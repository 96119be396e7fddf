"""Benchmark driver — prints ONE JSON line:
{"metric": "pipeline_reads_per_s", "value": N, "unit": "reads/s", ...}.

The scaled leg: 120k error-free 100 bp reads (6x) over a seeded 2 Mb
haploid genome with 4,000 planted SNPs, through seqset + readmap build and
whole-genome discovery, warm (one pass first so compiles land in the cache).
It runs on the GPU and fails when JAX finds none; every result names the
device it ran on.
"""

import json
import time


def _scaled_pipeline_rate():
    """reads/s through build + discovery (second, warm pass)."""
    import jax
    import numpy as np

    from biograph_jax.build.readmap_build import build_readmap
    from biograph_jax.build.seqset_build import build_seqset
    from biograph_jax.tools.simulate import haploid_sample
    from biograph_jax.variants.discover import DiscoverOptions, discover_variants

    sample = haploid_sample(12345, 2_000_000, 4000, read_len=100, depth=6.0)
    codes = sample.reads
    lengths = np.full(len(codes), 100, np.int32)
    ref = sample.reference()
    opt = DiscoverOptions(min_alt_support=5)

    def once():
        t0 = time.time()
        ss = build_seqset(codes, lengths)
        rm = build_readmap(ss, codes, lengths)
        jax.block_until_ready(  # fence the async build before discovery
            [v for v in (*vars(ss).values(), *vars(rm).values())
             if isinstance(v, jax.Array)]
        )
        t1 = time.time()
        stats = {}
        recs = discover_variants(ss, ref, opt=opt, readmap=rm, stats=stats)
        return t1 - t0, time.time() - t1, recs, stats

    once()
    tb, tc, recs, stats = once()
    return {
        "reads_per_s": len(codes) / (tb + tc),
        "build_s": tb,
        "call_s": tc,
        "records": len(recs),
        "stage_s": stats.get("stage_s", {}),
    }


def main():
    import jax

    devs = jax.devices()
    device = {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "count": len(devs),
    }
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: no GPU found ({device})")
    s = _scaled_pipeline_rate()
    print(
        json.dumps(
            {
                "metric": "pipeline_reads_per_s",
                "value": s["reads_per_s"],
                "unit": "reads/s",
                "device": device,
                "scaled_stages": {
                    k: s[k] for k in ("build_s", "call_s", "records", "stage_s")
                },
            }
        )
    )


if __name__ == "__main__":
    main()
