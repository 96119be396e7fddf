#!/usr/bin/env python3
"""Bring-up smoke of the main path on one NVIDIA GPU.

    python3 chip_smoke.py            # one card: device, pipeline,
                                     # equivalence, kernels
    python3 chip_smoke.py --four     # four cards: entry-sharded discovery
                                     # and the sharded pileup only
    python3 chip_smoke.py --trace DIR  # also trace the pipeline phase

Phases (one line each, times in seconds):

  device       the default JAX device is a GPU; name and power limit
  pipeline     a seeded E. coli-sized sample (4.6 Mb haploid genome, 4,600
               planted SNPs, 100 bp reads from both strands at 30x) through
               `cli.main(["full_pipeline", ...])`: create, discovery,
               coverage and grm; recall against the planted SNPs >= 0.95
  equivalence  a 200 kb instance: create + discovery on the card and in a
               CPU-only child process; record digests identical
  kernels      rank4_xla, push4, sizes_at, the find-window chain against
               the hash probe, and the classifier forward, each against a
               plain reference on the main run's seqset

Every phase that fails ends the run with a non-zero exit and no result
line.  The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the main run: E. coli K-12 MG1655 (ASM584v1) is 4,641,652 bp; one planted
# SNP per kb; 100 bp reads at 30x
GENOME_LEN = 4_600_000
N_SNPS = 4_600
READ_LEN = 100
DEPTH = 30.0
MIN_RECALL = 0.95
# the equivalence instance: same generator, 200 kb
EQ_GENOME_LEN = 200_000
# the four-card sample: same generator, 1 Mb
FOUR_GENOME_LEN = 1_000_000
KERNEL_QUERIES = 1 << 20

# device-memory bandwidth by device_kind (NVIDIA H100 SXM data sheet:
# 80 GB HBM3 at 3.35 TB/s, at the full 700 W power limit)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def import_package():
    """The package of this checkout, never one installed elsewhere."""
    sys.path.insert(0, HERE)
    import biograph_jax

    pkg_dir = os.path.dirname(os.path.abspath(biograph_jax.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        raise RuntimeError(f"biograph_jax imported from {pkg_dir}, not {HERE}")
    return biograph_jax


# ---------------------------------------------------------------- phases


def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: default device is {devs[0].platform}")
    log("device", device_kind=repr(devs[0].device_kind), count=len(devs),
        jax=jax.__version__, XLA_FLAGS=repr(os.environ.get("XLA_FLAGS", "")),
        compile_cache=jax.config.jax_compilation_cache_dir)
    print(nvidia_smi(), flush=True)
    return devs


def write_sample(work: str, sample) -> tuple[str, str]:
    from biograph_jax.tools.simulate import write_fasta, write_fastq

    os.makedirs(work, exist_ok=True)
    ref = os.path.join(work, "ref.fa")
    reads = os.path.join(work, "reads.fq")
    write_fasta(ref, sample.genome)
    write_fastq(reads, sample.reads)
    return ref, reads


def phase_pipeline(work: str, seed: int, genome_len: int = GENOME_LEN,
                   n_snps: int = N_SNPS, depth: float = DEPTH,
                   min_recall: float = MIN_RECALL, trace_dir: str | None = None):
    """full_pipeline on a seeded sample; returns (run dir, sample)."""
    import jax

    from biograph_jax import cli
    from biograph_jax.io.vcf import read_vcf
    from biograph_jax.tools.simulate import haploid_sample, truth_match

    t0 = time.time()
    sample = haploid_sample(seed, genome_len, n_snps, READ_LEN, depth)
    ref, reads = write_sample(work, sample)
    log("pipeline", genome_len=genome_len, snps=n_snps, read_len=READ_LEN,
        depth=depth, reads=len(sample.reads), setup_s=f"{time.time() - t0:.3f}")
    run = os.path.join(work, "run")
    argv = ["full_pipeline", "--reads", reads, "--ref", ref, "--out", run]
    t0 = time.time()
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            cli.main(argv)
    else:
        cli.main(argv)
    wall = time.time() - t0
    with open(os.path.join(run, "qc", "timings.json")) as f:
        stages = json.load(f)
    recs = read_vcf(os.path.join(run, "analysis", "results.vcf"))
    m = truth_match([(r.pos, r.ref, r.alt) for r in recs], sample)
    stats = jax.devices()[0].memory_stats() or {}
    log("pipeline", wall_s=f"{wall:.3f}",
        **{f"{k}_s": f"{v:.3f}" for k, v in stages.items()},
        records=len(recs), recall=f"{m['recall']:.5f}",
        precision=f"{m['precision']:.5f}",
        peak_device_bytes=stats.get("peak_bytes_in_use", "not reported"))
    if m["recall"] < min_recall:
        raise RuntimeError(f"recall {m['recall']:.4f} < {min_recall}")
    if trace_dir:
        report_trace(trace_dir)
    return run, sample


def discovery_digest(seed: int, genome_len: int) -> tuple[str, int]:
    """create + discovery of the seeded instance in this process."""
    import numpy as np

    from biograph_jax.build.readmap_build import build_readmap
    from biograph_jax.build.seqset_build import build_seqset
    from biograph_jax.runtime.resources import MemoryBudget
    from biograph_jax.tools.simulate import haploid_sample, record_digest
    from biograph_jax.variants.discover import DiscoverOptions, discover_variants

    sample = haploid_sample(seed, genome_len, genome_len // 1000, READ_LEN, DEPTH)
    lengths = np.full(len(sample.reads), READ_LEN, np.int32)
    ss = build_seqset(sample.reads, lengths, budget=MemoryBudget.detect())
    rm = build_readmap(ss, sample.reads, lengths)
    recs = discover_variants(ss, sample.reference(),
                             opt=DiscoverOptions(min_alt_support=5), readmap=rm)
    return record_digest(recs), len(recs)


def phase_equivalence(seed: int, genome_len: int = EQ_GENOME_LEN) -> None:
    t0 = time.time()
    card, n_card = discovery_digest(seed, genome_len)
    t_card = time.time() - t0
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--equivalence-child",
         "--seed", str(seed), "--genome-len", str(genome_len)],
        capture_output=True, text=True, env=env, timeout=900,
    )
    t_cpu = time.time() - t0
    if out.returncode != 0:
        raise RuntimeError(f"CPU child failed:\n{out.stderr[-4000:]}")
    child = json.loads(out.stdout.strip().splitlines()[-1])
    log("equivalence", genome_len=genome_len, records=n_card,
        card_s=f"{t_card:.3f}", cpu_child_s=f"{t_cpu:.3f}",
        card_digest=card[:16], cpu_digest=child["digest"][:16])
    if child["digest"] != card or child["records"] != n_card:
        raise RuntimeError("card and CPU records differ")


def rank4_reference(words, cum, pos):
    """numpy rank of all four bases: int64 [B, 4]."""
    import numpy as np

    from biograph_jax.core.bitvector import popcount_np

    nw = words.shape[1]
    w = pos >> 5
    over = w >= nw
    wc = np.minimum(w, nw - 1)
    rem = (pos & 31).astype(np.uint32)
    mask = np.where(rem > 0, (np.uint32(1) << rem) - np.uint32(1), np.uint32(0))
    mask = np.where(over, np.uint32(0xFFFFFFFF), mask).astype(np.uint32)
    word = words[:, wc] & mask[None, :]
    return (cum[:, wc] + popcount_np(np.ascontiguousarray(word))).T.astype(np.int64)


def push4_reference(ss, begin, end, size):
    """numpy push_front of all four bases onto each range."""
    import numpy as np

    words = np.asarray(ss.prev_words)
    cum = np.asarray(ss.prev_cum)
    fixed = np.asarray(ss.fixed)[None, :4]
    sizes = np.asarray(ss.entry_sizes)
    nb = fixed + rank4_reference(words, cum, begin)
    ne = fixed + rank4_reference(words, cum, end)
    kick = (nb < ne) & (sizes[np.minimum(nb, ss.n_entries - 1)] < (size + 1)[:, None])
    nb = nb + kick
    valid = (begin < end)[:, None]
    return (np.where(valid, nb, begin[:, None]),
            np.where(valid, ne, begin[:, None]))


def _time(fn, *args, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps


def phase_kernels(run: str, sample, seed: int, n_queries: int = KERNEL_QUERIES,
                  device_kind: str | None = None) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from biograph_jax.classifier.model import _forward, _init, stack_features
    from biograph_jax.index import probes
    from biograph_jax.index.seqset import Seqset, SeqsetRanges
    from biograph_jax.ops.rank4 import BYTES_PER_QUERY, rank4_xla
    from biograph_jax.variants.discover import DiscoverOptions

    rng = np.random.default_rng(seed)
    ss = Seqset.load(os.path.join(run, "sample.bgt", "seqset"))
    n = ss.n_entries
    words = np.asarray(ss.prev_words)
    cum = np.asarray(ss.prev_cum)
    nw = words.shape[1]
    d = ss.d
    bounds = np.array([0, 31, 32, n - 1, n, 32 * (n // 32), 32 * nw], np.int64)
    pos = np.concatenate([rng.integers(0, n + 1, n_queries), bounds])

    got = np.asarray(jax.jit(rank4_xla)(d.prev_words, d.prev_cum, pos))
    if not np.array_equal(got, rank4_reference(words, cum, pos)):
        raise RuntimeError("rank4_xla differs from the numpy popcount")
    f = jax.jit(rank4_xla)
    pos_dev = jnp.asarray(pos[:n_queries])
    dt = _time(f, d.prev_words, d.prev_cum, pos_dev)
    qps = n_queries / dt
    bps = qps * (8 + BYTES_PER_QUERY + 16)  # position in, 4 counts out
    peak = PEAK_BYTES_PER_S.get(device_kind) if device_kind else None
    if device_kind is not None and peak is None:
        raise RuntimeError(f"device kind {device_kind!r} is not in the peak table")
    log("kernels", entries=n, rank_words=nw, rank4_queries=len(pos),
        rank4_exact=True, rank4_qps=f"{qps:.6g}", rank4_bytes_per_s=f"{bps:.6g}",
        rank4_share_of_peak=f"{bps / peak:.6g}" if peak else "not measured")

    a, b = np.sort(rng.integers(0, n + 1, (2, n_queries)), axis=0)
    size = rng.integers(0, READ_LEN, n_queries).astype(np.int32)
    r = SeqsetRanges(jnp.asarray(a), jnp.asarray(b), jnp.asarray(size))
    nb4, ne4 = jax.jit(lambda r: d.push4(r))(r)
    wb4, we4 = push4_reference(ss, a, b, size)
    if not (np.array_equal(np.asarray(nb4), wb4)
            and np.array_equal(np.asarray(ne4), we4)):
        raise RuntimeError("push4 differs from the numpy reference")
    idx = np.concatenate([rng.integers(0, n + 64, n_queries), [0, n - 1, n]])
    sz = np.asarray(jax.jit(d.sizes_at)(jnp.asarray(idx)))
    if not np.array_equal(sz, np.asarray(ss.entry_sizes)[np.minimum(idx, n - 1)]):
        raise RuntimeError("sizes_at differs from entry_sizes")
    log("kernels", push4_lanes=n_queries, push4_exact=True,
        sizes_at_exact=True, max_entry_size=int(np.max(ss.entry_sizes)))

    # the find-window chain (rank gathers) against the rank-free hash probe
    m = DiscoverOptions().min_anchor_ctx
    g = sample.genome
    text = jnp.asarray(np.concatenate([g, (3 - g[::-1]).astype(np.uint8)]))
    t0 = time.time()
    probes.entry_seq_matrix(ss)
    t_seq = time.time() - t0
    t0 = time.time()
    probes.window_hash_table(ss, m)
    t_hash = time.time() - t0
    # windows that would cross the text start are masked by every caller
    wpos = jnp.asarray(rng.integers(m - 1, text.shape[0], n_queries))
    chain = [np.asarray(x) for x in probes.find_window_jit(
        d, text, wpos, jnp.full((n_queries,), m, jnp.int32), m)]
    hashed = [np.asarray(x) for x in probes.find_window_hash(ss, text, wpos, m)]
    hit = chain[0] < chain[1]
    if not np.array_equal(hit, hashed[0] < hashed[1]) or not all(
        np.array_equal(x[hit], y[hit]) for x, y in zip(chain, hashed)
    ):
        raise RuntimeError("find_window chain differs from the hash probe")
    hits = int(hit.sum())
    log("kernels", find_window_lanes=n_queries, window=m, hits=hits,
        chain_equals_hash=True, entry_seq_matrix_host_s=f"{t_seq:.3f}",
        window_hash_table_host_s=f"{t_hash:.3f}")

    # classifier forward on the main run's feature matrix
    feats = dict(np.load(os.path.join(run, "analysis", "features.npz")))
    x = stack_features(feats).astype(np.float32)
    x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-6)
    params = _init(jax.random.PRNGKey(seed), [x.shape[1], 32, 32, 1])
    got = np.asarray(jax.jit(_forward)(params, jnp.asarray(x)))
    h = x.astype(np.float64)
    p64 = {k: np.asarray(v, np.float64) for k, v in params.items()}
    h = np.maximum(h @ p64["w0"] + p64["b0"], 0)
    h = np.maximum(h @ p64["w1"] + p64["b1"], 0)
    want = 1 / (1 + np.exp(-(h @ p64["w2"] + p64["b2"])[:, 0]))
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    log("kernels", classifier_rows=x.shape[0], classifier_cols=x.shape[1],
        classifier_max_rel_err=f"{err:.3e}", precision="HIGHEST")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def report_trace(trace_dir: str) -> None:
    """Device busy/idle share and the top kernels of a profiler trace: busy
    is the union of the stream events on each GPU plane, over the window
    from the trace's first to its last event."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = ProfileData.from_file(path)
    lo, hi = float("inf"), 0.0
    per_dev = {}
    for plane in prof.planes:
        for line in plane.lines:
            for ev in line.events:
                lo = min(lo, ev.start_ns)
                hi = max(hi, ev.start_ns + ev.duration_ns)
        if not plane.name.startswith("/device:GPU"):
            continue
        spans, names = [], {}
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                names[ev.name] = names.get(ev.name, 0.0) + ev.duration_ns
        per_dev[plane.name] = (spans, names)
    window = hi - lo
    for dev, (spans, names) in per_dev.items():
        busy, end = 0.0, float("-inf")
        for s, e in sorted(spans):
            if e > end:
                busy += e - max(s, end)
                end = e
        top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
        log("trace", device=dev, window_s=f"{window / 1e9:.3f}",
            busy_s=f"{busy / 1e9:.3f}", idle_share=f"{1 - busy / window:.4f}")
        for name, ns in top:
            log("trace", kernel=repr(name[:80]), device_s=f"{ns / 1e9:.4f}")


def phase_four(work: str, seed: int, genome_len: int = FOUR_GENOME_LEN,
               region: tuple[int, int] | None = None) -> int:
    """Entry-sharded discovery over a 4-device mesh against the local engine
    on one device, and the sharded pileup step against its one-device sum."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from biograph_jax.build.readmap_build import build_readmap
    from biograph_jax.build.seqset_build import build_seqset
    from biograph_jax.parallel.mesh import sharded_pileup_step
    from biograph_jax.parallel.sharded_discovery import ShardedDiscoveryEngine
    from biograph_jax.tools.simulate import haploid_sample, record_digest
    from biograph_jax.variants.align import RefKmerIndex
    from biograph_jax.variants.discover import DiscoverOptions, discover_variants

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    sample = haploid_sample(seed, genome_len, genome_len // 1000, READ_LEN, DEPTH)
    lengths = np.full(len(sample.reads), READ_LEN, np.int32)
    t0 = time.time()
    ss = build_seqset(sample.reads, lengths)
    rm = build_readmap(ss, sample.reads, lengths)
    log("four", genome_len=genome_len, reads=len(lengths), entries=ss.n_entries,
        build_s=f"{time.time() - t0:.3f}")
    ref = sample.reference()
    opt = DiscoverOptions(min_alt_support=5)
    rounds = {}
    for name in ("local", "sharded", "local", "sharded"):
        eng = None
        if name == "sharded":
            eng = ShardedDiscoveryEngine(ss, Mesh(np.array(devs), ("model",)))
            placed = {dv.id for a in eng.args for dv in a.sharding.device_set}
            if len(placed) != 4:
                raise RuntimeError(f"sharded arrays sit on devices {placed}")
        t0 = time.time()
        recs = discover_variants(ss, ref, opt=opt, readmap=rm, engine=eng,
                                 region=region)
        rounds.setdefault(name, []).append((time.time() - t0, record_digest(recs),
                                            len(recs)))
    (tl, dl, nl), (ts, ds, ns) = rounds["local"][-1], rounds["sharded"][-1]
    log("four", local_records=nl, sharded_records=ns,
        local_s=" ".join(f"{t:.3f}" for t, _, _ in rounds["local"]),
        sharded_s=" ".join(f"{t:.3f}" for t, _, _ in rounds["sharded"]),
        local_digest=dl[:16], sharded_digest=ds[:16])
    if dl != ds or nl == 0:
        raise RuntimeError("entry-sharded records differ from the local engine")

    # data-parallel pileup: reads sharded over 4 devices, psum'd counts
    k = 16
    g = sample.genome
    idx = RefKmerIndex.build(g, k)
    kmers, kpos = np.asarray(idx.kmers), np.asarray(idx.positions)
    reads = sample.reads[0::2][: 4 * 4096]  # forward-strand reads
    rl = np.full(len(reads), READ_LEN, np.int32)
    mesh4 = Mesh(np.array(devs), ("data",))
    mesh1 = Mesh(np.array(devs[:1]), ("data",))
    t0 = time.time()
    c4 = np.asarray(sharded_pileup_step(mesh4, kmers, kpos, g, k)(
        kmers, kpos, g, reads, rl))
    t4 = time.time() - t0
    t0 = time.time()
    c1 = np.asarray(sharded_pileup_step(mesh1, kmers, kpos, g, k)(
        kmers, kpos, g, reads, rl))
    t1 = time.time() - t0
    log("four", pileup_reads=len(reads), pileup_mass=int(c4.sum()),
        four_s=f"{t4:.3f}", one_s=f"{t1:.3f}", equal=bool(np.array_equal(c4, c1)))
    if not np.array_equal(c4, c1) or c4.sum() == 0:
        raise RuntimeError("sharded pileup differs from the one-device sum")
    return 4


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=20261016)
    p.add_argument("--four", action="store_true",
                   help="run only the four-card phase")
    p.add_argument("--trace", help="profiler trace directory for the pipeline")
    p.add_argument("--equivalence-child", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--genome-len", type=int, default=EQ_GENOME_LEN,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import_package()
    if args.equivalence_child:
        digest, n = discovery_digest(args.seed, args.genome_len)
        print(json.dumps({"digest": digest, "records": n}))
        return 0

    devs = phase_device()
    work = os.path.join(HERE, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        if args.four:
            t0 = time.time()
            count = phase_four(work, args.seed)  # the four devices of the mesh
            log("four", ok=True, seconds=f"{time.time() - t0:.3f}")
        else:
            t0 = time.time()
            run, sample = phase_pipeline(work, args.seed, trace_dir=args.trace)
            log("pipeline", ok=True, seconds=f"{time.time() - t0:.3f}")
            t0 = time.time()
            phase_equivalence(args.seed)
            log("equivalence", ok=True, seconds=f"{time.time() - t0:.3f}")
            t0 = time.time()
            phase_kernels(run, sample, args.seed, device_kind=devs[0].device_kind)
            log("kernels", ok=True, seconds=f"{time.time() - t0:.3f}")
            count = len(devs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
