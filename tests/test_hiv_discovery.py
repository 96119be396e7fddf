"""HIV divergent-sample discovery gate (BASELINE config: datasets/hiv).

The ERR381524 sample shares only ~31% of its 25-mers with the HIV-1
reference (divergent runs up to ~1.2 kb) — the regime the reference's
branching engines exist for.  No truth VCF ships with the dataset, so the
gate is (a) a committed call-count snapshot (regression fence, the
sv_perf_check.py pattern) and (b) independent validation: every call must
carry read coverage through the coverage walk over the donor-patched
genome, which is a different code path from the assembler that produced it.
"""

import json
import os

import numpy as np
import pytest

SNAP = os.path.join(os.path.dirname(__file__), "data", "hiv_snapshot.json")


@pytest.mark.slow
def test_hiv_divergent_discovery():
    from biograph_jax.io.bgimport import open_bg_dir
    from biograph_jax.index.reference import Reference
    from biograph_jax.io.vcf import VcfRecord
    from biograph_jax.variants.coverage_tool import annotate_coverage
    from biograph_jax.variants.discover import DiscoverOptions, discover_variants

    ss, rm, _ = open_bg_dir(
        "/root/reference/datasets/hiv/biograph/ERR381524.bg"
    )
    ref = Reference.from_fasta(
        "/root/reference/datasets/hiv/ref/hiv-1-NC_001802.1.fa"
    )
    stats = {}
    opt = DiscoverOptions(min_alt_support=5, bidir=True)
    recs = [
        r
        for r in discover_variants(ss, ref, opt=opt, readmap=rm, stats=stats)
        if r["support"] >= 5
    ]
    snap = json.load(open(SNAP))
    assert len(recs) == snap["n_records"], (len(recs), snap)
    assert stats["anchors_found"] == snap["anchors_found"], stats
    assert stats["anchors_truncated"] == 0

    # independent validation: donor-patched coverage walk must support calls
    vrecs = [
        VcfRecord(chrom=r["chrom"], pos=r["pos"], ref=r["ref"], alt=r["alt"])
        for r in recs
    ]
    ann = annotate_coverage(rm, ref, vrecs)
    supported = (ann.alt_depth >= 3).mean()
    assert supported >= 0.9, (
        supported,
        [
            (v.pos, int(d))
            for v, d in zip(vrecs, ann.alt_depth)
            if d < 3
        ],
    )


@pytest.mark.slow
def test_hiv_iterative_recovers_divergent_runs():
    """Donor-patching rounds (variants/iterate.py, graph_discover analog)
    must reach substantially deeper into the divergent runs than one round —
    every emitted record is coverage-validated by construction."""
    from biograph_jax.io.bgimport import open_bg_dir
    from biograph_jax.index.reference import Reference
    from biograph_jax.variants.discover import DiscoverOptions
    from biograph_jax.variants.iterate import discover_variants_iterative

    ss, rm, _ = open_bg_dir(
        "/root/reference/datasets/hiv/biograph/ERR381524.bg"
    )
    ref = Reference.from_fasta(
        "/root/reference/datasets/hiv/ref/hiv-1-NC_001802.1.fa"
    )
    stats = {}
    recs = discover_variants_iterative(
        ss,
        ref,
        opt=DiscoverOptions(min_alt_support=5, bidir=True),
        readmap=rm,
        max_rounds=10,
        stats=stats,
    )
    snap = json.load(open(SNAP))
    # snapshot history: 145 under the kmax=16-capped depth counting; 144 once
    # Readmap.length_groups made depth exact (one borderline-hom patch flips);
    # 119 once the directional-coverage penalty landed (calc_coverage.cpp:10
    # parity, on by default like the reference) — one-directionally-covered
    # calls in this thin single-end sample are now discounted
    assert len(recs) == snap["n_iterative_records"], (len(recs), stats)
    assert len(recs) >= 3 * snap["n_records"]  # the point of iterating
