"""Discovery engine tests: simulated genome with SNPs + indels.

Reads are drawn from a mutated donor genome; discovery runs against the
original reference and must recover the planted variants.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from biograph_jax.core import dna
from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.build.readmap_build import build_readmap
from biograph_jax.variants.discover import (
    DiscoverOptions,
    discover_variants,
)


class FakeRef:
    def __init__(self, codes, name="chr1"):
        from biograph_jax.index.reference import Contig

        self.flat = np.asarray(codes, np.uint8)
        self.is_n = np.zeros(len(codes), bool)
        self.contigs = [Contig(name=name, start=0, length=len(codes))]


def _sim(rng, G=6000, snps=(), insertions=(), deletions=()):
    """Build ref + donor; returns (ref_codes, donor_codes, truth records)."""
    ref = rng.integers(0, 4, size=G, dtype=np.uint8)
    truth = []
    donor_parts = []
    edits = (
        [("S", p, None) for p in snps]
        + [("I", p, ln) for p, ln in insertions]
        + [("D", p, ln) for p, ln in deletions]
    )
    edits.sort(key=lambda e: e[1])
    prev = 0
    for kind, p, ln in edits:
        donor_parts.append(ref[prev:p])
        if kind == "S":
            alt = (ref[p] + 1 + rng.integers(0, 3)) % 4
            while alt == ref[p]:
                alt = rng.integers(0, 4)
            donor_parts.append(np.array([alt], np.uint8))
            truth.append(("S", p, int(ref[p]), int(alt)))
            prev = p + 1
        elif kind == "I":
            ins = rng.integers(0, 4, size=ln, dtype=np.uint8)
            donor_parts.append(np.array([ref[p]], np.uint8))
            donor_parts.append(ins)
            truth.append(("I", p, ln))
            prev = p + 1
        else:  # deletion of ln bases after p
            donor_parts.append(np.array([ref[p]], np.uint8))
            truth.append(("D", p, ln))
            prev = p + 1 + ln
    donor_parts.append(ref[prev:])
    donor = np.concatenate(donor_parts)
    return ref, donor, truth


def _reads_from(donor, rng, L=40, coverage=30):
    n = int(len(donor) * coverage / L)
    starts = rng.integers(0, len(donor) - L, size=n)
    codes = np.stack([donor[s : s + L] for s in starts])
    # strand-symmetric sampling (real sequencing reads both strands); the
    # engine's directional-coverage penalty (calc_coverage.cpp:10-17 analog,
    # on by default) discounts one-sided depth as a systematic-error signal
    half = n // 2
    codes[:half] = (3 - codes[:half])[:, ::-1]
    return codes, np.full(n, L, np.int32)


@pytest.fixture(scope="module")
def rngm():
    return np.random.default_rng(99)


def test_discover_snps(rngm):
    rng = rngm
    ref, donor, truth = _sim(rng, G=5000, snps=[1200, 2500, 3700])
    codes, lens = _reads_from(donor, rng)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    recs = discover_variants(ss, FakeRef(ref), chunk_len=2048, readmap=rm)
    got = {(r["pos"] - 1, r["ref"], r["alt"]) for r in recs if len(r["ref"]) == 1 == len(r["alt"])}
    for kind, p, rb, ab in [t for t in truth if t[0] == "S"]:
        assert (p, "ACGT"[rb], "ACGT"[ab]) in got, f"SNP at {p} missed: {sorted(got)[:5]}"
    # planted hom SNPs at ~25-30x must carry strong read support
    for r in recs:
        if (r["pos"] - 1, r["ref"], r["alt"]) in got:
            assert r["support"] >= 10, r


def test_discover_insertion_deletion(rngm):
    rng = rngm
    ref, donor, truth = _sim(
        rng, G=5000, insertions=[(1500, 5)], deletions=[(3200, 7)]
    )
    codes, lens = _reads_from(donor, rng)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    recs = discover_variants(ss, FakeRef(ref), chunk_len=2048, readmap=rm)
    indels = [r for r in recs if len(r["ref"]) != len(r["alt"]) and r["support"] >= 10]
    # insertion: alt longer by 5; deletion: ref longer by 7
    assert any(len(r["alt"]) - len(r["ref"]) == 5 for r in indels), indels
    assert any(len(r["ref"]) - len(r["alt"]) == 7 for r in indels), indels


def test_discover_clean_genome_no_calls(rngm):
    rng = rngm
    ref = rng.integers(0, 4, size=4000, dtype=np.uint8)
    codes, lens = _reads_from(ref, rng)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    recs = discover_variants(ss, FakeRef(ref), chunk_len=2048, readmap=rm)
    strong = [r for r in recs if r["support"] >= 3]
    assert strong == [], strong[:3]


def test_gpu_batching_records_identical(monkeypatch):
    """The GPU backend's launch choices (wide probe batches, one padded
    scoring batch across bubble-size buckets) give exactly the records of
    the CPU backend's choices — same engine, different batching."""
    from biograph_jax.variants import discover as D

    rng = np.random.default_rng(2026)  # its own stream: rngm is module-shared
    ref, donor, truth = _sim(
        rng, G=4000, snps=[700, 1900], insertions=[(1200, 4)], deletions=[(2900, 70)]
    )
    codes, lens = _reads_from(donor, rng)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    base = discover_variants(ss, FakeRef(ref), readmap=rm)
    monkeypatch.setattr(D, "backend", lambda: "gpu")
    gpu = discover_variants(ss, FakeRef(ref), readmap=rm)
    key = lambda r: (r["chrom"], r["pos"], r["ref"], r["alt"], r["support"])
    assert base and sorted(map(key, base)) == sorted(map(key, gpu))
    spans = {max(len(r["ref"]), len(r["alt"])) for r in base}
    assert max(spans) > 64 >= min(spans), spans  # two scoring buckets


def test_trunc_tables_instance_cache_only(rngm):
    """Regression (VERDICT r3): the trunc-table cache must live on the Seqset
    instance only — an id()-keyed module global leaked tables and could serve
    a NEW seqset the OLD one's tables after id reuse (wrong truncation)."""
    import biograph_jax.variants.discover as D

    assert not hasattr(D, "_TRUNC_CACHE")

    def make_ss(seed):
        r = np.random.default_rng(seed)
        codes = r.integers(0, 4, size=(40, 24), dtype=np.uint8)
        return build_seqset(codes, np.full(40, 24, np.int32))

    def expect(ss, c):
        shared = np.asarray(ss.shared)
        n = len(shared)
        idx = np.arange(n, dtype=np.int64)
        lt = shared < c
        prev_lt = np.maximum.accumulate(np.where(lt, idx, -1))
        nxt = np.where(lt, idx, n)
        next_lt = np.minimum.accumulate(nxt[::-1])[::-1]
        return prev_lt, next_lt

    ss1 = make_ss(1)
    p1, n1 = (np.asarray(x) for x in D._trunc_tables(ss1, 12))
    e1 = expect(ss1, 12)
    np.testing.assert_array_equal(p1, e1[0])
    np.testing.assert_array_equal(n1, e1[1])
    assert "_trunc_cache" in ss1.__dict__ and 12 in ss1._trunc_cache
    del ss1  # cache dies with the instance
    ss2 = make_ss(2)
    p2, n2 = (np.asarray(x) for x in D._trunc_tables(ss2, 12))
    e2 = expect(ss2, 12)
    np.testing.assert_array_equal(p2, e2[0])
    np.testing.assert_array_equal(n2, e2[1])


def test_discovery_under_tiny_hbm_budget(rngm, monkeypatch):
    """HBM-budget-driven discovery (resource_manager analog): with an
    artificially small BGT_HBM_BUDGET_BYTES the plan must drop the trunc
    tables and the shared span table, and discovery must still produce
    IDENTICAL records via the LtSearch fallback."""
    ref, donor, truth = _sim(
        rngm, G=6000, snps=(900, 2500, 4200), insertions=((3300, 5),),
        deletions=((1700, 4),),
    )
    codes, lens = _reads_from(donor, rngm)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    fref = FakeRef(ref)
    opt = DiscoverOptions(min_alt_support=5)
    stats0, stats1 = {}, {}
    base = discover_variants(ss, fref, opt=opt, readmap=rm, stats=stats0)
    assert stats0["memory_plan"]["use_trunc_tables"]
    monkeypatch.setenv("BGT_HBM_BUDGET_BYTES", str(1 << 16))  # 64 KiB
    tight = discover_variants(ss, fref, opt=opt, readmap=rm, stats=stats1)
    plan = stats1["memory_plan"]
    assert not plan["use_trunc_tables"]
    assert plan["span_table_cap"] == 0
    key = lambda r: (r["chrom"], r["pos"], r["ref"], r["alt"], r["support"])
    assert sorted(map(key, tight)) == sorted(map(key, base))


def test_branch_retry_rescues_beam_misses(rngm):
    """Adaptive-depth retry (branch.h:46 best-first queue analog): an anchor
    whose whole clone beam dies un-rejoined is re-explored with 4x clones.
    Fixture: a decoy haplotype family shares the alt path past the anchor
    and is WIDER than the true continuation, so a width-1 beam (always
    follows the widest child) dead-ends; the retry round's extra clones take
    the second-ranked child and rejoin."""
    rng = np.random.default_rng(5)
    G = 4000
    ref = rng.integers(0, 4, G, dtype=np.uint8)
    X = 2000
    donor = ref.copy()
    donor[X] = (donor[X] + 1) % 4
    codes, lens = _reads_from(donor, rng, L=40, coverage=25)
    L = 40
    fams = []
    for j in (4, 8, 12):  # divergence points after the SNP
        tail = rng.integers(0, 4, 80, dtype=np.uint8)
        hap = np.concatenate([donor[X - 80 : X + j + 1], tail])
        rows = np.stack([hap[s : s + L] for s in range(0, len(hap) - L, 1)])
        rows = rows.copy()
        half = len(rows) // 2
        rows[:half] = (3 - rows[:half])[:, ::-1]
        fams.append(rows)
    codes2 = np.concatenate([codes] + fams).astype(np.uint8)
    lens2 = np.concatenate(
        [lens, np.full(sum(len(f) for f in fams), L, np.int32)]
    )
    ss = build_seqset(codes2, lens2)
    rm = build_readmap(ss, codes2, lens2)
    fref = FakeRef(ref)

    def run(ncl, retries):
        stats = {}
        opt = DiscoverOptions(
            min_alt_support=5, branch_clones=ncl,
            branch_retry_rounds=retries, skip_trace_rev=True,
        )
        recs = discover_variants(ss, fref, opt=opt, readmap=rm, stats=stats)
        return any(r["pos"] == X + 1 for r in recs), stats

    # width-1 beam: decoy out-widens the true child -> the SNP is missed
    hit, _ = run(ncl=1, retries=0)
    assert not hit
    # the retry round re-explores the dead anchor with 4 clones and rescues
    hit, stats = run(ncl=1, retries=1)
    assert hit
    assert stats.get("branch_retry_rescued", 0) >= 1
    # the default configuration also finds it
    hit, _ = run(ncl=4, retries=1)
    assert hit


def test_prescreen_identity(rngm, monkeypatch):
    """The k-mer coverage prescreen (compact filter->exact->anchor frontend
    over covered blocks only) must produce records IDENTICAL to the dense
    probe pipeline — including on a genome whose reads cover only part of
    it (the prescreen's reason to exist)."""
    rng = rngm
    ref, donor, truth = _sim(
        rng, G=8000, snps=[700, 1900, 5200], insertions=[(1200, 4)],
        deletions=[(6400, 5)],
    )
    codes, lens = _reads_from(donor, rng)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    stats = {}
    compact = discover_variants(ss, FakeRef(ref), readmap=rm, stats=stats)
    assert "prescreen_probed" in stats  # compact frontend actually ran
    monkeypatch.setenv("BGT_NO_PRESCREEN", "1")
    dense = discover_variants(ss, FakeRef(ref), readmap=rm)
    key = lambda r: (r["chrom"], r["pos"], r["ref"], r["alt"], r["support"])
    assert sorted(map(key, compact)) == sorted(map(key, dense))
    assert {r["pos"] for r in compact} >= {t[1] + 1 for t in truth}
