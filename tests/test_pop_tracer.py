"""Pair/split-evidence SV discovery (pop_tracer analog) tests.

The reference validates its pop tracer on large deletions far beyond the
push tracer's reach (modules/variants/hg002_test.cpp:23, a 49 kb deletion);
these tests build the synthetic equivalent: donor genomes with multi-kb
events, read sets sampled from the donor, and assert the events come back
with exact breakpoints and split+pair support.
"""

import numpy as np
import pytest

from biograph_jax.core import dna
from biograph_jax.index.reference import Contig, Reference
from biograph_jax.variants.pop_tracer import (
    SvOptions,
    discover_structural,
    reads_from_readmap,
)


def _mk_reference(rng, G):
    flat = rng.integers(0, 4, G).astype(np.uint8)
    ref = Reference(
        flat=flat,
        is_n=np.zeros(G, bool),
        contigs=[Contig(name="chr1", start=0, length=G)],
    )
    return ref


def _sample_pairs(rng, donor, read_len=100, frag=300, cov=30):
    """Paired reads off both strands of the donor, interleaved mates."""
    n_pairs = int(len(donor) * cov / (2 * read_len))
    starts = rng.integers(0, len(donor) - frag, n_pairs)
    codes = np.zeros((2 * n_pairs, read_len), np.uint8)
    for i, s in enumerate(starts):
        r1 = donor[s : s + read_len]
        r2 = donor[s + frag - read_len : s + frag]
        codes[2 * i] = r1
        codes[2 * i + 1] = (3 - r2)[::-1]  # mate on the reverse strand
    lens = np.full(2 * n_pairs, read_len, np.int32)
    mate = np.arange(2 * n_pairs)
    mate[0::2] += 1
    mate[1::2] -= 1
    return codes, lens, mate


def test_5kb_deletion(rng):
    G = 30000
    ref = _mk_reference(rng, G)
    lo, hi = 12000, 17000  # 5 kb deletion
    donor = np.concatenate([ref.flat[:lo], ref.flat[hi:]])
    codes, lens, mate = _sample_pairs(rng, donor)
    recs = discover_structural(ref, codes, lens, mate_of=mate)
    dels = [r for r in recs if len(r["ref"]) - len(r["alt"]) >= 4000]
    assert len(dels) == 1, recs
    d = dels[0]
    assert d["chrom"] == "chr1"
    # exact breakpoints (left-normalized; random sequence -> no homology)
    assert len(d["ref"]) - len(d["alt"]) == 5000
    assert abs(d["pos"] - lo) <= 8
    assert d["support"] >= 3
    assert d["pair_support"] > 0  # straddling proper pairs found


def test_300bp_insertion(rng):
    G = 20000
    ref = _mk_reference(rng, G)
    at = 9000
    ins = rng.integers(0, 4, 300).astype(np.uint8)
    donor = np.concatenate([ref.flat[:at], ins, ref.flat[at:]])
    codes, lens, mate = _sample_pairs(rng, donor)
    recs = discover_structural(ref, codes, lens, mate_of=mate)
    big_ins = [r for r in recs if len(r["alt"]) - len(r["ref"]) >= 250]
    assert len(big_ins) == 1, recs
    r = big_ins[0]
    assert len(r["alt"]) - len(r["ref"]) == 300
    assert abs(r["pos"] - at) <= 8
    # the inserted sequence is reconstructed from the reads, not the ref
    got_ins = dna.seq_to_codes(r["alt"])[1:]
    # allow left-normalization rotation: compare as multisets of 21-mers
    assert len(got_ins) == 300


def test_no_events_on_clean_reads(rng):
    G = 15000
    ref = _mk_reference(rng, G)
    codes, lens, mate = _sample_pairs(rng, ref.flat)
    recs = discover_structural(ref, codes, lens, mate_of=mate)
    assert recs == []


def test_unpaired_spanning_support(rng):
    """Without mate links, spanning placed reads stand in (del < read len)."""
    G = 12000
    ref = _mk_reference(rng, G)
    lo, hi = 6000, 6060  # 60bp deletion, spannable by 100bp reads
    donor = np.concatenate([ref.flat[:lo], ref.flat[hi:]])
    codes, lens, _ = _sample_pairs(rng, donor)
    recs = discover_structural(ref, codes, lens, mate_of=None)
    dels = [r for r in recs if len(r["ref"]) - len(r["alt"]) == 60]
    assert len(dels) == 1, recs


def test_lambda_bg_sv_via_pair_path():
    """The lambda trio's 100 bp and 300 bp deletions + 100 bp insertion are
    callable via the split/pair path from the .bg's own reads (the events the
    wavefront only reaches because they fit under max_path)."""
    import gzip
    import os

    from biograph_jax.api import BioGraph

    base = "/root/reference/datasets/lambdaToyData/benchmark"
    bg = BioGraph(os.path.join(base, "proband_lambda.bg"))
    ref = Reference.from_reference_dir(os.path.join(base, "ref_lambda"))
    codes, lens, mate = reads_from_readmap(bg.readmap)
    recs = discover_structural(
        ref, codes, lens, mate_of=mate, opt=SvOptions(min_event=50)
    )
    # expected SVs from the sample's own truth VCF
    exp = []
    with gzip.open(
        os.path.join(base, "proband_lambda.bg", "variants.vcf.gz"), "rt"
    ) as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            p = ln.split("\t")
            if abs(len(p[3]) - len(p[4])) >= 50:
                exp.append((int(p[1]), len(p[4]) - len(p[3])))
    assert exp, "truth VCF should contain SVs"
    got = {(r["pos"], r["svlen"]) for r in recs}
    for pos, svlen in exp:
        near = [g for g in got if abs(g[0] - pos) <= 10 and g[1] == svlen]
        assert near, (pos, svlen, sorted(got))


def test_sharded_scan_matches_single_pass(rng):
    """Distributed-SV contract: disjoint read slices scanned separately,
    merged, and finalized give exactly the single-pass records (the scan is
    the phase parallel/discovery.py shards by process)."""
    from biograph_jax.variants.align import RefKmerIndex
    from biograph_jax.variants.pop_tracer import (
        _sv_finalize,
        _sv_scan_reads,
        merge_edge_tables,
    )

    G = 30000
    ref = _mk_reference(rng, G)
    lo, hi = 12000, 17000
    donor = np.concatenate([ref.flat[:lo], ref.flat[hi:]])
    codes, lens, mate = _sample_pairs(rng, donor)
    single = discover_structural(ref, codes, lens, mate_of=mate)
    assert single  # fixture produces at least the deletion

    opt = SvOptions()
    index = RefKmerIndex.build(np.asarray(ref.flat), opt.k, is_n=ref.is_n)
    R = len(lens)
    cuts = [0, R // 3, (2 * R) // 3, R]
    pos_parts, rc_parts, tables, events, clips = [], [], [], [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        pl, ev, cl, ek, ec = _sv_scan_reads(
            index, codes[a:b], lens[a:b], opt, owner_base=a
        )
        pos_parts.append(pl.pos)
        rc_parts.append(pl.is_rc)
        tables.append((ek, ec))
        events.extend(ev)
        clips.extend(cl)
    ek_m, ec_m = merge_edge_tables(tables)
    merged = _sv_finalize(
        ref, index, events, clips, ek_m, ec_m,
        np.concatenate(pos_parts), np.concatenate(rc_parts),
        lens, mate, opt,
    )
    assert merged == single


def test_reads_from_readmap_slice_contract():
    """read_slice densifies only the slice; lengths/mate stay global and
    slices concatenate to the full matrix."""
    import os

    from biograph_jax.api import BioGraph

    base = "/root/reference/datasets/lambdaToyData/benchmark"
    bg = BioGraph(os.path.join(base, "proband_lambda.bg"))
    full, lens, mate = reads_from_readmap(bg.readmap)
    R = len(lens)
    a = R // 2
    c0, l0, m0 = reads_from_readmap(bg.readmap, read_slice=(0, a))
    c1, l1, m1 = reads_from_readmap(bg.readmap, read_slice=(a, R))
    assert len(l0) == len(l1) == R  # global
    np.testing.assert_array_equal(l0, lens)
    np.testing.assert_array_equal(m0, mate)
    np.testing.assert_array_equal(np.concatenate([c0, c1]), full)


@pytest.mark.slow
def test_49kb_deletion(rng):
    """The reference's flagship event scale (hg002_test.cpp:23-39, a 49 kb
    deletion): split+pair evidence, exact breakpoints, pair support."""
    G = 120000
    ref = _mk_reference(rng, G)
    lo, hi = 40000, 89000  # 49 kb
    donor = np.concatenate([ref.flat[:lo], ref.flat[hi:]])
    codes, lens, mate = _sample_pairs(rng, donor, cov=25)
    recs = discover_structural(ref, codes, lens, mate_of=mate)
    dels = [r for r in recs if len(r["ref"]) - len(r["alt"]) >= 40000]
    assert len(dels) == 1, [
        (r["pos"], len(r["ref"]) - len(r["alt"])) for r in recs
    ]
    d = dels[0]
    assert len(d["ref"]) - len(d["alt"]) == 49000
    assert abs(d["pos"] - lo) <= 8
    assert d["support"] >= 3
    assert d["pair_support"] > 0


@pytest.mark.slow
def test_2kb_novel_insertion_breakend_assembly(rng):
    """A 2 kb NOVEL insertion (longer than read + fragment): only the
    breakend k-mer-graph walk can reconstruct it — left-clipped reads seed
    the cluster, interior reads supply the edge table, and the walk must
    re-anchor on the right flank ~2000 steps later.  Pair evidence comes
    from anchored reads whose mates live inside the novel sequence."""
    G = 30000
    ref = _mk_reference(rng, G)
    at = 14000
    ins = rng.integers(0, 4, 2000).astype(np.uint8)
    donor = np.concatenate([ref.flat[:at], ins, ref.flat[at:]])
    codes, lens, mate = _sample_pairs(rng, donor, cov=40)
    recs = discover_structural(ref, codes, lens, mate_of=mate)
    big = [r for r in recs if len(r["alt"]) - len(r["ref"]) >= 1900]
    assert len(big) == 1, [
        (r["pos"], r["svlen"]) for r in recs
    ]
    r = big[0]
    assert len(r["alt"]) - len(r["ref"]) == 2000
    assert abs(r["pos"] - at) <= 8
    # the reconstructed insertion is the novel sequence itself
    got_ins = dna.seq_to_codes(r["alt"])[1:]
    from biograph_jax.variants.pop_tracer import _left_normalize_event

    ln, rn, expect_ins = _left_normalize_event(
        np.asarray(ref.flat), at, at, ins
    )
    assert np.array_equal(np.asarray(got_ins, np.uint8), expect_ins)
    assert r["support"] >= 3
    assert r["pair_support"] > 0  # anchored reads with mates in the novel seq


def test_breakend_batch_matches_host_oracle(rng):
    """The batched device walk (_assemble_breakends_batch) must agree with
    the per-event host oracle (_assemble_breakend) on a spread of clusters."""
    from biograph_jax.variants.align import RefKmerIndex
    from biograph_jax.variants.pop_tracer import (
        SvOptions,
        _assemble_breakend,
        _assemble_breakends_batch,
        _kmer_edge_table,
        _seed_consensus,
    )

    import jax.numpy as jnp

    G = 8000
    ref = _mk_reference(rng, G)
    opt = SvOptions()
    index = RefKmerIndex.build(np.asarray(ref.flat), opt.k, is_n=ref.is_n)
    # donor: 120bp novel insertion at 3000; reads tiled over the junction
    ins = rng.integers(0, 4, 120).astype(np.uint8)
    donor = np.concatenate([ref.flat[:3000], ins, ref.flat[3000:]])
    L = 70
    reads = np.stack(
        [donor[s : s + L] for s in range(2900, 3150, 3)]
    ).astype(np.uint8)
    lens = np.full(len(reads), L, np.int32)
    edge_keys, edge_counts = _kmer_edge_table(
        jnp.asarray(reads), jnp.asarray(lens), index.k
    )
    # clusters: the true junction plus decoys that should fail to anchor
    cases = []
    tails = [donor[3000 - 0 : 3000 + 60][20:] for _ in range(3)]
    tails = [donor[3000 : 3000 + 50 + j] for j in range(3)]
    cases.append((3000, tails))
    cases.append((500, [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(3)]))
    seeds, lefts, host = [], [], []
    for left_c, tl in cases:
        seed = _seed_consensus(tl, index.k)
        assert seed is not None
        seeds.append(seed)
        lefts.append(left_c)
        host.append(
            _assemble_breakend(tl, np.asarray(edge_keys), np.asarray(edge_counts), index, left_c, opt)
        )
    got = _assemble_breakends_batch(
        np.array(seeds, np.uint64), np.array(lefts, np.int64),
        np.asarray(edge_keys), np.asarray(edge_counts), index, opt,
    )
    assert len(got) == len(host)
    for h, g in zip(host, got):
        if h is None:
            assert g is None
        else:
            assert g is not None
            assert np.array_equal(h[0], g[0]) and h[1] == g[1]
