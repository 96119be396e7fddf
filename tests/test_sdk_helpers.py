"""SDK depth: read iterators + region/breakpoint helpers + visualize."""

import numpy as np
import pytest

from biograph_jax.build.readmap_build import build_readmap
from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.core import dna
from biograph_jax.index.reference import Contig, Reference


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(99)
    G = 3000
    flat = rng.integers(0, 4, G).astype(np.uint8)
    donor = flat.copy()
    donor[1500] = (donor[1500] + 1) % 4  # a hom SNP
    rows = [donor[s : s + 60] for s in range(0, G - 60, 4)]
    codes = np.stack(rows).astype(np.uint8)
    # alternate strands (odd rows reverse-complemented) so every locus has
    # two-directional coverage — the directional-coverage penalty
    # (calc_coverage.cpp:10-17 semantics, on by default) floors support for
    # loci covered in only one direction, as with any real library prep
    codes[1::2] = (3 - codes[1::2])[:, ::-1]
    lens = np.full(len(rows), 60, np.int32)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    ref = Reference(
        flat=flat, is_n=np.zeros(G, bool), contigs=[Contig("chr1", 0, G)]
    )

    class BG:
        pass

    bg = BG()
    bg.seqset = ss
    bg.readmap = rm

    def seq_cov(seq):
        import jax.numpy as jnp

        f, r = rm.coverage(
            jnp.asarray(np.asarray(seq)[None, :]),
            jnp.asarray([len(seq)], np.int32),
        )
        return np.asarray(f + r)[0]

    bg.seq_coverage = seq_cov
    return bg, ref, donor, codes, lens


@pytest.mark.slow
def test_prefix_reads(world):
    bg, ref, donor, codes, lens = world
    rm = bg.readmap
    # an entry holding read 0's sequence: its prefix reads include read 0
    import jax.numpy as jnp

    r = bg.seqset.d.find(
        jnp.asarray(codes[0][None, :]), jnp.asarray([60], np.int32)
    )

    class E:
        begin = int(r.begin[0])
        end = int(r.end[0])
        size = 60

    reads = rm.get_prefix_reads(E)
    assert any(length == 60 for _, length in reads)
    assert rm.get_longest_prefix_read(E) is not None


def test_reads_containing(world):
    bg, ref, donor, codes, lens = world
    rm = bg.readmap
    # a 25-mer from the middle of read 10 is contained by read 10
    sub = codes[10][20:45]
    hits = rm.get_reads_containing(sub)
    assert hits, "no containing reads found"
    rids = {rid for rid, off in hits}
    assert 10 in rids
    # offsets are real: the read really has the seq there
    for rid, off in hits:
        if rid == 10:
            row = codes[10]
            if (row[off : off + 25] == sub).all():
                break
    else:
        pytest.fail("read 10 found but at no valid offset")


def test_overlap_reads(world):
    bg, ref, donor, codes, lens = world
    rm = bg.readmap
    # reads overlapping the tail of a 80bp donor window must include the
    # reads starting inside the window's second half
    win = donor[1000:1080]
    hits = rm.find_overlap_reads(win, min_overlap=30)
    assert hits
    assert all(ov >= 30 for _, ov in hits)
    best_rid, best_ov = hits[0]
    assert best_ov >= 55  # a read starts within a stride of the tail


def test_region_and_visualize(world):
    bg, ref, donor, codes, lens = world
    from biograph_jax.utils import find_region_variants, visualize

    res = find_region_variants(bg, ref, "chr1", 1300, 1700)
    keys = {(v["pos"], v["ref"], v["alt"]) for v in res.variants}
    want_ref = "ACGT"[ref.flat[1500]]
    want_alt = "ACGT"[donor[1500]]
    assert (1501, want_ref, want_alt) in keys, keys
    assert res.coverage is not None and res.coverage.max() > 5

    art = visualize(bg, ref, "chr1", 1480, 1520)
    assert "X" in art and "chr1:1480" in art


@pytest.mark.slow
def test_breakpoint_variants(world, rng):
    from biograph_jax.utils import find_breakpoint_variants

    # dedicated world with a 500bp deletion
    G = 6000
    flat = rng.integers(0, 4, G).astype(np.uint8)
    ref = Reference(
        flat=flat, is_n=np.zeros(G, bool), contigs=[Contig("chr1", 0, G)]
    )
    donor = np.concatenate([flat[:3000], flat[3500:]])
    rows = [donor[s : s + 100] for s in range(0, len(donor) - 100, 3)]
    codes = np.stack(rows).astype(np.uint8)
    lens = np.full(len(rows), 100, np.int32)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)

    class BG:
        pass

    bg = BG()
    bg.seqset = ss
    bg.readmap = rm
    res = find_breakpoint_variants(bg, ref, "chr1", 3000, 3500)
    dels = [v for v in res.variants if len(v["ref"]) - len(v["alt"]) == 500]
    assert len(dels) == 1, res.variants
