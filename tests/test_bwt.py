"""Reference BWT / FM-index tests (bwt_file.h:22 'SpiralBW' analog)."""

import numpy as np
import pytest

from biograph_jax.core import dna
from biograph_jax.index.bwt import RefBwt, build_suffix_array


def test_suffix_array_small():
    g = dna.seq_to_codes("ACGTACGTAC")
    sa = build_suffix_array(g)
    # brute force: suffixes + sentinel, sentinel smallest
    suff = ["".join("ACGT"[c] for c in g[i:]) for i in range(len(g))] + [""]
    order = sorted(range(len(suff)), key=lambda i: suff[i])
    assert list(sa) == order


def test_find_and_locate_random(rng):
    g = rng.integers(0, 4, 5000).astype(np.uint8)
    bwt = RefBwt.build(g)
    text = dna.codes_to_seq(g)
    for L in (1, 5, 17, 40):
        for _ in range(10):
            i = int(rng.integers(0, len(g) - L))
            q = text[i : i + L]
            lo, hi = bwt.find(q)
            # naive occurrence count
            want = sum(
                1 for j in range(len(text) - L + 1) if text[j : j + L] == q
            )
            assert int(hi[0] - lo[0]) == want, (L, q)
            pos = bwt.locate(int(lo[0]), int(hi[0]), max_hits=want)
            naive = [j for j in range(len(text) - L + 1) if text[j : j + L] == q]
            assert list(pos) == naive
    # absent query (longer than any repeat structure guarantees absence rarely;
    # construct one definitely absent by mutating)
    q = text[100:140]
    qm = "A" * 41 if "A" * 41 not in text else "C" * 41
    lo, hi = bwt.find(qm)
    assert int(hi[0] - lo[0]) == 0


def test_batched_find(rng):
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    bwt = RefBwt.build(g)
    B, L = 32, 25
    starts = rng.integers(0, len(g) - L, B)
    seqs = np.stack([g[s : s + L] for s in starts])
    lo, hi = bwt.find(seqs)
    assert (hi > lo).all()
    for i in range(B):
        pos = bwt.locate(int(lo[i]), int(hi[i]), max_hits=100)
        assert int(starts[i]) in list(pos)


def test_save_load_roundtrip(tmp_path, rng):
    g = rng.integers(0, 4, 2000).astype(np.uint8)
    bwt = RefBwt.build(g)
    bwt.save(str(tmp_path / "bwt"))
    b2 = RefBwt.load(str(tmp_path / "bwt"))
    q = dna.codes_to_seq(g[500:540])
    assert b2.count(q) == bwt.count(q) >= 1
    lo, hi = b2.find(q)
    assert 500 in list(b2.locate(int(lo[0]), int(hi[0])))


def test_lambda_reference_bwt():
    """Arbitrary-length exact queries over the real lambda reference."""
    from biograph_jax.index.reference import Reference

    ref = Reference.from_reference_dir(
        "/root/reference/datasets/lambdaToyData/benchmark/ref_lambda"
    )
    g = np.asarray(ref.flat)
    bwt = RefBwt.build(g)
    text = dna.codes_to_seq(g)
    # a 100-mer (far beyond the 16-mer seed-table cap) hits exactly once
    q = text[30000:30100]
    lo, hi = bwt.find(q)
    assert int(hi[0] - lo[0]) == text.count(q) == 1
    assert list(bwt.locate(int(lo[0]), int(hi[0]))) == [30000]
