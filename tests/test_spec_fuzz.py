"""SDK behavior spec, fuzzed (python/functest/spec_test.py + spec_fuzz analog).

Randomized read sets drive the public API; every invariant below is a
behavioral contract of the reference SDK (python/biograph/__init__.py
Seqset/SeqsetEntry semantics) and must hold for ANY input:

  F1  find(s) of a read's prefix is valid; its sequence round-trips.
  F2  push_front: find(b + s) == find(s).push_front(b), including
      invalidity agreement.
  F3  pop_front of find(s) contains find(s[1:]) (pop drops the first base;
      the popped range may widen to the longest stored suffix context).
  F4  truncate(m) == the range of the FIRST m bases of the query.
  F5  a substring occurs in some read or rev-comp  <=>  find is valid.
  F6  rev-comp closure: find(rc(s)) valid iff find(s) valid.
  F7  every seqset entry is prefix-maximal: push_front in all 4 bases of
      the full-length entry range never yields a superstring entry
      equal in length (entries are never proper prefixes of entries).
  F8  FM-index count(s) == brute-force occurrence count in the reference.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from biograph_jax.core import dna


def _mk(rng, n_reads=60, L=28):
    genome = rng.integers(0, 4, 500).astype(np.uint8)
    rows = []
    for _ in range(n_reads):
        p = rng.integers(0, len(genome) - L)
        r = genome[p : p + L].copy()
        if rng.random() < 0.3:  # mutations so the read set isn't pure genome
            r[rng.integers(0, L)] = rng.integers(0, 4)
        if rng.random() < 0.5:
            r = (3 - r)[::-1].copy()
        rows.append(r)
    return np.stack(rows), np.full(n_reads, L, np.int32)


def _substr_exists(codes, lengths, q):
    """Brute force: q appears in some read or read rev-comp."""
    qs = dna.codes_to_seq(q)
    for row, ln in zip(codes, lengths):
        s = dna.codes_to_seq(row[:ln])
        rc = dna.codes_to_seq((3 - row[:ln])[::-1])
        if qs in s or qs in rc:
            return True
    return False


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 23])
def test_sdk_spec_fuzz(seed, tmp_path):
    import json
    import os

    from biograph_jax.api import BioGraph
    from biograph_jax.build.readmap_build import build_readmap
    from biograph_jax.build.seqset_build import build_seqset

    rng = np.random.default_rng(seed)
    codes, lengths = _mk(rng)
    ss = build_seqset(codes, lengths)
    rm = build_readmap(ss, codes, lengths)
    path = str(tmp_path / f"f{seed}.bgt")
    os.makedirs(path, exist_ok=True)
    ss.save(os.path.join(path, "seqset"))
    rm.save(os.path.join(path, "readmap"))
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({"accession_id": f"fuzz{seed}"}, f)
    bg = BioGraph(path)

    B = "ACGT"
    for _ in range(25):
        i = rng.integers(0, len(lengths))
        ln = int(lengths[i])
        # bucketed lengths: every distinct shape pays a jit compile
        m = int(rng.choice([6, 12, 20, 28]))
        off = int(rng.integers(0, ln - m + 1))
        q = codes[i, off : off + m]
        qs = dna.codes_to_seq(q)

        # F1 + F5 (positive side)
        e = bg.find(qs)
        assert e.valid, qs
        assert str(e.sequence(m)) == qs

        # F2 push_front
        for b in range(4):
            lhs = bg.find(B[b] + qs)
            rhs = e.push_front(B[b])
            assert lhs.valid == rhs.valid
            if lhs.valid:
                assert (lhs.begin, lhs.end) == (rhs.begin, rhs.end)

        # F3 pop_front covers the suffix range
        if m > 4:
            sub = bg.find(qs[1:])
            pop = e.pop_front()
            assert pop.valid and sub.valid
            assert pop.begin <= sub.begin and sub.end <= pop.end

        # F4 truncate(m2) == find of the FIRST m2 bases (drop context from
        # the back; matches seqset_range::truncate, seqset.h:245)
        m2 = int(rng.choice([2, 5, 11]))
        m2 = min(m2, m - 1)
        tr = e.truncate(m2)
        direct = bg.find(qs[:m2])
        assert tr.valid and direct.valid
        assert (tr.begin, tr.end, tr.size) == (
            direct.begin,
            direct.end,
            direct.size,
        )

        # F6 rev-comp closure
        rc = dna.codes_to_seq((3 - q)[::-1])
        assert bg.find(rc).valid

    # F5 negative side: random strings absent from the reads must be invalid
    for _ in range(20):
        q = rng.integers(0, 4, 16).astype(np.uint8)
        want = _substr_exists(codes, lengths, q)
        got = bg.find(dna.codes_to_seq(q)).valid
        assert got == want, dna.codes_to_seq(q)

    # F7 prefix-maximality of entries
    sizes = np.asarray(ss.entry_sizes)
    ids = rng.integers(0, ss.n_entries, 10)
    for eid in ids:
        e = bg.entry(int(eid))
        full = e.sequence()
        for b in B:
            sup = bg.find(b + str(full))
            # a valid superstring must be strictly longer than the entry —
            # equal length would make the entry a proper prefix of another
            if sup.valid:
                assert sup.size == len(full) + 1


@pytest.mark.parametrize("seed", [3])
def test_fm_index_fuzz(seed):
    from biograph_jax.index.bwt import RefBwt

    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, 800).astype(np.uint8)
    fm = RefBwt.build(text)
    for _ in range(60):
        m = int(rng.integers(1, 20))
        if rng.random() < 0.7:
            p = int(rng.integers(0, len(text) - m))
            q = text[p : p + m]
        else:
            q = rng.integers(0, 4, m).astype(np.uint8)
        # brute force occurrences
        want = sum(
            1
            for i in range(len(text) - m + 1)
            if (text[i : i + m] == q).all()
        )
        got = fm.count(dna.codes_to_seq(q))
        assert got == want, (m, dna.codes_to_seq(q))
