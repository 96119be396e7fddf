"""Seqset construction + query tests against a brute-force model.

The brute-force model mirrors the structure definition exactly (see
biograph_jax.index.seqset docstring): entries = prefix-maximal distinct
suffixes of reads+revcomps in prefix-first lexicographic order.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from biograph_jax.core import dna
from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.index.seqset import SeqsetRanges


def _revcomp_str(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


class BruteSeqset:
    def __init__(self, reads):
        seqs = set()
        for r in reads:
            seqs.add(r)
            seqs.add(_revcomp_str(r))
        closure = set()
        for s in seqs:
            for j in range(len(s)):
                closure.add(s[j:])
        ordered = sorted(closure)
        self.entries = [
            s
            for i, s in enumerate(ordered)
            if i + 1 == len(ordered) or not ordered[i + 1].startswith(s)
        ]

    def find(self, q):
        """[begin, end) of entries with prefix q."""
        import bisect

        lo = bisect.bisect_left(self.entries, q)
        hi = lo
        while hi < len(self.entries) and self.entries[hi].startswith(q):
            hi += 1
        return lo, hi


def _reads_to_arrays(reads):
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = dna.seq_to_codes(r)
        lens[i] = len(r)
    return codes, lens


READSETS = [
    ["ACGTACGT"],
    ["ACGGCAT", "TTACGGC", "GCATTTT"],
    ["AAAA", "AAAT", "TTTT"],
    ["ACGTACGTACGTACGTAC", "GTACGTACGTACGTACGA"],  # crosses word boundary
]


@pytest.mark.parametrize("reads", READSETS)
def test_entries_match_bruteforce(reads):
    brute = BruteSeqset(reads)
    codes, lens = _reads_to_arrays(reads)
    ss = build_seqset(codes, lens)
    assert ss.n_entries == len(brute.entries)
    # entry sizes + reconstructed sequences
    for i, expect in enumerate(brute.entries):
        assert int(ss.entry_sizes[i]) == len(expect)
        assert ss.entry_sequence(i) == expect
    # shared = LCP with previous
    for i in range(1, ss.n_entries):
        a, b = brute.entries[i - 1], brute.entries[i]
        lcp = 0
        while lcp < min(len(a), len(b)) and a[lcp] == b[lcp]:
            lcp += 1
        assert int(ss.shared[i]) == lcp
    assert int(ss.shared[0]) == 0


@pytest.mark.parametrize("reads", READSETS)
def test_find_matches_bruteforce(reads):
    brute = BruteSeqset(reads)
    codes, lens = _reads_to_arrays(reads)
    ss = build_seqset(codes, lens)
    queries = []
    for r in reads:
        for j in range(len(r)):
            for k in range(1, len(r) - j + 1):
                queries.append(r[j : j + k])
    queries += ["A", "C", "G", "T", "AC", "GG", "TTTTTTTTTTTT"]
    qcodes, qlens = _reads_to_arrays(queries)
    got = ss.d.find(jnp.asarray(qcodes), jnp.asarray(qlens))
    for i, q in enumerate(queries):
        lo, hi = brute.find(q)
        if lo == hi:
            assert int(got.begin[i]) >= int(got.end[i]), q
        else:
            assert (int(got.begin[i]), int(got.end[i])) == (lo, hi), q
            assert int(got.size[i]) == len(q)


def test_find_existing_and_pop(rng):
    reads = [
        "".join(rng.choice(list("ACGT"), size=rng.integers(8, 30)))
        for _ in range(30)
    ]
    brute = BruteSeqset(reads)
    codes, lens = _reads_to_arrays(reads)
    ss = build_seqset(codes, lens)
    # find_existing on each read: entry must have the read as a prefix
    got = ss.d.find_existing(jnp.asarray(codes), jnp.asarray(lens))
    for i, r in enumerate(reads):
        e = int(got[i])
        assert brute.entries[e].startswith(r)
        assert e == brute.find(r)[0]
    # pop_front chains reconstruct sequences
    seqs = ss.d.sequences(jnp.arange(ss.n_entries, dtype=jnp.int64), ss.max_entry_len)
    for i, expect in enumerate(brute.entries):
        got_s = dna.codes_to_seq(np.asarray(seqs[i, : len(expect)]))
        assert got_s == expect


def test_pop_front_ranges():
    reads = ["ACGGCAT", "TTACGGC", "GCATTTT"]
    brute = BruteSeqset(reads)
    codes, lens = _reads_to_arrays(reads)
    ss = build_seqset(codes, lens)
    # take ranges for some sequences, pop, compare with brute find of s[1:]
    queries = ["ACGG", "GCAT", "TTACGGC", "CA"]
    qcodes, qlens = _reads_to_arrays(queries)
    r = ss.d.find(jnp.asarray(qcodes), jnp.asarray(qlens))
    popped = ss.d.pop_front_ranges(r)
    for i, q in enumerate(queries):
        lo, hi = brute.find(q[1:])
        assert (int(popped.begin[i]), int(popped.end[i])) == (lo, hi), q
        assert int(popped.size[i]) == len(q) - 1


def test_save_load(tmp_path):
    reads = ["ACGGCAT", "TTACGGC"]
    codes, lens = _reads_to_arrays(reads)
    ss = build_seqset(codes, lens)
    p = str(tmp_path / "seqset")
    ss.save(p)
    from biograph_jax.index.seqset import Seqset

    ss2 = Seqset.load(p)
    assert ss2.n_entries == ss.n_entries
    b1, e1, s1 = ss.find_str("ACGGC")
    b2, e2, s2 = ss2.find_str("ACGGC")
    assert (b1, e1, s1) == (b2, e2, s2)
