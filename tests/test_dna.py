import numpy as np
import pytest

from biograph_jax.core import dna


def test_roundtrip():
    s = "ACGTTGCAACGT"
    codes = dna.seq_to_codes(s)
    assert dna.codes_to_seq(codes) == s


def test_revcomp_simple():
    codes = dna.seq_to_codes("ACGT")
    rc = dna.revcomp_codes(codes)
    assert dna.codes_to_seq(rc) == "ACGT"
    codes = dna.seq_to_codes("AACG")
    assert dna.codes_to_seq(dna.revcomp_codes(codes)) == "CGTT"


def test_revcomp_batched_lengths():
    codes = np.zeros((2, 6), np.uint8)
    codes[0, :4] = dna.seq_to_codes("AACG")
    codes[1, :6] = dna.seq_to_codes("TTTAAA")
    out = dna.revcomp_codes(codes, length=np.array([4, 6]))
    assert dna.codes_to_seq(out[0, :4]) == "CGTT"
    assert dna.codes_to_seq(out[1, :6]) == "TTTAAA"
    assert (out[0, 4:] == 0).all()


def test_pack_unpack():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(5, 40), dtype=np.uint8)
    lengths = np.array([40, 35, 17, 16, 1])
    words = dna.pack_codes(codes, lengths)
    assert words.shape == (5, 3)
    back = dna.unpack_words(words, 40)
    for i, L in enumerate(lengths):
        assert (back[i, :L] == codes[i, :L]).all()
        assert (back[i, L:] == 0).all()


def test_pack_order_is_lexicographic():
    # word-compare == string-compare for same-prefix-first ordering
    a = dna.pack_codes(dna.seq_to_codes("ACGTACGTACGTACGTA"))  # 17 bases
    b = dna.pack_codes(dna.seq_to_codes("ACGTACGTACGTACGTC"))
    assert tuple(a) < tuple(b)


def test_prefix_mask():
    m = dna.prefix_mask_words(np.array([0, 1, 16, 17, 32]), 2)
    assert m[0, 0] == 0 and m[0, 1] == 0
    assert m[1, 0] == 0xC0000000 and m[1, 1] == 0
    assert m[2, 0] == 0xFFFFFFFF and m[2, 1] == 0
    assert m[3, 1] == 0xC0000000
    assert m[4, 1] == 0xFFFFFFFF


def test_kmers_from_codes():
    codes = dna.seq_to_codes("ACGTA")[None, :]
    kmers, valid = dna.kmers_from_codes(codes, np.array([5]), 3)
    assert valid.all()
    # ACG=0b000110=6, CGT=0b011011=27, GTA=0b101100=44
    assert list(kmers[0]) == [6, 27, 44]


def test_revcomp_kmer_matches_string():
    rng = np.random.default_rng(1)
    for k in (3, 23, 31, 32):
        codes = rng.integers(0, 4, size=(1, k), dtype=np.uint8)
        kmers, _ = dna.kmers_from_codes(codes, np.array([k]), k)
        rc = dna.revcomp_kmer(kmers, k)[0, 0]
        expect = dna.codes_to_seq(dna.revcomp_codes(codes[0]))
        assert dna.kmer_to_seq(rc, k) == expect


def test_canonicalize():
    codes = dna.seq_to_codes("TTT")[None, :]
    kmers, _ = dna.kmers_from_codes(codes, np.array([3]), 3)
    canon, fwd = dna.canonicalize_kmers(kmers, 3)
    assert dna.kmer_to_seq(canon[0, 0], 3) == "AAA"
    assert not fwd[0, 0]
