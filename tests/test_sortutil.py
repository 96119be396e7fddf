import numpy as np
import jax.numpy as jnp

from biograph_jax.core import dna
from biograph_jax.ops import sortutil


def _pack_strs(strs):
    L = max(len(s) for s in strs)
    W = dna.words_for_bases(L)
    codes = np.zeros((len(strs), W * 16), np.uint8)
    lens = np.zeros(len(strs), np.int32)
    for i, s in enumerate(strs):
        codes[i, : len(s)] = dna.seq_to_codes(s)
        lens[i] = len(s)
    return dna.pack_codes(codes, lens), lens


def _prefix_first_sorted(strs):
    # python string sort IS prefix-first lexicographic for A<C<G<T chars
    return sorted(strs)


def test_device_sort_matches_string_sort(rng):
    alpha = "ACGT"
    strs = [
        "".join(rng.choice(list(alpha), size=rng.integers(1, 40)))
        for _ in range(300)
    ]
    strs += ["ACGT", "ACGTA", "ACG", "ACGT"]  # prefixes + duplicates
    words, lens = _pack_strs(strs)
    sw, sl, _ = sortutil.sort_sequences_device(jnp.asarray(words), jnp.asarray(lens))
    got = []
    cw = np.asarray(sw)
    cl = np.asarray(sl)
    for i in range(len(strs)):
        codes = dna.unpack_words(cw[i], int(cl[i]))
        got.append(dna.codes_to_seq(codes))
    assert got == _prefix_first_sorted(strs)


def test_lcp_and_prefix_flags():
    strs = sorted(["ACGT", "ACGT", "ACGTA", "ACCA", "TTT", "TT", "AC"])
    words, lens = _pack_strs(strs)
    sw, sl, _ = sortutil.sort_sequences_device(jnp.asarray(words), jnp.asarray(lens))
    lcp = np.asarray(sortutil.lcp_with_prev(sw, sl))
    dup = np.asarray(sortutil.rows_equal(sw, sl))
    pref = np.asarray(sortutil.is_prefix_of_next(sw, sl))
    # sorted: AC ACCA ACGT ACGT ACGTA TT TTT
    assert list(lcp) == [0, 2, 2, 4, 4, 0, 2]
    assert list(dup) == [False, False, False, True, False, False, False]
    assert list(pref) == [True, False, True, True, False, True, False]


def test_merge_lower_bound(rng):
    entries = sorted(set(["ACCA", "ACGTA", "GTT", "TTT"]))
    queries = ["AAA", "ACCA", "ACG", "ACGTA", "ACGTAA", "G", "TTT", "TTTT", "ZZZ".replace("Z", "T")]
    ew, el = _pack_strs(entries)
    qw, ql = _pack_strs(queries)
    # pad query words to same W
    W = max(ew.shape[1], qw.shape[1])
    ew = np.pad(ew, ((0, 0), (0, W - ew.shape[1])))
    qw = np.pad(qw, ((0, 0), (0, W - qw.shape[1])))
    lb = np.asarray(
        sortutil.merge_lower_bound(
            jnp.asarray(ew), jnp.asarray(el), jnp.asarray(qw), jnp.asarray(ql)
        )
    )
    import bisect

    expect = [bisect.bisect_left(entries, q) for q in queries]
    assert list(lb) == expect
