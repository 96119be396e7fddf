import numpy as np
import pytest
import jax.numpy as jnp

from biograph_jax.ops.ltsearch import LtSearch


def _brute_back(vals, pos, c):
    for j in range(pos - 1, -1, -1):
        if vals[j] < c:
            return j
    return -1


def _brute_fwd(vals, pos, c):
    for j in range(pos + 1, len(vals)):
        if vals[j] < c:
            return j
    return len(vals)


def test_ltsearch_small(rng):
    vals = rng.integers(0, 8, size=700).astype(np.int32)
    lt = LtSearch.build(vals)
    pos = rng.integers(0, 700, size=200)
    c = rng.integers(0, 9, size=200).astype(np.int32)
    back = np.asarray(lt.next_backward_lt(jnp.asarray(pos), jnp.asarray(c)))
    fwd = np.asarray(lt.next_forward_lt(jnp.asarray(pos), jnp.asarray(c)))
    for i in range(200):
        assert back[i] == _brute_back(vals, pos[i], c[i]), (pos[i], c[i])
        assert fwd[i] == _brute_fwd(vals, pos[i], c[i]), (pos[i], c[i])


def test_ltsearch_cross_block(rng):
    # values arranged so matches are far away (cross many blocks)
    vals = np.full(2000, 100, np.int32)
    vals[3] = 1
    vals[1990] = 2
    lt = LtSearch.build(vals)
    back = np.asarray(lt.next_backward_lt(jnp.asarray([1500, 2, 4]), jnp.asarray([5, 5, 2])))
    assert list(back) == [3, -1, 3]
    fwd = np.asarray(lt.next_forward_lt(jnp.asarray([10, 1995, 3]), jnp.asarray([5, 5, 1])))
    assert list(fwd) == [1990, 2000, 2000]


@pytest.mark.slow
def test_push_front_drop_matches_reference_semantics():
    """push_front_drop drops context until the push succeeds."""
    from biograph_jax.core import dna
    from biograph_jax.build.seqset_build import build_seqset
    from biograph_jax.index.seqset import SeqsetRanges

    reads = ["ACGGCATTAA", "CATTAACCGG", "GGTTCCAAGG"]
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = dna.seq_to_codes(r)
        lens[i] = len(r)
    ss = build_seqset(codes, lens)

    # Walk a chimera of read0's tail and read1's head: plain push_front dies
    # at the junction, push_front_drop recovers by dropping context.
    s = "ACGGCATTAACCGG"  # read0 + read1 overlap chimera (valid overlap)
    r = SeqsetRanges(
        jnp.zeros(1, jnp.int64),
        jnp.full(1, ss.n_entries, jnp.int64),
        jnp.zeros(1, jnp.int32),
    )
    for ch in reversed(s):
        b = jnp.asarray([dna.seq_to_codes(ch)[0]], jnp.int32)
        r = ss.d.push_front_drop(r, b)
        assert int(r.begin[0]) < int(r.end[0])
    # A sequence with an impossible junction: drop must shrink context
    s2 = "TTTTGGTTCC"  # TTTT then read2's head; junction TTTTGG absent
    r = SeqsetRanges(
        jnp.zeros(1, jnp.int64),
        jnp.full(1, ss.n_entries, jnp.int64),
        jnp.zeros(1, jnp.int32),
    )
    sizes = []
    for ch in reversed(s2):
        b = jnp.asarray([dna.seq_to_codes(ch)[0]], jnp.int32)
        r = ss.d.push_front_drop(r, b)
        sizes.append(int(r.size[0]))
        assert int(r.begin[0]) < int(r.end[0])
    # context must have dropped at least once (size not strictly increasing)
    assert any(sizes[i + 1] <= sizes[i] for i in range(len(sizes) - 1))
