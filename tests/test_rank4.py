"""rank4_xla (the seqset's 4-way rank gather) and the seqset's gathers
against plain numpy references."""

import numpy as np
import pytest
import jax.numpy as jnp

from biograph_jax.core.bitvector import rank_cum
from biograph_jax.ops.rank4 import rank4_xla


def _popcount(x):
    x = np.asarray(x, np.uint64)
    return sum(((x >> np.uint64(k)) & np.uint64(1)) for k in range(32)).astype(np.int64)


def _structure(rng, nw):
    words = rng.integers(0, 1 << 32, (4, nw), dtype=np.uint64).astype(np.uint32)
    pc = _popcount(words)
    cum = np.cumsum(pc, axis=1) - pc
    return words, cum


def _rank4_np(words, cum, pos):
    """Bit-by-bit count of the set bits below each position, per base."""
    nw = words.shape[1]
    out = np.zeros((len(pos), 4), np.int64)
    for i, p in enumerate(pos):
        w, r = divmod(int(p), 32)
        for b in range(4):
            if w >= nw:
                out[i, b] = cum[b, -1] + _popcount(words[b, -1])
            else:
                low = int(words[b, w]) & ((1 << r) - 1)
                out[i, b] = cum[b, w] + bin(low).count("1")
    return out


@pytest.mark.parametrize("nw", [7, 300, 1000, 4097, 6144])
def test_rank4_xla_matches_popcount(rng, nw):
    words, cum = _structure(rng, nw)
    n = 32 * nw  # the structure's end lies on a word boundary
    bounds = [0, 1, 31, 32, 33, n // 2 // 32 * 32, n - 33, n - 32, n - 1, n]
    pos = np.concatenate([rng.integers(0, n + 1, 300), bounds]).astype(np.int64)
    got = np.asarray(rank4_xla(jnp.asarray(words), jnp.asarray(cum), pos))
    np.testing.assert_array_equal(got, _rank4_np(words, cum, pos))


def test_rank4_on_real_seqset(rng):
    """On a real (small) seqset rank4 answers each base's rank exactly as
    the per-base rank() does."""
    from biograph_jax.build.seqset_build import build_seqset

    codes = rng.integers(0, 4, (300, 40)).astype(np.uint8)
    lens = np.full(300, 40, np.int32)
    ss = build_seqset(codes, lens)
    pos = np.concatenate([rng.integers(0, ss.n_entries + 1, 600),
                          [0, 31, 32, ss.n_entries - 1, ss.n_entries]])
    got = np.asarray(rank4_xla(ss.d.prev_words, ss.d.prev_cum, jnp.asarray(pos)))
    d = ss.d
    for b in range(4):
        want = np.asarray(
            d.rank(jnp.full(len(pos), b, jnp.int32), jnp.asarray(pos))
        )
        assert (got[:, b] == want).all()


def test_push4_matches_push_front(rng):
    from biograph_jax.build.seqset_build import build_seqset

    codes = rng.integers(0, 4, (200, 30)).astype(np.uint8)
    lens = np.full(200, 30, np.int32)
    ss = build_seqset(codes, lens)
    d = ss.d
    # random valid ranges from a find over read prefixes
    q = codes[:64, :12]
    r = d.find(jnp.asarray(q), jnp.asarray(np.full(64, 12, np.int32)))
    nb4, ne4 = d.push4(r)
    for b in range(4):
        c = d.push_front(r, jnp.full((64,), b, jnp.int32))
        assert (np.asarray(nb4[:, b]) == np.asarray(c.begin)).all()
        assert (np.asarray(ne4[:, b]) == np.asarray(c.end)).all()


def test_sizes_at_exact_above_255(rng):
    """Entry sizes come back unclipped, past one byte, and indices past the
    last entry read the last entry."""
    from biograph_jax.build.seqset_build import build_seqset

    codes = rng.integers(0, 4, (12, 300)).astype(np.uint8)
    ss = build_seqset(codes, np.full(12, 300, np.int32))
    sizes = np.asarray(ss.entry_sizes)
    assert sizes.max() > 255
    n = ss.n_entries
    idx = np.concatenate([np.arange(n), [n, n + 7]])
    got = np.asarray(ss.d.sizes_at(jnp.asarray(idx)))
    np.testing.assert_array_equal(got, sizes[np.minimum(idx, n - 1)])


@pytest.mark.parametrize("shape", [(37,), (4, 300)])
def test_rank_cum_matches_numpy(rng, shape):
    words = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    pc = _popcount(words)
    want = np.cumsum(pc, axis=-1) - pc
    got = np.asarray(rank_cum(jnp.asarray(words)))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
