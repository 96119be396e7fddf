import numpy as np

from biograph_jax.core.bitvector import RankBits, popcount_np


def test_popcount():
    x = np.array([0, 1, 3, 0xFFFFFFFF, 0x80000000], np.uint32)
    assert list(popcount_np(x)) == [0, 1, 2, 32, 1]


def test_rank_matches_bruteforce(rng):
    n = 1000
    bits = rng.random(n) < 0.3
    rb = RankBits.from_bools(bits)
    cum = np.concatenate([[0], np.cumsum(bits)])
    idx = np.arange(n + 1)
    assert (rb.rank_np(idx) == cum).all()
    # device path
    assert (np.asarray(rb.rank(idx)) == cum).all()
    assert rb.total == bits.sum()


def test_get_and_positions(rng):
    n = 257
    bits = rng.random(n) < 0.5
    rb = RankBits.from_bools(bits)
    assert (np.asarray(rb.get(np.arange(n))) == bits).all()
    assert (rb.ones_positions() == np.nonzero(bits)[0]).all()


def test_from_positions():
    rb = RankBits.from_positions(np.array([0, 5, 31, 32, 63, 64]), 65)
    assert rb.total == 6
    assert list(rb.ones_positions()) == [0, 5, 31, 32, 63, 64]
    assert rb.rank_np(np.array([0, 1, 6, 32, 33, 65])).tolist() == [0, 1, 2, 3, 4, 6]
