"""LtTree (while-free segment-tree less-than search) must agree with the
LtSearch block structure and a brute-force scan on random value arrays —
both query directions, including out-of-range positions and thresholds
below/above every value (ops/ltsearch.py; reference semantics:
less_than_search used by seqset.cpp:350-427 push_front_drop)."""

import numpy as np
import jax.numpy as jnp
import pytest

from biograph_jax.ops.ltsearch import LtSearch, LtTree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lttree_matches_brute(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 700))
    vals = rng.integers(0, 40, n).astype(np.int32)
    lt = LtTree.build(vals)
    Q = 256
    pos = rng.integers(-1, n + 2, Q).astype(np.int64)
    c = rng.integers(0, 45, Q).astype(np.int32)
    bb = np.full(Q, -1, np.int64)
    bf = np.full(Q, n, np.int64)
    for qi in range(Q):
        for j in range(min(pos[qi], n) - 1, -1, -1):
            if vals[j] < c[qi]:
                bb[qi] = j
                break
        for j in range(max(pos[qi] + 1, 0), n):
            if vals[j] < c[qi]:
                bf[qi] = j
                break
    tb = np.asarray(lt.next_backward_lt(jnp.asarray(pos), jnp.asarray(c)))
    tf = np.asarray(lt.next_forward_lt(jnp.asarray(pos), jnp.asarray(c)))
    assert (tb == bb).all()
    assert (tf == bf).all()


def test_lttree_matches_ltsearch():
    rng = np.random.default_rng(7)
    n = 2000
    vals = rng.integers(0, 60, n).astype(np.int32)
    ls = LtSearch.build(vals)
    lt = LtTree.build(vals)
    pos = jnp.asarray(rng.integers(0, n, 512))
    c = jnp.asarray(rng.integers(1, 64, 512).astype(np.int32))
    assert (
        np.asarray(ls.next_backward_lt(pos, c))
        == np.asarray(lt.next_backward_lt(pos, c))
    ).all()
    assert (
        np.asarray(ls.next_forward_lt(pos, c))
        == np.asarray(lt.next_forward_lt(pos, c))
    ).all()


def test_lttree_device_build_matches_host():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 50, 777).astype(np.int32)
    host = LtTree.build(vals)
    dev = LtTree.build(jnp.asarray(vals))
    assert host.n == dev.n and host.m == dev.m
    assert (np.asarray(host.tree) == np.asarray(dev.tree)).all()
