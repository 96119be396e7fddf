"""The rank-free probes must reproduce the fori-loop probe chains."""

import numpy as np
import jax.numpy as jnp
import pytest


def test_find_window_hash_matches_chain(rng):
    """The rank-free hash window probe (probes.find_window_hash) must
    reproduce find_window's (begin, end, size) exactly for its fixed
    length, including misses and group ranges wider than one entry."""
    from biograph_jax.build.seqset_build import build_seqset
    from biograph_jax.index.probes import find_window, find_window_hash

    R, L = 300, 40
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lens = np.full(R, L, np.int32)
    ss = build_seqset(codes, lens)
    d = ss.d
    # text containing real read content and noise
    text = np.concatenate(
        [codes[:40].reshape(-1), rng.integers(0, 4, 600)]
    ).astype(np.uint8)
    tdev = jnp.asarray(text)
    pos = jnp.asarray(
        np.concatenate([rng.integers(0, len(text), 400), [0, 1, len(text) - 1]])
    )
    for m in (8, 17, 25):
        hb, he, hs = find_window_hash(ss, tdev, pos, m)
        cb, ce, cs = find_window(
            d, tdev, pos, jnp.full(pos.shape, m, jnp.int32), m
        )
        # positions whose window would cross the text start: the chain
        # reads a zero-clamped garbage window (its callers mask them via
        # cap); the hash refuses outright — compare in-bounds lanes only
        inb = np.asarray(pos) >= m - 1
        hit_h = np.asarray(hb < he) & inb
        hit_c = np.asarray(cb < ce) & inb
        assert (hit_h == hit_c).all(), (m, np.nonzero(hit_h != hit_c)[0][:5])
        sel = hit_c
        assert (np.asarray(hb)[sel] == np.asarray(cb)[sel]).all(), m
        assert (np.asarray(he)[sel] == np.asarray(ce)[sel]).all(), m
        assert (np.asarray(hs)[sel] == np.asarray(cs)[sel]).all(), m
