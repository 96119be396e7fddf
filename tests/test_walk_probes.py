"""The segmented work-queue walk must produce, for every position, exactly
the longest-existing-window range the probe pipeline computes (probe_ranges
+ exact recompute), checked against a brute-force linear scan over window
lengths (find_window is independently golden-gated)."""

import numpy as np
import jax.numpy as jnp
import pytest


@pytest.fixture(scope="module")
def walk_seqset():
    from biograph_jax.build.seqset_build import build_seqset

    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    reads = []
    for _ in range(150):
        p = rng.integers(0, 600 - 30)
        r = genome[p : p + 30].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1].copy()
        reads.append(r)
    codes = np.stack(reads)
    lengths = np.full(len(reads), 30, np.int32)
    ss = build_seqset(jnp.asarray(codes), jnp.asarray(lengths))
    # text: the genome with mutations sprinkled in (drops + restarts) and a
    # fully random tail (zero-coverage stretch: constant restarts)
    text = genome.copy()
    mut = rng.integers(0, 600, 40)
    text[mut] = (text[mut] + 1 + rng.integers(0, 3, 40)) % 4
    text = np.concatenate([text, rng.integers(0, 4, 120).astype(np.uint8)])
    return ss, text


def _brute(d, text, pos, ctx_lo, depth):
    """Longest existing window ending at each pos (linear scan over m)."""
    from biograph_jax.index.probes import find_window_jit

    P = pos.shape[0]
    bb = np.zeros(P, np.int64)
    be = np.full(P, d.n_entries, np.int64)
    bs = np.zeros(P, np.int32)
    w0 = np.minimum(depth, pos - ctx_lo + 1)
    posj = jnp.asarray(pos)
    for m in range(1, depth + 1):
        b, e, s = (
            np.asarray(x)
            for x in find_window_jit(
                d, jnp.asarray(text), posj, jnp.full((P,), m, jnp.int32), depth
            )
        )
        valid = (b < e) & (m <= w0)
        bb = np.where(valid, b, bb)
        be = np.where(valid, e, be)
        bs = np.where(valid, s, bs)
    return bb, be, bs


@pytest.mark.parametrize("lanes", [1, 7, 64])
def test_walk_matches_brute(walk_seqset, lanes):
    from biograph_jax.index.probes import walk_ranges_fused

    ss, text = walk_seqset
    d = ss.d
    depth = 25
    p0, P = 30, 512
    pos = p0 + np.arange(P, dtype=np.int64)
    eb, ee, es = _brute(d, text, pos, 0, depth)
    wb, we, ws = (
        np.asarray(x)
        for x in walk_ranges_fused(
            d, jnp.asarray(text), p0, 0, P, depth,
            lanes=lanes,
        )
    )
    exists = es > 0
    np.testing.assert_array_equal(wb[exists], eb[exists])
    np.testing.assert_array_equal(we[exists], ee[exists])
    np.testing.assert_array_equal(ws[exists], es[exists])
    # nothing exists: the walk reports the (empty) single-base fixed range
    assert (wb[~exists] >= we[~exists]).all()


def test_walk_ctx_lo_clip(walk_seqset):
    """Windows must not cross the segment low bound (strand-half boundary)."""
    from biograph_jax.index.probes import walk_ranges_fused

    ss, text = walk_seqset
    d = ss.d
    depth = 25
    ctx_lo = 47
    p0, P = ctx_lo, 256  # first owned position IS the boundary
    pos = p0 + np.arange(P, dtype=np.int64)
    eb, ee, es = _brute(d, text, pos, ctx_lo, depth)
    wb, we, ws = (
        np.asarray(x)
        for x in walk_ranges_fused(
            d, jnp.asarray(text), p0, ctx_lo, P, depth,
            lanes=5,
        )
    )
    exists = es > 0
    np.testing.assert_array_equal(wb[exists], eb[exists])
    np.testing.assert_array_equal(we[exists], ee[exists])
    np.testing.assert_array_equal(ws[exists], es[exists])
    assert (wb[~exists] >= we[~exists]).all()


@pytest.mark.slow
@pytest.mark.parametrize("own,widen_every,with_trunc", [
    (32, 8, True),
    (16, 4, False),
])
def test_walk_device_matches_brute(walk_seqset, own, widen_every, with_trunc,
                                   monkeypatch):
    """The single-launch device walk (cheap steps + deferred widens,
    probes.walk_ranges_device) must reproduce the brute-force longest-window
    ranges exactly, with and without the constant-threshold trunc tables,
    across lane geometries and multi-span requests."""
    from biograph_jax.index import probes as PR

    ss, text = walk_seqset
    d = ss.d
    depth = 25
    monkeypatch.setattr(PR, "WALK_DEV_OWN", own)
    monkeypatch.setattr(PR, "WALK_WIDEN_EVERY", widen_every)
    trunc = None
    if with_trunc:
        shared = np.asarray(ss.shared)
        n = len(shared)
        idx = np.arange(n, dtype=np.int64)
        lt = shared < depth
        prev_lt = np.maximum.accumulate(np.where(lt, idx, -1))
        nxt = np.where(lt, idx, n)
        next_lt = np.minimum.accumulate(nxt[::-1])[::-1]
        trunc = (jnp.asarray(prev_lt), jnp.asarray(next_lt.astype(np.int64)))
    reqs = [(30, 0, 512), (560, 550, 128)]
    got, check, _raw = PR.walk_ranges_device(
        d, jnp.asarray(text), reqs, depth, trunc=trunc
    )
    steps, undone = (int(x) for x in np.asarray(check))
    assert undone == 0, f"walk budget tripped with {undone} lanes undone"
    for (p0, ctx_lo, P), (gb, ge, gs) in zip(reqs, got):
        pos = p0 + np.arange(P, dtype=np.int64)
        eb, ee, es = _brute(d, text, pos, ctx_lo, depth)
        gb, ge, gs = (np.asarray(x) for x in (gb, ge, gs))
        exists = es > 0
        np.testing.assert_array_equal(gb[exists], eb[exists])
        np.testing.assert_array_equal(ge[exists], ee[exists])
        np.testing.assert_array_equal(gs[exists], es[exists])
        assert (gb[~exists] >= ge[~exists]).all()
