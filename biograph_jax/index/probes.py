"""Per-position probe ranges: the parallel replacement for sequential walks.

Every walk in the reference (ref_map building, tracer context tracking,
readmap::approx_coverage, modules/bio_base/readmap.cpp:368) advances one
position at a time because push_front_drop's context drops are sequential.
On an accelerator that shape is poison: thousands of tiny dependent steps.  These
probes compute each position's walk state INDEPENDENTLY — the state at
position j is fully determined by the text: it is the seqset range of the
longest window of length <= depth ending at j that exists (matching
statistics of the text against the read set).  That makes every position a
lane and caps sequential depth at the probe depth (~25-35 steps).

Windows are pushed complemented (the discovery/coverage convention: ranges
live in reverse-complement space so extending rightward is a push_front,
see modules/bio_base/readmap.cpp:368).

Existence is monotone in window length (the seqset holds every suffix of
every read — a window exists iff it is a substring of some read or
reverse complement, and substrings of substrings exist), which gives:
  * probe_ranges: one lockstep chain, restarting on mismatch.  A restart
    can under-estimate the longest window; such lanes come back flagged.
  * probe_exact: binary search over the window length for flagged lanes —
    each test is a pure push_front find chain, no widening searches.

`text` may be any uint8 code array (a doubled fwd++rc reference, or
flattened query rows); `seg_lo` (scalar or per-lane) clips each window's
left edge (strand-half boundary / row start).
"""

from __future__ import annotations

import os as _os
from functools import partial as _partial

import numpy as _np
import jax
import jax.numpy as jnp
from jax import lax

from biograph_jax.index.seqset import SeqsetRanges


def probe_ranges(d, text, p0, seg_lo, P: int, depth: int):
    """Probe positions p0..p0+P-1; returns (begin, end, size, restarted)."""
    n2 = text.shape[0]
    pos = p0 + jnp.arange(P, dtype=jnp.int64)
    w0 = jnp.minimum(depth, (pos - seg_lo + 1)).astype(jnp.int32)

    def step(s, state):
        begin, end, size, restarted = state
        idx = jnp.clip(pos - (depth - 1) + s, 0, n2 - 1)
        b = (3 - jnp.take(text, idx)).astype(jnp.int32)
        started = s >= (depth - w0)
        r2 = d.push_front(SeqsetRanges(begin, end, size), b)
        ok = r2.begin < r2.end
        # restart: the range of the lone base b is [fixed[b], fixed[b+1])
        b64 = b.astype(jnp.int64)
        nb = jnp.where(ok, r2.begin, jnp.take(d.fixed, b64))
        ne = jnp.where(ok, r2.end, jnp.take(d.fixed, b64 + 1))
        nsize = jnp.where(ok, r2.size, 1)
        restarted = restarted | (started & ~ok & (size > 0))
        return (
            jnp.where(started, nb, begin),
            jnp.where(started, ne, end),
            jnp.where(started, nsize, size),
            restarted,
        )

    state = (
        jnp.zeros((P,), jnp.int64),
        jnp.full((P,), d.n_entries, jnp.int64),
        jnp.zeros((P,), jnp.int32),
        jnp.zeros((P,), bool),
    )
    return jax.lax.fori_loop(0, depth, step, state)


probe_ranges_jit = jax.jit(probe_ranges, static_argnums=(4, 5))


def find_window(d, text, pos, m, depth: int):
    """Range of the length-m window ending at each pos (masked find chain).

    The push index at step s is pos - (depth-1) + s regardless of m; only
    the start mask differs, so every chain shape is identical."""
    n2 = text.shape[0]
    P = pos.shape[0]

    def step(s, state):
        begin, end, size = state
        idx = jnp.clip(pos - (depth - 1) + s, 0, n2 - 1)
        b = (3 - jnp.take(text, idx)).astype(jnp.int32)
        started = s >= (depth - m)
        r2 = d.push_front(SeqsetRanges(begin, end, size), b)
        return (
            jnp.where(started, r2.begin, begin),
            jnp.where(started, r2.end, end),
            jnp.where(started, r2.size, size),
        )

    state = (
        jnp.zeros((P,), jnp.int64),
        jnp.full((P,), d.n_entries, jnp.int64),
        jnp.zeros((P,), jnp.int32),
    )
    return jax.lax.fori_loop(0, depth, step, state)


def probe_exact(d, text, pos, seg_lo, depth: int, min_m: int = 0, seed=None):
    """Exact longest-window probe for the (padded) restarted positions.

    Binary search on the window length; a restarted lane is guaranteed
    longest < w0, and EXISTS(m) is monotone, so at most ceil(log2(depth))
    rounds of find chains pin it down.

    min_m > 0 narrows the search to [min_m, w0]: callers that only consume
    windows of at least min_m bases (anchor detection needs
    size >= min_anchor_ctx; coverage counting needs size >= min_read_len)
    should pre-filter lanes with find_window(min_m) and pass the bound here —
    rounds drop from log2(depth) to log2(depth - min_m + 1), and the caller's
    filter already holds the exact answer when min_m == depth (zero rounds).
    Lanes whose longest window is < min_m return whatever the bracket pins
    (an existing >= min_m window was asserted by the caller's filter)."""
    w0 = jnp.minimum(depth, (pos - seg_lo + 1)).astype(jnp.int32)
    lo_m = jnp.full_like(w0, min_m) if min_m else jnp.zeros_like(w0)
    lo_m = jnp.minimum(lo_m, w0)
    hi_m = w0
    P = pos.shape[0]
    # best-so-far range: lo_m only moves on a successful test, so the last
    # successful chain's range IS the final answer — no closing find needed
    bb = jnp.zeros((P,), jnp.int64)
    be = jnp.full((P,), d.n_entries, jnp.int64)
    bs = jnp.zeros((P,), jnp.int32)
    if min_m:
        # the caller asserted EXISTS(min_m); seed best-so-far with it so a
        # bracket that never improves still returns a valid range.  The
        # caller's filter chain already computed this range — pass it via
        # `seed` to skip the recompute.
        bb, be, bs = (
            seed if seed is not None else find_window(d, text, pos, lo_m, depth)
        )
        rounds = (depth - min_m).bit_length()
    else:
        rounds = max((depth - 1).bit_length(), 1)
    for _ in range(rounds):
        mid = (lo_m + hi_m) // 2
        mid = jnp.where(hi_m - lo_m > 1, mid, lo_m)
        b, e, s = find_window(d, text, pos, mid, depth)
        ok = (b < e) & (mid > lo_m)
        lo_m = jnp.where(ok, mid, lo_m)
        hi_m = jnp.where(b < e, hi_m, jnp.minimum(mid, hi_m))
        bb = jnp.where(ok, b, bb)
        be = jnp.where(ok, e, be)
        bs = jnp.where(ok, s, bs)
    return bb, be, bs


probe_exact_jit = jax.jit(probe_exact, static_argnums=(4, 5))
find_window_jit = jax.jit(find_window, static_argnums=(4,))


def _sel4(b, c0, c1, c2, c3):
    """Per-lane 4-way select: lax.select_n lowers to elementwise selects
    where a take_along_axis over the same data would lower to a gather."""
    return lax.select_n(b, c0, c1, c2, c3)


# ---------------------------------------------------------------------------
# Segmented work-queue walk: O(P) rank work instead of the probes' O(P*depth)
#
# Matching statistics the reference's way (ref_map builds by scanning the
# reference THROUGH the seqset with push_front_drop, ref_map.h:49), but over
# SIMD lanes: each lane owns a contiguous slice of positions and walks it
# sequentially; per dispatched step a lane either ADVANCES one position (its
# push succeeded — probe semantics: window exists after the short-entry kick)
# or performs ONE context DROP (the body of seqset.push_front_drop's widen
# loop, seqset.cpp:350-427, unrolled one iteration per step).  All lanes
# share one stacked rank4 gather per step.  Total rank work
# ~ 2*(P + lanes*depth) vs the probe pipeline's P*depth(+exact rounds):
# ~10x less at depth 25.
#
# Output contract: identical to probe_ranges + probe_exact recompute of every
# restarted lane — for each position j in [p0, p0+P), the seqset range of the
# longest existing window ending at j with length <= min(depth, j-ctx_lo+1)
# (capped by a truncate when a push would exceed depth).  Lanes start a
# `depth`-deep halo before their own slice (clamped at ctx_lo), so the state
# is exact by the first owned position.  Positions where even the single
# base does not occur get that base's empty fixed range with size 1, exactly
# like the probe restart.  Equivalence is test-gated on CPU
# (tests/test_walk_probes.py).
# ---------------------------------------------------------------------------

# lane geometry: lanes = min(WALK_LANES max, ceil(P / WALK_OWN)) — each lane
# owns ~WALK_OWN positions after its depth-long halo, so total steps stay
# ~WALK_OWN + depth while the per-step rank batch stays wide
WALK_LANES = int(_os.environ.get("BGT_WALK_LANES", str(1 << 18)))
WALK_OWN = int(_os.environ.get("BGT_WALK_OWN", "32"))
# extra steps enqueued sync-free past the guaranteed minimum: covers the
# typical drop tail so most spans converge before the first (expensive)
# undone poll; wasted blocks on already-done lanes are ~ms of device work
WALK_TAIL_MARGIN = int(_os.environ.get("BGT_WALK_TAIL_MARGIN", "64"))


def _walk_step(d, text, carry, depth: int):
    pos, begin, end, ctx, outb, oute, outc, p0, own_hi = carry
    S = pos.shape[0]
    n = d.n_entries
    n2 = text.shape[0]
    done = pos >= own_hi
    b = (3 - jnp.take(text, jnp.clip(pos, 0, n2 - 1))).astype(jnp.int32)
    # push candidate: one stacked rank4 gather for both range ends
    r4 = d.rank4(jnp.concatenate([begin, end]))
    b2 = jnp.concatenate([b, b])
    rsel = _sel4(b2, r4[:, 0], r4[:, 1], r4[:, 2], r4[:, 3]).astype(jnp.int64)
    fb = _sel4(b, *(jnp.broadcast_to(d.fixed[j], (S,)) for j in range(4)))
    fe = _sel4(b, *(jnp.broadcast_to(d.fixed[j + 1], (S,)) for j in range(4)))
    nb0 = fb + rsel[:S]  # pre-kick child (push_front_drop's fixed_b + sub_b)
    ne = fb + rsel[S:]
    nctx = ctx + 1
    first = jnp.clip(nb0, 0, n - 1)
    sizes_first = d.sizes_at(first).astype(jnp.int32)
    kick = (nb0 < ne) & (sizes_first < nctx)
    nb = nb0 + kick.astype(nb0.dtype)
    ok = nb < ne  # window exists (post-kick, probe/push_front semantics)
    invalid_in = begin >= end
    # advance: push succeeded, or nothing to drop (empty context / invalid
    # range) -> restart with the single-base range (probe restart semantics)
    adv = (ok | (ctx == 0) | invalid_in) & ~done
    ab = jnp.where(ok, nb, fb)
    ae = jnp.where(ok, ne, fe)
    actx = jnp.where(ok, nctx, 1)
    # cap the context at depth (probe windows never exceed depth): widen the
    # (depth+1)-window range back out to the maximal depth-sharing run
    over = adv & (actx > depth)
    # drop: ONE widen iteration of push_front_drop's loop (min_ctx=0,
    # seqset.cpp:350-427); the post-widen ranks are recomputed by the next
    # step's rank4, so no extra rank launches here
    shared_b = jnp.take(d.shared, jnp.clip(begin, 0, n - 1)).astype(jnp.int32)
    shared_e = jnp.where(
        end >= n,
        0,
        jnp.take(d.shared, jnp.clip(end, 0, n - 1)),
    ).astype(jnp.int32)
    drop = jnp.maximum(shared_b, shared_e)
    # lone-short: a single continuation entry exists but is too short
    # (sub_b != sub_e pre-kick) — drop to just below its full length
    drop = jnp.where(
        nb0 != ne, jnp.maximum(drop, sizes_first - 1), drop
    )
    upd_b = (begin > 0) & (shared_b >= drop)
    upd_e = (end < n) & (shared_e >= drop)
    # cap-widen and drop-widen are mutually exclusive per lane (over => adv,
    # drop => ~adv): ONE LtSearch boundary-query pair serves both
    # (_widen semantics: back from begin+1, forward from end-1, index/
    # seqset.py _widen)
    qb = jnp.where(over, ab + 1, jnp.where(upd_b, begin, 1))
    qe = jnp.where(over, ae - 1, jnp.where(upd_e, end, jnp.int64(n - 1)))
    lvl = jnp.where(over, depth, drop)
    wb = d.shared_lt.next_backward_lt(qb, lvl)
    we = d.shared_lt.next_forward_lt(qe, lvl)
    ab = jnp.where(over, jnp.maximum(wb, 0), ab)
    ae = jnp.where(over, we, ae)
    actx = jnp.minimum(actx, depth)
    dbegin = jnp.where(upd_b, jnp.maximum(wb, 0), begin)
    dend = jnp.where(upd_e, we, end)
    # no-progress safety (push_front_drop marks such lanes dead; here the
    # lane restarts, which a later step turns into single-base advance)
    noprog = ~adv & ~done & (drop == ctx) & ~upd_b & ~upd_e
    dbegin = jnp.where(noprog, jnp.zeros_like(dbegin), dbegin)
    dend = jnp.where(noprog, jnp.zeros_like(dend), dend)
    dctx = jnp.where(noprog, 0, drop)
    # merge: advanced lanes take the (capped) child and move on; dropping
    # lanes widen in place; done lanes hold
    begin2 = jnp.where(done, begin, jnp.where(adv, ab, dbegin))
    end2 = jnp.where(done, end, jnp.where(adv, ae, dend))
    ctx2 = jnp.where(done, ctx, jnp.where(adv, actx, dctx))
    # scatter owned outputs (halo and done lanes park at the spill slot P)
    oidx = jnp.where(adv & (pos >= p0), pos - p0, outb.shape[0] - 1)
    outb = outb.at[oidx].set(ab)
    oute = oute.at[oidx].set(ae)
    outc = outc.at[oidx].set(actx)
    pos2 = jnp.where(adv, pos + 1, pos)
    return (pos2, begin2, end2, ctx2, outb, oute, outc, p0, own_hi)


# walk steps unrolled into each dispatched device program
CHAIN_BLOCK = int(_os.environ.get("BGT_CHAIN_BLOCK", "8"))


@_partial(jax.jit, static_argnums=(3, 4))
def _walk_block(d, text, carry, depth: int, nsteps: int):
    """CHAIN_BLOCK walk steps fused into one device program."""
    for _ in range(nsteps):
        carry = _walk_step(d, text, carry, depth)
    return carry


@jax.jit
def _walk_undone(pos, own_hi):
    return jnp.sum(pos < own_hi)


def _walk_carry(d, p0: int, ctx_lo: int, P: int, depth: int, S: int, L: int):
    own_lo = p0 + _np.arange(S, dtype=_np.int64) * L
    own_hi = _np.minimum(own_lo + L, p0 + P)
    start = _np.maximum(own_lo - depth, int(ctx_lo))
    start = _np.minimum(start, own_hi)
    return (
        jnp.asarray(start),
        jnp.zeros((S,), jnp.int64),
        jnp.full((S,), d.n_entries, jnp.int64),
        jnp.zeros((S,), jnp.int32),
        jnp.zeros((P + 1,), jnp.int64),
        jnp.zeros((P + 1,), jnp.int64),
        jnp.zeros((P + 1,), jnp.int32),
        jnp.asarray(p0, jnp.int64),
        jnp.asarray(own_hi),
    )


def walk_ranges_fused(d, text, p0, ctx_lo, P: int, depth: int,
                      lanes: int | None = None):
    """Per-position maximal-window ranges for [p0, p0+P) — walk engine.

    Returns (begin[P], end[P], size[P]) equal to the probe pipeline's
    exact values (probe_ranges + probe_exact recompute of every restarted
    lane); `ctx_lo` clips window left edges (strand-half boundary).
    """
    return walk_ranges_multi(
        d, text, [(p0, ctx_lo, P)], depth, lanes
    )[0]


def walk_ranges_multi(d, text, reqs, depth: int, lanes: int | None = None):
    """walk_ranges_fused over several position spans with PIPELINED dispatch.

    reqs: list of (p0, ctx_lo, P) — each walks [p0, p0+P).  Lane counts are
    sized per span so each lane owns ~WALK_OWN positions (total steps stay
    ~WALK_OWN + depth regardless of span length).  Phase 1 enqueues every
    span's guaranteed-minimum step blocks without a single sync — the
    device drains a deep queue while the host keeps feeding it.  Phase 2 polls each span's convergence (one tiny
    fetch; drop-heavy spans get extra blocks).
    Returns a list of (begin[P], end[P], size[P]) device arrays."""
    geom = []
    carries = []
    for p0, ctx_lo, P in reqs:
        S = max(min(lanes or min(WALK_LANES, -(-P // WALK_OWN)), P), 1)
        L = -(-P // S)
        geom.append((S, L, P))
        carries.append(_walk_carry(d, int(p0), int(ctx_lo), P, depth, S, L))
    # every lane needs own span + halo pushes; drops add a data-dependent
    # tail.  A host sync drains the queue while an async enqueue does not,
    # so the driver is built around syncs, not launches: phase 1 enqueues every span's guaranteed minimum plus a
    # tail margin with no syncs at all; phase 2 polls ALL spans' undone
    # counts in ONE fused fetch per round and enqueues geometrically
    # growing block batches between rounds — total syncs stay O(log tail)
    # instead of O(tail / CHAIN_BLOCK) per span.
    steps = [0] * len(carries)

    def _enqueue(i, nsteps):
        c = carries[i]
        while nsteps > 0:
            c = _walk_block(d, text, c, depth, CHAIN_BLOCK)
            steps[i] += CHAIN_BLOCK
            nsteps -= CHAIN_BLOCK
        carries[i] = c

    for i, (S, L, P) in enumerate(geom):  # phase 1: async, no syncs
        _enqueue(i, L + depth + WALK_TAIL_MARGIN)
    active = list(range(len(carries)))
    batch = CHAIN_BLOCK
    while active:
        und = _np.asarray(  # ONE sync for every active span
            jnp.stack([_walk_undone(carries[i][0], carries[i][8])
                       for i in active])
        )
        nxt = []
        for u, i in zip(und, active):
            if int(u) == 0:
                continue
            S, L, P = geom[i]
            if steps[i] > 4 * (L + depth) + 256:
                raise RuntimeError(
                    f"walk_ranges_multi: no convergence after {steps[i]} "
                    f"steps (L={L}, depth={depth}) — drop loop stuck"
                )
            nxt.append(i)
        for i in nxt:
            _enqueue(i, batch)
        batch = min(2 * batch, 128)
        active = nxt
    return [
        (carry[4][:P], carry[5][:P], carry[6][:P])
        for carry, (S, L, P) in zip(carries, geom)
    ]


# ---------------------------------------------------------------------------
# Device-resident walk: the WHOLE multi-span walk as ONE device program
#
# The host-dispatched walk above keeps the rank-work win (O(P + lanes*depth)
# vs the probes' O(P*depth)) but pays one dispatch per CHAIN_BLOCK steps.
# This variant moves the step loop INSIDE jit (lax.while_loop with an
# all-lanes-done exit), so a whole genome's matching statistics cost ONE
# launch and ZERO host syncs.  It needs no nested DYNAMIC while_loops (the shared_lt structure must be the unrolled LtTree,
# ops/ltsearch.py — the two-level LtSearch's block-pointer walk is a
# while_loop and nests here).  Reference semantics unchanged: identical
# output contract to probe_ranges + probe_exact (ref_map.h:49 scan,
# push_front_drop widen loop seqset.cpp:350-427).
# ---------------------------------------------------------------------------


def _walk_cheap_step(d, text, trunc, carry, depth: int):
    """One ADVANCE-OR-DEFER walk step (pure XLA, loop-safe, LtTree-free).

    Same push/advance math as _walk_step, with two cost changes that make a
    device-resident loop competitive:
      * the at-cap widen (window grown past `depth`) uses the O(1)
        fixed-threshold trunc tables when available (the wavefront's
        _trunc_tables at the same threshold) instead of a tree search;
      * a failed push does NOT widen inline — the lane computes its drop
        level (cheap gathers) and STALLS as `pending`; the periodic
        _walk_widen_step serves all pending lanes' tree queries at once.
        Deferral is pure scheduling: the lane's state is untouched until
        the widen applies exactly the math _walk_step would have.
    Per-lane ownership: a lane only scatters positions in its own
    [own_lo, own_hi) slice (the host-loop variant's halo writes raced with
    the owner's on .at[].set ordering); flat output index = pos + obase.
    """
    (pos, begin, end, ctx, outb, oute, outc, obase, own_lo, own_hi,
     pending, pend_lvl, pend_flags) = carry
    S = pos.shape[0]
    n = d.n_entries
    n2 = text.shape[0]
    done = pos >= own_hi
    live = ~done & ~pending
    b = (3 - jnp.take(text, jnp.clip(pos, 0, n2 - 1))).astype(jnp.int32)
    r4 = d.rank4(jnp.concatenate([begin, end]))
    b2 = jnp.concatenate([b, b])
    rsel = _sel4(b2, r4[:, 0], r4[:, 1], r4[:, 2], r4[:, 3]).astype(jnp.int64)
    fb = _sel4(b, *(jnp.broadcast_to(d.fixed[j], (S,)) for j in range(4)))
    fe = _sel4(b, *(jnp.broadcast_to(d.fixed[j + 1], (S,)) for j in range(4)))
    nb0 = fb + rsel[:S]
    ne = fb + rsel[S:]
    nctx = ctx + 1
    first = jnp.clip(nb0, 0, n - 1)
    sizes_first = d.sizes_at(first).astype(jnp.int32)
    kick = (nb0 < ne) & (sizes_first < nctx)
    nb = nb0 + kick.astype(nb0.dtype)
    ok = nb < ne
    invalid_in = begin >= end
    adv = (ok | (ctx == 0) | invalid_in) & live
    ab = jnp.where(ok, nb, fb)
    ae = jnp.where(ok, ne, fe)
    actx = jnp.where(ok, nctx, 1)
    over = adv & (actx > depth)
    if trunc is not None:
        # constant-threshold widen: trunc tables are built at exactly this
        # depth (prev_lt[i] = largest j <= i with shared < depth == the
        # next_backward_lt(ab+1, depth) the widen would run)
        wb_t, we_t = d.trunc_gather(trunc[0], trunc[1], ab, ae)
        ab = jnp.where(over, jnp.maximum(wb_t, 0), ab)
        ae = jnp.where(over, we_t, ae)
        go_pending_over = jnp.zeros_like(over)
    else:
        # no tables (HBM budget): the lane ADVANCES with the capped,
        # un-widened child range and stalls pending; the widen step widens
        # begin/end in place and patches the already-written output slot
        go_pending_over = over
    actx = jnp.minimum(actx, depth)
    # failed push with context: compute the drop LEVEL now (gathers only),
    # defer the tree widen
    fail = live & ~adv & ~go_pending_over
    shared_b = jnp.take(d.shared, jnp.clip(begin, 0, n - 1)).astype(jnp.int32)
    shared_e = jnp.where(
        end >= n, 0, jnp.take(d.shared, jnp.clip(end, 0, n - 1))
    ).astype(jnp.int32)
    drop = jnp.maximum(shared_b, shared_e)
    drop = jnp.where(nb0 != ne, jnp.maximum(drop, sizes_first - 1), drop)
    upd_b = (begin > 0) & (shared_b >= drop)
    upd_e = (end < n) & (shared_e >= drop)
    # no-progress restart is cheap — handle inline (next step advances it
    # via the invalid-range path)
    noprog = fail & (drop == ctx) & ~upd_b & ~upd_e
    # drop to level 0 resolves INLINE as a restart-advance: the level-0
    # widen is always the full range [0, n) (no shared value is < 0), and
    # pushing b onto [0, n) is exactly the single-base fixed range the
    # restart path (ab = fb, ae = fe, actx = 1) already holds.  No level in
    # (0, ctx] widens the range (drop = max shared at the boundaries), so
    # the longest window ending at the new position really is 1.  This is
    # the dominant "drop" in low-coverage territory — deferring it to the
    # widen step would stall every lane ~widen_every/2 steps per uncovered
    # position.
    drop0 = fail & ~noprog & (drop == 0)
    go_pending_drop = fail & ~noprog & ~drop0
    adv = adv | drop0
    begin2 = jnp.where(adv, ab, jnp.where(noprog, jnp.zeros_like(begin), begin))
    end2 = jnp.where(adv, ae, jnp.where(noprog, jnp.zeros_like(end), end))
    ctx2 = jnp.where(adv, actx, jnp.where(noprog, 0, ctx))
    pending2 = pending | go_pending_over | go_pending_drop
    pend_lvl2 = jnp.where(
        go_pending_over,
        jnp.int32(depth),
        jnp.where(go_pending_drop, drop, pend_lvl),
    )
    # flags bit0: widen begin; bit1: widen end; bit2: over-style query
    # (qb = begin+1 / qe = end-1 instead of the drop's begin / end)
    flags_new = jnp.where(
        go_pending_over,
        jnp.int32(0b111),
        upd_b.astype(jnp.int32) | (upd_e.astype(jnp.int32) << 1),
    )
    pend_flags2 = jnp.where(
        go_pending_over | go_pending_drop, flags_new, pend_flags
    )
    # over lanes already advanced; store their (possibly un-widened when
    # pending) capped state
    owned = adv & (pos >= own_lo)
    oidx = jnp.where(owned, pos + obase, outb.shape[0] - 1)
    outb = outb.at[oidx].set(ab)
    oute = oute.at[oidx].set(ae)
    outc = outc.at[oidx].set(actx)
    pos2 = jnp.where(adv, pos + 1, pos)
    return (pos2, begin2, end2, ctx2, outb, oute, outc, obase, own_lo,
            own_hi, pending2, pend_lvl2, pend_flags2)


def _walk_widen_step(d, carry, depth: int):
    """Serve every pending lane's deferred widen with ONE pair of LtTree
    queries (the only tree work in the loop; see _walk_cheap_step)."""
    (pos, begin, end, ctx, outb, oute, outc, obase, own_lo, own_hi,
     pending, pend_lvl, pend_flags) = carry
    n = d.n_entries
    upd_b = (pend_flags & 1) != 0
    upd_e = (pend_flags & 2) != 0
    is_over = (pend_flags & 4) != 0
    qb = jnp.where(is_over, begin + 1, jnp.where(upd_b, begin, jnp.int64(1)))
    qe = jnp.where(
        is_over, end - 1, jnp.where(upd_e, end, jnp.int64(n - 1))
    )
    wb = d.shared_tree.next_backward_lt(qb, pend_lvl)
    we = d.shared_tree.next_forward_lt(qe, pend_lvl)
    sel_b = pending & upd_b
    sel_e = pending & upd_e
    begin2 = jnp.where(sel_b, jnp.maximum(wb, 0), begin)
    end2 = jnp.where(sel_e, we, end)
    ctx2 = jnp.where(pending, pend_lvl, ctx)
    # an over lane deferred its OUTPUT too (it advanced with the un-widened
    # capped range): patch the already-written slot with the widened range
    owned_over = pending & is_over & (pos - 1 >= own_lo)
    oidx = jnp.where(owned_over, pos - 1 + obase, outb.shape[0] - 1)
    outb = outb.at[oidx].set(begin2)
    oute = oute.at[oidx].set(end2)
    outc = outc.at[oidx].set(jnp.where(owned_over, ctx2, outc[oidx]))
    pending2 = jnp.zeros_like(pending)
    return (pos, begin2, end2, ctx2, outb, oute, outc, obase, own_lo,
            own_hi, pending2, pend_lvl, pend_flags)


WALK_WIDEN_EVERY = int(_os.environ.get("BGT_WALK_WIDEN_EVERY", "8"))


@_partial(jax.jit, static_argnums=(3, 4, 5))
def _walk_device_run(d, text, trunc, depth: int, budget: int, widen_every: int,
                     carry):
    """Run walk supersteps on device until every lane finishes (or the
    safety budget trips — the caller checks the returned undone count).
    One superstep = `widen_every` cheap steps + one widen step."""

    def cond(state):
        step, c = state
        # a lane at its last position may still hold a deferred widen
        # (pending) — one more widen step must run before exit
        return (step < budget) & jnp.any((c[0] < c[9]) | c[10])

    def body(state):
        step, c = state
        for _ in range(widen_every):
            c = _walk_cheap_step(d, text, trunc, c, depth)
        # tree queries only when some lane actually deferred this round
        c = lax.cond(
            jnp.any(c[10]),
            lambda cc: _walk_widen_step(d, cc, depth),
            lambda cc: cc,
            c,
        )
        return step + 1, c

    steps, carry = lax.while_loop(cond, body, (jnp.int32(0), carry))
    undone = jnp.sum(((carry[0] < carry[9]) | carry[10]).astype(jnp.int32))
    return jnp.stack([steps, undone]), carry


WALK_DEV_OWN = int(_os.environ.get("BGT_WALK_DEV_OWN", "128"))
_LANE_QUANTUM = 1 << 14  # lane-count shape bucket


def walk_ranges_device(d, text, reqs, depth: int, trunc=None,
                       lanes: int | None = None, out_layout=None):
    """walk_ranges_multi semantics in ONE device program (see block comment).

    reqs: list of (p0, ctx_lo, P).  trunc: optional (prev_lt, next_lt)
    tables built at threshold == depth (variants/discover._trunc_tables) —
    with them the at-cap widen is two gathers; without, at-cap lanes defer
    to the periodic widen step like drops.  Returns ([(begin, end, size)]
    per span, still on device) plus a device [steps, unconverged] check and
    the raw flat (begin, end, size) output arrays.  out_layout: optional
    (out_total, [out_off per req]) placing each span's outputs at an
    explicit offset of an out_total-long array whose un-walked slots stay
    zero — the k-mer prescreen writes sparse covered spans into full
    segment-shaped outputs this way.  Lane geometry: every lane owns
    ~WALK_DEV_OWN positions after a depth-long halo; lane count is padded
    to a 16K quantum so one compiled shape serves small perturbations."""
    own = max(WALK_DEV_OWN, 1)
    if lanes:
        total_P = sum(P for (_, _, P) in reqs)
        own = max(own, -(-total_P // lanes))
    pos_l, obase_l, lo_l, hi_l = [], [], [], []
    offs = (
        out_layout[1]
        if out_layout is not None
        else _np.cumsum([0] + [int(P) for (_, _, P) in reqs])[:-1]
    )
    out_off = int(out_layout[0]) if out_layout is not None else sum(
        int(P) for (_, _, P) in reqs
    )
    spans = []
    for (p0, ctx_lo, P), off in zip(reqs, offs):
        p0, ctx_lo, P, off = int(p0), int(ctx_lo), int(P), int(off)
        S = -(-P // own)
        own_lo = p0 + _np.arange(S, dtype=_np.int64) * own
        own_hi = _np.minimum(own_lo + own, p0 + P)
        start = _np.minimum(_np.maximum(own_lo - depth, ctx_lo), own_hi)
        pos_l.append(start)
        lo_l.append(own_lo)
        hi_l.append(own_hi)
        obase_l.append(_np.full(S, off - p0, _np.int64))
        spans.append((off, P))
    if not reqs:
        zb = jnp.zeros((out_off,), jnp.int64)
        zc = jnp.zeros((out_off,), jnp.int32)
        return [], jnp.zeros((2,), jnp.int32), (zb, zb, zc)
    pos = _np.concatenate(pos_l)
    S_tot = -(-len(pos) // _LANE_QUANTUM) * _LANE_QUANTUM
    pad = S_tot - len(pos)
    pos = _np.concatenate([pos, _np.zeros(pad, _np.int64)])
    own_lo = _np.concatenate(lo_l + [_np.zeros(pad, _np.int64)])
    own_hi = _np.concatenate(hi_l + [_np.zeros(pad, _np.int64)])  # pad: done
    obase = _np.concatenate(obase_l + [_np.zeros(pad, _np.int64)])
    OUT = out_off + 1  # spill slot for unowned scatters
    carry = (
        jnp.asarray(pos),
        jnp.zeros((S_tot,), jnp.int64),
        jnp.full((S_tot,), d.n_entries, jnp.int64),
        jnp.zeros((S_tot,), jnp.int32),
        jnp.zeros((OUT,), jnp.int64),
        jnp.zeros((OUT,), jnp.int64),
        jnp.zeros((OUT,), jnp.int32),
        jnp.asarray(obase),
        jnp.asarray(own_lo),
        jnp.asarray(own_hi),
        jnp.zeros((S_tot,), bool),
        jnp.zeros((S_tot,), jnp.int32),
        jnp.zeros((S_tot,), jnp.int32),
    )
    we = max(WALK_WIDEN_EVERY, 1)
    # every deferral stalls a lane <= we+1 supersteps; drops per position
    # are bounded by depth in the worst case, but typical genomes see a few
    # per own-span — the budget is a generous safety valve, not a tuning
    budget = (8 * (own + depth) + 512) // we + 8
    check, carry = _walk_device_run(d, text, trunc, depth, budget, we, carry)
    outb, oute, outc = carry[4], carry[5], carry[6]
    # check = device [supersteps, lanes_unconverged]; the caller folds it
    # into an existing fetch and must reject results when unconverged > 0
    # (budget safety valve tripped — silence would mean wrong ranges)
    return [
        (outb[o : o + P], oute[o : o + P], outc[o : o + P]) for o, P in spans
    ], check, (outb[:-1], oute[:-1], outc[:-1])


def use_walk_device(d) -> bool:
    """Single-launch device walk gate — opt-in (BGT_WALK_DEVICE=1).  The
    default frontend is the prescreened hash + probe pipeline; the walk's
    loop is bound by the in-loop gather rank over every position."""
    if getattr(d, "shared_tree", None) is None:
        return False
    return _os.environ.get("BGT_WALK_DEVICE", "") not in ("", "0")


def use_walk_probes(d) -> bool:
    """Walk engine gate — off by default; BGT_WALK_PROBES=1 opts in.  It
    trades rank work for one dispatch per CHAIN_BLOCK steps (~700 for a
    whole genome)."""
    v = _os.environ.get("BGT_WALK_PROBES")
    if v is not None:
        return v not in ("0", "") and d.shared_lt is not None
    return False


@jax.jit
def _packbits_jit(mask):
    return jnp.packbits(mask)


def fetch_mask(mask) -> _np.ndarray:
    """Fetch a device bool mask as packed bits (8x less host traffic)."""
    n = mask.shape[0]
    return _np.unpackbits(_np.asarray(_packbits_jit(mask)))[:n].astype(bool)


# ---------------------------------------------------------------------------
# Rank-free fixed-length window probe (the coverage hash trick generalized
# to any window length m): the m-window ending at position j is
# revcomp(text[j-m+1..j]); entries sharing a first-m-base prefix form a
# contiguous GROUP whose start i satisfies shared[i] < m <= size[i] (a
# group member with shared >= m has LCP >= m with its predecessor, hence
# size >= m — so group starts always qualify), and whose end is the next
# shared < m boundary (discover._trunc_tables' next_lt).  One rolling-hash
# lookup per lane therefore reproduces find_window(m)'s (begin, end, m)
# exactly, with zero rank work — the structure that makes the prescreened
# frontend O(lanes) instead of O(lanes * m) at any seqset scale.
# ---------------------------------------------------------------------------


def entry_seq_matrix(ss) -> _np.ndarray:
    """uint8 [n, max_entry_len] entry sequences, cached on the instance.

    Prefers host-unpacking the packed entry words the builder already
    cached (seqset_build.py _entry_cache) — pure numpy, no device walk;
    falls back to chunked pop-chain reconstruction otherwise."""
    seqs = ss.__dict__.get("_entry_seq_matrix")
    if seqs is not None:
        return seqs
    n = int(ss.n_entries)
    L = int(ss.max_entry_len)
    cached = ss.__dict__.get("_entry_cache")
    if cached is not None:
        from biograph_jax.core import dna as _dna

        e_words = _np.asarray(cached[0])
        seqs = _np.ascontiguousarray(_dna.unpack_words(e_words, L)[:, :L])
    else:
        CH = 1 << 17
        chunks = []
        ids = _np.arange(n, dtype=_np.int64)
        for lo in range(0, n, CH):
            sel = ids[lo : lo + CH]
            pad = CH - len(sel)
            if pad and lo > 0:
                sel = _np.concatenate([sel, _np.full(pad, sel[-1])])
            chunks.append(
                _np.asarray(ss.d.sequences(jnp.asarray(sel), L))[: n - lo]
            )
        seqs = _np.concatenate(chunks)
    ss.__dict__["_entry_seq_matrix"] = seqs
    return seqs


def window_hash_table(ss, m: int):
    """(keys i64 sorted, group_starts i64) for length-m windows; cached on
    the Seqset instance per m.  None when the seqset is empty."""
    cache = ss.__dict__.setdefault("_winhash_tables", {})
    hit = cache.get(m)
    if hit is not None:
        return hit
    from biograph_jax.index.readmap import _hash_pows_np

    shared = _np.asarray(ss.shared)
    sizes = _np.asarray(ss.entry_sizes)
    n = len(sizes)
    if n == 0:
        return None
    reps = _np.nonzero((shared < m) & (sizes >= m))[0].astype(_np.int64)
    if len(reps) == 0:
        return None
    seqs = entry_seq_matrix(ss)
    s = seqs[reps, :m].astype(_np.uint32) + _np.uint32(1)
    pw1, _, pw2, _ = _hash_pows_np(max(m, 2))
    h1 = (s * pw1[None, :m]).sum(axis=1, dtype=_np.uint32)
    h2 = (s * pw2[None, :m]).sum(axis=1, dtype=_np.uint32)
    key = ((h1.astype(_np.uint64) << _np.uint64(32)) | h2).view(_np.int64)
    order = _np.argsort(key)
    out = (jnp.asarray(key[order]), jnp.asarray(reps[order]))
    cache[m] = out
    return out


_TEXT_HASH_CACHE: dict = {}


def _text_prefix_hashes(text):
    """(P1, P2, pw1, pw2) rolling-hash prefix state for a device text
    buffer, cached per buffer identity."""
    key = (id(text), text.shape[0])
    hit = _TEXT_HASH_CACHE.get(key)
    if hit is not None:
        return hit
    from biograph_jax.index.readmap import _hash_pows_dev

    P = text.shape[0]
    pw1, pwinv1, pw2, pwinv2 = _hash_pows_dev(P)
    cc = (jnp.uint32(3) - text.astype(jnp.uint32)) + jnp.uint32(1)
    state = (
        jax.block_until_ready(jnp.cumsum(cc * pwinv1)),
        jax.block_until_ready(jnp.cumsum(cc * pwinv2)),
        pw1,
        pw2,
    )
    if len(_TEXT_HASH_CACHE) > 8:
        _TEXT_HASH_CACHE.clear()
    _TEXT_HASH_CACHE[key] = state
    return state


@_partial(jax.jit, static_argnums=(7,))
def _find_window_hash_jit(keys, reps, next_lt, P1, P2, pw1, pw2, m: int,
                          pos):
    idx_hi = jnp.clip(pos, 0, P1.shape[0] - 1)
    idx_lo = jnp.clip(pos - m, 0, P1.shape[0] - 1)
    lo_ok = pos - m >= 0
    h1 = jnp.take(pw1, idx_hi) * (
        jnp.take(P1, idx_hi)
        - jnp.where(lo_ok, jnp.take(P1, idx_lo), jnp.uint32(0))
    )
    h2 = jnp.take(pw2, idx_hi) * (
        jnp.take(P2, idx_hi)
        - jnp.where(lo_ok, jnp.take(P2, idx_lo), jnp.uint32(0))
    )
    key = lax.bitcast_convert_type(
        (h1.astype(jnp.uint64) << jnp.uint64(32)) | h2.astype(jnp.uint64),
        jnp.int64,
    )
    ix = jnp.clip(jnp.searchsorted(keys, key), 0, keys.shape[0] - 1)
    hit = (jnp.take(keys, ix) == key) & (pos - m + 1 >= 0)
    b = jnp.where(hit, jnp.take(reps, ix), 0)
    # group end = first shared < m boundary AFTER the start (next_lt of the
    # start itself IS the start); past the last entry the group runs to n
    n = next_lt.shape[0]
    e_raw = jnp.where(
        b + 1 < n, jnp.take(next_lt, jnp.clip(b + 1, 0, n - 1)), n
    )
    e = jnp.where(hit, e_raw, b)
    s = jnp.where(hit, jnp.int32(m), jnp.int32(0))
    return b, e, s


def find_window_hash(ss, text, pos, m: int):
    """find_window(d, text, pos, m, depth=m) by hash — (begin, end, size)
    identical to the chain (gated by tests/test_probes.py), O(1)/lane."""
    from biograph_jax.variants.discover import _trunc_tables

    tab = window_hash_table(ss, m)
    if tab is None:
        z = jnp.zeros(pos.shape, jnp.int64)
        return z, z, jnp.zeros(pos.shape, jnp.int32)
    keys, reps = tab
    _, next_lt = _trunc_tables(ss, m)
    P1, P2, pw1, pw2 = _text_prefix_hashes(text)
    return _find_window_hash_jit(keys, reps, next_lt, P1, P2, pw1, pw2, m,
                                 pos)
