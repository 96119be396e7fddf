"""Batched affine-gap global alignment (the aligner step, on device).

Counterpart of the reference's assembly re-aligner
(modules/variants/align.h:8: bidir realignment of assemblies to the
reference before splitting into primitive variants).  The reference aligns
one assembly at a time with scalar DP; here N blocks align simultaneously:
the three-state affine DP sweeps rows with a lax.scan while every lane and
every column updates in parallel.

Score model (minimization): mismatch=1, gap open=2.5, gap extend=0.5 —
matching variants/discover._align_decompose so decompositions agree.

Returns packed traceback choices so the host can emit SNP/ins/del pieces
without re-running the DP.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

MIS = 1.0
GAP_OPEN = 2.5
GAP_EXT = 0.5
BIG = 1e9


@partial(jax.jit, static_argnums=(4, 5))
def _align_scores_jit(ref, alt, ref_len, alt_len, Lr: int, La: int):
    """DP over N lanes: returns packed traceback [N, Lr+1, La+1] uint8.

    Traceback byte: bits 0-1 = M came-from state, bit 2 = Ix from extend,
    bit 3 = Iy from extend.
    """
    N = ref.shape[0]

    # state rows: M/Ix/Iy over columns 0..La
    cols = jnp.arange(La + 1)
    m0 = jnp.where(cols == 0, 0.0, BIG)[None, :].repeat(N, 0)
    ix0 = jnp.full((N, La + 1), BIG)
    iy0 = jnp.where(
        cols > 0, GAP_OPEN + GAP_EXT * jnp.maximum(cols - 1, 0), BIG
    )[None, :].repeat(N, 0)

    def row_step(carry, i):
        m_prev, ix_prev, iy_prev = carry
        # Ix (deletion: consume ref row i) — from previous row
        ix_open = m_prev + GAP_OPEN
        ix_ext = ix_prev + GAP_EXT
        ix = jnp.minimum(ix_open, ix_ext)
        ix_from_ext = (ix_ext < ix_open).astype(jnp.uint8)
        # M needs diagonal: prev row shifted right
        ref_b = ref[:, i - 1][:, None]
        sub = jnp.where(ref_b == alt, 0.0, MIS)
        diag_m = jnp.concatenate([jnp.full((N, 1), BIG), m_prev[:, :-1]], axis=1)
        diag_ix = jnp.concatenate([jnp.full((N, 1), BIG), ix_prev[:, :-1]], axis=1)
        diag_iy = jnp.concatenate([jnp.full((N, 1), BIG), iy_prev[:, :-1]], axis=1)
        stacked = jnp.stack([diag_m, diag_ix, diag_iy], axis=0)
        m_src = jnp.argmin(stacked, axis=0).astype(jnp.uint8)
        m = jnp.min(stacked, axis=0) + sub
        m = jnp.where(cols[None, :] == 0, BIG, m)
        # Iy (insertion: consume alt col) — affine within-row recurrence
        # iy[j] = min(m[j-1]+open, iy[j-1]+ext).  Unrolled: iy[j] =
        # min_{k<j}(m[k] + open + ext*(j-k-1)) = ext*j + cummin(c)[j] with
        # c[j] = m[j-1] + open - ext*j — a parallel prefix min instead of a
        # La-step scan (which made the DP Lr*La-sequential; all score
        # constants are exact binary fractions, so the refactoring is
        # bit-identical).  from_ext[j] <=> the best opener is before j-1,
        # i.e. cummin excluding c[j] beats c[j].
        m_left = jnp.concatenate([jnp.full((N, 1), BIG), m[:, :-1]], axis=1)
        jcol = cols[None, :].astype(m.dtype)
        c = m_left + GAP_OPEN - GAP_EXT * jcol
        cm = lax.cummin(c, axis=1)
        iy = GAP_EXT * jcol + cm
        iy = jnp.where(cols[None, :] == 0, BIG, iy)
        cm_prev = jnp.concatenate([jnp.full((N, 1), BIG), cm[:, :-1]], axis=1)
        iy_from_ext = (cm_prev < c).astype(jnp.uint8)
        tb = (
            m_src
            | (ix_from_ext << jnp.uint8(2))
            | (iy_from_ext << jnp.uint8(3))
        )
        return (m, ix, iy), (tb, m, ix, iy)

    (mN, ixN, iyN), (tb_rows, m_rows, ix_rows, iy_rows) = lax.scan(
        row_step, (m0, ix0, iy0), jnp.arange(1, Lr + 1)
    )
    # assemble tb [N, Lr+1, La+1]; row 0 has trivial traceback
    tb0 = jnp.zeros((1, N, La + 1), jnp.uint8) | jnp.uint8(1 << 3)
    tb = jnp.concatenate([tb0, tb_rows], axis=0)
    tb = jnp.moveaxis(tb, 0, 1)
    # final state at (ref_len, alt_len) per lane: gather final scores
    def final_at(rows, init_row):
        all_rows = jnp.concatenate([init_row[None], rows], axis=0)  # [Lr+1, N, La+1]
        r = jnp.take_along_axis(
            all_rows, ref_len[None, :, None].astype(jnp.int64), axis=0
        )[0]
        return jnp.take_along_axis(r, alt_len[:, None].astype(jnp.int64), axis=1)[:, 0]

    fm = final_at(m_rows, m0)
    fx = final_at(ix_rows, ix0)
    fy = final_at(iy_rows, iy0)
    final_state = jnp.argmin(jnp.stack([fm, fx, fy], axis=1), axis=1).astype(jnp.uint8)
    return tb, final_state


def align_blocks_batch(
    ref_blocks: List[np.ndarray], alt_blocks: List[np.ndarray]
):
    """Align N (ref, alt) code blocks; returns per-pair op lists.

    ops: list of ('M'|'D'|'I', ref_idx, alt_idx) in order — same contract as
    the scalar NW in variants/discover.
    """
    N = len(ref_blocks)
    if N == 0:
        return []
    # bucket by pow2 block size: one long block must not make every short
    # block pay its padded DP (cost is Lr rows x La cols per lane)
    sizes = [max(max(len(r), len(a)), 1) for r, a in zip(ref_blocks, alt_blocks)]
    if N > 1 and max(sizes) > 2 * min(sizes):
        buckets: dict = {}
        for i, sz in enumerate(sizes):
            b = 8
            while b < sz:
                b *= 2
            buckets.setdefault(b, []).append(i)
        if len(buckets) > 1:  # single-bucket sets fall through (no recursion)
            out = [None] * N
            for ids in buckets.values():
                sub = align_blocks_batch(
                    [ref_blocks[i] for i in ids], [alt_blocks[i] for i in ids]
                )
                for i, ops in zip(ids, sub):
                    out[i] = ops
            return out
    def _pow2(n):
        p = 8
        while p < n:
            p *= 2
        return p

    # pow2 shape buckets so the jit cache is reused across calls
    Lr = _pow2(max(max(len(r) for r in ref_blocks), 1))
    La = _pow2(max(max(len(a) for a in alt_blocks), 1))
    ref = np.zeros((N, Lr), np.uint8)
    alt = np.zeros((N, La), np.uint8)
    rl = np.zeros(N, np.int32)
    al = np.zeros(N, np.int32)
    for i, (r, a) in enumerate(zip(ref_blocks, alt_blocks)):
        ref[i, : len(r)] = r
        alt[i, : len(a)] = a
        rl[i] = len(r)
        al[i] = len(a)
    # note: alt is compared against ref row-wise; shape [N, 1] vs [N, La+1]
    alt_cmp = np.zeros((N, La + 1), np.uint8)
    alt_cmp[:, 1:] = alt
    tb, final_state = _align_scores_jit(
        jnp.asarray(ref), jnp.asarray(alt_cmp), jnp.asarray(rl), jnp.asarray(al), Lr, La
    )
    tb = np.asarray(tb)
    final_state = np.asarray(final_state)
    out = []
    for n in range(N):
        i, j = int(rl[n]), int(al[n])
        state = int(final_state[n])
        ops = []
        while i > 0 or j > 0:
            byte = tb[n, i, j]
            if state == 0:
                i -= 1
                j -= 1
                ops.append(("M", i, j))
                state = int(byte & 3)
            elif state == 1:
                i -= 1
                ops.append(("D", i, j))
                state = 1 if (byte >> 2) & 1 else 0
            else:
                j -= 1
                ops.append(("I", i, j))
                state = 2 if (byte >> 3) & 1 else 0
        ops.reverse()
        out.append(ops)
    return out
