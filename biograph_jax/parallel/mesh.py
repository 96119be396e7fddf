"""Device mesh + sharded pipeline steps.

Device-mesh replacement for the reference's multi-process runtime
(modules/mapred/taskdb.h, modules/main/manager.cpp worker fleet): instead of
a task database and forked workers, work is sharded over a
``jax.sharding.Mesh`` and partial results combine with XLA collectives.

Axes:
  * ``data``  — read batches (the reference's parallel_for over read files /
    trace chunks, SURVEY.md §2.7) shard along this axis.
  * the seqset / reference index is replicated per device at small scale and
    shardable by entry range at large scale (halo rank lookups all-gather).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def sharded_pileup_step(mesh: Mesh, ref_kmers, ref_positions, ref_codes, k: int):
    """Build a pjit-ed sharded step: reads (data-sharded) -> pileup counts
    (psum-reduced, replicated).

    This is the flagship multi-chip compute: seed lookup (binary search
    gathers), vectorized verify (mismatch counts), scatter-add pileup, and a
    cross-device psum — reads ride the data axis, the index is replicated.
    """
    ref_len = ref_codes.shape[0]

    def step(kmer_tab, pos_tab, ref, codes, lengths):
        B, L = codes.shape
        km, valid = _kmers(codes, lengths, k)
        q = km[:, 0]
        lo = jnp.searchsorted(kmer_tab, q)
        loc = jnp.clip(lo, 0, kmer_tab.shape[0] - 1)
        hit = jnp.take(kmer_tab, loc) == q
        start = jnp.where(hit, jnp.take(pos_tab, loc), -1)
        okpos = (start >= 0) & (start + lengths <= ref_len)
        s = jnp.clip(start, 0, max(ref_len - L, 0))
        win = ref[
            jnp.clip(
                s[:, None] + jnp.arange(L, dtype=jnp.int64)[None, :],
                0,
                ref_len - 1,
            )
        ]
        vb = jnp.arange(L)[None, :] < lengths[:, None]
        mm = jnp.sum((win != codes) & vb, axis=1)
        placed = okpos & (mm <= 3)
        tgt = jnp.clip(s[:, None] + jnp.arange(L, dtype=jnp.int64)[None, :], 0, ref_len - 1)
        flat = codes.astype(jnp.int64) * ref_len + tgt
        w = (placed[:, None] & vb).astype(jnp.int32)
        counts = (
            jnp.zeros((4 * ref_len,), jnp.int32)
            .at[flat.reshape(-1)]
            .add(w.reshape(-1))
            .reshape(4, ref_len)
        )
        # combine partial pileups across the data axis
        return lax.psum(counts, "data")

    from jax import shard_map

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("data"), P("data")),
        out_specs=P(),
    )
    return jax.jit(fn)


def _kmers(codes, lengths, k):
    B, L = codes.shape
    Wn = L - k + 1
    acc = jnp.zeros((B, Wn), jnp.uint64)
    for i in range(k):
        acc = (acc << jnp.uint64(2)) | codes[:, i : i + Wn].astype(jnp.uint64)
    pos = jnp.arange(Wn)
    return acc, pos[None, :] + k <= lengths[:, None]
