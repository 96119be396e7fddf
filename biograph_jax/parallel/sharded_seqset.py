"""Entry-sharded seqset: the model-parallel axis of the rebuild.

At human scale the seqset's rank structures (4 bitvectors + select tables
over billions of entries) exceed one chip's HBM.  This module shards them by
entry range across a mesh axis and serves *global* rank queries with one
psum: every shard computes its local contribution (full local rank for
positions past its range, partial for positions inside, zero before) and the
collective sums them — the reference's single-node mmap'd bitcount
(modules/io/bitcount.h:13) becomes a distributed structure with ICI-resident
queries.  This is the "sharded seqset index" called for in SURVEY.md §2.7/§7.

Layout per shard s over axis 'model' (S shards, entry space padded to S
equal ranges of R words each):
  words_s : uint32 [4, R]      — shard's slice of prev[b] bit words
  cum_s   : int64  [4, R]      — exclusive prefix popcounts *within shard*
  base_s  : int64  [4]         — total ones in shards before s
  lo_s    : int64              — first bit position owned by the shard
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


@dataclass
class ShardedRankArrays:
    """Host-side container of the sharded seqset structure (stacked [S, ...]).

    Beyond the rank bitvectors, the per-entry arrays the query engine needs
    (shared-prefix lengths, entry sizes, pop/select table) shard by the same
    entry ranges so push_front_drop / truncate run fully collective."""

    words: np.ndarray  # uint32 [S, 4, R]
    cum: np.ndarray  # int64 [S, 4, R] — exclusive prefix popcounts per shard
    lo: np.ndarray  # int64 [S] — first bit position owned by each shard
    fixed: np.ndarray  # int64 [5] (replicated)
    n_entries: int
    shared: np.ndarray = None  # int32 [S, Re] (pad -1 past n_entries)
    sizes: np.ndarray = None  # int32 [S, Re] (pad 0)
    pop_sel: np.ndarray = None  # int64 [S, Re] (pad 0)
    elo: np.ndarray = None  # int64 [S] first entry id per shard

    @staticmethod
    def build(seqset, n_shards: int) -> "ShardedRankArrays":
        words = np.asarray(seqset.prev_words)  # [4, nw]
        nw = words.shape[1]
        R = -(-nw // n_shards)
        wpad = np.zeros((4, R * n_shards), np.uint32)
        wpad[:, :nw] = words
        from biograph_jax.core.bitvector import popcount_np

        pc = popcount_np(wpad)  # [4, R*S]
        shard_words = wpad.reshape(4, n_shards, R).transpose(1, 0, 2)
        pcs = pc.reshape(4, n_shards, R).transpose(1, 0, 2)
        cum = np.zeros((n_shards, 4, R), np.int64)
        cum[:, :, 1:] = np.cumsum(pcs[:, :, :-1], axis=2)
        lo = (np.arange(n_shards, dtype=np.int64) * R) * 32

        n = seqset.n_entries
        Re = -(-n // n_shards)

        def shard_arr(a, pad, dtype):
            out = np.full(Re * n_shards, pad, dtype)
            out[:n] = np.asarray(a, dtype)
            return out.reshape(n_shards, Re)

        return ShardedRankArrays(
            words=shard_words.astype(np.uint32),
            cum=cum,
            lo=lo,
            fixed=np.asarray(seqset.fixed, np.int64),
            n_entries=n,
            shared=shard_arr(seqset.shared, -1, np.int32),
            sizes=shard_arr(seqset.entry_sizes, 0, np.int32),
            pop_sel=shard_arr(seqset.pop_sel, 0, np.int64),
            elo=np.arange(n_shards, dtype=np.int64) * Re,
        )

    def device_args(self):
        return (
            jnp.asarray(self.words),
            jnp.asarray(self.cum),
            jnp.asarray(self.lo),
            jnp.asarray(self.shared),
            jnp.asarray(self.sizes),
            jnp.asarray(self.pop_sel),
            jnp.asarray(self.elo),
        )

    def device_args_global(self, mesh: Mesh, axis: str = "model"):
        """Global jax.Arrays sharded over `axis` — the multi-host data path.

        Under jax.distributed each process materializes ONLY its addressable
        shards (make_array_from_callback slices the host copy per device), so
        a seqset larger than one host's HBM loads shard-by-shard.  The
        reference's analog is each worker mmap'ing its slice of the taskdb
        manifest; here the mesh assignment IS the manifest.  Single-process
        meshes get the same layout (useful for tests)."""
        from jax.sharding import NamedSharding

        sh = NamedSharding(mesh, P(axis))

        def mk(a):
            a = np.asarray(a)
            return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

        return (
            mk(self.words),
            mk(self.cum),
            mk(self.lo),
            mk(self.shared),
            mk(self.sizes),
            mk(self.pop_sel),
            mk(self.elo),
        )


def make_sharded_rank(mesh: Mesh, axis: str = "model"):
    """Build the collective rank function: (shard arrays..., b, pos) -> rank.

    Query arrays are replicated; each shard contributes via psum.
    """

    def rank_local(words, cum, lo, b, pos):
        # local shapes under shard_map: words [1, 4, R], cum [1, 4, R], lo [1]
        words = words[0]
        cum = cum[0]
        R = words.shape[1]
        rel = pos - lo[0]  # bit offset into this shard
        w = (rel >> 5).astype(jnp.int64)
        inside = (w >= 0) & (w < R)
        after = w >= R
        wc = jnp.clip(w, 0, R - 1)
        bidx = b.astype(jnp.int64)
        flat = bidx * R + wc
        word = jnp.take(words.reshape(-1), flat)
        rem = (rel & 31).astype(jnp.uint32)
        mask = jnp.where(
            rem > 0, (jnp.uint32(1) << rem) - jnp.uint32(1), jnp.uint32(0)
        )
        part = lax.population_count(word & mask).astype(jnp.int64)
        local_cum = jnp.take(cum.reshape(-1), flat)
        shard_total = jnp.take(cum[:, -1], bidx) + jnp.take(
            lax.population_count(words[:, -1]).astype(jnp.int64), bidx
        )
        contrib = jnp.where(
            inside,
            local_cum + part,
            jnp.where(after, shard_total, 0),
        )
        # shards before pos contribute their total, the owner its local
        # rank, later shards zero: the psum is the global rank.
        return lax.psum(contrib, axis)

    fn = shard_map(
        rank_local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(),
    )
    return jax.jit(fn)


def sharded_entry_push_front(rank_fn, arrays: ShardedRankArrays, entries, b):
    """Global entry_push_front via the collective rank."""
    fixed = jnp.asarray(arrays.fixed)
    r = rank_fn(
        jnp.asarray(arrays.words),
        jnp.asarray(arrays.cum),
        jnp.asarray(arrays.lo),
        jnp.asarray(b),
        jnp.asarray(entries),
    )
    return jnp.take(fixed, jnp.asarray(b).astype(jnp.int64)) + r


# ---------------------------------------------------------------------------
# Collective query engine: the full seqset op set (push_front /
# push_front_drop / truncate) over the entry-sharded structure, and the
# wavefront step built on it.  Each function is a faithful mirror of the
# single-device logic in index/seqset.py (same update rules, same
# tie-breaking) with gathers/searches replaced by one-owner psum gathers and
# pmax/pmin boundary searches — outputs are bit-identical to the local
# engine, which dryrun_multichip asserts.
# ---------------------------------------------------------------------------


def _local_env(words, cum, lo, shared, sizes, pop_sel, elo, fixed, n, axis):
    """Per-shard helper closures under shard_map (leading shard dim squeezed)."""
    words = words[0]
    cum = cum[0]
    lo = lo[0]
    shared = shared[0]
    sizes = sizes[0]
    pop_sel = pop_sel[0]
    elo = elo[0]
    R = words.shape[1]
    Re = shared.shape[0]
    gidx = elo + jnp.arange(Re, dtype=jnp.int64)

    def rank(b, pos):
        rel = pos - lo
        w = (rel >> 5).astype(jnp.int64)
        inside = (w >= 0) & (w < R)
        after = w >= R
        wc = jnp.clip(w, 0, R - 1)
        bidx = b.astype(jnp.int64)
        flat = bidx * R + wc
        word = jnp.take(words.reshape(-1), flat)
        rem = (rel & 31).astype(jnp.uint32)
        mask = jnp.where(
            rem > 0, (jnp.uint32(1) << rem) - jnp.uint32(1), jnp.uint32(0)
        )
        part = lax.population_count(word & mask).astype(jnp.int64)
        local_cum = jnp.take(cum.reshape(-1), flat)
        shard_total = jnp.take(cum[:, -1], bidx) + jnp.take(
            lax.population_count(words[:, -1]).astype(jnp.int64), bidx
        )
        contrib = jnp.where(inside, local_cum + part, jnp.where(after, shard_total, 0))
        return lax.psum(contrib, axis)

    def gather(arr, idx):
        """Entry-array gather: exactly one shard owns each (clipped) index."""
        rel = idx - elo
        own = (rel >= 0) & (rel < Re)
        v = jnp.take(arr, jnp.clip(rel, 0, Re - 1)).astype(jnp.int64)
        return lax.psum(jnp.where(own, v, 0), axis)

    def lt_back(pos, c):
        """Largest j < pos with shared[j] < c; -1 if none (collective)."""
        ok = (shared[None, :] < c[:, None]) & (gidx[None, :] < pos[:, None])
        best = jnp.max(jnp.where(ok, gidx[None, :], -1), axis=1)
        return lax.pmax(best, axis)

    def lt_fwd(pos, c):
        """Smallest j > pos with shared[j] < c; n if none (pad rows carry
        shared == -1, so the first pad position IS n)."""
        big = jnp.int64(1 << 62)
        ok = (shared[None, :] < c[:, None]) & (gidx[None, :] > pos[:, None])
        best = jnp.min(jnp.where(ok, gidx[None, :], big), axis=1)
        return jnp.minimum(lax.pmin(best, axis), n)

    def push_front(begin, end, size, b):
        """Mirror of _SeqsetDevice.push_front (index/seqset.py)."""
        fixed_b = jnp.take(fixed, b.astype(jnp.int64))
        nb = fixed_b + rank(b, begin)
        ne = fixed_b + rank(b, end)
        new_size = size + 1
        sizes_nb = gather(sizes, jnp.minimum(nb, n - 1)).astype(jnp.int32)
        kick = (nb < ne) & (sizes_nb < new_size)
        nb = nb + kick.astype(nb.dtype)
        was_valid = begin < end
        nb = jnp.where(was_valid, nb, begin)
        ne = jnp.where(was_valid, ne, begin)
        return nb, ne, jnp.where(was_valid, new_size, size)

    def widen(begin, end, size):
        """Mirror of _SeqsetDevice._widen."""
        nb = jnp.maximum(lt_back(begin + 1, size), 0)
        ne = lt_fwd(end - 1, size)
        return nb, ne

    def truncate(begin, end, size, new_size):
        """Mirror of _SeqsetDevice.truncate_ranges."""
        new_size = jnp.broadcast_to(jnp.asarray(new_size, jnp.int32), size.shape)
        need = size > new_size
        tgt = jnp.where(need, new_size, size)
        nb, ne = widen(begin, end, jnp.maximum(tgt, 1))
        return (
            jnp.where(need, nb, begin),
            jnp.where(need, ne, end),
            tgt,
        )

    def push_front_drop(begin, end, size, b, min_ctx=0):
        """Mirror of _SeqsetDevice.push_front_drop (same loop + dead rules)."""
        fixed_b = jnp.take(fixed, b.astype(jnp.int64))
        o_begin = begin
        o_end = end
        o_ctx = size.astype(jnp.int32)
        sub_b = rank(b, o_begin)
        sub_e = rank(b, o_end)
        dead = (o_ctx < jnp.asarray(min_ctx, jnp.int32)) | (o_begin >= o_end)

        def need_drop(sub_b, sub_e, o_ctx):
            first = jnp.clip(fixed_b + sub_b, 0, n - 1)
            lone_short = (sub_b + 1 == sub_e) & (
                gather(sizes, first).astype(jnp.int32) < o_ctx + 1
            )
            return (sub_b == sub_e) | lone_short

        def cond(state):
            return jnp.any(~state[6])

        def body(state):
            o_begin, o_end, o_ctx, sub_b, sub_e, dead, done = state
            active = ~done
            first = jnp.clip(fixed_b + sub_b, 0, n - 1)
            sh_begin = gather(shared, jnp.clip(o_begin, 0, n - 1)).astype(jnp.int32)
            sh_end = gather(shared, jnp.clip(o_end, 0, n - 1)).astype(jnp.int32)
            drop = jnp.maximum(
                sh_begin, jnp.where(o_end >= n, 0, sh_end)
            ).astype(jnp.int32)
            drop = jnp.where(
                sub_b != sub_e,
                jnp.maximum(drop, gather(sizes, first).astype(jnp.int32) - 1),
                drop,
            )
            below_min = drop < jnp.asarray(min_ctx, jnp.int32)
            upd_b = active & (o_begin > 0) & (sh_begin >= drop)
            upd_e = active & (o_end < n) & (sh_end >= drop)
            nb = lt_back(jnp.where(upd_b, o_begin, 1), drop)
            ne = lt_fwd(jnp.where(upd_e, o_end, n - 1), drop)
            nb = jnp.maximum(nb, 0)
            progress = upd_b | upd_e | (drop != o_ctx)
            newly_dead = active & (below_min | ~progress)
            o_begin2 = jnp.where(upd_b, nb, o_begin)
            o_end2 = jnp.where(upd_e, ne, o_end)
            sub_b2 = jnp.where(upd_b, rank(b, o_begin2), sub_b)
            sub_e2 = jnp.where(upd_e, rank(b, o_end2), sub_e)
            o_ctx2 = jnp.where(active, drop, o_ctx)
            still = need_drop(sub_b2, sub_e2, o_ctx2)
            dead2 = dead | newly_dead
            done2 = done | newly_dead | (active & ~still)
            keep = active & ~newly_dead
            return (
                jnp.where(keep, o_begin2, o_begin),
                jnp.where(keep, o_end2, o_end),
                jnp.where(keep, o_ctx2, o_ctx),
                jnp.where(keep, sub_b2, sub_b),
                jnp.where(keep, sub_e2, sub_e),
                dead2,
                done2,
            )

        done0 = dead | ~need_drop(sub_b, sub_e, o_ctx)
        o_begin, o_end, o_ctx, sub_b, sub_e, dead, _ = lax.while_loop(
            cond, body, (o_begin, o_end, o_ctx, sub_b, sub_e, dead, done0)
        )
        new_begin = fixed_b + sub_b
        new_end = fixed_b + sub_e
        sizes_nb = gather(sizes, jnp.clip(new_begin, 0, n - 1)).astype(jnp.int32)
        kick = (new_begin < new_end) & (sizes_nb < o_ctx + 1)
        new_begin = new_begin + kick.astype(new_begin.dtype)
        new_begin = jnp.where(dead, 0, new_begin)
        new_end = jnp.where(dead, 0, new_end)
        return new_begin, new_end, jnp.where(dead, 0, o_ctx + 1)

    class Env:
        pass

    env = Env()
    env.rank = rank
    env.gather = gather
    env.sizes = sizes
    env.push_front = push_front
    env.push_front_drop = push_front_drop
    env.truncate = truncate
    env.widen = widen
    return env


def make_sharded_seqset_ops(mesh: Mesh, n_entries: int, axis: str = "model"):
    """Jitted collective versions of the core seqset ops.

    Each returned fn takes (*arrays.device_args(), fixed, <query args>) with
    the structure sharded over `axis` and lane state replicated."""
    spec_s = (P(axis),) * 3 + (P(axis),) * 4  # words, cum, lo, shared, sizes, pop_sel, elo
    n = n_entries

    def wrap(name, body, n_q):
        def f(words, cum, lo, shared, sizes, pop_sel, elo, fixed, *q):
            env = _local_env(
                words, cum, lo, shared, sizes, pop_sel, elo, fixed, n, axis
            )
            return body(env, *q)

        return jax.jit(
            shard_map(
                f,
                mesh=mesh,
                in_specs=spec_s + (P(),) + (P(),) * n_q,
                out_specs=P(),
            )
        )

    return dict(
        push_front=wrap("push_front", lambda e, b_, e_, s_, bb: e.push_front(b_, e_, s_, bb), 4),
        push_front_drop=wrap(
            "push_front_drop", lambda e, b_, e_, s_, bb: e.push_front_drop(b_, e_, s_, bb), 4
        ),
        truncate=wrap(
            "truncate", lambda e, b_, e_, s_, ns: e.truncate(b_, e_, s_, ns), 4
        ),
    )
