"""Batched nearest-position-with-value-below queries over the shared array.

Counterpart of the reference's less_than_search used by
seqset_range::push_front_drop (modules/bio_base/seqset.cpp:350-427:
next_backward_lt / next_forward_lt over entry_shared).  Two-level layout:
per-position values + per-block minima (block = 256), so a query scans at
most one block vector-wise plus a block-pointer walk — all lanes advance in
lockstep inside jit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp
from jax import lax

BLOCK = 256


@dataclass(frozen=True)
class LtSearch:
    values: jnp.ndarray  # int32 [n]
    block_min: jnp.ndarray  # int32 [nb] (padded with +inf semantics)
    n: int

    def tree_flatten(self):
        return (self.values, self.block_min), self.n

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(values=children[0], block_min=children[1], n=aux)

    @staticmethod
    def build(values: np.ndarray) -> "LtSearch":
        values = np.asarray(values, np.int32)
        n = len(values)
        nb = (n + BLOCK - 1) // BLOCK
        pad = np.full(nb * BLOCK, np.iinfo(np.int32).max, np.int32)
        pad[:n] = values
        bmin = pad.reshape(nb, BLOCK).min(axis=1)
        return LtSearch(
            values=jnp.asarray(pad), block_min=jnp.asarray(bmin), n=n
        )

    def next_backward_lt(self, pos, c):
        """Largest j < pos with values[j] < c; -1 if none.  Batched."""
        pos = jnp.asarray(pos, jnp.int64)
        c = jnp.asarray(c, jnp.int32)
        nb = self.block_min.shape[0]

        # 1) find the candidate block: start at pos's block; if the part of
        # that block before pos has no value < c, walk block_ptr down until
        # block_min < c.
        b0 = pos >> 8
        in_block = self._block_scan_back(b0, pos, c)
        found0 = in_block >= 0
        bptr = jnp.where(found0, b0, b0 - 1)

        def cond(state):
            bptr, done = state
            return jnp.any(~done)

        def body(state):
            bptr, done = state
            ok = (~done) & (bptr >= 0)
            bm = jnp.take(self.block_min, jnp.maximum(bptr, 0))
            hit = ok & (bm < c)
            done = done | hit | (bptr < 0)
            bptr = jnp.where(ok & ~hit, bptr - 1, bptr)
            return bptr, done

        done0 = found0 | (bptr < 0)
        bptr, _ = lax.while_loop(cond, body, (bptr, done0))
        # 2) scan the found block fully (positions < pos constraint only
        # matters in pos's own block, already handled)
        in_later_block = self._block_scan_back(
            jnp.maximum(bptr, 0), jnp.full_like(pos, self.values.shape[0]), c
        )
        res = jnp.where(found0, in_block, jnp.where(bptr >= 0, in_later_block, -1))
        return res

    def next_forward_lt(self, pos, c):
        """Smallest j > pos with values[j] < c; n if none.  Batched."""
        pos = jnp.asarray(pos, jnp.int64)
        c = jnp.asarray(c, jnp.int32)
        nb = self.block_min.shape[0]
        b0 = pos >> 8
        in_block = self._block_scan_fwd(b0, pos, c)
        found0 = in_block >= 0
        bptr = jnp.where(found0, b0, b0 + 1)

        def cond(state):
            bptr, done = state
            return jnp.any(~done)

        def body(state):
            bptr, done = state
            ok = (~done) & (bptr < nb)
            bm = jnp.take(self.block_min, jnp.minimum(bptr, nb - 1))
            hit = ok & (bm < c)
            done = done | hit | (bptr >= nb)
            bptr = jnp.where(ok & ~hit, bptr + 1, bptr)
            return bptr, done

        done0 = found0 | (bptr >= nb)
        bptr, _ = lax.while_loop(cond, body, (bptr, done0))
        in_later = self._block_scan_fwd(jnp.minimum(bptr, nb - 1), -jnp.ones_like(pos), c)
        res = jnp.where(
            found0, in_block, jnp.where(bptr < nb, in_later, self.n)
        )
        res = jnp.where(res < 0, self.n, res)
        return res

    def _block_scan_back(self, blk, pos_limit, c):
        """Largest j in block blk with j < pos_limit and values[j] < c, else -1."""
        base = (blk << 8).astype(jnp.int64)
        idx = base[..., None] + jnp.arange(BLOCK, dtype=jnp.int64)
        vals = jnp.take(self.values, jnp.minimum(idx, self.values.shape[0] - 1))
        ok = (vals < c[..., None]) & (idx < pos_limit[..., None])
        best = jnp.max(jnp.where(ok, idx, -1), axis=-1)
        return best

    def _block_scan_fwd(self, blk, pos_limit, c):
        """Smallest j in block blk with j > pos_limit and values[j] < c, else -1."""
        base = (blk << 8).astype(jnp.int64)
        idx = base[..., None] + jnp.arange(BLOCK, dtype=jnp.int64)
        vals = jnp.take(self.values, jnp.minimum(idx, self.values.shape[0] - 1))
        ok = (vals < c[..., None]) & (idx > pos_limit[..., None]) & (
            idx < self.values.shape[0]
        )
        big = jnp.int64(1 << 62)
        best = jnp.min(jnp.where(ok, idx, big), axis=-1)
        return jnp.where(best == big, -1, best)


import jax.tree_util as _tree_util

_tree_util.register_pytree_node(
    LtSearch, LtSearch.tree_flatten, LtSearch.tree_unflatten
)


@dataclass(frozen=True)
class LtTree:
    """Segment-tree (min) variant of LtSearch with UNROLLED fixed-depth
    queries — no lax.while_loop anywhere, so queries can sit inside an outer
    device-side loop (lax.while_loop / fori_loop / scan) without creating
    nested dynamic while programs (the whole-walk device program needs
    exactly that).

    Layout: tree[1] is the root, children of v are 2v / 2v+1, leaves are
    tree[m + i] for i < m (m = next pow2 >= n, padded with int32 max, which
    never satisfies a `< c` test for the int32 context values used here).
    Total memory 2m * 4 bytes ~ 8-16 bytes per entry.

    Query shape (both directions): the search interval decomposition from a
    pow2-aligned boundary yields candidates on ONE side only, ordered
    nearest-first, so the first qualifying node (subtree min < c) contains
    the answer; a second unrolled descent walks that node to its extreme
    qualifying leaf.  Cost: ~3*log2(m) single-element gathers per lane.
    """

    tree: jnp.ndarray  # int32 [2m]
    n: int
    m: int

    def tree_flatten(self):
        return (self.tree,), (self.n, self.m)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(tree=children[0], n=aux[0], m=aux[1])

    @property
    def levels(self) -> int:
        return max(self.m.bit_length() - 1, 0)  # log2(m)

    @staticmethod
    def build(values) -> "LtTree":
        """Build from host or device values (device inputs stay on device:
        the reduction is pure jnp, so nothing round-trips a slow link)."""
        n = int(values.shape[0])
        m = 1 << max(n - 1, 1).bit_length() if n > 1 else 1
        v = jnp.asarray(values, jnp.int32)
        pad = jnp.full((m - n,), jnp.iinfo(jnp.int32).max, jnp.int32)
        lvl = jnp.concatenate([v, pad]) if m > n else v
        parts = [lvl]
        while parts[-1].shape[0] > 1:
            p = parts[-1]
            parts.append(jnp.minimum(p[0::2], p[1::2]))
        tree = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32)] + parts[::-1]
        )
        return LtTree(tree=tree, n=n, m=m)

    def next_backward_lt(self, pos, c):
        """Largest j < pos with values[j] < c; -1 if none.  Batched."""
        pos = jnp.asarray(pos, jnp.int64)
        c = jnp.asarray(c, jnp.int32)
        m = self.m
        # decompose [0, pos): l = m is pow2-aligned, so only r-side nodes
        # appear, nearest (rightmost range) first
        l = jnp.full_like(pos, m)
        r = m + jnp.clip(pos, 0, m)
        best = jnp.zeros_like(pos)
        found = jnp.zeros(pos.shape, bool)
        for _ in range(self.levels + 1):
            take = (l < r) & ((r & 1) == 1)
            node = r - 1
            q = take & (jnp.take(self.tree, jnp.maximum(node, 0)) < c) & ~found
            best = jnp.where(q, node, best)
            found = found | q
            r = jnp.where(take, r - 1, r) >> 1
            l = l >> 1
        # descend to the RIGHTMOST qualifying leaf
        node = best
        for _ in range(self.levels):
            inner = found & (node < m) & (node > 0)
            right = 2 * node + 1
            go_r = inner & (
                jnp.take(self.tree, jnp.minimum(right, 2 * m - 1)) < c
            )
            node = jnp.where(inner, jnp.where(go_r, right, 2 * node), node)
        return jnp.where(found, node - m, jnp.int64(-1))

    def next_forward_lt(self, pos, c):
        """Smallest j > pos with values[j] < c; n if none.  Batched."""
        pos = jnp.asarray(pos, jnp.int64)
        c = jnp.asarray(c, jnp.int32)
        m = self.m
        # decompose [pos+1, m): r = 2m is pow2-aligned, so only l-side nodes
        # appear, nearest (leftmost range) first; the +inf padding makes
        # [n, m) unmatchable
        l = m + jnp.clip(pos + 1, 0, m)
        r = jnp.full_like(pos, 2 * m)
        best = jnp.zeros_like(pos)
        found = jnp.zeros(pos.shape, bool)
        for _ in range(self.levels + 1):
            take = (l < r) & ((l & 1) == 1)
            q = take & (jnp.take(self.tree, jnp.minimum(l, 2 * m - 1)) < c) & ~found
            best = jnp.where(q, l, best)
            found = found | q
            l = jnp.where(take, l + 1, l) >> 1
            r = r >> 1
        # descend to the LEFTMOST qualifying leaf
        node = best
        for _ in range(self.levels):
            inner = found & (node < m) & (node > 0)
            left = 2 * node
            go_l = inner & (
                jnp.take(self.tree, jnp.minimum(left, 2 * m - 1)) < c
            )
            node = jnp.where(inner, jnp.where(go_l, left, left + 1), node)
        return jnp.where(found, node - m, jnp.int64(self.n))


_tree_util.register_pytree_node(
    LtTree, LtTree.tree_flatten, LtTree.tree_unflatten
)
