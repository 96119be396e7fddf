"""The seqset: a BWT-like suffix-ordered read store, queried in batch.

Device-batched counterpart of the reference seqset (modules/bio_base/seqset.h:20)
and seqset_range (seqset.h:207).  Semantics (verified against the reference
implementation, seqset.cpp):

  * The *closure set* C = every suffix of every read and reverse complement.
  * *Entries* = the prefix-maximal elements of C, sorted in prefix-first
    lexicographic order.  (Invariant from make_mergemap.h:28-31: no entry is a
    prefix of another.)
  * ``prev[b][i] = 1`` iff i is the first entry whose prefix P satisfies
    "b+P is an entry".  The number of set bits in prev[b] equals the number of
    entries starting with b, and rank/select between them is the LF mapping:
      - push_front(range [s,e) of seq S, base b) =
          fixed[b] + [rank_b(s), rank_b(e))   (seqset.cpp:319-338)
      - pop_front(entry e starting with b) = select_b(e - fixed[b])
        (seqset.cpp:710-719); we store the select table directly
        (``pop_sel``), which doubles as the reference's pop_front cache.
  * ``entry_sizes[i]`` — length of entry i; ``shared[i]`` — LCP with entry
    i-1.  A range [s,e) with seq length L covers entries sharing the first L
    bases: shared[j] >= L for j in (s,e).

Everything queryable is a flat device array; all query methods are batched —
thousands of search lanes advance per call via vectorized rank gathers.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from biograph_jax.core import dna
from biograph_jax.core.bitvector import RankBits, rank_query
from biograph_jax.core import container


class SeqsetRanges(NamedTuple):
    """A batch of seqset ranges (the vector analog of seqset_range)."""

    begin: jnp.ndarray  # int64 [B]
    end: jnp.ndarray  # int64 [B]
    size: jnp.ndarray  # int32 [B] — length of the represented sequence

    @property
    def valid(self):
        return self.begin < self.end


@dataclass
class Seqset:
    n_entries: int
    max_entry_len: int
    fixed: np.ndarray  # int64 [5]
    prev_words: np.ndarray  # uint32 [4, nw] — bit i of prev[b]
    prev_cum: np.ndarray  # int64 [4, nw] — exclusive prefix popcounts
    entry_sizes: np.ndarray  # int32 [n]
    shared: np.ndarray  # int32 [n]
    pop_sel: np.ndarray  # int64 [n] — select table == pop_front cache
    uuid: str = ""

    # ---------------- device views ----------------

    @cached_property
    def d(self):
        """Device-resident arrays bundle (jnp)."""
        from biograph_jax.ops.ltsearch import LtSearch, LtTree

        # jnp.asarray is a no-op for already-device-resident fields (the
        # device builder keeps them there); host-loaded seqsets upload once
        shared_dev = jnp.asarray(self.shared)
        return _SeqsetDevice(
            fixed=jnp.asarray(self.fixed),
            prev_words=jnp.asarray(self.prev_words),
            prev_cum=jnp.asarray(self.prev_cum),
            entry_sizes=jnp.asarray(self.entry_sizes),
            shared=shared_dev,
            pop_sel=jnp.asarray(self.pop_sel),
            n_entries=self.n_entries,
            # two query structures over `shared` with one contract
            # (ops/ltsearch.py): LtSearch's block walk is a lax.while_loop —
            # fine at top trace level (wavefront, push_front_drop), but
            # nested-dynamic-while if placed inside a device loop, and its
            # unrolled form blows up compile time.  The while-free LtTree
            # serves the single-launch device walk (probes.walk_ranges_device)
            # where its fixed-depth unrolled queries sit inside
            # lax.while_loop; built from the device-resident array (no extra
            # host round trip).
            shared_lt=LtSearch.build(np.asarray(self.shared)),
            shared_tree=LtTree.build(shared_dev),
        )

    # ---------------- convenience (host-side, small queries) -------------

    def size(self) -> int:
        return self.n_entries

    @property
    def read_len(self) -> int:
        return self.max_entry_len

    def ctx_begin(self) -> SeqsetRanges:
        return SeqsetRanges(
            begin=jnp.zeros((1,), jnp.int64),
            end=jnp.full((1,), self.n_entries, jnp.int64),
            size=jnp.zeros((1,), jnp.int32),
        )

    def find_str(self, seq: str):
        """Find a single sequence; returns (begin, end, size) ints."""
        codes = dna.seq_to_codes(seq)[None, :]
        r = self.d.find(jnp.asarray(codes), jnp.asarray([len(seq)], jnp.int32))
        return int(r.begin[0]), int(r.end[0]), int(r.size[0])

    def entry_sequence(self, entry: int, length: int | None = None) -> str:
        n = int(self.entry_sizes[entry]) if length is None else length
        codes = self.d.sequences(jnp.asarray([entry], jnp.int64), n)
        return dna.codes_to_seq(np.asarray(codes[0, :n]))

    # ---------------- persistence ----------------

    def save(self, path: str):
        with container.ArtifactWriter(path, "seqset") as w:
            w.set_scalar("n_entries", self.n_entries)
            w.set_scalar("max_entry_len", self.max_entry_len)
            w.add_array("fixed", self.fixed)
            w.add_array("prev_words", self.prev_words)
            w.add_array("prev_cum", self.prev_cum)
            w.add_array("entry_sizes", np.asarray(self.entry_sizes, np.int32))
            w.add_array("shared", np.asarray(self.shared, np.int32))
            w.add_array("pop_sel", np.asarray(self.pop_sel, np.int64))
            self.uuid = w.meta["uuid"]

    @staticmethod
    def load(path: str) -> "Seqset":
        r = container.ArtifactReader(path, "seqset")
        return Seqset(
            n_entries=r.scalar("n_entries"),
            max_entry_len=r.scalar("max_entry_len"),
            fixed=r.array("fixed"),
            prev_words=r.array("prev_words"),
            prev_cum=r.array("prev_cum"),
            entry_sizes=r.array("entry_sizes"),
            shared=r.array("shared"),
            pop_sel=r.array("pop_sel"),
            uuid=r.uuid,
        )


@dataclass(frozen=True)
class _SeqsetDevice:
    """Jit-friendly query engine over device-resident seqset arrays.

    Registered as a pytree so whole pipelines (reference walks, tracers) can
    be jitted with the seqset as an argument."""

    fixed: jnp.ndarray
    prev_words: jnp.ndarray
    prev_cum: jnp.ndarray
    entry_sizes: jnp.ndarray
    shared: jnp.ndarray
    pop_sel: jnp.ndarray
    n_entries: int
    shared_lt: object = None  # LtSearch over shared (push_front_drop)
    shared_tree: object = None  # while-free LtTree (device-loop walk)

    def tree_flatten(self):
        children = (
            self.fixed,
            self.prev_words,
            self.prev_cum,
            self.entry_sizes,
            self.shared,
            self.pop_sel,
            self.shared_lt,
            self.shared_tree,
        )
        return children, self.n_entries

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(
            fixed=children[0],
            prev_words=children[1],
            prev_cum=children[2],
            entry_sizes=children[3],
            shared=children[4],
            pop_sel=children[5],
            n_entries=aux,
            shared_lt=children[6],
            shared_tree=children[7],
        )

    # -- primitive ops (all batched) --

    def rank(self, b, pos):
        """rank of prev[base b] at positions pos; b and pos same shape."""
        b = jnp.asarray(b)
        pos = jnp.asarray(pos)
        nw = self.prev_words.shape[1]
        w = (pos >> 5).astype(jnp.int64)
        rem = (pos & 31).astype(jnp.uint32)
        # pos == 32*nw (an end position when n_entries % 32 == 0) must count
        # the last word fully, not index past the structure
        over = w >= nw
        wc = jnp.minimum(w, nw - 1)
        flat = b.astype(jnp.int64) * nw + wc
        word = jnp.take(self.prev_words.reshape(-1), flat)
        mask = jnp.where(rem > 0, (jnp.uint32(1) << rem) - jnp.uint32(1), jnp.uint32(0))
        mask = jnp.where(over, jnp.uint32(0xFFFFFFFF), mask)
        part = lax.population_count(word & mask).astype(jnp.int64)
        return jnp.take(self.prev_cum.reshape(-1), flat) + part

    def entry_has_front(self, entry, b):
        nw = self.prev_words.shape[1]
        flat = jnp.asarray(b).astype(jnp.int64) * nw + (entry >> 5)
        word = jnp.take(self.prev_words.reshape(-1), flat)
        return ((word >> (entry & 31).astype(jnp.uint32)) & 1).astype(bool)

    def entry_push_front(self, entry, b):
        """Batched seqset::entry_push_front (seqset.h:100-103)."""
        return jnp.take(self.fixed, jnp.asarray(b).astype(jnp.int64)) + self.rank(
            b, entry
        )

    def entry_first_base(self, entry):
        """Batched seqset::entry_get_base (seqset.cpp:249-254)."""
        entry = jnp.asarray(entry)
        ge1 = (entry >= self.fixed[1]).astype(jnp.int32)
        ge2 = (entry >= self.fixed[2]).astype(jnp.int32)
        ge3 = (entry >= self.fixed[3]).astype(jnp.int32)
        return ge1 + ge2 + ge3

    def entry_pop_front(self, entry):
        """Batched pop via the select table (== pop_front cache)."""
        return jnp.take(self.pop_sel, jnp.asarray(entry))

    def push_front(self, r: SeqsetRanges, b) -> SeqsetRanges:
        """Batched seqset_range::push_front (seqset.cpp:319-338).

        Lanes with invalid input ranges stay invalid.
        """
        b = jnp.asarray(b)
        fixed_b = jnp.take(self.fixed, b.astype(jnp.int64))
        nb = fixed_b + self.rank(b, r.begin)
        ne = fixed_b + self.rank(b, r.end)
        new_size = r.size + 1
        # kick begin forward if the first entry is too short to hold b+S
        sizes_nb = jnp.take(self.entry_sizes, jnp.minimum(nb, self.n_entries - 1))
        kick = (nb < ne) & (sizes_nb < new_size)
        nb = nb + kick.astype(nb.dtype)
        was_valid = r.begin < r.end
        nb = jnp.where(was_valid, nb, r.begin)
        ne = jnp.where(was_valid, ne, r.begin)
        return SeqsetRanges(begin=nb, end=ne, size=jnp.where(was_valid, new_size, r.size))

    def sizes_at(self, entry):
        """entry_sizes[min(entry, n-1)]."""
        return jnp.take(self.entry_sizes, jnp.minimum(entry, self.n_entries - 1))

    def rank4(self, pos):
        """All-4-bases rank at each position: int32 [B, 4] (ops/rank4.py)."""
        from biograph_jax.ops.rank4 import rank4_xla

        return rank4_xla(self.prev_words, self.prev_cum, pos)

    def push4(self, r: SeqsetRanges):
        """Children of each range for ALL four pushed bases at once.

        Returns (begin4, end4) int64 [B, 4] indexed by the pushed base —
        column b equals push_front(r, b).(begin, end).  Costs two rank4
        evaluations instead of eight rank chains; the wavefront's 4-base
        probe is built on this."""
        B = r.begin.shape[0]
        # both range ends in one stacked gather
        r4 = self.rank4(jnp.concatenate([r.begin, r.end])).astype(jnp.int64)
        nb = self.fixed[None, :4] + r4[:B]
        ne = self.fixed[None, :4] + r4[B:]
        new_size = (r.size + 1)[:, None]
        sizes_nb = self.sizes_at(nb)
        kick = (nb < ne) & (sizes_nb < new_size)
        nb = nb + kick.astype(nb.dtype)
        was_valid = (r.begin < r.end)[:, None]
        nb = jnp.where(was_valid, nb, r.begin[:, None])
        ne = jnp.where(was_valid, ne, r.begin[:, None])
        return nb, ne

    def push_front_drop(self, r: SeqsetRanges, b, min_ctx=0) -> SeqsetRanges:
        """Batched seqset_range::push_front_drop (seqset.cpp:350-427).

        Pushes base b onto each lane's sequence; where the result would be
        empty (or a lone too-short entry), drops context — widening the range
        to a shorter shared suffix via nearest-shared-below searches — until
        the push succeeds.  Lanes whose context would fall below ``min_ctx``
        come back invalid.
        """
        b = jnp.asarray(b)
        n = self.n_entries
        fixed_b = jnp.take(self.fixed, b.astype(jnp.int64))
        o_begin = jnp.asarray(r.begin)
        o_end = jnp.asarray(r.end)
        o_ctx = jnp.asarray(r.size, jnp.int32)
        sub_b = self.rank(b, o_begin)
        sub_e = self.rank(b, o_end)
        dead = (o_ctx < jnp.asarray(min_ctx, jnp.int32)) | (o_begin >= o_end)

        def need_drop(sub_b, sub_e, o_ctx):
            first = jnp.clip(fixed_b + sub_b, 0, n - 1)
            lone_short = (sub_b + 1 == sub_e) & (
                jnp.take(self.entry_sizes, first) < o_ctx + 1
            )
            return (sub_b == sub_e) | lone_short

        def cond(state):
            o_begin, o_end, o_ctx, sub_b, sub_e, dead, done = state
            return jnp.any(~done)

        def body(state):
            o_begin, o_end, o_ctx, sub_b, sub_e, dead, done = state
            active = ~done
            first = jnp.clip(fixed_b + sub_b, 0, n - 1)
            drop = jnp.maximum(
                jnp.take(self.shared, jnp.clip(o_begin, 0, n - 1)),
                jnp.where(
                    o_end >= n,
                    0,
                    jnp.take(self.shared, jnp.clip(o_end, 0, n - 1)),
                ),
            ).astype(jnp.int32)
            drop = jnp.where(
                sub_b != sub_e,
                jnp.maximum(drop, jnp.take(self.entry_sizes, first) - 1),
                drop,
            )
            below_min = drop < jnp.asarray(min_ctx, jnp.int32)
            upd_b = active & (o_begin > 0) & (
                jnp.take(self.shared, jnp.clip(o_begin, 0, n - 1)) >= drop
            )
            upd_e = active & (o_end < n) & (
                jnp.take(self.shared, jnp.clip(o_end, 0, n - 1)) >= drop
            )
            nb = self.shared_lt.next_backward_lt(
                jnp.where(upd_b, o_begin, 1), drop
            )
            ne = self.shared_lt.next_forward_lt(
                jnp.where(upd_e, o_end, n - 1), drop
            )
            nb = jnp.maximum(nb, 0)
            progress = upd_b | upd_e | (drop != o_ctx)
            newly_dead = active & (below_min | ~progress)
            o_begin2 = jnp.where(upd_b, nb, o_begin)
            o_end2 = jnp.where(upd_e, ne, o_end)
            sub_b2 = jnp.where(upd_b, self.rank(b, o_begin2), sub_b)
            sub_e2 = jnp.where(upd_e, self.rank(b, o_end2), sub_e)
            o_ctx2 = jnp.where(active, drop, o_ctx)
            still = need_drop(sub_b2, sub_e2, o_ctx2)
            dead = dead | newly_dead
            done = done | newly_dead | (active & ~still)
            keep = active & ~newly_dead
            return (
                jnp.where(keep, o_begin2, o_begin),
                jnp.where(keep, o_end2, o_end),
                jnp.where(keep, o_ctx2, o_ctx),
                jnp.where(keep, sub_b2, sub_b),
                jnp.where(keep, sub_e2, sub_e),
                dead,
                done,
            )

        done0 = dead | ~need_drop(sub_b, sub_e, o_ctx)
        o_begin, o_end, o_ctx, sub_b, sub_e, dead, _ = lax.while_loop(
            cond, body, (o_begin, o_end, o_ctx, sub_b, sub_e, dead, done0)
        )
        new_begin = fixed_b + sub_b
        new_end = fixed_b + sub_e
        sizes_nb = jnp.take(self.entry_sizes, jnp.clip(new_begin, 0, n - 1))
        kick = (new_begin < new_end) & (sizes_nb < o_ctx + 1)
        new_begin = new_begin + kick.astype(new_begin.dtype)
        new_begin = jnp.where(dead, 0, new_begin)
        new_end = jnp.where(dead, 0, new_end)
        return SeqsetRanges(
            begin=new_begin,
            end=new_end,
            size=jnp.where(dead, 0, o_ctx + 1),
        )

    def find(self, codes, lengths) -> SeqsetRanges:
        """Batched seqset::find (seqset.cpp:146-155): backward search.

        codes: [B, L] uint8 padded; lengths: [B].  Pushes bases from last to
        first; short lanes start later so all lanes finish together.
        """
        B, L = codes.shape
        lengths = jnp.asarray(lengths, jnp.int32)
        begin = jnp.zeros((B,), jnp.int64)
        end = jnp.full((B,), self.n_entries, jnp.int64)
        size = jnp.zeros((B,), jnp.int32)

        def step(i, state):
            begin, end, size = state
            # position from the back: lane processes base index lengths-1-i-? —
            # we push base at index (lengths - 1 - i) when i < lengths
            pos = lengths - 1 - i
            active = (pos >= 0) & (begin < end)
            bidx = jnp.take_along_axis(
                codes, jnp.maximum(pos, 0).astype(jnp.int64)[:, None], axis=1
            )[:, 0]
            r2 = self.push_front(
                SeqsetRanges(begin, end, size), bidx.astype(jnp.int32)
            )
            begin = jnp.where(active, r2.begin, begin)
            end = jnp.where(active, r2.end, end)
            size = jnp.where(active, r2.size, size)
            return begin, end, size

        begin, end, size = lax.fori_loop(0, L, step, (begin, end, size))
        return SeqsetRanges(begin=begin, end=end, size=size)

    def find_existing(self, codes, lengths):
        """Batched seqset::find_existing (seqset.cpp:161-171): entry ids for
        sequences known to exist.  Undefined for missing sequences."""
        B, L = codes.shape
        lengths = jnp.asarray(lengths, jnp.int32)
        entry = jnp.zeros((B,), jnp.int64)

        def step(i, entry):
            pos = lengths - 1 - i
            active = pos >= 0
            bidx = jnp.take_along_axis(
                codes, jnp.maximum(pos, 0).astype(jnp.int64)[:, None], axis=1
            )[:, 0].astype(jnp.int32)
            nxt = self.entry_push_front(entry, bidx)
            return jnp.where(active, nxt, entry)

        return lax.fori_loop(0, L, step, entry)

    def sequences(self, entries, max_len: int):
        """Batched seqset_range::sequence (seqset.cpp:673-689): reconstruct
        the first max_len bases of each entry id via pop chains."""
        entries = jnp.asarray(entries)
        B = entries.shape[0]
        out = jnp.zeros((B, max_len), jnp.uint8)

        def step(i, state):
            cur, out = state
            b = self.entry_first_base(cur)
            out = out.at[:, i].set(b.astype(jnp.uint8))
            return self.entry_pop_front(cur), out

        _, out = lax.fori_loop(0, max_len, step, (entries, out))
        return out

    def pop_front_ranges(self, r: SeqsetRanges) -> SeqsetRanges:
        """Batched seqset_range::pop_front (seqset.cpp:609-628).

        Drops the first base of each lane's sequence and widens to all entries
        sharing the remaining prefix, using a masked widening scan over
        ``shared``.  Widening is log-bounded via the shared-prefix doubling
        trick (each step at least doubles the widening window).
        """
        new_size = r.size - 1
        popped = self.entry_pop_front(r.begin)
        nb, ne = self._widen(popped, popped + 1, jnp.maximum(new_size, 1))
        # popping to the empty sequence yields the full seqset
        empty = new_size <= 0
        nb = jnp.where(empty, 0, nb)
        ne = jnp.where(empty, self.n_entries, ne)
        return SeqsetRanges(begin=nb, end=ne, size=jnp.maximum(new_size, 0))

    def truncate_ranges(self, r: SeqsetRanges, new_size) -> SeqsetRanges:
        """Batched seqset_range::truncate/pop_back (seqset.cpp:630-664):
        shorten each lane's sequence to new_size bases, widening the range to
        every entry sharing that prefix.  Lanes already <= new_size pass
        through unchanged."""
        new_size = jnp.broadcast_to(jnp.asarray(new_size, jnp.int32), r.size.shape)
        need = r.size > new_size
        tgt = jnp.where(need, new_size, r.size)
        nb, ne = self._widen(r.begin, r.end, jnp.maximum(tgt, 1))
        return SeqsetRanges(
            begin=jnp.where(need, nb, r.begin),
            end=jnp.where(need, ne, r.end),
            size=tgt,
        )

    def trunc_gather(self, prev_lt, next_lt, begin, end):
        """Constant-threshold truncation boundaries via the caller-built
        widen tables (variants/discover._trunc_tables): prev_lt/next_lt are
        per-entry arrays; returns (new_begin, new_end) for each lane.  The
        sharded engine overrides this with an owner-gather collective
        (parallel/sharded_discovery.py) — same contract, entry-sharded
        tables."""
        n_e = self.n_entries
        wb = jnp.maximum(jnp.take(prev_lt, jnp.clip(begin, 0, n_e - 1)), 0)
        we = jnp.where(
            end >= n_e, n_e, jnp.take(next_lt, jnp.clip(end, 0, n_e - 1))
        )
        return wb, we

    def _widen(self, begin, end, size):
        """Expand [begin, end) to the maximal run where shared >= size.

        Invariant: shared[j] >= size for all j in (begin', end') exclusive.
        Both boundaries are nearest-shared-below-size queries, answered in
        O(block walk) by the two-level LtSearch structure (the reference does
        the equivalent jumps through its shared-prefix array,
        seqset.cpp:630-664) — not a step-by-1 widening loop, which gated every
        lane on the slowest lane's run length."""
        begin = jnp.asarray(begin)
        end = jnp.asarray(end)
        size = jnp.asarray(size, jnp.int32)
        # largest j <= begin with shared[j] < size  (run start boundary)
        nb = self.shared_lt.next_backward_lt(begin + 1, size)
        nb = jnp.maximum(nb, 0)
        # smallest j >= end with shared[j] < size   (run end boundary; n if none)
        ne = self.shared_lt.next_forward_lt(end - 1, size)
        return nb, ne


jax.tree_util.register_pytree_node(
    _SeqsetDevice, _SeqsetDevice.tree_flatten, _SeqsetDevice.tree_unflatten
)
