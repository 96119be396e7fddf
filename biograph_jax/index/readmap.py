"""Readmap: seqset entries <-> reads, lengths, pairing, coverage queries.

Counterpart of the reference readmap (modules/bio_base/readmap.h:75):
  * sparse_multi mapping seqset entry -> readmap entries (CSR offsets,
    reference modules/io/sparse_multi.h:20)
  * per readmap-entry: read length, is_forward bit, mate-loop link
    (fwd -> RC -> mate -> mate-RC cycle, readmap.h:216-236)

A "readmap entry" exists for each orientation of each read (a read and its
reverse complement are separate entries pointing at different seqset entries,
linked by the mate loop).  get_read_count == num_entries / 2
(readmap.h:142).

All queries are batched (arrays of readmap-entry ids / seqset ranges in,
arrays out), mirroring the one-at-a-time reference API in vector form.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import jax.numpy as jnp

from biograph_jax.core import container


@dataclass
class Readmap:
    seqset: object
    # CSR over seqset entries -> readmap entry ids
    offsets: np.ndarray  # int64 [n_seqset_entries + 1]
    read_lengths: np.ndarray  # int32 [n_rm]
    is_forward: np.ndarray  # bool [n_rm]
    mate_pair_ptr: np.ndarray  # int64 [n_rm] — next link in the mate loop
    read_ids: np.ndarray  # int64 [n_rm] — original read index
    uuid: str = ""
    coverage_truncated: int = 0  # reads dropped by the kmax per-entry cap
    _warned_truncation: bool = False

    @property
    def num_entries(self) -> int:
        return len(self.read_lengths)

    @property
    def read_count(self) -> int:
        return self.num_entries // 2

    @cached_property
    def entry_of_rm(self) -> np.ndarray:
        """seqset entry id owning each readmap entry (reverse CSR)."""
        n = len(self.offsets) - 1
        counts = np.diff(self.offsets)
        return np.repeat(np.arange(n, dtype=np.int64), counts)

    @cached_property
    def length_groups(self):
        """Per-entry attached-read counts grouped by (read length, strand).

        Returns (lens int32 [D], counts int32 [D, 2, n_entries]) where
        counts[d, 0] counts attached reads of length lens[d] whose
        is_forward is False and counts[d, 1] those with True — exactly the
        split the coverage walk needs (the complement walk flips strand).
        With D small (uniform libraries have D == 1) coverage counting
        needs no per-read gather loop and NO kmax truncation at all."""
        n = len(self.offsets) - 1
        ent = self.entry_of_rm
        lens = np.unique(self.read_lengths) if self.num_entries else np.zeros(
            0, np.int32
        )
        counts = np.zeros((len(lens), 2, n), np.int32)
        fwd = np.asarray(self.is_forward)
        for d, m in enumerate(lens):
            sel = self.read_lengths == m
            counts[d, 0] = np.bincount(ent[sel & ~fwd], minlength=n)
            counts[d, 1] = np.bincount(ent[sel & fwd], minlength=n)
        return np.asarray(lens, np.int32), counts

    @cached_property
    def window_hash(self):
        """Hash index of full-length entries for the uniform coverage probe.

        With a uniform library (every read the same length == max_entry_len)
        a full-depth window in the coverage walk can only be an ENTIRE
        seqset entry: entries are distinct, at most depth long, and the
        walk's kick drops shorter ones — so the probe's answer is always a
        unique range [entry, entry+1).  That turns the depth-step rank
        chain (readmap.cpp:368's walk) into one rolling-hash lookup per
        position: hash every full-length entry's sequence once (sorted
        64-bit keys), then match query windows by hash + binary search.
        Returns (keys int64 [n] sorted, ids int64 [n], depth) or None."""
        depth = int(self.seqset.max_entry_len)
        if depth < 8 or self.num_entries == 0:
            return None
        sizes = np.asarray(self.seqset.entry_sizes)
        full = np.nonzero(sizes >= depth)[0].astype(np.int64)
        if len(full) == 0:
            return None
        from biograph_jax.index.probes import entry_seq_matrix

        s = entry_seq_matrix(self.seqset)[full, :depth].astype(
            np.uint32
        ) + np.uint32(1)
        pw1, _, pw2, _ = _hash_pows_np(depth)
        h1 = (s * pw1[None, :depth]).sum(axis=1, dtype=np.uint32)
        h2 = (s * pw2[None, :depth]).sum(axis=1, dtype=np.uint32)
        key = ((h1.astype(np.uint64) << np.uint64(32)) | h2).view(np.int64)
        order = np.argsort(key)
        return jnp.asarray(key[order]), jnp.asarray(full[order]), depth

    @cached_property
    def min_read_len(self) -> int:
        # NOT .min(initial=0): numpy folds `initial` INTO the reduction
        # (min(x, 0) == 0 always), which silently disabled the uniform
        # coverage fast path for every library until round 5
        if self.num_entries == 0:
            return 0
        return int(self.read_lengths.min())

    @cached_property
    def max_read_len(self) -> int:
        return int(self.read_lengths.max(initial=0))

    # ------------- batched queries (jnp in/out) -------------

    def entry_read_range(self, entries):
        """[start, end) into readmap-entry ids for each seqset entry
        (reference readmap::entry_to_index, readmap.h:113)."""
        off = jnp.asarray(self.offsets)
        e = jnp.asarray(entries)
        return jnp.take(off, e), jnp.take(off, e + 1)

    def entry_read_count(self, entries):
        s, e = self.entry_read_range(entries)
        return e - s

    def get_rev_comp(self, rm_ids):
        """Mate-loop walked 1 (forward) or 3 (rc) times (readmap.h:223-225)."""
        loop = jnp.asarray(self.mate_pair_ptr)
        fwd = jnp.take(jnp.asarray(self.is_forward), rm_ids)
        one = jnp.take(loop, rm_ids)
        three = jnp.take(loop, jnp.take(loop, one))
        return jnp.where(fwd, one, three)

    def get_mate(self, rm_ids):
        """Mate = loop twice (readmap.h:227); for unpaired returns self."""
        loop = jnp.asarray(self.mate_pair_ptr)
        return jnp.take(loop, jnp.take(loop, rm_ids))

    def has_mate(self, rm_ids):
        return self.get_mate(rm_ids) != jnp.asarray(rm_ids)

    def get_pair_stats(self):
        loop = self.mate_pair_ptr
        mate2 = loop[loop]
        paired = mate2 != np.arange(self.num_entries)
        fwd = self.is_forward
        return {
            "paired_reads": int((paired & fwd).sum()),
            "paired_bases": int(self.read_lengths[paired & fwd].sum()),
            "unpaired_reads": int((~paired & fwd).sum()),
            "unpaired_bases": int(self.read_lengths[~paired & fwd].sum()),
        }

    # ------------- read iteration (SDK surface) -------------

    def get_prefix_reads(self, entry, min_read_len: int = 0):
        """Reads that are a PREFIX of the range's sequence.

        Batch counterpart of readmap::get_prefix_reads (readmap.h:169): for
        every truncation length m, reads of length exactly m attached to the
        widened range are prefixes.  Returns [(read_id, length)] descending
        by length.  `entry` is a SeqsetEntry-like (begin, end, size)."""
        from biograph_jax.index.seqset import SeqsetRanges

        out = []
        d = self.seqset.d
        size = int(entry.size)
        r = SeqsetRanges(
            jnp.asarray([entry.begin]),
            jnp.asarray([entry.end]),
            jnp.asarray([size], jnp.int32),
        )
        for m in range(size, max(min_read_len, self.min_read_len) - 1, -1):
            t = d.truncate_ranges(r, m)
            lo = int(t.begin[0])
            hi = int(t.end[0])
            rm_lo, rm_hi = int(self.offsets[lo]), int(self.offsets[hi])
            lens = self.read_lengths[rm_lo:rm_hi]
            for j in np.nonzero(lens == m)[0]:
                out.append((int(self.read_ids[rm_lo + j]), m))
        return out

    def get_longest_prefix_read(self, entry):
        reads = self.get_prefix_reads(entry)
        return reads[0] if reads else None

    def get_reads_containing(self, seq, max_levels: int | None = None):
        """Reads containing `seq` anywhere (readmap.h:177 analog).

        Batched breadth-first leftward extension: the frontier of ranges
        (seq with o prepended bases) advances one level per step via one
        fused push4 over ALL frontier lanes; reads attached to a frontier
        range with read_len >= range size contain seq at offset o.
        Returns [(read_id, offset)]."""
        from biograph_jax.core import dna as _dna
        from biograph_jax.index.seqset import SeqsetRanges

        d = self.seqset.d
        if isinstance(seq, str):
            codes = _dna.seq_to_codes(seq)
        else:
            codes = np.asarray(seq, np.uint8)
        L = len(codes)
        r0 = d.find(jnp.asarray(codes[None, :]), jnp.asarray([L], jnp.int32))
        if not bool(r0.begin[0] < r0.end[0]):
            return []
        out = []
        max_levels = (
            self.max_read_len - L if max_levels is None else max_levels
        )
        begin = np.asarray(r0.begin)
        end = np.asarray(r0.end)
        size = np.asarray(r0.size)
        for level in range(max_levels + 1):
            # collect reads at this level
            for b, e, s in zip(begin, end, size):
                rm_lo, rm_hi = int(self.offsets[b]), int(self.offsets[e])
                lens = self.read_lengths[rm_lo:rm_hi]
                for j in np.nonzero(lens >= s)[0]:
                    out.append((int(self.read_ids[rm_lo + j]), level))
            if level == max_levels or len(begin) == 0:
                break
            r = SeqsetRanges(
                jnp.asarray(begin), jnp.asarray(end), jnp.asarray(size, jnp.int32)
            )
            nb4, ne4 = d.push4(r)
            nb = np.asarray(nb4).reshape(-1)
            ne = np.asarray(ne4).reshape(-1)
            ns = np.repeat(np.asarray(size) + 1, 4)
            keep = nb < ne
            begin, end, size = nb[keep], ne[keep], ns[keep]
        # dedup (a read containing seq at several offsets keeps each offset;
        # identical (read, offset) pairs collapse)
        return sorted(set(out), key=lambda t: (t[1], t[0]))

    def find_overlap_reads(self, seq, min_overlap: int = 20):
        """Reads whose PREFIX matches a SUFFIX of `seq` with overlap >=
        min_overlap (seqset.h:279 analog — the assembly extension query).
        Returns [(read_id, overlap)] descending by overlap."""
        from biograph_jax.core import dna as _dna
        from biograph_jax.index.seqset import SeqsetRanges

        d = self.seqset.d
        if isinstance(seq, str):
            codes = _dna.seq_to_codes(seq)
        else:
            codes = np.asarray(seq, np.uint8)
        L = len(codes)
        out = []
        seen = set()
        for m in range(min(L, self.max_read_len), min_overlap - 1, -1):
            suf = codes[L - m :]
            r = d.find(jnp.asarray(suf[None, :]), jnp.asarray([m], jnp.int32))
            lo, hi = int(r.begin[0]), int(r.end[0])
            if lo >= hi:
                continue
            rm_lo, rm_hi = int(self.offsets[lo]), int(self.offsets[hi])
            lens = self.read_lengths[rm_lo:rm_hi]
            for j in np.nonzero(lens >= m)[0]:
                rid = int(self.read_ids[rm_lo + j])
                if rid not in seen:
                    seen.add(rid)
                    out.append((rid, m))
        return out

    # ------------- coverage (sequence-level queries) -------------

    def coverage(self, codes, lengths, kmax: int = 16):
        """Per-base read coverage of query sequences, split by strand.

        Batch counterpart of readmap::approx_strand_coverage_split
        (modules/bio_base/readmap.cpp:368-399): walk the *complement* of each
        query with push_front_drop; wherever the range is unique, reads
        attached to its entry with read_len <= range size end at that
        position.  Strand is flipped because the walk builds the complement.

        codes: [B, L] uint8; lengths: [B]; kmax bounds reads gathered per
        entry (duplicate-heavy entries beyond kmax are truncated, matching
        the 'approx' spirit of the reference API).

        Returns (fwd_cov, rev_cov): int32 [B, L].
        """
        fwd, rev, _, _ = self._coverage_full(codes, lengths, kmax)
        return fwd, rev

    def coverage_events(self, codes, lengths, kmax: int = 16):
        """Raw read start/end events under each query window.

        Returns (starts, ends): int32 [B, L] counts of reads (both strands
        summed) starting / ending at each window position whose full body
        matches the window there.  `sum(starts[:a+1]) - sum(ends[:b])`
        counts reads spanning [a, b] entirely — the linkage statistic
        phasing needs (a context-dropped coverage min cannot distinguish
        one-sided support)."""
        _, _, starts, ends = self._coverage_full(codes, lengths, kmax)
        return starts, ends

    def _coverage_full(self, codes, lengths, kmax: int = 16):
        codes = np.asarray(codes, np.uint8)
        lengths = np.asarray(lengths, np.int32)
        B, L = codes.shape
        # shape-bucket to limit recompiles: L -> multiple of 64, B -> pow2
        Lp = max(64, -(-L // 64) * 64)
        Bp = 1
        while Bp < B:
            Bp *= 2
        cp = np.zeros((Bp, Lp), np.uint8)
        cp[:B, :L] = codes
        lp = np.zeros(Bp, np.int32)
        lp[:B] = lengths
        fwd, rev, starts, ends, n_trunc = self._coverage_probe(cp, lp, kmax)
        nt = int(n_trunc)
        self.coverage_truncated += nt
        if nt and not self._warned_truncation:
            self._warned_truncation = True
            import warnings

            warnings.warn(
                f"readmap.coverage: {nt} reads beyond the kmax={kmax} "
                "per-entry cap were not counted (duplicate-heavy entries); "
                "raise kmax for exact depth"
            )
        return fwd[:B, :L], rev[:B, :L], starts[:B, :L], ends[:B, :L]

    def _coverage_probe(self, cp, lp, kmax: int):
        """Per-position probe formulation of the coverage walk.

        The walk state at query position j is the longest existing window
        ending at j (context never exceeds the longest entry) — computed
        for ALL (row, position) lanes at once by the shared probe engine
        over the flattened query rows, then one vectorized counting pass.
        Sequential depth = max_entry_len instead of the padded row length,
        and no widening searches anywhere (the push_front_drop scan spends
        its steps in the drop searches).

        Uniform-read-length fast path: counting only consumes positions
        whose window reaches read length (m <= size), and with
        min_read_len == max_read_len == max_entry_len the longest window is
        either exactly depth (when the full read-length window exists —
        then its range IS the longest-window range) or too short to count.
        ONE find_window(depth) chain over all lanes replaces the restart
        chain + exact recompute — zero host round trips inside the loop."""
        from biograph_jax.index.probes import (
            fetch_mask,
            find_window_jit,
            probe_exact_jit,
            probe_ranges_jit,
        )

        d = self.seqset.d
        Bp, Lp = cp.shape
        depth = min(max(int(self.seqset.max_entry_len), 1), Lp)
        uniform = (
            self.num_entries > 0
            and self.min_read_len == self.max_read_len == depth
        )
        min_rl = max(min(self.min_read_len, depth), 1)
        text = jnp.asarray(cp.reshape(-1))
        # slab rows so lane arrays stay bounded
        rows = max(min((1 << 20) // Lp, Bp), 1)
        rows = 1 << (rows.bit_length() - 1)  # pow2 rows per slab
        outs = []
        for r0 in range(0, Bp, rows):
            P = rows * Lp
            p0 = jnp.asarray(r0 * Lp, jnp.int64)
            pos = jnp.arange(P, dtype=jnp.int64) + r0 * Lp
            if uniform:
                import os as _os

                wh = (
                    self.window_hash
                    if not _os.environ.get("BGT_NO_COV_HASH")
                    else None
                )
                if wh is not None:
                    # rank-free probe: every full-depth window is exactly
                    # one full-length entry — one rolling-hash lookup per
                    # position replaces the depth-step rank chain entirely
                    keys, ids, _ = wh
                    b, e, s = _uniform_hash_probe(
                        keys, ids,
                        lax.dynamic_slice_in_dim(text, r0 * Lp, P),
                        *_hash_pows_dev(P), Lp, depth,
                    )
                else:
                    b, e, s = _uniform_probe(d, text, pos, Lp, depth)
            else:
                seg = pos // Lp * Lp
                b, e, s, restarted = probe_ranges_jit(d, text, p0, seg, P, depth)
                # padding lanes (beyond each row's real length) restart on
                # garbage windows; lanes whose longest window cannot reach
                # min_read_len can never count a read — filter both before
                # paying the exact recompute
                li = np.arange(P)
                rst = fetch_mask(restarted) & ((li % Lp) < lp[r0 + li // Lp])
                rst &= (li % Lp) + 1 >= min_rl  # window can't fit a read
                if rst.any():
                    idx = np.nonzero(rst)[0]
                    m = 1 << max((len(idx) - 1).bit_length(), 0)
                    idx_p = np.concatenate(
                        [idx, np.full(m - len(idx), idx[-1])]
                    ).astype(np.int64)
                    pos_p = jnp.asarray(idx_p) + r0 * Lp
                    fb, fe, fs = find_window_jit(
                        d, text, pos_p, jnp.full((m,), min_rl, jnp.int32), depth
                    )
                    alive = fetch_mask(fb < fe)
                    if alive.any():
                        idx2 = np.nonzero(alive)[0]
                        m2 = 1 << max((len(idx2) - 1).bit_length(), 0)
                        sel = np.concatenate(
                            [idx2, np.full(m2 - len(idx2), idx2[-1])]
                        )
                        selj = jnp.asarray(sel)
                        pos2 = jnp.take(pos_p, selj)
                        b2, e2, s2 = probe_exact_jit(
                            d, text, pos2, pos2 // Lp * Lp, depth, min_rl,
                            (
                                jnp.take(fb, selj),
                                jnp.take(fe, selj),
                                jnp.take(fs, selj),
                            ),
                        )
                        di = jnp.take(jnp.asarray(idx_p), selj)
                        b = b.at[di].set(b2)
                        e = e.at[di].set(e2)
                        s = s.at[di].set(s2)
            lens, grp = self.length_groups
            if 0 < len(lens) <= 8:
                # grouped counting: per-entry (length, strand) totals give
                # EXACT depth with D tiny passes — no per-read K-loop, no
                # kmax truncation at any duplication level
                outs.append(
                    _coverage_count_grouped(
                        d,
                        jnp.asarray(lens),
                        jnp.asarray(grp),
                        b, e, s,
                        jnp.asarray(lp[r0 : r0 + rows]),
                        rows, Lp, min_rl,
                    )
                    + (0,)
                )
            else:
                outs.append(
                    _coverage_count(
                        d,
                        jnp.asarray(self.offsets),
                        jnp.asarray(self.read_lengths),
                        jnp.asarray(self.is_forward),
                        b, e, s,
                        jnp.asarray(lp[r0 : r0 + rows]),
                        rows, Lp, kmax, min_rl,
                    )
                )
        fwd = jnp.concatenate([o[0] for o in outs])
        rev = jnp.concatenate([o[1] for o in outs])
        starts = jnp.concatenate([o[2] for o in outs])
        ends = jnp.concatenate([o[3] for o in outs])
        n_trunc = sum(int(o[4]) for o in outs)
        return fwd, rev, starts, ends, n_trunc

    # ------------- persistence -------------

    # (placeholder anchor; persistence methods below)

    def save(self, path: str):
        with container.ArtifactWriter(path, "readmap") as w:
            w.set_scalar("seqset_uuid", getattr(self.seqset, "uuid", ""))
            w.add_array("offsets", self.offsets)
            w.add_array("read_lengths", np.asarray(self.read_lengths, np.int32))
            w.add_array("is_forward", np.asarray(self.is_forward, bool))
            w.add_array("mate_pair_ptr", np.asarray(self.mate_pair_ptr, np.int64))
            w.add_array("read_ids", np.asarray(self.read_ids, np.int64))
            self.uuid = w.meta["uuid"]

    @staticmethod
    def load(path: str, seqset) -> "Readmap":
        r = container.ArtifactReader(path, "readmap")
        return Readmap(
            seqset=seqset,
            offsets=r.array("offsets"),
            read_lengths=r.array("read_lengths"),
            is_forward=r.array("is_forward"),
            mate_pair_ptr=r.array("mate_pair_ptr"),
            read_ids=r.array("read_ids"),
            uuid=r.uuid,
        )


from functools import partial
import jax
from jax import lax


# rolling-hash constants for the uniform coverage probe (any odd multipliers)
_HM1, _HM2 = 0x9E3779B1, 0x85EBCA77
_POW_NP: dict = {}
_POW_DEV: dict = {}


def _hash_pows_np(P: int):
    """(m1^t, m1^-t, m2^t, m2^-t) mod 2^32 for t in [0, P) as uint32."""
    ent = _POW_NP.get(P)
    if ent is None:
        MASK = (1 << 32) - 1

        def pows(m):
            return np.concatenate(
                [
                    np.ones(1, np.uint32),
                    np.cumprod(np.full(P - 1, m, np.uint32), dtype=np.uint32),
                ]
            )

        ent = (
            pows(_HM1),
            pows(pow(_HM1, -1, 1 << 32) & MASK),
            pows(_HM2),
            pows(pow(_HM2, -1, 1 << 32) & MASK),
        )
        _POW_NP[P] = ent
    return ent


def _hash_pows_dev(P: int):
    ent = _POW_DEV.get(P)
    if ent is None:
        ent = tuple(jnp.asarray(a) for a in _hash_pows_np(P))
        _POW_DEV[P] = ent
    return ent


@partial(jax.jit, static_argnums=(7, 8))
def _uniform_hash_probe(keys, ids, text, pw1, pwinv1, pw2, pwinv2,
                        Lp: int, depth: int):
    """(begin, end, size) of the full-depth window ending at every position
    via rolling hash + binary search — O(1) rank-free per position.

    The window the walk builds at position j is revcomp(text[j-depth+1..j]),
    i.e. base i of the entry equals comp(text[j-i]); the polynomial hash
    H(j) = sum_i (comp(text[j-i])+1)*m^i is computed for ALL j at once as
    m^j * (P(j) - P(j-depth)) with P the cumulative sum of
    (comp(text[t])+1)*m^-t, everything mod 2^32 (wrapping uint32).  Two
    independent multipliers give a 64-bit key against the sorted
    full-length-entry keys (Readmap.window_hash)."""
    P = text.shape[0]
    cc = (jnp.uint32(3) - text.astype(jnp.uint32)) + jnp.uint32(1)
    pos = jnp.arange(P, dtype=jnp.int64)

    def roll(pw, pwinv):
        pref = jnp.cumsum(cc * pwinv)  # uint32: exact modular arithmetic
        shifted = jnp.concatenate(
            [jnp.zeros((depth,), jnp.uint32), pref[:-depth]]
        )
        return pw * (pref - shifted)

    h1 = roll(pw1, pwinv1)
    h2 = roll(pw2, pwinv2)
    key = lax.bitcast_convert_type(
        (h1.astype(jnp.uint64) << jnp.uint64(32)) | h2.astype(jnp.uint64),
        jnp.int64,
    )
    idx = jnp.searchsorted(keys, key)
    idxc = jnp.clip(idx, 0, keys.shape[0] - 1)
    hit = (jnp.take(keys, idxc) == key) & ((pos % Lp) + 1 >= depth)
    b = jnp.where(hit, jnp.take(ids, idxc), 0)
    e = jnp.where(hit, b + 1, b)
    s = jnp.where(hit, jnp.int32(depth), jnp.int32(0))
    return b, e, s


@partial(jax.jit, static_argnums=(3, 4))
def _uniform_probe(d, text, pos, Lp: int, depth: int):
    """find_window(depth) over all lanes; positions whose full-depth window
    would cross the row boundary (j < depth-1 in their row) come back
    invalid — no read fits there anyway."""
    from biograph_jax.index.probes import find_window

    P = pos.shape[0]
    b, e, s = find_window(d, text, pos, jnp.full((P,), depth, jnp.int32), depth)
    ok = (pos % Lp) + 1 >= depth
    return b, jnp.where(ok, e, b), s


@partial(jax.jit, static_argnums=(7, 8, 9))
def _coverage_count_grouped(d, lens, grp, begin, end, size, lengths,
                            B: int, L: int, min_rl: int = 1):
    """Exact read counting via per-entry (length, strand) group totals.

    Same semantics as _coverage_count but with the K-loop over attached
    reads replaced by D passes over precomputed counts (Readmap.
    length_groups) — exact at any duplication level, no kmax cap.
    lens: int32 [D]; grp: int32 [D, 2, n_entries]."""
    n_entries = d.n_entries
    D = lens.shape[0]
    begin = begin.reshape(B, L)
    end = end.reshape(B, L)
    size = size.reshape(B, L)
    j = jnp.arange(L)[None, :]
    active = j < lengths[:, None]
    unique = active & (begin + 1 == end) & (size >= min_rl)
    e = jnp.clip(begin, 0, n_entries - 1)
    starts = jnp.zeros((2, B, L), jnp.int32)
    ends = jnp.zeros((2, B, L), jnp.int32)
    b2 = jnp.broadcast_to(jnp.arange(B)[:, None], (B, L))
    for di in range(D):  # D is tiny (1 for uniform libraries)
        m = lens[di]
        start_pos = j + 1 - m
        match = unique & (m <= size) & (start_pos >= 0)
        sp = jnp.clip(start_pos, 0, L - 1).astype(jnp.int64)
        for s_i in range(2):
            cnt = jnp.where(match, jnp.take(grp[di, s_i], e), 0).astype(
                jnp.int32
            )
            starts = starts.at[s_i, b2, sp].add(cnt)
            ends = ends.at[s_i].add(cnt)
    covs = []
    for s_i in range(2):
        run = jnp.cumsum(starts[s_i], axis=1) - jnp.cumsum(
            jnp.pad(ends[s_i], ((0, 0), (1, 0)))[:, :L], axis=1
        )
        covs.append(run)
    return covs[0], covs[1], starts.sum(axis=0), ends.sum(axis=0)


@partial(jax.jit, static_argnums=(8, 9, 10, 11))
def _coverage_count(d, offsets, rlen, isfwd, begin, end, size, lengths,
                    B: int, L: int, kmax: int, min_rl: int = 1):
    """Vectorized read counting over per-position probe ranges.

    Mirrors the counting half of readmap::approx_strand_coverage_split
    (modules/bio_base/readmap.cpp:368-399): wherever a position's probe
    range is unique, reads attached to its entry with read_len <= context
    end at that position (strand flipped — the probes walk the complement).
    begin/end/size: flat [B*L] probe ranges from index/probes.py.
    """
    n_entries = d.n_entries
    n_rm = max(int(rlen.shape[0]), 1)
    begin = begin.reshape(B, L)
    end = end.reshape(B, L)
    size = size.reshape(B, L)
    j = jnp.arange(L)[None, :]
    active = j < lengths[:, None]
    # a window shorter than the shortest read can never host a read end;
    # gating here also keeps restart-underestimated lanes (whose exact
    # recompute was skipped for exactly this reason) out of the counts
    unique = active & (begin + 1 == end) & (size >= min_rl)
    e = jnp.clip(begin, 0, n_entries - 1)
    rs = jnp.take(offsets, e)
    re = jnp.take(offsets, e + 1)
    n_trunc = jnp.sum(jnp.where(unique, jnp.maximum(re - rs - kmax, 0), 0))
    ridx = rs[:, :, None] + jnp.arange(kmax)  # [B, L, K]
    ok = unique[:, :, None] & (ridx < re[:, :, None])
    ric = jnp.clip(ridx, 0, n_rm - 1)
    m = jnp.take(rlen, ric)
    start_pos = j[:, :, None] + 1 - m
    match = ok & (m <= size[:, :, None]) & (start_pos >= 0)
    strand_rev = jnp.take(isfwd, ric)  # complement walk flips strand
    hit_f = (match & ~strand_rev).astype(jnp.int32)
    hit_r = (match & strand_rev).astype(jnp.int32)
    sp = jnp.clip(start_pos, 0, L - 1).astype(jnp.int64)
    b3 = jnp.broadcast_to(jnp.arange(B)[:, None, None], sp.shape)
    starts = jnp.zeros((2, B, L), jnp.int32)
    starts = starts.at[0, b3, sp].add(hit_f)
    starts = starts.at[1, b3, sp].add(hit_r)
    ends = jnp.stack([hit_f.sum(axis=2), hit_r.sum(axis=2)])
    covs = []
    for s_i in range(2):
        run = jnp.cumsum(starts[s_i], axis=1) - jnp.cumsum(
            jnp.pad(ends[s_i], ((0, 0), (1, 0)))[:, :L], axis=1
        )
        covs.append(run)
    return covs[0], covs[1], starts.sum(axis=0), ends.sum(axis=0), n_trunc
