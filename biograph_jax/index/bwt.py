"""Reference BWT / FM-index: exact arbitrary-length genome range queries.

Counterpart of the reference's "SpiralBW" reference BWT
(modules/bio_base/bwt_file.h:22, built by modules/bio_mapred/make_bwt.cpp,
queried by `bgbinary bwtquery`): find(seq) -> the SA range of every exact
occurrence, then locate() -> genome positions.  It removes the k<=16 cap of
the seed table in variants/align.py — queries of any length are one backward
search.

Device-native construction: the suffix array comes from *prefix doubling* —
log2(G) rounds of device-wide radix sorts over (rank[i], rank[i+k]) pairs
(jax.lax.sort on int64 keys), not a sequential host SA-IS.  The FM occ
structure reuses the same RankBits rank machinery as the seqset
(core/bitvector.py), and backward search is batched over query lanes exactly
like seqset.find.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from biograph_jax.core import dna
from biograph_jax.core.bitvector import RankBits
from biograph_jax.core import container


def build_suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of codes + implicit terminal sentinel (smallest).

    Returns int64 [G+1]; sa[0] == G (the sentinel suffix).  Device prefix
    doubling: each round sorts (rank, rank_shifted, idx) and re-ranks."""
    g = np.asarray(codes)
    G = len(g)
    n = G + 1
    # rank 0 = sentinel; bases shift up by 1
    rank = jnp.concatenate(
        [jnp.asarray(g, jnp.int64) + 1, jnp.zeros((1,), jnp.int64)]
    )
    idx = jnp.arange(n, dtype=jnp.int64)

    @jax.jit
    def round_(rank, k):
        key2 = jnp.where(idx + k < n, jnp.take(rank, jnp.minimum(idx + k, n - 1)), -1)
        r1, r2, order = lax.sort((rank, key2, idx), num_keys=2, is_stable=True)
        new = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        nr = jnp.concatenate(
            [jnp.zeros((1,), jnp.int64), jnp.cumsum(new.astype(jnp.int64))]
        )
        # scatter back to position order
        rank_out = jnp.zeros((n,), jnp.int64).at[order].set(nr)
        return rank_out, order, nr[-1] + 1

    k = 1
    order = None
    while True:
        rank, order, n_distinct = round_(rank, k)
        if int(n_distinct) == n or k >= n:
            break
        k *= 2
    return np.asarray(order)


@dataclass
class RefBwt:
    """FM-index over the flat reference (forward strand + sentinel)."""

    length: int  # G (without sentinel)
    counts: np.ndarray  # int64 [6]: C array over {sentinel, A, C, G, T}
    occ: list  # 4x RankBits over the BWT, one per base
    sentinel_pos: int  # BWT row whose character is the sentinel
    sa_sample: np.ndarray  # int64 [ceil((G+1)/SA_RATE)] sampled suffix array
    sa_rate: int = 32
    uuid: str = ""

    @staticmethod
    def build(ref_codes: np.ndarray, sa_rate: int = 32) -> "RefBwt":
        g = np.asarray(ref_codes, np.uint8)
        G = len(g)
        sa = build_suffix_array(g)
        n = G + 1
        prev = sa - 1
        bwt = np.where(prev >= 0, g[np.clip(prev, 0, G - 1)], 0).astype(np.uint8)
        sentinel_pos = int(np.nonzero(sa == 0)[0][0])  # bwt char there is '$'
        base_counts = np.bincount(g, minlength=4)
        # C[c] = number of characters strictly smaller; alphabet order $,A,C,G,T
        C = np.zeros(6, np.int64)
        C[1] = 1
        for b in range(4):
            C[b + 2] = C[b + 1] + base_counts[b]
        occ = []
        for b in range(4):
            pos = np.nonzero((bwt == b) & (np.arange(n) != sentinel_pos))[0]
            occ.append(RankBits.from_positions(pos.astype(np.int64), n))
        sa_sample = sa[::sa_rate].astype(np.int64)
        return RefBwt(
            length=G,
            counts=C,
            occ=occ,
            sentinel_pos=sentinel_pos,
            sa_sample=sa_sample,
            sa_rate=sa_rate,
        )

    @staticmethod
    def cached_build(ref_codes: np.ndarray, sa_rate: int = 32) -> "RefBwt":
        """Build with a content-addressed disk cache.

        The suffix-array construction of a whole genome costs tens of
        seconds; pipeline stages that need the reference FM-index (grm,
        placement) share one artifact keyed by the reference bytes.  Cache
        dir: $BGT_CACHE (default <checkout>/.bgt_cache)."""
        import hashlib
        import os

        g = np.asarray(ref_codes, np.uint8)
        h = hashlib.sha256(g.tobytes()).hexdigest()[:24]
        checkout = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        root = os.environ.get("BGT_CACHE", os.path.join(checkout, ".bgt_cache"))
        path = os.path.join(root, f"refbwt_{h}_r{sa_rate}")
        try:
            if os.path.isdir(path):
                return RefBwt.load(path)
        except Exception:
            pass
        bwt = RefBwt.build(g, sa_rate)
        try:
            os.makedirs(root, exist_ok=True)
            bwt.save(path)
        except Exception:
            pass
        return bwt

    @cached_property
    def d(self):
        return _BwtDevice(
            counts=jnp.asarray(self.counts),
            occ_words=jnp.asarray(np.stack([o.words for o in self.occ])),
            occ_cum=jnp.asarray(np.stack([o.cum for o in self.occ])),
            n=self.length + 1,
            sentinel_pos=self.sentinel_pos,
            sa_sample=jnp.asarray(self.sa_sample),
            sa_rate=self.sa_rate,
        )

    # ---------------- queries ----------------

    def find(self, seqs, lengths=None):
        """Batched exact search.  seqs: [B, L] codes (or a str for B=1).
        Returns (lo, hi) int64 [B] SA ranges ([lo, hi) empty if absent)."""
        if isinstance(seqs, str):
            seqs = dna.seq_to_codes(seqs)[None, :]
        seqs = np.asarray(seqs, np.uint8)
        if lengths is None:
            lengths = np.full(seqs.shape[0], seqs.shape[1], np.int32)
        lo, hi = _bwt_find_jit(
            self.d, jnp.asarray(seqs), jnp.asarray(lengths, jnp.int32)
        )
        return np.asarray(lo), np.asarray(hi)

    def locate(self, lo: int, hi: int, max_hits: int = 64) -> np.ndarray:
        """Genome positions of SA rows [lo, hi) (ascending positions)."""
        m = min(int(hi) - int(lo), max_hits)
        if m <= 0:
            return np.zeros(0, np.int64)
        rows = jnp.arange(lo, lo + m, dtype=jnp.int64)
        pos = np.asarray(_bwt_locate_jit(self.d, rows))
        return np.sort(pos)

    def count(self, seq) -> int:
        lo, hi = self.find(seq)
        return int(hi[0] - lo[0])

    # ---------------- persistence ----------------

    def save(self, path: str):
        with container.ArtifactWriter(path, "refbwt") as w:
            w.set_scalar("length", self.length)
            w.set_scalar("sentinel_pos", self.sentinel_pos)
            w.set_scalar("sa_rate", self.sa_rate)
            w.add_array("counts", self.counts)
            w.add_array("occ_words", np.stack([o.words for o in self.occ]))
            w.add_array("occ_cum", np.stack([o.cum for o in self.occ]))
            w.add_array("sa_sample", self.sa_sample)
            self.uuid = w.meta["uuid"]

    @staticmethod
    def load(path: str) -> "RefBwt":
        r = container.ArtifactReader(path, "refbwt")
        words = r.array("occ_words")
        cum = r.array("occ_cum")
        n = r.scalar("length") + 1
        occ = [
            RankBits(
                n=n,
                words=words[b],
                cum=cum[b],
                total=int(
                    cum[b][-1] + bin(int(words[b][-1])).count("1")
                ),
            )
            for b in range(4)
        ]
        return RefBwt(
            length=r.scalar("length"),
            counts=r.array("counts"),
            occ=occ,
            sentinel_pos=r.scalar("sentinel_pos"),
            sa_sample=r.array("sa_sample"),
            sa_rate=r.scalar("sa_rate"),
            uuid=r.uuid,
        )


@dataclass(frozen=True)
class _BwtDevice:
    counts: jnp.ndarray  # [6]
    occ_words: jnp.ndarray  # u32 [4, nw]
    occ_cum: jnp.ndarray  # i64 [4, nw]
    n: int
    sentinel_pos: int
    sa_sample: jnp.ndarray
    sa_rate: int

    def tree_flatten(self):
        return (
            (self.counts, self.occ_words, self.occ_cum, self.sa_sample),
            (self.n, self.sentinel_pos, self.sa_rate),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(
            counts=children[0],
            occ_words=children[1],
            occ_cum=children[2],
            sa_sample=children[3],
            n=aux[0],
            sentinel_pos=aux[1],
            sa_rate=aux[2],
        )

    def rank(self, b, pos):
        """Occurrences of base b in bwt[0:pos] (sentinel row excluded)."""
        nw = self.occ_words.shape[1]
        w = (pos >> 5).astype(jnp.int64)
        rem = (pos & 31).astype(jnp.uint32)
        over = w >= nw
        wc = jnp.minimum(w, nw - 1)
        flat = b.astype(jnp.int64) * nw + wc
        word = jnp.take(self.occ_words.reshape(-1), flat)
        mask = jnp.where(
            rem > 0, (jnp.uint32(1) << rem) - jnp.uint32(1), jnp.uint32(0)
        )
        mask = jnp.where(over, jnp.uint32(0xFFFFFFFF), mask)
        part = lax.population_count(word & mask).astype(jnp.int64)
        return jnp.take(self.occ_cum.reshape(-1), flat) + part

    def lf_step(self, lo, hi, b):
        """One backward-search step: prepend base b."""
        cb = jnp.take(self.counts, b.astype(jnp.int64) + 1)
        return cb + self.rank(b, lo), cb + self.rank(b, hi)

    def lf_row(self, row):
        """LF mapping of a single BWT row (for locate walks)."""
        is_sent = row == self.sentinel_pos
        # bwt char at row: which base's occ bit is set
        nw = self.occ_words.shape[1]
        w = (row >> 5).astype(jnp.int64)
        bit = (row & 31).astype(jnp.uint32)
        chars = jnp.full(row.shape, -1, jnp.int64)
        for b in range(4):
            word = jnp.take(self.occ_words[b], w)
            has = ((word >> bit) & jnp.uint32(1)).astype(bool)
            chars = jnp.where(has, b, chars)
        b = jnp.maximum(chars, 0)
        nxt = jnp.take(self.counts, b + 1) + self.rank(b, row)
        return jnp.where(is_sent | (chars < 0), 0, nxt), chars


jax.tree_util.register_pytree_node(
    _BwtDevice, _BwtDevice.tree_flatten, _BwtDevice.tree_unflatten
)


@jax.jit
def _bwt_find_jit(d, seqs, lengths):
    B, L = seqs.shape
    lo = jnp.zeros((B,), jnp.int64)
    hi = jnp.full((B,), d.n, jnp.int64)

    def step(i, state):
        lo, hi = state
        pos = lengths - 1 - i
        active = (pos >= 0) & (lo < hi)
        b = jnp.take_along_axis(
            seqs, jnp.maximum(pos, 0).astype(jnp.int64)[:, None], axis=1
        )[:, 0].astype(jnp.int32)
        nlo, nhi = d.lf_step(lo, hi, b)
        return jnp.where(active, nlo, lo), jnp.where(active, nhi, hi)

    lo, hi = lax.fori_loop(0, L, step, (lo, hi))
    return lo, hi


@jax.jit
def _bwt_locate_jit(d, rows):
    """Walk each row backward via LF until a sampled SA row (or the row whose
    BWT char is the sentinel, i.e. SA == 0); position = sample + steps."""
    steps = jnp.zeros(rows.shape, jnp.int64)
    cur = rows
    sent = jnp.zeros(rows.shape, bool)

    def cond(state):
        cur, steps, done, sent = state
        return jnp.any(~done)

    def body(state):
        cur, steps, done, sent = state
        sampled = (cur % d.sa_rate) == 0
        nxt, chars = d.lf_row(cur)
        # BWT char '$' at cur means SA[cur] == 0: position is just `steps`
        is_sent = (~done) & (~sampled) & (chars < 0)
        move = (~done) & (~sampled) & (~is_sent)
        cur2 = jnp.where(move, nxt, cur)
        steps2 = jnp.where(move, steps + 1, steps)
        done2 = done | sampled | is_sent
        return cur2, steps2, done2, sent | is_sent

    done0 = (cur % d.sa_rate) == 0
    cur, steps, _, sent = lax.while_loop(cond, body, (cur, steps, done0, sent))
    base = jnp.take(d.sa_sample, cur // d.sa_rate)
    return jnp.where(sent, steps, base + steps)
