"""Succinct rank/select bitvector, batched for the device.

Device-batched counterpart of the reference's ``bitcount`` (modules/io/bitcount.h:13):
O(1) rank ("count") and select ("find_count").  Layout:

  * ``words``  — uint32[ceil(n/32)], bit i of word w = position 32*w + i
  * ``cum``    — int64[nwords], exclusive prefix popcount per word

Rank is a two-gather + popcount operation, vectorized over arbitrarily many
query positions at once (the reference answers one rank per call;
seqset tracing on the device advances thousands of frontiers per step).

Select is served from an explicit sorted positions array (``ones``): for the
seqset's pop_front this doubles as the reference's pop_front cache
(modules/bio_base/seqset.h:176-186, 8B/entry vs the reference's 5B/entry).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp
from jax import lax


@dataclass
class RankBits:
    """Immutable rank-queryable bitvector."""

    n: int  # number of bits
    words: np.ndarray  # uint32 [ceil(n/32)+1]  (one pad word so rank(n) works)
    cum: np.ndarray  # int64  [ceil(n/32)+1] exclusive prefix popcounts
    total: int  # total set bits

    @staticmethod
    def from_bools(bits: np.ndarray) -> "RankBits":
        bits = np.asarray(bits, dtype=bool)
        n = bits.shape[0]
        nw = n // 32 + 1
        pad = np.zeros(nw * 32, dtype=bool)
        pad[:n] = bits
        words = np.packbits(pad.reshape(nw, 32), axis=1, bitorder="little").view(
            np.uint32
        )
        words = words.reshape(nw)
        pc = popcount_np(words)
        cum = np.zeros(nw, dtype=np.int64)
        np.cumsum(pc[:-1], out=cum[1:])
        return RankBits(n=n, words=words, cum=cum, total=int(pc.sum()))

    @staticmethod
    def from_positions(pos: np.ndarray, n: int) -> "RankBits":
        bits = np.zeros(n, dtype=bool)
        bits[np.asarray(pos, dtype=np.int64)] = True
        return RankBits.from_bools(bits)

    def get(self, i):
        """Batched bit test."""
        xp = jnp if isinstance(i, jnp.ndarray) else np
        words = xp.asarray(self.words)
        i = xp.asarray(i)
        w = xp.take(words, (i >> 5).astype(xp.int64))
        return ((w >> (i & 31).astype(xp.uint32)) & 1).astype(bool)

    def rank(self, i):
        """Batched rank: number of set bits in [0, i).  i may be 0..n."""
        return rank_query(
            jnp.asarray(self.words), jnp.asarray(self.cum), jnp.asarray(i)
        )

    def rank_np(self, i):
        i = np.asarray(i, dtype=np.int64)
        w = i >> 5
        rem = (i & 31).astype(np.uint32)
        word = self.words[w]
        masked = np.where(rem > 0, word & ((np.uint32(1) << rem) - 1), 0).astype(
            np.uint32
        )
        return self.cum[w] + popcount_np(masked)

    def ones_positions(self) -> np.ndarray:
        """Sorted positions of set bits (the select table)."""
        bits = np.zeros(len(self.words) * 32, dtype=np.uint8)
        for b in range(32):
            bits[b::32] = (self.words >> np.uint32(b)) & 1
        return np.nonzero(bits[: self.n])[0].astype(np.int64)


def popcount_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    return np.unpackbits(x.view(np.uint8)).reshape(x.shape + (-1,)).sum(
        axis=-1, dtype=np.int64
    )


def rank_cum(words: jnp.ndarray) -> jnp.ndarray:
    """Exclusive prefix popcount per word along the last axis (int64): the
    rank acceleration table (the finalize of the reference's bitcount,
    modules/io/bitcount.cpp).  XLA fuses the popcount into the scan."""
    pc = lax.population_count(words).astype(jnp.int64)
    return jnp.cumsum(pc, axis=-1) - pc


def rank_query(words: jnp.ndarray, cum: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    """Vectorized rank over any index array (device path).

    words: uint32[nw]; cum: int64[nw]; i: int array [...] in [0, n].
    """
    i = jnp.asarray(i)
    w = (i >> 5).astype(jnp.int64)
    rem = (i & 31).astype(jnp.uint32)
    word = jnp.take(words, w)
    mask = jnp.where(
        rem > 0,
        (jnp.uint32(1) << rem) - jnp.uint32(1),
        jnp.uint32(0),
    )
    part = lax.population_count(word & mask).astype(jnp.int64)
    return jnp.take(cum, w) + part
