"""Fused 4-way rank queries: the seqset's hot gather.

The reference answers one rank query at a time by pointer-chasing its
bitcount accel tables (modules/io/bitcount.h:13 count(), used by
seqset_range::push_front at modules/bio_base/seqset.cpp:319-338).  Here a
*batch* of positions is answered for all four bases at once:

    rank_b(pos) = cum[b, pos>>5] + popcount(words[b, pos>>5] & mask(pos&31))

Each query reads one 32-bit word and one 64-bit cumulative count per base
(48 bytes for the four bases); XLA lowers the gathers to plain device-memory
loads, which the GPU's caches serve without any table packing.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# bytes one rank4 query reads: 4 bases x (uint32 word + int64 cum)
BYTES_PER_QUERY = 4 * (4 + 8)


def rank4_xla(prev_words, prev_cum, pos):
    """All-4-bases rank at each position: int32 [B, 4].

    prev_words: uint32 [4, nw]; prev_cum: int64 [4, nw] exclusive prefix
    popcounts; pos: int [B] in [0, 32 * nw]."""
    pos = jnp.asarray(pos)
    nw = prev_words.shape[1]
    w = (pos >> 5).astype(jnp.int64)
    rem = (pos & 31).astype(jnp.uint32)
    # pos == 32*nw (an end position when n_entries % 32 == 0) reads the last
    # word fully instead of indexing past the structure
    over = w >= nw
    wc = jnp.minimum(w, nw - 1)
    mask = jnp.where(
        rem > 0, (jnp.uint32(1) << rem) - jnp.uint32(1), jnp.uint32(0)
    )
    mask = jnp.where(over, jnp.uint32(0xFFFFFFFF), mask)
    outs = []
    flat_w = prev_words.reshape(-1)
    flat_c = prev_cum.reshape(-1)
    for b in range(4):
        word = jnp.take(flat_w, b * nw + wc)
        part = lax.population_count(word & mask).astype(jnp.int64)
        outs.append(jnp.take(flat_c, b * nw + wc) + part)
    return jnp.stack(outs, axis=1).astype(jnp.int32)
