"""Readmap construction: batch lower-bound of oriented reads into the seqset.

Counterpart of make_readmap (modules/bio_mapred/make_readmap.h:13,
make_readmap.cpp): the reference walks each corrected read through
seqset::find_existing one at a time; here every read and reverse complement is
located with ONE merged device sort (ops.sortutil.merge_lower_bound), then the
CSR (sparse_multi), mate-loop permutation (readmap.h:216-236) and is_forward
bits are assembled with vectorized scatters.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from biograph_jax.core import dna
from biograph_jax.index.readmap import Readmap
from biograph_jax.index.seqset import Seqset
from biograph_jax.ops import sortutil


def build_readmap(
    seqset: Seqset,
    codes: np.ndarray,
    lengths: np.ndarray,
    mate_of: np.ndarray | None = None,
    entry_words: np.ndarray | None = None,
    entry_lens: np.ndarray | None = None,
    chunk_rows: int = 1 << 20,
) -> Readmap:
    """Build a readmap for reads already incorporated in ``seqset``.

    codes: uint8 [R, L] (np array or memmap — reads stream to device in
    ``chunk_rows`` batches, reverse complements computed on device per
    chunk); lengths: int32 [R]; mate_of: int64 [R] with the mate read index
    or -1 (mates must be symmetric).

    entry_words/entry_lens: packed entry sequences (kept from the build); if
    absent they are reconstructed from the seqset via pop chains.
    """
    R, L = codes.shape
    lengths = np.asarray(lengths, np.int32)
    olens = np.concatenate([lengths, lengths])

    if entry_words is None:
        cached = seqset.__dict__.get("_entry_cache")
        if cached is not None:
            entry_words, entry_lens = cached
        else:
            entry_words, entry_lens = reconstruct_entry_words(seqset)
    W = entry_words.shape[1]
    ew_dev = jnp.asarray(entry_words)
    el_dev = jnp.asarray(entry_lens)

    def locate(c_dev, l_dev):
        q = dna.pack_codes(c_dev, l_dev)
        if q.shape[1] < W:
            q = jnp.pad(q, ((0, 0), (0, W - q.shape[1])))
        elif q.shape[1] > W:
            raise ValueError("reads longer than seqset max entry length")
        return np.asarray(
            sortutil.merge_lower_bound(ew_dev, el_dev, q, l_dev), np.int64
        )

    # entry of every oriented read: fwd block then rc block, chunked so only
    # one chunk is ever device-resident
    entry_ids = np.empty(2 * R, np.int64)
    for r0 in range(0, R, chunk_rows):
        r1 = min(R, r0 + chunk_rows)
        c = jnp.asarray(np.ascontiguousarray(codes[r0:r1]))
        ln = jnp.asarray(lengths[r0:r1])
        entry_ids[r0:r1] = locate(c, ln)
        entry_ids[R + r0 : R + r1] = locate(dna.revcomp_codes(c, ln), ln)

    # readmap-entry ordering: sorted by (seqset entry, read length, oriented id)
    # — deterministic, CSR-compatible.
    oriented_id = np.arange(2 * R, dtype=np.int64)
    order = np.lexsort((oriented_id, olens, entry_ids))
    entry_sorted = entry_ids[order]
    n = seqset.n_entries
    counts = np.bincount(entry_sorted, minlength=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])

    # rm index of each oriented read
    rm_of_oriented = np.empty(2 * R, np.int64)
    rm_of_oriented[order] = np.arange(2 * R)

    read_ids = order % R  # original read index of each readmap entry
    is_forward = order < R
    read_lengths = olens[order]

    # mate loop: fwd -> rc -> mate_fwd -> mate_rc -> fwd; unpaired: fwd -> rc -> fwd
    if mate_of is None:
        mate_of = np.full(R, -1, np.int64)
    mate_of = np.asarray(mate_of, np.int64)
    fwd_rm = rm_of_oriented[:R]
    rc_rm = rm_of_oriented[R:]
    loop = np.empty(2 * R, np.int64)
    paired = mate_of >= 0
    # fwd -> rc (always)
    loop[fwd_rm] = rc_rm
    # rc -> mate fwd (paired) or back to fwd (unpaired)
    loop[rc_rm[paired]] = fwd_rm[mate_of[paired]]
    loop[rc_rm[~paired]] = fwd_rm[~paired]

    return Readmap(
        seqset=seqset,
        offsets=offsets,
        read_lengths=np.asarray(read_lengths, np.int32),
        is_forward=is_forward,
        mate_pair_ptr=loop,
        read_ids=read_ids,
    )


def reconstruct_entry_words(seqset: Seqset, chunk: int = 1 << 18):
    """Recover packed entry sequences from the seqset via pop chains."""
    n = seqset.n_entries
    L = seqset.max_entry_len
    outs = []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        codes = seqset.d.sequences(jnp.arange(lo, hi, dtype=jnp.int64), L)
        lens = jnp.asarray(seqset.entry_sizes[lo:hi], jnp.int32)
        outs.append(np.asarray(dna.pack_codes(codes, lens)))
    words = np.concatenate(outs, axis=0) if outs else np.zeros((0, 1), np.uint32)
    return jnp.asarray(words), jnp.asarray(np.asarray(seqset.entry_sizes, np.int32))
