"""Device-wide lexicographic sorting of packed DNA sequences.

This is the device-native replacement for the reference's external merge sorts:
the build_seqset ``expander`` (modules/build_seqset/expand.h:9) and the mapred
kv sort machinery (modules/mapred/kv_sort.h, sorter.h) both reduce to
multi-operand ``jax.lax.sort`` over 2-bit packed words with a length tiebreak,
which XLA lowers to an efficient on-device sort.

Sequence keys are (word_0, ..., word_{W-1}, length): zero padding makes
unsigned word comparison lexicographic, and the ascending length tiebreak
yields exact "prefix-first" order (see biograph_jax.core.dna).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def sort_sequences_device(
    words: jnp.ndarray,
    lengths: jnp.ndarray,
    payloads: Sequence[jnp.ndarray] = (),
) -> Tuple[jnp.ndarray, jnp.ndarray, Tuple[jnp.ndarray, ...]]:
    """Sort rows of [N, W] packed words in prefix-first lexicographic order.

    Returns (sorted_words, sorted_lengths, sorted_payloads).
    """
    return _sort_rows(words, lengths, tuple(payloads))


@jax.jit
def _sort_rows(words, lengths, payloads):
    # one program: the column split and restack fuse around the sort
    # instead of materializing as separate [N] copies
    N, W = words.shape
    ops = tuple(words[:, i] for i in range(W)) + (lengths,) + payloads
    out = lax.sort(ops, num_keys=W + 1, is_stable=True)
    sw = jnp.stack(out[:W], axis=1)
    return sw, out[W], tuple(out[W + 1 :])


def sort_sequences_np(
    words: np.ndarray, lengths: np.ndarray
) -> np.ndarray:
    """Host argsort in the same order (np.lexsort keys are last-major)."""
    keys = [np.asarray(lengths)]
    for i in range(words.shape[1] - 1, -1, -1):
        keys.append(words[:, i])
    return np.lexsort(keys)


def rows_equal(words: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """adjacent-duplicate mask: out[i] = row i equals row i-1 (out[0]=False)."""
    xp = jnp if isinstance(words, jnp.ndarray) else np
    eq = xp.all(words[1:] == words[:-1], axis=1) & (lengths[1:] == lengths[:-1])
    return xp.concatenate([xp.zeros((1,), bool), eq])


def is_prefix_of_next(
    words, lengths
) -> "np.ndarray":
    """mask[i] = row i is a (non-strict) prefix of row i+1 (mask[-1]=False).

    Requires sorted order.  Row i is a prefix of row i+1 iff
    lengths[i] <= lengths[i+1] and the first lengths[i] bases agree; with
    zero padding that's a masked word comparison.
    """
    from biograph_jax.core.dna import prefix_mask_words

    xp = jnp if isinstance(words, jnp.ndarray) else np
    W = words.shape[1]
    mask = prefix_mask_words(lengths[:-1], W, xp=xp)
    pref = xp.all((words[1:] & mask) == words[:-1], axis=1) & (
        lengths[:-1] <= lengths[1:]
    )
    return xp.concatenate([pref, xp.zeros((1,), bool)])


# the device form as one fused program: op by op, the [N, W] word masks
# (64-bit under x64) would each be materialized in device memory
is_prefix_of_next_dev = jax.jit(is_prefix_of_next)


def lcp_with_prev(words, lengths):
    """Longest common prefix (in bases) of each row with the previous row.

    Vectorized: per-word XOR, locate first differing word, count leading
    zero *bases* there.  lcp[0] = 0.
    """
    xp = jnp if isinstance(words, jnp.ndarray) else np
    N, W = words.shape
    if N == 0:
        return xp.zeros((0,), xp.int32)
    x = words[1:] ^ words[:-1]  # [N-1, W]
    nz = x != 0
    any_nz = nz.any(axis=1)
    first_nz = xp.where(any_nz, xp.argmax(nz, axis=1), W)
    diff_word = xp.take_along_axis(
        x, xp.minimum(first_nz, W - 1)[:, None].astype(xp.int64), axis=1
    )[:, 0]
    lead_bases = _clz32(diff_word, xp) >> 1  # 2 bits per base
    lcp = xp.where(
        any_nz,
        first_nz * 16 + lead_bases,
        xp.minimum(lengths[1:], lengths[:-1]),
    )
    lcp = xp.minimum(lcp, xp.minimum(lengths[1:], lengths[:-1]))
    return xp.concatenate([xp.zeros((1,), lcp.dtype), lcp]).astype(xp.int32)


def _clz32(x, xp):
    """Count leading zeros of uint32 (x==0 -> 32), branch-free."""
    x = x.astype(xp.uint32)
    n = xp.zeros(x.shape, xp.int32)
    for shift in (16, 8, 4, 2, 1):
        hi = x >> xp.uint32(shift)
        use = hi != 0
        n = xp.where(use, n, n + shift)
        x = xp.where(use, hi, x)
    return xp.where(x == 0, n + 1, n)  # after loop x in {0,1}


def merge_lower_bound(
    entry_words: jnp.ndarray,
    entry_lengths: jnp.ndarray,
    query_words: jnp.ndarray,
    query_lengths: jnp.ndarray,
) -> jnp.ndarray:
    """For each query sequence, the index of the first entry >= it.

    Entries must be sorted (prefix-first order).  Implemented as one combined
    device sort with an entry/query tag as the final tiebreak — the rank of
    entries preceding each query in the merged order is exactly lower_bound.
    This is the batch counterpart of the reference's per-sequence backward
    search in make_readmap (modules/bio_mapred/make_readmap.cpp) and of the
    prev-bit construction in build_seqset's builder (builder.h:18-31).
    """
    Ne, W = entry_words.shape
    Nq = query_words.shape[0]
    words = jnp.concatenate([entry_words, query_words], axis=0)
    lengths = jnp.concatenate(
        [entry_lengths.astype(jnp.int32), query_lengths.astype(jnp.int32)]
    )
    # Queries must sort BEFORE an equal entry so an exact match is not counted
    # in its own lower bound: tag query=0, entry=1.
    tag = jnp.concatenate([jnp.ones(Ne, jnp.int32), jnp.zeros(Nq, jnp.int32)])
    # Entries carry an out-of-bounds payload index (Nq) so the scatter below
    # drops them (negative indices would wrap, not drop).
    payload = jnp.concatenate(
        [jnp.full(Ne, Nq, jnp.int64), jnp.arange(Nq, dtype=jnp.int64)]
    )
    ops = tuple(words[:, i] for i in range(W)) + (lengths, tag, payload)
    out = lax.sort(ops, num_keys=W + 2, is_stable=True)
    stag = out[W + 1]
    spayload = out[W + 2]
    # number of entries strictly before position p in merged order
    entries_before = jnp.cumsum(stag) - stag
    lb = jnp.zeros(Nq, jnp.int64)
    lb = lb.at[spayload].set(entries_before.astype(jnp.int64), mode="drop")
    return lb
