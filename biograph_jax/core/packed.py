"""Packed integer vectors and 1:many index maps.

Counterparts of the reference's packed_varbit_vector / sparse_multi / prefix_sum
(modules/io/packed_varbit_vector.h, modules/io/sparse_multi.h:20,
modules/io/prefix_sum.h).  On the device the natural representations are plain typed
arrays (XLA has no sub-byte arithmetic win for gathers) plus CSR offset arrays;
"varbit" packing is applied only at rest (in the artifact container) by
choosing the smallest integer dtype that fits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp


def smallest_uint_dtype(max_value: int):
    for dt in (np.uint8, np.uint16, np.uint32):
        if max_value <= np.iinfo(dt).max:
            return dt
    return np.uint64


@dataclass
class SparseMulti:
    """1:many mapping from a sparse domain [0, n) to dense ids [0, total).

    Reference sparse_multi (modules/io/sparse_multi.h:20) maps seqset entries
    to read ids.  CSR layout: ``offsets`` int64[n+1]; entry i owns dense range
    [offsets[i], offsets[i+1]).  ``values`` optionally stores the dense
    payload ordering.
    """

    offsets: np.ndarray  # int64 [n+1]
    values: np.ndarray  # int64 [total] — dense ids in entry order

    @staticmethod
    def from_pairs(keys: np.ndarray, values: np.ndarray, n: int) -> "SparseMulti":
        """Build from (key, value) pairs; keys in [0, n)."""
        keys = np.asarray(keys, dtype=np.int64)
        values = np.asarray(values, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        values = values[order]
        counts = np.bincount(keys, minlength=n)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return SparseMulti(offsets=offsets, values=values)

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    @property
    def total(self) -> int:
        return int(self.offsets[-1])

    def lookup_range(self, i):
        """Batched: dense [start, end) range for sparse index i."""
        xp = jnp if isinstance(i, jnp.ndarray) else np
        off = xp.asarray(self.offsets)
        return xp.take(off, i), xp.take(off, i + 1)

    def reverse_lookup(self, dense_ids):
        """Batched: sparse index owning each dense id (searchsorted)."""
        xp = jnp if isinstance(dense_ids, jnp.ndarray) else np
        off = xp.asarray(self.offsets)
        return xp.searchsorted(off, xp.asarray(dense_ids), side="right") - 1


def exclusive_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x) + 1, dtype=np.int64)
    np.cumsum(x, out=out[1:])
    return out
