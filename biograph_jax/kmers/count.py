"""Device k-mer counting: rolling encode → sort → segmented reduce.

Device-native counterpart of the reference's two k-mer counting paths:
  * the kmerize_reads map/sort/reduce pipeline
    (modules/bio_mapred/kmerize_reads_mapper.cpp:86-140 — canonical k-mer,
    (fwd, rev) count pair split by orientation), and
  * the build_seqset two-stage probabilistic/exact kmer_counter
    (modules/build_seqset/kmer_counter.h:123).

Instead of hash tables, counting is one device sort of the canonical k-mer
keys plus a segmented sum — deterministic, collision-free, and
sharding-friendly (k-mer space splits by leading bits across devices; each
shard sorts/reduces locally after an all-to-all by prefix).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from biograph_jax.core import dna


@dataclass
class KmerCounts:
    """Sorted unique canonical k-mers with per-orientation counts."""

    k: int
    kmers: np.ndarray  # uint64 [U], ascending
    fwd: np.ndarray  # int64 [U]
    rev: np.ndarray  # int64 [U]

    @property
    def total(self) -> np.ndarray:
        return self.fwd + self.rev

    def write_text(self, path: str):
        """Reference-compatible dump: 'SEQ\\tfwd\\trev' per line, sorted
        (format: modules/bio_format/kmer_count.cpp kmer_count_exporter)."""
        ks = self.kmers.astype(np.uint64)
        seqs = _kmers_to_text(ks, self.k)
        with open(path, "wb") as f:
            for s, fw, rv in zip(seqs, self.fwd, self.rev):
                f.write(b"%s\t%d\t%d\n" % (s, fw, rv))


def _kmers_to_text(kmers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized uint64 k-mers -> bytes rows."""
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    codes = ((kmers[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    ascii_rows = dna.decode_to_ascii(codes)
    return [row.tobytes() for row in ascii_rows]


def count_kmers_device(
    codes: jnp.ndarray, lengths: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Jit-friendly core: returns (unique_kmers[U?], fwd[U?], rev[U?], n_unique)
    padded to the full kmer count; entries past n_unique are the max key.
    """
    kmers, valid = dna.kmers_from_codes(codes, lengths, k)
    canon, is_fwd = dna.canonicalize_kmers(kmers, k)
    flat = canon.reshape(-1)
    fwd_flag = (is_fwd & valid).reshape(-1).astype(jnp.int64)
    rev_flag = ((~is_fwd) & valid).reshape(-1).astype(jnp.int64)
    # Push invalid (padding) kmers to the end with the max key.
    sentinel = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    keys = jnp.where(valid.reshape(-1), flat, sentinel)
    keys, fwd_flag, rev_flag = lax.sort(
        (keys, fwd_flag, rev_flag), num_keys=1, is_stable=False
    )
    n_valid = jnp.sum(valid)
    # Segment boundaries
    is_new = jnp.concatenate(
        [jnp.ones((1,), bool), keys[1:] != keys[:-1]]
    )
    seg_ids = jnp.cumsum(is_new.astype(jnp.int64)) - 1
    n = keys.shape[0]
    fwd_sum = jnp.zeros(n, jnp.int64).at[seg_ids].add(fwd_flag)
    rev_sum = jnp.zeros(n, jnp.int64).at[seg_ids].add(rev_flag)
    # Compact unique keys to the front (stable sort by is_new descending).
    order_key = (~is_new).astype(jnp.int32)
    _, uk, uf, ur = lax.sort(
        (order_key, keys, jnp.take(fwd_sum, seg_ids), jnp.take(rev_sum, seg_ids)),
        num_keys=1,
        is_stable=True,
    )
    # After the stable sort the first n_unique rows are the segment leaders in
    # ascending key order (stability preserves it).  But the per-row sums we
    # carried are per-segment totals gathered at every row; leaders carry the
    # right totals.
    n_unique = jnp.sum(is_new & (keys != sentinel))
    return uk, uf, ur, n_unique


def count_kmers(
    codes: np.ndarray,
    lengths: np.ndarray,
    k: int,
    include_revcomp_reads: bool = False,
    batch_rows: int = 1 << 17,
) -> KmerCounts:
    """Count canonical k-mers of a read set (host driver, device compute).

    include_revcomp_reads=False matches the kmerize_reads pipeline (each read
    counted once in its stored orientation).
    """
    if codes.shape[0] == 0 or codes.shape[1] < k:
        # no read wide enough to hold a single k-mer (e.g. aggressive
        # --cut-reads): an empty count, not a zero-size device scatter
        return KmerCounts(k, np.zeros(0, np.uint64), np.zeros(0, np.int64), np.zeros(0, np.int64))
    parts = []
    for lo in range(0, codes.shape[0], batch_rows):
        hi = min(lo + batch_rows, codes.shape[0])
        uk, uf, ur, nu = _count_jit(jnp.asarray(codes[lo:hi]), jnp.asarray(lengths[lo:hi]), k)
        nu = int(nu)
        parts.append(
            (np.asarray(uk[:nu]), np.asarray(uf[:nu]), np.asarray(ur[:nu]))
        )
    if len(parts) == 1:
        uk, uf, ur = parts[0]
    else:
        uk = np.concatenate([p[0] for p in parts])
        uf = np.concatenate([p[1] for p in parts])
        ur = np.concatenate([p[2] for p in parts])
        order = np.argsort(uk, kind="stable")
        uk, uf, ur = uk[order], uf[order], ur[order]
        isnew = np.concatenate([[True], uk[1:] != uk[:-1]])
        seg = np.cumsum(isnew) - 1
        n_u = int(seg[-1]) + 1
        fwd = np.zeros(n_u, np.int64)
        rev = np.zeros(n_u, np.int64)
        np.add.at(fwd, seg, uf)
        np.add.at(rev, seg, ur)
        uk, uf, ur = uk[isnew], fwd, rev
    return KmerCounts(k=k, kmers=uk, fwd=uf, rev=ur)


from functools import partial

_count_jit = jax.jit(count_kmers_device, static_argnums=2)
