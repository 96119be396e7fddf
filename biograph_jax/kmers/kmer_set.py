"""Trusted k-mer set with batched membership lookup.

Counterpart of the reference kmer_set (modules/bio_mapred/kmer_set.h:14):
a sorted table of canonical k-mers supporting flip-aware lookups.  On the device,
membership tests are batched binary searches (jnp.searchsorted) over the
sorted uint64 table — thousands of probes per dispatch.

Filtering mirrors kmerize_bf's kmer_passes (modules/bio_mapred/
kmerize_bf.cpp:288-335) exactly: BELOW_MIN_COUNT, SKEWED (fwd/rev
strand-skew prior test), and NEAR_OVERREP — k-mers one base substitution
away from an overrepresented k-mer (modules/bio_base/overrep.h find_near)
whose strand counts sit under the random/systematic error thresholds.
Where the reference probes a half-indexed hash per k-mer, this build
enumerates the (few) overrep k-mers' Hamming-1 neighborhoods once and
answers every query with one batched searchsorted.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from biograph_jax.core import dna
from biograph_jax.kmers.count import KmerCounts


def _hamming1_neighbors(kmers: np.ndarray, k: int) -> np.ndarray:
    """All 3k single-base substitutions of each kmer (uint64 [n, 3k])."""
    kmers = np.asarray(kmers, np.uint64)
    n = len(kmers)
    out = np.empty((n, 3 * k), np.uint64)
    col = 0
    for pos in range(k):
        shift = np.uint64(2 * pos)
        cur = (kmers >> shift) & np.uint64(3)
        for delta in (1, 2, 3):
            nb = (cur + np.uint64(delta)) & np.uint64(3)
            out[:, col] = (kmers & ~(np.uint64(3) << shift)) | (nb << shift)
            col += 1
    return out


def filter_kmer_counts(
    counts: KmerCounts,
    min_count: int = 2,
    max_count: int | None = None,
    prior_count: int = 5,
    skew_cutoff: float = 0.0,
    overrep_threshold: int = 0,
    sys_err_thresh: float = 0.1,
    rnd_err_thresh: float = 0.005,
):
    """kmer_passes analog (kmerize_bf.cpp:290-322).  Returns (keep bool [n],
    stats dict with per-filter-result counts)."""
    fwd = np.asarray(counts.fwd, np.int64)
    rev = np.asarray(counts.rev, np.int64)
    tot = fwd + rev
    below = tot < min_count
    if max_count is not None:
        below |= tot > max_count
    low = (np.minimum(fwd, rev) + prior_count) / (tot + 2 * prior_count)
    skewed = ~below & (low < skew_cutoff)
    near = np.zeros(len(tot), bool)
    n_overrep = 0
    if overrep_threshold:
        ov_mask = tot >= overrep_threshold
        n_overrep = int(ov_mask.sum())
        if n_overrep:
            ov_k = np.asarray(counts.kmers[ov_mask], np.uint64)
            ov_c = tot[ov_mask]
            # find_near checks hamming(k, O) == 1 for k AND revcomp(k); the
            # latter equals hamming(k, revcomp(O)) == 1, so the neighbor
            # table covers each overrep kmer and its reverse complement
            ov_rc = np.asarray(dna.revcomp_kmer(jnp.asarray(ov_k), counts.k))
            nbrs = np.concatenate(
                [
                    _hamming1_neighbors(ov_k, counts.k),
                    _hamming1_neighbors(ov_rc, counts.k),
                ],
                axis=1,
            )  # [n_ov, 6k]
            cnts = np.broadcast_to(ov_c[:, None], nbrs.shape)
            flat = nbrs.reshape(-1)
            flatc = cnts.reshape(-1)
            # max overrep count per distinct neighbor (find_near keeps max)
            order = np.lexsort((-flatc, flat))
            flat, flatc = flat[order], flatc[order]
            first = np.concatenate([[True], flat[1:] != flat[:-1]])
            tab_k, tab_c = flat[first], flatc[first]
            q = np.asarray(counts.kmers, np.uint64)
            lo = np.searchsorted(tab_k, q)
            loc = np.clip(lo, 0, len(tab_k) - 1)
            hit = (lo < len(tab_k)) & (tab_k[loc] == q)
            o_count = np.where(hit, tab_c[loc], 0)
            min_c = np.minimum(fwd, rev)
            max_c = np.maximum(fwd, rev)
            near = (
                hit
                & ~below
                & ~skewed
                & (min_c < o_count * rnd_err_thresh)
                & (max_c < o_count * sys_err_thresh)
            )
    keep = ~(below | skewed | near)
    stats = {
        "PASSED": int(keep.sum()),
        "BELOW_MIN_COUNT": int(below.sum()),
        "SKEWED": int(skewed.sum()),
        "NEAR_OVERREP": int(near.sum()),
        "OVERREP": n_overrep,
    }
    return keep, stats


@dataclass(frozen=True)
class KmerSet:
    k: int
    kmers: jnp.ndarray  # uint64 [n] sorted canonical k-mers

    @staticmethod
    def from_counts(
        counts: KmerCounts,
        min_count: int = 2,
        max_count: int | None = None,
        stats_out: dict | None = None,
        **filter_kw,
    ) -> "KmerSet":
        keep, stats = filter_kmer_counts(
            counts, min_count=min_count, max_count=max_count, **filter_kw
        )
        if stats_out is not None:
            stats_out.update(stats)
        return KmerSet(k=counts.k, kmers=jnp.asarray(counts.kmers[keep]))

    @property
    def size(self) -> int:
        return int(self.kmers.shape[0])

    def contains(self, query_kmers) -> jnp.ndarray:
        """Batched membership of *raw* k-mers (canonicalized internally)."""
        q = jnp.asarray(query_kmers, jnp.uint64)
        canon, _ = dna.canonicalize_kmers(q, self.k)
        return self.contains_canonical(canon)

    def contains_canonical(self, canon) -> jnp.ndarray:
        canon = jnp.asarray(canon, jnp.uint64)
        n = self.kmers.shape[0]
        if n == 0:
            return jnp.zeros(canon.shape, bool)
        lo = jnp.searchsorted(self.kmers, canon)
        loc = jnp.clip(lo, 0, n - 1)
        return (lo < n) & (jnp.take(self.kmers, loc) == canon)

    def save_arrays(self):
        return {"kmers": np.asarray(self.kmers), "k": self.k}
