"""Batched seed-and-verify read placement against the reference.

Device-batched replacement for the reference's legacy alignment path
(modules/bio_mapred/align_kmer.cpp, modules/bio_base/align_astar.h used by
the pileup pipeline): every read is seeded by exact k-mer lookups into a
sorted reference k-mer table, then *all* candidate placements for *all* reads
are verified in one vectorized mismatch count — no per-read control flow.

The same placement engine backs the pileup caller (variants/pileup.py) and
read-support checks in discovery.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from biograph_jax.core import dna


@dataclass(frozen=True)
class RefKmerIndex:
    """Sorted k-mer table over the reference (analog of the reference BWT /
    kmer_set lookup, modules/bio_base/bwt_file.h:22, bio_mapred/kmer_set.h:14).

    Layout notes: with k <= 16 the table is uint32 and positions int32
    (half the gather traffic of 64-bit); the genome is additionally stored as
    16 *phase-shifted* 2-bit packings (``ref_phases[p][w]`` = bases
    16*w+p .. 16*w+p+15), so a read window at any position is 3 aligned word
    gathers + XOR + popcount instead of per-base byte gathers."""

    k: int
    kmers: jnp.ndarray  # uint32 (k<=16) or uint64 [n] ascending
    positions: jnp.ndarray  # int32/int64 [n] start position of each k-mer
    ref_codes: jnp.ndarray  # uint8 [G]
    ref_len: int
    ref_phases: jnp.ndarray | None = None  # uint32 [16, nw]
    # direct-address table (k <= 13): bucket offsets into positions, one
    # gather per lookup instead of a log(n)-step binary search
    direct_off: jnp.ndarray | None = None  # int32 [4^k + 1]

    @staticmethod
    def build(
        ref_codes: np.ndarray,
        k: int,
        is_n: np.ndarray | None = None,
        use_direct: bool = False,
    ) -> "RefKmerIndex":
        ref = jnp.asarray(np.asarray(ref_codes, np.uint8))[None, :]
        G = ref.shape[1]
        kmers, valid = dna.kmers_from_codes(ref, jnp.asarray([G]), k)
        kmers = kmers[0]
        valid = valid[0]
        if is_n is not None:
            # k-mers touching N positions are not seedable
            isn = np.asarray(is_n, bool)
            bad = np.convolve(isn.astype(np.int32), np.ones(k, np.int32))[k - 1 : len(isn)]
            valid = valid & jnp.asarray(bad == 0)
        small = k <= 16 and G < (1 << 31)
        pos_dt = jnp.int32 if small else jnp.int64
        pos = jnp.arange(kmers.shape[0], dtype=pos_dt)
        if small:
            kmers = kmers.astype(jnp.uint32)
            sentinel = jnp.uint32(0xFFFFFFFF)
        else:
            sentinel = jnp.uint64(0xFFFFFFFFFFFFFFFF)
        keys = jnp.where(valid, kmers, sentinel)
        sk, sp = lax.sort((keys, pos), num_keys=1, is_stable=True)
        n_valid = int(jnp.sum(valid))
        ref_np = np.asarray(ref_codes, np.uint8)
        direct_off = None
        # NOTE: the direct table trades a scatter/cumsum build (and its
        # memory) for the 23-step binary search, so it stays opt-in.
        if use_direct and k <= 13:
            # Build the bucket-offset table ON DEVICE (a 4^k-entry table is
            # hundreds of MB — computing it from the 4-byte/kmer sorted array
            # avoids shipping it over a slow host->device link).
            skd = sk[:n_valid].astype(jnp.int32)
            counts = (
                jnp.zeros((1 << (2 * k)) + 1, jnp.int32)
                .at[skd + 1]
                .add(1)
            )
            direct_off = jnp.cumsum(counts, dtype=jnp.int32)
        return RefKmerIndex(
            k=k,
            kmers=sk[:n_valid],
            positions=sp[:n_valid],
            ref_codes=jnp.asarray(ref_np),
            ref_len=G,
            ref_phases=jnp.asarray(_phase_packings(ref_np)),
            direct_off=direct_off,
        )

    def lookup(self, query_kmers: jnp.ndarray, max_hits: int):
        """Batched: up to max_hits reference positions per query k-mer.

        Returns (positions [..., max_hits], valid mask).  Uses the
        direct-address table when present (one gather), else binary search.
        """
        q = jnp.asarray(query_kmers)
        if self.direct_off is not None:
            qi = q.astype(jnp.int64)
            lo = jnp.take(self.direct_off, qi).astype(jnp.int64)
            hi = jnp.take(self.direct_off, qi + 1).astype(jnp.int64)
            idx = lo[..., None] + jnp.arange(max_hits, dtype=jnp.int64)
            hit = idx < hi[..., None]
            idx_c = jnp.clip(idx, 0, max(self.positions.shape[0] - 1, 0))
            pos = jnp.take(self.positions, idx_c)
            return jnp.where(hit, pos, -1), hit
        lo = jnp.searchsorted(self.kmers, q)
        idx = lo[..., None] + jnp.arange(max_hits, dtype=jnp.int64)
        idx_c = jnp.clip(idx, 0, max(self.kmers.shape[0] - 1, 0))
        hit = (idx < self.kmers.shape[0]) & (jnp.take(self.kmers, idx_c) == q[..., None])
        pos = jnp.take(self.positions, idx_c)
        return jnp.where(hit, pos, -1), hit


def _phase_packings(ref_codes: np.ndarray) -> np.ndarray:
    """16 phase-shifted 2-bit packings of the genome: out[p, w] packs bases
    [16*w + p, 16*w + p + 16).  Memory = 4x genome bytes."""
    G = len(ref_codes)
    nw = G // 16 + 2
    out = np.zeros((16, nw), np.uint32)
    padded = np.zeros(nw * 16 + 16, np.uint8)
    padded[:G] = ref_codes
    for p in range(16):
        seg = padded[p : p + nw * 16].reshape(nw, 16).astype(np.uint32)
        shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
        out[p] = (seg << shifts).sum(axis=1, dtype=np.uint32)
    return out


@dataclass
class Placements:
    """Best placement per read (both strands considered)."""

    pos: np.ndarray  # int64 [R] start in flat ref coords (-1 = unplaced)
    is_rc: np.ndarray  # bool [R] — placed as reverse complement
    mismatches: np.ndarray  # int32 [R]


def place_reads(
    index: RefKmerIndex,
    codes: np.ndarray,
    lengths: np.ndarray,
    max_mismatches: int = 5,
    seeds_per_read: int = 3,
    max_hits_per_seed: int = 8,
    batch_rows: int = 1 << 15,
) -> Placements:
    """Place each read (and its revcomp) on the reference; keep the best.

    Seeds: k-mers at evenly spaced offsets; every (seed, hit) candidate is
    verified by a full vectorized mismatch count against the reference; the
    minimum-mismatch, leftmost placement wins.
    """
    R, L = codes.shape
    out_pos = np.full(R, -1, np.int64)
    out_rc = np.zeros(R, bool)
    out_mm = np.full(R, np.iinfo(np.int32).max, np.int32)
    fn = _place_jit(index, L, int(max_mismatches), seeds_per_read, max_hits_per_seed)
    for lo in range(0, R, batch_rows):
        hi = min(R, lo + batch_rows)
        p, rc, mm = fn(jnp.asarray(codes[lo:hi]), jnp.asarray(lengths[lo:hi], jnp.int32))
        out_pos[lo:hi] = np.asarray(p)
        out_rc[lo:hi] = np.asarray(rc)
        out_mm[lo:hi] = np.asarray(mm)
    return Placements(pos=out_pos, is_rc=out_rc, mismatches=out_mm)


def _place_jit(index: RefKmerIndex, L: int, max_mm: int, n_seeds: int, max_hits: int):
    k = index.k
    W = dna.words_for_bases(L)
    small = index.kmers.dtype == jnp.uint32
    idx_dt = jnp.int32 if small else jnp.int64

    @jax.jit
    def run(codes, lengths):
        B = codes.shape[0]
        rc = dna.revcomp_codes(codes, lengths)

        def candidates(c):
            # seed offsets spread over the read
            offs = [
                jnp.clip((lengths - k) * i // max(n_seeds - 1, 1), 0, L - k).astype(
                    idx_dt
                )
                for i in range(n_seeds)
            ]
            km, _ = dna.kmers_from_codes(c, lengths, k)  # [B, L-k+1] u64
            if small:
                km = km.astype(jnp.uint32)
            nwin = km.shape[1]
            cand = []
            for off in offs:
                offc = jnp.clip(off, 0, nwin - 1)
                q = jnp.take_along_axis(km, offc[:, None].astype(jnp.int64), axis=1)[:, 0]
                pos, hit = index.lookup(q, max_hits)  # [B, H]
                start = jnp.where(hit, pos.astype(idx_dt) - offc[:, None], -1)
                cand.append(start)
            return jnp.concatenate(cand, axis=1)  # [B, n_seeds*H]

        def verify(c, starts):
            """Packed-word verify: 3 aligned u32 gathers + XOR/popcount per
            candidate instead of L byte gathers."""
            okpos = (starts >= 0) & (
                starts + lengths[:, None].astype(starts.dtype) <= index.ref_len
            )
            s = jnp.clip(starts, 0, max(index.ref_len - 1, 0)).astype(jnp.int32)
            rw = dna.pack_codes(c, lengths)  # [B, W] u32
            rmask = dna.prefix_mask_words(lengths, W, xp=jnp)  # [B, W] u32
            phases = index.ref_phases
            nw = phases.shape[1]
            flat_base = (s & 15) * nw + (s >> 4)  # [B, C]
            mm = jnp.zeros(starts.shape, jnp.int32)
            flat_ref = phases.reshape(-1)
            for i in range(W):
                wref = jnp.take(flat_ref, (flat_base + i).astype(jnp.int32), mode="clip")
                x = (wref ^ rw[:, None, i]) & rmask[:, None, i]
                mmbits = (x | (x >> jnp.uint32(1))) & jnp.uint32(0x55555555)
                mm = mm + lax.population_count(mmbits).astype(jnp.int32)
            mm = jnp.where(okpos, mm, jnp.int32(1 << 30))
            return mm

        def best(c):
            starts = candidates(c)
            mm = verify(c, starts)
            # prefer min mismatches then leftmost start; invalid lanes get a
            # max key (mind int64 overflow: compose keys within range)
            G = jnp.int64(index.ref_len + 1)
            ok = mm < jnp.int32(1 << 30)
            key = jnp.where(
                ok,
                jnp.minimum(mm, 255).astype(jnp.int64) * G
                + jnp.clip(starts, 0, G - 1),
                jnp.int64(1 << 62),
            )
            j = jnp.argmin(key, axis=1)
            bmm = jnp.take_along_axis(mm, j[:, None], axis=1)[:, 0]
            bst = jnp.take_along_axis(starts, j[:, None], axis=1)[:, 0]
            return bst, bmm

        fpos, fmm = best(codes)
        rpos, rmm = best(rc)
        use_rc = rmm < fmm
        pos = jnp.where(use_rc, rpos, fpos)
        mm = jnp.where(use_rc, rmm, fmm)
        placed = mm <= max_mm
        return jnp.where(placed, pos, -1), use_rc & placed, jnp.where(placed, mm, jnp.int32(-1))

    return run
