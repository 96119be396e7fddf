"""Pileup SNP caller: placed reads -> per-base counts -> calls.

Counterpart of the reference's legacy pileup variant path
(modules/bio_base/pileup.h, bio_mapred/read_pileup_reducer.cpp; output format
matching golden/final.vcf: per-base depths DP_A..DP_T, QUAL = 3*DP_alt + 27,
AC = alt depth, GT from allele fraction).

The pileup itself is a single device scatter-add over all placed read bases —
the natural device formulation of "pile up the reads".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from biograph_jax.core import dna
from biograph_jax.index.reference import Reference
from biograph_jax.io.vcf import VcfRecord, VcfWriter
from biograph_jax.variants.align import Placements, RefKmerIndex, place_reads


def pileup_counts(
    ref_len: int,
    codes: np.ndarray,
    lengths: np.ndarray,
    pl: Placements,
    batch_rows: int = 1 << 15,
) -> np.ndarray:
    """Per-position per-base depths [4, ref_len] via device scatter-add."""
    counts = jnp.zeros((4, ref_len), jnp.int32)
    R, L = codes.shape

    @jax.jit
    def add(counts, c, ln, pos, is_rc):
        oriented = jnp.where(is_rc[:, None], dna.revcomp_codes(c, ln), c)
        offs = jnp.arange(L, dtype=jnp.int64)
        tgt = pos[:, None] + offs[None, :]
        valid = (pos[:, None] >= 0) & (offs[None, :] < ln[:, None]) & (
            tgt < ref_len
        )
        tgt_c = jnp.clip(tgt, 0, ref_len - 1)
        flat = oriented.astype(jnp.int64) * ref_len + tgt_c
        upd = jnp.zeros((4 * ref_len,), jnp.int32).at[
            jnp.where(valid, flat, 0)
        ].add(jnp.where(valid, 1, 0))
        return counts + upd.reshape(4, ref_len)

    for lo in range(0, R, batch_rows):
        hi = min(R, lo + batch_rows)
        counts = add(
            counts,
            jnp.asarray(codes[lo:hi]),
            jnp.asarray(lengths[lo:hi], jnp.int32),
            jnp.asarray(pl.pos[lo:hi]),
            jnp.asarray(pl.is_rc[lo:hi]),
        )
    return np.asarray(counts)


@dataclass
class PileupCall:
    flat_pos: int  # 0-based flat reference coordinate
    ref_base: int
    alt_base: int
    depth: int
    alt_depth: int
    genotype: str


def call_snps(
    ref_codes: np.ndarray,
    counts: np.ndarray,
    min_depth: int = 8,
    hom_frac: float = 0.8,
    het_frac: float = 0.25,
) -> List[PileupCall]:
    """Vectorized SNP calls from the pileup matrix.

    Emission rules shaped to the legacy caller behind golden/final.vcf:
    dominant non-reference base with depth >= min_depth; genotype 1/1 at
    >= hom_frac allele fraction, 0/1 between het_frac and hom_frac.
    """
    ref_codes = np.asarray(ref_codes, np.int64)
    depth = counts.sum(axis=0)
    G = len(ref_codes)
    ref_cnt = counts[ref_codes, np.arange(G)]
    nonref = counts.copy()
    nonref[ref_codes, np.arange(G)] = -1
    alt_base = nonref.argmax(axis=0)
    alt_cnt = nonref[alt_base, np.arange(G)]
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(depth > 0, alt_cnt / np.maximum(depth, 1), 0.0)
    is_call = (depth >= min_depth) & (alt_cnt > 0) & (frac >= het_frac)
    sites = np.nonzero(is_call)[0]
    out: List[PileupCall] = []
    for p in sites:
        gt = "1/1" if frac[p] >= hom_frac else "0/1"
        out.append(
            PileupCall(
                flat_pos=int(p),
                ref_base=int(ref_codes[p]),
                alt_base=int(alt_base[p]),
                depth=int(depth[p]),
                alt_depth=int(alt_cnt[p]),
                genotype=gt,
            )
        )
    return out


def write_pileup_vcf(
    path: str,
    reference: Reference,
    counts: np.ndarray,
    calls: List[PileupCall],
    sample: str = "SAMPLE",
):
    """final.vcf-style output: DP/AC/DP_A..DP_T INFO, QUAL = 3*alt_depth+27."""
    headers = [
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="Total Depth">',
        '##INFO=<ID=AC,Number=.,Type=Integer,Description="allele count in genotypes">',
        '##INFO=<ID=DP_A,Number=1,Type=Integer,Description="depth of A basecalls at position">',
        '##INFO=<ID=DP_C,Number=1,Type=Integer,Description="depth of C basecalls at position">',
        '##INFO=<ID=DP_G,Number=1,Type=Integer,Description="depth of G basecalls at position">',
        '##INFO=<ID=DP_T,Number=1,Type=Integer,Description="depth of T basecalls at position">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">',
    ]
    with VcfWriter(
        path,
        sample=sample,
        contigs=[(c.name, c.length) for c in reference.contigs],
        extra_headers=headers,
    ) as w:
        for call in calls:
            # flat coord -> contig coord
            contig = None
            for c in reference.contigs:
                if c.start <= call.flat_pos < c.start + c.length:
                    contig = c
                    break
            if contig is None:
                continue
            cnt = counts[:, call.flat_pos]
            rec = VcfRecord(
                chrom=contig.name,
                pos=call.flat_pos - contig.start + 1,
                ref="ACGT"[call.ref_base],
                alt="ACGT"[call.alt_base],
                qual=3 * call.alt_depth + 27,
                info={
                    "DP": call.depth,
                    "AC": call.alt_depth,
                    "DP_A": int(cnt[0]),
                    "DP_T": int(cnt[3]),
                    "DP_G": int(cnt[2]),
                    "DP_C": int(cnt[1]),
                },
                fmt={"GT": call.genotype, "DP": call.alt_depth},
            )
            w.write(rec)


def run_pileup_pipeline(
    reference: Reference,
    codes: np.ndarray,
    lengths: np.ndarray,
    k: int = 13,
    min_depth: int = 8,
    max_mismatches: int = 5,
):
    """reads + reference -> (placements, counts, calls)."""
    index = RefKmerIndex.build(reference.flat, k, reference.is_n)
    pl = place_reads(index, codes, lengths, max_mismatches=max_mismatches)
    counts = pileup_counts(reference.total_bases, codes, lengths, pl)
    calls = call_snps(reference.flat, counts, min_depth=min_depth)
    return pl, counts, calls
