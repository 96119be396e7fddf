"""Read-backed phasing (modules/variants/phase.h analog) on constructed
reads — the dna_testutil-style synthetic pattern from SURVEY §4."""

import numpy as np
import pytest

from biograph_jax.build.readmap_build import build_readmap
from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.index.reference import Contig, Reference
from biograph_jax.io.vcf import VcfRecord
from biograph_jax.variants.phase import phase_records


def _mk(rng, G=600):
    flat = rng.integers(0, 4, G).astype(np.uint8)
    ref = Reference(
        flat=flat, is_n=np.zeros(G, bool), contigs=[Contig("chr1", 0, G)]
    )
    return ref


def _reads_from(haps, read_len=100, step=7):
    rows = []
    for h in haps:
        for s in range(0, len(h) - read_len + 1, step):
            rows.append(h[s : s + read_len])
    codes = np.stack(rows).astype(np.uint8)
    lens = np.full(len(rows), read_len, np.int32)
    return codes, lens


def _snp(hap, pos, ref_base):
    hap[pos] = (ref_base + 1) % 4
    return "ACGT"[ref_base], "ACGT"[(ref_base + 1) % 4]


@pytest.mark.slow
def test_cis_and_trans_blocks(rng):
    ref = _mk(rng)
    flat = ref.flat
    hap1, hap2 = flat.copy(), flat.copy()
    # cis pair: both alts on hap1 at 200, 240
    r1, a1 = _snp(hap1, 200, int(flat[200]))
    r2, a2 = _snp(hap1, 240, int(flat[240]))
    # trans pair: alt at 400 on hap1, alt at 430 on hap2
    r3, a3 = _snp(hap1, 400, int(flat[400]))
    r4, a4 = _snp(hap2, 430, int(flat[430]))
    codes, lens = _reads_from([hap1, hap2])
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    records = [
        VcfRecord("chr1", 201, r1, a1),
        VcfRecord("chr1", 241, r2, a2),
        VcfRecord("chr1", 401, r3, a3),
        VcfRecord("chr1", 431, r4, a4),
    ]
    gt = ["0/1"] * 4
    pr = phase_records(rm, ref, records, gt)
    assert pr.n_blocks == 2
    # cis block: same orientation, shared PS
    assert pr.gt[0] == pr.gt[1] and "|" in pr.gt[0]
    assert pr.ps[0] == pr.ps[1] == 201
    # trans block: opposite orientation
    assert "|" in pr.gt[2] and "|" in pr.gt[3]
    assert pr.gt[2] != pr.gt[3]
    assert pr.ps[2] == pr.ps[3] == 401


@pytest.mark.slow
def test_conflict_splits_block(rng):
    """Variants farther apart than a read span stay unphased."""
    ref = _mk(rng, G=800)
    flat = ref.flat
    hap1 = flat.copy()
    r1, a1 = _snp(hap1, 200, int(flat[200]))
    r2, a2 = _snp(hap1, 500, int(flat[500]))  # 300 bp apart > read_len
    codes, lens = _reads_from([hap1, flat.copy()])
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    records = [VcfRecord("chr1", 201, r1, a1), VcfRecord("chr1", 501, r2, a2)]
    pr = phase_records(rm, ref, records, ["0/1", "0/1"])
    assert pr.n_blocks == 0
    assert pr.gt == ["0/1", "0/1"]
    assert pr.ps == [None, None]


def test_hom_and_multiallelic_skipped(rng):
    ref = _mk(rng)
    flat = ref.flat
    hap1 = flat.copy()
    r1, a1 = _snp(hap1, 200, int(flat[200]))
    codes, lens = _reads_from([hap1, flat.copy()])
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    records = [
        VcfRecord("chr1", 201, r1, a1),
        VcfRecord("chr1", 221, "A", "C,G"),
        VcfRecord("chr1", 241, "A", "C"),
    ]
    pr = phase_records(rm, ref, records, ["0/1", "1/2", "1/1"])
    # nothing linkable: multiallelic + hom excluded
    assert pr.gt == ["0/1", "1/2", "1/1"]
