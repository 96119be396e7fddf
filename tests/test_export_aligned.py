"""BAM writing (BGZF + binary records) and the export_aligned tool
(reference: python/biograph/tools/export_aligned.py; SAMv1 spec §4.1-5.3)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from biograph_jax.io.bamwrite import SamRecord, write_bam, write_sam


def _recs():
    return [
        SamRecord(
            qname="r0", flag=0, rname="chr1", pos=10, mapq=60,
            cigar=[(8, "M")], seq="ACGTACGT", qual="IIIIIIII",
            tags={"NM": 1},
        ),
        SamRecord(
            qname="r1", flag=16, rname="chr1", pos=30, mapq=60,
            cigar=[(4, "M")], seq="TTGG", tags={"NM": 0},
        ),
        SamRecord(
            qname="r2", flag=4, rname="*", pos=0, mapq=0, cigar=[],
            seq="CCCC",
        ),
    ]


def test_bam_roundtrip_own_reader(tmp_path):
    """Our BGZF writer must be readable by our own native BAM reader."""
    from biograph_jax.io.bam import read_bam

    p = str(tmp_path / "w.bam")
    assert write_bam(p, [("chr1", 1000)], _recs()) == 3
    batch, hdr = read_bam(p, with_names=True, keep_unmapped=True)
    assert batch.num_reads == 3
    assert [n.decode() if isinstance(n, bytes) else n for n in batch.names] == [
        "r0", "r1", "r2",
    ]
    # read_bam restores reverse-strand reads to original orientation:
    # r1 stored as TTGG with FLAG_REVERSE -> revcomp CCAA
    from biograph_jax.core import dna

    assert batch.sequence(0) == "ACGTACGT"
    assert batch.sequence(1) == "CCAA"
    assert batch.sequence(2) == "CCCC"
    assert list(hdr["flags"]) == [0, 16, 4]
    # quals preserved for r0 (phred 40)
    assert batch.quals[0, :8].tolist() == [40] * 8


def test_sam_text(tmp_path):
    p = str(tmp_path / "w.sam")
    assert write_sam(p, [("chr1", 1000)], _recs()) == 3
    lines = open(p).read().splitlines()
    assert lines[0].startswith("@HD") and "@SQ\tSN:chr1\tLN:1000" in lines[1]
    body = [l for l in lines if not l.startswith("@")]
    f = body[0].split("\t")
    assert f[:6] == ["r0", "0", "chr1", "10", "60", "8M"] and "NM:i:1" in f


@pytest.fixture(scope="module")
def ecoli_bgt(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ea") / "quick.bgt")
    r = subprocess.run(
        [
            sys.executable, "-m", "biograph_jax", "--platform", "cpu",
            "create", "--reads", "/root/reference/golden/quick_e_coli.fq",
            "--out", out, "--paired",
        ],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return out


@pytest.mark.slow
def test_export_aligned_e2e(ecoli_bgt, tmp_path):
    """Reads out of the readmap, placed, written as BAM, read back by the
    native reader; VCF windows restrict the output."""
    from biograph_jax.api import BioGraph
    from biograph_jax.index.reference import Reference
    from biograph_jax.io.bam import read_bam
    from biograph_jax.tools.export_aligned import export_aligned

    bg = BioGraph(ecoli_bgt)
    ref = Reference.from_reference_dir(
        "/root/reference/datasets/reference/e_coli_k12_ASM584v1"
    )
    sam_all = str(tmp_path / "all.sam")
    n_all = export_aligned(bg, ref, sam_all)
    assert n_all > 1000  # most reads place
    body = [l.split("\t") for l in open(sam_all) if not l.startswith("@")]
    assert len(body) == n_all
    # pick a genuinely covered position (contig + pos from a real record)
    mid_rec = body[len(body) // 2]
    chrom, mid = mid_rec[2], int(mid_rec[3]) + 20

    # VCF windows: a single variant keeps only nearby reads; BAM output
    # round-trips through the native reader
    vcf = tmp_path / "one.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        f"{chrom}\t{mid}\t.\tA\tT\t50\tPASS\t.\n"
    )
    bam = str(tmp_path / "win.bam")
    n_win = export_aligned(bg, ref, bam, vcf_path=str(vcf), window=300)
    assert 0 < n_win < n_all
    batch, hdr = read_bam(bam, with_names=True)
    assert batch.num_reads == n_win
    assert all(f & 0x4 == 0 for f in hdr["flags"])
    read_len = int(batch.lengths.max())
    # windowed SAM text cross-check
    sam = str(tmp_path / "win.sam")
    n_sam = export_aligned(bg, ref, sam, vcf_path=str(vcf), window=300)
    assert n_sam == n_win
    for line in open(sam):
        if line.startswith("@"):
            continue
        pos = int(line.split("\t")[3])
        assert mid - 300 - read_len <= pos <= mid + 300 + 1
