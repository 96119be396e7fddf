import os

import numpy as np
import pytest

from biograph_jax.tools import vdb
from biograph_jax.tools.qc import (
    aggregate_qc,
    error_threshold,
    kmer_histogram,
    refhash,
    write_kmer_quality_report,
)


def test_kmer_histogram_threshold():
    # bimodal: errors at 1-2, signal around 30
    counts = np.concatenate(
        [np.ones(1000), np.full(80, 2), np.full(400, 30), np.full(300, 29)]
    )
    hist = kmer_histogram(counts)
    thr = error_threshold(hist)
    assert 2 <= thr <= 10


def test_kmer_report_html(tmp_path):
    counts = np.concatenate([np.ones(50), np.full(100, 20)])
    meta = write_kmer_quality_report(str(tmp_path / "r.html"), counts, 23)
    html = open(tmp_path / "r.html").read()
    assert "k-mer quality report" in html
    assert meta["distinct_kmers"] == 150


def test_refhash_order_independent():
    from biograph_jax.index.reference import Contig, Reference

    flat = np.array([0, 1, 2, 3, 0, 0, 1, 1], np.uint8)
    r1 = Reference(
        flat=flat,
        is_n=np.zeros(8, bool),
        contigs=[Contig("a", 0, 4), Contig("b", 4, 4)],
    )
    # same contigs, different order in the flat array
    flat2 = np.array([0, 0, 1, 1, 0, 1, 2, 3], np.uint8)
    r2 = Reference(
        flat=flat2,
        is_n=np.zeros(8, bool),
        contigs=[Contig("b", 0, 4), Contig("a", 4, 4)],
    )
    assert refhash(r1) == refhash(r2)
    # different sequence -> different hash
    flat3 = flat.copy()
    flat3[0] = 3
    r3 = Reference(flat=flat3, is_n=np.zeros(8, bool), contigs=r1.contigs)
    assert refhash(r1) != refhash(r3)


def test_vdb_roundtrip(tmp_path):
    from biograph_jax.io.vcf import VcfRecord, VcfWriter

    vcf = str(tmp_path / "in.vcf")
    with VcfWriter(vcf, sample="s1") as w:
        w.write(VcfRecord("chr1", 100, "A", "T", qual=50, fmt={"GT": "0/1"}))
        w.write(VcfRecord("chr1", 200, "G", "C", qual=9, filter="lowq", fmt={"GT": "1/1"}))
        w.write(VcfRecord("chr2", 5, "T", "TA", qual=99, fmt={"GT": "1/1"}))
    db = str(tmp_path / "db")
    assert vdb.ingest(db, vcf, "s1") == 3
    assert list(vdb.list_samples(db)) == ["s1"]
    rows = vdb.query(db, chrom="chr1")
    assert len(rows) == 2
    rows = vdb.query(db, passing=True, min_qual=40)
    assert len(rows) == 2 and {r["pos"] for r in rows} == {100, 5}
    out = str(tmp_path / "out.vcf")
    assert vdb.export(db, "s1", out) == 3
    from biograph_jax.io.vcf import read_vcf

    back = read_vcf(out)
    assert [(r.chrom, r.pos, r.ref, r.alt) for r in back] == [
        ("chr1", 100, "A", "T"),
        ("chr1", 200, "G", "C"),
        ("chr2", 5, "T", "TA"),
    ]
