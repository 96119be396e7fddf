"""CRAM + QSEQ import parity (import_formats_test.py analog).

The CRAM decoder is from-scratch (no htslib): ITF8/LTF8, rANS-4x8 order 0/1,
gzip blocks, EXTERNAL/BYTE_ARRAY encodings, feature-based read
reconstruction against the reference.  Ground truth is the matching BAM of
the same reads."""

import numpy as np
import pytest

CRAM = "/root/reference/datasets/bams/e_coli/e_coli_test.cram"
BAM = "/root/reference/datasets/bams/e_coli/e_coli_test.bam"
REFDIR = "/root/reference/datasets/reference/e_coli_k12_ASM584v1"


@pytest.mark.slow
def test_cram_matches_bam():
    from biograph_jax.index.reference import Reference
    from biograph_jax.io.bam import read_bam
    from biograph_jax.io.cram import read_cram_batch

    ref = Reference.from_reference_dir(REFDIR)
    cb, chdr = read_cram_batch(CRAM, ref)
    bb, _ = read_bam(BAM)
    assert cb.num_reads == bb.num_reads == 53550
    assert "@SQ" in chdr["text"]
    for i in range(cb.num_reads):
        assert cb.names[i] == bb.names[i], i
        lc, lb = int(cb.lengths[i]), int(bb.lengths[i])
        assert lc == lb, i
        assert (cb.codes[i, :lc] == bb.codes[i, :lb]).all(), i
        assert (cb.quals[i, :lc] == bb.quals[i, :lc]).all(), i


def test_qseq_variants():
    from biograph_jax.io.qseq import read_qseq

    batches = {
        p: read_qseq(f"/root/reference/golden/test.qseq{p}")
        for p in ("", ".gz", ".bz2")
    }
    base = batches[""]
    assert base.num_reads == 813  # B-quality/N-masked reads trimmed away
    assert base.max_len == 100
    for p in (".gz", ".bz2"):
        b = batches[p]
        assert b.num_reads == base.num_reads
        assert (b.codes == base.codes).all()
        assert (b.quals == base.quals).all()
    # reference importer rules: '.' -> N, leading/trailing N trimmed
    assert base.lengths.min() >= 1
