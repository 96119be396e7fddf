import os

import numpy as np
import pytest

from biograph_jax.io.bam import mate_pairs_from_names, read_bam, read_sam

GOLDEN = "/root/reference/golden"


def test_read_bam_golden():
    batch, hdr = read_bam(os.path.join(GOLDEN, "ERR091571.bam"))
    assert batch.num_reads > 1000
    assert len(hdr["refs"]) >= 1
    assert (batch.lengths > 0).all()
    # sane base composition (no systematic N/A bias)
    frac_a = (batch.codes[batch.codes.shape[0] // 2] == 0).mean()
    assert 0.05 < frac_a < 0.6


def test_bam_matches_sam():
    """ERR091571.bam and .sam are the same alignments; importers must agree."""
    bam, _ = read_bam(os.path.join(GOLDEN, "ERR091571.bam"))
    sam, _ = read_sam(os.path.join(GOLDEN, "ERR091571.sam"))
    assert bam.num_reads == sam.num_reads
    assert (bam.lengths == sam.lengths).all()
    assert (bam.codes == sam.codes).all()
    assert bam.names == sam.names


def test_sam_reverse_strand_restored():
    sam, _ = read_sam(os.path.join(GOLDEN, "ecoli.sam"))
    assert sam.num_reads > 100


def test_parallel_bgzf_matches_serial():
    """Native parallel BGZF inflate must reproduce serial zlib exactly on a
    real multi-block BAM (and on plain-gzip input it must decline)."""
    import gzip

    from biograph_jax.io.bam import _bgzf_decompress
    from biograph_jax.native import bgzf_decompress_native

    path = os.path.join(GOLDEN, "SRR003674_10000.bam")
    raw = np.memmap(path, np.uint8, "r")
    got = bgzf_decompress_native(raw)
    assert got is not None, "native bgzf unavailable"
    want = _bgzf_decompress(bytes(raw))
    assert got.tobytes() == want and len(want) > len(raw)

    plain = gzip.compress(b"not a bgzf stream" * 100)
    assert bgzf_decompress_native(plain) is None  # no BC subfield -> decline


def test_mate_pairing():
    names = [b"a", b"b", b"a", b"c", b"b"]
    flags = np.array([0x41, 0x41, 0x81, 0x0, 0x81], np.int32)
    mate_of = mate_pairs_from_names(names, flags)
    assert mate_of[0] == 2 and mate_of[2] == 0
    assert mate_of[1] == 4 and mate_of[4] == 1
    assert mate_of[3] == -1


def test_spill_dir_imports_match_ram(tmp_path):
    """spill_dir imports must be byte-identical to in-RAM imports, with the
    big matrices living on disk (memmap)."""
    from biograph_jax.io.fastq import read_fastq

    fq = "/root/reference/golden/quick_e_coli.fq"
    a = read_fastq(fq)
    b = read_fastq(fq, spill_dir=str(tmp_path / "fq"))
    assert isinstance(b.codes, np.memmap)
    assert (a.codes == b.codes).all() and (a.lengths == b.lengths).all()
    assert (a.quals == b.quals).all()

    bam = os.path.join(GOLDEN, "SRR003674_10000.bam")
    x, _ = read_bam(bam)
    y, _ = read_bam(bam, spill_dir=str(tmp_path / "bam"))
    assert isinstance(y.codes, np.memmap)
    assert (x.codes == y.codes).all() and (x.lengths == y.lengths).all()
    assert x.names == y.names
