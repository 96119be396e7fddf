import os

import numpy as np
import pytest

from biograph_jax.io.fastq import read_fastq
from biograph_jax.native import fastq_scan_native, get_lib

GOLDEN = "/root/reference/golden"


def test_native_lib_builds():
    assert get_lib() is not None


@pytest.mark.parametrize(
    "name", ["quick_e_coli.fq", "e_coli_10000snp.fq", "E_coli_phred33.fq"]
)
def test_native_matches_numpy(name):
    path = os.path.join(GOLDEN, name)
    native = read_fastq(path, use_native=True)
    fallback = read_fastq(path, use_native=False)
    assert native.num_reads == fallback.num_reads
    assert (native.lengths == fallback.lengths).all()
    assert (native.codes == fallback.codes).all()
    if native.quals is not None and fallback.quals is not None:
        for i in range(0, native.num_reads, max(native.num_reads // 10, 1)):
            n = native.lengths[i]
            assert (native.quals[i, :n] == fallback.quals[i, :n]).all()


def test_native_malformed():
    # record truncated before the '+' line (note: an EOF right after '+\n'
    # parses as an empty quality line — golden/e_coli_10000snp.fq has blank
    # qual lines, so those are legal)
    buf = b"@r1\nACGT\n"
    with pytest.raises(ValueError):
        fastq_scan_native(buf)
    with pytest.raises(ValueError):
        fastq_scan_native(b"ACGT\nno header\n")


def test_native_pack_matches_python():
    from biograph_jax.core import dna
    from biograph_jax.native import get_lib
    import ctypes

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(7, 40), dtype=np.uint8)
    lengths = np.array([40, 35, 17, 16, 1, 0, 33], np.int32)
    expect = np.asarray(dna.pack_codes(codes, lengths))
    lib = get_lib()
    W = expect.shape[1]
    words = np.zeros((7, W), np.uint32)
    lib.pack_codes_2bit(
        codes.ctypes.data, 7, 40, lengths.ctypes.data, words.ctypes.data, W
    )
    assert (words == expect).all()
