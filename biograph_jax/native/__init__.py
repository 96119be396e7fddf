"""Native (C++) host-side components, loaded via ctypes.

The reference implements its runtime hot loops (read import, kv sort,
parsing) in C++ (modules/io/, modules/build_seqset/read_importer.cpp); the
build keeps the device compute in JAX/XLA but the host-side IO spine is
native too.  The shared library builds on first use with g++ (no pybind11 —
plain C ABI + ctypes) and is cached next to the sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(__file__)
_LOCK = threading.Lock()
_LIB = None


def _build_lib() -> str:
    """Compile the scanner, keyed by source hash (never shipped prebuilt:
    -march=native binaries are machine-specific and unauditable)."""
    src = os.path.join(_HERE, "fastq_scan.cpp")
    digest = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    out = os.path.join(_HERE, f"_native.{digest}.so")
    if os.path.isfile(out):
        return out
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-std=c++17",
        src,
        "-o",
        out + ".tmp",
        "-lz",
        "-lpthread",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(out + ".tmp", out)
    return out


def get_lib():
    """Load (building if needed) the native library; None if no toolchain."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            path = _build_lib()
        except Exception:
            return None
        lib = ctypes.CDLL(path)
        lib.fastq_scan.restype = ctypes.c_longlong
        lib.fastq_scan.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_int,
        ]
        lib.fastq_dims.restype = ctypes.c_int
        lib.fastq_dims.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.pack_codes_2bit.restype = None
        lib.pack_codes_2bit.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_longlong,
        ]
        lib.bam_dims.restype = ctypes.c_int
        lib.bam_dims.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.bam_scan.restype = ctypes.c_longlong
        lib.bam_scan.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_int,
        ] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong]
        lib.bgzf_scan.restype = ctypes.c_longlong
        lib.bgzf_scan.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_longlong,
        ]
        lib.bgzf_inflate.restype = ctypes.c_int
        lib.bgzf_inflate.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        _LIB = lib
        return lib


def _alloc(shape, dtype, spill_dir, name):
    """Output buffer: RAM by default, disk-backed memmap under spill_dir —
    WGS-scale imports hold reads on disk, not in host memory (the
    reference's analog is part_repo's file-backed partitions)."""
    if spill_dir is None:
        return np.zeros(shape, dtype)
    os.makedirs(spill_dir, exist_ok=True)
    return np.memmap(
        os.path.join(spill_dir, name + ".mm"), dtype, "w+", shape=shape
    )


def bgzf_decompress_native(buf, n_threads: int | None = None,
                           spill_dir: str | None = None):
    """Parallel BGZF decompression (the htslib multi-threaded-reader analog).

    `buf` is any uint8 buffer (bytes or np.memmap).  Returns a uint8 ndarray
    of the concatenated uncompressed stream, or None when the library is
    unavailable or a member lacks the BGZF 'BC' marker (caller falls back to
    serial zlib, which also handles plain gzip)."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(buf, np.uint8) if isinstance(buf, bytes) else buf
    n = len(arr)
    if n < 18:
        return None
    max_blocks = n // 28 + 2  # EOF marker block is 28 bytes, the minimum
    c_off = np.zeros(max_blocks, np.int64)
    c_size = np.zeros(max_blocks, np.int32)
    u_size = np.zeros(max_blocks, np.int32)
    k = lib.bgzf_scan(
        arr.ctypes.data, n, c_off.ctypes.data, c_size.ctypes.data,
        u_size.ctypes.data, max_blocks,
    )
    if k <= 0:
        return None
    if k == max_blocks and int(c_off[k - 1]) + int(c_size[k - 1]) < n:
        return None  # scan table too small (shouldn't happen; be safe)
    u_off = np.zeros(k + 1, np.int64)
    np.cumsum(u_size[:k], out=u_off[1:])
    out = _alloc((int(u_off[k]),), np.uint8, spill_dir, "bgzf_out")
    nt = n_threads or min(os.cpu_count() or 1, 16)
    rc = lib.bgzf_inflate(
        arr.ctypes.data, c_off.ctypes.data, c_size.ctypes.data,
        u_off.ctypes.data, u_size.ctypes.data, k, out.ctypes.data, int(nt),
    )
    if rc != 0:
        return None
    return out


def bam_scan_native(aln_buf, keep_unmapped: bool = True,
                    spill_dir: str | None = None):
    """Parse decompressed BAM alignment records natively.

    Returns (codes, quals, lengths, flags, names) or None when the library
    is unavailable.  spill_dir puts the code/qual matrices on disk."""
    lib = get_lib()
    if lib is None:
        return None
    arr = (
        np.frombuffer(aln_buf, np.uint8)
        if isinstance(aln_buf, bytes)
        else np.ascontiguousarray(aln_buf)
    )
    nr = ctypes.c_longlong(0)
    ml = ctypes.c_longlong(0)
    nb = ctypes.c_longlong(0)
    lib.bam_dims(
        arr.ctypes.data, len(arr), int(keep_unmapped),
        ctypes.byref(nr), ctypes.byref(ml), ctypes.byref(nb),
    )
    R, L = nr.value, max(ml.value, 1)
    codes = _alloc((R, L), np.uint8, spill_dir, "bam_codes")
    quals = _alloc((R, L), np.uint8, spill_dir, "bam_quals")
    lengths = np.zeros(R, np.int32)
    flags = np.zeros(R, np.int32)
    name_off = np.zeros(R + 1, np.int64)
    name_buf = np.zeros(max(nb.value, 1), np.uint8)
    got = lib.bam_scan(
        arr.ctypes.data, len(arr), int(keep_unmapped),
        codes.ctypes.data, quals.ctypes.data, lengths.ctypes.data,
        flags.ctypes.data, name_off.ctypes.data, name_buf.ctypes.data,
        R, L,
    )
    if got != R:
        raise ValueError(f"native BAM scan parsed {got}/{R} records")
    raw = name_buf.tobytes()
    names = [raw[name_off[i] : name_off[i + 1]] for i in range(R)]
    return codes, quals, lengths, flags, names


def fastq_scan_native(buf, with_quals: bool = True,
                      spill_dir: str | None = None):
    """Parse FASTQ bytes with the native scanner.

    Returns (codes [R, L], quals [R, L] | None, lengths [R]) or None if the
    native library is unavailable.  spill_dir puts the matrices on disk.
    """
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(buf, np.uint8) if isinstance(buf, bytes) else np.ascontiguousarray(buf)
    n_reads = ctypes.c_longlong(0)
    max_len = ctypes.c_longlong(0)
    rc = lib.fastq_dims(
        arr.ctypes.data, len(arr), ctypes.byref(n_reads), ctypes.byref(max_len)
    )
    if rc != 0:
        raise ValueError("malformed FASTQ (native scanner)")
    R, L = n_reads.value, max(max_len.value, 1)
    codes = _alloc((R, L), np.uint8, spill_dir, "fq_codes")
    quals = (
        _alloc((R, L), np.uint8, spill_dir, "fq_quals")
        if with_quals
        else np.zeros((1, 1), np.uint8)
    )
    lengths = np.zeros(R, np.int32)
    got = lib.fastq_scan(
        arr.ctypes.data,
        len(arr),
        codes.ctypes.data,
        quals.ctypes.data,
        lengths.ctypes.data,
        R,
        L,
        1 if with_quals else 0,
    )
    if got != R:
        raise ValueError(f"native FASTQ scan parsed {got}/{R} reads")
    return codes, (quals if with_quals else None), lengths
