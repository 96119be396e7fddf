"""SAM/BAM read import (no htslib).

Counterpart of the reference's BAM/CRAM ingestion
(modules/build_seqset/read_importer.cpp:543 via htslib sam_read1).  BAM is
BGZF (concatenated gzip members) over a simple binary record format.  The
hot layers are native when the C++ library is available: parallel BGZF
inflate (htslib multi-thread analog) + the record scanner; pure
zlib + numpy otherwise.  CRAM has its own decoder (io/cram.py).

Emits the same ReadBatch as the FASTQ importer, with pairing derived from
FLAG bits / read names.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

from biograph_jax.core import dna
from biograph_jax.io.fastq import ReadBatch

# BAM 4-bit base codes -> 2-bit codes ('=ACMGRSVTWYHKDBN'); ambiguity -> A(0)
_NIB_TO_CODE = np.zeros(16, np.uint8)
_NIB_TO_CODE[1] = 0  # A
_NIB_TO_CODE[2] = 1  # C
_NIB_TO_CODE[4] = 2  # G
_NIB_TO_CODE[8] = 3  # T


def _bgzf_bsize(view, pos: int) -> int:
    """Total size of the BGZF member at pos via its 'BC' extra subfield;
    -1 when the member is plain gzip (no FEXTRA/BC)."""
    if not (view[pos + 3] & 4):
        return -1
    xlen = view[pos + 10] | (view[pos + 11] << 8)
    q, xend = pos + 12, pos + 12 + xlen
    while q + 4 <= xend:
        slen = view[q + 2] | (view[q + 3] << 8)
        if view[q] == 0x42 and view[q + 1] == 0x43 and slen == 2:
            return (view[q + 4] | (view[q + 5] << 8)) + 1
        q += 4 + slen
    return -1


def _bgzf_decompress(buf) -> bytes:
    """Decompress all BGZF/gzip members (serial zlib fallback).

    BGZF members are walked by their 'BC' size field so each inflate sees
    only its own block — a decompressobj over the remaining stream would
    copy it into unused_data per member (quadratic on multi-thousand-block
    files).  Plain-gzip members (no BC) take the decompressobj path."""
    data = bytes(buf) if not isinstance(buf, bytes) else buf
    view = memoryview(data)
    out = []
    pos = 0
    n = len(view)
    while pos + 18 <= n:
        if view[pos] != 0x1F or view[pos + 1] != 0x8B:
            break
        bsize = _bgzf_bsize(view, pos)
        if 0 < bsize <= n - pos:
            out.append(zlib.decompress(view[pos : pos + bsize], wbits=31))
            pos += bsize
            continue
        d = zlib.decompressobj(wbits=31)
        out.append(d.decompress(view[pos:]))
        consumed = n - pos - len(d.unused_data)
        pos += consumed
        if consumed <= 0:
            break
    return b"".join(out)


def _load_decompressed(path: str, spill_dir: str | None = None):
    """mmap the file and BGZF-decompress it, multi-threaded when the native
    library is present (htslib hts_set_threads analog — BGZF blocks are
    independent deflate members, so they inflate in parallel); serial zlib
    otherwise.  Returns a buffer supporting slicing/frombuffer; with
    spill_dir the decompressed stream lives on disk, not in RAM."""
    raw = np.memmap(path, np.uint8, "r") if os.path.getsize(path) else b""
    try:
        from biograph_jax.native import bgzf_decompress_native

        out = bgzf_decompress_native(raw, spill_dir=spill_dir)
        if out is not None:
            return out
    except Exception:
        pass
    return _bgzf_decompress(raw)


def read_bam(
    path: str, with_names: bool = True, keep_unmapped: bool = True,
    spill_dir: str | None = None,
) -> Tuple[ReadBatch, dict]:
    """Parse a BAM file -> (ReadBatch, header info).

    Reverse-strand alignments are flipped back to original read orientation
    (matching the reference importer, read_importer.cpp BAM path).
    spill_dir keeps the decompressed stream and the code/qual matrices on
    disk (memmap) — WGS-scale imports stay within bounded host RAM.
    """
    data = _load_decompressed(path, spill_dir)
    if bytes(data[:4]) != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", data, 4)[0]
    off = 8 + l_text
    n_ref_n = struct.unpack_from("<i", data, off)[0]
    off_n = off + 4
    refs_n = []
    for _ in range(n_ref_n):
        l_name = struct.unpack_from("<i", data, off_n)[0]
        refs_n.append(
            (
                bytes(data[off_n + 4 : off_n + 4 + l_name - 1]).decode(),
                struct.unpack_from("<i", data, off_n + 4 + l_name)[0],
            )
        )
        off_n += 8 + l_name
    # native record scanner (C++, biograph_jax.native): the per-record loop
    # is the hot path on WGS-scale BAMs
    try:
        from biograph_jax.native import bam_scan_native

        out = bam_scan_native(data[off_n:], keep_unmapped, spill_dir=spill_dir)
    except Exception:
        out = None
    if out is not None:
        codes, quals, lengths, flags, names = out
        batch = ReadBatch(
            codes=codes,
            lengths=lengths,
            quals=quals,
            names=names if with_names else None,
        )
        batch.flags = np.asarray(flags, np.int32)  # type: ignore[attr-defined]
        return batch, {"refs": refs_n, "flags": flags}
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        name = bytes(data[off + 4 : off + 4 + l_name - 1]).decode()
        l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
        refs.append((name, l_ref))
        off += 8 + l_name
    seqs: List[np.ndarray] = []
    quals: List[np.ndarray] = []
    names: List[bytes] = []
    flags: List[int] = []
    n = len(data)
    while off + 4 <= n:
        block_size = struct.unpack_from("<i", data, off)[0]
        rec = data[off + 4 : off + 4 + block_size]
        off += 4 + block_size
        if len(rec) < 32:
            break
        (
            _ref_id,
            _pos,
            l_read_name,
            _mapq,
            _bin,
            n_cigar_op,
            flag,
            l_seq,
        ) = struct.unpack_from("<iiBBHHHi", rec, 0)
        p = 32
        name = rec[p : p + l_read_name - 1]
        p += l_read_name
        p += 4 * n_cigar_op
        nseq = (l_seq + 1) // 2
        seq_nib = np.frombuffer(rec[p : p + nseq], np.uint8)
        p += nseq
        qual = np.frombuffer(rec[p : p + l_seq], np.uint8)
        # unpack 4-bit: high nibble first
        codes4 = np.empty(nseq * 2, np.uint8)
        codes4[0::2] = seq_nib >> 4
        codes4[1::2] = seq_nib & 0xF
        codes = _NIB_TO_CODE[codes4[:l_seq]]
        q = qual.copy() if len(qual) == l_seq else np.zeros(l_seq, np.uint8)
        if flag & 0x10:  # reverse strand: restore original orientation
            codes = np.asarray(dna.revcomp_codes(codes))
            q = q[::-1]
        if not keep_unmapped and (flag & 0x4):
            continue
        if flag & 0x100 or flag & 0x800:  # secondary/supplementary
            continue
        seqs.append(codes)
        quals.append(q)
        names.append(bytes(name))
        flags.append(flag)
    return _to_batch(seqs, quals, names if with_names else None, flags), {
        "refs": refs
    }


def read_sam(path: str, with_names: bool = True) -> Tuple[ReadBatch, dict]:
    """Parse a SAM text file -> (ReadBatch, header info)."""
    seqs, quals, names, flags = [], [], [], []
    refs = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                if line.startswith(b"@SQ"):
                    d = dict(
                        kv.split(b":", 1)
                        for kv in line.split(b"\t")[1:]
                        if b":" in kv
                    )
                    refs.append(
                        (d.get(b"SN", b"?").decode(), int(d.get(b"LN", b"0")))
                    )
                continue
            fields = line.rstrip(b"\n").split(b"\t")
            if len(fields) < 11:
                continue
            flag = int(fields[1])
            if flag & 0x100 or flag & 0x800:
                continue
            seq = fields[9]
            if seq == b"*":
                continue
            codes = dna.encode_ascii(np.frombuffer(seq, np.uint8))
            q = (
                np.frombuffer(fields[10], np.uint8) - 33
                if fields[10] != b"*"
                else np.zeros(len(seq), np.uint8)
            )
            if flag & 0x10:
                codes = np.asarray(dna.revcomp_codes(codes))
                q = q[::-1].copy()
            seqs.append(codes)
            quals.append(q)
            names.append(bytes(fields[0]))
            flags.append(flag)
    return _to_batch(seqs, quals, names if with_names else None, flags), {
        "refs": refs
    }


def _to_batch(seqs, quals, names, flags) -> ReadBatch:
    if not seqs:
        return ReadBatch(
            codes=np.zeros((0, 0), np.uint8), lengths=np.zeros(0, np.int32)
        )
    L = max(len(s) for s in seqs)
    codes = np.zeros((len(seqs), L), np.uint8)
    qarr = np.zeros((len(seqs), L), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        codes[i, : len(s)] = s
        qarr[i, : len(q)] = q
        lens[i] = len(s)
    batch = ReadBatch(codes=codes, lengths=lens, quals=qarr, names=names)
    batch.flags = np.asarray(flags, np.int32)  # type: ignore[attr-defined]
    return batch


def mate_pairs_from_names(names: List[bytes], flags: np.ndarray) -> np.ndarray:
    """Pair reads by name + FLAG read1/read2 bits -> mate_of array."""
    mate_of = np.full(len(names), -1, np.int64)
    first: dict = {}
    for i, nm in enumerate(names):
        if not flags[i] & 0x1:
            continue
        if nm in first:
            j = first.pop(nm)
            mate_of[i] = j
            mate_of[j] = i
        else:
            first[nm] = i
    return mate_of
