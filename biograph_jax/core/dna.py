"""2-bit DNA codec, k-mer encoding, and packed-word sequence utilities.

Array-native counterpart of the reference's ``dna_sequence`` / ``kmer_t``
(reference: modules/bio_base/dna_sequence.h:19, modules/bio_base/kmer.h:30-67).
Sequences live as arrays:

  * **codes**:  uint8 arrays of per-base codes A=0 C=1 G=2 T=3 (one base per
    element) — the working representation for vectorized transforms.
  * **packed words**: uint32 arrays, 16 bases per word, first base in the two
    *most significant* bits.  With zero padding past the sequence end, unsigned
    word-by-word comparison equals lexicographic DNA comparison, and a
    sequence is a prefix of another iff its padded words match under a mask.
    Ties between a sequence and itself + trailing A's are broken by an
    explicit length key (ascending), which yields exact "prefix-first"
    lexicographic order — the seqset entry order.
  * **k-mers**: uint64, base appended at the least-significant end, matching
    the reference's ``make_kmer`` (modules/bio_base/kmer.h:30).

Everything here is shape-polymorphic pure-array code usable from numpy (host
I/O) and jax.numpy (device) alike.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

BASES_PER_WORD = 16  # 2 bits per base in a uint32 word

_ASCII_TO_CODE = np.zeros(256, dtype=np.uint8)
_ASCII_TO_CODE[ord("A")] = 0
_ASCII_TO_CODE[ord("a")] = 0
_ASCII_TO_CODE[ord("C")] = 1
_ASCII_TO_CODE[ord("c")] = 1
_ASCII_TO_CODE[ord("G")] = 2
_ASCII_TO_CODE[ord("g")] = 2
_ASCII_TO_CODE[ord("T")] = 3
_ASCII_TO_CODE[ord("t")] = 3
# Every other character (incl. 'N') maps to 0 == 'A', matching the reference's
# kmer_bit_value (modules/bio_base/kmer.h:69-88).

_CODE_TO_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_ascii(buf: np.ndarray) -> np.ndarray:
    """uint8 ASCII array -> uint8 base codes."""
    return _ASCII_TO_CODE[buf]


def decode_to_ascii(codes: np.ndarray) -> np.ndarray:
    """uint8 base codes -> uint8 ASCII array."""
    return _CODE_TO_ASCII[np.asarray(codes) & 3]


def seq_to_codes(seq: str) -> np.ndarray:
    return encode_ascii(np.frombuffer(seq.encode(), dtype=np.uint8))


def codes_to_seq(codes) -> str:
    return decode_to_ascii(np.asarray(codes)).tobytes().decode()


def revcomp_codes(codes, length=None, axis: int = -1):
    """Reverse complement of a code array along ``axis``.

    With ``length`` given (per-row lengths for a padded 2-D batch), each row is
    reversed within its own length; the padding region is zeroed.
    """
    xp = jnp if isinstance(codes, jnp.ndarray) else np
    comp = (3 - codes).astype(codes.dtype)
    if length is None:
        return xp.flip(comp, axis=axis)
    # Padded batch: gather positions length-1-i for i < length.
    n = codes.shape[-1]
    idx = xp.arange(n)
    lengths = xp.asarray(length)[..., None]
    src = lengths - 1 - idx
    valid = idx < lengths
    src = xp.where(valid, src, 0)
    out = xp.take_along_axis(comp, src.astype(xp.int32), axis=-1)
    return xp.where(valid, out, 0).astype(codes.dtype)


# ---------------------------------------------------------------------------
# Packed words
# ---------------------------------------------------------------------------


def words_for_bases(nbases: int) -> int:
    return (nbases + BASES_PER_WORD - 1) // BASES_PER_WORD


def pack_codes(codes, lengths=None):
    """Pack base codes into big-endian-ordered uint32 words.

    codes: [..., L] uint8 with zero padding; returns [..., W] uint32 where
    W = ceil(L/16).  Bases beyond ``lengths`` (if given) are zeroed first.
    """
    xp = jnp if isinstance(codes, jnp.ndarray) else np
    L = codes.shape[-1]
    W = words_for_bases(L)
    padL = W * BASES_PER_WORD
    c = codes.astype(xp.uint32)
    if lengths is not None:
        pos = xp.arange(L)
        c = xp.where(pos < xp.asarray(lengths)[..., None], c, 0)
    if padL != L:
        pad = [(0, 0)] * (c.ndim - 1) + [(0, padL - L)]
        c = xp.pad(c, pad)
    c = c.reshape(c.shape[:-1] + (W, BASES_PER_WORD))
    shifts = (2 * (BASES_PER_WORD - 1 - xp.arange(BASES_PER_WORD))).astype(xp.uint32)
    return (c << shifts).sum(axis=-1, dtype=xp.uint32)


_UNPACK_LUT = None


def unpack_words(words, nbases: int):
    """Inverse of pack_codes: [..., W] uint32 -> [..., nbases] uint8."""
    xp = jnp if isinstance(words, jnp.ndarray) else np
    W = words.shape[-1]
    if xp is np:
        # byte-LUT fast path: a broadcast u32 shift over [..., W, 16]
        # materializes 4 bytes per base (6.4s at 800k x 7 words); one
        # np.take over a 256->4 table is ~20x faster
        global _UNPACK_LUT
        if _UNPACK_LUT is None:
            b = np.arange(256, dtype=np.uint16)
            _UNPACK_LUT = np.stack(
                [(b >> s) & 3 for s in (6, 4, 2, 0)], axis=1
            ).astype(np.uint8)
        raw = np.ascontiguousarray(words, dtype="<u4").view(np.uint8)
        raw = raw.reshape(words.shape[:-1] + (W, 4))[..., ::-1]  # big-endian
        c = _UNPACK_LUT[raw].reshape(words.shape[:-1] + (W * 4 * 4,))
        return c[..., :nbases]
    shifts = (2 * (BASES_PER_WORD - 1 - xp.arange(BASES_PER_WORD))).astype(xp.uint32)
    c = (words[..., :, None] >> shifts) & 3
    c = c.reshape(words.shape[:-1] + (W * BASES_PER_WORD,))
    return c[..., :nbases].astype(xp.uint8)


def prefix_mask_words(length, W: int, xp=np):
    """Per-word AND-masks selecting the first ``length`` bases of a W-word row.

    length: scalar or [...]; returns [..., W] uint32.
    """
    length = xp.asarray(length)
    widx = xp.arange(W)
    # bases covered by each word: clamp(length - 16*w, 0, 16)
    inword = xp.clip(length[..., None] - widx * BASES_PER_WORD, 0, BASES_PER_WORD)
    # mask with the top 2*inword bits set
    full = xp.uint32(0xFFFFFFFF)
    shift = (2 * (BASES_PER_WORD - inword)).astype(xp.uint32)
    mask = xp.where(
        inword == 0,
        xp.uint32(0),
        (full >> shift) << shift,
    )
    return mask.astype(xp.uint32)


# ---------------------------------------------------------------------------
# k-mers (uint64, appended at the least-significant end)
# ---------------------------------------------------------------------------


def kmer_mask(k: int) -> int:
    return (1 << (2 * k)) - 1


def kmers_from_codes(codes, lengths, k: int):
    """All k-mers of each padded row.

    codes: [R, L] uint8; lengths: [R]; returns (kmers [R, L-k+1] uint64,
    valid [R, L-k+1] bool).  Matches reference make_kmer ordering
    (modules/bio_base/kmer.h:30: first base in the most significant bits).
    """
    xp = jnp if isinstance(codes, jnp.ndarray) else np
    R, L = codes.shape
    Wn = L - k + 1
    if Wn <= 0:
        return xp.zeros((R, 0), xp.uint64), xp.zeros((R, 0), bool)
    acc = xp.zeros((R, Wn), xp.uint64)
    for i in range(k):
        acc = (acc << xp.uint64(2)) | codes[:, i : i + Wn].astype(xp.uint64)
    pos = xp.arange(Wn)
    valid = pos[None, :] + k <= xp.asarray(lengths)[:, None]
    return acc, valid


def revcomp_kmer(kmers, k: int):
    """Reverse complement of packed k-mers (reference: kmer.cpp rev_comp)."""
    xp = jnp if isinstance(kmers, jnp.ndarray) else np
    x = (~xp.asarray(kmers, dtype=xp.uint64)).astype(xp.uint64)  # complement all bases
    # reverse 2-bit groups within 64 bits via bit-swaps
    m2 = xp.uint64(0x3333333333333333)
    m4 = xp.uint64(0x0F0F0F0F0F0F0F0F)
    m8 = xp.uint64(0x00FF00FF00FF00FF)
    m16 = xp.uint64(0x0000FFFF0000FFFF)
    x = ((x >> xp.uint64(2)) & m2) | ((x & m2) << xp.uint64(2))
    x = ((x >> xp.uint64(4)) & m4) | ((x & m4) << xp.uint64(4))
    x = ((x >> xp.uint64(8)) & m8) | ((x & m8) << xp.uint64(8))
    x = ((x >> xp.uint64(16)) & m16) | ((x & m16) << xp.uint64(16))
    x = (x >> xp.uint64(32)) | (x << xp.uint64(32))
    return (x >> xp.uint64(64 - 2 * k)).astype(xp.uint64)


def canonicalize_kmers(kmers, k: int):
    """Return (canonical kmer, was_forward) — min of kmer and its revcomp.

    Matches reference canonicalize (modules/bio_base/kmer.cpp): ties
    (palindromes) count as forward.
    """
    xp = jnp if isinstance(kmers, jnp.ndarray) else np
    rc = revcomp_kmer(kmers, k)
    fwd = kmers <= rc
    return xp.where(fwd, kmers, rc), fwd


def kmer_to_seq(kmer: int, k: int) -> str:
    out = []
    for i in range(k):
        out.append("ACGT"[(int(kmer) >> (2 * (k - 1 - i))) & 3])
    return "".join(out)
