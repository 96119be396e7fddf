"""User-facing SDK objects.

Counterpart of the reference Python SDK (python/biograph/__init__.py:33-47:
BioGraph, Seqset, Readmap, Reference, Sequence; SeqsetEntry generators).
``BioGraph(path)`` opens either this package's ``.bgt`` artifact dirs or the
reference's original ``.bg`` spiral_file dirs (auto-detected), so existing
BioGraph archives work unmodified.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from biograph_jax.core import dna


class Sequence:
    """An immutable DNA sequence (reference: python/biograph Sequence)."""

    def __init__(self, seq):
        if isinstance(seq, str):
            self._codes = dna.seq_to_codes(seq)
        else:
            self._codes = np.asarray(seq, np.uint8)

    @property
    def codes(self) -> np.ndarray:
        return self._codes

    def __len__(self):
        return len(self._codes)

    def __str__(self):
        return dna.codes_to_seq(self._codes)

    def __repr__(self):
        return f"Sequence({str(self)!r})"

    def __eq__(self, other):
        if isinstance(other, str):
            return str(self) == other
        return isinstance(other, Sequence) and np.array_equal(
            self._codes, other._codes
        )

    def rev_comp(self) -> "Sequence":
        return Sequence(np.asarray(dna.revcomp_codes(self._codes)))

    def __getitem__(self, sl):
        return Sequence(self._codes[sl])


class SeqsetEntry:
    """A seqset range with navigation — the SDK analog of seqset_range
    (modules/bio_base/seqset.h:207; python/biograph SeqsetEntry)."""

    def __init__(self, seqset, begin: int, end: int, size: int):
        self._ss = seqset
        self.begin = int(begin)
        self.end = int(end)
        self.size = int(size)

    @property
    def valid(self) -> bool:
        return self.begin < self.end

    def sequence(self, length: int | None = None) -> Sequence:
        n = self.size if length is None else min(length, self.size)
        import jax.numpy as jnp

        codes = self._ss.d.sequences(jnp.asarray([self.begin]), max(n, 1))
        return Sequence(np.asarray(codes[0, :n]))

    def push_front(self, base: str) -> "SeqsetEntry":
        import jax.numpy as jnp
        from biograph_jax.index.seqset import SeqsetRanges

        b = int(dna.seq_to_codes(base)[0])
        r = self._ss.d.push_front(
            SeqsetRanges(
                jnp.asarray([self.begin]),
                jnp.asarray([self.end]),
                jnp.asarray([self.size], jnp.int32),
            ),
            jnp.asarray([b], jnp.int32),
        )
        return SeqsetEntry(self._ss, int(r.begin[0]), int(r.end[0]), int(r.size[0]))

    def pop_front(self) -> "SeqsetEntry":
        import jax.numpy as jnp
        from biograph_jax.index.seqset import SeqsetRanges

        r = self._ss.d.pop_front_ranges(
            SeqsetRanges(
                jnp.asarray([self.begin]),
                jnp.asarray([self.end]),
                jnp.asarray([self.size], jnp.int32),
            )
        )
        return SeqsetEntry(self._ss, int(r.begin[0]), int(r.end[0]), int(r.size[0]))

    def truncate(self, new_size: int) -> "SeqsetEntry":
        import jax.numpy as jnp
        from biograph_jax.index.seqset import SeqsetRanges

        r = self._ss.d.truncate_ranges(
            SeqsetRanges(
                jnp.asarray([self.begin]),
                jnp.asarray([self.end]),
                jnp.asarray([self.size], jnp.int32),
            ),
            new_size,
        )
        return SeqsetEntry(self._ss, int(r.begin[0]), int(r.end[0]), int(r.size[0]))

    def __repr__(self):
        return f"SeqsetEntry([{self.begin},{self.end}), size={self.size})"


class ReadmapRead:
    """Handle on one readmap entry (reference ReadmapRead analog,
    python/biograph/__init__.py exports; readmap.h:240 readmap::read)."""

    def __init__(self, readmap, rm_id: int):
        self._rm = readmap
        self.rm_id = int(rm_id)

    @property
    def length(self) -> int:
        return int(self._rm.read_lengths[self.rm_id])

    @property
    def is_forward(self) -> bool:
        return bool(self._rm.is_forward[self.rm_id])

    @property
    def read_id(self) -> int:
        return int(self._rm.read_ids[self.rm_id])

    @property
    def entry_id(self) -> int:
        return int(self._rm.entry_of_rm[self.rm_id])

    def sequence(self) -> Sequence:
        import jax.numpy as jnp

        codes = self._rm.seqset.d.sequences(
            jnp.asarray([self.entry_id], jnp.int64), self.length
        )
        return Sequence(np.asarray(codes)[0][: self.length])

    def rev_comp(self) -> "ReadmapRead":
        rc = int(np.asarray(self._rm.get_rev_comp(np.asarray([self.rm_id])))[0])
        return ReadmapRead(self._rm, rc)

    def mate(self) -> "ReadmapRead | None":
        if not bool(np.asarray(self._rm.has_mate(np.asarray([self.rm_id])))[0]):
            return None
        m = int(np.asarray(self._rm.get_mate(np.asarray([self.rm_id])))[0])
        return ReadmapRead(self._rm, m)

    def __repr__(self):
        return (
            f"ReadmapRead(rm_id={self.rm_id}, len={self.length}, "
            f"{'fwd' if self.is_forward else 'rev'})"
        )


class ReferenceRange:
    """A [start, end) window of one reference contig (ReferenceRange analog)."""

    def __init__(self, reference, contig: str, start: int, end: int):
        self._ref = reference
        self.contig = contig
        self.start = int(start)
        self.end = int(end)

    @property
    def size(self) -> int:
        return self.end - self.start

    def sequence(self) -> Sequence:
        return Sequence(self._ref.get_codes(self.contig, self.start, self.end))

    def __repr__(self):
        return f"ReferenceRange({self.contig}:{self.start}-{self.end})"


class BioGraph:
    """Open a sample archive: .bgt (this package) or .bg (reference format)."""

    def __init__(self, path: str):
        from biograph_jax.index.seqset import Seqset
        from biograph_jax.index.readmap import Readmap
        from biograph_jax.core import container

        self.path = path
        self.metadata = {}
        self.readmap: Optional[Readmap] = None

        bgt_seqset = os.path.join(path, "seqset")
        if container.exists(bgt_seqset):
            # native .bgt layout
            meta_path = os.path.join(path, "metadata.json")
            if os.path.isfile(meta_path):
                self.metadata = json.load(open(meta_path))
            self.seqset = Seqset.load(bgt_seqset)
            rm_path = os.path.join(path, "readmap")
            if os.path.isdir(rm_path):
                self.readmap = Readmap.load(rm_path, self.seqset)
        elif os.path.isfile(bgt_seqset):
            # reference .bg layout (spiral_file ZIP members)
            from biograph_jax.io.bgimport import open_bg_dir

            self.seqset, self.readmap, self.metadata = open_bg_dir(path)
        else:
            raise FileNotFoundError(f"{path}: no seqset found (.bgt or .bg)")

    # ----- queries (reference python/biograph/__init__.py API surface) -----

    def find(self, seq) -> SeqsetEntry:
        """Find a sequence; returns a (possibly invalid) SeqsetEntry."""
        if isinstance(seq, Sequence):
            seq = str(seq)
        b, e, s = self.seqset.find_str(seq)
        return SeqsetEntry(self.seqset, b, e, s)

    def entry(self, entry_id: int) -> SeqsetEntry:
        """ctx_entry analog: the range of one full seqset entry."""
        return SeqsetEntry(
            self.seqset, entry_id, entry_id + 1, int(self.seqset.entry_sizes[entry_id])
        )

    def seq_coverage(self, seq):
        """Per-base read coverage of a sequence (fwd+rev), via the readmap."""
        if self.readmap is None:
            raise ValueError("no readmap")
        import jax.numpy as jnp

        if isinstance(seq, Sequence):
            codes = seq.codes
        elif isinstance(seq, str):
            codes = dna.seq_to_codes(seq)
        else:
            codes = np.asarray(seq, np.uint8)
        f, r = self.readmap.coverage(
            jnp.asarray(codes[None, :]), jnp.asarray([len(codes)], jnp.int32)
        )
        return np.asarray(f + r)[0]

    def read(self, rm_id: int) -> ReadmapRead:
        """Handle on one readmap entry."""
        if self.readmap is None:
            raise ValueError("no readmap")
        return ReadmapRead(self.readmap, rm_id)

    def pair_stats(self) -> dict:
        """ReadmapPairStats analog: paired/unpaired read + base counts."""
        if self.readmap is None:
            raise ValueError("no readmap")
        return self.readmap.get_pair_stats()

    @property
    def num_reads(self) -> int:
        return self.readmap.read_count if self.readmap else 0

    def __repr__(self):
        return (
            f"BioGraph({self.path!r}: {self.seqset.n_entries} entries, "
            f"{self.num_reads} reads)"
        )
