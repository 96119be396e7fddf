"""Multi-sample seqset merge + readmap migration.

Counterpart of the reference's merge machinery (modules/biograph/
biograph_merge.cpp:33, modules/bio_base/make_mergemap.h:47, seqset_merger.h:13,
make_readmap::migrate, make_readmap.h:27): several samples' seqsets combine
into one merged seqset, and each sample's readmap is re-pointed at it.

With the sort-based build this is one device pass: concatenate every input's
entry sequences, sort, drop non-prefix-maximal rows (the merge invariant from
make_mergemap.h:28-36: if X is a prefix of Y only Y survives), rebuild the
rank structures, and compute each input's mergemap as a batched lower_bound
of its entries into the merged order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import jax.numpy as jnp

from biograph_jax.core import dna
from biograph_jax.build.seqset_build import seqset_from_entries, _entries_from_suffixes
from biograph_jax.build.readmap_build import reconstruct_entry_words
from biograph_jax.index.readmap import Readmap
from biograph_jax.index.seqset import Seqset
from biograph_jax.ops import sortutil


def merge_seqsets(seqsets: List[Seqset]) -> Tuple[Seqset, List[np.ndarray]]:
    """Merge seqsets; returns (merged, mergemaps).

    mergemaps[i][e] = merged entry id that input i's entry e maps to (the
    merged entry having input entry e's sequence as a prefix) — the rank/
    position form of the reference's mergemap bitcounts
    (seqset_mergemap.h:21)."""
    words_list = []
    lens_list = []
    for ss in seqsets:
        w, l = reconstruct_entry_words(ss)
        words_list.append(np.asarray(w))
        lens_list.append(np.asarray(l))
    W = max(w.shape[1] for w in words_list)
    words = np.concatenate(
        [np.pad(w, ((0, 0), (0, W - w.shape[1]))) for w in words_list]
    )
    lens = np.concatenate(lens_list)
    ew, el, n_entries = _entries_from_suffixes(
        jnp.asarray(words), jnp.asarray(lens)
    )
    # NOTE: inputs are already suffix-closed so their union is too; only
    # dedup + prefix-maximality are needed (which _entries_from_suffixes does)
    ew = ew[:n_entries]
    el = el[:n_entries]
    merged = seqset_from_entries(ew, el)
    mergemaps = []
    for w, l in zip(words_list, lens_list):
        wp = np.pad(w, ((0, 0), (0, W - w.shape[1])))
        mm = np.asarray(
            sortutil.merge_lower_bound(
                ew, el, jnp.asarray(wp), jnp.asarray(l.astype(np.int32))
            ),
            np.int64,
        )
        mergemaps.append(mm)
    return merged, mergemaps


def migrate_readmap(rm: Readmap, merged: Seqset, mergemap: np.ndarray) -> Readmap:
    """Re-point a readmap at the merged seqset (make_readmap::migrate)."""
    old_entry = rm.entry_of_rm  # [n_rm] entry ids in the old seqset
    new_entry = mergemap[old_entry]
    order = np.lexsort(
        (np.arange(rm.num_entries), rm.read_lengths, new_entry)
    )
    n = merged.n_entries
    counts = np.bincount(new_entry[order], minlength=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    inv = np.empty(rm.num_entries, np.int64)
    inv[order] = np.arange(rm.num_entries)
    return Readmap(
        seqset=merged,
        offsets=offsets,
        read_lengths=np.asarray(rm.read_lengths)[order],
        is_forward=np.asarray(rm.is_forward)[order],
        mate_pair_ptr=inv[np.asarray(rm.mate_pair_ptr)[order]],
        read_ids=np.asarray(rm.read_ids)[order],
    )
