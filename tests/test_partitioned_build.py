"""Memory-bounded prefix-partitioned seqset construction.

The reference never holds the full suffix set (part_repo 4^d buckets +
expander passes, modules/build_seqset/part_repo.h:9, expand.h:22-40); the
device analog sorts prefix partitions in passes sized to a memory budget.  The
gate: the partitioned path must produce bit-identical structures to the
one-shot device sort, under a budget smaller than the suffix working set.
"""

import numpy as np
import pytest

from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.runtime.resources import MemoryBudget


def _assert_same(a, b):
    assert a.n_entries == b.n_entries
    for name in ("entry_sizes", "shared", "fixed", "prev_words", "pop_sel"):
        x = np.asarray(getattr(a, name))
        y = np.asarray(getattr(b, name))
        assert (x == y).all(), name


@pytest.mark.slow
def test_partitioned_matches_oneshot(rng):
    codes = rng.integers(0, 4, (400, 50)).astype(np.uint8)
    lens = rng.integers(20, 51, 400).astype(np.int32)
    codes = np.where(np.arange(50)[None, :] < lens[:, None], codes, 0).astype(
        np.uint8
    )
    full = build_seqset(codes, lens)
    # budget far below the ~400*50*2 suffix rows' working set -> many passes
    small = build_seqset(codes, lens, budget=1 << 20)
    _assert_same(full, small)


def test_partitioned_with_duplicates_and_short_reads(rng):
    rows = [rng.integers(0, 4, 30).astype(np.uint8) for _ in range(40)]
    rows += rows[:10]  # exact duplicate reads
    L = 30
    codes = np.zeros((len(rows), L), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        n = 30 if i % 3 else 7  # some reads shorter than partition depth
        codes[i, :n] = r[:n]
        lens[i] = n
    full = build_seqset(codes, lens)
    small = build_seqset(codes, lens, budget=MemoryBudget(bytes=1 << 16))
    _assert_same(full, small)


@pytest.mark.slow
def test_golden_structural_equivalence_partitioned():
    """The SURVEY §7 bit-exactness gate holds through the partitioned path
    with a budget ~10x smaller than the suffix working set."""
    import jax.numpy as jnp

    from biograph_jax.io.bgimport import open_bg_dir

    ss, rm, _ = open_bg_dir("/root/reference/golden/e_coli_10000snp.bg")
    fwd = np.nonzero(np.asarray(rm.is_forward))[0]
    entries = rm.entry_of_rm[fwd]
    lens = np.asarray(rm.read_lengths)[fwd]
    L = int(lens.max())
    codes = np.zeros((len(fwd), L), np.uint8)
    for lo in range(0, len(fwd), 1 << 14):
        hi = min(len(fwd), lo + (1 << 14))
        codes[lo:hi] = np.asarray(ss.d.sequences(jnp.asarray(entries[lo:hi]), L))
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0).astype(
        np.uint8
    )
    suffix_bytes = int(lens.sum()) * 2 * (3 * 4 + 8) * 4
    ss2 = build_seqset(codes, lens, budget=suffix_bytes // 10)
    _assert_same(ss, ss2)


@pytest.mark.slow
def test_partitioned_streams_memmap_reads(rng, tmp_path):
    """Host-resident (memmap) reads stream through the partitioned build in
    multiple chunks — neither the read matrix nor the suffix set is ever
    device-resident at once — and the result is bit-identical."""
    R, L = 900, 40
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lens = rng.integers(25, 41, R).astype(np.int32)
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0).astype(
        np.uint8
    )
    full = build_seqset(codes, lens)

    mp = np.memmap(str(tmp_path / "reads.u8"), np.uint8, "w+", shape=(R, L))
    mp[:] = codes
    mp.flush()
    ro = np.memmap(str(tmp_path / "reads.u8"), np.uint8, "r", shape=(R, L))
    # budget 1<<17 -> chunk_rows ~200: 5+ chunks of 900 rows, several passes
    small = build_seqset(ro, lens, budget=1 << 17)
    _assert_same(full, small)
