"""Multi-device tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from biograph_jax.core import dna
from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.parallel.mesh import make_mesh, sharded_pileup_step
from biograph_jax.parallel.sharded_seqset import (
    ShardedRankArrays,
    make_sharded_rank,
    sharded_entry_push_front,
)


@pytest.fixture(scope="module")
def small_seqset(rngm=None):
    rng = np.random.default_rng(5)
    reads = [
        "".join(rng.choice(list("ACGT"), size=30)) for _ in range(60)
    ]
    L = 30
    codes = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        codes[i] = dna.seq_to_codes(r)
    lens = np.full(len(reads), L, np.int32)
    return build_seqset(codes, lens), codes, lens


def test_sharded_rank_matches_local(small_seqset):
    ss, codes, lens = small_seqset
    n_dev = len(jax.devices())
    assert n_dev >= 8, "conftest should provide 8 virtual devices"
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:8]), ("model",))
    arrays = ShardedRankArrays.build(ss, 8)
    rank_fn = make_sharded_rank(mesh, "model")

    rng = np.random.default_rng(1)
    pos = rng.integers(0, ss.n_entries + 1, size=200)
    b = rng.integers(0, 4, size=200)
    got = np.asarray(
        rank_fn(
            jnp.asarray(arrays.words),
            jnp.asarray(arrays.cum),
            jnp.asarray(arrays.lo),
            jnp.asarray(b),
            jnp.asarray(pos),
        )
    )
    expect = np.asarray(ss.d.rank(jnp.asarray(b), jnp.asarray(pos)))
    assert (got == expect).all()


def test_sharded_push_front_chain(small_seqset):
    """find_existing via the sharded collective rank == local result."""
    ss, codes, lens = small_seqset
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:8]), ("model",))
    arrays = ShardedRankArrays.build(ss, 8)
    rank_fn = make_sharded_rank(mesh, "model")

    B, L = codes.shape
    entry = jnp.zeros((B,), jnp.int64)
    for i in range(L):
        pos = lens - 1 - i
        bidx = codes[np.arange(B), np.maximum(pos, 0)].astype(np.int32)
        nxt = sharded_entry_push_front(rank_fn, arrays, entry, jnp.asarray(bidx))
        entry = jnp.where(jnp.asarray(pos >= 0), nxt, entry)
    expect = ss.d.find_existing(jnp.asarray(codes), jnp.asarray(lens))
    assert (np.asarray(entry) == np.asarray(expect)).all()


def test_sharded_pileup_2d_mesh():
    from jax.sharding import Mesh
    from biograph_jax.variants.align import RefKmerIndex

    rng = np.random.default_rng(2)
    G, k = 2048, 16
    ref_codes = rng.integers(0, 4, size=G, dtype=np.uint8)
    idx = RefKmerIndex.build(ref_codes, k)
    R, L = 16, 32
    starts = rng.integers(0, G - L, size=R)
    codes = np.stack([ref_codes[s : s + L] for s in starts]).astype(np.uint8)
    lengths = np.full(R, L, np.int32)
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("data", "model"))
    step = sharded_pileup_step(
        mesh, jnp.asarray(idx.kmers), jnp.asarray(idx.positions),
        jnp.asarray(ref_codes), k,
    )
    counts = np.asarray(
        step(
            jnp.asarray(idx.kmers),
            jnp.asarray(idx.positions),
            jnp.asarray(ref_codes),
            jnp.asarray(codes),
            jnp.asarray(lengths),
        )
    )
    assert counts.sum() == R * L
