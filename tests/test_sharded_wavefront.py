"""Collective (entry-sharded) seqset ops + wavefront vs the local engine.

SURVEY §7 step 8: the sharded seqset must serve the REAL pipeline, not just
bare rank — push_front_drop and the wavefront step run under shard_map over
the virtual 8-CPU mesh and must match the single-device engine bit-for-bit.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.index.seqset import SeqsetRanges
from biograph_jax.parallel.sharded_seqset import (
    ShardedRankArrays,
    make_sharded_seqset_ops,
)

S = 4  # model shards


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 2000).astype(np.uint8)
    donor = ref.copy()
    donor[1000] = (donor[1000] + 1) % 4
    rows = [donor[s : s + 50] for s in range(0, len(donor) - 50, 3)]
    codes = np.stack(rows).astype(np.uint8)
    lens = np.full(len(rows), 50, np.int32)
    ss = build_seqset(codes, lens)
    devs = np.array(jax.devices("cpu")[:S]).reshape(1, S)
    mesh = Mesh(devs, ("data", "model"))
    arrays = ShardedRankArrays.build(ss, S)
    return ss, ref, mesh, arrays


def _ranges_from_reads(ss, rng, B=32, plen=12):
    ids = rng.integers(0, ss.n_entries, B)
    seqs = np.asarray(ss.d.sequences(jnp.asarray(ids), plen))
    return ss.d.find(jnp.asarray(seqs), jnp.asarray(np.full(B, plen, np.int32)))


def test_collective_ops_bitexact(setup, rng):
    ss, ref, mesh, arrays = setup
    ops = make_sharded_seqset_ops(mesh, ss.n_entries)
    args = arrays.device_args() + (jnp.asarray(arrays.fixed),)
    r = _ranges_from_reads(ss, rng)

    for b in range(4):
        bb = jnp.full(r.begin.shape, b, jnp.int32)
        want = ss.d.push_front(r, bb)
        nb, ne, nsz = ops["push_front"](*args, r.begin, r.end, r.size, bb)
        assert (np.asarray(nb) == np.asarray(want.begin)).all()
        assert (np.asarray(ne) == np.asarray(want.end)).all()
        assert (np.asarray(nsz) == np.asarray(want.size)).all()

    for tgt in (3, 8, 11):
        want = ss.d.truncate_ranges(r, tgt)
        nb, ne, nsz = ops["truncate"](
            *args, r.begin, r.end, r.size, jnp.full(r.size.shape, tgt, jnp.int32)
        )
        assert (np.asarray(nb) == np.asarray(want.begin)).all()
        assert (np.asarray(ne) == np.asarray(want.end)).all()

    # sequential drop-walk along the reference (exercises context drops,
    # lone-short kicks, dead lanes) — 40 steps, compared each step
    B = 16
    begin = jnp.zeros((B,), jnp.int64)
    end = jnp.full((B,), ss.n_entries, jnp.int64)
    size = jnp.zeros((B,), jnp.int32)
    lb, le, ls = begin, end, size
    starts = rng.integers(0, len(ref) - 60, B)
    for i in range(40):
        bases = jnp.asarray(
            3 - ref[starts + i].astype(np.int32)
        )  # complement walk like discovery
        want = ss.d.push_front_drop(SeqsetRanges(lb, le, ls), bases)
        gb, ge, gs = ops["push_front_drop"](*args, lb, le, ls, bases)
        assert (np.asarray(gb) == np.asarray(want.begin)).all(), i
        assert (np.asarray(ge) == np.asarray(want.end)).all(), i
        assert (np.asarray(gs) == np.asarray(want.size)).all(), i
        lb, le, ls = want.begin, want.end, want.size


def test_sharded_wavefront_bitexact(setup, rng):
    """The production sharded wavefront — ShardedDiscoveryEngine.wavefront,
    the seed + early-exit loop the engine-mode _asm_start dispatches — must
    match the single-device _wavefront_jit bit-for-bit."""
    from biograph_jax.parallel.sharded_discovery import ShardedDiscoveryEngine
    from biograph_jax.variants import discover as D

    ss, ref, mesh, arrays = setup
    MAXP, k, min_w, probe_ctx = 64, 13, 1, 25
    span = ref[900:1200]
    n_packed = len(span) - k + 1
    npk = D._next_pow2(len(span))
    packed = D._span_kmers_dev(
        jnp.asarray(span), jnp.asarray(0, jnp.int64),
        jnp.asarray(len(span), jnp.int64), npk, k,
    )

    A = 32
    r = _ranges_from_reads(ss, rng, B=A, plen=probe_ctx)
    seed = dict(
        begin=r.begin,
        end=r.end,
        size=r.size,
        ab=jnp.asarray(np.tile(np.arange(4), A // 4).astype(np.int32)),
        policy=jnp.asarray(np.tile(np.arange(4), A // 4).astype(np.int32)),
        min_local=jnp.full((A,), 5, jnp.int64),
    )
    tt = D._trunc_tables(ss, probe_ctx)
    want = D._wavefront_jit(
        ss.d, packed, tt[0], tt[1], jnp.asarray(n_packed, jnp.int64),
        dict(seed), MAXP, k, min_w, probe_ctx, 10,
    )

    eng = ShardedDiscoveryEngine(ss, mesh)
    ett = eng.trunc_tables(probe_ctx)
    got = eng.wavefront(
        packed, ett[0], ett[1], n_packed, dict(seed),
        MAXP, k, min_w, probe_ctx, 10,
    )
    # some lanes must actually have rejoined for this to be a real test
    assert int((np.asarray(want["rejoin"]) >= 0).sum()) > 0
    for name in want:
        assert (
            np.asarray(got[name]) == np.asarray(want[name])
        ).all(), name


def test_block_wavefront_bitexact(setup, rng):
    """The interleaved driver's chunked early-exit wavefront must match the
    single-program while_loop engine bit-for-bit, for every chunk size
    alignment."""
    from biograph_jax.variants import discover as D

    ss, ref, mesh, arrays = setup
    MAXP, k, min_w, probe_ctx = 64, 13, 1, 25
    span = ref[900:1200]
    n_packed = len(span) - k + 1
    npk = D._next_pow2(len(span))
    packed = D._span_kmers_dev(
        jnp.asarray(span), jnp.asarray(0, jnp.int64),
        jnp.asarray(len(span), jnp.int64), npk, k,
    )

    A = 32
    r = _ranges_from_reads(ss, rng, B=A, plen=probe_ctx)
    seed = dict(
        begin=r.begin,
        end=r.end,
        size=r.size,
        ab=jnp.asarray(np.tile(np.arange(4), A // 4).astype(np.int32)),
        policy=jnp.asarray(np.tile(np.arange(4), A // 4).astype(np.int32)),
        min_local=jnp.full((A,), 5, jnp.int64),
    )
    tt = D._trunc_tables(ss, probe_ctx)
    st0 = D._wavefront_seed_jit(ss.d, seed, MAXP)
    want = D._wavefront_loop_jit(
        ss.d, packed, tt[0], tt[1], jnp.asarray(n_packed, jnp.int64),
        {k_: v for k_, v in st0.items()}, MAXP, k, min_w, probe_ctx,
    )
    for block in (1, 7, 16):
        st = {k_: v for k_, v in st0.items()}
        step = 1
        while step < MAXP:
            n = min(block, MAXP - step)
            st = D._wavefront_chunk_jit(
                ss.d, packed, tt[0], tt[1], jnp.asarray(n_packed, jnp.int64),
                st, jnp.int32(step), n, MAXP, k, min_w, probe_ctx,
            )
            step += n
        for name in want:
            assert (
                np.asarray(st[name]) == np.asarray(want[name])
            ).all(), (block, name)


def test_distributed_init_single_process():
    """task_mgr_local-style: the multi-host bring-up path runs one-process."""
    from biograph_jax.parallel.distributed import global_mesh, initialize

    ctx = initialize(num_processes=1)
    assert ctx.num_processes == 1 and not ctx.initialized
    mesh = global_mesh({"data": -1, "model": 4})
    assert mesh.devices.size == len(jax.devices())
    assert mesh.shape["model"] == 4
