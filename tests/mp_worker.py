"""Worker for the 2-process jax.distributed test (tests/test_multiprocess.py).

Each process owns 2 virtual CPU devices; the 4-way 'model' mesh spans both
processes, so every collective seqset op really crosses a process boundary
(gloo CPU collectives — the DCN stand-in).  This is the multi-host analog of
the reference testing its distributed runtime through task_mgr_local
(modules/mapred/task_mgr.h:60): same production code path, local processes.

Usage: python mp_worker.py <process_id> <num_processes> <coordinator>
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
os.environ.setdefault("BGT_NO_COMPILE_CACHE", "1")

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.index.seqset import SeqsetRanges
from biograph_jax.parallel.distributed import global_mesh, initialize
from biograph_jax.parallel.sharded_seqset import (
    ShardedRankArrays,
    make_sharded_seqset_ops,
)


def main():
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    ctx = initialize(coordinator=coord, num_processes=nproc, process_id=pid)
    assert ctx.initialized and ctx.num_processes == nproc, ctx
    mesh = global_mesh({"model": -1})
    S = mesh.shape["model"]
    assert S == nproc * 2, (S, jax.device_count())

    # identical deterministic inputs on every process (each host reading the
    # same immutable artifact, as in a real run)
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 1200).astype(np.uint8)
    rows = [ref[s : s + 40] for s in range(0, len(ref) - 40, 5)]
    codes = np.stack(rows).astype(np.uint8)
    lens = np.full(len(rows), 40, np.int32)
    ss = build_seqset(codes, lens)

    arrays = ShardedRankArrays.build(ss, S)
    args = arrays.device_args_global(mesh) + (np.asarray(arrays.fixed),)
    ops = make_sharded_seqset_ops(mesh, ss.n_entries)

    # local single-device truth (full structure on this process's device 0)
    ids = rng.integers(0, ss.n_entries, 16)
    plen = 12
    seqs = np.asarray(ss.d.sequences(jnp.asarray(ids), plen))
    r = ss.d.find(jnp.asarray(seqs), jnp.asarray(np.full(16, plen, np.int32)))

    def fetch(x):
        return np.asarray(jax.device_get(x.addressable_shards[0].data))

    for b in range(4):
        bb = np.full(r.begin.shape, b, np.int32)
        want = ss.d.push_front(r, jnp.asarray(bb))
        nb, ne, nsz = ops["push_front"](
            *args, np.asarray(r.begin), np.asarray(r.end), np.asarray(r.size), bb
        )
        assert (fetch(nb) == np.asarray(want.begin)).all(), ("push b", b)
        assert (fetch(ne) == np.asarray(want.end)).all(), ("push e", b)
        assert (fetch(nsz) == np.asarray(want.size)).all(), ("push s", b)

    # drop-walk along the reference: exercises the collective while_loop
    B = 8
    lb = jnp.zeros((B,), jnp.int64)
    le = jnp.full((B,), ss.n_entries, jnp.int64)
    ls = jnp.zeros((B,), jnp.int32)
    starts = rng.integers(0, len(ref) - 40, B)
    for i in range(20):
        bases = (3 - ref[starts + i]).astype(np.int32)
        want = ss.d.push_front_drop(SeqsetRanges(lb, le, ls), jnp.asarray(bases))
        gb, ge, gs = ops["push_front_drop"](
            *args, np.asarray(lb), np.asarray(le), np.asarray(ls), bases
        )
        assert (fetch(gb) == np.asarray(want.begin)).all(), ("drop b", i)
        assert (fetch(ge) == np.asarray(want.end)).all(), ("drop e", i)
        assert (fetch(gs) == np.asarray(want.size)).all(), ("drop s", i)
        lb, le, ls = want.begin, want.end, want.size

    # --- region-sharded distributed discovery: every process traces its
    # overlapping slice, parts merge through the shared run dir, and the
    # merged records equal the single-process engine's bit-for-bit
    # (parallel/discovery.py; trace_ref chunk scheduling over hosts) ---
    import tempfile

    from biograph_jax.build.readmap_build import build_readmap
    from biograph_jax.index.reference import Contig
    from biograph_jax.parallel.discovery import discover_variants_distributed
    from biograph_jax.variants.discover import DiscoverOptions, discover_variants

    class _Ref:
        def __init__(self, codes):
            self.flat = np.asarray(codes, np.uint8)
            self.is_n = np.zeros(len(codes), bool)
            self.contigs = [Contig(name="c", start=0, length=len(codes))]

        def contig_by_name(self, name):
            return self.contigs[0]

    donor = ref.copy()
    for p in (200, 600, 950):  # planted SNPs
        donor[p] = (donor[p] + 1) % 4
    rows_d = [donor[s : s + 40] for s in range(0, len(donor) - 40, 2)]
    codes_d = np.stack(rows_d).astype(np.uint8)
    # alternate strands so every locus sees both (directional penalty is on)
    codes_d[::2] = (3 - codes_d[::2])[:, ::-1]
    lens_d = np.full(len(rows_d), 40, np.int32)
    ss_d = build_seqset(codes_d, lens_d)
    rm_d = build_readmap(ss_d, codes_d, lens_d)
    rref = _Ref(ref)
    opt = DiscoverOptions(min_alt_support=5)
    want = discover_variants(ss_d, rref, opt=opt, readmap=rm_d)
    run_dir = os.path.join(tempfile.gettempdir(), f"bgt_mp_disc_{coord.split(':')[1]}")
    got = discover_variants_distributed(
        ss_d, rref, run_dir, opt=opt, readmap=rm_d
    )
    keyf = lambda r: (r["chrom"], r["pos"], r["ref"], r["alt"], r["support"])
    assert sorted(map(keyf, got)) == sorted(map(keyf, want)), (
        len(got), len(want),
    )
    snps = {r["pos"] - 1 for r in got}
    assert {200, 600, 950} <= snps, snps

    # --- read-sliced distributed SV discovery: each process scans only its
    # slice of the readmap's forward reads; merged finalize must equal the
    # single-pass engine exactly (parallel/discovery.py
    # discover_structural_distributed) ---
    from biograph_jax.parallel.discovery import discover_structural_distributed
    from biograph_jax.variants.pop_tracer import (
        SvOptions,
        discover_structural,
        reads_from_readmap,
    )

    sv_ref = rng.integers(0, 4, 9000).astype(np.uint8)
    dlo, dhi = 4000, 4500  # 500 bp deletion
    sv_donor = np.concatenate([sv_ref[:dlo], sv_ref[dhi:]])
    n_pairs, rl, frag = 1500, 80, 240
    starts = rng.integers(0, len(sv_donor) - frag, n_pairs)
    sv_codes = np.zeros((2 * n_pairs, rl), np.uint8)
    for i, s in enumerate(starts):
        sv_codes[2 * i] = sv_donor[s : s + rl]
        sv_codes[2 * i + 1] = (3 - sv_donor[s + frag - rl : s + frag])[::-1]
    sv_lens = np.full(2 * n_pairs, rl, np.int32)
    ss_sv = build_seqset(sv_codes, sv_lens)
    rm_sv = build_readmap(ss_sv, sv_codes, sv_lens)
    sv_rref = _Ref(sv_ref)
    svopt = SvOptions()
    c_all, l_all, m_all = reads_from_readmap(rm_sv)
    sv_want = discover_structural(sv_rref, c_all, l_all, mate_of=m_all, opt=svopt)
    sv_dir = os.path.join(tempfile.gettempdir(), f"bgt_mp_sv_{coord.split(':')[1]}")
    sv_got = discover_structural_distributed(rm_sv, sv_rref, sv_dir, opt=svopt)
    assert sv_got == sv_want, (len(sv_got), len(sv_want))
    assert any(
        len(r["ref"]) - len(r["alt"]) == dhi - dlo for r in sv_got
    ), sv_got

    print(f"MP_OK pid={pid} procs={jax.process_count()} devs={jax.device_count()}")


if __name__ == "__main__":
    main()
