"""Entry-sharded seqset serving PRODUCTION discovery (VERDICT r3 #2).

The ShardedDiscoveryEngine runs every seqset-touching discovery stage
(probe chains, exact recompute, anchor scan, wavefront) over the
entry-sharded structure on the 8-virtual-device 'model' mesh, reusing the
local pipeline's stage functions verbatim through the shard-local adapter
device — so these tests assert full VCF-record EQUALITY with the local
engine, on synthetic data and on the golden E. coli region (the reference's
memory-bounded seqset contract, modules/bio_base/seqset.h:20 +
part_repo.h:9, rebuilt as mesh sharding)."""

import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from biograph_jax.build.readmap_build import build_readmap
from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.index.reference import Contig
from biograph_jax.parallel.sharded_discovery import ShardedDiscoveryEngine
from biograph_jax.variants.discover import DiscoverOptions, discover_variants


class FakeRef:
    def __init__(self, codes):
        self.flat = np.asarray(codes, np.uint8)
        self.is_n = np.zeros(len(codes), bool)
        self.contigs = [Contig(name="chr1", start=0, length=len(codes))]

    def contig_by_name(self, name):
        return self.contigs[0]


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(-1), ("model",))


_KEY = lambda r: (r["chrom"], r["pos"], r["ref"], r["alt"], r["support"])


@pytest.mark.slow
def test_sharded_engine_matches_local_synthetic():
    rng = np.random.default_rng(7)
    G = 4000
    ref = rng.integers(0, 4, G).astype(np.uint8)
    donor = ref.copy()
    planted = (700, 1900, 3100)
    for p in planted:
        donor[p] = (donor[p] + 1) % 4
    # a small insertion + deletion exercise the multi-step beam
    donor = np.concatenate(
        [donor[:2500], rng.integers(0, 4, 4).astype(np.uint8), donor[2500:]]
    )
    L = 40
    starts = rng.integers(0, len(donor) - L, 2600)
    codes = np.stack([donor[s : s + L] for s in starts])
    codes[::2] = (3 - codes[::2])[:, ::-1]
    lens = np.full(len(codes), L, np.int32)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    rref = FakeRef(ref)
    opt = DiscoverOptions(min_alt_support=5)
    want = discover_variants(ss, rref, opt=opt, readmap=rm)
    assert {p + 1 for p in planted} <= {r["pos"] for r in want}
    eng = ShardedDiscoveryEngine(ss, _mesh())
    got = discover_variants(ss, rref, opt=opt, readmap=rm, engine=eng)
    assert sorted(map(_KEY, got)) == sorted(map(_KEY, want))


@pytest.mark.slow
def test_sharded_engine_matches_local_golden_ecoli():
    """Golden-data gate: discovery over the E. coli test region with the
    seqset entry-sharded across all 8 virtual devices produces records
    identical to the local engine."""
    from biograph_jax.index.reference import Reference
    from biograph_jax.io.fastq import read_fastq

    batch = read_fastq("/root/reference/golden/e_coli_10000snp.fq")
    ss = build_seqset(batch.codes, batch.lengths)
    rm = build_readmap(ss, batch.codes, batch.lengths)
    ref = Reference.from_reference_dir(
        "/root/reference/datasets/reference/e_coli_k12_ASM584v1"
    )
    opt = DiscoverOptions(min_alt_support=5)
    c = ref.contig_by_name("Chromosome")
    region = (c.start, c.start + 12000)
    want = discover_variants(ss, ref, region=region, opt=opt, readmap=rm)
    assert want, "local engine should call variants in the region"
    eng = ShardedDiscoveryEngine(ss, _mesh())
    got = discover_variants(ss, ref, region=region, opt=opt, readmap=rm, engine=eng)
    assert sorted(map(_KEY, got)) == sorted(map(_KEY, want))


def test_adapter_primitives_match_local():
    """rank4 / push4 / trunc_gather of the shard-local adapter agree with
    the single-device engine on random queries."""
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from biograph_jax.index.seqset import SeqsetRanges
    from biograph_jax.parallel.sharded_discovery import _ShardLocalDevice
    from biograph_jax.parallel.sharded_seqset import ShardedRankArrays
    from biograph_jax.variants.discover import _trunc_tables

    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=(300, 32), dtype=np.uint8)
    ss = build_seqset(codes, np.full(300, 32, np.int32))
    mesh = _mesh()
    S = mesh.shape["model"]
    arrays = ShardedRankArrays.build(ss, S)
    args = arrays.device_args_global(mesh)
    n = ss.n_entries
    ids = rng.integers(0, n, 64)
    plen = 10
    seqs = np.asarray(ss.d.sequences(jnp.asarray(ids), plen))
    r = ss.d.find(jnp.asarray(seqs), jnp.asarray(np.full(64, plen, np.int32)))
    want_nb, want_ne = ss.d.push4(r)
    prev_lt, next_lt = (np.asarray(t) for t in _trunc_tables(ss, 8))
    Re = arrays.shared.shape[1]
    pl2 = np.full(Re * S, -1, np.int64)
    pl2[:n] = prev_lt
    nl2 = np.full(Re * S, n, np.int64)
    nl2[:n] = next_lt
    want_tb, want_te = (
        np.asarray(x)
        for x in ss.d.trunc_gather(
            jnp.asarray(prev_lt), jnp.asarray(next_lt), r.begin, r.end
        )
    )

    def f(words, cum, lo, shared, sizes, pop_sel, elo, fixed, plt, nlt, b, e, s):
        d = _ShardLocalDevice(
            words, cum, lo, shared, sizes, pop_sel, elo, fixed, n, "model"
        )
        nb, ne = d.push4(SeqsetRanges(b, e, s))
        tb, te = d.trunc_gather(plt, nlt, b, e)
        return nb, ne, tb, te

    fn = jax.jit(
        shard_map(
            f,
            mesh=mesh,
            in_specs=(P("model"),) * 7 + (P(),) + (P("model"),) * 2 + (P(),) * 3,
            out_specs=P(),
        )
    )
    got_nb, got_ne, got_tb, got_te = fn(
        *args,
        jnp.asarray(arrays.fixed),
        pl2.reshape(S, Re),
        nl2.reshape(S, Re),
        r.begin,
        r.end,
        r.size,
    )
    np.testing.assert_array_equal(np.asarray(got_nb), np.asarray(want_nb))
    np.testing.assert_array_equal(np.asarray(got_ne), np.asarray(want_ne))
    np.testing.assert_array_equal(np.asarray(got_tb), want_tb)
    np.testing.assert_array_equal(np.asarray(got_te), want_te)
