import numpy as np
import jax.numpy as jnp
import pytest

from biograph_jax.core import dna
from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.build.readmap_build import build_readmap


def _revcomp_str(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _reads_to_arrays(reads):
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = dna.seq_to_codes(r)
        lens[i] = len(r)
    return codes, lens


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(7)
    reads = [
        "".join(rng.choice(list("ACGT"), size=20)) for _ in range(40)
    ]
    # mates: read 2i paired with 2i+1, last 4 unpaired
    mate_of = np.full(len(reads), -1, np.int64)
    for i in range(0, len(reads) - 4, 2):
        mate_of[i] = i + 1
        mate_of[i + 1] = i
    codes, lens = _reads_to_arrays(reads)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens, mate_of)
    return reads, mate_of, codes, lens, ss, rm


def test_entry_counts(sample):
    reads, mate_of, codes, lens, ss, rm = sample
    assert rm.num_entries == 2 * len(reads)
    assert rm.read_count == len(reads)
    assert rm.offsets[-1] == rm.num_entries


def test_entries_point_at_read_prefixed_entries(sample):
    reads, mate_of, codes, lens, ss, rm = sample
    ent = rm.entry_of_rm
    for rm_id in range(rm.num_entries):
        read_idx = rm.read_ids[rm_id]
        s = reads[read_idx]
        if not rm.is_forward[rm_id]:
            s = _revcomp_str(s)
        entry_seq = ss.entry_sequence(int(ent[rm_id]))
        assert entry_seq.startswith(s)
        assert rm.read_lengths[rm_id] == len(s)


def test_mate_loop(sample):
    reads, mate_of, codes, lens, ss, rm = sample
    ids = jnp.arange(rm.num_entries)
    rc = np.asarray(rm.get_rev_comp(ids))
    mate = np.asarray(rm.get_mate(ids))
    has = np.asarray(rm.has_mate(ids))
    for rm_id in range(rm.num_entries):
        ridx = rm.read_ids[rm_id]
        # rev comp flips orientation, same read
        assert rm.read_ids[rc[rm_id]] == ridx
        assert rm.is_forward[rc[rm_id]] != rm.is_forward[rm_id]
        if mate_of[ridx] >= 0:
            assert has[rm_id]
            assert rm.read_ids[mate[rm_id]] == mate_of[ridx]
        else:
            assert not has[rm_id]
            assert mate[rm_id] == rm_id


def test_pair_stats(sample):
    reads, mate_of, codes, lens, ss, rm = sample
    st = rm.get_pair_stats()
    n_paired = int((mate_of >= 0).sum())
    assert st["paired_reads"] == n_paired
    assert st["unpaired_reads"] == len(reads) - n_paired


def test_coverage_uniform(sample):
    reads, mate_of, codes, lens, ss, rm = sample
    # coverage of a read by itself: every base covered at least once
    q = codes[:6]
    ql = lens[:6]
    fwd, rev = rm.coverage(jnp.asarray(q), jnp.asarray(ql))
    tot = np.asarray(fwd + rev)
    for i in range(6):
        assert (tot[i, : ql[i]] >= 1).all(), tot[i]


def test_coverage_counts_duplicates():
    reads = ["ACGGCATTAA"] * 3 + ["TTACGGCATT"]
    codes, lens = _reads_to_arrays(reads)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    fwd, rev = rm.coverage(jnp.asarray(codes[:1]), jnp.asarray(lens[:1]))
    tot = np.asarray(fwd + rev)[0]
    # the triplicated read covers everything 3x (plus overlap from the other)
    assert (tot >= 3).all()


def test_coverage_hash_probe_matches_chain():
    """The rank-free rolling-hash uniform probe must agree with the rank
    chain path exactly (same b/e/s semantics -> same depths)."""
    import os

    rng = np.random.default_rng(7)
    R, L = 400, 48
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lens = np.full(R, L, np.int32)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    assert rm.window_hash is not None
    q = np.zeros((24, 160), np.uint8)
    ql = np.zeros(24, np.int32)
    for i in range(24):
        s = rng.integers(0, R)
        off = rng.integers(0, 9)
        seq = np.concatenate(
            [rng.integers(0, 4, off), codes[s], rng.integers(0, 4, 160)]
        )[:160]
        q[i] = seq
        ql[i] = rng.integers(60, 160)
    f1, r1 = rm.coverage(jnp.asarray(q), jnp.asarray(ql))
    os.environ["BGT_NO_COV_HASH"] = "1"
    try:
        rm2 = build_readmap(ss, codes, lens)
        f2, r2 = rm2.coverage(jnp.asarray(q), jnp.asarray(ql))
    finally:
        del os.environ["BGT_NO_COV_HASH"]
    assert (np.asarray(f1) == np.asarray(f2)).all()
    assert (np.asarray(r1) == np.asarray(r2)).all()


def test_save_load(tmp_path, sample):
    reads, mate_of, codes, lens, ss, rm = sample
    p = str(tmp_path / "readmap")
    rm.save(p)
    from biograph_jax.index.readmap import Readmap

    rm2 = Readmap.load(p, ss)
    assert rm2.num_entries == rm.num_entries
    assert (np.asarray(rm2.mate_pair_ptr) == np.asarray(rm.mate_pair_ptr)).all()
