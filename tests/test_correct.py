import numpy as np
import jax.numpy as jnp

from biograph_jax.core import dna
from biograph_jax.kmers.count import count_kmers
from biograph_jax.kmers.kmer_set import KmerSet
from biograph_jax.build.correct import correct_reads


def _mk_reads(genome, n, L, rng):
    starts = rng.integers(0, len(genome) - L, size=n)
    return np.stack([genome[s : s + L] for s in starts]), starts


def test_correct_single_errors(rng):
    G = 3000
    genome = rng.integers(0, 4, size=G, dtype=np.uint8)
    L = 50
    reads, _ = _mk_reads(genome, 1200, L, rng)
    lens = np.full(len(reads), L, np.int32)
    counts = count_kmers(reads, lens, k=23)
    ks = KmerSet.from_counts(counts, min_count=3)

    # corrupt 50 reads with one substitution each (not in the first k bases
    # so the anchor stays at 0)
    bad = reads.copy()
    idx = rng.choice(len(reads), size=50, replace=False)
    for i in idx:
        p = rng.integers(25, L)
        bad[i, p] = (bad[i, p] + rng.integers(1, 4)) % 4
    res = correct_reads(ks, bad, lens)
    fixed = 0
    for i in idx:
        if res.lengths[i] == L and (res.codes[i] == reads[i]).all():
            fixed += 1
    assert fixed >= 45, f"only {fixed}/50 corrected"
    # clean reads unchanged
    # clean reads: unchanged up to their (possibly edge-truncated) length —
    # reads near genome ends can lose low-coverage tail k-mers, like the
    # reference's fast_read_correct returning the longest trusted run.
    clean = [i for i in range(len(reads)) if i not in set(idx)]
    full = 0
    for i in clean[:100]:
        n = res.lengths[i]
        assert n >= 23
        assert (res.codes[i, :n] == reads[i][:n]).all()
        full += int(n == L)
    assert full >= 90


def test_uncorrectable_reads_dropped(rng):
    G = 2000
    genome = rng.integers(0, 4, size=G, dtype=np.uint8)
    L = 40
    reads, _ = _mk_reads(genome, 800, L, rng)
    lens = np.full(len(reads), L, np.int32)
    ks = KmerSet.from_counts(count_kmers(reads, lens, k=23), min_count=3)
    junk = rng.integers(0, 4, size=(5, L), dtype=np.uint8)
    res = correct_reads(ks, junk, np.full(5, L, np.int32))
    assert (res.lengths == 0).all()


def test_error_burst_truncates(rng):
    G = 2000
    genome = rng.integers(0, 4, size=G, dtype=np.uint8)
    L = 40
    reads, _ = _mk_reads(genome, 800, L, rng)
    lens = np.full(len(reads), L, np.int32)
    ks = KmerSet.from_counts(count_kmers(reads, lens, k=23), min_count=3)
    bad = reads[:3].copy()
    bad[:, 30:] = rng.integers(0, 4, size=(3, 10), dtype=np.uint8)
    res = correct_reads(ks, bad, np.full(3, L, np.int32), max_corrections=2)
    # reads should be truncated near the burst, not fully dropped
    for i in range(3):
        assert 23 <= res.lengths[i] <= L
        assert (res.codes[i, : min(30, res.lengths[i])] == reads[i][: min(30, res.lengths[i])]).all()


def test_overrep_filter_parity():
    """kmer_passes analog (kmerize_bf.cpp:288-335): BELOW_MIN_COUNT, SKEWED,
    and NEAR_OVERREP (hamming-1 neighborhood of an overrepresented kmer,
    overrep.cpp find_near) with the reference's default thresholds."""
    import numpy as np

    from biograph_jax.core import dna
    from biograph_jax.kmers.count import KmerCounts
    from biograph_jax.kmers.kmer_set import filter_kmer_counts

    k = 23
    rng = np.random.default_rng(5)
    base = np.uint64(rng.integers(0, 1 << (2 * k), dtype=np.uint64))
    # hamming-1 neighbor of `base`: flip base 7
    nb = (base & ~(np.uint64(3) << np.uint64(14))) | (
        ((base >> np.uint64(14)) + np.uint64(1)) & np.uint64(3)
    ) << np.uint64(14)
    far = base ^ np.uint64(0b1111)  # two bases changed -> not near
    normal = np.uint64(rng.integers(0, 1 << (2 * k), dtype=np.uint64))
    kmers = np.sort(np.array([base, nb, far, normal], np.uint64))
    idx = {int(v): i for i, v in enumerate(kmers)}
    fwd = np.zeros(4, np.int64)
    rev = np.zeros(4, np.int64)
    fwd[idx[int(base)]] = 3000; rev[idx[int(base)]] = 3100  # overrep (6100x)
    fwd[idx[int(nb)]] = 4; rev[idx[int(nb)]] = 3            # weak neighbor
    fwd[idx[int(far)]] = 5; rev[idx[int(far)]] = 5
    fwd[idx[int(normal)]] = 20; rev[idx[int(normal)]] = 22
    counts = KmerCounts(k=k, kmers=kmers, fwd=fwd, rev=rev)

    keep, stats = filter_kmer_counts(
        counts, min_count=2, overrep_threshold=1000,
        sys_err_thresh=0.1, rnd_err_thresh=0.005,
    )
    # weak hamming-1 neighbor dies (min 3 < 6100*.005=30.5, max 4 < 610);
    # the overrep kmer itself and the far/normal kmers survive
    assert not keep[idx[int(nb)]]
    assert keep[idx[int(base)]] and keep[idx[int(far)]] and keep[idx[int(normal)]]
    assert stats["NEAR_OVERREP"] == 1 and stats["OVERREP"] == 1

    # a STRONG hamming-1 neighbor survives (fails the rnd threshold)
    fwd[idx[int(nb)]] = 40; rev[idx[int(nb)]] = 35
    keep, _ = filter_kmer_counts(
        counts, min_count=2, overrep_threshold=1000,
    )
    assert keep[idx[int(nb)]]

    # revcomp side: a kmer one substitution from the overrep's REVERSE
    # COMPLEMENT is also near (find_near tries both strands)
    rc = int(np.asarray(dna.revcomp_kmer(np.uint64(base)[None], k))[0])
    rc_nb = np.uint64(rc) ^ np.uint64(2)  # flip base 0
    kmers2 = np.sort(np.array([base, rc_nb], np.uint64))
    i2 = {int(v): i for i, v in enumerate(kmers2)}
    fwd2 = np.zeros(2, np.int64); rev2 = np.zeros(2, np.int64)
    fwd2[i2[int(base)]] = 6000
    fwd2[i2[int(rc_nb)]] = 2; rev2[i2[int(rc_nb)]] = 2
    keep2, st2 = filter_kmer_counts(
        KmerCounts(k=k, kmers=kmers2, fwd=fwd2, rev=rev2),
        min_count=2, overrep_threshold=1000,
    )
    assert not keep2[i2[int(rc_nb)]] and st2["NEAR_OVERREP"] == 1

    # skew filter: 40/0 split with cutoff 0.2 dies; balanced survives
    keep3, st3 = filter_kmer_counts(
        KmerCounts(
            k=k,
            kmers=np.sort(np.array([normal, far], np.uint64)),
            fwd=np.array([40, 20], np.int64),
            rev=np.array([0, 22], np.int64),
        ),
        min_count=2, skew_cutoff=0.2,
    )
    assert st3["SKEWED"] == 1 and keep3.sum() == 1
