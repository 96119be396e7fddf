"""The seeded sample generator and the helpers chip_smoke.py scores with."""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp

from biograph_jax.tools.simulate import (
    MIN_SNP_GAP,
    haploid_sample,
    record_digest,
    truth_match,
    write_fasta,
    write_fastq,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_sample_is_determined_by_seed():
    a = haploid_sample(5, 20_000, 20, read_len=50, depth=4)
    b = haploid_sample(5, 20_000, 20, read_len=50, depth=4)
    c = haploid_sample(6, 20_000, 20, read_len=50, depth=4)
    for x, y in ((a.genome, b.genome), (a.snp_pos, b.snp_pos),
                 (a.snp_alt, b.snp_alt), (a.reads, b.reads)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.genome, c.genome)


def test_sample_plants_spaced_snps_and_strand_reads():
    s = haploid_sample(1, 30_000, 40, read_len=60, depth=5)
    assert s.reads.shape == (2500, 60)
    assert np.diff(s.snp_pos).min() >= MIN_SNP_GAP
    assert s.snp_pos.min() >= MIN_SNP_GAP // 2
    assert s.snp_pos.max() < 30_000 - MIN_SNP_GAP // 2
    assert (s.genome[s.snp_pos] != s.snp_alt).all()
    assert (np.nonzero(s.donor != s.genome)[0] == s.snp_pos).all()
    donor = s.donor.tobytes()
    fwd = s.reads[0].tobytes()
    rev = (3 - s.reads[1][::-1]).astype(np.uint8).tobytes()
    assert fwd in donor and rev in donor


def test_sample_rejects_crowded_snps():
    with pytest.raises(ValueError):
        haploid_sample(1, 1000, 10)


def test_truth_match_counts_only_planted_substitutions():
    s = haploid_sample(2, 10_000, 5, read_len=50, depth=1)
    alt = "ACGT"
    calls = [(int(p) + 1, "N", alt[int(a)]) for p, a in zip(s.snp_pos, s.snp_alt)]
    calls[0] = (calls[0][0], "N", alt[(int(s.snp_alt[0]) + 1) % 4])  # wrong base
    calls.append((int(s.snp_pos[1]) + 1, "NN", "N"))  # an indel there
    calls.append((3, "N", "A"))  # nothing planted
    m = truth_match(iter(calls), s)
    assert m["truth"] == 5 and m["calls"] == 7 and m["true_positives"] == 4
    assert m["recall"] == pytest.approx(0.8)
    assert m["precision"] == pytest.approx(4 / 7)


def test_record_digest_is_order_free_and_support_sensitive():
    recs = [
        {"chrom": "chr1", "pos": 10, "ref": "A", "alt": "C", "support": 7},
        {"chrom": "chr1", "pos": 99, "ref": "G", "alt": "T", "support": 3},
    ]
    assert record_digest(recs) == record_digest(recs[::-1])
    changed = [dict(recs[0], support=8), recs[1]]
    assert record_digest(changed) != record_digest(recs)


def test_fasta_and_fastq_read_back(tmp_path):
    from biograph_jax.index.reference import Reference
    from biograph_jax.io.fastq import read_fastq

    s = haploid_sample(3, 1_234, 2, read_len=30, depth=3)
    write_fasta(str(tmp_path / "r.fa"), s.genome)
    write_fastq(str(tmp_path / "r.fq"), s.reads)
    ref = Reference.from_fasta(str(tmp_path / "r.fa"))
    np.testing.assert_array_equal(np.asarray(ref.flat), s.genome)
    mine = s.reference()
    np.testing.assert_array_equal(mine.flat, ref.flat)
    assert mine.contigs == ref.contigs and not mine.is_n.any()
    batch = read_fastq(str(tmp_path / "r.fq"))
    assert batch.num_reads == len(s.reads)
    np.testing.assert_array_equal(np.asarray(batch.codes)[:, :30], s.reads)


def test_smoke_rank_references_match_the_seqset(rng):
    """chip_smoke's numpy rank4/push4 references agree with the device
    paths they check on the card."""
    from biograph_jax.build.seqset_build import build_seqset
    from biograph_jax.index.seqset import SeqsetRanges

    C = _smoke()
    codes = rng.integers(0, 4, (150, 36)).astype(np.uint8)
    ss = build_seqset(codes, np.full(150, 36, np.int32))
    n = ss.n_entries
    pos = np.concatenate([rng.integers(0, n + 1, 400), [0, 31, 32, n - 1, n]])
    got = np.asarray(ss.d.rank4(jnp.asarray(pos)))
    np.testing.assert_array_equal(
        got, C.rank4_reference(np.asarray(ss.prev_words), np.asarray(ss.prev_cum), pos)
    )
    a, b = np.sort(rng.integers(0, n + 1, (2, 400)), axis=0)
    size = rng.integers(0, 36, 400).astype(np.int32)
    nb4, ne4 = ss.d.push4(SeqsetRanges(jnp.asarray(a), jnp.asarray(b), jnp.asarray(size)))
    wb4, we4 = C.push4_reference(ss, a, b, size)
    np.testing.assert_array_equal(np.asarray(nb4), wb4)
    np.testing.assert_array_equal(np.asarray(ne4), we4)
