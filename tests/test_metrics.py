"""Call-set metrics + raw-read validation units (variants/metrics.py;
sv_perf_check.py:56-80 metric-dict model)."""

import numpy as np

from biograph_jax.index.reference import Contig
from biograph_jax.variants.metrics import (
    normalize_key,
    raw_read_support,
    stage_metrics,
)


def test_normalize_key_homopolymer_representations():
    # same insertion written three ways
    assert normalize_key(("c", 5070, "CTTTTTT", "CTTTTTTT")) == normalize_key(
        ("c", 5070, "C", "CT")
    )
    assert normalize_key(("c", 8029, "TA", "TAA")) == ("c", 8029, "T", "TA")
    # SNP unchanged; pos advances over a shared prefix
    assert normalize_key(("c", 10, "A", "G")) == ("c", 10, "A", "G")
    assert normalize_key(("c", 10, "AC", "AT")) == ("c", 11, "C", "T")


def test_stage_metrics_normalized_match():
    calls = {("c", 5070, "C", "CT"), ("c", 1, "A", "G"), ("c", 9, "T", "C")}
    truth = {("c", 5070, "CTTTTTT", "CTTTTTTT"), ("c", 1, "A", "G"), ("c", 2, "G", "T")}
    m = stage_metrics(calls, truth)
    assert (m["TP"], m["FP"], m["FN"]) == (2, 1, 1)
    assert m["recall"] == round(2 / 3, 4)


class _Ref:
    def __init__(self, codes):
        self.flat = np.asarray(codes, np.uint8)
        self.contigs = [Contig(name="c", start=0, length=len(codes))]

    def contig_by_name(self, name):
        return self.contigs[0]


def test_raw_read_support_haplotype_context(tmp_path):
    """Two nearby hom SNPs: a read set carrying BOTH validates each call only
    when the neighbour is applied to the probe window (context_calls)."""
    from biograph_jax.core import dna

    rng = np.random.default_rng(3)
    ref_codes = rng.integers(0, 4, 120).astype(np.uint8)
    donor = ref_codes.copy()
    donor[50] = (donor[50] + 1) % 4
    donor[55] = (donor[55] + 1) % 4
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for s in range(30, 60, 2):
            seq = dna.codes_to_seq(donor[s : s + 35])
            f.write(f"@r{s}\n{seq}\n+\n{'I' * 35}\n")
    ref = _Ref(ref_codes)
    b = dna.codes_to_seq(ref_codes)
    calls = [
        {"chrom": "c", "pos": 51, "ref": b[50], "alt": dna.codes_to_seq(donor[50:51])},
        {"chrom": "c", "pos": 56, "ref": b[55], "alt": dna.codes_to_seq(donor[55:56])},
    ]
    # both in context: every window matches reads, no ref support
    sup = raw_read_support(ref, str(fq), calls)
    assert all(s["alt_reads"] >= 3 and s["ref_reads"] == 0 for s in sup), sup
    # neighbour missing from context: the probe window matches nothing
    solo = raw_read_support(ref, str(fq), [calls[0]])
    assert solo[0]["alt_reads"] == 0
    fixed = raw_read_support(ref, str(fq), [calls[0]], context_calls=calls)
    assert fixed[0]["alt_reads"] >= 3
