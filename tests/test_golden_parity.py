"""Golden-parity gate: the --golden-parity preset vs golden/final.vcf.

Measures the reverse-engineered 2012 pipeline reproduction (VERDICT r4
item 3).  Machine-checked floor: all 57 golden records called at exact
position/allele; >=53/57 DP byte-exact; every extra call carries >=35
admitted alt basecalls; QUAL formula matches the golden file's own
internal rule on every DP-exact record."""

import re

import numpy as np
import pytest

GOLDEN = "/root/reference/golden/final.vcf"


def _golden_records():
    out = {}
    for ln in open(GOLDEN):
        if ln.startswith("#"):
            continue
        f = ln.rstrip("\n").split("\t")
        dp = int(re.search(r"DP=(\d+)", f[7]).group(1))
        out[(f[0], int(f[1]))] = (f[3], f[4], dp, int(f[5]))
    return out


@pytest.mark.slow
def test_golden_parity_preset(tmp_path):
    from biograph_jax.io.fastq import read_fastq
    from biograph_jax.index.reference import Reference
    from biograph_jax.variants.golden_parity import (
        golden_parity_calls,
        write_golden_parity_vcf,
    )

    batch = read_fastq("/root/reference/golden/e_coli_10000snp.fq")
    ref = Reference.from_reference_dir(
        "/root/reference/datasets/reference/e_coli_k12_ASM584v1"
    )
    calls = golden_parity_calls(ref, batch.codes, batch.lengths)
    golden = _golden_records()

    ours = {(c.chrom, c.pos): c for c in calls}
    # every golden record called at the exact position and allele
    missed = [
        k for k, (r, a, dp, q) in golden.items()
        if k not in ours or ours[k].ref != r or ours[k].alt != a
    ]
    assert not missed, missed
    # DP byte-exact on >= 53/57 (residuals documented in PARITY.md —
    # clustered systematic-mismatch loci of the dead 2012 aligner)
    dp_exact = sum(
        1 for k, (r, a, dp, q) in golden.items() if ours[k].depth == dp
    )
    assert dp_exact >= 53, dp_exact
    # every extra call is a real >=35-deep alt pileup (no hallucinations)
    extras = [c for c in calls if (c.chrom, c.pos) not in golden]
    assert len(extras) <= 16, len(extras)
    assert all(c.depth >= 35 for c in extras)
    # QUAL rule: golden's own records obey 3*DP+27 on 56/57; ours must obey
    # it everywhere and therefore match golden byte-for-byte wherever DP does
    out = tmp_path / "parity.vcf"
    write_golden_parity_vcf(str(out), calls)
    body = [
        ln for ln in open(out).read().splitlines() if not ln.startswith("#")
    ]
    assert len(body) == len(calls)
    for ln in body:
        f = ln.split("\t")
        dp = int(re.search(r"DP=(\d+)", f[7]).group(1))
        assert int(f[5]) == 3 * dp + 27
    # record-level byte equality where DP matches and no GENE annotation
    golden_lines = {}
    for ln in open(GOLDEN):
        if ln.startswith("#"):
            continue
        f = ln.split("\t")
        golden_lines[(f[0], int(f[1]))] = ln.rstrip("\n")
    exact_lines = 0
    for ln in body:
        f = ln.split("\t")
        k = (f[0], int(f[1]))
        if k in golden_lines and "GENE" not in golden_lines[k]:
            exact_lines += ln == golden_lines[k]
    # the 3 golden records without GENE= annotations must reproduce
    # byte-for-byte (5169, 5183, 9274)
    assert exact_lines >= 3, exact_lines
