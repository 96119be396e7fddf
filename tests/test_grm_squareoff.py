"""grm (breakend mappability) + squareoff (multi-sample re-genotyping)."""

import os
import subprocess
import sys

import numpy as np
import pytest

LAMBDA = "/root/reference/datasets/lambdaToyData/benchmark"


def _run(args, **kw):
    return subprocess.run(
        [sys.executable, "-m", "biograph_jax", "--platform", "cpu", *args],
        capture_output=True,
        text=True,
        cwd="/root/repo",
        **kw,
    )


def test_grm_annotates_sv_breakends(tmp_path):
    from biograph_jax.index.bwt import RefBwt
    from biograph_jax.index.reference import Reference
    from biograph_jax.io.vcf import VcfRecord
    from biograph_jax.tools.grm import annotate_grm

    ref = Reference.from_reference_dir(os.path.join(LAMBDA, "ref_lambda"))
    bwt = RefBwt.build(np.asarray(ref.flat))
    flat = np.asarray(ref.flat)
    # the lambda 100bp deletion at 2191 (unique flanks) + a small SNP
    refseq = "".join("ACGT"[c] for c in flat[2190:2291])
    recs = [
        VcfRecord("lambda", 2191, refseq, refseq[0]),
        VcfRecord("lambda", 5897, "G", "A"),
    ]
    out = annotate_grm(bwt, ref, recs)
    assert out[0].info.get("GRM_UP") == 1  # unique upstream anchor
    assert out[0].info.get("GRM_DN") == 1
    assert "GRM_UP" not in out[1].info  # SNPs pass through


def test_squareoff_trio(tmp_path):
    """Union of trio single-sample calls re-genotyped in all three samples:
    father-only variants must come back hom-ref/absent in mother."""
    from biograph_jax.api import BioGraph
    from biograph_jax.index.reference import Reference
    from biograph_jax.tools.squareoff import squareoff

    ref = Reference.from_reference_dir(os.path.join(LAMBDA, "ref_lambda"))
    # build per-sample VCF paths from the committed pcmp expectations
    vcfs = [
        os.path.join(LAMBDA, f"{s}_single_pcmp.vcf")
        for s in ("father", "mother", "proband")
    ]
    bgs = [
        BioGraph(os.path.join(LAMBDA, f"{s}_lambda.bg"))
        for s in ("father", "mother", "proband")
    ]
    out = str(tmp_path / "square.vcf")
    recs = squareoff(vcfs, bgs, ref, out, ["father", "mother", "proband"])
    assert len(recs) >= 16  # union across the trio
    lines = [l for l in open(out) if not l.startswith("#")]
    assert len(lines) == len(recs)
    header = [l for l in open(out) if l.startswith("#CHROM")][0]
    assert header.rstrip().split("\t")[-3:] == ["father", "mother", "proband"]
    # spot-check: known father-only SNP 5897 G>A hom in father+proband,
    # absent in mother
    row = [l for l in lines if l.split("\t")[1] == "5897"][0].rstrip().split("\t")
    fmt_keys = row[8].split(":")
    gt_i = fmt_keys.index("GT")
    gts = [row[9 + i].split(":")[gt_i] for i in range(3)]
    assert gts[0] == "1/1" and gts[2] == "1/1", gts
    assert gts[1] in ("0/0", "./."), gts


@pytest.mark.slow
def test_squareoff_matches_family_pcmp(tmp_path):
    """GT concordance against the reference's own multi-sample trio output
    (datasets/lambdaToyData/benchmark/family_pcmp.vcf) — the squareoff
    parity gate."""
    from biograph_jax.api import BioGraph
    from biograph_jax.index.reference import Reference
    from biograph_jax.tools.squareoff import squareoff

    ref = Reference.from_reference_dir(os.path.join(LAMBDA, "ref_lambda"))
    # expected: per (pos,ref,alt) the per-sample GTs, in their column order
    exp = {}
    order = None
    for ln in open(os.path.join(LAMBDA, "family_pcmp.vcf")):
        if ln.startswith("#CHROM"):
            order = ln.rstrip().split("\t")[9:]
            continue
        if ln.startswith("#"):
            continue
        f = ln.rstrip().split("\t")
        if len(f) < 10 or ":" not in f[8]:
            continue
        keys = f[8].split(":")
        gts = {}
        for s, col in zip(order, f[9:]):
            d = dict(zip(keys, col.split(":")))
            g = d.get("GT", ".")
            if g in (".", "./."):
                g = d.get("PGT", ".")
            gts[s] = g.replace("|", "/")
        exp[(int(f[1]), f[3], f[4])] = gts
    assert order == ["proband", "father", "mother"]

    samples = ["proband", "father", "mother"]
    vcfs = [os.path.join(LAMBDA, f"{s}_single_pcmp.vcf") for s in samples]
    bgs = [BioGraph(os.path.join(LAMBDA, f"{s}_lambda.bg")) for s in samples]
    out = str(tmp_path / "family.vcf")
    recs = squareoff(vcfs, bgs, ref, out, samples)
    agree = tot = 0
    mism = []
    lines = [l for l in open(out) if not l.startswith("#")]
    for l in lines:
        f = l.rstrip().split("\t")
        key = (int(f[1]), f[3], f[4])
        if key not in exp:
            continue
        keys = f[8].split(":")
        for si, s in enumerate(samples):
            want = exp[key].get(s, ".")
            if want == ".":
                continue
            got = dict(zip(keys, f[9 + si].split(":")))["GT"].replace("|", "/")
            tot += 1
            ok = got == want or (want == "0/0" and got == "./.")
            agree += ok
            if not ok:
                mism.append((key[0], s, want, got))
    assert tot >= 40
    assert agree >= 0.9 * tot, (agree, tot, mism[:6])


@pytest.mark.slow
def test_pvcf_pipe_trio(tmp_path):
    """Project-VCF orchestration (pvcf_pipe analog — the reference ships a
    stub; this one runs): union squareoff across the trio + Mendelian
    annotation driven by a PED file, through the real CLI."""
    ped = tmp_path / "trio.ped"
    ped.write_text(
        "lamfam\tproband\tfather\tmother\t1\t2\n"
        "lamfam\tfather\t0\t0\t1\t1\n"
        "lamfam\tmother\t0\t0\t2\t1\n"
    )
    out = tmp_path / "project.vcf"
    samples = ["father", "mother", "proband"]
    r = _run(
        [
            "pvcf_pipe",
            "--biographs", *[os.path.join(LAMBDA, f"{s}_lambda.bg") for s in samples],
            "--vcfs", *[os.path.join(LAMBDA, f"{s}_single_pcmp.vcf") for s in samples],
            "-r", os.path.join(LAMBDA, "ref_lambda"),
            "-p", str(ped),
            "--samples", *samples,
            "-o", str(out),
        ],
        timeout=1500,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    head = [l for l in open(out) if l.startswith("#CHROM")][0]
    assert head.rstrip().endswith("father\tmother\tproband")
    body = [l for l in open(out) if not l.startswith("#")]
    assert len(body) >= 8
    assert all("sizeCat=" in l for l in body)
    assert (tmp_path / "project_stats.json").is_file()
    # an unknown sample name must be rejected against the pedigree
    r = _run(
        [
            "pvcf_pipe",
            "--biographs", os.path.join(LAMBDA, "father_lambda.bg"),
            "--vcfs", os.path.join(LAMBDA, "father_single_pcmp.vcf"),
            "-r", os.path.join(LAMBDA, "ref_lambda"),
            "-p", str(ped),
            "--samples", "nobody",
            "-o", str(tmp_path / "x.vcf"),
        ]
    )
    assert r.returncode != 0 and "not in pedigree" in (r.stderr + r.stdout)
