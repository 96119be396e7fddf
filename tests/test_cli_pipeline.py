"""CLI end-to-end tests: the product surface itself, run as subprocesses.

These drive the same entry points a user types (the reference exercises its
built CLI the same way, python/functest/biograph_wrapper_test.py), so a
stage that only breaks at the CLI wiring level (like an undefined name in
run_coverage) fails here even when the library-level tests pass.
"""

import json
import os
import subprocess
import sys

import pytest

GOLDEN = "/root/reference/golden"
REFDIR = "/root/reference/datasets/reference/e_coli_k12_ASM584v1"
LAMBDA = "/root/reference/datasets/lambdaToyData/benchmark"


def _run(args, **kw):
    return subprocess.run(
        [sys.executable, "-m", "biograph_jax", "--platform", "cpu", *args],
        capture_output=True,
        text=True,
        cwd="/root/repo",
        **kw,
    )


def _vcf_records(path):
    out = set()
    for ln in open(path):
        if ln.startswith("#"):
            continue
        f = ln.split("\t")
        out.add((f[0].split(":")[0], int(f[1]), f[3], f[4]))
    return out


def test_cli_coverage_lambda(tmp_path):
    """`biograph_jax coverage` (run_coverage path) over the lambda trio .bg —
    including a multi-allelic and a symbolic record, which must pass through
    un-corrupted instead of being decoded as DNA."""
    vcf_in = tmp_path / "in.vcf"
    vcf_in.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tfather\n"
        "lambda\t2667\t.\tC\tCA\t.\tPASS\t.\tGT\t./.\n"
        "lambda\t5897\t.\tG\tA\t.\tPASS\t.\tGT\t./.\n"
        "lambda\t7146\t.\tG\tGTA,GA\t.\tPASS\t.\tGT\t./.\n"
        "lambda\t9000\t.\tN\t<DEL>\t.\tPASS\tSVTYPE=DEL\tGT\t./.\n"
    )
    out = tmp_path / "out.vcf"
    feats = tmp_path / "feats.npz"
    r = _run(
        [
            "coverage",
            "--vcf", str(vcf_in),
            "--biograph", os.path.join(LAMBDA, "father_lambda.bg"),
            "--ref", os.path.join(LAMBDA, "ref_lambda"),
            "--out", str(out),
            "--features", str(feats),
        ]
    )
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [l for l in open(out) if not l.startswith("#")]
    assert len(lines) == 4
    recs = {}
    for l in lines:
        f = l.rstrip("\n").split("\t")
        fmt = dict(zip(f[8].split(":"), f[9].split(":")))
        info = dict(
            kv.split("=", 1) if "=" in kv else (kv, "1")
            for kv in f[7].split(";")
        )
        recs[int(f[1])] = (fmt, info)
    # known hom-alt lambda variants genotype 1/1 with real depth
    assert recs[2667][0]["GT"] == "1/1"
    assert recs[5897][0]["GT"] == "1/1"
    assert int(recs[5897][1]["DP"]) > 50
    # PC INFO field is declared and populated (pair coverage wired in)
    header = [l for l in open(out) if l.startswith("##INFO=<ID=PC")]
    assert header, "PC INFO header missing"
    assert int(recs[5897][1]["PC"]) > 0  # paired sample: spanning pairs exist
    # multi-allelic: AD has 3 fields (ref + 2 alts), GT indexes allele 1
    fmt7146 = recs[7146][0]
    assert len(fmt7146["AD"].split(",")) == 3
    assert fmt7146["GT"] in ("1/1", "0/1", "1/2")
    # symbolic alt: skipped, not decoded as ACGT
    assert recs[9000][0]["GT"] == "./."
    import numpy as np

    z = np.load(feats)
    assert "pair_cov" in z.files and len(z["alt_depth"]) == 4


@pytest.mark.slow
def test_cli_full_pipeline_ecoli(tmp_path):
    """`biograph_jax full_pipeline` from reads to results.vcf, plus resume.

    Asserts BOTH directions against golden/final.vcf in the region: full
    recall of golden records and a bounded number of extras (precision)."""
    out = str(tmp_path / "run")
    args = [
        "full_pipeline",
        "--reads", os.path.join(GOLDEN, "e_coli_10000snp.fq"),
        "--ref", REFDIR,
        "--out", out,
        "--region", "Chromosome:0-12000",
        "--min-depth", "5",
    ]
    r = _run(args, timeout=1500)
    assert r.returncode == 0, r.stderr[-3000:]
    results = os.path.join(out, "analysis", "results.vcf")
    assert os.path.isfile(results)
    ours = _vcf_records(results)
    golden = {
        r_
        for r_ in _vcf_records(os.path.join(GOLDEN, "final.vcf"))
        if r_[1] <= 12000 - 300
    }
    missing = golden - ours
    assert not missing, sorted(missing)[:5]
    # Per-stage METRIC-DICT snapshot (sv_perf_check.py:56-80 model) with
    # machine-checked evidence instead of a bare extras-count pin:
    #   * precision/recall/F1 of discovery + results vs golden final.vcf AND
    #     the reference's own pileup.vcf (normalized-representation match)
    #   * EVERY extra vs final.vcf must be proven by >= 3 raw FASTQ reads
    #     carrying the exact alt haplotype with zero ref-haplotype reads
    #     (final.vcf is a curated subset: its own pileup caller reports 120
    #     of them; raw reads prove the other 108)
    #   * any truth record we miss must itself have zero raw alt reads
    #     (pileup's 3882 ATTTT>ATTT is a samtools-era FP, not our FN)
    from biograph_jax.index.reference import Reference
    from biograph_jax.variants.metrics import parity_report

    snap = json.load(
        open(os.path.join(os.path.dirname(__file__), "data", "ecoli_region_snapshot.json"))
    )
    ref = Reference.from_reference_dir(REFDIR)

    def stage_records(path):
        return [
            {"chrom": c_, "pos": p_, "ref": rr, "alt": aa}
            for (c_, p_, rr, aa) in _vcf_records(path)
        ]

    report = parity_report(
        ref,
        os.path.join(GOLDEN, "e_coli_10000snp.fq"),
        {
            "discovery": stage_records(os.path.join(out, "analysis", "discovery.vcf")),
            "results": stage_records(results),
        },
        {
            "final": os.path.join(GOLDEN, "final.vcf"),
            "pileup": os.path.join(GOLDEN, "pileup.vcf"),
        },
        max_pos=12000 - 300,
    )
    got = {
        "stages": report["stages"],
        "extras": {
            "n_extras": report["extras_validation"]["n_extras"],
            "n_read_proven": report["extras_validation"]["n_read_proven"],
        },
        "missed_without_read_support": {
            name: len(v["without_read_support"])
            for name, v in report["missed_validation"].items()
        },
    }
    assert not report["extras_validation"]["unproven"], (
        report["extras_validation"]["unproven"][:3]
    )
    # the ORTHOGONAL realignment-pileup channel must never actively
    # contradict an extra (aligned depth with the alt in the minority);
    # silence (zero aligned depth inside dense variant clusters that defeat
    # gapless alignment) is expected and covered by the haplotype proof
    assert not report["extras_validation"].get("pileup_contradicted"), (
        report["extras_validation"]["pileup_contradicted"][:3]
    )
    assert report["extras_validation"].get("n_pileup_confirmed", 0) >= 150
    # every missed truth record must be a truth-set error (zero alt reads)
    for name, v in report["missed_validation"].items():
        assert not v["with_read_support"], (name, v["with_read_support"][:3])
    assert got == snap, (got, snap)
    # coverage stage genotyped (no hardcoded 1/1 with zero depth)
    assert json.load(open(os.path.join(out, "qc", "timings.json")))

    # resume: all stages skip, fast exit 0
    r2 = _run(args + ["--resume"], timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert r2.stdout.count("skipping") >= 3

    # rerun: exactly one named stage re-executes (bgbinary rerun analog)
    body0 = open(results).read()
    disc = os.path.join(out, "analysis", "discovery.vcf")
    dt0 = os.path.getmtime(disc)
    cov = os.path.join(out, "analysis", "coverage.vcf")
    ct0 = os.path.getmtime(cov)
    r3 = _run(args + ["--rerun", "discovery"], timeout=1500)
    assert r3.returncode == 0, r3.stderr[-2000:]
    assert os.path.getmtime(disc) > dt0  # discovery reran
    assert os.path.getmtime(cov) == ct0  # downstream artifact untouched
    assert open(results).read() == body0
    assert r3.stdout.count("skipping (--rerun discovery)") >= 2


@pytest.mark.slow
def test_cli_dev_commands(tmp_path):
    """query / dump_flat / ref2seqset / metadata dev-command parity
    (reference: bgbinary dev commands, modules/biograph/main.cpp:62-70)."""
    bgt = str(tmp_path / "quick.bgt")
    r = _run(
        [
            "create",
            "--reads", os.path.join(GOLDEN, "quick_e_coli.fq"),
            "--out", bgt,
        ]
    )
    assert r.returncode == 0, r.stderr[-2000:]

    # query: a read prefix must be found; a garbage string must not
    read1 = open(os.path.join(GOLDEN, "quick_e_coli.fq")).readlines()[1].strip()
    r = _run(["query", "--biograph", bgt, "--query", read1[:20]])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "entries share this prefix" in r.stdout
    body = [l for l in r.stdout.splitlines() if set(l) <= set("ACGT") and l]
    assert body and all(s.startswith(read1[:20]) for s in body)
    r = _run(["query", "--biograph", bgt, "--query", "GTCA" * 10])
    assert r.returncode == 0
    assert "No valid results" in r.stdout

    # dump_flat: every line is a distinct entry sequence, count matches
    flat = tmp_path / "flat.txt"
    r = _run(["dump_flat", "--biograph", bgt, "--out", str(flat)])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = flat.read_text().splitlines()
    meta = json.load(open(os.path.join(bgt, "metadata.json")))
    assert len(lines) == meta["num_seqset_entries"]
    assert len(set(lines)) == len(lines)
    assert lines == sorted(lines)  # seqset entries are suffix-sorted

    # ref2seqset on the lambda reference: every 100bp tile findable
    out2 = str(tmp_path / "lambda_ref.bgt")
    r = _run(
        [
            "ref2seqset",
            "--ref", os.path.join(LAMBDA, "ref_lambda"),
            "--out", out2,
            "--read-size", "100",
        ]
    )
    assert r.returncode == 0, r.stderr[-2000:]
    meta2 = json.load(open(os.path.join(out2, "metadata.json")))
    assert meta2["num_reads"] >= 480  # 48.5kb / 100
    r = _run(["query", "--biograph", out2, "--query", read1[:20]])
    assert r.returncode == 0  # absent from lambda: clean no-result
    assert "No valid results" in r.stdout

    # metadata: displays and edits sample_id
    r = _run(["metadata", bgt, "--set-sample-id", "S1"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"sample_id": "S1"' in r.stdout
    assert json.load(open(os.path.join(bgt, "metadata.json")))["sample_id"] == "S1"


@pytest.mark.slow
def test_cli_tool_commands(tmp_path):
    """One pass over the remaining CLI surface — upgrade, stats, refhash,
    export_fastq, merge, kmers, ref2bwt, bwtquery, vdb, discovery — so a
    wiring-level break in any subcommand fails a test (the round-1 coverage
    NameError survived because only the library layer was tested)."""
    # upgrade a reference .bg to native .bgt
    bgt = str(tmp_path / "father.bgt")
    r = _run(["upgrade", "--in", os.path.join(LAMBDA, "father_lambda.bg"), "--out", bgt])
    assert r.returncode == 0, r.stderr[-2000:]

    r = _run(["stats", bgt])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "seqset entries" in r.stdout

    r = _run(["refhash", "--ref", os.path.join(LAMBDA, "ref_lambda")])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip()

    fq = tmp_path / "reads.fq"
    r = _run(["export_fastq", "--biograph", bgt, "--out", str(fq)])
    assert r.returncode == 0, r.stderr[-2000:]
    n_reads = sum(1 for l in open(fq) if l.startswith("@"))
    assert n_reads > 1000

    # kmers on the exported reads
    kc = tmp_path / "kmers.txt"
    r = _run(["kmers", "--reads", str(fq), "--out", str(kc)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert sum(1 for _ in open(kc)) > 1000

    # merge father with itself -> idempotent entry count
    merged = str(tmp_path / "merged.bgt")
    r = _run(["merge", "--biographs", bgt, bgt, "--out", merged])
    assert r.returncode == 0, r.stderr[-2000:]
    m_in = json.load(open(os.path.join(bgt, "metadata.json")))
    m_out = json.load(open(os.path.join(merged, "metadata.json")))
    assert m_out["num_seqset_entries"] == m_in["num_seqset_entries"]

    # ref2bwt + bwtquery: a known lambda substring occurs exactly once
    bwt = str(tmp_path / "ref.bwt")
    r = _run(["ref2bwt", "--ref", os.path.join(LAMBDA, "ref_lambda"), "--out", bwt])
    assert r.returncode == 0, r.stderr[-2000:]
    from biograph_jax.index.reference import Reference
    from biograph_jax.core import dna as _dna

    ref = Reference.from_reference_dir(os.path.join(LAMBDA, "ref_lambda"))
    probe = _dna.codes_to_seq(ref.flat[5000:5040])
    r = _run(["bwtquery", "--bwt", bwt, "--seq", probe])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "occurrence(s)" in r.stdout and "positions: 5000" in r.stdout

    # discovery CLI (pileup mode) on the upgraded biograph
    dvcf = tmp_path / "d.vcf"
    r = _run(
        [
            "discovery", "--mode", "pileup", "--biograph", bgt,
            "--ref", os.path.join(LAMBDA, "ref_lambda"), "--out", str(dvcf),
        ]
    )
    assert r.returncode == 0, r.stderr[-2000:]
    n_calls = sum(1 for l in open(dvcf) if not l.startswith("#"))
    assert n_calls >= 8  # the reference's own 8 lambda calls

    # assemble mode with the assembly CSV dump (write_csv_assembly analog)
    avcf = tmp_path / "a.vcf"
    acsv = tmp_path / "asm.csv"
    r = _run(
        [
            "discovery", "--mode", "assemble", "--biograph", bgt,
            "--ref", os.path.join(LAMBDA, "ref_lambda"), "--out", str(avcf),
            "--min-depth", "5", "--assemblies-out", str(acsv),
        ],
        timeout=1500,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    rows = open(acsv).read().splitlines()
    assert rows[0].startswith("scaffold_name,left_offset,right_offset")
    assert len(rows) > 8  # one row per scored assembly
    import re as _re

    for row in rows[1:3]:
        f = row.split(",")
        assert f[0] == "lambda" and int(f[1]) < int(f[2])
        assert _re.fullmatch(r"[ACGT]*", f[7])

    # vdb ingest/list/query/export roundtrip
    db = str(tmp_path / "vdb")
    r = _run(["vdb", "ingest", "--db", db, "--vcf", str(dvcf), "--sample", "father"])
    assert r.returncode == 0, r.stderr[-2000:]
    r = _run(["vdb", "list", "--db", db])
    assert r.returncode == 0 and "father" in r.stdout
    r = _run(["vdb", "query", "--db", db, "--sample", "father", "--limit", "5"])
    assert r.returncode == 0, r.stderr[-2000:]
    out_vcf = tmp_path / "export.vcf"
    r = _run(["vdb", "export", "--db", db, "--sample", "father", "--out", str(out_vcf)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert sum(1 for l in open(out_vcf) if not l.startswith("#")) == n_calls


def test_cli_create_sample_and_cut(tmp_path):
    """create --sample-reads / --cut-reads importer options
    (reference: biograph_create.cpp:316-321 + read_importer.h:35)."""
    import numpy as np

    from biograph_jax.io.fastq import cut_reads, read_fastq, sample_mask, subset_batch

    src = os.path.join(GOLDEN, "quick_e_coli.fq")
    full = read_fastq(src)
    R = full.num_reads

    # deterministic accumulator sampling: ~1 in 4, evenly spread
    keep = sample_mask(R, 0.25)
    assert abs(int(keep.sum()) - R // 4) <= 1
    assert (np.diff(np.nonzero(keep)[0]) == 4).all()
    sub = subset_batch(full, keep)
    assert sub.num_reads == int(keep.sum())
    assert sub.sequence(0) == full.sequence(int(np.nonzero(keep)[0][0]))

    # cutting: bases 5-20 (1-based inclusive) of each read
    cut = cut_reads(full, 5, 20)
    assert int(cut.lengths.max()) == 16
    assert cut.sequence(0) == full.sequence(0)[4:20]
    # a read shorter than the cut start becomes zero-length
    tiny = subset_batch(full, np.arange(1))
    tiny.lengths[:] = 3
    assert int(cut_reads(tiny, 5, 20).lengths[0]) == 0

    # through the CLI: sampled+cut create produces a valid smaller .bgt
    bgt = str(tmp_path / "cutsample.bgt")
    r = _run(
        [
            "create",
            "--reads", src,
            "--out", bgt,
            "--sample-reads", "0.25",
            "--cut-reads", "5-20",
        ]
    )
    assert r.returncode == 0, r.stderr[-2000:]
    meta = json.load(open(os.path.join(bgt, "metadata.json")))
    assert meta["num_reads"] == int(keep.sum())
    # every surviving entry is <= the cut width * 2 suffix structure and the
    # seqset answers a cut read's prefix
    q = cut.sequence(int(np.nonzero(keep)[0][0]))[:12]
    r = _run(["query", "--biograph", bgt, "--query", q])
    assert r.returncode == 0 and "entries share this prefix" in r.stdout
