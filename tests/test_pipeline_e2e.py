"""End-to-end pipeline tests on the reference's golden E. coli data.

Gates (SURVEY.md §6/§7):
  * k-mer counts bit-identical to golden/kmer_count.txt
  * pileup variant calls: 100% recall vs golden/final.vcf, >=95% concordance
    vs golden/pileup.vcf SNP records
"""

import os
import subprocess
import sys

import numpy as np
import pytest

GOLDEN = "/root/reference/golden"
REFDIR = "/root/reference/datasets/reference/e_coli_k12_ASM584v1"


def _vcf_records(path, strip_contig=True):
    out = set()
    for ln in open(path):
        if ln.startswith("#"):
            continue
        f = ln.split("\t")
        chrom = f[0].split(":")[0] if strip_contig else f[0]
        out.add((chrom, int(f[1]), f[3], f[4]))
    return out


@pytest.fixture(scope="module")
def ecoli_ref():
    from biograph_jax.index.reference import Reference

    return Reference.from_reference_dir(REFDIR)


def test_kmer_count_golden_bitexact(tmp_path):
    from biograph_jax.io.fastq import read_fastq
    from biograph_jax.kmers.count import count_kmers

    batch = read_fastq(os.path.join(GOLDEN, "quick_e_coli.fq"))
    kc = count_kmers(batch.codes, batch.lengths, k=23)
    out = tmp_path / "kmer_count.txt"
    kc.write_text(str(out))
    golden = open(os.path.join(GOLDEN, "kmer_count.txt"), "rb").read()
    ours = open(out, "rb").read()
    assert ours == golden


@pytest.mark.slow
def test_pileup_concordance(ecoli_ref):
    from biograph_jax.io.fastq import read_fastq
    from biograph_jax.variants.pileup import run_pileup_pipeline, write_pileup_vcf

    batch = read_fastq(os.path.join(GOLDEN, "e_coli_10000snp.fq"))
    pl, counts, calls = run_pileup_pipeline(ecoli_ref, batch.codes, batch.lengths)
    placed = int((pl.pos >= 0).sum())
    assert placed >= 0.85 * batch.num_reads

    out = "/tmp/bgt_e2e_final.vcf"
    write_pileup_vcf(out, ecoli_ref, counts, calls)
    ours = _vcf_records(out)

    golden_final = _vcf_records(os.path.join(GOLDEN, "final.vcf"))
    assert golden_final <= ours, f"missing: {sorted(golden_final - ours)[:5]}"

    golden_pileup = {
        r
        for r in _vcf_records(os.path.join(GOLDEN, "pileup.vcf"))
        if len(r[2]) == 1 and len(r[3]) == 1  # SNPs only (no indel calls yet)
    }
    common = len(golden_pileup & ours)
    assert common >= 0.95 * len(golden_pileup), (
        f"{common}/{len(golden_pileup)} pileup SNPs recovered"
    )


def test_cli_kmers_and_reference(tmp_path):
    env = dict(os.environ)
    out = tmp_path / "kc.txt"
    r = subprocess.run(
        [
            sys.executable,
            "-m",
            "biograph_jax",
            "--platform",
            "cpu",
            "kmers",
            "--reads",
            os.path.join(GOLDEN, "quick_e_coli.fq"),
            "--out",
            str(out),
        ],
        capture_output=True,
        text=True,
        env=env,
        cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    assert open(out, "rb").read() == open(
        os.path.join(GOLDEN, "kmer_count.txt"), "rb"
    ).read()


@pytest.mark.slow
def test_assembly_discovery_concordance(ecoli_ref, tmp_path):
    """The wavefront assembly engine must recover all golden final.vcf
    records and all pileup.vcf SNPs within the tested region."""
    from biograph_jax.io.fastq import read_fastq
    from biograph_jax.build.seqset_build import build_seqset
    from biograph_jax.build.readmap_build import build_readmap
    from biograph_jax.variants.discover import (
        DiscoverOptions,
        discover_variants,
        write_discovery_vcf,
    )

    batch = read_fastq(os.path.join(GOLDEN, "e_coli_10000snp.fq"))
    ss = build_seqset(batch.codes, batch.lengths)
    rm = build_readmap(ss, batch.codes, batch.lengths)
    c = ecoli_ref.contig_by_name("Chromosome")
    hi = 12000
    opt = DiscoverOptions(min_alt_support=5)
    recs = discover_variants(
        ss,
        ecoli_ref,
        region=(c.start, c.start + hi),
        opt=opt,
        readmap=rm,
    )
    out = str(tmp_path / "asm.vcf")
    write_discovery_vcf(out, ecoli_ref, recs, opt=opt)
    ours = _vcf_records(out)

    golden_final = {
        r for r in _vcf_records(os.path.join(GOLDEN, "final.vcf")) if r[1] <= hi - 300
    }
    assert golden_final <= ours, sorted(golden_final - ours)[:5]
    golden_pileup = {
        r
        for r in _vcf_records(os.path.join(GOLDEN, "pileup.vcf"))
        if len(r[2]) == 1 == len(r[3]) and r[0] == "Chromosome" and r[1] <= hi - 300
    }
    common = golden_pileup & ours
    assert len(common) >= 0.97 * len(golden_pileup), (
        f"{len(common)}/{len(golden_pileup)}"
    )


@pytest.mark.slow
def test_bg_import_lambda_discovery(tmp_path):
    """Import the reference's own lambda .bg (spiral_file format) and
    reproduce its variant calls exactly."""
    import gzip

    from biograph_jax.io.bgimport import open_bg_dir
    from biograph_jax.index.reference import Reference
    from biograph_jax.variants.discover import (
        DiscoverOptions,
        discover_variants,
    )

    base = "/root/reference/datasets/lambdaToyData/benchmark"
    ss, rm, meta = open_bg_dir(os.path.join(base, "father_lambda.bg"))
    assert ss.n_entries == 98006
    assert meta["accession_id"] == "father"
    assert rm is not None and rm.read_count == 48930
    ref = Reference.from_reference_dir(os.path.join(base, "ref_lambda"))
    opt = DiscoverOptions(min_alt_support=3)
    recs = discover_variants(ss, ref, opt=opt, readmap=rm, chunk_len=4096)
    ours = {
        (r["chrom"], r["pos"], r["ref"], r["alt"])
        for r in recs
        if r["support"] >= 3
    }
    exp = set()
    with gzip.open(
        os.path.join(base, "father_lambda.bg", "variants.vcf.gz"), "rt"
    ) as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            p = ln.split("\t")
            exp.add((p[0].split(":")[0], int(p[1]), p[3], p[4]))
    assert exp == ours, (sorted(exp - ours)[:3], sorted(ours - exp)[:3])


def test_bg_import_hiv_seqset():
    """The HIV divergent-sample .bg seqsets open and answer queries."""
    from biograph_jax.io.bgimport import open_bg_dir
    import jax.numpy as jnp
    from biograph_jax.core import dna

    ss, rm, meta = open_bg_dir(
        "/root/reference/datasets/hiv/biograph/ERR381524.bg"
    )
    assert ss.n_entries > 1000
    ids = jnp.asarray([0, ss.n_entries // 3, ss.n_entries - 1], jnp.int64)
    seqs = np.asarray(ss.d.sequences(ids, 30))
    for i, e in enumerate(np.asarray(ids)):
        n = min(int(ss.entry_sizes[e]), 30)
        b, en, sz = ss.find_str(dna.codes_to_seq(seqs[i, :n]))
        assert b <= int(e) < en


@pytest.mark.slow
def test_golden_bg_structural_equivalence():
    """SURVEY §7 gate: rebuild the golden e_coli_10000snp.bg's seqset from
    its own reads with OUR builder — every structure array must be
    bit-identical to the reference-built original."""
    import jax.numpy as jnp

    from biograph_jax.io.bgimport import open_bg_dir
    from biograph_jax.build.seqset_build import build_seqset

    ss, rm, _ = open_bg_dir(os.path.join(GOLDEN, "e_coli_10000snp.bg"))
    fwd = np.nonzero(np.asarray(rm.is_forward))[0]
    entries = rm.entry_of_rm[fwd]
    lens = np.asarray(rm.read_lengths)[fwd]
    L = int(lens.max())
    codes = np.zeros((len(fwd), L), np.uint8)
    for lo in range(0, len(fwd), 1 << 14):
        hi = min(len(fwd), lo + (1 << 14))
        codes[lo:hi] = np.asarray(
            ss.d.sequences(jnp.asarray(entries[lo:hi]), L)
        )
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0).astype(
        np.uint8
    )
    ss2 = build_seqset(codes, lens)
    assert ss2.n_entries == ss.n_entries
    for name in ("entry_sizes", "shared", "fixed", "prev_words", "pop_sel"):
        a = np.asarray(getattr(ss, name))
        b = np.asarray(getattr(ss2, name))
        assert (a == b).all(), f"{name} differs"


@pytest.mark.parametrize("sample", ["father", "mother", "proband"])
def test_lambda_trio_pcmp_genotypes(sample):
    """Coverage-tool genotypes must agree with the reference's own pcmp
    output (<sample>_single_pcmp.vcf) on the lambda trio — includes 100bp
    and 300bp SV deletions and a 100bp insertion."""
    from biograph_jax.api import BioGraph
    from biograph_jax.index.reference import Reference
    from biograph_jax.io.vcf import VcfRecord
    from biograph_jax.variants.coverage_tool import annotate_coverage

    base = "/root/reference/datasets/lambdaToyData/benchmark"
    bg = BioGraph(os.path.join(base, f"{sample}_lambda.bg"))
    ref = Reference.from_reference_dir(os.path.join(base, "ref_lambda"))
    exp = []
    for ln in open(os.path.join(base, f"{sample}_single_pcmp.vcf")):
        if ln.startswith("#"):
            continue
        f = ln.rstrip().split("\t")
        d = dict(zip(f[8].split(":"), f[9].split(":")))
        want = d.get("GT", ".")
        if want == ".":
            want = d.get("PGT", ".")
        exp.append((f[0], int(f[1]), f[3], f[4], want))
    records = [
        VcfRecord(chrom=c, pos=p, ref=r, alt=a) for c, p, r, a, _ in exp
    ]
    ann = annotate_coverage(bg.readmap, ref, records)
    agree = tot = 0
    mism = []
    for i, (c, p, r, a, want) in enumerate(exp):
        if want == ".":
            continue
        tot += 1
        got = ann.gt[i]
        ok = got.replace("|", "/") == want.replace("|", "/") or (
            want == "0/0" and got == "./."
        )
        agree += ok
        if not ok:
            mism.append((c, p, want, got))
    assert agree >= 0.9 * tot, (agree, tot, mism[:4])
