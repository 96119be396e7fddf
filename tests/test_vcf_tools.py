"""Cohort VCF utilities: sample paste, freq filter, ML table + exact HWE
(reference: tools/vcf_sample_paste.py, freq_filter.py, vcf_to_ml_table.py)."""

import math

import pytest

from biograph_jax.tools.vcf_tools import (
    freq_filter,
    hwe_exact,
    sample_paste,
    vcf_to_ml_table,
)


def _brute_hwe(n_het, n_hom_rare, n_hom_common):
    """Exact het-count distribution from first principles
    (Wigginton 2005 eq. 1: multinomial genotype configs over fixed allele
    counts)."""
    n = n_het + n_hom_rare + n_hom_common
    n_rare = 2 * n_hom_rare + n_het
    probs = {}
    for het in range(n_rare % 2, n_rare + 1, 2):
        hom_r = (n_rare - het) // 2
        hom_c = n - het - hom_r
        if hom_c < 0:
            continue
        probs[het] = (
            math.comb(n, hom_r)
            * math.comb(n - hom_r, het)
            * 2**het
            / math.comb(2 * n, n_rare)
        )
    tot = sum(probs.values())
    obs = probs[n_het] / tot
    p_hwe = sum(p for p in probs.values() if p / tot <= obs * (1 + 1e-12)) / tot
    p_exc = sum(p for h, p in probs.items() if h >= n_het) / tot
    return p_hwe, p_exc


@pytest.mark.parametrize(
    "het,hom_r,hom_c",
    [(57, 14, 50), (20, 0, 80), (0, 10, 90), (3, 1, 2), (100, 0, 0), (1, 0, 1)],
)
def test_hwe_exact_matches_bruteforce(het, hom_r, hom_c):
    got = hwe_exact(het, hom_r, hom_c)
    want = _brute_hwe(het, hom_r, hom_c)
    assert got[0] == pytest.approx(want[0], rel=1e-9)
    assert got[1] == pytest.approx(want[1], rel=1e-9)


def _single_sample_vcf(path, sample, rows):
    lines = [
        "##fileformat=VCFv4.2",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="AD">',
        f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}",
    ]
    for chrom, pos, ref, alt, gt, ad in rows:
        lines.append(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t50\tPASS\t.\tGT:AD\t{gt}:{ad}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


SITES = [("1", 100, "A", "T"), ("1", 200, "G", "C"), ("2", 9, "T", "TA")]


def test_sample_paste_and_freq_filter(tmp_path):
    v1 = _single_sample_vcf(
        tmp_path / "s1.vcf", "S1",
        [(c, p, r, a, "0/1", "8,5") for c, p, r, a in SITES],
    )
    v2 = _single_sample_vcf(
        tmp_path / "s2.vcf", "S2",
        [
            (SITES[0] + ("1/1", "0,9")),
            (SITES[1] + ("./.", ".")),
            (SITES[2] + ("0/0", "12,0")),
        ],
    )
    out = tmp_path / "pasted.vcf"
    assert sample_paste([v1, v2], str(out)) == 3
    head = [l for l in out.read_text().splitlines() if l.startswith("#CHROM")][0]
    assert head.endswith("S1\tS2")
    body = [l.split("\t") for l in out.read_text().splitlines() if not l.startswith("#")]
    assert body[0][9].startswith("0/1") and body[0][10].startswith("1/1")

    # mismatched loci rejected
    v3 = _single_sample_vcf(
        tmp_path / "s3.vcf", "S3", [("1", 101, "A", "T", "0/1", "1,1")] * 3
    )
    with pytest.raises(ValueError, match="loci mismatch"):
        sample_paste([v1, v3], str(tmp_path / "x.vcf"))

    # freq_filter: site2 has 5 alt obs in 1 individual (S2 missing)
    fout = tmp_path / "filtered.vcf"
    stats = freq_filter(str(out), str(fout), min_observations=6, min_individuals=2)
    kept = [l for l in fout.read_text().splitlines() if not l.startswith("#")]
    assert stats["pass"] == len(kept)
    poss = {l.split("\t")[1] for l in kept}
    assert "200" not in poss  # 5 obs < 6 and 1 indiv < 2
    assert "100" in poss  # 5+9 obs, 2 indivs


def test_vcf_to_ml_table(tmp_path):
    # 4 diploid samples at one site: 1 hom-alt, 2 het, 1 hom-ref
    lines = [
        "##fileformat=VCFv4.2",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="AD">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA\tB\tC\tD",
        "1\t100\t.\tA\tT\t50\tPASS\t.\tGT:AD\t1/1:0,9\t0/1:5,4\t0/1:6,3\t0/0:11,0",
    ]
    p = tmp_path / "cohort.vcf"
    p.write_text("\n".join(lines) + "\n")
    out = tmp_path / "table.tsv"
    assert vcf_to_ml_table(str(p), str(out)) == 2  # ref row + 1 alt row
    rows = out.read_text().splitlines()
    header = rows[0].split("\t")
    assert header[:2] == ["pos", "AF"] and header[-4:] == ["A", "B", "C", "D"]
    ref_row = rows[1].split("\t")
    alt_row = rows[2].split("\t")
    assert ref_row[0] == "bg_1:100.0" and alt_row[0] == "bg_1:100.1"
    # AC = 2*1 + 2 = 4 of AN 8 -> AF 0.5; AC_Het 2; AC_Hom 2
    stats = dict(zip(["AF", "MAF", "AC", "AC_Het", "AC_Hom", "AC_Hemi", "HWE", "ExcHet"], alt_row[1:9]))
    assert stats["AF"] == "0.5" and stats["AC"] == "4"
    assert stats["AC_Het"] == "2" and stats["AC_Hom"] == "2"
    want_hwe, want_exc = _brute_hwe(2, 1, 1)
    assert float(stats["HWE"]) == pytest.approx(want_hwe, rel=1e-6)
    assert float(stats["ExcHet"]) == pytest.approx(want_exc, rel=1e-6)
    # per-sample AD columns: ref row carries the ref depths, alt row the alt
    assert ref_row[-4:] == ["0", "5", "6", "11"]
    assert alt_row[-4:] == ["9", "4", "3", "0"]


def test_rvg_cleaner(tmp_path):
    """SVs kept; pair-backed smalls kept; phase-linked smalls kept (even
    retroactively from the backlog); pair-bare unphased noise dropped
    (rvg_cleaner.py behavior with PS/PC standing in for PI/PDP)."""
    from biograph_jax.tools.vcf_tools import rvg_cleaner

    lines = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS",
        # pair-bare small in phase set 7 BEFORE its SV -> backlog, flushed
        "1\t50\t.\tA\tT\t9\tPASS\tPC=0\tGT:PS\t0|1:7",
        # noise: no pairs, no phase
        "1\t60\t.\tG\tC\t9\tPASS\tPC=0\tGT\t0/1",
        # pair-backed small -> kept
        "1\t70\t.\tT\tG\t9\tPASS\tPC=4\tGT\t0/1",
        # the SV in phase set 7
        "1\t100\t.\t" + "A" * 60 + "\tA\t50\tPASS\tSVLEN=-59;PC=9\tGT:PS\t1|1:7",
        # later small in the now-known phase set -> kept directly
        "1\t200\t.\tC\tA\t9\tPASS\tPC=0\tGT:PS\t1|0:7",
        # chromosome change resets state: phase 7 no longer known
        "2\t10\t.\tA\tG\t9\tPASS\tPC=0\tGT:PS\t0|1:7",
    ]
    src = tmp_path / "in.vcf"
    src.write_text("\n".join(lines) + "\n")
    out = tmp_path / "out.vcf"
    stats = rvg_cleaner(str(src), str(out))
    body = [l.split("\t")[1] for l in open(out) if not l.startswith("#")]
    # 70 kept on pairs; SV at 100 flushes backlogged 50; 200 in-phase
    assert body == ["70", "100", "50", "200"]
    assert stats == {"sv": 1, "paired": 1, "inphase": 2, "dropped": 2}
