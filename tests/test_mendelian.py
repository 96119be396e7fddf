"""Pedigree parsing and Mendelian-error annotation
(reference: python/biograph/utils.py:684 Pedigree,
python/biograph/tools/mendelian_annotator.py)."""

import json

from biograph_jax.tools.mendelian import classify_allele, me_check, size_cat
from biograph_jax.utils.pedigree import Pedigree

PED = """\
#fam	ind	pat	mat	sex	pheno
fam1	kid1	dad1	mom1	1	2
fam1	dad1	0	0	1	1
fam1	mom1	0	0	2	1
fam2	kid2	dad2	mom2	2	1
"""


def _ped(tmp_path):
    p = tmp_path / "fam.ped"
    p.write_text(PED)
    return Pedigree(str(p))


def test_pedigree_views(tmp_path):
    ped = _ped(tmp_path)
    # ghost parents synthesized for fam2
    assert "dad2" in ped and ped["dad2"].sex == "1"
    assert "mom2" in ped and ped["mom2"].sex == "2"
    assert sorted(s.ind_id for s in ped.get_trio_probands()) == ["kid1", "kid2"]
    assert {s.ind_id for s in ped.all_male()} == {"kid1", "dad1", "dad2"}
    assert {s.ind_id for s in ped.all_affected()} == {"kid1"}
    assert {s.ind_id for s in ped.all_unaffected()} == {"dad1", "mom1", "kid2"}
    assert [s.ind_id for s in ped["dad1"].offspring] == ["kid1"]
    trios = {pr.ind_id: (fa.ind_id, ma.ind_id) for pr, fa, ma in ped.trios()}
    assert trios == {"kid1": ("dad1", "mom1"), "kid2": ("dad2", "mom2")}
    ped.filter(inc_fam=["fam1"])
    assert sorted(ped) == ["dad1", "kid1", "mom1"]


def test_me_check():
    # consistent: one allele from each parent
    assert me_check("0/1", "1/1", "0/0") == 0
    assert me_check("1|0", "0/1", "0/0") == 0
    # inconsistent: child alt absent from both parents
    assert me_check("1/1", "0/0", "0/1") == 1
    assert me_check("0/1", "0/0", "0/0") == 1
    # skips: missing GT; all-hom-ref without ref_count
    assert me_check("./.", "0/1", "0/1") == -1
    assert me_check("0/0", "0/0", "0/0") == -1
    assert me_check("0/0", "0/0", "0/0", ref_count=True) == 0


def test_classify_and_sizecat():
    assert classify_allele("A", "T") == ("REPL", 1)
    assert classify_allele("A", "ATTT") == ("INS", 3)
    assert classify_allele("ACGT", "A") == ("DEL", 3)
    assert classify_allele("ACGTACGT", "ACG") == ("SUBSDEL", 5)
    assert size_cat(3) == "1-9" and size_cat(75) == "50-99"
    assert size_cat(5000) == "gt1000"


VCF = """\
##fileformat=VCFv4.2
##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">
##FORMAT=<ID=DP,Number=1,Type=Integer,Description="DP">
#CHROM	POS	ID	REF	ALT	QUAL	FILTER	INFO	FORMAT	kid1	dad1	mom1	kid2	dad2	mom2
1	100	.	A	T	50	PASS	.	GT:DP	0/1:20	0/1:18	0/0:22	0/0:15	0/0:12	0/0:19
1	200	.	G	GAAAAAAAAAAA	40	PASS	.	GT:DP	1/1:9	0/0:30	0/1:25	0/1:8	0/1:11	0/0:14
1	300	.	C	A	30	PASS	.	GT:DP	./.:.	0/1:10	0/1:10	1/1:5	0/0:9	0/0:7
"""


def test_annotate_vcf_cli(tmp_path, capsys):
    from biograph_jax.cli import main

    ped = tmp_path / "fam.ped"
    ped.write_text(PED)
    vcf = tmp_path / "fam.vcf"
    vcf.write_text(VCF)
    out = tmp_path / "anno.vcf"
    main(
        [
            "mendelian",
            "-v", str(vcf),
            "-p", str(ped),
            "-o", str(out),
        ]
    )
    assert "3 variants" in capsys.readouterr().out
    lines = [l for l in out.read_text().splitlines() if not l.startswith("#")]
    info = {l.split("\t")[1]: l.split("\t")[7] for l in lines}
    # site 100: fam1 consistent (0/1 from dad), fam2 all-hom-ref skipped
    assert "MEF" not in info["100"] and "sizeCat=1-9" in info["100"]
    # site 200: fam1 kid 1/1 but dad 0/0 -> error; fam2 0/1 consistent
    assert "MEF=fam1" in info["200"] and "sizeCat=10-49" in info["200"]
    # site 300: fam1 skipped (missing GT); fam2 1/1 from 0/0 parents -> error
    assert "MEF=fam2" in info["300"]
    # reports
    rep = json.load(open(tmp_path / "anno_stats.json"))
    assert rep["var_count"] == 3
    assert rep["fam1"]["type_counts"]["INS"] == {"tot": 1, "err": 1, "pct": 1.0}
    assert rep["fam1"]["type_counts"]["REPL"]["tot"] == 1
    assert rep["fam2"]["type_counts"]["REPL"] == {"tot": 1, "err": 1, "pct": 1.0}
    # depth bucketing: fam1's INS trio min DP is 9 -> bucket "1"
    assert rep["fam1"]["cov_size_me"]["1"]["10-49"]["tot"] == 1
    assert (tmp_path / "anno_stats.txt").read_text().startswith("var_count\t3")


def test_golden_lambda_meanno(tmp_path):
    """Gate against the reference's own shipped mendelian-annotator output
    (datasets/lambdaToyData/benchmark/family_pcmp_meanno.vcf + stats).  The
    golden files predate the current size ladder (they use '50-299'), so the
    gate checks the version-stable facts: which sites carry a family error
    (MEF) and the per-type total/error counts."""
    import os

    bench = "/root/reference/datasets/lambdaToyData/benchmark"
    golden = os.path.join(bench, "family_pcmp_meanno.vcf")
    if not os.path.isfile(golden):
        import pytest

        pytest.skip("lambda benchmark data not present")
    ped = tmp_path / "lam.ped"
    ped.write_text(
        "lamfam0\tproband\tfather\tmother\t1\t2\n"
        "lamfam0\tfather\t0\t0\t1\t1\n"
        "lamfam0\tmother\t0\t0\t2\t1\n"
    )
    out = tmp_path / "meanno.vcf"
    from biograph_jax.tools.mendelian import annotate_vcf
    from biograph_jax.utils.pedigree import Pedigree

    rep = annotate_vcf(
        os.path.join(bench, "family_pcmp.vcf"), str(out), Pedigree(str(ped))
    )

    def mef_sites(path):
        out = set()
        for ln in open(path):
            if ln.startswith("#"):
                continue
            f = ln.split("\t")
            if "MEF=" in f[7]:
                out.add((f[0], int(f[1]), f[3], f[4]))
        return out

    assert mef_sites(str(out)) == mef_sites(golden)
    got = rep.finalize()["overall"]["type_counts"]
    want = json.load(
        open(os.path.join(bench, "family_pcmp_meanno_stats.json"))
    )["overall"]["type_counts"]
    for t in ("DEL", "INS", "REPL", "SUBSDEL", "SUBSINS"):
        assert (got[t]["tot"], got[t]["err"]) == (want[t]["tot"], want[t]["err"]), t
