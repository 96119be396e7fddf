"""SDK generator-pipeline surface (reference: biograph.variants generators,
python/biograph/variants/__init__.py:4-47 + par_pipeline.h)."""

import os
import subprocess
import sys

import pytest

LAMBDA = "/root/reference/datasets/lambdaToyData/benchmark"


@pytest.fixture(scope="module")
def father_bgt(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gen") / "father.bgt")
    r = subprocess.run(
        [
            sys.executable, "-m", "biograph_jax", "--platform", "cpu",
            "upgrade", "--in", os.path.join(LAMBDA, "father_lambda.bg"),
            "--out", out,
        ],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return out


@pytest.mark.slow
def test_generator_chain_lambda(father_bgt, tmp_path):
    """parse_region -> trim_ref -> add_ref_assemblies -> generate_read_cov
    -> generate_pair_cov -> split_phases -> dedup -> vcf_export, with the
    read-cov stage running inside par_pipeline; output matches the
    discovery CLI's calls for the same biograph."""
    from biograph_jax.api import BioGraph
    from biograph_jax.index.reference import Reference
    from biograph_jax.variants import generators as bgexvar
    from biograph_jax.variants.discover import DiscoverOptions

    bg = BioGraph(father_bgt)
    ref = Reference.from_reference_dir(os.path.join(LAMBDA, "ref_lambda"))
    cname = ref.contigs[0].name
    region = f"{cname}:0-{int(ref.contigs[0].length)}"

    opt = DiscoverOptions(min_alt_support=5)
    recs = bgexvar.parse_region(bg, ref, region, opt=opt)
    recs = bgexvar.trim_ref(recs, ref)
    recs = bgexvar.add_ref_assemblies(recs, ref, region)
    recs = bgexvar.par_pipeline(
        lambda it: bgexvar.generate_read_cov(bg.readmap, ref, it), recs
    )
    recs = bgexvar.generate_pair_cov(bg.readmap, ref, recs)
    recs = bgexvar.split_phases(bg.readmap, ref, recs)
    # ordering canary between stages (global_set_verify_order analog — the
    # reference keeps it on in every test, biograph_variants.cpp:639)
    recs = bgexvar.verify_order(recs, "post-phase")
    recs = list(bgexvar.dedup_cov_reads(recs))

    refblocks = [r for r in recs if r.info.get("REFBLOCK")]
    variants = [r for r in recs if not r.info.get("REFBLOCK")]
    assert len(variants) >= 8  # the reference's own 8 lambda calls
    assert refblocks, "ref assemblies fill uncovered stretches"
    # ref blocks + variants tile the region in order
    assert recs[0].pos == 1 and recs[0].info.get("REFBLOCK")
    for r in variants:
        assert r.fmt.get("GT") in ("0/1", "1/1", "0/0") or "|" in str(r.fmt["GT"])
        assert int(r.fmt["DP"]) > 0 and "PL" in r.fmt
        assert "PC" in r.info

    out = str(tmp_path / "gen.vcf")
    n = bgexvar.vcf_export(recs, out, ref, sample="father")
    assert n == len(variants)
    body = [l for l in open(out) if not l.startswith("#")]
    assert len(body) == n and "GT:" in body[0].split("\t")[8] + ":"


def test_par_pipeline_propagates_errors():
    from biograph_jax.variants import generators as bgexvar

    def boom(it):
        for i, x in enumerate(it):
            if i == 3:
                raise RuntimeError("stage failed")
            yield x

    out = []
    with pytest.raises(RuntimeError, match="stage failed"):
        for x in bgexvar.par_pipeline(boom, range(10)):
            out.append(x)
    assert out == [0, 1, 2]


def test_trim_ref_rejects_wrong_ref(tmp_path):
    import numpy as np

    from biograph_jax.index.reference import Reference, Contig
    from biograph_jax.io.vcf import VcfRecord
    from biograph_jax.variants import generators as bgexvar

    flat = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.uint8)  # ACGTACGT
    ref = Reference(
        flat=flat, is_n=np.zeros(8, bool), contigs=[Contig("c", 0, 8)]
    )
    ok = VcfRecord("c", 2, "C", "T")
    bad = VcfRecord("c", 2, "G", "T")
    same = VcfRecord("c", 3, "G", "G")
    got = list(bgexvar.trim_ref([ok, same], ref))
    assert got == [ok]  # alt==ref dropped
    with pytest.raises(ValueError, match="!= reference"):
        list(bgexvar.trim_ref([bad], ref))


def test_verify_order_catches_disorder():
    from biograph_jax.io.vcf import VcfRecord
    from biograph_jax.variants import generators as bgexvar

    ok = [
        VcfRecord(chrom="c", pos=1, ref="A", alt="T"),
        VcfRecord(chrom="c", pos=5, ref="A", alt="T"),
    ]
    assert len(list(bgexvar.verify_order(iter(ok)))) == 2
    bad = [ok[1], ok[0]]
    import pytest

    with pytest.raises(AssertionError, match="verify_order"):
        list(bgexvar.verify_order(iter(bad)))
