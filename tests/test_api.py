import numpy as np
import pytest

from biograph_jax.api import BioGraph, Sequence
from biograph_jax.core import dna
from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.build.readmap_build import build_readmap


def test_sequence_ops():
    s = Sequence("ACGTT")
    assert str(s) == "ACGTT"
    assert len(s) == 5
    assert s.rev_comp() == "AACGT"
    assert s[1:3] == "CG"


@pytest.fixture(scope="module")
def sample_bgt(tmp_path_factory):
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=1500, dtype=np.uint8)
    L = 30
    starts = rng.integers(0, 1500 - L, size=300)
    codes = np.stack([genome[s : s + L] for s in starts])
    lens = np.full(300, L, np.int32)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    d = tmp_path_factory.mktemp("bgt") / "sample.bgt"
    import os, json

    os.makedirs(d, exist_ok=True)
    ss.save(str(d / "seqset"))
    rm.save(str(d / "readmap"))
    (d / "metadata.json").write_text(json.dumps({"accession_id": "t"}))
    return str(d), genome, codes


def test_biograph_bgt_roundtrip(sample_bgt):
    path, genome, codes = sample_bgt
    bg = BioGraph(path)
    assert bg.num_reads == 300
    read = dna.codes_to_seq(codes[0])
    e = bg.find(read)
    assert e.valid
    assert str(e.sequence())[: len(read)] == read
    # navigation: pop then push recovers a sub-range
    popped = e.pop_front()
    assert popped.size == e.size - 1
    # coverage over a genome window
    cov = bg.seq_coverage(dna.codes_to_seq(genome[200:260]))
    assert cov.max() >= 1


def test_biograph_opens_reference_bg():
    bg = BioGraph(
        "/root/reference/datasets/lambdaToyData/benchmark/father_lambda.bg"
    )
    assert bg.seqset.n_entries == 98006
    assert bg.metadata.get("accession_id") == "father"
    e = bg.entry(0)
    s = str(e.sequence(20))
    assert bg.find(s).valid


def test_biograph_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        BioGraph(str(tmp_path / "nope"))


def test_sdk_read_handles_and_ranges(sample_bgt):
    """ReadmapRead / ReadmapPairStats / ReferenceRange / version exports
    (reference python/biograph/__init__.py export list)."""
    import biograph_jax
    from biograph_jax.index.reference import Reference

    path, genome, codes = sample_bgt
    bg = BioGraph(path)

    r = bg.read(0)
    assert r.length > 0
    s = r.sequence()
    assert len(s) == r.length
    rc = r.rev_comp()
    assert rc.length == r.length
    assert str(rc.sequence()) == str(s.rev_comp())
    assert r.mate() is None or r.mate().length > 0

    stats = bg.pair_stats()
    assert stats["paired_reads"] + stats["unpaired_reads"] == bg.num_reads

    ref = Reference(
        flat=genome,
        is_n=(genome == 255),
        contigs=[__import__("biograph_jax.index.reference", fromlist=["Contig"]).Contig("g", 0, len(genome))],
    )
    rr = ref.make_range("g", 100, 160)
    assert rr.size == 60
    assert str(rr.sequence()) == dna.codes_to_seq(genome[100:160])
    import pytest as _pytest

    with _pytest.raises(ValueError):
        ref.make_range("g", 50, len(genome) + 1)

    assert biograph_jax.version() == biograph_jax.__version__
    assert isinstance(biograph_jax.build_revision(), str)

    from biograph_jax.utils import genotyper

    gt, gq = genotyper(30, 15)
    assert gt == "0/1" and gq > 0
    gts, gqs = genotyper([30, 30, 30], [0, 15, 30])
    assert list(gts) == ["0/0", "0/1", "1/1"]
