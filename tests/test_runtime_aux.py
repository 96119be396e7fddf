"""Aux runtime pieces: VCF ordering canary, exclusion regions, runtime stats.

Reference analogs: the sorted-output pipeline invariant (an unsorted VCF is
an upstream bug, modules/variants/assemble.cpp ordering verifier),
rvg_exclude (modules/variants/rvg_exclude.h), and runtime_stats
(modules/io/runtime_stats.h:14-50) + autostats counters.
"""

import io
import json

import numpy as np
import pytest


def test_vcf_writer_ordering_canary():
    from biograph_jax.io.vcf import VcfRecord, VcfWriter

    buf = io.StringIO()
    w = VcfWriter(buf, sample="s")
    w.write(VcfRecord(chrom="c1", pos=10, ref="A", alt="T"))
    w.write(VcfRecord(chrom="c1", pos=10, ref="A", alt="G"))  # ties ok
    w.write(VcfRecord(chrom="c2", pos=5, ref="A", alt="T"))  # new contig ok
    with pytest.raises(ValueError, match="order violation"):
        w.write(VcfRecord(chrom="c2", pos=4, ref="A", alt="T"))
    with pytest.raises(ValueError, match="re-entered"):
        w.write(VcfRecord(chrom="c1", pos=99, ref="A", alt="T"))


class _Contig:
    def __init__(self, start):
        self.start = start


class _Ref:
    def __init__(self, starts):
        self._c = {k: _Contig(v) for k, v in starts.items()}

    def contig_by_name(self, n):
        return self._c[n]


def test_bed_exclusion_intervals(tmp_path):
    from biograph_jax.cli import _flat_overlaps, _load_bed

    ref = _Ref({"c1": 0, "c2": 1000})
    bed = tmp_path / "x.bed"
    bed.write_text(
        "track name=excl\n"
        "c1\t10\t20\n"
        "c1\t15\t30\n"  # overlaps previous -> merged [10,30)
        "c2\t5\t8\n"
    )
    iv = _load_bed(ref, str(bed))
    assert iv.tolist() == [[10, 30], [1005, 1008]]
    assert _flat_overlaps(iv, 12, 13)
    assert _flat_overlaps(iv, 29, 40)  # spans the merged end
    assert _flat_overlaps(iv, 0, 11)
    assert not _flat_overlaps(iv, 30, 40)  # half-open: 30 is outside
    assert not _flat_overlaps(iv, 0, 10)
    assert _flat_overlaps(iv, 1005, 1006)
    assert not _flat_overlaps(iv, 1008, 1010)


def test_progress_runtime_stats():
    from biograph_jax.runtime.log import Progress

    p = Progress(label="t")
    with p.stage("alpha"):
        sum(range(10000))
    p.add("num_reads", 7)
    p.count("widgets")
    p.count("widgets", 2)
    d = p.stats_dict()
    assert [s["name"] for s in d["stages"]] == ["alpha"]
    s = d["stages"][0]
    assert s["wall_seconds"] >= 0 and "cpu_user_seconds" in s and s["end_time"] > 0
    assert d["counters"] == {"num_reads": 7, "widgets": 3}
    json.dumps(d)  # must be JSON-serializable as written to create_stats.json
