"""Variant-graph joint evaluation (modules/vargraph/vargraph.h analog).

Reads are constructed from known haplotypes; the graph evaluator must count
edge traversals with joint context and pick the diploid path pair that the
haplotypes actually form — including trans multi-allelic (1/2) calls that
per-variant genotyping cannot express, and rejection of allele combinations
no read supports.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from biograph_jax.build.readmap_build import build_readmap
from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.io.vcf import VcfRecord
from biograph_jax.variants.vargraph import evaluate_vargraph


class FakeRef:
    def __init__(self, flat):
        self.flat = flat
        self.is_n = np.zeros(len(flat), bool)

    def contig_by_name(self, name):
        class C:
            start = 0

        return C()


def _reads_from(haps, L=40, step=2, rng=None):
    rows = []
    for h in haps:
        for s in range(0, len(h) - L + 1, step):
            r = h[s : s + L].copy()
            if rng is not None and rng.random() < 0.5:
                r = (3 - r)[::-1].copy()
            rows.append(r)
    codes = np.stack(rows).astype(np.uint8)
    lens = np.full(len(rows), L, np.int32)
    return codes, lens


@pytest.fixture(scope="module")
def base():
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 900).astype(np.uint8)
    return ref, rng


def _gt_map(ref, haps, records, rng):
    codes, lens = _reads_from(haps, rng=rng)
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    res = evaluate_vargraph(rm, FakeRef(ref), records)
    return res


@pytest.mark.slow
def test_cis_het_pair(base):
    """Two nearby het SNPs on the same haplotype: joint GT 0/1 + 0/1 with
    both alt edges supported on the alt-alt path."""
    ref, rng = base
    hap1 = ref.copy()
    hap1[400] = (ref[400] + 1) % 4
    hap1[420] = (ref[420] + 2) % 4
    from biograph_jax.core import dna

    records = [
        VcfRecord("c", 401, dna.codes_to_seq(ref[400:401]),
                  dna.codes_to_seq(hap1[400:401])),
        VcfRecord("c", 421, dna.codes_to_seq(ref[420:421]),
                  dna.codes_to_seq(hap1[420:421])),
    ]
    res = _gt_map(ref, [hap1, ref], records, rng)
    assert res.gt == ["0/1", "0/1"]
    assert res.cluster_of[0] == res.cluster_of[1]  # one joint window
    assert all(er[0] > 0 for er in res.edge_reads)
    assert (res.ref_reads > 0).all()


def test_trans_multiallelic(base):
    """One site, different alt on each haplotype: joint GT is 1/2 —
    expressible only through the path-pair model."""
    ref, rng = base
    hap1 = ref.copy()
    hap2 = ref.copy()
    hap1[500] = (ref[500] + 1) % 4
    hap2[500] = (ref[500] + 2) % 4
    from biograph_jax.core import dna

    records = [
        VcfRecord(
            "c", 501, dna.codes_to_seq(ref[500:501]),
            dna.codes_to_seq(hap1[500:501]) + "," + dna.codes_to_seq(hap2[500:501]),
        )
    ]
    res = _gt_map(ref, [hap1, hap2], records, rng)
    assert res.gt == ["1/2"]
    assert res.edge_reads[0][0] > 0 and res.edge_reads[0][1] > 0
    assert res.ref_reads[0] == 0


@pytest.mark.slow
def test_hom_and_unsupported_edge(base):
    """A hom-alt deletion plus a second record whose alt no read supports:
    the joint pick keeps the hom path pair and calls the junk 0/0."""
    ref, rng = base
    hap = np.concatenate([ref[:600], ref[610:]])  # 10bp deletion on BOTH haps
    from biograph_jax.core import dna

    records = [
        VcfRecord("c", 600, dna.codes_to_seq(ref[599:610]),
                  dna.codes_to_seq(ref[599:600])),
        VcfRecord("c", 640, dna.codes_to_seq(ref[639:640]),
                  dna.codes_to_seq((ref[639:640] + 1) % 4)),
    ]
    res = _gt_map(ref, [hap, hap], records, rng)
    assert res.gt[0] == "1/1"
    assert res.gt[1] in ("0/0", "./.")
    assert res.edge_reads[1][0] == 0  # no traversal of the junk edge


def test_symbolic_alt_skipped(base):
    ref, rng = base
    records = [VcfRecord("c", 100, "A", "<DEL>")]
    res = _gt_map(ref, [ref], records, rng)
    assert res.gt == ["./."] and res.cluster_of[0] == -1


def test_joint_context_beats_allalt_donor(base):
    """A true het SNP 4bp from an unsupported junk call: the all-alt donor
    window carries the junk edit, destroying the true variant's read
    support; the graph walk scores the (alt, ref) path and keeps it."""
    ref, rng = base
    hap1 = ref.copy()
    hap1[700] = (ref[700] + 1) % 4
    from biograph_jax.core import dna

    records = [
        VcfRecord("c", 701, dna.codes_to_seq(ref[700:701]),
                  dna.codes_to_seq(hap1[700:701])),
        VcfRecord("c", 705, dna.codes_to_seq(ref[704:705]),
                  dna.codes_to_seq((ref[704:705] + 3) % 4)),  # junk
    ]
    codes, lens = _reads_from([hap1, ref], rng=np.random.default_rng(9))
    ss = build_seqset(codes, lens)
    rm = build_readmap(ss, codes, lens)
    res = evaluate_vargraph(rm, FakeRef(ref), records)
    assert res.gt[0] == "0/1" and res.edge_reads[0][0] > 0
    assert res.gt[1] in ("0/0", "./.")

    # the all-alt donor evaluation undercounts the true allele here
    from biograph_jax.variants.coverage_tool import annotate_coverage

    ann = annotate_coverage(rm, FakeRef(ref), records)
    assert ann.alt_depth[0] < res.edge_reads[0][0]
