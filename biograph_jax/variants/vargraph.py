"""Variant-graph joint evaluation.

Counterpart of the reference's vargraph (modules/vargraph/vargraph.h:13-45):
build a graph of reference nodes and alt-allele edges from VCF records,
traverse the read set counting traversals per edge, and genotype jointly.
The block/graph walking role of apply_block/apply_edges/apply_graph
(modules/variants/apply_block.h etc.) is covered by the same machinery:
nearby records form a window cluster, every realizable haplotype path
through the cluster is materialized, and read support is measured ON the
path sequence, so each edge is evaluated with its true joint context
(a het next to a long insertion keeps its flank reads).

Device shape: one readmap.coverage launch scores EVERY (path, position) lane of
a cluster batch at once — the reference's per-edge pointer walk becomes a
dense [paths, window] depth matrix and the per-edge counts are window mins.

Per-edge counts take the max over all paths carrying the edge — each edge
is scored in its most favorable joint context, so a true variant keeps its
support through the path where a neighboring junk call reverts to ref
(the all-alt donor evaluation in coverage_tool cannot do this).  Genotypes
come from the edge counts via the binomial model (utils.py:532 via
coverage_tool.genotyper_log10), with multi-allelic het-alt (j/k) when two
alt edges carry balanced support — the states two haplotype paths realize.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import List, Sequence

import numpy as np
import jax.numpy as jnp

from biograph_jax.core import dna
from biograph_jax.io.vcf import VcfRecord


@dataclass
class VarGraphResult:
    gt: List[str]  # joint genotype per record
    edge_reads: List[np.ndarray]  # per record: int32 [n_alts] best-path edge depth
    ref_reads: np.ndarray  # int32 [N] ref-edge depth (from the best ref-carrying path)
    cluster_of: np.ndarray  # int32 [N] cluster id (-1 = not evaluable)
    n_paths: np.ndarray  # int32 [N] paths enumerated for the record's cluster


def _is_dna(s: str) -> bool:
    return bool(s) and all(c in "ACGTacgt" for c in s)


def _clusters(flat_pos, ends, valid, reach: int, max_sites: int):
    """Group record indices whose windows overlap within `reach` bases;
    clusters cap at max_sites (ploid_limit analog — an over-dense window
    splits rather than exploding the path set)."""
    order = sorted((i for i in range(len(flat_pos)) if valid[i]),
                   key=lambda i: flat_pos[i])
    out: List[List[int]] = []
    cur: List[int] = []
    cur_end = -1
    for i in order:
        if cur and (flat_pos[i] - cur_end > reach or len(cur) >= max_sites):
            out.append(cur)
            cur = []
        cur.append(i)
        cur_end = max(cur_end, ends[i])
    if cur:
        out.append(cur)
    return out


def _path_seq(ref_flat, lo, hi, sites, choice):
    """Window [lo, hi) of the reference with chosen allele edits applied.
    sites: list of (pos, ref_codes, [alt_codes...]) ascending; choice[j] = 0
    for ref or 1-based alt index.  Returns (codes, site_spans) where
    site_spans[j] = (start, end) of site j's allele in path coordinates."""
    parts = []
    spans = []
    cur = lo
    for (p0, ra, alts), c in zip(sites, choice):
        parts.append(ref_flat[cur:p0])
        allele = ra if c == 0 else alts[c - 1]
        start = sum(len(x) for x in parts)
        parts.append(allele)
        spans.append((start, start + len(allele)))
        cur = p0 + len(ra)
    parts.append(ref_flat[cur:hi])
    return np.concatenate(parts), spans


def evaluate_vargraph(
    readmap,
    reference,
    records: List[VcfRecord],
    max_sites: int = 4,
    max_paths: int = 16,
    min_depth: int = 1,
) -> VarGraphResult:
    """Per-edge read counts + joint diploid genotypes over window clusters."""
    from biograph_jax.variants.coverage_tool import genotyper_log10

    N = len(records)
    C = int(readmap.max_read_len) + 2
    WIN_CAP = 192  # long-allele edges score at their breakpoints
    ref_flat = np.asarray(reference.flat)
    G = len(ref_flat)

    flat_pos = np.zeros(N, np.int64)
    ends = np.zeros(N, np.int64)
    valid = np.ones(N, bool)
    sites_of: List = [None] * N
    for i, rec in enumerate(records):
        alts = rec.alt.split(",")
        if not _is_dna(rec.ref) or not all(_is_dna(a) for a in alts):
            valid[i] = False
            continue
        contig = reference.contig_by_name(rec.chrom)
        p0 = contig.start + rec.pos - 1
        flat_pos[i] = p0
        ends[i] = p0 + len(rec.ref)
        # cap alleles per site at 2 alts (keeps paths <= 3^max_sites before
        # the max_paths cut; reference limit_alleles plays the same role)
        sites_of[i] = (
            p0,
            np.asarray(dna.seq_to_codes(rec.ref), np.uint8),
            [np.asarray(dna.seq_to_codes(a), np.uint8) for a in alts[:2]],
        )

    gt = ["./."] * N
    edge_reads = [np.zeros(max(len(records[i].alt.split(",")), 1), np.int32)
                  for i in range(N)]
    ref_reads = np.zeros(N, np.int32)
    cluster_of = np.full(N, -1, np.int32)
    n_paths_out = np.zeros(N, np.int32)

    clusters = _clusters(flat_pos, ends, valid, reach=C, max_sites=max_sites)
    for ci, idxs in enumerate(clusters):
        sites = [sites_of[i] for i in idxs]
        lo = max(int(flat_pos[idxs[0]]) - C, 0)
        hi = min(int(max(ends[i] for i in idxs)) + C, G)

        # allele choices per site, trimmed until the path count fits
        n_allele = [1 + len(s[2]) for s in sites]
        while int(np.prod(n_allele)) > max_paths and max(n_allele) > 2:
            n_allele[int(np.argmax(n_allele))] -= 1
        choices = list(product(*[range(n) for n in n_allele]))
        if len(choices) > max_paths:
            # over-dense even at 2 alleles/site: keep ref path + single-alt
            # paths + the all-alt path (star topology)
            star = [tuple(0 for _ in sites)]
            for j in range(len(sites)):
                c = [0] * len(sites)
                c[j] = 1
                star.append(tuple(c))
            star.append(tuple(1 for _ in sites))
            choices = star

        paths = []
        spans = []
        for ch in choices:
            seq, sp = _path_seq(ref_flat, lo, hi, sites, ch)
            paths.append(seq)
            spans.append(sp)

        # one coverage launch for the whole cluster: depth at every
        # position of every path
        L = max(len(p) for p in paths)
        qc = np.zeros((len(paths), L), np.uint8)
        ql = np.zeros(len(paths), np.int32)
        for j, p in enumerate(paths):
            qc[j, : len(p)] = p
            ql[j] = len(p)
        fwd, rev = readmap.coverage(jnp.asarray(qc), jnp.asarray(ql))
        tot = np.asarray(fwd + rev)

        # per (path, site) edge depth: min depth across the allele span
        # widened by one base each side (a traversal must cross the edge);
        # long alleles score at their two breakpoint windows
        P, S = len(choices), len(sites)
        D = np.zeros((P, S), np.int32)
        for p in range(P):
            for s in range(S):
                a, b = spans[p][s]
                a2, b2 = max(a - 1, 0), min(b + 1, int(ql[p]))
                if b - a > 2 * WIN_CAP + C:
                    wl = tot[p, a2 : a + WIN_CAP]
                    wr = tot[p, b - WIN_CAP : b2]
                    D[p, s] = min(int(wl.min()), int(wr.min()))
                else:
                    D[p, s] = int(tot[p, a2:b2].min()) if b2 > a2 else 0

        # per-edge traversal counts: best depth of each allele edge over ALL
        # paths carrying it (reference vargraph reports per-edge coverage;
        # the max-over-paths gives every edge its most favorable joint
        # context — a true variant next to a junk call keeps full support
        # through the path where the junk edge is ref)
        ch = np.asarray(choices, np.int32)  # [P, S]
        for s, i in enumerate(idxs):
            cluster_of[i] = ci
            n_paths_out[i] = P
            n_alts = len(sites[s][2])
            er = np.zeros(max(n_alts, 1), np.int32)
            for ai in range(n_alts):
                carry = ch[:, s] == ai + 1
                er[ai] = int(D[carry, s].max()) if carry.any() else 0
            edge_reads[i] = er
            carry0 = ch[:, s] == 0
            ref_reads[i] = int(D[carry0, s].max()) if carry0.any() else 0

            # diploid state from the edge counts (same binomial model as
            # annotate_coverage; states are what two haplotype paths can
            # realize: ref/het/hom of one alt, or het-alt of two)
            d_ref = int(ref_reads[i])
            k = int(np.argmax(er)) + 1
            d_alt = int(er[k - 1])
            tot_c = d_alt + d_ref
            if tot_c < min_depth:
                gt[i] = "./."
                continue
            gl = genotyper_log10(np.asarray([max(tot_c, 1)]), np.asarray([d_alt]))[0]
            state = int(np.argmax(gl))
            g = {0: "0/0", 1: f"0/{k}", 2: f"{k}/{k}"}[state]
            if n_alts >= 2:
                d = er.astype(np.int64)
                o2 = np.argsort(-d)
                a1, a2 = int(o2[0]), int(o2[1])
                total = int(d.sum()) + d_ref
                if d[a2] >= 3 and d[a2] >= 0.25 * total and d_ref < 0.2 * total:
                    g = f"{min(a1, a2) + 1}/{max(a1, a2) + 1}"
            gt[i] = g

    return VarGraphResult(
        gt=gt,
        edge_reads=edge_reads,
        ref_reads=ref_reads,
        cluster_of=cluster_of,
        n_paths=n_paths_out,
    )
