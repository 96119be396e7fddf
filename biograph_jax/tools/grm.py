"""Breakend-mappability annotation (the `grm` pipeline stage).

The reference shells out to `truvari anno grm` (python/biograph/tools/
bgbinary_cmds.py:371): for each SV it remaps the reference sequence
flanking the breakends and records how uniquely each flank maps — repeat-
embedded breakpoints are where SV callers hallucinate.  This analog answers
the same question with the reference FM-index (index/bwt.py): exact
occurrence counts of the k-mers upstream/downstream of each breakend and of
the inserted sequence's ends, emitted as INFO fields:

  GRM_UP / GRM_DN   genome hit count of the k-mer before / after the event
  GRM_IN            hit count of the inserted sequence's first k-mer (INS)

A count of 1 = uniquely anchored breakend; large counts flag repeats.
"""

from __future__ import annotations

from typing import List

import numpy as np

from biograph_jax.core import dna
from biograph_jax.io.vcf import VcfRecord, VcfWriter, read_vcf

GRM_HEADERS = [
    '##INFO=<ID=GRM_UP,Number=1,Type=Integer,Description="Genome occurrences of the upstream breakend k-mer">',
    '##INFO=<ID=GRM_DN,Number=1,Type=Integer,Description="Genome occurrences of the downstream breakend k-mer">',
    '##INFO=<ID=GRM_IN,Number=1,Type=Integer,Description="Genome occurrences of the inserted sequence k-mer">',
]


def annotate_grm(
    bwt,
    reference,
    records: List[VcfRecord],
    k: int = 50,
    min_event: int = 20,
) -> List[VcfRecord]:
    """Fill GRM_* INFO fields on SV records (smaller records pass through)."""
    flat = np.asarray(reference.flat)
    queries = []
    owners = []  # (record index, field)
    for i, rec in enumerate(records):
        alt1 = rec.alt.split(",")[0]
        if abs(len(alt1) - len(rec.ref)) < min_event:
            continue
        c = reference.contig_by_name(rec.chrom)
        p0 = c.start + rec.pos - 1
        up = flat[max(p0 - k + 1, 0) : p0 + 1]
        dn_start = p0 + len(rec.ref)
        dn = flat[dn_start : dn_start + k]
        if len(up) >= 20:
            queries.append(up)
            owners.append((i, "GRM_UP"))
        if len(dn) >= 20:
            queries.append(dn)
            owners.append((i, "GRM_DN"))
        if len(alt1) > min_event and all(ch in "ACGTacgt" for ch in alt1):
            ins = dna.seq_to_codes(alt1[1 : k + 1])
            if len(ins) >= 20:
                queries.append(ins)
                owners.append((i, "GRM_IN"))
    if queries:
        L = max(len(q) for q in queries)
        qc = np.zeros((len(queries), L), np.uint8)
        ql = np.zeros(len(queries), np.int32)
        for j, q in enumerate(queries):
            qc[j, : len(q)] = q
            ql[j] = len(q)
        lo, hi = bwt.find(qc, ql)
        for (i, fieldname), l, h in zip(owners, lo, hi):
            records[i].info[fieldname] = int(h - l)
    return records


def run_grm(vcf_in: str, vcf_out: str, bwt, reference, sample="SAMPLE", k=50):
    records = read_vcf(vcf_in)
    records = annotate_grm(bwt, reference, records, k=k)
    with VcfWriter(
        vcf_out,
        sample=sample,
        contigs=[(c.name, c.length) for c in reference.contigs],
        extra_headers=GRM_HEADERS,
    ) as w:
        for rec in records:
            w.write(rec)
    return records
