"""Chainable variant-stream generators — the SDK pipeline surface.

Counterpart of the reference's `biograph.variants` generator API
(python/biograph/variants/__init__.py:4-47: C++ steps exposed as Python
generators that chain `parse_region → trim_ref → add_ref_assemblies →
generate_read_cov → generate_pair_cov → ...`, plus the par_pipeline
background-thread wrapper, python/biograph/variants/par_pipeline.h:14-20).

Here each stage is a real Python generator over VcfRecord streams; stages
whose compute is batched on device (coverage, pair coverage, phasing)
consume the stream in chunks, run one batched launch per chunk, and yield
annotated records — generator ergonomics outside, lane-batched kernels
inside (the batched translation of the reference's threaded pull pipeline).

Example (the coverage tool's chain, tools/coverage.py:500-510):

    from biograph_jax.variants import generators as bgexvar
    recs = bgexvar.parse_region(bg, ref, "Chromosome:0-120000")
    recs = bgexvar.trim_ref(recs, ref)
    recs = bgexvar.generate_read_cov(bg.readmap, ref, recs)
    recs = bgexvar.generate_pair_cov(bg.readmap, ref, recs)
    bgexvar.vcf_export(recs, "out.vcf", ref, sample="S1")
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List

import numpy as np

from biograph_jax.core import dna
from biograph_jax.io.vcf import VcfRecord

DEFAULT_CHUNK = 256
_QUEUE_SIZE = 4096  # par_pipeline.h:19 k_max_queue_size


def _chunks(it: Iterable, n: int) -> Iterator[List]:
    buf = []
    for x in it:
        buf.append(x)
        if len(buf) >= n:
            yield buf
            buf = []
    if buf:
        yield buf


def parse_region(bg, reference, region: str | None = None, opt=None) -> Iterator[VcfRecord]:
    """Discover variants over `region` ("contig:lo-hi", 0-based) and yield
    VcfRecords (ParallelDiscover / parse_region analog)."""
    from biograph_jax.variants.discover import DiscoverOptions, discover_variants

    opt = opt or DiscoverOptions()
    reg = None
    if region:
        cname, span = region.split(":")
        lo, hi = (int(x) for x in span.split("-"))
        c = reference.contig_by_name(cname)
        if c is None:
            raise ValueError(f"unknown contig {cname!r}")
        reg = (c.start + lo, c.start + hi)
    for r in discover_variants(bg.seqset, reference, region=reg, opt=opt,
                               readmap=bg.readmap):
        yield VcfRecord(
            chrom=r["chrom"],
            pos=r["pos"],
            ref=r["ref"],
            alt=r["alt"],
            info={"SUP": int(r["support"]), "RSUP": int(r.get("ref_support", 0))},
        )


def trim_ref(records: Iterable[VcfRecord], reference) -> Iterator[VcfRecord]:
    """Drop records whose ALT equals the reference (ref_trimmer analog,
    modules/variants/trim_ref.h:10) and left-normalize redundant padding."""
    flat = np.asarray(reference.flat)
    for r in records:
        if r.alt == r.ref:
            continue
        c = reference.contig_by_name(r.chrom.split(":")[0])
        if c is not None:
            start = c.start + r.pos - 1
            want = dna.codes_to_seq(flat[start : start + len(r.ref)])
            if want and want != r.ref.upper():
                raise ValueError(
                    f"{r.chrom}:{r.pos} REF {r.ref!r} != reference {want!r}"
                )
        yield r


def add_ref_assemblies(
    records: Iterable[VcfRecord], reference, region: str
) -> Iterator[VcfRecord]:
    """Emit hom-ref records for the region's uncovered stretches so
    downstream coverage scores the reference allele everywhere
    (add_ref_assemblies analog)."""
    cname, span = region.split(":")
    lo, hi = (int(x) for x in span.split("-"))
    flat = np.asarray(reference.flat)
    c = reference.contig_by_name(cname)
    cursor = lo
    for r in records:
        vpos0 = r.pos - 1
        if vpos0 > cursor:
            yield VcfRecord(
                chrom=cname,
                pos=cursor + 1,
                ref=dna.codes_to_seq(flat[c.start + cursor : c.start + cursor + 1]),
                alt=".",
                info={"END": vpos0, "REFBLOCK": True},
            )
        cursor = max(cursor, vpos0 + len(r.ref))
        yield r
    if cursor < hi:
        yield VcfRecord(
            chrom=cname,
            pos=cursor + 1,
            ref=dna.codes_to_seq(flat[c.start + cursor : c.start + cursor + 1]),
            alt=".",
            info={"END": hi, "REFBLOCK": True},
        )


def generate_read_cov(
    readmap, reference, records: Iterable[VcfRecord], chunk: int = DEFAULT_CHUNK
) -> Iterator[VcfRecord]:
    """Attach read-coverage evidence + genotype (generate_read_cov /
    calc_coverage analog): DP/AD/GT/GQ/PL FORMAT fields per record, one
    batched coverage launch per chunk."""
    from biograph_jax.variants.coverage_tool import annotate_coverage

    for group in _chunks(records, chunk):
        real = [r for r in group if not r.info.get("REFBLOCK")]
        ann = annotate_coverage(readmap, reference, real) if real else None
        i = 0
        for r in group:
            if r.info.get("REFBLOCK"):
                yield r
                continue
            r.fmt["GT"] = ann.gt[i]
            r.fmt["DP"] = int(ann.alt_depth[i] + ann.ref_depth[i])
            r.fmt["AD"] = (
                ann.ad[i] if ann.ad else f"{int(ann.ref_depth[i])},{int(ann.alt_depth[i])}"
            )
            r.fmt["GQ"] = int(ann.gq[i])
            r.fmt["PL"] = ",".join(str(int(x)) for x in ann.pl[i])
            i += 1
            yield r


def generate_pair_cov(
    readmap, reference, records: Iterable[VcfRecord], chunk: int = DEFAULT_CHUNK
) -> Iterator[VcfRecord]:
    """Attach mate-pair support (generate_pair_cov / place_pair_cov analog):
    INFO PC per record."""
    from biograph_jax.variants.coverage_tool import annotate_pair_coverage

    for group in _chunks(records, chunk):
        real = [r for r in group if not r.info.get("REFBLOCK")]
        pc = annotate_pair_coverage(readmap, reference, real) if real else []
        i = 0
        for r in group:
            if not r.info.get("REFBLOCK"):
                r.info["PC"] = int(pc[i])
                i += 1
            yield r


def split_phases(
    readmap, reference, records: Iterable[VcfRecord]
) -> Iterator[VcfRecord]:
    """Read-backed phasing (split_phases/join_phases/resolve_phase_conflicts
    analog, modules/variants/phase.h:26): het GTs gain phased `|` genotypes
    and PS phase-set tags where spanning reads link them."""
    from biograph_jax.variants.phase import phase_records

    group = list(records)
    real = [r for r in group if not r.info.get("REFBLOCK")]
    if real:
        gts = [str(r.fmt.get("GT", "0/1")) for r in real]
        res = phase_records(readmap, reference, real, gts)
        for r, g, ps in zip(real, res.gt, res.ps):
            r.fmt["GT"] = g
            if ps is not None:
                r.fmt["PS"] = ps
    yield from group


def dedup_cov_reads(records: Iterable[VcfRecord]) -> Iterator[VcfRecord]:
    """Drop exact-duplicate records, keeping the best-supported
    (dedup_cov_reads / exact_deduper analog)."""
    seen = {}
    order = []
    for r in records:
        key = (r.chrom, r.pos, r.ref, r.alt)
        old = seen.get(key)
        if old is None:
            seen[key] = r
            order.append(key)
        elif int(r.info.get("SUP", 0)) > int(old.info.get("SUP", 0)):
            seen[key] = r
    for key in order:
        yield seen[key]


def vcf_export(
    records: Iterable[VcfRecord], path: str, reference=None, sample: str = "SAMPLE"
) -> int:
    """Write the stream (ploidless_vcf_export analog); returns count."""
    from biograph_jax.io.vcf import VcfWriter

    contigs = (
        [(c.name, c.length) for c in reference.contigs] if reference else None
    )
    headers = [
        '##INFO=<ID=SUP,Number=1,Type=Integer,Description="Alt read support">',
        '##INFO=<ID=RSUP,Number=1,Type=Integer,Description="Ref read support">',
        '##INFO=<ID=PC,Number=1,Type=Integer,Description="Pair coverage">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allele depths">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
        '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Likelihoods">',
        '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set">',
    ]
    n = 0
    with VcfWriter(path, sample=sample, contigs=contigs, extra_headers=headers) as w:
        for r in records:
            if r.info.get("REFBLOCK"):
                continue
            w.write(r)
            n += 1
    return n


def verify_order(records: Iterable[VcfRecord], label: str = "stream") -> Iterator[VcfRecord]:
    """Sorted-stream invariant canary (assemble_pipeline_interface::
    global_set_verify_order analog, modules/variants/assemble.h — enabled in
    all the reference's tests, biograph_variants.cpp:639): asserts records
    arrive sorted by (chrom, pos) and names the offender when a stage breaks
    the contract.  Insert between any two stages; costs one comparison per
    record."""
    last = None
    for r in records:
        key = (r.chrom, r.pos)
        if last is not None and r.chrom == last[0] and key < last:
            raise AssertionError(
                f"verify_order[{label}]: {key} arrived after {last}"
            )
        last = key
        yield r


def par_pipeline(stage, records: Iterable, queue_size: int = _QUEUE_SIZE) -> Iterator:
    """Run `stage` (an iterator->iterator callable) on a background thread
    with a bounded handoff queue (par_asm_pipeline_wrapper analog,
    python/biograph/variants/par_pipeline.h:14-20): the producer stays at
    most queue_size records ahead, and exceptions propagate to the
    consumer."""
    q: queue.Queue = queue.Queue(maxsize=queue_size)
    _END = object()

    def run():
        try:
            for x in stage(records):
                q.put(x)
            q.put(_END)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    while True:
        x = q.get()
        if x is _END:
            break
        if isinstance(x, BaseException):
            raise x
        yield x
    t.join()
