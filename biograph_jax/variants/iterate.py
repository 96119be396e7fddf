"""Iterative donor-patching discovery for divergent genomes.

The reference attacks deep divergence with its graph-walking engines
(modules/graph_discover/discover.h:16 anchored windowed discovery over
patched assembly graphs, modules/variants/apply_block/apply_graph).  This
analog iterates the whole pipeline: discover -> apply confident calls to a
donor genome -> rediscover against the donor (whose anchors now reach into
previously unalignable territory) -> repeat until no new calls.  The final
variant set is re-derived in ONE pass by composing the per-round coordinate
maps and aligning every still-different (ref block, donor block) pair with
the batched affine DP — no error-prone per-round variant composition.
"""

from __future__ import annotations

from typing import List

import numpy as np

from biograph_jax.core import dna
from biograph_jax.index.reference import Contig, Reference
from biograph_jax.variants.coverage_tool import build_donor
from biograph_jax.variants.discover import (
    DiscoverOptions,
    _left_normalize,
    _ops_to_pieces,
    discover_variants,
)


def discover_variants_iterative(
    ss,
    reference,
    opt: DiscoverOptions | None = None,
    readmap=None,
    max_rounds: int = 4,
    region: tuple | None = None,
    stats: dict | None = None,
) -> List[dict]:
    """Multi-round anchored discovery with donor patching.

    Returns discovery-record dicts vs the ORIGINAL reference; support comes
    from the donor-context coverage walk (annotate_coverage), the same
    evidence the single-round path reports."""
    opt = opt or DiscoverOptions()
    ref_flat = np.asarray(reference.flat)
    G = len(ref_flat)
    if stats is None:
        stats = {}
    stats["rounds"] = 0

    cur_ref = reference
    # composed map: original ref position -> current donor position
    comp_map = np.arange(G + 1, dtype=np.int64)
    donor = ref_flat
    seen_donors = {hash(ref_flat.tobytes())}  # cycle detection
    for rnd in range(max_rounds):
        recs = discover_variants(
            ss,
            cur_ref,
            opt=opt,
            readmap=readmap,
            region=region if rnd == 0 else None,
            stats=stats.setdefault(f"round{rnd}", {}),
        )
        recs = [r for r in recs if r["support"] >= opt.min_alt_support]
        stats["rounds"] = rnd + 1
        stats[f"round{rnd}"]["n_records"] = len(recs)
        # patch only confidently-hom calls: het / quasi-species positions
        # oscillate (apply the alt, then re-call the ref base back) without
        # this gate — they still get REPORTED via the final diff + coverage
        recs = [
            r
            for r in recs
            if r["support"]
            >= opt.hom_frac * (r["support"] + r.get("ref_support", 0))
        ]
        stats[f"round{rnd}"]["n_patched"] = len(recs)
        if not recs:
            break
        # apply to the current donor
        flat_records = []
        for r in recs:
            c = cur_ref.contig_by_name(r["chrom"])
            flat_records.append(
                (
                    c.start + r["pos"] - 1,
                    dna.seq_to_codes(r["ref"]),
                    dna.seq_to_codes(r["alt"]),
                )
            )
        flat_records.sort(key=lambda t: t[0])
        new_donor, donor_of_cur, applied = build_donor(
            np.asarray(cur_ref.flat), flat_records
        )
        if not applied.any():
            break
        h = hash(new_donor.tobytes())
        if h in seen_donors:
            # the patch set oscillates (quasi-species het positions flipping
            # back and forth) — the donor state repeats, so stop
            stats["cycle_detected"] = True
            break
        seen_donors.add(h)
        comp_map = donor_of_cur[comp_map]
        donor = new_donor
        cur_ref = Reference(
            flat=new_donor,
            is_n=np.zeros(len(new_donor), bool),
            contigs=[Contig(name=c.name, start=0, length=len(new_donor))]
            if len(reference.contigs) == 1
            else _remap_contigs(reference, donor_of_cur),
        )

    # extract the net diff: maximal blocks where composed donor != ref
    records = _diff_records(reference, ref_flat, donor, comp_map)
    if readmap is not None and records:
        from biograph_jax.io.vcf import VcfRecord
        from biograph_jax.variants.coverage_tool import annotate_coverage

        vrecs = [
            VcfRecord(chrom=r["chrom"], pos=r["pos"], ref=r["ref"], alt=r["alt"])
            for r in records
        ]
        ann = annotate_coverage(readmap, reference, vrecs)
        for r, d_, rd in zip(records, ann.alt_depth, ann.ref_depth):
            r["support"] = int(d_)
            r["ref_support"] = int(rd)
        records = [r for r in records if r["support"] >= opt.min_alt_support]
    return records


def _remap_contigs(reference, donor_of_cur):
    out = []
    for c in reference.contigs:
        s = int(donor_of_cur[c.start])
        e = int(donor_of_cur[c.start + c.length])
        out.append(Contig(name=c.name, start=s, length=e - s))
    return out


def _diff_records(reference, ref_flat, donor, comp_map):
    """Blocks where the donor differs from ref -> primitive variant records.

    A ref position i is a clean match when its mapped donor base equals
    ref[i] AND the next position maps to the immediately following donor
    position (no insertion in between)."""
    from biograph_jax.ops.align_dp import align_blocks_batch
    from biograph_jax.variants.discover import _contig_of

    G = len(ref_flat)
    if G == 0:
        return []
    dpos = comp_map[:G]
    match = (donor[np.clip(dpos, 0, len(donor) - 1)] == ref_flat) & (
        comp_map[1 : G + 1] == dpos + 1
    )
    out = []
    blocks = []
    i = 0
    while i < G:
        if match[i]:
            i += 1
            continue
        j = i
        while j < G and not match[j]:
            j += 1
        # ref block [i, j); donor block [comp_map[i], comp_map[j])
        blocks.append((i, j, int(comp_map[i]), int(comp_map[j])))
        i = j
    if not blocks:
        return []
    rb = [ref_flat[i:j] for i, j, a, b in blocks]
    db = [donor[a:b] for i, j, a, b in blocks]
    ops_all = align_blocks_batch(rb, db)
    for (i, j, a, b), ops in zip(blocks, ops_all):
        for vpos, ref_str, alt_str in _ops_to_pieces(
            ref_flat, i, ref_flat[i:j], donor[a:b], ops
        ):
            contig = _contig_of(reference, vpos)
            if contig is None:
                continue
            out.append(
                {
                    "chrom": contig.name,
                    "pos": vpos - contig.start + 1,
                    "ref": ref_str,
                    "alt": alt_str,
                    "support": 0,
                    "ref_support": 0,
                }
            )
    seen = {}
    for r in out:
        key = (r["chrom"], r["pos"], r["ref"], r["alt"])
        seen.setdefault(key, r)
    return sorted(seen.values(), key=lambda r: (r["chrom"], r["pos"]))
