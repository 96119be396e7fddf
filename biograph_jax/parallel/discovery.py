"""Distributed discovery: region-sharded variant calling across processes.

The reference parallelizes discovery by splitting scaffolds into chunks and
scheduling them over a thread pool (modules/variants/trace_ref.cpp:105); at
cloud scale the unit is one whole sample per instance.  Here the same chunk
scheduling spans *hosts*: under jax.distributed every process traces an
overlapping slice of the region with its replicated seqset, and the
per-process record lists are exchanged through the run directory — files on
shared storage are the data plane, exactly the reference's manifest
convention (modules/mapred/manifest.h:79) — then merged and deduped
identically on every process.

Slice ownership: records are owned by the slice whose half-open [lo, hi)
range contains their anchor position; slices are traced with `overlap`
extra bases on each side so an owned record always sees its full assembly
context.  Rejoins farther than `overlap` past a slice boundary (giant
deletions near the cut) are found by the pair/split SV engine rather than
the wavefront, as in the single-process pipeline.
"""

from __future__ import annotations

import json
import os
import time
from typing import List

import numpy as np

from biograph_jax.runtime import storage


def _slices(lo: int, hi: int, n: int) -> List[tuple]:
    """n contiguous half-open owned ranges covering [lo, hi)."""
    edges = np.linspace(lo, hi, n + 1).astype(np.int64)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(n)]


def discover_variants_distributed(
    ss,
    reference,
    run_dir: str,
    region: tuple | None = None,
    opt=None,
    readmap=None,
    stats: dict | None = None,
    overlap: int | None = None,
    barrier_timeout_s: float = 600.0,
):
    """Run discovery region-sharded over all jax.distributed processes.

    Every process calls this with the same arguments (seqset/readmap are the
    same immutable artifacts on each host); every process returns the same
    merged record list.  Single-process runs degrade to plain
    discover_variants.  `run_dir` must be shared storage in a real
    multi-host deployment (the file data plane)."""
    import jax

    from biograph_jax.variants.discover import (
        DiscoverOptions,
        discover_variants,
        _dedup_records,
    )

    opt = opt or DiscoverOptions()
    nproc = jax.process_count()
    pid = jax.process_index()
    G = len(np.asarray(reference.flat))
    lo, hi = region if region else (0, G)
    if nproc <= 1:
        return discover_variants(
            ss, reference, region=(lo, hi), opt=opt, readmap=readmap, stats=stats
        )
    if overlap is None:
        overlap = opt.max_path + opt.rejoin_k + opt.probe_ctx + 2
    own_lo, own_hi = _slices(lo, hi, nproc)[pid]
    ext = (max(lo, own_lo - overlap), min(hi, own_hi + overlap))
    local = discover_variants(
        ss, reference, region=ext, opt=opt, readmap=readmap, stats=stats
    )
    # ownership filter: anchor position (rec pos is 1-based contig-relative)
    owned = []
    for r in local:
        c = reference.contig_by_name(r["chrom"])
        flat = c.start + r["pos"] - 1
        if own_lo <= flat < own_hi:
            owned.append(r)
    st = storage.for_path(run_dir)  # pluggable data plane (file://, s3://)
    st.makedirs(run_dir)
    part = storage.join(run_dir, f"discovery_part_{pid:05d}.json")
    tmp = part + ".tmp"
    with st.open(tmp, "w") as f:
        json.dump(owned, f)
    st.publish(tmp, part)  # atomic: readers never see a partial file

    # barrier: a device collective over the global mesh (the only ordering
    # primitive a jax.distributed job needs; control plane stays jax's)
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("bgt_discovery_parts")

    merged = []
    deadline = time.time() + barrier_timeout_s
    for p in range(nproc):
        path = storage.join(run_dir, f"discovery_part_{p:05d}.json")
        while not st.exists(path):
            # shared-FS visibility can lag the barrier on network mounts
            if time.time() > deadline:
                raise TimeoutError(f"missing discovery part {path}")
            time.sleep(0.05)
        with st.open(path) as f:
            merged.extend(json.load(f))
    return _dedup_records(merged)


def _await_file(st, path: str, deadline: float):
    while not st.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"missing part {path}")
        time.sleep(0.05)


def discover_structural_distributed(
    readmap,
    reference,
    run_dir: str,
    opt=None,
    barrier_timeout_s: float = 600.0,
):
    """Pair/split SV discovery with the O(reads) scan sharded by read slice.

    Every process densifies + places + split-places only its contiguous
    slice of the readmap's forward reads (the dominant cost — previously
    duplicated N× on every process), exchanges the compact scan results
    (placements, raw events, clip candidates, k-mer edge tables) through
    `run_dir`, then runs the deterministic finalize identically everywhere —
    so all processes return the same record list as a single-process run.
    """
    import jax

    from biograph_jax.variants.align import RefKmerIndex
    from biograph_jax.variants.pop_tracer import (
        SvOptions,
        _sv_finalize,
        _sv_scan_reads,
        discover_structural,
        merge_edge_tables,
        reads_from_readmap,
    )

    opt = opt or SvOptions()
    nproc = jax.process_count()
    pid = jax.process_index()
    if nproc <= 1:
        codes, lens, mate = reads_from_readmap(readmap)
        return discover_structural(reference, codes, lens, mate_of=mate, opt=opt)

    # global lengths/mate links are cheap; codes densify is per-slice only
    _, lens, mate = reads_from_readmap(readmap, read_slice=(0, 0))
    R = len(lens)
    lo, hi = _slices(0, R, nproc)[pid]
    codes, _, _ = reads_from_readmap(readmap, read_slice=(lo, hi))
    ref = np.asarray(reference.flat)
    index = RefKmerIndex.build(ref, opt.k, is_n=getattr(reference, "is_n", None))
    placements, raw_events, clip_cands, ek, ec = _sv_scan_reads(
        index, codes, lens[lo:hi], opt, owner_base=lo
    )

    st = storage.for_path(run_dir)
    st.makedirs(run_dir)
    part = storage.join(run_dir, f"sv_part_{pid:05d}.npz")
    tmp = part + ".tmp.npz"
    with st.open(tmp, "wb") as _f:
        np.savez(
            _f,
            pos=placements.pos,
            is_rc=placements.is_rc,
            ev_left=np.array([e[0] for e in raw_events], np.int64),
            ev_right=np.array([e[1] for e in raw_events], np.int64),
            ev_owner=np.array([e[3] for e in raw_events], np.int64),
            ev_ins=np.frombuffer(b"".join(e[2] for e in raw_events), np.uint8),
            ev_ins_len=np.array([len(e[2]) for e in raw_events], np.int64),
            cl_left=np.array([c[0] for c in clip_cands], np.int64),
            cl_owner=np.array([c[2] for c in clip_cands], np.int64),
            cl_tail=(
                np.concatenate([c[1] for c in clip_cands])
                if clip_cands
                else np.zeros(0, np.uint8)
            ),
            cl_tail_len=np.array([len(c[1]) for c in clip_cands], np.int64),
            edge_keys=ek,
            edge_counts=ec,
        )
    st.publish(tmp, part)

    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("bgt_sv_parts")

    deadline = time.time() + barrier_timeout_s
    pos_parts, rc_parts, tables = [], [], []
    all_events, all_clips = [], []
    for p in range(nproc):
        path = storage.join(run_dir, f"sv_part_{p:05d}.npz")
        _await_file(st, path, deadline)
        with st.open(path, "rb") as _f:
            z = dict(np.load(_f))
        pos_parts.append(z["pos"])
        rc_parts.append(z["is_rc"])
        tables.append((z["edge_keys"], z["edge_counts"]))
        off = 0
        for l, r, n, o in zip(
            z["ev_left"], z["ev_right"], z["ev_ins_len"], z["ev_owner"]
        ):
            all_events.append(
                (int(l), int(r), z["ev_ins"][off : off + int(n)].tobytes(), int(o))
            )
            off += int(n)
        off = 0
        for l, n, o in zip(z["cl_left"], z["cl_tail_len"], z["cl_owner"]):
            all_clips.append(
                (int(l), z["cl_tail"][off : off + int(n)].copy(), int(o))
            )
            off += int(n)
    pos_all = np.concatenate(pos_parts)
    rc_all = np.concatenate(rc_parts)
    ek_m, ec_m = merge_edge_tables(tables)
    if not all_events and not all_clips:
        return []
    return _sv_finalize(
        reference, index, all_events, all_clips, ek_m, ec_m,
        pos_all, rc_all, lens, mate, opt,
    )
