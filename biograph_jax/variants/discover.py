"""Reference-guided wavefront assembly — the discovery engine.

Device-batched reformulation of the reference's discovery stack
(modules/variants/trace_ref.h:9 work scheduling, tracer.cpp push tracer,
discovery/ bidirectional engine): instead of one pointer-chasing path walk at
a time, a *beam of frontier lanes* advances through the seqset in lockstep —
every step is a batch of rank queries.

Coordinate convention: the walk runs left-to-right over the reference but the
seqset prepends bases, so lanes hold ranges in reverse-complement space —
pushing complement(b) appends b on the forward strand (same trick as
readmap::approx_coverage, modules/bio_base/readmap.cpp:368).

Stages (each one or two jitted device programs):
  1. ref walk      — lax.scan of push_front_drop along the chunk, recording
                     per-position ranges (the ref_map analog,
                     modules/variants/ref_map.h:49)
  2. anchors       — vectorized 4-base branch probe at every position
  3. wavefront     — beam search: each step pushes 4 candidate bases per
                     lane, scores children by read support, keeps the top
                     beam, tests rejoin against a chunk k-mer index
                     (tracer.cpp rejoin-to-ref search)
  4. variants      — prefix/suffix alignment of assembly vs ref span ->
                     SNP/ins/del records, left-normalized
                     (modules/variants/normalize.h:7)
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from biograph_jax.core import dna
from biograph_jax.index.seqset import Seqset, SeqsetRanges
from biograph_jax.index.readmap import Readmap


@dataclass
class DiscoverOptions:
    """Engine knobs (analog of assemble_options, modules/variants/assemble.h:475).

    Reference-knob mapping (assemble.h field -> here):
      bidir_min_anchor_len / min_overlap  -> min_anchor_ctx / probe_ctx
      bidir_max_branch_steps              -> max_path
      max_next_paths / max_rejoins        -> branch_clones (beam clones/anchor)
      read_ahead_distance                 -> read_ahead_distance (rejoin window)
      scaffold_split_size                 -> scaffold_split_size (probe batch)
      skip_push_trace_fwd/rev             -> skip_trace_fwd / skip_trace_rev
      read_cov_max_reads_per_entry        -> read_cov_max_reads_per_entry
      penalize_directional_coverage       -> penalize_directional_coverage
      simple_genotype_filter + min_depth_portion + min_read_depth
        + min_pair_depth                  -> same names (VCF-emit gate)
      vcf_sv_size_threshold               -> vcf_sv_size_threshold
      output_assembly_ids                 -> output_assembly_ids (AID INFO)
      trace_assembly_ids / add_offset_trace -> trace_offsets (debug dump)
      max_pair_distance / min_pop_overlap etc. (pair/pop engine) -> the SV
        engine's SvOptions (variants/pop_tracer.py)
    Knobs with no analog here are artifacts of the reference's sequential
    cost-driven search (branch costs, search-step budgets, per-read path
    caps): the beam advances every lane each step and prunes by rank, so
    cost accounting has no equivalent work to gate.  Worker-profile knobs
    (himem etc.) live in runtime/resources.py instead.
    """

    min_anchor_ctx: int = 20  # min ref context at a branch point
    probe_ctx: int = 25  # context length for branch probing / extension
    # Range widths count DISTINCT suffix continuations (entries are deduped),
    # so validity (>=1) is the branch criterion; true read support is
    # computed from the readmap after assembly (calc_coverage analog).
    min_branch_width: int = 1
    min_extend_width: int = 1
    beam_width: int = 256  # frontier lanes per chunk batch
    bidir: bool = True  # trace fwd AND reverse-complement (trace_ref.h:33-51)
    skip_trace_fwd: bool = False  # assemble.h skip_push_trace_fwd
    skip_trace_rev: bool = False  # assemble.h skip_push_trace_rev
    max_path: int = 420  # max assembled alt bases (300bp-class insertions fit)
    rejoin_k: int = 23  # suffix k-mer size for rejoin detection
    max_assemblies: int = 4096  # per chunk batch; truncation is counted
    min_alt_support: int = 3
    hom_frac: float = 0.8
    # beam clones per anchor (best/second-best at the first junctions);
    # power of two (each junction consumes one policy bit)
    branch_clones: int = 4
    # adaptive depth: anchors whose whole clone beam dies un-rejoined are
    # re-explored with branch_clones x 4^round clones (covering 2 more
    # junctions per round) — the batched analog of the reference's
    # best-first branch queue backtracking into less-supported extensions
    # (discovery/branch.h:46 search-entry queue, push_search.h:9); paid
    # only where the fixed-width beam failed
    branch_retry_rounds: int = 1
    # rejoin search window in bases (assemble.h read_ahead_distance: "only
    # deletions smaller than this are detected locally"); rounded up to a
    # power of two
    read_ahead_distance: int = 1 << 18
    # probe-batch width cap (assemble.h scaffold_split_size analog: the unit
    # of genome per device dispatch)
    scaffold_split_size: int = 1 << 20
    # coverage scoring (calc_coverage.cpp):
    read_cov_max_reads_per_entry: int = 0  # 0 = engine default (16)
    penalize_directional_coverage: bool = True  # calc_coverage.cpp:10-17
    # VCF-emit genotype gate (simple_genotype_filter.cpp:56-140):
    simple_genotype_filter: bool = True
    min_depth_portion: float = 0.23
    min_read_depth: int = 1
    min_pair_depth: int = 0
    # in-search pair evidence (tracer.cpp:602 DISCARD PATH rule): an
    # assembled alt path longer than max_bases_between_pairs needs at least
    # min_pair_evidence consistent mate pairs anchored to its bubble, when
    # the library is paired (assemble.h:574 default 300; vacuous for
    # shorter paths and single-end libraries, exactly as the reference's
    # pushed_since_pair counter is)
    pair_gate: bool = True
    max_bases_between_pairs: int = 300  # assemble.h:574
    max_pair_distance: int = 1000  # assemble.h:589
    min_pair_evidence: int = 1
    # VCF output shaping:
    vcf_sv_size_threshold: int = 50  # SVLEN/SVTYPE INFO at this size
    output_assembly_ids: bool = False  # AID INFO field
    # debug: dump any assembly whose bubble overlaps one of these flat
    # offsets (add_offset_trace analog, assemble.h:768)
    trace_offsets: tuple = ()


@dataclass
class Assembly:
    """One assembled alternate path (analog of the assembly record,
    modules/variants/assemble.h:285)."""

    chunk_start: int  # flat ref coord of chunk base
    anchor: int  # last ref-matching position (flat coords)
    rejoin: int  # first ref-matching position after the bubble (flat)
    seq: np.ndarray  # alt bases between anchor and rejoin (uint8 codes)
    support: int  # min read support along the path
    ref_support: int = 0  # min read support along the ref span of the bubble


MAXA = 8192  # max anchors returned per probe batch (truncation is counted)

# the shared probe engine (index/probes.py) replaces the sequential
# per-chunk reference walk (ref_map analog, modules/variants/ref_map.h:49):
# anchor detection probes every genome position as an independent lane
from biograph_jax.index.probes import (
    fetch_mask as _fetch_mask,
    find_window_jit as _find_window_jit,
    probe_exact_jit as _probe_exact_jit,
    probe_ranges_jit as _probe_jit,
)
from biograph_jax.runtime.backend import backend


def anchor_scan(d, ref2, begin, end, size, p0, seg_hi, min_anchor_ctx: int,
                min_branch_width: int):
    """Branch probe + ON-DEVICE anchor detection and compaction.

    One fused rank4 pass gives all four children of every position's probe
    range; positions where a non-reference base has a continuation (and
    enough context) become anchors.  Only the compact anchor list (MAXA
    rows) leaves the device — kilobytes instead of megabytes per batch.
    Returns (a_pos, ab, begin, end, size, n_anchors, n_raw).
    """
    P = begin.shape[0]
    n2 = ref2.shape[0]
    pos = p0 + jnp.arange(P, dtype=jnp.int64)
    r = SeqsetRanges(begin, end, size)
    # candidate alt base bb pushes complement 3-bb -> flip columns
    nb4, ne4 = d.push4(r)
    W4 = (ne4 - nb4)[:, ::-1]
    # contiguous lanes: the next-ref-base vector is a slice, not a gather
    # (lanes whose pos+1 lands past n2 are masked by the seg_hi gate below)
    refp = jnp.concatenate([ref2, jnp.zeros((P + 1,), ref2.dtype)])
    nxt = lax.dynamic_slice_in_dim(refp, jnp.clip(p0 + 1, 0, n2), P).astype(
        jnp.int32
    )
    base_ids = jnp.arange(4)[None, :]
    good = (
        (W4 >= min_branch_width)
        & (base_ids != nxt[:, None])
        & (size[:, None] >= min_anchor_ctx)
        & ((pos + 1)[:, None] <= seg_hi)
        & (begin < end)[:, None]
    )
    flat = good.reshape(-1)
    # compaction by searchsorted over the inclusive cumsum: the k-th set bit
    # is the first index whose running count reaches k+1.  MAXA-sized gathers
    # replace a [4P]-element scatter (whose overflow-slot collisions
    # serialize).
    cs = jnp.cumsum(flat.astype(jnp.int64))
    n_raw = cs[-1]
    n_anchors = jnp.minimum(n_raw, MAXA)
    src = jnp.searchsorted(cs, jnp.arange(1, MAXA + 1, dtype=jnp.int64))
    valid = src < flat.shape[0]
    srcc = jnp.clip(src, 0, flat.shape[0] - 1)
    li = srcc // 4
    ab = srcc % 4
    stacked = jnp.stack(
        [
            jnp.where(valid, p0 + li, 0),
            jnp.where(valid, ab, 0),
            jnp.where(valid, jnp.take(begin, li), 0),
            jnp.where(valid, jnp.take(end, li), 0),
            jnp.where(valid, jnp.take(size, li).astype(jnp.int64), 0),
        ]
    )  # [5, MAXA]
    # counts ride a tiny first fetch; the anchor columns come back as ONE
    # stacked array the caller slices device-side to the live prefix — per
    # batch the host link sees two small transfers, not seven MAXA-row ones
    counts = jnp.stack([n_anchors, n_raw])
    return counts, stacked


_anchor_jit = jax.jit(anchor_scan, static_argnums=(7, 8))


def wavefront_assemble(
    ss: Seqset,
    ref_codes: np.ndarray,
    anchors: tuple,
    opt: DiscoverOptions,
    stats: dict | None = None,
    ref_limit: int | None = None,
    ref_dev=None,
    engine=None,
    mem_plan=None,
    prescreen=None,
) -> List[Assembly]:
    """Extend alt branches through the seqset; rejoin to reference.

    anchors: (a_pos, ab, begin, end, size) — compact per-anchor probe
    ranges straight from the device anchor scan (no per-position arrays
    cross the host/device link).  ref_dev: the doubled reference already on
    device (uploaded once by the caller) — span k-mer tables are built from
    it on device.
    """
    d = ss.d
    n_anchor = len(anchors[0])
    if n_anchor == 0:
        return []
    ref = np.asarray(ref_codes)
    if ref_limit is None:
        ref_limit = len(ref)
    if ref_dev is None:
        ref_dev = jnp.asarray(ref)

    # group anchors by genome position.  The (K, key2) span table puts no
    # limit on a batch's genome span (32-bit positions), so groups are sized
    # by lane count only.  Pooled groups everywhere (done-lane compaction recovers the width
    # decay a small group would have given; fewer groups = fewer fixed
    # costs); the engine keeps caller-sized groups for shard_map shapes
    eff_width = (
        max(opt.beam_width, WAVE_LANES) if engine is None else opt.beam_width
    )
    flat_pos = np.asarray(anchors[0])
    order = np.argsort(flat_pos, kind="stable")
    groups = []
    start = 0
    for i in range(1, n_anchor + 1):
        if i == n_anchor or i - start >= eff_width:
            groups.append(order[start:i])
            start = i

    if engine is not None:
        trunc_tables = engine.trunc_tables(opt.probe_ctx)
    elif mem_plan is not None and not mem_plan["use_trunc_tables"]:
        # HBM budget: fall back to in-loop LtSearch truncation
        trunc_tables = (None, None)
    else:
        trunc_tables = _trunc_tables(ss, opt.probe_ctx)
    # Shared rejoin span table: when the anchors' joint span fits the table
    # budget, build ONE (K, key2) table for all groups in this orientation —
    # one device sort instead of one per group, and ONE (Ap, npk) wavefront
    # program shape instead of a span-dependent ladder of compiles.  Past the budget
    # (human-scale scaffolds) groups fall back to their own bounded spans.
    span_shared = None
    k_rej = opt.rejoin_k
    lo_all = int(flat_pos.min())
    hi_all = int(min(flat_pos.max() + opt.max_path + k_rej + 2, ref_limit))
    span_all = min(hi_all + 1, ref_limit) - lo_all
    span_cap = SPAN_TABLE_CAP if mem_plan is None else mem_plan["span_table_cap"]
    if span_all >= k_rej:
        npk_all = 16384
        while npk_all < span_all - k_rej + 1:
            npk_all *= 4 if npk_all < (1 << 20) else 2
        # compact HIT-POSITION table (see _span_kmers_compact_dev): every
        # reachable query k-mer is read content whose last PRESCREEN_K
        # bases hit, so span occurrences only start at hit_pos - (k-1) —
        # a ~100x smaller table (no 8M-row sort per orientation) with
        # identical answers
        if (
            engine is None
            and prescreen is not None
            and _PRESCREEN_K <= k_rej <= opt.probe_ctx
        ):
            npk_c = prescreen["pos"].shape[0]
            if npk_c < npk_all:
                K_t, key2_t, n_real = _span_kmers_compact_dev(
                    ref_dev, jnp.asarray(lo_all, jnp.int64),
                    jnp.asarray(span_all, jnp.int64), npk_c, k_rej,
                    pos_abs=prescreen["pos"] - (k_rej - 1),
                )
                # n_real stays a device scalar (it only feeds a device-side
                # bound check) — no extra host sync
                span_shared = ((K_t, key2_t), lo_all, n_real)
        if span_shared is None and npk_all <= span_cap:
            span_shared = (
                _span_kmers_dev(
                    ref_dev, jnp.asarray(lo_all, jnp.int64),
                    jnp.asarray(span_all, jnp.int64), npk_all, k_rej,
                ),
                lo_all,
                span_all - k_rej + 1,
            )
    # start every group (span-table + seed dispatches are async), then
    # advance all groups' beams INTERLEAVED: each group's done-poll only
    # waits on its own enqueued steps while every other group's compute
    # drains behind it, so the device is not idle for one round trip per
    # group.
    def start_all(group_sels, ncl):
        pairs = []
        for sel in group_sels:
            c = _asm_start(
                d, ref, tuple(a[sel] for a in anchors), opt, ref_limit,
                trunc_tables, ref_dev, span_shared, engine=engine, ncl=ncl,
            )
            if c is not None:
                pairs.append((sel, c))
        return pairs

    def drive(cs):
        """Advance groups' beams interleaved (no-op on the engine path and
        the single-launch device-while path, whose _asm_start already ran
        the full loop).  Inner unit: a chunked early-exit while_loop, ONE
        launch per CHECK_EVERY steps; host compaction runs between polls."""
        active = [c for c in cs if c["step"] < c["MAXP"]]
        while active:
            for c in active:  # dispatch wave: async enqueues
                target = min(c["step"] + CHECK_EVERY, c["MAXP"])
                c["st"] = _wavefront_chunk_jit(
                    d, c["packed"], trunc_tables[0], trunc_tables[1],
                    c["n_packed"], c["st"], jnp.int32(c["step"]),
                    target - c["step"], c["MAXP"], c["k"], c["min_w"],
                    c["probe_ctx"], c["pos_bits"],
                )
                c["step"] = target
            nxt = []  # poll wave: one tiny fetch per group
            for c in active:
                if c["step"] >= c["MAXP"]:
                    continue
                und = int(_undone_count(c["st"]))
                if und == 0:
                    continue
                _maybe_compact(c, und)
                nxt.append(c)
            active = nxt

    pairs = start_all(groups, None)
    drive([c for _, c in pairs])
    out: List[Assembly] = []
    done_anchors = 0
    truncated = False
    failed: List[int] = []
    for sel, c in pairs:
        asms, ok_keys, branchy = _asm_finish(d, c)
        out.extend(asms)
        failed.extend(
            int(sel[j])
            for j in range(len(sel))
            if j not in ok_keys and j in branchy
        )
        done_anchors += c["n_sel"]
        if len(out) >= opt.max_assemblies:
            truncated = True
            if stats is not None and done_anchors < n_anchor:
                stats["assemblies_truncated"] += n_anchor - done_anchors
                import warnings

                warnings.warn(
                    f"discovery: assembly cap {opt.max_assemblies} hit;"
                    f" {n_anchor - done_anchors} anchors unexplored in this batch"
                )
            break
    # adaptive-depth retry (branch.h:46 best-first queue analog): anchors
    # whose whole beam died un-rejoined re-explore with 4x the clones per
    # round — two more junctions of best/second coverage, paid only where
    # the fixed beam failed
    ncl = max(int(opt.branch_clones), 1)
    for _ in range(int(getattr(opt, "branch_retry_rounds", 0))):
        if not failed or truncated:
            break
        ncl *= 4
        per = max(eff_width // max(ncl // max(int(opt.branch_clones), 1), 1), 16)
        fgroups = [
            np.asarray(failed[i : i + per], np.int64)
            for i in range(0, len(failed), per)
        ]
        rpairs = start_all(fgroups, ncl)
        drive([c for _, c in rpairs])
        failed = []
        for sel, c in rpairs:
            asms, ok_keys, branchy = _asm_finish(d, c)
            out.extend(asms)
            failed.extend(
                int(sel[j])
                for j in range(len(sel))
                if j not in ok_keys and j in branchy
            )
            if stats is not None:
                stats["branch_retry_rescued"] = stats.get(
                    "branch_retry_rescued", 0
                ) + len(ok_keys)
    return out[: opt.max_assemblies]


def _use_wave_device() -> bool:
    """Whole-device wavefront gate (see _asm_start) — opt-in
    (BGT_WAVE_DEVICE=1).  The single-launch while_loop pays full lane width
    for all MAXP steps (no done-lane compaction); the interleaved chunk
    driver compacts between polls."""
    return os.environ.get("BGT_WAVE_DEVICE", "0") not in ("0", "")


N_POLICY = 4  # beam clones per anchor (2 junction choices x 2 ranks)


def _asm_start(d, ref, anchors, opt: DiscoverOptions, ref_limit=None,
               trunc_tables=None, ref_dev=None, span_shared=None,
               engine=None, ncl=None):
    """Host prep + async device dispatch for one beam group; returns the ctx
    dict the interleaved driver advances (None for an empty group).

    Each anchor is explored by N_POLICY clone lanes: where several child
    bases are viable (repeat junctions), clone j of an anchor takes the
    child ranked by bit (j >> n_junction) & 1 — exploring best/second-best
    combinations at the first two junctions.  This is the bounded-width
    analog of the reference tracer's branch search (tracer.cpp path
    exploration with branch costs); per anchor the best-supported,
    smallest assembly wins (applied in _asm_finish).
    """
    a_pos, ab, a_begin, a_end, a_size = anchors
    A0 = len(a_pos)
    if A0 == 0:
        return None
    if ref_limit is None:
        ref_limit = len(ref)
    if trunc_tables is None:
        raise ValueError("_asm_start requires trunc_tables")
    MAXP = opt.max_path
    k = opt.rejoin_k
    pos_bits = max(int(opt.read_ahead_distance - 1).bit_length(), 1)

    # local ref kmer index for rejoin (bounded span; never crossing
    # ref_limit — with a doubled fwd+rc ref array the halves must not mix)
    anchor_flat0 = np.asarray(a_pos)
    if span_shared is not None:
        lo_flat = span_shared[1]
        n_packed = span_shared[2]
    else:
        lo_flat = int(anchor_flat0.min())
        hi_flat = int(min(anchor_flat0.max() + MAXP + k + 2, ref_limit))
        # 32-bit span positions in the (K, key2) table: real scaffolds fit
        assert hi_flat - lo_flat < (1 << 32)
        span_len = min(hi_flat + 1, ref_limit) - lo_flat
        if span_len < k:
            return None
        n_packed = span_len - k + 1

    # replicate each anchor into branch_clones clone lanes (max_next_paths /
    # max_rejoins analog: bounded branch exploration width); retry rounds
    # pass a widened ncl for adaptive depth
    ncl = max(int(ncl if ncl is not None else opt.branch_clones), 1)
    rep = np.repeat(np.arange(A0), ncl)
    policy = np.tile(np.arange(ncl), A0)
    A = A0 * ncl
    anchor_flat = anchor_flat0[rep]
    abp = ab[rep]

    # pad lanes and the span table to pow2 buckets for jit shape reuse; lanes
    # use a pow2 ladder (min 128) and the span table a 4x ladder so shape
    # combos — and so XLA compiles — stay rare (the persistent cache holds
    # the handful of (Ap, npk) wavefront programs across processes)
    Ap = max(_next_pow2(A), 128)
    # Pad rows are all-ones in BOTH table arrays; n_packed guards reject them
    # (a T-homopolymer roll can never equal the 64-bit all-ones sentinel).
    # 4x ladder keeps shape combos rare; 2x above 1M bounds the memory/sort
    # overshoot on whole-scaffold spans.
    if span_shared is not None:
        packed_dev = span_shared[0]
    else:
        npk = 16384
        while npk < n_packed:
            npk *= 4 if npk < (1 << 20) else 2
        if ref_dev is None:
            ref_dev = jnp.asarray(ref)
        packed_dev = _span_kmers_dev(
            ref_dev, jnp.asarray(lo_flat, jnp.int64),
            jnp.asarray(span_len, jnp.int64), npk, k,
        )

    def pad(x, fill=0, dtype=None):
        out = np.full(Ap, fill, dtype or np.asarray(x).dtype)
        out[:A] = x
        return jnp.asarray(out)

    # seed state is built ON DEVICE inside the jitted wavefront (the initial
    # push_front included): only five [Ap] anchor arrays cross the link
    seed = dict(
        begin=pad(a_begin[rep], 0, np.int64),
        end=pad(a_end[rep], 0, np.int64),
        size=pad(a_size[rep].astype(np.int32)),
        ab=pad(abp.astype(np.int32), 0, np.int32),
        policy=pad(policy.astype(np.int32)),
        min_local=pad((anchor_flat - lo_flat + 1).astype(np.int64)),
    )
    n_packed_dev = jnp.asarray(n_packed, jnp.int64)

    if engine is not None:
        # sharded engine: seed + full early-exit loop under shard_map
        st = engine.wavefront(
            packed_dev, trunc_tables[0], trunc_tables[1], n_packed,
            seed, MAXP, k, opt.min_extend_width, opt.probe_ctx, pos_bits,
        )
        step = MAXP
    elif not _use_wave_device():
        # the interleaved driver advances st in chunks with
        # done-lane compaction between polls (drive() in wavefront_assemble)
        st = _wavefront_seed_jit(d, seed, MAXP)
        step = 1
    else:
        # single-launch whole-beam while_loop (BGT_WAVE_DEVICE=1 A/B): no
        # compaction, full lane width to the last straggler
        st = _wavefront_jit(
            d, packed_dev, trunc_tables[0], trunc_tables[1], n_packed_dev,
            seed, MAXP, k, opt.min_extend_width, opt.probe_ctx, pos_bits,
        )
        step = MAXP
    return dict(
        st=st, step=step, packed=packed_dev, n_packed=n_packed_dev,
        MAXP=MAXP, k=k, min_w=opt.min_extend_width, probe_ctx=opt.probe_ctx,
        pos_bits=pos_bits, rep=rep, anchor_flat=anchor_flat, lo_flat=lo_flat,
        A=A, Ap=Ap, n_sel=A0,
    )


def _asm_finish(d, c):
    """Fetch one finished beam group's rejoined lanes and build Assembly
    records (per anchor the best-supported, smallest bubble wins).
    Returns (assemblies, succeeded_local_anchor_ids, branchy_local_ids) —
    the id sets feed the adaptive-depth retry in wavefront_assemble
    (retrying an anchor that never saw a junction is pure waste: every
    clone walked the identical path)."""
    out = c["st"]
    if c.get("sel") is not None:
        # fold the compacted live subset back into the full-width state
        out = _scatter_state(c["full_st"], c["st"], c["sel"])
    Ap, A, MAXP, k = c["Ap"], c["A"], c["MAXP"], c["k"]
    rep, anchor_flat, lo_flat = c["rep"], c["anchor_flat"], c["lo_flat"]
    # transfer only rejoined lanes (device-side compaction): the path matrix
    # is the bulk of the output and most lanes never rejoin.  All scalar
    # outputs ride ONE stacked transfer — each fetch over the device link
    # pays full round-trip latency.
    packed_out = _compact_hits_jit(
        out["rejoin"], out["out_len"], out["out_support"]
    )
    po = np.asarray(packed_out)
    n = int(po[4, 0])
    lanes = po[0, :n]
    rejoin = po[1, :n]
    out_len = po[2, :n]
    out_support = po[3, :n]
    if n:
        n_pad = min(_next_pow2(n), Ap)  # bucket gather shapes
        out_path = np.asarray(
            jnp.take(
                out["path"], jnp.asarray(po[0, :n_pad], jnp.int64), axis=0
            )
        )[:n]
    else:
        out_path = np.zeros((0, MAXP), np.uint8)

    results = {}
    for hit in range(n):
        lane = int(lanes[hit])
        if lane >= A:
            continue
        j_flat = lo_flat + int(rejoin[hit])
        a_flat = int(anchor_flat[lane])
        alt_len = int(out_len[hit]) - k
        if alt_len < 0 or j_flat <= a_flat:
            continue
        asm = Assembly(
            chunk_start=lo_flat,
            anchor=a_flat,
            rejoin=j_flat,
            seq=out_path[hit, :alt_len].copy(),
            support=int(out_support[hit]),
        )
        key = rep[lane]
        old = results.get(key)
        if old is None or _asm_better(asm, old):
            results[key] = asm
    nj = np.asarray(out["n_junction"])[:A]
    branchy = {int(rep[lane]) for lane in np.nonzero(nj > 0)[0]}
    return list(results.values()), set(results.keys()), branchy


@jax.jit
def _compact_hits_jit(rejoin, out_len, out_support):
    """Rejoined lanes compacted to the front, as ONE stacked int64 [5, Ap]
    array (rows: lane id, rejoin, out_len, out_support, hit count broadcast)
    so the host needs a single device fetch."""
    hit = rejoin >= 0
    key = (~hit).astype(jnp.int32)
    idx = jnp.arange(rejoin.shape[0], dtype=jnp.int64)
    _, sidx, srj, slen, ssup = lax.sort(
        (key, idx, rejoin, out_len.astype(jnp.int64), out_support),
        num_keys=2,
        is_stable=True,
    )
    n = jnp.broadcast_to(jnp.sum(hit).astype(jnp.int64), sidx.shape)
    return jnp.stack([sidx, srj, slen, ssup, n])


def _next_pow2(n):
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


from functools import partial as _partial


def _discovery_memory_plan(ss: Seqset, G: int, stats: dict | None = None):
    """Budget discovery's device-resident working set against HBM
    (resource_manager scratch-quota analog, modules/mapred/resource_manager.h:7;
    multi-pass sizing as in kmer_counter.h:29).

    Accounts the seqset core (rank bitplanes + cum + shared/sizes/pop_sel +
    LtSearch blocks), the doubled reference, the two n-entry trunc tables,
    and the shared rejoin span table against MemoryBudget.detect()
    (BGT_HBM_BUDGET_BYTES override).  Over budget, features degrade in
    cost order: the shared span table shrinks/disappears first (groups fall
    back to their own bounded tables), then the trunc tables are dropped
    and the wavefront truncates through LtSearch in-loop.  The chosen plan
    is recorded in stats["memory_plan"]."""
    from biograph_jax.runtime.resources import MemoryBudget

    budget = MemoryBudget.detect()
    n = int(ss.n_entries)
    pw = np.asarray(ss.prev_words)
    core = (
        pw.nbytes  # rank bit words (uint32)
        + pw.size * 8  # exclusive prefix popcounts (int64)
        + n * 4  # shared (int32)
        + n * 4  # entry_sizes (int32)
        + n * 8  # pop_sel (int64)
        + n // 4  # LtSearch block minima (both directions, coarse)
    )
    ref2 = 2 * G  # doubled fwd++rc reference, uint8
    trunc = 16 * n  # prev_lt + next_lt, int64 each
    head = budget.bytes - core - ref2
    use_trunc = head >= trunc
    span_budget = head - (trunc if use_trunc else 0)
    span_cap = min(SPAN_TABLE_CAP, max(span_budget // 16, 0))
    if span_cap < 16384:  # smallest ladder rung — shared table off
        span_cap = 0
    plan = {
        "budget_bytes": budget.bytes,
        "core_bytes": core,
        "ref2_bytes": ref2,
        "trunc_bytes": trunc,
        "use_trunc_tables": bool(use_trunc),
        "span_table_cap": int(span_cap),
    }
    if stats is not None:
        stats["memory_plan"] = plan
    return plan


_PRESCREEN_K = 12  # bitmap k-mer (4^12 = 16.7M one-byte slots = 16 MB HBM)
_PRESCREEN_BLK = 256  # coverage-block granularity (>= any probe depth)


@jax.jit
def _prescreen_bitmap_jit(d):
    """uint8 [4^K] membership bitmap of every K-mer present in the read set.

    The seqset's entries are the prefix-maximal distinct suffixes of
    reads ++ revcomps, so the K-prefixes of entries with size >= K
    enumerate EXACTLY the length-K substrings of the read set (a substring
    is a prefix of the suffix at its position, and prefix-maximality only
    folds suffixes into longer entries that retain them as prefixes); the
    set is rc-closed because the build includes revcomps."""
    K = _PRESCREEN_K
    n = d.n_entries
    seqs = d.sequences(jnp.arange(n, dtype=jnp.int64), K)
    val = jnp.zeros((n,), jnp.int64)
    for i in range(K):
        val = (val << 2) | seqs[:, i].astype(jnp.int64)
    valid = d.entry_sizes >= K
    return (
        jnp.zeros((1 << (2 * K),), jnp.uint8)
        .at[jnp.where(valid, val, 0)]
        .max(valid.astype(jnp.uint8))
    )


@jax.jit
def _hit_mask(bitmap, ref2_dev):
    """Per-position 'the K-mer ENDING here is a read K-mer' (positions
    p < K-1 read a zero pad — anchors need >= min_anchor_ctx of context so
    none live there).  Padded to a BLK multiple."""
    K = _PRESCREEN_K
    BLK = _PRESCREEN_BLK
    n2 = ref2_dev.shape[0]
    nb = -(-n2 // BLK)
    refp = jnp.concatenate(
        [
            jnp.zeros((K - 1,), ref2_dev.dtype),
            ref2_dev,
            jnp.zeros((nb * BLK - n2,), ref2_dev.dtype),
        ]
    )
    val = jnp.zeros((nb * BLK,), jnp.int64)
    for j in range(K):
        val = (val << 2) | lax.dynamic_slice_in_dim(refp, j, nb * BLK).astype(
            jnp.int64
        )
    hit = jnp.take(bitmap, val) > 0
    return hit.at[n2:].set(False)


@jax.jit
def _hit_blocks_packed(bitmap, ref2_dev):
    """packbits over per-BLK-block 'any position's K-mer is a read K-mer'."""
    hit = _hit_mask(bitmap, ref2_dev)
    return jnp.packbits(hit.reshape(-1, _PRESCREEN_BLK).any(axis=1))


@jax.jit
def _hit_count(bitmap, ref2_dev):
    return jnp.sum(_hit_mask(bitmap, ref2_dev).astype(jnp.int64))


@_partial(jax.jit, static_argnums=(2,))
def _hit_positions_jit(bitmap, ref2_dev, Pc: int):
    """The first Pc hit positions via cumsum + searchsorted compaction
    (pads -> -1)."""
    hit = _hit_mask(bitmap, ref2_dev)
    cs = jnp.cumsum(hit.astype(jnp.int64))
    src = jnp.searchsorted(cs, jnp.arange(1, Pc + 1, dtype=jnp.int64))
    return jnp.where(src < hit.shape[0], src, jnp.int64(-1))


def _prescreen_blocks(ss: Seqset, ref2_dev) -> np.ndarray:
    """Per-BLK-block read-K-mer coverage bits for this (seqset, reference)
    pair: ONE tiny packed fetch (~n2/BLK/8 bytes) decides the whole
    genome's walk work.  The K-mer bitmap (a pure seqset property) is
    cached on the instance; the block bits depend on the reference too and
    are recomputed per call (the device compute is one cached program)."""
    bm = ss.__dict__.get("_prescreen_bitmap")
    if bm is None:
        bm = _prescreen_bitmap_jit(ss.d)
        ss.__dict__["_prescreen_bitmap"] = bm
    return np.unpackbits(np.asarray(_hit_blocks_packed(bm, ref2_dev)))


def _prescreen_spans(packed: np.ndarray, lo: int, hi: int):
    """Merged [lo, hi) sub-intervals whose BLK-blocks contain any read
    K-mer hit — the only places a >= min_anchor_ctx window (hence an
    anchor) can exist.  Returns a list of (span_lo, span_hi)."""
    BLK = _PRESCREEN_BLK
    b_lo, b_hi = lo // BLK, -(-hi // BLK)
    cov = np.zeros(b_hi - b_lo, np.int8)
    m = min(len(packed), b_hi)
    if m > b_lo:
        cov[: m - b_lo] = packed[b_lo:m]
    edges = np.diff(np.concatenate([[0], cov, [0]]))
    starts = np.nonzero(edges == 1)[0]
    ends = np.nonzero(edges == -1)[0]
    return [
        (a, b)
        for s, e in zip(starts, ends)
        for a, b in (
            (max((b_lo + int(s)) * BLK, lo), min((b_lo + int(e)) * BLK, hi)),
        )
        if b > a
    ]


@_partial(jax.jit, static_argnums=(2,))
def _block_positions_jit(bids, G2, BLK: int):
    """Covered-block lane positions built ON DEVICE from the (tiny) block-id
    upload; bid -1 pads produce negative positions (rejected by the cap)."""
    pos = bids[:, None] * BLK + jnp.arange(BLK, dtype=jnp.int64)[None, :]
    return jnp.where(bids[:, None] < 0, -1, pos).reshape(-1)


@_partial(jax.jit, static_argnums=(6, 7))
def _anchor_scan_at(d, ref2, pos, begin, end, size, min_anchor_ctx: int,
                    min_branch_width: int, cap):
    """anchor_scan over a COMPACT gathered lane set (non-contiguous pos).

    cap: per-lane anchor-position bound encoding every validity gate
    (segment membership, p_last, seg_hi, min context, padding) as
    (pos + 1) <= cap; -1 disables a lane.  Same branch-probe math and
    MAXA compaction as the contiguous scan."""
    n2 = ref2.shape[0]
    r = SeqsetRanges(begin, end, size)
    nb4, ne4 = d.push4(r)
    W4 = (ne4 - nb4)[:, ::-1]
    nxt = jnp.take(ref2, jnp.clip(pos + 1, 0, n2 - 1)).astype(jnp.int32)
    base_ids = jnp.arange(4)[None, :]
    good = (
        (W4 >= min_branch_width)
        & (base_ids != nxt[:, None])
        & (size[:, None] >= min_anchor_ctx)
        & ((pos + 1)[:, None] <= cap[:, None])
        & (begin < end)[:, None]
    )
    flat = good.reshape(-1)
    cs = jnp.cumsum(flat.astype(jnp.int64))
    n_raw = cs[-1]
    n_anchors = jnp.minimum(n_raw, MAXA)
    src = jnp.searchsorted(cs, jnp.arange(1, MAXA + 1, dtype=jnp.int64))
    valid = src < flat.shape[0]
    srcc = jnp.clip(src, 0, flat.shape[0] - 1)
    li = srcc // 4
    ab = srcc % 4
    stacked = jnp.stack(
        [
            jnp.where(valid, jnp.take(pos, li), 0),
            jnp.where(valid, ab, 0),
            jnp.where(valid, jnp.take(begin, li), 0),
            jnp.where(valid, jnp.take(end, li), 0),
            jnp.where(valid, jnp.take(size, li).astype(jnp.int64), 0),
        ]
    )
    counts = jnp.stack([n_anchors, n_raw])
    return counts, stacked


def _discover_compact(ss, reference, ref, ref2, ref2_dev, segments, opt,
                      stats, stage_s, anchor_parts, all_asms, all_records,
                      readmap, out_assemblies, G, P, _t, mem_plan):
    """Prescreened compact frontend: filter -> exact -> anchor over the
    gathered covered-block positions only.

    Replaces the per-position restart-chain wave entirely: candidate lanes
    are the covered blocks' positions (a tiny device upload of block ids —
    the positions themselves are built on device), the min_anchor_ctx
    find-window filter kills non-anchor lanes, and the binary-search exact
    probe recovers the same longest-window ranges the dense pipeline
    computes, so anchors — and records — are identical (gated by
    tests/test_discover.py::test_prescreen_identity)."""
    from biograph_jax.index.probes import fetch_mask as _fetch
    from biograph_jax.index.probes import find_window_hash

    d = ss.d
    bm = ss.__dict__.get("_prescreen_bitmap")
    if bm is None:
        bm = _prescreen_bitmap_jit(ss.d)
        ss.__dict__["_prescreen_bitmap"] = bm
    # candidate lanes = EXACT hit positions (block granularity over-covers
    # ~10x: repeats scatter sites genome-wide and every site pays
    # 2*BLK*strands lanes) — one tiny count fetch sizes the compaction
    n_hits = int(_hit_count(bm, ref2_dev))
    stats["prescreen_probed"] = n_hits
    if n_hits == 0:
        stage_s["anchors"] = stage_s.get("anchors", 0.0) + (time.time() - _t)
        return _dedup_records(all_records)
    Pc = max(_next_pow2(n_hits), 1024)
    pos = _hit_positions_jit(bm, ref2_dev, Pc)
    # per-lane validity cap and context clip (<= 2 segments: a where-chain)
    cap = jnp.full(pos.shape, -1, jnp.int64)
    ctx = jnp.zeros(pos.shape, jnp.int64)
    for _, ctx_lo, p_first, p_last, seg_hi in segments:
        in_seg = (pos >= p_first) & (pos <= p_last)
        cap = jnp.where(
            in_seg, jnp.int64(min(seg_hi, p_last + 1)), cap
        )
        ctx = jnp.where(in_seg, jnp.int64(ctx_lo), ctx)
    cap = jnp.where(pos - ctx + 1 >= opt.min_anchor_ctx, cap, -1)
    # filter: does a min_anchor_ctx window end here?
    m_vec = jnp.full(pos.shape, opt.min_anchor_ctx, jnp.int32)
    posc = jnp.clip(pos, 0, 2 * G - 1)
    use_hash_filter = not os.environ.get("BGT_NO_HASH_FILTER")
    if use_hash_filter:
        # rank-free filter (probes.find_window_hash): one rolling-hash
        # lookup per lane instead of a min_anchor_ctx-step rank chain —
        # the chain cost was the frontend's floor at HBM-scale seqsets
        fb, fe, fs = find_window_hash(ss, ref2_dev, posc, opt.min_anchor_ctx)
    else:
        fb, fe, fs = _find_window_jit(d, ref2_dev, posc, m_vec, opt.probe_ctx)
    stage_s["probe_filter"] = stage_s.get("probe_filter", 0.0) + (time.time() - _t)
    _t = time.time()
    alive_dev = (fb < fe) & (cap >= 0)
    if use_hash_filter:
        # branch pre-gate: the exact longest window's range is a SUBSET
        # of the filter window's range, so branch width there is
        # bounded by branch width here — one push4 over the filter
        # ranges is a necessary condition for anchorhood that compacts
        # the lanes ~100x before the expensive exact bisection
        nb4, ne4 = d.push4(SeqsetRanges(fb, fe, fs))
        W4 = (ne4 - nb4)[:, ::-1]
        nxt = jnp.take(
            ref2_dev, jnp.clip(posc + 1, 0, ref2_dev.shape[0] - 1)
        ).astype(jnp.int32)
        any_branch = jnp.any(
            (W4 >= opt.min_branch_width)
            & (jnp.arange(4)[None, :] != nxt[:, None]),
            axis=1,
        )
        alive_dev = alive_dev & any_branch
    alive = _fetch(alive_dev)
    if not alive.any():
        stage_s["anchors"] = stage_s.get("anchors", 0.0) + (time.time() - _t)
        return _dedup_records(all_records)
    idx = np.nonzero(alive)[0]
    m2 = _next_pow2(len(idx))
    sel = np.concatenate([idx, np.full(m2 - len(idx), idx[-1])])
    selj = jnp.asarray(sel)
    pos2 = jnp.take(posc, selj)
    # pad lanes repeat a real lane — disable their anchors via cap
    cap2 = jnp.where(
        jnp.arange(m2) < len(idx), jnp.take(cap, selj), jnp.int64(-1)
    )
    ctx2 = jnp.take(ctx, selj)
    seed = (jnp.take(fb, selj), jnp.take(fe, selj), jnp.take(fs, selj))
    b2, e2, s2 = _probe_exact_jit(
        d, ref2_dev, pos2, ctx2, opt.probe_ctx,
        opt.min_anchor_ctx, seed,
    )
    stage_s["probe_exact"] = stage_s.get("probe_exact", 0.0) + (time.time() - _t)
    _t = time.time()
    counts, stacked = _anchor_scan_at(
        d, ref2_dev, pos2, b2, e2, s2, opt.min_anchor_ctx,
        opt.min_branch_width, cap2,
    )
    n, n_raw = (int(x) for x in np.asarray(counts))
    stats["anchors_found"] += n_raw
    if n_raw > n:
        stats["anchors_truncated"] += n_raw - n
        import warnings

        warnings.warn(
            f"discovery: {n_raw - n} anchors over the {MAXA} cap were "
            "dropped; raise MAXA"
        )
    if n:
        live = np.asarray(stacked[:, : min(_next_pow2(n), MAXA)])[:, :n]
        # split by orientation (the compact scan pools both halves)
        for rev_half in (False, True):
            m = (live[0] >= G) == rev_half
            if m.any():
                anchor_parts.setdefault(rev_half, []).append(
                    tuple(c[m] for c in live)
                )
    stage_s["anchors"] = stage_s.get("anchors", 0.0) + (time.time() - _t)
    _t = time.time()
    return _finish_from_anchors(
        ss, reference, ref, ref2, ref2_dev, opt, stats, stage_s,
        anchor_parts, all_asms, all_records, readmap, out_assemblies, G, _t,
        mem_plan=mem_plan, prescreen={"pos": pos},
    )


def use_prescreen(opt) -> bool:
    """K-mer coverage prescreen gate: sound whenever anchors require at
    least K bases of context (a window of length >= min_anchor_ctx >= K
    ending at p contains the K-mer ending at p, so un-hit positions can
    never anchor and their walk state is never consumed).  BGT_NO_PRESCREEN
    opts out (e.g. to time the dense walk)."""
    return (
        opt.min_anchor_ctx >= _PRESCREEN_K
        and not os.environ.get("BGT_NO_PRESCREEN")
    )


def _trunc_tables(ss: Seqset, c: int):
    """Constant-threshold widen tables: prev_lt[i] = largest j <= i with
    shared[j] < c (-1 if none); next_lt[i] = smallest j >= i with
    shared[j] < c (n if none).

    truncate_ranges to a KNOWN constant c is then two gathers per lane
    instead of two block-structured less-than searches — the wavefront
    truncates to probe_ctx every step, and the searches would dominate its
    step cost.

    Cached on the Seqset instance only (an id()-keyed process-global dict
    previously risked leaking tables and, after id reuse, serving a NEW
    seqset the OLD seqset's tables — wrong truncation, wrong calls)."""
    cache = ss.__dict__.setdefault("_trunc_cache", {})
    hit = cache.get(c)
    if hit is None:
        shared = np.asarray(ss.shared)
        n = len(shared)
        idx = np.arange(n, dtype=np.int64)
        lt = shared < c
        prev_lt = np.maximum.accumulate(np.where(lt, idx, -1))
        nxt = np.where(lt, idx, n)
        next_lt = np.minimum.accumulate(nxt[::-1])[::-1]
        hit = (jnp.asarray(prev_lt), jnp.asarray(next_lt.astype(np.int64)))
        cache[c] = hit
    return hit


def _wavefront_seed(d, seed, MAXP: int):
    """Initial wavefront state from the per-anchor seed arrays: the first
    alt-base push and all derived state, built on device.  Plain (unjitted)
    so the sharded engine can trace it under shard_map with its adapter
    device; the local pipeline uses the jitted wrapper below."""
    A = seed["begin"].shape[0]
    r0 = d.push_front(
        SeqsetRanges(seed["begin"], seed["end"], seed["size"]),
        3 - seed["ab"],
    )
    alive0 = r0.begin < r0.end
    return dict(
        begin=r0.begin,
        end=r0.end,
        size=r0.size,
        path=jnp.zeros((A, MAXP), jnp.uint8).at[:, 0].set(
            seed["ab"].astype(jnp.uint8)
        ),
        path_len=jnp.ones((A,), jnp.int32),
        support=jnp.where(alive0, r0.end - r0.begin, 0).astype(jnp.int64),
        n_junction=jnp.zeros((A,), jnp.int32),
        roll=seed["ab"].astype(jnp.uint64),
        done=~alive0,
        policy=seed["policy"],
        min_local=seed["min_local"],
        rejoin=jnp.full((A,), -1, jnp.int64),
        out_len=jnp.zeros((A,), jnp.int32),
        out_support=jnp.zeros((A,), jnp.int64),
    )


_wavefront_seed_jit = _partial(jax.jit, static_argnums=(2,))(_wavefront_seed)


def _rejoin_lookup(span_tab, n_packed, roll, min_local, can,
                   pos_bits: int = None):
    """Nearest span occurrence of each rolling k-mer at/after min_local,
    within the per-lane rejoin window (2^pos_bits bases — the
    read_ahead_distance knob, assemble.h:532).  span_tab is the (K, key2)
    pair from _span_kmers_dev.  Returns (found, jpos)."""
    if pos_bits is None:
        pos_bits = POS_BITS
    K, key2 = span_tab
    npk = K.shape[0]
    lo = jnp.searchsorted(K, roll)  # run start of the query k-mer
    q2 = (lo.astype(jnp.uint64) << jnp.uint64(32)) | jnp.clip(
        min_local, 0, (1 << 32) - 1
    ).astype(jnp.uint64)
    idx = jnp.searchsorted(key2, q2)
    idxc = jnp.clip(idx, 0, npk - 1)
    jpos = (key2[idxc] & jnp.uint64(0xFFFFFFFF)).astype(jnp.int64)
    found = (
        can
        & (idx < n_packed)
        & (K[idxc] == roll)
        & (jpos - min_local < (1 << pos_bits))
    )
    return found, jpos


def _wavefront_body(d, packed, prev_lt, next_lt, n_packed, st, step_i,
                    MAXP: int, k: int, min_w: int, probe_ctx: int,
                    pos_bits: int = None):
    """One beam-extension step (shared by the whole-beam while_loop and the
    chunked driver).  `packed` is the (K, key2) span table pair (see
    _span_kmers_dev)."""
    kmask = jnp.uint64((1 << (2 * k)) - 1)
    if True:
        done = st["done"]
        cur = SeqsetRanges(st["begin"], st["end"], st["size"])
        # all 4 children per lane from one fused rank4 pass; candidate alt
        # base bb pushes complement 3-bb -> flip columns into bb order.
        nb4, ne4 = d.push4(cur)
        Bc = nb4[:, ::-1]
        Ec = ne4[:, ::-1]
        W = Ec - Bc  # [A, 4]
        viable = W >= min_w
        n_viable = viable.sum(axis=1)
        order = jnp.argsort(-W, axis=1, stable=True)
        rank_bit = ((st["policy"] >> jnp.minimum(st["n_junction"], 30)) & 1).astype(
            jnp.int64
        )
        take_rank = jnp.where(n_viable > 1, rank_bit, 0)
        best = jnp.take_along_axis(order, take_rank[:, None], axis=1)[:, 0]
        bw = jnp.take_along_axis(W, best[:, None], axis=1)[:, 0]
        ext = (~done) & (bw >= min_w)
        n_junction = st["n_junction"] + ((~done) & (n_viable > 1)).astype(jnp.int32)
        nb = jnp.where(ext, best, 0).astype(jnp.int32)
        new_begin = jnp.take_along_axis(Bc, nb[:, None].astype(jnp.int64), axis=1)[:, 0]
        new_end = jnp.take_along_axis(Ec, nb[:, None].astype(jnp.int64), axis=1)[:, 0]
        cur2 = SeqsetRanges(
            jnp.where(ext, new_begin, cur.begin),
            jnp.where(ext, new_end, cur.end),
            jnp.where(ext, cur.size + 1, cur.size),
        )
        if prev_lt is None:
            # HBM-budget fallback (runtime/resources.py): the two
            # n_entries-sized widen tables don't fit — truncate through the
            # LtSearch block structure instead (no extra residency, more
            # search steps per beam step)
            cur2 = d.truncate_ranges(cur2, probe_ctx)
        else:
            # truncate to probe_ctx via the precomputed constant-threshold
            # widen tables (see _trunc_tables) — semantics of
            # d.truncate_ranges(cur2, probe_ctx), at two gathers per lane
            # (owner-gather collective when d is the sharded engine)
            need = cur2.size > probe_ctx
            wb, we = d.trunc_gather(prev_lt, next_lt, cur2.begin, cur2.end)
            cur2 = SeqsetRanges(
                jnp.where(need, wb, cur2.begin),
                jnp.where(need, we, cur2.end),
                jnp.where(need, probe_ctx, cur2.size),
            )
        path = st["path"].at[:, step_i].set(
            jnp.where(ext, nb.astype(jnp.uint8), st["path"][:, step_i])
        )
        path_len = jnp.where(ext, step_i + 1, st["path_len"])
        support = jnp.where(ext, jnp.minimum(st["support"], bw), st["support"])
        roll = jnp.where(
            ext,
            ((st["roll"] << jnp.uint64(2)) | nb.astype(jnp.uint64)) & kmask,
            st["roll"],
        )
        done = done | ~ext

        # rejoin: nearest span occurrence of the rolling kmer after the anchor
        can = ext & (path_len > k)
        found, jpos = _rejoin_lookup(
            packed, n_packed, roll, st["min_local"], can, pos_bits
        )
        newly = found & (st["rejoin"] < 0)
        rejoin = jnp.where(newly, jpos, st["rejoin"])
        out_len = jnp.where(newly, path_len, st["out_len"])
        out_support = jnp.where(newly, support, st["out_support"])
        done = done | newly
        return dict(
            begin=cur2.begin,
            end=cur2.end,
            size=cur2.size,
            path=path,
            path_len=path_len,
            support=support,
            n_junction=n_junction,
            roll=roll,
            done=done,
            policy=st["policy"],
            min_local=st["min_local"],
            rejoin=rejoin,
            out_len=out_len,
            out_support=out_support,
        )


def _wavefront_loop(d, packed, prev_lt, next_lt, n_packed, st, MAXP: int,
                    k: int, min_w: int, probe_ctx: int,
                    pos_bits: int = None):
    """Early-exit while loop over beam steps from a full state dict.  Plain
    (unjitted) for the same shard_map-reuse reason as _wavefront_seed."""

    def cond(carry):
        step_i, st = carry
        return (step_i < MAXP) & jnp.any(~st["done"])

    def body(carry):
        step_i, st = carry
        return step_i + 1, _wavefront_body(
            d, packed, prev_lt, next_lt, n_packed, st, step_i,
            MAXP, k, min_w, probe_ctx, pos_bits,
        )

    _, st = lax.while_loop(cond, body, (jnp.asarray(1, jnp.int32), st))
    return st


_wavefront_loop_jit = _partial(jax.jit, static_argnums=(6, 7, 8, 9, 10))(
    _wavefront_loop
)


@_partial(jax.jit, static_argnums=(6, 7, 8, 9, 10))
def _wavefront_jit(d, packed, prev_lt, next_lt, n_packed, seed, MAXP: int,
                   k: int, min_w: int, probe_ctx: int, pos_bits: int = None):
    """The whole beam extension as one device program (early-exit while).

    Most lanes rejoin or die within ~read-length steps, so running all MAXP
    iterations would pay 5-10x the needed sequential latency."""
    st = _wavefront_seed_jit(d, seed, MAXP)
    return _wavefront_loop_jit(
        d, packed, prev_lt, next_lt, n_packed, st, MAXP, k, min_w, probe_ctx,
        pos_bits,
    )


@_partial(jax.jit, static_argnums=(7, 8, 9, 10, 11, 12))
def _wavefront_chunk_jit(d, packed, prev_lt, next_lt, n_packed, st, step0,
                         nsteps: int, MAXP: int, k: int, min_w: int,
                         probe_ctx: int, pos_bits: int = None):
    """`nsteps` beam steps as ONE device while_loop with early exit — the
    interleaved driver's inner unit: one launch per CHECK_EVERY steps,
    early exit inside the chunk, and the driver's host compaction still
    runs between chunks."""
    step0 = jnp.asarray(step0, jnp.int32)

    def cond(c):
        i, s = c
        return (i < nsteps) & jnp.any(~s["done"])

    def body(c):
        i, s = c
        return i + 1, _wavefront_body(
            d, packed, prev_lt, next_lt, n_packed, s, step0 + i,
            MAXP, k, min_w, probe_ctx, pos_bits,
        )

    _, st = lax.while_loop(cond, body, (jnp.int32(0), st))
    return st


@jax.jit
def _undone_count(st):
    return jnp.sum(~st["done"])


@jax.jit
def _live_front_idx(st):
    """Lane indices sorted live-first (stable): the first `undone` entries
    are exactly the live lanes; the rest are done lanes usable as padding."""
    done = st["done"]
    idx = jnp.arange(done.shape[0], dtype=jnp.int64)
    _, sidx = lax.sort((done.astype(jnp.int32), idx), num_keys=2, is_stable=True)
    return sidx


@_partial(jax.jit, static_argnums=(2,))
def _gather_state(st, sel, n: int):
    """Rows sel[:n] of every per-lane state array (beam-state shrink)."""
    s = sel[:n]
    return {k: jnp.take(v, s, axis=0) for k, v in st.items()}


@jax.jit
def _scatter_state(full, small, sel):
    """Write the compacted rows back into the full-width state (done rows
    rewrite their own frozen values — harmless)."""
    return {k: full[k].at[sel].set(small[k]) for k in full}


def _maybe_compact(c, undone: int) -> None:
    """Shrink ctx c's beam state to the live-lane subset when sparse.

    The compacted state's rows map to full-state rows via c["sel"]; on
    every further shrink the selection is composed device-side, and
    _asm_finish scatters the survivor rows back before harvesting.  Shapes
    stay pow2-bucketed so each width compiles once."""
    if not WAVE_COMPACT:
        return
    Ap_cur = c["st"]["begin"].shape[0]
    new_Ap = max(_next_pow2(max(undone, 1)), WAVE_COMPACT_MIN)
    if new_Ap * 4 > Ap_cur:  # only shrink on >=4x reduction (hysteresis)
        return
    global WAVE_COMPACTIONS
    WAVE_COMPACTIONS += 1
    sidx = _live_front_idx(c["st"])
    if c.get("sel") is None:
        c["full_st"] = c["st"]
        sel_new = lax.slice_in_dim(sidx, 0, new_Ap)
    else:
        # fold current small state into full, then re-select
        c["full_st"] = _scatter_state(c["full_st"], c["st"], c["sel"])
        sel_new = jnp.take(c["sel"], lax.slice_in_dim(sidx, 0, new_Ap))
    c["sel"] = sel_new
    c["st"] = _gather_state(c["full_st"], sel_new, new_Ap)


# host-loop wavefront: steps between done-fetches (one tiny sync each; with
# interleaved groups the fetch overlaps other groups' queued compute)
CHECK_EVERY = int(os.environ.get("BGT_CHECK_EVERY", "48"))
WAVE_LANES = int(os.environ.get("BGT_WAVE_LANES", "4096"))  # lanes per group
# done-lane compaction: when live lanes fall below 1/4 of the state width,
# shrink the beam state to the live subset (pow2-bucketed shapes) so late
# steps — where most lanes have already rejoined or died — stop paying
# full-width rank/gather cost.  BGT_NO_WAVE_COMPACT=1 disables.
WAVE_COMPACT = not os.environ.get("BGT_NO_WAVE_COMPACT")
WAVE_COMPACT_MIN = 512  # never shrink below this width
WAVE_COMPACTIONS = 0  # process-lifetime shrink count (autostats counter)


def _asm_better(a: Assembly, b: Assembly) -> bool:
    """Prefer higher support, then the more parsimonious bubble."""
    if a.support != b.support:
        return a.support > b.support
    da = abs((a.rejoin - a.anchor - 1) - len(a.seq)) + len(a.seq)
    db = abs((b.rejoin - b.anchor - 1) - len(b.seq)) + len(b.seq)
    return da < db


POS_BITS = 18  # per-lane rejoin search window, log2 (span itself unbounded)
# shared-span-table row budget: 2^23 rows = 134 MB (two uint64 arrays) —
# microbial genomes share one table per orientation; bigger scaffolds fall
# back to per-group bounded spans
SPAN_TABLE_CAP = int(os.environ.get("BGT_SPAN_TABLE_CAP", str(1 << 23)))


@_partial(jax.jit, static_argnums=(3, 4))
def _span_kmers_dev(ref2_dev, lo, span_len, npk: int, k: int):
    """Span k-mer table built ON DEVICE from the already-uploaded reference.

    Returns (K, key2), both uint64 [npk]:
      * K    — k-mers of the span sorted ascending (pads sort last as ~0),
      * key2 — (run_start(K[i]) << 32) | pos[i], ascending.
    One searchsorted on K finds a query k-mer's run start r; a second
    searchsorted on key2 for (r << 32 | min_pos) finds that k-mer's nearest
    occurrence at/after min_pos (positions are the secondary sort key).
    Unlike the old (kmer << 18 | pos) single-word packing this puts NO limit
    on the span length (pos is 32-bit), so one beam batch can serve anchors
    across a whole scaffold instead of 256 kb windows."""
    i = jnp.arange(npk, dtype=jnp.int64)
    n2 = ref2_dev.shape[0]
    # zero-pad so every slice below fits without clamp distortion (lanes past
    # span_len are invalidated below; pads are never read by valid lanes)
    refp = jnp.concatenate([ref2_dev, jnp.zeros((npk,), ref2_dev.dtype)])
    acc = jnp.zeros((npk,), jnp.uint64)
    for j in range(k):
        # contiguous window: a length-npk slice at lo+j (a slice streams at
        # bandwidth speed where a gather would not)
        c = lax.dynamic_slice_in_dim(
            refp, jnp.clip(lo + j, 0, n2), npk
        ).astype(jnp.uint64)
        acc = (acc << jnp.uint64(2)) | c
    valid = (i + k) <= span_len
    ones = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    kmers = jnp.where(valid, acc, ones)
    pos = jnp.where(valid, i.astype(jnp.uint64), ones)
    K, P = lax.sort((kmers, pos), num_keys=2)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), K[1:] != K[:-1]]
    )
    i0 = lax.cummax(jnp.where(first, i, 0))
    key2 = jnp.where(
        K == ones, ones, (i0.astype(jnp.uint64) << jnp.uint64(32)) | P
    )
    return K, key2


@_partial(jax.jit, static_argnums=(3, 4))
def _span_kmers_compact_dev(ref2_dev, lo, span_len, npk: int, k: int,
                            pos_abs=None):
    """_span_kmers_dev over a COMPACT covered-position subset.

    pos_abs: int64 [npk] absolute ref2 start positions (pad with -1).  Every
    rolling k-mer the beam can query is read content (the truncated range
    witnesses the path's last probe_ctx >= k bases as a read substring), and
    every span occurrence of a read k-mer lies in a prescreen-covered block
    (its ending K-mer is a read K-mer) — so a table holding ONLY covered
    blocks' rows answers every reachable query identically to the dense
    span table, at a fraction of the rows (test-gated record identity)."""
    n2 = ref2_dev.shape[0]
    i = jnp.arange(npk, dtype=jnp.int64)
    rel = pos_abs - lo
    idx = jnp.clip(
        pos_abs[:, None] + jnp.arange(k, dtype=jnp.int64)[None, :], 0, n2 - 1
    )
    w = jnp.take(ref2_dev, idx).astype(jnp.uint64)
    acc = jnp.zeros((npk,), jnp.uint64)
    for j in range(k):
        acc = (acc << jnp.uint64(2)) | w[:, j]
    valid = (pos_abs >= 0) & (rel >= 0) & (rel + k <= span_len)
    ones = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    kmers = jnp.where(valid, acc, ones)
    pos = jnp.where(valid, rel.astype(jnp.uint64), ones)
    K, P = lax.sort((kmers, pos), num_keys=2)
    first = jnp.concatenate([jnp.ones((1,), bool), K[1:] != K[:-1]])
    i0 = lax.cummax(jnp.where(first, i, 0))
    key2 = jnp.where(
        K == ones, ones, (i0.astype(jnp.uint64) << jnp.uint64(32)) | P
    )
    return K, key2, jnp.sum(valid.astype(jnp.int64))


def discover_variants(
    ss: Seqset,
    reference,
    region: tuple | None = None,
    opt: DiscoverOptions | None = None,
    chunk_len: int | None = None,
    chunk_batch: int | None = None,
    readmap: Readmap | None = None,
    stats: dict | None = None,
    out_assemblies: list | None = None,
    engine=None,
):
    """Top-level driver: reference walk -> anchors -> wavefront -> variants.

    engine: optional ShardedDiscoveryEngine (parallel/sharded_discovery.py).
    When given, every seqset-touching stage (probe chains, exact recompute,
    anchor scan, wavefront) runs over the ENTRY-SHARDED structure on the
    engine's mesh instead of ss.d's single-device arrays — the memory-bounded
    production path for seqsets larger than one device's memory.  Records are
    bit-identical to the local engine (tests/test_sharded_discovery.py).

    out_assemblies: optional list; the scored, deduped Assembly records are
    appended to it (the discovery CSV dump's data source, analog of
    DiscoveryMain::write_csv_assembly, biograph_variants.cpp:546).

    region: (flat_start, flat_end) or None for the whole reference.
    Chunks overlap by opt.max_path so bubbles crossing a boundary are seen by
    the chunk that owns their anchor (the reference's scaffold_split_size
    chunking + anchored rejoin, modules/variants/assemble.h:535).

    Both orientations probe over a doubled (fwd ++ rc) reference array.
    Anchor detection is per-position-parallel (probe_ranges): sequential
    depth probe_ctx instead of a chunk-length walk.  `stats` (optional dict,
    filled in place) reports anchor/assembly truncation so dense regions
    can't drop candidates silently (assemble_stats counters analog,
    modules/io/autostats.h:25).  chunk_len/chunk_batch are kept for
    API compatibility; chunk_batch bounds the probe batch width.
    """
    opt = opt or DiscoverOptions()
    ref = np.asarray(reference.flat)
    G = len(ref)
    lo, hi = region if region else (0, G)
    if stats is None:
        stats = {}
    stats.setdefault("anchors_found", 0)
    stats.setdefault("anchors_truncated", 0)
    stats.setdefault("assemblies_truncated", 0)
    all_records = []
    mem_plan = _discovery_memory_plan(ss, G, stats)
    ref2 = np.concatenate([ref, (3 - ref[::-1]).astype(np.uint8)])
    # one transfer for all batches (mesh-replicated in sharded mode so the
    # shard_map stages see a consistently-placed operand)
    ref2_dev = engine.replicate(ref2) if engine else jnp.asarray(ref2)
    # fwd + reverse-complement work duplication (trace_ref.h:33-51,
    # reversable_tracer.cpp:40): the rc pass anchors events from their right
    # side, recovering candidates whose left context is repeat-poisoned.
    # Segments: (rev_half, ctx_lo, first_probe, last_probe, max_anchor_pos)
    segments = []
    if not opt.skip_trace_fwd:
        segments.append((False, 0, lo, min(hi, G - 1) - 1, min(hi, G - 1)))
    if opt.bidir and not opt.skip_trace_rev:
        lo_r, hi_r = G - hi, G - lo
        seg_hi_r = min(2 * G - lo, 2 * G - 1)
        segments.append((True, G, G + lo_r, seg_hi_r - 1, seg_hi_r))
    if not segments:
        return []
    all_asms: List[Assembly] = []
    anchor_parts: dict = {}
    span = max(hi - lo, 1)
    # on the GPU fewer, wider probe batches (up to the scaffold split size)
    # amortize the per-step dispatch; the CPU backend prefers cache-sized
    # batches.  Not yet measured on the card.
    wide = engine is None and backend() == "gpu"
    P_cap = (
        _next_pow2(opt.scaffold_split_size)
        if wide
        else min(_next_pow2(opt.scaffold_split_size), 1 << 17)
    )
    P = chunk_batch or min(max(_next_pow2(span), 4096), P_cap)
    # The probe/filter/anchor pipeline runs in DISPATCH WAVES: every batch's
    # chain is enqueued before any batch's results are fetched, so each
    # fetch waits only for its own data while every other batch's compute
    # (and transfers) proceed behind it — over a high-latency device link
    # the syncs stop serializing the whole genome.
    batches = [
        (rev_half, ctx_lo, p0, p_last, seg_hi, P)
        for rev_half, ctx_lo, p_first, p_last, seg_hi in segments
        for p0 in range(p_first, p_last + 1, P)
    ]
    _t = time.time()  # stage wall marks -> stats["stage_s"] (autostats analog)
    stage_s = stats.setdefault("stage_s", {})
    from biograph_jax.index.probes import use_walk_device as _use_walk_dev
    from biograph_jax.index.probes import use_walk_probes as _use_walk
    from biograph_jax.index.probes import walk_ranges_device as _walk_dev
    from biograph_jax.index.probes import walk_ranges_multi as _walk_multi

    if engine is None and _use_walk_dev(ss.d) and not _use_walk(ss.d):
        # single-launch device walk (probes.walk_ranges_device): the whole
        # genome's matching statistics in ONE jitted lax.while_loop program —
        # least rank work (O(P + lanes*depth)) AND least launches, the combo
        # neither the probe pipeline (O(P*depth) ranks) nor the
        # host-dispatched walk (hundreds of dispatches) achieves.
        seg_nb = [
            len(range(p_first, p_last + 1, P))
            for (_, _, p_first, p_last, _) in segments
        ]
        trunc = (
            _trunc_tables(ss, opt.probe_ctx)
            if (mem_plan is None or mem_plan["use_trunc_tables"])
            else None
        )
        seg_widths = [nb * P for nb in seg_nb]
        if use_prescreen(opt):
            # walk ONLY read-k-mer-covered blocks (see _prescreen_spans):
            # un-hit positions can never anchor, and zeros in the un-walked
            # output slots fail every anchor gate — output-identical, with
            # walk work proportional to COVERED genome, not genome length
            blocks = _prescreen_blocks(ss, ref2_dev)
            reqs, offs = [], []
            out_total = sum(seg_widths)
            seg_off = 0
            for (rev_half, ctx_lo, p_first, _, _), width in zip(
                segments, seg_widths
            ):
                for a, b in _prescreen_spans(
                    blocks, p_first, p_first + width
                ):
                    reqs.append((a, ctx_lo, b - a))
                    offs.append(seg_off + (a - p_first))
                seg_off += width
            stats["prescreen_walked"] = sum(pp for (_, _, pp) in reqs)
            _, walk_steps, raw = _walk_dev(
                ss.d, ref2_dev, reqs, opt.probe_ctx, trunc=trunc,
                out_layout=(out_total, offs),
            )
            bounds = np.cumsum([0] + seg_widths)
            seg_walk = [
                tuple(x[bounds[i] : bounds[i + 1]] for x in raw)
                for i in range(len(segments))
            ]
        else:
            seg_walk, walk_steps, _raw = _walk_dev(
                ss.d, ref2_dev,
                [
                    (p_first, ctx_lo, w)
                    for (_, ctx_lo, p_first, _, _), w in zip(
                        segments, seg_widths
                    )
                ],
                opt.probe_ctx, trunc=trunc,
            )
        # segment-wide batches: the anchor scan consumes each segment's walk
        # output in ONE launch (the per-P slicing only existed so the probe
        # pipeline could reuse a single compiled [P] program shape)
        seg_batches = [
            (rev_half, ctx_lo, p_first, p_last, seg_hi, w)
            for (rev_half, ctx_lo, p_first, p_last, seg_hi), w in zip(
                segments, seg_widths
            )
        ]
        probe_h = [[b, e, s, None] for (b, e, s) in seg_walk]
        stage_s["walk"] = stage_s.get("walk", 0.0) + (time.time() - _t)
        _t = time.time()
        return _discover_finish(
            ss, reference, ref, ref2, ref2_dev, seg_batches, probe_h, opt,
            stats, stage_s, anchor_parts, all_asms, all_records, readmap,
            out_assemblies, G, P, _t, mem_plan=mem_plan,
            walk_check=walk_steps,
        )
    if engine is None and _use_walk(ss.d):
        # walk engine: per-position maximal-window ranges via segmented
        # sequential walks (ref_map's scan-the-reference-through-the-seqset,
        # modules/variants/ref_map.h:49, over SIMD lanes) — O(P + lanes*depth)
        # rank launches instead of the probe pipeline's O(P*depth) plus the
        # restarted-lane binary-search recompute; output contract identical
        # (tests/test_walk_probes.py), so the anchor scan consumes it as-is.
        seg_nb = [
            len(range(p_first, p_last + 1, P))
            for (_, _, p_first, p_last, _) in segments
        ]
        seg_walk = _walk_multi(
            ss.d, ref2_dev,
            [
                (p_first, ctx_lo, nb * P)
                for (_, ctx_lo, p_first, _, _), nb in zip(segments, seg_nb)
            ],
            opt.probe_ctx,
        )
        # per-batch views are device-side slices of the segment walk output
        # (the anchor scan keeps its one compiled [P] program; no transfers)
        probe_h = [
            [b[j * P : (j + 1) * P], e[j * P : (j + 1) * P],
             s[j * P : (j + 1) * P], None]
            for (b, e, s), nb in zip(seg_walk, seg_nb)
            for j in range(nb)
        ]
        stage_s["walk"] = stage_s.get("walk", 0.0) + (time.time() - _t)
        _t = time.time()
        return _discover_finish(
            ss, reference, ref, ref2, ref2_dev, batches, probe_h, opt,
            stats, stage_s, anchor_parts, all_asms, all_records, readmap,
            out_assemblies, G, P, _t, mem_plan=mem_plan,
        )
    # K-mer coverage prescreen (see _prescreen_blocks): positions whose
    # ending K-mer never occurs in the read set can't host a
    # >= min_anchor_ctx window, so only covered blocks' positions are
    # probed — as ONE compact gathered lane array (filter -> exact ->
    # anchor, no per-position restart chains at all); frontend work scales
    # with COVERED genome, not genome length.
    if engine is None and use_prescreen(opt):
        return _discover_compact(
            ss, reference, ref, ref2, ref2_dev, segments, opt, stats,
            stage_s, anchor_parts, all_asms, all_records, readmap,
            out_assemblies, G, P, _t, mem_plan,
        )
    # wave 1: all probe chains
    if engine is not None:
        probe_h = [
            list(engine.probe_ranges(ref2_dev, p0, ctx_lo, w, opt.probe_ctx))
            for (rev_half, ctx_lo, p0, p_last, seg_hi, w) in batches
        ]
    else:
        probe_h = [
            list(
                _probe_jit(
                    ss.d, ref2_dev, jnp.asarray(p0, jnp.int64),
                    jnp.asarray(ctx_lo, jnp.int64), w, opt.probe_ctx,
                )
            )
            for (rev_half, ctx_lo, p0, p_last, seg_hi, w) in batches
        ]
    stage_s["probe_dispatch"] = stage_s.get("probe_dispatch", 0.0) + (time.time() - _t)
    _t = time.time()
    # wave 2: restart masks (bit-packed); lanes past the segment end, or too
    # close to the segment start to reach min_anchor_ctx of context, can
    # never anchor — skip their exact recompute
    rst_list = []
    for (rev_half, ctx_lo, p0, p_last, seg_hi, w), h in zip(batches, probe_h):
        lane_pos = p0 + np.arange(w)
        rst_list.append(
            _fetch_mask(h[3])
            & (lane_pos <= p_last)
            & (lane_pos - ctx_lo + 1 >= opt.min_anchor_ctx)
        )
    stage_s["probe_masks"] = stage_s.get("probe_masks", 0.0) + (time.time() - _t)
    _t = time.time()
    # wave 3: anchor-candidate filters — a restarted lane only matters if
    # some window of >= min_anchor_ctx bases ending there exists (its chain
    # state is a valid lower bound otherwise, and a lane whose longest
    # window is shorter can't pass the size >= min_anchor_ctx anchor gate).
    # In zero-coverage stretches — most of a genome at low depth — this
    # kills the (expensive) binary-search recompute entirely.
    filt = {}
    for i, rst in enumerate(rst_list):
        if rst.any():
            _, ctx_lo, p0 = batches[i][:3]
            idx = np.nonzero(rst)[0]
            m = _next_pow2(len(idx))
            idx_p = np.concatenate(
                [idx, np.full(m - len(idx), idx[-1])]
            ).astype(np.int64)
            pos_p = jnp.asarray(idx_p + p0)
            m_vec = jnp.full((m,), opt.min_anchor_ctx, jnp.int32)
            filt[i] = (
                idx_p,
                pos_p,
                engine.find_window(ref2_dev, pos_p, m_vec, opt.probe_ctx)
                if engine is not None
                else _find_window_jit(ss.d, ref2_dev, pos_p, m_vec, opt.probe_ctx),
            )
    stage_s["probe_filter"] = stage_s.get("probe_filter", 0.0) + (time.time() - _t)
    _t = time.time()
    # waves 4-5: exact recompute of surviving lanes, scattered back
    for i, (idx_p, pos_p, (fb, fe, fs)) in filt.items():
        alive = _fetch_mask(fb < fe)
        if not alive.any():
            continue
        _, ctx_lo, p0 = batches[i][:3]
        idx2 = np.nonzero(alive)[0]
        m2 = _next_pow2(len(idx2))
        sel = np.concatenate([idx2, np.full(m2 - len(idx2), idx2[-1])])
        selj = jnp.asarray(sel)
        pos2 = jnp.take(pos_p, selj)
        seed_sel = (jnp.take(fb, selj), jnp.take(fe, selj), jnp.take(fs, selj))
        if engine is not None:
            b2, e2, s2 = engine.probe_exact(
                ref2_dev, pos2, ctx_lo, opt.probe_ctx, opt.min_anchor_ctx,
                seed_sel,
            )
        else:
            b2, e2, s2 = _probe_exact_jit(
                ss.d, ref2_dev, pos2, jnp.asarray(ctx_lo, jnp.int64),
                opt.probe_ctx, opt.min_anchor_ctx, seed_sel,
            )
        di = jnp.take(jnp.asarray(idx_p), selj)
        h = probe_h[i]
        h[0] = h[0].at[di].set(b2)
        h[1] = h[1].at[di].set(e2)
        h[2] = h[2].at[di].set(s2)
    stage_s["probe_exact"] = stage_s.get("probe_exact", 0.0) + (time.time() - _t)
    _t = time.time()
    return _discover_finish(
        ss, reference, ref, ref2, ref2_dev, batches, probe_h, opt,
        stats, stage_s, anchor_parts, all_asms, all_records, readmap,
        out_assemblies, G, P, _t, engine=engine, mem_plan=mem_plan,
    )


def _discover_finish(ss, reference, ref, ref2, ref2_dev, batches, probe_h,
                     opt, stats, stage_s, anchor_parts, all_asms,
                     all_records, readmap, out_assemblies, G, P, _t,
                     engine=None, mem_plan=None, walk_check=None):
    """Anchor scan -> wavefront -> score -> extract (shared by the walk-engine
    and probe-pipeline front ends; probe_h = per-batch [begin, end, size, _]
    device arrays).

    walk_check: optional device [steps, unconverged] from walk_ranges_device;
    fetched TOGETHER with the anchor counts (no extra sync) and rejected if
    the walk's safety budget tripped before every lane converged."""
    # wave 6: anchor scans (batch tuples may carry their own width as a 6th
    # element — the device-walk front end passes whole segments)
    anchor_h = []
    for b, h in zip(batches, probe_h):
        rev_half, ctx_lo, p0, p_last, seg_hi = b[:5]
        w = b[5] if len(b) > 5 else P
        if engine is not None:
            anchor_h.append(
                engine.anchor_scan(
                    ref2_dev, h[0], h[1], h[2], p0, min(seg_hi, p0 + w),
                    opt.min_anchor_ctx, opt.min_branch_width,
                )
            )
        else:
            anchor_h.append(
                _anchor_jit(
                    ss.d, ref2_dev, h[0], h[1], h[2], jnp.asarray(p0, jnp.int64),
                    jnp.asarray(min(seg_hi, p0 + w), jnp.int64),
                    opt.min_anchor_ctx, opt.min_branch_width,
                )
            )
        h[0] = h[1] = h[2] = h[3] = None  # release probe state buffers
    # waves 7-8: anchor counts, then live anchor columns.  All batches'
    # counts come back in ONE fused fetch (per-batch fetches would
    # serialize one host sync per batch)
    count_rows = [c for c, _ in anchor_h]
    if walk_check is not None:
        count_rows.append(walk_check.astype(jnp.int64))
    counts_all = (
        np.asarray(jnp.stack(count_rows))
        if count_rows
        else np.zeros((0, 2), np.int64)
    )
    if walk_check is not None:
        walk_steps, walk_undone = (int(x) for x in counts_all[-1])
        counts_all = counts_all[:-1]
        stats["walk_steps"] = walk_steps
        if walk_undone:
            raise RuntimeError(
                f"device walk: {walk_undone} lanes unconverged after "
                f"{walk_steps} steps (safety budget tripped) — results "
                "unusable; rerun with BGT_WALK_DEVICE=0"
            )
    for j, (b, (counts, stacked)) in enumerate(zip(batches, anchor_h)):
            rev_half = b[0]
            n, n_raw = (int(x) for x in counts_all[j])
            stats["anchors_found"] += n_raw
            if n_raw > n:
                stats["anchors_truncated"] += n_raw - n
                import warnings

                warnings.warn(
                    f"discovery: {n_raw - n} anchors over the "
                    f"{MAXA}-per-batch cap were dropped; shrink chunk_batch "
                    "or raise MAXA"
                )
            if n:
                live = np.asarray(stacked[:, : min(_next_pow2(n), MAXA)])[:, :n]
                anchor_parts.setdefault(rev_half, []).append(
                    (live[0], live[1], live[2], live[3], live[4])
                )
    stage_s["anchors"] = stage_s.get("anchors", 0.0) + (time.time() - _t)
    _t = time.time()
    return _finish_from_anchors(
        ss, reference, ref, ref2, ref2_dev, opt, stats, stage_s,
        anchor_parts, all_asms, all_records, readmap, out_assemblies, G, _t,
        engine=engine, mem_plan=mem_plan,
    )


def _finish_from_anchors(ss, reference, ref, ref2, ref2_dev, opt, stats,
                         stage_s, anchor_parts, all_asms, all_records,
                         readmap, out_assemblies, G, _t, engine=None,
                         mem_plan=None, prescreen=None):
    """Wavefront -> score -> extract from pooled per-orientation anchors."""
    # assemble once per orientation over ALL collected anchors: with sparse
    # anchors (a whole genome yields a few hundred), per-probe-batch assembly
    # ran dozens of tiny wavefronts whose fixed cost (state setup, span
    # tables, device round trips) dwarfed the useful work; pooled anchors
    # fill a few large beam batches instead
    for rev_half, parts in anchor_parts.items():
        anchors = tuple(np.concatenate(cols) for cols in zip(*parts))
        # prescreen span batches bucket up to pow2 widths and may overlap
        # the next span — dedup (pos, base) so no anchor is explored twice
        _, uidx = np.unique(
            np.stack([anchors[0], anchors[1]]), axis=1, return_index=True
        )
        if len(uidx) < len(anchors[0]):
            uidx = np.sort(uidx)
            anchors = tuple(a[uidx] for a in anchors)
        asms = wavefront_assemble(
            ss, ref2, anchors, opt, stats=stats,
            ref_limit=(2 * G if rev_half else G),
            ref_dev=ref2_dev, engine=engine, mem_plan=mem_plan,
            prescreen=prescreen,
        )
        if rev_half:
            asms = [
                _rc_assembly(
                    Assembly(
                        chunk_start=a.chunk_start - G,
                        anchor=a.anchor - G,
                        rejoin=a.rejoin - G,
                        seq=a.seq,
                        support=a.support,
                        ref_support=a.ref_support,
                    ),
                    G,
                )
                for a in asms
            ]
        all_asms.extend(asms)
    stage_s["wavefront"] = stage_s.get("wavefront", 0.0) + (time.time() - _t)
    _t = time.time()
    # dedup identical bubbles across batches/orientations BEFORE the
    # (expensive) coverage scoring — fwd and rev mostly rediscover the same
    # assemblies, and scoring is a costly stage
    uniq = {}
    for a in all_asms:
        key = (a.anchor, a.rejoin, a.seq.tobytes())
        if key not in uniq or a.support > uniq[key].support:
            uniq[key] = a
    all_asms = list(uniq.values())
    if readmap is not None:
        all_asms = score_assemblies(readmap, ref, all_asms, opt)
        # sub-threshold assemblies can never yield an emittable record
        # (write_discovery_vcf and every API consumer filter at
        # min_alt_support) — drop them before the extraction/alignment pass,
        # where unsupported repeat-mediated giant "deletions" would otherwise
        # pay huge decomposition DPs
        all_asms = [a for a in all_asms if a.support >= opt.min_alt_support]
        # in-search pair evidence (tracer.cpp:602): long alt paths without
        # any consistent mate-pair anchoring are discarded before records
        all_asms = pair_gate_assemblies(readmap, ref, all_asms, opt, stats)
    if opt.trace_offsets:
        # offset-trace debug facility (add_offset_trace analog,
        # modules/variants/assemble.h:768): dump every assembly whose bubble
        # overlaps a traced flat offset
        for a in all_asms:
            if any(a.anchor <= t <= a.rejoin for t in opt.trace_offsets):
                print(
                    f"TRACE assembly anchor={a.anchor} rejoin={a.rejoin} "
                    f"support={a.support} ref_support={a.ref_support} "
                    f"alt={dna.codes_to_seq(np.asarray(a.seq, np.uint8))}"
                )
    if out_assemblies is not None:
        out_assemblies.extend(all_asms)
    stage_s["score"] = stage_s.get("score", 0.0) + (time.time() - _t)
    _t = time.time()
    all_records.extend(extract_variants(all_asms, ref, reference, opt))
    stage_s["extract"] = stage_s.get("extract", 0.0) + (time.time() - _t)
    # genotype from support vs local ref coverage
    return _dedup_records(all_records)


def _rc_assembly(a: Assembly, G: int) -> Assembly:
    """Map an assembly traced in reverse-complement coordinates back to the
    forward strand: the bubble (anchor, rejoin) flips end-for-end and the alt
    path reverse-complements."""
    return Assembly(
        chunk_start=G - 1 - a.chunk_start,
        anchor=G - 1 - a.rejoin,
        rejoin=G - 1 - a.anchor,
        seq=(3 - np.asarray(a.seq, np.uint8))[::-1].copy(),
        support=a.support,
        ref_support=a.ref_support,
    )


def _ref_pair_spans(rm: Readmap, ref: np.ndarray, max_frag: int):
    """Proper-pair spans [a, b) + half-placed mate positions on the
    reference, computed ONCE per readmap and cached on the instance.

    A proper pair = both mates placed, opposite strands, |distance| <=
    max_frag (pair_cov.cpp semantics).  Half-placed pairs (one mate on the
    novel path of an insertion never places) are kept as single positions —
    generous evidence for the gate, which only culls paths with NOTHING."""
    key = ("_ref_pair_spans", max_frag)
    hit = rm.__dict__.get(key)
    if hit is not None:
        return hit
    from biograph_jax.variants.align import RefKmerIndex, place_reads

    loop = np.asarray(rm.mate_pair_ptr)
    fwd_ids = np.nonzero(np.asarray(rm.is_forward))[0]
    mate2 = loop[loop]
    entries = rm.entry_of_rm[fwd_ids]
    lens = np.asarray(rm.read_lengths)[fwd_ids]
    L = int(lens.max(initial=1))
    codes = np.zeros((len(fwd_ids), L), np.uint8)
    ss = rm.seqset
    for lo in range(0, len(fwd_ids), 1 << 14):
        hi = min(len(fwd_ids), lo + (1 << 14))
        codes[lo:hi] = np.asarray(
            ss.d.sequences(jnp.asarray(entries[lo:hi]), L)
        )
    codes = np.where(
        np.arange(L)[None, :] < lens[:, None], codes, 0
    ).astype(np.uint8)
    idx = RefKmerIndex.build(ref, 13)
    pl = place_reads(idx, codes, lens, max_mismatches=3)
    pos_of_fwd = np.full(rm.num_entries, -1, np.int64)
    pos_of_fwd[fwd_ids] = np.arange(len(fwd_ids))
    mate_idx = pos_of_fwd[mate2[fwd_ids]]
    mclip = np.clip(mate_idx, 0, len(fwd_ids) - 1)
    placed = pl.pos >= 0
    paired = (mate_idx != np.arange(len(fwd_ids))) & (mate_idx >= 0)
    both = placed & paired & placed[mclip]
    proper = (
        both
        & (np.abs(pl.pos - pl.pos[mclip]) <= max_frag)
        & (pl.is_rc != pl.is_rc[mclip])
    )
    a = np.minimum(pl.pos, pl.pos[mclip])[proper]
    b = np.maximum(pl.pos + lens, pl.pos[mclip] + lens)[proper]
    half = paired & (placed ^ placed[mclip])
    half_pos = np.where(placed, pl.pos, pl.pos[mclip])[half]
    half_len = np.where(placed, lens, lens[mclip])[half]
    order = np.argsort(a)
    spans = (a[order], b[order], np.sort(half_pos + half_len // 2))
    rm.__dict__[key] = spans
    return spans


def pair_gate_assemblies(rm: Readmap, ref: np.ndarray, asms: List[Assembly],
                         opt: DiscoverOptions, stats: dict | None = None):
    """The tracer's pair-evidence discard (tracer.cpp:602: a path that
    extends past max_bases_between_pairs without pair support is dropped),
    applied at assembly acceptance: alt paths longer than the threshold
    must show min_pair_evidence proper pairs straddling the bubble (or
    half-placed mates within max_pair_distance of it).  Vacuous when the
    library is unpaired — the reference's counter never trips there
    either."""
    if not opt.pair_gate or not asms:
        return asms
    if int(np.asarray(rm.mate_pair_ptr).size) == 0 or (
        rm.get_pair_stats()["paired_reads"] == 0
    ):
        return asms
    long_asms = [
        a for a in asms if len(a.seq) > opt.max_bases_between_pairs
    ]
    if not long_asms:
        return asms
    a_s, b_s, half_mid = _ref_pair_spans(rm, ref, opt.max_pair_distance)
    kept = []
    gated = 0
    for a in asms:
        if len(a.seq) <= opt.max_bases_between_pairs:
            kept.append(a)
            continue
        # proper pairs straddling the bubble: a <= anchor and b >= rejoin
        i = np.searchsorted(a_s, a.anchor + 1, side="right")
        straddle = int((b_s[:i] >= a.rejoin).sum())
        # half-placed mates near the bubble (novel-insertion evidence)
        lo = np.searchsorted(half_mid, a.anchor - opt.max_pair_distance)
        hi = np.searchsorted(half_mid, a.rejoin + opt.max_pair_distance)
        if straddle + int(hi - lo) >= opt.min_pair_evidence:
            kept.append(a)
        else:
            gated += 1
    if stats is not None:
        stats["pair_gated"] = stats.get("pair_gated", 0) + gated
    return kept


def score_assemblies(rm: Readmap, ref: np.ndarray, asms: List[Assembly], opt: DiscoverOptions):
    """Replace range-width support with true read coverage of the alt path
    (analog of calc_coverage / read_cov, modules/variants/calc_coverage.h:16,
    read_cov.cpp): each assembly's alt sequence plus flanking context is run
    through readmap.coverage; support = min depth across the bubble.  The
    matching REFERENCE span is scored the same way (ref_support), so the
    genotyper can weigh alt vs ref evidence instead of hardcoding hom-alt.

    Assemblies are bucketed by bubble size first: the coverage scan's cost is
    the padded window length, and one 400 bp event must not make every SNP
    bubble pay a 400-step scan."""
    if not asms:
        return asms
    buckets: dict = {}
    cap = 2 * MID_CAP  # giant ref spans are scored as breakpoint windows
    for a in asms:
        span = max(len(a.seq), min(a.rejoin - a.anchor - 1, cap))
        b = 64
        while b < span:
            b *= 2
        buckets.setdefault(b, []).append(a)
    if len(buckets) > 1 and backend() == "gpu":
        # GPU: ONE padded batch instead of per-bucket calls — every extra
        # coverage call costs launches plus a result fetch, where the padded
        # positions cost little device time.  Not yet measured on the card.
        return _score_batch(rm, ref, asms, opt)
    if len(buckets) > 1:
        for group in buckets.values():
            _score_batch(rm, ref, group, opt)
        return asms
    return _score_batch(rm, ref, asms, opt)


MID_CAP = 192  # ref-span scoring cap for giant deletions (bases per side)


def _score_batch(rm: Readmap, ref: np.ndarray, asms: List[Assembly], opt: DiscoverOptions):
    # Flanks must cover a full read length: the coverage walk only counts a
    # read once its END position is reached with enough context, so the
    # first/last read_len positions of any window undercount.
    C = int(rm.max_read_len) + 2

    # Row plan: every assembly gets an alt row; the ref allele gets one row
    # unless the span is giant (a long deletion whose rejoin k-mer landed far
    # downstream), in which case the two breakpoint-adjacent windows are
    # scored as separate rows — the interior of a 100 kb candidate deletion
    # must not cost a 100 kb coverage row, and ref evidence for a deletion
    # lives at its breakpoints anyway (read_cov scores events at their
    # boundaries too, modules/variants/read_cov.cpp).
    rows = []  # (asm_idx, kind, seq, lo, hi); kind: 0=alt, 1=ref, 2=ref-part
    for i, a in enumerate(asms):
        left = ref[max(a.anchor + 1 - C, 0) : a.anchor + 1]
        right = ref[a.rejoin : a.rejoin + C]
        alt = np.asarray(a.seq, np.uint8)
        seq = np.concatenate([left, alt, right])
        rows.append(
            (i, 0, seq, max(len(left) - 1, 0), min(len(left) + len(alt) + 1, len(seq)))
        )
        mid = ref[a.anchor + 1 : a.rejoin]
        if len(mid) <= 2 * MID_CAP:
            seq = np.concatenate([left, mid, right])
            rows.append(
                (i, 1, seq, max(len(left) - 1, 0), min(len(left) + len(mid) + 1, len(seq)))
            )
        else:
            # left breakpoint: flank + first MID_CAP+C span bases; window
            # stops C short of the cut so truncated-context positions (which
            # undercount) stay out of the min
            lseq = np.concatenate([left, mid[: MID_CAP + C]])
            rows.append((i, 2, lseq, max(len(left) - 1, 0), len(left) + MID_CAP))
            rseq = np.concatenate([mid[-(MID_CAP + C) :], right])
            rows.append((i, 2, rseq, MID_CAP + C, len(rseq)))
    qlen = max(max(len(r[2]) for r in rows), 2 * C + 1)
    B = len(rows)
    q = np.zeros((B, qlen), np.uint8)
    ql = np.zeros(B, np.int32)
    for r, (_, _, seq, _, _) in enumerate(rows):
        q[r, : len(seq)] = seq
        ql[r] = len(seq)
    import jax.numpy as jnp

    kmax = opt.read_cov_max_reads_per_entry or 16
    fwd, rev = rm.coverage(jnp.asarray(q), jnp.asarray(ql), kmax=kmax)
    fwd = np.asarray(fwd)
    rev = np.asarray(rev)
    tot = fwd + rev
    if opt.penalize_directional_coverage:
        # discount heavily one-sided depth (calc_coverage.cpp:10-17: if
        # |fwd-rev| * 4 > 3 * (fwd+rev), depth = 2 * min(fwd, rev)) — one
        # direction dominating is the signature of systematic read errors
        skew = np.abs(fwd - rev) * 4 > tot * 3
        tot = np.where(skew, 2 * np.minimum(fwd, rev), tot)
    ref_mins: dict = {}
    for r, (i, kind, seq, lo, hi) in enumerate(rows):
        win = tot[r, lo:hi]
        v = int(win.min()) if len(win) else 0
        if kind == 0:
            asms[i].support = v
        else:
            ref_mins[i] = min(ref_mins.get(i, 1 << 30), v)
    for i, a in enumerate(asms):
        a.ref_support = ref_mins.get(i, 0)
    return asms


def _dedup_records(records):
    seen = {}
    for r in records:
        key = (r["chrom"], r["pos"], r["ref"], r["alt"])
        if key not in seen or seen[key]["support"] < r["support"]:
            seen[key] = r
    return sorted(seen.values(), key=lambda r: (r["chrom"], r["pos"]))


def write_discovery_vcf(path: str, reference, records, sample="SAMPLE", opt=None):
    """Emit discovery records as VCF (ploidless_vcf_export analog).

    Genotypes come from the binomial genotyper over alt vs ref bubble
    coverage (simple_genotype_filter analog, modules/variants/
    simple_genotype_filter.h) — not a hardcoded ploidy."""
    from biograph_jax.io.vcf import VcfRecord, VcfWriter

    opt = opt or DiscoverOptions()
    headers = [
        '##INFO=<ID=SUP,Number=1,Type=Integer,Description="Min read support along assembly">',
        '##INFO=<ID=RSUP,Number=1,Type=Integer,Description="Min read support along the reference span">',
        '##INFO=<ID=PAIRS,Number=1,Type=Integer,Description="Mate pairs straddling the event">',
        '##INFO=<ID=AID,Number=1,Type=Integer,Description="Assembly id">',
        '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Length difference alt-ref">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Structural variant type">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">',
    ]
    with VcfWriter(
        path,
        sample=sample,
        contigs=[(c.name, c.length) for c in reference.contigs],
        extra_headers=headers,
    ) as w:
        for r in records:
            if r["support"] < opt.min_alt_support:
                continue
            alt_d = int(r["support"])
            ref_d = int(r.get("ref_support", 0))
            if opt.simple_genotype_filter:
                # simple_genotype_filter.cpp:91-140 — depth floors, then the
                # alt-depth-portion gate against total local depth
                if alt_d < opt.min_read_depth:
                    continue
                if int(r.get("pair_support", opt.min_pair_depth)) < opt.min_pair_depth:
                    continue
                total_d = alt_d + ref_d
                if total_d and alt_d / total_d < opt.min_depth_portion:
                    continue
            frac = alt_d / max(alt_d + ref_d, 1)
            gt = "1/1" if frac >= opt.hom_frac else "0/1"
            info = {"SUP": alt_d, "RSUP": ref_d}
            if "pair_support" in r:
                info["PAIRS"] = int(r["pair_support"])
            if opt.output_assembly_ids and "aid" in r:
                info["AID"] = int(r["aid"])
            svlen = len(r["alt"]) - len(r["ref"])
            if abs(svlen) >= opt.vcf_sv_size_threshold:
                info["SVLEN"] = svlen
                info["SVTYPE"] = "INS" if svlen > 0 else "DEL"
            w.write(
                VcfRecord(
                    chrom=r["chrom"],
                    pos=r["pos"],
                    ref=r["ref"],
                    alt=r["alt"],
                    qual=3 * alt_d + 27,
                    info=info,
                    fmt={"GT": gt, "DP": alt_d + ref_d},
                )
            )


def write_assembly_csv(path: str, reference, assemblies: List[Assembly]):
    """Assembly dump CSV (analog of DiscoveryMain::write_csv_assembly,
    modules/biograph/biograph_variants.cpp:546-565): one row per scored
    assembly with its bubble coordinates, support, and both sequences."""
    ref = np.asarray(reference.flat)
    with open(path, "w") as f:
        f.write(
            "scaffold_name,left_offset,right_offset,aid,score,ref_support,"
            "ref_seq,seq,generated_by\n"
        )
        for aid, a in enumerate(assemblies):
            c = _contig_of(reference, a.anchor)
            if c is None:
                continue
            f.write(
                f"{c.name},{a.anchor - c.start},{a.rejoin - c.start},{aid},"
                f"{a.support},{a.ref_support},"
                f"{dna.codes_to_seq(ref[a.anchor + 1 : a.rejoin])},"
                f"{dna.codes_to_seq(np.asarray(a.seq, np.uint8))},WAVEFRONT\n"
            )
    return len(assemblies)


def extract_variants(assemblies: List[Assembly], ref: np.ndarray, reference, opt: DiscoverOptions):
    """Assemblies -> normalized variant records (chrom, pos, ref, alt, support).

    Prefix/suffix trimming handles SNPs and clean indels; remaining block
    substitutions are emitted verbatim (analog of the aligner + normalizer
    steps, modules/variants/align.h:8, normalize.h:7)."""
    out = []
    trimmed = []  # (asm, pos_flat, rs, as_)
    complex_ids = []
    aid_of = {id(a): i for i, a in enumerate(assemblies)}
    for asm in assemblies:
        a, j = asm.anchor, asm.rejoin
        ref_seg = ref[a + 1 : j]
        alt_seg = np.asarray(asm.seq, np.uint8)
        # trim common prefix/suffix (vectorized: one compare + argmax each)
        m = min(len(ref_seg), len(alt_seg))
        neq = ref_seg[:m] != alt_seg[:m]
        p = int(np.argmax(neq)) if neq.any() else m
        rs, as_ = ref_seg[p:], alt_seg[p:]
        m2 = min(len(rs), len(as_))
        neq2 = rs[len(rs) - m2 :][::-1] != as_[len(as_) - m2 :][::-1]
        q = int(np.argmax(neq2)) if neq2.any() else m2
        rs = rs[: len(rs) - q]
        as_ = as_[: len(as_) - q]
        pos_flat = a + 1 + p  # first differing base (flat, 0-based)
        if len(rs) == 0 and len(as_) == 0:
            continue  # identical to reference
        idx = len(trimmed)
        trimmed.append((asm, pos_flat, rs, as_))
        if (
            len(rs) != len(as_)
            and min(len(rs), len(as_)) > 0
            and (len(rs) > 2 or len(as_) > 2)
            # giant blocks (repeat-mediated distant rejoins) skip base-level
            # decomposition — emitted as one left-normalized block record
            and max(len(rs), len(as_)) <= 2048
        ):
            complex_ids.append(idx)
    # batch-align all complex blocks on device (aligner step,
    # modules/variants/align.h:8; ops/align_dp.py)
    from biograph_jax.ops.align_dp import align_blocks_batch

    ops_by_id = {}
    if complex_ids:
        all_ops = align_blocks_batch(
            [trimmed[i][2] for i in complex_ids],
            [trimmed[i][3] for i in complex_ids],
        )
        ops_by_id = dict(zip(complex_ids, all_ops))
    for idx, (asm, pos_flat, rs, as_) in enumerate(trimmed):
        pieces = []
        if len(rs) == len(as_):
            # same-length block: split into primitive SNPs at mismatches
            # (align_splitter analog, modules/variants/align.h:74)
            for i in np.nonzero(np.asarray(rs) != np.asarray(as_))[0]:
                pieces.append(
                    (
                        pos_flat + int(i),
                        dna.codes_to_seq(rs[i : i + 1]),
                        dna.codes_to_seq(as_[i : i + 1]),
                    )
                )
        elif idx in ops_by_id:
            pieces.extend(
                _align_decompose(ref, pos_flat, rs, as_, ops=ops_by_id[idx])
            )
        else:
            # clean indel / tiny block: left-anchor + left-shift
            pieces.append(_left_normalize(ref, pos_flat, rs, as_))
        for vpos, ref_str, alt_str in pieces:
            contig = _contig_of(reference, vpos)
            if contig is None:
                continue
            out.append(
                {
                    "chrom": contig.name,
                    "pos": vpos - contig.start + 1,
                    "ref": ref_str,
                    "alt": alt_str,
                    "support": asm.support,
                    "ref_support": asm.ref_support,
                    "aid": aid_of[id(asm)],
                }
            )
    # dedup identical records, keep max support (exact_dedup analog)
    seen = {}
    for r in out:
        key = (r["chrom"], r["pos"], r["ref"], r["alt"])
        if key not in seen or seen[key]["support"] < r["support"]:
            seen[key] = r
    return sorted(seen.values(), key=lambda r: (r["chrom"], r["pos"]))


def _align_decompose(ref, pos_flat, rs, as_, ops=None):
    """Global alignment (affine-ish) of ref block vs alt block; emit
    primitive SNP / indel pieces.  With ops precomputed (the batched device
    aligner, ops/align_dp.py), only grouping runs here; the scalar NW below
    is the fallback for direct calls."""
    if ops is not None:
        return _ops_to_pieces(ref, pos_flat, rs, as_, ops)
    n, m = len(rs), len(as_)
    GAP_OPEN, GAP_EXT, MIS = 2.5, 0.5, 1.0
    INF = 1e18
    # three-state affine DP (M, Ix = gap in alt/deletion, Iy = insertion)
    M = np.full((n + 1, m + 1), INF)
    Ix = np.full((n + 1, m + 1), INF)
    Iy = np.full((n + 1, m + 1), INF)
    M[0, 0] = 0.0
    for i in range(1, n + 1):
        Ix[i, 0] = GAP_OPEN + GAP_EXT * (i - 1)
    for j in range(1, m + 1):
        Iy[0, j] = GAP_OPEN + GAP_EXT * (j - 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = 0.0 if rs[i - 1] == as_[j - 1] else MIS
            M[i, j] = sub + min(M[i - 1, j - 1], Ix[i - 1, j - 1], Iy[i - 1, j - 1])
            Ix[i, j] = min(M[i - 1, j] + GAP_OPEN, Ix[i - 1, j] + GAP_EXT)
            Iy[i, j] = min(M[i, j - 1] + GAP_OPEN, Iy[i, j - 1] + GAP_EXT)
    # traceback
    i, j = n, m
    state = int(np.argmin([M[i, j], Ix[i, j], Iy[i, j]]))
    ops = []  # (op, ref_idx, alt_idx): 'M' match/mismatch, 'D' del, 'I' ins
    while i > 0 or j > 0:
        if state == 0:
            i, j = i - 1, j - 1
            ops.append(("M", i, j))
            state = int(np.argmin([M[i, j], Ix[i, j], Iy[i, j]])) if (i or j) else 0
        elif state == 1:
            prevM = M[i - 1, j] + GAP_OPEN
            prevX = Ix[i - 1, j] + GAP_EXT
            i -= 1
            ops.append(("D", i, j))
            state = 0 if prevM <= prevX else 1
        else:
            prevM = M[i, j - 1] + GAP_OPEN
            prevY = Iy[i, j - 1] + GAP_EXT
            j -= 1
            ops.append(("I", i, j))
            state = 0 if prevM <= prevY else 2
    ops.reverse()
    return _ops_to_pieces(ref, pos_flat, rs, as_, ops)


def _ops_to_pieces(ref, pos_flat, rs, as_, ops):
    """Group alignment ops into primitive SNP / indel pieces."""
    # group into variant pieces
    pieces = []
    run = None  # (kind, ref_lo, ref_hi, alt_lo, alt_hi)
    for op, ri, aj in ops:
        if op == "M":
            if run is not None:
                pieces.append(run)
                run = None
            if rs[ri] != as_[aj]:
                pieces.append(("S", ri, ri + 1, aj, aj + 1))
        else:
            kind = op
            if run is not None and run[0] == kind:
                run = (kind, run[1], max(run[2], ri + (op == "D")), run[3], max(run[4], aj + (op == "I")))
            else:
                if run is not None:
                    pieces.append(run)
                lo_r, hi_r = (ri, ri + 1) if op == "D" else (ri, ri)
                lo_a, hi_a = (aj, aj + 1) if op == "I" else (aj, aj)
                run = (kind, lo_r, hi_r, lo_a, hi_a)
    if run is not None:
        pieces.append(run)
    out = []
    for kind, rlo, rhi, alo, ahi in pieces:
        if kind == "S":
            out.append(
                (
                    pos_flat + rlo,
                    dna.codes_to_seq(rs[rlo:rhi]),
                    dna.codes_to_seq(as_[alo:ahi]),
                )
            )
        else:
            out.append(
                _left_normalize(ref, pos_flat + rlo, rs[rlo:rhi], as_[alo:ahi])
            )
    return out


def _left_normalize(ref, pos, rs, as_):
    """VCF-style left alignment of an indel/block at flat position pos.

    For a pure indel the step-by-step rule (shift while the base before
    equals the arm's last base, rotating the arm) is equivalent to: shift by
    the longest s with ref[pos-1-i] == arm[(L-1-i) mod L] for all i < s —
    computed as one vectorized comparison instead of a Python loop that
    rebuilt the arm per step (O(shift*L) lists; pathological on long
    deletions)."""
    rs = np.asarray(rs, np.uint8)
    as_ = np.asarray(as_, np.uint8)
    arm = as_ if len(rs) == 0 else (rs if len(as_) == 0 else None)
    if arm is not None and len(arm) and pos > 0:
        L = len(arm)
        # block-wise scan: compare 4096 positions at a time so the common
        # case (shift of a few bases) costs O(block), not O(pos)
        s = 0
        B = 4096
        while s < pos:
            n = min(B, pos - s)
            i = np.arange(s, s + n)
            neq = ref[pos - 1 - i] != arm[(L - 1 - i) % L]
            if neq.any():
                s += int(np.argmax(neq))
                break
            s += n
        if s:
            arm = np.roll(arm, s % L)
            pos -= s
            if len(rs):
                rs = arm
            else:
                as_ = arm
    anchor_base = ref[pos - 1] if pos > 0 else ref[pos]
    ref_str = dna.codes_to_seq(np.concatenate([[anchor_base], rs]).astype(np.uint8))
    alt_str = dna.codes_to_seq(np.concatenate([[anchor_base], as_]).astype(np.uint8))
    return pos - 1, ref_str, alt_str


def _contig_of(reference, flat_pos):
    for c in reference.contigs:
        if c.start <= flat_pos < c.start + c.length:
            return c
    return None
