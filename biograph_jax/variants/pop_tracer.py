"""Pair/split-evidence structural-variant discovery (pop_tracer analog).

The reference discovers events larger than the push tracer's path cap with
the pop tracer (modules/variants/pop_tracer.h:8, algorithm steps at
pop_tracer.h:34-60): it collects reference + mate-candidate seqset entries in
a window, chains pops whose prefixes match, and scores chains with mate-pair
support (modules/variants/pair_cov.cpp place_pair_cov / pair_edge_cov).

The batched reformulation turns the pointer-chasing chain walk into two
batched passes over *reads that failed whole-read placement*:

  1. **split placement** — every k-mer of every unplaced read is looked up in
     the reference k-mer table at once; per read the dominant *prefix
     diagonal* and *suffix diagonal* are voted out of the hit matrix (one
     sort, no per-read walk).  A read whose prefix lands at diagonal d_pre
     and suffix at d_suf != d_pre spans a breakpoint:
       d_suf > d_pre  ->  deletion of (d_suf - d_pre) bases
       d_suf < d_pre  ->  insertion of (d_pre - d_suf) bases (novel sequence
                          taken from the read between the two runs)
     Exact breakpoints come from vectorized prefix/suffix match runs against
     the reference; micro-homology resolves to the leftmost breakpoint.
  2. **clustering + pair evidence** — candidates agreeing on (left, right,
     inserted) merge; events need min_sv_reads split reads, and mate pairs
     straddling the junction in proper orientation with a plausible implied
     fragment add pair support (pair_cov analog).

Event size is bounded only by the reference length — this is the engine that
lifts the wavefront's max_path cap (the reference's flagship 49 kb deletion,
modules/variants/hg002_test.cpp:23, is a split+pair call of exactly this
shape).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from biograph_jax.core import dna
from biograph_jax.variants.align import RefKmerIndex, Placements, place_reads


@dataclass
class SvOptions:
    """Knobs for the pair/split SV engine (assemble_options pair/pop subset,
    modules/variants/assemble.h:475 pop_trace_* fields)."""

    k: int = 16  # seed k-mer size for split placement
    min_run: int = 20  # min exact prefix/suffix anchor run (bases)
    min_sv_reads: int = 3  # split reads required per event
    min_event: int = 50  # smaller events belong to the wavefront engine
    max_frag: int = 1000  # max mate-pair fragment for pair support
    max_hits: int = 4  # reference hits considered per seed k-mer
    cluster_pad: int = 8  # breakpoint jitter merged into one event
    max_reads_batch: int = 1 << 14


@dataclass
class SvEvent:
    """A clustered breakpoint event."""

    left: int  # flat ref position after the last prefix-matched base
    right: int  # flat ref position of the first suffix-matched base
    ins: np.ndarray  # inserted bases between the anchors (uint8 codes)
    support: int  # split reads
    pair_support: int = 0  # straddling proper pairs

    @property
    def del_len(self) -> int:
        return self.right - self.left

    @property
    def ins_len(self) -> int:
        return len(self.ins)


def reads_from_readmap(rm, batch: int = 1 << 14, read_slice: tuple | None = None):
    """Reconstruct forward-oriented reads (+ mate links) from a readmap.

    Returns (codes [R, L], lengths [R], mate_of [R] | None) where mate_of[i]
    is the index of read i's mate in the same arrays (self if unpaired) —
    the data the reference pop tracer pulls through readmap mate loops
    (modules/bio_base/readmap.h:216-236).

    `read_slice=(lo, hi)` densifies codes only for forward reads [lo, hi)
    (codes has hi-lo rows) while lengths/mate_of stay GLOBAL over all R
    forward reads — the shard contract for distributed SV discovery, where
    each process materializes only its slice but pair evidence needs global
    placements."""
    loop = np.asarray(rm.mate_pair_ptr)
    fwd_ids = np.nonzero(np.asarray(rm.is_forward))[0]
    lens = np.asarray(rm.read_lengths)[fwd_ids]
    L = int(lens.max(initial=1))
    lo0, hi0 = read_slice if read_slice is not None else (0, len(fwd_ids))
    sel = fwd_ids[lo0:hi0]
    entries = rm.entry_of_rm[sel]
    codes = np.zeros((len(sel), L), np.uint8)
    ss = rm.seqset
    for lo in range(0, len(sel), batch):
        hi = min(len(sel), lo + batch)
        codes[lo:hi] = np.asarray(ss.d.sequences(jnp.asarray(entries[lo:hi]), L))
    codes = np.where(
        np.arange(L)[None, :] < lens[lo0:hi0, None], codes, 0
    ).astype(np.uint8)
    mate2 = loop[loop]  # fwd -> rc -> mate-fwd
    pos_of_fwd = np.full(rm.num_entries, -1, np.int64)
    pos_of_fwd[fwd_ids] = np.arange(len(fwd_ids))
    mate_of = pos_of_fwd[mate2[fwd_ids]]
    mate_of = np.where(mate_of >= 0, mate_of, np.arange(len(fwd_ids)))
    if (mate_of == np.arange(len(fwd_ids))).all():
        mate_of = None
    return codes, lens, mate_of


def _match_run_fwd(reads: np.ndarray, lens: np.ndarray, ref: np.ndarray, starts: np.ndarray):
    """Per read: length of the exact match run read[0:p] == ref[start:start+p]."""
    R, L = reads.shape
    G = len(ref)
    idx = starts[:, None] + np.arange(L)[None, :]
    ok = (idx >= 0) & (idx < G)
    refw = ref[np.clip(idx, 0, G - 1)]
    eq = ok & (refw == reads) & (np.arange(L)[None, :] < lens[:, None])
    # first mismatch position = run length
    return np.where(eq.all(axis=1), lens, eq.argmin(axis=1)).astype(np.int64)


def _match_run_bwd(reads: np.ndarray, lens: np.ndarray, ref: np.ndarray, diag: np.ndarray):
    """Per read: smallest s with read[s:len] == ref[diag+s : diag+len]."""
    R, L = reads.shape
    G = len(ref)
    j = np.arange(L)[None, :]
    idx = diag[:, None] + j
    ok = (idx >= 0) & (idx < G)
    refw = ref[np.clip(idx, 0, G - 1)]
    eq = ok & (refw == reads) & (j < lens[:, None])
    # positions beyond the read length count as matched (don't break the run)
    eqp = eq | (j >= lens[:, None])
    # run of matches ending at len-1: s = 1 + last mismatch index, or 0
    mism = ~eqp
    any_m = mism.any(axis=1)
    last_m = (L - 1) - mism[:, ::-1].argmax(axis=1)
    return np.where(any_m, last_m + 1, 0).astype(np.int64)


def split_place(
    index: RefKmerIndex,
    reads: np.ndarray,
    lens: np.ndarray,
    opt: SvOptions,
):
    """Split placement of reads: per read the best (prefix diag, suffix diag).

    Returns dict of arrays over reads: d_pre, d_suf, p (prefix run), s
    (suffix run start), valid."""
    R, L = reads.shape
    k = index.k
    if R == 0 or L < k:
        z = np.zeros(0, np.int64)
        return dict(d_pre=z, d_suf=z, p=z, s=z, valid=np.zeros(0, bool))
    km, kvalid = dna.kmers_from_codes(
        jnp.asarray(reads), jnp.asarray(lens, jnp.int32), k
    )
    if index.kmers.dtype == jnp.uint32:
        km = km.astype(jnp.uint32)
    pos, hit = index.lookup(km, opt.max_hits)  # [R, nwin, H]
    pos = np.asarray(pos, np.int64)
    hit = np.asarray(hit) & np.asarray(kvalid)[:, :, None]
    nwin = pos.shape[1]
    offs = np.arange(nwin)[None, :, None]
    diag = np.where(hit, pos - offs, np.int64(-(1 << 62)))

    # vote the dominant diagonal among early-offset hits (prefix) and
    # late-offset hits (suffix): mode via sorting each read's candidates
    third = np.maximum(lens // 3, k)[:, None, None]
    pre_hit = hit & (offs < third)
    suf_hit = hit & (offs >= np.maximum(lens[:, None, None] - k + 1 - third, 0))

    def mode_diag(mask):
        d = np.where(mask, diag, np.int64(1 << 62))
        ds = np.sort(d.reshape(R, -1), axis=1)
        # longest run of equal values (excluding sentinel)
        runs = np.zeros(R, np.int64)
        best = np.full(R, np.int64(1 << 62))
        cur = np.ones(R, np.int64)
        for j in range(1, ds.shape[1]):
            same = (ds[:, j] == ds[:, j - 1]) & (ds[:, j] != (1 << 62))
            cur = np.where(same, cur + 1, 1)
            better = (cur > runs) & (ds[:, j] != (1 << 62))
            best = np.where(better, ds[:, j], best)
            runs = np.where(better, cur, runs)
        first_ok = (ds[:, 0] != (1 << 62)) & (runs == 0)
        best = np.where(first_ok, ds[:, 0], best)
        runs = np.maximum(runs, (ds[:, 0] != (1 << 62)).astype(np.int64))
        return best, runs

    d_pre, n_pre = mode_diag(pre_hit)
    d_suf, n_suf = mode_diag(suf_hit)
    have_pre = d_pre != (1 << 62)
    have_suf = d_suf != (1 << 62)
    d_pre = np.where(have_pre, d_pre, 0)
    d_suf = np.where(have_suf, d_suf, 0)
    p = _match_run_fwd(reads, lens, np.asarray(index.ref_codes), d_pre)
    s = _match_run_bwd(reads, lens, np.asarray(index.ref_codes), d_suf)
    valid = (
        have_pre
        & have_suf
        & (p >= opt.min_run)
        & (lens - s >= opt.min_run)
        & (d_pre != d_suf)
        & (d_pre >= 0)
        & (d_suf >= 0)
    )
    return dict(
        d_pre=d_pre, d_suf=d_suf, p=p, s=s, valid=valid,
        have_pre=have_pre & (d_pre >= 0), have_suf=have_suf & (d_suf >= 0),
    )


def _events_from_split(sp, reads, lens, opt: SvOptions) -> List[Tuple[int, int, bytes, int]]:
    """(left, right, ins_codes) per supporting read, micro-homology resolved
    to the leftmost breakpoint."""
    out = []
    idx = np.nonzero(sp["valid"])[0]
    for i in idx:
        d_pre, d_suf = int(sp["d_pre"][i]), int(sp["d_suf"][i])
        p, s = int(sp["p"][i]), int(sp["s"][i])
        # homology at the junction can pull the suffix run left past the
        # prefix run (s < p) or pull right below left; resolve by pinning the
        # junction at the end of the prefix run and shifting the suffix run
        # right by the overlap (the shifted bases match ref by construction)
        s = max(s, p)
        left = d_pre + p
        right = d_suf + s
        if right < left:
            delta = left - right
            s += delta
            right += delta
            if s > int(lens[i]):
                continue
        ins = reads[i, p:s].tobytes()
        if right - left == len(ins) == 0:
            continue
        if (right - left) < opt.min_event and len(ins) < opt.min_event:
            continue
        out.append((left, right, ins, int(i)))
    return out


def _kmer_edge_table(reads: np.ndarray, lens: np.ndarray, k: int):
    """Sorted (kmer<<2 | next_base) edge keys + counts over all reads — the
    chaining structure the reference builds by popping seqset entry fronts
    (pop_tracer.h:34-60 'join prefix-matching entries'), here as one
    vectorized unique over every read k-mer edge."""
    km, valid = dna.kmers_from_codes(reads, lens, k)
    R, W = km.shape
    if W <= 1:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    nb = reads[:, k:].astype(np.uint64)  # next base after each window
    has_next = valid[:, :-1] & (np.arange(W - 1)[None, :] + k < lens[:, None])
    keys = (km[:, :-1] << np.uint64(2)) | nb
    flat = keys[has_next]
    uk, counts = np.unique(flat, return_counts=True)
    return uk, counts.astype(np.int64)


def _assemble_breakend(
    seed_tails: List[np.ndarray],
    edge_keys: np.ndarray,
    edge_counts: np.ndarray,
    index: RefKmerIndex,
    left: int,
    opt: SvOptions,
    max_assembly: int = 20000,
    confirm: int = 16,
):
    """Extend the novel sequence hanging off a left breakend through the
    read k-mer graph until it re-anchors on the reference.

    Returns (ins_codes, right) or None.  The walk picks the heaviest
    outgoing edge each step (greedy unitig walk = the batched analog of
    chaining pops); an anchor candidate (current k-mer present in the
    reference) is accepted once `confirm` subsequent walked bases match the
    reference right flank."""
    k = index.k
    mask = np.uint64((1 << (2 * k)) - 1)
    # consensus of the first k novel bases across the cluster's tails
    L0 = max(len(t) for t in seed_tails)
    if L0 < k:
        return None
    mat = np.full((len(seed_tails), L0), -1, np.int8)
    for i, t in enumerate(seed_tails):
        mat[i, : len(t)] = t
    seed = []
    for j in range(k):
        col = mat[:, j]
        col = col[col >= 0]
        if len(col) == 0:
            return None
        seed.append(np.bincount(col, minlength=4).argmax())
    cur = np.uint64(0)
    for b in seed:
        cur = ((cur << np.uint64(2)) | np.uint64(b)) & mask
    assembled = list(seed)
    ref = np.asarray(index.ref_codes)
    G = len(ref)
    pending = None  # (t_idx, q) anchor awaiting confirmation

    def ref_hit(kmer):
        pos, hit = index.lookup(jnp.asarray([kmer], jnp.uint64 if index.kmers.dtype != jnp.uint32 else jnp.uint32), 2)
        pos = np.asarray(pos)[0]
        hit = np.asarray(hit)[0]
        for h in range(len(pos)):
            if hit[h]:
                return int(pos[h])
        return -1

    q0 = ref_hit(cur)
    if q0 >= 0:
        pending = (k - 1, q0)
    for step in range(max_assembly):
        # confirmation check for a pending anchor
        if pending is not None:
            t0, q = pending
            walked = len(assembled) - 1 - t0
            if walked >= confirm:
                seg = np.array(assembled[t0 + 1 : t0 + 1 + confirm], np.uint8)
                rseg = ref[q + k : q + k + confirm]
                if len(rseg) == confirm and (seg == rseg).all():
                    ins = np.array(assembled[: t0 - k + 1], np.uint8)
                    return ins, q
                pending = None
        cand = (cur << np.uint64(2)) & (mask << np.uint64(2))
        keys = cand | np.arange(4).astype(np.uint64)
        li = np.searchsorted(edge_keys, keys)
        lic = np.clip(li, 0, max(len(edge_keys) - 1, 0))
        ok = (li < len(edge_keys)) & (len(edge_keys) > 0)
        ok = ok & (edge_keys[lic] == keys)
        counts = np.where(ok, edge_counts[lic], 0)
        if counts.max(initial=0) < 2:
            break
        nb = int(counts.argmax())
        cur = ((cur << np.uint64(2)) | np.uint64(nb)) & mask
        assembled.append(nb)
        if pending is None:
            q = ref_hit(cur)
            # plausible right side only: at/after the breakend neighborhood
            if q >= 0 and q >= left - opt.cluster_pad and len(assembled) - k >= 0:
                pending = (len(assembled) - 1, q)
    # end-of-walk: a pending anchor with full remaining match also counts
    if pending is not None:
        t0, q = pending
        seg = np.array(assembled[t0 + 1 :], np.uint8)
        rseg = ref[q + k : q + k + len(seg)]
        if len(seg) >= 4 and len(rseg) == len(seg) and (seg == rseg).all():
            return np.array(assembled[: t0 - k + 1], np.uint8), q
    return None


def _seed_consensus(seed_tails: List[np.ndarray], k: int):
    """Per-column majority vote over the cluster's tails -> first-k-bases
    seed k-mer (None when no tail reaches k)."""
    L0 = max(len(t) for t in seed_tails)
    if L0 < k:
        return None
    mat = np.full((len(seed_tails), L0), -1, np.int8)
    for i, t in enumerate(seed_tails):
        mat[i, : len(t)] = t
    seed = np.uint64(0)
    mask = np.uint64((1 << (2 * k)) - 1)
    for j in range(k):
        col = mat[:, j]
        col = col[col >= 0]
        if len(col) == 0:
            return None
        b = np.bincount(col, minlength=4).argmax()
        seed = ((seed << np.uint64(2)) | np.uint64(b)) & mask
    return seed


from functools import partial as _partial


@_partial(jax.jit, static_argnums=(7, 8, 9, 10))
def _breakend_walk_jit(seeds, lefts, edge_keys, edge_counts, ref_kmers,
                       ref_pos, ref_codes, k: int, confirm: int,
                       max_assembly: int, pad: int):
    """Batched greedy unitig walk for ALL breakend clusters at once — the
    device-resident reformulation of _assemble_breakend's per-event Python
    loop (same update rules: heaviest outgoing edge with count >= 2, anchor
    on the smallest reference position of the current k-mer, accept after
    `confirm` walked bases match the reference right flank).

    Lanes: one per cluster.  Returns (path [L, CAP], nstep, pend_t0, pend_q,
    success, res_t0, res_q); end-of-walk partial-match acceptance stays on
    the host (tiny per-lane work over the fetched buffers)."""
    L = seeds.shape[0]
    CAP = max_assembly + k
    G = ref_codes.shape[0]
    E = edge_keys.shape[0]
    kmask = jnp.uint64((1 << (2 * k)) - 1)

    def ref_first_pos(cur):
        """Smallest reference position of each k-mer; -1 when absent (the
        sorted table keeps positions ascending within a k-mer run, so the
        run head IS the minimum — matching RefKmerIndex.lookup's first hit)."""
        q = cur.astype(ref_kmers.dtype)
        i = jnp.searchsorted(ref_kmers, q)
        ic = jnp.clip(i, 0, ref_kmers.shape[0] - 1)
        hit = (i < ref_kmers.shape[0]) & (ref_kmers[ic] == q)
        return jnp.where(hit, ref_pos[ic].astype(jnp.int64), -1)

    # seed the path buffer with the k seed bases
    path0 = jnp.zeros((L, CAP), jnp.uint8)
    sh = (seeds[:, None] >> (jnp.uint64(2) * (k - 1 - jnp.arange(k, dtype=jnp.uint64)))[None, :])
    path0 = path0.at[:, :k].set((sh & jnp.uint64(3)).astype(jnp.uint8))
    q0 = ref_first_pos(seeds)
    state = dict(
        cur=seeds,
        nstep=jnp.full((L,), k, jnp.int32),
        path=path0,
        pend_t0=jnp.where(q0 >= 0, k - 1, -1).astype(jnp.int32),
        pend_q=q0,
        stopped=jnp.zeros((L,), bool),
        success=jnp.zeros((L,), bool),
        res_t0=jnp.full((L,), -1, jnp.int32),
        res_q=jnp.full((L,), -1, jnp.int64),
        it=jnp.asarray(0, jnp.int32),
    )

    conf_ar = jnp.arange(confirm)

    def cond(st):
        return (st["it"] < max_assembly) & jnp.any(~st["stopped"])

    def body(st):
        act = ~st["stopped"]
        # 1) pending-anchor confirmation
        pend = st["pend_t0"] >= 0
        walked = st["nstep"] - 1 - st["pend_t0"]
        check = act & pend & (walked >= confirm)
        segi = jnp.clip(st["pend_t0"][:, None] + 1 + conf_ar[None, :], 0, CAP - 1)
        seg = jnp.take_along_axis(st["path"], segi.astype(jnp.int64), axis=1)
        refi = st["pend_q"][:, None] + k + conf_ar[None, :]
        inb = (refi >= 0) & (refi < G)
        refseg = ref_codes[jnp.clip(refi, 0, G - 1)]
        okconf = jnp.all(inb & (refseg == seg), axis=1)
        newly_ok = check & okconf
        success = st["success"] | newly_ok
        res_t0 = jnp.where(newly_ok, st["pend_t0"], st["res_t0"])
        res_q = jnp.where(newly_ok, st["pend_q"], st["res_q"])
        stopped = st["stopped"] | newly_ok
        # failed confirmation clears the pending anchor
        pend_t0 = jnp.where(check & ~okconf, -1, st["pend_t0"])
        act2 = ~stopped

        # 2) heaviest outgoing edge with support >= 2
        cand = (st["cur"] << jnp.uint64(2)) & (kmask << jnp.uint64(2))
        keys = cand[:, None] | jnp.arange(4, dtype=jnp.uint64)[None, :]
        li = jnp.searchsorted(edge_keys, keys)
        lic = jnp.clip(li, 0, max(E - 1, 0))
        ok = (li < E) & (E > 0) & (edge_keys[lic] == keys)
        counts = jnp.where(ok, edge_counts[lic], 0)
        best = jnp.argmax(counts, axis=1)
        bw = jnp.take_along_axis(counts, best[:, None], axis=1)[:, 0]
        dead_end = act2 & (bw < 2)
        stopped = stopped | dead_end
        ext = act2 & ~dead_end

        # 3) extend
        nb = best.astype(jnp.uint64)
        cur = jnp.where(
            ext, ((st["cur"] << jnp.uint64(2)) | nb) & kmask, st["cur"]
        )
        wr = jnp.clip(st["nstep"], 0, CAP - 1).astype(jnp.int64)
        old = jnp.take_along_axis(st["path"], wr[:, None], axis=1)[:, 0]
        newv = jnp.where(ext, nb.astype(jnp.uint8), old)
        path = st["path"].at[jnp.arange(L), wr].set(newv)
        nstep = jnp.where(ext, st["nstep"] + 1, st["nstep"])

        # 4) new pending anchor (plausible right side only)
        qn = ref_first_pos(cur)
        take = ext & (pend_t0 < 0) & (qn >= 0) & (qn >= lefts - pad)
        pend_t0 = jnp.where(take, nstep - 1, pend_t0)
        pend_q = jnp.where(take, qn, st["pend_q"])
        return dict(
            cur=cur, nstep=nstep, path=path, pend_t0=pend_t0, pend_q=pend_q,
            stopped=stopped, success=success, res_t0=res_t0, res_q=res_q,
            it=st["it"] + 1,
        )

    st = lax.while_loop(cond, body, state)
    return (
        st["path"], st["nstep"], st["pend_t0"], st["pend_q"],
        st["success"], st["res_t0"], st["res_q"],
    )


def _assemble_breakends_batch(
    seeds: np.ndarray,
    lefts: np.ndarray,
    edge_keys: np.ndarray,
    edge_counts: np.ndarray,
    index: RefKmerIndex,
    opt: SvOptions,
    max_assembly: int = 20000,
    confirm: int = 16,
):
    """All clusters' breakend walks as device lanes; returns per-cluster
    (ins_codes, right) | None with the same acceptance rules as the host
    oracle _assemble_breakend (tests/test_pop_tracer.py proves agreement)."""
    L = len(seeds)
    if L == 0:
        return []
    k = index.k
    Lp = 1
    while Lp < L:
        Lp *= 2
    seeds_p = np.zeros(Lp, np.uint64)
    seeds_p[:L] = seeds
    lefts_p = np.zeros(Lp, np.int64)
    lefts_p[:L] = lefts
    path, nstep, pend_t0, pend_q, success, res_t0, res_q = (
        np.asarray(x)
        for x in _breakend_walk_jit(
            jnp.asarray(seeds_p), jnp.asarray(lefts_p),
            jnp.asarray(edge_keys), jnp.asarray(edge_counts),
            index.kmers, index.positions, index.ref_codes,
            k, confirm, max_assembly, int(opt.cluster_pad),
        )
    )
    ref = np.asarray(index.ref_codes)
    G = len(ref)
    out = []
    for i in range(L):
        t0, q = -1, -1
        if success[i]:
            t0, q = int(res_t0[i]), int(res_q[i])
        elif pend_t0[i] >= 0:
            # end-of-walk: a pending anchor with full remaining match
            t0p, qp = int(pend_t0[i]), int(pend_q[i])
            seg = path[i, t0p + 1 : nstep[i]]
            rseg = ref[qp + k : qp + k + len(seg)]
            if len(seg) >= 4 and len(rseg) == len(seg) and (seg == rseg).all():
                t0, q = t0p, qp
        if t0 >= 0 and t0 - k + 1 >= 0:
            out.append((path[i, : t0 - k + 1].copy(), q))
        else:
            out.append(None)
    return out


def _left_normalize_event(ref: np.ndarray, left: int, right: int, ins: np.ndarray):
    """Shift a (del span [left,right) + inserted seq) leftwards while the base
    entering on the right equals the base leaving on the left (VCF left
    alignment over the event as a whole)."""
    ins = list(ins)
    while left > 0:
        prev = ref[left - 1]
        tail = ins[-1] if ins else (ref[right - 1] if right > left else None)
        if tail is None or tail != prev:
            break
        if ins:
            ins = [prev] + ins[:-1]
        left -= 1
        right -= 1
    return left, right, np.array(ins, np.uint8)


def _sv_scan_reads(
    index: RefKmerIndex,
    codes: np.ndarray,
    lengths: np.ndarray,
    opt: SvOptions,
    placements: Placements | None = None,
    owner_base: int = 0,
):
    """Per-read SV scan — the shardable O(reads) phase.

    Places reads (unless given), split-places the unplaced candidates in both
    orientations, and returns
      (placements, raw_events, clip_cands, edge_keys, edge_counts)
    where events/clips carry GLOBAL read ids (local index + owner_base) and
    the k-mer edge table covers this slice's unplaced reads (merge tables
    across slices with merge_edge_tables).  Disjoint read slices scanned
    separately and merged finalize to exactly the single-pass result —
    the distributed-SV contract (tests/test_pop_tracer.py)."""
    if placements is None:
        placements = place_reads(index, codes, lengths, max_mismatches=3)
    unplaced = np.nonzero(placements.pos < 0)[0]
    raw_events: List[Tuple[int, int, bytes, int]] = []
    clip_cands: List[Tuple[int, np.ndarray, int]] = []  # (left, tail, owner)
    if len(unplaced) == 0:
        return (
            placements, raw_events, clip_cands,
            np.zeros(0, np.uint64), np.zeros(0, np.int64),
        )

    # try both orientations of each unplaced read
    sub = codes[unplaced]
    sublen = lengths[unplaced]
    rc = np.asarray(dna.revcomp_codes(sub, sublen))
    reads2 = np.concatenate([sub, rc])
    lens2 = np.concatenate([sublen, sublen])
    owner = np.concatenate([unplaced, unplaced]) + owner_base

    for lo in range(0, len(reads2), opt.max_reads_batch):
        hi = min(len(reads2), lo + opt.max_reads_batch)
        sp = split_place(index, reads2[lo:hi], lens2[lo:hi], opt)
        for left, right, ins, i in _events_from_split(
            sp, reads2[lo:hi], lens2[lo:hi], opt
        ):
            raw_events.append((left, right, ins, int(owner[lo + i])))
        # one-sided left-clips: prefix anchors, tail is novel — the raw
        # material for breakend assembly of insertions longer than a read
        oneside = (
            sp["have_pre"]
            & ~sp["valid"]
            & (sp["p"] >= opt.min_run)
            & (lens2[lo:hi] - sp["p"] >= index.k + 4)
        )
        for i in np.nonzero(oneside)[0]:
            p = int(sp["p"][i])
            clip_cands.append(
                (
                    int(sp["d_pre"][i]) + p,
                    reads2[lo + i, p : lens2[lo + i]].copy(),
                    int(owner[lo + i]),
                )
            )
    edge_keys, edge_counts = _kmer_edge_table(reads2, lens2, index.k)
    return placements, raw_events, clip_cands, edge_keys, edge_counts


def merge_edge_tables(parts):
    """Merge per-slice sorted (edge_keys, edge_counts) tables by summing
    counts of equal keys."""
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    keys = np.concatenate([k for k, _ in parts])
    counts = np.concatenate([c for _, c in parts])
    uk, inv = np.unique(keys, return_inverse=True)
    out = np.zeros(len(uk), np.int64)
    np.add.at(out, inv, counts)
    return uk, out


def _sv_finalize(
    reference,
    index: RefKmerIndex,
    raw_events,
    clip_cands,
    edge_keys,
    edge_counts,
    pos_all: np.ndarray,
    rc_all: np.ndarray,
    lengths: np.ndarray,
    mate_of: np.ndarray | None,
    opt: SvOptions,
) -> List[Dict]:
    """Deterministic event clustering / breakend assembly / pair evidence /
    record emission over the (merged) scan results.  pos_all/rc_all/lengths
    are GLOBAL per-read arrays."""
    ref = np.asarray(index.ref_codes)
    # cluster: exact key after left-normalization, then merge within pad
    norm: Dict[Tuple[int, int, bytes], set] = {}
    for left, right, ins, rid in raw_events:
        ln, rn, insn = _left_normalize_event(
            ref, left, right, np.frombuffer(ins, np.uint8)
        )
        key = (int(ln), int(rn), insn.tobytes())
        norm.setdefault(key, set()).add(rid)

    # breakend assembly: cluster left-clips, then walk ALL clusters' read
    # k-mer graphs as device lanes in one batched program (the per-event
    # Python walk was host-bound at WGS unplaced-read counts)
    if clip_cands:
        # (left, owner) key: fully deterministic grouping regardless of the
        # order slices contributed candidates (single-pass vs distributed)
        clip_cands = sorted(clip_cands, key=lambda t: (t[0], t[2]))
        groups = []  # (left_c, owners, seed_kmer)
        gi = 0
        while gi < len(clip_cands):
            gj = gi + 1
            while (
                gj < len(clip_cands)
                and clip_cands[gj][0] - clip_cands[gi][0] <= opt.cluster_pad
            ):
                gj += 1
            group = clip_cands[gi:gj]
            owners = {o for _, _, o in group}
            if len(owners) >= opt.min_sv_reads:
                lefts = np.array([l for l, _, _ in group])
                left_c = int(np.bincount(lefts - lefts.min()).argmax() + lefts.min())
                tails = [t for l, t, _ in group if l == left_c] or [
                    t for _, t, _ in group
                ]
                seed = _seed_consensus(tails, index.k)
                if seed is not None:
                    groups.append((left_c, owners, seed))
            gi = gj
        if groups:
            results = _assemble_breakends_batch(
                np.array([g[2] for g in groups], np.uint64),
                np.array([g[0] for g in groups], np.int64),
                edge_keys,
                edge_counts,
                index,
                opt,
            )
            for (left_c, owners, _), res in zip(groups, results):
                if res is not None:
                    ins_codes, right_c = res
                    if 0 < left_c - right_c <= index.k + opt.cluster_pad:
                        # junction micro-homology: the walk re-anchored a few
                        # bases LEFT of the clip (ref[right_c:left_c] is
                        # claimed by both flanks).  Pin the junction at
                        # left_c; the homologous reference bases belong to
                        # the insertion:  I ++ ref[q:left] with right=left
                        # describes the same donor sequence.
                        ins_codes = np.concatenate(
                            [ins_codes, ref[right_c:left_c]]
                        ).astype(np.uint8)
                        right_c = left_c
                    if (
                        len(ins_codes) >= opt.min_event
                        or right_c - left_c >= opt.min_event
                    ) and right_c >= left_c:
                        ln, rn, insn = _left_normalize_event(
                            ref, left_c, right_c, ins_codes
                        )
                        key = (int(ln), int(rn), insn.tobytes())
                        norm.setdefault(key, set()).update(owners)
    # merge keys whose breakpoints differ by <= cluster_pad and same ins len
    keys = sorted(norm.keys())
    merged: List[SvEvent] = []
    used = [False] * len(keys)
    for a in range(len(keys)):
        if used[a]:
            continue
        la, ra, ia = keys[a]
        readset = set(norm[keys[a]])
        for b in range(a + 1, len(keys)):
            if used[b]:
                continue
            lb, rb, ib = keys[b]
            if lb - la > opt.cluster_pad:
                break
            if abs((rb - lb) - (ra - la)) <= 0 and len(ib) == len(ia) and abs(lb - la) <= opt.cluster_pad:
                readset |= norm[keys[b]]
                used[b] = True
        used[a] = True
        merged.append(
            SvEvent(
                left=la,
                right=ra,
                ins=np.frombuffer(ia, np.uint8),
                support=len(readset),
            )
        )
    merged = [e for e in merged if e.support >= opt.min_sv_reads]

    # pair evidence: placed mates straddling the junction in proper
    # orientation with implied fragment <= max_frag after removing the event
    if mate_of is not None and len(merged):
        pos = pos_all
        rcb = rc_all
        mate = np.asarray(mate_of)
        both = (pos >= 0) & (pos[mate] >= 0) & (mate != np.arange(len(pos)))
        proper = both & (rcb != rcb[mate])
        lo_p = np.minimum(pos, pos[mate])
        hi_p = np.maximum(pos + lengths, pos[mate] + lengths[mate])
        sel = np.nonzero(proper)[0]
        lo_p, hi_p = lo_p[sel], hi_p[sel]
        # one-mate-in-novel-sequence evidence (pair_cov's pairs placed INTO
        # the assembled insertion, modules/variants/pair_cov.cpp): a read
        # anchored within a fragment length of the junction whose mate
        # failed placement supports an insertion longer than the fragment,
        # where no pair can straddle both anchors
        half = (pos >= 0) & (pos[mate] < 0) & (mate != np.arange(len(pos)))
        hp = pos[half]
        hl = lengths[half]
        for e in merged:
            straddle = (lo_p + 1 <= e.left) & (hi_p - 1 >= e.right)
            implied = (hi_p - lo_p) - e.del_len + e.ins_len
            okfrag = straddle & (implied <= opt.max_frag) & (implied > 0)
            e.pair_support = int(okfrag.sum()) // 2
            if e.ins_len > opt.max_frag - 2 * int(lengths.max(initial=0)):
                near = (
                    (hp + hl >= e.left - opt.max_frag) & (hp + hl <= e.left)
                ) | ((hp >= e.right) & (hp <= e.right + opt.max_frag))
                e.pair_support += int(near.sum())
    elif len(merged):
        # unpaired library: spanning placed reads stand in for pairs
        pos = pos_all
        sel = np.nonzero(pos >= 0)[0]
        for e in merged:
            span = (pos[sel] + 1 <= e.left) & (pos[sel] + lengths[sel] - 1 >= e.right)
            e.pair_support = 0 if e.del_len > int(lengths.max(initial=0)) else int(span.sum())

    # emit discovery-compatible records
    out = []
    for e in merged:
        left, right, ins = e.left, e.right, e.ins
        contig = None
        for c in reference.contigs:
            if c.start <= left < c.start + c.length:
                contig = c
                break
        if contig is None or right > contig.start + contig.length:
            continue
        anchor = ref[left - 1] if left > 0 else ref[left]
        pos0 = left - 1 if left > 0 else left
        ref_str = dna.codes_to_seq(
            np.concatenate([[anchor], ref[left:right]]).astype(np.uint8)
        )
        alt_str = dna.codes_to_seq(
            np.concatenate([[anchor], ins]).astype(np.uint8)
        )
        out.append(
            {
                "chrom": contig.name,
                "pos": int(pos0 - contig.start + 1),
                "ref": ref_str,
                "alt": alt_str,
                "support": int(e.support),
                "ref_support": 0,
                "pair_support": int(e.pair_support),
                "svlen": int(e.ins_len - e.del_len),
            }
        )
    out.sort(key=lambda r: (r["chrom"], r["pos"]))
    return out


def discover_structural(
    reference,
    codes: np.ndarray,
    lengths: np.ndarray,
    mate_of: np.ndarray | None = None,
    opt: SvOptions | None = None,
    placements: Placements | None = None,
    index: RefKmerIndex | None = None,
) -> List[Dict]:
    """Find >min_event structural variants from split reads + pair support.

    Returns discovery-record dicts (chrom/pos/ref/alt/support/pair_support)
    merge-compatible with the wavefront engine's output.  Composes the
    shardable scan (_sv_scan_reads) with the deterministic finalize
    (_sv_finalize) — the distributed pipeline runs the same two phases with
    the scan sliced per process (parallel/discovery.py)."""
    opt = opt or SvOptions()
    ref = np.asarray(reference.flat)
    if index is None:
        index = RefKmerIndex.build(
            ref, opt.k, is_n=getattr(reference, "is_n", None)
        )
    placements, raw_events, clip_cands, edge_keys, edge_counts = _sv_scan_reads(
        index, codes, lengths, opt, placements=placements
    )
    if not raw_events and not clip_cands:
        return []
    return _sv_finalize(
        reference, index, raw_events, clip_cands, edge_keys, edge_counts,
        placements.pos, placements.is_rc, lengths, mate_of, opt,
    )
