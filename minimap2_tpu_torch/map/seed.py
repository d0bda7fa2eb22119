"""Seed collection and anchor generation.

Reference semantics: seed.c (mm_seed_mz_flt :5-28, mm_seed_collect_all :30-52,
mm_seed_select :56-96, mm_collect_matches :98-132) and map.c anchor expansion
(collect_seed_hits map.c:168-204, skip_seed map.c:78-100).

A copy of minimap2_tpu.map.seed.  ``collect_seed_hits`` runs the C++
routine of native/host_map.cpp; ``collect_seed_hits_np`` is its plain NumPy
version, which also carries the skip_seed and --qstrand flags the C++
routine lacks (as in the JAX package).  Sort-stability notes: the reference
radix sorts are LSD (stable) keyed on the 64-bit x only, so every np.argsort
here uses kind='stable' on the same key to preserve tie order.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from .. import native
from ..config import (MM_DBG_SEED_FREQ, MM_F_FOR_ONLY, MM_F_NO_DIAG,
                      MM_F_NO_DUAL, MM_F_QSTRAND, MM_F_REV_ONLY,
                      MM_SEED_SEG_SHIFT, MM_SEED_SELF, MM_SEED_TANDEM)

U64 = np.uint64


def seed_mz_flt(mx: np.ndarray, my: np.ndarray, q_occ_max: int, q_occ_frac: float):
    """Drop query minimizers occurring too often within the query itself
    (seed.c:5-28)."""
    n = len(mx)
    if n <= q_occ_max or q_occ_frac <= 0.0 or q_occ_max <= 0:
        return mx, my
    order = np.argsort(mx, kind="stable")
    sx = mx[order]
    grp_start = np.concatenate(([True], sx[1:] != sx[:-1]))
    gid = np.cumsum(grp_start) - 1
    cnt = np.bincount(gid)
    bad_grp = (cnt > q_occ_max) & (cnt > n * q_occ_frac)
    bad = np.zeros(n, dtype=bool)
    bad[order] = bad_grp[gid]
    # the reference zeroes x then compacts entries with x != 0; a legit x==0
    # minimizer would also be dropped -- replicate exactly
    keep = (~bad) & (mx != 0)
    return mx[keep], my[keep]


@dataclass
class Seeds:
    """Columnar mm_seed_t array."""
    q_pos: np.ndarray    # uint32, pos<<1|strand
    q_span: np.ndarray   # int32
    seg_id: np.ndarray   # int32
    start: np.ndarray    # int64 offset into index pos array
    n: np.ndarray        # int64 occurrence count
    is_tandem: np.ndarray  # bool
    flt: np.ndarray      # bool


def seed_collect_all(mi, mx: np.ndarray, my: np.ndarray) -> Seeds:
    """seed.c:30-52. Keeps minimizer order; drops zero-hit minimizers."""
    h = mx >> np.uint64(8)
    start, cnt = mi.get(h)
    tand = np.zeros(len(mx), dtype=bool)
    if len(mx) > 1:
        same_prev = h[1:] == h[:-1]
        tand[1:] |= same_prev
        tand[:-1] |= same_prev
    hit = cnt > 0
    return Seeds(q_pos=(my & np.uint64(0xFFFFFFFF)).astype(np.uint32)[hit],
                 q_span=(mx & np.uint64(0xFF)).astype(np.int32)[hit],
                 seg_id=(my >> np.uint64(32)).astype(np.int32)[hit],
                 start=start[hit], n=cnt[hit], is_tandem=tand[hit],
                 flt=np.zeros(int(hit.sum()), dtype=bool))


def seed_select(s: Seeds, qlen: int, max_occ: int, max_max_occ: int, dist: int):
    """seed.c:56-96: within each streak of high-occurrence seeds keep only the
    top max_high_occ by smallest (n, index); mark the rest filtered."""
    MAX_MAX_HIGH_OCC = 128
    n = len(s.n)
    if n <= 1:
        return
    high = s.n > max_occ
    if not high.any():
        return
    flt = s.flt
    # streaks of consecutive high entries
    i = 0
    last0 = -1
    for i in range(n + 1):
        if i == n or not high[i]:
            if i - last0 > 1:
                ps = 0 if last0 < 0 else int(s.q_pos[last0]) >> 1
                pe = qlen if i == n else int(s.q_pos[i]) >> 1
                st, en = last0 + 1, i
                max_high_occ = int((pe - ps) / dist + 0.499)
                if max_high_occ > 0:
                    max_high_occ = min(max_high_occ, MAX_MAX_HIGH_OCC)
                    j = np.arange(st, en, dtype=np.int64)
                    key = (s.n[st:en].astype(np.uint64) << np.uint64(32)) | j.astype(np.uint64)
                    kk = min(max_high_occ, en - st)
                    sel = j[np.argsort(key, kind="stable")[:kk]]
                    flt[sel] = True
                flt[st:en] ^= True
                flt[st:en] |= s.n[st:en] > max_max_occ
            last0 = i


def dbg_seed_freq(pos, n, flt) -> None:
    """--dbg-seed-occ SF lines (seed.c:115-116): each seed that hit the
    index, its query position, occurrences and whether it was filtered."""
    sys.stderr.write("".join(f"SF\t{p}\t{c}\t{f}\n" for p, c, f in zip(
        np.asarray(pos).tolist(), np.asarray(n).tolist(),
        np.asarray(flt, np.int64).tolist())))


def collect_matches(mi, mx, my, qlen: int, max_occ: int, max_max_occ: int,
                    dist: int, seed_freq: bool = False):
    """seed.c:98-132: returns (seeds kept, n_a, rep_len, mini_pos array);
    with seed_freq, the SF lines of --dbg-seed-occ on stderr."""
    s = seed_collect_all(mi, mx, my)
    if dist > 0 and max_max_occ > max_occ:
        seed_select(s, qlen, max_occ, max_max_occ, dist)
    else:
        s.flt |= s.n > max_occ
    if seed_freq:
        dbg_seed_freq(s.q_pos.astype(np.int64) >> 1, s.n, s.flt)
    # rep_len: union length of filtered-seed intervals, merged in seed order
    rep_len = 0
    rep_st = rep_en = 0
    fidx = np.nonzero(s.flt)[0]
    en_arr = (s.q_pos[fidx].astype(np.int64) >> 1) + 1
    st_arr = en_arr - s.q_span[fidx]
    for st, en in zip(st_arr.tolist(), en_arr.tolist()):
        if st > rep_en:
            rep_len += rep_en - rep_st
            rep_st, rep_en = st, en
        else:
            rep_en = en
    rep_len += rep_en - rep_st
    keep = ~s.flt
    kept = Seeds(q_pos=s.q_pos[keep], q_span=s.q_span[keep], seg_id=s.seg_id[keep],
                 start=s.start[keep], n=s.n[keep], is_tandem=s.is_tandem[keep],
                 flt=np.zeros(int(keep.sum()), dtype=bool))
    n_a = int(kept.n.sum())
    mini_pos = ((kept.q_span.astype(np.uint64) << np.uint64(32))
                | (kept.q_pos.astype(np.uint64) >> np.uint64(1)))
    return kept, n_a, rep_len, mini_pos


def _heapdown(heap, i, n):
    """ks_heapdown (ksort.h) with heap_lt = (a.x > b.x): min-heap on x."""
    tmp = heap[i]
    k = i
    while True:
        k = (k << 1) + 1
        if k >= n:
            break
        if k != n - 1 and heap[k][0] > heap[k + 1][0]:
            k += 1
        if heap[k][0] > tmp[0]:
            break
        heap[i] = heap[k]
        i = k
    heap[i] = tmp


def _skip_seed(flag, r, q_pos, qname, qlen, mi):
    """skip_seed (map.c:78-100), scalar. Returns (skip, is_self)."""
    is_self = False
    if qname is not None and (flag & (MM_F_NO_DIAG | MM_F_NO_DUAL)):
        sq = mi.seq[int(r >> 32)]
        cmp = (qname > sq.name) - (qname < sq.name)
        if (flag & MM_F_NO_DIAG) and cmp == 0 and sq.length == qlen:
            if ((r & 0xFFFFFFFF) >> 1) == (q_pos >> 1):
                return True, is_self
            if (r & 1) == (q_pos & 1):
                is_self = True
        if (flag & MM_F_NO_DUAL) and cmp > 0:
            return True, is_self
    if flag & (MM_F_FOR_ONLY | MM_F_REV_ONLY):
        if (r & 1) == (q_pos & 1):
            if flag & MM_F_REV_ONLY:
                return True, is_self
        elif flag & MM_F_FOR_ONLY:
            return True, is_self
    return False, is_self


def collect_seed_hits_heap(mi, opt, max_occ: int, mx, my, qlen: int,
                           qname: str | None):
    """collect_seed_hits_heap (map.c:102-166): merge the per-seed sorted
    occurrence lists with a ksort min-heap instead of a flat sort.  Used by
    the sr presets (MM_F_HEAP_SORT): forward anchors stream out ascending,
    reverse anchors descending (then reversed in place), exactly like the
    reference -- including the ksort heap's tie behavior, which this is a
    faithful port of.

    Returns (ax, ay, rep_len, mini_pos)."""
    s, n_a, rep_len, mini_pos = collect_matches(
        mi, mx, my, qlen, max_occ, opt.max_max_occ, opt.occ_dist,
        bool(opt.dbg_flag & MM_DBG_SEED_FREQ))
    n_m = len(s.n)
    pos = mi.pos
    flag = opt.flag
    ax = np.zeros(n_a, np.uint64)
    ay = np.zeros(n_a, np.uint64)
    heap = []
    for i in range(n_m):
        if s.n[i] > 0:
            heap.append([int(pos[int(s.start[i])]), i << 32])
    hs = len(heap)
    for i in range((hs >> 1) - 1, -1, -1):      # ks_heapmake
        _heapdown(heap, i, hs)
    n_for = 0
    n_rev = 0
    while hs > 0:
        x, y = heap[0]
        si = y >> 32
        q_pos = int(s.q_pos[si])
        q_span = int(s.q_span[si])
        seg_id = int(s.seg_id[si])
        skip, is_self = _skip_seed(flag, x, q_pos, qname, qlen, mi)
        if not skip:
            rpos = (x & 0xFFFFFFFF) >> 1
            if (x & 1) == (q_pos & 1):          # forward strand
                px = (x & 0xFFFFFFFF00000000) | rpos
                py = (q_span << 32) | (q_pos >> 1)
                idx = n_for
                n_for += 1
            else:
                px = (1 << 63) | (x & 0xFFFFFFFF00000000) | rpos
                py = ((q_span << 32)
                      | (qlen - ((q_pos >> 1) + 1 - q_span) - 1))
                n_rev += 1
                idx = n_a - n_rev
            py |= seg_id << MM_SEED_SEG_SHIFT
            if s.is_tandem[si]:
                py |= MM_SEED_TANDEM
            if is_self:
                py |= MM_SEED_SELF
            ax[idx] = px
            ay[idx] = py
        within = y & 0xFFFFFFFF
        if within < int(s.n[si]) - 1:
            heap[0] = [int(pos[int(s.start[si]) + within + 1]), y + 1]
        else:
            heap[0] = heap[hs - 1]
            hs -= 1
        _heapdown(heap, 0, hs)
    # reverse-strand block is descending; flip it and close the gap
    if n_rev:
        ax[n_a - n_rev:n_a] = ax[n_a - n_rev:n_a][::-1]
        ay[n_a - n_rev:n_a] = ay[n_a - n_rev:n_a][::-1]
    if n_a > n_for + n_rev:
        ax[n_for:n_for + n_rev] = ax[n_a - n_rev:n_a]
        ay[n_for:n_for + n_rev] = ay[n_a - n_rev:n_a]
    return (ax[:n_for + n_rev], ay[:n_for + n_rev], rep_len, mini_pos)


def collect_seed_hits(mi, opt, max_occ: int, mx, my, qlen: int,
                      qname: str | None):
    """map.c:168-204: expand seeds to anchors and stable-sort by x.
    Returns (ax, ay, rep_len, mini_pos).

    The C++ routine has no skip_seed (ava's -X/--dual) and no --for-only,
    --rev-only or --qstrand: with those flags the NumPy expansion is the
    route, as in the JAX package.  Under --dbg-seed-occ the C++ routine
    hands back its seeds and the SF lines are written here (the JAX
    package runs its NumPy expansion for them)."""
    if opt.flag & (MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_FOR_ONLY
                   | MM_F_REV_ONLY | MM_F_QSTRAND):
        return collect_seed_hits_np(mi, opt, max_occ, mx, my, qlen, qname)
    mmo = opt.max_max_occ if (opt.occ_dist > 0
                              and opt.max_max_occ > max_occ) else 0
    seed_freq = bool(opt.dbg_flag & MM_DBG_SEED_FREQ)
    out = native.collect_anchors(mx, my, mi.keys, mi.starts, mi.pos, qlen,
                                 max_occ, mmo if mmo else max_occ,
                                 opt.occ_dist if mmo else 0, seed_freq)
    if seed_freq:
        dbg_seed_freq(*out[4].T)
    return out[:4]


def collect_seed_hits_np(mi, opt, max_occ: int, mx, my, qlen: int,
                         qname: str | None):
    """collect_seed_hits, plain version."""
    s, n_a, rep_len, mini_pos = collect_matches(
        mi, mx, my, qlen, max_occ, opt.max_max_occ, opt.occ_dist,
        bool(opt.dbg_flag & MM_DBG_SEED_FREQ))
    n_m = len(s.n)
    if n_a == 0:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64),
                rep_len, mini_pos)
    # expand occurrence slices
    seed_of = np.repeat(np.arange(n_m), s.n)
    within = np.arange(n_a, dtype=np.int64) - np.repeat(
        np.cumsum(s.n) - s.n, s.n)
    r = mi.pos[np.repeat(s.start, s.n) + within]          # occurrence records
    q_pos = s.q_pos[seed_of]
    q_span = s.q_span[seed_of].astype(np.uint64)
    seg_id = s.seg_id[seed_of].astype(np.uint64)
    tandem = s.is_tandem[seed_of]

    rid = (r >> np.uint64(32)).astype(np.int64)
    rpos = ((r & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
    same_strand = (r & np.uint64(1)) == (q_pos & np.uint32(1)).astype(np.uint64)

    # skip_seed (map.c:78-100)
    skip = np.zeros(n_a, dtype=bool)
    is_self = np.zeros(n_a, dtype=bool)
    flag = opt.flag
    if qname is not None and (flag & (MM_F_NO_DIAG | MM_F_NO_DUAL)):
        uniq_rids = np.unique(rid)
        cmp_map = {int(t): (qname > mi.seq[int(t)].name) - (qname < mi.seq[int(t)].name)
                   for t in uniq_rids}
        cmp = np.array([cmp_map[int(t)] for t in rid.tolist()], dtype=np.int8) \
            if len(uniq_rids) > 1 else np.full(n_a, cmp_map[int(uniq_rids[0])], np.int8)
        if flag & MM_F_NO_DIAG:
            lens = np.array([mi.seq[int(t)].length for t in uniq_rids])
            len_map = dict(zip(uniq_rids.tolist(), lens.tolist()))
            tlen = np.array([len_map[int(t)] for t in rid.tolist()], dtype=np.int64) \
                if len(uniq_rids) > 1 else np.full(n_a, len_map[int(uniq_rids[0])])
            diag_ctx = (cmp == 0) & (tlen == qlen)
            skip |= diag_ctx & (((r & np.uint64(0xFFFFFFFF)) >> np.uint64(1))
                                == (q_pos.astype(np.uint64) >> np.uint64(1)))
            is_self |= diag_ctx & ((r & np.uint64(1)) == (q_pos & np.uint32(1)).astype(np.uint64))
        if flag & MM_F_NO_DUAL:
            skip |= cmp > 0
    if flag & (MM_F_FOR_ONLY | MM_F_REV_ONLY):
        if flag & MM_F_REV_ONLY:
            skip |= same_strand
        if flag & MM_F_FOR_ONLY:
            skip |= ~same_strand

    keep = ~skip
    r, q_pos, q_span, seg_id = r[keep], q_pos[keep], q_span[keep], seg_id[keep]
    tandem, is_self = tandem[keep], is_self[keep]
    rid, rpos, same_strand = rid[keep], rpos[keep], same_strand[keep]

    hi = r & np.uint64(0xFFFFFFFF00000000)
    qp = (q_pos.astype(np.uint64) >> np.uint64(1))
    if not (flag & MM_F_QSTRAND):
        ax = np.where(same_strand, hi | rpos.astype(np.uint64),
                      np.uint64(1 << 63) | hi | rpos.astype(np.uint64))
        rev_y = (np.uint64(qlen) - ((qp + np.uint64(1) - q_span)) - np.uint64(1))
        ay = (q_span << np.uint64(32)) | np.where(same_strand, qp, rev_y)
    else:
        tlen = np.array([mi.seq[int(t)].length for t in rid.tolist()], dtype=np.uint64) \
            if n_a else np.empty(0, np.uint64)
        rev_x = (tlen - (rpos.astype(np.uint64) + np.uint64(1) - q_span) - np.uint64(1))
        ax = np.where(same_strand, hi | rpos.astype(np.uint64),
                      np.uint64(1 << 63) | hi | rev_x)
        ay = (q_span << np.uint64(32)) | qp
    ay = ay | (seg_id << np.uint64(MM_SEED_SEG_SHIFT))
    ay = ay | np.where(tandem, np.uint64(MM_SEED_TANDEM), np.uint64(0))
    ay = ay | np.where(is_self, np.uint64(MM_SEED_SELF), np.uint64(0))

    order = np.argsort(ax, kind="stable")   # radix_sort_128x keyed on x, stable
    return ax[order], ay[order], rep_len, mini_pos
