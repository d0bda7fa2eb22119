"""Paired-end pairing and multi-segment helpers (reference pe.c, hit.c
seg_gen; copy of minimap2_tpu.map.pe).  The host mapping path
(map/pipeline.map_frag_core) runs all four on a multi-segment fragment;
the --batch paired-end driver (parallel/engine.run_batched_pe_cli) runs
``pair`` on each fragment's device records."""
from __future__ import annotations

import numpy as np

from ..config import MM_SEED_SEG_MASK, MM_SEED_SEG_SHIFT
from . import hit as hitmod


def seg_gen(hash_: int, qlens, regs0, ax, ay):
    """mm_seg_gen (hit.c:342-396): split fragment chains into per-segment chains."""
    n_segs = len(qlens)
    acc = [0]
    for s in range(1, n_segs):
        acc.append(acc[s - 1] + qlens[s - 1])
    qlen_sum = acc[-1] + qlens[-1]
    seg_u = [[] for _ in range(n_segs)]
    seg_ax = [[] for _ in range(n_segs)]
    seg_ay = [[] for _ in range(n_segs)]
    for r in regs0:
        per_seg_cnt = [0] * n_segs
        per_seg_x = [[] for _ in range(n_segs)]
        per_seg_y = [[] for _ in range(n_segs)]
        for j in range(r.cnt):
            a_x = int(ax[r.as_ + j])
            a_y = int(ay[r.as_ + j])
            sid = (a_y & MM_SEED_SEG_MASK) >> MM_SEED_SEG_SHIFT
            rev = a_x >> 63
            adj = (qlen_sum - (qlens[sid] + acc[sid])) if rev else acc[sid]
            a_y = (a_y - adj) & 0xFFFFFFFFFFFFFFFF
            per_seg_cnt[sid] += 1
            per_seg_x[sid].append(a_x)
            per_seg_y[sid].append(a_y)
        for s in range(n_segs):
            if per_seg_cnt[s]:
                seg_u[s].append((r.score << 32) | per_seg_cnt[s])
                seg_ax[s].extend(per_seg_x[s])
                seg_ay[s].extend(per_seg_y[s])
    out = []
    for s in range(n_segs):
        u = np.array(seg_u[s], dtype=np.uint64)
        sax = np.array(seg_ax[s], dtype=np.uint64)
        say = np.array(seg_ay[s], dtype=np.uint64)
        regs = hitmod.gen_regs(hash_, qlens[s], u, sax, say, False)
        for r in regs:
            r.seg_split = True
            r.seg_id = s
        out.append((regs, sax, say))
    return out


def select_sub_multi(regs, pri_ratio, pri1, pri2, max_gap_ref, min_diff,
                     best_n, n_segs, qlens):
    """mm_select_sub_multi (pe.c:6-48)."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    n = len(regs)
    keep = [False] * n
    n_2nd = 0
    for i, r in enumerate(regs):
        p = r.parent
        if p == i:
            keep[i] = True
        elif n_2nd < best_n:
            rp = regs[p]
            thres = pri_ratio
            # pe.c: lower the threshold for hits joining both ends
            if r.qs < qlens[0] and r.qe > qlens[0]:  # crosses segment boundary
                thres = pri1 if rp.qs < qlens[0] and rp.qe > qlens[0] else pri2
            if r.score >= rp.score * thres or r.score + min_diff >= rp.score:
                keep[i] = True
                n_2nd += 1
    out = [r for i, r in enumerate(regs) if keep[i]]
    if len(out) != n:
        hitmod.sync_regs(out)
    return out


def set_pe_thru(qlens, regs_pair):
    """mm_set_pe_thru (pe.c:51-69): flag read-through pairs."""
    n_pri = [0, 0]
    pri = [None, None]
    for s in range(2):
        for r in regs_pair[s]:
            if r.id == r.parent:
                n_pri[s] += 1
                pri[s] = r
    if n_pri[0] == 1 and n_pri[1] == 1:
        p, q = pri[0], pri[1]
        if (p.rid == q.rid and p.rev == q.rev and abs(p.rs - q.rs) < 3
                and abs(p.re - q.re) < 3
                and ((p.qs == 0 and qlens[1] - q.qe == 0)
                     or (q.qs == 0 and qlens[0] - p.qe == 0))):
            p.pe_thru = q.pe_thru = True


def pair(max_gap_ref, pe_bonus, sub_diff, match_sc, qlens, regs_pair):
    """mm_pair (pe.c:81-182): proper-pair rescue + pair mapq boost."""
    U32 = 0xFFFFFFFF
    entries = []   # (key, s, rev, reg)
    dp_thres = 0
    segs = 0
    for s in range(2):
        mx = 0
        for r in regs_pair[s]:
            key = (r.rid << 33) | (r.rs << 1) | (s ^ int(r.rev))
            entries.append([key, s, int(r.rev), r])
            if r.p is not None:
                mx = max(mx, r.p.dp_max)
            segs |= 1 << s
        dp_thres += mx
    if segs != 3:
        return regs_pair
    dp_thres = max(dp_thres - pe_bonus, 0)
    entries.sort(key=lambda t: t[0])       # radix_sort_pair: key only, stable

    mx_score = -1
    max_idx = [-1, -1]
    last = [-1, -1]
    sc: list[int] = []
    for i, (key, s, rev, r) in enumerate(entries):
        if key & 1:  # reverse first read or forward second read
            if last[rev] < 0:
                continue
            q = entries[last[rev]][3]
            if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                continue
            for j in range(last[rev], -1, -1):
                kj, sj, revj, q = entries[j]
                if revj != rev or sj == s:
                    continue
                if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                    break
                if r.p.dp_max + q.p.dp_max < dp_thres:
                    continue
                score = ((r.p.dp_max + q.p.dp_max) << 32) \
                    | ((r.hash + q.hash) & U32)
                if score > mx_score:
                    mx_score = score
                    max_idx[sj] = j
                    max_idx[s] = i
                sc.append(score)
        else:       # forward first read or reverse second read
            last[rev] = i
    sc.sort()

    if sc and mx_score > 0:
        r2 = [entries[max_idx[0]][3], entries[max_idx[1]][3]]
        r2[0].proper_frag = r2[1].proper_frag = True
        for s in range(2):
            rs_ = r2[s]
            if rs_.id != rs_.parent:   # lift to primary, update parent
                pold = next((x for x in regs_pair[s]
                             if x.id == rs_.parent), None)
                if pold is not None:
                    for x in regs_pair[s]:
                        if x.parent == pold.id:
                            x.parent = rs_.id
                    pold.mapq = 0
            if not rs_.sam_pri:
                for x in regs_pair[s]:
                    x.sam_pri = False
                rs_.sam_pri = True
        mapq_pe = max(r2[0].mapq, r2[1].mapq)
        n_sub = sum(1 for v in sc if (v >> 32) + sub_diff >= (mx_score >> 32))
        if len(sc) > 1:
            f32 = np.float32
            mapq_pe_alt = int(f32(f32(6.02) * f32((mx_score >> 32)
                                                  - (sc[-2] >> 32))
                                  / f32(match_sc))
                              - f32(4.343) * f32(np.log(f32(n_sub))))
            mapq_pe = min(mapq_pe, mapq_pe_alt)
        for rr in r2:
            if rr.mapq < mapq_pe:
                rr.mapq = int(np.float32(0.2) * np.float32(rr.mapq)
                              + np.float32(0.8) * np.float32(mapq_pe)
                              + np.float32(0.499))
        if len(sc) == 1:
            for rr in r2:
                rr.mapq = max(rr.mapq, 2)
        elif (mx_score >> 32) > (sc[-2] >> 32):
            for rr in r2:
                rr.mapq = max(rr.mapq, 1)

    set_pe_thru(qlens, regs_pair)
    return regs_pair
