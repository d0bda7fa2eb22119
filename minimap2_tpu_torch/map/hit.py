"""Hit post-processing: chains -> regions, primary/secondary, mapQ (copy of
minimap2_tpu.map.hit).

Reference semantics: hit.c (mm_gen_regs :52-88, mm_reg_set_coor :23-38,
mm_cal_fuzzy_len :8-21, mm_set_parent :125-186, mm_select_sub :255-281,
mm_hit_sort :188-218, mm_set_sam_pri :220-229, mm_sync_regs :231-253,
mm_filter_regs :301-320, mm_set_mapq2 :432-485, mm_set_inv_mapq :406-430,
mm_filter_strand_retained :283-299, mm_squeeze_a :322-340,
mm_seg_gen :342-396) and esterr.c (mm_est_err :30-64).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..config import MM_PARENT_TMP_PRI, MM_PARENT_UNSET
from ..utils.intfloat import hash64_full


@dataclass
class Extra:
    """mm_extra_t (minimap.h:103-110)."""
    dp_score: int = 0
    dp_max: int = 0
    dp_max2: int = 0
    dp_max0: int = 0
    n_ambi: int = 0
    trans_strand: int = 0
    cigar: list[int] = field(default_factory=list)  # op | len<<4


@dataclass
class Reg:
    """mm_reg1_t (minimap.h:112-127)."""
    id: int = 0
    cnt: int = 0
    rid: int = 0
    score: int = 0
    qs: int = 0
    qe: int = 0
    rs: int = 0
    re: int = 0
    parent: int = MM_PARENT_UNSET
    subsc: int = 0
    as_: int = 0
    mlen: int = 0
    blen: int = 0
    n_sub: int = 0
    score0: int = 0
    mapq: int = 0
    split: int = 0
    rev: bool = False
    inv: bool = False
    sam_pri: bool = False
    proper_frag: bool = False
    pe_thru: bool = False
    seg_split: bool = False
    seg_id: int = 0
    split_inv: bool = False
    is_alt: bool = False
    strand_retained: bool = False
    is_spliced: bool = False
    hash: int = 0
    div: float = -1.0
    p: Extra | None = None


def _cal_fuzzy_len(r: Reg, ax, ay) -> None:
    """hit.c:8-21."""
    r.mlen = r.blen = 0
    if r.cnt <= 0:
        return
    a, b = r.as_, r.as_ + r.cnt
    span = ((ay[a:b] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    rp = (ax[a:b] & np.uint64(0xFFFFFFFF)).astype(np.uint32).astype(np.int32)
    qp = (ay[a:b] & np.uint64(0xFFFFFFFF)).astype(np.uint32).astype(np.int32)
    tl = np.diff(rp).astype(np.int64)
    ql = np.diff(qp).astype(np.int64)
    sp = span[1:]
    r.blen = int(span[0] + np.maximum(tl, ql).sum())
    r.mlen = int(span[0] + np.where((tl > sp) & (ql > sp), sp,
                                    np.minimum(tl, ql)).sum())


def reg_set_coor(r: Reg, qlen: int, ax, ay, is_qstrand: bool) -> None:
    """hit.c:23-38."""
    k = r.as_
    q_span = int((ay[k] >> np.uint64(32)) & np.uint64(0xFF))
    r.rev = bool(ax[k] >> np.uint64(63))
    r.rid = int((ax[k] << np.uint64(1)) >> np.uint64(33))
    rs = int(np.int32(ax[k] & np.uint64(0xFFFFFFFF)))
    r.rs = rs + 1 - q_span if rs + 1 > q_span else 0
    r.re = int(np.int32(ax[k + r.cnt - 1] & np.uint64(0xFFFFFFFF))) + 1
    if not r.rev or is_qstrand:
        r.qs = int(np.int32(ay[k] & np.uint64(0xFFFFFFFF))) + 1 - q_span
        r.qe = int(np.int32(ay[k + r.cnt - 1] & np.uint64(0xFFFFFFFF))) + 1
    else:
        r.qs = qlen - (int(np.int32(ay[k + r.cnt - 1] & np.uint64(0xFFFFFFFF))) + 1)
        r.qe = qlen - (int(np.int32(ay[k] & np.uint64(0xFFFFFFFF))) + 1 - q_span)
    _cal_fuzzy_len(r, ax, ay)


def gen_regs(hash_: int, qlen: int, u: np.ndarray, ax, ay,
             is_qstrand: bool = False) -> list[Reg]:
    """hit.c:52-88: chains (u + anchors) -> hit records, sorted by
    (score ^ tie-hash) descending."""
    n_u = len(u)
    if n_u == 0:
        return []
    zx = np.empty(n_u, dtype=np.uint64)
    zy = np.empty(n_u, dtype=np.uint64)
    k = 0
    for i in range(n_u):
        with np.errstate(over="ignore"):
            h = hash64_full((hash64_full(ax[k]) + hash64_full(ay[k]))
                            ^ np.uint64(hash_ & 0xFFFFFFFFFFFFFFFF))
        h32 = np.uint64(int(h) & 0xFFFFFFFF)
        zx[i] = u[i] ^ h32
        cnt = int(u[i] & np.uint64(0xFFFFFFFF))
        zy[i] = (np.uint64(k) << np.uint64(32)) | np.uint64(cnt)
        k += cnt
    order = np.argsort(zx, kind="stable")[::-1]
    regs = []
    for i, oi in enumerate(order):
        r = Reg()
        r.id = i
        r.parent = MM_PARENT_UNSET
        r.score = r.score0 = int(zx[oi] >> np.uint64(32))
        r.hash = int(zx[oi] & np.uint64(0xFFFFFFFF))
        r.cnt = int(zy[oi] & np.uint64(0xFFFFFFFF))
        r.as_ = int(zy[oi] >> np.uint64(32))
        r.div = -1.0
        reg_set_coor(r, qlen, ax, ay, is_qstrand)
        regs.append(r)
    return regs


def _alt_score(score: int, alt_diff_frac: float) -> int:
    if score < 0:
        return score
    score = int(score * (1.0 - alt_diff_frac) + 0.499)
    return score if score > 0 else 1


def split_reg(r: Reg, n: int, qlen: int, ax, ay, is_qstrand: bool) -> Reg | None:
    """mm_split_reg (hit.c:106-123): split r at anchor n; returns the tail reg."""
    if n <= 0 or n >= r.cnt:
        return None
    import copy
    r2 = copy.copy(r)
    r2.id = -1
    r2.sam_pri = False
    r2.p = None
    r2.split_inv = False
    r2.cnt = r.cnt - n
    r2.score = int(np.float32(r.score) * (np.float32(r2.cnt) / np.float32(r.cnt)) + np.float32(0.499))
    r2.as_ = r.as_ + n
    if r.parent == r.id:
        r2.parent = MM_PARENT_TMP_PRI
    reg_set_coor(r2, qlen, ax, ay, is_qstrand)
    r.cnt -= r2.cnt
    r.score -= r2.score
    reg_set_coor(r, qlen, ax, ay, is_qstrand)
    r.split |= 1
    r2.split |= 2
    return r2


def set_parent(regs: list[Reg], mask_level: float, mask_len: int,
               sub_diff: int, hard_mask_level: bool, alt_diff_frac: float) -> None:
    """hit.c:125-186."""
    n = len(regs)
    if n <= 0:
        return
    for i, r in enumerate(regs):
        r.id = i
    w = [0]
    regs[0].parent = 0
    k = 1
    for i in range(1, n):
        ri = regs[i]
        si, ei = ri.qs, ri.qe
        uncov_len = 0
        if not hard_mask_level:
            cov = []
            for j in range(k):
                rp = regs[w[j]]
                sj, ej = rp.qs, rp.qe
                if ej <= si or sj >= ei:
                    continue
                cov.append((max(sj, si), min(ej, ei)))
            if cov:
                cov.sort()
                x = si
                for s_, e_ in cov:
                    if s_ > x:
                        uncov_len += s_ - x
                    x = max(e_, x)
                if ei > x:
                    uncov_len += ei - x
            # if no overlapping primaries, fall through to "new primary"
        j = k  # default: becomes new primary
        for jj in range(k):
            rp = regs[w[jj]]
            sj, ej = rp.qs, rp.qe
            if ej <= si or sj >= ei:
                continue
            mn = min(ej - sj, ei - si)
            mx = max(ej - sj, ei - si)
            if si < sj:
                ol = 0 if ei < sj else (ei - sj if ei < ej else ej - sj)
            else:
                ol = 0 if ej < si else (ej - si if ej < ei else ei - si)
            if (np.float32(ol) / np.float32(mn) - np.float32(uncov_len) / np.float32(mx)
                    > np.float32(mask_level)) and uncov_len <= mask_len:
                cnt_sub = 0
                sci = ri.score
                ri.parent = rp.parent
                if not rp.is_alt and ri.is_alt:
                    sci = _alt_score(sci, alt_diff_frac)
                rp.subsc = max(rp.subsc, sci)
                if ri.cnt >= rp.cnt:
                    cnt_sub = 1
                if rp.p is not None and ri.p is not None and (
                        rp.rid != ri.rid or rp.rs != ri.rs or rp.re != ri.re or ol != mn):
                    sci = ri.p.dp_max
                    if not rp.is_alt and ri.is_alt:
                        sci = _alt_score(sci, alt_diff_frac)
                    rp.p.dp_max2 = max(rp.p.dp_max2, sci)
                    if rp.p.dp_max - ri.p.dp_max <= sub_diff:
                        cnt_sub = 1
                if cnt_sub:
                    rp.n_sub += 1
                j = jj
                break
        else:
            j = k
        if j == k:
            w.append(i)
            ri.parent = i
            ri.n_sub = 0
            k += 1


def hit_sort(regs: list[Reg], alt_diff_frac: float) -> list[Reg]:
    """hit.c:188-218: sort by (score, hash) descending, squeeze cnt==0."""
    n = len(regs)
    if n <= 1:
        return regs
    aux = []
    for i, r in enumerate(regs):
        if r.inv or r.cnt > 0:
            score = r.p.dp_max if r.p is not None else r.score
            if r.is_alt:
                score = _alt_score(score, alt_diff_frac)
            aux.append(((score << 32) | r.hash, i))
    aux.sort(key=lambda t: t[0])
    return [regs[i] for _, i in reversed(aux)]


def set_sam_pri(regs: list[Reg]) -> int:
    n_pri = 0
    for r in regs:
        if r.id == r.parent:
            n_pri += 1
            r.sam_pri = n_pri == 1
        else:
            r.sam_pri = False
    return n_pri


def sync_regs(regs: list[Reg]) -> None:
    """hit.c:231-253."""
    if not regs:
        return
    max_id = max(r.id for r in regs)
    tmp = [-1] * (max_id + 1)
    for i, r in enumerate(regs):
        if r.id >= 0:
            tmp[r.id] = i
    for i, r in enumerate(regs):
        r.id = i
        if r.parent == MM_PARENT_TMP_PRI:
            r.parent = i
        elif r.parent >= 0 and tmp[r.parent] >= 0:
            r.parent = tmp[r.parent]
        else:
            r.parent = MM_PARENT_UNSET
    set_sam_pri(regs)


def select_sub(regs: list[Reg], pri_ratio: float, min_diff: int, best_n: int,
               check_strand: bool, min_strand_sc: int) -> list[Reg]:
    """hit.c:255-281."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    n = len(regs)
    keep = [False] * n
    n_2nd = 0
    for i, r in enumerate(regs):
        pidx = r.parent
        if pidx == i or r.inv:
            keep[i] = True
        elif ((r.score >= regs[pidx].score * pri_ratio
               or r.score + min_diff >= regs[pidx].score) and n_2nd < best_n):
            rp = regs[pidx]
            if not (r.qs == rp.qs and r.qe == rp.qe and r.rid == rp.rid
                    and r.rs == rp.rs and r.re == rp.re):
                keep[i] = True
                n_2nd += 1
        elif (check_strand and n_2nd < best_n and r.score > min_strand_sc
              and r.rev != regs[pidx].rev):
            r.strand_retained = True
            keep[i] = True
            n_2nd += 1
    out = [r for i, r in enumerate(regs) if keep[i]]
    if len(out) != n:
        sync_regs(out)
    return out


def filter_strand_retained(regs: list[Reg]) -> list[Reg]:
    """hit.c:283-299."""
    out = []
    for r in regs:
        p = regs[r.parent] if 0 <= r.parent < len(regs) else r
        if (not r.strand_retained or r.div < p.div * 5.0 or r.div < 0.01):
            out.append(r)
    return out


def filter_regs(regs: list[Reg], opt, qlen: int) -> list[Reg]:
    """hit.c:301-320."""
    out = []
    for r in regs:
        flt = False
        if not r.inv and not r.seg_split and r.cnt < opt.min_cnt:
            flt = True
        if r.p is not None:
            if r.mlen < opt.min_chain_score:
                flt = True
            elif r.p.dp_max < opt.min_dp_max:
                flt = True
            elif r.qs > qlen * opt.max_clip_ratio and qlen - r.qe > qlen * opt.max_clip_ratio:
                flt = True
            if flt:
                r.p = None
        if not flt:
            out.append(r)
    return out


def squeeze_a(regs: list[Reg], ax, ay):
    """hit.c:322-340: compact anchors to only those referenced by regs."""
    order = sorted(range(len(regs)), key=lambda i: (regs[i].as_, i))
    new_ax = []
    new_ay = []
    as_ = 0
    for i in order:
        r = regs[i]
        new_ax.append(ax[r.as_:r.as_ + r.cnt])
        new_ay.append(ay[r.as_:r.as_ + r.cnt])
        r.as_ = as_
        as_ += r.cnt
    if new_ax:
        return np.concatenate(new_ax), np.concatenate(new_ay)
    return ax[:0], ay[:0]


def mark_alt(mi, regs: list[Reg]) -> None:
    if mi.n_alt == 0:
        return
    for r in regs:
        if mi.seq[r.rid].is_alt:
            r.is_alt = True


def _get_for_qpos(qlen: int, ax_i: int, ay_i: int) -> int:
    """esterr.c:7-14."""
    x = int(np.int32(ay_i & 0xFFFFFFFF))
    q_span = (ay_i >> 32) & 0xFF
    if ax_i >> 63:
        x = qlen - 1 - (x + 1 - q_span)
    return x


def est_err(mi, qlen: int, regs: list[Reg], ax, ay, mini_pos: np.ndarray) -> None:
    """mm_est_err (esterr.c:30-64): per-chain divergence from the fraction of
    query minimizers retained as anchors."""
    n = len(mini_pos)
    if n == 0:
        return
    sum_k = int(((mini_pos >> np.uint64(32)) & np.uint64(0xFF)).sum())
    avg_k = np.float32(sum_k) / np.float32(n)
    mp32 = (mini_pos & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    for r in regs:
        r.div = -1.0
        if r.cnt == 0:
            continue
        a0 = r.as_ + r.cnt - 1 if r.rev else r.as_
        x0 = _get_for_qpos(qlen, int(ax[a0]), int(ay[a0]))
        # exact replica of the reference's binary search (mini_pos is only
        # *approximately* sorted, so searchsorted could diverge; esterr.c:16-28)
        L, R = 0, n - 1
        st = -1
        while L <= R:
            m = (L + R) >> 1
            y = int(mp32[m])
            if y < x0:
                L = m + 1
            elif y > x0:
                R = m - 1
            else:
                st = m
                break
        if st < 0:
            continue  # logic inconsistency warning path
        en = st
        l_ref = mi.seq[r.rid].length
        n_match = 1
        k = 1
        j = st + 1
        while j < n and k < r.cnt:
            ai = r.as_ + r.cnt - 1 - k if r.rev else r.as_ + k
            x = _get_for_qpos(qlen, int(ax[ai]), int(ay[ai]))
            if x == int(mp32[j]):
                k += 1
                en = j
                n_match += 1
            j += 1
        n_tot = en - st + 1
        if r.qs > avg_k and r.rs > avg_k:
            n_tot += 1
        if qlen - r.qs > avg_k and l_ref - r.re > avg_k:
            n_tot += 1
        r.div = 0.0 if n_match >= n_tot else float(np.float32(
            1.0 - math.pow(n_match / n_tot, 1.0 / float(avg_k))))


def set_mapq(regs: list[Reg], min_chain_sc: int, match_sc: int, rep_len: int,
             is_sr: bool, is_splice: bool) -> None:
    """mm_set_mapq2 (hit.c:432-485), float32 arithmetic."""
    f32 = np.float32
    q_coef = f32(40.0)
    if not regs:
        return
    sum_sc = 0
    n_2nd_splice = 0
    for r in regs:
        if r.parent == r.id:
            sum_sc += r.score
        elif r.is_spliced:
            n_2nd_splice += 1
    uniq_ratio = f32(sum_sc) / f32(sum_sc + rep_len) if (sum_sc + rep_len) else f32(0)
    for r in regs:
        if r.inv:
            r.mapq = 0
        elif r.parent == r.id:
            pen_s1 = (f32(1.0) if r.score > 100 else f32(0.01) * f32(r.score)) * uniq_ratio
            pen_cm = f32(1.0) if r.cnt > 10 else f32(0.1) * f32(r.cnt)
            pen_cm = pen_s1 if pen_s1 < pen_cm else pen_cm
            subsc = max(r.subsc, min_chain_sc)
            if r.p is not None and r.p.dp_max2 > 0 and r.p.dp_max > 0:
                identity = f32(r.mlen) / f32(r.blen)
                if is_sr and is_splice:
                    x = f32(r.p.dp_max2) / f32(r.p.dp_max)
                else:
                    x = f32(r.p.dp_max2) * f32(subsc) / f32(r.p.dp_max) / f32(r.score0)
                mapq = int(identity * pen_cm * q_coef * (f32(1.0) - x * x)
                           * f32(np.log(f32(r.p.dp_max) / f32(match_sc))))
                if not is_sr:
                    mapq_alt = int(f32(6.02) * identity * identity
                                   * f32(r.p.dp_max - r.p.dp_max2) / f32(match_sc) + f32(0.499))
                    mapq = min(mapq, mapq_alt)
                if is_splice and is_sr and r.is_spliced and n_2nd_splice == 0:
                    mapq += 10
            else:
                x = f32(subsc) / f32(r.score0)
                if r.p is not None:
                    identity = f32(r.mlen) / f32(r.blen)
                    mapq = int(identity * pen_cm * q_coef * (f32(1.0) - x)
                               * f32(np.log(f32(r.p.dp_max) / f32(match_sc))))
                else:
                    mapq = int(pen_cm * q_coef * (f32(1.0) - x) * f32(np.log(f32(r.score))))
            mapq -= int(f32(4.343) * f32(np.log(f32(r.n_sub + 1))) + f32(0.499))
            mapq = max(mapq, 0)
            r.mapq = min(mapq, 60)
            if r.p is not None and r.p.dp_max > r.p.dp_max2 and r.mapq == 0:
                r.mapq = 1
        else:
            r.mapq = 0
    _set_inv_mapq(regs)


def _set_inv_mapq(regs: list[Reg]) -> None:
    """hit.c:406-430."""
    n = len(regs)
    if n < 3 or not any(r.inv for r in regs):
        return
    aux = sorted(
        ((r.rid << 32 | r.rs, i) for i, r in enumerate(regs)
         if r.parent == i or r.parent < 0))
    for j in range(1, len(aux) - 1):
        inv = regs[aux[j][1]]
        if inv.inv:
            lft = regs[aux[j - 1][1]]
            rgt = regs[aux[j + 1][1]]
            inv.mapq = min(lft.mapq, rgt.mapq)
