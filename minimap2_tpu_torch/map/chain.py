"""Anchor chaining: banded DP chaining and RMQ (long-gap) chaining.

Reference semantics: lchain.c (comput_sc :113-138, mg_lchain_dp :148-217,
mg_chain_backtrack :27-76, compact_a :78-111, mg_lchain_rmq :250-368,
comput_sc_simple :232-248).

A copy of minimap2_tpu.map.chain.  ``chain_dp`` and ``chain_rmq`` run the
C++ routines of native/host_map.cpp, the host mapping path's only route;
``chain_dp_np`` and ``chain_rmq_np`` are their plain NumPy versions (the
per-anchor backward scan with the max_skip/max_iter heuristics and the
long-range max_ii candidate, reproduced exactly), called by the tests only.

Scores use int32 with float32 penalty terms exactly as the C code
(mg_log2 approximation, C float->int truncation).
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..config import MM_SEED_SEG_MASK, MM_SEED_SEG_SHIFT
from ..utils.intfloat import mg_log2

INT32_MIN = -(1 << 31)
NEG_INF = INT32_MIN


def _comput_sc_vec(xi, yi, xj, yj, max_dist_x, max_dist_y, bw,
                   chn_pen_gap, chn_pen_skip, is_cdna, n_seg):
    """Vectorized comput_sc (lchain.c:113-138) of anchor i against anchors j.

    xi, yi: scalars (uint64); xj, yj: uint64 arrays. Returns int64 array with
    NEG_INF for incompatible pairs.
    """
    dq = (np.int64(np.int32(yi & 0xFFFFFFFF))
          - (yj & np.uint64(0xFFFFFFFF)).astype(np.int64))
    sidi = int((yi & MM_SEED_SEG_MASK) >> MM_SEED_SEG_SHIFT)
    sidj = ((yj & np.uint64(MM_SEED_SEG_MASK)) >> np.uint64(MM_SEED_SEG_SHIFT)).astype(np.int64)
    with np.errstate(over="ignore"):
        dr_u = (np.uint64(xi) - xj) & np.uint64(0xFFFFFFFFFFFFFFFF)
    dr = dr_u.astype(np.int64).astype(np.int32).astype(np.int64)
    same_sid = sidi == sidj

    bad = (dq <= 0) | (dq > max_dist_x)
    bad |= same_sid & ((dr == 0) | (dq > max_dist_y))
    dd = np.abs(dr - dq)
    bad |= same_sid & (dd > bw)
    if n_seg > 1 and not is_cdna:
        bad |= same_sid & (dr > max_dist_y)
    dg = np.minimum(dr, dq)
    q_span = ((yj >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    sc = np.minimum(q_span, dg)

    need_pen = (dd != 0) | (dg > q_span)
    ddf = dd.astype(np.float32)
    dgf = dg.astype(np.float32)
    lin_pen = np.float32(chn_pen_gap) * ddf + np.float32(chn_pen_skip) * dgf
    log_pen = np.where(dd >= 1, mg_log2((dd + 1).astype(np.float32)),
                       np.float32(0.0))
    if is_cdna or n_seg > 1:
        # per-branch handling (lchain.c:131-135)
        diff_sid = ~same_sid
        bonus = diff_sid & (dr == 0)
        min_pen = np.minimum(lin_pen, log_pen)
        del_or_jump = (dr > dq) | diff_sid
        pen_a = np.trunc(min_pen).astype(np.int64)
        pen_b = np.trunc(lin_pen + np.float32(0.5) * log_pen).astype(np.int64)
        adj = np.where(bonus, -1,  # sc += 1
                       np.where(del_or_jump, pen_a, pen_b))
        sc = np.where(need_pen, sc - adj, sc)
    else:
        pen = np.trunc((lin_pen + np.float32(0.5) * log_pen).astype(np.float32)).astype(np.int64)
        sc = np.where(need_pen, sc - pen, sc)
    return np.where(bad, np.int64(NEG_INF), sc)


def chain_dp(max_dist_x, max_dist_y, bw, max_skip, max_iter, min_cnt, min_sc,
             chn_pen_gap, chn_pen_skip, is_cdna, n_seg, ax, ay):
    """mg_lchain_dp (lchain.c:148-217) through native/host_map.cpp."""
    if len(ax) == 0:
        return np.empty(0, np.uint64), ax, ay
    return native.lchain_dp(max_dist_x, max_dist_y, bw, max_skip, max_iter,
                            min_cnt, min_sc, chn_pen_gap, chn_pen_skip,
                            is_cdna, n_seg, ax, ay)


def chain_dp_np(max_dist_x, max_dist_y, bw, max_skip, max_iter, min_cnt,
                min_sc, chn_pen_gap, chn_pen_skip, is_cdna, n_seg, ax, ay):
    """mg_lchain_dp (lchain.c:148-217), plain version.

    Returns (u, new_ax, new_ay): u is an int64 array of score<<32|cnt per
    chain; new arrays hold chain anchors concatenated, chains sorted by target
    start position (compact_a semantics).
    """
    n = len(ax)
    if n == 0:
        return np.empty(0, np.uint64), ax, ay
    max_drop = bw
    if max_dist_x < bw:
        max_dist_x = bw
    if max_dist_y < bw and not is_cdna:
        max_dist_y = bw
    if is_cdna:
        max_drop = (1 << 31) - 1

    f = np.zeros(n, dtype=np.int64)
    p = np.full(n, -1, dtype=np.int64)
    v = np.zeros(n, dtype=np.int64)
    t = np.full(n, -1, dtype=np.int64)  # stores marker i (C zeroes; use -1 sentinel)
    axl = ax
    ayl = ay
    x_hi = (ax >> np.uint64(32)).astype(np.int64)
    st = 0
    max_ii = -1
    for i in range(n):
        max_f = int((ayl[i] >> np.uint64(32)) & np.uint64(0xFF))
        max_j = -1
        n_skip = 0
        while st < i and (x_hi[i] != x_hi[st]
                          or int(axl[i]) > int(axl[st]) + max_dist_x):
            st += 1
        if i - st > max_iter:
            st = i - max_iter
        if st < i:
            js = np.arange(st, i, dtype=np.int64)
            scs = _comput_sc_vec(int(axl[i]), int(ayl[i]), axl[st:i], ayl[st:i],
                                 max_dist_x, max_dist_y, bw,
                                 chn_pen_gap, chn_pen_skip, is_cdna, n_seg)
            end_j = st - 1
            for j in range(i - 1, st - 1, -1):
                sc = int(scs[j - st])
                if sc == NEG_INF:
                    continue
                sc += int(f[j])
                if sc > max_f:
                    max_f, max_j = sc, j
                    if n_skip > 0:
                        n_skip -= 1
                elif t[j] == i:
                    n_skip += 1
                    if n_skip > max_skip:
                        end_j = j
                        break
                if p[j] >= 0:
                    t[p[j]] = i
            else:
                end_j = st - 1
        else:
            end_j = st - 1
        if max_ii < 0 or int(axl[i]) - int(axl[max_ii]) > max_dist_x:
            max_ii = -1
            if st < i:
                # C scans j descending with strict '<', so the rightmost argmax wins
                fw = f[st:i]
                max_ii = st + int(np.nonzero(fw == fw.max())[0][-1])
        if 0 <= max_ii < end_j:
            tmp = _comput_sc_vec(int(axl[i]), int(ayl[i]),
                                 axl[max_ii:max_ii + 1], ayl[max_ii:max_ii + 1],
                                 max_dist_x, max_dist_y, bw,
                                 chn_pen_gap, chn_pen_skip, is_cdna, n_seg)
            tsc = int(tmp[0])
            if tsc != NEG_INF and max_f < tsc + int(f[max_ii]):
                max_f = tsc + int(f[max_ii])
                max_j = max_ii
        f[i] = max_f
        p[i] = max_j
        v[i] = v[max_j] if (max_j >= 0 and v[max_j] > max_f) else max_f
        if max_ii < 0 or (int(axl[i]) - int(axl[max_ii]) <= max_dist_x
                          and f[max_ii] < f[i]):
            max_ii = i
    u, new_ax, new_ay = _backtrack_compact(
        f, p, v, min_cnt, min_sc, max_drop, ax, ay)
    return u, new_ax, new_ay


def _chain_bk_end(max_drop, zx, zy, f, p, t, k):
    """mg_chain_bk_end (lchain.c:9-25)."""
    i = int(zy[k])
    end_i, max_i = -1, i
    max_s = 0
    if i < 0 or t[i] != 0:
        return i
    while True:
        t[i] = 2
        i = int(p[i])
        end_i = i
        s = int(zx[k]) if i < 0 else int(zx[k]) - int(f[i])
        s = np.int32(s)
        if s > max_s:
            max_s, max_i = s, i
        elif max_s - s > max_drop:
            break
        if not (i >= 0 and t[i] == 0):
            break
    i = int(zy[k])
    while i >= 0 and i != end_i:
        t[i] = 0
        i = int(p[i])
    return max_i


def _backtrack_compact(f, p, v, min_cnt, min_sc, max_drop, ax, ay):
    """mg_chain_backtrack (lchain.c:27-76) + compact_a (:78-111)."""
    n = len(f)
    sel = np.nonzero(f >= min_sc)[0]
    if len(sel) == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint64), np.empty(0, np.uint64)
    # z sorted by f (stable; ties keep index order)
    order = np.argsort(f[sel], kind="stable")
    zx = f[sel][order]
    zy = sel[order].astype(np.int64)
    n_z = len(zx)
    t = np.zeros(n, dtype=np.int64)
    u_list = []
    v_list = []
    for k in range(n_z - 1, -1, -1):
        if t[zy[k]] != 0:
            continue
        n_v0 = len(v_list)
        end_i = _chain_bk_end(max_drop, zx, zy, f, p, t, k)
        i = int(zy[k])
        while i != end_i:
            v_list.append(i)
            t[i] = 1
            i = int(p[i])
        sc = int(zx[k]) if i < 0 else int(zx[k]) - int(f[i])
        sc = int(np.int32(sc))
        n_vi = len(v_list) - n_v0
        if sc >= min_sc and n_vi > 0 and n_vi >= min_cnt:
            u_list.append((sc, n_vi))
        else:
            del v_list[n_v0:]
    if not u_list:
        return np.empty(0, np.uint64), np.empty(0, np.uint64), np.empty(0, np.uint64)
    # write chains to b[] (anchors reversed back to ascending order)
    bx_parts, by_parts = [], []
    kk = 0
    varr = np.array(v_list, dtype=np.int64)
    for sc, ni in u_list:
        idx = varr[kk:kk + ni][::-1]
        bx_parts.append(ax[idx])
        by_parts.append(ay[idx])
        kk += ni
    # sort chains by the target position of their first anchor (stable)
    firsts = np.array([int(part[0]) for part in bx_parts], dtype=np.uint64)
    corder = np.argsort(firsts, kind="stable")
    u = np.array([(np.uint64(u_list[j][0]) << np.uint64(32)) | np.uint64(u_list[j][1])
                  for j in corder], dtype=np.uint64)
    new_ax = np.concatenate([bx_parts[j] for j in corder])
    new_ay = np.concatenate([by_parts[j] for j in corder])
    return u, new_ax, new_ay


def _comput_sc_simple(xi, yi, xj, yj, chn_pen_gap, chn_pen_skip):
    """comput_sc_simple (lchain.c:232-248). Scalar. Returns (sc, exact, width)."""
    dq = int(np.int32(yi & 0xFFFFFFFF)) - int(np.int32(yj & 0xFFFFFFFF))
    dr = int(np.int32((xi - xj) & 0xFFFFFFFFFFFFFFFF))
    dd = dr - dq if dr > dq else dq - dr
    dg = min(dr, dq)
    q_span = (yj >> 32) & 0xFF
    sc = min(q_span, dg)
    exact = (dd == 0 and dg <= q_span)
    if dd or dq > q_span:
        lin_pen = np.float32(chn_pen_gap) * np.float32(dd) + np.float32(chn_pen_skip) * np.float32(dg)
        log_pen = mg_log2(np.float32(dd + 1)) if dd >= 1 else np.float32(0.0)
        sc -= int(np.trunc(lin_pen + np.float32(0.5) * log_pen))
    return sc, exact, dd


def chain_rmq(max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size,
              min_cnt, min_sc, chn_pen_gap, chn_pen_skip, ax, ay):
    """mg_lchain_rmq (lchain.c:250-368) through native/host_map.cpp's
    segment-tree sweep."""
    if len(ax) == 0:
        return np.empty(0, np.uint64), ax, ay
    return native.lchain_rmq(max_dist, max_dist_inner, bw, max_chn_skip,
                             cap_rmq_size, min_cnt, min_sc, chn_pen_gap,
                             chn_pen_skip, ax, ay)


def chain_rmq_np(max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size,
                 min_cnt, min_sc, chn_pen_gap, chn_pen_skip, ax, ay):
    """mg_lchain_rmq (lchain.c:250-368) via an offline sweep, plain
    version.

    The AVL tree is replaced by explicit active windows over the anchor array;
    RMQ = argmax of the priority within the (query-pos) range. Priorities are
    doubles exactly as the reference."""
    n = len(ax)
    if n == 0:
        return np.empty(0, np.uint64), ax, ay
    if max_dist < bw:
        max_dist = bw
    if max_dist_inner < 0:
        max_dist_inner = 0
    if max_dist_inner > max_dist:
        max_dist_inner = max_dist
    f = np.zeros(n, dtype=np.int64)
    p = np.full(n, -1, dtype=np.int64)
    v = np.zeros(n, dtype=np.int64)
    t = np.full(n, -1, dtype=np.int64)
    x_hi = (ax >> np.uint64(32)).astype(np.int64)
    y32 = (ay & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32).astype(np.int64)
    pri = np.zeros(n, dtype=np.float64)
    x32 = (ax & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32).astype(np.int64)

    in_tree = np.zeros(n, dtype=bool)       # main tree membership
    in_inner = np.zeros(n, dtype=bool)
    st = st_inner = 0
    i0 = 0
    tree_size = inner_size = 0
    for i in range(n):
        q_span = int((ay[i] >> np.uint64(32)) & np.uint64(0xFF))
        max_f = q_span
        max_j = -1
        if i0 < i and ax[i0] != ax[i]:
            for j in range(i0, i):
                # krmq stores pri = -(f + 0.5*gap*(x+y)) and queries the MIN,
                # i.e. the max of (f + 0.5*gap*(x+y)); store it positively
                pri[j] = float(f[j]) + 0.5 * chn_pen_gap * (float(x32[j]) + float(y32[j]))
                in_tree[j] = True
                tree_size += 1
                if max_dist_inner > 0:
                    in_inner[j] = True
                    inner_size += 1
            i0 = i
        while st < i and (x_hi[i] != x_hi[st]
                          or int(ax[i]) > int(ax[st]) + max_dist
                          or tree_size > cap_rmq_size):
            if in_tree[st]:
                in_tree[st] = False
                tree_size -= 1
            st += 1
        if max_dist_inner > 0:
            while st_inner < i and (x_hi[i] != x_hi[st_inner]
                                    or int(ax[i]) > int(ax[st_inner]) + max_dist_inner
                                    or inner_size > cap_rmq_size):
                if in_inner[st_inner]:
                    in_inner[st_inner] = False
                    inner_size -= 1
                st_inner += 1
        # RMQ over y range (lo.y, hi.y) per krmq comparator semantics
        lo_y = int(y32[i]) - max_dist
        hi_y = int(y32[i])
        if tree_size > 0:
            cand = np.nonzero(in_tree[: i])[0]
            yc = y32[cand]
            inr = (yc > lo_y) & (yc < hi_y)
            cand = cand[inr]
            if len(cand) > 0:
                # max priority; AVL rmq: ties -> implementation-defined; use
                # leftmost (smallest index) which matches krmq in-order layout
                q = int(cand[np.argmax(pri[cand])])
                sc, exact, width = _comput_sc_simple(
                    int(ax[i]), int(ay[i]), int(ax[q]), int(ay[q]),
                    chn_pen_gap, chn_pen_skip)
                scf = sc + int(f[q])
                if width <= bw and scf > max_f:
                    max_f, max_j = scf, q
                n_skip = 0
                if not exact and max_dist_inner > 0 and int(y32[i]) > 0:
                    # iterate inner tree from y <= a_i.y - 1 descending
                    icand = np.nonzero(in_inner[: i])[0]
                    yy = y32[icand]
                    sel = icand[yy <= int(y32[i]) - 1]
                    # descending (y, i) order
                    order = np.lexsort((sel, y32[sel]))[::-1]
                    for q2 in sel[order]:
                        if int(y32[q2]) < int(y32[i]) - max_dist_inner:
                            break
                        sc2, _, width2 = _comput_sc_simple(
                            int(ax[i]), int(ay[i]), int(ax[q2]), int(ay[q2]),
                            chn_pen_gap, chn_pen_skip)
                        sc2 += int(f[q2])
                        if width2 <= bw:
                            if sc2 > max_f:
                                max_f, max_j = sc2, int(q2)
                                if n_skip > 0:
                                    n_skip -= 1
                            elif t[q2] == i:
                                n_skip += 1
                                if n_skip > max_chn_skip:
                                    break
                            if p[q2] >= 0:
                                t[p[q2]] = i
        f[i] = max_f
        p[i] = max_j
        v[i] = v[max_j] if (max_j >= 0 and v[max_j] > max_f) else max_f
    return _backtrack_compact(f, p, v, min_cnt, min_sc, bw, ax, ay)
