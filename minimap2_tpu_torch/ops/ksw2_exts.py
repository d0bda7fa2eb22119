"""Splice-aware extension kernel, bit-exact with ksw_exts2_sse
(ksw2_exts2_sse.c:33-465).

Same anti-diagonal difference recurrence as extd2, with the long-gap state
replaced by an intron state: opening cost q2 at donor sites (plus per-position
donor/acceptor adjustments from GT..AG signals, annotation bonuses or splice
scores), zero extension cost, and N CIGAR emission for gaps longer than
long_thres. No banding (the reference kernel has no w parameter).

A copy of minimap2_tpu.ops.ksw2_exts without its native dispatch: the plain
version of native.ksw_exts2 (native/host_map.cpp), called by the tests only.
"""
from __future__ import annotations

import numpy as np

from .ksw2_np import (KSW_EZ_APPROX_DROP, KSW_EZ_APPROX_MAX, KSW_EZ_EXTZ_ONLY,
                      KSW_EZ_GENERIC_SC, KSW_EZ_REV_CIGAR, KSW_EZ_RIGHT,
                      KSW_EZ_SCORE_ONLY, KSW_EZ_SPLICE_CMPLX,
                      KSW_EZ_SPLICE_FLANK, KSW_EZ_SPLICE_FOR,
                      KSW_EZ_SPLICE_REV, KSW_EZ_SPLICE_SCORE, KSW_NEG_INF,
                      ExtzResult, _apply_zdrop, backtrack)

I8 = np.int8
U8 = np.uint8
KSW_SPSC_OFFSET = 64


def _splice_site_arrays(tlen, target, flag, noncan, tlen_pad):
    """Donor/acceptor penalty arrays (ksw2_exts2_sse.c:120-192)."""
    sp0 = [8, 15, 21, 30]
    if flag & KSW_EZ_SPLICE_CMPLX:
        sp = [int(v / 3.0 + 0.499) for v in sp0]
    else:
        sp = [noncan // 2 if (flag & KSW_EZ_SPLICE_FLANK) else 0,
              noncan, noncan, noncan]
    donor = np.full(tlen_pad, -sp[3], dtype=np.int64)
    acceptor = np.full(tlen_pad, -sp[3], dtype=np.int64)
    tg = target
    if not (flag & KSW_EZ_REV_CIGAR):
        for t in range(tlen - 4):
            z = 3
            if flag & KSW_EZ_SPLICE_FOR:
                if tg[t + 1] == 2 and tg[t + 2] == 3:
                    z = -1 if (tg[t + 3] == 0 or tg[t + 3] == 2) else 0
                elif tg[t + 1] == 2 and tg[t + 2] == 1:
                    z = 1
                elif tg[t + 1] == 0 and tg[t + 2] == 3:
                    z = 2
            elif flag & KSW_EZ_SPLICE_REV:
                if tg[t + 1] == 1 and tg[t + 2] == 3:
                    z = -1 if (tg[t + 3] == 0 or tg[t + 3] == 2) else 0
                elif tg[t + 1] == 2 and tg[t + 2] == 3:
                    z = 2
            donor[t] = 0 if z < 0 else -sp[z]
        for t in range(2, tlen):
            z = 3
            if flag & KSW_EZ_SPLICE_FOR:
                if tg[t - 1] == 0 and tg[t] == 2:
                    z = -1 if (tg[t - 2] == 1 or tg[t - 2] == 3) else 0
                elif tg[t - 1] == 0 and tg[t] == 1:
                    z = 2
            elif flag & KSW_EZ_SPLICE_REV:
                if tg[t - 1] == 0 and tg[t] == 1:
                    z = -1 if (tg[t - 2] == 1 or tg[t - 2] == 3) else 0
                elif tg[t - 1] == 2 and tg[t] == 1:
                    z = 1
                elif tg[t - 1] == 0 and tg[t] == 3:
                    z = 2
            acceptor[t] = 0 if z < 0 else -sp[z]
    else:
        for t in range(tlen - 4):
            z = 3
            if flag & KSW_EZ_SPLICE_FOR:
                if tg[t + 1] == 2 and tg[t + 2] == 0:
                    z = -1 if (tg[t + 3] == 1 or tg[t + 3] == 3) else 0
                elif tg[t + 1] == 1 and tg[t + 2] == 0:
                    z = 2
            elif flag & KSW_EZ_SPLICE_REV:
                if tg[t + 1] == 1 and tg[t + 2] == 0:
                    z = -1 if (tg[t + 3] == 1 or tg[t + 3] == 3) else 0
                elif tg[t + 1] == 1 and tg[t + 2] == 2:
                    z = 1
                elif tg[t + 1] == 3 and tg[t + 2] == 0:
                    z = 2
            donor[t] = 0 if z < 0 else -sp[z]
        for t in range(2, tlen):
            z = 3
            if flag & KSW_EZ_SPLICE_FOR:
                if tg[t - 1] == 3 and tg[t] == 2:
                    z = -1 if (tg[t - 2] == 0 or tg[t - 2] == 2) else 0
                elif tg[t - 1] == 1 and tg[t] == 2:
                    z = 1
                elif tg[t - 1] == 3 and tg[t] == 0:
                    z = 2
            elif flag & KSW_EZ_SPLICE_REV:
                if tg[t - 1] == 3 and tg[t] == 1:
                    z = -1 if (tg[t - 2] == 0 or tg[t - 2] == 2) else 0
                elif tg[t - 1] == 3 and tg[t] == 2:
                    z = 2
            acceptor[t] = 0 if z < 0 else -sp[z]
    return donor, acceptor


def ksw_exts2(qlen, query, tlen, target, m, mat, q, e, q2, noncan, zdrop,
              end_bonus, junc_bonus, junc_pen, flag, junc,
              ez: ExtzResult | None = None) -> ExtzResult:
    if ez is None:
        ez = ExtzResult()
    ez.reset()
    if m <= 1 or qlen <= 0 or tlen <= 0 or q2 <= q + e:
        return ez
    assert not ((flag & KSW_EZ_SPLICE_FOR) and (flag & KSW_EZ_SPLICE_REV))
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)
    mat = np.asarray(mat, dtype=np.int8)
    sc_N = I8(-e) if mat[m * m - 1] == 0 else I8(mat[m * m - 1])
    min_sc = int(mat.min())
    if -min_sc > 2 * (q + e):
        return ez
    long_thres = (q2 - q) // e - 1
    if q2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * e - (q2 - q)
    tlen_ = (tlen + 15) // 16
    L = tlen_ * 16 + 16
    u = np.full(L, -q - e, dtype=I8)
    v = np.full(L, -q - e, dtype=I8)
    x = np.full(L, -q - e, dtype=I8)
    y = np.full(L, -q - e, dtype=I8)
    x2 = np.full(L, -q2, dtype=I8)
    s = np.zeros(L, dtype=I8)
    sf = np.zeros(L, dtype=U8)
    sf[:tlen] = target
    qr = np.zeros((qlen + 15) // 16 * 16 + 32, dtype=U8)
    qr[:qlen] = query[::-1]

    # donor/acceptor arrays (zero outside splice modes)
    if flag & (KSW_EZ_SPLICE_FOR | KSW_EZ_SPLICE_REV):
        donor64, acceptor64 = _splice_site_arrays(tlen, target, flag, noncan, L)
    else:
        donor64 = np.zeros(L, dtype=np.int64)
        acceptor64 = np.zeros(L, dtype=np.int64)
    if junc is not None and (flag & KSW_EZ_SPLICE_SCORE):
        donor_val = 0 if (bool(flag & KSW_EZ_SPLICE_FOR) == (not (flag & KSW_EZ_REV_CIGAR))) else 1
        j64 = np.asarray(junc, dtype=np.int64)
        for t in range(tlen - 1):
            jv = int(j64[t + 1])
            donor64[t] += (-junc_pen if (jv == 0xFF or (jv & 1) != donor_val)
                           else np.int8(jv >> 1) - KSW_SPSC_OFFSET)
            acceptor64[t] += (-junc_pen if (jv == 0xFF or (jv & 1) != (1 - donor_val))
                              else np.int8(jv >> 1) - KSW_SPSC_OFFSET)
    elif junc is not None:
        j64 = np.asarray(junc, dtype=np.int64)
        if not (flag & KSW_EZ_REV_CIGAR):
            for t in range(tlen - 1):
                if ((flag & KSW_EZ_SPLICE_FOR) and (j64[t + 1] & 1)) or \
                        ((flag & KSW_EZ_SPLICE_REV) and (j64[t + 1] & 8)):
                    donor64[t] += junc_bonus
            for t in range(tlen):
                if ((flag & KSW_EZ_SPLICE_FOR) and (j64[t] & 2)) or \
                        ((flag & KSW_EZ_SPLICE_REV) and (j64[t] & 4)):
                    acceptor64[t] += junc_bonus
        else:
            for t in range(tlen - 1):
                if ((flag & KSW_EZ_SPLICE_FOR) and (j64[t + 1] & 2)) or \
                        ((flag & KSW_EZ_SPLICE_REV) and (j64[t + 1] & 4)):
                    donor64[t] += junc_bonus
            for t in range(tlen):
                if ((flag & KSW_EZ_SPLICE_FOR) and (j64[t] & 1)) or \
                        ((flag & KSW_EZ_SPLICE_REV) and (j64[t] & 8)):
                    acceptor64[t] += junc_bonus
    donor = donor64.astype(I8)
    acceptor = acceptor64.astype(I8)

    H = None
    if not approx_max:
        H = np.full(tlen_ * 16 + 16, KSW_NEG_INF, dtype=np.int64)
    p_rows: dict[int, np.ndarray] = {}
    off = np.zeros(qlen + tlen - 1, dtype=np.int64)
    off_end = np.zeros(qlen + tlen - 1, dtype=np.int64)
    qe_pen = q + e
    right_mode = bool(flag & KSW_EZ_RIGHT)
    generic = bool(flag & KSW_EZ_GENERIC_SC)
    H0 = 0
    last_H0_t = 0
    last_st = last_en = -1

    for r in range(qlen + tlen - 1):
        st, en = 0, tlen - 1
        if st < r - qlen + 1:
            st = r - qlen + 1
        if en > r:
            en = r
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, x21, v1 = int(x[st - 1]), int(x2[st - 1]), int(v[st - 1])
            else:
                x1, x21, v1 = -q - e, -q2, -q - e
        else:
            x1, x21 = -q - e, -q2
            v1 = (-q - e if r == 0 else
                  -e if r < long_thres else
                  long_diff if r == long_thres else 0)
        if en >= r:
            y[r] = I8(-q - e)
            u[r] = I8(-q - e if r == 0 else
                      -e if r < long_thres else
                      long_diff if r == long_thres else 0)
        base = qlen - 1 - r
        if not generic:
            t = st0
            while t <= en0:
                sq = sf[t:t + 16].astype(np.int16)
                tq = qr[base + t:base + t + 16].astype(np.int16)
                eqm = sq == tq
                maskN = (sq == m - 1) | (tq == m - 1)
                val = np.where(eqm, I8(mat[0]), I8(mat[1]))
                val = np.where(maskN, sc_N, val)
                s[t:t + 16] = val
                t += 16
        else:
            idx_t = sf[st0:en0 + 1].astype(np.int64)
            idx_q = qr[base + st0:base + en0 + 1].astype(np.int64)
            s[st0:en0 + 1] = mat[idx_t * m + idx_q]
        with np.errstate(over="ignore"):
            z = s[st:en + 1].copy()
            xt1 = np.concatenate(([I8(x1)], x[st:en]))
            vt1 = np.concatenate(([I8(v1)], v[st:en]))
            x2t1 = np.concatenate(([I8(x21)], x2[st:en]))
            ut = u[st:en + 1].copy()
            a = xt1 + vt1
            b = y[st:en + 1] + ut
            a2 = x2t1 + vt1
            a2a = a2 + acceptor[st:en + 1]
            if with_cigar:
                if not right_mode:
                    d = np.where(a > z, U8(1), U8(0))
                    z = np.maximum(z, a)
                    d = np.where(b > z, U8(2), d)
                    z = np.maximum(z, b)
                    d = np.where(a2a > z, U8(3), d)
                    z = np.maximum(z, a2a)
                else:
                    d = np.where(z > a, U8(0), U8(1))
                    z = np.maximum(z, a)
                    d = np.where(z > b, d, U8(2))
                    z = np.maximum(z, b)
                    d = np.where(z > a2a, d, U8(3))
                    z = np.maximum(z, a2a)
            else:
                z = np.maximum(np.maximum(z, a), np.maximum(b, a2a))
                d = None
            u[st:en + 1] = z - vt1
            v[st:en + 1] = z - ut
            tmp = z - I8(q)
            a = a - tmp
            b = b - tmp
            a2 = a2 - (z - I8(q2))
            if not right_mode:
                ga, gb = a > 0, b > 0
            else:
                ga, gb = a >= 0, b >= 0
            x[st:en + 1] = np.where(ga, a, I8(0)) - I8(qe_pen)
            y[st:en + 1] = np.where(gb, b, I8(0)) - I8(qe_pen)
            dn = donor[st:en + 1]
            if not right_mode:
                g2 = a2 > dn
            else:
                g2 = a2 >= dn
            x2[st:en + 1] = np.where(g2, a2, dn) - I8(q2)
            if with_cigar:
                d = d | np.where(ga, U8(0x08), U8(0))
                d = d | np.where(gb, U8(0x10), U8(0))
                d = d | np.where(g2, U8(0x20), U8(0))
                p_rows[r] = d
                off[r], off_end[r] = st, en
        if not approx_max:
            v8 = v.astype(np.int64)
            u8 = u.astype(np.int64)
            if r > 0:
                if en0 > 0:
                    H[en0] = H[en0 - 1] + u8[en0]
                else:
                    H[en0] = H[en0] + v8[en0]
                max_H, max_t = int(H[en0]), en0
                if en0 > st0:
                    H[st0:en0] += v8[st0:en0]
                    seg = H[st0:en0]
                    mi_ = int(np.argmax(seg))
                    if int(seg[mi_]) > max_H:
                        max_H, max_t = int(seg[mi_]), st0 + mi_
            else:
                H[0] = int(v8[0]) - qe_pen
                max_H, max_t = int(H[0]), 0
            if en0 == tlen - 1 and H[en0] > ez.mte:
                ez.mte, ez.mte_q = int(H[en0]), r - en0
            if r - st0 == qlen - 1 and H[st0] > ez.mqe:
                ez.mqe, ez.mqe_t = int(H[st0]), st0
            if _apply_zdrop(ez, int(max_H), r, max_t, zdrop, 0):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = int(H[tlen - 1])
        else:
            if r > 0:
                if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                    d0 = int(v[last_H0_t])
                    d1 = int(u[last_H0_t + 1])
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0 += d1
                        last_H0_t += 1
                elif st0 <= last_H0_t <= en0:
                    H0 += int(v[last_H0_t])
                else:
                    last_H0_t += 1
                    H0 += int(u[last_H0_t])
            else:
                H0 = int(v[0]) - qe_pen
                last_H0_t = 0
            if (flag & KSW_EZ_APPROX_DROP) and _apply_zdrop(ez, H0, r, last_H0_t, zdrop, 0):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    if with_cigar:
        if not ez.zdropped and not (flag & KSW_EZ_EXTZ_ONLY):
            ez.cigar = backtrack(p_rows, off, off_end, tlen - 1, qlen - 1, long_thres)
        elif not ez.zdropped and (flag & KSW_EZ_EXTZ_ONLY) and ez.mqe + end_bonus > ez.max:
            ez.reach_end = True
            ez.cigar = backtrack(p_rows, off, off_end, ez.mqe_t, qlen - 1, long_thres)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = backtrack(p_rows, off, off_end, ez.max_t, ez.max_q, long_thres)
        if flag & KSW_EZ_REV_CIGAR:
            ez.cigar.reverse()
    return ez
