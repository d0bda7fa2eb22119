"""Banded extension alignment kernels, bit-exact with the reference ksw2.

Implements the Suzuki-Kasahara difference recurrence on anti-diagonals exactly
as the reference SIMD kernels do (ksw2_extz2_sse.c, ksw2_extd2_sse.c), in
diagonal-vectorized NumPy int8 arithmetic, including:
  * the 16-lane block rounding of the band (st/en rounding) and the resulting
    deterministic out-of-band cell updates,
  * wrap-around int8 arithmetic (epi8 add/sub), signed/unsigned max semantics,
  * exact and approximate max/zdrop modes,
  * the direction-byte encoding and ksw_backtrack state machine (ksw2.h:126-162).

A copy of minimap2_tpu.ops.ksw2_np without its native dispatch: these are
the plain versions of the host mapping path's C++ routines
(native/host_map.cpp, bound in native/__init__.py), called by name from the
tests only.

Also implements ksw_ll_i16 (Farrar striped local SW; ksw2_ll_sse.c) with the
reference's tie-breaking for (score, qe, te).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

KSW_NEG_INF = -0x40000000

KSW_EZ_SCORE_ONLY = 0x01
KSW_EZ_RIGHT = 0x02
KSW_EZ_GENERIC_SC = 0x04
KSW_EZ_APPROX_MAX = 0x08
KSW_EZ_APPROX_DROP = 0x10
KSW_EZ_EXTZ_ONLY = 0x40
KSW_EZ_REV_CIGAR = 0x80
KSW_EZ_SPLICE_FOR = 0x100
KSW_EZ_SPLICE_REV = 0x200
KSW_EZ_SPLICE_FLANK = 0x400
KSW_EZ_SPLICE_CMPLX = 0x800
KSW_EZ_SPLICE_SCORE = 0x1000

CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N = 0, 1, 2, 3

I8 = np.int8
U8 = np.uint8


@dataclass
class ExtzResult:
    """ksw_extz_t (ksw2.h:34-43)."""
    max: int = 0
    zdropped: bool = False
    max_q: int = -1
    max_t: int = -1
    mqe: int = KSW_NEG_INF
    mqe_t: int = -1
    mte: int = KSW_NEG_INF
    mte_q: int = -1
    score: int = KSW_NEG_INF
    reach_end: bool = False
    cigar: list[int] = field(default_factory=list)

    @property
    def n_cigar(self):
        return len(self.cigar)

    def reset(self):
        self.max_q = self.max_t = self.mqe_t = self.mte_q = -1
        self.max = 0
        self.score = self.mqe = self.mte = KSW_NEG_INF
        self.cigar = []
        self.zdropped = False
        self.reach_end = False


def push_cigar(cigar: list[int], op: int, length: int):
    if not cigar or (cigar[-1] & 0xF) != op:
        cigar.append(length << 4 | op)
    else:
        cigar[-1] += length << 4


def _apply_zdrop(ez: ExtzResult, H: int, r: int, t: int, zdrop: int, e: int) -> bool:
    """ksw_apply_zdrop (ksw2.h:171-187), is_rot=1."""
    if H > ez.max:
        ez.max, ez.max_t, ez.max_q = H, t, r - t
    elif t >= ez.max_t and r - t >= ez.max_q:
        tl = t - ez.max_t
        ql = (r - t) - ez.max_q
        l = tl - ql if tl > ql else ql - tl
        if zdrop >= 0 and ez.max - H > zdrop + l * e:
            ez.zdropped = True
            return True
    return False


def backtrack(p_rows, off, off_end, i0: int, j0: int,
              min_intron_len: int = 0) -> list[int]:
    """ksw_backtrack (ksw2.h:130-162), is_rot=1, forward CIGAR."""
    cigar: list[int] = []
    i, j, state = i0, j0, 0
    while i >= 0 and j >= 0:
        r = i + j
        force_state = -1
        if i < off[r]:
            force_state = 2
        if off_end is not None and i > off_end[r]:
            force_state = 1
        tmp = int(p_rows[r][i - off[r]]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2) & 1):
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            push_cigar(cigar, CIGAR_M, 1)
            i -= 1
            j -= 1
        elif state == 1 or (state == 3 and min_intron_len <= 0):
            push_cigar(cigar, CIGAR_D, 1)
            i -= 1
        elif state == 3 and min_intron_len > 0:
            push_cigar(cigar, CIGAR_N, 1)
            i -= 1
        else:
            push_cigar(cigar, CIGAR_I, 1)
            j -= 1
    if i >= 0:
        push_cigar(cigar, CIGAR_N if (min_intron_len > 0 and i >= min_intron_len)
                   else CIGAR_D, i + 1)
    if j >= 0:
        push_cigar(cigar, CIGAR_I, j + 1)
    cigar.reverse()
    return cigar


def ksw_extd2(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
              m: int, mat: np.ndarray, q: int, e: int, q2: int, e2: int,
              w: int, zdrop: int, end_bonus: int, flag: int,
              ez: ExtzResult | None = None) -> ExtzResult:
    """ksw_extd2_sse (ksw2_extd2_sse.c:34-401), bit-exact."""
    if ez is None:
        ez = ExtzResult()
    ez.reset()
    if m <= 1 or qlen <= 0 or tlen <= 0:
        return ez
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)
    if q2 + e2 < q + e:
        q, q2 = q2, q
        e, e2 = e2, e
    mat = np.asarray(mat, dtype=np.int8)
    sc_N = I8(-e2) if mat[m * m - 1] == 0 else I8(mat[m * m - 1])
    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen_ = (tlen + 15) // 16
    n_col_ = min(qlen, tlen)
    n_col_ = (min(n_col_, w + 1) + 15) // 16 + 1
    max_sc = int(mat.max())
    min_sc = int(mat[1:m * m].min())
    min_sc = min(min_sc, int(mat[1]))
    if -min_sc > 2 * (q + e):
        return ez
    if e != e2:
        long_thres = (q2 - q) // (e - e2) - 1
    else:
        long_thres = 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2

    L = tlen_ * 16 + 16  # padded state length (extra block for storeu overrun)
    u = np.full(L, -q - e, dtype=I8)
    v = np.full(L, -q - e, dtype=I8)
    x = np.full(L, -q - e, dtype=I8)
    y = np.full(L, -q - e, dtype=I8)
    x2 = np.full(L, -q2 - e2, dtype=I8)
    y2 = np.full(L, -q2 - e2, dtype=I8)
    s = np.zeros(L, dtype=I8)
    sf = np.zeros(L, dtype=U8)
    sf[:tlen] = target
    qlen_pad = (qlen + 15) // 16 * 16 + 32
    qr = np.zeros(qlen_pad, dtype=U8)
    qr[:qlen] = query[::-1]
    H = None
    if not approx_max:
        H = np.full(tlen_ * 16 + 16, KSW_NEG_INF, dtype=np.int64)
    p_rows: dict[int, np.ndarray] = {}
    off = np.zeros(qlen + tlen - 1, dtype=np.int64)
    off_end = np.zeros(qlen + tlen - 1, dtype=np.int64)
    qe_pen = q + e
    qe2_pen = q2 + e2
    sc_mch = I8(mat[0])
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
        if st < (r - wr + 1) >> 1:
            st = (r - wr + 1) >> 1
        if en > (r + wl) >> 1:
            en = (r + wl) >> 1
        if st > en:
            ez.zdropped = True
            break
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1
        # boundary conditions
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, x21, v1 = int(x[st - 1]), int(x2[st - 1]), int(v[st - 1])
            else:
                x1, x21 = -q - e, -q2 - e2
                v1 = -q - e
        else:
            x1, x21 = -q - e, -q2 - e2
            v1 = (-q - e if r == 0 else
                  -e if r < long_thres else
                  long_diff if r == long_thres else -e2)
        if en >= r:
            y[r] = I8(-q - e)
            y2[r] = I8(-q2 - e2)
            u[r] = I8(-q - e if r == 0 else
                      -e if r < long_thres else
                      long_diff if r == long_thres else -e2)
        # score row with exact coverage
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
        # core vectorized over [st, en]
        with np.errstate(over="ignore"):
            z = s[st:en + 1].copy()
            xt1 = np.concatenate(([I8(x1)], x[st:en]))
            vt1 = np.concatenate(([I8(v1)], v[st:en]))
            x2t1 = np.concatenate(([I8(x21)], x2[st:en]))
            ut = u[st:en + 1].copy()
            a = xt1 + vt1
            b = y[st:en + 1] + ut
            a2 = x2t1 + vt1
            b2 = y2[st:en + 1] + ut
            if with_cigar:
                if not right_mode:
                    d = np.where(a > z, U8(1), U8(0))
                    z = np.maximum(z, a)
                    d = np.where(b > z, U8(2), d)
                    z = np.maximum(z, b)
                    d = np.where(a2 > z, U8(3), d)
                    z = np.maximum(z, a2)
                    d = np.where(b2 > z, U8(4), d)
                    z = np.maximum(z, b2)
                else:
                    d = np.where(z > a, U8(0), U8(1))
                    z = np.maximum(z, a)
                    d = np.where(z > b, d, U8(2))
                    z = np.maximum(z, b)
                    d = np.where(z > a2, d, U8(3))
                    z = np.maximum(z, a2)
                    d = np.where(z > b2, d, U8(4))
                    z = np.maximum(z, b2)
            else:
                z = np.maximum(z, a)
                z = np.maximum(z, b)
                z = np.maximum(z, a2)
                z = np.maximum(z, b2)
                d = None
            z = np.minimum(z, sc_mch)
            u[st:en + 1] = z - vt1
            v[st:en + 1] = z - ut
            tmp = z - I8(q)
            a = a - tmp
            b = b - tmp
            tmp = z - I8(q2)
            a2 = a2 - tmp
            b2 = b2 - tmp
            if not right_mode:
                ga, gb = a > 0, b > 0
                ga2, gb2 = a2 > 0, b2 > 0
                x[st:en + 1] = np.where(ga, a, I8(0)) - I8(qe_pen)
                y[st:en + 1] = np.where(gb, b, I8(0)) - I8(qe_pen)
                x2[st:en + 1] = np.where(ga2, a2, I8(0)) - I8(qe2_pen)
                y2[st:en + 1] = np.where(gb2, b2, I8(0)) - I8(qe2_pen)
            else:
                ga, gb = a >= 0, b >= 0
                ga2, gb2 = a2 >= 0, b2 >= 0
                x[st:en + 1] = np.where(ga, a, I8(0)) - I8(qe_pen)
                y[st:en + 1] = np.where(gb, b, I8(0)) - I8(qe_pen)
                x2[st:en + 1] = np.where(ga2, a2, I8(0)) - I8(qe2_pen)
                y2[st:en + 1] = np.where(gb2, b2, I8(0)) - I8(qe2_pen)
            if with_cigar:
                d = d | np.where(ga, U8(0x08), U8(0))
                d = d | np.where(gb, U8(0x10), U8(0))
                d = d | np.where(ga2, U8(0x20), U8(0))
                d = d | np.where(gb2, U8(0x40), U8(0))
                p_rows[r] = d
                off[r], off_end[r] = st, en
        # H updates
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
                    mi = int(np.argmax(seg))
                    if int(seg[mi]) > max_H:
                        max_H, max_t = int(seg[mi]), st0 + mi
            else:
                H[0] = v8[0] - qe_pen
                max_H, max_t = int(H[0]), 0
            if en0 == tlen - 1 and H[en0] > ez.mte:
                ez.mte, ez.mte_q = int(H[en0]), r - en0
            if r - st0 == qlen - 1 and H[st0] > ez.mqe:
                ez.mqe, ez.mqe_t = int(H[st0]), st0
            if _apply_zdrop(ez, int(max_H), r, max_t, zdrop, e2):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = int(H[tlen - 1])
        else:
            v8 = v
            u8 = u
            if r > 0:
                if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                    d0 = int(v8[last_H0_t])
                    d1 = int(u8[last_H0_t + 1])
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0 += d1
                        last_H0_t += 1
                elif st0 <= last_H0_t <= en0:
                    H0 += int(v8[last_H0_t])
                else:
                    last_H0_t += 1
                    H0 += int(u8[last_H0_t])
            else:
                H0 = int(v8[0]) - qe_pen
                last_H0_t = 0
            if (flag & KSW_EZ_APPROX_DROP) and _apply_zdrop(ez, H0, r, last_H0_t, zdrop, e2):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    if with_cigar:
        if not ez.zdropped and not (flag & KSW_EZ_EXTZ_ONLY):
            ez.cigar = backtrack(p_rows, off, off_end, tlen - 1, qlen - 1)
        elif not ez.zdropped and (flag & KSW_EZ_EXTZ_ONLY) and ez.mqe + end_bonus > ez.max:
            ez.reach_end = True
            ez.cigar = backtrack(p_rows, off, off_end, ez.mqe_t, qlen - 1)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = backtrack(p_rows, off, off_end, ez.max_t, ez.max_q)
        if flag & KSW_EZ_REV_CIGAR:
            ez.cigar.reverse()
    return ez


def ksw_extz2(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
              m: int, mat: np.ndarray, q: int, e: int, w: int, zdrop: int,
              end_bonus: int, flag: int, ez: ExtzResult | None = None) -> ExtzResult:
    """ksw_extz2_sse (ksw2_extz2_sse.c), bit-exact. Offset arithmetic: all
    DP state stored as non-negative uint8 values (z offset by 2*(q+e))."""
    if ez is None:
        ez = ExtzResult()
    ez.reset()
    if m <= 0 or qlen <= 0 or tlen <= 0:
        return ez
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)
    mat = np.asarray(mat, dtype=np.int8)
    sc_N = I8(-e) if mat[m * m - 1] == 0 else I8(mat[m * m - 1])
    qe2 = (q + e) * 2
    max_sc_clip = U8(mat[0] + (q + e) * 2)
    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen_ = (tlen + 15) // 16
    n_col_ = min(qlen, tlen)
    n_col_ = (min(n_col_, w + 1) + 15) // 16 + 1
    min_sc = int(mat.min())
    if -min_sc > 2 * (q + e):
        return ez
    L = tlen_ * 16 + 16
    u = np.zeros(L, dtype=U8)
    v = np.zeros(L, dtype=U8)
    x = np.zeros(L, dtype=U8)
    y = np.zeros(L, dtype=U8)
    s = np.zeros(L, dtype=I8)
    sf = np.zeros(L, dtype=U8)
    sf[:tlen] = target
    qr = np.zeros((qlen + 15) // 16 * 16 + 32, dtype=U8)
    qr[:qlen] = query[::-1]
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
        if st < (r - wr + 1) >> 1:
            st = (r - wr + 1) >> 1
        if en > (r + wl) >> 1:
            en = (r + wl) >> 1
        if st > en:
            ez.zdropped = True
            break
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, v1 = int(x[st - 1]), int(v[st - 1])
            else:
                x1 = v1 = 0
        else:
            x1 = 0
            v1 = q if r else 0
        if en >= r:
            y[r] = U8(0)
            u[r] = U8(q if r else 0)
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
            # block1: z = s + qe2 (int8 add, wraps)
            z = (s[st:en + 1] + I8(qe2)).view(U8) if False else (s[st:en + 1].astype(I8) + I8(qe2))
            xt1 = np.concatenate(([U8(x1)], x[st:en]))
            vt1 = np.concatenate(([U8(v1)], v[st:en]))
            ut = u[st:en + 1].copy()
            a = (xt1.view(I8) + vt1.view(I8))
            b = (y[st:en + 1].view(I8) + ut.view(I8))
            if with_cigar:
                if not right_mode:
                    d = np.where(a > z, U8(1), U8(0))
                    z = np.maximum(z, a)           # signed max (SSE4.1 path)
                    d = np.where(b > z, U8(2), d)
                else:
                    d = np.where(z > a, U8(0), U8(1))
                    z = np.maximum(z, a)
                    d = np.where(z > b, d, U8(2))
            else:
                z = np.maximum(z, a)
                d = None
            # block2: unsigned max with b, unsigned min with clip
            zu = np.maximum(z.view(U8), b.view(U8))
            zu = np.minimum(zu, max_sc_clip)
            u[st:en + 1] = (zu.view(I8) - vt1.view(I8)).view(U8)
            v[st:en + 1] = (zu.view(I8) - ut.view(I8)).view(U8)
            zq = zu.view(I8) - I8(q)
            a = a - zq
            b = b.view(I8) - zq
            ga = a > 0
            gb = b > 0
            if not right_mode:
                x[st:en + 1] = np.where(ga, a, I8(0)).view(U8)
                y[st:en + 1] = np.where(gb, b, I8(0)).view(U8)
            else:
                ga = a >= 0
                gb = b >= 0
                x[st:en + 1] = np.where(ga, a, I8(0)).view(U8)
                y[st:en + 1] = np.where(gb, b, I8(0)).view(U8)
            if with_cigar:
                d = d | np.where(ga, U8(0x08), U8(0))
                d = d | np.where(gb, U8(0x10), U8(0))
                p_rows[r] = d
                off[r], off_end[r] = st, en
        if not approx_max:
            v8 = v.astype(np.int64)   # uint8 interpretation
            u8 = u.astype(np.int64)
            if r > 0:
                if en0 > 0:
                    H[en0] = H[en0 - 1] + u8[en0] - qe_pen
                else:
                    H[en0] = H[en0] + v8[en0] - qe_pen
                max_H, max_t = int(H[en0]), en0
                if en0 > st0:
                    H[st0:en0] += v8[st0:en0] - qe_pen
                    seg = H[st0:en0]
                    mi = int(np.argmax(seg))
                    if int(seg[mi]) > max_H:
                        max_H, max_t = int(seg[mi]), st0 + mi
            else:
                H[0] = int(v8[0]) - qe_pen - qe_pen
                max_H, max_t = int(H[0]), 0
            if en0 == tlen - 1 and H[en0] > ez.mte:
                ez.mte, ez.mte_q = int(H[en0]), r - en0
            if r - st0 == qlen - 1 and H[st0] > ez.mqe:
                ez.mqe, ez.mqe_t = int(H[st0]), st0
            if _apply_zdrop(ez, int(max_H), r, max_t, zdrop, e):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = int(H[tlen - 1])
        else:
            if r > 0:
                if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                    d0 = int(v[last_H0_t]) - qe_pen
                    d1 = int(u[last_H0_t + 1]) - qe_pen
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0 += d1
                        last_H0_t += 1
                elif st0 <= last_H0_t <= en0:
                    H0 += int(v[last_H0_t]) - qe_pen
                else:
                    last_H0_t += 1
                    H0 += int(u[last_H0_t]) - qe_pen
                if (flag & KSW_EZ_APPROX_DROP) and _apply_zdrop(ez, H0, r, last_H0_t, zdrop, e):
                    break
            else:
                H0 = int(v[0]) - qe_pen - qe_pen
                last_H0_t = 0
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    if with_cigar:
        if not ez.zdropped and not (flag & KSW_EZ_EXTZ_ONLY):
            ez.cigar = backtrack(p_rows, off, off_end, tlen - 1, qlen - 1)
        elif not ez.zdropped and (flag & KSW_EZ_EXTZ_ONLY) and ez.mqe + end_bonus > ez.max:
            ez.reach_end = True
            ez.cigar = backtrack(p_rows, off, off_end, ez.mqe_t, qlen - 1)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = backtrack(p_rows, off, off_end, ez.max_t, ez.max_q)
        if flag & KSW_EZ_REV_CIGAR:
            ez.cigar.reverse()
    return ez


def ksw_ll(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
           m: int, mat: np.ndarray, gapo: int, gape: int):
    """ksw_ll_qinit(size=2) + ksw_ll_i16 (ksw2_ll_sse.c:85-152): Farrar striped
    local SW, score + end positions, replicated faithfully including the
    lazy-F loop's early exit and its interaction with the E update.

    Returns (score, qe, te) with the reference's exact tie-breaking.
    """
    if qlen <= 0 or tlen <= 0:
        return 0, -1, -1
    mat = np.asarray(mat, dtype=np.int64).reshape(m, m)
    slen = (qlen + 7) // 8
    # striped profile: prof[a][j][lane] = mat[a][query[lane*slen + j]] or -1
    pos = np.arange(slen)[:, None] + np.arange(8)[None, :] * slen  # (slen, 8)
    padded_q = np.full(slen * 8, -1, dtype=np.int64)
    padded_q[:qlen] = query[:qlen].astype(np.int64)
    valid = pos < qlen
    prof = np.empty((m, slen, 8), dtype=np.int64)
    for a in range(m):
        prof[a] = np.where(valid, mat[a][np.where(valid, padded_q[pos], 0)], -1)
    gapoe = gapo + gape
    H0 = np.zeros((slen, 8), dtype=np.int64)
    H1 = np.zeros((slen, 8), dtype=np.int64)
    E = np.zeros((slen, 8), dtype=np.int64)
    Hmax = np.zeros((slen, 8), dtype=np.int64)
    gmax, te = 0, -1

    def subs_epu(aa, bb):
        return np.maximum(aa - bb, 0)

    for i in range(tlen):
        S = prof[int(target[i])]
        # h = H0[slen-1] shifted one lane up (slli by 2 bytes = one i16 lane)
        h = np.concatenate(([0], H0[slen - 1][:-1]))
        f = np.zeros(8, dtype=np.int64)
        rowmax = np.zeros(8, dtype=np.int64)
        for j in range(slen):
            h = h + S[j]
            e = E[j]
            h = np.maximum(h, e)
            h = np.maximum(h, f)
            rowmax = np.maximum(rowmax, h)
            H1[j] = h
            h2 = subs_epu(h, gapoe)
            e = subs_epu(e, gape)
            E[j] = np.maximum(e, h2)
            f = subs_epu(f, gape)
            f = np.maximum(f, h2)
            h = H0[j].copy()
        # lazy F propagation across lanes
        done = False
        for k in range(8):
            f = np.concatenate(([0], f[:-1]))
            for j in range(slen):
                h = np.maximum(H1[j], f)
                H1[j] = h
                h2 = subs_epu(h, gapoe)
                f = subs_epu(f, gape)
                if not np.any(f > h2):
                    done = True
                    break
            if done:
                break
        imax = int(rowmax.max())
        # NB: rowmax computed before lazy-F, exactly like the reference
        if imax >= gmax:
            gmax, te = imax, i
            Hmax[:] = H1
        H0, H1 = H1, H0
    # qe: scan Hmax in memory order (j fast within segment, lane slow is NOT
    # the layout -- uint16 memory order is [j][lane]), last hit wins
    qe = -1
    flat = Hmax.reshape(-1)  # index i -> j = i//8, lane = i%8
    hits = np.nonzero(flat == gmax)[0]
    if len(hits):
        i_hit = int(hits[-1])
        qe = i_hit // 8 + (i_hit % 8) * slen
    return gmax, qe, te
