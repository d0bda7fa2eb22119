"""SDUST low-complexity masking (reference sdust.c:44-213) and the
minimizer dust filter (map.c:33-57); a copy of minimap2_tpu.map.sdust.

Off by default (sdust_thres=0, options.c:21); enabled with -T.  Sequential
host port -- the filter runs per read over ~100 intervals, far off the
hot path.
"""
from __future__ import annotations

import numpy as np

from ..utils.intfloat import SEQ_NT4

SD_WLEN = 3
SD_WTOT = 1 << (SD_WLEN << 1)
SD_WMSK = SD_WTOT - 1


def sdust_core(seq: bytes | np.ndarray, T: int = 20, W: int = 64):
    """Returns list of (start, end) perfect-interval unions (sdust_core)."""
    if isinstance(seq, (bytes, bytearray)):
        codes = SEQ_NT4[np.frombuffer(bytes(seq), np.uint8)]
    else:
        codes = np.asarray(seq, np.uint8)
    l_seq = len(codes)
    res: list[list[int]] = []
    P: list[list[int]] = []   # [start, finish, r, l], sorted desc start
    w: list[int] = []         # word deque
    cv = [0] * SD_WTOT
    cw = [0] * SD_WTOT
    rv = rw = L = 0

    def save_masked_regions(start):
        nonlocal P
        if not P or P[-1][0] >= start:
            return
        p = P[-1]
        saved = False
        if res:
            s, f = res[-1]
            if p[0] <= f:
                saved = True
                res[-1][1] = max(f, p[1])
        if not saved:
            res.append([p[0], p[1]])
        i = len(P) - 1
        while i >= 0 and P[i][0] < start:
            i -= 1
        del P[i + 1:]

    def shift_window(t):
        nonlocal rv, rw, L
        if len(w) >= W - SD_WLEN + 1:
            s = w.pop(0)
            cw[s] -= 1
            rw -= cw[s]
            if L > len(w):
                L -= 1
                cv[s] -= 1
                rv -= cv[s]
        w.append(t)
        L += 1
        rw += cw[t]
        cw[t] += 1
        rv += cv[t]
        cv[t] += 1
        if cv[t] * 10 > T << 1:
            while True:
                s = w[len(w) - L]
                cv[s] -= 1
                rv -= cv[s]
                L -= 1
                if s == t:
                    break

    def find_perfect(start):
        c = cv[:]
        r = rv
        max_r = max_l = 0
        for i in range(len(w) - L - 1, -1, -1):
            t = w[i]
            r += c[t]
            c[t] += 1
            new_r, new_l = r, len(w) - i - 1
            if new_r * 10 > T * new_l:
                j = 0
                while j < len(P) and P[j][0] >= i + start:
                    p = P[j]
                    if max_r == 0 or p[2] * max_l > max_r * p[3]:
                        max_r, max_l = p[2], p[3]
                    j += 1
                if max_r == 0 or new_r * max_l >= max_r * new_l:
                    max_r, max_l = new_r, new_l
                    P.insert(j, [i + start, len(w) + (SD_WLEN - 1) + start,
                                 new_r, new_l])

    i = l = t = 0
    for i in range(l_seq + 1):
        b = int(codes[i]) if i < l_seq else 4
        if b < 4:
            l += 1
            t = ((t << 2) | b) & SD_WMSK
            if l >= SD_WLEN:
                start = max(l - W, 0) + (i + 1 - l)
                save_masked_regions(start)
                shift_window(t)
                if rw * 10 > L * T:
                    find_perfect(start)
        else:
            start = max(l - W + 1, 0) + (i + 1 - l)
            while P:
                save_masked_regions(start)
                start += 1
            l = t = 0
    return [(s, f) for s, f in res]


def dust_minier(mx: np.ndarray, my: np.ndarray, l_seq: int, seq: bytes,
                sdust_thres: int):
    """mm_dust_minier (map.c:33-57): drop minimizers with more than half
    their span inside a low-complexity region."""
    if sdust_thres <= 0 or len(mx) == 0:
        return mx, my
    dreg = sdust_core(seq, sdust_thres, 64)
    n_dreg = len(dreg)
    keep = np.ones(len(mx), bool)
    u = 0
    for j in range(len(mx)):
        qpos = int(np.uint32(my[j]) >> np.uint32(1))
        span = int(mx[j] & np.uint64(0xFF))
        s = qpos - (span - 1)
        e = s + span
        while u < n_dreg and dreg[u][1] <= s:
            u += 1
        if u < n_dreg and dreg[u][0] < e:
            ll = 0
            v = u
            while v < n_dreg and dreg[v][0] < e:
                ss = max(s, dreg[v][0])
                ee = min(e, dreg[v][1])
                ll += ee - ss
                v += 1
            if ll > span >> 1:
                keep[j] = False
    return mx[keep], my[keep]
