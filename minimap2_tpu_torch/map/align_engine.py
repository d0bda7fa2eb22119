"""Scoring matrices and CIGAR clean-up (copy of minimap2_tpu.map.
align_engine's pieces the --batch -c/-a path uses: ksw_gen_simple_mat
align.c:11-24, ksw_gen_ts_mat align.c:26-36, mm_fix_cigar align.c:105-181
and mm_event_identity align.c:997-1003)."""
from __future__ import annotations

import numpy as np

from .hit import Reg

CIG_M, CIG_I, CIG_D, CIG_N = 0, 1, 2, 3


def gen_simple_mat(m, a, b, sc_ambi):
    """ksw_gen_simple_mat (align.c:11-24)."""
    a = abs(a)
    b = -abs(b)
    sc_ambi = -abs(sc_ambi)
    mat = np.zeros(m * m, dtype=np.int8)
    for i in range(m - 1):
        for j in range(m - 1):
            mat[i * m + j] = a if i == j else b
        mat[i * m + m - 1] = sc_ambi
    for j in range(m):
        mat[(m - 1) * m + j] = sc_ambi
    return mat


def gen_ts_mat(m, a, b, transition, sc_ambi):
    """ksw_gen_ts_mat (align.c:26-36)."""
    mat = gen_simple_mat(m, a, b, sc_ambi)
    if transition == 0 or transition == b:
        return mat
    transition = -abs(transition)
    mat[0 * m + 2] = transition
    mat[1 * m + 3] = transition
    mat[2 * m + 0] = transition
    mat[3 * m + 1] = transition
    return mat


def fix_cigar(r: Reg, qseq, tseq):
    """mm_fix_cigar (align.c:105-181): indel left-shift, 5I6D7I merge and
    leading-indel removal.  Returns (qshift, tshift)."""
    p = r.p
    qshift = tshift = 0
    if len(p.cigar) <= 1:
        return 0, 0
    cig = p.cigar
    toff = qoff = 0
    to_shrink = False
    for k in range(len(cig)):
        op, ln = cig[k] & 0xF, cig[k] >> 4
        if ln == 0:
            to_shrink = True
        if op == CIG_M:
            toff += ln
            qoff += ln
        elif op in (CIG_I, CIG_D):
            if 0 < k < len(cig) - 1 and (cig[k - 1] & 0xF) == 0 \
                    and (cig[k + 1] & 0xF) == 0:
                prev_len = cig[k - 1] >> 4
                sh = 0
                if op == CIG_I:
                    while sh < prev_len and \
                            qseq[qoff - 1 - sh] == qseq[qoff + ln - 1 - sh]:
                        sh += 1
                else:
                    while sh < prev_len and \
                            tseq[toff - 1 - sh] == tseq[toff + ln - 1 - sh]:
                        sh += 1
                if sh > 0:
                    cig[k - 1] -= sh << 4
                    cig[k + 1] += sh << 4
                    qoff -= sh
                    toff -= sh
                if sh == prev_len:
                    to_shrink = True
            if op == CIG_I:
                qoff += ln
            else:
                toff += ln
        elif op == CIG_N:
            toff += ln
    assert qoff == r.qe - r.qs and toff == r.re - r.rs
    k = 0
    while k + 2 < len(cig):  # fix 5I6D7I runs
        if (cig[k] & 0xF) > 0 and (cig[k] & 0xF) + (cig[k + 1] & 0xF) == 3:
            s = [0, 0, 0]
            j = k
            while j < len(cig):
                op = cig[j] & 0xF
                if op in (CIG_I, CIG_D) or (cig[j] >> 4) == 0:
                    if op <= 2:
                        s[op] += cig[j] >> 4
                    j += 1
                else:
                    break
            if s[1] > 0 and s[2] > 0 and j - k > 2:
                cig[k] = s[1] << 4 | CIG_I
                cig[k + 1] = s[2] << 4 | CIG_D
                for kk in range(k + 2, j):
                    cig[kk] &= 0xF
                to_shrink = True
            k = j + 1  # C: k = l inside the body, then the for-loop ++k
        else:
            k += 1
    if to_shrink:
        cig2 = [c for c in cig if (c >> 4) != 0]
        cig3 = []
        k = 0
        while k < len(cig2):
            if k == len(cig2) - 1 or (cig2[k] & 0xF) != (cig2[k + 1] & 0xF):
                cig3.append(cig2[k])
            else:
                cig2[k + 1] += (cig2[k] >> 4) << 4
            k += 1
        p.cigar = cig3
        cig = p.cigar
    if cig and (cig[0] & 0xF) in (CIG_I, CIG_D):
        lead = cig[0] >> 4
        if (cig[0] & 0xF) == CIG_I:
            if r.rev:
                r.qe -= lead
            else:
                r.qs += lead
            qshift = lead
        else:
            r.rs += lead
            tshift = lead
        del cig[0]
    return qshift, tshift


def event_identity(r: Reg) -> float:
    """mm_event_identity (align.c:997-1003)."""
    if r.p is None:
        return -1.0
    n_gap = n_gapo = 0
    for c in r.p.cigar:
        op, ln = c & 0xF, c >> 4
        if op in (CIG_I, CIG_D):
            n_gapo += 1
            n_gap += ln
    denom = r.blen + r.p.n_ambi - n_gap + n_gapo
    return r.mlen / denom if denom else 0.0
