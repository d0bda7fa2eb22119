"""Base-level alignment engine of the host mapping path (copy of
minimap2_tpu.map.align_engine): the reference align.c around the ksw2
extensions.

The port's copy differs in two ways: the DPs (extd2, extz2, exts2, ll)
and the z-drop and mm_update_extra scans run only through the C++ routines
of native/ (their NumPy versions are the tests' business).  With
MapOptions.dbg_flag's MM_DBG_PRINT_ALN_SEQ bit (--print-aln-seq)
mm_align_pair writes each DP's parameters, target and query, then its
score and CIGAR, on stderr (align.c:339-346, :361-367).

Reference anchors (file:line cited per function): mm_align_skeleton
(align.c:1048-1120), mm_align1 (:645-914), mm_align1_inv (:916-971),
mm_test_zdrop (:61-103), mm_fix_cigar (:105-181), mm_update_cigar_eqx
(:183-252), mm_update_extra (:254-303), mm_fix_bad_ends (:527-561),
mm_filter_bad_seeds (:454-489), mm_filter_bad_seeds_alt (:491-525),
mm_adjust_minier (:418-433), mm_max_stretch (:563-589), update_dp_max
(:1022-1046), mm_event_identity (:997-1003).
"""
from __future__ import annotations

import copy
import math
import sys

import numpy as np

from ..config import (MM_CIGAR_STR, MM_DBG_PRINT_ALN_SEQ, MM_F_EQX,
                      MM_F_FOR_ONLY, MM_F_NO_END_FLT, MM_F_NO_INV,
                      MM_F_QSTRAND, MM_F_REV_ONLY, MM_F_SPLICE,
                      MM_F_SPLICE_FLANK, MM_F_SPLICE_FOR, MM_F_SPLICE_OLD,
                      MM_F_SPLICE_REV, MM_F_SR, MM_F_SR_RNA, MM_F_ALL_CHAINS,
                      MM_PARENT_TMP_PRI, MM_PARENT_UNSET, MM_SEED_LONG_JOIN,
                      MM_SEED_IGNORE, MM_SEED_SELF, MM_SEED_TANDEM, MM_I_HPC)
from .. import native
from ..ops import ksw2_np as K
from ..utils.intfloat import SEQ_NT4, mg_log2
from . import hit as hitmod
from .align_srrna import align_sr_rna
from .hit import Extra, Reg

I32 = lambda v: int(np.int32(v & 0xFFFFFFFF))

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


def test_zdrop(opt, qseq, tseq, cigar, mat):
    """mm_test_zdrop (align.c:61-103). Returns 0/1/2."""
    max_zdrop, pos = native.zdrop_scan(qseq, tseq, cigar, mat, 5, opt.q,
                                       opt.e)
    return _test_zdrop_tail(opt, qseq, tseq, mat, max_zdrop, pos)


def _test_zdrop_tail(opt, qseq, tseq, mat, max_zdrop, pos):
    """Inversion-rescue branch of mm_test_zdrop (align.c:88-102)."""
    q_len = pos[1][1] - pos[1][0]
    t_len = pos[0][1] - pos[0][0]
    if (not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_FOR_ONLY | MM_F_REV_ONLY))
            and max_zdrop > opt.zdrop_inv and q_len < opt.max_gap and t_len < opt.max_gap):
        seg = qseq[pos[1][0]:pos[1][1]][::-1].astype(np.int64)
        qseq2 = np.where(seg >= 4, 4, 3 - seg).astype(np.uint8)
        score, _, _ = native.ksw_ll(q_len, qseq2, t_len, tseq[pos[0][0]:pos[0][1]],
                               5, mat, opt.q, opt.e)
        if score >= opt.min_chain_score * opt.a and score >= opt.min_dp_max:
            return 2
    return 1 if max_zdrop > opt.zdrop else 0


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


def update_cigar_eqx(r: Reg, qseq, tseq):
    """mm_update_cigar_eqx (align.c:183-252)."""
    if r.p is None:
        return
    new = []
    toff = qoff = 0
    for c in r.p.cigar:
        op, ln = c & 0xF, c >> 4
        if op == CIG_M:
            while ln > 0:
                l = 0
                while l < ln and qseq[qoff + l] == tseq[toff + l]:
                    l += 1
                if l > 0:
                    new.append(l << 4 | 7)  # =
                    ln -= l
                    toff += l
                    qoff += l
                l = 0
                while l < ln and qseq[qoff + l] != tseq[toff + l]:
                    l += 1
                if l > 0:
                    new.append(l << 4 | 8)  # X
                    ln -= l
                    toff += l
                    qoff += l
            continue
        elif op == CIG_I:
            qoff += ln
        elif op in (CIG_D, CIG_N):
            toff += ln
        new.append(c)
    r.p.cigar = new


def update_extra(r: Reg, qseq, tseq, mat, q, e, is_eqx, log_gap):
    """mm_update_extra (align.c:254-303)."""
    p = r.p
    if p is None:
        return
    qshift, tshift = fix_cigar(r, qseq, tseq)
    qseq = qseq[qshift:]
    tseq = tseq[tshift:]
    r.blen, r.mlen, n_ambi, dp_max, r.is_spliced = native.update_extra_scan(
        qseq, tseq, p.cigar, mat, 5, q, e, log_gap)
    p.n_ambi += n_ambi
    p.dp_max = p.dp_max0 = dp_max
    if is_eqx:
        update_cigar_eqx(r, qseq, tseq)


def append_cigar(r: Reg, cigar):
    """mm_append_cigar (align.c:320-334)."""
    if not cigar:
        return
    if r.p is None:
        r.p = Extra()
    p = r.p
    if p.cigar and (p.cigar[-1] & 0xF) == (cigar[0] & 0xF):
        p.cigar[-1] += (cigar[0] >> 4) << 4
        p.cigar.extend(cigar[1:])
    else:
        p.cigar.extend(cigar)


def align_pair(opt, qseq, tseq, junc, mat, w, end_bonus, zdrop, ksw_flag,
               ez: K.ExtzResult):
    """mm_align_pair (align.c:336-368)."""
    qlen, tlen = len(qseq), len(tseq)
    dbg = opt.dbg_flag & MM_DBG_PRINT_ALN_SEQ
    if dbg:
        sys.stderr.write(
            f"===> q=({opt.q},{opt.q2}), e=({opt.e},{opt.e2}), bw={w}, "
            f"ksw_flag={ksw_flag}, zdrop={opt.zdrop}, "
            f"end_bonus={end_bonus} <===\n{_nt_str(tseq)}\n"
            f"{_nt_str(qseq)}\n")
    if opt.transition != 0 and opt.b != opt.transition:
        ksw_flag |= K.KSW_EZ_GENERIC_SC
    if opt.max_sw_mat > 0 and tlen * qlen > opt.max_sw_mat:
        ez.reset()
        ez.zdropped = True
    elif opt.flag & MM_F_SPLICE:
        if not (opt.flag & MM_F_SPLICE_OLD):
            ksw_flag |= K.KSW_EZ_SPLICE_CMPLX
        native.ksw_exts2(qlen, qseq, tlen, tseq, 5, mat, opt.q, opt.e, opt.q2,
                         opt.noncan, zdrop, end_bonus, opt.junc_bonus,
                         opt.junc_pen, ksw_flag, junc, ez)
    elif opt.q == opt.q2 and opt.e == opt.e2:
        native.ksw_extz2(qlen, qseq, tlen, tseq, 5, mat, opt.q, opt.e, w,
                         zdrop, end_bonus, ksw_flag, ez)
    else:
        native.ksw_extd2(qlen, qseq, tlen, tseq, 5, mat, opt.q, opt.e,
                         opt.q2, opt.e2, w, zdrop, end_bonus, ksw_flag, ez)
    if dbg:
        cig = "".join(f"{c >> 4}{MM_CIGAR_STR[c & 0xF]}" for c in ez.cigar)
        sys.stderr.write(f"score={ez.score}, cigar={cig}\n")
    return ez


def _nt_str(codes) -> str:
    """nt4 codes as ACGTN text (codes past 4 as N)."""
    c = np.minimum(np.asarray(codes, np.uint8), 4)
    return np.frombuffer(b"ACGTN", np.uint8)[c].tobytes().decode()


def get_hplen_back(mi, rid, x):
    """mm_get_hplen_back (align.c:409-416)."""
    s = mi.seq[rid]
    off0 = s.offset
    off = off0 + x
    c = mi.S[off]
    i = off - 1
    while i >= off0 and mi.S[i] == c:
        i -= 1
    return off - i


def adjust_minier(mi, qseq0, ax_i, ay_i):
    """mm_adjust_minier (align.c:418-433). Returns (r, q)."""
    if mi.flag & MM_I_HPC:
        qseq = qseq0[ax_i >> 63]
        qpos = I32(ay_i)
        i = qpos - 1
        c = qseq[qpos]
        while i > 0 and qseq[i] == c:
            i -= 1
        q = i + 1
        c2 = get_hplen_back(mi, (ax_i << 1 & 0xFFFFFFFFFFFFFFFF) >> 33, I32(ax_i))
        r = I32(ax_i) + 1 - c2
    else:
        r = I32(ax_i) - (mi.k >> 1)
        q = I32(ay_i) - (mi.k >> 1)
    return r, q


def collect_long_gaps(as1, cnt1, ax, ay, min_gap):
    """collect_long_gaps (align.c:435-452)."""
    qp = (ay[as1:as1 + cnt1] & np.uint64(0xFFFFFFFF)) \
        .astype(np.uint32).astype(np.int32).astype(np.int64)
    rp = (ax[as1:as1 + cnt1] & np.uint64(0xFFFFFFFF)) \
        .astype(np.uint32).astype(np.int32).astype(np.int64)
    gap = np.diff(qp) - np.diff(rp)
    Kl = (np.nonzero((gap < -min_gap) | (gap > min_gap))[0] + 1).tolist()
    if len(Kl) <= 1:
        return None
    return Kl


def filter_bad_seeds(as1, cnt1, ax, ay, min_gap, diff_thres, max_ext_len, max_ext_cnt):
    """mm_filter_bad_seeds (align.c:454-489). Mutates ay flags."""
    Kl = collect_long_gaps(as1, cnt1, ax, ay, min_gap)
    if Kl is None:
        return
    n = len(Kl)
    mx, max_st, max_en = 0, -1, -1
    k = 0
    while True:
        if k == n or k >= max_en:
            if max_en > 0:
                for i in range(Kl[max_st], Kl[max_en]):
                    ay[as1 + i] |= np.uint64(MM_SEED_IGNORE)
            mx, max_st, max_en = 0, -1, -1
            if k == n:
                break
        i = Kl[k]
        gap = (I32(int(ay[as1 + i])) - I32(int(ay[as1 + i - 1]))) - \
              I32(int(ax[as1 + i]) - int(ax[as1 + i - 1]))
        n_ins = gap if gap > 0 else 0
        n_del = -gap if gap <= 0 else 0
        qs = I32(int(ay[as1 + i - 1]))
        rs = I32(int(ax[as1 + i - 1]))
        max_diff, max_diff_l = 0, -1
        l = k + 1
        while l < n and l <= k + max_ext_cnt:
            j = Kl[l]
            if I32(int(ay[as1 + j])) - qs > max_ext_len or I32(int(ax[as1 + j])) - rs > max_ext_len:
                break
            gap = (I32(int(ay[as1 + j])) - I32(int(ay[as1 + j - 1]))) - \
                I32(int(ax[as1 + j]) - int(ax[as1 + j - 1]))
            if gap > 0:
                n_ins += gap
            else:
                n_del += -gap
            diff = n_ins + n_del - abs(n_ins - n_del)
            if max_diff < diff:
                max_diff, max_diff_l = diff, l
            l += 1
        if max_diff > diff_thres and max_diff > mx:
            mx, max_st, max_en = max_diff, k, max_diff_l
        k += 1


def filter_bad_seeds_alt(as1, cnt1, ax, ay, min_gap, max_ext):
    """mm_filter_bad_seeds_alt (align.c:491-525). Mutates ay flags."""
    Kl = collect_long_gaps(as1, cnt1, ax, ay, min_gap)
    if Kl is None:
        return
    n = len(Kl)
    k = 0
    while k < n:
        i = Kl[k]
        gap1 = (I32(int(ay[as1 + i])) - I32(int(ay[as1 + i - 1]))) - \
               (I32(int(ax[as1 + i])) - I32(int(ax[as1 + i - 1])))
        re1 = I32(int(ax[as1 + i]))
        qe1 = I32(int(ay[as1 + i]))
        gap1 = abs(gap1)
        l = k + 1
        while l < n:
            j = Kl[l]
            if I32(int(ay[as1 + j])) - qe1 > max_ext or I32(int(ax[as1 + j])) - re1 > max_ext:
                break
            gap2 = (I32(int(ay[as1 + j])) - I32(int(ay[as1 + j - 1]))) - \
                I32(int(ax[as1 + j]) - int(ax[as1 + j - 1]))
            q_span_pre = (int(ay[as1 + j - 1]) >> 32) & 0xFF
            rs2 = I32(int(ax[as1 + j - 1])) + q_span_pre
            qs2 = I32(int(ay[as1 + j - 1])) + q_span_pre
            m = min(rs2 - re1, qs2 - qe1)
            gap2 = abs(gap2)
            if m > gap1 + gap2:
                break
            re1 = I32(int(ax[as1 + j]))
            qe1 = I32(int(ay[as1 + j]))
            gap1 = gap2
            l += 1
        if l > k + 1:
            end = Kl[l - 1]
            for j in range(Kl[k], end):
                ay[as1 + j] |= np.uint64(MM_SEED_IGNORE)
            ay[as1 + end] |= np.uint64(MM_SEED_LONG_JOIN)
        k = l
    return


def fix_bad_ends(r: Reg, ax, ay, bw, min_match):
    """mm_fix_bad_ends (align.c:527-561). Returns (as1, cnt1)."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 3:
        return as_, cnt
    m = l = (int(ay[r.as_]) >> 32) & 0xFF
    for i in range(r.as_ + 1, r.as_ + r.cnt - 1):
        q_span = (int(ay[i]) >> 32) & 0xFF
        if int(ay[i]) & MM_SEED_LONG_JOIN:
            break
        lr = I32(int(ax[i])) - I32(int(ax[i - 1]))
        lq = I32(int(ay[i])) - I32(int(ay[i - 1]))
        mn, mx = min(lr, lq), max(lr, lq)
        if mx - mn > l >> 1:
            as_ = i
        l += mn
        m += min(mn, q_span)
        if l >= bw << 1 or (m >= min_match and m >= bw) or m >= r.mlen >> 1:
            break
    cnt = r.as_ + r.cnt - as_
    m = l = (int(ay[r.as_ + r.cnt - 1]) >> 32) & 0xFF
    for i in range(r.as_ + r.cnt - 2, as_, -1):
        q_span = (int(ay[i + 1]) >> 32) & 0xFF
        if int(ay[i + 1]) & MM_SEED_LONG_JOIN:
            break
        lr = I32(int(ax[i + 1])) - I32(int(ax[i]))
        lq = I32(int(ay[i + 1])) - I32(int(ay[i]))
        mn, mx = min(lr, lq), max(lr, lq)
        if mx - mn > l >> 1:
            cnt = i + 1 - as_
        l += mn
        m += min(mn, q_span)
        if l >= bw << 1 or (m >= min_match and m >= bw) or m >= r.mlen >> 1:
            break
    return as_, cnt


def max_stretch(r: Reg, ax, ay):
    """mm_max_stretch (align.c:563-589)."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 2:
        return as_, cnt
    max_score, max_i, max_len = -1, -1, 0
    score = (int(ay[r.as_]) >> 32) & 0xFF
    ln = 1
    i = r.as_ + 1
    for i in range(r.as_ + 1, r.as_ + r.cnt):
        q_span = (int(ay[i]) >> 32) & 0xFF
        lr = I32(int(ax[i])) - I32(int(ax[i - 1]))
        lq = I32(int(ay[i])) - I32(int(ay[i - 1]))
        if lq == lr:
            score += min(lq, q_span)
            ln += 1
        else:
            if score > max_score:
                max_score, max_len, max_i = score, ln, i - ln
            score, ln = q_span, 1
    i = r.as_ + r.cnt
    if score > max_score:
        max_score, max_len, max_i = score, ln, i - ln
    return max_i, max_len


def seed_ext_score(opt, mi, mat, qlen, qseq0, ax_i, ay_i):
    """mm_seed_ext_score (align.c:591-616)."""
    q_span = (ay_i >> 32) & 0xFF
    rid = (ax_i << 1 & 0xFFFFFFFFFFFFFFFF) >> 33
    re = (ax_i & 0xFFFFFFFF) + 1
    rs = re - q_span
    qe = (ay_i & 0xFFFFFFFF) + 1
    qs = qe - q_span
    ext_len = opt.anchor_ext_len
    rs = max(rs - ext_len, 0)
    qs = max(qs - ext_len, 0)
    re = min(re + ext_len, mi.seq[rid].length)
    qe = min(qe + ext_len, qlen)
    if opt.flag & MM_F_QSTRAND:
        qseq = qseq0[0][qs:qe]
        tseq = mi.getseq(rid, rs, re, rev=bool(ax_i >> 63))
    else:
        qseq = qseq0[ax_i >> 63][qs:qe]
        tseq = mi.getseq(rid, rs, re)
    score, _, _ = native.ksw_ll(qe - qs, qseq, re - rs, tseq, 5, mat, opt.q, opt.e)
    return score


def fix_bad_ends_splice(opt, mi, r: Reg, mat, qlen, qseq0, ax, ay):
    """mm_fix_bad_ends_splice (align.c:618-636)."""
    as1, cnt1 = r.as_, r.cnt
    if r.cnt < 3:
        return as1, cnt1
    log_gap = math.log(I32(int(ax[r.as_ + 1])) - I32(int(ax[r.as_])))
    if ((int(ay[r.as_]) >> 32) & 0xFF) < log_gap + opt.anchor_ext_shift:
        score = seed_ext_score(opt, mi, mat, qlen, qseq0, int(ax[r.as_]), int(ay[r.as_]))
        if score / mat[0] < log_gap + opt.anchor_ext_shift:
            as1 += 1
            cnt1 -= 1
    log_gap = math.log(I32(int(ax[r.as_ + r.cnt - 1])) - I32(int(ax[r.as_ + r.cnt - 2])))
    if ((int(ay[r.as_ + r.cnt - 1]) >> 32) & 0xFF) < log_gap + opt.anchor_ext_shift:
        score = seed_ext_score(opt, mi, mat, qlen, qseq0,
                               int(ax[r.as_ + r.cnt - 1]), int(ay[r.as_ + r.cnt - 1]))
        if score / mat[0] < log_gap + opt.anchor_ext_shift:
            cnt1 -= 1
    return as1, cnt1


def get_junc(mi, ctg, st, en, rev):
    """mm_get_junc (align.c:638-643): the --spsc scores, else the
    --junc-bed donor/acceptor flags, else none."""
    if mi.spsc is not None:
        return mi.spsc.get(ctg, st, en, rev)
    if mi.intervals is not None:
        return mi.intervals.junc(ctg, st, en)
    return np.zeros(en - st, dtype=np.uint8)


def align1(opt, mi, qlen, qseq0, r: Reg, n_a, ax, ay, splice_flag):
    """mm_align1 (align.c:645-914). Returns r2 (tail) or None."""
    is_sr = bool(opt.flag & MM_F_SR)
    is_splice = bool(opt.flag & MM_F_SPLICE)
    is_sr_rna = bool(opt.flag & MM_F_SR_RNA) and is_splice
    r2 = None
    if r.cnt == 0:
        return None
    rid = (int(ax[r.as_]) << 1 & 0xFFFFFFFFFFFFFFFF) >> 33
    rev = int(ax[r.as_]) >> 63
    mat = gen_ts_mat(5, opt.a, opt.b, opt.transition, opt.sc_ambi)
    bw = int(opt.bw * 1.5 + 1.0)
    bw_long = int(opt.bw_long * 1.5 + 1.0)
    if bw_long < bw:
        bw_long = bw
    ez = K.ExtzResult()

    if is_sr and not (mi.flag & MM_I_HPC):
        as1, cnt1 = max_stretch(r, ax, ay)
        span1 = (int(ay[as1]) >> 32) & 0xFF
        rs = I32(int(ax[as1])) + 1 - span1
        qs = I32(int(ay[as1])) + 1 - span1
        re = I32(int(ax[as1 + cnt1 - 1])) + 1
        qe = I32(int(ay[as1 + cnt1 - 1])) + 1
    else:
        if not (opt.flag & MM_F_NO_END_FLT):
            if is_splice:
                as1, cnt1 = fix_bad_ends_splice(opt, mi, r, mat, qlen, qseq0, ax, ay)
            else:
                as1, cnt1 = fix_bad_ends(r, ax, ay, opt.bw, opt.min_chain_score * 2)
        else:
            as1, cnt1 = r.as_, r.cnt
        filter_bad_seeds(as1, cnt1, ax, ay, 10, 40, opt.max_gap >> 1, 10)
        filter_bad_seeds_alt(as1, cnt1, ax, ay, 30, opt.max_gap >> 1)
        rs, qs = adjust_minier(mi, qseq0, int(ax[as1]), int(ay[as1]))
        re, qe = adjust_minier(mi, qseq0, int(ax[as1 + cnt1 - 1]), int(ay[as1 + cnt1 - 1]))
    assert cnt1 > 0

    ksw_flag = 0
    if is_splice:
        if splice_flag & MM_F_SPLICE_FOR:
            ksw_flag |= K.KSW_EZ_SPLICE_REV if rev else K.KSW_EZ_SPLICE_FOR
        if splice_flag & MM_F_SPLICE_REV:
            ksw_flag |= K.KSW_EZ_SPLICE_FOR if rev else K.KSW_EZ_SPLICE_REV
        if opt.flag & MM_F_SPLICE_FLANK:
            ksw_flag |= K.KSW_EZ_SPLICE_FLANK
        if mi.spsc is not None:
            ksw_flag |= K.KSW_EZ_SPLICE_SCORE

    tlen_rid = mi.seq[rid].length
    if is_sr:
        qs0, qe0 = 0, qlen
        l = qs
        l += (l * opt.a + opt.end_bonus - opt.q) // opt.e if l * opt.a + opt.end_bonus > opt.q else 0
        rs0 = rs - l if rs - l > 0 else 0
        l = qlen - qe
        l += (l * opt.a + opt.end_bonus - opt.q) // opt.e if l * opt.a + opt.end_bonus > opt.q else 0
        re0 = re + l if re + l < tlen_rid else tlen_rid
    else:
        span0 = (int(ay[r.as_]) >> 32) & 0xFF
        rs0 = I32(int(ax[r.as_])) + 1 - span0
        qs0 = I32(int(ay[r.as_])) + 1 - span0
        if rs0 < 0:
            rs0 = 0
        assert qs0 >= 0
        rs1 = qs1 = 0
        l = 0
        i = r.as_ - 1
        while i >= 0 and (int(ax[i]) >> 32) == (int(ax[r.as_]) >> 32):
            span_i = (int(ay[i]) >> 32) & 0xFF
            x = I32(int(ax[i])) + 1 - span_i
            yv = I32(int(ay[i])) + 1 - span_i
            if x < rs0 and yv < qs0:
                l += 1
                if l > opt.min_cnt:
                    l = max(rs0 - x, qs0 - yv)
                    rs1, qs1 = rs0 - l, qs0 - l
                    if rs1 < 0:
                        rs1 = 0
                    break
            i -= 1
        if qs > 0 and rs > 0:
            l = min(qs, opt.max_gap)
            qs1 = max(qs1, qs - l)
            qs0 = min(qs0, qs1)
            l += (l * opt.a - opt.q) // opt.e if l * opt.a > opt.q else 0
            l = min(l, opt.max_gap)
            l = min(l, rs)
            rs1 = max(rs1, rs - l)
            rs0 = min(rs0, rs1)
            rs0 = min(rs0, rs)
        else:
            rs0, qs0 = rs, qs
        re0 = I32(int(ax[r.as_ + r.cnt - 1])) + 1
        qe0 = I32(int(ay[r.as_ + r.cnt - 1])) + 1
        re1, qe1 = tlen_rid, qlen
        l = 0
        i = r.as_ + r.cnt
        while i < n_a and (int(ax[i]) >> 32) == (int(ax[r.as_]) >> 32):
            x = I32(int(ax[i])) + 1
            yv = I32(int(ay[i])) + 1
            if x > re0 and yv > qe0:
                l += 1
                if l > opt.min_cnt:
                    l = max(x - re0, yv - qe0)
                    re1, qe1 = re0 + l, qe0 + l
                    break
            i += 1
        if qe < qlen and re < tlen_rid:
            l = min(qlen - qe, opt.max_gap)
            qe1 = min(qe1, qe + l)
            qe0 = max(qe0, qe1)
            l += (l * opt.a - opt.q) // opt.e if l * opt.a > opt.q else 0
            l = min(l, opt.max_gap)
            l = min(l, tlen_rid - re)
            re1 = min(re1, re + l)
            re0 = max(re0, re1)
        else:
            re0, qe0 = re, qe
    if int(ay[r.as_]) & MM_SEED_SELF:
        max_ext = abs(r.qs - r.rs)
        if r.rs - rs0 > max_ext:
            rs0 = r.rs - max_ext
        if r.qs - qs0 > max_ext:
            qs0 = r.qs - max_ext
        max_ext = abs(r.qe - r.re)
        if re0 - r.re > max_ext:
            re0 = r.re + max_ext
        if qe0 - r.qe > max_ext:
            qe0 = r.qe + max_ext

    assert re0 > rs0
    is_qstrand = bool(opt.flag & MM_F_QSTRAND)
    dropped = False
    zdrop_code = 0

    def getq(a, b_):
        if is_qstrand:
            return qseq0[0][a:b_]
        return qseq0[rev][a:b_]

    def gett(a, b_):
        if is_qstrand:
            return mi.getseq(rid, a, b_, rev=bool(rev))
        return mi.getseq(rid, a, b_)

    if qs > 0 and rs > 0:  # left extension
        qseq = getq(qs0, qs)[::-1].copy()
        tseq = gett(rs0, rs)[::-1].copy()
        junc = get_junc(mi, rid, rs0, rs, bool(ksw_flag & K.KSW_EZ_SPLICE_REV))[::-1].copy()
        align_pair(opt, qseq, tseq, junc, mat, bw, opt.end_bonus,
                   opt.zdrop_inv if r.split_inv else opt.zdrop,
                   ksw_flag | K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT | K.KSW_EZ_REV_CIGAR, ez)
        if ez.n_cigar > 0:
            append_cigar(r, ez.cigar)
            r.p.dp_score += ez.max
        rs1 = rs - (ez.mqe_t + 1 if ez.reach_end else ez.max_t + 1)
        qs1 = qs - (qs - qs0 if ez.reach_end else ez.max_q + 1)
    else:
        rs1, qs1 = rs, qs
    re1, qe1 = rs, qs
    assert qs1 >= 0 and rs1 >= 0

    i = cnt1 - 1 if is_sr else 1
    while i < cnt1:  # gap filling
        if (int(ay[as1 + i]) & (MM_SEED_IGNORE | MM_SEED_TANDEM)) and i != cnt1 - 1:
            i += 1
            continue
        if is_sr and not (mi.flag & MM_I_HPC):
            re = I32(int(ax[as1 + i])) + 1
            qe = I32(int(ay[as1 + i])) + 1
        else:
            re, qe = adjust_minier(mi, qseq0, int(ax[as1 + i]), int(ay[as1 + i]))
        re1, qe1 = re, qe
        if i == cnt1 - 1 or (int(ay[as1 + i]) & MM_SEED_LONG_JOIN) or \
                (qe - qs >= opt.min_ksw_len and re - rs >= opt.min_ksw_len):
            bw1 = bw_long
            if int(ay[as1 + i]) & MM_SEED_LONG_JOIN:
                bw1 = max(qe - qs, re - rs)
            qseq = getq(qs, qe)
            tseq = gett(rs, re)
            junc = get_junc(mi, rid, rs, re, bool(ksw_flag & K.KSW_EZ_SPLICE_REV))
            if is_sr or (is_sr_rna and qe - qs == re - rs):
                max_gapped_score = (qe - qs - 2) * opt.a - 2 * (opt.q + opt.e)
                assert qe - qs == re - rs
                ez.reset()
                sc = 0
                for j in range(qe - qs):
                    if qseq[j] >= 4 or tseq[j] >= 4:
                        sc += -opt.sc_ambi if opt.sc_ambi > 0 else opt.sc_ambi
                    else:
                        sc += opt.a if qseq[j] == tseq[j] else -opt.b
                ez.score = sc
                if ez.score > max_gapped_score:
                    ez.cigar = []
                    K.push_cigar(ez.cigar, CIG_M, qe - qs)
                else:
                    align_pair(opt, qseq, tseq, junc, mat, bw1, -1, opt.zdrop,
                               ksw_flag | K.KSW_EZ_APPROX_MAX, ez)
            elif not (is_sr_rna and align_sr_rna(
                    opt, qseq, tseq, junc, mat, bw1, -1, opt.zdrop,
                    ksw_flag | K.KSW_EZ_APPROX_MAX, ez)):
                align_pair(opt, qseq, tseq, junc, mat, bw1, -1, opt.zdrop,
                           ksw_flag | K.KSW_EZ_APPROX_MAX, ez)
            zdrop_code = test_zdrop(opt, qseq, tseq, ez.cigar, mat)
            if zdrop_code != 0:
                align_pair(opt, qseq, tseq, junc, mat, bw1, -1,
                           opt.zdrop_inv if zdrop_code == 2 else opt.zdrop,
                           ksw_flag, ez)
            if ez.n_cigar > 0:
                append_cigar(r, ez.cigar)
            if ez.zdropped:
                if r.p is None:
                    r.p = Extra()
                j = i - 1
                while j >= 0:
                    if I32(int(ax[as1 + j])) <= rs + ez.max_t:
                        break
                    j -= 1
                dropped = True
                if j < 0:
                    j = 0
                r.p.dp_score += ez.max
                re1 = rs + (ez.max_t + 1)
                qe1 = qs + (ez.max_q + 1)
                if cnt1 - (j + 1) >= opt.min_cnt:
                    r2 = hitmod.split_reg(r, as1 + j + 1 - r.as_, qlen, ax, ay, is_qstrand)
                    if r2 is not None and zdrop_code == 2:
                        r2.split_inv = True
                break
            else:
                r.p.dp_score += ez.score
            rs, qs = re, qe
        i += 1

    if not dropped and qe < qe0 and re < re0:  # right extension
        qseq = getq(qe, qe0)
        tseq = gett(re, re0)
        junc = get_junc(mi, rid, re, re0, bool(ksw_flag & K.KSW_EZ_SPLICE_REV))
        align_pair(opt, qseq, tseq, junc, mat, bw, opt.end_bonus, opt.zdrop,
                   ksw_flag | K.KSW_EZ_EXTZ_ONLY, ez)
        if ez.n_cigar > 0:
            append_cigar(r, ez.cigar)
            r.p.dp_score += ez.max
        re1 = re + (ez.mqe_t + 1 if ez.reach_end else ez.max_t + 1)
        qe1 = qe + (qe0 - qe if ez.reach_end else ez.max_q + 1)
    assert qe1 <= qlen

    r.rs, r.re = rs1, re1
    if not rev or is_qstrand:
        r.qs, r.qe = qs1, qe1
    else:
        r.qs, r.qe = qlen - qe1, qlen - qs1

    assert re1 - rs1 <= re0 - rs0
    if r.p is not None:
        if is_qstrand:
            tseq = mi.getseq(rid, rs1, re1, rev=bool(r.rev))
            qseq = qseq0[0][qs1:]
        else:
            tseq = mi.getseq(rid, rs1, re1)
            qseq = qseq0[1 if r.rev else 0][qs1:]
        update_extra(r, qseq, tseq, mat, opt.q, opt.e,
                     bool(opt.flag & MM_F_EQX), not (is_sr or is_sr_rna))
        if rev and r.p.trans_strand:
            r.p.trans_strand ^= 3
    return r2


def align1_inv(opt, mi, qlen, qseq0, r1: Reg, r2: Reg):
    """mm_align1_inv (align.c:916-971). Returns Reg or None."""
    if not (r1.split & 1) or not (r2.split & 2):
        return None
    if r1.id != r1.parent and r1.parent != MM_PARENT_TMP_PRI:
        return None
    if r2.id != r2.parent and r2.parent != MM_PARENT_TMP_PRI:
        return None
    if r1.rid != r2.rid or r1.rev != r2.rev:
        return None
    ql = r1.qs - r2.qe if r1.rev else r2.qs - r1.qe
    tl = r2.rs - r1.re
    if ql < opt.min_chain_score or ql > opt.max_gap:
        return None
    if tl < opt.min_chain_score or tl > opt.max_gap:
        return None
    mat = gen_ts_mat(5, opt.a, opt.b, opt.transition, opt.sc_ambi)
    tseq = mi.getseq(r1.rid, r1.re, r2.rs)
    if r1.rev:
        qseq = qseq0[0][r2.qe:r2.qe + ql]
    else:
        qseq = qseq0[1][qlen - r2.qs:qlen - r2.qs + ql]
    qseq_r = qseq[::-1].copy()
    tseq_r = tseq[::-1].copy()
    score, q_off, t_off = native.ksw_ll(ql, qseq_r, tl, tseq_r, 5, mat, opt.q, opt.e)
    if score < opt.min_dp_max:
        return None
    q_off = ql - (q_off + 1)
    t_off = tl - (t_off + 1)
    ez = K.ExtzResult()
    align_pair(opt, qseq[q_off:], tseq[t_off:], None, mat,
               int(opt.bw * 1.5), -1, opt.zdrop, K.KSW_EZ_EXTZ_ONLY, ez)
    if ez.n_cigar == 0:
        return None
    r_inv = Reg()
    append_cigar(r_inv, ez.cigar)
    r_inv.p.dp_score = ez.max
    r_inv.id = -1
    r_inv.parent = MM_PARENT_UNSET
    r_inv.inv = True
    r_inv.rev = not r1.rev
    r_inv.rid = r1.rid
    r_inv.div = -1.0
    if not r_inv.rev:
        r_inv.qs = r2.qe + q_off
        r_inv.qe = r_inv.qs + ez.max_q + 1
    else:
        r_inv.qe = r2.qs - q_off
        r_inv.qs = r_inv.qe - (ez.max_q + 1)
    r_inv.rs = r1.re + t_off
    r_inv.re = r_inv.rs + ez.max_t + 1
    update_extra(r_inv, qseq[q_off:], tseq[t_off:], mat, opt.q, opt.e,
                 bool(opt.flag & MM_F_EQX),
                 not (opt.flag & (MM_F_SR | MM_F_SR_RNA)))
    return r_inv


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


def _recal_max_dp(r: Reg, b2: float, match_sc: int) -> int:
    """mm_recal_max_dp (align.c:1005-1020)."""
    if r.p is None:
        return -1
    n_gap = 0
    gap_cost = 0.0
    for c in r.p.cigar:
        op, ln = c & 0xF, c >> 4
        if op in (CIG_I, CIG_D):
            gap_cost += b2 + float(mg_log2(np.float32(1.0 + ln)))
            n_gap += ln
    n_mis = r.blen + r.p.n_ambi - r.mlen - n_gap
    return int(match_sc * (r.mlen - b2 * n_mis - gap_cost) + 0.499)


def update_dp_max(qlen, regs, frac, a, b):
    """mm_update_dp_max (align.c:1022-1046)."""
    if len(regs) < 2:
        return
    mx, mx2, max_i = -1, -1, -1
    for i, r in enumerate(regs):
        if r.p is None:
            continue
        if r.p.dp_max > mx:
            mx2, mx, max_i = mx, r.p.dp_max, i
        elif r.p.dp_max > mx2:
            mx2 = r.p.dp_max
    if max_i < 0 or mx < 0 or mx2 < 0:
        return
    if regs[max_i].qe - regs[max_i].qs < qlen * frac:
        return
    if mx2 < mx * frac:
        return
    div = 1.0 - event_identity(regs[max_i])
    if div < 0.02:
        div = 0.02
    b2 = 0.5 / div
    if b2 * a < b:
        b2 = a / b
    for r in regs:
        if r.p is None:
            continue
        r.p.dp_max = max(_recal_max_dp(r, b2, a), 0)


def align_skeleton(opt, mi, qlen, qstr, regs, ax, ay):
    """mm_align_skeleton (align.c:1048-1120)."""
    if isinstance(qstr, (bytes, str)):
        fwd = SEQ_NT4[np.frombuffer(qstr.encode() if isinstance(qstr, str) else qstr,
                                    dtype=np.uint8)]
    else:
        fwd = np.asarray(qstr, dtype=np.uint8)
    rev_ = fwd[::-1]
    rev_ = np.where(rev_ < 4, 3 - rev_, rev_).astype(np.uint8)
    qseq0 = [fwd.copy(), rev_.copy()]

    ax, ay = hitmod.squeeze_a(regs, ax, ay)
    n_a = len(ax)
    i = 0
    while i < len(regs):
        r2 = None
        if (opt.flag & MM_F_SPLICE) and (opt.flag & MM_F_SPLICE_FOR) and (opt.flag & MM_F_SPLICE_REV):
            s0 = copy.copy(regs[i])
            s1 = copy.copy(regs[i])
            # NB: seed-flag mutations on ay persist across both rounds, as in C
            s2_0 = align1(opt, mi, qlen, qseq0, s0, n_a, ax, ay, MM_F_SPLICE_FOR)
            if (opt.flag & MM_F_SR_RNA) and regs[i].qe - regs[i].qs == regs[i].re - regs[i].rs \
                    and s0.qe - s0.qs == s0.re - s0.rs and s0.qs == 0 and s0.qe == qlen:
                regs[i] = s0
                r2 = s2_0
                regs[i].p.trans_strand = 0
            else:
                s2_1 = align1(opt, mi, qlen, qseq0, s1, n_a, ax, ay, MM_F_SPLICE_REV)
                if s0.p.dp_score > s1.p.dp_score:
                    which, trans_strand = 0, 1
                elif s0.p.dp_score < s1.p.dp_score:
                    which, trans_strand = 1, 2
                else:
                    trans_strand = 3
                    which = (qlen + s0.p.dp_score) & 1
                if which == 0:
                    regs[i] = s0
                    r2 = s2_0
                else:
                    regs[i] = s1
                    r2 = s2_1
                r = regs[i]
                r.p.trans_strand = trans_strand
                if r.is_spliced:
                    if trans_strand in (1, 2):
                        r.p.dp_max += (opt.a + opt.b) + ((opt.a + opt.b) >> 1)
                    elif trans_strand == 3:
                        r.p.dp_max -= opt.a + opt.b
        else:
            r2 = align1(opt, mi, qlen, qseq0, regs[i], n_a, ax, ay, opt.flag)
            if opt.flag & MM_F_SPLICE:
                regs[i].p.trans_strand = 1 if opt.flag & MM_F_SPLICE_FOR else 2
        if r2 is not None and r2.cnt > 0:
            regs.insert(i + 1, r2)
        if i > 0 and regs[i].split_inv and not (opt.flag & MM_F_NO_INV):
            r_inv = align1_inv(opt, mi, qlen, qseq0, regs[i - 1], regs[i])
            if r_inv is not None:
                regs.insert(i + 1, r_inv)  # mm_insert_reg puts it after regs[i]
                i += 1  # skip the inserted INV alignment
        i += 1
    regs = hitmod.filter_regs(regs, opt, qlen)
    if not (opt.flag & (MM_F_SR | MM_F_SR_RNA | MM_F_ALL_CHAINS)) \
            and not opt.split_prefix and qlen >= opt.rank_min_len:
        update_dp_max(qlen, regs, opt.rank_frac, opt.a, opt.b)
        regs = hitmod.filter_regs(regs, opt, qlen)
    regs = hitmod.hit_sort(regs, opt.alt_drop)
    return regs
