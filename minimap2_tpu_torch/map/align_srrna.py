"""Short-RNA one-intron alignment heuristic (copy of
minimap2_tpu.map.align_srrna: mm_align_sr_rna, reference align.c:370-407),
with the splice DP through the C++ exts2 of native/.

When a short read's ends both match the target gap's flanks exactly, the
middle is bridged with a synthetic target (flank | N-fill | flank) and one
splice DP finds the single intron directly; the resulting N length is then
rescaled to the true gap.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..config import MM_F_SPLICE, MM_F_SPLICE_OLD
from ..ops.ksw2_np import KSW_EZ_SPLICE_CMPLX

MM_MAX_QLEN_FLANK = 100
CIG_M, CIG_I, CIG_N = 0, 1, 3


def align_sr_rna(opt, qseq, tseq, junc, mat, w, end_bonus, zdrop, ksw_flag,
                 ez) -> bool:
    """Returns True when the heuristic produced the alignment (skip the
    full-window splice DP)."""
    qlen, tlen = len(qseq), len(tseq)
    ilen = opt.q2 * 2
    tlen2 = qlen * 2 + ilen
    if not (opt.flag & MM_F_SPLICE):
        return False
    if qlen > MM_MAX_QLEN_FLANK or qlen * 2 + ilen > tlen:
        return False
    ll = int(np.sum((qseq == tseq[:qlen]) & (qseq < 4)))
    tail_t = tseq[tlen - qlen:]
    lr = int(np.sum((qseq[::-1] == tail_t[::-1]) & (qseq[::-1] < 4)))
    if qlen - (ll + lr) > 9:
        return False
    tseq2 = np.empty(tlen2, np.uint8)
    tseq2[:qlen] = tseq[:qlen]
    tseq2[qlen:qlen + ilen] = 4
    tseq2[qlen + ilen:] = tseq[tlen - qlen:]
    junc2 = None
    if junc is not None:
        junc2 = np.zeros(tlen2, np.uint8)
        junc2[:qlen] = junc[:qlen]
        junc2[qlen + ilen:] = junc[tlen - qlen:]
    if not (opt.flag & MM_F_SPLICE_OLD):
        ksw_flag |= KSW_EZ_SPLICE_CMPLX
    native.ksw_exts2(qlen, qseq, tlen2, tseq2, 5, mat, opt.q, opt.e, opt.q2,
                     opt.noncan, zdrop, end_bonus, opt.junc_bonus,
                     opt.junc_pen, ksw_flag, junc2, ez)
    if ez.zdropped or not ez.cigar:
        return False
    if (ez.cigar[0] & 0xF) != CIG_M or (ez.cigar[-1] & 0xF) != CIG_M:
        return False
    nn = sum(1 for c in ez.cigar if (c & 0xF) == CIG_N)
    n_ins = sum(1 for c in ez.cigar if (c & 0xF) == CIG_I)
    if nn != 1 or n_ins > 0:
        return False
    for i, c in enumerate(ez.cigar):
        if (c & 0xF) == CIG_N:
            ez.cigar[i] = c + ((tlen - tlen2) << 4)
    return True
