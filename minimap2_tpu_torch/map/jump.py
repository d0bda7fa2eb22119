"""Annotation-guided splice jump refinement (copy of minimap2_tpu.map.jump;
reference jump.c:1-201).

After base alignment, clipped read ends are extended through annotated
junctions (-j/--jump or --pass1 BED) by an exact-match test, prepending or
appending M-N-M to the CIGAR.  Powers the two-pass short-RNA flow
(--write-junc then --pass1).
"""
from __future__ import annotations

import numpy as np

from ..config import MM_F_EQX
from ..utils.intfloat import SEQ_NT4

MM_MIN_EXON_LEN = 20
MM_CIGAR_MATCH, MM_CIGAR_N_SKIP = 0, 3
MM_JUNC_ANNO, MM_JUNC_MISC = 0x1, 0x2


def _jump_check(mi, qlen, r, ext, is_left):
    """mm_jump_check (jump.c:7-22)."""
    e = int(not r.rev) ^ int(not is_left)
    if r.p is None or not r.p.cigar:
        return -1
    clip = r.qs if e == 0 else qlen - r.qe
    cigar = r.p.cigar[0] if is_left else r.p.cigar[-1]
    clen = cigar >> 4 if (cigar & 0xF) == MM_CIGAR_MATCH else 0
    if clen <= ext:
        return -1
    if is_left:
        if clip >= r.rs:
            return -1
    else:
        if clip >= mi.seq[r.rid].length - r.re:
            return -1
    return 0


def _get_qseq(qlen, qseq0, r, is_left, ql0):
    """mm_jump_get_qseq_seq (jump.c:24-49)."""
    codes = SEQ_NT4[np.frombuffer(qseq0, np.uint8)]
    if not r.rev:
        seg = codes[:ql0] if is_left else codes[qlen - ql0:]
        return seg.copy()
    if is_left:
        seg = codes[qlen - ql0:][::-1]
    else:
        seg = codes[:ql0][::-1]
    return np.where(seg >= 4, seg, 3 - seg).astype(np.uint8)


def _mismatches(q, t):
    return int(np.sum((q != t) | (q > 3) | (t > 3)))


def _apply_exon(r, i0_rec, clip, l, mm0, opt, qlen, left):
    off, off2 = i0_rec[0], i0_rec[1]
    if left:
        r.p.cigar[0:0] = [((clip + l) << 4) | MM_CIGAR_MATCH,
                          ((off - off2) << 4) | MM_CIGAR_N_SKIP]
        r.p.cigar[2] = (((r.p.cigar[2] >> 4) - l) << 4) | MM_CIGAR_MATCH
        r.rs = off2 - (clip + l)
        if not r.rev:
            r.qs = 0
        else:
            r.qe = qlen
    else:
        r.p.cigar[-1] = (((r.p.cigar[-1] >> 4) - l) << 4) | MM_CIGAR_MATCH
        r.p.cigar.extend([((off2 - off) << 4) | MM_CIGAR_N_SKIP,
                          ((clip + l) << 4) | MM_CIGAR_MATCH])
        r.re = off2 + (clip + l)
        if not r.rev:
            r.qe = qlen
        else:
            r.qs = 0
    r.blen += clip
    r.mlen += clip - mm0
    r.p.dp_max0 += (clip - mm0) * opt.a - mm0 * opt.b
    r.p.dp_max += (clip - mm0) * opt.a - mm0 * opt.b
    if not r.is_spliced:
        r.is_spliced = True
        r.p.dp_max += (opt.a + opt.b) + ((opt.a + opt.b) >> 1)


def _jump_split_side(mi, opt, qlen, qseq0, r, ts_strand, left: bool):
    """mm_jump_split_left/right (jump.c:51-121 / :123-196)."""
    ext = 1 + (opt.b + opt.a - 1) // opt.a + 1
    clip = (r.qs if not r.rev else qlen - r.qe) if left \
        else (qlen - r.qe if not r.rev else r.qs)
    extt = min(clip, ext)
    if _jump_check(mi, qlen, r, ext + MM_MIN_EXON_LEN, 1 if left else 0) < 0:
        return
    if left:
        a = mi.jumps.get(r.rid, r.rs - extt, r.rs + ext)
    else:
        a = mi.jumps.get(r.rid, r.re - ext, r.re + extt)
    if not a:
        return
    qseq = None
    i0_anno = i0_misc = -1
    n_anno = n_misc = 0
    mm0_anno = mm0_misc = 0
    for i, ai in enumerate(a):
        off, off2, cnt, strand, flag = ai
        if ts_strand * strand < 0:
            continue
        if left:
            if off2 >= off or off - off2 < 6 or off2 < clip + ext:
                continue
        else:
            if off2 <= off or off2 - off < 6 \
                    or off2 + clip + ext > mi.seq[r.rid].length:
                continue
        if qseq is None:
            qseq = _get_qseq(qlen, qseq0, r, 1 if left else 0, clip + ext)
        if left:
            tl1 = clip + (off - r.rs)
            tseq = np.concatenate([
                mi.getseq(r.rid, off2 - tl1, off2),
                mi.getseq(r.rid, off, r.rs + ext)])
            mm1 = _mismatches(qseq[:tl1], tseq[:tl1])
            mm2 = _mismatches(qseq[tl1:], tseq[tl1:])
        else:
            tl1 = clip + (r.re - off)
            tseq = np.concatenate([
                mi.getseq(r.rid, r.re - ext, off),
                mi.getseq(r.rid, off2, off2 + tl1)])
            split = clip + ext - tl1
            mm2 = _mismatches(qseq[:split], tseq[:split])
            mm1 = _mismatches(qseq[split:], tseq[split:])
        if mm1 == 0 and mm2 <= 1:
            if flag & MM_JUNC_ANNO:
                if left or i0_anno < 0:
                    i0_anno, mm0_anno = i, mm1 + mm2
                n_anno += 1
            else:
                if left or i0_misc < 0:
                    i0_misc, mm0_misc = i, mm1 + mm2
                n_misc += 1
    if n_anno > 0:
        m, i0, mm0 = n_anno, i0_anno, mm0_anno
    else:
        m, i0, mm0 = n_misc, i0_misc, mm0_misc
    if left:
        l = a[i0][0] - r.rs if m > 0 else 0
    else:
        l = r.re - a[i0][0] if m > 0 else 0
    if m == 1 and clip + l >= opt.jump_min_match:
        _apply_exon(r, a[i0], clip, l, mm0, opt, qlen, left)
    elif m > 0 and ((left and a[i0][0] > r.rs)
                    or (not left and r.re > a[i0][0])):
        if left:
            r.p.cigar[0] -= (l << 4) | MM_CIGAR_MATCH
            r.rs += l
            if not r.rev:
                r.qs += l
            else:
                r.qe -= l
        else:
            r.p.cigar[-1] -= (l << 4) | MM_CIGAR_MATCH
            r.re -= l
            if not r.rev:
                r.qe -= l
            else:
                r.qs += l


def jump_split(mi, opt, qlen, qseq0, r, ts_strand=0):
    """mm_jump_split (jump.c:196-201)."""
    assert not (opt.flag & MM_F_EQX)
    _jump_split_side(mi, opt, qlen, qseq0, r, ts_strand, True)
    _jump_split_side(mi, opt, qlen, qseq0, r, ts_strand, False)
