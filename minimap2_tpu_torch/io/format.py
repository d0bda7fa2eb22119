"""PAF / SAM writers with cs/ds/MD tags, and the --write-junc BED writer
(copy of minimap2_tpu.io.format).

Reference: format.c (mm_write_paf4 :425-458, write_tags :397-423,
mm_write_sam3 :522-679, write_cs_ds_or_MD :171-362, sam header :118-140,
mm_write_junc :263-300).
"""
from __future__ import annotations

import numpy as np

from ..config import (MM_CIGAR_STR, MM_F_COPY_COMMENT, MM_F_FRAG_MODE,
                      MM_F_LONG_CIGAR, MM_F_OUT_CG, MM_F_OUT_CS,
                      MM_F_OUT_CS_LONG, MM_F_OUT_DS, MM_F_OUT_MD,
                      MM_F_QSTRAND, MM_F_SECONDARY_SEQ, MM_F_SOFTCLIP)
from ..map.align_engine import event_identity
from ..map.hit import Reg
from .fastx import qname_len
from .tags import write_cs_ds_md


def _fmt_div(div: float) -> str:
    if div == 0.0:
        return "0"
    return f"{div:.4f}"


def write_tags(out: list[str], r: Reg) -> None:
    if r.id == r.parent:
        typ = "I" if r.inv else "P"
    else:
        typ = "i" if r.inv else "S"
    if r.p is not None:
        out.append(f"\tNM:i:{r.blen - r.mlen + r.p.n_ambi}\tms:i:{r.p.dp_max0}"
                   f"\tAS:i:{r.p.dp_score}\tnn:i:{r.p.n_ambi}")
        if r.p.trans_strand in (1, 2):
            out.append(f"\tts:A:{'?+-?'[r.p.trans_strand]}")
    out.append(f"\ttp:A:{typ}\tcm:i:{r.cnt}\ts1:i:{r.score}")
    if r.parent == r.id:
        out.append(f"\ts2:i:{r.subsc}")
    if r.p is not None:
        div = 1.0 - event_identity(r)
        out.append(f"\tde:f:{_fmt_div(div)}")
    elif 0.0 <= r.div <= 1.0:
        out.append(f"\tdv:f:{_fmt_div(r.div)}")
    if r.split:
        out.append(f"\tzd:i:{r.split}")


def write_paf(mi, qname: str, qlen: int, r: Reg | None, opt_flag: int,
              rep_len: int, n_seg: int = 0, seg_idx: int = 0,
              qseq: bytes | None = None, comment: str | None = None) -> str:
    """mm_write_paf4 (format.c:425-458)."""
    out = [qname]
    if (opt_flag & MM_F_FRAG_MODE) and n_seg >= 2 and seg_idx >= 0:
        out.append(f"/{seg_idx + 1}")
    if r is None:
        out.append(f"\t{qlen}\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0")
        if rep_len >= 0:
            out.append(f"\trl:i:{rep_len}")
        return "".join(out)
    out.append(f"\t{qlen}\t{r.qs}\t{r.qe}\t{'+-'[r.rev]}\t")
    out.append(mi.seq[r.rid].name)
    tlen = mi.seq[r.rid].length
    out.append(f"\t{tlen}")
    if (opt_flag & MM_F_QSTRAND) and r.rev:
        out.append(f"\t{tlen - r.re}\t{tlen - r.rs}")
    else:
        out.append(f"\t{r.rs}\t{r.re}")
    out.append(f"\t{r.mlen}\t{r.blen}\t{r.mapq}")
    write_tags(out, r)
    if rep_len >= 0:
        out.append(f"\trl:i:{rep_len}")
    if r.p is not None and (opt_flag & MM_F_OUT_CG):
        out.append("\tcg:Z:")
        for c in r.p.cigar:
            out.append(f"{c >> 4}{MM_CIGAR_STR[c & 0xF]}")
    if r.p is not None and (opt_flag & (MM_F_OUT_CS | MM_F_OUT_DS | MM_F_OUT_MD)):
        out.append(write_cs_ds_md(mi, qname, qseq, r,
                                  no_iden=not (opt_flag & MM_F_OUT_CS_LONG),
                                  is_MD=bool(opt_flag & MM_F_OUT_MD),
                                  is_ds=bool(opt_flag & MM_F_OUT_DS),
                                  write_tag=True,
                                  is_qstrand=bool(opt_flag & MM_F_QSTRAND)))
    if (opt_flag & MM_F_COPY_COMMENT) and comment:
        out.append(f"\t{comment}")
    return "".join(out)


_COMP_TRANS = bytes.maketrans(b"ACGTUacgtuRYSWKMBDHVryswkmbdhvNn",
                              b"TGCAAtgcaaYRSWMKVHDByrswmkvhdbNn")


def _sq(seq: bytes, rev: bool, comp: bool) -> str:
    if rev:
        seq = seq[::-1]
        if comp:
            seq = seq.translate(_COMP_TRANS)
    return seq.decode()


def write_sam_hdr(mi, rg: str | None, ver: str, cmdline: str | None) -> str:
    """mm_write_sam_hdr (format.c:118-140)."""
    out = ["@HD\tVN:1.6\tSO:unsorted\tGO:query\n"]
    if mi is not None:
        for s in mi.seq:
            out.append(f"@SQ\tSN:{s.name}\tLN:{s.length}\n")
    if rg:
        out.append(rg.replace("\\t", "\t") + "\n")
    out.append("@PG\tID:minimap2\tPN:minimap2")
    if ver:
        out.append(f"\tVN:{ver}")
    if cmdline:
        out.append(f"\tCL:{cmdline}")
    return "".join(out)


def _sam_cigar(r: Reg, sam_flag: int, qlen: int, opt_flag: int,
               in_tag: bool = False) -> str:
    """write_sam_cigar (format.c:494-520); in_tag emits the CG:B:I form."""
    if r.p is None:
        return "*"
    clip0 = qlen - r.qe if r.rev else r.qs
    clip1 = r.qs if r.rev else qlen - r.qe
    hard = (((sam_flag & 0x800) or ((sam_flag & 0x100) and (opt_flag & MM_F_SECONDARY_SEQ)))
            and not (opt_flag & MM_F_SOFTCLIP))
    out = []
    if in_tag:
        clip_op = 5 if hard else 4
        out.append("\tCG:B:I")
        if clip0:
            out.append(f",{clip0 << 4 | clip_op}")
        for c in r.p.cigar:
            out.append(f",{c}")
        if clip1:
            out.append(f",{clip1 << 4 | clip_op}")
        return "".join(out)
    cc = "H" if hard else "S"
    if clip0:
        out.append(f"{clip0}{cc}")
    for c in r.p.cigar:
        out.append(f"{c >> 4}{MM_CIGAR_STR[c & 0xF]}")
    if clip1:
        out.append(f"{clip1}{cc}")
    return "".join(out)


def write_sam(mi, rec, seg_idx: int, reg_idx: int, n_seg: int,
              n_regss: list[int], regss: list[list[Reg]], opt_flag: int,
              rep_len: int, rg_id: str | None = None) -> str:
    """mm_write_sam3 (format.c:522-679)."""
    n_regs = n_regss[seg_idx]
    regs = regss[seg_idx]
    r = regs[reg_idx] if (n_regs > 0 and 0 <= reg_idx < n_regs) else None
    r_prev = r_next = None
    if n_seg > 1:
        next_sid = (seg_idx + 1) % n_seg
        r_next = next((q for q in regss[next_sid] if q.sam_pri), None)
        if n_seg > 2:
            for i in range(1, n_seg):
                prev_sid = (seg_idx + n_seg - i) % n_seg
                if n_regss[prev_sid] > 0:
                    r_prev = next((q for q in regss[prev_sid] if q.sam_pri), None)
                    break
        else:
            r_prev = r_next

    out = []
    name = rec.name
    if n_seg > 1:
        name = name[:qname_len(name)]
    out.append(name)

    flag = 0x1 if n_seg > 1 else 0x0
    if r is None:
        flag |= 0x4
    else:
        if r.rev:
            flag |= 0x10
        if r.parent != r.id:
            flag |= 0x100
        elif not r.sam_pri:
            flag |= 0x800
    if n_seg > 1:
        if r is not None and r.proper_frag:
            flag |= 0x2
        if seg_idx == 0:
            flag |= 0x40
        elif seg_idx == n_seg - 1:
            flag |= 0x80
        if r_next is None:
            flag |= 0x8
        elif r_next.rev:
            flag |= 0x20
    out.append(f"\t{flag}")

    this_rid = this_pos = -1
    cigar_in_tag = False
    if r is None:
        if r_prev is not None:
            this_rid, this_pos = r_prev.rid, r_prev.rs
            out.append(f"\t{mi.seq[this_rid].name}\t{this_pos + 1}\t0\t*")
        else:
            out.append("\t*\t0\t0\t*")
    else:
        this_rid, this_pos = r.rid, r.rs
        out.append(f"\t{mi.seq[r.rid].name}\t{r.rs + 1}\t{r.mapq}\t")
        # BAM caps CIGAR ops at 65535: with -L, oversize CIGARs go to the
        # CG:B:I tag and the placeholder <slen>S<reflen>N is emitted here
        # (format.c:524, 577-590)
        max_bam_cigar_op = 65535
        if ((opt_flag & MM_F_LONG_CIGAR) and r.p is not None
                and len(r.p.cigar) > max_bam_cigar_op - 2):
            n_cigar = len(r.p.cigar)
            if r.qs != 0:
                n_cigar += 1
            if r.qe != len(rec.seq):
                n_cigar += 1
            if n_cigar > max_bam_cigar_op:
                cigar_in_tag = True
        if cigar_in_tag:
            if (flag & 0x900) == 0 or (opt_flag & MM_F_SOFTCLIP):
                slen = len(rec.seq)
            elif (flag & 0x100) and not (opt_flag & MM_F_SECONDARY_SEQ):
                slen = 0
            else:
                slen = r.qe - r.qs
            out.append(f"{slen}S{r.re - r.rs}N")
        else:
            out.append(_sam_cigar(r, flag, len(rec.seq), opt_flag))

    if n_seg > 1:
        tlen = 0
        if this_rid >= 0 and r_next is not None:
            if this_rid == r_next.rid:
                if r is not None:
                    this_pos5 = r.re - 1 if r.rev else this_pos
                    next_pos5 = r_next.re - 1 if r_next.rev else r_next.rs
                    tlen = next_pos5 - this_pos5
                out.append("\t=\t")
            else:
                out.append(f"\t{mi.seq[r_next.rid].name}\t")
            out.append(f"{r_next.rs + 1}\t")
        elif r_next is not None:
            out.append(f"\t{mi.seq[r_next.rid].name}\t{r_next.rs + 1}\t")
        elif this_rid >= 0:
            out.append(f"\t=\t{this_pos + 1}\t")
        else:
            out.append("\t*\t0\t")
        if tlen > 0:
            tlen += 1
        elif tlen < 0:
            tlen -= 1
        out.append(f"{tlen}\t")
    else:
        out.append("\t*\t0\t0\t")

    qual = rec.qual if (rec.qual and not (opt_flag & 0x010)) else None
    if r is None:
        out.append(_sq(rec.seq, False, False))
        out.append("\t")
        out.append(_sq(qual, False, False) if qual else "*")
    else:
        if (flag & 0x900) == 0 or (opt_flag & MM_F_SOFTCLIP):
            out.append(_sq(rec.seq, r.rev, r.rev))
            out.append("\t")
            out.append(_sq(qual, r.rev, False) if qual else "*")
        elif (flag & 0x100) and not (opt_flag & MM_F_SECONDARY_SEQ):
            out.append("*\t*")
        else:
            out.append(_sq(rec.seq[r.qs:r.qe], r.rev, r.rev))
            out.append("\t")
            out.append(_sq(qual[r.qs:r.qe], r.rev, False) if qual else "*")

    if rg_id:
        out.append(f"\tRG:Z:{rg_id}")
    if n_seg > 2:
        out.append(f"\tFI:i:{seg_idx}")
    if r is not None:
        write_tags(out, r)
        if r.parent == r.id and r.p is not None and n_regs > 1:
            sa = []
            for q in regs:
                if q is r or q.parent != q.id or q.p is None:
                    continue
                if q.qe - q.qs < q.re - q.rs:
                    l_M = q.qe - q.qs
                    l_D = (q.re - q.rs) - l_M
                    l_I = 0
                else:
                    l_M = q.re - q.rs
                    l_I = (q.qe - q.qs) - l_M
                    l_D = 0
                clip5 = len(rec.seq) - q.qe if q.rev else q.qs
                clip3 = q.qs if q.rev else len(rec.seq) - q.qe
                part = [f"{mi.seq[q.rid].name},{q.rs + 1},{'+-'[q.rev]},"]
                if clip5:
                    part.append(f"{clip5}S")
                if l_M:
                    part.append(f"{l_M}M")
                if l_I:
                    part.append(f"{l_I}I")
                if l_D:
                    part.append(f"{l_D}D")
                if clip3:
                    part.append(f"{clip3}S")
                part.append(f",{q.mapq},{q.blen - q.mlen + q.p.n_ambi};")
                sa.append("".join(part))
            if sa:
                out.append("\tSA:Z:" + "".join(sa))
        if r.p is not None and (opt_flag & (MM_F_OUT_CS | MM_F_OUT_DS | MM_F_OUT_MD)):
                out.append(write_cs_ds_md(mi, rec.name, rec.seq, r,
                                      no_iden=not (opt_flag & MM_F_OUT_CS_LONG),
                                      is_MD=bool(opt_flag & MM_F_OUT_MD),
                                      is_ds=bool(opt_flag & MM_F_OUT_DS),
                                      write_tag=True, is_qstrand=False))
        if cigar_in_tag:
            out.append(_sam_cigar(r, flag, len(rec.seq), opt_flag,
                                  in_tag=True))
    if rep_len >= 0:
        out.append(f"\trl:i:{rep_len}")
    if (opt_flag & MM_F_COPY_COMMENT) and rec.comment:
        out.append(f"\t{rec.comment}")
    return "".join(out)


def write_junc(mi, qname: str, r) -> str:
    """mm_write_junc (format.c:263-300): BED lines for each intron."""
    if not r.is_spliced or r.p is None:
        return ""
    if r.p.trans_strand not in (1, 2):
        return ""
    out = []
    t_off = r.rs
    for c in r.p.cigar:
        op, ln = c & 0xF, c >> 4
        if op in (0, 7, 8, 2):        # M, =, X, D
            t_off += ln
        elif op == 3:                 # N
            rev = (r.p.trans_strand == 2) ^ bool(r.rev)
            d = mi.getseq(r.rid, t_off, t_off + 2)
            a = mi.getseq(r.rid, t_off + ln - 2, t_off + ln)
            if rev:
                d, a = a, d
                d = np.where(d < 4, 3 - d, d)[::-1]
                a = np.where(a < 4, 3 - a, a)[::-1]
            s1 = 3 if (d[0], d[1]) == (2, 3) else \
                2 if (d[0], d[1]) == (2, 1) else \
                1 if (d[0], d[1]) == (0, 3) else 0
            s2 = 3 if (a[0], a[1]) == (0, 2) else \
                1 if (a[0], a[1]) == (0, 1) else 0
            out.append(f"{mi.seq[r.rid].name}\t{t_off}\t{t_off + ln}\t"
                       f"{qname}\t{s1 + s2}\t{'-' if rev else '+'}")
            t_off += ln
    return "\n".join(out)
