"""cs / ds / MD tags (copy of minimap2_tpu.io.tags; format.c:141-362)."""
from __future__ import annotations

import numpy as np

from ..utils.intfloat import SEQ_NT4

_LOW = "acgtn"
_UPP = "ACGTN"


def _write_indel_ds(out, seq, ll, lr):
    """write_indel_ds (format.c:142-169)."""
    ln = len(seq)
    if ll + lr >= ln:
        out.append("[" + "".join(_LOW[c] for c in seq) + "]")
    else:
        k = 0
        if ll > 0:
            out.append("[" + "".join(_LOW[seq[k + i]] for i in range(ll)) + "]")
            k += ll
        out.append("".join(_LOW[seq[k + i]] for i in range(ln - lr - ll)))
        k += ln - lr - ll
        if lr > 0:
            out.append("[" + "".join(_LOW[seq[k + i]] for i in range(lr)) + "]")


def _write_cs_ds_core(out, tseq, qseq, cigar, no_iden, is_ds, write_tag):
    """write_cs_ds_core (format.c:171-254)."""
    if write_tag:
        out.append(f"\t{'d' if is_ds else 'c'}s:Z:")
    q_len = t_len = 0
    for c in cigar:
        op, ln = c & 0xF, c >> 4
        if op in (0, 7, 8):
            q_len += ln
            t_len += ln
        elif op == 1:
            q_len += ln
        elif op in (2, 3):
            t_len += ln
    q_off = t_off = 0
    for c in cigar:
        op, ln = c & 0xF, c >> 4
        if op in (0, 7, 8):
            l_tmp = []
            for j in range(ln):
                if qseq[q_off + j] != tseq[t_off + j]:
                    if l_tmp:
                        out.append("=" + "".join(l_tmp) if not no_iden
                                   else f":{len(l_tmp)}")
                        l_tmp = []
                    out.append(f"*{_LOW[tseq[t_off + j]]}{_LOW[qseq[q_off + j]]}")
                else:
                    l_tmp.append(_UPP[qseq[q_off + j]])
            if l_tmp:
                out.append("=" + "".join(l_tmp) if not no_iden else f":{len(l_tmp)}")
            q_off += ln
            t_off += ln
        elif op == 1:  # insertion
            if is_ds:
                y = q_off
                z = 1
                while z <= ln and y - z >= 0 and qseq[y + ln - z] == qseq[y - z]:
                    z += 1
                lr = z - 1
                z = 0
                while z < ln and y + ln + z < q_len and qseq[y + ln + z] == qseq[y + z]:
                    z += 1
                ll = z
                out.append("+")
                _write_indel_ds(out, qseq[y:y + ln], ll, lr)
            else:
                out.append("+" + "".join(_LOW[qseq[q_off + j]] for j in range(ln)))
            q_off += ln
        elif op == 2:  # deletion
            if is_ds:
                x = t_off
                z = 1
                while z <= ln and x - z >= 0 and tseq[x + ln - z] == tseq[x - z]:
                    z += 1
                lr = z - 1
                z = 0
                while z < ln and x + ln + z < t_len and tseq[x + z] == tseq[x + ln + z]:
                    z += 1
                ll = z
                out.append("-")
                _write_indel_ds(out, tseq[x:x + ln], ll, lr)
            else:
                out.append("-" + "".join(_LOW[tseq[t_off + j]] for j in range(ln)))
            t_off += ln
        else:  # intron
            out.append(f"~{_LOW[tseq[t_off]]}{_LOW[tseq[t_off + 1]]}{ln}"
                       f"{_LOW[tseq[t_off + ln - 2]]}{_LOW[tseq[t_off + ln - 1]]}")
            t_off += ln


def _write_MD_core(out, tseq, qseq, cigar, write_tag):
    """write_MD_core (format.c:302-331)."""
    if write_tag:
        out.append("\tMD:Z:")
    l_MD = 0
    q_off = t_off = 0
    for c in cigar:
        op, ln = c & 0xF, c >> 4
        if op in (0, 7, 8):
            for j in range(ln):
                if qseq[q_off + j] != tseq[t_off + j]:
                    out.append(f"{l_MD}{_UPP[tseq[t_off + j]]}")
                    l_MD = 0
                else:
                    l_MD += 1
            q_off += ln
            t_off += ln
        elif op == 1:
            q_off += ln
        elif op == 2:
            out.append(f"{l_MD}^" + "".join(_UPP[tseq[t_off + j]] for j in range(ln)))
            l_MD = 0
            t_off += ln
        elif op == 3:
            t_off += ln
    if l_MD > 0:
        out.append(str(l_MD))


def write_cs_ds_md(mi, qname, qseq_full: bytes, r, no_iden: bool, is_MD: bool,
                   is_ds: bool, write_tag: bool, is_qstrand: bool) -> str:
    """write_cs_ds_or_MD (format.c:333-362)."""
    if r.p is None:
        return ""
    codes = SEQ_NT4[np.frombuffer(qseq_full, dtype=np.uint8)]
    if is_qstrand:
        tseq = mi.getseq(r.rid, r.rs, r.re, rev=bool(r.rev))
        qseq = codes[r.qs:r.qe]
    else:
        tseq = mi.getseq(r.rid, r.rs, r.re)
        if not r.rev:
            qseq = codes[r.qs:r.qe]
        else:
            qseq = codes[r.qs:r.qe][::-1]
            qseq = np.where(qseq >= 4, np.uint8(4), 3 - qseq).astype(np.uint8)
    out: list[str] = []
    if is_MD:
        _write_MD_core(out, tseq, qseq, r.p.cigar, write_tag)
    else:
        _write_cs_ds_core(out, tseq, qseq, r.p.cigar, no_iden, is_ds, write_tag)
    return "".join(out)
