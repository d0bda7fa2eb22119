"""Hit records and mapping quality (copy of minimap2_tpu.map.hit's pieces
the --batch -c/-a path uses: mm_extra_t / mm_reg1_t, mm_set_mapq2
hit.c:432-485 and mm_set_inv_mapq hit.c:406-430)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import MM_PARENT_UNSET


@dataclass
class Extra:
    """mm_extra_t (minimap.h:103-110)."""
    dp_score: int = 0
    dp_max: int = 0
    dp_max2: int = 0
    dp_max0: int = 0
    n_ambi: int = 0
    trans_strand: int = 0
    cigar: list[int] = field(default_factory=list)  # op | len<<4


@dataclass
class Reg:
    """mm_reg1_t (minimap.h:112-127)."""
    id: int = 0
    cnt: int = 0
    rid: int = 0
    score: int = 0
    qs: int = 0
    qe: int = 0
    rs: int = 0
    re: int = 0
    parent: int = MM_PARENT_UNSET
    subsc: int = 0
    as_: int = 0
    mlen: int = 0
    blen: int = 0
    n_sub: int = 0
    score0: int = 0
    mapq: int = 0
    split: int = 0
    rev: bool = False
    inv: bool = False
    sam_pri: bool = False
    proper_frag: bool = False
    pe_thru: bool = False
    seg_split: bool = False
    seg_id: int = 0
    split_inv: bool = False
    is_alt: bool = False
    strand_retained: bool = False
    is_spliced: bool = False
    hash: int = 0
    div: float = -1.0
    p: Extra | None = None


def set_mapq(regs: list[Reg], min_chain_sc: int, match_sc: int, rep_len: int,
             is_sr: bool, is_splice: bool) -> None:
    """mm_set_mapq2 (hit.c:432-485), float32 arithmetic."""
    f32 = np.float32
    q_coef = f32(40.0)
    if not regs:
        return
    sum_sc = 0
    n_2nd_splice = 0
    for r in regs:
        if r.parent == r.id:
            sum_sc += r.score
        elif r.is_spliced:
            n_2nd_splice += 1
    uniq_ratio = f32(sum_sc) / f32(sum_sc + rep_len) \
        if (sum_sc + rep_len) else f32(0)
    for r in regs:
        if r.inv:
            r.mapq = 0
        elif r.parent == r.id:
            pen_s1 = (f32(1.0) if r.score > 100
                      else f32(0.01) * f32(r.score)) * uniq_ratio
            pen_cm = f32(1.0) if r.cnt > 10 else f32(0.1) * f32(r.cnt)
            pen_cm = pen_s1 if pen_s1 < pen_cm else pen_cm
            subsc = max(r.subsc, min_chain_sc)
            if r.p is not None and r.p.dp_max2 > 0 and r.p.dp_max > 0:
                identity = f32(r.mlen) / f32(r.blen)
                if is_sr and is_splice:
                    x = f32(r.p.dp_max2) / f32(r.p.dp_max)
                else:
                    x = f32(r.p.dp_max2) * f32(subsc) / f32(r.p.dp_max) \
                        / f32(r.score0)
                mapq = int(identity * pen_cm * q_coef * (f32(1.0) - x * x)
                           * f32(np.log(f32(r.p.dp_max) / f32(match_sc))))
                if not is_sr:
                    mapq_alt = int(f32(6.02) * identity * identity
                                   * f32(r.p.dp_max - r.p.dp_max2)
                                   / f32(match_sc) + f32(0.499))
                    mapq = min(mapq, mapq_alt)
                if is_splice and is_sr and r.is_spliced and n_2nd_splice == 0:
                    mapq += 10
            else:
                x = f32(subsc) / f32(r.score0)
                if r.p is not None:
                    identity = f32(r.mlen) / f32(r.blen)
                    mapq = int(identity * pen_cm * q_coef * (f32(1.0) - x)
                               * f32(np.log(f32(r.p.dp_max) / f32(match_sc))))
                else:
                    mapq = int(pen_cm * q_coef * (f32(1.0) - x)
                               * f32(np.log(f32(r.score))))
            mapq -= int(f32(4.343) * f32(np.log(f32(r.n_sub + 1)))
                        + f32(0.499))
            mapq = max(mapq, 0)
            r.mapq = min(mapq, 60)
            if r.p is not None and r.p.dp_max > r.p.dp_max2 and r.mapq == 0:
                r.mapq = 1
        else:
            r.mapq = 0
    _set_inv_mapq(regs)


def _set_inv_mapq(regs: list[Reg]) -> None:
    """hit.c:406-430."""
    n = len(regs)
    if n < 3 or not any(r.inv for r in regs):
        return
    aux = sorted(
        ((r.rid << 32 | r.rs, i) for i, r in enumerate(regs)
         if r.parent == i or r.parent < 0))
    for j in range(1, len(aux) - 1):
        inv = regs[aux[j][1]]
        if inv.inv:
            lft = regs[aux[j - 1][1]]
            rgt = regs[aux[j + 1][1]]
            inv.mapq = min(lft.mapq, rgt.mapq)
