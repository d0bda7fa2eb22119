"""Base-level alignment driver entry (reference map.c:215-225 align_regs;
copy of minimap2_tpu.map.align)."""
from __future__ import annotations

from ..config import MM_F_ALL_CHAINS, MM_F_CIGAR, MM_F_HARD_MLEVEL
from . import hit as hitmod
from .align_engine import align_skeleton


def align_regs(opt, mi, qlen, seq, regs, ax, ay):
    if not (opt.flag & MM_F_CIGAR):
        return regs
    regs = align_skeleton(opt, mi, qlen, seq, regs, ax, ay)
    if not (opt.flag & MM_F_ALL_CHAINS):  # choose primary mappings (map.c:219-223)
        hitmod.set_parent(regs, opt.mask_level, opt.mask_len, opt.a * 2 + opt.b,
                          bool(opt.flag & MM_F_HARD_MLEVEL), opt.alt_drop)
        regs = hitmod.select_sub(regs, opt.pri_ratio, mi.k * 2, opt.best_n,
                                 False, int(opt.max_gap * 0.8))
        hitmod.set_sam_pri(regs)
    return regs
