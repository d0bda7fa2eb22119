"""Per-read host mapping and its output (copy of minimap2_tpu.map.driver's
map_fragment and write_fragment: worker_for map.c:425-474 and the step-2
output map.c:604-627), single-end.  The --batch -c/-a driver maps its
fallback reads through these."""
from __future__ import annotations

from .. import config as C
from ..io import format as fmt
from .pipeline import map_frag_core


def map_fragment(mi, mo, frag):
    """worker_for (map.c:425-474) for a one-read fragment.  A single segment
    is never reverse-complemented by pe_ori, so nothing flips back."""
    if len(frag) != 1:
        raise NotImplementedError("paired-end mapping is a later slice of "
                                  "the PyTorch/CUDA port")
    return map_frag_core(mi, [frag[0].seq], mo, frag[0].name)


def write_fragment(out, mi, mo, frag, regss, rep_lens):
    """step-2 output (map.c:604-627) of a one-read fragment (the CLI
    refuses -R, so there is no read group)."""
    if mo.flag & C.MM_F_OUT_JUNC:
        raise NotImplementedError("--write-junc (mm_write_junc) is a later "
                                  "slice of the PyTorch/CUDA port")
    n_seg = len(frag)
    n_regss = [len(rs) for rs in regss]
    for j, rec in enumerate(frag):
        regs = regss[j]
        rep_len = rep_lens[j]
        if regs:
            for k, r in enumerate(regs):
                if (mo.flag & C.MM_F_NO_PRINT_2ND) and r.id != r.parent:
                    continue
                if mo.flag & C.MM_F_OUT_SAM:
                    out.write(fmt.write_sam(mi, rec, j, k, n_seg, n_regss,
                                            regss, mo.flag, rep_len))
                else:
                    out.write(fmt.write_paf(mi, rec.name, len(rec.seq), r,
                                            mo.flag, rep_len, n_seg, j,
                                            qseq=rec.seq,
                                            comment=rec.comment))
                out.write("\n")
        elif (mo.flag & C.MM_F_PAF_NO_HIT) or \
                ((mo.flag & C.MM_F_OUT_SAM)
                 and not (mo.flag & C.MM_F_SAM_HIT_ONLY)):
            if mo.flag & C.MM_F_OUT_SAM:
                out.write(fmt.write_sam(mi, rec, j, -1, n_seg, n_regss,
                                        regss, mo.flag, rep_len))
            else:
                out.write(fmt.write_paf(mi, rec.name, len(rec.seq), None,
                                        mo.flag, rep_len, n_seg, j))
            out.write("\n")
