"""Per-fragment host mapping and its output (copy of
minimap2_tpu.map.driver's iter_fragments, map_fragment and write_fragment:
mm_bseq_read_frag2 + the qname grouping map.c:566-572, worker_for
map.c:425-474 and the step-2 output map.c:604-627).  A fragment is one
read, or the two ends of a pair; the --batch drivers map their fallback
reads and fragments through these."""
from __future__ import annotations

import sys

from .. import config as C
from ..io import format as fmt
from ..io.fastx import FastxReader, qname_same, revcomp_record
from .pipeline import map_frag_core


def iter_fragments(queries, frag_mode: bool):
    """Yield fragments (lists of SeqRecords): multi-file interleave
    (mm_bseq_read_frag2) + qname grouping (map.c:566-572)."""
    def read_stream():
        if len(queries) > 1:
            readers = [FastxReader(q) for q in queries]
            while True:
                recs = [rd.read1() for rd in readers]
                if any(r is None for r in recs):
                    if any(r is not None for r in recs):
                        print("[W::main] query files have different number"
                              " of records; extra records skipped.",
                              file=sys.stderr)
                    break
                yield from recs
            for rd in readers:
                rd.close()
        else:
            rd = FastxReader(queries[0])
            while True:
                rec = rd.read1()
                if rec is None:
                    break
                yield rec
            rd.close()

    pending: list = []
    for rec in read_stream():
        if pending and (not frag_mode
                        or not qname_same(pending[-1].name, rec.name)
                        or len(pending) >= C.MM_MAX_SEG):
            yield pending
            pending = []
        pending.append(rec)
    if pending:
        yield pending


def flip_back(regs, qlen: int) -> None:
    """A reverse-complemented segment's regs back to the read strand
    (map.c:454-470)."""
    for r in regs:
        r.qs, r.qe = qlen - r.qe, qlen - r.qs
        r.rev = 0 if r.rev else 1
        if r.p is not None:
            if r.p.trans_strand == 1:
                r.p.trans_strand = 2
            elif r.p.trans_strand == 2:
                r.p.trans_strand = 1


def map_fragment(mi, mo, frag):
    """worker_for (map.c:425-474): pe_ori revcomp, map, flip back."""
    n_seg = len(frag)
    pe_ori = mo.pe_ori
    flipped = [n_seg == 2 and ((j == 0 and (pe_ori >> 1) & 1)
                               or (j == 1 and pe_ori & 1))
               for j in range(n_seg)]
    mseqs = [revcomp_record(r).seq if flipped[j] else r.seq
             for j, r in enumerate(frag)]
    if mo.flag & C.MM_F_INDEPEND_SEG:
        results = [map_frag_core(mi, [mseqs[j]], mo, frag[j].name)[0]
                   for j in range(n_seg)]
    else:
        results = map_frag_core(mi, mseqs, mo, frag[0].name)
    for j in range(n_seg):
        if flipped[j]:
            flip_back(results[j].regs, len(frag[j].seq))
    return results


def write_fragment(out, mi, mo, frag, regss, rep_lens):
    """step-2 output (map.c:604-627) of a fragment (the CLI refuses -R, so
    there is no read group)."""
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
