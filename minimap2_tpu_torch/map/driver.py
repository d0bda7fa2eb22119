"""Per-fragment host mapping and its output, and the multi-part index
(copy of minimap2_tpu.map.driver: mm_bseq_read_frag2 + the qname grouping
map.c:566-572, worker_for map.c:425-474, the step-2 output map.c:578-641,
and for a genome larger than -I the part split index.c:315-340 with
merge_hits map.c:476-539 + mm_split_merge map.c:693-736).  A fragment is
one read, or the two ends of a pair; the --batch drivers map their
fallback reads and fragments through these."""
from __future__ import annotations

import sys
import time

import numpy as np

from .. import config as C
from ..config import MapOptions, mapopt_update
from ..index.index import MiniIndex, SeqMeta
from ..io import format as fmt
from ..io.fastx import FastxReader, qname_same, revcomp_record
from ..utils.intfloat import SEQ_NT4
from . import hit as hitmod
from .align_engine import update_dp_max
from .pe import pair as mm_pair
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
    """worker_for (map.c:425-474): pe_ori revcomp, map, flip back; with
    --print-qname or --print-aln-seq the QR and QT lines of the fragment's
    reads on stderr (map.c:433-434, :472-473)."""
    dbg_qname = mo.dbg_flag & (C.MM_DBG_PRINT_ALN_SEQ | C.MM_DBG_PRINT_QNAME)
    if dbg_qname:
        t_qr = time.time()
        for r in frag:
            print(f"QR\t{r.name}\t0\t{len(r.seq)}", file=sys.stderr)
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
    if dbg_qname:
        for r in frag:
            print(f"QT\t{r.name}\t0\t{time.time() - t_qr:.6f}",
                  file=sys.stderr)
    return results


def write_fragment(out, mi, mo, frag, regss, rep_lens):
    """step-2 output (map.c:604-627) of a fragment: SAM (with the -R read
    group the CLI puts in mo.rg_id) or PAF, or with --write-junc the BED
    lines of the introns of its primary records of mapq 10 or more
    (map.c:601-608)."""
    if mo.flag & C.MM_F_OUT_JUNC:
        for j, rec in enumerate(frag):
            for r in regss[j]:
                if r.id != r.parent or r.mapq < 10:
                    continue
                line = fmt.write_junc(mi, rec.name, r)
                if line:
                    out.write(line + "\n")
        return
    n_seg = len(frag)
    n_regss = [len(rs) for rs in regss]
    rg_id = getattr(mo, "rg_id", None)
    for j, rec in enumerate(frag):
        regs = regss[j]
        rep_len = rep_lens[j]
        if regs:
            for k, r in enumerate(regs):
                if (mo.flag & C.MM_F_NO_PRINT_2ND) and r.id != r.parent:
                    continue
                if mo.flag & C.MM_F_OUT_SAM:
                    out.write(fmt.write_sam(mi, rec, j, k, n_seg, n_regss,
                                            regss, mo.flag, rep_len,
                                            rg_id=rg_id))
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
                                        regss, mo.flag, rep_len,
                                        rg_id=rg_id))
            else:
                out.write(fmt.write_paf(mi, rec.name, len(rec.seq), None,
                                        mo.flag, rep_len, n_seg, j))
            out.write("\n")


def split_parts(names, seqs, batch_size: int):
    """mm_idx_reader part splitting (index.c:315-340): consecutive
    sequences accumulate into a part until batch_size bp is reached."""
    parts = []
    cur_n, cur_s, total = [], [], 0
    for nm, sq in zip(names, seqs):
        cur_n.append(nm)
        cur_s.append(sq)
        total += len(sq)
        if total >= batch_size:
            parts.append((cur_n, cur_s))
            cur_n, cur_s, total = [], [], 0
    if cur_n:
        parts.append((cur_n, cur_s))
    return parts


def run_multipart(names, seqs, io_opt, mo, queries, out, verbose=3,
                  write_hdr=None):
    """Multi-part index mapping with hit merge (the --split-prefix flow,
    map.c:476-539 + mm_split_merge map.c:693-736, held in memory).

    Maps every fragment against each index part, then re-sorts, re-picks
    primaries, re-scores mapq and re-pairs over the union of hits.
    """
    parts = split_parts(names, seqs, io_opt.batch_size)
    n_parts = len(parts)
    if verbose >= 3:
        print(f"[M::main] built index in {n_parts} parts", file=sys.stderr)
    # merged meta index (names/offsets/S) for output + tag generation
    meta = MiniIndex(io_opt.w, io_opt.k, io_opt.bucket_bits, io_opt.flag)
    off = 0
    chunks = []
    for nm, sq in zip(names, seqs):
        b = sq.encode() if isinstance(sq, str) else sq
        meta.seq.append(SeqMeta(name=nm, offset=off, length=len(b)))
        chunks.append(b)
        off += len(b)
    meta.S = SEQ_NT4[np.frombuffer(b"".join(chunks), np.uint8)].copy()
    if write_hdr is not None:
        write_hdr(meta)

    rid_shift = []
    acc = 0
    part_idx = []
    for pn, ps in parts:
        rid_shift.append(acc)
        acc += len(pn)
        part_idx.append(MiniIndex.build(pn, ps, w=io_opt.w, k=io_opt.k,
                                        b=io_opt.bucket_bits,
                                        flag=io_opt.flag))
    frag_mode = len(queries) > 1 or bool(mo.flag & C.MM_F_FRAG_MODE)
    frags = list(iter_fragments(queries, frag_mode))

    # phase 1: map everything against each part (tmp-file analogue)
    per_part = []
    for pi, mi_p in enumerate(part_idx):
        mo_p = MapOptions(**vars(mo))
        mapopt_update(mo_p, mi_p)
        res_p = [map_fragment(mi_p, mo_p, frag) for frag in frags]
        per_part.append(res_p)

    # phase 2: merge_hits per fragment segment (map.c:490-538)
    n_mapped = 0
    for fi, frag in enumerate(frags):
        n_seg = len(frag)
        regss, rep_lens = [], []
        frag_gap0 = None
        for j in range(n_seg):
            merged = []
            rep_len = 0
            for pi in range(n_parts):
                res = per_part[pi][fi][j]
                rep_len = max(rep_len, res.rep_len)
                if frag_gap0 is None:
                    frag_gap0 = res.frag_gap
                for r in res.regs:
                    r.rid += rid_shift[pi]
                    merged.append(r)
            qlen = len(frag[j].seq)
            if not (mo.flag & C.MM_F_SR) and qlen >= mo.rank_min_len:
                update_dp_max(qlen, merged, mo.rank_frac, mo.a, mo.b)
            for r in merged:
                if r.p is not None:
                    r.p.dp_max2 = 0
                r.subsc = 0
                r.n_sub = 0
            merged = hitmod.hit_sort(merged, mo.alt_drop)
            hitmod.set_parent(merged, mo.mask_level, mo.mask_len,
                              mo.a * 2 + mo.b,
                              bool(mo.flag & C.MM_F_HARD_MLEVEL),
                              mo.alt_drop)
            if not (mo.flag & C.MM_F_ALL_CHAINS):
                merged = hitmod.select_sub(merged, mo.pri_ratio,
                                           io_opt.k * 2, mo.best_n, False,
                                           int(mo.max_gap * 0.8))
                hitmod.set_sam_pri(merged)
            hitmod.set_mapq(merged, mo.min_chain_score, mo.a, rep_len,
                            bool(mo.flag & (C.MM_F_SR | C.MM_F_SR_RNA)),
                            bool(mo.flag & C.MM_F_SPLICE))
            regss.append(merged)
            rep_lens.append(rep_len)
        if n_seg == 2 and mo.pe_ori >= 0 and (mo.flag & C.MM_F_CIGAR):
            mm_pair(frag_gap0, mo.pe_bonus, mo.a * 2 + mo.b, mo.a,
                    [len(r.seq) for r in frag], regss)
        write_fragment(out, meta, mo, frag, regss, rep_lens)
        n_mapped += n_seg
    return n_mapped
