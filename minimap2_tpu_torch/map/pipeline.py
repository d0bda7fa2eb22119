"""Per-fragment host mapping: the reference's mm_map_frag_core
(map.c:227-378) for one or more segments (copy of
minimap2_tpu.map.pipeline).

The --batch drivers (parallel/engine.py) hand it the reads the device path
does not take: PAF reads longer than L, -c/-a reads whose device alignment
failed its audit, and paired-end fragments with an end the device path
could not align.  A fragment of two segments (paired ends) is chained
jointly, split per segment (map/pe.seg_gen), aligned per segment and
paired by mm_pair (map/pe.pair).  Sketch, anchors, chaining and the DPs run
through the C++ routines of native/host_map.cpp.  With jump side data (-j,
--pass1) a spliced single segment's clipped ends go through jump_split
(map/jump.py).  With MapOptions.dbg_flag's MM_DBG_PRINT_SEED or
MM_DBG_PRINT_CHAIN bits (--print-seeds, --print-chains) it writes the RS/SD
and CN lines of the JAX package (map.c:255-260, :326-330) on stderr.
"""
from __future__ import annotations

import sys

import numpy as np

from .. import native
from ..config import (MM_DBG_PRINT_CHAIN, MM_DBG_PRINT_SEED,
                      MM_F_ALL_CHAINS, MM_F_HARD_MLEVEL, MM_F_HEAP_SORT,
                      MM_F_CIGAR, MM_F_NO_HASH_NAME, MM_F_NO_LJOIN,
                      MM_F_QSTRAND,
                      MM_F_RMQ, MM_F_SPLICE, MM_F_SR, MM_F_SR_RNA,
                      MM_MAX_SEG, MapOptions)
from ..index.index import MiniIndex
from ..utils.intfloat import SEQ_NT4, qname_hash
from . import hit as hitmod
from .align import align_regs
from .chain import chain_dp, chain_rmq
from .jump import jump_split
from .pe import pair as mm_pair
from .pe import seg_gen, select_sub_multi
from .sdust import dust_minier
from .seed import collect_seed_hits, collect_seed_hits_heap, seed_mz_flt


def _anchor_fields(ax, ay):
    """The SD/CN columns of anchors ax/ay: contig ids, rpos, strand
    characters, qpos, spans (map.c:255-260)."""
    ax = np.asarray(ax, np.uint64)
    ay = np.asarray(ay, np.uint64)
    rid = ((ax << np.uint64(1)) >> np.uint64(33)).tolist()
    rpos = ax.astype(np.uint32).view(np.int32).astype(np.int64)
    strand = np.where(ax >> np.uint64(63), "-", "+").tolist()
    qpos = ay.astype(np.uint32).view(np.int32).astype(np.int64)
    span = ((ay >> np.uint64(32)) & np.uint64(0xFF)).tolist()
    return rid, rpos, strand, qpos, span


def _dbg_seed_dump(mi, ax, ay, rep_len):
    """--print-seeds RS/SD lines (map.c:255-260)."""
    rid, rpos, strand, qpos, span = _anchor_fields(ax, ay)
    gap = np.diff(qpos, prepend=qpos[:1]) - np.diff(rpos, prepend=rpos[:1])
    sys.stderr.write(f"RS\t{rep_len}\n" + "".join(
        f"SD\t{mi.seq[r].name}\t{rp}\t{st}\t{qp}\t{sp}\t{g}\n"
        for r, rp, st, qp, sp, g in zip(rid, rpos.tolist(), strand,
                                        qpos.tolist(), span, gap.tolist())))


def _dbg_chain_dump(mi, regs0, ax, ay):
    """--print-chains CN lines (map.c:326-330): each chain's anchors, the
    gap measured from the chain's previous anchor."""
    rid, rpos, strand, qpos, span = _anchor_fields(ax, ay)
    lines = []
    for j, r in enumerate(regs0):
        sl = slice(r.as_, r.as_ + r.cnt)
        q, rp = qpos[sl], rpos[sl]
        gap = np.diff(q, prepend=q[:1]) - np.diff(rp, prepend=rp[:1])
        lines += [f"CN\t{j}\t{mi.seq[a].name}\t{b}\t{c}\t{d}\t{e}\t{g}\n"
                  for a, b, c, d, e, g in zip(rid[sl], rp.tolist(),
                                              strand[sl], q.tolist(),
                                              span[sl], gap.tolist())]
    sys.stderr.write("".join(lines))


def collect_minimizers(mi: MiniIndex, opt: MapOptions, seqs: list[bytes]):
    """map.c:59-72, incl. the -T sdust minimizer mask."""
    xs, ys = [], []
    total = 0
    for sid, s in enumerate(seqs):
        codes = SEQ_NT4[np.frombuffer(s, dtype=np.uint8)]
        if len(codes) > 0:
            x, y = native.sketch(codes, mi.w, mi.k, sid, bool(mi.flag & 0x1))
            with np.errstate(over="ignore"):
                y = y + np.uint64((total << 1) & 0xFFFFFFFFFFFFFFFF)
            if opt.sdust_thres > 0:   # mask low-complexity minimizers
                x, y = dust_minier(x, y, len(s), s, opt.sdust_thres)
            xs.append(x)
            ys.append(y)
        total += len(s)
    if xs:
        return np.concatenate(xs), np.concatenate(ys)
    return np.empty(0, np.uint64), np.empty(0, np.uint64)


class FragResult:
    def __init__(self):
        self.regs: list[hitmod.Reg] = []
        self.rep_len = 0
        self.frag_gap = 0
        self.ax = None
        self.ay = None


def map_frag_core(mi: MiniIndex, seqs: list[bytes], opt: MapOptions,
                  qname: str | None) -> list[FragResult]:
    """Map one fragment (1..n segments). Returns per-segment results."""
    n_segs = len(seqs)
    qlens = [len(s) for s in seqs]
    qlen_sum = sum(qlens)
    results = [FragResult() for _ in range(n_segs)]
    if qlen_sum == 0 or n_segs <= 0 or n_segs > MM_MAX_SEG:
        return results
    if opt.max_qlen > 0 and qlen_sum > opt.max_qlen:
        return results

    is_splice = bool(opt.flag & MM_F_SPLICE)
    is_sr = bool(opt.flag & MM_F_SR)
    is_sr_rna = bool(opt.flag & MM_F_SR_RNA)
    hash_ = qname_hash(qname, qlen_sum, opt.seed,
                       bool(opt.flag & MM_F_NO_HASH_NAME))

    mx, my = collect_minimizers(mi, opt, seqs)
    if opt.q_occ_frac > 0.0:
        mx, my = seed_mz_flt(mx, my, opt.mid_occ, opt.q_occ_frac)
    _collect = (collect_seed_hits_heap if opt.flag & MM_F_HEAP_SORT
                else collect_seed_hits)     # map.c:252-253
    ax, ay, rep_len, mini_pos = _collect(
        mi, opt, opt.mid_occ, mx, my, qlen_sum, qname)
    if opt.dbg_flag & MM_DBG_PRINT_SEED:
        _dbg_seed_dump(mi, ax, ay, rep_len)

    # chaining gaps (map.c:262-274)
    if is_sr:
        max_chain_gap_qry = max(qlen_sum, opt.max_gap)
    else:
        max_chain_gap_qry = opt.max_gap
    if opt.max_gap_ref > 0:
        max_chain_gap_ref = opt.max_gap_ref
    elif opt.max_frag_len > 0:
        max_chain_gap_ref = max(opt.max_frag_len - qlen_sum, opt.max_gap)
    else:
        max_chain_gap_ref = opt.max_gap

    chn_pen_gap = np.float32(opt.chain_gap_scale * 0.01 * mi.k)
    chn_pen_skip = np.float32(opt.chain_skip_scale * 0.01 * mi.k)

    if opt.flag & MM_F_RMQ:
        u, ax, ay = chain_rmq(opt.max_gap, opt.rmq_inner_dist, opt.bw,
                              opt.max_chain_skip, opt.rmq_size_cap,
                              opt.min_cnt, opt.min_chain_score, chn_pen_gap,
                              chn_pen_skip, ax, ay)
    else:
        u, ax, ay = chain_dp(max_chain_gap_ref, max_chain_gap_qry, opt.bw,
                             opt.max_chain_skip, opt.max_chain_iter,
                             opt.min_cnt, opt.min_chain_score, chn_pen_gap,
                             chn_pen_skip, is_splice, n_segs, ax, ay)
    n_regs0 = len(u)

    # long-join rescue (map.c:283-292) / sr re-chain (map.c:293-316)
    if (opt.bw_long > opt.bw
            and (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_NO_LJOIN)) == 0
            and n_segs == 1 and n_regs0 > 1):
        st = int(np.int32(ay[0] & np.uint64(0xFFFFFFFF)))
        en = int(np.int32(ay[int(u[0] & np.uint64(0xFFFFFFFF)) - 1]
                          & np.uint64(0xFFFFFFFF)))
        if (qlen_sum - (en - st) > opt.rmq_rescue_size
                or en - st > qlen_sum * opt.rmq_rescue_ratio):
            order = np.argsort(ax, kind="stable")
            ax, ay = ax[order], ay[order]
            u, ax, ay = chain_rmq(opt.max_gap, opt.rmq_inner_dist,
                                  opt.bw_long, opt.max_chain_skip,
                                  opt.rmq_size_cap, opt.min_cnt,
                                  opt.min_chain_score, chn_pen_gap,
                                  chn_pen_skip, ax, ay)
    elif (opt.max_occ > opt.mid_occ and rep_len > 0
          and not (opt.flag & MM_F_RMQ)):
        rechain = False
        if n_regs0 > 0:
            # does the best chain cover all segments?
            scores = (u >> np.uint64(32)).astype(np.int64)
            cnts = (u & np.uint64(0xFFFFFFFF)).astype(np.int64)
            max_i = int(np.argmax(scores))
            off = int(cnts[:max_i].sum())
            seg_ids = ((ay[off:off + int(cnts[max_i])] & np.uint64(0xFF << 48))
                       >> np.uint64(48))
            n_chained_segs = 1 + int(np.sum(seg_ids[1:] != seg_ids[:-1]))
            if n_chained_segs < n_segs:
                rechain = True
        else:
            rechain = True
        if rechain:
            ax, ay, rep_len, mini_pos = _collect(
                mi, opt, opt.max_occ, mx, my, qlen_sum, qname)
            u, ax, ay = chain_dp(max_chain_gap_ref, max_chain_gap_qry,
                                 opt.bw, opt.max_chain_skip,
                                 opt.max_chain_iter, opt.min_cnt,
                                 opt.min_chain_score, chn_pen_gap,
                                 chn_pen_skip, is_splice, n_segs, ax, ay)

    regs0 = hitmod.gen_regs(hash_, qlen_sum, u, ax, ay,
                            bool(opt.flag & MM_F_QSTRAND))
    if mi.n_alt:
        hitmod.mark_alt(mi, regs0)
        regs0 = hitmod.hit_sort(regs0, opt.alt_drop)
    if opt.dbg_flag & (MM_DBG_PRINT_SEED | MM_DBG_PRINT_CHAIN):
        _dbg_chain_dump(mi, regs0, ax, ay)

    # chain_post (map.c:206-213)
    if not (opt.flag & MM_F_ALL_CHAINS):
        hitmod.set_parent(regs0, opt.mask_level, opt.mask_len,
                          opt.a * 2 + opt.b,
                          bool(opt.flag & MM_F_HARD_MLEVEL), opt.alt_drop)
        if n_segs <= 1:
            regs0 = hitmod.select_sub(regs0, opt.pri_ratio, mi.k * 2,
                                      opt.best_n, True,
                                      int(opt.max_gap * 0.8))
        else:
            regs0 = select_sub_multi(regs0, opt.pri_ratio, 0.2, 0.7,
                                     max_chain_gap_ref, mi.k * 2, opt.best_n,
                                     n_segs, qlens)
    if not is_sr and not (opt.flag & MM_F_QSTRAND):
        hitmod.est_err(mi, qlen_sum, regs0, ax, ay, mini_pos)
        regs0 = hitmod.filter_strand_retained(regs0)

    if n_segs == 1:
        regs0 = align_regs(opt, mi, qlens[0], seqs[0], regs0, ax, ay)
        hitmod.set_mapq(regs0, opt.min_chain_score, opt.a, rep_len,
                        is_sr or is_sr_rna, is_splice)
        if mi.jumps is not None and is_splice:   # map.c:363-365
            for r in regs0:
                jump_split(mi, opt, qlens[0], seqs[0], r, 0)
        results[0].regs = regs0
    else:
        segs = seg_gen(hash_, qlens, regs0, ax, ay)
        for i in range(n_segs):
            sregs, sax, say = segs[i]
            hitmod.set_parent(sregs, opt.mask_level, opt.mask_len,
                              opt.a * 2 + opt.b,
                              bool(opt.flag & MM_F_HARD_MLEVEL), opt.alt_drop)
            sregs = align_regs(opt, mi, qlens[i], seqs[i], sregs, sax, say)
            hitmod.set_mapq(sregs, opt.min_chain_score, opt.a, rep_len,
                            is_sr or is_sr_rna, is_splice)
            results[i].regs = sregs
        if n_segs == 2 and opt.pe_ori >= 0 and (opt.flag & MM_F_CIGAR):
            mm_pair(max_chain_gap_ref, opt.pe_bonus, opt.a * 2 + opt.b,
                    opt.a, qlens, [res.regs for res in results])

    for res in results:
        res.rep_len = rep_len
        res.frag_gap = max_chain_gap_ref
    results[0].ax, results[0].ay = ax, ay
    return results
