"""Batched mapping engine (port of minimap2_tpu.parallel.engine's
``--batch`` paths).

A read mega-batch runs sketch -> minimizer compaction -> index probe ->
anchor sort -> chain DP (+ the long-join rescue pass) -> top-K chain
selection on the device as one ``PafStep``; only (10, K, B) chain records
return to the host.  The device chain scan has a fixed look-back window
and the top-K selection approximates mm_set_parent, so quality is gated
statistically, as in the JAX package.

Without -c/-a (``run_batched_cli``) the records become PAF with ``_mapq``
(seed/chain/mapq only, map.c:227-341).  With -c/-a
(``run_batched_align_cli``) each chosen chain's extent is aligned on the
device (parallel/align_batch.py) and written as SAM or PAF with cg:Z.

With two query files in fragment mode (``-x sr r1.fq r2.fq``,
``run_batched_pe_cli``) both ends of each pair are mapped and aligned as
single reads on the device, then paired by mm_pair on the host.

The drivers hand the reads the device path does not take to the host
mapping path (map/pipeline.py map_frag_core, in C++ through native/), where
the JAX package does: PAF reads longer than L, -c/-a reads whose device
alignment failed its audit, and whole pairs with such an end.
``host_path`` counts those reads and their seconds.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from .. import native
from ..config import (MM_F_NO_LJOIN, MM_F_OUT_SAM, MM_F_RMQ,
                      MM_F_SAM_HIT_ONLY, MM_F_SPLICE, MM_F_SR, MM_I_HPC)
from ..io import format as fmt
from ..io.fastx import FastxReader, revcomp_record
from ..map import hit as hitmod
from ..map.align_engine import gen_ts_mat
from ..map.driver import flip_back, iter_fragments, map_fragment, \
    write_fragment
from ..map.pe import pair as pe_pair
from ..map.pipeline import map_frag_core
from ..ops.chain import chain_batch
from ..ops.sketch import sketch_batch
from ..utils import trace
from ..utils.intfloat import SEQ_NT4
from .batch import (BatchParams, DeviceIndex, _chain_scan,
                    _compact_minimizers, _lookup_anchors, chain_waypoints,
                    hpc_compact, topk_chains)

# long-join rescue trigger (map.c:283-292): uncovered query and span ratio
RESCUE_SIZE = 1000
RESCUE_RATIO = np.float32(0.1)
WAYPOINTS = 64      # chain waypoints per read for the -c/-a path

# reads mapped on the host path and the seconds they took, accumulated
# over calls (clear() starts a count)
host_path: Counter = Counter()


def _host_paf(mi, opt, rec, out):
    """Map one read longer than L on the host path and write its PAF as the
    JAX package does (its engine.py:315-323: no qseq, no comment)."""
    t0 = time.perf_counter()
    res = map_frag_core(mi, [rec.seq], opt, rec.name)[0]
    for r in res.regs:
        out.write(fmt.write_paf(mi, rec.name, len(rec.seq), r, opt.flag,
                                res.rep_len) + "\n")
    host_path["reads"] += 1
    host_path["seconds"] += time.perf_counter() - t0


def _host_record(mi, opt, rec, out):
    """Map one -c/-a fallback read on the host path and write its records
    (map_fragment + write_fragment, as the JAX package does)."""
    t0 = time.perf_counter()
    results = map_fragment(mi, opt, [rec])
    write_fragment(out, mi, opt, [rec], [res.regs for res in results],
                   [res.rep_len for res in results])
    host_path["reads"] += 1
    host_path["seconds"] += time.perf_counter() - t0


class PafStep(nn.Module):
    """Device program: packed read batch -> (10, K, B) int32 chain records
    (score, sub, qs, qe, rs, re, rev, rid, cnt, rep_len).

    Dispatch mirrors the JAX package's on-chip route (make_paf_step with
    interpret=False): the chain kernel iff B % 128 == 0, A % 256 == 0 and
    the RMQ tier is off (its ties go to the largest j), else the windowed
    scan (ties to the oldest slot).  On CPU tensors every kernel wrapper runs its plain
    version, so the CPU and the card compute the same records.

    with_sec interleaves each primary with its best overlapping runner-up
    (2K slots); with_wp also returns the (2, B, WAYPOINTS) waypoints [wq,
    wr] of each read's chosen chain for the -c/-a path's anchored
    decomposition."""

    def __init__(self, di: DeviceIndex, p: BatchParams, K: int, min_sc: int,
                 with_sec: bool = False, with_wp: bool = False):
        super().__init__()
        self.di = di
        self.p = p
        self.K = K
        self.min_sc = min_sc
        self.with_sec = with_sec
        self.with_wp = with_wp

    def seed(self, packed, nbits, lens):
        """Unpack, sketch, compact and probe: the anchor planes (rev, rid,
        rpos, qpos, span, av) and rep_len."""
        p = self.p
        with trace.span("paf_step:sketch"):
            codes = unpack_codes(packed, nbits, p.L)
            if p.hpc:       # homopolymer-compress, sketch the run stream
                codes_s, hpos, lens_s = hpc_compact(codes, lens)
            else:
                codes_s, lens_s = codes, lens
            hhi, hlo, z, is_mini = sketch_batch(codes_s, lens_s, p.k, p.w)
            mh_hi, mh_lo, mz, mpos, mvalid = _compact_minimizers(
                hhi, hlo, z, is_mini, p.M)
            mspan = None
            if p.hpc:
                # minimizer slots back to read coordinates; the HPC span is
                # hpos[mc] - hpos[mc - k], the k runs' lengths (sketch.c:
                # 94-105), clipped to [1, 255] (engine.py:57-70)
                L = codes.shape[1]
                mc = torch.clamp(mpos, 0, L - 1).to(torch.int64)
                end_orig = torch.gather(hpos, 1, mc)
                prev_orig = torch.where(
                    mc >= p.k,
                    torch.gather(hpos, 1, torch.clamp(mc - p.k, min=0)), -1)
                mspan = torch.where(
                    mvalid, torch.clamp(end_orig - prev_orig, 1, 255),
                    p.k).to(torch.int32)
                mpos = torch.where(mvalid, end_orig, L)
        return _lookup_anchors(self.di, mh_hi, mh_lo, mz, mpos, mvalid, lens,
                               p, mspan=mspan)

    def run_chain(self, planes, bw: int, max_dist: int):
        p = self.p
        B = planes[0].shape[0]
        # the RMQ tier's second window exists only in the scan route
        if B % 128 == 0 and p.A % 256 == 0 and not p.rmq_tier:
            f, _, qs_a, rs_a = chain_batch(
                *planes, WND=p.chain_window, max_dist_x=max_dist,
                max_dist_y=max_dist, bw=bw, chn_pen_gap=p.chn_pen_gap,
                chn_pen_skip=p.chn_pen_skip)
        else:
            p2 = dataclasses.replace(p, bw=bw, max_dist_x=max_dist,
                                     max_dist_y=max_dist)
            _, (f, _, qs_a, rs_a) = _chain_scan(*planes, p2)
        return f, qs_a, rs_a

    def forward(self, packed, nbits, lens):
        p, K, min_sc, sec = self.p, self.K, self.min_sc, self.with_sec
        rev, rid, rpos, qpos, span, av, rep_len = self.seed(packed, nbits,
                                                            lens)
        planes = (rev, rid, rpos, qpos, span, av)
        rescue = p.bw_long > p.bw
        with trace.span("paf_step:chain"):
            f, qs_a, rs_a = self.run_chain(planes, p.bw, p.max_dist_x)
            if rescue:      # the long-join rescue's rechain, wide band
                f2, qs2_a, rs2_a = self.run_chain(
                    planes, p.bw_long, max(p.max_dist_x, p.bw_long))
        with trace.span("paf_step:select"):
            recs = topk_chains(f, qs_a, rs_a, rev, rid, rpos, qpos, av, K,
                               min_sc, with_sec=sec)
            trig = None
            if rescue:
                # long-join rescue (map.c:283-292): reads whose best chain
                # leaves > RESCUE_SIZE uncovered query (or spans > 10% of
                # the read and has competitors) take the rechain of the
                # SAME anchors with the wide band
                sc0, qs0, qe0 = recs[0][0], recs[2][0], recs[3][0]
                n_multi = (recs[0] >= min_sc).sum(0) > 1
                span0 = qe0 - qs0
                lq = lens.to(torch.int32)
                ratio = torch.tensor(RESCUE_RATIO, device=lq.device)
                trig = (sc0 > 0) & n_multi & (
                    (lq - span0 > RESCUE_SIZE)
                    | (span0.to(torch.float32)
                       > lq.to(torch.float32) * ratio))
                recs2 = topk_chains(f2, qs2_a, rs2_a, rev, rid, rpos, qpos,
                                    av, K, min_sc, with_sec=sec)
                recs = [torch.where(trig[None, :], b, a)
                        for a, b in zip(recs, recs2)]
            recs.append(rep_len[None, :].expand(recs[0].shape[0], -1))
            stack = torch.stack(recs)
            if not self.with_wp:
                return stack
            # waypoints of the chosen chain, from the chain pass that
            # produced the chosen record (engine.py:122-134 of the JAX
            # package)
            rec0 = (recs[2][0], recs[4][0], recs[6][0], recs[7][0])
            wq, wr = chain_waypoints(qs_a, rs_a, rev, rid, rpos, qpos, av,
                                     rec0, WAYPOINTS)
            if trig is not None:
                wq2, wr2 = chain_waypoints(qs2_a, rs2_a, rev, rid, rpos, qpos,
                                           av, rec0, WAYPOINTS)
                wq = torch.where(trig[:, None], wq2, wq)
                wr = torch.where(trig[:, None], wr2, wr)
            return stack, torch.stack([wq, wr])


def encode_batch(seqs: list[bytes], L: int):
    """Pack reads into a fixed-shape (B, L) nt4 batch."""
    B = len(seqs)
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), L)
        codes[i, :n] = SEQ_NT4[np.frombuffer(s[:n], np.uint8)]
        lens[i] = n
    return codes, lens


def pack_codes(codes: np.ndarray):
    """(B, L) nt4 codes -> 2-bit packed (B, L//4) + N bitmap (B, L//8):
    the batch crosses the host->device link ~4x smaller."""
    B, L = codes.shape
    assert L % 8 == 0
    isn = codes >= 4
    c2 = np.where(isn, 0, codes).astype(np.uint8)
    c4 = c2.reshape(B, L // 4, 4)
    packed = (c4[:, :, 0] | (c4[:, :, 1] << 2) | (c4[:, :, 2] << 4)
              | (c4[:, :, 3] << 6)).astype(np.uint8)
    nb = np.packbits(isn.reshape(B, L // 8, 8), axis=-1,
                     bitorder="little")[:, :, 0]
    return packed, nb


def unpack_codes(packed: torch.Tensor, nbits: torch.Tensor, L: int):
    """Device-side inverse of pack_codes -> (B, L) uint8 nt4."""
    B = packed.shape[0]
    dev = packed.device
    sh = torch.arange(0, 8, 2, dtype=torch.uint8, device=dev)
    c = ((packed[:, :, None] >> sh) & 3).reshape(B, L)
    bit = torch.arange(8, dtype=torch.uint8, device=dev)
    nmask = (((nbits[:, :, None] >> bit) & 1) != 0).reshape(B, L)
    return torch.where(nmask, torch.full_like(c, 4), c)


def _mapq(score: int, sub: int, cnt: int, min_chain_score: int,
          rep_len: int = 0, sum_sc: int | None = None,
          n_sub: int = 0) -> int:
    """mm_set_mapq2 (hit.c:432-485), no-DP branch: chain-only mapq with
    the uniq_ratio repeat penalty and the n_sub correction."""
    if score <= 0:
        return 0
    if sum_sc is None:
        sum_sc = score
    uniq_ratio = np.float32(sum_sc) / np.float32(sum_sc + rep_len)
    pen_s1 = (np.float32(1.0) if score > 100
              else np.float32(0.01) * score) * uniq_ratio
    pen_cm = np.float32(1.0) if cnt > 10 else np.float32(0.1) * cnt
    pen_cm = min(pen_s1, pen_cm)
    subsc = max(sub, min_chain_score)
    x = np.float32(subsc) / np.float32(score)
    mapq = int(pen_cm * np.float32(40.0) * (np.float32(1.0) - x)
               * np.log(np.float32(score)))
    mapq -= int(np.float32(4.343) * np.log(np.float32(n_sub + 1))
                + np.float32(0.499))
    return max(0, min(mapq, 60))


def _occ_cap(opt) -> int:
    """Device occurrence cap: mid_occ, bounded to [10, cap]; the cap is 64
    unless MM2TPU_OCC_CAP sets it, as in the JAX package."""
    return min(max(opt.mid_occ, 10),
               int(os.environ.get("MM2TPU_OCC_CAP", "64")))


def _bw_long(opt) -> int:
    """Long-join band (map.c:283: only without splice/sr/no-ljoin and
    when bw_long exceeds bw)."""
    if (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_NO_LJOIN)) == 0 \
            and opt.bw_long > opt.bw:
        return opt.bw_long
    return 0


def batch_params(mi, opt, L: int) -> BatchParams:
    """The CLI's step shapes and scores (engine.py:253-260 and 721-727 of
    the JAX package): M = max(256, L // 4), A = 4096, chain window 64; HPC
    minimizers when the index has them; under MM_F_RMQ (asm, lr:hqae,
    --rmq) the RMQ tier, with the wide band bw_long even where the
    long-join rule is off.  The chain gap penalty stays BatchParams'
    map-ont default for every preset, as in the JAX package."""
    rmq = bool(opt.flag & MM_F_RMQ)
    return BatchParams(L=L, M=max(256, L // 4), A=4096,
                       occ_cap=_occ_cap(opt), chain_window=64,
                       k=mi.k, w=mi.w, max_dist_x=opt.max_gap,
                       max_dist_y=opt.max_gap, bw=opt.bw,
                       bw_long=_bw_long(opt) or (opt.bw_long if rmq else 0),
                       rmq_tier=rmq, hpc=bool(mi.flag & MM_I_HPC))


def dispatch_batch(step: PafStep, seqs, p: BatchParams,
                   pad_to: int | None = None):
    """Encode, upload and enqueue one batch; returns the (10, K, B) device
    tensor without waiting for it.  Partial batches are padded with empty
    reads up to ``pad_to`` (default: the next multiple of 8).  Its spans
    (``encode:pack``, then the step's) carry the thread's current batch id,
    or a new one."""
    dev = step.di.device

    def up(a):
        t = torch.from_numpy(a)
        return t.pin_memory().to(dev, non_blocking=True) \
            if dev.type == "cuda" else t
    with trace.batch():
        with trace.span("encode:pack"):
            B = len(seqs)
            tgt = pad_to if pad_to is not None else (B + 7) // 8 * 8
            if tgt > B:
                seqs = list(seqs) + [b""] * (tgt - B)
            codes, lens = encode_batch(seqs, p.L)
            packed, nbits = pack_codes(codes)
            planes = up(packed), up(nbits), up(lens)
        return step(*planes)


def map_batch_paf(mi, step: PafStep, names, seqs, p: BatchParams, out,
                  pending=None) -> int:
    """Fetch one batch's records and write its PAF lines."""
    if pending is None:
        pending = dispatch_batch(step, seqs, p)
    rec = pending.cpu().numpy()
    sc, sub, qs, qe, rs, re_, rev, rid, cnt, rep = rec
    K, B = sc.shape
    n_mapped = 0
    for b in range(min(B, len(seqs))):    # B may include pad rows
        qlen = len(seqs[b])
        rep_len = int(rep[0, b])
        # sum_sc over primaries (hit.c:438-443): the K slots are
        # query-disjoint, so every positive slot is a primary here
        sum_sc = int(np.sum(np.maximum(sc[:, b], 0)))
        wrote = False
        for k in range(K):
            if sc[k, b] <= 0:
                break
            mq = _mapq(int(sc[k, b]), int(sub[k, b]), int(cnt[k, b]), 40,
                       rep_len=rep_len, sum_sc=sum_sc)
            if k > 0:
                mq = 0
            r0 = int(mi.seq[int(rid[k, b])].length) \
                if int(rid[k, b]) < mi.n_seq else 0
            qs_, qe_ = int(max(qs[k, b], 0)), int(min(qe[k, b], qlen))
            rs_, re2 = int(max(rs[k, b], 0)), int(min(re_[k, b], r0))
            if qe_ <= qs_ or re2 <= rs_:
                continue
            if int(rev[k, b]):
                qs_, qe_ = qlen - qe_, qlen - qs_
            mlen = min(int(cnt[k, b]) * p.k, qe_ - qs_)
            blen = max(qe_ - qs_, re2 - rs_)
            out.write("\t".join(map(str, [
                names[b], qlen, qs_, qe_, "-" if int(rev[k, b]) else "+",
                mi.seq[int(rid[k, b])].name, r0, rs_, re2, mlen, blen, mq,
                "tp:A:" + ("P" if k == 0 else "S"),
                f"cm:i:{int(cnt[k, b])}", f"s1:i:{int(sc[k, b])}",
                f"s2:i:{max(int(sub[k, b]), 0)}", f"rl:i:{rep_len}",
            ])) + "\n")
            wrote = True
        if wrote:
            n_mapped += 1
    return n_mapped


def run_batched_cli(mi, opt, queries, out, batch_reads: int = 512,
                    L: int = 16384, device=None) -> int:
    """The CLI's --batch mapping: build the device index and the step
    for the CLI's shapes, then map ``queries`` in batches of
    ``batch_reads``."""
    step = PafStep(DeviceIndex.from_host(mi, resolve_device(device)),
                   batch_params(mi, opt, L),
                   K=opt.best_n if opt.best_n < 8 else 5,
                   min_sc=opt.min_chain_score)
    return map_queries(step, mi, queries, out, batch_reads, opt=opt)


def map_queries(step: PafStep, mi, queries, out, batch_reads: int,
                opt=None) -> int:
    """Map FASTA/FASTQ files in read mega-batches and write PAF.

    A feeder thread encodes, uploads and enqueues batch n+1 while the
    caller's thread fetches batch n and writes its PAF (the kt_pipeline
    read/map/write overlap, kthread.c:97-159); output order is the input
    order.  A read longer than L flushes and drains the pipeline and is
    mapped on the host path, as in the JAX package; that needs ``opt`` and
    a host index ``mi`` (one with its sequence), and raises without."""
    p = step.p
    L = p.L
    t0 = time.time()
    n_reads = n_mapped = n_host = 0
    names, seqs = [], []
    q_disp: queue.Queue = queue.Queue(maxsize=2)
    q_done: queue.Queue = queue.Queue(maxsize=4)

    def feeder():
        # after a failure, every later batch reports it too, so the
        # caller's drain always finds its item and raises
        err = None
        while True:
            item = q_disp.get()
            if item is None:
                return
            nm, sq = item
            res = err
            if err is None:
                try:
                    res = dispatch_batch(step, sq, p, pad_to=batch_reads)
                except BaseException as e:
                    err = res = e
            q_done.put((nm, sq, res))

    th = threading.Thread(target=feeder, daemon=True)
    th.start()
    outstanding = 0

    def drain(keep: int):
        nonlocal n_mapped, outstanding
        while outstanding > keep:
            nm, sq, fut = q_done.get()
            outstanding -= 1
            if isinstance(fut, BaseException):
                raise fut
            n_mapped += map_batch_paf(mi, step, nm, sq, p, out, pending=fut)

    def flush():
        nonlocal names, seqs, outstanding
        if not names:
            return
        q_disp.put((names, seqs))
        outstanding += 1
        names, seqs = [], []
        drain(2)

    try:
        for qf in queries:
            rd = FastxReader(qf)
            try:
                while True:
                    rec = rd.read1()
                    if rec is None:
                        break
                    n_reads += 1
                    if len(rec.seq) > L:
                        if opt is None or mi.S is None:
                            raise ValueError(
                                f"read {rec.name} is longer than L={L}: its "
                                "host path needs the options and the host "
                                "index")
                        n_host += 1
                        flush()
                        drain(0)
                        _host_paf(mi, opt, rec, out)
                        continue
                    names.append(rec.name)
                    seqs.append(rec.seq)
                    if len(names) >= batch_reads:
                        flush()
            finally:
                rd.close()
        flush()
        drain(0)
    finally:
        q_disp.put(None)
        th.join()
    dt = time.time() - t0
    print(f"[M::batch] mapped {n_reads} reads in {dt:.2f}s "
          f"({n_reads / max(dt, 1e-9):.1f} reads/s) on "
          f"{step.di.device}; host path (reads longer than L): "
          f"{n_host} ({100.0 * n_host / max(n_reads, 1):.1f}%)",
          file=sys.stderr)
    return n_reads


def _stitch_segments(ab, opt, mat, meta, segs, joints, seg_cigs, qseg_full):
    """Audit and join the cigars of a segmented extent (the tail of the
    anchored decomposition).  Terminal segments may be Kadane-trimmed at
    their OUTER edge only (the reference's extensions stop at the max
    score, align.c:779-890); an inner-edge trim or an internal z-drop means
    the segments were mis-joined -> (None, meta): a fallback read.
    Returns (cigar, updated_meta)."""
    off = int(ab.seq_off[meta["rid"]])
    new_meta = dict(meta)
    out = []
    last = len(segs) - 1
    w_thr_ = max(ab.w // 2, 64)
    pend = 0        # diagonal seam bases carried into the next joint
    for si, ((qa, ra, qb, rb), cg) in enumerate(zip(segs, seg_cigs)):
        qseg_i = qseg_full[qa - meta["qs"]: qb - meta["qs"]]
        tseg_i = ab.S[off + ra: off + rb]
        tk = trace.clock()
        q0, t0, q1, t1, _bsc, tcig = native.cigar_kadane_trim(
            qseg_i, tseg_i, list(cg), mat, 5, opt.q, opt.e, opt.q2,
            opt.e2, end_bonus=max(opt.end_bonus, 0))
        trace.charge("trim_ns", tk)
        if not tcig:
            return None, meta
        if si > 0:
            # seam repair: a joint can sit up to one waypoint spacing
            # before the true breakpoint, so this segment's DP left-trims
            # bases of the PREVIOUS diagonal; a diagonal trim (q0 == t0)
            # re-attaches as an M run before the joint.  Non-diagonal or
            # oversized trims mean mis-joined segments.
            if q0 != t0 or q0 > 4 * w_thr_:
                return None, meta
            if pend + q0:
                out.append(((pend + q0) << 4) | 0)
            op_, ln_ = joints[si - 1]
            if op_ and ln_:
                out.append((ln_ << 4) | op_)
        elif q0 or t0:          # outer left edge: extension trim
            new_meta["qs"] = meta["qs"] + q0
            new_meta["rs"] = meta["rs"] + t0
        rq_, rt_ = len(qseg_i) - q1, len(tseg_i) - t1
        if si < last:
            if rq_ != rt_ or rq_ > 4 * w_thr_:
                return None, meta
            pend = rq_          # carried to the next seam's M run
        elif rq_ or rt_:        # outer right edge
            new_meta["qe"] = qa + q1
            new_meta["re"] = ra + t1
        if opt.zdrop > 0:
            tk = trace.clock()
            mz, _pos = native.zdrop_scan(qseg_i[q0:q1], tseg_i[t0:t1],
                                         tcig, mat, 5, opt.q, opt.e)
            trace.charge("trim_ns", tk)
            if mz > opt.zdrop:
                return None, meta
        out.extend(tcig)
    return _merge_cigar(out), new_meta


def _merge_cigar(cig):
    """Merge adjacent same-op entries (seam hygiene after stitching)."""
    out = []
    for c in cig:
        if out and (out[-1] & 0xF) == (c & 0xF):
            out[-1] = ((out[-1] >> 4) + (c >> 4)) << 4 | (c & 0xF)
        else:
            out.append(c)
    return out


def batch_build_regs(recs, map_out, ab, mi, opt, mat, sec_mode,
                     splice_mode=False):
    """Chain records + device CIGARs -> per-read Reg lists.

    map_out is the PafStep output: the (10, K, B) records, or (records,
    (2, B, WP) waypoints).  With splice_mode, ab is a SpliceAlignBatcher
    whose jobs come back as (cigar, transcript strand, score).  Returns
    (by_read: id(rec) -> (rec, [Reg...]), fallback [(rec, cause)],
    unmapped [rec], fb_ids).  A fallback read goes to the host mapping
    path; its causes are "oversize" (an extent segment exceeds the DP
    shape), "empty cigar", "stitch" (a segmented extent failed its audit),
    "kadane" (empty max-scoring trim), "zdrop" (internal z-drop) and "no
    primary"."""
    from .align_batch import build_reg, revcomp_codes, split_extent
    with trace.span("regs:fetch"):
        wp = None
        if isinstance(map_out, tuple):
            map_out, wp_t = map_out
            wp = wp_t.cpu().numpy()              # (2, B, WP) [wq, wr]
        arr = map_out.cpu().numpy()
    sc, sub, qs, qe, rs, re_, rev, rid, cnt, rep = arr
    jobs, jmeta = [], []
    fallback, unmapped = [], []
    with trace.span("regs:jobs") as sp:
        for b, rec in enumerate(recs):
            qlen = len(rec.seq)
            if sc[0, b] <= 0:
                unmapped.append(rec)
                continue
            codes_f = SEQ_NT4[np.frombuffer(rec.seq, np.uint8)]
            codes_r = None
            for k in range(arr.shape[1]):
                is_sec = sec_mode and k % 2 == 1
                if sc[k, b] <= 0:
                    if k == 0:
                        break
                    continue    # empty interleaved slot
                # mm_select_sub (hit.c:265): a secondary survives against its
                # own parent slot's score, with the min_diff escape
                if is_sec:
                    psc = int(sc[k - 1, b])
                    s_ = int(sc[k, b])
                    if not (s_ >= opt.pri_ratio * psc
                            or s_ + 2 * mi.k >= psc):
                        continue
                r0 = (int(mi.seq[int(rid[k, b])].length)
                      if int(rid[k, b]) < mi.n_seq else 0)
                qs_, qe_ = int(max(qs[k, b], 0)), int(min(qe[k, b], qlen))
                rs_, re2 = int(max(rs[k, b], 0)), int(min(re_[k, b], r0))
                if qe_ <= qs_ or re2 <= rs_:
                    if k == 0:
                        unmapped.append(rec)
                        break
                    continue
                if rev[k, b]:
                    if codes_r is None:
                        codes_r = revcomp_codes(codes_f)
                    codes = codes_r
                else:
                    codes = codes_f
                # extend the primary's chain extent to the read ends
                # (align.c:779-890), clamped to the contig so the global band
                # never force-inserts an overhang
                if k == 0:
                    dl = min(qs_, rs_)
                    qs_, rs_ = qs_ - dl, rs_ - dl
                    dr = min(qlen - qe_, r0 - re2)
                    qe_, re2 = qe_ + dr, re2 + dr
                # anchored decomposition (align.c:803-872): split the primary
                # extent at waypoint diagonal jumps into band-sized segments
                # joined by explicit I/D ops
                segs, joints = [(qs_, rs_, qe_, re2)], []
                if k == 0 and wp is not None:
                    segs, joints = split_extent(
                        qs_, qe_, rs_, re2, wp[0, b], wp[1, b],
                        max(ab.w // 2, 64), ab.QP, ab.TP)
                if not all(ab.fits(qb - qa, rb - ra)
                           for qa, ra, qb, rb in segs):
                    if k == 0:
                        fallback.append((rec, "oversize"))
                        break
                    continue    # drop oversize secondaries only
                for qa, ra, qb, rb in segs:
                    jobs.append((codes[qa:qb], int(rid[k, b]), ra, rb))
                jmeta.append((rec, k, is_sec, codes[qs_:qe_],
                              {"sc": int(sc[k, b]), "sub": int(sub[k, b]),
                               "cnt": int(cnt[k, b]), "rev": int(rev[k, b]),
                               "rid": int(rid[k, b]), "qs": qs_, "qe": qe_,
                               "rs": rs_, "re": re2, "rep": int(rep[0, b])},
                              segs, joints))
        sp.add(reads=len(recs), jobs=len(jobs))
    with trace.span("regs:align"):
        cigs = ab.align_jobs(jobs) if jobs else []
    by_read = {}        # id(rec) -> (rec, [Reg, ...])
    fb_ids = set()

    def fall_back(rec, k, cause):
        if k == 0 and id(rec) not in fb_ids:
            fallback.append((rec, cause))
            fb_ids.add(id(rec))

    with trace.span("regs:finish"):
        ci_ = 0
        for (rec, k, is_sec, qseg, meta, segs, joints) in jmeta:
            n_seg = len(segs)
            cres_list = cigs[ci_:ci_ + n_seg]
            ci_ += n_seg
            if splice_mode:         # one segment: (cigar, ts, device score)
                cig, ts_, dsc_ = cres_list[0]
                if meta["rev"] and ts_:
                    ts_ ^= 3        # flip to the read strand (align.c:907)
                meta = dict(meta, ts=ts_, dsc=dsc_)
            else:
                cig = cres_list[0]
                if any(not c for c in cres_list):
                    fall_back(rec, k, "empty cigar")
                    continue
            if n_seg > 1:
                cig, meta2 = _stitch_segments(ab, opt, mat, meta, segs,
                                              joints, cres_list, qseg)
                if cig is None:
                    fall_back(rec, k, "stitch")
                    continue
                qseg = qseg[meta2["qs"] - meta["qs"]:
                            len(qseg) - (meta["qe"] - meta2["qe"])]
                meta = meta2
            else:
                tseg = ab.S[ab.seq_off[meta["rid"]] + meta["rs"]:
                            ab.seq_off[meta["rid"]] + meta["re"]]
                # 1) trim the forced global path at its max-scoring sub-path
                #    (the reference's extensions STOP at the max score,
                #    align.c:779-890): junk ends and over-extension fall off;
                #    the intron penalty is the flat q2 (e2 = 0) in splice mode
                tk = trace.clock()
                q0, t0, q1, t1, _bsc, tcig = native.cigar_kadane_trim(
                    qseg, tseg, cig, mat, 5, opt.q, opt.e, opt.q2,
                    0 if splice_mode else opt.e2,
                    end_bonus=max(opt.end_bonus, 0))
                trace.charge("trim_ns", tk)
                if not tcig:
                    fall_back(rec, k, "kadane")
                    continue
                if q1 > q0 and (q0 or t0 or q1 < len(qseg) or t1 < len(tseg)):
                    meta = dict(meta)
                    meta["qe"] = meta["qs"] + q1
                    meta["qs"] += q0
                    meta["re"] = meta["rs"] + t1
                    meta["rs"] += t0
                    qseg = qseg[q0:q1]
                    tseg = tseg[t0:t1]
                    cig = tcig
                if k == 0 and id(rec) not in fb_ids and opt.zdrop > 0 \
                        and not splice_mode:
                    # 2) post-hoc z-drop audit (mm_test_zdrop align.c:61-103,
                    #    applied at :843-868): an internal drop means the
                    #    reference would split the chain (not in splice mode:
                    #    the flat-gap scan would read introns as deletions)
                    tk = trace.clock()
                    mz, _pos = native.zdrop_scan(qseg, tseg, cig, mat, 5,
                                                 opt.q, opt.e)
                    trace.charge("trim_ns", tk)
                    if mz > opt.zdrop:
                        fall_back(rec, k, "zdrop")
                        continue
            r = build_reg(mi, opt, mat, len(rec.seq), qseg, meta, cig,
                          meta["rep"], reg_id=k,
                          parent=k - 1 if is_sec else k)
            r._rep_len = meta["rep"]
            by_read.setdefault(id(rec), (rec, []))[1].append(r)
    with trace.span("regs:mapq"):
        # dp_max2 / n_sub from the aligned secondaries (mm_set_parent
        # hit.c:171-176, 226-237), then the DP-informed mm_set_mapq2
        sub_diff = opt.a * 2 + opt.b
        for _rec, regs in by_read.values():
            by_id = {r.id: r for r in regs}
            for r in regs:
                if r.parent == r.id or r.parent not in by_id:
                    continue
                rp = by_id[r.parent]
                ident = (r.rid == rp.rid and r.rs == rp.rs and r.re == rp.re)
                cnt_sub = 1 if r.cnt >= rp.cnt else 0
                if rp.p is not None and r.p is not None and not ident:
                    rp.p.dp_max2 = max(rp.p.dp_max2, r.p.dp_max)
                    if rp.p.dp_max - r.p.dp_max <= sub_diff:
                        cnt_sub = 1
                if cnt_sub:
                    rp.n_sub += 1
            hitmod.set_mapq(regs, opt.min_chain_score, opt.a,
                            regs[0]._rep_len if regs else 0,
                            bool(opt.flag & MM_F_SR),
                            bool(opt.flag & MM_F_SPLICE))
    return by_read, fallback, unmapped, fb_ids


def run_batched_align_cli(mi, opt, queries, out, batch_reads: int = 512,
                          L: int = 12288, align_kw: dict | None = None,
                          device=None):
    """--batch with -c/-a: device mapping + device base-level alignment.

    The mapping step (with secondaries, and waypoints outside splice mode)
    picks each read's chains, then their extents run through extd2 +
    traceback on the device (AlignBatcher, QP = L, TP = L + 512 unless
    align_kw says otherwise), or with -x splice through the two-round exts2
    + splice traceback (SpliceAlignBatcher, QP = min(L, 2048), TP = 8192;
    align_kw's QP, TP, G, RB and sub apply).  Returns (reads, [(name,
    cause)] of the fallback reads)."""
    from .align_batch import AlignBatcher, SpliceAlignBatcher
    dev = resolve_device(device)
    # with secondaries, each selection round yields [primary, overlapping
    # secondary] slot pairs (mm_select_sub, hit.c:255-281)
    sec_mode = opt.best_n > 0 and opt.pri_ratio > 0
    splice_mode = bool(opt.flag & MM_F_SPLICE)
    # waypoints feed the anchored decomposition (genomic modes only: the
    # splice path's introns are the exts2 kernel's business)
    step = PafStep(DeviceIndex.from_host(mi, dev), batch_params(mi, opt, L),
                   K=3 if sec_mode else 1, min_sc=opt.min_chain_score,
                   with_sec=sec_mode, with_wp=not splice_mode)
    if splice_mode:
        skw = {k: v for k, v in (align_kw or {}).items()
               if k in ("QP", "TP", "G", "RB", "sub")}
        ab = SpliceAlignBatcher(
            mi, opt, gen_ts_mat(5, opt.a, opt.b, opt.transition, opt.sc_ambi),
            device=dev, **{"QP": min(L, 2048), "TP": 8192, **skw})
    else:
        ab = AlignBatcher(mi, opt, device=dev,
                          **{"QP": L, "TP": L + 512, **(align_kw or {})})
    return align_queries(step, ab, mi, opt, queries, out, batch_reads)


def align_queries(step: PafStep, ab, mi, opt, queries, out,
                  batch_reads: int):
    """Map and align FASTA/FASTQ files in read mega-batches and write SAM
    (-a) or PAF with cg:Z (-c).  The next batch's mapping step is enqueued
    before the previous batch is aligned and written.  Each batch writes
    its device records, then maps and writes its fallback reads on the host
    path, then its unmapped SAM lines, in the JAX package's order.  A read
    longer than L is cut to its first L bases for the mapping step in both
    packages (encode_batch) and usually falls back as "oversize".  The
    fallback reads are counted by cause on the [M::batch] line and returned
    as (reads, [(name, cause)]).  As in the JAX package, the device records
    take no =/X operators under --eqx (its device path does not read
    MM_F_EQX) and stay SAM/PAF under --write-junc, while the fallback
    reads get both through write_fragment; SAM records carry the -R read
    group (opt.rg_id)."""
    mat = gen_ts_mat(5, opt.a, opt.b, opt.transition, opt.sc_ambi)
    sam = bool(opt.flag & MM_F_OUT_SAM)
    rg_id = getattr(opt, "rg_id", None)
    t0 = time.time()
    n_reads = 0
    fallbacks = []

    def emit_batch(bid, recs, map_out):
        nonlocal n_reads
        n_reads += len(recs)
        with trace.batch(bid):
            by_read, fallback, unmapped, fb_ids = batch_build_regs(
                recs, map_out, ab, mi, opt, mat, step.with_sec,
                bool(opt.flag & MM_F_SPLICE))
        for rec, regs in by_read.values():
            if id(rec) in fb_ids or not regs:
                continue
            if regs[0].id != 0:     # the primary failed
                fallback.append((rec, "no primary"))
                continue
            if sam:
                for i in range(len(regs)):
                    out.write(fmt.write_sam(mi, rec, 0, i, 1, [len(regs)],
                                            [regs], opt.flag, 0,
                                            rg_id=rg_id))
                    out.write("\n")
            else:
                for r in regs:
                    out.write(fmt.write_paf(mi, rec.name, len(rec.seq), r,
                                            opt.flag, 0, qseq=rec.seq,
                                            comment=rec.comment))
                    out.write("\n")
        fallbacks.extend((rec.name, cause) for rec, cause in fallback)
        for rec, _cause in fallback:
            _host_record(mi, opt, rec, out)
        for rec in unmapped:
            if sam and not (opt.flag & MM_F_SAM_HIT_ONLY):
                out.write(fmt.write_sam(mi, rec, 0, -1, 1, [0], [[]],
                                        opt.flag, 0, rg_id=rg_id))
                out.write("\n")

    pending = []    # [(batch id, recs, map output)]

    def queue_batch(recs):
        with trace.batch(trace.new_batch()) as bid:
            pending.append((bid, recs, dispatch_batch(
                step, [r.seq for r in recs], step.p, pad_to=batch_reads)))
        while len(pending) > 1:
            emit_batch(*pending.pop(0))

    recs = []
    for qf in queries:
        rd = FastxReader(qf)
        try:
            while True:
                rec = rd.read1()
                if rec is None:
                    break
                recs.append(rec)
                if len(recs) >= batch_reads:
                    queue_batch(recs)
                    recs = []
        finally:
            rd.close()
    if recs:
        queue_batch(recs)
    while pending:
        emit_batch(*pending.pop(0))
    dt = time.time() - t0
    n_fb = len(fallbacks)
    why = ", ".join(f"{c} {n}" for c, n in
                    sorted(Counter(c for _, c in fallbacks).items()))
    print(f"[M::batch] aligned {n_reads} reads in {dt:.2f}s "
          f"({n_reads / max(dt, 1e-9):.1f} reads/s) on {ab.device}; "
          f"host path (fallback reads): {n_fb} "
          f"({100.0 * n_fb / max(n_reads, 1):.1f}%)"
          + (f" [{why}]" if why else ""), file=sys.stderr)
    return n_reads, fallbacks


def run_batched_pe_cli(mi, opt, queries, out, batch_frags: int = 256,
                       L: int = 1024, align_kw: dict | None = None,
                       device=None):
    """--batch paired-end (-x sr r1.fq r2.fq, SAM or PAF): build the step
    and the aligner at the JAX driver's widths (JAX engine.py:831-954): 2 x
    batch_frags reads a step, L, M = max(256, L // 4), A = 2048, chain
    window 64, K = 3 with secondaries, no waypoints and no long-join pass;
    AlignBatcher QP = L, TP = L + 512, W = 256 unless align_kw says
    otherwise.  Then ``align_pairs``."""
    from .align_batch import AlignBatcher
    dev = resolve_device(device)
    p = BatchParams(L=L, M=max(256, L // 4), A=2048,
                    occ_cap=_occ_cap(opt), chain_window=64,
                    k=mi.k, w=mi.w, max_dist_x=opt.max_gap,
                    max_dist_y=opt.max_gap, bw=opt.bw,
                    hpc=bool(mi.flag & MM_I_HPC))
    sec_mode = opt.best_n > 0 and opt.pri_ratio > 0
    step = PafStep(DeviceIndex.from_host(mi, dev), p, K=3 if sec_mode else 1,
                   min_sc=opt.min_chain_score, with_sec=sec_mode)
    ab = AlignBatcher(mi, opt, device=dev, **{"QP": L, "TP": L + 512,
                                              "W": 256, **(align_kw or {})})
    return align_pairs(step, ab, mi, opt, queries, out, batch_frags)


def flatten_fragments(frags, pe_ori: int):
    """The reads of a batch of fragments, an end reverse-complemented as
    pe_ori says (worker_for map.c:437-442; as in the JAX driver, the first
    and second read of any fragment): (records, flipped flags)."""
    recs, flips = [], []
    for frag in frags:
        for j, rec in enumerate(frag):
            flip = bool((j == 0 and (pe_ori >> 1) & 1)
                        or (j == 1 and pe_ori & 1))
            recs.append(revcomp_record(rec) if flip else rec)
            flips.append(flip)
    return recs, flips


def pair_and_write(out, mi, opt, frag, regss, flips):
    """A device fragment's output: mm_pair on its per-end regions (for two
    ends), which max_chain_gap_ref (map.c:266-271) bounds as at map.c:354,
    then each reverse-complemented end's regions back to its read strand,
    then its records (their formatting time goes to the open span's
    ``sam_ns``)."""
    n_seg = len(frag)
    if n_seg == 2:
        qlens = [len(r.seq) for r in frag]
        if opt.max_gap_ref > 0:
            mgr = opt.max_gap_ref
        elif opt.max_frag_len > 0:
            mgr = max(opt.max_frag_len - sum(qlens), opt.max_gap)
        else:
            mgr = opt.max_gap
        pe_pair(mgr, opt.pe_bonus, opt.a * 2 + opt.b, opt.a, qlens, regss)
    for j in range(n_seg):
        if flips[j]:
            flip_back(regss[j], len(frag[j].seq))
    ts = trace.clock()
    write_fragment(out, mi, opt, frag, regss, [0] * n_seg)
    trace.charge("sam_ns", ts)


def align_pairs(step: PafStep, ab, mi, opt, queries, out, batch_frags: int):
    """Map and align the fragments of ``queries`` (iter_fragments: the files
    interleaved, grouped by qname) in batches of batch_frags fragments:
    both ends of a pair map and align independently on the device (the
    reference's weak-pairing mode, map.c:380-390), then mm_pair's sort +
    windowed join rescues proper pairs and blends the pair mapq
    (pe.c:81-182), in the mapped orientation, before the
    reverse-complemented end flips back to its read strand.  A fragment
    with an end whose device alignment failed its audit goes to the host
    path whole; an end past the DP shape is written unmapped, as in the
    JAX package (it is not among batch_build_regs' fb_ids).  Records are
    written fragment by fragment in input order; the next batch's mapping
    step is enqueued before the previous batch is aligned.  Returns
    (reads, [(fragment's first read name, cause)] of the host-path
    fragments)."""
    mat = gen_ts_mat(5, opt.a, opt.b, opt.transition, opt.sc_ambi)
    B = 2 * batch_frags
    t0 = time.time()
    n_reads = 0
    fallbacks = []

    def emit(bid, frags, recs, flips, map_out):
        with trace.batch(bid):
            by_read, fallback, _unm, fb_ids = batch_build_regs(
                recs, map_out, ab, mi, opt, mat, step.with_sec, False)
            with trace.span("pairing:batch"):
                emit_pairs(frags, recs, flips, by_read, fallback, fb_ids)

    def emit_pairs(frags, recs, flips, by_read, fallback, fb_ids):
        cause = {id(rec): c for rec, c in fallback}
        idx = 0
        for frag in frags:
            n_seg = len(frag)
            regss = []
            why = None
            for j in range(n_seg):
                rec = recs[idx + j]
                if id(rec) in fb_ids:
                    why = cause[id(rec)]
                    break
                regs = by_read.get(id(rec), (None, []))[1]
                if regs and regs[0].id != 0:
                    why = "no primary"
                    break
                regss.append(regs)
            if why is not None:
                idx += n_seg
                fallbacks.append((frag[0].name, why))
                t = time.perf_counter()
                results = map_fragment(mi, opt, frag)
                ts = trace.clock()
                write_fragment(out, mi, opt, frag,
                               [res.regs for res in results],
                               [res.rep_len for res in results])
                trace.charge("sam_ns", ts)
                host_path["reads"] += n_seg
                host_path["seconds"] += time.perf_counter() - t
                continue
            pair_and_write(out, mi, opt, frag, regss,
                           flips[idx:idx + n_seg])
            idx += n_seg

    pending = []    # [(batch id, frags, recs, flips, map output)]

    def queue_batch(bid, frags, rd):
        nonlocal n_reads
        recs, flips = flatten_fragments(frags, opt.pe_ori)
        rd.add(reads=len(recs))
        rd.close()
        n_reads += len(recs)
        with trace.batch(bid):
            map_out = dispatch_batch(step, [r.seq for r in recs], step.p,
                                     pad_to=B)
        pending.append((bid, frags, recs, flips, map_out))
        while len(pending) > 1:
            emit(*pending.pop(0))

    def read_span():
        # a batch's id and its span, from the first fragment it reads to
        # its flatten_fragments
        bid = trace.new_batch()
        return bid, trace.span("encode:read", batch=bid)

    buf = []
    bid, rd = read_span()
    try:
        for frag in iter_fragments(queries, True):
            buf.append(frag)
            if len(buf) >= batch_frags:
                queue_batch(bid, buf, rd)
                buf = []
                bid, rd = read_span()
        if buf:
            queue_batch(bid, buf, rd)
    finally:
        rd.close()
    while pending:
        emit(*pending.pop(0))
    dt = time.time() - t0
    why = ", ".join(f"{c} {n}" for c, n in
                    sorted(Counter(c for _, c in fallbacks).items()))
    print(f"[M::batch] aligned {n_reads} paired reads in {dt:.2f}s "
          f"({n_reads / max(dt, 1e-9):.1f} reads/s) on {ab.device}; "
          f"host path (whole fragments): {len(fallbacks)}"
          + (f" [{why}]" if why else ""), file=sys.stderr)
    return n_reads, fallbacks
