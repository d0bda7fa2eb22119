"""Batched base-level alignment of the --batch -c/-a path (port of
minimap2_tpu.parallel.align_batch).

Each job (a read's chain extent, or one segment of it) runs ONE banded
global alignment on the extd2 kernel and its CIGAR is walked back on the
device by the traceback kernel, so the (R x W) direction bytes never cross
to the host: only the populated prefix of the one-op-per-diagonal plane
does.  The path is gated statistically, not byte-for-byte against
minimap2's align.c: chain-internal z-drop splits and end extensions are
approximated by the global band, and the host trims and audits the result
(engine.batch_build_regs).  With -x splice, SpliceAlignBatcher runs each
job through the unbanded exts2 kernel twice, once per transcript strand
(both rounds in one launch), and the splice-mode traceback labels introns
N.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..config import MM_F_SPLICE_OLD, MM_F_SR
from ..map.align_engine import fix_cigar
from ..map.hit import Extra, Reg
from ..ops.extend import EZ_SCORE, extd2_batch2
from ..ops.exts import exts2_batch, long_thres_of, splice_site_arrays
from ..ops.traceback import decode_ops, traceback_batch
from ..utils import trace
from .engine import _mapq

_COMP4 = np.array([3, 2, 1, 0, 4], np.uint8)


def _ops_extent(ops: torch.Tensor) -> int:
    """1 + the last nonzero column of the ops plane, computed on the
    device so only the populated prefix is downloaded."""
    col = torch.arange(ops.shape[1], device=ops.device)
    return int(torch.where(ops != 0, col, 0).max()) + 1


def _align_step(qr, sf, lens, *, G, W, RB, R, QP, TP, q, e, q2, e2, w,
                sc_mch, sc_mis):
    """extd2 (approx-max, global, with direction bytes) then traceback:
    (ops (N, RT) uint8, fin (N, 2) int32) on the inputs' device."""
    p, _ = extd2_batch2(qr, sf, lens, G=G, W=W, RB=RB, R=R, QP=QP, TP=TP,
                        q=q, e=e, q2=q2, e2=e2, w=w, zdrop=-1,
                        right_mode=False, approx_max=True, approx_drop=False,
                        sc_mch=sc_mch, sc_mis=sc_mis, sc_N=0,
                        with_cigar=True)
    return traceback_batch(p, lens, RB=RB, w=w)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _pack_jobs(ab, chunk, n):
    """(qr, sf, lens) host arrays of one sub-batch of (qseg, rid, rs, re)
    jobs padded to n rows: reversed queries, targets, and lens (1, 1) for
    the pad jobs."""
    qr = np.zeros((n, ab.QP), np.uint8)
    sf = np.zeros((n, ab.TP), np.uint8)
    lens = np.ones((n, 2), np.int32)
    for i, (qseg, rid, rs, re_) in enumerate(chunk):
        qr[i, :len(qseg)] = qseg[::-1]
        off = int(ab.seq_off[rid])
        tseg = ab.S[off + rs:off + re_]
        sf[i, :len(tseg)] = tseg
        lens[i] = (len(qseg), len(tseg))
    return qr, sf, lens


class AlignBatcher:
    """Aligns (read segment, reference interval) jobs in sub-batches of up
    to ``sub`` jobs on ``device``, one extd2 launch and one traceback each;
    a batch's last sub-batch is padded only to a multiple of G (to ``sub``
    when that is smaller).  The default 1024 (a multiple of G) puts a
    512-read batch's jobs in one launch: the kernel's time is set by the
    longest job's diagonals, and 6 blocks fit on each of an H100's 132 SMs,
    so one launch of ~580 jobs is faster than 512 + 64 or 256 + 256 + 64
    (PERF.md, section 6).  Device memory: a launch's direction bytes p are
    sub x RT x W bytes, RT = R rounded up to RB; at the default widths a
    full 1024-job sub-batch holds 1024 x 25,600 x 640 B = 16.8 GB.  Only
    one p is alive at a time (each is released once its traceback is
    enqueued), so the peak is one p and the small job planes."""

    def __init__(self, mi, opt, *, device, QP=12800, TP=12800, G=32, W=640,
                 RB=64, sub=1024):
        self.mi = mi
        self.opt = opt
        self.device = torch.device(device)
        self.QP, self.TP = QP, TP
        self.G, self.W, self.RB = G, W, RB
        self.sub = sub
        # chunk-uniform window: band + 48 + <= RB/2 drift must fit in W
        drift = -(-(RB // 2) // 16) * 16
        self.w = min(opt.bw, W - 48 - drift)
        self.R = (QP + TP + RB - 1) // RB * RB
        self.S = np.asarray(mi.S, np.uint8)
        self.seq_off = np.array([s.offset for s in mi.seq] or [0], np.int64)

    def fits(self, qlen_seg: int, tlen_seg: int) -> bool:
        return (0 < qlen_seg <= self.QP and 0 < tlen_seg <= self.TP
                and abs(qlen_seg - tlen_seg) <= self.w - 48)

    def dispatch(self, chunk):
        """Enqueue one sub-batch of (qseg, rid, rs, re) jobs; returns the
        (ops, fin) device tensors without waiting for them."""
        npad = min(self.sub, -(-len(chunk) // self.G) * self.G)
        qr, sf, lens = (_upload(a, self.device)
                        for a in _pack_jobs(self, chunk, npad))
        o = self.opt
        return _align_step(
            qr, sf, lens, G=self.G,
            W=self.W, RB=self.RB, R=self.R, QP=self.QP, TP=self.TP, q=o.q,
            e=o.e, q2=o.q2, e2=o.e2, w=self.w, sc_mch=o.a, sc_mis=-abs(o.b))

    def collect(self, fut, n):
        """Fetch a dispatched sub-batch and decode its n cigars: fin first,
        then only the ops columns up to the last populated one.  The time
        blocked in the downloads goes to the open span's ``wait_ns``."""
        ops, fin = fut
        tw = trace.clock()
        fin = fin.cpu().numpy()
        mx = _ops_extent(ops)
        ops = ops[:, :max(mx, 1)].cpu().numpy()
        trace.charge("wait_ns", tw)
        return [decode_ops(ops[i], int(fin[i, 0]), int(fin[i, 1]))
                for i in range(n)]

    def align_jobs(self, jobs):
        """jobs: list of (qseg u8 codes, rid, rs, re).  Returns one cigar
        (len<<4|op ints) per job, in order.  Sub-batches are
        double-buffered: the next one is enqueued before the previous one
        is fetched."""
        out = []
        inflight = []
        for lo in range(0, len(jobs), self.sub):
            chunk = jobs[lo:lo + self.sub]
            inflight.append((len(chunk), self.dispatch(chunk)))
            while len(inflight) > 1:
                n, fut = inflight.pop(0)
                out.extend(self.collect(fut, n))
        while inflight:
            n, fut = inflight.pop(0)
            out.extend(self.collect(fut, n))
        return out


class SpliceAlignBatcher:
    """Splice-aware alignment for --batch -x splice: each job runs the
    two-round transcript-strand trial of mm_align_skeleton (align.c:
    1068-1096), once with the SPLICE_FOR donor / acceptor planes and once
    with SPLICE_REV, and the round with the higher score gives the CIGAR
    (with N introns), the transcript strand and the score.  A sub-batch of
    up to ``sub`` jobs is padded to a multiple of G (EZ_DEAD's group) and
    both of its rounds go into one exts2 launch, FOR rows first, then one
    splice traceback; the next sub-batch is enqueued before the previous
    one is fetched.  Unbanded: W = QP + 32 lanes rounded up to 128 cover
    every diagonal's valid cells."""

    def __init__(self, mi, opt, mat=None, *, device, QP=2048, TP=8192, G=8,
                 RB=64, sub=256):
        self.mi = mi
        self.opt = opt
        self.device = torch.device(device)
        self.QP, self.TP = QP, TP
        self.G, self.RB, self.sub = G, RB, sub
        self.W = (QP + 32 + 127) // 128 * 128
        self.R = (QP + TP + RB - 1) // RB * RB
        self.S = np.asarray(mi.S, np.uint8)
        self.seq_off = np.array([s.offset for s in mi.seq] or [0], np.int64)
        self.cmplx = not (opt.flag & MM_F_SPLICE_OLD)
        self.long_thres = long_thres_of(opt.q, opt.e, opt.q2)[0]
        # sc_N from the scoring matrix's ambiguous entry (ksw2_exts.py:128)
        self.sc_N = -opt.e if (mat is None or int(mat[-1]) == 0) \
            else int(mat[-1])

    def fits(self, qlen_seg: int, tlen_seg: int) -> bool:
        return 0 < qlen_seg <= self.QP and 0 < tlen_seg <= self.TP

    def dispatch(self, chunk):
        """Enqueue both strand rounds of one sub-batch: one exts2 launch of
        2 x npad jobs (npad = len(chunk) rounded up to G; rows [0, npad)
        FOR, [npad, 2 npad) REV), then the splice-mode traceback.  Returns
        (ops, fin, ez) on the device without waiting for them."""
        o = self.opt
        npad = -(-len(chunk) // self.G) * self.G
        qr, sf, lens = _pack_jobs(self, chunk, npad)
        (dn_f, ac_f), (dn_r, ac_r) = (
            splice_site_arrays(sf, lens[:, 1], ff, o.noncan, self.cmplx,
                               False) for ff in (True, False))
        qr_t, sf_t, dn_t, ac_t, lens_t = (
            _upload(np.concatenate(a), self.device)
            for a in ((qr, qr), (sf, sf), (dn_f, dn_r), (ac_f, ac_r),
                      (lens, lens)))
        p, ez = exts2_batch(
            qr_t, sf_t, dn_t, ac_t, lens_t, G=self.G, W=self.W, RB=self.RB,
            R=self.R, QP=self.QP, TP=self.TP, q=o.q, e=o.e, q2=o.q2,
            zdrop=-1, right_mode=False, approx_max=True, approx_drop=False,
            sc_mch=o.a, sc_mis=-abs(o.b), sc_N=self.sc_N, with_cigar=True)
        ops, fin = traceback_batch(p, lens_t, RB=self.RB, w=0, splice=True,
                                   QP=self.QP)
        return ops, fin, ez

    def fetch(self, fut):
        """Download a dispatched sub-batch: fin and ez, then the ops columns
        up to the last populated one (the time blocked goes to the open
        span's ``wait_ns``)."""
        ops, fin, ez = fut
        tw = trace.clock()
        fin = fin.cpu().numpy()
        mx = _ops_extent(ops)
        out = ops[:, :max(mx, 1)].cpu().numpy(), fin, ez.cpu().numpy()
        trace.charge("wait_ns", tw)
        return out

    def pick(self, chunk, fetched):
        """[(cigar, trans_strand, score)] of a fetched sub-batch: per job
        the better of the FOR / REV rounds, a tie giving ts = 3 and the
        round of mm_align_skeleton's pseudo-random pick (align.c:
        1078-1080)."""
        ops, fin, ez = fetched
        npad = len(ez) // 2
        out = []
        for i in range(len(chunk)):
            sc_f = int(ez[i, EZ_SCORE])
            sc_r = int(ez[npad + i, EZ_SCORE])
            if sc_f > sc_r:
                row, ts = i, 1
            elif sc_f < sc_r:
                row, ts = npad + i, 2
            else:
                ts = 3
                row = npad + i if (len(chunk[i][0]) + sc_f) & 1 else i
            cig = decode_ops(ops[row], int(fin[row, 0]), int(fin[row, 1]),
                             splice=True, long_thres=self.long_thres)
            out.append((cig, ts, int(ez[row, EZ_SCORE])))
        return out

    def align_jobs(self, jobs):
        """Returns [(cigar, trans_strand, score)] per job, in order."""
        out = []
        inflight = []
        for lo in range(0, len(jobs), self.sub):
            chunk = jobs[lo:lo + self.sub]
            inflight.append((chunk, self.dispatch(chunk)))
            while len(inflight) > 1:
                chunk0, fut = inflight.pop(0)
                out.extend(self.pick(chunk0, self.fetch(fut)))
        while inflight:
            chunk0, fut = inflight.pop(0)
            out.extend(self.pick(chunk0, self.fetch(fut)))
        return out


def split_extent(qs, qe, rs, re_, wq, wr, w_thr, qp_max, tp_max):
    """Anchored decomposition of one chain extent (align.c:803-872 as
    segment planning): walk the chain waypoints and cut the extent where
    the diagonal jumps by more than w_thr (an SV-scale indel the band
    cannot absorb) or a segment outgrows the DP capacity.  Returns (segs,
    joints): segs = [(qa, ra, qb, rb)], joints[i] between segment i and
    i+1 is (op, len) with op 1=I, 2=D, 0=plain concatenation.  A jump is
    attributed to the waypoint before it; the next segment's banded DP
    re-places the bases within one waypoint spacing."""
    pts = [(int(qs), int(rs))]
    for q, r in zip(wq, wr):
        q, r = int(q), int(r)
        if q < 0:
            continue
        if qs < q < qe and rs < r < re_ and q > pts[-1][0] \
                and r > pts[-1][1]:
            pts.append((q, r))
    pts.append((int(qe), int(re_)))
    segs, joints = [], []
    sq, sr = pts[0]
    for (q1, r1), (q2, r2) in zip(pts, pts[1:]):
        d = (r2 - r1) - (q2 - q1)
        if abs(d) > w_thr and q1 > sq and r1 > sr:
            segs.append((sq, sr, q1, r1))
            if d > 0:
                joints.append((2, d))           # deletion joint
                sq, sr = q1, r1 + d
            else:
                joints.append((1, -d))          # insertion joint
                sq, sr = q1 - d, r1
        elif (q2 - sq > qp_max - 512 or r2 - sr > tp_max - 512) \
                and q1 > sq and r1 > sr:
            segs.append((sq, sr, q1, r1))       # capacity cut, no joint
            joints.append((0, 0))
            sq, sr = q1, r1
    segs.append((sq, sr, int(qe), int(re_)))
    return segs, joints


def build_reg(mi, opt, mat, qlen, qseg, rec, cigar, rep_len, reg_id=0,
              parent=None):
    """Chain record + device cigar -> a Reg the SAM/PAF writers accept.

    rec: dict with keys sc, sub, cnt, rev, rid, qs, qe, rs, re in STRAND
    coordinates (qs/qe on the aligned strand), and on the splice path ts
    (transcript strand) and dsc (device DP score).  parent != reg_id marks
    a secondary of that parent chain (tp:A:S, SAM 0x100, mapq 0)."""
    r = Reg()
    r.id = reg_id
    r.parent = reg_id if parent is None else parent
    sec = r.parent != r.id
    r.rid = int(rec["rid"])
    r.rev = bool(rec["rev"])
    r.cnt = int(rec["cnt"])
    r.qs, r.qe = int(rec["qs"]), int(rec["qe"])
    r.rs, r.re = int(rec["rs"]), int(rec["re"])
    if r.rev:       # back to read coordinates (hit.c:23-38)
        r.qs, r.qe = qlen - int(rec["qe"]), qlen - int(rec["qs"])
    r.score = r.score0 = int(rec["sc"])
    r.subsc = max(int(rec["sub"]), 0)
    r.mapq = (0 if sec else
              _mapq(int(rec["sc"]), int(rec["sub"]), int(rec["cnt"]),
                    opt.min_chain_score))
    r.sam_pri = reg_id == 0
    p = Extra()
    p.cigar = list(cigar)
    p.trans_strand = int(rec.get("ts", 0))
    r.is_spliced = any((c & 0xF) == 3 for c in p.cigar)
    off = mi.seq[r.rid].offset
    tseg = mi.S[off + int(rec["rs"]):off + int(rec["re"])]
    # canonicalize like the host path: indel left-shift, 5I6D7I merge,
    # leading-indel removal (mm_fix_cigar align.c:105-181)
    r.p = p
    qshift, tshift = fix_cigar(r, qseg, tseg)
    qseg = qseg[qshift:]
    tseg = tseg[tshift:]
    blen, mlen, n_ambi, dp_max, spliced = native.update_extra_scan(
        qseg, tseg, p.cigar, mat, 5, opt.q, opt.e,
        not (opt.flag & MM_F_SR))     # log_gap (align.c:906)
    r.blen, r.mlen, p.n_ambi = blen, mlen, n_ambi
    r.is_spliced = bool(spliced) or r.is_spliced
    p.dp_max = p.dp_max0 = p.dp_score = dp_max
    if "dsc" in rec:            # the device DP score of the splice path:
        p.dp_score = int(rec["dsc"])      # the AS:i of the ksw run
    if r.is_spliced and p.trans_strand:   # align.c:1090-1094
        if p.trans_strand in (1, 2):
            p.dp_max += (opt.a + opt.b) + ((opt.a + opt.b) >> 1)
        elif p.trans_strand == 3:
            p.dp_max -= opt.a + opt.b
    r.div = -1.0
    return r


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _COMP4[codes[::-1]]
