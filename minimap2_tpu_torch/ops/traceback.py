"""CIGAR traceback over extd2's / exts2's direction bytes: CUDA kernel,
plain version and the host decode.

Counterpart of minimap2_tpu.ops.traceback_pallas (traceback_batch :118,
kernel ``_bt_kernel`` :33; ``decode_ops`` :172): the ksw_backtrack walk
(ksw2.h:130-162, is_rot=1) from the global end cell (tlen-1, qlen-1) to
the origin over p (N, RT, W), reading lane ``i - ws(r)`` of diagonal r =
i + j.  Outside the band [st0, en0] of a diagonal the walk is forced (D
below the band, I above it, :79-80); inside it follows the state machine
of ksw2.h:141-147 (:86-90).  It emits one op byte per diagonal -- 1 = M,
2 = I, 3 = D, 4 = N, 0 for a diagonal the walk stepped over -- and the
leftover (i, j) in ``fin``; since r only decreases, the non-zero bytes in
descending r are the walk's moves, and ``decode_ops`` turns them into a
CIGAR on the host.

Two modes (:70-73, :96-97): extd2's rows (``ws = wstart_chunk(r, w,
RB)``, the band of width w), and with ``splice=True`` exts2's rows (``ws =
wstart_q(r, QP)``, the band unbounded, state 3 -- the intron -- emitting
op 4).  ``traceback_batch`` launches the kernel (csrc/traceback.cu) for
CUDA tensors and runs ``traceback_batch_plain`` for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .extend import wstart_chunk
from .exts import wstart_q


def traceback_batch_plain(p, lens, *, RB, w, splice=False, QP=0):
    """Plain version: the walk of every job at once, one step per diagonal
    from the highest start down (a job steps when its i + j equals r)."""
    N, RT, W = p.shape
    dev = p.device
    i64 = torch.int64
    qlen = lens[:, 0].to(i64)
    tlen = lens[:, 1].to(i64)
    iv, jv = tlen - 1, qlen - 1
    sv = torch.zeros(N, dtype=i64, device=dev)
    ops = torch.zeros((N, RT), dtype=torch.uint8, device=dev)
    rows = torch.arange(N, device=dev)
    r_hi = min(RT - 1, int((iv + jv).max())) if N else -1
    for r in range(r_hi, -1, -1):
        act = (iv >= 0) & (jv >= 0) & (iv + jv == r)
        if splice:
            st0 = torch.clamp(r - qlen + 1, min=0)
            en0 = torch.clamp(tlen - 1, max=r)
            ws = wstart_q(r, QP)
        else:
            st0 = torch.clamp(r - qlen + 1, min=max(0, (r - w + 1) >> 1))
            en0 = torch.clamp(tlen - 1, max=min(r, (r + w) >> 1))
            ws = wstart_chunk(r, w, RB)
        force = torch.where(iv > en0, 1, torch.where(iv < st0, 2, -1))
        col = iv - ws
        okc = (col >= 0) & (col < W) & (force < 0)
        tmp = torch.where(okc, p[rows, r, col.clamp(0, W - 1)].to(i64), 0)
        s1 = torch.where(sv == 0, tmp & 7,
                         torch.where((tmp >> (sv + 2)) & 1 != 0, sv, 0))
        s1 = torch.where(s1 == 0, tmp & 7, s1)
        s1 = torch.where(force >= 0, force, s1)
        is_m = s1 == 0
        is_d = (s1 == 1) | (s1 == 3)
        op = torch.where(is_m, 1, torch.where(is_d, 3, 2))
        if splice:
            op = torch.where(s1 == 3, 4, op)
        ops[:, r] = torch.where(act, op, 0)
        iv = torch.where(act & (is_m | is_d), iv - 1, iv)
        jv = torch.where(act & (is_m | ~is_d), jv - 1, jv)
        sv = torch.where(act, s1, sv)
    fin = torch.stack([iv, jv], 1).to(torch.int32)
    return ops, fin


def traceback_batch(p, lens, *, RB, w, splice=False, QP=0):
    """p: (N, RT, W) uint8 direction bytes from extd2_batch2 or, with
    splice=True, from exts2_batch at query capacity QP (with_cigar, global
    mode); lens: (N, 2) int32 [qlen, tlen].  Returns ops (N, RT) uint8 and
    fin (N, 2) int32; decode with decode_ops."""
    N, RT, W = p.shape
    if lens.shape != (N, 2):
        raise ValueError("traceback: lens (N, 2)")
    if splice and QP <= 0:
        raise ValueError("traceback: splice mode needs the query capacity QP")
    if p.device.type == "cpu":
        return traceback_batch_plain(p, lens, RB=RB, w=w, splice=splice,
                                     QP=QP)
    _build.require_cuda("traceback_batch", p, lens)
    if p.dtype != torch.uint8 or lens.dtype != torch.int32:
        raise ValueError("traceback: uint8 p and int32 lens")
    if W % 16:
        raise ValueError("traceback: the kernel reads p in 16-byte pieces "
                         "(W a multiple of 16)")
    ops = torch.empty((N, RT), dtype=torch.uint8, device=p.device)
    fin = torch.empty((N, 2), dtype=torch.int32, device=p.device)
    err = _build.lib().mm2_traceback(
        p.data_ptr(), lens.data_ptr(), ops.data_ptr(), fin.data_ptr(), N, RT,
        W, RB, w, int(splice), QP, _build.stream_ptr(p))
    _build.check(err, "mm2_traceback")
    _build.launches["traceback_splice" if splice else "traceback"] += 1
    return ops, fin


CIG_FROM_OP = np.array([255, 0, 1, 2, 3], np.uint8)  # 1=M 2=I 3=D 4=N


def decode_ops(ops_row: np.ndarray, fin_i: int, fin_j: int,
               splice: bool = False, long_thres: int = 0) -> list[int]:
    """ops (R,) u8 + leftover (i, j) -> forward cigar (len<<4|op) list,
    replicating ksw_backtrack's push + reverse (ksw2.h:155-161); in splice
    mode a leading deletion of fin_i >= long_thres is an intron (N)."""
    nz = np.nonzero(ops_row)[0]
    mv = CIG_FROM_OP[ops_row[nz]]          # ascending r = reversed walk
    cig: list[int] = []
    # the tails are pushed last, so they lead after the reverse
    if fin_i >= 0:
        lead_op = 3 if (splice and fin_i >= long_thres) else 2
        cig.append((fin_i + 1) << 4 | lead_op)   # leading deletion / N
    if fin_j >= 0:
        cig.append((fin_j + 1) << 4 | 1)   # leading insertion
    if len(mv):
        brk = np.nonzero(np.diff(mv))[0]
        starts = np.concatenate([[0], brk + 1])
        ends = np.concatenate([brk + 1, [len(mv)]])
        for s, e in zip(starts, ends):
            op = int(mv[s])
            ln = int(e - s)
            if cig and (cig[-1] & 0xF) == op:
                cig[-1] += ln << 4
            else:
                cig.append(ln << 4 | op)
    return cig
