"""Windowed chaining DP over sorted anchors: CUDA kernel and plain version.

Counterpart of minimap2_tpu.ops.chain_pallas.chain_batch (chain_pallas.py:
39-176): for each anchor i, the best of the last WND predecessors under
comput_sc (lchain.c:113-138) with the float32 mg_log2 gap penalty
(mmpriv.h:139-147).  Ties go to the largest predecessor index j (the C
scan walks j downwards with a strict '>').  Outputs per anchor: score f,
predecessor pred (global index, -1 = none), and the chain's start
coordinates qs, rs.

The float ops run one at a time, each rounded to float32 (no fused
multiply-add), so the truncated penalty matches the reference's.

``chain_batch`` launches the kernel (csrc/chain.cu) for CUDA tensors and
runs ``chain_batch_plain`` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

NEG_INF = -0x40000000
_C1 = np.float32(-0.34484843)
_C2 = np.float32(2.02466578)
_C3 = np.float32(0.67487759)


@functools.lru_cache(maxsize=None)
def _f32(v: float, device: torch.device) -> torch.Tensor:
    """A float32 scalar tensor on ``device``, made once: a fresh copy to the
    card at every step of the chain scan would synchronise the stream."""
    return torch.tensor(np.float32(v), device=device)


def mg_log2(x: torch.Tensor) -> torch.Tensor:
    """mg_log2 (mmpriv.h:139-147) on a float32 tensor, bit-exact."""
    zi = x.to(torch.float32).view(torch.int32)
    log2i = (((zi >> 23) & 255) - 128).to(torch.float32)
    zf = ((zi & 0x007FFFFF) | (127 << 23)).view(torch.float32)
    c = [_f32(float(v), x.device) for v in (_C1, _C2, _C3)]
    return log2i + ((c[0] * zf + c[1]) * zf - c[2])


def chain_penalty(dd, dg, chn_pen_gap: float, chn_pen_skip: float):
    """trunc(gap*dd + skip*dg + 0.5*mg_log2(dd+1)) as int32 (0 log term
    where dd < 1), each float op rounded on its own."""
    dev = dd.device
    gap, skip = _f32(chn_pen_gap, dev), _f32(chn_pen_skip, dev)
    lin = gap * dd.to(torch.float32) + skip * dg.to(torch.float32)
    logp = torch.where(dd >= 1, mg_log2((dd + 1).to(torch.float32)),
                       _f32(0.0, dev))
    half = _f32(0.5, dev)
    return torch.trunc(lin + half * logp).to(torch.int32)


def comput_sc(qp, rp, rv, ri, qposw, rposw, revw, ridw, spanw, fw,
              max_dist_x, max_dist_y, bw, chn_pen_gap, chn_pen_skip):
    """Candidate scores (B, WND) of anchor (qp, rp, rv, ri) (each (B,))
    against the window of predecessors; NEG_INF where joining is barred."""
    dq = qp[:, None] - qposw
    dr = rp[:, None] - rposw
    same = (revw == rv[:, None]) & (ridw == ri[:, None])
    dd = torch.abs(dr - dq)
    bad = (dq <= 0) | (dq > max_dist_x) | (dr == 0) | (dq > max_dist_y)
    bad |= (dd > bw) | ~same
    dg = torch.minimum(dr, dq)
    # the PREDECESSOR's q_span caps the gain (lchain.c:126)
    sc = torch.minimum(spanw, dg)
    pen = chain_penalty(dd, dg, chn_pen_gap, chn_pen_skip)
    need = (dd != 0) | (dg > spanw)
    sc = torch.where(need, sc - pen, sc)
    return torch.where(bad | (fw <= NEG_INF // 2),
                       torch.full_like(fw, NEG_INF), fw + sc)


def last_valid(av: torch.Tensor) -> int:
    """1 + the largest anchor index valid in any row (0 if none)."""
    idx = torch.arange(av.shape[1], device=av.device)
    return int(torch.where(av, idx, -1).max()) + 1 if av.numel() else 0


def chain_batch_plain(rev, rid, rpos, qpos, span, av, WND, max_dist_x,
                      max_dist_y, bw, chn_pen_gap, chn_pen_skip):
    """Plain version: a loop over anchors on (B, WND) ring windows.  Past
    the last valid anchor nothing reads the window again, so those lanes
    take their closed form (f NEG_INF, pred -1, qs/rs = pos - span + 1)."""
    B, A = rpos.shape
    dev = rpos.device
    i32 = torch.int32
    f = torch.full((B, A), NEG_INF, dtype=i32, device=dev)
    pred = torch.full((B, A), -1, dtype=i32, device=dev)
    qs = (qpos - span + 1).to(i32)
    rs = (rpos - span + 1).to(i32)
    z = torch.zeros((B, WND), dtype=i32, device=dev)
    fw = torch.full((B, WND), NEG_INF, dtype=i32, device=dev)
    revw, ridw, rposw, qposw, spanw, qsw, rsw = (z.clone() for _ in range(7))
    jw = torch.full((B, WND), -1, dtype=i32, device=dev)
    neg = torch.full((B, WND), NEG_INF, dtype=i32, device=dev)
    for a in range(last_valid(av)):
        rv, ri, rp, qp, sp, ok = (x[:, a] for x in
                                  (rev, rid, rpos, qpos, span, av))
        cand = comput_sc(qp, rp, rv, ri, qposw, rposw, revw, ridw, spanw, fw,
                         max_dist_x, max_dist_y, bw, chn_pen_gap,
                         chn_pen_skip)
        bsc = cand.amax(1)
        tie = cand == bsc[:, None]
        selj = torch.where(tie, jw, -1).amax(1)
        onehot = (jw == selj[:, None]) & tie

        def pick(arr):
            return torch.where(onehot, arr, neg).amax(1)

        use = (bsc >= sp) & ok
        f_a = torch.where(ok, torch.where(bsc >= sp, bsc, sp),
                          torch.full_like(sp, NEG_INF))
        qs_a = torch.where(use, pick(qsw), qs[:, a])
        rs_a = torch.where(use, pick(rsw), rs[:, a])
        f[:, a] = f_a
        pred[:, a] = torch.where(use, pick(jw), torch.full_like(sp, -1))
        qs[:, a] = qs_a
        rs[:, a] = rs_a
        s = a % WND
        for wnd, val in ((fw, f_a), (revw, rv), (ridw, ri), (rposw, rp),
                         (qposw, qp), (spanw, sp), (qsw, qs_a), (rsw, rs_a)):
            wnd[:, s] = val
        jw[:, s] = a
    return f, pred, qs, rs


def chain_batch(rev, rid, rpos, qpos, span, av, *, WND: int, max_dist_x: int,
                max_dist_y: int, bw: int, chn_pen_gap: float,
                chn_pen_skip: float):
    """Windowed chain DP.  Inputs (B, A) int32 planes + av bool; returns
    (f, pred, qs_a, rs_a) as (B, A) int32."""
    args = (WND, max_dist_x, max_dist_y, bw, chn_pen_gap, chn_pen_skip)
    if rpos.device.type == "cpu":
        return chain_batch_plain(rev, rid, rpos, qpos, span, av, *args)
    planes = (rev, rid, rpos, qpos, span)
    _build.require_cuda("chain_batch", *planes, av)
    B, A = rpos.shape
    if any(x.dtype != torch.int32 or x.shape != (B, A) for x in planes) \
            or av.dtype != torch.bool or av.shape != (B, A):
        raise ValueError("chain_batch: five (B, A) int32 planes + bool av")
    if WND < 1 or WND > max_window():
        raise ValueError(f"chain_batch: the kernel takes 1 <= WND <= "
                         f"{max_window()} (the shared-memory ring's "
                         f"ceiling), got {WND}")
    if A % 16 or any(x.data_ptr() % 16 for x in (*planes, av)):
        raise ValueError("chain_batch: the kernel stages anchors in 16-byte "
                         "pieces (A a multiple of 16, planes 16-byte "
                         "aligned)")
    outs = [torch.empty_like(rpos) for _ in range(4)]
    err = _build.lib().mm2_chain(
        *(x.data_ptr() for x in planes), av.data_ptr(),
        *(o.data_ptr() for o in outs), B, A, WND, max_dist_x, max_dist_y, bw,
        float(np.float32(chn_pen_gap)), float(np.float32(chn_pen_skip)),
        _build.stream_ptr(rpos))
    _build.check(err, "mm2_chain")
    _build.launches[launch_name(WND)] += 1
    return tuple(outs)


def slots_a_lane(WND: int) -> int:
    """The kernel's route for a window: 1, 2, 4 or 8 slots a lane in
    registers (WND <= 32, 64, 128, 256), else 0, the window in a ring in
    shared memory (csrc/chain.cu)."""
    for sl in (1, 2, 4, 8):
        if WND <= 32 * sl:
            return sl
    return 0


@functools.lru_cache(maxsize=None)
def max_window() -> int:
    """The largest window the shared-memory ring takes on this card."""
    n = ctypes.c_int(0)
    _build.check(_build.lib().mm2_chain_max_window(ctypes.byref(n)),
                 "mm2_chain_max_window")
    return n.value


def launch_name(WND: int) -> str:
    """The launch counter of the window's instantiation: ``chain`` at the
    paths' WND 64, else ``chain_w<WND>``."""
    return "chain" if WND == 64 else f"chain_w{WND}"
