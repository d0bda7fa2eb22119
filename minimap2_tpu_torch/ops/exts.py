"""Splice-aware extension with direction bytes (ksw_exts2): CUDA kernel,
plain version and the host splice-site planes, in every mode of the JAX
kernel.

Counterpart of minimap2_tpu.ops.exts_pallas.exts2_batch (exts_pallas.py:
536-556 -> ``_exts2_call`` :488 -> the Pallas kernel ``_exts2_kernel``
:111-425).  The ``--batch -x splice`` path (align_batch.py:189-196 of the
JAX package) runs approx-max, no zdrop, left-align, with direction bytes;
the kernel's other modes are exact-max (the H row, its maximum, mqe/mte
and ksw_apply_zdrop with e = 0: introns are free, :297-345), approx-drop
(the z-drop test on the H0 walk, :371-376), right-align (the ``>=`` forms
of the compares, :245-292) and no-cigar (no p: ``None``, where the JAX
kernel returns a (1, 1, 1, 1, 128) placeholder).  The Suzuki-Kasahara difference
recurrence of ksw_exts2_sse runs over anti-diagonals r on int32 lanes with
int8 wrap arithmetic (``_wrap8``); the second gap state is the intron x2
(open cost q2, no extension cost) with per-target donor / acceptor
adjustments; the score comes from the greedy H0 walk.  Both versions keep
the JAX package's layout, because the result depends on it:

* the DP is unbanded ([st0, en0] = the whole valid diagonal), and lane
  ``l`` of diagonal ``r`` is target position ``wstart_q(r, QP) + l``: the
  window follows the query edge, so ``r - ws(r)`` is a sawtooth; whenever
  ``ws`` steps by 16 the carried rows shift left 16 lanes with the fill
  values -q-e, -q2 and 0 (:198-211);
* at lane ``r`` the rows y, x2 and u are reset (:213-217) before the left
  neighbours are read, so x2's neighbour there is -q2;
* the score row ``s`` is rewritten on ``[st0, s_hi]`` only (:219-233);
* a target code past TP is 0; the donor / acceptor planes are i8
  (:227-228); there is no max_sc clamp (:263-264);
* continuation bits 0x08 / 0x10 / 0x20 (:290-292), rows 0 outside the
  updated lanes (:293).

``EZ_DEAD`` depends on the Pallas grid's group skip (:392-394), exactly
as in extd2; ``extend._ez_dead`` applies that rule (a z-dropped job, which
stops after that diagonal, is reported in lane ``EZ_ZFLAG``).  Outputs: ``p`` (N,
RC*RB, W) uint8 (JAX's (NG, RC, RB, G, W) block after a transpose), ``ez``
(N, 16) int32.  ``exts2_batch`` launches the kernel (csrc/exts2.cu) for
CUDA tensors and runs ``exts2_batch_plain`` for CPU tensors; either way
the jobs run in ``job_order`` (longest first) and come back in job order.
"""
from __future__ import annotations


import numpy as np
import torch

from . import _build
from .extend import (EZ_N, NEG_INF32, _ez_dead, _ez_out, _h_row, _sext8,
                     _zdrop_step, job_order)

# the widest window the kernel takes: its lane offsets inside a job's rows
# are int (ROADMAP Queue 3); the JAX kernel asserts no ceiling
MAX_W = 1 << 24


def wstart_q(r: int, QP: int) -> int:
    """Query-edge window start of diagonal r (16-aligned)."""
    return max(0, r - QP + 1) // 16 * 16


def long_thres_of(q: int, e: int, q2: int) -> tuple[int, int]:
    """(long_thres, long_diff) of ksw_exts2 (exts_pallas.py:118-122): the
    gap length from which the intron state is the cheaper deletion."""
    long_thres = (q2 - q) // e - 1
    if q2 > q + e + long_thres * e:
        long_thres += 1
    return long_thres, long_thres * e - (q2 - q)


def _wrap8(x):
    """int8 wrap of an int tensor (x mod 256 in [-128, 127])."""
    return ((x + 128) & 255) - 128


def splice_site_arrays(tseqs: np.ndarray, tlens: np.ndarray, flag_for: bool,
                       noncan: int, cmplx: bool, flank: bool):
    """Donor / acceptor penalty planes of a (N, TP) target batch
    (ksw2_exts2_sse.c:120-192, non-REV_CIGAR orientations; a copy of
    exts_pallas.splice_site_arrays).  Returns (donor, acceptor) (N, TP)
    int8."""
    sp0 = [8, 15, 21, 30]
    if cmplx:
        sp = [int(v / 3.0 + 0.499) for v in sp0]
    else:
        sp = [noncan // 2 if flank else 0, noncan, noncan, noncan]
    sp = np.array(sp, np.int64)
    N, TP = tseqs.shape
    t = tseqs.astype(np.int64)
    t1 = np.concatenate([t[:, 1:], np.full((N, 1), 4, np.int64)], 1)
    t2 = np.concatenate([t[:, 2:], np.full((N, 2), 4, np.int64)], 1)
    t3 = np.concatenate([t[:, 3:], np.full((N, 3), 4, np.int64)], 1)
    tm1 = np.concatenate([np.full((N, 1), 4, np.int64), t[:, :-1]], 1)
    tm2 = np.concatenate([np.full((N, 2), 4, np.int64), t[:, :-2]], 1)
    z_d = np.full((N, TP), 3, np.int64)
    z_a = np.full((N, TP), 3, np.int64)
    if flag_for:
        # donor GT[A/G], acceptor [C/T]AG
        z_d = np.where((t1 == 2) & (t2 == 3),
                       np.where((t3 == 0) | (t3 == 2), -1, 0), z_d)
        z_d = np.where((t1 == 2) & (t2 == 1), 1, z_d)
        z_d = np.where((t1 == 0) & (t2 == 3), 2, z_d)
        z_a = np.where((tm1 == 0) & (t == 2),
                       np.where((tm2 == 1) | (tm2 == 3), -1, 0), z_a)
        z_a = np.where((tm1 == 0) & (t == 1), 2, z_a)
    else:
        # reverse-strand signals (CT..AC)
        z_d = np.where((t1 == 1) & (t2 == 3),
                       np.where((t3 == 0) | (t3 == 2), -1, 0), z_d)
        z_d = np.where((t1 == 2) & (t2 == 3), 2, z_d)
        z_a = np.where((tm1 == 0) & (t == 1),
                       np.where((tm2 == 1) | (tm2 == 3), -1, 0), z_a)
        z_a = np.where((tm1 == 2) & (t == 1), 1, z_a)
        z_a = np.where((tm1 == 0) & (t == 3), 2, z_a)
    donor = np.where(z_d < 0, 0, -sp[np.clip(z_d, 0, 3)])
    acceptor = np.where(z_a < 0, 0, -sp[np.clip(z_a, 0, 3)])
    # range limits: donor defined for t < tlen-4, acceptor for t >= 2
    col = np.arange(TP)[None, :]
    donor = np.where(col < tlens[:, None] - 4, donor, -sp[3])
    acceptor = np.where((col >= 2) & (col < tlens[:, None]), acceptor,
                        -sp[3])
    return donor.astype(np.int8), acceptor.astype(np.int8)


def _check(W, QP):
    """The shapes the kernel takes: the JAX kernel's (W % 128, W >= QP +
    32), and W <= MAX_W."""
    if W % 128 or W < QP + 32 or W > MAX_W:
        raise ValueError(f"exts2: need W % 128 == 0, W >= QP + 32 and "
                         f"W <= {MAX_W} (W={W}, QP={QP})")


def exts2_batch_plain(qr, sf, dn, ac, lens, *, W, RT, QP, q, e, q2, sc_mch,
                      sc_mis, sc_N, with_cigar=True, approx_max=True,
                      approx_drop=False, right_mode=False, zdrop=-1):
    """Plain version on (N, W) lanes with a loop over anti-diagonals.
    qr: (N, QP) uint8 REVERSED queries; sf: (N, TP) uint8 targets; dn / ac:
    (N, TP) int8 donor / acceptor; lens (N, 2) int32.  Returns (p or None,
    ez) before the EZ_DEAD rule."""
    exact = not approx_max
    N = qr.shape[0]
    TP = sf.shape[1]
    dev = qr.device
    i32, i64 = torch.int32, torch.int64
    qe = q + e
    long_thres, long_diff = long_thres_of(q, e, q2)
    qlen = lens[:, 0].to(i64)
    tlen = lens[:, 1].to(i64)
    rstar = qlen + tlen - 1
    # qxa[n, c - qpos] = q[n, qpos] (0 outside the query): the query codes
    # of diagonal r are the contiguous window qxa[:, c - r + ws : + W]
    c = max(r - wstart_q(r, QP) for r in range(min(RT, QP + 16))) + 8
    j = torch.arange(c + W, device=dev)[None, :]
    src = j - (c - qlen[:, None] + 1)
    qxa = torch.where((src >= 0) & (src < qlen[:, None]),
                      qr.gather(1, src.clamp(0, QP - 1)).to(i32), 0)
    CT = max(TP, wstart_q(RT - 1, QP) + W)

    def padT(a):
        z = torch.zeros((N, CT), dtype=i32, device=dev)
        z[:, :TP] = a.to(i32)
        return z
    sfz, dnz, acz = padT(sf), padT(dn), padT(ac)

    def full(v):
        return torch.full((N, W), v, dtype=i32, device=dev)
    u, v, x, y, x2, s = full(-qe), full(-qe), full(-qe), full(-qe), \
        full(-q2), full(0)
    H = full(NEG_INF32) if exact else None
    zeros = torch.zeros(N, dtype=i64, device=dev)
    zflag = zeros.clone()
    best = (zeros, zeros - 1, zeros - 1)                 # mx, mxt, mxq
    # mte, mteq, mqe, mqet, score
    ends = (zeros + NEG_INF32, zeros - 1, zeros + NEG_INF32, zeros - 1,
            zeros + NEG_INF32)
    dead, zdr, last_st, nr = (zeros.bool(), zeros.clone(), zeros.clone(),
                              zeros.clone())
    H0, h0t = zeros.clone(), zeros.clone()
    p = torch.zeros((N, RT, W), dtype=torch.uint8, device=dev) \
        if with_cigar else None
    lane = torch.arange(W, device=dev)[None, :]
    rows = torch.arange(N, device=dev)
    fills = (-qe, -qe, -qe, -qe, -q2, 0)
    ws = 0
    for r in range(RT):
        if not bool((~dead).any()):
            break
        ws_prev, ws = ws, wstart_q(r, QP)
        dead = dead | (r >= rstar)
        st0 = torch.clamp(r - qlen + 1, min=0)
        en0 = torch.clamp(tlen - 1, max=r)
        band_dead = st0 > en0
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        live = ~(dead | band_dead)
        use_prev = (st - last_st == 16) & live & (st > 0)
        # boundary scalars at st - 1 of the previous diagonal's window
        pre = st - 1 - ws_prev
        okp = (pre >= 0) & (pre < W)
        prei = pre.clamp(0, W - 1)[:, None]

        def at_pre(a):
            return torch.where(okp, _sext8(a.gather(1, prei)[:, 0]), 0)
        x1 = torch.where(use_prev, at_pre(x), -qe)
        x21 = torch.where(use_prev, at_pre(x2), -q2)
        v1_edge = (-qe if r == 0 else -e if r < long_thres
                   else long_diff if r == long_thres else 0)
        v1 = torch.where(use_prev, at_pre(v),
                         torch.where(st > 0, -qe, v1_edge))
        if ws != ws_prev:   # the window stepped 16: shift with fills
            u, v, x, y, x2, s = (
                torch.cat([a[:, 16:], torch.full((N, 16), f, dtype=i32,
                                                 device=dev)], 1)
                for a, f in zip((u, v, x, y, x2, s), fills))
            if exact:
                H = torch.cat([H[:, 16:], torch.full(
                    (N, 16), NEG_INF32, dtype=i32, device=dev)], 1)
        t_abs = lane + ws
        at_r = (t_abs == r) & (en >= r)[:, None]
        y = torch.where(at_r, -qe, y)
        x2 = torch.where(at_r, -q2, x2)
        u_p = torch.where(at_r, v1_edge, u)
        s_hi = st0 + (en0 - st0) // 16 * 16 + 15
        scov = (t_abs >= st0[:, None]) & (t_abs <= s_hi[:, None]) \
            & live[:, None]
        tq = sfz[:, ws:ws + W]
        qq = qxa[:, c - r + ws:c - r + ws + W]
        dnr, acr = dnz[:, ws:ws + W], acz[:, ws:ws + W]
        sval = torch.where(tq == qq, sc_mch, sc_mis)
        sval = torch.where((tq == 4) | (qq == 4), sc_N, sval).to(i32)
        s = torch.where(scov, sval, s)
        at_stl = lane == (st - ws)[:, None]
        xt1 = torch.where(at_stl, x1[:, None].to(i32), x.roll(1, 1))
        vt1 = torch.where(at_stl, v1[:, None].to(i32), v.roll(1, 1))
        x2t1 = torch.where(at_stl, x21[:, None].to(i32), x2.roll(1, 1))
        a = _wrap8(xt1 + vt1)
        b = _wrap8(y + u_p)
        a2 = _wrap8(x2t1 + vt1)
        a2a = _wrap8(a2 + acr)
        z = s
        if right_mode:
            d = (z <= a).to(torch.uint8)
            z = torch.maximum(z, a)
            d = torch.where(z > b, d, 2)
            z = torch.maximum(z, b)
            d = torch.where(z > a2a, d, 3)
            z = torch.maximum(z, a2a)
        else:
            d = (a > z).to(torch.uint8)
            z = torch.maximum(z, a)
            d = torch.where(b > z, 2, d)
            z = torch.maximum(z, b)
            d = torch.where(a2a > z, 3, d)
            z = torch.maximum(z, a2a)
        u_new = _wrap8(z - vt1)
        v_new = _wrap8(z - u_p)
        t1 = _wrap8(z - q)
        a = _wrap8(a - t1)
        b = _wrap8(b - t1)
        a2 = _wrap8(a2 - _wrap8(z - q2))
        if right_mode:
            ga, gb, g2 = a >= 0, b >= 0, a2 >= dnr
        else:
            ga, gb, g2 = a > 0, b > 0, a2 > dnr
        m_upd = live[:, None] & (t_abs >= st[:, None]) \
            & (t_abs <= en[:, None])
        u = torch.where(m_upd, u_new, u_p)
        v = torch.where(m_upd, v_new, v)
        x = torch.where(m_upd, _wrap8(torch.where(ga, a, 0) - qe), x)
        y = torch.where(m_upd, _wrap8(torch.where(gb, b, 0) - qe), y)
        x2 = torch.where(m_upd, _wrap8(torch.where(g2, a2, dnr) - q2), x2)
        if with_cigar:
            d = d | (ga.to(torch.uint8) << 3) | (gb.to(torch.uint8) << 4) \
                | (g2.to(torch.uint8) << 5)
            p[:, r] = torch.where(m_upd, d, 0)
        fin = live & (r == rstar - 1) & (en0 == tlen - 1)
        if exact:
            H, max_H, max_t, ends = _h_row(
                H, u, v, r, ws, st0, en0, qlen, tlen, live, fin, qe, lane,
                t_abs, ends)
        else:
            # greedy H0 walk: lane lx = h0t + 1 - ws holds (v[t0], u[t0 + 1])
            lx = h0t + 1 - ws
            okx = (lx >= 0) & (lx < W)
            d0 = torch.where(okx, _sext8(v[rows, (lx - 1) % W]), 0)
            d1 = torch.where(okx, _sext8(u[rows, lx.clamp(0, W - 1)]), 0)
            in0 = (st0 <= h0t) & (h0t <= en0)
            in1 = (st0 <= h0t + 1) & (h0t + 1 <= en0)
            case12 = in0 & in1
            step_t = case12 & (d1 >= d0)
            delta = torch.where(case12, torch.where(step_t, d1, d0),
                                torch.where(in0, d0, d1))
            if r == 0:
                H0_new, h0t_new = v[:, 0].to(i64) - qe, zeros
            else:
                H0_new, h0t_new = H0 + delta, h0t + (step_t | ~in0).to(i64)
            H0 = torch.where(live, H0_new, H0)
            h0t = torch.where(live, h0t_new, h0t)
            ends = ends[:4] + (torch.where(fin, H0, ends[4]),)
            max_H, max_t = H0, h0t
        zdropped = zeros.bool()
        if exact or approx_drop:      # e = 0: introns are free
            zdropped, best = _zdrop_step(max_H, max_t, r, live, zdrop, 0,
                                         best)
        zdr = torch.where((~dead & band_dead) | zdropped, 1, zdr)
        zflag = zflag | zdropped
        dead = dead | band_dead | zdropped
        last_st = torch.where(live, st, last_st)
        nr = torch.where(live, r + 1, nr)
    return p, _ez_out(best, ends, zdr, last_st, nr, H0, h0t, zflag)


def exts2_batch(qr, sf, dn, ac, lens, *, G, W, RB, R, QP, TP, q, e, q2,
                zdrop, right_mode, approx_max, approx_drop, sc_mch, sc_mis,
                sc_N, with_cigar=True):
    """Batched exts2 (the signature of exts_pallas.exts2_batch).  qr: (N,
    QP) uint8 reversed queries; sf: (N, TP) uint8 targets; dn / ac: (N,
    TP) int8 donor / acceptor planes (splice_site_arrays); lens: (N, 2)
    int32 with 1 <= qlen <= QP, 1 <= tlen <= TP.  Returns (p (N, RC*RB, W)
    uint8, or None without with_cigar, ez (N, 16) int32).  G only fixes
    EZ_DEAD's group semantics.  approx_drop matters only with approx_max,
    as in the JAX kernel."""
    _check(W, QP)
    N = qr.shape[0]
    if qr.shape != (N, QP) or sf.shape != (N, TP) or dn.shape != (N, TP) \
            or ac.shape != (N, TP) or lens.shape != (N, 2):
        raise ValueError("exts2: qr (N, QP), sf / dn / ac (N, TP), lens "
                         "(N, 2)")
    RT = (R + RB - 1) // RB * RB
    approx_drop = bool(approx_drop and approx_max)
    kw = dict(W=W, RT=RT, QP=QP, q=q, e=e, q2=q2, sc_mch=sc_mch,
              sc_mis=sc_mis, sc_N=sc_N, with_cigar=with_cigar,
              approx_max=approx_max, approx_drop=approx_drop,
              right_mode=right_mode, zdrop=zdrop)
    order = job_order(lens)
    if qr.device.type == "cpu":
        # the kernel's block -> job mapping: run the jobs in that order,
        # put each result back in its job's row
        o = order.long()
        p_o, ez_o = exts2_batch_plain(qr[o], sf[o], dn[o], ac[o], lens[o],
                                      **kw)
        ez = torch.empty_like(ez_o)
        ez[o] = ez_o
        p = None
        if with_cigar:
            p = torch.empty_like(p_o)
            p[o] = p_o
        return p, _ez_dead(ez, lens, G, RB, RT)
    _build.require_cuda("exts2_batch", qr, sf, dn, ac, lens)
    if qr.dtype != torch.uint8 or sf.dtype != torch.uint8 \
            or dn.dtype != torch.int8 or ac.dtype != torch.int8 \
            or lens.dtype != torch.int32:
        raise ValueError("exts2: uint8 qr/sf, int8 dn/ac and int32 lens")
    mode = int(not approx_max) | int(right_mode) << 1 | int(approx_drop) << 2
    plan = _build.dp_plan("exts2", W, QP, TP, mode)
    slab = plan["route"] == "slab"
    # the kernel stores band rows only: every other byte of p is 0
    p = torch.zeros((N, RT, W) if with_cigar else (0,), dtype=torch.uint8,
                    device=qr.device)
    ez = torch.empty((N, EZ_N), dtype=torch.int32, device=qr.device)
    rows = torch.empty((N * plan["scratch"] // 4 if slab else 0,),
                       dtype=torch.int32, device=qr.device)
    err = _build.lib().mm2_exts2(
        qr.data_ptr(), sf.data_ptr(), dn.data_ptr(), ac.data_ptr(),
        lens.data_ptr(), order.data_ptr(), p.data_ptr(), ez.data_ptr(),
        rows.data_ptr() if slab else None, N, QP, TP, W, RT, q, e, q2,
        *long_thres_of(q, e, q2), sc_mch, sc_mis, sc_N, int(with_cigar),
        int(not approx_max), int(right_mode), int(approx_drop), zdrop,
        _build.stream_ptr(qr))
    _build.check(err, "mm2_exts2")
    _build.launches[launch_name(approx_max, right_mode, approx_drop,
                                with_cigar, plan["route"])] += 1
    return (p if with_cigar else None), _ez_dead(ez, lens, G, RB, RT)


def launch_name(approx_max, right_mode, approx_drop, with_cigar,
                route="reg"):
    """The launch counter of a mode's kernel instantiation on a route:
    ``exts2`` for the splice path's (approx-max, left-align, no
    approx-drop, with p, lanes in registers, planes in shared memory),
    else ``exts2_<exact|approx>[_right][_adrop][_nocigar]``; ``_gp`` or
    ``_slab`` after either for the planes-in-device-memory and the slab
    routes (``_build.dp_plan``)."""
    if approx_max and not right_mode and not approx_drop and with_cigar:
        name = "exts2"
    else:
        name = ("exts2_" + ("approx" if approx_max else "exact")
                + ("_right" if right_mode else "")
                + ("_adrop" if approx_drop else "")
                + ("" if with_cigar else "_nocigar"))
    return name + {"reg": "", "reg_gp": "_gp", "slab": "_slab"}[route]
