"""Banded dual-affine extension with direction bytes (ksw_extd2, approx-max
mode): CUDA kernel and plain version.

Counterpart of minimap2_tpu.ops.extend_pallas2.extd2_batch2
(extend_pallas2.py:605-667, kernel ``_extd2_kernel_v2`` :102-541): the
Suzuki-Kasahara difference recurrence of ksw_extd2_sse over
anti-diagonals r, with the greedy H0 walk along the main diagonal for the
score (approx-max, the mode of the ``-c``/``-a`` path, align_batch.py:
49-53).  Both versions keep the JAX package's state layout, because the
result depends on it:

* lane ``l`` of diagonal ``r`` is target position ``wstart_chunk(r, w,
  RB) + l``: all RB diagonals of a chunk share one window origin, and at
  each chunk boundary the carried rows shift left by ``dsh`` lanes with the
  fill values of ``chunk_shift`` (:186-200);
* the score row ``s`` is carried per lane; only ``[st0, s_hi]`` is
  rewritten (:311-320), so lanes in ``[st, st0)`` read stale scores, as the
  SSE reference does;
* a query or target code outside the sequence is 0, not 4
  (``prep_planes`` :570-572); ``sc_N`` applies only where a code is 4;
* the boundary values at ``st - 1`` (:272-287) and the H0 walk's ``v[t0]``,
  ``u[t0 + 1]`` (:455-477) go through ``_sext8``.

A pair is updated only while it is live; once dead (past its last
diagonal, or its band empty) every later row of ``p`` is 0 and its ``ez``
lanes are final, as in the Pallas kernel's chunk skip (:504-541).  The one
lane that depends on the Pallas grid is ``EZ_DEAD``: a chunk that starts at
or past the longest pair of its G-pair group is skipped, so a pair that ends
exactly on a chunk boundary of such a group never sees its dead diagonal.
``_ez_dead`` applies that rule from ``EZ_NR`` and the group lengths, for the
kernel and the plain version alike.

Outputs: ``p`` (N, RC*RB, W) uint8 direction bytes (JAX's (NG, RC, RB, G,
W) block after a reshape), ``ez`` (N, 16) int32.  ``extd2_batch2``
launches the kernel (csrc/extd2.cu) for CUDA tensors, its blocks taking
the jobs in ``job_order`` (longest first), and runs ``extd2_batch2_plain``
for CPU tensors.  Exact-max (H row), the approx-drop and right-align modes
raise NotImplementedError; zdrop is inert in the ported mode (``_check``).
"""
from __future__ import annotations


import torch

from . import _build

NEG_INF32 = -0x40000000
# ez output lanes (extend_pallas2.py:52-54); lanes 12/13 carry H0 and its
# target position, 14/15 are 0
EZ_MAX, EZ_ZDROP, EZ_MAXQ, EZ_MAXT, EZ_MQE, EZ_MQET, EZ_MTE, EZ_MTEQ, \
    EZ_SCORE, EZ_LASTST, EZ_DEAD, EZ_NR = range(12)
EZ_H0, EZ_H0T = EZ_NR + 1, EZ_NR + 2
EZ_N = 16


def wstart(r: int, w: int) -> int:
    """Uniform window start for diagonal r (16-aligned)."""
    return max(0, (r - w + 1) >> 1) // 16 * 16


def wstart_chunk(r: int, w: int, RB: int) -> int:
    """Chunk-uniform window start: every diagonal of an RB-chunk uses the
    window of the chunk's first diagonal."""
    return wstart((r // RB) * RB, w)


def _long_gap(q, e, q2, e2):
    """(long_thres, long_diff) of ksw_extd2 (extend_pallas2.py:110-116)."""
    long_thres = (q2 - q) // (e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    return long_thres, long_thres * (e - e2) - (q2 - q) - e2


def _sext8(x):
    """Sign-extend the low byte of an int tensor."""
    return (((x & 255) + 128) & 255) - 128


def _check(W, RB, w, right_mode, approx_max, approx_drop, zdrop):
    """Refuse what is not ported.  Any zdrop is taken: in the approx-max
    mode without approx-drop the reference kernel never reads it (its
    z-drop test runs in the exact-max branch and, in the approx-max
    branch, only under approx_drop; JAX extend_pallas2.py:436-443,
    476-489), so the -c/-a path's zdrop=-1 and map_batch's zdrop=400 give
    the same outputs and nothing of zdrop goes to the kernel."""
    if right_mode or not approx_max or approx_drop:
        raise NotImplementedError(
            "extd2: only the approx-max mode without approx-drop is ported "
            "(approx_max=True, approx_drop=False, right_mode=False); the "
            "exact-max, approx-drop and right-align modes are a later slice")
    drift = -(-(RB // 2) // 16) * 16
    if W % 128 or W < w + 48 + drift or RB > 128 or W > 1024:
        raise ValueError(f"extd2: need W % 128 == 0, W >= w + 48 + {drift}, "
                         f"W <= 1024 and RB <= 128 (W={W}, w={w}, RB={RB})")


def job_order(lens: torch.Tensor) -> torch.Tensor:
    """The order in which a launch's blocks take its jobs: longest first
    (qlen + tlen), ties in job order.  (N,) int32 on lens's device."""
    tot = lens[:, 0].to(torch.int64) + lens[:, 1].to(torch.int64)
    return torch.sort(-tot, stable=True).indices.to(torch.int32)


def _ez_dead(ez, lens, G: int, RB: int, RT: int):
    """EZ_DEAD as the Pallas grid leaves it: set iff the pair's first dead
    diagonal nr < RT ran, i.e. it is not a chunk start at or past the
    longest pair of its G-group (pad rows of the last group count with
    lens (1, 1), as prep_planes pads them)."""
    N = lens.shape[0]
    rstar = lens[:, 0].to(torch.int64) + lens[:, 1] - 1
    pad = (-N) % G
    if pad:
        rstar = torch.cat([rstar, rstar.new_ones(pad)])
    gmax = rstar.view(-1, G).amax(1).repeat_interleave(G)[:N]
    nr = ez[:, EZ_NR].to(torch.int64)
    ran = (nr % RB != 0) | (nr == 0) | (nr < gmax)
    ez[:, EZ_DEAD] = ((nr < RT) & ran).to(torch.int32)
    return ez


def extd2_batch2_plain(qr, sf, lens, *, W, RB, RT, q, e, q2, e2, w, sc_mch,
                       sc_mis, sc_N, with_cigar=True):
    """Plain version on (N, W) lanes with a loop over anti-diagonals.
    qr: (N, QP) uint8 REVERSED queries; sf: (N, TP) uint8 targets; lens
    (N, 2) int32.  Returns (p or None, ez) before the EZ_DEAD rule."""
    N, QP = qr.shape
    TP = sf.shape[1]
    dev = qr.device
    i32, i64 = torch.int32, torch.int64
    qe, qe2 = q + e, q2 + e2
    long_thres, long_diff = _long_gap(q, e, q2, e2)
    qlen = lens[:, 0].to(i64)
    tlen = lens[:, 1].to(i64)
    rstar = qlen + tlen - 1
    # qxa[n, c - qpos] = q[n, qpos] (0 outside the query): the query codes
    # of diagonal r are the contiguous window qxa[:, c - r + ws : + W]
    ws_last = wstart_chunk(RT - 1, w, RB)
    c = RT - 1 - ws_last + 8
    j = torch.arange(c + W, device=dev)[None, :]
    src = j - (c - qlen[:, None] + 1)
    qxa = torch.where((src >= 0) & (src < qlen[:, None]),
                      qr.gather(1, src.clamp(0, QP - 1)).to(i32), 0)
    sfz = torch.zeros((N, max(TP, ws_last + W)), dtype=i32, device=dev)
    sfz[:, :TP] = sf.to(i32)

    def full(v):
        return torch.full((N, W), v, dtype=i32, device=dev)
    u, v, x, y = full(-qe), full(-qe), full(-qe), full(-qe)
    x2, y2, s = full(-qe2), full(-qe2), full(0)
    zeros = torch.zeros(N, dtype=i64, device=dev)
    dead, zdr, last_st, nr = (zeros.bool(), zeros.clone(), zeros.clone(),
                              zeros.clone())
    H0, h0t = zeros.clone(), zeros.clone()
    score = torch.full((N,), NEG_INF32, dtype=i64, device=dev)
    p = torch.zeros((N, RT, W), dtype=torch.uint8, device=dev) \
        if with_cigar else None
    lane = torch.arange(W, device=dev)[None, :]
    rows = torch.arange(N, device=dev)
    ws = 0
    r_end = min(RT, int(rstar.max()) if N else 0)
    for r in range(r_end):
        if r % RB == 0:
            if r and not bool((~dead).any()):
                break
            ws_new = wstart(r, w)
            dsh = ws_new - ws
            if dsh:         # chunk_shift: out[l] = a[l + dsh], fill above
                u, v, x, y, x2, y2, s = (
                    torch.cat([a[:, dsh:], torch.full((N, dsh), f, dtype=i32,
                                                      device=dev)], 1)
                    for a, f in ((u, -qe), (v, -qe), (x, -qe), (y, -qe),
                                 (x2, -qe2), (y2, -qe2), (s, 0)))
            ws = ws_new
            tq = sfz[:, ws:ws + W]
            t_abs = lane + ws
        qq = qxa[:, c - r + ws:c - r + ws + W]
        dead = dead | (r >= rstar)
        st0 = torch.clamp(r - qlen + 1, min=max(0, (r - w + 1) >> 1))
        en0 = torch.clamp(tlen - 1, max=min(r, (r + w) >> 1))
        band_dead = st0 > en0
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        live = ~(dead | band_dead)
        use_prev = (st - last_st == 16) & live & (st > 0)
        # boundary scalars at lane st-1-ws (0 when outside the window)
        pre = st - 1 - ws
        okp = (pre >= 0) & (pre < W)
        prei = pre.clamp(0, W - 1)[:, None]

        def at_pre(a):
            return torch.where(okp, _sext8(a.gather(1, prei)[:, 0]), 0)
        x1 = torch.where(use_prev, at_pre(x), -qe)
        x21 = torch.where(use_prev, at_pre(x2), -qe2)
        v1_edge = (-qe if r == 0 else -e if r < long_thres
                   else long_diff if r == long_thres else -e2)
        v1 = torch.where(use_prev, at_pre(v),
                         torch.where(st > 0, -qe, v1_edge))
        at_r = (t_abs == r) & (en >= r)[:, None]
        y_p = torch.where(at_r, -qe, y)
        y2_p = torch.where(at_r, -qe2, y2)
        u_p = torch.where(at_r, v1_edge, u)
        s_hi = st0 + (en0 - st0) // 16 * 16 + 15
        scl = (t_abs >= st0[:, None]) & (t_abs <= s_hi[:, None]) \
            & live[:, None]
        sval = torch.where(tq == qq, sc_mch, sc_mis)
        sval = torch.where((tq == 4) | (qq == 4), sc_N, sval).to(i32)
        s = torch.where(scl, sval, s)
        at_stl = lane == (st - ws)[:, None]
        xt1 = torch.where(at_stl, x1[:, None].to(i32), x.roll(1, 1))
        vt1 = torch.where(at_stl, v1[:, None].to(i32), v.roll(1, 1))
        x2t1 = torch.where(at_stl, x21[:, None].to(i32), x2.roll(1, 1))
        a, b = xt1 + vt1, y_p + u_p
        a2, b2 = x2t1 + vt1, y2_p + u_p
        z = s
        if with_cigar:
            d = (a > z).to(torch.uint8)
            z = torch.maximum(z, a)
            d = torch.where(b > z, 2, d)
            z = torch.maximum(z, b)
            d = torch.where(a2 > z, 3, d)
            z = torch.maximum(z, a2)
            d = torch.where(b2 > z, 4, d)
            z = torch.maximum(z, b2)
        else:
            z = torch.maximum(torch.maximum(z, a),
                              torch.maximum(b, torch.maximum(a2, b2)))
        z = z.clamp(max=sc_mch)
        u_new, v_new = z - vt1, z - u_p
        a, b = a - (z - q), b - (z - q)
        a2, b2 = a2 - (z - q2), b2 - (z - q2)
        m_upd = live[:, None] & (t_abs >= st[:, None]) & (t_abs <= en[:, None])
        u = torch.where(m_upd, u_new, u_p)
        v = torch.where(m_upd, v_new, v)
        x = torch.where(m_upd, a.clamp(min=0) - qe, x)
        y = torch.where(m_upd, b.clamp(min=0) - qe, y_p)
        x2 = torch.where(m_upd, a2.clamp(min=0) - qe2, x2)
        y2 = torch.where(m_upd, b2.clamp(min=0) - qe2, y2_p)
        if with_cigar:
            d = d | ((a > 0).to(torch.uint8) << 3) \
                | ((b > 0).to(torch.uint8) << 4) \
                | ((a2 > 0).to(torch.uint8) << 5) \
                | ((b2 > 0).to(torch.uint8) << 6)
            p[:, r] = torch.where(m_upd, d, 0)
        fin = live & (r == rstar - 1) & (en0 == tlen - 1)
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
        score = torch.where(fin, H0, score)
        zdr = torch.where(~dead & band_dead, 1, zdr)
        dead = dead | band_dead
        last_st = torch.where(live, st, last_st)
        nr = torch.where(live, r + 1, nr)
    ez = torch.zeros((N, EZ_N), dtype=i64, device=dev)
    for lane_i, val in ((EZ_MAXQ, -1), (EZ_MAXT, -1), (EZ_MQE, NEG_INF32),
                        (EZ_MQET, -1), (EZ_MTE, NEG_INF32), (EZ_MTEQ, -1)):
        ez[:, lane_i] = val
    for lane_i, val in ((EZ_ZDROP, zdr), (EZ_SCORE, score),
                        (EZ_LASTST, last_st), (EZ_NR, nr), (EZ_H0, H0),
                        (EZ_H0T, h0t)):
        ez[:, lane_i] = val
    return p, ez.to(i32)


def extd2_batch2(qr, sf, lens, *, G, W, RB, R, QP, TP, q, e, q2, e2, w,
                 zdrop, right_mode, approx_max, approx_drop, sc_mch, sc_mis,
                 sc_N, with_cigar=True):
    """Batched extd2 (the signature of extend_pallas2.extd2_batch2).
    qr: (N, QP) uint8 reversed queries; sf: (N, TP) uint8 targets; lens:
    (N, 2) int32 with 1 <= qlen <= QP, 1 <= tlen <= TP.  Returns (p, ez):
    p (N, RC*RB, W) uint8 (None without with_cigar), ez (N, 16) int32.
    G only fixes EZ_DEAD's group semantics."""
    _check(W, RB, w, right_mode, approx_max, approx_drop, zdrop)
    N = qr.shape[0]
    if qr.shape != (N, QP) or sf.shape != (N, TP) or lens.shape != (N, 2):
        raise ValueError("extd2: qr (N, QP), sf (N, TP), lens (N, 2)")
    RT = (R + RB - 1) // RB * RB
    kw = dict(W=W, RB=RB, RT=RT, q=q, e=e, q2=q2, e2=e2, w=w, sc_mch=sc_mch,
              sc_mis=sc_mis, sc_N=sc_N, with_cigar=with_cigar)
    if qr.device.type == "cpu":
        p, ez = extd2_batch2_plain(qr, sf, lens, **kw)
        return p, _ez_dead(ez, lens, G, RB, RT)
    _build.require_cuda("extd2_batch2", qr, sf, lens)
    if qr.dtype != torch.uint8 or sf.dtype != torch.uint8 \
            or lens.dtype != torch.int32:
        raise ValueError("extd2: uint8 qr/sf and int32 lens")
    # the kernel writes every byte of p (0 off the band and past a job)
    p = torch.empty((N, RT, W) if with_cigar else (0,), dtype=torch.uint8,
                    device=qr.device)
    ez = torch.empty((N, EZ_N), dtype=torch.int32, device=qr.device)
    order = job_order(lens)
    err = _build.lib().mm2_extd2(
        qr.data_ptr(), sf.data_ptr(), lens.data_ptr(), order.data_ptr(),
        p.data_ptr(), ez.data_ptr(), N, QP, TP, W, RB, RT, w, q, e, q2, e2,
        *_long_gap(q, e, q2, e2), sc_mch, sc_mis, sc_N, int(with_cigar),
        _build.stream_ptr(qr))
    _build.check(err, "mm2_extd2")
    _build.launches["extd2"] += 1
    return (p if with_cigar else None), _ez_dead(ez, lens, G, RB, RT)
