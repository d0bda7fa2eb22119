"""Banded dual-affine extension with direction bytes (ksw_extd2): CUDA
kernel and plain version, in every mode of the JAX kernel.

Counterpart of minimap2_tpu.ops.extend_pallas2.extd2_batch2
(extend_pallas2.py:605-667, kernel ``_extd2_kernel_v2`` :102-541): the
Suzuki-Kasahara difference recurrence of ksw_extd2_sse over
anti-diagonals r.  The score comes from the greedy H0 walk along the main
diagonal (approx-max, the mode of the ``-c``/``-a`` path, align_batch.py:
49-53), or from the H row (exact-max: each diagonal's H, its maximum and
first argmax, the mqe/mte lanes and ksw_apply_zdrop, :398-448).
approx_drop adds the z-drop test to the H0 walk (:476-489); right_mode
takes the ``>=`` forms of the direction-byte compares (:333-390).  A job
that z-drops stops after that diagonal.  Both versions keep the JAX
package's state layout, because the result depends on it:

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
kernel and the plain version alike; a z-dropped pair is always dead (its
last diagonal ran), which both versions report in lane ``EZ_ZFLAG`` for
``_ez_dead`` to read and clear.

Outputs: ``p`` (N, RC*RB, W) uint8 direction bytes (JAX's (NG, RC, RB, G,
W) block after a reshape), ``ez`` (N, 16) int32.  ``extd2_batch2``
launches the kernel (csrc/extd2.cu) for CUDA tensors, its blocks taking
the jobs in ``job_order`` (longest first), and runs ``extd2_batch2_plain``
for CPU tensors.  zdrop is read only in the exact-max mode and under
approx_drop, as in the JAX kernel.
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
EZ_ZFLAG = EZ_NR + 3      # z-dropped, between a version and _ez_dead
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


# the widest window the kernel takes: its lane offsets inside a job's rows
# are int (ROADMAP Queue 3); the JAX kernel asserts no ceiling
MAX_W = 1 << 24


def _check(W, RB, w):
    """The shapes the kernel takes: the JAX kernel's (W % 128, W >= w + 48
    + drift, RB <= 128), and W <= MAX_W."""
    drift = -(-(RB // 2) // 16) * 16
    if W % 128 or W < w + 48 + drift or RB > 128 or W > MAX_W:
        raise ValueError(f"extd2: need W % 128 == 0, W >= w + 48 + {drift}, "
                         f"W <= {MAX_W} and RB <= 128 (W={W}, w={w}, "
                         f"RB={RB})")


def job_order(lens: torch.Tensor) -> torch.Tensor:
    """The order in which a launch's blocks take its jobs: longest first
    (qlen + tlen), ties in job order.  (N,) int32 on lens's device."""
    tot = lens[:, 0].to(torch.int64) + lens[:, 1].to(torch.int64)
    return torch.sort(-tot, stable=True).indices.to(torch.int32)


def _ez_dead(ez, lens, G: int, RB: int, RT: int):
    """EZ_DEAD as the Pallas grid leaves it: set iff the pair's first dead
    diagonal nr < RT ran, i.e. it is not a chunk start at or past the
    longest pair of its G-group (pad rows of the last group count with
    lens (1, 1), as prep_planes pads them), or it z-dropped (EZ_ZFLAG,
    cleared here): its dead flag was set on the diagonal that ran."""
    N = lens.shape[0]
    rstar = lens[:, 0].to(torch.int64) + lens[:, 1] - 1
    pad = (-N) % G
    if pad:
        rstar = torch.cat([rstar, rstar.new_ones(pad)])
    gmax = rstar.view(-1, G).amax(1).repeat_interleave(G)[:N]
    nr = ez[:, EZ_NR].to(torch.int64)
    ran = (nr % RB != 0) | (nr == 0) | (nr < gmax)
    ez[:, EZ_DEAD] = ((nr < RT) & ran | (ez[:, EZ_ZFLAG] != 0)).to(
        torch.int32)
    ez[:, EZ_ZFLAG] = 0
    return ez


def _h_row(H, u, v, r, ws, st0, en0, qlen, tlen, live, fin, qe, lane, t_abs,
           ends):
    """The exact-max step of diagonal r in the plain versions (JAX
    extend_pallas2.py:398-435, exts_pallas.py:297-335): H updated on
    [st0, en0] from the diagonal's updated u and v rows, the row's maximum
    and first argmax, and ends = (mte, mteq, mqe, mqet, score) updated.
    A lane left of the window reads 0, as the Pallas one-hot sum does.
    Returns (H, max_H, max_t, ends)."""
    W = H.shape[1]

    def at(a, ln):
        ok = (ln >= 0) & (ln < W)
        return torch.where(ok, a.gather(
            1, ln.clamp(0, W - 1)[:, None])[:, 0].to(torch.int64), 0)
    mte, mteq, mqe, mqet, score = ends
    en0l, st0l = en0 - ws, st0 - ws
    if r == 0:
        h_en0 = v[:, 0].to(torch.int64) - qe
    else:
        h_en0 = torch.where(en0 > 0, at(H, en0l - 1) + _sext8(at(u, en0l)),
                            at(H, en0l) + _sext8(at(v, en0l)))
    body = (t_abs >= st0[:, None]) & (t_abs < en0[:, None]) & (r > 0)
    Hn = torch.where(body, H + v, H)
    Hn = torch.where((t_abs == en0[:, None]) & live[:, None],
                     h_en0[:, None].to(H.dtype), Hn)
    bv = torch.where(body, Hn, NEG_INF32)
    bmax = bv.amax(1).to(torch.int64)
    barg = torch.where(bv == bmax[:, None], lane, W).amin(1) + ws
    use_body = (bmax > h_en0) & (r > 0)
    h_at_en0, h_at_st0 = at(Hn, en0l), at(Hn, st0l)
    upd = live & (en0 == tlen - 1) & (h_at_en0 > mte)
    mte = torch.where(upd, h_at_en0, mte)
    mteq = torch.where(upd, r - en0, mteq)
    upd = live & (r - st0 == qlen - 1) & (h_at_st0 > mqe)
    mqe = torch.where(upd, h_at_st0, mqe)
    mqet = torch.where(upd, st0, mqet)
    score = torch.where(fin, at(Hn, tlen - 1 - ws), score)
    return (torch.where(live[:, None], Hn, H),
            torch.where(use_body, bmax, h_en0),
            torch.where(use_body, barg, en0), (mte, mteq, mqe, mqet, score))


def _zdrop_step(max_H, max_t, r, live, zdrop, slope, best):
    """ksw_apply_zdrop (ksw2.h:171-187) on diagonal r's maximum max_H at
    max_t, for each pair: the gap term is |diagonal drift| * slope (e2 in
    extd2, 0 in exts2, where introns are free).  best = (mx, mxt, mxq).
    Returns (zdropped, best); zdrop < 0 never drops."""
    mx, mxt, mxq = best
    better = max_H > mx
    zdropped = torch.zeros_like(live)
    if zdrop >= 0:
        ldiff = ((max_t - mxt) - (r - max_t - mxq)).abs()
        zdropped = live & ~better & (max_t >= mxt) & (r - max_t >= mxq) \
            & (mx - max_H > zdrop + ldiff * slope)
    upd = live & better
    return zdropped, (torch.where(upd, max_H, mx),
                      torch.where(upd, max_t, mxt),
                      torch.where(upd, r - max_t, mxq))


def _ez_out(best, ends, zdr, last_st, nr, H0, h0t, zflag):
    """The (N, 16) int32 ez lanes of a plain version."""
    (mx, mxt, mxq), (mte, mteq, mqe, mqet, score) = best, ends
    ez = torch.zeros((mx.shape[0], EZ_N), dtype=torch.int64,
                     device=mx.device)
    for lane_i, val in ((EZ_MAX, mx), (EZ_ZDROP, zdr), (EZ_MAXQ, mxq),
                        (EZ_MAXT, mxt), (EZ_MQE, mqe), (EZ_MQET, mqet),
                        (EZ_MTE, mte), (EZ_MTEQ, mteq), (EZ_SCORE, score),
                        (EZ_LASTST, last_st), (EZ_NR, nr), (EZ_H0, H0),
                        (EZ_H0T, h0t), (EZ_ZFLAG, zflag)):
        ez[:, lane_i] = val
    return ez.to(torch.int32)


def extd2_batch2_plain(qr, sf, lens, *, W, RB, RT, q, e, q2, e2, w, sc_mch,
                       sc_mis, sc_N, with_cigar=True, approx_max=True,
                       approx_drop=False, right_mode=False, zdrop=-1):
    """Plain version on (N, W) lanes with a loop over anti-diagonals.
    qr: (N, QP) uint8 REVERSED queries; sf: (N, TP) uint8 targets; lens
    (N, 2) int32.  Returns (p or None, ez) before the EZ_DEAD rule."""
    exact = not approx_max
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
                if exact:
                    H = torch.cat([H[:, dsh:], torch.full(
                        (N, dsh), NEG_INF32, dtype=i32, device=dev)], 1)
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
        if with_cigar and right_mode:
            d = (z <= a).to(torch.uint8)
            z = torch.maximum(z, a)
            d = torch.where(z > b, d, 2)
            z = torch.maximum(z, b)
            d = torch.where(z > a2, d, 3)
            z = torch.maximum(z, a2)
            d = torch.where(z > b2, d, 4)
            z = torch.maximum(z, b2)
        elif with_cigar:
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
            gt = torch.ge if right_mode else torch.gt
            d = d | (gt(a, 0).to(torch.uint8) << 3) \
                | (gt(b, 0).to(torch.uint8) << 4) \
                | (gt(a2, 0).to(torch.uint8) << 5) \
                | (gt(b2, 0).to(torch.uint8) << 6)
            p[:, r] = torch.where(m_upd, d, 0)
        fin = live & (r == rstar - 1) & (en0 == tlen - 1)
        if exact:
            H, max_H, max_t, ends = _h_row(
                H, u, v, r, ws, st0, en0, qlen, tlen, live, fin, qe, lane,
                t_abs, ends)
        if not exact:
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
        if exact or approx_drop:
            zdropped, best = _zdrop_step(max_H, max_t, r, live, zdrop, e2,
                                         best)
        zdr = torch.where((~dead & band_dead) | zdropped, 1, zdr)
        zflag = zflag | zdropped
        dead = dead | band_dead | zdropped
        last_st = torch.where(live, st, last_st)
        nr = torch.where(live, r + 1, nr)
    return p, _ez_out(best, ends, zdr, last_st, nr, H0, h0t, zflag)


def extd2_batch2(qr, sf, lens, *, G, W, RB, R, QP, TP, q, e, q2, e2, w,
                 zdrop, right_mode, approx_max, approx_drop, sc_mch, sc_mis,
                 sc_N, with_cigar=True):
    """Batched extd2 (the signature of extend_pallas2.extd2_batch2).
    qr: (N, QP) uint8 reversed queries; sf: (N, TP) uint8 targets; lens:
    (N, 2) int32 with 1 <= qlen <= QP, 1 <= tlen <= TP.  Returns (p, ez):
    p (N, RC*RB, W) uint8 (None without with_cigar), ez (N, 16) int32.
    G only fixes EZ_DEAD's group semantics.  approx_drop matters only with
    approx_max, as in the JAX kernel."""
    _check(W, RB, w)
    N = qr.shape[0]
    if qr.shape != (N, QP) or sf.shape != (N, TP) or lens.shape != (N, 2):
        raise ValueError("extd2: qr (N, QP), sf (N, TP), lens (N, 2)")
    RT = (R + RB - 1) // RB * RB
    approx_drop = bool(approx_drop and approx_max)
    kw = dict(W=W, RB=RB, RT=RT, q=q, e=e, q2=q2, e2=e2, w=w, sc_mch=sc_mch,
              sc_mis=sc_mis, sc_N=sc_N, with_cigar=with_cigar,
              approx_max=approx_max, approx_drop=approx_drop,
              right_mode=right_mode, zdrop=zdrop)
    if qr.device.type == "cpu":
        p, ez = extd2_batch2_plain(qr, sf, lens, **kw)
        return p, _ez_dead(ez, lens, G, RB, RT)
    _build.require_cuda("extd2_batch2", qr, sf, lens)
    if qr.dtype != torch.uint8 or sf.dtype != torch.uint8 \
            or lens.dtype != torch.int32:
        raise ValueError("extd2: uint8 qr/sf and int32 lens")
    mode = int(not approx_max) | int(right_mode) << 1 | int(approx_drop) << 2
    plan = _build.dp_plan("extd2", W, QP, TP, mode)
    slab = plan["route"] == "slab"
    # the register routes write every byte of p (0 off the band and past a
    # job); the slab route writes the band's bytes only
    p = (torch.zeros if slab else torch.empty)(
        (N, RT, W) if with_cigar else (0,), dtype=torch.uint8,
        device=qr.device)
    ez = torch.empty((N, EZ_N), dtype=torch.int32, device=qr.device)
    rows = torch.empty((N * plan["scratch"] // 4 if slab else 0,),
                       dtype=torch.int32, device=qr.device)
    order = job_order(lens)
    err = _build.lib().mm2_extd2(
        qr.data_ptr(), sf.data_ptr(), lens.data_ptr(), order.data_ptr(),
        p.data_ptr(), ez.data_ptr(), rows.data_ptr() if slab else None, N,
        QP, TP, W, RB, RT, w, q, e, q2, e2, *_long_gap(q, e, q2, e2), sc_mch,
        sc_mis, sc_N, int(with_cigar), int(not approx_max), int(right_mode),
        int(approx_drop), zdrop, _build.stream_ptr(qr))
    _build.check(err, "mm2_extd2")
    _build.launches[launch_name(approx_max, right_mode, approx_drop,
                                plan["route"])] += 1
    return (p if with_cigar else None), _ez_dead(ez, lens, G, RB, RT)


def launch_name(approx_max, right_mode, approx_drop, route="reg"):
    """The launch counter of a mode's kernel instantiation on a route:
    ``extd2`` for the -c/-a path's (approx-max, left-align, no
    approx-drop, lanes in registers, planes in shared memory), else
    ``extd2_<exact|approx>[_right][_adrop]``; ``_gp`` or ``_slab`` after
    either for the planes-in-device-memory and the slab routes
    (``_build.dp_plan``)."""
    if approx_max and not right_mode and not approx_drop:
        name = "extd2"
    else:
        name = ("extd2_" + ("approx" if approx_max else "exact")
                + ("_right" if right_mode else "")
                + ("_adrop" if approx_drop else ""))
    return name + {"reg": "", "reg_gp": "_gp", "slab": "_slab"}[route]
