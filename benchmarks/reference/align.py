"""Plain reference arithmetic of a base-level alignment.

Imports nothing of the program: the scoring is minimap2's (a match scores
a, a mismatch -b, an ambiguous base -sc_ambi; a gap of l bases costs
min(q + l e, q2 + l e2)), written out again in NumPy and plain torch.

``replay`` recomputes, from a record's CIGAR and the two sequences, what
minimap2 writes as NM:i and ms:i (mm_update_extra, align.c:254-303: the
running score clamped at 0, log-scaled gap costs outside sr, mg_log2's
float approximation).  ``path_score`` is the global score of the CIGAR's
path; ``best_global`` the best global score over the same two intervals
(a banded Gotoh DP, row by row, batched).  ``linear_path`` is the
control: the best path when gaps cost e2 a base and nothing to open.
"""
from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 28)
OPS = "MIDNSHP=X"
M_, I_, D_, N_ = 0, 1, 2, 3
_CODE = np.full(256, -1, np.int64)
for _k, _c in enumerate(OPS):
    _CODE[ord(_c)] = _k


def parse_cigar(s: str):
    """(lengths, op codes) of a CIGAR string, op codes indexing OPS."""
    a = np.frombuffer(s.encode(), np.uint8)
    at = np.flatnonzero(_CODE[a] >= 0)
    run = at - np.concatenate([[-1], at[:-1]]) - 1
    d = a.astype(np.int64) - 48
    n = np.zeros(len(at), np.int64)
    for k in range(int(run.max()) if len(run) else 0):
        ok = k < run
        n[ok] += d[at[ok] - 1 - k] * 10 ** k
    return n, _CODE[a[at]]


def cigar(pairs):
    """(lengths, op codes) of [(length, op letter)]."""
    return (np.array([k for k, _ in pairs], np.int64),
            np.array([OPS.index(o) for _, o in pairs], np.int64))


def _log2f(x: np.ndarray, fma: bool) -> np.ndarray:
    """minimap2's mg_log2 on float32 (mmpriv.h), its two products and sums
    rounded once (fma) or each (no fma)."""
    f32 = np.float32
    z = np.asarray(x, f32)
    zi = z.view(np.uint32)
    log2i = (((zi >> 23) & 255).astype(np.int32) - 128).astype(f32)
    zf = ((zi & np.uint32(0x007FFFFF)) | np.uint32(127 << 23)).view(f32)
    if fma:
        t = (np.float64(f32(-0.34484843)) * zf + f32(2.02466578)).astype(f32)
        t = (np.float64(t) * zf - np.float64(f32(0.67487759))).astype(f32)
    else:
        t = (f32(-0.34484843) * zf + f32(2.02466578)) * zf - f32(0.67487759)
    return (log2i + t).astype(f32)


# mg_log2 of 1 + l for every gap length l a read can have, rounded as a
# fused multiply-add (g++ -march=native fuses it on a CPU with FMA); the
# unfused rounding differs by one ulp at some lengths, which moves ms only
# when a score lies within ~1e-6 of a rounding boundary
LOG_GAP = _log2f(1.0 + np.arange(1 << 16, dtype=np.float64), True)


def mat(a: int, b: int, sc_ambi: int) -> np.ndarray:
    """5 x 5 scoring matrix, nt4 codes, 4 ambiguous (ksw_gen_simple_mat)."""
    m = np.full((5, 5), -sc_ambi, np.int64)
    m[:4, :4] = -b
    np.fill_diagonal(m[:4, :4], a)
    return m


def _ops(cig):
    """(op codes 0 M / 1 I / 2 D, lengths, query offsets, target offsets) of
    a CIGAR's M, I and D runs, clips dropped (N skips only move the
    target)."""
    n, op = cig
    op = np.where(op >= 7, M_, op)          # = and X are matches
    qa = np.where((op == M_) | (op == I_), n, 0)
    ta = np.where((op == M_) | (op == D_) | (op == N_), n, 0)
    qo, to = np.cumsum(qa) - qa, np.cumsum(ta) - ta
    keep = op <= D_
    return op[keep], n[keep], qo[keep], to[keep]


def _m_bases(op, n, qo, to):
    """Query and target offsets of every base of the M runs, in order."""
    mm = op == 0
    ln = n[mm]
    rel = np.arange(int(ln.sum())) - np.repeat(np.cumsum(ln) - ln, ln)
    return np.repeat(qo[mm], ln) + rel, np.repeat(to[mm], ln) + rel


def replay(cig, qseq, tseq, m, q, e, log_gap: bool):
    """(NM, ms) of an aligned CIGAR (clips removed) over the query and
    target bases it spans: the path's steps (a base of an M run, or a whole
    gap) in order, the running score clamped at 0 in closed form, s_t =
    P_t - min(0, min_k<=t P_k) over the prefix sums P."""
    op, n, qo, to = _ops(cig)
    qi, ti = _m_bases(op, n, qo, to)
    qa, ta = qseq[qi], tseq[ti]
    amb = (qa > 3) | (ta > 3)
    nm = int(((qa != ta) & ~amb).sum() + amb.sum() + n[op > 0].sum())
    steps = np.where(op == 0, n, 1)
    at = np.cumsum(steps) - steps
    vals = np.empty(int(steps.sum()), np.float64)
    mm = op == 0
    vals[np.repeat(at[mm], n[mm]) + np.arange(len(qi))
         - np.repeat(np.cumsum(n[mm]) - n[mm], n[mm])] = m[ta, qa]
    gl = n[~mm]
    if log_gap:
        lg = (LOG_GAP[gl] if not len(gl) or gl.max() < len(LOG_GAP)
              else _log2f(1.0 + gl, True)).astype(np.float64)
        vals[at[~mm]] = -(float(q) + float(e) * lg)
    else:
        vals[at[~mm]] = -float(q + e)
    if not len(vals):
        return nm, 0
    P = np.cumsum(vals)
    run = P - np.minimum(np.minimum.accumulate(P), 0.0)
    return nm, int(max(float(run.max()), 0.0) + 0.499)


def path_score(cig, qseq, tseq, m, q, e, q2, e2) -> int:
    """The global score of the CIGAR's path (no clamp, two-piece gaps)."""
    op, n, qo, to = _ops(cig)
    qi, ti = _m_bases(op, n, qo, to)
    g = n[op > 0]
    return int(m[tseq[ti], qseq[qi]].sum()
               - np.minimum(q + g * e, q2 + g * e2).sum())


def _pad(seqs, dev):
    n = max(1, max(len(s) for s in seqs))
    out = np.full((len(seqs), n), 4, np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return torch.from_numpy(out).to(dev).to(torch.int64)


def best_global(qs, ts, m, q, e, q2, e2, wb, device):
    """Best global score of each (query, target) pair over a band of wb
    cells either side of the corner-to-corner line (a banded Gotoh DP with
    two gap pieces, one query row at a time, all pairs at once)."""
    dev = torch.device(device)
    R = len(qs)
    ql = torch.tensor([len(x) for x in qs], device=dev)
    tl = torch.tensor([len(x) for x in ts], device=dev)
    Q, T = _pad(qs, dev), _pad(ts, dev)
    Tp = torch.cat([torch.full((R, 1), 4, device=dev, dtype=torch.int64), T],
                   1)               # Tp[:, j] is target base j - 1
    M = torch.from_numpy(np.asarray(m, np.int64)).to(dev)
    Wd = 2 * wb + 1
    off = torch.arange(Wd, device=dev)[None, :]
    ar = torch.arange(R, device=dev)

    def lo_of(i):
        return torch.div(i * tl, torch.clamp(ql, min=1),
                         rounding_mode="floor") - wb

    def gap(n):
        return -torch.minimum(q + n * e, q2 + n * e2)

    lo_p = lo_of(torch.zeros(R, dtype=torch.int64, device=dev))
    j = lo_p[:, None] + off
    H = torch.where(j == 0, 0, gap(j))
    H = torch.where((j < 0) | (j > tl[:, None]), NEG, H)
    F1 = torch.full_like(H, NEG)
    F2 = torch.full_like(H, NEG)
    best = torch.where(ql == 0, gap(tl), NEG)
    for i in range(1, int(ql.max()) + 1):
        lo = lo_of(torch.full((R,), i, device=dev))
        j = lo[:, None] + off
        d = (lo - lo_p)[:, None]
        outside = (j < 0) | (j > tl[:, None])

        def prev(x, shift):
            k = off + d + shift
            ok = (k >= 0) & (k < Wd)
            return torch.where(ok, torch.gather(x, 1, k.clamp(0, Wd - 1)),
                               NEG)
        Hup, Hdg = prev(H, 0), prev(H, -1)
        F1 = torch.maximum(Hup - (q + e), prev(F1, 0) - e)
        F2 = torch.maximum(Hup - (q2 + e2), prev(F2, 0) - e2)
        qb = Q[:, i - 1:i].expand(R, Wd) if i <= Q.shape[1] else \
            torch.full((R, Wd), 4, device=dev, dtype=torch.int64)
        tb = torch.gather(Tp, 1, j.clamp(0, Tp.shape[1] - 1))
        D = torch.where(j >= 1, Hdg + M[tb, qb], NEG)
        H0 = torch.maximum(D, torch.maximum(F1, F2))
        H0 = torch.where(j == 0, gap(torch.full_like(j, i)), H0)
        H0 = torch.where(outside, NEG, H0)
        E1 = torch.cummax(H0 + e * j, 1).values
        E2 = torch.cummax(H0 + e2 * j, 1).values
        E1 = torch.cat([torch.full((R, 1), NEG, device=dev), E1[:, :-1]], 1) \
            - q - e * j
        E2 = torch.cat([torch.full((R, 1), NEG, device=dev), E2[:, :-1]], 1) \
            - q2 - e2 * j
        H = torch.maximum(H0, torch.maximum(E1, E2))
        H = torch.where(outside, NEG, torch.clamp(H, min=NEG))
        F1 = torch.where(outside, NEG, torch.clamp(F1, min=NEG))
        F2 = torch.where(outside, NEG, torch.clamp(F2, min=NEG))
        fin = ql == i
        if bool(fin.any()):
            k = (tl - lo).clamp(0, Wd - 1)
            inb = (tl - lo >= 0) & (tl - lo < Wd)
            v = torch.where(inb, H[ar, k], NEG)
            best = torch.where(fin, v, best)
        lo_p = lo
    return best.cpu().numpy()


def linear_path(qseq, tseq, m, g, wb):
    """The control's CIGAR: the best global path when a gap costs g a base
    and nothing to open, in the same band, traced back."""
    ql, tl = len(qseq), len(tseq)
    Wd = 2 * wb + 1
    lo_all = np.array([i * tl // max(ql, 1) - wb for i in range(ql + 1)])
    H = np.full((ql + 1, Wd), NEG, np.int64)
    back = np.zeros((ql + 1, Wd), np.uint8)     # 0 diag, 1 up, 2 left
    j = lo_all[0] + np.arange(Wd)
    ok = (j >= 0) & (j <= tl)
    H[0, ok] = -g * j[ok]
    back[0, ok] = 2
    for i in range(1, ql + 1):
        lo, lp = lo_all[i], lo_all[i - 1]
        j = lo + np.arange(Wd)
        ok = (j >= 0) & (j <= tl)
        ku, kd = j - lp, j - 1 - lp
        up = np.where((ku >= 0) & (ku < Wd), H[i - 1, np.clip(ku, 0, Wd - 1)],
                      NEG) - g
        dg = np.where((kd >= 0) & (kd < Wd) & (j >= 1),
                      H[i - 1, np.clip(kd, 0, Wd - 1)]
                      + m[tseq[np.clip(j - 1, 0, max(tl - 1, 0))],
                          qseq[i - 1]], NEG)
        h0 = np.maximum(dg, up)
        h0 = np.where(ok, h0, NEG)
        left = np.maximum.accumulate(h0 + g * j) - g * j
        h = np.maximum(h0, left)
        H[i] = np.where(ok, h, NEG)
        back[i] = np.where(h == dg, 0, np.where(h == up, 1, 2))
    cig = []
    i, jj = ql, tl
    while i > 0 or jj > 0:
        k = jj - lo_all[i]
        b = back[i, k] if i > 0 else 2
        op = "MID"[b]
        if cig and cig[-1][1] == op:
            cig[-1][0] += 1
        else:
            cig.append([1, op])
        if b == 0:
            i, jj = i - 1, jj - 1
        elif b == 1:
            i -= 1
        else:
            jj -= 1
    return cigar(list(reversed(cig)))
