"""Minimizer index built on the device (the counterpart of
minimap2_tpu.parallel.devbuild).

The host build (index/index.py) sketches with NumPy in a process pool:
~0.3 s a megabase, so a 3.1 Gb genome does not fit a run.  Here the whole
build -- sketch, genome-scale (key, pos) sort, distinct-key compaction and
the probe table -- runs on the device, and the finished DeviceIndex never
leaves it; only scalars (counts, mid_occ) come back to the host.

Layouts produced (the DeviceIndex of parallel/batch.py), as the JAX
package chooses them:
  h2r  (NB, 64 * stride) u32  the payload-fused 2-choice bucket table,
       when the memory plan admits it (in one piece, or chunked) and it
       builds; otherwise (MM2TPU_DEVBUILD_H2R=0, both plans over their
       bounds, five overflowing tries or a chunked build that fails)
  krows (K/64, 128) u32 + sc2 (K, 2) i32 + bucket_start (2^bb + 1,) i32
       the windowed probe over the sorted keys, bb grown until no bucket
       holds more than 25 keys (keys2 (K, 2) u32 in place of krows if one
       still does)
  pos2 (NPAD,) u32  sorted by (key, pos): pos_fmt 1 = global_pos << 1 |
                    strand, pos_fmt 2 = global_pos (strand in pstrand)
  S    nt4 codes with OV-wide separators between sequences (s_fmt 0: a
       code a byte; s_fmt 1 for pos_fmt 2: two codes a byte)

Chunking: a position's minimizer flag depends only on codes [p - k - w +
2, p + w - 1].  Sequences are laid end to end with OV = k + 2w - 3
(rounded up to 32) separator bytes of code 5 before, between and after
them; rows of LC = 8192 codes tile the flat array at stride STEP = LC -
OV, and each row owns positions [LCTX, LCTX + STEP) with LCTX = k + w -
2.  Code 5 is ambiguous to the sketch, as an N (4) is, so no k-mer or
window crosses a sequence boundary; _edge_fix tells the two apart to
reproduce mm_sketch's behaviour at sequence ends and at N runs.

Positions are global offsets in that separated space, and seq_off holds
each sequence's separated offset, so rid recovery works unchanged.
Genomes below 2^31 separated bp use pos_fmt 1, those of 2^31 up to 2^32
pos_fmt 2.

u32 planes are int32 bit patterns, with arithmetic on int64 copies
(utils/u32.py).
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..ops.sketch import sketch_batch
from ..utils.u32 import INT32_MIN, M32, i32, u32
from .batch import (H2R_LOAD, H2R_SLOTS, DeviceIndex, _mulhi_u32,
                    build_rtab_np)

UMAX = -1                   # 0xFFFFFFFF as an int32 bit pattern
I64_MAX = (1 << 63) - 1     # above every (hi << 32 | lo) hash of 2k <= 56


@dataclass
class DevBuildMeta:
    """Host-side metadata of a device-built index; ``stage_s`` holds the
    seconds of each build stage."""
    names: list
    seq_off: np.ndarray        # separated-space offsets (i64)
    seq_len: np.ndarray        # true lengths (i64)
    w: int
    k: int
    n_mini: int                # total minimizer occurrences
    n_distinct: int            # distinct minimizer hashes
    mid_occ: int               # cal_max_occ(occ_frac) analogue
    stage_s: dict = field(default_factory=dict)

    def seq_table(self):
        """A MiniIndex carrying only the per-sequence metadata (what the
        PAF and SAM writers read)."""
        from ..index.index import MiniIndex, SeqMeta
        mi = MiniIndex(self.w, self.k, 14, 0)
        for nm, off, ln in zip(self.names, self.seq_off, self.seq_len):
            mi.seq.append(SeqMeta(str(nm), int(off), int(ln)))
        return mi


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _edge_fix(hhi, hlo, valid, is_mini, rows, w: int):
    """mm_sketch's emission at sequence ends and N runs (sketch.c:89-143):
    at the first base of an N run (code 4) the scan drops its current
    window minimum; at the first separator byte (code 5) it emits it even
    without a complete window.  The current minimum is the latest argmin
    of the w slots before the event, so both are a windowed latest-argmin.
    Hashes compare as one int64 (hi << 32 | lo); an invalid slot is
    I64_MAX, above every hash.  Same residual divergences as the JAX
    package's rule (symmetric k-mers count as slots; two resets within w
    positions)."""
    x = torch.where(valid, (u32(hhi) << 32) | u32(hlo), I64_MAX)
    c = rows
    prev = torch.cat([c.new_full((c.shape[0], 1), 5), c[:, :-1]], dim=1)
    reset = (c == 4) & (prev != 4)
    flush = (c == 5) & (prev != 5)
    wm = torch.full_like(x, I64_MAX)
    for d in range(1, w + 1):           # min over slots [p - w, p)
        torch.minimum(wm[:, d:], x[:, :-d], out=wm[:, d:])
    have = (reset | flush) & (wm != I64_MAX)
    seen = torch.zeros_like(have)
    dropm = torch.zeros_like(have)
    addm = torch.zeros_like(have)
    eq = torch.zeros_like(have)
    for d in range(1, w + 1):           # smallest d = latest position
        eq[:, :d] = False
        torch.eq(x[:, :-d], wm[:, d:], out=eq[:, d:])
        eq &= have
        hit = eq & ~seen
        seen |= eq
        dropm[:, :-d] |= (hit & reset)[:, d:]
        addm[:, :-d] |= (hit & flush)[:, d:]
    return (is_mini & ~dropm) | (addm & valid)


def _sketch_chunk(S, bufs, n_off: int, base_row: int, *, NR, LC, STEP,
                  LCTX, k, w, CAPC, wide, fmt2):
    """Sketch NR rows from flat row base_row, and append the minimizers
    the rows own to the (key, pos) buffers at n_off; returns their count.
    fmt2: positions are the full u32 offset, the strand goes to its own
    plane."""
    keys_buf, khi_buf, pos_buf, str_buf = bufs
    rows = S.as_strided((NR, LC), (STEP, 1), base_row * STEP).contiguous()
    lens = torch.full((NR,), LC, dtype=torch.int32, device=S.device)
    hhi, hlo, z, is_mini, valid = sketch_batch(rows, lens, k, w,
                                               with_valid=True)
    sel = _edge_fix(hhi, hlo, valid, is_mini, rows, w)
    del valid, is_mini, rows
    sel[:, :LCTX] = False                       # owned: [LCTX, LCTX+STEP)
    sel[:, LCTX + STEP:] = False
    # compaction by nonzero + gather (the JAX package's fixed-size
    # nonzero pads with a fill index and masks; here the count is exact)
    idx = torch.nonzero(sel.reshape(-1)).squeeze(1)
    cnt = int(idx.numel())
    if cnt > CAPC or n_off + cnt > keys_buf.shape[0]:
        raise OverflowError(
            f"minimizer density exceeded the capture buffer: chunk count "
            f"{cnt} > {CAPC} (or {n_off + cnt} > {keys_buf.shape[0]} in "
            "all); rebuild with a larger cap_frac")
    # global separated position of the k-mer end
    gpos = (base_row * STEP + (idx // LC) * STEP) + idx % LC
    zs = z.reshape(-1)[idx]
    dst = slice(n_off, n_off + cnt)
    keys_buf[dst] = hlo.reshape(-1)[idx]
    if wide:
        khi_buf[dst] = hhi.reshape(-1)[idx]
    if fmt2:
        pos_buf[dst] = i32(gpos & M32)
        str_buf[dst] = zs.to(torch.uint8)
    else:
        pos_buf[dst] = i32(((gpos << 1) | zs.to(torch.int64)) & M32)
    return cnt


def _pack_s4(S, CH: int = 1 << 28):
    """nt4 u8 -> two 4-bit codes a byte (s_fmt 1), in pieces of CH bytes
    so the temporaries stay small; separators (5) become 4."""
    T = S.shape[0]
    out = torch.empty(T // 2, dtype=torch.uint8, device=S.device)
    for off in range(0, T, CH):
        x = torch.clamp(S[off:off + CH], max=4)
        out[off // 2:(off + x.shape[0]) // 2] = x[0::2] | (x[1::2] << 4)
    return out


def _signed_key(hi):
    """int32 bit patterns -> int64 whose signed order is the u32 order."""
    return (hi ^ INT32_MIN).to(torch.int64)


def _global_sort(keys, khi, pos, strand, n: int, *, wide, fmt2):
    """Sort the (key, pos) pairs in unsigned order and mark the first
    entry of each distinct key among the first n.  Narrow keys (k <= 15)
    and pos make one int64; wide keys take two stable passes (pos, then
    the (hi, lo) key as one int64).  fmt2 carries the strand plane
    through the same permutation.  Returns the sorted planes, neq and K."""
    if wide:
        order = torch.sort(u32(pos), stable=True).indices
        key64 = _signed_key(khi)[order] * (1 << 32) + u32(keys)[order]
        order = order[torch.sort(key64, stable=True).indices]
        del key64
        keys, khi, pos = keys[order], khi[order], pos[order]
    else:
        comb = _signed_key(keys) * (1 << 32) + u32(pos)
        comb, order = torch.sort(comb)
        keys = (comb >> 32).to(torch.int32) ^ INT32_MIN
        pos = i32(comb & M32)
        del comb
    if fmt2:
        strand = strand[order]
    del order
    neq = torch.ones_like(keys, dtype=torch.bool)
    neq[1:] = keys[1:] != keys[:-1]
    if wide:
        neq[1:] |= khi[1:] != khi[:-1]
    neq[n:] = False
    return keys, khi, pos, strand, neq, int(neq.sum())


def _compact(keys_s, khi_s, neq, n: int, *, KPAD, NPAD, wide):
    """Distinct-key compaction (worker_post, index.c:226-278): each run
    start goes to its rank (the JAX package's rank scatter with mode
    'drop'; the ranks of the run starts are 0..K-1 in order, so their
    nonzero list is the scatter's result).  Returns keys2 (KPAD, 2) [hi,
    lo], sc2 (KPAD, 2) [start, count] and the cumulative histogram of the
    occurrence counts (clipped at 2^16) that mid_occ reads."""
    dev = keys_s.device
    runs = torch.nonzero(neq).squeeze(1)
    starts = torch.full((KPAD,), n, dtype=torch.int32, device=dev)
    starts[:runs.numel()] = runs.to(torch.int32)
    del runs
    counts = torch.diff(starts, append=starts.new_full((1,), n))
    gi = torch.clamp(starts, max=NPAD - 1).to(torch.int64)
    pad = starts >= n
    klo = torch.where(pad, UMAX, keys_s[gi])
    khi = torch.where(pad, UMAX, khi_s[gi] if wide
                      else torch.zeros_like(starts))
    keys2 = torch.stack([khi, klo], dim=1)
    sc2 = torch.stack([starts, counts], dim=1)
    CLIP = 1 << 16
    hist = torch.bincount(torch.where(pad, 0, torch.clamp(counts, max=CLIP - 1)),
                          minlength=CLIP)
    return keys2, sc2, torch.cumsum(hist, 0)


def _h2r_words(keys2, sc2, key_bits: int, stride2: bool):
    """The words of each key's h2r slot (int64 u32 values): stride 2
    [key | cnt_hi2 << 30, start | cnt_lo4 << 28], stride 4 [key_sel, aux,
    start, cnt] (batch.build_h2rows_np)."""
    khi, klo = u32(keys2[:, 0]), u32(keys2[:, 1])
    starts, cnts = u32(sc2[:, 0]), u32(sc2[:, 1])
    if stride2:
        cnt6 = torch.clamp(cnts, max=63)
        return ((klo | ((cnt6 >> 4) << 30)) & M32,
                (starts | ((cnt6 & 15) << 28)) & M32)
    wide = key_bits > 31
    return (khi if wide else klo, klo if wide else torch.zeros_like(klo),
            starts, cnts)


def _b1(klo, NB: int):
    """Choice 1: the Fibonacci hash of the low key word."""
    return _mulhi_u32((klo * 2654435769) & M32, NB)


def _b2(khi, klo, NB: int):
    """Choice 2: the rehash of key bits 11..42."""
    return _mulhi_u32(((((klo >> 11) | (khi << 21)) & M32) * 2654435761)
                      & M32, NB)


def _run_ranks(bs):
    """Rank of each entry within its run of equal values of sorted bs."""
    i = torch.arange(bs.shape[0], device=bs.device)
    runstart = torch.ones_like(bs, dtype=torch.bool)
    runstart[1:] = bs[1:] != bs[:-1]
    return i - torch.cummax(torch.where(runstart, i, 0), 0).values


def _scatter_rows(flat, tgt, words, sel):
    """flat[tgt + d] = words[d] where sel (the JAX scatters' mode='drop'
    targets masked out first)."""
    t = tgt[sel]
    for d, v in enumerate(words):
        flat[t + d] = i32(v[sel])


def _h2rows_try(keys2, sc2, K: int, *, NB, CAPM, key_bits, stride2):
    """One monolithic build of the h2r table with NB buckets: choice-1
    ranks from one stable (b1, idx) sort; keys past 64 in their bucket
    (<= CAPM of them) fall to choice 2.  Returns (rows (NB, ROWW) int32,
    n_ov, n_movers); n_ov keys fit neither bucket."""
    dev = keys2.device
    KPAD = keys2.shape[0]
    khi, klo = u32(keys2[:, 0]), u32(keys2[:, 1])
    pad = torch.arange(KPAD, device=dev) >= K
    b1 = torch.where(pad, NB, _b1(klo, NB))
    b1s, ord1 = torch.sort(b1, stable=True)
    rank1s = _run_ranks(b1s)
    rank1 = torch.empty_like(rank1s)
    rank1[ord1] = rank1s
    placed1 = torch.empty_like(pad)
    placed1[ord1] = (rank1s < H2R_SLOTS) & (b1s < NB)
    del b1s, rank1s, ord1
    occ1 = torch.bincount(b1[placed1], minlength=NB + 1)
    b2 = _b2(khi, klo, NB)
    mover = ~placed1 & ~pad
    n_mv = int(mover.sum())
    mv = torch.nonzero(mover).squeeze(1)[:CAPM]
    midx = torch.full((CAPM,), KPAD - 1, dtype=torch.int64, device=dev)
    midx[:mv.numel()] = mv
    msel = torch.arange(CAPM, device=dev) < n_mv
    mb2s, mord = torch.sort(torch.where(msel, b2[midx], NB), stable=True)
    rank2 = _run_ranks(mb2s)
    occ_at = occ1[torch.clamp(mb2s, max=NB)]
    placed2 = (rank2 < H2R_SLOTS - occ_at) & (mb2s < NB)
    n_ov = n_mv - int(placed2.sum())
    words = _h2r_words(keys2, sc2, key_bits, stride2)
    stw = len(words)
    ROWW = stw * H2R_SLOTS
    flat = torch.full((NB * ROWW,), UMAX, dtype=torch.int32, device=dev)
    _scatter_rows(flat, b1 * ROWW + rank1 * stw, words, placed1)
    orig = midx[mord]
    _scatter_rows(flat, mb2s * ROWW + (occ_at + rank2) * stw,
                  [v[orig] for v in words], placed2)
    return flat.view(NB, ROWW), n_ov, n_mv


def _h2r_chunk(keys2, sc2, flat, occ, mvbuf, mv_n: int, off: int, K: int, *,
               NB, CK, CKM, key_bits, stride2):
    """One CK-key slice of the chunked build's pass 1: rank the slice's
    keys in their choice-1 buckets after the running occupancy ``occ``
    (updated in place), write the placed ones into ``flat`` and append the
    others' indices to ``mvbuf`` (at most CKM).  Returns the slice's
    overflow count."""
    dev = keys2.device
    kh, sc = keys2[off:off + CK], sc2[off:off + CK]
    klo = u32(kh[:, 1])
    pad = (off + torch.arange(CK, device=dev)) >= K
    b1 = torch.where(pad, NB, _b1(klo, NB))
    b1s, ord1 = torch.sort(b1, stable=True)
    rank = torch.empty_like(b1)
    rank[ord1] = _run_ranks(b1s)
    del b1s, ord1
    rank += occ[torch.clamp(b1, max=NB)]
    placed = (rank < H2R_SLOTS) & ~pad
    occ += torch.bincount(b1[~pad], minlength=NB + 1)
    words = _h2r_words(kh, sc, key_bits, stride2)
    stw = len(words)
    _scatter_rows(flat, b1 * stw * H2R_SLOTS + rank * stw, words, placed)
    mover = ~placed & ~pad
    n_mv = int(mover.sum())
    mv = torch.nonzero(mover).squeeze(1)[:CKM]
    mvbuf[mv_n:mv_n + mv.numel()] = off + mv
    return n_mv


def _h2r_pass2(keys2, sc2, flat, occ, mvbuf, mv_n: int, *, NB, key_bits,
               stride2):
    """The chunked build's pass 2: place the collected keys through
    choice 2 into the slots their buckets have left.  Returns n_ov."""
    dev = keys2.device
    CAPM = mvbuf.shape[0]
    j = torch.arange(CAPM, device=dev)
    ok = (j < mv_n) & (mvbuf >= 0)
    gi = torch.clamp(mvbuf, 0, keys2.shape[0] - 1)
    b2 = torch.where(ok, _b2(u32(keys2[gi, 0]), u32(keys2[gi, 1]), NB), NB)
    b2s, mord = torch.sort(b2, stable=True)
    rank2 = _run_ranks(b2s)
    occ_slots = torch.clamp(occ[torch.clamp(b2s, max=NB)], max=H2R_SLOTS)
    placed2 = (rank2 < H2R_SLOTS - occ_slots) & (b2s < NB)
    n_ov = int(ok.sum()) - int(placed2.sum())
    orig = gi[mord]
    words = _h2r_words(keys2[orig], sc2[orig], key_bits, stride2)
    stw = len(words)
    _scatter_rows(flat, b2s * stw * H2R_SLOTS + (occ_slots + rank2) * stw,
                  words, placed2)
    return n_ov


def _build_h2r_chunked(keys2, sc2, K: int, KPAD: int, key_bits: int,
                       stride2: bool, NB0: int):
    """GRCh38-scale h2r build, O(CK) temporaries instead of the monolithic
    KPAD-scale rank sort.  Returns (rows, NB), or (None, 0) after three
    table sizes or when the device runs out of memory."""
    dev = keys2.device
    stw = 2 if stride2 else 4
    ROWW = stw * H2R_SLOTS
    CK = 16 << 20
    while KPAD % CK:
        CK >>= 1
    CKM = max(CK // 4, 1 << 18)
    CAPM = _round_up(max(KPAD // 16, 1 << 20), 1 << 20)
    NB = NB0
    for _ in range(3):
        try:
            flat = torch.full((NB * ROWW,), UMAX, dtype=torch.int32,
                              device=dev)
            occ = torch.zeros(NB + 1, dtype=torch.int64, device=dev)
            mvbuf = torch.full((CAPM,), -1, dtype=torch.int64, device=dev)
            mv_n = 0
            for off in range(0, KPAD, CK):
                mv_n += _h2r_chunk(keys2, sc2, flat, occ, mvbuf, mv_n, off,
                                   K, NB=NB, CK=CK, CKM=CKM,
                                   key_bits=key_bits, stride2=stride2)
                if mv_n > CAPM - CKM:
                    break
            else:
                n_ov = _h2r_pass2(keys2, sc2, flat, occ, mvbuf, mv_n, NB=NB,
                                  key_bits=key_bits, stride2=stride2)
                if n_ov <= max(0, K // 1_000_000):
                    return flat.view(NB, ROWW), NB
        except torch.OutOfMemoryError:
            return None, 0      # the krows probe instead
        del flat, occ, mvbuf
        NB = int(NB * 1.12) + 1
    return None, 0


def _bucket_table(keys2, K: int, *, bb: int, shift: int):
    """bucket_start[b] = the first distinct-key row whose key >> shift is
    >= b, over 2^bb buckets (the JAX package's scatter-min and reverse
    cummin); returns it (int32) and the largest bucket's key count."""
    dev = keys2.device
    KPAD = keys2.shape[0]
    NBK = 1 << bb
    pad = torch.arange(KPAD, device=dev) >= K
    key = (torch.where(pad, 0, u32(keys2[:, 0])) << 32) | u32(keys2[:, 1])
    b_of = torch.where(pad, NBK, torch.clamp(key >> shift, max=NBK))
    bs = torch.full((NBK + 1,), K, dtype=torch.int64, device=dev)
    bs.scatter_reduce_(0, b_of, torch.arange(KPAD, device=dev), "amin")
    bs = torch.flip(torch.cummin(torch.flip(bs, [0]), 0).values, [0])
    return bs.to(torch.int32), int(torch.diff(bs).max())


def build_device_index(names, codes_list, w: int, k: int,
                       cap_frac: float = 0.26, chunk_pos: int = 64 << 20,
                       occ_frac: float = 2e-4, device=None,
                       force_pos_fmt: int | None = None,
                       consume: bool = False):
    """Build the DeviceIndex on ``device`` (CUDA unless named) from nt4
    code arrays (NumPy, or uint8 tensors on any device): the h2r layout,
    or the krows layout where the JAX package takes it (module
    docstring).  Returns (DeviceIndex, DevBuildMeta).  On CUDA the sketch
    runs the kernel; on the CPU its plain version.  consume=True drops each
    of the caller's contigs (the list entry) once it is copied, so a
    genome-sized list and the flat genome are not both held."""
    dev = resolve_device(device)
    if 2 * k > 56:
        raise ValueError("device build supports k <= 28")
    wide = 2 * k >= 32          # keys need the hi u32 plane
    LC = 8192
    OV = _round_up(k + 2 * w - 3, 32)
    if OV > LC // 2:
        raise ValueError(f"k + 2w - 3 = {k + 2 * w - 3} is too wide")
    STEP = LC - OV
    LCTX = k + w - 2
    stage, t0 = {}, time.time()
    t_last = [t0]

    def mark(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.time()
        stage[name] = t - t_last[0]
        t_last[0] = t

    # --- separated flat genome, assembled on the device ---
    lens = np.array([int(c.shape[0]) for c in codes_list], np.int64)
    total_sep = OV + int(np.sum(lens + OV))
    NR = max(1, math.ceil((total_sep - OV) / STEP))
    NRC = max(8, min(_round_up(NR, 8), _round_up(chunk_pos // LC, 8)))
    n_calls = math.ceil(NR / NRC)
    # whole chunks of rows (surplus rows see only separators: no
    # minimizer), plus one STEP of slack past the last row
    NR = n_calls * NRC
    pad_to = NR * STEP + OV + STEP
    seq_off = OV + np.concatenate([[0], np.cumsum(lens + OV)[:-1]])
    if pad_to >= (1 << 32) - 1:
        raise ValueError("genome too large for the device build (> 4 Gb)")
    fmt2 = total_sep >= (1 << 31) - 1
    if force_pos_fmt is not None:       # exercise pos_fmt 2 on small genomes
        fmt2 = force_pos_fmt == 2
    S = torch.full((pad_to,), 5, dtype=torch.uint8, device=dev)
    for j in range(len(codes_list)):
        c = codes_list[j]
        if consume:
            codes_list[j] = None        # drop the caller's reference
        if not torch.is_tensor(c):
            c = torch.from_numpy(np.ascontiguousarray(c, np.uint8))
        off = int(seq_off[j])
        S[off:off + c.shape[0]].copy_(c)
        del c
    mark("assemble")

    # --- chunked sketch + compaction ---
    CAPC = _round_up(int(NRC * STEP * cap_frac), 1 << 20)
    CAP_TOT = _round_up(int(NR * STEP * cap_frac), 1 << 20) + CAPC
    keys_buf = torch.full((CAP_TOT,), UMAX, dtype=torch.int32, device=dev)
    khi_buf = torch.full((CAP_TOT if wide else 1,), UMAX, dtype=torch.int32,
                         device=dev)
    pos_buf = torch.zeros(CAP_TOT, dtype=torch.int32, device=dev)
    str_buf = torch.zeros(CAP_TOT if fmt2 else 1, dtype=torch.uint8,
                          device=dev)
    bufs = (keys_buf, khi_buf, pos_buf, str_buf)
    N = 0
    for ci in range(n_calls):
        N += _sketch_chunk(S, bufs, N, ci * NRC, NR=NRC, LC=LC, STEP=STEP,
                           LCTX=LCTX, k=k, w=w, CAPC=CAPC, wide=wide,
                           fmt2=fmt2)
    del bufs
    mark("sketch")
    NPAD = min(_round_up(max(N, 1), 8 << 20), CAP_TOT)
    if NPAD < CAP_TOT:          # one buffer at a time: a bounded peak
        keys_buf = keys_buf[:NPAD].clone()
        khi_buf = khi_buf[:NPAD].clone() if wide else khi_buf
        pos_buf = pos_buf[:NPAD].clone()
        str_buf = str_buf[:NPAD].clone() if fmt2 else str_buf
    if fmt2:
        # pack the reference plane before the sort, which is the peak
        S = _pack_s4(S)
    mark("trim")
    keys_s, khi_s, pos_s, str_s, neq, K = _global_sort(
        keys_buf, khi_buf, pos_buf, str_buf, N, wide=wide, fmt2=fmt2)
    del keys_buf, khi_buf, pos_buf, str_buf
    mark("sort")

    # --- plan the h2r build as the JAX package does ---
    KPAD = _round_up(max(K, 1), 1 << 20)
    key_bits = 2 * k
    nb_est = max(64, -(-K // 44))
    stride2 = key_bits <= 30 and N < (1 << 28)
    base_mem = 4 * NPAD + (total_sep // 2 if fmt2 else total_sep)
    tbl_mem = nb_est * (512 if stride2 else 1024)
    mono_peak = KPAD * 32 + tbl_mem + base_mem
    chunk_peak = (KPAD * 16 + tbl_mem + base_mem + (KPAD // 16) * 4
                  + (16 << 20) * 48)
    env = os.environ.get("MM2TPU_DEVBUILD_H2R", "1")
    plan_mono = bool(K and env != "0" and env != "chunk"
                     and mono_peak < 12.0e9)
    plan_chunk = bool(K and env != "0" and not plan_mono
                      and chunk_peak < 14.0e9)
    keys2, sc2, chist = _compact(keys_s, khi_s, neq, N, KPAD=KPAD,
                                 NPAD=NPAD, wide=wide)
    pos2 = pos_s
    del keys_s, khi_s, pos_s, neq
    mark("compact")
    h2r, h2r_nb = None, 0
    NBH = max(64, -(-K // H2R_LOAD))
    if plan_chunk:
        h2r, h2r_nb = _build_h2r_chunked(keys2, sc2, K, KPAD, key_bits,
                                         stride2, NBH)
    elif plan_mono:
        CAPM = _round_up(max(KPAD // 16, 1 << 20), 1 << 20)
        for _ in range(5):
            try:
                rows, n_ov, n_mv = _h2rows_try(keys2, sc2, K, NB=NBH,
                                               CAPM=CAPM, key_bits=key_bits,
                                               stride2=stride2)
            except torch.OutOfMemoryError:
                break       # out of memory at the margin: the krows probe
            # a residual overflow of <= 1e-6 of the keys is dropped (those
            # minimizers never match); more grows the table
            if n_mv <= CAPM and n_ov <= max(0, K // 1_000_000):
                h2r, h2r_nb = rows, NBH
                break
            del rows
            NBH = int(NBH * 1.15) + 1
    if h2r is not None:
        # the payload probe reads h2r only: keys2/sc2 become placeholders
        bs = torch.zeros(2, dtype=torch.int32, device=dev)
        shift, probe_win, n_probe, krows = 0, 0, 1, None
        keys2 = torch.full((1, 2), UMAX, dtype=torch.int32, device=dev)
        sc2 = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    else:
        # the krows probe: grow bb until no bucket holds more than 25 keys
        bb = min(26, max(4, int(math.ceil(math.log2(max(K, 2)))) + 2),
                 key_bits)
        while True:
            shift = max(0, key_bits - bb)
            bs, bmax = _bucket_table(keys2, K, bb=bb, shift=shift)
            if bmax <= 25 or bb >= min(28, key_bits):
                break
            bb += 1
        probe_win = 2 if (bmax <= 25 and KPAD >= 128) else 0
        n_probe = max(1, int(math.ceil(math.log2(bmax + 1))))
        krows = None
        if probe_win:
            # 64 interleaved (hi, lo) pairs a row; the window probe reads
            # krows and sc2 only, so keys2 becomes a placeholder
            krows = keys2.reshape(-1, 128)
            keys2 = torch.full((1, 2), UMAX, dtype=torch.int32, device=dev)
    mark("h2r" if h2r is not None else "krows")
    # mid_occ = (k-th smallest count) + 1, read off the histogram
    if K:
        kk = min(int((1.0 - occ_frac) * K), K - 1)
        cum_real = chist.cpu().numpy() - (KPAD - K)  # pad rows sit in bin 0
        mid_occ = int(np.searchsorted(cum_real, kk + 1, side="left")) + 1
    else:
        mid_occ = (1 << 31) - 1
    pstrand = None
    if fmt2:
        # strand plane -> little-bit-order bitmap (bit j of byte b =
        # strand[8b + j]); S was packed before the sort
        pstrand = torch.zeros(NPAD // 8, dtype=torch.uint8, device=dev)
        for b in range(8):
            pstrand |= str_s[b::8] << b
    else:
        # the kept reference plane is plain nt4 (the -a path's gathers read
        # codes 0..4; separator code 5 only served the sketch)
        S.clamp_(max=4)
    del str_s
    rtab = build_rtab_np(np.asarray(seq_off, np.int64), int(total_sep))
    tables = {
        "keys2": keys2, "sc2": sc2, "bucket_start": bs, "krows": krows,
        "h2r": h2r, "pos2": pos2, "pstrand": pstrand, "S": S,
        "seq_off": torch.from_numpy(seq_off.astype(np.uint32)
                                    .view(np.int32)).to(dev),
        "seq_len": torch.from_numpy(lens.astype(np.int32)).to(dev),
        "rtab": None if rtab is None
        else torch.from_numpy(rtab.view(np.int32)).to(dev)}
    aux = {"key_shift": shift, "n_probe": n_probe, "h2_bits": 0,
           "h2_slots": 8, "pos_fmt": 2 if fmt2 else 1, "h2_nb": 0,
           "s_fmt": 1 if fmt2 else 0, "probe_win": probe_win,
           "h2r_nb": h2r_nb, "key_bits": key_bits,
           "rtab_on": 0 if rtab is None else 1}
    di = DeviceIndex.from_tensors(tables, aux)
    mark("finish")
    stage["total"] = time.time() - t0
    meta = DevBuildMeta(names=list(names), seq_off=seq_off, seq_len=lens,
                        w=w, k=k, n_mini=N, n_distinct=K, mid_occ=mid_occ,
                        stage_s=stage)
    return di, meta


def host_tables(di: DeviceIndex, meta: DevBuildMeta):
    """The index's tables copied to the host in MiniIndex coordinates, to
    hold a device build against a host build: (keys, starts, counts, y) --
    the sorted keys the probe table holds (h2r: all n_distinct but the <=
    1e-6 the build may drop; krows or keys2: every one), each key's run
    start and count in pos2 (counts clamp at 63 in stride-2 h2r rows), and
    y = rid << 32 | pos << 1 | strand of all n_mini positions.  Reads the
    whole probe table and pos2: a check, not a mapping step."""
    K = meta.n_distinct
    if di.h2r is None:
        kp = (di.krows if di.krows is not None else di.keys2).cpu().numpy()
        kp = kp.view(np.uint32).reshape(-1, 2)[:K].astype(np.uint64)
        keys = (kp[:, 0] << np.uint64(32)) | kp[:, 1]
        sc = di.sc2[:K].cpu().numpy().astype(np.int64)
        st, cn = sc[:, 0], sc[:, 1]
        ok = np.ones(len(keys), bool)
    elif di.h2r.shape[1] == 128:        # stride 2
        h2r = di.h2r.cpu().numpy().view(np.uint32)
        r = h2r.reshape(-1, 64, 2)
        ok = r[..., 0] != np.uint32(0xFFFFFFFF)
        keys = (r[..., 0][ok] & np.uint32(0x3FFFFFFF)).astype(np.uint64)
        st = (r[..., 1][ok] & np.uint32(0x0FFFFFFF)).astype(np.int64)
        cn = (((r[..., 0][ok] >> np.uint32(30)) << np.uint32(4))
              | (r[..., 1][ok] >> np.uint32(28))).astype(np.int64)
    else:
        h2r = di.h2r.cpu().numpy().view(np.uint32)
        r = h2r.reshape(-1, 64, 4)
        ok = r[..., 0] != np.uint32(0xFFFFFFFF)
        keys = r[..., 0][ok].astype(np.uint64)
        if di.key_bits > 31:
            keys = (keys << np.uint64(32)) | r[..., 1][ok].astype(np.uint64)
        st = r[..., 2][ok].astype(np.int64)
        cn = r[..., 3][ok].astype(np.int64)
    if not K - max(0, K // 1_000_000) <= int(ok.sum()) <= K:
        raise ValueError(f"the probe table holds {int(ok.sum())} keys of "
                         f"{K}")
    order = np.argsort(keys, kind="stable")
    p = di.pos2.cpu().numpy().view(np.uint32)[:meta.n_mini].astype(np.int64)
    if di.pos_fmt == 1:
        gpos, strand = p >> 1, p & 1
    else:
        ps = di.pstrand.cpu().numpy()
        i = np.arange(meta.n_mini)
        gpos, strand = p, (ps[i >> 3] >> (i & 7)) & 1
    rid = np.searchsorted(meta.seq_off, gpos, side="right") - 1
    y = (rid.astype(np.uint64) << np.uint64(32)) \
        | ((gpos - meta.seq_off[rid]).astype(np.uint64) << np.uint64(1)) \
        | strand.astype(np.uint64)
    return keys[order], st[order], cn[order], y
