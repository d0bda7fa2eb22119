"""Device-batched seeding, chaining and extension: the port of
minimap2_tpu.parallel.batch.

A read batch runs sketch -> minimizer compaction -> h2r index probe ->
anchor expansion and sort -> windowed chain DP -> top-K chain selection
as PyTorch ops on one device, with fixed shapes throughout (the ``--batch``
drivers' step, parallel/engine.py).  ``map_batch`` is the one-call step
of the JAX package: sketch -> compaction -> probe -> chain scan -> a
score-only extd2 extension of each read's best chain.  The Pallas kernels
of these paths are CUDA kernels here (ops/); everything between them is
plain tensor code.

u32 planes (hashes, sort keys, table words) are int32 tensors holding the
bit pattern, with arithmetic on masked int64 copies (utils/u32.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..ops.chain import NEG_INF, comput_sc, last_valid
from ..ops.extend import EZ_SCORE, extd2_batch2
from ..ops.sketch import hash64_t, sketch_batch
from ..ops.sort import MAX_WIDTH, sort1_rows, sort3_chunked, sort3_rows
from ..utils.u32 import M32, i32, u32, umax_where


# ---------------------------------------------------------------------------
# u64 helpers (the JAX package's (hi, lo) pair arithmetic; PyTorch has
# int64, and every key here is below 2^56)
# ---------------------------------------------------------------------------


def hash64_pair(khi, klo, mask_hi: int, mask_lo: int):
    """hash64 (sketch.c:28-38) on (hi, lo) u32 planes, bit-exact; the
    planes are int32 bit patterns or int64 values, the result int32."""
    mask = (mask_hi << 32) | mask_lo
    key = ((u32(khi) & mask_hi) << 32) | (u32(klo) & mask_lo)
    h = hash64_t(key, mask)
    return i32(h >> 32), i32(h & M32)


def _mulhi_u32(a: torch.Tensor, nb: int) -> torch.Tensor:
    """High 32 bits of a (u32 as int64) * nb: exact in int64, nb < 2^31."""
    return (a * nb) >> 32


# ---------------------------------------------------------------------------
# static parameters of a batched mapping step
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchParams:
    """Fixed shapes + scores for one mapping step (the fields of
    minimap2_tpu.parallel.batch.BatchParams that the port's steps read,
    same defaults; the long-join trigger's constants live in engine.py)."""
    k: int = 15
    w: int = 10
    L: int = 2048          # max read length in batch
    M: int = 512           # minimizer capacity per read
    occ_cap: int = 16      # occurrences taken per seed (mid_occ analogue)
    A: int = 1024          # anchor capacity per read
    chain_window: int = 64 # chain DP look-back window (max_iter analogue)
    max_dist_x: int = 5000
    max_dist_y: int = 5000
    bw: int = 500
    chn_pen_gap: float = 0.8 * 0.01 * 15
    chn_pen_skip: float = 0.0
    # extension of map_batch (map-ont: -A2 -B4 -O4,24 -E2,1, zdrop 400)
    QP: int = 2048         # query segment capacity
    TP: int = 2048         # target segment capacity
    W: int = 640           # extension band lanes; must be >= ext_w + 112
    ext_w: int = 500       # extension band half-width (map-ont bw)
    sc_mch: int = 2
    sc_mis: int = -4
    gapo: int = 4
    gape: int = 2
    gapo2: int = 24
    gape2: int = 1
    zdrop: int = 400
    hpc: bool = False      # homopolymer-compressed minimizers (map-pb, -H)
    # long-join rescue (map.c:283-292) band; 0 = off
    bw_long: int = 0
    # RMQ tier (asm, lr:hqae, --rmq; lchain.c:219-368 re-expressed): a
    # second look-back window in the chain scan that keeps every
    # rmq_stride-th anchor for rmq_window slots, under the wide band
    rmq_tier: bool = False
    rmq_window: int = 64
    rmq_stride: int = 32


# ---------------------------------------------------------------------------
# device index: host builders (NumPy copies of the JAX package's)
# ---------------------------------------------------------------------------

H2R_SLOTS = 64      # entries per row (64 slots either stride)
H2R_LOAD = 44       # target mean keys per bucket
# stride 4 (256-lane rows): [key_sel, aux, start, cnt] -- any key width.
# stride 2 (128-lane rows): [key|cnt_hi2<<30, start|cnt_lo4<<28] -- keys
#   <= 30 bits (k <= 15) AND < 2^28 positions; cnt clamps at 63, so the
#   occurrence cap is at most 62 on this layout.
H2R2_OCC_CAP = 62


def _h2r_b1_np(lo, NB):
    """Choice-1 bucket: Fibonacci hash of the key's low word."""
    m1 = (lo * np.uint32(2654435769))
    return ((m1.astype(np.uint64) * np.uint64(NB))
            >> np.uint64(32)).astype(np.int64)


def build_h2rows_np(keys_u64: np.ndarray, starts: np.ndarray,
                    cnts: np.ndarray, key_bits: int,
                    nb0: int | None = None):
    """Host build of the payload-fused 2-choice bucket table (copy of
    batch.build_h2rows_np).  keys_u64: the SORTED distinct minimizer
    hashes; starts/cnts: their runs in the position plane.  Returns
    (rows (NB, 2*64 or 4*64) u32, NB)."""
    K = len(keys_u64)
    stride2 = key_bits <= 30 and (len(starts) == 0
                                  or int(starts[-1] + cnts[-1]) < (1 << 28))
    ROWW = (2 if stride2 else 4) * H2R_SLOTS
    wide = key_bits > 31
    hi = (keys_u64 >> np.uint64(32)).astype(np.uint32)
    lo = keys_u64.astype(np.uint32)
    k11 = (((lo >> np.uint32(11)) | (hi << np.uint32(21)))
           * np.uint32(2654435761))
    NB = nb0 if nb0 else max(64, -(-K // H2R_LOAD))
    i = np.arange(K, dtype=np.int64)
    while True:
        b1 = _h2r_b1_np(lo, NB)
        ord1 = np.argsort(b1, kind="stable")
        b1s = b1[ord1]
        rs = np.r_[True, b1s[1:] != b1s[:-1]] if K else np.zeros(0, bool)
        grp = np.maximum.accumulate(np.where(rs, i, 0))
        rank1s = i - grp
        placed1s = rank1s < H2R_SLOTS
        rank1 = np.empty(K, np.int64); rank1[ord1] = rank1s
        placed1 = np.zeros(K, bool); placed1[ord1] = placed1s
        occ1 = np.bincount(b1[placed1], minlength=NB) if K else \
            np.zeros(NB, np.int64)
        b2 = ((k11.astype(np.uint64) * np.uint64(NB))
              >> np.uint64(32)).astype(np.int64)
        midx = np.nonzero(~placed1)[0]
        ordm = np.argsort(b2[midx], kind="stable")
        midx = midx[ordm]
        mbs = b2[midx]
        nm = len(midx)
        j = np.arange(nm, dtype=np.int64)
        rs2 = np.r_[True, mbs[1:] != mbs[:-1]] if nm else np.zeros(0, bool)
        grp2 = np.maximum.accumulate(np.where(rs2, j, 0)) if nm else j
        rank2 = j - grp2
        cap2 = H2R_SLOTS - occ1[mbs] if nm else np.zeros(0, np.int64)
        placed2 = rank2 < cap2
        n_ov = int(nm - placed2.sum())
        if n_ov <= max(0, K // 1_000_000) or NB > 4 * max(64, -(-K // H2R_LOAD)):
            # residual overflow (<= 1e-6 of keys) is dropped: those
            # minimizers never match, like an occurrence filter
            break
        NB = int(NB * 1.15) + 1
    rows = np.full(NB * ROWW, 0xFFFFFFFF, np.uint32)

    if stride2:
        cnt6 = np.minimum(cnts, 63).astype(np.uint32)
        w0_all = lo | ((cnt6 >> np.uint32(4)) << np.uint32(30))
        w1_all = (starts.astype(np.uint32)
                  | ((cnt6 & np.uint32(15)) << np.uint32(28)))

        def scatter(bkt, slot, sel):
            base = bkt * ROWW + slot * 2
            rows[base] = w0_all[sel]
            rows[base + 1] = w1_all[sel]
    else:
        def scatter(bkt, slot, sel):
            base = bkt * ROWW + slot * 4
            rows[base] = (hi[sel] if wide else lo[sel])
            rows[base + 1] = (lo[sel] if wide else 0)
            rows[base + 2] = starts[sel].astype(np.uint32)
            rows[base + 3] = cnts[sel].astype(np.uint32)

    if K:
        scatter(b1[placed1], rank1[placed1], placed1)
        scatter(mbs[placed2], (occ1[mbs] + rank2)[placed2], midx[placed2])
    return rows.reshape(NB, ROWW), NB


def build_rtab_np(seq_off64: np.ndarray, total_len: int):
    """4 KiB-block rid table [off, next_off, rid, 0] (u32), or None when
    ineligible (<= 16 contigs use unrolled compares; a contig < 4 KiB
    would put two boundaries in one block)."""
    n = len(seq_off64)
    if n <= 16 or n >= 65535:
        return None
    gaps = np.diff(np.append(seq_off64.astype(np.int64), total_len))
    if len(gaps) == 0 or gaps.min() < 4096:
        return None
    nb = (total_len + 4095) // 4096
    rid = np.maximum(np.searchsorted(
        seq_off64, np.arange(nb, dtype=np.int64) * 4096,
        side="right") - 1, 0)
    off64 = seq_off64.astype(np.int64)
    nxt64 = np.append(off64[1:], np.int64(0xFFFFFFFF))
    rt = np.zeros((nb, 4), np.uint32)
    rt[:, 0] = off64[rid].astype(np.uint32)
    rt[:, 1] = nxt64[rid].astype(np.uint32)
    rt[:, 2] = rid.astype(np.uint32)
    return rt


def _pack_s4(S: np.ndarray) -> np.ndarray:
    """nt4 u8 codes -> two 4-bit codes per byte (code 4 = ambiguous fits)."""
    T = len(S)
    Sp = S if T % 2 == 0 else np.concatenate([S, np.zeros(1, np.uint8)])
    h = Sp.reshape(-1, 2)
    return (h[:, 0] | (h[:, 1] << np.uint8(4))).astype(np.uint8)


def _gather_s(di, idx: torch.Tensor) -> torch.Tensor:
    """Gather nt4 codes from di.S at int64 indices, either s_fmt (1: two
    4-bit codes a byte, the even position in the low nibble)."""
    if di.s_fmt == 0:
        return di.S[torch.clamp(idx, 0, di.S.shape[0] - 1)]
    b = di.S[torch.clamp(idx >> 1, 0, di.S.shape[0] - 1)]
    return (b >> ((idx & 1).to(torch.uint8) << 2)) & 0xF


def _as_tensor(a: np.ndarray, device) -> torch.Tensor:
    """NumPy table -> tensor; u32 tables become int32 bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


class DeviceIndex(nn.Module):
    """The minimizer index resident on the device, h2r layout only: the
    payload-fused 2-choice bucket table ``h2r`` (one probe = two row
    gathers), the position plane ``pos2`` (pos_fmt 1: global pos<<1 |
    strand; pos_fmt 2: global pos with strand in the ``pstrand`` bitmap),
    the reference codes ``S`` (s_fmt 0: one nt4 code a byte; 1: two),
    contig offsets/lengths and, for > 16 contigs of >= 4 KiB, the 4 KiB
    block rid table ``rtab``.  Tables are buffers; u32 tables are int32
    bit patterns.  The aux ints carry the JAX DeviceIndex's names and
    values."""

    LEAVES = ("h2r", "pos2", "pstrand", "S", "seq_off", "seq_len", "rtab")
    AUX = ("key_shift", "n_probe", "h2_bits", "h2_slots", "pos_fmt",
           "h2_nb", "s_fmt", "probe_win", "h2r_nb", "key_bits", "rtab_on")

    def __init__(self, tables: dict, aux: dict):
        super().__init__()
        for name in self.LEAVES:
            self.register_buffer(name, tables.get(name))
        for name in self.AUX:
            setattr(self, name, int(aux[name]))
        if self.h2r is None or not self.h2r_nb:
            raise NotImplementedError(
                "the port probes the h2r table only; the h2 / krows / "
                "binary-search layouts are not ported")
        if self.pos_fmt not in (1, 2):
            raise NotImplementedError(
                f"pos_fmt {self.pos_fmt}: the port reads pos_fmt 1 and 2")

    def aux_dict(self) -> dict:
        return {a: getattr(self, a) for a in self.AUX}

    @classmethod
    def from_tensors(cls, tables: dict, aux: dict):
        """From tables already on one device (the index build's,
        parallel/devbuild.py): no copy, no host round trip.  u32 tables are
        int32 bit patterns; None = absent."""
        dtypes = {"h2r": torch.int32, "pos2": torch.int32,
                  "pstrand": torch.uint8, "S": torch.uint8,
                  "seq_off": torch.int32, "seq_len": torch.int32,
                  "rtab": torch.int32}
        tabs = {n: t for n, t in tables.items() if t is not None}
        devs = {t.device for t in tabs.values()}
        if len(devs) != 1:
            raise ValueError(f"DeviceIndex tables on several devices: {devs}")
        for n, t in tabs.items():
            if t.dtype != dtypes[n]:
                raise ValueError(f"DeviceIndex table {n}: {t.dtype}, "
                                 f"expected {dtypes[n]}")
        return cls(tabs, aux)

    @classmethod
    def from_numpy(cls, leaves: dict, aux: dict, device=None):
        """From NumPy tables named as the JAX DeviceIndex's leaves (extra
        leaves such as keys2/sc2 are ignored; None = absent)."""
        device = resolve_device(device)
        tables = {n: _as_tensor(np.asarray(leaves[n]), device)
                  for n in cls.LEAVES if leaves.get(n) is not None}
        return cls(tables, aux)

    @classmethod
    def from_host(cls, mi, device=None, force_pos_fmt: int | None = None,
                  force_s_fmt: int | None = None):
        """Build the device index from a host MiniIndex, with the layout
        choices of the JAX DeviceIndex.from_host on its h2r route."""
        K = len(mi.keys)
        if K == 0:
            raise NotImplementedError("empty index: nothing to probe")
        cnts = (mi.starts[1:] - mi.starts[:-1]).astype(np.int32)
        S = np.ascontiguousarray(mi.S if mi.S is not None
                                 else np.zeros(1, np.uint8))
        seq_off64 = np.array([s.offset for s in mi.seq] or [0], np.uint64)
        seq_len = np.array([s.length for s in mi.seq] or [0], np.int32)
        bb = min(26, max(4, int(math.ceil(math.log2(max(K, 2)))) + 2))
        key_bits = 2 * mi.k
        rows, nb = build_h2rows_np(mi.keys, mi.starts[:-1].astype(np.int64),
                                   cnts, key_bits,
                                   nb0=max(64, -(-K // H2R_LOAD)))
        pos = mi.pos
        total_len = (int(seq_off64[-1]) + int(seq_len[-1]) if len(S) else 0)
        if total_len < (1 << 31):
            pos_fmt = 1
        elif total_len < (1 << 32) - 1:
            pos_fmt = 2      # GRCh38 scale: strand in a side bitmap
        else:
            pos_fmt = 0
        if force_pos_fmt is not None:
            pos_fmt = force_pos_fmt
        if pos_fmt not in (1, 2):
            raise NotImplementedError(
                f"pos_fmt {pos_fmt} (genomes of 2^32 bases or more)")
        rid_h = (pos >> np.uint64(32)).astype(np.int64)
        rp_h = (pos & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        goff = seq_off64.astype(np.uint32)[
            np.clip(rid_h, 0, len(seq_off64) - 1)]
        ppad = max(1, len(pos))
        pos2 = np.zeros(ppad, np.uint32)
        pstrand = None
        if pos_fmt == 1:
            pos2[:len(pos)] = rp_h + (goff << np.uint32(1))
        else:
            pos2[:len(pos)] = (rp_h >> np.uint32(1)) + goff
            sbits = np.zeros(((ppad + 7) // 8) * 8, np.uint8)
            sbits[:len(pos)] = (rp_h & np.uint32(1)).astype(np.uint8)
            pstrand = np.packbits(sbits.reshape(-1, 8), axis=-1,
                                  bitorder="little")[:, 0]
        s_fmt = 1 if (len(S) >= int(1.6e9) or pos_fmt == 2) else 0
        if force_s_fmt is not None:
            s_fmt = force_s_fmt
        rtab = build_rtab_np(seq_off64, total_len)
        leaves = {"h2r": rows, "pos2": pos2, "pstrand": pstrand,
                  "S": _pack_s4(S) if s_fmt else S,
                  "seq_off": seq_off64.astype(np.uint32).view(np.int32),
                  "seq_len": seq_len, "rtab": rtab}
        aux = {"key_shift": max(0, key_bits - bb), "n_probe": 1,
               "h2_bits": 0, "h2_slots": 4 if key_bits < 32 else 8,
               "pos_fmt": pos_fmt, "h2_nb": 0, "s_fmt": s_fmt,
               "probe_win": 0, "h2r_nb": nb, "key_bits": key_bits,
               "rtab_on": 0 if rtab is None else 1}
        return cls.from_numpy(leaves, aux, device)


# ---------------------------------------------------------------------------
# seeding
# ---------------------------------------------------------------------------

KEY_NONE = 0x7FFFFFFF       # compaction key of a non-minimizer lane


def _compact_minimizers(hhi, hlo, strand, is_mini, M: int):
    """Select up to M minimizer positions per read, in position order:
    the 3-plane bitonic route of the JAX package (key = pos<<1 | strand,
    unique per row, with the hash pair riding as the other two planes).
    The rank-scatter route agrees with it on valid lanes only; downstream
    code masks the rest with mvalid.

    Past 16384 lanes (the JAX package's one-key lax.sort, batch.py:833-838)
    the key plane alone goes through sort1_rows and the hash pair is
    gathered at each sorted key's position: the keys are unique, so the
    valid lanes are the JAX package's; invalid lanes hold hash 0."""
    B, L = hhi.shape
    A = 1 << (max(L, M) - 1).bit_length()                 # pad to pow2
    posi = torch.arange(L, device=hhi.device, dtype=torch.int32)[None, :]
    key = torch.where(is_mini, (posi << 1) | strand.to(torch.int32),
                      torch.full_like(hhi, KEY_NONE))
    if A > L:
        def pad(x, v):
            return torch.cat([x, x.new_full((B, A - L), v)], dim=1)
        key, hhi, hlo = pad(key, KEY_NONE), pad(hhi, 0), pad(hlo, 0)
    if A > MAX_WIDTH:
        skey = sort1_rows(key)[:, :M]
        live = skey != KEY_NONE
        at = torch.where(live, skey >> 1, 0).to(torch.int64)
        mh_hi, mh_lo = (torch.where(live, torch.gather(x, 1, at), 0)
                        for x in (hhi, hlo))
    else:
        if A > 4096:
            skey, mh_hi, mh_lo = sort3_chunked(key, hhi, hlo, chunk=2048,
                                               keep=1024)
        else:
            skey, mh_hi, mh_lo = sort3_rows(key, hhi, hlo)
        skey, mh_hi, mh_lo = skey[:, :M], mh_hi[:, :M], mh_lo[:, :M]
    mvalid = skey != KEY_NONE
    mpos = torch.where(mvalid, skey >> 1, torch.full_like(skey, L))
    mz = torch.where(mvalid, skey & 1, torch.zeros_like(skey))
    return mh_hi, mh_lo, mz, mpos, mvalid


def hpc_compact(codes, lens):
    """Homopolymer-run compression (sketch.c:94-105 HPC mode), the sort1
    route of the JAX package's hpc_compact (batch.py:873-910).  Each run
    contributes one symbol at the position of its LAST base.  Returns
    (hcodes (B, L) uint8, 4 past the compacted read; hpos (B, L) int32 run
    end positions in the read, L past the compacted read; lc (B,) int32
    compacted lengths).  Spans >= 256 are not dropped (the reference drops
    such k-mers; the span plane clips them)."""
    B, L = codes.shape
    dev = codes.device
    posi = torch.arange(L, device=dev, dtype=torch.int32)[None, :]
    c32 = codes.to(torch.int32)
    nxt = torch.cat([c32[:, 1:], c32.new_full((B, 1), 4)], dim=1)
    ln = lens.to(torch.int32)[:, None]
    run_end = (posi < ln) & ((c32 != nxt) | (posi == ln - 1))
    lc = run_end.sum(1, dtype=torch.int32)
    A = 1 << (L - 1).bit_length()
    key = torch.where(run_end, posi, KEY_NONE)
    if A > L:
        key = torch.cat([key, key.new_full((B, A - L), KEY_NONE)], dim=1)
    hpos = torch.clamp(sort1_rows(key)[:, :L], max=L)
    hcodes = torch.where(hpos < L, torch.gather(
        c32, 1, torch.clamp(hpos, max=L - 1).to(torch.int64)), 4)
    return hcodes.to(torch.uint8), hpos, lc


def _probe_h2r(di: DeviceIndex, mh_hi, mh_lo, mvalid, occ_cap: int):
    """The h2r probe: two row gathers per minimizer -> (start, cnt, flt)
    with cnt zeroed above the occurrence cap and flt marking seeds the
    cap filtered.  Gathers stay int32 ((B, M, 128) words each)."""
    lo, hi = u32(mh_lo), u32(mh_hi)
    nb = di.h2r_nb
    b1 = _mulhi_u32((lo * 2654435769) & M32, nb)
    k11 = ((((lo >> 11) | (hi << 21)) & M32) * 2654435761) & M32
    b2 = _mulhi_u32(k11, nb)
    B, M = mh_lo.shape
    if di.h2r.shape[1] == 2 * H2R_SLOTS:
        # stride-2 rows: slot s = [key|cnt_hi2<<30, start|cnt_lo4<<28].
        # (An empty slot's masked key word is 0x3FFFFFFF, so that one key
        # value can false-hit with cnt 63 -> occurrence-filtered.)
        def probe2(bkt):
            r = di.h2r[bkt].view(B, M, H2R_SLOTS, 2)
            hit = (r[..., 0] & 0x3FFFFFFF) == mh_lo[..., None]
            return (u32(umax_where(hit, r[..., 0])),
                    u32(umax_where(hit, r[..., 1])), hit.any(-1))

        w0a, w1a, fa = probe2(b1)
        w0b, w1b, fb = probe2(b2)
        w0v = torch.maximum(w0a, w0b)
        w1v = torch.maximum(w1a, w1b)
        found = (fa | fb) & mvalid
        start = torch.where(found, w1v & 0x0FFFFFFF, 0)
        cnt_raw = ((w0v >> 30) << 4) | (w1v >> 28)
        occ_eff = min(occ_cap, H2R2_OCC_CAP)
    else:
        # stride-4 rows: slot s = [key_sel, aux, start, cnt]
        wide = di.key_bits >= 32
        hits, starts, cnts = [], [], []
        for bkt in (b1, b2):
            r = di.h2r[bkt].view(B, M, H2R_SLOTS, 4)
            if wide:
                hit = (r[..., 0] == mh_hi[..., None]) \
                    & (r[..., 1] == mh_lo[..., None])
            else:
                hit = r[..., 0] == mh_lo[..., None]
            hits.append(hit.any(-1))
            starts.append(torch.where(hit, r[..., 2], 0).amax(-1))
            cnts.append(torch.where(hit, r[..., 3], 0).amax(-1))
        found = (hits[0] | hits[1]) & mvalid
        start = torch.where(found, torch.maximum(*starts), 0)
        cnt_raw = torch.maximum(*cnts)
        occ_eff = occ_cap
    cnt = torch.where(found & (cnt_raw <= occ_eff), cnt_raw, 0)
    flt = found & (cnt_raw > occ_eff)
    return start.to(torch.int32), cnt.to(torch.int32), flt


def _lookup_anchors(di: DeviceIndex, mh_hi, mh_lo, mz, mpos, mvalid, qlen,
                    p: BatchParams, mspan=None):
    """Seed lookup + anchor expansion (seed.c:30-52, map.c:168-204): the
    h2r branch of the JAX package's _lookup_anchors.  mspan is the (B, M)
    query span of each minimizer (k unless HPC).  Returns int32 anchor
    planes sorted by (rev, rid, rpos, qpos) -- rev, rid, rpos, qpos, span
    -- the valid mask, and the per-read rep_len."""
    start, cnt, flt = _probe_h2r(di, mh_hi, mh_lo, mvalid, p.occ_cap)
    if mspan is None:
        mspan = torch.full_like(mpos, p.k)
    return _expand_anchors(di, start, cnt, flt, mz, mpos, mspan, qlen, p)


def _rid_of(di: DeviceIndex, gpos_u):
    """Contig index and offset of global positions (int64 u32 values)."""
    so_u = u32(di.seq_off)
    n_seq = so_u.shape[0]
    if n_seq <= 16:
        # tiny contig tables: unrolled compares.  The first contig starts
        # at seq_off[0], which is OV, not 0, in a device-built index (the
        # JAX package starts at 0 here and shifts contig 0 by OV bases)
        rid = torch.zeros_like(gpos_u)
        off_sel = so_u[0] + torch.zeros_like(gpos_u)
        for j in range(1, n_seq):
            in_j = gpos_u >= so_u[j]
            rid = rid + in_j.to(rid.dtype)
            off_sel = torch.where(in_j, so_u[j], off_sel)
        return rid, off_sel
    if di.rtab is not None:
        # one 16 B row [off, next_off, rid] per 4 KiB block; at most one
        # contig boundary in a block (contigs >= 4 KiB)
        rv = u32(di.rtab[torch.clamp(gpos_u >> 12, max=di.rtab.shape[0] - 1)])
        nxt = rv[..., 1]
        ge = gpos_u >= nxt
        return rv[..., 2] + ge.to(torch.int64), torch.where(ge, nxt, rv[..., 0])
    # branchless binary search over the sorted offsets
    lo_ = torch.zeros_like(gpos_u)
    hi_ = torch.full_like(gpos_u, n_seq)
    for _ in range(int(math.ceil(math.log2(n_seq))) + 1):
        mid = (lo_ + hi_) >> 1
        go = so_u[torch.clamp(mid, 0, n_seq - 1)]
        take = (mid < n_seq) & (go <= gpos_u)
        lo_ = torch.where(take, mid + 1, lo_)
        hi_ = torch.where(take, hi_, mid)
    rid = torch.clamp(lo_ - 1, min=0)
    return rid, so_u[rid]


def _expand_anchors(di: DeviceIndex, start, cnt, flt, mz, mpos, mspan, qlen,
                    p: BatchParams):
    """Seed (start, cnt) runs -> sorted anchor planes + rep_len."""
    B, M = start.shape
    dev = start.device
    A = p.A
    # rep_len: union of [pos-k+1, pos+1) over filtered seeds (mpos is
    # ascending) -- sum of min(k, en_i - en_prev_filtered)
    en = mpos + 1
    en_f = torch.where(flt, en, 0)
    prev_excl = torch.cat([torch.zeros_like(en_f[:, :1]),
                           torch.cummax(en_f, dim=1).values[:, :-1]], dim=1)
    contrib = torch.where(flt, torch.clamp(en - prev_excl, max=p.k), 0)
    rep_len = contrib.sum(1).to(torch.int32)
    # adaptive per-read occurrence cap when the anchors would overflow A
    total0 = cnt.sum(1, keepdim=True)
    nfound = torch.clamp((cnt > 0).sum(1, keepdim=True), min=1)
    cap_r = torch.clamp(A // nfound, min=1).to(cnt.dtype)
    cnt = torch.where(total0 > A, torch.minimum(cnt, cap_r), cnt)
    # per-seed output offsets; anchors beyond capacity A are dropped
    offs = torch.cumsum(cnt, dim=1, dtype=torch.int32) - cnt
    ends = offs + cnt
    slot = torch.arange(A, device=dev, dtype=torch.int32)[None, :]
    # seed_of[a] = seed j covering slot a: seed ids at run starts, then a
    # running max
    jrow = torch.arange(M, device=dev, dtype=torch.int32)[None, :].expand(B, M)
    scat = torch.where(cnt > 0, torch.clamp(offs, max=A - 1), A - 1)
    mark = torch.full((B, A), -1, dtype=torch.int32, device=dev)
    mark.scatter_reduce_(1, scat.to(torch.int64),
                         torch.where(cnt > 0, jrow, -1), reduce="amax")
    seed_of = torch.clamp(torch.cummax(mark, dim=1).values, 0, M - 1) \
        .to(torch.int64)
    a_valid = slot < ends[:, -1:]

    def g(x):
        return torch.gather(x, 1, seed_of)
    pidx = torch.clamp(g(start) + (slot - g(offs)), 0, di.pos2.shape[0] - 1) \
        .to(torch.int64)
    pv1 = u32(di.pos2[pidx])
    if di.pos_fmt == 1:
        gpos_u = pv1 >> 1
        rstrand = pv1 & 1
    else:
        gpos_u = pv1
        sb = di.pstrand[torch.clamp(pidx >> 3, max=di.pstrand.shape[0] - 1)]
        rstrand = (sb.to(torch.int64) >> (pidx & 7)) & 1
    rid, off_sel = _rid_of(di, gpos_u)
    rpos_u = (gpos_u - off_sel) & M32
    qz, qpos, span = g(mz), g(mpos), g(mspan)
    same = rstrand == qz
    rev = (~same).to(torch.int64)
    # query coordinate flip on reverse strand (seed.c / map.c:196-201)
    qpos_out = torch.where(same, qpos, qlen[:, None] - (qpos + 1 - span) - 1)
    # sort by (rev<<30|rid, rpos, span<<20|qpos); invalid lanes last
    key1 = torch.where(a_valid, (rev << 30) | rid, M32)
    key3 = (torch.clamp(span, 1, 255).to(torch.int64) << 20) \
        | torch.clamp(qpos_out, min=0).to(torch.int64)
    keys = [i32(key1), i32(rpos_u), i32(key3)]
    Ap = 1 << (A - 1).bit_length()
    if Ap > A:      # pad to a power of two with the all-ones sentinel
        keys = [torch.cat([x, x.new_full((B, Ap - A), -1)], dim=1)
                for x in keys]
    key1, key2, key3 = (x[:, :A] for x in sort3_rows(*keys))
    av = key1 != -1
    k1u = u32(key1)
    return ((k1u >> 30).to(torch.int32) & 1,
            (k1u & 0x3FFFFFFF).to(torch.int32),
            key2.contiguous(),
            (key3 & 0xFFFFF).contiguous(),
            (u32(key3) >> 20).to(torch.int32),
            av.contiguous(), rep_len)


# ---------------------------------------------------------------------------
# chaining and selection
# ---------------------------------------------------------------------------


def _chain_scan(rev, rid, rpos, qpos, span, av, p: BatchParams):
    """Windowed chaining DP (lchain.c:148-217 with a fixed look-back
    window), the port of the JAX package's lax.scan route.  The window is a
    shift register (slot 0 the oldest) and ties go to the oldest slot
    (argmax takes the first), unlike the kernel route, which takes the
    largest j.  With ``p.rmq_tier`` a second window of p.rmq_window slots
    takes every p.rmq_stride-th anchor (global index i % rmq_stride == 0)
    and is searched under the wide band (bw_long where it exceeds bw); it
    comes after the short window, so ties still go to the short window,
    and a predecessor found there has pred -2.  Returns (best, (f, pred,
    qs_a, rs_a)): best = per-read (score, qs, qe, rs, re, rev, rid) of the
    best chain end.  The scan stops after the last valid anchor of the
    batch; later lanes take their closed form (f NEG_INF, pred -1, qs = rs
    = 0)."""
    B, A = rpos.shape
    WND = p.chain_window
    dev = rpos.device
    i32_ = torch.int32
    bw2 = p.bw_long if p.bw_long > p.bw else p.bw
    f = torch.full((B, A), NEG_INF, dtype=i32_, device=dev)
    pred = torch.full((B, A), -1, dtype=i32_, device=dev)
    qs = torch.zeros((B, A), dtype=i32_, device=dev)
    rs = torch.zeros((B, A), dtype=i32_, device=dev)

    def window(n):
        """(f, rev, rid, rpos, qpos, span, qs, rs) planes of n slots."""
        z = torch.zeros((B, n), dtype=i32_, device=dev)
        return [torch.full((B, n), NEG_INF, dtype=i32_, device=dev)] + \
            [z.clone() for _ in range(7)]

    def push(wnd, vals):
        return [torch.cat([w_[:, 1:], v[:, None]], dim=1)
                for w_, v in zip(wnd, vals)]

    w1 = window(WND)
    w2 = window(p.rmq_window) if p.rmq_tier else None
    zb = torch.zeros(B, dtype=i32_, device=dev)
    best = [torch.full((B,), NEG_INF, dtype=i32_, device=dev)] + \
        [zb.clone() for _ in range(6)]
    neg1 = torch.full((B,), -1, dtype=i32_, device=dev)
    neg2 = torch.full((B,), -2, dtype=i32_, device=dev)
    def cands(anchor, wnd, band):
        """Candidate scores of the anchor (qp, rp, rv, ri) against a
        window's slots."""
        fw, revw, ridw, rposw, qposw, spanw = wnd[:6]
        return comput_sc(*anchor, qposw, rposw, revw, ridw, spanw, fw,
                         p.max_dist_x, p.max_dist_y, band, p.chn_pen_gap,
                         p.chn_pen_skip)

    for i in range(last_valid(av)):
        rv, ri, rp, qp, sp, ok = (x[:, i] for x in
                                  (rev, rid, rpos, qpos, span, av))
        anchor = (qp, rp, rv, ri)
        cand, qsw, rsw = cands(anchor, w1, p.bw), w1[6], w1[7]
        if w2 is not None:
            cand = torch.cat([cand, cands(anchor, w2, bw2)], dim=1)
            qsw = torch.cat([qsw, w2[6]], dim=1)
            rsw = torch.cat([rsw, w2[7]], dim=1)
        bj = torch.argmax(cand, dim=1, keepdim=True)
        bsc = torch.gather(cand, 1, bj)[:, 0]
        use = bsc >= sp
        f_i = torch.where(ok, torch.where(use, bsc, sp),
                          torch.full_like(sp, NEG_INF))
        qs_i = torch.where(use, torch.gather(qsw, 1, bj)[:, 0], qp - sp + 1)
        rs_i = torch.where(use, torch.gather(rsw, 1, bj)[:, 0], rp - sp + 1)
        pj = (i - WND + bj[:, 0]).to(i32_)
        if w2 is not None:
            pj = torch.where(bj[:, 0] < WND, pj, neg2)
        pred[:, i] = torch.where(use & ok, pj, neg1)
        qs_i = torch.where(ok, qs_i, 0)
        rs_i = torch.where(ok, rs_i, 0)
        f[:, i], qs[:, i], rs[:, i] = f_i, qs_i, rs_i
        # roll the windows, insert the current anchor at the end
        vals = (f_i, rv, ri, rp, qp, sp, qs_i, rs_i)
        w1 = push(w1, vals)
        if w2 is not None and i % p.rmq_stride == 0:
            w2 = push(w2, vals)
        # track the best-ending chain per read
        better = f_i > best[0]
        best = [torch.where(better, v, b_) for v, b_ in
                zip((f_i, qs_i, qp + 1, rs_i, rp + 1, rv, ri), best)]
    return tuple(best), (f, pred, qs, rs)


def topk_chains(f, qs_a, rs_a, rev, rid, rpos, qpos, av, K: int,
                min_sc: int, with_sec: bool = False):
    """Greedy top-K query-non-overlapping chains per read (mg_chain_
    backtrack + mm_set_parent's primary selection, lchain.c:27-76,
    hit.c:125-186): take the best chain end, mask every anchor inside its
    query span, record the best overlapping non-member as its sub-score.
    Returns 9 planes of shape (K, B): score, sub, qs, qe, rs, re, rev,
    rid, cnt.

    with_sec=True also emits, after each selected chain, its best
    query-overlapping runner-up as an explicit record (the reference keeps
    such chains as secondaries) -> (2K, B) planes, slots interleaved
    [pri0, sec0, pri1, sec1, ...]; a missing secondary has score <= 0."""
    alive = av & (f >= min_sc)
    neg = torch.full_like(f, NEG_INF)
    outs = []

    def chain_of(bi):
        """The chain ending at anchor bi (B, 1): its start/end/strand/rid
        and its member anchors."""
        qs1, rs1 = torch.gather(qs_a, 1, bi), torch.gather(rs_a, 1, bi)
        qe1, re1 = torch.gather(qpos, 1, bi) + 1, torch.gather(rpos, 1, bi) + 1
        rev1, rid1 = torch.gather(rev, 1, bi), torch.gather(rid, 1, bi)
        member = (qs_a == qs1) & (rs_a == rs1) & (rev == rev1) & (rid == rid1)
        cnt1 = (member & alive).sum(1, dtype=torch.int32)
        return [x[:, 0] for x in (qs1, qe1, rs1, re1, rev1, rid1)], member, \
            cnt1

    for _ in range(K):
        fm = torch.where(alive, f, neg)
        bi = torch.argmax(fm, dim=1, keepdim=True)
        sc1 = torch.gather(fm, 1, bi)[:, 0]
        (qs1, qe1, rs1, re1, rev1, rid1), member, cnt1 = chain_of(bi)
        ovlp = (qpos >= qs1[:, None]) & (qpos < qe1[:, None])
        sub_cand = torch.where(alive & ovlp & ~member, f, neg)
        sub1 = sub_cand.amax(1)
        outs.append((sc1, sub1, qs1, qe1, rs1, re1, rev1, rid1, cnt1))
        if with_sec:
            bi2 = torch.argmax(sub_cand, dim=1, keepdim=True)
            (qs2, qe2, rs2, re2, rev2, rid2), _, cnt2 = chain_of(bi2)
            outs.append((sub1, sc1, qs2, qe2, rs2, re2, rev2, rid2, cnt2))
        alive = alive & ~ovlp
    return [torch.stack(x).to(torch.int32) for x in zip(*outs)]


def chain_waypoints(qs_a, rs_a, rev, rid, rpos, qpos, av, rec0, WP: int):
    """Up to WP evenly spaced member anchors of each read's chosen chain
    (the device side of anchored decomposition, align.c:803-872): the align
    driver splits the chain extent at waypoint diagonal jumps into
    band-sized segment DPs.  rec0 = (qs1, rs1, rev1, rid1), each (B,).
    Returns (wq, wr) int32 (B, WP), -1 = empty; within a chain rpos and
    qpos are non-decreasing, so a per-bucket max keeps (q, r) paired."""
    qs1, rs1, rev1, rid1 = rec0
    B = qs_a.shape[0]
    member = av & (qs_a == qs1[:, None]) & (rs_a == rs1[:, None]) \
        & (rev == rev1[:, None]) & (rid == rid1[:, None])
    rank = torch.cumsum(member.to(torch.int32), dim=1)
    cnt = rank[:, -1:]
    j = torch.clamp(torch.div((rank - 1) * (WP - 1),
                              torch.clamp(cnt - 1, min=1),
                              rounding_mode="floor"), 0, WP - 1)
    jm = torch.where(member, j, WP - 1).to(torch.int64)
    out = []
    for plane in (qpos, rpos):
        w_ = torch.full((B, WP), -1, dtype=torch.int32, device=qs_a.device)
        val = torch.where(member, plane, -1).to(torch.int32)
        out.append(w_.scatter_reduce(1, jm, val, reduce="amax"))
    return tuple(out)


# ---------------------------------------------------------------------------
# the one-call device step
# ---------------------------------------------------------------------------


def _extend_best(di: DeviceIndex, codes, lens, best, p: BatchParams):
    """Banded extension of each read's best chain region through extd2 in
    its score-only approx-max mode (the JAX package's _extend_best,
    batch.py:1445-1497): query[qs:qe] (reverse-complemented on the reverse
    strand) against target[rs:re] of contig rid.  Returns the (B,) int32
    extension scores."""
    _b_sc, qs, qe, rs, re_, rv, rid = best
    B, L = codes.shape
    i32_ = torch.int32
    lens = lens.to(i32_)
    qs = torch.minimum(torch.clamp(qs, min=0), lens)
    qe = torch.minimum(torch.maximum(qe, qs), lens)
    ridc = torch.clamp(rid, 0, di.seq_len.shape[0] - 1).long()
    tlen_full = di.seq_len[ridc]
    rs = torch.minimum(torch.clamp(rs, min=0), tlen_full)
    re_ = torch.minimum(torch.maximum(re_, rs), tlen_full)
    qlen = torch.clamp(qe - qs, max=p.QP)[:, None]
    tlen = torch.clamp(re_ - rs, max=p.TP)[:, None]
    rev1 = rv[:, None] == 1
    # the query segment, reverse-complemented on the reverse strand (the
    # read's codes from its other end), in segment order, then reversed:
    # the kernel takes qr[i] = q[qlen - 1 - i]
    ar = torch.arange(p.QP, device=codes.device, dtype=i32_)[None, :]
    qidx = torch.where(rev1, (lens - qe)[:, None] + ar, qs[:, None] + ar)
    qcode = torch.gather(codes, 1, torch.clamp(qidx, 0, L - 1).long())
    qcode = torch.where(rev1 & (qcode < 4), 3 - qcode, qcode)
    qcode = torch.where(ar < qlen, qcode, 4).to(torch.uint8)
    flip = torch.where(rev1, qlen - 1 - ar, ar)
    qcode = torch.gather(qcode, 1, torch.clamp(flip, 0, p.QP - 1).long())
    qr = torch.gather(qcode, 1, torch.clamp(qlen - 1 - ar, 0, p.QP - 1).long())
    art = torch.arange(p.TP, device=codes.device, dtype=torch.int64)[None, :]
    soff = u32(di.seq_off[ridc])
    # pos_fmt 2 offsets are u32: the JAX package's index wraps mod 2^32
    tidx = (soff[:, None] + rs.to(torch.int64)[:, None] + art) & M32
    tcode = torch.where(art < tlen, _gather_s(di, tidx), 4).to(torch.uint8)
    lens2 = torch.cat([torch.clamp(qlen, min=1), torch.clamp(tlen, min=1)],
                      dim=1).to(i32_)
    _, ez = extd2_batch2(
        qr.contiguous(), tcode.contiguous(), lens2.contiguous(), G=16,
        W=p.W, RB=128, R=p.QP + p.TP - 1, QP=p.QP, TP=p.TP, q=p.gapo,
        e=p.gape, q2=p.gapo2, e2=p.gape2,
        w=min(p.ext_w, p.W - 48 - 64),     # band + 48 + RB/2 drift in W
        zdrop=p.zdrop, right_mode=False, approx_max=True, approx_drop=False,
        sc_mch=p.sc_mch, sc_mis=p.sc_mis, sc_N=-1, with_cigar=False)
    return ez[:, EZ_SCORE]


def map_batch(di: DeviceIndex, codes, lens, p: BatchParams) -> dict:
    """One full device mapping step over a (B, L) uint8 nt4 read batch on
    the index's device (the JAX package's map_batch, batch.py:1500-1524):
    sketch -> compaction -> probe -> windowed chain scan -> score-only
    extension of each read's best chain.  Returns a dict of (B,) tensors:
    chain_score, ext_score, mapped, rid, rev, qs, qe, rs, re, n_anchors."""
    hhi, hlo, z, is_mini = sketch_batch(codes, lens, p.k, p.w)
    mh_hi, mh_lo, mz, mpos, mvalid = _compact_minimizers(hhi, hlo, z,
                                                         is_mini, p.M)
    rev, rid, rpos, qpos, span, av, _rep = _lookup_anchors(
        di, mh_hi, mh_lo, mz, mpos, mvalid, lens, p)
    best, _ = _chain_scan(rev, rid, rpos, qpos, span, av, p)
    ext = _extend_best(di, codes, lens, best, p)
    b_sc, qs, qe, rs, re_, rv, rid_b = best
    return {
        "chain_score": b_sc, "ext_score": ext, "mapped": b_sc > 0,
        "rid": rid_b, "rev": rv, "qs": qs, "qe": qe, "rs": rs, "re": re_,
        "n_anchors": av.sum(1, dtype=torch.int32),
    }
