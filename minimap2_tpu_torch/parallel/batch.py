"""Device-batched seeding, chaining and extension: the port of
minimap2_tpu.parallel.batch.

A read batch runs sketch -> minimizer compaction -> index probe (any
layout of the JAX DeviceIndex: h2r, h2, krows, binary search) -> anchor
expansion and sort -> windowed chain DP -> top-K chain selection as
PyTorch ops on one device, with fixed shapes throughout (the ``--batch``
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
import os
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import native, resolve_device
from ..ops.chain import NEG_INF, comput_sc, last_valid
from ..ops.extend import EZ_SCORE, extd2_batch2
from ..ops.sketch import hash64_t, sketch_batch
from ..ops.sort import (KEY_NONE, MAX_WIDTH, sort1_ascending, sort3_chunked,
                        sort3_rows, sort3_wide)
from ..utils import trace
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


UMAX64 = 0xFFFFFFFFFFFFFFFF     # key pad of the bucket layout's keys2


class DeviceIndex(nn.Module):
    """The minimizer index resident on the device, in any layout of the JAX
    DeviceIndex (same leaf and aux names and values).  One probe table
    serves the seed lookup, the first present of:

    - ``h2r`` (NB, 64 * stride) u32: the payload-fused 2-choice bucket
      table (one probe = two row gathers; ``h2r_nb`` buckets);
    - ``h2`` (NB, slots * 3 or 4) i32: the 2-choice bucketed table of the
      host library's build_hash2_table, [key_lo, start, cnt] (keys < 2^32)
      or [key_hi, key_lo, start, cnt]; buckets by mulhi over ``h2_nb``, or
      by a 2^``h2_bits`` mask when h2_nb is 0;
    - ``krows`` (K/64, 128) u32: the sorted keys as 64 interleaved (hi, lo)
      pairs a row, probed by a two-row window from ``bucket_start`` (every
      bucket holds <= 25 keys; ``probe_win``), the runs in ``sc2``;
    - ``bucket_start`` (2^bb + 1,) i32 over ``keys2`` (K, 2) u32 [hi, lo]:
      a binary search of ``n_probe`` steps within the key's bucket
      (key >> ``key_shift``);
    - ``keys2`` alone: a binary search over all keys.

    ``sc2`` (K, 2) i32 holds each key's [start, cnt] run in the position
    plane ``pos2``: pos_fmt 0 (P, 2) i32 [rid, rpos << 1 | strand]; pos_fmt
    1 (P,) u32 global pos << 1 | strand; pos_fmt 2 (P,) u32 global pos with
    the strand in the ``pstrand`` bitmap.  ``S`` holds the reference codes
    (s_fmt 0: one nt4 code a byte; 1: two), with contig offsets/lengths
    and, for > 16 contigs of >= 4 KiB at pos_fmt 1 and 2, the 4 KiB block
    rid table ``rtab``.  Tables are buffers, u32 tables int32 bit patterns;
    an absent table is None."""

    # the JAX DeviceIndex's leaves, in its order (that of its .npz cache)
    LEAVES = ("keys2", "sc2", "pos2", "S", "seq_off", "seq_len",
              "bucket_start", "h2", "pstrand", "krows", "h2r", "rtab")
    AUX = ("key_shift", "n_probe", "h2_bits", "h2_slots", "pos_fmt",
           "h2_nb", "s_fmt", "probe_win", "h2r_nb", "key_bits", "rtab_on")
    DTYPES = {"keys2": torch.int32, "sc2": torch.int32, "pos2": torch.int32,
              "S": torch.uint8, "seq_off": torch.int32,
              "seq_len": torch.int32, "bucket_start": torch.int32,
              "h2": torch.int32, "pstrand": torch.uint8,
              "krows": torch.int32, "h2r": torch.int32, "rtab": torch.int32}
    # leaves the JAX package keeps as u32 (pos2 too unless pos_fmt 0)
    U32 = ("keys2", "krows", "h2r", "rtab")

    def __init__(self, tables: dict, aux: dict):
        super().__init__()
        for name in self.LEAVES:
            self.register_buffer(name, tables.get(name))
        for name in self.AUX:
            setattr(self, name, int(aux[name]))
        if self.pos_fmt not in (0, 1, 2):
            raise ValueError(f"pos_fmt {self.pos_fmt}")

    @property
    def device(self) -> torch.device:
        """The device the tables live on (pos2 is in every layout)."""
        return self.pos2.device

    def aux_dict(self) -> dict:
        return {a: getattr(self, a) for a in self.AUX}

    def to_numpy(self) -> dict:
        """The leaves as NumPy arrays with the JAX DeviceIndex's dtypes
        (u32 tables as uint32); absent leaves are left out."""
        out = {}
        for name in self.LEAVES:
            t = getattr(self, name)
            if t is None:
                continue
            a = t.cpu().numpy()
            if name in self.U32 or (name == "pos2" and self.pos_fmt):
                a = a.view(np.uint32)
            out[name] = a
        return out

    @classmethod
    def from_tensors(cls, tables: dict, aux: dict):
        """From tables already on one device (the index build's,
        parallel/devbuild.py): no copy, no host round trip.  u32 tables are
        int32 bit patterns; None = absent."""
        tabs = {n: t for n, t in tables.items() if t is not None}
        devs = {t.device for t in tabs.values()}
        if len(devs) != 1:
            raise ValueError(f"DeviceIndex tables on several devices: {devs}")
        for n, t in tabs.items():
            if t.dtype != cls.DTYPES[n]:
                raise ValueError(f"DeviceIndex table {n}: {t.dtype}, "
                                 f"expected {cls.DTYPES[n]}")
        return cls(tabs, aux)

    @classmethod
    def from_numpy(cls, leaves: dict, aux: dict, device=None):
        """From NumPy tables named as the JAX DeviceIndex's leaves (None or
        missing = absent): a JAX index of any layout, given as NumPy
        arrays, becomes the port's."""
        device = resolve_device(device)
        tables = {n: _as_tensor(np.asarray(leaves[n]), device)
                  for n in cls.LEAVES if leaves.get(n) is not None}
        return cls.from_tensors(tables, aux)

    @classmethod
    def from_host(cls, mi, device=None, force_pos_fmt: int | None = None,
                  force_s_fmt: int | None = None, cache: str | None = None,
                  n_shards: int | None = None):
        """Build the device index from a host MiniIndex with the layout
        rules of the JAX DeviceIndex.from_host.  With ``n_shards`` it
        returns that many key-range shards, padded to one shape (the JAX
        package's list); without, one DeviceIndex.  ``cache`` names an .npz
        file of the JAX package's format: loaded when it exists and holds
        this shard count (any failure rebuilds), written after a build."""
        # as in the JAX package, a cache that does not load is rebuilt and
        # one that cannot be written is skipped: the cache only saves time
        if cache and os.path.exists(cache):
            try:
                return cls._load_cache(cache, device, n_shards)
            except Exception:
                pass
        layouts = host_layout(mi, force_pos_fmt, force_s_fmt, n_shards or 1)
        shards = [cls.from_numpy(lv, aux, device) for lv, aux in layouts]
        if cache:
            try:
                cls._save_cache(cache, layouts)
            except Exception:
                pass
        return shards if n_shards is not None else shards[0]

    @classmethod
    def _save_cache(cls, path, layouts):
        """``s<i>_<leaf>`` for every shard's (leaves, aux), and meta: the
        shard count, then shard 0's aux ints (the JAX package's file)."""
        arrs = {f"s{i}_{n}": np.asarray(lv[n])
                for i, (lv, _aux) in enumerate(layouts) for n in cls.LEAVES
                if lv.get(n) is not None}
        aux = layouts[0][1]
        arrs["meta"] = np.array([len(layouts)] + [int(aux[a])
                                                  for a in cls.AUX], np.int64)
        np.savez(path, **arrs)

    @classmethod
    def _load_cache(cls, path, device=None, n_shards: int | None = None,
                    shard: int | None = None):
        """The shards of an .npz cache, which must hold ``n_shards`` of
        them (1 when None); every shard takes meta's aux.  Returns the list
        when n_shards is given, else the one DeviceIndex; with ``shard`` only
        that shard's arrays are read (np.load reads a key when asked)."""
        n = 1 if n_shards is None else n_shards
        with np.load(path) as z:
            meta = z["meta"]
            if int(meta[0]) != n:
                raise ValueError("shard count mismatch")
            if len(meta) != 1 + len(cls.AUX):
                raise ValueError("cache from an older layout")
            aux = {a: int(v) for a, v in zip(cls.AUX, meta[1:])}
            shards = []
            for i in range(n) if shard is None else [shard]:
                leaves = {nm: z[f"s{i}_{nm}"] for nm in cls.LEAVES
                          if f"s{i}_{nm}" in z.files}
                if aux["probe_win"] and "krows" not in leaves:
                    raise ValueError("cache predates the krows layout")
                if aux["h2r_nb"] and "h2r" not in leaves:
                    raise ValueError("cache predates the h2r layout")
                shards.append(cls.from_numpy(leaves, aux, device))
        return shards if n_shards is not None and shard is None \
            else shards[0]

    def shard(self, i: int) -> "DeviceIndex":
        """Shard i of an index from ``stack_shards`` (its tables' row i)."""
        return DeviceIndex({n: getattr(self, n)[i] for n in self.LEAVES
                            if getattr(self, n) is not None},
                           self.aux_dict())


def stack_shards(shards: list) -> DeviceIndex:
    """The shards' tables stacked along a leading shard axis (the JAX
    package's tree_map(jnp.stack)); ``DeviceIndex.shard(i)`` undoes it.
    Raises unless every shard has the same aux ints and table shapes."""
    aux = shards[0].aux_dict()
    for sh in shards[1:]:
        if sh.aux_dict() != aux:
            raise ValueError(f"stack_shards: aux {sh.aux_dict()} != {aux}")
        for n in DeviceIndex.LEAVES:
            a, b = getattr(shards[0], n), getattr(sh, n)
            if (a is None) != (b is None) or (a is not None
                                              and a.shape != b.shape):
                raise ValueError(f"stack_shards: table {n} differs in "
                                 "shape between shards")
    return DeviceIndex({n: torch.stack([getattr(sh, n) for sh in shards])
                        for n in DeviceIndex.LEAVES
                        if getattr(shards[0], n) is not None}, aux)


def host_layout(mi, force_pos_fmt: int | None = None,
                force_s_fmt: int | None = None, n_shards: int = 1) -> list:
    """The device index's NumPy leaves (the JAX DeviceIndex's dtypes) and
    aux ints from a host MiniIndex, one (leaves, aux) per key-range shard,
    by the rules of the JAX from_host: the h2r table unless MM2TPU_H2R=0
    or the index is empty; else the h2 table when the host library builds
    (grown by 15% until no key overflows); else the bucket table over the
    sorted keys, probed through krows when no bucket holds more than 25
    keys.  pos_fmt 1 below 2^31 bases, 2 below 2^32 - 1, else 0; s_fmt 1
    from 1.6 Gb, at pos_fmt 2, or with MM2TPU_PACK_S=1.

    Shard i holds keys [i K / n, (i + 1) K / n) and their positions p0:p1,
    its runs relative to p0; the key and position planes are padded to the
    largest shard's (keys to a multiple of 64), and every shard has the
    same h2r or h2 bucket count; S, the contig offsets and lengths and rtab are whole in
    each."""
    K = len(mi.keys)
    cnts = (mi.starts[1:] - mi.starts[:-1]).astype(np.int32)
    bounds = [(i * K) // n_shards for i in range(n_shards + 1)]
    spans = [(bounds[i], bounds[i + 1]) for i in range(n_shards)]
    kmax = max(hi - lo for lo, hi in spans)
    kpad = (max(1, kmax) + 63) // 64 * 64       # krows: 64-pair rows
    S = np.ascontiguousarray(mi.S if mi.S is not None
                             else np.zeros(1, np.uint8))
    seq_off64 = np.array([s.offset for s in mi.seq] or [0], np.uint64)
    seq_off = seq_off64.astype(np.uint32).view(np.int32)
    seq_len = np.array([s.length for s in mi.seq] or [0], np.int32)
    ppad = max(1, max(int(mi.starts[hi] - mi.starts[lo]) for lo, hi in spans))
    bb = min(26, max(4, int(math.ceil(math.log2(max(K, 2)))) + 2))
    key_bits = 2 * mi.k
    shift = max(0, key_bits - bb)
    use_h2r = K > 0 and os.environ.get("MM2TPU_H2R", "1") != "0"
    use_h2 = not use_h2r and K > 0 and native.available()
    key32 = key_bits < 32
    h2_slots = 4 if key32 else 8

    def p0_of(lo):
        return int(mi.starts[lo]) if K else 0

    tables = [None] * n_shards
    h2_nb = h2r_nb = 0
    if use_h2r:
        # one bucket count for every shard: a build that grows it restarts
        # every shard at the new count
        h2r_nb = max(64, -(-kmax // H2R_LOAD))
        i = 0
        while i < n_shards:
            lo, hi = spans[i]
            tables[i], nb = build_h2rows_np(
                mi.keys[lo:hi], (mi.starts[lo:hi] - p0_of(lo))
                .astype(np.int64), cnts[lo:hi], key_bits, nb0=h2r_nb)
            if nb != h2r_nb:
                h2r_nb, i = nb, 0
            else:
                i += 1
    elif use_h2:
        # mulhi over a bucket count that is not a power of two, one for
        # every shard; grow 15% while any key overflows both its buckets
        h2_nb = max(64, int(math.ceil(kmax / (h2_slots * 0.85))))
        while True:
            ov_tot = 0
            for i, (lo, hi) in enumerate(spans):
                tables[i], ov = native.build_hash2_table(
                    mi.keys[lo:hi], (mi.starts[lo:hi + 1] - p0_of(lo))
                    .astype(np.int64), h2_nb, h2_slots, key32, mulhi=True)
                ov_tot += ov
            if ov_tot == 0:
                break
            h2_nb = int(h2_nb * 1.15) + 1
    total_len = (int(seq_off64[-1]) + int(seq_len[-1]) if len(S) else 0)
    if total_len < (1 << 31):
        pos_fmt = 1
    elif total_len < (1 << 32) - 1:
        pos_fmt = 2      # GRCh38 scale: strand in a side bitmap
    else:
        pos_fmt = 0
    if force_pos_fmt is not None:
        pos_fmt = force_pos_fmt
    s_fmt = 1 if (len(S) >= int(1.6e9) or pos_fmt == 2
                  or os.environ.get("MM2TPU_PACK_S") == "1") else 0
    if force_s_fmt is not None:
        s_fmt = force_s_fmt
    S_out = _pack_s4(S) if s_fmt else S
    rtab = build_rtab_np(seq_off64, total_len) if pos_fmt else None
    out = []
    for i, (lo, hi) in enumerate(spans):
        p0, p1 = p0_of(lo), (int(mi.starts[hi]) if K else 0)
        krows = None
        if use_h2r or use_h2:
            keys2 = np.full((1, 2), 0xFFFFFFFF, np.uint32)
            sc2 = np.zeros((1, 2), np.int32)
            bstart = np.zeros(2, np.int32)
            n_probe, probe_win = 1, 0
        else:
            keys = np.full(kpad, UMAX64, np.uint64)
            keys[:hi - lo] = mi.keys[lo:hi]
            keys2 = np.empty((kpad, 2), np.uint32)
            keys2[:, 0] = (keys >> np.uint64(32)).astype(np.uint32)
            keys2[:, 1] = keys.astype(np.uint32)
            nb = 1 << min(bb, key_bits)
            bstart = np.searchsorted(
                mi.keys[lo:hi].astype(np.uint64) >> np.uint64(shift),
                np.arange(nb + 1, dtype=np.uint64)).astype(np.int32)
            sc2 = np.zeros((kpad, 2), np.int32)
            sc2[:hi - lo, 0] = (mi.starts[lo:hi] - p0).astype(np.int32)
            sc2[:hi - lo, 1] = cnts[lo:hi]
            bmax = int(np.diff(bstart).max()) if len(bstart) > 1 else 1
            n_probe = max(1, int(math.ceil(math.log2(bmax + 1))))
            probe_win = 2 if (bmax <= 25 and kpad >= 128) else 0
            if probe_win:   # (kpad, 2) row-major = [hi0, lo0, hi1, ...]
                krows = keys2.reshape(-1, 128)
        pos = mi.pos[p0:p1]
        pstrand = None
        if pos_fmt:
            rid_h = (pos >> np.uint64(32)).astype(np.int64)
            rp_h = (pos & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            goff = seq_off64.astype(np.uint32)[
                np.clip(rid_h, 0, len(seq_off64) - 1)]
            pos2 = np.zeros(ppad, np.uint32)
            if pos_fmt == 1:
                pos2[:len(pos)] = rp_h + (goff << np.uint32(1))
            else:
                pos2[:len(pos)] = (rp_h >> np.uint32(1)) + goff
                sbits = np.zeros(((ppad + 7) // 8) * 8, np.uint8)
                sbits[:len(pos)] = (rp_h & np.uint32(1)).astype(np.uint8)
                pstrand = np.packbits(sbits.reshape(-1, 8), axis=-1,
                                      bitorder="little")[:, 0]
        else:
            # two planes: rid, and rpos << 1 | strand
            pos2 = np.zeros((ppad, 2), np.int32)
            pos2[:len(pos), 0] = (pos >> np.uint64(32)).astype(np.int32)
            pos2[:len(pos), 1] = (pos
                                  & np.uint64(0xFFFFFFFF)).astype(np.int32)
        leaves = {"keys2": keys2, "sc2": sc2, "pos2": pos2, "S": S_out,
                  "seq_off": seq_off, "seq_len": seq_len,
                  "bucket_start": bstart,
                  "h2": tables[i] if use_h2 else None, "pstrand": pstrand,
                  "krows": krows, "h2r": tables[i] if use_h2r else None,
                  "rtab": rtab}
        aux = {"key_shift": shift, "n_probe": n_probe, "h2_bits": 0,
               "h2_slots": h2_slots, "pos_fmt": pos_fmt, "h2_nb": h2_nb,
               "s_fmt": s_fmt, "probe_win": probe_win, "h2r_nb": h2r_nb,
               "key_bits": key_bits, "rtab_on": 0 if rtab is None else 1}
        out.append((leaves, aux))
    return out


# ---------------------------------------------------------------------------
# seeding
# ---------------------------------------------------------------------------

def _compact_minimizers(hhi, hlo, strand, is_mini, M: int):
    """Select up to M minimizer positions per read, in position order:
    the 3-plane bitonic route of the JAX package (key = pos<<1 | strand,
    unique per row, with the hash pair riding as the other two planes).
    The rank-scatter route agrees with it on valid lanes only; downstream
    code masks the rest with mvalid.

    Past 16384 lanes (the JAX package's one-key lax.sort, batch.py:833-838)
    the key plane alone goes through sort1 (past 32768 lanes in chunks,
    ``sort1_ascending``) and the hash pair is gathered at each sorted key's
    position: the keys are unique, so the valid lanes are the JAX
    package's; invalid lanes hold hash 0."""
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
        skey = sort1_ascending(key, keep=M)
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
    route of the JAX package's hpc_compact (batch.py:873-910), past 32768
    lanes in chunks (``sort1_ascending``).  Each run
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
    hpos = torch.clamp(sort1_ascending(key, keep=L), max=L)
    hcodes = torch.where(hpos < L, torch.gather(
        c32, 1, torch.clamp(hpos, max=L - 1).to(torch.int64)), 4)
    return hcodes.to(torch.uint8), hpos, lc


def _probe_h2r(di: DeviceIndex, mh_hi, mh_lo, mvalid):
    """The h2r probe: two row gathers per minimizer.  Gathers stay int32
    ((B, M, 128) words each).  Each probe returns (start, cnt_raw,
    found)."""
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
    return start, cnt_raw, found


def _lt64(ahi, alo, bhi, blo):
    """(ahi, alo) < (bhi, blo) on u32 values held in int64."""
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def _probe_h2(di: DeviceIndex, mh_hi, mh_lo, mvalid):
    """The h2 probe: the rows of both candidate buckets, [key_lo, start,
    cnt] slots (keys < 2^32) or [key_hi, key_lo, start, cnt]; buckets by
    mulhi over h2_nb, or by the legacy 2^h2_bits mask."""
    lo, hi = u32(mh_lo), u32(mh_hi)
    S_ = di.h2_slots
    key32 = di.h2.shape[1] == S_ * 3
    st = 3 if key32 else 4
    k11 = ((((lo >> 11) | (hi << 21)) & M32) * 2654435761) & M32
    if di.h2_nb:
        b1 = _mulhi_u32((lo * 2654435769) & M32, di.h2_nb)
        b2 = _mulhi_u32(k11, di.h2_nb)
    else:
        mask = (1 << di.h2_bits) - 1
        b1, b2 = lo & mask, (k11 >> 7) & mask
    B, M = mh_lo.shape
    t = torch.cat([di.h2[b1], di.h2[b2]], dim=-1).view(B, M, 2 * S_, st)
    if key32:
        hit = t[..., 0] == mh_lo[..., None]
    else:
        hit = (t[..., 0] == mh_hi[..., None]) & (t[..., 1] == mh_lo[..., None])
    found = hit.any(-1) & mvalid
    start = torch.where(found, torch.where(hit, t[..., st - 2], 0).amax(-1), 0)
    cnt_raw = torch.where(hit, t[..., st - 1], 0).amax(-1)
    return start, cnt_raw, found


def _bucket_of(di: DeviceIndex, mh_hi, mh_lo):
    """Bucket of each key in bucket_start: key >> key_shift (low word)."""
    key = (u32(mh_hi) << 32) | u32(mh_lo)
    return torch.clamp((key >> di.key_shift) & M32, 0,
                       di.bucket_start.shape[0] - 2)


def _probe_krows(di: DeviceIndex, mh_hi, mh_lo, mvalid):
    """The windowed krows probe: a bucket's keys are contiguous in the
    sorted keys and at most 25, so the two 64-pair rows from the row of
    bucket_start[b] hold them all; the first equal lane (argmax) gives the
    key's index into sc2."""
    RK, KP = di.krows.shape[0], di.sc2.shape[0]
    B, M = mh_lo.shape
    lo0 = di.bucket_start[_bucket_of(di, mh_hi, mh_lo)]
    row = torch.clamp(lo0 >> 6, 0, RK - 2).to(torch.int64)
    eq = []
    for r in (row, row + 1):
        kr = di.krows[r].view(B, M, 64, 2)
        eq.append((kr[..., 0] == mh_hi[..., None])
                  & (kr[..., 1] == mh_lo[..., None]))
    eq = torch.cat(eq, dim=-1)                                # (B, M, 128)
    found = eq.any(-1) & mvalid
    lane = torch.argmax(eq.to(torch.uint8), dim=-1)
    sv = di.sc2[torch.clamp(row * 64 + lane, max=KP - 1)]
    return torch.where(found, sv[..., 0], 0), sv[..., 1], found


def _probe_sorted(di: DeviceIndex, mh_hi, mh_lo, mvalid):
    """The binary search over keys2: within the key's bucket in n_probe
    steps when bucket_start is there, else over all keys in
    bit_length(K + 1) steps (the JAX package's searchsorted_u64pair)."""
    K = di.keys2.shape[0]
    qhi, qlo = u32(mh_hi), u32(mh_lo)
    if di.bucket_start is not None:
        bkt = _bucket_of(di, mh_hi, mh_lo)
        lo_ = di.bucket_start[bkt].to(torch.int64)
        hi_ = di.bucket_start[bkt + 1].to(torch.int64)
        steps = di.n_probe
    else:
        lo_ = torch.zeros_like(qhi)
        hi_ = torch.full_like(qhi, K)
        steps = max(1, (K + 1).bit_length())
    for _ in range(steps):
        mid = (lo_ + hi_) >> 1
        kv = di.keys2[torch.clamp(mid, 0, K - 1)]
        less = _lt64(u32(kv[..., 0]), u32(kv[..., 1]), qhi, qlo) & (mid < hi_)
        lo_ = torch.where(less, mid + 1, lo_)
        hi_ = torch.where(less, hi_, mid)
    idx = torch.clamp(lo_, max=K - 1)
    kv = di.keys2[idx]
    found = (kv[..., 0] == mh_hi) & (kv[..., 1] == mh_lo) & mvalid
    sv = di.sc2[idx]
    return torch.where(found, sv[..., 0], 0), sv[..., 1], found


def probe_layout(di: DeviceIndex) -> str:
    """The probe the index's tables select, in the JAX package's order."""
    if di.h2r is not None:
        return "h2r"
    if di.h2 is not None:
        return "h2"
    if di.bucket_start is not None and di.probe_win and di.krows is not None:
        return "krows"
    return "bucket" if di.bucket_start is not None else "searchsorted"


def probe_seeds(di: DeviceIndex, mh_hi, mh_lo, mvalid, occ_cap: int):
    """Seed lookup (seed.c:30-52) through the index's probe -> (start,
    cnt, flt): each minimizer's run in pos2, cnt zeroed above the
    occurrence cap (mid_occ: such seeds are skipped, not truncated), flt
    marking the seeds the cap filtered."""
    layout = probe_layout(di)
    probe = {"h2r": _probe_h2r, "h2": _probe_h2,
             "krows": _probe_krows}.get(layout, _probe_sorted)
    start, cnt_raw, found = probe(di, mh_hi, mh_lo, mvalid)
    if layout == "h2r" and di.h2r.shape[1] == 2 * H2R_SLOTS:
        # stride-2 rows clamp a count at 63
        occ_cap = min(occ_cap, H2R2_OCC_CAP)
    cnt = torch.where(found & (cnt_raw <= occ_cap), cnt_raw, 0)
    return (start.to(torch.int32), cnt.to(torch.int32),
            found & (cnt_raw > occ_cap))


def _lookup_anchors(di: DeviceIndex, mh_hi, mh_lo, mz, mpos, mvalid, qlen,
                    p: BatchParams, mspan=None):
    """Seed lookup + anchor expansion (seed.c:30-52, map.c:168-204), the
    JAX package's _lookup_anchors with every probe.  mspan is the (B, M)
    query span of each minimizer (k unless HPC).  Returns int32 anchor
    planes sorted by (rev, rid, rpos, qpos) -- rev, rid, rpos, qpos, span
    -- the valid mask, and the per-read rep_len."""
    with trace.span("paf_step:probe"):
        start, cnt, flt = probe_seeds(di, mh_hi, mh_lo, mvalid, p.occ_cap)
    with trace.span("paf_step:anchors"):
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
    if di.pos_fmt == 0:
        # two planes: [rid, rpos << 1 | strand]
        pv = di.pos2[pidx]
        rid = pv[..., 0].to(torch.int64)
        rpos_u = (pv[..., 1] >> 1).to(torch.int64)
        rstrand = (pv[..., 1] & 1).to(torch.int64)
    else:
        pv1 = u32(di.pos2[pidx])
        if di.pos_fmt == 1:
            gpos_u = pv1 >> 1
            rstrand = pv1 & 1
        else:
            gpos_u = pv1
            sb = di.pstrand[torch.clamp(pidx >> 3,
                                        max=di.pstrand.shape[0] - 1)]
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
    return sort_anchor_keys([i32(key1), i32(rpos_u), i32(key3)], A) \
        + (rep_len,)


def sort_keys(keys, counter: str = "sort3"):
    """Anchor sort keys (three (B, W) int32 planes) padded to a power of
    two with the all-ones sentinel and sorted by one sort3 launch (counted
    under ``counter``).  Rows that pad past sort.MAX_WIDTH lanes take
    ``sort3_wide`` unpadded (the JAX step's lax.sort route), counted as
    ``sort3_wide`` for the anchor sort and ``<counter>_wide`` for another
    caller: the width alone picks the route."""
    B, W = keys[0].shape
    Wp = 1 << (W - 1).bit_length()
    if Wp > MAX_WIDTH:
        return sort3_wide(*keys, counter="sort3_wide" if counter == "sort3"
                          else f"{counter}_wide")
    if Wp > W:
        keys = [torch.cat([x, x.new_full((B, Wp - W), -1)], dim=1)
                for x in keys]
    return sort3_rows(*keys, counter=counter)


def sort_anchor_keys(keys, keep: int, counter: str = "sort3"):
    """``sort_keys``, the first ``keep`` lanes unpacked by
    anchors_of_keys."""
    k1, k2, k3 = (x[:, :keep] for x in sort_keys(keys, counter))
    return anchors_of_keys(k1, k2, k3)


def anchor_keys(rev, rid, rpos, qpos, span, av):
    """The anchors' sort keys (rev << 30 | rid, rpos, span << 20 | qpos)
    as int32 bit patterns, the all-ones sentinel on every plane of an
    invalid lane: what _expand_anchors sorts, rebuilt from its planes."""
    def key(x):
        return torch.where(av, x, torch.full_like(x, -1))
    return (key((rev << 30) | rid), key(rpos), key((span << 20) | qpos))


def anchors_of_keys(key1, key2, key3):
    """Sorted anchor keys -> the planes rev, rid, rpos, qpos, span and the
    valid mask (key1 not the sentinel)."""
    k1u = u32(key1)
    return ((k1u >> 30).to(torch.int32) & 1,
            (k1u & 0x3FFFFFFF).to(torch.int32),
            key2.contiguous(),
            (key3 & 0xFFFFF).contiguous(),
            (u32(key3) >> 20).to(torch.int32),
            (key1 != -1).contiguous())


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
