"""Minimizer sketch of a read batch: CUDA kernel and its plain version.

Counterpart of minimap2_tpu.ops.sketch_pallas.sketch_batch (the Pallas
kernel, sketch_pallas.py:79-228) and of parallel/batch.device_sketch, its
XLA twin; both give the same planes.  Per position i (the k-mer ending at
i): hash64 of the canonical k-mer as (hi, lo) u32 planes, the strand z,
and is_mini -- set when the hash equals the minimum of at least one
complete w-window (ties included), the minimizer set of mm_sketch
(sketch.c:77-143, non-HPC); with ``with_valid``, also the validity plane
(the k-mer has no code >= 4, starts in the row and ends before len, and
is not its own reverse complement) that the index build's edge rule
reads (parallel/devbuild.py).

``sketch_batch`` launches the kernel (csrc/sketch.cu) for CUDA tensors
and runs ``device_sketch`` for CPU tensors; nothing else picks between
them.
"""
from __future__ import annotations

import torch

from ..utils.u32 import M32, i32
from . import _build

BIG = (1 << 63) - 1        # above every 2k <= 56-bit hash: the empty slot


def hash64_t(key: torch.Tensor, mask: int) -> torch.Tensor:
    """hash64 (sketch.c:28-38) on int64 keys below 2^56.  Every left shift
    drops the bits the mask would clear first, so no value leaves int64."""
    def shl(x, s):
        return (x & (mask >> s)) << s
    key = (~key + shl(key, 21)) & mask
    key = key ^ (key >> 24)
    key = (key + shl(key, 3) + shl(key, 8)) & mask
    key = key ^ (key >> 14)
    key = (key + shl(key, 2) + shl(key, 4)) & mask
    key = key ^ (key >> 28)
    return (key + shl(key, 31)) & mask


def _later(x, d, fill):
    """y[:, i] = x[:, i + d], ``fill`` past the end."""
    return torch.cat([x[:, d:], x.new_full((x.shape[0], d), fill)], dim=1)


def _earlier(x, d, fill):
    """y[:, i] = x[:, i - d], ``fill`` before the start."""
    return torch.cat([x.new_full((x.shape[0], d), fill), x[:, :-d]], dim=1)


def device_sketch(codes: torch.Tensor, lens: torch.Tensor, k: int, w: int,
                  with_valid: bool = False):
    """Plain version (port of batch.device_sketch).  codes (B, L) uint8 nt4
    (4 = ambiguous / padding; any code >= 4 is ambiguous), lens (B,) int32.
    Returns (hhi, hlo, z, is_mini[, valid]): hash planes as int32 bit
    patterns, the others bool."""
    B, L = codes.shape
    mask = (1 << (2 * k)) - 1
    c = codes.to(torch.int64)
    comp = torch.where(codes < 4, 3 ^ c, torch.zeros_like(c))
    kf = torch.zeros_like(c)
    kr = torch.zeros_like(c)
    for j in range(k):     # kmer[i] collects codes[i-k+1..i], 0 before 0
        cj = _earlier(c, j, 0) if j else c
        pj = _earlier(comp, j, 0) if j else comp
        kf |= cj << (2 * j)
        kr |= pj << (2 * (k - 1 - j))
    kf &= mask
    # validity: no ambiguous base among the k codes, position >= k-1, < len
    camb = torch.cumsum((codes >= 4).to(torch.int32), dim=1)
    posi = torch.arange(L, device=codes.device)[None, :]
    lens2 = lens.to(torch.int64)[:, None]
    okpos = (camb == _earlier(camb, k, 0)) & (posi >= k - 1) & (posi < lens2)
    valid = okpos & (kf != kr)
    z = kf >= kr
    h = hash64_t(torch.where(z, kr, kf), mask)
    x = torch.where(valid, h, torch.full_like(h, BIG))
    # windowed min over w consecutive k-mer ends: window j covers [j, j+w)
    wm = x
    for d in range(1, w):
        wm = torch.minimum(wm, _later(x, d, BIG))
    # window j is complete iff all its w members are valid slots
    cok = torch.cumsum(okpos.to(torch.int32), dim=1)
    cok_w = _later(cok, w - 1, 0) if w > 1 else cok
    wok = ((cok_w - _earlier(cok, 1, 0)) == w) & (posi <= lens2 - w)
    # x[i] is a minimizer iff the max over complete covering windows of
    # their minimum equals x[i]
    mx = torch.where(wok, wm, torch.zeros_like(wm))
    cv = mx
    anyw = wok
    for d in range(1, w):
        cv = torch.maximum(cv, _earlier(mx, d, 0))
        anyw = anyw | _earlier(wok, d, False)
    is_mini = valid & anyw & (cv == x) & (x != BIG)
    out = ((h >> 32).to(torch.int32), i32(h & M32), z, is_mini)
    return out + (valid,) if with_valid else out


def sketch_batch(codes: torch.Tensor, lens: torch.Tensor, k: int, w: int,
                 with_valid: bool = False):
    """Sketch a read batch; same outputs as ``device_sketch``."""
    if codes.device.type == "cpu":
        return device_sketch(codes, lens, k, w, with_valid)
    _build.require_cuda("sketch_batch", codes, lens)
    B, L = codes.shape
    if codes.dtype != torch.uint8 or lens.dtype != torch.int32 \
            or lens.shape != (B,):
        raise ValueError("sketch_batch: codes (B, L) uint8, lens (B,) int32")
    if not (0 < k <= 28 and 0 < w and k + w <= 128):
        raise ValueError(f"sketch_batch: needs k <= 28 and k + w <= 128 "
                         f"(k={k}, w={w})")
    # the kernel reads codes 16 bytes at a time
    if not codes.is_contiguous() or codes.data_ptr() % 16:
        codes = codes.clone(memory_format=torch.contiguous_format)
    lens = lens.contiguous()
    hhi = torch.empty((B, L), dtype=torch.int32, device=codes.device)
    hlo = torch.empty_like(hhi)
    z = torch.empty((B, L), dtype=torch.bool, device=codes.device)
    is_mini = torch.empty_like(z)
    valid = torch.empty_like(z) if with_valid else None
    err = _build.lib().mm2_sketch(
        codes.data_ptr(), lens.data_ptr(), hhi.data_ptr(), hlo.data_ptr(),
        z.data_ptr(), is_mini.data_ptr(),
        valid.data_ptr() if with_valid else None, B, L, k, w,
        _build.stream_ptr(codes))
    _build.check(err, "mm2_sketch")
    _build.launches["sketch"] += 1
    return (hhi, hlo, z, is_mini) + ((valid,) if with_valid else ())
