"""Row-wise bitonic sorts: CUDA kernels and their plain versions.

Counterparts of minimap2_tpu.ops.sort_pallas.sort3_rows (sort_pallas.py:
22-73), sort3_chunked (:76-97) and sort1_rows (:120-138, kernel
``_sort1_kernel`` :100): each row is sorted ascending by the lexicographic
(k1, k2, k3) u32 triple, or by one u32 plane.  The planes are int32
tensors holding u32 bit patterns.  Every plane takes part in the key, so
any correct sort gives the same planes; the plain versions run the same
bitonic network (partner = i ^ j) in torch.

``sort3_rows`` / ``sort1_rows`` launch their kernels (csrc/sort3.cu,
csrc/sort1.cu) for CUDA tensors and run ``sort3_rows_plain`` /
``sort1_rows_plain`` for CPU tensors.
"""
from __future__ import annotations

import torch

from ..utils.u32 import i32, u32
from . import _build

MAX_WIDTH = 16384      # A * 12 bytes of shared memory per row (192 KB)
SORT1_MAX_WIDTH = 32768  # A * 4 bytes of shared memory per row (128 KB)


def _lex_gt(a, b):
    """(a1, ..., an) > (b1, ..., bn), lexicographic."""
    gt = a[-1] > b[-1]
    for x, y in zip(a[-2::-1], b[-2::-1]):
        gt = (x > y) | ((x == y) & gt)
    return gt


def _bitonic_rows_plain(*keys):
    """Bitonic network on (B, A) planes, A a power of two, ascending by the
    lexicographic tuple of the planes."""
    B, A = keys[0].shape
    planes = [u32(x) for x in keys]
    kk = 2
    while kk <= A:
        j = kk >> 1
        while j >= 1:
            # pairs (i, i + j) with bit j of i clear: the two halves of
            # each 2j-lane block; block q sorts ascending iff bit kk of
            # its first lane is clear
            v = [x.view(B, A // (2 * j), 2, j) for x in planes]
            lo = [x[:, :, 0] for x in v]
            hi = [x[:, :, 1] for x in v]
            q = torch.arange(A // (2 * j), device=keys[0].device)
            asc = (((q * 2 * j) & kk) == 0)[None, :, None]
            swap = torch.where(asc, _lex_gt(lo, hi), _lex_gt(hi, lo))
            planes = [torch.stack([torch.where(swap, h, l),
                                   torch.where(swap, l, h)],
                                  dim=2).view(B, A)
                      for l, h in zip(lo, hi)]
            j >>= 1
        kk <<= 1
    return tuple(i32(x) for x in planes)


def sort3_rows_plain(k1, k2, k3):
    """Plain version of sort3_rows."""
    return _bitonic_rows_plain(k1, k2, k3)


def sort1_rows_plain(k1):
    """Plain version of sort1_rows."""
    return _bitonic_rows_plain(k1)[0]


def sort1_rows(k1):
    """Row-wise ascending sort of one u32 plane (int32 bit pattern, shape
    (B, A), A a power of two): the HPC run-end compaction."""
    B, A = k1.shape
    if A & (A - 1) or A < 2:
        raise ValueError(f"sort1_rows: width {A} is not a power of two")
    if k1.device.type == "cpu":
        return sort1_rows_plain(k1)
    _build.require_cuda("sort1_rows", k1)
    if k1.dtype != torch.int32:
        raise ValueError("sort1_rows: one (B, A) int32 plane")
    if A > SORT1_MAX_WIDTH:
        raise ValueError(f"sort1_rows: width {A} > {SORT1_MAX_WIDTH}")
    out = torch.empty_like(k1)
    err = _build.lib().mm2_sort1(k1.data_ptr(), out.data_ptr(), B, A,
                                 _build.stream_ptr(k1))
    _build.check(err, "mm2_sort1")
    _build.launches["sort1"] += 1
    return out


def sort3_rows(k1, k2, k3):
    """Row-wise ascending lexicographic sort of three u32 planes
    (int32 bit patterns, shape (B, A), A a power of two)."""
    B, A = k1.shape
    if A & (A - 1) or A < 2:
        raise ValueError(f"sort3_rows: width {A} is not a power of two")
    if k1.device.type == "cpu":
        return sort3_rows_plain(k1, k2, k3)
    _build.require_cuda("sort3_rows", k1, k2, k3)
    if any(x.dtype != torch.int32 or x.shape != (B, A) for x in (k1, k2, k3)):
        raise ValueError("sort3_rows: three (B, A) int32 planes")
    if A > MAX_WIDTH:
        raise ValueError(f"sort3_rows: width {A} > {MAX_WIDTH}")
    outs = [torch.empty_like(k1) for _ in range(3)]
    err = _build.lib().mm2_sort3(
        k1.data_ptr(), k2.data_ptr(), k3.data_ptr(),
        *(o.data_ptr() for o in outs), B, A, _build.stream_ptr(k1))
    _build.check(err, "mm2_sort3")
    _build.launches["sort3"] += 1
    return tuple(outs)


def sort3_chunked(k1, k2, k3, chunk: int = 2048, keep: int = 1024):
    """Two-level sort for wide rows, as sort_pallas.sort3_chunked: sort
    ``chunk``-lane pieces, then sort the concatenation of each piece's
    first ``keep`` lanes.  Exact while no chunk holds more than ``keep``
    live keys; that cut is the reference's and is kept."""
    B, A = k1.shape
    if A % chunk or keep > chunk:
        raise ValueError(f"sort3_chunked: width {A}, chunk {chunk}")
    C = A // chunk
    s = sort3_rows(*(x.reshape(B * C, chunk) for x in (k1, k2, k3)))
    return sort3_rows(*(x.view(B, C, chunk)[:, :, :keep].reshape(B, C * keep)
                        for x in s))
