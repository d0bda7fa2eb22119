"""Row-wise bitonic sorts: CUDA kernels and their plain versions.

Counterparts of minimap2_tpu.ops.sort_pallas.sort3_rows (sort_pallas.py:
22-73), sort3_chunked (:76-97) and sort1_rows (:120-138, kernel
``_sort1_kernel`` :100): each row is sorted ascending by the lexicographic
(k1, k2, k3) u32 triple, or by one u32 plane.  The planes are int32
tensors holding u32 bit patterns.  Every plane takes part in the key, so
any correct sort gives the same planes; the plain versions run the same
bitonic network (partner = i ^ j) in torch.

``sort3_rows``, ``sort3_chunked`` and ``sort1_rows`` launch their kernels
(csrc/sort3.cu, csrc/sort1.cu) for CUDA tensors and run
``sort3_rows_plain`` / ``sort1_rows_plain`` for CPU tensors.
``sort1_ascending`` takes the compaction's keys past SORT1_MAX_WIDTH
lanes: one sort1 launch over row chunks, then a scatter.  ``sort3_wide``
sorts three planes of any width by three stable ``torch.sort`` passes:
the counterpart of the JAX step's ``lax.sort`` (XLA's sort, not a Pallas
kernel), which takes the rows that sort3's shared memory cannot hold.
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


def sort3_wide(k1, k2, k3, counter: str = "sort3_wide"):
    """Row-wise ascending lexicographic sort of three u32 planes (int32
    bit patterns, (B, A), any A): three stable sorts, last key first, each
    key widened to int64 as its u32 value so that the all-ones sentinel
    sorts last.  The same planes as sort3_rows_plain.  On the card the call
    is counted under ``counter``; it launches PyTorch's sort, as the JAX
    step leaves these rows to XLA's."""
    perm = None
    for k in (k3, k2, k1):
        key = k.to(torch.int64) & 0xFFFFFFFF
        if perm is not None:
            key = key.gather(1, perm)
        idx = torch.sort(key, dim=1, stable=True).indices
        perm = idx if perm is None else perm.gather(1, idx)
    if k1.device.type == "cuda":
        _build.launches[counter] += 1
    return tuple(k.gather(1, perm) for k in (k1, k2, k3))


def sort1_rows(k1):
    """Row-wise ascending sort of one u32 plane (int32 bit pattern, shape
    (B, A), A a power of two): the HPC run-end compaction."""
    B, A = k1.shape
    if A & (A - 1) or A < 2:
        raise ValueError(f"sort1_rows: width {A} is not a power of two")
    if k1.device.type == "cpu":
        return sort1_rows_plain(k1)
    return _launch_sort1(k1, "sort1")


def _launch_sort1(k1, counter):
    """mm2_sort1 on a (rows, A) CUDA plane, counted under ``counter``."""
    B, A = k1.shape
    _build.require_cuda("sort1_rows", k1)
    if k1.dtype != torch.int32:
        raise ValueError("sort1_rows: one (B, A) int32 plane")
    if A > SORT1_MAX_WIDTH:
        raise ValueError(f"sort1_rows: width {A} > {SORT1_MAX_WIDTH}")
    if k1.data_ptr() % 16:       # the kernel loads 16-byte pieces
        k1 = k1.clone()
    out = torch.empty_like(k1)
    err = _build.lib().mm2_sort1(k1.data_ptr(), out.data_ptr(), B, A,
                                 _build.stream_ptr(k1))
    _build.check(err, "mm2_sort1")
    _build.launches[counter] += 1
    return out


KEY_NONE = 0x7FFFFFFF     # a compaction key's empty lane


def sort1_ascending(k1, keep: int | None = None):
    """sort1_rows for the compaction's keys at any power-of-two width:
    each row's keys other than KEY_NONE already ascend along the row, and
    every other lane holds KEY_NONE, so sorting a row compacts it.  Up to
    SORT1_MAX_WIDTH lanes this is sort1_rows.  Wider rows are cut into
    SORT1_MAX_WIDTH-lane chunks, all compacted by one sort1 launch (counted
    as ``sort1_chunked``; the plain version on the CPU), and each chunk's
    live prefix is scattered after the prefixes of the chunks before it
    (a cumsum of their counts): the result equals sort1_rows_plain at full
    width.  Returns the first ``keep`` lanes (default all)."""
    B, A = k1.shape
    keep = A if keep is None else keep
    if A <= SORT1_MAX_WIDTH:
        return sort1_rows(k1)[:, :keep]
    if A & (A - 1):
        raise ValueError(f"sort1_ascending: width {A} is not a power of two")
    W = SORT1_MAX_WIDTH
    pieces = k1.reshape(B * (A // W), W)
    if k1.device.type == "cpu":
        s = sort1_rows_plain(pieces)
    else:
        s = _launch_sort1(pieces.contiguous(), "sort1_chunked")
    s = s.view(B, A // W, W)
    n = (s != KEY_NONE).sum(-1, keepdim=True)                 # (B, C, 1)
    lane = torch.arange(W, device=k1.device)
    # a live lane goes after the chunks before it; the rest, and lanes
    # past keep, to a spare column
    dest = torch.where(lane < n, torch.clamp(torch.cumsum(n, 1) - n + lane,
                                             max=keep), keep)
    out = s.new_full((B, keep + 1), KEY_NONE)
    out.scatter_(1, dest.view(B, A), s.view(B, A))
    return out[:, :keep]


def _sort3_planes(name, k1, k2, k3, A):
    """Check three (rows, A) CUDA planes; clone any whose data is not
    16-byte aligned (the kernel loads 16-byte pieces)."""
    rows = k1.shape[0]
    _build.require_cuda(name, k1, k2, k3)
    if any(x.dtype != torch.int32 or x.shape != (rows, A)
           for x in (k1, k2, k3)):
        raise ValueError(f"{name}: three (B, A) int32 planes")
    if A > MAX_WIDTH:
        raise ValueError(f"{name}: width {A} > {MAX_WIDTH}")
    return [x if x.data_ptr() % 16 == 0 else x.clone()
            for x in (k1, k2, k3)]


def _launch_sort3(planes, rows, A, kk0, keep, flip, counter):
    """mm2_sort3_ex: phases kk0 .. A of the network on each row, the first
    ``keep`` lanes of row r stored as row r of the (rows, keep) result,
    odd rows reversed when flip."""
    outs = [planes[0].new_empty((rows, keep)) for _ in range(3)]
    err = _build.lib().mm2_sort3_ex(
        *(x.data_ptr() for x in planes), *(o.data_ptr() for o in outs),
        rows, A, kk0, keep, int(flip), _build.stream_ptr(planes[0]))
    _build.check(err, "mm2_sort3_ex")
    _build.launches[counter] += 1
    return outs


def sort3_rows(k1, k2, k3, counter: str = "sort3"):
    """Row-wise ascending lexicographic sort of three u32 planes
    (int32 bit patterns, shape (B, A), A a power of two); a launch is
    counted under ``counter`` (the sharded step's merge counts its own)."""
    B, A = k1.shape
    if A & (A - 1) or A < 2:
        raise ValueError(f"sort3_rows: width {A} is not a power of two")
    if k1.device.type == "cpu":
        return sort3_rows_plain(k1, k2, k3)
    planes = _sort3_planes("sort3_rows", k1, k2, k3, A)
    return tuple(_launch_sort3(planes, B, A, 2, A, False, counter))


def sort3_chunked(k1, k2, k3, chunk: int = 2048, keep: int = 1024):
    """Two-level sort for wide rows, as sort_pallas.sort3_chunked: sort
    ``chunk``-lane pieces, then sort the concatenation of each piece's
    first ``keep`` lanes.  Exact while no chunk holds more than ``keep``
    live keys; that cut is the reference's and is kept.

    On the card the first launch stores each piece's first ``keep`` lanes
    straight into the (B, C*keep) input of the second, odd pieces
    reversed; the second launch (``sort3_merge``) then runs only the
    network's merge phases.  With one piece a row (C = 1) the first
    launch's rows are the result."""
    B, A = k1.shape
    if A % chunk or keep > chunk:
        raise ValueError(f"sort3_chunked: width {A}, chunk {chunk}")
    C = A // chunk
    if k1.device.type == "cpu":
        s = sort3_rows(*(x.reshape(B * C, chunk) for x in (k1, k2, k3)))
        return sort3_rows(*(x.view(B, C, chunk)[:, :, :keep]
                            .reshape(B, C * keep) for x in s))
    W = C * keep
    for n in (chunk, W):
        if n & (n - 1) or n < 2:
            raise ValueError(f"sort3_rows: width {n} is not a power of two")
        if n > MAX_WIDTH:
            raise ValueError(f"sort3_rows: width {n} > {MAX_WIDTH}")
    planes = _sort3_planes("sort3_rows", *(x.reshape(B * C, chunk)
                                           for x in (k1, k2, k3)), chunk)
    for n, kk0, kept, flip, counter in chunked_launches(C, chunk, keep):
        planes = [x.view(-1, n) for x in planes]
        planes = _launch_sort3(planes, planes[0].shape[0], n, kk0, kept,
                               flip, counter)
    return tuple(x.view(B, W) for x in planes)


def chunked_launches(C, chunk, keep):
    """sort3_chunked's launches on the card for C pieces a row, each as
    (width, kk0, keep, flip, counter) of ``_launch_sort3``.  Row r of the
    first launch is piece r % C of row r // C, so reversing its odd rows
    reverses the odd pieces only when C is even (C is a power of two);
    with one piece a row the first launch's rows are the result."""
    first = (chunk, 2, keep, C > 1, "sort3")
    if C == 1:
        return [first]
    return [first, (C * keep, 2 * keep, C * keep, False, "sort3_merge")]
