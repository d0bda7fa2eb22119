"""JAX's default PRNG (threefry 2x32), bit for bit, in torch integer ops.

The JAX package's device genome (utils/simgenome_dev.py) draws every base
from ``jax.random``.  This module reproduces the part of it that the
generator uses -- ``PRNGKey``, ``split``, ``fold_in``, ``randint`` (int32
and uint8, scalar or array bounds) and ``uniform`` (float32, with bounds)
-- as JAX 0.9 computes them with ``jax_threefry_partitionable`` on (its
default): a draw of shape S hashes the 64-bit iota over S, split as
(hi, lo) u32 counters, and 32-bit draws are the XOR of the two output
words (jax/_src/prng.py: threefry_2x32, _threefry_split_foldlike,
_threefry_fold_in, _threefry_random_bits_partitionable; jax/_src/
random.py: _uniform, _randint).

A key is a pair of Python ints (the two u32 words of a JAX raw key);
keys are derived on the host.  Draws are tensors on any device: u32
arithmetic runs on int64 tensors masked to 32 bits, so the CPU and the
card give the same bytes.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 with 20 rounds on counter words x0, x1 (Python ints
    or int64 tensors holding u32 values).  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    if isinstance(x1, int):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = (x0 + x1) & M32
                x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]) & M32
            x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
        return x0, x1
    # the same rounds in place (genome-scale draws).  Only x0's low word
    # is ever read (by the add and the XOR into x1), so x0 is masked once
    # at the end; it stays below 2^38.
    x0 = x0.expand_as(x1).clone() if torch.is_tensor(x0) \
        else torch.full_like(x1, x0)
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=t)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x0) \
                .bitwise_and_(M32)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(M32)
    return x0.bitwise_and_(M32), x1


def PRNGKey(seed: int):
    """jax.random.PRNGKey(seed) for 0 <= seed < 2^32."""
    return (seed >> 32) & M32, seed & M32


def split(key, num: int = 2):
    """jax.random.split(key, num) -> list of num keys."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def fold_in(key, data: int):
    """jax.random.fold_in(key, data), data a u32 value."""
    return threefry2x32(key[0], key[1], 0, data & M32)


def random_bits32(key, shape, device="cpu", at=None) -> torch.Tensor:
    """32 random bits a position of a ``shape`` draw, as int64 values in
    [0, 2^32); with ``at`` (int64 flat positions, any shape) only those
    positions' bits.  Hashed in slices of counters: on the CPU small
    enough for the ~130 passes of the rounds to stay in cache, on a card
    large enough to keep launches few and the temporaries bounded."""
    dev = torch.device(device)
    n = math.prod(shape) if at is None else at.numel()
    step = 1 << (18 if dev.type == "cpu" else 26)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    for s in range(0, n, step):
        cnt = torch.arange(s, min(n, s + step), dtype=torch.int64,
                           device=dev) if at is None \
            else at.reshape(-1)[s:s + step]
        b1, b2 = threefry2x32(key[0], key[1], cnt >> 32, cnt & M32)
        torch.bitwise_xor(b1, b2, out=out[s:s + cnt.shape[0]])
    return out.reshape(tuple(shape) if at is None else at.shape)


def uniform(key, shape, minval=0.0, maxval=1.0, device="cpu", at=None):
    """jax.random.uniform(key, shape, float32, minval, maxval) (at: see
    random_bits32)."""
    bits = random_bits32(key, shape, device, at)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, _fma32(floats, hi - lo, lo))


def _fma32(a, b, c):
    """a * b + c on float32 tensors with one rounding, as XLA's CPU backend
    computes ``floats * (maxval - minval) + minval`` (a fused multiply-add).
    The product is exact in float64; the float64 sum is nudged one step
    toward the exact value where it would round to float32 from a tie."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)              # exact residual (TwoSum)
    tie = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(tie & (err != 0), torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def randint(key, shape, minval, maxval, dtype=torch.int32, device="cpu",
            at=None):
    """jax.random.randint(key, shape, minval, maxval, dtype) for dtype
    int32 or uint8 (sampled as int32, as JAX samples narrow types): two
    32-bit draws folded into [minval, maxval) by the span multiplier (at:
    see random_bits32)."""
    lo = torch.as_tensor(minval, dtype=torch.int64, device=device)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=device)
    if dtype == torch.uint8:
        lo, hi = lo.clamp(0, 255), hi.clamp(0, 256)
    elif dtype != torch.int32:
        raise ValueError(f"randint: dtype {dtype} (int32 or uint8)")
    lo = lo.clamp(-(1 << 31), (1 << 31) - 1)
    hi = hi.clamp(-(1 << 31), (1 << 31) - 1)
    k1, k2 = split(key)
    higher = random_bits32(k1, shape, device, at)
    lower = random_bits32(k2, shape, device, at)
    span = torch.where(hi <= lo, 1, (hi - lo) & M32)
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span       # u32 product, wrapping
    off = ((((higher % span) * mult) & M32) + lower % span) & M32
    off = off % span
    val = (lo + off) & M32                     # int32 add, wrapping
    val = torch.where(val >= (1 << 31), val - (1 << 32), val)
    return val.to(torch.int32).to(dtype)


def randint_scalar(key, minval: int, maxval: int) -> int:
    """randint(key, (), minval, maxval, int32) as a Python int, computed
    on the host."""
    k1, k2 = split(key)
    higher, lower = (a ^ b for a, b in (threefry2x32(*k, 0, 0)
                                       for k in (k1, k2)))
    span = 1 if maxval <= minval else (maxval - minval) & M32
    mult = ((((1 << 16) % span) ** 2) & M32) % span
    off = ((((higher % span) * mult) & M32) + lower % span) & M32
    val = (minval + off % span) & M32
    return val - (1 << 32) if val >= (1 << 31) else val
