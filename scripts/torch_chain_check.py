#!/usr/bin/env python3
"""Short check of the port's chain DP kernel on one NVIDIA GPU:

    python3 scripts/torch_chain_check.py [--variant SRC[:NAME=VAL,...]]

Builds the kernels, makes 512 x 4096 random sorted anchor planes (per
read 1,024-4,096 valid anchors, every eighth read all 4,096: 1-3
colinear chains of 15-base anchors 1-40 bases apart with +-30 of
reference jitter, and a quarter noise on 2 strands x 3 contigs; seed 1),
and checks the kernel bit-equal to ``chain_batch_plain`` with the
map-ont chaining parameters at both bands (500, and 20,000 for the
long-join pass).  Prints the kernel's time (CUDA events, median) at each
band, its blocks per SM, the longest read's valid-anchor count n and the
kernel's ns a step of it.  Each ``--variant`` is another source of the
chain kernel (for example the parent commit's ``chain.cu``, put under
``build/``), built by nvcc with the given -D macros into ``build/``; it
is checked and timed on the same planes, in turns with the package's
kernel (package, variants, variants reversed, package).  Exits non-zero
without a card or on a mismatch.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import cuda_ms  # noqa: E402
from minimap2_tpu_torch.ops import _build, chain  # noqa: E402
from minimap2_tpu_torch.parallel.batch import BatchParams  # noqa: E402
from torch_traceback_check import build_variant  # noqa: E402

B, A = 512, 4096


def anchor_planes(rng):
    rev = np.zeros((B, A), np.int32)
    rid = np.zeros((B, A), np.int32)
    rpos = np.zeros((B, A), np.int32)
    qpos = np.zeros((B, A), np.int32)
    span = np.full((B, A), 15, np.int32)
    av = np.zeros((B, A), bool)
    for b in range(B):
        n = A if b % 8 == 0 else int(rng.integers(A // 4, A + 1))
        cols = []
        left = n - n // 4
        for c in range(int(rng.integers(1, 4))):
            m = left if c == 2 else int(rng.integers(0, left + 1))
            left -= m
            q = np.cumsum(rng.integers(1, 41, m))
            r = int(rng.integers(0, 1 << 26)) + q + rng.integers(-30, 31, m)
            cols.append(np.stack([np.full(m, rng.integers(0, 2)),
                                  np.full(m, rng.integers(0, 3)), r, q,
                                  np.full(m, 15)], 1))
        k = n - sum(len(x) for x in cols)
        cols.append(np.stack([rng.integers(0, 2, k), rng.integers(0, 3, k),
                              rng.integers(0, 1 << 26, k),
                              rng.integers(0, 16000, k),
                              rng.integers(10, 20, k)], 1))
        rows = np.concatenate(cols)
        rows = rows[np.lexsort((rows[:, 3], rows[:, 2], rows[:, 1],
                                rows[:, 0]))]
        for x, col in zip((rev, rid, rpos, qpos, span), rows.T):
            x[b, :n] = col
        av[b, :n] = True
    return [torch.from_numpy(x).cuda() for x in
            (rev, rid, rpos, qpos, span, av)]


def variant_call(fn, planes, kw):
    outs = [torch.empty_like(planes[2]) for _ in range(4)]
    _build.check(fn(*(x.data_ptr() for x in planes),
                    *(o.data_ptr() for o in outs), B, A, kw["WND"],
                    kw["max_dist_x"], kw["max_dist_y"], kw["bw"],
                    float(np.float32(kw["chn_pen_gap"])),
                    float(np.float32(kw["chn_pen_skip"])),
                    _build.stream_ptr(planes[2])), "mm2_chain (variant)")
    return outs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_chain_check: no CUDA device")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    t0 = time.time()
    _build.lib()
    print(f"build {time.time() - t0:.1f}s")
    on = False
    for ln in _build.build_log.splitlines():
        if ln.startswith("=="):
            on = "chain" in ln
        if on and ("registers" in ln or "spill" in ln):
            print("  ", ln.strip())
    variants = [build_variant(v, "mm2_chain") for v in args.variant]
    planes = anchor_planes(np.random.default_rng(1))
    n_max = chain.last_valid(planes[5])
    print(f"{B} x {A} planes, {int(planes[5].sum())} valid anchors, longest "
          f"read n = {n_max}; {_build.blocks_per_sm('chain', 64)} blocks per SM")
    p = BatchParams()
    ok = True
    for bw in (p.bw, 20000):
        kw = dict(WND=p.chain_window, max_dist_x=max(p.max_dist_x, bw),
                  max_dist_y=max(p.max_dist_y, bw), bw=bw,
                  chn_pen_gap=p.chn_pen_gap, chn_pen_skip=p.chn_pen_skip)
        t = time.time()
        want = chain.chain_batch_plain(*planes, **kw)
        torch.cuda.synchronize()
        plain_s = time.time() - t
        calls = [("package", lambda kw=kw: chain.chain_batch(*planes, **kw))]
        calls += [(label, lambda fn=fn, kw=kw: variant_call(fn, planes, kw))
                  for label, fn in variants]
        times = {label: [] for label, _ in calls}
        for label, call in calls:
            same = all(torch.equal(g, w) for g, w in zip(call(), want))
            print(f"[bw {bw}] {label}: bit-equal to the plain version {same}"
                  f" (plain {plain_s:.1f}s)")
            ok = ok and same
        for order in (calls, calls[::-1]):
            for label, call in order:
                times[label].append(cuda_ms(call))
        for label, _ in calls:
            ms = times[label]
            print(f"[bw {bw}]   {label}: {ms[0]:.3f} / {ms[1]:.3f} ms "
                  f"({1e6 * min(ms) / n_max:.1f} ns a step of the longest "
                  f"read)")
    if not ok:
        raise SystemExit("torch_chain_check: a kernel and the plain version "
                         "differ")


if __name__ == "__main__":
    main()
