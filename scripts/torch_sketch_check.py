#!/usr/bin/env python3
"""Short check of the port's sketch kernel on one NVIDIA GPU:

    python3 scripts/torch_sketch_check.py [--variant SRC[:NAME=VAL,...]]

Builds the kernels, makes 512 random reads of nt4 codes with 2,048 N runs
of 1-49 bases and lengths of 8,192-16,384 (seed 3, the reads of
``chip_smoke.py``'s phase 7), and checks ``sketch_batch`` bit-equal to
``device_sketch`` at every position, invalid ones included, at the three
settings of the main paths: (k, w) = (15, 10) at 512 x 16384 (map-ont),
(19, 10) at 512 x 16384 (map-pb, on HPC-compacted codes) and (15, 5) at
512 x 12288 (splice); then at the edge (28, 98) on 16 rows of 1,000
positions (L not a multiple of 16).  Prints the kernel's blocks per SM
and its time (CUDA events, median) at each main setting.  Each
``--variant`` is another source of the kernel (for example the parent
commit's ``sketch.cu``, put under ``build/``, or an edited copy there),
built by nvcc with the given -D macros into ``build/``; it is checked
and timed on the same reads, in turns with the package's kernel
(package, variants, variants reversed, package).  Exits non-zero without
a card or on a mismatch.
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
from minimap2_tpu_torch.ops import _build, sketch  # noqa: E402
from minimap2_tpu_torch.parallel.batch import hpc_compact  # noqa: E402
from torch_traceback_check import build_variant  # noqa: E402


def reads(rng, B, L):
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for _ in range(4 * B):
        b, st = int(rng.integers(0, B)), int(rng.integers(0, L - 60))
        codes[b, st:st + int(rng.integers(1, 50))] = 4
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    return torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda()


def variant_call(fn, codes, lens, k, w):
    B, L = codes.shape
    hhi = torch.empty((B, L), dtype=torch.int32, device=codes.device)
    hlo = torch.empty_like(hhi)
    z = torch.empty((B, L), dtype=torch.bool, device=codes.device)
    mini = torch.empty_like(z)
    _build.check(fn(codes.data_ptr(), lens.data_ptr(), hhi.data_ptr(),
                    hlo.data_ptr(), z.data_ptr(), mini.data_ptr(), B, L, k,
                    w, _build.stream_ptr(codes)), "mm2_sketch (variant)")
    return hhi, hlo, z, mini


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_sketch_check: no CUDA device")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    t0 = time.time()
    _build.lib()
    print(f"build {time.time() - t0:.1f}s")
    on = False
    for ln in _build.build_log.splitlines():
        if ln.startswith("=="):
            on = "sketch" in ln
        if on and ("registers" in ln or "spill" in ln):
            print("  ", ln.strip())
    variants = [build_variant(v, "mm2_sketch") for v in args.variant]
    rng = np.random.default_rng(3)
    ont = reads(rng, 512, 16384)
    hcodes, _, hlc = hpc_compact(*ont)
    settings = [("map-ont", ont, 15, 10), ("map-pb HPC", (hcodes, hlc), 19,
                                           10),
                ("splice", reads(rng, 512, 12288), 15, 5),
                ("edge", reads(rng, 16, 1000), 28, 98)]
    ok = True
    for tag, (codes, lens), k, w in settings:
        B, L = codes.shape
        want = sketch.device_sketch(codes, lens, k, w)
        calls = [("package", lambda c=codes, n=lens, k=k, w=w:
                  sketch.sketch_batch(c, n, k, w))]
        calls += [(label, lambda fn=fn, c=codes, n=lens, k=k, w=w:
                   variant_call(fn, c, n, k, w)) for label, fn in variants]
        for label, call in calls:
            same = all(torch.equal(g, x) for g, x in zip(call(), want))
            print(f"[{tag} k{k} w{w} {B}x{L}] {label}: bit-equal to "
                  f"device_sketch {same} ({int(want[3].sum())} minimizers)")
            ok = ok and same
        if tag == "edge":
            continue
        times = {label: [] for label, _ in calls}
        for order in (calls, calls[::-1]):
            for label, call in order:
                times[label].append(cuda_ms(call, reps=20))
        print(f"[{tag} k{k} w{w} {B}x{L}]   blocks per SM "
              f"{_build.blocks_per_sm('sketch', L, w)}")
        for label, _ in calls:
            print(f"[{tag} k{k} w{w} {B}x{L}]   {label}: "
                  f"{times[label][0]:.4f} / {times[label][1]:.4f} ms")
    if not ok:
        raise SystemExit("torch_sketch_check: a kernel and device_sketch "
                         "differ")


if __name__ == "__main__":
    main()
