#!/usr/bin/env python3
"""Short check of the port's 3-plane sort kernel on one NVIDIA GPU:

    python3 scripts/torch_sort3_check.py [--variant SRC[:NAME=VAL,...]]

Builds the kernels and checks ``sort3_rows`` bit-equal to
``sort3_rows_plain`` at every power-of-two width from 2 to 16,384 (4 rows
each), ``sort3_chunked`` at 1, 2, 4 and 8 pieces a row on 3 rows, then
at the main path's shapes (seed 3, the planes of
``chip_smoke.py``'s phase 7): the anchor sort at 512 x 4096 (half the
lanes all-ones sentinels) and the minimizer compaction ``sort3_chunked``
at 512 x 16384 (2 lanes in 11 live, the rest 0x7FFFFFFF), the latter
against the plain version applied twice with the keep cut.  Prints the
kernel's blocks per SM at 2048, 4096 and 8192 lanes and its times (CUDA
events, median) beside a 3-pass stable ``torch.sort``: rows, the chunked
sort, and its two launches alone.  Each ``--variant`` is another source
of the kernel (for example the parent commit's ``sort3.cu``, put under
``build/``, or an edited copy there), built by nvcc with the given -D
macros into ``build/``; it is checked and timed on the same planes, in
turns with the package's kernel (package, variants, variants reversed,
package).  A source with ``mm2_sort3`` instead of ``mm2_sort3_ex`` (the
parent's) runs the chunked sort as two launches with a slice copy
between them, as the parent's wrapper did.  Exits non-zero without a
card or on a mismatch.
"""
import argparse
import ctypes
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import cuda_ms, library_sort3  # noqa: E402
from minimap2_tpu_torch.ops import _build, sort  # noqa: E402
from torch_traceback_check import build_variant  # noqa: E402

CHUNK, KEEP = 2048, 1024
# the parent's entry point: (k1, k2, k3, o1, o2, o3, B, A, stream)
PARENT_SORT3 = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def planes(rng, B, A, sentinel, density):
    k1 = np.where(rng.random((B, A)) < density,
                  rng.integers(0, 1 << 31, (B, A)), sentinel)
    k2 = rng.integers(0, 1 << 32, (B, A), dtype=np.uint64)
    k3 = rng.integers(0, 1 << 32, (B, A), dtype=np.uint64)
    return [torch.from_numpy(x.astype(np.uint32).view(np.int32)).cuda()
            for x in (k1, k2, k3)]


def chunked_plain(k):
    B = k[0].shape[0]
    s = sort.sort3_rows_plain(*(x.reshape(-1, CHUNK) for x in k))
    return sort.sort3_rows_plain(*(x.view(B, -1, CHUNK)[:, :, :KEEP]
                                   .reshape(B, -1) for x in s))


def ex_call(fn, k, rows, A, kk0, keep, flip):
    outs = [k[0].new_empty((rows, keep)) for _ in range(3)]
    _build.check(fn(*(x.data_ptr() for x in k), *(o.data_ptr() for o in outs),
                    rows, A, kk0, keep, flip, _build.stream_ptr(k[0])),
                 "mm2_sort3_ex (variant)")
    return outs


def rows_call(fns, k):
    B, A = k[0].shape
    if "mm2_sort3_ex" in fns:
        return ex_call(fns["mm2_sort3_ex"], k, B, A, 2, A, 0)
    outs = [torch.empty_like(k[0]) for _ in range(3)]
    fn = fns["mm2_sort3"]
    fn.argtypes = PARENT_SORT3
    _build.check(fn(*(x.data_ptr() for x in k), *(o.data_ptr() for o in outs),
                    B, A, _build.stream_ptr(k[0])), "mm2_sort3 (variant)")
    return outs


def chunked_call(fns, k):
    B, A = k[0].shape
    C = A // CHUNK
    pieces = [x.reshape(B * C, CHUNK) for x in k]
    if "mm2_sort3_ex" not in fns:      # the parent's two launches
        s = rows_call(fns, pieces)
        return rows_call(fns, [x.view(B, C, CHUNK)[:, :, :KEEP]
                               .reshape(B, C * KEEP) for x in s])
    for n, kk0, kept, flip, _ in sort.chunked_launches(C, CHUNK, KEEP):
        pieces = [x.view(-1, n) for x in pieces]
        pieces = ex_call(fns["mm2_sort3_ex"], pieces, pieces[0].shape[0], n,
                         kk0, kept, int(flip))
    return [x.view(B, -1) for x in pieces]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_sort3_check: no CUDA device")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    t0 = time.time()
    _build.lib()
    print(f"build {time.time() - t0:.1f}s")
    on = False
    for ln in _build.build_log.splitlines():
        if ln.startswith("=="):
            on = "sort3" in ln
        if on and ("registers" in ln or "spill" in ln):
            print("  ", ln.strip())
    variants = [build_variant(v, ["mm2_sort3", "mm2_sort3_ex"])
                for v in args.variant]
    print("blocks per SM at 2048 / 4096 / 8192 lanes: "
          + " / ".join(str(_build.blocks_per_sm("sort3", a))
                       for a in (2048, 4096, 8192)))
    rng = np.random.default_rng(3)
    ok = True
    # every width, 4 rows: all tiers, rows narrower than a warp
    A = 2
    while A <= sort.MAX_WIDTH:
        k = planes(rng, 4, A, 0xFFFFFFFF, 0.5)
        k[0][:, ::3] = 7                       # duplicate triples
        k[1][:, ::3] = 9
        k[2][:, ::3] = 11
        want = sort.sort3_rows_plain(*k)
        same = all(torch.equal(g, w) for g, w in
                   zip(sort.sort3_rows(*k), want))
        for label, fns in variants:
            same = same and all(torch.equal(g, w) for g, w in
                                zip(rows_call(fns, k), want))
        if not same:
            print(f"width {A}: a kernel differs from the plain version")
        ok = ok and same
        A *= 2
    print(f"every width 2..{sort.MAX_WIDTH}: bit-equal {ok}")
    # sort3_chunked at 1, 2, 4 and 8 pieces a row on an odd row count
    crng = np.random.default_rng(5)
    for C in (1, 2, 4, 8):
        k = planes(crng, 3, C * CHUNK, 0x7FFFFFFF, 0.4)
        same = all(torch.equal(g, w) for g, w in
                   zip(sort.sort3_chunked(*k), chunked_plain(k)))
        print(f"chunked 3x{C * CHUNK} ({C} pieces a row): bit-equal {same}")
        ok = ok and same

    s_args = planes(rng, 512, 4096, 0xFFFFFFFF, 0.5)
    c_args = planes(rng, 512, 16384, 0x7FFFFFFF, 2 / 11)
    want_r = sort.sort3_rows_plain(*s_args)
    want_c = chunked_plain(c_args)
    cases = [("rows 512x4096", s_args, want_r, sort.sort3_rows, rows_call),
             ("chunked 512x16384", c_args, want_c, sort.sort3_chunked,
              chunked_call)]
    for tag, k, want, pkg, var in cases:
        calls = [("package", lambda k=k, pkg=pkg: pkg(*k))]
        calls += [(label, lambda k=k, fns=fns, var=var: var(fns, k))
                  for label, fns in variants]
        for label, call in calls:
            same = all(torch.equal(g, w) for g, w in zip(call(), want))
            print(f"[{tag}] {label}: bit-equal to the plain version {same}")
            ok = ok and same
        times = {label: [] for label, _ in calls}
        for order in (calls, calls[::-1]):
            for label, call in order:
                times[label].append(cuda_ms(call, reps=20))
        for label, _ in calls:
            print(f"[{tag}]   {label}: {times[label][0]:.4f} / "
                  f"{times[label][1]:.4f} ms")
        print(f"[{tag}]   3-pass torch.sort: "
              f"{cuda_ms(lambda k=k: library_sort3(*k), reps=5):.4f} ms")
    # the chunked sort's two launches alone
    B, A = c_args[0].shape
    C = A // CHUNK
    fn = _build.lib().mm2_sort3_ex
    pieces = [x.reshape(B * C, CHUNK) for x in c_args]
    runs = [x.view(B, C * KEEP) for x in
            ex_call(fn, pieces, B * C, CHUNK, 2, KEEP, 1)]
    first = cuda_ms(lambda: ex_call(fn, pieces, B * C, CHUNK, 2, KEEP, 1),
                    reps=20)
    merge = cuda_ms(lambda: ex_call(fn, runs, B, C * KEEP, 2 * KEEP,
                                    C * KEEP, 0), reps=20)
    print(f"[chunked 512x16384]   package's launches: first level "
          f"({B * C} x {CHUNK}, keep {KEEP}) {first:.4f} ms, merge "
          f"({B} x {C * KEEP}) {merge:.4f} ms")
    if not ok:
        raise SystemExit("torch_sort3_check: a kernel and the plain version "
                         "differ")


if __name__ == "__main__":
    main()
