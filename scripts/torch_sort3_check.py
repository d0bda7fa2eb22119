#!/usr/bin/env python3
"""Short check of the port's sort kernels (csrc/sort3.cu, csrc/sort1.cu) on
one NVIDIA GPU:

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
sort, and its two launches alone.  Then ``sort1_rows``: bit-equal to
``sort1_rows_plain`` at every power-of-two width from 2 to 32,768 on 4
rows of full-range u32, and at 512 x 16384 on the HPC route's run-end
keys (``hpc_compact``'s, of random codes and read lengths 8,000-11,000),
where it is also held against ``torch.sort`` (unsigned order) and timed
beside it; blocks per SM at 16384 and 32768 lanes.  Each ``--variant`` is
another source of a kernel (for example a parent commit's ``sort3.cu``
or ``sort1.cu``, put under ``build/``, or an edited copy there), built
by nvcc with the given -D macros into ``build/``; it is
checked and timed on the same inputs, in turns with the package's
kernel (package, variants, variants reversed, package), in the parts
whose entry points it has (``mm2_sort3`` / ``mm2_sort3_ex``,
``mm2_sort1``).  A source with ``mm2_sort3`` instead of
``mm2_sort3_ex`` (an earlier version's) runs the chunked sort as two
launches with a slice copy between them, as its wrapper did.
Exits non-zero without a card or on a mismatch.
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

from chip_smoke import cuda_ms, library_sort3, ptxas_usage  # noqa: E402
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
    for src in ("sort3.cu", "sort1.cu"):
        for ln in ptxas_usage(src):
            print(f"   {src}: {ln}")
    built = [build_variant(v, ["mm2_sort3", "mm2_sort3_ex", "mm2_sort1",
                               "mm2_sort1_occupancy"])
             for v in args.variant]
    variants = [(label, fns) for label, fns in built
                if "mm2_sort3" in fns or "mm2_sort3_ex" in fns]
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
    ok = check_sort1([(label, fns) for label, fns in built
                      if "mm2_sort1" in fns]) and ok
    if not ok:
        raise SystemExit("torch_sort3_check: a kernel and the plain version "
                         "differ")


def sort1_call(fn, k):
    out = torch.empty_like(k)
    _build.check(fn(k.data_ptr(), out.data_ptr(), *k.shape,
                    _build.stream_ptr(k)), "mm2_sort1 (variant)")
    return out


def hpc_keys(rng, B, L):
    """hpc_compact's run-end keys: a lane's position where a homopolymer
    run ends inside the read, else 0x7FFFFFFF."""
    codes = torch.from_numpy(rng.integers(0, 4, (B, L))).cuda()
    lens = torch.from_numpy(rng.integers(8000, 11001, (B, 1))).cuda()
    pos = torch.arange(L, device="cuda")[None, :]
    nxt = torch.cat([codes[:, 1:], codes.new_full((B, 1), 4)], dim=1)
    end = (pos < lens) & ((codes != nxt) | (pos == lens - 1))
    return torch.where(end, pos, 0x7FFFFFFF).to(torch.int32)


def check_sort1(variants):
    """sort1_rows (and each variant with mm2_sort1) against the plain
    version; times at 512 x 16384 on run-end keys."""
    print("sort1 blocks per SM at 16384 / 32768 lanes: "
          + " / ".join(str(_build.blocks_per_sm("sort1", a))
                       for a in (16384, 32768)))
    for label, fns in variants:
        if "mm2_sort1_occupancy" in fns:
            n = ctypes.c_int(0)
            _build.check(fns["mm2_sort1_occupancy"](16384, ctypes.byref(n)),
                         "mm2_sort1_occupancy (variant)")
            print(f"  [{label}] blocks per SM at 16384 lanes: {n.value}")
    rng = np.random.default_rng(9)
    ok = True
    A = 2
    while A <= sort.SORT1_MAX_WIDTH:
        k = torch.from_numpy(rng.integers(0, 1 << 32, (4, A), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).cuda()
        want = sort.sort1_rows_plain(k)
        same = torch.equal(sort.sort1_rows(k), want)
        for label, fns in variants:
            same = same and torch.equal(sort1_call(fns["mm2_sort1"], k), want)
        if not same:
            print(f"sort1 width {A}: a kernel differs from the plain version")
        ok = ok and same
        A *= 2
    print(f"sort1 every width 2..{sort.SORT1_MAX_WIDTH}: bit-equal {ok}")
    k = hpc_keys(rng, 512, 16384)
    want = sort.sort1_rows_plain(k)
    lib = torch.sort(k.to(torch.int64) & 0xFFFFFFFF, dim=1).values
    calls = [("package", lambda: sort.sort1_rows(k))]
    calls += [(label, lambda fn=fns["mm2_sort1"]: sort1_call(fn, k))
              for label, fns in variants]
    for label, call in calls:
        got = call()
        same = torch.equal(got, want) and torch.equal(
            got.to(torch.int64) & 0xFFFFFFFF, lib)
        print(f"[sort1 512x16384] {label}: bit-equal to the plain version "
              f"and torch.sort {same}")
        ok = ok and same
    times = {label: [] for label, _ in calls}
    for order in (calls, calls[::-1]):
        for label, call in order:
            times[label].append(cuda_ms(call, reps=20))
    for label, _ in calls:
        print(f"[sort1 512x16384]   {label}: {times[label][0]:.4f} / "
              f"{times[label][1]:.4f} ms")
    print(f"[sort1 512x16384]   torch.sort: "
          f"{cuda_ms(lambda: torch.sort(k, dim=1), reps=5):.4f} ms")
    return ok


if __name__ == "__main__":
    main()
