#!/usr/bin/env python3
"""Short check of the port's traceback kernel on one NVIDIA GPU:

    python3 scripts/torch_traceback_check.py [--variant SRC[:NAME=VAL,...]]

Builds the kernels, makes the direction bytes p of 576 random ONT-like
jobs at the -a path's widths (extd2, the jobs of
scripts/torch_extd2_check.py, seed 1) and of 512 random cDNA-like jobs at
the splice widths (exts2, the jobs of scripts/torch_exts2_check.py, seed
1), and checks the traceback kernel bit-equal to ``traceback_batch_plain``
on every job of both launches.  Prints, for each launch, the kernel's
time (CUDA events, median) on the whole launch and on its first 64 jobs,
its blocks per SM, the longest walk's diagonals and the kernel's ns a
diagonal of that walk.  Each ``--variant`` is another source of the
traceback (for example the parent commit's ``traceback.cu``, put under
``build/``), built by nvcc with the given -D macros into ``build/``; it
is checked and timed on the same p, in turns with the package's kernel
(package, variants, variants reversed, package).  Exits non-zero without
a card or on a mismatch.
"""
import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_extd2_check as xd  # noqa: E402
import torch_exts2_check as xs  # noqa: E402
from chip_smoke import cuda_ms, longest_walk  # noqa: E402
from minimap2_tpu_torch.ops import _build, extend, exts, traceback  # noqa


def build_variant(spec, symbol="mm2_traceback"):
    """(spec, the C entry point `symbol` of SRC built by nvcc with
    -DNAME=VAL ...) for a spec SRC[:NAME=VAL,...]; for a list of symbols,
    (spec, {symbol: entry point}) with those SRC defines (argument types
    set for the symbols the package also has)."""
    src, _, defs = spec.partition(":")
    defines = [d for d in defs.split(",") if d]
    h = hashlib.sha256(Path(src).read_bytes() + " ".join(
        defines + _build.NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _build.BUILD_DIR / f"variant-{h}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                          *(f"-D{d}" for d in defines), "-shared", "-o",
                          str(so), src], capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed on {spec}:\n{out.stdout}{out.stderr}")
    for ln in (out.stdout + out.stderr).splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"   [{spec}] {ln.strip()}")
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name in [symbol] if isinstance(symbol, str) else symbol:
        if hasattr(lib, name):
            fns[name] = getattr(lib, name)
            fns[name].argtypes = _build.SIGNATURES.get(name)
            fns[name].restype = ctypes.c_int
    return spec, fns[symbol] if isinstance(symbol, str) else fns


def variant_call(fn, p, lens, *, RB, w, splice=False, QP=0):
    N, RT, W = p.shape
    ops = torch.empty((N, RT), dtype=torch.uint8, device=p.device)
    fin = torch.empty((N, 2), dtype=torch.int32, device=p.device)
    _build.check(fn(p.data_ptr(), lens.data_ptr(), ops.data_ptr(),
                    fin.data_ptr(), N, RT, W, RB, w, int(splice), QP,
                    _build.stream_ptr(p)), "mm2_traceback (variant)")
    return ops, fin


def check_launch(tag, p, lens, variants, n_first, **kw):
    N = p.shape[0]
    ops, fin = traceback.traceback_batch(p, lens, **kw)
    t = time.time()
    ops2, fin2 = traceback.traceback_batch_plain(p, lens, **kw)
    torch.cuda.synchronize()
    plain_s = time.time() - t
    ok = torch.equal(ops, ops2) and torch.equal(fin, fin2)
    diag = longest_walk(ops)
    calls = [("package", lambda a, b: traceback.traceback_batch(a, b, **kw))]
    for label, fn in variants:
        got = variant_call(fn, p, lens, **kw)
        same = torch.equal(got[0], ops2) and torch.equal(got[1], fin2)
        print(f"[{tag}] variant {label}: bit-equal on the {N} jobs {same}")
        ok = ok and same
        calls.append((label, lambda a, b, fn=fn: variant_call(fn, a, b,
                                                              **kw)))
    del ops2
    first = (p[:n_first], lens[:n_first])
    times = {label: [] for label, _ in calls}
    firsts = {label: [] for label, _ in calls}
    for order in (calls, calls[::-1]):
        for label, call in order:
            times[label].append(cuda_ms(lambda: call(p, lens), reps=5))
            firsts[label].append(cuda_ms(lambda: call(*first), reps=5))
    mode = 1 if kw.get("splice") else 0
    print(f"[{tag}] {N} jobs, p {tuple(p.shape)}, bit-equal to the plain "
          f"version {ok} (plain {plain_s:.1f}s); longest walk {diag} "
          f"diagonals; package kernel "
          f"{_build.blocks_per_sm('traceback', mode)} blocks per SM")
    for label, _ in calls:
        ms = times[label]
        print(f"[{tag}]   {label}: {N} jobs {ms[0]:.3f} / {ms[1]:.3f} ms "
              f"({1e6 * min(ms) / max(diag, 1):.1f} ns a diagonal of the "
              f"longest walk); first {n_first} jobs {firsts[label][0]:.3f} "
              f"/ {firsts[label][1]:.3f} ms")
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_traceback_check: no CUDA device")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    t0 = time.time()
    _build.lib()
    print(f"build {time.time() - t0:.1f}s")
    on = False
    for ln in _build.build_log.splitlines():
        if ln.startswith("=="):
            on = "traceback" in ln
        if on and ("registers" in ln or "spill" in ln):
            print("  ", ln.strip())
    variants = [build_variant(v) for v in args.variant]

    # extd2 rows: the -a path's widths
    qr, sf, lens = xd.ont_jobs(np.random.default_rng(1), 576)
    jobs = [torch.from_numpy(x).cuda() for x in (qr, sf, lens)]
    R = (xd.QP + xd.TP + xd.RB - 1) // xd.RB * xd.RB
    p, _ = extend.extd2_batch2(
        *jobs, G=xd.G, W=xd.W, RB=xd.RB, R=R, QP=xd.QP, TP=xd.TP, w=xd.w,
        zdrop=-1, right_mode=False, approx_max=True, approx_drop=False,
        **xd.SC)
    ok = check_launch("extd2 rows", p, jobs[2], variants, 64, RB=xd.RB,
                      w=xd.w)
    del p, jobs
    torch.cuda.empty_cache()

    # splice rows: the CLI's splice widths, both strand rounds' worth
    QP, TP, RB = xs.QP, xs.TP, xs.RB
    W = (QP + 32 + 127) // 128 * 128
    qr, sf, lens = xs.cdna_jobs(np.random.default_rng(1), 512)
    dn, ac = exts.splice_site_arrays(sf, lens[:, 1], True, 9, True, False)
    jobs = [torch.from_numpy(x).cuda() for x in (qr, sf, dn, ac, lens)]
    p, _ = exts.exts2_batch(
        *jobs, G=xs.G, W=W, RB=RB, R=(QP + TP + RB - 1) // RB * RB, QP=QP,
        TP=TP, zdrop=-1, right_mode=False, approx_max=True,
        approx_drop=False, **xs.SC)
    ok = check_launch("splice rows", p, jobs[4], variants, 32, RB=RB, w=0,
                      splice=True, QP=QP) and ok
    if not ok:
        raise SystemExit("torch_traceback_check: a kernel and the plain "
                         "version differ")


if __name__ == "__main__":
    main()
