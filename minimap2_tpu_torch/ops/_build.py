"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file has a plain C interface.  At first use each
source is compiled by its own ``nvcc`` process (all started together) and
the objects are linked into one shared library under
``build/minimap2_tpu_torch/`` at the repository root, named by a hash of
the sources; ctypes loads it.  Nothing is built at import time: the CPU
path never needs a compiler.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "minimap2_tpu_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# --fmad=false: no multiply-add contraction anywhere (the chain penalty's
# truncation must round each float op on its own, as the reference does)
NVCC_FLAGS = [ARCH, "-O3", "-std=c++17", "--fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC"]

# launches per kernel, counted by the wrappers where they launch
launches: Counter = Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "mm2_sketch": [_P] * 7 + [_I] * 4 + [_P],
    "mm2_sketch_occupancy": [_I, _I, _P],
    "mm2_sort3_ex": [_P] * 6 + [_I] * 5 + [_P],
    "mm2_sort3_occupancy": [_I, _P],
    "mm2_sort1": [_P, _P, _I, _I, _P],
    "mm2_sort1_occupancy": [_I, _P],
    "mm2_chain": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "mm2_chain_occupancy": [_I, _P],
    "mm2_chain_max_window": [_P],
    "mm2_extd2": [_P] * 7 + [_I] * 21 + [_P],
    "mm2_extd2_plan": [_I, _I, _I, _I, _P],
    "mm2_extd2_occupancy": [_I, _I, _I, _I, _P],
    "mm2_exts2": [_P] * 9 + [_I] * 18 + [_P],
    "mm2_exts2_plan": [_I, _I, _I, _I, _P],
    "mm2_exts2_occupancy": [_I, _I, _I, _I, _P],
    "mm2_traceback": [_P, _P, _P, _P] + [_I] * 7 + [_P],
    "mm2_traceback_occupancy": [_I, _P],
}

_lib = None
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def lib():
    """The loaded kernel library, built on first call."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    srcs = sources()
    h = hashlib.sha256()
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libmm2kernels-{h.hexdigest()[:16]}.so"
    if not so.exists():
        t0 = time.time()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for s in srcs:
            obj = BUILD_DIR / f"{s.stem}-{os.getpid()}.o"
            procs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for (obj, pr), s in zip(procs, srcs):
            out = pr.communicate()[0].decode(errors="replace")
            logs.append(f"== {s.name}\n{out}")
            if pr.returncode != 0:
                failed.append(s.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, ARCH, "-shared", "-o", str(tmp),
                               *[str(o) for o, _ in procs]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for o, _ in procs:
            o.unlink(missing_ok=True)
        if link.returncode != 0:
            raise RuntimeError("link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp, so)
        build_seconds = time.time() - t0
    _lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(_lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_cuda(name: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def blocks_per_sm(kernel: str, *args: int) -> int:
    """Blocks of a kernel one SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, through the kernel's
    ``mm2_<kernel>_occupancy``), on the route the arguments take: extd2
    and exts2 at widths (W, QP, TP) and a mode (exact | right << 1 |
    adrop << 2, 0 for the paths' own), the traceback in a mode (splice 0
    or 1), sort3 and sort1 at a row width, the sketch at (L, w), the chain
    at a window."""
    name = f"mm2_{kernel}_occupancy"
    n = (ctypes.c_int * 2)()
    check(getattr(lib(), name)(*args, n), name)
    return n[0]


ROUTES = ("reg", "reg_gp", "slab")


@functools.lru_cache(maxsize=None)
def dp_plan(kernel: str, W: int, QP: int, TP: int, mode: int) -> dict:
    """The launch plan of extd2 or exts2 at widths (W, QP, TP) in a mode
    (exact | right << 1 | adrop << 2) on this card: its route (``reg``:
    the job's lanes in registers, its planes staged in shared memory;
    ``reg_gp``: the planes read from device memory; ``slab``: the rows in
    device memory, walked a group of lanes at a time), threads a block,
    dynamic shared memory, device-memory scratch a job (bytes) and blocks
    an SM holds at once.  Cached: it depends on the shapes and the card
    alone (the wrappers ask it on every launch)."""
    name = f"mm2_{kernel}_plan"
    out = (ctypes.c_longlong * 5)()
    check(getattr(lib(), name)(W, QP, TP, mode, out), name)
    return dict(route=ROUTES[out[0]], threads=out[1], smem=out[2],
                scratch=out[3], blocks_per_sm=out[4])


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
