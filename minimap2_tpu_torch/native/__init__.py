"""ctypes binding of the host scans the --batch -c/-a path runs per
alignment (host_scans.cpp: the Kadane trim of a forced global CIGAR, the
z-drop scan and the mm_update_extra statistics).

The library is built with g++ at first use into
``build/minimap2_tpu_torch/`` at the repository root, named by a hash of
the source and the flags (those of minimap2_tpu.native, so both packages
compute the same floats).  Without g++ this raises: the port has no other
route for these scans.
"""
from __future__ import annotations

import ctypes as C
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "host_scans.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "--param",
             "vect-max-version-for-alias-checks=40"]

_lib = None


def lib():
    """The loaded host-scan library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    so = BUILD_DIR / f"libmm2host-{h.hexdigest()[:16]}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the -c/-a path's host scans "
                               "(native/host_scans.cpp) need a C++ compiler")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{res.stderr}")
        os.replace(tmp, so)
    lb = C.CDLL(str(so))
    P, I, I64 = C.c_void_p, C.c_int, C.c_int64
    lb.mm_zdrop_scan.argtypes = [P, P, P, I64, P, I, I, I, P]
    lb.mm_update_extra_scan.argtypes = [P, P, P, I64, P, I, I, I, I, P]
    lb.mm_cigar_kadane_trim.argtypes = [P, P, P, I64, P, I, I, I, I, I, I,
                                        P, P]
    for fn in (lb.mm_zdrop_scan, lb.mm_update_extra_scan,
               lb.mm_cigar_kadane_trim):
        fn.restype = None
    _lib = lb
    return lb


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(C.c_void_p)


def _args(qseq, tseq, cigar, mat):
    return (np.ascontiguousarray(qseq, dtype=np.uint8),
            np.ascontiguousarray(tseq, dtype=np.uint8),
            np.ascontiguousarray(cigar, dtype=np.uint32),
            np.ascontiguousarray(mat, dtype=np.int8))


def cigar_kadane_trim(qseq, tseq, cigar, mat, m, q, e, q2, e2,
                      end_bonus=0):
    """Max-scoring sub-path trim of a forced global cigar.
    Returns (q0, t0, q1, t1, best_score, trimmed_cigar list)."""
    qs, ts, cig, mt = _args(qseq, tseq, cigar, mat)
    out = np.zeros(8, np.int64)
    cout = np.empty(len(cig) + 2, np.uint32)
    lib().mm_cigar_kadane_trim(_ptr(qs), _ptr(ts), _ptr(cig), len(cig),
                               _ptr(mt), m, q, e, q2, e2, end_bonus,
                               _ptr(cout), _ptr(out))
    return (int(out[0]), int(out[1]), int(out[2]), int(out[3]),
            int(out[4]), cout[:int(out[5])].tolist())


def zdrop_scan(qseq, tseq, cigar, mat, m, q, e):
    """mm_test_zdrop's scan -> (max_zdrop, [[i0, i1], [j0, j1]])."""
    qs, ts, cig, mt = _args(qseq, tseq, cigar, mat)
    out = np.empty(5, np.int64)
    lib().mm_zdrop_scan(_ptr(qs), _ptr(ts), _ptr(cig), len(cig), _ptr(mt),
                        m, q, e, _ptr(out))
    return int(out[0]), [[int(out[1]), int(out[2])],
                         [int(out[3]), int(out[4])]]


def update_extra_scan(qseq, tseq, cigar, mat, m, q, e, log_gap):
    """mm_update_extra's statistics -> (blen, mlen, n_ambi, dp_max,
    is_spliced)."""
    qs, ts, cig, mt = _args(qseq, tseq, cigar, mat)
    out = np.empty(5, np.int64)
    lib().mm_update_extra_scan(_ptr(qs), _ptr(ts), _ptr(cig), len(cig),
                               _ptr(mt), m, q, e, int(log_gap), _ptr(out))
    return (int(out[0]), int(out[1]), int(out[2]), int(out[3]),
            bool(out[4]))
