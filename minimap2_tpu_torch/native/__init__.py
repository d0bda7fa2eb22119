"""ctypes bindings of the port's host C++ routines.

Two sources, each built with g++ at first use into
``build/minimap2_tpu_torch/`` at the repository root and named by a hash
of the source, the flags (those of minimap2_tpu.native, so both packages
compute the same floats) and the CPU's feature flags (-march=native):

- ``host_scans.cpp``: the scans the --batch -c/-a path runs per alignment
  (the Kadane trim of a forced global CIGAR, the z-drop scan and the
  mm_update_extra statistics) and the FASTA/FASTQ buffer scanner that
  ``io.fastx.FastxReader`` reads through;
- ``host_map.cpp``: the host mapping path's sketch, anchor collection,
  chaining DPs (mg_lchain_dp, mg_lchain_rmq) and ksw2 extensions (extd2,
  extz2, exts2, ll), the device index's h2 table build, and the host
  index build's batched sketch and stable radix sort.

Without g++ this raises: the port has no other route for these routines.
``available()`` says whether the host-mapping library builds; the device
index takes its h2 layout, and the host index build its batched sketch
and radix sort, only then, as the JAX package does.
Their NumPy versions (index/sketch.py, map/seed.py, map/chain.py,
ops/ksw2_np.py, ops/ksw2_exts.py) are called by name from the tests only.
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
from ..ops.ksw2_np import ExtzResult

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "host_scans.cpp"
MAP_SRC = _HERE / "host_map.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "--param",
             "vect-max-version-for-alias-checks=40"]

_libs: dict = {}


def _cpu_flags() -> bytes:
    """The CPU's feature flags: -march=native code is valid only on a CPU
    that has them, so they go into the library's name."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def _build(src: Path, stem: str):
    h = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()
                       + _cpu_flags())
    so = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: the port's host routines "
                               f"(native/{src.name}) need a C++ compiler")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name}:\n{res.stderr}")
        os.replace(tmp, so)
    return C.CDLL(str(so))


class _EzOut(C.Structure):
    _fields_ = [(n, C.c_int32) for n in (
        "max", "zdropped", "max_q", "max_t", "mqe", "mqe_t", "mte", "mte_q",
        "score", "reach_end", "n_cigar", "pad")]


def lib():
    """The loaded host-scan library, built on first call."""
    if "scans" in _libs:
        return _libs["scans"]
    lb = _build(SRC, "libmm2host")
    P, I, I64 = C.c_void_p, C.c_int, C.c_int64
    lb.mm_zdrop_scan.argtypes = [P, P, P, I64, P, I, I, I, P]
    lb.mm_update_extra_scan.argtypes = [P, P, P, I64, P, I, I, I, I, P]
    lb.mm_cigar_kadane_trim.argtypes = [P, P, P, I64, P, I, I, I, I, I, I,
                                        P, P]
    for fn in (lb.mm_zdrop_scan, lb.mm_update_extra_scan,
               lb.mm_cigar_kadane_trim):
        fn.restype = None
    lb.mm_fastx_scan.argtypes = [P, I64, I, P, I64, P, P, I64, P]
    lb.mm_fastx_scan.restype = I64
    _libs["scans"] = lb
    return lb


def map_lib():
    """The loaded host-mapping library, built on first call."""
    if "map" in _libs:
        return _libs["map"]
    lb = _build(MAP_SRC, "libmm2hostmap")
    P, I, I64, F = C.c_void_p, C.c_int, C.c_int64, C.c_float
    EZ = C.POINTER(_EzOut)
    sigs = {
        "mm_sketch_nt4": [P, I64, I, I, C.c_uint32, I, P, P, I64],
        "mm_collect_anchors": [P, P, I64, P, P, I64, P, I64, I64, I64, I64,
                               P, P, I64, P, P, P, P, P],
        "ksw_extd2_cpp": [I, P, I, P, I, P] + [I] * 8 + [EZ, P, I64],
        "ksw_extz2_cpp": [I, P, I, P, I, P] + [I] * 6 + [EZ, P, I64],
        "ksw_exts2_cpp": [I, P, I, P, I, P] + [I] * 9 + [P, EZ, P, I64],
        "mg_lchain_dp_cpp": [I64] * 7 + [F, F, I, I, I64] + [P] * 6,
        "mg_lchain_rmq_cpp": [I64] * 7 + [F, F, I64] + [P] * 6,
        "ksw_ll_cpp": [I, P, I, P, I, P, I, I, P, P],
        "build_hash2_table": [P, P, I64, I64, I, I, I, P],
        "mm_sketch_many": [P, P, P, I64, I, I, I, P, P, I64],
    }
    for name, args in sigs.items():
        fn = getattr(lb, name)
        fn.argtypes = args
        fn.restype = I64
    lb.radix_sort_u64_pair.argtypes = [P, P, I64, I]
    lb.radix_sort_u64_pair.restype = None
    _libs["map"] = lb
    return lb


def available() -> bool:
    """Whether the host-mapping library builds and loads here (the
    counterpart of minimap2_tpu.native.available)."""
    try:
        map_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(C.c_void_p)


def fastx_scan(buf: bytes, is_final: bool):
    """Parse a FASTA/FASTQ text buffer (the kseq.h analogue of
    minimap2_tpu.native.fastx_scan).  Returns (n_records, seq_bytes
    ndarray, meta (n, 6) int64, qmeta (n, 2) int64, consumed).  meta
    columns: name_off, name_len, comment_off, comment_len, seq_off,
    seq_len; offsets of names into ``buf``, of seq/qual into seq_bytes.
    Raises ValueError on malformed input."""
    lb = lib()
    bufa = np.frombuffer(buf, np.uint8)
    rec_cap = max(64, len(buf) // 32)
    seq_cap = len(buf) + 64
    while True:
        out_seq = np.empty(seq_cap, np.uint8)
        meta = np.empty((rec_cap, 6), np.int64)
        qmeta = np.empty((rec_cap, 2), np.int64)
        consumed = np.zeros(1, np.int64)
        n = lb.mm_fastx_scan(_ptr(bufa), len(bufa), int(is_final),
                             _ptr(out_seq), seq_cap, _ptr(meta), _ptr(qmeta),
                             rec_cap, _ptr(consumed))
        if n == -1:             # a cap was exceeded: double both
            rec_cap *= 2
            seq_cap *= 2
            continue
        if n == -2:
            raise ValueError("malformed FASTA/FASTQ input")
        return int(n), out_seq, meta[:n], qmeta[:n], int(consumed[0])


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


def sketch(codes: np.ndarray, w: int, k: int, rid: int, is_hpc: bool):
    """mm_sketch over nt4 codes -> (x, y) u64 arrays (index/sketch.py's
    ``sketch`` is the plain version)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    cap = max(16, 2 * len(codes) // max(w, 1) + 64)
    while True:
        out_x = np.empty(cap, np.uint64)
        out_y = np.empty(cap, np.uint64)
        n = map_lib().mm_sketch_nt4(_ptr(codes), len(codes), w, k, rid,
                                    int(is_hpc), _ptr(out_x), _ptr(out_y),
                                    cap)
        if n <= cap:
            return out_x[:n], out_y[:n]
        cap = int(n) + 64


def sketch_many(codes: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                w: int, k: int, is_hpc: bool):
    """mm_sketch over every contig of the concatenated codes (contig r at
    offs[r], lens[r] bases, rid r) -> (x, y) u64 arrays in contig order;
    the output grows until it fits."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    cap = max(16, len(codes) + 1024)
    while True:
        out_x = np.empty(cap, np.uint64)
        out_y = np.empty(cap, np.uint64)
        n = map_lib().mm_sketch_many(_ptr(codes), _ptr(offs), _ptr(lens),
                                     len(offs), w, k, int(is_hpc),
                                     _ptr(out_x), _ptr(out_y), cap)
        if n <= cap:
            return out_x[:n], out_y[:n]
        cap = int(n) + 1024


def radix_sort_pair(keys: np.ndarray, vals: np.ndarray, key_bits: int):
    """Stable in-place LSD radix sort of (u64 key, u64 payload) pairs by
    the low key_bits of the key: equal keys keep their payloads' order."""
    if keys.dtype != np.uint64 or vals.dtype != np.uint64:
        raise TypeError("radix_sort_pair sorts uint64 keys and payloads")
    if not (keys.flags.c_contiguous and vals.flags.c_contiguous) \
            or len(keys) != len(vals):
        raise ValueError("radix_sort_pair needs contiguous arrays of one "
                         "length")
    map_lib().radix_sort_u64_pair(_ptr(keys), _ptr(vals), len(keys),
                                  key_bits)


def collect_anchors(mx, my, keys, starts, pos, qlen: int, max_occ: int,
                    max_max_occ: int, dist: int, seed_freq: bool = False):
    """Seed lookup + selection + anchor expansion + stable sort by x
    (map/seed.py's ``collect_seed_hits_np`` is the plain version).
    Returns (ax, ay, rep_len, mini_pos), and with seed_freq also the
    (n_seeds, 3) int64 rows (pos, occurrences, filtered) of the seeds that
    hit the index, in query order, for --dbg-seed-occ's SF lines."""
    mx = np.ascontiguousarray(mx, dtype=np.uint64)
    my = np.ascontiguousarray(my, dtype=np.uint64)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    pos = np.ascontiguousarray(pos, dtype=np.uint64)
    cap = max(1024, 64 * len(mx))
    rep = np.zeros(1, np.int64)
    n_mini = np.zeros(1, np.int64)
    sf = np.empty((len(mx), 3), np.int64) if seed_freq else None
    n_sf = np.zeros(1, np.int64)
    while True:
        ax = np.empty(cap, np.uint64)
        ay = np.empty(cap, np.uint64)
        minipos = np.empty(cap, np.uint64)
        n = map_lib().mm_collect_anchors(
            _ptr(mx), _ptr(my), len(mx), _ptr(keys), _ptr(starts),
            len(keys), _ptr(pos), qlen, max_occ, max_max_occ, dist,
            _ptr(ax), _ptr(ay), cap, _ptr(rep), _ptr(minipos),
            _ptr(n_mini), None if sf is None else _ptr(sf), _ptr(n_sf))
        if n < cap:
            out = (ax[:n], ay[:n], int(rep[0]), minipos[:int(n_mini[0])])
            return out if sf is None else out + (sf[:int(n_sf[0])],)
        cap *= 4


def _ez_call(fn, qlen, query, tlen, target, m, mat, mid_args, ez):
    query = np.ascontiguousarray(query, dtype=np.uint8)
    target = np.ascontiguousarray(target, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    eo = _EzOut()
    cap = 2 * (qlen + tlen) + 16
    cig = np.empty(cap, np.uint32)
    fn(qlen, _ptr(query), tlen, _ptr(target), m, _ptr(mat), *mid_args,
       C.byref(eo), _ptr(cig), cap)
    assert eo.n_cigar <= cap, "cigar overflow (truncated native buffer)"
    ez.max, ez.zdropped = eo.max, bool(eo.zdropped)
    ez.max_q, ez.max_t = eo.max_q, eo.max_t
    ez.mqe, ez.mqe_t = eo.mqe, eo.mqe_t
    ez.mte, ez.mte_q = eo.mte, eo.mte_q
    ez.score, ez.reach_end = eo.score, bool(eo.reach_end)
    ez.cigar = cig[:eo.n_cigar].tolist()
    return ez


def ksw_extd2(qlen, query, tlen, target, m, mat, q, e, q2, e2, w, zdrop,
              end_bonus, flag, ez: ExtzResult | None = None) -> ExtzResult:
    """ksw_extd2_sse (dual affine), as ops.ksw2_np.ksw_extd2."""
    if ez is None:
        ez = ExtzResult()
    ez.reset()
    if m <= 1 or qlen <= 0 or tlen <= 0:
        return ez
    return _ez_call(map_lib().ksw_extd2_cpp, qlen, query, tlen, target, m,
                    mat, (q, e, q2, e2, w, zdrop, end_bonus, flag), ez)


def ksw_extz2(qlen, query, tlen, target, m, mat, q, e, w, zdrop, end_bonus,
              flag, ez: ExtzResult | None = None) -> ExtzResult:
    """ksw_extz2_sse (single affine), as ops.ksw2_np.ksw_extz2."""
    if ez is None:
        ez = ExtzResult()
    ez.reset()
    if m <= 0 or qlen <= 0 or tlen <= 0:
        return ez
    return _ez_call(map_lib().ksw_extz2_cpp, qlen, query, tlen, target, m,
                    mat, (q, e, w, zdrop, end_bonus, flag), ez)


def ksw_exts2(qlen, query, tlen, target, m, mat, q, e, q2, noncan, zdrop,
              end_bonus, junc_bonus, junc_pen, flag, junc,
              ez: ExtzResult | None = None) -> ExtzResult:
    """ksw_exts2_sse (spliced), as ops.ksw2_exts.ksw_exts2."""
    if ez is None:
        ez = ExtzResult()
    ez.reset()
    if m <= 1 or qlen <= 0 or tlen <= 0 or q2 <= q + e:
        return ez
    jptr = None
    if junc is not None:
        junc = np.ascontiguousarray(junc, dtype=np.uint8)
        jptr = _ptr(junc)
    return _ez_call(map_lib().ksw_exts2_cpp, qlen, query, tlen, target, m,
                    mat, (q, e, q2, noncan, zdrop, end_bonus, junc_bonus,
                          junc_pen, flag, jptr), ez)


def ksw_ll(qlen, query, tlen, target, m, mat, gapo, gape):
    """Farrar local SW, score and ends -> (score, qe, te), as
    ops.ksw2_np.ksw_ll."""
    if qlen <= 0 or tlen <= 0:
        return 0, -1, -1
    query = np.ascontiguousarray(query, dtype=np.uint8)
    target = np.ascontiguousarray(target, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    qe = np.zeros(1, np.int32)
    te = np.zeros(1, np.int32)
    sc = map_lib().ksw_ll_cpp(qlen, _ptr(query), tlen, _ptr(target), m,
                              _ptr(mat), gapo, gape, _ptr(qe), _ptr(te))
    return int(sc), int(qe[0]), int(te[0])


def _chain_out(n):
    return tuple(np.empty(max(n, 1), np.uint64) for _ in range(3)) + (
        np.zeros(1, np.int64),)


def lchain_dp(max_dist_x, max_dist_y, bw, max_skip, max_iter, min_cnt,
              min_sc, chn_pen_gap, chn_pen_skip, is_cdna, n_seg, ax, ay):
    """mg_lchain_dp -> (u, new_ax, new_ay), as map/chain.py chain_dp_np."""
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    ay = np.ascontiguousarray(ay, dtype=np.uint64)
    n = len(ax)
    u, oax, oay, na = _chain_out(n)
    n_u = map_lib().mg_lchain_dp_cpp(
        max_dist_x, max_dist_y, bw, max_skip, max_iter, min_cnt, min_sc,
        float(chn_pen_gap), float(chn_pen_skip), int(is_cdna), int(n_seg),
        n, _ptr(ax), _ptr(ay), _ptr(u), _ptr(oax), _ptr(oay), _ptr(na))
    k = int(na[0])
    return u[:n_u].copy(), oax[:k].copy(), oay[:k].copy()


def lchain_rmq(max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size,
               min_cnt, min_sc, chn_pen_gap, chn_pen_skip, ax, ay):
    """mg_lchain_rmq -> (u, new_ax, new_ay), as map/chain.py
    chain_rmq_np."""
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    ay = np.ascontiguousarray(ay, dtype=np.uint64)
    n = len(ax)
    u, oax, oay, na = _chain_out(n)
    n_u = map_lib().mg_lchain_rmq_cpp(
        max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size, min_cnt,
        min_sc, float(chn_pen_gap), float(chn_pen_skip), n, _ptr(ax),
        _ptr(ay), _ptr(u), _ptr(oax), _ptr(oay), _ptr(na))
    k = int(na[0])
    return u[:n_u].copy(), oax[:k].copy(), oay[:k].copy()


def build_hash2_table(keys: np.ndarray, starts: np.ndarray, NB: int,
                      S: int, key32: bool,
                      mulhi: bool = False) -> tuple[np.ndarray, int]:
    """The (NB, S * stride) int32 2-choice bucketed table of the device
    index's h2 layout (stride 3 when key32 else 4) over the sorted keys
    and their len(keys) + 1 run bounds.  Returns (table, n_overflow).
    mulhi=True maps buckets by ((u64)h * NB) >> 32 (any NB), else by a
    low-bits mask (NB a power of two)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    stride = 3 if key32 else 4
    table = np.empty((NB, S * stride), np.int32)
    ov = map_lib().build_hash2_table(_ptr(keys), _ptr(starts), len(keys),
                                     NB, S, int(key32), int(mulhi),
                                     _ptr(table))
    return table, int(ov)
