"""Configuration: indexing/mapping options, flags and presets.

A copy of minimap2_tpu.config (pure Python), kept so the port imports
nothing of the JAX package.  Numeric defaults and presets are a 1:1 port
of minimap2's options.c:5-193 and the MM_F_*/MM_I_* flag words
(minimap.h:10-54).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

INT_MAX = 2147483647
INT64_MIN = -(1 << 63)

# ---- flag bits (minimap.h:10-50) ----
MM_F_NO_DIAG       = 0x001
MM_F_NO_DUAL       = 0x002
MM_F_CIGAR         = 0x004
MM_F_OUT_SAM       = 0x008
MM_F_NO_QUAL       = 0x010
MM_F_OUT_CG        = 0x020
MM_F_OUT_CS        = 0x040
MM_F_SPLICE        = 0x080
MM_F_SPLICE_FOR    = 0x100
MM_F_SPLICE_REV    = 0x200
MM_F_NO_LJOIN      = 0x400
MM_F_OUT_CS_LONG   = 0x800
MM_F_SR            = 0x1000
MM_F_FRAG_MODE     = 0x2000
MM_F_NO_PRINT_2ND  = 0x4000
MM_F_2_IO_THREADS  = 0x8000
MM_F_LONG_CIGAR    = 0x10000
MM_F_INDEPEND_SEG  = 0x20000
MM_F_SPLICE_FLANK  = 0x40000
MM_F_SOFTCLIP      = 0x80000
MM_F_FOR_ONLY      = 0x100000
MM_F_REV_ONLY      = 0x200000
MM_F_HEAP_SORT     = 0x400000
MM_F_ALL_CHAINS    = 0x800000
MM_F_OUT_MD        = 0x1000000
MM_F_COPY_COMMENT  = 0x2000000
MM_F_EQX           = 0x4000000
MM_F_PAF_NO_HIT    = 0x8000000
MM_F_NO_END_FLT    = 0x10000000
MM_F_HARD_MLEVEL   = 0x20000000
MM_F_SAM_HIT_ONLY  = 0x40000000
MM_F_RMQ           = 0x80000000
MM_F_QSTRAND       = 0x100000000
MM_F_NO_INV        = 0x200000000
MM_F_NO_HASH_NAME  = 0x400000000
MM_F_SPLICE_OLD    = 0x800000000
MM_F_SECONDARY_SEQ = 0x1000000000
MM_F_OUT_DS        = 0x2000000000
MM_F_WEAK_PAIRING  = 0x4000000000
MM_F_SR_RNA        = 0x8000000000
MM_F_OUT_JUNC      = 0x10000000000

MM_I_HPC     = 0x1
MM_I_NO_SEQ  = 0x2
MM_I_NO_NAME = 0x4

MM_MAX_SEG = 255

# seed flag bits on anchor y (mmpriv.h:19-25)
MM_SEED_LONG_JOIN = 1 << 40
MM_SEED_IGNORE    = 1 << 41
MM_SEED_TANDEM    = 1 << 42
MM_SEED_SELF      = 1 << 43
MM_SEED_SEG_SHIFT = 48
MM_SEED_SEG_MASK  = 0xFF << MM_SEED_SEG_SHIFT

# mm_dbg_flag bits (mmpriv.h:12-17), set by the CLI's debug-output flags
# and carried on MapOptions.dbg_flag
MM_DBG_PRINT_QNAME   = 0x2     # --print-qname: QR/QT lines
MM_DBG_PRINT_SEED    = 0x4     # --print-seeds: RS/SD lines (and CN lines)
MM_DBG_PRINT_ALN_SEQ = 0x8     # --print-aln-seq: the DPs' inputs, score
MM_DBG_PRINT_CHAIN   = 0x10    # --print-chains: CN lines
MM_DBG_SEED_FREQ     = 0x20    # --dbg-seed-occ: SF lines

MM_PARENT_UNSET = -1
MM_PARENT_TMP_PRI = -2

MM_CIGAR_STR = "MIDNSHP=XB"

MM_VERSION = "2.30-r1299-dirty"  # reference version we match (minimap.h:8)
TPU_VERSION = "0.1.0"


@dataclass
class IndexOptions:
    """mm_idxopt_t (minimap.h:130-134); defaults from options.c:5-12."""
    k: int = 15
    w: int = 10
    flag: int = 0
    bucket_bits: int = 14
    mini_batch_size: int = 50000000
    batch_size: int = 8000000000

    @property
    def is_hpc(self) -> bool:
        return bool(self.flag & MM_I_HPC)


@dataclass
class MapOptions:
    """mm_mapopt_t (minimap.h:136-192); defaults from options.c:14-67."""
    flag: int = 0
    seed: int = 11
    sdust_thres: int = 0
    max_qlen: int = 0
    bw: int = 500
    bw_long: int = 20000
    max_gap: int = 5000
    max_gap_ref: int = -1
    max_frag_len: int = 0
    max_chain_skip: int = 25
    max_chain_iter: int = 5000
    min_cnt: int = 3
    min_chain_score: int = 40
    chain_gap_scale: float = 0.8
    chain_skip_scale: float = 0.0
    rmq_size_cap: int = 100000
    rmq_inner_dist: int = 1000
    rmq_rescue_size: int = 1000
    rmq_rescue_ratio: float = 0.1
    mask_level: float = 0.5
    mask_len: int = INT_MAX
    pri_ratio: float = 0.8
    best_n: int = 5
    alt_drop: float = 0.15
    a: int = 2           # match score
    b: int = 4           # mismatch penalty
    q: int = 4           # gap open
    e: int = 2           # gap ext
    q2: int = 24         # second gap open
    e2: int = 1          # second gap ext
    transition: int = 0
    sc_ambi: int = 1
    noncan: int = 0
    junc_bonus: int = 0
    junc_pen: int = 0
    zdrop: int = 400
    zdrop_inv: int = 200
    end_bonus: int = -1
    min_dp_max: int = 80     # min_chain_score * a
    min_ksw_len: int = 200
    anchor_ext_len: int = 20
    anchor_ext_shift: int = 6
    max_clip_ratio: float = 1.0
    rank_min_len: int = 500
    rank_frac: float = 0.9
    pe_ori: int = 0
    pe_bonus: int = 33
    jump_min_match: int = 3
    mid_occ_frac: float = 2e-4
    q_occ_frac: float = 0.01
    min_mid_occ: int = 10
    max_mid_occ: int = 1000000
    mid_occ: int = 0
    max_occ: int = 0
    max_max_occ: int = 4095
    occ_dist: int = 500
    mini_batch_size: int = 500000000
    max_sw_mat: int = 100000000
    cap_kalloc: int = 500000000
    split_prefix: str | None = None
    # the reference's global mm_dbg_flag (MM_DBG_* bits), carried with the
    # options so that each call and each worker sees its own
    dbg_flag: int = 0


PRESETS = (
    "lr", "map-ont", "ava-ont", "map10k", "map-pb", "ava-pb",
    "lr:hq", "map-hifi", "map-ccs", "lr:hqae", "map-iclr-prerender",
    "map-iclr", "asm5", "asm10", "asm20", "short", "sr",
    "splice", "splice:hq", "splice:sr", "cdna",
)


def set_opt(preset: str | None, io: IndexOptions, mo: MapOptions) -> int:
    """Apply a preset in place (options.c:91-193). Returns 0 or -1 on unknown."""
    if preset is None:
        return 0
    if preset in ("lr", "map-ont"):
        pass
    elif preset == "ava-ont":
        io.flag, io.k, io.w = 0, 15, 5
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
        mo.min_chain_score, mo.pri_ratio, mo.max_chain_skip = 100, 0.0, 25
        mo.bw = mo.bw_long = 2000
        mo.occ_dist = 0
    elif preset in ("map10k", "map-pb"):
        io.flag |= MM_I_HPC
        io.k = 19
    elif preset == "ava-pb":
        io.flag |= MM_I_HPC
        io.k, io.w = 19, 5
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
        mo.min_chain_score, mo.pri_ratio, mo.max_chain_skip = 100, 0.0, 25
        mo.bw_long = mo.bw
        mo.occ_dist = 0
    elif preset in ("lr:hq", "map-hifi", "map-ccs"):
        io.flag, io.k, io.w = 0, 19, 19
        mo.max_gap = 10000
        mo.min_mid_occ, mo.max_mid_occ = 50, 500
        if preset in ("map-hifi", "map-ccs"):
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 4, 6, 26, 2, 1
            mo.min_dp_max = 200
    elif preset == "lr:hqae":
        io.flag, io.k, io.w = 0, 25, 51
        mo.flag |= MM_F_RMQ
        mo.min_mid_occ, mo.max_mid_occ = 50, 500
        mo.rmq_inner_dist = 5000
        mo.occ_dist = 200
        mo.best_n = 100
        mo.chain_gap_scale = 5.0
    elif preset == "map-iclr-prerender":
        io.flag, io.k = 0, 15
        mo.b, mo.transition = 6, 1
        mo.q, mo.q2 = 10, 50
    elif preset == "map-iclr":
        io.flag, io.k = 0, 19
        mo.b, mo.transition = 6, 4
        mo.q, mo.q2 = 10, 50
    elif preset.startswith("asm"):
        io.flag, io.k, io.w = 0, 19, 19
        mo.bw, mo.bw_long = 1000, 100000
        mo.max_gap = 10000
        mo.flag |= MM_F_RMQ
        mo.min_mid_occ, mo.max_mid_occ = 50, 500
        mo.min_dp_max = 200
        mo.best_n = 50
        if preset == "asm5":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 19, 39, 81, 3, 1
            mo.zdrop = mo.zdrop_inv = 200
        elif preset == "asm10":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 9, 16, 41, 2, 1
            mo.zdrop = mo.zdrop_inv = 200
        elif preset == "asm20":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 4, 6, 26, 2, 1
            mo.zdrop = mo.zdrop_inv = 200
            io.w = 10
        else:
            return -1
    elif preset in ("short", "sr"):
        io.flag, io.k, io.w = 0, 21, 11
        mo.flag |= (MM_F_SR | MM_F_FRAG_MODE | MM_F_NO_PRINT_2ND
                    | MM_F_2_IO_THREADS | MM_F_HEAP_SORT)
        mo.pe_ori = 0 << 1 | 1  # FR
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 2, 8, 12, 2, 24, 1
        mo.zdrop = mo.zdrop_inv = 100
        mo.end_bonus = 10
        mo.max_frag_len = 800
        mo.max_gap = 100
        mo.bw = mo.bw_long = 100
        mo.pri_ratio = 0.5
        mo.min_cnt = 2
        mo.min_chain_score = 25
        mo.min_dp_max = 40
        mo.best_n = 20
        mo.mid_occ = 1000
        mo.max_occ = 5000
        mo.mini_batch_size = 50000000
    elif preset in ("splice", "splice:hq", "splice:sr", "cdna"):
        io.flag, io.k, io.w = 0, 15, 5
        mo.flag |= MM_F_SPLICE | MM_F_SPLICE_FOR | MM_F_SPLICE_REV | MM_F_SPLICE_FLANK
        mo.max_sw_mat = 0
        mo.max_gap = 2000
        mo.max_gap_ref = mo.bw = mo.bw_long = 200000
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 2, 2, 1, 32, 0
        mo.noncan = 9
        mo.junc_bonus = 9
        mo.junc_pen = 5
        mo.zdrop, mo.zdrop_inv = 200, 100
        if preset == "splice:hq":
            mo.noncan, mo.b, mo.q, mo.q2 = 5, 4, 6, 24
        elif preset == "splice:sr":
            mo.flag |= (MM_F_NO_PRINT_2ND | MM_F_2_IO_THREADS | MM_F_HEAP_SORT
                        | MM_F_FRAG_MODE | MM_F_WEAK_PAIRING | MM_F_SR_RNA)
            mo.noncan, mo.b, mo.q, mo.q2 = 5, 4, 6, 24
            mo.min_chain_score = 25
            mo.min_dp_max = 40
            mo.min_ksw_len = 20
            mo.pe_ori = 0 << 1 | 1  # FR
            mo.best_n = 10
            mo.mini_batch_size = 100000000
    else:
        return -1
    return 0


def mapopt_update(mo: MapOptions, mi) -> None:
    """options.c:69-83: derive mid_occ from the index occurrence distribution."""
    if (mo.flag & MM_F_SPLICE_FOR) or (mo.flag & MM_F_SPLICE_REV):
        mo.flag |= MM_F_SPLICE
    if mo.mid_occ <= 0:
        mo.mid_occ = mi.cal_max_occ(mo.mid_occ_frac)
        if mo.mid_occ < mo.min_mid_occ:
            mo.mid_occ = mo.min_mid_occ
        if mo.max_mid_occ > mo.min_mid_occ and mo.mid_occ > mo.max_mid_occ:
            mo.mid_occ = mo.max_mid_occ
    if mo.bw_long < mo.bw:
        mo.bw_long = mo.bw


def max_spsc_bonus(mo: MapOptions) -> int:
    """options.c:195-200."""
    max_sc = (mo.q2 + 1) // 2 - 1
    return max_sc if max_sc > mo.q2 - mo.q else mo.q2 - mo.q


def check_opt(io: IndexOptions, mo: MapOptions) -> int:
    """options.c:202-277 validation; returns 0 if OK else negative code."""
    import sys

    def err(msg):
        print(f"[ERROR]\033[1;31m {msg}\033[0m", file=sys.stderr)

    if mo.bw > mo.bw_long:
        err(f"with '-rNUM1,NUM2', NUM1 ({mo.bw}) can't be larger than NUM2 ({mo.bw_long})")
        return -8
    if (mo.flag & MM_F_RMQ) and (mo.flag & (MM_F_SR | MM_F_SPLICE)):
        err("--rmq doesn't work with --sr or --splice")
        return -7
    if mo.split_prefix and (mo.flag & (MM_F_OUT_CS | MM_F_OUT_MD)):
        err("--cs or --MD doesn't work with --split-prefix")
        return -6
    if io.k <= 0 or io.w <= 0:
        err("-k and -w must be positive")
        return -5
    if mo.best_n < 0:
        err("-N must be no less than 0")
        return -4
    if mo.pri_ratio < 0.0 or mo.pri_ratio > 1.0:
        err("-p must be within 0 and 1 (including 0 and 1)")
        return -4
    if (mo.flag & MM_F_FOR_ONLY) and (mo.flag & MM_F_REV_ONLY):
        err("--for-only and --rev-only can't be applied at the same time")
        return -3
    if mo.e <= 0 or mo.q <= 0:
        err("-O and -E must be positive")
        return -1
    if (mo.q != mo.q2 or mo.e != mo.e2) and not (mo.e > mo.e2 and mo.q + mo.e < mo.q2 + mo.e2):
        err("dual gap penalties violating E1>E2 and O1+E1<O2+E2")
        return -2
    if (mo.q + mo.e) + (mo.q2 + mo.e2) > 127:
        err("scoring system violating ({-O}+{-E})+({-O2}+{-E2}) <= 127")
        return -1
    if mo.sc_ambi < 0 or mo.sc_ambi >= mo.b:
        err("--score-N should be within [0,{-B})")
        return -1
    if mo.zdrop < mo.zdrop_inv:
        err("Z-drop should not be less than inversion-Z-drop")
        return -5
    if (mo.flag & MM_F_NO_PRINT_2ND) and (mo.flag & MM_F_ALL_CHAINS):
        err("-X/-P and --secondary=no can't be applied at the same time")
        return -5
    if (mo.flag & MM_F_QSTRAND) and ((mo.flag & (MM_F_OUT_SAM | MM_F_SPLICE | MM_F_FRAG_MODE))
                                     or (io.flag & MM_I_HPC)):
        err("--qstrand doesn't work with -a, -H, --frag or --splice")
        return -5
    return 0
