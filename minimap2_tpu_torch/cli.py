"""Command-line entry point of the port: mapping as PAF or, with -c/-a, as
PAF with cg:Z or SAM (or with --write-junc as junction BED lines).

    python -m minimap2_tpu_torch.cli --batch [-x map-ont] [-a|-c] ref.fa reads.fq
    python -m minimap2_tpu_torch.cli --batch -x sr [-a] ref.fa r1.fq [r2.fq]
    python -m minimap2_tpu_torch.cli --batch -ax splice:sr [-j anno.bed] ref.mmi r1.fq [r2.fq]
    python -m minimap2_tpu_torch.cli -d ref.mmi ref.fa
    python -m minimap2_tpu_torch.cli [-t N] [-x preset] [-a|-c] ref.fa reads.fq

Presets on the --batch paths: map-ont / lr, lr:hq / map-hifi, lr:hqae,
asm5 / asm10 / asm20 (lr:hqae, asm and --rmq=yes chain with the RMQ
tier), map-pb (and -H: HPC minimizers), splice / splice:hq / cdna (spliced
-c/-a), sr (short reads, single-end or paired-end), splice:sr (single-end
through the spliced -c/-a path, paired-end through the paired path).  The
option parsing is minimap2_tpu.cli's (main.c:24-526: presets first, then
flags that override them), so IndexOptions/MapOptions come out the same.
The target is a .mmi or .npz index, or a FASTA indexed here (-d writes the
index as .mmi, or .npz by its suffix; with no query files the run ends
there); a FASTA larger than -I with query files goes through the host
multi-part split/merge path on both routes, as in the JAX package.  Then
mapopt_update and the side data (--junc-bed, -j, --pass1, --spsc, --alt).
With --batch, on the device: run_batched_pe_cli for two or more query
files in fragment mode (paired ends), else run_batched_align_cli with
-c/-a, else run_batched_cli.  Without --batch, the host mapping path as in
the JAX package: each fragment through map_fragment + write_fragment,
serially with -t 1 and in a spawn pool of -t workers otherwise; it touches
no device.  The debug-output flags (--print-seeds, --print-chains,
--print-aln-seq, --dbg-seed-occ, --print-qname) set MapOptions.dbg_flag
and print on stderr what the JAX CLI prints, on both routes: under
--batch for the reads the host mapping path takes.
"""
from __future__ import annotations

import os
import sys
import time

from . import config as C
from . import resolve_device
from .config import (IndexOptions, MapOptions, check_opt, mapopt_update,
                     max_spsc_bonus, set_opt)
from .index.index import MiniIndex
from .index.mmi import MM_IDX_MAGIC, dump_mmi, load_mmi
from .index.sidedata import jjump_read, read_alt, read_bed_junc, read_spsc
from .io import format as fmt
from .io.fastx import read_fasta
from .map.driver import iter_fragments, run_multipart
from .map.parallel_host import map_fragments, run_parallel
from .parallel import engine


USAGE = ("Usage: python -m minimap2_tpu_torch.cli [--batch] [options] "
         "target.fa query.fq [...]")


def parse_num(s: str) -> int:
    s = s.strip()
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 10 ** 3, "m": 10 ** 6, "g": 10 ** 9}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult)


_OPTS_WITH_ARG = set("kwIdtfUgGFNpMnmABOErzsKuRTqxvoJCe")
_OPTS_FLAG = set("acHXPD2LQySYh")

LONG_FLAG_OPTS = {
    "--cs": C.MM_F_OUT_CS, "--MD": C.MM_F_OUT_MD, "--ds": C.MM_F_OUT_DS,
    "--eqx": C.MM_F_EQX, "--paf-no-hit": C.MM_F_PAF_NO_HIT,
    "--sam-hit-only": C.MM_F_SAM_HIT_ONLY, "--softclip": C.MM_F_SOFTCLIP,
    "--no-end-flt": C.MM_F_NO_END_FLT, "--for-only": C.MM_F_FOR_ONLY,
    "--rev-only": C.MM_F_REV_ONLY, "--rmq": C.MM_F_RMQ,
    "--hard-mask-level": C.MM_F_HARD_MLEVEL, "--no-kalloc": 0,
    "--qstrand": C.MM_F_QSTRAND, "--no-inv": C.MM_F_NO_INV,
    "--no-hash-name": C.MM_F_NO_HASH_NAME,
    "--secondary-seq": C.MM_F_SECONDARY_SEQ,
}

# the debug-output flags: bits of MapOptions.dbg_flag (JAX cli.py:91,
# :306-322)
DBG_FLAG_OPTS = {
    "--print-qname": C.MM_DBG_PRINT_QNAME,
    "--print-seeds": C.MM_DBG_PRINT_SEED,
    "--print-chains": C.MM_DBG_PRINT_CHAIN,
    "--print-aln-seq": C.MM_DBG_PRINT_ALN_SEQ,
    "--dbg-seed-occ": C.MM_DBG_SEED_FREQ,
}
# the debug output that keeps the host route serial (JAX cli.py:636-644)
_DBG_SERIAL = (C.MM_DBG_PRINT_SEED | C.MM_DBG_PRINT_CHAIN
               | C.MM_DBG_PRINT_ALN_SEQ | C.MM_DBG_SEED_FREQ)


def _expand_short(argv):
    """ketopt-style combined short options: -cx splice == -c -x splice."""
    out = []
    for a in argv:
        if len(a) > 2 and a[0] == "-" and a[1] != "-" \
                and a[1] in (_OPTS_FLAG | _OPTS_WITH_ARG):
            j = 1
            ok = True
            parts = []
            while j < len(a):
                ch = a[j]
                if ch in _OPTS_FLAG:
                    parts.append(f"-{ch}")
                    j += 1
                elif ch in _OPTS_WITH_ARG:
                    val = a[j + 1:]
                    parts.append(f"-{ch}")
                    if val:
                        parts.append(val)
                    j = len(a)
                else:
                    ok = False
                    break
            if ok:
                out.extend(parts)
                continue
        out.append(a)
    return out


class Args:
    def __init__(self):
        self.pos = []
        self.verbose = 3
        self.batch = False
        self.sam = False
        self.out_file = None
        self.n_threads = 3
        self.idx_out = None         # -d
        self.rg = None              # -R
        self.junc_bed = None        # --junc-bed / --bed
        self.jump_bed = None        # -j / --jump
        self.pass1 = None           # --pass1
        self.spsc = None            # --spsc
        self.spsc_scale = 0.7       # --spsc-scale
        self.alt_list = None        # --alt
        self.split_prefix = None    # --split-prefix (held, as the JAX CLI)


def parse_args(argv):
    """Parse argv into (IndexOptions, MapOptions, Args) as minimap2_tpu.cli
    does; returns an int exit code instead when parsing ends the run."""
    argv = _expand_short(list(argv))
    io = IndexOptions()
    mo = MapOptions()
    args = Args()

    # pass 1: preset
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-x" or a.startswith("--preset"):
            preset = argv[i + 1] if a == "-x" else a.split("=", 1)[1]
            if set_opt(preset, io, mo) < 0:
                print(f"[ERROR] unknown preset '{preset}'", file=sys.stderr)
                return 1
            i += 2 if a == "-x" else 1
        else:
            i += 1

    # pass 2: everything else
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        def oval():
            return a.split("=", 1)[1] if "=" in a else val()

        def yes_no(flag, yes_sets=True):
            v = oval()
            if v in ("yes", "y"):
                mo.flag = (mo.flag | flag) if yes_sets else (mo.flag & ~flag)
            elif v in ("no", "n"):
                mo.flag = (mo.flag & ~flag) if yes_sets else (mo.flag | flag)
            else:
                print(f"[WARNING] option '{a.split('=')[0]}' only accepts "
                      "'yes' or 'no'.", file=sys.stderr)

        abase = a.split("=", 1)[0] if a.startswith("--") else a
        if a == "-x":
            i += 1  # already applied
        elif a == "-a":
            mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
            args.sam = True
        elif a == "-c":
            mo.flag |= C.MM_F_CIGAR | C.MM_F_OUT_CG
        elif a == "-k":
            io.k = int(val())
        elif a == "-w":
            io.w = int(val())
        elif a == "-H":
            io.flag |= C.MM_I_HPC
        elif a == "-I":
            io.batch_size = parse_num(val())
        elif a == "-d":
            args.idx_out = val()
        elif a == "-t":
            args.n_threads = int(val())
        elif a == "-v":
            args.verbose = int(val())
        elif a == "--version" or a == "-V":
            print(C.MM_VERSION.split("-")[0])
            return 0
        elif a == "-f":
            parts = val().split(",")
            mo.mid_occ_frac = float(parts[0]) if float(parts[0]) < 1 else 0
            if float(parts[0]) >= 1:
                mo.mid_occ = int(float(parts[0]))
            if len(parts) > 1:
                mo.max_mid_occ = int(float(parts[1]))
        elif a == "-U":
            v = val().split(",")
            mo.min_mid_occ = int(v[0])
            if len(v) > 1:
                mo.max_mid_occ = int(v[1])
        elif a == "-g":
            mo.max_gap = parse_num(val())
        elif a == "-G" or abase == "--max-intron-len":
            v = parse_num(val() if a == "-G" else oval())
            mo.max_gap_ref = mo.bw = mo.bw_long = v
        elif a == "-F":
            mo.max_frag_len = parse_num(val())
        elif a == "-N":
            mo.best_n = int(val())
        elif a == "-p":
            mo.pri_ratio = float(val())
        elif a == "-M" or abase == "--mask-level":
            mo.mask_level = float(val() if a == "-M" else oval())
        elif a == "-n" or abase == "--min-count":
            mo.min_cnt = int(val() if a == "-n" else oval())
        elif a == "-m" or abase == "--min-chain-score":
            mo.min_chain_score = int(val() if a == "-m" else oval())
        elif a == "-A":
            mo.a = int(val())
        elif a == "-B":
            mo.b = int(val())
        elif a == "-O":
            v = val().split(",")
            mo.q = int(v[0])
            mo.q2 = int(v[1]) if len(v) > 1 else mo.q
        elif a == "-E":
            v = val().split(",")
            mo.e = int(v[0])
            mo.e2 = int(v[1]) if len(v) > 1 else mo.e
        elif a == "-r":
            v = val().split(",")
            mo.bw = parse_num(v[0])
            if len(v) > 1:
                mo.bw_long = parse_num(v[1])
        elif a == "-z":
            v = val().split(",")
            mo.zdrop = parse_num(v[0])
            mo.zdrop_inv = parse_num(v[1]) if len(v) > 1 else mo.zdrop
        elif a == "-s" or abase == "--min-dp-score":
            mo.min_dp_max = parse_num(val() if a == "-s" else oval())
        elif a == "-K" or abase == "--mb-size":
            mo.mini_batch_size = parse_num(val() if a == "-K" else oval())
        elif a == "-X":
            mo.flag |= (C.MM_F_ALL_CHAINS | C.MM_F_NO_DIAG | C.MM_F_NO_DUAL
                        | C.MM_F_NO_LJOIN)
        elif a == "-P" or a == "--all-chain":
            mo.flag |= C.MM_F_ALL_CHAINS | C.MM_F_NO_LJOIN
        elif a == "-D" or a == "--no-self":
            mo.flag |= C.MM_F_NO_DIAG
        elif a == "-2":
            mo.flag |= C.MM_F_2_IO_THREADS
        elif a == "-u":
            for ch in val():
                if ch == "f":
                    mo.flag |= C.MM_F_SPLICE_FOR
                    mo.flag &= ~C.MM_F_SPLICE_REV
                elif ch == "b":
                    mo.flag |= C.MM_F_SPLICE_FOR | C.MM_F_SPLICE_REV
                elif ch == "r":
                    mo.flag |= C.MM_F_SPLICE_REV
                    mo.flag &= ~C.MM_F_SPLICE_FOR
                elif ch == "n":
                    mo.flag &= ~(C.MM_F_SPLICE_FOR | C.MM_F_SPLICE_REV)
        elif a == "-Y":
            mo.flag |= C.MM_F_SOFTCLIP
        elif a == "-L":
            mo.flag |= C.MM_F_LONG_CIGAR
        elif a == "-Q":
            mo.flag |= C.MM_F_NO_QUAL
        elif a == "-y":
            mo.flag |= C.MM_F_COPY_COMMENT
        elif a == "-R":
            args.rg = val()
        elif a == "-T":
            mo.sdust_thres = int(val())
        elif a == "-q" or abase == "--q-occ-frac":
            mo.q_occ_frac = float(val() if a == "-q" else oval())
        elif abase == "--secondary":
            if oval() == "no":
                mo.flag |= C.MM_F_NO_PRINT_2ND
        elif a == "--batch":
            args.batch = True
        elif a == "--write-junc":
            mo.flag |= C.MM_F_OUT_JUNC | C.MM_F_CIGAR
        elif abase == "--jump-min-match":
            mo.jump_min_match = int(oval())
        elif a == "--junc-bed" or a == "--bed":
            args.junc_bed = val()
        elif a == "-j" or a == "--jump":
            args.jump_bed = val()
        elif a == "--pass1":
            args.pass1 = val()
        elif a == "--spsc":
            args.spsc = val()
        elif a == "--spsc-scale":
            args.spsc_scale = float(val())
        elif a == "--alt":
            args.alt_list = val()
        elif a == "--split-prefix":
            args.split_prefix = val()
        elif a == "--spsc0" or a == "--junc-pen":
            mo.junc_pen = int(val())
        elif a == "--junc-bonus":
            mo.junc_bonus = int(val())
        elif a == "--alt-drop":
            mo.alt_drop = float(val())
        elif abase == "--cs":
            mo.flag |= C.MM_F_OUT_CS | C.MM_F_CIGAR
            if "=" in a and a.split("=", 1)[1] == "long":
                mo.flag |= C.MM_F_OUT_CS_LONG
        elif a == "-o":
            args.out_file = val()
        elif a == "-J":
            t = int(val())
            if t == 0:
                mo.flag |= C.MM_F_SPLICE_OLD
            elif t == 1:
                mo.flag &= ~C.MM_F_SPLICE_OLD
        elif a == "-C" or abase == "--cost-non-gt-ag":
            mo.noncan = int(val() if a == "-C" else oval())
        elif a == "-e":
            mo.occ_dist = parse_num(val())
        elif a == "-S":
            mo.flag |= C.MM_F_OUT_CS | C.MM_F_CIGAR | C.MM_F_OUT_CS_LONG
        elif abase == "--seed":
            mo.seed = int(oval())
        elif abase == "--max-chain-skip":
            mo.max_chain_skip = int(oval())
        elif abase == "--max-chain-iter":
            mo.max_chain_iter = int(oval())
        elif abase == "--chain-gap-scale":
            mo.chain_gap_scale = float(oval())
        elif abase == "--chain-skip-scale":
            mo.chain_skip_scale = float(oval())
        elif abase == "--mask-len":
            mo.mask_len = parse_num(oval())
        elif abase == "--min-dp-len":
            mo.min_ksw_len = int(oval())
        elif abase == "--end-bonus":
            mo.end_bonus = int(oval())
        elif abase == "--end-seed-pen":
            mo.anchor_ext_shift = int(oval())
        elif abase == "--max-clip-ratio":
            mo.max_clip_ratio = float(oval())
        elif abase == "--min-occ-floor":
            mo.min_mid_occ = int(oval())
        elif abase == "--score-N":
            mo.sc_ambi = int(oval())
        elif abase == "--max-qlen":
            mo.max_qlen = parse_num(oval())
        elif abase == "--cap-sw-mem":
            mo.max_sw_mat = parse_num(oval())
        elif abase == "--cap-kalloc":
            mo.cap_kalloc = parse_num(oval())
        elif abase == "--rmq-inner":
            mo.rmq_inner_dist = parse_num(oval())
        elif abase == "--bucket-bits":
            io.bucket_bits = int(oval())
        elif a == "--no-long-join":
            mo.flag |= C.MM_F_NO_LJOIN
        elif a == "--splice":
            mo.flag |= C.MM_F_SPLICE
        elif a == "--idx-no-seq":
            io.flag |= C.MM_I_NO_SEQ
        elif a == "--no-pairing":
            mo.flag |= C.MM_F_INDEPEND_SEG
        elif abase == "--frag":
            yes_no(C.MM_F_FRAG_MODE, yes_sets=True)
        elif abase == "--heap-sort":
            yes_no(C.MM_F_HEAP_SORT, yes_sets=True)
        elif abase == "--dual":
            yes_no(C.MM_F_NO_DUAL, yes_sets=False)
        elif abase == "--splice-flank":
            yes_no(C.MM_F_SPLICE_FLANK, yes_sets=True)
        elif a.startswith("--rmq="):
            yes_no(C.MM_F_RMQ, yes_sets=True)
        elif abase == "--sr":
            v = a.split("=", 1)[1] if "=" in a else "dna"
            if v == "rna":
                mo.flag |= C.MM_F_SR_RNA
            elif v == "no":
                mo.flag &= ~(C.MM_F_SR | C.MM_F_SR_RNA)
            else:
                mo.flag |= C.MM_F_SR
        elif abase == "--pairing":
            v = oval()
            if v == "no":
                mo.flag |= C.MM_F_INDEPEND_SEG
            elif v == "weak":
                mo.flag |= C.MM_F_WEAK_PAIRING
                mo.flag &= ~C.MM_F_INDEPEND_SEG
            else:
                mo.flag &= ~(C.MM_F_INDEPEND_SEG | C.MM_F_WEAK_PAIRING)
        elif abase == "--lj-min-ratio":
            oval()
        elif a == "-h" or a == "--help":
            print(USAGE)
            return 0
        elif a in DBG_FLAG_OPTS:
            mo.dbg_flag |= DBG_FLAG_OPTS[a]
            if a == "--print-aln-seq":      # main.c:224 (forces 1 thread)
                args.n_threads = 1
        elif a in LONG_FLAG_OPTS:
            mo.flag |= LONG_FLAG_OPTS[a]
            if a in ("--MD", "--ds"):
                mo.flag |= C.MM_F_CIGAR
        elif a.startswith("--"):
            print(f"[WARNING] unhandled option '{a}' (ignored)",
                  file=sys.stderr)
            # consume a value if the next token isn't a file
            if i + 1 < len(argv) and not argv[i + 1].startswith("-") \
                    and "=" not in a and not os.path.exists(argv[i + 1]):
                i += 1
        elif a.startswith("-") and len(a) > 1:
            print(f"[ERROR] unknown option '{a}'", file=sys.stderr)
            return 1
        else:
            args.pos.append(a)
        i += 1

    if (mo.flag & C.MM_F_SPLICE_FOR) or (mo.flag & C.MM_F_SPLICE_REV):
        mo.flag |= C.MM_F_SPLICE
    return io, mo, args


def run_host(mi, mo, queries, out, n_threads: int) -> int:
    """The route without --batch (JAX cli.py:634-657): every fragment (one
    read, or with two or more query files or --frag=yes the reads of one
    name) through map_fragment + write_fragment on the host; with
    n_threads > 1 on Linux in a spawn pool that keeps input order, unless
    debug output other than --print-qname is on.  Returns the number of
    reads mapped."""
    frag_mode = len(queries) > 1 or bool(mo.flag & C.MM_F_FRAG_MODE)
    if n_threads > 1 and sys.platform.startswith("linux") \
            and not mo.dbg_flag & _DBG_SERIAL:
        return run_parallel(mi, mo, queries, out, frag_mode, n_threads)
    return map_fragments(mi, mo, iter_fragments(queries, frag_mode), out)


def load_target(tgt: str, io: IndexOptions, args, has_queries: bool):
    """The index of the target (JAX cli.py:520-546): a .npz or .mmi file
    (by suffix or magic) as it is, else the FASTA indexed here, and with
    -d written to .npz or .mmi.  A FASTA larger than -I with query files
    is not indexed whole: returns (None, (names, seqs)) for the
    multi-part path, else (index, None)."""
    with open(tgt, "rb") as fh:
        magic = fh.read(4)
    if tgt.endswith(".npz"):
        mi = MiniIndex.load(tgt)
    elif magic == MM_IDX_MAGIC:
        mi = load_mmi(tgt)
    else:
        names, seqs = read_fasta(tgt)
        if sum(len(s) for s in seqs) > io.batch_size and has_queries:
            if args.batch:
                print(f"[WARNING] genome exceeds -I ({io.batch_size} bp): "
                      "--batch is ignored and the host multi-part "
                      "split/merge path runs instead; raise -I to keep the "
                      "device path", file=sys.stderr)
            return None, (names, seqs)
        mi = MiniIndex.build(names, seqs, w=io.w, k=io.k,
                             b=io.bucket_bits, flag=io.flag)
    if args.idx_out:
        if args.idx_out.endswith(".npz"):
            mi.save(args.idx_out)
        else:
            dump_mmi(mi, args.idx_out)
    return mi, None


def attach_side_data(mi, mo: MapOptions, args, verbose: int) -> None:
    """--junc-bed, -j, --pass1, --spsc and --alt onto the index (JAX
    cli.py:580-601; index/sidedata.py)."""
    if args.junc_bed:
        mi.intervals = read_bed_junc(args.junc_bed, mi)
    if args.jump_bed:
        jjump_read(args.jump_bed, mi, 0x1, -1)     # MM_JUNC_ANNO
    if args.pass1:
        jjump_read(args.pass1, mi, 0x2, 5)         # MM_JUNC_MISC
    if args.spsc:
        n = read_spsc(args.spsc, mi, max_spsc_bonus(mo), args.spsc_scale)
        if verbose >= 3:
            print(f"[M::mm_idx_spsc_read2] read {n} splice scores",
                  file=sys.stderr)
    if args.alt_list:
        n = read_alt(args.alt_list, mi)
        if verbose >= 3:
            print(f"[M::mm_idx_alt_read] found {n} ALT contigs",
                  file=sys.stderr)


def main(argv=None, device=None) -> int:
    """The CLI: --batch on the device, else the host mapping path.
    ``device`` defaults to CUDA on both routes, so the CLI has one rule;
    the host route touches no device."""
    orig_argv = list(sys.argv[1:] if argv is None else argv)
    parsed = parse_args(orig_argv)
    if isinstance(parsed, int):
        return parsed
    io, mo, args = parsed
    device = resolve_device(device)      # fail before the index build
    if check_opt(io, mo) < 0:
        return 1
    if not args.pos:
        print(USAGE, file=sys.stderr)
        return 1
    tgt, queries = args.pos[0], args.pos[1:]
    for f_ in [tgt] + queries:
        if not os.path.exists(f_):
            print(f"ERROR: failed to open file '{f_}'", file=sys.stderr)
            return 1
    t0 = time.time()
    mi, multipart = load_target(tgt, io, args, bool(queries))
    if mi is not None and args.verbose >= 3:
        print(f"[M::main::{time.time() - t0:.3f}] loaded/built the index "
              f"for {mi.n_seq} target sequence(s)", file=sys.stderr)
    if not queries:         # -d alone: the index is written
        return 0
    cmdline = "minimap2 " + " ".join(orig_argv)
    out = sys.stdout
    if args.out_file and args.out_file != "-":
        out = open(args.out_file, "w")
    try:
        if multipart is not None:
            n_mapped = run_multipart(
                *multipart, io, mo, queries, out, args.verbose,
                (lambda meta: out.write(fmt.write_sam_hdr(
                    meta, args.rg, C.MM_VERSION, cmdline) + "\n"))
                if args.sam else None)
        else:
            n_mapped = map_target(mi, mo, args, queries, out, cmdline,
                                  device, t0)
        if n_mapped is not None and args.verbose >= 3:
            print(f"[M::worker_pipeline::{time.time() - t0:.3f}] "
                  f"mapped {n_mapped} sequences", file=sys.stderr)
    finally:
        if out is not sys.stdout:
            out.close()
    if args.verbose >= 3:
        print(f"[M::main] Version: {C.MM_VERSION}", file=sys.stderr)
        print(f"[M::main] CMD: python -m minimap2_tpu_torch.cli "
              f"{' '.join(orig_argv)}", file=sys.stderr)
    return 0


def map_target(mi, mo, args, queries, out, cmdline, device, t0):
    """Map the query files against one index: mapopt_update, the side
    data, the SAM header (with the -R read group, whose ID the records
    carry as RG:Z), then the --batch drivers or the host route.  Returns
    the reads the host route mapped, or None on --batch (its drivers log
    their own counts)."""
    mapopt_update(mo, mi)
    if args.verbose >= 3:
        print(f"[M::main::{time.time() - t0:.3f}] mid_occ = {mo.mid_occ}",
              file=sys.stderr)
        print(mi.stat(), file=sys.stderr)
    attach_side_data(mi, mo, args, args.verbose)
    if args.sam:
        mo.rg_id = None
        if args.rg:
            for f_ in args.rg.replace("\\t", "\t").split("\t"):
                if f_.startswith("ID:"):
                    mo.rg_id = f_[3:]
        out.write(fmt.write_sam_hdr(mi, args.rg, C.MM_VERSION, cmdline)
                  + "\n")
    if not args.batch:
        return run_host(mi, mo, queries, out, args.n_threads)
    if len(queries) > 1 and (mo.flag & C.MM_F_FRAG_MODE):
        engine.run_batched_pe_cli(mi, mo, queries, out, device=device)
    elif mo.flag & (C.MM_F_CIGAR | C.MM_F_OUT_SAM):
        engine.run_batched_align_cli(mi, mo, queries, out, device=device)
    else:
        engine.run_batched_cli(mi, mo, queries, out, device=device)
    return None


if __name__ == "__main__":
    sys.exit(main())
