#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught; each prints its
seconds):
  1. the card: nvidia-smi name and power limit; no CUDA device -> exit;
  2. build the CUDA kernels from minimap2_tpu_torch/ops/csrc, and the
     host library from minimap2_tpu_torch/native/host_map.cpp (g++); every
     CLI phase reads FASTA/FASTQ through the native scanner
     (native.fastx_scan in native/host_scans.cpp), checked after phase 3
     and at the end;
  3. the PAF path: a 100 Mb, 8-contig repeat-bearing genome and 1024
     ONT-like 8-11 kb reads through ``minimap2_tpu_torch.cli.main(
     ["--batch", "-x", "map-ont", "-d", "main.mmi", ...])``; every kernel
     of the path must have launched, >= 90% of reads must land on their
     source interval and no mapq-60 primary may be wrong; the .mmi the
     run wrote, loaded again, must equal the run's host MiniIndex array
     for array (keys, run starts, positions, reference codes, names and
     lengths); the dump's and the load's seconds; the port's ``paftools
     mapeval`` rows of the PAF; every host index build from FASTA (here
     and in phases 4b, 4c, 5 and 6: the native batched sketch and radix
     sort) prints its seconds;
  3b. the device index build (pos_fmt 1, h2r built in one piece) of phase
     3's genome on the card: the sketch kernel launched in the build, its
     tables decoded to host coordinates equal phase 3's host MiniIndex
     (keys, run starts, positions) and mid_occ its cal_max_occ(2e-4); phase
     3's reads mapped through it at phase 3's widths give byte-identical
     PAF; each build stage's seconds and the peak device memory; then the
     same genome under MM2TPU_DEVBUILD_H2R=0: the krows layout (probe_win
     2), decoded equal to phase 3's host index with every key, phase 3's
     reads through it (the rule of 3f);
  3f. phase 3's host index as the h2 layout with pos_fmt 0 and s_fmt 1
     (MM2TPU_H2R=0, MM2TPU_PACK_S=1, force_pos_fmt=0): its seconds and
     table sizes; phase 3's reads through it at occ_cap 62 (what phase
     3's stride-2 h2r rows apply) with PAF equal to phase 3's but for
     reads holding a key the h2r build dropped, and at occ_cap 64, where
     a read may also differ through a key of 63-64 occurrences (each such
     read named); _lookup_anchors timed whole and as the probe alone on
     phase 3's first compacted minimizers (512 x 4096) for h2r, h2, krows
     and h2 with pos_fmt 0 (the last three with equal anchors);
  3c. the 3.1 Gb / 195-contig GRCh38 envelope: generated on the card
     (alt0 and alt170 equal to the same contigs generated on the CPU),
     1024 ONT-like reads sliced from its 24 big chromosomes, indexed on the
     card with consume=True (pos_fmt 2, s_fmt 1, the chunked h2r build),
     the reads mapped through ``engine.map_queries`` in two 512-read
     batches at bench.py's widths (L 12288, M 2048, A 4096, long-join
     pass on); the accuracy gates of phase 3, the port's mapeval rows,
     reads/s, the build's stages, peak memory and counts; then bench.py's
     off-distribution gate: 256 pbsim-CLR-shaped reads (12-30 kb, 5%
     errors 10:60:30, 10% with a 1-10 kb deletion; made from the 24
     chromosomes before the build consumes them) through a second PafStep
     at L 32768, M 4096, A 8192, bw_long 0, one 256-read batch (sketch,
     sort1 for the compaction past 16384 lanes, sort3, the chain kernel);
     the port's mapeval rows, no error in the Q60 row;
  3e. the one-call device step: ``batch.map_batch`` on phase 3b's
     device-built index with 512 simulated ONT-like reads of 1.2-2 kb (seed
     10) in one call at the port's BatchParams defaults (L 2048, M 512, A
     1024, QP = TP 2048, W 640, ext_w 500): sketch, sort3 and extd2 (its
     score-only mode) launched, the chain kernel not (the step chains with
     the scan, as the JAX package's does); >= 90% of reads with contig
     and strand right and [rs, re) on their source interval, ext_score > 0
     on every mapped read; reads/s and the chain scan's seconds from a
     second call on the same inputs (equal dicts);
  3g. the sharded step (``parallel/sharded.py``): phase 3's host index
     split into two key-range shards by ``DeviceIndex.from_host(mi,
     n_shards=2, cache=...)`` (its seconds, each shard's keys and table
     MB); four ranks (minimap2_tpu_torch/parallel/ranks.py) share the card
     at (data=2, idx=2) through gloo, each loading only its shard from
     the .npz, and map phase 3e's 512 reads (256 a data row) at the
     BatchParams defaults, twice: sketch, sort3, the shard merge's sort3
     and extd2 launched in every rank, the chain kernel in none; the
     gathered output bit-equal to map_batch on phase 3's one-shard index
     on every read of at most A one-shard anchors (the reads above A
     counted and named), its first 16 reads equal to the same step run by
     four CPU gloo ranks (plain versions), n_mapped the gathered mapped
     count; the anchor counts, the idx balance, the second call's
     seconds and reads/s (slowest rank), the collectives' seconds and
     each rank's peak device memory; then a 1-rank NCCL group in this
     process runs the step at (1, 1) on the same reads, equal to
     map_batch;
  3d. reads longer than L: on phase 3's main.mmi, 1024 ONT-like reads (5%
     sub, 2.5% del, 2.5% ins; seeds 5, 6 and 7), 896 of 8-11 kb and 128 of
     16.6-50 kb (past L = 16384) in a shuffled order, through
     ``cli.main(["--batch", "-x", "map-ont", ...])``; all 128 long reads
     must go through the host path and every record come out in input
     order, >= 90% of reads correct, no wrong mapq-60 primary; reads/s and
     the host path's share of the run's seconds;
  4. the -a path: the same reads on main.mmi through ``cli.main([
     "--batch", "-a", "-x", "map-ont", ...])``; all five kernels launched,
     >= 90% of
     primaries on their source interval (a fallback read is scored on the
     record the host path writes for it), no wrong mapq-60 primary, <= 3%
     fallback reads (the JAX package's decisions, which the port takes,
     give 2.25% on these reads), and every primary's CIGAR spans the read
     and its aligned reference interval; the host path's reads and
     seconds;
  4b. the short-read paired-end path: on the same genome, 2048 simulated
     Illumina-like FR pairs (4096 ends of 150 bp; fragments ~N(350, 50)
     clipped to [200, 600], half from the minus strand; 0.5% substitutions,
     0.01% deletions and 0.01% insertions; seed 8) in two FASTQ files
     through ``cli.main(["--batch", "-ax", "sr", ref, r1, r2])`` (a k21 w11
     host index, 512 ends a step, L 1024, A 2048, extd2 at W 256); sketch,
     sort3, chain, extd2 and the traceback launched, >= 90% of ends with a
     primary on their source interval, no wrong mapq-60 primary, >= 90% of
     pairs proper (0x2), every primary CIGAR spanning its read, <= 5% of
     the fragments on the host path; reads/s and the host path's reads and
     seconds;
  4c. the RMQ tier: 1024 simulated ONT Q20-like reads (8-11 kb, 0.5%
     substitutions, 0.25% deletions, 0.25% insertions; seed 9) on the same
     genome through ``cli.main(["--batch", "-a", "-x", "lr:hqae", ...])``
     (k25 w51), then the PAF route on the same host index through
     ``engine.run_batched_cli``; sketch, sort3, extd2 and the traceback
     launched and the chain kernel not (the RMQ tier chains with the scan
     and its strided second window); -a: >= 90% of primaries on their
     source interval (fallback reads on their host-path records), no wrong
     mapq-60 primary, every primary CIGAR spanning its read, <= 5%
     fallback reads; PAF: phase 3's gates; reads/s of both, the chain
     scan's seconds a batch and the host path's share;
  5. the HPC path: 1024 PacBio-CLR-like reads (2% sub, 3% del, 5% ins)
     through ``cli.main(["--batch", "-x", "map-pb", ...])`` on the same
     genome; sort1 launched, >= 90% of primaries on their source interval,
     no wrong mapq-60 primary;
  6. the splice path: the genome with 1024 planted multi-exon genes (half
     on each strand, canonical splice signals) and one cDNA read per gene
     through ``cli.main(["--batch", "-a", "-x", "splice", "-d",
     "splice.mmi", ...])``; sketch, sort3, chain, exts2 and the splice
     traceback launched, >= 90% of primaries on their gene (fallback reads
     scored on their host-path records), no wrong mapq-60 primary, every
     primary CIGAR spans its read and reference interval, >= 80% of the
     true introns matched exactly by an N op;
  6b. splice:sr on splice.mmi (k15 w5): 2048 FR pairs of 2 x 150 bp from
     the planted genes' spliced transcripts (fragments ~N(250, 50) clipped
     to [160, 500], every other one reverse-complemented, 0.5%
     substitutions; seed 12) in two FASTQ files and a BED12 of the genes;
     (a) ``cli.main(["--batch", "-ax", "splice:sr", "-j", anno,
     "splice.mmi", r1, r2])``: sketch, sort3, chain, extd2 and the
     traceback launched; (b) the r1 file alone, single-end: sketch, sort3,
     chain, exts2 and the splice traceback launched; no wrong mapq-60
     primary, every primary CIGAR spans its read, run (a)'s records in
     input order, and the shares of ends with a primary on their gene, of
     pairs proper and of fragments on the host path and run (b)'s share
     of true introns matched exactly against SSR_FLOORS (run (a)'s is
     printed: its extd2 does not splice); reads/s of both runs;
  6c. the wide shapes (the JAX kernels' own, past the defaults): phase 4's
     reads through ``cli.main(["--batch", "-a", "-x", "map-ont", "-r",
     "1000,20000", ...])`` with run_batched_align_cli at align_kw W 1152
     (extd2's band 1000), phase 4's gates; phase 6's reads against
     splice.mmi at L 4096 and align_kw QP 4096, sub 128 (exts2 at W 4224),
     phase 6's gates; phase 3's first 512 reads through a PafStep at
     chain_window 128 (the chain kernel's WND 128, no WND 64 launch),
     phase 3's gates; reads/s of each;
  7. each kernel against its plain PyTorch version on the card at its
     path's shapes (bit-equal; the sketch on random codes, on the first
     batch of phases 3 (k15 w10), 5 (k19 w10, HPC-compacted codes) and 6
     (k15 w5), and with its validity plane on phase 3b's first build chunk
     (8192 x 8192); sort3 on random planes and on phase 3's first compaction
     and anchor keys; extd2 on the first align launch of phase 4 (a
     batch's jobs), timed there and on its first 64 jobs, the traceback
     on those 64 jobs, sort1 on phase 5's first batch and on full-range
     u32, exts2 on the first 32 jobs of phase 6's first launch and on
     that whole launch (both strand rounds of a sub-batch), the splice
     traceback on those 32 jobs and on that whole launch; at phase 4b's
     sr shapes: the sketch (k21 w11) on its first batch, sort3 on its
     first compaction and anchor keys, the chain on its first batch's
     anchor planes, extd2 (W 256) and the traceback on its first align
     launch; at phase 4c's shapes: the sketch (k25 w51) on its first
     batch and at k19 w19 on random codes, sort3 on its first compaction
     (chunked) and anchor keys, extd2 and the traceback on its first align
     launch; extd2's score-only mode on phase 3e's launch, its own row of
     the kernels line, with its cell-updates/s; at phase 6b's shapes: the
     sketch (k15 w5, 512 x 1024), sort3, the chain, extd2 and the
     traceback on run (a)'s first batch and align launch, exts2 and the
     splice traceback on the first 32 jobs of run (b)'s first launch;
     sort3 on the keys phase 3g's rank 0 merged (256 x 2048, the first
     1024 kept), its own row of the kernels line (``sort3_shard_merge``),
     and the merge of those parts twice over in rows of two (the route
     past one sort row's width) bit-equal to one plain sort;
     at phase 3c's off-distribution shapes: the sketch at 256 x 32768,
     sort1 on the compaction keys (256 x 32768), sort3 on the anchor keys
     and the chain on the anchor planes (256 x 8192); sort1's chunked
     route in the compaction of a seeded 256 x 65536 batch, launches
     counted, bit-equal to sort1_rows_plain at full width, beside
     torch.sort; the modes no CLI path runs, each through its entry
     point with the launch counts of that run, bit-equal p and ez and
     its own row: extd2 on 64 ONT-like jobs at QP = TP 2048, W 640, RB
     128 (half with a target that turns random, zdrop 400) in exact-max
     right-aligned with p, exact-max score-only, and approx-drop
     right-aligned with p; exts2 on 32 cDNA-like jobs at QP 1024, TP 4096
     (half with a 500-base random query tail, zdrop 200) in exact-max with p and
     approx-drop right-aligned without p; at least one z-drop each, the
     count logged; and the wide route past one sort3 row (three stable
     torch.sort passes): the anchor sort at 64 x 32768 and a two-shard
     merge at A 16384, against the plain sort; the wide shapes, each
     through its entry point with its launch counted, bit-equal and its
     own row: extd2 at W 2048 and 4096 (the register route), 8192 (the
     slab route, approx and exact) on 16 ONT-like jobs and at W 640 on
     planes of QP = TP = 114688 (planes from device memory); exts2 at W
     8320 (approx; exact on the slab route) and 16512 (slab) on cDNA-like
     jobs and at TP 131072 on two jobs with an 80-120 kb intron, each
     launch's plain check on 1-4 of its jobs whose DP reaches a lane past
     the row's mark (lane_reach, wide_jobs), p and ez sliced from that
     launch (job_slice); the chain at WND 32, 128, 1000 and 5000 on phase
     3's first batch's anchors (plain on its first 32 reads); extd2 and
     the traceback on phase 6c's -a W 1152 first launch, exts2 and the
     splice traceback on its splice QP 4096 first launch (plain on 32 of
     its jobs past lane 1024 and 16 past lane 2176, sliced likewise)),
     timed with CUDA events;
     extd2's DP cell-updates/s as bench.py defines them;
     blocks per SM of every kernel, and the sketch's, sort3's and sort1's
     registers and spills (ptxas); the chain's longest read (valid
     anchors n, ns a step) and each traceback's longest walk (diagonals,
     ns a diagonal);
  8. where one 512-read batch spends its time, for the PAF and HPC paths
     (host read/encode/emit, device step with CUDA events and
     torch.profiler), the -a, splice and sr paired-end paths (mapping
     step, DP kernel launches, traceback, ops download, host regs, and
     the SAM emit, for sr with mm_pair);
  9. card vs CPU (plain versions): the first 128 reads of phases 3 and 5
     through PafStep give identical records, the first 4 reads of phase
     4 and the first 2 of phase 6 through their -a paths identical SAM,
     the first long read of phase 3d with one of its short reads through
     the PAF driver identical PAF, the first 16 pairs of phase 4b through
     ``engine.align_pairs`` identical SAM, likewise the first 16 pairs of
     phase 6b's run (a), the first 4 reads of phase 4c
     through its -a path identical SAM, the first 16 reads of phase 3e
     through ``map_batch`` identical dicts;
  9b. the CLI without --batch (the host mapping path, no kernel may
     launch): a 10 Mb cut of phase 3's first contig and 128 ONT-like reads
     (seed 11) through ``cli.main(["-c", "-x", "map-ont", "-t", "8", ...])``
     and with -t 1: byte-identical PAF, phase 3's accuracy gates; reads/s;
  9c. ``mappy.Aligner`` (map-ont) on 9b's cut with 16 of its reads: each
     read's primary hits equal its tp:A:P records in 9b's PAF (contig,
     reference and query interval, strand, mapq, CIGAR); no kernel may
     launch;
 10. the deferred checks: phase 7's plain versions that pay per
     anti-diagonal (the -a, sr, splice:sr and lr:hqae extd2 and traceback
     launches, the splice phase's whole exts2 launch and splice traceback,
     the whole mode part and the wide rows) run in four child processes
     (``chip_smoke.py --checks``, stopped if the run fails) beside phases
     9-9a, whose load is the host's; any mismatch there fails the run
     before the ``kernels`` JSON line, then the ``ok`` line.  The checks
     of the wide rows and of the three wide paths compare jobs sliced
     from the timed launch (its p rows and ez rows, and its traceback's
     ops and fin), chosen among the jobs whose DP reaches the row's wide
     lanes.
"""
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
NONTENSOR_OPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores
GENOME_LEN, N_CONTIGS, N_READS = 100_000_000, 8, 1024
SR_PAIRS, SR_LEN = 2048, 150
SSR_PAIRS = 2048
MB_READS, HOST_CUT, HOST_READS = 512, 10_000_000, 128
OFFDIST_READS, MAPPY_READS = 256, 16
# the kernels line's rows of phase 7's wide part at shapes no CLI preset
# passes (the three new paths' rows count their own runs' launches)
WIDE_ROWS = ("extd2_w2048", "extd2_w4096", "extd2_w8192", "extd2_exact_w8192",
             "extd2_gp", "exts2_w8320", "exts2_exact_w8320", "exts2_w16512",
             "exts2_gp", "chain_w32", "chain_w128", "chain_w1000",
             "chain_w5000", "extd2_w1152", "traceback_w1152", "exts2_w4224",
             "traceback_splice_w4224")
# the kernels line's rows of phase 7's mode part (no CLI path runs them)
MODE_ROWS = ("extd2_exact_right", "extd2_exact", "extd2_approx_right_adrop",
             "exts2_exact", "exts2_approx_right_adrop_nocigar", "sort3_wide",
             "sort3_shard_merge_wide")


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    """A check that holds under python -O too."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() on the current stream, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def max_abs_err(got, want):
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def max_abs_err_u8(got, want):
    """max |got - want| over uint8 (or same-typed) tensors, no widening."""
    return max(int((torch.maximum(g, w) - torch.minimum(g, w)).max())
               for g, w in zip(got, want))


def timed_once(fn):
    """(fn(), milliseconds) of one call, CUDA events."""
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def band_cells(lens, w, nr=None):
    """Cells the extd2 updates: per job, the band width en0 - st0 + 1 of
    every diagonal until the job's band ends or, given each job's EZ_NR,
    before that diagonal (a z-drop ends a job early); w None is exts2's
    unbanded DP."""
    tot = 0
    for i, (ql, tl) in enumerate(lens):
        r = np.arange(ql + tl - 1 if nr is None else int(nr[i]))
        st0 = np.maximum(0, r - ql + 1)
        en0 = np.minimum(tl - 1, r)
        if w is not None:
            st0 = np.maximum(st0, (r - w + 1) >> 1)
            en0 = np.minimum(en0, (r + w) >> 1)
        width = en0 - st0 + 1
        dead = np.flatnonzero(width <= 0)
        tot += int(width[:dead[0] if len(dead) else len(width)].sum())
    return tot


def longest_walk(ops):
    """Diagonals from a traceback walk's start to its last step, over the
    longest job of ops (N, RT)."""
    col = torch.arange(ops.shape[1], device=ops.device)
    nz = ops != 0
    hi = torch.where(nz, col, -1).amax(1)
    lo = torch.where(nz, col, ops.shape[1]).amin(1)
    return int(torch.where(hi >= 0, hi - lo + 1, 0).max())


def bound(nbytes, nops):
    """Least time (ms) for the work: bytes over the memory rate vs
    integer/float ops over the non-tensor rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / NONTENSOR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _extd2_bound(lens_t, w, nr=None, ops=40, with_p=True):
    """(band cells, bound ms, bound_by) of an extd2 launch on these jobs:
    what this run's data needs, one p byte a band cell (not the padded
    (N, RT, W) plane), the live query and target bytes, lens and ez; ops
    integer ops a cell (40; the exact mode's H row 8 more: its add, the
    maximum's compare and selects).  nr: each job's EZ_NR, where a
    z-drop ended it."""
    from minimap2_tpu_torch.ops import extend
    lh = lens_t.cpu().numpy().astype(np.int64)
    n, cells = len(lh), band_cells(lh, w, nr)
    nb = (cells if with_p else 0) + int(lh.sum()) + n * 8 \
        + n * extend.EZ_N * 4
    return (cells,) + bound(nb, ops * cells)


def _exts2_bound(lens_t, nr=None, ops=45, with_p=True):
    """(DP cells, bound ms, bound_by) of an exts2 launch on these jobs:
    what this run's data needs, one p byte a DP cell (not the padded
    (N, RT, W) plane the wrapper zero-fills, timed apart as memset_ms),
    each job's live query bytes and target, donor and acceptor bytes,
    lens and ez; ops integer ops a cell (45; the exact mode 8 more); nr
    as _extd2_bound's."""
    from minimap2_tpu_torch.ops import extend
    lh = lens_t.cpu().numpy().astype(np.int64)
    n, cells = len(lh), band_cells(lh, None, nr)
    live = int(lh[:, 0].sum()) + 3 * int(lh[:, 1].sum())
    nb = (cells if with_p else 0) + live + n * 8 + n * extend.EZ_N * 4
    return (cells,) + bound(nb, ops * cells)


def sketch_ops(w):
    """Integer ops a position that the sketch's function needs at least,
    whatever k: the rolling forward and reverse k-mer update and the last
    ambiguous code's position (11), the canonical select and hash64 (25),
    the flags z, valid, wok and is_mini (10), and ceil(log2 w) doubling
    levels each of the window minimum and of the maximum over the covering
    windows, a compare and a select a level (4 a level)."""
    return 46 + 4 * (w - 1).bit_length()


def sort_stages(A):
    lg = A.bit_length() - 1
    return lg * (lg + 1) // 2


def library_sort3(k1, k2, k3):
    """The yardstick the port never calls: a 3-pass stable torch.sort
    (least significant plane first) of the lexicographic u32 triple."""
    planes = [x.to(torch.int64) & 0xFFFFFFFF for x in (k1, k2, k3)]
    idx = None
    for x in reversed(planes):
        key = x if idx is None else torch.gather(x, 1, idx)
        order = torch.sort(key, dim=1, stable=True).indices
        idx = order if idx is None else torch.gather(idx, 1, order)
    return tuple(torch.gather(x, 1, idx) for x in planes)


class Deferred:
    """Plain-version checks of phase 7 that pay per anti-diagonal (the -a,
    sr and lr:hqae extd2 + traceback launches, the splice phase's whole
    exts2 launch, the mode part, the wide rows) run in four child
    processes (``chip_smoke.py --checks``) beside the card-vs-CPU phases:
    each job's inputs go to a file (and, for a check of jobs sliced from a
    timed launch, that launch's outputs for them), a child runs the kernel
    (where no outputs came) and the plain version and compares, and the results
    fill the kernel rows before the kernels line (a mismatch fails the run
    there), each row's max_abs_err then the largest of its parts'.  A
    dict of a row that waits for a result carries ``deferred: key:part``
    until then.  The kernels are launched, counted and timed in this
    process before the children start; the children take one thread
    each and end before phases 9b-9c time the host."""

    def __init__(self, tmp):
        self.tmp, self.jobs, self.procs = tmp, [], []

    def add(self, kind, cost, **spec):
        """A job of about ``cost`` plain diagonals; returns its key."""
        key = f"{kind}{len(self.jobs)}"
        path = os.path.join(self.tmp, f"check_{key}.pt")
        torch.save(dict(spec, kind=kind, key=key), path)
        self.jobs.append((cost, path))
        return key

    def start(self, n_proc=4):
        """The jobs, largest first, each to the child with less so far."""
        lists = [[0, []] for _ in range(n_proc)]
        for cost, path in sorted(self.jobs, reverse=True):
            lst = min(lists, key=lambda x: x[0])
            lst[0] += cost
            lst[1].append(path)
        for i, (_, paths) in enumerate(lists):
            out, lg = (os.path.join(self.tmp, f"checks{i}.{x}")
                       for x in ("json", "log"))
            with open(lg, "w") as f:
                self.procs.append((subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--checks",
                     out, *paths], stdout=f, stderr=subprocess.STDOUT),
                    out, lg))

    def __enter__(self):
        return self

    def __exit__(self, *exc):       # a failed run stops its children
        for proc, _, _ in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def finish(self, rows):
        results = []
        for proc, out, lg in self.procs:
            rc = proc.wait(timeout=1200)
            with open(lg) as f:
                for ln in f:
                    log(ln.rstrip("\n"))
            require(rc == 0, f"a deferred checks' child exited with {rc}")
            with open(out) as f:
                results += json.load(f)
        require(len(results) == len(self.jobs), "a deferred check is missing")
        done = {}
        for r in results:
            for part, vals in r.items():
                if isinstance(vals, dict):
                    require(vals["max_abs_err"] == 0, f"{r['key']} {part} "
                            f"differs from its plain version ({vals})")
                    done[f"{r['key']}:{part}"] = vals

        def fill(d):
            if isinstance(d, dict):
                if "deferred" in d:
                    d.update(done[d.pop("deferred")])
                for v in d.values():
                    fill(v)
        for row in rows:
            fill(row)
            row["max_abs_err"] = worst_err(row)


def worst_err(d):
    """The largest max_abs_err of d and of every part of it."""
    return max([d.get("max_abs_err", 0)] + [
        worst_err(v) for v in d.values() if isinstance(v, dict)])


DEFER = None        # main's Deferred; phase functions check inline without


def plain_note(x):
    """A plain version's time for a log line, or where it went."""
    if x.get("plain_ms") is None:
        return "plain version in the deferred checks"
    return f"plain {x['plain_ms']:.0f} ms on {x.get('plain_jobs', '')} jobs"


def run_checks(out, jobs):
    """The child of Deferred: each job's check, its results to out (the
    kernels load from the build the parent made; one thread: the plain
    versions run on the card, and the host phases beside them want the
    cores)."""
    torch.set_num_threads(1)
    results = []
    for path in jobs:
        spec = torch.load(path)
        t = time.time()
        if spec["kind"] == "extd2_tb":
            ext, tb = _extd2_tb_plain(spec["args"], spec["kw"], spec["n_p"],
                                      sl=spec.get("sl"))
            r = dict(ext=ext, tb=tb)
        elif spec["kind"] == "exts2_launch":
            ext, tb = _exts2_launch_plain(spec["args"], spec["kw"],
                                          sl=spec.get("sl"))
            r = dict(launch_ext=ext, launch_tb=tb)
        elif spec["kind"] == "slice":
            r = dict(dp=_slice_plain(spec["dp"], spec["args"], spec["kw"],
                                     spec["m"], spec["sl"]))
        elif spec["kind"] == "chain":
            r = dict(chain=_chain_plain(spec["args"], spec["kw"]))
        else:
            r = dict(dp=_mode_plain(spec["dp"], spec["args"], spec["kw"],
                                    spec["m"], ez_main=spec["ez"],
                                    plain_dev=spec.get("plain_dev")))
        results.append(dict(r, key=spec["key"]))
        log(f"[deferred] {spec['key']}: {time.time() - t:.1f}s "
            + ", ".join(f"{k} {v}" for k, v in r.items()))
        del spec
        torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump(results, f)


def reader_check(tag):
    """The CLI phases read FASTA/FASTQ through the native scanner
    (native.fastx_scan), never the Python parser: the host library must
    have loaded."""
    from minimap2_tpu_torch import native
    from minimap2_tpu_torch.io import fastx
    require(native.available(), "the native host library did not load")
    log(f"[reader] {tag}: native.fastx_scan calls {fastx.routes['native']}, "
        f"records parsed in Python {fastx.routes['python']}")
    require(fastx.routes["native"] > 0 and fastx.routes["python"] == 0,
            f"{tag} did not read through native.fastx_scan only "
            f"({dict(fastx.routes)})")


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    return smi.splitlines()[0]


def phase_build():
    from minimap2_tpu_torch.ops import _build
    t0 = time.time()
    _build.lib()
    dt = time.time() - t0
    usage = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or ln.startswith("==")]
    log(f"[build] kernels built and loaded in {dt:.1f}s "
        f"(nvcc {_build.build_seconds:.1f}s)")
    from minimap2_tpu_torch import native
    t0 = time.time()
    native.map_lib()
    log(f"[build] host library (native/host_map.cpp: the index build's "
        f"sketch and radix sort, the host path) built and loaded in "
        f"{time.time() - t0:.1f}s")
    for ln in usage:
        log(f"[build]   {ln}")


def phase_main_path(tmp):
    from minimap2_tpu_torch.utils.simgenome import (simulate_genome,
                                                    simulate_reads,
                                                    write_fasta)
    t0 = time.time()
    names, seqs = simulate_genome(GENOME_LEN, N_CONTIGS, 7)
    rnames, reads = simulate_reads(seqs, N_READS, np.random.default_rng(1),
                                   name_seqs=names)
    ref, rd, paf = (os.path.join(tmp, f) for f in
                    ("ref.fa", "reads.fa", "out.paf"))
    write_fasta(ref, names, seqs)
    write_fasta(rd, rnames, reads)
    # phase 5's PacBio-CLR-like reads and phase 6's spliced world
    hnames, hreads = simulate_reads(seqs, N_READS, np.random.default_rng(2),
                                    sub=0.02, dele=0.03, ins=0.05,
                                    name_seqs=names)
    hpc_rd = os.path.join(tmp, "hpc_reads.fa")
    write_fasta(hpc_rd, hnames, hreads)
    gseqs, gnames, greads, introns = simulate_spliced(
        names, seqs, N_READS, np.random.default_rng(4))
    spl_ref, spl_rd = (os.path.join(tmp, f) for f in
                       ("splice_ref.fa", "splice_reads.fa"))
    write_fasta(spl_ref, names, gseqs)
    write_fasta(spl_rd, gnames, greads)
    # phase 6b's splice:sr pairs from the same genes, and their BED12
    ssr_names, ssr1, ssr2, ssr_truth, ssr_bed = simulate_splice_sr_pairs(
        names, gseqs, gnames, introns, SSR_PAIRS, np.random.default_rng(12))
    ssr_rd = [os.path.join(tmp, f"ssr_r{e}.fq") for e in (1, 2)]
    for path, e, ends in zip(ssr_rd, (1, 2), (ssr1, ssr2)):
        write_fastq(path, [f"{nm}/{e}" for nm in ssr_names], ends)
    ssr_anno = os.path.join(tmp, "ssr_anno.bed")
    with open(ssr_anno, "w") as f:
        f.write("\n".join(ssr_bed) + "\n")
    # phase 4b's short-read pairs
    sr_names, sr1, sr2 = simulate_sr_pairs(names, seqs, SR_PAIRS,
                                           np.random.default_rng(8))
    sr_rd = [os.path.join(tmp, f"sr_r{e}.fq") for e in (1, 2)]
    for path, e, ends in zip(sr_rd, (1, 2), (sr1, sr2)):
        write_fastq(path, [f"{nm}/{e}" for nm in sr_names], ends)
    sr_lens = {(nm, e): len(x) for e, ends in ((1, sr1), (2, sr2))
               for nm, x in zip(sr_names, ends)}
    # phase 4c's ONT Q20-like reads, phase 3e's short ONT-like reads and
    # phase 9b's world (a 10 Mb cut of the first contig and its reads)
    qnames, qreads = simulate_reads(seqs, N_READS, np.random.default_rng(9),
                                    sub=0.005, dele=0.0025, ins=0.0025,
                                    name_seqs=names)
    q_rd = os.path.join(tmp, "q20_reads.fa")
    write_fasta(q_rd, qnames, qreads)
    mb_names, mb_reads = simulate_reads(seqs, MB_READS,
                                        np.random.default_rng(10),
                                        min_len=1200, max_len=2000,
                                        name_seqs=names)
    cut_name = [names[0]]
    cut_names, cut_reads = simulate_reads([seqs[0][:HOST_CUT]], HOST_READS,
                                          np.random.default_rng(11),
                                          name_seqs=cut_name)
    cut_ref, cut_rd = (os.path.join(tmp, f) for f in ("cut.fa", "cut_reads.fa"))
    write_fasta(cut_ref, cut_name, [seqs[0][:HOST_CUT]])
    write_fasta(cut_rd, cut_names, cut_reads)
    log(f"[main] simulated {GENOME_LEN / 1e6:.0f} Mb genome + {N_READS} "
        f"ONT-like, {N_READS} PacBio-like, {N_READS} cDNA and {N_READS} "
        f"ONT Q20-like reads, {SR_PAIRS} short-read pairs, {SSR_PAIRS} "
        f"splice:sr pairs, {MB_READS} "
        f"short ONT-like reads and a {HOST_CUT / 1e6:.0f} Mb cut with "
        f"{HOST_READS} reads in {time.time() - t0:.1f}s")
    del reads, hreads, gseqs, greads, sr1, sr2, qreads, ssr1, ssr2

    from minimap2_tpu_torch import cli
    from minimap2_tpu_torch.index.mmi import load_mmi
    from minimap2_tpu_torch.parallel import batch, engine
    comp, anch, sk, dump = {}, {}, {}, {}
    mmi = os.path.join(tmp, "main.mmi")
    run = _paf_run("main", ["--batch", "-x", "map-ont", "-d", mmi, "-o", paf,
                            ref, rd],
                   ("sketch", "sort3", "sort3_merge", "chain"),
                   [_capture_first(batch, "sort3_chunked", comp),
                    _capture_first(batch, "sort3_rows", anch),
                    _capture_first(engine, "sketch_batch", sk),
                    _timer(cli, "dump_mmi", dump)])
    paf_accuracy("main", paf, rnames)
    mapeval_rows("main", paf)
    t = time.time()
    loaded = load_mmi(mmi)
    load_s = time.time() - t
    same_index("main", loaded, run["mi"])
    log(f"[main] -d {os.path.getsize(mmi) / 1e6:.1f} MB .mmi: dump "
        f"{dump['seconds']:.2f}s, load {load_s:.2f}s; equal to the host "
        "MiniIndex array for array")
    return dict(run, rd=rd, ref=ref, rnames=rnames, hpc_rd=hpc_rd, paf=paf,
                mmi=mmi, mmi_s=dict(dump=dump["seconds"], load=load_s),
                ssr_names=ssr_names, ssr_rd=ssr_rd, ssr_truth=ssr_truth,
                ssr_bed=ssr_anno,
                genome=(names, seqs),
                compaction_keys=comp["args"], anchor_keys=anch["args"],
                sketch_in=sk["args"],
                hnames=hnames, spl_ref=spl_ref, spl_rd=spl_rd, gnames=gnames,
                introns=introns, sr_rd=sr_rd, sr_names=sr_names,
                sr_lens=sr_lens, q_rd=q_rd, qnames=qnames,
                mb_names=mb_names, mb_reads=mb_reads, cut_ref=cut_ref,
                cut_rd=cut_rd, cut_names=cut_names)


def _timer(mod, name, store):
    """A hook for mod.name that records its seconds in store."""
    fn = getattr(mod, name)

    def timing(*args, **kw):
        t = time.time()
        out = fn(*args, **kw)
        store["seconds"] = time.time() - t
        return out
    return mod, name, timing


def same_index(tag, a, b):
    """Fail unless two MiniIndexes hold the same arrays (keys, run starts,
    positions, reference codes; values and dtypes) and sequence names and
    lengths."""
    require([(s.name, s.length) for s in a.seq] ==
            [(s.name, s.length) for s in b.seq],
            f"{tag}: the .mmi's names or lengths differ")
    for x in ("keys", "starts", "pos", "S"):
        ax, bx = getattr(a, x), getattr(b, x)
        require(ax.dtype == bx.dtype and np.array_equal(ax, bx),
                f"{tag}: the .mmi's {x} differ from the host index's")


@contextlib.contextmanager
def _env(**env):
    """Environment variables set for a block, restored after it."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def describe_index(di):
    """A DeviceIndex's probe layout, its aux ints that shape the probe and
    the MB of each of its tables."""
    from minimap2_tpu_torch.parallel import batch
    mb = {n: round(t.numel() * t.element_size() / 1e6, 1)
          for n, t in di.named_buffers()}
    return (f"{batch.probe_layout(di)} layout (h2r_nb {di.h2r_nb}, h2_nb "
            f"{di.h2_nb}, probe_win {di.probe_win}, key_shift "
            f"{di.key_shift}, n_probe {di.n_probe}), tables in MB {mb}")


def _build_on_card(tag, names, parts, w, k, **kw):
    """build_device_index on the card with its sketch launches counted
    (counts set to 0 just before, read just after) and its first sketch
    call's inputs captured; logs the stages, the peak device memory above
    what was held before, and the counts."""
    from minimap2_tpu_torch.ops._build import launches
    from minimap2_tpu_torch.parallel import devbuild
    sk = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    with _hooked([_capture_first(devbuild, "sketch_batch", sk)]):
        di, meta = devbuild.build_device_index(names, parts, w, k,
                                               device="cuda", **kw)
        torch.cuda.synchronize()
    counts = dict(launches)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    require(counts.get("sketch", 0) > 0,
            f"kernel sketch never launched in the {tag} index build")
    stages = {n: round(t, 3) for n, t in meta.stage_s.items()}
    log(f"[{tag}] device index build: {stages} s; peak device memory "
        f"{peak_gb:.2f} GB above the {base / 1e9:.2f} GB held before; "
        f"pos_fmt {di.pos_fmt}, s_fmt {di.s_fmt}, {describe_index(di)}; "
        f"n_mini {meta.n_mini}, distinct {meta.n_distinct}, mid_occ "
        f"{meta.mid_occ}; launches {counts}")
    return di, meta, dict(stages=stages, peak_gb=peak_gb, launches=counts,
                          sketch_in=sk["args"], n_mini=meta.n_mini,
                          n_distinct=meta.n_distinct, mid_occ=meta.mid_occ)


def _map_on_card(tag, step, mi, rd, out_path, batch_reads=512,
                 kernels=("sketch", "sort3", "sort3_merge", "chain")):
    """engine.map_queries in batch_reads-read batches with the launches
    counted around it; fails unless the path's kernels launched."""
    from minimap2_tpu_torch.ops._build import launches
    from minimap2_tpu_torch.parallel import engine
    torch.cuda.synchronize()
    launches.clear()
    t = time.time()
    with open(out_path, "w") as out, torch.no_grad():
        n = engine.map_queries(step, mi, [rd], out, batch_reads)
    torch.cuda.synchronize()
    map_s = time.time() - t
    counts = dict(launches)
    for name in kernels:
        require(counts.get(name, 0) > 0,
                f"kernel {name} never launched on the {tag} mapping")
    log(f"[{tag}] mapped {n} reads in {map_s:.2f}s ({n / map_s:.1f} reads/s"
        f", the first batch with its warm-up); launches {counts}")
    return dict(n=n, map_s=map_s, reads_per_s=n / map_s, launches=counts)


def phase_devbuild(main, tmp):
    """Phase 3's genome indexed on the card; held against phase 3's host
    index and its PAF.  Then the same genome under MM2TPU_DEVBUILD_H2R=0
    (the krows layout), held to the host index with every key, and phase
    3's reads mapped through it (``_map_layout``)."""
    from minimap2_tpu_torch.parallel import batch, devbuild, engine
    names, seqs = main.pop("genome")
    mi = main["mi"]
    di, meta, info = _build_on_card("devbuild", names, list(seqs), mi.w,
                                    mi.k)
    t = time.time()
    step = main["step"]
    # the h2r table equals the one phase 3 built from the host index (the
    # same keys dropped, <= 1e-6 of them); decoded, every key it holds has
    # the host's run, and pos2 the host's positions
    require(di.h2r_nb == step.di.h2r_nb and torch.equal(di.h2r, step.di.h2r),
            "the device-built h2r table differs from phase 3's")
    keys, starts, counts, pos = devbuild.host_tables(di, meta)
    require(meta.n_mini == len(mi.pos) and meta.n_distinct == len(mi.keys),
            f"device build counts {meta.n_mini} / {meta.n_distinct}, host "
            f"{len(mi.pos)} / {len(mi.keys)}")
    at = np.minimum(np.searchsorted(mi.keys, keys), len(mi.keys) - 1)
    require(np.array_equal(mi.keys[at], keys), "device-built keys differ")
    require(np.array_equal(mi.starts[at], starts)
            and np.array_equal(np.minimum(np.diff(mi.starts)[at], 63),
                               np.minimum(counts, 63)),
            "device-built runs differ")
    require(np.array_equal(pos, mi.pos), "device-built positions differ")
    require(meta.mid_occ == mi.cal_max_occ(2e-4),
            f"device-built mid_occ {meta.mid_occ} != {mi.cal_max_occ(2e-4)}")
    dropped = np.delete(mi.keys, at)
    log(f"[devbuild] h2r table equal to phase 3's; its {len(keys)} keys "
        f"({len(dropped)} dropped, as in phase 3's: {dropped.tolist()}), "
        f"their runs and all {len(pos)} positions equal phase 3's host "
        f"index, mid_occ {meta.mid_occ} (checked in {time.time() - t:.1f}s)")
    dstep = engine.PafStep(di, step.p, step.K, step.min_sc)
    paf = os.path.join(tmp, "devbuild.paf")
    run = _map_on_card("devbuild", dstep, meta.seq_table(), main["rd"], paf)
    with open(paf, "rb") as a, open(main["paf"], "rb") as b:
        same = a.read() == b.read()
    require(same, "PAF through the device-built index differs from phase 3's")
    log("[devbuild] PAF through the device-built index byte-identical to "
        "phase 3's")
    # the krows layout of the same genome, before the genome goes
    with _env(MM2TPU_DEVBUILD_H2R="0"):
        kdi, kmeta, kinfo = _build_on_card("devbuild krows", names,
                                           list(seqs), mi.w, mi.k)
    del seqs, kinfo["sketch_in"]
    require(batch.probe_layout(kdi) == "krows" and kdi.probe_win == 2,
            f"MM2TPU_DEVBUILD_H2R=0 built the {batch.probe_layout(kdi)} "
            f"layout, probe_win {kdi.probe_win}")
    t = time.time()
    keys, starts, counts, pos = devbuild.host_tables(kdi, kmeta)
    require(np.array_equal(keys, mi.keys)
            and np.array_equal(starts, mi.starts[:-1])
            and np.array_equal(counts, np.diff(mi.starts))
            and np.array_equal(pos, mi.pos) and kmeta.mid_occ == meta.mid_occ,
            "the krows index's keys, runs, positions or mid_occ differ from "
            "phase 3's host index")
    log(f"[devbuild krows] all {len(keys)} keys, their runs and all "
        f"{len(pos)} positions equal phase 3's host index, mid_occ "
        f"{kmeta.mid_occ} (checked in {time.time() - t:.1f}s)")
    kruns = _map_layout("devbuild krows", kdi, kmeta.seq_table(), main,
                        dropped, tmp)
    return dict(info, map=run, di=di, contigs=list(names), dropped=dropped,
                krows=dict(kinfo, di=kdi, runs=kruns))


def _paf_records(path):
    """A PAF's lines grouped by query name."""
    recs = {}
    with open(path) as f:
        for ln in f:
            recs.setdefault(ln.split("\t", 1)[0], []).append(ln)
    return recs


def _map_layout(tag, di, seq_mi, main, dropped, tmp):
    """Phase 3's reads through a PafStep on another layout of phase 3's
    index, the PAF held to phase 3's.  Phase 3's stride-2 h2r rows clamp a
    count at 63, so that index skips seeds of more than 62 occurrences
    whatever occ_cap says, and its build dropped a few keys; a layout with
    exact counts and every key does neither.  So the reads are mapped at
    that cap, min(occ_cap, 62), where a read's PAF may differ from phase
    3's only if the read holds a dropped key, and at phase 3's occ_cap,
    where it may also differ if it holds a key of 63..occ_cap occurrences.
    Each such read is named (its keys from the host sketch)."""
    from minimap2_tpu_torch import native
    from minimap2_tpu_torch.io.fastx import read_fasta
    from minimap2_tpu_torch.parallel import batch, engine
    from minimap2_tpu_torch.utils.intfloat import SEQ_NT4
    step, mi = main["step"], main["mi"]
    p = step.p
    cap = p.occ_cap
    if step.di.h2r.shape[1] == 2 * batch.H2R_SLOTS:
        cap = min(cap, batch.H2R2_OCC_CAP)
    cnt = np.diff(mi.starts)
    many = mi.keys[(cnt > cap) & (cnt <= p.occ_cap)]
    want = _paf_records(main["paf"])
    reads = dict(zip(*read_fasta(main["rd"])))
    out = []
    for c, allowed, why in (
            (cap, dropped, "a key the h2r build dropped"),
            (p.occ_cap, np.union1d(dropped, many),
             f"a dropped key or one of {cap + 1}..{p.occ_cap} occurrences")):
        paf = os.path.join(tmp, f"{tag.replace(' ', '_')}_{c}.paf")
        run = _map_on_card(f"{tag}, occ_cap {c}", engine.PafStep(
            di, dataclasses.replace(p, occ_cap=c), step.K, step.min_sc),
            seq_mi, main["rd"], paf)
        got = _paf_records(paf)
        diff = sorted(n for n in set(got) | set(want)
                      if got.get(n) != want.get(n))
        bad = [n for n in diff if not np.isin(native.sketch(
            SEQ_NT4[np.frombuffer(reads[n], np.uint8)], mi.w, mi.k, 0,
            False)[0] >> np.uint64(8), allowed).any()]
        require(not bad, f"{tag}, occ_cap {c}: the PAF of {len(bad)} reads "
                f"differs from phase 3's without {why}: {bad[:8]}")
        log(f"[{tag}] occ_cap {c}: PAF equal to phase 3's on "
            f"{len(reads) - len(diff)} reads; {len(diff)} differ, each "
            f"holding {why}: {diff}")
        out.append(dict(run, occ_cap=c, differing=diff))
        if c == p.occ_cap:
            break
    return out


def phase_layouts(main, dvb, tmp):
    """Phase 3f: phase 3's host index as the h2 layout with pos_fmt 0 and
    s_fmt 1 (MM2TPU_H2R=0, MM2TPU_PACK_S=1, force_pos_fmt=0), phase 3's
    reads mapped through it (``_map_layout``); then the probe of four
    layouts timed on phase 3's first compacted minimizers (512 x 4096):
    h2r (phase 3's), h2 (with phase 3's pos_fmt 1 tables), krows (phase
    3b's) and h2 with pos_fmt 0, each as the whole _lookup_anchors and as
    the probe alone; the last three give equal anchor planes."""
    from minimap2_tpu_torch.ops.sketch import sketch_batch
    from minimap2_tpu_torch.parallel import batch, engine
    from minimap2_tpu_torch.parallel.batch import DeviceIndex
    mi, step = main["mi"], main["step"]
    p = step.p
    torch.cuda.synchronize()
    t = time.time()
    with _env(MM2TPU_H2R="0", MM2TPU_PACK_S="1"):
        di = DeviceIndex.from_host(mi, "cuda", force_pos_fmt=0)
    torch.cuda.synchronize()
    build_s = time.time() - t
    require(batch.probe_layout(di) == "h2" and (di.pos_fmt, di.s_fmt)
            == (0, 1), "MM2TPU_H2R=0 / MM2TPU_PACK_S=1 / force_pos_fmt=0 "
            f"built {batch.probe_layout(di)}, pos_fmt {di.pos_fmt}, s_fmt "
            f"{di.s_fmt}")
    log(f"[layouts] h2 index (pos_fmt 0, s_fmt 1) from phase 3's host index "
        f"in {build_s:.2f}s: {describe_index(di)}")
    runs = _map_layout("layouts h2", di, mi, main, dvb["dropped"], tmp)
    # the probe timings; h2 with pos_fmt 1 takes phase 3's position tables
    h2f1 = DeviceIndex.from_tensors(
        dict({n: getattr(di, n) for n in ("keys2", "sc2", "bucket_start",
                                          "h2")},
             **{n: getattr(step.di, n) for n in ("pos2", "pstrand", "S",
                                                 "seq_off", "seq_len",
                                                 "rtab")}),
        dict(di.aux_dict(), pos_fmt=step.di.pos_fmt, s_fmt=step.di.s_fmt,
             rtab_on=step.di.rtab_on))
    kdi = dvb["krows"].pop("di")
    packed, nbits, lens = (x.cuda() for x in
                           _first_batch(step, main["rd"], 512))
    with torch.no_grad():
        codes = engine.unpack_codes(packed, nbits, p.L)
        front = batch._compact_minimizers(
            *sketch_batch(codes, lens, p.k, p.w), p.M)
        mh_hi, mh_lo, _, _, mvalid = front
        probes, planes = {}, {}
        for name, d in (("h2r", step.di), ("h2", h2f1), ("krows", kdi),
                        ("h2 pos_fmt 0", di)):
            planes[name] = batch._lookup_anchors(d, *front, lens, p)
            probes[name] = dict(
                lookup_ms=cuda_ms(lambda d=d: batch._lookup_anchors(
                    d, *front, lens, p), reps=5),
                probe_ms=cuda_ms(lambda d=d: batch.probe_seeds(
                    d, mh_hi, mh_lo, mvalid, p.occ_cap), reps=5))
    for name in ("krows", "h2 pos_fmt 0"):
        require(all(torch.equal(a, b) for a, b in
                    zip(planes[name], planes["h2"])),
                f"the {name} anchors differ from the h2 layout's")
    log(f"[layouts] _lookup_anchors on phase 3's first compacted minimizers "
        f"{tuple(mh_lo.shape)} (A {p.A}, occ_cap {p.occ_cap}; h2, krows and "
        f"h2 pos_fmt 0 give equal anchors), ms whole / probe alone: "
        + ", ".join(f"{n} {v['lookup_ms']:.4f} / {v['probe_ms']:.4f}"
                    for n, v in probes.items()))
    del di, h2f1, kdi, planes, front, codes
    torch.cuda.empty_cache()
    return dict(build_s=build_s, runs=runs, probes=probes)


def _truth_ok(name, contigs, rid, rev, rs, re_):
    """A mapping (contig index, strand, [rs, re)) on the simulated read's
    source interval."""
    _, chrom, st, en, strand = name.split("!")
    return (contigs[rid] == chrom and rev == (strand == "-")
            and rs < int(en) and re_ > int(st))


def phase_map_batch(main, dvb):
    """Phase 3e: the one-call device step ``batch.map_batch`` on phase 3b's
    device-built index, 512 short ONT-like reads in one batch at the
    port's BatchParams defaults; the chain scan's seconds, extd2's first
    (score-only) launch for phase 7."""
    from minimap2_tpu_torch.ops._build import launches
    from minimap2_tpu_torch.parallel import batch, engine
    p = batch.BatchParams()
    di = dvb["di"]
    require((p.k, p.w) == (15, 10), "phase 3b's index is k15 w10")
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    reads = main["mb_reads"]
    codes, lens = engine.encode_batch([acgt[r].tobytes() for r in reads],
                                      p.L)
    require((lens == [len(r) for r in reads]).all(),
            "a map_batch read does not fit L")
    c_t, l_t = (torch.from_numpy(x).cuda() for x in (codes, lens))
    job, scans = {}, []
    torch.cuda.synchronize()
    launches.clear()
    t = time.time()
    with _hooked([_capture_first(batch, "extd2_batch2", job),
                  _scan_timer(batch, scans)]), torch.no_grad():
        out = batch.map_batch(di, c_t, l_t, p)
        torch.cuda.synchronize()
    cold_s = time.time() - t
    counts = dict(launches)
    # the rate from a second call on the same inputs: the first pays the
    # first-call costs (kernel loads, the allocator's growth)
    t = time.time()
    with _hooked([_scan_timer(batch, scans)]), torch.no_grad():
        again = batch.map_batch(di, c_t, l_t, p)
        torch.cuda.synchronize()
    map_s = time.time() - t
    require(all(torch.equal(out[k], again[k]) for k in out),
            "map_batch's second call differs from its first")
    for name in ("sketch", "sort3", "extd2"):
        require(counts.get(name, 0) > 0,
                f"kernel {name} never launched in map_batch")
    require(counts.get("chain", 0) == 0,
            "the chain kernel launched in map_batch (the JAX package's "
            "step chains with the scan)")
    o = {k: v.cpu().numpy() for k, v in out.items()}
    contigs = dvb["contigs"]
    n_ok = sum(bool(o["mapped"][i]) and _truth_ok(
        nm, contigs, int(o["rid"][i]), int(o["rev"][i]), int(o["rs"][i]),
        int(o["re"][i])) for i, nm in enumerate(main["mb_names"]))
    n_mapped = int(o["mapped"].sum())
    n_ext = int((o["ext_score"][o["mapped"]] > 0).sum())
    frac = n_ok / len(main["mb_names"])
    log(f"[map_batch] {len(codes)} reads ({int(lens.min())}-"
        f"{int(lens.max())} bp) in one call: the first {cold_s:.3f}s, a "
        f"second on the same inputs {map_s:.3f}s ({len(codes) / map_s:.1f} "
        f"reads/s); its chain scan {scans[1][0]:.3f}s ({scans[1][1]} "
        f"steps); "
        f"{n_ok} ({100 * frac:.1f}%) on their contig, strand and source "
        f"interval; {n_mapped} mapped, {n_ext} of them with ext_score > 0;"
        f" launches {counts}")
    require(frac >= 0.90, f"map_batch: only {100 * frac:.1f}% of reads "
            "correct")
    require(n_ext == n_mapped, f"map_batch: {n_mapped - n_ext} mapped reads "
            "with ext_score <= 0")
    return dict(p=p, di=di, codes=codes, lens=lens, out=o, launches=counts,
                map_s=map_s, cold_s=cold_s, scan_s=scans[1][0],
                first_job=job,
                reads_per_s=len(codes) / map_s, correct=frac)


def phase_sharded(main, mb, tmp, n_cpu=16):
    """Phase 3g: the sharded step at full width.  Phase 3's host index is
    split into two key-range shards (``from_host(mi, n_shards=2,
    cache=...)``); four gloo ranks share the card at (data=2, idx=2), each
    loading only its shard from the .npz, and map phase 3e's 512 reads
    (256 a data row) at the BatchParams defaults, twice; sketch, sort3,
    the shard merge's sort3 and extd2 must launch in every rank and the
    chain kernel in none.  The gathered output must equal map_batch on
    phase 3's one-shard index (phase 3's PafStep's) on every read whose
    one-shard anchor count is at most A (the reads above are counted and
    named); its first n_cpu reads must equal the same step run by four
    gloo ranks on the CPU (plain versions); then a 1-rank NCCL group runs
    the step at (1, 1) on all reads, equal to map_batch."""
    import dataclasses

    from minimap2_tpu_torch.parallel import batch, ranks, sharded
    p = batch.BatchParams()
    mi, di1 = main["mi"], main["step"].di
    require((p.k, p.w) == (mi.k, mi.w), "phase 3's index is k15 w10")
    cache = os.path.join(tmp, "main.idx2.npz")
    t = time.time()
    shards = batch.DeviceIndex.from_host(mi, "cpu", n_shards=2, cache=cache)
    split_s = time.time() - t
    K = len(mi.keys)
    for i, sh in enumerate(shards):
        nbytes = {n: t_.numel() * t_.element_size()
                  for n, t_ in sh.named_buffers()}
        log(f"[sharded] shard {i}: keys {(i + 1) * K // 2 - i * K // 2} of "
            f"{K}, {batch.probe_layout(sh)} rows {sh.h2r_nb}, tables "
            f"{sum(nbytes.values()) / 1e6:.1f} MB "
            f"({ {n: round(b / 1e6, 1) for n, b in nbytes.items()} })")
    del shards
    log(f"[sharded] from_host(n_shards=2) of phase 3's index and its .npz "
        f"({os.path.getsize(cache) / 1e6:.1f} MB) in {split_s:.1f}s")
    codes, lens = mb["codes"], mb["lens"]
    reads = os.path.join(tmp, "sharded_reads.npz")
    np.savez(reads, codes=codes, lens=lens)
    run = dict(tag="3g", cache=cache, reads=reads,
               params=dataclasses.asdict(p), repeat=2, dump_merge=True)
    job = dict(n_data=2, n_idx=2, device="cuda", runs=[run],
               out=os.path.join(tmp, "sharded_cuda"))
    t = time.time()
    reports = ranks.spawn_ranks(job, timeout=420)
    spawn_s = time.time() - t
    got = ranks.load_result(job, 0)
    for rep in reports:
        r0 = rep["runs"][0]
        first = r0["launches"][0]
        for name in ("sketch", "sort3", "sort3_shard_merge", "extd2"):
            require(first.get(name, 0) > 0, f"kernel {name} never launched "
                    f"in rank {rep['rank']} of the sharded step")
        require(first.get("chain", 0) == 0, f"the chain kernel launched in "
                f"rank {rep['rank']} of the sharded step")
        log(f"[sharded] rank {rep['rank']} on {rep['device']}: shard load "
            f"{r0['load_s']:.2f}s, step {r0['seconds'][0]:.3f}s then "
            f"{r0['seconds'][1]:.3f}s, collectives {r0['coll_s'][0]:.3f}s "
            f"then {r0['coll_s'][1]:.3f}s, peak device memory "
            f"{r0['peak_gb']:.2f} GB, {r0['n_anc_local']} anchors; launches"
            f" {first}")
    # the reference: map_batch on phase 3's one-shard index
    c_t, l_t = (torch.from_numpy(x).cuda() for x in (codes, lens))
    with torch.no_grad():
        ref = batch.map_batch(di1, c_t, l_t, p)
        hhi, hlo, z, mini = batch.sketch_batch(c_t, l_t, p.k, p.w)
        front = batch._compact_minimizers(hhi, hlo, z, mini, p.M)
        _s, cnt, _f = batch.probe_seeds(di1, front[0], front[1], front[4],
                                        p.occ_cap)
    ref = {k: v.cpu().numpy() for k, v in ref.items()}
    total0 = cnt.sum(1).cpu().numpy()
    over = np.flatnonzero(total0 > p.A)
    under = total0 <= p.A
    for f in sharded.OUT_FIELDS:
        bad = np.flatnonzero(under & (got[f] != ref[f]))
        require(len(bad) == 0, f"sharded step: {f} differs from map_batch on"
                f" {len(bad)} reads at or under A anchors (first "
                f"{bad[:8].tolist()})")
    n_mapped = int(got["n_mapped"])
    require(n_mapped == int((got["chain_score"] > 0).sum()),
            f"sharded n_mapped {n_mapped} is not the gathered mapped count")
    diff_over = [int(i) for i in over if any(
        got[f][i] != ref[f][i] for f in sharded.OUT_FIELDS)]
    names = [main["mb_names"][i].split("!")[0] for i in over]
    log(f"[sharded] gathered output equal to map_batch on the "
        f"{int(under.sum())} reads at or under A={p.A} anchors; "
        f"{len(over)} reads above A (total0 {total0[over].tolist()}: "
        f"{names}), {len(diff_over)} of them differing; n_mapped "
        f"{n_mapped}")
    # the same step on the CPU (plain versions) for the first n_cpu reads
    creads = os.path.join(tmp, "sharded_reads_cpu.npz")
    np.savez(creads, codes=codes[:n_cpu], lens=lens[:n_cpu])
    cjob = dict(n_data=2, n_idx=2, device="cpu", threads=2,
                runs=[dict(run, reads=creads, repeat=1, dump_merge=False)],
                out=os.path.join(tmp, "sharded_cpu"))
    t = time.time()
    ranks.spawn_ranks(cjob, timeout=420)
    cpu_s = time.time() - t
    cgot = ranks.load_result(cjob, 0)
    for f in sharded.OUT_FIELDS:
        require(np.array_equal(cgot[f], got[f][:n_cpu]), f"sharded step: "
                f"{f} of the first {n_cpu} reads differs between card and "
                "CPU")
    log(f"[sharded] the first {n_cpu} reads through four CPU gloo ranks "
        f"(plain versions, {cpu_s:.1f}s with start-up): equal to the card's")
    # the (2, 2) anchor counts and the idx balance
    n_anc = got["n_anc"]
    per_idx = n_anc.sum(axis=0).astype(np.float64)
    bal = float(per_idx.max() / max(1.0, per_idx.mean()))
    step_s = max(rep["runs"][0]["seconds"][1] for rep in reports)
    coll_s = max(rep["runs"][0]["coll_s"][1] for rep in reports)
    log(f"[sharded] (data=2, idx=2): anchors {n_anc.tolist()}, per idx "
        f"{per_idx.astype(int).tolist()}, max/mean {bal:.3f}; the second "
        f"call {step_s:.3f}s on the slowest rank ({len(codes) / step_s:.1f} "
        f"reads/s), its collectives at most {coll_s:.3f}s a rank; the "
        f"four ranks' spawn to exit {spawn_s:.1f}s")
    # one NCCL rank in this process at (1, 1): NCCL's own all_reduce and
    # all_gather on the card
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init = os.path.join(tmp, "nccl_init")
    dev = sharded.init_rank(0, 1, "file://" + init, "cuda")
    try:
        require(torch.distributed.get_backend() == "nccl",
                "the 1-rank group is not NCCL")
        step = sharded.make_sharded_step(p, 1, 1)
        with torch.no_grad():
            out, nm1, na1 = step(di1, c_t.to(dev), l_t.to(dev))
            full, counts = step.gather_sharded(out, na1)
        torch.cuda.synchronize()
        for f in sharded.OUT_FIELDS:
            require(np.array_equal(full[f].cpu().numpy(), ref[f]),
                    f"the 1-rank NCCL step differs from map_batch in {f}")
        require(int(nm1) == int(ref["mapped"].sum())
                and int(counts.sum()) == int(ref["n_anchors"].sum()),
                "the 1-rank NCCL step's counts differ from map_batch's")
        log(f"[sharded] 1-rank NCCL step at (1, 1): equal to map_batch on "
            f"all {len(codes)} reads, collectives {step.coll_s:.4f}s")
    finally:
        torch.distributed.destroy_process_group()
    merged = np.load(os.path.join(job["out"], "merge0.npz"))
    merge_keys = [np.concatenate([merged[f"s{i}_k{q}"] for i in range(2)],
                                 axis=1) for q in range(3)]
    return dict(reports=reports, launches=[r["runs"][0]["launches"][0]
                                           for r in reports],
                merge_keys=merge_keys, A=p.A, step_s=step_s,
                reads_per_s=len(codes) / step_s, coll_s=coll_s,
                split_s=split_s, balance=bal, over=len(over))


def phase_sharded_kernels(shd, rows):
    """Phase 7 at phase 3g's merge shape: sort3 on the keys rank 0 merged
    (256 x 2048, the first A kept) against its plain version and torch.sort,
    its own row of the kernels line."""
    from minimap2_tpu_torch.ops import _build, sort
    from minimap2_tpu_torch.parallel import sharded
    keys = [torch.from_numpy(x).cuda() for x in shd["merge_keys"]]
    B, W = keys[0].shape
    A = shd["A"]
    got = sort.sort3_rows(*keys, counter="sort3_shard_merge")
    err = max_abs_err([x[:, :A] for x in got],
                      [x[:, :A] for x in sort.sort3_rows_plain(*keys)])
    require(err == 0, f"sort3 differs from its plain version on the shard "
            f"merge's keys ({err})")
    bms, bby = bound(B * W * 12 + B * A * 12,
                     B * (W // 2) * sort_stages(W) * 8)
    row = dict(
        name="sort3_shard_merge", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/sort3.cu",
        replaces="minimap2_tpu/ops/sort_pallas.py:65",
        launches=sum(c.get("sort3_shard_merge", 0)
                     for c in shd["launches"]),
        max_abs_err=err,
        ms=cuda_ms(lambda: sort.sort3_rows(*keys,
                                           counter="sort3_shard_merge")),
        plain_ms=cuda_ms(lambda: sort.sort3_rows_plain(*keys), reps=3),
        bound_ms=bms, bound_by=bby,
        library_ms=cuda_ms(lambda: library_sort3(*keys), reps=5),
        shape=[B, W], keep=A,
        blocks_per_sm=_build.blocks_per_sm("sort3", W))
    log(f"[kernels] sort3 on the shard merge's keys ({B} x {W}, the first "
        f"{A} kept; {row['launches']} launches in phase 3g's four ranks): "
        f"bit-equal, {row['ms']:.4f} ms, plain {row['plain_ms']:.2f} ms, "
        f"bound {bms:.4f} ms ({bby}), torch.sort x3 "
        f"{row['library_ms']:.4f} ms")
    # the merge past one sort row's width (more shards than fit): the
    # shards' parts twice over, merged two at a time, against the CPU
    parts = [tuple(x[:, q * A:(q + 1) * A] for x in keys)
             for q in range(W // A)] * 2
    tree = sharded.merge_anchors(parts, A, max_width=2 * A)
    flat = sharded.merge_anchors([tuple(x.cpu() for x in pt)
                                  for pt in parts], A)
    terr = max_abs_err([x.cpu() for x in tree], flat)
    require(terr == 0, f"the shard merge in groups differs from one plain "
            f"sort ({terr})")
    log(f"[kernels] the shard merge of {len(parts)} parts two at a time "
        f"({len(parts)} x {A} lanes, rows of {2 * A}): bit-equal to one "
        f"plain sort")
    rows.append(row)


def phase_grch38(tmp):
    """The GRCh38 envelope generated, indexed and mapped on the card."""
    from minimap2_tpu_torch.parallel import engine
    from minimap2_tpu_torch.parallel.batch import BatchParams
    from minimap2_tpu_torch.utils import simgenome_dev as sgd
    from minimap2_tpu_torch.utils.simgenome import write_fasta
    total, ncon = 3_100_000_000, 195
    torch.cuda.synchronize()
    t = time.time()
    names, parts = sgd.grch38_envelope_parts(total, ncon, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.time() - t
    n_bp = sum(int(p.shape[0]) for p in parts)
    # two alt contigs against the same contigs made on the CPU
    (_, nbig, _), (ts, ns, ss) = sgd.grch38_parts_plan(total, ncon)
    t = time.time()
    for c in (0, 170):
        cpu = sgd.simulate_contig(ss, c, ts // ns, device="cpu")
        require(torch.equal(parts[nbig + c].cpu(), cpu),
                f"alt{c} generated on the card differs from the CPU's")
    cmp_s = time.time() - t
    t = time.time()
    rnames, rcodes = sgd.simulate_reads_device(parts[:nbig], N_READS, seed=3,
                                               names=names[:nbig])
    rd = os.path.join(tmp, "grch38_reads.fa")
    write_fasta(rd, rnames, rcodes)
    # bench.py's off-distribution gate (bench.py:389-395): pbsim-CLR-shaped
    # reads from the 24 chromosomes, made before the build consumes them
    cnames, ccodes = sgd.simulate_reads_device_clr(parts[:nbig], OFFDIST_READS,
                                                   names=names[:nbig])
    clr_rd = os.path.join(tmp, "grch38_clr.fa")
    write_fasta(clr_rd, cnames, ccodes)
    clr_lens = [len(c) for c in ccodes]
    del rcodes, ccodes
    reads_s = time.time() - t
    log(f"[grch38] {n_bp} bp in {len(parts)} contigs generated on the card "
        f"in {gen_s:.1f}s; alt0 and alt170 equal the CPU's ({cmp_s:.1f}s); "
        f"{N_READS} reads sliced and {OFFDIST_READS} CLR-like reads "
        f"({min(clr_lens)}-{max(clr_lens)} bp) made in {reads_s:.1f}s")
    di, meta, info = _build_on_card("grch38", names, parts, 10, 15,
                                    cap_frac=0.21, consume=True)
    require(all(p is None for p in parts), "consume=True kept contigs")
    del parts
    require(di.pos_fmt == 2 and di.s_fmt == 1 and di.pstrand is not None
            and di.h2r_nb > 0, "the envelope's index is not pos_fmt 2 / "
            "s_fmt 1 with an h2r table")
    p = BatchParams(L=12288, M=2048, A=4096,
                    occ_cap=min(max(meta.mid_occ, 10), 64), chain_window=64,
                    bw_long=20000)
    step = engine.PafStep(di, p, K=5, min_sc=40)
    paf = os.path.join(tmp, "grch38.paf")
    run = _map_on_card("grch38", step, meta.seq_table(), rd, paf)
    paf_accuracy("grch38", paf, rnames)
    mapeval_rows("grch38", paf)
    offdist = phase_offdist(di, p, meta, clr_rd, tmp)
    del step, di, info["sketch_in"]
    torch.cuda.empty_cache()
    return dict(info, map=run, genome_bp=n_bp, gen_s=gen_s, reads_s=reads_s,
                offdist=offdist)


def phase_offdist(di, p, meta, clr_rd, tmp):
    """Phase 3c's off-distribution step (bench.py:251-258, :481-487): the
    CLR-like reads through a second PafStep at L 32768, M 4096, A 8192,
    bw_long 0, 256 reads a batch (the chain kernel's route); sketch, sort1
    (the compaction past 16384 lanes), sort3 and the chain launched; the
    port's mapeval rows, no error in the Q60 row (bench.py:514).  Keeps
    each kernel's first inputs for phase 7."""
    from minimap2_tpu_torch.parallel import batch, engine
    p32 = dataclasses.replace(p, L=32768, M=4096, A=8192, bw_long=0)
    step = engine.PafStep(di, p32, K=5, min_sc=40)
    paf = os.path.join(tmp, "grch38_clr.paf")
    sk, s1, s3, ch = {}, {}, {}, {}
    with _hooked([_capture_first(engine, "sketch_batch", sk),
                  _capture_first(batch, "sort1_ascending", s1),
                  _capture_first(batch, "sort3_rows", s3),
                  _capture_first(engine, "chain_batch", ch)]):
        run = _map_on_card("offdist", step, meta.seq_table(), clr_rd, paf,
                           batch_reads=OFFDIST_READS,
                           kernels=("sketch", "sort1", "sort3", "chain"))
    rows = mapeval_rows("offdist", paf)
    q60 = q60_row(rows)
    require(q60 is None or int(q60[3]) == 0,
            f"offdist: errors in the mapeval Q60 row {q60}")
    log(f"[offdist] {OFFDIST_READS} CLR-like reads at L 32768 in "
        f"{run['map_s']:.2f}s (one step, its warm-up included); mapeval Q60 "
        f"row {q60}")
    return dict(run, mapeval=rows, sketch_in=sk["args"],
                sort1_keys=s1["args"][0], anchor_keys=s3["args"],
                chain_in=ch)


def phase_long_reads(main, tmp, n_short=896, n_long=128):
    """Phase 3d: reads longer than L among shorter ones, through the CLI on
    phase 3's genome; the long ones take the host path."""
    from minimap2_tpu_torch.utils.simgenome import (simulate_reads,
                                                    write_fasta)
    names, seqs = main["genome"]
    sn, sr = simulate_reads(seqs, n_short, np.random.default_rng(5),
                            name_seqs=names)
    ln_, lr = simulate_reads(seqs, n_long, np.random.default_rng(6),
                             min_len=16_600, max_len=50_000,
                             name_seqs=names)
    ln_ = ["S2" + nm[2:] for nm in ln_]
    order = np.random.default_rng(7).permutation(n_short + n_long)
    rnames = [(sn + ln_)[i] for i in order]
    reads = [(sr + lr)[i] for i in order]
    n_past = sum(len(r) > 16384 for r in reads)
    require(n_past == n_long,
            f"{n_past} reads longer than L = 16384, not {n_long}")
    rd, paf = (os.path.join(tmp, f) for f in ("long_reads.fa", "long.paf"))
    write_fasta(rd, rnames, reads)
    del reads
    run = _paf_run("long", ["--batch", "-x", "map-ont", "-o", paf,
                            main["mmi"], rd],
                   ("sketch", "sort3", "sort3_merge", "chain"))
    host = run["host"]
    require(host["reads"] == n_long,
            f"{host['reads']} reads through the host path, not {n_long}")
    pos = {nm: i for i, nm in enumerate(rnames)}
    with open(paf) as f:
        seq = [pos[ln.split("\t", 1)[0]] for ln in f]
    require(all(a <= b for a, b in zip(seq, seq[1:])),
            "phase 3d's records are not in input order")
    n_long_out = len({i for i in seq if rnames[i].startswith("S2")})
    share = host["seconds"] / run["map_s"]
    log(f"[long] {run['reads_per_s']:.1f} reads/s; the host path took "
        f"{host['seconds']:.3f}s of the {run['map_s']:.2f}s mapping run "
        f"({100 * share:.1f}%) for the {n_long} reads longer than L; "
        f"{n_long_out}/{n_long} of them have a record")
    paf_accuracy("long", paf, rnames)
    return dict(run, rd=rd, rnames=rnames, host_share=share)


def mapeval_rows(tag, paf):
    """The port's ``paftools mapeval`` on a PAF of simulated reads (bench.py
    :187-197): its rows, each logged."""
    from minimap2_tpu_torch.tools import paftools
    out = io.StringIO()
    require(paftools.mapeval([paf], out=out) == 0, f"{tag}: mapeval failed")
    rows = [ln.split("\t") for ln in out.getvalue().splitlines()]
    for r in rows:
        log(f"[{tag}] mapeval " + " ".join(r))
    return rows


def q60_row(rows):
    return next((r for r in rows if r and r[1] == "60"), None)


def paf_accuracy(tag, paf, rnames):
    """Gate PAF primaries against the simulated truth (paftools mapeval's
    rule): >= 90% on their source interval, no wrong mapq-60 primary."""
    prim = {}
    with open(paf) as f:
        for ln in f:
            t = ln.rstrip("\n").split("\t")
            if "tp:A:P" in t:
                prim.setdefault(t[0], t)
    n_ok = n_q60_wrong = n_q60 = 0
    for nm in rnames:
        _, chrom, st, en, strand = nm.split("!")
        t = prim.get(nm)
        if t is None:
            continue
        ok = (t[5] == chrom and t[4] == strand and int(t[7]) < int(en)
              and int(t[8]) > int(st))
        n_ok += ok
        if int(t[11]) == 60:
            n_q60 += 1
            n_q60_wrong += not ok
    frac = n_ok / len(rnames)
    log(f"[{tag}] {n_ok}/{len(rnames)} reads correct ({100 * frac:.1f}%), "
        f"{n_q60} at mapq 60 of which {n_q60_wrong} wrong")
    require(frac >= 0.90, f"{tag}: only {100 * frac:.1f}% of reads correct")
    require(n_q60_wrong == 0, f"{tag}: {n_q60_wrong} wrong mapq-60 primaries")


def simulate_spliced(names, seqs, n_genes, rng):
    """A copy of the genome with n_genes planted genes at random
    non-overlapping loci, half on each strand: 4-8 exons of 80-300 bp,
    introns of 60-1200 bp (log-uniform), transcripts <= 2000 bp and gene
    spans <= 7000 bp; each intron gets GT..AG on the gene's strand (CT..AC
    on the forward sequence of a - gene).  One cDNA read per gene, the
    spliced transcript in either orientation, with 1.5% substitutions,
    0.75% deletions and 0.75% insertions.  Returns (genome copy, read
    names '<id>!<contig>!<gene start>!<gene end>!<gene strand>', read
    codes, {read name: [(intron start, intron end), ...]})."""
    seqs = [s.copy() for s in seqs]
    lens = np.array([len(s) for s in seqs], np.float64)
    taken = [[] for _ in seqs]
    rnames, reads, introns = [], [], {}
    while len(reads) < n_genes:
        n_ex = int(rng.integers(4, 9))
        ex = rng.integers(80, 301, n_ex)
        itr = np.exp(rng.uniform(np.log(60), np.log(1200), n_ex - 1)) \
            .astype(np.int64)
        span = int(ex.sum() + itr.sum())
        if ex.sum() > 2000 or span > 7000:
            continue
        ci = int(rng.choice(len(seqs), p=lens / lens.sum()))
        st = int(rng.integers(1000, len(seqs[ci]) - span - 1000))
        if any(st < b + 500 and a < st + span + 500 for a, b in taken[ci]):
            continue
        taken[ci].append((st, st + span))
        minus = len(reads) % 2 == 1
        g = seqs[ci]
        exons, pos = [], st
        for j in range(n_ex):
            exons.append((pos, pos + int(ex[j])))
            pos += int(ex[j]) + (int(itr[j]) if j < n_ex - 1 else 0)
        ivs = [(a[1], b[0]) for a, b in zip(exons, exons[1:])]
        for a, b in ivs:
            g[a:a + 2], g[b - 2:b] = ((1, 3), (0, 1)) if minus \
                else ((2, 3), (0, 2))
        tx = np.concatenate([g[a:b] for a, b in exons]).astype(np.uint8)
        r = rng.random(len(tx))
        msub = r < 0.015
        tx[msub] = (tx[msub] + rng.integers(1, 4, int(msub.sum()),
                                            dtype=np.uint8)) % 4
        tx = tx[~((r >= 0.015) & (r < 0.0225))]
        mins = np.flatnonzero(rng.random(len(tx)) < 0.0075)
        tx = np.insert(tx, mins, rng.integers(0, 4, len(mins))
                       .astype(np.uint8))
        if rng.random() < 0.5:
            tx = (3 - tx)[::-1].astype(np.uint8)
        nm = (f"G{len(reads)}!{names[ci]}!{st}!{st + span}!"
              f"{'-' if minus else '+'}")
        rnames.append(nm)
        reads.append(tx)
        introns[nm] = ivs
    return seqs, rnames, reads, introns


def simulate_sr_pairs(names, seqs, n_pairs, rng):
    """Illumina-like FR pairs: a fragment of ~N(350, 50) bases clipped to
    [200, 600] (inside sr's max_frag_len 800) from a contig drawn by
    length, every other one from the minus strand; r1 its first SR_LEN
    bases, r2 the reverse complement of its last SR_LEN; each end with
    0.5% substitutions, 0.01% deletions and 0.01% insertions.  Returns
    (qnames '<id>!<contig>!<fragment start>!<fragment end>!<fragment
    strand>' (mapeval's truth; each end's interval follows from it, see
    sr_truth), r1 codes, r2 codes)."""
    tot = np.array([len(x) for x in seqs], np.float64)
    pchr = tot / tot.sum()
    qnames, r1s, r2s = [], [], []
    for i in range(n_pairs):
        ci = int(rng.choice(len(seqs), p=pchr))
        flen = int(np.clip(round(rng.normal(350, 50)), 200, 600))
        st = int(rng.integers(0, len(seqs[ci]) - flen))
        frag = seqs[ci][st:st + flen].astype(np.uint8)
        minus = i % 2 == 1
        if minus:
            frag = (3 - frag)[::-1]
        ends = []
        for x in (frag[:SR_LEN], (3 - frag[-SR_LEN:])[::-1]):
            x = x.astype(np.uint8)
            r = rng.random(len(x))
            msub = r < 0.005
            x[msub] = (x[msub] + rng.integers(1, 4, int(msub.sum()),
                                              dtype=np.uint8)) % 4
            x = x[~((r >= 0.005) & (r < 0.0051))]
            mins = np.flatnonzero(rng.random(len(x)) < 0.0001)
            x = np.insert(x, mins, rng.integers(0, 4, len(mins))
                          .astype(np.uint8))
            ends.append(x)
        qnames.append(f"P{i}!{names[ci]}!{st}!{st + flen}!"
                      f"{'-' if minus else '+'}")
        r1s.append(ends[0])
        r2s.append(ends[1])
    return qnames, r1s, r2s


def sr_truth(qname, end):
    """(contig, start, end, strand) of one end of a simulated pair: r1 is
    the fragment's start on its strand, r2 its end on the other."""
    _, chrom, st, en, strand = qname.split("!")
    st, en = int(st), int(en)
    first = (strand == "+") == (end == 1)
    iv = (st, st + SR_LEN) if first else (en - SR_LEN, en)
    return chrom, iv[0], iv[1], strand if end == 1 else "+-"[strand == "+"]


def write_fastq(path, names, codes):
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for nm, x in zip(names, codes):
            f.write(b"@%s\n%s\n+\n%s\n" % (nm.encode(), acgt[x].tobytes(),
                                           b"I" * len(x)))


def _align_gates(tag, run, rnames, max_fallback):
    """The -a path's gates on an _align_run: every primary CIGAR spans its
    read and its Reg's reference interval, >= 90% of primaries on their
    source interval (a fallback read scored on its host-path record), no
    wrong mapq-60 primary, at most max_fallback of the reads on the host
    path.  Returns (gates, mean identity of the primaries); the gates are
    checked after the later phases, so that a run that fails them still
    measures the kernels."""
    prim, prim_regs = run["prim"], run["prim_regs"]
    n_ok = n_q60 = n_q60_wrong = 0
    idents, bad_cigar = [], []
    for nm in rnames:
        t = prim.get(nm)
        if t is None:
            continue
        _, chrom, st, en, strand = nm.split("!")
        q_len, r_len, _ = _cigar_spans(t[5])
        rs, re_, qlen = prim_regs[nm]
        pos = int(t[3]) - 1
        if q_len != qlen or r_len != re_ - rs or pos != rs:
            bad_cigar.append(nm)
        ok = (t[2] == chrom and ("-" if int(t[1]) & 16 else "+") == strand
              and pos < int(en) and pos + r_len > int(st))
        n_ok += ok
        if int(t[4]) == 60:
            n_q60 += 1
            n_q60_wrong += not ok
        idents += [1.0 - float(x[5:]) for x in t if x.startswith("de:f:")]
    frac = n_ok / len(rnames)
    mean_ident = statistics.fmean(idents) if idents else 0.0
    n_fb = len(run["fallbacks"])
    log(f"[{tag}] {n_ok}/{len(rnames)} primaries correct "
        f"({100 * frac:.1f}%), {n_q60} at mapq 60 of which {n_q60_wrong} "
        f"wrong; mean identity of the primaries {mean_ident:.4f}; "
        f"{len(prim) - len(bad_cigar)}/{len(prim)} CIGARs span read and "
        f"reference interval; {n_fb} fallback reads "
        f"({100 * n_fb / run['n_reads']:.2f}%)")
    gates = [(not bad_cigar, f"{tag}: CIGAR lengths disagree for "
              f"{bad_cigar[:5]}"),
             (frac >= 0.90, f"{tag}: only {100 * frac:.1f}% of primaries "
              "correct"),
             (n_q60_wrong == 0, f"{tag}: {n_q60_wrong} wrong mapq-60 "
              "primaries"),
             (n_fb <= max_fallback * run["n_reads"],
              f"{tag}: {n_fb} fallback reads (> {100 * max_fallback:.0f}%)")]
    return gates, mean_ident


def phase_align_path(main, tmp):
    """The -a path through the CLI on the same genome and reads.  Records
    the first align sub-batch's inputs (for phase 7)."""
    from minimap2_tpu_torch.parallel import align_batch
    sam = os.path.join(tmp, "out.sam")
    first_job = {}
    run = _align_run(
        "align", ["--batch", "-a", "-x", "map-ont", "-o", sam, main["mmi"],
                  main["rd"]], ("sketch", "sort3", "sort3_merge", "chain",
                                "extd2", "traceback"),
        [_capture_first(align_batch, "_align_step", first_job)])
    # the port takes the JAX package's fallback decisions; on these seeded
    # reads they come to 2.25% (PERF.md, section 6)
    gates, mean_ident = _align_gates("align", run, main["rnames"], 0.03)
    return dict(run, first_job=first_job, mean_identity=mean_ident,
                gates=gates)


def _scan_timer(mod, store):
    """A hook for mod._chain_scan (engine's or batch's) that records each
    call's seconds (synchronised) and steps (the batch's last valid
    anchor)."""
    from minimap2_tpu_torch.ops.chain import last_valid
    fn = mod._chain_scan

    def timed(*a):
        torch.cuda.synchronize()
        t = time.time()
        out = fn(*a)
        torch.cuda.synchronize()
        store.append((time.time() - t, last_valid(a[5])))
        return out
    return mod, "_chain_scan", timed


def _scan_log(tag, scans, n_batches):
    tot = sum(t for t, _ in scans)
    steps = sum(n for _, n in scans)
    log(f"[{tag}] the chain scan: {len(scans)} calls ({n_batches} batches, "
        f"two passes each), {tot:.2f}s, {tot / max(n_batches, 1):.3f}s a "
        f"batch, {steps} steps, {1e6 * tot / max(steps, 1):.1f} us a step")
    return dict(calls=len(scans), seconds=tot, steps=steps,
                s_per_batch=tot / max(n_batches, 1))


def phase_lr_hqae(main, tmp):
    """Phase 4c: ONT Q20-like reads through ``cli.main(["--batch", "-a",
    "-x", "lr:hqae", ...])`` (k25 w51, the RMQ tier: the chain scan, not
    the chain kernel), then the PAF route through
    ``engine.run_batched_cli`` on the same host index.  Records the first
    batch's sketch input, compaction and anchor keys and first align
    launch (for phase 7)."""
    from minimap2_tpu_torch import cli, config
    from minimap2_tpu_torch.ops._build import launches
    from minimap2_tpu_torch.parallel import align_batch, batch, engine
    sam, paf = (os.path.join(tmp, f) for f in ("q20.sam", "q20.paf"))
    first_job, sk, comp, anch, scans = {}, {}, {}, {}, []
    run = _align_run(
        "lr:hqae", ["--batch", "-a", "-x", "lr:hqae", "-o", sam, main["ref"],
                    main["q_rd"]], ("sketch", "sort3", "sort3_merge",
                                    "extd2", "traceback"),
        [_capture_first(align_batch, "_align_step", first_job),
         _capture_first(engine, "sketch_batch", sk),
         _capture_first(batch, "sort3_chunked", comp),
         _capture_first(batch, "sort3_rows", anch),
         _scan_timer(engine, scans)])
    p = run["step"].p
    require(p.rmq_tier and (p.k, p.w) == (25, 51) and p.bw_long > p.bw,
            f"the lr:hqae step is not the RMQ tier at k25 w51 ({p})")
    require(run["launches"].get("chain", 0) == 0,
            "the chain kernel launched on the lr:hqae -a path")
    n_batches = -(-run["n_reads"] // 512)
    scan = _scan_log("lr:hqae", scans, n_batches)
    gates, mean_ident = _align_gates("lr:hqae", run, main["qnames"], 0.05)
    host_share = run["host"]["seconds"] / run["align_s"]
    # the PAF route on the same host index, its launches counted alone
    _io, mo, _args = cli.parse_args(["-x", "lr:hqae"])
    config.mapopt_update(mo, run["mi"])
    seen, pscans = {}, []
    launches.clear()
    engine.host_path.clear()
    with _hooked([_map_timer(seen), _scan_timer(engine, pscans)]), \
            open(paf, "w") as out:
        engine.run_batched_cli(run["mi"], mo, [main["q_rd"]], out)
    pcounts = dict(launches)
    for name in ("sketch", "sort3", "sort3_merge"):
        require(pcounts.get(name, 0) > 0,
                f"kernel {name} never launched on the lr:hqae PAF path")
    require(pcounts.get("chain", 0) == 0,
            "the chain kernel launched on the lr:hqae PAF path")
    paf_rps = seen["n"] / seen["map_s"]
    log(f"[lr:hqae] PAF route: {seen['n']} reads in {seen['map_s']:.2f}s "
        f"({paf_rps:.1f} reads/s); launches {pcounts}; host path "
        f"{engine.host_path['reads']} reads")
    pscan = _scan_log("lr:hqae PAF", pscans, n_batches)
    paf_accuracy("lr:hqae PAF", paf, main["qnames"])
    log(f"[lr:hqae] -a: {run['reads_per_s']:.1f} aligned reads/s, the host "
        f"path {100 * host_share:.1f}% of the run; the chain scan "
        f"{100 * scan['seconds'] / run['align_s']:.1f}% of the -a run, "
        f"{100 * pscan['seconds'] / seen['map_s']:.1f}% of the PAF run")
    return dict(run, first_job=first_job, sketch_in=sk["args"],
                compaction_keys=comp["args"], anchor_keys=anch["args"],
                mean_identity=mean_ident, gates=gates, scan=scan,
                paf_scan=pscan, paf_reads_per_s=paf_rps,
                paf_launches=pcounts, host_share=host_share,
                rd=main["q_rd"])


def phase_sr_path(main, tmp):
    """Phase 4b: the paired-end short-read path through the CLI on the same
    genome.  Records, for phase 7, the first batch's sketch input, its
    compaction and anchor sort keys, its chain input and its first align
    launch's inputs."""
    from minimap2_tpu_torch.parallel import align_batch, batch, engine
    sam = os.path.join(tmp, "sr.sam")
    first_job, sk, ch, sorts = {}, {}, {}, []
    run = _pe_run(
        "sr", ["--batch", "-ax", "sr", "-o", sam, main["ref"],
               *main["sr_rd"]],
        ("sketch", "sort3", "chain", "extd2", "traceback"),
        [_capture_first(align_batch, "_align_step", first_job),
         _capture_first(engine, "sketch_batch", sk),
         _capture_first(engine, "chain_batch", ch),
         _capture_calls(batch, "sort3_rows", sorts, 2)])
    prim, proper = {}, Counter()
    with open(sam) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            t = ln.rstrip("\n").split("\t")
            flag = int(t[1])
            if flag & 0x904 == 0:
                end = 1 if flag & 0x40 else 2
                prim.setdefault((t[0], end), t)
                proper[t[0]] += bool(flag & 0x2)
    n_ok = n_q60 = n_q60_wrong = 0
    bad_cigar = []
    for nm in main["sr_names"]:
        for end in (1, 2):
            t = prim.get((nm, end))
            if t is None:
                continue
            chrom, st, en, strand = sr_truth(nm, end)
            q_len, r_len, _ = _cigar_spans(t[5])
            if q_len != main["sr_lens"][(nm, end)] or len(t[9]) != q_len:
                bad_cigar.append((nm, end))
            pos = int(t[3]) - 1
            ok = (t[2] == chrom and ("-" if int(t[1]) & 16 else "+") == strand
                  and pos < en and pos + r_len > st)
            n_ok += ok
            if int(t[4]) == 60:
                n_q60 += 1
                n_q60_wrong += not ok
    n_ends, n_pairs = 2 * len(main["sr_names"]), len(main["sr_names"])
    frac = n_ok / n_ends
    n_proper = sum(v == 2 for v in proper.values())
    n_fb = len(run["fallbacks"])
    log(f"[sr] {n_ok}/{n_ends} ends with a primary on their source interval "
        f"({100 * frac:.1f}%), {n_q60} at mapq 60 of which {n_q60_wrong} "
        f"wrong; {n_proper}/{n_pairs} pairs proper "
        f"({100 * n_proper / n_pairs:.1f}%); "
        f"{len(prim) - len(bad_cigar)}/{len(prim)} primary CIGARs span their "
        f"read; {n_fb} fragments ({100 * n_fb / n_pairs:.2f}%) on the host "
        "path")
    gates = [(not bad_cigar, f"sr CIGAR lengths disagree for "
              f"{bad_cigar[:5]}"),
             (frac >= 0.90, f"only {100 * frac:.1f}% of sr ends correct"),
             (n_q60_wrong == 0, f"{n_q60_wrong} wrong mapq-60 sr primaries"),
             (n_proper >= 0.90 * n_pairs,
              f"only {n_proper}/{n_pairs} sr pairs proper"),
             (n_fb <= 0.05 * n_pairs,
              f"{n_fb} sr fragments on the host path (> 5%)")]
    return dict(run, first_job=first_job, sketch_in=sk["args"],
                chain_in=ch, compaction_keys=sorts[0]["args"],
                anchor_keys=sorts[1]["args"], gates=gates,
                rd=main["sr_rd"], correct=frac,
                proper=n_proper / n_pairs)


def _pe_run(tag, argv, kernels, hooks=()):
    """cli.main(argv) on the paired-end path with its fragment loop timed;
    fails unless every kernel named launched.  Returns the step, batcher,
    index, options, launches, reads/s, host-path fragments and seconds."""
    from minimap2_tpu_torch.parallel import engine
    seen = {}
    align_pairs = engine.align_pairs

    def timed(step, ab, mi, opt, queries, out, batch_frags):
        torch.cuda.synchronize()
        t = time.time()
        res = align_pairs(step, ab, mi, opt, queries, out, batch_frags)
        torch.cuda.synchronize()
        seen.update(step=step, ab=ab, mi=mi, opt=opt, res=res,
                    batch_frags=batch_frags, align_s=time.time() - t)
        return res
    rc, counts, total_s, host = _run_cli(
        argv, [(engine, "align_pairs", timed), *hooks])
    require(rc == 0, f"{tag}: cli.main returned {rc}")
    n_reads, fallbacks = seen["res"]
    reads_per_s = n_reads / seen["align_s"]
    causes = dict(Counter(c for _, c in fallbacks))
    log(f"[{tag}] index build + upload {total_s - seen['align_s']:.1f}s; "
        f"aligned {n_reads} paired reads in {seen['align_s']:.2f}s "
        f"({reads_per_s:.1f} reads/s); launches {counts}")
    log(f"[{tag}] fragments on the host path: {len(fallbacks)} by cause "
        f"{causes}; the host path mapped {host['reads']} reads in "
        f"{host['seconds']:.3f}s "
        f"({100 * host['seconds'] / seen['align_s']:.1f}% of the run)")
    require(host["reads"] == 2 * len(fallbacks),
            f"{tag}: {len(fallbacks)} fragments on the host path, "
            f"{host['reads']} reads through it")
    for name in kernels:
        require(counts.get(name, 0) > 0,
                f"kernel {name} never launched on the {tag} path")
    return dict(seen, launches=counts, reads_per_s=reads_per_s,
                n_reads=n_reads, fallbacks=fallbacks, host=host)


@contextlib.contextmanager
def _hooked(hooks):
    """Module attributes swapped for a block: hooks = [(module, name,
    replacement)]."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in hooks]
    for m, n, f in hooks:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


HOST_BUILDS = []     # (Mb, k, w, seconds) of each host index build


def _build_timer():
    """A hook for cli.MiniIndex whose ``build`` (the host index build from
    FASTA: the native batched sketch and radix sort) is timed, logged and
    kept in HOST_BUILDS."""
    from minimap2_tpu_torch import cli, native
    base = cli.MiniIndex

    class TimedIndex(base):
        load = base.load        # an index of the base class, as build's

        @classmethod
        def build(cls, names, seqs, w, k, *a, **kw):
            t = time.time()
            mi = base.build(names, seqs, w, k, *a, **kw)
            dt = time.time() - t
            mb = sum(s.length for s in mi.seq) / 1e6
            HOST_BUILDS.append((round(mb), k, w, round(dt, 1)))
            log(f"[index] host index build of {mb:.0f} Mb at k{k} w{w}: "
                f"{dt:.1f}s ({len(mi.keys)} keys; native sketch_many + "
                f"radix_sort_pair: {native.available()})")
            return mi
    return cli, "MiniIndex", TimedIndex


def _run_cli(argv, hooks, call=None):
    """cli.main(argv), or call() in its place, with the hooks in place (see
    _hooked) and the host index build timed.  Returns (rc, launches,
    seconds, host path {reads, seconds})."""
    from minimap2_tpu_torch import cli
    from minimap2_tpu_torch.ops._build import launches
    from minimap2_tpu_torch.parallel import engine
    launches.clear()
    engine.host_path.clear()
    t1 = time.time()
    with _hooked([_build_timer(), *hooks]):
        rc = cli.main(argv) if call is None else call()
    host = {"reads": engine.host_path["reads"],
            "seconds": engine.host_path["seconds"]}
    return rc, dict(launches), time.time() - t1, host


def _capture_first(mod, name, store):
    """A hook for mod.name that records the first call's arguments
    (tensors cloned) in store, then calls the original."""
    fn = getattr(mod, name)

    def capturing(*args, **kw):
        if not store:
            store.update(args=[x.clone() if torch.is_tensor(x) else x
                               for x in args], kw=kw)
        return fn(*args, **kw)
    return mod, name, capturing


def _capture_calls(mod, name, store, n):
    """A hook for mod.name that records the first n calls' arguments
    (tensors cloned) in the list store, then calls the original."""
    fn = getattr(mod, name)

    def capturing(*args, **kw):
        if len(store) < n:
            store.append(dict(args=[x.clone() if torch.is_tensor(x) else x
                                    for x in args], kw=kw))
        return fn(*args, **kw)
    return mod, name, capturing


def _map_timer(seen):
    """A hook for engine.map_queries that times the mapping loop
    (synchronised) and records its step, index, options and reads."""
    from minimap2_tpu_torch.parallel import engine
    map_queries = engine.map_queries

    def timed(step, mi, queries, out, batch_reads, opt=None):
        torch.cuda.synchronize()
        t = time.time()
        n = map_queries(step, mi, queries, out, batch_reads, opt=opt)
        torch.cuda.synchronize()
        seen.update(step=step, mi=mi, opt=opt, n=n, map_s=time.time() - t)
        return n
    return engine, "map_queries", timed


def _paf_run(tag, argv, kernels, hooks=()):
    """cli.main(argv) on a PAF path with its mapping loop timed; fails
    unless every kernel named launched.  Returns the step, index, reads,
    seconds, launches and reads/s."""
    seen = {}
    rc, counts, total_s, host = _run_cli(argv, [_map_timer(seen), *hooks])
    require(rc == 0, f"{tag}: cli.main returned {rc}")
    reads_per_s = seen["n"] / seen["map_s"]
    log(f"[{tag}] index build + upload {total_s - seen['map_s']:.1f}s; "
        f"mapped {seen['n']} reads in {seen['map_s']:.2f}s "
        f"({reads_per_s:.1f} reads/s); launches {counts}; host path "
        f"{host['reads']} reads in {host['seconds']:.3f}s")
    for name in kernels:
        require(counts.get(name, 0) > 0,
                f"kernel {name} never launched on the {tag} path")
    return dict(seen, launches=counts, reads_per_s=reads_per_s, host=host)


def _align_run(tag, argv, kernels, hooks=(), call=None):
    """cli.main(argv) on an -a path (or call(), which writes the SAM that
    argv's -o names) with its align loop timed, each primary's Reg extent
    recorded (the device path's, and the host path's for a fallback read)
    and the SAM's primary records read back; fails unless every kernel
    named launched.  Returns the step, batcher, index, options, launches,
    reads/s, fallback reads and host-path seconds."""
    from minimap2_tpu_torch.parallel import engine
    seen, prim_regs = {}, {}
    align_queries = engine.align_queries
    batch_build_regs = engine.batch_build_regs

    def timed(step, ab, mi, opt, queries, out, batch_reads):
        torch.cuda.synchronize()
        t = time.time()
        res = align_queries(step, ab, mi, opt, queries, out, batch_reads)
        torch.cuda.synchronize()
        seen.update(step=step, ab=ab, mi=mi, opt=opt, res=res,
                    align_s=time.time() - t)
        return res

    def recording(recs, *a, **kw):
        res = batch_build_regs(recs, *a, **kw)
        for rec, regs in res[0].values():
            r = regs[0]
            prim_regs[rec.name] = (r.rs, r.re, len(rec.seq))
        return res

    map_fragment = engine.map_fragment

    def recording_host(mi, opt, frag):
        # the SAM primary of a host-path read is its sam_pri region
        results = map_fragment(mi, opt, frag)
        for r in results[0].regs:
            if r.sam_pri:
                prim_regs[frag[0].name] = (r.rs, r.re, len(frag[0].seq))
        return results
    rc, counts, total_s, host = _run_cli(
        argv, [(engine, "align_queries", timed),
               (engine, "batch_build_regs", recording),
               (engine, "map_fragment", recording_host), *hooks], call)
    require(rc == 0, f"{tag}: cli.main returned {rc}")
    n_reads, fallbacks = seen["res"]
    reads_per_s = n_reads / seen["align_s"]
    causes = dict(Counter(c for _, c in fallbacks))
    log(f"[{tag}] index build + upload {total_s - seen['align_s']:.1f}s; "
        f"aligned {n_reads} reads in {seen['align_s']:.2f}s "
        f"({reads_per_s:.1f} reads/s); launches {counts}")
    log(f"[{tag}] fallback reads: {len(fallbacks)} "
        f"({100 * len(fallbacks) / n_reads:.2f}%) by cause {causes}; the "
        f"host path mapped {host['reads']} in {host['seconds']:.3f}s "
        f"({100 * host['seconds'] / seen['align_s']:.1f}% of the run)")
    require(host["reads"] == len(fallbacks),
            f"{tag}: {len(fallbacks)} fallback reads, {host['reads']} "
            "through the host path")
    for name in kernels:
        require(counts.get(name, 0) > 0,
                f"kernel {name} never launched on the {tag} path")
    prim = {}
    with open(argv[argv.index("-o") + 1]) as f:
        for ln in f:
            t = ln.rstrip("\n").split("\t")
            if not ln.startswith("@") and int(t[1]) & 0x904 == 0:
                prim.setdefault(t[0], t)
    return dict(seen, launches=counts, reads_per_s=reads_per_s,
                n_reads=n_reads, fallbacks=fallbacks, prim=prim,
                prim_regs=prim_regs, host=host)


def phase_hpc_path(main, tmp):
    """The HPC path (map-pb: k19 w10 HPC minimizers) through the CLI on
    the same genome, with PacBio-CLR-like reads; records the first sort1
    input (the run-end keys of the first batch) and the first sketch input
    (its HPC-compacted codes) for phase 7."""
    from minimap2_tpu_torch.parallel import batch, engine
    paf = os.path.join(tmp, "hpc.paf")
    keys, sk = {}, {}
    run = _paf_run("hpc", ["--batch", "-x", "map-pb", "-o", paf, main["ref"],
                           main["hpc_rd"]], ("sort1", "sketch", "sort3",
                                             "sort3_merge", "chain"),
                   [_capture_first(batch, "sort1_ascending", keys),
                    _capture_first(engine, "sketch_batch", sk)])
    require(run["step"].p.hpc, "the map-pb step is not an HPC step")
    paf_accuracy("hpc", paf, main["hnames"])
    return dict(run, sort1_keys=keys["args"][0], rd=main["hpc_rd"],
                sketch_in=sk["args"])


def _cigar_spans(cigar):
    ops = re.findall(r"(\d+)([MIDNSHP=X])", cigar)
    return (sum(int(n) for n, o in ops if o in "MIS=XH"),
            sum(int(n) for n, o in ops if o in "MDN=X"), ops)


def phase_splice_path(main, tmp):
    """The spliced -a path through the CLI on the genome with planted
    genes; records the first exts2 launch's inputs and the first sketch
    input (for phase 7)."""
    from minimap2_tpu_torch.parallel import align_batch, engine
    sam = os.path.join(tmp, "splice.sam")
    mmi = os.path.join(tmp, "splice.mmi")
    first, sk = {}, {}
    run = _align_run(
        "splice", ["--batch", "-a", "-x", "splice", "-d", mmi, "-o", sam,
                   main["spl_ref"], main["spl_rd"]],
        ("sketch", "sort3", "sort3_merge", "chain", "exts2",
         "traceback_splice"),
        [_capture_first(align_batch, "exts2_batch", first),
         _capture_first(engine, "sketch_batch", sk)])
    gates, in_frac = _splice_gates("splice", run, main)
    return dict(run, first=first, gates=gates, intron_share=in_frac,
                rd=main["spl_rd"], sketch_in=sk["args"], mmi=mmi)


def simulate_splice_sr_pairs(names, gseqs, gnames, introns, n_pairs, rng):
    """Short-read RNA-seq pairs from phase 6's planted genes: pair i from
    gene i mod n_genes, a fragment of ~N(250, 50) bases clipped to [160,
    500] (and to the transcript) of its spliced transcript, every other
    one reverse-complemented; r1 its first SR_LEN bases, r2 the reverse
    complement of its last SR_LEN; 0.5% substitutions.  Returns (qnames,
    r1 codes, r2 codes, {(qname, end): (contig, gene start, gene end,
    strand, [introns the end crosses])}, BED12 lines of the genes)."""
    cid = {nm: i for i, nm in enumerate(names)}
    qnames, r1s, r2s, truth = [], [], [], {}
    for i in range(n_pairs):
        gn = gnames[i % len(gnames)]
        _, chrom, gst, gen, _ = gn.split("!")
        gst, gen = int(gst), int(gen)
        ivs = introns[gn]
        exons = list(zip([gst] + [b for _, b in ivs],
                         [a for a, _ in ivs] + [gen]))
        g = gseqs[cid[chrom]]
        tx = np.concatenate([g[a:b] for a, b in exons]).astype(np.uint8)
        gpos = np.concatenate([np.arange(a, b) for a, b in exons])
        flen = min(int(np.clip(round(rng.normal(250, 50)), 160, 500)),
                   len(tx))
        fs = int(rng.integers(0, len(tx) - flen + 1))
        minus = i % 2 == 1
        a_iv, b_iv = (fs, fs + SR_LEN), (fs + flen - SR_LEN, fs + flen)
        frag = tx[fs:fs + flen]
        if minus:
            frag = (3 - frag)[::-1]
        qn = f"S{i}!{chrom}!{gst}!{gen}"
        ends = []
        for e, (x, iv, strand) in enumerate(
                ((frag[:SR_LEN], b_iv if minus else a_iv, "-+"[not minus]),
                 ((3 - frag[-SR_LEN:])[::-1], a_iv if minus else b_iv,
                  "+-"[not minus])), 1):
            x = x.astype(np.uint8)
            msub = rng.random(len(x)) < 0.005
            x[msub] = (x[msub] + rng.integers(1, 4, int(msub.sum()),
                                              dtype=np.uint8)) % 4
            ends.append(x)
            gp = gpos[iv[0]:iv[1]]
            jumps = np.flatnonzero(np.diff(gp) != 1)
            truth[(qn, e)] = (chrom, int(gp[0]), int(gp[-1]) + 1, strand,
                              [(int(gp[j]) + 1, int(gp[j + 1]))
                               for j in jumps])
        qnames.append(qn)
        r1s.append(ends[0])
        r2s.append(ends[1])
    bed = []
    for gn in gnames:
        _, chrom, gst, gen, strand = gn.split("!")
        gst, gen = int(gst), int(gen)
        ivs = introns[gn]
        ex = list(zip([gst] + [b for _, b in ivs], [a for a, _ in ivs] + [gen]))
        bed.append(f"{chrom}\t{gst}\t{gen}\t{gn.split('!')[0]}\t0\t{strand}\t"
                   f"{gst}\t{gen}\t0\t{len(ex)}\t"
                   + ",".join(str(b - a) for a, b in ex) + ",\t"
                   + ",".join(str(a - gst) for a, _ in ex) + ",")
    return qnames, r1s, r2s, truth, bed


def _splice_sr_scores(sam, truth, ends):
    """Primary records of a splice:sr SAM against the simulated truth:
    (ends with a primary on their gene, ends with a primary, mapq-60
    primaries, wrong ones, pairs proper, true introns crossed, matched
    exactly by an N op, primaries whose CIGAR does not span the read,
    records out of input order)."""
    prim, proper, order = {}, Counter(), []
    with open(sam) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            t = ln.rstrip("\n").split("\t")
            nm = t[0].split("/")[0]
            order.append(int(nm.split("!")[0][1:]))
            flag = int(t[1])
            if flag & 0x904 == 0:
                end = 2 if flag & 0x80 else 1
                prim.setdefault((nm, end), t)
                proper[nm] += bool(flag & 0x2)
    n_ok = n_q60 = n_q60_wrong = n_in = n_in_ok = 0
    bad_cigar = []
    for key in ends:
        chrom, gst, gen, strand, ivs = truth[key]
        n_in += len(ivs)
        t = prim.get(key)
        if t is None:
            continue
        q_len, r_len, ops = _cigar_spans(t[5])
        if q_len != SR_LEN or len(t[9]) != q_len:
            bad_cigar.append(key)
        pos = int(t[3]) - 1
        ok = t[2] == chrom and pos < gen and pos + r_len > gst
        n_ok += ok
        if int(t[4]) == 60:
            n_q60 += 1
            n_q60_wrong += not ok
        got_in, x = set(), pos
        for n_, o in ops:
            if o == "N":
                got_in.add((x, x + int(n_)))
            if o in "MDN=X":
                x += int(n_)
        n_in_ok += sum(iv in got_in for iv in ivs)
    n_out = sum(a > b for a, b in zip(order, order[1:]))
    return dict(on_gene=n_ok, with_primary=len(prim), q60=n_q60,
                q60_wrong=n_q60_wrong, proper=sum(v == 2 for v in
                                                  proper.values()),
                introns=n_in, introns_exact=n_in_ok, bad_cigar=bad_cigar,
                out_of_order=n_out)


# phase 6b's floors and the host-path ceiling, from a CPU rehearsal of the
# same simulation on a 10 Mb genome (256 genes, 384 pairs): 0.694 of ends
# on their gene, 0.576 of pairs proper, no fragment on the host path,
# single-end 0.802 on their gene and 0.276 of introns matched; the floors
# leave room for sampling.  The paired path's share of true introns matched
# has no floor: it aligns with extd2, which does not splice, so it is 0 by
# design (the JAX package's paired device path likewise); it is printed
SSR_FLOORS = dict(pe_on_gene=0.60, pe_proper=0.48, pe_host=0.05,
                  se_on_gene=0.70, se_introns=0.18)


def phase_splice_sr(main, spl, tmp):
    """Phase 6b: splice:sr on phase 6's genome through its .mmi (k15 w5).
    Run (a), the command users run: ``cli.main(["--batch", "-ax",
    "splice:sr", "-j", anno.bed, "splice.mmi", r1, r2])``, the paired
    path (extd2 + the traceback, which do not splice; a fragment goes to
    the host path whole only where an end fails its audit, and -j has no
    effect there: jump_split runs in map_frag_core's single-segment branch
    and the device path reads no side data, as in the JAX package); run
    (b): the same reads' r1 alone, single-end, through the spliced -a
    path (exts2 + the splice traceback).  Gates: no wrong
    mapq-60 primary, every primary CIGAR spans its read, records in input
    order (run (a)); shares of ends with a primary on their gene, of pairs
    proper, of fragments on the host path and run (b)'s of true introns
    matched exactly against SSR_FLOORS (run (a)'s is printed).  Records,
    for phase 7, run (a)'s first batch's sketch input, compaction and
    anchor keys, chain input and first align launch, and run (b)'s first
    exts2 launch."""
    from minimap2_tpu_torch.parallel import align_batch, batch, engine
    n_pairs = len(main["ssr_names"])
    sam_a, sam_b = (os.path.join(tmp, f) for f in ("ssr_pe.sam",
                                                   "ssr_se.sam"))
    first_job, sk, ch, sorts, first_s = {}, {}, {}, [], {}
    pe = _pe_run(
        "splice:sr pe", ["--batch", "-ax", "splice:sr", "-j",
                         main["ssr_bed"], "-o", sam_a, spl["mmi"],
                         *main["ssr_rd"]],
        ("sketch", "sort3", "chain", "extd2", "traceback"),
        [_capture_first(align_batch, "_align_step", first_job),
         _capture_first(engine, "sketch_batch", sk),
         _capture_first(engine, "chain_batch", ch),
         _capture_calls(batch, "sort3_rows", sorts, 2)])
    se = _align_run(
        "splice:sr se", ["--batch", "-ax", "splice:sr", "-o", sam_b,
                         spl["mmi"], main["ssr_rd"][0]],
        ("sketch", "sort3", "chain", "exts2", "traceback_splice"),
        [_capture_first(align_batch, "exts2_batch", first_s)])
    truth = main["ssr_truth"]
    a = _splice_sr_scores(sam_a, truth, [(nm, e) for nm in main["ssr_names"]
                                         for e in (1, 2)])
    b = _splice_sr_scores(sam_b, truth, [(nm, 1)
                                         for nm in main["ssr_names"]])
    n_fb = len(pe["fallbacks"])
    shares = dict(pe_on_gene=a["on_gene"] / (2 * n_pairs),
                  pe_proper=a["proper"] / n_pairs,
                  pe_introns=a["introns_exact"] / max(a["introns"], 1),
                  pe_host=n_fb / n_pairs,
                  se_on_gene=b["on_gene"] / n_pairs,
                  se_introns=b["introns_exact"] / max(b["introns"], 1))
    for tag, x in (("pe", a), ("se", b)):
        log(f"[splice:sr {tag}] {x['on_gene']} ends on their gene, "
            f"{x['with_primary']} with a primary, {x['q60']} at mapq 60 of "
            f"which {x['q60_wrong']} wrong; {x['proper']} pairs proper; "
            f"{x['introns_exact']}/{x['introns']} true introns matched "
            f"exactly; {len(x['bad_cigar'])} primary CIGARs not spanning "
            f"their read; {x['out_of_order']} records out of input order")
    log(f"[splice:sr] shares {json.dumps({k: round(v, 4) for k, v in shares.items()})}"
        f"; paired {pe['reads_per_s']:.1f} reads/s, single-end "
        f"{se['reads_per_s']:.1f} reads/s; fragments on the host path "
        f"{n_fb} ({100 * shares['pe_host']:.1f}%), single-end fallback "
        f"reads {len(se['fallbacks'])}")
    # the paired path writes fragment by fragment in input order; the
    # single-end -a path writes a batch's unmapped reads after its mapped
    # ones, as the JAX package does
    gates = [(a["out_of_order"] == 0, f"splice:sr pe: {a['out_of_order']} "
              "records out of input order")]
    for tag, x in (("pe", a), ("se", b)):
        gates += [(x["q60_wrong"] == 0, f"splice:sr {tag}: {x['q60_wrong']} "
                   "wrong mapq-60 primaries"),
                  (not x["bad_cigar"], f"splice:sr {tag}: CIGARs not "
                   f"spanning their read {x['bad_cigar'][:5]}")]
    log(f"[splice:sr pe] {a['introns_exact']}/{a['introns']} true introns "
        f"matched on the paired path, which aligns with extd2 (no splicing)"
        f"; no floor")
    for k_, floor in SSR_FLOORS.items():
        ok = shares[k_] <= floor if k_ == "pe_host" else shares[k_] >= floor
        gates.append((ok, f"splice:sr {k_} {shares[k_]:.4f} against "
                      f"{'ceiling' if k_ == 'pe_host' else 'floor'} {floor}"))
    return dict(pe=dict(pe, first_job=first_job, sketch_in=sk["args"],
                        chain_in=ch, compaction_keys=sorts[0]["args"],
                        anchor_keys=sorts[1]["args"], rd=main["ssr_rd"]),
                se=dict(se, first=first_s), shares=shares, gates=gates)


def phase_splice_sr_kernels(ssr, rows):
    """Phase 7 at phase 6b's shapes: the sketch (k15 w5, 512 x 1024),
    sort3, the chain, extd2 and the traceback on run (a)'s first batch and
    align launch (phase_sr_kernels), and exts2 and the splice traceback on
    the first 32 jobs of run (b)'s first launch (_exts2_traceback_splice);
    each bit-equal to its plain version, timed, beside its bound, as a
    "splice_sr" entry of its row."""
    phase_sr_kernels(ssr["pe"], rows, "splice_sr")
    by = {r["name"]: r for r in rows}
    ext, tb, _ = _exts2_traceback_splice(
        "splice:sr's first launch", ssr["se"]["first"])
    for name, e in (("exts2", ext), ("traceback_splice", tb)):
        by[name]["splice_sr"] = e
        by[name]["max_abs_err"] = max(by[name]["max_abs_err"],
                                      e["max_abs_err"])


def _exts2_plain(args, kw, RT, sl=None):
    """exts2's plain version on args at the launch's kw, with the
    kernel's EZ_DEAD group rule applied (by the groups of the launch of
    the job_slice sl where given)."""
    from minimap2_tpu_torch.ops import exts
    pp, ezp = exts.exts2_batch_plain(
        *args, W=kw["W"], RT=RT, QP=args[0].shape[1], q=kw["q"], e=kw["e"],
        q2=kw["q2"], sc_mch=kw["sc_mch"], sc_mis=kw["sc_mis"],
        sc_N=kw["sc_N"])
    if sl is not None:
        return pp, ez_dead_in(ezp, sl, kw["G"], kw["RB"]).to(pp.device)
    return pp, exts._ez_dead(ezp, args[4], kw["G"], kw["RB"], RT)


def _exts2_launch_plain(args, kw, p=None, ez=None, sl=None):
    """exts2 and the splice traceback against their plain versions on one
    whole launch (args: qr, sf, dn, ac, lens; the kernel runs here unless
    its outputs are given), or, given sl, on args, the jobs of the
    job_slice sl of a timed launch (with its traceback's ops and fin rows;
    the plain versions on the card), compared 16 jobs at a time:
    ({max_abs_err, plain_ms} of exts2, of the traceback)."""
    from minimap2_tpu_torch.ops import exts, traceback
    ops = None
    if sl is not None:
        args = [x.cuda() for x in args]
        p, ez = unslice(sl, "cuda"), sl["ez"].cuda()
        ops, fin = sl["ops"].cuda(), sl["fin"].cuda()
    if p is None:
        p, ez = exts.exts2_batch(*args, **kw)
    N, RT = p.shape[:2]
    if sl is None:
        (pp, ezp), ms = timed_once(lambda: _exts2_plain(args, kw, RT))
    else:
        (pp, ezp), ms = timed_once(lambda: _exts2_plain(args, kw, RT, sl))
    err = max([max_abs_err_u8([p[i:i + 16]], [pp[i:i + 16]])
               for i in range(0, N, 16)] + [max_abs_err([ez], [ezp])])
    del pp
    tkw = dict(RB=kw["RB"], w=0, splice=True, QP=args[0].shape[1])
    if ops is None:
        ops, fin = traceback.traceback_batch(p, args[4], **tkw)
    (ops2, fin2), tb_ms = timed_once(
        lambda: traceback.traceback_batch_plain(p, args[4], **tkw))
    err_t = max(max_abs_err_u8([ops], [ops2]), max_abs_err([fin], [fin2]))
    return (dict(max_abs_err=err, plain_ms=ms),
            dict(max_abs_err=err_t, plain_ms=tb_ms))


def _exts2_traceback_splice(tag, first, n=32):
    """exts2 and the splice traceback against their plain versions on the
    first n jobs of one captured exts2 launch (first: its args and kw):
    bit-equal, timed with CUDA events, each beside its bound, and the
    wrapper's zero-fill of p (memset_ms) timed apart.  Returns (exts2
    dict, traceback dict, p of the n jobs)."""
    from minimap2_tpu_torch.ops import exts, traceback
    kw = first["kw"]
    args = [x[:n] for x in first["args"]]      # qr, sf, dn, ac, lens
    N, QP = args[0].shape
    TP, W, RB = kw["TP"], kw["W"], kw["RB"]
    p, ez = exts.exts2_batch(*args, **kw)
    RT = p.shape[1]
    (pp, ezp), plain_ms = timed_once(lambda: _exts2_plain(args, kw, RT))
    err = max(max_abs_err_u8([p], [pp]), max_abs_err([ez], [ezp]))
    require(err == 0, f"exts2 differs from its plain version on the first "
            f"{N} jobs of {tag} ({err})")
    del pp
    cells, bms, bby = _exts2_bound(args[4])
    ms = cuda_ms(lambda: exts.exts2_batch(*args, **kw), reps=5)
    memset_ms = cuda_ms(lambda: torch.zeros((N, RT, W), dtype=torch.uint8,
                                            device="cuda"), reps=5)
    ext = dict(shape=[N, QP, TP, W, RT], dp_cells=cells, max_abs_err=err,
               ms=ms, memset_ms=memset_ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=bby)
    log(f"[kernels] exts2 on the first {N} jobs of {tag} (QP={QP}, "
        f"TP={TP}, W={W}, R={RT}, {cells} DP cells): bit-equal, {ms:.3f} "
        f"ms (of it {memset_ms:.3f} ms zeroing p), plain {plain_ms:.0f} "
        f"ms, bound {bms:.4f} ms ({bby})")
    tkw = dict(RB=RB, w=0, splice=True, QP=QP)
    ops, fin = traceback.traceback_batch(p, args[4], **tkw)
    (ops2, fin2), tb_plain_ms = timed_once(
        lambda: traceback.traceback_batch_plain(p, args[4], **tkw))
    err_t = max(max_abs_err_u8([ops], [ops2]), max_abs_err([fin], [fin2]))
    require(err_t == 0, f"splice traceback differs from its plain version "
            f"on the first {N} jobs of {tag} ({err_t})")
    visited = int((ops != 0).sum())
    n_intron_ops = int((ops == 4).sum())
    tbms, tby = bound(visited + N * RT + N * 8 + N * 8, 0)
    tb_ms = cuda_ms(lambda: traceback.traceback_batch(p, args[4], **tkw),
                    reps=5)
    tb = dict(shape=[N, RT, W], visited=visited, max_abs_err=err_t,
              ms=tb_ms, plain_ms=tb_plain_ms, bound_ms=tbms, bound_by=tby)
    log(f"[kernels] splice traceback on the same p: bit-equal, {tb_ms:.3f} "
        f"ms, plain {tb_plain_ms:.0f} ms, {visited} diagonals visited, "
        f"{n_intron_ops} of them N, bound {tbms:.6f} ms ({tby})")
    return ext, tb, p


def _first_batch(step, rd, n):
    from minimap2_tpu_torch.io.fastx import read_fasta
    from minimap2_tpu_torch.parallel import engine
    _, seqs = read_fasta(rd)
    codes, lens = engine.encode_batch(seqs[:n], step.p.L)
    packed, nbits = engine.pack_codes(codes)
    return [torch.from_numpy(x) for x in (packed, nbits, lens)]


def ptxas_usage(src):
    """The ``-Xptxas -v`` lines of one kernel source in the build log, one
    a kernel: its name (a template's as ``name<args>``), spills,
    registers and shared memory."""
    from minimap2_tpu_torch.ops import _build
    out, on = [], False
    for ln in _build.build_log.splitlines():
        if ln.startswith("=="):
            on = ln.strip() == f"== {src}"
        elif on and "entry function" in ln:
            # _ZN<len><anonymous namespace><len><name>[I<template args>E]
            name = ln.split("'")[1]
            ns = re.match(r"_ZN(\d+)", name)
            n = ns and re.match(r"\d+", name[ns.end() + int(ns[1]):])
            if n:
                start = ns.end() + int(ns[1]) + n.end()
                end = start + int(n[0])
                args = re.match(r"I((?:L[ib]\d+E)+)E", name[end:])
                name = name[start:end] + ("<" + ", ".join(
                    re.findall(r"L[ib](\d+)E", args[1])) + ">" if args
                    else "")
            out.append(name)
        elif on and out and ("registers" in ln or "spill" in ln):
            out[-1] += "; " + ln.split(":")[-1].strip()
    return out


def kernel_launches(counts, name):
    """Launches of a kernel on a run: sort3 counts its merge launches too,
    sort1 its chunked ones."""
    return (counts.get(name, 0) + counts.get(f"{name}_merge", 0)
            + counts.get(f"{name}_chunked", 0))


def phase_kernels(main, hpc, spl, dvb, g38):
    from minimap2_tpu_torch.ops import _build, chain, sketch, sort
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    rows = []
    for src in ("sketch.cu", "sort3.cu"):
        for ln in ptxas_usage(src):
            log(f"[kernels] {src}: {ln}")

    # sketch at 512 x 16384 with N runs and ragged lengths, and on each
    # path's first batch: map-ont (k15 w10), map-pb's HPC-compacted codes
    # (k19 w10), splice (k15 w5)
    B, L = 512, 16384
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for _ in range(4 * B):
        b, st = int(rng.integers(0, B)), int(rng.integers(0, L - 60))
        codes[b, st:st + int(rng.integers(1, 50))] = 4
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    c_t = torch.from_numpy(codes).to(dev)
    l_t = torch.from_numpy(lens).to(dev)
    args = (c_t, l_t, 15, 10)
    got = sketch.sketch_batch(*args)
    want = sketch.device_sketch(*args)
    err = max_abs_err(got, want)
    require(err == 0, f"sketch differs from its plain version ({err})")
    del got, want
    paths = {}
    for tag, run in (("map-ont", main), ("map-pb", hpc), ("splice", spl)):
        p_args = tuple(run["sketch_in"])
        PB, PL = p_args[0].shape
        e = max_abs_err(sketch.sketch_batch(*p_args),
                        sketch.device_sketch(*p_args))
        require(e == 0, f"sketch differs from its plain version on the "
                f"{tag} path's first batch ({e})")
        err = max(err, e)
        k_, w_ = p_args[2], p_args[3]
        paths[tag] = dict(k=k_, w=w_, shape=[PB, PL], max_abs_err=e,
                          ms=cuda_ms(lambda a=p_args: sketch.sketch_batch(*a)),
                          blocks_per_sm=_build.blocks_per_sm("sketch", PL,
                                                             w_))
        log(f"[kernels] sketch on the {tag} path's first batch ({PB} x {PL},"
            f" k{k_} w{w_}): bit-equal, {paths[tag]['ms']:.4f} ms, "
            f"{paths[tag]['blocks_per_sm']} blocks per SM")
    # the index build's rows (8192 x 8192, code-5 separators) with the
    # validity plane: phase 3b's first chunk
    b_args = tuple(dvb["sketch_in"])            # rows, lens, k, w
    BB, BL = b_args[0].shape
    bk, bw_ = b_args[2], b_args[3]
    e = max_abs_err(sketch.sketch_batch(*b_args, with_valid=True),
                    sketch.device_sketch(*b_args, with_valid=True))
    require(e == 0, f"sketch differs from its plain version on the index "
            f"build's first chunk, five planes ({e})")
    err = max(err, e)
    cb_ms, cb_by = bound(BB * BL * 12 + BB * 4,
                         BB * BL * sketch_ops(bw_))
    build_chunk = dict(
        shape=[BB, BL], k=bk, w=bw_, max_abs_err=e,
        ms=cuda_ms(lambda: sketch.sketch_batch(*b_args, with_valid=True)),
        plain_ms=cuda_ms(lambda: sketch.device_sketch(*b_args,
                                                      with_valid=True),
                         reps=2, warmup=1),
        bound_ms=cb_ms, bound_by=cb_by,
        blocks_per_sm=_build.blocks_per_sm("sketch", BL, bw_),
        launches_devbuild=dvb["launches"].get("sketch", 0),
        launches_grch38=g38["launches"].get("sketch", 0))
    log(f"[kernels] sketch with the validity plane on the index build's "
        f"first chunk ({BB} x {BL}, k{bk} w{bw_}): bit-equal (5 planes), "
        f"{build_chunk['ms']:.4f} ms, plain {build_chunk['plain_ms']:.1f} "
        f"ms, bound {cb_ms:.4f} ms ({cb_by}); launches a build: 100 Mb "
        f"{build_chunk['launches_devbuild']}, GRCh38 envelope "
        f"{build_chunk['launches_grch38']}")
    bms, by = bound(B * L * 11 + B * 4, B * L * sketch_ops(10))
    rows.append(dict(
        name="sketch", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/sketch.cu",
        replaces="minimap2_tpu/ops/sketch_pallas.py:218",
        launches=main["launches"].get("sketch", 0), max_abs_err=err,
        ms=cuda_ms(lambda: sketch.sketch_batch(*args)),
        plain_ms=cuda_ms(lambda: sketch.device_sketch(*args), reps=3),
        bound_ms=bms, bound_by=by, library_ms=None, shape=[B, L],
        blocks_per_sm=_build.blocks_per_sm("sketch", L, 10), paths=paths,
        build_chunk=build_chunk))

    # sort3_rows at 512 x 4096 (the anchor sort), sort3_chunked at
    # 512 x 16384 (minimizer compaction): random planes, then the first
    # batch's own keys from phase 3
    def planes(B, A, sentinel, density):
        k1 = np.where(rng.random((B, A)) < density,
                      rng.integers(0, 1 << 31, (B, A)), sentinel)
        k2 = rng.integers(0, 1 << 32, (B, A), dtype=np.uint64)
        k3 = rng.integers(0, 1 << 32, (B, A), dtype=np.uint64)
        return [torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(dev)
                for x in (k1, k2, k3)]

    def chunked_plain(c_args):
        B_, A_ = c_args[0].shape
        s = sort.sort3_rows_plain(*(x.reshape(-1, 2048) for x in c_args))
        return sort.sort3_rows_plain(*(x.view(B_, -1, 2048)[:, :, :1024]
                                       .reshape(B_, -1) for x in s))

    s_args = planes(512, 4096, 0xFFFFFFFF, 0.5)
    got = sort.sort3_rows(*s_args)
    err = max_abs_err(got, sort.sort3_rows_plain(*s_args))
    require(err == 0, f"sort3_rows differs from its plain version ({err})")
    lib = library_sort3(*s_args)
    require(all(bool(((g.to(torch.int64) & 0xFFFFFFFF) == x).all())
                for g, x in zip(got, lib)),
            "sort3_rows differs from the 3-pass torch.sort")
    A = 4096
    bms, by = bound(512 * A * 24, 512 * (A // 2) * sort_stages(A) * 8)
    c_args = planes(512, 16384, 0x7FFFFFFF, 2 / 11)
    gotc = sort.sort3_chunked(*c_args)
    errc = max_abs_err(gotc, chunked_plain(c_args))
    require(errc == 0,
            f"sort3_chunked differs from its plain version ({errc})")
    a_keys, c_keys = main["anchor_keys"], main["compaction_keys"]
    err_a = max_abs_err(sort.sort3_rows(*a_keys),
                        sort.sort3_rows_plain(*a_keys))
    require(err_a == 0, f"sort3_rows differs from its plain version on "
            f"phase 3's anchor keys ({err_a})")
    err_p = max_abs_err(sort.sort3_chunked(*c_keys), chunked_plain(c_keys))
    require(err_p == 0, f"sort3_chunked differs from its plain version on "
            f"phase 3's compaction keys ({err_p})")
    log(f"[kernels] sort3 bit-equal on phase 3's first anchor keys "
        f"{tuple(a_keys[0].shape)} and compaction keys "
        f"{tuple(c_keys[0].shape)}; blocks per SM at 2048 / 4096 / 8192 "
        f"lanes: " + " / ".join(str(_build.blocks_per_sm("sort3", a))
                                for a in (2048, 4096, 8192)))
    # the compaction's work: 2048-lane chunks sorted, then only the merge
    # phases kk = 2048 .. 8192 of the kept 8192 lanes
    merge_stages = sort_stages(8192) - sort_stages(1024)
    cb, cby = bound(512 * 16384 * 12 + 512 * 8192 * 12,
                    (512 * 8 * 1024 * sort_stages(2048)
                     + 512 * 4096 * merge_stages) * 8)
    rows.append(dict(
        name="sort3", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/sort3.cu",
        replaces="minimap2_tpu/ops/sort_pallas.py:65",
        launches=kernel_launches(main["launches"], "sort3"),
        launches_by_entry={n: main["launches"].get(n, 0)
                           for n in ("sort3", "sort3_merge")},
        max_abs_err=max(err, errc, err_a, err_p),
        ms=cuda_ms(lambda: sort.sort3_rows(*s_args)),
        plain_ms=cuda_ms(lambda: sort.sort3_rows_plain(*s_args), reps=3),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: library_sort3(*s_args), reps=5),
        shape=[512, 4096], blocks_per_sm=_build.blocks_per_sm("sort3", A),
        path_anchor_ms=cuda_ms(lambda: sort.sort3_rows(*a_keys)),
        chunked=dict(
            shape=[512, 16384], max_abs_err=errc,
            ms=cuda_ms(lambda: sort.sort3_chunked(*c_args)),
            path_ms=cuda_ms(lambda: sort.sort3_chunked(*c_keys)),
            plain_ms=cuda_ms(lambda: chunked_plain(c_args), reps=3),
            bound_ms=cb, bound_by=cby,
            library_ms=cuda_ms(lambda: library_sort3(*c_args), reps=5))))
    log(f"[kernels] sort3 rows 512 x 4096 {rows[-1]['ms']:.4f} ms (phase 3's"
        f" anchor keys {rows[-1]['path_anchor_ms']:.4f}), bound {bms:.4f} ms"
        f" ({by}); chunked 512 x 16384 {rows[-1]['chunked']['ms']:.4f} ms "
        f"(phase 3's compaction keys {rows[-1]['chunked']['path_ms']:.4f}),"
        f" bound {cb:.4f} ms ({cby})")
    del got, gotc, lib
    # chain DP at 512 x 4096 on the anchor planes of the first batch, both
    # passes' bands (500, and 20000 for the long-join rescue)
    step = main["step"]
    p = step.p
    with torch.no_grad():
        planes_ = step.seed(*(x.to(dev) for x in
                              _first_batch(step, main["rd"], 512)))[:6]
    n_anchor = int(planes_[5].sum())
    errs = []
    for bw in (p.bw, p.bw_long):
        kw = dict(WND=p.chain_window, max_dist_x=max(p.max_dist_x, bw),
                  max_dist_y=max(p.max_dist_y, bw), bw=bw,
                  chn_pen_gap=p.chn_pen_gap, chn_pen_skip=p.chn_pen_skip)
        errs.append(max_abs_err(chain.chain_batch(*planes_, **kw),
                                chain.chain_batch_plain(*planes_, **kw)))
    require(max(errs) == 0, f"chain differs from its plain version ({errs})")
    kw = dict(WND=p.chain_window, max_dist_x=p.max_dist_x,
              max_dist_y=p.max_dist_y, bw=p.bw, chn_pen_gap=p.chn_pen_gap,
              chn_pen_skip=p.chn_pen_skip)
    B, A = planes_[0].shape
    bms, by = bound(B * A * (21 + 16), n_anchor * p.chain_window * 30)
    n_max = chain.last_valid(planes_[5])
    ch_ms = cuda_ms(lambda: chain.chain_batch(*planes_, **kw))
    per_sm = _build.blocks_per_sm("chain", 64)
    log(f"[kernels] chain at {B} x {A} ({n_anchor} valid anchors, the "
        f"longest read's n {n_max}, {per_sm} blocks per SM): {ch_ms:.3f} "
        f"ms, {1e6 * ch_ms / max(n_max, 1):.1f} ns a step of the longest "
        f"read, bound {bms:.4f} ms ({by})")
    rows.append(dict(
        name="chain", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/chain.cu",
        replaces="minimap2_tpu/ops/chain_pallas.py:166",
        launches=main["launches"].get("chain", 0), max_abs_err=max(errs),
        ms=ch_ms,
        plain_ms=cuda_ms(lambda: chain.chain_batch_plain(*planes_, **kw),
                         reps=2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None, shape=[B, A],
        valid_anchors=n_anchor, longest_n=n_max,
        ns_per_step=1e6 * ch_ms / max(n_max, 1), blocks_per_sm=per_sm))
    return rows


def _extd2_tb_plain(args, ext_kw, n_p, p=None, ez=None, ops=None, fin=None,
                    sl=None):
    """extd2 and the traceback against their plain versions on the first
    n_p jobs of one launch (args: qr, sf, lens; ext_kw the launch's; the
    kernels run here unless their outputs are given), or, given sl, on
    args, the jobs of the job_slice sl of a timed launch (with its
    traceback's ops and fin rows; the plain versions on the card):
    bit-equal.  Returns ({max_abs_err, plain_ms, plain_jobs} of extd2, of
    the traceback)."""
    from minimap2_tpu_torch.ops import extend, traceback
    k = ext_kw
    W, RB, w, G = k["W"], k["RB"], k["w"], k["G"]
    if sl is not None:
        args = [x.cuda() for x in args]
        p, ez = unslice(sl, "cuda"), sl["ez"].cuda()
        ops, fin = sl["ops"].cuda(), sl["fin"].cuda()
    qr, sf, lens = args
    if p is None:
        p, ez = extend.extd2_batch2(qr, sf, lens, **k)
    RT = p.shape[1]

    def extd2_plain():
        pp, ezp = extend.extd2_batch2_plain(
            qr[:n_p], sf[:n_p], lens[:n_p], W=W, RB=RB, RT=RT, q=k["q"],
            e=k["e"], q2=k["q2"], e2=k["e2"], w=w, sc_mch=k["sc_mch"],
            sc_mis=k["sc_mis"], sc_N=k["sc_N"])
        if sl is not None:
            return pp, ez_dead_in(ezp, sl, G, RB).cuda()
        return pp, extend._ez_dead(ezp, lens[:n_p], G, RB, RT)
    (pp, ezp), ext_ms = timed_once(extd2_plain)
    err = max([max_abs_err_u8([p[i:i + 16]], [pp[i:i + 16]])
               for i in range(0, n_p, 16)] + [max_abs_err([ez[:n_p]], [ezp])])
    del pp
    if ops is None:
        ops, fin = traceback.traceback_batch(p, lens, RB=RB, w=w)
    (ops2, fin2), tb_ms = timed_once(
        lambda: traceback.traceback_batch_plain(p[:n_p], lens[:n_p], RB=RB,
                                                w=w))
    err_t = max(max_abs_err_u8([ops[:n_p]], [ops2]),
                max_abs_err([fin[:n_p]], [fin2]))
    return (dict(max_abs_err=err, plain_ms=ext_ms, plain_jobs=n_p),
            dict(max_abs_err=err_t, plain_ms=tb_ms, plain_jobs=n_p))


def lane_reach(lens, w=None, RB=None, QP=None, nr=None):
    """The widest window lane each job's DP reaches: 1 + the largest en0 -
    ws over the diagonals it runs (up to its EZ_NR where nr is given), for
    extd2 (band w, window wstart_chunk(r, w, RB)) or, with w None, exts2
    (window wstart_q(r, QP)).  (N,) int64."""
    lh = lens.cpu().numpy().astype(np.int64)
    ql, tl = lh[:, 0], lh[:, 1]
    end = ql + tl - 1
    if nr is not None:
        end = np.minimum(end, nr.cpu().numpy().astype(np.int64))
    r = np.arange(int(end.max(initial=0)))
    if w is None:
        ws = np.maximum(0, r - QP + 1) // 16 * 16
    else:
        ws = np.maximum(0, ((r // RB * RB) - w + 1) >> 1) // 16 * 16
    out = np.zeros(len(lh), np.int64)
    for i in range(len(lh)):
        rr = r[:end[i]]
        st0 = np.maximum(0, rr - ql[i] + 1)
        en0 = np.minimum(tl[i] - 1, rr)
        if w is not None:
            st0 = np.maximum(st0, (rr - w + 1) >> 1)
            en0 = np.minimum(en0, (rr + w) >> 1)
        ok = st0 <= en0
        if ok.any():
            out[i] = int((en0 - ws[:end[i]])[ok].max()) + 1
    return out


def wide_jobs(lens, n, reach, past, least=None):
    """Indices of up to n jobs of a launch for its plain check: of those
    whose DP reaches a lane past ``past`` (reach: lane_reach's), the ones
    with the fewest diagonals (the plain versions pay per anti-diagonal);
    fails where fewer than ``least`` (n by default) reach it."""
    rstar = (lens[:, 0].long() + lens[:, 1].long() - 1).cpu().numpy()
    far = np.flatnonzero(reach > past)
    least = n if least is None else least
    require(len(far) >= least, f"only {len(far)} jobs of the launch reach "
            f"a lane past {past} (widest {int(reach.max(initial=0))}), "
            f"{least} wanted")
    pick = far[np.argsort(rstar[far], kind="stable")[:n]]
    return torch.from_numpy(np.sort(pick)).to(lens.device)


def job_slice(p, ez, lens, sub, RT):
    """Jobs sub of a timed DP launch's outputs, for a plain check of them
    (jobs are independent): their p rows up to their last diagonal (the
    rows past it must be 0, which is checked here), their ez rows, the
    launch's lens (EZ_DEAD's group rule) and RT, on the host."""
    Rc = int((lens[sub].long().sum(1) - 1).max())
    if p is not None:
        require(not bool(p[sub, Rc:].any()), "a DP launch wrote p past "
                "its jobs' last diagonal")
    return dict(p=None if p is None else p[sub, :Rc].cpu(),
                ez=ez[sub].cpu(), lens_all=lens.cpu(), sub=sub.cpu(), RT=RT)


def unslice(sl, dev):
    """The whole (n, RT, W) p of a job_slice on dev."""
    c = sl["p"]
    p = torch.zeros((c.shape[0], sl["RT"], c.shape[2]), dtype=torch.uint8,
                    device=dev)
    p[:, :c.shape[1]] = c.to(dev)
    return p


def ez_dead_in(ezp, sl, G, RB):
    """EZ_DEAD on a plain version's ez rows of the jobs of a job_slice,
    by the G-groups of their launch."""
    from minimap2_tpu_torch.ops import extend
    full = torch.zeros((len(sl["lens_all"]), extend.EZ_N),
                       dtype=torch.int32)
    full[sl["sub"]] = ezp.cpu()
    return extend._ez_dead(full, sl["lens_all"], G, RB, sl["RT"])[sl["sub"]]


def p_err(p_c, pp):
    """max |p - pp| of a job_slice's p rows against a plain version's
    whole p (whose rows past the slice's must be 0)."""
    pp = pp.cpu()
    Rc = p_c.shape[1]
    return max(max_abs_err_u8([p_c], [pp[:, :Rc]]),
               int(pp[:, Rc:].max()) if pp.shape[1] > Rc else 0)


def _extd2_traceback(job, n_first=64, n_plain=None, subset=None):
    """extd2 against its plain version on one captured align launch (the
    whole launch, or its first n_plain jobs: n_plain a multiple of G, so
    that EZ_DEAD's group rule is the launch's; or the jobs of subset, a
    launch of their own), timed on the whole launch and on its first
    n_first jobs, and the traceback likewise on that launch's p:
    bit-equal, timed with CUDA events, each beside its bound; the plain
    versions in the deferred checks when main runs them.  Returns (extd2
    dict, traceback dict, the ext_kw of the launch)."""
    from minimap2_tpu_torch.ops import _build, extend, traceback
    qr, sf, lens = job["args"]
    kw = job["kw"]
    N, QP = qr.shape
    TP = kw["TP"]
    G, W, RB, w = kw["G"], kw["W"], kw["RB"], kw["w"]
    ext_kw = dict(G=G, W=W, RB=RB, R=kw["R"], QP=QP, TP=TP, q=kw["q"],
                  e=kw["e"], q2=kw["q2"], e2=kw["e2"], w=w, zdrop=-1,
                  right_mode=False, approx_max=True, approx_drop=False,
                  sc_mch=kw["sc_mch"], sc_mis=kw["sc_mis"], sc_N=0)
    p, ez = extend.extd2_batch2(qr, sf, lens, **ext_kw)
    RT = p.shape[1]
    n_p = N if n_plain is None else n_plain
    require(n_p == N or n_p % G == 0, f"n_plain {n_p} is not a multiple of "
            f"G {G}")
    held = "the whole first launch" if n_p == N else (
        f"the first launch's first {n_p} jobs")
    ops, fin = traceback.traceback_batch(p, lens, RB=RB, w=w)
    if subset is not None:
        held = f"{len(subset)} jobs of the first launch"
        sl = dict(job_slice(p, ez, lens, subset, RT), ops=ops[subset].cpu(),
                  fin=fin[subset].cpu())
        sub_args = [qr[subset].cpu(), sf[subset].cpu(), lens[subset].cpu()]
    if subset is not None and DEFER is not None:
        key = DEFER.add("extd2_tb", int((lens[subset].sum(1) - 1).max()),
                        args=sub_args, kw=ext_kw, n_p=len(subset), sl=sl)
        ext_res, tb_res = (dict(max_abs_err=None, plain_ms=None,
                                plain_jobs=len(subset),
                                deferred=f"{key}:{part}")
                           for part in ("ext", "tb"))
    elif subset is not None:
        ext_res, tb_res = _extd2_tb_plain(sub_args, ext_kw, len(subset),
                                          sl=sl)
        require(ext_res["max_abs_err"] == 0 and tb_res["max_abs_err"] == 0,
                f"extd2 or the traceback differs from its plain version on "
                f"{held} ({ext_res}, {tb_res}; W={W})")
    elif DEFER is not None:
        key = DEFER.add("extd2_tb", int((lens[:n_p].sum(1) - 1).max()),
                        args=[qr, sf, lens], kw=ext_kw, n_p=n_p)
        ext_res, tb_res = (dict(max_abs_err=None, plain_ms=None,
                                plain_jobs=n_p, deferred=f"{key}:{part}")
                           for part in ("ext", "tb"))
    else:
        ext_res, tb_res = _extd2_tb_plain((qr, sf, lens), ext_kw, n_p, p, ez,
                                          ops, fin)
        require(ext_res["max_abs_err"] == 0, f"extd2 differs from its plain "
                f"version on {held} ({ext_res}; W={W}, QP={QP}, TP={TP})")
        require(tb_res["max_abs_err"] == 0, f"traceback differs from its "
                f"plain version on {held} ({tb_res}; W={W})")

    cells, bms, by = _extd2_bound(lens, w)
    ext_ms = cuda_ms(lambda: extend.extd2_batch2(qr, sf, lens, **ext_kw),
                     reps=3)
    f_n = [x[:n_first] for x in (qr, sf, lens)]
    cells_n, bms_n, by_n = _extd2_bound(f_n[2], w)
    ms_n = cuda_ms(lambda: extend.extd2_batch2(*f_n, **ext_kw), reps=5)
    per_sm = _build.blocks_per_sm("extd2", W, QP, TP, 0)
    ext = dict(**ext_res, ms=ext_ms, bound_ms=bms, bound_by=by,
               shape=[N, QP, TP, W, RT],
               band_cells=cells, blocks_per_sm=per_sm,
               first64=dict(ms=ms_n, bound_ms=bms_n, bound_by=by_n,
                            band_cells=cells_n))

    def tb_bound(ops_t):     # one p byte per visited diagonal, ops, lens, fin
        n, visited = ops_t.shape[0], int((ops_t != 0).sum())
        return (visited,) + bound(visited + n * RT + n * 8 + n * 8, 0)
    visited, tbms, tby = tb_bound(ops)
    visited_n, tbms_n, tby_n = tb_bound(ops[:n_first])
    tb_ms = cuda_ms(lambda: traceback.traceback_batch(p, lens, RB=RB, w=w),
                    reps=3)
    p_n = p[:n_first]
    tb_ms_n = cuda_ms(lambda: traceback.traceback_batch(p_n, f_n[2], RB=RB,
                                                        w=w), reps=5)
    walk = longest_walk(ops)
    tb = dict(**tb_res, ms=tb_ms, bound_ms=tbms,
              bound_by=tby, shape=[N, RT, W], visited=visited,
              longest_walk=walk, ns_per_diagonal=1e6 * tb_ms / max(walk, 1),
              blocks_per_sm=_build.blocks_per_sm("traceback", 0),
              first64=dict(ms=tb_ms_n, bound_ms=tbms_n, bound_by=tby_n,
                           visited=visited_n))
    return ext, tb, ext_kw


def phase_align_kernels(aln):
    """extd2 against its plain version on the whole first launch of the -a
    run (a 512-read batch's jobs), timed on that launch and on its first
    64 jobs (the earlier 64-job sub-batch); the traceback likewise on that
    launch's p; extd2's DP cell-updates/s on bench.py's 64 x 10,240 x
    10,240 random pairs."""
    from minimap2_tpu_torch.ops import extend
    ext, tb, ext_kw = _extd2_traceback(aln["first_job"])
    # bench.py:262-292: 64 x 10,240 x 10,240 random pairs, band 500
    rng = np.random.default_rng(0)
    NB, QB, w_b = 64, 10240, 500
    b_args = [torch.from_numpy(x).cuda() for x in (
        rng.integers(0, 4, (NB, QB)).astype(np.uint8),
        rng.integers(0, 4, (NB, QB)).astype(np.uint8),
        np.full((NB, 2), QB, np.int32))]
    b_kw = dict(ext_kw, G=64, W=640, RB=64, R=(2 * QB + 127) // 128 * 128,
                QP=QB, TP=QB, q=4, e=2, q2=24, e2=1, w=w_b, sc_mch=2,
                sc_mis=-4)
    b_ms = cuda_ms(lambda: extend.extd2_batch2(*b_args, **b_kw), reps=3)
    rr = np.arange(2 * QB - 1)
    b_cells = int(np.minimum.reduce([np.full_like(rr, w_b), rr + 1,
                                     2 * QB - 1 - rr]).sum()) * NB
    dp_rate = b_cells / (b_ms / 1e3)
    del b_args
    _log_extd2_traceback("-a", ext, tb, ext_kw)
    log(f"[kernels] extd2 on bench.py's 64 x 10,240^2 pairs: {b_ms:.3f} ms "
        f"= {dp_rate:.4g} DP cell-updates/s")
    rows = [dict(
        name="extd2", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/extd2.cu",
        replaces="minimap2_tpu/ops/extend_pallas2.py:658",
        launches=aln["launches"].get("extd2", 0), **ext, library_ms=None,
        dp_cells_per_s=dp_rate, dp_bench_ms=b_ms)]
    rows.append(dict(
        name="traceback", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/traceback.cu",
        replaces="minimap2_tpu/ops/traceback_pallas.py:155",
        launches=aln["launches"].get("traceback", 0), **tb, library_ms=None))
    return rows


def _log_extd2_traceback(tag, x, y, k):
    """The log lines of one _extd2_traceback result."""
    N, QP, TP, W, RT = x["shape"]
    log(f"[kernels] extd2 on the {tag} path's first launch, {N} jobs "
        f"(QP={QP}, TP={TP}, W={W}, w={k['w']}, R={RT}, scores "
        f"a{k['sc_mch']} b{-k['sc_mis']} q{k['q']} e{k['e']} q{k['q2']} "
        f"e{k['e2']}, {x['band_cells']} band cells, "
        f"{x['blocks_per_sm']} blocks per SM): {x['ms']:.3f} ms, "
        f"{plain_note(x)}, bound {x['bound_ms']:.4f} ms "
        f"({x['bound_by']}); on its first 64 jobs "
        f"({x['first64']['band_cells']} band cells): "
        f"{x['first64']['ms']:.3f} ms, bound "
        f"{x['first64']['bound_ms']:.4f} ms ({x['first64']['bound_by']})")
    log(f"[kernels] traceback on the {tag} path's first launch's p ({N} "
        f"jobs, {y['visited']} diagonals visited, the longest walk "
        f"{y['longest_walk']} diagonals, {y['blocks_per_sm']} blocks per "
        f"SM): {y['ms']:.3f} ms = {y['ns_per_diagonal']:.1f} ns a "
        f"diagonal of the longest walk, {plain_note(y)}, "
        f"bound {y['bound_ms']:.6f} ms ({y['bound_by']}); on its first "
        f"64 jobs: {y['first64']['ms']:.3f} ms, bound "
        f"{y['first64']['bound_ms']:.6f} ms ({y['first64']['bound_by']})")


def phase_sr_kernels(srp, rows, path="sr"):
    """Phase 7 at the sr path's shapes, on phase 4b's first batch: the
    sketch at k21 w11 (512 x 1024), sort3 on its compaction and anchor
    keys, the chain on its anchor planes (512 x 2048, band 100), extd2 (W
    256, sr scores) and the traceback on its first align launch; each
    bit-equal to its plain version, timed, beside its bound.  Adds a
    ``path`` entry to each kernel's row (phase 6b's splice:sr pairs, k15
    w5, run the same shapes as "splice_sr")."""
    from minimap2_tpu_torch.ops import _build, chain, sketch, sort
    by = {r["name"]: r for r in rows}
    p_args = tuple(srp["sketch_in"])
    PB, PL = p_args[0].shape
    k_, w_ = p_args[2], p_args[3]
    e = max_abs_err(sketch.sketch_batch(*p_args),
                    sketch.device_sketch(*p_args))
    require(e == 0, f"sketch differs from its plain version on the {path} "
            f"path's first batch ({e})")
    s_ms, s_by = bound(PB * PL * 11 + PB * 4,
                       PB * PL * sketch_ops(w_))
    sk = dict(k=k_, w=w_, shape=[PB, PL], max_abs_err=e,
              ms=cuda_ms(lambda: sketch.sketch_batch(*p_args)),
              plain_ms=cuda_ms(lambda: sketch.device_sketch(*p_args), reps=3),
              bound_ms=s_ms, bound_by=s_by,
              blocks_per_sm=_build.blocks_per_sm("sketch", PL, w_))
    by["sketch"]["paths"][path] = sk
    by["sketch"]["max_abs_err"] = max(by["sketch"]["max_abs_err"], e)
    log(f"[kernels] sketch on the {path} path's first batch ({PB} x {PL}, k{k_} "
        f"w{w_}): bit-equal, {sk['ms']:.4f} ms, plain {sk['plain_ms']:.2f} "
        f"ms, bound {s_ms:.4f} ms ({s_by}), {sk['blocks_per_sm']} blocks "
        f"per SM")
    # the path's first compaction (512 x 1024) and anchor keys, both
    # through sort3_rows
    sr3 = {}
    for tag, keys in (("compaction", srp["compaction_keys"]),
                      ("anchors", srp["anchor_keys"])):
        e = max_abs_err(sort.sort3_rows(*keys), sort.sort3_rows_plain(*keys))
        require(e == 0, f"sort3_rows differs from its plain version on the {path}"
                f" path's first {tag} keys ({e})")
        B_, A_ = keys[0].shape
        b_ms, b_by = bound(B_ * A_ * 24, B_ * (A_ // 2) * sort_stages(A_) * 8)
        sr3[tag] = dict(
            shape=[B_, A_], max_abs_err=e,
            ms=cuda_ms(lambda k=keys: sort.sort3_rows(*k)),
            plain_ms=cuda_ms(lambda k=keys: sort.sort3_rows_plain(*k),
                             reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda k=keys: library_sort3(*k), reps=5),
            blocks_per_sm=_build.blocks_per_sm("sort3", A_))
        log(f"[kernels] sort3 on the {path} path's first {tag} keys ({B_} x "
            f"{A_}): bit-equal, {sr3[tag]['ms']:.4f} ms, plain "
            f"{sr3[tag]['plain_ms']:.2f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"torch.sort x3 {sr3[tag]['library_ms']:.4f} ms, "
            f"{sr3[tag]['blocks_per_sm']} blocks per SM")
    by["sort3"][path] = sr3
    by["sort3"]["max_abs_err"] = max(
        by["sort3"]["max_abs_err"], *(x["max_abs_err"] for x in sr3.values()))

    # the path's first batch (512 x 2048, band 100)
    sr_planes, sr_kw = srp["chain_in"]["args"], srp["chain_in"]["kw"]
    e = max_abs_err(chain.chain_batch(*sr_planes, **sr_kw),
                    chain.chain_batch_plain(*sr_planes, **sr_kw))
    require(e == 0, f"chain differs from its plain version on the {path} path's "
            f"first batch ({e})")
    B_, A_ = sr_planes[0].shape
    n_sr = int(sr_planes[5].sum())
    n_max_sr = chain.last_valid(sr_planes[5])
    b_ms, b_by = bound(B_ * A_ * (21 + 16), n_sr * sr_kw["WND"] * 30)
    sr_ms = cuda_ms(lambda: chain.chain_batch(*sr_planes, **sr_kw))
    by["chain"][path] = dict(
        shape=[B_, A_], bw=sr_kw["bw"], max_abs_err=e, ms=sr_ms,
        plain_ms=cuda_ms(lambda: chain.chain_batch_plain(*sr_planes, **sr_kw),
                         reps=2, warmup=1),
        bound_ms=b_ms, bound_by=b_by, valid_anchors=n_sr, longest_n=n_max_sr,
        ns_per_step=1e6 * sr_ms / max(n_max_sr, 1))
    by["chain"]["max_abs_err"] = max(by["chain"]["max_abs_err"], e)
    log(f"[kernels] chain on the {path} path's first batch ({B_} x {A_}, band "
        f"{sr_kw['bw']}, {n_sr} valid anchors, the longest read's n "
        f"{n_max_sr}): bit-equal, {sr_ms:.3f} ms, plain "
        f"{by['chain'][path]['plain_ms']:.1f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")

    ext, tb, ext_kw = _extd2_traceback(srp["first_job"])
    _log_extd2_traceback(path, ext, tb, ext_kw)
    for name, x in (("extd2", ext), ("traceback", tb)):
        by[name][path] = x      # its error joins the row's in finish


def phase_offdist_kernels(od, rows):
    """Phase 7 at phase 3c's off-distribution shapes, on its step's first
    batch: the sketch (256 x 32768, k15 w10), sort1 on the compaction's
    keys (256 x 32768, beside torch.sort), sort3 on the anchor keys (256 x
    8192) and the chain on the anchor planes (256 x 8192, band 500); each
    bit-equal to its plain version, timed, beside its bound, as an
    "offdist" entry of its kernel's row.  The plain chain runs once (its
    ~8192 serial steps cost seconds), which gives its time."""
    from minimap2_tpu_torch.ops import _build, chain, sketch, sort
    by = {r["name"]: r for r in rows}
    p_args = tuple(od["sketch_in"])
    PB, PL = p_args[0].shape
    k_, w_ = p_args[2], p_args[3]
    e = max_abs_err(sketch.sketch_batch(*p_args),
                    sketch.device_sketch(*p_args))
    require(e == 0, f"sketch differs from its plain version at {PB} x {PL} "
            f"({e})")
    b_ms, b_by = bound(PB * PL * 11 + PB * 4, PB * PL * sketch_ops(w_))
    x = by["sketch"]["paths"]["offdist"] = dict(
        k=k_, w=w_, shape=[PB, PL], max_abs_err=e,
        ms=cuda_ms(lambda: sketch.sketch_batch(*p_args)),
        plain_ms=cuda_ms(lambda: sketch.device_sketch(*p_args), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        blocks_per_sm=_build.blocks_per_sm("sketch", PL, w_))
    by["sketch"]["max_abs_err"] = max(by["sketch"]["max_abs_err"], e)
    log(f"[kernels] sketch on the offdist step's first batch ({PB} x {PL}, "
        f"k{k_} w{w_}): bit-equal, {x['ms']:.4f} ms, plain "
        f"{x['plain_ms']:.2f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{x['blocks_per_sm']} blocks per SM")

    keys = od["sort1_keys"]
    B, A = keys.shape
    got = sort.sort1_rows(keys)
    e = max_abs_err([got], [sort.sort1_rows_plain(keys)])
    require(e == 0, f"sort1 differs from its plain version on the offdist "
            f"compaction keys ({e})")
    require(torch.equal(got.to(torch.int64) & 0xFFFFFFFF, torch.sort(
        keys.to(torch.int64) & 0xFFFFFFFF, dim=1).values),
        "sort1 differs from torch.sort on the offdist compaction keys")
    del got
    b_ms, b_by = bound(8 * B * A, B * (A // 2) * sort_stages(A) * 2)
    x = by["sort1"]["offdist"] = dict(
        shape=[B, A], max_abs_err=e, ms=cuda_ms(lambda: sort.sort1_rows(keys)),
        plain_ms=cuda_ms(lambda: sort.sort1_rows_plain(keys), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(keys, dim=1), reps=5),
        blocks_per_sm=_build.blocks_per_sm("sort1", A))
    by["sort1"]["max_abs_err"] = max(by["sort1"]["max_abs_err"], e)
    for ln in ptxas_usage("sort1.cu"):
        if ln.startswith(f"sort1_kernel<{A}>"):
            log(f"[kernels] sort1.cu: {ln}")
    log(f"[kernels] sort1 on the offdist compaction keys ({B} x {A}): "
        f"bit-equal, {x['ms']:.4f} ms, plain {x['plain_ms']:.2f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), torch.sort {x['library_ms']:.4f} ms, "
        f"{x['blocks_per_sm']} blocks per SM")

    keys = od["anchor_keys"]
    B, A = keys[0].shape
    e = max_abs_err(sort.sort3_rows(*keys), sort.sort3_rows_plain(*keys))
    require(e == 0, f"sort3_rows differs from its plain version on the "
            f"offdist anchor keys ({e})")
    b_ms, b_by = bound(B * A * 24, B * (A // 2) * sort_stages(A) * 8)
    x = by["sort3"]["offdist"] = dict(
        shape=[B, A], max_abs_err=e,
        ms=cuda_ms(lambda: sort.sort3_rows(*keys)),
        plain_ms=cuda_ms(lambda: sort.sort3_rows_plain(*keys), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: library_sort3(*keys), reps=5),
        blocks_per_sm=_build.blocks_per_sm("sort3", A))
    by["sort3"]["max_abs_err"] = max(by["sort3"]["max_abs_err"], e)
    log(f"[kernels] sort3 on the offdist anchor keys ({B} x {A}): "
        f"bit-equal, {x['ms']:.4f} ms, plain {x['plain_ms']:.2f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), torch.sort x3 {x['library_ms']:.4f} ms, "
        f"{x['blocks_per_sm']} blocks per SM")

    planes, kw = od["chain_in"]["args"], od["chain_in"]["kw"]
    got = chain.chain_batch(*planes, **kw)
    want, plain_ms = timed_once(lambda: chain.chain_batch_plain(*planes,
                                                                **kw))
    e = max_abs_err(got, want)
    require(e == 0, f"chain differs from its plain version on the offdist "
            f"anchor planes ({e})")
    del got, want
    B, A = planes[0].shape
    n_anchor = int(planes[5].sum())
    n_max = chain.last_valid(planes[5])
    b_ms, b_by = bound(B * A * (21 + 16), n_anchor * kw["WND"] * 30)
    ch_ms = cuda_ms(lambda: chain.chain_batch(*planes, **kw))
    by["chain"]["offdist"] = dict(
        shape=[B, A], bw=kw["bw"], max_abs_err=e, ms=ch_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        valid_anchors=n_anchor, longest_n=n_max,
        ns_per_step=1e6 * ch_ms / max(n_max, 1))
    by["chain"]["max_abs_err"] = max(by["chain"]["max_abs_err"], e)
    log(f"[kernels] chain on the offdist anchor planes ({B} x {A}, band "
        f"{kw['bw']}, {n_anchor} valid anchors, the longest read's n "
        f"{n_max}): bit-equal, {ch_ms:.3f} ms, "
        f"{1e6 * ch_ms / max(n_max, 1):.1f} ns a step of the longest read, "
        f"plain {plain_ms:.1f} ms (one call), bound {b_ms:.4f} ms ({b_by})")


def phase_sort1_chunked(rows, B=256, L=65536):
    """Phase 7, sort1 past 32768 lanes: the minimizer compaction of a
    (256, 65536) sketch-like batch made from a seed (minimizer density
    2/11, as at w 10) with the launches counted around it, sort1_chunked
    required; its positions equal each row's minimizers in order; the
    chunked route (``sort.sort1_ascending``: one sort1 launch over
    32768-lane chunks and a scatter) bit-equal to sort1_rows_plain at full
    width on the compaction's key plane, timed beside torch.sort and its
    bound, as the "chunked" entry of the sort1 row."""
    from minimap2_tpu_torch.ops import sort
    from minimap2_tpu_torch.ops._build import launches
    from minimap2_tpu_torch.parallel import batch
    from minimap2_tpu_torch.utils.u32 import i32
    by = {r["name"]: r for r in rows}
    g = torch.Generator(device="cuda").manual_seed(16)
    is_mini = torch.rand((B, L), generator=g, device="cuda") < 2 / 11
    z = torch.randint(0, 2, (B, L), generator=g, device="cuda",
                      dtype=torch.int32)
    hhi, hlo = (i32(torch.randint(0, 1 << 32, (B, L), generator=g,
                                  device="cuda")) for _ in range(2))
    M = L // 4
    torch.cuda.synchronize()
    launches.clear()
    with torch.no_grad():
        mh_hi, mh_lo, mz, mpos, mvalid = batch._compact_minimizers(
            hhi, hlo, z, is_mini, M)
        torch.cuda.synchronize()
    counts = dict(launches)
    require(counts.get("sort1_chunked", 0) > 0,
            f"sort1 never launched chunked in the {B} x {L} compaction "
            f"({counts})")
    n = is_mini.sum(1)
    ar = torch.arange(M, device="cuda")[None, :]
    posi = torch.arange(L, device="cuda")[None, :]
    first = torch.sort(torch.where(is_mini, posi, L), dim=1).values[:, :M]
    require(torch.equal(mvalid, ar < n[:, None])
            and torch.equal(torch.where(mvalid, mpos, L), first.to(mpos.dtype))
            and torch.equal(torch.where(mvalid, mz, 0), torch.where(
                mvalid, torch.gather(z, 1, first.clamp(max=L - 1)), 0)),
            "the chunked compaction's minimizers differ from each row's "
            "minimizers in order")
    key = torch.where(is_mini, (posi.to(torch.int32) << 1) | z,
                      sort.KEY_NONE)
    got = sort.sort1_ascending(key)
    e = max_abs_err([got], [sort.sort1_rows_plain(key)])
    require(e == 0, f"the chunked sort1 route differs from sort1_rows_plain "
            f"at {B} x {L} ({e})")
    del got
    W = sort.SORT1_MAX_WIDTH
    b_ms, b_by = bound(8 * B * L, B * (L // 2) * sort_stages(W) * 2)
    x = by["sort1"]["chunked"] = dict(
        shape=[B, L], launches=counts["sort1_chunked"], max_abs_err=e,
        ms=cuda_ms(lambda: sort.sort1_ascending(key)),
        compaction_ms=cuda_ms(lambda: batch._compact_minimizers(
            hhi, hlo, z, is_mini, M)),
        plain_ms=cuda_ms(lambda: sort.sort1_rows_plain(key), reps=2,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(key, dim=1), reps=5))
    by["sort1"]["max_abs_err"] = max(by["sort1"]["max_abs_err"], e)
    log(f"[kernels] sort1 chunked ({B} x {L} as {B * L // W} rows of {W}, "
        f"{int(n.float().mean())} minimizers a row): bit-equal to "
        f"sort1_rows_plain at full width, {x['ms']:.4f} ms (the whole "
        f"compaction {x['compaction_ms']:.4f} ms), plain {x['plain_ms']:.2f}"
        f" ms, bound {b_ms:.4f} ms ({b_by}), torch.sort "
        f"{x['library_ms']:.4f} ms; launches {counts}")


def phase_rmq_kernels(lrq, mb, rows):
    """Phase 7 at phase 4c's shapes (lr:hqae, k25 w51) and phase 3e's
    (map_batch): the sketch on 4c's first batch and on random codes at k19
    w19 (asm5/asm10), sort3 on 4c's first compaction (chunked) and anchor
    keys, extd2 and the traceback on 4c's first align launch, and extd2's
    score-only mode on 3e's launch; each bit-equal to its plain version,
    timed, beside its bound.  Adds "lr:hqae" / "asm" entries to the
    kernel rows and the extd2 score-only row."""
    from minimap2_tpu_torch.ops import _build, extend, sketch, sort
    by = {r["name"]: r for r in rows}
    rng = np.random.default_rng(12)
    rnd = (torch.from_numpy(rng.integers(0, 4, (512, 16384))
                            .astype(np.uint8)).cuda(),
           torch.from_numpy(rng.integers(8192, 16385, 512)
                            .astype(np.int32)).cuda(), 19, 19)
    for tag, p_args in (("lr:hqae", tuple(lrq["sketch_in"])),
                        ("asm k19 w19 random", rnd)):
        PB, PL = p_args[0].shape
        k_, w_ = p_args[2], p_args[3]
        e = max_abs_err(sketch.sketch_batch(*p_args),
                        sketch.device_sketch(*p_args))
        require(e == 0, f"sketch differs from its plain version on {tag} "
                f"({PB} x {PL}, k{k_} w{w_}; {e})")
        s_ms, s_by = bound(PB * PL * 11 + PB * 4,
                           PB * PL * sketch_ops(w_))
        x = dict(k=k_, w=w_, shape=[PB, PL], max_abs_err=e,
                 ms=cuda_ms(lambda a=p_args: sketch.sketch_batch(*a)),
                 plain_ms=cuda_ms(lambda a=p_args: sketch.device_sketch(*a),
                                  reps=3),
                 bound_ms=s_ms, bound_by=s_by,
                 blocks_per_sm=_build.blocks_per_sm("sketch", PL, w_))
        by["sketch"]["paths"][tag] = x
        by["sketch"]["max_abs_err"] = max(by["sketch"]["max_abs_err"], e)
        log(f"[kernels] sketch on {tag} ({PB} x {PL}, k{k_} w{w_}): "
            f"bit-equal, {x['ms']:.4f} ms, plain {x['plain_ms']:.2f} ms, "
            f"bound {s_ms:.4f} ms ({s_by}), {x['blocks_per_sm']} blocks per "
            f"SM")

    def chunked_plain(c_args):
        B_, A_ = c_args[0].shape
        s_ = sort.sort3_rows_plain(*(x.reshape(-1, 2048) for x in c_args))
        return sort.sort3_rows_plain(*(x.view(B_, -1, 2048)[:, :, :1024]
                                       .reshape(B_, -1) for x in s_))
    c_keys, a_keys = lrq["compaction_keys"], lrq["anchor_keys"]
    B_, A_ = c_keys[0].shape
    require((B_, A_) == (512, 16384), f"lr:hqae compaction {B_} x {A_}")
    err_c = max_abs_err(sort.sort3_chunked(*c_keys), chunked_plain(c_keys))
    err_a = max_abs_err(sort.sort3_rows(*a_keys),
                        sort.sort3_rows_plain(*a_keys))
    require(err_c == 0 and err_a == 0, f"sort3 differs from its plain "
            f"version on the lr:hqae keys ({err_c}, {err_a})")
    merge_stages = sort_stages(8192) - sort_stages(1024)
    cb, cby = bound(B_ * A_ * 12 + B_ * 8192 * 12,
                    (B_ * 8 * 1024 * sort_stages(2048)
                     + B_ * 4096 * merge_stages) * 8)
    Ba, Aa = a_keys[0].shape
    ab_, aby = bound(Ba * Aa * 24, Ba * (Aa // 2) * sort_stages(Aa) * 8)
    x = dict(chunked=dict(
        shape=[B_, A_], max_abs_err=err_c,
        ms=cuda_ms(lambda: sort.sort3_chunked(*c_keys)),
        plain_ms=cuda_ms(lambda: chunked_plain(c_keys), reps=3),
        bound_ms=cb, bound_by=cby,
        library_ms=cuda_ms(lambda: library_sort3(*c_keys), reps=5)),
        anchors=dict(
        shape=[Ba, Aa], max_abs_err=err_a,
        ms=cuda_ms(lambda: sort.sort3_rows(*a_keys)),
        plain_ms=cuda_ms(lambda: sort.sort3_rows_plain(*a_keys), reps=3),
        bound_ms=ab_, bound_by=aby,
        library_ms=cuda_ms(lambda: library_sort3(*a_keys), reps=5)))
    by["sort3"]["lr:hqae"] = x
    log(f"[kernels] sort3 on lr:hqae's first compaction ({B_} x {A_}, "
        f"chunked) and anchor keys ({Ba} x {Aa}): bit-equal, "
        f"{x['chunked']['ms']:.4f} / {x['anchors']['ms']:.4f} ms, plain "
        f"{x['chunked']['plain_ms']:.2f} / {x['anchors']['plain_ms']:.2f} "
        f"ms, bound {cb:.4f} ({cby}) / {ab_:.4f} ({aby}) ms, torch.sort x3 "
        f"{x['chunked']['library_ms']:.4f} / "
        f"{x['anchors']['library_ms']:.4f} ms")

    # the same widths as the -a row (W 640, band 500), so the plain
    # versions take its first 32 jobs only
    ext, tb, ext_kw = _extd2_traceback(lrq["first_job"], n_plain=32)
    _log_extd2_traceback("lr:hqae", ext, tb, ext_kw)
    for name, x in (("extd2", ext), ("traceback", tb)):
        by[name]["lr:hqae"] = x      # its error joins the row's in finish

    # map_batch's launch: score only (no p), zdrop 400, G 16, RB 128
    (qr, sf, lens), kw = mb["first_job"]["args"], mb["first_job"]["kw"]
    require(kw["with_cigar"] is False and kw["zdrop"] >= 0,
            f"map_batch's extd2 launch is not score-only with zdrop ({kw})")
    N, QP = qr.shape
    TP, W, RB, w, G = kw["TP"], kw["W"], kw["RB"], kw["w"], kw["G"]
    RT = (kw["R"] + RB - 1) // RB * RB
    p_, ez = extend.extd2_batch2(qr, sf, lens, **kw)
    require(p_ is None, "score-only extd2 returned direction bytes")

    def plain():
        _, ezp = extend.extd2_batch2_plain(
            qr, sf, lens, W=W, RB=RB, RT=RT, q=kw["q"], e=kw["e"],
            q2=kw["q2"], e2=kw["e2"], w=w, sc_mch=kw["sc_mch"],
            sc_mis=kw["sc_mis"], sc_N=kw["sc_N"], with_cigar=False)
        return extend._ez_dead(ezp, lens, G, RB, RT)
    ezp, plain_ms = timed_once(plain)
    err = max_abs_err([ez], [ezp])
    require(err == 0, f"score-only extd2 differs from its plain version on "
            f"map_batch's launch ({err})")
    cells, bms, bby = _extd2_bound(lens, w, with_p=False)
    ms = cuda_ms(lambda: extend.extd2_batch2(qr, sf, lens, **kw), reps=5)
    row = dict(
        name="extd2_score_only", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/extd2.cu",
        replaces="minimap2_tpu/ops/extend_pallas2.py:658",
        launches=mb["launches"].get("extd2", 0), max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None,
        shape=[N, QP, TP, W], w=w, zdrop=kw["zdrop"], band_cells=cells,
        dp_cells_per_s=cells / (ms / 1e3),
        blocks_per_sm=_build.blocks_per_sm("extd2", W, QP, TP, 0))
    log(f"[kernels] extd2 score-only (map_batch's launch: {N} jobs, QP={QP},"
        f" TP={TP}, W={W}, w={w}, zdrop {kw['zdrop']}, {cells} band cells, "
        f"{row['blocks_per_sm']} blocks per SM): bit-equal ez, {ms:.3f} ms "
        f"= {row['dp_cells_per_s']:.4g} cell-updates/s, plain "
        f"{plain_ms:.0f} ms, bound {bms:.4f} ms ({bby})")
    rows.append(row)


def phase_new_kernels(hpc, spl):
    """sort1 on the HPC phase's first run-end keys (beside torch.sort);
    exts2 on the first 32 jobs of the splice phase's first launch (FOR
    rows) and on the whole launch, the splice traceback on those 32 jobs
    and on the whole launch; each against its plain version, bit-equal."""
    from minimap2_tpu_torch.ops import _build, exts, sort, traceback
    rows = []
    keys = hpc["sort1_keys"]
    B, A = keys.shape
    # the path's run-end keys, and 4 rows of full-range u32 (the top bit
    # set on half the lanes), each against the plain version and against
    # torch.sort in unsigned order
    rng = np.random.default_rng(9)
    full = torch.from_numpy(rng.integers(0, 1 << 32, (4, A), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).cuda()
    err = 0
    for tag, k in (("map-pb's first run-end keys", keys),
                   ("4 rows of full-range u32", full)):
        got = sort.sort1_rows(k)
        e = max_abs_err([got], [sort.sort1_rows_plain(k)])
        require(e == 0, f"sort1 differs from its plain version on {tag} "
                f"({e})")
        require(torch.equal(got.to(torch.int64) & 0xFFFFFFFF, torch.sort(
            k.to(torch.int64) & 0xFFFFFFFF, dim=1).values),
            f"sort1 differs from torch.sort on {tag}")
        err = max(err, e)
    del got
    for ln in ptxas_usage("sort1.cu"):
        if ln.startswith(f"sort1_kernel<{A}>"):
            log(f"[kernels] sort1.cu: {ln}")
    per_sm = _build.blocks_per_sm("sort1", A)
    # one plane: a compare-exchange is a min and a max (sort3's 8 count a
    # 64-bit and a 32-bit compare and six selects of a triple)
    bms, by = bound(8 * B * A, B * (A // 2) * sort_stages(A) * 2)
    rows.append(dict(
        name="sort1", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/sort1.cu",
        replaces="minimap2_tpu/ops/sort_pallas.py:130",
        launches=hpc["launches"].get("sort1", 0), max_abs_err=err,
        ms=cuda_ms(lambda: sort.sort1_rows(keys)),
        plain_ms=cuda_ms(lambda: sort.sort1_rows_plain(keys), reps=3),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: torch.sort(keys, dim=1), reps=5),
        shape=[B, A], blocks_per_sm=per_sm))
    log(f"[kernels] sort1 at {B} x {A} on map-pb's run-end keys: "
        f"{rows[-1]['ms']:.4f} ms, bound {bms:.4f} ms ({by}), torch.sort "
        f"{rows[-1]['library_ms']:.4f} ms, {per_sm} blocks per SM")

    launch = spl["first"]["args"]        # qr, sf, dn, ac, lens
    kw = spl["first"]["kw"]
    NL = launch[0].shape[0]
    W, RB = kw["W"], kw["RB"]
    ext, tb, p = _exts2_traceback_splice("the splice phase's first launch",
                                         spl["first"])
    _, QP, _, _, RT = ext["shape"]
    del p
    # the whole first launch, compared 16 jobs at a time, and the splice
    # traceback on its p (in the deferred checks when main runs them)
    pl, ezl = exts.exts2_batch(*launch, **kw)
    if DEFER is not None:
        key = DEFER.add("exts2_launch", RT, args=list(launch), kw=kw)
        res_l, res_tl = (dict(max_abs_err=None, plain_ms=None,
                              deferred=f"{key}:{part}")
                         for part in ("launch_ext", "launch_tb"))
    else:
        res_l, res_tl = _exts2_launch_plain(launch, kw, pl, ezl)
        require(res_l["max_abs_err"] == 0 and res_tl["max_abs_err"] == 0,
                f"exts2 or the splice traceback differs from its plain "
                f"version on the whole first launch ({res_l}, {res_tl})")
    l_cells, l_bms, l_by = _exts2_bound(launch[4])
    launch_ms = cuda_ms(lambda: exts.exts2_batch(*launch, **kw), reps=3)
    memset_ms = cuda_ms(lambda: torch.zeros((NL, RT, W), dtype=torch.uint8,
                                            device="cuda"), reps=3)
    per_sm = _build.blocks_per_sm("exts2", W, QP, kw["TP"], 0)
    log(f"[kernels] exts2 on the splice phase's first launch, {NL} jobs "
        f"(both strand rounds), {l_cells} DP cells: {launch_ms:.3f} ms "
        f"(of it {memset_ms:.3f} ms zeroing p), {plain_note(res_l)}, "
        f"bound {l_bms:.4f} ms ({l_by}); {per_sm} blocks per SM")
    rows.append(dict(
        name="exts2", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/exts2.cu",
        replaces="minimap2_tpu/ops/exts_pallas.py:525",
        launches=spl["launches"].get("exts2", 0),
        max_abs_err=ext["max_abs_err"],     # the launch's joins in finish
        library_ms=None,
        **{k: v for k, v in ext.items() if k != "max_abs_err"},
        launch=dict(jobs=NL, blocks_per_sm=per_sm, dp_cells=l_cells,
                    ms=launch_ms, memset_ms=memset_ms, bound_ms=l_bms,
                    bound_by=l_by, **res_l)))

    tkw = dict(RB=RB, w=0, splice=True, QP=QP)
    # the whole first launch (both strand rounds of a sub-batch)
    lens_l = launch[4]
    opsl, finl = traceback.traceback_batch(pl, lens_l, **tkw)
    visited_l = int((opsl != 0).sum())
    walk = longest_walk(opsl)
    tl_bms, tl_by = bound(visited_l + NL * RT + NL * 8 + NL * 8, 0)
    tbl_ms = cuda_ms(lambda: traceback.traceback_batch(pl, lens_l, **tkw),
                     reps=5)
    tb_sm = _build.blocks_per_sm("traceback", 1)
    del pl
    log(f"[kernels] splice traceback on the whole launch's p ({NL} jobs, "
        f"{visited_l} diagonals visited, the longest walk {walk} diagonals, "
        f"{tb_sm} blocks per SM): {tbl_ms:.3f} ms = "
        f"{1e6 * tbl_ms / max(walk, 1):.1f} ns a diagonal of the longest "
        f"walk, {plain_note(res_tl)}, bound {tl_bms:.6f} ms ({tl_by})")
    rows.append(dict(
        name="traceback_splice", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/traceback.cu",
        replaces="minimap2_tpu/ops/traceback_pallas.py:155",
        launches=spl["launches"].get("traceback_splice", 0),
        max_abs_err=tb["max_abs_err"],      # the launch's joins in finish
        library_ms=None,
        **{k: v for k, v in tb.items() if k != "max_abs_err"},
        launch=dict(jobs=NL, ms=tbl_ms, **res_tl,
                    bound_ms=tl_bms, bound_by=tl_by,
                    visited=visited_l, longest_walk=walk,
                    ns_per_diagonal=1e6 * tbl_ms / max(walk, 1),
                    blocks_per_sm=tb_sm)))
    return rows


def _wide_call(run, sam, L=None, **align_kw):
    """A call for _align_run: engine.run_batched_align_cli on an earlier
    -a phase's index (its host MiniIndex: no .mmi load) and reads, at
    these align_kw (and L), writing sam; the options are run's, or
    run["wide_opt"] where given."""
    from minimap2_tpu_torch.parallel import engine

    def call():
        kw = {} if L is None else {"L": L}
        with open(sam, "w") as out:
            engine.run_batched_align_cli(
                run["mi"], run.get("wide_opt", run["opt"]), [run["rd"]],
                out, align_kw=align_kw, **kw)
        return 0
    return call


def phase_wide_align(aln, main, tmp):
    """-a at the full band of 1000 (as the asm presets and -r 1000 users
    get it from the reference): phase 4's reads and index through
    engine.run_batched_align_cli with phase 4's options at -r 1000,20000
    and align_kw W 1152, so extd2 runs a band of 1000 lanes (at the
    default W 640 the batcher clamps it to 560).  Phase 4's gates; the
    first align launch is recorded for phase 7."""
    from minimap2_tpu_torch.parallel import align_batch
    sam = os.path.join(tmp, "wide.sam")
    opt = copy.copy(aln["opt"])
    opt.bw, opt.bw_long = 1000, 20000          # -r 1000,20000
    first_job = {}
    run = _align_run(
        "align W1152", ["-o", sam],
        ("sketch", "sort3", "sort3_merge", "chain", "extd2", "traceback"),
        [_capture_first(align_batch, "_align_step", first_job)],
        _wide_call(dict(aln, wide_opt=opt), sam, W=1152))
    ab = run["ab"]
    require(ab.W == 1152 and ab.w == 1000, f"the -a W 1152 run's batcher "
            f"took W {ab.W}, band {ab.w}")
    gates, mean_ident = _align_gates("align W1152", run, main["rnames"],
                                     0.03)
    return dict(run, first_job=first_job, mean_identity=mean_ident,
                gates=gates)


def _splice_gates(tag, run, main):
    """The splice path's gates on an _align_run of phase 6's reads: every
    primary CIGAR spans its read and its Reg's reference interval, >= 90%
    of primaries on their gene, no wrong mapq-60 primary, >= 80% of the
    true introns matched exactly by an N op.  Returns (gates, the share of
    introns matched)."""
    prim, prim_regs = run["prim"], run["prim_regs"]
    n_ok = n_q60 = n_q60_wrong = n_in = n_in_ok = 0
    bad_cigar = []
    missed = Counter()      # why a true intron has no exact N op
    for nm in main["gnames"]:
        true_in = main["introns"][nm]
        n_in += len(true_in)
        t = prim.get(nm)
        if t is None:
            missed["read without a primary"] += len(true_in)
            continue
        _, chrom, st, en, _ = nm.split("!")
        q_len, r_len, ops = _cigar_spans(t[5])
        rs, re_, qlen = prim_regs[nm]
        pos = int(t[3]) - 1
        if q_len != qlen or r_len != re_ - rs or pos != rs:
            bad_cigar.append(nm)
        ok = t[2] == chrom and pos < int(en) and pos + r_len > int(st)
        n_ok += ok
        if int(t[4]) == 60:
            n_q60 += 1
            n_q60_wrong += not ok
        got_in, x = set(), pos
        for n_, o in ops:
            if o == "N":
                got_in.add((x, x + int(n_)))
            if o in "MDN=X":
                x += int(n_)
        n_in_ok += sum(iv in got_in for iv in true_in)
        for a, b in true_in:
            if (a, b) in got_in:
                continue
            if not ok:
                missed["primary off its gene"] += 1
            elif a < pos or b > pos + r_len:
                missed["outside the aligned interval"] += 1
            else:
                missed["inside it, not matched"] += 1
    frac = n_ok / len(main["gnames"])
    in_frac = n_in_ok / max(n_in, 1)
    log(f"[{tag}] {n_ok}/{len(main['gnames'])} primaries on their gene "
        f"({100 * frac:.1f}%), {n_q60} at mapq 60 of which {n_q60_wrong} "
        f"wrong; {n_in_ok}/{n_in} true introns matched exactly by an N op "
        f"({100 * in_frac:.1f}%); {len(prim) - len(bad_cigar)}/{len(prim)} "
        "CIGARs span read and reference interval")
    log(f"[{tag}] true introns without an exact N op, by where they lie: "
        f"{dict(missed)}")
    gates = [(not bad_cigar, f"{tag} CIGAR lengths disagree for "
              f"{bad_cigar[:5]}"),
             (frac >= 0.90, f"only {100 * frac:.1f}% of {tag} primaries "
              "on their gene"),
             (n_q60_wrong == 0, f"{n_q60_wrong} wrong mapq-60 {tag} "
              "primaries"),
             (in_frac >= 0.80, f"only {100 * in_frac:.1f}% of the true "
              f"introns matched ({tag})")]
    return gates, in_frac


def phase_wide_splice(spl, main, tmp):
    """The spliced -a path at QP 4096 (the read bucket of full-length cDNA
    and Iso-Seq-like reads of 2-4 kb): phase 6's reads and index through
    engine.run_batched_align_cli at L 4096 and align_kw QP 4096, sub 128,
    so exts2 runs at W 4224 (both strand rounds of 128 jobs a launch).
    Phase 6's gates; the first exts2 launch is recorded for phase 7."""
    from minimap2_tpu_torch.parallel import align_batch
    sam = os.path.join(tmp, "wide_splice.sam")
    first = {}
    run = _align_run(
        "splice QP4096", ["-o", sam],
        # (at L 4096 the compaction keys fit one sort3 row: no merge)
        ("sketch", "sort3", "chain", "exts2", "traceback_splice"),
        [_capture_first(align_batch, "exts2_batch", first)],
        _wide_call(spl, sam, L=4096, QP=4096, sub=128))
    require(run["ab"].W == 4224, f"the splice QP 4096 run's batcher took W "
            f"{run['ab'].W}")
    gates, in_frac = _splice_gates("splice QP4096", run, main)
    return dict(run, first=first, gates=gates, intron_share=in_frac)


def phase_wide_chain(main, tmp):
    """PAF at chain_window 128: phase 3's first 512 reads through a
    PafStep of phase 3's widths (B 512, A 4096: the chain kernel's route)
    whose BatchParams take chain_window 128; phase 3's accuracy gates on
    those reads."""
    from minimap2_tpu_torch.io.fastx import read_fasta
    from minimap2_tpu_torch.parallel import engine
    step0 = main["step"]
    step = engine.PafStep(step0.di, dataclasses.replace(
        step0.p, chain_window=128), step0.K, step0.min_sc, step0.with_sec,
        step0.with_wp)
    names, seqs = read_fasta(main["rd"])
    rd, paf = (os.path.join(tmp, f) for f in ("w128.fa", "w128.paf"))
    with open(rd, "wb") as f:
        for nm, sq in zip(names[:512], seqs[:512]):
            f.write(b">" + nm.encode() + b"\n" + sq + b"\n")
    run = _map_on_card("paf WND128", step, main["mi"], rd, paf, 512,
                       ("sketch", "sort3", "sort3_merge", "chain_w128"))
    require(run["launches"].get("chain", 0) == 0, "the chain_window 128 "
            "run launched the WND 64 kernel")
    paf_accuracy("paf WND128", paf, main["rnames"][:512])
    return dict(run, step=step)


def _launch_counted(name, fn):
    """fn() with the launches it made counted (a Counter of kernel names);
    fails unless it launched ``name`` once."""
    from minimap2_tpu_torch.ops import _build
    before = Counter(_build.launches)
    out = fn()
    torch.cuda.synchronize()
    made = Counter(_build.launches) - before
    require(made.get(name, 0) == 1, f"{name} did not launch once "
            f"({dict(made)})")
    return out, made[name]


def _wide_cdna_jobs(rng, n, QP, TP, qlen, intron, n_in):
    """n cDNA-like splice jobs: a query of qlen = (lo, hi) bases (1%
    substitutions) against its genomic span, with n_in GT..AG introns of
    intron = (lo, hi) bases."""
    qr = np.zeros((n, QP), np.uint8)
    sf = np.zeros((n, TP), np.uint8)
    lens = np.zeros((n, 2), np.int32)
    for i in range(n):
        ql = int(rng.integers(qlen[0], qlen[1] + 1))
        q = rng.integers(0, 4, ql).astype(np.uint8)
        cuts = np.sort(rng.choice(np.arange(100, ql - 100), n_in,
                                  replace=False))
        parts, prev = [], 0
        for c in list(cuts) + [ql]:
            parts.append(q[prev:c])
            if c < ql:
                iv = rng.integers(0, 4, int(rng.integers(intron[0],
                                                         intron[1] + 1)))
                iv[:2], iv[-2:] = (2, 3), (0, 2)
                parts.append(iv.astype(np.uint8))
            prev = c
        t = np.concatenate(parts)[:TP]
        mm = rng.random(ql) < 0.01
        q[mm] = (q[mm] + 1) % 4
        qr[i, :ql] = q[::-1]
        sf[i, :len(t)] = t
        lens[i] = (ql, len(t))
    return qr, sf, lens


def _chain_ops(av, WND):
    """Window slots the chain DP scores on these anchors: each read's
    anchors up to its last valid one, each against min(a, WND) earlier
    slots."""
    n = torch.where(av, torch.arange(av.shape[1], device=av.device),
                    -1).amax(1).cpu().numpy().astype(np.int64) + 1
    return int(sum(int(np.minimum(np.arange(k), WND).sum()) for k in n))


def phase_wide_dp(rows):
    """Phase 7's wide DP rows: each DP kernel's routes past one block and
    past one block's shared memory through its entry point, on jobs whose
    DP reaches the row's wide lanes, each launch counted around its call
    and timed beside its bound; the jobs of that launch that reach a lane
    past the row's mark with the fewest diagonals are held against the
    plain version (p and ez sliced from the counted launch, bit-equal; in
    the deferred checks when main runs them)."""
    from minimap2_tpu_torch.ops import _build, exts, extend
    for src in ("extd2.cu", "exts2.cu", "chain.cu"):
        for ln in ptxas_usage(src):
            log(f"[kernels] {src}: {ln}")
    rng = np.random.default_rng(19)
    # extd2 (-a scoring): W 2048, 4096 on the register route, 8192 past
    # one block (the slab route: a band of ~4040 lanes is ~1010 groups of
    # four for its 512 threads) in the approx and exact modes, and W 640
    # on planes past one block's shared memory (QP = TP = 114688, jobs of
    # 900-1400 bases); the check takes n_chk jobs whose DP reaches a lane
    # past `past`
    ek = dict(q=4, e=2, q2=24, e2=1, sc_mch=2, sc_mis=-4, sc_N=-1)
    approx = dict(approx_max=True, right_mode=False, approx_drop=False,
                  with_cigar=True)
    exact = dict(approx_max=False, right_mode=False, approx_drop=False,
                 with_cigar=True)
    dspecs = []
    for name, W, n, QP, lo, hi, m, n_chk, past in (
            ("extd2_w2048", 2048, 16, 2560, 1700, 2100, approx, 4, 1536),
            ("extd2_w4096", 4096, 16, 4096, 3300, 3800, approx, 2, 3072),
            ("extd2_w8192", 8192, 16, 6144, 4600, 5400, approx, 2, 4096),
            ("extd2_exact_w8192", 8192, 16, 6144, 4600, 5400, exact, 2,
             4096),
            ("extd2_gp", 640, 16, 114688, 900, 1400, approx, 4, 0)):
        TP, RB = QP, 128
        d_in = [torch.from_numpy(a).cuda()
                for a in _mode_ont_jobs(rng, n, QP, TP, lo, hi)]
        drift = -(-(RB // 2) // 16) * 16
        kw = dict(G=16, W=W, RB=RB, R=QP + TP, QP=QP, TP=TP,
                  w=min(W - 48 - drift, 500 if W == 640 else W), zdrop=400,
                  **ek)
        dspecs.append((name, "extd2", d_in, kw, m, n_chk, past))
    # exts2 (splice scoring): W 8320 on the register route (queries of
    # 4500-5200 bases) and past one block in the exact mode (6300-7000
    # bases: more 16-lane groups than its threads), 16512 past one block
    # (8500-9500 bases), and W 2176 on planes past one block's shared
    # memory (TP 131072, introns of 80-120 kb)
    sk = dict(q=2, e=1, q2=32, sc_mch=1, sc_mis=-2, sc_N=-1)
    for name, QP, TP, n, ql, intr, n_in, m, n_chk, past in (
            ("exts2_w8320", 8192, 8192, 4, (4500, 5200), (300, 800), 2,
             approx, 2, 4096),
            ("exts2_exact_w8320", 8192, 9216, 4, (6300, 7000), (300, 800),
             2, exact, 2, 6144),
            ("exts2_w16512", 16384, 12288, 2, (8500, 9500), (300, 800), 2,
             approx, 1, 8320),
            ("exts2_gp", 2048, 131072, 2, (1500, 2000), (80000, 120000),
             1, approx, 1, 0)):
        qr, sf, lens = _wide_cdna_jobs(rng, n, QP, TP, ql, intr, n_in)
        dn, ac = exts.splice_site_arrays(sf, lens[:, 1], True, 9, True,
                                         False)
        s_in = [torch.from_numpy(x).cuda() for x in (qr, sf, dn, ac, lens)]
        kw = dict(G=8, W=(QP + 32 + 127) // 128 * 128, RB=64, R=QP + TP,
                  QP=QP, TP=TP, zdrop=200, **sk)
        dspecs.append((name, "exts2", s_in, kw, m, n_chk, past))
    torch.cuda.synchronize()
    for name, kind, args, kw, m, n_chk, past in dspecs:
        fn = extend.extd2_batch2 if kind == "extd2" else exts.exts2_batch
        mode = (int(not m["approx_max"]) | int(m["right_mode"]) << 1
                | int(m["approx_drop"]) << 2)
        plan = _build.dp_plan(kind, kw["W"], kw["QP"], kw["TP"], mode)
        lname = (extend.launch_name(m["approx_max"], False, False,
                                    plan["route"]) if kind == "extd2"
                 else exts.launch_name(m["approx_max"], False, False, True,
                                       plan["route"]))
        (p, ez), n_launch = _launch_counted(
            lname, lambda: fn(*args, **kw, **m))
        lens_t = args[2] if kind == "extd2" else args[4]
        N, W = lens_t.shape[0], kw["W"]
        nr = ez[:, extend.EZ_NR]
        reach = (lane_reach(lens_t, kw["w"], kw["RB"], nr=nr)
                 if kind == "extd2" else lane_reach(lens_t, QP=kw["QP"],
                                                    nr=nr))
        sub = wide_jobs(lens_t, n_chk, reach, past)
        sl = job_slice(p, ez, lens_t, sub, p.shape[1])
        del p
        s_args = [a[sub].cpu() for a in args]
        if DEFER is not None:
            key = DEFER.add("slice", int((lens_t[sub].sum(1) - 1).max()),
                            dp=kind, args=s_args, kw=kw, m=m, sl=sl)
            res = dict(max_abs_err=None, plain_ms=None, plain_jobs=n_chk,
                       deferred=f"{key}:dp")
        else:
            res = _slice_plain(kind, s_args, kw, m, sl)
            require(res["max_abs_err"] == 0, f"{name} differs from its "
                    f"plain version ({res['max_abs_err']})")
        del sl
        ex = not m["approx_max"]
        nr = nr.cpu().numpy()
        if kind == "extd2":
            cells, bms, bby = _extd2_bound(lens_t, kw["w"], nr, 40 + 8 * ex)
        else:
            cells, bms, bby = _exts2_bound(lens_t, nr, 45 + 8 * ex)
        ms = cuda_ms(lambda: fn(*args, **kw, **m), reps=3)
        rows.append(dict(
            name=name, route="cuda",
            source=f"minimap2_tpu_torch/ops/csrc/{kind}.cu",
            replaces=("minimap2_tpu/ops/extend_pallas2.py:658"
                      if kind == "extd2"
                      else "minimap2_tpu/ops/exts_pallas.py:525"),
            launches=n_launch, **res, ms=ms, bound_ms=bms, bound_by=bby,
            library_ms=None, counter=lname, kernel_route=plan["route"],
            threads=plan["threads"], smem=plan["smem"],
            scratch_per_job=plan["scratch"],
            blocks_per_sm=plan["blocks_per_sm"],
            shape=[N, kw["QP"], kw["TP"], W], band=kw.get("w"),
            widest_lane=int(reach.max()),
            checked_jobs=[[int(x) for x in lens_t[i].tolist()]
                          + [int(reach[i])] for i in sub.tolist()],
            dp_cells=cells, dp_cells_per_s=cells / (ms / 1e3),
            z_dropped=_zdropped(ez, lens_t, kw.get("w"))))
        r = rows[-1]
        log(f"[kernels] {name} ({N} jobs, QP={kw['QP']}, TP={kw['TP']}, "
            f"W={W}, band {kw.get('w')}; route {plan['route']}, "
            f"{plan['threads']} threads, {plan['smem']} bytes of shared "
            f"memory, {plan['scratch']} bytes of rows a job, "
            f"{plan['blocks_per_sm']} blocks per SM; {cells} DP cells; "
            f"widest lane {r['widest_lane']}; checked jobs (qlen, tlen, "
            f"widest lane) {r['checked_jobs']}): "
            f"{ms:.3f} ms = {r['dp_cells_per_s']:.4g} cell-updates/s, "
            f"{plain_note(r)}, bound {bms:.4f} ms ({bby})")
    del dspecs
    torch.cuda.empty_cache()


def _chain_plain(args, kw):
    """The chain kernel against its plain version on the same anchor
    planes: f, pred, qs and rs bit-equal.  Returns {max_abs_err, plain_ms,
    plain_jobs}."""
    from minimap2_tpu_torch.ops import chain
    got = chain.chain_batch(*args, **kw)
    want, plain_ms = timed_once(lambda: chain.chain_batch_plain(*args, **kw))
    return dict(max_abs_err=max_abs_err(got, want), plain_ms=plain_ms,
                plain_jobs=args[0].shape[0])


def wide_chain_rows(planes, p, rows, w128_launches=None):
    """The chain at WND 32, 128 (registers: 1 and 4 slots a lane), 1000 and
    5000 (the ring in shared memory) on anchor planes (B, A), through its
    entry point at BatchParams p's band, each launch counted around its
    call, timed beside its bound and held bit-equal to the plain version
    on the first 32 reads.  The WND 128 row counts the launches
    w128_launches gives (the PAF WND 128 run's) where given."""
    from minimap2_tpu_torch.ops import _build, chain
    B, A = planes[0].shape
    first = [x[:32] for x in planes]
    for WND in (32, 128, 1000, 5000):
        kw = dict(WND=WND, max_dist_x=p.max_dist_x, max_dist_y=p.max_dist_y,
                  bw=p.bw, chn_pen_gap=p.chn_pen_gap,
                  chn_pen_skip=p.chn_pen_skip)
        lname = chain.launch_name(WND)
        _, n_launch = _launch_counted(
            lname, lambda: chain.chain_batch(*planes, **kw))
        if DEFER is not None:
            key = DEFER.add("chain", int(planes[5][:32].sum()),
                            args=list(first), kw=kw)
            res = dict(max_abs_err=None, plain_ms=None, plain_jobs=32,
                       deferred=f"{key}:chain")
        else:
            res = _chain_plain(first, kw)
            require(res["max_abs_err"] == 0, f"chain at WND {WND} differs "
                    f"from its plain version ({res['max_abs_err']})")
        ops = _chain_ops(planes[5], WND)
        bms, by = bound(B * A * (21 + 16), ops * 30)
        ms = cuda_ms(lambda: chain.chain_batch(*planes, **kw), reps=3)
        n_max = chain.last_valid(planes[5])
        rows.append(dict(
            name=f"chain_w{WND}", route="cuda",
            source="minimap2_tpu_torch/ops/csrc/chain.cu",
            replaces="minimap2_tpu/ops/chain_pallas.py:166",
            launches=(w128_launches if WND == 128
                      and w128_launches is not None else n_launch),
            **res, ms=ms, bound_ms=bms, bound_by=by, library_ms=None,
            shape=[B, A],
            window=WND, slots_a_lane=chain.slots_a_lane(WND),
            window_slots_scored=ops, ns_per_step=1e6 * ms / max(n_max, 1),
            blocks_per_sm=_build.blocks_per_sm("chain", WND)))
        r = rows[-1]
        log(f"[kernels] chain at WND {WND} ({B} x {A}, "
            + (f"{r['slots_a_lane']} slots a lane" if r["slots_a_lane"]
               else "the window in a shared ring") + ", "
            f"{r['blocks_per_sm']} blocks per SM): {ms:.3f} ms "
            f"({r['ns_per_step']:.1f} ns a step of the longest read), "
            f"{plain_note(r)}, bound {bms:.4f} ms ({by})")
    chain_64 = next((x for x in rows if x["name"] == "chain"), None)
    if chain_64 is not None:
        w128 = next(x for x in rows if x["name"] == "chain_w128")
        log(f"[kernels] chain at WND 128 {w128['ms']:.3f} ms against WND "
            f"64 (phase 3's) {chain_64['ms']:.3f} ms")


def phase_wide_kernels(main, wal, wsp, wch, rows):
    """Phase 7's wide part: the wide DP rows (phase_wide_dp), the chain at
    other windows on phase 3's first batch's anchors (wide_chain_rows),
    then the rows of the three new paths: extd2 and the traceback on the
    -a W 1152 run's first launch, exts2 and the splice traceback on the
    splice QP 4096 run's first launch, each timed beside the paths' own
    launch at the default widths."""
    from minimap2_tpu_torch.ops import _build, extend, exts, traceback
    phase_wide_dp(rows)
    step = main["step"]
    with torch.no_grad():
        planes = step.seed(*(x.cuda() for x in
                             _first_batch(step, main["rd"], 512)))[:6]
    wide_chain_rows(planes, step.p, rows,
                    wch["launches"].get("chain_w128", 0))
    del planes

    # the three new paths: -a at W 1152, splice at QP 4096; each check
    # takes the jobs of the timed launch that reach past the lanes of the
    # earlier limit (W 1024) or bucket (W 2176)
    lens_a, kw_a = wal["first_job"]["args"][2], wal["first_job"]["kw"]
    reach = lane_reach(lens_a, kw_a["w"], kw_a["RB"])
    ext, tb, ext_kw = _extd2_traceback(
        wal["first_job"], subset=wide_jobs(lens_a, 32, reach, 1024))
    _log_extd2_traceback("-a W1152", ext, tb, ext_kw)
    log(f"[kernels] -a W1152: {int((reach > 1024).sum())} of "
        f"{len(reach)} jobs of its first launch reach a lane past 1024, "
        f"the widest {int(reach.max())}")
    rows.append(dict(
        name="extd2_w1152", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/extd2.cu",
        replaces="minimap2_tpu/ops/extend_pallas2.py:658",
        launches=wal["launches"].get("extd2", 0), **ext, library_ms=None,
        band=ext_kw["w"], widest_lane=int(reach.max()),
        jobs_past_1024=int((reach > 1024).sum())))
    rows.append(dict(
        name="traceback_w1152", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/traceback.cu",
        replaces="minimap2_tpu/ops/traceback_pallas.py:155",
        launches=wal["launches"].get("traceback", 0), **tb,
        library_ms=None))
    x640 = next((x for x in rows if x["name"] == "extd2"), None)
    if x640 is not None:
        log(f"[kernels] extd2 on the -a W 1152 run's first launch "
            f"{ext['ms']:.3f} ms against phase 4's at W 640 "
            f"{x640['ms']:.3f} ms")
    launch = wsp["first"]["args"]        # qr, sf, dn, ac, lens
    kw = wsp["first"]["kw"]
    N, QP = launch[0].shape
    W, RB, TP = kw["W"], kw["RB"], kw["TP"]
    pl, ezl = exts.exts2_batch(*launch, **kw)
    RT = pl.shape[1]
    tkw = dict(RB=RB, w=0, splice=True, QP=QP)
    ops, fin = traceback.traceback_batch(pl, launch[4], **tkw)
    # the plain check on up to 16 of its jobs (both rounds' rows) that
    # reach a lane past the QP 2048 bucket's W 2176 (its reads are cDNA
    # of at most 2000 bases: their lanes past it are target positions
    # past 2176 on the diagonals before 4096), sliced from this launch
    reach = lane_reach(launch[4], QP=QP, nr=ezl[:, extend.EZ_NR])
    sub = wide_jobs(launch[4], 16, reach, 2176, least=4)
    n_p = len(sub)
    sl = dict(job_slice(pl, ezl, launch[4], sub, RT), ops=ops[sub].cpu(),
              fin=fin[sub].cpu())
    s_args = [x[sub].cpu() for x in launch]
    log(f"[kernels] splice QP4096: {int((reach > 2176).sum())} of {N} jobs "
        f"of its first launch reach a lane past 2176, "
        f"{int((reach > 4096).sum())} past 4096, the widest "
        f"{int(reach.max())}; longest query {int(launch[4][:, 0].max())}")
    if DEFER is not None:
        key = DEFER.add("exts2_launch",
                        int((launch[4][sub].sum(1) - 1).max()),
                        args=s_args, kw=kw, sl=sl)
        res_e, res_t = (dict(max_abs_err=None, plain_ms=None,
                             plain_jobs=n_p, deferred=f"{key}:{part}")
                        for part in ("launch_ext", "launch_tb"))
    else:
        res_e, res_t = (dict(x, plain_jobs=n_p) for x in
                        _exts2_launch_plain(s_args, kw, sl=sl))
        require(res_e["max_abs_err"] == 0 and res_t["max_abs_err"] == 0,
                f"exts2 or the splice traceback at W {W} differs from its "
                f"plain version ({res_e}, {res_t})")
    del sl
    cells, bms, bby = _exts2_bound(launch[4])
    ms = cuda_ms(lambda: exts.exts2_batch(*launch, **kw), reps=3)
    plan = _build.dp_plan("exts2", W, QP, TP, 0)
    rows.append(dict(
        name="exts2_w4224", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/exts2.cu",
        replaces="minimap2_tpu/ops/exts_pallas.py:525",
        launches=wsp["launches"].get("exts2", 0), **res_e, ms=ms,
        bound_ms=bms, bound_by=bby, library_ms=None,
        shape=[N, QP, TP, W, RT], dp_cells=cells,
        kernel_route=plan["route"], threads=plan["threads"],
        blocks_per_sm=plan["blocks_per_sm"], widest_lane=int(reach.max()),
        jobs_past_2176=int((reach > 2176).sum()),
        longest_query=int(launch[4][:, 0].max())))
    visited = int((ops != 0).sum())
    tbms, tby = bound(visited + N * RT + N * 16, 0)
    tb_ms = cuda_ms(lambda: traceback.traceback_batch(pl, launch[4], **tkw),
                    reps=3)
    rows.append(dict(
        name="traceback_splice_w4224", route="cuda",
        source="minimap2_tpu_torch/ops/csrc/traceback.cu",
        replaces="minimap2_tpu/ops/traceback_pallas.py:155",
        launches=wsp["launches"].get("traceback_splice", 0), **res_t,
        ms=tb_ms, bound_ms=tbms, bound_by=tby, library_ms=None,
        shape=[N, RT, W], visited=visited))
    del pl, ezl, ops, fin
    x2176 = next((x for x in rows if x["name"] == "exts2"), None)
    log(f"[kernels] exts2 on the splice QP 4096 run's first launch ({N} "
        f"jobs, W {W}, route {plan['route']}, {plan['threads']} threads, "
        f"{cells} DP cells): {ms:.3f} ms, {plain_note(res_e)}, bound "
        f"{bms:.4f} ms ({bby})"
        + (f"; phase 6's launch at W 2176 {x2176['ms']:.3f} ms"
           if x2176 else "")
        + f"; the splice traceback on its p {tb_ms:.3f} ms, bound "
        f"{tbms:.6f} ms ({tby})")


def _mode_ont_jobs(rng, n, QP, TP, lo=900, hi=1400):
    """n ONT-like extension jobs of lo-hi query bases (5% substitutions,
    2.5% insertions and deletions each); in every other job the target
    turns random after 30-60% of its length, so the exact and approx-drop
    modes z-drop there."""
    qr = np.zeros((n, QP), np.uint8)
    sf = np.zeros((n, TP), np.uint8)
    lens = np.zeros((n, 2), np.int32)
    for i in range(n):
        ql = int(rng.integers(lo, min(QP, hi) + 1))
        q = rng.integers(0, 4, ql).astype(np.uint8)
        t = np.where(rng.random(ql) < 0.05, (q + rng.integers(1, 4, ql)) % 4,
                     q)[rng.random(ql) >= 0.025]
        ins = rng.random(len(t)) < 0.025
        out = rng.integers(0, 4, len(t) + int(ins.sum()))
        out[np.arange(len(t)) + np.cumsum(ins) - ins] = t
        t = out[:TP].astype(np.uint8)
        if i % 2 == 0:
            k = int(len(t) * rng.uniform(0.3, 0.6))
            t[k:] = rng.integers(0, 4, len(t) - k)
        qr[i, :ql] = q[::-1]
        sf[i, :len(t)] = t
        lens[i] = (ql, len(t))
    return qr, sf, lens


def _mode_cdna_jobs(rng, n, QP, TP):
    """n cDNA-like splice jobs: a query of 2-3 exons (300-1000 bases, 1%
    substitutions) against its genomic span, GT..AG introns of 80-600
    bases; in every other job the query goes on past its span for 500
    random bases (after 300-500 spliced ones), so the exact and
    approx-drop modes z-drop there."""
    qr = np.zeros((n, QP), np.uint8)
    sf = np.zeros((n, TP), np.uint8)
    lens = np.zeros((n, 2), np.int32)
    for i in range(n):
        tail = 500 if i % 2 == 0 else 0
        ql = int(rng.integers(300, 501) if tail else rng.integers(600, 1001))
        q = rng.integers(0, 4, ql).astype(np.uint8)
        cuts = np.sort(rng.choice(np.arange(80, ql - 80),
                                  int(rng.integers(1, 3)), replace=False))
        parts, prev = [], 0
        for c in list(cuts) + [ql]:
            parts.append(q[prev:c])
            if c < ql:
                iv = rng.integers(0, 4, int(rng.integers(80, 601)))
                iv[:2], iv[-2:] = (2, 3), (0, 2)
                parts.append(iv.astype(np.uint8))
            prev = c
        t = np.concatenate(parts)[:TP]
        mm = rng.random(ql) < 0.01
        q[mm] = (q[mm] + 1) % 4
        q = np.concatenate([q, rng.integers(0, 4, tail).astype(np.uint8)])
        qr[i, :len(q)] = q[::-1]
        sf[i, :len(t)] = t
        lens[i] = (len(q), len(t))
    return qr, sf, lens


def _zdropped(ez, lens, w):
    """Jobs that z-dropped: EZ_ZDROP set while the band at the diagonal
    after EZ_NR is still alive (a band that dies sets it too)."""
    from minimap2_tpu_torch.ops import extend
    ez, lens = ez.cpu().numpy(), lens.cpu().numpy().astype(np.int64)
    r = ez[:, extend.EZ_NR].astype(np.int64)
    ql, tl = lens[:, 0], lens[:, 1]
    st0 = np.maximum(0, r - ql + 1)
    en0 = np.minimum(tl - 1, r)
    if w is not None:
        st0 = np.maximum(st0, (r - w + 1) >> 1)
        en0 = np.minimum(en0, (r + w) >> 1)
    return int(((ez[:, extend.EZ_ZDROP] == 1) & (r < ql + tl - 1)
                & (st0 <= en0)).sum())


def _mode_plain(kind, args, kw, m, outs=None, ez_main=None, plain_dev=None):
    """One extd2 or exts2 mode launch against its plain version on the
    same inputs: p (where the mode writes it) and ez bit-equal.  The
    kernel runs here unless its outputs are given; ez_main, the ez of the
    launch that main counted and timed, must equal this launch's; the
    plain version runs on plain_dev (the inputs' device by default).
    Returns {max_abs_err, plain_ms}."""
    from minimap2_tpu_torch.ops import extend, exts
    fn, plain_fn = ((extend.extd2_batch2, extend.extd2_batch2_plain)
                    if kind == "extd2"
                    else (exts.exts2_batch, exts.exts2_batch_plain))
    p, ez = fn(*args, **kw, **m) if outs is None else outs
    if ez_main is not None:
        require(torch.equal(ez.cpu(), ez_main), f"{kind} {m}: the check's "
                f"launch differs from the timed one")
    RB = kw["RB"]
    RT = (kw["R"] + RB - 1) // RB * RB
    pk = {k: kw[k] for k in ("W", "q", "e", "q2", "sc_mch", "sc_mis",
                             "sc_N", "zdrop")}
    pk.update(m, RT=RT)
    if kind == "extd2":
        pk.update(RB=RB, e2=kw["e2"], w=kw["w"])
        lens_t = args[2]
    else:
        # exts2's blocks take the jobs longest first; its plain version in
        # job order gives the same rows
        pk.update(QP=kw["QP"])
        lens_t = args[4]
    pargs = args if plain_dev is None else [a.to(plain_dev) for a in args]
    (pp, ezp), plain_ms = timed_once(lambda: plain_fn(*pargs, **pk))
    ezp = extend._ez_dead(ezp, lens_t.to(ezp.device), kw["G"], RB,
                          RT).to(ez.device)
    if pp is not None:
        pp = pp.to(p.device)
    err = max_abs_err([ez], [ezp])
    if m["with_cigar"]:
        err = max(err, max_abs_err_u8([p], [pp]))
    else:
        require(p is None and pp is None, f"{kind} {m} returned p")
    return dict(max_abs_err=err, plain_ms=plain_ms,
                plain_jobs=len(lens_t))


def _slice_plain(kind, args, kw, m, sl):
    """The jobs of the job_slice sl of a timed extd2 or exts2 launch (kw,
    m) against the plain version on their inputs args (host tensors; at
    these few jobs the plain version's loop runs faster on the host than
    as launches on the card): p and ez bit-equal.  Returns {max_abs_err,
    plain_ms, plain_jobs}."""
    from minimap2_tpu_torch.ops import extend, exts
    plain_fn = (extend.extd2_batch2_plain if kind == "extd2"
                else exts.exts2_batch_plain)
    RB = kw["RB"]
    pk = {k: kw[k] for k in ("W", "q", "e", "q2", "sc_mch", "sc_mis",
                             "sc_N", "zdrop")}
    pk.update(m, RT=sl["RT"])
    if kind == "extd2":
        pk.update(RB=RB, e2=kw["e2"], w=kw["w"])
    else:
        pk.update(QP=kw["QP"])
    (pp, ezp), plain_ms = timed_once(lambda: plain_fn(*args, **pk))
    err = max_abs_err([sl["ez"]], [ez_dead_in(ezp, sl, kw["G"], RB)])
    if m["with_cigar"]:
        err = max(err, p_err(sl["p"], pp))
    return dict(max_abs_err=err, plain_ms=plain_ms,
                plain_jobs=len(sl["sub"]))


def phase_mode_kernels(rows, n_ext=64, n_spl=32, n_rows=64):
    """Phase 7's mode part: each extd2 and exts2 mode off the CLI paths
    through its entry point (extend.extd2_batch2, exts.exts2_batch), and
    the anchor sort and the two-shard merge past one sort3 row (the wide
    route); the launch counts of that run; each timed beside its bound,
    its own row of the kernels line, and held against its plain version
    on the same inputs (bit-equal p and ez; the DP modes' plain versions
    in the deferred checks when main runs them).  (A rehearsal on the CPU
    may pass fewer jobs and sort rows.)"""
    from minimap2_tpu_torch.ops import _build, exts, extend, sort
    from minimap2_tpu_torch.parallel import batch, sharded
    for src in ("extd2.cu", "exts2.cu"):
        for ln in ptxas_usage(src):
            log(f"[kernels] {src}: {ln}")
    rng = np.random.default_rng(18)
    # extd2 at map_batch's score-only shape (QP = TP 2048, W 640, RB 128,
    # G 16, band 500), map-ont scoring, zdrop 400
    QP = TP = 2048
    d_in = [torch.from_numpy(x).cuda()
            for x in _mode_ont_jobs(rng, n_ext, QP, TP)]
    dkw = dict(G=16, W=640, RB=128, R=QP + TP, QP=QP, TP=TP, q=4, e=2,
               q2=24, e2=1, w=500, zdrop=400, sc_mch=2, sc_mis=-4, sc_N=-1)
    d_modes = [("extd2_exact_right", dict(approx_max=False, right_mode=True,
                                          approx_drop=False,
                                          with_cigar=True)),
               ("extd2_exact", dict(approx_max=False, right_mode=False,
                                    approx_drop=False, with_cigar=False)),
               ("extd2_approx_right_adrop", dict(
                   approx_max=True, right_mode=True, approx_drop=True,
                   with_cigar=True))]
    # exts2 on 32 cDNA-like jobs at QP 1024 (W 1152, TP 4096), splice
    # scoring, zdrop 200
    SQ, ST = 1024, 4096
    qr, sf, lens = _mode_cdna_jobs(rng, n_spl, SQ, ST)
    dn, ac = exts.splice_site_arrays(sf, lens[:, 1], True, 9, True, False)
    s_in = [torch.from_numpy(x).cuda() for x in (qr, sf, dn, ac, lens)]
    skw = dict(G=8, W=1152, RB=64, R=SQ + ST, QP=SQ, TP=ST, q=2, e=1,
               q2=32, zdrop=200, sc_mch=1, sc_mis=-2, sc_N=-1)
    s_modes = [("exts2_exact", dict(approx_max=False, right_mode=False,
                                    approx_drop=False, with_cigar=True)),
               ("exts2_approx_right_adrop_nocigar", dict(
                   approx_max=True, right_mode=True, approx_drop=True,
                   with_cigar=False))]
    # the anchor sort at 64 x 32768 and a two-shard merge at A 16384
    keys = [torch.from_numpy(rng.integers(0, 1 << 32, (n_rows, 32768),
                                          dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).cuda()
            for _ in range(3)]
    keys[0] = torch.where(torch.from_numpy(rng.random(keys[0].shape) < 0.25)
                          .cuda(), -1, keys[0] & 0x3FF)
    A = 16384

    def part():
        av = torch.from_numpy(rng.random((n_rows, A)) < 0.7).cuda()
        rnd = [torch.from_numpy(rng.integers(0, hi, (n_rows, A))
                                .astype(np.int32)).cuda()
               for hi in (2, 195, 1 << 28, 1 << 15)]
        return batch.anchor_keys(*rnd, torch.full_like(rnd[0], 15), av)
    parts = [part(), part()]
    torch.cuda.synchronize()

    _build.launches.clear()
    outs = {}
    for name, m in d_modes:
        outs[name] = extend.extd2_batch2(*d_in, **dkw, **m)
    for name, m in s_modes:
        outs[name] = exts.exts2_batch(*s_in, **skw, **m)
    outs["sort3_wide"] = batch.sort_keys(keys)
    outs["sort3_shard_merge_wide"] = sharded.merge_anchors(parts, A)
    torch.cuda.synchronize()
    counts = Counter(_build.launches)
    log(f"[kernels] mode run launches: {dict(counts)}")
    for name, _ in d_modes + s_modes:
        require(counts.get(name, 0) == 1, f"{name} did not launch "
                f"({dict(counts)})")
    require(counts.get("sort3_wide", 0) == 1
            and counts.get("sort3_shard_merge_wide", 0) == 1
            and counts.get("sort3", 0) == 0
            and counts.get("sort3_shard_merge", 0) == 0,
            f"the sorts past one row did not take the wide route only "
            f"({dict(counts)})")

    def dp_row(name, kind, args, kw, m):
        p, ez = outs.pop(name)
        lens_t = args[2] if kind == "extd2" else args[4]
        N, W = lens_t.shape[0], kw["W"]
        if DEFER is not None:
            key = DEFER.add("mode", int((lens_t.sum(1) - 1).max()),
                            dp=kind, args=list(args), kw=kw, m=m,
                            ez=ez.cpu())
            res = dict(max_abs_err=None, plain_ms=None, plain_jobs=N,
                       deferred=f"{key}:dp")
        else:
            res = _mode_plain(kind, args, kw, m, (p, ez))
            require(res["max_abs_err"] == 0, f"{name} differs from its "
                    f"plain version ({res['max_abs_err']})")
        del p
        exact = not m["approx_max"]
        nr = ez[:, extend.EZ_NR].cpu().numpy()
        if kind == "extd2":
            w, fn = kw["w"], extend.extd2_batch2
            cells, bms, bby = _extd2_bound(lens_t, w, nr, 40 + 8 * exact,
                                           m["with_cigar"])
        else:
            w, fn = None, exts.exts2_batch
            cells, bms, bby = _exts2_bound(lens_t, nr, 45 + 8 * exact,
                                           m["with_cigar"])
        nz = _zdropped(ez, lens_t, w)
        ms = cuda_ms(lambda: fn(*args, **kw, **m), reps=3)
        mode = (int(exact) | int(m["right_mode"]) << 1
                | int(m["approx_drop"]) << 2)
        row = dict(
            name=name, route="cuda",
            source=f"minimap2_tpu_torch/ops/csrc/{kind}.cu",
            replaces=("minimap2_tpu/ops/extend_pallas2.py:658"
                      if kind == "extd2"
                      else "minimap2_tpu/ops/exts_pallas.py:525"),
            launches=counts[name], **res, ms=ms, bound_ms=bms, bound_by=bby,
            library_ms=None, shape=[N, kw["QP"], kw["TP"], W],
            zdrop=kw["zdrop"], z_dropped=nz, dp_cells=cells,
            dp_cells_per_s=cells / (ms / 1e3),
            blocks_per_sm=_build.blocks_per_sm(kind, W, kw["QP"], kw["TP"],
                                               mode))
        log(f"[kernels] {name} ({N} jobs, QP={kw['QP']}, TP={kw['TP']}, "
            f"W={W}, zdrop {kw['zdrop']}: {nz} jobs z-dropped, {cells} DP "
            f"cells, {row['blocks_per_sm']} blocks per SM): {ms:.3f} ms = "
            f"{row['dp_cells_per_s']:.4g} cell-updates/s, {plain_note(row)}"
            f", bound {bms:.4f} ms ({bby})")
        rows.append(row)
        return nz
    nz_d = sum([dp_row(nm, "extd2", d_in, dkw, m) for nm, m in d_modes])
    nz_s = sum([dp_row(nm, "exts2", s_in, skw, m) for nm, m in s_modes])
    require(nz_d > 0 and nz_s > 0, f"no z-drop in the extd2 ({nz_d}) or "
            f"exts2 ({nz_s}) mode runs")

    # the wide route: three stable torch.sort passes (XLA's lax.sort in
    # the JAX step, not a Pallas kernel), against the plain network
    B, W = keys[0].shape
    err = max_abs_err(outs["sort3_wide"], sort.sort3_rows_plain(*keys))
    require(err == 0, f"the wide sort differs from its plain version "
            f"({err})")
    bms, bby = bound(B * W * 24, B * (W // 2) * sort_stages(W) * 8)
    rows.append(dict(
        name="sort3_wide", route="cuda",
        source="minimap2_tpu_torch/ops/sort.py",
        replaces="minimap2_tpu/parallel/batch.py:1221 (lax.sort)",
        launches=counts["sort3_wide"], max_abs_err=err,
        ms=cuda_ms(lambda: batch.sort_keys(keys), reps=5),
        plain_ms=cuda_ms(lambda: sort.sort3_rows_plain(*keys), reps=3),
        bound_ms=bms, bound_by=bby,
        library_ms=cuda_ms(lambda: library_sort3(*keys), reps=5),
        shape=[B, W]))
    r = rows[-1]
    log(f"[kernels] the wide sort at {B} x {W} (three stable torch.sort "
        f"passes): bit-equal, {r['ms']:.4f} ms, plain {r['plain_ms']:.2f} "
        f"ms, bound {bms:.4f} ms ({bby}), library_sort3 "
        f"{r['library_ms']:.4f} ms")
    cat = [torch.cat([pt[j] for pt in parts], dim=1) for j in range(3)]
    want = batch.anchors_of_keys(
        *(x[:, :A] for x in sort.sort3_rows_plain(*cat)))
    err = max_abs_err(outs["sort3_shard_merge_wide"], want)
    require(err == 0, f"the two-shard merge at A {A} differs from one "
            f"plain sort ({err})")
    W2 = 2 * A
    bms, bby = bound(B * W2 * 12 + B * A * 21,
                     B * (W2 // 2) * sort_stages(W2) * 8)
    rows.append(dict(
        name="sort3_shard_merge_wide", route="cuda",
        source="minimap2_tpu_torch/ops/sort.py",
        replaces="minimap2_tpu/parallel/batch.py:1567 (lax.sort)",
        launches=counts["sort3_shard_merge_wide"], max_abs_err=err,
        ms=cuda_ms(lambda: sharded.merge_anchors(parts, A), reps=5),
        plain_ms=cuda_ms(lambda: batch.anchors_of_keys(
            *(x[:, :A] for x in sort.sort3_rows_plain(*cat))), reps=3),
        bound_ms=bms, bound_by=bby,
        library_ms=cuda_ms(lambda: library_sort3(*cat), reps=5),
        shape=[B, W2], keep=A))
    r = rows[-1]
    log(f"[kernels] the two-shard merge at A {A} ({B} x {W2} lanes, the "
        f"wide route): bit-equal to one plain sort, {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.2f} ms, bound {bms:.4f} ms ({bby})")


def _records(path, n):
    from minimap2_tpu_torch.io.fastx import FastxReader
    rd = FastxReader(path)
    recs = []
    while len(recs) < n:
        rec = rd.read1()
        if rec is None:
            break
        recs.append(rec)
    rd.close()
    return recs


def phase_align_breakdown(aln, splice=False, pe=False):
    """Where one 512-read -a batch spends its time: the mapping step
    (CUDA events), the DP kernel (extd2, or exts2 with both strand rounds
    in a launch) and the traceback per sub-batch (CUDA events), the ops
    download, the host's regs (trim, audits, fix_cigar, mapq) and the SAM
    emit.  With pe, the batch is the first 256 pairs of the sr path, r2
    reverse-complemented, and the emit is mm_pair + the fragments' SAM."""
    import itertools

    from minimap2_tpu_torch.io import format as fmt
    from minimap2_tpu_torch.map.align_engine import gen_ts_mat
    from minimap2_tpu_torch.map.driver import iter_fragments
    from minimap2_tpu_torch.ops.traceback import decode_ops
    from minimap2_tpu_torch.parallel import align_batch, engine
    step, ab, mi, opt = aln["step"], aln["ab"], aln["mi"], aln["opt"]
    if pe:
        frags = list(itertools.islice(iter_fragments(aln["rd"], True), 256))
        recs, flips = engine.flatten_fragments(frags, opt.pe_ori)
    else:
        recs = _records(aln["rd"], 512)
    seqs = [r.seq for r in recs]
    codes, lens = engine.encode_batch(seqs, step.p.L)
    packed, nbits = engine.pack_codes(codes)
    batch = [torch.from_numpy(x).cuda() for x in (packed, nbits, lens)]
    with torch.no_grad():
        step_ms = cuda_ms(lambda: step(*batch), reps=3)
        map_out = step(*batch)
    dp = "exts2_batch" if splice else "extd2_batch2"
    evs = {dp: [], "traceback_batch": []}
    jobs = []           # jobs (rows) of each DP launch
    dp_calls = []       # (args, kwargs) of each DP launch
    dl = [0.0]
    wrapped = {}
    for name in evs:
        fn = getattr(align_batch, name)

        def timed(*a, _fn=fn, _key=name, **k):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = _fn(*a, **k)
            e.record()
            evs[_key].append((s, e))
            if _key == dp:
                jobs.append(a[0].shape[0])
                dp_calls.append((a, k))
            return out
        wrapped[name] = fn
        setattr(align_batch, name, timed)

    if splice:
        fetch = ab.fetch

        def timed_fetch(fut):
            torch.cuda.synchronize()
            t = time.time()
            out = fetch(fut)
            dl[0] += time.time() - t
            return out
        ab.fetch = timed_fetch
    else:
        def timed_collect(fut, n):
            ops, fin = fut
            torch.cuda.synchronize()
            t = time.time()
            fin_h = fin.cpu().numpy()
            mx = align_batch._ops_extent(ops)
            ops_h = ops[:, :max(mx, 1)].cpu().numpy()
            dl[0] += time.time() - t
            return [decode_ops(ops_h[i], int(fin_h[i, 0]), int(fin_h[i, 1]))
                    for i in range(n)]
        ab.collect = timed_collect
    mat = gen_ts_mat(5, opt.a, opt.b, opt.transition, opt.sc_ambi)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.time()
        by_read, fallback, _, fb_ids = engine.batch_build_regs(
            recs, map_out, ab, mi, opt, mat, step.with_sec, splice)
        t1 = time.time()
    finally:
        ab.__dict__.pop("fetch" if splice else "collect")
        for name, fn in wrapped.items():
            setattr(align_batch, name, fn)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    dp_ms = sum(s.elapsed_time(e) for s, e in evs[dp])
    tb_ms = sum(s.elapsed_time(e) for s, e in evs["traceback_batch"])
    out = io.StringIO()
    t2 = time.time()
    if pe:      # the device fragments (the host path's are not timed here)
        idx = 0
        for frag in frags:
            ends = recs[idx:idx + len(frag)]
            regss = [by_read.get(id(r), (None, []))[1] for r in ends]
            if not any(id(r) in fb_ids for r in ends) and \
                    all(not rg or rg[0].id == 0 for rg in regss):
                engine.pair_and_write(out, mi, opt, frag, regss,
                                      flips[idx:idx + len(frag)])
            idx += len(frag)
    else:
        for rec, regs in by_read.values():
            for i in range(len(regs)):
                out.write(fmt.write_sam(mi, rec, 0, i, 1, [len(regs)],
                                        [regs], opt.flag, 0) + "\n")
    t3 = time.time()
    host_s = (t1 - t0) - (dp_ms + tb_ms) / 1e3 - dl[0]
    tag = "sr" if pe else "splice" if splice else "-a"
    dp_bound = ""
    if not splice:      # the batch's extd2 work: a p byte a band cell
        nbytes = cells = 0
        for a, k in dp_calls:
            lh = a[2].cpu().numpy().astype(np.int64)
            c = band_cells(lh, k["w"])
            nbytes += c + int(lh.sum()) + len(lh) * (8 + 64)
            cells += c
        bms, by = bound(nbytes, 40 * cells)
        dp_bound = f" (bound {bms:.3f} ms, {by}: {cells} band cells)"
    log(f"[breakdown] 512-read {tag} batch: mapping step {step_ms:.2f} ms; "
        f"{len(evs[dp])} {dp.split('_')[0]} launches on sub-batches of "
        f"{ab.sub} (jobs a launch {jobs}): {dp.split('_')[0]} "
        f"{dp_ms:.2f} ms{dp_bound}, traceback "
        f"{tb_ms:.2f} ms, ops download {1e3 * dl[0]:.2f} ms; host regs "
        f"(trim, audits, fix_cigar, mapq) {host_s:.3f} s, "
        f"{'mm_pair + ' if pe else ''}SAM emit "
        f"{t3 - t2:.3f} s; {len(fallback)} fallback reads; device memory "
        f"peak of the alignment {peak_gb:.3f} GB above the "
        f"{base / 1e9:.3f} GB held before it")


def phase_align_cross_check(aln, tmp, n, splice=False, tag=None):
    """The first n reads through the -a path on the card and on the CPU
    (plain versions, CPU copies of the index): identical SAM text.  Both
    sides run the path's widths in small sub-batches (16 jobs; the splice
    path 8 jobs at QP 2048, TP 8192)."""
    from minimap2_tpu_torch.map.align_engine import gen_ts_mat
    from minimap2_tpu_torch.parallel.align_batch import (AlignBatcher,
                                                         SpliceAlignBatcher)
    from minimap2_tpu_torch.parallel.batch import DeviceIndex
    from minimap2_tpu_torch.parallel.engine import PafStep, align_queries
    from minimap2_tpu_torch.utils.simgenome import write_fasta
    from minimap2_tpu_torch.utils.intfloat import SEQ_NT4
    step, ab, mi, opt = aln["step"], aln["ab"], aln["mi"], aln["opt"]
    tag = tag or ("splice" if splice else "-a")
    recs = _records(aln["rd"], n)
    path = os.path.join(tmp, f"x{n}_{tag.replace(':', '_')}.fa")
    write_fasta(path, [r.name for r in recs],
                [SEQ_NT4[np.frombuffer(r.seq, np.uint8)] for r in recs])
    di = step.di
    di_cpu = DeviceIndex({nm: t.cpu() for nm, t in di.named_buffers()},
                         di.aux_dict())
    step_cpu = PafStep(di_cpu, step.p, step.K, step.min_sc,
                       with_sec=step.with_sec, with_wp=step.with_wp)
    if splice:
        mat = gen_ts_mat(5, opt.a, opt.b, opt.transition, opt.sc_ambi)
        ab_card, ab_cpu = (SpliceAlignBatcher(
            mi, opt, mat, device=d, QP=2048, TP=8192, G=ab.G, RB=ab.RB,
            sub=8) for d in ("cuda", "cpu"))
    else:       # 16 jobs a sub-batch: the plain extd2 pays per row
        ab_card, ab_cpu = (AlignBatcher(
            mi, opt, device=d, QP=ab.QP, TP=ab.TP, G=ab.G, W=ab.W, RB=ab.RB,
            sub=16) for d in ("cuda", "cpu"))
    outs, secs = [], []
    for st_, ab_ in ((step, ab_card), (step_cpu, ab_cpu)):
        out = io.StringIO()
        t = time.time()
        with torch.no_grad():
            align_queries(st_, ab_, mi, opt, [path], out, 128)
        secs.append(time.time() - t)
        outs.append(out.getvalue())
    n_rec = len(outs[0].splitlines())
    require(n_rec >= n * 3 // 4, f"only {n_rec} {tag} SAM records for {n} "
            "reads")
    require(outs[0] == outs[1], f"card and CPU {tag} SAM differ")
    log(f"[cross] {n}-read {tag} SAM ({n_rec} records) identical on card "
        f"and CPU (card {secs[0]:.2f}s, CPU plain versions {secs[1]:.1f}s)")


def phase_sr_cross_check(srp, tmp, n_pairs=16, tag="sr"):
    """The first n_pairs pairs of phase 4b (or 6b's, tag "splice:sr")
    through ``engine.align_pairs``
    on the card and on the CPU (plain versions, CPU copies of the index):
    identical SAM.  Both sides take them as one batch (2 x n_pairs rows:
    the windowed chain scan, as the JAX dispatch rule says) at the path's
    widths, in 16-job sub-batches."""
    from minimap2_tpu_torch.parallel.align_batch import AlignBatcher
    from minimap2_tpu_torch.parallel.batch import DeviceIndex
    from minimap2_tpu_torch.parallel.engine import PafStep, align_pairs
    from minimap2_tpu_torch.utils.intfloat import SEQ_NT4
    step, ab, mi, opt = srp["step"], srp["ab"], srp["mi"], srp["opt"]
    paths = []
    for e, path in enumerate(srp["rd"], 1):
        recs = _records(path, n_pairs)
        paths.append(os.path.join(tmp, f"x_{tag.replace(':', '_')}{e}.fq"))
        write_fastq(paths[-1], [r.name for r in recs],
                    [SEQ_NT4[np.frombuffer(r.seq, np.uint8)] for r in recs])
    di = step.di
    di_cpu = DeviceIndex({nm: t.cpu() for nm, t in di.named_buffers()},
                         di.aux_dict())
    step_cpu = PafStep(di_cpu, step.p, step.K, step.min_sc,
                       with_sec=step.with_sec)
    ab_card, ab_cpu = (AlignBatcher(
        mi, opt, device=d, QP=ab.QP, TP=ab.TP, G=ab.G, W=ab.W, RB=ab.RB,
        sub=16) for d in ("cuda", "cpu"))
    outs, secs = [], []
    for st_, ab_ in ((step, ab_card), (step_cpu, ab_cpu)):
        out = io.StringIO()
        t = time.time()
        with torch.no_grad():
            align_pairs(st_, ab_, mi, opt, paths, out, n_pairs)
        secs.append(time.time() - t)
        outs.append(out.getvalue())
    n_rec = len(outs[0].splitlines())
    require(n_rec >= 2 * n_pairs, f"only {n_rec} {tag} SAM records for "
            f"{n_pairs} pairs")
    require(outs[0] == outs[1], f"card and CPU {tag} SAM differ")
    log(f"[cross] {n_pairs}-pair {tag} SAM ({n_rec} records) identical on card "
        f"and CPU (card {secs[0]:.2f}s, CPU plain versions {secs[1]:.1f}s)")


def phase_long_cross_check(long_, tmp, n=1):
    """The first n long reads of phase 3d, each after one of its short
    reads, through the PAF driver on the card and on the CPU (plain
    versions, CPU copies of the index): identical PAF."""
    from minimap2_tpu_torch.parallel.batch import DeviceIndex
    from minimap2_tpu_torch.parallel.engine import PafStep, map_queries
    from minimap2_tpu_torch.utils.intfloat import SEQ_NT4
    from minimap2_tpu_torch.utils.simgenome import write_fasta
    step, mi, opt = long_["step"], long_["mi"], long_["opt"]
    recs = _records(long_["rd"], 1024)
    longs = [r for r in recs if len(r.seq) > step.p.L][:n]
    shorts = [r for r in recs if len(r.seq) <= step.p.L][:n]
    pick = [r for pair in zip(shorts, longs) for r in pair]
    path = os.path.join(tmp, "x_long.fa")
    write_fasta(path, [r.name for r in pick],
                [SEQ_NT4[np.frombuffer(r.seq, np.uint8)] for r in pick])
    di = step.di
    di_cpu = DeviceIndex({nm: t.cpu() for nm, t in di.named_buffers()},
                         di.aux_dict())
    step_cpu = PafStep(di_cpu, step.p, step.K, step.min_sc)
    outs, secs = [], []
    for st_ in (step, step_cpu):
        out = io.StringIO()
        t = time.time()
        with torch.no_grad():
            map_queries(st_, mi, [path], out, 8, opt=opt)
        secs.append(time.time() - t)
        outs.append(out.getvalue())
    names = {ln.split("\t", 1)[0] for ln in outs[0].splitlines()}
    n_rec = sum(r.name in names for r in longs)
    require(n_rec >= 3 * len(longs) // 4,
            f"{n_rec} of {len(longs)} long reads have a record")
    require(outs[0] == outs[1], "card and CPU long-read PAF differ")
    log(f"[cross] {n} long + {n} short reads' PAF "
        f"({len(outs[0].splitlines())} records) identical on card and CPU "
        f"(card {secs[0]:.2f}s, CPU plain versions {secs[1]:.1f}s)")


def phase_host_route(main, tmp):
    """Phase 9b: the CLI without --batch (the host mapping path, no device
    work) on a 10 Mb cut of phase 3's first contig with 128 ONT-like
    reads, ``-c -x map-ont`` with -t 8 (a spawn pool) and with -t 1:
    byte-identical outputs, phase 3's accuracy gates, no kernel launched."""
    from minimap2_tpu_torch import cli
    from minimap2_tpu_torch.ops._build import launches
    outs, secs = [], {}
    for t in ("8", "1"):
        path = os.path.join(tmp, f"host_t{t}.paf")
        launches.clear()
        t0 = time.time()
        rc = cli.main(["-c", "-x", "map-ont", "-t", t, "-o", path,
                       main["cut_ref"], main["cut_rd"]])
        secs[t] = time.time() - t0
        require(rc == 0, f"the host route with -t {t} returned {rc}")
        require(not any(launches.values()),
                f"the host route launched kernels: {dict(launches)}")
        with open(path, "rb") as f:
            outs.append(f.read())
    require(outs[0] == outs[1], "the host route's -t 8 and -t 1 PAF differ")
    n = len(main["cut_names"])
    log(f"[host] {n} reads through the CLI without --batch (host, no device "
        f"work; each run builds its {HOST_CUT / 1e6:.0f} Mb index): -t 8 "
        f"{secs['8']:.2f}s ({n / secs['8']:.1f} reads/s), -t 1 "
        f"{secs['1']:.2f}s ({n / secs['1']:.1f} reads/s); PAF "
        f"byte-identical ({len(outs[0].splitlines())} records)")
    paf_accuracy("host", os.path.join(tmp, "host_t1.paf"),
                 main["cut_names"])
    return dict(seconds=secs, reads_per_s={t: n / v for t, v in secs.items()})


def phase_mappy(main, tmp):
    """Phase 9c: ``mappy.Aligner`` (map-ont) on phase 9b's 10 Mb cut with
    MAPPY_READS of its reads: each read's primary hits equal its tp:A:P
    records in 9b's -t 1 PAF (contig, r_st, r_en, strand, q_st, q_en,
    mapq, and cigar_str against cg:Z), in order; no kernel launched."""
    from minimap2_tpu_torch import mappy
    from minimap2_tpu_torch.ops._build import launches
    want = {}
    with open(os.path.join(tmp, "host_t1.paf")) as f:
        for ln in f:
            t = ln.rstrip("\n").split("\t")
            if "tp:A:P" in t:
                cg = next(x[5:] for x in t if x.startswith("cg:Z:"))
                want.setdefault(t[0], []).append(
                    (t[5], int(t[7]), int(t[8]), t[4], int(t[2]), int(t[3]),
                     int(t[11]), cg))
    launches.clear()
    t0 = time.time()
    a = mappy.Aligner(main["cut_ref"], preset="map-ont")
    idx_s = time.time() - t0
    n = n_hits = 0
    t0 = time.time()
    for name, seq, _ in mappy.fastx_read(main["cut_rd"]):
        if n == MAPPY_READS:
            break
        got = [(h.ctg, h.r_st, h.r_en, "+" if h.strand > 0 else "-", h.q_st,
                h.q_en, h.mapq, h.cigar_str)
               for h in a.map(seq, name=name) if h.is_primary]
        require(got == want.get(name, []),
                f"mappy's primary hits of {name} differ from the CLI's: "
                f"{got} vs {want.get(name)}")
        n += 1
        n_hits += len(got)
    map_s = time.time() - t0
    require(not any(launches.values()),
            f"mappy launched kernels: {dict(launches)}")
    require(n == MAPPY_READS and n_hits >= MAPPY_READS * 0.9,
            f"mappy: {n} reads, {n_hits} primary hits")
    log(f"[mappy] {n} reads through mappy.Aligner (map-ont, host, no "
        f"kernel launched): {n_hits} primary hits equal the CLI's -c "
        f"records; index built in {idx_s:.1f}s, mapped in {map_s:.2f}s "
        f"({n / map_s:.1f} reads/s)")
    return dict(reads=n, hits=n_hits, index_s=idx_s, map_s=map_s)


def phase_map_batch_cross_check(mb, n=16):
    """The first n reads of phase 3e through map_batch on the card and on
    the CPU (plain versions, a CPU copy of the index): identical dicts."""
    from minimap2_tpu_torch.parallel.batch import DeviceIndex, map_batch
    di = mb["di"]
    di_cpu = DeviceIndex({nm: t.cpu() for nm, t in di.named_buffers()},
                         di.aux_dict())
    codes, lens = (torch.from_numpy(x[:n]) for x in (mb["codes"], mb["lens"]))
    outs, secs = [], []
    for d_, c_, l_ in ((di, codes.cuda(), lens.cuda()),
                       (di_cpu, codes, lens)):
        t = time.time()
        with torch.no_grad():
            o = map_batch(d_, c_, l_, mb["p"])
        outs.append({k: v.cpu() for k, v in o.items()})
        secs.append(time.time() - t)
    for k in outs[0]:
        require(torch.equal(outs[0][k], outs[1][k]),
                f"card and CPU map_batch differ in {k}")
    log(f"[cross] {n}-read map_batch dicts identical on card and CPU (card "
        f"{secs[0]:.2f}s, CPU plain versions {secs[1]:.1f}s)")


def phase_breakdown(main, tag="PAF"):
    """Where one 512-read batch spends its time: host read/encode/pack,
    the device step (CUDA events, and torch.profiler's device time by
    kernel), the host PAF emit."""
    import io
    from minimap2_tpu_torch.io.fastx import read_fasta
    from minimap2_tpu_torch.parallel import engine
    step, mi = main["step"], main["mi"]
    t0 = time.time()
    names, seqs = read_fasta(main["rd"])
    names, seqs = names[:512], seqs[:512]
    t1 = time.time()
    codes, lens = engine.encode_batch(seqs, step.p.L)
    packed, nbits = engine.pack_codes(codes)
    t2 = time.time()
    batch = [torch.from_numpy(x).cuda() for x in (packed, nbits, lens)]
    with torch.no_grad():
        step_ms = cuda_ms(lambda: step(*batch), reps=5)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            rec = step(*batch)
            torch.cuda.synchronize()
    # device-side events only (each kernel's time is also charged to the
    # aten op that launched it)
    ev = [(e.key, e.self_device_time_total / 1e3) for e in
          prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]
    dev_ms = sum(t for _, t in ev)
    top = sorted(ev, key=lambda x: -x[1])[:10]
    t3 = time.time()
    engine.map_batch_paf(mi, step, names, seqs, step.p, io.StringIO(),
                         pending=rec)
    t4 = time.time()
    log(f"[breakdown] 512-read {tag} batch: host read (1024 reads, "
        f"native.fastx_scan) {t1 - t0:.3f}s, encode+pack {t2 - t1:.3f}s, "
        f"device step "
        f"{step_ms:.2f} ms ({dev_ms:.2f} ms of it in kernels, profiler), "
        f"PAF emit {t4 - t3:.3f}s")
    for k, t in top:
        log(f"[breakdown]   {t:8.3f} ms  {k[:90]}")


def phase_cross_check(main, tag="PAF"):
    from minimap2_tpu_torch.parallel.batch import DeviceIndex
    from minimap2_tpu_torch.parallel.engine import PafStep
    step = main["step"]
    di = step.di
    di_cpu = DeviceIndex({n: t.cpu() for n, t in di.named_buffers()},
                         di.aux_dict())
    step_cpu = PafStep(di_cpu, step.p, step.K, step.min_sc)
    batch = _first_batch(step, main["rd"], 128)
    t0 = time.time()
    with torch.no_grad():
        gpu = step(*(x.cuda() for x in batch)).cpu()
        t1 = time.time()
        cpu = step_cpu(*batch)
    t2 = time.time()
    require(gpu.shape == (10, step.K, 128), f"records shape {gpu.shape}")
    require(torch.equal(gpu, cpu), f"card and CPU {tag} records differ")
    log(f"[cross] 128-read {tag} records identical on card and CPU "
        f"(card {t1 - t0:.2f}s, CPU plain versions {t2 - t1:.1f}s)")


def main():
    t_start = time.time()
    secs = {}

    def timed(name, fn, *a):
        t = time.time()
        out = fn(*a)
        secs[name] = round(time.time() - t, 1)
        log(f"[time] {name}: {secs[name]}s")
        return out
    card = timed("card", phase_card)
    timed("build", phase_build)
    global DEFER
    with tempfile.TemporaryDirectory() as tmp, Deferred(tmp) as DEFER:
        main_ = timed("paf", phase_main_path, tmp)
        reader_check("the PAF phase")
        long_ = timed("long", phase_long_reads, main_, tmp)
        dvb = timed("devbuild", phase_devbuild, main_, tmp)
        lay = timed("layouts", phase_layouts, main_, dvb, tmp)
        mb = timed("map_batch", phase_map_batch, main_, dvb)
        shd = timed("sharded", phase_sharded, main_, mb, tmp)
        g38 = timed("grch38", phase_grch38, tmp)
        aln = timed("align", phase_align_path, main_, tmp)
        aln["rd"] = main_["rd"]
        srp = timed("sr", phase_sr_path, main_, tmp)
        lrq = timed("lr:hqae", phase_lr_hqae, main_, tmp)
        hpc = timed("hpc", phase_hpc_path, main_, tmp)
        spl = timed("splice", phase_splice_path, main_, tmp)
        ssr = timed("splice:sr", phase_splice_sr, main_, spl, tmp)
        wal = timed("align W1152", phase_wide_align, aln, main_, tmp)
        wsp = timed("splice QP4096", phase_wide_splice, spl, main_, tmp)
        wch = timed("paf WND128", phase_wide_chain, main_, tmp)
        rows = timed("kernels", phase_kernels, main_, hpc, spl, dvb, g38)
        rows += timed("align kernels", phase_align_kernels, aln)
        rows += timed("new kernels", phase_new_kernels, hpc, spl)
        timed("offdist kernels", phase_offdist_kernels, g38["offdist"], rows)
        timed("sort1 chunked", phase_sort1_chunked, rows)
        timed("sr kernels", phase_sr_kernels, srp, rows)
        timed("rmq kernels", phase_rmq_kernels, lrq, mb, rows)
        timed("splice:sr kernels", phase_splice_sr_kernels, ssr, rows)
        timed("sharded kernels", phase_sharded_kernels, shd, rows)
        timed("mode kernels", phase_mode_kernels, rows)
        timed("wide kernels", phase_wide_kernels, main_, wal, wsp, wch, rows)
        for r in rows:          # the PAF kernels also run on the other paths
            if r["name"] in ("extd2_score_only", "sort3_shard_merge") \
                    or r["name"] in MODE_ROWS + WIDE_ROWS:
                continue        # map_batch's mode, the sharded step's
                                # merge, the modes and shapes off the CLI
                                # paths' defaults
            r["launches_sharded"] = sum(
                kernel_launches(c, r["name"])
                + (c.get("sort3_shard_merge", 0) if r["name"] == "sort3"
                   else 0) for c in shd["launches"])
            r["launches_align"] = kernel_launches(aln["launches"], r["name"])
            r["launches_hpc"] = kernel_launches(hpc["launches"], r["name"])
            r["launches_splice"] = kernel_launches(spl["launches"],
                                                   r["name"])
            r["launches_sr"] = kernel_launches(srp["launches"], r["name"])
            r["launches_lr_hqae"] = kernel_launches(lrq["launches"],
                                                    r["name"])
            r["launches_lr_hqae_paf"] = kernel_launches(lrq["paf_launches"],
                                                        r["name"])
            r["launches_map_batch"] = kernel_launches(mb["launches"],
                                                      r["name"])
            r["launches_splice_sr"] = kernel_launches(
                ssr["pe"]["launches"], r["name"])
            r["launches_splice_sr_se"] = kernel_launches(
                ssr["se"]["launches"], r["name"])
            r["launches_offdist"] = kernel_launches(
                g38["offdist"]["launches"], r["name"])
            r["launches_h2"] = kernel_launches(
                lay["runs"][0]["launches"], r["name"])
            r["launches_krows"] = kernel_launches(
                dvb["krows"]["runs"][0]["launches"], r["name"])
        timed("breakdown", phase_breakdown, main_)
        timed("hpc breakdown", phase_breakdown, hpc, "HPC")
        timed("align breakdown", phase_align_breakdown, aln)
        timed("splice breakdown", phase_align_breakdown, spl, True)
        timed("sr breakdown", phase_align_breakdown, srp, False, True)
        torch.cuda.empty_cache()     # the child's room on the card
        DEFER.start()                # beside the card-vs-CPU phases
        timed("cross PAF", phase_cross_check, main_)
        timed("cross HPC", phase_cross_check, hpc, "HPC")
        timed("cross -a", phase_align_cross_check, aln, tmp, 4)
        timed("cross splice", phase_align_cross_check, spl, tmp, 2, True)
        timed("cross long", phase_long_cross_check, long_, tmp)
        timed("cross sr", phase_sr_cross_check, srp, tmp)
        timed("cross splice:sr", phase_sr_cross_check, ssr["pe"], tmp, 16,
              "splice:sr")
        timed("cross lr:hqae", phase_align_cross_check, lrq, tmp, 4, False,
              "lr:hqae")
        timed("cross map_batch", phase_map_batch_cross_check, mb)
        timed("deferred checks", DEFER.finish, rows)   # before the host
        host = timed("host", phase_host_route, main_, tmp)     # rates
        mpy = timed("mappy", phase_mappy, main_, tmp)
        reader_check("the whole run")
    for ok, msg in (aln["gates"] + spl["gates"] + srp["gates"]
                    + lrq["gates"] + ssr["gates"] + wal["gates"]
                    + wsp["gates"]):
        require(ok, msg)
    kinds = torch.cuda.get_device_name(0)
    log(f"[main] card {card}: {main_['reads_per_s']:.1f} reads/s (PAF), "
        f"{long_['reads_per_s']:.1f} reads/s (PAF with 128 reads past L, "
        f"{100 * long_['host_share']:.1f}% of it on the host path), "
        f"{aln['reads_per_s']:.1f} reads/s (-a, mean identity "
        f"{aln['mean_identity']:.4f}; host path {aln['host']['reads']} "
        f"reads, {aln['host']['seconds']:.3f}s), {srp['reads_per_s']:.1f} "
        f"reads/s (-ax sr paired, {100 * srp['correct']:.1f}% of ends "
        f"correct, {100 * srp['proper']:.1f}% of pairs proper; host path "
        f"{srp['host']['reads']} reads, {srp['host']['seconds']:.3f}s), "
        f"{lrq['reads_per_s']:.1f} reads/s (-a -x lr:hqae, mean identity "
        f"{lrq['mean_identity']:.4f}, the chain scan "
        f"{lrq['scan']['s_per_batch']:.2f}s a batch; host path "
        f"{lrq['host']['reads']} reads, {lrq['host']['seconds']:.3f}s), "
        f"{lrq['paf_reads_per_s']:.1f} reads/s (-x lr:hqae PAF), "
        f"{mb['reads_per_s']:.1f} reads/s (map_batch, one 512-read call "
        f"after a first, which took {mb['cold_s']:.2f}s; "
        f"the scan {mb['scan_s']:.2f}s), "
        f"{shd['reads_per_s']:.1f} reads/s (the sharded step, 4 gloo ranks "
        f"at (data=2, idx=2), the slowest rank's second call; collectives "
        f"{shd['coll_s']:.3f}s), "
        f"{host['reads_per_s']['8']:.1f} reads/s (no --batch, host, -t 8), "
        f"{mpy['reads'] / mpy['map_s']:.1f} reads/s (mappy, host), "
        f"{hpc['reads_per_s']:.1f} reads/s (map-pb), "
        f"{spl['reads_per_s']:.1f} reads/s (-a -x "
        f"splice, {100 * spl['intron_share']:.1f}% of introns exact; host "
        f"path {spl['host']['reads']} reads, {spl['host']['seconds']:.3f}s), "
        f"{ssr['pe']['reads_per_s']:.1f} reads/s (-ax splice:sr -j paired, "
        f"{100 * ssr['shares']['pe_host']:.1f}% of fragments on the host "
        f"path), {ssr['se']['reads_per_s']:.1f} reads/s (-ax splice:sr "
        f"single-end), {wal['reads_per_s']:.1f} reads/s (-a -r 1000 at W "
        f"1152, mean identity {wal['mean_identity']:.4f}; host path "
        f"{wal['host']['reads']} reads), {wsp['reads_per_s']:.1f} reads/s "
        f"(-a -x splice at QP 4096, {100 * wsp['intron_share']:.1f}% of "
        f"introns exact), {wch['reads_per_s']:.1f} reads/s (PAF at "
        f"chain_window 128, 512 reads) on the 100 Mb genome (its .mmi "
        f"dumped in {main_['mmi_s']['dump']:.2f}s, loaded in "
        f"{main_['mmi_s']['load']:.2f}s); {g38['map']['reads_per_s']:.1f} reads/s "
        f"(PAF) and {OFFDIST_READS / g38['offdist']['map_s']:.1f} reads/s "
        f"(the CLR-like reads at L 32768, one step) on the "
        f"GRCh38 envelope, its index built in {g38['stages']['total']:.1f}s "
        f"(100 Mb: {dvb['stages']['total']:.1f}s); "
        f"host index builds (Mb, k, w, s) {HOST_BUILDS}; "
        f"{time.time() - t_start:.0f}s in all, by phase {secs}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kinds,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--checks"]:
        run_checks(sys.argv[2], sys.argv[3:])
    else:
        main()
