#!/usr/bin/env python3
"""The short-read paired-end path of the port alone, on one NVIDIA GPU:

    python3 scripts/torch_sr_check.py

Builds the kernels, simulates ``chip_smoke.py``'s 100 Mb genome and its
phase 4b reads (2048 Illumina-like FR pairs, seed 8), and runs phase 4b
through ``cli.main(["--batch", "-ax", "sr", ...])`` with its gates
reported, not enforced.  Then it maps 100 of the fragments that have an
unmapped end on the host path (``map_fragment``: the reference's seed
occurrence rule, mid_occ 1000) and scores their primaries; runs phase 4b
again with ``MM2TPU_OCC_CAP=1000`` (the device's seed occurrence cap,
64 by default); and runs ``chip_smoke.py``'s sr kernel checks (phase 7),
the sr batch breakdown (phase 8) and the 16-pair card-vs-CPU check
(phase 9).  Writes the kernels' sr entries to
``chiprun_out/sr_check_rows.json``.  Exits non-zero without a card or on
a kernel mismatch.
"""
import io
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def score_host_path(srp, sr_rd, fragments):
    """map_fragment + write_fragment on the named fragments; returns
    (records, primaries, correct primaries, wrong mapq-60 primaries)."""
    from minimap2_tpu_torch.map.driver import (iter_fragments, map_fragment,
                                               write_fragment)
    mi, opt = srp["mi"], srp["opt"]
    out = io.StringIO()
    for frag in iter_fragments(sr_rd, True):
        if frag[0].name[:-2] in fragments:
            res = map_fragment(mi, opt, frag)
            write_fragment(out, mi, opt, frag, [r.regs for r in res],
                           [r.rep_len for r in res])
    recs = [ln.split("\t") for ln in out.getvalue().splitlines()]
    n = ok = q60_wrong = 0
    for t in recs:
        flag = int(t[1])
        if flag & 0x904:
            continue
        n += 1
        chrom, st, en, strand = cs.sr_truth(t[0], 1 if flag & 64 else 2)
        r_len = cs._cigar_spans(t[5])[1]
        pos = int(t[3]) - 1
        good = (t[2] == chrom and ("-" if flag & 16 else "+") == strand
                and pos < en and pos + r_len > st)
        ok += good
        q60_wrong += int(t[4]) == 60 and not good
    return len(recs), n, ok, q60_wrong


def main():
    t0 = time.time()
    cs.phase_card()
    cs.phase_build()
    from minimap2_tpu_torch.utils.simgenome import (simulate_genome,
                                                    write_fasta)
    tmp = tempfile.mkdtemp()
    names, seqs = simulate_genome(cs.GENOME_LEN, cs.N_CONTIGS, 7)
    ref = os.path.join(tmp, "ref.fa")
    write_fasta(ref, names, seqs)
    qn, r1, r2 = cs.simulate_sr_pairs(names, seqs, cs.SR_PAIRS,
                                      np.random.default_rng(8))
    sr_rd = [os.path.join(tmp, f"sr_r{e}.fq") for e in (1, 2)]
    for path, e, ends in zip(sr_rd, (1, 2), (r1, r2)):
        cs.write_fastq(path, [f"{nm}/{e}" for nm in qn], ends)
    lens = {(nm, e): len(x) for e, ends in ((1, r1), (2, r2))
            for nm, x in zip(qn, ends)}
    main_ = dict(ref=ref, sr_rd=sr_rd, sr_names=qn, sr_lens=lens)
    del seqs
    cs.log(f"[sr-check] genome and reads simulated in "
           f"{time.time() - t0:.1f}s")
    t = time.time()
    srp = cs.phase_sr_path(main_, tmp)
    cs.log(f"[sr-check] phase 4b {time.time() - t:.1f}s; gates "
           f"{[(ok, msg) for ok, msg in srp['gates']]}")
    with open(os.path.join(tmp, "sr.sam")) as f:
        recs = [ln.split("\t") for ln in f if not ln.startswith("@")]
    unmapped = sorted({t[0] for t in recs if int(t[1]) & 4})
    cs.log(f"[sr-check] {sum(int(t[1]) & 4 != 0 for t in recs)} unmapped "
           f"ends in {len(unmapped)} fragments")
    t = time.time()
    n_rec, n_prim, n_ok, n_wrong = score_host_path(srp, sr_rd,
                                                   set(unmapped[:100]))
    cs.log(f"[sr-check] host path on {min(len(unmapped), 100)} fragments "
           f"with an unmapped end: {n_rec} records, {n_prim} primaries, "
           f"{n_ok} correct, {n_wrong} wrong at mapq 60, "
           f"{time.time() - t:.1f}s; mid_occ {srp['opt'].mid_occ}")
    os.environ["MM2TPU_OCC_CAP"] = "1000"
    t = time.time()
    try:
        srp2 = cs.phase_sr_path(main_, tmp)
        cs.log(f"[sr-check] occ cap 1000: {time.time() - t:.1f}s; gates "
               f"{[(ok, msg) for ok, msg in srp2['gates']]}")
        del srp2
    finally:
        del os.environ["MM2TPU_OCC_CAP"]
    rows = [dict(name=n, paths={}, max_abs_err=0)
            for n in ("sketch", "sort3", "chain", "extd2", "traceback")]
    cs.phase_sr_kernels(srp, rows)
    cs.phase_align_breakdown(srp, False, True)
    cs.phase_sr_cross_check(srp, tmp)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/sr_check_rows.json", "w") as f:
        json.dump(rows, f, indent=1, default=str)
    cs.log(f"[sr-check] {time.time() - t0:.1f}s in all")


if __name__ == "__main__":
    main()
