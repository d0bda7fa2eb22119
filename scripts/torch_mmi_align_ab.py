#!/usr/bin/env python3
"""The -a path from a FASTA target and from its .mmi, in one process on
one NVIDIA GPU:

    python3 scripts/torch_mmi_align_ab.py

Builds the kernels, simulates ``chip_smoke.py``'s 100 Mb genome (seed 7)
and its phase 4 reads (1024 ONT-like reads, seed 1), and runs phase 4's
command, ``cli.main(["--batch", "-a", "-x", "map-ont", ...])``, four
times in the order FASTA (which also writes the .mmi with -d), .mmi,
.mmi, FASTA.  For each run it prints the aligned reads/s, the fallback
reads and the seconds the host path took for them, and the seconds of the
rest of the align loop; it checks that the four SAM files are identical
but for the @PG line and that the loaded index holds the built one's
arrays with the same dtypes and memory layout.  Writes the runs to
``chiprun_out/mmi_align_ab.json``.  Exits non-zero without a card, on a
kernel that did not launch, or when the outputs or indexes differ.
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def layout(mi):
    """(dtype, C-contiguous, writeable) of each of the index's arrays."""
    return {x: (str(getattr(mi, x).dtype),
                bool(getattr(mi, x).flags.c_contiguous),
                bool(getattr(mi, x).flags.writeable))
            for x in ("keys", "starts", "pos", "S")}


def body(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


def main():
    t0 = time.time()
    cs.require(torch.cuda.is_available(), "no CUDA device")
    cs.phase_build()
    from minimap2_tpu_torch.utils.simgenome import (simulate_genome,
                                                    simulate_reads,
                                                    write_fasta)
    names, seqs = simulate_genome(cs.GENOME_LEN, cs.N_CONTIGS, 7)
    rnames, reads = simulate_reads(seqs, cs.N_READS,
                                   np.random.default_rng(1), name_seqs=names)
    kernels = ("sketch", "sort3", "sort3_merge", "chain", "extd2",
               "traceback")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        ref, rd, mmi = (os.path.join(tmp, f) for f in
                        ("ref.fa", "reads.fa", "main.mmi"))
        write_fasta(ref, names, seqs)
        write_fasta(rd, rnames, reads)
        del seqs, reads
        indexes = {}
        for i, target in enumerate(("fasta", "mmi", "mmi", "fasta")):
            sam = os.path.join(tmp, f"run{i}.sam")
            argv = ["--batch", "-a", "-x", "map-ont", "-o", sam]
            if i == 0:
                argv += ["-d", mmi]
            argv += [ref if target == "fasta" else mmi, rd]
            run = cs._align_run(f"ab {i} {target}", argv, kernels)
            host_s = run["host"]["seconds"]
            runs.append(dict(
                target=target, reads_per_s=run["reads_per_s"],
                align_s=run["align_s"], fallbacks=len(run["fallbacks"]),
                host_path_s=host_s, rest_s=run["align_s"] - host_s))
            indexes.setdefault(target, run["mi"])
            cs.log(f"[ab] run {i} ({target}): {run['reads_per_s']:.1f} "
                   f"aligned reads/s, {len(run['fallbacks'])} fallback reads "
                   f"in {host_s:.3f}s on the host path, the rest of the "
                   f"align loop {runs[-1]['rest_s']:.3f}s")
            if i:
                cs.require(body(sam) == body(os.path.join(tmp, "run0.sam")),
                           f"run {i} ({target}) wrote other records than "
                           "run 0 (fasta)")
            del run
        cs.same_index("ab", indexes["mmi"], indexes["fasta"])
        lay = {t: layout(m) for t, m in indexes.items()}
        cs.log(f"[ab] index arrays (dtype, C-contiguous, writeable): {lay}")
        cs.require(lay["mmi"] == lay["fasta"], "the loaded index's arrays "
                   "differ in dtype or layout from the built one's")
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    cs.log(f"[ab] card {smi.strip()}; the four SAM files identical but for "
           f"@PG; {time.time() - t0:.1f}s in all")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "mmi_align_ab.json"),
              "w") as f:
        json.dump(dict(card=smi.strip(), runs=runs, layout=lay), f,
                  indent=1)


if __name__ == "__main__":
    main()
