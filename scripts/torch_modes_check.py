#!/usr/bin/env python3
"""Short check of the DP kernels' modes and the wide sort on one NVIDIA
GPU:

    python3 scripts/torch_modes_check.py

Builds the kernels, prints every extd2 and exts2 instantiation's
registers, spills and shared memory (``nvcc -Xptxas -v``), then runs
chip_smoke.py's mode part of phase 7 (``phase_mode_kernels``): extd2 in
exact-max right-aligned with p, exact-max score-only and approx-drop
right-aligned with p on 64 ONT-like jobs at QP = TP 2048 (zdrop 400);
exts2 in exact-max with p and approx-drop right-aligned without p on 32
cDNA-like jobs at QP 1024 (zdrop 200); the anchor sort at 64 x 32768 and
a two-shard merge at A 16384 through the wide route.  Each is checked
bit-equal to its plain version and timed (CUDA events) beside its bound;
the rows are written to chiprun_out/modes_check.json.  Exits non-zero
without a card or on a mismatch.
"""
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import phase_build, phase_card, phase_mode_kernels  # noqa: E402


def main():
    card = phase_card()
    phase_build()
    rows = []
    phase_mode_kernels(rows)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "modes_check.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
