#!/usr/bin/env python3
"""Short check of the kernels' wide shapes on one NVIDIA GPU:

    python3 scripts/torch_wide_check.py

Builds the kernels, prints every extd2, exts2 and chain instantiation's
registers, spills and shared memory (``nvcc -Xptxas -v``), then runs
chip_smoke.py's wide DP rows (``phase_wide_dp``: extd2 at W 2048, 4096
and 8192 on ONT-like jobs, W 8192 also in the exact mode, W 640 on planes
of QP = TP = 114688; exts2 at W 8320 in the approx and exact modes, at W
16512, and at TP 131072 on jobs with introns of 80-120 kb; the jobs of
each launch that reach the row's wide lanes with the fewest diagonals
are held bit-equal to the plain version, sliced from that launch) and
the chain at WND 32, 128, 1000 and 5000 (``wide_chain_rows``, bit-equal
on the first 32 reads) on 512 x 4096 anchor planes made here from a seed
(chains of 20-300 anchors on both strands of three contigs, and noise).
The plain checks run in chip_smoke.py's four deferred children.  Each
launch's route is printed and each kernel timed with CUDA events beside
its bound.  The rows go to chiprun_out/wide_check.json.  Exits non-zero
without a card or on a mismatch.
"""
import json
import os
import sys
import tempfile

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from chip_smoke import (Deferred, phase_build, phase_card,  # noqa: E402
                        phase_wide_dp, wide_chain_rows)


def anchor_planes(seed, B=512, A=4096):
    """(rev, rid, rpos, qpos, span, av) of B reads: each read's anchors
    sorted by (rev, rid, rpos), chains of colinear anchors with small
    gaps, and random anchors between; 60-100% of A valid."""
    rng = np.random.default_rng(seed)
    planes = [np.zeros((B, A), np.int32) for _ in range(5)]
    av = np.zeros((B, A), bool)
    for b in range(B):
        n = int(A * rng.uniform(0.6, 1.0))
        rows = []
        while len(rows) < n * 3 // 4:
            rv, ri = int(rng.integers(0, 2)), int(rng.integers(0, 3))
            r0, q = int(rng.integers(0, 1 << 28)), 0
            for _ in range(int(rng.integers(20, 300))):
                q += int(rng.integers(1, 40))
                rows.append((rv, ri, r0 + q + int(rng.integers(-30, 31)), q,
                             15))
        while len(rows) < n:
            rows.append((int(rng.integers(0, 2)), int(rng.integers(0, 3)),
                         int(rng.integers(0, 1 << 28)),
                         int(rng.integers(0, 20000)), 15))
        rows = np.array(sorted(rows[:n]), np.int64)
        for j in range(5):
            planes[j][b, :n] = rows[:, j]
        av[b, :n] = True
    return [torch.from_numpy(x).cuda() for x in planes + [av]]


def main():
    from minimap2_tpu_torch.parallel.batch import BatchParams
    card = phase_card()
    phase_build()
    rows = []
    with tempfile.TemporaryDirectory() as tmp, Deferred(tmp) as defer:
        chip_smoke.DEFER = defer
        phase_wide_dp(rows)
        wide_chain_rows(anchor_planes(3), BatchParams(), rows)
        torch.cuda.empty_cache()
        defer.start()
        defer.finish(rows)
    os.makedirs("chiprun_out", exist_ok=True)
    out = {"card": card, "rows": rows}
    with open(os.path.join("chiprun_out", "wide_check.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
