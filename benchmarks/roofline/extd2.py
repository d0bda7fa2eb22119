"""The work of one extd2 launch (banded global DP with direction bytes,
ksw_extd2's recurrence), counted from its jobs' lengths: the band cells,
40 integer operations a cell, one direction byte written a cell, each
job's query and target bytes read once, its lengths (8 bytes) and its
16 int32 result lanes."""
from __future__ import annotations

import numpy as np

OPS_PER_CELL = 40
EZ_LANES = 16


def band_cells(lens, w: int) -> int:
    """Cells the DP updates: per job of (query, target) lengths, the band
    width en - st + 1 of every anti-diagonal r, with st = max(0, r - ql + 1,
    (r - w + 1) >> 1) and en = min(tl - 1, r, (r + w) >> 1), until the
    band ends."""
    tot = 0
    for ql, tl in lens:
        r = np.arange(ql + tl - 1, dtype=np.int64)
        st = np.maximum(np.maximum(0, r - ql + 1), (r - w + 1) >> 1)
        en = np.minimum(np.minimum(tl - 1, r), (r + w) >> 1)
        width = en - st + 1
        dead = np.flatnonzero(width <= 0)
        tot += int(width[:dead[0] if len(dead) else len(width)].sum())
    return tot


def work(lens, w: int):
    """(bytes, operations) of a launch over jobs of these lengths."""
    cells = band_cells(lens, w)
    live = sum(q + t for q, t in lens)
    n = len(lens)
    return cells + live + 8 * n + 4 * EZ_LANES * n, OPS_PER_CELL * cells
