#!/usr/bin/env python3
"""Value ranges of extd2's difference rows, on the CPU:

    python3 scripts/torch_extd2_ranges.py

Runs the plain version (``ops/extend.extd2_batch2_plain``) with a hook
after each anti-diagonal's update that records, for every row (u, v, x, y,
x2, y2) and the pre-max sums (a, b, a2, b2), the least and greatest value
over the updated lanes [st, en], split into cells of the DP matrix
([st0, en0]) and the band's 16-aligned edges outside it.  Three ONT-like
pairs at the -a path's band (W=640, RB=64, w=500, map-ont scoring, seed
5): target longer, query longer by 440, and a third.  It shows why the
kernel keeps int32 lanes: the rows stay within [-128, 127] in the matrix
but not on the edges, where int8 lanes would wrap and change those lanes'
direction bytes.
"""
import inspect
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from minimap2_tpu_torch.ops import extend  # noqa: E402

HOOK = """
        for nm_, a_ in (('u', u), ('v', v), ('x', x), ('y', y), ('x2', x2),
                        ('y2', y2), ('a', a + (z - q)), ('b', b + (z - q)),
                        ('a2', a2 + (z - q2)), ('b2', b2 + (z - q2))):
            cell = m_upd & (t_abs >= st0[:, None]) & (t_abs <= en0[:, None])
            for part, msk in (('matrix', cell), ('edges', m_upd & ~cell)):
                if bool(msk.any()):
                    lo_, hi_ = RANGES.get((part, nm_), (0, 0))
                    RANGES[(part, nm_)] = (min(lo_, int(a_[msk].min())),
                                           max(hi_, int(a_[msk].max())))
"""


def pairs(rng, lens):
    N = len(lens)
    QP = TP = max(max(x) for x in lens) + 64
    qr = np.zeros((N, QP), np.uint8)
    sf = np.zeros((N, TP), np.uint8)
    for n, (ql, tl) in enumerate(lens):
        q = rng.integers(0, 4, ql).astype(np.uint8)
        t = np.resize(q, tl)
        t = np.where(rng.random(tl) < 0.08, rng.integers(0, 4, tl), t)
        qr[n, :ql] = q[::-1]
        sf[n, :tl] = t
    return [torch.from_numpy(x) for x in (qr, sf, np.array(lens, np.int32))]


def main():
    src = inspect.getsource(extend.extd2_batch2_plain)
    anchor = "        fin = live & (r == rstar - 1)"
    assert src.count(anchor) == 1
    ns = dict(vars(extend), RANGES={})
    exec(src.replace(anchor, HOOK.rstrip("\n") + "\n" + anchor), ns)
    qr, sf, lens = pairs(np.random.default_rng(5),
                         [(2000, 2037), (2000, 1560), (1500, 1800)])
    W, RB, w = 640, 64, 500
    RT = -(-(qr.shape[1] + sf.shape[1]) // RB) * RB
    ns["extd2_batch2_plain"](qr, sf, lens, W=W, RB=RB, RT=RT, q=4, e=2,
                             q2=24, e2=1, w=w, sc_mch=2, sc_mis=-4, sc_N=0)
    for part in ("matrix", "edges"):
        print(part, ", ".join(f"{k[1]} [{v[0]}, {v[1]}]"
                              for k, v in sorted(ns["RANGES"].items())
                              if k[0] == part))


if __name__ == "__main__":
    main()
