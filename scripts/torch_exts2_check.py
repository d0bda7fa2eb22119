#!/usr/bin/env python3
"""Short check of the port's exts2 kernel on one NVIDIA GPU:

    python3 scripts/torch_exts2_check.py

Builds the kernels (printing nvcc's register and spill lines), makes 512
random cDNA-like jobs at the CLI's splice widths (QP=2048, TP=8192,
W=2176, RB=64; a query of 300-2048 bases, the target the query with 0-5
planted GT..AG introns of 60-1200 bases, 3% substitutions; seed 1), and
checks the kernel bit-equal to ``exts2_batch_plain`` on the first 32 jobs
and on the last 16 jobs of the 512-job launch.  Prints the kernel's time
(CUDA events, median) on 32 and on 512 jobs, the time of zeroing the
512-job p, and the kernel's blocks per SM.  Exits non-zero without a card
or on a mismatch.
"""
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from minimap2_tpu_torch.ops import _build, exts  # noqa: E402

QP, TP, RB, G = 2048, 8192, 64, 8
SC = dict(q=2, e=1, q2=32, sc_mch=1, sc_mis=-2, sc_N=-1)


def cdna_jobs(rng, n):
    qr = np.zeros((n, QP), np.uint8)
    sf = np.zeros((n, TP), np.uint8)
    lens = np.zeros((n, 2), np.int32)
    for i in range(n):
        ql = int(rng.integers(300, QP + 1))
        q = rng.integers(0, 4, ql).astype(np.uint8)
        t = q.copy()
        for _ in range(int(rng.integers(0, 6))):
            k = int(rng.integers(1, len(t) - 1))
            L = int(np.exp(rng.uniform(np.log(60), np.log(1200))))
            iv = rng.integers(0, 4, L).astype(np.uint8)
            iv[:2], iv[-2:] = (2, 3), (0, 2)
            if len(t) + L <= TP:
                t = np.concatenate([t[:k], iv, t[k:]])
        m = rng.random(ql) < 0.03
        q[m] = (q[m] + 1) % 4
        qr[i, :ql] = q[::-1]
        sf[i, :len(t)] = t
        lens[i] = (ql, len(t))
    return qr, sf, lens


def median_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return sorted(ts)[len(ts) // 2]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_exts2_check: no CUDA device")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    t0 = time.time()
    _build.lib()
    print(f"build {time.time() - t0:.1f}s")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln or ln.startswith("=="):
            print("  ", ln.strip())
    W = (QP + 32 + 127) // 128 * 128
    R = (QP + TP + RB - 1) // RB * RB
    print("blocks per SM", _build.blocks_per_sm("exts2", W, QP, TP, 0))
    qr, sf, lens = cdna_jobs(np.random.default_rng(1), 512)
    dn, ac = exts.splice_site_arrays(sf, lens[:, 1], True, 9, True, False)
    jobs = [torch.from_numpy(x).cuda() for x in (qr, sf, dn, ac, lens)]
    kw = dict(G=G, W=W, RB=RB, R=R, QP=QP, TP=TP, zdrop=-1,
              right_mode=False, approx_max=True, approx_drop=False, **SC)

    def plain(args, RT):
        p, ez = exts.exts2_batch_plain(*args, W=W, RT=RT, QP=QP, **SC)
        return p, exts._ez_dead(ez, args[4], G, RB, RT)
    first = [x[:32] for x in jobs]
    p, ez = exts.exts2_batch(*first, **kw)
    RT = p.shape[1]
    t = time.time()
    pp, ezp = plain(first, RT)
    torch.cuda.synchronize()
    ok = torch.equal(p, pp) and torch.equal(ez, ezp)
    print(f"32 jobs bit-equal to the plain version: {ok} (plain "
          f"{time.time() - t:.1f}s)")
    del p, pp
    print(f"kernel, 32 jobs: "
          f"{median_ms(lambda: exts.exts2_batch(*first, **kw), 5):.3f} ms")
    print(f"kernel, 512 jobs: "
          f"{median_ms(lambda: exts.exts2_batch(*jobs, **kw), 3):.3f} ms")
    print("zeroing p of 512 jobs: %.3f ms" % median_ms(
        lambda: torch.zeros((512, RT, W), dtype=torch.uint8, device="cuda"),
        3))
    p, ez = exts.exts2_batch(*jobs, **kw)
    last = [x[-16:] for x in jobs]
    pp, ezp = plain(last, RT)
    # two whole EZ_DEAD groups of G = 8 jobs in both launches
    ok_last = torch.equal(p[-16:], pp) and torch.equal(ez[-16:], ezp)
    print(f"last 16 jobs of the 512-job launch bit-equal: {ok_last}")
    tot = lens[:, 0].astype(np.int64) + lens[:, 1]
    print(f"DP cells {int((lens[:, 0].astype(np.int64) * lens[:, 1]).sum())}"
          f", qlen + tlen mean {tot.mean():.1f} max {tot.max()}")
    if not (ok and ok_last):
        raise SystemExit("torch_exts2_check: kernel and plain version differ")


if __name__ == "__main__":
    main()
