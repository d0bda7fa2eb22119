#!/usr/bin/env python3
"""Short check of the port's extd2 kernel on one NVIDIA GPU:

    python3 scripts/torch_extd2_check.py

Builds the kernels (printing nvcc's register and spill lines for
extd2.cu), makes 576 random ONT-like jobs at the -a path's widths
(QP=12288, TP=12800, W=640, RB=64, G=32, band w=500, map-ont scoring; a
query of 1,000-11,000 bases, the target the query with 5% substitutions
and 2.5% insertions and deletions each; seed 1), and checks the kernel
bit-equal to ``extd2_batch2_plain`` on the first 32 jobs.  It prints the
blocks per SM and the kernel's time (CUDA events, median) on 64 jobs, on a
256-job launch and on the 576 jobs as sub-batches of 256 (256 + 256 + 64),
of 512 (512 + 64) and in one launch; the time a memset of a 256-job and
of a 576-job p would add; and the time and the device memory peak of one
launch of 1024 jobs (the 576 and the first 448 again), AlignBatcher's
largest sub-batch.  Exits non-zero without a card or on a mismatch.
"""
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from minimap2_tpu_torch.ops import _build, extend  # noqa: E402

QP, TP, W, RB, G, w = 12288, 12800, 640, 64, 32, 500
SC = dict(q=4, e=2, q2=24, e2=1, sc_mch=2, sc_mis=-4, sc_N=0)


def ont_jobs(rng, n):
    qr = np.zeros((n, QP), np.uint8)
    sf = np.zeros((n, TP), np.uint8)
    lens = np.zeros((n, 2), np.int32)
    for i in range(n):
        ql = int(rng.integers(1000, 11001))
        q = rng.integers(0, 4, ql).astype(np.uint8)
        t = np.where(rng.random(ql) < 0.05, (q + rng.integers(1, 4, ql)) % 4,
                     q)[rng.random(ql) >= 0.025]          # 2.5% deletions
        ins = rng.random(len(t)) < 0.025                  # 2.5% insertions
        out = rng.integers(0, 4, len(t) + int(ins.sum()))
        out[np.arange(len(t)) + np.cumsum(ins) - ins] = t
        t = out
        t = t[:TP].astype(np.uint8)
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
        raise SystemExit("torch_extd2_check: no CUDA device")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    t0 = time.time()
    _build.lib()
    print(f"build {time.time() - t0:.1f}s")
    on = False
    for ln in _build.build_log.splitlines():
        if ln.startswith("=="):
            on = "extd2" in ln
        if on and ("registers" in ln or "spill" in ln or "Compiling" in ln):
            print("  ", ln.strip())
    qr, sf, lens = ont_jobs(np.random.default_rng(1), 576)
    jobs = [torch.from_numpy(x).cuda() for x in (qr, sf, lens)]
    R = (QP + TP + RB - 1) // RB * RB
    kw = dict(G=G, W=W, RB=RB, R=R, QP=QP, TP=TP, w=w, zdrop=-1,
              right_mode=False, approx_max=True, approx_drop=False, **SC)
    first = [x[:32] for x in jobs]
    RT = (R + RB - 1) // RB * RB
    t = time.time()
    pp, ezp = extend.extd2_batch2_plain(*first, W=W, RB=RB, RT=RT, w=w, **SC)
    ezp = extend._ez_dead(ezp, first[2], G, RB, RT)
    torch.cuda.synchronize()
    print(f"plain version on 32 jobs: {time.time() - t:.1f}s")
    p, ez = extend.extd2_batch2(*first, **kw)
    ok = torch.equal(p, pp) and torch.equal(ez, ezp)
    del p

    def launch(lo, hi):
        return extend.extd2_batch2(*(x[lo:hi] for x in jobs), **kw)

    def batch(sub):
        for lo in range(0, 576, sub):
            launch(lo, min(lo + sub, 576))
    print(f"bit-equal on 32 jobs {ok}; "
          f"{_build.blocks_per_sm("extd2", W, QP, TP, 0)} blocks per SM; "
          f"64 jobs {median_ms(lambda: launch(0, 64), 3):.3f} ms; "
          f"256 jobs {median_ms(lambda: launch(0, 256), 3):.3f} ms; "
          f"576 jobs as 256+256+64 {median_ms(lambda: batch(256), 2):.3f}"
          f" ms, as 512+64 {median_ms(lambda: batch(512), 2):.3f} ms, "
          f"as one launch {median_ms(lambda: batch(576), 2):.3f} ms",
          flush=True)
    for n in (256, 576):
        print(f"a memset of a {n}-job p: %.3f ms" % median_ms(
            lambda: torch.zeros((n, RT, W), dtype=torch.uint8,
                                device="cuda"), 3))
    del pp
    jobs = [torch.cat([x, x[:448]]) for x in jobs]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(lambda: launch(0, 1024), 2)
    peak = torch.cuda.max_memory_allocated()
    print(f"one launch of 1024 jobs: {ms:.3f} ms; device memory peak "
          f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB above the "
          f"inputs), p {1024 * RT * W / 1e9:.3f} GB; card "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
    tot = lens[:, 0].astype(np.int64) + lens[:, 1]
    print(f"qlen + tlen of the first 256 jobs: mean {tot[:256].mean():.1f} "
          f"max {tot[:256].max()}")
    if not ok:
        raise SystemExit("torch_extd2_check: kernel and plain version differ")


if __name__ == "__main__":
    main()
