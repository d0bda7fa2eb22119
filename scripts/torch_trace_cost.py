#!/usr/bin/env python3
"""What the port's stage spans cost on the host, with no profiler and
under one:

    python3 scripts/torch_trace_cost.py

Times each primitive of the span recorder (minimap2_tpu_torch/utils/
trace.py) a call, off and on (on: under torch.profiler with the CPU
activity, and CUDA's where a card is): a span (``with trace.span``), a
timer (``trace.clock`` then ``trace.charge``) and ``with trace.batch``.
Then counts the spans and timers of each batch of a paired-end run
(engine.align_pairs on tests/data/sr-r{1,2}.fq against MT-human.fa, on
the CPU, 20 pairs a batch) and prints their cost for a batch of 512
reads, off and on: the spans and the download timers (``wait_ns``) as
counted a batch, the trim and SAM timers scaled by the reads.  Writes
chiprun_out/trace_cost.json.
"""
import io
import json
import os
import sys
import time
from collections import Counter, deque

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import torch  # noqa: E402

from minimap2_tpu_torch import config  # noqa: E402
from minimap2_tpu_torch.index.index import MiniIndex  # noqa: E402
from minimap2_tpu_torch.io import fastx  # noqa: E402
from minimap2_tpu_torch.parallel import engine  # noqa: E402
from minimap2_tpu_torch.utils import trace  # noqa: E402

BATCH_READS = 512


def activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def per_call_ns(fn, n):
    """Median over five rounds of the ns a call of fn(n) loops n times."""
    out = []
    for _ in range(5):
        t = time.perf_counter_ns()
        fn(n)
        out.append((time.perf_counter_ns() - t) / n)
    return sorted(out)[2]


def spans(n):
    for _ in range(n):
        with trace.span("regs:jobs"):
            pass


def timers(n):
    for _ in range(n):
        t = trace.clock()
        trace.charge("trim_ns", t)


def batches(n):
    for _ in range(n):
        with trace.batch(7):
            pass


def primitives():
    """{primitive: (ns off, ns on)}; the timer's on-cost inside an open
    span, where the port charges it."""
    trace.LOG = deque(maxlen=1 << 18)
    off = {"span": per_call_ns(spans, 200_000),
           "timer": per_call_ns(timers, 200_000),
           "batch": per_call_ns(batches, 200_000)}
    with torch.profiler.profile(activities=activities()):
        with trace.span("regs:finish"):
            on = {"timer": per_call_ns(timers, 200_000),
                  "batch": per_call_ns(batches, 200_000)}
        on["span"] = per_call_ns(spans, 20_000)
    return {k: (off[k], on[k]) for k in off}


def counts():
    """(reads, spans a batch, {timer: count a batch of BATCH_READS}) of
    a traced paired-end run on the CPU."""
    names, seqs = fastx.read_fasta(os.path.join(ROOT, "tests/data/"
                                                "MT-human.fa"))
    io_opt, mo = config.IndexOptions(), config.MapOptions()
    config.set_opt("sr", io_opt, mo)
    mo.flag |= config.MM_F_CIGAR | config.MM_F_OUT_SAM
    mi = MiniIndex.build(names, seqs, w=io_opt.w, k=io_opt.k)
    config.mapopt_update(mo, mi)
    queries = [os.path.join(ROOT, f"tests/data/sr-r{e}.fq") for e in (1, 2)]
    n_timers = Counter()
    charge = trace.charge

    def counted(key, t0):
        n_timers[key] += 1
        charge(key, t0)
    trace.LOG = deque(maxlen=1 << 18)
    trace.charge = counted
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            n, _ = engine.run_batched_pe_cli(
                mi, mo, queries, io.StringIO(), batch_frags=20, L=256,
                align_kw={"QP": 192, "TP": 192, "W": 256, "sub": 128},
                device="cpu")
    finally:
        trace.charge = charge
    logged = trace.spans()
    full = {s.batch for s in logged if s.name == "regs:fetch"}
    n_spans = sum(s.batch in full for s in logged)
    scale = BATCH_READS / (n / len(full))
    return n, n_spans / len(full), {
        k: v / len(full) * (1 if k == "wait_ns" else scale)
        for k, v in n_timers.items()}


def main():
    prim = primitives()
    n, sb, timers_b = counts()
    tb = sum(timers_b.values())
    cost = {w: (sb * prim["span"][i] + tb * prim["timer"][i]) / 1e6
            for i, w in enumerate(("off_ms", "on_ms"))}
    out = {"device": (torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else "cpu"),
           "ns_a_call": {k: {"off": v[0], "on": v[1]}
                         for k, v in prim.items()},
           "reads_counted": n,
           "a_batch_of_512_reads": {
               "spans": sb, "timers": tb,
               "timers_by_key": timers_b,
               **cost}}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "trace_cost.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
