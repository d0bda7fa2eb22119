"""The traced run's spans and their reduction.

Spans come from the benchmark's own wrappers around calls into the
program (module attributes replaced from outside, restored after), each a
host interval and a profiler range of the same name; the profiler records
every client thread and the device.  ``reduce`` turns the profile into the
record the per-layer metric readers read.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict

import numpy as np
import torch

from .roofline import bound_ms
from .roofline import extd2 as extd2_roofline

# the span each wrapped call opens, and what the host is doing meanwhile
SPANS = {
    ("engine", "dispatch_batch"): "encode",
    ("engine", "PafStep.forward"): "paf_step",
    ("engine", "batch_build_regs"): "regs",
    ("engine", "_host_record"): "host_path",
    ("engine", "map_fragment"): "host_path",
    ("engine", "pair_and_write"): "pairing",
    ("align_batch", "AlignBatcher.collect"): "align_fetch",
}


class Tracer:
    def __init__(self):
        from minimap2_tpu_torch.parallel import align_batch, engine
        self.mods = {"engine": engine, "align_batch": align_batch}
        self.spans = defaultdict(list)      # name -> [(t0, t1)]
        self.launches = {}                  # "align:k" -> bound ms
        self.lock = threading.Lock()
        self.saved = []
        self.prof = None

    def _wrap(self, fn, name):
        spans = self.spans

        def wrapped(*a, **kw):
            t = time.perf_counter()
            with torch.profiler.record_function(name):
                try:
                    return fn(*a, **kw)
                finally:
                    spans[name].append((t, time.perf_counter()))
        return wrapped

    def _dispatch(self, fn):
        """AlignBatcher.dispatch: one range per launch, named by its
        number, and the launch's least extd2 time from its jobs."""
        tr = self

        def wrapped(ab, chunk):
            with tr.lock:
                name = f"align:{len(tr.launches)}"
                tr.launches[name] = None
            lens = [(len(q), re_ - rs) for q, _rid, rs, re_ in chunk]
            tr.launches[name] = bound_ms(*extd2_roofline.work(lens, ab.w))
            t = time.perf_counter()
            with torch.profiler.record_function(name):
                try:
                    return fn(ab, chunk)
                finally:
                    tr.spans["align"].append((t, time.perf_counter()))
        return wrapped

    def install(self):
        for (m, attr), name in SPANS.items():
            obj = self.mods[m]
            if "." in attr:
                cls, attr = attr.split(".")
                obj = getattr(obj, cls)
            self.saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, self._wrap(getattr(obj, attr), name))
        ab = self.mods["align_batch"].AlignBatcher
        self.saved.append((ab, "dispatch", ab.dispatch))
        ab.dispatch = self._dispatch(ab.dispatch)

    def remove(self):
        for obj, attr, fn in reversed(self.saved):
            setattr(obj, attr, fn)
        self.saved.clear()

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        try:
            from torch._C._profiler import _ExperimentalConfig
            cfg = _ExperimentalConfig(profile_all_threads=True)
            self.prof = torch.profiler.profile(activities=acts,
                                               experimental_config=cfg)
        except (ImportError, TypeError):
            self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.win = torch.profiler.record_function("window")
        self.win_pc = time.perf_counter()
        self.win.__enter__()

    def end_window(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.win.__exit__(None, None, None)

    def stop(self):
        self.prof.__exit__(None, None, None)


def _union(iv):
    """Merged (start, end) intervals of a list, sorted."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_span(name: str) -> bool:
    return name == "window" or name.split(":")[0] in NAMES


NAMES = set(SPANS.values()) | {"align"}


class _Kernels:
    """The device's kernel, copy and set intervals, for the device time
    that falls inside an interval (one stream: they do not overlap)."""

    def __init__(self, evs):
        evs = sorted(evs, key=lambda e: e[2])
        self.st = np.array([e[2] for e in evs], np.float64)
        self.en = np.array([e[3] for e in evs], np.float64)
        self.names = [e[0] for e in evs]

    def inside(self, s, e, pred=None):
        lo = int(np.searchsorted(self.en, s, "right"))
        hi = int(np.searchsorted(self.st, e, "left"))
        tot = 0.0
        for k in range(lo, hi):
            if pred is None or pred(self.names[k]):
                tot += max(0.0, min(self.en[k], e) - max(self.st[k], s))
        return tot


def _events(prof):
    """(name, on the device, start us, end us) of every profiled event,
    from the profiler's raw results (its FunctionEvent tree takes minutes
    to build over a window of this size), on one clock from the first."""
    cpu = torch.autograd.DeviceType.CPU
    raw = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in raw), default=0)
    out = []
    for e in raw:
        s = (e.start_ns() - base) / 1e3
        out.append((e.name(), e.device_type() != cpu, s,
                    s + e.duration_ns() / 1e3))
    return out


def reduce(tracer: Tracer, t0: float, t1: float):
    """The traced window's record: per-layer inputs, busy and window
    seconds, and the breakdown.  The profiler shows each span twice: on the
    host, and on the device from its first launch to its last (a user
    annotation); a span's device time is the kernels' inside the latter.
    The per-batch device times take the annotations that start in the
    measured window [t0, t1) (host clock), and the batches are the
    paf_step annotations among them."""
    evs = _events(tracer.prof)
    ws, we = next((s, e) for n, d, s, e in evs if n == "window" and not d)
    dev = [x for x in evs if x[1]]
    ann = [x for x in dev if _is_span(x[0])]
    ker = [x for x in dev if not _is_span(x[0]) and x[3] > ws and x[2] < we]
    busy = _union([(max(s, ws), min(e, we)) for _, _, s, e in ker])
    busy_us = sum(e - s for s, e in busy)
    ops = defaultdict(float)
    for n, _, s, e in ker:
        ops[n] += e - s
    # idle gaps, each labelled by the innermost host span open at its
    # middle ("unspanned": SAM formatting, reading the queries, the loop)
    by_label = defaultdict(list)
    for n, d, s, e in evs:
        if not d and n != "window" and _is_span(n):
            by_label[n.split(":")[0]].append((s, e))
    starts = {}
    for lb, v in by_label.items():
        v.sort()
        starts[lb] = np.array([x[0] for x in v], np.float64)
    gaps = defaultdict(float)
    edges = [ws] + [x for s, e in busy for x in (s, e)] + [we]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        best = None
        for lb, v in by_label.items():
            k = int(np.searchsorted(starts[lb], mid, "right"))
            for a_, b_ in v[max(0, k - 8):k]:     # a span a client thread
                if b_ > mid and (best is None or b_ - a_ < best[0]):
                    best = (b_ - a_, lb)
        gaps[best[1] if best else "unspanned"] += e - s
    kern = _Kernels(ker)

    def in_window(x):       # the profiler's clock, in us, to the host's
        return t0 <= tracer.win_pc + (x[2] - ws) / 1e6 < t1
    ann = [x for x in ann if in_window(x)]
    steps = [x for x in ann if x[0] == "paf_step"]
    batches = len(steps)
    step_us = sum(kern.inside(s, e) for _, _, s, e in steps)
    align_us = ext_us = ext_bound = 0.0
    for n, _, s, e in ann:
        if n.startswith("align:"):
            align_us += kern.inside(s, e)
            k = kern.inside(s, e, lambda kn: "extd2" in kn)
            if k > 0 and tracer.launches.get(n):
                ext_us += k
                ext_bound += tracer.launches[n] * 1e3
    spans = {n: [(a, b) for a, b in v if t0 <= a < t1]
             for n, v in tracer.spans.items()}
    top = sorted(ops.items(), key=lambda x: -x[1])[:10]
    return {
        "window_s": (we - ws) / 1e6, "busy_s": busy_us / 1e6,
        "batches": batches, "spans": spans,
        "paf_step_device_ms": step_us / 1e3,
        "align_device_ms": align_us / 1e3,
        "extd2_us": ext_us, "extd2_bound_us": ext_bound,
        "breakdown": {
            "device_ops": [[n, v / 1e6] for n, v in top],
            "idle_gaps": [[n, v / 1e6] for n, v in sorted(
                gaps.items(), key=lambda x: -x[1])[:10]]},
    }
