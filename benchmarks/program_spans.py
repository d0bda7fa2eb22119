"""The program's own stage spans, per batch of the traced window.

The program logs its spans while the profiler records
(minimap2_tpu_torch/utils/trace.py): one record a stage and batch,
(name, batch id, parent id, start ns, end ns, attrs, ...) on
time.perf_counter_ns(), the clock of the window and of the benchmark's
own spans (trace.py, seconds).  The window's batches are those whose
``regs:fetch`` starts inside one of the window's ``regs`` spans
(``rec["spans"]["regs"]``).  Every reader returns None where the log has
no window batch, as with a program that logs no spans.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

STEP = ("paf_step:sketch", "paf_step:probe", "paf_step:anchors",
        "paf_step:chain", "paf_step:select")


def program_log():
    """The program's span log; empty where the program has none."""
    try:
        from minimap2_tpu_torch.utils import trace
    except ImportError:
        return []
    return trace.spans()


class Window:
    """The log's spans of the window's batches, by stage name."""

    def __init__(self, rec, log=None):
        log = program_log() if log is None else log
        regs = sorted(rec["spans"].get("regs", []))
        starts = [a for a, _ in regs]
        self.batches = set()
        for name, bid, _parent, t0, _t1, _attrs, *_ in log:
            if name != "regs:fetch" or bid is None:
                continue
            k = bisect.bisect_right(starts, t0 / 1e9) - 1
            if k >= 0 and t0 / 1e9 < regs[k][1]:
                self.batches.add(bid)
        self.by_name = defaultdict(list)    # name -> [(batch, ns, attrs)]
        for name, bid, _parent, t0, t1, attrs, *_ in log:
            if bid in self.batches:
                self.by_name[name].append((bid, t1 - t0, attrs))
        self.log = log
        self.regs = regs

    def ms(self, *names):
        """Milliseconds a batch of the named stages, summed, over the
        window batches that logged any of them; None without one."""
        rows = [r for n in names for r in self.by_name[n]]
        n_b = len({b for b, _, _ in rows})
        if not n_b:
            return None
        return sum(ns for _, ns, _ in rows) / n_b / 1e6

    def attr_ms(self, name, key):
        """Milliseconds a batch of the attr ``key`` of the stage ``name``."""
        rows = self.by_name[name]
        n_b = len({b for b, _, _ in rows})
        if not n_b:
            return None
        return sum(a.get(key, 0) for _, _, a in rows) / n_b / 1e6

    def attr_sum(self, name, key):
        return sum(a.get(key, 0) for _, _, a in self.by_name[name])


def window(rec, log=None):
    """The window's batches, or None where the log holds none."""
    w = Window(rec, log)
    return w if w.batches else None


def less(a, b):
    """a - b, or None where either is."""
    return None if a is None or b is None else a - b


def plus(*xs):
    """The sum, or None where any is."""
    return None if any(x is None for x in xs) else sum(xs)


def unspanned_pct(rec, log=None):
    """Share of the time from the window's first regs span to its last
    that no span of the program covers (the union of all its spans), in
    percent."""
    w = window(rec, log)
    if w is None:
        return None
    lo, hi = w.regs[0][0], max(b for _, b in w.regs)
    if hi <= lo:
        return None
    iv = sorted((max(t0 / 1e9, lo), min(t1 / 1e9, hi))
                for _, _, _, t0, t1, *_ in w.log
                if t1 / 1e9 > lo and t0 / 1e9 < hi)
    covered = 0.0
    end = lo
    for s, e in iv:
        if e > end:
            covered += e - max(s, end)
            end = e
    return 100.0 * (1.0 - covered / (hi - lo))
