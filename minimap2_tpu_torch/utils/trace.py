"""The port's per-batch stage spans, recorded while a torch profiler runs.

Tracing is on exactly while ``torch.profiler`` (or the autograd profiler)
records: there is nothing to switch on.  Off, opening a span is one flag
check; it takes no timestamp, opens no profiler range and logs nothing.
On, a span opens a profiler range of its name, so the profiler's trace
(``export_chrome_trace``) shows it on the device trace's clock beside the
kernels it launched, and when it closes it appends one ``Span`` to
``LOG``, a bounded deque: (name, batch, parent, t0, t1, attrs, id), with
``time.perf_counter_ns()`` times.

A name is ``<label>:<stage>`` (``NAMES``).  A batch takes its id
(``new_batch``) when its reads start to be read, or at ``dispatch_batch``;
``batch(bid)`` makes it the current batch of the thread's spans.  A span's
parent is the innermost span open on its thread.  Spans are per batch and
stage, never per job, read or fragment: time spent per job inside a stage
goes into the stage span's attrs (``clock`` and ``charge``, which read the
clock only while tracing is on).  ``spans()`` returns the log.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

from torch._C._profiler import _RecordFunctionFast as _Range
from torch.autograd import profiler as _profiler

# every span the port opens, by label; the labels are those the
# benchmark's trace reduction (benchmarks/trace.py) counts as spans
STAGES = {
    "encode": ("read", "pack"),
    "paf_step": ("sketch", "probe", "anchors", "chain", "select"),
    "regs": ("fetch", "jobs", "align", "finish", "mapq"),
    "pairing": ("batch",),
}
NAMES = frozenset(f"{lb}:{st}" for lb, sts in STAGES.items() for st in sts)


class Span(NamedTuple):
    name: str
    batch: int | None       # None: opened outside any batch
    parent: int | None      # id of the innermost span open at its start
    t0: int                 # time.perf_counter_ns()
    t1: int
    attrs: dict
    id: int


LOG: deque = deque(maxlen=1 << 18)
_span_ids = itertools.count(1)
_batch_ids = itertools.count()


class _Thread(threading.local):
    def __init__(self):
        self.stack = []     # open spans, innermost last
        self.batch = None


_tls = _Thread()


def on() -> bool:
    """True while a torch profiler records."""
    return _profiler._is_profiler_enabled


def spans() -> list[Span]:
    """The logged spans, oldest first (each logged when it closes)."""
    return list(LOG)


def new_batch() -> int:
    """A new process-wide batch id."""
    return next(_batch_ids)


class batch:
    """Make ``bid`` the current batch of this thread's spans inside the
    block; with None, keep the current one, or take a new id if there is
    none.  ``with batch() as bid``."""
    __slots__ = ("bid", "prev")

    def __init__(self, bid: int | None = None):
        self.bid = bid

    def __enter__(self) -> int:
        self.prev = _tls.batch
        if self.bid is None:
            self.bid = self.prev if self.prev is not None else new_batch()
        _tls.batch = self.bid
        return self.bid

    def __exit__(self, *exc):
        _tls.batch = self.prev


class _Open:
    """A span that is open: closed by ``with`` or ``close()``."""
    __slots__ = ("name", "batch", "parent", "t0", "attrs", "id", "rf")

    def __init__(self, name: str, bid: int | None):
        st = _tls.stack
        self.name = name
        self.batch = _tls.batch if bid is None else bid
        self.parent = st[-1].id if st else None
        self.attrs = {}
        self.id = next(_span_ids)
        self.t0 = time.perf_counter_ns()
        # a function-scope range: the profiler annotates a kernel on the
        # device with the innermost user-scope range (record_function's)
        # open at its launch, so a user-scope span would take its kernels
        # from the range around it, where benchmarks/trace.py counts a
        # batch's device time (its paf_step and align:* ranges)
        self.rf = _Range(name)
        self.rf.__enter__()
        st.append(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add(self, **attrs):
        """Add each value to the attr of its name (from 0)."""
        a = self.attrs
        for k, v in attrs.items():
            a[k] = a.get(k, 0) + v

    def close(self):
        if self.rf is None:
            return
        self.rf.__exit__(None, None, None)
        self.rf = None
        t1 = time.perf_counter_ns()
        _tls.stack.remove(self)
        LOG.append(Span(self.name, self.batch, self.parent, self.t0, t1,
                        self.attrs, self.id))


class _Off:
    """The span opened while tracing is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def add(self, **attrs):
        pass

    def close(self):
        pass


_OFF = _Off()


def span(name: str, batch: int | None = None):
    """Open the span ``name`` (one of NAMES) of the current batch, or of
    ``batch``; use it in a ``with`` or close it with ``close()``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, batch)


def clock() -> int:
    """perf_counter_ns() while tracing is on, else 0: a timer's start for
    ``charge``."""
    return time.perf_counter_ns() if _profiler._is_profiler_enabled else 0


def charge(key: str, t0: int):
    """Add the ns since ``clock()`` gave ``t0`` to the attr ``key`` of this
    thread's innermost open span; nothing for t0 0 or with none open."""
    if t0:
        dt = time.perf_counter_ns() - t0
        st = _tls.stack
        if st:
            a = st[-1].attrs
            a[key] = a.get(key, 0) + dt
