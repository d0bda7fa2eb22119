"""Where a client's SAM goes: every line is formatted by the program and
handed here, timed, and dropped but for what the output check reads.

A unit is what the program writes records for as one: a read, or a pair's
fragment.  Units are fed in pool order, over and over, ``batch`` at a
time, and the pool is a whole number of batches; a batch's units come
back together, each with one or more lines, in an order of the
program's.  The sink times each unit by its first line, counts the units
a finished batch lacks, and keeps, from the first batch written after
``keep_from`` on (the window's start), the fields of every unit it
writes (SEQ and QUAL dropped: the pool holds them).  Once
``close`` is called, the next write raises ``WindowClosed``, which
ends the client's call into the program.
"""
from __future__ import annotations

import threading
import time

import numpy as np


class WindowClosed(Exception):
    pass


class Sink:
    def __init__(self, names, batch: int):
        self.index = {nm: i for i, nm in enumerate(names)}
        self.n = len(names)
        self.batch = batch
        if self.n % batch:
            raise ValueError("the pool is not a whole number of batches")
        self.buf = ""
        self.cur = None
        self.block, self.seen = None, set()
        self.times = []             # first-line time of each unit written
        self.starts = []            # first-line time of each batch
        self.missing = 0            # units skipped in the stream
        self.kept = []              # (time, pool index, [fields])
        self.keep_from = None       # the window opens at the first batch
        self.t0 = None              # written from here on, and keeps units
        self.closed = threading.Event()

    def write(self, s: str):
        if self.closed.is_set():
            raise WindowClosed
        self.buf += s
        if "\n" not in self.buf:
            return
        *lines, self.buf = self.buf.split("\n")
        t = time.perf_counter()
        for ln in lines:
            if ln and ln[0] != "@":
                self._line(ln, t)

    def flush(self):
        pass

    def _line(self, ln: str, t: float):
        f = ln.split("\t")
        i = self.index[f[0]]
        if i != self.cur:
            self._block(i // self.batch, t)
            self.seen.add(i)
            self.cur = i
            self.times.append(t)
            if self.t0 is not None:
                self.kept.append((t, i, []))
        if self.t0 is not None:
            self.kept[-1][2].append(f[:9] + f[11:])

    def _block(self, b: int, t: float):
        """Account for the batch a unit belongs to: a new batch closes the
        last one, which must have come whole, and must be its successor."""
        if b == self.block:
            return
        self.starts.append(t)
        if self.t0 is None and self.keep_from is not None \
                and t >= self.keep_from:
            self.t0 = t
        if self.block is not None:
            self.missing += self.batch - len(self.seen)
            nb = self.n // self.batch
            self.missing += ((b - self.block - 1) % nb) * self.batch
        self.block, self.seen = b, set()

    def close(self):
        self.closed.set()

    def start_at(self, t: float):
        """The first batch start at or after t; None while it has not
        come."""
        return next((x for x in self.starts if x >= t), None)

    def in_window(self, t0: float, t1: float):
        """(units written in [t0, t1), [(pool index, records)] of each)."""
        ts = np.asarray(self.times)
        n = int(((ts >= t0) & (ts < t1)).sum())
        kept = [(i, recs) for t, i, recs in self.kept if t0 <= t < t1]
        return n, kept
