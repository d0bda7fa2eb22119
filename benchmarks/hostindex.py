"""The host index of a device-built index, as a deployment that builds on
the card makes it.

The port's host mapping path (the reads its device path hands off) and its
aligner read a MiniIndex on the host: the sorted minimizer keys, each key's
run in the position array, the positions (rid << 32 | pos << 1 | strand)
and the reference codes.  The keys, runs and positions come from the
program's own ``devbuild.host_tables`` (its time is the program's set-up
work); the codes are the genome the benchmark made, laid end to end as
``MiniIndex.build_codes`` lays them.
"""
from __future__ import annotations

import time

import numpy as np


def host_index(di, meta, codes):
    """(a MiniIndex over the device index ``di``, built with ``meta``, and
    the genome's host codes, one array a contig in the build's order; the
    seconds of the program's host_tables call)."""
    from minimap2_tpu_torch.index.index import MiniIndex, SeqMeta
    from minimap2_tpu_torch.parallel.devbuild import host_tables
    t = time.perf_counter()
    keys, st, cn, y = host_tables(di, meta)
    secs = time.perf_counter() - t
    n = len(y)
    if len(st) and st[0] == 0 and (st[1:] > st[:-1]).all():
        # runs tile the positions in key order: a key's run reaches the
        # next key's (counts may be clamped by the probe table's rows; the
        # run of a key the table dropped, at most one in a million, joins
        # the key before it)
        cn = np.diff(np.append(st, n))
        pos = y
    else:               # gather each kept key's run
        base = np.cumsum(cn) - cn
        pos = y[np.repeat(st - base, cn) + np.arange(int(cn.sum()))]
    mi = MiniIndex(meta.w, meta.k, 14, 0)
    mi.keys = keys
    mi.starts = np.concatenate([[0], np.cumsum(cn)]).astype(np.int64)
    mi.pos = pos
    mi.S = np.concatenate(codes) if codes else np.empty(0, np.uint8)
    off = 0
    for nm, c in zip(meta.names, codes):
        mi.seq.append(SeqMeta(name=str(nm), offset=off, length=len(c)))
        off += len(c)
    return mi, secs
