"""Multi-worker host mapping: the kt_for/kt_pipeline analogue (-t), after
minimap2_tpu.map.parallel_host.

The reference maps fragments with ``kt_for`` worker threads inside a
3-step ordered pipeline (kthread.c:54-159, map.c:541-641).  Python
threads cannot run the mapping's Python loops in parallel, so fragments
go to spawned worker processes instead: each worker loads the index and
options once, maps and formats a chunk of fragments, and ``imap`` keeps
input order, like the pipeline's ordered step-2 write.  Spawn, not fork:
the parent may hold threads (torch's pools), and forking a threaded
process can deadlock.

The index reaches the workers through a pickle file that the parent
writes once, not through the pool's initargs: a spawning parent writes
each worker's arguments into its pipe and waits there while the worker
imports its modules, so a large index would start the workers one after
another, each behind the last one's imports.

The workers map with the debug output off: the JAX package keeps it in
module globals that its spawned workers never set, so its pool prints no
QR lines under --print-qname (the reference does; ROADMAP Queue 3).  The
other debug flags keep the CLI serial.
"""
from __future__ import annotations

import copy
import io
import os
import pickle
import tempfile

from .driver import iter_fragments, map_fragment, write_fragment

_G: tuple | None = None     # (mi, mo) installed by the pool initializer


def _init_worker(state_path: str):
    global _G
    with open(state_path, "rb") as f:
        _G = pickle.load(f)


def map_fragments(mi, mo, frags, out) -> int:
    """Map each fragment and write its records to out, in order; returns
    the number of reads mapped.  The serial loop, and a worker's."""
    n = 0
    for frag in frags:
        results = map_fragment(mi, mo, frag)
        write_fragment(out, mi, mo, frag, [res.regs for res in results],
                       [res.rep_len for res in results])
        n += len(frag)
    return n


def _work_chunk(frags):
    mi, mo = _G
    buf = io.StringIO()
    n = map_fragments(mi, mo, frags, buf)
    return n, buf.getvalue()


def run_parallel(mi, mo, queries, out, frag_mode: bool, n_threads: int,
                 chunk_frags: int = 16) -> int:
    """Map all fragments with a spawn pool of n_threads workers, writing
    their output in input order; returns the number of reads mapped."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")

    def chunks():
        cur = []
        for frag in iter_fragments(queries, frag_mode):
            cur.append(frag)
            if len(cur) >= chunk_frags:
                yield cur
                cur = []
        if cur:
            yield cur

    n_mapped = 0
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.pkl")
        mo_w = copy.copy(mo)
        mo_w.dbg_flag = 0
        with open(state, "wb") as f:
            pickle.dump((mi, mo_w), f, protocol=pickle.HIGHEST_PROTOCOL)
        with ctx.Pool(n_threads, initializer=_init_worker,
                      initargs=(state,)) as pool:
            for n, txt in pool.imap(_work_chunk, chunks()):
                out.write(txt)
                n_mapped += n
    return n_mapped
