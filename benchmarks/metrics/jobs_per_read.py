"""jobs_per_read: alignment jobs a read of the window's batches, from the
program's regs:jobs span (its attrs jobs over reads)."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    w = ps.window(rec, log)
    if w is None:
        return None
    reads = w.attr_sum("regs:jobs", "reads")
    return w.attr_sum("regs:jobs", "jobs") / reads if reads else None
