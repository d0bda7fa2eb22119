"""regs_jobs_ms: host milliseconds a batch of the program's regs:jobs
span (the loop over chain slots that builds the alignment jobs)."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    w = ps.window(rec, log)
    return w and w.ms("regs:jobs")
