"""regs_trim_ms: host milliseconds a batch of regs:finish's trim_ns: the
native Kadane trim and z-drop audit of each job's CIGAR."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    w = ps.window(rec, log)
    return w and w.attr_ms("regs:finish", "trim_ns")
