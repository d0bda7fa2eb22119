"""regs_wait_ms: host milliseconds a batch the regs layer waits on the
card: the regs:fetch span (the chain records' download) plus regs:align's
wait_ns (AlignBatcher.collect's downloads)."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    w = ps.window(rec, log)
    return w and ps.plus(w.ms("regs:fetch"), w.attr_ms("regs:align",
                                                        "wait_ns"))
