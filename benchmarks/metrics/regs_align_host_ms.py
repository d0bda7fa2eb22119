"""regs_align_host_ms: host milliseconds a batch of the program's
regs:align span less its wait_ns: AlignBatcher's packing, upload, launch
and CIGAR decoding."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    w = ps.window(rec, log)
    return w and ps.less(w.ms("regs:align"), w.attr_ms("regs:align",
                                                        "wait_ns"))
