"""regs_reg_ms: host milliseconds a batch of regs:finish less its
trim_ns (build_reg and the loop), plus regs:mapq (dp_max2, n_sub and
set_mapq)."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    w = ps.window(rec, log)
    return w and ps.plus(ps.less(w.ms("regs:finish"),
                                 w.attr_ms("regs:finish", "trim_ns")),
                         w.ms("regs:mapq"))
