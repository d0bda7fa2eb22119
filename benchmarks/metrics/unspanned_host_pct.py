"""unspanned_host_pct: share of the time from the window's first regs
span to its last that no span of the program covers (the union of all its
spans), in percent."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    return ps.unspanned_pct(rec, log)
