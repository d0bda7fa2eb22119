"""pair_ms: host milliseconds a batch of the program's pairing:batch span
less its sam_ns: mm_pair, the strand flips and the fragment loop (and the
host path's mapping of a fragment handed to it)."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    w = ps.window(rec, log)
    return w and ps.less(w.ms("pairing:batch"),
                         w.attr_ms("pairing:batch", "sam_ns"))
