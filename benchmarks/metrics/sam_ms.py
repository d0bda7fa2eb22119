"""sam_ms: host milliseconds a batch of pairing:batch's sam_ns: formatting
and writing the SAM records (write_fragment)."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    w = ps.window(rec, log)
    return w and w.attr_ms("pairing:batch", "sam_ns")
