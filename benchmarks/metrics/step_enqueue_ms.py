"""step_enqueue_ms: host milliseconds a batch of the program's five
paf_step spans (sketch, probe, anchors, chain, select): the host's cost
of launching the mapping step."""
from benchmarks import program_spans as ps


def read(rec, log=None):
    w = ps.window(rec, log)
    return w and w.ms(*ps.STEP)
