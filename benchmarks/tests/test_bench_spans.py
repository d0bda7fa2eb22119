"""The readers of the program's own spans (program_spans.py and the
eleven metrics on it) on a synthetic record and log: the window's batches
chosen by the benchmark's regs spans, the per-batch stage sums and their
subtractions (wait_ns, trim_ns, sam_ns), the union behind
unspanned_host_pct, and None where the log has no window batch."""
import sys

import pytest

from benchmarks import harness
from benchmarks import program_spans as ps

MS = 1_000_000
S = 1_000_000_000
SPAN_METRICS = ["encode_host_ms", "step_enqueue_ms", "regs_wait_ms",
                "regs_jobs_ms", "regs_align_host_ms", "regs_trim_ms",
                "regs_reg_ms", "pair_ms", "sam_ms", "unspanned_host_pct",
                "jobs_per_read"]


def _batch(bid, t, log, skip=()):
    """One batch's spans, regs:fetch starting at t ns: (name, ms, attrs)
    laid one after another from t - 200 ms (the read and the step) and
    from t (the regs and pairing stages)."""
    stages = [("encode:read", 100, {"reads": 4}), ("encode:pack", 10, {})]
    stages += [(n, 1, {}) for n in ps.STEP]
    at = t - 200 * MS
    for name, ms, attrs in stages:
        if name not in skip:
            log.append((name, bid, None, at, at + ms * MS, attrs, len(log)))
        at += ms * MS
    at = t
    for name, ms, attrs in [
            ("regs:fetch", 2, {}), ("regs:jobs", 5, {"reads": 4, "jobs": 6}),
            ("regs:align", 20, {"wait_ns": 8 * MS}),
            ("regs:finish", 30, {"trim_ns": 12 * MS}),
            ("regs:mapq", 1, {}), ("pairing:batch", 10, {"sam_ns": 6 * MS})]:
        log.append((name, bid, None, at, at + ms * MS, attrs, len(log)))
        at += ms * MS


@pytest.fixture
def world():
    """Batches 0 and 1 in the window's regs spans; batch 2's regs:fetch
    after the window, batch 3's in a gap between its regs spans.  Batch
    0 logged no encode:read (its read began before the profiler)."""
    log = []
    _batch(0, 1 * S + MS, log, skip=("encode:read",))
    _batch(1, 2 * S + MS, log)
    _batch(2, 9 * S, log)
    _batch(3, int(1.5 * S), log)
    rec = {"spans": {"regs": [(2.0, 2.1), (1.0, 1.1)]}}
    return rec, log


def test_window_batches(world):
    rec, log = world
    assert ps.Window(rec, log).batches == {0, 1}
    assert ps.window({"spans": {}}, log) is None
    assert ps.window(rec, []) is None


@pytest.mark.parametrize("name,want", [
    ("encode_host_ms", 10.0 + 100.0 / 2),
    ("step_enqueue_ms", 5.0),
    ("regs_wait_ms", 2.0 + 8.0),
    ("regs_jobs_ms", 5.0),
    ("regs_align_host_ms", 20.0 - 8.0),
    ("regs_trim_ms", 12.0),
    ("regs_reg_ms", 30.0 - 12.0 + 1.0),
    ("pair_ms", 10.0 - 6.0),
    ("sam_ms", 6.0),
    ("jobs_per_read", 6 / 4),
])
def test_stage_readers(world, name, want):
    rec, log = world
    assert harness.metric_reader(name)(rec, log) == pytest.approx(want)


def test_regs_metrics_add_up_to_the_regs_spans(world):
    rec, log = world
    got = sum(harness.metric_reader(n)(rec, log) for n in (
        "regs_wait_ms", "regs_jobs_ms", "regs_align_host_ms",
        "regs_trim_ms", "regs_reg_ms"))
    assert got == pytest.approx(2 + 5 + 20 + 30 + 1)


def test_unspanned_is_the_union_gap():
    """Window [10, 12] s from the regs spans; the program's spans cover
    [10, 10.6] (two overlapping) and [11, 11.8] (two overlapping), and one
    lies past the window: 0.6 s of 2 uncovered."""
    rec = {"spans": {"regs": [(10.0, 10.5), (11.0, 12.0)]}}
    log = [("regs:fetch", 0, None, 10 * S, int(10.2 * S), {}, 1),
           ("regs:jobs", 0, None, int(10.1 * S), int(10.6 * S), {}, 2),
           ("pairing:batch", 0, None, 11 * S, int(11.5 * S), {}, 3),
           ("encode:read", 1, None, int(11.4 * S), int(11.8 * S), {}, 4),
           ("encode:pack", 1, None, 13 * S, 14 * S, {}, 5)]
    got = harness.metric_reader("unspanned_host_pct")(rec, log)
    assert got == pytest.approx(100.0 * 0.6 / 2.0)
    # a log of six-field records, as the program's log is documented
    six = [r[:6] for r in log]
    assert harness.metric_reader("unspanned_host_pct")(rec, six) \
        == pytest.approx(got)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_without_window_batches(world, name):
    rec, log = world
    read = harness.metric_reader(name)
    assert read(rec, []) is None
    assert read({"spans": {}}, log) is None
    assert read({"spans": {"regs": [(50.0, 51.0)]}}, log) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_from_a_program_without_spans(world, monkeypatch, name):
    """The parent commit has no span module: the readers find nothing and
    raise nothing."""
    import minimap2_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "minimap2_tpu_torch.utils.trace", None)
    assert ps.program_log() == []
    rec, _ = world
    assert harness.metric_reader(name)(rec) is None
