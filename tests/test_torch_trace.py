"""The port's stage spans (minimap2_tpu_torch/utils/trace.py) on short
paired-end runs: engine.align_pairs through run_batched_pe_cli on the
first pairs of tests/data/sr-r{1,2}.fq against MT-human.fa, on the CPU.

(a) With no profiler running, a run opens no profiler range, reads no
    clock through the recorder and logs nothing.
(b) Under torch.profiler every logged span has a host profiler event of
    its name, as many of each; shifted to their first, the starts agree
    within 1 ms.  No span is a user-scope range, which would take the
    device annotation of its kernels from the range around it.
(c) Each batch's spans carry its one batch id (one span a stage, the id
    following the batch through the pipeline); parents are open spans
    that hold their children; the regs:* spans lie inside the call to
    batch_build_regs; the stage attrs count the batch's reads and jobs.
(d) Every name the port can open is a span of benchmarks/trace.py's
    reduction and no align:* range.
"""
import io
import re
import time
from collections import defaultdict, deque
from pathlib import Path

import pytest
import torch

from benchmarks import trace as bench_trace
from minimap2_tpu_torch import config
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.io import fastx
from minimap2_tpu_torch.parallel import engine
from minimap2_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
MT = ROOT / "tests/data/MT-human.fa"
SR = [ROOT / "tests/data/sr-r1.fq", ROOT / "tests/data/sr-r2.fq"]
# one DP launch a batch, and few anti-diagonals: the CPU profiler records
# every op of the plain DP loops
KW = {"QP": 192, "TP": 192, "W": 256, "sub": 128}
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def world():
    names, seqs = fastx.read_fasta(str(MT))
    io_opt, mo = config.IndexOptions(), config.MapOptions()
    config.set_opt("sr", io_opt, mo)
    mo.flag |= config.MM_F_CIGAR | config.MM_F_OUT_SAM
    mi = MiniIndex.build(names, seqs, w=io_opt.w, k=io_opt.k)
    config.mapopt_update(mo, mi)
    return mi, mo


def _pairs(tmp, n):
    """The first n pairs of the fixture, as two FASTQ files."""
    out = []
    for path in SR:
        lines = path.read_text().splitlines(keepends=True)[:4 * n]
        dst = tmp / path.name
        dst.write_text("".join(lines))
        out.append(str(dst))
    return out


def _run(world, queries, batch_frags):
    mi, mo = world
    out = io.StringIO()
    n, fallbacks = engine.run_batched_pe_cli(
        mi, mo, queries, out, batch_frags=batch_frags, L=256, align_kw=KW,
        device="cpu")
    assert fallbacks == []
    return n, out.getvalue()


@pytest.fixture(scope="module")
def traced(world, tmp_path_factory):
    """16 pairs in two batches under the CPU profiler: (logged spans, host
    profiler events (name, start ns, record scope) of the port's names,
    the batch_build_regs calls (start, end) on perf_counter_ns)."""
    queries = _pairs(tmp_path_factory.mktemp("traced"), 16)
    calls = []
    build = engine.batch_build_regs

    def timed(*a, **kw):
        t = time.perf_counter_ns()
        try:
            return build(*a, **kw)
        finally:
            calls.append((t, time.perf_counter_ns()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "LOG", deque(maxlen=1 << 10))
        mp.setattr(engine, "batch_build_regs", timed)
        with torch.profiler.profile(activities=CPU) as prof:
            n, _ = _run(world, queries, 8)
        logged = trace.spans()
    assert n == 32
    evs = [(e.name(), e.start_ns(), e.scope())
           for e in prof.profiler.kineto_results.events()
           if e.name() in trace.NAMES]
    return logged, evs, calls


def test_no_profiler_logs_nothing(world, tmp_path, monkeypatch):
    class NoClock:
        @staticmethod
        def perf_counter_ns():
            raise AssertionError("the recorder read the clock")

    def no_range(name, *args):
        raise AssertionError(f"the port opened the range {name}")
    monkeypatch.setattr(trace, "LOG", deque(maxlen=16))
    monkeypatch.setattr(trace, "time", NoClock)
    monkeypatch.setattr(trace, "_Range", no_range)
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not trace.on()
    n, text = _run(world, _pairs(tmp_path, 8), 8)
    assert n == 16 and len(text.splitlines()) == 16
    assert trace.spans() == []


def test_spans_are_profiler_ranges(traced):
    logged, evs, _ = traced
    assert logged and {s.name for s in logged} == trace.NAMES
    user = int(torch._C._profiler.RecordScope.USER_SCOPE)
    assert all(scope != user for _, _, scope in evs)
    by_name = defaultdict(list)
    for name, t, _ in evs:
        by_name[name].append(t)
    e0 = min(t for _, t, _ in evs)
    s0 = min(s.t0 for s in logged)
    for name in trace.NAMES:
        starts = sorted(s.t0 - s0 for s in logged if s.name == name)
        got = sorted(t - e0 for t in by_name[name])
        assert len(got) == len(starts), name
        for a, b in zip(starts, got):
            assert abs(a - b) < 1_000_000, (name, a, b)


def test_spans_carry_their_batch(traced):
    logged, _, calls = traced
    by_id = {s.id: s for s in logged}
    for s in logged:
        assert s.batch is not None and s.t0 <= s.t1
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    batches = defaultdict(list)
    for s in logged:
        batches[s.batch].append(s)
    full = sorted(b for b, v in batches.items()
                  if any(s.name == "regs:fetch" for s in v))
    assert len(full) == 2 and len(calls) == 2
    for b in batches:
        names = sorted(s.name for s in batches[b])
        # the read span past the last batch meets the end of the files
        assert names == (sorted(trace.NAMES) if b in full
                         else ["encode:read"])
    for s in logged:
        if s.name.startswith("regs:"):
            assert any(a <= s.t0 and s.t1 <= e for a, e in calls), s.name
    # batch n + 1 is read and dispatched before batch n's regs
    first, second = ({s.name: s for s in batches[b]} for b in full)
    assert second["encode:pack"].t1 <= first["regs:fetch"].t0
    assert second["paf_step:select"].t1 <= first["regs:fetch"].t0
    for b in full:
        st = {s.name: s for s in batches[b]}
        assert st["encode:read"].attrs["reads"] == 16
        assert st["regs:jobs"].attrs["reads"] == 16
        assert st["regs:jobs"].attrs["jobs"] >= 16
        assert st["regs:align"].attrs["wait_ns"] > 0
        assert 0 < st["regs:finish"].attrs["trim_ns"] \
            < st["regs:finish"].t1 - st["regs:finish"].t0
        assert 0 < st["pairing:batch"].attrs["sam_ns"] \
            < st["pairing:batch"].t1 - st["pairing:batch"].t0


def test_span_names_are_benchmark_spans():
    src = "".join(p.read_text() for p in
                  (ROOT / "minimap2_tpu_torch").rglob("*.py"))
    opened = set(re.findall(r'trace\.span\(\s*"([^"]+)"', src))
    assert opened == trace.NAMES
    for name in trace.NAMES:
        assert bench_trace._is_span(name), name
        assert not name.startswith("align:")
        assert name.split(":")[0] != "align"


def test_nesting_batches_and_charges(monkeypatch):
    monkeypatch.setattr(trace, "LOG", deque(maxlen=16))
    trace.charge("wait_ns", trace.clock())      # off: nothing to charge
    with torch.profiler.profile(activities=CPU):
        assert trace.on()
        with trace.batch() as b0:
            with trace.span("regs:align") as outer:
                trace.charge("wait_ns", trace.clock())
                with trace.span("regs:finish"):
                    trace.charge("trim_ns", trace.clock())
                outer.add(jobs=2)
                outer.add(jobs=3)
            with trace.batch() as again:
                assert again == b0
        with trace.batch(trace.new_batch()) as b1:
            assert b1 != b0
            rd = trace.span("encode:read", batch=b0)
            rd.close()
            rd.close()
        trace.charge("sam_ns", trace.clock())   # no span open
    finish, align, read = trace.spans()
    assert (finish.name, align.name, read.name) == (
        "regs:finish", "regs:align", "encode:read")
    assert finish.parent == align.id and align.parent is None
    assert read.parent is None and read.batch == b0
    assert finish.batch == align.batch == b0
    assert set(align.attrs) == {"wait_ns", "jobs"} and align.attrs["jobs"] == 5
    assert set(finish.attrs) == {"trim_ns"}
    assert align.t0 <= finish.t0 <= finish.t1 <= align.t1
