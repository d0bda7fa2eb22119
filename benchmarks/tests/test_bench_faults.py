"""The output check against a broken timed path: each fault a cell can have
makes ``correct`` false, and the sound path keeps it true.  On the CPU at
a small size (the kernels' plain versions), through the whole run but the
look for a chip; the chip-marked tests read the control and the
half-batch fault at the cells' own sizes on the card.

Faults: the mapping step returns its previous batch's state; half of each
batch is left out (its reads' chains dropped); an answer is altered where
it is produced (one SAM record a batch written one base off; every
primary written at mapping quality 60; in pairs, the proper-pair flag
cleared on every pair).  test_bench_reference.py holds the flag set on
pairs that are no FR pair against the check's rule."""
import copy
import time

import pytest
import torch

from benchmarks import harness

CELLS = ["grch38-map-ont.sam", "grch38-sr.pairs"]
# grch38-map-ont.sam waits outside BENCHMARK.json (PERF.md, Open
# questions); its files are kept, and tested here
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
BENCH["workloads"].append({"name": "grch38-map-ont.sam",
                           "config": "grch38-map-ont", "traffic": "ont-sam",
                           "chips": 1})


def small(name):
    _, _, cfg, trf = harness.cell_files(name, BENCH)
    cfg, trf = copy.deepcopy(cfg), copy.deepcopy(trf)
    cfg["genome"] = {"total": 3_000_000, "contigs": 8, "n_big": 6}
    if trf["driver"] == "sam":
        cfg["L"] = 512
        # QP past the longest read + 512: no capacity cut in split_extent
        cfg["align"] = {"QP": 1024, "TP": 1536, "W": 256, "sub": 8}
        trf["read_model"].update(min_len=300, max_len=450)
        trf.update(pool=32, batch=8)
    else:
        cfg["step"] = dict(cfg["step"], L=256)
        cfg["align"] = {"QP": 256, "TP": 768, "W": 256, "sub": 8}
        trf.update(pool=32, batch=8)
    trf.update(warm_batches=1, check_sample=32)
    # 300-450 bp reads on a 3 Mb genome with the envelope's repeat share
    # land in another copy more often than 8-11 kb reads on 3.1 Gb do
    trf["limits"]["off_truth_pct"] = 20.0
    # and a share of them at mapping quality 60: the mapq60 fault is read
    # at the cells' own sizes only (test_control_and_faults_on_the_card)
    trf["limits"]["mapq60_off_pct"] = 50.0
    return cfg, trf


def run(name, seconds=12.0, **kw):
    torch.set_num_threads(4)
    cfg, trf = small(name)
    res, checks = harness.run_cell(name, 20260, seconds, False,
                                   time.perf_counter(), device="cpu",
                                   bench=BENCH, config=cfg, traffic=trf, **kw)
    return res, {n: (v, lim) for n, v, lim in checks}


def correct(checks):
    return all(v is not None and v <= lim for v, lim in checks.values())


def stale(engine):
    fwd = engine.PafStep.forward
    last = []

    def forward(self, *a):
        out = fwd(self, *a)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return engine.PafStep, "forward", forward


def half(engine):
    fwd = engine.PafStep.forward

    def forward(self, *a):
        out = fwd(self, *a)
        stack = out[0] if isinstance(out, tuple) else out
        stack[0, :, stack.shape[2] // 2:] = 0      # chain scores
        return out
    return engine.PafStep, "forward", forward


def _sam_edit(engine, edit):
    """engine.fmt.write_sam with edit(n, fields) applied to each record."""
    sam = engine.fmt.write_sam
    n = [0]

    def write_sam(*a, **kw):
        f = sam(*a, **kw).split("\t")
        n[0] += 1
        edit(n[0], f)
        return "\t".join(f)
    return engine.fmt, "write_sam", write_sam


def altered(engine):
    def edit(n, f):
        if n % 8 == 1 and not int(f[1]) & 4:
            f[3] = str(int(f[3]) + 1)
    return _sam_edit(engine, edit)


def mapq60(engine):
    def edit(n, f):
        if not int(f[1]) & 0x904:
            f[4] = "60"
    return _sam_edit(engine, edit)


def never_proper(engine):
    def edit(n, f):
        f[1] = str(int(f[1]) & ~2)
    return _sam_edit(engine, edit)


@pytest.mark.parametrize("fault", [stale, half, altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    from minimap2_tpu_torch.parallel import engine
    obj, attr, fn = fault(engine)
    monkeypatch.setattr(obj, attr, fn)
    res, checks = run(name)
    assert not correct(checks), checks


def test_pairing_never_proper_is_not_correct(monkeypatch):
    from minimap2_tpu_torch.parallel import engine
    monkeypatch.setattr(*never_proper(engine))
    res, checks = run("grch38-sr.pairs")
    assert not correct(checks), checks


@pytest.mark.chip
@pytest.mark.parametrize("part", ["control", "half"])
@pytest.mark.parametrize("name", [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]])
def test_control_and_faults_on_the_card(name, part, cuda, monkeypatch):
    """At the cell's own size, on three seeds each.  control: the control
    (reference/align.linear_path's gap-open-free alignments in the
    program's place) fails score_gap; in the same runs every primary
    written at mapping quality 60 fails mapq60_off_pct and, in pairs, the
    proper-pair flag cleared fails unpaired_pct (each number reads only its
    own fault).  half: the half-batch fault fails off_truth_pct.  The
    readings go to standard output for the limits."""
    from minimap2_tpu_torch.parallel import engine
    if part == "control":
        monkeypatch.setattr(*mapq60(engine))
        if "pairs" in name:
            monkeypatch.setattr(*never_proper(engine))
        seeds, numbers = (71, 72, 73), ("score_gap", "mapq60_off_pct",
                                         "unpaired_pct")
    else:
        monkeypatch.setattr(*half(engine))
        seeds, numbers = (74, 75, 76), ("off_truth_pct",)
    for seed in seeds:
        _, checks = harness.run_cell(name, seed, 10.0, False,
                                     time.perf_counter(),
                                     control=part == "control")
        checks = {n: (v, lim) for n, v, lim in checks}
        print(f"{part} {name} seed {seed}: {checks}", flush=True)
        for n in numbers:
            if n in checks:
                assert checks[n][0] > checks[n][1], n
