"""BENCHMARK.json resolves to its files by name, keeps the contract's
shapes, and nothing a run or the reference loads is the JAX stack or the
JAX package (top-level names compared whole)."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(wl):
    from benchmarks import harness
    _, w, cfg, trf = harness.cell_files(wl["name"])
    assert any(c["name"] == wl["config"] for c in BENCH["configs"])
    drv = __import__(f"benchmarks.drivers.{trf['driver']}",
                     fromlist=["UNIT_READS"])
    assert trf["pool"] % trf["batch"] == 0
    assert set(trf["limits"]) == {"off_truth_pct", "mapq60_off_pct",
                                  "score_gap"} | (
        {"unpaired_pct"} if drv.UNIT_READS == 2 else set())
    for k in ("preset", "genome", "index", "scoring", "align"):
        assert k in cfg
    assert w["chips"] == 1


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_resolves(m):
    from benchmarks import harness
    assert callable(harness.metric_reader(m["name"]))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= cells


def test_names_units_and_files():
    items = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for x in items:
        assert NAME.match(x["name"]), x["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    assert {"setup_s", "reads_per_s"} <= {m["name"]
                                          for m in BENCH["end_to_end"]}


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    mods = _loaded(
        "import sys; sys.argv = ['x']; sys.path.insert(0, '.');"
        "import benchmarks.run, benchmarks.harness, benchmarks.trace;"
        "import benchmarks.drivers.sam, benchmarks.drivers.pairs;"
        "from minimap2_tpu_torch.parallel import engine, devbuild, "
        "align_batch;"
        "print(' '.join(m.split('.')[0] for m in sys.modules))")
    assert not mods & {"jax", "jaxlib", "flax", "minimap2_tpu"}
    assert "minimap2_tpu_torch" in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded(
        "import sys; sys.path.insert(0, '.');"
        "import benchmarks.reference.check, benchmarks.reference.align;"
        "print(' '.join(m.split('.')[0] for m in sys.modules))")
    assert not mods & {"jax", "jaxlib", "flax", "minimap2_tpu",
                       "minimap2_tpu_torch"}
