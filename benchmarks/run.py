"""The benchmark of minimap2_tpu_torch: one cell, one run.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 breakdown, and
last the output check's numbers beside their limits, which also end
standard error.  Exits non-zero, printing no result, without enough CUDA
devices, when the JAX stack or the JAX package was loaded, or on any
failure."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# One host thread for the numeric libraries: the program's host work is
# one Python thread, and a pool of spinning workers beside it on a shared
# host makes its speed swing from run to run.
HOST_THREADS = 1
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = str(HOST_THREADS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch
    torch.set_num_threads(HOST_THREADS)
    from benchmarks import harness
    bench, wl, _, _ = harness.cell_files(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(a.workload, a.seed, a.seconds,
                                      bool(a.trace), T_START, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules of the JAX stack or package: {found}",
              file=sys.stderr)
        return 3
    ok = all(v is not None and v <= lim for _, v, lim in checks)
    metrics = {}
    if a.trace:
        rec = result["record"]
        for m in bench["per_layer"]:
            if harness.applies(m, a.workload):
                v = harness.metric_reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if harness.applies(m, a.workload):
                metrics[m["name"]] = {"value": result["e2e"][m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": wl["chips"], "memory_peak_bytes": result["peak"]}
    out = {"correct": ok, "attempted": result["reads"],
           "failed": result["failed"], "metrics": metrics, "device": device}
    if a.trace:
        device["busy_s"] = result["record"]["busy_s"]
        device["window_s"] = result["record"]["window_s"]
        out["breakdown"] = result["record"]["breakdown"]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
