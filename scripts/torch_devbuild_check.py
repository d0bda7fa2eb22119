#!/usr/bin/env python3
"""Short check of the port's device index build on one GPU.

    python3 scripts/torch_devbuild_check.py [--small-mb 4] [--grch38]

Builds the CUDA kernels; holds the sketch kernel's five planes (the
validity plane included) bit-equal to its plain version on an 8192 x 8192
chunk of build rows, and times both; generates a small genome with
utils/simgenome_dev on the card and on the CPU (equal bytes required) and
indexes it on both (every table of the two DeviceIndexes equal, with the
stage seconds of each); with --grch38 also runs chip_smoke.py's GRCh38
phase (the 3.1 Gb envelope generated, indexed and 1024 reads mapped on
the card, with its gates).  Prints the card's name and power limit first.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small-mb", type=float, default=4)
    ap.add_argument("--grch38", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from minimap2_tpu_torch.ops import sketch
    from minimap2_tpu_torch.parallel import devbuild
    from minimap2_tpu_torch.utils import simgenome_dev as sgd
    cs.phase_build()

    total = int(a.small_mb * 1e6)
    t = time.time()
    names, parts = sgd.simulate_genome_device(total, 8, 7, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.time() - t
    cpu = sgd.simulate_genome_device(total, 8, 7, device="cpu")[1]
    cs.require(all(torch.equal(p.cpu(), c) for p, c in zip(parts, cpu)),
               "the genome made on the card differs from the CPU's")
    print(f"[check] {total} bp genome on the card in {gen_s:.2f}s, equal "
          "to the CPU's", flush=True)
    di, meta, info = cs._build_on_card("small", names, list(parts), 10, 15)
    dc, mc = devbuild.build_device_index(names, cpu, 10, 15, device="cpu")
    for n in di.LEAVES:
        x, y = getattr(di, n), getattr(dc, n)
        cs.require((x is None) == (y is None)
                   and (x is None or torch.equal(x.cpu(), y)),
                   f"table {n} differs between card and CPU builds")
    cs.require(di.aux_dict() == dc.aux_dict()
               and (meta.n_mini, meta.n_distinct, meta.mid_occ)
               == (mc.n_mini, mc.n_distinct, mc.mid_occ),
               "aux or counts differ between card and CPU builds")
    print(f"[check] card and CPU builds equal; CPU stages "
          f"{ {n: round(v, 3) for n, v in mc.stage_s.items()} }", flush=True)

    # the sketch with the validity plane at the build's chunk shape
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = torch.randint(0, 4, (8192, 8192), dtype=torch.uint8,
                         device="cuda", generator=g)
    rows[:, :32] = 5                    # separator runs, as the build has
    rows[::7, 4000:4010] = 4            # and N runs
    lens = torch.full((8192,), 8192, dtype=torch.int32, device="cuda")
    args = (rows.contiguous(), lens, 15, 10)
    err = cs.max_abs_err(sketch.sketch_batch(*args, with_valid=True),
                         sketch.device_sketch(*args, with_valid=True))
    cs.require(err == 0, f"sketch (five planes) differs ({err})")
    ms = cs.cuda_ms(lambda: sketch.sketch_batch(*args, with_valid=True))
    ms4 = cs.cuda_ms(lambda: sketch.sketch_batch(*args))
    plain = cs.cuda_ms(lambda: sketch.device_sketch(*args, with_valid=True),
                       reps=2, warmup=1)
    bms, by = cs.bound(8192 * 8192 * 12 + 8192 * 4,
                       8192 * 8192 * (8 * 15 + 40 + 7 * 10))
    print(f"[check] sketch 8192 x 8192 k15 w10: bit-equal (5 planes); "
          f"{ms:.4f} ms with valid, {ms4:.4f} ms without, plain "
          f"{plain:.1f} ms, bound {bms:.4f} ms ({by})", flush=True)
    del parts, cpu, di, dc, rows, args
    torch.cuda.empty_cache()
    if a.grch38:
        with tempfile.TemporaryDirectory() as tmp:
            t = time.time()
            g = cs.phase_grch38(tmp)
            print(f"[check] GRCh38 phase {time.time() - t:.1f}s: "
                  f"{g['map']['reads_per_s']:.1f} reads/s, stages "
                  f"{g['stages']}, peak {g['peak_gb']:.2f} GB", flush=True)


if __name__ == "__main__":
    main()
