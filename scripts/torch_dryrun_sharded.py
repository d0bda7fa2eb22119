#!/usr/bin/env python3
"""Dry run of the port's sharded mapping step over torch.distributed (the
counterpart of scripts/dryrun_twohost.py and the JAX package's
__graft_entry__.dryrun_multichip).

    python3 scripts/torch_dryrun_sharded.py [--device cpu|cuda]
                                            [--timeout SECONDS]

For each (n_data, n_idx) of (1, 1), (1, 2), (2, 1) and (2, 2) it spawns
n_data * n_idx ranks (one process each, joined through a ``file://``
store in a temporary directory); each rank loads its index shard from an
.npz cache written by ``DeviceIndex.from_host(mi, n_shards=n_idx)`` and
runs one sharded step on its data slice.  The gathered output is held
against the one-shard ``map_batch`` on two worlds: a 20 kb genome with 4
reads, then a skewed one (40 copies of a 300 bp element) with 64.
It prints each configuration's per-idx anchor counts, their max/mean
balance and whether it is equal.  Ranks on CUDA share the card(s) as
``cuda:(rank % device_count)``; ranks that share one GPU use gloo.  A rank
that outlives ``--timeout`` is killed, and the run fails.

The ranks and their worlds come from ``minimap2_tpu_torch.parallel.ranks``
(``spawn_ranks``, ``build_tiny``).
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from minimap2_tpu_torch.parallel.ranks import (  # noqa: E402
    build_tiny, load_result, spawn_ranks, write_run)


def one_shard(mi, p, codes, lens, device):
    """map_batch on the one-shard index: the reference of every config."""
    import torch

    from minimap2_tpu_torch.parallel.batch import DeviceIndex, map_batch
    di = DeviceIndex.from_host(mi, device)
    with torch.no_grad():
        ref = map_batch(di, torch.from_numpy(codes).to(di.device),
                        torch.from_numpy(lens).to(di.device), p)
    return {k: v.cpu().numpy() for k, v in ref.items()}


def dryrun(device: str, timeout: float) -> bool:
    from minimap2_tpu_torch.parallel.sharded import OUT_FIELDS
    if device == "cuda":        # built once here, loaded by the ranks
        from minimap2_tpu_torch.ops import _build
        _build.lib()
    with tempfile.TemporaryDirectory() as tmp:
        cfgs = [(1, 1), (1, 2), (2, 1), (2, 2)]
        mi, p, codes, lens = build_tiny(B=4)
        mi2, p2, codes2, lens2 = build_tiny(B=64, seed=13, skew=True)
        refs = [one_shard(mi, p, codes, lens, device),
                one_shard(mi2, p2, codes2, lens2, device)]
        rows = []
        for nd, ni in cfgs:
            runs = [write_run(tmp, "tiny", mi, p, codes, lens, ni),
                    write_run(tmp, "skew", mi2, p2, codes2, lens2, ni)]
            job = dict(n_data=nd, n_idx=ni, device=device, runs=runs,
                       out=os.path.join(tmp, f"job{nd}x{ni}"))
            t = time.time()
            reports = spawn_ranks(job, timeout)
            wall = time.time() - t
            eq = True
            for j, ref in enumerate(refs):
                got = load_result(job, j)
                eq &= all(np.array_equal(got[f], ref[f]) for f in OUT_FIELDS)
                eq &= got["n_mapped"] == int(ref["mapped"].sum())
            got = load_result(job, 1)
            per_idx = got["n_anc"].sum(axis=0).astype(np.float64)
            bal = float(per_idx.max() / max(1.0, per_idx.mean()))
            step_s = max(r["runs"][1]["seconds"][-1] for r in reports)
            rows.append((nd, ni, eq, bal, step_s, wall))
            print(f"[dryrun] data={nd} idx={ni}: skewed world per-idx "
                  f"anchors {per_idx.astype(int).tolist()}, "
                  f"max/mean {bal:.2f}, n_anc {got['n_anc'].tolist()}",
                  flush=True)
        print("[dryrun] (n_data, n_idx, equal, idx balance, step s of the "
              "slowest rank, spawn s):")
        for r in rows:
            print(f"[dryrun]   data={r[0]} idx={r[1]} equal={r[2]} "
                  f"balance={r[3]:.2f} step_s={r[4]:.3f} spawn_s="
                  f"{r[5]:.1f}")
        return all(r[2] for r in rows)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--timeout", type=float, default=300.0)
    a = ap.parse_args(argv)
    return 0 if dryrun(a.device, a.timeout) else 1


if __name__ == "__main__":
    sys.exit(main())
