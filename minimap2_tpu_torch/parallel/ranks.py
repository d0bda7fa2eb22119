"""The sharded step's ranks as processes: ``spawn_ranks`` starts one
process a rank of a job, each running ``worker``, and ``load_result``
reads the gathered output rank 0 wrote.  A job is a dict of n_data,
n_idx, device, out (a directory) and runs: each run an index cache written
by ``DeviceIndex.from_host(mi, n_shards=n_idx)``, an .npz of reads and
BatchParams (``write_run``).  The ranks join through a ``file://`` store in
the job's directory; a rank that outlives the timeout is killed.
``build_tiny`` makes the small worlds the dry run and the tests map.

    python3 -m minimap2_tpu_torch.parallel.ranks JOB RANK

runs one rank of the job file JOB.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..index.index import MiniIndex
from ..ops import _build
from ..ops._build import launches
from . import sharded
from .batch import BatchParams, DeviceIndex

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_ref(rng, ref_len, skew: bool):
    """A random genome; with skew, 40 copies of one 300 bp element, whose
    keys fall in a narrow key range, hence one shard."""
    ref = rng.integers(0, 4, ref_len, dtype=np.uint8)
    if skew:
        elem = rng.integers(0, 4, 300, dtype=np.uint8)
        for _ in range(40):
            st = int(rng.integers(0, ref_len - 300))
            ref[st:st + 300] = elem
    return ref


def build_tiny(L=512, B=8, ref_len=20000, seed=7, skew=False):
    """The JAX package's __graft_entry__._build_tiny in the port: the same
    genome and reads from the same seed -> (mi, p, codes, lens)."""
    rng = np.random.default_rng(seed)
    ref = make_ref(rng, ref_len, skew)
    mi = MiniIndex.build_codes(["chr1"], [ref], w=10, k=15)
    p = BatchParams(L=L, M=128, A=256, QP=512, TP=512, W=256, ext_w=200,
                    chain_window=32)
    codes = np.full((B, p.L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        st = int(rng.integers(0, ref_len - 600))
        ln = int(rng.integers(300, L))
        seq = ref[st:st + ln].copy()
        mut = rng.random(ln) < 0.05
        seq[mut] = rng.integers(0, 4, int(mut.sum()))
        if i % 2:
            seq = (3 - seq)[::-1].copy()
        codes[i, :ln] = seq
        lens[i] = ln
    return mi, p, codes, lens


def write_run(tmp, tag, mi, p, codes, lens, n_idx):
    """The files of one run: the n_idx-shard cache (built here) and the
    reads; returns the run's JSON entry."""
    cache = os.path.join(tmp, f"{tag}.idx{n_idx}.npz")
    if not os.path.exists(cache):
        DeviceIndex.from_host(mi, "cpu", n_shards=n_idx, cache=cache)
    reads = os.path.join(tmp, f"{tag}.reads.npz")
    np.savez(reads, codes=codes, lens=lens)
    return dict(tag=tag, cache=cache, reads=reads,
                params=dataclasses.asdict(p))


def spawn_ranks(job: dict, timeout: float = 300.0) -> list:
    """Run ``worker`` as ranks 0..n_data * n_idx - 1 of one job (a dict
    with n_data, n_idx, device, runs, out) and return each rank's report
    (its JSON).  A rank that fails fails the call; past ``timeout``
    seconds every rank still running is killed."""
    world = job["n_data"] * job["n_idx"]
    os.makedirs(job["out"], exist_ok=True)
    path = os.path.join(job["out"], "job.json")
    init = os.path.join(job["out"], "pg_init")
    if os.path.exists(init):
        os.remove(init)
    with open(path, "w") as f:
        json.dump(dict(job, init="file://" + init), f)
    penv = dict(os.environ)
    penv["PYTHONPATH"] = ROOT + os.pathsep + penv.get("PYTHONPATH", "")
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(job["out"], f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", __name__, path, str(r)], stdout=log, stderr=subprocess.STDOUT, env=penv))
    deadline = time.time() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.time() > deadline:
                failed = f"timed out after {timeout:.0f}s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or bad:
        tails = []
        for r in range(world):
            with open(os.path.join(job["out"], f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} (rc {procs[r].returncode}):\n"
                             + f.read()[-3000:])
        raise RuntimeError(f"sharded ranks failed ({failed or bad}):\n"
                           + "\n".join(tails))
    reports = []
    for r in range(world):
        with open(os.path.join(job["out"], f"rank{r}.log")) as f:
            for ln in f:
                if ln.startswith("[sharded]"):     # each rank's backend
                    print(ln.rstrip(), flush=True)
        with open(os.path.join(job["out"], f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def load_result(job: dict, j: int) -> dict:
    """Run j's gathered output, written by rank 0: the planes of
    sharded.OUT_FIELDS, n_mapped and the (n_data, n_idx) n_anc."""
    with np.load(os.path.join(job["out"], f"run{j}.npz")) as z:
        return {k: z[k] for k in z.files}


def worker(job_path: str, rank: int) -> None:
    """One rank: join the group, then for each run load this rank's index
    shard and data slice, run the sharded step (``repeat`` times; the
    output of the last is gathered) and report launches, seconds,
    collective seconds and peak device memory."""
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(int(job.get("threads", 1)))
    n_data, n_idx = job["n_data"], job["n_idx"]
    world = n_data * n_idx
    dev = sharded.init_rank(rank, world, job["init"], job["device"])
    cuda = dev.type == "cuda"
    if cuda:
        _build.lib()
    report = {"rank": rank, "device": str(dev), "runs": []}
    for j, run in enumerate(job["runs"]):
        t = time.time()
        di = DeviceIndex._load_cache(run["cache"], dev, n_idx,
                                     shard=rank % n_idx)
        with np.load(run["reads"]) as z:
            codes, lens = z["codes"], z["lens"]
        p = BatchParams(**run["params"])
        step = sharded.make_sharded_step(p, n_data, n_idx)
        c_t = step.local(torch.from_numpy(codes)).to(dev)
        l_t = step.local(torch.from_numpy(lens)).to(dev)
        load_s = time.time() - t
        merged = []
        if run.get("dump_merge") and rank == 0:
            merge = sharded.merge_anchors

            def capture(parts, A, **kw):
                if not merged:
                    merged.append([x.cpu().numpy() for x in parts])
                return merge(parts, A, **kw)
            sharded.merge_anchors = capture
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        secs, counts, coll = [], [], []
        for _ in range(run.get("repeat", 1)):
            launches.clear()
            step.coll_s = 0.0
            t = time.time()
            with torch.no_grad():
                out, n_mapped, n_anc = step(di, c_t, l_t)
            if cuda:
                torch.cuda.synchronize(dev)
            secs.append(time.time() - t)
            counts.append(dict(launches))
            coll.append(step.coll_s)
        if merged:
            sharded.merge_anchors = merge
            np.savez(os.path.join(job["out"], f"merge{j}.npz"),
                     **{f"s{i}_k{q}": part[q] for i, part in
                        enumerate(merged[0]) for q in range(3)})
        full, n_anc_all = step.gather_sharded(out, n_anc)
        if rank == 0:
            np.savez(os.path.join(job["out"], f"run{j}.npz"),
                     n_mapped=int(n_mapped), n_anc=n_anc_all.cpu().numpy(),
                     **{k: v.cpu().numpy() for k, v in full.items()})
        report["runs"].append(dict(
            tag=run.get("tag"), load_s=load_s, seconds=secs,
            launches=counts, coll_s=coll, reads=int(c_t.shape[0]),
            n_mapped=int(n_mapped), n_anc_local=int(n_anc),
            peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                     if cuda else None)))
        del di
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]))
