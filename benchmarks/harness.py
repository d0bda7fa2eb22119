"""One run of one cell: set-up, warm-up, the measured window, the traced
reduction and the output check.

Everything is found by name: the cell in BENCHMARK.json, its
configuration in configs/<config>.json, its traffic mix in
traffic/<traffic>.json, the traffic's driver in drivers/<driver>.py, each
per-layer metric's reader in metrics/<metric>.py.  The program under test
is minimap2_tpu_torch; the JAX package is never imported.

Clients are threads of this one process, each streaming its own pool of
reads through the program's entry into its own sink, all over one
DeviceIndex built on the device at set-up.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import resource
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from . import genome, hostindex
from .reference.check import Judge
from .sink import Sink, WindowClosed

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "minimap2_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, bench=None):
    """(workload entry, configuration, traffic) of a cell, by name."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = load_json(HERE / "configs" / f"{wl['config']}.json")
    trf = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    return bench, wl, cfg, trf


def metric_reader(name: str):
    """The read(record) function of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (compared whole)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def applies(metric, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """What a driver reads: the configuration, the traffic, the device,
    the genome (until the build takes it), the index and the options."""

    def __init__(self, cfg, trf, device, tmp):
        self.config, self.traffic = cfg, trf
        self.device = torch.device(device)
        self.tmp = Path(tmp)
        self.parts = self.di = self.meta = self.mi = self.opt = None
        self.n_big = cfg["genome"].get("n_big", 24)


def options(cfg, mi):
    """The preset's mapping options, with -a, derived for the index as the
    CLI derives them."""
    from minimap2_tpu_torch import config as C
    io, mo = C.IndexOptions(), C.MapOptions()
    if C.set_opt(cfg["preset"], io, mo) < 0:
        raise ValueError(f"unknown preset {cfg['preset']}")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    io.k, io.w = cfg["index"]["k"], cfg["index"]["w"]
    if C.check_opt(io, mo) < 0:
        raise ValueError("the preset's options do not check")
    C.mapopt_update(mo, mi)
    return mo


def _cpu_s():
    """CPU seconds this process has used."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _client(run, sink, errors):
    try:
        with torch.no_grad():
            run(sink)
    except WindowClosed:
        pass
    except BaseException as e:      # reported by the main thread
        errors.append(e)
        sink.close()


def _sample(seed: int, client: int, pl, n: int):
    """Pool units whose primaries the score gap is read on: n drawn from
    the seed, and the unit with the longest read."""
    rng = np.random.default_rng([seed & (2**64 - 1), seed >> 64, 0x5A, client])
    units = len(pl["reads"])
    pick = set(rng.choice(units, min(n, units), replace=False).tolist())
    pick.add(int(np.argmax([max(len(r) for r in u) for u in pl["reads"]])))
    return pick


def run_cell(workload, seed, seconds, trace, t_start, device="cuda",
             bench=None, config=None, traffic=None, control=False,
             log=None):
    """Run the cell once; returns (result dict, [(name, value, limit)])."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench, wl, cfg, trf = cell_files(workload, bench)
    cfg, trf = config or cfg, traffic or trf
    drv = importlib.import_module(f"benchmarks.drivers.{trf['driver']}")
    from minimap2_tpu_torch.parallel import devbuild, engine
    dev = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        cell = Cell(cfg, trf, dev, tmp)
        stamps = [("start", t_start)]

        def stamp(what):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stamps.append((what, time.perf_counter()))
        stamp("imports")
        g = cfg["genome"]
        names, cell.parts = genome.make(seed, g["total"], g["contigs"], dev,
                                        cell.n_big)
        codes = [p.to("cpu", copy=True).numpy() for p in cell.parts]
        stamp("genome")
        pools = [drv.pool(cell, c, genome.generator(seed, 0x900 + c, dev))
                 for c in range(trf["clients"])]
        stamp("reads")
        ix = cfg["index"]
        parts, cell.parts = cell.parts, None
        cell.di, cell.meta = devbuild.build_device_index(
            names, parts, ix["w"], ix["k"], cap_frac=ix["cap_frac"],
            device=dev, consume=True)
        del parts
        stamp("index")
        index_build_s = sum(v for k, v in cell.meta.stage_s.items()
                            if k != "total")
        cell.mi, host_tables_s = hostindex.host_index(cell.di, cell.meta,
                                                      codes)
        del codes
        stamp("host tables")
        cell.opt = options(cfg, cell.mi)
        runners = [drv.client(cell, pl) for pl in pools]
        stamp("clients")
        sinks = [Sink(pl["names"], trf["batch"]) for pl in pools]
        log("[bench] set-up s: " + ", ".join(
            f"{w} {b - a:.2f}" for (_, a), (w, b) in zip(stamps, stamps[1:]))
            + f" (build stages {index_build_s:.2f}, host_tables "
            f"{host_tables_s:.2f}, mid_occ "
            f"{cell.opt.mid_occ})")
        tracer = None
        if trace:
            from .trace import Tracer
            tracer = Tracer()
            tracer.install()
        # the set-up's objects are never freed in the window: keep them out
        # of the collector's passes
        gc.collect()
        gc.freeze()
        errors = []
        threads = [threading.Thread(target=_client, args=(r, s, errors),
                                    daemon=True)
                   for r, s in zip(runners, sinks)]
        for th in threads:
            th.start()
        warm = trf["warm_batches"] * trf["batch"]
        while min(len(s.times) for s in sinks) < warm and not errors:
            time.sleep(0.05)
        if errors:
            raise errors[0]
        stamp("warm-up")
        log(f"[bench] warm-up {stamps[-1][1] - stamps[-2][1]:.2f} s")
        if tracer:
            tracer.start()
        # each client's window runs from its first batch after the
        # warm-up to its first batch at least ``seconds`` later, so it
        # holds whole batches
        tw = time.perf_counter()
        cpu_a = _cpu_s()
        for s in sinks:
            s.keep_from = tw
        host0 = engine.host_path["reads"]
        t0s = [None] * len(sinks)
        t1s = [None] * len(sinks)
        while not errors and None in t1s:
            time.sleep(0.05)
            if time.perf_counter() > tw + seconds + 600:
                raise RuntimeError("no batch came for ten minutes")
            for c, s in enumerate(sinks):
                t0s[c] = s.t0
                if t0s[c] is not None and t1s[c] is None:
                    t1s[c] = s.start_at(t0s[c] + seconds)
        if errors:
            raise errors[0]
        host1 = engine.host_path["reads"]
        cpu_b, tb = _cpu_s(), time.perf_counter()
        t0, t1 = min(t0s), max(t1s)
        record = None
        if tracer:
            tracer.end_window()
        # the clients stop before the profiler does, so its parse of the
        # trace neither records nor shares the interpreter with them
        for s in sinks:
            s.close()
        for th in threads:
            th.join(timeout=600)
        if tracer:
            t = time.perf_counter()
            tracer.stop()
            log(f"[bench] profiler stop {time.perf_counter() - t:.1f} s")
        if errors:
            raise errors[0]
        if any(th.is_alive() for th in threads):
            raise RuntimeError("a client did not stop")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak = int(torch.cuda.max_memory_allocated(dev))
        else:
            peak = 0
        units, kept = zip(*(s.in_window(a, b)
                            for s, a, b in zip(sinks, t0s, t1s)))
        n_reads = sum(units) * drv.UNIT_READS
        rate = sum(u * drv.UNIT_READS / (b - a)
                   for u, a, b in zip(units, t0s, t1s))
        if tracer:
            from .trace import reduce
            tracer.remove()
            t = time.perf_counter()
            record = reduce(tracer, t0, t1)
            log(f"[bench] trace reduced {time.perf_counter() - t:.1f} s")
            record.update(index_build_s=index_build_s,
                          host_tables_s=host_tables_s, reads=n_reads,
                          host_path_reads=host1 - host0)
        setup_s = t0 - t_start
        per = np.diff([x for s in sinks[:1] for x in s.starts
                       if t0s[0] <= x <= t1s[0]])
        if len(per):
            log(f"[bench] batch periods s: min {per.min():.3f} median "
                f"{np.median(per):.3f} max {per.max():.3f}")
        log(f"[bench] this process's CPU in the window: "
            f"{(cpu_b - cpu_a) / (tb - tw):.2f} cores")
        log(f"[bench] window {t1 - t0:.2f} s: {n_reads} reads "
            f"({rate:.1f} reads/s), {host1 - host0} on the host path; "
            f"set-up {setup_s:.1f} s; peak {peak / 1e9:.2f} GB")
        # the program's state goes before the reference runs
        del runners, threads
        cell.di = cell.mi = cell.meta = None
        gc.unfreeze()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        checks, n_bad = check(cfg, trf, seed, dev, names, pools, sinks,
                              kept, drv, control, log)
        log(f"[bench] output check {time.perf_counter() - t:.1f} s")
    result = dict(e2e={"reads_per_s": rate, "setup_s": setup_s},
                  record=record, peak=peak, reads=n_reads, failed=n_bad)
    return result, checks


def check(cfg, trf, seed, dev, names, pools, sinks, kept, drv, control,
          log):
    """[(number, value, limit)] of the output check (reference/check.py)
    and the count of units found wrong."""
    g = cfg["genome"]
    t = time.perf_counter()
    _, parts = genome.make(seed, g["total"], g["contigs"], dev,
                           cfg["genome"].get("n_big", 24))
    host = {nm: p.cpu().numpy() for nm, p in zip(names, parts)}
    del parts
    log(f"[bench] check: genome again {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    judge = Judge(host, cfg["scoring"], cfg.get("pairing"))
    off = mates = n_units = n_segs = 0
    for c, (pl, kp) in enumerate(zip(pools, kept)):
        pick = _sample(seed, c, pl, trf["check_sample"])
        for i, recs in kp:
            o, mt = judge.unit(recs, pl["reads"][i], pl["truths"][i],
                               i in pick)
            pick.discard(i)
            off += o
            mates += mt
            n_units += 1
            n_segs += len(pl["reads"][i])
    log(f"[bench] check: {n_units} units judged {time.perf_counter() - t:.1f}"
        f" s")
    t = time.perf_counter()
    gap = judge.score_gap(dev, control=control)
    log(f"[bench] check: score gap of {len(judge.gap_jobs)} primaries "
        f"{time.perf_counter() - t:.1f} s")
    for name, why in judge.bad[:5]:
        log(f"[bench] bad record {name}: {why}")
    missing = sum(s.missing for s in sinks)
    lim = trf["limits"]
    out = [("missing", missing, 0), ("bad_records", len(judge.bad), 0)]
    if drv.UNIT_READS == 2:
        out.append(("bad_mates", mates, 0))
    n = judge.n
    out += [("off_truth_pct", 100.0 * off / max(n_segs, 1),
             lim["off_truth_pct"]),
            ("mapq60_off_pct", 100.0 * n["q60_off"] / max(n["q60"], 1),
             lim["mapq60_off_pct"])]
    if drv.UNIT_READS == 2:
        out.append(("unpaired_pct",
                    100.0 * n["unpaired"] / max(n["pairs_on"], 1),
                    lim["unpaired_pct"]))
    out.append(("score_gap", gap, lim["score_gap"]))
    if n_units == 0:
        out.append(("no_units_checked", 1, 0))
    return out, missing + len(judge.bad) + mates
