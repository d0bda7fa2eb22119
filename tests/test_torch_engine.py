"""Port engine and CLI vs the JAX package:

(a) PafStep's (10, K, B) records equal make_paf_step(interpret=False)'s,
    the on-chip dispatch with every Pallas kernel in interpret mode
    (chain kernel route: B % 128 == 0, A % 256 == 0, long-join pass on),
    also with secondaries and waypoints (the -c/-a path's step);
(b) run_batched_cli's PAF is byte-identical to the JAX engine's;
(c) cli.main parses options and reads side data (--junc-bed, --alt) as
    the JAX CLI does (the debug output: tests/test_torch_debug_output.py);
(d) a read longer than L takes the host path and gives the JAX package's
    PAF;
(e) the device occurrence cap reads MM2TPU_OCC_CAP as the JAX package does;
(f) PafStep at bench.py's off-distribution widths (L 32768) on CLR-like
    reads equals the JAX step.
"""
import functools
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minimap2_tpu.cli as jax_cli
import minimap2_tpu.parallel.engine as jax_engine
import minimap2_tpu.config as jax_config
from minimap2_tpu.config import IndexOptions, MapOptions, mapopt_update, \
    set_opt
from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.ops import chain_pallas, sketch_pallas, sort_pallas
from minimap2_tpu.parallel.batch import BatchParams as JaxBatchParams
from minimap2_tpu.parallel.batch import DeviceIndex as JaxDeviceIndex
import minimap2_tpu_torch
import minimap2_tpu_torch.cli as port_cli
import minimap2_tpu_torch.config as port_config
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.parallel import engine
from minimap2_tpu_torch.parallel.batch import BatchParams, DeviceIndex

jax.config.update("jax_platforms", "cpu")

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _kernel_world(B=128):
    """200 kb genome with a repeat family; B reads of 300-1000 bp with
    5% substitutions, half reverse-complemented, every 8th carrying a
    2 kb deletion (a long-join candidate)."""
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 200_000).astype(np.uint8)
    fam = rng.integers(0, 4, 500).astype(np.uint8)
    for st in rng.integers(0, 199_000, 12):
        g[st:st + 500] = fam
    reads = []
    for i in range(B):
        n = int(rng.integers(300, 1000))
        st = int(rng.integers(0, len(g) - n - 2500))
        r = g[st:st + n].copy() if i % 8 else \
            np.concatenate([g[st:st + n // 2], g[st + n // 2 + 2000:
                                                 st + n + 2000]])
        m = rng.random(len(r)) < 0.05
        r[m] = rng.integers(0, 4, int(m.sum()))
        if i % 2:
            r = (3 - r)[::-1]
        reads.append(ACGT[r].tobytes())
    return g, reads


def test_paf_step_records_match_jax_kernel_route(monkeypatch):
    g, reads = _kernel_world()
    shape = dict(k=15, w=10, L=1024, M=256, A=256, occ_cap=16,
                 chain_window=64, bw=500, bw_long=20000)
    jmi = JaxMiniIndex.build_codes(["g"], [g], w=10, k=15)
    jdi = JaxDeviceIndex.from_host(jmi, 1)[0]
    sk, s3, ch = (sketch_pallas.sketch_batch, sort_pallas.sort3_rows,
                  chain_pallas.chain_batch)
    monkeypatch.setattr(sketch_pallas, "sketch_batch",
                        functools.partial(sk, interpret=True))
    monkeypatch.setattr(sort_pallas, "sort3_rows",
                        lambda a, b, c, G=8, interpret=False:
                        s3(a, b, c, G=G, interpret=True))
    monkeypatch.setattr(chain_pallas, "chain_batch",
                        functools.partial(ch, interpret=True))
    jstep = jax_engine.make_paf_step(jdi, JaxBatchParams(**shape), K=5,
                                     min_sc=40, interpret=False)
    codes, lens = engine.encode_batch(reads, 1024)
    packed, nbits = engine.pack_codes(codes)
    want = np.asarray(jstep(jnp.asarray(packed), jnp.asarray(nbits),
                            jnp.asarray(lens)))
    di = DeviceIndex.from_host(MiniIndex.build_codes(["g"], [g], w=10, k=15),
                               "cpu")
    step = engine.PafStep(di, BatchParams(**shape), K=5, min_sc=40)
    got = step(torch.from_numpy(packed), torch.from_numpy(nbits),
               torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (10, 5, 128)
    np.testing.assert_array_equal(got, want)
    assert (want[0, 0] > 100).sum() > 100           # the reads do map


def test_paf_step_sec_wp_match_jax_kernel_route(monkeypatch):
    """PafStep(with_sec, with_wp) == make_paf_step(with_sec, with_wp) on
    the on-chip route (chain kernel: B % 128 == 0, A % 256 == 0; Pallas
    kernels in interpret mode), long-join pass on."""
    g, reads = _kernel_world()
    shape = dict(k=15, w=10, L=1024, M=256, A=256, occ_cap=16,
                 chain_window=64, bw=500, bw_long=20000)
    sk, s3, ch = (sketch_pallas.sketch_batch, sort_pallas.sort3_rows,
                  chain_pallas.chain_batch)
    monkeypatch.setattr(sketch_pallas, "sketch_batch",
                        functools.partial(sk, interpret=True))
    monkeypatch.setattr(sort_pallas, "sort3_rows",
                        lambda a, b, c, G=8, interpret=False:
                        s3(a, b, c, G=G, interpret=True))
    monkeypatch.setattr(chain_pallas, "chain_batch",
                        functools.partial(ch, interpret=True))
    jdi = JaxDeviceIndex.from_host(
        JaxMiniIndex.build_codes(["g"], [g], w=10, k=15), 1)[0]
    jstep = jax_engine.make_paf_step(jdi, JaxBatchParams(**shape), K=3,
                                     min_sc=40, interpret=False,
                                     with_sec=True, with_wp=True)
    codes, lens = engine.encode_batch(reads, 1024)
    packed, nbits = engine.pack_codes(codes)
    want = [np.asarray(x) for x in jstep(jnp.asarray(packed),
                                         jnp.asarray(nbits),
                                         jnp.asarray(lens))]
    di = DeviceIndex.from_host(
        MiniIndex.build_codes(["g"], [g], w=10, k=15), "cpu")
    step = engine.PafStep(di, BatchParams(**shape), K=3, min_sc=40,
                          with_sec=True, with_wp=True)
    got = step(*(torch.from_numpy(x) for x in (packed, nbits, lens)))
    assert got[0].shape == (10, 6, 128) and got[1].shape == (2, 128, 64)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), w_)
    assert (want[0][0, 1] > 0).sum() >= 3            # secondaries found
    assert (want[1][0] >= 0).sum(1).min() > 1        # waypoints per read


def _clr_reads(g, n, rng):
    """pbsim-CLR-shaped reads from g (bench.py's off-distribution gate,
    scaled down): 12-30 kb, 5% errors (sub:ins:del 10:60:30), every
    fourth with a 1-10 kb internal deletion, half reverse-complemented."""
    reads = []
    for i in range(n):
        ln = int(rng.integers(12000, 30000))
        st = int(rng.integers(0, len(g) - ln - 10000))
        r = g[st:st + ln]
        if i % 4 == 1:
            cut = int(rng.integers(1000, 10000))
            r = np.concatenate([r[:ln // 2], g[st + ln // 2 + cut:st + ln + cut]])
        ev = rng.random(len(r))
        sub, ins, dele = ev < 0.005, (ev >= 0.005) & (ev < 0.035), ev >= 0.985
        r = np.where(sub, (r + rng.integers(1, 4, len(r))) % 4, r)
        r = np.concatenate([np.repeat(r[~dele], 1 + ins[~dele])])
        if i % 2:
            r = (3 - r)[::-1]
        reads.append(ACGT[r.astype(np.uint8)].tobytes())
    return reads


def test_paf_step_at_l32768_matches_jax(monkeypatch):
    """PafStep at bench.py's off-distribution widths (L 32768, M 4096, A
    8192, window 64, bw_long 0, K 5, min_sc 40; bench.py:108-118,
    :481-483) on 8 CLR-like reads of 12-30 kb: the compaction past 16384
    lanes (sort1 + gather; JAX's lax.sort at B % 8 == 0), the sketch at
    32768 lanes and the anchor sort at 8192, records equal to
    make_paf_step(interpret=False)'s with the Pallas sketch in interpret
    mode (8 reads: the chain scan route in both)."""
    rng = np.random.default_rng(15)
    g = rng.integers(0, 4, 400_000).astype(np.uint8)
    fam = rng.integers(0, 4, 800).astype(np.uint8)
    for st in rng.integers(0, 399_000, 20):
        g[st:st + 800] = fam
    reads = _clr_reads(g, 8, rng)
    jmi = JaxMiniIndex.build_codes(["g"], [g], w=10, k=15)
    mid_occ = jmi.cal_max_occ(2e-4)
    shape = dict(k=15, w=10, L=32768, M=4096, A=8192,
                 occ_cap=min(max(mid_occ, 10), 64), chain_window=64,
                 bw_long=0)
    monkeypatch.setattr(sketch_pallas, "sketch_batch", functools.partial(
        sketch_pallas.sketch_batch, interpret=True))
    jstep = jax_engine.make_paf_step(JaxDeviceIndex.from_host(jmi, 1)[0],
                                     JaxBatchParams(**shape), K=5,
                                     min_sc=40, interpret=False)
    codes, lens = engine.encode_batch(reads, 32768)
    packed, nbits = engine.pack_codes(codes)
    want = np.asarray(jstep(jnp.asarray(packed), jnp.asarray(nbits),
                            jnp.asarray(lens)))
    di = DeviceIndex.from_host(MiniIndex.build_codes(["g"], [g], w=10, k=15),
                               "cpu")
    step = engine.PafStep(di, BatchParams(**shape), K=5, min_sc=40)
    got = step(*(torch.from_numpy(x) for x in (packed, nbits, lens)))
    assert got.shape == want.shape == (10, 5, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, 0] > 1000).all()                # every read maps


@pytest.fixture(scope="module")
def conc_world(tmp_path_factory):
    """The world of tests/test_concurrency.py."""
    tmp = tmp_path_factory.mktemp("torch_conc")
    rng = np.random.default_rng(5)
    ref = "".join(rng.choice(list("ACGT"), 60000))
    reads = tmp / "reads.fa"
    with open(reads, "w") as f:
        for i in range(48):
            st = int(rng.integers(0, len(ref) - 400))
            seq = ref[st:st + 400]
            if i % 3 == 0:
                comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
                seq = "".join(comp[c] for c in reversed(seq))
            f.write(f">q{i}\n{seq}\n")
    refpath = tmp / "ref.fa"
    refpath.write_text(f">c1\n{ref}\n")
    return ref, str(refpath), str(reads)


@pytest.mark.parametrize("batch_reads", [8, 48])
def test_run_batched_cli_paf_matches_jax(conc_world, batch_reads):
    ref, _, reads = conc_world
    jmi = JaxMiniIndex.build(["c1"], [ref], w=10, k=15)
    io_, mo = IndexOptions(), MapOptions()
    set_opt("map-ont", io_, mo)
    mapopt_update(mo, jmi)
    want = io.StringIO()
    n1 = jax_engine.run_batched_cli(jmi, mo, [reads], want,
                                    batch_reads=batch_reads, L=512)
    tmi = MiniIndex.build(["c1"], [ref], w=10, k=15)
    tio, tmo = port_config.IndexOptions(), port_config.MapOptions()
    port_config.set_opt("map-ont", tio, tmo)
    port_config.mapopt_update(tmo, tmi)
    got = io.StringIO()
    n2 = engine.run_batched_cli(tmi, tmo, [reads], got,
                                batch_reads=batch_reads, L=512, device="cpu")
    assert n1 == n2 == 48
    assert got.getvalue() == want.getvalue()
    assert len(got.getvalue().splitlines()) >= 48


def _captured(monkeypatch, mod):
    """Patch the three --batch drivers of mod to record the index, its side
    data and the options they are handed."""
    seen = {}

    def fake(mi, opt, queries, out, **_):
        seen.update(k=mi.k, w=mi.w, flag=mi.flag, b=mi.b, opt=vars(opt),
                    intervals=mi.intervals and mi.intervals.per_ctg,
                    alt=[s.is_alt for s in mi.seq])
        return 0
    for name in ("run_batched_cli", "run_batched_align_cli",
                 "run_batched_pe_cli"):
        monkeypatch.setattr(mod, name, fake)
    return seen


@pytest.mark.parametrize("opts", [
    ["-x", "map-ont"], ["-x", "lr:hq"],
    ["-k", "17", "-w", "11", "-r", "1000", "-g", "8000"],
    ["-x", "map-ont", "-f", "0.001", "-N", "3", "--secondary=no", "-r2k,30k"],
    ["-x", "splice:sr"], ["-c", "--eqx"],
    ["-x", "splice", "--junc-bed", "JUNC"],
    ["-c", "-x", "map-ont", "--alt", "ALT"], ["-a", "--eqx"],
])
def test_cli_options_match_jax(conc_world, monkeypatch, tmp_path, opts):
    _, ref, reads = conc_world
    (tmp_path / "junc.bed").write_text("c1\t100\t900\tj\t3\t+\n"
                                       "c1\t2000\t2500\tk\t0\t-\n")
    (tmp_path / "alt.txt").write_text("c1\n")
    files = {"JUNC": str(tmp_path / "junc.bed"),
             "ALT": str(tmp_path / "alt.txt")}
    argv = ["--batch", *[files.get(o, o) for o in opts], ref, reads]
    want = _captured(monkeypatch, jax_engine)
    assert jax_cli.main(argv) == 0
    got = _captured(monkeypatch, engine)
    assert port_cli.main(argv, device="cpu") == 0
    # the port carries the JAX CLI's debug globals on the options
    assert got and got["opt"].pop("dbg_flag") == 0
    assert got == want


@pytest.mark.parametrize("preset", ["map-ont", "map-pb"])
def test_read_longer_than_L_matches_jax(conc_world, tmp_path, preset):
    """Reads longer than L, between shorter reads of the same batch, go to
    the host path and give the JAX package's PAF byte for byte, in input
    order."""
    ref, _, _ = conc_world
    rng = np.random.default_rng(3)
    comp = str.maketrans("ACGT", "TGCA")
    mixed = tmp_path / "mixed.fa"
    with open(mixed, "w") as f:
        for i in range(12):
            n = 1500 if i in (3, 4, 9) else 400         # L = 512
            st = int(rng.integers(0, len(ref) - n))
            seq = ref[st:st + n]
            if i % 4 == 1:
                seq = seq.translate(comp)[::-1]
            f.write(f">m{i}\n{seq}\n")
    texts = []
    for cfg, MI, eng, kw in (
            (port_config, MiniIndex, engine, {"device": "cpu"}),
            (jax_config, JaxMiniIndex, jax_engine, {})):
        io_, mo = cfg.IndexOptions(), cfg.MapOptions()
        cfg.set_opt(preset, io_, mo)
        mi = MI.build(["c1"], [ref], w=io_.w, k=io_.k, flag=io_.flag)
        cfg.mapopt_update(mo, mi)
        out = io.StringIO()
        engine.host_path.clear()
        assert eng.run_batched_cli(mi, mo, [str(mixed)], out, batch_reads=8,
                                   L=512, **kw) == 12
        texts.append(out.getvalue())
        if eng is engine:
            assert engine.host_path["reads"] == 3
    got, want = texts
    assert got == want
    names = [ln.split("\t")[0] for ln in got.splitlines()]
    assert {"m3", "m4", "m9"} <= set(names)
    assert names == sorted(names, key=lambda n: int(n[1:]))


def test_read_longer_than_L_needs_the_host_index(conc_world, tmp_path):
    ref, _, _ = conc_world
    long_reads = tmp_path / "long.fa"
    long_reads.write_text(f">long\n{ref[:600]}\n")
    tmi = MiniIndex.build(["c1"], [ref], w=10, k=15)
    tmo = port_config.MapOptions()
    port_config.mapopt_update(tmo, tmi)
    step = engine.PafStep(DeviceIndex.from_host(tmi, "cpu"),
                          engine.batch_params(tmi, tmo, 512), K=5,
                          min_sc=tmo.min_chain_score)
    with pytest.raises(ValueError, match="longer than L"):
        engine.map_queries(step, tmi, [str(long_reads)], io.StringIO(), 8)


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minimap2_tpu_torch.resolve_device(None)
    assert minimap2_tpu_torch.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("mid_occ", [2, 40, 100, 300])
@pytest.mark.parametrize("cap", [None, "32", "128"])
def test_occ_cap_matches_jax(monkeypatch, cap, mid_occ):
    if cap is None:
        monkeypatch.delenv("MM2TPU_OCC_CAP", raising=False)
    else:
        monkeypatch.setenv("MM2TPU_OCC_CAP", cap)
    jo, po = MapOptions(), port_config.MapOptions()
    jo.mid_occ = po.mid_occ = mid_occ
    assert engine._occ_cap(po) == jax_engine._occ_cap(jo)
