"""The port's RMQ chaining tier vs the JAX package (tolerance 0):

(a) _chain_scan with and without the tier on the anchors of the JAX
    package's test_rmq_tier_long_lookback (a chain predecessor past the
    short window, junk anchors between), and on random planes with junk
    anchors, strands and contigs: f, pred, qs, rs and the best chain equal;
(b) a PafStep batch with B % 128 == 0 and A % 256 == 0 under rmq_tier
    takes the scan route, as the JAX package's make_paf_step does, and its
    records equal the JAX step's (Pallas kernels in interpret mode);
(c) cli.main with --batch -x lr:hqae (PAF and -a SAM), -x asm20 and
    -x map-ont --rmq=yes byte-identical to the JAX CLI at small widths;
(d) the --batch step's chain gap penalty is map-ont's for every preset in
    both packages, where the host chainer takes chain_gap_scale (a
    reference finding the port reproduces).
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minimap2_tpu.cli as jax_cli
import minimap2_tpu.parallel.engine as jax_engine
from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.ops import sketch_pallas, sort_pallas
from minimap2_tpu.parallel import batch as jax_batch
import minimap2_tpu_torch.cli as port_cli
from minimap2_tpu_torch import config as port_config
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.map.chain import chain_rmq
from minimap2_tpu_torch.parallel import batch, engine

jax.config.update("jax_platforms", "cpu")

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = str.maketrans("ACGT", "TGCA")


def _scan_both(planes, **kw):
    """_chain_scan of both packages on the same numpy planes."""
    jbest, (jf, jpred, _v, jqs, jrs) = jax_batch._chain_scan(
        *(jnp.asarray(x) for x in planes), jax_batch.BatchParams(**kw))
    pbest, (pf, ppred, pqs, prs) = batch._chain_scan(
        *(torch.from_numpy(x) for x in planes), batch.BatchParams(**kw))
    for w_, g_ in zip((*jbest, jf, jpred, jqs, jrs),
                      (*pbest, pf, ppred, pqs, prs)):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    return pbest, ppred.numpy()


def _lookback_planes(A=512):
    """The anchors of the JAX package's test_rmq_tier_long_lookback: two
    chains on either side of a 5 kb deletion with 150 junk anchors (shared
    low qpos) between them in rpos order."""
    anchors = [(100 + 30 * j, 100 + 30 * j) for j in range(100)]
    anchors += [(3100 + 33 * j, 40 + (j % 3)) for j in range(150)]
    anchors += [(8100 + 30 * j, 3100 + 30 * j) for j in range(100)]
    anchors.sort()
    n = len(anchors)
    rpos = np.zeros((1, A), np.int32)
    qpos = np.zeros((1, A), np.int32)
    rpos[0, :n] = [a[0] for a in anchors]
    qpos[0, :n] = [a[1] for a in anchors]
    av = np.zeros((1, A), bool)
    av[0, :n] = True
    z = np.zeros((1, A), np.int32)
    return (z, z.copy(), rpos, qpos, np.full((1, A), 15, np.int32), av)


@pytest.mark.parametrize("tier", [False, True], ids=["window", "rmq"])
def test_chain_scan_long_lookback_matches_jax(tier):
    best, pred = _scan_both(_lookback_planes(), chain_window=64, bw=500,
                            bw_long=50000, max_dist_x=100000,
                            max_dist_y=100000, rmq_tier=tier)
    sc = int(best[0][0])
    if tier:            # joined across the gap through the long window
        assert sc > 2000 and int(best[1][0]) <= 110
        assert (pred == -2).sum() >= 1
    else:
        assert sc < 1700 and (pred != -2).all()


def _random_planes(rng, B, A):
    """Sorted anchor planes of B reads: a few chains each on its own
    strand/contig with gaps, plus junk anchors, invalid lanes at the end
    and a few invalid lanes inside (av False)."""
    out = [np.zeros((B, A), np.int32) for _ in range(5)] + \
        [np.zeros((B, A), bool)]
    for b in range(B):
        rows = []
        for _c in range(int(rng.integers(1, 4))):
            rv, ri = int(rng.integers(0, 2)), int(rng.integers(0, 3))
            r0, q0 = int(rng.integers(0, 50000)), int(rng.integers(0, 2000))
            for j in range(int(rng.integers(20, 120))):
                jump = 4000 if j == 40 else 0        # a long gap
                rows.append((rv, ri, r0 + 25 * j + jump
                             + int(rng.integers(-3, 4)), q0 + 25 * j,
                             int(rng.integers(12, 26))))
        for _ in range(int(rng.integers(50, 250))):   # junk
            rows.append((int(rng.integers(0, 2)), int(rng.integers(0, 3)),
                         int(rng.integers(0, 60000)),
                         int(rng.integers(0, 5000)),
                         int(rng.integers(12, 26))))
        rows = sorted(rows)[:A]
        n = len(rows)
        for k in range(5):
            out[k][b, :n] = [r[k] for r in rows]
        out[5][b, :n] = rng.random(n) > 0.02
    return tuple(out)


@pytest.mark.parametrize("window,stride", [(64, 32), (16, 5)])
def test_chain_scan_rmq_random_matches_jax(window, stride):
    rng = np.random.default_rng(17 + stride)
    planes = _random_planes(rng, 8, 512)
    _best, pred = _scan_both(planes, chain_window=32, bw=500, bw_long=20000,
                             max_dist_x=5000, max_dist_y=5000,
                             rmq_tier=True, rmq_window=window,
                             rmq_stride=stride)
    assert (pred == -2).sum() > 0 and (pred >= 0).sum() > 0


def _kernel_world(B=128):
    """200 kb genome with a repeat family; B reads of 300-1000 bp (5%
    substitutions, half reverse-complemented, every 8th with a 2 kb
    deletion)."""
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


def test_paf_step_rmq_tier_takes_the_scan_route(monkeypatch):
    """B % 128 == 0 and A % 256 == 0 would take the chain kernel; under
    rmq_tier both packages take the scan (JAX engine.py:77-78), in both
    passes, and the records are equal."""
    g, reads = _kernel_world()
    shape = dict(k=15, w=10, L=1024, M=256, A=256, occ_cap=16,
                 chain_window=64, bw=500, bw_long=20000, rmq_tier=True)
    sk, s3 = sketch_pallas.sketch_batch, sort_pallas.sort3_rows
    monkeypatch.setattr(sketch_pallas, "sketch_batch",
                        functools.partial(sk, interpret=True))
    monkeypatch.setattr(sort_pallas, "sort3_rows",
                        lambda a, b, c, G=8, interpret=False:
                        s3(a, b, c, G=G, interpret=True))
    jdi = jax_batch.DeviceIndex.from_host(
        JaxMiniIndex.build_codes(["g"], [g], w=10, k=15), 1)[0]
    jstep = jax_engine.make_paf_step(jdi, jax_batch.BatchParams(**shape),
                                     K=5, min_sc=40, interpret=False)
    codes, lens = engine.encode_batch(reads, 1024)
    packed, nbits = engine.pack_codes(codes)
    want = np.asarray(jstep(jnp.asarray(packed), jnp.asarray(nbits),
                            jnp.asarray(lens)))

    def no_kernel(*a, **k):
        raise AssertionError("chain_batch ran under rmq_tier")
    monkeypatch.setattr(engine, "chain_batch", no_kernel)
    scans = []
    monkeypatch.setattr(engine, "_chain_scan", lambda *a: (
        scans.append(a[-1]), batch._chain_scan(*a))[1])
    di = batch.DeviceIndex.from_host(
        MiniIndex.build_codes(["g"], [g], w=10, k=15), "cpu")
    step = engine.PafStep(di, batch.BatchParams(**shape), K=5, min_sc=40)
    got = step(*(torch.from_numpy(x) for x in (packed, nbits, lens)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert [p.bw for p in scans] == [500, 20000]
    assert all(p.rmq_tier for p in scans)
    assert (want[0, 0] > 100).sum() > 100


@pytest.fixture(scope="module")
def lr_world(tmp_path_factory):
    """A 120 kb genome with a repeat family and 24 Q20-like reads (1%
    substitutions) of 300-450 bp, half reverse-complemented, every 4th
    across a 1.5 kb deletion (a long-join candidate)."""
    tmp = tmp_path_factory.mktemp("torch_rmq")
    rng = np.random.default_rng(23)
    g = rng.integers(0, 4, 120_000).astype(np.uint8)
    fam = rng.integers(0, 4, 400).astype(np.uint8)
    for st in rng.integers(0, 119_000, 10):
        g[st:st + 400] = fam
    ref = ACGT[g].tobytes().decode()
    reads = tmp / "reads.fa"
    with open(reads, "w") as f:
        for i in range(24):
            n = int(rng.integers(300, 450))
            st = int(rng.integers(0, len(ref) - n - 2000))
            seq = ref[st:st + n] if i % 4 else \
                ref[st:st + n // 2] + ref[st + n // 2 + 1500:st + n + 1500]
            s = np.frombuffer(seq.encode(), np.uint8).copy()
            m = rng.random(len(s)) < 0.01
            s[m] = ACGT[rng.integers(0, 4, int(m.sum()))]
            seq = s.tobytes().decode()
            if i % 2:
                seq = seq.translate(COMP)[::-1]
            f.write(f">r{i}\n{seq}\n")
    refpath = tmp / "ref.fa"
    refpath.write_text(f">c1\n{ref[:70000]}\n>c2\n{ref[70000:]}\n")
    return str(refpath), str(reads)


_CLI_CASES = {"lr-hqae-paf": ["-x", "lr:hqae"],
              "lr-hqae-sam": ["-ax", "lr:hqae"],
              "asm20-paf": ["-x", "asm20"],
              "map-ont-rmq-paf": ["-x", "map-ont", "--rmq=yes"]}


def _small_widths(mod, mp):
    """mod's --batch drivers at the tests' small widths."""
    mp.setattr(mod, "run_batched_cli", functools.partial(
        mod.run_batched_cli, batch_reads=16, L=512))
    mp.setattr(mod, "run_batched_align_cli", functools.partial(
        mod.run_batched_align_cli, batch_reads=16, L=512,
        align_kw={"QP": 768, "TP": 1280, "W": 256, "sub": 8}))


@pytest.fixture(scope="module")
def jax_cli_outs(lr_world, tmp_path_factory):
    """The JAX CLI's output of each case, made once for the module: case
    -> (its -o path, which the port then writes too, as the @PG line
    carries it; the text).  The JAX step compiles its k25 w51 sketch for
    about two minutes on the CPU, once in the PAF step and once in the -a
    step, so the cases run in threads and the compiles overlap."""
    ref, reads = lr_world
    tmp = tmp_path_factory.mktemp("rmq_cli")

    def run(case):
        out = tmp / f"{case}.out"
        assert jax_cli.main(["--batch", *_CLI_CASES[case], "-o", str(out),
                             ref, reads]) == 0
        return case, (out, out.read_text())
    with pytest.MonkeyPatch.context() as mp:
        _small_widths(jax_engine, mp)
        with ThreadPoolExecutor(len(_CLI_CASES)) as pool:
            return dict(pool.map(run, _CLI_CASES))


@pytest.mark.parametrize("case", list(_CLI_CASES))
def test_cli_rmq_matches_jax(monkeypatch, lr_world, jax_cli_outs, case):
    ref, reads = lr_world
    argv = _CLI_CASES[case]
    out, want = jax_cli_outs[case]
    tiers = []
    real = engine.batch_params
    monkeypatch.setattr(engine, "batch_params", lambda *a: (
        tiers.append(real(*a)), tiers[-1])[1])
    _small_widths(engine, monkeypatch)
    assert port_cli.main(["--batch", *argv, "-o", str(out), ref, reads],
                         device="cpu") == 0
    got = out.read_text()
    assert got == want
    assert tiers and all(p.rmq_tier and p.bw_long > p.bw for p in tiers)
    recs = [ln.split("\t") for ln in got.splitlines()
            if not ln.startswith("@")]
    if argv[0] == "-ax":
        names = {t[0] for t in recs if not int(t[1]) & 0x904}
    else:
        names = {t[0] for t in recs}
    assert len(names) >= 20           # nearly every read mapped


def test_batch_chain_gap_penalty_is_map_ont():
    """The --batch step chains every preset with BatchParams' default gap
    penalty 0.8 * 0.01 * 15 in both packages; the host chainer takes
    chain_gap_scale * 0.01 * k (1.25 at lr:hqae).  Smallest input where
    the two disagree: two anchors (span 25) 100 bp apart on the query and
    120 on the target; the step joins them (f 46), the host chainer does
    not."""
    io_, mo = port_config.IndexOptions(), port_config.MapOptions()
    port_config.set_opt("lr:hqae", io_, mo)

    class _Mi:
        k, w, flag = io_.k, io_.w, 0
    mo.mid_occ = 100
    p = engine.batch_params(_Mi, mo, 1024)
    assert p.chn_pen_gap == jax_batch.BatchParams().chn_pen_gap
    assert p.rmq_tier and p.bw_long == mo.bw_long
    A = 4
    planes = [np.zeros((1, A), np.int32) for _ in range(5)]
    planes[2][0, :2] = (100, 220)
    planes[3][0, :2] = (100, 200)
    planes[4][0, :] = 25
    av = np.zeros((1, A), bool)
    av[0, :2] = True
    best, _pred = _scan_both((*planes, av), chain_window=64, bw=500,
                             max_dist_x=5000, max_dist_y=5000)
    assert int(best[0][0]) == 46 and int(best[1][0]) == 76
    # the host path's chainer (mg_lchain_rmq under MM_F_RMQ) joins them
    # only at the step's penalty; at the preset's it keeps two chains
    ax = np.array([100, 220], np.uint64)
    ay = np.array([(25 << 32) | 100, (25 << 32) | 200], np.uint64)
    pen = np.float32(mo.chain_gap_scale * 0.01 * io_.k)
    assert pen == np.float32(1.25)

    def host_chains(gap):
        u, _ax, _ay = chain_rmq(mo.max_gap, mo.rmq_inner_dist, mo.bw,
                                mo.max_chain_skip, mo.rmq_size_cap, 1, 0,
                                gap, np.float32(0), ax.copy(), ay.copy())
        return [(int(x) >> 32, int(x) & 0xFFFFFFFF) for x in u]
    assert host_chains(np.float32(p.chn_pen_gap)) == [(46, 2)]
    assert host_chains(pen) == [(25, 1), (25, 1)]
