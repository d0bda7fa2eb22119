"""Port seeding and chaining vs the JAX package, exact on integer planes:
minimizer compaction, the h2r probe + anchor expansion (pos_fmt 1 and 2,
stride-2 and stride-4 rows, every rid-recovery branch), the plain chain
kernel vs chain_pallas in interpret mode, the windowed scan, and top-K
chain selection; and the CUDA chain kernel's own code (csrc/chain.cu, on
the host shim) vs the plain version, bit-equal."""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.ops import sort_pallas
from minimap2_tpu.ops.chain_pallas import chain_batch as jax_chain_batch
from minimap2_tpu.parallel import batch as jb
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.ops import chain as chain_mod
from minimap2_tpu_torch.ops.chain import NEG_INF, chain_batch
from minimap2_tpu_torch.parallel import batch as tb
from cuda_host import build_on_host

jax.config.update("jax_platforms", "cpu")


def _t(x):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.array(x))


def _eq(got, want, name=""):
    got = got.numpy()
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _front_inputs(seed, B, L, density):
    rng = np.random.default_rng(seed)
    hhi = rng.integers(0, 2**32, (B, L), dtype=np.uint64).astype(np.uint32)
    hlo = rng.integers(0, 2**32, (B, L), dtype=np.uint64).astype(np.uint32)
    z = rng.integers(0, 2, (B, L)).astype(np.int32)
    mini = rng.random((B, L)) < density
    return hhi, hlo, z, mini


@pytest.mark.parametrize("L,M", [(512, 128), (8192, 1024)])
def test_compaction_matches_on_valid_lanes(L, M):
    hhi, hlo, z, mini = _front_inputs(L, 8, L, 0.15)
    got = tb._compact_minimizers(_t(hhi), _t(hlo), torch.from_numpy(z) != 0,
                                 torch.from_numpy(mini), M)
    want = jb._compact_minimizers(jnp.asarray(hhi), jnp.asarray(hlo),
                                  jnp.asarray(z), jnp.asarray(mini), M,
                                  use_pallas=False)
    valid = np.asarray(want[4])
    _eq(got[4], valid, "mvalid")
    for name, g, w in zip(("mh_hi", "mh_lo", "mz", "mpos"), got, want):
        w = np.asarray(w)
        g = g.numpy().view(w.dtype) if w.dtype == np.uint32 else g.numpy()
        np.testing.assert_array_equal(g[valid], w[valid], err_msg=name)


@pytest.mark.parametrize("B,density", [(2, 0.15), (8, 0.25)])
def test_wide_compaction_matches_jax(B, density):
    """Past 16384 lanes (L 20000 -> A 32768): the port's sort1 + gather
    against the JAX package's route (lax.sort at B % 8 == 0, else its
    rank scatter); at density 0.25 a row holds more minimizers than M."""
    L, M = 20000, 4096
    hhi, hlo, z, mini = _front_inputs(B, B, L, density)
    got = tb._compact_minimizers(_t(hhi), _t(hlo), torch.from_numpy(z) != 0,
                                 torch.from_numpy(mini), M)
    want = jb._compact_minimizers(jnp.asarray(hhi), jnp.asarray(hlo),
                                  jnp.asarray(z), jnp.asarray(mini), M,
                                  use_pallas=True)
    valid = np.asarray(want[4])
    assert valid.sum(1).min() > 0 and (valid.sum(1) == M).any() == (B == 8)
    _eq(got[4], valid, "mvalid")
    for name, g, w in zip(("mh_hi", "mh_lo", "mz", "mpos"), got, want):
        w = np.asarray(w)
        g = g.numpy().view(w.dtype)
        np.testing.assert_array_equal(g[valid], w[valid], err_msg=name)
        if B % 8 == 0 and name in ("mz", "mpos"):   # the lax.sort route
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_compaction_matches_sort_route_on_all_lanes(monkeypatch):
    hhi, hlo, z, mini = _front_inputs(1, 8, 512, 0.2)
    orig = sort_pallas.sort3_rows
    monkeypatch.setattr(sort_pallas, "sort3_rows",
                        lambda a, b, c, G=8, interpret=False:
                        orig(a, b, c, G=G, interpret=True))
    want = jb._compact_minimizers(jnp.asarray(hhi), jnp.asarray(hlo),
                                  jnp.asarray(z), jnp.asarray(mini), 128,
                                  use_pallas=True)
    got = tb._compact_minimizers(_t(hhi), _t(hlo), torch.from_numpy(z) != 0,
                                 torch.from_numpy(mini), 128)
    for name, g, w in zip(("mh_hi", "mh_lo", "mz", "mpos", "mvalid"),
                          got, want):
        _eq(g, w, name)


def _world(case):
    """Genome with a 6-fold repeat (occurrence-filtered seeds -> rep_len),
    reads from it with substitutions, a third reverse-complemented."""
    rng = np.random.default_rng(7)
    n_ctg = 20 if case in ("many", "many_short") else 1
    lens = [6000] * n_ctg if n_ctg > 1 else [60000]
    if case == "many_short":
        lens[5] = 1500
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    rep = rng.integers(0, 4, 300).astype(np.uint8)
    for j in range(6):
        c = seqs[j % n_ctg]
        st = 200 + 700 * j if n_ctg == 1 else 400
        c[st:st + 300] = rep
    k = 19 if case == "k19" else 15
    names = [f"c{i}" for i in range(n_ctg)]
    B, L = 8, 1024
    codes = np.full((B, L), 4, np.uint8)
    qlen = np.zeros(B, np.int32)
    for b in range(B):
        src = seqs[int(rng.integers(0, n_ctg))] if b else seqs[0]
        n = int(rng.integers(300, min(L, len(src) - 10))) if b else 900
        st = int(rng.integers(0, len(src) - n)) if b else 0
        r = src[st:st + n].copy()
        m = rng.random(n) < 0.04
        r[m] = rng.integers(0, 4, int(m.sum()))
        if b % 3 == 1:
            r = (3 - r)[::-1]
        codes[b, :n] = r
        qlen[b] = n
    return names, seqs, k, codes, qlen


@pytest.mark.parametrize("case,fmt", [("one", 1), ("one", 2), ("k19", 1),
                                      ("many", 1), ("many_short", 1)])
def test_anchor_planes_match_jax(case, fmt):
    names, seqs, k, codes, qlen = _world(case)
    p = dict(k=k, w=10, L=1024, M=256, A=256, occ_cap=4, chain_window=64)
    jmi = JaxMiniIndex.build_codes(names, seqs, w=10, k=k)
    jdi = jb.DeviceIndex.from_host(jmi, 1, force_pos_fmt=fmt)[0]
    tdi = tb.DeviceIndex.from_host(MiniIndex.build_codes(names, seqs, w=10,
                                                         k=k),
                                   "cpu", force_pos_fmt=fmt)
    assert (tdi.rtab is not None) == (case == "many")
    jp, tp = jb.BatchParams(**p), tb.BatchParams(**p)
    hhi, hlo, z, mini = jb.device_sketch(jnp.asarray(codes),
                                         jnp.asarray(qlen), k, 10)
    front = jb._compact_minimizers(hhi, hlo, z, mini, jp.M)
    want = jb._lookup_anchors(jdi, *front, jnp.asarray(qlen), jp, True)
    got = tb._lookup_anchors(tdi, *(_t(x) for x in front), _t(qlen), tp)
    names_ = ("rev", "rid", "rpos", "qpos", "span", "av", "rep_len")
    for name, g, w in zip(names_, got, want):
        _eq(g, w, name)
    assert int(np.asarray(want[5]).sum()) > 300
    assert int(np.asarray(want[6]).sum()) > 0          # filtered seeds


def _anchor_planes(seed, B, A):
    """Sorted anchor planes: per read a few diagonal chains with indels
    plus noise, ragged valid counts, garbage past them."""
    rng = np.random.default_rng(seed)
    rev = np.zeros((B, A), np.int32)
    rid = np.zeros((B, A), np.int32)
    rpos = rng.integers(0, 1 << 20, (B, A)).astype(np.int32)
    qpos = rng.integers(0, 4000, (B, A)).astype(np.int32)
    span = rng.integers(1, 256, (B, A)).astype(np.int32)
    av = np.zeros((B, A), bool)
    for b in range(B):
        n = int(rng.integers(A // 4, A + 1)) if b % 5 else 0
        rows = []
        for c in range(int(rng.integers(1, 4))):
            base_r = int(rng.integers(0, 50000))
            rv, ri = int(rng.integers(0, 2)), int(rng.integers(0, 3))
            q = 0
            for _ in range(n // 2):
                q += int(rng.integers(1, 40))
                rows.append((rv, ri, base_r + q + int(rng.integers(-30, 31)),
                             q, 15))
        while len(rows) < n:
            rows.append((int(rng.integers(0, 2)), int(rng.integers(0, 3)),
                         int(rng.integers(0, 60000)),
                         int(rng.integers(0, 4000)),
                         int(rng.integers(10, 20))))
        rows = sorted(rows[:n])
        for a, row in enumerate(rows):
            rev[b, a], rid[b, a], rpos[b, a], qpos[b, a], span[b, a] = row
        av[b, :n] = True
    return rev, rid, rpos, qpos, span, av


CHAIN_ARGS = dict(max_dist_x=5000, max_dist_y=5000, bw=500,
                  chn_pen_gap=0.8 * 0.01 * 15, chn_pen_skip=0.0)


@pytest.mark.parametrize("bw", [500, 20000])
def test_plain_chain_kernel_matches_pallas(bw):
    planes = _anchor_planes(bw, 128, 256)
    args = dict(CHAIN_ARGS, bw=bw, max_dist_x=max(5000, bw),
                max_dist_y=max(5000, bw))
    want = jax_chain_batch(*(jnp.asarray(x) for x in planes), BL=128, WND=64,
                           AC=256, k=15, interpret=True, **args)
    got = chain_batch(*(torch.from_numpy(x) for x in planes), WND=64, **args)
    for name, g, w in zip(("f", "pred", "qs", "rs"), got, want):
        _eq(g, w, name)
    assert int((np.asarray(want[1]) >= 0).sum()) > 1000


def test_chain_scan_and_topk_match_jax():
    planes = _anchor_planes(3, 16, 256)
    jp = jb.BatchParams(A=256, chain_window=64)
    tp = tb.BatchParams(A=256, chain_window=64)
    jbest, (jf, jpred, _, jqs, jrs) = jb._chain_scan(
        *(jnp.asarray(x) for x in planes), jp)
    tbest, (tf, tpred, tqs, trs) = tb._chain_scan(
        *(torch.from_numpy(x) for x in planes), tp)
    for name, g, w in zip(("f", "pred", "qs", "rs"), (tf, tpred, tqs, trs),
                          (jf, jpred, jqs, jrs)):
        _eq(g, w, name)
    for g, w in zip(tbest, jbest):
        _eq(g, w, "best")
    rev, rid, rpos, qpos, span, av = planes
    want = jb.topk_chains(jf, jqs, jrs, *(jnp.asarray(x) for x in
                                          (rev, rid, rpos, qpos, av)),
                          K=5, min_sc=40)
    got = tb.topk_chains(tf, tqs, trs, *(torch.from_numpy(x) for x in
                                         (rev, rid, rpos, qpos, av)),
                         K=5, min_sc=40)
    for g, w in zip(got, want):
        _eq(g, w, "topk")
    assert int((np.asarray(want[0]) > 0).sum()) > 12


def test_chain_routes_break_ties_differently():
    """Two predecessors with equal scores: the kernel takes the later one
    (largest j), the scan the older window slot (first argmax)."""
    B, A = 128, 256
    rev = np.zeros((B, A), np.int32)
    rid = np.zeros((B, A), np.int32)
    rpos = np.zeros((B, A), np.int32)
    qpos = np.zeros((B, A), np.int32)
    span = np.full((B, A), 15, np.int32)
    av = np.zeros((B, A), bool)
    # anchors 0 and 1 lie on one diagonal 100 apart from anchor 2 each way
    rpos[:, :3] = [[1000, 1100, 1200]]
    qpos[:, :3] = [[1100, 1000, 1200]]
    av[:, :3] = True
    t = [torch.from_numpy(x) for x in (rev, rid, rpos, qpos, span, av)]
    _, kpred, _, _ = chain_batch(*t, WND=64, **CHAIN_ARGS)
    p = dataclasses.replace(tb.BatchParams(A=A), **{
        k_: v for k_, v in CHAIN_ARGS.items() if k_ != "chn_pen_gap"})
    _, (_, spred, _, _) = tb._chain_scan(*t, p)
    assert int(kpred[0, 2]) == 1 and int(spred[0, 2]) == 0


_CHAIN_RUNNER = r"""
extern "C" int emu_chain_wnd(const void* rev, const void* rid,
                             const void* rpos, const void* qpos,
                             const void* span, const void* av, void* f,
                             void* pred, void* qs, void* rs, int B, int A,
                             int max_dist_x, int max_dist_y, int bw,
                             float gap, float skip, int wnd) {
  const Params prm{std::max(0, std::min(max_dist_x, max_dist_y)), bw, gap,
                   skip};
  const ChainFn fn = chain_variant(wnd);
  emu_launch(B, 32, [=] {
    fn((const int32_t*)rev, (const int32_t*)rid, (const int32_t*)rpos,
       (const int32_t*)qpos, (const int32_t*)span, (const uint8_t*)av,
       (int32_t*)f, (int32_t*)pred, (int32_t*)qs, (int32_t*)rs, A, wnd, prm);
  });
  return slots_a_lane(wnd);
}

extern "C" int emu_chain(const void* rev, const void* rid, const void* rpos,
                         const void* qpos, const void* span, const void* av,
                         void* f, void* pred, void* qs, void* rs, int B,
                         int A, int max_dist_x, int max_dist_y, int bw,
                         float gap, float skip) {
  emu_chain_wnd(rev, rid, rpos, qpos, span, av, f, pred, qs, rs, B, A,
                max_dist_x, max_dist_y, bw, gap, skip, 64);
  return 0;
}
"""


@pytest.fixture(scope="module")
def chain_host(tmp_path_factory):
    """csrc/chain.cu's device code on the host shim."""
    lib = build_on_host("chain", _CHAIN_RUNNER,
                        tmp_path_factory.mktemp("chain_host"))
    fn, fn.wnd = lib.emu_chain, lib.emu_chain_wnd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
        + [ctypes.c_float] * 2
    fn.wnd.argtypes = fn.argtypes + [ctypes.c_int]
    fn.restype = fn.wnd.restype = ctypes.c_int
    return fn


def _host_chain_planes(seed, B, A, wnd=64):
    """_anchor_planes plus the edges: row 1 the tie of
    test_chain_routes_break_ties_differently repeated along the read
    (equal candidates, the larger j must win), row 2 anchors every one
    barred from the others (windows of NEG_INF only), row 3 valid up to
    its last anchor (n = A), row 4 with invalid anchors inside its valid
    range, row 0 with no valid anchor; rows 5 and 6 the window's edge:
    anchor 0 joins anchor wnd (wnd back) but not anchor wnd + 1, the
    anchors between being on another contig."""
    planes = [x.copy() for x in _anchor_planes(seed, B, A)]
    rev, rid, rpos, qpos, span, av = planes
    step = np.arange(A // 3)[:, None] * 5000
    tri = (np.array([[1000, 1100, 1200]]) + step).ravel()
    rpos[1, :len(tri)] = tri
    qpos[1, :len(tri)] = (np.array([[1100, 1000, 1200]]) + step).ravel()
    rev[1], rid[1], span[1] = 0, 0, 15
    av[1] = np.arange(A) < len(tri)
    rid[2] = np.arange(A)
    av[2] = True
    av[3] = True
    av[4, ::7] = False
    av[4, -3] = True
    for b, far in ((5, wnd), (6, wnd + 1)):
        rid[b, :far + 1] = 1
        rid[b, [0, far]] = 0
        rpos[b, [0, far]] = [1000, 1100]
        qpos[b, [0, far]] = [1000, 1100]
        span[b, :far + 1] = 15
        av[b, :far + 1] = True
    return planes


@pytest.mark.parametrize("bw,B,A", [(500, 12, 256), (20000, 12, 256),
                                    (500, 8, 400), (20000, 8, 144),
                                    (100, 8, 2048)])
def test_chain_cuda_source_on_host_matches_plain(chain_host, bw, B, A):
    """The kernel's own code against the plain version, bit-equal: both
    bands, chunks of 128 anchors with a ragged last one (A = 400, 144), and
    the sr path's band 100 at its A = 2048."""
    planes = _host_chain_planes(bw + A, B, A)
    args = dict(CHAIN_ARGS, bw=bw, max_dist_x=max(5000, bw),
                max_dist_y=max(5000, bw))
    outs = [np.full((B, A), -7, np.int32) for _ in range(4)]
    ins = [np.ascontiguousarray(x) for x in planes]
    assert chain_host(*[x.ctypes.data for x in ins],
                      *[o.ctypes.data for o in outs], B, A,
                      args["max_dist_x"], args["max_dist_y"], bw,
                      float(np.float32(args["chn_pen_gap"])),
                      float(np.float32(args["chn_pen_skip"]))) == 0
    want = chain_batch(*(torch.from_numpy(x) for x in planes), WND=64,
                       **args)
    for name, g, w in zip(("f", "pred", "qs", "rs"), outs, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    pred = want[1].numpy()
    assert pred[1, 2] == 1                   # the tie went to the larger j
    assert pred[5, 64] == 0 and pred[6, 65] == -1
    assert (pred[2] == -1).all() and (want[0].numpy()[0] == NEG_INF).all()
    assert int((pred >= 0).sum()) > A


@pytest.mark.parametrize("WND", [1, 2, 17, 32, 128, 300])
def test_chain_windows_match_pallas(WND):
    """Any window the JAX kernel takes (its ring slot is a % WND): the
    smallest ones (fewer than two older slots), one not a power of two,
    one a lane's slot of the register ring (32), the PAF path's
    chain_window 128 and one past the register ring (300)."""
    planes = _anchor_planes(WND, 128, 384)
    want = jax_chain_batch(*(jnp.asarray(x) for x in planes), BL=128,
                           WND=WND, AC=384, k=15, interpret=True,
                           **CHAIN_ARGS)
    got = chain_batch(*(torch.from_numpy(x) for x in planes), WND=WND,
                      **CHAIN_ARGS)
    for name, g, w in zip(("f", "pred", "qs", "rs"), got, want):
        _eq(g, w, name)
    pred = np.asarray(want[1])
    back = np.arange(pred.shape[1])[None, :] - pred
    assert (pred >= 0).sum() > 1000 and back[pred >= 0].max() <= WND


_WINDOW_CASES = [(1, 256), (2, 256), (17, 256), (32, 256), (100, 256),
                 (128, 256), (200, 256), (256, 320), (300, 384), (5000, 256)]


@pytest.mark.parametrize("WND,A", _WINDOW_CASES,
                         ids=[f"WND{w}-A{a}" for w, a in _WINDOW_CASES])
def test_chain_windows_cuda_source_on_host_matches_plain(chain_host, WND, A):
    """The kernel's instantiation of each window against the plain
    version, bit-equal: 1, 2, 4 and 8 slots a lane in registers (WND up to
    32, 64, 128, 256, and windows that fill them partly) and the ring in
    shared memory past 256 slots, with the window's edge (rows 5 and 6)
    where A holds it."""
    B, bw = 8, 500
    planes = _host_chain_planes(WND + A, B, A, wnd=min(WND, A - 2))
    args = dict(CHAIN_ARGS, bw=bw)
    outs = [np.full((B, A), -7, np.int32) for _ in range(4)]
    ins = [np.ascontiguousarray(x) for x in planes]
    sl = chain_host.wnd(*[x.ctypes.data for x in ins],
                        *[o.ctypes.data for o in outs], B, A,
                        args["max_dist_x"], args["max_dist_y"], bw,
                        float(np.float32(args["chn_pen_gap"])),
                        float(np.float32(args["chn_pen_skip"])), WND)
    assert sl == chain_mod.slots_a_lane(WND)
    want = chain_batch(*(torch.from_numpy(x) for x in planes), WND=WND,
                       **args)
    for name, g, w in zip(("f", "pred", "qs", "rs"), outs, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    pred = want[1].numpy()
    assert pred[1, 2] == 1                  # anchor 1 (the larger j)
    if WND + 1 < A:
        assert pred[5, WND] == 0 and pred[6, WND + 1] == -1
