"""Port extd2 (ops/extend.py) vs the JAX package's extd2_batch2 Pallas
kernel in interpret mode: p and ez bit-equal (tolerance 0) on pairs with
substitutions, indels and N runs, including pairs that end exactly on a
chunk boundary (EZ_DEAD's group rule) and pairs whose band dies.  Also the
device code of csrc/extd2.cu, built with g++ on tests/cuda_host_shim.h
(one std::thread per CUDA thread), bit-equal to the plain version."""
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minimap2_tpu.ops.extend_pallas2 import extd2_batch2 as jax_extd2
from minimap2_tpu_torch.ops import extend
from cuda_host import build_on_host

jax.config.update("jax_platforms", "cpu")

Q, E, Q2, E2 = 4, 2, 24, 1


def make_pairs(seed, lens_list, QP, TP):
    """Pairs of the given (qlen, tlen): the target is the query with 6%
    substitutions, short indels and a run of N (code 4) in some pairs."""
    rng = np.random.default_rng(seed)
    N = len(lens_list)
    qr = np.zeros((N, QP), np.uint8)
    sf = np.zeros((N, TP), np.uint8)
    lens = np.array(lens_list, np.int32)
    for n, (ql, tl) in enumerate(lens_list):
        q = rng.integers(0, 4, ql).astype(np.uint8)
        t = []
        i = 0
        while len(t) < tl:
            x = rng.random()
            if x < 0.03 and i < ql:
                i += int(rng.integers(1, 6))                 # deletion
            elif x < 0.06:
                t.extend(rng.integers(0, 4, int(rng.integers(1, 6))))
            else:
                c = q[i] if i < ql else rng.integers(0, 4)
                t.append(rng.integers(0, 4) if rng.random() < 0.06 else c)
                i += 1
        t = np.array(t[:tl], np.uint8)
        if n % 3 == 1:
            st = int(rng.integers(0, max(1, ql - 12)))
            q[st:st + 10] = 4
        if n % 3 == 2:
            st = int(rng.integers(0, max(1, tl - 12)))
            t[st:st + 10] = 4
        qr[n, :ql] = q[::-1]
        sf[n, :tl] = t
    return qr, sf, lens


# (qlen, tlen) pairs: ordinary ones; two that end on a chunk boundary
# (qlen + tlen - 1 = 384 and 256, multiples of RB): #4 shares its group
# with a longer pair, #8 is the longest of its group (the rest of which is
# small or padding) for every G below; #6's band dies (|qlen - tlen| > w)
LENS = [(200, 230), (40, 44), (150, 120), (60, 40), (204, 181), (250, 370),
        (230, 20), (1, 1), (156, 101)]


@pytest.mark.parametrize("RB,G,with_cigar,sc_N", [
    (32, 4, True, 0), (64, 4, True, -1), (64, 8, False, 0),
    (32, 3, False, -1)])
def test_extd2_matches_jax(RB, G, with_cigar, sc_N):
    QP, TP, W, w = 256, 384, 256, 150
    lens_list = LENS
    qr, sf, lens = make_pairs(RB + G, lens_list, QP, TP)
    R = QP + TP
    kw = dict(G=G, W=W, RB=RB, R=R, QP=QP, TP=TP, q=Q, e=E, q2=Q2, e2=E2,
              w=w, zdrop=-1, right_mode=False, approx_max=True,
              approx_drop=False, sc_mch=2, sc_mis=-4, sc_N=sc_N,
              with_cigar=with_cigar)
    jp, jez = jax_extd2(jnp.asarray(qr), jnp.asarray(sf), jnp.asarray(lens),
                        interpret=True, **kw)
    p, ez = extend.extd2_batch2(torch.from_numpy(qr), torch.from_numpy(sf),
                                torch.from_numpy(lens), **kw)
    N = len(lens_list)
    np.testing.assert_array_equal(ez.numpy(), np.asarray(jez))
    if with_cigar:
        NG, RC = jp.shape[:2]
        want = np.asarray(jp).transpose(0, 3, 1, 2, 4).reshape(
            NG * G, RC * RB, W)[:N]
        assert p.shape == want.shape
        np.testing.assert_array_equal(p.numpy(), want)
    else:
        assert p is None
    ezn = ez.numpy()
    # the cases reach what they are there for
    assert ezn[6, extend.EZ_ZDROP] == 1                    # band died
    assert (ezn[:, extend.EZ_DEAD] == 0).any()             # skipped chunk
    assert (ezn[:, extend.EZ_SCORE] > 0).sum() >= 5


def test_extd2_other_modes_raise():
    """Every mode of the JAX kernel runs (test_extd2_modes_match_jax), and
    so does W past 1024 (the port kernel's limit before its slab route),
    bit-equal to the JAX kernel; what still raises is a shape the kernel
    does not take: W not a multiple of 128, W < w + 48 + drift, W past
    MAX_W (the port kernel's ceiling), RB past 128, and planes that are
    not (N, QP), (N, TP)."""
    z = torch.zeros((1, 128), dtype=torch.uint8)
    lens = torch.ones((1, 2), dtype=torch.int32)
    kw = dict(G=1, W=128, RB=32, R=256, QP=128, TP=128, q=Q, e=E, q2=Q2,
              e2=E2, w=40, zdrop=-1, right_mode=False, approx_max=True,
              approx_drop=False, sc_mch=2, sc_mis=-4, sc_N=0)
    for mode in (dict(approx_max=False), dict(zdrop=400, approx_drop=True),
                 dict(right_mode=True, with_cigar=False)):
        extend.extd2_batch2(z, z, lens, **{**kw, **mode})
    wide = {**kw, "W": 1152, "w": 40}
    jp, jez = jax_extd2(jnp.asarray(z.numpy()), jnp.asarray(z.numpy()),
                        jnp.asarray(lens.numpy()), interpret=True, **wide)
    p, ez = extend.extd2_batch2(z, z, lens, **wide)
    np.testing.assert_array_equal(ez.numpy(), np.asarray(jez))
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jp).transpose(0, 3, 1, 2, 4).reshape(
            p.shape))
    for bad in (dict(w=100), dict(W=192), dict(W=extend.MAX_W + 128, w=40),
                dict(RB=256, W=1024), dict(QP=64)):
        with pytest.raises(ValueError):
            extend.extd2_batch2(z, z, lens, **{**kw, **bad})


@pytest.mark.parametrize("W,w,approx_max", [
    (1152, 1000, True), (1152, 1000, False), (2048, 1900, True),
    (2048, 1900, False)], ids=["W1152-approx", "W1152-exact",
                               "W2048-approx", "W2048-exact"])
def test_extd2_wide_matches_jax(W, w, approx_max):
    """Windows past one block of the port kernel's earlier 256 threads:
    the full band of 1000 (asm presets, -r 1000) at W 1152, and W 2048,
    in the -a path's approx mode and in the exact mode with z-drop; p and
    ez bit-equal to the JAX kernel's."""
    QP, TP, RB, G = 640, 896, 64, 4
    lens_l = [(600, 880), (640, 640), (300, 896), (1, 1), (520, 100)]
    qr, sf, lens = make_pairs(W + w, lens_l, QP, TP)
    kw = dict(G=G, W=W, RB=RB, R=QP + TP, QP=QP, TP=TP, q=Q, e=E, q2=Q2,
              e2=E2, w=w, zdrop=-1 if approx_max else 400, right_mode=False,
              approx_max=approx_max, approx_drop=False, sc_mch=2, sc_mis=-4,
              sc_N=0, with_cigar=True)
    jp, jez = jax_extd2(jnp.asarray(qr), jnp.asarray(sf), jnp.asarray(lens),
                        interpret=True, **kw)
    p, ez = extend.extd2_batch2(torch.from_numpy(qr), torch.from_numpy(sf),
                                torch.from_numpy(lens), **kw)
    N = len(lens_l)
    np.testing.assert_array_equal(ez.numpy(), np.asarray(jez))
    NG, RC = jp.shape[:2]
    want = np.asarray(jp).transpose(0, 3, 1, 2, 4).reshape(
        NG * G, RC * RB, W)[:N]
    np.testing.assert_array_equal(p.numpy(), want)
    assert (ez.numpy()[:, extend.EZ_SCORE] > 0).sum() >= 3


# the mode grid: approx_max x right_mode x with_cigar x zdrop, and
# approx_drop (with approx_max) x right_mode x with_cigar at zdrop 400
MODES = [(am, rm, wc, zd, False) for am in (True, False)
         for rm in (False, True) for wc in (True, False) for zd in (-1, 400)] \
    + [(True, rm, wc, 400, True) for rm in (False, True) for wc in (True, False)]
# sr scoring (a2 b8 q12 e2 q24 e1), under which a target that turns random
# z-drops at 400 within 256 bases.  Group 0 (G = 4): four pairs that all
# z-drop before the longest one's end; #7's band dies; #9, #10 end on a
# chunk boundary (rstar 256), #11 too as the longest of its group (384)
ZLENS = [(256, 256), (250, 240), (240, 256), (230, 250), (200, 230),
         (40, 44), (150, 120), (230, 20), (1, 1), (156, 101), (160, 97),
         (204, 181)]
ZSC = dict(q=12, e=2, q2=24, e2=1, sc_mch=2, sc_mis=-8, sc_N=-1)


def zdrop_pairs():
    """ZLENS pairs; in #0-#4 and #11 the target turns random partway."""
    qr, sf, lens = make_pairs(7, ZLENS, 256, 256)
    rng = np.random.default_rng(8)
    for n, g in ((0, 20), (1, 30), (2, 25), (3, 40), (4, 60), (11, 50)):
        tl = ZLENS[n][1]
        sf[n, g:tl] = rng.integers(0, 4, tl - g)
    return qr, sf, lens


def _mode_id(m):
    am, rm, wc, zd, ad = m
    return (("approx" if am else "exact") + ("-right" if rm else "-left")
            + ("-cigar" if wc else "-score") + f"-z{zd}"
            + ("-adrop" if ad else ""))


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_extd2_modes_match_jax(mode):
    """Each mode of the JAX kernel (exact-max with its H row, z-drop,
    approx-drop, right-align, with and without p): p and ez bit-equal."""
    am, rm, wc, zd, ad = mode
    qr, sf, lens = zdrop_pairs()
    G, RB, W, w, QP, TP = 4, 32, 256, 150, 256, 256
    kw = dict(G=G, W=W, RB=RB, R=QP + TP, QP=QP, TP=TP, w=w, zdrop=zd,
              right_mode=rm, approx_max=am, approx_drop=ad, with_cigar=wc,
              **ZSC)
    jp, jez = jax_extd2(jnp.asarray(qr), jnp.asarray(sf), jnp.asarray(lens),
                        interpret=True, **kw)
    p, ez = extend.extd2_batch2(torch.from_numpy(qr), torch.from_numpy(sf),
                                torch.from_numpy(lens), **kw)
    N = len(ZLENS)
    np.testing.assert_array_equal(ez.numpy(), np.asarray(jez))
    if wc:
        NG, RC = jp.shape[:2]
        want = np.asarray(jp).transpose(0, 3, 1, 2, 4).reshape(
            NG * G, RC * RB, W)[:N]
        np.testing.assert_array_equal(p.numpy(), want)
    else:
        assert p is None
    ezn = ez.numpy()
    rstar = lens.sum(1) - 1
    dropped = (ezn[:, extend.EZ_ZDROP] == 1) & (ezn[:, extend.EZ_NR] < rstar)
    band = np.array([7])
    if zd >= 0 and (not am or ad):
        # the whole of group 0 z-drops before its longest pair's end
        assert dropped[:4].all() and (ezn[:4, extend.EZ_NR] < rstar[:4].max()
                                      ).all()
        assert (ezn[:4, extend.EZ_DEAD] == 1).all()
    else:
        assert list(np.flatnonzero(dropped)) == list(band)
    assert ezn[11, extend.EZ_DEAD] == 0 and ezn[9, extend.EZ_DEAD] == 1
    if not am:
        assert (ezn[:, extend.EZ_MAX] > 0).sum() >= 10
        assert (ezn[:, extend.EZ_MTE] > extend.NEG_INF32).sum() >= 6


_EMU_RUNNER = r"""
// the launch on the route plan_of picks when an instantiation takes at
// most tmax threads (the slab route at least 32) and a block at most smax
// bytes of shared memory
extern "C" int emu_extd2_route(const void* qr, const void* sf,
                               const void* lens, const void* order, void* p,
                               void* ez, int N, int QP, int TP, int W, int RB,
                               int RT, int w, int q, int e, int q2, int e2,
                               int long_thres, int long_diff, int sc_mch,
                               int sc_mis, int sc_N, int with_cigar,
                               int exact, int right, int adrop, int zdrop,
                               int tmax, int smax) {
  const int tm[3] = {tmax, tmax, tmax > 32 ? tmax : 32};
  const Plan pl = plan_of(exact, W, QP, TP, tm, (size_t)smax);
  std::vector<int> rows(pl.scratch / 4 * N);
  const Extd2Args a = {(const uint8_t*)qr, (const uint8_t*)sf,
                       (const int*)lens, (const int*)order, (uint8_t*)p,
                       (int*)ez, rows.data(), QP, TP, W, RB, RT, w, q, e, q2,
                       e2, long_thres, long_diff, sc_mch, sc_mis, sc_N,
                       with_cigar, zdrop};
  const Extd2Fn fn = extd2_variant(exact, right, adrop, pl.route);
  emu_launch(N, pl.threads, [=] { fn(a); });
  return pl.route;
}

extern "C" int emu_extd2(const void* qr, const void* sf, const void* lens,
                         const void* order, void* p, void* ez, int N, int QP,
                         int TP, int W, int RB, int RT, int w, int q, int e,
                         int q2, int e2, int long_thres, int long_diff,
                         int sc_mch, int sc_mis, int sc_N, int with_cigar,
                         int exact, int right, int adrop, int zdrop) {
  return emu_extd2_route(qr, sf, lens, order, p, ez, N, QP, TP, W, RB, RT, w,
                         q, e, q2, e2, long_thres, long_diff, sc_mch, sc_mis,
                         sc_N, with_cigar, exact, right, adrop, zdrop, 1024,
                         232448);
}
"""


@pytest.fixture(scope="module")
def extd2_host(tmp_path_factory):
    """The device half of csrc/extd2.cu (everything before its host entry
    points) on the host shim, as a ctypes function."""
    lib = build_on_host("extd2", _EMU_RUNNER,
                        tmp_path_factory.mktemp("extd2_host"))
    fn, fn.route = lib.emu_extd2, lib.emu_extd2_route
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 21
    fn.route.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 23
    fn.restype = fn.route.restype = ctypes.c_int
    return fn


def _host_cases():
    """(QP, TP, W, RB, w, lens, (q, e, q2, e2), sc_mch, sc_mis, sc_N,
    with_cigar): fixed cases, then random ones from a seed."""
    sc = (Q, E, Q2, E2)
    cases = [
        # LENS at test_extd2_matches_jax's widths: chunk-boundary ends
        # (rstar 384, 256), a dead band (#6), qlen = tlen = 1 (#7)
        (256, 384, 256, 32, 150, LENS, sc, 2, -4, 0, True),
        (256, 384, 256, 64, 150, LENS, sc, 2, -4, -1, False),
        # W = w + 48 + RB/2, its least: the lanes that wrap on a chunk
        # shift enter the band within the chunk; |qlen - tlen| at, and
        # past, w - 48
        (640, 640, 256, 64, 176, [(600, 620), (300, 428), (428, 300),
                                  (200, 330), (640, 576), (97, 160)],
         sc, 2, -4, 0, True),
        (384, 512, 128, 32, 64, [(384, 400), (300, 316), (1, 9), (9, 1),
                                 (250, 270), (129, 128), (200, 184)],
         (6, 2, 26, 1), 1, -4, -1, True),
        # rstar on a chunk boundary (160 + 97 - 1 = 256), tlen = 1, qlen = 1
        (256, 256, 256, 64, 150, [(160, 97), (1, 1), (200, 1), (1, 120),
                                  (256, 256), (64, 129)],
         sc, 2, -4, 0, True),
        # the sr path's widths and scores (QP = L = 1024, TP = L + 512,
        # W = 256, band w = bw = 100; a2 b8 q12 e2 q24 e1): 150 bp ends
        # against their extents, a band that dies (|qlen - tlen| > w)
        (1024, 1536, 256, 64, 100, [(150, 150), (150, 162), (101, 96),
                                    (150, 141), (60, 170), (150, 150)],
         (12, 2, 24, 1), 2, -8, 0, True),
    ]
    rng = np.random.default_rng(11)
    for _ in range(10):
        RB = int(rng.choice([16, 32, 64]))
        W = int(rng.choice([128, 256, 384]))
        drift = -(-(RB // 2) // 16) * 16
        w = int(rng.integers(8, W - 48 - drift + 1))
        QP = int(rng.choice([64, 200, 512]))
        TP = int(rng.choice([96, 300, 512]))
        lens = []
        for _ in range(int(rng.integers(1, 9))):
            ql = int(rng.integers(1, QP + 1))
            tl = int(np.clip(ql + rng.integers(-w, w + 1), 1, TP))
            lens.append((ql, tl))
        q, e = int(rng.integers(1, 8)), int(rng.integers(1, 4))
        q2 = int(rng.integers(q, 40))
        e2 = int(rng.integers(1, e + 1))
        cases.append((QP, TP, W, RB, w, lens, (q, e, q2, e2),
                      int(rng.integers(1, 4)), -int(rng.integers(1, 8)),
                      -int(rng.integers(0, 3)), bool(rng.integers(0, 4))))
    return cases


@pytest.mark.parametrize(
    "case", _host_cases(),
    ids=lambda c: f"W{c[2]}-RB{c[3]}-w{c[4]}-n{len(c[5])}")
def test_extd2_cuda_source_on_host_matches_plain(extd2_host, case):
    QP, TP, W, RB, w, lens_l, (q, e, q2, e2), mch, mis, sc_n, cig = case
    qr, sf, lens = make_pairs(W + RB + len(lens_l), lens_l, QP, TP)
    RT = (QP + TP + RB - 1) // RB * RB
    N = len(lens_l)
    order = extend.job_order(torch.from_numpy(lens)).numpy()
    # the kernel writes every byte of p: start from garbage
    p = np.full((N, RT, W) if cig else (1,), 0xA5, np.uint8)
    ez = np.zeros((N, extend.EZ_N), np.int32)
    ins = [np.ascontiguousarray(x) for x in (qr, sf, lens, order)]
    assert extd2_host(*[x.ctypes.data for x in ins], p.ctypes.data,
                      ez.ctypes.data, N, QP, TP, W, RB, RT, w, q, e, q2, e2,
                      *extend._long_gap(q, e, q2, e2), mch, mis, sc_n,
                      int(cig), 0, 0, 0, -1) == 0
    pp, ezp = extend.extd2_batch2_plain(
        *(torch.from_numpy(x) for x in (qr, sf, lens)), W=W, RB=RB, RT=RT,
        q=q, e=e, q2=q2, e2=e2, w=w, sc_mch=mch, sc_mis=mis, sc_N=sc_n,
        with_cigar=cig)
    np.testing.assert_array_equal(ez, ezp.numpy())
    if cig:
        np.testing.assert_array_equal(p, pp.numpy())
    else:
        assert pp is None and p[0] == 0xA5


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_extd2_modes_cuda_source_on_host_matches_plain(extd2_host, mode):
    """Each mode's instantiation of csrc/extd2.cu on the host shim against
    the plain version: p and ez bit-equal on the z-drop pairs and, in the
    exact modes with z-drop, on the W = w + 48 + RB/2 case whose wrapped
    lanes (H's among them) enter the band."""
    am, rm, wc, zd, ad = mode
    cases = [(256, 256, 256, 32, 150, ZLENS, zdrop_pairs())]
    if not am and zd >= 0:
        wl = [(600, 620), (300, 428), (428, 300), (200, 330), (640, 576)]
        qr, sf, lens = make_pairs(3, wl, 640, 640)
        sf[0, 200:620] = np.random.default_rng(5).integers(0, 4, 420)
        cases.append((640, 640, 256, 64, 176, wl, (qr, sf, lens)))
    for QP, TP, W, RB, w, lens_l, (qr, sf, lens) in cases:
        RT = (QP + TP + RB - 1) // RB * RB
        N = len(lens_l)
        order = extend.job_order(torch.from_numpy(lens)).numpy()
        p = np.full((N, RT, W) if wc else (1,), 0xA5, np.uint8)
        ez = np.zeros((N, extend.EZ_N), np.int32)
        ins = [np.ascontiguousarray(x) for x in (qr, sf, lens, order)]
        sc = ZSC
        assert extd2_host(
            *[x.ctypes.data for x in ins], p.ctypes.data, ez.ctypes.data, N,
            QP, TP, W, RB, RT, w, sc["q"], sc["e"], sc["q2"], sc["e2"],
            *extend._long_gap(sc["q"], sc["e"], sc["q2"], sc["e2"]),
            sc["sc_mch"], sc["sc_mis"], sc["sc_N"], int(wc), int(not am),
            int(rm), int(ad), zd) == 0
        pp, ezp = extend.extd2_batch2_plain(
            *(torch.from_numpy(x) for x in (qr, sf, lens)), W=W, RB=RB,
            RT=RT, w=w, with_cigar=wc, approx_max=am, approx_drop=ad,
            right_mode=rm, zdrop=zd, **ZSC)
        np.testing.assert_array_equal(ez, ezp.numpy())
        if wc:
            np.testing.assert_array_equal(p, pp.numpy())
        else:
            assert pp is None and p[0] == 0xA5


# every instantiation of the modes on the two routes past one block:
# (approx_max, right_mode, approx_drop)
ROUTE_MODES = [(True, False, False), (True, True, False), (True, False, True),
               (True, True, True), (False, False, False), (False, True, False)]


@pytest.mark.parametrize("route", ["gp", "slab"])
@pytest.mark.parametrize("mode", ROUTE_MODES,
                         ids=lambda m: _mode_id((m[0], m[1], True,
                                                 400 if not m[0] or m[2]
                                                 else -1, m[2])))
def test_extd2_routes_cuda_source_on_host_matches_plain(extd2_host, mode,
                                                        route):
    """Each mode's instantiation on the route past one block's shared
    memory (the planes read from device memory: a block holds the edge
    rows and scalars and 64 bytes more here) and on the slab route (a
    block of 32 threads takes the lanes of 64 or more, a group of four at
    a time, its rows in device memory; p comes zeroed, as the wrapper
    allocates it), against the plain version: p and ez bit-equal on the
    z-drop pairs and on the W = w + 48 + RB/2 case whose wrapped lanes
    enter the band."""
    am, rm, ad = mode
    zd = 400 if not am or ad else -1
    wl = [(420, 440), (300, 428), (428, 300), (200, 330), (448, 400)]
    qr, sf, lens = make_pairs(3, wl, 448, 448)
    sf[0, 200:440] = np.random.default_rng(5).integers(0, 4, 240)
    for QP, TP, W, RB, w, (qr, sf, lens) in (
            (256, 256, 256, 32, 150, zdrop_pairs()),
            (448, 448, 256, 64, 176, (qr, sf, lens))):
        RT = (QP + TP + RB - 1) // RB * RB
        N = lens.shape[0]
        # a block holds the edge rows and scalars but not the planes
        rows = 2 * W // 4 * 16 + 64 + (0 if am else 512)
        tmax, smax = (1024, rows + 64) if route == "gp" else (32, 232448)
        order = extend.job_order(torch.from_numpy(lens)).numpy()
        p = np.zeros((N, RT, W), np.uint8)
        ez = np.zeros((N, extend.EZ_N), np.int32)
        ins = [np.ascontiguousarray(x) for x in (qr, sf, lens, order)]
        sc = ZSC
        assert extd2_host.route(
            *[x.ctypes.data for x in ins], p.ctypes.data, ez.ctypes.data, N,
            QP, TP, W, RB, RT, w, sc["q"], sc["e"], sc["q2"], sc["e2"],
            *extend._long_gap(sc["q"], sc["e"], sc["q2"], sc["e2"]),
            sc["sc_mch"], sc["sc_mis"], sc["sc_N"], 1, int(not am), int(rm),
            int(ad), zd, tmax, smax) == (1 if route == "gp" else 2)
        pp, ezp = extend.extd2_batch2_plain(
            *(torch.from_numpy(x) for x in (qr, sf, lens)), W=W, RB=RB,
            RT=RT, w=w, with_cigar=True, approx_max=am, approx_drop=ad,
            right_mode=rm, zdrop=zd, **ZSC)
        np.testing.assert_array_equal(ez, ezp.numpy())
        np.testing.assert_array_equal(p, pp.numpy())
