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
    z = torch.zeros((1, 128), dtype=torch.uint8)
    lens = torch.ones((1, 2), dtype=torch.int32)
    kw = dict(G=1, W=128, RB=32, R=256, QP=128, TP=128, q=Q, e=E, q2=Q2,
              e2=E2, w=40, zdrop=-1, right_mode=False, approx_max=True,
              approx_drop=False, sc_mch=2, sc_mis=-4, sc_N=0)
    for bad in (dict(approx_max=False), dict(zdrop=400, approx_drop=True),
                dict(approx_drop=True), dict(right_mode=True)):
        with pytest.raises(NotImplementedError):
            extend.extd2_batch2(z, z, lens, **{**kw, **bad})
    with pytest.raises(ValueError):
        extend.extd2_batch2(z, z, lens, **{**kw, "w": 100})


_EMU_RUNNER = r"""
extern "C" int emu_extd2(const void* qr, const void* sf, const void* lens,
                         const void* order, void* p, void* ez, int N, int QP,
                         int TP, int W, int RB, int RT, int w, int q, int e,
                         int q2, int e2, int long_thres, int long_diff,
                         int sc_mch, int sc_mis, int sc_N, int with_cigar) {
  emu_launch(N, W / GL, [=] {
    extd2_kernel((const uint8_t*)qr, (const uint8_t*)sf, (const int*)lens,
                 (const int*)order, (uint8_t*)p, (int*)ez, QP, TP, W, RB, RT,
                 w, q, e, q2, e2, long_thres, long_diff, sc_mch, sc_mis, sc_N,
                 with_cigar);
  });
  return 0;
}
"""


@pytest.fixture(scope="module")
def extd2_host(tmp_path_factory):
    """The device half of csrc/extd2.cu (everything before its host entry
    points) on the host shim, as a ctypes function."""
    fn = build_on_host("extd2", _EMU_RUNNER,
                       tmp_path_factory.mktemp("extd2_host")).emu_extd2
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17
    fn.restype = ctypes.c_int
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
                      int(cig)) == 0
    pp, ezp = extend.extd2_batch2_plain(
        *(torch.from_numpy(x) for x in (qr, sf, lens)), W=W, RB=RB, RT=RT,
        q=q, e=e, q2=q2, e2=e2, w=w, sc_mch=mch, sc_mis=mis, sc_N=sc_n,
        with_cigar=cig)
    np.testing.assert_array_equal(ez, ezp.numpy())
    if cig:
        np.testing.assert_array_equal(p, pp.numpy())
    else:
        assert pp is None and p[0] == 0xA5
