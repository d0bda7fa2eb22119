"""Port traceback (ops/traceback.py) vs the JAX package's traceback_batch
Pallas kernel in interpret mode, both on the direction bytes of JAX's
extd2_batch2: ops, fin and the decoded CIGARs bit-equal (tolerance 0);
and the CUDA kernel's own code (csrc/traceback.cu, on the host shim) vs
the plain version, both modes, bit-equal."""
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minimap2_tpu.ops.extend_pallas2 import extd2_batch2 as jax_extd2
from minimap2_tpu.ops.traceback_pallas import decode_ops as jax_decode
from minimap2_tpu.ops.traceback_pallas import traceback_batch as jax_tb
from minimap2_tpu_torch.ops import traceback
from cuda_host import build_on_host
from test_torch_extend import LENS, make_pairs

jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("RB,G,w", [(32, 4, 100), (64, 8, 150)])
def test_traceback_matches_jax(RB, G, w):
    QP, TP, W = 256, 384, 256
    qr, sf, lens = make_pairs(7 * RB + w, LENS, QP, TP)
    R = QP + TP
    jp, _ = jax_extd2(jnp.asarray(qr), jnp.asarray(sf), jnp.asarray(lens),
                      G=G, W=W, RB=RB, R=R, QP=QP, TP=TP, q=4, e=2, q2=24,
                      e2=1, w=w, zdrop=-1, right_mode=False, approx_max=True,
                      approx_drop=False, sc_mch=2, sc_mis=-4, sc_N=0,
                      with_cigar=True, interpret=True)
    jops, jfin = jax_tb(jp, jnp.asarray(lens), G=G, W=W, RB=RB, R=R, w=w,
                        interpret=True)
    jops, jfin = np.asarray(jops), np.asarray(jfin)
    N = len(LENS)
    NG, RC = jp.shape[:2]
    p = np.asarray(jp).transpose(0, 3, 1, 2, 4).reshape(NG * G, RC * RB,
                                                        W)[:N]
    ops, fin = traceback.traceback_batch(torch.from_numpy(p.copy()),
                                         torch.from_numpy(lens), RB=RB, w=w)
    np.testing.assert_array_equal(ops.numpy(), jops)
    np.testing.assert_array_equal(fin.numpy(), jfin)
    n_ops = 0
    for n in range(N):
        cig = traceback.decode_ops(ops.numpy()[n], int(fin[n, 0]),
                                   int(fin[n, 1]))
        assert cig == jax_decode(jops[n], int(jfin[n, 0]), int(jfin[n, 1]))
        ql, tl = lens[n]
        # a global path: the CIGAR consumes both sequences
        assert sum(c >> 4 for c in cig if c & 0xF in (0, 1)) == ql
        assert sum(c >> 4 for c in cig if c & 0xF in (0, 2)) == tl
        n_ops += sum(1 for c in cig if c & 0xF in (1, 2))
    assert n_ops > N                      # indels were traced


def test_decode_ops_leftovers():
    ops = np.zeros(12, np.uint8)
    ops[[3, 5, 6, 8]] = [1, 3, 2, 1]      # ascending r: M D I M
    for fin in ((-1, -1), (2, -1), (-1, 1)):
        assert traceback.decode_ops(ops, *fin) == jax_decode(ops, *fin)
    assert traceback.decode_ops(ops, 2, -1)[0] == (3 << 4 | 2)


_TB_RUNNER = r"""
extern "C" int emu_traceback(const void* p, const void* lens, void* ops,
                             void* fin, int N, int RT, int W, int RB, int w,
                             int splice, int QP) {
  const auto* pp = (const uint8_t*)p;
  const auto* ll = (const int*)lens;
  auto* oo = (uint8_t*)ops;
  auto* ff = (int*)fin;
  if (splice)
    emu_launch(N, 32, [=] {
      traceback_kernel<true>(pp, ll, oo, ff, RT, W, RB, w, QP); });
  else
    emu_launch(N, 32, [=] {
      traceback_kernel<false>(pp, ll, oo, ff, RT, W, RB, w, QP); });
  return 0;
}
"""


@pytest.fixture(scope="module")
def traceback_host(tmp_path_factory):
    """csrc/traceback.cu's device code on the host shim."""
    lib = build_on_host("traceback", _TB_RUNNER,
                        tmp_path_factory.mktemp("tb_host"))
    fn = lib.emu_traceback
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    fn.restype = ctypes.c_int
    return fn


def _tb_cases():
    """(splice, RT, W, RB, w, QP, lens, valid_states) cases: fixed ones,
    then random ones from a seed.  p is random bytes (with valid_states
    its low 3 bits are a ksw state 0-4), so walks take every kind of step."""
    cases = [
        # extd2 rows: a band wider than W (columns outside [0, W)), forced
        # steps (|qlen - tlen| near w), qlen or tlen of 1, a walk that
        # never starts (r >= RT), RT not a multiple of 64
        (False, 416, 64, 32, 100, 0, [(200, 210), (1, 150), (150, 1),
                                      (1, 1), (160, 60), (300, 200),
                                      (208, 208)], True),
        (False, 400, 128, 16, 40, 0, [(190, 205), (100, 140), (60, 20),
                                      (2, 3), (120, 121)], False),
        (False, 640, 256, 64, 150, 0, [(320, 318), (300, 250), (17, 30),
                                       (321, 321), (64, 64)], True),
        # splice rows: the band unbounded, W < qlen (columns outside),
        # intron state 3 emitting op 4
        (True, 448, 96, 64, 0, 64, [(64, 300), (40, 380), (1, 200),
                                    (64, 1), (64, 385), (20, 20)], True),
        (True, 320, 160, 32, 0, 128, [(128, 190), (100, 150), (128, 193),
                                      (5, 250)], False),
    ]
    rng = np.random.default_rng(5)
    for _ in range(6):
        splice = bool(rng.integers(2))
        RB = int(rng.choice([16, 32, 64]))
        W = int(rng.choice([48, 64, 128, 192]))
        RT = int(rng.integers(4, 12)) * RB
        QP = int(rng.choice([32, 64, 128])) if splice else 0
        w = 0 if splice else int(rng.integers(4, 2 * W))
        lens = [(int(rng.integers(1, RT // 2 + 8)),
                 int(rng.integers(1, RT // 2 + 8)))
                for _ in range(int(rng.integers(1, 7)))]
        cases.append((splice, RT, W, RB, w, QP, lens,
                      bool(rng.integers(2))))
    return cases


@pytest.mark.parametrize("case", _tb_cases(), ids=lambda c: (
    f"{'splice' if c[0] else 'extd2'}-RT{c[1]}-W{c[2]}-n{len(c[6])}"))
def test_traceback_cuda_source_on_host_matches_plain(traceback_host, case):
    splice, RT, W, RB, w, QP, lens_l, valid = case
    rng = np.random.default_rng(RT * W + len(lens_l))
    N = len(lens_l)
    p = rng.integers(0, 256, (N, RT, W), dtype=np.uint8)
    if valid:
        p = (p & 0xF8) | rng.integers(0, 5, p.shape, dtype=np.uint8)
    lens = np.array(lens_l, np.int32)
    ops = np.full((N, RT), 0xA5, np.uint8)    # the kernel writes every byte
    fin = np.full((N, 2), -7, np.int32)
    assert traceback_host(p.ctypes.data, lens.ctypes.data, ops.ctypes.data,
                          fin.ctypes.data, N, RT, W, RB, w, int(splice),
                          QP) == 0
    want_ops, want_fin = traceback.traceback_batch_plain(
        torch.from_numpy(p), torch.from_numpy(lens), RB=RB, w=w,
        splice=splice, QP=QP)
    np.testing.assert_array_equal(ops, want_ops.numpy())
    np.testing.assert_array_equal(fin, want_fin.numpy())


def test_traceback_host_cases_cover_the_edges():
    """The fixed cases above reach what they are meant to: M steps from
    a chunk's lowest diagonal (r % 64 == 0, landing on r - 2), steps the
    band forces (|i - j| > w on extd2's rows), intron ops and walks that
    never start."""
    edge_m = forced = introns = unstarted = 0
    for splice, RT, W, RB, w, QP, lens_l, valid in _tb_cases()[:5]:
        rng = np.random.default_rng(RT * W + len(lens_l))
        N = len(lens_l)
        p = rng.integers(0, 256, (N, RT, W), dtype=np.uint8)
        if valid:
            p = (p & 0xF8) | rng.integers(0, 5, p.shape, dtype=np.uint8)
        ops, fin = traceback.traceback_batch_plain(
            torch.from_numpy(p), torch.from_numpy(np.array(lens_l, np.int32)),
            RB=RB, w=w, splice=splice, QP=QP)
        ops = ops.numpy()
        r = np.arange(64, RT, 64)
        edge_m += int(((ops[:, r] == 1) & (ops[:, r - 1] == 0)).sum())
        introns += int((ops == 4).sum())
        unstarted += sum(ql + tl - 2 >= RT for ql, tl in lens_l)
        for n, (ql, tl) in enumerate(lens_l):
            i, j = tl - 1, ql - 1           # replay the walk from its ops
            for op in ops[n, ::-1][ops[n, ::-1] != 0]:
                forced += not splice and abs(i - j) > w
                i -= op != 2
                j -= op in (1, 2)
    assert edge_m and forced and introns and unstarted
