"""Port extd2 (ops/extend.py) vs the JAX package's extd2_batch2 Pallas
kernel in interpret mode: p and ez bit-equal (tolerance 0) on pairs with
substitutions, indels and N runs, including pairs that end exactly on a
chunk boundary (EZ_DEAD's group rule) and pairs whose band dies."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minimap2_tpu.ops.extend_pallas2 import extd2_batch2 as jax_extd2
from minimap2_tpu_torch.ops import extend

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
    for bad in (dict(approx_max=False), dict(zdrop=400),
                dict(approx_drop=True), dict(right_mode=True)):
        with pytest.raises(NotImplementedError):
            extend.extd2_batch2(z, z, lens, **{**kw, **bad})
    with pytest.raises(ValueError):
        extend.extd2_batch2(z, z, lens, **{**kw, "w": 100})
