"""The port's one-call device step vs the JAX package (tolerance 0):

(a) map_batch on the world of the JAX package's test_map_batch_single_device
    (a 20 kb genome, 8 reads of 300-511 bp with 5% substitutions, half
    reverse-complemented; L 512, A 256, QP = TP 512, W 256): every key of
    the result dict equal to JAX map_batch(interpret=True), at pos_fmt 1
    (S one code a byte) and pos_fmt 2 (two codes a byte, u32 offsets);
(b) extd2 in map_batch's score-only mode: zdrop is inert there, so
    zdrop=400 gives what zdrop=-1 gives, and both equal the JAX Pallas
    kernel in interpret mode (every ez lane).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.ops.extend_pallas2 import extd2_batch2 as jax_extd2
from minimap2_tpu.parallel import batch as jax_batch
from minimap2_tpu.utils.intfloat import SEQ_NT4
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.ops import extend
from minimap2_tpu_torch.parallel import batch

jax.config.update("jax_platforms", "cpu")

SHAPE = dict(L=512, M=128, A=256, QP=512, TP=512, W=256, ext_w=200,
             chain_window=32)


@pytest.fixture(scope="module")
def tiny_world():
    """tests/test_batch.py's tiny_world and _sim, in the same rng order."""
    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGT"), 20000))
    B, L = 8, SHAPE["L"]
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    truth = []
    for i in range(B):
        st = int(rng.integers(0, len(ref) - 600))
        ln = int(rng.integers(300, L))
        seq = SEQ_NT4[np.frombuffer(ref[st:st + ln].encode(),
                                    np.uint8)].copy()
        mut = rng.random(ln) < 0.05
        seq[mut] = rng.integers(0, 4, int(mut.sum()))
        if i % 2:
            seq = (3 - seq)[::-1].copy()
        codes[i, :ln] = seq
        lens[i] = ln
        truth.append((st, st + ln, i % 2))
    return ref, codes, lens, truth


@pytest.mark.parametrize("pos_fmt", [1, 2])
def test_map_batch_matches_jax(tiny_world, pos_fmt):
    ref, codes, lens, truth = tiny_world
    jdi = jax_batch.DeviceIndex.from_host(
        JaxMiniIndex.build(["chr1"], [ref], w=10, k=15), 1,
        force_pos_fmt=pos_fmt)[0]
    want = jax_batch.map_batch(jdi, jnp.asarray(codes), jnp.asarray(lens),
                               jax_batch.BatchParams(**SHAPE), interpret=True)
    di = batch.DeviceIndex.from_host(
        MiniIndex.build(["chr1"], [ref], w=10, k=15), "cpu",
        force_pos_fmt=pos_fmt)
    assert (di.pos_fmt, di.s_fmt) == (pos_fmt, pos_fmt - 1)
    got = batch.map_batch(di, torch.from_numpy(codes), torch.from_numpy(lens),
                          batch.BatchParams(**SHAPE))
    assert set(got) == set(want)
    for k, w_ in want.items():
        w_ = np.asarray(w_)
        assert got[k].numpy().dtype == w_.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w_, err_msg=k)
    # the JAX package's own gates on this world hold
    for i, (st, en, rv) in enumerate(truth):
        assert got["chain_score"][i] > 50 and got["ext_score"][i] > 0
        assert int(got["rev"][i]) == rv
        assert st - 150 <= got["rs"][i] and got["re"][i] <= en + 150


def test_extd2_score_only_zdrop_matches_jax():
    """G 16, RB 128, W 256 as in _extend_best, on 24 random jobs: related
    pairs with substitutions and indels, unrelated pairs whose score
    falls far below its max (where a z-drop would act), and pairs shorter
    than a chunk."""
    rng = np.random.default_rng(41)
    N, QP, TP = 24, 384, 384
    qr = np.full((N, QP), 4, np.uint8)
    sf = np.full((N, TP), 4, np.uint8)
    lens = np.zeros((N, 2), np.int32)
    for n in range(N):
        tl = int(rng.integers(20, TP))
        t = rng.integers(0, 4, tl).astype(np.uint8)
        if n % 3 == 2:
            q = rng.integers(0, 4, int(rng.integers(20, QP))).astype(np.uint8)
        else:
            q = t.copy()
            m = rng.random(tl) < 0.08
            q[m] = rng.integers(0, 4, int(m.sum()))
            if n % 3 == 1 and tl > 60:
                q = np.concatenate([q[:tl // 2], q[tl // 2 + 12:]])
            q = q[:QP]
        sf[n, :tl] = t
        qr[n, :len(q)] = q[::-1]
        lens[n] = (len(q), tl)
    kw = dict(G=16, W=256, RB=128, R=QP + TP - 1, QP=QP, TP=TP, q=4, e=2,
              q2=24, e2=1, w=144, right_mode=False, approx_max=True,
              approx_drop=False, sc_mch=2, sc_mis=-4, sc_N=-1)
    args = [torch.from_numpy(x) for x in (qr, sf, lens)]
    p0, ez0 = extend.extd2_batch2(*args, zdrop=-1, with_cigar=False, **kw)
    p1, ez1 = extend.extd2_batch2(*args, zdrop=400, with_cigar=False, **kw)
    assert p0 is None and p1 is None
    np.testing.assert_array_equal(ez1.numpy(), ez0.numpy())
    _, jez = jax_extd2(jnp.asarray(qr), jnp.asarray(sf), jnp.asarray(lens),
                       zdrop=400, with_cigar=False, interpret=True, **kw)
    np.testing.assert_array_equal(ez1.numpy(), np.asarray(jez))
    sc = ez1.numpy()[:, extend.EZ_SCORE]
    assert (sc > 100).sum() >= 8 and (sc < 0).sum() >= 4
