"""Port traceback (ops/traceback.py) vs the JAX package's traceback_batch
Pallas kernel in interpret mode, both on the direction bytes of JAX's
extd2_batch2: ops, fin and the decoded CIGARs bit-equal (tolerance 0)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minimap2_tpu.ops.extend_pallas2 import extd2_batch2 as jax_extd2
from minimap2_tpu.ops.traceback_pallas import decode_ops as jax_decode
from minimap2_tpu.ops.traceback_pallas import traceback_batch as jax_tb
from minimap2_tpu_torch.ops import traceback
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
