"""Port device genome (utils/jrandom.py, utils/simgenome_dev.py) vs the
JAX package, bit for bit: threefry keys and draws against jax.random, the
genome and the GRCh38-shaped envelope against simgenome_dev's, the
satellite regions, and the reads sliced from the same genome."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minimap2_tpu.utils import simgenome_dev as jsd
from minimap2_tpu_torch.utils import jrandom as jr
from minimap2_tpu_torch.utils import simgenome_dev as tsd

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs in several
    worker processes at once, and a thread pool in each, synchronising
    at every elementwise pass, then waits on threads the others hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


def test_keys_match_jax():
    """PRNGKey, split and fold_in chains give JAX's raw key words."""
    for seed in (0, 1, 7, 8, 123456789, (1 << 32) - 1):
        jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
        assert _key(jk) == tk
        for step in range(6):
            if step % 2:
                jk, tk = jax.random.fold_in(jk, 0xA11 + step), \
                    jr.fold_in(tk, 0xA11 + step)
            else:
                js = jax.random.split(jk, 5 + step)
                ts = jr.split(tk, 5 + step)
                assert [_key(x) for x in js] == ts
                jk, tk = js[-1], ts[-1]
            assert _key(jk) == tk


SHAPES = [(1,), (7,), (1000,), (3, 5), (11, 13), (4, 7, 3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_randint_matches_jax(shape):
    jk, tk = jax.random.PRNGKey(42), jr.PRNGKey(42)
    for i, (lo, hi) in enumerate([(0, 4), (0, 256), (3, 200), (7, 3)]):
        a = jax.random.randint(jax.random.fold_in(jk, i), shape, lo, hi,
                               jnp.uint8)
        b = jr.randint(jr.fold_in(tk, i), shape, lo, hi, torch.uint8)
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for i, (lo, hi) in enumerate([(500, 6001), (-1_000_000, 1_000_000),
                                  (0, 125_000_000), (-(1 << 31), 1 << 30),
                                  (20_000, 100_000), (5, 5)]):
        a = jax.random.randint(jax.random.fold_in(jk, 10 + i), shape, lo, hi,
                               jnp.int32)
        b = jr.randint(jr.fold_in(tk, 10 + i), shape, lo, hi)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # array bounds, broadcast over the last axis
    n = shape[-1]
    lo = np.arange(n, dtype=np.int32) * 37 - 50
    hi = lo + 1 + np.arange(n, dtype=np.int32) * 1001
    a = jax.random.randint(jk, shape, jnp.asarray(lo), jnp.asarray(hi),
                           jnp.int32)
    b = jr.randint(tk, shape, torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    a = jax.random.randint(jk, shape, jnp.asarray(lo % 7),
                           jnp.asarray(hi % 250 + 7), jnp.uint8)
    b = jr.randint(tk, shape, torch.from_numpy(lo % 7),
                   torch.from_numpy(hi % 250 + 7), torch.uint8)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_randint_scalar_matches_jax():
    jk = jax.random.split(jax.random.PRNGKey(9), 40)
    tk = jr.split(jr.PRNGKey(9), 40)
    for i, (lo, hi) in enumerate([(20_000, 100_000), (0, 2_900_000),
                                  (0, 1), (4, 4), (-5, 70_000)] * 8):
        a = int(jax.random.randint(jk[i], (), lo, hi, jnp.int32))
        assert jr.randint_scalar(tk[i], lo, hi) == a
        assert int(jr.randint(tk[i], (), lo, hi)) == a


@pytest.mark.parametrize("shape", SHAPES + [(200_000,)])
def test_uniform_matches_jax(shape):
    """200k draws make XLA CPU's fused multiply-add in floats * (max -
    min) + min show (one rounding, not two)."""
    jk, tk = jax.random.PRNGKey(3), jr.PRNGKey(3)
    for i, (lo, hi) in enumerate([(0.0, 1.0), (0.05, 0.20), (0.05, 0.15),
                                  (-2.5, 7.25)]):
        a = np.asarray(jax.random.uniform(jax.random.fold_in(jk, i), shape,
                                          minval=lo, maxval=hi))
        b = jr.uniform(jr.fold_in(tk, i), shape, lo, hi).numpy()
        np.testing.assert_array_equal(b.view(np.uint32), a.view(np.uint32))


@pytest.fixture(scope="module")
def genomes():
    """The 2.4 Mb / 8-contig genome from both packages (smaller totals
    break the generator: a 100 kb segdup block needs ~110 kb contigs)."""
    jn, jp = jsd.simulate_genome_device(2_400_000, 8, 7)
    tn, tp = tsd.simulate_genome_device(2_400_000, 8, 7, device="cpu")
    return jn, jp, tn, tp


def test_simulate_genome_matches_jax(genomes):
    jn, jp, tn, tp = genomes
    assert tn == jn
    for a, b in zip(jp, tp):
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    c = tsd.simulate_contig(7, 5, 300_000, device="cpu")
    np.testing.assert_array_equal(c.numpy(), np.asarray(jp[5]))


def test_write_genome_fasta_host(genomes, tmp_path):
    """A genome regenerated on the CPU and written as FASTA reads back as
    the JAX package's: one contig of 300 kb is the 2.4 Mb genome's chr1
    (the same key and length)."""
    from minimap2_tpu_torch.io.fastx import read_fasta
    from minimap2_tpu_torch.utils.intfloat import SEQ_NT4
    jn, jp, _, _ = genomes
    path = str(tmp_path / "g.fa")
    assert tsd.write_genome_fasta_host(path, 300_000, 1, 7) == jn[:1]
    names, seqs = read_fasta(path)
    assert names == jn[:1]
    np.testing.assert_array_equal(SEQ_NT4[np.frombuffer(seqs[0], np.uint8)],
                                  np.asarray(jp[0]))


def test_grch38_envelope_matches_jax():
    jn, jp = jsd.grch38_envelope_parts(8_000_000, 26)
    tn, tp = tsd.grch38_envelope_parts(8_000_000, 26, device="cpu")
    assert tn == jn and len(tp) == 26
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    (_, _, _), (ts, ns, ss) = tsd.grch38_parts_plan(8_000_000, 26)
    np.testing.assert_array_equal(
        tsd.simulate_contig(ss, 1, ts // ns, device="cpu").numpy(),
        np.asarray(jp[25]))


def test_satellite_regions_match_jax():
    for P, n, seed in ((300_000, 8, 7), (125_000_000, 24, 7),
                       (543_859, 3, 8)):
        want = jsd.satellite_regions(P, n, seed)
        got = tsd.satellite_regions(P, n, seed)
        assert len(got) == len(want) == n
        for (gc, gl), (wc, wl) in zip(got, want):
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("region", [None, "satellite"])
def test_simulate_reads_match_jax(genomes, region):
    jn, jp, tn, tp = genomes
    want = jsd.simulate_reads_device(jp, 40, seed=3, names=jn,
                                     region=region, min_len=2000,
                                     max_len=5000)
    got = tsd.simulate_reads_device(tp, 40, seed=3, names=tn,
                                    region=region, min_len=2000,
                                    max_len=5000)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


def test_simulate_reads_clr_match_jax(genomes):
    jn, jp, tn, tp = genomes
    want = jsd.simulate_reads_device_clr(jp, 12, names=jn)
    got = tsd.simulate_reads_device_clr(tp, 12, names=tn)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
