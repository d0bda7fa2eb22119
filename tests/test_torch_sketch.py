"""Port sketch vs the JAX package: hash64_pair, and the plain version of
the sketch kernel against sketch_pallas.sketch_batch (interpret mode) and
batch.device_sketch on reads with N runs and ragged lengths, and with the
validity plane on rows with N runs and the index build's code-5
separators; and the CUDA kernel's own code (csrc/sketch.cu on the host
shim) vs the plain version, all five planes.  Integer planes compare
exactly (tolerance 0)."""
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minimap2_tpu.ops.sketch_pallas import sketch_batch as jax_sketch_batch
from minimap2_tpu.parallel import batch as jb
from minimap2_tpu_torch.ops.sketch import device_sketch, sketch_batch
from minimap2_tpu_torch.parallel import batch as tb
from cuda_host import build_on_host

jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("k", [15, 19, 28])
def test_hash64_pair_matches_jax(k):
    rng = np.random.default_rng(k)
    mask = (1 << (2 * k)) - 1
    keys = rng.integers(0, mask + 1, 512, dtype=np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = keys.astype(np.uint32)
    jh, jl = jb.hash64_pair(jnp.asarray(hi), jnp.asarray(lo),
                            mask >> 32, mask & 0xFFFFFFFF)
    th, tl = tb.hash64_pair(torch.from_numpy(hi.view(np.int32)),
                            torch.from_numpy(lo.view(np.int32)),
                            mask >> 32, mask & 0xFFFFFFFF)
    np.testing.assert_array_equal(th.numpy().view(np.uint32), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy().view(np.uint32), np.asarray(jl))


def _reads(seed, B=8, L=1024):
    """nt4 codes with N runs, ragged lengths and garbage past the end."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for b in range(B):
        for _ in range(3):
            st = int(rng.integers(0, L - 40))
            codes[b, st:st + int(rng.integers(1, 30))] = 4
    lens = rng.integers(L // 3, L + 1, B).astype(np.int32)
    lens[0] = L
    lens[1] = 5            # shorter than k
    for b in range(2, B, 3):
        codes[b, lens[b]:] = 4
    return codes, lens


@pytest.mark.parametrize("k,w", [(15, 10), (16, 8), (19, 19), (21, 11)])
def test_plain_sketch_matches_jax(k, w):
    codes, lens = _reads(k * 31 + w)
    hhi, hlo, z, mini = (x.numpy() for x in sketch_batch(
        torch.from_numpy(codes), torch.from_numpy(lens), k, w))
    # the XLA twin: every plane at every position
    dh, dl, dz, dm = (np.asarray(x) for x in jb.device_sketch(
        jnp.asarray(codes), jnp.asarray(lens), k, w))
    np.testing.assert_array_equal(hhi.view(np.uint32), dh)
    np.testing.assert_array_equal(hlo.view(np.uint32), dl)
    np.testing.assert_array_equal(z, dz)
    np.testing.assert_array_equal(mini, dm)
    # the Pallas kernel: is_mini and valid everywhere, hash and strand on
    # valid positions (elsewhere its neighbour blocks hold garbage)
    ph, pl_, pz, pm, pv = (np.asarray(x) for x in jax_sketch_batch(
        jnp.asarray(codes), jnp.asarray(lens), G=8, T=512, k=k, w=w,
        interpret=True))
    np.testing.assert_array_equal(mini, pm)
    assert mini.sum() > 100
    v = pv.astype(bool)
    np.testing.assert_array_equal(hhi.view(np.uint32)[v], ph[v])
    np.testing.assert_array_equal(hlo.view(np.uint32)[v], pl_[v])
    np.testing.assert_array_equal(z[v], pz[v])


def _build_rows(seed, B=4, L=2048, k=15, w=10):
    """Rows as the index build cuts them: sequences between runs of code-5
    separators (k + 2w - 3 rounded up to 32 wide), N runs (code 4) inside
    them, every row full length."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    ov = (k + 2 * w - 3 + 31) // 32 * 32
    for b in range(B):
        for _ in range(3):
            st = int(rng.integers(0, L - ov))
            codes[b, st:st + ov] = 5
        for _ in range(4):
            st = int(rng.integers(0, L - 40))
            codes[b, st:st + int(rng.integers(1, 30))] = 4
    codes[0, :ov] = 5
    codes[-1, -ov:] = 5
    return codes, np.full(B, L, np.int32)


@pytest.mark.parametrize("k,w", [(15, 10), (19, 5)])
def test_plain_sketch_valid_matches_jax(k, w):
    """device_sketch(with_valid=True) against the Pallas kernel's five
    outputs and batch.device_sketch(with_valid=True)."""
    codes, lens = _build_rows(k + w, k=k, w=w)
    got = [x.numpy() for x in device_sketch(
        torch.from_numpy(codes), torch.from_numpy(lens), k, w,
        with_valid=True)]
    assert len(got) == 5
    hhi, hlo, z, mini, valid = got
    want = [np.asarray(x) for x in jb.device_sketch(
        jnp.asarray(codes), jnp.asarray(lens), k, w, with_valid=True)]
    for name, g, x in zip(("hhi", "hlo", "z", "is_mini", "valid"), got,
                          want):
        np.testing.assert_array_equal(
            g.view(np.uint32) if g.dtype == np.int32 else g, x, err_msg=name)
    ph, pl_, pz, pm, pv = (np.asarray(x) for x in jax_sketch_batch(
        jnp.asarray(codes), jnp.asarray(lens), G=4, T=512, k=k, w=w,
        interpret=True))
    np.testing.assert_array_equal(valid, pv)
    np.testing.assert_array_equal(mini, pm)
    v = pv.astype(bool)
    np.testing.assert_array_equal(hhi.view(np.uint32)[v], ph[v])
    np.testing.assert_array_equal(hlo.view(np.uint32)[v], pl_[v])
    np.testing.assert_array_equal(z[v], pz[v])
    assert 0 < valid.sum() < valid.size and mini.sum() > 100
    # a k-mer holding a separator or an N is never valid
    amb = np.cumsum(codes >= 4, axis=1)
    back = np.concatenate([np.zeros((codes.shape[0], k), amb.dtype),
                           amb[:, :-k]], axis=1)
    assert not (valid & (amb != back)).any()


def test_device_sketch_is_the_plain_version():
    codes, lens = _reads(3, B=2, L=256)
    a = sketch_batch(torch.from_numpy(codes), torch.from_numpy(lens), 15, 10)
    b = device_sketch(torch.from_numpy(codes), torch.from_numpy(lens), 15, 10)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


_SKETCH_RUNNER = r"""
extern "C" int emu_sketch(const void* codes, const void* lens, void* hhi,
                          void* hlo, void* z, void* is_mini, void* valid,
                          int B, int L, int k, int w) {
  const Shape sh = shape_of(L, w);
  emu_launch(B * sh.n_tiles, sh.threads, [=] {
    sketch_kernel((const uint8_t*)codes, (const int32_t*)lens,
                  (uint32_t*)hhi, (uint32_t*)hlo, (uint8_t*)z,
                  (uint8_t*)is_mini, (uint8_t*)valid, L, k, w, sh.tile,
                  sh.n_tiles, sh.HL);
  });
  return 0;
}
"""


@pytest.fixture(scope="module")
def sketch_host(tmp_path_factory):
    """csrc/sketch.cu's device code on the host shim, as mm2_sketch."""
    fn = build_on_host("sketch", _SKETCH_RUNNER,
                       tmp_path_factory.mktemp("sketch_host")).emu_sketch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("k,w,B,L", [(15, 10, 6, 1024), (19, 10, 6, 1024),
                                     (15, 5, 6, 1024), (19, 19, 6, 1024),
                                     (21, 11, 6, 1024),
                                     (28, 98, 6, 600), (15, 10, 2, 4112),
                                     (15, 10, 2, 8192)])
def test_sketch_cuda_source_on_host_matches_plain(sketch_host, k, w, B, L):
    """The kernel's own code against device_sketch at every position,
    invalid ones included (rows shorter than k, N runs, garbage past the
    end), all five planes; L = 600 is not a multiple of 16 (the unaligned
    loads and stores) and w + k - 2 there spans eight 16-code pieces; L =
    4112 takes two 2048-position tiles and a partial third (the halos
    between tiles); L = 8192 is the index build's row, with code-5
    separator runs and N runs."""
    codes, lens = _reads(k * 31 + w, B=B, L=L) if L != 8192 else \
        _build_rows(k * 31 + w, B=B, L=L, k=k, w=w)
    outs = [np.full((B, L), 0x55, dt) for dt in
            (np.int32, np.int32, np.uint8, np.uint8, np.uint8)]
    assert sketch_host(codes.ctypes.data, lens.ctypes.data,
                       *(o.ctypes.data for o in outs), B, L, k, w) == 0
    want = device_sketch(torch.from_numpy(codes), torch.from_numpy(lens),
                         k, w, with_valid=True)
    for name, g, x in zip(("hhi", "hlo", "z", "is_mini", "valid"), outs,
                          want):
        np.testing.assert_array_equal(g, x.numpy().astype(g.dtype),
                                      err_msg=name)
    assert want[3].sum() > L // w          # minimizers found
    assert 0 < want[4].sum() < B * L


def test_sketch_cuda_source_on_host_without_valid(sketch_host):
    """With no valid buffer (the mapping path's call) the kernel writes the
    other four planes as before."""
    B, L, k, w = 3, 1024, 15, 10
    codes, lens = _reads(5, B=B, L=L)
    outs = [np.full((B, L), 0x55, dt) for dt in
            (np.int32, np.int32, np.uint8, np.uint8)]
    assert sketch_host(codes.ctypes.data, lens.ctypes.data,
                       *(o.ctypes.data for o in outs), None, B, L, k,
                       w) == 0
    want = device_sketch(torch.from_numpy(codes), torch.from_numpy(lens),
                         k, w)
    for name, g, x in zip(("hhi", "hlo", "z", "is_mini"), outs, want):
        np.testing.assert_array_equal(g, x.numpy().astype(g.dtype),
                                      err_msg=name)
