"""Port 3-plane bitonic sort vs sort_pallas in interpret mode: sort3_rows
at widths 256 and 4096 and sort3_chunked at 16384, with duplicate keys
and sentinel lanes; and the CUDA kernels' own code (csrc/sort3.cu and
csrc/sort1.cu on the host shim) vs the plain versions.  Planes compare
exactly."""
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minimap2_tpu.ops import sort_pallas
from minimap2_tpu_torch.ops import sort as tsort
from cuda_host import build_on_host

jax.config.update("jax_platforms", "cpu")


def _planes(seed, B, A):
    """Three u32 planes: small key ranges (many duplicate triples),
    sentinel lanes, and values with the top bit set."""
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, 6, (B, A)).astype(np.uint32)
    k1[rng.random((B, A)) < 0.2] = 0xFFFFFFFF
    k1[rng.random((B, A)) < 0.1] = 0x7FFFFFFF
    k2 = rng.integers(0, 4, (B, A)).astype(np.uint32) << np.uint32(30)
    k3 = rng.integers(0, 1 << 32, (B, A), dtype=np.uint64).astype(np.uint32)
    k3[:, 1::2] = k3[:, ::2] & np.uint32(0x80000003)
    return k1, k2, k3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))


@pytest.mark.parametrize("A", [256, 4096])
def test_sort3_rows_matches_pallas(A):
    k1, k2, k3 = _planes(A, 8, A)
    want = sort_pallas.sort3_rows(jnp.asarray(k1), jnp.asarray(k2),
                                  jnp.asarray(k3), G=8, interpret=True)
    _check(tsort.sort3_rows(_t(k1), _t(k2), _t(k3)), want)


def test_sort3_chunked_matches_pallas(monkeypatch):
    k1, k2, k3 = _planes(16384, 8, 16384)
    orig = sort_pallas.sort3_rows
    monkeypatch.setattr(sort_pallas, "sort3_rows",
                        lambda a, b, c, G=8, interpret=False:
                        orig(a, b, c, G=G, interpret=True))
    want = sort_pallas.sort3_chunked(jnp.asarray(k1), jnp.asarray(k2),
                                     jnp.asarray(k3), chunk=2048, keep=1024,
                                     G=8)
    got = tsort.sort3_chunked(_t(k1), _t(k2), _t(k3), chunk=2048, keep=1024)
    assert got[0].shape == (8, 8192)
    _check(got, want)


@pytest.mark.parametrize("A", [32768, 24576])
def test_sort3_wide_matches_plain(A):
    """The wide route (three stable sorts) on rows past sort.MAX_WIDTH:
    the plain network's planes, at a power of two and, through the
    anchor sort's sort_keys, at a width it pads (the sentinel lanes sort
    last, so the first A lanes agree)."""
    from minimap2_tpu_torch.parallel import batch as tbatch
    k1, k2, k3 = _planes(A, 4, A)
    keys = [_t(k1), _t(k2), _t(k3)]
    got = tbatch.sort_keys(keys)
    Ap = 1 << (A - 1).bit_length()
    padded = [torch.cat([x, x.new_full((4, Ap - A), -1)], dim=1)
              for x in keys]
    want = tsort.sort3_rows_plain(*padded)
    assert got[0].shape == (4, A)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w[:, :A].numpy())
    for g, w in zip(tsort.sort3_wide(*keys), got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_sort3_rows_is_a_sort():
    k1, k2, k3 = _planes(5, 4, 1024)
    got = [g.numpy().view(np.uint32)
           for g in tsort.sort3_rows(_t(k1), _t(k2), _t(k3))]
    for b in range(4):
        want = sorted(zip(k1[b].tolist(), k2[b].tolist(), k3[b].tolist()))
        assert list(zip(*(g[b].tolist() for g in got))) == want


_SORT3_RUNNER = r"""
#include <type_traits>
template <int E>
void emu_sort3_e(const void* k1, const void* k2, const void* k3, void* o1,
                 void* o2, void* o3, int rows, int A, int kk0, int keep,
                 int flip) {
  emu_launch(rows, A / E, [=] {
    sort3_kernel<E>((const uint32_t*)k1, (const uint32_t*)k2,
                    (const uint32_t*)k3, (uint32_t*)o1, (uint32_t*)o2,
                    (uint32_t*)o3, A, kk0, keep, flip);
  });
}
extern "C" int emu_sort3(const void* k1, const void* k2, const void* k3,
                         void* o1, void* o2, void* o3, int rows, int A,
                         int kk0, int keep, int flip) {
  switch (lanes_per_thread(A)) {
    case 2: emu_sort3_e<2>(k1, k2, k3, o1, o2, o3, rows, A, kk0, keep, flip);
            return 0;
    case 4: emu_sort3_e<4>(k1, k2, k3, o1, o2, o3, rows, A, kk0, keep, flip);
            return 0;
    case 8: emu_sort3_e<8>(k1, k2, k3, o1, o2, o3, rows, A, kk0, keep, flip);
            return 0;
    case 16: emu_sort3_e<16>(k1, k2, k3, o1, o2, o3, rows, A, kk0, keep,
                             flip);
             return 0;
  }
  return 1;
}
"""


@pytest.fixture(scope="module")
def sort3_host(tmp_path_factory):
    """csrc/sort3.cu's device code on the host shim: fn(planes, A, kk0,
    keep, flip) -> the (rows, keep) planes, as mm2_sort3_ex."""
    fn = build_on_host("sort3", _SORT3_RUNNER,
                       tmp_path_factory.mktemp("sort3_host")).emu_sort3
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int

    def run(planes, A, kk0, keep, flip):
        ins = [np.ascontiguousarray(x, np.uint32).reshape(-1, A)
               for x in planes]
        rows = ins[0].shape[0]
        outs = [np.full((rows, keep), 0xDEADBEEF, np.uint32)
                for _ in range(3)]
        assert fn(*(x.ctypes.data for x in ins),
                  *(o.ctypes.data for o in outs), rows, A, kk0, keep,
                  int(flip)) == 0
        return outs
    return run


@pytest.mark.parametrize("A", [2, 8, 16, 64, 512, 1024, 2048])
def test_sort3_cuda_source_on_host_matches_plain(sort3_host, A):
    """The kernel's own code, every tier (registers, shuffles, shared
    memory from 1024 lanes up) against the plain version, bit-equal."""
    k1, k2, k3 = _planes(A + 1, 3, A)
    got = sort3_host((k1, k2, k3), A, 2, A, False)
    _check([_t(g) for g in got],
           [w.numpy().view(np.uint32)
            for w in tsort.sort3_rows_plain(_t(k1), _t(k2), _t(k3))])


@pytest.mark.parametrize("B,A,seed", [(2, 16384, 1024), (3, 2048, 3)])
def test_sort3_chunked_cuda_source_on_host_matches_plain(sort3_host, B, A,
                                                         seed):
    """sort3_chunked's launches as the wrapper plans them (chunk 2048, keep
    1024): with C = A / chunk = 8 pieces a row, odd runs stored reversed,
    then the merge phases only; with C = 1 and an odd row count, one
    launch, nothing reversed.  Against the plain version applied twice
    with the keep cut."""
    chunk, keep = 2048, 1024
    k1, k2, k3 = _planes(seed, B, A)
    k1[:, ::3] = 0x7FFFFFFF                   # KEY_NONE-like sentinels
    got = (k1, k2, k3)
    for n, kk0, kept, flip, _ in tsort.chunked_launches(A // chunk, chunk,
                                                        keep):
        got = sort3_host(got, n, kk0, kept, flip)
    s = tsort.sort3_rows_plain(*(_t(x).reshape(-1, chunk)
                                 for x in (k1, k2, k3)))
    want = [x.view(B, -1, chunk)[:, :, :keep].reshape(B, -1) for x in s]
    _check([_t(g.reshape(B, -1)) for g in got],
           [w.numpy().view(np.uint32)
            for w in tsort.sort3_rows_plain(*want)])


_SORT1_RUNNER = r"""
template <int A>
int emu_sort1_at(const void* k1, void* o1, int rows, int width) {
  if (width == A) {
    emu_launch(rows, A / LANES<A>, [=] {
      sort1_kernel<A>((const uint32_t*)k1, (uint32_t*)o1);
    });
    // the last block wrote no shared memory past what a launch requests
    const unsigned char* p = (const unsigned char*)emu_smem;
    for (size_t b = SMEM<A>; b < sizeof emu_smem; ++b)
      if (p[b] != 0xA5) return 2;
    return 0;
  }
  if constexpr (A < 32768) return emu_sort1_at<2 * A>(k1, o1, rows, width);
  return 1;
}
extern "C" int emu_sort1(const void* k1, void* o1, int rows, int A) {
  return emu_sort1_at<2>(k1, o1, rows, A);
}
"""


@pytest.fixture(scope="module")
def sort1_host(tmp_path_factory):
    """csrc/sort1.cu's device code on the host shim: fn(keys (rows, A)
    uint32) -> the sorted rows, as mm2_sort1."""
    fn = build_on_host("sort1", _SORT1_RUNNER,
                       tmp_path_factory.mktemp("sort1_host")).emu_sort1
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int

    def run(keys):
        keys = np.ascontiguousarray(keys, np.uint32)
        out = np.full_like(keys, 0xDEADBEEF)
        assert fn(keys.ctypes.data, out.ctypes.data, *keys.shape) == 0
        return out
    return run


def _sort1_keys(seed, B, A):
    """Row 0 full-range u32 (the top bit set on half the lanes), row 1
    runs of duplicates among 0x7FFFFFFF sentinels and top-bit values, row
    2 the HPC route's run-end keys (hpc_compact's ``key``: a lane's
    position where a homopolymer run of random codes ends, else
    0x7FFFFFFF, the tail past the read's length all sentinels)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 32, (B, A), dtype=np.uint64).astype(np.uint32)
    if B > 1:
        dup = np.repeat(rng.integers(0, 1 << 32, A, dtype=np.uint64)
                        .astype(np.uint32), rng.integers(1, 9, A))[:A]
        dup[rng.random(A) < 0.3] = 0x7FFFFFFF
        k[1] = dup
    if B > 2:
        n = int(rng.integers(A // 2, A + 1))
        codes = np.repeat(rng.integers(0, 4, A), rng.integers(1, 6, A))[:n]
        end = np.append(codes[1:] != codes[:-1], True)
        k[2] = 0x7FFFFFFF
        k[2, :n] = np.where(end, np.arange(n), 0x7FFFFFFF)
    return k


@pytest.mark.parametrize("A", [2, 8, 16, 64, 512, 1024, 2048, 16384, 32768])
def test_sort1_cuda_source_on_host_matches_plain(sort1_host, A):
    """The kernel's own code against the plain version, bit-equal, and no
    shared memory written past what its launch requests: every tier
    (registers from 2 lanes, shuffles from 32, the warp-lane and the
    high-bit transposes from 1024) and each lanes-a-thread count (2 and 8
    below 16 lanes, 16 up to 8192, 32 from 16384)."""
    k = _sort1_keys(A + 7, 3, A)
    want = tsort.sort1_rows_plain(_t(k)).numpy().view(np.uint32)
    np.testing.assert_array_equal(sort1_host(k), want)
    np.testing.assert_array_equal(want, np.sort(k, axis=1))
