// Host emulation of the CUDA subset the port's kernels use, for CPU tests
// that build a kernel's device code with g++: one std::thread per CUDA
// thread of a block, __syncthreads as a std::barrier, warp primitives as a
// barrier of the warp's threads around an exchange array, blocks one after
// the other, cp.async as a plain copy, and the byte-wise SIMD and float
// intrinsics written out.  Build with -ffp-contract=off, so that each
// float intrinsic rounds on its own as on the card.  It checks a kernel's
// arithmetic and data flow, not nvcc or the card.
#include <algorithm>
#include <barrier>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
struct int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
struct emu_dim { unsigned x; };
static thread_local emu_dim threadIdx;
static emu_dim blockIdx, blockDim;
static std::barrier<>* emu_barrier;
static std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
static uint64_t emu_xchg[32][32];                   // [warp][lane]
alignas(16) static uint4 emu_smem[232448 / 16];    // a block's maximum
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }

// run kernel(...) as an N-block grid of T threads
template <class F> void emu_launch(int N, int T, F kernel) {
  for (int b = 0; b < N; ++b) {
    blockIdx.x = b;
    blockDim.x = T;
    std::memset(emu_smem, 0xA5, sizeof emu_smem);   // no stale zeros
    std::barrier<> bar(T);
    emu_barrier = &bar;
    emu_warp_barriers.clear();
    for (int t = 0; t < T; t += 32)
      emu_warp_barriers.emplace_back(
          std::make_unique<std::barrier<>>(std::min(32, T - t)));
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t)
      th.emplace_back([=] { threadIdx.x = t; kernel(); });
    for (auto& x : th) x.join();
  }
}

// warp primitives: every thread of the warp takes part (full masks only)
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  emu_warp_barriers[threadIdx.x >> 5]->arrive_and_wait();
}
// publish v, then f(the warp's 32 published values), then a barrier so
// the array is free again
template <class T, class F> auto emu_warp_op(T v, F f) {
  uint64_t x = 0;
  std::memcpy(&x, &v, sizeof v);
  emu_xchg[threadIdx.x >> 5][threadIdx.x & 31] = x;
  __syncwarp();
  const auto r = f(emu_xchg[threadIdx.x >> 5]);
  __syncwarp();
  return r;
}
template <class T> T emu_get(uint64_t x) {
  T v;
  std::memcpy(&v, &x, sizeof v);
  return v;
}
template <class T> T __shfl_sync(unsigned, T v, int src, int = 32) {
  return emu_warp_op(v, [=](const uint64_t* a) {
    return emu_get<T>(a[src & 31]); });
}
template <class T> T __shfl_xor_sync(unsigned, T v, int m, int = 32) {
  return emu_warp_op(v, [=](const uint64_t* a) {
    return emu_get<T>(a[(threadIdx.x & 31) ^ (m & 31)]); });
}
inline int __reduce_max_sync(unsigned, int v) {
  return emu_warp_op(v, [](const uint64_t* a) {
    int m = INT_MIN;
    for (int l = 0; l < 32; ++l) m = std::max(m, emu_get<int>(a[l]));
    return m; });
}
inline int __clz(int x) {
  return x == 0 ? 32 : __builtin_clz((unsigned)x);
}

// cp.async (cuda_pipeline.h) as a plain copy: the data is there at once
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t zfill = 0) {
  std::memcpy(dst, src, n - zfill);
  std::memset((char*)dst + n - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

// float intrinsics: one rounding each (with -ffp-contract=off)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __int2float_rn(int x) { return (float)x; }
inline int __float2int_rz(float x) { return (int)x; }
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, 4);
  return x;
}

template <class F> inline uint32_t emu_bytes(uint32_t a, uint32_t b, F f) {
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (f((a >> (8 * i)) & 255u, (b >> (8 * i)) & 255u) & 255u) << (8 * i);
  return r;
}
inline int emu_s8(uint32_t x) { return (int)(int8_t)(uint8_t)x; }
inline int __viaddmax_s32(int a, int b, int c) { return max(a + b, c); }
inline uint32_t __vadd4(uint32_t a, uint32_t b) {
  return emu_bytes(a, b, [](uint32_t x, uint32_t y) { return x + y; });
}
inline uint32_t __vsub4(uint32_t a, uint32_t b) {
  return emu_bytes(a, b, [](uint32_t x, uint32_t y) { return x - y; });
}
inline uint32_t __vmaxs4(uint32_t a, uint32_t b) {
  return emu_bytes(a, b, [](uint32_t x, uint32_t y) {
    return emu_s8(x) > emu_s8(y) ? x : y; });
}
inline uint32_t __vcmpgts4(uint32_t a, uint32_t b) {
  return emu_bytes(a, b, [](uint32_t x, uint32_t y) {
    return emu_s8(x) > emu_s8(y) ? 255u : 0u; });
}
inline uint32_t __vcmpgeu4(uint32_t a, uint32_t b) {
  return emu_bytes(a, b, [](uint32_t x, uint32_t y) {
    return x >= y ? 255u : 0u; });
}
inline uint32_t __vcmpltu4(uint32_t a, uint32_t b) {
  return emu_bytes(a, b, [](uint32_t x, uint32_t y) {
    return x < y ? 255u : 0u; });
}
inline uint32_t __vcmpeq4(uint32_t a, uint32_t b) {
  return emu_bytes(a, b, [](uint32_t x, uint32_t y) {
    return x == y ? 255u : 0u; });
}
// result byte i = byte (s >> 4i) & 7 of the 8 bytes y:x
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 255u) << (8 * i);
  return r;
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t sh) {
  const uint64_t v = ((uint64_t)hi << 32) | lo;
  return (uint32_t)((v << (sh & 31)) >> 32);
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t sh) {
  const uint64_t v = ((uint64_t)hi << 32) | lo;
  return (uint32_t)(v >> (sh & 31));
}
