// Host emulation of the CUDA subset the port's kernels use, for CPU tests
// that build a kernel's device code with g++: one std::thread per CUDA
// thread of a block, __syncthreads as a std::barrier, blocks one after the
// other, and the byte-wise SIMD intrinsics written out lane by lane.  It
// checks a kernel's arithmetic and data flow, not nvcc or the card.
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

using std::max;
using std::min;
#define __global__
#define __device__
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
alignas(16) static uint4 emu_smem[232448 / 16];    // a block's maximum
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

// run kernel(...) as an N-block grid of T threads
template <class F> void emu_launch(int N, int T, F kernel) {
  for (int b = 0; b < N; ++b) {
    blockIdx.x = b;
    blockDim.x = T;
    std::memset(emu_smem, 0xA5, sizeof emu_smem);   // no stale zeros
    std::barrier<> bar(T);
    emu_barrier = &bar;
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t)
      th.emplace_back([=] { threadIdx.x = t; kernel(); });
    for (auto& x : th) x.join();
  }
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
