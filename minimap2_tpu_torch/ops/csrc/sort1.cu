// Row-wise ascending bitonic sort of one u32 plane on Hopper.
//
// Replaces minimap2_tpu/ops/sort_pallas.py: sort1_rows -> _sort1_kernel (the
// Pallas kernel at sort_pallas.py:100-117, called at :130).  The HPC route
// sorts run-end keys (position, or 0x7FFFFFFF off a run end) of 512 rows x
// 16384 lanes to compact each read's homopolymer-run ends in order; the
// kernel sorts any u32 values.
//
// What bounds it: the compare-exchange network, (A/2) log2(A) (log2(A)+1)/2
// compare-exchanges a row, each a min and a max; device memory sees each
// lane read once and written once (8 bytes).  Design: registers first.  A
// block sorts one row of A lanes (A a template parameter); thread t holds
// the E consecutive lanes [tE, tE + E) in registers, read and written as
// 16-byte pieces.  A warp's threads hold W = 32E lanes.  A stage of partner
// distance j runs
//   - j < E: between the thread's own registers, unrolled, no barrier;
//   - E <= j < W: against lane t ^ (j/E) of the same warp, one
//     __shfl_xor_sync a lane; but from phase kk = 1024 on, where a phase
//     has all of them, the stages 32 <= j < W run between registers after
//     a transpose through dynamic shared memory: thread t loads the E lanes
//     (t/32) W + 32c + t%32, c < E;
//   - j >= W: between registers after another transpose: thread t loads
//     the lanes h W + u T + t (all H = A/W values of h, u < E/H; T
//     threads), which needs H <= E, hence E = 32 from 16384 lanes.
// A transposing phase stores the thread's own lanes once, goes through
// each transposed layout (load, stages, store back) with a barrier before
// each, and loads its own lanes again after a last barrier: a thread only
// ever reads the words it wrote in the same layout.  Word indices are
// XOR-swizzled so that neither the 16-byte pieces of a thread's own lanes
// nor a warp's 32 consecutive words meet a bank conflict.  At 16384 lanes
// (E = 32, 512 threads, 64 registers: two blocks an SM) that is 60 of the
// 105 stages in a thread's own registers, 10 by shuffles, 25 after the
// warp-lane transpose and 10 after the high one, with 14 barriers.  During
// phase kk a lane whose block sorts descending (bit kk of its index set)
// holds its value complemented, so every compare-exchange is one min and
// one max with no direction: the direction costs one XOR a lane and phase.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// lanes a thread at row width A (a power of two, 2 .. 32768)
template <int A>
constexpr int LANES = A < 16 ? A : A < 16384 ? 16 : 32;

// the first phase whose warp-lane stages run after a transpose (measured
// against 256 and 512 at 16384 lanes)
constexpr int MID_FROM = 1024;

// dynamic shared memory of a row: the row itself, in the rows that have a
// phase MID_FROM (then E >= 16 and A >= 32E)
template <int A>
constexpr size_t SMEM = A >= MID_FROM ? A * sizeof(uint32_t) : 0;

// (x, y) -> (min, max)
__device__ __forceinline__ void cmpx(uint32_t& x, uint32_t& y) {
  const uint32_t lo = min(x, y);
  y = max(x, y);
  x = lo;
}

// the stages of partner distance J = J0, J0/2, .., 1 with J < lim between
// registers k and k + J
template <int J0, int N>
__device__ __forceinline__ void merge_regs(uint32_t (&v)[N], int lim) {
#pragma unroll
  for (int J = J0; J >= 1; J >>= 1)
    if (J < lim)
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (!(k & J)) cmpx(v[k], v[k + J]);
}

// ~0 when bit kk of lane i is set: the lanes whose block of phase kk sorts
// descending hold their values complemented during that phase
__device__ __forceinline__ uint32_t flip(int i, int kk) {
  return i & kk ? 0xFFFFFFFFu : 0u;
}

// word w of the row in shared memory: 16-byte piece w/4 XOR-swizzled by the
// bits above its group of eight pieces
template <int E>
__device__ __forceinline__ int swz(int w) {
  constexpr int M = E >= 8 ? E / 4 - 1 : 0;
  return w ^ (((w >> 5) & M) << 2);
}

// registers v[0..4) to or from the 16-byte piece at p
__device__ __forceinline__ void put4(uint32_t* p, const uint32_t* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void get4(const uint32_t* p, uint32_t* v) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

template <int A>
__global__ void __launch_bounds__(A / LANES<A>)
    sort1_kernel(const uint32_t* __restrict__ k1, uint32_t* __restrict__ o1) {
  constexpr int E = LANES<A>, T = A / E, W = 32 * E;
  constexpr int H = A > W ? A / W : 1;
  // high-transposed lane h W + u T + t sits at word (h W + u T) + swz(t)
  // when those offsets are multiples of 8E
  constexpr bool SPLIT = E / H == 1 || T % (8 * E) == 0;
  extern __shared__ uint4 smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  const int t = threadIdx.x;
  const int g0 = t * E;
  const unsigned wmask = T >= 32 ? 0xFFFFFFFFu : (1u << (T & 31)) - 1u;
  const size_t base = (size_t)blockIdx.x * A + g0;
  uint32_t v[E];
  if constexpr (E >= 4) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) get4(k1 + base + 4 * q, v + 4 * q);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = k1[base + i];
  }

  // phases inside the thread's lanes
#pragma unroll
  for (int i = 0; i < E; ++i) v[i] ^= flip(g0 + i, 2);
#pragma unroll
  for (int kk = 2; kk < E; kk <<= 1) {
    merge_regs<E / 2>(v, kk);
#pragma unroll
    for (int i = 0; i < E; ++i)
      v[i] ^= flip(g0 + i, kk) ^ flip(g0 + i, 2 * kk);
  }

  for (int kk = E; kk <= A; kk <<= 1) {
    int j = kk >> 1;
    if (SMEM<A> && kk >= MID_FROM) {           // stages j >= 32
#pragma unroll
      for (int q = 0; q < E / 4; ++q) put4(s + swz<E>(g0 + 4 * q), v + 4 * q);
      __syncthreads();
      if (j >= W) {
        // register k = u H + h holds lane h W + u T + t
        uint32_t* st = s + (SPLIT ? swz<E>(t) : t);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int off = k % H * W + k / H * T;
          v[k] = SPLIT ? st[off] : s[swz<E>(off + t)];
        }
        merge_regs<H / 2>(v, kk / W);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int off = k % H * W + k / H * T;
          (SPLIT ? st[off] : s[swz<E>(off + t)]) = v[k];
        }
        __syncthreads();
      }
      // register c holds lane (t / 32) W + 32 c + t % 32
      uint32_t* sm = s + (t >> 5) * W;
      const int r = t & 31;
#pragma unroll
      for (int c = 0; c < E; ++c)
        v[c] = sm[32 * c + (r ^ ((c & (E / 4 - 1)) << 2))];
      merge_regs<E / 2>(v, kk / 32);
#pragma unroll
      for (int c = 0; c < E; ++c)
        sm[32 * c + (r ^ ((c & (E / 4 - 1)) << 2))] = v[c];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < E / 4; ++q) get4(s + swz<E>(g0 + 4 * q), v + 4 * q);
      j = 16;
    }
    for (; j >= E; j >>= 1) {
      const int m = j / E;                     // partner lane t ^ m
      const bool lower = (t & m) == 0;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const uint32_t y = __shfl_xor_sync(wmask, v[i], m);
        v[i] = lower ? min(v[i], y) : max(v[i], y);
      }
    }
    merge_regs<E / 2>(v, E);
    const uint32_t f = flip(g0, kk) ^ flip(g0, 2 * kk);   // every lane's
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] ^= f;
  }

  if constexpr (E >= 4) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) put4(o1 + base + 4 * q, v + 4 * q);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) o1[base + i] = v[i];
  }
}

}  // namespace

// host side: launches (not part of the device code the CPU tests build)
namespace {

template <int A>
int launch(const void* k1, void* o1, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sort1_kernel<A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM<A>);
  if (err != cudaSuccess) return (int)err;
  constexpr int threads = A / LANES<A>;
  sort1_kernel<A><<<B, threads, SMEM<A>, stream>>>((const uint32_t*)k1,
                                                   (uint32_t*)o1);
  return (int)cudaGetLastError();
}

template <int A>
int occupancy(int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      sort1_kernel<A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM<A>);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, sort1_kernel<A>, A / LANES<A>, SMEM<A>);
}

template <int A> struct Width { static constexpr int value = A; };

// f(Width<A>()) for a row width A
template <class F>
int with_width(int A, F f) {
  switch (A) {
    case 2: return f(Width<2>());
    case 4: return f(Width<4>());
    case 8: return f(Width<8>());
    case 16: return f(Width<16>());
    case 32: return f(Width<32>());
    case 64: return f(Width<64>());
    case 128: return f(Width<128>());
    case 256: return f(Width<256>());
    case 512: return f(Width<512>());
    case 1024: return f(Width<1024>());
    case 2048: return f(Width<2048>());
    case 4096: return f(Width<4096>());
    case 8192: return f(Width<8192>());
    case 16384: return f(Width<16384>());
    case 32768: return f(Width<32768>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Sort the B rows of A lanes of one plane.
extern "C" int mm2_sort1(const void* k1, void* o1, int B, int A,
                         void* stream) {
  if (B == 0) return 0;
  return with_width(A, [&](auto a) {
    return launch<decltype(a)::value>(k1, o1, B, (cudaStream_t)stream);
  });
}

// blocks of the kernel one SM holds at row width A
extern "C" int mm2_sort1_occupancy(int A, int* n) {
  return with_width(A, [&](auto a) { return occupancy<decltype(a)::value>(n); });
}
