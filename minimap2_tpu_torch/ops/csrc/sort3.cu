// Row-wise ascending bitonic sort of three u32 planes on Hopper.
//
// Replaces minimap2_tpu/ops/sort_pallas.py: sort3_rows -> _sort_kernel (the
// Pallas kernel at sort_pallas.py:22-73) and sort3_chunked (:76-97).  Rows
// sort by the lexicographic (k1, k2, k3) triple.  The main path sorts
// 512 x 4096 lanes (anchors) and compacts minimizers of 512 x 16384 lanes
// in two launches: 4096 chunks of 2048 lanes (keeping each chunk's 1024
// smallest), then a merge of each row's eight kept runs (8192 lanes).
//
// What bounds it: the compare-exchange network, (A/2) log2(A)
// (log2(A)+1) / 2 compare-exchanges of a 12-byte triple a row; device
// memory sees each lane read once and written once (24 bytes).
// Design: registers first.  A block sorts one row; thread t holds the E
// consecutive lanes [tE, tE + E) of each plane in registers.  A stage of
// partner distance j runs
//   - j < E: between the thread's own registers, unrolled, no barrier;
//   - E <= j < 32E: against lane t ^ (j/E) of the same warp, three
//     __shfl_xor_sync a lane, no barrier;
//   - j >= 32E: in dynamic shared memory, one barrier a stage; the row goes
//     there and back once per merge phase kk, in 16-byte pieces whose index
//     is XOR-swizzled so that neither those pieces nor a warp's 32
//     consecutive words meet a bank conflict.
// With E = 16 (256 threads at 4096 lanes) that is 6 of the 78 stages.
// Every swap is two selects on the outcome of one compare.  The
// compaction's first launch stores only each chunk's first `keep` lanes,
// odd chunks reversed, straight into the (B, C*keep) input of the second
// launch: its runs then alternate ascending and descending, the state the
// network is in after phase kk = keep, so the second launch runs only the
// phases kk = 2 keep .. A (36 stages at 8192 lanes instead of 91).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool lex_gt(uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b1, uint32_t b2,
                                       uint32_t b3) {
  const unsigned long long a = ((unsigned long long)a1 << 32) | a2;
  const unsigned long long b = ((unsigned long long)b1 << 32) | b2;
  return a > b || (a == b && a3 > b3);
}

// (x, y) -> (min, max) when asc, else (max, min); equal triples may swap
__device__ __forceinline__ void cmpx(uint32_t& x1, uint32_t& x2,
                                     uint32_t& x3, uint32_t& y1,
                                     uint32_t& y2, uint32_t& y3, bool asc) {
  const bool sw = lex_gt(x1, x2, x3, y1, y2, y3) == asc;
  const uint32_t a1 = x1, a2 = x2, a3 = x3;
  x1 = sw ? y1 : x1;
  x2 = sw ? y2 : x2;
  x3 = sw ? y3 : x3;
  y1 = sw ? a1 : y1;
  y2 = sw ? a2 : y2;
  y3 = sw ? a3 : y3;
}

// word w of a plane in shared memory: 16-byte piece w/4 XOR-swizzled by the
// bits above its group of eight pieces
template <int E>
__device__ __forceinline__ int swz(int w) {
  constexpr int M = E >= 8 ? E / 4 - 1 : 0;
  return w ^ (((w >> 5) & M) << 2);
}

template <int E>
__device__ __forceinline__ void load_run(const uint32_t* __restrict__ p,
                                         uint32_t* r) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int v = 0; v < E / 4; ++v) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[v];
      r[4 * v] = q.x;
      r[4 * v + 1] = q.y;
      r[4 * v + 2] = q.z;
      r[4 * v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) r[i] = p[i];
  }
}

// lanes [g0, g0 + E) of a row whose first `keep` lanes are stored at out,
// in reverse order when rev
template <int E>
__device__ __forceinline__ void store_run(uint32_t* __restrict__ out,
                                          const uint32_t* r, int g0,
                                          int keep, bool rev) {
  if (E >= 4 && (keep & 3) == 0) {
    if (g0 >= keep) return;
#pragma unroll
    for (int v = 0; v < E / 4; ++v) {
      const int g = g0 + 4 * v;
      if (g >= keep) break;
      const uint32_t* x = r + 4 * v;
      if (rev)
        *reinterpret_cast<uint4*>(out + keep - 4 - g) =
            make_uint4(x[3], x[2], x[1], x[0]);
      else
        *reinterpret_cast<uint4*>(out + g) = make_uint4(x[0], x[1], x[2],
                                                        x[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int g = g0 + i;
      if (g < keep) out[rev ? keep - 1 - g : g] = r[i];
    }
  }
}

// the thread's E lanes of a plane to or from shared memory (E >= 8)
template <int E>
__device__ __forceinline__ void stash(uint32_t* s, const uint32_t* r,
                                      int g0) {
#pragma unroll
  for (int v = 0; v < E / 4; ++v)
    *reinterpret_cast<uint4*>(s + swz<E>(g0 + 4 * v)) =
        make_uint4(r[4 * v], r[4 * v + 1], r[4 * v + 2], r[4 * v + 3]);
}

template <int E>
__device__ __forceinline__ void fetch(const uint32_t* s, uint32_t* r,
                                      int g0) {
#pragma unroll
  for (int v = 0; v < E / 4; ++v) {
    const uint4 q = *reinterpret_cast<const uint4*>(s + swz<E>(g0 + 4 * v));
    r[4 * v] = q.x;
    r[4 * v + 1] = q.y;
    r[4 * v + 2] = q.z;
    r[4 * v + 3] = q.w;
  }
}

// Rows of A = E * blockDim.x lanes, phases kk = kk0 .. A of the network
// (lanes [i, i + kk) ascending iff bit kk of i is clear); lanes [0, keep)
// of row r go to out + r * keep, reversed on odd rows when flip.  The
// bound of 1024 threads holds a thread to 64 registers, which keeps four
// 256-thread blocks an SM at E = 16 (at the cost of a 12-byte spill).
template <int E>
__global__ void __launch_bounds__(1024)
    sort3_kernel(const uint32_t* __restrict__ k1,
                 const uint32_t* __restrict__ k2,
                 const uint32_t* __restrict__ k3, uint32_t* __restrict__ o1,
                 uint32_t* __restrict__ o2, uint32_t* __restrict__ o3, int A,
                 int kk0, int keep, int flip) {
  extern __shared__ uint4 smem[];
  uint32_t* s1 = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s2 = s1 + A;
  uint32_t* s3 = s2 + A;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int g0 = t * E;
  const unsigned wmask = T >= 32 ? 0xFFFFFFFFu : (1u << T) - 1u;
  const size_t row = blockIdx.x;
  uint32_t a[E], b[E], c[E];
  load_run<E>(k1 + row * A + g0, a);
  load_run<E>(k2 + row * A + g0, b);
  load_run<E>(k3 + row * A + g0, c);

  for (int kk = kk0; kk <= A; kk <<= 1) {
    int j = kk >> 1;
    if (j >= 32 * E) {
      // each thread stashes and later fetches only its own lanes, so no
      // barrier is needed between a fetch and the next phase's stash
      stash<E>(s1, a, g0);
      stash<E>(s2, b, g0);
      stash<E>(s3, c, g0);
      __syncthreads();
      for (; j >= 32 * E; j >>= 1) {
        for (int p = t; p < A / 2; p += T) {
          const int i = 2 * p - (p & (j - 1));    // bit j of i clear
          const int x = swz<E>(i), y = swz<E>(i + j);
          uint32_t x1 = s1[x], x2 = s2[x], x3 = s3[x];
          uint32_t y1 = s1[y], y2 = s2[y], y3 = s3[y];
          cmpx(x1, x2, x3, y1, y2, y3, (i & kk) == 0);
          s1[x] = x1;
          s2[x] = x2;
          s3[x] = x3;
          s1[y] = y1;
          s2[y] = y2;
          s3[y] = y3;
        }
        __syncthreads();
      }
      fetch<E>(s1, a, g0);
      fetch<E>(s2, b, g0);
      fetch<E>(s3, c, g0);
    }
    const bool asc_t = (g0 & kk) == 0;      // for every kk >= E
    for (; j >= E; j >>= 1) {
      const int m = j / E;                  // partner lane t ^ m
      const bool keep_min = ((t & m) == 0) == asc_t;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const uint32_t p1 = __shfl_xor_sync(wmask, a[i], m);
        const uint32_t p2 = __shfl_xor_sync(wmask, b[i], m);
        const uint32_t p3 = __shfl_xor_sync(wmask, c[i], m);
        const bool take = lex_gt(a[i], b[i], c[i], p1, p2, p3) == keep_min;
        a[i] = take ? p1 : a[i];
        b[i] = take ? p2 : b[i];
        c[i] = take ? p3 : c[i];
      }
    }
#pragma unroll
    for (int jj = E / 2; jj >= 1; jj >>= 1) {
      if (jj <= j) {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          if (i & jj) continue;
          const bool asc = ((g0 + i) & kk) == 0;
          cmpx(a[i], b[i], c[i], a[i + jj], b[i + jj], c[i + jj], asc);
        }
      }
    }
  }

  const bool rev = flip && (row & 1);
  store_run<E>(o1 + row * keep, a, g0, keep, rev);
  store_run<E>(o2 + row * keep, b, g0, keep, rev);
  store_run<E>(o3 + row * keep, c, g0, keep, rev);
}

// lanes a thread for a row of A lanes (a power of two, 2 .. 16384): 16,
// so 1024 threads at 16384 lanes
int lanes_per_thread(int A) { return A < 16 ? A : 16; }

}  // namespace

// host side: launches (not part of the device code the CPU tests build)
namespace {

template <int E>
int launch(const void* k1, const void* k2, const void* k3, void* o1,
           void* o2, void* o3, int rows, int A, int kk0, int keep, int flip,
           cudaStream_t stream) {
  const size_t smem = A >= 64 * E ? (size_t)A * 3 * sizeof(uint32_t) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      sort3_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sort3_kernel<E><<<rows, A / E, smem, stream>>>(
      (const uint32_t*)k1, (const uint32_t*)k2, (const uint32_t*)k3,
      (uint32_t*)o1, (uint32_t*)o2, (uint32_t*)o3, A, kk0, keep, flip);
  return (int)cudaGetLastError();
}

template <int E>
int occupancy(int A, int* n) {
  const size_t smem = A >= 64 * E ? (size_t)A * 3 * sizeof(uint32_t) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      sort3_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, sort3_kernel<E>, A / E, smem);
}

}  // namespace

#define SORT3_DISPATCH(CALL)              \
  switch (lanes_per_thread(A)) {          \
    case 2: return CALL(2);               \
    case 4: return CALL(4);               \
    case 8: return CALL(8);               \
    case 16: return CALL(16);             \
    default: return (int)cudaErrorInvalidValue; \
  }

// Sort `rows` rows of A lanes (phases kk0 .. A of the network) and store
// each row's first `keep` lanes at o + row * keep, odd rows reversed when
// flip.  A plain sort is kk0 = 2, keep = A, flip = 0.
extern "C" int mm2_sort3_ex(const void* k1, const void* k2, const void* k3,
                            void* o1, void* o2, void* o3, int rows, int A,
                            int kk0, int keep, int flip, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SORT3_LAUNCH(E) \
  launch<E>(k1, k2, k3, o1, o2, o3, rows, A, kk0, keep, flip, s)
  SORT3_DISPATCH(SORT3_LAUNCH)
}

// blocks of the kernel one SM holds at row width A
extern "C" int mm2_sort3_occupancy(int A, int* n) {
#define SORT3_OCCUPANCY(E) occupancy<E>(A, n)
  SORT3_DISPATCH(SORT3_OCCUPANCY)
}
