// Minimizer sketch of a read batch on Hopper.
//
// Replaces minimap2_tpu/ops/sketch_pallas.py: sketch_batch -> _sketch_kernel
// (the Pallas kernel at sketch_pallas.py:79-228).  Per read position i (the
// k-mer ending at i) it writes hash64 of the canonical k-mer as two u32
// planes (hi, lo), the strand z, and is_mini: i's hash equals the minimum
// of at least one complete w-window covering i (ties included); and, when
// the caller passes a buffer for it, valid: the k-mer ending at i has no
// code >= 4 (4 = N, 5 = the index build's separator), i >= k - 1, i < len
// and it is not its own reverse complement (bit 2 of the TPU kernel's flag
// plane).  The planes equal parallel/batch.device_sketch's at every
// position, invalid ones included, so the plain PyTorch version is that
// function.
//
// What bounds it: device memory and integer issue.  A position reads 1
// byte of codes and writes 10 bytes (two u32 hash words, z, is_mini; 11
// with valid), and
// its k-mer hash and window terms are a few dozen integer ops.
// Design: a block covers a tile of TILE positions of one read plus a halo
// of HL >= w - 1 positions on each side (HL a multiple of P), one thread a
// run of P = 16 consecutive positions, so a block is TILE/P + 2 HL/P
// threads and every thread has one run.  A thread
//   - loads its 16 codes, and the w + k - 2 before them, in 16-byte pieces
//     and rolls the forward and reverse k-mers one code a step in native
//     uint64 (2k <= 56 bits), keeping the last ambiguous code's position:
//     a k-mer is valid iff none lies among its k codes, and the window of
//     w k-mers ending at a position is complete iff none lies among the
//     last w + k - 1 codes (`wend`, a bit a position);
//   - hashes each of its positions once and stores hi and lo 16 bytes at a
//     time, z (and valid) 16 positions to a store;
//   - takes window minima by doubling: m_2s[e] = min(m_s[e], m_s[e + s])
//     up to the largest power of two S <= w, then min(m_S[e], m_S[e + w -
//     S]); each level publishes the values a neighbouring run reads
//     (the first s of the run) in shared memory laid out [lane of the
//     run][run], so a warp's accesses are consecutive (no bank
//     conflict), two buffers taking turns (one barrier a level).
//     log2(w) + 1 levels: a cost a position that w barely moves.  The
//     w-independent van Herk / Gil-Werman form (prefix and suffix minima
//     over segments of w, four barriers) measured slower at the paths'
//     w of 5 and 10: its two scans, carry fold and combine at a runtime
//     segment phase are more integer work than 3-4 doubling levels, and
//     the kernel is bound by instruction issue, not barriers;
//   - takes the maximum over the complete windows covering each position
//     the same way, backwards, on wok ? min + 1 : 0 (0: no complete
//     window), and stores is_mini 16 positions to a store.
// Positions outside [0, L) are masked here; the TPU kernel relied on
// clamped neighbour blocks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 2048;                // positions a block at most
constexpr int P = 16;                     // positions a thread
constexpr int PAD = 8;                    // runs of shared-memory margin
constexpr unsigned long long BIG = 1ull << 62;   // above every hash: none

__device__ __forceinline__ unsigned long long hash64(unsigned long long key,
                                                     unsigned long long mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

// codes of positions [q, q + 16) of a row: code 4 past L; positions before
// 0 read as 0 here and are told apart by position
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row,
                                        int q, int L, bool vec) {
  if (vec && q >= 0 && q + P <= L)
    return *reinterpret_cast<const uint4*>(row + q);
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < P; ++b) {
    const int p = q + b;
    const uint32_t c = p < 0 ? 0u : (p < L ? row[p] : 4u);
    v[b >> 2] |= c << (8 * (b & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t byte_of(const uint4& c, int b) {
  const uint32_t w = b < 4 ? c.x : (b < 8 ? c.y : (b < 12 ? c.z : c.w));
  return (w >> (8 * (b & 3))) & 255u;
}

struct Roll {
  unsigned long long kf = 0, kr = 0;
  int last_n = -(1 << 30);                // position of the last code >= 4
  // one code at position p (mm_sketch's rolling update; plain OR of the
  // code into the forward k-mer, as device_sketch)
  __device__ __forceinline__ void step(uint32_t c, int p,
                                       unsigned long long mask, int shift) {
    const uint32_t comp = (p >= 0 && c < 4) ? (3u ^ c) : 0u;
    kf = ((kf << 2) | c) & mask;
    kr = (kr >> 2) | ((unsigned long long)comp << shift);
    last_n = (p >= 0 && c >= 4) ? p : last_n;
  }
};

// value of position-in-tile e (run e / P, lane e % P) in a buffer laid out
// [lane][PAD + run]
__device__ __forceinline__ int at(int e, int runs_s) {
  return (e & (P - 1)) * runs_s + PAD + (e >> 4);
}

// at most TILE/P + 16 threads (HL <= 128 as w <= 127), and registers for
// three blocks an SM
__global__ void __launch_bounds__(TILE / P + 256 / P, 3)
    sketch_kernel(const uint8_t* __restrict__ codes,
                  const int32_t* __restrict__ lens,
                  uint32_t* __restrict__ hhi, uint32_t* __restrict__ hlo,
                  uint8_t* __restrict__ zout, uint8_t* __restrict__ mini,
                  uint8_t* __restrict__ vout, int L, int k, int w, int tile,
                  int n_tiles, int HL) {
  extern __shared__ uint4 smem[];
  const int runs = blockDim.x;
  const int runs_s = runs + 2 * PAD;
  unsigned long long* buf0 = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* buf1 = buf0 + P * runs_s;
  uint16_t* s_wend = reinterpret_cast<uint16_t*>(buf1 + P * runs_s);

  const int r = threadIdx.x;
  const int b = blockIdx.x / n_tiles;
  const int p0 = (blockIdx.x % n_tiles) * tile;
  const int q0 = p0 - HL + r * P;              // the run [q0, q0 + P)
  const int len = lens[b];
  const uint8_t* row = codes + (size_t)b * L;
  const bool vec = (L & (P - 1)) == 0;
  const unsigned long long mask = (1ull << (2 * k)) - 1ull;

  // k-mers: the w + k - 2 codes before the run, then the run.  Of the
  // codes before it only the last k - 1 enter a k-mer; the rest only move
  // the last ambiguous code (a byte-wise compare per 4 codes).
  Roll roll;
  const int n_warm = (w + k - 2 + P - 1) / P;
  const int n_roll = (k - 1 + P - 1) / P;
  for (int ch = n_warm; ch > 0; --ch) {
    const int q = q0 - ch * P;
    const uint4 c = load16(row, q, L, vec);
    if (ch <= n_roll) {
#pragma unroll
      for (int i = 0; i < P; ++i) roll.step(byte_of(c, i), q + i, mask,
                                            2 * (k - 1));
    } else {
      const uint32_t wd[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint32_t n4 = __vcmpgeu4(wd[v], 0x04040404u);
        // positions before 0 hold 0, never >= 4
        if (n4) roll.last_n = q + 4 * v + (31 - __clz((int)n4)) / 8;
      }
    }
  }
  const uint4 cr = load16(row, q0, L, vec);
  const bool own = q0 >= p0 && q0 < p0 + tile && q0 < L;
  const bool own_vec = own && vec;
  const size_t o = (size_t)b * L + q0;
  unsigned long long x[P];
  uint32_t zb[4] = {0, 0, 0, 0};
  uint32_t vb[4] = {0, 0, 0, 0};
  uint32_t wend = 0;
#pragma unroll
  for (int v = 0; v < P / 4; ++v) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * v + u;
      const int q = q0 + i;
      roll.step(byte_of(cr, i), q, mask, 2 * (k - 1));
      const bool in = q < len;
      const bool okp = in && q >= k - 1 && q - roll.last_n >= k;
      wend |= (uint32_t)(in && q >= w + k - 2 &&
                         q - roll.last_n >= w + k - 1) << i;
      const bool z = roll.kf >= roll.kr;
      const unsigned long long h = hash64(z ? roll.kr : roll.kf, mask);
      const bool ok = okp && roll.kf != roll.kr;
      x[i] = ok ? h : BIG;
      vb[v] |= (uint32_t)ok << (8 * u);
      hi[u] = (uint32_t)(h >> 32);
      lo[u] = (uint32_t)h;
      zb[v] |= (uint32_t)z << (8 * u);
    }
    // hash hi and lo of the tile's runs, 4 positions a store
    if (own_vec) {
      reinterpret_cast<uint4*>(hhi + o)[v] = make_uint4(hi[0], hi[1], hi[2],
                                                        hi[3]);
      reinterpret_cast<uint4*>(hlo + o)[v] = make_uint4(lo[0], lo[1], lo[2],
                                                        lo[3]);
    } else if (own) {
      for (int u = 0; u < 4 && q0 + 4 * v + u < L; ++u) {
        hhi[o + 4 * v + u] = hi[u];
        hlo[o + 4 * v + u] = lo[u];
      }
    }
  }
  s_wend[r] = (uint16_t)wend;
  if (own_vec) {
    *reinterpret_cast<uint4*>(zout + o) = make_uint4(zb[0], zb[1], zb[2],
                                                     zb[3]);
  } else if (own) {
    for (int i = 0; i < P && q0 + i < L; ++i)
      zout[o + i] = (zb[i >> 2] >> (8 * (i & 3))) & 1u;
  }
  if (vout != nullptr) {
    if (own_vec) {
      *reinterpret_cast<uint4*>(vout + o) = make_uint4(vb[0], vb[1], vb[2],
                                                       vb[3]);
    } else if (own) {
      for (int i = 0; i < P && q0 + i < L; ++i)
        vout[o + i] = (vb[i >> 2] >> (8 * (i & 3))) & 1u;
    }
  }

  // window minima: m[e] = min(x[e .. e + w)) by doubling
  const int e0 = r * P;                          // the run's first entry
  int level = 0;
  unsigned long long m[P];
#pragma unroll
  for (int i = 0; i < P; ++i) m[i] = x[i];
#pragma unroll
  for (int s = 1; s <= 64; s <<= 1) {
    if (2 * s > w) break;
    unsigned long long* bf = (level++ & 1) ? buf1 : buf0;
#pragma unroll
    for (int i = 0; i < P; ++i)         // what the runs before need
      if (i < s) bf[at(e0 + i, runs_s)] = m[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const unsigned long long y =
          i + s < P ? m[(i + s) & (P - 1)] : bf[at(e0 + i + s, runs_s)];
      m[i] = y < m[i] ? y : m[i];
    }
  }
  int S = 1;
  while (2 * S <= w) S <<= 1;
  if (w > S) {
    unsigned long long* bf = (level++ & 1) ? buf1 : buf0;
#pragma unroll
    for (int i = 0; i < P; ++i) bf[at(e0 + i, runs_s)] = m[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const unsigned long long y = bf[at(e0 + i + w - S, runs_s)];
      m[i] = y < m[i] ? y : m[i];
    }
  }

  // window e is complete iff wend at e + w - 1; cv = wok ? min + 1 : 0
  __syncthreads();                              // s_wend
  const int f = r + (w - 1) / P;
  const uint32_t wok =
      ((uint32_t)s_wend[f] | ((uint32_t)s_wend[f + 1] << 16)) >>
      ((w - 1) & (P - 1));
#pragma unroll
  for (int i = 0; i < P; ++i) m[i] = (wok >> i) & 1u ? m[i] + 1 : 0ull;

  // maximum over the windows covering each position: [e - w + 1, e]
#pragma unroll
  for (int s = 1; s <= 64; s <<= 1) {
    if (2 * s > w) break;
    unsigned long long* bf = (level++ & 1) ? buf1 : buf0;
#pragma unroll
    for (int i = 0; i < P; ++i)         // what the runs after need
      if (i >= P - s) bf[at(e0 + i, runs_s)] = m[i];
    __syncthreads();
#pragma unroll
    for (int i = P - 1; i >= 0; --i) {
      const unsigned long long y =
          i >= s ? m[(i - s) & (P - 1)] : bf[at(e0 + i - s, runs_s)];
      m[i] = y > m[i] ? y : m[i];
    }
  }
  if (w > S) {
    unsigned long long* bf = (level++ & 1) ? buf1 : buf0;
#pragma unroll
    for (int i = 0; i < P; ++i) bf[at(e0 + i, runs_s)] = m[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const unsigned long long y = bf[at(e0 + i - (w - S), runs_s)];
      m[i] = y > m[i] ? y : m[i];
    }
  }

  if (!own) return;
  uint32_t mb[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < P; ++i)
    mb[i >> 2] |= (uint32_t)(x[i] != BIG && m[i] == x[i] + 1) << (8 * (i & 3));
  if (vec) {
    *reinterpret_cast<uint4*>(mini + o) = make_uint4(mb[0], mb[1], mb[2],
                                                     mb[3]);
  } else {
    for (int i = 0; i < P && q0 + i < L; ++i)
      mini[o + i] = (mb[i >> 2] >> (8 * (i & 3))) & 1u;
  }
}

// the launch's shape for rows of L positions and windows of w
struct Shape {
  int tile, n_tiles, HL, threads;
  size_t smem;
};

Shape shape_of(int L, int w) {
  Shape sh;
  const int Lr = (L + P - 1) / P * P;
  sh.tile = Lr < TILE ? Lr : TILE;
  sh.n_tiles = (L + sh.tile - 1) / sh.tile;
  sh.HL = (w - 1 + P - 1) / P * P;
  sh.threads = (sh.tile + 2 * sh.HL) / P;
  sh.smem = 2 * (size_t)P * (sh.threads + 2 * PAD) * 8 +
            (size_t)(sh.threads + 2 * PAD) * 2;
  return sh;
}

}  // namespace

// valid may be null: the plane is then not written
extern "C" int mm2_sketch(const void* codes, const void* lens, void* hhi,
                          void* hlo, void* z, void* is_mini, void* valid,
                          int B, int L, int k, int w, void* stream) {
  if (B == 0 || L == 0) return 0;
  const Shape sh = shape_of(L, w);
  cudaError_t err = cudaFuncSetAttribute(
      sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  sketch_kernel<<<B * sh.n_tiles, sh.threads, sh.smem,
                  (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)lens, (uint32_t*)hhi,
      (uint32_t*)hlo, (uint8_t*)z, (uint8_t*)is_mini, (uint8_t*)valid, L, k,
      w, sh.tile, sh.n_tiles, sh.HL);
  return (int)cudaGetLastError();
}

// blocks of the kernel one SM holds for rows of L positions, windows of w
extern "C" int mm2_sketch_occupancy(int L, int w, int* n) {
  const Shape sh = shape_of(L, w);
  cudaError_t err = cudaFuncSetAttribute(
      sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, sketch_kernel, sh.threads, sh.smem);
}
