// CIGAR traceback over extd2's / exts2's direction bytes on Hopper.
//
// Replaces minimap2_tpu/ops/traceback_pallas.py: traceback_batch ->
// _bt_kernel (the Pallas kernel at traceback_pallas.py:33-113, called at
// :155), both modes.  ksw_backtrack (ksw2.h:130-162) from (tlen-1, qlen-1)
// down to the origin over p (N, RT, W): diagonal r = i + j, lane i - ws(r);
// outside the band the walk is forced (D below it, I above it).  extd2's
// rows: ws = wstart_chunk(r), band w.  exts2's rows (splice): ws =
// wstart_q(r, QP), the band unbounded, and state 3 (intron) emits op 4.
// Outputs one op byte per diagonal (1 = M, 2 = I, 3 = D, 4 = N, 0 = not
// visited) and the leftover (i, j).
//
// What bounds it: latency.  The walk of a job is a chain of ~qlen + tlen
// dependent steps, each a one-byte read of p whose value picks the next
// address; p does not fit in L2, so a walk that loads each byte when it
// needs it pays a trip to device memory a step.  Design: one warp per job
// (a block), and the walk reads shared memory only.  The walk never leaves
// a small window: from (r, i) it moves to diagonal r - 1 or r - 2, and i
// falls by at most one a step, so on diagonal r' < r it lies in columns
// i - (r - r') .. i.  The diagonals are cut into chunks of K (chunk c
// holds diagonals cK .. cK + K - 1).  When the walk enters chunk c at
// column i_e, every cell it can visit in chunk c - 1 lies in columns
// [i_e - 2K + 1, i_e], so the whole warp then copies those bytes of chunk
// c - 1's K rows into shared memory with 16-byte cp.async, while lane 0
// walks chunk c from the window copied one chunk earlier (double buffer).
// Within a chunk each step has the bytes of its three possible next cells
// loaded while it decides, so no step waits for a load of its own.
// ws(r) is a multiple of 16, so one window offset serves every row, and a
// 16-byte piece of a row lies wholly inside [0, W) or wholly outside: an
// outside piece is stored as zeros, which is what the walk reads there.
// A chunk's K op bytes go out in one coalesced store; the rows above the
// walk's start chunk and below its end chunk are zeroed by the warp.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int K = 32;               // diagonals a chunk (a multiple of 32)
constexpr int WB = 2 * K + 16;      // window bytes a row (16-byte aligned)
constexpr int PIECES = WB / 16;     // 16-byte pieces a window row
constexpr int BUF = K * WB;         // bytes of one chunk's window
constexpr int SMEM = 2 * BUF + K;   // two windows + a chunk's op bytes
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int wstart(int r, int w) {
  const int a = (r - w + 1) >> 1;
  return ((a > 0 ? a : 0) >> 4) << 4;
}

// query-edge window start of exts2's rows
__device__ __forceinline__ int wstart_q(int r, int QP) {
  const int a = r - QP + 1;
  return ((a > 0 ? a : 0) >> 4) << 4;
}

__device__ __forceinline__ int floor16(int x) { return x & ~15; }

// row[lo, hi) = 0 by the warp: bytes up to a 16-byte boundary, then
// 16-byte stores, then bytes
__device__ void zero_row(uint8_t* row, int lo, int hi, int lane) {
  if (lo >= hi) return;
  const uintptr_t a = (uintptr_t)(row + lo), b = (uintptr_t)(row + hi);
  const uintptr_t a16 = (a + 15) & ~(uintptr_t)15, b16 = b & ~(uintptr_t)15;
  if (a16 >= b16) {
    for (uintptr_t x = a + lane; x < b; x += 32) *(uint8_t*)x = 0;
    return;
  }
  for (uintptr_t x = a + lane; x < a16; x += 32) *(uint8_t*)x = 0;
  for (uintptr_t x = a16 + 16 * lane; x < b16; x += 16 * 32)
    *(uint4*)x = make_uint4(0, 0, 0, 0);
  for (uintptr_t x = b16 + lane; x < b; x += 32) *(uint8_t*)x = 0;
}

// chunk c's window: rows cK + k (k < K, up to r_hi) at columns [A - ws,
// A - ws + WB), a row a lane, into buf; pieces outside [0, W) are zeros
template <bool SPLICE>
__device__ void fetch_window(uint8_t* buf, const uint8_t* prow, int c,
                             int A, int r_hi, int W, int RB, int w, int QP,
                             int lane) {
  for (int k = lane; k < K && c * K + k <= r_hi; k += 32) {
    const int r = c * K + k;
    const int ws = SPLICE ? wstart_q(r, QP) : wstart((r / RB) * RB, w);
    const uint8_t* src = prow + (size_t)r * W;
    uint8_t* dst = buf + k * WB;
    for (int q = 0; q < PIECES; ++q) {
      const int col = A + 16 * q - ws;
      if (col >= 0 && col + 16 <= W)
        __pipeline_memcpy_async(dst + 16 * q, src + col, 16);
      else
        *(uint4*)(dst + 16 * q) = make_uint4(0, 0, 0, 0);
    }
  }
}

// lane 0's walk through chunk [base, base + K) of window wc (column
// offset A), from (i, j) in state s while i, j >= 0 and i + j >= base,
// writing the chunk's op bytes.  A step takes its cell's byte from the
// three that the step before loaded for its possible moves (M: r - 2,
// i - 1; D: r - 1, i - 1; I: r - 1, i), so it waits on its arithmetic,
// not on a load; only a chunk's first cell is loaded when needed.
template <bool SPLICE>
__device__ __forceinline__ void walk_chunk(const uint8_t* wc, int base,
                                           int A, int qlen, int tlen, int w,
                                           int& i_, int& j_, int& s_,
                                           uint8_t* sops) {
  int i = i_, j = j_, s = s_, r = i + j;
  int off = (r - base) * WB + (i - A);
  int tmp = wc[off];
  do {
    const int cm = wc[max(off - 2 * WB - 1, 0)];
    const int cd = wc[max(off - WB - 1, 0)];
    const int ci = wc[max(off - WB, 0)];
    int st0 = max(0, r - qlen + 1), en0 = min(tlen - 1, r);
    if (!SPLICE) {
      st0 = max(st0, (r - w + 1) >> 1);
      en0 = min(en0, (r + w) >> 1);
    }
    // ksw2.h:141-147, and the forced steps outside the band
    int s1 = s != 0 && ((tmp >> (s + 2)) & 1) ? s : tmp & 7;
    s1 = i > en0 ? 1 : i < st0 ? 2 : s1;
    const int is_m = s1 == 0, is_d = (0xA >> s1) & 1;   // D: states 1, 3
    sops[r - base] = is_m ? 1 : (SPLICE && s1 == 3) ? 4 : (is_d ? 3 : 2);
    const int di = is_m | is_d, dj = is_m | (is_d ^ 1);
    i -= di;
    j -= dj;
    r -= di + dj;
    off -= (di + dj) * WB + di;
    tmp = is_m ? cm : (is_d ? cd : ci);
    s = s1;
  } while (i >= 0 && j >= 0 && r >= base);
  i_ = i;
  j_ = j;
  s_ = s;
}

template <bool SPLICE>
__global__ void __launch_bounds__(32)
traceback_kernel(const uint8_t* __restrict__ p, const int* __restrict__ lens,
                 uint8_t* __restrict__ ops, int* __restrict__ fin, int RT,
                 int W, int RB, int w, int QP) {
  extern __shared__ uint4 smem[];
  uint8_t* win = (uint8_t*)smem;
  uint8_t* sops = win + 2 * BUF;
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  const int qlen = lens[2 * n], tlen = lens[2 * n + 1];
  const uint8_t* prow = p + (size_t)n * RT * W;
  uint8_t* orow = ops + (size_t)n * RT;
  int i = tlen - 1, j = qlen - 1, s = 0;
  const int r0 = i + j;
  if (i < 0 || j < 0 || r0 >= RT) {       // the walk never starts
    zero_row(orow, 0, RT, lane);
    if (lane == 0) {
      fin[2 * n] = i;
      fin[2 * n + 1] = j;
    }
    return;
  }
  int c = r0 / K;
  zero_row(orow, (c + 1) * K, RT, lane);
  // chunk c's window: the walk enters it at column i
  int A = floor16(i - 2 * K + 1);
  fetch_window<SPLICE>(win + (c & 1) * BUF, prow, c, A, r0, W, RB, w, QP,
                       lane);
  __pipeline_commit();
  for (;;) {
    // the walk enters chunk c at column i: chunk c - 1's window
    const int A_next = floor16(i - 2 * K + 1);
    if (c > 0)
      fetch_window<SPLICE>(win + ((c - 1) & 1) * BUF, prow, c - 1, A_next,
                           r0, W, RB, w, QP, lane);
    __pipeline_commit();
    __pipeline_wait_prior(1);             // chunk c's window is in
    for (int k = lane; k < K; k += 32) sops[k] = 0;
    __syncwarp();
    if (lane == 0)
      walk_chunk<SPLICE>(win + (c & 1) * BUF, c * K, A, qlen, tlen, w, i, j,
                         s, sops);
    __syncwarp();
    for (int k = lane; k < K && c * K + k < RT; k += 32)
      orow[c * K + k] = sops[k];
    i = __shfl_sync(FULL, i, 0);
    j = __shfl_sync(FULL, j, 0);
    s = __shfl_sync(FULL, s, 0);
    if (i < 0 || j < 0) break;
    --c;
    A = A_next;
  }
  zero_row(orow, 0, c * K, lane);
  if (lane == 0) {
    fin[2 * n] = i;
    fin[2 * n + 1] = j;
  }
}

}  // namespace

extern "C" int mm2_traceback(const void* p, const void* lens, void* ops,
                             void* fin, int N, int RT, int W, int RB, int w,
                             int splice, int QP, void* stream) {
  if (N == 0) return 0;
  if (W % 16 != 0) return (int)cudaErrorInvalidValue;
  const auto kernel = splice ? traceback_kernel<true>
                             : traceback_kernel<false>;
  kernel<<<N, 32, SMEM, (cudaStream_t)stream>>>(
      (const uint8_t*)p, (const int*)lens, (uint8_t*)ops, (int*)fin, RT, W,
      RB, w, QP);
  return (int)cudaGetLastError();
}

// blocks (one job each) of the traceback one SM holds at once
extern "C" int mm2_traceback_occupancy(int splice, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, splice ? traceback_kernel<true> : traceback_kernel<false>, 32,
      SMEM);
}
