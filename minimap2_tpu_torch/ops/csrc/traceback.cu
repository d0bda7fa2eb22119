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
// dependent steps, each a one-byte load from p (which does not fit in L2)
// whose value picks the next address; the bytes it reads are one per
// visited diagonal.  Design: one block per job; thread 0 walks, writing
// its op bytes into a zeroed shared-memory row of RT bytes, and the block
// then writes the whole row to device memory in one coalesced pass.  Steps
// the band forces skip their load.  The launch runs every job of a
// sub-batch at once, so the card overlaps the jobs' walks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int wstart(int r, int w) {
  const int a = (r - w + 1) >> 1;
  return ((a > 0 ? a : 0) >> 4) << 4;
}

// query-edge window start of exts2's rows
__device__ __forceinline__ int wstart_q(int r, int QP) {
  const int a = r - QP + 1;
  return ((a > 0 ? a : 0) >> 4) << 4;
}

__global__ void traceback_kernel(const uint8_t* __restrict__ p,
                                 const int* __restrict__ lens,
                                 uint8_t* __restrict__ ops,
                                 int* __restrict__ fin, int RT, int W,
                                 int RB, int w, int splice, int QP) {
  extern __shared__ uint8_t sops[];
  const int n = blockIdx.x;
  for (int k = threadIdx.x; k < RT; k += THREADS) sops[k] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int qlen = lens[2 * n], tlen = lens[2 * n + 1];
    const uint8_t* prow = p + (size_t)n * RT * W;
    int i = tlen - 1, j = qlen - 1, s = 0;
    while (i >= 0 && j >= 0) {
      const int r = i + j;
      if (r >= RT) break;            // the walk never starts
      int st0 = max(0, r - qlen + 1), en0 = min(tlen - 1, r), ws;
      if (splice) {
        ws = wstart_q(r, QP);
      } else {
        st0 = max(st0, (r - w + 1) >> 1);
        en0 = min(en0, (r + w) >> 1);
        ws = wstart((r / RB) * RB, w);
      }
      int s1;
      if (i > en0) {
        s1 = 1;
      } else if (i < st0) {
        s1 = 2;
      } else {
        const int col = i - ws;
        const int tmp = (col >= 0 && col < W) ? prow[(size_t)r * W + col] : 0;
        s1 = s == 0 ? (tmp & 7) : (((tmp >> (s + 2)) & 1) ? s : 0);
        if (s1 == 0) s1 = tmp & 7;
      }
      const bool is_m = s1 == 0, is_d = s1 == 1 || s1 == 3;
      sops[r] = is_m ? 1 : (splice && s1 == 3) ? 4 : (is_d ? 3 : 2);
      if (is_m || is_d) --i;
      if (is_m || !is_d) --j;
      s = s1;
    }
    fin[2 * n] = i;
    fin[2 * n + 1] = j;
  }
  __syncthreads();
  uint8_t* orow = ops + (size_t)n * RT;
  for (int k = threadIdx.x; k < RT; k += THREADS) orow[k] = sops[k];
}

}  // namespace

extern "C" int mm2_traceback(const void* p, const void* lens, void* ops,
                             void* fin, int N, int RT, int W, int RB, int w,
                             int splice, int QP, void* stream) {
  if (N == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RT);
  if (err != cudaSuccess) return (int)err;
  traceback_kernel<<<N, THREADS, RT, (cudaStream_t)stream>>>(
      (const uint8_t*)p, (const int*)lens, (uint8_t*)ops, (int*)fin, RT, W,
      RB, w, splice, QP);
  return (int)cudaGetLastError();
}
