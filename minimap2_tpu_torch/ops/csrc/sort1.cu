// Row-wise ascending bitonic sort of one u32 plane on Hopper.
//
// Replaces minimap2_tpu/ops/sort_pallas.py: sort1_rows -> _sort1_kernel (the
// Pallas kernel at sort_pallas.py:100-117, called at :130).  The HPC route
// sorts run-end keys (position, or 0x7FFFFFFF off a run end) of 512 rows x
// 16384 lanes to compact each read's homopolymer-run ends in order.
//
// What bounds it: the compare-exchange network, (A/2) log2(A) (log2(A)+1)/2
// compare-exchanges a row with a barrier between stages; device memory sees
// each lane read once and written once (8 bytes).  Design: sort3.cu's, for
// one plane: one block per row holds the row in dynamic shared memory (4
// bytes a lane: 64 KB at 16384 lanes, above the 48 KB default, hence the
// opt-in), every stage runs out of shared memory, and device memory is
// touched once on the way in and once on the way out.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void sort1_kernel(const uint32_t* __restrict__ k1,
                             uint32_t* __restrict__ o1, int A) {
  extern __shared__ uint32_t s1[];
  const size_t base = (size_t)blockIdx.x * A;
  for (int i = threadIdx.x; i < A; i += blockDim.x) s1[i] = k1[base + i];
  __syncthreads();
  const int half = A >> 1;
  for (int kk = 2; kk <= A; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));   // bit j of i clear
        const int l = i + j;
        const uint32_t a = s1[i], b = s1[l];
        const bool asc = (i & kk) == 0;
        if (asc ? a > b : b > a) {
          s1[i] = b;
          s1[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < A; i += blockDim.x) o1[base + i] = s1[i];
}

}  // namespace

extern "C" int mm2_sort1(const void* k1, void* o1, int B, int A,
                         void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)A * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sort1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = A / 2 < 1024 ? A / 2 : 1024;
  sort1_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)k1, (uint32_t*)o1, A);
  return (int)cudaGetLastError();
}
