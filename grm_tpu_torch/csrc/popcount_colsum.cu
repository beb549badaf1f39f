// Masked popcount column sums for Hopper (sm_90a):
//
//     counts[c, k] = sum_w popcount(matrix[w, k] & masks[c, w])
//
// Replaces grm_tpu/ops/pallas_popcount.py:94 popcount_colsum_pallas (kernel
// body _kernel, :47) and its XLA twin grm_tpu/ops/popcount.py:115
// _colsum_xla. The matrix is the packed genome x k-mer presence matrix,
// (W, K) 32-bit words, genome g at word g / 32, bit 31 - g % 32.
//
// What bounds it on the H100: device memory. A column costs W 4-byte loads
// and C * W AND + POPC + ADD. At the main path's mask counts (C <= 12) the
// popc work (C * W * K at 16 popc per clock per SM) stays under the time
// of the one (W * K * 4)-byte read at 3.35 TB/s.
//
// What the design does about it: one thread per column, so a warp reads 32
// consecutive words of matrix row w (128-byte coalesced transactions) and
// the matrix is read once per launch for up to kMaskChunk masks. The masks
// sit in shared memory (all threads read the same word: a broadcast) and the
// counts in registers. More masks than kMaskChunk re-read the column's words
// from L1/L2, not from device memory. The GPU needs no int8 unpack: __popc
// works on the packed words directly.
//
// The pair-batched entry serves the exact SCM engine's pass 2 and the argmax
// engine's winner-block recount: P pairs, each a column offset plus its own
// two masks, count `width` columns from their offset -> (P, 2, width).
// Columns outside [0, K) count 0. Both entries run count_column.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaskChunk = 8;

__device__ __forceinline__ void count_column(
    const uint32_t* __restrict__ matrix, int n_words, long long n_cols,
    long long col, const uint32_t* masks, int n_masks,
    int32_t* __restrict__ out, long long out_stride) {
  for (int c0 = 0; c0 < n_masks; c0 += kMaskChunk) {
    int acc[kMaskChunk];
#pragma unroll
    for (int j = 0; j < kMaskChunk; ++j) acc[j] = 0;
    for (int w = 0; w < n_words; ++w) {
      const uint32_t word = __ldg(matrix + (size_t)w * n_cols + col);
#pragma unroll
      for (int j = 0; j < kMaskChunk; ++j) {
        if (c0 + j < n_masks) {
          acc[j] += __popc(word & masks[(c0 + j) * n_words + w]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaskChunk; ++j) {
      if (c0 + j < n_masks) out[(size_t)(c0 + j) * out_stride] = acc[j];
    }
  }
}

// masks (C, W); out (C, K).
__global__ void __launch_bounds__(kThreads) colsum_kernel(
    const uint32_t* __restrict__ matrix, int n_words, long long n_cols,
    const uint32_t* __restrict__ masks, int n_masks,
    int32_t* __restrict__ out) {
  extern __shared__ uint32_t s_masks[];
  for (int i = threadIdx.x; i < n_masks * n_words; i += kThreads) {
    s_masks[i] = masks[i];
  }
  __syncthreads();
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= n_cols) return;
  count_column(matrix, n_words, n_cols, col, s_masks, n_masks, out + col,
               n_cols);
}

// masks (P, 2, W); offsets (P,); out (P, 2, width). Block row y = pair.
__global__ void __launch_bounds__(kThreads) colsum_pairs_kernel(
    const uint32_t* __restrict__ matrix, int n_words, long long n_cols,
    const uint32_t* __restrict__ masks, const long long* __restrict__ offsets,
    int width, int32_t* __restrict__ out) {
  extern __shared__ uint32_t s_masks[];
  const int pair = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * n_words; i += kThreads) {
    s_masks[i] = masks[(size_t)pair * 2 * n_words + i];
  }
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= width) return;
  const long long col = offsets[pair] + j;
  int32_t* o = out + (size_t)pair * 2 * width + j;
  if (col < 0 || col >= n_cols) {
    o[0] = 0;
    o[width] = 0;
    return;
  }
  count_column(matrix, n_words, n_cols, col, s_masks, 2, o, width);
}

}  // namespace

extern "C" int grm_popcount_colsum(const void* matrix, int n_words,
                                   long long n_cols, const void* masks,
                                   int n_masks, void* out, void* stream) {
  const size_t smem = (size_t)n_masks * n_words * sizeof(uint32_t);
  const long long blocks = (n_cols + kThreads - 1) / kThreads;
  colsum_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)matrix, n_words, n_cols, (const uint32_t*)masks,
      n_masks, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int grm_popcount_colsum_pairs(const void* matrix, int n_words,
                                         long long n_cols, const void* masks,
                                         const void* offsets, int n_pairs,
                                         int width, void* out, void* stream) {
  const size_t smem = (size_t)2 * n_words * sizeof(uint32_t);
  const dim3 grid((width + kThreads - 1) / kThreads, n_pairs);
  colsum_pairs_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)matrix, n_words, n_cols, (const uint32_t*)masks,
      (const long long*)offsets, width, (int32_t*)out);
  return (int)cudaGetLastError();
}
