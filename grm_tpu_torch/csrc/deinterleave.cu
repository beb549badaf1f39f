// The artifact's matrix split for Hopper (sm_90a): a chunk of the on-disk
// (W64, c) uint64 matrix into columns [lo, lo + c) of the (n_words, K) 32-bit
// device matrix,
//
//     dst[2w,     lo + j] = src[w, j] >> 32          (genomes [64w, 64w+32))
//     dst[2w + 1, lo + j] = src[w, j] & 0xffffffff   (genomes [64w+32, 64w+64))
//
// with row 2w + 1 dropped where it is n_words (the padding half past the
// last genome of an odd word count).
//
// Replaces grm_tpu/ops/popcount.py:69 _deinterleave_u64_view, the XLA
// program that splits the uploaded raw words on the TPU (no pallas_call).
// Here the chunks arrive through a pinned staging ring
// (grm_tpu_torch/ops/popcount.py, BitMatrix.from_u64), so the card holds the
// matrix plus two chunks, as grm_tpu's donated input holds it to one matrix.
//
// What bounds it on the H100: device memory. Each chunk is read once
// (W64 * c * 8 bytes) and written once (n_words * c * 4 bytes), with no
// arithmetic to speak of: the least time is those bytes at 3.35 TB/s.
//
// What the design does about it: a layout copy, kept simple. One thread per
// (u64 row, 4 columns): two 16-byte loads of the four words, one 16-byte
// store of their high halves and one of their low halves, so a warp reads
// 1 KB and writes two 512-byte runs, all coalesced. A thread whose group is
// ragged (the chunk's last columns) or whose addresses are not 16-byte
// aligned (K or lo not a multiple of 4) copies word by word.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) deinterleave_u64_kernel(
    const unsigned long long* __restrict__ src, long long c,
    int n_words, int32_t* __restrict__ dst, long long k, long long lo) {
  const long long col = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (col >= c) return;
  const int w = blockIdx.y;
  const bool has_low = 2 * w + 1 < n_words;
  const unsigned long long* s = src + (size_t)w * c + col;
  int32_t* hi = dst + (size_t)(2 * w) * k + lo + col;
  int32_t* lw = hi + k;
  const bool vector = col + 4 <= c && (reinterpret_cast<uintptr_t>(s) & 15) == 0
      && (reinterpret_cast<uintptr_t>(hi) & 15) == 0
      && (reinterpret_cast<uintptr_t>(lw) & 15) == 0;
  if (vector) {
    const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(s));
    const ulonglong2 b = __ldg(reinterpret_cast<const ulonglong2*>(s) + 1);
    *reinterpret_cast<int4*>(hi) = make_int4(
        (int)(a.x >> 32), (int)(a.y >> 32), (int)(b.x >> 32), (int)(b.y >> 32));
    if (has_low) {
      *reinterpret_cast<int4*>(lw) = make_int4(
          (int)(uint32_t)a.x, (int)(uint32_t)a.y, (int)(uint32_t)b.x,
          (int)(uint32_t)b.y);
    }
    return;
  }
  const int n = c - col < 4 ? (int)(c - col) : 4;
  for (int j = 0; j < n; ++j) {
    const unsigned long long v = __ldg(s + j);
    hi[j] = (int)(v >> 32);
    if (has_low) lw[j] = (int)(uint32_t)v;
  }
}

}  // namespace

// src: (w64, c) uint64, contiguous; dst: (n_words, k) int32, contiguous,
// written at columns [lo, lo + c). n_words is 2 * w64 or 2 * w64 - 1.
extern "C" int grm_deinterleave_u64(const void* src, int w64, long long c,
                                    void* dst, int n_words, long long k,
                                    long long lo, void* stream) {
  if (c <= 0 || w64 <= 0) return 0;
  const long long groups = (c + 3) / 4;
  const dim3 grid((unsigned)((groups + kThreads - 1) / kThreads),
                  (unsigned)w64);
  deinterleave_u64_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)src, c, n_words, (int32_t*)dst, k, lo);
  return (int)cudaGetLastError();
}
