// SCM utility sweep for Hopper (sm_90a): for F fits at once, the presence
// counts of every k-mer among each fit's negative and positive examples,
//
//     cn[f, k] = sum_w popcount(matrix[w, k] & neg[f, w])
//     cp[f, k] = sum_w popcount(matrix[w, k] & pos[f, w])
//
// reduced inside the kernel to small per-block results by one of two
// epilogues, so no count ever reaches device memory:
//
//   kArgmax (replaces grm_tpu/ops/pallas_scm_sweep.py:211
//   scm_utility_argmax_pallas, kernel body _make_kernel :105): per block of
//   `block_cols` columns and per fit, the min of u_min and the max of u_max,
//   with u_abs = cn - p * cp; u_min masks presence rules that cover nothing
//   (cn + cp == n_neg + n_pos) and u_max absence rules that cover nothing
//   (cn + cp == 0), to +-FLT_MAX as the Pallas kernel does. Unlike the Pallas
//   kernel it also applies the rule-exclusion mask (the k-mer blacklist),
//   so one kernel serves the argmax engine with and without a blacklist.
//
//   kSuperblockMax (replaces the XLA program grm_tpu/parallel/scm_exact.py:68
//   _pass1, which has the same core): per fit and per superblock of
//   `block_cols` columns, max(u_pres, u_abs) with
//   u_pres = (n_neg - cn) - p * (n_pos - cp); excluded rules are -inf and
//   there is no zero-coverage filter.
//
// Columns at or past `limit` are padding: +-FLT_MAX (kArgmax) or -inf
// (kSuperblockMax). One CUDA block owns one column block and loops over all
// of it, so the result needs no atomics and is deterministic.
//
// Rounding: the utilities are written with __fmul_rn / __fsub_rn (and the
// library is built with -fmad=false) so that every product and difference
// rounds once, exactly as the plain PyTorch version's separate mul and sub
// do. A fused multiply-add would round once where PyTorch rounds twice.
//
// What bounds it on the H100: integer operations. Each column costs W
// 4-byte loads but 2 * F * W AND + POPC + ADD; at F = 100..128 fits the
// popc work (16 per clock per SM) outweighs the matrix read by ~50x.
//
// What the design does about it: one thread per column (coalesced loads of
// matrix row w), the fit masks in shared memory laid out [w][fit] so a
// 16-byte load brings one word of four fits' masks (8 LDS.128 per word and
// fit group of 16, not 32 LDS.32), 16 fits' counts in registers per pass,
// and the matrix words of a block re-read from L1/L2 once per fit group.
// The tensor-core route (b1 mma with AND + POPC) is later work.
//
// Plain C interface for ctypes; returns cudaGetLastError().

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFitGroup = 16;

enum Epilogue { kArgmax = 0, kSuperblockMax = 1 };

// Shared memory: masks [w][2 * fits_pad] (neg fits, then pos fits), then
// n_neg, n_pos (int) and p (float) per fit, then the reduction scratch.
__host__ __device__ inline size_t smem_bytes(int n_words, int fits_pad) {
  return (size_t)n_words * 2 * fits_pad * sizeof(uint32_t) +
         (size_t)3 * fits_pad * sizeof(float) +
         (size_t)2 * kWarps * kFitGroup * sizeof(float);
}

template <int EPI>
__global__ void __launch_bounds__(kThreads) scm_sweep_kernel(
    const uint32_t* __restrict__ matrix, int n_words, long long n_cols,
    long long limit, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ pos, const int32_t* __restrict__ n_neg,
    const int32_t* __restrict__ n_pos, const float* __restrict__ ps,
    int n_fits, int fits_per_block, int fits_pad,
    const uint8_t* __restrict__ excl, int block_cols, int n_blocks,
    float* __restrict__ out_a, float* __restrict__ out_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* s_masks = reinterpret_cast<uint32_t*>(smem_raw);
  int32_t* s_nn = reinterpret_cast<int32_t*>(s_masks + (size_t)n_words * 2 * fits_pad);
  int32_t* s_np = s_nn + fits_pad;
  float* s_p = reinterpret_cast<float*>(s_np + fits_pad);
  float* s_red = s_p + fits_pad;

  const int f_lo = blockIdx.y * fits_per_block;
  const int fc = min(fits_per_block, n_fits - f_lo);
  for (int i = threadIdx.x; i < n_words * fits_pad; i += kThreads) {
    const int w = i / fits_pad;
    const int f = i % fits_pad;
    const bool live = f < fc;
    const size_t src = (size_t)(f_lo + f) * n_words + w;
    s_masks[(size_t)w * 2 * fits_pad + f] = live ? neg[src] : 0u;
    s_masks[(size_t)w * 2 * fits_pad + fits_pad + f] = live ? pos[src] : 0u;
  }
  for (int f = threadIdx.x; f < fits_pad; f += kThreads) {
    const bool live = f < fc;
    s_nn[f] = live ? n_neg[f_lo + f] : 0;
    s_np[f] = live ? n_pos[f_lo + f] : 0;
    s_p[f] = live ? ps[f_lo + f] : 0.0f;
  }
  __syncthreads();

  const long long col_lo = (long long)blockIdx.x * block_cols;
  const long long col_hi = min(col_lo + (long long)block_cols, limit);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int g = 0; g < fc; g += kFitGroup) {
    float best_a[kFitGroup];
    float best_b[kFitGroup];
#pragma unroll
    for (int j = 0; j < kFitGroup; ++j) {
      best_a[j] = EPI == kArgmax ? FLT_MAX : -INFINITY;
      best_b[j] = -FLT_MAX;
    }
    for (long long k = col_lo + threadIdx.x; k < col_hi; k += kThreads) {
      int cn[kFitGroup];
      int cp[kFitGroup];
#pragma unroll
      for (int j = 0; j < kFitGroup; ++j) {
        cn[j] = 0;
        cp[j] = 0;
      }
      for (int w = 0; w < n_words; ++w) {
        const uint32_t word = __ldg(matrix + (size_t)w * n_cols + k);
        const uint4* row_neg =
            reinterpret_cast<const uint4*>(s_masks + (size_t)w * 2 * fits_pad + g);
        const uint4* row_pos = reinterpret_cast<const uint4*>(
            s_masks + (size_t)w * 2 * fits_pad + fits_pad + g);
#pragma unroll
        for (int q = 0; q < kFitGroup / 4; ++q) {
          const uint4 mn = row_neg[q];
          const uint4 mp = row_pos[q];
          cn[4 * q + 0] += __popc(word & mn.x);
          cn[4 * q + 1] += __popc(word & mn.y);
          cn[4 * q + 2] += __popc(word & mn.z);
          cn[4 * q + 3] += __popc(word & mn.w);
          cp[4 * q + 0] += __popc(word & mp.x);
          cp[4 * q + 1] += __popc(word & mp.y);
          cp[4 * q + 2] += __popc(word & mp.z);
          cp[4 * q + 3] += __popc(word & mp.w);
        }
      }
      bool ex_p = false;
      bool ex_a = false;
      if (excl != nullptr) {
        ex_p = excl[k] != 0;
        ex_a = excl[n_cols + k] != 0;
      }
#pragma unroll
      for (int j = 0; j < kFitGroup; ++j) {
        const float cnf = (float)cn[j];
        const float cpf = (float)cp[j];
        const float p = s_p[g + j];
        if (EPI == kArgmax) {
          const float u = __fsub_rn(cnf, __fmul_rn(p, cpf));
          const int s = cn[j] + cp[j];
          const float u_min = (s == s_nn[g + j] + s_np[g + j] || ex_p) ? FLT_MAX : u;
          const float u_max = (s == 0 || ex_a) ? -FLT_MAX : u;
          best_a[j] = fminf(best_a[j], u_min);
          best_b[j] = fmaxf(best_b[j], u_max);
        } else {
          const float u_pres =
              ex_p ? -INFINITY
                   : __fsub_rn(__fsub_rn((float)s_nn[g + j], cnf),
                               __fmul_rn(p, __fsub_rn((float)s_np[g + j], cpf)));
          const float u_abs = ex_a ? -INFINITY : __fsub_rn(cnf, __fmul_rn(p, cpf));
          best_a[j] = fmaxf(best_a[j], fmaxf(u_pres, u_abs));
        }
      }
    }

    // Block reduction: min/max are exact, so the order does not matter.
#pragma unroll
    for (int j = 0; j < kFitGroup; ++j) {
      float a = best_a[j];
      float b = best_b[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float oa = __shfl_xor_sync(0xffffffffu, a, off);
        const float ob = EPI == kArgmax ? __shfl_xor_sync(0xffffffffu, b, off) : b;
        a = EPI == kArgmax ? fminf(a, oa) : fmaxf(a, oa);
        if (EPI == kArgmax) b = fmaxf(b, ob);
      }
      if (lane == 0) {
        s_red[warp * kFitGroup + j] = a;
        s_red[(kWarps + warp) * kFitGroup + j] = b;
      }
    }
    __syncthreads();
    if (threadIdx.x < kFitGroup && g + (int)threadIdx.x < fc) {
      const int j = threadIdx.x;
      float a = s_red[j];
      float b = s_red[kWarps * kFitGroup + j];
      for (int wp = 1; wp < kWarps; ++wp) {
        const float oa = s_red[wp * kFitGroup + j];
        a = EPI == kArgmax ? fminf(a, oa) : fmaxf(a, oa);
        b = fmaxf(b, s_red[(kWarps + wp) * kFitGroup + j]);
      }
      const int fit = f_lo + g + j;
      if (EPI == kArgmax) {
        out_a[(size_t)blockIdx.x * n_fits + fit] = a;
        out_b[(size_t)blockIdx.x * n_fits + fit] = b;
      } else {
        out_a[(size_t)fit * n_blocks + blockIdx.x] = a;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// epilogue 0 = kArgmax: out_a = block minima (n_blocks, n_fits), out_b =
// block maxima (n_blocks, n_fits). epilogue 1 = kSuperblockMax: out_a =
// (n_fits, n_blocks), out_b unused. n_blocks = ceil(n_cols / block_cols);
// grid row y takes fits [y * fits_per_block, (y + 1) * fits_per_block);
// excl is (2, n_cols) bytes (row 0 presence, row 1 absence) or null.
extern "C" int grm_scm_sweep(int epilogue, const void* matrix, int n_words,
                             long long n_cols, long long limit,
                             const void* neg, const void* pos,
                             const void* n_neg, const void* n_pos,
                             const void* ps, int n_fits, int fits_per_block,
                             const void* excl, int block_cols, void* out_a,
                             void* out_b, void* stream) {
  const int fits_pad = (fits_per_block + kFitGroup - 1) / kFitGroup * kFitGroup;
  const size_t smem = smem_bytes(n_words, fits_pad);
  const int n_blocks = (int)((n_cols + block_cols - 1) / block_cols);
  const dim3 grid(n_blocks, (n_fits + fits_per_block - 1) / fits_per_block);
  cudaStream_t s = (cudaStream_t)stream;
#define GRM_LAUNCH(EPI)                                                      \
  do {                                                                       \
    if (smem > 48 * 1024) {                                                  \
      cudaError_t e = cudaFuncSetAttribute(                                  \
          scm_sweep_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          (int)smem);                                                        \
      if (e != cudaSuccess) return (int)e;                                   \
    }                                                                        \
    scm_sweep_kernel<EPI><<<grid, kThreads, smem, s>>>(                      \
        (const uint32_t*)matrix, n_words, n_cols, limit,                     \
        (const uint32_t*)neg, (const uint32_t*)pos, (const int32_t*)n_neg,   \
        (const int32_t*)n_pos, (const float*)ps, n_fits, fits_per_block,     \
        fits_pad, (const uint8_t*)excl, block_cols, n_blocks,                \
        (float*)out_a, (float*)out_b);                                       \
  } while (0)
  if (epilogue == kArgmax) {
    GRM_LAUNCH(kArgmax);
  } else {
    GRM_LAUNCH(kSuperblockMax);
  }
#undef GRM_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" long long grm_scm_sweep_smem_bytes(int n_words, int fits_per_block) {
  const int fits_pad = (fits_per_block + kFitGroup - 1) / kFitGroup * kFitGroup;
  return (long long)smem_bytes(n_words, fits_pad);
}
