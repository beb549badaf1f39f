// CART frontier sweep for Hopper (sm_90a): for N tree nodes at once, the
// presence-rule split of every k-mer column scored by the sum of both
// children's altered-prior impurity, reduced inside the kernel to one
// (least score, lowest column) pair per column block and node.
//
// Replaces grm_tpu/ops/pallas_cart_sweep.py:145 cart_frontier_scores_pallas
// (kernel body _make_kernel :78, impurity _child_score :56) and, because the
// exclusion mask lives here, the per-node XLA scorer
// grm_tpu/parallel/cart_device.py:30 _best_split that a blacklist forced.
//
//     left[n, c, k]  = sum_w popcount(matrix[w, k] & masks[n, c, w])
//     right[n, c, k] = n_node[n, c] - left[n, c, k]
//     p = scale[n, c] * count,  p_t = sum_c p            (class order)
//     gini child          = (p_t * p_t - sum_c p * p) / p_t   where p_t > 0
//     cross-entropy child = (-sum_c [f > 0] f * log f) * p_t, f = p / p_t
//     score = child(left) + child(right)
//
// A column scores +inf when either child is empty (integer test), when it
// is at or past `limit` (padding) and when the exclusion mask bans it. Per
// node the kernel keeps the least score and the LOWEST column reaching it;
// a block in which no column of a node is valid writes (+inf, INT_MAX).
// One CUDA block owns one column block, so the result needs no atomics and
// is deterministic; the reduction over blocks (NB x N pairs) is left to
// the caller. No (N, C, K) count array reaches device memory.
//
// Rounding: every product, sum, difference and quotient is written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (and the library is built
// with -fmad=false), in the plain PyTorch version's order, so each rounds
// once exactly as PyTorch's separate operations do. logf is CUDA's
// single-precision log (never __logf, never -use_fast_math).
//
// What bounds it on the H100: integer throughput. Each column costs W 4-byte
// loads but N * C * W AND + POPC + ADD (16 popc per clock per SM), then per
// node 2 divisions (Gini) or 2C divisions and 2C logs (cross-entropy). At
// W = 11, C = 2 the popc term (22 per node and column) leads the
// special-function term always and the one matrix read from N = 3 nodes on.
//
// What the design does about it: one thread per column (coalesced loads of
// matrix row w), the (node, class) masks in shared memory laid out
// [w][node * C + class] so one 16-byte load brings one word of four masks,
// the counts of a group of nodes (8 nodes for C <= 2, else 4) in registers
// per pass, and the matrix words of a block re-read from L1/L2 once per
// node group. Nodes beyond the shared-memory budget go to grid rows.
//
// Plain C interface for ctypes; returns cudaGetLastError().

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;

enum Criterion { kGini = 0, kCrossEntropy = 1 };

// Nodes whose counts one pass keeps in registers; group * C is a multiple
// of 4 for every C, so a group's masks are whole 16-byte loads.
__host__ __device__ constexpr int node_group(int n_classes) {
  return n_classes <= 2 ? 8 : 4;
}

// Shared memory: masks [w][nodes_pad * C], then n_node (int) and scale
// (float) per (node, class), then the reduction scratch.
__host__ __device__ inline size_t smem_bytes(int n_words, int nodes_pad,
                                             int n_classes) {
  return (size_t)n_words * nodes_pad * n_classes * sizeof(uint32_t) +
         (size_t)2 * nodes_pad * n_classes * sizeof(float) +
         (size_t)2 * kWarps * kMaxGroup * sizeof(float);
}

template <int C, int CRIT>
__device__ __forceinline__ float child_score(const float (&p)[C]) {
  float p_t = p[0];
#pragma unroll
  for (int c = 1; c < C; ++c) p_t = __fadd_rn(p_t, p[c]);
  if (CRIT == kGini) {
    float sq = __fmul_rn(p[0], p[0]);
#pragma unroll
    for (int c = 1; c < C; ++c) sq = __fadd_rn(sq, __fmul_rn(p[c], p[c]));
    const float num = __fsub_rn(__fmul_rn(p_t, p_t), sq);
    return p_t > 0.0f ? __fdiv_rn(num, p_t) : 0.0f;
  }
  float ent = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float frac = p_t > 0.0f ? __fdiv_rn(p[c], p_t) : 0.0f;
    const float term = frac > 0.0f ? __fmul_rn(frac, logf(frac)) : 0.0f;
    ent = __fsub_rn(ent, term);
  }
  return __fmul_rn(ent, p_t);
}

template <int C, int CRIT>
__global__ void __launch_bounds__(kThreads) cart_sweep_kernel(
    const uint32_t* __restrict__ matrix, int n_words, long long n_cols,
    long long limit, const uint32_t* __restrict__ masks,
    const int32_t* __restrict__ n_node, const float* __restrict__ scale,
    int n_nodes, int nodes_per_block, int nodes_pad,
    const uint8_t* __restrict__ excl, int block_cols,
    float* __restrict__ out_score, int32_t* __restrict__ out_col) {
  constexpr int G = node_group(C);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = nodes_pad * C;
  uint32_t* s_masks = reinterpret_cast<uint32_t*>(smem_raw);
  int32_t* s_nn = reinterpret_cast<int32_t*>(s_masks + (size_t)n_words * stride);
  float* s_scale = reinterpret_cast<float*>(s_nn + stride);
  float* s_red_s = s_scale + stride;
  int32_t* s_red_c = reinterpret_cast<int32_t*>(s_red_s + kWarps * kMaxGroup);

  const int n_lo = blockIdx.y * nodes_per_block;
  const int nc = min(nodes_per_block, n_nodes - n_lo);
  for (int i = threadIdx.x; i < n_words * stride; i += kThreads) {
    const int w = i / stride;
    const int m = i % stride;  // node * C + class
    s_masks[i] = m < nc * C
                     ? masks[((size_t)n_lo * C + m) * n_words + w]
                     : 0u;
  }
  for (int m = threadIdx.x; m < stride; m += kThreads) {
    const bool live = m < nc * C;
    s_nn[m] = live ? n_node[(size_t)n_lo * C + m] : 0;
    s_scale[m] = live ? scale[(size_t)n_lo * C + m] : 0.0f;
  }
  __syncthreads();

  const long long col_lo = (long long)blockIdx.x * block_cols;
  const long long col_hi =
      min(col_lo + (long long)block_cols, min(limit, n_cols));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int g = 0; g < nc; g += G) {
    float best_s[G];
    int32_t best_c[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      best_s[j] = INFINITY;
      best_c[j] = INT_MAX;
    }
    // A thread visits its columns in ascending order, so the strict
    // comparison keeps the lowest column among equal scores.
    for (long long k = col_lo + threadIdx.x; k < col_hi; k += kThreads) {
      if (excl != nullptr && excl[k] != 0) continue;
      int cnt[G * C];
#pragma unroll
      for (int j = 0; j < G * C; ++j) cnt[j] = 0;
      for (int w = 0; w < n_words; ++w) {
        const uint32_t word = __ldg(matrix + (size_t)w * n_cols + k);
        const uint4* row = reinterpret_cast<const uint4*>(
            s_masks + (size_t)w * stride + g * C);
#pragma unroll
        for (int q = 0; q < G * C / 4; ++q) {
          const uint4 m = row[q];
          cnt[4 * q + 0] += __popc(word & m.x);
          cnt[4 * q + 1] += __popc(word & m.y);
          cnt[4 * q + 2] += __popc(word & m.z);
          cnt[4 * q + 3] += __popc(word & m.w);
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float pl[C];
        float pr[C];
        int left_n = 0;
        int right_n = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int left = cnt[j * C + c];
          const int right = s_nn[(g + j) * C + c] - left;
          const float sc = s_scale[(g + j) * C + c];
          left_n += left;
          right_n += right;
          pl[c] = __fmul_rn(sc, (float)left);
          pr[c] = __fmul_rn(sc, (float)right);
        }
        if (left_n == 0 || right_n == 0) continue;
        const float score =
            __fadd_rn(child_score<C, CRIT>(pl), child_score<C, CRIT>(pr));
        if (score < best_s[j]) {
          best_s[j] = score;
          best_c[j] = (int32_t)k;
        }
      }
    }

    // Block reduction of (score, column) pairs, least score first and then
    // lowest column: exact, so the order of the steps does not matter.
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float s = best_s[j];
      int32_t c = best_c[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, s, off);
        const int32_t oc = __shfl_xor_sync(0xffffffffu, c, off);
        if (os < s || (os == s && oc < c)) {
          s = os;
          c = oc;
        }
      }
      if (lane == 0) {
        s_red_s[warp * kMaxGroup + j] = s;
        s_red_c[warp * kMaxGroup + j] = c;
      }
    }
    __syncthreads();
    if (threadIdx.x < G && g + (int)threadIdx.x < nc) {
      const int j = threadIdx.x;
      float s = s_red_s[j];
      int32_t c = s_red_c[j];
      for (int wp = 1; wp < kWarps; ++wp) {
        const float os = s_red_s[wp * kMaxGroup + j];
        const int32_t oc = s_red_c[wp * kMaxGroup + j];
        if (os < s || (os == s && oc < c)) {
          s = os;
          c = oc;
        }
      }
      const size_t o = (size_t)blockIdx.x * n_nodes + n_lo + g + j;
      out_score[o] = s;
      out_col[o] = c;
    }
    __syncthreads();
  }
}

inline int pad_nodes(int nodes_per_block, int n_classes) {
  const int g = node_group(n_classes);
  return (nodes_per_block + g - 1) / g * g;
}

template <int C, int CRIT>
int launch(const void* matrix, int n_words, long long n_cols, long long limit,
           const void* masks, const void* n_node, const void* scale,
           int n_nodes, int nodes_per_block, const void* excl, int block_cols,
           void* out_score, void* out_col, void* stream) {
  const int nodes_pad = pad_nodes(nodes_per_block, C);
  const size_t smem = smem_bytes(n_words, nodes_pad, C);
  const int n_blocks = (int)((n_cols + block_cols - 1) / block_cols);
  const dim3 grid(n_blocks, (n_nodes + nodes_per_block - 1) / nodes_per_block);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cart_sweep_kernel<C, CRIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cart_sweep_kernel<C, CRIT><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)matrix, n_words, n_cols, limit, (const uint32_t*)masks,
      (const int32_t*)n_node, (const float*)scale, n_nodes, nodes_per_block,
      nodes_pad, (const uint8_t*)excl, block_cols, (float*)out_score,
      (int32_t*)out_col);
  return (int)cudaGetLastError();
}

}  // namespace

// masks (n_nodes, n_classes, n_words) words; n_node (n_nodes, n_classes)
// int32; scale (n_nodes, n_classes) float32 = priors / totals; excl
// (n_cols,) bytes or null; criterion 0 = Gini, 1 = cross-entropy. Outputs
// (n_blocks, n_nodes) float32 / int32 with n_blocks = ceil(n_cols /
// block_cols); grid row y takes nodes [y * nodes_per_block, (y + 1) *
// nodes_per_block). n_classes is 2, 3, 4 or 8: a caller with a count in
// between appends empty classes (masks, n_node and scale all 0), which add
// +0 to every sum and so leave each score bit for bit as it was. n_blocks > 0
// and n_nodes > 0 are the caller's to check; an unsupported n_classes or
// criterion returns cudaErrorInvalidValue.
extern "C" int grm_cart_sweep(int criterion, const void* matrix, int n_words,
                              long long n_cols, long long limit,
                              const void* masks, const void* n_node,
                              const void* scale, int n_nodes, int n_classes,
                              int nodes_per_block, const void* excl,
                              int block_cols, void* out_score, void* out_col,
                              void* stream) {
#define GRM_ARGS                                                             \
  matrix, n_words, n_cols, limit, masks, n_node, scale, n_nodes,             \
      nodes_per_block, excl, block_cols, out_score, out_col, stream
#define GRM_CASE(C)                                                          \
  case C:                                                                    \
    return criterion == kGini ? launch<C, kGini>(GRM_ARGS)                   \
                              : launch<C, kCrossEntropy>(GRM_ARGS);
  if (criterion != kGini && criterion != kCrossEntropy)
    return (int)cudaErrorInvalidValue;
  switch (n_classes) {
    GRM_CASE(2)
    GRM_CASE(3)
    GRM_CASE(4)
    GRM_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GRM_CASE
#undef GRM_ARGS
}

extern "C" long long grm_cart_sweep_smem_bytes(int n_words,
                                               int nodes_per_block,
                                               int n_classes) {
  return (long long)smem_bytes(n_words, pad_nodes(nodes_per_block, n_classes),
                               n_classes);
}
