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
// single-precision log (never __logf, never -use_fast_math). The score
// functions live in cart_score.cuh, shared with the exact engine's kernels
// (cart_exact.cu), so that a column scores the same bits in every pass.
//
// What bounds it on the H100: the counting is a 1-bit matrix product, left =
// masks AND-POPC matrix, and runs on the tensor cores (bmma_tile.cuh), where
// it costs a few instructions per 16 columns and 4 nodes: the popc pipe no
// longer bounds the kernel. What is left is the score per (node, column): 2
// divisions (Gini) or 2C divisions and 2C logs (cross-entropy), some 110 and
// 310 instructions, which then take nine tenths of the time. For two classes
// they are not computed per column at all: a node with (n0, n1) examples has
// only (n0 + 1)(n1 + 1) distinct splits, so a small kernel first fills one
// score table per node (cart_sweep_table_kernel, by child_score itself, so
// the bits are the sweep's own), and the sweep reads one entry per (node,
// column). That path is bound by the latency of its loads (the matrix from
// device memory, the tables from L1/L2), not by arithmetic; the one read of
// the matrix is its floor.
//
// The design. One warp owns a tile of 16 matrix columns: they are the 16
// rows of the tile product's A operand, read straight from matrix[w, k] as
// fragments (lane g * 4 + t reads word 4 * step + t of columns g and g + 8:
// four full 32-byte sectors a load). The masks are the B operand, 8 to a
// tile: 4 nodes x 1 class pair, mask 2j and 2j + 1 being the two classes of
// the tile's node j; further class pairs are further tiles over the same
// nodes. The caller packs them in fragment order (tiles[group][pair][step]
// [lane], zero past the real depth, classes and nodes), and the block keeps
// them in shared memory. After the steps, thread (g, t) holds every class
// count of node t of each group for columns g and g + 8 and scores them with
// no shuffle. A pass keeps the counts of 5 groups with tables and of 4 /
// pairs groups without; a frontier of up to that many groups reads the
// matrix once, a larger one again per pass (from L1/L2), and nodes beyond
// the shared-memory budget go to grid rows. Nodes
// are padded to groups of 4; a thread does no work for a padded node, a
// banned column or a column past the limit, and a tile whose 16 columns are
// all banned is not loaded at all.
//
// The tables are the caller's buffer: entry table_off[n] + a * (n1 + 1) + b
// scores the split of node n that sends (a, b) examples left, +inf where a
// child is empty. The caller gives them only for two classes and only where
// the whole frontier's tables fit its budget; without them (table == null)
// every score is computed directly.
//
// Ties: a thread meets its columns in ascending order and replaces its best
// only on a strictly lower score; the reductions across lanes and warps
// compare (score, column) lexicographically.
//
// Plain C interface for ctypes; returns cudaGetLastError().

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "bmma_tile.cuh"
#include "cart_score.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupNodes = 4;  // nodes of one mask tile (8 masks = 4 pairs)
constexpr int kWarpCols = bmma::kTileRows;  // matrix columns per warp tile
constexpr int kRegSteps = 4;    // depth steps whose A fragments load at once
constexpr int kMaxChunk = 8;    // most groups a pass keeps in registers
// Both ways of scoring wait more than they compute (look-ups on gathers
// from L1/L2, direct scores on chains of divisions and logs), so both want
// warps more than registers: of the pairs tried on the H100, 5 groups a pass
// (a frontier of 20 nodes in one) and 4 blocks an SM (64 registers) were the
// fastest with tables, 4 groups (over the class pairs) and 4 blocks without.
constexpr int kTableChunk = 5;
constexpr int kTableBlocks = 4;
constexpr int kDirectChunk = 4;
constexpr int kDirectBlocks = 4;
static_assert(kDirectChunk >= 1 && kDirectChunk <= kMaxChunk, "direct chunk");
static_assert(kTableChunk >= 1 && kTableChunk <= kMaxChunk, "table chunk");

using cart_score::kCrossEntropy;
using cart_score::kGini;
using cart_score::split_score;

__host__ __device__ constexpr int class_pairs(int n_classes) {
  return (n_classes + 1) / 2;
}

// Groups whose counts a pass of direct scores keeps in registers: the chunk
// shared out over the class pairs (16 accumulators a thread by default).
__host__ __device__ constexpr int chunk_groups(int n_classes) {
  return class_pairs(n_classes) >= kDirectChunk
             ? 1
             : kDirectChunk / class_pairs(n_classes);
}

__host__ __device__ inline int depth_steps(int n_words) {
  return (n_words + bmma::kStepWords - 1) / bmma::kStepWords;
}

// Shared memory: the mask tiles of the block's groups, then n_node (int) and
// scale (float) per (node, class), then the reduction scratch.
__host__ __device__ inline size_t smem_bytes(int n_words, int groups,
                                             int n_classes) {
  return (size_t)groups * class_pairs(n_classes) * depth_steps(n_words) *
             bmma::kLanes * sizeof(uint32_t) +
         (size_t)2 * groups * kGroupNodes * n_classes * sizeof(float) +
         (size_t)2 * kWarps * kMaxChunk * kGroupNodes * sizeof(float);
}

// (least score, lowest column): exact, so the order of the steps of a
// reduction does not matter.
__device__ __forceinline__ void take_better(float& s, int32_t& c, float os,
                                            int32_t oc) {
  if (os < s || (os == s && oc < c)) {
    s = os;
    c = oc;
  }
}

// The first kRegSteps depth steps of one warp tile as this lane's A
// fragments, and whether its two columns are scored at all.
struct TileFrag {
  uint32_t a0[kRegSteps];
  uint32_t a1[kRegSteps];
  bool v0;
  bool v1;
};

// What the sweep needs of one node when it scores by look-up.
struct __align__(16) TableNode {
  int32_t n1p;   // examples of the second class + 1: the table's row length
  int32_t last;  // the table's last entry
  int32_t off;   // the table's first entry in the launch's table buffer
  int32_t pad;
};

// Score table of one node with (n0, n1) examples (two classes): entry
// a * (n1 + 1) + b is the score of the split that sends (a, b) of them left,
// child(left) + child(right) by child_score itself in the sweep's own order,
// so a look-up gives the bits the sweep would compute; +inf for the two
// splits with an empty child (the first and the last entry).
template <int CRIT>
__global__ void __launch_bounds__(kThreads) cart_sweep_table_kernel(
    const int32_t* __restrict__ n_node, const float* __restrict__ scale,
    const int32_t* __restrict__ table_off, int table_cap,
    float* __restrict__ table) {
  const int node = blockIdx.y;
  const int n0 = n_node[2 * node];
  const int n1 = n_node[2 * node + 1];
  const int n1p = n1 + 1;
  const int size = min((n0 + 1) * n1p, table_cap);
  const float s0 = scale[2 * node];
  const float s1 = scale[2 * node + 1];
  float* out = table + table_off[node];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < size;
       i += gridDim.x * kThreads) {
    const int a = i / n1p;
    const int b = i % n1p;
    const float pl[2] = {__fmul_rn(s0, (float)a), __fmul_rn(s1, (float)b)};
    const float pr[2] = {__fmul_rn(s0, (float)(n0 - a)),
                         __fmul_rn(s1, (float)(n1 - b))};
    out[i] = i == 0 || i == size - 1
                 ? INFINITY
                 : split_score<2, CRIT>(pl, pr);
  }
}

template <int C, int CRIT, bool TABLE>
__global__ void __launch_bounds__(kThreads,
                                  TABLE ? kTableBlocks : kDirectBlocks)
cart_sweep_kernel(
    const uint32_t* __restrict__ matrix, int n_words, long long n_cols,
    long long limit, const uint32_t* __restrict__ tiles,
    const int32_t* __restrict__ n_node, const float* __restrict__ scale,
    int n_nodes, int groups_per_block, const uint8_t* __restrict__ excl,
    int block_cols, const float* __restrict__ table,
    const int32_t* __restrict__ table_off, int table_cap,
    float* __restrict__ out_score, int32_t* __restrict__ out_col) {
  static_assert(!TABLE || C == 2, "score tables are for two classes");
  constexpr int CP = class_pairs(C);
  constexpr int GC = TABLE ? kTableChunk : chunk_groups(C);
  constexpr int kSlots = kMaxChunk * kGroupNodes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_steps = depth_steps(n_words);
  const int grp_lo = blockIdx.y * groups_per_block;
  const int n_lo = grp_lo * kGroupNodes;
  const int nc = min(groups_per_block * kGroupNodes, n_nodes - n_lo);
  const int ng = (nc + kGroupNodes - 1) / kGroupNodes;
  const int group_words = CP * n_steps * bmma::kLanes;

  uint32_t* s_tiles = reinterpret_cast<uint32_t*>(smem_raw);
  int32_t* s_nn = reinterpret_cast<int32_t*>(
      s_tiles + (size_t)groups_per_block * group_words);
  float* s_scale =
      reinterpret_cast<float*>(s_nn + groups_per_block * kGroupNodes * C);
  // With tables, a TableNode per node takes the counts' and scales' place
  // (both are 16 bytes a node for two classes).
  TableNode* s_tnode = reinterpret_cast<TableNode*>(s_nn);
  float* s_red_s = s_scale + groups_per_block * kGroupNodes * C;
  int32_t* s_red_c = reinterpret_cast<int32_t*>(s_red_s + kWarps * kSlots);

  for (int i = threadIdx.x; i < ng * group_words; i += kThreads)
    s_tiles[i] = tiles[(size_t)grp_lo * group_words + i];
  if (!TABLE) {
    for (int m = threadIdx.x; m < ng * kGroupNodes * C; m += kThreads) {
      const bool live = m < nc * C;
      s_nn[m] = live ? n_node[(size_t)n_lo * C + m] : 0;
      s_scale[m] = live ? scale[(size_t)n_lo * C + m] : 0.0f;
    }
  } else {
    for (int m = threadIdx.x; m < nc; m += kThreads) {
      const int n1p = n_node[(size_t)(n_lo + m) * C + 1] + 1;
      const int size =
          min((n_node[(size_t)(n_lo + m) * C] + 1) * n1p, table_cap);
      s_tnode[m] = TableNode{n1p, size - 1, table_off[n_lo + m], 0};
    }
  }
  __syncthreads();

  const long long col_lo = (long long)blockIdx.x * block_cols;
  const long long col_hi =
      min(col_lo + (long long)block_cols, min(limit, n_cols));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = bmma::frag_index(lane);  // matrix columns g and g + 8
  const int t = bmma::frag_word(lane);   // word of a step; node of a group

  const uint32_t* row_t = matrix + (size_t)t * n_cols;  // word t, step 0
  const size_t step_stride = (size_t)bmma::kStepWords * n_cols;

  for (int g0 = 0; g0 < ng; g0 += GC) {
    float best_s[GC];
    int32_t best_c[GC];
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      best_s[j] = INFINITY;
      best_c[j] = INT_MAX;
    }
    const uint32_t* b_tiles = s_tiles + (size_t)g0 * group_words + lane;

    // With look-up scores a tile's fragments are loaded one tile ahead, so
    // that the loads are in flight while the tile before it is counted and
    // scored. The direct scores are long enough to hide the other warps'
    // loads, and gained nothing from loading ahead.
    auto load_tile = [&](long long c0, TileFrag& f) {
      const long long k0 = c0 + g;
      const long long k1 = k0 + bmma::kTileRows / 2;
      f.v0 = k0 < col_hi && (excl == nullptr || excl[k0] == 0);
      f.v1 = k1 < col_hi && (excl == nullptr || excl[k1] == 0);
      const uint32_t* src = row_t + k0;
#pragma unroll
      for (int i = 0; i < kRegSteps; ++i) {
        const bool deep = i * bmma::kStepWords + t < n_words;
        f.a0[i] = f.v0 && deep ? __ldg(src + i * step_stride) : 0u;
        f.a1[i] = f.v1 && deep
                      ? __ldg(src + i * step_stride + bmma::kTileRows / 2)
                      : 0u;
      }
    };
    auto count_step = [&](int (&acc)[GC][CP][4], int step, uint32_t a0,
                          uint32_t a1) {
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        if (g0 + j < ng) {
#pragma unroll
          for (int q = 0; q < CP; ++q)
            bmma::mma_and_popc_k128(
                acc[j][q], a0, a1,
                b_tiles[((size_t)(j * CP + q) * n_steps + step) *
                        bmma::kLanes]);
        }
      }
    };

    TileFrag next;
    if (TABLE) load_tile(col_lo + warp * kWarpCols, next);
    for (long long c0 = col_lo + warp * kWarpCols; c0 < col_hi;
         c0 += kWarps * kWarpCols) {
      TileFrag cur;
      if (TABLE) {
        cur = next;
        load_tile(c0 + kWarps * kWarpCols, next);
      } else {
        load_tile(c0, cur);
      }
      const long long k0 = c0 + g;
      const long long k1 = k0 + bmma::kTileRows / 2;
      const bool v0 = cur.v0;
      const bool v1 = cur.v1;
      if (!__any_sync(0xffffffffu, v0 || v1)) continue;

      int acc[GC][CP][4];
#pragma unroll
      for (int j = 0; j < GC; ++j)
#pragma unroll
        for (int q = 0; q < CP; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][q][e] = 0;

      // The counts: one AND + POPC tile product per group, pair and step.
      // (The product needs the whole warp; the scores below diverge.)
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kRegSteps; ++i)
        if (i < n_steps) count_step(acc, i, cur.a0[i], cur.a1[i]);
      // Deeper matrices (more than 512 genomes): the further steps' words
      // are loaded here, not ahead.
      for (int step = kRegSteps; step < n_steps; ++step) {
        const int w = step * bmma::kStepWords + t;
        const uint32_t* src = matrix + (size_t)w * n_cols;
        count_step(acc, step, v0 && w < n_words ? __ldg(src + k0) : 0u,
                   v1 && w < n_words ? __ldg(src + k1) : 0u);
      }

      // The scores: this thread holds node t of each group, columns k0, k1.
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        const int node = (g0 + j) * kGroupNodes + t;
        if (node >= nc) continue;
        if (TABLE) {
          // The split's score by look-up, at the left child's two counts.
          const TableNode tn = s_tnode[node];
          const float* tb = table + tn.off;
          if (v0) {
            const int at = acc[j][0][0] * tn.n1p + acc[j][0][1];
            const float score = __ldg(tb + min(max(at, 0), tn.last));
            if (score < best_s[j]) {
              best_s[j] = score;
              best_c[j] = (int32_t)k0;
            }
          }
          if (v1) {
            const int at = acc[j][0][2] * tn.n1p + acc[j][0][3];
            const float score = __ldg(tb + min(max(at, 0), tn.last));
            if (score < best_s[j]) {
              best_s[j] = score;
              best_c[j] = (int32_t)k1;
            }
          }
          continue;
        }
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
          if (!(h ? v1 : v0)) continue;
          float pl[C];
          float pr[C];
          int left_n = 0;
          int right_n = 0;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int left =
                h ? acc[j][c / 2][2 + c % 2] : acc[j][c / 2][c % 2];
            const int right = s_nn[node * C + c] - left;
            const float sc = s_scale[node * C + c];
            left_n += left;
            right_n += right;
            pl[c] = __fmul_rn(sc, (float)left);
            pr[c] = __fmul_rn(sc, (float)right);
          }
          if (left_n == 0 || right_n == 0) continue;
          const float score = split_score<C, CRIT>(pl, pr);
          if (score < best_s[j]) {
            best_s[j] = score;
            best_c[j] = (int32_t)(h ? k1 : k0);
          }
        }
      }
    }

    // Lanes with the same t hold the same nodes: reduce over g, then over
    // the warps.
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      float s = best_s[j];
      int32_t c = best_c[j];
#pragma unroll
      for (int off = 16; off >= 4; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, s, off);
        const int32_t oc = __shfl_xor_sync(0xffffffffu, c, off);
        take_better(s, c, os, oc);
      }
      if (g == 0) {
        s_red_s[warp * kSlots + j * kGroupNodes + t] = s;
        s_red_c[warp * kSlots + j * kGroupNodes + t] = c;
      }
    }
    __syncthreads();
    const int slot = threadIdx.x;
    if (slot < GC * kGroupNodes && g0 * kGroupNodes + slot < nc) {
      float s = s_red_s[slot];
      int32_t c = s_red_c[slot];
      for (int wp = 1; wp < kWarps; ++wp)
        take_better(s, c, s_red_s[wp * kSlots + slot],
                    s_red_c[wp * kSlots + slot]);
      const size_t o =
          (size_t)blockIdx.x * n_nodes + n_lo + g0 * kGroupNodes + slot;
      out_score[o] = s;
      out_col[o] = c;
    }
    __syncthreads();
  }
}

template <int C, int CRIT, bool TABLE>
int launch(const void* matrix, int n_words, long long n_cols, long long limit,
           const void* tiles, const void* n_node, const void* scale,
           int n_nodes, int groups_per_block, const void* excl, int block_cols,
           void* table, const void* table_off, int table_cap, void* out_score,
           void* out_col, void* stream) {
  const size_t smem = smem_bytes(n_words, groups_per_block, C);
  const int n_blocks = (int)((n_cols + block_cols - 1) / block_cols);
  const int nodes_per_block = groups_per_block * kGroupNodes;
  const dim3 grid(n_blocks, (n_nodes + nodes_per_block - 1) / nodes_per_block);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cart_sweep_kernel<C, CRIT, TABLE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (TABLE) {
    const dim3 table_grid((table_cap + kThreads - 1) / kThreads < 32
                              ? (table_cap + kThreads - 1) / kThreads
                              : 32,
                          n_nodes);
    cart_sweep_table_kernel<CRIT>
        <<<table_grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)n_node, (const float*)scale,
            (const int32_t*)table_off, table_cap, (float*)table);
  }
  cart_sweep_kernel<C, CRIT, TABLE>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const uint32_t*)matrix, n_words, n_cols, limit,
          (const uint32_t*)tiles, (const int32_t*)n_node, (const float*)scale,
          n_nodes, groups_per_block, (const uint8_t*)excl, block_cols,
          (const float*)table, (const int32_t*)table_off, table_cap,
          (float*)out_score, (int32_t*)out_col);
  return (int)cudaGetLastError();
}

}  // namespace

// tiles (groups, pairs, steps, 32) words: the class masks in the fragment
// order of bmma_tile.cuh, groups = ceil(n_nodes / 4), pairs = ceil(n_classes
// / 2), steps = ceil(n_words / 4); word [grp][q][s][4 * (2 * j + e) + t] is
// word 4 * s + t of the mask of node 4 * grp + j, class 2 * q + e, and 0 past
// the real nodes, classes and words. n_node (n_nodes, n_classes) int32;
// scale (n_nodes, n_classes) float32 = priors / totals; excl (n_cols,) bytes
// or null; criterion 0 = Gini, 1 = cross-entropy. Outputs (n_blocks,
// n_nodes) float32 / int32 with n_blocks = ceil(n_cols / block_cols); grid
// row y takes groups [y * groups_per_block, (y + 1) * groups_per_block).
// n_classes is 2, 3, 4, 6 or 8: a caller with a count in between appends
// empty classes (masks, n_node and scale all 0), which add +0 to every sum
// and so leave each score bit for bit as it was. table (floats) and
// table_off (n_nodes int32) are null, or (two classes only) a buffer for
// the score tables and each node's first entry in it, node n taking min((n0
// + 1)(n1 + 1), table_cap) entries; the tables are filled here, before the
// sweep, on the same stream. n_blocks > 0 and n_nodes > 0 are the caller's to
// check; an unsupported n_classes or criterion returns cudaErrorInvalidValue.
extern "C" int grm_cart_sweep(int criterion, const void* matrix, int n_words,
                              long long n_cols, long long limit,
                              const void* tiles, const void* n_node,
                              const void* scale, int n_nodes, int n_classes,
                              int groups_per_block, const void* excl,
                              int block_cols, void* table,
                              const void* table_off, int table_cap,
                              void* out_score, void* out_col, void* stream) {
#define GRM_ARGS                                                             \
  matrix, n_words, n_cols, limit, tiles, n_node, scale, n_nodes,             \
      groups_per_block, excl, block_cols, table, table_off, table_cap,       \
      out_score, out_col, stream
#define GRM_CASE(C)                                                          \
  case C:                                                                    \
    return criterion == kGini ? launch<C, kGini, false>(GRM_ARGS)            \
                              : launch<C, kCrossEntropy, false>(GRM_ARGS);
  if (criterion != kGini && criterion != kCrossEntropy)
    return (int)cudaErrorInvalidValue;
  if (table != nullptr) {
    if (n_classes != 2 || table_off == nullptr || table_cap < 1)
      return (int)cudaErrorInvalidValue;
    return criterion == kGini ? launch<2, kGini, true>(GRM_ARGS)
                              : launch<2, kCrossEntropy, true>(GRM_ARGS);
  }
  switch (n_classes) {
    GRM_CASE(2)
    GRM_CASE(3)
    GRM_CASE(4)
    GRM_CASE(6)
    GRM_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GRM_CASE
#undef GRM_ARGS
}

extern "C" long long grm_cart_sweep_smem_bytes(int n_words,
                                               int groups_per_block,
                                               int n_classes) {
  return (long long)smem_bytes(n_words, groups_per_block, n_classes);
}
