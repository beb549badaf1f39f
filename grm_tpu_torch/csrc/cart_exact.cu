// The exact CART engine's two sweeps for Hopper (sm_90a): per BFS frontier
// node, the tuple tables (cart_exact_tuples) and the compaction of the
// candidate and equivalent columns (cart_exact_select), each one pass over
// the packed genome x k-mer matrix.
//
// Replaces the XLA programs of grm_tpu/parallel/cart_exact.py that ran on
// the TPU:
//   cart_exact_tuples  <- _distinct_chunk (:165), _tuple_scatter_chunk
//                         (:124) and _winner_chunk (:293): one table pass
//                         with no budget, no escalation and no winner pass;
//   cart_exact_select  <- gather mode: _gather_pass's sweep 2 (:321) and
//                         _gather2_chunk (:437); equiv mode: _equiv_chunk
//                         (:469). No budgets, so no x8 re-runs.
//
// Per (node, column) both count, in one 1-bit tensor-core product
// (bmma_tile.cuh), the node's C class counts (the left child of the
// presence split) and the column's occurrence in the node's tree's training
// set (the occurrence tiebreak of the reference's experiment_cart.py:82-94):
// the mask rows of a node are its C class masks, then its train mask. The
// score is cart_score.cuh's, the one the frontier sweep (cart_sweep.cu, the
// engine's pass 1) computes, so a column's score is bit for bit the one
// whose minimum set the node's threshold.
//
//     left[c] = popcount(matrix[:, k] & class_mask[c]),  occ likewise
//     valid   = k < limit, k not excluded, neither child empty
//     key     = ((left[0] * r1 + left[1]) * r2 + left[2]) ...,  r_c = n_c + 1
//
// cart_exact_tuples: a valid column with score <= thresh[node] folds into
// the node's two tables (entry table_off[node] + key; the caller sizes a
// node's tables to its count lattice prod(n_c + 1) <= 65536):
//   occ_tab: atomicMax of ((occ + 1) << 32) | (0xFFFFFFFF - k): the largest
//            occurrence, then the lowest column at it; 0 = absent;
//   col_tab: atomicMin of k: the lowest column of the key (identity
//            tiebreak); INT_MAX = absent.
// Max and min do not depend on the order of the updates, so the tables are
// deterministic. Hot keys (a small node, where millions of columns fall on a
// few keys that all pass the filter) are aggregated first: the lanes of a
// warp that hit one table entry agree on it (__match_any_sync) and reduce
// their occurrences and columns, and one lane updates the entry, and only
// if a read through L2 shows that the update would change it (the tables
// only grow or only shrink, so a stale read never skips a needed update).
//
// cart_exact_select, gather mode: a valid column with score <= thresh[node]
// is written out with its C counts and its occurrence. Equiv mode: a valid
// column whose key is in the node's winning-key set (a bitmap of the node's
// count lattice, in shared memory) and whose occurrence is occmax[node]
// (any occurrence where occmax < 0) is written out. Both modes run twice:
// `write` 0 counts the hits per (column block, node) into counts; the caller
// turns them into output offsets (an exclusive scan over the blocks, node by
// node: node-major, ascending); `write` 1 writes. Inside a block the warps
// take tiles in column order round by round, and each round's hits are
// placed by a ballot within the warp and the warps' counts in shared memory,
// so every node's output is ascending and the same from run to run: no
// cursor atomic, no sort, no budget.
//
// What bounds it on the H100. One read of the matrix (W * K * 4 bytes) is
// the floor, as for the other sweeps; the counting is a few tensor-core
// products per 16 columns and 4 nodes. The score per (node, column) is
// computed directly (the 1 to 2C divisions and C logs of cart_score.cuh),
// so at frontiers of tens of nodes the special-function pipe bounds it, as
// it bounds cart_sweep's direct path. In the tuple pass, the hot-key case
// adds same-address atomics: at most one per warp, tile and (node, key),
// and only when the entry would change.
//
// The design, as cart_sweep.cu's: one warp owns a tile of 16 matrix
// columns (the product's 16 A rows, read straight from matrix[w, k]); the
// mask rows are the B operand, 4 nodes x 2 rows a tile, packed by the caller
// in fragment order (ops/tiles.py), held in shared memory; thread (g, t)
// then holds every count of node t of each group for columns g and g + 8.
// A pass keeps the accumulators of a few groups (4 / row pairs); the
// frontier's further groups re-read the block's columns from L1/L2; nodes
// past the shared-memory budget go to grid rows. One CUDA block owns one
// column block.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "bmma_tile.cuh"
#include "cart_score.cuh"

namespace {

using cart_score::kCrossEntropy;
using cart_score::kGini;
using cart_score::split_score;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupNodes = 4;  // nodes of one mask tile (4 x 2 mask rows)
constexpr int kWarpCols = bmma::kTileRows;    // matrix columns per warp tile
constexpr int kRoundCols = kWarps * kWarpCols;  // columns of one round
constexpr int kAccTiles = 4;  // (group, row pair) accumulator tiles a pass
constexpr int kBitmapWords = (1 << 16) / 32;  // a node's winning-key bitmap

enum Mode { kTuples = 0, kGather = 1, kEquiv = 2 };

// Mask rows per node: the C classes, then the train mask; in pairs.
__host__ __device__ constexpr int row_pairs(int n_classes) {
  return (n_classes + 2) / 2;
}

// Groups of 4 nodes whose accumulators a pass keeps.
__host__ __device__ constexpr int chunk_groups(int n_classes) {
  return row_pairs(n_classes) >= kAccTiles ? 1
                                           : kAccTiles / row_pairs(n_classes);
}

__host__ __device__ inline int depth_steps(int n_words) {
  return (n_words + bmma::kStepWords - 1) / bmma::kStepWords;
}

// Shared memory of a block that holds `groups` groups of 4 nodes, in bytes
// from the start: the mask tiles, n_node and scale per (node, class),
// thresh and one integer (table offset, or occmax) per node, the write
// pass's per-warp counts (two rounds' worth) and per-node bases, and in
// equiv mode the bitmaps of one pass's nodes.
struct Layout {
  size_t nn, scale, thresh, aux, cnt, base, bits, total;
};

__host__ __device__ inline Layout layout(int mode, int n_words, int groups,
                                         int n_classes) {
  const int nodes = groups * kGroupNodes;
  const int slots = chunk_groups(n_classes) * kGroupNodes;
  Layout l;
  size_t o = (size_t)groups * row_pairs(n_classes) * depth_steps(n_words) *
             bmma::kLanes * sizeof(uint32_t);
  l.nn = o;
  o += (size_t)nodes * n_classes * sizeof(int32_t);
  l.scale = o;
  o += (size_t)nodes * n_classes * sizeof(float);
  l.thresh = o;
  o += (size_t)nodes * sizeof(float);
  l.aux = o;
  o += (size_t)nodes * sizeof(int32_t);
  l.cnt = o;
  o += (size_t)2 * kWarps * slots * sizeof(int32_t);
  o = (o + 7) & ~(size_t)7;
  l.base = o;
  o += (size_t)slots * sizeof(long long);
  l.bits = o;
  if (mode == kEquiv) o += (size_t)slots * kBitmapWords * sizeof(uint32_t);
  l.total = o;
  return l;
}

struct Params {
  const uint32_t* matrix;
  int n_words;
  long long n_cols;
  long long limit;
  const uint32_t* tiles;
  const int32_t* n_node;
  const float* scale;
  const float* thresh;   // tuples, gather
  const int32_t* aux;    // tuples: table offsets; equiv: occmax
  const uint32_t* bitmap;  // equiv: (n_nodes, kBitmapWords)
  int n_nodes;
  int groups_per_block;
  const uint8_t* excl;
  int block_cols;
  int write;
  unsigned long long* occ_tab;  // tuples
  int32_t* col_tab;             // tuples
  long long* counts;            // select, write 0: (n_blocks, n_nodes)
  const long long* offsets;     // select, write 1: (n_blocks, n_nodes)
  int32_t* out_col;
  int32_t* out_left;  // gather: (C, total)
  int32_t* out_occ;   // gather
  long long total;
};

template <int C, int CRIT, int MODE>
__device__ __forceinline__ void exact_sweep(const Params& p) {
  constexpr int RP = row_pairs(C);
  constexpr int GC = chunk_groups(C);
  constexpr int kSlots = GC * kGroupNodes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout lay = layout(MODE, p.n_words, p.groups_per_block, C);
  const int n_steps = depth_steps(p.n_words);
  const int grp_lo = blockIdx.y * p.groups_per_block;
  const int n_lo = grp_lo * kGroupNodes;
  const int nc = min(p.groups_per_block * kGroupNodes, p.n_nodes - n_lo);
  const int ng = (nc + kGroupNodes - 1) / kGroupNodes;
  const int group_words = RP * n_steps * bmma::kLanes;

  uint32_t* s_tiles = reinterpret_cast<uint32_t*>(smem_raw);
  int32_t* s_nn = reinterpret_cast<int32_t*>(smem_raw + lay.nn);
  float* s_scale = reinterpret_cast<float*>(smem_raw + lay.scale);
  float* s_thresh = reinterpret_cast<float*>(smem_raw + lay.thresh);
  int32_t* s_aux = reinterpret_cast<int32_t*>(smem_raw + lay.aux);
  int32_t* s_cnt = reinterpret_cast<int32_t*>(smem_raw + lay.cnt);
  long long* s_base = reinterpret_cast<long long*>(smem_raw + lay.base);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem_raw + lay.bits);

  for (int i = threadIdx.x; i < ng * group_words; i += kThreads)
    s_tiles[i] = p.tiles[(size_t)grp_lo * group_words + i];
  for (int m = threadIdx.x; m < ng * kGroupNodes * C; m += kThreads) {
    const bool live = m < nc * C;
    s_nn[m] = live ? p.n_node[(size_t)n_lo * C + m] : 0;
    s_scale[m] = live ? p.scale[(size_t)n_lo * C + m] : 0.0f;
  }
  for (int m = threadIdx.x; m < ng * kGroupNodes; m += kThreads) {
    const bool live = m < nc;
    s_thresh[m] = live && MODE != kEquiv ? p.thresh[n_lo + m] : -INFINITY;
    s_aux[m] = live && p.aux != nullptr ? p.aux[n_lo + m] : 0;
  }
  __syncthreads();

  const long long col_lo = (long long)blockIdx.x * p.block_cols;
  const long long col_hi =
      min(col_lo + (long long)p.block_cols, min(p.limit, p.n_cols));
  const int n_rounds =
      col_hi > col_lo ? (int)((col_hi - col_lo + kRoundCols - 1) / kRoundCols)
                      : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = bmma::frag_index(lane);  // matrix columns g and g + 8
  const int t = bmma::frag_word(lane);   // word of a step; node of a group
  const unsigned lanes_t = 0x11111111u << t;  // the lanes holding node t
  const unsigned below = (1u << lane) - 1u;

  for (int g0 = 0; g0 < ng; g0 += GC) {
    if (MODE == kEquiv) {
      // The pass's winning-key bitmaps: the words of each node's lattice.
      for (int s = 0; s < kSlots; ++s) {
        const int node = g0 * kGroupNodes + s;
        if (node >= nc) break;
        int lattice = 1;
#pragma unroll
        for (int c = 0; c < C; ++c) lattice *= s_nn[node * C + c] + 1;
        const int words = min((lattice + 31) / 32, kBitmapWords);
        const uint32_t* src = p.bitmap + (size_t)(n_lo + node) * kBitmapWords;
        for (int i = threadIdx.x; i < words; i += kThreads)
          s_bits[s * kBitmapWords + i] = src[i];
      }
    }
    if (MODE != kTuples && threadIdx.x < kSlots) {
      const int node = g0 * kGroupNodes + threadIdx.x;
      s_base[threadIdx.x] =
          p.write && node < nc
              ? p.offsets[(size_t)blockIdx.x * p.n_nodes + n_lo + node]
              : 0;
      s_cnt[threadIdx.x] = 0;  // the count pass sums here
    }
    __syncthreads();
    const uint32_t* b_tiles = s_tiles + (size_t)g0 * group_words + lane;
    int my_hits[GC];
#pragma unroll
    for (int j = 0; j < GC; ++j) my_hits[j] = 0;

    for (int r = 0; r < n_rounds; ++r) {
      const long long k0 = col_lo + (long long)r * kRoundCols +
                           warp * kWarpCols + g;
      const long long k1 = k0 + bmma::kTileRows / 2;
      const bool v0 = k0 < col_hi && (p.excl == nullptr || p.excl[k0] == 0);
      const bool v1 = k1 < col_hi && (p.excl == nullptr || p.excl[k1] == 0);

      int acc[GC][RP][4];
#pragma unroll
      for (int j = 0; j < GC; ++j)
#pragma unroll
        for (int q = 0; q < RP; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][q][e] = 0;
      if (__any_sync(0xffffffffu, v0 || v1)) {
        // The counts: one AND + POPC tile product per group, row pair and
        // 128-bit step of depth.
        for (int step = 0; step < n_steps; ++step) {
          const int w = step * bmma::kStepWords + t;
          const uint32_t* src = p.matrix + (size_t)w * p.n_cols;
          const uint32_t a0 = v0 && w < p.n_words ? __ldg(src + k0) : 0u;
          const uint32_t a1 = v1 && w < p.n_words ? __ldg(src + k1) : 0u;
#pragma unroll
          for (int j = 0; j < GC; ++j) {
            if (g0 + j < ng) {
#pragma unroll
              for (int q = 0; q < RP; ++q)
                bmma::mma_and_popc_k128(
                    acc[j][q], a0, a1,
                    b_tiles[((size_t)(j * RP + q) * n_steps + step) *
                            bmma::kLanes]);
            }
          }
        }
      }

      // Each (group, half): this thread's node t, column k0 or k1.
      bool hit[GC][2];
      int occ_of[GC][2];
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        const int node = (g0 + j) * kGroupNodes + t;
        const bool live = node < nc;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int left[C];
#pragma unroll
          for (int c = 0; c < C; ++c)
            left[c] = acc[j][c / 2][2 * h + c % 2];
          const int occ = acc[j][C / 2][2 * h + C % 2];
          occ_of[j][h] = occ;
          bool ok = live && (h ? v1 : v0);
          int key = 0;
          if (ok) {
            if (MODE == kEquiv) {
              key = left[0];
#pragma unroll
              for (int c = 1; c < C; ++c)
                key = key * (s_nn[node * C + c] + 1) + left[c];
              const int slot = j * kGroupNodes + t;
              const int om = s_aux[node];
              ok = ((s_bits[slot * kBitmapWords + (key >> 5)] >> (key & 31)) &
                    1u) &&
                   (om < 0 || occ == om);
            } else {
              float pl[C];
              float pr[C];
              int left_n = 0;
              int right_n = 0;
#pragma unroll
              for (int c = 0; c < C; ++c) {
                const int right = s_nn[node * C + c] - left[c];
                const float sc = s_scale[node * C + c];
                left_n += left[c];
                right_n += right;
                pl[c] = __fmul_rn(sc, (float)left[c]);
                pr[c] = __fmul_rn(sc, (float)right);
              }
              ok = left_n > 0 && right_n > 0 &&
                   split_score<C, CRIT>(pl, pr) <= s_thresh[node];
              if (MODE == kTuples && ok) {
                key = left[0];
#pragma unroll
                for (int c = 1; c < C; ++c)
                  key = key * (s_nn[node * C + c] + 1) + left[c];
              }
            }
          }
          hit[j][h] = ok;
          if (MODE == kTuples) {
            // The lanes that hit one table entry, reduced to one update.
            const unsigned entry = ok ? (unsigned)(s_aux[node] + key)
                                      : 0xFFFFFFFFu;
            if (__any_sync(0xffffffffu, ok)) {
              const unsigned grp = __match_any_sync(0xffffffffu, entry);
              if (ok) {
                const unsigned col = (unsigned)(h ? k1 : k0);
                const unsigned om = __reduce_max_sync(grp, (unsigned)occ);
                const unsigned cm = __reduce_min_sync(
                    grp, (unsigned)occ == om ? col : 0xFFFFFFFFu);
                const unsigned ca = __reduce_min_sync(grp, col);
                if (lane == __ffs(grp) - 1) {
                  const unsigned long long v =
                      ((unsigned long long)(om + 1u) << 32) |
                      (0xFFFFFFFFu - cm);
                  unsigned long long* a = p.occ_tab + entry;
                  if (__ldcg(a) < v) atomicMax(a, v);
                  int32_t* b = p.col_tab + entry;
                  if (__ldcg(b) > (int32_t)ca) atomicMin(b, (int32_t)ca);
                }
              }
            }
          }
        }
      }
      if (MODE == kTuples) continue;

      if (!p.write) {
#pragma unroll
        for (int j = 0; j < GC; ++j) my_hits[j] += hit[j][0] + hit[j][1];
        continue;
      }
      // The write pass: this round's hits of each node in column order
      // (warp by warp; in a warp tile column g before g + 8 before the
      // next g), after the rounds before it.
      int32_t* cnt = s_cnt + (r & 1) * kWarps * kSlots;
      unsigned b0[GC];
      unsigned b1[GC];
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        b0[j] = __ballot_sync(0xffffffffu, hit[j][0]);
        b1[j] = __ballot_sync(0xffffffffu, hit[j][1]);
        if (g == 0)
          cnt[warp * kSlots + j * kGroupNodes + t] =
              __popc(b0[j] & lanes_t) + __popc(b1[j] & lanes_t);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        if (!(hit[j][0] || hit[j][1])) continue;
        const int slot = j * kGroupNodes + t;
        long long base = s_base[slot];
        for (int wp = 0; wp < warp; ++wp) base += cnt[wp * kSlots + slot];
        const int pre0 = __popc(b0[j] & lanes_t & below);
        const int pre1 =
            __popc(b0[j] & lanes_t) + __popc(b1[j] & lanes_t & below);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!hit[j][h]) continue;
          const long long pos = base + (h ? pre1 : pre0);
          p.out_col[pos] = (int32_t)(h ? k1 : k0);
          if (MODE == kGather) {
            p.out_occ[pos] = occ_of[j][h];
#pragma unroll
            for (int c = 0; c < C; ++c)
              p.out_left[(size_t)c * p.total + pos] =
                  acc[j][c / 2][2 * h + c % 2];
          }
        }
      }
      __syncthreads();
      if (threadIdx.x < kSlots) {
        long long sum = 0;
        for (int wp = 0; wp < kWarps; ++wp)
          sum += cnt[wp * kSlots + threadIdx.x];
        s_base[threadIdx.x] += sum;
      }
    }

    if (MODE != kTuples && !p.write) {
#pragma unroll
      for (int j = 0; j < GC; ++j)
        if (my_hits[j]) atomicAdd(s_cnt + j * kGroupNodes + t, my_hits[j]);
      __syncthreads();
      if (threadIdx.x < kSlots) {
        const int node = g0 * kGroupNodes + threadIdx.x;
        if (node < nc)
          p.counts[(size_t)blockIdx.x * p.n_nodes + n_lo + node] =
              s_cnt[threadIdx.x];
      }
    }
    __syncthreads();
  }
}

template <int C, int CRIT>
__global__ void __launch_bounds__(kThreads)
    cart_exact_tuples_kernel(const Params p) {
  exact_sweep<C, CRIT, kTuples>(p);
}

template <int C, int CRIT, int MODE>
__global__ void __launch_bounds__(kThreads)
    cart_exact_select_kernel(const Params p) {
  exact_sweep<C, CRIT, MODE>(p);
}

template <typename Kernel>
int launch(Kernel kernel, int mode, const Params& p, int n_classes,
           void* stream) {
  const size_t smem =
      layout(mode, p.n_words, p.groups_per_block, n_classes).total;
  const int n_blocks = (int)((p.n_cols + p.block_cols - 1) / p.block_cols);
  const int nodes_per_block = p.groups_per_block * kGroupNodes;
  const dim3 grid(n_blocks,
                  (p.n_nodes + nodes_per_block - 1) / nodes_per_block);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <int C>
int launch_mode(int mode, int criterion, const Params& p, void* stream) {
  if (mode == kTuples)
    return criterion == kGini
               ? launch(cart_exact_tuples_kernel<C, kGini>, mode, p, C, stream)
               : launch(cart_exact_tuples_kernel<C, kCrossEntropy>, mode, p, C,
                        stream);
  if (mode == kGather)
    return criterion == kGini
               ? launch(cart_exact_select_kernel<C, kGini, kGather>, mode, p, C,
                        stream)
               : launch(cart_exact_select_kernel<C, kCrossEntropy, kGather>,
                        mode, p, C, stream);
  return launch(cart_exact_select_kernel<C, kGini, kEquiv>, mode, p, C,
                stream);
}

int dispatch(int mode, int criterion, int n_classes, const Params& p,
             void* stream) {
  if (criterion != kGini && criterion != kCrossEntropy)
    return (int)cudaErrorInvalidValue;
  if (mode != kTuples && mode != kGather && mode != kEquiv)
    return (int)cudaErrorInvalidValue;
  switch (n_classes) {
    case 2:
      return launch_mode<2>(mode, criterion, p, stream);
    case 3:
      return launch_mode<3>(mode, criterion, p, stream);
    case 4:
      return launch_mode<4>(mode, criterion, p, stream);
    case 6:
      return launch_mode<6>(mode, criterion, p, stream);
    case 8:
      return launch_mode<8>(mode, criterion, p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared with both entries: matrix (n_words, n_cols) words; tiles (groups,
// pairs, steps, 32) words: the (n_nodes, n_classes + 1, n_words) mask rows
// (classes, then the train mask) in the fragment order of bmma_tile.cuh,
// groups = ceil(n_nodes / 4), pairs = ceil((n_classes + 1) / 2), steps =
// ceil(n_words / 4), 0 past the real nodes, rows and words; n_node
// (n_nodes, n_classes) int32; scale (n_nodes, n_classes) float32 = priors /
// totals; excl (n_cols,) bytes or null; columns at or past `limit` are
// padding; criterion 0 = Gini, 1 = cross-entropy. n_classes is 2, 3, 4, 6 or
// 8 (a caller with a count in between appends empty classes); grid row y
// takes the groups [y * groups_per_block, (y + 1) * groups_per_block). The
// caller checks n_nodes > 0 and n_cols > 0.
//
// The tuple tables: thresh (n_nodes,) float32; table_off (n_nodes,) int32
// entries; occ_tab (u64) zeroed and col_tab (int32) filled with INT_MAX by
// the caller, node n's entries from table_off[n] on, prod(n_c + 1) of them.
extern "C" int grm_cart_exact_tuples(
    int criterion, const void* matrix, int n_words, long long n_cols,
    long long limit, const void* tiles, const void* n_node, const void* scale,
    const void* thresh, const void* table_off, int n_nodes, int n_classes,
    int groups_per_block, const void* excl, int block_cols, void* occ_tab,
    void* col_tab, void* stream) {
  Params p = {};
  p.matrix = (const uint32_t*)matrix;
  p.n_words = n_words;
  p.n_cols = n_cols;
  p.limit = limit;
  p.tiles = (const uint32_t*)tiles;
  p.n_node = (const int32_t*)n_node;
  p.scale = (const float*)scale;
  p.thresh = (const float*)thresh;
  p.aux = (const int32_t*)table_off;
  p.n_nodes = n_nodes;
  p.groups_per_block = groups_per_block;
  p.excl = (const uint8_t*)excl;
  p.block_cols = block_cols;
  p.occ_tab = (unsigned long long*)occ_tab;
  p.col_tab = (int32_t*)col_tab;
  return dispatch(kTuples, criterion, n_classes, p, stream);
}

// The compaction: mode 1 = gather (thresh (n_nodes,) float32; outputs
// out_col, out_left (n_classes, total) and out_occ), mode 2 = equiv
// (occmax (n_nodes,) int32, -1 = any occurrence; bitmap (n_nodes, 2048)
// words, bit key % 32 of word key / 32 set for a winning key; output
// out_col). write 0 fills counts (n_blocks, n_nodes) int64 with the hits of
// each (column block, node); write 1 writes node n's hits of block b, in
// ascending column order, from offsets[b, n] on. n_blocks = ceil(n_cols /
// block_cols).
extern "C" int grm_cart_exact_select(
    int mode, int write, int criterion, const void* matrix, int n_words,
    long long n_cols, long long limit, const void* tiles, const void* n_node,
    const void* scale, const void* thresh, const void* occmax,
    const void* bitmap, int n_nodes, int n_classes, int groups_per_block,
    const void* excl, int block_cols, void* counts, const void* offsets,
    void* out_col, void* out_left, void* out_occ, long long total,
    void* stream) {
  if (mode != kGather && mode != kEquiv) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.matrix = (const uint32_t*)matrix;
  p.n_words = n_words;
  p.n_cols = n_cols;
  p.limit = limit;
  p.tiles = (const uint32_t*)tiles;
  p.n_node = (const int32_t*)n_node;
  p.scale = (const float*)scale;
  p.thresh = (const float*)thresh;
  p.aux = (const int32_t*)occmax;
  p.bitmap = (const uint32_t*)bitmap;
  p.n_nodes = n_nodes;
  p.groups_per_block = groups_per_block;
  p.excl = (const uint8_t*)excl;
  p.block_cols = block_cols;
  p.write = write;
  p.counts = (long long*)counts;
  p.offsets = (const long long*)offsets;
  p.out_col = (int32_t*)out_col;
  p.out_left = (int32_t*)out_left;
  p.out_occ = (int32_t*)out_occ;
  p.total = total;
  return dispatch(mode, criterion, n_classes, p, stream);
}

// Shared-memory bytes of one block (mode 0 tuples, 1 gather, 2 equiv).
extern "C" long long grm_cart_exact_smem_bytes(int mode, int n_words,
                                               int groups_per_block,
                                               int n_classes) {
  return (long long)layout(mode, n_words, groups_per_block, n_classes).total;
}
