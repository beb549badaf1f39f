// The exact CART engine's kernels for Hopper (sm_90a): per BFS frontier
// node, the tuple tables (cart_exact_tuples) and the compaction of the
// candidate and equivalent columns (cart_exact_select), each one read of the
// packed genome x k-mer matrix.
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
// Per (node, column) the sweep counts, in one 1-bit tensor-core product
// (bmma_tile.cuh), the node's C class counts (the left child of the
// presence split) and the column's occurrence in the node's tree's training
// set (the occurrence tiebreak of the reference's experiment_cart.py:82-94):
// the mask rows of a node are its C class masks, then its train mask.
//
//     left[c] = popcount(matrix[:, k] & class_mask[c]),  occ likewise
//     valid   = k < limit, k not excluded
//     key     = ((left[0] * r1 + left[1]) * r2 + left[2]) ...,  r_c = n_c + 1
//
// Four kernels:
//
// cart_exact_bitmap_kernel, the pass bitmaps. A split's float32 score is a
// function of its key alone (the left counts; n_node and scale are the
// node's), and a tuple-regime node has at most 65,536 keys. So one thread
// per key of every node's lattice decodes the key, scores it with
// cart_score.cuh's function on the same __fmul_rn products as the frontier
// sweep (cart_sweep.cu, the engine's pass 1), and sets bit key % 32 of word
// key / 32 of the node's bitmap where neither child is empty and the score
// is at most thresh[node]. Every bit is the decision a direct score per
// column would take, at the cost of the distinct splits instead of one
// score per (node, column).
//
// cart_exact_tuples_kernel: a valid column whose key's bit is set folds into
// the node's two tables (entry table_off[node] + key):
//   occ_tab: atomicMax of ((occ + 1) << 32) | (0xFFFFFFFF - k): the largest
//            occurrence, then the lowest column at it; 0 = absent;
//   col_tab: atomicMin of k: the lowest column of the key (identity
//            tiebreak); INT_MAX = absent.
// Max and min do not depend on the order of the updates, so the tables are
// deterministic. The lanes of a warp that hit one entry agree on it
// (__match_any_sync) and reduce their occurrences and columns, and one lane
// updates. A node with a small lattice (the hot-key case: millions of
// columns on a few keys) folds into a private copy of its tables in the
// block's shared memory, merged into the global tables once per block with
// the same max and min; the other nodes update the global tables, and only
// where a read through L2 shows the update would change them (the tables
// only grow or only shrink, so a stale read never skips a needed update).
//
// cart_exact_select_kernel, the counting launch of the compaction. Gather
// mode: a valid column with both children non-empty and score <= thresh
// [node] is a hit (scored directly: a gather-regime lattice is past the
// bitmaps' 65,536 keys). Equiv mode: a valid column whose key is in the
// node's winning-key bitmap and whose occurrence is occmax[node] (any where
// occmax < 0) is a hit. The block gathers its hits as bits in shared memory
// (one 16-bit half a warp tile and node, from two ballots) and writes, per
// (column block, node), the number of hits and, where there are any, its
// 128 hit words. The caller turns the counts into output offsets (an
// exclusive scan over the blocks, node by node: node-major, ascending).
//
// cart_exact_write_kernel, the writing launch: one block per (column block,
// node) with hits reads the block's 128 hit words, not the matrix, takes a
// prefix of their popcounts (one scan within the warps, one barrier), and
// places every set bit at its offset plus the __popc of the bits below it.
// Output is ascending and the same from run to run: no atomics on
// positions, no sort, no budget. In gather mode each hit column's class
// counts and occurrence are counted again with __popc over its W words and
// the node's masks: the writing launch reads only the hit columns.
//
// The sweep's design, as cart_sweep.cu's: one warp owns a tile of 16 matrix
// columns (the product's 16 A rows, read from matrix[w, k]); the mask rows
// are the B operand, 4 nodes x 2 rows a tile, packed by the caller in
// fragment order (ops/tiles.py), held in shared memory; thread (g, t) then
// holds every count of node t of a group for columns g and g + 8. The A
// fragments of a tile are read once, into registers where the depth is at
// most kRegSteps 128-bit steps (512 genomes; the published median, 342
// genomes, takes 3 steps, 6 registers a lane), else into the warp's slab of
// shared memory by cp.async (5022 genomes: 40 steps), and every group of
// the grid row's nodes is counted from them, two 128-bit steps a k256
// product: each launch reads a column once for all the nodes a grid row
// holds. Nodes past the shared-memory
// budget go to further grid rows. The bitmaps of a grid row's nodes are
// held in shared memory where they fit and read through L1 where they do
// not. One CUDA block owns one block of kBlockCols columns.
//
// What bounds them on the H100. One read of the matrix (W * K * 4 bytes) is
// the floor, as for the other sweeps; the counting is a few tensor-core
// products per 16 columns and 4 nodes. What is left per (node, column) in
// tuples and equiv mode is the key (C - 1 multiply-adds), one bit test and
// the ballots, so the loads and the issue of those few instructions bound
// the sweep; gather mode still scores every (node, column) directly on the
// special-function pipe. The writing launch moves the hit words and the
// output; the hot-key folds cost shared-memory atomics.
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
constexpr int kWarpCols = bmma::kTileRows;      // matrix columns per warp tile
constexpr int kBlockCols = 4096;                // matrix columns per block
constexpr int kBlockWords = kBlockCols / 32;    // hit words per (block, node)
constexpr int kRegSteps = 4;  // deepest A fragments held in registers
constexpr int kFillWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kTuples = 0, kGather = 1, kEquiv = 2 };

// Mask rows per node: the C classes, then the train mask; in pairs.
__host__ __device__ constexpr int row_pairs(int n_classes) {
  return (n_classes + 2) / 2;
}

__host__ __device__ inline int depth_steps(int n_words) {
  return (n_words + bmma::kStepWords - 1) / bmma::kStepWords;
}

// Shared memory of a block that holds `groups` groups of 4 nodes, in bytes
// from the start: the mask tiles; n_node and scale per (node, class);
// thresh, one integer (table offset, or occmax), the bitmap offset and the
// private-table offset per node; the grid row's bitmaps (bit_words words,
// 0 where they are read from global memory); the private tables
// (priv_entries of u64 and int32); the select modes' hit words (kBlockWords
// per node); and, past kRegSteps steps of depth, each warp's slab of A
// fragments (two words per lane and step).
struct Layout {
  size_t nn, scale, thresh, aux, boff, poff, bits, priv_occ, priv_col, hits,
      stage, total;
};

__host__ __device__ inline Layout layout(int mode, int n_words, int groups,
                                         int n_classes, int bit_words,
                                         int priv_entries) {
  const int nodes = groups * kGroupNodes;
  const int steps = depth_steps(n_words);
  Layout l;
  size_t o = (size_t)groups * row_pairs(n_classes) * steps * bmma::kLanes *
             sizeof(uint32_t);
  l.nn = o;
  o += (size_t)nodes * n_classes * sizeof(int32_t);
  l.scale = o;
  o += (size_t)nodes * n_classes * sizeof(float);
  l.thresh = o;
  o += (size_t)nodes * sizeof(float);
  l.aux = o;
  o += (size_t)nodes * sizeof(int32_t);
  l.boff = o;
  o += (size_t)nodes * sizeof(int32_t);
  l.poff = o;
  o += (size_t)nodes * sizeof(int32_t);
  l.bits = o;
  o += (size_t)bit_words * sizeof(uint32_t);
  o = (o + 7) & ~(size_t)7;
  l.priv_occ = o;
  o += (size_t)priv_entries * sizeof(unsigned long long);
  l.priv_col = o;
  o += (size_t)priv_entries * sizeof(int32_t);
  l.hits = o;
  if (mode != kTuples) o += (size_t)nodes * kBlockWords * sizeof(uint32_t);
  o = (o + 15) & ~(size_t)15;
  l.stage = o;
  if (steps > kRegSteps)
    o += (size_t)kWarps * steps * bmma::kLanes * 2 * sizeof(uint32_t);
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
  const float* thresh;     // gather
  const int32_t* aux;      // tuples: table offsets; equiv: occmax
  const uint32_t* bits;    // tuples: pass bitmaps; equiv: winning keys
  const int32_t* bit_off;  // (n_nodes + 1,) word offsets into bits
  int bit_words;           // a grid row's bitmap words in shared memory
  const int32_t* priv_off;  // tuples: private-table offset in the row, -1
  int priv_entries;
  int n_nodes;
  int groups_per_block;
  const uint8_t* excl;
  unsigned long long* occ_tab;  // tuples
  int32_t* col_tab;             // tuples
  long long* counts;            // select: (n_nodes, n_blocks)
  uint32_t* hits;               // select: (n_nodes, n_blocks, kBlockWords)
};

// Bits 0, 4, ..., 28 of x gathered into bits 0 to 7: one node's lanes of a
// ballot (lane 4g + t holds node t's column g).
__device__ __forceinline__ uint32_t every_fourth_bit(uint32_t x) {
  x &= 0x11111111u;
  x = (x | (x >> 3)) & 0x03030303u;
  x = (x | (x >> 6)) & 0x000F000Fu;
  return (x | (x >> 12)) & 0xFFu;
}

// Four bytes from global to shared memory, zero-filled where !valid.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int C, int CRIT, int MODE>
__device__ __forceinline__ void exact_sweep(const Params& p) {
  constexpr int RP = row_pairs(C);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout lay = layout(MODE, p.n_words, p.groups_per_block, C,
                            p.bit_words, p.priv_entries);
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
  int32_t* s_boff = reinterpret_cast<int32_t*>(smem_raw + lay.boff);
  int32_t* s_poff = reinterpret_cast<int32_t*>(smem_raw + lay.poff);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem_raw + lay.bits);
  unsigned long long* s_pocc =
      reinterpret_cast<unsigned long long*>(smem_raw + lay.priv_occ);
  int32_t* s_pcol = reinterpret_cast<int32_t*>(smem_raw + lay.priv_col);
  uint32_t* s_hits = reinterpret_cast<uint32_t*>(smem_raw + lay.hits);
  uint16_t* s_hits16 = reinterpret_cast<uint16_t*>(smem_raw + lay.hits);

  for (int i = threadIdx.x; i < ng * group_words; i += kThreads)
    s_tiles[i] = p.tiles[(size_t)grp_lo * group_words + i];
  for (int m = threadIdx.x; m < ng * kGroupNodes * C; m += kThreads) {
    const bool live = m < nc * C;
    s_nn[m] = live ? p.n_node[(size_t)n_lo * C + m] : 0;
    s_scale[m] = live ? p.scale[(size_t)n_lo * C + m] : 0.0f;
  }
  const int row_bit0 = MODE != kGather ? p.bit_off[n_lo] : 0;
  for (int m = threadIdx.x; m < ng * kGroupNodes; m += kThreads) {
    const bool live = m < nc;
    s_thresh[m] = live && MODE == kGather ? p.thresh[n_lo + m] : -INFINITY;
    s_aux[m] = live && MODE != kGather ? p.aux[n_lo + m] : 0;
    s_boff[m] = live && MODE != kGather ? p.bit_off[n_lo + m] - row_bit0 : 0;
    s_poff[m] = live && MODE == kTuples && p.priv_entries > 0
                    ? p.priv_off[n_lo + m]
                    : -1;
  }
  if (MODE != kGather && p.bit_words > 0) {
    const int words = p.bit_off[n_lo + nc] - row_bit0;
    for (int i = threadIdx.x; i < words; i += kThreads)
      s_bits[i] = p.bits[(size_t)row_bit0 + i];
  }
  if (MODE == kTuples) {
    for (int i = threadIdx.x; i < p.priv_entries; i += kThreads) {
      s_pocc[i] = 0ull;
      s_pcol[i] = INT_MAX;
    }
  } else {
    for (int i = threadIdx.x; i < ng * kGroupNodes * kBlockWords;
         i += kThreads)
      s_hits[i] = 0u;
  }
  __syncthreads();

  const uint32_t* g_bits = MODE != kGather ? p.bits + row_bit0 : nullptr;
  const long long col_lo = (long long)blockIdx.x * kBlockCols;
  const long long col_hi =
      min(col_lo + (long long)kBlockCols, min(p.limit, p.n_cols));
  const int n_tiles =
      col_hi > col_lo ? (int)((col_hi - col_lo + kWarpCols - 1) / kWarpCols)
                      : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = bmma::frag_index(lane);  // matrix columns g and g + 8
  const int t = bmma::frag_word(lane);   // word of a step; node of a group
  const bool staged = n_steps > kRegSteps;
  uint32_t* slab = reinterpret_cast<uint32_t*>(smem_raw + lay.stage) +
                   (size_t)warp * n_steps * bmma::kLanes * 2;

  // Per (node, column) of group j, from its accumulators: the hit test and,
  // in tuples mode, the fold; in the select modes the hits' bits.
  auto epilogue = [&](int j, const int (&acc)[RP][4], int tile, long long k0,
                      long long k1, bool v0, bool v1) {
    const int node = j * kGroupNodes + t;
    const bool live = node < nc;
    bool hit[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int left[C];
#pragma unroll
      for (int c = 0; c < C; ++c) left[c] = acc[c / 2][2 * h + c % 2];
      const int occ = acc[C / 2][2 * h + C % 2];
      bool ok = live && (h ? v1 : v0);
      int key = 0;
      if (MODE == kGather) {
        if (ok) {
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
        }
      } else if (ok) {
        key = left[0];
#pragma unroll
        for (int c = 1; c < C; ++c)
          key = key * (s_nn[node * C + c] + 1) + left[c];
        const int idx = s_boff[node] + (key >> 5);
        const uint32_t word =
            p.bit_words > 0 ? s_bits[idx] : __ldg(g_bits + idx);
        ok = (word >> (key & 31)) & 1u;
        if (MODE == kEquiv) {
          const int om = s_aux[node];
          ok = ok && (om < 0 || occ == om);
        }
      }
      hit[h] = ok;
      if (MODE == kTuples && __any_sync(kFull, ok)) {
        // The lanes that hit one table entry, reduced to one update.
        const int po = live ? s_poff[node] : -1;
        const unsigned tag =
            !ok ? 0xFFFFFFFFu
                : po >= 0 ? 0x80000000u | (unsigned)(po + key)
                          : (unsigned)(s_aux[node] + key);
        const unsigned grp = __match_any_sync(kFull, tag);
        if (ok) {
          const unsigned col = (unsigned)(h ? k1 : k0);
          const unsigned om = __reduce_max_sync(grp, (unsigned)occ);
          const unsigned cm = __reduce_min_sync(
              grp, (unsigned)occ == om ? col : 0xFFFFFFFFu);
          const unsigned ca = __reduce_min_sync(grp, col);
          if (lane == __ffs(grp) - 1) {
            const unsigned long long v =
                ((unsigned long long)(om + 1u) << 32) | (0xFFFFFFFFu - cm);
            if (po >= 0) {
              const int i = po + key;
              if (s_pocc[i] < v) atomicMax(s_pocc + i, v);
              if (s_pcol[i] > (int32_t)ca) atomicMin(s_pcol + i, (int32_t)ca);
            } else {
              const unsigned e = (unsigned)(s_aux[node] + key);
              unsigned long long* a = p.occ_tab + e;
              if (__ldcg(a) < v) atomicMax(a, v);
              int32_t* b = p.col_tab + e;
              if (__ldcg(b) > (int32_t)ca) atomicMin(b, (int32_t)ca);
            }
          }
        }
      }
    }
    if (MODE != kTuples) {
      // Node t's hits of this tile: columns g (ballot 0) and g + 8
      // (ballot 1), gathered by the lanes g = 0 into one 16-bit half.
      const unsigned b0 = __ballot_sync(kFull, hit[0]);
      const unsigned b1 = __ballot_sync(kFull, hit[1]);
      const int slot = j * kGroupNodes + lane;
      if (lane < kGroupNodes && slot < nc) {
        const uint32_t half = every_fourth_bit(b0 >> lane) |
                              (every_fourth_bit(b1 >> lane) << 8);
        if (half) s_hits16[(size_t)slot * 2 * kBlockWords + tile] =
                      (uint16_t)half;
      }
    }
  };

  const uint32_t* b_tiles = s_tiles + lane;
  // A tile's columns: k0 = its first + g, k1 = k0 + 8, each valid or not
  // (never past the block's tiles).
  auto columns = [&](int tile, long long& k0, long long& k1, bool& v0,
                     bool& v1) {
    k0 = col_lo + (long long)tile * kWarpCols + g;
    k1 = k0 + bmma::kTileRows / 2;
    v0 = k0 < col_hi && (p.excl == nullptr || p.excl[k0] == 0);
    v1 = k1 < col_hi && (p.excl == nullptr || p.excl[k1] == 0);
  };
  if (!staged) {
    for (int tile = warp; tile < n_tiles; tile += kWarps) {
      long long k0, k1;
      bool v0, v1;
      columns(tile, k0, k1, v0, v1);
      if (!__any_sync(kFull, v0 || v1)) continue;
      // The tile's A fragments, read once into registers.
      uint32_t a[kRegSteps][2];
#pragma unroll
      for (int s = 0; s < kRegSteps; ++s) {
        const int w = s * bmma::kStepWords + t;
        const uint32_t* src = p.matrix + (size_t)w * p.n_cols;
        a[s][0] = v0 && w < p.n_words ? __ldg(src + k0) : 0u;
        a[s][1] = v1 && w < p.n_words ? __ldg(src + k1) : 0u;
      }
      for (int j = 0; j < ng; ++j) {
        const uint32_t* b = b_tiles + (size_t)j * group_words;
        int acc[RP][4];
#pragma unroll
        for (int q = 0; q < RP; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] = 0;
        // Two 128-bit steps a 256-bit product; an odd last step alone.
#pragma unroll
        for (int s = 0; s < kRegSteps; s += 2) {
#pragma unroll
          for (int q = 0; q < RP; ++q) {
            const uint32_t* bq = b + ((size_t)q * n_steps + s) * bmma::kLanes;
            if (s + 1 < n_steps)
              bmma::mma_and_popc_k256(acc[q], a[s][0], a[s][1], a[s + 1][0],
                                      a[s + 1][1], bq[0], bq[bmma::kLanes]);
            else if (s < n_steps)
              bmma::mma_and_popc_k128(acc[q], a[s][0], a[s][1], bq[0]);
          }
        }
        epilogue(j, acc, tile, k0, k1, v0, v1);
      }
    }
  } else {
    for (int tile = warp; tile < n_tiles; tile += kWarps) {
      long long k0, k1;
      bool v0, v1;
      columns(tile, k0, k1, v0, v1);
      if (!__any_sync(kFull, v0 || v1)) continue;
      // Deeper masks: the tile's A fragments into the warp's slab by
      // cp.async, once, then read from shared memory for every group.
      __syncwarp();  // the previous tile's reads of the slab are done
      for (int s = 0; s < n_steps; ++s) {
        const int w = s * bmma::kStepWords + t;
        const bool in = w < p.n_words;
        const uint32_t* src = p.matrix + (size_t)(in ? w : 0) * p.n_cols;
        cp_async4(slab + (s * bmma::kLanes + lane) * 2, src + (v0 ? k0 : 0),
                  in && v0);
        cp_async4(slab + (s * bmma::kLanes + lane) * 2 + 1,
                  src + (v1 ? k1 : 0), in && v1);
      }
      cp_async_wait_all();
      __syncwarp();
      for (int j = 0; j < ng; ++j) {
        int acc[RP][4];
#pragma unroll
        for (int q = 0; q < RP; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] = 0;
        const uint2* frag = reinterpret_cast<const uint2*>(slab) + lane;
        for (int s = 0; s < n_steps; s += 2) {
          const uint2 a = frag[s * bmma::kLanes];
          const uint2 a2 =
              s + 1 < n_steps ? frag[(s + 1) * bmma::kLanes] : uint2{0, 0};
#pragma unroll
          for (int q = 0; q < RP; ++q) {
            const uint32_t* bq =
                b_tiles + ((size_t)(j * RP + q) * n_steps + s) * bmma::kLanes;
            if (s + 1 < n_steps)
              bmma::mma_and_popc_k256(acc[q], a.x, a.y, a2.x, a2.y, bq[0],
                                      bq[bmma::kLanes]);
            else
              bmma::mma_and_popc_k128(acc[q], a.x, a.y, bq[0]);
          }
        }
        epilogue(j, acc, tile, k0, k1, v0, v1);
      }
    }
  }

  __syncthreads();
  if (MODE == kTuples) {
    // The private tables into the global ones, once per block.
    if (p.priv_entries == 0) return;
    for (int s = 0; s < nc; ++s) {
      const int po = s_poff[s];
      if (po < 0) continue;
      int lattice = 1;
#pragma unroll
      for (int c = 0; c < C; ++c) lattice *= s_nn[s * C + c] + 1;
      for (int key = threadIdx.x; key < lattice; key += kThreads) {
        const unsigned long long v = s_pocc[po + key];
        if (v == 0ull) continue;
        const size_t e = (size_t)s_aux[s] + key;
        if (__ldcg(p.occ_tab + e) < v) atomicMax(p.occ_tab + e, v);
        const int32_t cm = s_pcol[po + key];
        if (__ldcg(p.col_tab + e) > cm) atomicMin(p.col_tab + e, cm);
      }
    }
    return;
  }
  // Per node of the row: the block's hit count and, if any, its hit words.
  for (int s = warp; s < nc; s += kWarps) {
    uint32_t words[kBlockWords / 32];
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kBlockWords / 32; ++i) {
      words[i] = s_hits[(size_t)s * kBlockWords + i * 32 + lane];
      cnt += __popc(words[i]);
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0)
      p.counts[(size_t)(n_lo + s) * gridDim.x + blockIdx.x] = cnt;
    if (cnt) {
      uint32_t* dst =
          p.hits + ((size_t)(n_lo + s) * gridDim.x + blockIdx.x) * kBlockWords;
#pragma unroll
      for (int i = 0; i < kBlockWords / 32; ++i) dst[i * 32 + lane] = words[i];
    }
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

struct FillParams {
  const int32_t* n_node;  // (n_nodes, C)
  const float* scale;     // (n_nodes, C)
  const float* thresh;    // (n_nodes,)
  const int32_t* bit_off;  // (n_nodes + 1,)
  uint32_t* bits;
};

// One warp per bitmap word, one lane per key: the pass bit of every key of
// node blockIdx.y's lattice.
template <int C, int CRIT>
__global__ void __launch_bounds__(kFillWarps * 32)
    cart_exact_bitmap_kernel(const FillParams p) {
  const int node = blockIdx.y;
  const int word = blockIdx.x * kFillWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  int lattice = 1;
#pragma unroll
  for (int c = 0; c < C; ++c) lattice *= p.n_node[node * C + c] + 1;
  if (word >= (lattice + 31) / 32) return;  // the whole warp
  const int key = word * 32 + lane;
  bool ok = false;
  if (key < lattice) {
    int left[C];
    int rem = key;
#pragma unroll
    for (int c = C - 1; c > 0; --c) {
      const int radix = p.n_node[node * C + c] + 1;
      left[c] = rem % radix;
      rem /= radix;
    }
    left[0] = rem;
    float pl[C];
    float pr[C];
    int left_n = 0;
    int right_n = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int right = p.n_node[node * C + c] - left[c];
      const float sc = p.scale[node * C + c];
      left_n += left[c];
      right_n += right;
      pl[c] = __fmul_rn(sc, (float)left[c]);
      pr[c] = __fmul_rn(sc, (float)right);
    }
    ok = left_n > 0 && right_n > 0 &&
         split_score<C, CRIT>(pl, pr) <= p.thresh[node];
  }
  const unsigned bits = __ballot_sync(kFull, ok);
  if (lane == 0) p.bits[(size_t)p.bit_off[node] + word] = bits;
}

struct WriteParams {
  const uint32_t* matrix;
  int n_words;
  long long n_cols;
  const uint32_t* hits;      // (n_nodes, n_blocks, kBlockWords)
  const long long* counts;   // (n_nodes, n_blocks)
  const long long* offsets;  // (n_nodes, n_blocks)
  int n_nodes;
  int n_blocks;
  int n_classes;
  const uint32_t* class_masks;  // gather: (n_nodes, n_classes, n_words)
  const uint32_t* train_masks;  // gather: (n_nodes, n_words)
  int32_t* out_col;
  int32_t* out_left;  // gather: (n_classes, total)
  int32_t* out_occ;   // gather
  long long total;
};

// One block per (column block, node): the node's hits of the block at its
// offset, ascending, from the hit words alone; in gather mode each hit
// column's counts again, over its W words.
template <bool GATHER>
__global__ void __launch_bounds__(kBlockWords)
    cart_exact_write_kernel(const WriteParams p) {
  constexpr int kMaxClasses = 8;
  const int b = blockIdx.x;
  const int node = blockIdx.y;
  const size_t at = (size_t)node * p.n_blocks + b;
  if (p.counts[at] == 0) return;  // the whole block
  __shared__ int s_warp[kBlockWords / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t word =
      p.hits[((size_t)node * p.n_blocks + b) * kBlockWords + threadIdx.x];
  const int n = __popc(word);
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  long long base = p.offsets[at];
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  const int excl = incl - n;
  const long long col0 = (long long)b * kBlockCols + (long long)warp * 32 * 32;
  const unsigned below = (1u << lane) - 1u;
  for (int i = 0; i < 32; ++i) {
    const uint32_t wi = __shfl_sync(kFull, word, i);
    if (wi == 0u) continue;
    const int pre = __shfl_sync(kFull, excl, i);
    if (!((wi >> lane) & 1u)) continue;
    const long long pos = base + pre + __popc(wi & below);
    const long long col = col0 + i * 32 + lane;
    p.out_col[pos] = (int32_t)col;
    if (GATHER) {
      int left[kMaxClasses];
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) left[c] = 0;
      int occ = 0;
      const uint32_t* cm = p.class_masks + (size_t)node * p.n_classes * p.n_words;
      const uint32_t* tm = p.train_masks + (size_t)node * p.n_words;
      for (int w = 0; w < p.n_words; ++w) {
        const uint32_t x = __ldg(p.matrix + (size_t)w * p.n_cols + col);
        occ += __popc(x & __ldg(tm + w));
#pragma unroll
        for (int c = 0; c < kMaxClasses; ++c)
          if (c < p.n_classes)
            left[c] += __popc(x & __ldg(cm + (size_t)c * p.n_words + w));
      }
      p.out_occ[pos] = occ;
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c)
        if (c < p.n_classes) p.out_left[(size_t)c * p.total + pos] = left[c];
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int mode, const Params& p, int n_classes,
           void* stream) {
  const size_t smem = layout(mode, p.n_words, p.groups_per_block, n_classes,
                             p.bit_words, p.priv_entries)
                          .total;
  const int n_blocks = (int)((p.n_cols + kBlockCols - 1) / kBlockCols);
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

template <int C>
int launch_fill(int criterion, const FillParams& p, int n_nodes,
                int max_words, void* stream) {
  const dim3 grid((max_words + kFillWarps - 1) / kFillWarps, n_nodes);
  if (criterion == kGini)
    cart_exact_bitmap_kernel<C, kGini>
        <<<grid, kFillWarps * 32, 0, (cudaStream_t)stream>>>(p);
  else
    cart_exact_bitmap_kernel<C, kCrossEntropy>
        <<<grid, kFillWarps * 32, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared with the sweep entries: matrix (n_words, n_cols) words; tiles
// (groups, pairs, steps, 32) words: the (n_nodes, n_classes + 1, n_words)
// mask rows (classes, then the train mask) in the fragment order of
// bmma_tile.cuh, groups = ceil(n_nodes / 4), pairs = ceil((n_classes + 1) /
// 2), steps = ceil(n_words / 4), 0 past the real nodes, rows and words;
// n_node (n_nodes, n_classes) int32; scale (n_nodes, n_classes) float32 =
// priors / totals; excl (n_cols,) bytes or null; columns at or past `limit`
// are padding; criterion 0 = Gini, 1 = cross-entropy. n_classes is 2, 3, 4,
// 6 or 8 (a caller with a count in between appends empty classes); grid row
// y takes the groups [y * groups_per_block, (y + 1) * groups_per_block);
// column blocks are 4096 columns. Bitmaps (tuples, equiv): node n's words
// are bits[bit_off[n], bit_off[n + 1]), bit key % 32 of word key / 32;
// bit_words > 0 holds a grid row's bitmaps in shared memory (at least the
// row's words), 0 reads them from global memory. The caller checks n_nodes
// > 0 and n_cols > 0.
//
// The pass bitmaps: bits[bit_off[n] + i] for i < ceil(prod(n_c + 1) / 32),
// max_words the largest such count.
extern "C" int grm_cart_exact_bitmap(int criterion, const void* n_node,
                                     const void* scale, const void* thresh,
                                     const void* bit_off, int n_nodes,
                                     int n_classes, int max_words, void* bits,
                                     void* stream) {
  if (criterion != kGini && criterion != kCrossEntropy)
    return (int)cudaErrorInvalidValue;
  FillParams p = {(const int32_t*)n_node, (const float*)scale,
                  (const float*)thresh, (const int32_t*)bit_off,
                  (uint32_t*)bits};
  switch (n_classes) {
    case 2:
      return launch_fill<2>(criterion, p, n_nodes, max_words, stream);
    case 3:
      return launch_fill<3>(criterion, p, n_nodes, max_words, stream);
    case 4:
      return launch_fill<4>(criterion, p, n_nodes, max_words, stream);
    case 6:
      return launch_fill<6>(criterion, p, n_nodes, max_words, stream);
    case 8:
      return launch_fill<8>(criterion, p, n_nodes, max_words, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tuple tables from the pass bitmaps: table_off (n_nodes,) int32
// entries; occ_tab (u64) zeroed and col_tab (int32) filled with INT_MAX by
// the caller, node n's entries from table_off[n] on, prod(n_c + 1) of them;
// priv_off (n_nodes,) int32: a node's private tables in its grid row's
// priv_entries (-1: none; null when priv_entries is 0).
extern "C" int grm_cart_exact_tuples(
    int criterion, const void* matrix, int n_words, long long n_cols,
    long long limit, const void* tiles, const void* n_node, const void* scale,
    const void* table_off, const void* bits, const void* bit_off,
    int bit_words, const void* priv_off, int priv_entries, int n_nodes,
    int n_classes, int groups_per_block, const void* excl, void* occ_tab,
    void* col_tab, void* stream) {
  Params p = {};
  p.matrix = (const uint32_t*)matrix;
  p.n_words = n_words;
  p.n_cols = n_cols;
  p.limit = limit;
  p.tiles = (const uint32_t*)tiles;
  p.n_node = (const int32_t*)n_node;
  p.scale = (const float*)scale;
  p.aux = (const int32_t*)table_off;
  p.bits = (const uint32_t*)bits;
  p.bit_off = (const int32_t*)bit_off;
  p.bit_words = bit_words;
  p.priv_off = (const int32_t*)priv_off;
  p.priv_entries = priv_entries;
  p.n_nodes = n_nodes;
  p.groups_per_block = groups_per_block;
  p.excl = (const uint8_t*)excl;
  p.occ_tab = (unsigned long long*)occ_tab;
  p.col_tab = (int32_t*)col_tab;
  return dispatch(kTuples, criterion, n_classes, p, stream);
}

// The compaction's counting launch: mode 1 = gather (thresh (n_nodes,)
// float32), mode 2 = equiv (occmax (n_nodes,) int32, -1 = any occurrence;
// the winning-key bitmaps). Fills counts (n_nodes, n_blocks) int64 with the
// hits of each (node, column block) and, where they are not 0, that
// block's kBlockWords hit words of hits (n_nodes, n_blocks, kBlockWords),
// bit i of word j = column 4096 b + 32 j + i; n_blocks = ceil(n_cols /
// 4096).
extern "C" int grm_cart_exact_select(
    int mode, int criterion, const void* matrix, int n_words,
    long long n_cols, long long limit, const void* tiles, const void* n_node,
    const void* scale, const void* thresh, const void* occmax,
    const void* bits, const void* bit_off, int bit_words, int n_nodes,
    int n_classes, int groups_per_block, const void* excl, void* counts,
    void* hits, void* stream) {
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
  p.bits = (const uint32_t*)bits;
  p.bit_off = (const int32_t*)bit_off;
  p.bit_words = bit_words;
  p.n_nodes = n_nodes;
  p.groups_per_block = groups_per_block;
  p.excl = (const uint8_t*)excl;
  p.counts = (long long*)counts;
  p.hits = (uint32_t*)hits;
  return dispatch(mode, criterion, n_classes, p, stream);
}

// The compaction's writing launch: node n's hits of block b, ascending,
// from offsets[n, b] on, into out_col (total,) int32 and, with gather 1,
// their class counts out_left (n_classes, total) and occurrences out_occ
// (total,), counted over class_masks (n_nodes, n_classes, n_words) and
// train_masks (n_nodes, n_words); n_classes is at most 8.
extern "C" int grm_cart_exact_write(
    int gather, const void* matrix, int n_words, long long n_cols,
    const void* hits, const void* counts, const void* offsets, int n_nodes,
    int n_classes, const void* class_masks, const void* train_masks,
    void* out_col, void* out_left, void* out_occ, long long total,
    void* stream) {
  if (n_classes < 1 || n_classes > 8) return (int)cudaErrorInvalidValue;
  WriteParams p = {};
  p.matrix = (const uint32_t*)matrix;
  p.n_words = n_words;
  p.n_cols = n_cols;
  p.hits = (const uint32_t*)hits;
  p.counts = (const long long*)counts;
  p.offsets = (const long long*)offsets;
  p.n_nodes = n_nodes;
  p.n_blocks = (int)((n_cols + kBlockCols - 1) / kBlockCols);
  p.n_classes = n_classes;
  p.class_masks = (const uint32_t*)class_masks;
  p.train_masks = (const uint32_t*)train_masks;
  p.out_col = (int32_t*)out_col;
  p.out_left = (int32_t*)out_left;
  p.out_occ = (int32_t*)out_occ;
  p.total = total;
  const dim3 grid(p.n_blocks, n_nodes);
  if (gather)
    cart_exact_write_kernel<true>
        <<<grid, kBlockWords, 0, (cudaStream_t)stream>>>(p);
  else
    cart_exact_write_kernel<false>
        <<<grid, kBlockWords, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Shared-memory bytes of one sweep block (mode 0 tuples, 1 gather, 2
// equiv).
extern "C" long long grm_cart_exact_smem_bytes(int mode, int n_words,
                                               int groups_per_block,
                                               int n_classes, int bit_words,
                                               int priv_entries) {
  return (long long)layout(mode, n_words, groups_per_block, n_classes,
                           bit_words, priv_entries)
      .total;
}
