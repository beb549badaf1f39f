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
// What bounds it on the H100. The counting is a 1-bit matrix product,
// (cn, cp) = matrix AND-POPC masks, and runs on the tensor cores
// (bmma_tile.cuh): at W = 11 words, two products (a k256 and a k128) per 16
// columns and 4 fits, where the scalar pipe took 2 * 11 AND + POPC + ADD
// per (fit, column). What is left is the epilogue per (fit, column): two
// conversions, the utilities (one product and one difference for kArgmax,
// two and four for kSuperblockMax), the zero-coverage tests and a min and a
// max, 9 to 10 instructions on the ALU and FMA pipes. The kernel is bound
// by issuing those and by waiting on the chains of products between them,
// not by the one read of the matrix (PERF.md has the times).
//
// The design. One warp owns tiles of 16 matrix columns: they are the 16
// rows of the tile product's A operand, read straight from matrix[w, k] as
// fragments (lane g * 4 + t reads word 4 * step + t of columns g and g + 8).
// The fit masks are the B operand, 8 to a tile: 4 fits x (neg, pos), packed
// by the caller in fragment order (ops/tiles.py pack_mask_tiles); the block
// keeps them in shared memory as one 16-byte word per lane and 4 steps, so
// one load brings a group's B for a whole chunk of 512 genomes. After the
// steps thread (g, t) holds cn and cp of fit t of the group for columns g
// and g + 8 and takes them with no shuffle. The conversions are one
// subtraction each: the accumulators start at the bits of the float 2^23,
// so the product's integer sum leaves 2^23 + count there, and subtracting
// 2^23 gives the count as a float, exactly (counts stay below 2^23), on the
// full-rate pipe and not on the quarter-rate I2F. In the common case (no
// padding, at most 512 genomes) a warp takes four tiles at once: they share
// each group's B and constants, and their four chains of products run side
// by side. With an exclusion mask a warp reads the mask's bytes of its four
// tiles one run ahead, and they still take the common case unless a rule
// is banned alone: a column banned in both rows is read as a copy of an
// unbanned column of the run, which min and max then take twice, changing
// nothing. A pass keeps the running extrema of 32 groups in registers;
// more groups take more passes over the block's columns (re-read from
// L1/L2), and groups past the shared-memory budget go to grid rows. Tiles
// with padding or a rule banned alone are taken one at a time with every
// column tested. A tile whose 16 columns are all past the limit or banned
// in both rows is not loaded. That is the shallow build, up to 512 genomes
// (16 words).
//
// The deep build, past 512 genomes (sweep_deep). There the product's work
// grows with the depth while the epilogue's does not, so the bound is the
// b1 product itself: at 5022 genomes (W = 157), K = 11.7M and F = 120 fits,
// 2.74 ms of BMMA against 2.19 ms for one read of the 7.35 GB matrix. Both
// bounds hold only if every matrix word is read from device memory once a
// launch, and if no product waits on a load. So a block holds the B
// fragments of all its groups in shared memory for the whole launch (one
// 256-byte k256 fragment a group and step: 150 KB for 30 groups at W =
// 157), and a producer warp streams the block's columns through a ring of
// stages in shared memory by cp.async, ahead of 8 consumer warps: a stage
// is 64 columns x 32 words (4 k256 steps), the column tiles in order and
// the depth inside each, each stage read from device memory once and
// released by the consumers through mbarriers. The copies are 16 bytes a
// lane where K is a multiple of 4 columns, else 4 bytes, so K may be any
// width. Every consumer warp reads every stage's four 16-column tiles from
// shared memory and takes its own groups against them: warp w keeps groups
// w, w + 8, w + 16 and w + 24 of the block in registers, 4 tiles x 4 groups
// = 16 independent chains of k256 products, so one product's latency hides
// behind the others and no product waits on device memory or L2; a whole
// stage's 4 steps are unrolled with no test, so that a step's fragments
// load during the step before. A stage row stores column c at c ^ (8 (w &
// 3)), so the fragments' loads (lane 4 g + t reads word t of columns g and
// g + 8) and the producer's row writes hit 32 banks. A block owns one
// column block as before and each group one warp, so the extrema need no
// atomics and no reduction across warps. What bounds it then is issue and
// latency in the consumers (1 block, 9 warps an SM: the ring and B take
// 221 KB): the shared-memory traffic, 192 bytes a product, would allow
// ~75% of the b1 rate, and the matrix streams at a third of its rate
// (PERF.md has the times). The groups that do not fit one block (past 32
// groups, or B past what the ring leaves) are split evenly over grid rows,
// each of which reads the matrix again: as the consumers bound the kernel,
// a second read costs little (at F = 200, W = 157, two grid rows ran as
// fast as the same two blocks launched as a thread-block cluster). Whether
// the launch has an exclusion mask is a template parameter (MASKED) here
// too: tested at run time, it cost the consumers 6 registers and ~4% at
// F = 120, W = 157.
//
// Plain C interface for ctypes; returns cudaGetLastError().

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "bmma_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupFits = 4;  // fits of one mask tile (8 masks = 4 pairs)
constexpr int kWarpCols = bmma::kTileRows;  // matrix columns per warp tile
constexpr int kHalf = bmma::kTileRows / 2;  // column g + kHalf: d[2], d[3]
constexpr int kChunkSteps = 4;  // depth steps of one 16-byte B load
constexpr int kMagic = 0x4B000000;  // the bits of 2^23 as a float
constexpr float kMagicF = 8388608.0f;
constexpr int kPassGroups = 32;  // groups a pass, up to 512 genomes
constexpr int kWideTiles = 4;    // warp tiles of the common case side by side
constexpr int kWideCols = kWideTiles * kWarpCols;

// The deep build (past 512 genomes).
constexpr int kDeepWarps = 8;     // consumer warps; one more is the producer
constexpr int kDeepThreads = (kDeepWarps + 1) * 32;
constexpr int kWarpGroups = 4;    // groups a consumer warp keeps in registers
constexpr int kDeepGroups = kDeepWarps * kWarpGroups;  // groups a block
constexpr int kStageTiles = 4;    // 16-column tiles of a stage
constexpr int kStageCols = kStageTiles * kWarpCols;    // 64 columns
constexpr int kStageWords = 32;   // word rows of a stage
constexpr int kStageSteps = kStageWords / (2 * bmma::kStepWords);  // k256
constexpr int kStageBytes = kStageWords * kStageCols * 4;
constexpr int kMaxStages = 8;     // the ring's stages, at most
constexpr int kMinStages = 2;
constexpr int kSmemMax = 227 * 1024;

enum Epilogue { kArgmax = 0, kSuperblockMax = 1 };

// Blocks an SM: 128 registers a thread, for the running extrema (2 x 32
// for kArgmax, 32 for kSuperblockMax) and the A fragments of four tiles.
constexpr int kBlocksPerSM = 2;

__host__ __device__ inline int depth_steps(int n_words) {
  return (n_words + bmma::kStepWords - 1) / bmma::kStepWords;
}

__host__ __device__ inline int depth_chunks(int n_words) {
  return (depth_steps(n_words) + kChunkSteps - 1) / kChunkSteps;
}

// k256 steps of the deep build: pairs of k128 steps, the last one maybe
// half zero.
__host__ __device__ inline int deep_steps(int n_words) {
  return (depth_steps(n_words) + 1) / 2;
}

// A deep block's shared memory for its groups, less the ring: the B
// fragments ([group][k256 step][lane], 8 bytes each) and the fits'
// constants (p, n_neg + n_pos, n_neg, n_pos).
__host__ __device__ inline size_t deep_fixed_bytes(int n_words, int groups) {
  return (size_t)groups * deep_steps(n_words) * bmma::kLanes * sizeof(uint2) +
         (size_t)groups * kGroupFits * sizeof(float4);
}

// The ring's stages: as many as the rest of the shared memory holds, up to
// kMaxStages; each takes its bytes and two mbarriers (full, empty).
__host__ __device__ inline int deep_stages(int n_words, int groups) {
  const long long left =
      (long long)kSmemMax - (long long)deep_fixed_bytes(n_words, groups);
  const long long n = left / (kStageBytes + 2 * (long long)sizeof(uint64_t));
  return (int)(n < kMaxStages ? n : kMaxStages);
}

// Shared memory. Shallow: the B fragments of the row's groups
// ([group][chunk][lane], 16 bytes each), the fits' constants, then the
// reduction scratch of 8 warps x a pass's groups x 4 fits, twice. Deep:
// deep_fixed_bytes, then the ring's stages and their mbarriers.
__host__ __device__ inline size_t smem_bytes(int n_words, int groups_per_row) {
  if (depth_chunks(n_words) > 1)
    return deep_fixed_bytes(n_words, groups_per_row) +
           (size_t)deep_stages(n_words, groups_per_row) *
               (kStageBytes + 2 * sizeof(uint64_t));
  return (size_t)groups_per_row * depth_chunks(n_words) * bmma::kLanes *
             sizeof(uint4) +
         (size_t)groups_per_row * kGroupFits * sizeof(float4) +
         (size_t)2 * kWarps * kPassGroups * kGroupFits * sizeof(float);
}

// The exclusion mask's bytes of the run of kWideCols columns from c0 on,
// as lane reads them: presence and absence of column c0 + lane, then of
// c0 + 32 + lane; zeros without a mask or for a run that passes col_hi
// (which takes the one-tile path). Loaded one run ahead of their use.
__device__ __forceinline__ void load_excl(uint32_t (&ex)[4],
                                          const uint8_t* __restrict__ excl,
                                          long long n_cols, long long c0,
                                          long long col_hi, int lane) {
  const bool live = excl != nullptr && c0 + kWideCols <= col_hi;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    ex[i] = live ? __ldg(excl + (i & 1) * n_cols + c0 + (i >> 1) * 32 + lane)
                 : 0u;
}

// Whether a run of kWideCols columns takes the common case, from its mask
// bytes: only if no rule is banned alone and no tile is banned whole (it
// is not loaded; the one-tile path skips it). A column banned in both rows
// contributes nothing; there it is read as a copy of the run's first
// unbanned column, whose utilities the block takes anyway, so min and max
// are unchanged. sub: bit h set where lane's column g + 8h is such a copy;
// sub_off: the copy's offset from column g.
__device__ __forceinline__ bool wide_run(const uint32_t (&ex)[4], int g,
                                         uint32_t& sub, int& sub_off) {
  const bool p0 = ex[0] != 0, a0 = ex[1] != 0;
  const bool p1 = ex[2] != 0, a1 = ex[3] != 0;
  if (__any_sync(0xffffffffu, p0 != a0 || p1 != a1)) return false;
  const uint32_t lo = __ballot_sync(0xffffffffu, p0);  // columns 0..31
  const uint32_t hi = __ballot_sync(0xffffffffu, p1);  // columns 32..63
  if ((lo | hi) == 0) return true;
  if ((lo & 0xffffu) == 0xffffu || (lo >> 16) == 0xffffu ||
      (hi & 0xffffu) == 0xffffu || (hi >> 16) == 0xffffu)
    return false;
  // Tiles 0 and 1 are not both banned whole, so a column of lo is free.
  sub_off = __ffs(~lo) - 1 - g;
  sub = 0;
#pragma unroll
  for (int h = 0; h < 2 * kWideTiles; ++h)
    sub |= (((h < 4 ? lo : hi) >> (g + kHalf * (h & 3))) & 1u) << h;
  return true;
}

// A count from an accumulator that started at kMagic, as a float, exactly.
__device__ __forceinline__ float count_of(int acc) {
  return __fsub_rn(__int_as_float(acc), kMagicF);
}

// One (fit, column): counts (acc_n, acc_p) as the product left them; fit =
// (p, bits of n_neg + n_pos, n_neg, n_pos); ex_p / ex_a ban the presence /
// absence rule (exclusion mask or padding).
template <int EPI>
__device__ __forceinline__ void take_column(float& best_a, float& best_b,
                                            int acc_n, int acc_p,
                                            const float4& fit, bool ex_p,
                                            bool ex_a) {
  const float cn = count_of(acc_n);
  const float cp = count_of(acc_p);
  const float p = fit.x;
  if (EPI == kArgmax) {
    const float u = __fsub_rn(cn, __fmul_rn(p, cp));
    const int s = (int)((uint32_t)acc_n + (uint32_t)acc_p - 2u * kMagic);
    if (!(s == __float_as_int(fit.y) || ex_p)) best_a = fminf(best_a, u);
    if (!(s == 0 || ex_a)) best_b = fmaxf(best_b, u);
  } else {
    const float u_pres = __fsub_rn(__fsub_rn(fit.z, cn),
                                   __fmul_rn(p, __fsub_rn(fit.w, cp)));
    const float u_abs = __fsub_rn(cn, __fmul_rn(p, cp));
    if (!ex_p) best_a = fmaxf(best_a, u_pres);
    if (!ex_a) best_a = fmaxf(best_a, u_abs);
  }
}

// One warp tile of 16 columns from k0 - g on, for the gp groups of a pass
// (at most GC), with every column tested: padding, the exclusion mask. The
// tile is not loaded when all its columns are padding or banned in both
// rows. At most 512 genomes: one chunk of 4 steps.
template <int EPI, int GC>
__device__ __forceinline__ void sweep_tile(
    float (&best_a)[GC], float (&best_b)[GC],
    const uint32_t* __restrict__ matrix, int n_words, long long n_cols,
    int n_steps, int n_chunks, long long k0, long long col_hi,
    const uint8_t* __restrict__ excl, const uint4* b_pass,
    const float4* fit_pass, int gp, int t) {
  const long long k1 = k0 + kHalf;
  bool ex_p0 = k0 >= col_hi;
  bool ex_a0 = ex_p0;
  bool ex_p1 = k1 >= col_hi;
  bool ex_a1 = ex_p1;
  if (excl != nullptr) {
    if (!ex_p0) {
      ex_p0 = excl[k0] != 0;
      ex_a0 = excl[n_cols + k0] != 0;
    }
    if (!ex_p1) {
      ex_p1 = excl[k1] != 0;
      ex_a1 = excl[n_cols + k1] != 0;
    }
  }
  const bool v0 = !(ex_p0 && ex_a0);
  const bool v1 = !(ex_p1 && ex_a1);
  if (!__any_sync(0xffffffffu, v0 || v1)) return;

  // The first chunk's A fragments (up to 512 genomes), kept for every group
  // of the pass.
  const size_t step_stride = (size_t)bmma::kStepWords * n_cols;
  const uint32_t* src = matrix + (size_t)t * n_cols + k0;
  uint32_t a0[kChunkSteps];
  uint32_t a1[kChunkSteps];
#pragma unroll
  for (int i = 0; i < kChunkSteps; ++i) {
    const bool deep = i * bmma::kStepWords + t < n_words;
    a0[i] = v0 && deep ? __ldg(src + i * step_stride) : 0u;
    a1[i] = v1 && deep ? __ldg(src + i * step_stride + kHalf) : 0u;
  }
  __syncwarp();

  const int start[4] = {kMagic, kMagic, kMagic, kMagic};
#pragma unroll
  for (int j = 0; j < GC; ++j) {
    if (j >= gp) break;
    const uint4* b_grp = b_pass + (size_t)j * n_chunks * bmma::kLanes;
    const uint4 b = b_grp[0];
    int acc[4];
    bmma::mma_and_popc_k128_from(acc, a0[0], a1[0], b.x, start);
    if (n_steps > 1) bmma::mma_and_popc_k128(acc, a0[1], a1[1], b.y);
    if (n_steps > 2) bmma::mma_and_popc_k128(acc, a0[2], a1[2], b.z);
    if (n_steps > 3) bmma::mma_and_popc_k128(acc, a0[3], a1[3], b.w);
    const float4 fc = fit_pass[j * kGroupFits];
    take_column<EPI>(best_a[j], best_b[j], acc[0], acc[1], fc, ex_p0, ex_a0);
    take_column<EPI>(best_a[j], best_b[j], acc[2], acc[3], fc, ex_p1, ex_a1);
  }
}

// kWideTiles warp tiles, 16 kWideTiles columns from k0 - g on, none of them
// padding or banned in one row alone, at most 512 genomes (one chunk of
// steps): the common case, with no column tested; columns banned in both
// rows are read as copies (wide_run's sub, sub_off). The tiles share each
// group's B and constants, and their chains of products run side by side.
// STEPS (3 or 4) fixes the chain at two products, a k256 over steps 0 and 1
// and a k128 (or k256) over the rest, so that no product waits on a step
// that does not exist; fewer steps multiply zero A words.
template <int EPI, int GC, int STEPS>
__device__ __forceinline__ void sweep_wide(
    float (&best_a)[GC], float (&best_b)[GC],
    const uint32_t* __restrict__ matrix, int n_words, long long n_cols,
    long long k0, const uint4* b_pass, const float4* fit_pass, int gp,
    int t, uint32_t sub, int sub_off) {
  const size_t step_stride = (size_t)bmma::kStepWords * n_cols;
  const uint32_t* src = matrix + (size_t)t * n_cols + k0;
  uint32_t a[kWideTiles][2][STEPS];  // [tile][column g, g + 8][step]
  int off[2 * kWideTiles];  // of column g + 8h, or of its copy
#pragma unroll
  for (int h = 0; h < 2 * kWideTiles; ++h)
    off[h] = (sub >> h) & 1u ? sub_off : h * kHalf;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const bool deep = i * bmma::kStepWords + t < n_words;
#pragma unroll
    for (int h = 0; h < 2 * kWideTiles; ++h)
      a[h / 2][h % 2][i] = deep ? __ldg(src + i * step_stride + off[h]) : 0u;
  }
  __syncwarp();

  const int start[4] = {kMagic, kMagic, kMagic, kMagic};
#pragma unroll
  for (int j = 0; j < GC; ++j) {
    if (j >= gp) break;
    const uint4 b4 = b_pass[(size_t)j * bmma::kLanes];
    const uint32_t b[kChunkSteps] = {b4.x, b4.y, b4.z, b4.w};
    int acc[kWideTiles][4];
    // Steps 0 and 1 as one k256 product, then step 2 (and 3) as k128 or
    // k256: a chain of 2 products at 3 or 4 steps.
#pragma unroll
    for (int u = 0; u < kWideTiles; ++u)
      bmma::mma_and_popc_k256_from(acc[u], a[u][0][0], a[u][1][0], a[u][0][1],
                                   a[u][1][1], b[0], b[1], start);
#pragma unroll
    for (int u = 0; u < kWideTiles; ++u) {
      if (STEPS == 4)
        bmma::mma_and_popc_k256(acc[u], a[u][0][2], a[u][1][2], a[u][0][3],
                                a[u][1][3], b[2], b[3]);
      else
        bmma::mma_and_popc_k128(acc[u], a[u][0][2], a[u][1][2], b[2]);
    }
    const float4 fc = fit_pass[j * kGroupFits];
#pragma unroll
    for (int u = 0; u < kWideTiles; ++u) {
      take_column<EPI>(best_a[j], best_b[j], acc[u][0], acc[u][1], fc, false,
                       false);
      take_column<EPI>(best_a[j], best_b[j], acc[u][2], acc[u][3], fc, false,
                       false);
    }
  }
}

// The kernel's parameters, as every build takes them.
#define GRM_PARAMS                                                          \
  const uint32_t *__restrict__ matrix, int n_words, long long n_cols,      \
      long long limit, const uint32_t *__restrict__ tiles,                 \
      const int32_t *__restrict__ n_neg, const int32_t *__restrict__ n_pos, \
      const float *__restrict__ ps, int n_fits, int groups_per_row,        \
      const uint8_t *__restrict__ excl, int block_cols, int n_blocks,      \
      float *__restrict__ out_a, float *__restrict__ out_b
#define GRM_PARAM_NAMES                                                     \
  matrix, n_words, n_cols, limit, tiles, n_neg, n_pos, ps, n_fits,          \
      groups_per_row, excl, block_cols, n_blocks, out_a, out_b

// The shallow build (up to 512 genomes). MASKED: whether the launch has an
// exclusion mask, so that the common case without one keeps no mask bytes
// and no copies in registers.
template <int EPI, bool MASKED>
__device__ __forceinline__ void sweep_shallow(GRM_PARAMS) {
  constexpr int GC = kPassGroups;  // groups a pass
  constexpr int kSlots = GC * kGroupFits;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_steps = depth_steps(n_words);
  const int n_chunks = depth_chunks(n_words);
  const int grp_lo = blockIdx.y * groups_per_row;
  const int ng = min(groups_per_row,
                     (n_fits + kGroupFits - 1) / kGroupFits - grp_lo);
  uint4* s_b = reinterpret_cast<uint4*>(smem_raw);
  float4* s_fit = reinterpret_cast<float4*>(
      s_b + (size_t)groups_per_row * n_chunks * bmma::kLanes);
  float* s_red = reinterpret_cast<float*>(s_fit + groups_per_row * kGroupFits);

  // tiles[grp][step][lane] -> word step % 4 of s_b[grp][step / 4][lane],
  // zero on the steps that pad the last chunk.
  uint32_t* s_bw = reinterpret_cast<uint32_t*>(s_b);
  const int padded_steps = n_chunks * kChunkSteps;
  for (int i = threadIdx.x; i < ng * padded_steps * bmma::kLanes;
       i += kThreads) {
    const int ln = i % bmma::kLanes;
    const int step = (i / bmma::kLanes) % padded_steps;
    const int grp = i / (bmma::kLanes * padded_steps);
    s_bw[(((size_t)grp * n_chunks + step / kChunkSteps) * bmma::kLanes + ln) *
             kChunkSteps +
         step % kChunkSteps] =
        step < n_steps
            ? tiles[((size_t)(grp_lo + grp) * n_steps + step) * bmma::kLanes +
                    ln]
            : 0u;
  }
  for (int m = threadIdx.x; m < ng * kGroupFits; m += kThreads) {
    const int fit = grp_lo * kGroupFits + m;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (fit < n_fits) {
      const int nn = n_neg[fit];
      const int np = n_pos[fit];
      c = make_float4(ps[fit], __int_as_float(nn + np), (float)nn, (float)np);
    }
    s_fit[m] = c;
  }
  __syncthreads();

  const long long col_lo = (long long)blockIdx.x * block_cols;
  const long long col_hi =
      min(col_lo + (long long)block_cols, min(limit, n_cols));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = bmma::frag_index(lane);  // matrix columns g and g + 8
  const int t = bmma::frag_word(lane);   // word of a step; fit of a group

  for (int g0 = 0; g0 < ng; g0 += GC) {
    const int gp = min(GC, ng - g0);  // groups of this pass
    float best_a[GC];
    float best_b[GC];
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      best_a[j] = EPI == kArgmax ? FLT_MAX : -INFINITY;
      best_b[j] = -FLT_MAX;
    }
    const uint4* b_pass = s_b + (size_t)g0 * n_chunks * bmma::kLanes + lane;
    const float4* fit_pass = s_fit + g0 * kGroupFits + t;
    constexpr int kRunStride = kWarps * kWideCols;
    uint32_t ex_next[4] = {0u, 0u, 0u, 0u};
    if (MASKED)
      load_excl(ex_next, excl, n_cols, col_lo + warp * kWideCols, col_hi,
                lane);
    for (long long c0 = col_lo + warp * kWideCols; c0 < col_hi;
         c0 += kRunStride) {
      const uint32_t ex[4] = {ex_next[0], ex_next[1], ex_next[2], ex_next[3]};
      if (MASKED)
        load_excl(ex_next, excl, n_cols, c0 + kRunStride, col_hi, lane);
      uint32_t sub = 0;
      int sub_off = 0;
      if (c0 + kWideCols <= col_hi &&
          (!MASKED || wide_run(ex, g, sub, sub_off))) {
        if (n_steps <= 3)
          sweep_wide<EPI, GC, 3>(best_a, best_b, matrix, n_words, n_cols,
                                 c0 + g, b_pass, fit_pass, gp, t, sub,
                                 sub_off);
        else
          sweep_wide<EPI, GC, 4>(best_a, best_b, matrix, n_words, n_cols,
                                 c0 + g, b_pass, fit_pass, gp, t, sub,
                                 sub_off);
      } else {
#pragma unroll 1
        for (int u = 0; u < kWideTiles; ++u)
          sweep_tile<EPI, GC>(best_a, best_b, matrix, n_words, n_cols,
                              n_steps, n_chunks, c0 + u * kWarpCols + g,
                              col_hi, excl, b_pass, fit_pass, gp, t);
      }
    }

    // Lanes with the same t hold the same fits: reduce over g, then over
    // the warps. min and max are exact, so the order does not matter.
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      float a = best_a[j];
      float b = best_b[j];
#pragma unroll
      for (int off = 16; off >= 4; off >>= 1) {
        const float oa = __shfl_xor_sync(0xffffffffu, a, off);
        a = EPI == kArgmax ? fminf(a, oa) : fmaxf(a, oa);
        if (EPI == kArgmax) b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, off));
      }
      if (g == 0) {
        s_red[warp * kSlots + j * kGroupFits + t] = a;
        s_red[(kWarps + warp) * kSlots + j * kGroupFits + t] = b;
      }
    }
    __syncthreads();
    const int slot = threadIdx.x;
    const int fit = (grp_lo + g0) * kGroupFits + slot;
    if (slot < gp * kGroupFits && fit < n_fits) {
      float a = s_red[slot];
      float b = s_red[kWarps * kSlots + slot];
      for (int wp = 1; wp < kWarps; ++wp) {
        const float oa = s_red[wp * kSlots + slot];
        a = EPI == kArgmax ? fminf(a, oa) : fmaxf(a, oa);
        b = fmaxf(b, s_red[(kWarps + wp) * kSlots + slot]);
      }
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

// The deep build's ring: mbarriers and cp.async, in PTX.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Returns once the phase of the given parity has completed (acquire).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One arrival (release): this thread's reads of the stage are done.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// One arrival once every cp.async this thread issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst,
                                          const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The deep build (past 512 genomes; the header's note). Block (x, y) takes
// column block x and the groups of grid row y. Warp kDeepWarps is the
// producer; consumer warp w takes the row's groups w + 8 i, i < 4.
template <int EPI, bool MASKED>
__device__ __forceinline__ void sweep_deep(GRM_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_steps = depth_steps(n_words);  // k128 steps
  const int n_s256 = deep_steps(n_words);
  const int n_chunks = (n_s256 + kStageSteps - 1) / kStageSteps;  // a tile
  const int n_stages = deep_stages(n_words, groups_per_row);
  const int blk = blockIdx.x;
  const int grp_lo = blockIdx.y * groups_per_row;
  const int ng = min(groups_per_row,
                     (n_fits + kGroupFits - 1) / kGroupFits - grp_lo);
  const int n_active = min(kDeepWarps, ng);  // consumer warps with groups
  uint2* s_b = reinterpret_cast<uint2*>(smem_raw);
  float4* s_fit = reinterpret_cast<float4*>(
      s_b + (size_t)groups_per_row * n_s256 * bmma::kLanes);
  uint32_t* s_ring =
      reinterpret_cast<uint32_t*>(s_fit + groups_per_row * kGroupFits);
  uint64_t* s_full = reinterpret_cast<uint64_t*>(
      s_ring + (size_t)n_stages * (kStageBytes / 4));
  uint64_t* s_empty = s_full + n_stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(s_full + s, bmma::kLanes);  // the producer's lanes
      mbar_init(s_empty + s, n_active * bmma::kLanes);  // the consumers'
    }
  }
  __syncthreads();

  const long long col_lo = (long long)blk * block_cols;
  const long long col_hi =
      min(col_lo + (long long)block_cols, min(limit, n_cols));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (warp == kDeepWarps) {
    // The producer: the stages of each column tile, the depth in order, each
    // word row's column c stored at c ^ 8 (w & 3) of its stage row. Rows of
    // whole 16-byte runs (K and the block a multiple of 4 columns) take
    // 16-byte copies, a lane 4 columns of one of two rows; others 4-byte
    // copies, a lane one column. Columns past col_hi and rows past n_words
    // are not read: their products are masked, or meet zero B.
    const bool vec = n_cols % 4 == 0 && block_cols % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(matrix) % 16 == 0;
    const int q = lane & 15;  // 16-byte copies: columns 4 q .. 4 q + 3
    const int r0 = lane >> 4;  // of rows r0, r0 + 2, ...
    int slot = 0;
    uint32_t phase = 0;
    for (long long c0 = col_lo; c0 < col_hi; c0 += kStageCols) {
      for (int d = 0; d < n_chunks; ++d) {
        mbar_wait(s_empty + slot, phase ^ 1u);
        uint32_t* stage = s_ring + (size_t)slot * (kStageBytes / 4);
        const int w0 = d * kStageWords;
        const int rows = min(kStageWords, n_words - w0);
        if (vec) {
          if (c0 + 4 * q < col_hi) {
            const uint32_t* src = matrix + (size_t)(w0 + r0) * n_cols + c0 + 4 * q;
#pragma unroll 4
            for (int r = r0; r < rows; r += 2)
              cp_async16(stage + r * kStageCols + ((4 * q) ^ (8 * (r & 3))),
                         src + (size_t)(r - r0) * n_cols);
          }
        } else {
#pragma unroll
          for (int h = 0; h < kStageCols / 32; ++h) {
            const long long c = c0 + h * 32 + lane;
            if (c < col_hi) {
              const uint32_t* src = matrix + (size_t)w0 * n_cols + c;
#pragma unroll 4
              for (int r = 0; r < rows; ++r)
                cp_async4(stage + r * kStageCols + ((h * 32 + lane) ^ (8 * (r & 3))),
                          src + (size_t)r * n_cols);
            }
          }
        }
        cp_async_arrive(s_full + slot);
        if (++slot == n_stages) {
          slot = 0;
          phase ^= 1u;
        }
      }
    }
    cp_async_wait_all();
    return;
  }
  // The consumer warps copy the B fragments and the fits' constants while
  // the producer fills the ring; then they wait for each other alone.
  // tiles[grp][step][lane] -> word step % 2 of s_b[grp][step / 2][lane],
  // zero on the half step that pads an odd count.
  uint32_t* s_bw = reinterpret_cast<uint32_t*>(s_b);
#pragma unroll 4
  for (int i = threadIdx.x; i < ng * 2 * n_s256 * bmma::kLanes;
       i += kDeepWarps * 32) {
    const int ln = i % bmma::kLanes;
    const int step = (i / bmma::kLanes) % (2 * n_s256);
    const int grp = i / (bmma::kLanes * 2 * n_s256);
    s_bw[(((size_t)grp * n_s256 + step / 2) * bmma::kLanes + ln) * 2 +
         step % 2] =
        step < n_steps
            ? tiles[((size_t)(grp_lo + grp) * n_steps + step) * bmma::kLanes +
                    ln]
            : 0u;
  }
  for (int m = threadIdx.x; m < ng * kGroupFits; m += kDeepWarps * 32) {
    const int fit = grp_lo * kGroupFits + m;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (fit < n_fits) {
      const int nn = n_neg[fit];
      const int np = n_pos[fit];
      c = make_float4(ps[fit], __int_as_float(nn + np), (float)nn, (float)np);
    }
    s_fit[m] = c;
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(kDeepWarps * 32) : "memory");
  if (warp >= n_active) return;

  // A consumer: its gw groups; groups past gw repeat the last one's
  // products, so the chains have no branch, and are not taken.
  const int g = bmma::frag_index(lane);  // columns g and g + 8 of a tile
  const int t = bmma::frag_word(lane);   // word of a step; fit of a group
  const int gw = (ng - warp + kDeepWarps - 1) / kDeepWarps;
  const uint2* b_warp[kWarpGroups];
#pragma unroll
  for (int i = 0; i < kWarpGroups; ++i)
    b_warp[i] = s_b + (size_t)(warp + kDeepWarps * min(i, gw - 1)) * n_s256 *
                          bmma::kLanes +
                lane;
  float best_a[kWarpGroups];
  float best_b[kWarpGroups];
#pragma unroll
  for (int i = 0; i < kWarpGroups; ++i) {
    best_a[i] = EPI == kArgmax ? FLT_MAX : -INFINITY;
    best_b[i] = -FLT_MAX;
  }
  int slot = 0;
  uint32_t phase = 0;
  for (long long c0 = col_lo; c0 < col_hi; c0 += kStageCols) {
    // The tile's padding and exclusion flags, read before its products:
    // [tile][column g, g + 8].
    bool ex_p[kStageTiles][2];
    bool ex_a[kStageTiles][2];
#pragma unroll
    for (int u = 0; u < kStageTiles; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long k = c0 + u * kWarpCols + h * kHalf + g;
        const bool pad = k >= col_hi;
        ex_p[u][h] = pad || (MASKED && excl[k] != 0);
        ex_a[u][h] = pad || (MASKED && excl[n_cols + k] != 0);
      }
    }
    int acc[kStageTiles][kWarpGroups][4];
#pragma unroll
    for (int u = 0; u < kStageTiles; ++u)
#pragma unroll
      for (int i = 0; i < kWarpGroups; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][i][e] = kMagic;

    for (int d = 0; d < n_chunks; ++d) {
      mbar_wait(s_full + slot, phase);
      const uint32_t* stage = s_ring + (size_t)slot * (kStageBytes / 4);
      const int s0 = d * kStageSteps;
      const int ns = min(kStageSteps, n_s256 - s0);
      // k256 step s of the stage: rows 8 s + t and 8 s + 4 + t (words t
      // and 4 + t of the step), both stored at column ^ 8 t.
      auto step = [&](int s) {
        const uint32_t* r0 = stage + (8 * s + t) * kStageCols;
        const uint32_t* r1 = r0 + 4 * kStageCols;
        uint32_t a[kStageTiles][4];
#pragma unroll
        for (int u = 0; u < kStageTiles; ++u) {
          const int col = (u * kWarpCols + g) ^ (8 * t);
          a[u][0] = r0[col];
          a[u][1] = r0[col ^ kHalf];
          a[u][2] = r1[col];
          a[u][3] = r1[col ^ kHalf];
        }
        uint2 b[kWarpGroups];
#pragma unroll
        for (int i = 0; i < kWarpGroups; ++i)
          b[i] = b_warp[i][(size_t)(s0 + s) * bmma::kLanes];
#pragma unroll
        for (int i = 0; i < kWarpGroups; ++i)
#pragma unroll
          for (int u = 0; u < kStageTiles; ++u)
            bmma::mma_and_popc_k256(acc[u][i], a[u][0], a[u][1], a[u][2],
                                    a[u][3], b[i].x, b[i].y);
      };
      // A whole stage unrolled with no test, so that the compiler may load
      // a step's operands during the step before; a partial one in a loop.
      if (ns == kStageSteps) {
#pragma unroll
        for (int s = 0; s < kStageSteps; ++s) step(s);
      } else {
        for (int s = 0; s < ns; ++s) step(s);
      }
      mbar_arrive(s_empty + slot);
      if (++slot == n_stages) {
        slot = 0;
        phase ^= 1u;
      }
    }
#pragma unroll
    for (int i = 0; i < kWarpGroups; ++i) {
      if (i < gw) {
        const float4 fc = s_fit[(warp + kDeepWarps * i) * kGroupFits + t];
#pragma unroll
        for (int u = 0; u < kStageTiles; ++u) {
          take_column<EPI>(best_a[i], best_b[i], acc[u][i][0], acc[u][i][1],
                           fc, ex_p[u][0], ex_a[u][0]);
          take_column<EPI>(best_a[i], best_b[i], acc[u][i][2], acc[u][i][3],
                           fc, ex_p[u][1], ex_a[u][1]);
        }
      }
    }
  }

  // Lanes with the same t hold the same fit: reduce over g. min and max
  // are exact, so the order does not matter; each group has one warp.
#pragma unroll
  for (int i = 0; i < kWarpGroups; ++i) {
    if (i < gw) {
      float a = best_a[i];
      float b = best_b[i];
#pragma unroll
      for (int off = 16; off >= 4; off >>= 1) {
        const float oa = __shfl_xor_sync(0xffffffffu, a, off);
        a = EPI == kArgmax ? fminf(a, oa) : fmaxf(a, oa);
        if (EPI == kArgmax) b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, off));
      }
      const int fit = (grp_lo + warp + kDeepWarps * i) * kGroupFits + t;
      if (g == 0 && fit < n_fits) {
        if (EPI == kArgmax) {
          out_a[(size_t)blk * n_fits + fit] = a;
          out_b[(size_t)blk * n_fits + fit] = b;
        } else {
          out_a[(size_t)fit * n_blocks + blk] = a;
        }
      }
    }
  }
}

// DEEP: whether the depth passes one chunk of 4 steps (512 genomes).
// MASKED: whether the launch has an exclusion mask.
template <int EPI, bool DEEP, bool MASKED>
__global__ void __launch_bounds__(DEEP ? kDeepThreads : kThreads,
                                  DEEP ? 1 : kBlocksPerSM)
    scm_sweep_kernel(GRM_PARAMS) {
  if constexpr (DEEP)
    sweep_deep<EPI, MASKED>(GRM_PARAM_NAMES);
  else
    sweep_shallow<EPI, MASKED>(GRM_PARAM_NAMES);
}

template <int EPI, bool DEEP, bool MASKED>
int launch(const void* matrix, int n_words, long long n_cols, long long limit,
           const void* tiles, const void* n_neg, const void* n_pos,
           const void* ps, int n_fits, int groups_per_row, const void* excl,
           int block_cols, void* out_a, void* out_b, void* stream) {
  if (DEEP && (groups_per_row < 1 || groups_per_row > kDeepGroups ||
               deep_stages(n_words, groups_per_row) < kMinStages))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_words, groups_per_row);
  const int n_blocks = (int)((n_cols + block_cols - 1) / block_cols);
  const int fits_per_row = groups_per_row * kGroupFits;
  const dim3 grid(n_blocks, (n_fits + fits_per_row - 1) / fits_per_row);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scm_sweep_kernel<EPI, DEEP, MASKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scm_sweep_kernel<EPI, DEEP, MASKED>
      <<<grid, DEEP ? kDeepThreads : kThreads, smem,
         (cudaStream_t)stream>>>(
      (const uint32_t*)matrix, n_words, n_cols, limit, (const uint32_t*)tiles,
      (const int32_t*)n_neg, (const int32_t*)n_pos, (const float*)ps, n_fits,
      groups_per_row, (const uint8_t*)excl, block_cols, n_blocks,
      (float*)out_a, (float*)out_b);
  return (int)cudaGetLastError();
}

}  // namespace

// epilogue 0 = kArgmax: out_a = block minima (n_blocks, n_fits), out_b =
// block maxima (n_blocks, n_fits). epilogue 1 = kSuperblockMax: out_a =
// (n_fits, n_blocks), out_b unused. n_blocks = ceil(n_cols / block_cols).
// tiles (groups, steps, 32) words: the neg and pos masks in the fragment
// order of bmma_tile.cuh, groups = ceil(n_fits / 4), steps = ceil(n_words /
// 4); word [grp][s][4 * (2 * j + e) + t] is word 4 * s + t of fit 4 * grp +
// j's neg (e = 0) or pos (e = 1) mask, 0 past the real fits and words.
// n_neg, n_pos (n_fits,) int32; ps (n_fits,) float32; excl (2, n_cols)
// bytes (row 0 presence, row 1 absence) or null. Grid row y takes groups
// [y * groups_per_row, (y + 1) * groups_per_row). Up to 16 words a pass
// keeps 32 groups in registers. Past 16 words a block keeps groups_per_row
// groups (at most 32, 4 a consumer warp) with their B fragments in shared
// memory for the whole launch and streams its columns through its ring
// once. Counts must stay below 2^23
// (n_words < 2^18), and n_blocks > 0, n_fits > 0 are the caller's to
// check.
extern "C" int grm_scm_sweep(int epilogue, const void* matrix, int n_words,
                             long long n_cols, long long limit,
                             const void* tiles, const void* n_neg,
                             const void* n_pos, const void* ps, int n_fits,
                             int groups_per_row, const void* excl,
                             int block_cols, void* out_a, void* out_b,
                             void* stream) {
#define GRM_ARGS                                                             \
  matrix, n_words, n_cols, limit, tiles, n_neg, n_pos, ps, n_fits,           \
      groups_per_row, excl, block_cols, out_a, out_b, stream
  if (epilogue != kArgmax && epilogue != kSuperblockMax)
    return (int)cudaErrorInvalidValue;
  // Past 512 genomes (more than one chunk of 4 steps): the deep build.
  if (depth_chunks(n_words) > 1) {
    if (excl != nullptr)
      return epilogue == kArgmax ? launch<kArgmax, true, true>(GRM_ARGS)
                                 : launch<kSuperblockMax, true, true>(GRM_ARGS);
    return epilogue == kArgmax ? launch<kArgmax, true, false>(GRM_ARGS)
                               : launch<kSuperblockMax, true, false>(GRM_ARGS);
  }
  if (excl != nullptr)
    return epilogue == kArgmax ? launch<kArgmax, false, true>(GRM_ARGS)
                               : launch<kSuperblockMax, false, true>(GRM_ARGS);
  return epilogue == kArgmax ? launch<kArgmax, false, false>(GRM_ARGS)
                             : launch<kSuperblockMax, false, false>(GRM_ARGS);
#undef GRM_ARGS
}

extern "C" long long grm_scm_sweep_smem_bytes(int n_words,
                                              int groups_per_row) {
  return (long long)smem_bytes(n_words, groups_per_row);
}
