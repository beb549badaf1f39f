// Stable hybrid radix sort and stable multiway merge of the device ingest's
// sort keys, for Hopper (sm_90a).
//
// Replaces grm_tpu/ops/kmer.py:110 _lex_sort, the stable lax.sort over
// [invalid, words...] (XLA, no pallas_call) that orders a batch's canonical
// windows (grm_tpu/parallel/device_build.py:88) and one genome's windows
// (_sort_unique_device, grm_tpu/ops/kmer.py:177): radix_sort. And the same
// sort of the union merge's rows (_merge_ranks, device_build.py:158, sort at
// :182), whose batches arrive sorted: merge_keys.
//
// What radix_sort computes: the stable sort of n rows by [invalid, key
// planes...] (grm_tpu_torch/ops/kmer.py sort_keys). Keys are P planes of n
// int64, most significant first, each a pair of k-mer words ((hi << 32) |
// lo) ^ 2^63, 2^63 - 1 in every plane of an invalid row. A row is invalid
// where `valid` is 0, or, with no `valid` and one plane, where its key is
// 2^63 - 1; with no `valid` and more planes every row counts as valid.
// Outputs: the sorted keys (P, n) int64, each sorted row's input position
// (n,) int64 and, where `valid` is given, the sorted validity (n,) uint8.
// Ties keep input order, so the output is unique and equals the plain
// version exactly.
//
// The rows sort as one composite of 64 P + 1 bits: bit 64 P is the row's
// invalid flag, bits [64 (P - 1 - p), 64 (P - p)) plane p's key ^ 2^63 (its
// unsigned order). Digits of kDigitBits bits are aligned from the top: digit
// j of n_digits(P) covers composite bits [digit_lo(P, j), digit_hi(P, j)),
// the top digit the top bits with the invalid flag, digit 0 what is left
// below (narrower).
//
// What bounds it on the H100: device memory. The function must read each key
// once and write each sorted key and position once (24 bytes a row at P = 1:
// 1.01 ms at 3.35 TB/s for a batch of 140.9M windows). An LSD radix sort
// moves every row once a digit (8 times at k = 31). This design moves a row
// about three times (Stehle & Jacobsen, SIGMOD 2017):
//
// 1. Level 1, over all rows. The count kernel reads the keys once: each
//    chunk's histogram of the top digit (kChunkTiles tiles of the scatter;
//    a count block takes a range of consecutive chunks and keeps each
//    chunk's counts as the range's counts before it, the range's sums
//    apart), and each group's (valid, invalid) OR of the key bits and of
//    their complements. The scan kernel makes the plan (a digit below the
//    top that is uniform over the valid rows and over the invalid rows is
//    dead: its bits cannot change the order; at k = 31 8 digits are live,
//    at k = 21 6, at k = 33 9), then each range's first output row of every
//    digit (an exclusive scan over the ranges, digit-major). The scatter
//    kernel moves each chunk's rows tile by tile to their buckets, stably:
//    a warp loads 32 consecutive rows a step, the lanes of one digit find
//    each other by an atomicOr into a mask a (warp, digit), one exclusive
//    scan of the warps' counters gives each row its slot in the tile's
//    sorted order, and the tile is written slot by slot from shared memory
//    so that a digit's rows of a tile are stored together. Its rows go to buffer A as the key planes ^ 2^63 and a 32-bit
//    payload: the row's input position with the invalid flag in its top bit
//    (so n < 2^31).
// 2. Level L > 1, segmented: each bucket of level L - 1 larger than the
//    local sort's capacity (local_rows(P)) is counted, scanned and scattered
//    the same way by the next live digit, from one buffer to the other. A
//    bucket takes as many chunks as its rows need; each chunk knows its
//    bucket. Buckets that stay too large go one level further; where no
//    live digit is left their rows are equal and already in input order.
//    The host launches every level a composite can have (n_digits(P)); a
//    level with no bucket exits at once.
// 3. The local sort. The scan of each level walks its sub-buckets in order
//    and packs consecutive ones that fit into jobs of at most local_rows(P)
//    rows ("bucket merging"). A job of one sub-bucket sorts by the live
//    digits below the level's; a packed job also by the level's own digit.
//    One block a job loads its keys into shared memory once, sorts them by
//    stable LSD passes over an index (the same warp match and counters,
//    kLocalWarps warps), and writes the final keys, int64 positions and
//    validity once, the payloads read again from the buffer. A job with no
//    digit left is copied as it is.
//
// Bytes a row at P = 1 (k = 31): 8 (level 1 count) + 20 (level 1 scatter:
// key read, key and payload written) + 8 (level 2 count) + 24 (level 2
// scatter) + 28 (local sort: key and payload read, key and position
// written) = 88, against 200 for an 8-bit LSD radix sort over the same
// live digits: 3.70 ms at 3.35 TB/s for a batch.
//
// What merge_keys computes: the same stable sort of rows that come as S
// segments of consecutive rows, segment s holding rows [seg_start[s],
// seg_start[s + 1]) of which the first v_s = min(seg_count[s], its rows)
// are valid and sorted and the rest invalid (2^63 - 1 in every plane),
// seg_count being a device tensor (the batches' k-mer counts: no fetch).
// Output: the valid rows merged (ties in segment order, then input order),
// then every invalid row in input order; validity always written. It must
// read each valid key once and write every output row once (1.1 ms for
// ingest-device's merge). Design (merge path: Green, McColl & Bader, ICS
// 2012):
//
// 1. One block: each segment's first row and first valid row among the
//    valid rows (exclusive scan of the clipped counts).
// 2. Output tiles of merge_tile(P) valid rows. For each tile edge o, one
//    warp finds each segment's co-rank (its rows among the first o) by
//    bisection on the composite value: bit by bit from the top bit where the
//    smallest and largest valid key differ, each lane binary-searches its
//    segments' windows for the candidate and the warp sums the counts. The
//    windows shrink with every bit; at the end they hold the rows equal to
//    the o-th key, and the rest of o is taken from them in segment order.
//    The blocks past the edges write the invalid rows (KEY_INVALID, their
//    input position, validity 0) after the valid ones in input order; they
//    run beside the latency-bound searches.
// 3. One block a tile: each segment's share of the tile is loaded into
//    shared memory once, segment after segment; ceil(log2 S) rounds of
//    stable pairwise merges in shared memory (each thread finds its first
//    output's co-rank in its pair by merge path, then merges sequentially),
//    then the tile is written once.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kMaxPlanes = 4;
constexpr int kMaxDigits = (64 * kMaxPlanes + 1 + kDigitBits - 1) / kDigitBits;
constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kScatterBlocks = 3;  // a scatter's blocks an SM
constexpr int kChunkTiles = 4;     // scatter tiles a chunk
constexpr int kCountThreads = 512;
constexpr int kCountCopies = 4;    // histogram copies of a count block
constexpr int kScanThreads = 1024; // 4 threads a digit
constexpr int kLocalThreads = 1024;
constexpr int kLocalWarps = kLocalThreads / 32;
constexpr int kLocalBlocks = 1;    // a local sort's blocks an SM
constexpr int kCntStride = kBins + 2;  // u16 a warp's counters (padded)
constexpr int kMaxSegments = 1024;
constexpr int kCorankThreads = 128;
constexpr int kCorankWarps = kCorankThreads / 32;
constexpr int kTailRows = 8;       // invalid rows a tail thread writes
constexpr int kMergeThreads = 512;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kInvalidBit = 0x80000000u;  // payload: the invalid flag
constexpr long long kInvalidKey = LLONG_MAX;
constexpr unsigned long long kSign = 0x8000000000000000ull;
static_assert(kBins == kScatterThreads, "one scatter thread a digit");
static_assert(kBins * 4 == kScanThreads, "four scan threads a digit");
static_assert(kLocalThreads % kBins == 0 &&
                  kLocalWarps % (kLocalThreads / kBins) == 0,
              "whole local threads a digit in the counters' scan");

// Rows a scatter thread takes a tile, by key planes: a tile is
// kScatterThreads * R rows, a chunk kChunkTiles tiles.
__host__ __device__ constexpr int scatter_rows(int P) {
  return P == 1 ? 16 : (P == 2 ? 8 : 4);
}
__host__ __device__ constexpr int tile_rows(int P) {
  return kScatterThreads * scatter_rows(P);
}
__host__ __device__ constexpr int chunk_rows(int P) {
  return kChunkTiles * tile_rows(P);
}
// Rows a local-sort thread takes a pass: the local capacity is
// kLocalThreads * local_steps(P) rows (8 P + 4 bytes of shared memory each).
__host__ __device__ constexpr int local_steps(int P) {
  return P == 1 ? 12 : (P == 2 ? 8 : (P == 3 ? 6 : 4));
}
__host__ __device__ constexpr int local_rows(int P) {
  return kLocalThreads * local_steps(P);
}
// Valid rows a merge tile takes (two copies of 8 P + 4 bytes a row).
__host__ __device__ constexpr int merge_tile(int P) {
  return P == 1 ? 4096 : (P == 4 ? 1024 : 2048);
}

// The digits of P planes, and digit j's composite bits [lo, hi).
__host__ __device__ constexpr int n_digits(int P) {
  return (64 * P + 1 + kDigitBits - 1) / kDigitBits;
}
__host__ __device__ constexpr int digit_hi(int P, int j) {
  return 64 * P + 1 - kDigitBits * (n_digits(P) - 1 - j);
}
__host__ __device__ constexpr int digit_lo(int P, int j) {
  return digit_hi(P, j) - kDigitBits > 0 ? digit_hi(P, j) - kDigitBits : 0;
}

struct Bucket {     // rows [start, start + size), chunks from chunk0
  uint32_t start, size, chunk0, pad;
};
struct Job {        // rows [start, start + size) of buffer buf, sorted by
  uint32_t start, size;  // the live digits up to jtop (none: -1)
  int32_t jtop, buf;
};
// The zeroed scratch: each group's (valid, invalid) OR of the key bits and
// of their complements; the plan (each digit live or not, each level's
// digit or -1); per level its buckets, chunks and the count and scatter
// blocks' chunk counters; the jobs and the local blocks' job counter.
struct Plan {
  unsigned long long bits[2][2][kMaxPlanes];
  int32_t live[kMaxDigits];
  int32_t level_digit[kMaxDigits + 2];
  uint32_t n_buckets[kMaxDigits + 2];
  uint32_t n_chunks[kMaxDigits + 2];
  uint32_t count_ctr[kMaxDigits + 2];
  uint32_t scatter_ctr[kMaxDigits + 2];
  uint32_t n_jobs, job_ctr;
};

struct SortArgs {
  const long long* keys;      // (P, n) input
  const uint8_t* valid;       // (n,) or null
  long long n;                // rows
  int keyed;                  // validity from plane 0 == 2^63 - 1
  long long* out_keys;        // (P, n)
  long long* out_perm;        // (n,)
  uint8_t* out_valid;         // (n,) or null
  unsigned long long* buf_keys[2];  // (P, n) key ^ 2^63, buffers A and B
  uint32_t* buf_pay[2];             // (n,) payloads
  uint32_t* counts;           // (max chunks, kBins): counts, then offsets
  uint32_t* ranges;           // level 1: (ranges, kBins) sums, then offsets
  int range_chunks;           // level 1: chunks a count block takes
  Bucket* buckets[2];         // a level's buckets, by its parity
  uint32_t* chunk_bucket[2];  // each chunk's bucket, by the level's parity
  Job* jobs;
  Plan* plan;
};

// 32-bit word i of a row's composite: word 2 (P - 1 - p) is plane p's low
// half (u = key ^ 2^63), word 2 (P - 1 - p) + 1 its high half, word 2 P
// the invalid flag, 0 past it.
template <int P>
__device__ __forceinline__ uint32_t word32(const unsigned long long (&u)[P],
                                           uint32_t inv, int i) {
  uint32_t v = i == 2 * P ? inv : 0u;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (i == 2 * (P - 1 - p)) v = (uint32_t)u[p];
    if (i == 2 * (P - 1 - p) + 1) v = (uint32_t)(u[p] >> 32);
  }
  return v;
}

// Composite bits [lo, lo + w) of a row: one funnel shift of the two 32-bit
// words that hold them.
template <int P>
__device__ __forceinline__ uint32_t digit_of(const unsigned long long (&u)[P],
                                             uint32_t inv, int lo, int w) {
  const int i = lo >> 5;
  return __funnelshift_r(word32<P>(u, inv, i), word32<P>(u, inv, i + 1),
                         lo & 31) & ((1u << w) - 1u);
}

// The lanes of the warp whose digit equals this lane's (none for a lane past
// the rows): each lane ORs its bit into its digit's mask (this warp's kBins
// words in shared memory, zero before and after), reads it back, and the
// peers clear it (CUB's atomic-OR warp match; one ballot a digit bit made a
// batch sort 23% slower on the H100, scripts/time_sort_variants.py).
__device__ __forceinline__ uint32_t warp_peers(uint32_t* masks, bool ok,
                                               uint32_t d, int lane) {
  if (ok) atomicOr(masks + d, 1u << lane);
  __syncwarp();
  const uint32_t peers = ok ? masks[d] : 0u;
  __syncwarp();
  if (ok) masks[d] = 0;
  __syncwarp();
  return peers;
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Row i of the input: its key planes ^ 2^63 and invalid flag.
template <int P>
__device__ __forceinline__ void load_input(const SortArgs& a, long long i,
                                           unsigned long long (&u)[P],
                                           uint32_t* inv) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    u[p] = (unsigned long long)__ldg(a.keys + p * a.n + i) ^ kSign;
  }
  if (a.valid != nullptr) {
    *inv = __ldg(a.valid + i) == 0;
  } else {
    *inv = a.keyed && u[0] == ~0ull;
  }
}

// The rows [begin, end) of chunk c of level L.
template <int P>
__device__ __forceinline__ void chunk_rows_of(const SortArgs& a, int L,
                                              unsigned c, long long* begin,
                                              long long* end) {
  constexpr long long CH = chunk_rows(P);
  if (L == 1) {
    *begin = (long long)c * CH;
    *end = *begin + CH < a.n ? *begin + CH : a.n;
    return;
  }
  const Bucket b = a.buckets[L & 1][a.chunk_bucket[L & 1][c]];
  *begin = (long long)b.start + (long long)(c - b.chunk0) * CH;
  const long long stop = (long long)b.start + b.size;
  *end = *begin + CH < stop ? *begin + CH : stop;
}

__device__ __forceinline__ unsigned level_chunks(const SortArgs& a, int L,
                                                 long long ch) {
  return L == 1 ? (unsigned)((a.n + ch - 1) / ch) : a.plan->n_chunks[L];
}

// Each chunk's histogram of level L's digit; level 1 (the input) also each
// group's OR of the key bits and of their complements.
template <int P, bool kInputSrc>
__global__ void __launch_bounds__(kCountThreads) sort_count_kernel(SortArgs a,
                                                                   int L) {
  constexpr int R = P == 1 ? 8 : (P == 2 ? 4 : 2);  // rows a thread a step
  __shared__ uint32_t s_hist[kCountCopies * kBins];
  __shared__ unsigned s_chunk;
  const unsigned n_chunks = level_chunks(a, L, chunk_rows(P));
  if (blockIdx.x >= n_chunks) return;  // the others take every chunk
  const int jd = kInputSrc ? n_digits(P) - 1 : a.plan->level_digit[L];
  const int lo = digit_lo(P, jd), w = digit_hi(P, jd) - lo;
  uint32_t* my_hist = s_hist + ((threadIdx.x >> 5) % kCountCopies) * kBins;
  unsigned long long bits[2][2][P];  // [invalid][OR, OR of complements][p]
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int p = 0; p < P; ++p) bits[g][0][p] = bits[g][1][p] = 0;
  }
  const int src = L & 1;
  // Level 1: block r takes chunks [r K, (r + 1) K) in order (K =
  // range_chunks), each chunk's counts stored as the range's counts before
  // it, the range's sums apart; later levels: chunks in any order.
  uint32_t before = 0;
  unsigned c = kInputSrc ? blockIdx.x * a.range_chunks : 0;
  const unsigned c_end =
      kInputSrc ? min(c + a.range_chunks, n_chunks) : n_chunks;
  for (;; ++c) {
    __syncthreads();
    if (!kInputSrc && threadIdx.x == 0) {
      s_chunk = atomicAdd(&a.plan->count_ctr[L], 1u);
    }
    for (int e = threadIdx.x; e < kCountCopies * kBins; e += kCountThreads) {
      s_hist[e] = 0;
    }
    __syncthreads();
    if (!kInputSrc) c = s_chunk;
    if (c >= c_end) break;
    long long begin, end;
    chunk_rows_of<P>(a, L, c, &begin, &end);
    for (long long i0 = begin + threadIdx.x; i0 < end;
         i0 += (long long)R * kCountThreads) {
      unsigned long long u[R][P];
      uint32_t inv[R];
#pragma unroll
      for (int e = 0; e < R; ++e) {
        const long long i = i0 + (long long)e * kCountThreads;
        inv[e] = 0;
        if (i < end) {
          if (kInputSrc) {
            load_input<P>(a, i, u[e], inv + e);
          } else {
            // Levels past the first never take the top digit: no flag.
#pragma unroll
            for (int p = 0; p < P; ++p) u[e][p] = a.buf_keys[src][p * a.n + i];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < R; ++e) {
        if (i0 + (long long)e * kCountThreads >= end) continue;
        atomicAdd(my_hist + digit_of<P>(u[e], inv[e], lo, w), 1u);
        if (kInputSrc) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (inv[e]) {
              bits[1][0][p] |= u[e][p];
              bits[1][1][p] |= ~u[e][p];
            } else {
              bits[0][0][p] |= u[e][p];
              bits[0][1][p] |= ~u[e][p];
            }
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < kBins) {
      uint32_t sum = 0;
#pragma unroll
      for (int h = 0; h < kCountCopies; ++h) sum += s_hist[h * kBins + threadIdx.x];
      a.counts[(long long)c * kBins + threadIdx.x] = kInputSrc ? before : sum;
      before += sum;
    }
  }
  if (kInputSrc) {
    if (threadIdx.x < kBins) {
      a.ranges[(long long)blockIdx.x * kBins + threadIdx.x] = before;
    }
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          unsigned long long v = bits[g][o][p];
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) v |= __shfl_xor_sync(kFull, v, d);
          if (lane == 0 && v) atomicOr(&a.plan->bits[g][o][p], v);
        }
      }
    }
  }
}

// The plan (one thread, after level 1's count): a digit is live unless it is
// uniform over the valid rows and over the invalid rows (no bit of it set in
// a group's OR and in its OR of complements); the top digit is always live
// (it holds the invalid flag). Level 1 takes the top digit, each next level
// the next live digit below, -1 past the last.
template <int P>
__device__ void make_plan(Plan* pl) {
  constexpr int nd = n_digits(P);
  for (int j = 0; j < nd; ++j) {
    bool live = j == nd - 1;
    for (int b = digit_lo(P, j); b < digit_hi(P, j) && b < 64 * P; ++b) {
      const int p = P - 1 - (b >> 6);
      const unsigned long long bit = 1ull << (b & 63);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (pl->bits[g][0][p] & pl->bits[g][1][p] & bit) live = true;
      }
    }
    pl->live[j] = live;
  }
  int j = nd - 1;
  pl->level_digit[0] = -1;
  pl->level_digit[1] = j;
  for (int L = 2; L < kMaxDigits + 2; ++L) {
    if (j >= 0) {
      do {
        --j;
      } while (j >= 0 && !pl->live[j]);
    }
    pl->level_digit[L] = j;
  }
}

// One block a bucket of level L: its digits' totals over its chunks, their
// exclusive scan into the sub-buckets' first rows, each chunk's counts
// turned into its first output row of each digit (4 threads a digit, each a
// quarter of the chunks), then the sub-buckets walked in order: those past
// the local capacity go to level L + 1 (or, with no digit left, to a copy
// job), consecutive others are packed into jobs.
template <int P>
__global__ void __launch_bounds__(kScanThreads) sort_scan_kernel(SortArgs a,
                                                                 int L) {
  constexpr uint32_t CH = chunk_rows(P);
  constexpr uint32_t C = local_rows(P);
  __shared__ uint32_t s_part[4][kBins];
  __shared__ uint32_t s_start[kBins + 1];
  __shared__ uint32_t s_warp[kBins / 32];
  Plan* pl = a.plan;
  if (L == 1) {
    if (blockIdx.x != 0) return;
    if (threadIdx.x == 0) {
      make_plan<P>(pl);
      a.buckets[1][0] = Bucket{0, (uint32_t)a.n, 0, 0};
      pl->n_buckets[1] = 1;
    }
    __syncthreads();
  }
  const unsigned nb = pl->n_buckets[L];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = threadIdx.x / kBins, d = threadIdx.x % kBins;
  // The units scanned: level 1's ranges of chunks (the count blocks'), a
  // later level's chunks of the bucket.
  uint32_t* units = L == 1 ? a.ranges : a.counts;
  for (unsigned b = blockIdx.x; b < nb; b += gridDim.x) {
    const Bucket bk = a.buckets[L & 1][b];
    const uint32_t nch = (bk.size + CH - 1) / CH;
    const uint32_t nu = L == 1 ? (nch + a.range_chunks - 1) / a.range_chunks
                               : nch;
    const uint32_t u0 = L == 1 ? 0 : bk.chunk0;
    const uint32_t c0 = u0 + (uint32_t)((unsigned long long)nu * q / 4);
    const uint32_t c1 = u0 + (uint32_t)((unsigned long long)nu * (q + 1) / 4);
    uint32_t sum = 0;
#pragma unroll 8
    for (uint32_t c = c0; c < c1; ++c) sum += units[(long long)c * kBins + d];
    s_part[q][d] = sum;
    __syncthreads();
    uint32_t total = 0, incl = 0;
    if (threadIdx.x < kBins) {  // warps 0 to 7: the digits' scan
      total = s_part[0][d] + s_part[1][d] + s_part[2][d] + s_part[3][d];
      incl = warp_inclusive(total, lane);
      if (lane == 31) s_warp[warp] = incl;
    }
    __syncthreads();
    if (threadIdx.x < kBins) {
      uint32_t before = incl - total;
      for (int v = 0; v < warp; ++v) before += s_warp[v];
      s_start[d] = bk.start + before;
      if (d == kBins - 1) s_start[kBins] = bk.start + bk.size;
    }
    __syncthreads();
    uint32_t run = s_start[d];
    for (int v = 0; v < q; ++v) run += s_part[v][d];
    for (uint32_t c = c0; c < c1; ++c) {
      const uint32_t x = units[(long long)c * kBins + d];
      units[(long long)c * kBins + d] = run;
      run += x;
    }
    if (threadIdx.x == 0) {
      const int jd = pl->level_digit[L];
      const int next = pl->level_digit[L + 1];
      const int buf = (L - 1) & 1;  // where level L writes its rows
      uint32_t run_start = 0, run_size = 0, run_n = 0;
      auto close_run = [&]() {
        if (run_n == 0) return;
        const uint32_t k = atomicAdd(&pl->n_jobs, 1u);
        a.jobs[k] = Job{run_start, run_size, run_n == 1 ? next : jd, buf};
        run_size = run_n = 0;
      };
      for (int v = 0; v < kBins; ++v) {
        const uint32_t sz = s_start[v + 1] - s_start[v];
        if (sz == 0) continue;
        if (sz > C) {
          close_run();
          if (next >= 0) {
            const uint32_t k = atomicAdd(&pl->n_buckets[L + 1], 1u);
            const uint32_t n_ch = (sz + CH - 1) / CH;
            const uint32_t ch0 = atomicAdd(&pl->n_chunks[L + 1], n_ch);
            a.buckets[(L + 1) & 1][k] = Bucket{s_start[v], sz, ch0, 0};
            for (uint32_t c = 0; c < n_ch; ++c) {
              a.chunk_bucket[(L + 1) & 1][ch0 + c] = k;
            }
          } else {  // equal rows, in input order
            const uint32_t k = atomicAdd(&pl->n_jobs, 1u);
            a.jobs[k] = Job{s_start[v], sz, -1, buf};
          }
          continue;
        }
        if (run_size + sz > C) close_run();
        if (run_n == 0) run_start = s_start[v];
        run_size += sz;
        ++run_n;
      }
      close_run();
    }
    __syncthreads();
  }
}

// Dynamic shared memory of a scatter, in bytes: the tile in input order
// (keys, payloads), each slot's input row (u16), the warps' counters (a
// padded row of kBins a warp, so that a warp's digits fall in distinct
// banks), the digits' tile offsets (u16, kBins + 1, padded), their next
// output rows in the chunk and this tile's (int each), the warps' masks.
__host__ __device__ constexpr int scatter_tile_bytes(int P) {
  return tile_rows(P) * (8 * P + 4 + 2);
}
__host__ __device__ constexpr int scatter_smem_bytes(int P) {
  return scatter_tile_bytes(P) + kScatterWarps * kCntStride * 2 +
         2 * (kBins + 8) + 2 * 4 * kBins + kScatterWarps * kBins * 4;
}

// Level L's scatter: each chunk's rows to their sub-buckets, tile by tile.
template <int P, bool kInputSrc>
__global__ void __launch_bounds__(kScatterThreads, kScatterBlocks)
    sort_scatter_kernel(SortArgs a, int L) {
  constexpr int R = scatter_rows(P);
  constexpr int T = tile_rows(P);
  extern __shared__ __align__(16) unsigned char s_raw[];
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(s_raw);
  uint32_t* s_pay = reinterpret_cast<uint32_t*>(s_raw + 8 * P * T);
  uint16_t* s_inv = reinterpret_cast<uint16_t*>(s_raw + (8 * P + 4) * T);
  uint16_t* s_cnt = reinterpret_cast<uint16_t*>(s_raw + scatter_tile_bytes(P));
  uint16_t* s_excl = s_cnt + kScatterWarps * kCntStride;
  int* s_base = reinterpret_cast<int*>(s_excl + kBins + 8);
  int* s_off = s_base + kBins;
  uint32_t* my_masks = reinterpret_cast<uint32_t*>(s_off + kBins) +
                       (threadIdx.x >> 5) * kBins;
  __shared__ unsigned s_chunk;
  __shared__ uint32_t s_warp[kScatterWarps];
  const unsigned n_chunks = level_chunks(a, L, chunk_rows(P));
  if (blockIdx.x >= n_chunks) return;  // the others take every chunk
  const int jd = kInputSrc ? n_digits(P) - 1 : a.plan->level_digit[L];
  const int lo = digit_lo(P, jd), w = digit_hi(P, jd) - lo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int src = L & 1, dst = (L - 1) & 1;
  for (int e = lane; e < kBins; e += 32) my_masks[e] = 0;
  unsigned long long* out_key = a.buf_keys[dst];
  uint32_t* out_pay = a.buf_pay[dst];
  for (;;) {
    __syncthreads();
    if (threadIdx.x == 0) s_chunk = atomicAdd(&a.plan->scatter_ctr[L], 1u);
    __syncthreads();
    const unsigned c = s_chunk;
    if (c >= n_chunks) break;
    long long begin, end;
    chunk_rows_of<P>(a, L, c, &begin, &end);
    s_base[threadIdx.x] =
        (int)a.counts[(long long)c * kBins + threadIdx.x] +
        (kInputSrc ? (int)a.ranges[(long long)(c / a.range_chunks) * kBins +
                                   threadIdx.x]
                   : 0);
    for (long long row0 = begin; row0 < end; row0 += T) {
      const int items = (int)(end - row0 < T ? end - row0 : T);
      for (int e = threadIdx.x; e < kScatterWarps * kCntStride / 2;
           e += kScatterThreads) {
        reinterpret_cast<uint32_t*>(s_cnt)[e] = 0;
      }

      // 1. Load: warp w's rows are the tile's [32 R w, 32 R (w + 1)), row
      // 32 r + lane at step r, all loads issued before any is used; each
      // row's digit taken, the tile stored in shared memory in input order.
      uint32_t dig[R];
      {
        unsigned long long u[R][P];
        uint32_t pay[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = warp * 32 * R + r * 32 + lane;
          if (i < items) {
            if (kInputSrc) {
              uint32_t inv;
              load_input<P>(a, row0 + i, u[r], &inv);
              pay[r] = (uint32_t)(row0 + i) | (inv ? kInvalidBit : 0u);
            } else {
#pragma unroll
              for (int p = 0; p < P; ++p) {
                u[r][p] = a.buf_keys[src][p * a.n + row0 + i];
              }
              pay[r] = a.buf_pay[src][row0 + i];
            }
          } else {
#pragma unroll
            for (int p = 0; p < P; ++p) u[r][p] = 0;
            pay[r] = 0;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = warp * 32 * R + r * 32 + lane;
          dig[r] = digit_of<P>(u[r], pay[r] >> 31, lo, w);
#pragma unroll
          for (int p = 0; p < P; ++p) s_key[p * T + i] = u[r][p];
          s_pay[i] = pay[r];
        }
      }
      __syncthreads();

      // 2. Stable ranks in the warp: per step, the lanes of one digit are
      // peers; the lowest adds their number to the warp's counter of it.
      const uint32_t lt = (1u << lane) - 1u;
      uint32_t rank[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool ok = warp * 32 * R + r * 32 + lane < items;
        const uint32_t peers = warp_peers(my_masks, ok, dig[r], lane);
        const int leader = __ffs(peers) - 1;
        uint32_t old = 0;
        if (ok && lane == leader) {
          uint16_t* cp = s_cnt + warp * kCntStride + dig[r];
          old = *cp;
          *cp = (uint16_t)(old + __popc(peers));
        }
        old = __shfl_sync(kFull, old, leader);
        rank[r] = old + __popc(peers & lt);
        __syncwarp();
      }
      __syncthreads();

      // 3. One exclusive scan of the counters, digit-major then warp: thread
      // d takes digit d's kScatterWarps counters. s_excl[d]: the tile's rows
      // before digit d.
      {
        uint32_t x[kScatterWarps], total = 0;
#pragma unroll
        for (int v = 0; v < kScatterWarps; ++v) {
          total += x[v] = s_cnt[v * kCntStride + threadIdx.x];
        }
        const uint32_t sum = warp_inclusive(total, lane);
        if (lane == 31) s_warp[warp] = sum;
        __syncthreads();
        uint32_t run = sum - total;
#pragma unroll
        for (int q = 0; q < kScatterWarps; ++q) run += q < warp ? s_warp[q] : 0u;
        s_excl[threadIdx.x] = (uint16_t)run;
#pragma unroll
        for (int v = 0; v < kScatterWarps; ++v) {
          s_cnt[v * kCntStride + threadIdx.x] = (uint16_t)run;
          run += x[v];
        }
        if (threadIdx.x == kScatterThreads - 1) s_excl[kBins] = (uint16_t)run;
      }
      __syncthreads();

      // 4. Each digit's output row for the tile's slot 0; each row's slot in
      // the tile's sorted order, the slot's input row into s_inv.
      s_off[threadIdx.x] = s_base[threadIdx.x] - (int)s_excl[threadIdx.x];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = warp * 32 * R + r * 32 + lane;
        if (i < items) s_inv[rank[r] + s_cnt[warp * kCntStride + dig[r]]] = i;
      }
      __syncthreads();

      // 5. The tile written out slot by slot, each slot's row read from the
      // input order.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = r * kScatterThreads + threadIdx.x;
        if (s >= items) continue;
        const int i = s_inv[s];
        unsigned long long k[P];
#pragma unroll
        for (int p = 0; p < P; ++p) k[p] = s_key[p * T + i];
        const uint32_t y = s_pay[i];
        const long long dest = s_off[digit_of<P>(k, y >> 31, lo, w)] + s;
#pragma unroll
        for (int p = 0; p < P; ++p) out_key[p * a.n + dest] = k[p];
        out_pay[dest] = y;
      }
      __syncthreads();
      s_base[threadIdx.x] +=
          (int)s_excl[threadIdx.x + 1] - (int)s_excl[threadIdx.x];
    }
  }
}

template <int P>
__device__ __forceinline__ void store_row(const SortArgs& a, long long o,
                                          const unsigned long long (&k)[P],
                                          uint32_t y) {
#pragma unroll
  for (int p = 0; p < P; ++p) a.out_keys[p * a.n + o] = (long long)(k[p] ^ kSign);
  a.out_perm[o] = (long long)(y & ~kInvalidBit);
  if (a.out_valid != nullptr) a.out_valid[o] = (y >> 31) ^ 1u;
}

__host__ __device__ constexpr int local_smem_bytes(int P) {
  return local_rows(P) * (8 * P + 4) + local_rows(P) / 8 +
         kLocalWarps * kCntStride * 2 + kLocalWarps * kBins * 4;
}

// The local sort: one job at a time a block (see the header). Positions of
// a pass are warp-major: warp w takes [32 re w, 32 re (w + 1)), position
// 32 r + lane at step r, re = ceil(rows / kLocalThreads), so that the ranks,
// the counters' scan (digit-major, then warp) and the slots keep the order.
// Shared memory holds the keys, the invalid flags (a bit a row, only where
// a pass takes the top digit), two index arrays and the counters; the
// payloads are read again from the buffer when the job is written.
template <int P>
__global__ void __launch_bounds__(kLocalThreads, kLocalBlocks)
    sort_local_kernel(SortArgs a) {
  constexpr int RM = local_steps(P);
  constexpr int C = local_rows(P);
  extern __shared__ __align__(16) unsigned char s_raw[];
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(s_raw);
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(s_raw + 8 * P * C);
  uint32_t* s_flag = reinterpret_cast<uint32_t*>(s_idx + 2 * C);  // [C / 32]
  uint16_t* s_cnt = reinterpret_cast<uint16_t*>(s_flag + C / 32);
  uint32_t* s_masks = reinterpret_cast<uint32_t*>(s_cnt + kLocalWarps * kCntStride);
  __shared__ unsigned s_job;
  __shared__ uint32_t s_warp[kLocalWarps];
  __shared__ int s_live[kMaxDigits];
  const unsigned n_jobs = a.plan->n_jobs;
  if (blockIdx.x >= n_jobs) return;
  for (int j = threadIdx.x; j < n_digits(P); j += kLocalThreads) {
    s_live[j] = a.plan->live[j];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* my_masks = s_masks + warp * kBins;
  for (int e = lane; e < kBins; e += 32) my_masks[e] = 0;
  for (;;) {
    __syncthreads();
    if (threadIdx.x == 0) s_job = atomicAdd(&a.plan->job_ctr, 1u);
    __syncthreads();
    if (s_job >= n_jobs) break;
    const Job job = a.jobs[s_job];
    const unsigned long long* bk = a.buf_keys[job.buf];
    const uint32_t* bp = a.buf_pay[job.buf];
    const int size = (int)job.size;
    int top = -1;  // the highest live digit to sort by
    for (int j = 0; j <= job.jtop; ++j) top = s_live[j] ? j : top;
    if (top < 0) {  // nothing to sort: copied (any size)
      for (long long s = threadIdx.x; s < job.size; s += kLocalThreads) {
        const long long i = (long long)job.start + s;
        unsigned long long k[P];
#pragma unroll
        for (int p = 0; p < P; ++p) k[p] = bk[p * a.n + i];
        store_row<P>(a, i, k, bp[i]);
      }
      continue;
    }
    const bool flags = digit_hi(P, top) == 64 * P + 1;  // the top digit
    for (int s = threadIdx.x; s < size; s += kLocalThreads) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        __pipeline_memcpy_async(s_key + p * C + s, bk + p * a.n + job.start + s,
                                8);
      }
      s_idx[s] = (uint16_t)s;
    }
    __pipeline_commit();
    if (flags) {  // rows s0 + lane of a warp: one ballot a word
      for (int s0 = warp * 32; s0 < size; s0 += kLocalThreads) {
        const int s = s0 + lane;
        const uint32_t bits =
            __ballot_sync(kFull, s < size && (bp[job.start + s] >> 31));
        if (lane == 0) s_flag[s0 >> 5] = bits;
      }
    }
    __pipeline_wait_prior(0);
    const int re = (size + kLocalThreads - 1) / kLocalThreads;
    int cur = 0;
    for (int j = 0; j <= top; ++j) {
      if (!s_live[j]) continue;
      const int lo = digit_lo(P, j), w = digit_hi(P, j) - lo;
      const bool with_flag = digit_hi(P, j) == 64 * P + 1;
      const uint16_t* from = s_idx + cur * C;
      uint16_t* to = s_idx + (cur ^ 1) * C;
      for (int e = threadIdx.x; e < kLocalWarps * kCntStride / 2;
           e += kLocalThreads) {
        reinterpret_cast<uint32_t*>(s_cnt)[e] = 0;
      }
      __syncthreads();
      uint32_t dig[RM], rank[RM], row[RM];
      uint32_t okm = 0;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        dig[r] = row[r] = 0;
        if (r < re) {
          const int pos = warp * 32 * re + r * 32 + lane;
          if (pos < size) {
            okm |= 1u << r;
            row[r] = from[pos];
            unsigned long long u[P];
#pragma unroll
            for (int p = 0; p < P; ++p) u[p] = s_key[p * C + row[r]];
            const uint32_t inv =
                with_flag ? (s_flag[row[r] >> 5] >> (row[r] & 31)) & 1u : 0u;
            dig[r] = digit_of<P>(u, inv, lo, w);
          }
        }
      }
      const uint32_t lt = (1u << lane) - 1u;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        rank[r] = 0;
        if (r < re) {
          const bool ok = (okm >> r) & 1u;
          const uint32_t peers = warp_peers(my_masks, ok, dig[r], lane);
          const int leader = __ffs(peers) - 1;
          uint32_t old = 0;
          if (ok && lane == leader) {
            uint16_t* cp = s_cnt + warp * kCntStride + dig[r];
            old = *cp;
            *cp = (uint16_t)(old + __popc(peers));
          }
          old = __shfl_sync(kFull, old, leader);
          rank[r] = old + __popc(peers & lt);
          __syncwarp();
        }
      }
      __syncthreads();
      {  // exclusive scan of the counters, digit-major then warp: thread
         // kT d + q takes digit d's counters of warps [kW q, kW (q + 1))
        constexpr int kT = kLocalThreads / kBins, kW = kLocalWarps / kT;
        uint16_t* cp = s_cnt + (threadIdx.x % kT) * kW * kCntStride +
                       threadIdx.x / kT;
        uint32_t x[kW], total = 0;
#pragma unroll
        for (int v = 0; v < kW; ++v) total += x[v] = cp[v * kCntStride];
        const uint32_t sum = warp_inclusive(total, lane);
        if (lane == 31) s_warp[warp] = sum;
        __syncthreads();
        if (warp == 0) {
          const uint32_t t = lane < kLocalWarps ? s_warp[lane] : 0u;
          const uint32_t e = warp_inclusive(t, lane) - t;
          if (lane < kLocalWarps) s_warp[lane] = e;
        }
        __syncthreads();
        uint32_t run = sum - total + s_warp[warp];
#pragma unroll
        for (int v = 0; v < kW; ++v) {
          cp[v * kCntStride] = (uint16_t)run;
          run += x[v];
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if ((okm >> r) & 1u) {
          to[s_cnt[warp * kCntStride + dig[r]] + rank[r]] = (uint16_t)row[r];
        }
      }
      __syncthreads();
      cur ^= 1;
    }
    // Written slot by slot, every payload read first.
    const uint16_t* fin = s_idx + cur * C;
    uint32_t pay[RM];
    uint32_t at[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int s = threadIdx.x + r * kLocalThreads;
      at[r] = pay[r] = 0;
      if (s < size) {
        at[r] = fin[s];
        pay[r] = bp[job.start + at[r]];
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int s = threadIdx.x + r * kLocalThreads;
      if (s < size) {
        unsigned long long k[P];
#pragma unroll
        for (int p = 0; p < P; ++p) k[p] = s_key[p * C + at[r]];
        store_row<P>(a, (long long)job.start + s, k, pay[r]);
      }
    }
  }
}

// -- the merge -----------------------------------------------------------

struct MergeArgs {
  const long long* keys;       // (P, n)
  long long n;
  int n_seg;
  const long long* seg_start;  // (S + 1,)
  const int32_t* seg_count;    // (S,)
  long long* out_keys;         // (P, n)
  long long* out_perm;         // (n,)
  uint8_t* out_valid;          // (n,)
  uint32_t* pstart;            // (S + 1,): each segment's first row
  uint32_t* vstart;            // (S + 1,): its first valid row among the
                               // valid rows; [S]: the valid rows
  uint32_t* corank;            // (n_edges, S)
  long long n_edges;           // tile edges: ceil(n / merge_tile(P)) + 1
};

// The segment table (one block of kMaxSegments threads).
__global__ void __launch_bounds__(kMaxSegments) merge_setup_kernel(
    MergeArgs a) {
  __shared__ uint32_t s_warp[kMaxSegments / 32];
  const int s = threadIdx.x, S = a.n_seg;
  const int lane = s & 31, warp = s >> 5;
  uint32_t v = 0;
  if (s < S) {
    const long long rows = a.seg_start[s + 1] - a.seg_start[s];
    const long long got = a.seg_count[s];
    v = (uint32_t)(got < 0 ? 0 : (got < rows ? got : rows));
    a.pstart[s] = (uint32_t)a.seg_start[s];
  }
  const uint32_t incl = warp_inclusive(v, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  uint32_t before = incl - v;
  for (int q = 0; q < warp; ++q) before += s_warp[q];
  if (s < S) a.vstart[s] = before;
  if (s == S - 1) {
    a.vstart[S] = before + v;
    a.pstart[S] = (uint32_t)a.seg_start[S];
  }
}

// The last s in [0, S) with start[s] <= i.
__device__ __forceinline__ int segment_of(const uint32_t* start, int S,
                                          uint32_t i) {
  int lo = 0, hi = S - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

template <int P>
__device__ __forceinline__ bool key_less(const unsigned long long (&x)[P],
                                         const unsigned long long (&y)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (x[p] != y[p]) return x[p] < y[p];
  }
  return false;
}

template <int P>
__device__ __forceinline__ void merge_key(const MergeArgs& a, uint32_t row,
                                          unsigned long long (&k)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    k[p] = (unsigned long long)__ldg(a.keys + p * a.n + row) ^ kSign;
  }
}

// The first index in [lo, hi) of segment s's valid rows whose key is not
// below y, or hi.
template <int P>
__device__ __forceinline__ uint32_t seg_lower_bound(const MergeArgs& a,
                                                uint32_t row0, uint32_t lo,
                                                uint32_t hi,
                                                const unsigned long long (&y)[P]) {
  while (lo < hi) {
    const uint32_t mid = (lo + hi) >> 1;
    unsigned long long k[P];
    merge_key<P>(a, row0 + mid, k);
    if (key_less<P>(k, y)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Blocks [0, n_corank): a warp a tile edge, each segment's co-rank (see the
// header); blocks past them: the invalid rows, kTailRows a thread.
template <int P>
__global__ void __launch_bounds__(kCorankThreads) merge_corank_kernel(
    MergeArgs a, int n_corank) {
  constexpr int TM = merge_tile(P);
  extern __shared__ uint32_t s_mem[];
  const int S = a.n_seg;
  uint32_t* s_pstart = s_mem;
  uint32_t* s_vstart = s_pstart + S + 1;
  for (int s = threadIdx.x; s <= S; s += kCorankThreads) {
    s_pstart[s] = a.pstart[s];
    s_vstart[s] = a.vstart[s];
  }
  __syncthreads();
  const uint32_t V = s_vstart[S];
  if ((int)blockIdx.x >= n_corank) {
    const long long base =
        (long long)(blockIdx.x - n_corank) * kCorankThreads * kTailRows;
#pragma unroll
    for (int e = 0; e < kTailRows; ++e) {
      const long long r = base + (long long)e * kCorankThreads + threadIdx.x;
      if (r >= a.n) break;
      const int s = segment_of(s_pstart, S, (uint32_t)r);
      const uint32_t v = s_vstart[s + 1] - s_vstart[s];
      if ((uint32_t)r - s_pstart[s] < v) continue;
      const long long o = (long long)V + r - s_vstart[s] - v;
#pragma unroll
      for (int p = 0; p < P; ++p) a.out_keys[p * a.n + o] = kInvalidKey;
      a.out_perm[o] = r;
      a.out_valid[o] = 0;
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long edge = (long long)blockIdx.x * kCorankWarps + warp;
  if (edge >= a.n_edges) return;
  uint32_t* out = a.corank + edge * S;
  const long long o64 = edge * TM;
  const uint32_t o = (uint32_t)(o64 < V ? o64 : V);
  if (o == 0 || o == V) {
    for (int s = lane; s < S; s += 32) {
      out[s] = o == 0 ? 0 : s_vstart[s + 1] - s_vstart[s];
    }
    return;
  }
  uint32_t* lo = s_vstart + S + 1 + warp * 3 * S;  // each segment's window
  uint32_t* hi = lo + S;
  uint32_t* mid = hi + S;
  // The smallest and the largest valid key: bits above the first that
  // differs are the o-th key's too.
  unsigned long long kmin[P], kmax[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    kmin[p] = ~0ull;
    kmax[p] = 0;
  }
  for (int s = lane; s < S; s += 32) {
    const uint32_t v = s_vstart[s + 1] - s_vstart[s];
    lo[s] = 0;
    hi[s] = v;
    if (v == 0) continue;
    unsigned long long k[P];
    merge_key<P>(a, s_pstart[s], k);
    if (key_less<P>(k, kmin)) {
#pragma unroll
      for (int p = 0; p < P; ++p) kmin[p] = k[p];
    }
    merge_key<P>(a, s_pstart[s] + v - 1, k);
    if (key_less<P>(kmax, k)) {
#pragma unroll
      for (int p = 0; p < P; ++p) kmax[p] = k[p];
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    unsigned long long k[P], m[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      k[p] = __shfl_xor_sync(kFull, kmin[p], d);
      m[p] = __shfl_xor_sync(kFull, kmax[p], d);
    }
    if (key_less<P>(k, kmin)) {
#pragma unroll
      for (int p = 0; p < P; ++p) kmin[p] = k[p];
    }
    if (key_less<P>(kmax, m)) {
#pragma unroll
      for (int p = 0; p < P; ++p) kmax[p] = m[p];
    }
  }
  int b = -1;  // the first bit from the top where kmin and kmax differ
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {
    const unsigned long long x = kmin[p] ^ kmax[p];
    if (x) b = 64 * (P - 1 - p) + 63 - __clzll(x);
  }
  unsigned long long x[P];  // the o-th key's bits above b
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int low = 64 * (P - 1 - p);  // the plane's lowest composite bit
    x[p] = b < low ? kmin[p]
           : b >= low + 63 ? 0ull
                           : kmin[p] & ~((2ull << (b - low)) - 1ull);
  }
  __syncwarp();
  for (; b >= 0; --b) {
    unsigned long long y[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      y[p] = x[p] | (P - 1 - p == (b >> 6) ? 1ull << (b & 63) : 0ull);
    }
    uint32_t cnt = 0;
    for (int s = lane; s < S; s += 32) {
      const uint32_t m = seg_lower_bound<P>(a, s_pstart[s], lo[s], hi[s], y);
      mid[s] = m;
      cnt += m;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) cnt += __shfl_xor_sync(kFull, cnt, d);
    const bool take = cnt <= o;  // the o-th key is at or above y
    if (take) {
#pragma unroll
      for (int p = 0; p < P; ++p) x[p] = y[p];
    }
    for (int s = lane; s < S; s += 32) {
      if (take) {
        lo[s] = mid[s];
      } else {
        hi[s] = mid[s];
      }
    }
  }
  // [lo, hi): each segment's rows equal to the o-th key; the rest of o is
  // taken from them in segment order.
  uint32_t below = 0;
  for (int s = lane; s < S; s += 32) below += lo[s];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) below += __shfl_xor_sync(kFull, below, d);
  const uint32_t rem = o - below;
  uint32_t carry = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const uint32_t eq = s < S ? hi[s] - lo[s] : 0u;
    const uint32_t incl = warp_inclusive(eq, lane);
    const uint32_t before = carry + incl - eq;
    if (s < S) {
      out[s] = lo[s] + (rem > before ? (rem - before < eq ? rem - before : eq)
                                     : 0u);
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
}

__host__ __device__ constexpr int merge_smem_bytes(int P, int S) {
  return merge_tile(P) * (8 * P + 4) * 2 + 4 * (3 * S + 1);
}

// One block a tile of valid rows (see the header).
template <int P>
__global__ void __launch_bounds__(kMergeThreads) merge_tile_kernel(
    MergeArgs a) {
  constexpr int TM = merge_tile(P);
  constexpr int E = TM / kMergeThreads;  // outputs a thread a round
  extern __shared__ __align__(16) unsigned char s_raw[];
  unsigned long long* s_key[2] = {
      reinterpret_cast<unsigned long long*>(s_raw),
      reinterpret_cast<unsigned long long*>(s_raw) + P * TM};
  uint32_t* s_row[2] = {reinterpret_cast<uint32_t*>(s_raw + 16 * P * TM),
                        reinterpret_cast<uint32_t*>(s_raw + 16 * P * TM) + TM};
  const int S = a.n_seg;
  uint32_t* s_off = s_row[1] + TM;  // (S + 1,) the tile's share of each
  uint32_t* s_first = s_off + S + 1;  // (S,) its first row of each
  __shared__ uint32_t s_warp[kMergeThreads / 32];
  const uint32_t V = a.vstart[S];
  const long long t0 = (long long)blockIdx.x * TM;
  if (t0 >= V) return;
  const uint32_t o0 = (uint32_t)t0;
  const uint32_t total = (uint32_t)(V - t0 < TM ? V - t0 : TM);
  const uint32_t* c0 = a.corank + (long long)blockIdx.x * S;
  const uint32_t* c1 = c0 + S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {  // each thread two segments: their shares, exclusive scan
    uint32_t len[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * threadIdx.x + h;
      len[h] = s < S ? c1[s] - c0[s] : 0u;
      if (s < S) s_first[s] = a.pstart[s] + c0[s];
    }
    const uint32_t sum = len[0] + len[1];
    const uint32_t incl = warp_inclusive(sum, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    uint32_t run = incl - sum;
    for (int q = 0; q < warp; ++q) run += s_warp[q];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * threadIdx.x + h;
      if (s < S) s_off[s] = run;
      run += len[h];
    }
    if (threadIdx.x == 0) s_off[S] = total;
  }
  __syncthreads();
  for (uint32_t i = threadIdx.x; i < total; i += kMergeThreads) {
    const int s = segment_of(s_off, S, i);
    const uint32_t row = s_first[s] + (i - s_off[s]);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      __pipeline_memcpy_async(s_key[0] + p * TM + i, a.keys + p * a.n + row, 8);
    }
    s_row[0][i] = row;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // The keys as their unsigned order (key ^ 2^63).
  for (uint32_t i = threadIdx.x; i < total; i += kMergeThreads) {
#pragma unroll
    for (int p = 0; p < P; ++p) s_key[0][p * TM + i] ^= kSign;
  }
  __syncthreads();
  int cur = 0;
  for (int r = 0; (1 << r) < S; ++r) {
    // Round r merges runs 2k and 2k + 1 of 2^r segments each into run k.
    const unsigned long long* kin = s_key[cur];
    const uint32_t* rin = s_row[cur];
    unsigned long long* kout = s_key[cur ^ 1];
    uint32_t* rout = s_row[cur ^ 1];
    const int half = 1 << r, span = 2 << r;
    const int n_pairs = (S + span - 1) / span;
    uint32_t pos = threadIdx.x * E;
    const uint32_t end = pos + E < total ? pos + E : total;
    while (pos < end) {
      int k = 0, kh = n_pairs - 1;  // the last pair starting at or before pos
      while (k < kh) {
        const int km = (k + kh + 1) >> 1;
        if (s_off[km * span] <= pos) {
          k = km;
        } else {
          kh = km - 1;
        }
      }
      const uint32_t a0 = s_off[k * span];
      const uint32_t a1 = s_off[k * span + half < S ? k * span + half : S];
      const uint32_t b1 = s_off[k * span + span < S ? k * span + span : S];
      const uint32_t la = a1 - a0, lb = b1 - a1, d = pos - a0;
      // Merge path: the first d outputs hold i rows of run 2k (ties: 2k's
      // first).
      uint32_t i = d > lb ? d - lb : 0, ih = d < la ? d : la;
      while (i < ih) {
        const uint32_t im = (i + ih) >> 1;
        unsigned long long ka[P], kb[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          ka[p] = kin[p * TM + a0 + im];
          kb[p] = kin[p * TM + a1 + d - 1 - im];
        }
        if (!key_less<P>(kb, ka)) {
          i = im + 1;
        } else {
          ih = im;
        }
      }
      uint32_t jb = d - i;
      const uint32_t stop = end < b1 ? end : b1;
      for (; pos < stop; ++pos) {
        bool from_a = i < la;
        if (from_a && jb < lb) {
          unsigned long long ka[P], kb[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            ka[p] = kin[p * TM + a0 + i];
            kb[p] = kin[p * TM + a1 + jb];
          }
          from_a = !key_less<P>(kb, ka);
        }
        const uint32_t at = from_a ? a0 + i++ : a1 + jb++;
#pragma unroll
        for (int p = 0; p < P; ++p) kout[p * TM + pos] = kin[p * TM + at];
        rout[pos] = rin[at];
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  for (uint32_t i = threadIdx.x; i < total; i += kMergeThreads) {
    const long long o = (long long)o0 + i;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      a.out_keys[p * a.n + o] = (long long)(s_key[cur][p * TM + i] ^ kSign);
    }
    a.out_perm[o] = s_row[cur][i];
    a.out_valid[o] = 1;
  }
}

// -- host side ------------------------------------------------------------

long long align16(long long b) { return (b + 15) / 16 * 16; }

long long max_buckets(int P, long long n) {  // a level's; each past capacity
  return n / local_rows(P) + 2;
}
long long max_chunks(int P, long long n) {
  return (n + chunk_rows(P) - 1) / chunk_rows(P) + max_buckets(P, n);
}
long long max_jobs(int P, long long n) {
  return (3 + 2LL * n_digits(P)) * max_buckets(P, n);
}
long long sort_work_bytes(int P, long long n) {
  return 2 * align16(n * (8LL * P + 4)) +
         2 * align16(max_chunks(P, n) * kBins * 4) +
         2 * align16(max_buckets(P, n) * (long long)sizeof(Bucket)) +
         2 * align16(max_chunks(P, n) * 4) +
         align16(max_jobs(P, n) * (long long)sizeof(Job));
}

int sms_of_device() {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

long long clamp_grid(long long want, long long cap) {
  return want < 1 ? 1 : (want < cap ? want : cap);
}

template <int P>
int run_sort(const void* keys, long long n, const void* valid,
             void* out_keys, void* out_perm, void* out_valid, void* work,
             void* scratch, cudaStream_t stream) {
  SortArgs a;
  a.keys = (const long long*)keys;
  a.valid = (const uint8_t*)valid;
  a.n = n;
  a.keyed = P == 1 && valid == nullptr;
  a.out_keys = (long long*)out_keys;
  a.out_perm = (long long*)out_perm;
  a.out_valid = (uint8_t*)out_valid;
  unsigned char* at = (unsigned char*)work;
  const long long buf = align16(n * (8LL * P + 4));
  for (int b = 0; b < 2; ++b) {
    a.buf_keys[b] = (unsigned long long*)at;
    a.buf_pay[b] = (uint32_t*)(at + 8LL * P * n);
    at += buf;
  }
  const long long mc = max_chunks(P, n), mb = max_buckets(P, n);
  a.counts = (uint32_t*)at;
  at += align16(mc * kBins * 4);
  a.ranges = (uint32_t*)at;
  at += align16(mc * kBins * 4);
  for (int b = 0; b < 2; ++b) {
    a.buckets[b] = (Bucket*)at;
    at += align16(mb * (long long)sizeof(Bucket));
  }
  for (int b = 0; b < 2; ++b) {
    a.chunk_bucket[b] = (uint32_t*)at;
    at += align16(mc * 4);
  }
  a.jobs = (Job*)at;
  a.plan = (Plan*)scratch;
  const int sms = sms_of_device();
  cudaError_t err;
  const int scatter_smem = scatter_smem_bytes(P);
  cudaFuncSetAttribute(sort_scatter_kernel<P, true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       scatter_smem);
  cudaFuncSetAttribute(sort_scatter_kernel<P, false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       scatter_smem);
  const int local_smem = local_smem_bytes(P);
  cudaFuncSetAttribute(sort_local_kernel<P>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       local_smem);
  const unsigned count_grid = (unsigned)clamp_grid(mc, 4LL * sms);
  // Level 1's count blocks take ranges of consecutive chunks, about four
  // blocks an SM.
  const long long l1_chunks = (n + chunk_rows(P) - 1) / chunk_rows(P);
  a.range_chunks = (int)((l1_chunks + 4LL * sms - 1) / (4LL * sms));
  const unsigned range_grid =
      (unsigned)((l1_chunks + a.range_chunks - 1) / a.range_chunks);
  const unsigned scan_grid = (unsigned)clamp_grid(mb, 2LL * sms);
  const unsigned scatter_grid = (unsigned)clamp_grid(mc, kScatterBlocks * sms);
  for (int L = 1; L <= n_digits(P); ++L) {
    if (L == 1) {
      sort_count_kernel<P, true><<<range_grid, kCountThreads, 0, stream>>>(a, L);
    } else {
      sort_count_kernel<P, false><<<count_grid, kCountThreads, 0, stream>>>(a, L);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sort_scan_kernel<P><<<L == 1 ? 1 : scan_grid, kScanThreads, 0, stream>>>(
        a, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (L == 1) {
      sort_scatter_kernel<P, true>
          <<<scatter_grid, kScatterThreads, scatter_smem, stream>>>(a, L);
    } else {
      sort_scatter_kernel<P, false>
          <<<scatter_grid, kScatterThreads, scatter_smem, stream>>>(a, L);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  sort_local_kernel<P><<<(unsigned)clamp_grid(max_jobs(P, n), kLocalBlocks * sms),
                         kLocalThreads, local_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

long long merge_edges(int P, long long n) {
  return (n + merge_tile(P) - 1) / merge_tile(P) + 1;
}

template <int P>
int run_merge(const void* keys, long long n, const void* seg_start,
              const void* seg_count, int n_seg, void* out_keys,
              void* out_perm, void* out_valid, void* scratch,
              cudaStream_t stream) {
  MergeArgs a;
  a.keys = (const long long*)keys;
  a.n = n;
  a.n_seg = n_seg;
  a.seg_start = (const long long*)seg_start;
  a.seg_count = (const int32_t*)seg_count;
  a.out_keys = (long long*)out_keys;
  a.out_perm = (long long*)out_perm;
  a.out_valid = (uint8_t*)out_valid;
  a.pstart = (uint32_t*)scratch;
  a.vstart = a.pstart + kMaxSegments + 1;
  a.corank = a.vstart + kMaxSegments + 1;
  a.n_edges = merge_edges(P, n);
  cudaError_t err;
  merge_setup_kernel<<<1, kMaxSegments, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_corank = (int)((a.n_edges + kCorankWarps - 1) / kCorankWarps);
  const long long n_tail = (n + (long long)kCorankThreads * kTailRows - 1) /
                           ((long long)kCorankThreads * kTailRows);
  const int corank_smem = 4 * (2 * (n_seg + 1) + kCorankWarps * 3 * n_seg);
  cudaFuncSetAttribute(merge_corank_kernel<P>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       corank_smem);
  merge_corank_kernel<P><<<(unsigned)(n_corank + n_tail), kCorankThreads,
                           corank_smem, stream>>>(a, n_corank);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int tile_smem = merge_smem_bytes(P, n_seg);
  cudaFuncSetAttribute(merge_tile_kernel<P>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, tile_smem);
  merge_tile_kernel<P><<<(unsigned)(a.n_edges - 1), kMergeThreads, tile_smem,
                         stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The zeroed 64-bit scratch words a sort takes.
extern "C" long long grm_radix_sort_scratch_words(int n_pairs, long long n) {
  if (n_pairs < 1 || n_pairs > kMaxPlanes || n < 0) return -1;
  return ((long long)sizeof(Plan) + 7) / 8;
}

// The bytes of its work buffers (uninitialised).
extern "C" long long grm_radix_sort_work_bytes(int n_pairs, long long n) {
  if (n_pairs < 1 || n_pairs > kMaxPlanes || n < 0) return -1;
  return sort_work_bytes(n_pairs, n);
}

// keys (n_pairs, n) int64; valid (n,) uint8 or null; out_keys (n_pairs, n)
// int64, out_perm (n,) int64, out_valid (n,) uint8 or null (null where
// valid is); work grm_radix_sort_work_bytes; scratch
// grm_radix_sort_scratch_words, zeroed. 1 <= n < 2^31.
extern "C" int grm_radix_sort(const void* keys, int n_pairs, long long n,
                              const void* valid, void* out_keys,
                              void* out_perm, void* out_valid, void* work,
                              void* scratch, void* stream) {
  if (n < 1 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_pairs) {
    case 1:
      return run_sort<1>(keys, n, valid, out_keys, out_perm, out_valid, work,
                         scratch, s);
    case 2:
      return run_sort<2>(keys, n, valid, out_keys, out_perm, out_valid, work,
                         scratch, s);
    case 3:
      return run_sort<3>(keys, n, valid, out_keys, out_perm, out_valid, work,
                         scratch, s);
    case 4:
      return run_sort<4>(keys, n, valid, out_keys, out_perm, out_valid, work,
                         scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The 64-bit scratch words a merge takes (uninitialised).
extern "C" long long grm_merge_keys_scratch_words(int n_pairs, long long n,
                                                  int n_seg) {
  if (n_pairs < 1 || n_pairs > kMaxPlanes || n < 0 || n_seg < 1 ||
      n_seg > kMaxSegments) {
    return -1;
  }
  return (2LL * (kMaxSegments + 1) + merge_edges(n_pairs, n) * n_seg + 1) / 2;
}

// keys (n_pairs, n) int64; seg_start (n_seg + 1,) int64 and seg_count
// (n_seg,) int32 on the device; out_keys (n_pairs, n) int64, out_perm (n,)
// int64, out_valid (n,) uint8; scratch grm_merge_keys_scratch_words.
// 1 <= n < 2^31, 1 <= n_seg <= kMaxSegments.
extern "C" int grm_merge_keys(const void* keys, int n_pairs, long long n,
                              const void* seg_start, const void* seg_count,
                              int n_seg, void* out_keys, void* out_perm,
                              void* out_valid, void* scratch, void* stream) {
  if (n < 1 || n >= (1LL << 31) || n_seg < 1 || n_seg > kMaxSegments) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_pairs) {
    case 1:
      return run_merge<1>(keys, n, seg_start, seg_count, n_seg, out_keys,
                          out_perm, out_valid, scratch, s);
    case 2:
      return run_merge<2>(keys, n, seg_start, seg_count, n_seg, out_keys,
                          out_perm, out_valid, scratch, s);
    case 3:
      return run_merge<3>(keys, n, seg_start, seg_count, n_seg, out_keys,
                          out_perm, out_valid, scratch, s);
    case 4:
      return run_merge<4>(keys, n, seg_start, seg_count, n_seg, out_keys,
                          out_perm, out_valid, scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
