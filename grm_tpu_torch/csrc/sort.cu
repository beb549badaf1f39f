// Stable LSD radix sort of the device ingest's sort keys, for Hopper
// (sm_90a).
//
// Replaces grm_tpu/ops/kmer.py:110 _lex_sort, the stable lax.sort over
// [invalid, words...] (XLA, no pallas_call) that orders a batch's canonical
// windows (grm_tpu/parallel/device_build.py:88), the union merge's rows
// (_merge_ranks, :158, sort at :182) and one genome's windows
// (_sort_unique_device, grm_tpu/ops/kmer.py:177).
//
// What it computes: the stable sort of n rows by [invalid, key planes...]
// (grm_tpu_torch/ops/kmer.py sort_keys). Keys are P planes of n int64,
// most significant first, each a pair of k-mer words ((hi << 32) | lo) ^
// 2^63, 2^63 - 1 in every plane of an invalid row. A row is invalid where
// `valid` is 0, or, with no `valid` and one plane, where its key is 2^63 - 1;
// with no `valid` and more planes every row counts as valid. Outputs: the
// sorted keys (P, n) int64, each sorted row's input position (n,) int64 and,
// where `valid` is given, the sorted validity (n,) uint8. Ties keep input
// order, so the output is unique and equals the plain version exactly.
//
// The rows sort as one composite of 64 P + 1 bits: bit 64 P is the row's
// invalid flag, bits [64 (P - 1 - p), 64 (P - p)) plane p's key ^ 2^63
// (its unsigned order). Digits of kDigitBits bits are aligned from the top:
// digit j of radix_passes(P) covers composite bits [digit_lo(P, j),
// digit_hi(P, j)), the last digit the top bits with the invalid flag,
// digit 0 what is left below (narrower). One LSD pass a digit, least
// significant first.
//
// Segments (the union merge): S segments of consecutive rows, segment s
// holding rows [seg_start[s], seg_start[s + 1]) of which the first
// min(seg_count[s], its rows) are valid and the rest invalid (2^63 - 1 in
// every plane, validity 0), seg_count being a device tensor (the batches'
// k-mer counts: no fetch). The sort then reads only the valid rows, in
// segment order, as if they were the whole input; the tail kernel writes
// the invalid rows after them in input order, which is where a stable sort
// puts them.
//
// What bounds it on the H100: device memory. The function must read each
// key once and write each sorted key and position once (24 bytes a row at
// P = 1: 1.01 ms at 3.35 TB/s for a batch of 140.9M windows). A radix sort
// moves every row once a pass: torch.sort (CUB's onesweep) reads the keys
// once for its histograms, then runs 8 passes over 64 bits that read and
// write the key and an int64 index, about 264 bytes a row.
//
// What the design does about it:
//
// 1. Sort only the live bits. A valid key's low 64 - 2k bits are zero at
//    k <= 31, and every invalid row has the same key, so a digit that is
//    uniform over the valid rows and uniform over the invalid rows cannot
//    change the order: its pass is skipped (the top pass always runs). The
//    histogram kernel ORs each group's key bits and their complements; the
//    plan kernel marks a digit uniform where no bit of it is set in both.
//    The validity is the top digit's top bit, not a pass of its own: at
//    k = 31 the 63 live bits take 8 passes of 8 bits, at k = 21 6, at
//    k = 33 9 (1 + 66 bits). Nothing relies on a canonical k-mer never
//    being all T: the all-T key differs from 2^63 - 1 in the invalid flag.
// 2. Carry a 32-bit payload: the row's input position, made by the first
//    pass (no iota read), with the invalid flag in its top bit (so n <
//    2^31). The last pass writes it as the int64 permutation, so that
//    build_columns and merge_columns take `perm` as before.
// 3. Count once, then one launch a pass. One histogram kernel reads the keys
//    once for every digit's counts (the digits' bit ranges compile-time
//    constants); one block scans them into each digit's first output row
//    and makes the plan: which passes run, and from which buffer to which.
//    Each pass (onesweep) takes tiles of kSortThreads * R rows (R =
//    sort_items(P)) in the order of an atomic counter. A warp loads 32
//    consecutive rows a step (coalesced), takes each row's digit once (a
//    funnel shift of two 32-bit words of the composite), and ranks them
//    stably: the lanes of one digit find each other with one ballot a digit
//    bit, and the lowest adds their count to the warp's counter of that
//    digit in shared memory. One exclusive scan of the counters,
//    digit-major then warp, gives each row its slot in the tile's sorted
//    order; each tile's counts go to the tiles after it by a decoupled
//    look-back, a 64-bit status word a (tile, digit): the pass's tag, an
//    aggregate or inclusive flag, the count, the aggregate published as
//    soon as the tile's counts are known. A thread looks back for its
//    digit kLookback tiles a step, the first step's loads issued before
//    the slots are made. The tile goes to shared memory in input order as
//    it is loaded (so that a thread holds only its rows' digits and ranks:
//    kSortBlocks blocks an SM), each slot's input row into a slot map, and
//    it is written out slot by slot through the map, so that a digit's rows
//    of a tile are stored together. The tags let every pass share one
//    status array, zeroed once a sort.
// 4. The merge sorts only its valid rows (segments, above): 96.4M of
//    ingest-device's 184.5M merge rows.
//
// The digit width, the look-back's window, the tile and the blocks an SM
// were chosen by timing this kernel's variants on the H100
// (scripts/time_sort_variants.py, PERF.md §6): every tile pays work per
// digit value (its counters, their scan, one status word and one look-back
// a digit), and the look-back's chain of tiles, more than the bytes, sets
// the pace of a pass, so 8-bit digits beat wider ones despite a pass more.
// Bytes a row at P = 1, k = 31: 8 (histograms) + 20 (the first pass reads
// a key and writes key and payload) + 6 x 24 + 28 (the last pass writes
// the int64 position) = 200, against torch.sort's ~264: 8.4 ms at 3.35
// TB/s for a batch.
//
// The look-back's status words carry tag, flag and count in one 64-bit word
// and publish nothing else, so relaxed loads and stores at GPU scope suffice.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kDigitsPerThread =
    kBins > kSortThreads ? kBins / kSortThreads : 1;  // look-back, scan
constexpr int kLookback = 1;    // tiles a look-back step reads
constexpr int kSortBlocks = 3;  // a pass's blocks an SM
constexpr int kMaxPlanes = 4;
constexpr int kMaxPasses = (64 * kMaxPlanes + 1 + kDigitBits - 1) / kDigitBits;
constexpr int kHistThreads = 512;
// Rows a histogram thread loads at once, by key planes.
__host__ __device__ constexpr int hist_rows(int P) {
  return P == 1 ? 8 : (P == 2 ? 4 : 2);
}
constexpr int kScanThreads = kBins < 1024 ? kBins : 1024;
constexpr int kTailThreads = 256;
constexpr int kMaxSegments = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kInvalidBit = 0x80000000u;  // payload: the invalid flag
constexpr long long kInvalidKey = LLONG_MAX;
constexpr unsigned long long kSign = 0x8000000000000000ull;
constexpr unsigned long long kAggregate = 1ull << 32;  // status: own count
constexpr unsigned long long kInclusive = 2ull << 32;  // status: count so far
constexpr int kTagShift = 40;                          // status: pass tag
// Buffers of a pass's plan.
constexpr int kInput = 0;   // src: the input keys; dst: the outputs
constexpr int kBufferA = 1;
constexpr int kBufferB = 2;
static_assert(kBufferB == kBufferA + 1,
              "the plan names buffer m % 2 as kBufferA + m % 2");
static_assert(kDigitBits <= 11 && kBins % 32 == 0,
              "a digit spans at most two 32-bit words; whole warps of bins");

// Rows a thread ranks a pass, by key planes: a tile is kSortThreads * R.
__host__ __device__ constexpr int sort_items(int P) {
  return P == 1 ? 16 : (P == 2 ? 8 : 4);
}

// The digits of P planes, and digit j's composite bits [lo, hi).
__host__ __device__ constexpr int radix_passes(int P) {
  return (64 * P + 1 + kDigitBits - 1) / kDigitBits;
}
__host__ __device__ constexpr int digit_hi(int P, int j) {
  return 64 * P + 1 - kDigitBits * (radix_passes(P) - 1 - j);
}
__host__ __device__ constexpr int digit_lo(int P, int j) {
  return digit_hi(P, j) - kDigitBits > 0 ? digit_hi(P, j) - kDigitBits : 0;
}

// Copies of the histogram counters a block keeps (warp w adds to copy w %
// copies, so that fewer warps contend for one counter), within 96 KB.
__host__ __device__ constexpr int hist_copies(int P) {
  return radix_passes(P) * kBins * 4 * 4 <= 96 * 1024 ? 4 : 1;
}

struct SortArgs {
  const long long* keys;      // (P, n) input
  const uint8_t* valid;       // (n,) or null
  long long n;                // rows
  int keyed;                  // validity from plane 0 == 2^63 - 1
  const long long* seg_start; // (S + 1,) first row of each segment, or null
  const int32_t* seg_count;   // (S,) valid rows of each segment (clipped)
  int n_seg;
  long long* out_keys;        // (P, n)
  long long* out_perm;        // (n,)
  uint8_t* out_valid;         // (n,) or null
  unsigned long long* buf_keys[2];  // (P, n) key ^ 2^63, buffers A and B
  uint32_t* buf_pay[2];             // (n,) payloads
  // Scratch, zeroed: each digit's counts, its first output rows, each
  // group's (valid, invalid) OR of the keys and of their complements, the
  // plan (ordinal or -1, src, dst, 0 a digit), the tile counters, the rows
  // sorted (n, or the valid rows of the segments) and each segment's first
  // valid row among them, and the status words.
  uint32_t* hist;             // (kMaxPasses, kBins)
  uint32_t* base;             // (kMaxPasses, kBins)
  unsigned long long* bits;   // (2 groups, 2, kMaxPlanes)
  int32_t* plan;              // (kMaxPasses, 4)
  uint32_t* tiles;            // (kMaxPasses,)
  long long* n_rows;          // (1,)
  uint32_t* vstart;           // (kMaxSegments + 1,)
  unsigned long long* status; // (tiles of a pass, kBins)
};

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

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

// The lanes of the warp whose (ok, w-bit digit) equal this lane's: one
// ballot a bit (the match instruction is slower on this card).
__device__ __forceinline__ uint32_t match_digit(bool ok, uint32_t d, int w) {
  const uint32_t live = __ballot_sync(kFull, ok);
  uint32_t peers = ok ? live : ~live;
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    if (b < w) {
      const bool one = (d >> b) & 1u;
      const uint32_t ones = __ballot_sync(kFull, one);
      peers &= one ? ones : ~ones;
    }
  }
  return peers;
}

// Shared memory of the segment table: each segment's first row, and its
// first valid row among the rows sorted (both < 2^31), S + 1 each.
__device__ long long load_segments(const SortArgs& a, uint32_t* s_pstart,
                                   uint32_t* s_vstart) {
  if (a.seg_start == nullptr) return a.n;
  const int S = a.n_seg;
  for (int s = threadIdx.x; s <= S; s += blockDim.x) {
    s_pstart[s] = (uint32_t)a.seg_start[s];
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // warp 0: exclusive scan of the clipped counts
    const int lane = threadIdx.x;
    uint32_t carry = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      uint32_t c = 0;
      if (s < S) {
        const long long rows = (long long)s_pstart[s + 1] - s_pstart[s];
        const long long got = a.seg_count[s];
        c = (uint32_t)(got < 0 ? 0 : (got < rows ? got : rows));
      }
      uint32_t sum = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t o = __shfl_up_sync(kFull, sum, d);
        if (lane >= d) sum += o;
      }
      if (s < S) s_vstart[s] = carry + sum - c;
      carry += __shfl_sync(kFull, sum, 31);
    }
    if (lane == 0) s_vstart[S] = carry;
  }
  __syncthreads();
  return s_vstart[S];
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

// Row i of the rows sorted, from the input: its key planes ^ 2^63, its
// input position and invalid flag.
template <int P>
__device__ __forceinline__ void load_input(const SortArgs& a,
                                           const uint32_t* s_pstart,
                                           const uint32_t* s_vstart,
                                           long long i,
                                           unsigned long long (&u)[P],
                                           uint32_t* pos, uint32_t* inv) {
  long long row = i;
  if (a.seg_start != nullptr) {
    const int s = segment_of(s_vstart, a.n_seg, (uint32_t)i);
    row = (long long)s_pstart[s] + (i - s_vstart[s]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    u[p] = (unsigned long long)__ldg(a.keys + p * a.n + row) ^ kSign;
  }
  if (a.seg_start != nullptr) {
    *inv = 0;  // the segments' valid prefixes
  } else if (a.valid != nullptr) {
    *inv = __ldg(a.valid + row) == 0;
  } else {
    *inv = a.keyed && u[0] == ~0ull;
  }
  *pos = (uint32_t)row;
}

// Every digit's counts over the rows sorted, each group's OR of the key
// bits and of their complements; block 0 also stores the rows sorted and
// the segments' first valid rows.
template <int P>
__global__ void __launch_bounds__(kHistThreads) sort_hist_kernel(SortArgs a) {
  constexpr int kPasses = radix_passes(P);
  constexpr int kCopies = hist_copies(P);
  extern __shared__ uint32_t s_mem[];
  uint32_t* s_hist = s_mem;  // [copy][digit][bin]
  uint32_t* s_pstart = s_hist + kCopies * kPasses * kBins;
  uint32_t* s_vstart = s_pstart + a.n_seg + 1;
  for (int e = threadIdx.x; e < kCopies * kPasses * kBins; e += blockDim.x) {
    s_hist[e] = 0;
  }
  uint32_t* my_hist = s_hist + ((threadIdx.x >> 5) % kCopies) * kPasses * kBins;
  const long long n_rows = load_segments(a, s_pstart, s_vstart);
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) *a.n_rows = n_rows;
    if (a.seg_start != nullptr) {
      for (int s = threadIdx.x; s <= a.n_seg; s += blockDim.x) {
        a.vstart[s] = s_vstart[s];
      }
    }
  }
  __syncthreads();
  unsigned long long bits[2][2][P];  // [invalid][OR, OR of complements][p]
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int p = 0; p < P; ++p) bits[g][0][p] = bits[g][1][p] = 0;
  }
  // hist_rows(P) rows a thread a step, a grid's width apart, all loads
  // issued before any is used.
  constexpr int kHistRows = hist_rows(P);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i0 < n_rows; i0 += kHistRows * stride) {
    unsigned long long u[kHistRows][P];
    uint32_t inv[kHistRows];
#pragma unroll
    for (int e = 0; e < kHistRows; ++e) {
      uint32_t pos;
      if (i0 + e * stride < n_rows) {
        load_input<P>(a, s_pstart, s_vstart, i0 + e * stride, u[e], &pos,
                      inv + e);
      }
    }
#pragma unroll
    for (int e = 0; e < kHistRows; ++e) {
      if (i0 + e * stride >= n_rows) continue;
#pragma unroll
      for (int j = 0; j < kPasses; ++j) {
        atomicAdd(my_hist + j * kBins +
                      digit_of<P>(u[e], inv[e], digit_lo(P, j),
                                  digit_hi(P, j) - digit_lo(P, j)),
                  1u);
      }
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
  __syncthreads();
  for (int e = threadIdx.x; e < kPasses * kBins; e += blockDim.x) {
    uint32_t c = 0;
#pragma unroll
    for (int h = 0; h < kCopies; ++h) c += s_hist[h * kPasses * kBins + e];
    if (c) atomicAdd(a.hist + e, c);
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
        if (lane == 0 && v) atomicOr(a.bits + (g * 2 + o) * kMaxPlanes + p, v);
      }
    }
  }
}

// One block: each digit's first output rows (an exclusive scan of its
// counts), then the plan. A digit runs its pass unless it is uniform over
// the valid rows and over the invalid rows (no bit of it set in a group's
// OR and in its OR of complements); the top digit always runs. The m-th
// pass that runs reads the input (m = 0) or buffer (m - 1) % 2 and writes
// buffer m % 2, or the outputs if it is the last.
template <int P>
__global__ void __launch_bounds__(kScanThreads) sort_scan_kernel(SortArgs a) {
  __shared__ uint32_t s_warp[kScanThreads / 32];
  __shared__ int s_runs[kMaxPasses];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int n_pass = radix_passes(P);
  constexpr int kPer = kBins / kScanThreads;
  for (int j = 0; j < n_pass; ++j) {
    const uint32_t* h = a.hist + j * kBins;
    uint32_t c[kPer], total = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) total += c[e] = h[threadIdx.x * kPer + e];
    uint32_t sum = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(kFull, sum, d);
      if (lane >= d) sum += o;
    }
    if (lane == 31) s_warp[warp] = sum;
    __syncthreads();
    uint32_t before = sum - total;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      a.base[j * kBins + threadIdx.x * kPer + e] = before;
      before += c[e];
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n_pass; j += kScanThreads) {
    bool uniform = j < n_pass - 1;
    for (int b = digit_lo(P, j); b < digit_hi(P, j) && b < 64 * P; ++b) {
      const int p = P - 1 - (b >> 6);
      const unsigned long long bit = 1ull << (b & 63);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (a.bits[(g * 2) * kMaxPlanes + p] &
            a.bits[(g * 2 + 1) * kMaxPlanes + p] & bit) {
          uniform = false;
        }
      }
    }
    s_runs[j] = !uniform;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int runs = 0;
    for (int j = 0; j < n_pass; ++j) runs += s_runs[j];
    int m = 0;
    for (int j = 0; j < n_pass; ++j) {
      int32_t* pl = a.plan + 4 * j;
      if (!s_runs[j]) {
        pl[0] = -1;
        continue;
      }
      pl[0] = m;
      pl[1] = m == 0 ? kInput : kBufferA + ((m - 1) & 1);
      pl[2] = m == runs - 1 ? kInput : kBufferA + (m & 1);
      ++m;
    }
  }
}

// Dynamic shared memory of a pass, in bytes: the tile in input order
// (keys, payloads), each slot's input row (u16), the warps' counters, the
// digits' tile offsets (u16, kBins + 1, padded), their output bases (int),
// the segment table.
__host__ __device__ constexpr int pass_tile_bytes(int P) {
  return kSortThreads * sort_items(P) * (8 * P + 4 + 2);
}
__host__ __device__ constexpr int pass_smem_bytes(int P, int n_seg) {
  return pass_tile_bytes(P) + kBins * kSortWarps * 2 + 2 * (kBins + 8) +
         4 * kBins + (n_seg > 0 ? 8 * (n_seg + 1) : 0);
}

// One LSD pass over digit j (see the header).
template <int P>
__global__ void __launch_bounds__(kSortThreads, kSortBlocks) sort_pass_kernel(
    SortArgs a, int j) {
  constexpr int R = sort_items(P);
  constexpr int T = kSortThreads * R;
  extern __shared__ __align__(16) unsigned char s_raw[];
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(s_raw);
  uint32_t* s_pay = reinterpret_cast<uint32_t*>(s_raw + 8 * P * T);
  uint16_t* s_inv = reinterpret_cast<uint16_t*>(s_raw + (8 * P + 4) * T);
  uint16_t* s_cnt = reinterpret_cast<uint16_t*>(s_raw + pass_tile_bytes(P));
  uint16_t* s_excl = s_cnt + kBins * kSortWarps;
  int* s_base = reinterpret_cast<int*>(s_excl + kBins + 8);
  uint32_t* s_pstart = reinterpret_cast<uint32_t*>(s_base + kBins);
  uint32_t* s_vstart = s_pstart + a.n_seg + 1;
  __shared__ int s_tile, s_m, s_src, s_dst;
  __shared__ uint32_t s_warp[kSortWarps];
  if (threadIdx.x == 0) {
    const int32_t* pl = a.plan + 4 * j;
    s_m = pl[0];
    s_src = pl[1];
    s_dst = pl[2];
    s_tile = s_m >= 0 ? (int)atomicAdd(a.tiles + j, 1u) : 0;
  }
  __syncthreads();
  const int m = s_m;
  if (m < 0) return;  // a uniform digit
  const long long n_rows = *a.n_rows;
  const int tile = s_tile;
  const long long row0 = (long long)tile * T;
  if (row0 >= n_rows) return;  // past the rows sorted: publishes nothing
  const int items = (int)(n_rows - row0 < T ? n_rows - row0 : T);
  const int src = s_src, dst = s_dst;
  const int lo = digit_lo(P, j), w = digit_hi(P, j) - lo;
  const int bins = 1 << w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (src == kInput && a.seg_start != nullptr) {
    load_segments(a, s_pstart, s_vstart);  // synchronises
  }
  {
    uint4* c = reinterpret_cast<uint4*>(s_cnt);
    for (int e = threadIdx.x; e < kBins * kSortWarps * 2 / 16;
         e += kSortThreads) {
      c[e] = make_uint4(0, 0, 0, 0);
    }
  }

  // 1. Load: warp w's rows are the tile's [32 R w, 32 R (w + 1)), row
  // 32 r + lane at step r, all loads issued before any is used; each row's
  // digit taken, the tile stored in shared memory in input order.
  uint32_t dig[R];
  {
    unsigned long long u[R][P];
    uint32_t pay[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = warp * 32 * R + r * 32 + lane;
      if (i < items) {
        if (src == kInput) {
          uint32_t pos, inv;
          load_input<P>(a, s_pstart, s_vstart, row0 + i, u[r], &pos, &inv);
          pay[r] = pos | (inv ? kInvalidBit : 0u);
        } else {
          const unsigned long long* bk =
              src == kBufferA ? a.buf_keys[0] : a.buf_keys[1];
#pragma unroll
          for (int p = 0; p < P; ++p) u[r][p] = bk[p * a.n + row0 + i];
          pay[r] = (src == kBufferA ? a.buf_pay[0] : a.buf_pay[1])[row0 + i];
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
    const uint32_t peers = match_digit(ok, dig[r], w);
    const int leader = __ffs(peers) - 1;
    uint32_t old = 0;
    if (ok && lane == leader) {
      uint16_t* c = s_cnt + dig[r] * kSortWarps + warp;
      old = *c;
      *c = (uint16_t)(old + __popc(peers));
    }
    old = __shfl_sync(kFull, old, leader);
    rank[r] = old + __popc(peers & lt);
    __syncwarp();
  }
  __syncthreads();

  // 3. One exclusive scan of the counters, digit-major then warp: thread t
  // takes digits [kDigitsPerThread t, kDigitsPerThread (t + 1)), each
  // digit's kSortWarps counters (the threads past the digits none).
  // s_excl[d]: the tile's rows before digit d.
  {
    constexpr int kEntries = kDigitsPerThread * kSortWarps;  // u16 each
    const bool mine = threadIdx.x * kDigitsPerThread < kBins;
    uint4* c = reinterpret_cast<uint4*>(s_cnt) + threadIdx.x * (kEntries / 8);
    uint4 v[kEntries / 8];
    uint32_t total = 0;
#pragma unroll
    for (int e = 0; e < kEntries / 8; ++e) {
      v[e] = mine ? c[e] : make_uint4(0, 0, 0, 0);
      const uint32_t x[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
#pragma unroll
      for (int h = 0; h < 4; ++h) total += (x[h] & 0xFFFFu) + (x[h] >> 16);
    }
    uint32_t sum = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(kFull, sum, d);
      if (lane >= d) sum += o;
    }
    if (lane == 31) s_warp[warp] = sum;
    __syncthreads();
    uint32_t run = sum - total;
#pragma unroll
    for (int q = 0; q < kSortWarps; ++q) run += q < warp ? s_warp[q] : 0u;
    if (mine) {
#pragma unroll
      for (int e = 0; e < kEntries / 8; ++e) {
        uint32_t x[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int entry = e * 8 + h * 2;  // its two u16 halves
          if (entry % kSortWarps == 0) {
            s_excl[threadIdx.x * kDigitsPerThread + entry / kSortWarps] =
                (uint16_t)run;
          }
          const uint32_t a0 = x[h] & 0xFFFFu, a1 = x[h] >> 16;
          x[h] = run | ((run + a0) << 16);
          run += a0 + a1;
        }
        c[e] = make_uint4(x[0], x[1], x[2], x[3]);
      }
    }
    if (threadIdx.x == kSortThreads - 1) s_excl[kBins] = (uint16_t)run;
  }
  __syncthreads();

  // 4. The tile's count of each digit published at once (tile 0: as its
  // inclusive count), so that later tiles need not wait on this one.
  const unsigned long long tag = (unsigned long long)(m + 1) << kTagShift;
  uint32_t cnt[kDigitsPerThread];
#pragma unroll
  for (int q = 0; q < kDigitsPerThread; ++q) {
    const int d = threadIdx.x + q * kSortThreads;
    cnt[q] = d < bins ? (uint32_t)(s_excl[d + 1] - s_excl[d]) : 0u;
    if (d < bins) {
      store_status(a.status + (long long)tile * kBins + d,
                   tag | (tile > 0 ? kAggregate : kInclusive) | cnt[q]);
    }
  }

  // The look-back's first window issued now, so that its loads are in
  // flight while the slots are made.
  unsigned long long first[kDigitsPerThread][kLookback];
#pragma unroll
  for (int q = 0; q < kDigitsPerThread; ++q) {
    const int d = threadIdx.x + q * kSortThreads;
#pragma unroll
    for (int k = 0; k < kLookback; ++k) {
      first[q][k] = tile > k && d < bins
                        ? load_status(a.status + (long long)(tile - 1 - k) *
                                                     kBins + d)
                        : 0ull;
    }
  }

  // 5. Each row's slot in the tile's sorted order; the slot's input row
  // into s_inv.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = warp * 32 * R + r * 32 + lane;
    if (i < items) s_inv[rank[r] + s_cnt[dig[r] * kSortWarps + warp]] = i;
  }

  // 6. The look-back: a step reads, for every open digit of the thread,
  // the status of the kLookback tiles before the last one read (the first
  // step's loads issued before the slots are made), all loads issued
  // before any is used, and adds them down to the nearest inclusive count
  // or the first not yet published (read again the next step). Then the
  // inclusive count is published, and s_base[d] = the digit's first
  // output row + its rows in earlier tiles - its rows before it in this
  // tile.
  {
    uint32_t pre[kDigitsPerThread];
    int back[kDigitsPerThread];
    bool open[kDigitsPerThread];
#pragma unroll
    for (int q = 0; q < kDigitsPerThread; ++q) {
      open[q] = threadIdx.x + q * kSortThreads < bins && tile > 0;
      pre[q] = 0;
      back[q] = tile - 1;
    }
    bool any = tile > 0;
    bool fresh = true;  // the first window is in `first`
    while (any) {
      unsigned long long st[kDigitsPerThread][kLookback];
#pragma unroll
      for (int q = 0; q < kDigitsPerThread; ++q) {
        const int d = threadIdx.x + q * kSortThreads;
#pragma unroll
        for (int k = 0; k < kLookback; ++k) {
          const int t = back[q] - k;
          st[q][k] = fresh ? first[q][k]
                     : open[q] && t >= 0
                         ? load_status(a.status + (long long)t * kBins + d)
                         : 0ull;
        }
      }
      fresh = false;
      any = false;
#pragma unroll
      for (int q = 0; q < kDigitsPerThread; ++q) {
        bool go = open[q];
#pragma unroll
        for (int k = 0; k < kLookback; ++k) {
          if (!go) continue;
          const unsigned long long v = st[q][k];
          if ((v >> kTagShift) != (unsigned long long)(m + 1)) {
            go = false;  // not yet published
          } else {
            pre[q] += (uint32_t)v;
            --back[q];
            if (v & kInclusive) open[q] = go = false;
          }
        }
        any |= open[q];
      }
    }
    const uint32_t* base = a.base + j * kBins;
#pragma unroll
    for (int q = 0; q < kDigitsPerThread; ++q) {
      const int d = threadIdx.x + q * kSortThreads;
      if (d >= bins) continue;
      if (tile > 0) {
        store_status(a.status + (long long)tile * kBins + d,
                     tag | kInclusive | (pre[q] + cnt[q]));
      }
      s_base[d] = (int)(base[d] + pre[q]) - (int)s_excl[d];
    }
  }
  __syncthreads();

  // 7. The tile written out slot by slot, each slot's row read from the
  // input order.
  long long* out_key[P];
  unsigned long long* buf_key[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    out_key[p] = a.out_keys + p * a.n;
    buf_key[p] = (dst == kBufferA ? a.buf_keys[0] : a.buf_keys[1]) + p * a.n;
  }
  uint32_t* buf_pay = dst == kBufferA ? a.buf_pay[0] : a.buf_pay[1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = r * kSortThreads + threadIdx.x;
    if (s >= items) continue;
    const int i = s_inv[s];
    unsigned long long k[P];
#pragma unroll
    for (int p = 0; p < P; ++p) k[p] = s_key[p * T + i];
    const uint32_t y = s_pay[i];
    const int dest = s_base[digit_of<P>(k, y >> 31, lo, w)] + s;
    if (dst == kInput) {
#pragma unroll
      for (int p = 0; p < P; ++p) out_key[p][dest] = (long long)(k[p] ^ kSign);
      a.out_perm[dest] = (long long)(y & ~kInvalidBit);
      if (a.out_valid != nullptr) a.out_valid[dest] = (y >> 31) ^ 1u;
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) buf_key[p][dest] = k[p];
      buf_pay[dest] = y;
    }
  }
}

// The segments' invalid rows, after the valid ones in input order: row r
// of segment s, past its valid prefix, goes to n_rows + r - (s's first
// valid row among the rows sorted) - (s's valid rows).
template <int P>
__global__ void __launch_bounds__(kTailThreads) sort_tail_kernel(SortArgs a) {
  extern __shared__ uint32_t s_mem[];
  uint32_t* s_pstart = s_mem;
  uint32_t* s_vstart = s_pstart + a.n_seg + 1;
  const long long n_rows = load_segments(a, s_pstart, s_vstart);
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  const int s = segment_of(s_pstart, a.n_seg, (uint32_t)r);
  const uint32_t v = s_vstart[s + 1] - s_vstart[s];
  if ((uint32_t)r - s_pstart[s] < v) return;
  const long long o = n_rows + r - s_vstart[s] - v;
#pragma unroll
  for (int p = 0; p < P; ++p) a.out_keys[p * a.n + o] = kInvalidKey;
  a.out_perm[o] = r;
  if (a.out_valid != nullptr) a.out_valid[o] = 0;
}

// Scratch offsets, in 64-bit words.
constexpr long long kHistWords = kMaxPasses * kBins / 2;
constexpr long long kBitsWords = 2 * 2 * kMaxPlanes;
constexpr long long kPlanWords = kMaxPasses * 4 / 2;
constexpr long long kTileWords = (kMaxPasses + 1) / 2;
constexpr long long kVstartWords = (kMaxSegments + 2) / 2;
constexpr long long kStatusOffset =
    2 * kHistWords + kBitsWords + kPlanWords + kTileWords + 1 + kVstartWords;

long long n_tiles(int P, long long n) {
  const long long t = (long long)kSortThreads * sort_items(P);
  return (n + t - 1) / t;
}

long long align16(long long b) { return (b + 15) / 16 * 16; }

template <int P>
int run_sort(const void* keys, long long n, const void* valid,
             const void* seg_start, const void* seg_count, int n_seg,
             void* out_keys, void* out_perm, void* out_valid, void* work,
             void* scratch, cudaStream_t stream) {
  SortArgs a;
  a.keys = (const long long*)keys;
  a.valid = (const uint8_t*)valid;
  a.n = n;
  a.keyed = P == 1 && valid == nullptr;
  a.seg_start = (const long long*)seg_start;
  a.seg_count = (const int32_t*)seg_count;
  a.n_seg = seg_start != nullptr ? n_seg : 0;
  a.out_keys = (long long*)out_keys;
  a.out_perm = (long long*)out_perm;
  a.out_valid = (uint8_t*)out_valid;
  const long long buf = align16(n * (8LL * P + 4));
  for (int b = 0; b < 2; ++b) {
    unsigned char* at = (unsigned char*)work + b * buf;
    a.buf_keys[b] = (unsigned long long*)at;
    a.buf_pay[b] = (uint32_t*)(at + 8 * P * n);
  }
  unsigned long long* s = (unsigned long long*)scratch;
  a.hist = (uint32_t*)s;
  a.base = (uint32_t*)(s + kHistWords);
  a.bits = s + 2 * kHistWords;
  a.plan = (int32_t*)(s + 2 * kHistWords + kBitsWords);
  a.tiles = (uint32_t*)(s + 2 * kHistWords + kBitsWords + kPlanWords);
  a.n_rows = (long long*)(s + 2 * kHistWords + kBitsWords + kPlanWords +
                          kTileWords);
  a.vstart = (uint32_t*)(s + 2 * kHistWords + kBitsWords + kPlanWords +
                         kTileWords + 1);
  a.status = s + kStatusOffset;
  const int seg_bytes = a.n_seg > 0 ? 8 * (a.n_seg + 1) : 0;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);

  const long long hist_blocks_max = (n + kHistThreads - 1) / kHistThreads;
  const int hist_blocks = (int)(hist_blocks_max < 2LL * sms
                                    ? hist_blocks_max : 2LL * sms);
  cudaError_t err;
  const int hist_smem =
      hist_copies(P) * radix_passes(P) * kBins * 4 + seg_bytes;
  cudaFuncSetAttribute(sort_hist_kernel<P>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, hist_smem);
  sort_hist_kernel<P><<<hist_blocks, kHistThreads, hist_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sort_scan_kernel<P><<<1, kScanThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int smem = pass_smem_bytes(P, a.n_seg);
  cudaFuncSetAttribute(sort_pass_kernel<P>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long long tiles = n_tiles(P, n);
  for (int j = 0; j < radix_passes(P); ++j) {
    sort_pass_kernel<P><<<(unsigned)tiles, kSortThreads, smem, stream>>>(a, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (a.n_seg > 0) {
    sort_tail_kernel<P><<<(unsigned)((n + kTailThreads - 1) / kTailThreads),
                          kTailThreads, seg_bytes, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// The zeroed 64-bit scratch words a sort of n rows of n_pairs planes takes.
extern "C" long long grm_radix_sort_scratch_words(int n_pairs, long long n) {
  if (n_pairs < 1 || n_pairs > kMaxPlanes) return -1;
  return kStatusOffset + n_tiles(n_pairs, n) * kBins;
}

// The bytes of its two work buffers (uninitialised).
extern "C" long long grm_radix_sort_work_bytes(int n_pairs, long long n) {
  if (n_pairs < 1 || n_pairs > kMaxPlanes) return -1;
  return 2 * align16(n * (8LL * n_pairs + 4));
}

// keys (n_pairs, n) int64; valid (n,) uint8 or null; seg_start (n_seg + 1,)
// int64 and seg_count (n_seg,) int32 on the device, or null; out_keys
// (n_pairs, n) int64, out_perm (n,) int64, out_valid (n,) uint8 or null
// (null where valid is); work grm_radix_sort_work_bytes; scratch
// grm_radix_sort_scratch_words, zeroed. 1 <= n < 2^31.
extern "C" int grm_radix_sort(const void* keys, int n_pairs, long long n,
                              const void* valid, const void* seg_start,
                              const void* seg_count, int n_seg,
                              void* out_keys, void* out_perm,
                              void* out_valid, void* work, void* scratch,
                              void* stream) {
  if (n < 1 || n >= (1LL << 31) ||
      (seg_start != nullptr && (n_seg < 1 || n_seg > kMaxSegments))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_pairs) {
    case 1:
      return run_sort<1>(keys, n, valid, seg_start, seg_count, n_seg,
                         out_keys, out_perm, out_valid, work, scratch, s);
    case 2:
      return run_sort<2>(keys, n, valid, seg_start, seg_count, n_seg,
                         out_keys, out_perm, out_valid, work, scratch, s);
    case 3:
      return run_sort<3>(keys, n, valid, seg_start, seg_count, n_seg,
                         out_keys, out_perm, out_valid, work, scratch, s);
    case 4:
      return run_sort<4>(keys, n, valid, seg_start, seg_count, n_seg,
                         out_keys, out_perm, out_valid, work, scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
