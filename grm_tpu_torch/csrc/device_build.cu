// Device ingest for Hopper (sm_90a): the steps of the packed presence
// matrix's build that follow the window sort.
//
// Replaces the XLA programs of grm_tpu/parallel/device_build.py (none is a
// pallas_call):
//
//   build_columns (K2)   _build after the sort (:92-140): the new-k-mer
//                        flags, each row's union column from a scan of the
//                        flags, the genome bits ORed into the packed
//                        (W, k_budget) matrix, the union words.
//   merge_columns (K3)   _merge_ranks (:158) and _scatter_batch_columns
//                        (:207) in one launch: each merge row's merged
//                        column, the merged union, and each batch's word
//                        rows placed at their merged columns in the final
//                        (W, k_budget) matrix.
//   compact_columns (K4) _compact_singletons (:222) and _build's filter
//                        (:142) in one launch: each column's genome count,
//                        then the stable left compaction of the columns
//                        present in a number of genomes other than one,
//                        matrix and union.
//
// The rows come sorted (torch.sort, stable) by their keys: n_pairs planes
// of n int64 keys, a pair of k-mer words each, ((hi << 32) | lo) ^ 2^63,
// most significant plane first, and 2^63 - 1 in every plane of an invalid
// row (grm_tpu_torch/ops/kmer.py). Validity is the optional sorted uint8
// plane `valid`, or, where it is null, plane 0 below 2^63 - 1 (k <= 31).
// The valid rows come first, and rows of one k-mer keep their input order,
// which is genome order. `perm` is each sorted row's input position.
//
// K2, what bounds it on the H100: device memory. The function reads each
// row's key and permutation entry once (16 bytes a row at n_pairs = 1) and
// writes a few bytes of matrix and union per distinct k-mer.
//
// What its design does about it: one launch, each row read once. A block
// takes a tile of kBuildThreads * R consecutive sorted rows (R =
// build_rows(n_pairs)), its tile id from an atomic counter, so that a tile
// only ever waits on tiles that are already running. It stages the tile in
// shared memory with coalesced loads, all in flight before any is used;
// a row's genome is perm / n_cols by a multiply with a magic number made
// once a call (exact below 2^31). Then each thread walks R consecutive
// rows in registers: "first of a valid k-mer" is a compare with the row
// before, a (column, word) segment starts at a new k-mer or a new word,
// and the genome bits of a segment are ORed as the walk goes. A warp adds
// its lanes' firsts and ORs the segments that cross lanes with two
// shuffle scans, once per R rows; the block adds its warps' counts, and
// the tile's exclusive prefix comes from a decoupled look-back over one
// 64-bit status word a tile (flag and count in one word): no flags tensor
// and no torch.cumsum. The rows of one (column, word) are consecutive
// (columns do not decrease, nor do the genomes of a k-mer), so each
// segment's word is written once, by the lane that holds its last row:
// with a plain store, or with atomicOr for a segment that may continue in
// another warp (at most two a warp, however long a k-mer's run is). A
// repeated (k-mer, genome) row sets a bit that is already set, so no
// duplicate mask is needed. The first row of each k-mer writes its union
// words. Columns at or past k_budget are dropped, as XLA's out-of-range
// scatters drop them, but still counted, and the caller raises. The last
// tile writes the count of distinct k-mers. Five blocks an SM
// (kBuildBlocks) keep enough tiles staging while others wait on the
// look-back.
//
// K3, what bounds it: device memory. It reads each valid merge row's key
// and permutation entry once (16 bytes a row at n_pairs = 1) and the row's
// batch words once, and writes those words once into the final matrix;
// the bucket padding that follows the valid rows is never read past one
// key a tile.
//
// What its design does about it: one launch, no dest. A block takes a
// tile of kMergeThreads * R consecutive sorted rows (R = merge_rows(P))
// by the atomic tile counter; warp w owns the tile's w-th chunk of 32 R
// rows, lane l its rows 32 i + l, so every load is coalesced and all of a
// thread's loads are in flight before any is used. "First of a valid
// k-mer" is a compare with the row before (a shuffle from the lane below,
// lane 31 of the step before, or one load before the chunk); a ballot a
// step gives the warp its firsts, the block adds its warps' counts, and
// the tile's prefix comes from the look-back (lookback_prefix). A row's
// merged column is then the number of firsts up to it, less one. A
// padding tile (its first row invalid: the valid rows come first) exits
// after that one read and publishes nothing; no tile that holds a valid
// row waits on it, since all of them come before it. The tile holding the
// last valid row writes the count (tile 0 writes 0 if there is none).
// A valid row's input position p names its batch b (the last whose first
// concatenated row is at most p: a binary search of the row starts in
// shared memory) and its batch column j = p - that start. A row copied on
// its own would scatter 4-byte stores over the W word rows, so the tile
// bins its rows by batch in shared memory first: a batch holds a k-mer
// once and its rows come in its own sorted order, so the tile's rows of
// batch b have consecutive batch columns, and a row's slot is b's first
// slot plus j less the least of them (no sort). The batch words are read
// slot by slot (consecutive columns of one batch: coalesced) while warp 0
// looks back, the tile's own count being published before the bins are
// made; then each slot's word goes to its merged column with a plain
// store, a batch's slots on increasing columns of its own word rows (the
// batches own disjoint word rows, so no word is written twice). The
// first row of each k-mer writes its union words. Columns at or past
// k_budget are dropped but counted.
//
// K4, what bounds it: device memory. It reads each live column's W matrix
// words and nw union words once and writes each kept column's once.
//
// What its design does about it: one launch, the counts fused. A block
// takes a tile of kCompactThreads consecutive columns by the atomic tile
// counter, one column a thread, so every read and write of a matrix row is
// coalesced. A thread adds its live column's genomes with __popc over its
// W words and keeps the column if the count is not 1; a ballot, the warps'
// counts and the look-back give each kept column its compacted position,
// and the thread copies its words there (the second read of a word hits
// the cache the first one filled). A tile wholly at or past the live
// columns exits after reading n_kmers, and the tile holding the last live
// column writes the count.
//
// The look-back's status words carry flag and count in one 64-bit word and
// publish nothing else, so relaxed loads and stores at GPU scope suffice
// (an acquire load on each spin was measured slower on the H100).
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr long long kInvalidKey = LLONG_MAX;

// K2: build_columns in one pass (see the header). The look-back
// (lookback_prefix) is written for any tile-ordered scan.
constexpr int kBuildThreads = 256;
constexpr int kBuildWarps = kBuildThreads / 32;
constexpr int kBuildBlocks = 5;  // an SM: at most 48 registers a thread
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kNoGenome = 0xFFFFFFFFu;  // the genome of an invalid row
constexpr unsigned long long kAggregate = 1ull << 32;  // status: own count
constexpr unsigned long long kInclusive = 2ull << 32;  // status: count so far

// Consecutive rows a thread walks, by key planes: a tile is kBuildThreads
// * R rows, staged in shared memory (one slot of padding after each
// thread's R rows: R + 1 is odd, so the threads' walks hit distinct banks).
__host__ __device__ constexpr int build_rows(int P) {
  return P == 1 ? 8 : (P == 2 ? 4 : 2);
}

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

// Decoupled look-back, by one whole warp: the sum of the counts of the
// tiles before `tile`. status[t] is 0 until tile t stores (kAggregate | its
// count), then (kInclusive | the count of tiles 0..t); each is one 64-bit
// store, so no read sees a flag without its count. Lane l reads tile
// window - l; the warp waits until all 32 have published, adds the counts
// down to the nearest inclusive one, and moves 32 tiles back if there was
// none. Every tile before `tile` took its id earlier, so it is running and
// publishes its count without waiting on a later tile.
__device__ uint32_t lookback_prefix(const unsigned long long* status,
                                    long long tile, int lane) {
  uint32_t prefix = 0;
  for (long long window = tile - 1;; window -= 32) {
    const long long t = window - lane;
    unsigned long long s;
    do {
      s = t >= 0 ? load_status(status + t) : kInclusive;
    } while (__any_sync(kFull, (s >> 32) == 0));
    const unsigned done = __ballot_sync(kFull, (s >> 32) == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    prefix += __reduce_add_sync(kFull, lane <= stop ? (uint32_t)s : 0u);
    if (done) return prefix;
  }
}

// By one whole warp of tile `tile`: publishes the tile's count, looks
// back, publishes the count of tiles 0..tile; returns the tile's
// exclusive prefix. status is the launch's zeroed status words.
__device__ uint32_t publish_tile(unsigned long long* status, long long tile,
                                 uint32_t tile_count, int lane) {
  uint32_t prefix = 0;
  if (tile > 0) {
    if (lane == 0) store_status(status + tile, kAggregate | tile_count);
    prefix = lookback_prefix(status, tile, lane);
  }
  if (lane == 0) store_status(status + tile, kInclusive | (prefix + tile_count));
  return prefix;
}

// perm / n_cols for 0 <= perm < 2^31: (perm * magic) >> shift, magic and
// shift from ops/device_build._divisor_magic.
__device__ __forceinline__ uint32_t genome_of(uint32_t p, uint32_t magic,
                                              int shift) {
  return (uint32_t)(((unsigned long long)p * magic) >> shift);
}

// A genome's bit in its matrix word (0 for an invalid row or a word past
// n_words).
__device__ __forceinline__ uint32_t genome_bit(uint32_t g, int n_words) {
  return g != kNoGenome && (int)(g >> 5) < n_words ? 1u << (31 - (g & 31))
                                                   : 0u;
}

// One segment's word: a plain store where no other warp holds rows of the
// segment, else atomicOr.
__device__ __forceinline__ void write_word(uint32_t* matrix, int word,
                                           long long col, long long k_budget,
                                           uint32_t bits, bool shared) {
  if (bits == 0 || col < 0 || col >= k_budget) return;
  uint32_t* at = matrix + (long long)word * k_budget + col;
  if (shared) {
    atomicOr(at, bits);
  } else {
    *at = bits;
  }
}

// A k-mer's nw union words from its P key planes: word 2p is plane p's
// high half, word 2p + 1 its low half, the sign bit given back.
template <int P>
__device__ __forceinline__ void put_union(int32_t* u, const long long* kmer,
                                          int nw) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const unsigned long long w =
        (unsigned long long)kmer[p] ^ 0x8000000000000000ull;
    if (nw % 2 == 0 && 2 * p + 1 < nw) {  // 8-byte aligned: hi, lo
      *reinterpret_cast<unsigned long long*>(u + 2 * p) =
          (w << 32) | (w >> 32);
    } else if (2 * p < nw) {
      u[2 * p] = (int32_t)(uint32_t)(w >> 32);
      if (2 * p + 1 < nw) u[2 * p + 1] = (int32_t)(uint32_t)w;
    }
  }
}

// Genome bits into matrix (W, k_budget), union words into union_words
// (k_budget, nw), the count of distinct k-mers into count; scratch is
// 1 + n_tiles zeroed words: the tile counter, then one status a tile.
template <int P>
__global__ void __launch_bounds__(kBuildThreads, kBuildBlocks)
    build_columns_tile_kernel(
    const long long* __restrict__ keys, long long n,
    const uint8_t* __restrict__ valid, const long long* __restrict__ perm,
    uint32_t magic, int shift, int n_words, long long k_budget, int nw,
    uint32_t* __restrict__ matrix, int32_t* __restrict__ union_words,
    unsigned long long* __restrict__ scratch, int32_t* __restrict__ count) {
  constexpr int R = build_rows(P);
  constexpr int kTile = kBuildThreads * R;
  constexpr int kSlots = kBuildThreads * (R + 1);
  __shared__ long long s_key[P][kSlots];
  __shared__ uint32_t s_gid[kSlots];
  __shared__ long long s_tile;
  __shared__ uint32_t s_count[kBuildWarps];
  __shared__ uint32_t s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool keyed = valid == nullptr;  // validity from plane 0's key
  if (threadIdx.x == 0) s_tile = (long long)atomicAdd(scratch, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const long long row0 = tile * kTile;

  // 1. Stage the tile, each row read once and coalesced: row i of the tile
  // to slot i + i / R, its genome beside it. Every load is issued before
  // any is used (the row index is clamped, not branched on); perm by its
  // low 32-bit word (perm < 2^31). Thread 0 reads the row before the tile.
  long long key[R][P];
  uint32_t at[R];
  bool ok[R];
  const uint32_t* perm_lo = reinterpret_cast<const uint32_t*>(perm);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long r = min(row0 + j * kBuildThreads + threadIdx.x, n - 1);
#pragma unroll
    for (int p = 0; p < P; ++p) key[j][p] = keys[p * n + r];
    at[j] = perm_lo[2 * r];
    ok[j] = keyed || valid[r] != 0;
  }
  long long before[P];  // the row before this thread's first
  uint32_t g_before = kNoGenome;
#pragma unroll
  for (int p = 0; p < P; ++p) before[p] = kInvalidKey;
  if (threadIdx.x == 0 && row0 > 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) before[p] = keys[p * n + row0 - 1];
    if (keyed ? before[0] != kInvalidKey : valid[row0 - 1] != 0) {
      g_before = genome_of(perm_lo[2 * (row0 - 1)], magic, shift);
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = j * kBuildThreads + threadIdx.x;
    uint32_t g = kNoGenome;
    if (row0 + i >= n) {
#pragma unroll
      for (int p = 0; p < P; ++p) key[j][p] = kInvalidKey;
    } else if (ok[j] && (!keyed || key[j][0] != kInvalidKey)) {
      g = genome_of(at[j], magic, shift);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) s_key[p][i + i / R] = key[j][p];
    s_gid[i + i / R] = g;
  }
  __syncthreads();

  // 2. This thread's rows t R .. t R + R - 1 in order: bit i of
  // `firsts` marks row i the first of a valid k-mer, of `starts` the
  // start of a (column, word) segment (an invalid row starts its own);
  // `trail` ORs the genome bits from the last start (all of them if
  // there is none).
  const int slot0 = threadIdx.x * (R + 1);
  if (threadIdx.x > 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) before[p] = s_key[p][slot0 - 2];
    g_before = s_gid[slot0 - 2];
  }
  uint32_t gid[R];
  uint32_t firsts = 0, starts = 0, trail = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    bool is_new = row0 + (long long)threadIdx.x * R + i == 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long k = s_key[p][slot0 + i];
      is_new |= k != before[p];
      before[p] = k;
    }
    const uint32_t g = s_gid[slot0 + i];
    const bool start = g == kNoGenome || g_before == kNoGenome ||
                       is_new || (g >> 5) != (g_before >> 5);
    firsts |= (uint32_t)(g != kNoGenome && is_new) << i;
    starts |= (uint32_t)start << i;
    const uint32_t bit = genome_bit(g, n_words);
    trail = start ? bit : trail | bit;
    gid[i] = g_before = g;
  }

  // 3. The warp: each lane's firsts before it, and the trailing segments
  // ORed from lane to lane up to the nearest lane with a start (`upto`:
  // the OR of the segment open at the end of this lane's rows).
  const uint32_t lt = (1u << lane) - 1;  // lanes below this one
  const uint32_t with_start = __ballot_sync(kFull, starts != 0);
  const uint32_t row0_start = __ballot_sync(kFull, (starts & 1) != 0);
  const uint32_t since = with_start & (lt | (1u << lane));
  const int from = since != 0 ? 31 - __clz(since) : 0;
  uint32_t below = __popc(firsts), upto = trail;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t c = __shfl_up_sync(kFull, below, d);
    const uint32_t o = __shfl_up_sync(kFull, upto, d);
    if (lane >= d) below += c;
    if (lane - d >= from) upto |= o;
  }
  uint32_t carry = __shfl_up_sync(kFull, upto, 1);  // lane - 1's
  if (lane == 0) carry = 0;
  if (lane == 31) s_count[warp] = below;
  below -= __popc(firsts);

  // 4. The tile's prefix: the warps' counts added in the block, the
  // tile's own count published, the look-back, the sum published.
  __syncthreads();
  uint32_t tile_count = 0, warp_base = 0;
#pragma unroll
  for (int w = 0; w < kBuildWarps; ++w) {
    const uint32_t c = s_count[w];
    warp_base += w < warp ? c : 0u;
    tile_count += c;
  }
  if (warp == 0) {
    const uint32_t prefix = publish_tile(scratch + 1, tile, tile_count, lane);
    if (lane == 0) {
      s_prefix = prefix;
      if (tile == gridDim.x - 1) *count = (int32_t)(prefix + tile_count);
    }
  }
  __syncthreads();

  // 5. The writes, row by row. A segment's word is written once, by the
  // lane that holds its last row: with a plain store where the
  // segment's rows all lie in this warp's, else with atomicOr (a segment
  // that began before the warp's rows, or runs to their end). The first
  // row of each k-mer writes its union words.
  long long col = (long long)s_prefix + warp_base + below - 1;
  long long seg_col = col;
  int seg_word = (int)(gid[0] >> 5);
  bool open = true;  // the segment began before this lane's rows
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const uint32_t g = gid[i];
    if ((starts >> i) & 1) {
      if (i > 0) {
        write_word(matrix, seg_word, seg_col, k_budget,
                   open ? acc | carry : acc, open && (since & lt) == 0);
      }
      open = false;
      acc = 0;
      seg_word = (int)(g >> 5);
      seg_col = col + ((firsts >> i) & 1);
    }
    if ((firsts >> i) & 1) {
      ++col;
      if (col < k_budget) {
        long long kmer[P];
#pragma unroll
        for (int p = 0; p < P; ++p) kmer[p] = s_key[p][slot0 + i];
        put_union<P>(union_words + col * nw, kmer, nw);
      }
    }
    acc |= genome_bit(g, n_words);
  }
  if (lane == 31 || ((row0_start >> (lane + 1)) & 1) != 0) {
    write_word(matrix, seg_word, seg_col, k_budget, upto,
               lane == 31 || since == 0);
  }
}

template <int P>
int launch_build_columns(const void* keys, long long n, const void* valid,
                         const void* perm, unsigned magic, int shift,
                         int n_words, long long k_budget, int nw,
                         void* matrix, void* union_words, void* scratch,
                         void* count, long long n_tiles,
                         cudaStream_t stream) {
  build_columns_tile_kernel<P><<<(unsigned)n_tiles, kBuildThreads, 0,
                                 stream>>>(
      (const long long*)keys, n, (const uint8_t*)valid,
      (const long long*)perm, magic, shift, n_words, k_budget, nw,
      (uint32_t*)matrix, (int32_t*)union_words,
      (unsigned long long*)scratch, (int32_t*)count);
  return (int)cudaGetLastError();
}

// K3: merge_columns in one pass (see the header).
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kMergeBlocks = 4;  // an SM: at most 64 registers a thread
// One row of the batch table a batch, in concatenation order: its matrix
// (wb, bucket) int32's address, its first concatenated row, its bucket,
// wb, and its first word row in the final matrix.
constexpr int kBatchFields = 5;
// The dynamic shared memory: four words a batch (16 KB at the most).
constexpr int kMaxMergeBatches = 1024;
constexpr uint32_t kNoRow = 0xFFFFFFFFu;

// Rows a lane takes from its warp's chunk, by key planes: a tile is
// kMergeThreads * R rows.
__host__ __device__ constexpr int merge_rows(int P) {
  return P == 1 ? 8 : (P == 2 ? 4 : 2);
}

// The batch of input position p: the last whose first row is at most p.
__device__ __forceinline__ int batch_of(const uint32_t* row0, int n_batches,
                                        uint32_t p) {
  int lo = 0, hi = n_batches - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (row0[mid] <= p) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The final matrix (w_total, k_budget) and the merged union (k_budget,
// nw), both zeroed, the merged count into count; scratch is 1 + n_tiles
// zeroed words: the tile counter, then one status a tile. The dynamic
// shared memory holds four words a batch.
template <int P>
__global__ void __launch_bounds__(kMergeThreads, kMergeBlocks)
    merge_columns_tile_kernel(
    const long long* __restrict__ keys, long long n,
    const uint8_t* __restrict__ valid, const long long* __restrict__ perm,
    const long long* __restrict__ batches, int n_batches, long long k_budget,
    int nw, int32_t* __restrict__ final_matrix,
    int32_t* __restrict__ union_words,
    unsigned long long* __restrict__ scratch, int32_t* __restrict__ count) {
  constexpr int R = merge_rows(P);
  constexpr int kTile = kMergeThreads * R;
  // A batch's first concatenated row; the least batch column of its rows
  // in the tile, their number, their first slot in the tile's bins.
  extern __shared__ uint32_t s_batch[];
  uint32_t* s_row0 = s_batch;
  uint32_t* s_jmin = s_row0 + n_batches;
  uint32_t* s_size = s_jmin + n_batches;
  uint32_t* s_off = s_size + n_batches;
  // The tile's valid rows binned by batch, in batch-column order: each
  // slot's batch, its batch word (word row 0) and its merged column.
  __shared__ uint16_t s_bat[kTile];
  __shared__ int32_t s_word[kTile];
  __shared__ uint32_t s_col[kTile];
  __shared__ long long s_tile;
  __shared__ int s_state;  // 0 padding, 1 valid rows, 2 and the last one
  __shared__ uint32_t s_count[kMergeWarps];
  __shared__ uint32_t s_prefix, s_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool keyed = valid == nullptr;  // validity from plane 0's key
  if (threadIdx.x == 0) {
    const long long tile = (long long)atomicAdd(scratch, 1ull);
    const long long end = (tile + 1) * kTile;
    int state = 0;
    if (keyed ? keys[tile * kTile] != kInvalidKey : valid[tile * kTile]) {
      state = end >= n || (keyed ? keys[end] == kInvalidKey : !valid[end])
                  ? 2 : 1;
    } else if (tile == 0) {
      *count = 0;  // no valid row
    }
    s_tile = tile;
    s_state = state;
  }
  __syncthreads();
  // A padding tile: every row from its first on is invalid.
  if (s_state == 0) return;
  const long long tile = s_tile;
  const long long c0 = tile * kTile + (long long)warp * 32 * R;

  // 1. The warp's chunk, row c0 + 32 i + lane at step i, every load
  // issued before any is used (the row clamped into [0, n)); perm by its
  // low 32-bit word (perm < 2^31). Lane 0 reads the row before the chunk.
  long long key[R][P];
  uint32_t at[R];
  bool ok[R];
  const uint32_t* perm_lo = reinterpret_cast<const uint32_t*>(perm);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long r = min(c0 + 32 * i + lane, n - 1);
#pragma unroll
    for (int p = 0; p < P; ++p) key[i][p] = keys[p * n + r];
    at[i] = perm_lo[2 * r];
    ok[i] = keyed || valid[r] != 0;
  }
  long long before[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    before[p] = lane == 0 && c0 > 0 ? keys[p * n + min(c0, n) - 1]
                                    : kInvalidKey;
  }
  for (int b = threadIdx.x; b < n_batches; b += kMergeThreads) {
    s_row0[b] = (uint32_t)batches[b * kBatchFields + 1];
    s_jmin[b] = kNoRow;
    s_size[b] = 0;
  }

  // 2. Bit l of firsts[i]: lane l's row at step i is valid and the first
  // of its k-mer (its key differs from the lane below's, from lane 31's
  // at step i - 1, or from the row before the chunk).
  uint32_t firsts[R];
  uint32_t warp_count = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long row = c0 + 32 * i + lane;
    ok[i] = ok[i] && row < n && (!keyed || key[i][0] != kInvalidKey);
    bool is_new = row == 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long last = i > 0 ? key[i - 1][p] : before[p];
      const long long up = __shfl_up_sync(kFull, key[i][p], 1);
      const long long step = __shfl_sync(kFull, last, i > 0 ? 31 : 0);
      is_new |= (lane == 0 ? step : up) != key[i][p];
    }
    firsts[i] = __ballot_sync(kFull, ok[i] && is_new);
    warp_count += __popc(firsts[i]);
  }
  if (lane == 0) s_count[warp] = warp_count;
  __syncthreads();

  // 3. The tile's count published at once (kAggregate), so that later
  // tiles need not wait for this one's bins. Each valid row's batch b and
  // batch column j: a batch holds a k-mer once and its rows come in the
  // order of its own sorted union, so the tile's rows of batch b have
  // consecutive batch columns from s_jmin[b] on. The lowest lane of a
  // warp's rows of one batch holds their least column.
  uint32_t tile_count = 0, warp_base = 0;
#pragma unroll
  for (int w = 0; w < kMergeWarps; ++w) {
    const uint32_t c = s_count[w];
    warp_base += w < warp ? c : 0u;
    tile_count += c;
  }
  unsigned long long* status = scratch + 1;
  if (threadIdx.x == 0 && tile > 0) {
    store_status(status + tile, kAggregate | tile_count);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int b = ok[i] ? batch_of(s_row0, n_batches, at[i]) : -1;
    const uint32_t peers = __match_any_sync(kFull, b);
    if (b >= 0 && lane == __ffs(peers) - 1) {
      atomicMin(s_jmin + b, at[i] - s_row0[b]);
      atomicAdd(s_size + b, (uint32_t)__popc(peers));
    }
  }
  __syncthreads();

  // 4. Each batch's first slot: an exclusive scan of the sizes.
  if (warp == 0) {
    uint32_t carry = 0;
    for (int b0 = 0; b0 < n_batches; b0 += 32) {
      const int b = b0 + lane;
      const uint32_t size = b < n_batches ? s_size[b] : 0u;
      uint32_t sum = size;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t o = __shfl_up_sync(kFull, sum, d);
        if (lane >= d) sum += o;
      }
      if (b < n_batches) s_off[b] = carry + sum - size;
      carry += __shfl_sync(kFull, sum, 31);
    }
    if (lane == 0) s_total = carry;
  }
  __syncthreads();

  // 5. Each valid row's slot, kept in at[i] from here on.
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!ok[i]) continue;
    const int b = batch_of(s_row0, n_batches, at[i]);
    at[i] = s_off[b] + (at[i] - s_row0[b]) - s_jmin[b];
    s_bat[at[i]] = (uint16_t)b;
  }
  __syncthreads();

  // 6. The batch words of word row 0 by slot, consecutive slots of a batch
  // on consecutive batch columns (coalesced reads); then the look-back.
  const int total = (int)s_total;
  for (int e = threadIdx.x; e < total; e += kMergeThreads) {
    const int b = s_bat[e];
    const int32_t* src = reinterpret_cast<const int32_t*>(
        __ldg(batches + b * kBatchFields));
    s_word[e] = __ldg(src + s_jmin[b] + (e - s_off[b]));
  }
  if (warp == 0) {
    uint32_t prefix = 0;
    if (tile > 0) prefix = lookback_prefix(status, tile, lane);
    if (lane == 0) {
      store_status(status + tile, kInclusive | (prefix + tile_count));
      s_prefix = prefix;
      if (s_state == 2) *count = (int32_t)(prefix + tile_count);
    }
  }
  __syncthreads();

  // 7. Each valid row's merged column, the count of firsts up to it less
  // one, into its slot; the first row of each k-mer writes the union
  // words.
  const uint32_t upto = (2u << lane) - 1;  // lanes up to this one
  long long base = (long long)s_prefix + warp_base - 1;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long col = base + __popc(firsts[i] & upto);
    base += __popc(firsts[i]);
    if (!ok[i]) continue;
    s_col[at[i]] = (uint32_t)min(col, k_budget);
    if (((firsts[i] >> lane) & 1) && col < k_budget) {
      put_union<P>(union_words + col * nw, key[i], nw);
    }
  }
  __syncthreads();

  // 8. The words to the final matrix by slot, plain stores: a batch's
  // slots on increasing merged columns of its own word rows (the batches
  // own disjoint word rows, and a batch holds a k-mer once).
  for (int e = threadIdx.x; e < total; e += kMergeThreads) {
    const long long col = s_col[e];
    if (col >= k_budget) continue;
    const long long* t = batches + s_bat[e] * kBatchFields;
    int32_t* dst = final_matrix + __ldg(t + 4) * k_budget + col;
    dst[0] = s_word[e];
    const int wb = (int)__ldg(t + 3);
    if (wb > 1) {
      const long long bucket = __ldg(t + 2);
      const int32_t* src = reinterpret_cast<const int32_t*>(__ldg(t)) +
                           s_jmin[s_bat[e]] + (e - s_off[s_bat[e]]);
      for (int w = 1; w < wb; ++w) dst[w * k_budget] = src[w * bucket];
    }
  }
}

template <int P>
int launch_merge_columns(const void* keys, long long n, const void* valid,
                         const void* perm, const void* batches,
                         int n_batches, long long k_budget, int nw,
                         void* final_matrix, void* union_words,
                         void* scratch, void* count, long long n_tiles,
                         cudaStream_t stream) {
  merge_columns_tile_kernel<P><<<(unsigned)n_tiles, kMergeThreads,
                                 4 * n_batches * sizeof(uint32_t), stream>>>(
      (const long long*)keys, n, (const uint8_t*)valid,
      (const long long*)perm, (const long long*)batches, n_batches, k_budget,
      nw, (int32_t*)final_matrix, (int32_t*)union_words,
      (unsigned long long*)scratch, (int32_t*)count);
  return (int)cudaGetLastError();
}

// K4: compact_columns in one pass (see the header).
constexpr int kCompactThreads = 512;  // a tile: one column a thread
constexpr int kCompactWarps = kCompactThreads / 32;

// The compacted matrix (W, K) and union (K, nw), both zeroed, the kept
// count into count; scratch is 1 + n_tiles zeroed words, as for K3.
__global__ void __launch_bounds__(kCompactThreads) compact_columns_tile_kernel(
    const int32_t* __restrict__ matrix, const int32_t* __restrict__ union_in,
    int n_words, long long n_cols, int nw,
    const int32_t* __restrict__ n_kmers, int32_t* __restrict__ out,
    int32_t* __restrict__ union_out,
    unsigned long long* __restrict__ scratch, int32_t* __restrict__ count) {
  __shared__ long long s_tile, s_live;
  __shared__ int s_state;  // 0 past the live columns, 1 live, 2 the last
  __shared__ uint32_t s_count[kCompactWarps];
  __shared__ uint32_t s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const long long tile = (long long)atomicAdd(scratch, 1ull);
    const long long live = min((long long)max(*n_kmers, 0), n_cols);
    int state = 0;
    if (tile * kCompactThreads < live) {
      state = (tile + 1) * kCompactThreads >= live ? 2 : 1;
    } else if (tile == 0) {
      *count = 0;  // no live column
    }
    s_tile = tile;
    s_live = live;
    s_state = state;
  }
  __syncthreads();
  if (s_state == 0) return;
  const long long tile = s_tile;
  const long long live = s_live;
  const long long c = tile * kCompactThreads + threadIdx.x;  // the column

  // 1. The column's genomes over its W words, each word row read
  // coalesced across the lanes (the column clamped into the live ones).
  const int32_t* at = matrix + min(c, live - 1);
  uint32_t genomes = 0;
  for (int w = 0; w < n_words; ++w) {
    genomes += __popc((uint32_t)__ldg(at + w * n_cols));
  }
  const uint32_t keeps = __ballot_sync(kFull, c < live && genomes != 1);

  // 2. The tile's prefix, as in K3; the tile that holds the last live
  // column writes the count.
  if (lane == 0) s_count[warp] = __popc(keeps);
  __syncthreads();
  uint32_t tile_count = 0, warp_base = 0;
#pragma unroll
  for (int w = 0; w < kCompactWarps; ++w) {
    const uint32_t n = s_count[w];
    warp_base += w < warp ? n : 0u;
    tile_count += n;
  }
  if (warp == 0) {
    const uint32_t prefix = publish_tile(scratch + 1, tile, tile_count, lane);
    if (lane == 0) {
      s_prefix = prefix;
      if (s_state == 2) *count = (int32_t)(prefix + tile_count);
    }
  }
  __syncthreads();

  // 3. A kept column's words to its compacted position, the keeps before
  // it in the launch (the second read hits the cache the first filled).
  if (((keeps >> lane) & 1) == 0) return;
  const long long pos =
      (long long)s_prefix + warp_base + __popc(keeps & ((1u << lane) - 1));
  for (int w = 0; w < n_words; ++w) {
    out[(long long)w * n_cols + pos] = __ldg(at + w * n_cols);
  }
  for (int j = 0; j < nw; ++j) union_out[pos * nw + j] = union_in[c * nw + j];
}

}  // namespace

// The tiles of a build_columns launch over n rows of n_pairs key planes.
extern "C" long long grm_build_columns_tiles(int n_pairs, long long n) {
  const long long tile = (long long)kBuildThreads * build_rows(n_pairs);
  return (n + tile - 1) / tile;
}

// scratch: 1 + grm_build_columns_tiles(n_pairs, n) zeroed 64-bit words.
extern "C" int grm_build_columns(const void* keys, int n_pairs, long long n,
                                 const void* valid, const void* perm,
                                 unsigned magic, int shift, int n_words,
                                 long long k_budget, int nw, void* matrix,
                                 void* union_words, void* scratch,
                                 void* count, void* stream) {
  const long long tiles = grm_build_columns_tiles(n_pairs, n);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_pairs) {
    case 1:
      return launch_build_columns<1>(keys, n, valid, perm, magic, shift,
                                     n_words, k_budget, nw, matrix,
                                     union_words, scratch, count, tiles, s);
    case 2:
      return launch_build_columns<2>(keys, n, valid, perm, magic, shift,
                                     n_words, k_budget, nw, matrix,
                                     union_words, scratch, count, tiles, s);
    case 3:
      return launch_build_columns<3>(keys, n, valid, perm, magic, shift,
                                     n_words, k_budget, nw, matrix,
                                     union_words, scratch, count, tiles, s);
    case 4:
      return launch_build_columns<4>(keys, n, valid, perm, magic, shift,
                                     n_words, k_budget, nw, matrix,
                                     union_words, scratch, count, tiles, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tiles of a merge_columns launch over n rows of n_pairs key planes.
extern "C" long long grm_merge_columns_tiles(int n_pairs, long long n) {
  const long long tile = (long long)kMergeThreads * merge_rows(n_pairs);
  return (n + tile - 1) / tile;
}

// batches: n_batches rows of kBatchFields int64 on the device; scratch:
// 1 + grm_merge_columns_tiles(n_pairs, n) zeroed 64-bit words.
extern "C" int grm_merge_columns(const void* keys, int n_pairs, long long n,
                                 const void* valid, const void* perm,
                                 const void* batches, int n_batches,
                                 long long k_budget, int nw,
                                 void* final_matrix, void* union_words,
                                 void* scratch, void* count, void* stream) {
  if (n_batches < 1 || n_batches > kMaxMergeBatches) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = grm_merge_columns_tiles(n_pairs, n);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_pairs) {
    case 1:
      return launch_merge_columns<1>(keys, n, valid, perm, batches,
                                     n_batches, k_budget, nw, final_matrix,
                                     union_words, scratch, count, tiles, s);
    case 2:
      return launch_merge_columns<2>(keys, n, valid, perm, batches,
                                     n_batches, k_budget, nw, final_matrix,
                                     union_words, scratch, count, tiles, s);
    case 3:
      return launch_merge_columns<3>(keys, n, valid, perm, batches,
                                     n_batches, k_budget, nw, final_matrix,
                                     union_words, scratch, count, tiles, s);
    case 4:
      return launch_merge_columns<4>(keys, n, valid, perm, batches,
                                     n_batches, k_budget, nw, final_matrix,
                                     union_words, scratch, count, tiles, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tiles of a compact_columns launch over n_cols columns.
extern "C" long long grm_compact_columns_tiles(long long n_cols) {
  return (n_cols + kCompactThreads - 1) / kCompactThreads;
}

// scratch: 1 + grm_compact_columns_tiles(n_cols) zeroed 64-bit words.
extern "C" int grm_compact_columns(const void* matrix, const void* union_in,
                                   int n_words, long long n_cols, int nw,
                                   const void* n_kmers, void* out,
                                   void* union_out, void* scratch,
                                   void* count, void* stream) {
  compact_columns_tile_kernel<<<(unsigned)grm_compact_columns_tiles(n_cols),
                                kCompactThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)matrix, (const int32_t*)union_in, n_words, n_cols, nw,
      (const int32_t*)n_kmers, (int32_t*)out, (int32_t*)union_out,
      (unsigned long long*)scratch, (int32_t*)count);
  return (int)cudaGetLastError();
}
