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
//   merge_columns (K3)   _merge_ranks (:158): each row's merged column
//                        (dest) after the merge sort, and the merged union;
//                        _scatter_batch_columns (:207): a batch's word rows
//                        placed at dest in the final matrix.
//   compact_columns (K4) _compact_singletons (:222) and _build's filter
//                        (:142): the stable left compaction of the columns
//                        present in at least two genomes, matrix and union.
//                        Its column counts come from popcount_colsum with an
//                        all-ones mask.
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
// K3 and K4, what bounds them: device memory, likewise; K3 reads each
// union row's key, permutation entry and scan once, K4 reads and writes
// each column once. The arithmetic is a few integer operations a row.
// Each is a flags launch, a torch.cumsum of the flags between two launches
// (an inclusive int32 scan) and a write launch, one thread per row or
// column, neighbouring threads on neighbouring rows, so every read is
// coalesced. Only the first row of a k-mer writes its union words.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kInvalidKey = LLONG_MAX;
constexpr int kTrash = INT_MAX;  // dest of an invalid merge row

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ bool row_valid(const long long* keys,
                                          const uint8_t* valid,
                                          long long i) {
  return valid != nullptr ? valid[i] != 0 : keys[i] != kInvalidKey;
}

__device__ __forceinline__ bool row_new(const long long* keys, int n_pairs,
                                        long long n, long long i) {
  if (i == 0) return true;
  for (int p = 0; p < n_pairs; ++p) {
    if (keys[p * n + i] != keys[p * n + i - 1]) return true;
  }
  return false;
}

// k-mer word j of sorted row i.
__device__ __forceinline__ int32_t key_word(const long long* keys,
                                            long long n, long long i, int j) {
  const unsigned long long u =
      (unsigned long long)keys[(j / 2) * n + i] ^ 0x8000000000000000ull;
  return (int32_t)(uint32_t)(j % 2 == 0 ? u >> 32 : u);
}

__device__ __forceinline__ void write_union(const long long* keys,
                                            long long n, long long i,
                                            long long col, int nw,
                                            int32_t* union_words) {
  for (int j = 0; j < nw; ++j) {
    union_words[col * nw + j] = key_word(keys, n, i, j);
  }
}

// flags[i] = 1 where row i is valid and the first of its k-mer.
__global__ void __launch_bounds__(kThreads) columns_flags_kernel(
    const long long* __restrict__ keys, int n_pairs, long long n,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ flags) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  flags[i] = row_valid(keys, valid, i) && row_new(keys, n_pairs, n, i);
}

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
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
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
    unsigned long long* status = scratch + 1;
    uint32_t prefix = 0;
    if (tile > 0) {
      if (lane == 0) store_status(status + tile, kAggregate | tile_count);
      prefix = lookback_prefix(status, tile, lane);
    }
    if (lane == 0) {
      store_status(status + tile, kInclusive | (prefix + tile_count));
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
        int32_t* u = union_words + col * nw;
        const int slot = slot0 + i;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const unsigned long long w =
              (unsigned long long)s_key[p][slot] ^ 0x8000000000000000ull;
          if (nw % 2 == 0 && 2 * p + 1 < nw) {  // 8-byte aligned: hi, lo
            *reinterpret_cast<unsigned long long*>(u + 2 * p) =
                (w << 32) | (w >> 32);
          } else if (2 * p < nw) {
            u[2 * p] = (int32_t)(uint32_t)(w >> 32);
            if (2 * p + 1 < nw) u[2 * p + 1] = (int32_t)(uint32_t)w;
          }
        }
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

// K3's second launch: dest (input position order) and the merged union.
__global__ void __launch_bounds__(kThreads) merge_dest_kernel(
    const long long* __restrict__ keys, int n_pairs, long long n,
    const uint8_t* __restrict__ valid, const long long* __restrict__ perm,
    const int32_t* __restrict__ scan, long long k_budget, int nw,
    int32_t* __restrict__ dest, int32_t* __restrict__ union_words) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool ok = row_valid(keys, valid, i);
  const long long col = (long long)scan[i] - 1;
  dest[perm[i]] = ok ? (int32_t)col : kTrash;
  if (ok && col < k_budget && row_new(keys, n_pairs, n, i)) {
    write_union(keys, n, i, col, nw, union_words);
  }
}

// K3's column scatter: batch column j (of `bucket`) to final column
// dest[j], word rows [w_off, w_off + wb).
__global__ void __launch_bounds__(kThreads) scatter_columns_kernel(
    const int32_t* __restrict__ batch, int wb, long long bucket,
    const int32_t* __restrict__ dest, int32_t* __restrict__ final_matrix,
    int w_off, long long k_budget) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= bucket) return;
  const long long d = dest[j];
  if (d < 0 || d >= k_budget || d == kTrash) return;
  for (int w = 0; w < wb; ++w) {
    final_matrix[(long long)(w_off + w) * k_budget + d] =
        batch[(long long)w * bucket + j];
  }
}

// K4's first launch: keep the live columns not present in exactly one
// genome.
__global__ void __launch_bounds__(kThreads) compact_flags_kernel(
    const int32_t* __restrict__ counts, long long n_cols,
    const int32_t* __restrict__ n_kmers, int32_t* __restrict__ flags) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_cols) return;
  flags[c] = c < (long long)*n_kmers && counts[c] != 1;
}

// K4's second launch: kept column c to column scan[c] - 1.
__global__ void __launch_bounds__(kThreads) compact_gather_kernel(
    const int32_t* __restrict__ matrix, const int32_t* __restrict__ union_in,
    int n_words, long long n_cols, int nw, const int32_t* __restrict__ scan,
    int32_t* __restrict__ out, int32_t* __restrict__ union_out) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_cols) return;
  const int32_t s = scan[c];
  if (s == (c > 0 ? scan[c - 1] : 0)) return;
  const long long p = s - 1;
  for (int w = 0; w < n_words; ++w) {
    out[(long long)w * n_cols + p] = matrix[(long long)w * n_cols + c];
  }
  for (int j = 0; j < nw; ++j) union_out[p * nw + j] = union_in[c * nw + j];
}

}  // namespace

extern "C" int grm_columns_flags(const void* keys, int n_pairs, long long n,
                                 const void* valid, void* flags,
                                 void* stream) {
  columns_flags_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, n_pairs, n, (const uint8_t*)valid,
      (int32_t*)flags);
  return (int)cudaGetLastError();
}

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

extern "C" int grm_merge_dest(const void* keys, int n_pairs, long long n,
                              const void* valid, const void* perm,
                              const void* scan, long long k_budget, int nw,
                              void* dest, void* union_words, void* stream) {
  merge_dest_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, n_pairs, n, (const uint8_t*)valid,
      (const long long*)perm, (const int32_t*)scan, k_budget, nw,
      (int32_t*)dest, (int32_t*)union_words);
  return (int)cudaGetLastError();
}

extern "C" int grm_scatter_columns(const void* batch, int wb,
                                   long long bucket, const void* dest,
                                   void* final_matrix, int w_off,
                                   long long k_budget, void* stream) {
  scatter_columns_kernel<<<blocks_for(bucket), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)batch, wb, bucket, (const int32_t*)dest,
      (int32_t*)final_matrix, w_off, k_budget);
  return (int)cudaGetLastError();
}

extern "C" int grm_compact_flags(const void* counts, long long n_cols,
                                 const void* n_kmers, void* flags,
                                 void* stream) {
  compact_flags_kernel<<<blocks_for(n_cols), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)counts, n_cols, (const int32_t*)n_kmers,
      (int32_t*)flags);
  return (int)cudaGetLastError();
}

extern "C" int grm_compact_gather(const void* matrix, const void* union_in,
                                  int n_words, long long n_cols, int nw,
                                  const void* scan, void* out,
                                  void* union_out, void* stream) {
  compact_gather_kernel<<<blocks_for(n_cols), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)matrix, (const int32_t*)union_in, n_words, n_cols, nw,
      (const int32_t*)scan, (int32_t*)out, (int32_t*)union_out);
  return (int)cudaGetLastError();
}
