// Device ingest for Hopper (sm_90a): the steps of the packed presence
// matrix's build that follow the window sort.
//
// Replaces the XLA programs of grm_tpu/parallel/device_build.py (none is a
// pallas_call):
//
//   build_columns (K2)   _build after the sort (:92-140): the new-k-mer
//                        flags, the duplicate (k-mer, genome) mask, each
//                        row's union column from a scan of the flags, the
//                        genome bits scattered into the packed (W, k_budget)
//                        matrix, the union words.
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
// `perm` is each sorted row's input position. Every scan is a torch.cumsum
// of the flags between two launches (an inclusive int32 scan).
//
// What bounds them on the H100: device memory. K2 reads each row's key,
// permutation entry and scan once (20 bytes a row at n_pairs = 1, plus the
// flags written and read by the scan) and writes a few bytes of matrix and
// union per distinct k-mer; K3 likewise per union row; K4 reads and writes
// each column once. The arithmetic is a few integer operations a row.
//
// What the design does about it: one thread per row, neighbouring threads
// on neighbouring rows, so every read is coalesced. In K2 a warp ORs the
// genome bits that share a matrix word (their segment key col * W + word is
// non-decreasing along the sorted rows) with a segmented shuffle scan, and
// the last lane of each segment issues one atomicOr: a k-mer that all 32
// genomes of a word hold costs one atomic, not 32. Only the first row of a
// k-mer writes its union words. Rows past k_budget are dropped, as XLA's
// out-of-range scatters drop them, and the caller raises.
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

// K2's second launch: genome bits into matrix (W, k_budget), union words
// into union_words (k_budget, nw). Row i is window perm[i] % n_cols of
// genome perm[i] / n_cols.
__global__ void __launch_bounds__(kThreads) build_columns_kernel(
    const long long* __restrict__ keys, int n_pairs, long long n,
    const uint8_t* __restrict__ valid, const long long* __restrict__ perm,
    const int32_t* __restrict__ scan, long long n_cols, int n_words,
    long long k_budget, int nw, uint32_t* __restrict__ matrix,
    int32_t* __restrict__ union_words) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long seg = LLONG_MAX;  // col * n_words + word; LLONG_MAX: no write
  long long addr = 0;
  uint32_t bits = 0;
  if (i < n && row_valid(keys, valid, i)) {
    const long long col = (long long)scan[i] - 1;
    if (col < k_budget) {
      const bool is_new = row_new(keys, n_pairs, n, i);
      const long long gid = perm[i] / n_cols;
      const bool dup = !is_new && perm[i - 1] / n_cols == gid;
      const int word = (int)(gid >> 5);
      seg = col * n_words + word;
      addr = (long long)word * k_budget + col;
      if (!dup) bits = 1u << (31 - (int)(gid & 31));
      if (is_new) write_union(keys, n, i, col, nw, union_words);
    }
  }
  // Segmented inclusive OR over the lanes of equal seg (contiguous, since
  // seg does not decrease along the rows).
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t other = __shfl_up_sync(0xFFFFFFFFu, bits, d);
    const long long other_seg = __shfl_up_sync(0xFFFFFFFFu, seg, d);
    if (lane >= d && other_seg == seg) bits |= other;
  }
  const long long next_seg = __shfl_down_sync(0xFFFFFFFFu, seg, 1);
  if ((lane == 31 || next_seg != seg) && seg != LLONG_MAX && bits != 0) {
    atomicOr(matrix + addr, bits);
  }
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

extern "C" int grm_build_columns(const void* keys, int n_pairs, long long n,
                                 const void* valid, const void* perm,
                                 const void* scan, long long n_cols,
                                 int n_words, long long k_budget, int nw,
                                 void* matrix, void* union_words,
                                 void* stream) {
  build_columns_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, n_pairs, n, (const uint8_t*)valid,
      (const long long*)perm, (const int32_t*)scan, n_cols, n_words, k_budget,
      nw, (uint32_t*)matrix, (int32_t*)union_words);
  return (int)cudaGetLastError();
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
