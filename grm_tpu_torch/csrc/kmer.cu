// Canonical k-mer windows for Hopper (sm_90a): for every window start t of
// every genome row g of the (G, L) int8 codes (A=0 C=1 G=2 T=3, 4 = an
// invalid base or a contig separator), the canonical words of the window
// (the lexicographic minimum of the forward window and its reverse
// complement), its validity and, for k <= 31, its sort key.
//
// Replaces grm_tpu/ops/kmer.py:137 _extract_canon with its helpers
// _sliding_pack16 (:81), _window_words (:92) and _lex_less (:128), which
// XLA ran under vmap over the genomes of a batch
// (grm_tpu/parallel/device_build.py:69). Outputs, bit for bit as there:
//
//   words (nw, G, L) int32: word j holds bases [16j, 16j + 16) MSB-first,
//       the last word only the top 2r bits (r = k - 16 (nw - 1)). Bases past
//       the row count as A; the reverse complement of a window that runs past
//       the row (t > L - k) is zero.
//   valid (G, L) uint8: no base >= 4 in [t, t + k) and t <= L - k.
//   key (G, L) int64 (k <= 31): ((w0 << 32) | w1) ^ 2^63 for a valid
//       window (w1 = 0 when nw = 1), 2^63 - 1 for an invalid one, so that
//       torch.sort of the signed keys orders [invalid, words].
//
// Each output is skipped where its pointer is null.
//
// What bounds it on the H100: device memory. A window reads one code byte
// and writes nw * 4 + 1 (+ 8) bytes; the k-base pack is some 2k integer
// operations, well under the memory time at the card's integer rate.
//
// What the design does about it: a block stages kTile + k - 1 codes of one
// row in shared memory with coalesced loads, then one thread per window
// packs the k bases from shared memory (neighbouring threads read
// neighbouring bytes: no bank conflict), building the forward words in
// place and the reverse complement by pushing each complemented base in at
// the front, in registers (NW is a template argument, so both stay in
// registers). Neighbouring threads write neighbouring windows: every store
// is coalesced.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // windows a block
constexpr int kMaxK = 128;

template <int NW>
__global__ void __launch_bounds__(kThreads) kmer_canon_kernel(
    const int8_t* __restrict__ codes, long long n_cols, int k,
    long long plane, int32_t* __restrict__ words,
    uint8_t* __restrict__ valid, long long* __restrict__ key) {
  __shared__ int8_t s[kTile + kMaxK];
  const long long row = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * kTile;
  const int8_t* src = codes + row * n_cols;
  for (int i = threadIdx.x; i < kTile + k - 1; i += kThreads) {
    const long long pos = t0 + i;
    s[i] = pos < n_cols ? src[pos] : (int8_t)4;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < kTile; w += kThreads) {
    const long long t = t0 + w;
    if (t >= n_cols) break;
    uint32_t fwd[NW], rc[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) fwd[j] = rc[j] = 0;
    bool bad = false;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (16 * j + i < k) {
          const int c = s[w + 16 * j + i];
          bad |= c >= 4;
          const uint32_t b = (uint32_t)c & 3u;
          fwd[j] |= b << (30 - 2 * i);
          // The reverse complement: every base so far moves one place
          // back and the complement of this one takes place 0.
#pragma unroll
          for (int q = NW - 1; q > 0; --q) {
            rc[q] = (rc[q] >> 2) | (rc[q - 1] << 30);
          }
          rc[0] = (rc[0] >> 2) | ((3u - b) << 30);
        }
      }
    }
    if (t > n_cols - k) {
#pragma unroll
      for (int j = 0; j < NW; ++j) rc[j] = 0;
    }
    // use_rc = rc < fwd, lexicographically over the words.
    bool use_rc = false;
#pragma unroll
    for (int j = NW - 1; j >= 0; --j) {
      use_rc = (rc[j] < fwd[j]) || ((rc[j] == fwd[j]) && use_rc);
    }
    const long long at = row * n_cols + t;
    if (words != nullptr) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        words[j * plane + at] = (int32_t)(use_rc ? rc[j] : fwd[j]);
      }
    }
    if (valid != nullptr) valid[at] = bad ? 0 : 1;
    if (key != nullptr) {
      const uint64_t hi = use_rc ? rc[0] : fwd[0];
      uint64_t lo = 0;
      if constexpr (NW > 1) lo = use_rc ? rc[1] : fwd[1];
      key[at] = bad ? (long long)0x7FFFFFFFFFFFFFFFull
                    : (long long)(((hi << 32) | lo) ^ 0x8000000000000000ull);
    }
  }
}

template <int NW>
void launch(const int8_t* codes, int n_rows, long long n_cols, int k,
            int32_t* words, uint8_t* valid, long long* key,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((n_cols + kTile - 1) / kTile), n_rows);
  kmer_canon_kernel<NW><<<grid, kThreads, 0, stream>>>(
      codes, n_cols, k, (long long)n_rows * n_cols, words, valid, key);
}

}  // namespace

// codes (n_rows, n_cols) int8; words (nw, n_rows, n_cols) int32, valid
// (n_rows, n_cols) uint8 and key (n_rows, n_cols) int64, each nullable.
extern "C" int grm_kmer_canon(const void* codes, int n_rows, long long n_cols,
                              int k, void* words, void* valid, void* key,
                              void* stream) {
  const int nw = (k + 15) / 16;
  if (k < 1 || k > kMaxK || (key != nullptr && k > 31) || n_rows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int8_t* c = (const int8_t*)codes;
  int32_t* w = (int32_t*)words;
  uint8_t* v = (uint8_t*)valid;
  long long* y = (long long*)key;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nw) {
    case 1: launch<1>(c, n_rows, n_cols, k, w, v, y, s); break;
    case 2: launch<2>(c, n_rows, n_cols, k, w, v, y, s); break;
    case 3: launch<3>(c, n_rows, n_cols, k, w, v, y, s); break;
    case 4: launch<4>(c, n_rows, n_cols, k, w, v, y, s); break;
    case 5: launch<5>(c, n_rows, n_cols, k, w, v, y, s); break;
    case 6: launch<6>(c, n_rows, n_cols, k, w, v, y, s); break;
    case 7: launch<7>(c, n_rows, n_cols, k, w, v, y, s); break;
    default: launch<8>(c, n_rows, n_cols, k, w, v, y, s); break;
  }
  return (int)cudaGetLastError();
}
