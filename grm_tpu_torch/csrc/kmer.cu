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
//       the row count as A (c & 3); the reverse complement of a window that
//       runs past the row (t > L - k) is zero.
//   valid (G, L) uint8: no base >= 4 in [t, t + k) and t <= L - k.
//   key (G, L) int64 (k <= 31): ((w0 << 32) | w1) ^ 2^63 for a valid
//       window (w1 = 0 when nw = 1), 2^63 - 1 for an invalid one, so that
//       torch.sort of the signed keys orders [invalid, words].
//
// Each output is skipped where its pointer is null; the key is one launch
// (kmer_canon_kernel<nw, true>), words and validity another (<nw, false>).
//
// What bounds it on the H100: device memory, 1 code byte in and 8 key bytes
// out a window (0.38 ms at 3.35 TB/s for a batch of 140.9M windows),
// provided a window costs O(1) integer work. Packing the k bases of every window anew costs
// O(k) operations (about 400 a window at k = 31) and makes the integer
// issue, not the bytes, the limit.
//
// What the design does about it: a block takes one row and a tile of
// kThreads * R consecutive windows; a thread takes a run of R consecutive
// windows and ROLLS through it. Its registers hold the forward words and
// the reverse-complement words of the current window, in the left-aligned
// output layout: a new base shifts the forward words left by one base
// (funnel shifts across words) and enters at the last word's lowest base,
// and enters the reverse complement at the front of word 0 while the
// reverse words shift right and the last word drops its oldest base (the
// mask to its top 2r bits). A run-length counter of valid bases gives the
// validity: a window is valid iff the last k bases were all < 4, and since
// the row is padded with 4s past its end, that also rejects t > L - k. A
// run first warms up on the k - 1 bases before its first window (one
// base more for each base that rounds the start down to a whole code
// word: older bases leave the registers, so the extra ones change
// nothing), then costs one shift-in and one compare a window.
//
// - The codes of a tile (T + k - 1 bytes, plus a leading word for the
//   warm-up's rounding and one for the last funnel read) are staged in
//   shared memory once, with 16-byte loads where the row is 16-byte
//   aligned and a scalar tail past the row's end or where it is not.
//   A thread reads them a 4-byte word at a time, realigned to its window
//   starts with one funnel shift a word. Runs are R / 4 words apart, which
//   would put a warp's lanes on 4 banks; one padding word after every R / 4
//   code words puts them on 32.
// - The outputs of a run are R consecutive windows, so a thread's direct
//   stores would stride R elements across a warp. They are staged in
//   shared memory, window q of run i at i R + (q + i R / 32) mod R (a
//   rotation by run that keeps a warp's stores, 4-, 8- and 1-byte, off
//   shared banks), then written out by window, neighbouring threads on
//   neighbouring windows: every global store is coalesced.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 128;

// Windows a run, by word count: 32 where a window's outputs are at most 9
// bytes, fewer where they would not fit 48 KB of static shared memory.
__host__ __device__ constexpr int run_length(int nw) {
  return nw <= 2 ? 32 : (nw <= 4 ? 16 : 8);
}

template <int NW, bool KEY>
struct Tile {
  static constexpr int R = run_length(NW);  // windows a run
  static constexpr int T = kThreads * R;    // windows a tile
  static constexpr int PW = R / 4;          // code words between two runs
  // Code words a tile stages at most: the leading word, T + kMaxK - 1
  // bases, and the word the last funnel read takes beyond them.
  static constexpr int CODE_WORDS = (T + kMaxK + 3) / 4 + 1;
  static constexpr int CODE_SLOTS = CODE_WORDS + CODE_WORDS / PW + 1;
  static constexpr int OUT_BYTES = KEY ? 8 * T : (4 * NW + 1) * T;
};

// Shared-memory slot of logical code word w: a padding word after every PW.
template <int PW>
__device__ __forceinline__ int code_slot(int w) {
  return w + w / PW;
}

// Shared-memory slot of window q of run i (both of a tile).
template <int R>
__device__ __forceinline__ int out_slot(int i, int q) {
  return i * R + ((q + (i * R) / 32) & (R - 1));
}

template <int NW, bool KEY>
__global__ void __launch_bounds__(kThreads) kmer_canon_kernel(
    const int8_t* __restrict__ codes, long long n_cols, int k,
    long long plane, int32_t* __restrict__ words,
    uint8_t* __restrict__ valid, long long* __restrict__ key) {
  using L = Tile<NW, KEY>;
  constexpr int R = L::R, T = L::T, PW = L::PW;
  __shared__ uint32_t s_codes[L::CODE_SLOTS];
  __shared__ __align__(16) unsigned char s_out[L::OUT_BYTES];

  const long long row = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * T;
  const int8_t* src = codes + row * n_cols;
  const long long left = n_cols - t0;  // windows of the row from t0
  const int nt = left < T ? (int)left : T;

  // 1. Stage the codes: logical code word w holds the row's bytes
  // [t0 - 4 + 4w, t0 + 4w), 4 past the row's ends.
  const int n_words = (T + k + 3) / 4 + 1;
  int n_vec = 0;  // 16-byte chunks: chunk c is logical words 1 + 4c .. 4 + 4c
  if ((reinterpret_cast<uintptr_t>(src + t0) & 15) == 0) {
    const long long in_row = left < 4LL * (n_words - 1) ? left
                                                       : 4LL * (n_words - 1);
    n_vec = (int)(in_row / 16);
  }
  const int4* vec = reinterpret_cast<const int4*>(src + t0);
  for (int c = threadIdx.x; c < n_vec; c += kThreads) {
    const int4 x = __ldg(vec + c);
    s_codes[code_slot<PW>(4 * c + 1)] = (uint32_t)x.x;
    s_codes[code_slot<PW>(4 * c + 2)] = (uint32_t)x.y;
    s_codes[code_slot<PW>(4 * c + 3)] = (uint32_t)x.z;
    s_codes[code_slot<PW>(4 * c + 4)] = (uint32_t)x.w;
  }
  // The rest a word at a time: word 0, then those past the chunks.
  for (int u = threadIdx.x; u < n_words - 4 * n_vec; u += kThreads) {
    const int w = u == 0 ? 0 : 4 * n_vec + u;
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long pos = t0 - 4 + 4LL * w + b;
      const uint32_t c =
          pos >= 0 && pos < n_cols ? (uint32_t)(uint8_t)src[pos] : 4u;
      word |= c << (8 * b);
    }
    s_codes[code_slot<PW>(w)] = word;
  }
  __syncthreads();

  // 2. Roll through the run: bases [base - 4 wu + k - 1, base + R + k - 1)
  // of the tile, window q emitted after base base + q + k - 1.
  const int i = threadIdx.x;
  const int base = i * R;
  if (base < nt) {
    const int r_last = k - 16 * (NW - 1);
    const int ins = 32 - 2 * r_last;  // the newest forward base's shift
    const uint32_t last_mask = 0xFFFFFFFFu << ins;
    const int wu = (k + 2) / 4;  // warm-up words: ceil((k - 1) / 4)
    // Logical byte of the first warm-up base, and its word and shift.
    const int first = 4 + base + k - 1 - 4 * wu;
    const int sh = 8 * (first & 3);
    int slot_word = first >> 2;
    uint32_t f[NW], r[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) f[j] = r[j] = 0;
    int run = 0;

    auto push = [&](uint32_t w, int byte) {
      const int c = (int)(int8_t)(uint8_t)(w >> (8 * byte));
      run = c >= 4 ? 0 : run + 1;
      const uint32_t b = (uint32_t)c & 3u;
#pragma unroll
      for (int j = 0; j + 1 < NW; ++j) f[j] = __funnelshift_l(f[j + 1], f[j], 2);
      f[NW - 1] = (f[NW - 1] << 2) | (b << ins);
#pragma unroll
      for (int j = NW - 1; j > 0; --j) r[j] = __funnelshift_r(r[j], r[j - 1], 2);
      r[0] = (r[0] >> 2) | ((3u - b) << 30);
      r[NW - 1] &= last_mask;
    };
    auto next_word = [&](uint32_t& lo) {
      const uint32_t hi = s_codes[code_slot<PW>(slot_word + 1)];
      const uint32_t w = __funnelshift_r(lo, hi, sh);
      lo = hi;
      ++slot_word;
      return w;
    };

    uint32_t lo = s_codes[code_slot<PW>(slot_word)];
    for (int n = 0; n < wu; ++n) {
      const uint32_t w = next_word(lo);
#pragma unroll
      for (int b = 0; b < 4; ++b) push(w, b);
    }
    const long long tail_from = n_cols - k + 1 - t0 - base;  // first q past L - k
#pragma unroll
    for (int n = 0; n < R / 4; ++n) {
      const uint32_t w = next_word(lo);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        push(w, b);
        const int q = 4 * n + b;
        const int slot = out_slot<R>(i, q);
        const bool ok = run >= k;
        if constexpr (KEY) {
          const uint64_t fw =
              ((uint64_t)f[0] << 32) | (NW > 1 ? f[NW - 1] : 0u);
          const uint64_t rw =
              ((uint64_t)r[0] << 32) | (NW > 1 ? r[NW - 1] : 0u);
          const uint64_t canon = rw < fw ? rw : fw;
          reinterpret_cast<unsigned long long*>(s_out)[slot] =
              ok ? canon ^ 0x8000000000000000ull : 0x7FFFFFFFFFFFFFFFull;
        } else {
          const bool tail = q >= tail_from;
          bool use_rc = false;
#pragma unroll
          for (int j = NW - 1; j >= 0; --j) {
            const uint32_t rj = tail ? 0u : r[j];
            use_rc = (rj < f[j]) || ((rj == f[j]) && use_rc);
          }
          uint32_t* s_words = reinterpret_cast<uint32_t*>(s_out);
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            s_words[j * T + slot] = use_rc ? (tail ? 0u : r[j]) : f[j];
          }
          s_out[4 * NW * T + slot] = ok ? 1 : 0;
        }
      }
    }
  }
  __syncthreads();

  // 3. Write the tile out, neighbouring threads on neighbouring windows.
  const long long at0 = row * n_cols + t0;
#pragma unroll 4
  for (int m = 0; m < R; ++m) {
    const int w = threadIdx.x + m * kThreads;
    if (w >= nt) break;
    const int slot = out_slot<R>(w / R, w % R);
    if constexpr (KEY) {
      key[at0 + w] = reinterpret_cast<const long long*>(s_out)[slot];
    } else {
      if (words != nullptr) {
        const uint32_t* s_words = reinterpret_cast<const uint32_t*>(s_out);
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          words[j * plane + at0 + w] = (int32_t)s_words[j * T + slot];
        }
      }
      if (valid != nullptr) valid[at0 + w] = s_out[4 * NW * T + slot];
    }
  }
}

template <int NW, bool KEY>
void launch(const int8_t* codes, int n_rows, long long n_cols, int k,
            int32_t* words, uint8_t* valid, long long* key,
            cudaStream_t stream) {
  constexpr int T = Tile<NW, KEY>::T;
  const dim3 grid((unsigned)((n_cols + T - 1) / T), n_rows);
  kmer_canon_kernel<NW, KEY><<<grid, kThreads, 0, stream>>>(
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
  if (y != nullptr) {
    if (nw == 1) {
      launch<1, true>(c, n_rows, n_cols, k, nullptr, nullptr, y, s);
    } else {
      launch<2, true>(c, n_rows, n_cols, k, nullptr, nullptr, y, s);
    }
  }
  if (w != nullptr || v != nullptr) {
    switch (nw) {
      case 1: launch<1, false>(c, n_rows, n_cols, k, w, v, nullptr, s); break;
      case 2: launch<2, false>(c, n_rows, n_cols, k, w, v, nullptr, s); break;
      case 3: launch<3, false>(c, n_rows, n_cols, k, w, v, nullptr, s); break;
      case 4: launch<4, false>(c, n_rows, n_cols, k, w, v, nullptr, s); break;
      case 5: launch<5, false>(c, n_rows, n_cols, k, w, v, nullptr, s); break;
      case 6: launch<6, false>(c, n_rows, n_cols, k, w, v, nullptr, s); break;
      case 7: launch<7, false>(c, n_rows, n_cols, k, w, v, nullptr, s); break;
      default: launch<8, false>(c, n_rows, n_cols, k, w, v, nullptr, s); break;
    }
  }
  return (int)cudaGetLastError();
}
