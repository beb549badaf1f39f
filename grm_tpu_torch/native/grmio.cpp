// grmio: native host-side genomic IO and the k-mer union merge.
//
// The port's own copy of the entry points of grm_tpu/native/grmio.cpp that
// its ingest calls (the same outputs); grm_tpu_torch never loads grm_tpu's
// library.
//
// The host C++ of grm_tpu_torch's ingest (grm_tpu_torch/native/bindings.py
// builds it with g++ at first use and loads it with ctypes):
//
//   - FASTA/FASTQ buffer -> 2-bit codes (A=0 C=1 G=2 T=3, 4 = invalid and
//     contig separator), matching grm_tpu_torch.ops.kmer.encode_contigs;
//   - N-way merge of per-genome sorted k-mer arrays into the union k-mer
//     space and the packed presence matrix: the dsk2kover role, a
//     pointer-chasing workload that runs on the host (the card counts each
//     genome's k-mers with csrc/kmer.cu).
//
// K-mers are (n, nw) uint32 rows, big-endian word order, bases MSB-first,
// last word left-aligned: numeric/lexicographic equivalence with the device
// representation, so outputs are interchangeable.
//
// Exposed as a C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// FASTA/FASTQ parsing
// ---------------------------------------------------------------------------

// Encode a FASTA text buffer into 2-bit codes with contig separators.
// Returns the number of codes written (<= n). out must have capacity n.
long grm_encode_fasta(const char* buf, long n, int8_t* out) {
    static int8_t table[256];
    static bool init = false;
    if (!init) {
        memset(table, 4, sizeof(table));
        table[(unsigned char)'A'] = table[(unsigned char)'a'] = 0;
        table[(unsigned char)'C'] = table[(unsigned char)'c'] = 1;
        table[(unsigned char)'G'] = table[(unsigned char)'g'] = 2;
        table[(unsigned char)'T'] = table[(unsigned char)'t'] = 3;
        init = true;
    }
    long w = 0;
    long i = 0;
    bool wrote_any = false;
    while (i < n) {
        if (buf[i] == '>') {
            // Header line: skip to end of line; separate contigs.
            while (i < n && buf[i] != '\n') i++;
            if (wrote_any && w > 0 && out[w - 1] != 4) out[w++] = 4;
        } else {
            for (; i < n && buf[i] != '\n'; i++) {
                unsigned char c = (unsigned char)buf[i];
                if (c == '\r' || c == ' ' || c == '\t') continue;
                out[w++] = table[c];
                wrote_any = true;
            }
        }
        i++;  // skip newline
    }
    // Trim trailing separator.
    while (w > 0 && out[w - 1] == 4 && (w == 1 || out[w - 2] == 4)) w--;
    return w;
}

// Encode a FASTQ text buffer (sequence lines only) into 2-bit codes with
// separators between reads. Returns number of codes written.
long grm_encode_fastq(const char* buf, long n, int8_t* out) {
    static int8_t table[256];
    static bool init = false;
    if (!init) {
        memset(table, 4, sizeof(table));
        table[(unsigned char)'A'] = table[(unsigned char)'a'] = 0;
        table[(unsigned char)'C'] = table[(unsigned char)'c'] = 1;
        table[(unsigned char)'G'] = table[(unsigned char)'g'] = 2;
        table[(unsigned char)'T'] = table[(unsigned char)'t'] = 3;
        init = true;
    }
    long w = 0;
    long i = 0;
    int line = 0;
    bool first = true;
    while (i < n) {
        long start = i;
        while (i < n && buf[i] != '\n') i++;
        if (line % 4 == 1) {  // sequence line
            if (!first) out[w++] = 4;
            for (long j = start; j < i; j++) {
                unsigned char c = (unsigned char)buf[j];
                if (c == '\r') continue;
                out[w++] = table[c];
            }
            first = false;
        }
        i++;
        line++;
    }
    return w;
}

// ---------------------------------------------------------------------------
// N-way merge into the union k-mer space (dsk2kover role)
// ---------------------------------------------------------------------------

namespace {

inline bool row_eq_n(const uint32_t* a, const uint32_t* b, int nw) {
    for (int j = 0; j < nw; j++)
        if (a[j] != b[j]) return false;
    return true;
}

}  // namespace

// Fused dsk2kover merge for nw <= 2 (k <= 32): one pass over the N sorted
// per-genome k-mer lists emits the sorted distinct union, per-union genome
// counts and the packed presence bits, set during emission (no per-element
// column indices, no separate bit-set pass). Rows collapse to one uint64 key
// (big-endian word order makes u64 compare == lexicographic row compare)
// driven through a loser-tree tournament: log2(N) integer compares per
// element. Streams are passed as raw addresses (no host-side concatenation).
// ``matrix`` is (ceil(n_lists/64), cap)-shaped with row
// stride ``matrix_stride`` (elements); rows are zeroed lazily column by
// column as union entries are emitted, so the buffer may be uninitialized
// and only ceil(n_lists/64) x n_union cells are ever touched. Compact with
// grm_compact_rows afterwards.
long grm_merge_union_bits64(const uint64_t* list_addrs, const int64_t* sizes,
                            int n_lists, int nw, uint32_t* out_union,
                            int32_t* out_genome_counts, uint64_t* matrix,
                            long matrix_stride, long cap) {
    if (nw < 1 || nw > 2 || n_lists < 1) return -2;
    const int n_words = (n_lists + 63) >> 6;

    int M = 1;
    while (M < n_lists) M <<= 1;
    // Arrays sized M so padding leaves [n_lists, M) carry real sentinel
    // entries — the branchless replay indexes them directly.
    std::vector<const uint32_t*> ptr(n_lists);
    std::vector<const uint32_t*> end(n_lists);
    std::vector<uint64_t> cur(M, ~0ULL);
    std::vector<int> rank(M);
    long remaining = 0;

    auto load = [&](int i) {
        if (ptr[i] >= end[i]) {
            cur[i] = ~0ULL;
            rank[i] = n_lists + i;
            return;
        }
        const uint32_t* row = ptr[i];
        cur[i] = (nw == 1)
                     ? (uint64_t)row[0]
                     : (((uint64_t)row[0] << 32) | (uint64_t)row[1]);
    };
    for (int i = 0; i < M; i++) rank[i] = 2 * M + i;  // padding sentinels
    for (int i = 0; i < n_lists; i++) {
        ptr[i] = (const uint32_t*)(uintptr_t)list_addrs[i];
        end[i] = ptr[i] + sizes[i] * nw;
        rank[i] = i;
        load(i);
        remaining += sizes[i];
    }

    auto less = [&](int a, int b) {
        return cur[a] < cur[b] || (cur[a] == cur[b] && rank[a] < rank[b]);
    };
    std::vector<int> tree(M);
    int winner;
    {
        std::vector<int> up(2 * M);
        for (int i = 0; i < M; i++) up[M + i] = i;
        for (int n = M - 1; n >= 1; n--) {
            int a = up[2 * n], b = up[2 * n + 1];
            int w = less(a, b) ? a : b;
            tree[n] = (w == a) ? b : a;
            up[n] = w;
        }
        winner = up[1];
    }

    long out = 0;
    uint64_t prev = 0;
    while (remaining > 0) {
        int i = winner;
        uint64_t key = cur[i];
        if (out == 0 || key != prev) {
            if (out >= cap) return -1;
            uint32_t* dst = out_union + (long)out * nw;
            if (nw == 1) {
                dst[0] = (uint32_t)key;
            } else {
                dst[0] = (uint32_t)(key >> 32);
                dst[1] = (uint32_t)key;
            }
            out_genome_counts[out] = 0;
            for (int w = 0; w < n_words; w++) matrix[w * matrix_stride + out] = 0;
            prev = key;
            out++;
        }
        out_genome_counts[out - 1]++;
        matrix[(long)(i >> 6) * matrix_stride + (out - 1)] |=
            1ULL << (63 - (i & 63));
        ptr[i] += nw;
        remaining--;
        load(i);
        // Branchless replay: the loser/winner swap outcome is ~random, so
        // a branchy swap pays a misprediction per level per element (the
        // dominant cost of the flat merge). Conditional-select keeps the
        // pipeline full; keys and ranks compare arithmetically.
        int node = (M + i) >> 1;
        winner = i;
        uint64_t wk = cur[winner];
        int wr = rank[winner];
        while (node >= 1) {
            const int t = tree[node];
            const uint64_t tk = cur[t];
            const int tr = rank[t];
            const bool sw = (tk < wk) | ((tk == wk) & (tr < wr));
            tree[node] = sw ? winner : t;
            winner = sw ? t : winner;
            wk = sw ? tk : wk;
            wr = sw ? tr : wr;
            node >>= 1;
        }
    }
    return out;
}

// Generalization of grm_merge_union_bits64 to any row width nw in [1, 8]
// (k up to 128): the loser tree runs on (row pointer, rank) entries with
// lexicographic multiword compares. Exhausted streams are flagged instead
// of carrying a sentinel key, so every real key value is representable.
// Same output contract as the u64 variant.
long grm_merge_union_bits_rows(const uint64_t* list_addrs, const int64_t* sizes,
                               int n_lists, int nw, uint32_t* out_union,
                               int32_t* out_genome_counts, uint64_t* matrix,
                               long matrix_stride, long cap) {
    if (nw < 1 || nw > 8 || n_lists < 1) return -2;
    const int n_words = (n_lists + 63) >> 6;

    int M = 1;
    while (M < n_lists) M <<= 1;
    // Each stream caches a 64-bit PREFIX of its head row (first two words,
    // big-endian significant): the replay compares prefixes branchlessly
    // like the u64 kernel, and falls to a full-row tie compare only when
    // prefixes are equal (rare for k > 32 — it needs a shared 32-base
    // prefix). cur/rank are sized M so padding leaves hold sentinels.
    std::vector<const uint32_t*> ptr(n_lists);
    std::vector<const uint32_t*> end(n_lists);
    std::vector<uint64_t> cur(M, ~0ULL);
    std::vector<int> rank(M);
    long remaining = 0;

    auto load = [&](int i) {
        if (ptr[i] >= end[i]) {
            cur[i] = ~0ULL;
            rank[i] = n_lists + i;
            return;
        }
        const uint32_t* row = ptr[i];
        cur[i] = (nw == 1)
                     ? (uint64_t)row[0]
                     : (((uint64_t)row[0] << 32) | (uint64_t)row[1]);
    };
    for (int i = 0; i < M; i++) rank[i] = 2 * M + i;  // padding sentinels
    for (int i = 0; i < n_lists; i++) {
        ptr[i] = (const uint32_t*)(uintptr_t)list_addrs[i];
        end[i] = ptr[i] + sizes[i] * nw;
        rank[i] = i;
        load(i);
        remaining += sizes[i];
    }

    // Equal-prefix ordering: exhausted/padding (rank >= n_lists) order by
    // rank (live streams always precede them); live streams compare the
    // tail words, then rank.
    auto tie_less = [&](int a, int b) {
        if (rank[a] >= n_lists || rank[b] >= n_lists)
            return rank[a] < rank[b];
        const uint32_t* ra = ptr[a];
        const uint32_t* rb = ptr[b];
        for (int j = 2; j < nw; j++) {
            if (ra[j] != rb[j]) return ra[j] < rb[j];
        }
        return rank[a] < rank[b];
    };
    auto less = [&](int a, int b) {
        return cur[a] < cur[b] || (cur[a] == cur[b] && tie_less(a, b));
    };
    std::vector<int> tree(M);
    int winner;
    {
        std::vector<int> up(2 * M);
        for (int i = 0; i < M; i++) up[M + i] = i;
        for (int n = M - 1; n >= 1; n--) {
            int a = up[2 * n], b = up[2 * n + 1];
            int w = less(a, b) ? a : b;
            tree[n] = (w == a) ? b : a;
            up[n] = w;
        }
        winner = up[1];
    }

    long out = 0;
    while (remaining > 0) {
        const int i = winner;
        const uint32_t* row = ptr[i];
        if (out == 0 || !row_eq_n(out_union + (out - 1) * nw, row, nw)) {
            if (out >= cap) return -1;
            memcpy(out_union + (long)out * nw, row, nw * sizeof(uint32_t));
            out_genome_counts[out] = 0;
            for (int w = 0; w < n_words; w++) matrix[w * matrix_stride + out] = 0;
            out++;
        }
        out_genome_counts[out - 1]++;
        matrix[(long)(i >> 6) * matrix_stride + (out - 1)] |=
            1ULL << (63 - (i & 63));
        ptr[i] += nw;
        remaining--;
        load(i);
        // Replay: branchless prefix select; the equal-prefix fallback is a
        // predictable rarely-taken branch.
        int node = (M + i) >> 1;
        winner = i;
        uint64_t wk = cur[winner];
        while (node >= 1) {
            const int t = tree[node];
            const uint64_t tk = cur[t];
            bool sw;
            if (tk != wk) {
                sw = tk < wk;
            } else {
                sw = tie_less(t, winner);
            }
            tree[node] = sw ? winner : t;
            winner = sw ? t : winner;
            wk = sw ? tk : wk;
            node >>= 1;
        }
    }
    return out;
}

// Compact rows laid out at src_stride down to dst_stride (dst_stride <=
// src_stride), ascending: buf[r*dst_stride .. +n_cols) = buf[r*src_stride ..).
// Safe in place (see proof in the caller): dst never overruns a later src.
void grm_compact_rows(uint64_t* buf, long n_rows, long n_cols,
                      long src_stride, long dst_stride) {
    for (long r = 1; r < n_rows; r++) {
        memmove(buf + r * dst_stride, buf + r * src_stride,
                n_cols * sizeof(uint64_t));
    }
}

}  // extern "C"
