// The 1-bit tensor-core tile shared by the sweep kernels: a matrix product
// over bits whose multiply is AND and whose sum is a population count,
//
//     D[m, n] = C[m, n] + popcount(A[m, :] & B[:, n])
//
// written as mma.sync.aligned.m16n8k128/k256.row.col.s32.b1.b1.s32.and.popc
// (sm_80 and later; SASS BMMA.168128 / BMMA.168256 .AND.POPC). One warp owns
// one tile: 16 rows of A, 8 columns of B, and a depth of 128 (or 256) bits
// per step, held as 32-bit words.
//
// Fragments, with lane = threadIdx.x % 32, g = lane / 4, t = lane % 4:
//
//     A (16 x 128 bits, row-major): a0 = word t of row g
//                                   a1 = word t of row g + 8
//     B (128 bits x 8, column-major): b0 = word t of column g
//     C, D (16 x 8 int32): d[0] = (row g,     column 2t)
//                          d[1] = (row g,     column 2t + 1)
//                          d[2] = (row g + 8, column 2t)
//                          d[3] = (row g + 8, column 2t + 1)
//
// and for the k256 step a2, a3, b1 hold word 4 + t of the same rows and
// column. Word w of a step covers bits [32w, 32w + 32) of the depth; the
// order of bits inside a word, and of words inside the depth, is free as
// long as A and B agree, because every bit position is ANDed with itself.
// A operand that is zero past the real depth makes the other operand's
// padding irrelevant.
//
// How the sweeps use it: A's rows are 16 matrix columns (k-mers), the depth
// is the genome axis, and B's columns are 8 example masks. With mask 2j the
// first and mask 2j + 1 the second class of node j (cart_sweep.cu), or the
// negative and the positive examples of fit j (scm_sweep.cu), a thread's
// d[0], d[1] are both counts of node or fit t for matrix column g, and d[2],
// d[3] those for matrix column g + 8: an epilogue per (node, column) needs
// no shuffle.

#pragma once

#include <cstdint>

namespace bmma {

constexpr int kStepWords = 4;   // 32-bit words of depth per k128 step
constexpr int kTileRows = 16;   // rows of A per tile
constexpr int kTileCols = 8;    // columns of B per tile
constexpr int kLanes = 32;

// Row of A (and row + 8) and column of B whose words this lane holds.
__device__ __forceinline__ int frag_index(int lane) { return lane >> 2; }
// Word of the step this lane holds, for A and for B.
__device__ __forceinline__ int frag_word(int lane) { return lane & 3; }
// Column of d[0] and d[2]; d[1] and d[3] are the next column. Their rows
// are frag_index(lane) and frag_index(lane) + 8.
__device__ __forceinline__ int acc_col(int lane) { return (lane & 3) * 2; }

// d += popcount(A & B) over one 128-bit step.
__device__ __forceinline__ void mma_and_popc_k128(int (&d)[4], uint32_t a0,
                                                  uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// d = c + popcount(A & B) over one 128-bit step: a tile's first step, with
// the accumulators' start c apart from d (no copy of c into d first).
__device__ __forceinline__ void mma_and_popc_k128_from(int (&d)[4],
                                                       uint32_t a0,
                                                       uint32_t a1,
                                                       uint32_t b0,
                                                       const int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(c[0]), "r"(c[1]), "r"(c[2]),
        "r"(c[3]));
}

// d = c + popcount(A & B) over one 256-bit step, c apart from d.
__device__ __forceinline__ void mma_and_popc_k256_from(
    int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint32_t b0, uint32_t b1, const int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(c[0]),
        "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

// d += popcount(A & B) over one 256-bit step (two k128 steps' operands).
__device__ __forceinline__ void mma_and_popc_k256(int (&d)[4], uint32_t a0,
                                                  uint32_t a1, uint32_t a2,
                                                  uint32_t a3, uint32_t b0,
                                                  uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace bmma
