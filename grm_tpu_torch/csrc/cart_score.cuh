// The CART split score shared by the kernels that score splits: the frontier
// sweep (cart_sweep.cu, pass 1 of the exact engine and the whole of the
// argmax engine) and the exact engine's tuple tables and candidate
// compaction (cart_exact.cu). One definition, so that a column's float32
// score is the same bits in every pass: the exact engine's filter keeps a
// column when its score is at most the node's threshold, and the threshold
// comes from pass 1's minimum.
//
//     p = scale[c] * count[c],  p_t = sum_c p            (class order)
//     gini child          = (p_t * p_t - sum_c p * p) / p_t   where p_t > 0
//     cross-entropy child = (-sum_c [f > 0] f * log f) * p_t, f = p / p_t
//     split score = child(left) + child(right)
//
// Every product, sum, difference and quotient is written with __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn (and the libraries build with
// -fmad=false), in the plain PyTorch version's order, so each rounds once
// exactly as PyTorch's separate operations do. logf is CUDA's
// single-precision log (never __logf, never -use_fast_math). A caller with a
// class count between two instantiations appends empty classes (count and
// scale 0): they add +0 to every sum and leave each score bit for bit as it
// was.

#pragma once

namespace cart_score {

enum Criterion { kGini = 0, kCrossEntropy = 1 };

// Impurity of one child times its probability; p holds the C class
// probabilities scale[c] * count[c].
template <int C, int CRIT>
__device__ __forceinline__ float child_score(const float (&p)[C]) {
  float p_t = p[0];
#pragma unroll
  for (int c = 1; c < C; ++c) p_t = __fadd_rn(p_t, p[c]);
  if (CRIT == kGini) {
    float sq = __fmul_rn(p[0], p[0]);
#pragma unroll
    for (int c = 1; c < C; ++c) sq = __fadd_rn(sq, __fmul_rn(p[c], p[c]));
    const float num = __fsub_rn(__fmul_rn(p_t, p_t), sq);
    return p_t > 0.0f ? __fdiv_rn(num, p_t) : 0.0f;
  }
  float ent = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float frac = p_t > 0.0f ? __fdiv_rn(p[c], p_t) : 0.0f;
    const float term = frac > 0.0f ? __fmul_rn(frac, logf(frac)) : 0.0f;
    ent = __fsub_rn(ent, term);
  }
  return __fmul_rn(ent, p_t);
}

// The split's score from both children's class probabilities: the left
// child's first, as every scorer of the port adds them.
template <int C, int CRIT>
__device__ __forceinline__ float split_score(const float (&pl)[C],
                                             const float (&pr)[C]) {
  return __fadd_rn(child_score<C, CRIT>(pl), child_score<C, CRIT>(pr));
}

}  // namespace cart_score
