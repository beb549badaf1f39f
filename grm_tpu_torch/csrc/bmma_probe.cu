// Rate probes for Hopper (sm_90a): what the card executes per second of the
// instructions the sweep kernels' bounds rest on. NVIDIA publishes no 1-bit
// tensor-core peak for the H100, so the bound of an AND + POPC product has to
// come from a measurement.
//
// Every mode runs `iters` rounds of kChains independent dependency chains
// per thread on register operands only; nothing is read from memory, and one
// word per thread is written at the end so that no chain is dead code.
//
//   mode 0  mma.sync m16n8k256 b1 AND + POPC: 16 * 8 * 256 bit-ANDs per warp
//           instruction
//   mode 1  mma.sync m16n8k128 b1 AND + POPC: 16 * 8 * 128
//   mode 2  scalar AND + POPC + ADD, one 32-bit word per thread instruction
//   mode 3  the special-function unit: rcp.approx and lg2.approx by turns
//   mode 4  modes 2 and 3 in one loop: if POPC and the special functions
//           go through one pipe this takes the sum of their times, if
//           through two, the larger
//
// Plain C interface for ctypes; returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "bmma_tile.cuh"

namespace {

constexpr int kChains = 8;

template <int MODE>
__global__ void bmma_probe_kernel(int iters, uint32_t seed,
                                  uint32_t* __restrict__ out) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t v[kChains];
  float f[kChains];
  int d[kChains][4];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    v[i] = (tid + 1u) * 2654435761u + seed * (i + 1u);
    f[i] = 1.5f + (float)((tid + i) & 255u);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0;
  }
  const uint32_t a = v[0] | 1u, b = ~v[1];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (MODE == 0) {
        bmma::mma_and_popc_k256(d[i], a, b, a ^ 0x5555u, b ^ 0x3333u, v[i],
                                v[(i + 1) % kChains]);
      } else if (MODE == 1) {
        bmma::mma_and_popc_k128(d[i], a, b, v[i]);
      }
      if (MODE == 2 || MODE == 4) {
        d[i][0] += __popc(v[i] & a);
        v[i] += (uint32_t)d[i][0];
      }
      if (MODE == 3 || MODE == 4) {
        float r;
        if (i & 1) {
          asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(f[i]));
          f[i] = r + 3.0f;
        } else {
          asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(f[i]));
          f[i] = r + 1.5f;
        }
      }
    }
  }
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    sum += v[i] + __float_as_uint(f[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += (uint32_t)d[i][e];
  }
  out[tid] = sum;
}

}  // namespace

// One launch of `blocks` x `threads` threads (threads a multiple of 32), each
// running `iters` rounds of grm_bmma_probe_chains() chained instructions of
// `mode`. out holds blocks * threads words.
extern "C" int grm_bmma_probe(int mode, int blocks, int threads, int iters,
                              void* out, void* stream) {
  auto* o = (uint32_t*)out;
  auto s = (cudaStream_t)stream;
  switch (mode) {
    case 0: bmma_probe_kernel<0><<<blocks, threads, 0, s>>>(iters, 1u, o); break;
    case 1: bmma_probe_kernel<1><<<blocks, threads, 0, s>>>(iters, 1u, o); break;
    case 2: bmma_probe_kernel<2><<<blocks, threads, 0, s>>>(iters, 1u, o); break;
    case 3: bmma_probe_kernel<3><<<blocks, threads, 0, s>>>(iters, 1u, o); break;
    case 4: bmma_probe_kernel<4><<<blocks, threads, 0, s>>>(iters, 1u, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int grm_bmma_probe_chains() { return kChains; }
