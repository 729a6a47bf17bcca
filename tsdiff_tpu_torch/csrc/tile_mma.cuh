// Tile products and element helpers shared by the port's kernels.
//
// A CTA of kThreads threads multiplies a row tile held in shared memory by a
// weight matrix streamed from global memory (L2): each warp owns 32 output
// columns and reads its B fragments straight from the (out, in) weight rows.
// bf16 runs on the tensor cores through mma.sync.m16n8k16 with f32
// accumulation; float runs an FMA loop with the same fragment layout, so both
// share one epilogue.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round to the working type and back
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float silu_f(float x) { return x * sigmoid_f(x); }
__device__ __forceinline__ float ssp_f(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))) - kLog2;
}

// ---------------------------------------------------------------------------
// acc[mf][nf][0..3] holds the m16n8 fragment of rows mf*16 + {g, g+8} and
// columns n0 + nf*8 + 2t + {0, 1}, g = lane/4, t = lane%4 (the mma.sync C
// layout, also used by the FMA path).

template <typename T, int MF>
struct Mma;

template <int MF>
struct Mma<__nv_bfloat16, MF> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ void load_b(uint32_t (&b)[4][2], const T* __restrict__ W,
                                                int Kin, int n0, int k0, int g, int t) {
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) {
      const T* wp = W + (size_t)(n0 + nf * 8 + g) * Kin + k0 + 2 * t;
      b[nf][0] = __ldg(reinterpret_cast<const unsigned int*>(wp));
      b[nf][1] = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
    }
  }
  // acc += A[rows, Kin] @ W[n0:n0+32, Kin]^T
  static __device__ __forceinline__ void accum(float (&acc)[MF][4][4], const T* A, int lda,
                                               int mfr, const T* __restrict__ W, int Kin,
                                               int n0, int g, int t) {
    uint32_t bc[4][2], bn[4][2];
    load_b(bc, W, Kin, n0, 0, g, t);
    for (int k0 = 0; k0 < Kin; k0 += 16) {
      if (k0 + 16 < Kin) load_b(bn, W, Kin, n0, k0 + 16, g, t);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        if (mf < mfr) {
          const T* ap = A + (mf * 16 + g) * lda + k0 + 2 * t;
          uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
          uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * lda);
          uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 8);
          uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * lda + 8);
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) {
            float* c = acc[mf][nf];
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(bc[nf][0]), "r"(bc[nf][1]));
          }
        }
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        bc[nf][0] = bn[nf][0];
        bc[nf][1] = bn[nf][1];
      }
    }
  }
};

template <int MF>
struct Mma<float, MF> {
  static __device__ __forceinline__ void accum(float (&acc)[MF][4][4], const float* A, int lda,
                                               int mfr, const float* __restrict__ W, int Kin,
                                               int n0, int g, int t) {
    for (int k0 = 0; k0 < Kin; k0 += 4) {
      float4 b[4][2];
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const float* wp = W + (size_t)(n0 + nf * 8 + 2 * t) * Kin + k0;
        b[nf][0] = __ldg(reinterpret_cast<const float4*>(wp));
        b[nf][1] = __ldg(reinterpret_cast<const float4*>(wp + Kin));
      }
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        if (mf < mfr) {
          const float4 lo = *reinterpret_cast<const float4*>(A + (mf * 16 + g) * lda + k0);
          const float4 hi = *reinterpret_cast<const float4*>(A + (mf * 16 + g + 8) * lda + k0);
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) {
            float* c = acc[mf][nf];
            const float4 w0 = b[nf][0], w1 = b[nf][1];
            c[0] = fmaf(lo.x, w0.x, c[0]); c[0] = fmaf(lo.y, w0.y, c[0]);
            c[0] = fmaf(lo.z, w0.z, c[0]); c[0] = fmaf(lo.w, w0.w, c[0]);
            c[1] = fmaf(lo.x, w1.x, c[1]); c[1] = fmaf(lo.y, w1.y, c[1]);
            c[1] = fmaf(lo.z, w1.z, c[1]); c[1] = fmaf(lo.w, w1.w, c[1]);
            c[2] = fmaf(hi.x, w0.x, c[2]); c[2] = fmaf(hi.y, w0.y, c[2]);
            c[2] = fmaf(hi.z, w0.z, c[2]); c[2] = fmaf(hi.w, w0.w, c[2]);
            c[3] = fmaf(hi.x, w1.x, c[3]); c[3] = fmaf(hi.y, w1.y, c[3]);
            c[3] = fmaf(hi.z, w1.z, c[3]); c[3] = fmaf(hi.w, w1.w, c[3]);
          }
        }
      }
    }
  }
};

// out[r, c] = epi(r, c, sum_k A1[r,k] W1[c,k] (+ sum_k A2[r,k] W2[c,k]))
// for r < rows (a multiple of 16, at most MF*16), c < Nout (a multiple of 32).
// Ends with a block barrier.
template <typename T, int MF, typename Epi>
__device__ __forceinline__ void gemm(const T* A1, const T* __restrict__ W1, const T* A2,
                                     const T* __restrict__ W2, int lda, int rows, int Kin,
                                     int Nout, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mfr = rows / 16;
  for (int n0 = warp * 32; n0 < Nout; n0 += kWarps * 32) {
    float acc[MF][4][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mf][nf][q] = 0.0f;
    Mma<T, MF>::accum(acc, A1, lda, mfr, W1, Kin, n0, g, t);
    if (A2 != nullptr) Mma<T, MF>::accum(acc, A2, lda, mfr, W2, Kin, n0, g, t);
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      if (mf < mfr) {
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          const int r = mf * 16 + g, col = n0 + nf * 8 + 2 * t;
          epi(r, col, acc[mf][nf][0]);
          epi(r, col + 1, acc[mf][nf][1]);
          epi(r + 8, col, acc[mf][nf][2]);
          epi(r + 8, col + 1, acc[mf][nf][3]);
        }
      }
    }
  }
  __syncthreads();
}

}  // namespace tile
