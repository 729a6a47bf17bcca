// Tile products and element helpers shared by the port's kernels.
//
// A CTA of kThreads threads multiplies a row tile held in shared memory by a
// weight matrix streamed from global memory (L2): each warp owns 32 output
// columns and reads its B fragments straight from the (out, in) weight rows.
// bf16 runs on the tensor cores through mma.sync.m16n8k16 with f32
// accumulation; float runs an FMA loop with the same fragment layout, so both
// share one epilogue.  The int8 product (quantize_rows, gemm8) is the tensor
// cores' mma.sync.m16n8k32 on per-row quantized activations with int32
// accumulation, dequantized in its epilogue.

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

// ---------------------------------------------------------------------------
// int8 products.  Activations are quantized per row (symmetric, dynamic),
// weights per tensor; the int32 sum is exact and is scaled back to f32 by
// (row scale * weight scale), that product taken first.

// 8 consecutive values of a row (16-byte aligned) as floats
__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}
__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    x[2 * q] = f.x;
    x[2 * q + 1] = f.y;
  }
}

// Per-row symmetric int8 of nr rows of H values in T (shared, row stride lds,
// rows 16-byte aligned, H a multiple of 8): s[r] = max(max|x|, 1e-12) / 127
// and q = rint(x / s), ties to even, a true division.  q has row stride ldq
// bytes (a multiple of 8; shared or global).  One warp a row, 8 values a lane
// and step; ends with a block barrier.
template <typename T>
__device__ __forceinline__ void quantize_rows(const T* src, int lds, int8_t* q, size_t ldq,
                                              float* s, int nr, int H) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nr; r += kWarps) {
    const T* row = src + r * lds;
    float x[8];
    float m = 0.0f;
    for (int c0 = lane * 8; c0 < H; c0 += 256) {
      load8(x, row + c0);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(x[e]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float sc = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
    for (int c0 = lane * 8; c0 < H; c0 += 256) {
      load8(x, row + c0);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[e / 4] |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fdiv_rn(x[e], sc)) << (8 * (e % 4));
      *reinterpret_cast<uint2*>(q + r * ldq + c0) = make_uint2(w[0], w[1]);
    }
    if (lane == 0) s[r] = sc;
  }
  __syncthreads();
}

template <int MF>
struct Mma8 {
  static __device__ __forceinline__ void load_b(uint32_t (&b)[4][2], const int8_t* __restrict__ W,
                                                int Kin, int n0, int k0, int g, int t) {
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) {
      const int8_t* wp = W + (size_t)(n0 + nf * 8 + g) * Kin + k0 + 4 * t;
      b[nf][0] = __ldg(reinterpret_cast<const unsigned int*>(wp));
      b[nf][1] = __ldg(reinterpret_cast<const unsigned int*>(wp + 16));
    }
  }
  // acc += A[rows, Kin] @ W[n0:n0+32, Kin]^T, A in shared memory (row stride
  // lda bytes), W (out, in) in global memory
  static __device__ __forceinline__ void accum(int (&acc)[MF][4][4], const int8_t* A, int lda,
                                               int mfr, const int8_t* __restrict__ W, int Kin,
                                               int n0, int g, int t) {
    uint32_t bc[4][2], bn[4][2];
    load_b(bc, W, Kin, n0, 0, g, t);
    for (int k0 = 0; k0 < Kin; k0 += 32) {
      if (k0 + 32 < Kin) load_b(bn, W, Kin, n0, k0 + 32, g, t);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        if (mf < mfr) {
          const int8_t* ap = A + (mf * 16 + g) * lda + k0 + 4 * t;
          uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
          uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * lda);
          uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
          uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * lda + 16);
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) {
            int* c = acc[mf][nf];
            asm volatile(
                "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
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

// out[r, c] = epi(r, c, f32(sum_k A1[r,k] W1[c,k]) * (s1[r] * sw1)
//                       (+ f32(sum_k A2[r,k] W2[c,k]) * (s2[r] * sw2)))
// for r < rows (a multiple of 16, at most MF*16), c < Nout (a multiple of 32),
// Kin a multiple of 32.  s1, s2 are the rows' scales in shared memory.  Ends
// with a block barrier.
template <int MF, typename Epi>
__device__ __forceinline__ void gemm8(const int8_t* A1, const float* s1,
                                      const int8_t* __restrict__ W1, float sw1, const int8_t* A2,
                                      const float* s2, const int8_t* __restrict__ W2, float sw2,
                                      int lda, int rows, int Kin, int Nout, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mfr = rows / 16;
  for (int n0 = warp * 32; n0 < Nout; n0 += kWarps * 32) {
    int acc[MF][4][4];
    float v[MF][4][4];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1 && A2 == nullptr) break;
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mf][nf][q] = 0;
      const float* sr = pass == 0 ? s1 : s2;
      const float sw = pass == 0 ? sw1 : sw2;
      Mma8<MF>::accum(acc, pass == 0 ? A1 : A2, lda, mfr, pass == 0 ? W1 : W2, Kin, n0, g, t);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        if (mf < mfr) {
          const float lo = sr[mf * 16 + g] * sw, hi = sr[mf * 16 + g + 8] * sw;
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float x = __fmul_rn(__int2float_rn(acc[mf][nf][q]), q < 2 ? lo : hi);
              v[mf][nf][q] = pass == 0 ? x : __fadd_rn(v[mf][nf][q], x);
            }
          }
        }
      }
    }
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      if (mf < mfr) {
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          const int r = mf * 16 + g, col = n0 + nf * 8 + 2 * t;
          epi(r, col, v[mf][nf][0]);
          epi(r, col + 1, v[mf][nf][1]);
          epi(r + 8, col, v[mf][nf][2]);
          epi(r + 8, col + 1, v[mf][nf][3]);
        }
      }
    }
  }
  __syncthreads();
}

}  // namespace tile
