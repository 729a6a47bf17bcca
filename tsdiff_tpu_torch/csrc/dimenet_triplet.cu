// DimeNet++'s triplet chain of one interaction block, fused, for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA
// (tsdiff_tpu/models/dimenetpp.py).  On the card the port computed it as
// three einsums (ops/dimenet_triplet.py::triplet_sum_reference), which wrote
// and read (B, N, N, N, 8) and (B, N, N, N, 64) tensors several times and
// ran their permuted copies and a batched gemv well below the card's
// bandwidth.  This kernel computes, per block,
//
//   rw[b,j,k,l,:]  = sum_n rbf_bes[b,j,k,l,n] * sbf1[l,n,:]           (f32)
//   S[b,i,j,k,:]   = sum_l cbf[b,i,j,k,l] * rw[b,j,k,l,:]             (f32)
//   U[b,i,j,k,:]   = lin_sbf2(S)                    (Bb = 8 -> I, no bias)
//   T[b,i,j,c]     = sum_k x_kj[b,j,k,c] * U[b,i,j,k,c]               (f32)
//
// and writes only T (B, N, N, I) float32.  The rounding points are the
// einsums': rw and S in f32; with the bf16 network S is rounded to bf16,
// lin_sbf2's products are summed in f32 and U is rounded to bf16 (what
// F.linear in bf16 returns); the product with x_kj and the sum over k in
// f32.  With a float32 network nothing is rounded.  Every (i, k) of the
// padded grid is computed, as the einsums do: cbf is zero off the triplets,
// so a NaN or inf in x_kj reaches T as it does through them.
//
// Bound at the main path's shapes (DimeNet++'s published widths: ns = 7,
// nr = 6, Bb = 8, I = 64; B = 100, bf16), per launch (one interaction
// block): on the padded grid a triplet (i, j, k) needs 7*8 + 8*64 + 64 = 632
// multiply-adds, 1.75 GFLOP at N = 24 (0.52 at N = 16), of which lin_sbf2's
// 1.40 run on the tensor cores and the rest, 0.35, on f32 FMAs (5 us at 67
// TFLOP/s).  The bytes: cbf (38.7 MB at N = 24), the Bessel basis (9.7),
// x_kj (14.7) read once and T (14.7) written once, 77.8 MB, 23 us at 3.35
// TB/s; 28.9 MB, 9 us at N = 16.  So the bytes bound it.
//
// Design.  One CTA per (b, j), 256 threads:
//   1. stages cbf[b, :, j] (N rows of N*ns floats), rbf_bes[b, j], sbf1
//      and x_kj[b, j] in shared memory with cp.async, 16 bytes a copy where
//      the rows allow it (a row of cbf is 28 N bytes: where 4 divides N);
//   2. folds sbf1 into rw (N x ns x 8) in shared memory, a thread per (k, l);
//   3. forms S for every (i, k) once, into shared memory as [k][i][8]
//      (bf16 or f32; the rows of i padded to a multiple of 16, zero);
//   4. each warp takes (16 rows of i) x (8 columns of c) tiles: for k in
//      order, lin_sbf2 is one mma.sync.m16n8k8 (bf16: A = S[k] from shared
//      memory, B = lin_sbf2's weight in registers) or 8 FMAs an element
//      (float32), U is rounded from the accumulator fragment, and
//      T += x_kj[k] * U in registers.  The sum over k runs in a fixed
//      order, no atomics: two launches agree bit for bit.  In bf16 the
//      mma.sync beat 8 f32 FMAs an element of U (86 against 140 us at
//      N = 24, 33 against 43 at N = 16, H100 at 700 W).
// Shared memory at N = 24 in bf16: 46 KB, four CTAs an SM; at N = 16, 23 KB.
// The compute phases wait on latency, not on instruction throughput:
// persistent CTAs that copy the next (b, j) while computing one ran slower
// (88 against 76 us at N = 24, 34 against 26 at N = 16: three and six CTAs
// an SM against four and eight), and two tiles a warp in step over k gained
// 4-9 %.
// N up to kMaxN, ns and nr up to 8, I a multiple of 8 up to 128: at those
// limits in float32 the staging takes 196 KB of the 227 KB a CTA may have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBasis = 8;     // basis_emb: lin_sbf2's depth, one m16n8k8 product
constexpr int kMaxN = 48;
constexpr int kMaxBasisFns = 8;  // ns and nr each
constexpr int kMaxInt = 128;

// Byte offsets of the staged tensors in dynamic shared memory.
struct Layout {
  int cbf, rbf, sbf1, x, rw, s, total;
  int rw_stride;  // floats per k of rw: ns * 8, padded by 4 against bank conflicts
  int s_kstride;  // elements per k of S: (ipad + 1) rows of 8, the same reason
  int ipad;       // N rounded up to the mma's 16 rows
};

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int N, int ns, int nr, int I, int s_bytes) {
  Layout L;
  L.ipad = (N + 15) / 16 * 16;
  L.rw_stride = ns * kBasis + 4;
  L.s_kstride = (L.ipad + 1) * kBasis;
  int off = 0;
  L.cbf = off;  off = align16(off + N * N * ns * 4);
  L.rbf = off;  off = align16(off + N * ns * nr * 4);
  L.sbf1 = off; off = align16(off + ns * nr * kBasis * 4);
  L.x = off;    off = align16(off + N * I * 4);
  L.rw = off;   off = align16(off + N * L.rw_stride * 4);
  L.s = off;    off = align16(off + N * L.s_kstride * s_bytes);
  L.total = off;
  return L;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of `rows` rows of `n` floats, row r from src + r * stride,
// to dst, one row after another: 16 bytes a copy where the rows allow it,
// else 4.  The threads walk the units in order, the row and column advanced
// without a division.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int rows,
                                           int n, size_t stride) {
  const bool vec = n % 4 == 0 && stride % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int m = vec ? n / 4 : n;
  const int step_r = kThreads / m, step_c = kThreads - step_r * m;
  int r = threadIdx.x / m, c = threadIdx.x - r * m;
  while (r < rows) {
    if (vec)
      cp_async16(dst + r * n + c * 4, src + r * stride + c * 4);
    else
      cp_async4(dst + r * n + c, src + r * stride + c);
    r += step_r;
    c += step_c;
    if (c >= m) {
      c -= m;
      ++r;
    }
  }
}

// A pair rounded to bf16 and back (round to nearest even).
__device__ __forceinline__ float2 round_bf16(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// kBf16: S and U rounded to bf16, w2 bf16, lin_sbf2 on mma.sync; else all
// float32, lin_sbf2 on FMAs.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads) dimenet_triplet_kernel(
    const float* __restrict__ rbf, const float* __restrict__ sbf1,
    const float* __restrict__ cbf, const void* __restrict__ w2,
    const float* __restrict__ x_kj, float* __restrict__ out, int N, int ns, int nr, int I) {
  using ST = std::conditional_t<kBf16, __nv_bfloat16, float>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(N, ns, nr, I, sizeof(ST));
  float* cbf_s = reinterpret_cast<float*>(smem + L.cbf);
  float* rbf_s = reinterpret_cast<float*>(smem + L.rbf);
  float* sbf1_s = reinterpret_cast<float*>(smem + L.sbf1);
  float* x_s = reinterpret_cast<float*>(smem + L.x);
  float* rw_s = reinterpret_cast<float*>(smem + L.rw);
  ST* s_s = reinterpret_cast<ST*>(smem + L.s);

  const int b = blockIdx.x / N, j = blockIdx.x - b * N;
  const int tid = threadIdx.x;
  const int crow = N * ns, nsr = ns * nr;

  // 1. stage the block's inputs: cbf[b, i, j] for every i, rbf_bes[b, j],
  //    sbf1 and x_kj[b, j]
  stage_rows(cbf_s, cbf + (static_cast<size_t>(b) * N * N + j) * crow, N, crow,
             static_cast<size_t>(N) * crow);
  stage_rows(rbf_s, rbf + (static_cast<size_t>(b) * N + j) * N * nsr, 1, N * nsr, 0);
  stage_rows(sbf1_s, sbf1, 1, nsr * kBasis, 0);
  stage_rows(x_s, x_kj + (static_cast<size_t>(b) * N + j) * N * I, 1, N * I, 0);
  cp_async_wait_all();
  __syncthreads();

  // 2. rw[k][l][:] = sum_n rbf[k][l][n] * sbf1[l][n][:], a thread per (k, l)
  for (int e = tid; e < N * ns; e += kThreads) {
    const int k = e / ns, l = e - k * ns;
    const float* rb = rbf_s + k * nsr + l * nr;
    float acc[kBasis];
#pragma unroll
    for (int c = 0; c < kBasis; ++c) acc[c] = 0.f;
    for (int n = 0; n < nr; ++n) {
      const float rv = rb[n];
      const float4 w0 = *reinterpret_cast<const float4*>(sbf1_s + (l * nr + n) * kBasis);
      const float4 w1 = *reinterpret_cast<const float4*>(sbf1_s + (l * nr + n) * kBasis + 4);
      acc[0] = fmaf(rv, w0.x, acc[0]);
      acc[1] = fmaf(rv, w0.y, acc[1]);
      acc[2] = fmaf(rv, w0.z, acc[2]);
      acc[3] = fmaf(rv, w0.w, acc[3]);
      acc[4] = fmaf(rv, w1.x, acc[4]);
      acc[5] = fmaf(rv, w1.y, acc[5]);
      acc[6] = fmaf(rv, w1.z, acc[6]);
      acc[7] = fmaf(rv, w1.w, acc[7]);
    }
    float* dst = rw_s + k * L.rw_stride + l * kBasis;
    reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();

  // 3. S[k][i][:] = sum_l cbf[i][k][l] * rw[k][l][:], rows N..ipad-1 zero
  for (int e = tid; e < L.ipad * N; e += kThreads) {
    const int i = e / N, k = e - i * N;
    float acc[kBasis];
#pragma unroll
    for (int c = 0; c < kBasis; ++c) acc[c] = 0.f;
    if (i < N) {
      const float* cv = cbf_s + i * crow + k * ns;
      const float* rr = rw_s + k * L.rw_stride;
      for (int l = 0; l < ns; ++l) {
        const float cl = cv[l];
        const float4 r0 = *reinterpret_cast<const float4*>(rr + l * kBasis);
        const float4 r1 = *reinterpret_cast<const float4*>(rr + l * kBasis + 4);
        acc[0] = fmaf(cl, r0.x, acc[0]);
        acc[1] = fmaf(cl, r0.y, acc[1]);
        acc[2] = fmaf(cl, r0.z, acc[2]);
        acc[3] = fmaf(cl, r0.w, acc[3]);
        acc[4] = fmaf(cl, r1.x, acc[4]);
        acc[5] = fmaf(cl, r1.y, acc[5]);
        acc[6] = fmaf(cl, r1.z, acc[6]);
        acc[7] = fmaf(cl, r1.w, acc[7]);
      }
    }
    ST* dst = s_s + k * L.s_kstride + i * kBasis;
    if constexpr (kBf16) {
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int m = 0; m < 4; ++m) h[m] = __floats2bfloat162_rn(acc[2 * m], acc[2 * m + 1]);
      *reinterpret_cast<uint4*>(dst) = packed;
    } else {
      reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
  __syncthreads();

  // 4. T[i][c] = sum_k x[k][c] * U[i][k][c], U = lin_sbf2(S[k][i]); a warp
  //    owns a tile of 16 rows of i by 8 columns of c, its lanes the mma.sync
  //    C fragment: rows g, g + 8 and columns 2q, 2q + 1 (g = lane/4, q = lane%4)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ntiles = I / 8, tiles = (L.ipad / 16) * ntiles;
  for (int u = warp; u < tiles; u += kThreads / 32) {
    const int mt = u / ntiles, nt = u - mt * ntiles;
    const int i0 = mt * 16 + g, c0 = nt * 8 + 2 * q;
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
    if constexpr (kBf16) {
      // B[kk][n] = w2[nt*8 + n][kk]: this lane's pair kk = 2q, 2q + 1 of column g
      const uint32_t bw = *reinterpret_cast<const uint32_t*>(
          static_cast<const __nv_bfloat16*>(w2) + (nt * 8 + g) * kBasis + 2 * q);
      const ST* sp = s_s + i0 * kBasis + 2 * q;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(sp + k * L.s_kstride);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(sp + k * L.s_kstride + 8 * kBasis);
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
        asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
            : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
            : "r"(a0), "r"(a1), "r"(bw));
        const float2 u01 = round_bf16(d0, d1), u23 = round_bf16(d2, d3);
        const float2 xv = *reinterpret_cast<const float2*>(x_s + k * I + c0);
        t0 = fmaf(xv.x, u01.x, t0);
        t1 = fmaf(xv.y, u01.y, t1);
        t2 = fmaf(xv.x, u23.x, t2);
        t3 = fmaf(xv.y, u23.y, t3);
      }
    } else {
      const float* w = static_cast<const float*>(w2);
      float wa[kBasis], wb[kBasis];  // w2's rows c0 and c0 + 1
#pragma unroll
      for (int c = 0; c < kBasis; ++c) {
        wa[c] = w[c0 * kBasis + c];
        wb[c] = w[(c0 + 1) * kBasis + c];
      }
      const float* sp = s_s + i0 * kBasis;
#pragma unroll 2
      for (int k = 0; k < N; ++k) {
        const float4* s0 = reinterpret_cast<const float4*>(sp + k * L.s_kstride);
        const float4* s1 = reinterpret_cast<const float4*>(sp + k * L.s_kstride + 8 * kBasis);
        const float4 s0a = s0[0], s0b = s0[1], s1a = s1[0], s1b = s1[1];
        const float sa[kBasis] = {s0a.x, s0a.y, s0a.z, s0a.w, s0b.x, s0b.y, s0b.z, s0b.w};
        const float sb[kBasis] = {s1a.x, s1a.y, s1a.z, s1a.w, s1b.x, s1b.y, s1b.z, s1b.w};
        float u0 = 0.f, u1 = 0.f, u2 = 0.f, u3 = 0.f;
#pragma unroll
        for (int c = 0; c < kBasis; ++c) {
          u0 = fmaf(sa[c], wa[c], u0);
          u1 = fmaf(sa[c], wb[c], u1);
          u2 = fmaf(sb[c], wa[c], u2);
          u3 = fmaf(sb[c], wb[c], u3);
        }
        const float2 xv = *reinterpret_cast<const float2*>(x_s + k * I + c0);
        t0 = fmaf(xv.x, u0, t0);
        t1 = fmaf(xv.y, u1, t1);
        t2 = fmaf(xv.x, u2, t2);
        t3 = fmaf(xv.y, u3, t3);
      }
    }
    if (i0 < N)
      *reinterpret_cast<float2*>(out + ((static_cast<size_t>(b) * N + i0) * N + j) * I + c0) =
          make_float2(t0, t1);
    if (i0 + 8 < N)
      *reinterpret_cast<float2*>(out + ((static_cast<size_t>(b) * N + i0 + 8) * N + j) * I + c0) =
          make_float2(t2, t3);
  }
}

template <bool kBf16>
int launch(const void* const* ptrs, int B, int N, int ns, int nr, int I, cudaStream_t stream) {
  const Layout L = make_layout(N, ns, nr, I, kBf16 ? 2 : 4);
  auto kernel = dimenet_triplet_kernel<kBf16>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B * N, kThreads, L.total, stream>>>(
      static_cast<const float*>(ptrs[0]), static_cast<const float*>(ptrs[1]),
      static_cast<const float*>(ptrs[2]), ptrs[3], static_cast<const float*>(ptrs[4]),
      static_cast<float*>(const_cast<void*>(ptrs[5])), N, ns, nr, I);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the chain of one interaction block on `stream`; returns the
// cudaError_t of the launch.  ptrs: rbf_bes (B, N, N, ns, nr) f32, sbf1
// (ns * nr, 8) f32, cbf (B, N, N, N, ns) f32, lin_sbf2's weight (I, 8) (bf16
// where is_bf16, else f32), x_kj (B, N, N, I) f32 and the output T
// (B, N, N, I) f32, all contiguous.
// The caller keeps the shapes within dimenet_triplet_limits.
int dimenet_triplet_launch(const void* const* ptrs, int B, int N, int ns, int nr, int I,
                           int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<true>(ptrs, B, N, ns, nr, I, s) : launch<false>(ptrs, B, N, ns, nr, I, s);
}

// The limits of the shapes the kernel takes: N, lin_sbf2's depth, ns and nr
// each, I (a multiple of 8).
void dimenet_triplet_limits(int* out) {
  out[0] = kMaxN;
  out[1] = kBasis;
  out[2] = kMaxBasisFns;
  out[3] = kMaxInt;
}

const char* dimenet_triplet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
