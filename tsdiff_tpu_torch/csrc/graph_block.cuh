// Per-graph pieces shared by the score kernels and the SchNet stack kernels:
// tile and node-row copies, the pair filter of one row tile, the two
// aggregations (dense pair rows p = i*N + j; offset-packed rows p = (k-1)*N +
// i), the node update that ends an interaction block, the block itself and the
// last layer of the score head.
//
// One CTA of tile::kThreads threads owns one graph.  Its node states h, the
// lin1 output xh (NP x lda each, NP = N padded to 16, pad rows zero) and the
// f32 aggregation buffer agg (N x H) live in shared memory; pair rows come in
// tiles of TR rows (row stride lda).  T is the working type; rnd() marks the
// points where the TPU kernels round to it.

#pragma once

#include "tile_mma.cuh"

namespace blk {

using tile::from_f;
using tile::gemm;
using tile::kThreads;
using tile::kWarps;
using tile::rnd;
using tile::ssp_f;
using tile::to_f;

// One block's weights: matrices (out, in), biases (out).
template <typename T>
struct BlockWeights {
  const T* f1w;
  const T* f1b;
  const T* f2w;
  const T* f2b;
  const T* l1w;
  const T* l2w;
  const T* l2b;
  const T* ow;
  const T* ob;
  // block l of layer-stacked weights (L, H, H) and (L, H)
  __device__ __forceinline__ BlockWeights at(int l, int H) const {
    const size_t wo = (size_t)l * H * H, bo = (size_t)l * H;
    return {f1w + wo, f1b + bo, f2w + wo, f2b + bo, l1w + wo, l2w + wo, l2b + bo, ow + wo, ob + bo};
  }
};

// nr rows of H values (global, row stride H) -> shared (row stride lda)
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int lda, const T* src, int nr, int H) {
  constexpr int kVec = 16 / sizeof(T);
  for (int idx = threadIdx.x; idx < nr * H / kVec; idx += kThreads) {
    const int r = idx / (H / kVec), cv = idx % (H / kVec);
    *reinterpret_cast<uint4*>(dst + r * lda + cv * kVec) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * H + cv * kVec);
  }
}

// N node rows (global) -> shared NP rows, the pad rows zero
template <typename T>
__device__ __forceinline__ void load_nodes(T* dst, int lda, const T* src, int N, int NP, int H) {
  for (int idx = threadIdx.x; idx < NP * H; idx += kThreads) {
    const int r = idx / H, col = idx % H;
    dst[r * lda + col] = r < N ? src[(size_t)r * H + col] : from_f<T>(0.0f);
  }
}

template <typename T>
__device__ __forceinline__ void store_nodes(T* dst, const T* src, int lda, int N, int H) {
  for (int idx = threadIdx.x; idx < N * H; idx += kThreads) {
    const int r = idx / H, col = idx % H;
    dst[(size_t)r * H + col] = src[r * lda + col];
  }
}

// agg[j] += rnd(w[p] * xh[i]) over the tile's dense pair rows p = i*N + j.
// Every thread owns feature columns: no two threads touch one entry.
template <typename T>
__device__ __forceinline__ void aggregate(float* agg, const T* w, const T* xh, int lda, int r0,
                                          int nr, int N, int H) {
  for (int col = threadIdx.x; col < H; col += kThreads) {
    for (int r = 0; r < nr; ++r) {
      const int pr = r0 + r, i = pr / N, j = pr - i * N;
      agg[j * H + col] += rnd<T>(to_f(w[r * lda + col]) * to_f(xh[i * lda + col]));
    }
  }
}

// The symmetric aggregation over the tile's offset-packed rows p = (k-1)*N + i,
// the pair {i, j = (i+k) % N}: agg[j] += rnd(w*xh[i]), agg[i] += rnd(w*xh[j]).
template <typename T>
__device__ __forceinline__ void aggregate_packed(float* agg, const T* w, const T* xh, int lda,
                                                 int r0, int nr, int N, int H) {
  for (int col = threadIdx.x; col < H; col += kThreads) {
    for (int r = 0; r < nr; ++r) {
      const int pr = r0 + r, k = pr / N + 1, i = pr - (k - 1) * N;
      const int j = i + k < N ? i + k : i + k - N;
      const float wv = to_f(w[r * lda + col]);
      agg[j * H + col] += rnd<T>(wv * to_f(xh[i * lda + col]));
      agg[i * H + col] += rnd<T>(wv * to_f(xh[j * lda + col]));
    }
  }
}

// xh = rnd(h l1w), pad rows zero; agg = 0.  A block barrier must follow
// before agg is used (the tile loops have one).
template <typename T, int MF>
__device__ __forceinline__ void node_lin1(const T* h_s, const T* l1w, T* xh_s, float* agg,
                                          int lda, int NP, int N, int H) {
  gemm<T, MF>(h_s, l1w, nullptr, nullptr, lda, NP, H, H, [&](int r, int col, float v) {
    xh_s[r * lda + col] = r < N ? from_f<T>(v) : from_f<T>(0.0f);
  });
  for (int idx = threadIdx.x; idx < N * H; idx += kThreads) agg[idx] = 0.0f;
}

// ea (the tile in bufA) -> bufA = rnd(rnd(rnd(ssp(rnd(ea f1w + f1b))) f2w + f2b) * c)
template <typename T, int MF>
__device__ __forceinline__ void filter_tile(T* bufA, T* bufB, const float* c_s,
                                            const BlockWeights<T>& w, int lda, int nr, int H) {
  gemm<T, MF>(bufA, w.f1w, nullptr, nullptr, lda, nr, H, H, [&](int r, int col, float v) {
    bufB[r * lda + col] = from_f<T>(ssp_f(rnd<T>(v + to_f(w.f1b[col]))));
  });
  gemm<T, MF>(bufB, w.f2w, nullptr, nullptr, lda, nr, H, H, [&](int r, int col, float v) {
    bufA[r * lda + col] = from_f<T>(rnd<T>(v + to_f(w.f2b[col])) * c_s[r]);
  });
}

// h += rnd(ssp(rnd(rnd(agg) l2w + l2b)) ow + ob); t_s is a tile of >= NP rows
template <typename T, int MF>
__device__ __forceinline__ void node_update(const float* agg, T* t_s, T* xh_s, T* h_s,
                                            const BlockWeights<T>& w, int lda, int NP, int N,
                                            int H) {
  for (int idx = threadIdx.x; idx < NP * H; idx += kThreads) {
    const int r = idx / H, col = idx % H;
    t_s[r * lda + col] = r < N ? from_f<T>(agg[r * H + col]) : from_f<T>(0.0f);
  }
  __syncthreads();
  gemm<T, MF>(t_s, w.l2w, nullptr, nullptr, lda, NP, H, H, [&](int r, int col, float v) {
    xh_s[r * lda + col] =
        r < N ? from_f<T>(ssp_f(rnd<T>(v + to_f(w.l2b[col])))) : from_f<T>(0.0f);
  });
  gemm<T, MF>(xh_s, w.ow, nullptr, nullptr, lda, NP, H, H, [&](int r, int col, float v) {
    if (r < N) {
      const float y = rnd<T>(v + to_f(w.ob[col]));
      h_s[r * lda + col] = from_f<T>(to_f(h_s[r * lda + col]) + y);
    }
  });
}

// One interaction block of one graph on its R pair rows, dense (R = N*N) or
// offset-packed (R = (N/2)*N), streamed from global memory in tiles of TR
// rows: ea_g (R, H) in T, c_g (R) in C (float or T), rounded to T.
template <typename T, int TR, bool kPacked, typename C>
__device__ __forceinline__ void interaction_block(T* bufA, T* bufB, T* h_s, T* xh_s, float* agg,
                                                  float* c_s, const T* ea_g, const C* c_g,
                                                  const BlockWeights<T>& w, int lda, int NP,
                                                  int N, int R, int H) {
  constexpr int MF = TR / 16;
  node_lin1<T, MF>(h_s, w.l1w, xh_s, agg, lda, NP, N, H);
  for (int r0 = 0; r0 < R; r0 += TR) {
    const int nr = min(TR, R - r0);
    for (int r = threadIdx.x; r < nr; r += kThreads) c_s[r] = rnd<T>(to_f(c_g[r0 + r]));
    load_tile(bufA, lda, ea_g + (size_t)r0 * H, nr, H);
    __syncthreads();
    filter_tile<T, MF>(bufA, bufB, c_s, w, lda, nr, H);
    if (kPacked)
      aggregate_packed(agg, bufA, xh_s, lda, r0, nr, N, H);
    else
      aggregate(agg, bufA, xh_s, lda, r0, nr, N, H);
    __syncthreads();
  }
  node_update<T, MF>(agg, bufA, xh_s, h_s, w, lda, NP, N, H);
}

// out[r] = sum_col g[r, col] * g2w[col] + g2b for the tile's rows, one warp a
// row, f32 accumulation; ends with a block barrier.
template <typename T>
__device__ __forceinline__ void head_dot(const T* g_s, int lda, const T* g2w, float g2b,
                                         float* out, int nr, int Hh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nr; r += kWarps) {
    float s = 0.0f;
    for (int col = lane; col < Hh; col += 32) s += to_f(g_s[r * lda + col]) * to_f(g2w[col]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[r] = s + g2b;
  }
  __syncthreads();
}

}  // namespace blk
