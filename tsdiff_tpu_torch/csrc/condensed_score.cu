// Dense fused score step of one condensed-encoder model, for Hopper.
//
// Replaces the TPU kernel tsdiff_tpu/ops/pallas/condensed_score.py::
// condensed_score_pallas (kernel _score_kernel).  Per graph b, on the dense
// pair rows p = i*N + j (the directed pair i -> j), P = N*N:
//
//   1. distance MLP   de = W1 silu(rnd(d*w0 + b0)) + b1               (P, H)
//   2. R/P combine    attr = de * emb, the bond embeddings precomputed
//      per batch and streamed from global memory, (B, P, H) each
//   3. edge_cat       ea = C1 silu(C0r attr_r + C0p attr_p + c0) + c1
//   4. L SchNet blocks, agg[j] = sum_i rnd(w[i*N+j] * xh[i])
//   5. output-order edge_cat on the same de (recomputed, see below)
//   6. head MLP 2H->H->H/2->1 on [h_i * h_j, ea_out], f32 out (B, P)
//
// The working type T (float or bf16) is what every activation is rounded to
// after each bias add and each silu/ssp; the first layer's d*w0 + b0 is one
// f32 expression rounded once (the TPU kernel's (P,1)x(1,H) product
// accumulates in f32); products w*xh are rounded to T before their f32 sum;
// matrix products accumulate in f32.
//
// Design.  One CTA owns one graph.  h, xh and the f32 aggregation buffer
// (N x H each) stay in shared memory; the aggregation over sources is done by
// column-owning threads in a fixed order, without atomics.  One graph's ea
// (576 x 256 bf16 at N=24, 295 KB) exceeds a block's shared memory and feeds
// all L blocks, so pair rows are walked in tiles of TR rows: ea is written
// once to a global scratch buffer (allocated by the caller) and streamed back
// by every block; de is recomputed for the output stage instead of being
// stored.  The four embedding tensors are each read once, tile by tile,
// straight into the de*emb product.  Weights stream from global memory (L2):
// each warp owns 32 output columns.  bf16 products run on the tensor cores
// (mma.sync.m16n8k16, f32 accumulation); the f32 path uses FMA loops and
// exists to check the kernel against the plain version.  The interaction
// block is the one of the SchNet stack kernels (graph_block.cuh).
//
// Bound at the dense path's shapes (B=100, N=24, H=256, L=7, bf16): counted
// from the kernel body, 2*B*(7*P*H^2 + L*(2*P*H^2 + 3*N*H^2) + 2.5*P*H^2) =
// 1.84e11 flop, 0.19 ms at 989 TFLOP/s, against ~125 MB of inputs (the four
// embedding tensors are 29.5 MB each), 0.04 ms at 3.35 TB/s: bound by the
// tensor cores.  This first version makes no attempt at that bound: one CTA
// per graph leaves 32 of 132 SMs idle at B=100, and it uses mma.sync, no TMA,
// and re-reads each weight matrix from L2 once per row tile.

#include "graph_block.cuh"

namespace {

using tile::from_f;
using tile::gemm;
using tile::kThreads;
using tile::rnd;
using tile::silu_f;
using tile::to_f;

constexpr int kNumPtrs = 34;
constexpr size_t kMaxSmem = 232448;

template <typename T>
struct Params {
  const float* d;   // (B, P) masked distances
  const float* c;   // (B, P) cutoff & encoder edge mask
  const T* z;       // (B, N, H) node states
  const T* er_in;   // (B, P, H) bond embeddings, encoder order
  const T* ep_in;
  const T* er_out;  // (B, P, H) output order
  const T* ep_out;
  // weights; matrices in (out, in) layout
  const T* dw0;     // (H)
  const T* db0;
  const T* dw1;     // (H, H)
  const T* db1;
  const T* c0r;     // (H, H)
  const T* c0p;
  const T* c0b;
  const T* c1w;
  const T* c1b;
  blk::BlockWeights<T> stack;  // (L, H, H) and (L, H)
  const T* g0h;     // (H, H)
  const T* g0e;
  const T* g0b;
  const T* g1w;     // (H/2, H)
  const T* g1b;
  const T* g2w;     // (H/2)
  const T* g2b;     // (1)
  T* ea;            // (B, P, H) scratch
  float* out;       // (B, P)
  int B, N, H, L;
};

// Shared-memory carve-up, shared by the kernel and the host-side size check.
struct Smem {
  size_t buf, node, agg, rows, total;
  int lda, np;
};

template <typename T, int TR>
__host__ __device__ inline Smem smem_layout(int N, int H) {
  Smem s;
  s.lda = H + 16 / (int)sizeof(T);  // +16 bytes per row: conflict-free fragment loads
  s.np = (N + 15) / 16 * 16;
  s.buf = (size_t)TR * s.lda * sizeof(T);
  s.node = (size_t)s.np * s.lda * sizeof(T);
  s.agg = (size_t)N * H * sizeof(float);
  s.rows = (size_t)TR * 2 * sizeof(float);
  s.total = 3 * s.buf + 2 * s.node + s.agg + s.rows;
  return s;
}

template <typename T, int TR>
__global__ void __launch_bounds__(kThreads, 1) condensed_score_kernel(Params<T> p) {
  constexpr int MF = TR / 16;
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, H = p.H, L = p.L;
  const int P = N * N, Hh = H / 2;
  const Smem lay = smem_layout<T, TR>(N, H);
  const int lda = lay.lda, NP = lay.np;

  T* bufA = reinterpret_cast<T*>(smem);
  T* bufB = reinterpret_cast<T*>(smem + lay.buf);
  T* bufC = reinterpret_cast<T*>(smem + 2 * lay.buf);
  T* h_s = reinterpret_cast<T*>(smem + 3 * lay.buf);
  T* xh_s = reinterpret_cast<T*>(smem + 3 * lay.buf + lay.node);
  float* agg = reinterpret_cast<float*>(smem + 3 * lay.buf + 2 * lay.node);
  float* d_s = reinterpret_cast<float*>(smem + 3 * lay.buf + 2 * lay.node + lay.agg);
  float* c_s = d_s + TR;

  const int b = blockIdx.x, tid = threadIdx.x;
  const float* d_g = p.d + (size_t)b * P;
  const float* c_g = p.c + (size_t)b * P;
  T* ea_g = p.ea + (size_t)b * P * H;
  const float g2b = to_f(p.g2b[0]);
  // kernel parameters copied to locals: the lambdas below capture by reference
  const T *dw0 = p.dw0, *db0 = p.db0, *dw1 = p.dw1, *db1 = p.db1, *c0r = p.c0r, *c0p = p.c0p;
  const T *c0b = p.c0b, *c1w = p.c1w, *c1b = p.c1b, *g0h = p.g0h, *g0e = p.g0e, *g0b = p.g0b;
  const T *g1w = p.g1w, *g1b = p.g1b, *g2w = p.g2w;
  const blk::BlockWeights<T> stack = p.stack;

  blk::load_nodes(h_s, lda, p.z + (size_t)b * N * H, N, NP, H);

  // edge_cat of the row tile at r0 with the embeddings er, ep (B, P, H), into
  // dst (leading dim ld)
  auto edge_cat = [&](int r0, int nr, const T* er, const T* ep, T* dst, int ld) {
    for (int r = tid; r < nr; r += kThreads) d_s[r] = rnd<T>(d_g[r0 + r]);
    __syncthreads();
    for (int idx = tid; idx < nr * H; idx += kThreads) {
      const int r = idx / H, col = idx % H;
      const float x = rnd<T>(d_s[r] * to_f(dw0[col]) + to_f(db0[col]));
      bufA[r * lda + col] = from_f<T>(silu_f(x));
    }
    __syncthreads();
    gemm<T, MF>(bufA, dw1, nullptr, nullptr, lda, nr, H, H, [&](int r, int col, float v) {
      bufB[r * lda + col] = from_f<T>(v + to_f(db1[col]));
    });
    // attr = de * emb, the embeddings streamed 16 bytes a thread
    const T* er_g = er + ((size_t)b * P + r0) * H;
    const T* ep_g = ep + ((size_t)b * P + r0) * H;
    for (int idx = tid; idx < nr * H / kVec; idx += kThreads) {
      const int r = idx / (H / kVec), cv = idx % (H / kVec);
      const uint4 rv = *reinterpret_cast<const uint4*>(er_g + (size_t)r * H + cv * kVec);
      const uint4 pv = *reinterpret_cast<const uint4*>(ep_g + (size_t)r * H + cv * kVec);
      const T* re = reinterpret_cast<const T*>(&rv);
      const T* pe = reinterpret_cast<const T*>(&pv);
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const int o = r * lda + cv * kVec + q;
        const float de = to_f(bufB[o]);
        bufA[o] = from_f<T>(de * to_f(re[q]));
        bufC[o] = from_f<T>(de * to_f(pe[q]));
      }
    }
    __syncthreads();
    gemm<T, MF>(bufA, c0r, bufC, c0p, lda, nr, H, H, [&](int r, int col, float v) {
      bufB[r * lda + col] = from_f<T>(silu_f(rnd<T>(v + to_f(c0b[col]))));
    });
    gemm<T, MF>(bufB, c1w, nullptr, nullptr, lda, nr, H, H, [&](int r, int col, float v) {
      dst[(size_t)r * ld + col] = from_f<T>(v + to_f(c1b[col]));
    });
  };

  // 1. encoder-order edge features of every row, into the global scratch
  for (int r0 = 0; r0 < P; r0 += TR)
    edge_cat(r0, min(TR, P - r0), p.er_in, p.ep_in, ea_g + (size_t)r0 * H, H);

  // 2. interaction blocks
  for (int l = 0; l < L; ++l)
    blk::interaction_block<T, TR, false>(bufA, bufB, h_s, xh_s, agg, c_s, ea_g, c_g,
                                         stack.at(l, H), lda, NP, N, P, H);

  // 3. head on [h_i * h_j, ea_out] with the output-order edge features
  float* out = p.out + (size_t)b * P;
  for (int r0 = 0; r0 < P; r0 += TR) {
    const int nr = min(TR, P - r0);
    edge_cat(r0, nr, p.er_out, p.ep_out, bufA, lda);
    for (int idx = tid; idx < nr * H; idx += kThreads) {
      const int r = idx / H, col = idx % H;
      const int pr = r0 + r, i = pr / N, j = pr - i * N;
      bufC[r * lda + col] = from_f<T>(to_f(h_s[i * lda + col]) * to_f(h_s[j * lda + col]));
    }
    __syncthreads();
    gemm<T, MF>(bufC, g0h, bufA, g0e, lda, nr, H, H, [&](int r, int col, float v) {
      bufB[r * lda + col] = from_f<T>(silu_f(rnd<T>(v + to_f(g0b[col]))));
    });
    gemm<T, MF>(bufB, g1w, nullptr, nullptr, lda, nr, H, Hh, [&](int r, int col, float v) {
      bufA[r * lda + col] = from_f<T>(silu_f(rnd<T>(v + to_f(g1b[col]))));
    });
    blk::head_dot(bufA, lda, g2w, g2b, out + r0, nr, Hh);
  }
}

template <typename T, int TR>
int launch(const void* const* ptrs, int B, int N, int H, int L, void* stream) {
  const Smem lay = smem_layout<T, TR>(N, H);
  if (lay.np > TR || lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params<T> p;
  int i = 0;
  p.d = static_cast<const float*>(ptrs[i++]);
  p.c = static_cast<const float*>(ptrs[i++]);
  blk::BlockWeights<T>& s = p.stack;
  const T** in[] = {&p.z, &p.er_in, &p.ep_in, &p.er_out, &p.ep_out,
                    &p.dw0, &p.db0, &p.dw1, &p.db1, &p.c0r, &p.c0p, &p.c0b, &p.c1w, &p.c1b,
                    &s.f1w, &s.f1b, &s.f2w, &s.f2b, &s.l1w, &s.l2w, &s.l2b, &s.ow, &s.ob,
                    &p.g0h, &p.g0e, &p.g0b, &p.g1w, &p.g1b, &p.g2w, &p.g2b};
  for (const T** slot : in) *slot = static_cast<const T*>(ptrs[i++]);
  p.ea = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  p.out = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  if (i != kNumPtrs) return (int)cudaErrorInvalidValue;
  p.B = B; p.N = N; p.H = H; p.L = L;
  cudaError_t e = cudaFuncSetAttribute(condensed_score_kernel<T, TR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  condensed_score_kernel<T, TR>
      <<<B, kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the score kernel on `stream`; returns the cudaError_t of the launch.
// ptrs: d, cmask, z, er_in, ep_in, er_out, ep_out, the 25 weights in the order
// of Params, the ea scratch and the output.
int condensed_score_launch(const void* const* ptrs, int B, int N, int H, int L, int is_bf16,
                           void* stream) {
  if (N <= 0 || N % 8 != 0 || H <= 0 || H % 64 != 0 || L < 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) return launch<__nv_bfloat16, 64>(ptrs, B, N, H, L, stream);
  return launch<float, 32>(ptrs, B, N, H, L, stream);
}

const char* condensed_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
