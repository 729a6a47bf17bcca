// Fused SchNet interaction stack for Hopper: forward, forward without saved
// block inputs, and backward.
//
// Replaces the TPU kernels
//   tsdiff_tpu/ops/pallas/schnet_stack_vjp.py::interaction_stack_pallas_trainable
//     (_fwd_kernel and _bwd_kernel, the custom VJP of the training path), and
//   tsdiff_tpu/ops/pallas/schnet_stack.py::interaction_stack_pallas
//     (_stack_kernel: the same forward without the saved block inputs).
//
// Per graph b, with pair rows p = i*N + j (source i, target j), P = N*N, and
// per block l (T is the working type, float or bf16):
//
//   w   = rnd(rnd(ssp(rnd(ea f1w + f1b)) f2w + f2b) * c)            (P, F)
//   xh  = rnd(h l1w)                                                 (N, F)
//   agg[j] = rnd(sum_i rnd(w[i*N+j] * xh[i]))                        (N, F)
//   h  += rnd(ssp(rnd(agg l2w + l2b)) ow + ob)                       (N, H)
//
// rnd() rounds to T; products accumulate in f32.  These are the rounding
// points of the TPU kernel (schnet_stack_vjp.py:61-67); its jnp.sum of T
// products is an f32 sum rounded once, and the aggregation here is the same
// f32 sum.  The backward walks the blocks in reverse and recomputes each
// block's pair filter from (ea, c, hs[l]), with ssp' = sigmoid, exactly as
// _bwd_kernel (:96-134) does, including its casts of dagg, da2, ds1 and da1
// to T.
//
// Design.
//   * Forward (schnet_fwd_kernel): one CTA per graph runs all L blocks.  h,
//     xh and the f32 aggregation buffer (N x H each) stay in shared memory;
//     the pair rows stream from global memory in tiles of TR rows, since one
//     graph's ea (576 x 256 bf16 at N=24) exceeds a block's shared memory.
//     Each thread owns feature columns in the aggregation, so the sum over
//     sources needs no atomics and is deterministic.  The template flag
//     kStoreHs compiles the store of the block inputs hs in (B3) or out (B4).
//   * Backward, one round per block l, from L-1 down to 0:
//     - schnet_bwd_rows_kernel, one CTA per graph: recomputes block l,
//       updates the f32 cotangent g (B, N, H) and the f32 dea (B, P, E) in
//       place (each graph's rows belong to one CTA), and writes the per-row
//       factors of the weight gradients to scratch in T, plus per-graph f32
//       column sums for the four bias gradients;
//     - schnet_bwd_sum_kernel sums the bias partials over graphs;
//     - schnet_bwd_xty_kernel is a split-K X^T Y over all rows of all graphs
//       for the five weight gradients of block l (f32 accumulation), and
//       schnet_bwd_reduce_kernel sums its partials in a fixed order.
//     The TPU kernel accumulated the weight gradients in resident outputs
//     over a sequential grid; on the GPU graphs run in parallel, and this
//     two-pass reduction keeps the result deterministic without atomics.
//
// Bound at the training shapes (B=200, N=24, H=F=E=256, L=7, bf16): the
// forward is 2.25e11 flop of matrix products (the TPU kernel's own estimate,
// schnet_stack.py:129), 0.23 ms at 989 TFLOP/s, against 59 MB of ea (18 us at
// 3.35 TB/s); the backward is 6.7e11 flop (0.68 ms) against ea, dea (f32) and
// the weights, ~180 MB (54 us).  Both are bound by the tensor cores.  This
// first version makes no attempt at that bound: mma.sync instead of wgmma, no
// TMA, weights re-read from L2 once per row tile, the backward's per-row
// factors round-trip through global memory, and the f32 path (which exists
// to check the kernels against the plain version) runs FMA loops.

#include "graph_block.cuh"

namespace {

using blk::aggregate;
using blk::load_nodes;
using blk::load_tile;
using blk::store_nodes;
using tile::from_f;
using tile::gemm;
using tile::kThreads;
using tile::rnd;
using tile::sigmoid_f;
using tile::ssp_f;
using tile::to_f;

constexpr int kFwdPtrs = 14;
constexpr int kBwdPtrs = 39;
constexpr int kJobs = 5;          // weight-gradient products per block
constexpr int kXtyTile = 64;      // output tile edge of one X^T Y CTA
constexpr int kXtyRows = 32;      // rows staged per step
constexpr int kXtyThreads = 128;  // 4 warps of 32 x 32 outputs
constexpr size_t kMaxSmem = 232448;

// Shared-memory carve-up of the per-graph kernels: two pair-row tiles, then
// `nodes` node buffers (NP x lda), the f32 accumulator (N x H) and the tile's
// cutoff mask.  Shared by the kernels and the host-side size check.
struct Smem {
  size_t tile, node, acc, total;
  int lda, np;
};

template <typename T, int TR>
__host__ __device__ inline Smem smem_layout(int N, int H, int nodes) {
  Smem s;
  s.lda = H + 16 / (int)sizeof(T);  // +16 bytes per row: conflict-free fragment loads
  s.np = (N + 15) / 16 * 16;
  s.tile = (size_t)TR * s.lda * sizeof(T);
  s.node = (size_t)s.np * s.lda * sizeof(T);
  s.acc = (size_t)N * H * sizeof(float);
  s.total = 2 * s.tile + nodes * s.node + s.acc + TR * sizeof(float);
  return s;
}

// ---------------------------------------------------------------------------
// Forward

template <typename T>
struct FwdParams {
  const T* ea;  // (B, P, H) edge features
  const T* c;   // (B, P) cutoff mask
  const T* h;   // (B, N, H) node states
  // matrices (L, out, in), biases (L, out)
  const T* f1w;
  const T* f1b;
  const T* f2w;
  const T* f2b;
  const T* l1w;
  const T* l2w;
  const T* l2b;
  const T* ow;
  const T* ob;
  T* out;       // (B, N, H)
  T* hs;        // (B, L, N, H) block inputs; unused without kStoreHs
  int B, N, H, L;
};

template <typename T, int TR, bool kStoreHs>
__global__ void __launch_bounds__(kThreads, 1) schnet_fwd_kernel(FwdParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, H = p.H, L = p.L, P = N * N;
  const Smem lay = smem_layout<T, TR>(N, H, 2);
  const int lda = lay.lda, NP = lay.np;
  T* bufA = reinterpret_cast<T*>(smem);
  T* bufB = reinterpret_cast<T*>(smem + lay.tile);
  T* h_s = reinterpret_cast<T*>(smem + 2 * lay.tile);
  T* xh_s = reinterpret_cast<T*>(smem + 2 * lay.tile + lay.node);
  float* agg = reinterpret_cast<float*>(smem + 2 * lay.tile + 2 * lay.node);
  float* c_s = agg + N * H;

  const int b = blockIdx.x;
  const T* ea_g = p.ea + (size_t)b * P * H;
  const T* c_g = p.c + (size_t)b * P;
  const blk::BlockWeights<T> w = {p.f1w, p.f1b, p.f2w, p.f2b, p.l1w, p.l2w, p.l2b, p.ow, p.ob};

  load_nodes(h_s, lda, p.h + (size_t)b * N * H, N, NP, H);
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    if (kStoreHs) store_nodes(p.hs + ((size_t)b * L + l) * N * H, h_s, lda, N, H);
    blk::interaction_block<T, TR, false>(bufA, bufB, h_s, xh_s, agg, c_s, ea_g, c_g, w.at(l, H),
                                         lda, NP, N, P, H);
  }
  store_nodes(p.out + (size_t)b * N * H, h_s, lda, N, H);
}

// ---------------------------------------------------------------------------
// Backward, per-graph part of block l

template <typename T>
struct BwdParams {
  const T* ea;   // (B, P, H)
  const T* c;    // (B, P)
  const T* hs;   // (B, L, N, H) block inputs
  // (L, out, in): the recompute's products
  const T* f1w_t;
  const T* f2w_t;
  const T* l1w_t;
  const T* l2w_t;
  // (L, in, out): the backward's products with the transposed weights
  const T* f1w;
  const T* f2w;
  const T* l1w;
  const T* l2w;
  const T* ow;
  const T* f1b;  // (L, out)
  const T* f2b;
  const T* l2b;
  float* g;      // (B, N, H) cotangent of block l's output; becomes that of its input
  float* dea;    // (B, P, H) accumulated over blocks
  // per-row factors of block l: pair rows (B*P, H), node rows (B*N, H)
  T* s1;
  T* sg1;        // rnd(sigmoid(a1))
  T* w;
  T* da2;
  T* da1;
  T* hl;
  T* dxh;
  T* agg;
  T* da3;
  T* s3;
  T* gd;         // rnd(g)
  float* bias;   // (4, B, H) per-graph column sums: df1b, df2b, dl2b, dob
  int B, N, H, L, l;
};

template <typename T, int TR>
__global__ void __launch_bounds__(kThreads, 1) schnet_bwd_rows_kernel(BwdParams<T> p) {
  constexpr int MF = TR / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, H = p.H, L = p.L, l = p.l, B = p.B, P = N * N;
  const Smem lay = smem_layout<T, TR>(N, H, 3);
  const int lda = lay.lda, NP = lay.np;
  T* bufA = reinterpret_cast<T*>(smem);
  T* bufB = reinterpret_cast<T*>(smem + lay.tile);
  T* h_s = reinterpret_cast<T*>(smem + 2 * lay.tile);
  T* xh_s = reinterpret_cast<T*>(smem + 2 * lay.tile + lay.node);
  T* dagg_s = reinterpret_cast<T*>(smem + 2 * lay.tile + 2 * lay.node);
  float* acc = reinterpret_cast<float*>(smem + 2 * lay.tile + 3 * lay.node);
  float* c_s = acc + N * H;

  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t wo = (size_t)l * H * H, bo = (size_t)l * H;
  const size_t prow = (size_t)b * P, nrow = (size_t)b * N;  // the graph's first pair / node row
  const T* ea_g = p.ea + prow * H;
  const T* c_g = p.c + prow;
  float* g_g = p.g + nrow * H;
  float* dea_g = p.dea + prow * H;
  const T *f1w_t = p.f1w_t, *f2w_t = p.f2w_t, *l1w_t = p.l1w_t, *l2w_t = p.l2w_t;
  const T *f1w = p.f1w, *f2w = p.f2w, *l1w = p.l1w, *l2w = p.l2w, *ow = p.ow;
  const T *f1b = p.f1b, *f2b = p.f2b, *l2b = p.l2b;
  T *s1 = p.s1, *sg1 = p.sg1, *wg = p.w, *da2 = p.da2, *da1 = p.da1;
  T *s3 = p.s3, *da3 = p.da3;

  // block input and xh = rnd(h_l l1w)
  load_nodes(h_s, lda, p.hs + ((size_t)b * L + l) * N * H, N, NP, H);
  __syncthreads();
  store_nodes(p.hl + nrow * H, h_s, lda, N, H);
  gemm<T, MF>(h_s, l1w_t + wo, nullptr, nullptr, lda, NP, H, H, [&](int r, int col, float v) {
    xh_s[r * lda + col] = r < N ? from_f<T>(v) : from_f<T>(0.0f);
  });
  for (int idx = tid; idx < N * H; idx += kThreads) acc[idx] = 0.0f;

  // 1. recompute the filter of every pair tile and the aggregation
  for (int r0 = 0; r0 < P; r0 += TR) {
    const int nr = min(TR, P - r0);
    for (int r = tid; r < nr; r += kThreads) c_s[r] = to_f(c_g[r0 + r]);
    load_tile(bufA, lda, ea_g + (size_t)r0 * H, nr, H);
    __syncthreads();
    gemm<T, MF>(bufA, f1w_t + wo, nullptr, nullptr, lda, nr, H, H, [&](int r, int col, float v) {
      const float a1 = v + to_f(f1b[bo + col]);
      const size_t o = (prow + r0 + r) * H + col;
      const T s = from_f<T>(ssp_f(rnd<T>(a1)));
      bufB[r * lda + col] = s;
      s1[o] = s;
      sg1[o] = from_f<T>(sigmoid_f(a1));
    });
    gemm<T, MF>(bufB, f2w_t + wo, nullptr, nullptr, lda, nr, H, H, [&](int r, int col, float v) {
      const T wv = from_f<T>(rnd<T>(v + to_f(f2b[bo + col])) * c_s[r]);
      bufA[r * lda + col] = wv;
      wg[(prow + r0 + r) * H + col] = wv;
    });
    aggregate(acc, bufA, xh_s, lda, r0, nr, N, H);
    __syncthreads();
  }

  // 2. node rows: agg -> a3 -> s3; dow and dob from g; da3; dagg
  for (int idx = tid; idx < NP * H; idx += kThreads) {
    const int r = idx / H, col = idx % H;
    const T a = r < N ? from_f<T>(acc[r * H + col]) : from_f<T>(0.0f);
    const T gd = r < N ? from_f<T>(g_g[r * H + col]) : from_f<T>(0.0f);
    h_s[r * lda + col] = a;
    bufA[r * lda + col] = gd;
    if (r < N) {
      p.agg[(nrow + r) * H + col] = a;
      p.gd[(nrow + r) * H + col] = gd;
    }
  }
  if (tid < H) {
    float s = 0.0f;
    for (int r = 0; r < N; ++r) s += g_g[r * H + tid];
    p.bias[(3 * (size_t)B + b) * H + tid] = s;  // dob
  }
  __syncthreads();
  gemm<T, MF>(h_s, l2w_t + wo, nullptr, nullptr, lda, NP, H, H, [&](int r, int col, float v) {
    if (r < N) {
      const float a3 = v + to_f(l2b[bo + col]);
      s3[(nrow + r) * H + col] = from_f<T>(ssp_f(rnd<T>(a3)));
      acc[r * H + col] = sigmoid_f(a3);
    }
  });
  // da3 = (rnd(g) ow^T) * sigmoid(a3), kept in f32 for dl2b
  gemm<T, MF>(bufA, ow + wo, nullptr, nullptr, lda, NP, H, H, [&](int r, int col, float v) {
    float d = 0.0f;
    if (r < N) {
      d = v * acc[r * H + col];
      acc[r * H + col] = d;
      da3[(nrow + r) * H + col] = from_f<T>(d);
    }
    bufB[r * lda + col] = from_f<T>(d);
  });
  gemm<T, MF>(bufB, l2w + wo, nullptr, nullptr, lda, NP, H, H, [&](int r, int col, float v) {
    dagg_s[r * lda + col] = r < N ? from_f<T>(v) : from_f<T>(0.0f);
  });
  if (tid < H) {
    float s = 0.0f;
    for (int r = 0; r < N; ++r) s += acc[r * H + tid];
    p.bias[(2 * (size_t)B + b) * H + tid] = s;  // dl2b
  }
  __syncthreads();
  for (int idx = tid; idx < N * H; idx += kThreads) acc[idx] = 0.0f;  // now dxh

  // 3. pair rows: da2, dxh, da1, dea
  float sum_da1 = 0.0f, sum_da2 = 0.0f;
  for (int r0 = 0; r0 < P; r0 += TR) {
    const int nr = min(TR, P - r0);
    for (int r = tid; r < nr; r += kThreads) c_s[r] = to_f(c_g[r0 + r]);
    __syncthreads();
    if (tid < H) {
      const int col = tid;
      for (int r = 0; r < nr; ++r) {
        const int pr = r0 + r, i = pr / N, j = pr - i * N;
        const size_t o = (prow + pr) * H + col;
        const float dg = to_f(dagg_s[j * lda + col]);
        const T d2 = from_f<T>(rnd<T>(to_f(xh_s[i * lda + col]) * dg) * c_s[r]);
        bufA[r * lda + col] = d2;
        da2[o] = d2;
        sum_da2 += to_f(d2);
        acc[i * H + col] += rnd<T>(to_f(wg[o]) * dg);
      }
    }
    __syncthreads();
    gemm<T, MF>(bufA, f2w + wo, nullptr, nullptr, lda, nr, H, H, [&](int r, int col, float v) {
      const size_t o = (prow + r0 + r) * H + col;
      const T d1 = from_f<T>(rnd<T>(v) * to_f(sg1[o]));
      bufB[r * lda + col] = d1;
      da1[o] = d1;
    });
    if (tid < H)
      for (int r = 0; r < nr; ++r) sum_da1 += to_f(bufB[r * lda + tid]);
    gemm<T, MF>(bufB, f1w + wo, nullptr, nullptr, lda, nr, H, H, [&](int r, int col, float v) {
      dea_g[(size_t)(r0 + r) * H + col] += v;
    });
  }
  if (tid < H) {
    p.bias[(0 * (size_t)B + b) * H + tid] = sum_da1;  // df1b
    p.bias[(1 * (size_t)B + b) * H + tid] = sum_da2;  // df2b
  }

  // g += rnd(dxh) l1w^T: the lin1 path into h_l (the residual path is g itself)
  for (int idx = tid; idx < NP * H; idx += kThreads) {
    const int r = idx / H, col = idx % H;
    const T d = r < N ? from_f<T>(acc[r * H + col]) : from_f<T>(0.0f);
    h_s[r * lda + col] = d;
    if (r < N) p.dxh[(nrow + r) * H + col] = d;
  }
  __syncthreads();
  gemm<T, MF>(h_s, l1w + wo, nullptr, nullptr, lda, NP, H, H, [&](int r, int col, float v) {
    if (r < N) g_g[r * H + col] += v;
  });
}

struct BiasOut {
  float* out[4];  // df1b, df2b, dl2b, dob, each (L, H)
};

// out[k][l] = sum over graphs of the per-graph partials, in graph order
__global__ void schnet_bwd_sum_kernel(const float* bias, BiasOut o, int B, int H, int l) {
  const int k = blockIdx.x;
  for (int col = threadIdx.x; col < H; col += blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += bias[((size_t)k * B + b) * H + col];
    o.out[k][(size_t)l * H + col] = s;
  }
}

// ---------------------------------------------------------------------------
// Weight gradients: out (M x M, f32) = X^T Y over `rows` rows, X and Y row
// major (rows x M) in T.  Split-K over blocks of rows, then a fixed-order sum.

template <typename T>
struct XtyJob {
  const T* x;
  const T* y;
  float* part;  // (splits, M, M)
  float* out;   // (M, M)
  int rows, splits, rows_per_split;
};

template <typename T>
struct XtyJobs {
  XtyJob<T> job[kJobs];
  int M;
};

constexpr int xty_ld(int bytes) { return kXtyRows + 16 / bytes; }

template <typename T>
struct XtyStep;

template <>
struct XtyStep<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int LD = xty_ld(2);
  // acc += xs[m rows][32]  ys[n rows][32]^T for this warp's 32 x 32 outputs
  static __device__ __forceinline__ void run(float (&acc)[2][4][4], const T* xs, const T* ys,
                                             int wm, int wn, int g, int t) {
#pragma unroll
    for (int ks = 0; ks < kXtyRows; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const T* ap = xs + (wm * 32 + mf * 16 + g) * LD + ks + 2 * t;
        a[mf][0] = *reinterpret_cast<const uint32_t*>(ap);
        a[mf][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * LD);
        a[mf][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        a[mf][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * LD + 8);
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const T* bp = ys + (wn * 32 + nf * 8 + g) * LD + ks + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          float* c = acc[mf][nf];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
              : "r"(a[mf][0]), "r"(a[mf][1]), "r"(a[mf][2]), "r"(a[mf][3]), "r"(b0), "r"(b1));
        }
      }
    }
  }
};

template <>
struct XtyStep<float> {
  static constexpr int LD = xty_ld(4);
  static __device__ __forceinline__ void run(float (&acc)[2][4][4], const float* xs,
                                             const float* ys, int wm, int wn, int g, int t) {
    for (int k = 0; k < kXtyRows; ++k) {
      float a[2][2], bv[4][2];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        a[mf][0] = xs[(wm * 32 + mf * 16 + g) * LD + k];
        a[mf][1] = xs[(wm * 32 + mf * 16 + g + 8) * LD + k];
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        bv[nf][0] = ys[(wn * 32 + nf * 8 + 2 * t) * LD + k];
        bv[nf][1] = ys[(wn * 32 + nf * 8 + 2 * t + 1) * LD + k];
      }
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          float* c = acc[mf][nf];
          c[0] = fmaf(a[mf][0], bv[nf][0], c[0]);
          c[1] = fmaf(a[mf][0], bv[nf][1], c[1]);
          c[2] = fmaf(a[mf][1], bv[nf][0], c[2]);
          c[3] = fmaf(a[mf][1], bv[nf][1], c[3]);
        }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kXtyThreads) schnet_bwd_xty_kernel(XtyJobs<T> jobs) {
  constexpr int LD = XtyStep<T>::LD;
  constexpr int kVec = 16 / sizeof(T), kSeg = kXtyTile / kVec;
  __shared__ __align__(16) unsigned char xs_raw[kXtyTile * LD * sizeof(T)];
  __shared__ __align__(16) unsigned char ys_raw[kXtyTile * LD * sizeof(T)];
  T* xs = reinterpret_cast<T*>(xs_raw);
  T* ys = reinterpret_cast<T*>(ys_raw);
  const XtyJob<T> jb = jobs.job[blockIdx.z];
  const int s = blockIdx.y;
  if (s >= jb.splits) return;
  const int M = jobs.M, tiles_n = M / kXtyTile;
  const int m0 = (blockIdx.x / tiles_n) * kXtyTile, n0 = (blockIdx.x % tiles_n) * kXtyTile;
  const int rbeg = s * jb.rows_per_split, rend = min(jb.rows, rbeg + jb.rows_per_split);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, wm = warp / 2, wn = warp % 2;

  float acc[2][4][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mf][nf][q] = 0.0f;

  for (int k0 = rbeg; k0 < rend; k0 += kXtyRows) {
    // stage rows k0.. of X[:, m0:m0+64] and Y[:, n0:n0+64] transposed: xs[m][k], ys[n][k]
    for (int v = tid; v < kXtyRows * kSeg; v += kXtyThreads) {
      const int k = v / kSeg, seg = v % kSeg;
      uint4 xv = make_uint4(0, 0, 0, 0), yv = make_uint4(0, 0, 0, 0);  // zero rows past the end
      if (k0 + k < rend) {
        xv = *reinterpret_cast<const uint4*>(jb.x + (size_t)(k0 + k) * M + m0 + seg * kVec);
        yv = *reinterpret_cast<const uint4*>(jb.y + (size_t)(k0 + k) * M + n0 + seg * kVec);
      }
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* ye = reinterpret_cast<const T*>(&yv);
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        xs[(seg * kVec + q) * LD + k] = xe[q];
        ys[(seg * kVec + q) * LD + k] = ye[q];
      }
    }
    __syncthreads();
    XtyStep<T>::run(acc, xs, ys, wm, wn, g, t);
    __syncthreads();
  }
  float* part = jb.part + (size_t)s * M * M;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) {
      const int r = m0 + wm * 32 + mf * 16 + g, c = n0 + wn * 32 + nf * 8 + 2 * t;
      part[(size_t)r * M + c] = acc[mf][nf][0];
      part[(size_t)r * M + c + 1] = acc[mf][nf][1];
      part[(size_t)(r + 8) * M + c] = acc[mf][nf][2];
      part[(size_t)(r + 8) * M + c + 1] = acc[mf][nf][3];
    }
}

template <typename T>
__global__ void schnet_bwd_reduce_kernel(XtyJobs<T> jobs) {
  const XtyJob<T> jb = jobs.job[blockIdx.y];
  const size_t MM = (size_t)jobs.M * jobs.M;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < MM;
       idx += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < jb.splits; ++q) s += jb.part[q * MM + idx];
    jb.out[idx] = s;
  }
}

// ---------------------------------------------------------------------------
// Launches

template <typename T, int TR, bool kStoreHs>
int launch_fwd(const void* const* ptrs, int B, int N, int H, int L, void* stream) {
  const Smem lay = smem_layout<T, TR>(N, H, 2);
  if (lay.np > TR || lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  FwdParams<T> p;
  int i = 0;
  p.ea = static_cast<const T*>(ptrs[i++]);
  p.c = static_cast<const T*>(ptrs[i++]);
  p.h = static_cast<const T*>(ptrs[i++]);
  const T** w[] = {&p.f1w, &p.f1b, &p.f2w, &p.f2b, &p.l1w, &p.l2w, &p.l2b, &p.ow, &p.ob};
  for (const T** slot : w) *slot = static_cast<const T*>(ptrs[i++]);
  p.out = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  p.hs = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  if (i != kFwdPtrs) return (int)cudaErrorInvalidValue;
  p.B = B; p.N = N; p.H = H; p.L = L;
  cudaError_t e = cudaFuncSetAttribute(schnet_fwd_kernel<T, TR, kStoreHs>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  schnet_fwd_kernel<T, TR, kStoreHs>
      <<<B, kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int TR>
int launch_bwd(const void* const* ptrs, int B, int N, int H, int L, int pair_rows_per_split,
               int node_rows_per_split, void* stream) {
  const Smem lay = smem_layout<T, TR>(N, H, 3);
  if (lay.np > TR || lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (pair_rows_per_split <= 0 || node_rows_per_split <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto in = [&](int k) { return static_cast<const T*>(ptrs[k]); };
  auto tmp = [&](int k) { return static_cast<T*>(const_cast<void*>(ptrs[k])); };
  auto f32 = [&](int k) { return static_cast<float*>(const_cast<void*>(ptrs[k])); };

  BwdParams<T> p;
  p.ea = in(0); p.c = in(1); p.hs = in(2); p.g = f32(3); p.dea = f32(4);
  p.f1w_t = in(5); p.f2w_t = in(6); p.l1w_t = in(7); p.l2w_t = in(8);
  p.f1w = in(9); p.f2w = in(10); p.l1w = in(11); p.l2w = in(12); p.ow = in(13);
  p.f1b = in(14); p.f2b = in(15); p.l2b = in(16);
  // gradients in the order f1w, f1b, f2w, f2b, l1w, l2w, l2b, ow, ob
  float* df1w = f32(17);
  float* df2w = f32(19);
  float* dl1w = f32(21);
  float* dl2w = f32(22);
  float* dow = f32(24);
  const BiasOut bias_out = {{f32(18), f32(20), f32(23), f32(25)}};
  p.s1 = tmp(26); p.sg1 = tmp(27); p.w = tmp(28); p.da2 = tmp(29); p.da1 = tmp(30);
  p.hl = tmp(31); p.dxh = tmp(32); p.agg = tmp(33); p.da3 = tmp(34); p.s3 = tmp(35);
  p.gd = tmp(36);
  p.bias = f32(37);
  float* part = f32(38);
  p.B = B; p.N = N; p.H = H; p.L = L;

  cudaError_t e = cudaFuncSetAttribute(schnet_bwd_rows_kernel<T, TR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)lay.total);
  if (e != cudaSuccess) return (int)e;

  const size_t HH = (size_t)H * H;
  const int pair_rows = B * N * N, node_rows = B * N;
  const int pair_splits = (pair_rows + pair_rows_per_split - 1) / pair_rows_per_split;
  const int node_splits = (node_rows + node_rows_per_split - 1) / node_rows_per_split;
  const T* xs[kJobs] = {p.ea, p.s1, p.hl, p.agg, p.s3};
  const T* ys[kJobs] = {p.da1, p.da2, p.dxh, p.da3, p.gd};
  float* outs[kJobs] = {df1w, df2w, dl1w, dl2w, dow};

  for (int l = L - 1; l >= 0; --l) {
    p.l = l;
    schnet_bwd_rows_kernel<T, TR><<<B, kThreads, lay.total, st>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    schnet_bwd_sum_kernel<<<4, kThreads, 0, st>>>(p.bias, bias_out, B, H, l);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    XtyJobs<T> jobs;
    jobs.M = H;
    size_t off = 0;
    for (int k = 0; k < kJobs; ++k) {
      const bool pair = k < 2;
      XtyJob<T>& jb = jobs.job[k];
      jb.x = xs[k];
      jb.y = ys[k];
      jb.rows = pair ? pair_rows : node_rows;
      jb.splits = pair ? pair_splits : node_splits;
      jb.rows_per_split = pair ? pair_rows_per_split : node_rows_per_split;
      jb.part = part + off;
      jb.out = outs[k] + (size_t)l * HH;
      off += (size_t)jb.splits * HH;
    }
    const int tiles = (H / kXtyTile) * (H / kXtyTile);
    const int max_splits = pair_splits > node_splits ? pair_splits : node_splits;
    schnet_bwd_xty_kernel<T><<<dim3(tiles, max_splits, kJobs), kXtyThreads, 0, st>>>(jobs);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    schnet_bwd_reduce_kernel<T><<<dim3((int)((HH + 255) / 256), kJobs), 256, 0, st>>>(jobs);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

bool bad_shape(int B, int N, int H, int L) {
  return B <= 0 || N <= 0 || N % 8 != 0 || H <= 0 || H % 64 != 0 || H > kThreads || L < 0;
}

}  // namespace

extern "C" {

// Forward of the stack on `stream`; returns the cudaError_t of the launch.
// ptrs: ea, c, h, then f1w f1b f2w f2b l1w l2w l2b ow ob (matrices (L, out,
// in)), out, hs (ignored unless store_hs).
int schnet_stack_fwd_launch(const void* const* ptrs, int B, int N, int H, int L, int is_bf16,
                            int store_hs, void* stream) {
  if (bad_shape(B, N, H, L)) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    using T = __nv_bfloat16;
    return store_hs ? launch_fwd<T, 64, true>(ptrs, B, N, H, L, stream)
                    : launch_fwd<T, 64, false>(ptrs, B, N, H, L, stream);
  }
  return store_hs ? launch_fwd<float, 32, true>(ptrs, B, N, H, L, stream)
                  : launch_fwd<float, 32, false>(ptrs, B, N, H, L, stream);
}

// Backward of the stack on `stream` (4 launches per block); returns the first
// failing cudaError_t.  ptrs, in order: ea, c, hs, g (f32, in: the output's
// cotangent, out: dh), dea (f32, zeroed by the caller); f1w f2w l1w l2w as
// (L, out, in); f1w f2w l1w l2w ow as (L, in, out); f1b f2b l2b; the nine f32
// gradients f1w f1b f2w f2b l1w l2w l2b ow ob; pair scratch s1 sg1 w da2 da1
// (B*N*N, H); node scratch hl dxh agg da3 s3 gd (B*N, H); the (4, B, H) f32
// bias partials; the f32 split-K partials, (2 * ceil(B*N*N / pair_rows_per_split)
// + 3 * ceil(B*N / node_rows_per_split)) * H * H.
int schnet_stack_bwd_launch(const void* const* ptrs, int B, int N, int H, int L, int is_bf16,
                            int pair_rows_per_split, int node_rows_per_split, void* stream) {
  if (bad_shape(B, N, H, L)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_bwd<__nv_bfloat16, 64>(ptrs, B, N, H, L, pair_rows_per_split,
                                         node_rows_per_split, stream);
  return launch_bwd<float, 32>(ptrs, B, N, H, L, pair_rows_per_split, node_rows_per_split,
                               stream);
}

const char* schnet_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
