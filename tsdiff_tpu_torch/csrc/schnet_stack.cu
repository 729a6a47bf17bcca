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
//   * Forward, one CTA per graph runs all L blocks.  h, xh and the f32
//     aggregation buffer (N x H each) stay in shared memory; the pair rows
//     stream from global memory in 64-row tiles, since one graph's ea (576 x
//     256 bf16 at N=24) exceeds a block's shared memory.  The aggregation
//     sums each node's sources in a fixed order, without atomics.  The
//     template flag kStoreHs compiles the store of the block inputs hs in
//     (B3) or out (B4).  bf16 at H = 256, N <= 24 takes schnet_fwd_wg_kernel
//     (wgmma on csrc/wg_pipeline.cuh, below); f32 and other shapes take the
//     first port's schnet_fwd_kernel (mma.sync), by the explicit branch in
//     launch_fwd.
//   * Backward, one round per block l, from L-1 down to 0:
//     - the row kernel, one CTA per graph: recomputes block l, updates the
//       f32 cotangent g (B, N, H) and the f32 dea (B, P, E) in place (each
//       graph's rows belong to one CTA), and writes the per-row factors of
//       the weight gradients to scratch in T, plus per-graph f32 column sums
//       for the four bias gradients.  bf16 at H = 256 and N <= 24 takes
//       schnet_bwd_rows_wg_kernel (wgmma on csrc/wg_pipeline.cuh, below);
//       f32 and other shapes take schnet_bwd_rows_kernel (mma.sync), by the
//       explicit branch in launch_bwd;
//     - schnet_bwd_sum_kernel sums the bias partials over graphs;
//     - a split-K X^T Y over all rows of all graphs for the five weight
//       gradients of block l (f32 accumulation), then a sum of its partials
//       in a fixed order.  bf16 at H = 256 takes schnet_bwd_xty_wg_kernel
//       (wgmma with both operands read transposed, tensor copies, one
//       persistent CTA per SM; below) and schnet_bwd_xty_wg_reduce_kernel;
//       f32 and other shapes take schnet_bwd_xty_kernel (mma.sync) and
//       schnet_bwd_reduce_kernel, by the explicit branch in launch_bwd.
//     The TPU kernel accumulated the weight gradients in resident outputs
//     over a sequential grid; on the GPU graphs run in parallel, and this
//     two-pass reduction keeps the result deterministic without atomics.
//
// Bound at the training shapes (B=200, N=24, H=F=E=256, L=7, bf16): the
// forward is 2.25e11 flop of matrix products (the TPU kernel's own estimate,
// schnet_stack.py:129), 0.23 ms at 989 TFLOP/s, against 59 MB of ea (18 us at
// 3.35 TB/s); the backward is 6.7e11 flop (0.68 ms) against ea, dea (f32) and
// the weights, ~180 MB (54 us).  Both are bound by the tensor cores.  The
// first port's mma.sync kernels make no attempt at that bound: weights
// re-read from L2 once per row tile, the backward's per-row factors round-trip
// through global memory, and the f32 path (which exists to check the kernels
// against the plain version) runs FMA loops.
//
// The Hopper kernels (bf16, H = F = E = 256, N <= 24, N % 8 == 0 so that
// P = N*N fills whole 64-row tiles) follow the dense score kernel's design
// (csrc/condensed_score.cu):
//   * the grid.  One CTA per graph: at B = 200 that is 200 CTAs on 132 SMs,
//     1.52 waves, 5 tile pairs per CTA and pass at N = 24.  A two-CTA
//     cluster per graph (400 CTAs, 3.03 waves of 3 and 2 tile pairs, agg,
//     dxh and dagg exchanged through distributed shared memory) makes 4
//     waves of 3 pairs = 12 pair units against 2 waves of 5 = 10, plus the
//     exchange; persistent CTAs (132, each walking 1.52 graphs) leave the
//     same 2 waves' worth on the busiest SM.  One CTA per graph is the least.
//   * a producer warp walks a static schedule of weight stages through the
//     3-stage ring from one image of every block's ten matrices
//     (ops/schnet_stack.py::arrange_stack_weights, made on the host once per
//     train step: a forward product reads its matrix transposed, f1w^T,
//     f2w^T, l1w^T, l2w^T, ow^T, a backward one ow, l2w, f2w, f1w, l1w as
//     they are, so every product has a weight matrix as its B operand and
//     runs on wg::mma_stage_bf16 unchanged), and it fetches the ea tile
//     images (tile_image(ea, 64), made once per train step as well) into
//     tile A.
//
// The forward, schnet_fwd_wg_kernel: one launch for the L blocks, each B2's
// interaction block (wgb::interaction_block, which both kernels call),
// walking ops/schnet_stack.py::stack_fwd_schedule (8 (3 + 2 pairs) stages a
// block): xh = rnd(h l1w) from h's node image; per tile pair s1 =
// rnd(ssp(rnd(ea f1w + f1b))) into tile B and w = rnd(rnd(s1 f2w + f2b) c)
// into tile A, then agg[j] += rnd(w[i*N+j] xh[i]), i ascending; the node
// update on the node images in the B tiles, h in place.  Nothing but hs and
// the output goes to global memory.  2*B*L*(2*P*H^2 + 3*N*H^2) flop: 2.25e11
// at the training shapes, 0.23 ms at 989 TFLOP/s.
//
// The row kernel, schnet_bwd_rows_wg_kernel, one launch per block.  Its own
// products are 2*B*(2*P*H^2 + 2*P*H^2 + 5*N*H^2) flop per block: at the
// training shapes 4.45e11 over the 7 blocks, 0.45 ms at 989 TFLOP/s
// (ops/schnet_stack.py::schnet_stack_cost, "bwd_rows"), walking
// ops/schnet_stack.py::stack_bwd_schedule:
//   * pass 1, per tile pair: a1 = ea f1w + f1b -> s1 (tile B, global),
//     rnd(sigmoid(a1)) (global sg1); a2 = s1 f2w + f2b -> w = rnd(rnd(a2) c)
//     (tile A, global); agg[j] += rnd(w[i*N+j] xh[i]), i ascending.
//   * node stage, the two warpgroups on alternate 32-column stages: a3 =
//     rnd(agg) l2w + l2b -> s3, sigmoid(a3); da3 = (rnd(g) ow^T) sigmoid(a3);
//     dagg = rnd(rnd(da3) l2w^T).  The B tiles and warpgroup 0's A tile hold
//     the node images; h's slot takes dagg, the f32 agg buffer takes in turn
//     agg, sigmoid(a3), da3 and dxh.
//   * pass 2, per tile pair: one bulk copy brings the tile's w rows (row
//     major, as pass 1 stored them) into tile B; the consumers build the
//     da2 = rnd(rnd(xh[i] dagg[j]) c) tile image in tile A and store it;
//     dxh[i] += rnd(w[i*N+j] dagg[j]), j ascending, pair after pair (the
//     two warpgroups take alternate source nodes: no atomics, bitwise
//     repeatable); ds1 = da2 f2w^T -> da1 = rnd(rnd(ds1) sg1) (tile B,
//     global); dea[p] += da1 f1w^T, an f32 read-modify-write of the graph's
//     own rows.  w, sg1 and dea of the next tile pair are put into L2 ahead.
//   * end: g += rnd(dxh) l1w^T.  Column sums for the bias gradients in a
//     fixed order: per thread over its tiles' rows, warpgroup 0's plus
//     warpgroup 1's.
//   Global stores go at constant offsets from per-tile row bases; warp
//   indices come from __shfl_sync (ptxas serializes wgmma under a branch it
//   takes for divergent); every mbarrier wait is bounded.

#include <cuda.h>

#include <type_traits>

#include "graph_block.cuh"
#include "wg_pipeline.cuh"

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

constexpr int kFwdPtrs = 16;
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

// ---------------------------------------------------------------------------
// The forward and the row kernel on the warp-specialised pipeline (bf16,
// H = 256, N <= 24).  Shared memory is wgb::dense_layout's without the row
// table: h as a node tile image, xh as N plain rows, the tiles A0, B0, A1, B1,
// the f32 node buffer and six mbarriers beside the ring's (per warpgroup the
// ea tile, full and empty, and the row kernel's w tile of pass 2, full); at
// N = 24 the ring has 3 stages.

using wgb::act_ssp;
using wgb::aggregate_dense_pair;
using wgb::bf16;
using wgb::GraphSmem;
using wgb::kH;
using wgb::kHH;
using wgb::kStageElems;
using wgb::kStagesPerMat;
using wgb::kTileElems;
using wgb::ld2;
using wgb::ld_shared32;
using wgb::prefetch_l2;
using wgb::rb;
using wgb::st_shared32;
using wg::img_off;
using wg::pack_bf16;
using wg::unpack_bf16;

// The ten matrices of a block in the arranged image, one image for both
// kernels (ops/schnet_stack.py::STACK_ORDER): the row kernel's producer walks
// the first nine in this order, the forward's reads l1w^T, f1w^T, f2w^T,
// l2w^T and ow^T.  A forward product's B operand is the transposed (out, in)
// matrix, a backward product's the (in, out) matrix as it is.
enum StackMat { kL1wT, kF1wT, kF2wT, kL2wT, kOw, kL2w, kF2w, kF1w, kL1w, kOwT, kStackMats };

// Both kernels need N % 8 == 0 (whole 64-row pair tiles) and the 3 ring
// stages that the carve-up leaves up to N = 24.
bool fwd_wg_takes(int N, int H, int is_bf16) {
  return is_bf16 && H == kH && N > 0 && N % 8 == 0 && N <= 24 &&
         wgb::dense_layout(N, false).stages >= 3;
}
bool bwd_wg_takes(int N, int H, int is_bf16) { return fwd_wg_takes(N, H, is_bf16); }

__device__ __forceinline__ float act_sigmoid(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ void st_global32(bf16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}
// two bf16 values this kernel wrote earlier (through L2, not the read-only path)
__device__ __forceinline__ float2 ld_cg2(const bf16* p) {
  return unpack_bf16(__ldcg(reinterpret_cast<const unsigned int*>(p)));
}
// the product of two packed bf16 pairs rounded once to bf16, as float2
__device__ __forceinline__ float2 mul_bf16x2(uint32_t a, uint32_t b) {
  return __bfloat1622float2(__hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                    *reinterpret_cast<const __nv_bfloat162*>(&b)));
}
__device__ __forceinline__ void add2(float2& s, float2 v) {
  s.x += v.x;
  s.y += v.y;
}

// h (the node tile image) as N rows of global memory at dst; the consumers
__device__ __forceinline__ void store_h(bf16* dst, const unsigned char* sm, const GraphSmem& lay,
                                       int tid, int N) {
  for (int idx = tid; idx < N * 32; idx += wg::kConsumers) {
    const int row = idx >> 5, unit = idx & 31;
    *reinterpret_cast<uint4*>(dst + (size_t)row * kH + unit * 8) =
        *reinterpret_cast<const uint4*>(sm + lay.h + img_off<2>(row, unit * 8, lay.node_stride));
  }
}

// All L blocks of one graph per CTA; kStoreHs: each block's input h to hs
// (B3), else not (B4).  The producer fetches the ea tiles from ea's tile
// images and walks 8 (3 + 2 pairs) weight stages a block.
template <bool kStoreHs>
__global__ void __launch_bounds__(wg::kThreads, 1)
schnet_fwd_wg_kernel(FwdParams<bf16> p, const bf16* __restrict__ wimg,
                     const bf16* __restrict__ ea_img) {
  extern __shared__ unsigned char smem_raw[];
  const int N = p.N, L = p.L, P = N * N, ntiles = P / 64, npairs = (ntiles + 1) / 2;
  const GraphSmem lay = wgb::dense_layout(N, false);
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full = base + lay.bars, empty = full + 8 * wg::kMaxStages;
  const uint32_t afull = empty + 8 * wg::kMaxStages, aempty = afull + 16;
  float* agg = reinterpret_cast<float*>(sm + lay.agg);

  const int b = blockIdx.x, tid = threadIdx.x;
  // warp-uniform by construction, and known to the compiler as such: wgmma
  // under a branch it takes for divergent is serialized
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const size_t prow = (size_t)b * P, nrow = (size_t)b * N;  // the graph's first pair / node row

  // barriers; the input h as a node tile image
  if (tid == 0) {
    wg::ring_init(full, empty, lay.stages);
    for (int w = 0; w < 2; ++w) {
      wg::mbar_init(afull + 8 * w, 1);
      wg::mbar_init(aempty + 8 * w, 1);
    }
    wg::mbar_init_fence();
  }
  for (int idx = tid; idx < N * 32; idx += wg::kThreads) {
    const int row = idx >> 5, unit = idx & 31;
    *reinterpret_cast<uint4*>(sm + lay.h + img_off<2>(row, unit * 8, lay.node_stride)) =
        *reinterpret_cast<const uint4*>(p.h + (nrow + row) * kH + unit * 8);
  }
  wg::fence_async_shared();
  __syncthreads();

  if (warp_idx >= wg::kConsumers / 32) {
    // ===== producer: the static schedule of weight stages and ea tiles =====
    wg::reg_dealloc<wg::kRegsProducer>();
    if (tid == wg::kConsumers) {
      wg::Ring ring{full, empty, base + lay.ring, lay.stages};
      const bf16* ea_g = ea_img + prow * kH;  // the graph's P / 64 tile images
      uint32_t aphase = 0;  // bit w: the parity warpgroup w's tile A was last waited on
      for (int l = 0; l < L; ++l) {
        const bf16* wl = wimg + (size_t)l * kStackMats * kHH;  // block l's matrices
        auto fill_mat = [&](int m) {
          for (int c = 0; c < kStagesPerMat; ++c) ring.fill(wl + (size_t)m * kHH + c * kStageElems);
        };
        fill_mat(kL1wT);
        for (int tp = 0; tp < npairs; ++tp) {
          for (int w = 0; w < 2; ++w) {
            const int ti = 2 * tp + w;
            if (ti >= ntiles) continue;
            wg::mbar_wait(aempty + 8 * w, ((aphase >> w) & 1) ^ 1);
            aphase ^= 1u << w;
            wg::mbar_expect_tx(afull + 8 * w, wg::kTileBytes);
            wg::bulk_load(base + lay.tiles + 2 * w * wg::kTileBytes,
                          ea_g + (size_t)ti * kTileElems, wg::kTileBytes, afull + 8 * w);
          }
          fill_mat(kF1wT);
          fill_mat(kF2wT);
        }
        fill_mat(kL2wT);
        fill_mat(kOwT);
      }
    }
    return;
  }

  // ===== consumers: one 64-row tile of each tile pair per warpgroup =====
  wg::reg_alloc<wg::kRegsConsumer>();
  WG_T_BEGIN(t_consumer);
  wg::Ring ring{full, empty, base + lay.ring, lay.stages};
  const int w = warp_idx >> 2;
  const bf16* c_g = p.c + prow;
  uint32_t afp = 0;
  for (int l = 0; l < L; ++l) {
    const size_t bo = (size_t)l * kH;
    // the block's input (the last block has ended with a barrier of the consumers)
    if (kStoreHs) store_h(p.hs + ((size_t)b * L + l) * N * kH, sm, lay, tid, N);
    wgb::interaction_block(ring, sm, base, lay, agg, c_g, p.f1b + bo, p.f2b + bo, p.l2b + bo,
                           p.ob + bo, afull, aempty, afp, w, tid, N);
  }
  store_h(p.out + nrow * kH, sm, lay, tid, N);
  WG_T_END(wg::kProfTotal, t_consumer);
}

// dxh[i] += rnd(w[i*N+j] * dagg[j]) over the rows i*N+j of tile pair tp, j
// ascending.  The w rows sit as plain 512-byte rows in the B tiles of the two
// warpgroups, dagg as N plain rows in h's slot.  Warpgroup w takes the pair's
// sources i_lo + w, i_lo + w + 2, ..., a thread two feature columns; pairs
// come in order, so every source sums its N targets in ascending j, the same
// f32 sums in every run.  (The caller has put a barrier of the consumers
// before, once both w tiles have arrived, and puts one after.)
__device__ __forceinline__ void dxh_pair(unsigned char* sm, const GraphSmem& lay, float* dxh,
                                         int tp, int w, int ct, int N, int P) {
  const int pr0 = 128 * tp, nrows = min(P, pr0 + 128) - pr0;
  const int i_lo = pr0 / N, i_hi = (pr0 + nrows - 1) / N;
  const uint32_t w_col = lay.tiles + wg::kTileBytes + 4 * ct, d_col = lay.h + 4 * ct;
  for (int i = i_lo + w; i <= i_hi; i += 2) {
    float2 v = *reinterpret_cast<const float2*>(dxh + i * kH + 2 * ct);
    const int j_lo = max(0, pr0 - i * N), j_hi = min(N - 1, pr0 + nrows - 1 - i * N);
    for (int j = j_lo; j <= j_hi; ++j) {
      const uint32_t q = i * N + j - pr0;  // row q & 63 of warpgroup q >> 6's tile B
      add2(v, mul_bf16x2(ld_shared32(sm, w_col + (q >> 6) * (2 * wg::kTileBytes) + (q & 63) * 512),
                         ld_shared32(sm, d_col + j * (2 * kH))));
    }
    *reinterpret_cast<float2*>(dxh + i * kH + 2 * ct) = v;
  }
}

__global__ void __launch_bounds__(wg::kThreads, 1)
schnet_bwd_rows_wg_kernel(BwdParams<bf16> p, const bf16* __restrict__ wimg,
                          const bf16* __restrict__ ea_img) {
  extern __shared__ unsigned char smem_raw[];
  const int N = p.N, P = N * N, B = p.B, l = p.l, ntiles = P / 64, npairs = (ntiles + 1) / 2;
  const GraphSmem lay = wgb::dense_layout(N, false);
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full = base + lay.bars, empty = full + 8 * wg::kMaxStages;
  const uint32_t afull = empty + 8 * wg::kMaxStages, aempty = afull + 16, wfull = aempty + 16;
  float* agg = reinterpret_cast<float*>(sm + lay.agg);
  const uint32_t ns = lay.node_stride;

  const int b = blockIdx.x, tid = threadIdx.x;
  // warp-uniform by construction, and known to the compiler as such: wgmma
  // under a branch it takes for divergent is serialized
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const size_t prow = (size_t)b * P, nrow = (size_t)b * N;  // the graph's first pair / node row
  const bf16* wl = wimg + (size_t)l * kStackMats * kHH;     // block l's matrices

  // barriers; the block input h_l as a node tile image, and to hl
  if (tid == 0) {
    wg::ring_init(full, empty, lay.stages);
    for (int w = 0; w < 2; ++w) {
      wg::mbar_init(afull + 8 * w, 1);
      wg::mbar_init(aempty + 8 * w, 1);
      wg::mbar_init(wfull + 8 * w, 1);
    }
    wg::mbar_init_fence();
  }
  const bf16* h_g = p.hs + ((size_t)b * p.L + l) * N * kH;
  for (int idx = tid; idx < N * 32; idx += wg::kThreads) {
    const int row = idx >> 5, unit = idx & 31;
    const uint4 v = *reinterpret_cast<const uint4*>(h_g + (size_t)row * kH + unit * 8);
    *reinterpret_cast<uint4*>(sm + lay.h + img_off<2>(row, unit * 8, ns)) = v;
    *reinterpret_cast<uint4*>(p.hl + (nrow + row) * kH + unit * 8) = v;
  }
  wg::fence_async_shared();
  __syncthreads();

  if (warp_idx >= wg::kConsumers / 32) {
    // ===== producer: the static schedule of weight stages and ea tiles =====
    wg::reg_dealloc<wg::kRegsProducer>();
    if (tid == wg::kConsumers) {
      wg::Ring ring{full, empty, base + lay.ring, lay.stages};
      auto fill_mat = [&](int m) {
        for (int c = 0; c < kStagesPerMat; ++c) ring.fill(wl + (size_t)m * kHH + c * kStageElems);
      };
      const bf16* ea_g = ea_img + prow * kH;  // the graph's P / 64 tile images
      fill_mat(kL1wT);
      uint32_t aphase = 0;  // bit w: the parity warpgroup w's tile A was last waited on
      for (int tp = 0; tp < npairs; ++tp) {
        for (int w = 0; w < 2; ++w) {
          const int ti = 2 * tp + w;
          if (ti >= ntiles) continue;
          wg::mbar_wait(aempty + 8 * w, ((aphase >> w) & 1) ^ 1);
          aphase ^= 1u << w;
          wg::mbar_expect_tx(afull + 8 * w, wg::kTileBytes);
          wg::bulk_load(base + lay.tiles + 2 * w * wg::kTileBytes, ea_g + (size_t)ti * kTileElems,
                        wg::kTileBytes, afull + 8 * w);
        }
        fill_mat(kF1wT);
        fill_mat(kF2wT);
      }
      fill_mat(kL2wT);
      fill_mat(kOw);
      fill_mat(kL2w);
      for (int tp = 0; tp < npairs; ++tp) {
        fill_mat(kF2w);
        fill_mat(kF1w);
      }
      fill_mat(kL1w);
    }
    return;
  }

  // ===== consumers: one 64-row tile of each tile pair per warpgroup =====
  wg::reg_alloc<wg::kRegsConsumer>();
  WG_T_BEGIN(t_consumer);
  wg::Ring ring{full, empty, base + lay.ring, lay.stages};
  const int w = warp_idx >> 2, ct = tid & 127, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = ((ct >> 5) << 4) + g, r_hi = r_lo + 8;
  const bool elected = ct == 0;
  const int bar_wg = wgb::kBarWg0 + w;
  const uint32_t ta_off = lay.tiles + 2 * w * wg::kTileBytes, tb_off = ta_off + wg::kTileBytes;
  const uint32_t tile_a = base + ta_off, tile_b = base + tb_off;
  const bf16* c_g = p.c + prow;
  float* g_g = p.g + nrow * kH;
  const size_t bo = (size_t)l * kH;
  const bf16 *f1b = p.f1b + bo, *f2b = p.f2b + bo, *l2b = p.l2b + bo;
  uint32_t hold[64];  // product_bf16's kept registers: unused here (kKeep false)
  // after generic stores into a tile: visible to wgmma, in every warp
  auto publish = [&]() {
    wg::fence_async_shared();
    wg::bar_sync(bar_wg, 128);
  };
  auto consumers_sync = [&]() { wg::bar_sync(wgb::kBarConsumers, wg::kConsumers); };
  // this thread's first element of a tile's pair rows (row r_lo, column 2t):
  // the epilogues store at constant offsets from it
  auto row_base = [&](int r0, bool active) {
    return (prow + (active ? r0 : 0) + r_lo) * kH + 2 * t;
  };
  // this warpgroup's rows of tile ti in w, sg1 and dea into L2 (one thread)
  auto prefetch_rows = [&](int ti) {
    if (elected && ti < ntiles) {
      const size_t o = (prow + (size_t)ti * 64) * kH;
      prefetch_l2(p.w + o, wg::kTileBytes);
      prefetch_l2(p.sg1 + o, wg::kTileBytes);
      prefetch_l2(p.dea + o, wg::kTileBytes);
      prefetch_l2(p.dea + o + kTileElems / 2, wg::kTileBytes);
    }
  };

  // xh = rnd(h_l l1w) as N plain rows; agg = 0
  WG_T(wg::kProfNodeProducts, wgb::block_begin(ring, sm, base, lay, agg, w, tid, r_lo, t, N));

  // ----- pass 1: the filter of every pair tile and the aggregation -----
  uint32_t afp = 0;
  for (int tp = 0; tp < npairs; ++tp) {
    const int ti = 2 * tp + w, r0 = ti * 64;
    const bool active = ti < ntiles;
    float c_lo = 0.0f, c_hi = 0.0f;
    const size_t o_lo = row_base(r0, active);
    bf16 *s1_lo = p.s1 + o_lo, *sg_lo = p.sg1 + o_lo, *w_lo = p.w + o_lo;
    if (active) {
      c_lo = __bfloat162float(c_g[r0 + r_lo]);
      c_hi = __bfloat162float(c_g[r0 + r_hi]);
      WG_T(wg::kProfTileWait, wg::mbar_wait(afull + 8 * w, afp));
      afp ^= 1;
    }
    // a1 = ea f1w + f1b: s1 = rnd(ssp(rnd(a1))) into tile B and to global,
    // rnd(sigmoid(a1)) to global
    wg::product_bf16<kStagesPerMat, false, false>(
        ring, active, tile_a, 0, wg::kAtomBytes, hold,
        [&](int c, float (&acc)[16], uint32_t (&)[8]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * c + 8 * j;
            const float2 bias = ld2(f1b, col + 2 * t);
            const float a00 = acc[4 * j] + bias.x, a01 = acc[4 * j + 1] + bias.y;
            const float a10 = acc[4 * j + 2] + bias.x, a11 = acc[4 * j + 3] + bias.y;
            const uint32_t slo = pack_bf16(act_ssp(rb(a00)), act_ssp(rb(a01)));
            const uint32_t shi = pack_bf16(act_ssp(rb(a10)), act_ssp(rb(a11)));
            st_shared32(sm, tb_off + img_off<2>(r_lo, col + 2 * t), slo);
            st_shared32(sm, tb_off + img_off<2>(r_hi, col + 2 * t), shi);
            st_global32(s1_lo + col, slo);
            st_global32(s1_lo + 8 * kH + col, shi);
            st_global32(sg_lo + col, pack_bf16(act_sigmoid(a00), act_sigmoid(a01)));
            st_global32(sg_lo + 8 * kH + col, pack_bf16(act_sigmoid(a10), act_sigmoid(a11)));
          }
        });
    if (active) publish();  // s1 visible to wgmma; every warp's reads of tile A have ended
    // w = rnd(rnd(s1 f2w + f2b) * c) into tile A and to global
    wg::product_bf16<kStagesPerMat, false, false>(
        ring, active, tile_b, 0, wg::kAtomBytes, hold,
        [&](int c, float (&acc)[16], uint32_t (&)[8]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * c + 8 * j;
            const float2 bias = ld2(f2b, col + 2 * t);
            const uint32_t lo = pack_bf16(rb(acc[4 * j] + bias.x) * c_lo,
                                          rb(acc[4 * j + 1] + bias.y) * c_lo);
            const uint32_t hi = pack_bf16(rb(acc[4 * j + 2] + bias.x) * c_hi,
                                          rb(acc[4 * j + 3] + bias.y) * c_hi);
            st_shared32(sm, ta_off + img_off<2>(r_lo, col + 2 * t), lo);
            st_shared32(sm, ta_off + img_off<2>(r_hi, col + 2 * t), hi);
            st_global32(w_lo + col, lo);
            st_global32(w_lo + 8 * kH + col, hi);
          }
        });
    consumers_sync();  // both w tiles are written
    WG_T(wg::kProfAggregate, aggregate_dense_pair(sm, lay, agg, tp, w, ct, N, P));
    // the w tiles are read, agg is whole; the generic stores into tile A are
    // ordered before the bulk copy that refills it
    wg::fence_async_shared();
    consumers_sync();
    if (active && elected) wg::mbar_arrive(aempty + 8 * w);  // tile A takes the next ea tile
  }

  // ----- node stage -----
  // the pass-1 scratch stores are ordered before pass 2's bulk copies of w
  wg::fence_async_all();
  WG_T_BEGIN(t_node);
  const uint32_t agg_img = lay.tiles + wg::kTileBytes;     // warpgroup 0's tile B
  const uint32_t gd_img = lay.tiles + 3 * wg::kTileBytes;  // warpgroup 1's tile B
  const uint32_t da3_img = lay.tiles;                      // warpgroup 0's tile A
  for (int idx = tid; idx < N * (kH / 2); idx += wg::kConsumers) {
    const int row = idx >> 7, col = 2 * (idx & 127);
    const float2 a = *reinterpret_cast<const float2*>(agg + row * kH + col);
    const float2 gv = *reinterpret_cast<const float2*>(g_g + row * kH + col);
    const uint32_t ap = pack_bf16(a.x, a.y), gp = pack_bf16(gv.x, gv.y);
    st_shared32(sm, agg_img + img_off<2>(row, col, ns), ap);
    st_shared32(sm, gd_img + img_off<2>(row, col, ns), gp);
    st_global32(p.agg + (nrow + row) * kH + col, ap);
    st_global32(p.gd + (nrow + row) * kH + col, gp);
  }
  if (tid < kH) {
    float s = 0.0f;
    for (int r = 0; r < N; ++r) s += g_g[r * kH + tid];
    p.bias[(3 * (size_t)B + b) * kH + tid] = s;  // dob
  }
  wg::fence_async_shared();
  consumers_sync();
  // a3 = rnd(agg) l2w + l2b: s3 to global, sigmoid(a3) into the f32 buffer
  bf16* s3_g = p.s3 + nrow * kH + 2 * t;
  wgb::node_product(ring, w, base + agg_img, ns, [&](int c, float (&acc)[16]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * c + 8 * j;
      const float2 bias = ld2(l2b, col + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r_hi : r_lo;
        if (r < N) {
          const float a0 = acc[4 * j + 2 * h] + bias.x, a1 = acc[4 * j + 2 * h + 1] + bias.y;
          st_global32(s3_g + r * kH + col, pack_bf16(act_ssp(rb(a0)), act_ssp(rb(a1))));
          *reinterpret_cast<float2*>(agg + r * kH + col + 2 * t) =
              make_float2(act_sigmoid(a0), act_sigmoid(a1));
        }
      }
    }
  });
  consumers_sync();
  // da3 = (rnd(g) ow^T) sigmoid(a3): f32 in the buffer, rnd(da3) to global
  // and into a node image
  bf16* da3_g = p.da3 + nrow * kH + 2 * t;
  wgb::node_product(ring, w, base + gd_img, ns, [&](int c, float (&acc)[16]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * c + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r_hi : r_lo;
        if (r < N) {
          float2* q = reinterpret_cast<float2*>(agg + r * kH + col + 2 * t);
          const float2 s = *q;
          const float2 d = make_float2(acc[4 * j + 2 * h] * s.x, acc[4 * j + 2 * h + 1] * s.y);
          *q = d;
          const uint32_t pk = pack_bf16(d.x, d.y);
          st_global32(da3_g + r * kH + col, pk);
          st_shared32(sm, da3_img + img_off<2>(r, col + 2 * t, ns), pk);
        }
      }
    }
  });
  wg::fence_async_shared();
  consumers_sync();
  if (tid < kH) {
    float s = 0.0f;
    for (int r = 0; r < N; ++r) s += agg[r * kH + tid];
    p.bias[(2 * (size_t)B + b) * kH + tid] = s;  // dl2b
  }
  // dagg = rnd(rnd(da3) l2w^T) as N plain rows in h's slot
  wgb::node_product(ring, w, base + da3_img, ns, [&](int c, float (&acc)[16]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * c + 8 * j + 2 * t;
      if (r_lo < N)
        st_shared32(sm, lay.h + (r_lo * kH + col) * 2, pack_bf16(acc[4 * j], acc[4 * j + 1]));
      if (r_hi < N)
        st_shared32(sm, lay.h + (r_hi * kH + col) * 2,
                    pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
    }
  });
  consumers_sync();  // dagg whole; the dl2b sums have read the buffer
  for (int idx = tid; idx < N * kH / 4; idx += wg::kConsumers)
    reinterpret_cast<float4*>(agg)[idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // now dxh
  consumers_sync();
  WG_T_END(wg::kProfNodeProducts, t_node);

  // ----- pass 2: da2, dxh, da1, dea -----
  float2 sum_da1 = make_float2(0.0f, 0.0f), sum_da2 = make_float2(0.0f, 0.0f);
  uint32_t wfp = 0;
  prefetch_rows(w);
  for (int tp = 0; tp < npairs; ++tp) {
    const int ti = 2 * tp + w, r0 = ti * 64;
    const bool active = ti < ntiles;
    const size_t o_lo = row_base(r0, active);
    // tile B is free (every warp's products of the last pair have ended, and
    // its generic stores are fenced): the tile's w rows into it
    wg::fence_async_shared();
    wg::bar_sync(bar_wg, 128);
    if (active && elected) {
      wg::mbar_expect_tx(wfull + 8 * w, wg::kTileBytes);
      wg::bulk_load(tile_b, p.w + (prow + r0) * kH, wg::kTileBytes, wfull + 8 * w);
    }
    prefetch_rows(ti + 2);
    // da2 = rnd(rnd(xh[i] dagg[j]) c) into tile A and to global: a thread
    // two columns of the 64 rows; their column sums
    if (active) {
      WG_T_BEGIN(t_da2);
      bf16* da2_g = p.da2 + (prow + r0) * kH + 2 * ct;
      int i = r0 / N, j = r0 - i * N;
      for (int r = 0; r < 64; ++r) {
        const float cr = __bfloat162float(c_g[r0 + r]);
        const float2 x = mul_bf16x2(ld_shared32(sm, lay.xh + i * (2 * kH) + 4 * ct),
                                    ld_shared32(sm, lay.h + j * (2 * kH) + 4 * ct));
        const uint32_t d = pack_bf16(x.x * cr, x.y * cr);
        st_shared32(sm, ta_off + img_off<2>(r, 2 * ct), d);
        st_global32(da2_g + r * kH, d);
        add2(sum_da2, unpack_bf16(d));
        if (++j == N) {
          j = 0;
          ++i;
        }
      }
      WG_T_END(wg::kProfFirstLayer, t_da2);
    }
    wg::fence_async_shared();
    consumers_sync();  // da2 tiles written
    for (int v = 0; v < 2; ++v)  // both tiles' w rows have arrived
      if (2 * tp + v < ntiles) WG_T(wg::kProfTileWait, wg::mbar_wait(wfull + 8 * v, wfp));
    wfp ^= 1;
    WG_T(wg::kProfAggregate, dxh_pair(sm, lay, agg, tp, w, ct, N, P));
    consumers_sync();  // the w rows are read: tile B takes da1
    // ds1 = da2 f2w^T -> da1 = rnd(rnd(ds1) * sg1) into tile B and to global
    const bf16* sg_lo = p.sg1 + o_lo;
    bf16* da1_lo = p.da1 + o_lo;
    wg::product_bf16<kStagesPerMat, false, false>(
        ring, active, tile_a, 0, wg::kAtomBytes, hold,
        [&](int c, float (&acc)[16], uint32_t (&)[8]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * c + 8 * j;
            const float2 sl = ld_cg2(sg_lo + col), sh = ld_cg2(sg_lo + 8 * kH + col);
            const uint32_t lo = pack_bf16(rb(acc[4 * j]) * sl.x, rb(acc[4 * j + 1]) * sl.y);
            const uint32_t hi = pack_bf16(rb(acc[4 * j + 2]) * sh.x, rb(acc[4 * j + 3]) * sh.y);
            st_shared32(sm, tb_off + img_off<2>(r_lo, col + 2 * t), lo);
            st_shared32(sm, tb_off + img_off<2>(r_hi, col + 2 * t), hi);
            st_global32(da1_lo + col, lo);
            st_global32(da1_lo + 8 * kH + col, hi);
          }
        });
    if (active) {
      publish();  // da1 visible to wgmma
      WG_T_BEGIN(t_da1);
      for (int r = 0; r < 64; ++r)
        add2(sum_da1, unpack_bf16(ld_shared32(sm, tb_off + img_off<2>(r, 2 * ct))));
      WG_T_END(wg::kProfFirstLayer, t_da1);
    }
    // dea += da1 f1w^T, the graph's own f32 rows
    float* dea_lo = p.dea + o_lo;
    wg::product_bf16<kStagesPerMat, false, false>(
        ring, active, tile_b, 0, wg::kAtomBytes, hold,
        [&](int c, float (&acc)[16], uint32_t (&)[8]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float2* qlo = reinterpret_cast<float2*>(dea_lo + 32 * c + 8 * j);
            float2* qhi = reinterpret_cast<float2*>(dea_lo + 8 * kH + 32 * c + 8 * j);
            const float2 vlo = __ldcg(qlo), vhi = __ldcg(qhi);
            *qlo = make_float2(vlo.x + acc[4 * j], vlo.y + acc[4 * j + 1]);
            *qhi = make_float2(vhi.x + acc[4 * j + 2], vhi.y + acc[4 * j + 3]);
          }
        });
  }
  consumers_sync();  // dxh is whole, every product of pass 2 has ended

  // df1b, df2b: warpgroup 1's column sums, then warpgroup 0's added to them
  float2* b1 = reinterpret_cast<float2*>(p.bias + ((size_t)0 * B + b) * kH + 2 * ct);
  float2* b2 = reinterpret_cast<float2*>(p.bias + ((size_t)1 * B + b) * kH + 2 * ct);
  if (w == 1) {
    *b1 = sum_da1;
    *b2 = sum_da2;
  }
  // rnd(dxh) to global and as a node image in h's slot (dagg has been read)
  for (int idx = tid; idx < N * (kH / 2); idx += wg::kConsumers) {
    const int row = idx >> 7, col = 2 * (idx & 127);
    const float2 v = *reinterpret_cast<const float2*>(agg + row * kH + col);
    const uint32_t pk = pack_bf16(v.x, v.y);
    st_shared32(sm, lay.h + img_off<2>(row, col, ns), pk);
    st_global32(p.dxh + (nrow + row) * kH + col, pk);
  }
  wg::fence_async_shared();
  consumers_sync();
  if (w == 0) {
    const float2 o1 = *b1, o2 = *b2;
    *b1 = make_float2(sum_da1.x + o1.x, sum_da1.y + o1.y);
    *b2 = make_float2(sum_da2.x + o2.x, sum_da2.y + o2.y);
  }
  // g += rnd(dxh) l1w^T: the lin1 path into h_l (the residual path is g itself)
  auto add_dh = [&](int c, float (&acc)[16]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * c + 8 * j + 2 * t;
      if (r_lo < N) {
        float2* q = reinterpret_cast<float2*>(g_g + r_lo * kH + col);
        const float2 v = *q;
        *q = make_float2(v.x + acc[4 * j], v.y + acc[4 * j + 1]);
      }
      if (r_hi < N) {
        float2* q = reinterpret_cast<float2*>(g_g + r_hi * kH + col);
        const float2 v = *q;
        *q = make_float2(v.x + acc[4 * j + 2], v.y + acc[4 * j + 3]);
      }
    }
  };
  WG_T(wg::kProfNodeProducts, wgb::node_product(ring, w, base + lay.h, ns, add_dh));
  WG_T_END(wg::kProfTotal, t_consumer);
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
// Weight gradients on Hopper: schnet_bwd_xty_wg_kernel (bf16, H = 256).
//
// Replaces, for these shapes, schnet_bwd_xty_kernel and
// schnet_bwd_reduce_kernel: _bwd_kernel's dot(X.T, Y) lines (dow, dl2w, dl1w,
// df2w, df1w += ..., schnet_stack_vjp.py:72).  The five products of block l
// (df1w = ea^T da1 and df2w = s1^T da2 over the B*N*N pair rows; dl1w = hl^T
// dxh, dl2w = agg^T da3 and dow = s3^T gd over the B*N node rows) are ten
// outputs of 128 x 256: output 2k + mt is rows 128 mt .. 128 mt + 127 of job
// k's gradient.  Each output's reduction is cut into stages of 64 rows, and
// the stage-units of all ten, in the order (job, M-tile, stage), are dealt in
// equal ranges to one persistent CTA per SM (ops/schnet_stack.py::
// xty_schedule, made on the host and read here as a table): no wave is left
// part full and no small job trails behind a large one.  A CTA's range is
// one or more segments, each a run of one output's stages; a segment's sum
// goes to its own f32 partial (128 x 256), and
// schnet_bwd_xty_wg_reduce_kernel adds each output's partials in segment
// order: deterministic, bitwise repeatable, no atomics.
//
// Per stage the producer warp copies by 2-D tensor copies (wg::tma_load_2d;
// the ten tensor maps are made on the host once per backward call, the
// scratch being the same for every block) the M-tile's 128 columns of X as
// two boxes, one per consumer warpgroup, and Y's 256 columns as four, 64 rows
// each, 48 KB into a ring of 4 stages.  Each consumer warpgroup keeps its 64 x
// 256 f32 output in registers (128 a thread) and runs four wgmma m64n256k16
// a stage with both operands MN-major (imm-trans-a = imm-trans-b = 1), the
// next stage's product issued while the last one's finishes.  Both M-tiles of
// an output read all of Y; the CTAs on them start at about the same row and
// move at the same pace, so the second read finds Y in L2.
//
// Bound: per block X and Y are read once, 4 B N^2 H + 6 B N H bf16 values, and
// the products are 2 B (2 N^2 + 3 N) H^2 flop (schnet_stack_cost, "bwd_xty"):
// at B = 200, N = 24 per call of 7 blocks 1.764e9 bytes, 0.53 ms at 3.35 TB/s,
// against 2.246e11 flop, 0.23 ms: bound by bytes.  The partials add 128 KB
// written and read per segment, about 141 segments a block on 132 SMs.

constexpr int kXtyWgTileM = 128;
constexpr int kXtyWgOutputs = 2 * kJobs;
constexpr int kXtyWgRing = 4;
constexpr uint32_t kXtyWgXBytes = 2 * wg::kMnBoxBytes;      // X: one box per warpgroup
constexpr uint32_t kXtyWgStageBytes = 6 * wg::kMnBoxBytes;  // and Y's four boxes
constexpr size_t kXtyWgSmem = kXtyWgRing * kXtyWgStageBytes + 16 * kXtyWgRing + 1024;

// the tensor maps of the five X and the five Y (row-major (rows, 256) bf16,
// 64 x 64 boxes, 128-byte swizzle)
struct XtyMaps {
  CUtensorMap x[kJobs];
  CUtensorMap y[kJobs];
};
struct XtyOuts {
  float* out[kJobs];  // (256, 256) f32 each
};

// The schedule's int32 table (ops/schnet_stack.py::xty_schedule_table): the
// first segment of each CTA, cta_begin[ctas + 1]; of each output,
// out_begin[kXtyWgOutputs + 1]; then per segment (job, M-tile, first stage,
// end stage).
__device__ __forceinline__ const int* xty_segments(const int* sched, int ctas) {
  return sched + ctas + 1 + kXtyWgOutputs + 1;
}

__global__ void __launch_bounds__(wg::kThreads, 1)
schnet_bwd_xty_wg_kernel(const __grid_constant__ XtyMaps maps, const int* __restrict__ sched,
                         int ctas, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + kXtyWgRing * kXtyWgStageBytes, empty = full + 8 * kXtyWgRing;
  const int tid = threadIdx.x;
  // warp-uniform by construction, and known to the compiler as such
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int* segs = xty_segments(sched, ctas);
  const int seg0 = sched[blockIdx.x], seg1 = sched[blockIdx.x + 1];
  if (tid == 0) {
    for (int i = 0; i < kXtyWgRing; ++i) {
      wg::mbar_init(full + 8 * i, 1);
      wg::mbar_init(empty + 8 * i, wg::kConsumers / 32);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp_idx >= wg::kConsumers / 32) {
    // ===== producer: the CTA's segments, stage after stage =====
    wg::reg_dealloc<wg::kRegsProducer>();
    if (tid == wg::kConsumers) {
      uint32_t idx = 0, phase = 0;
      for (int sg = seg0; sg < seg1; ++sg) {
        const int job = segs[4 * sg], x_col = kXtyWgTileM * segs[4 * sg + 1];
        const void* xm = &maps.x[job];
        const void* ym = &maps.y[job];
        for (int s = segs[4 * sg + 2]; s < segs[4 * sg + 3]; ++s) {
          wg::mbar_wait(empty + 8 * idx, phase ^ 1);
          const uint32_t st = ring + idx * kXtyWgStageBytes, bar = full + 8 * idx;
          const int row = s * (int)wg::kMnBoxRows;
          wg::mbar_expect_tx(bar, kXtyWgStageBytes);
          wg::tma_load_2d(st, xm, x_col, row, bar);
          wg::tma_load_2d(st + wg::kMnBoxBytes, xm, x_col + 64, row, bar);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wg::tma_load_2d(st + kXtyWgXBytes + q * wg::kMnBoxBytes, ym, 64 * q, row, bar);
          if (++idx == kXtyWgRing) { idx = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // ===== consumers: warpgroup w, rows 64 w .. 64 w + 63 of each segment's output =====
  wg::reg_alloc<wg::kRegsConsumer>();
  const int w = warp_idx >> 2, lane = tid & 31;
  const int r_lo = ((warp_idx & 3) << 4) + (lane >> 2), c0 = 2 * (lane & 3);
  uint32_t idx = 0, phase = 0, ridx = 0;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  // wgmma on the next filled stage; `first` starts the sum
  auto stage = [&](bool first) {
    wg::mbar_wait(full + 8 * idx, phase);
    const uint32_t st = ring + idx * kXtyWgStageBytes;
    if (++idx == kXtyWgRing) { idx = 0; phase ^= 1; }
    const uint64_t da = wg::make_desc_mn(st + w * wg::kMnBoxBytes);
    const uint64_t db = wg::make_desc_mn(st + kXtyWgXBytes);
    wg::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)  // a k16 step is 16 rows further on in both operands
      wg::mma_tt_bf16_n256(acc, da + ((k * wg::kMnK16Bytes) >> 4),
                           db + ((k * wg::kMnK16Bytes) >> 4), (first && k == 0) ? 0 : 1);
    wg::wgmma_commit();
  };
  // after its warp's wgmma on the oldest unreleased stage have ended
  auto release = [&]() {
    if (lane == 0) wg::mbar_arrive(empty + 8 * ridx);
    if (++ridx == kXtyWgRing) ridx = 0;
  };
  for (int sg = seg0; sg < seg1; ++sg) {
    const int n = __shfl_sync(0xffffffffu, segs[4 * sg + 3] - segs[4 * sg + 2], 0);
    stage(true);
    for (int i = 1; i < n; ++i) {
      stage(false);
      wg::wgmma_wait<1>();
      release();
    }
    wg::wgmma_wait<0>();
    wg::fence_acc128(acc);
    release();
    // the partial's rows r_lo and r_lo + 8 of this warpgroup's half, at
    // constant offsets from one row base
    float* dst = part + ((size_t)sg * kXtyWgTileM + 64 * w + r_lo) * kH + c0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(dst + 8 * kH + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// out[k][row] = the sum of output (k, row / 128)'s partials, in segment order
__global__ void schnet_bwd_xty_wg_reduce_kernel(XtyOuts o, const float* __restrict__ part,
                                                const int* __restrict__ sched, int ctas) {
  const int k = blockIdx.y, i4 = blockIdx.x * blockDim.x + threadIdx.x;
  if (i4 >= kHH / 4) return;
  const int row = i4 / (kH / 4), col = 4 * (i4 % (kH / 4));
  const int* out_begin = sched + ctas + 1 + 2 * k + row / kXtyWgTileM;
  const float* src = part + (size_t)(row % kXtyWgTileM) * kH + col;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int sg = out_begin[0]; sg < out_begin[1]; ++sg) {
    const float4 v = *reinterpret_cast<const float4*>(src + (size_t)sg * kXtyWgTileM * kH);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(o.out[k] + (size_t)row * kH + col) = s;
}

// bf16 at H = 256 takes the wgmma weight-gradient kernel: the tensor maps
// address any row count an int holds.  Everything else takes
// schnet_bwd_xty_kernel; neither gives way to the other.
bool xty_wg_takes(int pair_rows, int node_rows, int H, int is_bf16) {
  return is_bf16 && H == kH && pair_rows > 0 && node_rows > 0;
}

// cuTensorMapEncodeTiled from the driver, found at run time: the library
// links no driver library
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || ptr == nullptr) return cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = found;
  return cudaSuccess;
}

// the map of a row-major (rows, 256) bf16 matrix in boxes of 64 columns x 64
// rows with the 128-byte swizzle; rows past the end read as zeros
cudaError_t rows_map(CUtensorMap* map, const bf16* ptr, int rows) {
  EncodeTiled fn;
  const cudaError_t e = encode_tiled(&fn);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)kH, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kH * sizeof(bf16)};
  const cuuint32_t box[2] = {64, wg::kMnBoxRows}, elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t xty_maps(XtyMaps* maps, const bf16* const xs[kJobs], const bf16* const ys[kJobs],
                     int pair_rows, int node_rows) {
  for (int k = 0; k < kJobs; ++k) {
    const int rows = k < 2 ? pair_rows : node_rows;
    cudaError_t e = rows_map(&maps->x[k], xs[k], rows);
    if (e == cudaSuccess) e = rows_map(&maps->y[k], ys[k], rows);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// One block's five gradients by the wgmma kernel and its reduction.
cudaError_t launch_xty_wg(const XtyMaps& maps, const int* sched, int ctas, float* part,
                          float* const outs[kJobs], cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(schnet_bwd_xty_wg_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kXtyWgSmem);
  if (e != cudaSuccess) return e;
  schnet_bwd_xty_wg_kernel<<<ctas, wg::kThreads, kXtyWgSmem, st>>>(maps, sched, ctas, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  XtyOuts o;
  for (int k = 0; k < kJobs; ++k) o.out[k] = outs[k];
  schnet_bwd_xty_wg_reduce_kernel<<<dim3(kHH / 4 / 256, kJobs), 256, 0, st>>>(o, part, sched, ctas);
  return cudaGetLastError();
}

// One block's five gradients by schnet_bwd_xty_kernel and
// schnet_bwd_reduce_kernel (split-K over fixed row counts).
template <typename T>
cudaError_t launch_xty_split(const T* const xs[kJobs], const T* const ys[kJobs],
                             float* const outs[kJobs], float* part, int pair_rows, int node_rows,
                             int H, int pair_rows_per_split, int node_rows_per_split,
                             cudaStream_t st) {
  const size_t HH = (size_t)H * H;
  const int pair_splits = (pair_rows + pair_rows_per_split - 1) / pair_rows_per_split;
  const int node_splits = (node_rows + node_rows_per_split - 1) / node_rows_per_split;
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
    jb.out = outs[k];
    off += (size_t)jb.splits * HH;
  }
  const int tiles = (H / kXtyTile) * (H / kXtyTile);
  const int max_splits = pair_splits > node_splits ? pair_splits : node_splits;
  schnet_bwd_xty_kernel<T><<<dim3(tiles, max_splits, kJobs), kXtyThreads, 0, st>>>(jobs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  schnet_bwd_reduce_kernel<T><<<dim3((int)((HH + 255) / 256), kJobs), 256, 0, st>>>(jobs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launches

template <typename T, int TR, bool kStoreHs>
int launch_fwd(const void* const* ptrs, int B, int N, int H, int L, void* stream) {
  FwdParams<T> p;
  int i = 0;
  p.ea = static_cast<const T*>(ptrs[i++]);
  p.c = static_cast<const T*>(ptrs[i++]);
  p.h = static_cast<const T*>(ptrs[i++]);
  const T** w[] = {&p.f1w, &p.f1b, &p.f2w, &p.f2b, &p.l1w, &p.l2w, &p.l2b, &p.ow, &p.ob};
  for (const T** slot : w) *slot = static_cast<const T*>(ptrs[i++]);
  p.out = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  p.hs = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  // the wgmma kernel's arranged weights and ea tile images
  const bf16* wimg = static_cast<const bf16*>(ptrs[i++]);
  const bf16* ea_img = static_cast<const bf16*>(ptrs[i++]);
  if (i != kFwdPtrs) return (int)cudaErrorInvalidValue;
  p.B = B; p.N = N; p.H = H; p.L = L;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  // bf16 at H = 256, N <= 24 takes the wgmma kernel, everything else the
  // mma.sync one; neither gives way to the other
  if constexpr (std::is_same<T, bf16>::value) {
    if (fwd_wg_takes(N, H, 1)) {
      const GraphSmem lay = wgb::dense_layout(N, false);
      if (wimg == nullptr || ea_img == nullptr || lay.total > wgb::kMaxSmem)
        return (int)cudaErrorInvalidValue;
      e = cudaFuncSetAttribute(schnet_fwd_wg_kernel<kStoreHs>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
      if (e != cudaSuccess) return (int)e;
      schnet_fwd_wg_kernel<kStoreHs><<<B, wg::kThreads, lay.total, st>>>(p, wimg, ea_img);
      return (int)cudaGetLastError();
    }
  }
  const Smem lay = smem_layout<T, TR>(N, H, 2);
  if (lay.np > TR || lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(schnet_fwd_kernel<T, TR, kStoreHs>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  schnet_fwd_kernel<T, TR, kStoreHs><<<B, kThreads, lay.total, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int TR>
int launch_bwd(const void* const* ptrs, int B, int N, int H, int L, int pair_rows_per_split,
               int node_rows_per_split, int xty_ctas, void* stream) {
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
  // the wgmma row kernel's arranged weights and ea tile images
  const bf16* wimg = static_cast<const bf16*>(ptrs[39]);
  const bf16* ea_img = static_cast<const bf16*>(ptrs[40]);
  // the wgmma weight-gradient kernel's schedule table
  const int* sched = static_cast<const int*>(ptrs[41]);

  // bf16 at H = 256, N <= 24 takes the wgmma row kernel, everything else the
  // mma.sync one; neither gives way to the other
  const bool use_wg = bwd_wg_takes(N, H, std::is_same<T, bf16>::value);
  const GraphSmem wlay = wgb::dense_layout(N, false);
  cudaError_t e;
  if (use_wg) {
    if (wimg == nullptr || ea_img == nullptr || wlay.total > wgb::kMaxSmem)
      return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(schnet_bwd_rows_wg_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wlay.total);
  } else {
    e = cudaFuncSetAttribute(schnet_bwd_rows_kernel<T, TR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  }
  if (e != cudaSuccess) return (int)e;

  const size_t HH = (size_t)H * H;
  const int pair_rows = B * N * N, node_rows = B * N;
  const T* xs[kJobs] = {p.ea, p.s1, p.hl, p.agg, p.s3};
  const T* ys[kJobs] = {p.da1, p.da2, p.dxh, p.da3, p.gd};
  // bf16 at H = 256 takes the wgmma weight-gradient kernel, everything else
  // schnet_bwd_xty_kernel; neither gives way to the other.  The scratch is
  // the same for every block: its tensor maps are made once.
  const bool use_xty_wg = xty_wg_takes(pair_rows, node_rows, H, std::is_same<T, bf16>::value);
  XtyMaps maps;
  if (use_xty_wg) {
    if (sched == nullptr || xty_ctas <= 0) return (int)cudaErrorInvalidValue;
    e = xty_maps(&maps, reinterpret_cast<const bf16* const*>(xs),
                 reinterpret_cast<const bf16* const*>(ys), pair_rows, node_rows);
    if (e != cudaSuccess) return (int)e;
  }

  for (int l = L - 1; l >= 0; --l) {
    p.l = l;
    if constexpr (std::is_same<T, bf16>::value) {
      if (use_wg)
        schnet_bwd_rows_wg_kernel<<<B, wg::kThreads, wlay.total, st>>>(p, wimg, ea_img);
      else
        schnet_bwd_rows_kernel<T, TR><<<B, kThreads, lay.total, st>>>(p);
    } else {
      schnet_bwd_rows_kernel<T, TR><<<B, kThreads, lay.total, st>>>(p);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    schnet_bwd_sum_kernel<<<4, kThreads, 0, st>>>(p.bias, bias_out, B, H, l);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    float* const outs[kJobs] = {df1w + l * HH, df2w + l * HH, dl1w + l * HH, dl2w + l * HH,
                                dow + l * HH};
    e = use_xty_wg ? launch_xty_wg(maps, sched, xty_ctas, part, outs, st)
                   : launch_xty_split<T>(xs, ys, outs, part, pair_rows, node_rows, H,
                                         pair_rows_per_split, node_rows_per_split, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// One block's five weight gradients alone (schnet_stack_xty_launch).
template <typename T>
int launch_xty(const void* const* ptrs, int pair_rows, int node_rows, int H,
               int pair_rows_per_split, int node_rows_per_split, int xty_ctas, void* stream) {
  if (pair_rows <= 0 || node_rows <= 0 || H <= 0 || H % kXtyTile != 0 || H > kH ||
      pair_rows_per_split <= 0 || node_rows_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xs[kJobs];
  const T* ys[kJobs];
  float* outs[kJobs];
  float* out = static_cast<float*>(const_cast<void*>(ptrs[2 * kJobs]));
  for (int k = 0; k < kJobs; ++k) {
    xs[k] = static_cast<const T*>(ptrs[k]);
    ys[k] = static_cast<const T*>(ptrs[kJobs + k]);
    outs[k] = out + (size_t)k * H * H;
  }
  float* part = static_cast<float*>(const_cast<void*>(ptrs[2 * kJobs + 1]));
  const int* sched = static_cast<const int*>(ptrs[2 * kJobs + 2]);
  if (xty_wg_takes(pair_rows, node_rows, H, std::is_same<T, bf16>::value)) {
    if (sched == nullptr || xty_ctas <= 0) return (int)cudaErrorInvalidValue;
    XtyMaps maps;
    cudaError_t e = xty_maps(&maps, reinterpret_cast<const bf16* const*>(xs),
                             reinterpret_cast<const bf16* const*>(ys), pair_rows, node_rows);
    if (e == cudaSuccess) e = launch_xty_wg(maps, sched, xty_ctas, part, outs, st);
    return (int)e;
  }
  return (int)launch_xty_split<T>(xs, ys, outs, part, pair_rows, node_rows, H,
                                  pair_rows_per_split, node_rows_per_split, st);
}

bool bad_shape(int B, int N, int H, int L) {
  return B <= 0 || N <= 0 || N % 8 != 0 || H <= 0 || H % 64 != 0 || H > kThreads || L < 0;
}

}  // namespace

WG_PROFILE_ENTRY(schnet_stack_profile)

extern "C" {

// Forward of the stack on `stream`; returns the cudaError_t of the launch.
// ptrs: ea, c, h, then f1w f1b f2w f2b l1w l2w l2b ow ob (matrices (L, out,
// in), read by the mma.sync kernel only), out, hs (ignored unless store_hs);
// then, where schnet_stack_fwd_uses_wg says 1 (null otherwise), the arranged
// bf16 weight image (L * 10 * H * H, ops/schnet_stack.py::arrange_stack_weights)
// and ea as 64-row tile images (B, N*N*H).
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
// bias partials; the f32 weight-gradient partials; then, where
// schnet_stack_bwd_uses_wg says 1 (null otherwise), the arranged bf16 weight
// image (L * 10 * H * H, ops/schnet_stack.py::arrange_stack_weights) and ea
// as 64-row tile images (B, N*N*H); then, where schnet_stack_bwd_xty_uses_wg
// says 1 (null otherwise), the int32 schedule table of xty_ctas CTAs
// (ops/schnet_stack.py::xty_schedule_table).  The partials are, for the
// wgmma weight-gradient kernel, (the table's segments, 128, H), otherwise
// (2 * ceil(B*N*N / pair_rows_per_split) + 3 * ceil(B*N / node_rows_per_split),
// H, H).
int schnet_stack_bwd_launch(const void* const* ptrs, int B, int N, int H, int L, int is_bf16,
                            int pair_rows_per_split, int node_rows_per_split, int xty_ctas,
                            void* stream) {
  if (bad_shape(B, N, H, L)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_bwd<__nv_bfloat16, 64>(ptrs, B, N, H, L, pair_rows_per_split,
                                         node_rows_per_split, xty_ctas, stream);
  return launch_bwd<float, 32>(ptrs, B, N, H, L, pair_rows_per_split, node_rows_per_split,
                               xty_ctas, stream);
}

// The five weight-gradient products of one block of the backward alone, on
// `stream`: out[k] (f32, H x H) = x_k^T y_k summed over all rows.  ptrs: x0..x4,
// y0..y4 (row major (rows, H); jobs 0 and 1 pair_rows rows, 2-4 node_rows),
// out (5, H, H), the f32 partials and the schedule table as for
// schnet_stack_bwd_launch (the table null where schnet_stack_bwd_xty_uses_wg
// says 0).
int schnet_stack_xty_launch(const void* const* ptrs, int pair_rows, int node_rows, int H,
                            int is_bf16, int pair_rows_per_split, int node_rows_per_split,
                            int xty_ctas, void* stream) {
  if (is_bf16)
    return launch_xty<__nv_bfloat16>(ptrs, pair_rows, node_rows, H, pair_rows_per_split,
                                     node_rows_per_split, xty_ctas, stream);
  return launch_xty<float>(ptrs, pair_rows, node_rows, H, pair_rows_per_split,
                           node_rows_per_split, xty_ctas, stream);
}

// 1 where schnet_stack_fwd_launch takes the wgmma kernel (bf16, H = 256,
// N % 8 == 0, N <= 24), 0 where it takes the mma.sync one.
int schnet_stack_fwd_uses_wg(int N, int H, int is_bf16) {
  return fwd_wg_takes(N, H, is_bf16) ? 1 : 0;
}

// 1 where schnet_stack_bwd_launch takes the wgmma row kernel (the same
// shapes), 0 where it takes the mma.sync one.
int schnet_stack_bwd_uses_wg(int N, int H, int is_bf16) {
  return bwd_wg_takes(N, H, is_bf16) ? 1 : 0;
}

// 1 where the backward's weight gradients take the wgmma kernel (bf16, H =
// 256), 0 where they take schnet_bwd_xty_kernel.
int schnet_stack_bwd_xty_uses_wg(int pair_rows, int node_rows, int H, int is_bf16) {
  return xty_wg_takes(pair_rows, node_rows, H, is_bf16) ? 1 : 0;
}

const char* schnet_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
