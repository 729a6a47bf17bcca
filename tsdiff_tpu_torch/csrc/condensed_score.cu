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
// Bound at the dense path's shapes (B=100, N=24, H=256, L=7, bf16): counted
// from the kernel body, 2*B*(7*P*H^2 + L*(2*P*H^2 + 3*N*H^2) + 2.5*P*H^2) =
// 1.84e11 flop, 0.19 ms at 989 TFLOP/s, against ~125 MB of inputs (the four
// embedding tensors are 29.5 MB each), 0.04 ms at 3.35 TB/s: bound by the
// tensor cores.
//
// Two kernels.  One CTA owns one graph in both: h, xh and the f32
// aggregation (N x H each) stay in shared memory, ea goes once to a global
// scratch and comes back in every block, de is recomputed for the output
// stage, the four embedding tensors are each read once, tile by tile,
// straight into the de*emb product.
//
// condensed_score_kernel (float32, and bf16 at shapes the other does not
// take): the first port.  256 threads, tiles of TR rows (64 in bf16, 32 in
// f32), the aggregation by column-owning threads in a fixed order, weights
// from L2 once per row tile, bf16 products on mma.sync.m16n8k16 (the f32 path
// uses FMA loops and exists to check the kernel against the plain version).
// The interaction block is the one of the SchNet stack kernels
// (graph_block.cuh).  At the dense path's shapes it reads 3.17 GB of weights
// from L2 per launch and runs at 3.6 ms (H100, 700 W).
//
// condensed_score_wg_kernel (bf16, H = 256, N <= 24; csrc/wg_pipeline.cuh,
// the pipeline of the packed score kernels):
//   * the grid.  One CTA per graph: at B = 100 that is 100 of 132 SMs in one
//     wave, 5 tile pairs per CTA at N = 24 (P = 576 rows, 9 full tiles).
//     Splitting a graph over a two-CTA cluster (the per-node partial agg and
//     h exchanged through distributed shared memory) gives 200 CTAs, 1.52
//     waves, 3 and 2 tile pairs per CTA: two waves of 3 tile pairs plus the
//     exchange, against one wave of 5.  The one-CTA grid is the shorter.
//   * a producer warp walks the static schedule of weight stages
//     (ops/condensed_score.py::dense_schedule; the packed kernel's walk over
//     more tile pairs) and fills the 3-stage ring of 16 KB stages from the
//     arranged weight image (ops/packed_score.py::arrange_weights), and it
//     fetches each ea tile image into tile A as soon as the last pair's
//     aggregation has read it.
//   * two consumer warpgroups hold one 64-row tile each and read the same
//     stage; wgmma m64n32k16 with two accumulator sets, so a stage's epilogue
//     runs under the next stage's products; ex2/lg2/rcp activations.
//   * the embedding stream.  de*er and de*ep are made in the epilogue of the
//     dw1 product from 4-byte loads in the fragment's own layout; one
//     thread of the warpgroup has put its tile's embedding rows into L2 a
//     tile pair ahead with bulk prefetches (cp.async.bulk.prefetch.L2, 32 KB
//     a tile), so the loads wait on L2, not on device memory.  No shared
//     memory: at N = 24 the ring has exactly its 3 stages left beside h, xh,
//     the f32 agg (24 KB), the dense row table and the four tiles.
//   * results kept while their product still reads the tile they go to
//     (de*ep, the c0 and g0 outputs): the packed kernel keeps them in 64
//     registers a thread, which ptxas put in local memory (its spills).  Here
//     the epilogue writes them as a tile image into a per-warpgroup global
//     scratch (L2), and once the product has ended one bulk copy brings the
//     tile into shared memory.  No spill, and one asynchronous copy instead
//     of 64 loads a thread.  The filter w goes straight into tile A, which
//     f1w has finished reading: the next ea tile is fetched into tile A after
//     the aggregation, under the next pair's or the node update's work.
//   * the dense aggregation agg[j] = sum_i rnd(w[i*N+j] * xh[i]): a tile pair
//     covers rows 128*tp .. +127, so each receiving node j takes the sources
//     i whose row lies in the pair, in ascending order; pairs come in order,
//     so every node sums its N sources in ascending i.  A warpgroup takes
//     half the nodes, a thread two columns of four nodes at a time in
//     registers; no atomics, bitwise repeatable.
//   * the head's node products h_i * h_j from a table of (i, j) per dense row
//     built once per CTA: no division per row.
//
// The bound is the tensor cores' (above); what the
// packed kernels on the same pipeline showed is that the CUDA cores' work
// beside the products (epilogues, aggregation) holds them at 8-9x that bound.

#include "graph_block.cuh"
#include "wg_pipeline.cuh"

namespace {

using tile::from_f;
using tile::gemm;
using tile::kThreads;
using tile::rnd;
using tile::silu_f;
using tile::to_f;

constexpr int kNumPtrs = 35;
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


// ---------------------------------------------------------------------------
// The warp-specialised kernel (bf16, H = 256).

using wgb::act_silu;
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

// Offsets of the matrices in the arranged weight image, in units of kHH
// elements (ops/packed_score.py::IMAGE_ORDER, which arrange_weights writes).
struct DenseImage {
  int L;
  __device__ int dw1() const { return 0; }
  __device__ int c0r() const { return 1; }
  __device__ int c0p() const { return 2; }
  __device__ int c1w() const { return 3; }
  __device__ int f1w(int l) const { return 4 + l; }
  __device__ int f2w(int l) const { return 4 + L + l; }
  __device__ int l1w(int l) const { return 4 + 2 * L + l; }
  __device__ int l2w(int l) const { return 4 + 3 * L + l; }
  __device__ int ow(int l) const { return 4 + 4 * L + l; }
  __device__ int g0h() const { return 4 + 5 * L; }
  __device__ int g0e() const { return 5 + 5 * L; }
  __device__ int g1w() const { return 6 + 5 * L; }  // half a unit
};

// v[k] for a k known only at run time, without an indexed (local) array
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int k) {
  const uint32_t a = (k & 1) ? v[1] : v[0], b = (k & 1) ? v[3] : v[2];
  return (k & 2) ? b : a;
}

// Barriers, the dense row table (row p -> i = p / N, j = p % N) and the node
// states as a tile image; every thread of the CTA, then a __syncthreads.
__device__ __forceinline__ void dense_setup(unsigned char* sm, uint32_t base, const GraphSmem& lay,
                                            const bf16* z, int N) {
  const int tid = threadIdx.x, P = N * N;
  const uint32_t full = base + lay.bars, empty = full + 8 * wg::kMaxStages;
  const uint32_t afull = empty + 8 * wg::kMaxStages, aempty = afull + 16, kfull = aempty + 16;
  if (tid == 0) {
    wg::ring_init(full, empty, lay.stages);
    for (int w = 0; w < 2; ++w) {
      wg::mbar_init(afull + 8 * w, 1);
      wg::mbar_init(aempty + 8 * w, 1);
      wg::mbar_init(kfull + 8 * w, 1);
    }
    wg::mbar_init_fence();
  }
  unsigned char* tab = sm + lay.tab;
  for (int r = tid; r < P; r += wg::kThreads) {
    const int i = r / N;
    tab[2 * r] = (unsigned char)i;
    tab[2 * r + 1] = (unsigned char)(r - i * N);
  }
  for (int idx = tid; idx < N * 32; idx += wg::kThreads) {
    const int row = idx >> 5, unit = idx & 31;
    *reinterpret_cast<uint4*>(sm + lay.h + wg::img_off<2>(row, unit * 8, lay.node_stride)) =
        *reinterpret_cast<const uint4*>(z + (size_t)row * kH + unit * 8);
  }
  wg::fence_async_shared();
  __syncthreads();
}

__global__ void __launch_bounds__(wg::kThreads, 1)
condensed_score_wg_kernel(Params<bf16> p, const bf16* __restrict__ wimg) {
  extern __shared__ unsigned char smem_raw[];
  const int N = p.N, L = p.L, P = N * N, ntiles = P / 64, npairs = (ntiles + 1) / 2;
  const GraphSmem lay = wgb::dense_layout(N, true);
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full = base + lay.bars, empty = full + 8 * wg::kMaxStages;
  const uint32_t afull = empty + 8 * wg::kMaxStages, aempty = afull + 16, kfull = aempty + 16;
  const unsigned char* tab = sm + lay.tab;
  float* agg = reinterpret_cast<float*>(sm + lay.agg);

  const int b = blockIdx.x, tid = threadIdx.x;
  // warp-uniform by construction, and known to the compiler as such: wgmma
  // under a branch it takes for divergent is serialized
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const DenseImage wi = {L};
  // per graph: ntiles ea tile images, then one kept tile image per warpgroup
  bf16* ea_g = p.ea + (size_t)b * (ntiles + 2) * kTileElems;

  dense_setup(sm, base, lay, p.z + (size_t)b * N * kH, N);

  if (warp_idx >= wg::kConsumers / 32) {
    // ===== producer: the static schedule of weight stages and ea tiles =====
    wg::reg_dealloc<wg::kRegsProducer>();
    if (tid == wg::kConsumers) {
      wg::Ring ring{full, empty, base + lay.ring, lay.stages};
      auto mat = [&](int unit) { return wimg + (size_t)unit * kHH; };
      auto fill_mat = [&](const bf16* w, int stages = kStagesPerMat) {
        for (int c = 0; c < stages; ++c) ring.fill(w + c * kStageElems);
      };
      auto fill_pairs = [&](const bf16* w0, const bf16* w1) {
        for (int c = 0; c < kStagesPerMat; ++c) {
          ring.fill(w0 + c * kStageElems);
          ring.fill(w1 + c * kStageElems);
        }
      };
      auto edge_cat = [&]() {
        fill_mat(mat(wi.dw1()));
        fill_pairs(mat(wi.c0r()), mat(wi.c0p()));
        fill_mat(mat(wi.c1w()));
      };
      for (int tp = 0; tp < npairs; ++tp) edge_cat();
      uint32_t aphase = 0;  // bit w: the parity warpgroup w's tile A is waited on
      for (int l = 0; l < L; ++l) {
        fill_mat(mat(wi.l1w(l)));
        for (int tp = 0; tp < npairs; ++tp) {
          for (int w = 0; w < 2; ++w) {
            const int ti = 2 * tp + w;
            if (ti >= ntiles) continue;
            wg::mbar_wait(aempty + 8 * w, (aphase >> w) & 1);
            aphase ^= 1u << w;
            wg::mbar_expect_tx(afull + 8 * w, wg::kTileBytes);
            wg::bulk_load(base + lay.tiles + 2 * w * wg::kTileBytes,
                          ea_g + (size_t)ti * kTileElems, wg::kTileBytes, afull + 8 * w);
          }
          fill_mat(mat(wi.f1w(l)));
          fill_mat(mat(wi.f2w(l)));
        }
        fill_mat(mat(wi.l2w(l)));
        fill_mat(mat(wi.ow(l)));
      }
      for (int tp = 0; tp < npairs; ++tp) {
        edge_cat();
        fill_pairs(mat(wi.g0h()), mat(wi.g0e()));
        fill_mat(mat(wi.g1w()), kStagesPerMat / 2);
      }
    }
  } else {
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
    unsigned char* kept_g =
        reinterpret_cast<unsigned char*>(ea_g + (size_t)(ntiles + w) * kTileElems);
    // This thread's words of a stage in the kept tile image.  Word (row, col =
    // 32c + 8j + 2t) sits in 16-byte unit (4(c&1) + j) ^ (row & 7) of its row,
    // which is 4((c&1) ^ (g>>2)) + (j ^ (g&3)) since row & 7 = g: so with
    // slot s = j ^ (g&3) the address is one of two row bases (by the parity
    // of c) plus a constant, and slot s stores group s ^ (g&3)'s word.  No
    // address arithmetic per store: a 64-bit address per store had ptxas
    // spill.
    unsigned char* const kept_even = kept_g + r_lo * 128 + 4 * t + 64 * (g >> 2);
    unsigned char* const kept_odd = kept_g + r_lo * 128 + 4 * t + 64 * ((g >> 2) ^ 1);
    const int g_lo = g & 3;
    uint32_t kphase = 0;
    const float* d_g = p.d + (size_t)b * P;
    const float* c_g = p.c + (size_t)b * P;
    // after generic stores into a tile: visible to wgmma, in every warp
    auto publish = [&]() {
      wg::fence_async_shared();
      wg::bar_sync(bar_wg, 128);
    };
    // an epilogue's packed pairs of stage c (rows r_lo and r_hi of groups
    // j = 0..3) into the kept tile image
    auto keep = [&](int c, const uint32_t (&lo)[4], const uint32_t (&hi)[4]) {
      unsigned char* q = ((c & 1) ? kept_odd : kept_even) + (c >> 1) * wg::kAtomBytes;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = s ^ g_lo;
        *reinterpret_cast<uint32_t*>(q + 16 * s) = pick4(lo, j);
        *reinterpret_cast<uint32_t*>(q + 1024 + 16 * s) = pick4(hi, j);  // row r_lo + 8
      }
    };
    // after a product that kept its results: once every warp's stores are
    // fenced for the asynchronous proxy and its reads of tile A have ended,
    // the kept tile image into tile A by one bulk copy.  Also publishes the
    // epilogue's generic stores into tile B.
    auto fetch_kept = [&]() {
      wg::fence_async_all();
      wg::bar_sync(bar_wg, 128);
      if (elected) {
        wg::mbar_expect_tx(kfull + 8 * w, wg::kTileBytes);
        wg::bulk_load(tile_a, kept_g, wg::kTileBytes, kfull + 8 * w);
      }
      WG_T(wg::kProfStoreKept, wg::mbar_wait(kfull + 8 * w, kphase));
      kphase ^= 1;
    };
    uint32_t hold[64];  // product_bf16's kept registers: unused here (kKeep false)
    // this warpgroup's tile ti of two embedding tensors into L2 (one thread),
    // a tile pair ahead of the dw1 epilogue that reads it
    auto prefetch = [&](int ti, const bf16* er, const bf16* ep) {
      if (elected && ti < ntiles) {
        const size_t off = ((size_t)b * P + (size_t)ti * 64) * kH;
        prefetch_l2(er + off, wg::kTileBytes);
        prefetch_l2(ep + off, wg::kTileBytes);
      }
    };

    // edge_cat of this warpgroup's tile ti with the embeddings er, ep into
    // tile B (the caller has made sure both tiles are free)
    auto edge_cat = [&](int ti, const bf16* er, const bf16* ep) {
      const int r0 = ti * 64;
      const bool active = ti < ntiles;
      prefetch(ti + 2, er, ep);
      if (active) {
        // the first layer silu(rnd(d w0 + b0)) into tile A: a thread takes
        // one 16-byte unit of columns for 16 rows
        const int unit = ct & 31, rq = ct >> 5;
        float w0[8], b0[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 wv = ld2(p.dw0, unit * 8 + 2 * e), bv = ld2(p.db0, unit * 8 + 2 * e);
          w0[2 * e] = wv.x; w0[2 * e + 1] = wv.y;
          b0[2 * e] = bv.x; b0[2 * e + 1] = bv.y;
        }
        WG_T_BEGIN(t_first);
        for (int r = rq; r < 64; r += 4) {
          const float d = rb(d_g[r0 + r]);
          uint4 o;
          uint32_t* oq = &o.x;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oq[e] = wg::pack_bf16(act_silu(rb(__fadd_rn(__fmul_rn(d, w0[2 * e]), b0[2 * e]))),
                                  act_silu(rb(__fadd_rn(__fmul_rn(d, w0[2 * e + 1]),
                                                        b0[2 * e + 1]))));
          *reinterpret_cast<uint4*>(sm + ta_off + wg::img_off<2>(r, unit * 8)) = o;
        }
        WG_T_END(wg::kProfFirstLayer, t_first);
      }
      publish();
      // this thread's two rows of the embeddings (only read when active)
      const size_t row_lo = ((size_t)b * P + (size_t)(active ? r0 : 0) + r_lo) * kH;
      const bf16 *er_lo = er + row_lo, *er_hi = er_lo + 8 * kH;
      const bf16 *ep_lo = ep + row_lo, *ep_hi = ep_lo + 8 * kH;
      // de = rnd(a0 dw1 + db1): de*er into tile B, de*ep into the kept tile,
      // then tile A
      wg::product_bf16<kStagesPerMat, false, false>(
          ring, active, tile_a, 0, wg::kAtomBytes, hold,
          [&](int c, float (&acc)[16], uint32_t (&)[8]) {
            uint32_t klo[4], khi[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 32 * c + 8 * j + 2 * t;
              const float2 bias = ld2(p.db1, col);
              const float lo0 = rb(acc[4 * j] + bias.x), lo1 = rb(acc[4 * j + 1] + bias.y);
              const float hi0 = rb(acc[4 * j + 2] + bias.x), hi1 = rb(acc[4 * j + 3] + bias.y);
              const float2 rl = ld2(er_lo, col), rh = ld2(er_hi, col);
              const float2 pl = ld2(ep_lo, col), ph = ld2(ep_hi, col);
              st_shared32(sm, tb_off + wg::img_off<2>(r_lo, col),
                          wg::pack_bf16(lo0 * rl.x, lo1 * rl.y));
              st_shared32(sm, tb_off + wg::img_off<2>(r_hi, col),
                          wg::pack_bf16(hi0 * rh.x, hi1 * rh.y));
              klo[j] = wg::pack_bf16(lo0 * pl.x, lo1 * pl.y);
              khi[j] = wg::pack_bf16(hi0 * ph.x, hi1 * ph.y);
            }
            keep(c, klo, khi);
          });
      if (active) fetch_kept();
      // v = silu(rnd((de*er) c0r + (de*ep) c0p + c0b)) into the kept tile, then tile A
      wg::product_bf16<kStagesPerMat, true, false>(
          ring, active, tile_b, tile_a, wg::kAtomBytes, hold,
          [&](int c, float (&acc)[16], uint32_t (&)[8]) {
            uint32_t klo[4], khi[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 bias = ld2(p.c0b, 32 * c + 8 * j + 2 * t);
              klo[j] = wg::pack_bf16(act_silu(rb(acc[4 * j] + bias.x)),
                                     act_silu(rb(acc[4 * j + 1] + bias.y)));
              khi[j] = wg::pack_bf16(act_silu(rb(acc[4 * j + 2] + bias.x)),
                                     act_silu(rb(acc[4 * j + 3] + bias.y)));
            }
            keep(c, klo, khi);
          });
      if (active) fetch_kept();
      // ea = rnd(v c1w + c1b) into tile B
      wg::product_bf16<kStagesPerMat, false, false>(
          ring, active, tile_a, 0, wg::kAtomBytes, hold,
          [&](int c, float (&acc)[16], uint32_t (&)[8]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 32 * c + 8 * j + 2 * t;
              const float2 bias = ld2(p.c1b, col);
              st_shared32(sm, tb_off + wg::img_off<2>(r_lo, col),
                          wg::pack_bf16(acc[4 * j] + bias.x, acc[4 * j + 1] + bias.y));
              st_shared32(sm, tb_off + wg::img_off<2>(r_hi, col),
                          wg::pack_bf16(acc[4 * j + 2] + bias.x, acc[4 * j + 3] + bias.y));
            }
          });
      publish();
    };

    // 1. encoder-order edge features of every row, into the global scratch
    prefetch(w, p.er_in, p.ep_in);
    for (int tp = 0; tp < npairs; ++tp) {
      const int ti = 2 * tp + w;
      if (elected) wg::bulk_store_wait_read();  // the last tile's store has read tile B
      wg::bar_sync(bar_wg, 128);
      edge_cat(ti, p.er_in, p.ep_in);
      if (ti < ntiles && elected)
        wg::bulk_store(ea_g + (size_t)ti * kTileElems, tile_b, wg::kTileBytes);
    }
    if (elected) {
      wg::bulk_store_wait();
      wg::fence_async_all();
      wg::mbar_arrive(aempty + 8 * w);  // tile A takes the first ea tile
    }

    // 2. interaction blocks
    uint32_t afp = 0;
    for (int l = 0; l < L; ++l) {
      const bf16* f1b = p.stack.f1b + (size_t)l * kH;
      const bf16* f2b = p.stack.f2b + (size_t)l * kH;
      const bf16* l2b = p.stack.l2b + (size_t)l * kH;
      const bf16* ob = p.stack.ob + (size_t)l * kH;
      if (l == L - 1) prefetch(w, p.er_out, p.ep_out);  // the head's first tile
      wgb::interaction_block(ring, sm, base, lay, agg, c_g, f1b, f2b, l2b, ob, afull, aempty, afp,
                             w, tid, N);
    }

    // 3. head on [h_i * h_j, ea_out] with the output-order edge features
    if (L == 0) prefetch(w, p.er_out, p.ep_out);
    const float g2b = __bfloat162float(p.g2b[0]);
    float* out = p.out + (size_t)b * P;
    const uint32_t ns = lay.node_stride;
    for (int tp = 0; tp < npairs; ++tp) {
      const int ti = 2 * tp + w, r0 = ti * 64;
      const bool active = ti < ntiles;
      wg::bar_sync(bar_wg, 128);  // the last tile's head products have read tile A
      edge_cat(ti, p.er_out, p.ep_out);  // ea_out in tile B
      if (active) {
        WG_T_BEGIN(t_nodes);
        for (int idx = ct; idx < 64 * 32; idx += 128) {
          const int r = idx >> 5, unit = idx & 31;
          const int i = tab[2 * (r0 + r)], j = tab[2 * (r0 + r) + 1];
          const uint4 hi = *reinterpret_cast<const uint4*>(sm + lay.h + wg::img_off<2>(i, unit * 8, ns));
          const uint4 hj = *reinterpret_cast<const uint4*>(sm + lay.h + wg::img_off<2>(j, unit * 8, ns));
          const uint32_t* a = &hi.x;
          const uint32_t* bq = &hj.x;
          uint4 o;
          uint32_t* oq = &o.x;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = wg::unpack_bf16(a[e]), y = wg::unpack_bf16(bq[e]);
            oq[e] = wg::pack_bf16(x.x * y.x, x.y * y.y);
          }
          *reinterpret_cast<uint4*>(sm + ta_off + wg::img_off<2>(r, unit * 8)) = o;
        }
        WG_T_END(wg::kProfNodeProducts, t_nodes);
      }
      publish();
      // g = silu(rnd((h_i*h_j) g0h + ea_out g0e + g0b)) into the kept tile, then tile A
      wg::product_bf16<kStagesPerMat, true, false>(
          ring, active, tile_a, tile_b, wg::kAtomBytes, hold,
          [&](int c, float (&acc)[16], uint32_t (&)[8]) {
            uint32_t klo[4], khi[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 bias = ld2(p.g0b, 32 * c + 8 * j + 2 * t);
              klo[j] = wg::pack_bf16(act_silu(rb(acc[4 * j] + bias.x)),
                                     act_silu(rb(acc[4 * j + 1] + bias.y)));
              khi[j] = wg::pack_bf16(act_silu(rb(acc[4 * j + 2] + bias.x)),
                                     act_silu(rb(acc[4 * j + 3] + bias.y)));
            }
            keep(c, klo, khi);
          });
      if (active) fetch_kept();
      // out = rnd(silu(rnd(g g1w + g1b))) . g2w + g2b: each thread its columns
      // of two rows, then the four lanes that share the rows
      float s_lo = 0.0f, s_hi = 0.0f;
      wg::product_bf16<kStagesPerMat / 2, false, false>(
          ring, active, tile_a, 0, wg::kAtomBytes, hold,
          [&](int c, float (&acc)[16], uint32_t (&)[8]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 32 * c + 8 * j + 2 * t;
              const float2 bias = ld2(p.g1b, col), gw = ld2(p.g2w, col);
              s_lo += rb(act_silu(rb(acc[4 * j] + bias.x))) * gw.x;
              s_lo += rb(act_silu(rb(acc[4 * j + 1] + bias.y))) * gw.y;
              s_hi += rb(act_silu(rb(acc[4 * j + 2] + bias.x))) * gw.x;
              s_hi += rb(act_silu(rb(acc[4 * j + 3] + bias.y))) * gw.y;
            }
          });
      if (active) {
        s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 1);
        s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 2);
        s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 1);
        s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 2);
        if (t == 0) {
          out[r0 + r_lo] = s_lo + g2b;
          out[r0 + r_hi] = s_hi + g2b;
        }
      }
    }
    WG_T_END(wg::kProfTotal, t_consumer);
  }
}

// d, cmask, z, the four embeddings and the 25 weights: ptrs[0 .. 31]
template <typename T>
void fill_params(Params<T>& p, const void* const* ptrs, int& i) {
  p.d = static_cast<const float*>(ptrs[i++]);
  p.c = static_cast<const float*>(ptrs[i++]);
  blk::BlockWeights<T>& s = p.stack;
  const T** in[] = {&p.z, &p.er_in, &p.ep_in, &p.er_out, &p.ep_out,
                    &p.dw0, &p.db0, &p.dw1, &p.db1, &p.c0r, &p.c0p, &p.c0b, &p.c1w, &p.c1b,
                    &s.f1w, &s.f1b, &s.f2w, &s.f2b, &s.l1w, &s.l2w, &s.l2b, &s.ow, &s.ob,
                    &p.g0h, &p.g0e, &p.g0b, &p.g1w, &p.g1b, &p.g2w, &p.g2b};
  for (const T** slot : in) *slot = static_cast<const T*>(ptrs[i++]);
}

bool wg_takes(int N, int H, int is_bf16) {
  return is_bf16 && H == kH && N % 8 == 0 && N <= 255 && wgb::dense_layout(N, true).stages >= 3;
}

int launch_wg(const void* const* ptrs, int B, int N, int L, void* stream) {
  const GraphSmem lay = wgb::dense_layout(N, true);
  Params<bf16> p;
  int i = 0;
  fill_params(p, ptrs, i);
  const bf16* wimg = static_cast<const bf16*>(ptrs[i++]);
  p.ea = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  p.out = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  if (i != kNumPtrs || wimg == nullptr || lay.total > wgb::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  p.B = B; p.N = N; p.H = kH; p.L = L;
  cudaError_t e = cudaFuncSetAttribute(condensed_score_wg_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  condensed_score_wg_kernel<<<B, wg::kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(
      p, wimg);
  return (int)cudaGetLastError();
}

template <typename T, int TR>
int launch(const void* const* ptrs, int B, int N, int H, int L, void* stream) {
  const Smem lay = smem_layout<T, TR>(N, H);
  if (lay.np > TR || lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params<T> p;
  int i = 0;
  fill_params(p, ptrs, i);
  ++i;  // the arranged weight image: the warp-specialised kernel's
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

WG_PROFILE_ENTRY(condensed_score_profile)

extern "C" {

// Launches the score kernel on `stream`; returns the cudaError_t of the launch.
// ptrs: d, cmask, z, er_in, ep_in, er_out, ep_out, the 25 weights in the order
// of Params, the arranged weight image (may be null where
// condensed_score_uses_wg says 0), the scratch and the output.  bf16 at
// H = 256 takes the warp-specialised kernel whenever its shared memory fits
// (N <= 24); every other shape, and float32, takes the mma.sync kernel.
int condensed_score_launch(const void* const* ptrs, int B, int N, int H, int L, int is_bf16,
                           void* stream) {
  if (N <= 0 || N % 8 != 0 || H <= 0 || H % 64 != 0 || L < 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  if (wg_takes(N, H, is_bf16)) return launch_wg(ptrs, B, N, L, stream);
  if (is_bf16) return launch<__nv_bfloat16, 64>(ptrs, B, N, H, L, stream);
  return launch<float, 32>(ptrs, B, N, H, L, stream);
}

// 1 where condensed_score_launch takes the warp-specialised kernel.  Its
// scratch is, per graph, N*N/64 ea tile images of 32 KB and two more (one per
// consumer warpgroup) for kept results; the mma.sync kernel's is (N*N, H).
int condensed_score_uses_wg(int N, int H, int is_bf16) { return wg_takes(N, H, is_bf16) ? 1 : 0; }

const char* condensed_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
