// Offset-packed fused score step of the condensed-encoder ensemble, for Hopper.
//
// Replaces the TPU kernel tsdiff_tpu/ops/pallas/condensed_score_packed.py::
// packed_score_pallas (kernel _score_kernel) and computes the same function
// for all M ensemble members in one launch.  Per (member m, graph b), on the
// packed pair rows p = (k-1)*N + i (the unordered pair {i, (i+k) % N}):
//
//   1. distance MLP   de = W1 silu(d*w0 + b0) + b1                   (R, H)
//   2. bond embedding er/ep = table[type]  (a row read; the TPU did a
//      one-hot matmul against a 128-row table)
//   3. edge_cat       ea = C1 silu(C0r (de*er) + C0p (de*ep) + c0) + c1
//   4. L SchNet blocks with the symmetric roll aggregation
//        agg[(i+k)%N] += w[k,i]*xh[i],   agg[i] += w[k,i]*xh[(i+k)%N]
//   5. out-order edge_cat on the same de (recomputed, see below)
//   6. head MLP 2H->H->H/2->1 on [h_i * h_(i+k)%N, ea_out]
//
// Layout and rounding follow the TPU kernel: the working type T (float or
// bf16) is what every activation is rounded to after each bias add and each
// silu/ssp, products w*xh are rounded to T before they are summed in f32,
// matrix products accumulate in f32.
//
// Bound at the main path's shapes (M=8, B=100, N=24, H=F=256, L=7, bf16):
// ~7.6e11 flop per launch against ~56 MB of inputs and outputs (mostly the
// members' weights), so the tensor-core rate bounds it (~0.77 ms at 989
// TFLOP/s, against ~17 us for the bytes at 3.35 TB/s).  Beside the products
// a row element passes ~12.5 silu/ssp: special-function and rounding work of
// the same order as the tensor-core time, which has to run under the
// products, not after them.
//
// Two kernels.  One CTA owns one (member, graph) in both, member-major, so
// CTAs in flight share a member's weights in L2; the node states and the f32
// aggregation stay in shared memory, the encoder-order edge features ea go
// once to a global scratch and come back in every block, de is recomputed
// for the output stage.
//
// packed_score_kernel (float32, and bf16 at widths or N the other does not
// take): the first port.  256 threads, 64-row tiles (32 in f32), every lane
// fetches its mma.sync B fragments from the (out, in) weight rows in L2, four
// bytes at a time, once per row tile: 143.5 matrix reads per CTA at N=24,
// 15.0 GB of L2 reads per launch at the shapes above, which alone keeps it at
// 14.3 ms (53 TFLOP/s).  It exists to check the arithmetic (f32) and as the
// explicit branch for what the new kernel does not cover.
//
// packed_score_wg_kernel (bf16, H = 256, N <= 24; csrc/wg_pipeline.cuh):
//   * warp-specialised, 384 threads: a producer warp walks a static schedule
//     of (matrix, 32-column block) stages (ops/packed_score.py::wg_schedule),
//     the same for every CTA of a shape,
//     and fills a shared-memory ring (3 stages of 16 KB at N=24, more at
//     smaller N) with one bulk asynchronous copy per stage, completing on
//     mbarriers; setmaxnreg moves its registers to the consumers.  The
//     weights were arranged once, by ops/packed_score.py::arrange_weights,
//     into the swizzled image wgmma reads, so the copy is 1-D: no tensor map.
//   * two consumer warpgroups hold one 64-row tile each and read the same
//     stage: 128 pair rows per stage read from L2, three tile pairs instead
//     of five tiles at N=24: 9.9 GB per launch (0.66x; 0.65x at N=16).
//   * wgmma.mma_async m64n32k16, f32 accumulators in registers, two sets, so
//     a stage's epilogue (bias, round, silu/ssp, round, pack) runs on the
//     fragment while the next stage's products are in flight.  The
//     activations use ex2/lg2/rcp: the accurate expf/log1pf/division cost
//     40 % of the kernel (10.6 -> 7.4 ms), their error is below bf16's.
//   * the chains of edge_cat (. -> c0 -> c1) and the head (. -> g0 -> g1)
//     alternate between two shared-memory tiles per warpgroup.  Chaining
//     through registers (the accumulator fragment is the next product's A
//     fragment, 64-column stages) was built first and is right, but needs
//     both products' fragments and the accumulators at once: at 232 registers
//     ptxas serialized every wgmma (C7512) and spilled, 11-12 ms.  What does not
//     fit is then shared memory: four tiles leave 48 KB for the ring at N=24,
//     hence 32-column stages.
//   * the filter chain (ea -> f1 -> f2, L times per tile, 60 % of the flops)
//     runs in registers (filter_chain): each 32-column stage of f1 is, after
//     its epilogue, the A fragment of one 32-deep K-block of f2, which runs
//     full width, two m64n256k16 a K-block with A from registers, from stages
//     of f2w's K-blocks (256 rows of 64 bytes, the 64-byte swizzle;
//     ops/packed_score.py::kblock_image, made once at load).  f2 was 128
//     m64n32k16 a tile, each reading 2 KB of A and 1 KB of B from shared memory
//     for 16 cycles of tensor work (192 B/cycle against the SM's 128), its
//     results kept in local memory until the product ended; now 16 m64n256k16
//     read 8 KB of B each for 128 cycles, s1 never leaves registers, and w
//     goes to tile B once, from f2's whole 64 x 256 accumulator.  Live across
//     the chain: f2's 128 accumulators, f1's 16, two sets of 8 fragment
//     registers.  That fits only with more registers than the launch's 168:
//     the consumers take 240 and the producer 24 (kRegsConsumerB1), and ptxas
//     gives a setmaxnreg region its count only if no trap instruction is
//     inline in the function: with the bounded waits' __trap() inline it held
//     every region to 168, serialized the wgmma (C7512) and spilled 4.6 KB, at
//     224, 232 or 240; with the trap called (WG_TRAP_OUTLINED) no C7512 and
//     1,024 bytes of spill stores (1,176 before; 1,260 at 224, 1,144 at 232).
//   * ea is stored as 64-row tile images by one bulk copy per tile and
//     fetched into tile A by the producer one tile ahead (118 MB written and
//     826 MB read per launch at the shapes above, more than L2 holds: about
//     0.28 ms of device-memory time; left as it is).
//   * the aggregation has no division and no serial walk: a warpgroup takes
//     half the nodes, a thread two columns of four nodes at a time in
//     registers, offsets in a fixed order; no atomics, bitwise repeatable.
//   * node products (l1w, l2w, ow) run through the same ring on the N node
//     rows of a 64-row wgmma, the warpgroups taking alternate stages.
// Measured on an H100 at 700 W: 6.9 ms at N=24 (14.3 before), 3.5 at N=16
// (6.9); with the filter chain in registers 6.42 and 3.26 (6.90 and 3.50 in
// the same call, random weights at M=8, B=100).  The profile (ops/wg_profile.py,
// -DWG_PROFILE) of one consumer lane at N=24: epilogues 25 %, aggregation 16 %,
// node products 15 %, wgmma dispatch 12 %, ring waits 5 %: the two warpgroups
// share one shallow ring, so they run in step and nothing hides one's
// epilogue behind the other's products.  A deeper ring, or one per
// warpgroup, is the next lever; shared memory is what it costs.

#include "graph_block.cuh"
#define WG_TRAP_OUTLINED  // the filter chain needs setmaxnreg's registers (wg_pipeline.cuh)
#include "wg_pipeline.cuh"

namespace {

using tile::from_f;
using tile::gemm;
using tile::kThreads;
using tile::rnd;
using tile::silu_f;
using tile::ssp_f;
using tile::to_f;

constexpr int kNumPtrs = 37;

template <typename T>
struct Params {
  const float* d;     // (B, R) packed distances
  const float* c;     // (B, R) cutoff mask with the 0.5 last-slab factor
  const T* z;         // (M, B, N, H) node states
  const int* tr_in;   // (B, R) bond types, encoder order
  const int* tp_in;
  const int* tr_out;  // (B, R) bond types, output order
  const int* tp_out;
  // weights, each stacked (M, ...); matrices in (out, in) layout
  const T* table;  // (V, H)
  const T* dw0;    // (H)
  const T* db0;
  const T* dw1;    // (H, H)
  const T* db1;
  const T* c0r;    // (H, H)
  const T* c0p;
  const T* c0b;
  const T* c1w;
  const T* c1b;
  const T* f1w;    // (L, H, H)
  const T* f1b;    // (L, H)
  const T* f2w;
  const T* f2b;
  const T* l1w;
  const T* l2w;
  const T* l2b;
  const T* ow;
  const T* ob;
  const T* g0h;    // (H, H)
  const T* g0e;
  const T* g0b;
  const T* g1w;    // (H/2, H)
  const T* g1b;
  const T* g2w;    // (H/2)
  const T* g2b;    // (1)
  T* ea;           // (M*B, R, H) scratch
  float* out;      // (M, B, R)
  int M, B, N, H, L, V;
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
  s.rows = (size_t)TR * 4 * sizeof(float);
  s.total = 3 * s.buf + 2 * s.node + s.agg + s.rows;
  return s;
}

template <typename T, int TR>
__global__ void __launch_bounds__(kThreads, 1) packed_score_kernel(Params<T> p) {
  constexpr int MF = TR / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, H = p.H, L = p.L, B = p.B;
  const int K = N / 2, R = K * N, Hh = H / 2;
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
  int* ta_s = reinterpret_cast<int*>(c_s + TR);
  int* tb_s = ta_s + TR;

  const int mb = blockIdx.x;  // member-major: CTAs in flight share a member's weights
  const int m = mb / B, b = mb % B;
  const int tid = threadIdx.x;

  const size_t HH = (size_t)H * H;
  const T* table = p.table + (size_t)m * p.V * H;
  const T* dw0 = p.dw0 + (size_t)m * H;
  const T* db0 = p.db0 + (size_t)m * H;
  const T* dw1 = p.dw1 + m * HH;
  const T* db1 = p.db1 + (size_t)m * H;
  const T* c0r = p.c0r + m * HH;
  const T* c0p = p.c0p + m * HH;
  const T* c0b = p.c0b + (size_t)m * H;
  const T* c1w = p.c1w + m * HH;
  const T* c1b = p.c1b + (size_t)m * H;
  const T* f1w = p.f1w + m * L * HH;
  const T* f1b = p.f1b + (size_t)m * L * H;
  const T* f2w = p.f2w + m * L * HH;
  const T* f2b = p.f2b + (size_t)m * L * H;
  const T* l1w = p.l1w + m * L * HH;
  const T* l2w = p.l2w + m * L * HH;
  const T* l2b = p.l2b + (size_t)m * L * H;
  const T* ow = p.ow + m * L * HH;
  const T* ob = p.ob + (size_t)m * L * H;
  const T* g0h = p.g0h + m * HH;
  const T* g0e = p.g0e + m * HH;
  const T* g0b = p.g0b + (size_t)m * H;
  const T* g1w = p.g1w + m * (HH / 2);
  const T* g1b = p.g1b + (size_t)m * Hh;
  const T* g2w = p.g2w + (size_t)m * Hh;
  const float g2b = to_f(p.g2b[m]);

  const float* d_g = p.d + (size_t)b * R;
  const float* c_g = p.c + (size_t)b * R;
  T* ea_g = p.ea + (size_t)mb * R * H;

  // node states; pad rows stay zero
  for (int idx = tid; idx < NP * H; idx += kThreads) {
    const int r = idx / H, col = idx % H;
    h_s[r * lda + col] = r < N ? p.z[((size_t)mb * N + r) * H + col] : from_f<T>(0.0f);
  }

  auto load_rows = [&](int r0, int nr, const int* ta, const int* tb) {
    for (int r = tid; r < nr; r += kThreads) {
      d_s[r] = rnd<T>(d_g[r0 + r]);
      c_s[r] = rnd<T>(c_g[r0 + r]);
      ta_s[r] = ta[(size_t)b * R + r0 + r];
      tb_s[r] = tb[(size_t)b * R + r0 + r];
    }
    __syncthreads();
  };

  // edge_cat of one row tile (d_s, ta_s, tb_s loaded) into dst (leading dim ld)
  auto edge_cat = [&](int nr, T* dst, int ld) {
    for (int idx = tid; idx < nr * H; idx += kThreads) {
      const int r = idx / H, col = idx % H;
      float x = rnd<T>(d_s[r] * to_f(dw0[col]));
      x = rnd<T>(x + to_f(db0[col]));
      bufA[r * lda + col] = from_f<T>(silu_f(x));
    }
    __syncthreads();
    gemm<T, MF>(bufA, dw1, nullptr, nullptr, lda, nr, H, H, [&](int r, int col, float v) {
      bufB[r * lda + col] = from_f<T>(v + to_f(db1[col]));
    });
    for (int idx = tid; idx < nr * H; idx += kThreads) {
      const int r = idx / H, col = idx % H;
      const float de = to_f(bufB[r * lda + col]);
      bufA[r * lda + col] = from_f<T>(de * to_f(table[(size_t)ta_s[r] * H + col]));
      bufC[r * lda + col] = from_f<T>(de * to_f(table[(size_t)tb_s[r] * H + col]));
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
  for (int r0 = 0; r0 < R; r0 += TR) {
    const int nr = min(TR, R - r0);
    load_rows(r0, nr, p.tr_in, p.tp_in);
    edge_cat(nr, ea_g + (size_t)r0 * H, H);
  }

  // 2. interaction blocks
  const blk::BlockWeights<T> stack = {f1w, f1b, f2w, f2b, l1w, l2w, l2b, ow, ob};
  for (int l = 0; l < L; ++l)
    blk::interaction_block<T, TR, true>(bufA, bufB, h_s, xh_s, agg, c_s, ea_g, c_g,
                                        stack.at(l, H), lda, NP, N, R, H);

  // 3. head on [h_i * h_j, ea_out] with the output-order edge features
  float* out = p.out + (size_t)mb * R;
  for (int r0 = 0; r0 < R; r0 += TR) {
    const int nr = min(TR, R - r0);
    load_rows(r0, nr, p.tr_out, p.tp_out);
    edge_cat(nr, bufA, lda);
    for (int idx = tid; idx < nr * H; idx += kThreads) {
      const int r = idx / H, col = idx % H;
      const int pr = r0 + r, k = pr / N + 1, i = pr - (k - 1) * N;
      const int j = i + k < N ? i + k : i + k - N;
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
using wgb::bf16;
using wgb::kH;
using wgb::kHH;
using wgb::kMaxSmem;
using wgb::kStageElems;
using wgb::kStagesPerMat;
using wgb::kTileElems;
using wgb::ld2;
using wgb::rb;
using wgb::st_shared32;
using wgb::store_hold;
using wgb::GraphSmem;
using wgb::graph_layout;

// Offsets of the matrices in a member's arranged weight image, in units of
// kHH elements (ops/packed_score.py::arrange_weights writes this order).  The
// image holds f2w at units 4 + L + l for B2; this kernel reads f2w from its
// K-block image (f2k_all) instead.
struct WImage {
  int L;
  __host__ __device__ int dw1() const { return 0; }
  __host__ __device__ int c0r() const { return 1; }
  __host__ __device__ int c0p() const { return 2; }
  __host__ __device__ int c1w() const { return 3; }
  __host__ __device__ int f1w(int l) const { return 4 + l; }
  __host__ __device__ int l1w(int l) const { return 4 + 2 * L + l; }
  __host__ __device__ int l2w(int l) const { return 4 + 3 * L + l; }
  __host__ __device__ int ow(int l) const { return 4 + 4 * L + l; }
  __host__ __device__ int g0h() const { return 4 + 5 * L; }
  __host__ __device__ int g0e() const { return 5 + 5 * L; }
  __host__ __device__ int g1w() const { return 6 + 5 * L; }  // half a unit
  __host__ __device__ size_t elems() const { return (size_t)(13 + 10 * L) * (kHH / 2); }
};

// The filter chain of one warpgroup's 64-row tile, the first product's output
// kept in registers: per column block c of f1, the f1 stage (m64n32k16 over
// K = 256, A the ea tile image at a_img) into acc1, epi1(c, acc1, a) leaving
// its 32 columns as the A fragments of K-block c of f2 (k16 steps 2c, 2c+1),
// and that K-block's two m64n256k16 into acc2, which holds f2's whole 64 x 256
// output.  Ring stages in the order f1(0), f1(1), f2(0), f1(2), f2(1), ...,
// f1(7), f2(6), f2(7) (ops/packed_score.py::wg_schedule).  Step c waits for
// f2(c-1) and releases its stage, then issues f1(c+1) and f2(c), one commit
// group each, and waits for all but the newest: f1(c+1) has ended, and f2(c)
// (with the fragments of K-block c, hence two sets of them) is still on the
// tensor core while epi1(c+1) runs.  A warpgroup holds at most two stages, so
// the producer keeps one more in flight than with three.  acc2 is whole, and
// fenced, on return.  An inactive warpgroup (no rows in this tile) only passes
// the stages on.
template <typename Epi>
__device__ __forceinline__ void filter_chain(wg::Ring& ring, bool active, uint32_t a_img,
                                             float (&acc2)[128], Epi epi1) {
  if (!active) {
    for (int i = 0; i < 2 * kStagesPerMat; ++i) {
      ring.acquire();
      ring.release();
    }
    return;
  }
  float acc1[16];
  uint32_t a[2][8];
  auto issue_f1 = [&]() {
    uint32_t b;
    WG_T(wg::kProfAcquire, b = ring.acquire());
    WG_T(wg::kProfDispatch, wg::mma_stage_bf16(acc1, a_img, wg::kAtomBytes, b, true);
         wg::wgmma_commit());
  };
  auto issue_f2 = [&](const uint32_t (&frag)[8], bool zero) {
    uint32_t b;
    WG_T(wg::kProfAcquire, b = ring.acquire());
    WG_T(wg::kProfDispatch, wg::fence_acc128(acc2); wg::mma_kblock_bf16_n256(acc2, frag, b, zero);
         wg::wgmma_commit(); wg::fence_acc128(acc2));
  };
  wg::wgmma_fence();
  issue_f1();
  WG_T(wg::kProfWait, wg::wgmma_wait<0>());
  wg::fence_operand(acc1);
  ring.release();
  WG_T(wg::kProfEpilogue, epi1(0, acc1, a[0]));
#pragma unroll
  for (int c = 0; c < kStagesPerMat; ++c) {
    if (c > 0) {
      WG_T(wg::kProfWait, wg::wgmma_wait<0>());  // f2(c-1) has ended
      wg::fence_acc128(acc2);
      ring.release();
    }
    wg::wgmma_fence();
    if (c + 1 < kStagesPerMat) issue_f1();
    issue_f2(a[c & 1], c == 0);
    if (c + 1 < kStagesPerMat) {
      WG_T(wg::kProfWait, wg::wgmma_wait<1>());  // f1(c+1) has ended
      wg::fence_operand(acc1);
      ring.release();
      WG_T(wg::kProfEpilogue, epi1(c + 1, acc1, a[(c + 1) & 1]));
    }
  }
  WG_T(wg::kProfWait, wg::wgmma_wait<0>());
  wg::fence_acc128(acc2);
  ring.release();  // f2(7)
}

// setmaxnreg of the warp-specialised kernel's consumer and producer warpgroups
constexpr int kRegsConsumerB1 = 240, kRegsProducerB1 = 24;

__global__ void __launch_bounds__(wg::kThreads, 1)
packed_score_wg_kernel(Params<bf16> p, const bf16* __restrict__ wimg_all,
                       const bf16* __restrict__ f2k_all) {
  extern __shared__ unsigned char smem_raw[];
  const int N = p.N, L = p.L, B = p.B;
  const int K = N / 2, R = K * N, ntiles = (R + 63) / 64, npairs = (ntiles + 1) / 2;
  const GraphSmem lay = graph_layout(N);
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ns = lay.node_stride;
  const uint32_t full = base + lay.bars, empty = full + 8 * wg::kMaxStages;
  const uint32_t afull = empty + 8 * wg::kMaxStages, aempty = afull + 16;
  unsigned char* tab = sm + lay.tab;
  float* agg = reinterpret_cast<float*>(sm + lay.agg);

  const int mb = blockIdx.x;  // member-major: CTAs in flight share a member's weights
  const int m = mb / B, b = mb % B;
  const int tid = threadIdx.x;
  // warp-uniform by construction, and known to the compiler as such: wgmma
  // under a branch it takes for divergent is serialized
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const WImage wi = {L};
  const bf16* wimg = wimg_all + (size_t)m * wi.elems();
  const bf16* f2k = f2k_all + (size_t)m * L * kHH;  // f2w's K-blocks, layer after layer
  bf16* ea_g = p.ea + (size_t)mb * ntiles * kTileElems;  // tile images, 32 KB each

  wgb::cta_setup(sm, base, lay, p.z + (size_t)mb * N * kH, N);

  if (warp_idx >= wg::kConsumers / 32) {
    // ===== producer: the static schedule of weight stages and ea tiles =====
    wg::reg_dealloc<kRegsProducerB1>();
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
          // the filter chain: f1(0), then f1(c+1) and f2's K-block c in turn
          const bf16* f1 = mat(wi.f1w(l));
          const bf16* f2 = f2k + (size_t)l * kHH;
          ring.fill(f1);
          for (int c = 0; c < kStagesPerMat; ++c) {
            if (c + 1 < kStagesPerMat) ring.fill(f1 + (c + 1) * kStageElems);
            ring.fill(f2 + c * kStageElems);
          }
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
    wg::reg_alloc<kRegsConsumerB1>();
    WG_T_BEGIN(t_consumer);
    wg::Ring ring{full, empty, base + lay.ring, lay.stages};
    const int w = warp_idx >> 2, ct = tid & 127, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = ((ct >> 5) << 4) + g, r_hi = r_lo + 8;
    const bool elected = ct == 0;
    const int bar_wg = wgb::kBarWg0 + w;
    const uint32_t ta_off = lay.tiles + 2 * w * wg::kTileBytes, tb_off = ta_off + wg::kTileBytes;
    const uint32_t tile_a = base + ta_off, tile_b = base + tb_off;
    // after generic stores into a tile: visible to wgmma, in every warp
    auto publish = [&]() {
      wg::fence_async_shared();
      wg::bar_sync(bar_wg, 128);
    };

    const bf16* table = p.table + (size_t)m * p.V * kH;
    const float* d_g = p.d + (size_t)b * R;
    const float* c_g = p.c + (size_t)b * R;

    // edge_cat of this warpgroup's tile ti into tile B (the caller has made
    // sure both tiles are free)
    auto edge_cat = [&](int ti, const int* ta_g, const int* tb_g) {
      const bf16* dw0 = p.dw0 + (size_t)m * kH;
      const bf16* db0 = p.db0 + (size_t)m * kH;
      const bf16* db1 = p.db1 + (size_t)m * kH;
      const bf16* c0b = p.c0b + (size_t)m * kH;
      const bf16* c1b = p.c1b + (size_t)m * kH;
      const int r0 = ti * 64, nr = min(64, R - r0);
      const bool active = nr > 0;
      if (active) {
        // the first layer silu(rnd(rnd(d w0) + b0)) into tile A: a thread
        // takes one 16-byte unit of columns for 16 rows
        const int unit = ct & 31, rq = ct >> 5;
        float w0[8], b0[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 wv = ld2(dw0, unit * 8 + 2 * e), bv = ld2(db0, unit * 8 + 2 * e);
          w0[2 * e] = wv.x; w0[2 * e + 1] = wv.y;
          b0[2 * e] = bv.x; b0[2 * e + 1] = bv.y;
        }
        WG_T_BEGIN(t_first);
        for (int r = rq; r < 64; r += 4) {
          const float d = r < nr ? rb(d_g[r0 + r]) : 0.0f;
          uint4 o;
          uint32_t* oq = &o.x;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oq[e] = wg::pack_bf16(act_silu(rb(rb(d * w0[2 * e]) + b0[2 * e])),
                                  act_silu(rb(rb(d * w0[2 * e + 1]) + b0[2 * e + 1])));
          *reinterpret_cast<uint4*>(sm + ta_off + wg::img_off<2>(r, unit * 8)) = o;
        }
        WG_T_END(wg::kProfFirstLayer, t_first);
      }
      publish();
      int ta_lo = 0, ta_hi = 0, tb_lo = 0, tb_hi = 0;
      if (active && r_lo < nr) {
        ta_lo = ta_g[(size_t)b * R + r0 + r_lo];
        tb_lo = tb_g[(size_t)b * R + r0 + r_lo];
      }
      if (active && r_hi < nr) {
        ta_hi = ta_g[(size_t)b * R + r0 + r_hi];
        tb_hi = tb_g[(size_t)b * R + r0 + r_hi];
      }
      const bf16* er_lo = table + (size_t)ta_lo * kH;
      const bf16* er_hi = table + (size_t)ta_hi * kH;
      const bf16* ep_lo = table + (size_t)tb_lo * kH;
      const bf16* ep_hi = table + (size_t)tb_hi * kH;
      // de = rnd(a0 dw1 + db1): de*er straight into tile B, de*ep kept until
      // the product has read all of tile A, then stored there
      uint32_t hold[64];
      wg::product_bf16<kStagesPerMat, false, true>(ring, active, tile_a, 0, wg::kAtomBytes, hold,
                                             [&](int c, float (&acc)[16], uint32_t (&out)[8]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 32 * c + 8 * j + 2 * t;
          const float2 bias = ld2(db1, col);
          const float lo0 = rb(acc[4 * j] + bias.x), lo1 = rb(acc[4 * j + 1] + bias.y);
          const float hi0 = rb(acc[4 * j + 2] + bias.x), hi1 = rb(acc[4 * j + 3] + bias.y);
          const float2 rl = ld2(er_lo, col), rh = ld2(er_hi, col);
          const float2 pl = ld2(ep_lo, col), ph = ld2(ep_hi, col);
          st_shared32(sm, tb_off + wg::img_off<2>(r_lo, col),
                      wg::pack_bf16(lo0 * rl.x, lo1 * rl.y));
          st_shared32(sm, tb_off + wg::img_off<2>(r_hi, col),
                      wg::pack_bf16(hi0 * rh.x, hi1 * rh.y));
          out[2 * j] = wg::pack_bf16(lo0 * pl.x, lo1 * pl.y);
          out[2 * j + 1] = wg::pack_bf16(hi0 * ph.x, hi1 * ph.y);
        }
      });
      if (active) {
        wg::bar_sync(bar_wg, 128);  // every warp's reads of tile A have ended
        WG_T(wg::kProfStoreKept, store_hold(sm, ta_off, hold, r_lo, t));
      }
      publish();
      // v = silu(rnd((de*er) c0r + (de*ep) c0p + c0b)), kept, then into tile A
      wg::product_bf16<kStagesPerMat, true, true>(ring, active, tile_b, tile_a, wg::kAtomBytes, hold,
                                            [&](int c, float (&acc)[16], uint32_t (&out)[8]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 bias = ld2(c0b, 32 * c + 8 * j + 2 * t);
          out[2 * j] = wg::pack_bf16(act_silu(rb(acc[4 * j] + bias.x)),
                                              act_silu(rb(acc[4 * j + 1] + bias.y)));
          out[2 * j + 1] = wg::pack_bf16(act_silu(rb(acc[4 * j + 2] + bias.x)),
                                                  act_silu(rb(acc[4 * j + 3] + bias.y)));
        }
      });
      if (active) {
        wg::bar_sync(bar_wg, 128);
        WG_T(wg::kProfStoreKept, store_hold(sm, ta_off, hold, r_lo, t));
      }
      publish();
      // ea = rnd(v c1w + c1b) into tile B
      wg::product_bf16<kStagesPerMat, false, false>(ring, active, tile_a, 0, wg::kAtomBytes, hold,
                                             [&](int c, float (&acc)[16], uint32_t (&out)[8]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 32 * c + 8 * j + 2 * t;
          const float2 bias = ld2(c1b, col);
          st_shared32(sm, tb_off + wg::img_off<2>(r_lo, col),
                      wg::pack_bf16(acc[4 * j] + bias.x, acc[4 * j + 1] + bias.y));
          st_shared32(sm, tb_off + wg::img_off<2>(r_hi, col),
                      wg::pack_bf16(acc[4 * j + 2] + bias.x, acc[4 * j + 3] + bias.y));
        }
      });
      publish();
    };

    // 1. encoder-order edge features of every row, into the global scratch.
    //    The scratch is written and read back by this CTA alone, L times: at
    //    the main path's shapes 131 MB written and 826 MB read per launch,
    //    more than L2 holds, about 0.28 ms of device-memory time.
    for (int tp = 0; tp < npairs; ++tp) {
      const int ti = 2 * tp + w;
      if (elected) wg::bulk_store_wait_read();  // the last tile's store has read tile B
      wg::bar_sync(bar_wg, 128);
      edge_cat(ti, p.tr_in, p.tp_in);
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
      const bf16* f1b = p.f1b + ((size_t)m * L + l) * kH;
      const bf16* f2b = p.f2b + ((size_t)m * L + l) * kH;
      const bf16* l2b = p.l2b + ((size_t)m * L + l) * kH;
      const bf16* ob = p.ob + ((size_t)m * L + l) * kH;
      WG_T(wg::kProfNodeProducts,
           wgb::block_begin(ring, sm, base, lay, agg, w, tid, r_lo, t, N));

      for (int tp = 0; tp < npairs; ++tp) {
        const int ti = 2 * tp + w, r0 = ti * 64, nr = min(64, R - r0);
        const bool active = nr > 0;
        float c_lo = 0.0f, c_hi = 0.0f;
        if (active) {
          if (r_lo < nr) c_lo = rb(c_g[r0 + r_lo]);
          if (r_hi < nr) c_hi = rb(c_g[r0 + r_hi]);
          WG_T(wg::kProfTileWait, wg::mbar_wait(afull + 8 * w, afp));
          afp ^= 1;
        }
        // s1 = rnd(ssp(rnd(ea f1w + f1b))) in registers, as f2's A fragments
        float acc2[128];
        filter_chain(ring, active, tile_a, acc2,
                     [&](int c, float (&acc)[16], uint32_t (&frag)[8]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 bias = ld2(f1b, 32 * c + 8 * j + 2 * t);
            // group j: k16 step j / 2 of the K-block, registers 2 (j % 2), 2 (j % 2) + 1
            frag[4 * (j >> 1) + 2 * (j & 1)] = wg::pack_bf16(act_ssp(rb(acc[4 * j] + bias.x)),
                                                             act_ssp(rb(acc[4 * j + 1] + bias.y)));
            frag[4 * (j >> 1) + 2 * (j & 1) + 1] =
                wg::pack_bf16(act_ssp(rb(acc[4 * j + 2] + bias.x)),
                              act_ssp(rb(acc[4 * j + 3] + bias.y)));
          }
        });
        // w = rnd(rnd(s1 f2w + f2b) * c) into tile B, which nothing else reads now
        if (active) {
          WG_T_BEGIN(t_epi);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = 8 * j + 2 * t;
            const float2 bias = ld2(f2b, col);
            st_shared32(sm, tb_off + wg::img_off<2>(r_lo, col),
                        wg::pack_bf16(rb(acc2[4 * j] + bias.x) * c_lo,
                                      rb(acc2[4 * j + 1] + bias.y) * c_lo));
            st_shared32(sm, tb_off + wg::img_off<2>(r_hi, col),
                        wg::pack_bf16(rb(acc2[4 * j + 2] + bias.x) * c_hi,
                                      rb(acc2[4 * j + 3] + bias.y) * c_hi));
          }
          WG_T_END(wg::kProfEpilogue, t_epi);
        }
        // both w tiles are written, and every wgmma of the chain has read tile A
        wg::bar_sync(wgb::kBarConsumers, wg::kConsumers);
        if (active && elected) wg::mbar_arrive(aempty + 8 * w);  // tile A takes the next ea tile
        WG_T(wg::kProfAggregate, wgb::aggregate_pair(sm, lay, agg, tp, w, ct, N, R));
        wg::bar_sync(wgb::kBarConsumers, wg::kConsumers);  // the w tiles are read, agg is whole
      }

      WG_T(wg::kProfNodeProducts,
           wgb::node_update(ring, sm, base, lay, agg, l2b, ob, w, tid, r_lo, t, N));
    }

    // 3. head on [h_i * h_j, ea_out] with the output-order edge features
    const bf16* g0b = p.g0b + (size_t)m * kH;
    const bf16* g1b = p.g1b + (size_t)m * (kH / 2);
    const bf16* g2w = p.g2w + (size_t)m * (kH / 2);
    const float g2b = to_f(p.g2b[m]);
    float* out = p.out + (size_t)mb * R;
    for (int tp = 0; tp < npairs; ++tp) {
      const int ti = 2 * tp + w, r0 = ti * 64, nr = min(64, R - r0);
      const bool active = nr > 0;
      wg::bar_sync(bar_wg, 128);  // the last tile's head products have read tile A
      edge_cat(ti, p.tr_out, p.tp_out);  // ea_out in tile B
      if (active) {
        for (int idx = ct; idx < 64 * 32; idx += 128) {
          const int r = idx >> 5, unit = idx & 31;
          uint4 o = make_uint4(0u, 0u, 0u, 0u);
          if (r < nr) {
            const int i = tab[2 * (r0 + r)], j = tab[2 * (r0 + r) + 1];
            const uint4 hi = *reinterpret_cast<const uint4*>(sm + lay.h + wg::img_off<2>(i, unit * 8, ns));
            const uint4 hj = *reinterpret_cast<const uint4*>(sm + lay.h + wg::img_off<2>(j, unit * 8, ns));
            const uint32_t* a = &hi.x;
            const uint32_t* bq = &hj.x;
            uint32_t* oq = &o.x;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 x = wg::unpack_bf16(a[e]), y = wg::unpack_bf16(bq[e]);
              oq[e] = wg::pack_bf16(x.x * y.x, x.y * y.y);
            }
          }
          *reinterpret_cast<uint4*>(sm + ta_off + wg::img_off<2>(r, unit * 8)) = o;
        }
      }
      publish();
      // g = silu(rnd((h_i*h_j) g0h + ea_out g0e + g0b)), kept, then into tile A
      uint32_t hold[64];
      wg::product_bf16<kStagesPerMat, true, true>(ring, active, tile_a, tile_b, wg::kAtomBytes, hold,
                                            [&](int c, float (&acc)[16], uint32_t (&out)[8]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 bias = ld2(g0b, 32 * c + 8 * j + 2 * t);
          out[2 * j] = wg::pack_bf16(act_silu(rb(acc[4 * j] + bias.x)),
                                              act_silu(rb(acc[4 * j + 1] + bias.y)));
          out[2 * j + 1] = wg::pack_bf16(act_silu(rb(acc[4 * j + 2] + bias.x)),
                                                  act_silu(rb(acc[4 * j + 3] + bias.y)));
        }
      });
      if (active) {
        wg::bar_sync(bar_wg, 128);
        WG_T(wg::kProfStoreKept, store_hold(sm, ta_off, hold, r_lo, t));
      }
      publish();
      // out = rnd(silu(rnd(g g1w + g1b))) . g2w + g2b: each thread its columns
      // of two rows, then the four lanes that share the rows
      float s_lo = 0.0f, s_hi = 0.0f;
      wg::product_bf16<kStagesPerMat / 2, false, false>(ring, active, tile_a, 0, wg::kAtomBytes, hold,
                                                 [&](int c, float (&acc)[16], uint32_t (&out)[8]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 32 * c + 8 * j + 2 * t;
          const float2 bias = ld2(g1b, col), gw = ld2(g2w, col);
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
        if (t == 0 && r_lo < nr) out[r0 + r_lo] = s_lo + g2b;
        if (t == 0 && r_hi < nr) out[r0 + r_hi] = s_hi + g2b;
      }
    }
    WG_T_END(wg::kProfTotal, t_consumer);
  }
}

// The tile product alone, for a test against a matrix product: out[0] = A W^T
// with A from shared memory (warpgroup 0), out[1] the same with A from
// registers (warpgroup 1), out[2] the same full width from W's K-blocks
// (warpgroup 1, as B1's filter chain runs f2); A (64, 256) row-major, wimg the
// arranged (256, 256) weight, kimg its K-block image, out (3, 64, 256) f32.
// Eight stages of each image through a ring of three.
__global__ void __launch_bounds__(wg::kThreads, 1)
tile_product_selftest_kernel(const bf16* __restrict__ A, const bf16* __restrict__ wimg,
                             const bf16* __restrict__ kimg, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kRing = 3;
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring_off = 0, tile_off = kRing * wg::kStageBytes;
  const uint32_t full = base + tile_off + wg::kTileBytes, empty = full + 8 * kRing;
  const int tid = threadIdx.x;
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (tid == 0) {
    wg::ring_init(full, empty, kRing);
    wg::mbar_init_fence();
  }
  for (int idx = tid; idx < 64 * 32; idx += wg::kThreads) {
    const int row = idx >> 5, unit = idx & 31;
    *reinterpret_cast<uint4*>(sm + tile_off + wg::img_off<2>(row, unit * 8)) =
        *reinterpret_cast<const uint4*>(A + row * kH + unit * 8);
  }
  wg::fence_async_shared();
  __syncthreads();
  if (warp_idx >= wg::kConsumers / 32) {
    wg::reg_dealloc<wg::kRegsProducer>();
    if (tid == wg::kConsumers) {
      wg::Ring ring{full, empty, base + ring_off, kRing};
      for (int c = 0; c < kStagesPerMat; ++c) ring.fill(wimg + c * kStageElems);
      for (int c = 0; c < kStagesPerMat; ++c) ring.fill(kimg + c * kStageElems);
    }
  } else {
    wg::reg_alloc<wg::kRegsConsumer>();
    wg::Ring ring{full, empty, base + ring_off, kRing};
    const int w = warp_idx >> 2, ct = tid & 127, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r_lo = ((ct >> 5) << 4) + g, r_hi = r_lo + 8;
    float* o = out + (size_t)w * 64 * kH;
    auto epi = [&](int c, float (&acc)[16]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * c + 8 * j + 2 * t;
        o[r_lo * kH + col] = acc[4 * j];
        o[r_lo * kH + col + 1] = acc[4 * j + 1];
        o[r_hi * kH + col] = acc[4 * j + 2];
        o[r_hi * kH + col + 1] = acc[4 * j + 3];
      }
    };
    if (w == 0) {
      uint32_t hold[64];
      wg::product_bf16<kStagesPerMat, false, false>(ring, true, base + tile_off, 0, wg::kAtomBytes, hold,
                                             [&](int c, float (&acc)[16], uint32_t (&)[8]) { epi(c, acc); });
      for (int c = 0; c < kStagesPerMat; ++c) {  // the K-blocks are warpgroup 1's
        ring.acquire();
        ring.release();
      }
    } else {
      // the A fragments as frag_put lays them out, from the rows in global memory
      uint32_t a[64];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 32 * c + 8 * j + 2 * t;
          wg::frag_put(a, c, j, __ldg(reinterpret_cast<const unsigned int*>(A + r_lo * kH + col)),
                       __ldg(reinterpret_cast<const unsigned int*>(A + r_hi * kH + col)));
        }
      }
      float acc[16];
#pragma unroll
      for (int c = 0; c < kStagesPerMat; ++c) {
        const uint32_t bs = ring.acquire();
        wg::wgmma_fence();
        wg::mma_stage_bf16_rs(acc, a, bs, true);
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_operand(acc);
        ring.release();
        epi(c, acc);
      }
      // the K-blocks: K-block c takes the fragments of stage c, made afresh
      float acc2[128];
#pragma unroll
      for (int c = 0; c < kStagesPerMat; ++c) {
        uint32_t frag[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 32 * c + 8 * j + 2 * t;
          frag[4 * (j >> 1) + 2 * (j & 1)] =
              __ldg(reinterpret_cast<const unsigned int*>(A + r_lo * kH + col));
          frag[4 * (j >> 1) + 2 * (j & 1) + 1] =
              __ldg(reinterpret_cast<const unsigned int*>(A + r_hi * kH + col));
        }
        const uint32_t bs = ring.acquire();
        wg::wgmma_fence();
        wg::mma_kblock_bf16_n256(acc2, frag, bs, c == 0);
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_acc128(acc2);
        ring.release();
      }
      float* o2 = out + 2 * 64 * kH;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * t;
        o2[r_lo * kH + col] = acc2[4 * j];
        o2[r_lo * kH + col + 1] = acc2[4 * j + 1];
        o2[r_hi * kH + col] = acc2[4 * j + 2];
        o2[r_hi * kH + col + 1] = acc2[4 * j + 3];
      }
    }
  }
}

template <typename T>
void fill_params(Params<T>& p, const void* const* ptrs, int& i) {
  p.d = static_cast<const float*>(ptrs[i++]);
  p.c = static_cast<const float*>(ptrs[i++]);
  p.z = static_cast<const T*>(ptrs[i++]);
  p.tr_in = static_cast<const int*>(ptrs[i++]);
  p.tp_in = static_cast<const int*>(ptrs[i++]);
  p.tr_out = static_cast<const int*>(ptrs[i++]);
  p.tp_out = static_cast<const int*>(ptrs[i++]);
  const T** w[] = {&p.table, &p.dw0, &p.db0, &p.dw1, &p.db1, &p.c0r, &p.c0p, &p.c0b, &p.c1w,
                   &p.c1b, &p.f1w, &p.f1b, &p.f2w, &p.f2b, &p.l1w, &p.l2w, &p.l2b, &p.ow,
                   &p.ob, &p.g0h, &p.g0e, &p.g0b, &p.g1w, &p.g1b, &p.g2w, &p.g2b};
  for (const T** slot : w) *slot = static_cast<const T*>(ptrs[i++]);
}

bool wg_takes(int N, int H, int is_bf16) {
  return is_bf16 && H == kH && N % 8 == 0 && graph_layout(N).stages >= 3;
}

int launch_wg(const void* const* ptrs, int M, int B, int N, int L, int V, void* stream) {
  const GraphSmem lay = graph_layout(N);
  Params<bf16> p;
  int i = 0;
  fill_params(p, ptrs, i);
  const bf16* wimg = static_cast<const bf16*>(ptrs[i++]);
  const bf16* f2k = static_cast<const bf16*>(ptrs[i++]);
  p.ea = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  p.out = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  if (i != kNumPtrs || wimg == nullptr || f2k == nullptr) return (int)cudaErrorInvalidValue;
  p.M = M; p.B = B; p.N = N; p.H = kH; p.L = L; p.V = V;
  cudaError_t e = cudaFuncSetAttribute(packed_score_wg_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  packed_score_wg_kernel<<<M * B, wg::kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(
      p, wimg, f2k);
  return (int)cudaGetLastError();
}

template <typename T, int TR>
int launch(const void* const* ptrs, int M, int B, int N, int H, int L, int V, void* stream) {
  const Smem lay = smem_layout<T, TR>(N, H);
  if (lay.np > TR || lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params<T> p;
  int i = 0;
  fill_params(p, ptrs, i);
  i += 2;  // the arranged weight images: the warp-specialised kernel's
  p.ea = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  p.out = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  if (i != kNumPtrs) return (int)cudaErrorInvalidValue;
  p.M = M; p.B = B; p.N = N; p.H = H; p.L = L; p.V = V;
  cudaError_t e = cudaFuncSetAttribute(packed_score_kernel<T, TR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  packed_score_kernel<T, TR>
      <<<M * B, kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

WG_PROFILE_ENTRY(packed_score_profile)

extern "C" {

// Launches the score kernel on `stream`; returns the cudaError_t of the launch.
// ptrs: d, cmask, z, tr_in, tp_in, tr_out, tp_out, the 26 weights in the
// order of Params, the arranged weight image and f2w's K-block image (both may
// be null where packed_score_uses_wg says 0), the ea scratch and the output.  bf16 at H = 256
// takes the warp-specialised kernel whenever its shared memory fits (N <= 24);
// every other shape, and float32, takes the mma.sync kernel.
int packed_score_launch(const void* const* ptrs, int M, int B, int N, int H, int L, int V,
                        int is_bf16, void* stream) {
  if (N <= 0 || N % 8 != 0 || H % 64 != 0 || L < 0 || M <= 0 || B <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  if (wg_takes(N, H, is_bf16)) return launch_wg(ptrs, M, B, N, L, V, stream);
  if (is_bf16) return launch<__nv_bfloat16, 64>(ptrs, M, B, N, H, L, V, stream);
  return launch<float, 32>(ptrs, M, B, N, H, L, V, stream);
}

// 1 where packed_score_launch takes the warp-specialised kernel.  Its ea
// scratch is ceil(R / 64) tile images of 32 KB per (member, graph).
int packed_score_uses_wg(int N, int H, int is_bf16) { return wg_takes(N, H, is_bf16) ? 1 : 0; }

// out (3, 64, 256) f32 = A (64, 256) bf16 times the (256, 256) bf16 weight,
// transposed: through the ring, from the arranged image with A from shared
// memory and from registers, and from the K-block image full width.
int packed_score_tile_selftest(const void* A, const void* wimg, const void* kimg, void* out,
                               void* stream) {
  const int smem = 3 * wg::kStageBytes + wg::kTileBytes + 128 + 1024;
  cudaError_t e = cudaFuncSetAttribute(tile_product_selftest_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tile_product_selftest_kernel<<<1, wg::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(wimg), static_cast<const bf16*>(kimg),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* packed_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
