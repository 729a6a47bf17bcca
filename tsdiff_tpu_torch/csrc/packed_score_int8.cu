// Offset-packed fused score step with int8 pair-row products, for Hopper.
//
// Replaces the TPU kernel tsdiff_tpu/ops/pallas/condensed_score_packed_int8.py::
// packed_score_pallas_int8 (kernel _score_kernel_int8): the program of
// packed_score.cu on the same packed pair rows p = (k-1)*N + i, for all M
// members in one launch, with every pair-row matrix product done in int8:
//
//   * weights dw1, c0r, c0p, c1w, g0h, g0e, g1w and the bond table come in as
//     symmetric per-tensor int8 codes with one f32 scale each, f1w and f2w
//     with one scale per layer (quantized by the caller from the f32
//     parameters);
//   * the activation of every such product is quantized per row right before
//     it, from its value in the working type T: s = max(max|x|, 1e-12) / 127,
//     q = rint(x / s) (ties to even, a true division); ea, which feeds all L
//     blocks, is quantized once;
//   * the int32 sum is scaled by (s_row * s_w), that product taken first, then
//     the bias is added in f32 and the result rounded to T;
//   * a bond embedding is a row of the int8 table times the table's scale;
//   * the 1->H first layer, the node products l1w, l2w, ow, the aggregation, h
//     and the last head layer g2w stay in T, as in packed_score.cu.
//
// Bound at the main path's shapes (M=8, B=100, N=24, H=F=256, L=7, bf16):
// 7.1e11 int8 operations in the pair-row products, 0.36 ms at 1979 TOP/s,
// plus 5.3e10 flop of node products and the last head layer in bf16, 0.05 ms
// at 989 TFLOP/s; the inputs and outputs are ~35 MB (10 us at 3.35 TB/s).
// Bound by the tensor cores; but beside them every row element passes ~12.5
// activations and ~10 quantizations (a row maximum, a division, a rounding),
// and that work, on the CUDA cores, is what the kernels' time is made of.
//
// Two kernels, as in packed_score.cu: one CTA per (member, graph), h, xh and
// the f32 aggregation in shared memory, ea as codes and row scales in a
// global scratch (half the bytes of packed_score.cu's).
//
// packed_score_int8_kernel (float32, and bf16 at widths or N the other does
// not take): the first port.  mma.sync.m16n8k32 on tiles quantized in shared
// memory by a pass of its own between two products (one warp a row), weights
// from L2 once per 64-row tile: 15.2 ms at the shapes above.
//
// packed_score_int8_wg_kernel (bf16, H = 256, N <= 24; csrc/wg_pipeline.cuh):
// packed_score_wg_kernel's program (producer warp, ring of 16 KB weight
// stages filled by bulk copies, two consumer warpgroups on one 64-row tile
// each, the same aggregation and node update) with
//   * wgmma.mma_async m64n32k32 s8 x s8 -> s32 for every pair-row product, an
//     int8 stage being 64 output columns (two 32-column halves); the node
//     products stay bf16 wgmma through the same ring;
//   * the quantization in the producing product's epilogue: the epilogue
//     leaves its results, in the working type, in the warpgroup's bf16 tile
//     on the fragment's own positions, and the same thread, with no barrier
//     and no pass of the CTA in between, takes the maxima of its two rows
//     (its own 64 values and two quad shuffles), divides, and writes the
//     codes into the s8 tile image the next wgmma reads.  The row scales stay
//     in registers (in the scratch for ea).  The arithmetic is the plain
//     version's bit for bit; x / s is taken as x * (1/s) where that cannot
//     change the rounded code and as a true division next to a tie;
//   * two-operand products (c0r/c0p, g0h/g0e): two row scales, so two s32
//     accumulator sets, dequantized apart and then added.
// Kept in registers until the product had ended (as packed_score.cu keeps
// what it cannot store yet) the results went to local memory, and with 256
// KB of it a CTA that is L2: quantizing from there took 37 % of the kernel
// (14.0 ms).  Through the shared-memory tile, the quantization one function:
// 8.4 ms at N=24, 3.9 at N=16 on an H100 at 700 W (15.2 and 7.4 before); the
// quantization is still a third of it (ops/wg_profile.py).

#include "graph_block.cuh"
#include "wg_pipeline.cuh"

namespace {

using tile::from_f;
using tile::gemm8;
using tile::kThreads;
using tile::quantize_rows;
using tile::rnd;
using tile::silu_f;
using tile::ssp_f;
using tile::to_f;

constexpr int kNumPtrs = 41;
constexpr size_t kMaxSmem = 232448;
// order of the per-tensor scales in Params::scales
enum Scale { kDw1, kC0r, kC0p, kC1w, kG0h, kG0e, kG1w, kTable, kNumScales };

template <typename T>
struct Params {
  const float* d;     // (B, R) packed distances
  const float* c;     // (B, R) cutoff mask with the 0.5 last-slab factor
  const T* z;         // (M, B, N, H) node states
  const int* tr_in;   // (B, R) bond types, encoder order
  const int* tp_in;
  const int* tr_out;  // (B, R) bond types, output order
  const int* tp_out;
  const float* scales;  // (M, kNumScales)
  const float* f1s;     // (M, L)
  const float* f2s;
  // weights, each stacked (M, ...); matrices in (out, in) layout
  const int8_t* table;  // (V, H)
  const T* dw0;         // (H)
  const T* db0;
  const int8_t* dw1;    // (H, H)
  const T* db1;
  const int8_t* c0r;    // (H, H)
  const int8_t* c0p;
  const T* c0b;
  const int8_t* c1w;
  const T* c1b;
  const int8_t* f1w;    // (L, H, H)
  const T* f1b;         // (L, H)
  const int8_t* f2w;
  const T* f2b;
  const T* l1w;
  const T* l2w;
  const T* l2b;
  const T* ow;
  const T* ob;
  const int8_t* g0h;    // (H, H)
  const int8_t* g0e;
  const T* g0b;
  const int8_t* g1w;    // (H/2, H)
  const T* g1b;
  const T* g2w;         // (H/2)
  const T* g2b;         // (1)
  int8_t* ea_q;         // (M*B, R, H) scratch: quantized ea
  float* ea_s;          // (M*B, R) scratch: its row scales
  float* out;           // (M, B, R)
  int M, B, N, H, L, V;
};

// Shared-memory carve-up, shared by the kernel and the host-side size check.
struct Smem {
  size_t buf, qbuf, node, agg, rows, total;
  int lda, ldq, np;
};

template <typename T, int TR>
__host__ __device__ inline Smem smem_layout(int N, int H) {
  Smem s;
  s.lda = H + 16 / (int)sizeof(T);  // +16 bytes per row: conflict-free fragment loads
  s.ldq = H + 16;
  s.np = (N + 15) / 16 * 16;
  s.buf = (size_t)TR * s.lda * sizeof(T);
  s.qbuf = (size_t)TR * s.ldq;
  s.node = (size_t)s.np * s.lda * sizeof(T);
  s.agg = (size_t)N * H * sizeof(float);
  s.rows = (size_t)TR * 6 * sizeof(float);
  s.total = 3 * s.buf + 2 * s.qbuf + 2 * s.node + s.agg + s.rows;
  return s;
}

template <typename T, int TR>
__global__ void __launch_bounds__(kThreads, 1) packed_score_int8_kernel(Params<T> p) {
  constexpr int MF = TR / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, H = p.H, L = p.L, B = p.B;
  const int K = N / 2, R = K * N, Hh = H / 2;
  const Smem lay = smem_layout<T, TR>(N, H);
  const int lda = lay.lda, ldq = lay.ldq, NP = lay.np;

  unsigned char* sp = smem;
  T* bufA = reinterpret_cast<T*>(sp);
  T* bufB = reinterpret_cast<T*>(sp + lay.buf);
  T* bufC = reinterpret_cast<T*>(sp + 2 * lay.buf);
  sp += 3 * lay.buf;
  int8_t* q1 = reinterpret_cast<int8_t*>(sp);
  int8_t* q2 = reinterpret_cast<int8_t*>(sp + lay.qbuf);
  sp += 2 * lay.qbuf;
  T* h_s = reinterpret_cast<T*>(sp);
  T* xh_s = reinterpret_cast<T*>(sp + lay.node);
  sp += 2 * lay.node;
  float* agg = reinterpret_cast<float*>(sp);
  sp += lay.agg;
  float* d_s = reinterpret_cast<float*>(sp);
  float* c_s = d_s + TR;
  float* s1 = c_s + TR;
  float* s2 = s1 + TR;
  int* ta_s = reinterpret_cast<int*>(s2 + TR);
  int* tb_s = ta_s + TR;

  const int mb = blockIdx.x;  // member-major: CTAs in flight share a member's weights
  const int m = mb / B, b = mb % B;
  const int tid = threadIdx.x;

  const size_t HH = (size_t)H * H;
  const float* sc = p.scales + (size_t)m * kNumScales;
  const float s_dw1 = sc[kDw1], s_c0r = sc[kC0r], s_c0p = sc[kC0p], s_c1w = sc[kC1w];
  const float s_g0h = sc[kG0h], s_g0e = sc[kG0e], s_g1w = sc[kG1w], s_table = sc[kTable];
  const float* f1s = p.f1s + (size_t)m * L;
  const float* f2s = p.f2s + (size_t)m * L;
  const int8_t* table = p.table + (size_t)m * p.V * H;
  const T* dw0 = p.dw0 + (size_t)m * H;
  const T* db0 = p.db0 + (size_t)m * H;
  const int8_t* dw1 = p.dw1 + m * HH;
  const T* db1 = p.db1 + (size_t)m * H;
  const int8_t* c0r = p.c0r + m * HH;
  const int8_t* c0p = p.c0p + m * HH;
  const T* c0b = p.c0b + (size_t)m * H;
  const int8_t* c1w = p.c1w + m * HH;
  const T* c1b = p.c1b + (size_t)m * H;
  const int8_t* f1w = p.f1w + m * L * HH;
  const T* f1b = p.f1b + (size_t)m * L * H;
  const int8_t* f2w = p.f2w + m * L * HH;
  const T* f2b = p.f2b + (size_t)m * L * H;
  // the node products' weights; the pair filter's are int8 and handled here
  const blk::BlockWeights<T> stack = {
      nullptr, nullptr, nullptr, nullptr, p.l1w + m * L * HH, p.l2w + m * L * HH,
      p.l2b + (size_t)m * L * H, p.ow + m * L * HH, p.ob + (size_t)m * L * H};
  const int8_t* g0h = p.g0h + m * HH;
  const int8_t* g0e = p.g0e + m * HH;
  const T* g0b = p.g0b + (size_t)m * H;
  const int8_t* g1w = p.g1w + m * (HH / 2);
  const T* g1b = p.g1b + (size_t)m * Hh;
  const T* g2w = p.g2w + (size_t)m * Hh;
  const float g2b = to_f(p.g2b[m]);

  const float* d_g = p.d + (size_t)b * R;
  const float* c_g = p.c + (size_t)b * R;
  int8_t* eaq_g = p.ea_q + (size_t)mb * R * H;
  float* eas_g = p.ea_s + (size_t)mb * R;

  blk::load_nodes(h_s, lda, p.z + (size_t)mb * N * H, N, NP, H);

  auto load_rows = [&](int r0, int nr, const int* ta, const int* tb) {
    for (int r = tid; r < nr; r += kThreads) {
      d_s[r] = rnd<T>(d_g[r0 + r]);
      ta_s[r] = ta[(size_t)b * R + r0 + r];
      tb_s[r] = tb[(size_t)b * R + r0 + r];
    }
    __syncthreads();
  };

  // edge_cat of one row tile (d_s, ta_s, tb_s loaded) into bufA
  auto edge_cat = [&](int nr) {
    for (int idx = tid; idx < nr * H; idx += kThreads) {
      const int r = idx / H, col = idx % H;
      float x = rnd<T>(d_s[r] * to_f(dw0[col]));
      x = rnd<T>(x + to_f(db0[col]));
      bufA[r * lda + col] = from_f<T>(silu_f(x));
    }
    __syncthreads();
    quantize_rows(bufA, lda, q1, ldq, s1, nr, H);
    gemm8<MF>(q1, s1, dw1, s_dw1, nullptr, nullptr, nullptr, 0.0f, ldq, nr, H, H,
              [&](int r, int col, float v) {
                bufB[r * lda + col] = from_f<T>(v + to_f(db1[col]));
              });
    for (int idx = tid; idx < nr * H; idx += kThreads) {
      const int r = idx / H, col = idx % H;
      const float de = to_f(bufB[r * lda + col]);
      const float er = rnd<T>((float)table[(size_t)ta_s[r] * H + col] * s_table);
      const float ep = rnd<T>((float)table[(size_t)tb_s[r] * H + col] * s_table);
      bufA[r * lda + col] = from_f<T>(de * er);
      bufC[r * lda + col] = from_f<T>(de * ep);
    }
    __syncthreads();
    quantize_rows(bufA, lda, q1, ldq, s1, nr, H);
    quantize_rows(bufC, lda, q2, ldq, s2, nr, H);
    gemm8<MF>(q1, s1, c0r, s_c0r, q2, s2, c0p, s_c0p, ldq, nr, H, H,
              [&](int r, int col, float v) {
                bufB[r * lda + col] = from_f<T>(silu_f(rnd<T>(v + to_f(c0b[col]))));
              });
    quantize_rows(bufB, lda, q1, ldq, s1, nr, H);
    gemm8<MF>(q1, s1, c1w, s_c1w, nullptr, nullptr, nullptr, 0.0f, ldq, nr, H, H,
              [&](int r, int col, float v) {
                bufA[r * lda + col] = from_f<T>(v + to_f(c1b[col]));
              });
  };

  // 1. encoder-order edge features of every row, quantized once, into the
  //    global scratch
  for (int r0 = 0; r0 < R; r0 += TR) {
    const int nr = min(TR, R - r0);
    load_rows(r0, nr, p.tr_in, p.tp_in);
    edge_cat(nr);
    quantize_rows(bufA, lda, eaq_g + (size_t)r0 * H, (size_t)H, eas_g + r0, nr, H);
  }

  // 2. interaction blocks
  for (int l = 0; l < L; ++l) {
    const size_t wo = (size_t)l * HH, bo = (size_t)l * H;
    const blk::BlockWeights<T> w = stack.at(l, H);
    const float s_f1 = f1s[l], s_f2 = f2s[l];
    blk::node_lin1<T, MF>(h_s, w.l1w, xh_s, agg, lda, NP, N, H);
    for (int r0 = 0; r0 < R; r0 += TR) {
      const int nr = min(TR, R - r0);
      for (int r = tid; r < nr; r += kThreads) {
        c_s[r] = rnd<T>(c_g[r0 + r]);
        s1[r] = eas_g[r0 + r];
      }
      for (int idx = tid; idx < nr * H / 16; idx += kThreads) {
        const int r = idx / (H / 16), cv = idx % (H / 16);
        *reinterpret_cast<uint4*>(q1 + r * ldq + cv * 16) =
            *reinterpret_cast<const uint4*>(eaq_g + (size_t)(r0 + r) * H + cv * 16);
      }
      __syncthreads();
      gemm8<MF>(q1, s1, f1w + wo, s_f1, nullptr, nullptr, nullptr, 0.0f, ldq, nr, H, H,
                [&](int r, int col, float v) {
                  bufB[r * lda + col] = from_f<T>(ssp_f(rnd<T>(v + to_f(f1b[bo + col]))));
                });
      quantize_rows(bufB, lda, q2, ldq, s2, nr, H);
      gemm8<MF>(q2, s2, f2w + wo, s_f2, nullptr, nullptr, nullptr, 0.0f, ldq, nr, H, H,
                [&](int r, int col, float v) {
                  bufA[r * lda + col] = from_f<T>(rnd<T>(v + to_f(f2b[bo + col])) * c_s[r]);
                });
      blk::aggregate_packed(agg, bufA, xh_s, lda, r0, nr, N, H);
      __syncthreads();
    }
    blk::node_update<T, MF>(agg, bufA, xh_s, h_s, w, lda, NP, N, H);
  }

  // 3. head on [h_i * h_j, ea_out] with the output-order edge features
  float* out = p.out + (size_t)mb * R;
  for (int r0 = 0; r0 < R; r0 += TR) {
    const int nr = min(TR, R - r0);
    load_rows(r0, nr, p.tr_out, p.tp_out);
    edge_cat(nr);
    for (int idx = tid; idx < nr * H; idx += kThreads) {
      const int r = idx / H, col = idx % H;
      const int pr = r0 + r, k = pr / N + 1, i = pr - (k - 1) * N;
      const int j = i + k < N ? i + k : i + k - N;
      bufC[r * lda + col] = from_f<T>(to_f(h_s[i * lda + col]) * to_f(h_s[j * lda + col]));
    }
    __syncthreads();
    quantize_rows(bufC, lda, q1, ldq, s1, nr, H);
    quantize_rows(bufA, lda, q2, ldq, s2, nr, H);
    gemm8<MF>(q1, s1, g0h, s_g0h, q2, s2, g0e, s_g0e, ldq, nr, H, H,
              [&](int r, int col, float v) {
                bufB[r * lda + col] = from_f<T>(silu_f(rnd<T>(v + to_f(g0b[col]))));
              });
    quantize_rows(bufB, lda, q1, ldq, s1, nr, H);
    gemm8<MF>(q1, s1, g1w, s_g1w, nullptr, nullptr, nullptr, 0.0f, ldq, nr, H, Hh,
              [&](int r, int col, float v) {
                bufA[r * lda + col] = from_f<T>(silu_f(rnd<T>(v + to_f(g1b[col]))));
              });
    blk::head_dot(bufA, lda, g2w, g2b, out + r0, nr, Hh);
  }
}

// ---------------------------------------------------------------------------
// The warp-specialised kernel (bf16 working type, H = 256, N <= 24).

using wgb::act_silu;
using wgb::act_ssp;
using wgb::bf16;
using wgb::kH;
using wgb::kHH;
using wgb::kStageElems;
using wgb::ld2;
using wgb::rb;
using wgb::st_shared32;
using wgb::GraphSmem;
using wgb::graph_layout;

constexpr int kCodeTile = wg::kTileBytes / 2;  // a 64-row tile of codes: 16 KB
constexpr int kCodeStages = kH / 64;           // ring stages of an int8 (H, H) matrix

// Offsets of the matrices in a member's two arranged images: the int8 one
// (pair-row products; units of kHH bytes) and the working-type one (node
// products; units of kHH elements).  ops/packed_score_int8.py::
// arrange_weights_int8 writes this order.
struct WImage8 {
  int L;
  __host__ __device__ int dw1() const { return 0; }
  __host__ __device__ int c0r() const { return 1; }
  __host__ __device__ int c0p() const { return 2; }
  __host__ __device__ int c1w() const { return 3; }
  __host__ __device__ int f1w(int l) const { return 4 + l; }
  __host__ __device__ int f2w(int l) const { return 4 + L + l; }
  __host__ __device__ int g0h() const { return 4 + 2 * L; }
  __host__ __device__ int g0e() const { return 5 + 2 * L; }
  __host__ __device__ int g1w() const { return 6 + 2 * L; }  // half a unit
  __host__ __device__ size_t bytes() const { return (size_t)(13 + 4 * L) * (kHH / 2); }
  __host__ __device__ int l1w(int l) const { return l; }
  __host__ __device__ int l2w(int l) const { return L + l; }
  __host__ __device__ int ow(int l) const { return 2 * L + l; }
  __host__ __device__ size_t node_elems() const { return (size_t)3 * L * kHH; }
};

// two packed results (row g, row g+8) of group j in half c into the bf16 tile at off
__device__ __forceinline__ void st_pair(unsigned char* sm, uint32_t off, int r_lo, int col,
                                        uint32_t lo, uint32_t hi) {
  st_shared32(sm, off + wg::img_off<2>(r_lo, col), lo);
  st_shared32(sm, off + wg::img_off<2>(r_lo + 8, col), hi);
}

// a bond embedding pair: two codes of the int8 table times its scale, rounded
__device__ __forceinline__ float2 emb2(const int8_t* row, int col, float s_table) {
  const unsigned short v = __ldg(reinterpret_cast<const unsigned short*>(row + col));
  return make_float2(rb((float)(int8_t)(v & 0xff) * s_table), rb((float)(int8_t)(v >> 8) * s_table));
}

__global__ void __launch_bounds__(wg::kThreads, 1)
packed_score_int8_wg_kernel(Params<bf16> p, const int8_t* __restrict__ wimg8_all,
                            const bf16* __restrict__ wimg_all) {
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
  // warp-uniform, and known to the compiler as such (see packed_score.cu)
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const WImage8 wi = {L};
  const int8_t* wimg8 = wimg8_all + (size_t)m * wi.bytes();
  const bf16* wimg = wimg_all + (size_t)m * wi.node_elems();
  int8_t* eaq_g = p.ea_q + (size_t)mb * ntiles * kCodeTile;  // tile images of codes, 16 KB each
  float* eas_g = p.ea_s + (size_t)mb * ntiles * 64;          // their row scales

  wgb::cta_setup(sm, base, lay, p.z + (size_t)mb * N * kH, N);

  if (warp_idx >= wg::kConsumers / 32) {
    // ===== producer: the static schedule of weight stages and ea tiles =====
    wg::reg_dealloc<wg::kRegsProducer>();
    if (tid == wg::kConsumers) {
      wg::Ring ring{full, empty, base + lay.ring, lay.stages};
      auto mat8 = [&](int unit) { return wimg8 + (size_t)unit * kHH; };
      auto mat = [&](int unit) { return wimg + (size_t)unit * kHH; };
      auto fill8 = [&](const int8_t* w, int stages = kCodeStages) {
        for (int c = 0; c < stages; ++c) ring.fill(w + c * wg::kStageBytes);
      };
      auto fill8_pairs = [&](const int8_t* w0, const int8_t* w1) {
        for (int c = 0; c < kCodeStages; ++c) {
          ring.fill(w0 + c * wg::kStageBytes);
          ring.fill(w1 + c * wg::kStageBytes);
        }
      };
      auto fill_node = [&](const bf16* w) {
        for (int c = 0; c < wgb::kStagesPerMat; ++c) ring.fill(w + c * kStageElems);
      };
      auto edge_cat = [&]() {
        fill8(mat8(wi.dw1()));
        fill8_pairs(mat8(wi.c0r()), mat8(wi.c0p()));
        fill8(mat8(wi.c1w()));
      };
      for (int tp = 0; tp < npairs; ++tp) edge_cat();
      uint32_t aphase = 0;  // bit w: the parity warpgroup w's code tile is waited on
      for (int l = 0; l < L; ++l) {
        fill_node(mat(wi.l1w(l)));
        for (int tp = 0; tp < npairs; ++tp) {
          for (int w = 0; w < 2; ++w) {
            const int ti = 2 * tp + w;
            if (ti >= ntiles) continue;
            wg::mbar_wait(aempty + 8 * w, (aphase >> w) & 1);
            aphase ^= 1u << w;
            wg::mbar_expect_tx(afull + 8 * w, kCodeTile);
            wg::bulk_load(base + lay.tiles + 2 * w * wg::kTileBytes,
                          eaq_g + (size_t)ti * kCodeTile, kCodeTile, afull + 8 * w);
          }
          fill8(mat8(wi.f1w(l)));
          fill8(mat8(wi.f2w(l)));
        }
        fill_node(mat(wi.l2w(l)));
        fill_node(mat(wi.ow(l)));
      }
      for (int tp = 0; tp < npairs; ++tp) {
        edge_cat();
        fill8_pairs(mat8(wi.g0h()), mat8(wi.g0e()));
        fill8(mat8(wi.g1w()), kCodeStages / 2);
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
    // the warpgroup's 64 KB: two tiles of codes Q0 and Q1, and the bf16 tile B
    // (where epilogues leave their results, the w tile of the aggregation, the
    // node update's operands)
    const uint32_t q0_off = lay.tiles + 2 * w * wg::kTileBytes, q1_off = q0_off + kCodeTile;
    const uint32_t tb_off = q0_off + 2 * kCodeTile;
    const uint32_t q0 = base + q0_off, q1 = base + q1_off;
    // after generic stores into a tile: visible to wgmma, in every warp
    auto publish = [&]() {
      wg::fence_async_shared();
      wg::bar_sync(bar_wg, 128);
    };

    const float* sc = p.scales + (size_t)m * kNumScales;
    const float s_dw1 = sc[kDw1], s_c0r = sc[kC0r], s_c0p = sc[kC0p], s_c1w = sc[kC1w];
    const float s_g0h = sc[kG0h], s_g0e = sc[kG0e], s_g1w = sc[kG1w], s_table = sc[kTable];
    const int8_t* table = p.table + (size_t)m * p.V * kH;
    const float* d_g = p.d + (size_t)b * R;
    const float* c_g = p.c + (size_t)b * R;

    // edge_cat of this warpgroup's tile ti: the codes of ea into Q1, its row
    // scales into se_lo, se_hi.  An epilogue leaves its results, in the working
    // type, in tile B on the fragment's positions; the same thread then takes
    // its rows' maxima and writes the codes of the next product's operand: no
    // separate pass of the CTA over the tile, no barrier before it.  Between
    // two products of the chain there is one barrier of the warpgroup.
    auto edge_cat = [&](int ti, const int* ta_g, const int* tb_g, float& se_lo, float& se_hi) {
      const bf16* dw0 = p.dw0 + (size_t)m * kH;
      const bf16* db0 = p.db0 + (size_t)m * kH;
      const bf16* db1 = p.db1 + (size_t)m * kH;
      const bf16* c0b = p.c0b + (size_t)m * kH;
      const bf16* c1b = p.c1b + (size_t)m * kH;
      const int r0 = ti * 64, nr = min(64, R - r0);
      const bool active = nr > 0;
      float sa_lo = 0.0f, sa_hi = 0.0f;
      int ta_lo = 0, ta_hi = 0, tb_lo = 0, tb_hi = 0;
      if (active) {
        float d_lo = 0.0f, d_hi = 0.0f;
        if (r_lo < nr) {
          d_lo = rb(d_g[r0 + r_lo]);
          ta_lo = ta_g[(size_t)b * R + r0 + r_lo];
          tb_lo = tb_g[(size_t)b * R + r0 + r_lo];
        }
        if (r_hi < nr) {
          d_hi = rb(d_g[r0 + r_hi]);
          ta_hi = ta_g[(size_t)b * R + r0 + r_hi];
          tb_hi = tb_g[(size_t)b * R + r0 + r_hi];
        }
        // the first layer silu(rnd(rnd(d w0) + b0)) on the fragment's positions
        WG_T_BEGIN(t_first);
#pragma unroll 1
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * c + 8 * j + 2 * t;
            const float2 w0 = ld2(dw0, col), b0 = ld2(db0, col);
            st_pair(sm, tb_off, r_lo, col,
                    wg::pack_bf16(act_silu(rb(rb(d_lo * w0.x) + b0.x)),
                                  act_silu(rb(rb(d_lo * w0.y) + b0.y))),
                    wg::pack_bf16(act_silu(rb(rb(d_hi * w0.x) + b0.x)),
                                  act_silu(rb(rb(d_hi * w0.y) + b0.y))));
          }
        }
        WG_T_END(wg::kProfFirstLayer, t_first);
        WG_T(wg::kProfQuantize, wgb::quantize_tile(sm, tb_off, q0_off, r_lo, t, sa_lo, sa_hi));
      }
      publish();
      // de = rnd(a0 dw1 + db1)
      wg::product_s8<kCodeStages, false>(
          ring, active, q0, 0, sa_lo * s_dw1, sa_hi * s_dw1, 0.0f, 0.0f,
          [&](int c, float (&v)[16]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 32 * c + 8 * j + 2 * t;
              const float2 bias = ld2(db1, col);
              st_pair(sm, tb_off, r_lo, col, wg::pack_bf16(v[4 * j] + bias.x, v[4 * j + 1] + bias.y),
                      wg::pack_bf16(v[4 * j + 2] + bias.x, v[4 * j + 3] + bias.y));
            }
          });
      float sr_lo = 0.0f, sr_hi = 0.0f, sp_lo = 0.0f, sp_hi = 0.0f;
      wg::bar_sync(bar_wg, 128);  // every warp's dw1 has read Q0: it takes de*ep
      if (active) {
        // de*er into Q1, de*ep into Q0: the rows' maxima first, then the codes
        const int8_t* er_lo = table + (size_t)ta_lo * kH;
        const int8_t* er_hi = table + (size_t)ta_hi * kH;
        const int8_t* ep_lo = table + (size_t)tb_lo * kH;
        const int8_t* ep_hi = table + (size_t)tb_hi * kH;
        auto mul = [](float2 a, float2 e) { return make_float2(rb(a.x * e.x), rb(a.y * e.y)); };
        auto amax = [](float m, float2 x) { return fmaxf(m, fmaxf(fabsf(x.x), fabsf(x.y))); };
#pragma unroll 1
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * c + 8 * j + 2 * t;
            const float2 lo = wg::unpack_bf16(wgb::ld_shared32(sm, tb_off + wg::img_off<2>(r_lo, col)));
            const float2 hi = wg::unpack_bf16(wgb::ld_shared32(sm, tb_off + wg::img_off<2>(r_hi, col)));
            sr_lo = amax(sr_lo, mul(lo, emb2(er_lo, col, s_table)));
            sr_hi = amax(sr_hi, mul(hi, emb2(er_hi, col, s_table)));
            sp_lo = amax(sp_lo, mul(lo, emb2(ep_lo, col, s_table)));
            sp_hi = amax(sp_hi, mul(hi, emb2(ep_hi, col, s_table)));
          }
        }
        sr_lo = wgb::row_scale(wgb::quad_max(sr_lo));
        sr_hi = wgb::row_scale(wgb::quad_max(sr_hi));
        sp_lo = wgb::row_scale(wgb::quad_max(sp_lo));
        sp_hi = wgb::row_scale(wgb::quad_max(sp_hi));
        const float ir_lo = wgb::scale_inv(sr_lo), ir_hi = wgb::scale_inv(sr_hi);
        const float ip_lo = wgb::scale_inv(sp_lo), ip_hi = wgb::scale_inv(sp_hi);
#pragma unroll 1
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * c + 8 * j + 2 * t;
            const float2 lo = wg::unpack_bf16(wgb::ld_shared32(sm, tb_off + wg::img_off<2>(r_lo, col)));
            const float2 hi = wg::unpack_bf16(wgb::ld_shared32(sm, tb_off + wg::img_off<2>(r_hi, col)));
            const uint32_t o_lo = wg::img_off<1>(r_lo, col), o_hi = wg::img_off<1>(r_hi, col);
            wgb::st_shared16(sm, q1_off + o_lo, wgb::code2(mul(lo, emb2(er_lo, col, s_table)), sr_lo, ir_lo));
            wgb::st_shared16(sm, q1_off + o_hi, wgb::code2(mul(hi, emb2(er_hi, col, s_table)), sr_hi, ir_hi));
            wgb::st_shared16(sm, q0_off + o_lo, wgb::code2(mul(lo, emb2(ep_lo, col, s_table)), sp_lo, ip_lo));
            wgb::st_shared16(sm, q0_off + o_hi, wgb::code2(mul(hi, emb2(ep_hi, col, s_table)), sp_hi, ip_hi));
          }
        }
      }
      publish();
      // v = silu(rnd((de*er) c0r + (de*ep) c0p + c0b))
      wg::product_s8<kCodeStages, true>(
          ring, active, q1, q0, sr_lo * s_c0r, sr_hi * s_c0r, sp_lo * s_c0p, sp_hi * s_c0p,
          [&](int c, float (&v)[16]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 32 * c + 8 * j + 2 * t;
              const float2 bias = ld2(c0b, col);
              st_pair(sm, tb_off, r_lo, col,
                      wg::pack_bf16(act_silu(rb(v[4 * j] + bias.x)), act_silu(rb(v[4 * j + 1] + bias.y))),
                      wg::pack_bf16(act_silu(rb(v[4 * j + 2] + bias.x)),
                                    act_silu(rb(v[4 * j + 3] + bias.y))));
            }
          });
      float sv_lo = 0.0f, sv_hi = 0.0f;
      wg::bar_sync(bar_wg, 128);  // every warp's c0 has read Q0
      if (active) WG_T(wg::kProfQuantize, wgb::quantize_tile(sm, tb_off, q0_off, r_lo, t, sv_lo, sv_hi));
      publish();
      // ea = rnd(v c1w + c1b), quantized once for all its readers
      wg::product_s8<kCodeStages, false>(
          ring, active, q0, 0, sv_lo * s_c1w, sv_hi * s_c1w, 0.0f, 0.0f,
          [&](int c, float (&v)[16]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 32 * c + 8 * j + 2 * t;
              const float2 bias = ld2(c1b, col);
              st_pair(sm, tb_off, r_lo, col, wg::pack_bf16(v[4 * j] + bias.x, v[4 * j + 1] + bias.y),
                      wg::pack_bf16(v[4 * j + 2] + bias.x, v[4 * j + 3] + bias.y));
            }
          });
      se_lo = se_hi = 0.0f;
      if (active) WG_T(wg::kProfQuantize, wgb::quantize_tile(sm, tb_off, q1_off, r_lo, t, se_lo, se_hi));
      publish();
    };

    // 1. encoder-order edge features of every row, as codes and row scales,
    //    into the global scratch (half the bytes of packed_score.cu's)
    for (int tp = 0; tp < npairs; ++tp) {
      const int ti = 2 * tp + w;
      if (elected) wg::bulk_store_wait_read();  // the last tile's store has read Q1
      wg::bar_sync(bar_wg, 128);
      float se_lo, se_hi;
      edge_cat(ti, p.tr_in, p.tp_in, se_lo, se_hi);
      if (ti < ntiles) {
        if (elected) wg::bulk_store(eaq_g + (size_t)ti * kCodeTile, q1, kCodeTile);
        if (t == 0) {
          eas_g[ti * 64 + r_lo] = se_lo;
          eas_g[ti * 64 + r_hi] = se_hi;
        }
      }
    }
    if (elected) {
      wg::bulk_store_wait();
      wg::fence_async_all();
      wg::mbar_arrive(aempty + 8 * w);  // Q0 takes the first tile of codes
    }

    // 2. interaction blocks
    uint32_t afp = 0;
    for (int l = 0; l < L; ++l) {
      const bf16* f1b = p.f1b + ((size_t)m * L + l) * kH;
      const bf16* f2b = p.f2b + ((size_t)m * L + l) * kH;
      const bf16* l2b = p.l2b + ((size_t)m * L + l) * kH;
      const bf16* ob = p.ob + ((size_t)m * L + l) * kH;
      const float s_f1 = p.f1s[(size_t)m * L + l], s_f2 = p.f2s[(size_t)m * L + l];
      WG_T(wg::kProfNodeProducts,
           wgb::block_begin(ring, sm, base, lay, agg, w, tid, r_lo, t, N));

      for (int tp = 0; tp < npairs; ++tp) {
        const int ti = 2 * tp + w, r0 = ti * 64, nr = min(64, R - r0);
        const bool active = nr > 0;
        float c_lo = 0.0f, c_hi = 0.0f, se_lo = 0.0f, se_hi = 0.0f;
        if (active) {
          if (r_lo < nr) c_lo = rb(c_g[r0 + r_lo]);
          if (r_hi < nr) c_hi = rb(c_g[r0 + r_hi]);
          se_lo = eas_g[ti * 64 + r_lo];
          se_hi = eas_g[ti * 64 + r_hi];
          WG_T(wg::kProfTileWait, wg::mbar_wait(afull + 8 * w, afp));
          afp ^= 1;
        }
        // f = ssp(rnd(ea f1w + f1b)) into tile B, its codes into Q1
        wg::product_s8<kCodeStages, false>(
            ring, active, q0, 0, se_lo * s_f1, se_hi * s_f1, 0.0f, 0.0f,
            [&](int c, float (&v)[16]) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int col = 32 * c + 8 * j + 2 * t;
                const float2 bias = ld2(f1b, col);
                st_pair(sm, tb_off, r_lo, col,
                        wg::pack_bf16(act_ssp(rb(v[4 * j] + bias.x)), act_ssp(rb(v[4 * j + 1] + bias.y))),
                        wg::pack_bf16(act_ssp(rb(v[4 * j + 2] + bias.x)),
                                      act_ssp(rb(v[4 * j + 3] + bias.y))));
              }
            });
        float sf_lo = 0.0f, sf_hi = 0.0f;
        if (active) {
          WG_T(wg::kProfQuantize, wgb::quantize_tile(sm, tb_off, q1_off, r_lo, t, sf_lo, sf_hi));
          publish();
          if (elected) wg::mbar_arrive(aempty + 8 * w);  // Q0 takes the next tile of codes
        }
        // w = rnd(rnd(f f2w + f2b) * c) into tile B
        wg::product_s8<kCodeStages, false>(
            ring, active, q1, 0, sf_lo * s_f2, sf_hi * s_f2, 0.0f, 0.0f,
            [&](int c, float (&v)[16]) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int col = 32 * c + 8 * j + 2 * t;
                const float2 bias = ld2(f2b, col);
                st_shared32(sm, tb_off + wg::img_off<2>(r_lo, col),
                            wg::pack_bf16(rb(v[4 * j] + bias.x) * c_lo,
                                          rb(v[4 * j + 1] + bias.y) * c_lo));
                st_shared32(sm, tb_off + wg::img_off<2>(r_hi, col),
                            wg::pack_bf16(rb(v[4 * j + 2] + bias.x) * c_hi,
                                          rb(v[4 * j + 3] + bias.y) * c_hi));
              }
            });
        wg::bar_sync(wgb::kBarConsumers, wg::kConsumers);  // both w tiles are written
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
    float* out_g = p.out + (size_t)mb * R;
    for (int tp = 0; tp < npairs; ++tp) {
      const int ti = 2 * tp + w, r0 = ti * 64, nr = min(64, R - r0);
      const bool active = nr > 0;
      wg::bar_sync(bar_wg, 128);  // the last tile's head products have read Q0
      float se_lo, se_hi;
      edge_cat(ti, p.tr_out, p.tp_out, se_lo, se_hi);  // ea_out's codes in Q1
      float sh_lo = 0.0f, sh_hi = 0.0f;
      if (active) {
        // h_i * h_j on the fragment's positions into tile B, its codes into Q0
        const int i_lo = r_lo < nr ? tab[2 * (r0 + r_lo)] : 0, j_lo = r_lo < nr ? tab[2 * (r0 + r_lo) + 1] : 0;
        const int i_hi = r_hi < nr ? tab[2 * (r0 + r_hi)] : 0, j_hi = r_hi < nr ? tab[2 * (r0 + r_hi) + 1] : 0;
#pragma unroll 1
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * c + 8 * j + 2 * t;
            const float2 a = wg::unpack_bf16(wgb::ld_shared32(sm, lay.h + wg::img_off<2>(i_lo, col, ns)));
            const float2 bq = wg::unpack_bf16(wgb::ld_shared32(sm, lay.h + wg::img_off<2>(j_lo, col, ns)));
            const float2 e = wg::unpack_bf16(wgb::ld_shared32(sm, lay.h + wg::img_off<2>(i_hi, col, ns)));
            const float2 f = wg::unpack_bf16(wgb::ld_shared32(sm, lay.h + wg::img_off<2>(j_hi, col, ns)));
            st_pair(sm, tb_off, r_lo, col, wg::pack_bf16(a.x * bq.x, a.y * bq.y),
                    wg::pack_bf16(e.x * f.x, e.y * f.y));
          }
        }
        WG_T(wg::kProfQuantize, wgb::quantize_tile(sm, tb_off, q0_off, r_lo, t, sh_lo, sh_hi));
      }
      publish();
      // g = silu(rnd((h_i*h_j) g0h + ea_out g0e + g0b)) into tile B, its codes into Q0
      wg::product_s8<kCodeStages, true>(
          ring, active, q0, q1, sh_lo * s_g0h, sh_hi * s_g0h, se_lo * s_g0e, se_hi * s_g0e,
          [&](int c, float (&v)[16]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 32 * c + 8 * j + 2 * t;
              const float2 bias = ld2(g0b, col);
              st_pair(sm, tb_off, r_lo, col,
                      wg::pack_bf16(act_silu(rb(v[4 * j] + bias.x)), act_silu(rb(v[4 * j + 1] + bias.y))),
                      wg::pack_bf16(act_silu(rb(v[4 * j + 2] + bias.x)),
                                    act_silu(rb(v[4 * j + 3] + bias.y))));
            }
          });
      float sg_lo = 0.0f, sg_hi = 0.0f;
      wg::bar_sync(bar_wg, 128);  // every warp's g0 has read Q0
      if (active) WG_T(wg::kProfQuantize, wgb::quantize_tile(sm, tb_off, q0_off, r_lo, t, sg_lo, sg_hi));
      publish();
      // out = rnd(silu(rnd(g g1w + g1b))) . g2w + g2b: each thread its columns
      // of two rows, then the four lanes that share the rows
      float s_lo = 0.0f, s_hi = 0.0f;
      wg::product_s8<kCodeStages / 2, false>(
          ring, active, q0, 0, sg_lo * s_g1w, sg_hi * s_g1w, 0.0f, 0.0f,
          [&](int c, float (&v)[16]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 32 * c + 8 * j + 2 * t;
              const float2 bias = ld2(g1b, col), gw = ld2(g2w, col);
              s_lo += rb(act_silu(rb(v[4 * j] + bias.x))) * gw.x;
              s_lo += rb(act_silu(rb(v[4 * j + 1] + bias.y))) * gw.y;
              s_hi += rb(act_silu(rb(v[4 * j + 2] + bias.x))) * gw.x;
              s_hi += rb(act_silu(rb(v[4 * j + 3] + bias.y))) * gw.y;
            }
          });
      if (active) {
        s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 1);
        s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 2);
        s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 1);
        s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 2);
        if (t == 0 && r_lo < nr) out_g[r0 + r_lo] = s_lo + g2b;
        if (t == 0 && r_hi < nr) out_g[r0 + r_hi] = s_hi + g2b;
      }
    }
    WG_T_END(wg::kProfTotal, t_consumer);
  }
}

// The int8 tile product alone, for a test against an integer matrix product:
// out (64, 256) s32 = A (64, 256) s8 codes times the arranged (256, 256) s8
// weight image, transposed; A from a tile image in shared memory, four stages
// through a ring of three, both warpgroups computing (warpgroup 0 writes).
__global__ void __launch_bounds__(wg::kThreads, 1)
tile_product_s8_selftest_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ wimg8,
                                int* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kRing = 3;
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t tile_off = kRing * wg::kStageBytes;
  const uint32_t full = base + tile_off + kCodeTile, empty = full + 8 * kRing;
  const int tid = threadIdx.x;
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (tid == 0) {
    wg::ring_init(full, empty, kRing);
    wg::mbar_init_fence();
  }
  for (int idx = tid; idx < 64 * 16; idx += wg::kThreads) {
    const int row = idx >> 4, unit = idx & 15;
    *reinterpret_cast<uint4*>(sm + tile_off + wg::img_off<1>(row, unit * 16)) =
        *reinterpret_cast<const uint4*>(A + row * kH + unit * 16);
  }
  wg::fence_async_shared();
  __syncthreads();
  if (warp_idx >= wg::kConsumers / 32) {
    wg::reg_dealloc<wg::kRegsProducer>();
    if (tid == wg::kConsumers) {
      wg::Ring ring{full, empty, base, kRing};
      for (int c = 0; c < kCodeStages; ++c) ring.fill(wimg8 + c * wg::kStageBytes);
    }
  } else {
    wg::reg_alloc<wg::kRegsConsumer>();
    wg::Ring ring{full, empty, base, kRing};
    const int w = warp_idx >> 2, ct = tid & 127, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r_lo = ((ct >> 5) << 4) + g, r_hi = r_lo + 8;
    // scales of 1: the f32 values are the s32 sums (exact below 2^24)
    wg::product_s8<kCodeStages, false>(
        ring, true, base + tile_off, 0, 1.0f, 1.0f, 0.0f, 0.0f,
        [&](int c, float (&v)[16]) {
          if (w != 0) return;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * c + 8 * j + 2 * t;
            out[r_lo * kH + col] = (int)v[4 * j];
            out[r_lo * kH + col + 1] = (int)v[4 * j + 1];
            out[r_hi * kH + col] = (int)v[4 * j + 2];
            out[r_hi * kH + col + 1] = (int)v[4 * j + 3];
          }
        });
  }
}

template <typename T>
void fill_params(Params<T>& p, const void* const* ptrs, int& i) {
  auto f32 = [&]() { return static_cast<const float*>(ptrs[i++]); };
  auto i32 = [&]() { return static_cast<const int*>(ptrs[i++]); };
  auto i8 = [&]() { return static_cast<const int8_t*>(ptrs[i++]); };
  auto wt = [&]() { return static_cast<const T*>(ptrs[i++]); };
  p.d = f32(); p.c = f32(); p.z = wt();
  p.tr_in = i32(); p.tp_in = i32(); p.tr_out = i32(); p.tp_out = i32();
  p.scales = f32(); p.f1s = f32(); p.f2s = f32();
  p.table = i8(); p.dw0 = wt(); p.db0 = wt(); p.dw1 = i8(); p.db1 = wt();
  p.c0r = i8(); p.c0p = i8(); p.c0b = wt(); p.c1w = i8(); p.c1b = wt();
  p.f1w = i8(); p.f1b = wt(); p.f2w = i8(); p.f2b = wt();
  p.l1w = wt(); p.l2w = wt(); p.l2b = wt(); p.ow = wt(); p.ob = wt();
  p.g0h = i8(); p.g0e = i8(); p.g0b = wt(); p.g1w = i8(); p.g1b = wt();
  p.g2w = wt(); p.g2b = wt();
}

bool wg_takes(int N, int H, int is_bf16) {
  return is_bf16 && H == kH && N % 8 == 0 && graph_layout(N).stages >= 3;
}

int launch_wg(const void* const* ptrs, int M, int B, int N, int L, int V, void* stream) {
  const GraphSmem lay = graph_layout(N);
  Params<bf16> p;
  int i = 0;
  fill_params(p, ptrs, i);
  const int8_t* wimg8 = static_cast<const int8_t*>(ptrs[i++]);
  const bf16* wimg = static_cast<const bf16*>(ptrs[i++]);
  p.ea_q = static_cast<int8_t*>(const_cast<void*>(ptrs[i++]));
  p.ea_s = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  p.out = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  if (i != kNumPtrs || wimg8 == nullptr || wimg == nullptr) return (int)cudaErrorInvalidValue;
  p.M = M; p.B = B; p.N = N; p.H = kH; p.L = L; p.V = V;
  cudaError_t e = cudaFuncSetAttribute(packed_score_int8_wg_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  packed_score_int8_wg_kernel<<<M * B, wg::kThreads, lay.total,
                                static_cast<cudaStream_t>(stream)>>>(p, wimg8, wimg);
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
  p.ea_q = static_cast<int8_t*>(const_cast<void*>(ptrs[i++]));
  p.ea_s = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  p.out = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  if (i != kNumPtrs) return (int)cudaErrorInvalidValue;
  p.M = M; p.B = B; p.N = N; p.H = H; p.L = L; p.V = V;
  cudaError_t e = cudaFuncSetAttribute(packed_score_int8_kernel<T, TR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  packed_score_int8_kernel<T, TR>
      <<<M * B, kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

WG_PROFILE_ENTRY(packed_score_int8_profile)

extern "C" {

// Launches the int8 score kernel on `stream`; returns the cudaError_t of the
// launch.  ptrs: d, cmask, z, tr_in, tp_in, tr_out, tp_out, the (M, 8) scales,
// the (M, L) f1w and f2w scales, the 26 weights in the order of Params (int8
// codes for the quantized ones), the two arranged weight images (int8, then
// working type; may be null where packed_score_int8_uses_wg says 0), the ea_q
// and ea_s scratch and the output.  bf16 at H = 256 takes the warp-specialised
// kernel whenever its shared memory fits (N <= 24); every other shape, and
// float32, takes the mma.sync kernel.
int packed_score_int8_launch(const void* const* ptrs, int M, int B, int N, int H, int L, int V,
                             int is_bf16, void* stream) {
  if (N <= 0 || N % 8 != 0 || H <= 0 || H % 64 != 0 || L < 0 || M <= 0 || B <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  if (wg_takes(N, H, is_bf16)) return launch_wg(ptrs, M, B, N, L, V, stream);
  if (is_bf16) return launch<__nv_bfloat16, 64>(ptrs, M, B, N, H, L, V, stream);
  return launch<float, 32>(ptrs, M, B, N, H, L, V, stream);
}

// 1 where packed_score_int8_launch takes the warp-specialised kernel.  Its
// scratch is ceil(R / 64) tiles per (member, graph): 16 KB of codes and 64 row
// scales each.
int packed_score_int8_uses_wg(int N, int H, int is_bf16) { return wg_takes(N, H, is_bf16) ? 1 : 0; }

// out (64, 256) s32 = A (64, 256) s8 times the arranged (256, 256) s8 weight
// image, transposed, through the ring.
int packed_score_int8_tile_selftest(const void* A, const void* wimg8, void* out, void* stream) {
  const int smem = 3 * wg::kStageBytes + kCodeTile + 128 + 1024;
  cudaError_t e = cudaFuncSetAttribute(tile_product_s8_selftest_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tile_product_s8_selftest_kernel<<<1, wg::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(A), static_cast<const int8_t*>(wimg8), static_cast<int*>(out));
  return (int)cudaGetLastError();
}

const char* packed_score_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
