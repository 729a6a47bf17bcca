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
// Design.  As packed_score.cu: one CTA per (member, graph), h, xh and the f32
// aggregation buffer in shared memory, pair rows in tiles of TR rows, weights
// streamed from L2.  Each int8 product is mma.sync.m16n8k32 (s8 x s8 -> s32)
// on a tile quantized in shared memory by one warp per row (the row maximum is
// a warp shuffle reduction over all H columns), with the dequantization in the
// product's epilogue.  The global scratch holds ea as int8 codes and row
// scales instead of T: half the bytes of packed_score.cu's scratch at bf16.
//
// Bound at the main path's shapes (M=8, B=100, N=24, H=F=256, L=7, bf16):
// 7.1e11 int8 operations in the pair-row products, 0.36 ms at 1979 TOP/s,
// plus 5.3e10 flop of node products and the last head layer in bf16, 0.05 ms
// at 989 TFLOP/s; the inputs and outputs are ~35 MB (10 us at 3.35 TB/s).
// Bound by the tensor cores.  This first version makes no attempt at that
// bound, for packed_score.cu's reasons, and adds a quantization pass over
// every tile between two products.

#include "graph_block.cuh"

namespace {

using tile::from_f;
using tile::gemm8;
using tile::kThreads;
using tile::quantize_rows;
using tile::rnd;
using tile::silu_f;
using tile::ssp_f;
using tile::to_f;

constexpr int kNumPtrs = 39;
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

template <typename T, int TR>
int launch(const void* const* ptrs, int M, int B, int N, int H, int L, int V, void* stream) {
  const Smem lay = smem_layout<T, TR>(N, H);
  if (lay.np > TR || lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params<T> p;
  int i = 0;
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

extern "C" {

// Launches the int8 score kernel on `stream`; returns the cudaError_t of the
// launch.  ptrs: d, cmask, z, tr_in, tp_in, tr_out, tp_out, the (M, 8) scales,
// the (M, L) f1w and f2w scales, the 26 weights in the order of Params (int8
// codes for the quantized ones), the ea_q and ea_s scratch and the output.
int packed_score_int8_launch(const void* const* ptrs, int M, int B, int N, int H, int L, int V,
                             int is_bf16, void* stream) {
  if (N <= 0 || N % 8 != 0 || H <= 0 || H % 64 != 0 || L < 0 || M <= 0 || B <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) return launch<__nv_bfloat16, 64>(ptrs, M, B, N, H, L, V, stream);
  return launch<float, 32>(ptrs, M, B, N, H, L, V, stream);
}

const char* packed_score_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
