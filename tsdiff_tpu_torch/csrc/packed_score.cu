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
// Design.  One CTA owns one (member, graph): the node states h, xh and the
// f32 aggregation buffer agg (N x H each) stay in shared memory, so the
// aggregation needs no atomics and is deterministic.  Pair rows are walked
// in tiles of TR rows.  The encoder-order edge features ea are written once
// to a global scratch buffer (allocated by the caller) and read back by every
// block; de is recomputed for the output stage instead of being stored.
// Weights stream from global memory (L2-resident across CTAs of a member):
// each warp owns 32 output columns and reads its B fragments straight from
// the (out, in) weight rows.  bf16 products run on the tensor cores through
// mma.sync.m16n8k16 with f32 accumulation; the f32 path uses FMA loops (it
// exists to check the kernel against the plain version, not for speed).
//
// Bound at the main path's shapes (M=8, B=100, N=24, H=F=256, L=7, bf16):
// ~7.6e11 flop per launch against ~56 MB of inputs and outputs (mostly the
// members' weights), so the tensor-core rate bounds it (~0.77 ms at 989
// TFLOP/s, against ~17 us for the bytes at 3.35 TB/s).  This first version makes no attempt
// at that bound: no TMA, no wgmma, no warp specialisation, and each weight
// matrix is re-read from L2 once per row tile.

#include "graph_block.cuh"

namespace {

using tile::from_f;
using tile::gemm;
using tile::kThreads;
using tile::rnd;
using tile::silu_f;
using tile::to_f;

constexpr int kNumPtrs = 35;

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

template <typename T, int TR>
int launch(const void* const* ptrs, int M, int B, int N, int H, int L, int V, void* stream) {
  const Smem lay = smem_layout<T, TR>(N, H);
  if (lay.np > TR || lay.total > 232448) return (int)cudaErrorInvalidValue;
  Params<T> p;
  int i = 0;
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

extern "C" {

// Launches the score kernel on `stream`; returns the cudaError_t of the launch.
// ptrs: d, cmask, z, tr_in, tp_in, tr_out, tp_out, the 26 weights in the
// order of Params, the ea scratch and the output.
int packed_score_launch(const void* const* ptrs, int M, int B, int N, int H, int L, int V,
                        int is_bf16, void* stream) {
  if (N <= 0 || N % 8 != 0 || H % 64 != 0 || L < 0 || M <= 0 || B <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) return launch<__nv_bfloat16, 64>(ptrs, M, B, N, H, L, V, stream);
  return launch<float, 32>(ptrs, M, B, N, H, L, V, stream);
}

const char* packed_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
