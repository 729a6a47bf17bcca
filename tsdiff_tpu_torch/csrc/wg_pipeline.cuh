// Warp-specialised tile-product pipeline for Hopper, shared by the port's
// redesigned kernels.
//
// A CTA of kThreads = 384 threads is two consumer warpgroups (warps 0-7) and
// one producer warpgroup (warps 8-11, of which one lane works).  The producer
// walks a static schedule of weight stages and fills a ring of shared-memory
// buffers with one bulk asynchronous copy per stage (cp.async.bulk, completion
// on an mbarrier).  A stage is kStageCols = 32 output columns of one weight
// matrix over the whole reduction length (16 KB: K = 256 in bf16, or two such
// blocks in s8), stored in global memory in exactly the image wgmma reads
// from shared memory, so the copy is 1-D and needs no tensor map:
//
//   atom kc (K elements [kc*A, (kc+1)*A), A = 128 bytes / element size):
//     `rows` rows of 128 bytes; the 16-byte unit u of row r sits at unit
//     u ^ (r % 8)                                  (the 128-byte swizzle)
//   a stage, and a 64-row activation tile, is its atoms one after another.
//
// Both consumer warpgroups read every stage (each holds its own 64-row tile,
// so a stage read once from L2 serves 128 rows) and release it, one arrival
// per warp.  A product is a sequence of stages; per stage a warpgroup starts
// wgmma.mma_async m64n32k16 (bf16, f32 accumulators) or m64n32k32 (s8, s32
// accumulators) over K, A from a tile image in shared memory, and while a
// stage's epilogue runs the next stage's wgmma is already in flight (two
// accumulator sets).  Thread (warp q, lane 4g+t) of a warpgroup holds rows
// 16q+g and 16q+g+8, columns 8j+2t, 8j+2t+1 of every 8-column group j of a
// stage: an epilogue works on the fragment where it sits and stores packed
// pairs into the next product's tile image.
//
// The accumulator fragment also maps onto the A register fragments of the
// next product (frag_put; mma_rs_bf16 takes them), but a chain held that way
// with 32-column stages on both sides needs the fragments of two products and
// the accumulators at once, 160 registers before any address or bias: at the
// 232 a consumer thread can have ptxas then serializes every wgmma of the
// kernel (C7512) and spills.  So the chains here go through shared memory, two
// tiles per warpgroup.  One exception, B1's filter chain (packed_score.cu):
// each 32 columns of the first product's output are the A fragments of one
// 32-deep K-block of the second, which runs full width (m64n256k16, A from
// registers: mma_kblock_bf16_n256) from a stage of 256 rows of 64 bytes in the
// 64-byte swizzle (make_desc_sw64).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace wg {

constexpr int kThreads = 384;       // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kConsumers = 256;     // threads of the two consumer warpgroups
constexpr int kMaxStages = 8;
constexpr int kStageCols = 32;
constexpr int kStageBytes = 16384;  // 32 rows x 256 bf16, or 64 rows x 256 s8
constexpr int kStageAtom = 4096;    // 32 rows x 128 bytes
constexpr int kTileBytes = 32768;   // 64 rows x 256 bf16
constexpr int kAtomBytes = 8192;    // 64 rows x 128 bytes
// 168 registers a thread at launch (65536 / 384): 2 x 128 x 224 + 128 x 56 of them
constexpr int kRegsProducer = 56;
constexpr int kRegsConsumer = 224;
constexpr uint32_t kSpinLimit = 1u << 22;  // a wait that long is a lost arrival: trap

// Built with -DWG_PROFILE (ops/wg_profile.py does), thread 0 of CTA 0, a lane
// of consumer warpgroup 0, adds the clock64 cycles it spends in each part to
// g_prof: no profiler runs where these kernels are measured.  Without the
// flag WG_T is the statement alone.
enum Prof {
  kProfAcquire, kProfDispatch, kProfWait, kProfEpilogue, kProfBarrier, kProfTileWait,
  kProfAggregate, kProfNodeProducts, kProfStoreKept, kProfFirstLayer, kProfQuantize,
  kProfTotal, kProfSlots
};
#ifdef WG_PROFILE
__device__ unsigned long long g_prof[kProfSlots];
#define WG_T(slot, ...)                                                                    \
  {                                                                                        \
    const long long wg_t0_ = clock64();                                                    \
    __VA_ARGS__;                                                                           \
    if (threadIdx.x == 0 && blockIdx.x == 0) wg::g_prof[slot] += clock64() - wg_t0_;        \
  }
#define WG_T_BEGIN(var) const long long var = clock64()
#define WG_T_END(slot, var) \
  if (threadIdx.x == 0 && blockIdx.x == 0) wg::g_prof[slot] += clock64() - var
#else
#define WG_T(slot, ...) \
  { __VA_ARGS__; }
#define WG_T_BEGIN(var) \
  do {                  \
  } while (0)
#define WG_T_END(slot, var) \
  do {                      \
  } while (0)
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers, bulk copies, fences, named barriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// A wait that has spun kSpinLimit times traps.  Where the including source
// defines WG_TRAP_OUTLINED before the include, the trap is a call: with a trap
// instruction inline anywhere in a function, ptxas holds every region of it to
// the launch's register count (168 a thread at 384 threads), whatever setmaxnreg
// gives the warpgroup, and it does not for a call (packed_score.cu defines it).
#ifdef WG_TRAP_OUTLINED
__device__ __noinline__ void trap_outlined() { __trap(); }
#define WG_TRAP() trap_outlined()
#else
#define WG_TRAP() __trap()
#endif

// returns when the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) break;
    if (++spins > kSpinLimit) WG_TRAP();
  }
}
// global -> shared, `bytes` a multiple of 16, both 16-byte aligned
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// shared -> global, tracked by the issuing thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the issuing thread's bulk stores have read their shared-memory source
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and have been written
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes before, asynchronous-proxy reads (wgmma, bulk copies) after
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  WG_T(kProfBarrier, asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory"));
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int N> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// The ring of weight stages.  full[i] counts the producer's expect_tx arrival
// and the copy's bytes; empty[i] counts one arrival of each consumer warp (a
// warp that lags behind its warpgroup must have seen the stage's phase before
// the stage is filled again: waits go by phase parity).  Every thread keeps
// its own cursor.

struct Ring {
  uint32_t full, empty, buf;  // shared addresses: barrier i at +8*i, stage i at +kStageBytes*i
  uint32_t n;                 // stages, at most kMaxStages
  uint32_t idx = 0, phase = 0;    // next stage to fill (producer) or to read (consumer)
  uint32_t ridx = 0;              // consumer: next stage to release

  __device__ __forceinline__ void advance() {
    if (++idx == n) { idx = 0; phase ^= 1; }
  }
  // producer (one thread): fill the next stage from `src`
  __device__ __forceinline__ void fill(const void* src) {
    mbar_wait(empty + 8 * idx, phase ^ 1);
    mbar_expect_tx(full + 8 * idx, kStageBytes);
    bulk_load(buf + kStageBytes * idx, src, kStageBytes, full + 8 * idx);
    advance();
  }
  // consumer (every thread): the shared address of the next stage, once filled
  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(full + 8 * idx, phase);
    const uint32_t s = buf + kStageBytes * idx;
    advance();
    return s;
  }
  // consumer (every thread, after its warp's wgmma on the stage ended)
  __device__ __forceinline__ void release() {
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * ridx);
    if (++ridx == n) ridx = 0;
  }
};

__device__ __forceinline__ void ring_init(uint32_t full, uint32_t empty, int n) {
  for (int i = 0; i < n; ++i) {
    mbar_init(full + 8 * i, 1);
    mbar_init(empty + 8 * i, kConsumers / 32);
  }
}

// ---------------------------------------------------------------------------
// The tile image.  Byte offset of element (row, k) of a 64-row tile whose
// atoms are `atom_stride` bytes apart (kAtomBytes for a full tile; rows*128
// for a node tile that keeps only its first rows), ESZ bytes per element.

template <int ESZ>
__device__ __forceinline__ uint32_t img_off(int row, int k, uint32_t atom_stride = kAtomBytes) {
  constexpr int kAtomK = 128 / ESZ, kUnitK = 16 / ESZ;
  const int kk = k % kAtomK;
  return (k / kAtomK) * atom_stride + row * 128 + (((kk / kUnitK) ^ (row & 7)) << 4) +
         (kk % kUnitK) * ESZ;
}

// ---------------------------------------------------------------------------
// wgmma

// descriptor of a K-major operand in the tile image (1024-byte aligned atoms)
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset: unused with a swizzle
  d |= (uint64_t)(1024 >> 4) << 32;  // stride between 8-row groups
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from reading an accumulator before the wait that ends its group
template <typename V> __device__ __forceinline__ void fence_operand(V (&x)[16]);
template <> __device__ __forceinline__ void fence_operand<float>(float (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <> __device__ __forceinline__ void fence_operand<int>(int (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

#define WG_ACC16(c, d)                                                                      \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15])
#define WG_F(x) "+f"(x)
#define WG_R(x) "+r"(x)
#define WG_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (+)= A(shared) B(shared)^T, m64n32k16 bf16
__device__ __forceinline__ void mma_ss_bf16(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_REGS16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC16(WG_F, d)
      : "l"(da), "l"(db), "r"(acc));
}
// d (+)= A(registers) B(shared)^T, m64n32k16 bf16
__device__ __forceinline__ void mma_rs_bf16(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : WG_ACC16(WG_F, d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}
// d (+)= A(shared) B(shared)^T, m64n32k32 s8 x s8 -> s32
__device__ __forceinline__ void mma_ss_s8(int (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " WG_REGS16 ", %16, %17, p;\n}\n"
      : WG_ACC16(WG_R, d)
      : "l"(da), "l"(db), "r"(acc));
}

// acc (+)= A B^T over K = 256 for one 32-column stage in bf16: 16 k16 steps,
// four per atom, 32 bytes apart inside the swizzled row.  A is the tile image
// at a_img (atoms a_stride bytes apart); the stage's atoms are kStageAtom apart.
__device__ __forceinline__ void mma_stage_bf16(float (&acc)[16], uint32_t a_img, uint32_t a_stride,
                                               uint32_t b_stage, bool zero) {
  const uint64_t db = make_desc(b_stage);
  const uint64_t da = make_desc(a_img);
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const uint32_t in_atom = (s & 3) * 32;
    mma_ss_bf16(acc, da + (((s >> 2) * a_stride + in_atom) >> 4),
                db + (((s >> 2) * kStageAtom + in_atom) >> 4), (s > 0 || !zero) ? 1 : 0);
  }
}
// the same with A from the register fragments a[4s .. 4s+3] of k16 step s
__device__ __forceinline__ void mma_stage_bf16_rs(float (&acc)[16], const uint32_t (&a)[64],
                                                  uint32_t b_stage, bool zero) {
  const uint64_t db = make_desc(b_stage);
#pragma unroll
  for (int s = 0; s < 16; ++s)
    mma_rs_bf16(acc, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3],
                db + (((s >> 2) * kStageAtom + (s & 3) * 32) >> 4), (s > 0 || !zero) ? 1 : 0);
}

// acc (+)= A B^T over K = 256 for 32 columns in s8: 8 k32 steps, four per
// atom; A a 64-row s8 tile image (2 atoms of kAtomBytes), b_half the 32-row
// half of an s8 stage (2 atoms of kStageAtom, 8 KB).
__device__ __forceinline__ void mma_stage_s8(int (&acc)[16], uint32_t a_img, uint32_t b_half,
                                             bool zero) {
  const uint64_t db = make_desc(b_half);
  const uint64_t da = make_desc(a_img);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint32_t in_atom = (s & 3) * 32;
    mma_ss_s8(acc, da + (((s >> 2) * kAtomBytes + in_atom) >> 4),
              db + (((s >> 2) * kStageAtom + in_atom) >> 4), (s > 0 || !zero) ? 1 : 0);
  }
}

// ---------------------------------------------------------------------------
// Fragments.  In stage c (columns 32c..32c+31) the accumulator entries
// 4j..4j+3 of thread (warp q, lane 4g+t) are (row 16q+g, col), (row 16q+g,
// col+1), (row 16q+g+8, col), (row 16q+g+8, col+1) with col = 32c + 8j + 2t.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// the two packed column pairs (row g, row g+8) of group j in stage c, as the
// A fragments of a product: k16 step 2c + j/2, registers 2(j%2) and 2(j%2)+1
__device__ __forceinline__ void frag_put(uint32_t (&a)[64], int c, int j, uint32_t lo,
                                         uint32_t hi) {
  a[8 * c + 4 * (j >> 1) + 2 * (j & 1)] = lo;
  a[8 * c + 4 * (j >> 1) + 2 * (j & 1) + 1] = hi;
}

// One product on one warpgroup's 64-row tile: kStagesN stages of 32 output
// columns each, A from the tile image a1 (atoms a_stride apart).  kDual: two
// operands summed into one accumulator, per 32 columns a stage for a1 and
// then a stage for a2.  epi(c, acc, out) gets stage c's accumulator while stage
// c+1's wgmma is in flight, and may leave 8 packed results in out (row g and
// row g+8 of group j at out[2j], out[2j+1]): they are kept in hold[8c..8c+7]
// (kKeep) for a tile that is still being read, to be stored when the product
// has ended.  (ptxas keeps hold in local memory, 64 stores and loads a
// product and thread, whatever the register budget: its only spills.)  A
// warpgroup never holds more than three stages.  An inactive warpgroup (no rows in this tile) only passes the
// stages on.
template <int kStagesN, bool kDual, bool kKeep, typename Epi>
__device__ __forceinline__ void product_bf16(Ring& ring, bool active, uint32_t a1, uint32_t a2,
                                             uint32_t a_stride, uint32_t (&hold)[64], Epi epi) {
  constexpr int kPer = kDual ? 2 : 1;
  if (!active) {
    for (int i = 0; i < kStagesN * kPer; ++i) {
      ring.acquire();
      ring.release();
    }
    return;
  }
  float acc[2][16];
#pragma unroll
  for (int c = 0; c <= kStagesN; ++c) {
    if (c < kStagesN) {
      uint32_t b0;
      WG_T(kProfAcquire, b0 = ring.acquire());
      WG_T(kProfDispatch, wgmma_fence(); mma_stage_bf16(acc[c & 1], a1, a_stride, b0, true);
           wgmma_commit());
    }
    if (c > 0) {  // all but the group just committed have ended: stage c-1 is done
      WG_T(kProfWait, if (c < kStagesN) wgmma_wait<1>(); else wgmma_wait<0>());
      fence_operand(acc[(c - 1) & 1]);
      for (int i = 0; i < kPer; ++i) ring.release();
    }
    if (kDual && c < kStagesN) {
      uint32_t b1;
      WG_T(kProfAcquire, b1 = ring.acquire());
      WG_T(kProfDispatch, mma_stage_bf16(acc[c & 1], a2, a_stride, b1, false); wgmma_commit());
    }
    if (c > 0) {
      uint32_t out[8];
      WG_T(kProfEpilogue, epi(c - 1, acc[(c - 1) & 1], out));
      if (kKeep) {
#pragma unroll
        for (int i = 0; i < 8; ++i) hold[8 * (c - 1) + i] = out[i];
      }
    }
  }
}

// The int8 product on one warpgroup's 64-row tile of codes: kStagesN ring
// stages of 64 output columns (two 32-column halves, 8 KB each), A the s8 tile
// image a1.  The exact s32 sums are scaled back to f32 by the row's scale times
// the weight's (s1_lo for row g, s1_hi for row g+8, the products taken by the
// caller): v = f32(acc) * s, with __fmul_rn and __fadd_rn so that no
// contraction changes a bit.  kDual: a second operand a2 with its own scales
// and its own accumulators, per 64 columns a stage for a1 and then a stage for
// a2, dequantized apart and then added.  epi(c, v) gets the 32-column half c
// (v laid out as product_bf16's accumulator); it stores its results itself.
template <int kStagesN, bool kDual, typename Epi>
__device__ __forceinline__ void product_s8(Ring& ring, bool active, uint32_t a1, uint32_t a2,
                                           float s1_lo, float s1_hi, float s2_lo, float s2_hi,
                                           Epi epi) {
  constexpr int kPer = kDual ? 2 : 1;
  constexpr uint32_t kHalf = kStageBytes / 2;
  if (!active) {
    for (int i = 0; i < kStagesN * kPer; ++i) {
      ring.acquire();
      ring.release();
    }
    return;
  }
  auto finish = [&](int c, int (&x1)[16], int (&x2)[16]) {
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] = __fmul_rn(__int2float_rn(x1[i]), (i & 2) ? s1_hi : s1_lo);
      if (kDual) v[i] = __fadd_rn(v[i], __fmul_rn(__int2float_rn(x2[i]), (i & 2) ? s2_hi : s2_lo));
    }
    WG_T(kProfEpilogue, epi(c, v));
  };
  if constexpr (!kDual) {
    int acc[2][2][16];
#pragma unroll
    for (int s = 0; s <= kStagesN; ++s) {
      if (s < kStagesN) {
        uint32_t b;
        WG_T(kProfAcquire, b = ring.acquire());
        WG_T(kProfDispatch, wgmma_fence(); mma_stage_s8(acc[s & 1][0], a1, b, true);
             mma_stage_s8(acc[s & 1][1], a1, b + kHalf, true); wgmma_commit());
      }
      if (s > 0) {
        WG_T(kProfWait, if (s < kStagesN) wgmma_wait<1>(); else wgmma_wait<0>());
        fence_operand(acc[(s - 1) & 1][0]);
        fence_operand(acc[(s - 1) & 1][1]);
        ring.release();
        finish(2 * (s - 1), acc[(s - 1) & 1][0], acc[(s - 1) & 1][0]);
        finish(2 * (s - 1) + 1, acc[(s - 1) & 1][1], acc[(s - 1) & 1][1]);
      }
    }
  } else {
    int acc1[2][16], acc2[2][16];
#pragma unroll
    for (int s = 0; s < kStagesN; ++s) {
      uint32_t b1, b2;
      WG_T(kProfAcquire, b1 = ring.acquire(); b2 = ring.acquire());
      WG_T(kProfDispatch, wgmma_fence(); mma_stage_s8(acc1[0], a1, b1, true);
           mma_stage_s8(acc1[1], a1, b1 + kHalf, true); mma_stage_s8(acc2[0], a2, b2, true);
           mma_stage_s8(acc2[1], a2, b2 + kHalf, true); wgmma_commit());
      WG_T(kProfWait, wgmma_wait<0>());
      fence_operand(acc1[0]);
      fence_operand(acc1[1]);
      fence_operand(acc2[0]);
      fence_operand(acc2[1]);
      ring.release();
      ring.release();
      finish(2 * s, acc1[0], acc2[0]);
      finish(2 * s + 1, acc1[1], acc2[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Both operands read transposed: D (+)= X^T Y over rows, for weight gradients.
//
// A 2-D tensor copy (cp.async.bulk.tensor.2d, tensor map made on the host
// with CU_TENSOR_MAP_SWIZZLE_128B) brings a box of 64 columns (128 bytes of
// bf16) by 64 rows of a row-major matrix into shared memory: row r at byte
// 128 r, its 16-byte unit u at unit u ^ (r % 8), the tile image's swizzle
// (img_off) with the rows along the reduction.  Rows past the tensor's end
// arrive as zeros, and the copy's bytes count in full.  A wgmma operand
// whose M (or N) runs along such a row is MN-major (imm-trans = 1); in its
// descriptor the stride byte offset is the step between 8-row groups along K
// (kMnGroupBytes) and the leading byte offset the step between 64-column
// boxes along M or N (kMnBoxBytes, the boxes one after another); a k16 step
// begins 16 rows (kMnK16Bytes) further on.  ops/schnet_stack.py mirrors these
// constants (XTY_*), and tests/test_torch_stack_xty_layout.py emulates the
// addresses they give.

constexpr uint32_t kMnBoxRows = 64;
constexpr uint32_t kMnBoxBytes = 8192;   // 64 rows x 128 bytes
constexpr uint32_t kMnGroupBytes = 1024; // 8 rows x 128 bytes
constexpr uint32_t kMnK16Bytes = 2048;   // 16 rows x 128 bytes

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int col, int row,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// descriptor of an MN-major operand made of 64-column boxes (1024-byte aligned)
__device__ __forceinline__ uint64_t make_desc_mn(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)(kMnBoxBytes >> 4) << 16;    // leading byte offset: between boxes along M or N
  d |= (uint64_t)(kMnGroupBytes >> 4) << 32;  // stride byte offset: between 8-row groups along K
  d |= (uint64_t)1 << 62;                     // 128-byte swizzle
  return d;
}

#define WG_ACC16_AT(c, d, o)                                                                  \
  c(d[o]), c(d[o + 1]), c(d[o + 2]), c(d[o + 3]), c(d[o + 4]), c(d[o + 5]), c(d[o + 6]),      \
      c(d[o + 7]), c(d[o + 8]), c(d[o + 9]), c(d[o + 10]), c(d[o + 11]), c(d[o + 12]),         \
      c(d[o + 13]), c(d[o + 14]), c(d[o + 15])
#define WG_ACC128(c, d)                                                                       \
  WG_ACC16_AT(c, d, 0), WG_ACC16_AT(c, d, 16), WG_ACC16_AT(c, d, 32), WG_ACC16_AT(c, d, 48),  \
      WG_ACC16_AT(c, d, 64), WG_ACC16_AT(c, d, 80), WG_ACC16_AT(c, d, 96),                     \
      WG_ACC16_AT(c, d, 112)

// d (+)= A B, m64n256k16 bf16, A (64 x 16) and B (16 x 256) both MN-major in
// shared memory: imm-trans-a = imm-trans-b = 1.  Thread (warp q, lane 4g+t)
// of the warpgroup holds rows 16q+g (d[4j], d[4j+1]) and 16q+g+8 (d[4j+2],
// d[4j+3]) of columns 8j+2t, 8j+2t+1, j = 0..31.
__device__ __forceinline__ void mma_tt_bf16_n256(float (&d)[128], uint64_t da, uint64_t db,
                                                 int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      " %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86,"
      " %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102,"
      " %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116,"
      " %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", %128, %129, p, 1, 1, 1, 1;\n}\n"
      : WG_ACC128(WG_F, d)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void fence_acc128(float (&x)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// descriptor of a K-major operand whose rows are 64 bytes (32 bf16 of K) and
// lie one after another, 1024-byte aligned: 8-row groups of 512 bytes, the
// 16-byte unit u of row r at unit u ^ ((r >> 1) & 3) (the 64-byte swizzle:
// address bits 4-5 XOR bits 7-8)
__device__ __forceinline__ uint64_t make_desc_sw64(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;           // leading byte offset: unused with a swizzle
  d |= (uint64_t)(512 >> 4) << 32;  // stride between 8-row groups
  d |= (uint64_t)2 << 62;           // 64-byte swizzle
  return d;
}

// d (+)= A(registers) B(shared)^T, m64n256k16 bf16, B K-major; d laid out as
// mma_tt_bf16_n256's
__device__ __forceinline__ void mma_rs_bf16_n256(float (&d)[128], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      " %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86,"
      " %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102,"
      " %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116,"
      " %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : WG_ACC128(WG_F, d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}

// acc (+)= A B^T over one 32-deep K-block, all 256 output columns: two
// m64n256k16 steps, A the register fragments a[0..3] (k16 step 0) and a[4..7]
// (step 1) as frag_put lays out one 32-column stage, B the K-block stage at
// b_stage (256 rows of 64 bytes, make_desc_sw64), step 1 32 bytes into its rows.
__device__ __forceinline__ void mma_kblock_bf16_n256(float (&acc)[128], const uint32_t (&a)[8],
                                                     uint32_t b_stage, bool zero) {
  const uint64_t db = make_desc_sw64(b_stage);
  mma_rs_bf16_n256(acc, a[0], a[1], a[2], a[3], db, zero ? 0 : 1);
  mma_rs_bf16_n256(acc, a[4], a[5], a[6], a[7], db + (32 >> 4), 1);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// One graph per CTA on the pipeline: what the warp-specialised graph kernels
// share (bf16 working type, H = F = 256).

namespace wgb {

using bf16 = __nv_bfloat16;
constexpr int kH = 256;
constexpr int kHH = kH * kH;
constexpr int kStageElems = wg::kStageBytes / 2;  // bf16 elements of a weight stage
constexpr int kTileElems = wg::kTileBytes / 2;    // bf16 elements of a 64-row tile
constexpr int kStagesPerMat = kH / wg::kStageCols;
constexpr size_t kMaxSmem = 232448;
constexpr float kLog2 = 0.6931471805599453f;
// named barriers: 0 is __syncthreads
enum Bar { kBarWg0 = 1, kBarWg1 = 2, kBarConsumers = 3 };

// Shared memory of a warp-specialised graph kernel, offsets from a 1024-byte
// aligned base.  Each warpgroup has two 64-row tiles, A (which also takes the
// ea tiles the producer prefetches) and B; a chain of products alternates
// between them.  The node tile h keeps only its N rows (atoms node_stride
// apart): a node product reads 64 rows, so it comes first and what lies
// behind it is mapped; xh is N plain rows.  Between two tile loops the B tiles hold
// the node update's operands.  The ring takes what is left.
struct GraphSmem {
  uint32_t h, xh, tiles, agg, tab, bars, ring, total;
  uint32_t node_stride, stages;
};

__host__ __device__ inline GraphSmem graph_layout(int N) {
  GraphSmem s;
  const uint32_t R = (N / 2) * N;
  s.node_stride = N * 128;
  s.h = 0;
  s.xh = 4 * s.node_stride;
  s.tiles = 8 * s.node_stride;             // A0, B0, A1, B1
  s.agg = s.tiles + 4 * wg::kTileBytes;
  s.tab = s.agg + N * kH * 4;
  s.bars = s.tab + (2 * R + 15) / 16 * 16;
  s.ring = (s.bars + 8 * (2 * wg::kMaxStages + 4) + 1023) / 1024 * 1024;
  const uint32_t room = s.ring + 1024 < kMaxSmem ? (uint32_t)kMaxSmem - 1024 - s.ring : 0;
  s.stages = room / wg::kStageBytes < wg::kMaxStages ? room / wg::kStageBytes : wg::kMaxStages;
  s.total = s.ring + s.stages * wg::kStageBytes + 1024;  // and the slack of the alignment
  return s;
}

// The carve-up of the dense kernels (one graph's P = N*N pair rows p = i*N
// + j: B2 and the SchNet stack's forward and backward row kernel):
// graph_layout's, with the dense row table (two bytes per row) where `table`
// says so, and six mbarriers beside the ring's: per warpgroup the ea tile
// (full, empty) and one more tile (B2's kept tile, the row kernel's w tile of
// pass 2).  At N = 24 the ring has 3 stages, with or without the table.
__host__ __device__ inline GraphSmem dense_layout(int N, bool table) {
  GraphSmem s;
  const uint32_t P = N * N;
  s.node_stride = N * 128;
  s.h = 0;
  s.xh = 4 * s.node_stride;
  s.tiles = 8 * s.node_stride;  // A0, B0, A1, B1
  s.agg = s.tiles + 4 * wg::kTileBytes;
  s.tab = s.agg + N * kH * 4;
  s.bars = s.tab + (table ? (2 * P + 15) / 16 * 16 : 0);
  s.ring = (s.bars + 8 * (2 * wg::kMaxStages + 6) + 1023) / 1024 * 1024;
  const uint32_t room = s.ring + 1024 < kMaxSmem ? (uint32_t)kMaxSmem - 1024 - s.ring : 0;
  s.stages = room / wg::kStageBytes < wg::kMaxStages ? room / wg::kStageBytes : wg::kMaxStages;
  s.total = s.ring + s.stages * wg::kStageBytes + 1024;  // and the slack of the alignment
  return s;
}

// global -> L2, `bytes` a multiple of 16, 16-byte aligned
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ float2 ld2(const bf16* v, int col) {
  return wg::unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(v + col)));
}
__device__ __forceinline__ void st_shared32(unsigned char* sm, uint32_t off, uint32_t v) {
  *reinterpret_cast<uint32_t*>(sm + off) = v;
}
__device__ __forceinline__ uint32_t ld_shared32(const unsigned char* sm, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(sm + off);
}
__device__ __forceinline__ float rb(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
// The activations with the fast exponential and logarithm (ex2, lg2 and rcp
// on the special-function unit): their error, a few f32 ulps, is far below
// the bf16 rounding that follows.  The accurate expf, log1pf and division of
// tile_mma.cuh cost 40 % of this kernel's time.
__device__ __forceinline__ float act_silu(float x) { return __fdividef(x, 1.0f + __expf(-x)); }
__device__ __forceinline__ float act_ssp(float x) {
  return fmaxf(x, 0.0f) + __logf(1.0f + __expf(-fabsf(x))) - kLog2;
}

// A stage's packed results (row g and row g+8 of group j) kept until the
// product has ended, then stored into a tile image: hold[8c + 2j], [.. + 1].
__device__ __forceinline__ void store_hold(unsigned char* sm, uint32_t tile_off,
                                           const uint32_t (&hold)[64], int r_lo, int t) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * c + 8 * j + 2 * t;
      st_shared32(sm, tile_off + wg::img_off<2>(r_lo, col), hold[8 * c + 2 * j]);
      st_shared32(sm, tile_off + wg::img_off<2>(r_lo + 8, col), hold[8 * c + 2 * j + 1]);
    }
  }
}

// A node product on the N node rows (a tile image with atoms a_stride apart):
// the two warpgroups take alternate 32-column stages.
template <typename Epi>
__device__ __forceinline__ void node_product(wg::Ring& ring, int w, uint32_t a_img,
                                             uint32_t a_stride, Epi epi) {
  float acc[16];
#pragma unroll
  for (int c = 0; c < kStagesPerMat; ++c) {
    const uint32_t bs = ring.acquire();
    if ((c & 1) == w) {
      wg::wgmma_fence();
      wg::mma_stage_bf16(acc, a_img, a_stride, bs, true);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_operand(acc);
      ring.release();
      epi(c, acc);
    } else {
      ring.release();
    }
  }
}


// Start of an interaction block: agg = 0 and xh = rnd(h l1w) as N plain rows
// (only the aggregation reads it).  Ends with a barrier of the consumers.
__device__ __forceinline__ void block_begin(wg::Ring& ring, unsigned char* sm, uint32_t base,
                                            const GraphSmem& lay, float* agg, int w, int tid,
                                            int r_lo, int t, int N) {
  for (int idx = tid; idx < N * kH / 4; idx += wg::kConsumers)
    reinterpret_cast<float4*>(agg)[idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  node_product(ring, w, base + lay.h, lay.node_stride, [&](int c, float (&acc)[16]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * c + 8 * j + 2 * t;
      if (r_lo < N)
        st_shared32(sm, lay.xh + (r_lo * kH + col) * 2, wg::pack_bf16(acc[4 * j], acc[4 * j + 1]));
      if (r_lo + 8 < N)
        st_shared32(sm, lay.xh + ((r_lo + 8) * kH + col) * 2,
                    wg::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
    }
  });
  wg::bar_sync(kBarConsumers, wg::kConsumers);
}

// The symmetric aggregation of tile pair tp's rows, the w tiles in the B tiles
// of the two warpgroups (the caller has put a barrier of the consumers before
// and puts one after).  A warpgroup takes half the nodes, a thread two
// feature columns of four nodes at a time: it adds what node n receives,
// offsets k in order, the pair {n, n+k} before {n-k, n}, in registers.  No two
// threads touch one entry and the order is fixed: the f32 sums are the same
// in every run.  The product of two bf16 values rounded once to bf16 is
// __hmul2's; a row outside the pair's range adds w = 0 from a valid address,
// so no branch separates the loads of the four nodes.
__device__ __forceinline__ void aggregate_pair(unsigned char* sm, const GraphSmem& lay, float* agg,
                                               int tp, int w, int ct, int N, int R) {
  const int pr0 = 128 * tp, nrows = min(R, pr0 + 128) - pr0;
  const int k_lo = pr0 / N + 1, k_hi = (pr0 + nrows - 1) / N + 1, half = N / 2;
  const uint32_t w_col = lay.tiles + wg::kTileBytes + (ct >> 5) * wg::kAtomBytes + (ct & 3) * 4;
  const uint32_t w_unit = (ct >> 2) & 7, x_col = lay.xh + 4 * ct;
  auto term = [&](float2& v, int pr, int other) {
    const bool in = (unsigned)(pr - pr0) < (unsigned)nrows;
    const uint32_t q = in ? pr - pr0 : 0;  // row q & 63 of warpgroup q >> 6's tile B
    const uint32_t wraw = ld_shared32(sm, w_col + (q >> 6) * (2 * wg::kTileBytes) +
                                              (q & 63) * 128 + (((q & 7) ^ w_unit) << 4));
    const uint32_t w2 = in ? wraw : 0u, x2 = ld_shared32(sm, x_col + other * (2 * kH));
    const float2 pv = __bfloat1622float2(__hmul2(*reinterpret_cast<const __nv_bfloat162*>(&w2),
                                                 *reinterpret_cast<const __nv_bfloat162*>(&x2)));
    v.x += pv.x;
    v.y += pv.y;
  };
  for (int n0 = w * half; n0 < (w + 1) * half; n0 += 4) {
    float2 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = *reinterpret_cast<const float2*>(agg + (n0 + u) * kH + 2 * ct);
    for (int k = k_lo; k <= k_hi; ++k) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + u;
        const int j = n + k < N ? n + k : n + k - N;  // row (k, n) is the pair {n, j}
        const int i = n - k < 0 ? n - k + N : n - k;  // row (k, i) is the pair {i, n}
        term(v[u], (k - 1) * N + n, j);
        term(v[u], (k - 1) * N + i, i);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float2*>(agg + (n0 + u) * kH + 2 * ct) = v[u];
  }
}

// The dense aggregation of tile pair tp's rows p = i*N + j, the w tiles in
// the A tiles of the two warpgroups (the caller has put a barrier of the
// consumers before and puts one after).  A warpgroup takes half the receiving
// nodes j, a thread two feature columns of four nodes at a time: it adds the
// sources i whose row lies in the pair, in ascending order, in registers.  No
// two threads touch one entry and the order is fixed: every node sums its N
// sources in ascending i, the same f32 sums in every run.  The product of two
// bf16 values rounded once to bf16 is __hmul2's; a row outside the pair adds
// w = 0 from a valid address, so no branch separates the four nodes' loads.
__device__ __forceinline__ void aggregate_dense_pair(unsigned char* sm, const GraphSmem& lay,
                                                     float* agg, int tp, int w, int ct, int N,
                                                     int P) {
  const int pr0 = 128 * tp, nrows = min(P, pr0 + 128) - pr0;
  const int i_lo = pr0 / N, i_hi = (pr0 + nrows - 1) / N, half = N / 2;
  const uint32_t w_col = lay.tiles + (ct >> 5) * wg::kAtomBytes + (ct & 3) * 4;
  const uint32_t w_unit = (ct >> 2) & 7, x_col = lay.xh + 4 * ct;
  for (int n0 = w * half; n0 < (w + 1) * half; n0 += 4) {
    float2 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = *reinterpret_cast<const float2*>(agg + (n0 + u) * kH + 2 * ct);
    for (int i = i_lo; i <= i_hi; ++i) {
      const uint32_t x2 = ld_shared32(sm, x_col + i * (2 * kH));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pr = i * N + n0 + u;
        const bool in = (unsigned)(pr - pr0) < (unsigned)nrows;
        const uint32_t q = in ? pr - pr0 : 0;  // row q & 63 of warpgroup q >> 6's tile A
        const uint32_t wraw = ld_shared32(sm, w_col + (q >> 6) * (2 * wg::kTileBytes) +
                                                  (q & 63) * 128 + (((q & 7) ^ w_unit) << 4));
        const uint32_t w2 = in ? wraw : 0u;
        const float2 pv =
            __bfloat1622float2(__hmul2(*reinterpret_cast<const __nv_bfloat162*>(&w2),
                                       *reinterpret_cast<const __nv_bfloat162*>(&x2)));
        v[u].x += pv.x;
        v[u].y += pv.y;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float2*>(agg + (n0 + u) * kH + 2 * ct) = v[u];
  }
}

// End of an interaction block: h += rnd(ssp(rnd(rnd(agg) l2w + l2b)) ow + ob).
// The B tiles are free between two tile loops: rnd(agg) goes to warpgroup 0's,
// the ssp to warpgroup 1's.  Starts after, and ends with, a barrier of the
// consumers.
__device__ __forceinline__ void node_update(wg::Ring& ring, unsigned char* sm, uint32_t base,
                                            const GraphSmem& lay, const float* agg,
                                            const bf16* l2b, const bf16* ob, int w, int tid,
                                            int r_lo, int t, int N) {
  const uint32_t ns = lay.node_stride, r_hi = r_lo + 8;
  const uint32_t t_off = lay.tiles + wg::kTileBytes, u_off = lay.tiles + 3 * wg::kTileBytes;
  for (int idx = tid; idx < N * (kH / 2); idx += wg::kConsumers) {
    const int row = idx >> 7, cp = idx & 127;
    const float2 v = *reinterpret_cast<const float2*>(agg + row * kH + 2 * cp);
    st_shared32(sm, t_off + wg::img_off<2>(row, 2 * cp, ns), wg::pack_bf16(v.x, v.y));
  }
  wg::fence_async_shared();
  wg::bar_sync(kBarConsumers, wg::kConsumers);
  node_product(ring, w, base + t_off, ns, [&](int c, float (&acc)[16]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * c + 8 * j + 2 * t;
      const float2 bias = ld2(l2b, col);
      if (r_lo < N)
        st_shared32(sm, u_off + wg::img_off<2>(r_lo, col, ns),
                    wg::pack_bf16(act_ssp(rb(acc[4 * j] + bias.x)),
                                  act_ssp(rb(acc[4 * j + 1] + bias.y))));
      if (r_hi < N)
        st_shared32(sm, u_off + wg::img_off<2>(r_hi, col, ns),
                    wg::pack_bf16(act_ssp(rb(acc[4 * j + 2] + bias.x)),
                                  act_ssp(rb(acc[4 * j + 3] + bias.y))));
    }
  });
  wg::fence_async_shared();
  wg::bar_sync(kBarConsumers, wg::kConsumers);
  node_product(ring, w, base + u_off, ns, [&](int c, float (&acc)[16]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * c + 8 * j + 2 * t;
      const float2 bias = ld2(ob, col);
      if (r_lo < N) {
        const uint32_t off = lay.h + wg::img_off<2>(r_lo, col, ns);
        const float2 h0 = wg::unpack_bf16(ld_shared32(sm, off));
        st_shared32(sm, off, wg::pack_bf16(h0.x + rb(acc[4 * j] + bias.x),
                                           h0.y + rb(acc[4 * j + 1] + bias.y)));
      }
      if (r_hi < N) {
        const uint32_t off = lay.h + wg::img_off<2>(r_hi, col, ns);
        const float2 h0 = wg::unpack_bf16(ld_shared32(sm, off));
        st_shared32(sm, off, wg::pack_bf16(h0.x + rb(acc[4 * j + 2] + bias.x),
                                           h0.y + rb(acc[4 * j + 3] + bias.y)));
      }
    }
  });
  wg::fence_async_shared();
  wg::bar_sync(kBarConsumers, wg::kConsumers);
}

// The cutoff of a pair row as the filter multiplies it: B2's is f32 and
// rounded to bf16 here, the SchNet stack's is bf16 already.
__device__ __forceinline__ float cutoff_value(float c) { return rb(c); }
__device__ __forceinline__ float cutoff_value(bf16 c) { return __bfloat162float(c); }

// One interaction block of a dense kernel (B2, the SchNet stack's forward)
// on the graph's 64-row pair tiles, which the producer brings into the
// warpgroups' A tiles (afull, aempty: per warpgroup; afp: the parity of this
// warpgroup's next wait on afull), weight stages l1w, per tile pair f1w and
// f2w, then l2w and ow:
//   xh = rnd(h l1w); per tile pair s1 = rnd(ssp(rnd(ea f1w + f1b))) into
//   tile B, w = rnd(rnd(s1 f2w + f2b) * c) into tile A, then agg[j] +=
//   rnd(w[i*N+j] xh[i]); h += rnd(ssp(rnd(rnd(agg) l2w + l2b)) ow + ob).
// w is the consumer's warpgroup, tid its thread (0..255).  Starts after, and
// ends with, a barrier of the consumers.
template <typename C>
__device__ __forceinline__ void interaction_block(wg::Ring& ring, unsigned char* sm, uint32_t base,
                                                  const GraphSmem& lay, float* agg, const C* c_g,
                                                  const bf16* f1b, const bf16* f2b,
                                                  const bf16* l2b, const bf16* ob, uint32_t afull,
                                                  uint32_t aempty, uint32_t& afp, int w, int tid,
                                                  int N) {
  const int P = N * N, ntiles = P / 64, npairs = (ntiles + 1) / 2;
  const int ct = tid & 127, t = tid & 3, r_lo = ((ct >> 5) << 4) + ((tid & 31) >> 2);
  const int r_hi = r_lo + 8;
  const bool elected = ct == 0;
  const uint32_t ta_off = lay.tiles + 2 * w * wg::kTileBytes, tb_off = ta_off + wg::kTileBytes;
  uint32_t hold[64];  // product_bf16's kept registers: unused here (kKeep false)
  WG_T(wg::kProfNodeProducts, block_begin(ring, sm, base, lay, agg, w, tid, r_lo, t, N));

  for (int tp = 0; tp < npairs; ++tp) {
    const int ti = 2 * tp + w, r0 = ti * 64;
    const bool active = ti < ntiles;
    float c_lo = 0.0f, c_hi = 0.0f;
    if (active) {
      c_lo = cutoff_value(c_g[r0 + r_lo]);
      c_hi = cutoff_value(c_g[r0 + r_hi]);
      WG_T(wg::kProfTileWait, wg::mbar_wait(afull + 8 * w, afp));
      afp ^= 1;
    }
    // s1 = rnd(ssp(rnd(ea f1w + f1b))), tile A into tile B
    wg::product_bf16<kStagesPerMat, false, false>(
        ring, active, base + ta_off, 0, wg::kAtomBytes, hold,
        [&](int c, float (&acc)[16], uint32_t (&)[8]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * c + 8 * j + 2 * t;
            const float2 bias = ld2(f1b, col);
            st_shared32(sm, tb_off + wg::img_off<2>(r_lo, col),
                        wg::pack_bf16(act_ssp(rb(acc[4 * j] + bias.x)),
                                      act_ssp(rb(acc[4 * j + 1] + bias.y))));
            st_shared32(sm, tb_off + wg::img_off<2>(r_hi, col),
                        wg::pack_bf16(act_ssp(rb(acc[4 * j + 2] + bias.x)),
                                      act_ssp(rb(acc[4 * j + 3] + bias.y))));
          }
        });
    if (active) {  // s1 visible to wgmma; every warp's reads of tile A have ended
      wg::fence_async_shared();
      wg::bar_sync(kBarWg0 + w, 128);
    }
    // w = rnd(rnd(s1 f2w + f2b) * c) into tile A, which f1w has finished reading
    wg::product_bf16<kStagesPerMat, false, false>(
        ring, active, base + tb_off, 0, wg::kAtomBytes, hold,
        [&](int c, float (&acc)[16], uint32_t (&)[8]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * c + 8 * j + 2 * t;
            const float2 bias = ld2(f2b, col);
            st_shared32(sm, ta_off + wg::img_off<2>(r_lo, col),
                        wg::pack_bf16(rb(acc[4 * j] + bias.x) * c_lo,
                                      rb(acc[4 * j + 1] + bias.y) * c_lo));
            st_shared32(sm, ta_off + wg::img_off<2>(r_hi, col),
                        wg::pack_bf16(rb(acc[4 * j + 2] + bias.x) * c_hi,
                                      rb(acc[4 * j + 3] + bias.y) * c_hi));
          }
        });
    wg::bar_sync(kBarConsumers, wg::kConsumers);  // both w tiles are written
    WG_T(wg::kProfAggregate, aggregate_dense_pair(sm, lay, agg, tp, w, ct, N, P));
    // the w tiles are read, agg is whole; the generic stores into tile A are
    // ordered before the bulk copy that refills it
    wg::fence_async_shared();
    wg::bar_sync(kBarConsumers, wg::kConsumers);
    if (active && elected) wg::mbar_arrive(aempty + 8 * w);  // tile A takes the next ea tile
  }

  WG_T(wg::kProfNodeProducts, node_update(ring, sm, base, lay, agg, l2b, ob, w, tid, r_lo, t, N));
}

// Per-row symmetric int8 of a product's results on the fragment's positions
// (rows g and g+8 of a thread): a row lives in the four lanes of a quad, so
// its maximum is the thread's own and two shuffles.  s = max(max|x|, 1e-12) / 127 and q = rint(x / s), ties to
// even, a true division: bit for bit the plain version's.  The codes go to
// the s8 tile image at tile_off, two a store; the scales stay in registers.
__device__ __forceinline__ float quad_max(float m) {
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}
// rint(x / s) of the true division, without dividing where that is safe: x
// times the rounded reciprocal of s is within 2e-5 of the quotient (|q| <=
// 127), so away from a tie (fraction within 1e-3 of 0.5) both round to the
// same integer; next to a tie the division is done.
__device__ __forceinline__ int code(float x, float s, float inv) {
  float y = x * inv;
  if (fabsf(y - floorf(y) - 0.5f) < 1e-3f) y = __fdiv_rn(x, s);
  return __float2int_rn(y);
}
__device__ __forceinline__ float scale_inv(float s) { return __fdiv_rn(1.0f, s); }
__device__ __forceinline__ uint32_t code2(float2 x, float s, float inv) {
  return (uint32_t)(uint8_t)(int8_t)code(x.x, s, inv) |
         (uint32_t)(uint8_t)(int8_t)code(x.y, s, inv) << 8;
}
__device__ __forceinline__ void st_shared16(unsigned char* sm, uint32_t off, uint32_t v) {
  *reinterpret_cast<uint16_t*>(sm + off) = (uint16_t)v;
}
__device__ __forceinline__ float row_scale(float m) { return __fdiv_rn(fmaxf(m, 1e-12f), 127.0f); }
// src_off is a bf16 tile image holding the values where this thread's
// epilogue stored them (so no barrier is needed between the two), dst_off the
// s8 tile image of the codes.
// Not inlined, and its loops over the stages rolled: ten call sites of 128
// guarded divisions each took the build to ten minutes.
__device__ __noinline__ void quantize_tile(unsigned char* sm, uint32_t src_off, uint32_t dst_off,
                                           int r_lo, int t, float& s_lo, float& s_hi) {
  float m_lo = 0.0f, m_hi = 0.0f;
#pragma unroll 1
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * c + 8 * j + 2 * t;
      const float2 lo = wg::unpack_bf16(ld_shared32(sm, src_off + wg::img_off<2>(r_lo, col)));
      const float2 hi = wg::unpack_bf16(ld_shared32(sm, src_off + wg::img_off<2>(r_lo + 8, col)));
      m_lo = fmaxf(m_lo, fmaxf(fabsf(lo.x), fabsf(lo.y)));
      m_hi = fmaxf(m_hi, fmaxf(fabsf(hi.x), fabsf(hi.y)));
    }
  }
  s_lo = row_scale(quad_max(m_lo));
  s_hi = row_scale(quad_max(m_hi));
  const float inv_lo = scale_inv(s_lo), inv_hi = scale_inv(s_hi);
#pragma unroll 1
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * c + 8 * j + 2 * t;
      const float2 lo = wg::unpack_bf16(ld_shared32(sm, src_off + wg::img_off<2>(r_lo, col)));
      const float2 hi = wg::unpack_bf16(ld_shared32(sm, src_off + wg::img_off<2>(r_lo + 8, col)));
      st_shared16(sm, dst_off + wg::img_off<1>(r_lo, col), code2(lo, s_lo, inv_lo));
      st_shared16(sm, dst_off + wg::img_off<1>(r_lo + 8, col), code2(hi, s_hi, inv_hi));
    }
  }
}

// Barriers, the packed-row table (row -> i, j = (i + k) % N, k = row / N + 1)
// and the node states as a tile image; every thread of the CTA, then a
// __syncthreads.
__device__ __forceinline__ void cta_setup(unsigned char* sm, uint32_t base, const GraphSmem& lay,
                                          const bf16* z, int N) {
  const int tid = threadIdx.x, R = (N / 2) * N;
  const uint32_t full = base + lay.bars, empty = full + 8 * wg::kMaxStages;
  const uint32_t afull = empty + 8 * wg::kMaxStages, aempty = afull + 16;
  if (tid == 0) {
    wg::ring_init(full, empty, lay.stages);
    for (int w = 0; w < 2; ++w) {
      wg::mbar_init(afull + 8 * w, 1);
      wg::mbar_init(aempty + 8 * w, 1);
    }
    wg::mbar_init_fence();
  }
  unsigned char* tab = sm + lay.tab;
  for (int r = tid; r < R; r += wg::kThreads) {
    const int k = r / N + 1, i = r - (k - 1) * N;
    tab[2 * r] = (unsigned char)i;
    tab[2 * r + 1] = (unsigned char)(i + k < N ? i + k : i + k - N);
  }
  for (int idx = tid; idx < N * 32; idx += wg::kThreads) {
    const int row = idx >> 5, unit = idx & 31;
    *reinterpret_cast<uint4*>(sm + lay.h + wg::img_off<2>(row, unit * 8, lay.node_stride)) =
        *reinterpret_cast<const uint4*>(z + (size_t)row * kH + unit * 8);
  }
  wg::fence_async_shared();
  __syncthreads();
}

}  // namespace wgb

// The profile's slots for the host: 0 on success.  reset != 0 clears them.
#ifdef WG_PROFILE
#define WG_PROFILE_ENTRY(name)                                                        \
  extern "C" int name(unsigned long long* out, int reset) {                            \
    if (reset) {                                                                      \
      const unsigned long long zero[wg::kProfSlots] = {};                             \
      return (int)cudaMemcpyToSymbol(wg::g_prof, zero, sizeof(zero));                 \
    }                                                                                 \
    return (int)cudaMemcpyFromSymbol(out, wg::g_prof, sizeof(wg::g_prof));             \
  }
#else
#define WG_PROFILE_ENTRY(name)
#endif
