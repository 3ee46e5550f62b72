// Flash attention (online softmax) for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py:34 (wrapper `flash_attention`,
// pallas_call at :157).
//
// What it computes, for q (B, Hq, Lq, D) and k, v (B, Hkv, Lkv, D), each
// read by strides (the head_dim stride must be 1), in float32 or bfloat16:
//   s    = (q . k) * scale, then softcap * tanh(s / softcap) if softcap > 0;
//   mask: key < Lkv, and key <= qpos if causal, and key > qpos - window if
//         window > 0, with qpos = row + (Lkv - Lq) (the last query sees
//         the last key: decode alignment); masked scores are -1e30;
//   out  = softmax(s) v, by the running max m, denominator l and
//          accumulator acc in float32, then acc / max(l, 1e-30) cast to
//          q's type.
// The kv head of query head h is h / (Hq / Hkv), by index: K and V are
// never repeated.
//
// The -1e30 sentinel is the reference's on purpose.  A row whose keys in a
// visited tile are all masked, before any tile with a visible key, gets
// m = -1e30 and p = exp(-1e30 - -1e30) = 1 for every masked key, so it
// briefly averages masked keys (zeros past Lkv); the first tile with a
// visible key has alpha = exp(-1e30 - m_new) = 0 and wipes that out.  With
// -INFINITY the same row would give exp(-inf - -inf) = NaN.  Every row has
// a visible key (the wrapper requires Lq <= Lkv and window >= 1), so the
// output is the exact masked softmax whatever the tiling.  Exponents are
// taken of (x - m), which is exactly 0 for x = m = -1e30.
//
// Both bodies loop, inside one block per (q tile, query head, batch), over
// exactly the kv tiles the causal and window tests can reach: from the
// tile holding key q_lo - window + 1 to the tile holding key q_hi (causal)
// or the last one, where q_lo and q_hi are the positions of the tile's
// first and last rows.  That loop takes the place of the TPU's sequential
// fourth grid dimension.
//
// Bound: operations.  At the LM path's shape (B 2, Hq 32, Hkv 8, L 8192,
// D 80, causal, window 4096, bf16) the visible (query, key) pairs need
// 4 B Hq D * 25,167,872 = 5.15e11 flops, 0.52 ms at the tensor cores' 989
// TFLOP/s, against 0.063 ms for the 210 MB of q, k, v and out.
//
// bfloat16 (the model's type): `flash_fwd_wgmma`, Hopper's warpgroup
// tensor cores fed by TMA.  The first bf16 body ran mma.sync m16n8k16 from
// registers (91 TFLOP/s): K and V were loaded synchronously through
// registers, V was transposed into shared memory element by element, and
// two __syncthreads per kv tile kept every load from overlapping a
// product.  This body:
//   * 3 warpgroups: two consumers of 64 query rows each (a 128-row q
//     tile) and one producer, whose one thread issues TMA loads of the Q
//     tile and of K and V tiles into a 3-stage ring with full / empty
//     mbarriers.  The producer gives up registers (setmaxnreg 40) to the
//     consumers (232).
//   * S = Q K^T by wgmma.mma_async m64nBKk16 (BK = 128 keys, 64 for D =
//     128) with both operands in shared memory; P V by m64nDk16 with P in
//     registers (S's accumulator fragments, rounded to bf16: the rounding
//     every tensor-core flash kernel makes; l sums the unrounded p) and V
//     as the B operand through wgmma's transpose bit: V is never
//     transposed by a thread.
//   * Layout.  A bf16 row of D = 80 is 160 bytes, no multiple of the
//     128-byte swizzle span.  Every operand tile is therefore stored as
//     D / 16 column panels of [rows][16] bf16 with the 32-byte swizzle:
//     one 2-D TMA box of 16 x rows per panel.  A panel is at once the
//     K-major layout wgmma wants for Q and K (8-row groups 256 bytes
//     apart) and the MN-major layout it wants for V (16-wide d groups one
//     panel apart, 8-key groups 256 bytes apart), so one layout serves all
//     three operands with no padding of D (padding 80 to 96 or 128 would
//     cost 20-60% more Q K^T work) and no bank conflicts (the 32-byte
//     swizzle spreads a core matrix's 8 rows over all 32 banks).
//   * The tensor maps are 4-D (d, row, head, batch) views of the strided
//     (B, H, L, D) tensors, so the model's transposed (B, L, H, D)
//     projections go in without a copy; TMA zero-fills rows past Lq and
//     Lkv.  TMA needs 16-byte aligned pointers and strides: the wrapper
//     copies inputs that are not.
//   * Inside a warpgroup the kv loop is software-pipelined: S_i = Q K_i^T
//     and O += P_{i-1} V_{i-1} are issued together, and the softmax of S_i
//     runs while P_{i-1} V_{i-1} is still on the tensor cores.  Across the
//     two warpgroups a ping-pong of named barriers makes them take turns
//     to issue, so one's softmax runs beside the other's products.
//   * The softmax is the limit at D = 80 (one exp per score against 320
//     flops of products), so it is kept lean: scores are scaled into the
//     log2 domain once, exponentials are single ex2.approx instructions,
//     the softcap and mask are chosen per tile outside the score loop (a
//     branch per score is if-converted into tanh and mask work for every
//     score), and row maxima and sums run as four independent chains.
//   * q tiles run heaviest first (the last q tile sees the most keys), and
//     a tile that no mask reaches skips the mask.
//   Measured (chip_smoke.py, phase timing, at the LM path's shape):
//   1.224 ms, 43% of the 0.521 ms bound, against 5.693 ms for the
//   mma.sync body and 7.020 ms for scaled_dot_product_attention, on an
//   NVIDIA H100 80GB HBM3, 700.00 W.  168 registers at entry (the
//   consumers take 232), no spills.
//
// float32 (the reference's kernel configs): `flash_fwd_f32`, both products
// as f32 FMAs on the CUDA cores (64 x 64 tiles), so f32 inputs are never
// rounded to a narrower type.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kcheck.cuh"  // KC_*: checks in the checked build, else nothing

namespace {

constexpr int kBQ = 64;                   // query rows per block (f32)
constexpr int kBK = 64;                   // keys per kv tile (f32)
constexpr int kTX = 16, kTY = 16;         // thread grid (f32)
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;          // score rows per thread
constexpr int kCols = kBK / kTX;          // keys per thread
constexpr int kPP = kBK + 1;              // padded P row
constexpr float kNegInf = -1e30f;

struct Params {
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, ob, oh, ol;
  int group, Lq, Lkv, q_offset, causal, window;
  float softcap, scale;
};

// ---------------------------------------------------------------------------
// float32 inputs: both products as float32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Params p) {
  constexpr int DP = D + 1;               // odd row length
  constexpr int DC = D / kTX;             // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                       // [kBQ][DP]
  float* ks = qs + kBQ * DP;              // [kBK][DP]
  float* vs = ks + kBK * DP;              // [kBK][DP]
  float* ps = vs + kBK * DP;              // [kBQ][kPP]

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int row0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / p.group;
  const int nrows = min(kBQ, p.Lq - row0);
  const int q_lo = row0 + p.q_offset;     // position of the first row
  const int q_hi = q_lo + nrows - 1;      // and of the last one

  const float* qp = q + b * p.qb + hq * p.qh + (long long)row0 * p.ql;
  const float* kp = k + b * p.kb + hk * p.kh;
  const float* vp = v + b * p.vb + hk * p.vh;
  float* op = o + b * p.ob + hq * p.oh + (long long)row0 * p.ol;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    if (r < nrows) KC_LD(&qp[r * p.ql + c], sizeof(float));
    KC_SH(&qs[r * DP + c], sizeof(float));
    qs[r * DP + c] = r < nrows ? qp[r * p.ql + c] : 0.f;
  }

  // the kv tiles some row of this q tile can see
  int kt_first = 0, kt_last = (p.Lkv - 1) / kBK;
  if (p.causal) kt_last = min(kt_last, q_hi / kBK);
  if (p.window > 0) kt_first = max(0, q_lo - p.window + 1) / kBK;

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    const int nk = min(kBK, p.Lkv - k0);
    KC_JITTER(kt);
    __syncthreads();                      // the last tile's K, V, P are read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = r < nk;
      const long long key = k0 + r;
      if (in) {
        KC_LD(&kp[key * p.kl + c], sizeof(float));
        KC_LD(&vp[key * p.vl + c], sizeof(float));
      }
      KC_SH(&ks[r * DP + c], sizeof(float));
      KC_SH(&vs[r * DP + c], sizeof(float));
      ks[r * DP + c] = in ? kp[key * p.kl + c] : 0.f;
      vs[r * DP + c] = in ? vp[key * p.vl + c] : 0.f;
    }
    KC_JITTER(kt);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kTY * i) * DP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + kTX * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q_lo + ty + kTY * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + kTX * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool keep = kpos < p.Lkv;
        if (p.causal) keep = keep && kpos <= qpos;
        if (p.window > 0) keep = keep && kpos > qpos - p.window;
        s[i][j] = keep ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pj = expf(s[i][j] - m_new);
        KC_SH(&ps[(ty + kTY * i) * kPP + tx + kTX * j], sizeof(float));
        ps[(ty + kTY * i) * kPP + tx + kTX * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    KC_JITTER(kt);
    __syncthreads();                      // P complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + kTY * i) * kPP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = vs[j * DP + tx + kTX * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + kTY * i;
    if (r >= nrows) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      KC_ST(&op[r * p.ol + tx + kTX * c], sizeof(float));
      op[r * p.ol + tx + kTX * c] = acc[i][c] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 inputs: wgmma on tiles that TMA brings in
// ---------------------------------------------------------------------------

constexpr int kQT = 128;                  // query rows per block
constexpr int kWgThreads = 384;           // 2 consumer + 1 producer warpgroups
constexpr int kKvStages = 3;
constexpr int kPanelBytes = 32;           // one [row][16] bf16 panel row
// >= half of the SM's 227 KB: one block per SM, which setmaxnreg's
// register hand-over between the warpgroups relies on
constexpr int kMinSmem = 120 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct FlashTile {
  static constexpr int BK = D <= 80 ? 128 : 64;     // keys per kv tile
  static constexpr int NC = D / 16;                 // 16-wide d panels
  static constexpr int kQBytes = NC * kQT * kPanelBytes;
  static constexpr int kKvBytes = NC * BK * kPanelBytes;   // K or V tile
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kKvStages * kKvBytes + 8 * (1 + 2 * kKvStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  KC_SH(bar, sizeof(uint64_t));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  KC_SH(bar, sizeof(uint64_t));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  KC_SH(bar, sizeof(uint64_t));
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  KC_SH(bar, sizeof(uint64_t));
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// one box of the 4-D tensor map at (d, row, head, batch) into dst;
// completion is counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int d, int row, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(d),
         "r"(row), "r"(h), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 32-byte-swizzled panel: start
// address, leading and stride byte offsets (16-byte units), layout 3 (B32)
__device__ __forceinline__ uint64_t desc_b32(const void* p, uint32_t lbo,
                                             uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)3 << 62);
}

// 2^x on the special-function unit (0 for x = -1.4e30, 1 for x = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barriers (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses to accumulator registers across
// the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D (64 x N, f32) = A (64 x 16) B (16 x N) (+ D if accumulate), A and B
// K-major in shared memory.  Accumulator fragments (warp w of the
// warpgroup, g = lane / 4, t = lane % 4): d[4j + e] is row 16w + g + 8 (e /
// 2), column 8j + 2t + e % 2.
template <int N>
__device__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate);

// D (64 x N, f32) += A (64 x 16, bf16 registers) B (16 x N), B MN-major in
// shared memory (transpose bit set).  a holds rows g, g + 8 and columns
// 2t, 2t + 1, 2t + 8, 2t + 9 of this warp's 16 rows, as mma.sync m16n8k16.
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// scores of one kv tile in the log2 domain, in place: y = s * y_scale,
// capped (y_cap tanh y) and masked to the sentinel where the template says;
// mx0 / mx1 are this thread's maxima of its rows g and g + 8.  The two
// options are template parameters so that no score pays for a branch it
// does not take (if-converted, tanh and the mask would run on every score).
template <bool kCap, bool kMask, int NS>
__device__ __forceinline__ void scores(float* sc, const Params& p,
                                       float y_scale, float y_cap, int k0,
                                       int t, int qpos0, float& mx0,
                                       float& mx1) {
  // four independent max chains per row (two warps per scheduler leave
  // little to hide a serial chain's latency behind)
  float a0[4], a1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a0[i] = a1[i] = kNegInf;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = sc[4 * j + e] * y_scale;
      if (kCap) y = y_cap * tanhf(y);
      if (kMask) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const int qpos = qpos0 + (e < 2 ? 0 : 8);
        bool keep = kpos < p.Lkv;
        if (p.causal) keep = keep && kpos <= qpos;
        if (p.window > 0) keep = keep && kpos > qpos - p.window;
        y = keep ? y : kNegInf;
      }
      sc[4 * j + e] = y;
    }
    a0[j % 4] = fmaxf(a0[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
    a1[j % 4] = fmaxf(a1[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(fmaxf(a0[0], a0[1]), fmaxf(a0[2], a0[3]));
  mx1 = fmaxf(fmaxf(a1[0], a1[1]), fmaxf(a1[2], a1[3]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, Params p) {
  using T = FlashTile<D>;
  constexpr int BK = T::BK, NC = T::NC;
  constexpr int NS = BK / 8;              // n-blocks of S
  constexpr int ND = D / 8;               // n-blocks of O
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;                                   // [NC][kQT][16]
  uint8_t* k_s = q_s + T::kQBytes;                       // [stage][NC][BK][16]
  uint8_t* v_s = k_s + kKvStages * T::kKvBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kKvStages * T::kKvBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kKvStages;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest q tiles first
  const int row0 = qt * kQT;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / p.group;
  const int nrows = min(kQT, p.Lq - row0);
  const int q_lo = row0 + p.q_offset;
  const int q_hi = q_lo + nrows - 1;
  int kt_first = 0, kt_last = (p.Lkv - 1) / BK;
  if (p.causal) kt_last = min(kt_last, q_hi / BK);
  if (p.window > 0) kt_first = max(0, q_lo - p.window + 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  KC_JITTER(0);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < NC; ++c) {
        KC_SH(q_s + c * kQT * kPanelBytes, kQT * kPanelBytes);
        tma_load(q_s + c * kQT * kPanelBytes, &tq, 16 * c, row0, hq, b,
                 q_full);
      }
      for (int kt = kt_first, i = 0; kt <= kt_last; ++kt, ++i) {
        const int s = i % kKvStages, ph = (i / kKvStages) & 1;
        KC_JITTER(i);
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], 2 * T::kKvBytes);
        uint8_t* ks = k_s + s * T::kKvBytes;
        uint8_t* vs = v_s + s * T::kKvBytes;
        for (int c = 0; c < NC; ++c) {
          const int off = c * BK * kPanelBytes;
          KC_SH(ks + off, BK * kPanelBytes);
          KC_SH(vs + off, BK * kPanelBytes);
          tma_load(ks + off, &tk, 16 * c, kt * BK, hk, b, &full[s]);
          tma_load(vs + off, &tv, 16 * c, kt * BK, hk, b, &full[s]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) ----
    //
    // Software pipeline over the kv tiles: S_i = Q K_i^T and O += P_{i-1}
    // V_{i-1} are issued together; the softmax of S_i runs while P_{i-1}
    // V_{i-1} is still on the tensor cores, and only then is O rescaled
    // and stage i - 1 handed back to the producer.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
    const int g = lane / 4, t = lane % 4;
    const int wq_lo = q_lo + 64 * wg;     // position of the warpgroup's row 0
    const int qpos0 = wq_lo + 16 * w + g;   // position of row g (g + 8: +8)
    // scores in the log2 domain: y = x log2(e), with the running max m in
    // the same units, so exp2(y - m) is the reference's exp(x - m); the
    // -1e30 sentinel keeps its meaning
    const float ys = p.softcap > 0.f ? p.scale / p.softcap
                                     : p.scale * kLog2e;
    const float yc = p.softcap * kLog2e;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    float acc[ND * 4], sc[NS * 4];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < ND * 4; ++i) acc[i] = 0.f;

    auto issue_s = [&](int s) {
      const uint8_t* ks = k_s + s * T::kKvBytes;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        KC_SH(q_s + (c * kQT + 64 * wg) * kPanelBytes, 64 * kPanelBytes);
        KC_SH(ks + c * BK * kPanelBytes, BK * kPanelBytes);
        wgmma_ss<BK>(sc,
                     desc_b32(q_s + (c * kQT + 64 * wg) * kPanelBytes, 16,
                              256),
                     desc_b32(ks + c * BK * kPanelBytes, 16, 256), c > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int s) {
      const uint8_t* vs = v_s + s * T::kKvBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 16 keys of every d panel: NC panels BK * 32 bytes apart
        KC_SH(vs + kk * 16 * kPanelBytes,
              (NC - 1) * BK * kPanelBytes + 16 * kPanelBytes);
        wgmma_rs<D>(acc, pa[kk],
                    desc_b32(vs + kk * 16 * kPanelBytes, BK * kPanelBytes,
                             256));
      }
      wgmma_commit();
    };
    // S of kv tile kt -> unnormalised probabilities in sc, running max and
    // sum updated; al0 / al1 get the rescale factors of O's two rows
    auto softmax = [&](int kt, float& al0, float& al1) {
      const int k0 = kt * BK;
      // no mask reaches this tile: every key is in range, in the past of
      // the warpgroup's first row and inside the window of its last row
      const bool full_tile = k0 + BK <= p.Lkv &&
                             (!p.causal || k0 + BK - 1 <= wq_lo) &&
                             (p.window <= 0 || k0 > wq_lo + 63 - p.window);
      float mx0, mx1;
      if (p.softcap > 0.f) {
        if (full_tile)
          scores<true, false, NS>(sc, p, ys, yc, k0, t, qpos0, mx0, mx1);
        else
          scores<true, true, NS>(sc, p, ys, yc, k0, t, qpos0, mx0, mx1);
      } else {
        if (full_tile)
          scores<false, false, NS>(sc, p, ys, yc, k0, t, qpos0, mx0, mx1);
        else
          scores<false, true, NS>(sc, p, ys, yc, k0, t, qpos0, mx0, mx1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      al0 = ex2(m0 - mn0);
      al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        sc[4 * j] = ex2(sc[4 * j] - mn0);
        sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn1);
        s0[j % 4] += sc[4 * j] + sc[4 * j + 1];
        s1[j % 4] += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * al0 + ((s0[0] + s0[1]) + (s0[2] + s0[3]));
      l1 = l1 * al1 + ((s1[0] + s1[1]) + (s1[2] + s1[3]));
    };
    // P (rounded to bf16) into the A fragments of P V: n-blocks 2kk and
    // 2kk + 1 of P are the fragment of k-step kk
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        pa[j / 2][2 * (j % 2)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };

    // ping-pong: the two warpgroups take turns to issue their products
    // (named barrier 1 + wg is this warpgroup's turn), so one's softmax
    // runs while the other's products hold the tensor cores
    auto turn_begin = [&]() { bar_sync(1 + wg, 256); };
    auto turn_end = [&]() { bar_arrive(2 - wg, 256); };
    if (wg == 1) bar_arrive(1, 256);      // warpgroup 0 goes first

    KC_JITTER(0);
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    float al0, al1;
    fence_regs<NS * 4>(sc);
    wgmma_fence();
    KC_JITTER(0);
    turn_begin();
    issue_s(0);
    turn_end();
    wgmma_wait<0>();
    fence_regs<NS * 4>(sc);
    softmax(kt_first, al0, al1);          // O is still zero: no rescale
    pack_p();
    for (int kt = kt_first + 1, i = 1; kt <= kt_last; ++kt, ++i) {
      const int s = i % kKvStages, ph = (i / kKvStages) & 1;
      const int prev = (i - 1) % kKvStages;
      KC_JITTER(i);
      mbar_wait(&full[s], ph);
      fence_regs<NS * 4>(sc);
      fence_regs<ND * 4>(acc);
      wgmma_fence();
      KC_JITTER(i);
      turn_begin();
      issue_s(s);
      issue_pv(prev);
      turn_end();
      wgmma_wait<1>();                    // S_i is in; P_{i-1} V_{i-1} runs on
      fence_regs<NS * 4>(sc);
      softmax(kt, al0, al1);
      wgmma_wait<0>();
      fence_regs<ND * 4>(acc);
      fence_regs<NS * 4>(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);   // this warp is done
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[4 * n] *= al0;
        acc[4 * n + 1] *= al0;
        acc[4 * n + 2] *= al1;
        acc[4 * n + 3] *= al1;
      }
      pack_p();
    }
    const int last = (kt_last - kt_first) % kKvStages;
    fence_regs<ND * 4>(acc);
    wgmma_fence();
    KC_JITTER(kt_last);
    turn_begin();
    issue_pv(last);
    turn_end();
    KC_JITTER(kt_last);
    if (wg == 0) bar_sync(1, 256);        // warpgroup 1's last hand-over
    wgmma_wait<0>();
    fence_regs<ND * 4>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[last]);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = 1.f / fmaxf(l0, 1e-30f), d1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* op = o + b * p.ob + hq * p.oh;
    const int r0 = 64 * wg + 16 * w + g, r1 = r0 + 8;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * t;
      if (r0 < nrows) {
        KC_ST(op + (long long)(row0 + r0) * p.ol + c, 2 * sizeof(*op));
        *reinterpret_cast<__nv_bfloat162*>(
            op + (long long)(row0 + r0) * p.ol + c) =
            __floats2bfloat162_rn(acc[4 * n] * d0, acc[4 * n + 1] * d0);
      }
      if (r1 < nrows) {
        KC_ST(op + (long long)(row0 + r1) * p.ol + c, 2 * sizeof(*op));
        *reinterpret_cast<__nv_bfloat162*>(
            op + (long long)(row0 + r1) * p.ol + c) =
            __floats2bfloat162_rn(acc[4 * n + 2] * d1, acc[4 * n + 3] * d1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                         12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a bf16 (B, H, L, D) tensor with element strides (sb, sh, sl, 1) as a 4-D
// tensor map (d, row, head, batch) with boxes of 16 d x `rows` rows,
// 32-byte swizzled; rows past L read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int L, int D,
              long long sb, long long sh, long long sl, int rows) {
  // the map's last element lies inside the tensor (TMA bounds the rest)
  KC_HOST_RANGE(ptr, 2 * (1 + (D - 1) + (L - 1) * sl + (H - 1) * sh +
                          (B - 1) * sb));
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {16, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const Params& prm, int B, int Hq, int Hkv, int Lq, int Lkv,
                cudaStream_t st) {
  using T = FlashTile<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Hq, Lq, D, prm.qb, prm.qh, prm.ql, kQT) ||
      !make_map(&tk, k, B, Hkv, Lkv, D, prm.kb, prm.kh, prm.kl, T::BK) ||
      !make_map(&tv, v, B, Hkv, Lkv, D, prm.vb, prm.vh, prm.vl, T::BK))
    return (int)cudaErrorInvalidValue;
  const int smem = T::kSmem > kMinSmem ? T::kSmem : kMinSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + kQT - 1) / kQT, Hq, B);
  flash_fwd_wgmma<D><<<grid, kWgThreads, smem, st>>>(
      tq, tk, tv, (__nv_bfloat16*)o, prm);
  return (int)cudaGetLastError();
}

template <int D>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           const Params& prm, int B, int Hq, int Hkv, int Lq, int Lkv,
           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return launch_bf16<D>(q, k, v, o, prm, B, Hq, Hkv, Lq, Lkv, st);
  const dim3 grid((Lq + kBQ - 1) / kBQ, Hq, B);
  const int smem = (int)sizeof(float) *
                   ((kBQ + 2 * kBK) * (D + 1) + kBQ * kPP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_f32<D><<<grid, kThreads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides (batch, head, row) of q, k, v and out, in
// that order; the head_dim stride of each is 1.  For bf16, every pointer of
// q, k, v is 16-byte aligned and each of their strides a multiple of 8
// (TMA's rule).  window 0 means none, softcap 0 means none.  Returns a
// cudaError_t (0 on a clean launch).
int flash_attention_fwd(int bf16, const void* q, const void* k,
                        const void* v, void* o, const long long* strides,
                        int B, int Hq, int Hkv, int Lq, int Lkv, int D,
                        int causal, int window, float softcap, float scale,
                        void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Lq < 1 || Lkv < Lq ||
      B > 65535 || Hq > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  const Params prm{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11],
                   Hq / Hkv, Lq, Lkv, Lkv - Lq, causal, window, softcap,
                   scale};
  const bool h = bf16 != 0;
  switch (D) {
    case 16: return launch<16>(h, q, k, v, o, prm, B, Hq, Hkv, Lq, Lkv, stream);
    case 80: return launch<80>(h, q, k, v, o, prm, B, Hq, Hkv, Lq, Lkv, stream);
    case 128:
      return launch<128>(h, q, k, v, o, prm, B, Hq, Hkv, Lq, Lkv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
