// Flash attention (online softmax) for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py:34 (wrapper `flash_attention`).
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
// output is the exact masked softmax whatever the tiling.
//
// Design.  One block per (q tile of 64 rows, query head, batch); a loop
// over the kv tiles of 64 keys inside the block takes the place of the
// TPU's sequential fourth grid dimension.  The loop covers only the tiles
// the causal and window tests can reach: from the tile holding key
// q_lo - window + 1 to the tile holding key q_hi (causal) or the last one,
// where q_lo and q_hi are the positions of the tile's first and last rows.
// Each tile of K and V is staged in shared memory; loads and stores are
// masked at the ragged ends of Lq and Lkv, and nothing past either end is
// read.  Two bodies share that frame:
//   * bfloat16 (the model's type): `flash_fwd_mma`, both products on the
//     tensor cores with mma.sync (bf16 operands, f32 accumulators), four
//     warps of 16 rows each; see the note above it;
//   * float32 (the reference's kernel configs): `flash_fwd_f32`, both
//     products as f32 FMAs on the CUDA cores, so f32 inputs are never
//     rounded to a narrower type.
//
// Bound: operations.  At the LM path's shape (B 2, Hq 32, Hkv 8, L 8192,
// D 80, causal, window 4096, bf16) the visible (query, key) pairs need
// 4 B Hq D * 25,167,872 = 5.15e11 flops, 0.52 ms at the tensor cores' 989
// TFLOP/s, against 0.063 ms for the 210 MB of q, k, v and out.  So the bf16
// body runs its products on the tensor cores and keeps S and P in
// registers (no round trip through shared memory).  It stops short of the
// Hopper forms that reach the peak (wgmma, TMA loads into a ring of tiles,
// warp specialisation, overlapping the softmax with the next product):
// those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                   // query rows per block
constexpr int kBK = 64;                   // keys per kv tile
constexpr int kTX = 16, kTY = 16;         // thread grid
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
    __syncthreads();                      // the last tile's K, V, P are read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = r < nk;
      const long long key = k0 + r;
      ks[r * DP + c] = in ? kp[key * p.kl + c] : 0.f;
      vs[r * DP + c] = in ? vp[key * p.vl + c] : 0.f;
    }
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
    for (int c = 0; c < DC; ++c)
      op[r * p.ol + tx + kTX * c] = acc[i][c] / den;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 inputs: both products on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulators)
// ---------------------------------------------------------------------------
//
// Four warps per block, 16 query rows each (64 rows), kv tiles of 64 keys.
// Q and K are staged in shared memory as [row][D + 8] bf16 and V as its
// transpose [D][64 + 8] (the pads make every fragment load below free of
// bank conflicts).  Fragments follow the PTX layout of m16n8k16 (g = lane
// / 4, t = lane % 4): A holds rows g, g + 8 and columns 2t, 2t + 1 (+8);
// B holds k rows 2t, 2t + 1 (+8) of column g; C holds rows g, g + 8 and
// columns 2t, 2t + 1.  S = Q K^T reads B from K's rows (one 32-bit load per
// pair); the f32 scores of two adjacent n-tiles of S are exactly the A
// fragment of P for one k-step of P V, rounded to bf16 (the one rounding
// this path adds: P is kept in bf16 for the product, as flash kernels on
// tensor cores do; l sums the unrounded p).  Row max and row sum are
// reduced over the 4 lanes of a row group by shuffles; each lane keeps a
// partial l until the end.  Tiles that no mask touches skip the mask.

constexpr int kMmaWarps = 4;            // kBQ = 16 rows per warp
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kPad = 8;                   // bf16 pad of each smem row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [0, n) of a (rows x D) bf16 tile at src (row stride ld elements)
// into dst [rows][D + kPad] by 16-byte loads; rows past n are zeros.  The
// wrapper hands over 16-byte aligned row starts (it copies a tensor whose
// pointer or strides are not).
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int rows, int n) {
  constexpr int DS = D + kPad;
  constexpr int CH = D / 8;               // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CH; e += kMmaThreads) {
    const int r = e / CH, c = (e % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) val = *reinterpret_cast<const uint4*>(src + r * ld + c);
    *reinterpret_cast<uint4*>(dst + r * DS + c) = val;
  }
}

// V rows [0, n) transposed into dst [D][kBK + kPad]; keys past n are zeros
template <int D>
__device__ __forceinline__ void load_vt(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src,
                                        long long ld, int n) {
  constexpr int KS = kBK + kPad;
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < kBK * CH; e += kMmaThreads) {
    const int r = e / CH, c = (e % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) val = *reinterpret_cast<const uint4*>(src + r * ld + c);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * KS + r] = h[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, Params p) {
  constexpr int DS = D + kPad;            // Q, K row stride
  constexpr int KS = kBK + kPad;          // V^T row stride
  constexpr int KD = D / 16;              // k-steps of S = Q K^T
  constexpr int NS = kBK / 8;             // n-tiles of S
  constexpr int ND = D / 8;               // n-tiles of O
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf[];
  __nv_bfloat16* qs = smem_bf;            // [kBQ][DS]
  __nv_bfloat16* ks = qs + kBQ * DS;      // [kBK][DS]
  __nv_bfloat16* vts = ks + kBK * DS;     // [D][KS]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / p.group;
  const int nrows = min(kBQ, p.Lq - row0);
  const int q_lo = row0 + p.q_offset;
  const int q_hi = q_lo + nrows - 1;

  const __nv_bfloat16* kp = k + b * p.kb + hk * p.kh;
  const __nv_bfloat16* vp = v + b * p.vb + hk * p.vh;
  load_rows<D>(qs, q + b * p.qb + hq * p.qh + (long long)row0 * p.ql, p.ql,
               kBQ, nrows);
  __syncthreads();

  // this warp's Q fragments, kept in registers for the whole kv loop
  uint32_t qa[KD][4];
  const __nv_bfloat16* qw = qs + (warp * 16) * DS;
#pragma unroll
  for (int ks_ = 0; ks_ < KD; ++ks_) {
    const int c = ks_ * 16 + 2 * t;
    qa[ks_][0] = *reinterpret_cast<const uint32_t*>(qw + g * DS + c);
    qa[ks_][1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * DS + c);
    qa[ks_][2] = *reinterpret_cast<const uint32_t*>(qw + g * DS + c + 8);
    qa[ks_][3] =
        *reinterpret_cast<const uint32_t*>(qw + (g + 8) * DS + c + 8);
  }

  int kt_first = 0, kt_last = (p.Lkv - 1) / kBK;
  if (p.causal) kt_last = min(kt_last, q_hi / kBK);
  if (p.window > 0) kt_first = max(0, q_lo - p.window + 1) / kBK;

  // rows g and g + 8 of this warp's 16
  const int qpos0 = q_lo + warp * 16 + g, qpos1 = qpos0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    const int nk = min(kBK, p.Lkv - k0);
    __syncthreads();                      // the last tile's K, V^T are read
    load_rows<D>(ks, kp + (long long)k0 * p.kl, p.kl, kBK, nk);
    load_vt<D>(vts, vp + (long long)k0 * p.vl, p.vl, nk);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks_ = 0; ks_ < KD; ++ks_) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * DS + ks_ * 16 + 2 * t;
        mma_bf16(s[n], qa[ks_], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // no mask reaches this tile: every key is in range, in the past of
    // the block's first row and inside the window of its last row
    const bool full = nk == kBK && (!p.causal || k0 + kBK - 1 <= q_lo) &&
                      (p.window <= 0 || k0 > q_hi - p.window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (!full) {
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool keep = kpos < p.Lkv;
          if (p.causal) keep = keep && kpos <= qpos;
          if (p.window > 0) keep = keep && kpos > qpos - p.window;
          x = keep ? x : kNegInf;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = vts + (n * 8 + g) * KS + kk * 16 + 2 * t;
        mma_bf16(acc[n], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* op = o + b * p.ob + hq * p.oh;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < nrows) {
      __nv_bfloat16* dst = op + (long long)(row0 + r0) * p.ol + c;
      dst[0] = __float2bfloat16(acc[n][0] / d0);
      dst[1] = __float2bfloat16(acc[n][1] / d0);
    }
    if (r1 < nrows) {
      __nv_bfloat16* dst = op + (long long)(row0 + r1) * p.ol + c;
      dst[0] = __float2bfloat16(acc[n][2] / d1);
      dst[1] = __float2bfloat16(acc[n][3] / d1);
    }
  }
}

template <int D>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           const Params& prm, int B, int Hq, int Lq, void* stream) {
  const dim3 grid((Lq + kBQ - 1) / kBQ, Hq, B);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16) {
    const int smem = (int)sizeof(__nv_bfloat16) *
                     ((kBQ + kBK) * (D + kPad) + D * (kBK + kPad));
    err = cudaFuncSetAttribute(
        flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_mma<D><<<grid, kMmaThreads, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, prm);
  } else {
    const int smem = (int)sizeof(float) *
                     ((kBQ + 2 * kBK) * (D + 1) + kBQ * kPP);
    err = cudaFuncSetAttribute(
        flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_f32<D><<<grid, kThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, prm);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides (batch, head, row) of q, k, v and out, in
// that order; the head_dim stride of each is 1.  For bf16, every pointer of
// q, k, v is 16-byte aligned and each of their strides a multiple of 8.
// window 0 means none, softcap 0 means none.  Returns a cudaError_t (0 on
// a clean launch).
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
    case 16: return launch<16>(h, q, k, v, o, prm, B, Hq, Lq, stream);
    case 80: return launch<80>(h, q, k, v, o, prm, B, Hq, Lq, stream);
    case 128: return launch<128>(h, q, k, v, o, prm, B, Hq, Lq, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
