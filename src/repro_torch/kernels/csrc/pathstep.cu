// Fused path step of the batched lambda-path engine, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_kernel` (:106) and `_kernel_weighted`
// (:116) of src/repro/kernels/pathstep.py (wrapper `fused_path_step`).
//
// What it computes, for C lane-stacked p x p states (Omega and W = Omega S
// as contiguous (C*p, p), an optional weight operand, and a device-side
// (C, 3) table [tau, tau*lam1, lam2]), per element (r, c) of lane l:
//   grad = 0.5 * (W + W^T) + lam2 * Omega, then - 1/Omega on the diagonal;
//   z    = Omega - tau * grad;
//   cand = soft(z, thr) off the diagonal and z on it, thr = tau*lam1, or
//          tau*lam1 * w with w = inf forcing an exact zero (even when
//          tau*lam1 == 0, where inf * 0 would be nan);
// and per lane the sums <cand - Omega, grad>, ||cand - Omega||^2,
// ||cand||^2, the off-diagonal l1 of cand and its nonzero count.
//
// Bound: device-memory bytes.  The work reads Omega and W once and writes
// cand once, 3*C*p^2*8 bytes in float64 (4*C*p^2*8 with a weight operand
// per lane), at ~20 flops per element.  Each block owns one 32 x 32 output
// tile of one lane and reads the W^T tile it needs (tile (j, i) of the
// same lane) through shared memory as a transpose: coalesced loads, and a
// padded row against bank conflicts.  W is thus read twice (once as W,
// once as W^T by the mirror tile's block); reading each tile pair once per
// block pair would save one of the five passes and is later work.
//
// Stats: each block reduces its tile's five sums (in double, the nonzero
// count as an integer) and writes them to a partials buffer the wrapper
// allocates; a second kernel, one block per lane, sums the partials in a
// fixed order.  No atomics, so runs repeat to the bit and the engine's
// per-lane trial counts cannot wobble.  The count stays exact past 2^24
// (a lane at p = 16384 has up to 2.7e8 nonzeros): it is summed as a
// double and rounded once to the output type.
//
// Bit-exactness: cand must equal the plain PyTorch version
// (repro_torch.kernels.ref.fused_path_step) bit for bit.  This file is
// compiled with -fmad=false, so `g + lam2 * o` and `o - tau * g` are never
// contracted into FMAs, and 1/Omega is taken only on the diagonal.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kcheck.cuh"  // KC_*: checks in the checked build, else nothing

namespace {

constexpr int kTile = 32;                 // output tile edge
constexpr int kRows = 8;                  // thread rows; 4 tile rows each
constexpr int kThreads = kTile * kRows;
constexpr int kStats = 5;
constexpr int kReduceThreads = 256;

template <typename T>
__device__ __forceinline__ T soft(T zv, T thr) {
  // sign(z) * max(|z| - thr, 0), propagating NaN as torch does
  T d = fabs(zv) - thr;
  T mx = (d < T(0)) ? T(0) : d;
  T sg = (zv > T(0)) ? T(1) : ((zv < T(0)) ? T(-1) : zv);
  return sg * mx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
path_step_kernel(const T* __restrict__ om, const T* __restrict__ w,
                 const T* __restrict__ wts, long long wts_lane_stride,
                 const T* __restrict__ scal, T* __restrict__ cand,
                 double* __restrict__ partials, int p) {
  __shared__ T wt_tile[kTile][kTile + 1];
  const int lane = blockIdx.z;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t base = (size_t)lane * p * p;
  KC_LD(&scal[lane * 3], 3 * sizeof(T));
  const T tau = scal[lane * 3 + 0];
  const T alpha = scal[lane * 3 + 1];
  const T lam2 = scal[lane * 3 + 2];

  // wt_tile[k][x] = W[c0 + k][r0 + x]: element (r0 + y, c0 + x) of this
  // tile needs W[c0 + x][r0 + y] = wt_tile[x][y]
  for (int k = ty; k < kTile; k += kRows) {
    KC_JITTER(k);
    const int row = c0 + k, col = r0 + tx;
    if (row < p && col < p) {
      KC_LD(&w[base + (size_t)row * p + col], sizeof(T));
      KC_SH(&wt_tile[k][tx], sizeof(T));
      wt_tile[k][tx] = w[base + (size_t)row * p + col];
    }
  }
  KC_JITTER(0);
  __syncthreads();

  double s_dg = 0.0, s_dd = 0.0, s_sq = 0.0, s_l1 = 0.0;
  int nnz = 0;
  for (int k = ty; k < kTile; k += kRows) {
    KC_JITTER(k);
    const int r = r0 + k, c = c0 + tx;
    if (r >= p || c >= p) continue;
    const size_t off = base + (size_t)r * p + c;
    KC_LD(&om[off], sizeof(T));
    const T o = om[off];
    const bool diag = (r == c);
    KC_LD(&w[off], sizeof(T));
    KC_SH(&wt_tile[tx][k], sizeof(T));
    T g = (w[off] + wt_tile[tx][k]) * T(0.5);
    g = g + lam2 * o;
    if (diag) g = g - T(1) / o;
    const T z = o - tau * g;
    T thr = alpha;
    if (wts != nullptr) {
      KC_LD(&wts[(size_t)wts_lane_stride * lane + (size_t)r * p + c],
            sizeof(T));
      const T wv = wts[(size_t)wts_lane_stride * lane + (size_t)r * p + c];
      thr = isinf(wv) ? T(INFINITY) : alpha * wv;
    }
    const T cv = diag ? z : soft(z, thr);
    KC_ST(&cand[off], sizeof(T));
    cand[off] = cv;
    const T d = cv - o;
    s_dg += (double)(d * g);
    s_dd += (double)(d * d);
    s_sq += (double)(cv * cv);
    if (!diag) s_l1 += (double)fabs(cv);
    nnz += (cv != T(0));
  }

  // block reduction: warp shuffles, then one value per warp in smem
  for (int s = 16; s > 0; s >>= 1) {
    s_dg += __shfl_down_sync(0xffffffffu, s_dg, s);
    s_dd += __shfl_down_sync(0xffffffffu, s_dd, s);
    s_sq += __shfl_down_sync(0xffffffffu, s_sq, s);
    s_l1 += __shfl_down_sync(0xffffffffu, s_l1, s);
    nnz += __shfl_down_sync(0xffffffffu, nnz, s);
  }
  __shared__ double sh[4][kThreads / 32];
  __shared__ int shn[kThreads / 32];
  const int tid = ty * kTile + tx;
  const int lid = tid % 32, wid = tid / 32;
  if (lid == 0) {
    KC_SH(&sh[3][wid], sizeof(double));
    KC_SH(&shn[wid], sizeof(int));
    sh[0][wid] = s_dg;
    sh[1][wid] = s_dd;
    sh[2][wid] = s_sq;
    sh[3][wid] = s_l1;
    shn[wid] = nnz;
  }
  KC_JITTER(0);
  __syncthreads();
  if (tid == 0) {
    double a = 0.0, b = 0.0, cc = 0.0, d = 0.0;
    long long n = 0;
    for (int i = 0; i < kThreads / 32; ++i) {
      a += sh[0][i];
      b += sh[1][i];
      cc += sh[2][i];
      d += sh[3][i];
      n += shn[i];
    }
    double* out = partials +
        (((size_t)lane * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
            kStats;
    KC_ST(out, kStats * sizeof(double));
    out[0] = a;
    out[1] = b;
    out[2] = cc;
    out[3] = d;
    out[4] = (double)n;
  }
}

// One block per lane: sum that lane's per-tile partials in a fixed order
// (each thread a fixed stride, then a fixed tree) and round once to T.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
lane_reduce_kernel(const double* __restrict__ partials, long long tiles,
                   T* __restrict__ stats) {
  __shared__ double sh[kStats][kReduceThreads];
  const int lane = blockIdx.x;
  const double* src = partials + (size_t)lane * tiles * kStats;
  double acc[kStats] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (long long t = threadIdx.x; t < tiles; t += kReduceThreads) {
    KC_JITTER(t / kReduceThreads);
    KC_LD(&src[t * kStats], kStats * sizeof(double));
    for (int k = 0; k < kStats; ++k) acc[k] += src[t * kStats + k];
  }
  for (int k = 0; k < kStats; ++k) sh[k][threadIdx.x] = acc[k];
  KC_JITTER(0);
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      KC_SH(&sh[kStats - 1][threadIdx.x + s], sizeof(double));
      for (int k = 0; k < kStats; ++k) {
        sh[k][threadIdx.x] += sh[k][threadIdx.x + s];
      }
    }
    KC_JITTER(s);
    __syncthreads();
  }
  if (threadIdx.x < kStats) {
    KC_ST(&stats[lane * kStats + threadIdx.x], sizeof(T));
    stats[lane * kStats + threadIdx.x] = (T)sh[threadIdx.x][0];
  }
}

template <typename T>
int launch(const T* om, const T* w, const T* wts, long long wts_stride,
           const T* scal, T* cand, double* partials, T* stats, int c, int p,
           void* stream) {
  if (c <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  const int g = (p + kTile - 1) / kTile;
  const dim3 grid(g, g, c), block(kTile, kRows);
  cudaStream_t st = (cudaStream_t)stream;
  path_step_kernel<T><<<grid, block, 0, st>>>(om, w, wts, wts_stride, scal,
                                             cand, partials, p);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  lane_reduce_kernel<T><<<c, kReduceThreads, 0, st>>>(
      partials, (long long)g * g, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_path_step_f64(const double* om, const double* w,
                                   const double* wts, long long wts_stride,
                                   const double* scal, double* cand,
                                   double* partials, double* stats, int c,
                                   int p, void* stream) {
  return launch<double>(om, w, wts, wts_stride, scal, cand, partials, stats,
                        c, p, stream);
}

extern "C" int fused_path_step_f32(const float* om, const float* w,
                                   const float* wts, long long wts_stride,
                                   const float* scal, float* cand,
                                   double* partials, float* stats, int c,
                                   int p, void* stream) {
  return launch<float>(om, w, wts, wts_stride, scal, cand, partials, stats,
                       c, p, stream);
}
