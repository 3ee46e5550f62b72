// Fused proximal update + line-search statistics, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_kernel` and `_kernel_weighted` of
// src/repro/kernels/softthresh.py (wrapper `fused_prox_stats`).
//
// What it computes, per (bm, bn) tile of z (m x n):
//   out = S_thr(z) off the diagonal, z on it; thr = alpha, or alpha * w
//         with w = inf forcing an exact zero (even at alpha == 0);
//   five partials over the tile's valid elements: sum log(max(out,1e-30))
//   over the diagonal, sum |out| off it, sum out^2, min over the diagonal,
//   and the count of nonzero outputs.  With bm = bn = the matops block
//   size, count > 0 IS the block-occupancy mask of the new iterate.
//
// Bound: device-memory bytes.  Each element is read once (z, plus w and
// the diagonal mask when given) and written once, with ~10 flops.  One
// thread block owns one tile, so a tile's partials are reduced in
// registers and shared memory and written once as (gm, gn, 5); the
// wrapper sums them.  The diagonal is derived from the indices when no
// mask is passed, which saves a p^2 read on the main path.
//
// Bit-exactness: out must equal the plain PyTorch version bit for bit.
// This file is compiled with -fmad=false, so `alpha * w` and the
// `st * (1 - m) + z * m` blend are never contracted into FMAs.
//
// The trial entry (`fused_prox_stats_trial_kernel`, wrapper
// `fused_prox_trial`) is one whole line-search trial of the prox loop: it
// reads Omega and the gradient G, forms z = omega - tau * g in registers
// (two rounded ops, as eager PyTorch computes them: -fmad=false keeps
// them apart), writes cand = S_thr(z) off the diagonal and z on it once,
// and reduces per tile <d, d>, <d, g> (d = cand - omega), ||cand||^2 and
// the nonzero count.  Bound: 3 p^2 words (two streams in, one out) where
// the unfused trial moved 16 p^2.  Where the row length, the tile width
// and every base pointer allow, each access moves 16 bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kcheck.cuh"  // KC_*: checks in the checked build, else nothing

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T soft(T zv, T thr) {
  // sign(z) * max(|z| - thr, 0) with jnp's NaN propagation
  T d = fabs(zv) - thr;
  T mx = (d < T(0)) ? T(0) : d;
  T sg = (zv > T(0)) ? T(1) : ((zv < T(0)) ? T(-1) : zv);
  return sg * mx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_prox_stats_kernel(const T* __restrict__ z, const T* __restrict__ dmask,
                        const T* __restrict__ w, T alpha,
                        T* __restrict__ out, T* __restrict__ stats,
                        int m, int n, int bm, int bn) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int r0 = ti * bm, c0 = tj * bn;
  const int rows = min(bm, m - r0), cols = min(bn, n - c0);
  const int count = rows * cols;

  T logdet = 0, l1 = 0, sumsq = 0, mind = T(INFINITY);
  int nnz = 0;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    KC_JITTER(e / kThreads);
    const int r = r0 + e / cols, c = c0 + e % cols;
    const size_t off = (size_t)r * n + c;
    KC_LD(&z[off], sizeof(T));
    const T zv = z[off];
    T thr = alpha;
    if (w != nullptr) {
      KC_LD(&w[off], sizeof(T));
      const T wv = w[off];
      thr = isinf(wv) ? T(INFINITY) : alpha * wv;
    }
    const T st = soft(zv, thr);
    T o;
    bool diag;
    if (dmask != nullptr) {
      KC_LD(&dmask[off], sizeof(T));
      const T mv = dmask[off];
      o = st * (T(1) - mv) + zv * mv;
      diag = mv > T(0);
    } else {
      diag = (r == c);
      o = diag ? zv : st;
    }
    KC_ST(&out[off], sizeof(T));
    out[off] = o;
    if (diag) {
      logdet += log(o < T(1e-30) ? T(1e-30) : o);
      mind = (o < mind || o != o) ? o : mind;
    } else {
      l1 += fabs(o);
    }
    sumsq += o * o;
    nnz += (o != T(0));
  }

  // block reduction: warp shuffles, then one value per warp in smem
  for (int s = 16; s > 0; s >>= 1) {
    logdet += __shfl_down_sync(0xffffffffu, logdet, s);
    l1 += __shfl_down_sync(0xffffffffu, l1, s);
    sumsq += __shfl_down_sync(0xffffffffu, sumsq, s);
    const T om = __shfl_down_sync(0xffffffffu, mind, s);
    mind = (om < mind || om != om) ? om : mind;
    nnz += __shfl_down_sync(0xffffffffu, nnz, s);
  }
  __shared__ T sh[4][kThreads / 32];
  __shared__ int shn[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    KC_SH(&sh[3][warp], sizeof(T));
    KC_SH(&shn[warp], sizeof(int));
    sh[0][warp] = logdet;
    sh[1][warp] = l1;
    sh[2][warp] = sumsq;
    sh[3][warp] = mind;
    shn[warp] = nnz;
  }
  KC_JITTER(0);
  __syncthreads();
  if (threadIdx.x == 0) {
    T a = 0, b = 0, c = 0, d = T(INFINITY);
    int k = 0;
    for (int i = 0; i < kThreads / 32; ++i) {
      a += sh[0][i];
      b += sh[1][i];
      c += sh[2][i];
      d = (sh[3][i] < d || sh[3][i] != sh[3][i]) ? sh[3][i] : d;
      k += shn[i];
    }
    T* st = stats + ((size_t)ti * gridDim.x + tj) * 5;
    KC_ST(st, 5 * sizeof(T));
    st[0] = a;
    st[1] = b;
    st[2] = c;
    st[3] = d;
    st[4] = T(k);
  }
}

template <typename T>
int launch(const T* z, const T* dmask, const T* w, T alpha, T* out,
           T* stats, int m, int n, int bm, int bn, void* stream) {
  if (m <= 0 || n <= 0 || bm <= 0 || bn <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  fused_prox_stats_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      z, dmask, w, alpha, out, stats, m, n, bm, bn);
  return (int)cudaGetLastError();
}

// one global access of V consecutive elements: a 16-byte vector where V > 1
template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  KC_LD(p, V * sizeof(T));
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& x) {
  KC_ST(p, V * sizeof(T));
  *reinterpret_cast<Pack<T, V>*>(p) = x;
}

// stats columns of the trial entry: <d, d>, <d, g>, ||cand||^2, nonzeros
constexpr int kTrialStats = 4;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
fused_prox_stats_trial_kernel(const T* __restrict__ omega,
                              const T* __restrict__ g,
                              const T* __restrict__ w, T tau, T alpha,
                              T* __restrict__ out, T* __restrict__ stats,
                              int m, int n, int bm, int bn) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int r0 = ti * bm, c0 = tj * bn;
  const int rows = min(bm, m - r0), cols = min(bn, n - c0);
  const int vcols = cols / V;  // V divides cols on the vector path
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int kWarps = kThreads / 32;

  T dd = 0, dg = 0, nn = 0;
  int nnz = 0;
  // a warp per row, its lanes along the row: each warp access is one
  // contiguous run of 32 * V elements
  for (int i = warp; i < rows; i += kWarps) {
    const int r = r0 + i;
    for (int j = lane; j < vcols; j += 32) {
      KC_JITTER(i);
      const int c = c0 + j * V;
      const size_t off = (size_t)r * n + c;
      const Pack<T, V> ov = load<T, V>(omega + off);
      const Pack<T, V> gv = load<T, V>(g + off);
      Pack<T, V> wv{};
      if (w != nullptr) wv = load<T, V>(w + off);
      Pack<T, V> cv;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const T zv = ov.v[k] - tau * gv.v[k];
        T thr = alpha;
        if (w != nullptr) thr = isinf(wv.v[k]) ? T(INFINITY) : alpha * wv.v[k];
        const T o = (r == c + k) ? zv : soft(zv, thr);
        const T d = o - ov.v[k];
        dd += d * d;
        dg += d * gv.v[k];
        nn += o * o;
        nnz += (o != T(0));
        cv.v[k] = o;
      }
      store<T, V>(out + off, cv);
    }
  }

  for (int s = 16; s > 0; s >>= 1) {
    dd += __shfl_down_sync(0xffffffffu, dd, s);
    dg += __shfl_down_sync(0xffffffffu, dg, s);
    nn += __shfl_down_sync(0xffffffffu, nn, s);
    nnz += __shfl_down_sync(0xffffffffu, nnz, s);
  }
  __shared__ T sh[3][kWarps];
  __shared__ int shn[kWarps];
  if (lane == 0) {
    KC_SH(&sh[2][warp], sizeof(T));
    KC_SH(&shn[warp], sizeof(int));
    sh[0][warp] = dd;
    sh[1][warp] = dg;
    sh[2][warp] = nn;
    shn[warp] = nnz;
  }
  KC_JITTER(0);
  __syncthreads();
  if (threadIdx.x == 0) {
    T a = 0, b = 0, c = 0;
    int k = 0;
    for (int i = 0; i < kWarps; ++i) {
      a += sh[0][i];
      b += sh[1][i];
      c += sh[2][i];
      k += shn[i];
    }
    T* st = stats + ((size_t)ti * gridDim.x + tj) * kTrialStats;
    KC_ST(st, kTrialStats * sizeof(T));
    st[0] = a;
    st[1] = b;
    st[2] = c;
    st[3] = T(k);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch_trial(const T* omega, const T* g, const T* w, T tau, T alpha,
                 T* out, T* stats, int m, int n, int bm, int bn,
                 void* stream) {
  if (m <= 0 || n <= 0 || bm <= 0 || bn <= 0) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  const bool vec = n % V == 0 && bn % V == 0 && aligned16(omega) &&
                   aligned16(g) && aligned16(out) &&
                   (w == nullptr || aligned16(w));
  if (vec)
    fused_prox_stats_trial_kernel<T, V>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            omega, g, w, tau, alpha, out, stats, m, n, bm, bn);
  else
    fused_prox_stats_trial_kernel<T, 1>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            omega, g, w, tau, alpha, out, stats, m, n, bm, bn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_prox_trial_f64(const double* omega, const double* g,
                                    const double* w, double tau,
                                    double alpha, double* out, double* stats,
                                    int m, int n, int bm, int bn,
                                    void* stream) {
  return launch_trial<double>(omega, g, w, tau, alpha, out, stats, m, n, bm,
                              bn, stream);
}

extern "C" int fused_prox_trial_f32(const float* omega, const float* g,
                                    const float* w, float tau, float alpha,
                                    float* out, float* stats, int m, int n,
                                    int bm, int bn, void* stream) {
  return launch_trial<float>(omega, g, w, tau, alpha, out, stats, m, n, bm,
                             bn, stream);
}

extern "C" int fused_prox_stats_f64(const double* z, const double* dmask,
                                    const double* w, double alpha,
                                    double* out, double* stats, int m, int n,
                                    int bm, int bn, void* stream) {
  return launch<double>(z, dmask, w, alpha, out, stats, m, n, bm, bn, stream);
}

extern "C" int fused_prox_stats_f32(const float* z, const float* dmask,
                                    const float* w, float alpha, float* out,
                                    float* stats, int m, int n, int bm, int bn,
                                    void* stream) {
  return launch<float>(z, dmask, w, alpha, out, stats, m, n, bm, bn, stream);
}
