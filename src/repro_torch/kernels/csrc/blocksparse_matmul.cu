// Block-sparse x dense matrix product, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/blocksparse_matmul.py (wrapper `blocksparse_matmul`),
// and on the solver's path the block-gather fallback
// `repro.core.matops.masked_matmul` that the JAX solve runs in its place.
//
// C (M x N) = A (M x K) @ B (K x N), where A is zero outside a set of
// occupied bs x bs tiles.  Two sources of tiles share one kernel body:
//   * CSR:  values (nb, bs, bs) with a row pointer (nbr + 1) and column
//           ids (nb), the reference's block-CSR contract;
//   * mask: the dense A read in place plus its int8 occupancy mask
//           (nbr, nbc); each program scans its own mask row, so no tile
//           list is compacted, gathered or copied.
//
// One program owns one output tile: rows [row0, row0 + kTM) of block-row
// r (never crossing the block-row) by columns [col0, col0 + kTN).  It
// loops over block-row r's occupied tiles and accumulates in registers,
// so no two programs write the same output element: the TPU kernel's
// sequential grid axis and its flush-on-row-change (the CA401 write-race
// hazard) have no counterpart here.  An empty block-row writes zeros.
//
// Bound: at the solver's densities (a few % of blocks) the product is
// bound by the bytes of B read and C written; the flops are
// 2 * nnz_blocks * bs^2 * N.  This first version is a plain shared-memory
// tiled FMA loop (kTK-deep k-slices through shared memory, a 4 x 4
// register micro-tile per thread) in the operand dtype; mma.sync/wgmma
// and TMA pipelining are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64, kTN = 64, kTK = 16;
constexpr int kThreads = 256;   // 16 x 16, each thread a 4 x 4 micro-tile

template <typename T>
struct CsrTiles {
  const T* values;
  const int* row_ptr;
  const int* col_idx;
  int bs;
  __device__ int first(int r) const { return row_ptr[r]; }
  __device__ int stop(int r) const { return row_ptr[r + 1]; }
  __device__ int next(int, int e) const { return e + 1; }
  // column block of entry e, and the address/stride of element
  // (r*bs, col*bs) of A inside that tile
  __device__ int col(int, int e) const { return col_idx[e]; }
  __device__ const T* tile(int, int e, int& ld) const {
    ld = bs;
    return values + (size_t)e * bs * bs;
  }
};

template <typename T>
struct MaskTiles {
  const T* a;
  int lda;
  const int8_t* mask;
  int nbc;
  int bs;
  __device__ int next(int r, int e) const {
    const int8_t* row = mask + (size_t)r * nbc;
    for (++e; e < nbc; ++e)
      if (row[e] > 0) break;
    return e;
  }
  __device__ int first(int r) const { return next(r, -1); }
  __device__ int stop(int) const { return nbc; }
  __device__ int col(int, int e) const { return e; }
  __device__ const T* tile(int r, int e, int& ld) const {
    ld = lda;
    return a + (size_t)r * bs * lda + (size_t)e * bs;
  }
};

template <typename T, typename Tiles>
__global__ void __launch_bounds__(kThreads)
bsmm_kernel(Tiles tiles, const T* __restrict__ b, int ldb,
            T* __restrict__ c, int ldc, int M, int K, int N, int bs,
            int sub_tiles) {
  __shared__ T As[kTM][kTK];
  __shared__ T Bs[kTK][kTN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r = blockIdx.y / sub_tiles;
  const int row0 = r * bs + (blockIdx.y % sub_tiles) * kTM;
  const int row_end = min(min(row0 + kTM, (r + 1) * bs), M);
  const int col0 = blockIdx.x * kTN;
  if (row0 >= row_end) return;   // uniform across the block

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int e = tiles.first(r); e < tiles.stop(r); e = tiles.next(r, e)) {
    int lda;
    const T* at = tiles.tile(r, e, lda);   // element (r*bs, cb*bs) of A
    const int k0 = tiles.col(r, e) * bs;
    const int k_end = min(k0 + bs, K);
    for (int kk = k0; kk < k_end; kk += kTK) {
      for (int l = threadIdx.x; l < kTM * kTK; l += kThreads) {
        const int i = l / kTK, q = l % kTK;
        const int gr = row0 + i, gk = kk + q;
        As[i][q] = (gr < row_end && gk < k_end)
                       ? at[(size_t)(gr - r * bs) * lda + (gk - k0)]
                       : T(0);
      }
      for (int l = threadIdx.x; l < kTK * kTN; l += kThreads) {
        const int q = l / kTN, j = l % kTN;
        const int gk = kk + q, gc = col0 + j;
        Bs[q][j] = (gk < k_end && gc < N) ? b[(size_t)gk * ldb + gc] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        T av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][q];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[q][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < N) c[(size_t)gr * ldc + gc] = acc[i][j];
    }
  }
}

template <typename T, typename Tiles>
int launch(Tiles tiles, const T* b, int ldb, T* c, int ldc, int M, int K,
           int N, int bs, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bs <= 0) return (int)cudaErrorInvalidValue;
  const int nbr = (M + bs - 1) / bs;
  const int sub_tiles = (bs + kTM - 1) / kTM;
  if ((long long)nbr * sub_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((N + kTN - 1) / kTN, nbr * sub_tiles);
  bsmm_kernel<T, Tiles><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tiles, b, ldb, c, ldc, M, K, N, bs, sub_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int csr(const T* values, const int* row_ptr, const int* col_idx, int bs,
        const T* b, int ldb, T* c, int ldc, int M, int K, int N,
        void* stream) {
  CsrTiles<T> t{values, row_ptr, col_idx, bs};
  return launch<T>(t, b, ldb, c, ldc, M, K, N, bs, stream);
}

template <typename T>
int masked(const T* a, int lda, const int8_t* mask, int nbc, int bs,
           const T* b, int ldb, T* c, int ldc, int M, int K, int N,
           void* stream) {
  MaskTiles<T> t{a, lda, mask, nbc, bs};
  return launch<T>(t, b, ldb, c, ldc, M, K, N, bs, stream);
}

}  // namespace

extern "C" {

int bsmm_csr_f64(const double* values, const int* row_ptr, const int* col_idx,
                 int bs, const double* b, int ldb, double* c, int ldc, int M,
                 int K, int N, void* stream) {
  return csr<double>(values, row_ptr, col_idx, bs, b, ldb, c, ldc, M, K, N,
                     stream);
}

int bsmm_csr_f32(const float* values, const int* row_ptr, const int* col_idx,
                 int bs, const float* b, int ldb, float* c, int ldc, int M,
                 int K, int N, void* stream) {
  return csr<float>(values, row_ptr, col_idx, bs, b, ldb, c, ldc, M, K, N,
                    stream);
}

int bsmm_mask_f64(const double* a, int lda, const int8_t* mask, int nbc,
                  int bs, const double* b, int ldb, double* c, int ldc, int M,
                  int K, int N, void* stream) {
  return masked<double>(a, lda, mask, nbc, bs, b, ldb, c, ldc, M, K, N,
                        stream);
}

int bsmm_mask_f32(const float* a, int lda, const int8_t* mask, int nbc,
                  int bs, const float* b, int ldb, float* c, int ldc, int M,
                  int K, int N, void* stream) {
  return masked<float>(a, lda, mask, nbc, bs, b, ldb, c, ldc, M, K, N,
                       stream);
}

}  // extern "C"
