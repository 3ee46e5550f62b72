// Block-sparse x dense matrix product, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/blocksparse_matmul.py:30 (wrapper `blocksparse_matmul`,
// pallas_call at :107), and on the solver's path the block-gather fallback
// `repro.core.matops.masked_matmul` that the JAX solve runs in its place.
//
// C (M x N) = A (M x K) @ B (K x N), where A is zero outside a set of
// occupied bs x bs tiles.  Two sources of tiles share each kernel body:
//   * CSR:  values (nb, bs, bs) with a row pointer (nbr + 1) and column
//           ids (nb), the reference's block-CSR contract;
//   * mask: the dense A read in place plus its int8 occupancy mask
//           (nbr, nbc); no tile list is compacted, gathered or copied on
//           the host.
//
// One block owns one output tile: rows [row0, row0 + 128) of block-row r
// (never crossing the block-row) by 128 columns.  It loops over block-row
// r's occupied tiles and accumulates in registers, so no two blocks write
// the same output element: the TPU kernel's sequential grid axis and its
// flush-on-row-change (the CA401 write-race hazard) have no counterpart
// here.  An empty block-row writes zeros.
//
// Bound: operations.  At the solver's main shape (W = Omega S, p = 16384,
// bs 128, 382 of 16384 tiles occupied) the product needs 2 nnz_blocks
// bs^2 N = 2.05e11 flops, 3.06 ms at the f64 tensor cores' 67 TFLOP/s,
// against ~1.3 ms for the bytes (S read once, C written once).
//
// float64 body, `bsmm_f64_tc`: the f64 tensor cores.
//   * mma.sync m16n8k8 f64 (sm_90).  probes/f64_mma_probe.cu measured
//     m8n8k4 (the sm_80 shape) at half the f64 tensor rate (33 TFLOP/s)
//     and m16n8k4/k8/k16 at the full 66 on an NVIDIA H100 80GB HBM3,
//     700.00 W; k8 takes half k4's instructions and half k16's fragment
//     registers.  The first body was a DFMA loop on
//     the CUDA cores, whose f64 rate is half the tensor cores'.
//   * 8 warps, 2 x 4, each a 64 x 32 warp tile (4 x 4 mma tiles, 64 f64
//     accumulators a thread).  Per 8-deep k step a warp loads 24 fragment
//     doubles for 16 mma; the rows of the padded A and B stages (20 and
//     136 doubles) make every fragment load conflict-free.
//   * Occupied tiles: at block start the block-row's occupied column
//     blocks are compacted once into shared memory (a ballot over the mask
//     row, or the CSR column ids), so the loop never rescans the mask.
//   * Pipeline: a 4-stage ring of 16-deep A and B k-slices filled by
//     cp.async 16-byte copies (8-byte ones where a pointer, leading
//     dimension or bs is odd), with zero fill past the ragged edges of M,
//     K, N and of each tile.  Slices are numbered across the block-row's
//     tiles, so the ring flows over tile boundaries without draining; one
//     __syncthreads per slice.
//   * L2: blocks walk panels of 16 column tiles, block-row by block-row
//     inside a panel, so the ~132 resident blocks share ~8 neighbouring
//     block-rows and one 2048-column panel of S: the S block-rows a banded
//     Omega reads from neighbouring block-rows are still in the 50 MB L2.
//     The first body walked every column tile of one block-row first.
//   * Tensor-core sums are fused multiply-adds in another order than the
//     plain version's; the manifest's f64 rtol of 1e-10 covers it.
//   Measured (chip_smoke.py, phase timing, at the main shape with 382 of
//   16384 tiles occupied): 5.406 ms, 57% of the 3.061 ms bound, against
//   17.52 ms for the first body, 146.5 ms for the dense torch.matmul and
//   50.41 ms for PyTorch's f64 BSR product, on an NVIDIA H100 80GB HBM3,
//   700.00 W.  242-250 registers a thread, no spills.
//
// float32 body, `bsmm_fma`: the first body, kept for f32: a shared-memory
// tiled FMA loop on the CUDA cores (64 x 64 x 16 tiles, a 4 x 4 register
// micro-tile per thread).  TF32 tensor cores would round the f32 operands
// to 10 mantissa bits and change the f32 results, so f32 stays on FMAs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kcheck.cuh"  // KC_*: checks in the checked build, else nothing

namespace {

// ---------------------------------------------------------------------------
// tile sources
// ---------------------------------------------------------------------------

template <typename T>
struct CsrTiles {
  const T* values;
  const int* row_ptr;
  const int* col_idx;
  int bs;
  __device__ int count(int r) const {
    KC_LD(&row_ptr[r], sizeof(int));
    KC_LD(&row_ptr[r + 1], sizeof(int));
    return row_ptr[r + 1] - row_ptr[r];
  }
  // column block of the i-th occupied tile of block-row r
  __device__ int col(int r, int i) const {
    KC_LD(&row_ptr[r], sizeof(int));
    KC_LD(&col_idx[row_ptr[r] + i], sizeof(int));
    return col_idx[row_ptr[r] + i];
  }
  // element (r*bs, col*bs) of A inside the i-th tile, and its row stride
  __device__ const T* tile(int r, int i, int, int& ld) const {
    ld = bs;
    KC_LD(&row_ptr[r], sizeof(int));
    return values + (size_t)(row_ptr[r] + i) * bs * bs;
  }
  // the entries of a block-row are a list already
  static constexpr bool kMaskRow = false;
};

template <typename T>
struct MaskTiles {
  const T* a;
  int lda;
  const int8_t* mask;
  int nbc;
  int bs;
  __device__ const T* tile(int r, int, int col, int& ld) const {
    ld = lda;
    return a + (size_t)r * bs * lda + (size_t)col * bs;
  }
  // a block-row's tiles are found by scanning its mask row
  static constexpr bool kMaskRow = true;
  __device__ const int8_t* mask_row(int r) const {
    return mask + (size_t)r * nbc;
  }
  __device__ int ncols() const { return nbc; }
  // the f32 body's scan
  __device__ int next(int r, int e) const {
    const int8_t* row = mask_row(r);
    for (++e; e < nbc; ++e) {
      KC_LD(&row[e], 1);
      if (row[e] > 0) break;
    }
    return e;
  }
};

// ---------------------------------------------------------------------------
// float64: mma.sync m16n8k8 on the f64 tensor cores, cp.async ring
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kStages = 4;
constexpr int kTcThreads = 256;            // 8 warps: 2 (rows) x 4 (cols)
constexpr int kLdA = kBK + 4;              // A stage row, doubles
constexpr int kLdB = kBN + 8;              // B stage row, doubles
constexpr int kStageA = kBM * kLdA;        // doubles
constexpr int kStageB = kBK * kLdB;
constexpr int kListCap = 1024;             // occupied tiles per pass
constexpr int kPanel = 16;                 // column tiles per L2 panel
constexpr size_t kTcSmem =
    sizeof(double) * kStages * (kStageA + kStageB) + sizeof(int) * kListCap;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy VEC doubles (8 or 16 bytes) from src, of which n are in range; the
// rest of the destination is zero-filled.  With n = 0 nothing is read.
template <int VEC>
__device__ __forceinline__ void cp_async(double* dst, const double* src,
                                         int n) {
  const uint32_t d = smem_u32(dst);
  const int bytes = n * 8;
  // the destination's VEC doubles are written (zero past n); only the n
  // in range are read
  KC_SH(dst, VEC * 8);
  if (n > 0) KC_LD(src, n * 8);
  if (VEC == 2)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// D (16 x 8) += A (16 x 8, row) B (8 x 8, col), f64.  Fragments (g = lane
// / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1].
__device__ __forceinline__ void mma_f64(double* d, const double* a,
                                        const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// the occupied column blocks of block-row r in [c_lo, c_hi), in order,
// into list; returns their number (uniform across the block)
template <typename Tiles>
__device__ int compact_tiles(const Tiles& tiles, int r, int c_lo, int c_hi,
                             int* list, int* warp_tot) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int8_t* row = tiles.mask_row(r);
  int count = 0;
  for (int c0 = c_lo; c0 < c_hi; c0 += kTcThreads) {
    const int c = c0 + threadIdx.x;
    KC_JITTER(c0);
    if (c < c_hi) KC_LD(&row[c], 1);
    const bool occ = c < c_hi && row[c] > 0;
    const unsigned bal = __ballot_sync(0xffffffffu, occ);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    KC_JITTER(c0);
    __syncthreads();
    int base = count;
    for (int w = 0; w < kTcThreads / 32; ++w) {
      if (w < warp) base += warp_tot[w];
      count += warp_tot[w];
    }
    if (occ) {
      KC_SH(&list[base + __popc(bal & ((1u << lane) - 1u))], sizeof(int));
      list[base + __popc(bal & ((1u << lane) - 1u))] = c;
    }
    KC_JITTER(c0);
    __syncthreads();
  }
  return count;
}

template <int VEC, typename Tiles>
__global__ void __launch_bounds__(kTcThreads, 1)
bsmm_f64_tc(Tiles tiles, const double* __restrict__ b, int ldb,
            double* __restrict__ c, int ldc, int M, int K, int N, int bs,
            int sub_tiles, int row_tiles, int col_tiles) {
  extern __shared__ __align__(16) double smem_d[];
  double* as = smem_d;                                // [kStages][kStageA]
  double* bsm = as + kStages * kStageA;               // [kStages][kStageB]
  int* list = reinterpret_cast<int*>(bsm + kStages * kStageB);
  __shared__ int warp_tot[kTcThreads / 32];

  // panel order: 16 column tiles at a time, block-row by block-row
  const int id = blockIdx.x;
  const int panel = id / (row_tiles * kPanel);
  const int local = id - panel * row_tiles * kPanel;
  const int width = min(kPanel, col_tiles - panel * kPanel);
  const int rt = local / width;
  const int col0 = (panel * kPanel + local % width) * kBN;
  const int r = rt / sub_tiles;
  const int row0 = r * bs + (rt % sub_tiles) * kBM;
  const int row_end = min(min(row0 + kBM, (r + 1) * bs), M);
  if (row0 >= row_end) return;   // uniform across the block

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  double acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  // this thread's copies: A rows a_row + j kARowStep at column a_k of a
  // slice, B rows b_kr + j kBRowStep at column b_col of the tile
  constexpr int kARowChunks = kBK / VEC, kARowStep = kTcThreads / kARowChunks;
  constexpr int kBRowChunks = kBN / VEC, kBRowStep = kTcThreads / kBRowChunks;
  const int a_row = tid / kARowChunks, a_k = (tid % kARowChunks) * VEC;
  const int b_kr = tid / kBRowChunks, b_col = (tid % kBRowChunks) * VEC;
  const int n_col = max(0, min(VEC, N - col0 - b_col));   // B columns in N
  const int sa_off = a_row * kLdA + a_k, sb_off = b_kr * kLdB + b_col;

  const int spt = (bs + kBK - 1) / kBK;       // k-slices per tile
  int total_cols;   // mask: column blocks to scan; CSR: entries
  if constexpr (Tiles::kMaskRow) total_cols = tiles.ncols();
  else total_cols = tiles.count(r);

  for (int c_lo = 0; c_lo < total_cols; c_lo += kListCap) {
    const int c_hi = min(c_lo + kListCap, total_cols);
    int n_tiles;
    if constexpr (Tiles::kMaskRow) {
      n_tiles = compact_tiles(tiles, r, c_lo, c_hi, list, warp_tot);
    } else {
      n_tiles = c_hi - c_lo;
      for (int i = tid; i < n_tiles; i += kTcThreads) {
        KC_SH(&list[i], sizeof(int));
        list[i] = tiles.col(r, c_lo + i);
      }
      KC_JITTER(c_lo);
      __syncthreads();
    }
    const int n_slices = n_tiles * spt;

    // issue the copies of slice s into stage s % kStages
    auto load = [&](int s) {
      const int i = s / spt;
      const int kk = (s - i * spt) * kBK;        // k offset inside the tile
      KC_SH(&list[i], sizeof(int));
      const int cb = list[i];
      const int k_tile = min(bs, K - cb * bs);   // the tile's columns in K
      int lda;
      const double* at = tiles.tile(r, c_lo + i, cb, lda);
      const int n_k = max(0, min(VEC, k_tile - kk - a_k));
      const double* ap =
          at + (long long)(row0 - r * bs + a_row) * lda + kk + a_k;
      double* sa = as + (s % kStages) * kStageA + sa_off;
#pragma unroll
      for (int j = 0; j < kBM / kARowStep; ++j) {
        const int n = row0 + a_row + j * kARowStep < row_end ? n_k : 0;
        cp_async<VEC>(sa + j * kARowStep * kLdA,
                      n ? ap + (long long)j * kARowStep * lda : at, n);
      }
      const double* bp =
          b + (long long)(cb * bs + kk + b_kr) * ldb + col0 + b_col;
      double* sb = bsm + (s % kStages) * kStageB + sb_off;
#pragma unroll
      for (int j = 0; j < kBK / kBRowStep; ++j) {
        const int n = kk + b_kr + j * kBRowStep < k_tile ? n_col : 0;
        cp_async<VEC>(sb + j * kBRowStep * kLdB,
                      n ? bp + (long long)j * kBRowStep * ldb : b, n);
      }
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_slices) load(s);
      cp_commit();
    }
    for (int s = 0; s < n_slices; ++s) {
      cp_wait<kStages - 2>();
      KC_JITTER(s);
      __syncthreads();   // slice s landed; stage (s - 1) % kStages is free
      if (s + kStages - 1 < n_slices) load(s + kStages - 1);
      cp_commit();
      const double* sa = as + (s % kStages) * kStageA + wm * kLdA;
      const double* sb = bsm + (s % kStages) * kStageB + wn;
      // the first and last fragment doubles this thread reads of the slice
      KC_SH(sa + g * kLdA + t, sizeof(double));
      KC_SH(sa + (56 + g) * kLdA + 12 + t, sizeof(double));
      KC_SH(sb + t * kLdB + g, sizeof(double));
      KC_SH(sb + (12 + t) * kLdB + 24 + g, sizeof(double));
#pragma unroll
      for (int k8 = 0; k8 < kBK; k8 += 8) {
        double bf[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const double* p = sb + (k8 + t) * kLdB + j * 8 + g;
          bf[j][0] = p[0];
          bf[j][1] = p[4 * kLdB];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double* p = sa + (i * 16 + g) * kLdA + k8 + t;
          const double af[4] = {p[0], p[8 * kLdA], p[4], p[8 * kLdA + 4]};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_f64(acc[i][j], af, bf[j]);
        }
      }
    }
    cp_wait<0>();
    KC_JITTER(c_lo);
    __syncthreads();   // the stages and the list are free for the next pass
  }

  // 16-byte stores where every row start of C is 16-byte aligned
  const bool st16 = ((reinterpret_cast<uintptr_t>(c) & 15u) | (ldc & 1)) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + wm + i * 16 + g + 8 * h;
      if (gr >= row_end) continue;
      double* dst = c + (size_t)gr * ldc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gc = col0 + wn + j * 8 + 2 * t;   // even
        if (gc + 1 < N && st16) {
          KC_ST(dst + gc, 2 * sizeof(double));
          *reinterpret_cast<double2*>(dst + gc) =
              make_double2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (gc < N) {
            KC_ST(&dst[gc], sizeof(double));
            dst[gc] = acc[i][j][2 * h];
          }
          if (gc + 1 < N) {
            KC_ST(&dst[gc + 1], sizeof(double));
            dst[gc + 1] = acc[i][j][2 * h + 1];
          }
        }
      }
    }
  }
}

template <typename Tiles>
int launch_f64(Tiles tiles, bool vec16, const double* b, int ldb, double* c,
               int ldc, int M, int K, int N, int bs, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bs <= 0) return (int)cudaErrorInvalidValue;
  const int nbr = (M + bs - 1) / bs;
  const int sub_tiles = (bs + kBM - 1) / kBM;
  const long long row_tiles = (long long)nbr * sub_tiles;
  const long long col_tiles = (N + kBN - 1) / kBN;
  if (row_tiles * col_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  auto kern = vec16 ? bsmm_f64_tc<2, Tiles> : bsmm_f64_tc<1, Tiles>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(row_tiles * col_tiles), kTcThreads, kTcSmem,
         (cudaStream_t)stream>>>(tiles, b, ldb, c, ldc, M, K, N, bs,
                                 sub_tiles, (int)row_tiles, (int)col_tiles);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// ---------------------------------------------------------------------------
// float32: the first body, FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTM = 64, kTN = 64, kTK = 16;
constexpr int kThreads = 256;   // 16 x 16, each thread a 4 x 4 micro-tile

template <typename Tiles>
__global__ void __launch_bounds__(kThreads)
bsmm_fma(Tiles tiles, const float* __restrict__ b, int ldb,
         float* __restrict__ c, int ldc, int M, int K, int N, int bs,
         int sub_tiles) {
  __shared__ float As[kTM][kTK];
  __shared__ float Bs[kTK][kTN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r = blockIdx.y / sub_tiles;
  const int row0 = r * bs + (blockIdx.y % sub_tiles) * kTM;
  const int row_end = min(min(row0 + kTM, (r + 1) * bs), M);
  const int col0 = blockIdx.x * kTN;
  if (row0 >= row_end) return;   // uniform across the block

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  int e, stop;   // mask: column blocks; CSR: entries of the block-row
  if constexpr (Tiles::kMaskRow) {
    e = tiles.next(r, -1);
    stop = tiles.ncols();
  } else {
    e = 0;
    stop = tiles.count(r);
  }
  while (e < stop) {
    int cb;
    if constexpr (Tiles::kMaskRow) cb = e;
    else cb = tiles.col(r, e);
    int lda;
    const float* at = tiles.tile(r, e, cb, lda);   // element (r*bs, cb*bs)
    const int k0 = cb * bs;
    const int k_end = min(k0 + bs, K);
    for (int kk = k0; kk < k_end; kk += kTK) {
      KC_JITTER(kk);
      for (int l = threadIdx.x; l < kTM * kTK; l += kThreads) {
        const int i = l / kTK, q = l % kTK;
        const int gr = row0 + i, gk = kk + q;
        if (gr < row_end && gk < k_end)
          KC_LD(&at[(size_t)(gr - r * bs) * lda + (gk - k0)], sizeof(float));
        KC_SH(&As[i][q], sizeof(float));
        As[i][q] = (gr < row_end && gk < k_end)
                       ? at[(size_t)(gr - r * bs) * lda + (gk - k0)]
                       : 0.f;
      }
      for (int l = threadIdx.x; l < kTK * kTN; l += kThreads) {
        const int q = l / kTN, j = l % kTN;
        const int gk = kk + q, gc = col0 + j;
        if (gk < k_end && gc < N)
          KC_LD(&b[(size_t)gk * ldb + gc], sizeof(float));
        KC_SH(&Bs[q][j], sizeof(float));
        Bs[q][j] = (gk < k_end && gc < N) ? b[(size_t)gk * ldb + gc] : 0.f;
      }
      KC_JITTER(kk);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kTK; ++q) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][q];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[q][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      KC_JITTER(kk);
      __syncthreads();
    }
    if constexpr (Tiles::kMaskRow) e = tiles.next(r, e);
    else ++e;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < N) {
        KC_ST(&c[(size_t)gr * ldc + gc], sizeof(float));
        c[(size_t)gr * ldc + gc] = acc[i][j];
      }
    }
  }
}

template <typename Tiles>
int launch_f32(Tiles tiles, const float* b, int ldb, float* c, int ldc,
               int M, int K, int N, int bs, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bs <= 0) return (int)cudaErrorInvalidValue;
  const int nbr = (M + bs - 1) / bs;
  const int sub_tiles = (bs + kTM - 1) / kTM;
  if ((long long)nbr * sub_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((N + kTN - 1) / kTN, nbr * sub_tiles);
  bsmm_fma<Tiles><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tiles, b, ldb, c, ldc, M, K, N, bs, sub_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bsmm_csr_f64(const double* values, const int* row_ptr, const int* col_idx,
                 int bs, const double* b, int ldb, double* c, int ldc, int M,
                 int K, int N, void* stream) {
  CsrTiles<double> t{values, row_ptr, col_idx, bs};
  const bool vec16 = aligned16(values) && aligned16(b) && bs % 2 == 0 &&
                     ldb % 2 == 0;
  return launch_f64(t, vec16, b, ldb, c, ldc, M, K, N, bs, stream);
}

int bsmm_csr_f32(const float* values, const int* row_ptr, const int* col_idx,
                 int bs, const float* b, int ldb, float* c, int ldc, int M,
                 int K, int N, void* stream) {
  CsrTiles<float> t{values, row_ptr, col_idx, bs};
  return launch_f32(t, b, ldb, c, ldc, M, K, N, bs, stream);
}

int bsmm_mask_f64(const double* a, int lda, const int8_t* mask, int nbc,
                  int bs, const double* b, int ldb, double* c, int ldc, int M,
                  int K, int N, void* stream) {
  MaskTiles<double> t{a, lda, mask, nbc, bs};
  const bool vec16 = aligned16(a) && aligned16(b) && bs % 2 == 0 &&
                     lda % 2 == 0 && ldb % 2 == 0;
  return launch_f64(t, vec16, b, ldb, c, ldc, M, K, N, bs, stream);
}

int bsmm_mask_f32(const float* a, int lda, const int8_t* mask, int nbc,
                  int bs, const float* b, int ldb, float* c, int ldc, int M,
                  int K, int N, void* stream) {
  MaskTiles<float> t{a, lda, mask, nbc, bs};
  return launch_f32(t, b, ldb, c, ldc, M, K, N, bs, stream);
}

}  // extern "C"
