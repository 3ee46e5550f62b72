// Probe of the f64 mma.sync shapes on Hopper: checks each shape's fragment
// layout against a host product and measures its throughput from
// registers (no memory traffic), 132 x 4 blocks of 8 warps, 8 independent
// accumulators a warp.  It chose the shape of the block-sparse product's
// f64 body (csrc/blocksparse_matmul.cu).  Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o f64_mma_probe f64_mma_probe.cu && ./f64_mma_probe
//
// Fragments (g = lane / 4, t = lane % 4; A row-major, B and D as indexed):
//   m8n8k4:   a = A[g][t]; b = B[t][g]; d = D[g][2t], D[g][2t+1]
//   m16n8kK:  a_i = A[g + 8 (i % 2)][t + 4 (i / 2)], i < K / 2;
//             b_i = B[t + 4 i][g], i < K / 4;
//             d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma884(double* c, const double* a,
                                       const double* b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
__device__ __forceinline__ void mma1684(double* c, const double* a,
                                        const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ __forceinline__ void mma1688(double* c, const double* a,
                                        const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma16816(double* c, const double* a,
                                         const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// D = A B through one mma of shape S (0: m8n8k4, 1-3: m16n8k4/k8/k16)
// with the layouts above; A row-major M x K, B row-major K x N, D
// row-major M x N
template <int S>
__global__ void layout_kernel(const double* A, const double* B, double* C) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[8], b[4], c[4] = {0, 0, 0, 0};
  if (S == 0) {
    a[0] = A[g * 4 + t];
    b[0] = B[t * 8 + g];
    mma884(c, a, b);
    C[g * 8 + 2 * t] = c[0];
    C[g * 8 + 2 * t + 1] = c[1];
    return;
  }
  constexpr int K = S == 1 ? 4 : S == 2 ? 8 : 16;
  for (int i = 0; i < K / 2; ++i)
    a[i] = A[(g + 8 * (i % 2)) * K + t + 4 * (i / 2)];
  for (int i = 0; i < K / 4; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  if (S == 1) mma1684(c, a, b);
  if (S == 2) mma1688(c, a, b);
  if (S == 3) mma16816(c, a, b);
  C[g * 8 + 2 * t] = c[0];
  C[g * 8 + 2 * t + 1] = c[1];
  C[(g + 8) * 8 + 2 * t] = c[2];
  C[(g + 8) * 8 + 2 * t + 1] = c[3];
}

// 8 independent accumulators a warp, operands held in registers
template <int S>
__global__ void tput_kernel(const double* in, double* out, int iters) {
  double a[8], b[4], c[8][4];
  for (int i = 0; i < 8; ++i) a[i] = in[(threadIdx.x + i) & 63];
  for (int i = 0; i < 4; ++i) b[i] = in[(threadIdx.x + 3 * i) & 63];
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) c[j][e] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (S == 0) mma884(c[j], a, b);
      if (S == 1) mma1684(c[j], a, b);
      if (S == 2) mma1688(c[j], a, b);
      if (S == 3) mma16816(c[j], a, b);
    }
  }
  double s = 0;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int S>
void run(const char* name, int M, int K) {
  const int N = 8;
  double* hA = (double*)malloc(M * K * 8);
  double* hB = (double*)malloc(K * N * 8);
  double* hC = (double*)malloc(M * N * 8);
  for (int i = 0; i < M * K; ++i) hA[i] = (double)((i * 7) % 13) - 6.0;
  for (int i = 0; i < K * N; ++i) hB[i] = (double)((i * 5) % 11) - 4.75;
  double *A, *B, *C;
  cudaMalloc(&A, M * K * 8);
  cudaMalloc(&B, K * N * 8);
  cudaMalloc(&C, M * N * 8);
  cudaMemcpy(A, hA, M * K * 8, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hB, K * N * 8, cudaMemcpyHostToDevice);
  layout_kernel<S><<<1, 32>>>(A, B, C);
  const cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(hC, C, M * N * 8, cudaMemcpyDeviceToHost);
  double err = 0;
  for (int m = 0; m < M; ++m)
    for (int n = 0; n < N; ++n) {
      double r = 0;
      for (int k = 0; k < K; ++k) r += hA[m * K + k] * hB[k * N + n];
      err = fmax(err, fabs(r - hC[m * N + n]));
    }
  const int blocks = 132 * 4, threads = 256, iters = 2048;
  double *in, *out;
  cudaMalloc(&in, 64 * 8);
  cudaMemset(in, 0, 64 * 8);
  cudaMalloc(&out, blocks * threads * 8);
  tput_kernel<S><<<blocks, threads>>>(in, out, 16);   // warm-up
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  tput_kernel<S><<<blocks, threads>>>(in, out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * M * N * K * 8.0 * iters * (blocks * threads / 32);
  printf("%s: launch %s, layout max err %.3e, %.2f TFLOP/s (%.3f ms)\n",
         name, cudaGetErrorString(e), err, flops / ms / 1e9, ms);
  cudaFree(A), cudaFree(B), cudaFree(C), cudaFree(in), cudaFree(out);
  free(hA), free(hB), free(hC);
}

int main() {
  run<0>("m8n8k4", 8, 4);
  run<1>("m16n8k4", 16, 4);
  run<2>("m16n8k8", 16, 8);
  run<3>("m16n8k16", 16, 16);
  return 0;
}
