// Negative controls of the checked build (kcheck.cuh): five tiny kernels,
// each with one planted fault that the check must report under its rule.
// A checker that finds nothing in the port's kernels proves nothing until
// it finds these.  Built only with -DREPRO_KCHECK (kernels.build,
// checked=True) and run by repro_torch.analysis.kernelpass.probes; no
// kernel of the port calls them.
//
// Each launcher takes a float input `in` and a float output `out` of n
// elements (n a multiple of 256) and the stream, and returns a
// cudaError_t:
//   kc_probe_store_past_end  every element stored, and one more past the
//                            end                                 -> CA403
//   kc_probe_tile_unstored   one 256-element tile never stored   -> CA402
//   kc_probe_double_store    two blocks store the last tile, the same
//                            values both times                   -> CA401
//   kc_probe_smem_race       warp 1 reads shared data that warp 0 writes,
//                            with the __syncthreads between them removed:
//                            a result only jitter changes        -> CA401
//   kc_probe_smem_past_end   a shared access one past the block's
//                            allocation (checked, not made: the card
//                            would fault)                        -> CA403
#include <cuda_runtime.h>
#include <stdint.h>

#include "../kcheck.cuh"

namespace {

constexpr int kTile = 256;

__global__ void store_past_end(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n) return;
  if (i < n) KC_LD(&in[i], sizeof(float));
  KC_ST(&out[i], sizeof(float));
  out[i] = i < n ? in[i] : 0.f;   // planted: i == n is one past the end
}

__global__ void tile_unstored(const float* in, float* out, int n) {
  if (blockIdx.x == 1) return;    // planted: tile 1 is never stored
  const int i = blockIdx.x * kTile + threadIdx.x;
  KC_LD(&in[i], sizeof(float));
  KC_ST(&out[i], sizeof(float));
  out[i] = in[i];
}

__global__ void double_store(const float* in, float* out, int n) {
  // planted: the last two blocks both own the last tile
  const int tile = min((int)blockIdx.x, n / kTile - 1);
  const int i = tile * kTile + threadIdx.x;
  KC_LD(&in[i], sizeof(float));
  KC_ST(&out[i], sizeof(float));
  out[i] = in[i];
}

__global__ void smem_race(const float* in, float* out, int n) {
  __shared__ float buf[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  if (warp == 0) buf[lane] = 0.f;
  KC_JITTER(0);
  __syncthreads();
  if (warp == 0) {
    KC_JITTER(1);
    KC_LD(&in[i], sizeof(float));
    buf[lane] = in[i];
  }
  // planted: the __syncthreads that orders the write above before the
  // read below is missing
  if (warp == 1) {
    KC_JITTER(2);
    KC_ST(&out[i], sizeof(float));
    out[i] = buf[lane];
  }
}

__global__ void smem_past_end(const float* in, float* out, int n) {
  __shared__ float buf[kTile];
  const int t = threadIdx.x, i = blockIdx.x * kTile + t;
  KC_LD(&in[i], sizeof(float));
  KC_SH(&buf[t + 1], sizeof(float));   // planted: buf[kTile] for the last
  buf[t] = in[i];
  KC_JITTER(0);
  __syncthreads();
  KC_ST(&out[i], sizeof(float));
  out[i] = buf[kTile - 1 - t];
}

int done() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

int kc_probe_store_past_end(const float* in, float* out, int n,
                            void* stream) {
  store_past_end<<<n / kTile + 1, kTile, 0, (cudaStream_t)stream>>>(in, out,
                                                                    n);
  return done();
}

int kc_probe_tile_unstored(const float* in, float* out, int n,
                           void* stream) {
  tile_unstored<<<n / kTile, kTile, 0, (cudaStream_t)stream>>>(in, out, n);
  return done();
}

int kc_probe_double_store(const float* in, float* out, int n, void* stream) {
  double_store<<<n / kTile + 1, kTile, 0, (cudaStream_t)stream>>>(in, out, n);
  return done();
}

int kc_probe_smem_race(const float* in, float* out, int n, void* stream) {
  smem_race<<<n / 32, 64, 0, (cudaStream_t)stream>>>(in, out, n);
  return done();
}

int kc_probe_smem_past_end(const float* in, float* out, int n,
                           void* stream) {
  smem_past_end<<<n / kTile, kTile, 0, (cudaStream_t)stream>>>(in, out, n);
  return done();
}

}  // extern "C"
