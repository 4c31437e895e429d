// Image pyramid kernels for Hopper (sm_90a): 2x2 half-sample (B1) and
// central-difference gradients (B2).
//
// Replace the Pallas TPU kernels stereo_svo_tpu/ops/pallas/pyramid_kernel.py
// `halfsample` (_half_kernel) and `gradients` (_grad_kernel). Both are
// memory-bound stencils: one thread per output pixel, neighbouring threads
// on neighbouring columns so every warp reads and writes contiguous rows.
// The TPU's 16-row VMEM tiling has no counterpart here.
//
// Plain C interface (loaded with ctypes); every entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__global__ void halfsample_kernel(const float* __restrict__ in,
                                  float* __restrict__ out,
                                  int W, int H2, int W2) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W2 || y >= H2) return;
  const float* r0 = in + (size_t)(2 * y) * W + 2 * x;
  const float* r1 = r0 + W;
  // same summation order as the plain version: ((a + b) + c) + d
  out[(size_t)y * W2 + x] = (((r0[0] + r0[1]) + r1[0]) + r1[1]) * 0.25f;
}

__global__ void gradients_kernel(const float* __restrict__ in,
                                 float* __restrict__ gx,
                                 float* __restrict__ gy, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)y * W + x;
  float vx = 0.0f, vy = 0.0f;
  if (x > 0 && x < W - 1) vx = 0.5f * (in[i + 1] - in[i - 1]);
  if (y > 0 && y < H - 1) vy = 0.5f * (in[i + W] - in[i - W]);
  gx[i] = vx;
  gy[i] = vy;
}

}  // namespace

extern "C" int svo_halfsample(const float* in, float* out, int H, int W,
                              void* stream) {
  const int H2 = H / 2, W2 = W / 2;
  if (H2 > 0 && W2 > 0) {
    dim3 block(32, 8);
    dim3 grid((W2 + block.x - 1) / block.x, (H2 + block.y - 1) / block.y);
    halfsample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, out, W,
                                                                 H2, W2);
  }
  return (int)cudaGetLastError();
}

extern "C" int svo_gradients(const float* in, float* gx, float* gy, int H,
                             int W, void* stream) {
  if (H > 0 && W > 0) {
    dim3 block(32, 8);
    dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
    gradients_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, gx, gy, H,
                                                                W);
  }
  return (int)cudaGetLastError();
}
