// Patch sampling (B3) and the fused Gauss-Newton accumulation of sparse
// image alignment (B4) for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels stereo_svo_tpu/ops/pallas/align_kernel.py
// `sample_patches` (_sample_kernel) and `gn_accumulate` (_gn_kernel).
// On the TPU those kernels read each patch's (P+1)^2 window out of VMEM
// with one-hot micro-matmuls over an 8-aligned 16-row block, because Mosaic
// has no cheap dynamic gather. Hopper gathers natively from L1/L2, so here
// every thread samples its own pixel with four taps.
//
// Border rule: each tap is clamped like ops/interp.bilinear of the
// reference (u in [0, W-1.000001], iu1 = min(iu0+1, W-1)), not the Pallas
// rule that clamps the patch centre. The two agree at interior centres.
//
// Plain C interface (loaded with ctypes); every entry point launches on the
// caller's stream and returns cudaGetLastError(). Built with -fmad=false so
// each multiply and add rounds as in the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kAcc = 30;      // 21 unique H entries, 6 g, cost, n_eff, n_inl
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 128;

__device__ __forceinline__ float clampf_nan(float x, float lo, float hi) {
  // like torch.clamp / jnp.clip: a NaN stays NaN
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Bilinear sample at (u, v) [u = column, v = row], taps clamped to the image.
__device__ __forceinline__ float bilinear(const float* __restrict__ img,
                                          int H, int W, float umax,
                                          float vmax, float u, float v) {
  u = clampf_nan(u, 0.0f, umax);
  v = clampf_nan(v, 0.0f, vmax);
  const float u0 = floorf(u), v0 = floorf(v);
  const float du = u - u0, dv = v - v0;
  const int iu0 = clampi((int)u0, 0, W - 1);
  const int iv0 = clampi((int)v0, 0, H - 1);
  const int iu1 = min(iu0 + 1, W - 1);
  const int iv1 = min(iv0 + 1, H - 1);
  const float p00 = __ldg(img + (size_t)iv0 * W + iu0);
  const float p01 = __ldg(img + (size_t)iv0 * W + iu1);
  const float p10 = __ldg(img + (size_t)iv1 * W + iu0);
  const float p11 = __ldg(img + (size_t)iv1 * W + iu1);
  const float top = p00 + du * (p01 - p00);
  const float bot = p10 + du * (p11 - p10);
  return top + dv * (bot - top);
}

// Sample of patch pixel p (row-major in a P x P grid) of centre m.
__device__ __forceinline__ float patch_pixel(const float* __restrict__ img,
                                             int H, int W,
                                             const float* __restrict__ uv,
                                             long m, int p, int P) {
  const float half = (float)(P - 1) * 0.5f;
  const int py = p / P, px = p - py * P;
  const float umax = (float)((double)W - 1.000001);
  const float vmax = (float)((double)H - 1.000001);
  const float u = uv[2 * m] + ((float)px - half);
  const float v = uv[2 * m + 1] + ((float)py - half);
  return bilinear(img, H, W, umax, vmax, u, v);
}

// B3: one thread per (centre, patch pixel).
__global__ void sample_patch_kernel(const float* __restrict__ img, int H,
                                    int W, const float* __restrict__ uv,
                                    long M, int P, float* __restrict__ out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int P2 = P * P;
  if (idx >= M * P2) return;
  const long m = idx / P2;
  out[idx] = patch_pixel(img, H, W, uv, m, (int)(idx - m * P2), P);
}

// B4, pass 1: each block reduces its grid-strided share of the N*P^2
// (feature, pixel) terms to kAcc partial sums. Fixed assignment of terms to
// threads and a fixed reduction tree: no float atomics, so a run repeats
// bit for bit.
__global__ void gn_partial_kernel(const float* __restrict__ img, int H, int W,
                                  const float* __restrict__ uv,
                                  const float* __restrict__ tmpl,
                                  const float* __restrict__ jac,
                                  const float* __restrict__ mask, int N,
                                  int P, const float* __restrict__ ab,
                                  float huber_k,
                                  float* __restrict__ partials) {
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.0f;
  const float a_il = ab[0], b_il = ab[1];
  const int P2 = P * P;
  const long total = (long)N * P2;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const long m = idx / P2;
    const float cur = patch_pixel(img, H, W, uv, m, (int)(idx - m * P2), P);
    const float msk = mask[idx];
    const float e = cur - (a_il * tmpl[idx] + b_il);
    const float ae = fabsf(e);
    const float w = (ae <= huber_k ? 1.0f : huber_k / fmaxf(ae, 1e-6f)) * msk;
    float J[6], Jw[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      J[i] = jac[idx * 6 + i];
      Jw[i] = J[i] * w;
    }
    int c = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) acc[c++] += Jw[i] * J[j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * e;
    acc[27] += w * e * e;
    acc[28] += msk;
    acc[29] += ae < huber_k ? msk : 0.0f;
  }

  __shared__ float warp_sums[kThreads / 32][kAcc];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kAcc; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w][threadIdx.x];
    partials[(size_t)blockIdx.x * kAcc + threadIdx.x] = s;
  }
}

// B4, pass 2: one block sums the per-block partials in block order and
// writes H (6x6, symmetric), g (6), cost, n_eff, n_inl.
__global__ void gn_final_kernel(const float* __restrict__ partials,
                                int nblocks, float* __restrict__ out) {
  __shared__ float s[kAcc];
  if (threadIdx.x < kAcc) {
    float v = 0.0f;
    for (int b = 0; b < nblocks; ++b) v += partials[(size_t)b * kAcc + threadIdx.x];
    s[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int i = 0; i < 6; ++i) {
      for (int j = i; j < 6; ++j) {
        out[i * 6 + j] = s[c];
        out[j * 6 + i] = s[c];
        ++c;
      }
    }
    for (int i = 0; i < 6; ++i) out[36 + i] = s[21 + i];
    out[42] = s[27];
    out[43] = s[28];
    out[44] = s[29];
  }
}

}  // namespace

extern "C" int svo_sample_patch(const float* img, int H, int W,
                                const float* uv, long M, int P, float* out,
                                void* stream) {
  const long total = M * (long)P * P;
  if (total > 0) {
    const long blocks = (total + kThreads - 1) / kThreads;
    sample_patch_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(img, H, W, uv, M, P, out);
  }
  return (int)cudaGetLastError();
}

// Number of pass-1 blocks for N features of P x P pixels; the caller
// allocates partials of gn_blocks(N, P) * 30 floats.
extern "C" int svo_gn_blocks(int N, int P) {
  const long total = (long)N * P * P;
  long b = (total + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

extern "C" int svo_gn_accumulate(const float* img, int H, int W,
                                 const float* uv, const float* tmpl,
                                 const float* jac, const float* mask, int N,
                                 int P, const float* ab, float huber_k,
                                 float* partials, float* out, void* stream) {
  const int nblocks = svo_gn_blocks(N, P);
  cudaStream_t s = (cudaStream_t)stream;
  gn_partial_kernel<<<nblocks, kThreads, 0, s>>>(img, H, W, uv, tmpl, jac,
                                                 mask, N, P, ab, huber_k,
                                                 partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_final_kernel<<<1, 32, 0, s>>>(partials, nblocks, out);
  return (int)cudaGetLastError();
}
