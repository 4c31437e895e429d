// Device pieces shared by the kernels that sample patches (align.cu's B3, B4
// and align_levels_kernel, klt.cu's klt_track_kernel): the threads a patch
// centre takes and the bilinear taps of ops/interp.bilinear.
//
// Each function computes interp.bilinear's operations in its order, in
// float32 (the library is built with -fmad=false and no fast math), so every
// kernel that samples with them gives the plain version's samples bit for
// bit.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clampf_nan(float x, float lo, float hi) {
  // like torch.clamp / jnp.clip: a NaN stays NaN
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Threads per centre for P x P patches.
__host__ __device__ constexpr int group_size(int P) {
  return P * P <= 16 ? 16 : (P * P <= 64 ? 32 : 128);
}

// The taps of one sample, as interp.bilinear computes them.
struct Taps {
  int iu0, iu1, iv0, iv1;
  float du, dv;
};

// The taps at (u, v) of an H x W image: clamped to [0, umax] x [0, vmax]
// (umax = W - 1.000001, vmax = H - 1.000001, rounded to float32 as
// torch.clamp rounds its bound), then the indices clamped again (a NaN
// coordinate converts to an arbitrary integer, which the reference's gather
// clamps implicitly).
__device__ __forceinline__ Taps taps_at(float u, float v, int H, int W,
                                        float umax, float vmax) {
  u = clampf_nan(u, 0.0f, umax);
  v = clampf_nan(v, 0.0f, vmax);
  const float u0 = floorf(u), v0 = floorf(v);
  Taps t;
  t.du = u - u0;
  t.dv = v - v0;
  t.iu0 = clampi((int)u0, 0, W - 1);
  t.iv0 = clampi((int)v0, 0, H - 1);
  t.iu1 = min(t.iu0 + 1, W - 1);
  t.iv1 = min(t.iv0 + 1, H - 1);
  return t;
}

// The taps of patch pixel p (row-major, P x P) centred at (cu, cv):
// u = cu + (px - (P-1)/2), v likewise, as interp.patch_coords offsets them.
__device__ __forceinline__ Taps taps_of(float cu, float cv, int p, int P,
                                        int H, int W, float umax,
                                        float vmax) {
  const float half = (float)(P - 1) * 0.5f;
  const int py = p / P, px = p - py * P;
  return taps_at(cu + ((float)px - half), cv + ((float)py - half), H, W,
                 umax, vmax);
}

__device__ __forceinline__ float blend(float p00, float p01, float p10,
                                       float p11, float du, float dv) {
  const float top = p00 + du * (p01 - p00);
  const float bot = p10 + du * (p11 - p10);
  return top + dv * (bot - top);
}

}  // namespace
