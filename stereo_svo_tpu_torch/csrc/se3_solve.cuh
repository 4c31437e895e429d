// Device pieces shared by the Gauss-Newton kernels (align.cu's
// align_levels_kernel and pose_refine.cu's refine_pose_kernel): the SE(3)
// exponential and composition of geometry/se3.py, and the 6x6 solve of
// ops/solve.chol_solve_small on the lanes of one warp.
//
// Each function computes the PyTorch chain's operations in its order, in
// float32 (the library is built with -fmad=false and no fast math), so a
// kernel that calls them repeats the chain's rounding wherever the chain's
// order is fixed.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clamp_lo_nan(float x, float lo) {
  return x < lo ? lo : x;   // torch.clamp(x, min=lo): a NaN stays NaN
}

// se3.exp: twist (v, w) -> E (3x4, row-major), Rodrigues with the same
// Taylor branches.
__device__ void se3_exp(const float* xi, float* E) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float th = sqrtf(th2 + 1e-16f);
  float A, B, C;   // the small-angle branch skips the trigonometry
  if (th2 < 1e-8f) {
    A = 1.0f - th2 / 6.0f;
    B = 0.5f - th2 / 24.0f;
    C = (float)(1.0 / 6.0) - th2 / 120.0f;
  } else {
    const float sn = sinf(th), cs = cosf(th);
    A = sn / th;
    B = (1.0f - cs) / th2;
    C = (th - sn) / (th2 * th);
  }
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float WW[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      WW[i * 3 + j] = (W[i * 3] * W[j] + W[i * 3 + 1] * W[3 + j]) +
                      W[i * 3 + 2] * W[6 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.0f : 0.0f;
      E[i * 4 + j] = (I + A * W[i * 3 + j]) + B * WW[i * 3 + j];
      const float V = (I + B * W[i * 3 + j]) + C * WW[i * 3 + j];
      t = j == 0 ? V * xi[0] : t + V * xi[j];
    }
    E[i * 4 + 3] = t;
  }
}

// out = A o B (se3.compose: B first, then A; rotations multiplied, A's
// translation added). out may not alias A or B.
__device__ __forceinline__ void se3_compose(const float* A, const float* B,
                                            float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = (A[i * 4] * B[j] + A[i * 4 + 1] * B[4 + j]) +
                      A[i * 4 + 2] * B[8 + j];
      out[i * 4 + j] = j == 3 ? s + A[i * 4 + 3] : s;
    }
  }
}

// T <- T o E.
__device__ void se3_compose_into(float* T, const float* E) {
  float out[12];
  se3_compose(T, E, out);
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = out[k];
}

// Index of H[r][c], r <= c, in a row-major upper triangle of 21 floats.
__host__ __device__ constexpr int upper6(int r, int c) {
  return r * 6 - r * (r - 1) / 2 + (c - r);
}

// The regularised 6x6 solve of a Gauss-Newton refresh pass, on the 32
// lanes of one warp (every lane calls it): H from its upper triangle U
// (21 floats, row-major), each diagonal entry replaced by diag(entry, tr)
// with tr H's trace summed in row order, factored by
// ops/solve.chol_solve_small's rule (lane i < 6 holding row i, the rows of
// a column computed at once, each entry with the chain's operations in its
// order, pivot floor 1e-20); then lanes 0-6 solve for the columns of H^-1
// (right-hand side e_lane) and for the step (g, lane 6). L (36 floats)
// receives the factor, X (42) the 7 solutions, lane i's at X[6 i]: H^-1
// row-major, then the step. U, g, L and X lie in shared memory.
template <class Diag>
__device__ void solve6_lanes(const float* U, const float* g, Diag diag,
                             float* L, float* X) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float tr = U[0];   // the diagonal sits at 0, 6, 11, 15, 18, 20
#pragma unroll
  for (int i = 1; i < 6; ++i) tr = tr + U[upper6(i, i)];
  const int row = lane < 6 ? lane : 5;
  float A[6], Lr[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int r = min(row, j), c = max(row, j);
    A[j] = U[upper6(r, c)];
    if (j == row) A[j] = diag(A[j], tr);
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {   // column j: s - L[row][q] L[j][q], q up
    float s = A[j];
#pragma unroll
    for (int q = 0; q < j; ++q) s = s - Lr[q] * __shfl_sync(full, Lr[q], j);
    const float d = __shfl_sync(full, sqrtf(clamp_lo_nan(s, 1e-20f)), j);
    Lr[j] = row == j ? d : (row > j ? s / d : 0.0f);
  }
  if (lane < 6) {
#pragma unroll
    for (int j = 0; j < 6; ++j) L[lane * 6 + j] = Lr[j];
  }
  __syncwarp();
  if (lane < 7) {   // e_lane (lane < 6) or g (lane 6)
    float yv[6], x[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float s = lane == 6 ? g[i] : (i == lane ? 1.0f : 0.0f);
#pragma unroll
      for (int q = 0; q < i; ++q) s = s - L[i * 6 + q] * yv[q];
      yv[i] = s / L[i * 7];
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
      float s = yv[i];
#pragma unroll
      for (int q = i + 1; q < 6; ++q) s = s - L[q * 6 + i] * x[q];
      x[i] = s / L[i * 7];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) X[lane * 6 + i] = x[i];
  }
  __syncwarp();
}

}  // namespace
