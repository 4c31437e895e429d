// refine_pose_kernel: the whole of frontend/pose_refine.refine (motion-only
// pose refinement, chunked IRLS Gauss-Newton) in one launch, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: it fuses the jnp chain of
// stereo_svo_tpu/frontend/pose_refine.py:refine. Why: as a chain of PyTorch
// ops the refinement of one EuRoC frame was ~2,050 kernel nodes of ~1.2 us
// each (2.78 ms of a 5.9-ms frame graph on an H100); here it is one node.
// What bounds it: the latency of its dependent passes (at the defaults,
// refine_max_iters 10 and refine_irls_chunks 3: 3 refresh passes, 6 inner
// passes and the last), each a sweep over the N features (~100 flops a
// feature) and one reduction over the problem, and on a refresh pass a 6x6
// factorisation and solve; not bytes (N = 192: ~8 KB a pass, read from L1
// after the first) nor flops.
//
// Design. One thread block a problem (the single step: 1 problem; a batch of
// sequences: B), no cluster: a pass is too little work to spread (a cluster
// barrier costs ~0.9 us, align.cu), and within one block a __syncthreads and
// a shuffle tree cost a fraction of that. The block has one thread a feature
// up to 1,024 threads (svo_refine_threads: N = 192 gives 192, 240 gives 256,
// 2,048 gives 1,024 with two features a thread); thread i takes features i,
// i + blockDim, ... in every pass.
//
// A pass transforms each feature by T, projects it (front: z > 1e-3),
// forms the residual, its Huber weight from refine_huber_px and the
// whitening sigma and, where disparities are given, the disparity row
// fx B / clamp(z, 0.2) - d with its weight, as the chain does (a masked
// feature's weight is its weight times 0, so a NaN poisons the sums exactly
// as in the chain). A refresh pass also forms the 2x6 projection Jacobian
// and the disparity Jacobian at the pass's camera points (kept in shared
// memory: the inner passes after it use the same Jacobians, recomputed from
// them bit for bit), sums H's upper triangle and g (27 sums); warp 0 then
// adds the motion prior (xi = se3.log(T o T_prior^-1), with log_so3's
// small-angle branch and V^-1 as the adjugate of V over its determinant, in
// place of the chain's inv_ex) and the regulariser (H + 1e-8 I +
// 1e-4 tr(H)/6 I), solves for H^-1 and the step (solve6_lanes,
// se3_solve.cuh) and sets T <- exp(-step) o T. An inner pass recomputes r
// and w at the new pose, sums g (6 sums) and sets T <- exp(-(H^-1 g)) o T.
// The last pass writes the inlier mask (mask, front, err < refine_outlier_px
// * sigma), the inliers' RMS error and their count.
//
// Reductions: a shuffle tree in each warp, then thread c adds the warps' sums
// in warp order; no float atomics, and the features-to-threads map is fixed
// by N, so a call repeats bit for bit and problem b of a launch equals its
// launch alone. Float32 throughout (-fmad=false, no fast math): the result is
// the chain's arithmetic up to the order of its sums.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include "se3_solve.cuh"   // se3_exp, se3_compose, solve6_lanes

namespace {

constexpr int kRefineMaxThreads = 1024;
constexpr int kRefineMaxWarps = kRefineMaxThreads / 32;
constexpr int kRefineProblems = 65535;   // the grid's problem dimension
constexpr int kRefineOut = 13;           // T (12), RMS error
constexpr size_t kRefineMaxShared = 227 * 1024;   // a block's, on sm_90

struct RefineArgs {
  const float* T_init;               // (3, 4)
  const float* X;                    // (N, 3) world points
  const float* uv;                   // (N, 2) observations
  const unsigned char* mask;         // (N,) bool
  const float* sig;                  // (N,) or null: 1
  const float* sig_d;                // (N,) or null: sig
  const float* T_prior;              // (3, 4) or null: no prior
  const float* disp;                 // (N,) or null: no disparity rows
  const unsigned char* disp_mask;    // (N,) bool, with disp
  long s_T, s_X, s_uv, s_mask, s_sig, s_sig_d, s_prior, s_disp,
      s_disp_mask;                   // problem strides (elements)
  int N, chunks, inner;
  float fx, fy, cx, cy, fxB;         // level-0 intrinsics, fx * baseline
  float huber_k, outlier_px, stereo_w, lam_t, lam_r;
  float* out;                        // (B, 13): T row-major, RMS error
  int* n_inl;                        // (B,)
  unsigned char* inliers;            // (B, N) bool
};

struct RefineShared {
  float part[kRefineMaxWarps * 27];  // block_sum's warp sums
  float sum[27];                     // block_sum's totals
  float T[12];
  float T_prior_inv[12];
  float Hinv[36];
  float L[36];
  float X[42];
};

// Sum each of C per-thread values over the block: a fixed shuffle tree in
// each warp, then thread c adds the warps' sums in warp order into sh.sum[c].
// Every thread calls it; sh.sum is read after it returns.
template <int C>
__device__ __forceinline__ void block_sum(const float (&v)[C],
                                          RefineShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float x = v[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) sh.part[warp * C + c] = x;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float s = 0.0f;
    for (int i = 0; i < nw; ++i) s += sh.part[i * C + threadIdx.x];
    sh.sum[threadIdx.x] = s;
  }
  __syncthreads();
}

// One feature's inputs.
struct Feature {
  float x0, x1, x2;   // world point
  float u, v;         // observation
  float s, sd;        // sigmas of the reprojection and disparity rows
  float d;            // observed disparity (0 without)
  bool m, dm;         // mask, disparity mask
};

__device__ __forceinline__ Feature load_feature(
    const float* __restrict__ X,
    const float* __restrict__ uv, const unsigned char* __restrict__ mask,
    const float* sig, const float* sig_d, const float* disp,
    const unsigned char* disp_mask, int n) {
  Feature f;
  f.x0 = __ldg(X + 3 * n);
  f.x1 = __ldg(X + 3 * n + 1);
  f.x2 = __ldg(X + 3 * n + 2);
  f.u = __ldg(uv + 2 * n);
  f.v = __ldg(uv + 2 * n + 1);
  f.m = mask[n] != 0;
  f.s = sig ? __ldg(sig + n) : 1.0f;
  f.sd = sig_d ? __ldg(sig_d + n) : f.s;
  f.d = disp ? __ldg(disp + n) : 0.0f;
  f.dm = disp ? disp_mask[n] != 0 : false;
  return f;
}

// Huber weight of a whitened residual norm (pose_refine.refine's huber).
__device__ __forceinline__ float huber(float rn, float k) {
  return rn <= k ? 1.0f : k / clamp_lo_nan(rn, 1e-6f);
}

// The residual of one feature at pose T: its camera point xc, whether it
// is in front, the reprojection residual (r0, r1) with its weight w, and
// (with disparities) the disparity residual rd with its weight wd.
struct Residual {
  float xc[3];
  float r0, r1, w, rd, wd;
};

__device__ __forceinline__ Residual residual(const RefineArgs& a,
                                             const float* T,
                                             const Feature& f, bool use_disp) {
  Residual r;
#pragma unroll
  for (int i = 0; i < 3; ++i)   // se3.transform: (R * x).sum(-1) + t
    r.xc[i] = ((T[i * 4] * f.x0 + T[i * 4 + 1] * f.x1) + T[i * 4 + 2] * f.x2) +
              T[i * 4 + 3];
  const bool front = r.xc[2] > 1e-3f;   // camera.project
  const float zs = front ? r.xc[2] : 1.0f;
  r.r0 = (a.fx * r.xc[0] / zs + a.cx) - f.u;
  r.r1 = (a.fy * r.xc[1] / zs + a.cy) - f.v;
  const float rn = sqrtf(r.r0 * r.r0 + r.r1 * r.r1) / f.s;
  r.w = (huber(rn, a.huber_k) * (1.0f / (f.s * f.s))) *
        ((f.m && front) ? 1.0f : 0.0f);
  r.rd = r.wd = 0.0f;
  if (use_disp) {
    r.rd = a.fxB / clamp_lo_nan(r.xc[2], 0.2f) - f.d;
    r.wd = ((huber(fabsf(r.rd) / f.sd, a.huber_k) *
             (1.0f / (f.sd * f.sd))) * a.stereo_w) *
           ((f.m && front && f.dm) ? 1.0f : 0.0f);
  }
  return r;
}

// camera.proj_pose_jacobian (J, 2x6 row-major) and the disparity Jacobian
// (Jd, 6) at camera point xc, with the chain's operations (its zeros
// multiplied in, so a non-finite point gives the chain's NaNs).
__device__ __forceinline__ void jacobians(const RefineArgs& a,
                                          const float* xc, float* J,
                                          float* Jd) {
  const float x = xc[0], y = xc[1], z = xc[2];
  const float iz = 1.0f / clamp_lo_nan(z, 1e-3f);
  const float iz2 = iz * iz;
  const float Jp[6] = {a.fx * iz, 0.0f, (-a.fx * x) * iz2,
                       0.0f, a.fy * iz, (-a.fy * y) * iz2};
  const float hat[9] = {0.0f, -z, y, z, 0.0f, -x, -y, x, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      J[r * 6 + j] = Jp[r * 3 + j];
      J[r * 6 + 3 + j] = -((Jp[r * 3] * hat[j] + Jp[r * 3 + 1] * hat[3 + j]) +
                           Jp[r * 3 + 2] * hat[6 + j]);
    }
  }
  const float zd = clamp_lo_nan(z, 0.2f);
  const float s = -a.fxB / (zd * zd);
  Jd[0] = s * 0.0f;
  Jd[1] = s * 0.0f;
  Jd[2] = s * 1.0f;
  Jd[3] = s * y;
  Jd[4] = s * -x;
  Jd[5] = s * 0.0f;
}

// se3.log of a pose (3x4 row-major) into xi (v, w): log_so3 with its
// small-angle branch, then v = V(w)^-1 t, V^-1 as adj(V) / det(V).
__device__ void se3_log(const float* T, float* xi) {
  const float trace = (T[0] + T[5]) + T[10];
  float cos_t = (trace - 1.0f) * 0.5f;
  cos_t = cos_t < -1.0f ? -1.0f : cos_t;   // torch.clamp: NaN stays NaN
  cos_t = cos_t > 1.0f ? 1.0f : cos_t;
  const float vee[3] = {T[9] - T[6], T[2] - T[8], T[4] - T[1]};
  const bool small = cos_t > (float)(1.0 - 1e-5);
  const float cos_safe = small ? 0.0f : cos_t;
  const float theta = acosf(cos_safe);
  const float sin_safe =
      sqrtf(clamp_lo_nan(1.0f - cos_safe * cos_safe, 1e-12f));
  const float scale_big = theta / (2.0f * sin_safe);
  const float omc = 1.0f - cos_t;
  const float scale_small = (0.5f + omc / 6.0f) + ((omc * omc) * 7.0f) / 90.0f;
  const float scale = small ? scale_small : scale_big;
  const float w0 = scale * vee[0], w1 = scale * vee[1], w2 = scale * vee[2];
  // V(w), as geometry/se3._V
  const float th2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float th = sqrtf(th2 + 1e-16f);
  float B, C;
  if (th2 < 1e-8f) {
    B = 0.5f - th2 / 24.0f;
    C = (float)(1.0 / 6.0) - th2 / 120.0f;
  } else {
    B = (1.0f - cosf(th)) / th2;
    C = (th - sinf(th)) / (th2 * th);
  }
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float V[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float ww = (W[i * 3] * W[j] + W[i * 3 + 1] * W[3 + j]) +
                       W[i * 3 + 2] * W[6 + j];
      V[i * 3 + j] = ((i == j ? 1.0f : 0.0f) + B * W[i * 3 + j]) + C * ww;
    }
  // adjugate (cofactors, transposed) over the determinant
  float adj[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int r0 = (j + 1) % 3, r1 = (j + 2) % 3;
      const int c0 = (i + 1) % 3, c1 = (i + 2) % 3;
      adj[i * 3 + j] = V[r0 * 3 + c0] * V[r1 * 3 + c1] -
                       V[r0 * 3 + c1] * V[r1 * 3 + c0];
    }
  const float det =
      (V[0] * adj[0] + V[1] * adj[3]) + V[2] * adj[6];
  const float t[3] = {T[3], T[7], T[11]};
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xi[i] = ((adj[i * 3] / det) * t[0] + (adj[i * 3 + 1] / det) * t[1]) +
            (adj[i * 3 + 2] / det) * t[2];
  xi[3] = w0;
  xi[4] = w1;
  xi[5] = w2;
}

// T <- exp(xi) o T, T in shared memory.
__device__ __forceinline__ void left_update(float* T, const float* xi) {
  float E[12], out[12];
  se3_exp(xi, E);
  se3_compose(E, T, out);
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = out[k];
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    refine_pose_kernel(RefineArgs a) {
  extern __shared__ float4 s_xc[];   // each feature's refresh camera point
  __shared__ RefineShared sh;
  const size_t y = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, N = a.N;
  const float* X = a.X + y * a.s_X;
  const float* uv = a.uv + y * a.s_uv;
  const unsigned char* mask = a.mask + y * a.s_mask;
  const float* sig = a.sig ? a.sig + y * a.s_sig : nullptr;
  const float* sig_d = a.sig_d ? a.sig_d + y * a.s_sig_d : sig;
  const float* disp = a.disp ? a.disp + y * a.s_disp : nullptr;
  const unsigned char* disp_mask =
      a.disp ? a.disp_mask + y * a.s_disp_mask : nullptr;
  const bool use_disp = disp != nullptr;
  const bool use_prior = a.T_prior != nullptr;
  if (tid < 12) sh.T[tid] = a.T_init[y * a.s_T + tid];
  if (tid == 0 && use_prior) {   // se3.inverse(T_prior)
    const float* P = a.T_prior + y * a.s_prior;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) sh.T_prior_inv[i * 4 + j] = P[j * 4 + i];
      sh.T_prior_inv[i * 4 + 3] =
          -((P[i] * P[3] + P[4 + i] * P[7]) + P[8 + i] * P[11]);
    }
  }
  __syncthreads();

  for (int ch = 0; ch < a.chunks; ++ch) {
    // ---- refresh pass: H, g at T; Jacobians frozen for the inner passes
    float T[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) T[i] = sh.T[i];
    float acc[27];
#pragma unroll
    for (int c = 0; c < 27; ++c) acc[c] = 0.0f;
    for (int n = tid; n < N; n += nt) {
      const Feature f = load_feature(X, uv, mask, sig, sig_d, disp,
                                     disp_mask, n);
      const Residual r = residual(a, T, f, use_disp);
      s_xc[n] = make_float4(r.xc[0], r.xc[1], r.xc[2], 0.0f);
      float J[12], Jd[6];
      jacobians(a, r.xc, J, Jd);
      const float res[2] = {r.r0, r.r1};
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        float Jw[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) Jw[i] = J[row * 6 + i] * r.w;
        int c = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j) acc[c++] += Jw[i] * J[row * 6 + j];
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * res[row];
      }
      if (use_disp) {
        float Jw[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) Jw[i] = Jd[i] * r.wd;
        int c = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j) acc[c++] += Jw[i] * Jd[j];
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * r.rd;
      }
    }
    block_sum<27>(acc, sh);
    if (tid < 32) {
      if (tid == 0 && use_prior) {   // H + diag(lam), g + lam * xi
        float D[12], xi[6];
        se3_compose(sh.T, sh.T_prior_inv, D);
        se3_log(D, xi);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float lam = i < 3 ? a.lam_t : a.lam_r;
          sh.sum[upper6(i, i)] = sh.sum[upper6(i, i)] + lam;
          sh.sum[21 + i] = sh.sum[21 + i] + lam * xi[i];
        }
      }
      __syncwarp();
      solve6_lanes(sh.sum, sh.sum + 21,
                   [](float h, float tr) {   // H + 1e-8 I + 1e-4 tr/6 I
                     return (h + 1e-8f) + 1e-4f * tr / 6.0f;
                   },
                   sh.L, sh.X);
      if (tid == 0) {   // T <- exp(-step) o T
#pragma unroll
        for (int i = 0; i < 36; ++i) sh.Hinv[i] = sh.X[i];
        float xi[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) xi[i] = -sh.X[36 + i];
        left_update(sh.T, xi);
      }
    }
    __syncthreads();

    // ---- inner passes: r and w anew, J and H^-1 of the refresh pass ----
    for (int it = 0; it < a.inner; ++it) {
#pragma unroll
      for (int i = 0; i < 12; ++i) T[i] = sh.T[i];
      float gs[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) gs[i] = 0.0f;
      for (int n = tid; n < N; n += nt) {
        const Feature f = load_feature(X, uv, mask, sig, sig_d, disp,
                                       disp_mask, n);
        const Residual r = residual(a, T, f, use_disp);
        const float4 p = s_xc[n];
        const float xc[3] = {p.x, p.y, p.z};
        float J[12], Jd[6];
        jacobians(a, xc, J, Jd);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          gs[i] += (J[i] * r.w) * r.r0;
          gs[i] += (J[6 + i] * r.w) * r.r1;
        }
        if (use_disp) {
#pragma unroll
          for (int i = 0; i < 6; ++i) gs[i] += (Jd[i] * r.wd) * r.rd;
        }
      }
      block_sum<6>(gs, sh);
      if (tid == 0) {   // T <- exp(-(H^-1 g)) o T
        float xi[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float s = sh.Hinv[i * 6] * sh.sum[0];
#pragma unroll
          for (int j = 1; j < 6; ++j) s = s + sh.Hinv[i * 6 + j] * sh.sum[j];
          xi[i] = -s;
        }
        left_update(sh.T, xi);
      }
      __syncthreads();
    }
  }

  // ---- the last pass: inliers and their RMS error at the final pose ----
  float T[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) T[i] = sh.T[i];
  float st[2] = {0.0f, 0.0f};   // sum of squared errors, inliers
  unsigned char* inl = a.inliers + y * (size_t)N;
  for (int n = tid; n < N; n += nt) {
    const Feature f = load_feature(X, uv, mask, sig, sig_d, disp,
                                   disp_mask, n);
    float xc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      xc[i] = ((T[i * 4] * f.x0 + T[i * 4 + 1] * f.x1) + T[i * 4 + 2] * f.x2) +
              T[i * 4 + 3];
    const bool front = xc[2] > 1e-3f;
    const float zs = front ? xc[2] : 1.0f;
    const float e0 = (a.fx * xc[0] / zs + a.cx) - f.u;
    const float e1 = (a.fy * xc[1] / zs + a.cy) - f.v;
    const float err = sqrtf(e0 * e0 + e1 * e1);
    const bool in = f.m && front && err < a.outlier_px * f.s;
    inl[n] = in ? 1 : 0;
    st[0] += in ? err * err : 0.0f;
    st[1] += in ? 1.0f : 0.0f;
  }
  block_sum<2>(st, sh);
  if (tid < 12) a.out[y * kRefineOut + tid] = sh.T[tid];
  if (tid == 12)
    a.out[y * kRefineOut + 12] = sqrtf(sh.sum[0] / fmaxf(sh.sum[1], 1.0f));
  if (tid == 13) a.n_inl[y] = (int)sh.sum[1];
}

}  // namespace

// Threads of each refine_pose block for N features: one a feature, a whole
// number of warps, 32 to 1,024.
extern "C" int svo_refine_threads(int N) {
  long warps = ((long)N + 31) / 32;
  if (warps < 1) warps = 1;
  if (warps > kRefineMaxWarps) warps = kRefineMaxWarps;
  return (int)(warps * 32);
}

// The pose refinement of B problems, one block each (refine_pose_kernel).
// Problem b's arrays at b times the strides given (0: shared by all
// problems). sig, sig_d, T_prior and disp may be null: sigma 1, sig_d =
// sig, no motion prior, no disparity rows (disp_mask is read only with
// disp). intr: fx, fy, cx, cy, fx * baseline; par: Huber k, outlier
// threshold (px), stereo weight, prior weights of translation and rotation
// (1 / sigma^2). chunks refresh passes with inner passes after each. out:
// (B, 13) [T row-major, RMS error], n_inl (B,), inliers (B, N) bool.
extern "C" int svo_refine_pose(
    const float* T_init, long s_T, const float* X, long s_X, const float* uv,
    long s_uv, const unsigned char* mask, long s_mask, const float* sig,
    long s_sig, const float* sig_d, long s_sig_d, const float* T_prior,
    long s_prior, const float* disp, long s_disp,
    const unsigned char* disp_mask, long s_disp_mask, int N,
    const float* intr, const float* par, int chunks, int inner, float* out,
    int* n_inl, unsigned char* inliers, int B, void* stream) {
  if (N < 0 || B < 0 || B > kRefineProblems || chunks < 0 || inner < 0 ||
      (disp && !disp_mask))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const size_t shared = (size_t)N * sizeof(float4);
  if (shared + sizeof(RefineShared) > kRefineMaxShared)
    return (int)cudaErrorInvalidValue;
  RefineArgs a{};
  a.T_init = T_init;
  a.X = X;
  a.uv = uv;
  a.mask = mask;
  a.sig = sig;
  a.sig_d = sig_d;
  a.T_prior = T_prior;
  a.disp = disp;
  a.disp_mask = disp_mask;
  a.s_T = s_T;
  a.s_X = s_X;
  a.s_uv = s_uv;
  a.s_mask = s_mask;
  a.s_sig = s_sig;
  a.s_sig_d = s_sig_d;
  a.s_prior = s_prior;
  a.s_disp = s_disp;
  a.s_disp_mask = s_disp_mask;
  a.N = N;
  a.chunks = chunks;
  a.inner = inner;
  a.fx = intr[0];
  a.fy = intr[1];
  a.cx = intr[2];
  a.cy = intr[3];
  a.fxB = intr[4];
  a.huber_k = par[0];
  a.outlier_px = par[1];
  a.stereo_w = par[2];
  a.lam_t = par[3];
  a.lam_r = par[4];
  a.out = out;
  a.n_inl = n_inl;
  a.inliers = inliers;
  const int threads = svo_refine_threads(N);
  cudaStream_t s = (cudaStream_t)stream;
#define SVO_REFINE(kT)                                                       \
  do {                                                                       \
    if (shared + sizeof(RefineShared) > 48 * 1024) {                         \
      const cudaError_t err = cudaFuncSetAttribute(                          \
          refine_pose_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          (int)shared);                                                      \
      if (err != cudaSuccess) return (int)err;                               \
    }                                                                        \
    refine_pose_kernel<kT><<<(unsigned)B, threads, shared, s>>>(a);          \
  } while (0)
  if (threads <= 256)
    SVO_REFINE(256);
  else
    SVO_REFINE(kRefineMaxThreads);
#undef SVO_REFINE
  return (int)cudaGetLastError();
}
