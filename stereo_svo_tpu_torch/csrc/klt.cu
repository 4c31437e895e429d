// klt_track_kernel: the whole of ops/klt.track (pyramidal inverse-
// compositional Lucas-Kanade feature tracking) in one launch, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel on its own: it fuses the jnp chain of
// stereo_svo_tpu/ops/klt.py:track with its uses of B3
// (stereo_svo_tpu/ops/pallas/align_kernel.py:110, one sample of the N
// patches an iteration) and, with klt_affine_warp, warp_template_level. Why:
// as a chain of PyTorch ops and B3 launches the KLT of one EuRoC frame was
// ~950 kernel nodes of ~1.2 us each (1.50 ms of a 3.28-ms frame graph on an
// H100); here it is one node.
//
// What bounds it: the latency of klt_levels x klt_max_iters dependent
// iterations (3 x 6 = 18 at every shipped configuration), each a gather of
// every feature's P x P patch from the level image (in L2) and three sums
// over it. Not bytes: the templates once (N = 192, P = 8, 3 levels: ~0.5 MB)
// and four taps a pixel an iteration (~0.2 MB) take ~0.2 us at 3.35 TB/s.
// Not flops: ~0.1 MFLOP an iteration.
//
// Design. A group of G threads a feature, B3's group_size (16 threads at
// P = 4, a warp at P = 8, four warps at P = 16), the groups packed into
// blocks as B3 packs its centres (64 threads, 128 at G = 128), one grid row
// a problem. No cluster and no barrier between groups: every feature is
// independent of every other, so a group runs its feature's whole level
// loop by itself. Thread `lane` of a group takes patch pixels lane,
// lane + G, ... and keeps their template value and gradient in registers
// for a level; every thread of the group keeps the feature's uv, its
// converged flag and its residual in registers across levels and
// iterations.
//
// Sums over the feature's P^2 pixels: each thread adds its pixels in order,
// then a butterfly of shuffles within the group (__shfl_xor_sync on the
// group's lanes), and at G = 128, where the group is the block, the warps'
// sums in warp order through shared memory. Each butterfly step adds the
// same two partial sums on both lanes, so every lane of the group holds the
// same bits and takes the same branches, and a call repeats bit for bit. No
// float atomics. Sums over the template alone (its mean and variance) are
// formed once a level; an iteration takes three rounds: the current patch's
// sum, its covariance with the template, and g = J^T e with sum |e|.
//
// Each level, coarse to fine: the level's template, its gradients and its
// inverse 2x2 Hessian; with A_inv and oversized patches (klt_affine_warp),
// first warp_template_level's warp of the feature's B x B patch through
// A_inv (the bilinear value and gradient inside the patch, J = G A_inv, the
// 2x2 Hessian + 1e-3 I and solve.inv2x2), taken where every sample lies
// inside the patch and the big patch inside the level (big_ok), and counted
// in n_warped. Then convergence resets, and each iteration follows the
// chain: the bounds test at the level (margin P), the sample at uv 2^-lv
// with B3's taps_of and blend (bilinear.cuh: interp.bilinear's taps, so the
// samples are B3's bit for bit), the affine illumination fit (a clamped to
// [0.6, 1.6]; edgelets a = 1 and e = cur - t), delta = Hinv g / a, the
// edgelets' projection on edge_dir, uv <- uv - delta 2^lv, the convergence
// test against klt_conv_eps^2 and res = mean |e|. A feature that is inactive
// at a level (masked, out of bounds or converged) cannot turn active again
// within the level, since its uv no longer changes: its group leaves the
// level's loop, and the outputs are those the chain gives. Last, the
// moved2 plausibility test.
//
// n_warped: each feature adds its count of warped levels to its problem's
// tally with an integer atomic, then takes a ticket; the feature that draws
// the last ticket writes the total and zeroes the tally for the next call
// on the stream. Integers: the same total in any order.
//
// Float32 throughout (-fmad=false, no fast math): the chain's arithmetic up
// to the order of its sums (and the FMAs its 2x2 products may take in
// cuBLAS).
//
// Plain C interface (loaded with ctypes); launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "bilinear.cuh"   // group_size, taps_of, taps_at, blend, clampf_nan

namespace {

constexpr int kMaxKltLevels = 8;
constexpr int kKltMaxPix = 8;          // patch pixels a thread at most
constexpr int kKltProblems = 65535;    // the grid's y dimension
constexpr int kKltMaxSums = 4;         // values one group sum adds at most

struct KltLevel {
  const float* img;   // problem 0's level image (H, W)
  long img_stride;    // elements between two problems' images
  int H, W;
};

struct KltArgs {
  KltLevel lv[kMaxKltLevels];
  int L, N, iters, big_side;
  const float* patches;             // (L, N, P*P)
  const float* jac;                 // (L, N, P*P, 2)
  const float* hinv;                // (L, N, 2, 2)
  const unsigned char* mask;        // (N,) bool
  const float* big;                 // (L, N, B*B), read with A_inv
  const unsigned char* big_ok;      // (L, N) bool, read with A_inv
  const float* uv_init;             // (N, 2)
  const float* edge_dir;            // (N, 2) or null
  const unsigned char* is_edgelet;  // (N,) bool or null
  const float* A_inv;               // (N, 2, 2) or null: no warp
  long s_patches, s_jac, s_hinv, s_mask, s_big, s_big_ok, s_uv, s_edge_dir,
      s_edgelet, s_A_inv;           // problem strides (elements)
  float eps2;                       // klt_conv_eps^2
  float moved2_max;                 // (4 P)^2
  int illum_affine;
  float* uv_out;                    // (B, N, 2)
  unsigned char* ok_out;            // (B, N) bool
  float* res_out;                   // (B, N)
  int* n_warped;                    // (B,)
  unsigned int* tally;              // (B, 2): warped count, tickets
};

// Sum each of C values over the group of G threads (the lanes of `lanes`):
// a butterfly of shuffles within each warp's share of the group, then, for a
// group of several warps (the whole block), their sums in warp order through
// `red`. Every thread of the group gets the same C totals in v.
template <int C>
__device__ __forceinline__ void group_sum(float (&v)[C], int G,
                                          unsigned lanes, float* red) {
  const int width = G < 32 ? G : 32;
#pragma unroll
  for (int c = 0; c < C; ++c)
    for (int off = width >> 1; off > 0; off >>= 1)
      v[c] += __shfl_xor_sync(lanes, v[c], off);
  if (G > 32) {
    const int warp = threadIdx.x >> 5, nw = G >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) red[warp * C + c] = v[c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float s = red[c];
      for (int w = 1; w < nw; ++w) s += red[w * C + c];
      v[c] = s;
    }
    __syncthreads();   // red is written again by the next sum
  }
}

// warp_template_level for one feature at one level: the B x B patch `big`
// resampled at A_inv times each patch offset, the samples' gradients through
// A_inv (J = G A_inv), and the inverse of J^T J + 1e-3 I (solve.inv2x2)
// into t, j0, j1 and h. Returns whether every sample landed inside the
// patch.
template <int kPix>
__device__ __forceinline__ bool warp_template(
    const float* __restrict__ big, int Bs, const float (&A)[4], int P,
    int G, int lane, unsigned lanes, float* red, float (&t)[kPix],
    float (&j0)[kPix], float (&j1)[kPix], float (&h)[4]) {
  const int P2 = P * P;
  const float half = (float)(P - 1) * 0.5f;   // interp.patch_coords
  const float hb = (float)(Bs - 1) * 0.5f;    // (B - 1) / 2
  const float bmax = (float)((double)Bs - 1.000001);
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // outside, H00, H01, H11
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = lane + k * G;
    if (p >= P2) break;
    const int py = p / P, px = p - py * P;
    const float ou = (float)px - half, ov = (float)py - half;
    const float r0 = A[0] * ou + A[1] * ov, r1 = A[2] * ou + A[3] * ov;
    if (!(fabsf(r0) <= hb && fabsf(r1) <= hb)) s[0] += 1.0f;
    const Taps tp = taps_at(r0 + hb, r1 + hb, Bs, Bs, bmax, bmax);
    const float p00 = __ldg(big + tp.iv0 * Bs + tp.iu0);
    const float p01 = __ldg(big + tp.iv0 * Bs + tp.iu1);
    const float p10 = __ldg(big + tp.iv1 * Bs + tp.iu0);
    const float p11 = __ldg(big + tp.iv1 * Bs + tp.iu1);
    const float du = tp.du, dv = tp.dv;
    const float cu = 1.0f - du, cv = 1.0f - dv;
    t[k] = ((p00 * cu * cv + p01 * du * cv) + p10 * cu * dv) + p11 * du * dv;
    const float gu = (p01 - p00) * cv + (p11 - p10) * dv;
    const float gv = (p10 - p00) * cu + (p11 - p01) * du;
    j0[k] = gu * A[0] + gv * A[2];
    j1[k] = gu * A[1] + gv * A[3];
    s[1] += j0[k] * j0[k];
    s[2] += j0[k] * j1[k];
    s[3] += j1[k] * j1[k];
  }
  group_sum<4>(s, G, lanes, red);
  const float a = s[1] + 1e-3f, b = s[2], c = s[2], d = s[3] + 1e-3f;
  float det = a * d - b * c;
  if (!(fabsf(det) > 1e-12f)) {   // torch.where(|det| > eps, det, ...)
    const float sg = (det > 0.0f ? 1.0f : 0.0f) - (det < 0.0f ? 1.0f : 0.0f);
    det = sg * 1e-12f + 1e-12f;
  }
  h[0] = d / det;
  h[1] = -b / det;
  h[2] = -c / det;
  h[3] = a / det;
  return s[0] == 0.0f;
}

template <int kP>
__global__ void __launch_bounds__(128)
    klt_track_kernel(KltArgs a, int P_arg) {
  __shared__ float red[4 * kKltMaxSums];   // group_sum's warp sums, G = 128
  const int P = kP > 0 ? kP : P_arg;
  const int G = group_size(P), P2 = P * P;
  constexpr int kPix =
      kP > 0 ? (kP * kP + group_size(kP) - 1) / group_size(kP) : kKltMaxPix;
  const int slot = threadIdx.x / G, lane = threadIdx.x - slot * G;
  const int n = blockIdx.x * (blockDim.x / G) + slot;
  const size_t y = blockIdx.y;
  const int N = a.N;
  if (N == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) a.n_warped[y] = 0;
    return;
  }
  if (n >= N) return;   // whole groups only (G = 128: the whole block)
  const unsigned lanes =
      G < 32 ? ((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1))
             : 0xffffffffu;
  const float inv_p2 = 1.0f / (float)P2;   // torch.mean's factor

  const bool on = a.mask[y * a.s_mask + n] != 0;
  const float u0 = a.uv_init[y * a.s_uv + 2 * n];
  const float v0 = a.uv_init[y * a.s_uv + 2 * n + 1];
  const bool edge =
      a.is_edgelet != nullptr && a.is_edgelet[y * a.s_edgelet + n] != 0;
  const bool fit = a.illum_affine && !edge;   // else a = 1, e = cur - t
  const bool project = edge && a.edge_dir != nullptr;
  float ed0 = 0.0f, ed1 = 0.0f;
  if (project) {
    ed0 = a.edge_dir[y * a.s_edge_dir + 2 * n];
    ed1 = a.edge_dir[y * a.s_edge_dir + 2 * n + 1];
  }
  float A[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (a.A_inv != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) A[i] = a.A_inv[y * a.s_A_inv + 4 * n + i];
  }
  float u = u0, v = v0, res = 0.0f;
  bool converged = false;
  int warped = 0;

  // a masked feature is never active: uv_init, not ok, res 0
  for (int lv = a.L - 1; lv >= 0 && on; --lv) {
    const KltLevel L = a.lv[lv];
    const float* __restrict__ img = L.img + y * L.img_stride;
    const size_t row = (size_t)lv * N + n;   // the feature's (L, N) entry
    const float* tp = a.patches + y * a.s_patches + row * P2;
    const float* jp = a.jac + y * a.s_jac + row * P2 * 2;
    const float* hp = a.hinv + y * a.s_hinv + row * 4;
    float t[kPix], j0[kPix], j1[kPix], h[4];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = lane + k * G;
      t[k] = j0[k] = j1[k] = 0.0f;
      if (p < P2) {
        t[k] = __ldg(tp + p);
        j0[k] = __ldg(jp + 2 * p);
        j1[k] = __ldg(jp + 2 * p + 1);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __ldg(hp + i);
    if (a.A_inv != nullptr) {
      float tw[kPix], jw0[kPix], jw1[kPix], hw[4];
      const int B2 = a.big_side * a.big_side;
      const bool contained = warp_template<kPix>(
          a.big + y * a.s_big + row * B2, a.big_side, A, P, G, lane, lanes,
          red, tw, jw0, jw1, hw);
      if (contained && a.big_ok[y * a.s_big_ok + row] != 0) {
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (lane + k * G < P2) {
            t[k] = tw[k];
            j0[k] = jw0[k];
            j1[k] = jw1[k];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = hw[i];
        ++warped;
      }
    }
    float mt = 0.0f, var = 0.0f;
    if (fit) {   // the template's mean and variance, once a level
      float s[1] = {0.0f};
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        if (lane + k * G < P2) s[0] += t[k];
      group_sum<1>(s, G, lanes, red);
      mt = s[0] * inv_p2;
      float q[1] = {0.0f};
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        if (lane + k * G < P2) q[0] += (t[k] - mt) * (t[k] - mt);
      group_sum<1>(q, G, lanes, red);
      var = q[0] * inv_p2;
      var = var < 1e-3f ? 1e-3f : var;   // torch.clamp(var, min=1e-3)
    }
    const float scale = 1.0f / (float)(1 << lv), up = (float)(1 << lv);
    const float Pf = (float)P, ub = (float)(L.W - P), vb = (float)(L.H - P);
    const float umax = (float)((double)L.W - 1.000001);
    const float vmax = (float)((double)L.H - 1.000001);
    converged = false;   // convergence resets at each level
    for (int it = 0; it < a.iters; ++it) {
      const float us = u * scale, vs = v * scale;
      // in_b; a feature out of bounds stays so for the level
      if (!(us > Pf && us < ub && vs > Pf && vs < vb)) break;
      float cur[kPix];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int p = lane + k * G;
        cur[k] = 0.0f;
        if (p < P2) {
          const Taps q = taps_of(us, vs, p, P, L.H, L.W, umax, vmax);
          const float* r0 = img + (size_t)q.iv0 * L.W;
          const float* r1 = img + (size_t)q.iv1 * L.W;
          cur[k] = blend(__ldg(r0 + q.iu0), __ldg(r0 + q.iu1),
                         __ldg(r1 + q.iu0), __ldg(r1 + q.iu1), q.du, q.dv);
        }
      }
      float al = 1.0f, e[kPix];
      if (fit) {   // cur ~ a t + b, a clamped to [0.6, 1.6]
        float s[1] = {0.0f};
#pragma unroll
        for (int k = 0; k < kPix; ++k)
          if (lane + k * G < P2) s[0] += cur[k];
        group_sum<1>(s, G, lanes, red);
        const float mc = s[0] * inv_p2;
        float c[1] = {0.0f};
#pragma unroll
        for (int k = 0; k < kPix; ++k)
          if (lane + k * G < P2) c[0] += (cur[k] - mc) * (t[k] - mt);
        group_sum<1>(c, G, lanes, red);
        al = clampf_nan((c[0] * inv_p2) / var, 0.6f, 1.6f);
#pragma unroll
        for (int k = 0; k < kPix; ++k)
          e[k] = (cur[k] - mc) - al * (t[k] - mt);
      } else {
#pragma unroll
        for (int k = 0; k < kPix; ++k) e[k] = cur[k] - t[k];
      }
      float g[3] = {0.0f, 0.0f, 0.0f};   // J^T e, sum |e|
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (lane + k * G < P2) {
          g[0] += j0[k] * e[k];
          g[1] += j1[k] * e[k];
          g[2] += fabsf(e[k]);
        }
      }
      group_sum<3>(g, G, lanes, red);
      float d0 = (h[0] * g[0] + h[1] * g[1]) / al;
      float d1 = (h[2] * g[0] + h[3] * g[1]) / al;
      if (project) {   // edgelets: 1-DoF along their gradient normal
        const float along = d0 * ed0 + d1 * ed1;
        d0 = along * ed0;
        d1 = along * ed1;
      }
      u = u - d0 * up;
      v = v - d1 * up;
      res = g[2] * inv_p2;
      if (d0 * d0 + d1 * d1 < a.eps2) {
        converged = true;   // inactive for the rest of the level
        break;
      }
    }
  }

  if (lane == 0) {
    const float du = u - u0, dv = v - v0;
    const bool ok = on && converged && du * du + dv * dv < a.moved2_max;
    a.uv_out[(y * N + n) * 2] = u;
    a.uv_out[(y * N + n) * 2 + 1] = v;
    a.ok_out[y * N + n] = ok ? 1 : 0;
    a.res_out[y * N + n] = res;
    if (a.A_inv == nullptr) {
      if (n == 0) a.n_warped[y] = 0;
    } else {
      unsigned int* tally = a.tally + 2 * y;
      if (warped) atomicAdd(tally, (unsigned int)warped);
      __threadfence();   // the count lands before the ticket is taken
      if (atomicAdd(tally + 1, 1u) == (unsigned int)(N - 1)) {
        __threadfence();
        a.n_warped[y] = (int)atomicExch(tally, 0u);
        atomicExch(tally + 1, 0u);   // ready for the next call
      }
    }
  }
}

template <int kP>
void launch_klt(const KltArgs& a, int P, int B, cudaStream_t stream) {
  const int G = group_size(P);
  const int threads = G <= 32 ? 64 : 128;
  const int per_block = threads / G;
  long blocks = ((long)a.N + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  klt_track_kernel<kP>
      <<<dim3((unsigned)blocks, (unsigned)B), threads, 0, stream>>>(a, P);
}

}  // namespace

// The KLT of B problems (klt_track_kernel). Per level lv (L <= 8, level 0
// the finest): problem 0's image at level_ptr[lv], problems
// level_stride[lv] elements apart, level_hw[2 lv], level_hw[2 lv + 1] its
// H, W. The template (patches, jac, hinv, mask; big and big_ok, read only
// with A_inv, big_side their B), uv_init, edge_dir and is_edgelet (null:
// none) and A_inv (null: no warp): problem b's arrays at b times the strides
// given (0: shared by all problems). iters: klt_max_iters; eps2:
// klt_conv_eps^2; moved2_max: (4 P)^2. Outputs: uv_out (B, N, 2), ok_out
// (B, N) bool, res_out (B, N), n_warped (B,); tally (B, 2) unsigned ints,
// zero before the first call (the kernel leaves them zero), with A_inv.
extern "C" int svo_klt_track(
    const long long* level_ptr, const long* level_stride,
    const int* level_hw, int L, const float* patches, long s_patches,
    const float* jac, long s_jac, const float* hinv, long s_hinv,
    const unsigned char* mask, long s_mask, const float* big, long s_big,
    const unsigned char* big_ok, long s_big_ok, int big_side,
    const float* uv_init, long s_uv, const float* edge_dir, long s_edge_dir,
    const unsigned char* is_edgelet, long s_edgelet, const float* A_inv,
    long s_A_inv, int N, int P, int iters, float eps2, float moved2_max,
    int illum_affine, float* uv_out, unsigned char* ok_out, float* res_out,
    int* n_warped, unsigned int* tally, int B, void* stream) {
  if (L < 0 || L > kMaxKltLevels || N < 0 || P < 1 || iters < 0 || B < 0 ||
      B > kKltProblems ||
      (long)P * P > (long)kKltMaxPix * group_size(P) ||
      (A_inv && (!big || !big_ok || !tally || big_side < 2)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  KltArgs a{};
  for (int i = 0; i < L; ++i) {
    KltLevel& lv = a.lv[i];
    lv.img = reinterpret_cast<const float*>(level_ptr[i]);
    lv.img_stride = level_stride[i];
    lv.H = level_hw[2 * i];
    lv.W = level_hw[2 * i + 1];
    if (lv.H < 1 || lv.W < 1) return (int)cudaErrorInvalidValue;
  }
  a.L = L;
  a.N = N;
  a.iters = iters;
  a.big_side = big_side;
  a.patches = patches;
  a.jac = jac;
  a.hinv = hinv;
  a.mask = mask;
  a.big = big;
  a.big_ok = big_ok;
  a.uv_init = uv_init;
  a.edge_dir = edge_dir;
  a.is_edgelet = is_edgelet;
  a.A_inv = A_inv;
  a.s_patches = s_patches;
  a.s_jac = s_jac;
  a.s_hinv = s_hinv;
  a.s_mask = s_mask;
  a.s_big = s_big;
  a.s_big_ok = s_big_ok;
  a.s_uv = s_uv;
  a.s_edge_dir = s_edge_dir;
  a.s_edgelet = s_edgelet;
  a.s_A_inv = s_A_inv;
  a.eps2 = eps2;
  a.moved2_max = moved2_max;
  a.illum_affine = illum_affine;
  a.uv_out = uv_out;
  a.ok_out = ok_out;
  a.res_out = res_out;
  a.n_warped = n_warped;
  a.tally = tally;
  cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 4: launch_klt<4>(a, P, B, s); break;
    case 8: launch_klt<8>(a, P, B, s); break;
    case 16: launch_klt<16>(a, P, B, s); break;
    default: launch_klt<0>(a, P, B, s);
  }
  return (int)cudaGetLastError();
}
