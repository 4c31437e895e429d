// Patch sampling (B3), the fused Gauss-Newton accumulation of sparse
// image alignment (B4) and the whole alignment in one launch
// (align_levels_kernel, below B3 and B4) for Hopper (sm_90a).
//
// B3 and B4 replace the Pallas TPU kernels of
// stereo_svo_tpu/ops/pallas/align_kernel.py `sample_patches` (_sample_kernel)
// and `gn_accumulate` (_gn_kernel). On the TPU those kernels read each patch's
// (P+1)^2 window out of VMEM with one-hot micro-matmuls over an 8-aligned
// 16-row block, because Mosaic has no cheap dynamic gather.
//
// What bounds them here. At the main path's sizes (N = 192 centres, P = 4
// or 8) B3 moves ~100 KB and B4 ~120 KB: 0.03-0.04 us at 3.35 TB/s, and B4's
// ~0.25 MFLOP is less still. Both are bound by launch latency and by the
// host's cost per call, not by bytes or operations. The design therefore
// (1) samples up to three same-shape images at the same centres in one
// launch (a pyramid level's image, gx and gy for the templates), (2) makes
// B4 one launch per call, (3) spreads B3's N = 192 over more SMs than one
// thread per output did (96 blocks at P = 8, was 48; 48 at P = 4, was 12),
// and (4) reads each centre's footprint from device memory once instead
// of four taps per output:
//
// * A group of G threads works on one centre (G = 16 at P = 4, a warp at
//   P = 8, four warps at P = 16). The group loads the centre once and
//   stages the (P+2) x (P+2) window at floor(centre - (P-1)/2) of each
//   image in shared memory, row by row (coalesced along rows); each output
//   then reads its four taps from shared memory. The patch size is a
//   template parameter for the main path's P = 4, 8 and 16 (any other P
//   runs the generic instance), so the staging loop unrolls and its loads
//   overlap instead of waiting on each other.
// * Bit-exactness with the plain version. Every output still computes its
//   own u = centre + (px - half), the clamp, floor, du and dv exactly as
//   ops/interp.bilinear does, so rounding of u near a power of two cannot
//   move a tap. A tap is read from the window only where it lies inside
//   it; otherwise (centres within ~P/2+1 px of the border or beyond it,
//   whose taps the per-tap clamp moves, or a rare rounding step outside
//   the window) the output takes the per-tap global path. Both paths read
//   the same pixel, so the result is bit for bit that of the plain version.
//
// Border rule: each tap is clamped like ops/interp.bilinear of the
// reference (u in [0, W-1.000001], iu1 = min(iu0+1, W-1)), not the Pallas
// rule that clamps the patch centre. The two agree at interior centres.
//
// B4, one launch: each block reduces its share of the terms to 30 partial
// sums, writes them to scratch, and takes a ticket; the block that draws
// the last ticket adds the partials in block order 0..nblocks-1 (a fixed
// order, no float atomics: a call repeats bit for bit), writes the 45
// outputs and resets the ticket counter to 0 for the next call. The
// scratch and the counter belong to the caller's stream, which orders
// successive calls. B4 keeps 256-thread blocks (12 at N = 192): at P = 4
// that is the two-launch design's assignment of terms to threads and its
// reduction tree, so its sums, and every trajectory, repeat bit for bit.
// 128-thread blocks (24 at N = 192) were measured: no faster, and their
// other summation order moved the KITTI path's ATE by 17 % (PERF.md).
// The last block copies all partials to shared memory in one pass before
// adding them, so its loads overlap instead of waiting one block at a time.
//
// The problem axis (the counterpart of the reference's jax.vmap over B
// sequences or loop edges): both kernels take B independent problems in one
// launch, grid dimension y, each array of problem b at a fixed element
// stride from problem 0's (0 for an array that all problems share). Each
// problem keeps the block partition, the assignment of terms to threads and
// the reduction order of its one-problem launch; B4 gives each problem its
// own slice of the partials and its own ticket counter. So problem b of a
// launch equals a launch of problem b alone bit for bit, and a launch with
// B = 1 is the one-problem launch.
//
// Plain C interface (loaded with ctypes); every entry point launches on the
// caller's stream and returns cudaGetLastError(). Built with -fmad=false so
// each multiply and add rounds as in the plain PyTorch version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bilinear.cuh"    // group_size, taps_of, blend
#include "se3_solve.cuh"   // se3_exp, se3_compose_into, solve6_lanes

namespace {

constexpr int kAcc = 30;          // 21 unique H entries, 6 g, cost, n_eff, n_inl
constexpr int kGnThreads = 256;   // B4 block: at P = 4 the terms-to-threads
                                  // map and the reduction tree of the
                                  // two-launch design, so the sums repeat
                                  // its bits
constexpr int kMaxBlocks = 128;   // B4 grid cap: the final pass adds <= 128 partials
constexpr int kMaxImages = 3;     // B3: image, gx, gy of one level
constexpr int kMaxProblems = 65535;   // the grid's y dimension
constexpr int kOut = 45;          // B4's outputs per problem

__host__ inline int sample_block_threads(int P) {
  return group_size(P) <= 32 ? 64 : 128;
}

// Top-left corner of a centre's staged window along one axis, kept in
// range so that corner + S never overflows (a NaN centre gives 0).
__device__ __forceinline__ int window_origin(float c, int P, int n, int S) {
  return clampi((int)floorf(c + (0.0f - (float)(P - 1) * 0.5f)), -S, n);
}

// One centre's view of its staged windows (K images, S x S each).
struct Window {
  const float* w;   // shared memory, K * S * S
  int ox, oy, S;
};

// Stage the S x S window at (ox, oy) of each of K images; pixels outside
// the image are clamped copies (never read for an in-window tap). With
// the patch size known at compile time (kP > 0) the loop unrolls and every
// load is issued before the first store, so the loads overlap.
template <int kP>
__device__ __forceinline__ void stage(float* w, const float* __restrict__ img,
                                      int K, int H, int W, int ox, int oy,
                                      int P, int lane) {
  const size_t HW = (size_t)H * W;
  if constexpr (kP > 0) {
    constexpr int S = kP + 2, S2 = S * S, G = group_size(kP);
    constexpr int kIter = (S2 + G - 1) / G;
    float v[kMaxImages][kIter];
#pragma unroll
    for (int k = 0; k < kMaxImages; ++k) {
#pragma unroll
      for (int it = 0; it < kIter; ++it) {
        const int i = lane + it * G, r = i / S, c = i - r * S;
        if (k < K && i < S2)
          v[k][it] = __ldg(img + k * HW +
                           (size_t)clampi(oy + r, 0, H - 1) * W +
                           clampi(ox + c, 0, W - 1));
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxImages; ++k) {
#pragma unroll
      for (int it = 0; it < kIter; ++it) {
        const int i = lane + it * G;
        if (k < K && i < S2) w[k * S2 + i] = v[k][it];
      }
    }
  } else {
    const int S = P + 2, S2 = S * S, G = group_size(P);
    for (int i = lane; i < K * S2; i += G) {
      const int k = i / S2, j = i - k * S2;
      const int r = j / S, c = j - r * S;
      w[i] = __ldg(img + k * HW + (size_t)clampi(oy + r, 0, H - 1) * W +
                   clampi(ox + c, 0, W - 1));
    }
  }
}

// Sample image k at the output whose taps are t: from the window where all
// four taps lie inside it, else from device memory (the same pixels).
__device__ __forceinline__ float sample(const Window& win,
                                        const float* __restrict__ img,
                                        int k, int H, int W, const Taps& t) {
  const int S = win.S;
  const bool inside = t.iu0 >= win.ox && t.iu1 < win.ox + S &&
                      t.iv0 >= win.oy && t.iv1 < win.oy + S;
  float p00, p01, p10, p11;
  if (inside) {
    const float* w = win.w + k * S * S;
    const int r0 = (t.iv0 - win.oy) * S, r1 = (t.iv1 - win.oy) * S;
    const int c0 = t.iu0 - win.ox, c1 = t.iu1 - win.ox;
    p00 = w[r0 + c0];
    p01 = w[r0 + c1];
    p10 = w[r1 + c0];
    p11 = w[r1 + c1];
  } else {
    const float* im = img + (size_t)k * H * W;
    p00 = __ldg(im + (size_t)t.iv0 * W + t.iu0);
    p01 = __ldg(im + (size_t)t.iv0 * W + t.iu1);
    p10 = __ldg(im + (size_t)t.iv1 * W + t.iu0);
    p11 = __ldg(im + (size_t)t.iv1 * W + t.iu1);
  }
  return blend(p00, p01, p10, p11, t.du, t.dv);
}

// B3: K images (planes of one (K, H, W) buffer) sampled at M centres;
// out is (K, M, P*P). One group of G threads per centre. kP > 0: the
// patch size at compile time (the main path's 4, 8 and 16); 0: any P.
// Problem blockIdx.y: its images at img + y * img_stride, its centres at
// uv + y * uv_stride, its output the y-th (K, M, P*P) block of out.
template <int kP>
__global__ void sample_patch_kernel(const float* __restrict__ img,
                                    long img_stride, int K, int H, int W,
                                    const float* __restrict__ uv,
                                    long uv_stride, long M, int P_arg,
                                    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int P = kP > 0 ? kP : P_arg;
  const int G = group_size(P), S = P + 2, P2 = P * P;
  const int slot = threadIdx.x / G, lane = threadIdx.x - slot * G;
  const long m = (long)blockIdx.x * (blockDim.x / G) + slot;
  if (m >= M) return;   // whole groups only: no barrier below spans groups
  img += (size_t)blockIdx.y * img_stride;                 // this problem's
  uv += (size_t)blockIdx.y * uv_stride;
  out += (size_t)blockIdx.y * K * M * P2;
  const float cu = uv[2 * m], cv = uv[2 * m + 1];
  float* w = smem + (size_t)slot * K * S * S;
  const Window win{w, window_origin(cu, P, W, S), window_origin(cv, P, H, S),
                   S};
  stage<kP>(w, img, K, H, W, win.ox, win.oy, P, lane);
  // a group is a half warp, a warp or (G = 128) the whole block
  if (G < 32)
    __syncwarp(((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1)));
  else if (G == 32)
    __syncwarp();
  else
    __syncthreads();
  const float umax = (float)((double)W - 1.000001);
  const float vmax = (float)((double)H - 1.000001);
#pragma unroll
  for (int it = 0; it < (P2 + G - 1) / G; ++it) {
    const int p = lane + it * G;
    if (p >= P2) break;
    const Taps t = taps_of(cu, cv, p, P, H, W, umax, vmax);
#pragma unroll
    for (int k = 0; k < kMaxImages; ++k)
      if (k < K) out[((size_t)k * M + m) * P2 + p] = sample(win, img, k, H, W, t);
  }
}

// Element strides between two problems' arrays in B4.
struct GnStrides {
  long img, uv, tmpl, jac, mask, a, b;
};

// B4: sample + illumination-corrected residual + Huber weight + 6x6 normal
// equations over the N*P^2 (feature, pixel) terms, in one launch. Problem
// blockIdx.y: its arrays at the strides st, its partials the y-th slice of
// kMaxBlocks * kAcc, its ticket counter counter[y], its outputs the y-th
// kOut of out.
template <int kP>
__global__ void __launch_bounds__(kGnThreads)
gn_accumulate_kernel(const float* __restrict__ img, int H, int W,
                     const float* __restrict__ uv,
                     const float* __restrict__ tmpl,
                     const float* __restrict__ jac,
                     const float* __restrict__ mask, int N, int P_arg,
                     const float* __restrict__ a_ptr,
                     const float* __restrict__ b_ptr, GnStrides st,
                     float huber_k, float* __restrict__ partials,
                     unsigned int* __restrict__ counter,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float warp_sums[kGnThreads / 32][kAcc];
  __shared__ float total[kAcc];
  __shared__ float part_s[kMaxBlocks * kAcc];   // the last block's copy
  __shared__ bool is_last;
  {                                                       // this problem's
    const size_t y = blockIdx.y;
    img += y * st.img;
    uv += y * st.uv;
    tmpl += y * st.tmpl;
    jac += y * st.jac;
    mask += y * st.mask;
    a_ptr += y * st.a;
    b_ptr += y * st.b;
    partials += y * kMaxBlocks * kAcc;
    counter += y;
    out += y * kOut;
  }
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.0f;
  const float a_il = *a_ptr, b_il = *b_ptr;
  const int P = kP > 0 ? kP : P_arg;
  const int G = group_size(P), S = P + 2, P2 = P * P;
  const int per_block = kGnThreads / G;
  const int slot = threadIdx.x / G, lane = threadIdx.x - slot * G;
  const float umax = (float)((double)W - 1.000001);
  const float vmax = (float)((double)H - 1.000001);
  float* w = smem + (size_t)slot * S * S;
  // a fixed assignment of terms to threads for a given (N, P); at P = 4
  // thread t of block b takes terms b*256 + t + i*(gridDim.x*256)
  for (long base = (long)blockIdx.x * per_block; base < N;
       base += (long)gridDim.x * per_block) {
    const long m = base + slot;
    float cu = 0.0f, cv = 0.0f;
    Window win{w, 0, 0, S};
    if (m < N) {
      cu = uv[2 * m];
      cv = uv[2 * m + 1];
      win.ox = window_origin(cu, P, W, S);
      win.oy = window_origin(cv, P, H, S);
      stage<kP>(w, img, 1, H, W, win.ox, win.oy, P, lane);
    }
    __syncthreads();
    if (m < N) {
#pragma unroll
      for (int it = 0; it < (P2 + G - 1) / G; ++it) {
        const int p = lane + it * G;
        if (p >= P2) break;
        const long idx = m * P2 + p;
        const float cur =
            sample(win, img, 0, H, W, taps_of(cu, cv, p, P, H, W, umax, vmax));
        const float msk = mask[idx];
        const float e = cur - (a_il * tmpl[idx] + b_il);
        const float ae = fabsf(e);
        const float wt =
            (ae <= huber_k ? 1.0f : huber_k / fmaxf(ae, 1e-6f)) * msk;
        const float2* j2 = reinterpret_cast<const float2*>(jac + idx * 6);
        const float2 j01 = __ldg(j2), j23 = __ldg(j2 + 1), j45 = __ldg(j2 + 2);
        const float J[6] = {j01.x, j01.y, j23.x, j23.y, j45.x, j45.y};
        float Jw[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) Jw[i] = J[i] * wt;
        int c = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j) acc[c++] += Jw[i] * J[j];
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * e;
        acc[27] += wt * e * e;
        acc[28] += msk;
        acc[29] += ae < huber_k ? msk : 0.0f;
      }
    }
    __syncthreads();   // the next round restages the windows
  }

  // block partials: a fixed shuffle tree, then warps in order
  const int lane32 = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kAcc; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane32 == 0) warp_sums[warp][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float s = 0.0f;
    for (int i = 0; i < kGnThreads / 32; ++i) s += warp_sums[i][threadIdx.x];
    partials[(size_t)blockIdx.x * kAcc + threadIdx.x] = s;
    __threadfence();   // the partial is visible before the ticket is taken
  }
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  // the last block: every thread copies partials to shared memory (the
  // loads overlap: one trip to L2, not one per block), then they are added
  // in block order
  __threadfence();
  const unsigned n_part = gridDim.x * kAcc;
  for (unsigned i = threadIdx.x; i < n_part; i += kGnThreads)
    part_s[i] = __ldcg(partials + i);
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float v = 0.0f;
    for (unsigned b = 0; b < gridDim.x; ++b) v += part_s[b * kAcc + threadIdx.x];
    total[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x < 36) {   // H, symmetric, from its upper triangle
    const int i = threadIdx.x / 6, j = threadIdx.x - i * 6;
    const int r = min(i, j), c = max(i, j);
    out[threadIdx.x] = total[r * 6 - r * (r - 1) / 2 + (c - r)];
  } else if (threadIdx.x < kOut) {
    out[threadIdx.x] = total[threadIdx.x - 15];   // g, cost, n_eff, n_inl
  }
  if (threadIdx.x == 0) *counter = 0u;   // ready for the next call
}

template <int kP>
void launch_sample(const float* img, long img_stride, int K, int H, int W,
                   const float* uv, long uv_stride, long M, int P, float* out,
                   int B, cudaStream_t stream) {
  const int threads = sample_block_threads(P);
  const int per_block = threads / group_size(P);
  const size_t shared =
      (size_t)per_block * K * (P + 2) * (P + 2) * sizeof(float);
  const long blocks = (M + per_block - 1) / per_block;
  sample_patch_kernel<kP>
      <<<dim3((unsigned)blocks, (unsigned)B), threads, shared, stream>>>(
          img, img_stride, K, H, W, uv, uv_stride, M, P, out);
}

template <int kP>
void launch_gn(const float* img, int H, int W, const float* uv,
               const float* tmpl, const float* jac, const float* mask, int N,
               int P, const float* a_il, const float* b_il,
               const GnStrides& st, float huber_k, float* partials,
               unsigned int* counter, float* out, int blocks, int B,
               cudaStream_t stream) {
  const size_t shared =
      (size_t)(kGnThreads / group_size(P)) * (P + 2) * (P + 2) * sizeof(float);
  gn_accumulate_kernel<kP>
      <<<dim3((unsigned)blocks, (unsigned)B), kGnThreads, shared, stream>>>(
          img, H, W, uv, tmpl, jac, mask, N, P, a_il, b_il, st, huber_k,
          partials, counter, out);
}


// ---------------------------------------------------------------------------
// align_levels_kernel: the whole of ops/align.align in one launch.
//
// Replaces no Pallas kernel: it fuses the jnp chain of
// stereo_svo_tpu/ops/align.py:align (every level, refresh pass and inner
// pass of the coarse-to-fine inverse-compositional Gauss-Newton) with B4's
// accumulation. Why: as a chain of PyTorch ops, B3 and B4 the alignment of
// one EuRoC frame was ~3,135 kernel nodes of ~1.3 us each (4.3 ms graphed);
// here it is one node. What bounds it: the latency of 15 dependent passes
// (at the default (2, 3, 4, 8) schedule), each a sweep over N*P^2 terms
// (3,072 at N = 192, P = 4), one to three reductions over the problem and,
// on a refresh pass, one 6x6 factorisation and solve; its bytes (a level's
// template, ~85 KB, and four taps a term, in L2 and L1) take well under a
// microsecond a pass.
//
// Design. A cluster of kAlignCluster thread blocks a problem (the single step:
// 1 problem; a batch of sequences: B; the loop closure: its edges), block r of
// a cluster taking features N*r/8 to N*(r+1)/8 and their terms, blockDim a
// multiple of 32 picked from the block's terms by svo_align_threads (about one
// term a thread, at most 512). On the EuRoC shape, on an H100 (700 W), a
// cluster of 8 took 98 us, of 4 107, of 2 125, one block of 512 threads 126
// (its block-wide reductions), and 152 as a cluster of 1: a cluster barrier
// costs ~0.9 us, and 29 reductions need one each. Thread i takes the terms t =
// i, i + blockDim, ... of its block in every pass, so a thread's terms stay
// its own in dynamic shared memory: each term's sample and whether it counts
// during a refresh pass, then its Huber weight for the inner passes after it.
// A pass begins by projecting the block's features into shared memory
// (transform by T, project with the level's intrinsics, front: z > 1e-3, and
// the template mask); a term offsets its feature's pixel to the patch pixel,
// tests in_bounds with margin 1 and samples the level image with B3's taps_of
// and blend (exactly interp.bilinear's taps).
//
// A refresh pass samples once, fits the illumination pair in two sweeps
// as the chain does (sums of ok, ref*ok, cur*ok; then the covariance and
// variance about those means; a clamped to [0.5, 2]), computes the Huber
// weights and B4's 30 sums (H's upper triangle, g, the cost, n_eff,
// n_inl); then warp 0 of every block, from the same sums, regularises H
// (+ 1e-4 tr(H)/6 I + 1e-8 I), factors it once by
// ops/solve.chol_solve_small's rule (same operations in the same order,
// pivot floor 1e-20; the chain factors the same matrix for each of its 7
// right-hand sides), solves for H^-1 and the step on 7 lanes, and sets
// T <- T o exp(-step / a) (geometry/se3.exp's formula). An inner pass
// samples again, forms e and b = sum J w e, the cost sum w e^2 / n_ok and
// the inlier share, and sets T <- T o exp(-(H^-1 b) / a). The blocks of a
// cluster hold the same pose, bit for bit, throughout.
//
// Reductions: a shuffle tree in each warp, the warps' sums in warp order,
// then the blocks' sums in rank order through distributed shared memory;
// no float atomics and a terms-to-threads map fixed by (N, P), so a call
// repeats bit for bit and problem b of a launch equals its launch alone.
// Float32 throughout (-fmad=false, no fast math): the result is the
// chain's arithmetic up to the order of its sums.

constexpr int kMaxAlignLevels = 8;
constexpr int kAlignOut = 14;            // T (12), cost, inlier share
constexpr int kAlignCluster = 8;          // thread blocks a problem
constexpr int kAlignMaxThreads = 512;
constexpr int kAlignTermsPerThread = 1;   // the block size aims at this
constexpr int kAlignMaxWarps = kAlignMaxThreads / 32;
constexpr size_t kMaxSharedBytes = 227 * 1024;   // a block's, on sm_90

struct AlignLevel {
  const float* img;       // problem 0's level image (H, W)
  long img_stride;        // elements between two problems' images
  int H, W;
  float fx, fy, cx, cy;   // the level's intrinsics (camera.intrinsics)
  float umax, vmax;       // in_bounds with margin 1: u, v <= w - 2, h - 2
  int chunks, inner;      // refresh passes, inner passes after each
};

struct AlignArgs {
  AlignLevel lv[kMaxAlignLevels];
  int L, N;
  const float* p_ref;            // (N, 3)
  const float* patches;          // (L, N, P*P)
  const float* jac;              // (L, N, P*P, 6)
  const unsigned char* mask;     // (N,) bool
  const float* T_init;           // (3, 4)
  long s_p_ref, s_patches, s_jac, s_mask, s_T;   // problem strides
  float huber_k;
  int illum_affine;
  float* out;                    // (B, kAlignOut)
};

// Shared state of one block of a problem's alignment.
struct AlignShared {
  float part[kAlignMaxWarps * 30];   // cluster_sum's warp sums
  float mine[2][32];                 // cluster_sum's block sums
  float sum[30];                     // cluster_sum's totals
  float T[12];
  float Hinv[36];
  float L[36];                       // Cholesky factor, row-major
  float X[42];                       // the 7 solutions
  float n_ok, cost, frac;
};

// Sum each of C per-thread values over the problem's cluster of blocks:
// in each warp a fixed shuffle tree, then thread c of each block adds its
// warps' sums in warp order, and after a cluster barrier adds the blocks'
// sums in rank order from their shared memory (double-buffered: a buffer
// is written again only after the next barrier, when every block has read
// it). Every thread of every block gets the same C totals in sh.sum.
template <int C>
__device__ __forceinline__ void cluster_sum(const float (&v)[C],
                                            AlignShared& sh, int& buf) {
  namespace cg = cooperative_groups;
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
    sh.mine[buf][threadIdx.x] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (threadIdx.x < C) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kAlignCluster; ++r)
      s += *cluster.map_shared_rank(&sh.mine[buf][threadIdx.x], r);
    sh.sum[threadIdx.x] = s;
  }
  __syncthreads();
  buf ^= 1;
}

// The projections of features n0..n1-1 in one pass, from the block's
// pose: each feature's level pixel (u, v) and whether it counts (in front,
// z > 1e-3, and in the template mask), into proj (shared memory, one float4
// a feature). The block synchronises after.
__device__ __forceinline__ void project_features(
    const AlignLevel& lv, const float* __restrict__ p_ref,
    const unsigned char* __restrict__ mask, const float* T_sh, int n0,
    int n1, float4* proj) {
  float T[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) T[i] = T_sh[i];
  for (int n = n0 + threadIdx.x; n < n1; n += blockDim.x) {
    const float x0 = __ldg(p_ref + 3 * n), x1 = __ldg(p_ref + 3 * n + 1),
                x2 = __ldg(p_ref + 3 * n + 2);
    float pc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)   // se3.transform: (R * x).sum(-1) + t
      pc[i] = ((T[i * 4] * x0 + T[i * 4 + 1] * x1) + T[i * 4 + 2] * x2) +
              T[i * 4 + 3];
    const bool front = pc[2] > 1e-3f;   // camera.project
    const float zs = front ? pc[2] : 1.0f;
    const float u = lv.fx * pc[0] / zs + lv.cx;
    const float v = lv.fy * pc[1] / zs + lv.cy;
    proj[n - n0] =
        make_float4(u, v, (front && mask[n] != 0) ? 1.0f : 0.0f, 0.0f);
  }
  __syncthreads();
}

// One term: the current image at patch pixel p of a feature projected to
// pr, and whether the term counts (the feature counts and the pixel is in
// bounds with margin 1).
struct Term {
  float cur;
  bool ok;
};

__device__ __forceinline__ Term sample_term(const AlignLevel& lv,
                                            const float* __restrict__ img,
                                            float4 pr, int p, int P) {
  const float half = (float)(P - 1) * 0.5f;
  const int py = p / P, px = p - py * P;
  const float pu = pr.x + ((float)px - half), pv = pr.y + ((float)py - half);
  const float umax = (float)((double)lv.W - 1.000001);
  const float vmax = (float)((double)lv.H - 1.000001);
  const Taps tp = taps_of(pr.x, pr.y, p, P, lv.H, lv.W, umax, vmax);
  const float* r0 = img + (size_t)tp.iv0 * lv.W;
  const float* r1 = img + (size_t)tp.iv1 * lv.W;
  Term t;
  t.cur = blend(__ldg(r0 + tp.iu0), __ldg(r0 + tp.iu1), __ldg(r1 + tp.iu0),
                __ldg(r1 + tp.iu1), tp.du, tp.dv);
  t.ok = pr.z != 0.0f && pu >= 1.0f && pu <= lv.umax && pv >= 1.0f &&
         pv <= lv.vmax;
  return t;
}


// Dynamic shared memory of a block of N features: their projections
// (float4 a feature), then each term's sample and later its Huber weight
// (a float a term), then whether each term counts (a byte a term).
__host__ __device__ inline size_t align_shared_bytes(int N, int P) {
  return (size_t)N * sizeof(float4) + (size_t)N * P * P * (sizeof(float) + 1);
}

// The regularised 6x6 solve of a refresh pass, on warp 0: H + 1e-4 tr(H)/6
// I + 1e-8 I (H from its upper triangle in sum[0..20], g in sum[21..26])
// solved for H^-1 and the step by solve6_lanes (se3_solve.cuh), then lane 0
// sets T <- T o exp(-step / a).
__device__ void refresh_solve(AlignShared& sh, float a_il) {
  const int lane = threadIdx.x;
  if (lane == 0) {
    const float n_ok = clamp_lo_nan(sh.sum[28], 1.0f);
    sh.n_ok = n_ok;
    sh.cost = sh.sum[27] / n_ok;
    sh.frac = sh.sum[29] / n_ok;
  }
  solve6_lanes(sh.sum, sh.sum + 21,
               [](float a, float tr) {
                 const float reg = 1e-4f * tr / 6.0f;
                 return (a + reg) + 1e-8f;
               },
               sh.L, sh.X);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 36; ++i) sh.Hinv[i] = sh.X[i];
    float xi[6], E[12];
#pragma unroll
    for (int i = 0; i < 6; ++i) xi[i] = -sh.X[36 + i] / a_il;
    se3_exp(xi, E);
    se3_compose_into(sh.T, E);
  }
}

template <int kP>
__global__ void __cluster_dims__(kAlignCluster, 1, 1)
    __launch_bounds__(kAlignMaxThreads)
    align_levels_kernel(AlignArgs args, int P_arg) {
  extern __shared__ float4 s_dyn[];
  __shared__ AlignShared sh;
  const int P = kP > 0 ? kP : P_arg;
  const int P2 = P * P, N = args.N, NP2 = N * P2;
  // this block's features n0..n1-1 of problem y, and their terms
  const int rank = (int)(blockIdx.x % kAlignCluster);
  const size_t y = blockIdx.x / kAlignCluster;
  const int n0 = N * rank / kAlignCluster;
  const int n1 = N * (rank + 1) / kAlignCluster;
  const int NT = (n1 - n0) * P2, t0 = n0 * P2;
  float4* proj = s_dyn;
  float* s_w = reinterpret_cast<float*>(            // sample, then weight
      s_dyn + (N + kAlignCluster - 1) / kAlignCluster);
  unsigned char* s_ok = reinterpret_cast<unsigned char*>(s_w + NT);
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* p_ref = args.p_ref + y * args.s_p_ref;
  const unsigned char* mask = args.mask + y * args.s_mask;
  const float k = args.huber_k;
  int buf = 0;
  if (tid < 12) sh.T[tid] = args.T_init[y * args.s_T + tid];
  if (tid == 0) {
    sh.cost = 0.0f;
    sh.frac = 0.0f;
  }
  __syncthreads();

  for (int li = 0; li < args.L; ++li) {
    const AlignLevel lv = args.lv[li];
    const float* img = lv.img + y * lv.img_stride;
    const float* ref =
        args.patches + y * args.s_patches + (size_t)li * NP2 + t0;
    const float* jac =
        args.jac + y * args.s_jac + ((size_t)li * NP2 + t0) * 6;
    for (int ch = 0; ch < lv.chunks; ++ch) {
      // ---- refresh pass: sample once (kept in s_w, s_ok for its sweeps)
      project_features(lv, p_ref, mask, sh.T, n0, n1, proj);
      float m3[3] = {0.0f, 0.0f, 0.0f};   // sum ok, ref*ok, cur*ok
      for (int t = tid; t < NT; t += nt) {
        const int n = t / P2;
        const Term r = sample_term(lv, img, proj[n], t - n * P2, P);
        s_w[t] = r.cur;
        s_ok[t] = r.ok;
        const float okf = r.ok ? 1.0f : 0.0f;
        m3[0] += okf;
        m3[1] += __ldg(ref + t) * okf;
        m3[2] += r.cur * okf;
      }
      float a_il = 1.0f, b_il = 0.0f;
      if (args.illum_affine) {   // the illumination pair, in two sweeps
        cluster_sum<3>(m3, sh, buf);
        const float sw = clamp_lo_nan(sh.sum[0], 1.0f);
        const float m_ref = sh.sum[1] / sw, m_cur = sh.sum[2] / sw;
        float cv[2] = {0.0f, 0.0f};   // covariance, variance
        for (int t = tid; t < NT; t += nt) {
          const float okf = s_ok[t] ? 1.0f : 0.0f;
          const float dr = __ldg(ref + t) - m_ref;
          cv[0] += ((s_w[t] - m_cur) * dr) * okf;
          cv[1] += (dr * dr) * okf;
        }
        cluster_sum<2>(cv, sh, buf);
        const float cov = sh.sum[0] / sw, var = sh.sum[1] / sw;
        a_il = clampf_nan(cov / clamp_lo_nan(var, 1e-3f), 0.5f, 2.0f);
        b_il = m_cur - a_il * m_ref;
      }
      float acc[30];
#pragma unroll
      for (int c = 0; c < 30; ++c) acc[c] = 0.0f;
      for (int t = tid; t < NT; t += nt) {
        const float msk = s_ok[t] ? 1.0f : 0.0f;
        const float e = s_w[t] - (a_il * __ldg(ref + t) + b_il);
        const float ae = fabsf(e);
        const float wt = (ae <= k ? 1.0f : k / clamp_lo_nan(ae, 1e-6f)) * msk;
        s_w[t] = wt;
        const float2* j2 = reinterpret_cast<const float2*>(jac + (size_t)t * 6);
        const float2 j01 = __ldg(j2), j23 = __ldg(j2 + 1), j45 = __ldg(j2 + 2);
        const float J[6] = {j01.x, j01.y, j23.x, j23.y, j45.x, j45.y};
        float Jw[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) Jw[i] = J[i] * wt;
        int c = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j) acc[c++] += Jw[i] * J[j];
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * e;
        acc[27] += wt * e * e;
        acc[28] += msk;
        acc[29] += ae < k ? msk : 0.0f;
      }
      cluster_sum<30>(acc, sh, buf);
      // every block of the cluster makes the same solve from the same sums
      if (tid < 32) refresh_solve(sh, a_il);
      __syncthreads();

      // ---- inner passes: the refresh pass's weights and H^-1 ----
      for (int it = 0; it < lv.inner; ++it) {
        project_features(lv, p_ref, mask, sh.T, n0, n1, proj);
        float bs[9];   // b (6), cost, inliers, terms ok
#pragma unroll
        for (int c = 0; c < 9; ++c) bs[c] = 0.0f;
        for (int t = tid; t < NT; t += nt) {
          const int n = t / P2;
          const Term r = sample_term(lv, img, proj[n], t - n * P2, P);
          const float e = r.cur - (a_il * __ldg(ref + t) + b_il);
          const float wt = s_w[t];
          const float2* j2 =
              reinterpret_cast<const float2*>(jac + (size_t)t * 6);
          const float2 j01 = __ldg(j2), j23 = __ldg(j2 + 1),
                       j45 = __ldg(j2 + 2);
          const float J[6] = {j01.x, j01.y, j23.x, j23.y, j45.x, j45.y};
#pragma unroll
          for (int i = 0; i < 6; ++i) bs[i] += J[i] * wt * e;
          bs[6] += wt * e * e;
          bs[7] += (fabsf(e) < k && r.ok) ? 1.0f : 0.0f;
          bs[8] += r.ok ? 1.0f : 0.0f;
        }
        cluster_sum<9>(bs, sh, buf);
        if (tid == 0) {   // T <- T o exp(-(H^-1 b) / a)
          sh.cost = sh.sum[6] / sh.n_ok;
          sh.frac = sh.sum[7] / clamp_lo_nan(sh.sum[8], 1.0f);
          float xi[6], E[12];
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            float s = sh.Hinv[i * 6] * sh.sum[0];
#pragma unroll
            for (int j = 1; j < 6; ++j) s = s + sh.Hinv[i * 6 + j] * sh.sum[j];
            xi[i] = -(s / a_il);
          }
          se3_exp(xi, E);
          se3_compose_into(sh.T, E);
        }
        __syncthreads();
      }
    }
  }
  if (rank == 0) {
    if (tid < 12) args.out[y * kAlignOut + tid] = sh.T[tid];
    if (tid == 12) args.out[y * kAlignOut + 12] = sh.cost;
    if (tid == 13) args.out[y * kAlignOut + 13] = sh.frac;
  }
  // no block leaves while another may still read its sums
  cooperative_groups::this_cluster().sync();
}

}  // namespace

// B3 over B problems: problem b's (K, H, W) images at img + b * img_stride,
// its (M, 2) centres at uv + b * uv_stride, its (K, M, P*P) output the b-th
// block of out.
extern "C" int svo_sample_patch(const float* img, long img_stride, int K,
                                int H, int W, const float* uv, long uv_stride,
                                long M, int P, float* out, int B,
                                void* stream) {
  if (K < 1 || K > kMaxImages || P < 1 || B < 0 || B > kMaxProblems)
    return (int)cudaErrorInvalidValue;
  if (M > 0 && B > 0) {
    cudaStream_t s = (cudaStream_t)stream;
#define SVO_SAMPLE(kP)                                                     \
  launch_sample<kP>(img, img_stride, K, H, W, uv, uv_stride, M, P, out, B, s)
    switch (P) {
      case 4: SVO_SAMPLE(4); break;
      case 8: SVO_SAMPLE(8); break;
      case 16: SVO_SAMPLE(16); break;
      default: SVO_SAMPLE(0);
    }
#undef SVO_SAMPLE
  }
  return (int)cudaGetLastError();
}

// Number of B4 blocks for N features of P x P pixels (at most kMaxBlocks).
extern "C" int svo_gn_blocks(int N, int P) {
  const int per_block = kGnThreads / group_size(P);
  long b = ((long)N + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// Floats of B4 scratch partials a problem needs; the caller allocates them
// once for each number of problems (and one zero-initialised unsigned int
// counter a problem).
extern "C" int svo_gn_scratch_floats(void) { return kMaxBlocks * kAcc; }

// B4 over B problems: problem b's arrays at the element strides given
// (0 for an array all problems share; jac's stride even, for its float2
// loads), its partials the b-th slice of svo_gn_scratch_floats(), its
// counter counter[b], its 45 outputs the b-th 45 of out.
extern "C" int svo_gn_accumulate(
    const float* img, long img_stride, int H, int W, const float* uv,
    long uv_stride, const float* tmpl, long tmpl_stride, const float* jac,
    long jac_stride, const float* mask, long mask_stride, int N, int P,
    const float* a_il, long a_stride, const float* b_il, long b_stride,
    float huber_k,
    float* partials, unsigned int* counter, float* out, int B,
    void* stream) {
  if (P < 1 || group_size(P) > kGnThreads || B < 0 || B > kMaxProblems ||
      jac_stride % 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const int blocks = svo_gn_blocks(N, P);
  const GnStrides st{img_stride,  uv_stride, tmpl_stride, jac_stride,
                     mask_stride, a_stride,  b_stride};
  cudaStream_t s = (cudaStream_t)stream;
  if (P == 4)
    launch_gn<4>(img, H, W, uv, tmpl, jac, mask, N, P, a_il, b_il, st,
                 huber_k, partials, counter, out, blocks, B, s);
  else
    launch_gn<0>(img, H, W, uv, tmpl, jac, mask, N, P, a_il, b_il, st,
                 huber_k, partials, counter, out, blocks, B, s);
  return (int)cudaGetLastError();
}

// Threads of each align_levels block for N features of P x P pixels (a
// block takes up to ceil(N / kAlignCluster) of them): about
// kAlignTermsPerThread terms a thread, a whole number of warps, at most
// kAlignMaxThreads.
extern "C" int svo_align_threads(int N, int P) {
  const long terms =
      (long)((N + kAlignCluster - 1) / kAlignCluster) * P * P;
  long warps = (terms + 32L * kAlignTermsPerThread - 1) /
               (32L * kAlignTermsPerThread);
  if (warps < 1) warps = 1;
  if (warps > kAlignMaxWarps) warps = kAlignMaxWarps;
  return (int)(warps * 32);
}

// The whole alignment of B problems, a cluster of kAlignCluster blocks each
// (align_levels_kernel).
// Per level li (coarse to fine, L <= kMaxAlignLevels): problem 0's image at
// level_ptr[li], problems level_stride[li] elements apart, level_hw[2 li],
// level_hw[2 li + 1] its H, W; intr[4 li..] its (fx, fy, cx, cy);
// bounds[2 li..] in_bounds' (w - 2, h - 2); sched[2 li..] its refresh
// passes and the inner passes after each. The template and T_init: problem
// b's arrays at b times the strides given (0: shared by all problems;
// jac's stride even, jac 8-byte aligned, for its float2 loads). out:
// (B, 14) [T row-major, cost, inlier share]. threads: a block's, a
// multiple of 32 up to 512 (svo_align_threads gives the one the wrapper
// uses).
extern "C" int svo_align_levels(
    const long long* level_ptr, const long* level_stride, const int* level_hw,
    const float* intr, const float* bounds, const int* sched, int L,
    const float* p_ref, long p_ref_stride, const float* patches,
    long patches_stride, const float* jac, long jac_stride,
    const unsigned char* mask, long mask_stride, const float* T_init,
    long T_stride, int N, int P, float huber_k, int illum_affine,
    float* out, int B, int threads, void* stream) {
  if (L < 0 || L > kMaxAlignLevels || N < 0 || P < 1 || B < 0 ||
      B > kMaxProblems || threads < 32 || threads > kAlignMaxThreads ||
      threads % 32 || jac_stride % 2 || ((size_t)jac & 7))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  AlignArgs a{};
  for (int i = 0; i < L; ++i) {
    AlignLevel& lv = a.lv[i];
    lv.img = reinterpret_cast<const float*>(level_ptr[i]);
    lv.img_stride = level_stride[i];
    lv.H = level_hw[2 * i];
    lv.W = level_hw[2 * i + 1];
    lv.fx = intr[4 * i];
    lv.fy = intr[4 * i + 1];
    lv.cx = intr[4 * i + 2];
    lv.cy = intr[4 * i + 3];
    lv.umax = bounds[2 * i];
    lv.vmax = bounds[2 * i + 1];
    lv.chunks = sched[2 * i];
    lv.inner = sched[2 * i + 1];
    if (lv.H < 1 || lv.W < 1 || lv.chunks < 0 || lv.inner < 0)
      return (int)cudaErrorInvalidValue;
  }
  a.L = L;
  a.N = N;
  a.p_ref = p_ref;
  a.patches = patches;
  a.jac = jac;
  a.mask = mask;
  a.T_init = T_init;
  a.s_p_ref = p_ref_stride;
  a.s_patches = patches_stride;
  a.s_jac = jac_stride;
  a.s_mask = mask_stride;
  a.s_T = T_stride;
  a.huber_k = huber_k;
  a.illum_affine = illum_affine;
  a.out = out;
  const size_t shared =
      align_shared_bytes((N + kAlignCluster - 1) / kAlignCluster, P);
  if (shared + sizeof(AlignShared) > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SVO_ALIGN(kP)                                                        \
  do {                                                                       \
    if (shared + sizeof(AlignShared) > 48 * 1024) {                          \
      const cudaError_t err = cudaFuncSetAttribute(                          \
          align_levels_kernel<kP>,                                           \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);         \
      if (err != cudaSuccess) return (int)err;                               \
    }                                                                        \
    align_levels_kernel<kP>                                                  \
        <<<(unsigned)B * kAlignCluster, threads, shared, s>>>(a, P);         \
  } while (0)
  if (P == 4)
    SVO_ALIGN(4);
  else
    SVO_ALIGN(0);
#undef SVO_ALIGN
  return (int)cudaGetLastError();
}
