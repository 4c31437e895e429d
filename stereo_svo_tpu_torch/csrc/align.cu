// Patch sampling (B3) and the fused Gauss-Newton accumulation of sparse
// image alignment (B4) for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels stereo_svo_tpu/ops/pallas/align_kernel.py
// `sample_patches` (_sample_kernel) and `gn_accumulate` (_gn_kernel).
// On the TPU those kernels read each patch's (P+1)^2 window out of VMEM
// with one-hot micro-matmuls over an 8-aligned 16-row block, because Mosaic
// has no cheap dynamic gather.
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

#include <cuda_runtime.h>

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

__host__ inline int sample_block_threads(int P) {
  return group_size(P) <= 32 ? 64 : 128;
}

// The taps of one output, as interp.bilinear computes them.
struct Taps {
  int iu0, iu1, iv0, iv1;
  float du, dv;
};

__device__ __forceinline__ Taps taps_of(float cu, float cv, int p, int P,
                                        int H, int W, float umax,
                                        float vmax) {
  const float half = (float)(P - 1) * 0.5f;
  const int py = p / P, px = p - py * P;
  const float u = clampf_nan(cu + ((float)px - half), 0.0f, umax);
  const float v = clampf_nan(cv + ((float)py - half), 0.0f, vmax);
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

__device__ __forceinline__ float blend(float p00, float p01, float p10,
                                       float p11, float du, float dv) {
  const float top = p00 + du * (p01 - p00);
  const float bot = p10 + du * (p11 - p10);
  return top + dv * (bot - top);
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
