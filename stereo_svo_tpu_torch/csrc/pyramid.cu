// Image pyramid kernels for Hopper (sm_90a): every level's image plane in
// one launch (B1) and central-difference gradients (B2).
//
// B1 replaces the Pallas TPU kernel
// stereo_svo_tpu/ops/pallas/pyramid_kernel.py `halfsample` (_half_kernel),
// which the TPU runs once per level. Bytes bound it: it reads the frame and
// writes level 0 and every coarser level once, ~3.4 MB at 752x480 (1.0 us at
// 3.35 TB/s), with four additions and a multiply per coarse pixel. One
// launch per level would pay a launch each for levels 2 and 3, which move
// 0.45 and 0.11 MB, and read every level back from device memory. Here
// every coarse pixel depends only on a 2^l x 2^l block of level 0, so one
// block owns a 32x64 tile of level 0 (aligned to 2^5 in both axes), stages
// it in shared memory with coalesced 4-byte loads (KITTI's 1241-float rows
// are not 16-byte aligned, so no vector or TMA loads), writes it out as
// level 0, and builds levels 1-5 of the tile from shared memory: no halo,
// no second read of the frame. A warp owns 4 tile rows, so levels 1 and 2
// need only __syncwarp; one __syncthreads precedes levels 3-5, which warp 0
// computes. A deeper pyramid continues with another launch from the
// deepest level written. Each pixel keeps the plain version's arithmetic,
// (((a + b) + c) + d) * 0.25f, built with -fmad=false: every level is bit
// for bit the 2x2 mean of the one above it.
//
// B2 replaces `gradients` (_grad_kernel) of the same file: a memory-bound
// stencil, one thread per pixel, neighbouring threads on neighbouring
// columns so every warp reads and writes contiguous rows.
//
// The problem axis (the counterpart of the reference's jax.vmap over B
// frames or thumbnails of one shape): both kernels take B problems in one
// launch, grid dimension z, each with its input and outputs at a fixed
// element stride from the first problem's. A block computes exactly what
// the one-problem launch computes for its problem, so problem b of a launch
// equals a launch of problem b alone bit for bit, and a launch with B = 1
// is the one-problem launch.
//
// Plain C interface (loaded with ctypes); every entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32, TILE_W = 64;  // level-0 tile of one block
constexpr int CHAIN = 6;                 // levels one launch covers: 2^5 | 32
constexpr int WARPS = TILE_H / 4;        // 4 tile rows a warp
constexpr int MAX_LEVELS = 32;           // level 31 is empty for any int size

struct Chain {
  float* out[CHAIN];  // image plane of each level; out[0] null: input kept
  int h[CHAIN], w[CHAIN];
  int n;              // levels in this launch, its input level included
  long in_stride;     // elements from one problem's input to the next's
  long out_stride;    // the same for the outputs
};

__device__ __forceinline__ float mean4(float a, float b, float c, float d) {
  // the plain version's order: ((a + b) + c) + d
  return (((a + b) + c) + d) * 0.25f;
}

__device__ __forceinline__ void put(const Chain& c, size_t off, int l, int y,
                                    int x, float v) {
  if (y < c.h[l] && x < c.w[l]) c.out[l][off + (size_t)y * c.w[l] + x] = v;
}

// Level l of the tile from the level above it in shared memory: the 2x2
// block under output (y, x) is a float2 in each of two rows.
__device__ __forceinline__ float down(const float* above, int pitch, int y,
                                      int x) {
  const float2 a = reinterpret_cast<const float2*>(above + 2 * y * pitch)[x];
  const float2 b =
      reinterpret_cast<const float2*>(above + (2 * y + 1) * pitch)[x];
  return mean4(a.x, a.y, b.x, b.y);
}

__global__ void __launch_bounds__(WARPS * 32)
    pyramid_levels_kernel(const float* __restrict__ in, Chain c) {
  __shared__ __align__(16) float l0[WARPS][4 * TILE_W];
  __shared__ __align__(16) float l1[WARPS][2 * TILE_W / 2];
  __shared__ __align__(16) float l2[TILE_H / 4 * TILE_W / 4];
  __shared__ __align__(16) float l3[TILE_H / 8 * TILE_W / 8];
  __shared__ __align__(16) float l4[TILE_H / 16 * TILE_W / 16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  in += (size_t)blockIdx.z * c.in_stride;                 // this problem's
  const size_t off = (size_t)blockIdx.z * c.out_stride;

  // level 0: the warp's 4 rows, each as two coalesced 32-column halves;
  // all 8 loads are issued before the first store
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int y = y0 + 4 * warp + (i >> 1), x = x0 + 32 * (i & 1) + lane;
    v[i] = (y < c.h[0] && x < c.w[0]) ? in[(size_t)y * c.w[0] + x] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l0[warp][(i >> 1) * TILE_W + 32 * (i & 1) + lane] = v[i];
    if (c.out[0] != nullptr)
      put(c, off, 0, y0 + 4 * warp + (i >> 1), x0 + 32 * (i & 1) + lane, v[i]);
  }
  // c.n is the same in every thread, so these returns skip no barrier that
  // another thread waits at
  if (c.n < 2) return;
  __syncwarp();
  // level 1: the warp's 2 rows of 32 pixels
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m = down(l0[warp], TILE_W, r, lane);
    l1[warp][r * (TILE_W / 2) + lane] = m;
    put(c, off, 1, (y0 >> 1) + 2 * warp + r, (x0 >> 1) + lane, m);
  }
  if (c.n < 3) return;
  __syncwarp();
  // level 2: the warp's row of 16 pixels
  if (lane < TILE_W / 4) {
    const float m = down(l1[warp], TILE_W / 2, 0, lane);
    l2[warp * (TILE_W / 4) + lane] = m;
    put(c, off, 2, (y0 >> 2) + warp, (x0 >> 2) + lane, m);
  }
  if (c.n < 4) return;
  __syncthreads();  // every warp's level-2 row is in place
  if (warp != 0) return;
  // levels 3-5 by warp 0: 4x8 pixels (one a lane), then 2x4, then 1x2
  {
    const int y = lane >> 3, x = lane & 7;
    const float m = down(l2, TILE_W / 4, y, x);
    l3[lane] = m;
    put(c, off, 3, (y0 >> 3) + y, (x0 >> 3) + x, m);
  }
  if (c.n < 5) return;
  __syncwarp();
  if (lane < 8) {
    const int y = lane >> 2, x = lane & 3;
    const float m = down(l3, TILE_W / 8, y, x);
    l4[lane] = m;
    put(c, off, 4, (y0 >> 4) + y, (x0 >> 4) + x, m);
  }
  if (c.n < 6) return;
  __syncwarp();
  if (lane < 2)
    put(c, off, 5, y0 >> 5, (x0 >> 5) + lane, down(l4, TILE_W / 16, 0, lane));
}

__global__ void gradients_kernel(const float* __restrict__ in,
                                 long in_stride, float* __restrict__ gx,
                                 float* __restrict__ gy, long out_stride,
                                 int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  in += (size_t)blockIdx.z * in_stride;                   // this problem's
  gx += (size_t)blockIdx.z * out_stride;
  gy += (size_t)blockIdx.z * out_stride;
  const size_t i = (size_t)y * W + x;
  float vx = 0.0f, vy = 0.0f;
  if (x > 0 && x < W - 1) vx = 0.5f * (in[i + 1] - in[i - 1]);
  if (y > 0 && y < H - 1) vy = 0.5f * (in[i + W] - in[i - W]);
  gx[i] = vx;
  gy[i] = vy;
}

// Levels 0..n-1 of one launch (n <= CHAIN) from ``in``, the image of
// level 0 (h[0] x w[0], contiguous), for B problems at the given strides.
// Launches nothing for an empty input.
int launch_chain(const float* in, long in_stride, float* const* out,
                 long out_stride, const int* h, const int* w, int n, int B,
                 cudaStream_t stream) {
  if (h[0] <= 0 || w[0] <= 0 || B <= 0) return (int)cudaSuccess;
  Chain c;
  for (int l = 0; l < CHAIN; ++l) {
    c.out[l] = l < n ? out[l] : nullptr;
    c.h[l] = l < n ? h[l] : 0;
    c.w[l] = l < n ? w[l] : 0;
  }
  c.n = n;
  c.in_stride = in_stride;
  c.out_stride = out_stride;
  const dim3 grid((w[0] + TILE_W - 1) / TILE_W, (h[0] + TILE_H - 1) / TILE_H,
                  B);
  pyramid_levels_kernel<<<grid, WARPS * 32, 0, stream>>>(in, c);
  return (int)cudaGetLastError();
}

}  // namespace

// The image planes of the L-level pyramids of B frames of H x W, frame b at
// ``in + b * in_stride``: level l is the first plane of a (3, h_l, w_l)
// buffer, h_{l+1} = h_l / 2 (likewise w), and one frame's buffers lie one
// after another, frame b's from ``base + b * total`` (total: the elements
// of one frame's buffers). One launch for L <= 6; each further launch
// starts from the deepest level written and adds up to 5 levels, while
// that level is not empty.
extern "C" int svo_pyramid(const float* in, long in_stride, float* base,
                           int H, int W, int L, int B, void* stream) {
  if (L < 1 || L > MAX_LEVELS || H < 0 || W < 0 || B < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  int h[MAX_LEVELS], w[MAX_LEVELS];
  float* img[MAX_LEVELS];
  size_t off = 0;
  for (int l = 0; l < L; ++l) {
    h[l] = l ? h[l - 1] / 2 : H;
    w[l] = l ? w[l - 1] / 2 : W;
    img[l] = base + off;
    off += (size_t)3 * h[l] * w[l];
  }
  const long total = (long)off;
  for (int s = 0; s == 0 || s < L - 1; s += CHAIN - 1) {
    float* out[CHAIN];
    const int n = L - s < CHAIN ? L - s : CHAIN;
    for (int l = 0; l < n; ++l) out[l] = img[s + l];
    if (s > 0) out[0] = nullptr;  // written by the launch before
    const int rc = launch_chain(s ? img[s] : in, s ? total : in_stride, out,
                                total, h + s, w + s, n, B,
                                (cudaStream_t)stream);
    if (rc != (int)cudaSuccess) return rc;
  }
  return (int)cudaSuccess;
}

// One 2x2 half-sample, H x W ``in`` to (H/2) x (W/2) ``out``: the same
// kernel with two levels, the input not copied.
extern "C" int svo_halfsample(const float* in, float* out, int H, int W,
                              void* stream) {
  float* outs[2] = {nullptr, out};
  const int h[2] = {H, H / 2}, w[2] = {W, W / 2};
  return launch_chain(in, 0, outs, 0, h, w, 2, 1, (cudaStream_t)stream);
}

// Gradients of B images of H x W, image b at ``in + b * in_stride``, its gx
// and gy at ``gx + b * out_stride`` and ``gy + b * out_stride``.
extern "C" int svo_gradients(const float* in, long in_stride, float* gx,
                             float* gy, long out_stride, int H, int W, int B,
                             void* stream) {
  if (B < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (H > 0 && W > 0 && B > 0) {
    dim3 block(32, 8);
    dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B);
    gradients_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        in, in_stride, gx, gy, out_stride, H, W);
  }
  return (int)cudaGetLastError();
}
