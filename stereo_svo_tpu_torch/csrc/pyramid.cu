// Image pyramid kernels for Hopper (sm_90a): every level's image plane in
// one launch (B1) and every level's central-difference gradients in one
// launch (B2).
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
// B2 replaces `gradients` (_grad_kernel, the pl.pallas_call at
// stereo_svo_tpu/ops/pallas/pyramid_kernel.py:70), which the TPU runs once
// per level. Bytes bound it: every level's image read once and its gx and
// gy written once, 12 bytes a pixel, 5.75 MB for a 752x480 pyramid of 4
// levels (1.717 us at 3.35 TB/s), with two operations per output. One
// launch per level paid a launch floor (~1.2 us) for each of levels 1-3,
// which move 1.08, 0.27 and 0.07 MB, so B2 writes every level of every
// problem in one launch: the grid enumerates the tiles of every non-empty
// level, largest level first (the small levels fill the tail), and
// blockIdx.z is the problem; a block finds its level in a prefix table of
// tile counts passed by value. A warp owns 32 consecutive columns (128
// columns as float4 where the level's width and planes allow 16-byte
// access: 752x480 levels 0-2, not KITTI's 1241 or level 3's 94) and walks
// down GRAD_ROWS rows, starting every load of its rows and the rows above
// and below before the first use: gy comes from registers, gx from the
// neighbouring lanes by shuffles, and the warp's two edge lanes load the
// one column beyond it. Each output keeps the plain version's expression,
// 0.5f * (in[i+1] - in[i-1]), and is zero on each level's border rows and
// columns (every row or column when h or w <= 2): bit for bit the plain
// version.
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

constexpr int GRAD_WARPS = 4;  // warps of a B2 block, one above the other
constexpr int GRAD_ROWS = 2;   // rows each thread walks down
constexpr int GRAD_TILE_H = GRAD_WARPS * GRAD_ROWS;

struct GradLevel {
  const float* in;  // the level's image, problem 0
  float* gx;        // its gx and gy planes, problem 0
  float* gy;
  int h, w;
  int vec;          // columns a thread owns: 4 (float4 access) or 1
  int tiles_x;      // tile columns: ceil(w / (32 * vec))
  int first;        // the level's first tile in the grid
};

struct GradWork {
  GradLevel lv[MAX_LEVELS];  // the levels with tiles, largest first
  int n;
  long in_stride;            // elements from one problem's image to the next
  long out_stride;           // the same for gx and gy
};

template <int V>
struct Cols {
  float v[V];
};

template <int V>
__device__ __forceinline__ Cols<V> load_cols(const float* p) {
  Cols<V> c;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    c.v[0] = q.x, c.v[1] = q.y, c.v[2] = q.z, c.v[3] = q.w;
  } else {
    c.v[0] = *p;
  }
  return c;
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// One thread's V columns from x on, rows y0 .. y0 + GRAD_ROWS - 1 of level
// ``L``; every lane of the warp takes part in the shuffles.
template <int V>
__device__ __forceinline__ void grad_strip(const GradLevel& L,
                                           const float* __restrict__ in,
                                           float* __restrict__ gx,
                                           float* __restrict__ gy, int x,
                                           int y0, int lane) {
  const int h = L.h, w = L.w;
  const bool cols = x < w;
  // the rows above, at and below the strip, and the columns beyond the
  // warp's edges: every load started before the first use
  Cols<V> r[GRAD_ROWS + 2];
  float left[GRAD_ROWS], right[GRAD_ROWS];
#pragma unroll
  for (int i = 0; i < GRAD_ROWS + 2; ++i) {
    const int y = y0 - 1 + i;
    if (cols && y >= 0 && y < h) {
      r[i] = load_cols<V>(in + (size_t)y * w + x);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) r[i].v[k] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < GRAD_ROWS; ++i) {
    const size_t row = (size_t)(y0 + i) * w;
    const bool y_ok = y0 + i < h;
    left[i] = (lane == 0 && x > 0 && y_ok) ? in[row + x - 1] : 0.0f;
    right[i] = (lane == 31 && x + V < w && y_ok) ? in[row + x + V] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < GRAD_ROWS; ++i) {
    const int y = y0 + i;
    const Cols<V>& c = r[i + 1];
    // column x - 1 is the last of the lane before, x + V the first of the
    // lane after
    const float up = __shfl_up_sync(0xffffffffu, c.v[V - 1], 1);
    const float down = __shfl_down_sync(0xffffffffu, c.v[0], 1);
    const float l = lane == 0 ? left[i] : up;
    const float rr = lane == 31 ? right[i] : down;
    const bool y_in = y > 0 && y < h - 1;
    float ox[V], oy[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int col = x + k;
      const float a = k == 0 ? l : c.v[k - 1];
      const float b = k == V - 1 ? rr : c.v[k + 1];
      ox[k] = (col > 0 && col < w - 1) ? 0.5f * (b - a) : 0.0f;
      oy[k] = y_in ? 0.5f * (r[i + 2].v[k] - r[i].v[k]) : 0.0f;
    }
    if (cols && y < h) {
      store_cols<V>(gx + (size_t)y * w + x, ox);
      store_cols<V>(gy + (size_t)y * w + x, oy);
    }
  }
}

__global__ void __launch_bounds__(GRAD_WARPS * 32)
    gradients_levels_kernel(const __grid_constant__ GradWork wk) {
  // the level of this block's tile: the last whose first tile is not
  // beyond it (the same for every thread of the block)
  const int t = blockIdx.x;
  int l = 0;
  while (l + 1 < wk.n && t >= wk.lv[l + 1].first) ++l;
  const GradLevel& L = wk.lv[l];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = t - L.first;
  const int ty = tile / L.tiles_x, tx = tile - ty * L.tiles_x;
  const int y0 = ty * GRAD_TILE_H + warp * GRAD_ROWS;
  const float* in = L.in + (size_t)blockIdx.z * wk.in_stride;
  float* gx = L.gx + (size_t)blockIdx.z * wk.out_stride;
  float* gy = L.gy + (size_t)blockIdx.z * wk.out_stride;
  if (L.vec == 4)
    grad_strip<4>(L, in, gx, gy, (tx * 32 + lane) * 4, y0, lane);
  else
    grad_strip<1>(L, in, gx, gy, tx * 32 + lane, y0, lane);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// B2 on the levels ``wk.lv[0..n)`` (in, gx, gy, h, w set, largest first),
// B problems at wk's strides: fills in each level's tiles, drops the empty
// levels, launches once. Launches nothing when no level has a pixel.
int launch_gradients(GradWork& wk, int n, int B, cudaStream_t stream) {
  if (B < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  long tiles = 0;
  int m = 0;
  const bool strides4 = B <= 1 || (wk.in_stride % 4 == 0
                                   && wk.out_stride % 4 == 0);
  for (int l = 0; l < n; ++l) {
    GradLevel L = wk.lv[l];
    if (L.h <= 0 || L.w <= 0) continue;
    L.vec = (L.w % 4 == 0 && strides4 && aligned16(L.in) && aligned16(L.gx)
             && aligned16(L.gy)) ? 4 : 1;
    L.tiles_x = (L.w + 32 * L.vec - 1) / (32 * L.vec);
    L.first = (int)tiles;
    tiles += (long)L.tiles_x * ((L.h + GRAD_TILE_H - 1) / GRAD_TILE_H);
    wk.lv[m++] = L;
  }
  wk.n = m;
  if (tiles == 0 || B == 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  gradients_levels_kernel<<<dim3((unsigned)tiles, 1, B), GRAD_WARPS * 32, 0,
                            stream>>>(wk);
  return (int)cudaGetLastError();
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

// Every level's gx and gy planes of the B pyramids that svo_pyramid lays
// out from ``base`` (the same H, W, L and per-pyramid stride), from their
// image planes: one launch.
extern "C" int svo_pyramid_gradients(float* base, int H, int W, int L, int B,
                                     void* stream) {
  if (L < 1 || L > MAX_LEVELS || H < 0 || W < 0 || B < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  GradWork wk{};
  size_t off = 0;
  int h = H, w = W;
  for (int l = 0; l < L; ++l) {
    const size_t plane = (size_t)h * w;
    wk.lv[l] = {base + off, base + off + plane, base + off + 2 * plane, h, w,
                1, 0, 0};
    off += 3 * plane;
    h /= 2;
    w /= 2;
  }
  wk.in_stride = wk.out_stride = (long)off;
  return launch_gradients(wk, L, B, (cudaStream_t)stream);
}

// Gradients of B images of H x W, image b at ``in + b * in_stride``, its gx
// and gy at ``gx + b * out_stride`` and ``gy + b * out_stride``: the same
// kernel on a one-level list.
extern "C" int svo_gradients(const float* in, long in_stride, float* gx,
                             float* gy, long out_stride, int H, int W, int B,
                             void* stream) {
  if (H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  GradWork wk{};
  wk.lv[0] = {in, gx, gy, H, W, 1, 0, 0};
  wk.in_stride = in_stride;
  wk.out_stride = out_stride;
  return launch_gradients(wk, 1, B, (cudaStream_t)stream);
}
