// The v4 compositing arithmetic shared by K1 and K2a (rasterize_v4.cu) and K6
// (rasterize_v4_seg.cu), and the pixel layout and warp cull that K2b
// (rasterize_v4_bwd.cu) shares with them: the constants, the per-pixel
// state and the walk of one pixel over one chunk of splat rows in shared
// memory. One copy, so the three forward kernels' outputs are equal bit for
// bit on equal rows.
//
// The arithmetic is that of `composite_chunk_grouped`
// (gaussiananything_tpu/ops/rasterize.py:360) as the v4 TPU kernels evaluate
// it (rasterize_pallas.py:850-943). Built without fast math and with
// -fmad=false: see rasterize_v4.cu on the knife edges.
//
// The warp cull. A warp owns an 8 x 4 pixel rectangle of its 16 x 16 tile
// (warps 0-7 in two columns of four rows). Columns 22 and 23 of a splat row,
// the padding of the 22 packed fields, hold the splat's pixel box
// ([floor(bb_min), ceil(bb_max)] of `preprocess_splats`, clamped to the
// image) as two int16 pairs in the bits of two floats (`rasterize.
// splat_table`). A warp whose rectangle, widened by 1 px, misses the box
// skips the row. That is exact: outside the box rho3d >= 9 and rho2d >= 9
// in exact arithmetic, so the window and alpha are 0, and alpha >= 1/255
// needs rho < 8.70 at opacity 1, so fp32 rounding near the edge leaves
// alpha far below the keep threshold; every walk treats such a step as
// `continue` (factor 1, weight 0), so skipping it changes no sum in any
// order. tests/test_torch_cull.py checks on seeded and adversarial scenes
// that every step the plain walk keeps lies inside.
//
// The walk's latency. A training frame's time is set by its heaviest tile
// (PERF.md: 95% of K2a's span after the median block ends), which walks
// ~900 rows per pixel alone on its SM; a row's geometry is a dependent
// chain of shared loads, an IEEE division and expf. So the walk takes the
// rows two at a time, their chains side by side, the state row by row.
#pragma once

#include <cuda_runtime.h>

namespace ga_v4 {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block
constexpr int kMaxChunk = 256;        // splat rows staged per chunk
constexpr int kRowF4 = 6;             // float4 per splat row
constexpr int kOut = 10;              // output channels
constexpr int kWarpW = 8;             // a warp's pixel rectangle
constexpr int kWarpH = 4;

constexpr float kFilterInvSquare = 2.0f;
constexpr float kAlphaEps = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kNearCull = 0.2f;
constexpr float kRhoCut = 9.0f;
constexpr float kRhoRamp = 1.0f;
constexpr float kZNear = 0.01f;
constexpr float kZFar = 100.0f;
constexpr float kZRange = (float)(100.0 - 0.01);

// Where thread `lid` of a tile's block sits: its pixel (lx, ly) in the tile
// and its warp's rectangle, widened by the cull's 1 px margin, in image
// pixels (the tile's origin at (x0, y0)).
struct PixelSlot {
  int lx, ly;                 // pixel in the tile; index ly * kTile + lx
  int wx_lo, wx_hi, wy_lo, wy_hi;
};

__device__ __forceinline__ PixelSlot pixel_slot(int lid, int x0, int y0) {
  const int warp = lid >> 5;
  const int lane = lid & 31;
  PixelSlot p;
  const int wx = (warp & 1) * kWarpW;
  const int wy = (warp >> 1) * kWarpH;
  p.lx = wx + (lane % kWarpW);
  p.ly = wy + (lane / kWarpW);
  p.wx_lo = x0 + wx - 1;
  p.wx_hi = x0 + wx + kWarpW;
  p.wy_lo = y0 + wy - 1;
  p.wy_hi = y0 + wy + kWarpH;
  return p;
}

// Whether the warp of `p` misses the box in columns 22, 23 (`f5.z`, `f5.w`
// of the row's sixth float4: x0 | x1 << 16 and y0 | y1 << 16).
__device__ __forceinline__ bool warp_misses(const float4& f5,
                                            const PixelSlot& p) {
  const int bx = __float_as_int(f5.z);
  const int by = __float_as_int(f5.w);
  return (bx >> 16) < p.wx_lo || (bx & 0xffff) > p.wx_hi ||
         (by >> 16) < p.wy_lo || (by & 0xffff) > p.wy_hi;
}

// The geometry of N (pixel, row) steps, the forward's expressions in its
// order: the clamped alpha, the depth and the keep test of each. Written
// statement by statement across the N rows, so their independent chains
// (shared loads, an IEEE division, expf) interleave in one warp's
// instruction stream; each row's values are the serial walk's bit for bit.
template <int N>
__device__ __forceinline__ void step_geometry(const float4* const (&row)[N],
                                              float px, float py,
                                              float (&alpha)[N],
                                              float (&depth)[N],
                                              bool (&keep)[N]) {
  float p0[N], p1[N], p2[N], inv[N], rho[N], win[N];
  float4 f2[N], f3[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float4 f0 = row[j][0];   // a0 a1 a2 b0
    const float4 f1 = row[j][1];   // b1 b2 c0 c1
    f2[j] = row[j][2];             // c2 tz0 tz1 tz2
    f3[j] = row[j][3];             // cx cy cz op
    p0[j] = px * f0.x + py * f0.w + f1.z;
    p1[j] = px * f0.y + py * f1.x + f1.w;
    p2[j] = px * f0.z + py * f1.y + f2[j].x;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float safe = fabsf(p2[j]) < 1e-9f ? 1e-9f : p2[j];
    inv[j] = 1.0f / safe;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float u = p0[j] * inv[j];
    const float v = p1[j] * inv[j];
    const float rho3d = u * u + v * v;
    const float dx = px - f3[j].x;
    const float dy = py - f3[j].y;
    const float rho2d = kFilterInvSquare * (dx * dx + dy * dy);
    const bool use3d = rho3d <= rho2d;
    rho[j] = fminf(rho3d, rho2d);
    depth[j] = use3d ? u * f2[j].y + v * f2[j].z + f2[j].w : f3[j].z;
    win[j] = fminf(fmaxf((kRhoCut - rho[j]) / kRhoRamp, 0.0f), 1.0f);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float gau = expf(-0.5f * rho[j]) * win[j];
    alpha[j] = fminf(f3[j].w * gau, kAlphaMax);
    keep[j] = (alpha[j] >= kAlphaEps) & (depth[j] > kNearCull);
  }
}

// One pixel's compositing state, in registers.
struct PixelState {
  float T = 1.0f, A = 0.0f, D = 0.0f, D2 = 0.0f, dist = 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  float dexp = 0.0f, dmed = 0.0f;
};

// Composite pixel (px, py) over the first `n` rows of `rows` (shared
// memory, kRowF4 float4 each, front to back) and fold the chunk's sums into
// the state: sums are added at the chunk end, the distortion takes the chunk
// sums with the entry-state cross terms, and T <= kTEps is flushed to 0.
// Every 32 rows, lane l tests row l's box for its warp (one ballot); the
// warp then takes the rows it meets two at a time: their geometry side by
// side (`step_geometry`), then the state, row by row in order. The rows it
// misses are never looked at. Every thread of the block calls this.
//
// With kMarks, the warp also writes `marks[k / 32]`, bit k % 32 set for
// each row k that some lane of the warp blends (kept and entered at
// T > T_EPS): K2a's record of where the backward has work (K2b).
template <bool kMarks = false>
__device__ __forceinline__ void composite_rows(const float4* rows, int n,
                                               float px, float py,
                                               const PixelSlot& slot,
                                               PixelState& s,
                                               unsigned* marks = nullptr) {
  float &T = s.T, &A = s.A, &D = s.D, &D2 = s.D2, &dist = s.dist;
  float &cr = s.cr, &cg = s.cg, &cb = s.cb;
  float &n0 = s.n0, &n1 = s.n1, &n2 = s.n2, &dexp = s.dexp, &dmed = s.dmed;
  const float T_in0 = T;    // chunk-entry transmittance
  float tc = 1.0f;          // Π (1 - α) over this chunk so far
  float s_r = 0.0f, s_g = 0.0f, s_b = 0.0f;
  float s_n0 = 0.0f, s_n1 = 0.0f, s_n2 = 0.0f;
  float s_w = 0.0f, s_wz = 0.0f, s_med = 0.0f, s_wm = 0.0f, s_wm2 = 0.0f;
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int kl = k0 + lane;
    const bool meets = kl < n && !warp_misses(rows[kl * kRowF4 + 5], slot);
    unsigned todo = __ballot_sync(0xffffffffu, meets);
    unsigned word = 0;
    while (todo) {
      const int ka = k0 + __ffs(todo) - 1;
      todo &= todo - 1;
      const bool two = todo != 0;
      const int kb = two ? k0 + __ffs(todo) - 1 : ka;
      todo &= todo - 1;
      const float4* const row[2] = {rows + ka * kRowF4, rows + kb * kRowF4};
      float alpha[2], depth[2];
      bool keep[2];
      step_geometry<2>(row, px, py, alpha, depth, keep);
      keep[1] = keep[1] & two;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // α = 0 where not kept: factor 1, weight 0, no crossing
        bool blends = false;
        if (keep[j]) {
          const float t_excl = tc;
          const float t_in = T_in0 * t_excl;
          const float t_incl = tc * (1.0f - alpha[j]);
          tc = t_incl;
          const float t_after = T_in0 * t_incl;
          if ((t_in > 0.5f) & (t_after <= 0.5f)) s_med = s_med + depth[j];
          blends = t_in > kTEps;
          if (blends) {
            const float w = T_in0 * alpha[j] * t_excl;
            const float4 f4 = row[j][4];   // r g b nx
            const float4 f5 = row[j][5];   // ny nz box_x box_y
            s_r = s_r + w * f4.x;
            s_g = s_g + w * f4.y;
            s_b = s_b + w * f4.z;
            s_n0 = s_n0 + w * f4.w;
            s_n1 = s_n1 + w * f5.x;
            s_n2 = s_n2 + w * f5.y;
            s_w = s_w + w;
            s_wz = s_wz + w * depth[j];
            const float zc = fmaxf(depth[j], kZNear);
            const float m = (kZFar * (zc - kZNear)) / (zc * kZRange);
            const float wm = w * m;
            s_wm = s_wm + wm;
            s_wm2 = s_wm2 + wm * m;
          }
        }
        if constexpr (kMarks) {
          if (__any_sync(0xffffffffu, blends))
            word |= 1u << ((j ? kb : ka) - k0);
        }
      }
    }
    if constexpr (kMarks) {
      if (lane == 0) marks[k0 / 32] = word;
    }
  }

  cr = cr + s_r;
  cg = cg + s_g;
  cb = cb + s_b;
  n0 = n0 + s_n0;
  n1 = n1 + s_n1;
  n2 = n2 + s_n2;
  dexp = dexp + s_wz;
  dmed = dmed + s_med;
  dist = dist + A * s_wm2 + D2 * s_w - 2.0f * D * s_wm
         + (s_w * s_wm2 - s_wm * s_wm);
  A = A + s_w;
  D = D + s_wm;
  D2 = D2 + s_wm2;
  const float t_raw = T_in0 * tc;
  T = t_raw > kTEps ? t_raw : 0.0f;
}

// The tiles by descending work, ties by id (`order[rank] = tile`), where a
// tile's work is its count, or min(count, n_exec · chunk) where `n_exec` is
// given; where `chunk_off` is given, also the exclusive cumsum of
// ceil(count / chunk) (`rasterize.chunk_offsets`). K2a's and K2b's blocks
// take the tiles in this order, so the heaviest start first. One thread per
// tile counts against all the others in shared memory: O(n_tiles²) integer
// compares, a few µs at 1,024 tiles, and no host round trip.
__global__ void tile_order_kernel(const int* __restrict__ counts,
                                  const int* __restrict__ n_exec, int chunk,
                                  int n_tiles, int* __restrict__ order,
                                  int* __restrict__ chunk_off) {
  extern __shared__ int work[];         // work, then chunks, n_tiles each
  int* chunks = work + n_tiles;
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    const int c = counts[i];
    work[i] = n_exec ? min(c, n_exec[i] * chunk) : c;
    chunks[i] = (c + chunk - 1) / chunk;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tiles) return;
  const int wi = work[i];
  int rank = 0, off = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int wj = work[j];
    rank += (wj > wi) | ((wj == wi) & (j < i));
    off += j < i ? chunks[j] : 0;
  }
  order[rank] = i;
  if (chunk_off) {
    chunk_off[i] = off;
    if (i == n_tiles - 1) chunk_off[n_tiles] = off + chunks[i];
  }
}

// Launch tile_order_kernel on `stream`; returns its CUDA error.
inline cudaError_t launch_tile_order(const int* counts, const int* n_exec,
                                     int chunk, int n_tiles, int* order,
                                     int* chunk_off, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const size_t shmem = 2 * (size_t)n_tiles * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tile_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return err;
  tile_order_kernel<<<(n_tiles + kThreads - 1) / kThreads, kThreads, shmem,
                      stream>>>(counts, n_exec, chunk, n_tiles, order,
                                chunk_off);
  return cudaGetLastError();
}

// Write the pixel's ten output channels, the image blended over `bg`.
// `o` points at the pixel in channel 0; `plane` is one channel's size.
__device__ __forceinline__ void store_pixel(const PixelState& s,
                                            const float* __restrict__ bg,
                                            float* __restrict__ o,
                                            size_t plane) {
  o[0 * plane] = s.cr + s.T * bg[0];
  o[1 * plane] = s.cg + s.T * bg[1];
  o[2 * plane] = s.cb + s.T * bg[2];
  o[3 * plane] = s.A;
  o[4 * plane] = s.dexp;
  o[5 * plane] = s.dmed;
  o[6 * plane] = s.dist;
  o[7 * plane] = s.n0;
  o[8 * plane] = s.n1;
  o[9 * plane] = s.n2;
}

}  // namespace ga_v4
