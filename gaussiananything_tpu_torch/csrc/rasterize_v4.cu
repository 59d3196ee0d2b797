// K1 and K2a: the 2DGS forward compositor for Hopper (sm_90a), and the same
// compositor keeping what the backward kernel needs.
//
// K1 (`composite_v4_kernel<false>`):
//
// Replaces the TPU kernel `_make_v4_kernel(dma=False)` of
// gaussiananything_tpu/ops/rasterize_pallas.py:806, driven there by
// `rasterize_tiled_v4` (:1010). It computes what that kernel computes (the
// per-pair math of `composite_chunk_grouped`, rasterize.py:360) but is not
// carried over block by block:
//
//   * one thread block per 16x16-pixel tile, one thread per pixel;
//   * the block walks its tile's depth-ordered pair segment (starts/counts
//     of `build_tile_pairs`) in chunks: the threads copy each chunk's splat
//     rows (22 packed fields, padded to 96 bytes = six float4) from the
//     splat-major table into shared memory, then every thread composites
//     its pixel over the chunk serially;
//   * the block leaves once no pixel has T > T_EPS (`__syncthreads_or`),
//     the per-tile saturation exit of the TPU kernel.
//
// The kernel reads splats through the pair indices itself, so the TPU's
// dense step-table gather and its `steps_per_group` budget do not exist
// here: the result is the untruncated one, equal to `rz.rasterize_tiled`.
//
// What bounds it on this card: operations. Each (pixel, pair) step costs
// about 60 fp32 operations (a division and an expf among them) for 96
// bytes of splat row read once per tile from shared memory, so the table
// and pair reads (a few MB a view) are far below the memory roofline and
// the CUDA cores' fp32 rate is the limit. The design keeps every per-pixel
// quantity in registers and the splat rows in shared memory (broadcast
// reads, no bank conflicts), and the early exit skips saturated tiles'
// tails. Speed is later work; the times are in PERF.md.
//
// Numerics: built WITHOUT fast math and with -fmad=false, so every multiply
// and add rounds as PyTorch's elementwise ops do in the plain version
// (`composite_plain`): the `alpha >= 1/255` keep test and the T <= 1e-4
// gate are knife edges. Transmittance is a serial product (the TPU's
// doubling scan and torch.cumprod differ from it only in the last ulp).
// Chunk sums are added to the state at each chunk end and the distortion
// uses the chunk sums with the entry-state cross terms
// (rasterize_pallas.py:926-940); the final T <= 1e-4 flush precedes the
// bg blend (:942-943, :1133).
//
// K2a (`composite_v4_kernel<true>`, `ga_composite_v4_train`) replaces the
// TPU kernel `_v4_fwd_entries_kernel` (rasterize_pallas.py:1280, driven by
// `rasterize_tiled_v4_train`, :1559). It is the same template, so its
// outputs are K1's bit for bit; in addition, before each chunk it executes,
// every pixel stores its entry state (T, Σw, D = Σw·m, D2 = Σw·m²,
// :1297-1300) at row `chunk_off[tile] + chunk index` of the entries buffer
// ((rows, 4, 256) floats, coalesced over the pixels), and the tile records
// how many chunks it executed before its saturation exit. The backward
// kernel (rasterize_v4_bwd.cu) reads only those rows, so it walks exactly
// the chunks the forward ran. The extra cost is 4 KB written per executed
// (tile, chunk): still bound by operations. K1's instantiation compiles
// the stores away.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block
constexpr int kMaxChunk = 256;        // splat rows staged per chunk
constexpr int kRowF4 = 6;             // float4 per splat row
constexpr int kOut = 10;              // output channels

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

template <bool kEntries>
__global__ void __launch_bounds__(kPix)
composite_v4_kernel(const float4* __restrict__ tab,
                    const int* __restrict__ pairs,
                    const int* __restrict__ starts,
                    const int* __restrict__ counts,
                    const float* __restrict__ bg, int tiles_x, int img_h,
                    int img_w, int chunk, float* __restrict__ out,
                    const int* __restrict__ chunk_off,
                    float* __restrict__ entries, int* __restrict__ n_exec) {
  __shared__ float4 rows[kMaxChunk * kRowF4];

  const int t = blockIdx.x;
  const int lid = threadIdx.x;
  const int x = (t % tiles_x) * kTile + lid % kTile;
  const int y = (t / tiles_x) * kTile + lid / kTile;
  const float px = (float)x;
  const float py = (float)y;
  const int start = starts[t];
  const int count = counts[t];

  float T = 1.0f, A = 0.0f, D = 0.0f, D2 = 0.0f, dist = 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  float dexp = 0.0f, dmed = 0.0f;

  int executed = 0;
  for (int c0 = 0; c0 < count; c0 += chunk) {
    // barrier for the previous chunk's readers and the saturation exit
    if (!__syncthreads_or(T > kTEps)) break;
    if constexpr (kEntries) {
      float* e = entries + (size_t)(chunk_off[t] + executed) * (4 * kPix) + lid;
      e[0 * kPix] = T;
      e[1 * kPix] = A;
      e[2 * kPix] = D;
      e[3 * kPix] = D2;
    }
    ++executed;
    const int n = min(chunk, count - c0);
    for (int j = lid; j < n; j += kPix) {
      const float4* src = tab + (size_t)pairs[start + c0 + j] * kRowF4;
#pragma unroll
      for (int q = 0; q < kRowF4; ++q) rows[j * kRowF4 + q] = src[q];
    }
    __syncthreads();

    const float T_in0 = T;    // chunk-entry transmittance
    float tc = 1.0f;          // Π (1 - α) over this chunk so far
    float s_r = 0.0f, s_g = 0.0f, s_b = 0.0f;
    float s_n0 = 0.0f, s_n1 = 0.0f, s_n2 = 0.0f;
    float s_w = 0.0f, s_wz = 0.0f, s_med = 0.0f, s_wm = 0.0f, s_wm2 = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float4 f0 = rows[k * kRowF4 + 0];   // a0 a1 a2 b0
      const float4 f1 = rows[k * kRowF4 + 1];   // b1 b2 c0 c1
      const float4 f2 = rows[k * kRowF4 + 2];   // c2 tz0 tz1 tz2
      const float4 f3 = rows[k * kRowF4 + 3];   // cx cy cz op
      const float p0 = px * f0.x + py * f0.w + f1.z;
      const float p1 = px * f0.y + py * f1.x + f1.w;
      const float p2 = px * f0.z + py * f1.y + f2.x;
      const float safe = fabsf(p2) < 1e-9f ? 1e-9f : p2;
      const float inv = 1.0f / safe;
      const float u = p0 * inv;
      const float v = p1 * inv;
      const float rho3d = u * u + v * v;
      const float dx = px - f3.x;
      const float dy = py - f3.y;
      const float rho2d = kFilterInvSquare * (dx * dx + dy * dy);
      const bool use3d = rho3d <= rho2d;
      const float rho = fminf(rho3d, rho2d);
      float depth = use3d ? u * f2.y + v * f2.z + f2.w : f3.z;
      const float win = fminf(fmaxf((kRhoCut - rho) / kRhoRamp, 0.0f), 1.0f);
      const float gau = expf(-0.5f * rho) * win;
      float alpha = fminf(f3.w * gau, kAlphaMax);
      const bool keep = (alpha >= kAlphaEps) & (depth > kNearCull);
      if (!keep) continue;    // α = 0: factor 1, weight 0, crossing false

      const float t_excl = tc;
      const float t_in = T_in0 * t_excl;
      const float t_incl = tc * (1.0f - alpha);
      tc = t_incl;
      const float t_after = T_in0 * t_incl;
      if ((t_in > 0.5f) & (t_after <= 0.5f)) s_med = s_med + depth;
      if (t_in <= kTEps) continue;
      const float w = T_in0 * alpha * t_excl;

      const float4 f4 = rows[k * kRowF4 + 4];   // r g b nx
      const float4 f5 = rows[k * kRowF4 + 5];   // ny nz
      s_r = s_r + w * f4.x;
      s_g = s_g + w * f4.y;
      s_b = s_b + w * f4.z;
      s_n0 = s_n0 + w * f4.w;
      s_n1 = s_n1 + w * f5.x;
      s_n2 = s_n2 + w * f5.y;
      s_w = s_w + w;
      s_wz = s_wz + w * depth;
      const float zc = fmaxf(depth, kZNear);
      const float m = (kZFar * (zc - kZNear)) / (zc * kZRange);
      const float wm = w * m;
      s_wm = s_wm + wm;
      s_wm2 = s_wm2 + wm * m;
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

  if constexpr (kEntries) {
    if (lid == 0) n_exec[t] = executed;
  }

  const size_t plane = (size_t)img_h * img_w;
  float* o = out + (size_t)y * img_w + x;
  o[0 * plane] = cr + T * bg[0];
  o[1 * plane] = cg + T * bg[1];
  o[2 * plane] = cb + T * bg[2];
  o[3 * plane] = A;
  o[4 * plane] = dexp;
  o[5 * plane] = dmed;
  o[6 * plane] = dist;
  o[7 * plane] = n0;
  o[8 * plane] = n1;
  o[9 * plane] = n2;
}

}  // namespace

// Plain C interface for ctypes. Returns cudaGetLastError() after the launch
// (0 = success); the caller raises on anything else.
extern "C" int ga_composite_v4(const void* tab, const void* pairs,
                               const void* starts, const void* counts,
                               const void* bg, int tiles_x, int tiles_y,
                               int chunk, void* out, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles_x * tiles_y);
  composite_v4_kernel<false><<<grid, kPix, 0, (cudaStream_t)stream>>>(
      (const float4*)tab, (const int*)pairs, (const int*)starts,
      (const int*)counts, (const float*)bg, tiles_x, tiles_y * kTile,
      tiles_x * kTile, chunk, (float*)out, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// K2a: as above, plus the entry states (`entries`, rows indexed by the
// exclusive cumsum `chunk_off` of ceil(counts / chunk)) and the executed
// chunk count of every tile (`n_exec`).
extern "C" int ga_composite_v4_train(const void* tab, const void* pairs,
                                     const void* starts, const void* counts,
                                     const void* bg, int tiles_x, int tiles_y,
                                     int chunk, void* out,
                                     const void* chunk_off, void* entries,
                                     void* n_exec, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles_x * tiles_y);
  composite_v4_kernel<true><<<grid, kPix, 0, (cudaStream_t)stream>>>(
      (const float4*)tab, (const int*)pairs, (const int*)starts,
      (const int*)counts, (const float*)bg, tiles_x, tiles_y * kTile,
      tiles_x * kTile, chunk, (float*)out, (const int*)chunk_off,
      (float*)entries, (int*)n_exec);
  return (int)cudaGetLastError();
}
