// The v4 compositing arithmetic shared by K1 and K2a (rasterize_v4.cu) and K6
// (rasterize_v4_seg.cu): the constants, the per-pixel state and the walk of
// one pixel over one chunk of splat rows in shared memory. One copy, so the
// three kernels' outputs are equal bit for bit on equal rows.
//
// The arithmetic is that of `composite_chunk_grouped`
// (gaussiananything_tpu/ops/rasterize.py:360) as the v4 TPU kernels evaluate
// it (rasterize_pallas.py:850-943). Built without fast math and with
// -fmad=false: see rasterize_v4.cu on the knife edges.
#pragma once

#include <cuda_runtime.h>

namespace ga_v4 {

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
__device__ __forceinline__ void composite_rows(const float4* rows, int n,
                                               float px, float py,
                                               PixelState& s) {
  float &T = s.T, &A = s.A, &D = s.D, &D2 = s.D2, &dist = s.dist;
  float &cr = s.cr, &cg = s.cg, &cb = s.cb;
  float &n0 = s.n0, &n1 = s.n1, &n2 = s.n2, &dexp = s.dexp, &dmed = s.dmed;
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
