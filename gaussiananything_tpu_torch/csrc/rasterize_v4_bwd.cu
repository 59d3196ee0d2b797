// K2b: the 2DGS backward compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_v4_bwd_kernel` of
// gaussiananything_tpu/ops/rasterize_pallas.py:1306 (pallas_call :1704),
// driven there by `rasterize_tiled_v4_train` (:1559). Given the cotangent of
// the forward's (10, H, W) buffer it returns the cotangent of the splat
// table: the analytic adjoints of `_chunk_backward` (rasterize.py:475)
// applied to every (pixel, pair) step the forward executed. It computes what
// the TPU kernel computes, not its block structure:
//
//   * pass A, `composite_v4_bwd_kernel`: one thread block per 16x16 tile, one
//     thread per pixel. The block walks the chunks the forward executed
//     (`n_exec` of K2a) in reverse. For each it stages the chunk's splat rows
//     in shared memory as the forward does, reads each pixel's entry state
//     (T, Σw, D, D2) from K2a's entries buffer, and goes over the chunk
//     front to back twice: once to recompute the chunk sums Σw, Σw·m and
//     Σw·m², which give the chunk-sum cotangents and so the total
//     Q = Σ cw·w; once more to apply the adjoints, where the suffix sum
//     Σ_{i>j} cw_i·w_i of the transmittance chain is Q minus the running
//     prefix, so no step needs T divided back by (1 − α) and nothing per
//     (pixel, slot) is stored. The 13-channel state cotangent stays in
//     registers from chunk to chunk.
//   * the distortion chain runs in double. dist is Σ_ij w_i·w_j·(m_i − m_j)²
//     written as sums of w, w·m and w·m²; its cotangents are three terms
//     the size of ct_dist that cancel to (m_i − m_j)², far under fp32's
//     resolution of them on an opaque surface. In fp32 the residue of that cancellation in Q
//     lands whole on the front slot's bracket and is divided by (1 − α).
//     So the three sums, their cotangents, the weight cotangent's dist part,
//     Q and the prefix are double (a few operations per blending step; the
//     43 of the keep test and the transmittance product stay the forward's
//     fp32, so every knife edge is the forward's).
//   * the pixel-axis reduction: each kept (pixel, slot) contributes to 22
//     sums over the block's 256 pixels. They are reduced in a fixed order:
//     warp shuffles, then the 8 warps' partials through shared memory in warp
//     order. A warp skips a slot none of its lanes keeps (`__any_sync`). One
//     thread per slot then finishes the row (the tz chain of the depth
//     numerator) and writes the pair's 22-field cotangent row EXCLUSIVELY:
//     there is no float atomic anywhere, so the result is bit-reproducible.
//   * pass B, `splat_sum_kernel`: the pair rows are summed into splat rows,
//     one thread per (splat, float4), serially over the splat's pairs in the
//     order of a stable sort of the pair list by splat id (made by the
//     caller). Rows of pairs no tile executed are zero (the caller clears the
//     buffer). This is the adjoint of the forward's gather through `pairs`.
//
// Knife edges are the forward's: `keep` (α >= 1/255, depth > 0.2), `below`
// (T_in <= 1e-4), `crossed` (T = 0.5), `use3d`, the `og < 0.99` clamp gate
// and the chunk-end flush are RECOMPUTED, not stored, with the forward's
// expression order (rasterize_v4.cu), expf, IEEE division and -fmad=false
// (no fast math): a transmittance that differed in the last ulp would flip
// them and move whole 1/255 steps of gradient.
//
// What bounds it on this card: operations. Per executed (pixel, pair) step:
// about 60 fp32 operations in each of the two recompute passes plus about
// 110 for the adjoints, and 110 shuffle-adds per warp for the 22 sums;
// against that the bytes (rows, entries, one 96-byte row per pair written
// and read once, the cotangent maps) are tens of MB a view. The 18 of the 22
// sums that factor as (1, px, py | ct_rgb, ct_normal)ᵀ × (…) are not yet
// exploited; speed is later work, the times are in PERF.md.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block
constexpr int kWarps = kPix / 32;
constexpr int kMaxChunk = 128;        // splat rows staged per chunk
constexpr int kRowF4 = 6;             // float4 per splat row
constexpr int kSums = 22;             // reduced sums per (tile, slot)

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
constexpr float kDmDz = (float)(100.0 * 0.01 / (100.0 - 0.01));

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kPix)
composite_v4_bwd_kernel(const float4* __restrict__ tab,
                        const int* __restrict__ pairs,
                        const int* __restrict__ starts,
                        const int* __restrict__ counts,
                        const float* __restrict__ bg,
                        const int* __restrict__ chunk_off,
                        const float* __restrict__ entries,
                        const int* __restrict__ n_exec,
                        const float* __restrict__ ct_buf, int tiles_x,
                        int img_h, int img_w, int chunk,
                        float4* __restrict__ d_pairs) {
  extern __shared__ float4 smem[];
  float4* rows = smem;                                  // chunk * kRowF4
  float* part = (float*)(smem + chunk * kRowF4);        // kWarps*chunk*kSums

  const int t = blockIdx.x;
  const int lid = threadIdx.x;
  const int lane = lid & 31;
  const int warp = lid >> 5;
  const int x = (t % tiles_x) * kTile + lid % kTile;
  const int y = (t / tiles_x) * kTile + lid / kTile;
  const float px = (float)x;
  const float py = (float)y;
  const int start = starts[t];
  const int count = counts[t];
  const int n_ex = n_exec[t];
  const size_t e_base = (size_t)chunk_off[t];

  // cotangent of the final state; the image was blended over bg in the
  // forward, so the final transmittance receives Σ_c ct_image_c · bg_c
  const size_t plane = (size_t)img_h * img_w;
  const float* ci = ct_buf + (size_t)y * img_w + x;
  const float ct_r = ci[0 * plane];
  const float ct_g = ci[1 * plane];
  const float ct_b = ci[2 * plane];
  float ct_T = ct_r * bg[0] + ct_g * bg[1] + ct_b * bg[2];
  // the carried cotangents of Σw, D and D2 belong to the dist chain: double
  double ct_A = ci[3 * plane];
  const float ct_dexp = ci[4 * plane];
  const float ct_dmed = ci[5 * plane];
  const double ct_dist = ci[6 * plane];
  const float ct_n0 = ci[7 * plane];
  const float ct_n1 = ci[8 * plane];
  const float ct_n2 = ci[9 * plane];
  double ct_D = 0.0, ct_D2 = 0.0;

  for (int c = n_ex - 1; c >= 0; --c) {
    const int c0 = c * chunk;
    const int n = min(chunk, count - c0);
    __syncthreads();    // the previous chunk's readers of rows and part
    for (int j = lid; j < n; j += kPix) {
      const float4* src = tab + (size_t)pairs[start + c0 + j] * kRowF4;
#pragma unroll
      for (int q = 0; q < kRowF4; ++q) rows[j * kRowF4 + q] = src[q];
    }
    __syncthreads();

    const float* e = entries + (e_base + c) * (4 * kPix) + lid;
    const float T_in0 = e[0 * kPix];
    const float A = e[1 * kPix];
    const float D = e[2 * kPix];
    const float D2 = e[3 * kPix];

    // ---- pass 1: the forward's chunk sums (rasterize_v4.cu, verbatim) ----
    float tc = 1.0f;
    double s_w = 0.0, s_wm = 0.0, s_wm2 = 0.0;
    double q_rest = 0.0;      // Σ_j w_j · (the part of cw_j without dist)
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
      const float depth = use3d ? u * f2.y + v * f2.z + f2.w : f3.z;
      const float win = fminf(fmaxf((kRhoCut - rho) / kRhoRamp, 0.0f), 1.0f);
      const float gau = expf(-0.5f * rho) * win;
      const float alpha = fminf(f3.w * gau, kAlphaMax);
      const bool keep = (alpha >= kAlphaEps) & (depth > kNearCull);
      if (!keep) continue;

      const float t_excl = tc;
      const float t_in = T_in0 * t_excl;
      tc = tc * (1.0f - alpha);
      if (t_in <= kTEps) continue;
      const float w = T_in0 * alpha * t_excl;

      const float4 f4 = rows[k * kRowF4 + 4];   // r g b nx
      const float4 f5 = rows[k * kRowF4 + 5];   // ny nz
      const float cw_rest = ct_r * f4.x + ct_g * f4.y + ct_b * f4.z
                            + ct_n0 * f4.w + ct_n1 * f5.x + ct_n2 * f5.y
                            + ct_dexp * depth;
      q_rest = q_rest + (double)cw_rest * (double)w;
      const float zc = fmaxf(depth, kZNear);
      const float m = (kZFar * (zc - kZNear)) / (zc * kZRange);
      const double wm = (double)w * (double)m;
      s_w = s_w + (double)w;
      s_wm = s_wm + wm;
      s_wm2 = s_wm2 + wm * (double)m;
    }

    // chunk-sum cotangents (the dist cross terms use the ENTRY accumulators)
    const double ct_s_w = ct_A + ct_dist * ((double)D2 + s_wm2);
    const double ct_s_wm = ct_D - 2.0 * ct_dist * ((double)D + s_wm);
    const double ct_s_wm2 = ct_D2 + ct_dist * ((double)A + s_w);
    // the flush gate of the chunk end: no cotangent through a flushed T
    const float t_raw = T_in0 * tc;
    const bool flushed = t_raw <= kTEps;
    const float ct_T_out = flushed ? 0.0f : ct_T;
    const float bracket0 = ct_T_out * (flushed ? 0.0f : t_raw);
    // Q = Σ_j cw_j · w_j over the chunk, from the sums above
    const double Q = q_rest + ct_s_w * s_w + ct_s_wm * s_wm
                     + ct_s_wm2 * s_wm2;

    // ---- pass 2: the adjoints, and the 22 sums over the pixels ----------
    float tc2 = 1.0f;
    double incl = 0.0;        // running Σ_{i<=j} cw_i · w_i
    float sum_ct_T = 0.0f;    // Σ_j cw_j · α_j · t_excl_j
    for (int k = 0; k < n; ++k) {
      const float4 f0 = rows[k * kRowF4 + 0];
      const float4 f1 = rows[k * kRowF4 + 1];
      const float4 f2 = rows[k * kRowF4 + 2];
      const float4 f3 = rows[k * kRowF4 + 3];
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
      const float depth = use3d ? u * f2.y + v * f2.z + f2.w : f3.z;
      const float win = fminf(fmaxf((kRhoCut - rho) / kRhoRamp, 0.0f), 1.0f);
      const float expw = expf(-0.5f * rho);
      const float gau = expw * win;
      const float og = f3.w * gau;
      const float alpha = fminf(og, kAlphaMax);
      const bool keep = (alpha >= kAlphaEps) & (depth > kNearCull);

      // a slot that is not kept, or is entered at T <= T_EPS, has weight 0
      // and (its bracket being exactly 0) no cotangent at all
      bool active = false;
      float t_excl = 0.0f;
      bool crossed = false;
      if (keep) {
        t_excl = tc2;
        const float t_in = T_in0 * t_excl;
        tc2 = tc2 * (1.0f - alpha);
        const float t_after = T_in0 * tc2;
        crossed = (t_in > 0.5f) & (t_after <= 0.5f);
        active = t_in > kTEps;
      }
      float* dst = part + ((size_t)warp * chunk + k) * kSums;
      if (!__any_sync(0xffffffffu, active)) {
        if (lane < kSums) dst[lane] = 0.0f;
        continue;
      }

      float s[kSums];
#pragma unroll
      for (int i = 0; i < kSums; ++i) s[i] = 0.0f;
      if (active) {
        const float4 f4 = rows[k * kRowF4 + 4];
        const float4 f5 = rows[k * kRowF4 + 5];
        const float w = T_in0 * alpha * t_excl;
        const float zc = fmaxf(depth, kZNear);
        const float m = (kZFar * (zc - kZNear)) / (zc * kZRange);
        const float cw_rest = ct_r * f4.x + ct_g * f4.y + ct_b * f4.z
                              + ct_n0 * f4.w + ct_n1 * f5.x + ct_n2 * f5.y
                              + ct_dexp * depth;
        const double md = (double)m;
        const double cw_d = (double)cw_rest
                            + (ct_s_w + ct_s_wm * md + ct_s_wm2 * (md * md));
        const float cw = (float)cw_d;
        // alpha / transmittance chain
        incl = incl + cw_d * (double)w;
        const float bracket = (float)(Q - incl) + bracket0;
        const float ct_alpha = cw * T_in0 * t_excl - bracket / (1.0f - alpha);
        sum_ct_T = sum_ct_T + cw * alpha * t_excl;
        // depth / mapped-depth chain
        const float ct_m =
            (float)((double)w * (ct_s_wm + ct_s_wm2 * (2.0 * md)));
        const float dm_dz = depth >= kZNear ? kDmDz / (zc * zc) : 0.0f;
        const float ct_depth = ct_dexp * w + (crossed ? ct_dmed : 0.0f)
                               + ct_m * dm_dz;
        const float ct_depth3 = use3d ? ct_depth : 0.0f;
        const float ct_num = ct_depth3 * inv;
        // opacity / gaussian-weight chain
        const float ct_og = og < kAlphaMax ? ct_alpha : 0.0f;
        const float ct_gau = ct_og * f3.w;
        const float ramp = kRhoCut - rho;
        const float dwin = (ramp > 0.0f) & (ramp < kRhoRamp)
                               ? -1.0f / kRhoRamp : 0.0f;
        const float ct_rho = ct_gau * (expw * dwin - 0.5f * expw * win);
        const float ct_rho3d = use3d ? ct_rho : 0.0f;
        const float ct_rho2d = use3d ? 0.0f : ct_rho;
        const float ct_u = 2.0f * u * ct_rho3d;
        const float ct_v = 2.0f * v * ct_rho3d;
        // projective ray-plane chain
        const float ct_p0 = ct_u * inv;
        const float ct_p1 = ct_v * inv;
        const float ct_inv = ct_u * p0 + ct_v * p1
                             + ct_depth3 * (depth * safe);
        const float ct_safe = -(inv * inv) * ct_inv;
        const float ct_p2 = fabsf(p2) < 1e-9f ? 0.0f : ct_safe;
        // pixel basis (px, py, 1) × (p0, p1, p2, depth numerator)
        s[0] = px * ct_p0;
        s[1] = px * ct_p1;
        s[2] = px * ct_p2;
        s[3] = px * ct_num;
        s[4] = py * ct_p0;
        s[5] = py * ct_p1;
        s[6] = py * ct_p2;
        s[7] = py * ct_num;
        s[8] = ct_p0;
        s[9] = ct_p1;
        s[10] = ct_p2;
        s[11] = ct_num;
        s[12] = -(ct_rho2d * kFilterInvSquare * 2.0f * dx);   // cx
        s[13] = -(ct_rho2d * kFilterInvSquare * 2.0f * dy);   // cy
        s[14] = use3d ? 0.0f : ct_depth;                      // cz
        s[15] = ct_og * gau;                                  // opacity
        s[16] = w * ct_r;
        s[17] = w * ct_g;
        s[18] = w * ct_b;
        s[19] = w * ct_n0;
        s[20] = w * ct_n1;
        s[21] = w * ct_n2;
      }
#pragma unroll
      for (int i = 0; i < kSums; ++i) s[i] = warp_sum(s[i]);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kSums; ++i) dst[i] = s[i];
      }
    }

    // cotangent of this chunk's entry state = of the previous chunk's exit
    ct_T = sum_ct_T + ct_T_out * tc;
    ct_A = ct_A + ct_dist * s_wm2;
    ct_D = ct_D - 2.0 * ct_dist * s_wm;
    ct_D2 = ct_D2 + ct_dist * s_w;

    // ---- the 8 warps' partials, in warp order; one row per pair ---------
    __syncthreads();
    for (int j = lid; j < n; j += kPix) {
      float r[kSums];
#pragma unroll
      for (int i = 0; i < kSums; ++i) r[i] = 0.0f;
      for (int wp = 0; wp < kWarps; ++wp) {
        const float* src = part + ((size_t)wp * chunk + j) * kSums;
#pragma unroll
        for (int i = 0; i < kSums; ++i) r[i] = r[i] + src[i];
      }
      const float4 f0 = rows[j * kRowF4 + 0];   // a0 a1 a2 b0
      const float4 f1 = rows[j * kRowF4 + 1];   // b1 b2 c0 c1
      const float4 f2 = rows[j * kRowF4 + 2];   // c2 tz0 tz1 tz2
      // the depth-numerator column holds [tz·a, tz·b, tz·c]: chain it back
      // into a/b/c (times tz_i) and into tz (times the a/b/c components)
      const float tza = r[3], tzb = r[7], tzc = r[11];
      float4 o0, o1, o2, o3, o4, o5;
      o0.x = r[0] + tza * f2.y;
      o0.y = r[1] + tza * f2.z;
      o0.z = r[2] + tza * f2.w;
      o0.w = r[4] + tzb * f2.y;
      o1.x = r[5] + tzb * f2.z;
      o1.y = r[6] + tzb * f2.w;
      o1.z = r[8] + tzc * f2.y;
      o1.w = r[9] + tzc * f2.z;
      o2.x = r[10] + tzc * f2.w;
      o2.y = tza * f0.x + tzb * f0.w + tzc * f1.z;
      o2.z = tza * f0.y + tzb * f1.x + tzc * f1.w;
      o2.w = tza * f0.z + tzb * f1.y + tzc * f2.x;
      o3 = make_float4(r[12], r[13], r[14], r[15]);
      o4 = make_float4(r[16], r[17], r[18], r[19]);
      o5 = make_float4(r[20], r[21], 0.0f, 0.0f);
      float4* d = d_pairs + (size_t)(start + c0 + j) * kRowF4;
      d[0] = o0;
      d[1] = o1;
      d[2] = o2;
      d[3] = o3;
      d[4] = o4;
      d[5] = o5;
    }
  }
}

// Pass B: splat row = Σ of its pairs' rows, serially in `order` (pair
// positions sorted stably by splat id; `seg[s]..seg[s+1]` is splat s's run).
__global__ void splat_sum_kernel(const float4* __restrict__ d_pairs,
                                 const int* __restrict__ order,
                                 const int* __restrict__ seg, int n_splats,
                                 float4* __restrict__ d_tab) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_splats * kRowF4) return;
  const int s = idx / kRowF4;
  const int q = idx % kRowF4;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int end = seg[s + 1];
  for (int i = seg[s]; i < end; ++i) {
    const float4 v = d_pairs[(size_t)order[i] * kRowF4 + q];
    acc.x = acc.x + v.x;
    acc.y = acc.y + v.y;
    acc.z = acc.z + v.z;
    acc.w = acc.w + v.w;
  }
  d_tab[idx] = acc;
}

}  // namespace

// Plain C interface for ctypes. `d_pairs` ((pairs, 24) floats) must be zero
// on entry. Returns the first CUDA error of the two launches (0 = success).
extern "C" int ga_composite_v4_bwd(
    const void* tab, const void* pairs, const void* starts,
    const void* counts, const void* bg, const void* chunk_off,
    const void* entries, const void* n_exec, const void* ct_buf, int tiles_x,
    int tiles_y, int chunk, void* d_pairs, const void* order, const void* seg,
    int n_splats, void* d_tab, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)chunk * kRowF4 * sizeof(float4)
                       + (size_t)kWarps * chunk * kSums * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      composite_v4_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  composite_v4_bwd_kernel<<<tiles_x * tiles_y, kPix, shmem,
                            (cudaStream_t)stream>>>(
      (const float4*)tab, (const int*)pairs, (const int*)starts,
      (const int*)counts, (const float*)bg, (const int*)chunk_off,
      (const float*)entries, (const int*)n_exec, (const float*)ct_buf,
      tiles_x, tiles_y * kTile, tiles_x * kTile, chunk, (float4*)d_pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = n_splats * kRowF4;
  if (total > 0) {
    splat_sum_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const float4*)d_pairs, (const int*)order, (const int*)seg, n_splats,
        (float4*)d_tab);
  }
  return (int)cudaGetLastError();
}
