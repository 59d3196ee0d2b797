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
//     thread per pixel, each warp an 8 x 4 pixel rectangle (composite_v4.cuh);
//     blocks take the tiles heaviest first (`tile_order`, sorted by the
//     executed steps), so the longest tiles do not start in the last wave.
//     The block walks the chunks the forward executed (`n_exec` of K2a) in
//     reverse. For each it stages the chunk's splat rows in shared memory,
//     reads each pixel's entry state (T, Σw, D, D2) from K2a's entries
//     buffer and each warp's marks (K2a's record of the slots some lane of
//     the warp blends, one 32-bit word per 32 slots), and goes over the
//     marked slots of the chunk front to back twice. 94% of the executed
//     (pixel, pair) steps blend nothing, and 35-45% are culled for the
//     warp: the keep test of every executed step runs once, in K2a. That is
//     exact: a lane that keeps a slot either blends it (the slot is marked)
//     or is entered at T <= T_EPS and stays dead for the rest of the chunk
//     (its flush gate then holds on the marked slots' product too), so
//     every sum, the transmittance product wherever it is used, and the
//     flush are the full walk's.
//   * pass 1 recomputes the forward's chunk sums Σw, Σw·m, Σw·m² and
//     Σ w·(the part of the weight cotangent without dist), which give the
//     chunk-sum cotangents and so the total Q = Σ cw·w; pass 2 applies the
//     adjoints, where the suffix sum Σ_{i>j} cw_i·w_i of the transmittance
//     chain is Q minus the running prefix, so no step needs T divided back
//     by (1 − α) and nothing per (pixel, slot) is stored. Both take the
//     marked slots two at a time, their geometry (and adjoints) side by
//     side, the transmittance product and the prefix in slot order: the
//     heaviest tile's latency sets the kernel's time (PERF.md).
//   * the distortion chain runs in double. dist is Σ_ij w_i·w_j·(m_i − m_j)²
//     written as sums of w, w·m and w·m²; its cotangents are three terms
//     the size of ct_dist that cancel to (m_i − m_j)², far under fp32's
//     resolution of them on an opaque surface. In fp32 the residue of that
//     cancellation in Q lands whole on the front slot's bracket and is
//     divided by (1 − α). So the three sums, their cotangents, the weight
//     cotangent's dist part, Q and the prefix are double.
//   * the pixel-axis reduction: each blending (pixel, slot) contributes to
//     22 sums over the block's 256 pixels. A warp reduces its 22 by one
//     transposed butterfly (reduce-scatter, 23 shuffles), after which lane
//     `scatter_field(lane)` holds one sum; the 22 lanes store them into a
//     partial buffer of 32 slots. After each marked word a barrier, then
//     the word's marked slots are shared out over the warps: lane i adds
//     the 8 warps' partials of sum i in warp order, the lanes chain the
//     depth numerator's sums back into the coefficients, and the 24 lanes
//     write the pair's row. Two partial buffers alternate, so one barrier
//     per marked word. Every executed slot's row is written (cleared at the
//     chunk's start, where no lane blends), and the rows past the executed
//     chunks too: no float atomic anywhere, the result is bit-reproducible,
//     and the caller clears nothing.
//   * pass B, `splat_sum_kernel`: the pair rows are summed into splat rows,
//     one thread per (splat, float4), serially over the splat's pairs in the
//     order of a stable sort of the pair list by splat id (made by the
//     caller). This is the adjoint of the forward's gather through `pairs`.
//
// Knife edges are the forward's: `keep` (α >= 1/255, depth > 0.2), `below`
// (T_in <= 1e-4), `crossed` (T = 0.5), `use3d`, the `og < 0.99` clamp gate
// and the chunk-end flush are RECOMPUTED, not stored, with the forward's
// expression order (composite_v4.cuh), expf, IEEE division and -fmad=false
// (no fast math): a transmittance that differed in the last ulp would flip
// them and move whole 1/255 steps of gradient.
//
// What bounds it on this card: operations. The function needs the keep test
// (about 43 fp32 operations) once per executed (pixel, pair) step and about
// 140 more for the adjoints and the sums of each step that blends; the bytes
// (rows, entries, the cotangent maps, the table cotangent) are tens of MB a
// view. Shared memory: the chunk's rows (12 KB at chunk 128) and two
// partial buffers (44 KB); two blocks per SM, for the registers of two
// slots' adjoints. The times and the attribution of the time to the passes
// are in PERF.md.

#include <cuda_runtime.h>

#include "composite_v4.cuh"

namespace {

using namespace ga_v4;

constexpr int kWarps = kPix / 32;
constexpr int kBwdChunk = 128;            // splat rows staged per chunk
constexpr int kSlots = 32;                // slots per mask word
constexpr int kWords = kBwdChunk / kSlots;
constexpr int kSums = 22;                 // reduced sums per (tile, slot)
constexpr int kPart = kWarps * kSlots * kSums;  // floats per partial buffer
constexpr float kDmDz = (float)(100.0 * 0.01 / (100.0 - 0.01));

// One step of the transposed butterfly over N values: lanes with bit O set
// keep the upper half, the others the lower half, each adding its partner's
// copy of the half it keeps. After the steps O = 16 .. 1 a lane holds one
// sum over the 32 lanes (or padding), in a fixed order.
template <int N, int O>
struct ReduceScatter {
  static __device__ __forceinline__ float run(float* v, int lane) {
    constexpr int H = (N + 1) / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float lo = v[j];
      const float hi = j + H < N ? v[j + H] : 0.0f;
      const float keep = up ? hi : lo;
      const float send = up ? lo : hi;
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return ReduceScatter<H, O / 2>::run(v, lane);
  }
};

template <int N>
struct ReduceScatter<N, 0> {
  static __device__ __forceinline__ float run(float* v, int) { return v[0]; }
};

// Which of the kSums sums lane `lane` holds after ReduceScatter<kSums, 16>
// (-1: padding).
__device__ __forceinline__ int scatter_field(int lane) {
  int n = kSums, real = kSums, base = 0;
  for (int o = 16; o > 0; o >>= 1) {
    const int h = (n + 1) / 2;
    if (lane & o) {
      base += h;
      real -= h;
    } else {
      real = min(real, h);
    }
    n = h;
  }
  return real > 0 ? base : -1;
}

__global__ void __launch_bounds__(kPix, 2)
composite_v4_bwd_kernel(const float4* __restrict__ tab,
                        const int* __restrict__ pairs,
                        const int* __restrict__ starts,
                        const int* __restrict__ counts,
                        const float* __restrict__ bg,
                        const int* __restrict__ tile_order,
                        const int* __restrict__ chunk_off,
                        const float* __restrict__ entries,
                        const int* __restrict__ n_exec,
                        const unsigned* __restrict__ marks,
                        const float* __restrict__ ct_buf, int tiles_x,
                        int img_h, int img_w, int chunk, int row0,
                        float* __restrict__ d_pairs) {
  extern __shared__ float4 smem[];
  float4* rows = smem;                                  // chunk * kRowF4
  float* part = (float*)(smem + chunk * kRowF4);        // 2 * kPart
  __shared__ unsigned masks[kWarps][kWords];

  const int t = tile_order[blockIdx.x];
  const int lid = threadIdx.x;
  const int lane = lid & 31;
  const int warp = lid >> 5;
  const int tx0 = (t % tiles_x) * kTile;
  const int ty0 = (t / tiles_x) * kTile;
  // a band starts at image row row0 (rasterize_v4.cu): the ray and the
  // cull in the image's rows, ct_buf in the band's
  const PixelSlot slot = pixel_slot(lid, tx0, ty0 + row0);
  const int x = tx0 + slot.lx;
  const int y = ty0 + slot.ly;
  const int pix = slot.ly * kTile + slot.lx;
  const float px = (float)x;
  const float py = (float)(y + row0);
  const int field = scatter_field(lane);
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

  int buf = 0;    // the partial buffer of the next marked word
  for (int c = n_ex - 1; c >= 0; --c) {
    const int c0 = c * chunk;
    const int n = min(chunk, count - c0);
    __syncthreads();    // the previous chunk's readers of rows and masks
    for (int j = lid; j < n; j += kPix) {
      const float4* src = tab + (size_t)pairs[start + c0 + j] * kRowF4;
#pragma unroll
      for (int q = 0; q < kRowF4; ++q) rows[j * kRowF4 + q] = src[q];
    }
    if (lid < kWarps * kWords)
      masks[lid / kWords][lid % kWords] = marks[(e_base + c) * kWarps * kWords
                                                + lid];
    // the chunk's pair rows start at zero; the finish writes the marked ones
    float4* zero = (float4*)(d_pairs + (size_t)(start + c0) * (kRowF4 * 4));
    for (int j = lid; j < n * kRowF4; j += kPix)
      zero[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();

    const float* e = entries + (e_base + c) * (4 * kPix) + pix;
    const float T_in0 = e[0 * kPix];
    const float A = e[1 * kPix];
    const float D = e[2 * kPix];
    const float D2 = e[3 * kPix];

    // ---- pass 1: the forward's chunk sums, over the marked slots --------
    float tc = 1.0f;
    double s_w = 0.0, s_wm = 0.0, s_wm2 = 0.0;
    double q_rest = 0.0;      // Σ_j w_j · (the part of cw_j without dist)
    for (int wi = 0; wi * kSlots < n; ++wi) {
      for (unsigned todo = masks[warp][wi]; todo;) {
        const int ka = wi * kSlots + __ffs(todo) - 1;
        todo &= todo - 1;
        const bool two = todo != 0;
        const int kb = two ? wi * kSlots + __ffs(todo) - 1 : ka;
        todo &= todo - 1;
        const float4* const row[2] = {rows + ka * kRowF4, rows + kb * kRowF4};
        float alpha[2], depth[2];
        bool keep[2];
        step_geometry<2>(row, px, py, alpha, depth, keep);
        keep[1] = keep[1] & two;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!keep[j]) continue;
          const float t_excl = tc;
          const float t_in = T_in0 * t_excl;
          tc = tc * (1.0f - alpha[j]);
          if (t_in <= kTEps) continue;
          const float w = T_in0 * alpha[j] * t_excl;
          const float4 f4 = row[j][4];   // r g b nx
          const float4 f5 = row[j][5];   // ny nz box_x box_y
          const float cw_rest = ct_r * f4.x + ct_g * f4.y + ct_b * f4.z
                                + ct_n0 * f4.w + ct_n1 * f5.x + ct_n2 * f5.y
                                + ct_dexp * depth[j];
          q_rest = q_rest + (double)cw_rest * (double)w;
          const float zc = fmaxf(depth[j], kZNear);
          const float m = (kZFar * (zc - kZNear)) / (zc * kZRange);
          const double wm = (double)w * (double)m;
          s_w = s_w + (double)w;
          s_wm = s_wm + wm;
          s_wm2 = s_wm2 + wm * (double)m;
        }
      }
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

    // ---- pass 2: the adjoints of the marked slots, word by word ---------
    float tc2 = 1.0f;
    double incl = 0.0;        // running Σ_{i<=j} cw_i · w_i
    float sum_ct_T = 0.0f;    // Σ_j cw_j · α_j · t_excl_j
    for (int wi = 0; wi * kSlots < n; ++wi) {
      unsigned any_warp = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) any_warp |= masks[w][wi];
      float* pb = part + buf * kPart;
      if (any_warp) {
        for (unsigned mk = masks[warp][wi]; mk;) {
          // two marked slots at a time: their geometry and adjoints side by
          // side (every lane computes both; what a lane does not blend is
          // selected away), the transmittance product and the prefix in
          // slot order
          int b[2];
          b[0] = __ffs(mk) - 1;
          mk &= mk - 1;
          const bool two = mk != 0;
          b[1] = two ? __ffs(mk) - 1 : b[0];
          mk &= mk - 1;
          const float4* row[2];
          float p0[2], p1[2], p2[2], safe[2], inv[2], u[2], v[2], dx[2],
              dy[2], rho[2], depth[2], win[2], expw[2], gau[2], og[2],
              alpha[2];
          bool use3d[2], keep[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            row[j] = rows + (wi * kSlots + b[j]) * kRowF4;
            const float4 f0 = row[j][0];
            const float4 f1 = row[j][1];
            const float4 f2 = row[j][2];
            p0[j] = px * f0.x + py * f0.w + f1.z;
            p1[j] = px * f0.y + py * f1.x + f1.w;
            p2[j] = px * f0.z + py * f1.y + f2.x;
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            safe[j] = fabsf(p2[j]) < 1e-9f ? 1e-9f : p2[j];
            inv[j] = 1.0f / safe[j];
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float4 f2 = row[j][2];
            const float4 f3 = row[j][3];
            u[j] = p0[j] * inv[j];
            v[j] = p1[j] * inv[j];
            const float rho3d = u[j] * u[j] + v[j] * v[j];
            dx[j] = px - f3.x;
            dy[j] = py - f3.y;
            const float rho2d =
                kFilterInvSquare * (dx[j] * dx[j] + dy[j] * dy[j]);
            use3d[j] = rho3d <= rho2d;
            rho[j] = fminf(rho3d, rho2d);
            depth[j] = use3d[j] ? u[j] * f2.y + v[j] * f2.z + f2.w : f3.z;
            win[j] = fminf(fmaxf((kRhoCut - rho[j]) / kRhoRamp, 0.0f), 1.0f);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            expw[j] = expf(-0.5f * rho[j]);
            gau[j] = expw[j] * win[j];
            og[j] = row[j][3].w * gau[j];
            alpha[j] = fminf(og[j], kAlphaMax);
            keep[j] = (alpha[j] >= kAlphaEps) & (depth[j] > kNearCull);
          }
          keep[1] = keep[1] & two;

          // a slot that is not kept, or is entered at T <= T_EPS, has
          // weight 0 and (its bracket being exactly 0) no cotangent at all
          float t_excl[2];
          bool crossed[2], active[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            t_excl[j] = 0.0f;
            crossed[j] = false;
            active[j] = false;
            if (keep[j]) {
              t_excl[j] = tc2;
              const float t_in = T_in0 * t_excl[j];
              tc2 = tc2 * (1.0f - alpha[j]);
              const float t_after = T_in0 * tc2;
              crossed[j] = (t_in > 0.5f) & (t_after <= 0.5f);
              active[j] = t_in > kTEps;
            }
          }

          float w[2], zc[2], cw[2];
          double md[2], cw_d[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float4 f4 = row[j][4];
            const float4 f5 = row[j][5];
            w[j] = T_in0 * alpha[j] * t_excl[j];
            zc[j] = fmaxf(depth[j], kZNear);
            const float m = (kZFar * (zc[j] - kZNear)) / (zc[j] * kZRange);
            const float cw_rest = ct_r * f4.x + ct_g * f4.y + ct_b * f4.z
                                  + ct_n0 * f4.w + ct_n1 * f5.x
                                  + ct_n2 * f5.y + ct_dexp * depth[j];
            md[j] = (double)m;
            cw_d[j] = (double)cw_rest
                + (ct_s_w + ct_s_wm * md[j] + ct_s_wm2 * (md[j] * md[j]));
            cw[j] = (float)cw_d[j];
          }
          // alpha / transmittance chain: the prefix in slot order
          float bracket[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (active[j]) incl = incl + cw_d[j] * (double)w[j];
            bracket[j] = (float)(Q - incl) + bracket0;
            if (active[j]) sum_ct_T = sum_ct_T + cw[j] * alpha[j] * t_excl[j];
          }

          float s[2][kSums];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float4 f3 = row[j][3];
            const float ct_alpha =
                cw[j] * T_in0 * t_excl[j] - bracket[j] / (1.0f - alpha[j]);
            // depth / mapped-depth chain
            const float ct_m =
                (float)((double)w[j] * (ct_s_wm + ct_s_wm2 * (2.0 * md[j])));
            const float dm_dz =
                depth[j] >= kZNear ? kDmDz / (zc[j] * zc[j]) : 0.0f;
            const float ct_depth = ct_dexp * w[j]
                                   + (crossed[j] ? ct_dmed : 0.0f)
                                   + ct_m * dm_dz;
            const float ct_depth3 = use3d[j] ? ct_depth : 0.0f;
            const float ct_num = ct_depth3 * inv[j];
            // opacity / gaussian-weight chain
            const float ct_og = og[j] < kAlphaMax ? ct_alpha : 0.0f;
            const float ct_gau = ct_og * f3.w;
            const float ramp = kRhoCut - rho[j];
            const float dwin = (ramp > 0.0f) & (ramp < kRhoRamp)
                                   ? -1.0f / kRhoRamp : 0.0f;
            const float ct_rho =
                ct_gau * (expw[j] * dwin - 0.5f * expw[j] * win[j]);
            const float ct_rho3d = use3d[j] ? ct_rho : 0.0f;
            const float ct_rho2d = use3d[j] ? 0.0f : ct_rho;
            const float ct_u = 2.0f * u[j] * ct_rho3d;
            const float ct_v = 2.0f * v[j] * ct_rho3d;
            // projective ray-plane chain
            const float ct_p0 = ct_u * inv[j];
            const float ct_p1 = ct_v * inv[j];
            const float ct_inv = ct_u * p0[j] + ct_v * p1[j]
                                 + ct_depth3 * (depth[j] * safe[j]);
            const float ct_safe = -(inv[j] * inv[j]) * ct_inv;
            const float ct_p2 = fabsf(p2[j]) < 1e-9f ? 0.0f : ct_safe;
            // pixel basis (px, py, 1) × (p0, p1, p2, depth numerator)
            const bool on = active[j];
            s[j][0] = on ? px * ct_p0 : 0.0f;
            s[j][1] = on ? px * ct_p1 : 0.0f;
            s[j][2] = on ? px * ct_p2 : 0.0f;
            s[j][3] = on ? px * ct_num : 0.0f;
            s[j][4] = on ? py * ct_p0 : 0.0f;
            s[j][5] = on ? py * ct_p1 : 0.0f;
            s[j][6] = on ? py * ct_p2 : 0.0f;
            s[j][7] = on ? py * ct_num : 0.0f;
            s[j][8] = on ? ct_p0 : 0.0f;
            s[j][9] = on ? ct_p1 : 0.0f;
            s[j][10] = on ? ct_p2 : 0.0f;
            s[j][11] = on ? ct_num : 0.0f;
            s[j][12] = on ? -(ct_rho2d * kFilterInvSquare * 2.0f * dx[j])
                          : 0.0f;                                     // cx
            s[j][13] = on ? -(ct_rho2d * kFilterInvSquare * 2.0f * dy[j])
                          : 0.0f;                                     // cy
            s[j][14] = on && !use3d[j] ? ct_depth : 0.0f;           // cz
            s[j][15] = on ? ct_og * gau[j] : 0.0f;                  // opacity
            s[j][16] = on ? w[j] * ct_r : 0.0f;
            s[j][17] = on ? w[j] * ct_g : 0.0f;
            s[j][18] = on ? w[j] * ct_b : 0.0f;
            s[j][19] = on ? w[j] * ct_n0 : 0.0f;
            s[j][20] = on ? w[j] * ct_n1 : 0.0f;
            s[j][21] = on ? w[j] * ct_n2 : 0.0f;
          }
          const float sum0 = ReduceScatter<kSums, 16>::run(s[0], lane);
          const float sum1 = ReduceScatter<kSums, 16>::run(s[1], lane);
          if (field >= 0) {
            pb[(warp * kSlots + b[0]) * kSums + field] = sum0;
            if (two) pb[(warp * kSlots + b[1]) * kSums + field] = sum1;
          }
        }
        __syncthreads();      // every warp's partials of this word
      }

      if (any_warp) {
        // the pair rows of the word's marked slots, the i-th of them
        // finished by warp i % 8: lane j adds the 8 warps' partials of sum
        // j in warp order, the lanes chain the depth numerator's sums back
        // into the coefficients, and the 24 lanes write the pair's row
        unsigned who_of = 0;  // lane b: the warps that marked slot b
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          who_of |= ((masks[w][wi] >> lane) & 1u) << w;
        int i = 0;
        for (unsigned todo = any_warp; todo; todo &= todo - 1, ++i) {
          if (i % kWarps != warp) continue;
          const int b = __ffs(todo) - 1;
          const int k = wi * kSlots + b;
          const unsigned who = __shfl_sync(0xffffffffu, who_of, b);
          // the 8 loads side by side, then the sum in warp order (an
          // unmarked warp adds +0, which changes no sum)
          float r = 0.0f;
          if (lane < kSums) {
            float p[kWarps];
#pragma unroll
            for (int w = 0; w < kWarps; ++w)
              p[w] = (who >> w) & 1u ? pb[(w * kSlots + b) * kSums + lane]
                                     : 0.0f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) r = r + p[w];
          }
          // the depth-numerator column holds [tz·a, tz·b, tz·c]: chain it
          // back into a/b/c (times tz_i) and into tz (times a/b/c)
          const float tza = __shfl_sync(0xffffffffu, r, 3);
          const float tzb = __shfl_sync(0xffffffffu, r, 7);
          const float tzc = __shfl_sync(0xffffffffu, r, 11);
          const int src = lane < 9 ? (lane / 3) * 4 + lane % 3 : lane;
          const float R = __shfl_sync(0xffffffffu, r, src);
          // a0 a1 a2 b0 b1 b2 c0 c1 c2 tz0 tz1 tz2
          const float* row = (const float*)(rows + k * kRowF4);
          float o = 0.0f;
          if (lane < 9) {
            const float tzk = lane < 3 ? tza : (lane < 6 ? tzb : tzc);
            o = R + tzk * row[9 + lane % 3];
          } else if (lane < 12) {
            const int j = lane - 9;
            o = tza * row[j] + tzb * row[3 + j] + tzc * row[6 + j];
          } else if (lane < kSums) {
            o = R;
          }
          if (lane < kRowF4 * 4)
            d_pairs[(size_t)(start + c0 + k) * (kRowF4 * 4) + lane] = o;
        }
        buf ^= 1;
      }
    }

    // cotangent of this chunk's entry state = of the previous chunk's exit
    ct_T = sum_ct_T + ct_T_out * tc;
    ct_A = ct_A + ct_dist * s_wm2;
    ct_D = ct_D - 2.0 * ct_dist * s_wm;
    ct_D2 = ct_D2 + ct_dist * s_w;
  }

  // the pairs past the executed chunks carry no cotangent
  const int done = min(count, n_ex * chunk);
  float* rest = d_pairs + (size_t)(start + done) * (kRowF4 * 4);
  for (int i = lid; i < (count - done) * kRowF4 * 4; i += kPix) rest[i] = 0.0f;
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

// Plain C interface for ctypes. Block i of pass A runs tile `tile_order[i]`
// ((tiles) int32 scratch: the tiles by descending executed steps
// min(counts, n_exec · chunk), written by tile_order_kernel first). Every
// row of `d_pairs` ((pairs, 24) floats) that a tile reads is written; the
// others are neither written nor read. `row0` is the image row of ct_buf's
// first row, as for ga_composite_v4. Returns the first CUDA error of the
// launches (0 = success).
extern "C" int ga_composite_v4_bwd(
    const void* tab, const void* pairs, const void* starts,
    const void* counts, const void* bg, void* tile_order,
    const void* chunk_off, const void* entries, const void* n_exec,
    const void* marks, const void* ct_buf, int tiles_x, int tiles_y,
    int chunk, int row0, void* d_pairs,
    const void* order, const void* seg, int n_splats, void* d_tab,
    void* stream) {
  if (chunk < 1 || chunk > kBwdChunk) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_tile_order(
      (const int*)counts, (const int*)n_exec, chunk, tiles_x * tiles_y,
      (int*)tile_order, nullptr, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = (size_t)chunk * kRowF4 * sizeof(float4)
                       + 2 * (size_t)kPart * sizeof(float);
  err = cudaFuncSetAttribute(
      composite_v4_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  composite_v4_bwd_kernel<<<tiles_x * tiles_y, kPix, shmem,
                            (cudaStream_t)stream>>>(
      (const float4*)tab, (const int*)pairs, (const int*)starts,
      (const int*)counts, (const float*)bg, (const int*)tile_order,
      (const int*)chunk_off, (const float*)entries, (const int*)n_exec,
      (const unsigned*)marks, (const float*)ct_buf, tiles_x,
      tiles_y * kTile, tiles_x * kTile, chunk, row0, (float*)d_pairs);
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
