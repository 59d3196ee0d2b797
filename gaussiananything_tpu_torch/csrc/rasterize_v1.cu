// K3, K4, K5 and the stage kernels: the dense-list forward compositors
// (v1, v2, v3) for Hopper (sm_90a).
//
// They replace the TPU kernels of
// gaussiananything_tpu/ops/rasterize_pallas.py
//
//   K3  `_make_kernel(with_aux)`      :59,  driven by `rasterize_tiled_pallas`
//       (:216) and `rasterize_tiled_fused` (:290): one program per tile;
//   K4  `_make_grouped_kernel`        :346, driven by
//       `rasterize_tiled_pallas_grouped` (:455): count-sorted groups of G
//       tiles on a (group, chunk) grid, the state carried between grid steps;
//   K5  `_make_unrolled_kernel`       :555, driven by
//       `rasterize_tiled_pallas_v3` (:659): G consecutive tiles per program;
//
// and `make_kernel(stage)` of tools/pallas_bisect.py:25 (row-major inputs)
// and tools/pallas_bisect2.py:30 (field-major inputs): K4 cut off after
// stage 0 (Σρ), 1 (Σα), 2 (Σw and T) or 3 (rgb, Σw and T), with cut-down
// arithmetic, kept there to bisect a compile stall.
//
// All read DENSE per-tile lists: geom (T, M, 16) = t_x(3) t_y(3) t_w(3)
// t_z(3) centre x, y, centre depth, opacity, and feat (T, M, 8) = rgb(3)
// normal(3) 1 0, rows past a tile's count being the dead splat (opacity 0),
// and write (T, P, 16) = rgb(3) alpha Σw·z median dist normal(3) T 0(5).
// They compute one function (`composite_lists_plain` in ops/rasterize.py)
// up to the dist channel, which only K3 with aux fills. What they compute
// differs from the v4 kernels (rasterize_v4.cu):
//
//   * the ray-splat intersection is the cross product of the two pixel
//     planes, evaluated per pair from t_x, t_y, t_w, with u = p0 / safe
//     (:96-107), not the pre-crossed coefficients and a reciprocal;
//   * transmittance runs in log space: log1p(-α) summed along the chunk,
//     t_excl = exp(cums - log1m), the pairs entered at T_in <= 1e-4 pruned
//     and the sum taken again without them (:124-133);
//   * T is not flushed to 0 at chunk ends, so `T·bg` keeps a residue of up
//     to 1e-4 in the image;
//   * K3's distortion uses prefix forms (:157-164), not chunk sums.
//
// The design here is not the TPU's, where a (P, chunk) block is evaluated
// at once and `_lane_cumsum` is a doubling scan along the lanes. One thread
// owns one pixel and walks the chunk front to back with a running sum; a
// block of P = tile² threads serves a tile (K3), G consecutive tiles one
// after the other (K5), or a group of G tiles chunk by chunk (K4). The
// chunk's rows are staged in shared memory (96 bytes a pair; the dense
// lists make a (tile, chunk) slice contiguous, so the copy is coalesced
// float4 loads of only the rows below the tile's count).
//
//   * The two scans. The first scan's running sum `cums1` decides the
//     pruning, the second's `cums2` gives the weights. Until a pair is
//     pruned the two are the same number, so one walk serves both; after
//     it they part and `cums2` skips the pruned pairs. (log1p(-α) <= 0
//     makes T_in non-increasing, so in practice the pruned set is the
//     chunk's tail.) The expressions are the kernel's own, not a running
//     product: t_in = T·exp(cums1 - log1m), w = T·α·exp(cums2 - log1m),
//     t_after = T·exp(cums2), and T·exp(cums2) at the chunk end; a running
//     product rounds otherwise and flips the median and the prune against
//     the plain version.
//   * The feature sums. K3 and K5 use `jnp.dot(w, feat)` at default
//     precision (:135, :624), which on a TPU rounds its inputs to bf16 and
//     in the CPU interpreter is fp32. Here every sum is fp32, in the
//     kernel's body.
//   * K4's grid. A CUDA grid has no order to carry a state along, and
//     G·P = 4096 threads are more than a block holds. So one block of P
//     threads serves a group, keeps the G tiles' states in shared memory
//     (10 floats a pixel) and loops over the chunks below the group's
//     largest count. The group-wide test of :364 (`c·chunk < gmax` and some
//     pixel of the GROUP above 1e-4) is a block-wide `__syncthreads_or`
//     over every thread's G pixels. Skipping a chunk group-wide, per tile
//     (K3) or not at all (K5) gives the same maps: a skipped chunk's pairs
//     are all masked or pruned, their weights 0, and exp(0) leaves T as it
//     was.
//   * Tiles of 8×8 and 16×16 pixels (64- and 256-thread blocks), chunks of
//     up to 256 rows.
//
// What bounds them on this card: operations, as K1: about 53 fp32
// operations per (pixel, pair) step up to the keep test, a log1p and two or
// three exp for each kept pair, against 96 bytes per (tile, pair) read once.
// Built like K1 without fast math and with -fmad=false (the α >= 1/255,
// T_in > 1e-4 and 0.5-crossing tests are knife edges). The times are in
// PERF.md.

#include <cuda_runtime.h>

#include "composite_v4.cuh"

namespace {

// the compositing constants are the v4 kernels' own
using ga_v4::kAlphaEps;
using ga_v4::kAlphaMax;
using ga_v4::kFilterInvSquare;
using ga_v4::kMaxChunk;          // rows staged per chunk
using ga_v4::kNearCull;
using ga_v4::kRhoCut;
using ga_v4::kRhoRamp;
using ga_v4::kTEps;
using ga_v4::kZFar;
using ga_v4::kZNear;
using ga_v4::kZRange;

constexpr int kGeomF4 = 4;       // float4 per geometry row
constexpr int kFeatF4 = 2;       // float4 per feature row
constexpr int kOutW = 16;        // floats per output pixel
constexpr int kGroupState = 10;  // floats of K4's per-pixel state
constexpr int kStageState = 5;   // floats of a stage kernel's state

// One pixel's state: the output channels, and with aux the running sums of
// the distortion (Σw, Σw·m, Σw·m²).
struct ListState {
  float T = 1.0f;
  float r = 0.0f, g = 0.0f, b = 0.0f, alpha = 0.0f, dexp = 0.0f, dmed = 0.0f;
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  float dist = 0.0f, A = 0.0f, D = 0.0f, D2 = 0.0f;
};

// The cross-product ray-splat form shared by every kernel here: (u, v) of
// pixel (px, py) on the splat whose geometry row starts at `g`.
struct RaySplat {
  float u, v;
};

__device__ __forceinline__ RaySplat intersect(const float4 g0, const float4 g1,
                                              const float4 g2, float px,
                                              float py) {
  // g0 = tx0 tx1 tx2 ty0, g1 = ty1 ty2 tw0 tw1, g2 = tw2 tz0 tz1 tz2
  const float k0 = px * g1.z - g0.x;
  const float k1 = px * g1.w - g0.y;
  const float k2 = px * g2.x - g0.z;
  const float l0 = py * g1.z - g0.w;
  const float l1 = py * g1.w - g1.x;
  const float l2 = py * g2.x - g1.y;
  const float p0 = k1 * l2 - k2 * l1;
  const float p1 = k2 * l0 - k0 * l2;
  const float p2 = k0 * l1 - k1 * l0;
  const float safe = fabsf(p2) < 1e-9f ? 1e-9f : p2;
  return {p0 / safe, p1 / safe};
}

// Composite pixel (px, py) over the first `n` rows of a chunk (the rows
// below the tile's count; later lanes are masked and change nothing) and
// fold the chunk's sums into the state.
template <bool kAux>
__device__ __forceinline__ void composite_list_rows(const float4* geom,
                                                    const float4* feat, int n,
                                                    float px, float py,
                                                    ListState& s) {
  const float T = s.T;    // chunk-entry transmittance
  float cums1 = 0.0f;     // Σ log1p(-α) of the first scan (decides pruning)
  float cums2 = 0.0f;     // the same without the pruned pairs
  bool pruned = false;
  float s_r = 0.0f, s_g = 0.0f, s_b = 0.0f;
  float s_n0 = 0.0f, s_n1 = 0.0f, s_n2 = 0.0f;
  float s_w = 0.0f, s_wz = 0.0f, s_med = 0.0f;
  float s_wm = 0.0f, s_wm2 = 0.0f, s_dist = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float4 g0 = geom[k * kGeomF4 + 0];
    const float4 g1 = geom[k * kGeomF4 + 1];
    const float4 g2 = geom[k * kGeomF4 + 2];
    const float4 g3 = geom[k * kGeomF4 + 3];   // cx cy cz opacity
    const RaySplat rs = intersect(g0, g1, g2, px, py);
    const float u = rs.u;
    const float v = rs.v;
    const float rho3d = u * u + v * v;
    const float z_int = u * g2.y + v * g2.z + g2.w;
    const float dx = px - g3.x;
    const float dy = py - g3.y;
    const float rho2d = kFilterInvSquare * (dx * dx + dy * dy);
    const float rho = fminf(rho3d, rho2d);
    const float depth = rho3d <= rho2d ? z_int : g3.z;
    const float win = fminf(fmaxf((kRhoCut - rho) / kRhoRamp, 0.0f), 1.0f);
    const float gau = expf(-0.5f * rho) * win;
    const float alpha = fminf(g3.w * gau, kAlphaMax);
    const bool keep = (alpha >= kAlphaEps) & (depth > kNearCull);
    if (!keep) continue;    // α = 0: log1p(-0) = 0, weight 0, no crossing

    const float log1m = log1pf(-alpha);
    cums1 = cums1 + log1m;
    const float t_excl1 = expf(cums1 - log1m);
    const float t_in = T * t_excl1;
    if (t_in <= kTEps) {    // pruned: α = 0 in the second scan
      pruned = true;
      continue;
    }
    float t_excl = t_excl1;
    if (!pruned) {
      cums2 = cums1;
    } else {
      cums2 = cums2 + log1m;
      t_excl = expf(cums2 - log1m);
    }
    const float w = T * alpha * t_excl;
    const float t_after = T * expf(cums2);
    if ((t_in > 0.5f) & (t_after <= 0.5f)) s_med = s_med + depth;

    const float4 f0 = feat[k * kFeatF4 + 0];   // r g b nx
    const float4 f1 = feat[k * kFeatF4 + 1];   // ny nz 1 0
    s_r = s_r + w * f0.x;
    s_g = s_g + w * f0.y;
    s_b = s_b + w * f0.z;
    s_n0 = s_n0 + w * f0.w;
    s_n1 = s_n1 + w * f1.x;
    s_n2 = s_n2 + w * f1.y;
    s_w = s_w + w;
    s_wz = s_wz + w * depth;
    if constexpr (kAux) {
      const float zc = fmaxf(depth, kZNear);
      const float m = (kZFar * (zc - kZNear)) / (zc * kZRange);
      const float wm_r = w * m;
      const float wm2_r = wm_r * m;
      s_wm = s_wm + wm_r;       // inclusive prefix sums along the chunk
      s_wm2 = s_wm2 + wm2_r;
      // Σ_{j<i} w_j = T·(1 - t_excl_i); the exclusive prefixes of w·m and
      // w·m² as inclusive minus own, as the scan gives them
      const float a_pre = s.A + T * (1.0f - t_excl);
      const float d_pre = s.D + (s_wm - wm_r);
      const float d2_pre = s.D2 + (s_wm2 - wm2_r);
      s_dist = s_dist + w * (m * m * a_pre + d2_pre - 2.0f * m * d_pre);
    }
  }
  s.r = s.r + s_r;
  s.g = s.g + s_g;
  s.b = s.b + s_b;
  s.n0 = s.n0 + s_n0;
  s.n1 = s.n1 + s_n1;
  s.n2 = s.n2 + s_n2;
  s.alpha = s.alpha + s_w;
  s.dexp = s.dexp + s_wz;
  s.dmed = s.dmed + s_med;
  if constexpr (kAux) {
    s.dist = s.dist + s_dist;
    s.A = s.A + s_w;
    s.D = s.D + s_wm;
    s.D2 = s.D2 + s_wm2;
  }
  s.T = T * expf(cums2);
}

// Copy the first `n` rows of a tile's chunk into shared memory: `rows`
// holds the geometry rows, then from `chunk * kGeomF4` the feature rows.
// The caller puts a barrier before (the previous readers) and after.
__device__ __forceinline__ void stage_rows(float4* rows, const float4* geom,
                                           const float4* feat, size_t row,
                                           int n, int chunk) {
  const float4* gsrc = geom + row * kGeomF4;
  const float4* fsrc = feat + row * kFeatF4;
  for (int i = threadIdx.x; i < n * kGeomF4; i += blockDim.x) rows[i] = gsrc[i];
  float4* frows = rows + chunk * kGeomF4;
  for (int i = threadIdx.x; i < n * kFeatF4; i += blockDim.x)
    frows[i] = fsrc[i];
}

__device__ __forceinline__ void store_list_pixel(const ListState& s,
                                                 float* __restrict__ o) {
  float4* o4 = reinterpret_cast<float4*>(o);
  o4[0] = make_float4(s.r, s.g, s.b, s.alpha);
  o4[1] = make_float4(s.dexp, s.dmed, s.dist, s.n0);
  o4[2] = make_float4(s.n1, s.n2, s.T, 0.0f);
  o4[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One tile, all of its chunks: K3's program, and one of K5's G.
template <bool kAux, bool kSaturationExit>
__device__ __forceinline__ void composite_tile(
    const float4* __restrict__ geom, const float4* __restrict__ feat, int t,
    int count, int max_per_tile, int tiles_x, int tile, int chunk, int row0,
    float4* rows, float* __restrict__ out) {
  const int lid = threadIdx.x;
  const float px = (float)((t % tiles_x) * tile + lid % tile);
  const float py = (float)((t / tiles_x) * tile + lid / tile + row0);
  const int n_chunks = min((count + chunk - 1) / chunk, max_per_tile / chunk);
  ListState s;
  for (int c = 0; c < n_chunks; ++c) {
    // barrier for the previous chunk's readers; K3 also leaves here once no
    // pixel of the tile is above the threshold (T never rises again)
    if (kSaturationExit) {
      if (!__syncthreads_or(s.T > kTEps)) break;
    } else {
      __syncthreads();
    }
    const int n = min(chunk, count - c * chunk);
    stage_rows(rows, geom, feat, (size_t)t * max_per_tile + c * chunk, n,
               chunk);
    __syncthreads();
    composite_list_rows<kAux>(rows, rows + chunk * kGeomF4, n, px, py, s);
  }
  store_list_pixel(s, out + ((size_t)t * blockDim.x + lid) * kOutW);
}

// K3: one block per tile.
template <bool kAux>
__global__ void composite_lists_kernel(const float4* __restrict__ geom,
                                       const float4* __restrict__ feat,
                                       const int* __restrict__ counts,
                                       int max_per_tile, int tiles_x, int tile,
                                       int chunk, int row0,
                                       float* __restrict__ out) {
  extern __shared__ float4 rows[];
  const int t = blockIdx.x;
  composite_tile<kAux, true>(geom, feat, t, counts[t], max_per_tile, tiles_x,
                             tile, chunk, row0, rows, out);
}

// K5: one block per `group` consecutive tiles, one after the other, each
// over its own ceil(count / chunk) chunks; no saturation test (:575-641).
__global__ void composite_lists_unrolled_kernel(
    const float4* __restrict__ geom, const float4* __restrict__ feat,
    const int* __restrict__ counts, int max_per_tile, int tiles_x, int tile,
    int chunk, int group, int row0, float* __restrict__ out) {
  extern __shared__ float4 rows[];
  for (int j = 0; j < group; ++j) {
    const int t = blockIdx.x * group + j;
    composite_tile<false, false>(geom, feat, t, counts[t], max_per_tile,
                                 tiles_x, tile, chunk, row0, rows, out);
  }
}

// K4: one block per count-sorted group of `group` tiles. Shared memory:
// the chunk's rows, then the states, channel-major [group][kGroupState][P]
// so that a warp's pixels lie on consecutive words.
__global__ void composite_lists_grouped_kernel(
    const int* __restrict__ gmax_of, const float4* __restrict__ geom,
    const float4* __restrict__ feat, const float* __restrict__ px_tab,
    const float* __restrict__ py_tab, const float* __restrict__ cnt_f,
    int group, int max_per_tile, int chunk, float* __restrict__ out) {
  extern __shared__ float4 rows[];
  const int P = blockDim.x;
  const int lid = threadIdx.x;
  const int g = blockIdx.x;
  float* state =
      reinterpret_cast<float*>(rows + chunk * (kGeomF4 + kFeatF4));
  auto at = [&](int j, int ch) -> float& {
    return state[(j * kGroupState + ch) * P + lid];
  };
  // tile j's state: T, then the output channels in `ListState`'s order
  auto load_state = [&](int j) {
    ListState s;
    s.T = at(j, 0);
    s.r = at(j, 1);
    s.g = at(j, 2);
    s.b = at(j, 3);
    s.alpha = at(j, 4);
    s.dexp = at(j, 5);
    s.dmed = at(j, 6);
    s.n0 = at(j, 7);
    s.n1 = at(j, 8);
    s.n2 = at(j, 9);
    return s;
  };
  auto store_state = [&](int j, const ListState& s) {
    at(j, 0) = s.T;
    at(j, 1) = s.r;
    at(j, 2) = s.g;
    at(j, 3) = s.b;
    at(j, 4) = s.alpha;
    at(j, 5) = s.dexp;
    at(j, 6) = s.dmed;
    at(j, 7) = s.n0;
    at(j, 8) = s.n1;
    at(j, 9) = s.n2;
  };
  for (int j = 0; j < group; ++j) store_state(j, ListState());
  const int gmax = gmax_of[g];
  const int n_chunks = max_per_tile / chunk;
  for (int c = 0; c < n_chunks && c * chunk < gmax; ++c) {
    // :364: the group runs the chunk while some pixel of ANY of its tiles
    // is above the threshold. Each thread reads only its own state words,
    // so the barrier inside is the only one this test needs; T never rises
    // again, so a group that fails the test once is done.
    bool live = false;
    for (int j = 0; j < group; ++j) live |= at(j, 0) > kTEps;
    if (!__syncthreads_or(live)) break;
    for (int j = 0; j < group; ++j) {
      const int t = g * group + j;
      const int n = min(chunk, (int)cnt_f[t] - c * chunk);
      if (n <= 0) continue;   // the same for the whole block
      __syncthreads();        // the previous tile's readers
      stage_rows(rows, geom, feat, (size_t)t * max_per_tile + c * chunk, n,
                 chunk);
      __syncthreads();
      ListState s = load_state(j);
      composite_list_rows<false>(rows, rows + chunk * kGeomF4, n,
                                 px_tab[(size_t)t * P + lid],
                                 py_tab[(size_t)t * P + lid], s);
      store_state(j, s);
    }
  }
  for (int j = 0; j < group; ++j) {
    const ListState s = load_state(j);
    store_list_pixel(s, out + ((size_t)(g * group + j) * P + lid) * kOutW);
  }
}

// The stage kernels: K4's structure (a block per group, the state in shared
// memory across the chunk loop, the group-wide test) around the cut-down
// arithmetic of `make_kernel(stage)`: ρ = u² + v² alone (no window, no
// depth, no count mask), α = min(op·exp(-ρ/2), 0.99) kept at 1/255, one
// scan, no pruning. State channels: 0 = T, 1..4 = the stage's sums.
// Row-major: geom (T, M, 16), feat (T, M, 8), px/py (T, P), out (T, P, 16).
// Field-major: geom (16, T, M), feat (8, T, M), px/py (1, T, P), out
// (16, T, P).
template <int kStage, bool kFieldMajor>
__global__ void stage_kernel(const int* __restrict__ gmax_of,
                             const float* __restrict__ geom,
                             const float* __restrict__ feat,
                             const float* __restrict__ px_tab,
                             const float* __restrict__ py_tab, int n_tiles,
                             int group, int max_per_tile, int chunk,
                             float* __restrict__ out) {
  extern __shared__ float4 rows4[];
  float* rows = reinterpret_cast<float*>(rows4);    // [chunk][16 + 8]
  const int P = blockDim.x;
  const int lid = threadIdx.x;
  const int g = blockIdx.x;
  float* state = rows + chunk * 24;
  auto at = [&](int j, int ch) -> float& {
    return state[(j * kStageState + ch) * P + lid];
  };
  for (int j = 0; j < group; ++j) {
    at(j, 0) = 1.0f;
    for (int ch = 1; ch < kStageState; ++ch) at(j, ch) = 0.0f;
  }
  const int gmax = gmax_of[g];
  const int n_chunks = max_per_tile / chunk;
  for (int c = 0; c < n_chunks && c * chunk < gmax; ++c) {
    bool live = false;
    for (int j = 0; j < group; ++j) live |= at(j, 0) > kTEps;
    if (!__syncthreads_or(live)) break;
    for (int j = 0; j < group; ++j) {
      const int t = g * group + j;
      __syncthreads();
      // stage the chunk as [k][24] rows whatever the input layout
      for (int i = lid; i < chunk * 24; i += P) {
        int k, f;
        if (kFieldMajor) {
          f = i / chunk;
          k = i % chunk;
        } else {
          k = i / 24;
          f = i % 24;
        }
        const size_t lane = (size_t)c * chunk + k;
        float val;
        if (kFieldMajor) {
          val = f < 16 ? geom[((size_t)f * n_tiles + t) * max_per_tile + lane]
                       : feat[((size_t)(f - 16) * n_tiles + t) * max_per_tile
                              + lane];
        } else {
          val = f < 16 ? geom[((size_t)t * max_per_tile + lane) * 16 + f]
                       : feat[((size_t)t * max_per_tile + lane) * 8 + f - 16];
        }
        rows[k * 24 + f] = val;
      }
      __syncthreads();
      const float px = px_tab[(size_t)t * P + lid];
      const float py = py_tab[(size_t)t * P + lid];
      const float T = at(j, 0);
      float cums = 0.0f;
      float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
      for (int k = 0; k < chunk; ++k) {
        const float4* r4 = reinterpret_cast<const float4*>(rows + k * 24);
        const RaySplat rs = intersect(r4[0], r4[1], r4[2], px, py);
        const float rho = rs.u * rs.u + rs.v * rs.v;
        if (kStage == 0) {
          s1 = s1 + rho;
          continue;
        }
        float alpha = fminf(r4[3].w * expf(-0.5f * rho), kAlphaMax);
        alpha = alpha >= kAlphaEps ? alpha : 0.0f;
        if (kStage == 1) {
          s1 = s1 + alpha;
          continue;
        }
        const float log1m = log1pf(-alpha);
        cums = cums + log1m;
        const float w = T * alpha * expf(cums - log1m);
        if (kStage == 2) {
          s1 = s1 + w;
          continue;
        }
        s1 = s1 + w * r4[4].x;
        s2 = s2 + w * r4[4].y;
        s3 = s3 + w * r4[4].z;
        s4 = s4 + w;
      }
      at(j, 1) = at(j, 1) + s1;
      if (kStage == 3) {
        at(j, 2) = at(j, 2) + s2;
        at(j, 3) = at(j, 3) + s3;
        at(j, 4) = at(j, 4) + s4;
      }
      if (kStage >= 2) at(j, 0) = T * expf(cums);
    }
  }
  for (int j = 0; j < group; ++j) {
    const int t = g * group + j;
    for (int ch = 0; ch < kOutW; ++ch) {
      const float val = ch < kStageState ? at(j, ch) : 0.0f;
      if (kFieldMajor) {
        out[((size_t)ch * n_tiles + t) * P + lid] = val;
      } else {
        out[((size_t)t * P + lid) * kOutW + ch] = val;
      }
    }
  }
}

bool bad_frame(int tile, int chunk, int max_per_tile) {
  return (tile != 8 && tile != 16) || chunk < 1 || chunk > kMaxChunk
         || max_per_tile % chunk != 0;
}

int rows_bytes(int chunk) {
  return chunk * (kGeomF4 + kFeatF4) * (int)sizeof(float4);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int kStage, bool kFieldMajor>
int launch_stage(const void* gmax, const void* geom, const void* feat,
                 const void* px, const void* py, int n_tiles, int group, int P,
                 int max_per_tile, int chunk, void* out, int smem,
                 cudaStream_t stream) {
  cudaError_t err = allow_shared(stage_kernel<kStage, kFieldMajor>, smem);
  if (err != cudaSuccess) return (int)err;
  stage_kernel<kStage, kFieldMajor><<<n_tiles / group, P, smem, stream>>>(
      (const int*)gmax, (const float*)geom, (const float*)feat,
      (const float*)px, (const float*)py, n_tiles, group, max_per_tile, chunk,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interfaces for ctypes. Each returns the CUDA error of the launch
// (0 = success); the caller raises on anything else.

// K3. geom (T, M, 16), feat (T, M, 8), counts (T,) int32, out (T, P, 16).
extern "C" int ga_composite_lists(const void* geom, const void* feat,
                                  const void* counts, int n_tiles,
                                  int max_per_tile, int tiles_x, int tile,
                                  int chunk, int row0, int with_aux, void* out,
                                  void* stream) {
  if (bad_frame(tile, chunk, max_per_tile)) return (int)cudaErrorInvalidValue;
  const int P = tile * tile;
  const int smem = rows_bytes(chunk);
  auto kernel = with_aux ? composite_lists_kernel<true>
                         : composite_lists_kernel<false>;
  kernel<<<n_tiles, P, smem, (cudaStream_t)stream>>>(
      (const float4*)geom, (const float4*)feat, (const int*)counts,
      max_per_tile, tiles_x, tile, chunk, row0, (float*)out);
  return (int)cudaGetLastError();
}

// K5. As K3, `group` consecutive tiles per block; n_tiles % group == 0.
extern "C" int ga_composite_lists_unrolled(const void* geom, const void* feat,
                                           const void* counts, int n_tiles,
                                           int max_per_tile, int tiles_x,
                                           int tile, int chunk, int group,
                                           int row0, void* out, void* stream) {
  if (bad_frame(tile, chunk, max_per_tile) || group < 1 || n_tiles % group)
    return (int)cudaErrorInvalidValue;
  composite_lists_unrolled_kernel<<<n_tiles / group, tile * tile,
                                    rows_bytes(chunk), (cudaStream_t)stream>>>(
      (const float4*)geom, (const float4*)feat, (const int*)counts,
      max_per_tile, tiles_x, tile, chunk, group, row0, (float*)out);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory K4 needs for a group: the caller checks it
// against the card's limit before the launch.
extern "C" int ga_grouped_shared_bytes(int group, int P, int chunk) {
  return rows_bytes(chunk) + group * kGroupState * P * (int)sizeof(float);
}

// K4. Tiles in count-sorted order: gmax (T / group,) int32, geom, feat as
// K3, px, py (T, P) float, cnt (T, 1) float counts, out (T, P, 16).
extern "C" int ga_composite_lists_grouped(const void* gmax, const void* geom,
                                          const void* feat, const void* px,
                                          const void* py, const void* cnt,
                                          int n_tiles, int group, int P,
                                          int max_per_tile, int chunk,
                                          void* out, void* stream) {
  if ((P != 64 && P != 256) || chunk < 1 || chunk > kMaxChunk
      || max_per_tile % chunk != 0 || group < 1 || n_tiles % group)
    return (int)cudaErrorInvalidValue;
  const int smem = ga_grouped_shared_bytes(group, P, chunk);
  cudaError_t err = allow_shared(composite_lists_grouped_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  composite_lists_grouped_kernel<<<n_tiles / group, P, smem,
                                   (cudaStream_t)stream>>>(
      (const int*)gmax, (const float4*)geom, (const float4*)feat,
      (const float*)px, (const float*)py, (const float*)cnt, group,
      max_per_tile, chunk, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int ga_stage_shared_bytes(int group, int P, int chunk) {
  return rows_bytes(chunk) + group * kStageState * P * (int)sizeof(float);
}

// The stage kernels: stage 0..3, row-major (field_major 0) or field-major
// inputs and output, as `stage_kernel` lays them out.
extern "C" int ga_stage(int stage, int field_major, const void* gmax,
                        const void* geom, const void* feat, const void* px,
                        const void* py, int n_tiles, int group, int P,
                        int max_per_tile, int chunk, void* out, void* stream) {
  if (P < 32 || P > 1024 || P % 32 || chunk < 1 || chunk > kMaxChunk
      || max_per_tile % chunk != 0 || group < 1 || n_tiles % group)
    return (int)cudaErrorInvalidValue;
  const int smem = ga_stage_shared_bytes(group, P, chunk);
  cudaStream_t s = (cudaStream_t)stream;
#define GA_STAGE(S, F)                                                     \
  if (stage == S && (field_major != 0) == F)                               \
    return launch_stage<S, F>(gmax, geom, feat, px, py, n_tiles, group, P, \
                              max_per_tile, chunk, out, smem, s);
  GA_STAGE(0, false) GA_STAGE(1, false) GA_STAGE(2, false) GA_STAGE(3, false)
  GA_STAGE(0, true) GA_STAGE(1, true) GA_STAGE(2, true) GA_STAGE(3, true)
#undef GA_STAGE
  return (int)cudaErrorInvalidValue;
}
