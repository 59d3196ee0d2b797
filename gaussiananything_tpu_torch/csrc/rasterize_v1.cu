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
// block of P = tile² threads serves a tile, each pixel's state in registers
// for the whole launch. Every kernel here stages a chunk's rows (96 bytes a
// pair) with 1-D bulk asynchronous copies into a double buffer, chunk c + 1
// landing while the block walks chunk c: the dense lists make a (tile,
// chunk) slice two contiguous runs (geometry, features), and a field-major
// slice 24 runs, one per field.
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
//   * The paired walk. The heaviest tile's walk bounds K3, K4 and K5 (up to
//     2,048 rows a pixel), and a row's geometry is a dependent chain (the
//     cross product, two IEEE divisions, expf). So the walk takes the rows
//     two at a time (kWalkRows): their geometry side by side, then the
//     keep test, the scans, the median crossing and the sums row by row in
//     order, as K1's walk does (composite_v4.cuh). Each row's values are
//     the single-row walk's bit for bit.
//   * The feature sums. K3 and K5 use `jnp.dot(w, feat)` at default
//     precision (:135, :624), which on a TPU rounds its inputs to bf16 and
//     in the CPU interpreter is fp32. Here every sum is fp32, in the
//     kernel's body.
//   * K3's grid. A block per tile, the tiles heaviest first
//     (`tile_order_kernel` of composite_v4.cuh, launched before it in the
//     same call: the heaviest tile's latency bounds the launch), `out` in
//     natural tile order. The block leaves once no pixel of its tile is
//     above 1e-4 (a `__syncthreads_or` per chunk); a chunk copied ahead
//     that it then skips lands before it exits.
//   * K4's grid. A CUDA grid has no order to carry a state along, and
//     G·P = 4096 threads are more than a block holds. The TPU's (group,
//     chunk) grid becomes a thread-block cluster: a block per tile of the
//     count-sorted group, the blocks of a cluster on neighbouring SMs. The
//     group-wide test of :364 (`c·chunk < gmax` and some pixel of the GROUP
//     above 1e-4) is, once per chunk, a `__syncthreads_or` per block into a
//     word of its shared memory, `cluster.sync()` and an OR of the
//     cluster's words read through distributed shared memory. A cluster
//     holds at most 16 blocks; a larger group runs the test per cluster of
//     a divisor of G. Skipping a chunk group-wide, per cluster, per tile
//     (K3) or not at all (K5) gives the same maps: a skipped chunk's pairs
//     are all masked or pruned, their weights 0, and exp(0) leaves T as it
//     was.
//   * K5's grid. The TPU walked G consecutive tiles in one program to
//     spread each grid step's cost; a CUDA block has no such cost. So every
//     tile is a block, heaviest first as K3's. G stays in the contract (it
//     divides T) and forms no cluster: the tiles share nothing.
//   * The stage kernels' grid: K4's, a block per tile and the G tiles of a
//     group one cluster, the group test through distributed shared memory.
//     They have no prune: after T <= 1e-4 a tile's later rows still add
//     T·α·... to its sums. So whether a saturated tile walks on because its
//     group is live shows in the output, and the test cannot be split: a
//     group is ONE cluster (G <= 16, and what the card schedules at that P
//     and chunk), never a per-tile exit or a test per part of the group.
//     Field-major rows land as 24 runs of `chunk` floats, one 1-D bulk copy
//     per field issued by the lanes of one warp (each run 16-byte aligned:
//     chunk a multiple of 4).
//   * Tiles of 8×8 and 16×16 pixels (64- and 256-thread blocks), chunks of
//     up to 256 rows (two buffers then take 48 KB).
//
// What bounds them on this card: operations, as K1: about 53 fp32
// operations per (pixel, pair) step up to the keep test, a log1p and two or
// three exp for each kept pair, against 96 bytes per (tile, pair) read once.
// Their time, though, is the heaviest tile's walk (a stage kernel's: one
// tile's 1,024 rows on one SM), on an SM whose issue slots it shares with
// the other blocks there. Built like K1 without fast math and with
// -fmad=false (the α >= 1/255, T_in > 1e-4 and 0.5-crossing tests are knife
// edges). The times are in PERF.md.

#include <cuda_runtime.h>
#include <cooperative_groups.h>

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
constexpr int kFields = 24;      // floats per row, geometry then features
constexpr int kOutW = 16;        // floats per output pixel
constexpr int kMaxCluster = 16;  // the largest cluster Hopper schedules
constexpr int kWalkRows = 2;     // rows a walk takes side by side

// One pixel's state: the output channels, and with aux the running sums of
// the distortion (Σw, Σw·m, Σw·m²).
struct ListState {
  float T = 1.0f;
  float r = 0.0f, g = 0.0f, b = 0.0f, alpha = 0.0f, dexp = 0.0f, dmed = 0.0f;
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  float dist = 0.0f, A = 0.0f, D = 0.0f, D2 = 0.0f;
};

// The cross-product ray-splat form shared by every kernel here: (u, v) of
// pixel (px, py) on N splats, row j's geometry as g0 = tx0 tx1 tx2 ty0,
// g1 = ty1 ty2 tw0 tw1, g2 = tw2 (tz0 tz1 tz2). Written statement by
// statement across the rows, so their chains (the cross product, two IEEE
// divisions) interleave in one warp's instruction stream.
template <int N>
__device__ __forceinline__ void intersect(const float4 (&g0)[N],
                                          const float4 (&g1)[N],
                                          const float4 (&g2)[N], float px,
                                          float py, float (&u)[N],
                                          float (&v)[N]) {
  float p0[N], p1[N], safe[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float k0 = px * g1[j].z - g0[j].x;
    const float k1 = px * g1[j].w - g0[j].y;
    const float k2 = px * g2[j].x - g0[j].z;
    const float l0 = py * g1[j].z - g0[j].w;
    const float l1 = py * g1[j].w - g1[j].x;
    const float l2 = py * g2[j].x - g1[j].y;
    p0[j] = k1 * l2 - k2 * l1;
    p1[j] = k2 * l0 - k0 * l2;
    const float p2 = k0 * l1 - k1 * l0;
    safe[j] = fabsf(p2) < 1e-9f ? 1e-9f : p2;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    u[j] = p0[j] / safe[j];
    v[j] = p1[j] / safe[j];
  }
}

// Composite pixel (px, py) over the first `n` rows of a chunk (the rows
// below the tile's count; later lanes are masked and change nothing) and
// fold the chunk's sums into the state. Rows kWalkRows at a time: their
// geometry up to the keep test side by side, then row by row in order.
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
  for (int k0 = 0; k0 < n; k0 += kWalkRows) {
    // rows k0 + j; past n the last row is read again and not kept
    int kr[kWalkRows];
    float4 g0[kWalkRows], g1[kWalkRows], g2[kWalkRows], g3[kWalkRows];
#pragma unroll
    for (int j = 0; j < kWalkRows; ++j) {
      kr[j] = min(k0 + j, n - 1);
      g0[j] = geom[kr[j] * kGeomF4 + 0];
      g1[j] = geom[kr[j] * kGeomF4 + 1];
      g2[j] = geom[kr[j] * kGeomF4 + 2];
      g3[j] = geom[kr[j] * kGeomF4 + 3];   // cx cy cz opacity
    }
    float u[kWalkRows], v[kWalkRows];
    intersect<kWalkRows>(g0, g1, g2, px, py, u, v);
    float rho[kWalkRows], win[kWalkRows], depth[kWalkRows];
    float alpha[kWalkRows];
    bool keep[kWalkRows];
#pragma unroll
    for (int j = 0; j < kWalkRows; ++j) {
      const float rho3d = u[j] * u[j] + v[j] * v[j];
      const float z_int = u[j] * g2[j].y + v[j] * g2[j].z + g2[j].w;
      const float dx = px - g3[j].x;
      const float dy = py - g3[j].y;
      const float rho2d = kFilterInvSquare * (dx * dx + dy * dy);
      rho[j] = fminf(rho3d, rho2d);
      depth[j] = rho3d <= rho2d ? z_int : g3[j].z;
      win[j] = fminf(fmaxf((kRhoCut - rho[j]) / kRhoRamp, 0.0f), 1.0f);
    }
#pragma unroll
    for (int j = 0; j < kWalkRows; ++j) {
      const float gau = expf(-0.5f * rho[j]) * win[j];
      alpha[j] = fminf(g3[j].w * gau, kAlphaMax);
      keep[j] = (alpha[j] >= kAlphaEps) & (depth[j] > kNearCull)
                & (k0 + j < n);
    }

#pragma unroll
    for (int j = 0; j < kWalkRows; ++j) {
      if (!keep[j]) continue;   // α = 0: log1p(-0) = 0, weight 0, no crossing
      const float log1m = log1pf(-alpha[j]);
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
      const float w = T * alpha[j] * t_excl;
      const float t_after = T * expf(cums2);
      if ((t_in > 0.5f) & (t_after <= 0.5f)) s_med = s_med + depth[j];

      const float4 f0 = feat[kr[j] * kFeatF4 + 0];   // r g b nx
      const float4 f1 = feat[kr[j] * kFeatF4 + 1];   // ny nz 1 0
      s_r = s_r + w * f0.x;
      s_g = s_g + w * f0.y;
      s_b = s_b + w * f0.z;
      s_n0 = s_n0 + w * f0.w;
      s_n1 = s_n1 + w * f1.x;
      s_n2 = s_n2 + w * f1.y;
      s_w = s_w + w;
      s_wz = s_wz + w * depth[j];
      if constexpr (kAux) {
        const float zc = fmaxf(depth[j], kZNear);
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

__device__ __forceinline__ void store_list_pixel(const ListState& s,
                                                 float* __restrict__ o) {
  float4* o4 = reinterpret_cast<float4*>(o);
  o4[0] = make_float4(s.r, s.g, s.b, s.alpha);
  o4[1] = make_float4(s.dexp, s.dmed, s.dist, s.n0);
  o4[2] = make_float4(s.n1, s.n2, s.T, 0.0f);
  o4[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The 1-D bulk asynchronous copy (the Tensor Memory Accelerator's
// non-tensor form) that feeds every kernel here: one thread asks for a
// contiguous run of bytes (a multiple of 16, both ends 16-byte aligned) to
// be copied from global into this block's shared memory, and the copy
// counts its bytes off the transaction count of an mbarrier in shared
// memory. A thread waits for the barrier's phase `parity` to complete.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The double buffer: two chunks of rows, each the geometry rows, then from
// `chunk * kGeomF4` the feature rows (field-major: 24 runs of `chunk`
// floats), and a barrier for each. Chunk c goes to buffer c & 1; its copy
// is the (c >> 1)-th use of that buffer's barrier.
struct ChunkBuffers {
  float4* rows;                    // dynamic shared memory, 2 chunks
  unsigned long long* full;        // two mbarriers
  int chunk;

  __device__ __forceinline__ const float4* geom(int c) const {
    return rows + (c & 1) * chunk * (kGeomF4 + kFeatF4);
  }
  __device__ __forceinline__ const float4* feat(int c) const {
    return geom(c) + chunk * kGeomF4;
  }
  // thread 0 only: set both barriers up (every thread then passes a barrier
  // before the first copy or wait)
  __device__ __forceinline__ void init() const {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // thread 0 only: start copying the first n rows of chunk c of the tile
  // whose rows start at `row`. Every reader of the buffer's previous chunk
  // (c - 2) has passed a barrier since.
  __device__ __forceinline__ void issue(const float4* __restrict__ g,
                                       const float4* __restrict__ f,
                                       size_t row, int c, int n) const {
    const unsigned gbytes = (unsigned)(n * kGeomF4 * sizeof(float4));
    const unsigned fbytes = (unsigned)(n * kFeatF4 * sizeof(float4));
    unsigned long long* bar = &full[c & 1];
    mbar_expect(bar, gbytes + fbytes);
    float4* dst = const_cast<float4*>(geom(c));
    const size_t src = row + (size_t)c * chunk;
    bulk_copy(dst, g + src * kGeomF4, gbytes, bar);
    bulk_copy(dst + chunk * kGeomF4, f + src * kFeatF4, fbytes, bar);
  }
  // every lane of one warp: as `issue`, chunk c of tile t of field-major
  // tables g (16, T, M) and f (8, T, M), lane i < 24 copying field i's run
  // of `chunk` floats to float i·chunk of the buffer
  __device__ __forceinline__ void issue_fields(const float* __restrict__ g,
                                              const float* __restrict__ f,
                                              int n_tiles, int t, int M,
                                              int c) const {
    const int lane = threadIdx.x & 31;
    const unsigned bytes = (unsigned)(chunk * sizeof(float));
    unsigned long long* bar = &full[c & 1];
    if (lane == 0) mbar_expect(bar, kFields * bytes);
    __syncwarp();
    if (lane < kFields) {
      const float* src = lane < 16
          ? g + ((size_t)lane * n_tiles + t) * M
          : f + ((size_t)(lane - 16) * n_tiles + t) * M;
      float* dst = reinterpret_cast<float*>(const_cast<float4*>(geom(c)));
      bulk_copy(dst + lane * chunk, src + (size_t)c * chunk, bytes, bar);
    }
  }
  __device__ __forceinline__ void wait(int c) const {
    mbar_wait(&full[c & 1], (unsigned)((c >> 1) & 1));
  }
};

// K3: one block per tile, the tiles by descending count (tile_order_kernel,
// launched first), `out` in natural tile order. Chunk c + 1 is copied while
// the block walks chunk c; the block leaves once no pixel of its tile is
// above the threshold.
template <bool kAux>
__global__ void composite_lists_kernel(const float4* __restrict__ geom,
                                       const float4* __restrict__ feat,
                                       const int* __restrict__ counts,
                                       const int* __restrict__ order,
                                       int max_per_tile, int tiles_x, int tile,
                                       int chunk, int row0,
                                       float* __restrict__ out) {
  extern __shared__ float4 rows[];
  __shared__ unsigned long long full[2];
  const ChunkBuffers buf{rows, full, chunk};
  const int lid = threadIdx.x;
  const int t = order[blockIdx.x];
  const int count = counts[t];
  const float px = (float)((t % tiles_x) * tile + lid % tile);
  const float py = (float)((t / tiles_x) * tile + lid / tile + row0);
  const int n_chunks = min((count + chunk - 1) / chunk, max_per_tile / chunk);
  const size_t row = (size_t)t * max_per_tile;
  if (lid == 0) {
    buf.init();
    if (n_chunks > 0) buf.issue(geom, feat, row, 0, min(chunk, count));
  }
  ListState s;
  int c = 0;
  for (; c < n_chunks; ++c) {
    // the barrier for the readers of the buffer chunk c + 1 goes to; the
    // block leaves here once no pixel of the tile is above the threshold
    // (T never rises again)
    if (!__syncthreads_or(s.T > kTEps)) break;
    if (lid == 0 && c + 1 < n_chunks)
      buf.issue(geom, feat, row, c + 1, min(chunk, count - (c + 1) * chunk));
    buf.wait(c);
    composite_list_rows<kAux>(buf.geom(c), buf.feat(c),
                              min(chunk, count - c * chunk), px, py, s);
  }
  // a copy started for a chunk the tile skips lands before exit
  if (lid == 0 && c < n_chunks) buf.wait(c);
  store_list_pixel(s, out + ((size_t)t * blockDim.x + lid) * kOutW);
}

// K5: one block per tile, each over its own ceil(count / chunk) chunks with
// no saturation test (:575-641). Block i takes tile `order[i]`, the tiles by
// descending count (tile_order_kernel, launched first), so the heaviest
// start first; `out` is in natural tile order. Chunk c + 1 is copied while
// the block walks chunk c.
__global__ void composite_lists_unrolled_kernel(
    const float4* __restrict__ geom, const float4* __restrict__ feat,
    const int* __restrict__ counts, const int* __restrict__ order,
    int max_per_tile, int tiles_x, int tile, int chunk, int row0,
    float* __restrict__ out) {
  extern __shared__ float4 rows[];
  __shared__ unsigned long long full[2];
  const ChunkBuffers buf{rows, full, chunk};
  const int lid = threadIdx.x;
  const int t = order[blockIdx.x];
  const int count = counts[t];
  const float px = (float)((t % tiles_x) * tile + lid % tile);
  const float py = (float)((t / tiles_x) * tile + lid / tile + row0);
  const int n_chunks = min((count + chunk - 1) / chunk, max_per_tile / chunk);
  const size_t row = (size_t)t * max_per_tile;
  if (lid == 0) {
    buf.init();
    if (n_chunks > 0) buf.issue(geom, feat, row, 0, min(chunk, count));
  }
  __syncthreads();
  ListState s;
  for (int c = 0; c < n_chunks; ++c) {
    if (lid == 0 && c + 1 < n_chunks)
      buf.issue(geom, feat, row, c + 1, min(chunk, count - (c + 1) * chunk));
    buf.wait(c);
    composite_list_rows<false>(buf.geom(c), buf.feat(c),
                               min(chunk, count - c * chunk), px, py, s);
    __syncthreads();    // the readers of buffer c & 1, before chunk c + 2
  }
  store_list_pixel(s, out + ((size_t)t * blockDim.x + lid) * kOutW);
}

// The group-wide test of K4 and the stage kernels before chunk c: each
// block ORs its threads' `mine` into its word live[c & 1], the cluster
// synchronises, and every warp ORs the cluster's words through distributed
// shared memory. A word is written again two chunks on, after the next
// cluster.sync, which no block passes before every block has read it here;
// the kernel ends with a last cluster.sync, so that no block leaves while
// another may read its words. The block barrier also orders the readers of
// the buffer the next chunk goes to.
__device__ __forceinline__ bool cluster_any(
    const cooperative_groups::cluster_group& cluster, int* live, int c,
    bool mine) {
  const int block = __syncthreads_or(mine);
  if (threadIdx.x == 0) live[c & 1] = block;
  cluster.sync();
  const int lane = threadIdx.x & 31;
  const int vote = lane < (int)cluster.num_blocks()
                       ? *cluster.map_shared_rank(&live[c & 1], lane)
                       : 0;
  return __any_sync(0xffffffffu, vote);
}

// K4: one block of P threads per tile, the tiles in count-sorted order, a
// cluster of consecutive blocks per group (or per part of a group larger
// than the largest cluster the card schedules). Per chunk below the
// group's largest count, :364's group-wide test (`cluster_any`); the
// cluster runs the chunk or, T never rising again, stops. A block whose
// tile has no rows in a chunk still votes. Each block copies only its
// tile's rows below its count, chunk c + 1 while it walks chunk c.
__global__ void composite_lists_grouped_kernel(
    const int* __restrict__ gmax_of, const float4* __restrict__ geom,
    const float4* __restrict__ feat, const float* __restrict__ px_tab,
    const float* __restrict__ py_tab, const float* __restrict__ cnt_f,
    int group, int max_per_tile, int chunk, float* __restrict__ out) {
  extern __shared__ float4 rows[];
  __shared__ unsigned long long full[2];
  __shared__ int live[2];          // this block's votes, by chunk parity
  const ChunkBuffers buf{rows, full, chunk};
  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int P = blockDim.x;
  const int lid = threadIdx.x;
  const int t = blockIdx.x;
  const int count = (int)cnt_f[t];
  const float px = px_tab[(size_t)t * P + lid];
  const float py = py_tab[(size_t)t * P + lid];
  // the chunks c with c·chunk < gmax: the same for the whole cluster
  const int c_end = min(max_per_tile / chunk,
                        (gmax_of[t / group] + chunk - 1) / chunk);
  const int own = min(c_end, (count + chunk - 1) / chunk);  // with rows
  const size_t row = (size_t)t * max_per_tile;
  if (lid == 0) {
    buf.init();
    if (own > 0) buf.issue(geom, feat, row, 0, min(chunk, count));
  }
  ListState s;
  int c = 0;
  for (; c < c_end; ++c) {
    if (!cluster_any(cluster, live, c, s.T > kTEps)) break;
    if (c < own) {
      if (lid == 0 && c + 1 < own)
        buf.issue(geom, feat, row, c + 1,
                  min(chunk, count - (c + 1) * chunk));
      buf.wait(c);
      composite_list_rows<false>(buf.geom(c), buf.feat(c),
                                 min(chunk, count - c * chunk), px, py, s);
    }
  }
  // a copy started for a chunk the cluster did not run lands before exit
  if (lid == 0 && c < own) buf.wait(c);
  store_list_pixel(s, out + ((size_t)t * P + lid) * kOutW);
  cluster.sync();   // no block leaves while another may read its votes
}

// A stage kernel's pixel: T, then the stage's sums (output channels 0..4).
struct StageState {
  float T = 1.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
};

// One chunk of a stage kernel's rows as its copy lands them in a buffer:
// row-major, the geometry rows then the feature rows (K3's layout);
// field-major, 24 runs of `chunk` floats, one per field.
template <bool kFieldMajor>
struct StageRows {
  const float* base;
  int chunk;

  // row k's t_x, t_y, t_w as `intersect` takes them, and its opacity
  __device__ __forceinline__ void geometry(int k, float4& g0, float4& g1,
                                           float4& g2, float& op) const {
    if constexpr (kFieldMajor) {
      const float* f = base + k;
      g0 = make_float4(f[0], f[chunk], f[2 * chunk], f[3 * chunk]);
      g1 = make_float4(f[4 * chunk], f[5 * chunk], f[6 * chunk],
                       f[7 * chunk]);
      g2 = make_float4(f[8 * chunk], 0.0f, 0.0f, 0.0f);   // tw2 alone
      op = f[15 * chunk];
    } else {
      const float4* r = reinterpret_cast<const float4*>(base) + k * kGeomF4;
      g0 = r[0];
      g1 = r[1];
      g2 = r[2];
      op = r[3].w;
    }
  }
  // row k's rgb (features 0..2)
  __device__ __forceinline__ float3 rgb(int k) const {
    if constexpr (kFieldMajor) {
      const float* f = base + 16 * chunk + k;
      return make_float3(f[0], f[chunk], f[2 * chunk]);
    } else {
      const float4 f = reinterpret_cast<const float4*>(
          base)[chunk * kGeomF4 + k * kFeatF4];
      return make_float3(f.x, f.y, f.z);
    }
  }
};

// The cut-down walk of `make_kernel(stage)` over every row of a chunk:
// ρ = u² + v² alone (no window, no depth, no count mask), α = min(op·
// exp(-ρ/2), 0.99) kept at 1/255, one scan, no pruning. Rows kWalkRows at
// a time: their ρ, α and log1p(-α) side by side, the state row by row in
// order.
template <int kStage, bool kFieldMajor>
__device__ __forceinline__ void stage_walk(const StageRows<kFieldMajor>& rows,
                                           float px, float py,
                                           StageState& s) {
  const int n = rows.chunk;
  const float T = s.T;
  float cums = 0.0f;
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kWalkRows) {
    // rows k0 + j below n (the last row read again past it)
    const int rows_here = min(kWalkRows, n - k0);
    float4 g0[kWalkRows], g1[kWalkRows], g2[kWalkRows];
    float op[kWalkRows], u[kWalkRows], v[kWalkRows], rho[kWalkRows];
    float alpha[kWalkRows], log1m[kWalkRows];
#pragma unroll
    for (int j = 0; j < kWalkRows; ++j)
      rows.geometry(min(k0 + j, n - 1), g0[j], g1[j], g2[j], op[j]);
    intersect<kWalkRows>(g0, g1, g2, px, py, u, v);
#pragma unroll
    for (int j = 0; j < kWalkRows; ++j) rho[j] = u[j] * u[j] + v[j] * v[j];
    if constexpr (kStage == 0) {
#pragma unroll
      for (int j = 0; j < kWalkRows; ++j)
        if (j < rows_here) s1 = s1 + rho[j];
      continue;
    }
#pragma unroll
    for (int j = 0; j < kWalkRows; ++j) {
      alpha[j] = fminf(op[j] * expf(-0.5f * rho[j]), kAlphaMax);
      alpha[j] = alpha[j] >= kAlphaEps ? alpha[j] : 0.0f;
    }
    if constexpr (kStage == 1) {
#pragma unroll
      for (int j = 0; j < kWalkRows; ++j)
        if (j < rows_here) s1 = s1 + alpha[j];
      continue;
    }
#pragma unroll
    for (int j = 0; j < kWalkRows; ++j) log1m[j] = log1pf(-alpha[j]);
#pragma unroll
    for (int j = 0; j < kWalkRows; ++j) {
      if (j >= rows_here) break;
      cums = cums + log1m[j];
      const float w = T * alpha[j] * expf(cums - log1m[j]);
      if constexpr (kStage == 2) {
        s1 = s1 + w;
      } else {
        const float3 c = rows.rgb(k0 + j);
        s1 = s1 + w * c.x;
        s2 = s2 + w * c.y;
        s3 = s3 + w * c.z;
        s4 = s4 + w;
      }
    }
  }
  s.s1 = s.s1 + s1;
  if constexpr (kStage == 3) {
    s.s2 = s.s2 + s2;
    s.s3 = s.s3 + s3;
    s.s4 = s.s4 + s4;
  }
  if constexpr (kStage >= 2) s.T = T * expf(cums);
}

// The stage kernels: K4's grid (a block per tile, the `group` tiles of a
// group ONE cluster, each pixel's state in registers) around the cut-down
// arithmetic. Per chunk below the group's gmax, the group test
// (`cluster_any`); the group runs the chunk, every row of it, or stops.
// Row-major: geom (T, M, 16), feat (T, M, 8), px/py (T, P), out (T, P, 16).
// Field-major: geom (16, T, M), feat (8, T, M), px/py (1, T, P), out
// (16, T, P). Output channels 0 = T, 1..4 = the stage's sums, the rest 0.
template <int kStage, bool kFieldMajor>
__global__ void stage_kernel(const int* __restrict__ gmax_of,
                             const float* __restrict__ geom,
                             const float* __restrict__ feat,
                             const float* __restrict__ px_tab,
                             const float* __restrict__ py_tab, int n_tiles,
                             int group, int max_per_tile, int chunk,
                             float* __restrict__ out) {
  extern __shared__ float4 rows[];
  __shared__ unsigned long long full[2];
  __shared__ int live[2];
  const ChunkBuffers buf{rows, full, chunk};
  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int P = blockDim.x;
  const int lid = threadIdx.x;
  const int t = blockIdx.x;
  const float px = px_tab[(size_t)t * P + lid];
  const float py = py_tab[(size_t)t * P + lid];
  const int c_end = min(max_per_tile / chunk,
                        (gmax_of[t / group] + chunk - 1) / chunk);
  auto issue = [&](int c) {
    if constexpr (kFieldMajor) {
      if (lid < 32) buf.issue_fields(geom, feat, n_tiles, t, max_per_tile, c);
    } else {
      if (lid == 0)
        buf.issue(reinterpret_cast<const float4*>(geom),
                  reinterpret_cast<const float4*>(feat),
                  (size_t)t * max_per_tile, c, chunk);
    }
  };
  if (lid == 0) buf.init();
  __syncthreads();
  if (c_end > 0) issue(0);
  StageState s;
  int c = 0;
  for (; c < c_end; ++c) {
    if (!cluster_any(cluster, live, c, s.T > kTEps)) break;
    if (c + 1 < c_end) issue(c + 1);
    buf.wait(c);
    stage_walk<kStage>(
        StageRows<kFieldMajor>{reinterpret_cast<const float*>(buf.geom(c)),
                               chunk}, px, py, s);
  }
  // a copy started for a chunk the group did not run lands before exit
  if (lid == 0 && c < c_end) buf.wait(c);
  if constexpr (kFieldMajor) {
    const float state[5] = {s.T, s.s1, s.s2, s.s3, s.s4};
#pragma unroll
    for (int ch = 0; ch < kOutW; ++ch)
      out[((size_t)ch * n_tiles + t) * P + lid] = ch < 5 ? state[ch] : 0.0f;
  } else {
    float4* o4 = reinterpret_cast<float4*>(out + ((size_t)t * P + lid) * kOutW);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    o4[0] = make_float4(s.T, s.s1, s.s2, s.s3);
    o4[1] = make_float4(s.s4, 0.0f, 0.0f, 0.0f);
    o4[2] = zero;
    o4[3] = zero;
  }
  cluster.sync();   // no block leaves while another may read its votes
}

using StageKernel = void (*)(const int*, const float*, const float*,
                             const float*, const float*, int, int, int, int,
                             float*);

// stage_kernel<stage, field_major>, or nullptr for another stage
StageKernel stage_kernel_of(int stage, bool field_major) {
  static const StageKernel kernels[2][4] = {
      {stage_kernel<0, false>, stage_kernel<1, false>, stage_kernel<2, false>,
       stage_kernel<3, false>},
      {stage_kernel<0, true>, stage_kernel<1, true>, stage_kernel<2, true>,
       stage_kernel<3, true>}};
  return stage >= 0 && stage < 4 ? kernels[field_major][stage] : nullptr;
}

bool bad_frame(int tile, int chunk, int max_per_tile) {
  return (tile != 8 && tile != 16) || chunk < 1 || chunk > kMaxChunk
         || max_per_tile % chunk != 0;
}

// Every kernel's double buffer: two chunks of rows.
int list_buffers_bytes(int chunk) {
  return 2 * chunk * (kGeomF4 + kFeatF4) * (int)sizeof(float4);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// A cluster launch (K4, the stages): `n_tiles` blocks of P threads in
// clusters of `cluster`.
cudaLaunchConfig_t cluster_config(int n_tiles, int P, int smem, int cluster,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles);
  cfg.blockDim = dim3(P);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A cluster kernel may take `smem` bytes of dynamic shared memory and
// clusters of up to 16 blocks (beyond the portable 8).
template <typename Kernel>
cudaError_t prepare_cluster(Kernel kernel, int smem) {
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// How many clusters of `cluster` blocks of `kernel`, P threads each at
// `chunk`, the card holds at once (cudaOccupancyMaxActiveClusters): 0 where
// it schedules no such cluster (above 16 blocks, or a size it refuses); any
// other failure as its CUDA error, negated.
template <typename Kernel>
int max_clusters(Kernel kernel, int cluster, int P, int chunk) {
  if (cluster < 1 || cluster > kMaxCluster) return 0;
  const int smem = list_buffers_bytes(chunk);
  const cudaError_t err = prepare_cluster(kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, P, smem, cluster, nullptr, &attr);
  int n = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (occ == cudaErrorInvalidClusterSize) {
    cudaGetLastError();   // a size the card refuses: none of it fits
    return 0;
  }
  return occ == cudaSuccess ? n : -(int)occ;
}

}  // namespace

// Plain C interfaces for ctypes. Each returns the CUDA error of the launch
// (0 = success); the caller raises on anything else.

// K3. geom (T, M, 16), feat (T, M, 8), counts (T,) int32, out (T, P, 16) in
// natural tile order. `order` (T,) int32 receives the tiles by descending
// count (ties by id), the order the blocks take them in.
extern "C" int ga_composite_lists(const void* geom, const void* feat,
                                  const void* counts, void* order,
                                  int n_tiles, int max_per_tile, int tiles_x,
                                  int tile, int chunk, int row0, int with_aux,
                                  void* out, void* stream) {
  if (bad_frame(tile, chunk, max_per_tile)) return (int)cudaErrorInvalidValue;
  const int smem = list_buffers_bytes(chunk);
  cudaStream_t s = (cudaStream_t)stream;
  auto kernel = with_aux ? composite_lists_kernel<true>
                         : composite_lists_kernel<false>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = ga_v4::launch_tile_order((const int*)counts, nullptr, chunk, n_tiles,
                                 (int*)order, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_tiles, tile * tile, smem, s>>>(
      (const float4*)geom, (const float4*)feat, (const int*)counts,
      (const int*)order, max_per_tile, tiles_x, tile, chunk, row0,
      (float*)out);
  return (int)cudaGetLastError();
}

// K5. geom, feat, counts as K3, out (T, P, 16) in natural tile order, no
// dist. `group` consecutive tiles are the reference's unit (n_tiles % group
// == 0) but no longer share a block. `order` (T,) int32 receives the tiles
// by descending count (ties by id), the order the blocks take them in.
extern "C" int ga_composite_lists_unrolled(const void* geom, const void* feat,
                                           const void* counts, void* order,
                                           int n_tiles, int max_per_tile,
                                           int tiles_x, int tile, int chunk,
                                           int group, int row0, void* out,
                                           void* stream) {
  if (bad_frame(tile, chunk, max_per_tile) || group < 1 || n_tiles % group)
    return (int)cudaErrorInvalidValue;
  const int smem = list_buffers_bytes(chunk);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = allow_shared(composite_lists_unrolled_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = ga_v4::launch_tile_order((const int*)counts, nullptr, chunk, n_tiles,
                                 (int*)order, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  composite_lists_unrolled_kernel<<<n_tiles, tile * tile, smem, s>>>(
      (const float4*)geom, (const float4*)feat, (const int*)counts,
      (const int*)order, max_per_tile, tiles_x, tile, chunk, row0,
      (float*)out);
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` K4 blocks of P threads at `chunk` the card
// holds at once: `max_clusters`.
extern "C" int ga_grouped_clusters(int cluster, int P, int chunk) {
  return max_clusters(composite_lists_grouped_kernel, cluster, P, chunk);
}

// K4. Tiles in count-sorted order: gmax (T / group,) int32, geom, feat as
// K3, px, py (T, P) float, cnt (T, 1) float counts, out (T, P, 16). One
// block per tile in clusters of `cluster` (a divisor of `group`, at most 16,
// that the card schedules: `ga_grouped_clusters`).
extern "C" int ga_composite_lists_grouped(const void* gmax, const void* geom,
                                          const void* feat, const void* px,
                                          const void* py, const void* cnt,
                                          int n_tiles, int group, int cluster,
                                          int P, int max_per_tile, int chunk,
                                          void* out, void* stream) {
  if ((P != 64 && P != 256) || chunk < 1 || chunk > kMaxChunk
      || max_per_tile % chunk != 0 || group < 1 || n_tiles % group
      || cluster < 1 || cluster > kMaxCluster || group % cluster)
    return (int)cudaErrorInvalidValue;
  const int smem = list_buffers_bytes(chunk);
  cudaError_t err = prepare_cluster(composite_lists_grouped_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      n_tiles, P, smem, cluster, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, composite_lists_grouped_kernel, (const int*)gmax,
      (const float4*)geom, (const float4*)feat, (const float*)px,
      (const float*)py, (const float*)cnt, group, max_per_tile, chunk,
      (float*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `group` blocks of the stage kernel (stage,
// field_major), P threads each at `chunk`, the card holds at once:
// `max_clusters`; 0 where it holds none, so the group cannot run.
extern "C" int ga_stage_clusters(int stage, int field_major, int group, int P,
                                 int chunk) {
  const StageKernel kernel = stage_kernel_of(stage, field_major != 0);
  if (!kernel) return -(int)cudaErrorInvalidValue;
  return max_clusters(kernel, group, P, chunk);
}

// The stage kernels: stage 0..3, row-major (field_major 0) or field-major
// inputs and output, as `stage_kernel` lays them out; each group of
// `group` tiles one cluster. Field-major chunks are multiples of 4 rows.
extern "C" int ga_stage(int stage, int field_major, const void* gmax,
                        const void* geom, const void* feat, const void* px,
                        const void* py, int n_tiles, int group, int P,
                        int max_per_tile, int chunk, void* out, void* stream) {
  const StageKernel kernel = stage_kernel_of(stage, field_major != 0);
  if (!kernel || P < 32 || P > 1024 || P % 32 || chunk < 1
      || chunk > kMaxChunk || max_per_tile % chunk != 0 || group < 1
      || group > kMaxCluster || n_tiles % group
      || (field_major && chunk % 4))
    return (int)cudaErrorInvalidValue;
  const int smem = list_buffers_bytes(chunk);
  cudaError_t err = prepare_cluster(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      n_tiles, P, smem, group, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, (const int*)gmax,
                           (const float*)geom, (const float*)feat,
                           (const float*)px, (const float*)py, n_tiles, group,
                           max_per_tile, chunk, (float*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
