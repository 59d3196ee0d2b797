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
// The walk of one pixel over one staged chunk is `composite_rows` in
// composite_v4.cuh, which the segment-fed kernel (rasterize_v4_seg.cu)
// shares.
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

#include "composite_v4.cuh"

namespace {

using namespace ga_v4;

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

  PixelState s;

  int executed = 0;
  for (int c0 = 0; c0 < count; c0 += chunk) {
    // barrier for the previous chunk's readers and the saturation exit
    if (!__syncthreads_or(s.T > kTEps)) break;
    if constexpr (kEntries) {
      float* e = entries + (size_t)(chunk_off[t] + executed) * (4 * kPix) + lid;
      e[0 * kPix] = s.T;
      e[1 * kPix] = s.A;
      e[2 * kPix] = s.D;
      e[3 * kPix] = s.D2;
    }
    ++executed;
    const int n = min(chunk, count - c0);
    for (int j = lid; j < n; j += kPix) {
      const float4* src = tab + (size_t)pairs[start + c0 + j] * kRowF4;
#pragma unroll
      for (int q = 0; q < kRowF4; ++q) rows[j * kRowF4 + q] = src[q];
    }
    __syncthreads();

    composite_rows(rows, n, px, py, s);
  }

  if constexpr (kEntries) {
    if (lid == 0) n_exec[t] = executed;
  }

  const size_t plane = (size_t)img_h * img_w;
  store_pixel(s, bg, out + (size_t)y * img_w + x, plane);
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
