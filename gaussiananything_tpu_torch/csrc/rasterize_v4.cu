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
//   * one thread block per 16x16-pixel tile, one thread per pixel, each warp
//     an 8 x 4 pixel rectangle;
//   * the block walks its tile's depth-ordered pair segment (starts/counts
//     of `build_tile_pairs`) in chunks: the threads copy each chunk's splat
//     rows (22 packed fields and the splat's pixel box, 96 bytes = six
//     float4) from the splat-major table into shared memory (sized to the
//     chunk), then every thread composites its pixel over the chunk
//     serially, its warp skipping the rows whose box it misses (the exact
//     warp cull of composite_v4.cuh: 35-45% of the (warp, pair) steps of the
//     trainer's frames need no keep test) and taking the others two at a
//     time, their geometry side by side;
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
// ((rows, 4, 256) floats, coalesced over the pixels), after each chunk
// every warp stores its marks (four 32-bit words: bit k set where some
// lane of the warp blends slot k, `__any_sync` in the walk), and the tile
// records how many chunks it executed before its saturation exit. The
// backward kernel (rasterize_v4_bwd.cu) reads only those rows, so it walks
// exactly the chunks the forward ran, and only their marked slots: the
// walk's keep test runs once per executed step, here. The extra cost is 4 KB written per executed
// (tile, chunk), sector-coalesced (a warp's 8 x 4 pixels are four 32-byte
// runs): still bound by operations. K1's instantiation compiles the stores
// away. K2a's blocks take the tiles heaviest first (`tile_order`, sorted by
// count): the heaviest tile of a training frame runs twice the busy tiles'
// mean, and started last in raster order it set the kernel's end.

#include <cuda_runtime.h>

#include "composite_v4.cuh"

namespace {

using namespace ga_v4;

constexpr int kTrainChunk = 128;                // K2a's largest chunk
constexpr int kMarkWords = kTrainChunk / 32;    // per warp and chunk

template <bool kEntries>
__global__ void __launch_bounds__(kPix)
composite_v4_kernel(const float4* __restrict__ tab,
                    const int* __restrict__ pairs,
                    const int* __restrict__ starts,
                    const int* __restrict__ counts,
                    const float* __restrict__ bg, int tiles_x, int img_h,
                    int img_w, int chunk, int row0, float* __restrict__ out,
                    const int* __restrict__ tile_order,
                    const int* __restrict__ chunk_off,
                    float* __restrict__ entries, int* __restrict__ n_exec,
                    unsigned* __restrict__ marks) {
  extern __shared__ float4 rows[];      // chunk * kRowF4

  const int t = kEntries ? tile_order[blockIdx.x] : blockIdx.x;
  const int lid = threadIdx.x;
  const int tx0 = (t % tiles_x) * kTile;
  const int ty0 = (t / tiles_x) * kTile;
  // a band of a taller image starts at image row row0: the ray and the
  // splat boxes are in the image's rows, the buffer in the band's
  const PixelSlot slot = pixel_slot(lid, tx0, ty0 + row0);
  const int x = tx0 + slot.lx;
  const int y = ty0 + slot.ly;
  const int pix = slot.ly * kTile + slot.lx;
  const float px = (float)x;
  const float py = (float)(y + row0);
  const int start = starts[t];
  const int count = counts[t];

  PixelState s;

  int executed = 0;
  for (int c0 = 0; c0 < count; c0 += chunk) {
    // barrier for the previous chunk's readers and the saturation exit
    if (!__syncthreads_or(s.T > kTEps)) break;
    const size_t row = kEntries ? (size_t)(chunk_off[t] + executed) : 0;
    if constexpr (kEntries) {
      float* e = entries + row * (4 * kPix) + pix;
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

    if constexpr (kEntries) {
      // the warp's words; those past the chunk's rows stay zero
      unsigned* m = marks + (row * (kPix / 32) + (lid >> 5)) * kMarkWords;
      if ((lid & 31) < kMarkWords) m[lid & 31] = 0u;
      __syncwarp();
      composite_rows<true>(rows, n, px, py, slot, s, m);
    } else {
      composite_rows(rows, n, px, py, slot, s);
    }
  }

  if constexpr (kEntries) {
    if (lid == 0) n_exec[t] = executed;
    // the chunks past the saturation exit keep a zero entry state and
    // mark no slot
    const int n_chunks = (count + chunk - 1) / chunk;
    for (int c = executed; c < n_chunks; ++c) {
      const size_t row = (size_t)(chunk_off[t] + c);
      float* e = entries + row * (4 * kPix) + pix;
      e[0 * kPix] = 0.0f;
      e[1 * kPix] = 0.0f;
      e[2 * kPix] = 0.0f;
      e[3 * kPix] = 0.0f;
      if (lid < (kPix / 32) * kMarkWords)
        marks[row * (kPix / 32) * kMarkWords + lid] = 0u;
    }
  }

  const size_t plane = (size_t)img_h * img_w;
  store_pixel(s, bg, out + (size_t)y * img_w + x, plane);
}

}  // namespace

// Plain C interface for ctypes. Returns cudaGetLastError() after the launch
// (0 = success); the caller raises on anything else. `row0` is the image
// row of the buffer's first row (0 for a whole view): a band of tiles_y
// tiles of a taller image, whose table was built against the whole image.
extern "C" int ga_composite_v4(const void* tab, const void* pairs,
                               const void* starts, const void* counts,
                               const void* bg, int tiles_x, int tiles_y,
                               int chunk, int row0, void* out, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)chunk * kRowF4 * sizeof(float4);
  composite_v4_kernel<false><<<tiles_x * tiles_y, kPix, shmem,
                               (cudaStream_t)stream>>>(
      (const float4*)tab, (const int*)pairs, (const int*)starts,
      (const int*)counts, (const float*)bg, tiles_x, tiles_y * kTile,
      tiles_x * kTile, chunk, row0, (float*)out, nullptr, nullptr, nullptr,
      nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The tile order and chunk offsets K2a launches with (tile_order_kernel):
// `order` (n_tiles) int32, `chunk_off` (n_tiles + 1) int32 or null, work by
// `n_exec` (n_tiles) int32 when it is not null. Returns the CUDA error.
extern "C" int ga_tile_order(const void* counts, const void* n_exec,
                             int chunk, int n_tiles, void* order,
                             void* chunk_off, void* stream) {
  if (chunk < 1 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_tile_order((const int*)counts, (const int*)n_exec,
                                chunk, n_tiles, (int*)order, (int*)chunk_off,
                                (cudaStream_t)stream);
}

// K2a: as above, plus the entry states (`entries`, rows indexed by
// `chunk_off`, the exclusive cumsum of ceil(counts / chunk), which it
// writes), the executed chunk count of every tile (`n_exec`) and each
// executed chunk's marks (`marks`, (rows, 8 warps, 4 words) uint32: bit
// k % 32 of word k / 32 set where some lane of the warp blends slot k);
// block i runs tile `tile_order[i]`, the tiles by descending count, which
// it also writes (tile_order_kernel, launched first). chunk <= 128.
extern "C" int ga_composite_v4_train(const void* tab, const void* pairs,
                                     const void* starts, const void* counts,
                                     const void* bg, int tiles_x, int tiles_y,
                                     int chunk, int row0, void* out,
                                     void* tile_order,
                                     void* chunk_off, void* entries,
                                     void* n_exec, void* marks,
                                     void* stream) {
  if (chunk < 1 || chunk > kTrainChunk) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_tile_order(
      (const int*)counts, nullptr, chunk, tiles_x * tiles_y,
      (int*)tile_order, (int*)chunk_off, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = (size_t)chunk * kRowF4 * sizeof(float4);
  composite_v4_kernel<true><<<tiles_x * tiles_y, kPix, shmem,
                              (cudaStream_t)stream>>>(
      (const float4*)tab, (const int*)pairs, (const int*)starts,
      (const int*)counts, (const float*)bg, tiles_x, tiles_y * kTile,
      tiles_x * kTile, chunk, row0, (float*)out, (const int*)tile_order,
      (const int*)chunk_off, (float*)entries, (int*)n_exec,
      (unsigned*)marks);
  return (int)cudaGetLastError();
}
