// K6: the v4 forward compositor fed by asynchronous copies out of ONE
// segment-ordered table, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_v4_kernel(dma=True)` (`dma_kernel`,
// gaussiananything_tpu/ops/rasterize_pallas.py:966, driven there by
// `rasterize_tiled_v4_dma`, :1147). That kernel computes K1's arithmetic
// (:850-943) on per-(tile, chunk) slices that it copies itself, with
// `pltpu.make_async_copy`, out of the table `packed24[:, pairs]` (24, L) at
// offsets `starts[t] + c·chunk`, and masks the lanes at or past
// `counts[t] − c·chunk` (:870-871) instead of reading dummy rows. It never
// compiled on the TPU: Mosaic wants 128-aligned lane offsets and segment
// starts are arbitrary.
//
// Here:
//
//   * `rasterize_tiled_v4_dma` gathers the table once, splat-major: row i
//     of `seg` is the 96-byte row (22 fields padded to six float4) of the
//     splat at pair position i. A field-major (24, L) table at offset starts[t] + c·chunk
//     is only 4-byte aligned, which a 16-byte `cp.async` refuses; with
//     splat-major rows a (tile, chunk) slice is ONE contiguous range of
//     chunk × 96 bytes whose start is always 32-byte aligned;
//   * one block per 16×16 tile, one thread per pixel, as K1. The block keeps
//     two chunk buffers in shared memory: while it composites chunk c out of
//     one, the 16-byte `cp.async.cg` copies of chunk c + 1 are in flight
//     into the other (one commit group per chunk, `cp.async.wait_group 1`
//     before reading). The threads start the copies but no thread touches
//     the data on its way, and there is no index load in front of a row load
//     as in K1: the slice's address is known from starts[t] alone;
//   * only the rows of a slice below the tile's count are copied, and the
//     walk stops there, which is the lane mask of :870-871: the kernel reads
//     nothing outside rows starts[t] .. starts[t] + counts[t] of the table,
//     whatever the table's trailing padding;
//   * the block leaves once no pixel has T > T_EPS, after waiting for the
//     copy it has in flight.
//
// There is no step table and no `steps_per_group` budget, so there are no
// dead steps (the JAX function parks them on a chunk that it may composite a
// second time, :1204).
//
// The arithmetic is K1's own code (composite_v4.cuh), so on equal rows K6's
// buffer equals K1's bit for bit. What bounds it on this card: operations,
// as K1 (about 60 fp32 operations per (pixel, pair) step against 96 bytes
// per (tile, pair) read once). The segment table costs its caller a gather
// of one 96-byte row per pair that K1 does not pay; the times of both are
// in PERF.md.

#include <cuda_runtime.h>

#include "composite_v4.cuh"

namespace {

using namespace ga_v4;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__global__ void __launch_bounds__(kPix)
composite_v4_seg_kernel(const float4* __restrict__ seg,
                        const int* __restrict__ starts,
                        const int* __restrict__ counts,
                        const float* __restrict__ bg, int tiles_x, int img_h,
                        int img_w, int chunk, int row0,
                        float* __restrict__ out) {
  // two buffers of `chunk` rows each
  extern __shared__ float4 rows[];

  const int t = blockIdx.x;
  const int lid = threadIdx.x;
  const int tx0 = (t % tiles_x) * kTile;
  const int ty0 = (t / tiles_x) * kTile;
  // the splat boxes are in the image's rows: the band starts at row0
  const PixelSlot slot = pixel_slot(lid, tx0, ty0 + row0);
  const int x = tx0 + slot.lx;
  const int y = ty0 + slot.ly;
  const float px = (float)x;
  const float py = (float)(y + row0);
  const int count = counts[t];
  const float4* src = seg + (size_t)starts[t] * kRowF4;
  const int slice_f4 = chunk * kRowF4;

  // every thread starts its share of the 16-byte copies of a slice's rows
  // below the tile's count
  auto start_copy = [&](int c0, int buf) {
    const float4* from = src + (size_t)c0 * kRowF4;
    float4* to = rows + buf * slice_f4;
    const int live_f4 = min(chunk, count - c0) * kRowF4;
    for (int i = lid; i < live_f4; i += kPix) cp_async_16(to + i, from + i);
    cp_async_commit();
  };

  PixelState s;

  if (count > 0) start_copy(0, 0);
  int buf = 0;
  for (int c0 = 0; c0 < count; c0 += chunk, buf ^= 1) {
    // the saturation exit; also the barrier after which the other buffer,
    // which the chunk before this one was read from, may be overwritten
    if (!__syncthreads_or(s.T > kTEps)) break;
    const bool more = c0 + chunk < count;
    if (more) {
      start_copy(c0 + chunk, buf ^ 1);
      cp_async_wait<1>();     // this chunk's group; the next stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();          // every thread's copies of this chunk landed

    // lanes at or past the tile's count were not copied and are not walked
    composite_rows(rows + buf * slice_f4, min(chunk, count - c0), px, py,
                   slot, s);
  }
  cp_async_wait<0>();         // a copy in flight at the saturation exit

  const size_t plane = (size_t)img_h * img_w;
  store_pixel(s, bg, out + (size_t)y * img_w + x, plane);
}

}  // namespace

// Plain C interface for ctypes. Returns the CUDA error of the launch (0 =
// success); the caller raises on anything else.
extern "C" int ga_composite_v4_seg(const void* seg, const void* starts,
                                   const void* counts, const void* bg,
                                   int tiles_x, int tiles_y, int chunk,
                                   int row0, void* out, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  const int smem = 2 * chunk * kRowF4 * (int)sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      composite_v4_seg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles_x * tiles_y);
  composite_v4_seg_kernel<<<grid, kPix, smem, (cudaStream_t)stream>>>(
      (const float4*)seg, (const int*)starts, (const int*)counts,
      (const float*)bg, tiles_x, tiles_y * kTile, tiles_x * kTile, chunk, row0,
      (float*)out);
  return (int)cudaGetLastError();
}
