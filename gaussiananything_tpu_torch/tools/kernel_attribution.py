"""Where the kernels' time goes on the card: K2a's and K2b's time split
into the phases of their design, and the block timelines of the list
kernels K3, K4, K5 and of the stage kernels, from instrumented copies of
their sources.

    python -m gaussiananything_tpu_torch.tools.kernel_attribution \\
        [--root DIR] [--cases "train 512" ... bench defaults stages] \\
        [--reps 20] [--out FILE] [--save FILE] [--against FILE]

`--root` names the checkout whose kernels are measured (default: this
one); another checkout's package, e.g. an earlier commit unpacked with
`git archive`, measures that commit's kernels through its own wrappers and
its own `ops/kernel_lib` (a checkout from before that module is measured
with its own copy of this tool). Each copy is built from that checkout's
`csrc/` into a temporary directory and thrown away; the committed sources
carry no instrumentation.

Two kinds of copy:

  * stamps: thread 0 of every block reads %globaltimer at the block's start
    and end, which gives the tail (the kernel's end minus the median
    block's end), and the SM clock at every barrier, adding the cycles
    since the barrier before to the phase that ends there. Lane 0 of each
    warp adds its own cycles in the parts no barrier separates (K2b's two
    passes and its pixel reduction). Shares of a block's cycles, summed
    over blocks.
  * cuts: a copy with one part removed, timed with CUDA events beside the
    whole kernel. Its results are wrong; only its time is read.

Every time is the median of `--reps` wrapper calls between CUDA events, at
the trainer's frames (the 73,728-splat sphere's LoD ladder, `max_per_tile`
1024, chunk 128) and the timing tool's (`max_per_tile` 2048); K1 and K6,
which share K2a's walk, are timed whole beside them at the serving path's
chunk 256.

The list cases ("bench": 512², tile 16, `max_per_tile` 2048, chunk 256;
"defaults": the defaults of `rasterize_tiled_v2`/`_v3`, tile 8,
`max_per_tile` 512, chunk 128) time K3 (with and without aux), K4 and K5
whole, check that K4's and K5's outputs equal K3's (aux off) bit for bit
and that two runs are bit-equal; the case "stages" times the eight stage
instantiations at the stage tool's shape. Beside each median of single
calls ("ms") stands "batched ms": `--reps` calls back to back between two
events, over their count, the card's time without the host's way to each
launch. Each of those kernels is read
through a stamped copy: every block's start and end (%globaltimer) and SM
(%smid), which give the span, the tail after the median block, the longest
block and its start, and the number of SMs the blocks ran on; beside them
the blocks (and clusters) per SM that
`cudaOccupancyMaxActiveBlocksPerMultiprocessor` (and
`cudaOccupancyMaxActiveClusters`) give for the launch (of the stamped
copy, whose stamps may cost registers); the stamped K3 and stage copies
also split thread 0's SM cycles into the vote (the saturation or group
test), the feed (issuing a copy and waiting for its chunk) and the walk,
and a cut copy with products in place of the ray-splat form's two
divisions times K3 and the stage kernels without them; copies that walk
one or four rows side by side in place of two time every kernel with the
same results. `--save` writes
K3's and the stage kernels' outputs to a file, `--against` compares this
run's with such a file: K3 bit for bit, the stages within atol 2e-5 / rtol
1e-4 (a parent checkout through `--root --save`, then this one).

One JSON line per (kernel, case), the card's name and power limit first.
Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

# name: (splats, image size, max_per_tile); chunk 128, the trainer's
CASES = {"train 128": (768, 128, 1024), "train 256": (6144, 256, 1024),
         "train 384": (24576, 384, 1024), "train 512": (73728, 512, 1024),
         "tools 512": (73728, 512, 2048)}
# name: (splats, image size, tile, max_per_tile, chunk, K4's group, K5's
# group), as `chip_smoke.py` runs the list kernels
LIST_CASES = {"bench": (73728, 512, 16, 2048, 256, 16, 16),
              "defaults": (73728, 512, 8, 512, 128, 16, 8)}
# the stage kernels at the stage tool's shape (8 groups of 8 tiles of 256
# pixels, 4 chunks of 256 rows), its seeded inputs
STAGE_CASES = ("stages",)
CHUNK = 128
FWD_CHUNK = 256     # the serving path's chunk, where K1 and K6 are timed
MAX_BLOCKS = 16384

PRELUDE = r"""
#define GA_MAX_BLOCKS %d
__device__ unsigned long long ga_acc[16];
__device__ unsigned long long ga_blk[2 * GA_MAX_BLOCKS];
__device__ unsigned ga_sm[GA_MAX_BLOCKS];
__device__ __forceinline__ unsigned long long ga_gt() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned ga_smid() {
  unsigned r;
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(r));
  return r;
}
#define GA_BEGIN() int ga_ph = 0; long long ga_c = clock64(); \
  if (threadIdx.x == 0) { \
    ga_blk[blockIdx.x] = ga_gt(); ga_sm[blockIdx.x] = ga_smid(); }
#define GA_MARK(next) do { const long long ga_n = clock64(); \
  if (threadIdx.x == 0) \
    atomicAdd(&ga_acc[ga_ph], (unsigned long long)(ga_n - ga_c)); \
  ga_ph = (next); ga_c = ga_n; } while (0)
#define GA_WARP(id, v) do { if ((threadIdx.x & 31) == 0) \
  atomicAdd(&ga_acc[id], (unsigned long long)(v)); } while (0)
#define GA_END() do { __syncthreads(); GA_MARK(0); \
  if (threadIdx.x == 0) ga_blk[GA_MAX_BLOCKS + blockIdx.x] = ga_gt(); \
  } while (0)
extern "C" int ga_stamps(void* acc, void* blk, void* sm, int clear) {
  static unsigned long long zero[2 * GA_MAX_BLOCKS];
  if (clear) {
    cudaMemcpyToSymbol(ga_acc, zero, sizeof(ga_acc));
    cudaMemcpyToSymbol(ga_blk, zero, sizeof(ga_blk));
    cudaMemcpyToSymbol(ga_sm, zero, sizeof(ga_sm));
  } else {
    cudaMemcpyFromSymbol(acc, ga_acc, sizeof(ga_acc));
    cudaMemcpyFromSymbol(blk, ga_blk, sizeof(ga_blk));
    cudaMemcpyFromSymbol(sm, ga_sm, sizeof(ga_sm));
  }
  return (int)cudaDeviceSynchronize();
}
""" % MAX_BLOCKS

INCLUDE = "#include <cuda_runtime.h>\n"

# Each design's copies: {copy name: {source file: [(old, new), ...]}}. Every
# `old` must occur in the file exactly once. Phase ids: block phases 0-3 by
# thread 0, warp sums 4-7 by lane 0 of each warp.
K2A_PHASES = {0: "prologue", 1: "gather", 2: "walk", 3: "epilogue"}
PHASES = {
    "two-pass": {"K2a": K2A_PHASES, "K2b": {
        0: "prologue", 1: "staging", 2: "passes", 3: "finish",
        4: "warp pass 1", 5: "warp pass 2", 6: "warp reduction"}},
    "marked": {"K2a": K2A_PHASES, "K2b": {
        0: "prologue", 1: "staging", 2: "pass 1", 3: "pass 2 and finish",
        4: "warp pass 1", 5: "warp pass 2", 6: "warp reduction",
        7: "warp finish"}},
}

_STAGE = ("      for (int q = 0; q < kRowF4; ++q) rows[j * kRowF4 + q] = src[q];\n"
          "    }\n    __syncthreads();\n")

_K2A_STAMPS = [
    ("  int executed = 0;\n  for (int c0 = 0; c0 < count; c0 += chunk) {\n"
     "    // barrier for the previous chunk's readers and the saturation exit\n"
     "    if (!__syncthreads_or(s.T > kTEps)) break;\n",
     "  int executed = 0;\n  GA_BEGIN();\n"
     "  for (int c0 = 0; c0 < count; c0 += chunk) {\n"
     "    if (!__syncthreads_or(s.T > kTEps)) break;\n    GA_MARK(1);\n"),
    (_STAGE, _STAGE + "    GA_MARK(2);\n"),
    ("  if constexpr (kEntries) {\n    if (lid == 0) n_exec[t] = executed;",
     "  __syncthreads();\n  GA_MARK(3);\n"
     "  if constexpr (kEntries) {\n    if (lid == 0) n_exec[t] = executed;"),
    ("  store_pixel(s, bg, out + (size_t)y * img_w + x, plane);\n}\n",
     "  store_pixel(s, bg, out + (size_t)y * img_w + x, plane);\n"
     "  GA_END();\n}\n"),
]

_K2B_BEGIN = ("  const size_t e_base = (size_t)chunk_off[t];\n",
              "  const size_t e_base = (size_t)chunk_off[t];\n  GA_BEGIN();\n")
_K2B_PASS1_END = "    // chunk-sum cotangents (the dist cross terms use the ENTRY"

_RS1 = ("#pragma unroll\n"
        "      for (int i = 0; i < kSums; ++i) s[i] = warp_sum(s[i]);\n")
_RS2 = ("          const float sum0 = ReduceScatter<kSums, 16>::run(s[0], "
        "lane);\n          const float sum1 = ReduceScatter<kSums, 16>::run("
        "s[1], lane);\n")
_STAGED = ("      zero[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n"
           "    __syncthreads();\n")
_PASS2 = ("    // ---- pass 2: the adjoints of the marked slots, word by word "
          "---------\n")
_CHUNK_END = "    // cotangent of this chunk's entry state = of the previous chunk's"

DESIGNS = {
    # the first design: K2a walks tiles in raster order; K2b goes over every
    # chunk twice (sums, then adjoints) and reduces 22 sums per kept slot
    "two-pass": {
        "K2a": {"stamps": {"rasterize_v4.cu": _K2A_STAMPS}},
        "K2b": {
            "stamps": {"rasterize_v4_bwd.cu": [
                _K2B_BEGIN,
                ("    __syncthreads();    // the previous chunk's readers of "
                 "rows and part\n", "    __syncthreads();\n    GA_MARK(1);\n"),
                (_STAGE, _STAGE + "    GA_MARK(2);\n"
                 "    long long ga_w = clock64(), ga_red = 0;\n"),
                (_K2B_PASS1_END, "    GA_WARP(4, clock64() - ga_w);\n"
                 "    ga_w = clock64();\n" + _K2B_PASS1_END),
                (_RS1, "      const long long ga_r = clock64();\n" + _RS1
                 + "      ga_red += clock64() - ga_r;\n"),
                (_CHUNK_END, "    GA_WARP(5, clock64() - ga_w);\n"
                 "    GA_WARP(6, ga_red);\n" + _CHUNK_END),
                ("    // ---- the 8 warps' partials, in warp order; one row per "
                 "pair ---------\n    __syncthreads();\n",
                 "    __syncthreads();\n    GA_MARK(3);\n"),
                ("      d[5] = o5;\n    }\n  }\n}\n",
                 "      d[5] = o5;\n    }\n  }\n  GA_END();\n}\n"),
            ]},
            "cut pass 1": {"rasterize_v4_bwd.cu": [(
                "    for (int k = 0; k < n; ++k) {\n"
                "      const float4 f0 = rows[k * kRowF4 + 0];   // a0 a1 a2 b0\n",
                "    for (int k = 0; k < 0; ++k) {\n"
                "      const float4 f0 = rows[k * kRowF4 + 0];\n")]},
            "cut reduction": {"rasterize_v4_bwd.cu": [(_RS1, "")]},
            "cut finish": {"rasterize_v4_bwd.cu": [(
                "    for (int j = lid; j < n; j += kPix) {\n"
                "      float r[kSums];\n",
                "    for (int j = lid; j < 0; j += kPix) {\n"
                "      float r[kSums];\n")]},
        },
    },
    # the current design: the warp cull and the paired walk
    # (composite_v4.cuh), the tiles heaviest first; K2a writes each chunk's
    # blend marks, and K2b's two passes visit only the marked slots, two at
    # a time
    "marked": {
        "K2a": {
            "stamps": {"rasterize_v4.cu": _K2A_STAMPS},
            "without the cull": {"composite_v4.cuh": [(
                "    const bool meets = kl < n && !warp_misses(rows[kl * "
                "kRowF4 + 5], slot);\n", "    const bool meets = kl < n;\n")]},
            "in raster order": {"rasterize_v4.cu": [(
                "  const int t = kEntries ? tile_order[blockIdx.x] : "
                "blockIdx.x;\n", "  const int t = blockIdx.x;\n")]},
            "at 4 blocks per SM": {"rasterize_v4.cu": [(
                "__global__ void __launch_bounds__(kPix)\ncomposite_v4_kernel(",
                "__global__ void __launch_bounds__(kPix, 4)\n"
                "composite_v4_kernel(")]},
        },
        "K2b": {
            "stamps": {"rasterize_v4_bwd.cu": [
                _K2B_BEGIN,
                ("    __syncthreads();    // the previous chunk's readers of "
                 "rows and masks\n", "    __syncthreads();\n    GA_MARK(1);\n"),
                (_STAGED, _STAGED + "    GA_MARK(2);\n"
                 "    long long ga_w = clock64(), ga_red = 0, ga_fin = 0;\n"),
                (_K2B_PASS1_END, "    GA_WARP(4, clock64() - ga_w);\n"
                 + _K2B_PASS1_END),
                (_PASS2, "    GA_MARK(3);\n    ga_w = clock64();\n" + _PASS2),
                (_RS2, "          const long long ga_r = clock64();\n" + _RS2
                 + "          ga_red += clock64() - ga_r;\n"),
                ("        // the pair rows of the word's marked slots, the i-th "
                 "of them\n", "        const long long ga_f = clock64();\n"
                 "        // the pair rows of the word's marked slots, the i-th "
                 "of them\n"),
                ("        buf ^= 1;\n",
                 "        ga_fin += clock64() - ga_f;\n        buf ^= 1;\n"),
                (_CHUNK_END, "    GA_WARP(5, clock64() - ga_w);\n"
                 "    GA_WARP(6, ga_red);\n    GA_WARP(7, ga_fin);\n"
                 + _CHUNK_END),
                ("i += kPix) rest[i] = 0.0f;\n}\n",
                 "i += kPix) rest[i] = 0.0f;\n  GA_END();\n}\n"),
            ]},
            "in raster order": {"rasterize_v4_bwd.cu": [(
                "  const int t = tile_order[blockIdx.x];\n",
                "  const int t = blockIdx.x;\n")]},
            "at 3 blocks per SM": {"rasterize_v4_bwd.cu": [(
                "__launch_bounds__(kPix, 2)", "__launch_bounds__(kPix, 3)")]},
            "cut reduction": {"rasterize_v4_bwd.cu": [(
                _RS2, "          float sum0 = 0.0f, sum1 = 0.0f;\n"
                "#pragma unroll\n"
                "          for (int i = 0; i < kSums; ++i) {\n"
                "            sum0 = sum0 + s[0][i];\n"
                "            sum1 = sum1 + s[1][i];\n          }\n")]},
        },
    },
}


# The list and stage kernels' copies, as DESIGNS, one stamped copy per
# source kernel: "K3" (both `aux` instantiations), "K4", "K5" and "stages"
# (the eight instantiations). An edit whose `old` is None appends `new` to
# the file: `ga_occupancy(kernel, P, chunk, group, *blocks, *clusters)`
# writes the blocks per SM (and for a cluster launch the active clusters)
# the occupancy calculator gives for the wrapper's launch, `kernel` 3, 4 or
# 5, or 10 + 4·field_major + stage. A design's anchors measure an earlier
# checkout through `--root` (the before-and-after of PERF.md rests on
# them); each later redesign keeps only its parent's.
_STAMP_END = "  GA_END();\n}\n"
# `ga_occupancy` for a design's source; the placeholders name what differs
# between designs
_OCCUPANCY = """
template <typename Kernel>
int stage_occupancy(Kernel kernel, int stage, bool field, int P, int chunk,
                    int group, int* blocks, int* clusters) {
  const int smem = %(stage_smem)s;
  const cudaError_t err = %(stage_prepare)s;
  if (err != cudaSuccess) return (int)err;%(stage_clusters)s
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            P, smem);
}
extern "C" int ga_occupancy(int kernel, int P, int chunk, int group,
                            int* blocks, int* clusters) {
  const int smem = list_buffers_bytes(chunk);
  *clusters = 0;
  if (kernel == 3) {
    const int k3_smem = %(k3_smem)s;
    const cudaError_t err = allow_shared(composite_lists_kernel<false>,
                                         k3_smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, composite_lists_kernel<false>, P, k3_smem);
  }
  if (kernel == 4) {
    const cudaError_t err = %(k4_prepare)s;
    if (err != cudaSuccess) return (int)err;
    for (int size = 16; size >= 1; --size) {
      if (group %% size) continue;
      *clusters = ga_grouped_clusters(size, P, chunk);
      if (*clusters < 0) return -*clusters;
      if (*clusters > 0) break;
    }
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, composite_lists_grouped_kernel, P, smem);
  }
  if (kernel >= 10 && kernel < 18) {
    const int s = (kernel - 10) %% 4;
    const bool f = kernel >= 14;
#define GA_OCC(S, F) if (s == S && f == F) return stage_occupancy( \
    stage_kernel<S, F>, S, F, P, chunk, group, blocks, clusters);
    GA_OCC(0, false) GA_OCC(1, false) GA_OCC(2, false) GA_OCC(3, false)
    GA_OCC(0, true) GA_OCC(1, true) GA_OCC(2, true) GA_OCC(3, true)
#undef GA_OCC
  }
  const cudaError_t err = allow_shared(composite_lists_unrolled_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, composite_lists_unrolled_kernel, P, smem);
}
"""
_CLUSTER_OCCUPANCY = (None, _OCCUPANCY % {
    "stage_smem": "ga_stage_shared_bytes(group, P, chunk)",
    "stage_prepare": "allow_shared(kernel, smem)", "stage_clusters": "",
    "k3_smem": "rows_bytes(chunk)", "k4_prepare": "prepare_grouped(smem)"})
_PAIRED_OCCUPANCY = (None, _OCCUPANCY % {
    "stage_smem": "list_buffers_bytes(chunk)",
    "stage_prepare": "prepare_cluster(kernel, smem)",
    "stage_clusters": "\n  *clusters = ga_stage_clusters(stage, field, group, "
                      "P, chunk);\n  if (*clusters < 0) return -*clusters;",
    "k3_smem": "smem",
    "k4_prepare": "prepare_cluster(composite_lists_grouped_kernel, smem)"})
# a cut copy (wrong results, read for its time): the ray-splat form's two
# IEEE divisions become products
_PRODUCTS = {"rasterize_v1.cu": [(
    "    u[j] = p0[j] / safe[j];\n    v[j] = p1[j] / safe[j];\n",
    "    u[j] = p0[j] * safe[j];\n    v[j] = p1[j] * safe[j];\n")]}
# the walk with another number of rows side by side (its results are the
# kernel's, bit for bit; read for its time)
_WALK_ROWS = {
    f"{word} at a time": {"rasterize_v1.cu": [(
        "constexpr int kWalkRows = 2;",
        f"constexpr int kWalkRows = {rows};")]}
    for word, rows in (("one row", 1), ("four rows", 4))}
# the phases of the stamped copies that mark them (thread 0's SM cycles)
LIST_PHASES = {0: "prologue and epilogue", 1: "vote", 2: "feed",
               3: "walk"}
LIST_DESIGNS = {
    # the cluster design: K3 a block per tile in natural order, its rows
    # staged by synchronous copies, walked one row at a time; K4 a block per
    # tile, a cluster per group, the group test through distributed shared
    # memory; K5 a block per tile, heaviest first, K4 and K5 fed by bulk
    # copies into a double buffer; the stage kernels a block per group, the
    # G tiles walked one after another each chunk, their states in shared
    # memory
    "cluster": {
        "K3": {"stamps": {"rasterize_v1.cu": [
            ("  extern __shared__ float4 rows[];\n  const int t = blockIdx.x;\n"
             "  composite_tile<kAux, true>(geom, feat, t, counts[t], "
             "max_per_tile, tiles_x,\n                             tile, "
             "chunk, row0, rows, out);\n}\n",
             "  extern __shared__ float4 rows[];\n  const int t = blockIdx.x;\n"
             "  GA_BEGIN();\n  composite_tile<kAux, true>(geom, feat, t, "
             "counts[t], max_per_tile, tiles_x, tile, chunk, row0, rows, "
             "out);\n" + _STAMP_END),
            _CLUSTER_OCCUPANCY]}},
        "K4": {"stamps": {"rasterize_v1.cu": [
            ("  __shared__ int live[2];          // this block's vote, by "
             "chunk parity\n",
             "  __shared__ int live[2];\n  GA_BEGIN();\n"),
            ("  cluster.sync();   // no block leaves while another may read "
             "its votes\n}\n",
             "  cluster.sync();\n" + _STAMP_END),
            _CLUSTER_OCCUPANCY]}},
        "K5": {"stamps": {"rasterize_v1.cu": [
            ("  const int t = order[blockIdx.x];\n",
             "  const int t = order[blockIdx.x];\n  GA_BEGIN();\n"),
            ("    __syncthreads();    // the readers of buffer c & 1, before "
             "chunk c + 2\n  }\n  store_list_pixel(s, out + ((size_t)t * "
             "blockDim.x + lid) * kOutW);\n}\n",
             "    __syncthreads();\n  }\n  store_list_pixel(s, out + "
             "((size_t)t * blockDim.x + lid) * kOutW);\n" + _STAMP_END),
            _CLUSTER_OCCUPANCY]}},
        "stages": {"stamps": {"rasterize_v1.cu": [
            ("  const int g = blockIdx.x;\n  float* state = rows + chunk * "
             "24;\n",
             "  const int g = blockIdx.x;\n  GA_BEGIN();\n  float* state = "
             "rows + chunk * 24;\n"),
            ("        out[((size_t)t * P + lid) * kOutW + ch] = val;\n      }"
             "\n    }\n  }\n}\n",
             "        out[((size_t)t * P + lid) * kOutW + ch] = val;\n      }"
             "\n    }\n  }\n" + _STAMP_END),
            _CLUSTER_OCCUPANCY]}},
    },
    # the paired design: every kernel fed by bulk copies into a double
    # buffer and walked two rows at a time; K3 a block per tile, heaviest
    # first, leaving once its tile saturates; the stage kernels K4's grid, a
    # group one cluster, the states in registers
    "paired": {
        "K3": {"stamps": {"rasterize_v1.cu": [
            ("  ListState s;\n  int c = 0;\n  for (; c < n_chunks; ++c) {\n",
             "  GA_BEGIN();\n  ListState s;\n  int c = 0;\n"
             "  for (; c < n_chunks; ++c) {\n    GA_MARK(1);\n"),
            ("    if (!__syncthreads_or(s.T > kTEps)) break;\n"
             "    if (lid == 0 && c + 1 < n_chunks)\n",
             "    if (!__syncthreads_or(s.T > kTEps)) break;\n    GA_MARK(2);\n"
             "    if (lid == 0 && c + 1 < n_chunks)\n"),
            ("    buf.wait(c);\n    composite_list_rows<kAux>(",
             "    buf.wait(c);\n    GA_MARK(3);\n    composite_list_rows<kAux>("),
            ("  // a copy started for a chunk the tile skips lands before exit\n",
             "  GA_MARK(0);\n"),
            ("  if (lid == 0 && c < n_chunks) buf.wait(c);\n  store_list_pixel("
             "s, out + ((size_t)t * blockDim.x + lid) * kOutW);\n}\n",
             "  if (lid == 0 && c < n_chunks) buf.wait(c);\n  store_list_pixel("
             "s, out + ((size_t)t * blockDim.x + lid) * kOutW);\n"
             + _STAMP_END),
            _PAIRED_OCCUPANCY]},
               "with products for the divisions": _PRODUCTS, **_WALK_ROWS,
               "at 4 blocks per SM": {"rasterize_v1.cu": [(
                   "template <bool kAux>\n__global__ void "
                   "composite_lists_kernel(",
                   "template <bool kAux>\n__global__ void "
                   "__launch_bounds__(256, 4) composite_lists_kernel(")]}},
        "K4": {"stamps": {"rasterize_v1.cu": [
            ("  __shared__ int live[2];          // this block's votes, by "
             "chunk parity\n",
             "  __shared__ int live[2];\n  GA_BEGIN();\n"),
            ("  store_list_pixel(s, out + ((size_t)t * P + lid) * kOutW);\n"
             "  cluster.sync();   // no block leaves while another may read "
             "its votes\n}\n",
             "  store_list_pixel(s, out + ((size_t)t * P + lid) * kOutW);\n"
             "  cluster.sync();\n" + _STAMP_END),
            _PAIRED_OCCUPANCY]}, **_WALK_ROWS},
        "K5": {"stamps": {"rasterize_v1.cu": [
            ("  __syncthreads();\n  ListState s;\n"
             "  for (int c = 0; c < n_chunks; ++c) {\n",
             "  __syncthreads();\n  GA_BEGIN();\n  ListState s;\n"
             "  for (int c = 0; c < n_chunks; ++c) {\n"),
            ("    __syncthreads();    // the readers of buffer c & 1, before "
             "chunk c + 2\n  }\n  store_list_pixel(s, out + ((size_t)t * "
             "blockDim.x + lid) * kOutW);\n}\n",
             "    __syncthreads();\n  }\n  store_list_pixel(s, out + "
             "((size_t)t * blockDim.x + lid) * kOutW);\n" + _STAMP_END),
            _PAIRED_OCCUPANCY]}, **_WALK_ROWS},
        "stages": {"stamps": {"rasterize_v1.cu": [
            ("  __shared__ int live[2];\n  const ChunkBuffers buf{rows, full, "
             "chunk};\n",
             "  __shared__ int live[2];\n  GA_BEGIN();\n"
             "  const ChunkBuffers buf{rows, full, chunk};\n"),
            ("    if (!cluster_any(cluster, live, c, s.T > kTEps)) break;\n"
             "    if (c + 1 < c_end) issue(c + 1);\n    buf.wait(c);\n",
             "    GA_MARK(1);\n"
             "    if (!cluster_any(cluster, live, c, s.T > kTEps)) break;\n"
             "    GA_MARK(2);\n    if (c + 1 < c_end) issue(c + 1);\n"
             "    buf.wait(c);\n    GA_MARK(3);\n"),
            ("  // a copy started for a chunk the group did not run lands "
             "before exit\n", "  GA_MARK(0);\n"),
            ("    o4[3] = zero;\n  }\n  cluster.sync();   // no block leaves "
             "while another may read its votes\n}\n",
             "    o4[3] = zero;\n  }\n  cluster.sync();\n" + _STAMP_END),
            _PAIRED_OCCUPANCY]},
            "with products for the divisions": _PRODUCTS, **_WALK_ROWS},
    },
}
# the stamped copy of each source kernel and the wrappers' kernels it serves
STAMPED_KERNELS = {"K3": ("K3", "K3 aux"), "K4": ("K4",), "K5": ("K5",),
                   "stages": tuple(f"B{b}.{s}" for b in (1, 2)
                                   for s in range(4))}


def patched_csrc(csrc: str, dest: str, patches) -> str:
    """Copy `csrc` (without its build directory) to `dest`/csrc and apply
    `patches` {file: [(old, new)]} (`old` None: append `new`); the
    instrumentation prelude goes after the first include of every patched
    file. Returns the new directory."""
    out = os.path.join(dest, "csrc")
    shutil.copytree(csrc, out, ignore=shutil.ignore_patterns("build"))
    for name, edits in patches.items():
        path = os.path.join(out, name)
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if old is None:
                text += new
                continue
            if text.count(old) != 1:
                raise ValueError(f"{name}: an edit's anchor occurs "
                                 f"{text.count(old)} times, not once:\n{old}")
            text = text.replace(old, new)
        if "GA_BEGIN()" in text:
            text = text.replace(INCLUDE, INCLUDE + PRELUDE, 1)
        with open(path, "w") as f:
            f.write(text)
    return out


def design_of(csrc: str, designs=None) -> str:
    """The name in `designs` (default DESIGNS) whose every anchor is in
    `csrc`'s sources."""
    designs = DESIGNS if designs is None else designs
    for name, kernels in designs.items():
        ok = True
        for copies in kernels.values():
            for patches in copies.values():
                for fname, edits in patches.items():
                    with open(os.path.join(csrc, fname)) as f:
                        text = f.read()
                    ok &= all(text.count(old) == 1 for old, _ in edits
                              if old is not None)
        if ok:
            return name
    raise ValueError(f"no design of {sorted(designs)} fits {csrc}")


def _frame(dev, n, res, mpt):
    import torch
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.render import cameras
    g = make_object(0, n=n, kind="sphere", device=dev)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0], device=dev)
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    pairs, starts, counts = rz.build_tile_pairs(sp, res, res, 16, mpt)
    if "packed" in inspect.signature(rz.splat_table).parameters:
        tab = rz.splat_table(rz.pack_splat_render(sp))  # the first design
    else:
        tab = rz.splat_table(sp, res, res)
    ct = torch.randn((rz.N_OUT, res, res),
                     generator=torch.Generator().manual_seed(6)).to(dev)
    return (tab.contiguous(), pairs, starts, counts,
            torch.ones(3, device=dev), res, res), ct


def _median_ms(fn, reps):
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _batched_ms(fn, n):
    """Milliseconds per call of `fn` over `n` calls back to back between
    two CUDA events: the card's time per launch once the host's enqueueing
    runs ahead of it (a median of single calls, `_median_ms`, also counts
    the host's way to each launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _runners(rc, frames, forward=False):
    """{kernel: {case: fn}} calling the wrappers of the imported package;
    with `forward`, K1 and K6 too, at chunk FWD_CHUNK (their walk is
    K2a's)."""
    out = {"K2a": {}, "K2b": {}}
    if forward:
        out.update(K1={}, K6={})
    for case, (args, ct) in frames.items():
        if forward:
            seg_tab = args[0][args[1].long()]
            out["K1"][case] = (lambda a=args: rc.composite(
                *a, chunk=FWD_CHUNK))
            out["K6"][case] = (lambda a=(seg_tab, *args[2:]):
                               rc.composite_segments(*a, chunk=FWD_CHUNK))
        out["K2a"][case] = (lambda a=args: rc.composite_entries(
            *a, chunk=CHUNK))
        tab, pairs, starts, counts, bg, res, _ = args
        # the first design's K2a returns 4 tensors, the current one also the
        # marks K2b reads
        _, *state = rc.composite_entries(*args, chunk=CHUNK)
        order, seg = rc.splat_order(pairs, starts, counts, tab.shape[0])
        out["K2b"][case] = (
            lambda a=(tab, pairs, starts, counts, bg, ct, *state, order, seg,
                      res, res): rc.composite_backward(*a, chunk=CHUNK))
    return out


def _stamps(rc, lib_name, fn, iters=5):
    """Phase cycles per call summed over blocks, and the block timeline."""
    import numpy as np
    import torch
    lib = rc.library(lib_name)
    lib.ga_stamps.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    fn()
    torch.cuda.synchronize()
    acc = np.zeros(16, np.uint64)
    blk = np.zeros(2 * MAX_BLOCKS, np.uint64)
    sm = np.zeros(MAX_BLOCKS, np.uint32)
    if lib.ga_stamps(None, None, None, 1):
        raise RuntimeError("clearing the stamps failed")
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    if lib.ga_stamps(acc.ctypes.data, blk.ctypes.data, sm.ctypes.data, 0):
        raise RuntimeError("reading the stamps failed")
    start, end = blk[:MAX_BLOCKS].astype(np.int64), \
        blk[MAX_BLOCKS:].astype(np.int64)
    used = start > 0
    start, end, sm = start[used], end[used], sm[used]
    t0 = start.min()
    span = float(end.max() - t0)
    dur = end - start
    longest = int(np.argmax(dur))
    return acc.astype(np.float64) / iters, {
        "blocks": int(used.sum()), "span_us": span / 1e3,
        "median_block_end_us": float(np.median(end - t0)) / 1e3,
        "tail_share": float(end.max() - np.median(end)) / span,
        "block_us_median": float(np.median(dur)) / 1e3,
        "block_us_max": float(dur.max()) / 1e3,
        "longest_block_starts_at_share": float(start[longest] - t0) / span,
        "sms": int(len(np.unique(sm))),
    }


def measure(root: str, case_names, reps: int, log, out=None):
    import torch
    from gaussiananything_tpu_torch.ops import kernel_lib
    from gaussiananything_tpu_torch.ops import rasterize_cuda as rc
    csrc = os.path.dirname(kernel_lib.SOURCES["fwd"][0])
    design = design_of(csrc)
    dev = torch.device("cuda")
    frames = {c: _frame(dev, *CASES[c]) for c in case_names}
    libs = {"K2a": "fwd", "K2b": "bwd"}
    phases = PHASES[design]
    recs = {(k, c): {"root": root, "design": design, "kernel": k, "case": c}
            for k in ("K2a", "K2b", "K1", "K6") for c in case_names}
    with tempfile.TemporaryDirectory() as tmp:
        for k, cases in _runners(rc, frames, forward=True).items():
            for c, fn in cases.items():
                recs[(k, c)]["ms"] = _median_ms(fn, reps)
                if k in ("K1", "K6"):
                    recs[(k, c)]["chunk"] = FWD_CHUNK
                    log(json.dumps(recs[(k, c)]))
        for line in kernel_lib.build_log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                log(f"ptxas: {line.strip()}")
        for kernel, copies in DESIGNS[design].items():
            for i, (copy, patches) in enumerate(copies.items()):
                with kernel_lib.sources_from(patched_csrc(
                        csrc, os.path.join(tmp, f"{kernel}{i}"), patches),
                        (libs[kernel],)):
                    for case, fn in _runners(rc, frames)[kernel].items():
                        _phases(rc, fn, rec=recs[(kernel, case)], copy=copy,
                                lib=libs[kernel], names=phases[kernel],
                                reps=reps)
            for case in case_names:
                log(json.dumps(recs[(kernel, case)]))
                if out:
                    with open(out, "a") as f:
                        f.write(json.dumps(recs[(kernel, case)]) + "\n")
    return list(recs.values())


def _phases(rc, fn, rec, copy, lib, names, reps):
    """A training kernel's copy read into `rec`: a cut copy's time, or the
    stamped copy's phase shares, timeline and time."""
    if copy != "stamps":
        rec[f"{copy} ms"] = _median_ms(fn, reps)
        return
    acc, timeline = _stamps(rc, lib, fn)
    block = sum(acc[i] for i in names if i < 4)
    rec["block_cycle_shares"] = {
        names[i]: acc[i] / block for i in names if i < 4}
    warp = {names[i]: acc[i] for i in names if i >= 4}
    if warp:
        total = sum(v for n, v in warp.items() if "pass" in n)
        rec["warp_cycle_shares"] = {n: v / total for n, v in warp.items()}
    rec["timeline"] = timeline
    rec["stamped ms"] = _median_ms(fn, reps)


def _list_frame(dev, n, res, tile, mpt, chunk, group4, group5):
    """The list wrappers' inputs at one case, as `chip_smoke.py` makes
    them: natural order for K3 and K5, count-sorted for K4."""
    import torch
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.render import cameras
    g = make_object(0, n=n, kind="sphere", device=dev)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0], device=dev)
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    lists, counts = rz.build_tile_lists(sp, res, res, tile, mpt)
    geom, feat = rz.pack_tile_inputs(rz.pad_dead_splat(sp), lists)
    geom, feat = geom.contiguous(), feat.contiguous()
    px, py = rz.tile_pixel_tables(
        torch.arange(counts.shape[0], device=dev), res // tile, tile)
    order = torch.sort(-counts, stable=True).indices
    cs = counts[order]
    grouped = (cs.reshape(-1, group4).amax(1).int().contiguous(),
               geom[order].contiguous(), feat[order].contiguous(),
               px[order].contiguous(), py[order].contiguous(),
               cs.float()[:, None].contiguous())
    return {"natural": (geom, feat, counts, res // tile, tile, chunk),
            "grouped": grouped, "inv": torch.sort(order, stable=True).indices,
            "chunk": chunk, "group4": group4, "group5": group5,
            "P": tile * tile}


def _stage_frame(dev):
    """The stage kernels' inputs at the stage tool's shape (seeded), both
    layouts."""
    from gaussiananything_tpu_torch.tools import kernel_stages as ks
    gmax, *row = ks.make_inputs(1, dev)
    return {"gmax": gmax, "row": tuple(row),
            "field": tuple(ks.to_field_major(*row)), "group": ks.G,
            "chunk": ks.CHUNK, "P": row[2].shape[1]}


def _list_runners(rc, frames):
    """{kernel: {case: fn}} of the list and stage wrappers of the imported
    package."""
    out = {k: {} for k in ("K3", "K3 aux", "K4", "K5",
                           *STAMPED_KERNELS["stages"])}
    for case, f in frames.items():
        if case in STAGE_CASES:
            for name in STAMPED_KERNELS["stages"]:
                field, stage = name[1] == "2", int(name[-1])
                out[name][case] = (
                    lambda f=f, s=stage, fm=field: rc.stage(
                        s, f["gmax"], *f["field" if fm else "row"],
                        f["group"], f["chunk"], field_major=fm))
            continue
        out["K3"][case] = lambda f=f: rc.composite_lists(*f["natural"])
        out["K3 aux"][case] = lambda f=f: rc.composite_lists(
            *f["natural"], with_aux=True)
        out["K4"][case] = lambda f=f: rc.composite_lists_grouped(
            *f["grouped"], f["group4"], f["chunk"])
        out["K5"][case] = lambda f=f: rc.composite_lists_unrolled(
            *f["natural"], f["group5"])
    return out


def _occupancy_code(kernel):
    """`ga_occupancy`'s kernel number of a wrapper's kernel."""
    if kernel.startswith("B"):
        return 10 + 4 * (kernel[1] == "2") + int(kernel[-1])
    return int(kernel[1])


def _compare(recs, outputs, against):
    """Each output saved by the run of `--save` against this run's: K3
    bit for bit, the stage kernels within atol 2e-5 / rtol 1e-4."""
    import torch
    other = torch.load(against)
    for key, got in outputs.items():
        if key not in other:
            continue
        ref = other[key]
        rec = recs[key]
        rec["max_abs_vs_other"] = float((got - ref).abs().max())
        rec["equal_to_other"] = bool(torch.equal(got, ref))
        if key[0].startswith("B"):
            rec["close_to_other"] = bool(torch.allclose(got, ref, atol=2e-5,
                                                        rtol=1e-4))


def measure_lists(root: str, case_names, reps: int, log, out=None,
                  save=None, against=None):
    """K3 (both aux), K4 and K5 at the list cases and the eight stage
    instantiations at the stage case: times, K4's and K5's bit-equality
    with K3 and between runs, every kernel's block timeline and occupancy
    from its stamped copy. `save` writes K3's and the stages' outputs to a
    file; `against` compares this run's with such a file."""
    import torch
    from gaussiananything_tpu_torch.ops import kernel_lib
    from gaussiananything_tpu_torch.ops import rasterize_cuda as rc
    csrc = os.path.dirname(kernel_lib.SOURCES["v1"][0])
    design = design_of(csrc, LIST_DESIGNS)
    dev = torch.device("cuda")
    frames = {c: (_stage_frame(dev) if c in STAGE_CASES
                  else _list_frame(dev, *LIST_CASES[c])) for c in case_names}
    names = [k for kernels in STAMPED_KERNELS.values() for k in kernels]
    recs = {(k, c): {"root": root, "design": design, "kernel": k, "case": c}
            for k in names for c in case_names
            if (c in STAGE_CASES) == k.startswith("B")}
    outputs = {}
    with tempfile.TemporaryDirectory() as tmp:
        runners = _list_runners(rc, frames)
        for c in case_names:
            if c in STAGE_CASES:
                for k in STAMPED_KERNELS["stages"]:
                    outputs[(k, c)] = runners[k][c]().cpu()
                    recs[(k, c)]["ms"] = _median_ms(runners[k][c], reps)
                    recs[(k, c)]["batched ms"] = _batched_ms(runners[k][c],
                                                             reps)
                continue
            ref = runners["K3"][c]()
            outputs[("K3", c)] = ref.cpu()
            outputs[("K3 aux", c)] = runners["K3 aux"][c]().cpu()
            for k in ("K4", "K5"):
                a, b = runners[k][c](), runners[k][c]()
                nat = (lambda x: x[frames[c]["inv"]]) if k == "K4" else \
                    (lambda x: x)
                recs[(k, c)]["equal_to_K3"] = bool(torch.equal(nat(a), ref))
                recs[(k, c)]["runs_equal"] = bool(torch.equal(a, b))
                recs[(k, c)]["max_abs_vs_K3"] = float(
                    (nat(a) - ref).abs().max())
            for k in ("K3", "K3 aux", "K4", "K5"):
                recs[(k, c)]["ms"] = _median_ms(runners[k][c], reps)
                recs[(k, c)]["batched ms"] = _batched_ms(runners[k][c], reps)
        if save:
            torch.save(outputs, save)
        if against:
            _compare(recs, outputs, against)
        keep = False
        for line in kernel_lib.build_log.splitlines():
            if "Compiling entry" in line:
                keep = any(w in line for w in ("composite_lists",
                                               "tile_order", "stage_kernel"))
            if keep and any(w in line for w in ("Compiling entry",
                                                "registers", "spill")):
                log(f"ptxas: {line.strip()}")
        for source_kernel, copies in LIST_DESIGNS[design].items():
            done = []
            for i, (copy, patches) in enumerate(copies.items()):
                with kernel_lib.sources_from(patched_csrc(
                        csrc, os.path.join(tmp, f"{source_kernel}{i}"),
                        patches), ("v1",)):
                    runners = _list_runners(rc, frames)
                    for kernel in STAMPED_KERNELS[source_kernel]:
                        for case, fn in runners[kernel].items():
                            rec = recs[(kernel, case)]
                            if copy == "stamps":
                                _stamped(rc, fn, frames[case], kernel, case,
                                         rec, reps)
                                done.append(rec)
                            else:
                                rec[f"{copy} ms"] = _median_ms(fn, reps)
            for rec in done:
                log(json.dumps(rec))
                if out:
                    with open(out, "a") as fh:
                        fh.write(json.dumps(rec) + "\n")
    return list(recs.values())


def _stamped(rc, fn, f, kernel, case, rec, reps):
    """A stamped copy's block timeline, phase shares (where its source
    marks them), time and occupancy, into `rec`."""
    acc, rec["timeline"] = _stamps(rc, "v1", fn)
    block = sum(acc[i] for i in LIST_PHASES)
    if block and any(acc[i] for i in LIST_PHASES if i):
        rec["block_cycle_shares"] = {
            name: acc[i] / block for i, name in LIST_PHASES.items()}
    rec["stamped ms"] = _median_ms(fn, reps)
    lib = rc.library("v1")
    lib.ga_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    group = f["group"] if case in STAGE_CASES else \
        f["group4"] if kernel == "K4" else f["group5"]
    err = lib.ga_occupancy(_occupancy_code(kernel), f["P"], f["chunk"],
                           group, ctypes.byref(blocks),
                           ctypes.byref(clusters))
    if err:
        raise RuntimeError(f"occupancy query: error {err}")
    rec["blocks_per_sm"] = blocks.value
    rec["active_clusters"] = clusters.value
    if kernel == "K4":
        rec["cluster"] = rc.cluster_size(
            group, rc.cluster_limit(f["P"], f["chunk"]))


def main(argv=None, log=print):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose kernels to measure (default: this)")
    ap.add_argument("--cases", nargs="+",
                    default=[*CASES, *LIST_CASES, *STAGE_CASES],
                    choices=[*CASES, *LIST_CASES, *STAGE_CASES])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--save", default=None,
                    help="write K3's and the stage kernels' outputs here")
    ap.add_argument("--against", default=None,
                    help="compare those outputs with a file of --save")
    ap.add_argument("--inner", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(a.root or here)
    if root != here and not a.inner:
        # the other checkout's package, through its own wrappers
        env = dict(os.environ, PYTHONPATH=root)
        args = [sys.executable, os.path.abspath(__file__), "--inner",
                "--root", root, "--reps", str(a.reps), "--cases", *a.cases]
        for flag in ("out", "save", "against"):
            if getattr(a, flag):
                args += [f"--{flag}", os.path.abspath(getattr(a, flag))]
        return subprocess.run(args, env=env, check=True)
    from gaussiananything_tpu_torch.utils.device import resolve_device
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    recs = []
    train = [c for c in a.cases if c in CASES]
    lists = [c for c in a.cases if c not in CASES]
    if train:
        recs += measure(root, train, a.reps, log, a.out)
    if lists:
        recs += measure_lists(root, lists, a.reps, log, a.out, a.save,
                              a.against)
    return recs


if __name__ == "__main__":
    main()
