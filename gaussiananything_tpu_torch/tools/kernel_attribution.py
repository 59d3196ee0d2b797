"""Where the kernels' time goes on the card: K2a's and K2b's time split
into the phases of their design, and the block timelines of the list
kernels K4 and K5, from instrumented copies of their sources.

    python -m gaussiananything_tpu_torch.tools.kernel_attribution \\
        [--root DIR] [--cases "train 512" ... bench defaults] [--reps 20] \\
        [--out FILE]

`--root` names the checkout whose kernels are measured (default: this
one); another checkout's package, e.g. an earlier commit unpacked with
`git archive`, measures that commit's kernels through its own wrappers.
Each copy is built from that checkout's `csrc/` into a temporary directory
and thrown away; the committed sources carry no instrumentation.

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
`max_per_tile` 512, chunk 128) time K3, K4 and K5 whole, check that K4's
and K5's outputs equal K3's (aux off) bit for bit and that two runs are
bit-equal, and read a stamped copy of K4 and of K5: every block's start
and end (%globaltimer) and SM (%smid), which give the span, the tail after
the median block, the longest block and its start, and the number of SMs
the blocks ran on; beside them the blocks (and clusters) per SM that
`cudaOccupancyMaxActiveBlocksPerMultiprocessor` (and
`cudaOccupancyMaxActiveClusters`) give for the launch.

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


# The list kernels' copies, as DESIGNS. An edit whose `old` is None appends
# `new` to the file: `ga_occupancy(kernel 4 or 5, P, chunk, group, *blocks,
# *clusters)` writes the blocks per SM (and for a cluster launch the active
# clusters) the occupancy calculator gives for the wrapper's launch. The
# earlier design's anchors measure an earlier checkout through `--root`
# (the before-and-after of PERF.md rests on them); a design's anchors go
# once no number in PERF.md does.
_STAMP_END = "  GA_END();\n}\n"
LIST_DESIGNS = {
    # the design before the clusters: K4 one block per count-sorted group, the G tiles'
    # states in shared memory, the tiles walked one after another each
    # chunk; K5 one block per G consecutive tiles, walked one after another
    "shared-state": {
        "K4": {"stamps": {"rasterize_v1.cu": [
            ("  float* state =\n      reinterpret_cast<float*>(rows + chunk * "
             "(kGeomF4 + kFeatF4));\n",
             "  GA_BEGIN();\n  float* state =\n      reinterpret_cast<float*>"
             "(rows + chunk * (kGeomF4 + kFeatF4));\n"),
            ("    store_list_pixel(s, out + ((size_t)(g * group + j) * P + "
             "lid) * kOutW);\n  }\n}\n",
             "    store_list_pixel(s, out + ((size_t)(g * group + j) * P + "
             "lid) * kOutW);\n  }\n" + _STAMP_END),
            (None, """
extern "C" int ga_occupancy(int kernel, int P, int chunk, int group,
                            int* blocks, int* clusters) {
  *clusters = 0;
  if (kernel == 4) {
    const int smem = ga_grouped_shared_bytes(group, P, chunk);
    const cudaError_t err = allow_shared(composite_lists_grouped_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, composite_lists_grouped_kernel, P, smem);
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, composite_lists_unrolled_kernel, P, rows_bytes(chunk));
}
"""),
        ]}},
        "K5": {"stamps": {"rasterize_v1.cu": [
            ("  extern __shared__ float4 rows[];\n  for (int j = 0; j < group; "
             "++j) {\n    const int t = blockIdx.x * group + j;\n",
             "  extern __shared__ float4 rows[];\n  GA_BEGIN();\n"
             "  for (int j = 0; j < group; ++j) {\n"
             "    const int t = blockIdx.x * group + j;\n"),
            ("                                 tiles_x, tile, chunk, row0, "
             "rows, out);\n  }\n}\n",
             "                                 tiles_x, tile, chunk, row0, "
             "rows, out);\n  }\n" + _STAMP_END),
        ]}},
    },
}
_CLUSTER_OCCUPANCY = (None, """
extern "C" int ga_occupancy(int kernel, int P, int chunk, int group,
                            int* blocks, int* clusters) {
  const int smem = list_buffers_bytes(chunk);
  *clusters = 0;
  if (kernel == 4) {
    const cudaError_t err = prepare_grouped(smem);
    if (err != cudaSuccess) return (int)err;
    for (int size = 16; size >= 1; --size) {
      if (group % size) continue;
      *clusters = ga_grouped_clusters(size, P, chunk);
      if (*clusters < 0) return -*clusters;
      if (*clusters > 0) break;
    }
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, composite_lists_grouped_kernel, P, smem);
  }
  const cudaError_t err = allow_shared(composite_lists_unrolled_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, composite_lists_unrolled_kernel, P, smem);
}
""")
# the current design: K4 a block per tile, a cluster per group, the states
# in registers, the group test through distributed shared memory; K5 a
# block per tile, heaviest first; both fed by bulk copies into a double
# buffer
LIST_DESIGNS["cluster"] = {
    "K4": {"stamps": {"rasterize_v1.cu": [
        ("  __shared__ int live[2];          // this block's vote, by chunk "
         "parity\n",
         "  __shared__ int live[2];\n  GA_BEGIN();\n"),
        ("  cluster.sync();   // no block leaves while another may read its "
         "votes\n}\n",
         "  cluster.sync();\n" + _STAMP_END),
        _CLUSTER_OCCUPANCY,
    ]}},
    "K5": {"stamps": {"rasterize_v1.cu": [
        ("  const int t = order[blockIdx.x];\n",
         "  const int t = order[blockIdx.x];\n  GA_BEGIN();\n"),
        ("    __syncthreads();    // the readers of buffer c & 1, before chunk "
         "c + 2\n  }\n  store_list_pixel(s, out + ((size_t)t * blockDim.x + "
         "lid) * kOutW);\n}\n",
         "    __syncthreads();\n  }\n  store_list_pixel(s, out + ((size_t)t "
         "* blockDim.x + lid) * kOutW);\n" + _STAMP_END),
        _CLUSTER_OCCUPANCY,
    ]}},
}
# the K5 copy reads its occupancy through the same appended function
LIST_DESIGNS["shared-state"]["K5"]["stamps"]["rasterize_v1.cu"].append(
    LIST_DESIGNS["shared-state"]["K4"]["stamps"]["rasterize_v1.cu"][-1])


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


def _use(rc, csrc):
    """Point the wrappers' build at the sources in `csrc`."""
    rc.SOURCES = {k: os.path.join(csrc, os.path.basename(v))
                  for k, v in rc.SOURCES.items()}
    rc.HEADERS = [os.path.join(csrc, os.path.basename(h))
                  for h in rc.HEADERS]
    rc.BUILD_DIR = os.path.join(csrc, "build")
    rc._libs.clear()


def _stamps(rc, lib_name, fn, iters=5):
    """Phase cycles per call summed over blocks, and the block timeline."""
    import numpy as np
    import torch
    lib = rc._library(lib_name)
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
    from gaussiananything_tpu_torch.ops import rasterize_cuda as rc
    csrc = os.path.dirname(rc.SOURCES["fwd"])
    design = design_of(csrc)
    dev = torch.device("cuda")
    frames = {c: _frame(dev, *CASES[c]) for c in case_names}
    libs = {"K2a": "fwd", "K2b": "bwd"}
    phases = PHASES[design]
    recs = {(k, c): {"root": root, "design": design, "kernel": k, "case": c}
            for k in ("K2a", "K2b", "K1", "K6") for c in case_names}
    with tempfile.TemporaryDirectory() as tmp:
        _use(rc, patched_csrc(csrc, os.path.join(tmp, "whole"), {}))
        for k, cases in _runners(rc, frames, forward=True).items():
            for c, fn in cases.items():
                recs[(k, c)]["ms"] = _median_ms(fn, reps)
                if k in ("K1", "K6"):
                    recs[(k, c)]["chunk"] = FWD_CHUNK
                    log(json.dumps(recs[(k, c)]))
        for line in rc.build_log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                log(f"ptxas: {line.strip()}")
        for kernel, copies in DESIGNS[design].items():
            for i, (copy, patches) in enumerate(copies.items()):
                _use(rc, patched_csrc(csrc, os.path.join(tmp, f"{kernel}{i}"),
                                      patches))
                for case, fn in _runners(rc, frames)[kernel].items():
                    rec = recs[(kernel, case)]
                    if copy != "stamps":
                        rec[f"{copy} ms"] = _median_ms(fn, reps)
                        continue
                    acc, timeline = _stamps(rc, libs[kernel], fn)
                    names = phases[kernel]
                    block = sum(acc[i] for i in names if i < 4)
                    rec["block_cycle_shares"] = {
                        names[i]: acc[i] / block for i in names if i < 4}
                    warp = {names[i]: acc[i] for i in names if i >= 4}
                    if warp:
                        total = sum(v for n, v in warp.items() if "pass" in n)
                        rec["warp_cycle_shares"] = {
                            n: v / total for n, v in warp.items()}
                    rec["timeline"] = timeline
                    rec["stamped ms"] = _median_ms(fn, reps)
            for case in case_names:
                log(json.dumps(recs[(kernel, case)]))
                if out:
                    with open(out, "a") as f:
                        f.write(json.dumps(recs[(kernel, case)]) + "\n")
    return list(recs.values())


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


def _list_runners(rc, frames):
    """{kernel: {case: fn}} of the list wrappers of the imported package."""
    out = {"K3": {}, "K4": {}, "K5": {}}
    for case, f in frames.items():
        out["K3"][case] = lambda f=f: rc.composite_lists(*f["natural"])
        out["K4"][case] = lambda f=f: rc.composite_lists_grouped(
            *f["grouped"], f["group4"], f["chunk"])
        out["K5"][case] = lambda f=f: rc.composite_lists_unrolled(
            *f["natural"], f["group5"])
    return out


def measure_lists(root: str, case_names, reps: int, log, out=None):
    """K3, K4 and K5 at the list cases: times, bit-equality with K3 and
    between runs, and K4's and K5's block timelines and occupancy."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize_cuda as rc
    csrc = os.path.dirname(rc.SOURCES["fwd"])
    design = design_of(csrc, LIST_DESIGNS)
    dev = torch.device("cuda")
    frames = {c: _list_frame(dev, *LIST_CASES[c]) for c in case_names}
    recs = {(k, c): {"root": root, "design": design, "kernel": k, "case": c}
            for k in ("K3", "K4", "K5") for c in case_names}
    with tempfile.TemporaryDirectory() as tmp:
        _use(rc, patched_csrc(csrc, os.path.join(tmp, "whole"), {}))
        runners = _list_runners(rc, frames)
        for c in case_names:
            ref = runners["K3"][c]()
            for k in ("K4", "K5"):
                a, b = runners[k][c](), runners[k][c]()
                nat = (lambda x: x[frames[c]["inv"]]) if k == "K4" else \
                    (lambda x: x)
                recs[(k, c)]["equal_to_K3"] = bool(torch.equal(nat(a), ref))
                recs[(k, c)]["runs_equal"] = bool(torch.equal(a, b))
                recs[(k, c)]["max_abs_vs_K3"] = float(
                    (nat(a) - ref).abs().max())
            for k in ("K3", "K4", "K5"):
                recs[(k, c)]["ms"] = _median_ms(runners[k][c], reps)
            log(json.dumps(recs[("K3", c)]))
        keep = False
        for line in rc.build_log.splitlines():
            if "Compiling entry" in line:
                keep = "composite_lists" in line or "tile_order" in line
            if keep and any(w in line for w in ("Compiling entry",
                                                "registers", "spill")):
                log(f"ptxas: {line.strip()}")
        for kernel, copies in LIST_DESIGNS[design].items():
            _use(rc, patched_csrc(csrc, os.path.join(tmp, kernel),
                                  copies["stamps"]))
            for case, fn in _list_runners(rc, frames)[kernel].items():
                rec = recs[(kernel, case)]
                _, rec["timeline"] = _stamps(rc, "v1", fn)
                rec["stamped ms"] = _median_ms(fn, reps)
                f = frames[case]
                lib = rc._library("v1")
                lib.ga_occupancy.argtypes = [ctypes.c_int] * 4 + \
                    [ctypes.c_void_p] * 2
                blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
                err = lib.ga_occupancy(
                    int(kernel[1]), f["P"], f["chunk"],
                    f["group4"] if kernel == "K4" else f["group5"],
                    ctypes.byref(blocks), ctypes.byref(clusters))
                if err:
                    raise RuntimeError(f"occupancy query: error {err}")
                rec["blocks_per_sm"] = blocks.value
                rec["active_clusters"] = clusters.value
                if kernel == "K4" and design == "cluster":
                    rec["cluster"] = rc.cluster_size(
                        f["group4"], rc.cluster_limit(f["P"], f["chunk"]))
            for case in case_names:
                log(json.dumps(recs[(kernel, case)]))
                if out:
                    with open(out, "a") as f:
                        f.write(json.dumps(recs[(kernel, case)]) + "\n")
    return list(recs.values())


def main(argv=None, log=print):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose kernels to measure (default: this)")
    ap.add_argument("--cases", nargs="+", default=[*CASES, *LIST_CASES],
                    choices=[*CASES, *LIST_CASES])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the lines here")
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
        if a.out:
            args += ["--out", a.out]
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
    lists = [c for c in a.cases if c in LIST_CASES]
    if train:
        recs += measure(root, train, a.reps, log, a.out)
    if lists:
        recs += measure_lists(root, lists, a.reps, log, a.out)
    return recs


if __name__ == "__main__":
    main()
