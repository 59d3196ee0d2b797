"""The hand-written Hopper compositors and their wrappers.

  * K1 (`composite`), forward only: replaces the TPU kernel
    `_make_v4_kernel(dma=False)`
    (`gaussiananything_tpu/ops/rasterize_pallas.py:806`, driven by
    `rasterize_tiled_v4`). Source `csrc/rasterize_v4.cu`.
  * K2a and K2b (`composite_train`, a `torch.autograd.Function`): the
    training pair, replacing `_v4_fwd_entries_kernel` (`:1280`) and
    `_v4_bwd_kernel` (`:1306`), driven there by `rasterize_tiled_v4_train`
    (`:1559`). K2a is K1 plus each executed chunk's entry state and the
    slots each warp blends (same source, another instantiation); K2b
    (`csrc/rasterize_v4_bwd.cu`) walks the executed chunks in reverse over
    those slots and returns the cotangent of the splat table.
  * K6 (`composite_segments`), forward only: replaces
    `_make_v4_kernel(dma=True)` (`dma_kernel`, `:966`, driven by
    `rasterize_tiled_v4_dma`, `:1147`): K1's arithmetic on slices of one
    segment-ordered table that the kernel copies into shared memory
    asynchronously. Source `csrc/rasterize_v4_seg.cu`; it shares
    `csrc/composite_v4.cuh` with K1 and K2a.
  * K3, K4, K5 (`composite_lists`, `composite_lists_grouped`,
    `composite_lists_unrolled`), forward only: the dense-list kernels
    `_make_kernel` (`:59`), `_make_grouped_kernel` (`:346`) and
    `_make_unrolled_kernel` (`:555`); K4 launches a thread-block cluster
    per group (`cluster_size`, `cluster_limit`). `stage` launches the
    stage-cut instantiations, the counterparts of `make_kernel(stage)` in
    `tools/pallas_bisect.py:25` and `tools/pallas_bisect2.py:30`, each
    group one cluster (`stage_clusters`). Source `csrc/rasterize_v1.cu`.

The design notes on what bounds each kernel are in the CUDA sources. Each
source is compiled with `nvcc` for `sm_90a` into a shared library with a
plain C interface at first use (into `csrc/build/`, which git ignores) and
loaded with ctypes; the sources build in parallel.

The wrappers take the plain versions (`rasterize.composite_plain`,
`rasterize.composite_plain_backward`, `rasterize.composite_segments_plain`,
`rasterize.composite_lists_plain`, `rasterize.stage_plain`) only for tensors
on the CPU; for CUDA tensors they launch the kernels or raise. Each wrapper
counts its launches in its `launches` attribute.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

import torch

from gaussiananything_tpu_torch.ops import rasterize as rz

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
SOURCES = {"fwd": os.path.join(_CSRC, "rasterize_v4.cu"),       # K1, K2a
           "bwd": os.path.join(_CSRC, "rasterize_v4_bwd.cu"),   # K2b
           "seg": os.path.join(_CSRC, "rasterize_v4_seg.cu"),   # K6
           "v1": os.path.join(_CSRC, "rasterize_v1.cu")}  # K3-K5, stages
HEADERS = [os.path.join(_CSRC, "composite_v4.cuh")]
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# rows a kernel stages per chunk
MAX_CHUNK = {"fwd": 256, "bwd": 128, "seg": 256, "v1": 256}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log = ""          # nvcc's output of this process's builds (ptxas -v)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the kernels are built from "
                           f"{_CSRC} with the CUDA toolkit")
    return path


def build() -> Dict[str, str]:
    """Compile every source of `SOURCES` that has no library yet, all at
    once (one `nvcc` process each); returns {name: library path}. A file
    name carries the hash of its source, the headers and the flags, and a
    library is written under a
    temporary name and renamed, so concurrent builds never load a
    half-written file."""
    global build_log
    paths, running = {}, []
    shared = " ".join(NVCC_FLAGS).encode()
    for header in HEADERS:
        with open(header, "rb") as f:
            shared += f.read()
    for name, source in SOURCES.items():
        with open(source, "rb") as f:
            digest = hashlib.sha256(f.read() + shared).hexdigest()[:16]
        stem = os.path.splitext(os.path.basename(source))[0]
        paths[name] = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
        if os.path.exists(paths[name]):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError:     # nvcc did not start: leave nothing behind
            os.remove(tmp)
            for _, _, other_tmp, other in running:
                other.kill()
                other.communicate()
                os.remove(other_tmp)
            raise
        running.append((name, source, tmp, proc))
    failed = []
    for name, source, tmp, proc in running:
        log = proc.communicate()[0]
        build_log += log
        if proc.returncode == 0:
            os.replace(tmp, paths[name])
        else:
            os.remove(tmp)
            failed.append(f"nvcc failed for {source}:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        if not _libs:
            ptr, i = ctypes.c_void_p, ctypes.c_int
            paths = build()
            fwd = ctypes.CDLL(paths["fwd"])
            fwd.ga_composite_v4.argtypes = [ptr] * 5 + [i] * 4 + [ptr] * 2
            fwd.ga_composite_v4.restype = i
            fwd.ga_composite_v4_train.argtypes = \
                [ptr] * 5 + [i] * 4 + [ptr] * 7
            fwd.ga_composite_v4_train.restype = i
            fwd.ga_tile_order.argtypes = [ptr] * 2 + [i] * 2 + [ptr] * 3
            fwd.ga_tile_order.restype = i
            bwd = ctypes.CDLL(paths["bwd"])
            bwd.ga_composite_v4_bwd.argtypes = \
                [ptr] * 11 + [i] * 4 + [ptr] * 3 + [i] + [ptr] * 2
            bwd.ga_composite_v4_bwd.restype = i
            seg = ctypes.CDLL(paths["seg"])
            seg.ga_composite_v4_seg.argtypes = \
                [ptr] * 4 + [i] * 4 + [ptr] * 2
            v1 = ctypes.CDLL(paths["v1"])
            v1.ga_composite_lists.argtypes = [ptr] * 4 + [i] * 7 + [ptr] * 2
            v1.ga_composite_lists_unrolled.argtypes = \
                [ptr] * 4 + [i] * 7 + [ptr] * 2
            v1.ga_composite_lists_grouped.argtypes = \
                [ptr] * 6 + [i] * 6 + [ptr] * 2
            v1.ga_stage.argtypes = [i] * 2 + [ptr] * 5 + [i] * 5 + [ptr] * 2
            v1.ga_grouped_clusters.argtypes = [i] * 3
            v1.ga_stage_clusters.argtypes = [i] * 5
            for fn in (seg.ga_composite_v4_seg, v1.ga_composite_lists,
                       v1.ga_composite_lists_unrolled,
                       v1.ga_composite_lists_grouped, v1.ga_stage,
                       v1.ga_grouped_clusters, v1.ga_stage_clusters):
                fn.restype = i
            _libs.update(fwd=fwd, bwd=bwd, seg=seg, v1=v1)
    return _libs[name]


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_frame(tab, pairs, starts, counts, bg, img_h, img_w, tile, chunk,
                 kernel: str):
    """Raise on what the kernels do not take; returns (tiles_x, tiles_y).
    `pairs` is None for K6, whose table is already in pair order."""
    if tile != 16:
        raise ValueError(f"the kernels run 16x16 tiles, got tile={tile}")
    if not 1 <= chunk <= MAX_CHUNK[kernel]:
        raise ValueError(f"the kernel stages at most {MAX_CHUNK[kernel]} "
                         f"splats a chunk, got {chunk}")
    if img_h % tile or img_w % tile:
        raise ValueError(f"image {img_h}x{img_w} is not a multiple of 16")
    tiles_x, tiles_y = img_w // tile, img_h // tile
    _check(tab, "tab", torch.float32)
    if tab.dim() != 2 or tab.shape[1] != rz.TABLE_W:
        raise ValueError(f"tab must be (N, {rz.TABLE_W}), got "
                         f"{tuple(tab.shape)}")
    if pairs is not None:
        _check(pairs, "pairs", torch.int32)
    _check(starts, "starts", torch.int32, (tiles_x * tiles_y,))
    _check(counts, "counts", torch.int32, (tiles_x * tiles_y,))
    _check(bg, "bg", torch.float32, (3,))
    for t, name in ((pairs, "pairs"), (starts, "starts"), (counts, "counts"),
                    (bg, "bg")):
        if t is not None and t.device != tab.device:
            raise ValueError(f"{name} is on {t.device}, tab on {tab.device}")
    return tiles_x, tiles_y


# When a list, every launch appends (kernel name, start event, end event),
# CUDA events around the launch on the current stream: a caller sums
# `start.elapsed_time(end)` after a synchronise for the kernels' device time
# inside a larger run.
event_log = None


@contextlib.contextmanager
def _logged(kernel: str):
    log = event_log
    if log is None:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    log.append((kernel, start, end))


def _raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def composite(tab: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
              counts: torch.Tensor, bg: torch.Tensor, img_h: int, img_w: int,
              tile: int = 16, chunk: int = 256, row0: int = 0
              ) -> torch.Tensor:
    """K1: composite every tile's depth-ordered pair segment; returns the
    (N_OUT, img_h, img_w) buffer of `rasterize.OUT_CHANNELS`.

    Inputs as for `rasterize.composite_plain`: tab (N, TABLE_W) float32
    splat table, pairs/starts/counts int32 from `build_tile_pairs`, bg (3,)
    float32; `row0` is the image row of the buffer's first row (a band of
    a taller image, the table built against the whole image). CPU tensors
    take the plain version; CUDA tensors launch the kernel (one block per
    16×16 tile) and count one launch. Forward only.
    """
    if tab.device.type == "cpu":
        return rz.composite_plain(tab, pairs, starts, counts, bg, img_h,
                                  img_w, tile=tile, chunk=chunk, row0=row0)
    tab = tab.detach()
    tiles_x, tiles_y = _check_frame(tab, pairs, starts, counts, bg, img_h,
                                    img_w, tile, chunk, "fwd")
    out = torch.empty((rz.N_OUT, img_h, img_w), dtype=torch.float32,
                      device=tab.device)
    stream = torch.cuda.current_stream(tab.device).cuda_stream
    with _logged("K1"):
        _raise_on(_library("fwd").ga_composite_v4(
            tab.data_ptr(), pairs.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), bg.data_ptr(), tiles_x, tiles_y, chunk, row0,
            out.data_ptr(), stream), "K1")
    composite.launches += 1
    return out


composite.launches = 0


def composite_entries(tab: torch.Tensor, pairs: torch.Tensor,
                      starts: torch.Tensor, counts: torch.Tensor,
                      bg: torch.Tensor, img_h: int, img_w: int,
                      tile: int = 16, chunk: int = 128, row0: int = 0):
    """K2a: K1's buffer, plus what the backward needs (CUDA tensors).
    Returns (buf (N_OUT, img_h, img_w), chunk_off (n_tiles + 1,) int32,
    entries (rows, 4, 256) float32, n_exec (n_tiles,) int32, marks
    (rows, 8, 4) int32), as `rasterize.chunk_offsets` and its plain version
    `rasterize.composite_plain(..., return_entries=True)` define them:
    entries' and marks' first `chunk_off[-1]` rows are the plain
    version's, and `rows` is `rasterize.max_entry_rows`, a bound from the
    shapes alone, so the host never waits for the card. Launches the
    kernel (which orders the tiles heaviest first and writes `chunk_off`
    itself) and counts one launch. `row0` as for `composite`.
    """
    tiles_x, tiles_y = _check_frame(tab, pairs, starts, counts, bg, img_h,
                                    img_w, tile, chunk, "bwd")
    n_tiles, dev = tiles_x * tiles_y, tab.device
    chunk_off = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)
    order = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    out = torch.empty((rz.N_OUT, img_h, img_w), dtype=torch.float32,
                      device=dev)
    # the kernel zeroes the rows of the chunks a saturated tile skips
    entries = torch.empty((rz.max_entry_rows(pairs.shape[0], n_tiles, chunk),
                           4, tile * tile), dtype=torch.float32, device=dev)
    n_exec = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    marks = torch.empty((entries.shape[0], tile * tile // 32, rz.MARK_WORDS),
                        dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _logged("K2a"):
        _raise_on(_library("fwd").ga_composite_v4_train(
            tab.data_ptr(), pairs.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), bg.data_ptr(), tiles_x, tiles_y, chunk, row0,
            out.data_ptr(), order.data_ptr(), chunk_off.data_ptr(),
            entries.data_ptr(), n_exec.data_ptr(), marks.data_ptr(),
            stream), "K2a")
    composite_entries.launches += 1
    return out, chunk_off, entries, n_exec, marks


composite_entries.launches = 0


def splat_order(pairs: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, n_splats: int):
    """(order, seg) int32 for K2b's splat-space sum: the pair positions some
    tile reads (`starts[t] <= i < starts[t] + counts[t]`), sorted stably by
    splat id, and splat s's run `order[seg[s]:seg[s + 1]]`. Positions no
    tile reads (padding, pairs beyond a tile's cap) sort behind the last
    splat: the binning parks thousands of them on splat 0, whose serial
    sum would otherwise take milliseconds."""
    n = pairs.shape[0]
    edge = torch.zeros(n + 1, dtype=torch.int32, device=pairs.device)
    ones = torch.ones_like(starts)
    edge.index_add_(0, starts.long(), ones)
    edge.index_add_(0, (starts + counts).long(), -ones)
    live = torch.cumsum(edge[:n], 0) > 0
    key = torch.where(live, pairs, torch.full_like(pairs, n_splats))
    sorted_ids, order = torch.sort(key, stable=True)
    seg = torch.searchsorted(
        sorted_ids, torch.arange(n_splats + 1, dtype=pairs.dtype,
                                 device=pairs.device))
    return order.int(), seg.int()


def composite_backward(tab: torch.Tensor, pairs: torch.Tensor,
                       starts: torch.Tensor, counts: torch.Tensor,
                       bg: torch.Tensor, ct_buf: torch.Tensor,
                       chunk_off: torch.Tensor, entries: torch.Tensor,
                       n_exec: torch.Tensor, marks: torch.Tensor,
                       order: torch.Tensor, seg: torch.Tensor, img_h: int,
                       img_w: int, tile: int = 16, chunk: int = 128,
                       row0: int = 0) -> torch.Tensor:
    """K2b: the cotangent of `tab` (N, TABLE_W) given the cotangent `ct_buf`
    (N_OUT, img_h, img_w) of the forward's buffer, from what
    `composite_entries` and `splat_order` returned for the same frame
    (CUDA tensors). Launches the kernel (pass A over the tiles, heaviest
    first, visiting only the slots K2a marked; then pass B over the
    splats) and counts one launch. No float atomics: equal inputs give
    bit-equal gradients. `row0` as for `composite`. Its plain version is
    `rasterize.composite_plain_backward`, which `composite_train` takes for
    CPU tensors.
    """
    tiles_x, tiles_y = _check_frame(tab, pairs, starts, counts, bg, img_h,
                                    img_w, tile, chunk, "bwd")
    n_tiles, n_splats = tiles_x * tiles_y, tab.shape[0]
    ct_buf = ct_buf.contiguous()
    _check(ct_buf, "ct_buf", torch.float32, (rz.N_OUT, img_h, img_w))
    _check(chunk_off, "chunk_off", torch.int32, (n_tiles + 1,))
    _check(entries, "entries", torch.float32)
    _check(n_exec, "n_exec", torch.int32, (n_tiles,))
    _check(marks, "marks", torch.int32,
           (entries.shape[0], tile * tile // 32, rz.MARK_WORDS))
    _check(order, "order", torch.int32, tuple(pairs.shape))
    _check(seg, "seg", torch.int32, (n_splats + 1,))
    dev = tab.device
    # the kernel writes every row a tile reads; pass B reads no other
    d_pairs = torch.empty((pairs.shape[0], rz.TABLE_W), dtype=torch.float32,
                          device=dev)
    d_tab = torch.empty_like(tab)
    tiles = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _logged("K2b"):
        _raise_on(_library("bwd").ga_composite_v4_bwd(
            tab.data_ptr(), pairs.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), bg.data_ptr(), tiles.data_ptr(),
            chunk_off.data_ptr(), entries.data_ptr(), n_exec.data_ptr(),
            marks.data_ptr(), ct_buf.data_ptr(), tiles_x, tiles_y, chunk,
            row0, d_pairs.data_ptr(), order.data_ptr(), seg.data_ptr(), n_splats,
            d_tab.data_ptr(), stream), "K2b")
    composite_backward.launches += 1
    return d_tab


composite_backward.launches = 0


class _CompositeTrain(torch.autograd.Function):
    """K2a forward, K2b backward, for CUDA tensors. Differentiable in `tab`
    only: the pair lists are indices and `bg` is a constant of the training
    renders."""

    @staticmethod
    def forward(ctx, tab, pairs, starts, counts, bg, img_h, img_w, tile,
                chunk, row0):
        tab = tab.contiguous()
        buf, *extras = composite_entries(tab, pairs, starts, counts, bg,
                                         img_h, img_w, tile=tile, chunk=chunk,
                                         row0=row0)
        ctx.save_for_backward(tab, pairs, starts, counts, bg, *extras,
                              *splat_order(pairs, starts, counts,
                                           tab.shape[0]))
        ctx.frame = (img_h, img_w, tile, chunk, row0)
        return buf

    @staticmethod
    def backward(ctx, ct_buf):
        img_h, img_w, tile, chunk, row0 = ctx.frame
        # read once: under a checkpointed render each read unpacks anew,
        # which `torch.utils.checkpoint` refuses
        saved = ctx.saved_tensors
        d_tab = composite_backward(*saved[:5], ct_buf, *saved[5:], img_h,
                                   img_w, tile=tile, chunk=chunk, row0=row0)
        return (d_tab,) + (None,) * 9


def composite_train(tab: torch.Tensor, pairs: torch.Tensor,
                    starts: torch.Tensor, counts: torch.Tensor,
                    bg: torch.Tensor, img_h: int, img_w: int, tile: int = 16,
                    chunk: int = 128, row0: int = 0) -> torch.Tensor:
    """`composite` for training: the same buffer, differentiable with
    respect to `tab`. CUDA tensors launch K2a forward and K2b backward; CPU
    tensors take the plain pair (`rasterize.composite_plain_train`).
    `row0` as for `composite`."""
    if tab.device.type == "cpu":
        return rz.composite_plain_train(tab, pairs, starts, counts, bg,
                                        img_h, img_w, tile=tile, chunk=chunk,
                                        row0=row0)
    return _CompositeTrain.apply(tab, pairs, starts, counts, bg, img_h,
                                 img_w, tile, chunk, row0)


def composite_segments(seg: torch.Tensor, starts: torch.Tensor,
                       counts: torch.Tensor, bg: torch.Tensor, img_h: int,
                       img_w: int, tile: int = 16, chunk: int = 128,
                       row0: int = 0) -> torch.Tensor:
    """K6: K1's buffer from the segment-ordered table.

    seg (L, TABLE_W) float32 from `rasterize.segment_table` (row i is the
    splat at pair position i; tile t's rows start at `starts[t]`), starts
    and counts int32 from `build_tile_pairs`, bg (3,) float32; `row0` is
    the image row of the buffer's first row. Returns (N_OUT, img_h, img_w).
    CPU tensors take `rasterize.composite_segments_plain`; CUDA tensors
    launch the kernel (one block per 16x16 tile, the next chunk's rows
    copied asynchronously while this one is composited) and count one
    launch. The kernel reads rows starts[t] .. starts[t] + counts[t] of
    `seg` and no others, so the table needs no trailing padding. Forward
    only.
    """
    if seg.device.type == "cpu":
        return rz.composite_segments_plain(seg, starts, counts, bg, img_h,
                                           img_w, tile=tile, chunk=chunk,
                                           row0=row0)
    seg = seg.detach()
    tiles_x, tiles_y = _check_frame(seg, None, starts, counts, bg, img_h,
                                    img_w, tile, chunk, "seg")
    out = torch.empty((rz.N_OUT, img_h, img_w), dtype=torch.float32,
                      device=seg.device)
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    with _logged("K6"):
        _raise_on(_library("seg").ga_composite_v4_seg(
            seg.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            bg.data_ptr(), tiles_x, tiles_y, chunk, row0, out.data_ptr(),
            stream), "K6")
    composite_segments.launches += 1
    return out


composite_segments.launches = 0


def _check_lists(geom, feat, n_tiles, chunk, tile=None, P=None):
    """Raise on what the list kernels do not take; returns max_per_tile."""
    if tile is not None and tile not in (8, 16):
        raise ValueError(f"the list kernels run 8x8 or 16x16 tiles, got "
                         f"tile={tile}")
    if P is not None and P not in (64, 256):
        raise ValueError(f"the list kernels run 64 or 256 pixels a tile, got "
                         f"{P}")
    if not 1 <= chunk <= MAX_CHUNK["v1"]:
        raise ValueError(f"the kernel stages at most {MAX_CHUNK['v1']} "
                         f"splats a chunk, got {chunk}")
    _check(geom, "geom", torch.float32)
    if geom.dim() != 3 or geom.shape[0] != n_tiles \
            or geom.shape[2] != rz.GEOM_W:
        raise ValueError(f"geom must be ({n_tiles}, M, {rz.GEOM_W}), got "
                         f"{tuple(geom.shape)}")
    M = geom.shape[1]
    _check(feat, "feat", torch.float32, (n_tiles, M, rz.FEAT_W))
    if feat.device != geom.device:
        raise ValueError(f"feat is on {feat.device}, geom on {geom.device}")
    if geom.data_ptr() % 16 or feat.data_ptr() % 16:
        raise ValueError("the kernels read geom and feat as 16-byte rows: "
                         "both must be 16-byte aligned")
    if M % chunk:
        raise ValueError("max_per_tile must be a multiple of chunk")
    return M


def _composite_natural(wrapper, kernel, geom, feat, counts, tiles_x, tile,
                       chunk, row0, with_aux=False, group=None):
    """K3 (`group` None) or K5 on tiles in natural order: the plain version
    for CPU tensors, else one launch, counted on `wrapper`, whose blocks
    take the tiles heaviest first. Returns (T, tile², LIST_OUT_W)."""
    n_tiles = counts.shape[0]
    if group is not None and (group < 1 or n_tiles % group):
        raise ValueError(f"{n_tiles} tiles are not a multiple of the group "
                         f"{group}")
    if geom.device.type == "cpu":
        px, py = rz.tile_pixel_tables(torch.arange(n_tiles), tiles_x, tile,
                                      row0)
        return rz.composite_lists_plain(geom, feat, counts, px, py, chunk,
                                        with_aux=with_aux)
    M = _check_lists(geom, feat, n_tiles, chunk, tile=tile)
    _check(counts, "counts", torch.int32, (n_tiles,))
    out = torch.empty((n_tiles, tile * tile, rz.LIST_OUT_W),
                      dtype=torch.float32, device=geom.device)
    # the tiles by descending count, which the launch writes
    order = torch.empty(n_tiles, dtype=torch.int32, device=geom.device)
    stream = torch.cuda.current_stream(geom.device).cuda_stream
    lib = _library("v1")
    with _logged(kernel):
        if group is None:
            err = lib.ga_composite_lists(
                geom.data_ptr(), feat.data_ptr(), counts.data_ptr(),
                order.data_ptr(), n_tiles, M, tiles_x, tile, chunk, row0,
                int(with_aux), out.data_ptr(), stream)
        else:
            err = lib.ga_composite_lists_unrolled(
                geom.data_ptr(), feat.data_ptr(), counts.data_ptr(),
                order.data_ptr(), n_tiles, M, tiles_x, tile, chunk, group,
                row0, out.data_ptr(), stream)
        _raise_on(err, kernel)
    wrapper.launches += 1
    return out


def composite_lists(geom: torch.Tensor, feat: torch.Tensor,
                    counts: torch.Tensor, tiles_x: int, tile: int,
                    chunk: int, row0: int = 0, with_aux: bool = False
                    ) -> torch.Tensor:
    """K3: composite every tile's dense list, one block per tile, the
    tiles heaviest first, each leaving once its tile is saturated.

    geom (T, M, GEOM_W), feat (T, M, FEAT_W) float32 from
    `rasterize.pack_tile_inputs`, counts (T,) int32; tile t covers the
    `tile`-square at column t % tiles_x, row t // tiles_x, offset by `row0`
    image rows. Returns (T, tile², LIST_OUT_W); dist (channel 6) is 0
    unless `with_aux`. CPU tensors take `rasterize.composite_lists_plain`;
    CUDA tensors launch the kernel and count one launch. Forward only.
    """
    return _composite_natural(composite_lists, "K3", geom, feat, counts,
                              tiles_x, tile, chunk, row0, with_aux=with_aux)


composite_lists.launches = 0


def composite_lists_unrolled(geom: torch.Tensor, feat: torch.Tensor,
                             counts: torch.Tensor, tiles_x: int, tile: int,
                             chunk: int, group: int, row0: int = 0
                             ) -> torch.Tensor:
    """K5: as `composite_lists` without the distortion and without the
    saturation exit: every tile walks every chunk below its count. The
    reference's unit of `group` consecutive tiles stays in the contract
    (`group` divides T) but no longer shares a block: one block per tile,
    the heaviest tiles first, each chunk's rows copied asynchronously while
    the block walks the one before. CPU tensors take
    `rasterize.composite_lists_plain`; CUDA tensors launch the kernel and
    count one launch."""
    return _composite_natural(composite_lists_unrolled, "K5", geom, feat,
                              counts, tiles_x, tile, chunk, row0, group=group)


composite_lists_unrolled.launches = 0


CLUSTER_MAX = 16     # the largest thread-block cluster Hopper schedules


def cluster_size(group: int, limit: int) -> int:
    """K4's cluster: the largest divisor of `group` not above `limit`, the
    largest cluster the card schedules (at most CLUSTER_MAX)."""
    return max(d for d in range(1, min(group, limit) + 1) if group % d == 0)


_cluster_limits: Dict[tuple, int] = {}


def cluster_limit(P: int, chunk: int) -> int:
    """The largest cluster of K4 blocks of P threads at `chunk`, up to
    CLUSTER_MAX, of which the card holds at least one at a time
    (`cudaOccupancyMaxActiveClusters`); raises where it holds none."""
    lib = _library("v1")
    key = (id(lib), P, chunk)
    if key not in _cluster_limits:
        for size in range(CLUSTER_MAX, 0, -1):
            n = lib.ga_grouped_clusters(size, P, chunk)
            _raise_on(max(-n, 0), "K4")
            if n > 0:
                _cluster_limits[key] = size
                break
        else:
            raise RuntimeError(f"the card schedules no cluster of K4 blocks "
                               f"of {P} threads at chunk {chunk}")
    return _cluster_limits[key]


def composite_lists_grouped(gmax: torch.Tensor, geom: torch.Tensor,
                            feat: torch.Tensor, px: torch.Tensor,
                            py: torch.Tensor, cnt: torch.Tensor, group: int,
                            chunk: int) -> torch.Tensor:
    """K4: composite count-sorted groups of `group` tiles, chunk by chunk
    below the group's largest count while some pixel of the group stands
    above T_EPS.

    The tiles come in the caller's (count-sorted) order: gmax (T / group,)
    int32 largest count of each group, geom and feat as for
    `composite_lists`, px and py (T, P) float32 pixel coordinates
    (`rasterize.tile_pixel_tables`), cnt (T, 1) float32 counts. Returns
    (T, P, LIST_OUT_W) in the same order, dist 0. CPU tensors take
    `rasterize.composite_lists_plain`; CUDA tensors launch the kernel and
    count one launch.

    On the card a tile is a block and a group a thread-block cluster of
    `cluster_size(group, cluster_limit(P, chunk))` blocks: the whole group
    for every group up to 16. A larger group runs its group test per
    cluster, which gives the same maps: a chunk that one part skips and
    another runs has all of the skipping part's pairs masked or pruned
    (`tests/test_torch_list_groups.py` holds the plain twin of that walk).
    """
    n_tiles, P = px.shape
    if group < 1 or n_tiles % group:
        raise ValueError(f"{n_tiles} tiles are not a multiple of the group "
                         f"{group}")
    if geom.device.type == "cpu":
        return rz.composite_lists_plain(geom, feat, cnt[:, 0].int(), px, py,
                                        chunk)
    M = _check_lists(geom, feat, n_tiles, chunk, P=P)
    _check(gmax, "gmax", torch.int32, (n_tiles // group,))
    _check(px, "px", torch.float32, (n_tiles, P))
    _check(py, "py", torch.float32, (n_tiles, P))
    _check(cnt, "cnt", torch.float32, (n_tiles, 1))
    lib = _library("v1")
    cluster = cluster_size(group, cluster_limit(P, chunk))
    out = torch.empty((n_tiles, P, rz.LIST_OUT_W), dtype=torch.float32,
                      device=geom.device)
    stream = torch.cuda.current_stream(geom.device).cuda_stream
    with _logged("K4"):
        _raise_on(lib.ga_composite_lists_grouped(
            gmax.data_ptr(), geom.data_ptr(), feat.data_ptr(), px.data_ptr(),
            py.data_ptr(), cnt.data_ptr(), n_tiles, group, cluster, P, M,
            chunk, out.data_ptr(), stream), "K4")
    composite_lists_grouped.launches += 1
    return out


composite_lists_grouped.launches = 0


_stage_cluster_counts: Dict[tuple, int] = {}


def stage_clusters(stage_id: int, field_major: bool, group: int, P: int,
                   chunk: int) -> int:
    """How many clusters of `group` blocks of the stage kernel (P threads
    at `chunk`) the card holds at once (`cudaOccupancyMaxActiveClusters`):
    0 where it schedules no such cluster, above CLUSTER_MAX blocks among
    them."""
    lib = _library("v1")
    key = (id(lib), stage_id, bool(field_major), group, P, chunk)
    if key not in _stage_cluster_counts:
        n = lib.ga_stage_clusters(stage_id, int(field_major), group, P, chunk)
        _raise_on(max(-n, 0), "stage")
        _stage_cluster_counts[key] = n
    return _stage_cluster_counts[key]


def stage(stage_id: int, gmax: torch.Tensor, geom: torch.Tensor,
          feat: torch.Tensor, px: torch.Tensor, py: torch.Tensor, group: int,
          chunk: int, field_major: bool = False) -> torch.Tensor:
    """K4 cut off after stage `stage_id` (0..3), on row-major or
    field-major inputs: shapes and result as `rasterize.stage_plain`, which
    CPU tensors take. CUDA tensors launch the instantiation, a block per
    tile and each group of `group` tiles ONE thread-block cluster, and
    count one launch in `stage.launches[(stage_id, field_major)]`.

    The kernels have no prune, so a saturated tile whose group is live
    walks on and its sums show it: the group test cannot be split per tile
    or per part of a group. A `group` the card does not schedule as one
    cluster at this P and chunk (above CLUSTER_MAX, or too large for its
    occupancy; `stage_clusters`) raises ValueError before the launch, as
    does a field-major chunk that is not a multiple of 4 rows (each field's
    run of the chunk is one 16-byte aligned bulk copy)."""
    if stage_id not in (0, 1, 2, 3):
        raise ValueError(f"stage must be 0..3, got {stage_id}")
    if geom.device.type == "cpu":
        return rz.stage_plain(stage_id, gmax, geom, feat, px, py, group,
                              chunk, field_major=field_major)
    if field_major:
        _, n_tiles, M = geom.shape
        P = px.shape[2]
        shapes = ((16, n_tiles, M), (8, n_tiles, M), (1, n_tiles, P),
                  (16, n_tiles, P))
    else:
        n_tiles, M, _ = geom.shape
        P = px.shape[1]
        shapes = ((n_tiles, M, 16), (n_tiles, M, 8), (n_tiles, P),
                  (n_tiles, P, 16))
    if group < 1 or n_tiles % group or M % chunk:
        raise ValueError(f"{n_tiles} tiles of {M} rows do not split into "
                         f"groups of {group} and chunks of {chunk}")
    if not 1 <= chunk <= MAX_CHUNK["v1"]:
        raise ValueError(f"the kernel stages at most {MAX_CHUNK['v1']} "
                         f"splats a chunk, got {chunk}")
    if field_major and chunk % 4:
        raise ValueError(f"field-major chunks are copied a field at a time "
                         f"in 16-byte runs: chunk must be a multiple of 4, "
                         f"got {chunk}")
    _check(geom, "geom", torch.float32, shapes[0])
    _check(feat, "feat", torch.float32, shapes[1])
    _check(px, "px", torch.float32, shapes[2])
    _check(py, "py", torch.float32, shapes[2])
    _check(gmax, "gmax", torch.int32, (n_tiles // group,))
    if geom.data_ptr() % 16 or feat.data_ptr() % 16:
        raise ValueError("the kernels copy geom and feat in 16-byte runs: "
                         "both must be 16-byte aligned")
    if stage_clusters(stage_id, field_major, group, P, chunk) < 1:
        raise ValueError(f"the card schedules no cluster of {group} blocks "
                         f"of {P} threads at chunk {chunk}: a group of the "
                         f"stage kernels runs as one cluster (at most "
                         f"{CLUSTER_MAX} blocks)")
    lib = _library("v1")
    out = torch.empty(shapes[3], dtype=torch.float32, device=geom.device)
    stream = torch.cuda.current_stream(geom.device).cuda_stream
    name = f"B{2 if field_major else 1}.{stage_id}"
    with _logged(name):
        _raise_on(lib.ga_stage(
            stage_id, int(field_major), gmax.data_ptr(), geom.data_ptr(),
            feat.data_ptr(), px.data_ptr(), py.data_ptr(), n_tiles, group, P,
            M, chunk, out.data_ptr(), stream), name)
    stage.launches[(stage_id, bool(field_major))] += 1
    return out


stage.launches = {(s, f): 0 for s in range(4) for f in (False, True)}
