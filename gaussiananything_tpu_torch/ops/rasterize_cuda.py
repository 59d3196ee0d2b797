"""K1, the hand-written Hopper forward compositor, and its wrapper.

Replaces the TPU kernel `_make_v4_kernel(dma=False)`
(`gaussiananything_tpu/ops/rasterize_pallas.py:806`, driven by
`rasterize_tiled_v4`). The CUDA source, with the design note on what bounds
it, is `csrc/rasterize_v4.cu`. It is compiled with `nvcc` for `sm_90a` into
a shared library with a plain C interface at first use (into
`csrc/build/`, which git ignores) and loaded with ctypes.

`composite` takes the plain version (`rasterize.composite_plain`) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from gaussiananything_tpu_torch.ops import rasterize as rz

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
SOURCE = os.path.join(_CSRC, "rasterize_v4.cu")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output of this process's build (ptxas -v)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: K1 is built from "
                           f"{SOURCE} with the CUDA toolkit")
    return path


def build() -> str:
    """Compile `csrc/rasterize_v4.cu` if no library of this source exists;
    returns the library path. The file name carries the source hash, and
    the library is written under a temporary name and renamed, so
    concurrent builders never load a half-written file."""
    global build_log
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"librasterize_v4_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE}:\n{build_log}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.ga_composite_v4.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                + [ctypes.c_void_p, ctypes.c_void_p])
            lib.ga_composite_v4.restype = ctypes.c_int
            _lib = lib
    return _lib


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


def composite(tab: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
              counts: torch.Tensor, bg: torch.Tensor, img_h: int, img_w: int,
              tile: int = 16, chunk: int = 256) -> torch.Tensor:
    """K1: composite every tile's depth-ordered pair segment; returns the
    (N_OUT, img_h, img_w) buffer of `rasterize.OUT_CHANNELS`.

    Inputs as for `rasterize.composite_plain`: tab (N, TABLE_W) float32
    splat table, pairs/starts/counts int32 from `build_tile_pairs`, bg (3,)
    float32. CPU tensors take the plain version; CUDA tensors launch the
    kernel (one block per 16×16 tile) and count one launch.
    """
    if tab.device.type == "cpu":
        return rz.composite_plain(tab, pairs, starts, counts, bg, img_h,
                                  img_w, tile=tile, chunk=chunk)
    if tile != 16:
        raise ValueError(f"K1 runs 16x16 tiles, got tile={tile}")
    if not 1 <= chunk <= 256:
        raise ValueError(f"K1 stages at most 256 splats a chunk, got {chunk}")
    if img_h % tile or img_w % tile:
        raise ValueError(f"image {img_h}x{img_w} is not a multiple of 16")
    tiles_x, tiles_y = img_w // tile, img_h // tile
    _check(tab, "tab", torch.float32)
    if tab.dim() != 2 or tab.shape[1] != rz.TABLE_W:
        raise ValueError(f"tab must be (N, {rz.TABLE_W}), got "
                         f"{tuple(tab.shape)}")
    _check(pairs, "pairs", torch.int32)
    _check(starts, "starts", torch.int32, (tiles_x * tiles_y,))
    _check(counts, "counts", torch.int32, (tiles_x * tiles_y,))
    _check(bg, "bg", torch.float32, (3,))
    for t, name in ((pairs, "pairs"), (starts, "starts"), (counts, "counts"),
                    (bg, "bg")):
        if t.device != tab.device:
            raise ValueError(f"{name} is on {t.device}, tab on {tab.device}")
    out = torch.empty((rz.N_OUT, img_h, img_w), dtype=torch.float32,
                      device=tab.device)
    stream = torch.cuda.current_stream(tab.device).cuda_stream
    err = _library().ga_composite_v4(
        tab.data_ptr(), pairs.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), bg.data_ptr(), tiles_x, tiles_y, chunk,
        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    composite.launches += 1
    return out


composite.launches = 0
