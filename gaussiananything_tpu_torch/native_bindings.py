"""ctypes bindings for the repository's native mesh runtime (the port's own
copy of `gaussiananything_tpu/native_bindings.py`).

`native/surface_nets.cc` holds a surface-nets extractor, an OpenMP TSDF
integrate (the Open3D-on-CPU role of the reference's mesh export,
`nsr/lsgm/flow_matching_trainer.py:1319-1343`) and a binary PLY writer. The
port compiles it at first use with the flags of `native/Makefile` into
`gaussiananything_tpu_torch/native/build/` (git-ignored; `native/` itself
belongs to the JAX package's bindings). A failed build raises with the
compiler's message: there is no silent fallback. Only where no C++
compiler can be started at all does `library` raise `NativeUnavailable`,
which `render.ply_io.write_ply` alone catches to write with numpy. The
Python `render.tsdf.surface_nets` is the plain version the tests hold this
one to.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from gaussiananything_tpu_torch.ops import kernel_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "native", "surface_nets.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "native", "build")
# native/Makefile's CXXFLAGS, with -shared
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-fopenmp", "-shared"]

_LIB = None
_LOCK = threading.Lock()
build_log = ""


class NativeUnavailable(RuntimeError):
    """No C++ compiler could be started: the library cannot be built."""

_FP = ctypes.POINTER(ctypes.c_float)


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("model name")), "")
    except OSError:
        return ""


def _build() -> str:
    """The library in BUILD_DIR, keyed by the source, the flags and the
    host CPU (-march=native), built through `kernel_lib.compile_keyed`."""
    global build_log
    with open(SOURCE, "rb") as f:
        key = f.read() + " ".join(CXX_FLAGS).encode() + _cpu_model().encode()
    # $CXX as the Makefile takes it, then the g++ on PATH: a $CXX without
    # OpenMP's spec files cannot build it
    compilers = [[cxx, *CXX_FLAGS]
                 for cxx in dict.fromkeys([os.environ.get("CXX", "g++"),
                                           "g++"])]
    try:
        path, log = kernel_lib.compile_keyed(SOURCE, key, BUILD_DIR,
                                             "ganative", compilers)
    except FileNotFoundError as e:
        raise NativeUnavailable(str(e)) from e
    if log:
        build_log = log
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built at first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            lib.ga_surface_nets.restype = ctypes.c_int
            lib.ga_surface_nets.argtypes = [
                _FP, _FP, ctypes.c_int, ctypes.c_float, _FP, _FP,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            lib.ga_tsdf_integrate.restype = ctypes.c_int
            lib.ga_tsdf_integrate.argtypes = [
                _FP, _FP, _FP, _FP, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, _FP, _FP, _FP]
            lib.ga_write_ply.restype = ctypes.c_int
            lib.ga_write_ply.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int, _FP, ctypes.c_int64]
            _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def tsdf_integrate(depths: np.ndarray, colors: np.ndarray,
                   alphas: np.ndarray, cam_view: np.ndarray, tanfov: float,
                   resolution: int = 128, bound: float = 0.495,
                   trunc_voxels: float = 12.0, alpha_thres: float = 0.08
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host OpenMP TSDF fusion, the semantics of `render.tsdf.
    integrate_tsdf`: depths/alphas (V, 1, H, W), colors (V, 3, H, W),
    cam_view (V, 4, 4) row-vector → (tsdf (D,D,D), color (D,D,D,3))."""
    lib = library()
    D = resolution
    V, _, H, W = depths.shape
    dep = np.ascontiguousarray(depths.reshape(V, H, W), np.float32)
    alp = np.ascontiguousarray(alphas.reshape(V, H, W), np.float32)
    col = np.ascontiguousarray(colors, np.float32)
    cv = np.ascontiguousarray(cam_view, np.float32)
    tsdf = np.empty((D, D, D), np.float32)
    weight = np.empty((D, D, D), np.float32)
    color = np.empty((D, D, D, 3), np.float32)
    rc = lib.ga_tsdf_integrate(
        _ptr(dep), _ptr(col), _ptr(alp), _ptr(cv), V, H, W,
        ctypes.c_float(float(tanfov)), D, ctypes.c_float(bound),
        ctypes.c_float(trunc_voxels * 2 * bound / D),
        ctypes.c_float(alpha_thres), _ptr(tsdf), _ptr(weight), _ptr(color))
    if rc != 0:
        raise RuntimeError(f"ga_tsdf_integrate returned {rc}")
    return tsdf, color


def surface_nets(tsdf: np.ndarray, color: Optional[np.ndarray] = None,
                 bound: float = 0.495
                 ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Surface nets over a (D,D,D) SDF → (verts (N,3), faces (M,3) int32,
    vertex colors (N,3) or None)."""
    lib = library()
    D = tsdf.shape[0]
    tsdf_c = np.ascontiguousarray(tsdf, np.float32)
    col_c = None if color is None else np.ascontiguousarray(color,
                                                            np.float32)
    vert_cap = max(1024, 4 * D * D * 3)
    for _ in range(4):                 # grow and retry on a full buffer
        face_cap = 4 * vert_cap
        verts = np.empty((vert_cap, 3), np.float32)
        cols = np.empty((vert_cap, 3), np.float32)
        faces = np.empty((face_cap, 3), np.int32)
        nv, nf = ctypes.c_int64(), ctypes.c_int64()
        rc = lib.ga_surface_nets(
            _ptr(tsdf_c), None if col_c is None else _ptr(col_c), D,
            ctypes.c_float(bound), _ptr(verts), _ptr(cols),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vert_cap, face_cap, ctypes.byref(nv), ctypes.byref(nf))
        if rc == 0:
            break
        vert_cap *= 4
    else:
        raise RuntimeError("ga_surface_nets: capacity exceeded")
    c = None if color is None else cols[: nv.value].copy()
    return verts[: nv.value].copy(), faces[: nf.value].copy(), c


def write_ply_native(path: str, fields: dict) -> None:
    """Binary little-endian PLY through `ga_write_ply`: fields name -> (N,)
    arrays, written as float32 vertex properties in insertion order (the
    bytes of `render.ply_io.write_ply`'s numpy writer). Raises on a failed
    build or write."""
    lib = library()
    names = list(fields)
    n = len(fields[names[0]])
    data = np.ascontiguousarray(
        np.stack([np.asarray(fields[k], np.float32).reshape(n)
                  for k in names], axis=1))
    blob = b"\0".join(k.encode() for k in names) + b"\0"
    if lib.ga_write_ply(os.fsencode(path), blob, len(names), _ptr(data),
                        n) != 0:
        raise OSError(f"ga_write_ply could not write {path}")
