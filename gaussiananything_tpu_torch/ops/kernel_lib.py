"""How a hand-written source becomes a callable, for every kernel of the
port: the one table of CUDA sources (`SOURCES`), their build with `nvcc`
for `sm_90a` into shared libraries with a plain C interface (all at once
at first use, into `build/` beside the sources, which git ignores), their
loading with ctypes, and the checks every wrapper shares. The host mesh
library (`native_bindings`) is built by the same keyed step.

A new kernel is one `SOURCES` entry and its own wrapper module, which
declares its entry points' signatures (`library`) and states once what the
kernel takes.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List, Sequence, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# The compositors' knife edges (alpha >= 1/255, T <= 1e-4) flip on the last
# ulp, so their multiplies and adds are rounded apart, as the plain versions
# round them. The attention kernel has no such edge; the row-norm kernel
# rounds its outputs apart with intrinsics.
_FMA_APART = ["-fmad=false"]
SOURCES = {"fwd": (os.path.join(CSRC, "rasterize_v4.cu"), _FMA_APART),
           "bwd": (os.path.join(CSRC, "rasterize_v4_bwd.cu"), _FMA_APART),
           "seg": (os.path.join(CSRC, "rasterize_v4_seg.cu"), _FMA_APART),
           "v1": (os.path.join(CSRC, "rasterize_v1.cu"), _FMA_APART),
           "attn": (os.path.join(CSRC, "attention.cu"), []),
           "rownorm": (os.path.join(CSRC, "rownorm.cu"), [])}
# beside every source; each library's key holds them all
HEADERS = ["composite_v4.cuh"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log = ""          # the compilers' output of this process's builds


def compile_keyed(source: str, key: bytes, build_dir: str, stem: str,
                  commands: Iterable[Sequence[str]]) -> Tuple[str, str]:
    """(path, log) of `build_dir`/lib<stem>_<digest of key>.so, compiled
    from `source` unless it is there by each of `commands` (+ `-o <file>
    source`) in turn until one succeeds; written under a temporary name and
    renamed, so concurrent builds never load a half-written file. Raises
    RuntimeError with the compilers' output, FileNotFoundError where no
    command could be started; a failed build leaves nothing behind."""
    digest = hashlib.sha256(key).hexdigest()[:16]
    target = os.path.join(build_dir, f"lib{stem}_{digest}.so")
    if os.path.exists(target):
        return target, ""
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{stem}_", suffix=".so",
                               dir=build_dir)
    os.close(fd)
    failures, ran = [], False
    try:
        for command in commands:
            cmd = [*command, "-o", tmp, source]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=600)
            except OSError as e:                    # no such compiler
                failures.append(f"{' '.join(cmd)}\n{e}")
                continue
            ran = True
            log = f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
            if res.returncode == 0:
                os.replace(tmp, target)
                return target, log
            failures.append(log)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    raise (RuntimeError if ran else FileNotFoundError)(
        f"building {source} failed:\n" + "\n".join(failures))


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _build_one(source: str, flags: List[str]) -> Tuple[str, str]:
    """A source's library, keyed by the source, the flags and the headers
    (the digests the library files have always carried)."""
    here = os.path.dirname(source)
    with open(source, "rb") as f:
        key = f.read() + " ".join(NVCC_FLAGS).encode()
    for header in HEADERS:
        with open(os.path.join(here, header), "rb") as f:
            key += f.read()
    return compile_keyed(source, key + " ".join(flags).encode(),
                         os.path.join(here, "build"),
                         os.path.splitext(os.path.basename(source))[0],
                         [[_nvcc(), *NVCC_FLAGS, *flags]])


def build() -> Dict[str, str]:
    """Compile every source of `SOURCES` that has no library yet, all at
    once (one `nvcc` process each); returns {name: library path}."""
    global build_log
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        jobs = {name: pool.submit(_build_one, *entry)
                for name, entry in SOURCES.items()}
    paths, failed = {}, []
    for name, job in jobs.items():
        try:
            paths[name], log = job.result()
        except (RuntimeError, OSError) as e:
            failed.append(e)
            continue
        build_log += log
    if failed:
        started = all(isinstance(e, RuntimeError) for e in failed)
        raise (RuntimeError if started else FileNotFoundError)(
            "\n".join(map(str, failed)))
    return paths


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Library `name` of `SOURCES`, built at first use and loaded once;
    `signatures` gives each entry point's argument types (every entry
    point returns an int, a cudaError or a count)."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build()[name])
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


@contextlib.contextmanager
def sources_from(csrc: str, names: Iterable[str]):
    """Inside the block, the libraries `names` are built from the files of
    the same names in `csrc` (with the headers beside them, into
    `csrc`/build) and loaded anew; after it, from their own sources again."""
    names = list(names)
    with _lock:
        saved = dict(SOURCES)
        for name in names:
            source, flags = SOURCES[name]
            SOURCES[name] = (os.path.join(csrc, os.path.basename(source)),
                             flags)
            _libs.pop(name, None)
    try:
        yield
    finally:
        with _lock:
            SOURCES.update(saved)
            for name in names:
                _libs.pop(name, None)


def check(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def refuse(why: List[Tuple[str, str]]):
    """Raise ValueError with the messages of a rule's (reason, message)
    pairs, if there are any."""
    if why:
        raise ValueError("; ".join(message for _, message in why))


def aligned16(t) -> bool:
    """Unit stride along the last dim, every other stride a whole number of
    16-byte chunks of fp32, the base 16-byte aligned: what the kernels'
    16-byte loads read."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 or n == 1
                    for s, n in zip(t.stride()[:-1], t.shape[:-1])))
