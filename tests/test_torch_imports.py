"""The port stands alone: no file of `gaussiananything_tpu_torch/` or
`chip_smoke.py` imports JAX, flax, optax or the JAX package, and the entry
points run on `cuda` unless the caller asks for the CPU."""
from __future__ import annotations

import ast
import inspect
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# `tools` and `bench` are the JAX package's top-level tools; the port's own
# live inside its package
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "gaussiananything_tpu",
             "tools", "bench"}


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT,
                                            "gaussiananything_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_found():
    files = _port_files()
    assert len(files) > 30
    rel = {os.path.relpath(f, ROOT) for f in files}
    pkg = "gaussiananything_tpu_torch/"
    for name in ("ops/rasterize_cuda.py", "ops/fps.py", "ops/pointcloud.py",
                 "models/sd_encoder.py", "models/encoder.py",
                 "data/postprocess.py", "train/losses.py", "train/state.py",
                 "train/vae_trainer.py", "train/logging.py",
                 "train/evaluation.py", "data/gbuffer.py",
                 "cli/train_vae.py", "tools/rasterizer_timing.py",
                 "tools/bench.py", "tools/kernel_stages.py",
                 "tools/kernel_attribution.py", "cli/serve.py",
                 "models/openclip_text.py", "models/matting.py",
                 "data/real.py", "render/tsdf.py", "native_bindings.py",
                 "diffusion/transport.py", "diffusion/ddpm.py",
                 "cli/train_flow.py", "cli/extract_latents.py",
                 "data/objaverse_raw.py", "parallel/__init__.py",
                 "parallel/mesh.py", "parallel/dist.py",
                 "parallel/dryrun.py", "render/sharded.py",
                 "cli/import_release.py", "utils/release_import.py",
                 "render/sh.py", "utils/profiling.py",
                 "tools/golden_parity_512.py", "tools/fm_feasibility.py",
                 "tools/release_feasibility.py"):
        assert pkg + name in rel, name


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_cli_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    from gaussiananything_tpu_torch.cli import sample
    from gaussiananything_tpu_torch.utils import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inspect.signature(device.resolve_device).parameters[
        "device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.main(["--release", "--full", "--num", "0"])
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_multi_rank_setup_names_the_backend(monkeypatch):
    """One process is no process group; NCCL with more ranks on a host
    than cards raises and names the flag that asks for gloo (no silent
    switch of backend); a mesh other than the launched world is refused,
    naming it; the dry run takes the card unless asked for the CPU."""
    from gaussiananything_tpu_torch.parallel import dist, dryrun
    from gaussiananything_tpu_torch.parallel.mesh import training_mesh
    dist.setup_dist()
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        dist.setup_dist()
    assert not torch.distributed.is_initialized()
    monkeypatch.undo()
    with pytest.raises(ValueError, match=r"2 \(data\) x 2 \(tile\)"):
        training_mesh(2, 2, 4)
    assert training_mesh(0, 1, 4).shape == {"data": 1, "tile": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])


def test_serve_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    from gaussiananything_tpu_torch.cli import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_pipeline(args)


def test_resolve_device_pins_fp32_products():
    from gaussiananything_tpu_torch.utils.device import resolve_device
    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_train_cli_defaults_to_cuda_and_refuses_without_it(monkeypatch,
                                                           tmp_path):
    from gaussiananything_tpu_torch.cli import train_vae
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vae.main(["--steps", "1", "--logdir", str(tmp_path)])


def test_flow_clis_default_to_cuda_and_refuse_without_it(monkeypatch,
                                                        tmp_path):
    from gaussiananything_tpu_torch.cli import extract_latents, train_flow
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_flow.main(["--steps", "1", "--logdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_latents.main(["--num", "1", "--out", str(tmp_path)])


def test_training_kernels_raise_on_cuda_tensors_without_a_build(monkeypatch,
                                                                tmp_path):
    """On a CUDA tensor the wrappers launch their kernel or raise: a build
    that fails is an error, never the plain version, and leaves no file
    behind. (A `meta` tensor stands in for a device that is not the CPU.)"""
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    assert set(rasterize_cuda.SOURCES) == {"fwd", "bwd", "seg", "v1"}
    for path in (*rasterize_cuda.SOURCES.values(), *rasterize_cuda.HEADERS):
        assert os.path.exists(path)
    tab = torch.zeros((4, rz.TABLE_W), device="meta")
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    bg = torch.ones(3, device="meta")
    for fn in (rasterize_cuda.composite, rasterize_cuda.composite_entries,
               rasterize_cuda.composite_train):
        with pytest.raises((ValueError, RuntimeError)):
            fn(tab, idx, idx, idx, bg, 32, 32)
    with pytest.raises((ValueError, RuntimeError)):
        rasterize_cuda.composite_segments(tab, idx, idx, bg, 32, 32)
    geom = torch.zeros((4, 64, rz.GEOM_W), device="meta")
    feat = torch.zeros((4, 64, rz.FEAT_W), device="meta")
    pix = torch.zeros((4, 256), device="meta")
    for call in (
            lambda: rasterize_cuda.composite_lists(geom, feat, idx, 2, 16,
                                                   64),
            lambda: rasterize_cuda.composite_lists_unrolled(geom, feat, idx,
                                                            2, 16, 64, 2),
            lambda: rasterize_cuda.composite_lists_grouped(
                idx[:2], geom, feat, pix, pix, pix[:, :1], 2, 64),
            lambda: rasterize_cuda.stage(0, idx[:2], geom, feat, pix, pix, 2,
                                         64)):
        with pytest.raises((ValueError, RuntimeError)):
            call()
    build_dir = tmp_path / "build"
    monkeypatch.setattr(rasterize_cuda, "_nvcc",
                        lambda: str(tmp_path / "no-nvcc-here"))
    monkeypatch.setattr(rasterize_cuda, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(rasterize_cuda, "_libs", {})
    with pytest.raises(FileNotFoundError):
        rasterize_cuda._library("v1")
    assert not rasterize_cuda._libs
    assert list(build_dir.iterdir()) == []


def test_tools_default_to_cuda_and_refuse_without_it(monkeypatch):
    from gaussiananything_tpu_torch.tools import (bench, fm_feasibility,
                                                  golden_parity_512,
                                                  kernel_attribution,
                                                  kernel_stages,
                                                  rasterizer_timing,
                                                  release_feasibility)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (bench, kernel_stages, rasterizer_timing, kernel_attribution,
                 golden_parity_512, fm_feasibility, release_feasibility):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])


def test_cli_runs_only_the_ported_path(tmp_path):
    """Every path of the JAX CLI is ported (the demo preset runs); its
    `--platform` is the port's `--device` and is refused."""
    from gaussiananything_tpu_torch.cli import sample
    assert sample.main(["--device", "cpu", "--num", "0",
                        "--out", str(tmp_path)]) == []
    with pytest.raises(SystemExit):
        sample.main(["--platform", "cpu", "--num", "0"])
