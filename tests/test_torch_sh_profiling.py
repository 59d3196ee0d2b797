"""The port's `render/sh.py`, `utils/profiling.py` and native PLY writer
against the JAX package's: spherical harmonics of degrees 0-3 to 1e-6 on
the same numpy inputs; the spans in the trace on the CPU; the
binary PLY that `ga_write_ply` writes, byte for byte the JAX package's
native writer's and the numpy writer's."""
from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu import native_bindings as jnative
from gaussiananything_tpu.render import sh as jsh
from gaussiananything_tpu_torch import native_bindings
from gaussiananything_tpu_torch.render import ply_io
from gaussiananything_tpu_torch.render import sh
from gaussiananything_tpu_torch.utils import profiling


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    coeffs = rng.normal(size=(5, 7, 3, (deg + 1) ** 2)).astype(np.float32)
    dirs = rng.normal(size=(5, 7, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    got = sh.eval_sh(deg, torch.from_numpy(coeffs), torch.from_numpy(dirs))
    want = np.asarray(jsh.eval_sh(deg, jnp.asarray(coeffs),
                                  jnp.asarray(dirs)))
    assert got.shape == want.shape == (5, 7, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sh_constants_and_rgb_round_trip():
    assert (sh.C0, sh.C1, sh.C2, sh.C3) == (jsh.C0, jsh.C1, jsh.C2, jsh.C3)
    rgb = torch.rand(4, 3, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(sh.rgb_to_sh(rgb).numpy(),
                               np.asarray(jsh.rgb_to_sh(rgb.numpy())),
                               rtol=1e-6)
    torch.testing.assert_close(sh.sh_to_rgb(sh.rgb_to_sh(rgb)), rgb)
    with pytest.raises(ValueError):
        sh.eval_sh(4, torch.zeros(1, 3, 25), torch.zeros(1, 3))


def test_trace_records_annotations(tmp_path):
    """`trace` around a `recording`: the spans are ranges of the Chrome
    trace; outside a recording they are not."""
    with profiling.recording(), profiling.trace(str(tmp_path)) as prof:
        with profiling.span("ga.render.view"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    names = {e.key for e in prof.key_averages()}
    assert "ga.render.view" in names
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "ga.render.view" for e in events)
    with profiling.trace(str(tmp_path / "off")) as prof:
        with profiling.span("ga.render.view"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    assert "ga.render.view" not in {e.key for e in prof.key_averages()}


def _fields():
    rng = np.random.default_rng(0)
    return {k: rng.normal(size=50).astype(np.float32)
            for k in ("x", "y", "z", "opacity", "f_dc_0")}


def test_native_ply_equals_jax_and_numpy(tmp_path):
    fields = _fields()
    port, jax_native, numpy_w = (tmp_path / f"{n}.ply"
                                 for n in ("port", "jax", "numpy"))
    assert ply_io.write_ply(str(port), fields) == "native"
    assert jnative.write_ply_native(str(jax_native), fields)
    assert ply_io.write_ply(str(numpy_w), fields, binary=False) == "numpy"
    data = port.read_bytes()
    assert data == jax_native.read_bytes()
    # the numpy writer's binary bytes, written without the library
    header = ["ply", "format binary_little_endian 1.0", "element vertex 50"]
    header += [f"property float {k}" for k in fields] + ["end_header"]
    body = np.stack([fields[k] for k in fields], 1).astype("<f4").tobytes()
    assert data == ("\n".join(header) + "\n").encode() + body
    back = ply_io.read_ply(str(port))
    for k in fields:
        np.testing.assert_array_equal(back[k], fields[k])
        np.testing.assert_allclose(ply_io.read_ply(str(numpy_w))[k],
                                   fields[k], rtol=1e-7)


def test_numpy_writer_only_without_a_compiler(tmp_path, monkeypatch):
    """The numpy writer runs only where no C++ compiler can be started
    (and writes the same bytes); a failed build raises."""
    fields = _fields()
    monkeypatch.setattr(native_bindings, "_LIB", None)
    monkeypatch.setattr(native_bindings, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setenv("PATH", str(tmp_path))      # no g++ either
    out = tmp_path / "fallback.ply"
    assert ply_io.write_ply(str(out), fields) == "numpy"
    monkeypatch.undo()
    ref = tmp_path / "ref.ply"
    assert ply_io.write_ply(str(ref), fields) == "native"
    assert out.read_bytes() == ref.read_bytes()

    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_bindings, "_LIB", None)
    monkeypatch.setattr(native_bindings, "SOURCE", str(broken))
    monkeypatch.setattr(native_bindings, "BUILD_DIR", str(tmp_path / "c"))
    with pytest.raises(RuntimeError) as err:
        ply_io.write_ply(str(tmp_path / "x.ply"), fields)
    assert not isinstance(err.value, native_bindings.NativeUnavailable)
    assert not os.path.exists(tmp_path / "x.ply")
