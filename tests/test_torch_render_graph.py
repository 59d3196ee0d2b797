"""`rasterize_tiled`'s CUDA-graph path for a view's projection and binning,
what of it runs on the CPU: the rule that decides where it engages, the
key a graph is held to, the cache's eager first calls, and the renderer's
epilogue over all views at once. The capture and the replay themselves
are held on the card (`tests/test_torch_cuda.py`, `test_frame_graph_*`).
This file imports neither JAX nor the JAX package."""
from __future__ import annotations

import types

import pytest
import torch

from gaussiananything_tpu_torch.data.synthetic import make_object
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.render.renderer import render_multiview
from gaussiananything_tpu_torch.utils.graphs import GraphCache

torch.set_num_threads(2)


def _stand_in(device: str, requires_grad: bool):
    # the rule reads only a tensor's device and requires_grad, so a CUDA
    # input can be stood in for without a card
    return types.SimpleNamespace(device=torch.device(device),
                                 requires_grad=requires_grad)


ROUTES = [
    # (device, grad mode, gaussians require grad, impl, capturing) → engages
    (("cuda", False, False, "cuda", False), True),
    (("cuda", True, False, "cuda", False), True),
    (("cuda", False, True, "cuda", False), True),
    (("cuda", True, True, "cuda", False), False),
    (("cuda", False, False, "plain", False), False),
    (("cuda", False, False, "cuda", True), False),
    (("cpu", False, False, "cuda", False), False),
    (("cpu", True, True, "cuda", False), False),
    (("cpu", False, False, "plain", False), False),
]


@pytest.mark.parametrize("case,engages", ROUTES,
                         ids=["-".join(map(str, c)) for c, _ in ROUTES])
def test_route(monkeypatch, case, engages):
    device, grad, req, impl, capturing = case
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    g = _stand_in(device, req)
    cams = [_stand_in(device, False) for _ in range(2)]
    with torch.set_grad_enabled(grad):
        assert rz.frame_graph_engages(g, *cams, impl) is engages


@pytest.mark.parametrize("which", [1, 2])
def test_route_reads_the_cameras_too(monkeypatch, which):
    """A camera that requires grad under grad mode makes the table require
    one; a camera on another device than the card would be read as a host
    scalar at capture."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    ins = [_stand_in("cuda", False) for _ in range(3)]
    ins[which] = _stand_in("cuda", True)
    with torch.enable_grad():
        assert not rz.frame_graph_engages(*ins, "cuda")
    with torch.no_grad():
        assert rz.frame_graph_engages(*ins, "cuda")
    ins[which] = _stand_in("cpu", False)
    with torch.no_grad():
        assert not rz.frame_graph_engages(*ins, "cuda")


FRAME = (512, 512, 16, 2048, 0, 0)    # img_h, img_w, tile, mpt, full_h, row0


def _inputs(n=64, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, 13), generator=g, dtype=dtype),
            torch.randn((4, 4), generator=g), torch.randn((4, 4), generator=g))


def test_key_holds_across_new_input_data():
    key = rz.frame_key(*_inputs(), FRAME)
    assert rz.frame_key(*_inputs(seed=5), FRAME) == key


def _with(i, v):
    f = list(FRAME)
    f[i] = v
    return tuple(f)


KEY_CHANGES = {
    "n": lambda: rz.frame_key(*_inputs(n=65), FRAME),
    "size": lambda: rz.frame_key(*_inputs(), _with(0, 256)),
    "width": lambda: rz.frame_key(*_inputs(), _with(1, 256)),
    "tile": lambda: rz.frame_key(*_inputs(), _with(2, 8)),
    "max_per_tile": lambda: rz.frame_key(*_inputs(), _with(3, 1024)),
    "full_h": lambda: rz.frame_key(*_inputs(), _with(4, 1024)),
    "row0": lambda: rz.frame_key(*_inputs(), _with(5, 256)),
    "dtype": lambda: rz.frame_key(*_inputs(dtype=torch.float64), FRAME),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_key_separates_what_a_capture_fixes(change):
    assert KEY_CHANGES[change]() != rz.frame_key(*_inputs(), FRAME)


def test_key_separates_inference_mode_and_matmul_policy():
    from gaussiananything_tpu_torch.utils import precision
    key = rz.frame_key(*_inputs(), FRAME)
    with torch.inference_mode():
        assert rz.frame_key(*_inputs(), FRAME) != key
    before = (torch.backends.cuda.matmul.fp32_precision,
              torch.backends.cudnn.conv.fp32_precision)
    try:
        precision.set_policy("default" if before[0] == "ieee"
                             else "highest")
        assert rz.frame_key(*_inputs(), FRAME) != key
    finally:
        (torch.backends.cuda.matmul.fp32_precision,
         torch.backends.cudnn.conv.fp32_precision) = before


def test_cache_runs_first_calls_eagerly_and_keeps_at_most_its_limit():
    """A key's first call is the body's own output and captures nothing;
    keys beyond `LIMIT` evict the least recently used."""
    cache = GraphCache("ga.test")
    calls = []

    def body(x):
        calls.append(x)
        return x * 2
    x = torch.arange(3.0)
    for k in range(cache.LIMIT + 2):
        out, replayed = cache.run(("k", k), body, (x,))
        assert not replayed and torch.equal(out, x * 2)
    assert len(calls) == cache.LIMIT + 2
    assert list(cache.entries) == [("k", k) for k in
                                   range(2, cache.LIMIT + 2)]
    assert all(e is None for e in cache.entries.values())


def _scene(n=512, views=3, seed=0):
    g = make_object(seed, n=n, kind="sphere")[None]
    sweep = cameras.uni_mesh_path(8)[:views]
    cam = cameras.pose_to_gs_camera(sweep)
    return g, cam["cam_view"][None], cam["cam_view_proj"][None]


def _per_view(gaussians, cam_view, cam_view_proj, bg, size, **kw):
    """The renderer's maps view by view, with each view's expressions."""
    B, V = cam_view.shape[:2]
    views = []
    for s in range(B * V):
        b, v = divmod(s, V)
        cv = cam_view[b, v].float()
        out = rz.rasterize_tiled(gaussians[b], cv, cam_view_proj[b, v],
                                 bg[b, v].contiguous(), size, size, **kw)
        nv = out["normal_view"]
        alpha = out["alpha"]
        depth_exp = out["depth_expected"] / torch.clamp(alpha, min=1e-10)
        views.append({
            "image": torch.clamp(out["image"], 0.0, 1.0), "alpha": alpha,
            "depth": out["depth_median"],
            "depth_expected": torch.where(alpha > 1e-6, depth_exp,
                                          torch.zeros_like(depth_exp)),
            "rend_normal": torch.stack([nv[0] * cv[j, 0] + nv[1] * cv[j, 1]
                                        + nv[2] * cv[j, 2]
                                        for j in range(3)]),
            "dist": out["dist"]})
    return {k: torch.stack([o[k] for o in views]).reshape(
        (B, V) + views[0][k].shape) for k in views[0]}


@pytest.mark.parametrize("impl", ["cuda", "plain"])
def test_epilogue_over_all_views_is_the_per_view_one_bit_for_bit(impl):
    g, cv, cvp = _scene()
    bg = torch.rand((1, cv.shape[1], 3), generator=torch.Generator()
                    .manual_seed(2))
    kw = dict(tile=16, max_per_tile=256, chunk=64, impl=impl)
    with torch.no_grad():
        got = render_multiview(g, cv, cvp, bg, 64, **kw)
        want = _per_view(g, cv, cvp, bg, 64, **kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    assert float(got["alpha"].max()) > 0.5
    assert not rz.FRAME_GRAPHS.entries       # the CPU stays eager


def test_epilogue_gradient_matches_the_per_view_one():
    g, cv, cvp = _scene(n=256, views=2)
    bg = torch.ones((1, 2, 3))
    kw = dict(tile=16, max_per_tile=256, chunk=64)
    grads = []
    for fn in (render_multiview, _per_view):
        x = g.clone().requires_grad_(True)
        out = fn(x, cv, cvp, bg, 32, **kw)
        sum(v.sum() * (i + 1) for i, v in enumerate(out.values())).backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-7)
    assert float(grads[0].abs().max()) > 0
