"""The plain reference against the program at tiny widths on the CPU,
where both run IEEE fp32: the same seeded weights give the same tokens,
velocities, gaussians and turntable."""
import pytest
import torch

from benchmark import inputs
from benchmark.drivers import i23d_requests
from benchmark.reference import i23d as reference
from benchmark.tests.tiny import tiny_config

SEED = 2 ** 31 + 5


@pytest.fixture(scope="module")
def both():
    torch.set_num_threads(2)
    cfg = tiny_config("i23d-release")
    return cfg, i23d_requests.build(cfg, SEED, "cpu"), \
        reference.build(cfg, SEED, "cpu")


def test_same_parameters(both):
    cfg, prog, ref = both
    for tag in ("cond", "dit1", "dit2", "vae"):
        p = dict(getattr(prog, tag).named_parameters())
        r = dict(ref[tag].named_parameters())
        assert p.keys() == r.keys()
        for k in p:
            assert torch.equal(p[k], r[k]), (tag, k)


@torch.no_grad()
def test_networks_match(both):
    cfg, prog, ref = both
    img = inputs.object_images(1, cfg["conditioner"]["img_size"],
                               inputs.generator(SEED, 1, "cpu"), "cpu")
    c = prog.cond(img)
    tokens, vector = ref["cond"](img)
    torch.testing.assert_close(c.crossattn, tokens, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c.vector, vector, rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(1)
    K = cfg["vae"]["latent_num"]
    for tag, ch in (("dit1", 3), ("dit2", 10)):
        x = torch.randn((2, K, ch), generator=g)
        t = torch.rand(2, generator=g)
        xyz = torch.rand((2, K, 3), generator=g) if ch == 10 else None
        ctx = torch.cat([tokens, torch.zeros_like(tokens)])
        vec = torch.cat([vector, torch.zeros_like(vector)])
        torch.testing.assert_close(
            getattr(prog, tag)(x, t, ctx, vec, xyz=xyz),
            ref[tag](x, t, ctx, vec, xyz=xyz), rtol=1e-5, atol=1e-5)
    z = torch.randn((1, K, 10), generator=g)
    anchors = torch.rand((1, K, 3), generator=g) * 0.9 - 0.45
    for a, b in zip(prog.vae.decode(z, anchors), ref["vae"].decode(z, anchors)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@torch.no_grad()
def test_cameras_and_render_match(both):
    from gaussiananything_tpu_torch.render import cameras
    from gaussiananything_tpu_torch.render.renderer import render_multiview
    cfg, prog, ref = both
    cam = cameras.pose_to_gs_camera(cameras.uni_mesh_path(8)[:8])
    rc = reference.cameras(cfg, "cpu")
    for k in ("cam_view", "cam_view_proj"):
        torch.testing.assert_close(cam[k], rc[k], rtol=0, atol=1e-6)
    g = torch.Generator().manual_seed(2)
    K = cfg["vae"]["latent_num"]
    lods = prog.vae.decode(torch.randn((1, K, 10), generator=g),
                           torch.rand((1, K, 3), generator=g) * 0.6 - 0.3)
    r = cfg["render"]
    out = render_multiview(lods[-1], cam["cam_view"][None],
                           cam["cam_view_proj"][None], torch.ones(1, 8, 3),
                           r["output_size"], tile=r["tile"],
                           max_per_tile=r["max_per_tile"], chunk=r["chunk"])
    maps, work = reference.render(cfg, lods[-1][0], rc)
    assert float(maps["alpha"].max()) > 0.5
    for k in maps:
        torch.testing.assert_close(out[k][0], maps[k], rtol=1e-5, atol=1e-5)
    assert int(work["steps"].sum()) > 0


def test_training_reference_matches_the_fp32_program(tmp_path):
    """With the compute dtype at float32 the program's training steps and
    the reference's agree to round-off (the cell itself is bf16)."""
    import json
    import os

    from benchmark import run
    from benchmark.tests.tiny import checkout
    root = checkout(str(tmp_path))
    path = os.path.join(root, "benchmark", "configs", "vae-release.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["precision"]["compute_dtype"] = "float32"
    with open(path, "w") as f:
        json.dump(cfg, f)
    rec, _ = run.run_cell(root, "vae-release.train", SEED, 0.05, False,
                          device="cpu")
    read = rec["read"]
    assert read["loss"] < 1e-5, read
    assert read["grad1"] < 1e-4 and read["grad1_median"] < 1e-5, read
    assert read["update2_median"] < 1e-3, read


def test_fp8_control_rounds_the_forward_only():
    """The bf16 configuration's control: each operand of a model product
    rounded to e4m3 under its own scale (3 mantissa bits: within 1/16 of
    each value, or of e4m3's smallest step at the scale), the cotangent
    passed through as it comes."""
    from benchmark.reference import precision
    x = (torch.randn(256, 64) * 1e-4).requires_grad_()
    with precision.control("bfloat16"):
        y = precision.net(x)
    assert y.dtype == torch.bfloat16
    step = x.detach().abs().max() / precision.E4M3_MAX * 2.0 ** -9
    err = (y.detach().float() - x.detach()).abs()
    assert bool((err <= x.detach().abs() / 16 + step + 1e-3 * err).all())
    assert float(err.max()) > 1e-3 * float(x.detach().abs().max())
    g = torch.randn(256, 64, dtype=torch.bfloat16)
    y.backward(g)
    assert torch.equal(x.grad, g.float())
