"""The yardstick's counts: the analytic FLOPs against PyTorch's own
FLOP counter on small-width copies of the program's networks, and the
compositor's steps against a per-pixel walk."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import inputs
from benchmark.counts import flops
from benchmark.counts import raster as raster_counts
from benchmark.drivers import i23d_requests
from benchmark.reference import raster
from benchmark.tests.tiny import tiny_config

SEED = 2 ** 31 + 11


def _counted(fn, *args, **kw):
    with FlopCounterMode(display=False) as m:
        fn(*args, **kw)
    return m.get_total_flops()


def test_network_flops_match_the_counter():
    torch.set_num_threads(2)
    cfg = tiny_config("i23d-release")
    prog = i23d_requests.build(cfg, SEED, "cpu")
    c = cfg["conditioner"]
    img = torch.rand((1, 3, c["img_size"], c["img_size"]))
    assert _counted(prog.cond, img) == flops.dinov2(c)
    g = (c["img_size"] // c["patch"]) ** 2
    K = cfg["vae"]["latent_num"]
    for tag, ch in (("dit1", 3), ("dit2", 10)):
        args = (torch.randn(2, K, ch), torch.rand(2), torch.randn(2, g, 64),
                torch.randn(2, 64))
        kw = {"xyz": torch.rand(2, K, 3)} if ch == 10 else {}
        assert _counted(getattr(prog, tag), *args, **kw) == \
            flops.dit(cfg[tag], K, g, batch=2)
    assert _counted(prog.vae.decode, torch.randn(1, K, 10),
                    torch.rand(1, K, 3)) == flops.vae_decode(cfg["vae"])


@torch.no_grad()
def test_request_flops_count_every_call():
    """`flops.request` counts the conditioner and DiT calls that a
    request makes through `cli.sample.sample_request`."""
    from gaussiananything_tpu_torch.cli import sample
    from gaussiananything_tpu_torch.config import RenderConfig
    from gaussiananything_tpu_torch.train.fm_trainer import FMConfig
    cfg = tiny_config("i23d-release")
    prog = i23d_requests.build(cfg, SEED, "cpu")
    calls = {"cond": 0, "dit1": 0, "dit2": 0}
    for k in calls:
        getattr(prog, k).register_forward_hook(
            lambda m, a, o, k=k: calls.__setitem__(k, calls[k] + 1))
    fm = FMConfig(stage=1, num_steps=cfg["sampler"]["num_steps"])
    r = cfg["render"]
    img = inputs.object_images(1, cfg["conditioner"]["img_size"],
                               inputs.generator(SEED, 1, "cpu"), "cpu")
    sample.sample_request(prog, img, fm, FMConfig(stage=2, num_steps=2),
                          RenderConfig(output_size=r["output_size"],
                                       max_per_tile=r["max_per_tile"],
                                       chunk=r["chunk"]), log=lambda _: None)
    evals = 2 * cfg["sampler"]["num_steps"]
    assert calls == {"cond": 2, "dit1": evals, "dit2": evals}
    g = (cfg["conditioner"]["img_size"] // 14) ** 2
    K = cfg["vae"]["latent_num"]
    assert flops.request(cfg) == 2 * flops.dinov2(cfg["conditioner"]) \
        + evals * (flops.dit(cfg["dit1"], K, g, 2)
                   + flops.dit(cfg["dit2"], K, g, 2)) \
        + flops.vae_decode(cfg["vae"])


def _scene(n=48, seed=3):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand((n, 3), generator=g) * 0.5 - 0.25
    raw = torch.randn((n, 10), generator=g)
    return torch.cat([xyz, torch.sigmoid(raw[:, :1]) * 0.98 + 0.02,
                      0.02 + 0.08 * torch.rand((n, 2), generator=g),
                      raw[:, 1:5], torch.rand((n, 3), generator=g)], -1)


def test_steps_match_a_per_pixel_walk():
    size, tile, mpt = 32, 16, 64
    gs = _scene()
    cams = raster.cameras(*raster.orbit_poses(2), "cpu")
    for v in range(2):
        cv, cvp = cams["cam_view"][v], cams["cam_view_proj"][v]
        sp = raster.preprocess_splats(gs, cv, cvp, size, size)
        pairs, starts, counts = raster.build_tile_pairs(sp, size, size,
                                                        tile, mpt)
        tab = raster.pack_splat_render(sp).t().contiguous()
        _, work = raster.composite(tab, pairs, starts, counts,
                                   torch.ones(3), size, size, tile, 16)
        want, blended = _per_pixel(tab, pairs, starts, counts, size, tile)
        assert work["steps"].tolist() == want
        assert work["blended"].tolist() == blended
        assert sum(want) > 0


def _per_pixel(tab, pairs, starts, counts, size, tile):
    """Per tile, the largest over its pixels of the slots entered at
    T > T_EPS, and the pairs blended, walking one splat at a time."""
    tiles_x = size // tile
    tab0 = torch.cat([tab, torch.zeros(1, tab.shape[1])])
    out, blends = [], []
    for t in range(tiles_x * tiles_x):
        ids = pairs[int(starts[t]):int(starts[t]) + int(counts[t])].long()
        ty, tx = divmod(t, tiles_x)
        best, blended = 0, 0
        for p in range(tile * tile):
            px = torch.tensor([[tx * tile + p % tile]], dtype=torch.float32)
            py = torch.tensor([[ty * tile + p // tile]], dtype=torch.float32)
            state = raster._init_state(1, 1, "cpu")
            n = 0
            for s in ids:
                if float(state.trans) <= raster.T_EPS:
                    break
                n += 1
                state, w, _ = raster.composite_chunk(
                    state, px, py, tab0[s][:, None, None],
                    return_weights=True)
                blended += int((w > 0).sum())
            best = max(best, n)
        out.append(best)
        blends.append(blended)
    return out, blends


def test_bound_names_its_limit():
    b = raster_counts.forward_view(torch.tensor([100000]), 73728, 512, 16)
    assert b["bound_by"] == "operations"
    assert b["ops"] == 100000 * 256 * raster_counts.OPS_FWD
    b = raster_counts.forward_view(torch.tensor([1]), 73728, 512, 16)
    assert b["bound_by"] == "bytes"


def test_busy_seconds_is_the_union():
    from benchmark import core
    dev = [(0, 10, "a"), (5, 12, "b"), (20, 30, "c"), (21, 25, "d")]
    assert core.busy_seconds(dev) == 22 / 1e9


def test_every_k2_launch_is_sized():
    """The wrapper that gives each K2 launch its LoD keeps the wrapped
    function's launch count, and takes itself off again."""
    import types
    from benchmark.drivers import vae_train
    mod = types.ModuleType("fake_rasterize_cuda")
    exec("def composite_entries(tab, pairs, starts, counts, bg, img_h,"
         " img_w, tile=16):\n"
         "    composite_entries.launches += 1\n"
         "composite_entries.launches = 0\n"
         "def composite_backward(tab, img_h=1, row0=0):\n"
         "    composite_backward.launches += 1\n"
         "composite_backward.launches = 0\n"
         "def train():\n"
         "    composite_entries(0, 0, 0, 0, 0, 128, 128)\n"
         "    composite_backward(0, img_h=512)\n", mod.__dict__)
    fns = (mod.composite_entries, mod.composite_backward)
    sizes = []
    vae_train._size_k2(mod, sizes)
    mod.train()
    mod.train()
    vae_train._size_k2(mod, None)
    mod.train()
    assert sizes == [128, 512, 128, 512]
    assert (mod.composite_entries, mod.composite_backward) == fns
    assert [f.launches for f in fns] == [3, 3]


def test_mean_view_bounds_the_mean_work():
    views = [raster_counts.bound(ops, nbytes)
             for ops, nbytes in ((6.7e9, 10), (13.4e9, 30))]
    m = raster_counts.mean_view(views)
    assert m["ops"] == 10.05e9 and m["bytes"] == 20
    assert abs(m["bound_s"] - sum(v["bound_s"] for v in views) / 2) < 1e-12
