"""The port's losses, optimiser and VAE training step against the JAX
package on the CPU: the same numpy inputs, weights (through
`from_jax_params`), batch and random draws go through both."""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.train import losses as JL
from gaussiananything_tpu.train import state as jstate
from gaussiananything_tpu.train import vae_trainer as jtrainer
from gaussiananything_tpu_torch.data.synthetic import make_batch
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.train import losses as L
from gaussiananything_tpu_torch.train import state as pstate
from gaussiananything_tpu_torch.train import vae_trainer as ptrainer
from gaussiananything_tpu_torch.utils.param_io import from_jax_params

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _maps(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _jax_perceptual_net():
    _, p = JL._perceptual_params()
    net = L.PerceptualNet()
    net.load_state_dict(from_jax_params(p, net))
    return net.requires_grad_(False)


# every loss function on the same inputs: (name, port call, JAX call)
def _loss_cases():
    a, b = _maps(0, 2, 3, 3, 16, 16), _maps(1, 2, 3, 3, 16, 16)
    m = (_maps(2, 2, 3, 1, 16, 16) > 0.4).astype(np.float32)
    d, gd = _maps(3, 2, 3, 1, 16, 16) + 1, _maps(4, 2, 3, 1, 16, 16) + 1
    g = np.random.default_rng(5).normal(size=(2, 50, 13)).astype(np.float32)
    g[..., 3] = _maps(6, 2, 50)
    poses = cameras.generate_input_camera(
        1.8, [(10, 20), (40, 130), (-20, 250)] * 2)
    cam = cameras.pose_to_gs_camera(poses)["cam_view"].numpy().reshape(
        2, 3, 4, 4)
    return [
        ("l1", lambda: L.l1(t(a), t(b)), lambda: JL.l1(a, b)),
        ("l1_masked", lambda: L.l1(t(a), t(b), t(m)),
         lambda: JL.l1(a, b, m)),
        ("mse", lambda: L.mse(t(a), t(b)), lambda: JL.mse(a, b)),
        ("mse_masked", lambda: L.mse(t(a), t(b), t(m)),
         lambda: JL.mse(a, b, m)),
        ("perceptual", lambda: L.perceptual_loss(
            t(a[0]), t(b[0]), _jax_perceptual_net()),
         lambda: jax.jit(JL.perceptual_loss)(a[0], b[0])),
        ("ssim", lambda: L.ssim(t(a[0]), t(b[0])),
         lambda: JL.ssim(jnp.asarray(a[0]), jnp.asarray(b[0]))),
        ("depth_si", lambda: L.depth_loss_scale_invariant(t(d), t(gd), t(m)),
         lambda: JL.depth_loss_scale_invariant(jnp.asarray(d),
                                               jnp.asarray(gd),
                                               jnp.asarray(m))),
        ("normal_consistency", lambda: L.normal_consistency_loss(
            t(a - 0.5), t(b - 0.5), t(m)),
         lambda: JL.normal_consistency_loss(jnp.asarray(a - 0.5),
                                            jnp.asarray(b - 0.5),
                                            jnp.asarray(m))),
        ("depth_to_normal", lambda: L.depth_to_normal(t(d), t(cam), 0.27),
         lambda: JL.depth_to_normal(jnp.asarray(d), jnp.asarray(cam),
                                    jnp.float32(0.27))),
        ("scale_reg", lambda: L.scale_reg(t(g)), lambda: JL.scale_reg(g)),
        ("opacity_reg", lambda: L.opacity_reg(t(g)),
         lambda: JL.opacity_reg(g)),
        ("kl_schedule", lambda: torch.tensor(
            [L.kl_coeff_schedule(s, 1e-5, 50) for s in (0, 20, 80)]),
         lambda: jnp.stack([JL.kl_coeff_schedule(jnp.asarray(s), 1e-5, 50)
                            for s in (0, 20, 80)])),
    ]


_LOSS_NAMES = ["l1", "l1_masked", "mse", "mse_masked", "perceptual", "ssim",
               "depth_si", "normal_consistency", "depth_to_normal",
               "scale_reg", "opacity_reg", "kl_schedule"]


@pytest.fixture(scope="module")
def loss_cases():
    cases = _loss_cases()
    assert [c[0] for c in cases] == _LOSS_NAMES
    return {c[0]: c[1:] for c in cases}


@pytest.mark.parametrize("name", _LOSS_NAMES)
def test_loss_matches_jax(loss_cases, name):
    """rtol 1e-4 / atol 1e-6: the same fp32 formulas, other sum orders."""
    port, ref = loss_cases[name]
    np.testing.assert_allclose(port().numpy(), np.asarray(ref()),
                               rtol=1e-4, atol=1e-6)


def test_default_perceptual_net_is_seeded_and_frozen():
    a = L.default_perceptual_net("cpu", 0)
    assert a is L.default_perceptual_net("cpu", 0)
    assert not any(p.requires_grad for p in a.parameters())
    b = L.default_perceptual_net("cpu", 1)
    assert not torch.equal(a.conv0a.weight, b.conv0a.weight)
    x = t(_maps(0, 1, 3, 16, 16))
    assert float(L.perceptual_loss(x, x)) == 0.0
    assert float(L.perceptual_loss(x, 1 - x)) > 0.0


# ------------------------------------------------------------ optimiser

def test_optimizer_and_ema_match_optax():
    """5 updates with warmup 2 (the first has lr 0), clipping active, an
    lr multiplier on one top-level module and an extra EMA rate: params,
    both EMA trees agree with optax to 1e-6."""
    r = np.random.default_rng(0)
    shapes = {"encoder": {"w": (4, 3), "b": (3,)}, "decoder": {"w": (3, 2)}}
    params = {m: {k: r.normal(size=s).astype(np.float32)
                  for k, s in d.items()} for m, d in shapes.items()}
    grads = [{m: {k: (3.0 * r.normal(size=s)).astype(np.float32)
                  for k, s in d.items()} for m, d in shapes.items()}
             for _ in range(5)]
    kw = dict(lr=1e-2, weight_decay=0.05, grad_clip=1.0, ema_decay=0.9,
              extra_ema_decays=(0.5,), warmup_steps=2,
              lr_mults=(("encoder", 0.25),))
    jcfg = jstate.TrainStateConfig(**kw)
    tx = jstate.make_optimizer(jcfg)
    js = jstate.TrainState.create(jax.tree.map(jnp.asarray, params), tx,
                                  extra_ema_decays=(0.5,))
    flat = {f"{m}.{k}": torch.nn.Parameter(t(v))
            for m, d in params.items() for k, v in d.items()}
    ps = pstate.TrainState(flat, extra_ema_decays=(0.5,))
    pcfg = pstate.TrainStateConfig(**kw)
    for g in grads:
        js = js.apply_gradients(jax.tree.map(jnp.asarray, g), tx,
                                ema_decay=jcfg.ema_decay)
        ps.apply_gradients({f"{m}.{k}": t(v) for m, d in g.items()
                            for k, v in d.items()}, pcfg)
    assert ps.step == int(js.step) == 5
    for tree, ref in ((ps.params, js.params), (ps.ema, js.ema_params),
                      (ps.ema_extra["0.5"], js.ema_extra["0.5"])):
        for m, d in ref.items():
            for k, v in d.items():
                np.testing.assert_allclose(
                    tree[f"{m}.{k}"].detach().numpy(), np.asarray(v),
                    rtol=1e-5, atol=1e-6)
    # the first update ran at lr 0: only later ones moved the parameters
    assert pstate.learning_rate(pcfg, 0, "encoder.w") == 0.0
    assert pstate.learning_rate(pcfg, 1, "encoder.w") == \
        pytest.approx(1e-2 * 0.25 * 0.5)
    assert pstate.learning_rate(pcfg, 9, "decoder.w") == pytest.approx(1e-2)


def test_checkpoint_round_trip(tmp_path):
    lin = torch.nn.Linear(3, 2)
    cfg = pstate.TrainStateConfig(warmup_steps=1, extra_ema_decays=(0.5,))
    state = pstate.TrainState.create(lin, cfg.extra_ema_decays)
    g = {k: torch.ones_like(p) for k, p in state.params.items()}
    for _ in range(2):
        state.apply_gradients(g, cfg)
    for _ in range(5):
        pstate.save_checkpoint(str(tmp_path), state, keep=3)
        state.apply_gradients(g, cfg)
    assert len(os.listdir(tmp_path)) == 3
    other = pstate.TrainState.create(torch.nn.Linear(3, 2), (0.5,))
    pstate.restore_checkpoint(str(tmp_path), other)
    assert other.step == 6
    pstate.restore_checkpoint(str(tmp_path), other, step=5)
    assert other.step == 5 and not torch.equal(other.mu["weight"],
                                               state.mu["weight"])
    with pytest.raises(FileNotFoundError):
        pstate.restore_checkpoint(str(tmp_path / "none"), other)


# ------------------------------------------------------- the whole step

SIZES = dict(latent_num=12, z_channels=4, decoder_width=64, decoder_depth=2,
             decoder_heads=2, up_factors=(4,), up_depths=(1,))
LODS = (16, 32)
N_STEPS = 3


def _jax_draws(rng, n_lod, latent_shape):
    """The draws `vae_loss_fn` makes from `rng` (`vae_trainer.py:122-141`,
    `models/vae.py:40-43`)."""
    rng_s, rng_lpips, _ = jax.random.split(rng, 3)
    return {"noise": t(jax.random.normal(rng_s, latent_shape, jnp.float32)),
            "lpips_lod": int(jax.random.randint(rng_lpips, (), 0, n_lod))}


@pytest.fixture(scope="module")
def trained():
    """N_STEPS steps of both packages in the release layout (the
    `vae-release` preset's; the other layout's forward is held to JAX in
    test_torch_encoder.py) from the same weights, on the same batch, with
    the same draws; regularisers switched on from step 0."""
    rp = True
    kw = dict(seed=0, batch=1, n_views_in=2, n_views_sup=2, res=32,
              n_pts=128, n_splats=256)
    # one batch for both (test_torch_encoder.py holds the two packages'
    # `make_batch` to each other)
    pbatch = {k: v for k, v in make_batch(**kw).items()
              if k != "gt_gaussians"}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in pbatch.items()}
    enc_w = 256 if rp else 64
    jm = JPointVAE(encoder_width=enc_w, release_parity=rp, **SIZES)
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(jm.init)(key, jbatch["images_in"], jbatch["pcd"], key)
    pm = PointVAE(encoder_width=enc_w, release_parity=rp, with_encoder=True,
                  **SIZES)
    pm.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, jparams), pm))

    loss_kw = dict(lod_resolutions=LODS, normal_start_step=0,
                   dist_start_step=0, kl_anneal_steps=2, chamfer_weight=0.1)
    tx_kw = dict(lr=1e-3, warmup_steps=2)
    jcfg = jstate.TrainStateConfig(**tx_kw)
    jstep = jtrainer.make_train_step(
        jm, jtrainer.VAELossConfig(**loss_kw), jcfg)
    js = jstate.TrainState.create(jparams, jstate.make_optimizer(jcfg))
    pstep = ptrainer.make_train_step(
        pm, ptrainer.VAELossConfig(**loss_kw),
        pstate.TrainStateConfig(**tx_kw), perceptual_net=_jax_perceptual_net())
    ps = pstate.TrainState.create(pm)

    jlogs, plogs = [], []
    for i in range(N_STEPS):
        rng = jax.random.fold_in(key, i)
        js, jl = jstep(js, jbatch, rng)
        jlogs.append({k: float(v) for k, v in jl.items()})
        pl = pstep(ps, pbatch, draws=_jax_draws(
            rng, len(LODS), (1, SIZES["latent_num"], SIZES["z_channels"])))
        plogs.append({k: float(v) for k, v in pl.items()})
    return dict(jlogs=jlogs, plogs=plogs, js=js, ps=ps, pm=pm)


def test_train_step_logs_match_jax(trained):
    """`logs["total"]` and every logged term of the first step (identical
    weights): rtol 2e-3, atol 1e-5, the tolerance of the rasterizer, whose
    sums round differently from JAX's around the 1/255 keep threshold.
    `grad_norm`: rtol 5e-3, because the normal-consistency term sends
    cotangents of magnitude ~1e7 into the expected-depth map where the
    finite-difference normal degenerates, which cancel to a gradient of
    ~1e-3, so fp32 summation order shows at 2e-3 (with `normal_weight=0`
    the two gradients agree to 2e-6). Later steps are held to 1e-2: the
    parameters have by then drifted apart within tolerance."""
    for i, (pl, jl) in enumerate(zip(trained["plogs"], trained["jlogs"])):
        assert set(pl) == set(jl)
        for k in jl:
            rtol = 1e-2 if i else (5e-3 if k == "grad_norm" else 2e-3)
            np.testing.assert_allclose(pl[k], jl[k], rtol=rtol, atol=1e-5,
                                       err_msg=f"step {i} {k}")


def test_three_steps_parameters_match_jax(trained):
    """After N_STEPS updates the parameters and the EMA agree with JAX's.
    Adam divides each gradient element by its own running magnitude, so an
    element whose gradient sits at the rounding floor may move by a whole
    learning rate either way: no element differs by more than the sum of
    the learning rates (0 + 5e-4 + 1e-3), and at most 1% of all elements
    by more than 2e-4."""
    ps, js = trained["ps"], trained["js"]
    assert ps.step == int(js.step) == N_STEPS
    ref = from_jax_params(jax.tree.map(np.asarray, js.params), trained["pm"])
    ema = from_jax_params(jax.tree.map(np.asarray, js.ema_params),
                          trained["pm"])
    moved, beyond, count = 0.0, 0, 0
    for k, p in ps.params.items():
        for got, want in ((p.detach(), ref[k]), (ps.ema[k], ema[k])):
            d = (got - want).abs()
            assert float(d.max()) <= 1.5e-3 + 1e-6, k
            beyond += int((d > 2e-4).sum())
            count += d.numel()
        moved = max(moved, float((p.detach() - ps.ema[k]).abs().max()))
    assert beyond <= 0.01 * count, (beyond, count)
    assert moved > 0


def test_rand_coarse_lod_draws_and_runs():
    """`rand_coarse_lod`: the perceptual draw is between the rendered
    coarse LoD and the finest; the loss renders those two only."""
    cfg = ptrainer.VAELossConfig(rand_coarse_lod=True)
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(40):
        d = ptrainer.draw_step_randomness(4, cfg, g)
        assert d["coarse_idx"] in (0, 1, 2)
        assert d["lpips_lod"] in (d["coarse_idx"], 3)
        seen.add((d["coarse_idx"], d["lpips_lod"] == 3))
    assert len(seen) == 6
    batch = {k: v for k, v in make_batch(
        seed=0, batch=1, n_views_in=2, n_views_sup=2, res=32, n_pts=128,
        n_splats=256).items() if k != "gt_gaussians"}
    torch.manual_seed(0)
    pm = PointVAE(encoder_width=64, release_parity=False, with_encoder=True,
                  latent_num=12, z_channels=4, decoder_width=64,
                  decoder_depth=1, decoder_heads=2, up_factors=(2, 2),
                  up_depths=(1, 1))
    cfg = ptrainer.VAELossConfig(rand_coarse_lod=True,
                                 lod_resolutions=(16, 16, 32))
    total, (logs, renders, lods) = ptrainer.vae_loss_fn(
        pm, batch, 0, cfg, generator=g)
    assert len(lods) == 3 and len(renders) == 1
    assert torch.isfinite(total) and "coarse_lod_loss" in logs
    assert "l1_lod2" in logs and "l1_lod0" not in logs


def test_train_cli_runs_and_resumes(tmp_path):
    """`cli.train_vae.main` on the CPU at a tiny config, with the release
    recipe's flags: the PatchGAN (`--adv`: discriminator steps on odd
    steps), a packed dataset with one held-out instance evaluated every
    step, and the encoder grafted from the run's own checkpoint. Steps
    counted, parameters and EMA moved, the log, the evaluation PNGs and
    both networks' checkpoints written, and `--resume` continues both;
    `--platform` (the JAX CLI's) is `--device` here."""
    from gaussiananything_tpu_torch.cli import train_vae
    from gaussiananything_tpu_torch.config import preset
    from gaussiananything_tpu_torch.data.gbuffer import \
        export_synthetic_dataset
    cfg = preset("demo-e2e")
    cfg.data.resolution, cfg.data.n_points = 32, 64
    cfg.render.lod_resolutions = (16, 32)
    cfg.vae.latent_num, cfg.vae.decoder_width = 12, 64
    cfg.vae.encoder_width = 64
    cfg.optim.batch_size, cfg.optim.warmup_steps = 1, 1
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    data = str(tmp_path / "data")
    export_synthetic_dataset(data, n_instances=3, n_views=4, res=32,
                             n_splats=256)
    logdir = str(tmp_path / "run")
    common = ["--config", str(path), "--logdir", logdir, "--device", "cpu",
              "--adv", "--data-dir", data, "--holdout", "1",
              "--eval-every", "1"]
    timers = []
    res = train_vae.main(common + ["--steps", "2"], timers=timers)
    assert res["state"].step == 2 and len(res["logs"]) == 2
    assert res["disc_state"].step == 1 and len(res["d_logs"]) == 1
    assert len(res["evals"]) == 2
    assert all(np.isfinite(v) for lg in res["logs"] + res["d_logs"]
               + res["evals"] for v in lg.values())
    assert {"g_loss", "adaptive_w"} <= set(res["logs"][0])
    assert {"data", "forward", "render", "adversarial", "loss", "backward",
            "optimizer", "eval"} <= set(timers[0])
    assert "disc_step" in timers[1]
    for name in ("progress.csv", "eval/eval_0000001.png",
                 "eval/eval_0000002.png", "ckpt/step_00000002.pt",
                 "ckpt_disc/step_00000001.pt"):
        assert os.path.exists(os.path.join(logdir, name)), name
    state, model = res["state"], res["model"]
    assert any(not torch.equal(state.ema[k], p.detach())
               for k, p in state.params.items())
    ckpt = os.path.join(logdir, "ckpt")
    res2 = train_vae.main(common + ["--steps", "4", "--resume", ckpt,
                                    "--load-submodule", f"encoder={ckpt}"])
    assert res2["state"].step == 4 and len(res2["logs"]) == 2
    assert res2["disc_state"].step == 2
    saved = torch.load(os.path.join(ckpt, "step_00000002.pt"))
    assert not any(torch.equal(saved["params"][k], v.detach())
                   for k, v in res2["state"].params.items()
                   if k.startswith("encoder."))
    with pytest.raises(SystemExit):
        train_vae.main(["--platform", "cpu", "--device", "cpu"])
