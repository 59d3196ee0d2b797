"""The port's PatchGAN path against the JAX package on the CPU: the
discriminator and hinge losses, the adversarial generator step (adaptive
weight, the start-step gate), the discriminator's step, and the warm start
of one submodule (`load_submodule`). The same numpy inputs, weights
(through `from_jax_params`), batch and random draws go through both."""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.train import losses as JL
from gaussiananything_tpu.train import state as jstate
from gaussiananything_tpu.train import vae_trainer as jtrainer
from gaussiananything_tpu_torch.data.synthetic import make_batch
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.train import losses as L
from gaussiananything_tpu_torch.train import state as pstate
from gaussiananything_tpu_torch.train import vae_trainer as ptrainer
from gaussiananything_tpu_torch.utils.param_io import from_jax_params

torch.set_num_threads(2)

# the step tests' sizes (test_torch_training.py), the release layout
SIZES = dict(latent_num=12, z_channels=4, decoder_width=64, decoder_depth=2,
             decoder_heads=2, up_factors=(4,), up_depths=(1,))
LODS = (16, 32)
LATENT = (SIZES["latent_num"], SIZES["z_channels"])
ADV = dict(lod_resolutions=LODS, normal_start_step=0, dist_start_step=0,
           kl_anneal_steps=2, adv_weight=0.1)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _jax_perceptual_net():
    _, p = JL._perceptual_params()
    net = L.PerceptualNet()
    net.load_state_dict(from_jax_params(p, net))
    return net.requires_grad_(False)


def _jax_draws(rng, batch_size):
    """The draws `vae_loss_fn` makes from `rng` (`vae_trainer.py:122-141`,
    `models/vae.py:40-43`)."""
    rng_s, rng_lpips, _ = jax.random.split(rng, 3)
    return {"noise": t(jax.random.normal(rng_s, (batch_size,) + LATENT)),
            "lpips_lod": int(jax.random.randint(rng_lpips, (), 0,
                                                len(LODS)))}


@pytest.fixture(scope="module")
def setup():
    """Both packages' VAE and discriminator from the same weights, and one
    batch of 1 (`make_batch` is held to JAX's in test_torch_encoder.py)."""
    pbatch = {k: v for k, v in make_batch(
        seed=0, batch=1, n_views_in=2, n_views_sup=2, res=32, n_pts=128,
        n_splats=256).items() if k != "gt_gaussians"}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in pbatch.items()}
    jm = JPointVAE(encoder_width=256, release_parity=True, **SIZES)
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(jm.init)(key, jbatch["images_in"], jbatch["pcd"], key)
    jdisc = JL.PatchDiscriminator(ch=32, layers=2)
    jdp = jdisc.init(jax.random.PRNGKey(2), jnp.zeros((1, 3, 32, 32)))
    return dict(pbatch=pbatch, jbatch=jbatch, jm=jm, jparams=jparams,
                jdisc=jdisc, jdp=jdp)


def _port_models(s):
    pm = PointVAE(encoder_width=256, release_parity=True, with_encoder=True,
                  **SIZES)
    pm.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, s["jparams"]), pm))
    pd = L.PatchDiscriminator(ch=32, layers=2)
    pd.load_state_dict(from_jax_params(jax.tree.map(np.asarray, s["jdp"]),
                                       pd))
    return pm, pd


# ------------------------------------------------------------ the pieces

@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (1, 3, 24, 40)])
def test_patch_discriminator_matches_jax(setup, shape):
    """Logits of the same weights on the same images: rtol 1e-4 / atol
    1e-5 (fp32 convolutions and GroupNorm statistics, other sum orders).
    The odd shape pads asymmetrically at stride 1, as flax's "SAME"."""
    _, pd = _port_models(setup)
    x = np.random.default_rng(3).uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(setup["jdisc"].apply(setup["jdp"], jnp.asarray(x)))
    with torch.no_grad():
        got = pd(t(x)).numpy()
    assert got.shape == np.moveaxis(ref, -1, 1).shape
    np.testing.assert_allclose(got, np.moveaxis(ref, -1, 1), rtol=1e-4,
                               atol=1e-5)


def test_hinge_losses_match_jax():
    r = np.random.default_rng(0)
    real, fake = r.normal(size=(2, 1, 5, 5)), r.normal(size=(2, 1, 5, 5))
    np.testing.assert_allclose(
        float(L.hinge_d_loss(t(real), t(fake))),
        float(JL.hinge_d_loss(jnp.asarray(real, jnp.float32),
                              jnp.asarray(fake, jnp.float32))), rtol=1e-6)
    np.testing.assert_allclose(float(L.hinge_g_loss(t(fake))),
                               float(JL.hinge_g_loss(
                                   jnp.asarray(fake, jnp.float32))),
                               rtol=1e-6)


# --------------------------------------------- the adversarial G-step

N_STEPS = 2


@pytest.fixture(scope="module")
def adv_steps(setup):
    """N_STEPS adversarial generator steps of both packages, adaptive
    weight on, the discriminator fixed."""
    s = setup
    tx_kw = dict(lr=1e-3, warmup_steps=2)
    jcfg = jstate.TrainStateConfig(**tx_kw)
    jstep = jtrainer.make_train_step(
        s["jm"], jtrainer.VAELossConfig(**ADV), jcfg, disc_model=s["jdisc"])
    js = jstate.TrainState.create(s["jparams"], jstate.make_optimizer(jcfg))
    pm, pd = _port_models(s)
    pd.requires_grad_(True)
    pstep = ptrainer.make_train_step(
        pm, ptrainer.VAELossConfig(**ADV), pstate.TrainStateConfig(**tx_kw),
        perceptual_net=_jax_perceptual_net(), disc_model=pd)
    ps = pstate.TrainState.create(pm)
    key = jax.random.PRNGKey(7)
    jlogs, plogs = [], []
    for i in range(N_STEPS):
        rng = jax.random.fold_in(key, i)
        js, jl = jstep(js, s["jbatch"], rng, s["jdp"])
        jlogs.append({k: float(v) for k, v in jl.items()})
        plogs.append({k: float(v) for k, v in pstep(
            ps, s["pbatch"], draws=_jax_draws(rng, 1)).items()})
    return dict(jlogs=jlogs, plogs=plogs, pd=pd)


def test_adv_train_step_logs_match_jax(adv_steps):
    """Every log of each step, `total`, `g_loss` and `adaptive_w` among
    them: the tolerances of test_torch_training.py (rtol 2e-3 on losses at
    the first step, 1e-2 after it, once the parameters have drifted within
    tolerance); `grad_norm` and `adaptive_w`, a ratio of two gradient
    norms, 5e-3 at the first step."""
    for i, (pl, jl) in enumerate(zip(adv_steps["plogs"],
                                     adv_steps["jlogs"])):
        assert set(pl) == set(jl)
        assert {"g_loss", "adaptive_w"} <= set(pl)
        for k in jl:
            rtol = 1e-2 if i else (5e-3 if k in ("grad_norm", "adaptive_w")
                                   else 2e-3)
            np.testing.assert_allclose(pl[k], jl[k], rtol=rtol, atol=1e-5,
                                       err_msg=f"step {i} {k}")
        assert 0.0 < pl["adaptive_w"] <= 1e4


def test_adaptive_weight_gives_no_gradient_to_the_discriminator(adv_steps):
    """The two gradient calls of the adaptive weight and the step's own
    gradient are taken with explicit inputs: no parameter's `.grad` is
    written."""
    assert all(p.grad is None for p in adv_steps["pd"].parameters())


@pytest.fixture(scope="module")
def gated(setup):
    """The loss without the adaptive weight, at step 0 and 1 with
    `adv_start_step` 1: the gate closed, then open (kl_anneal_steps 2, so
    the KL weight differs between the two as well)."""
    s = setup
    cfg = dict(ADV, adaptive_adv=False, adv_start_step=1)
    jloss = jax.jit(lambda p, b, r, st, dp: jtrainer.vae_loss_fn(
        p, s["jm"], b, r, st, jtrainer.VAELossConfig(**cfg), dp,
        s["jdisc"])[:2])
    pm, pd = _port_models(s)
    out = {}
    for step in (0, 1):
        rng = jax.random.PRNGKey(11 + step)
        jt, (jl, _, _) = jloss(s["jparams"], s["jbatch"], rng,
                               jnp.asarray(step, jnp.int32), s["jdp"])
        with torch.no_grad():
            pt, (pl, _, _) = ptrainer.vae_loss_fn(
                pm, s["pbatch"], step, ptrainer.VAELossConfig(**cfg),
                draws=_jax_draws(rng, 1),
                perceptual_net=_jax_perceptual_net(), disc_model=pd)
        out[step] = ({k: float(v) for k, v in jl.items()},
                     {k: float(v) for k, v in pl.items()})
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_adv_gate_and_fixed_weight_match_jax(gated, step):
    """Every log within 2e-3 of JAX's, `total` and `g_loss` among them
    (with the gate closed at step 0 JAX's total leaves the generator's
    term out, with it open at step 1 it carries 0.1 · g_loss); no
    `adaptive_w`."""
    jl, pl = gated[step]
    assert "adaptive_w" not in pl and set(pl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(pl[k], jl[k], rtol=2e-3, atol=1e-5,
                                   err_msg=k)


def test_adv_weight_zero_or_no_disc_leaves_the_loss(setup):
    """Without a discriminator, or with `adv_weight` 0, no adversarial
    term and no adversarial log."""
    pm, pd = _port_models(setup)
    base = ptrainer.VAELossConfig(**dict(ADV, adv_weight=0.0))
    draws = {"noise": torch.zeros((1,) + LATENT), "lpips_lod": 0}
    with torch.no_grad():
        a, (la, _, _) = ptrainer.vae_loss_fn(pm, setup["pbatch"], 0, base,
                                             draws=draws, disc_model=pd)
        b, (lb, _, _) = ptrainer.vae_loss_fn(
            pm, setup["pbatch"], 0, ptrainer.VAELossConfig(**ADV),
            draws=draws)
    assert "g_loss" not in la and "g_loss" not in lb
    assert float(a) == float(b)


# ------------------------------------------------ the discriminator step

@pytest.fixture(scope="module")
def disc_stepped(setup):
    s = setup
    tx_kw = dict(lr=1e-2, warmup_steps=1)
    jcfg = jstate.TrainStateConfig(**tx_kw)
    cfg = dict(ADV)
    jstep = jtrainer.make_disc_step(s["jm"], s["jdisc"],
                                    jtrainer.VAELossConfig(**cfg), jcfg)
    jds = jstate.TrainState.create(s["jdp"], jstate.make_optimizer(jcfg))
    pm, pd = _port_models(s)
    pds = pstate.TrainState.create(pd)
    pstep = ptrainer.make_disc_step(pm, pd, ptrainer.VAELossConfig(**cfg),
                                    pstate.TrainStateConfig(**tx_kw))
    jlogs, plogs = [], []
    for i in range(2):          # the first update runs at lr 0
        rng = jax.random.PRNGKey(20 + i)
        jds, jl = jstep(jds, s["jparams"], s["jbatch"], rng)
        jlogs.append(float(jl["d_loss"]))
        noise = t(jax.random.normal(rng, (1,) + LATENT))
        plogs.append(float(pstep(pds, s["pbatch"],
                                 draws={"noise": noise})["d_loss"]))
    return dict(jds=jds, pds=pds, pd=pd, jlogs=jlogs, plogs=plogs,
                init=from_jax_params(jax.tree.map(np.asarray, s["jdp"]), pd))


def test_disc_step_matches_jax(disc_stepped):
    """`d_loss` of both steps within 2e-3; after them the discriminator's
    parameters agree with JAX's within 2e-4 + 1e-3 relative (two Adam
    updates of lr 1e-2: an element whose gradient sits at the rounding
    floor moves by up to a learning rate either way, so at most 1% of the
    elements may differ by more than 2e-4, none by more than 1e-2)."""
    d = disc_stepped
    np.testing.assert_allclose(d["plogs"], d["jlogs"], rtol=2e-3, atol=1e-5)
    assert d["pds"].step == int(d["jds"].step) == 2
    ref = from_jax_params(jax.tree.map(np.asarray, d["jds"].params), d["pd"])
    beyond = count = 0
    for k, p in d["pds"].params.items():
        diff = (p.detach() - ref[k]).abs()
        assert float(diff.max()) <= 1e-2 + 1e-6, k
        beyond += int((diff > 2e-4 + 1e-3 * ref[k].abs()).sum())
        count += diff.numel()
    assert beyond <= 0.01 * count, (beyond, count)
    assert max(float((p.detach() - d["init"][k]).abs().max())
               for k, p in d["pds"].params.items()) > 1e-3


def test_disc_step_leaves_the_generator(setup):
    """The discriminator's step changes only the discriminator."""
    pm, pd = _port_models(setup)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    pds = pstate.TrainState.create(pd)
    step = ptrainer.make_disc_step(pm, pd, ptrainer.VAELossConfig(**ADV))
    logs = step(pds, setup["pbatch"], generator=torch.Generator()
                .manual_seed(0))
    assert np.isfinite(float(logs["d_loss"])) and pds.step == 1
    assert all(torch.equal(before[k], v) for k, v in pm.state_dict().items())
    assert all(p.grad is None for p in pm.parameters())


# ------------------------------------------------------- load_submodule

def _two_module_state(seed, enc_shape=(4, 4), extra=(0.5,)):
    g = torch.Generator().manual_seed(seed)
    params = {"encoder.w": torch.nn.Parameter(torch.randn(enc_shape,
                                                          generator=g)),
              "encoder.b": torch.nn.Parameter(torch.randn(4, generator=g)),
              "decoder.w": torch.nn.Parameter(torch.randn((4, 4),
                                                          generator=g))}
    return pstate.TrainState(params, extra_ema_decays=extra)


def test_load_submodule_grafts_one_submodule(tmp_path):
    """Parameters, EMA and extra-rate EMA of `encoder.*` come from the
    checkpoint (its EMA with `ema=True`); `decoder.*`, the moments and the
    step stay."""
    cfg = pstate.TrainStateConfig(lr=1e-2, warmup_steps=1,
                                  extra_ema_decays=(0.5,))
    src = _two_module_state(1)
    for _ in range(3):
        src.apply_gradients({k: torch.ones_like(p)
                             for k, p in src.params.items()}, cfg)
    pstate.save_checkpoint(str(tmp_path), src)
    for ema in (False, True):
        dst = _two_module_state(2)
        dst.apply_gradients({k: torch.full_like(p, 0.5)
                             for k, p in dst.params.items()}, cfg)
        keep = {n: {k: v.clone() for k, v in getattr(dst, n).items()}
                for n in ("params", "mu", "nu")}
        out = pstate.load_submodule(str(tmp_path), dst, "encoder", ema=ema)
        assert out is dst and dst.step == 1
        want = src.ema if ema else src.params
        for tree in (dst.params, dst.ema, dst.ema_extra["0.5"]):
            for k in ("encoder.w", "encoder.b"):
                assert torch.equal(tree[k].detach(), want[k].detach())
            assert not torch.equal(tree["decoder.w"].detach(),
                                   src.params["decoder.w"].detach())
        assert torch.equal(dst.params["decoder.w"].detach(),
                           keep["params"]["decoder.w"])
        for n in ("mu", "nu"):
            for k, v in keep[n].items():
                assert torch.equal(getattr(dst, n)[k], v)


def test_load_submodule_refuses_what_it_cannot_graft(tmp_path):
    pstate.save_checkpoint(str(tmp_path), _two_module_state(1))
    with pytest.raises(KeyError, match="available: \\['decoder', "
                                       "'encoder'\\]"):
        pstate.load_submodule(str(tmp_path), _two_module_state(2),
                              "upsampler")
    with pytest.raises(ValueError, match="shape"):
        pstate.load_submodule(str(tmp_path),
                              _two_module_state(2, enc_shape=(2, 2)),
                              "encoder")
    fewer = _two_module_state(2)
    del fewer.params["encoder.b"]
    with pytest.raises(ValueError, match="structure"):
        pstate.load_submodule(str(tmp_path), fewer, "encoder")
