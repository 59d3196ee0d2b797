"""The port's gradient accumulation (`make_accum_train_step`) against the
JAX package's on the CPU: two micro-batches of one, the same weights
(through `from_jax_params`), batch and per-micro-batch draws (JAX draws
micro-batch i from `fold_in(rng, i)`)."""
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

SIZES = dict(latent_num=12, z_channels=4, decoder_width=64, decoder_depth=2,
             decoder_heads=2, up_factors=(4,), up_depths=(1,))
LODS = (16, 32)
LATENT = (SIZES["latent_num"], SIZES["z_channels"])
LOSS = dict(lod_resolutions=LODS, normal_start_step=0, dist_start_step=0,
            kl_anneal_steps=2)
TX = dict(lr=1e-3, warmup_steps=2)
N_MICRO, N_STEPS = 2, 2


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _perceptual_net():
    _, p = JL._perceptual_params()
    net = L.PerceptualNet()
    net.load_state_dict(from_jax_params(p, net))
    return net.requires_grad_(False)


def _micro_draws(rng):
    """The draws of `make_accum_train_step`'s micro-batch i: `vae_loss_fn`
    on `fold_in(rng, i)` (`vae_trainer.py:122-141, 386`)."""
    out = []
    for i in range(N_MICRO):
        rng_s, rng_lpips, _ = jax.random.split(jax.random.fold_in(rng, i), 3)
        out.append({"noise": t(jax.random.normal(rng_s, (1,) + LATENT)),
                    "lpips_lod": int(jax.random.randint(rng_lpips, (), 0,
                                                        len(LODS)))})
    return out


@pytest.fixture(scope="module")
def accumulated():
    pbatch = {k: v for k, v in make_batch(
        seed=3, batch=2, n_views_in=2, n_views_sup=2, res=32, n_pts=128,
        n_splats=256).items() if k != "gt_gaussians"}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in pbatch.items()}
    jm = JPointVAE(encoder_width=256, release_parity=True, **SIZES)
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(jm.init)(key, jbatch["images_in"][:1],
                               jbatch["pcd"][:1], key)
    jcfg = jstate.TrainStateConfig(**TX)
    jstep = jtrainer.make_accum_train_step(
        jm, jtrainer.VAELossConfig(**LOSS), N_MICRO, tx_cfg=jcfg)
    js = jstate.TrainState.create(jparams, jstate.make_optimizer(jcfg))
    pm = PointVAE(encoder_width=256, release_parity=True, with_encoder=True,
                  **SIZES)
    init = from_jax_params(jax.tree.map(np.asarray, jparams), pm)
    pm.load_state_dict(init)
    pstep = ptrainer.make_accum_train_step(
        pm, ptrainer.VAELossConfig(**LOSS), N_MICRO,
        pstate.TrainStateConfig(**TX), perceptual_net=_perceptual_net())
    ps = pstate.TrainState.create(pm)
    jlogs, plogs, draws = [], [], []
    for i in range(N_STEPS):
        rng = jax.random.fold_in(jax.random.PRNGKey(5), i)
        js, jl = jstep(js, jbatch, rng)
        jlogs.append({k: float(v) for k, v in jl.items()})
        draws.append(_micro_draws(rng))
        plogs.append({k: float(v) for k, v in pstep(
            ps, pbatch, draws=draws[-1]).items()})
    return dict(jlogs=jlogs, plogs=plogs, js=js, ps=ps, pm=pm, init=init,
                pbatch=pbatch, draws=draws)


def test_accum_logs_match_jax(accumulated):
    """Each log is the mean over the micro-batches and `grad_norm` that of
    the averaged gradient: rtol 2e-3 on the losses and 5e-3 on
    `grad_norm` at the first step, 1e-2 after it (test_torch_training.py's
    tolerances)."""
    for i, (pl, jl) in enumerate(zip(accumulated["plogs"],
                                     accumulated["jlogs"])):
        assert set(pl) == set(jl)
        for k in jl:
            rtol = 1e-2 if i else (5e-3 if k == "grad_norm" else 2e-3)
            np.testing.assert_allclose(pl[k], jl[k], rtol=rtol, atol=1e-5,
                                       err_msg=f"step {i} {k}")


def test_accum_parameters_match_jax(accumulated):
    """After N_STEPS single optimiser steps (the first at lr 0) the
    parameters and EMA agree with JAX's. Adam divides each gradient
    element by its own running magnitude, so an element whose gradient
    sits at the rounding floor (the surfel head's, zero by construction at
    init) moves by a whole learning rate, 5e-4, either way in either
    package: no element further apart than twice that, at most 1% of
    all elements beyond 2e-4 (test_torch_training.py's share)."""
    ps, js = accumulated["ps"], accumulated["js"]
    assert ps.step == int(js.step) == N_STEPS
    ref = from_jax_params(jax.tree.map(np.asarray, js.params),
                          accumulated["pm"])
    ema = from_jax_params(jax.tree.map(np.asarray, js.ema_params),
                          accumulated["pm"])
    beyond = count = 0
    for k, p in ps.params.items():
        for got, want in ((p.detach(), ref[k]), (ps.ema[k], ema[k])):
            d = (got - want).abs()
            assert float(d.max()) <= 2 * 5e-4 + 1e-6, k
            beyond += int((d > 2e-4).sum())
            count += d.numel()
    assert beyond <= 0.01 * count, (beyond, count)


def test_accum_is_the_mean_of_the_micro_gradients(accumulated):
    """The port's accumulated gradient equals the mean of the two
    micro-batches' gradients taken one by one (the same port code, so
    rtol 1e-5), and one accumulated step is one optimiser update."""
    pm = accumulated["pm"]
    pm.load_state_dict(accumulated["init"])
    state = pstate.TrainState.create(pm)
    cfg = ptrainer.VAELossConfig(**LOSS)
    batch, draws = accumulated["pbatch"], accumulated["draws"][0]
    manual = None
    for i in range(N_MICRO):
        sub = {k: v[i:i + 1] if v.dim() else v for k, v in batch.items()}
        total = ptrainer.vae_loss_fn(pm, sub, 0, cfg, draws=draws[i],
                                     perceptual_net=_perceptual_net())[0]
        g = torch.autograd.grad(total, list(state.params.values()),
                                allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for x, p in zip(g, state.params.values())]
        manual = g if manual is None else [a + b for a, b in zip(manual, g)]
    want = float(torch.sqrt(sum((x / N_MICRO).pow(2).sum()
                                for x in manual)))
    step = ptrainer.make_accum_train_step(pm, cfg, N_MICRO,
                                          perceptual_net=_perceptual_net())
    logs = step(state, batch, draws=draws)
    np.testing.assert_allclose(float(logs["grad_norm"]), want, rtol=1e-5)
    assert state.step == 1


def test_accum_refuses_a_batch_it_cannot_split(accumulated):
    step = ptrainer.make_accum_train_step(
        accumulated["pm"], ptrainer.VAELossConfig(**LOSS), 3)
    with pytest.raises(ValueError, match="micro-batches"):
        step(pstate.TrainState.create(accumulated["pm"]),
             accumulated["pbatch"])
