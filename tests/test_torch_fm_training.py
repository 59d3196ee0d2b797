"""The port's flow-matching training against the JAX package on the CPU:
the ucg keep mask, `remat`, `make_fm_train_step` for two steps in four
variants (stage 1, stage 2, a frozen conditioner, two micro-batches), the
sampler's dopri5 branch and `split_stage2`. Tiny widths: a non-release
DiT-S cut to depth 2 and width 64, a depth-1 scratch ViT conditioner of
width 32 at 28², 24 latents. The weights are seeded numpy values carried
by `from_jax_params`; every JAX draw (the ucg mask, t, the noise) is
handed to the port."""
from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussiananything_tpu.diffusion.transport import \
    create_transport as jcreate_transport
from gaussiananything_tpu.models import conditioner as jcond
from gaussiananything_tpu.models.dit import PointDiT as JPointDiT
from gaussiananything_tpu.models.dit import stage1_dit as jstage1_dit
from gaussiananything_tpu.models.dit import stage2_dit as jstage2_dit
from gaussiananything_tpu.train import fm_trainer as jfm
from gaussiananything_tpu.train import state as jstate
from gaussiananything_tpu_torch.diffusion.transport import create_transport
from gaussiananything_tpu_torch.models import conditioner as cond
from gaussiananything_tpu_torch.models.dit import (PointDiT, stage1_dit,
                                                   stage2_dit)
from gaussiananything_tpu_torch.train import fm_trainer as fm
from gaussiananything_tpu_torch.train import state as pstate
from gaussiananything_tpu_torch.utils.param_io import from_jax_params
from test_torch_models import carry, randomize, t

torch.set_num_threads(2)

W, CW, K, ZC, IMG, B = 64, 32, 24, 4, 28, 4
DIT = dict(depth=2, width=W, heads=4, cond_dim=CW, vector_dim=CW)
COND = dict(width=CW, depth=1, heads=2, ucg_rate=0.5)
TX = dict(lr=1e-3, warmup_steps=2)
LR_STEP2 = 1e-3 / 2           # the second update's learning rate
N_STEPS = 2
# the losses, t_mean and grad_norm: rtol 2e-3 / 5e-3 at the first step,
# 1e-2 after it (`tests/test_torch_accum.py`'s bounds)
LOG_RTOL = {"fm_loss": 2e-3, "t_mean": 1e-6, "grad_norm": 5e-3}


def _batch(stage, seed=0):
    r = np.random.default_rng(seed)
    b = {"cond": r.uniform(size=(B, 3, IMG, IMG)).astype(np.float32)}
    xyz = r.normal(size=(B, K, 3)).astype(np.float32) * 0.3
    if stage == 1:
        b["latent"] = xyz / jfm.XYZ_SCALE
    else:
        b["latent"] = r.normal(size=(B, K, ZC)).astype(np.float32)
        b["xyz"] = xyz
    return b


def _models(stage):
    jc = jcond.ImageConditioner(img_size=IMG, **COND)
    pc = cond.ImageConditioner(img_size=IMG, backbone="scratch", **COND)
    if stage == 1:
        jd, pd = jstage1_dit("S", **DIT), stage1_dit("S", **DIT)
    else:
        jd = jstage2_dit("S", z_channels=ZC, **DIT)
        pd = stage2_dit("S", z_channels=ZC, **DIT)
    return jc, pc, jd, pd


def _init(stage, batch):
    jc, pc, jd, pd = _models(stage)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cp = randomize(jc, 1, jb["cond"][:1])
    c0 = jc.apply(cp, jb["cond"][:1])
    kw = {"xyz": jb["xyz"][:1]} if stage == 2 else {}
    dp = randomize(jd, 2, jb["latent"][:1], jnp.zeros((1,)), c0.crossattn,
                   c0.vector, **kw)
    pc = carry(cp, pc).train()
    pd = carry(dp, pd).train()
    return jc, pc, jd, pd, jax.tree.map(jnp.asarray, cp), \
        jax.tree.map(jnp.asarray, dp)


def _micro_rngs(rng, accum):
    return [rng] if accum == 1 else [jax.random.fold_in(rng, i)
                                     for i in range(accum)]


def _jax_draws(rng, accum, mb, latent_shape, ucg_rate):
    """The draws `make_fm_train_step` makes from `rng`: per micro-batch
    rng_c, rng_t = split(rng_i); keep = bernoulli(rng_c); inside
    `training_loss` t = uniform(split(rng_t)[0]), x0 = normal(...[1])."""
    out = []
    for r in _micro_rngs(rng, accum):
        rng_c, rng_t = jax.random.split(r)
        rt, rn = jax.random.split(rng_t)
        out.append({
            "keep": t(jax.random.bernoulli(rng_c, 1.0 - ucg_rate,
                                           (mb, 1, 1))),
            "t": t(jax.random.uniform(rt, (mb,), minval=1e-5,
                                      maxval=1 - 1e-5)),
            "x0": t(jax.random.normal(rn, (mb,) + latent_shape))})
    return out


def _jax_grad_norm(jd, jc, dp, cp, jb, rng, stage, accum, train_cond):
    """The norm of the JAX step's averaged DiT gradient, taken with the
    JAX package's own conditioner and transport on the step's rng."""
    transport = jcreate_transport()
    mb = B // accum

    def loss(dp_, cp_, sub, r):
        rng_c, rng_t = jax.random.split(r)
        if not train_cond:
            cp_ = jax.lax.stop_gradient(cp_)
        c = jc.apply(cp_, sub["cond"], rng=rng_c, train=True)
        kw = {"xyz": sub["xyz"]} if stage == 2 else {}
        return transport.training_loss(
            lambda xt, tt: jd.apply(dp_, xt, tt, c.crossattn, c.vector,
                                    **kw), rng_t, sub["latent"])[0]

    grad = jax.jit(jax.grad(loss))
    total = None
    for i, r in enumerate(_micro_rngs(rng, accum)):
        sub = {k: v[i * mb:(i + 1) * mb] for k, v in jb.items()}
        g = grad(dp, cp, sub, r)
        total = g if total is None else jax.tree.map(jnp.add, total, g)
    return float(optax.global_norm(jax.tree.map(lambda a: a / accum,
                                                total)))


VARIANTS = {"stage1": (1, True, 1), "stage2": (2, True, 1),
            "frozen": (1, False, 1), "accum2": (1, True, 2)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def trained(request):
    stage, train_cond, accum = VARIANTS[request.param]
    batch = _batch(stage)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: t(v) for k, v in batch.items()}
    jc, pc, jd, pd, cp, dp = _init(stage, batch)
    cp0, dp0 = cp, dp
    jcfg = jstate.TrainStateConfig(**TX)
    jstep = jfm.make_fm_train_step(jd, jc, jcreate_transport(),
                                   jfm.FMConfig(stage=stage), jcfg,
                                   train_conditioner=train_cond, accum=accum)
    tx = jstate.make_optimizer(jcfg)
    js = jstate.TrainState.create(dp, tx)
    jcs = jstate.TrainState.create(cp, tx if train_cond
                                   else optax.identity())
    pstep = fm.make_fm_train_step(pd, pc, create_transport(),
                                  fm.FMConfig(stage=stage),
                                  pstate.TrainStateConfig(**TX),
                                  accum=accum)
    ps = pstate.TrainState.create(pd)
    pcs = pstate.TrainState.create(pc, frozen=not train_cond)
    latent_shape = (K, 3 if stage == 1 else ZC)
    jlogs, plogs, norms = [], [], []
    for i in range(N_STEPS):
        rng = jax.random.fold_in(jax.random.PRNGKey(7), i)
        if i == 0:
            norms.append(_jax_grad_norm(jd, jc, dp0, cp0, jb, rng, stage,
                                        accum, train_cond))
        js, jcs, jl = jstep(js, jcs, jb, rng)
        jlogs.append({k: float(v) for k, v in jl.items()})
        draws = _jax_draws(rng, accum, B // accum, latent_shape,
                           COND["ucg_rate"])
        plogs.append({k: float(v) for k, v in
                      pstep(ps, pcs, pb, draws=draws).items()})
    return dict(jlogs=jlogs, plogs=plogs, norm0=norms[0], js=js, jcs=jcs,
                ps=ps, pcs=pcs, pd=pd, pc=pc, train_cond=train_cond,
                name=request.param)


def test_fm_step_logs_match_jax(trained):
    """fm_loss and t_mean against the JAX step's logs (t_mean is the mean
    of the handed-over draws), grad_norm against the norm of JAX's
    gradient at the first step."""
    for i, (pl, jl) in enumerate(zip(trained["plogs"], trained["jlogs"])):
        assert set(jl) == {"fm_loss", "t_mean"}
        for k in jl:
            rtol = LOG_RTOL[k] if i == 0 else max(LOG_RTOL[k], 1e-2 * (
                k == "fm_loss"))
            np.testing.assert_allclose(pl[k], jl[k], rtol=rtol, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    np.testing.assert_allclose(trained["plogs"][0]["grad_norm"],
                               trained["norm0"], rtol=LOG_RTOL["grad_norm"])


def _param_gaps(got_tree, want_np, module):
    want = from_jax_params(jax.tree.map(np.asarray, want_np), module)
    beyond = count = 0
    worst = 0.0
    for k, v in got_tree.items():
        d = (v.detach() - want[k]).abs()
        worst = max(worst, float(d.max()))
        beyond += int((d > 2e-4).sum())
        count += d.numel()
    return worst, beyond, count


def test_fm_step_parameters_match_jax(trained):
    """After two updates (the first at lr 0) the DiT's parameters and EMA,
    and a trained conditioner's parameters and EMA (at 0.5× lr), agree
    with JAX's within test_torch_accum.py's bounds: no element further
    apart than two of the second update's learning rate (Adam moves an
    element whose gradient sits at the rounding floor by a whole lr either
    way), at most 1% of the elements beyond 2e-4. A frozen conditioner
    does not move at all."""
    ps, js, pcs, jcs = (trained[k] for k in ("ps", "js", "pcs", "jcs"))
    assert ps.step == int(js.step) == N_STEPS
    for got, want in ((ps.params, js.params), (ps.ema, js.ema_params)):
        worst, beyond, count = _param_gaps(got, want, trained["pd"])
        assert worst <= 2 * LR_STEP2 + 1e-6, worst
        assert beyond <= 0.01 * count, (beyond, count)
    if trained["train_cond"]:
        assert pcs.step == int(jcs.step) == N_STEPS
        for got, want in ((pcs.params, jcs.params),
                          (pcs.ema, jcs.ema_params)):
            worst, beyond, count = _param_gaps(got, want, trained["pc"])
            assert worst <= LR_STEP2 + 1e-6, worst
            assert beyond <= 0.01 * count, (beyond, count)
    else:
        assert pcs.frozen and pcs.step == 0 and not pcs.mu and not pcs.nu
        assert pcs.ema is pcs.params
        worst, _, _ = _param_gaps(pcs.params, jcs.params, trained["pc"])
        assert worst == 0.0


# ---------------------------------------------------------------- ucg mask

@pytest.mark.parametrize("kind", ["image", "text"])
def test_ucg_keep_mask_matches_jax(kind):
    """Both conditioners zero a sample's tokens and pooled vector where the
    handed-over bernoulli mask is 0 in training mode, as the JAX
    conditioners do on the same rng; in eval mode nothing is dropped.
    Tolerance: the conditioners' rtol/atol 2e-4 (`tests/test_torch_text.py`)."""
    rng = jax.random.PRNGKey(3)
    n = 6
    if kind == "image":
        x = np.random.default_rng(0).uniform(size=(n, 3, IMG, IMG)).astype(
            np.float32)
        jm = jcond.ImageConditioner(img_size=IMG, **COND)
        pm = cond.ImageConditioner(img_size=IMG, backbone="scratch", **COND)
        px = t(x)
    else:
        x = jcond.tokenize_bytes(["a chair", "red", "x", "two words", "",
                                  "cat"])
        jm = jcond.TextConditioner(width=CW, depth=1, heads=2, max_len=77,
                                   ucg_rate=0.5)
        pm = cond.TextConditioner(width=CW, depth=1, heads=2, ucg_rate=0.5)
        px = torch.from_numpy(x).long()
    p = randomize(jm, 4, jnp.asarray(x))
    pm = carry(p, pm)
    ref = jm.apply(p, jnp.asarray(x), rng=rng, train=True)
    keep = t(jax.random.bernoulli(rng, 0.5, (n, 1, 1)))
    assert 0 < float(keep.sum()) < n          # both branches exercised
    with torch.no_grad():
        got = pm.train()(px, keep=keep)
        plain = pm.eval()(px)
    np.testing.assert_allclose(got.crossattn.numpy(),
                               np.asarray(ref.crossattn), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got.vector.numpy(), np.asarray(ref.vector),
                               rtol=2e-4, atol=2e-4)
    dropped = keep[:, 0, 0] == 0
    assert float(got.crossattn[dropped].abs().max()) == 0.0
    assert float(got.vector[dropped].abs().max()) == 0.0
    assert torch.equal(got.crossattn[~dropped], plain.crossattn[~dropped])
    # drawn from a generator: the JAX rule, a uniform below 1 − ucg_rate
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    mask = cond.ucg_keep_mask(4096, 0.1, g1)
    assert mask.shape == (4096, 1, 1)
    assert torch.equal(mask, (torch.rand((4096, 1, 1), generator=g2)
                              < 0.9).float())
    assert abs(float(mask.mean()) - 0.9) < 0.02


# ------------------------------------------------------------------- remat

def test_remat_changes_nothing():
    """The DiT with per-block checkpointing gives the same loss and the
    same gradients, bit for bit on the CPU, as without it; it stays off
    without gradients."""
    torch.manual_seed(0)
    plain = stage2_dit("S", z_channels=ZC, **DIT)
    remat = copy.deepcopy(plain)
    remat.remat = True
    r = np.random.default_rng(1)
    x, xyz = t(r.normal(size=(2, K, ZC))), t(r.normal(size=(2, K, 3)))
    tt, ctx, vec = t([0.3, 0.8]), t(r.normal(size=(2, 9, CW))), t(
        r.normal(size=(2, CW)))
    grads = []
    for m in (plain, remat):
        loss = (m(x, tt, ctx, vec, xyz=xyz) ** 2).mean()
        grads.append(torch.autograd.grad(loss, list(m.parameters())))
        grads[-1] = (loss.detach(),) + grads[-1]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    calls = []
    import gaussiananything_tpu_torch.models.dit as dit_mod
    real = dit_mod.checkpoint

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    dit_mod.checkpoint = spy
    try:
        with torch.no_grad():
            remat(x, tt, ctx, vec, xyz=xyz)
        assert not calls
        remat(x, tt, ctx, vec, xyz=xyz)
        assert len(calls) == DIT["depth"]
        assert all(c == {"use_reentrant": False} for c in calls)
    finally:
        dit_mod.checkpoint = real


# ----------------------------------------------------- sampler, split_stage2

def test_dopri5_sampler_matches_jax():
    """`make_sampler` with sampler="dopri5" on a tiny release-layout
    stage-1 DiT and the JAX sampler on the same weights, conditioning and
    noise: the adaptive integration (JAX odeint's steps) agrees within the
    DiTs' atol 2e-4 / rtol 1e-3 (`tests/test_torch_text.py`);
    `latent_divider` scales the output in both. The release layout embeds
    raw t; the non-release one embeds t·1000, a field so rough in t that
    two float32 integrations of it part after a few dozen steps (the
    error ratio jumps between 1 and 2 on states 1e-7 apart), so it cannot
    hold one integrator to another. The fixed-step branch's `cfg_scale`
    and `num_steps` overrides are held on the same weights."""
    batch = _batch(1)
    jc, pc, _, _, cp, _ = _init(1, batch)
    pc.eval()
    kw = dict(in_channels=3, width=W, depth=2, heads=4, cond_dim=CW,
              vector_dim=CW, release_parity=True)
    jd = JPointDiT(**kw)
    img = batch["cond"][:2]
    c = jc.apply(cp, jnp.asarray(img[:1]))
    dp = randomize(jd, 2, jnp.zeros((1, K, 3)), jnp.zeros((1,)),
                   c.crossattn, c.vector)
    pd = carry(dp, PointDiT(**kw))
    dp = jax.tree.map(jnp.asarray, dp)
    key = jax.random.PRNGKey(11)
    x0 = t(jax.random.normal(key, (2, K, 3)))
    for sampler, over in (("dopri5", {}),
                          ("heun", dict(cfg_scale=3.0, num_steps=3))):
        cfgs = dict(stage=1, cfg_scale=2.0, sampler=sampler,
                    latent_divider=1.5)
        ref = jfm.make_sampler(jd, jc, jfm.FMConfig(**cfgs), (K, 3))(
            dp, cp, jnp.asarray(img), key, **over)
        got = fm.make_sampler(pd, pc, fm.FMConfig(**cfgs), (K, 3))(
            t(img), x0=x0, **over)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                                   rtol=1e-3, err_msg=sampler)
    with pytest.raises(ValueError, match="sampler"):
        fm.make_sampler(pd, pc, fm.FMConfig(sampler="rk4"), (K, 3))


def test_split_stage2():
    lat = np.random.default_rng(0).normal(size=(2, K, ZC + 3)).astype(
        np.float32)
    for got, want in zip(fm.split_stage2(t(lat), ZC),
                         jfm.split_stage2(jnp.asarray(lat), ZC)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert fm.unnormalize_stage1(t(lat))[0, 0, 0] == t(lat)[0, 0, 0] * 0.164


def test_frozen_state_refuses_updates_and_round_trips(tmp_path):
    """A frozen state keeps no moments and no EMA copy, takes no update,
    checkpoints and restores only into a frozen state, and its checkpoint
    feeds `restore_inference_params` like any other."""
    m = cond.ImageConditioner(img_size=IMG, backbone="scratch", **COND)
    st = pstate.TrainState.create(m, frozen=True)
    assert not any(p.requires_grad for p in m.parameters())
    assert st.ema is st.params and len(st.params) == len(
        list(m.parameters()))
    with pytest.raises(RuntimeError, match="frozen"):
        st.apply_gradients({}, pstate.TrainStateConfig())
    pstate.save_checkpoint(str(tmp_path / "c"), st)
    m2 = cond.ImageConditioner(img_size=IMG, backbone="scratch", **COND)
    st2 = pstate.restore_checkpoint(str(tmp_path / "c"),
                                    pstate.TrainState.create(m2, frozen=True))
    for k, v in st2.params.items():
        assert torch.equal(v, st.params[k])
    with pytest.raises(ValueError, match="frozen"):
        pstate.restore_checkpoint(
            str(tmp_path / "c"), pstate.TrainState.create(
                cond.ImageConditioner(img_size=IMG, backbone="scratch",
                                      **COND)))
    m3 = cond.ImageConditioner(img_size=IMG, backbone="scratch", **COND)
    pstate.restore_inference_params(str(tmp_path / "c"), m3)
    for k, v in m3.state_dict().items():
        assert torch.equal(v, st.params[k])


def test_fm_config_matches_jax():
    assert [f.name for f in dataclasses.fields(fm.FMConfig)] == [
        f.name for f in dataclasses.fields(jfm.FMConfig)]
    assert fm.FMConfig() == fm.FMConfig(**dataclasses.asdict(jfm.FMConfig()))
