"""bf16 mixed-precision training in the port against the JAX package's on
the CPU (`config.VAEModelConfig.compute_dtype`, JAX `tests/test_bf16.py`):
under `dtype=bfloat16` every parameter, gradient, AdamW moment and EMA copy
is fp32 and the products run in bf16; the VAE's encode and decode and the
DiT's velocity are held to JAX's bf16 forward on the same parameters; one
VAE step's and one stage-1 flow step's loss and gradients to JAX's bf16
step on the same draws; a bf16 step moves a norm weight at 1.0, which a
model holding bf16 parameters never does; `render_lods(remat=True)` equals
`remat=False` bit for bit and JAX's `render_lods`; the release-feasibility
tool runs at a tiny size.

Bounds: the forwards 0.05 (`tests/test_bf16.py:59-60`), the DiT velocity
0.05·max(scale, 1) (`:94-96`); the step's loss 1e-2 relative and each
gradient leaf 5e-2 of that leaf's max|g_jax|; the renders' gradients rtol
2e-3 / atol 2e-4 (`tests/test_pallas_kernel.py:116-165`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.diffusion.transport import \
    create_transport as jcreate_transport
from gaussiananything_tpu.models import conditioner as jcond
from gaussiananything_tpu.models.dit import stage1_dit as jstage1_dit
from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.train import vae_trainer as jtrainer
from gaussiananything_tpu_torch.config import VAEModelConfig
from gaussiananything_tpu_torch.data.synthetic import make_batch
from gaussiananything_tpu_torch.diffusion.transport import create_transport
from gaussiananything_tpu_torch.models import layers
from gaussiananything_tpu_torch.models.conditioner import (ImageConditioner,
                                                           TextConditioner)
from gaussiananything_tpu_torch.models.dit import (PointDiT, stage1_dit,
                                                   stage2_dit)
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.tools import release_feasibility
from gaussiananything_tpu_torch.train import fm_trainer as fm
from gaussiananything_tpu_torch.train import vae_trainer as ptrainer
from gaussiananything_tpu_torch.train.state import (TrainState,
                                                    TrainStateConfig)
from gaussiananything_tpu_torch.utils.param_io import from_jax_params
from test_torch_models import carry, randomize, t

torch.set_num_threads(2)
BF16, F32 = torch.bfloat16, torch.float32

# JAX `tests/test_bf16.py:22-25` `tiny_vae`
TINY_VAE = dict(latent_num=16, z_channels=4, encoder_width=64,
                decoder_width=64, decoder_heads=4, decoder_depth=2,
                up_factors=(4,), up_depths=(1,))
LODS = (16, 32)
DIT = dict(depth=2, width=64, heads=4, cond_dim=32, vector_dim=32)
COND = dict(width=32, depth=1, heads=2, img_size=28, ucg_rate=0.5)
K, B_FM = 24, 4


def _vae_batch():
    """JAX `make_batch(seed=0, ...)` of `tests/test_bf16.py:45-46` (the
    port's `make_batch` makes the same one from the seed)."""
    return {k: v for k, v in make_batch(
        seed=0, batch=1, n_views_in=2, n_views_sup=2, res=32, n_pts=64,
        n_splats=128).items() if k != "gt_gaussians"}


def _linear_out_dtypes(module, run):
    """The output dtypes of every Linear and conv of `module` on `run()`."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
             for m in module.modules()
             if isinstance(m, (layers.Linear, layers.Conv2d))]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return set(seen)


def _vae(release=False, **kw):
    sizes = dict(TINY_VAE, latent_num=12) if release else TINY_VAE
    return PointVAE(**dict(sizes, encoder_width=256 if release else 64),
                    release_parity=release, with_encoder=True, **kw)


MODELS = {
    "vae": lambda dt: _vae(dtype=dt),
    "vae-release": lambda dt: _vae(release=True, dtype=dt),
    "dit": lambda dt: stage1_dit("S", dtype=dt, **DIT),
    "dit-release": lambda dt: PointDiT(dtype=dt, **DIT),
    "dit-t23d": lambda dt: PointDiT(variant="text", dtype=dt, **DIT),
    "scratch": lambda dt: ImageConditioner(backbone="scratch", dtype=dt,
                                           **COND),
    "dinov2": lambda dt: ImageConditioner(backbone="dinov2", dtype=dt,
                                          **COND),
    "bytes": lambda dt: TextConditioner(width=32, depth=1, heads=2,
                                        backbone="bytes", dtype=dt),
    "openclip": lambda dt: TextConditioner(width=32, depth=1, heads=2,
                                           backbone="openclip", dtype=dt),
}


def _forward(name, m):
    r = np.random.default_rng(0)
    if name.startswith("vae"):
        b = _vae_batch()
        return lambda: m(b["images_in"], b["pcd"],
                         generator=torch.Generator().manual_seed(0))
    if name.startswith("dit"):
        args = (t(r.normal(size=(2, 12, 3))), t(np.full(2, 0.3)),
                t(r.normal(size=(2, 5, 32))), t(r.normal(size=(2, 32))))
        return lambda: m(*args)
    if name in ("scratch", "dinov2"):
        return lambda: m(t(r.uniform(size=(2, 3, 28, 28))))
    return lambda: m(torch.from_numpy(r.integers(1, 250, (2, 77))))


@pytest.mark.parametrize("name", list(MODELS))
def test_parameters_fp32_compute_bf16(name):
    """JAX `tests/test_bf16.py:34-41`: the parameters stay fp32 under a
    bf16 compute dtype; every Linear and conv computes in bf16 (fp32
    without it)."""
    m16, m32 = MODELS[name](BF16), MODELS[name](F32)
    assert {p.dtype for p in m16.parameters()} == {F32}
    m16.eval()
    m32.eval()
    with torch.no_grad():
        assert _linear_out_dtypes(m16, _forward(name, m16)) == {BF16}
        assert _linear_out_dtypes(m32, _forward(name, m32)) == {F32}


# ------------------------------------------------------------- the VAE

@pytest.fixture(scope="module")
def vae_case():
    """JAX's tiny bf16 VAE on its flax initialisation at PRNGKey(0) (as
    `tests/test_bf16.py:51-53,66`: the bounds are the JAX tests' for that
    init), the port's on the same parameters, the batch and the step's
    draws from PRNGKey(0)."""
    batch = _vae_batch()
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jm = JPointVAE(dtype=jnp.bfloat16, **TINY_VAE)
    key = jax.random.PRNGKey(0)
    params = jax.jit(jm.init)(key, jb["images_in"], jb["pcd"], key)
    pm = _vae(dtype=BF16)
    pm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                       pm))
    rng_s, rng_lpips, _ = jax.random.split(key, 3)
    draws = {"noise": t(jax.random.normal(
        rng_s, (1, TINY_VAE["latent_num"], TINY_VAE["z_channels"]))),
        "lpips_lod": int(jax.random.randint(rng_lpips, (), 0, len(LODS)))}
    return dict(jm=jm, pm=pm, params=params, batch=batch, jb=jb, key=key,
                rng_s=rng_s, draws=draws)


def test_vae_encode_decode_bf16_match_jax(vae_case):
    """The latent statistics (fp32), the sampled latent and every LoD's
    activated gaussians (fp32) within 0.05 of JAX's bf16 forward."""
    c = vae_case
    ref = jax.jit(c["jm"].apply)(c["params"], c["jb"]["images_in"],
                                 c["jb"]["pcd"], c["rng_s"])
    with torch.no_grad():
        got = c["pm"](c["batch"]["images_in"], c["batch"]["pcd"],
                      noise=c["draws"]["noise"])
    for k in ("mean", "logvar", "z"):
        assert got[k].dtype == F32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=0.05, err_msg=k)
    for a, b in zip(got["lods"], ref["lods"]):
        assert a.dtype == F32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=0.05)


def _leaf_gaps(got: dict, ref_tree, module) -> dict:
    """{name: max|g_port − g_jax| / max|g_jax|} for every leaf."""
    ref = from_jax_params(jax.tree.map(np.asarray, ref_tree), module)
    assert set(got) == set(ref)
    return {k: float((got[k] - ref[k]).abs().max())
            / max(float(ref[k].abs().max()), 1e-30) for k in ref}


def _check_grads(loss, jloss, grads, jgrads, module, what):
    assert {g.dtype for g in grads.values()} == {F32}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-2)
    ref = from_jax_params(jax.tree.map(np.asarray, jgrads), module)
    # a key bias shifts all of a query's scores by q·b_k, which the softmax
    # removes: its gradient is zero but for rounding in both packages, and
    # is held to 1e-2 of its value bias's instead
    zero = [k for k in ref if k.endswith("to_k.bias")]
    for k in zero:
        floor = 1e-2 * float(ref[k[:-len("to_k.bias")] + "to_v.bias"]
                             .abs().max())
        assert float(ref[k].abs().max()) <= floor, k
        assert float(grads[k].abs().max()) <= floor, k
    gaps = {k: v for k, v in _leaf_gaps(grads, jgrads, module).items()
            if k not in zero}
    worst = max(gaps, key=gaps.get)
    print(f"{what}: worst gradient leaf {worst} at "
          f"{gaps[worst]:.3e} of its max|g_jax|")
    bad = {k: v for k, v in gaps.items() if not v <= 5e-2}
    assert not bad, bad


def test_vae_step_gradients_bf16_match_jax(vae_case):
    """One VAE step (`VAELossConfig(lod_resolutions=(16, 32),
    perceptual_weight=0.0)`, step 0, JAX's draws): the loss and every
    gradient leaf against `jax.value_and_grad(vae_loss_fn)` in bf16."""
    c = vae_case
    cfg = dict(lod_resolutions=LODS, perceptual_weight=0.0)

    def jloss(p):
        return jtrainer.vae_loss_fn(p, c["jm"], c["jb"], c["key"],
                                    jnp.asarray(0, jnp.int32),
                                    jtrainer.VAELossConfig(**cfg))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(c["params"])
    pm = c["pm"]
    total, _ = ptrainer.vae_loss_fn(pm, c["batch"], 0,
                                    ptrainer.VAELossConfig(**cfg),
                                    draws=c["draws"])
    named = dict(pm.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(
        total, list(named.values()), allow_unused=True)))
    grads = {k: torch.zeros_like(named[k]) if g is None else g
             for k, g in grads.items()}
    _check_grads(total, jl, grads, jg, pm, "VAE step")


def test_bf16_adversarial_terms_stay_fp32():
    """What the JAX package computes in fp32 stays fp32 under a bf16 VAE:
    the renders, every logged loss term, the adaptive weight (its two
    gradient norms taken on the fp32 gaussians) and the discriminator,
    whose step takes fp32 gradients into an fp32 state."""
    from gaussiananything_tpu_torch.train.losses import PatchDiscriminator
    torch.manual_seed(0)
    pm, disc = _vae(dtype=BF16), PatchDiscriminator(ch=32, layers=2)
    batch = _vae_batch()
    cfg = ptrainer.VAELossConfig(lod_resolutions=LODS, perceptual_weight=0.0,
                                 adv_weight=0.1)
    total, (logs, renders, _) = ptrainer.vae_loss_fn(
        pm, batch, 0, cfg, generator=torch.Generator().manual_seed(0),
        disc_model=disc)
    assert total.dtype == F32 and {v.dtype for v in logs.values()} == {F32}
    assert {m.dtype for r in renders for m in r.values()} == {F32}
    assert torch.isfinite(logs["adaptive_w"]) and logs["adaptive_w"] > 0
    dstate = TrainState.create(disc)
    d_logs = ptrainer.make_disc_step(pm, disc, cfg, TrainStateConfig(
        warmup_steps=1))(dstate, batch, generator=torch.Generator())
    assert np.isfinite(float(d_logs["d_loss"])) and dstate.step == 1
    assert {v.dtype for tree in (dstate.params, dstate.mu, dstate.ema)
            for v in tree.values()} == {F32}


# ----------------------------------------------------- the flow step

@pytest.fixture(scope="module")
def fm_case():
    """A stage-1 DiT-S cut to depth 2 and width 64 and a trained scratch
    ViT conditioner, both bf16, on seeded parameters; JAX's draws of one
    step at PRNGKey(7)."""
    r = np.random.default_rng(0)
    batch = {"cond": r.uniform(size=(B_FM, 3, 28, 28)).astype(np.float32),
             "latent": (r.normal(size=(B_FM, K, 3)) * 2.0).astype(
                 np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jc = jcond.ImageConditioner(dtype=jnp.bfloat16, **COND)
    jd = jstage1_dit("S", dtype=jnp.bfloat16, **DIT)
    cp = randomize(jc, 1, jb["cond"][:1])
    c0 = jc.apply(cp, jb["cond"][:1])
    dp = randomize(jd, 2, jb["latent"][:1], jnp.zeros((1,)), c0.crossattn,
                   c0.vector)
    pc = carry(cp, ImageConditioner(backbone="scratch", dtype=BF16,
                                    **COND)).train()
    pd = carry(dp, stage1_dit("S", dtype=BF16, **DIT)).train()
    rng = jax.random.PRNGKey(7)
    rng_c, rng_t = jax.random.split(rng)
    rt, rn = jax.random.split(rng_t)
    draws = {"keep": t(jax.random.bernoulli(rng_c, 1.0 - COND["ucg_rate"],
                                            (B_FM, 1, 1))),
             "t": t(jax.random.uniform(rt, (B_FM,), minval=1e-5,
                                       maxval=1 - 1e-5)),
             "x0": t(jax.random.normal(rn, (B_FM, K, 3)))}
    return dict(jc=jc, jd=jd, pc=pc, pd=pd, batch=batch, jb=jb, rng=rng,
                cp=jax.tree.map(jnp.asarray, cp),
                dp=jax.tree.map(jnp.asarray, dp), draws=draws)


def test_dit_velocity_bf16_matches_jax(fm_case):
    """The DiT's bf16 velocity within 0.05·max(scale, 1) of JAX's bf16,
    scale the fp32 velocity's max (`tests/test_bf16.py:94-96`)."""
    c = fm_case
    r = np.random.default_rng(3)
    x, tt = r.normal(size=(2, K, 3)), np.full((2,), 0.3)
    ctx, vec = r.normal(size=(2, 5, 32)), r.normal(size=(2, 32))
    jargs = [jnp.asarray(a, jnp.float32) for a in (x, tt, ctx, vec)]
    v16 = np.asarray(jax.jit(c["jd"].apply)(c["dp"], *jargs))
    v32 = np.asarray(jax.jit(jstage1_dit("S", **DIT).apply)(c["dp"],
                                                             *jargs))
    with torch.no_grad():
        got = c["pd"](*(t(a) for a in (x, tt, ctx, vec)))
    assert got.dtype == F32
    scale = float(np.abs(v32).max())
    np.testing.assert_allclose(got.numpy(), v16, atol=0.05 * max(scale, 1))


def test_flow_step_gradients_bf16_match_jax(fm_case):
    """One stage-1 flow step with the conditioner trained: the velocity
    MSE and every DiT and conditioner gradient leaf against JAX's bf16
    step on the same keep mask, t and x0."""
    c = fm_case
    transport = jcreate_transport()

    def jloss(dp, cp):
        rng_c, rng_t = jax.random.split(c["rng"])
        cond = c["jc"].apply(cp, c["jb"]["cond"], rng=rng_c, train=True)
        return transport.training_loss(
            lambda xt, tt: c["jd"].apply(dp, xt, tt, cond.crossattn,
                                         cond.vector),
            rng_t, c["jb"]["latent"])[0]

    jl, (jgd, jgc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        c["dp"], c["cp"])
    pd, pc, d = c["pd"], c["pc"], c["draws"]
    cond = pc(t(c["batch"]["cond"]), keep=d["keep"])
    loss, _ = create_transport().training_loss(
        lambda xt, tt: pd(xt, tt, cond.crossattn, cond.vector),
        t(c["batch"]["latent"]), t=d["t"], x0=d["x0"])
    g_dit, g_cond = fm._grads(loss, [dict(pd.named_parameters()),
                                     dict(pc.named_parameters())])
    _check_grads(loss, jl, g_dit, jgd, pd, "flow step, DiT")
    _check_grads(loss, jl, g_cond, jgc, pc, "flow step, conditioner")


# ------------------------------------------- training moves the weights

def _moved_after_steps(kind: str, dtype) -> dict:
    """{name: moved} of every parameter after a warm-up step (lr 0) and
    three steps at lr 1e-4, from seed 0; and the state's dtypes."""
    torch.manual_seed(0)
    tx = TrainStateConfig(lr=1e-4, warmup_steps=1)
    if kind == "vae":
        model = _vae(release=True, dtype=dtype)
        step = ptrainer.make_train_step(
            model, ptrainer.VAELossConfig(lod_resolutions=LODS,
                                          perceptual_weight=0.0), tx)
        batch = _vae_batch()
    else:
        model = stage2_dit("S", z_channels=4, dtype=dtype, **DIT)
        pc = ImageConditioner(backbone="scratch", dtype=dtype, **COND)
        step = fm.make_fm_train_step(model, pc, create_transport(),
                                     fm.FMConfig(stage=2), tx)
        r = np.random.default_rng(0)
        batch = {"cond": t(r.uniform(size=(2, 3, 28, 28))),
                 "latent": t(r.normal(size=(2, K, 4))),
                 "xyz": t(r.normal(size=(2, K, 3)) * 0.3)}
        cstate = TrainState.create(pc, frozen=True)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = TrainState.create(model)
    for i in range(4):
        g = torch.Generator().manual_seed(i)
        if kind == "vae":
            step(state, batch, generator=g)
        else:
            step(state, cstate, batch, generator=g)
    dtypes = {v.dtype for tree in (state.params, state.mu, state.nu,
                                   state.ema) for v in tree.values()}
    moved = {k: bool((p.detach() != init[k]).any())
             for k, p in model.named_parameters()}
    norms = [f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm,
                               layers.RMSNorm)) and m.weight is not None
             and bool((init[f"{n}.weight"] == 1.0).all())]
    return moved, dtypes, norms


@pytest.mark.parametrize("kind", ["vae", "dit"])
def test_bf16_training_moves_every_parameter(kind):
    """Regression: with bf16 parameters (their spacing at 1.0 is 2⁻⁷) an
    lr-1e-4 AdamW step leaves a norm weight at exactly 1.0. Under the
    bf16 compute dtype every parameter that an fp32 run moves moves too,
    the norm weights initialised at 1.0 among them, and the parameters,
    both moments and the EMA are fp32."""
    moved32, dtypes32, norms = _moved_after_steps(kind, F32)
    moved16, dtypes16, _ = _moved_after_steps(kind, BF16)
    assert norms and all(moved16[k] for k in norms), \
        [k for k in norms if not moved16[k]]
    assert all(moved16[k] for k, v in moved32.items() if v), \
        [k for k, v in moved32.items() if v and not moved16[k]]
    assert dtypes32 == dtypes16 == {F32}


# --------------------------------------------------------------- remat

def _render_case():
    b = make_batch(seed=1, batch=1, n_views_in=1, n_views_sup=2, res=32,
                   n_pts=64, n_splats=256)
    g = b["gt_gaussians"]
    lods = [g[:, :96].contiguous(), g]
    r = np.random.default_rng(5)
    wts = {k: r.normal(size=(1, 2) + shape).astype(np.float32)
           for k, shape in (("image", (3,)), ("alpha", (1,)),
                            ("depth", (1,)), ("depth_expected", (1,)),
                            ("rend_normal", (3,)), ("dist", (1,)))}
    return b, lods, wts


def _port_render_grads(b, lods, wts, remat, calls):
    gs = [g.clone().requires_grad_(True) for g in lods]
    outs = ptrainer.render_lods(gs, b["cam_view"], b["cam_view_proj"],
                                torch.ones(3), LODS, remat=remat)
    loss = sum((o[k] * t(w[..., None, None]).expand_as(o[k])
                * (1.0 + i)).sum() for i, o in enumerate(outs)
               for k, w in wts.items())
    n_fwd = calls[0]
    grads = torch.autograd.grad(loss, gs)
    return loss.detach(), grads, n_fwd, calls[0]


def test_render_lods_remat(monkeypatch):
    """`render_lods(remat=True)`: the backward renders each LoD again
    (two forwards per LoD), and the loss and its gradient with respect to
    the gaussians are bit-equal to `remat=False` and within rtol 2e-3 /
    atol 2e-4·max(1, max|g|) of JAX's `render_lods` (remat on, chunk
    128)."""
    b, lods, wts = _render_case()
    calls = [0]
    real = ptrainer.render_multiview

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ptrainer, "render_multiview", counted)
    l0, g0, f0, b0 = _port_render_grads(b, lods, wts, False, calls)
    assert (f0, b0) == (2, 2)
    calls[0] = 0
    l1, g1, f1, b1 = _port_render_grads(b, lods, wts, True, calls)
    assert (f1, b1) == (2, 4)               # each LoD rendered again
    assert torch.equal(l0, l1)
    for a, c in zip(g0, g1):
        assert torch.equal(a, c)

    jl = [jnp.asarray(g.numpy()) for g in lods]

    def jloss(gl):
        outs = jtrainer.render_lods(
            gl, jnp.asarray(b["cam_view"].numpy()),
            jnp.asarray(b["cam_view_proj"].numpy()),
            jnp.asarray(b["tanfov"].numpy()), jnp.ones(3), LODS, chunk=128)
        return sum((o[k] * jnp.asarray(w)[..., None, None] * (1.0 + i)).sum()
                   for i, o in enumerate(outs) for k, w in wts.items())

    ref = jax.jit(jax.grad(jloss))(jl)
    for a, r in zip(g1, ref):
        r = np.asarray(r)
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(a.numpy(), r, rtol=2e-3,
                                   atol=2e-4 * scale)


# ------------------------------------------------------------ the tool

@pytest.mark.parametrize("bf16", [False, True])
def test_release_feasibility_tool_tiny(bf16):
    """`tools/release_feasibility.feasibility` at a tiny size on the CPU:
    the JAX tool's fields (compute dtype, params, the first step, the
    steady step and steps/s, memory) and finite logs; no peak on the
    CPU."""
    lines = []
    cfg = VAEModelConfig(latent_num=12, z_channels=4, encoder_width=64,
                         decoder_width=64, decoder_depth=1, decoder_heads=4,
                         up_factors=(2, 2, 2), up_depths=(1, 1, 1))
    out = release_feasibility.feasibility(
        views=2, steps=2, bf16=bf16, device="cpu", vae_cfg=cfg, res=64,
        lod_resolutions=(16, 32, 48, 64), n_points=256, log=lines.append)
    assert cfg.compute_dtype == "float32"       # the caller's is not edited
    assert out["compute_dtype"] == ("bfloat16" if bf16 else "float32")
    assert lines[0] == f"compute_dtype: {out['compute_dtype']}"
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        "params", "first step", "steady step"]
    assert "steps/s" in lines[-1]
    assert out["steps_taken"] == 3 and out["peak_bytes"] is None
    assert out["params"] == sum(
        p.numel() for p in PointVAE.from_config(cfg, with_encoder=True)
        .parameters())
    assert all(np.isfinite(v) for v in out["logs"].values())
    assert "coarse_lod_loss" in out["logs"]
