"""The port's transport, samplers and DDPM against the JAX package on the
CPU: the three paths and their derivatives, `plan`, `training_loss`, the
score and diffusion algebra in every form, the DDPM schedules,
`q_sample` and the ancestral and DDIM samplers, the adaptive dopri5
against JAX's `odeint` and the SDE sampler on the same noise. Every JAX
draw is handed to the port. Pure float32 arithmetic in both: rtol 1e-5 /
atol 1e-6 unless a test states otherwise."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from gaussiananything_tpu.diffusion import ddpm as jddpm
from gaussiananything_tpu.diffusion import sampling as jsampling
from gaussiananything_tpu.diffusion import transport as jtransport
from gaussiananything_tpu_torch import diffusion as pdiffusion
from gaussiananything_tpu_torch.diffusion import ddpm
from gaussiananything_tpu_torch.diffusion import sampling
from gaussiananything_tpu_torch.diffusion import transport

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
PATHS = ["linear", "gvp", "vp"]
T_GRID = np.linspace(0.02, 0.98, 49).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("name", PATHS)
def test_paths_and_derivatives(name):
    """α, σ, α̇, σ̇ equal JAX's, and α̇, σ̇ are the derivatives of α, σ
    (central differences in float64 through the port's functions: the
    paths are dtype-generic, atol 1e-6)."""
    jp, pp = jtransport.PATHS[name](), transport.PATHS[name]()
    assert pp.name == jp.name == name
    for f in ("alpha", "sigma", "d_alpha", "d_sigma"):
        close(getattr(pp, f)(t(T_GRID)), getattr(jp, f)(jnp.asarray(T_GRID)))
    x = torch.from_numpy(T_GRID.astype(np.float64))
    h = 1e-6
    for f, d in (("alpha", "d_alpha"), ("sigma", "d_sigma")):
        num = (getattr(pp, f)(x + h) - getattr(pp, f)(x - h)) / (2 * h)
        np.testing.assert_allclose(getattr(pp, d)(x).numpy(), num.numpy(),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", PATHS)
def test_plan_and_training_loss(name):
    """`plan` equals JAX's; `training_loss` on JAX's draws (t from
    split(rng)[0], x0 from split(rng)[1]) gives JAX's loss, t and
    per-sample losses for a velocity function both can evaluate."""
    r = np.random.default_rng(0)
    x1 = r.normal(size=(5, 7, 3)).astype(np.float32)
    x0 = r.normal(size=(5, 7, 3)).astype(np.float32)
    tt = r.uniform(0.05, 0.95, 5).astype(np.float32)
    jt = jtransport.create_transport(name)
    pt = transport.create_transport(name)
    for got, want in zip(pt.plan(t(x1), t(x0), t(tt)),
                         jt.plan(jnp.asarray(x1), jnp.asarray(x0),
                                 jnp.asarray(tt))):
        close(got, want)
    w = r.normal(size=(3, 3)).astype(np.float32)

    def jv(xt, tb):
        return jnp.tanh(xt @ jnp.asarray(w)) * tb[:, None, None]

    def pv(xt, tb):
        return torch.tanh(xt @ t(w)) * tb[:, None, None]

    for sampler in ("uniform", "lognorm"):
        jt = jtransport.create_transport(name, sampler)
        pt = transport.create_transport(name, sampler)
        rng = jax.random.PRNGKey(4)
        ref, aux = jt.training_loss(jv, rng, jnp.asarray(x1))
        rt, rn = jax.random.split(rng)
        draw_t = jt.sample_t(rt, 5)
        draw_x0 = jax.random.normal(rn, x1.shape)
        got, paux = pt.training_loss(pv, t(x1), t=t(draw_t), x0=t(draw_x0))
        close(got, ref)
        close(paux["t"], aux["t"])
        close(paux["per_sample"], aux["per_sample"])


def test_sample_t_draws():
    """Uniform draws lie in [1e-5, 1 − 1e-5), logit-normal ones are the
    sigmoid of a standard normal; both come from the generator."""
    g = torch.Generator().manual_seed(0)
    u = transport.create_transport("gvp", "uniform").sample_t(20000, g)
    assert float(u.min()) >= 1e-5 and float(u.max()) < 1 - 1e-5
    assert abs(float(u.mean()) - 0.5) < 0.01
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    ln = transport.create_transport("gvp", "lognorm").sample_t(8, g1)
    assert torch.equal(ln, torch.sigmoid(torch.randn(8, generator=g2)))
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    x1 = torch.zeros(3, 4, 2)
    _, aux = transport.create_transport().training_loss(
        lambda xt, tb: xt, x1, generator=g1)
    want_t = transport.create_transport().sample_t(3, g2)
    assert torch.equal(aux["t"], want_t)


@pytest.mark.parametrize("name", PATHS)
def test_score_and_diffusion(name):
    """`score_from_velocity` and `sde_diffusion` in every form equal
    JAX's; an unknown form raises in both."""
    jp, pp = jtransport.PATHS[name](), transport.PATHS[name]()
    r = np.random.default_rng(1)
    v = r.normal(size=(49, 6, 3)).astype(np.float32)
    x = r.normal(size=(49, 6, 3)).astype(np.float32)
    close(transport.score_from_velocity(pp, t(v), t(x), t(T_GRID)),
          jtransport.score_from_velocity(jp, jnp.asarray(v), jnp.asarray(x),
                                         jnp.asarray(T_GRID)), rtol=2e-5,
          atol=1e-5)
    for form in ("sbdm", "sigma", "linear", "constant"):
        close(transport.sde_diffusion(pp, t(T_GRID), form, 0.7),
              jtransport.sde_diffusion(jp, jnp.asarray(T_GRID), form, 0.7))
    with pytest.raises(NotImplementedError):
        transport.sde_diffusion(pp, t(T_GRID), "cubic")


def test_package_exports():
    assert pdiffusion.create_transport is transport.create_transport
    assert pdiffusion.sample_ode_adaptive is sampling.sample_ode_adaptive
    assert pdiffusion.sample_sde is sampling.sample_sde
    assert pdiffusion.sample_ode is sampling.sample_ode
    assert pdiffusion.Transport is transport.Transport


# ---------------------------------------------------------------- samplers

A = np.array([[0.3, -0.2], [0.1, 0.25]], np.float32)


def test_dopri5_toy_linear_field():
    """The linear field of `tests/test_extras.py:310` (x(1) = x0·e^A): the
    port's dopri5 equals JAX `odeint` within 1e-5 (the dense-output
    polynomial cancels 16·y_mid against 8·(y0 + y1), so the two float32
    evaluation orders part by a few ulps of its coefficients), and the
    exact solution within the JAX test's rtol 2e-4 / atol 1e-5."""
    x0 = np.random.RandomState(0).randn(4, 2).astype(np.float32)
    ref = jsampling.sample_ode_adaptive(lambda x, tb: x @ jnp.asarray(A).T,
                                        jnp.asarray(x0))
    calls = []

    def v(x, tb):
        calls.append(float(tb[0]))
        assert tb.shape == (4,) and tb.dtype == torch.float32
        return x @ t(A).T

    got = sampling.sample_ode_adaptive(v, t(x0))
    close(got, ref, rtol=1e-5, atol=1e-5)
    close(got, x0 @ sla.expm(A).T, rtol=2e-4, atol=1e-5)
    # two evaluations for the initial step, six per step (FSAL), the
    # steps past t = 1 interpolated back
    assert (len(calls) - 2) % 6 == 0 and max(calls) > 1.0


def test_dopri5_smooth_nonlinear_field():
    """A nonlinear time-dependent field: the port follows odeint's steps
    and lands within 1e-5 of it; at rtol 1e-5 / atol 1e-7 both agree with
    a 256-step Heun within the JAX test's atol 1e-3
    (`tests/test_models.py:254`)."""
    r = np.random.RandomState(1)
    x0 = r.randn(8, 5, 3).astype(np.float32)

    def jv(x, tb):
        return jnp.sin(2 * x) * (1 + tb[:, None, None]) - 0.5 * x

    def pv(x, tb):
        return torch.sin(2 * x) * (1 + tb[:, None, None]) - 0.5 * x

    close(sampling.sample_ode_adaptive(pv, t(x0)),
          jsampling.sample_ode_adaptive(jv, jnp.asarray(x0)),
          rtol=1e-5, atol=1e-5)
    tight = sampling.sample_ode_adaptive(pv, t(x0), rtol=1e-5, atol=1e-7)
    close(tight, sampling.sample_ode(pv, t(x0), 256, "heun"), atol=1e-3)


def _jax_sde_noise(rng, n, shape):
    """The per-step noise of JAX `sample_sde`'s scan: key, sub =
    split(key); normal(sub)."""
    out, key = [], rng
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return t(np.stack(out))


@pytest.mark.parametrize("name,form", [("gvp", "sbdm"), ("linear", "sbdm"),
                                       ("gvp", "sigma")])
def test_sde_matches_jax_on_the_same_noise(name, form):
    """`sample_sde` on JAX's per-step noise equals JAX's result (rtol 1e-4
    / atol 1e-5: 31 Euler–Maruyama steps of float32 sums)."""
    r = np.random.RandomState(2)
    x0 = r.randn(3, 6, 2).astype(np.float32)
    w = r.randn(2, 2).astype(np.float32) * 0.5

    def jv(x, tb):
        return jnp.tanh(x @ jnp.asarray(w)) - x * tb[:, None, None]

    def pv(x, tb):
        return torch.tanh(x @ t(w)) - x * tb[:, None, None]

    rng = jax.random.PRNGKey(9)
    ref = jsampling.sample_sde(jv, jnp.asarray(x0), rng,
                               path=jtransport.PATHS[name](), num_steps=32,
                               diffusion_form=form)
    noise = _jax_sde_noise(rng, 31, x0.shape)
    got = sampling.sample_sde(pv, t(x0), path=transport.PATHS[name](),
                              num_steps=32, diffusion_form=form, noise=noise)
    close(got, ref, rtol=1e-4, atol=1e-5)


def test_sde_preserves_marginals():
    """The port's own copy of `tests/test_models.py:224`: data = the point
    mu under the linear path, v(x, t) = mu − (x − t·mu)/(1 − t); after the
    Euler–Maruyama steps and the "Mean" last step the output law is
    N(mu, (h·(1 + h/t1))² I). Same bounds: mean atol 0.01, std rtol 0.2;
    the noise from a seeded generator."""
    mu = t([1.0, -2.0, 3.0])

    def v(x, tb):
        tb = tb.reshape(-1, 1, 1)
        return mu - (x - tb * mu) / (1.0 - tb)

    g = torch.Generator().manual_seed(1)
    x0 = torch.randn((4096, 1, 3), generator=g)
    h = 0.04
    x1 = sampling.sample_sde(v, x0, generator=g,
                             path=transport.linear_path(), num_steps=256,
                             last_step_size=h).reshape(-1, 3).numpy()
    sigma_final = h * (1.0 + h / (1.0 - h))
    np.testing.assert_allclose(x1.mean(0), mu.numpy(), atol=0.01)
    np.testing.assert_allclose(x1.std(0), sigma_final, rtol=0.2)


# -------------------------------------------------------------------- DDPM

@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_ddpm_schedules(schedule):
    for f in ("linear_betas", "cosine_betas"):
        np.testing.assert_array_equal(getattr(ddpm, f)(100),
                                      getattr(jddpm, f)(100))
    jd = jddpm.create_diffusion(100, schedule)
    pd = ddpm.create_diffusion(100, schedule)
    np.testing.assert_array_equal(pd.betas.numpy(), np.asarray(jd.betas))
    np.testing.assert_array_equal(pd.alphas_cum.numpy(),
                                  np.asarray(jd.alphas_cum))
    assert pd.T == jd.T == 100


@pytest.mark.parametrize("pred", ["eps", "x0", "v"])
def test_ddpm_q_sample_target_loss(pred):
    """`q_sample`, `target`, `pred_x0` and `training_loss` on JAX's draws
    (t = randint(split(rng)[0]), noise = normal(split(rng)[1]))."""
    r = np.random.default_rng(2)
    x0 = r.normal(size=(4, 5, 3)).astype(np.float32)
    noise = r.normal(size=(4, 5, 3)).astype(np.float32)
    tt = np.array([0, 17, 60, 99], np.int32)
    jd = jddpm.create_diffusion(100, "cosine", pred)
    pd = ddpm.create_diffusion(100, "cosine", pred)
    tl = torch.from_numpy(tt).long()
    close(pd.q_sample(t(x0), tl, t(noise)),
          jd.q_sample(jnp.asarray(x0), jnp.asarray(tt), jnp.asarray(noise)))
    close(pd.target(t(x0), t(noise), tl),
          jd.target(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(tt)))
    close(pd.pred_x0(t(noise), t(x0), tl),
          jd.pred_x0(jnp.asarray(noise), jnp.asarray(x0), jnp.asarray(tt)),
          rtol=1e-4, atol=1e-5)
    w = r.normal(size=(3, 3)).astype(np.float32)

    def jm(x, tb):
        return jnp.tanh(x @ jnp.asarray(w)) * (tb[:, None, None] / 100.0)

    def pm(x, tb):
        return torch.tanh(x @ t(w)) * (tb[:, None, None] / 100.0)

    rng = jax.random.PRNGKey(6)
    ref, aux = jd.training_loss(jm, rng, jnp.asarray(x0))
    rt, rn = jax.random.split(rng)
    jt = jax.random.randint(rt, (4,), 0, 100)
    jn = jax.random.normal(rn, x0.shape)
    got, paux = pd.training_loss(pm, t(x0), t=torch.from_numpy(
        np.asarray(jt)).long(), noise=t(jn))
    close(got, ref)
    np.testing.assert_array_equal(paux["t"].numpy(), np.asarray(aux["t"]))


def _jax_sampler_noise(rng, n, shape):
    """x_init = normal(split(rng)[0]); step i: key, sub = split(key)
    from split(rng)[1]; normal(sub)."""
    r_init, key = jax.random.split(rng)
    steps = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(sub, shape)))
    return t(jax.random.normal(r_init, shape)), t(np.stack(steps))


@pytest.mark.parametrize("pred", ["eps", "v"])
def test_ddpm_ancestral_and_ddim_samplers(pred):
    """Ancestral sampling over all T = 40 steps and DDIM over 12 respaced
    steps at eta 0 and 0.5, on JAX's initial draw and per-step noise:
    rtol 1e-4 / atol 1e-4 (40 steps of float32 updates whose 1/√ᾱ grows
    to 1e2)."""
    shape = (3, 4, 2)
    w = np.random.default_rng(3).normal(size=(2, 2)).astype(np.float32)

    def jm(x, tb):
        return jnp.tanh(x @ jnp.asarray(w)) * 0.5 + 0.001 * tb[:, None, None]

    def pm(x, tb):
        return torch.tanh(x @ t(w)) * 0.5 + 0.001 * tb[:, None, None]

    jd = jddpm.create_diffusion(40, "linear", pred)
    pd = ddpm.create_diffusion(40, "linear", pred)
    rng = jax.random.PRNGKey(12)
    ref = jd.ddpm_sample(jm, rng, shape)
    x_init, noise = _jax_sampler_noise(rng, 40, shape)
    close(pd.ddpm_sample(pm, shape, x_init=x_init, noise=noise), ref,
          rtol=1e-4, atol=1e-4)
    for eta in (0.0, 0.5):
        ref = jd.ddim_sample(jm, rng, shape, num_steps=12, eta=eta)
        x_init, noise = _jax_sampler_noise(rng, 12, shape)
        close(pd.ddim_sample(pm, shape, num_steps=12, eta=eta,
                             x_init=x_init, noise=noise), ref,
              rtol=1e-4, atol=1e-4)
    g1, g2 = (torch.Generator().manual_seed(0) for _ in range(2))
    a = pd.ddim_sample(pm, shape, num_steps=5, eta=0.3, generator=g1)
    b = pd.ddim_sample(pm, shape, num_steps=5, eta=0.3, generator=g2)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="prediction"):
        ddpm.create_diffusion(10, pred_type="score")
