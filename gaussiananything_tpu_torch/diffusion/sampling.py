"""Flow-matching samplers with classifier-free guidance (port of
`gaussiananything_tpu/diffusion/sampling.py`): fixed-step Euler/Heun, the
adaptive Dormand–Prince 5(4) ODE solver and the Euler–Maruyama SDE sampler
(`transport/transport.py:246-431`, `transport/integrators.py:8-75` of the
reference).

CFG (`VanillaCFG`, `dit/dit_i23d.py:159-172`) batch-doubles one model call
per step: v = v_uncond + scale · (v_cond − v_uncond).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gaussiananything_tpu_torch.diffusion.transport import (
    Path, gvp_path, score_from_velocity, sde_diffusion)
from gaussiananything_tpu_torch.utils import profiling


def cfg_velocity_fn(velocity_fn: Callable, cond: NamedTuple,
                    uncond: NamedTuple, cfg_scale: float) -> Callable:
    """`velocity_fn(x, t, c)` → guided `fn(x, t)`; cond/uncond are
    NamedTuples of tensors with a leading batch dim."""
    c2 = type(cond)(*(torch.cat([a, b], dim=0) for a, b in zip(cond, uncond)))

    def guided(x, t):
        with profiling.span("ga.velocity"):
            v = velocity_fn(torch.cat([x, x], dim=0),
                            torch.cat([t, t], dim=0), c2)
            v_c, v_u = v.chunk(2, dim=0)
            return v_u + cfg_scale * (v_c - v_u)

    return guided


def sample_ode(velocity_fn: Callable, x0: torch.Tensor, num_steps: int = 250,
               method: str = "heun") -> torch.Tensor:
    """Integrate dx/dt = v(x, t) from t = 0 (noise) to t = 1 (data) in
    `num_steps` fixed steps; method 'euler' | 'heun'."""
    if method not in ("euler", "heun"):
        raise ValueError(f"unknown fixed-step method {method!r}")
    B = x0.shape[0]
    dt = 1.0 / num_steps
    ts = torch.arange(num_steps, dtype=torch.float32, device=x0.device) * dt
    x = x0
    for t in ts:
        with profiling.span("ga.step"):
            tb = t.expand(B)
            v1 = velocity_fn(x, tb)
            if method == "euler":
                x = x + dt * v1
            else:
                v2 = velocity_fn(x + dt * v1, tb + dt)
                x = x + 0.5 * dt * (v1 + v2)
    return x


# ---------------------------------------------------------------------------
# Adaptive Dormand–Prince 5(4), as `jax.experimental.ode.odeint` (JAX 0.9)
# computes it: its Butcher tableau, its dense-output polynomial, its initial
# step (Hairer, Nørsett & Wanner, Sec. II.4, with order 4), its RMS error
# norm over every element of the state and its step controller (safety 0.9,
# factor bounds 0.2 and 10, order 5). Like odeint it steps past the end
# point and interpolates there with the last accepted step's polynomial;
# it does not clip the last step.
# ---------------------------------------------------------------------------

_DP_ALPHA = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1., 1., 0)
_DP_BETA = ((1 / 5, 0, 0, 0, 0, 0, 0),
            (3 / 40, 9 / 40, 0, 0, 0, 0, 0),
            (44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0),
            (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0),
            (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656,
             0, 0),
            (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0))
_DP_C_SOL = (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0)
_DP_C_ERR = (35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085,
             125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
             11 / 84 - 649 / 6300, -1. / 60.)
_DP_C_MID = (6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
             -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
             -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2)

_f32 = np.float32


def _combine(coef, k: torch.Tensor) -> torch.Tensor:
    """Σ_j coef[j]·k[j] over the stage axis of k (7, ...)."""
    c = torch.tensor(coef, dtype=k.dtype, device=k.device)
    return torch.tensordot(c, k, dims=1)


def _rk_step(fn, y0, f0, t0, dt):
    """One Dormand–Prince step: (y1, f1, error estimate, stages k)."""
    k = torch.zeros((7,) + y0.shape, dtype=y0.dtype, device=y0.device)
    k[0] = f0
    for i in range(1, 7):
        ti = _f32(t0 + dt * _f32(_DP_ALPHA[i - 1]))
        k[i] = fn(y0 + float(dt) * _combine(_DP_BETA[i - 1], k), ti)
    y1 = float(dt) * _combine(_DP_C_SOL, k) + y0
    return y1, k[-1], float(dt) * _combine(_DP_C_ERR, k), k


def _interp_fit(y0, y1, k, dt):
    """The 4th-order dense-output polynomial of a step, coefficients
    (a, b, c, d, e) highest power first."""
    dt = float(dt)
    y_mid = y0 + dt * _combine(_DP_C_MID, k)
    dy0, dy1 = k[0], k[-1]
    return (-2. * dt * dy0 + 2. * dt * dy1 - 8. * y0 - 8. * y1 + 16. * y_mid,
            5. * dt * dy0 - 3. * dt * dy1 + 18. * y0 + 14. * y1 - 32. * y_mid,
            -4. * dt * dy0 + dt * dy1 - 11. * y0 - 5. * y1 + 16. * y_mid,
            dt * dy0, y0)


def _initial_step(fn, t0, y0, f0, rtol, atol, order=4):
    scale = atol + y0.abs() * rtol
    d0 = _f32(torch.linalg.vector_norm(y0 / scale).item())
    d1 = _f32(torch.linalg.vector_norm(f0 / scale).item())
    h0 = _f32(1e-6) if (d0 < 1e-5 or d1 < 1e-5) else _f32(0.01 * d0 / d1)
    f1 = fn(y0 + float(h0) * f0, _f32(t0 + h0))
    d2 = _f32(torch.linalg.vector_norm((f1 - f0) / scale).item() / h0)
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = np.maximum(_f32(1e-6), h0 * _f32(1e-3))
    else:
        h1 = (_f32(0.01) / np.maximum(d1, d2)) ** _f32(1. / (order + 1.))
    return np.minimum(_f32(100.) * h0, h1)


def _next_step(dt, ratio, safety=0.9, ifactor=10.0, dfactor=0.2,
               order=5.0):
    """The controller's next step after an error ratio; NaN propagates as
    in `jnp.maximum`/`jnp.minimum`, which ends the integration."""
    dfactor = _f32(1.0) if ratio < 1 else _f32(dfactor)
    factor = np.minimum(_f32(ifactor), np.maximum(
        ratio ** _f32(-1.0 / order) * _f32(safety), dfactor))
    new = dt * _f32(ifactor) if ratio == 0 else dt * factor
    return _f32(max(new, 0.0)) if new == new else new


def sample_ode_adaptive(velocity_fn: Callable, x0: torch.Tensor,
                        rtol: float = 1e-3, atol: float = 1e-6
                        ) -> torch.Tensor:
    """Integrate dx/dt = v(x, t) from t = 0 to t = 1 with the adaptive
    Dormand–Prince 5(4) solver (the reference's torchdiffeq dopri5, atol
    1e-6 / rtol 1e-3, `transport/transport.py:388-391`). The step control
    follows `jax.experimental.ode.odeint` as written in JAX 0.9 (see the
    comment above), whose routine the JAX package calls: the initial step,
    the error norm over the whole state, the controller, and the
    interpolation at t = 1. The times and steps are float32 on the host;
    each step reads its error ratio back from the device."""
    B = x0.shape[0]

    def fn(y, t):
        return velocity_fn(y, torch.full((B,), float(t), dtype=torch.float32,
                                         device=y.device))

    y = x0
    f = fn(y, _f32(0.0))
    t, last_t, target = _f32(0.0), _f32(0.0), _f32(1.0)
    dt = _initial_step(fn, t, y, f, rtol, atol)
    coeff = (y,) * 5
    while t < target and dt > 0:
        with profiling.span("ga.step"):
            y1, f1, err, k = _rk_step(fn, y, f, t, dt)
            tol = atol + rtol * torch.maximum(y.abs(), y1.abs())
            ratio = _f32(torch.sqrt(((err / tol) ** 2).mean()).item())
            new_dt = _next_step(dt, ratio)
            if ratio <= 1:
                coeff = _interp_fit(y, y1, k, dt)
                y, f, last_t, t = y1, f1, t, _f32(t + dt)
            dt = new_dt
    r = float(_f32((target - last_t) / (t - last_t)))
    out = torch.zeros_like(x0)
    for c in coeff:
        out = out * r + c
    return out


def sample_sde(velocity_fn: Callable, x0: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               path: Optional[Path] = None, num_steps: int = 250,
               diffusion_form: str = "sbdm", diffusion_norm: float = 1.0,
               last_step_size: float = 0.04, t0: float = 4e-3,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Euler–Maruyama SDE sampler with the score-corrected drift
    (`transport/transport.py:268-363`, `transport/integrators.py:29-37`):
        drift = v + w(t)·score(v, x, t),  dx = drift·dt + √(2·w(t)·dt)·ε,
    which preserves the flow's marginals; num_steps − 1 steps over
    t ∈ [t0, 1 − last_step_size], then the reference's noise-free "Mean"
    last step x += drift·last_step_size. The per-step noise ε is
    `noise[i]` of a given (num_steps − 1, *x0.shape) stack, else drawn from
    `generator` on the host, one step at a time."""
    path = path or gvp_path()
    B = x0.shape[0]
    t1 = 1.0 - last_step_size
    ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
    dt = (t1 - t0) / (num_steps - 1)

    def drift_fn(x, t):
        tb = torch.full((B,), float(t), dtype=torch.float32, device=x.device)
        v = velocity_fn(x, tb)
        w = sde_diffusion(path, t.to(x.device), form=diffusion_form,
                          norm=diffusion_norm)
        return v + w * score_from_velocity(path, v, x, tb), w

    x = x0
    for i, t in enumerate(ts[:-1]):
        eps = noise[i] if noise is not None else torch.randn(
            x.shape, generator=generator, dtype=x.dtype)
        drift, w = drift_fn(x, t)
        x = x + dt * drift + torch.sqrt(2.0 * w * dt) * eps.to(x.device)
    drift, _ = drift_fn(x, torch.tensor(t1, dtype=torch.float32))
    return x + last_step_size * drift
