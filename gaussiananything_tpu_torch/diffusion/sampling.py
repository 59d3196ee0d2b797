"""Fixed-step flow-matching ODE samplers with classifier-free guidance
(port of `cfg_velocity_fn` and `sample_ode` of
`gaussiananything_tpu/diffusion/sampling.py`).

CFG (`VanillaCFG`, `dit/dit_i23d.py:159-172`) batch-doubles one model call
per step: v = v_uncond + scale · (v_cond − v_uncond).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def cfg_velocity_fn(velocity_fn: Callable, cond: NamedTuple,
                    uncond: NamedTuple, cfg_scale: float) -> Callable:
    """`velocity_fn(x, t, c)` → guided `fn(x, t)`; cond/uncond are
    NamedTuples of tensors with a leading batch dim."""
    c2 = type(cond)(*(torch.cat([a, b], dim=0) for a, b in zip(cond, uncond)))

    def guided(x, t):
        v = velocity_fn(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0),
                        c2)
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
        tb = t.expand(B)
        v1 = velocity_fn(x, tb)
        if method == "euler":
            x = x + dt * v1
        else:
            v2 = velocity_fn(x + dt * v1, tb + dt)
            x = x + 0.5 * dt * (v1 + v2)
    return x
