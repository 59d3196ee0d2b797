"""Flow-matching transport: interpolant paths, the training loss and the
score algebra of the SDE sampler (port of
`gaussiananything_tpu/diffusion/transport.py`; the reference's SiT
`transport/transport.py:48-242`, `transport/path.py:18-191`).

  * paths: linear (`ICPlan`), GVP (α = sin(πt/2), σ = cos(πt/2), the
    release path), VP;
  * convention: x_t = α_t·x1 + σ_t·x0 with x1 the data and x0 the noise;
    the target velocity u_t = α̇_t·x1 + σ̇_t·x0; loss = ‖v̂ − u_t‖²;
  * t: uniform on [1e-5, 1 − 1e-5] or logit-normal(0, 1).

The random draws come from an explicit `torch.Generator` (on the host, so
one seed gives the same draws on the card and the CPU) or are given by the
caller (`t`, `x0`), which is how another implementation's draws are handed
over.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch


class Path(NamedTuple):
    alpha: Callable[[torch.Tensor], torch.Tensor]
    sigma: Callable[[torch.Tensor], torch.Tensor]
    d_alpha: Callable[[torch.Tensor], torch.Tensor]
    d_sigma: Callable[[torch.Tensor], torch.Tensor]
    name: str


def linear_path() -> Path:
    return Path(alpha=lambda t: t, sigma=lambda t: 1 - t,
                d_alpha=lambda t: torch.ones_like(t),
                d_sigma=lambda t: -torch.ones_like(t), name="linear")


def gvp_path() -> Path:
    h = math.pi / 2
    return Path(alpha=lambda t: torch.sin(h * t),
                sigma=lambda t: torch.cos(h * t),
                d_alpha=lambda t: h * torch.cos(h * t),
                d_sigma=lambda t: -h * torch.sin(h * t), name="gvp")


def vp_path(beta_min: float = 0.1, beta_max: float = 20.0) -> Path:
    """VP with the data at t = 1: log α integrates β linearly in 1 − t."""
    def log_alpha(t):
        s = 1 - t
        return -0.25 * s ** 2 * (beta_max - beta_min) - 0.5 * s * beta_min

    def alpha(t):
        return torch.exp(log_alpha(t))

    def sigma(t):
        return torch.sqrt(torch.clamp(1 - alpha(t) ** 2, min=1e-12))

    def d_alpha(t):
        return alpha(t) * (0.5 * (1 - t) * (beta_max - beta_min)
                           + 0.5 * beta_min)

    def d_sigma(t):
        return -alpha(t) * d_alpha(t) / sigma(t)

    return Path(alpha, sigma, d_alpha, d_sigma, name="vp")


PATHS = {"linear": linear_path, "gvp": gvp_path, "vp": vp_path}


def _expand_t(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.reshape((t.shape[0],) + (1,) * (x.dim() - 1))


class Transport(NamedTuple):
    path: Path
    t_sampler: str = "uniform"     # or "lognorm"

    def sample_t(self, batch: int,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """(batch,) times on the generator's device: uniform on [1e-5,
        1 − 1e-5), or the sigmoid of a standard normal (`lognorm`)."""
        if self.t_sampler == "lognorm":
            return torch.sigmoid(torch.randn(batch, generator=generator))
        lo, hi = 1e-5, 1 - 1e-5
        return lo + (hi - lo) * torch.rand(batch, generator=generator)

    def plan(self, x1: torch.Tensor, x0: torch.Tensor, t: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x_t, target velocity u_t); t (B,) broadcasts over the rest."""
        a = _expand_t(self.path.alpha(t), x1)
        s = _expand_t(self.path.sigma(t), x1)
        da = _expand_t(self.path.d_alpha(t), x1)
        ds = _expand_t(self.path.d_sigma(t), x1)
        return a * x1 + s * x0, da * x1 + ds * x0

    def training_loss(self, velocity_fn: Callable, x1: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      t: Optional[torch.Tensor] = None,
                      x0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, dict]:
        """velocity_fn(x_t, t) → v̂. Returns (scalar loss, {"t",
        "per_sample"}). `t` and `x0` are drawn from `generator` (t first,
        as the JAX package splits its key) where not given, and moved to
        x1's device."""
        if t is None:
            t = self.sample_t(x1.shape[0], generator)
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, dtype=x1.dtype)
        t = t.to(x1.device, torch.float32)
        x0 = x0.to(x1.device, x1.dtype)
        xt, ut = self.plan(x1, x0, t)
        v = velocity_fn(xt, t)
        per_sample = ((v - ut) ** 2).mean(dim=tuple(range(1, x1.dim())))
        return per_sample.mean(), {"t": t, "per_sample": per_sample}


def create_transport(path_type: str = "gvp", t_sampler: str = "uniform"
                     ) -> Transport:
    return Transport(path=PATHS[path_type](), t_sampler=t_sampler)


# ---------------------------------------------------------------------------
# Score and diffusion algebra of the SDE sampler (the reference's
# `transport/path.py:35-80` ICPlan methods).
# ---------------------------------------------------------------------------

def score_from_velocity(path: Path, v: torch.Tensor, x: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """∇log p_t(x) from a velocity prediction, by the change of variables
    (`transport/path.py:70-80`):
        score = ((α/α̇)·v − x) / (σ² − (α/α̇)·σ̇·σ),
    finite for t in (0, 1)."""
    t = _expand_t(t, x)
    a, da = path.alpha(t), path.d_alpha(t)
    s, ds = path.sigma(t), path.d_sigma(t)
    rar = a / da
    return (rar * v - x) / (s * s - rar * ds * s)


def sde_diffusion(path: Path, t: torch.Tensor, form: str = "sbdm",
                  norm: float = 1.0) -> torch.Tensor:
    """Diffusion coefficient w(t) of the marginal-preserving reverse SDE
    (`transport/path.py:45-68` `compute_diffusion`). 'sbdm' (the
    reference's default): w = (α̇/α)·σ² − σ·σ̇."""
    a, da = path.alpha(t), path.d_alpha(t)
    s, ds = path.sigma(t), path.d_sigma(t)
    if form == "sbdm":
        return norm * ((da / a) * s * s - s * ds)
    if form == "sigma":
        return norm * s
    if form == "linear":
        return norm * (1.0 - t)
    if form == "constant":
        return torch.full_like(t, norm)
    raise NotImplementedError(f"diffusion form {form!r}")
