"""Discrete-time Gaussian diffusion, DDPM and DDIM (port of
`gaussiananything_tpu/diffusion/ddpm.py`; the reference's
`guided_diffusion/gaussian_diffusion.py` + `respace.py`, kept for
LN3Diff-era checkpoints: the release path is flow matching,
`diffusion/transport.py`).

eps / x0 / v prediction, linear and cosine schedules, respaced DDIM and
full-T ancestral sampling. The random draws come from a `torch.Generator`
on the host or are given by the caller: the training loss's `t` and
`noise`; a sampler's initial `x_init` and its per-step `noise` stack.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def linear_betas(T: int, beta_start=1e-4, beta_end=0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, T, dtype=np.float64)


def cosine_betas(T: int, s: float = 0.008) -> np.ndarray:
    f = np.cos((np.arange(T + 1) / T + s) / (1 + s) * math.pi / 2) ** 2
    return np.clip(1 - f[1:] / f[:-1], 0, 0.999)


def _draw(shape, generator, given, device):
    x = given if given is not None else torch.randn(shape,
                                                    generator=generator)
    return x.to(device, torch.float32)


class GaussianDiffusion:
    """betas and their cumulative alphas (T,) float32, on `device`."""

    def __init__(self, betas: torch.Tensor, alphas_cum: torch.Tensor,
                 pred_type: str = "eps"):
        if pred_type not in ("eps", "x0", "v"):
            raise ValueError(f"unknown prediction type {pred_type!r}")
        self.betas = betas
        self.alphas_cum = alphas_cum
        self.pred_type = pred_type

    @property
    def T(self) -> int:
        return self.betas.shape[0]

    def _coefs(self, t: torch.Tensor, ndim: int):
        shape = (t.shape[0],) + (1,) * (ndim - 1)
        ac = self.alphas_cum[t]
        return torch.sqrt(ac).reshape(shape), torch.sqrt(1 - ac).reshape(shape)

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        a, s = self._coefs(t, x0.dim())
        return a * x0 + s * noise

    def target(self, x0, noise, t):
        if self.pred_type == "eps":
            return noise
        if self.pred_type == "x0":
            return x0
        a, s = self._coefs(t, x0.dim())
        return a * noise - s * x0           # v-prediction

    def pred_x0(self, model_out, x_t, t):
        a, s = self._coefs(t, x_t.dim())
        if self.pred_type == "eps":
            return (x_t - s * model_out) / a
        if self.pred_type == "x0":
            return model_out
        return a * x_t - s * model_out

    def training_loss(self, model: Callable, x0: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None, **kwargs
                      ) -> Tuple[torch.Tensor, dict]:
        """MSE of model(x_t, t) against the prediction target; `t` (B,)
        integer steps and `noise` drawn from `generator` where not
        given."""
        if t is None:
            t = torch.randint(0, self.T, (x0.shape[0],), generator=generator)
        t = t.to(x0.device, torch.long)
        noise = _draw(x0.shape, generator, noise, x0.device)
        out = model(self.q_sample(x0, t, noise), t, **kwargs)
        return ((out - self.target(x0, noise, t)) ** 2).mean(), {"t": t}

    @torch.no_grad()
    def ddim_sample(self, model: Callable, shape, num_steps: int = 50,
                    eta: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    x_init: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None, **kwargs
                    ) -> torch.Tensor:
        """DDIM over `num_steps` respaced steps from T − 1 to 0 (`respace.py`
        + the DDIM loop). `noise`: the (num_steps, *shape) stack of the
        per-step draws (used where eta > 0); drawn after `x_init` from
        `generator` otherwise."""
        dev = self.betas.device
        ts = torch.linspace(self.T - 1, 0, num_steps,
                            dtype=torch.float32).round().long().tolist()
        x = _draw(shape, generator, x_init, dev)
        for i, t in enumerate(ts):
            t_next = ts[i + 1] if i + 1 < num_steps else -1
            eps_i = _draw(shape, generator,
                          None if noise is None else noise[i], dev)
            tb = torch.full((shape[0],), t, dtype=torch.long, device=dev)
            x0 = self.pred_x0(model(x, tb, **kwargs), x, tb)
            a_t = self.alphas_cum[t]
            a_next = self.alphas_cum[t_next] if t_next >= 0 else \
                torch.ones((), device=dev)
            eps = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1 - a_t)
            sigma = eta * torch.sqrt((1 - a_next) / (1 - a_t)) * torch.sqrt(
                1 - a_t / a_next)
            dir_xt = torch.sqrt(torch.clamp(1 - a_next - sigma ** 2,
                                            min=0.0)) * eps
            x = torch.sqrt(a_next) * x0 + dir_xt \
                + sigma * eps_i * float(t_next >= 0)
        return x

    @torch.no_grad()
    def ddpm_sample(self, model: Callable, shape,
                    generator: Optional[torch.Generator] = None,
                    x_init: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None, **kwargs
                    ) -> torch.Tensor:
        """Full-T ancestral sampling, x0 clipped to [−5, 5]. `noise`: the
        (T, *shape) stack of the per-step draws (step i is t = T − 1 − i),
        drawn after `x_init` from `generator` otherwise."""
        dev = self.betas.device
        x = _draw(shape, generator, x_init, dev)
        alphas = 1.0 - self.betas
        acum_prev = torch.cat([torch.ones(1, device=dev),
                               self.alphas_cum[:-1]])
        for i in range(self.T):
            t = self.T - 1 - i
            eps_i = _draw(shape, generator,
                          None if noise is None else noise[i], dev)
            tb = torch.full((shape[0],), t, dtype=torch.long, device=dev)
            x0 = torch.clamp(self.pred_x0(model(x, tb, **kwargs), x, tb),
                             -5, 5)
            denom = 1 - self.alphas_cum[t]
            coef1 = self.betas[t] * torch.sqrt(acum_prev[t]) / denom
            coef2 = (1 - acum_prev[t]) * torch.sqrt(alphas[t]) / denom
            var = self.betas[t] * (1 - acum_prev[t]) / denom
            x = coef1 * x0 + coef2 * x + torch.sqrt(
                torch.clamp(var, min=1e-20)) * eps_i * float(t > 0)
        return x


def create_diffusion(T: int = 1000, schedule: str = "linear",
                     pred_type: str = "eps", device="cpu"
                     ) -> GaussianDiffusion:
    betas = linear_betas(T) if schedule == "linear" else cosine_betas(T)
    alphas_cum = np.cumprod(1 - betas)
    return GaussianDiffusion(
        betas=torch.as_tensor(betas, dtype=torch.float32, device=device),
        alphas_cum=torch.as_tensor(alphas_cum, dtype=torch.float32,
                                   device=device),
        pred_type=pred_type)
