"""Flow-matching sampling (port of `make_sampler`, `XYZ_SCALE` and
`unnormalize_stage1` of `gaussiananything_tpu/train/fm_trainer.py`).

Sampling (`nsr/lsgm/flow_matching_trainer.py:701-744`): x0 ~ N(0, 1) →
CFG batch-doubled ODE integration → ×0.164 to world units (stage 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from gaussiananything_tpu_torch.diffusion.sampling import (cfg_velocity_fn,
                                                           sample_ode)

XYZ_SCALE = 0.164   # `datasets/g_buffer_objaverse.py:3645`


@dataclasses.dataclass(frozen=True)
class FMConfig:
    stage: int = 1                      # 1: geometry xyz; 2: texture latent
    cfg_scale: float = 4.5              # release i23d-stage1.sh
    num_steps: int = 250
    sampler: str = "heun"               # 'euler' | 'heun'


def make_sampler(dit_model, conditioner_model, cfg: FMConfig,
                 latent_shape) -> Callable:
    """Returns sample(cond_input, generator=None, xyz=None, x0=None) →
    latent samples (B, *latent_shape).

    The conditioner runs on `cond_input`; its zeros are the unconditional
    branch. The initial noise is `x0` when given (the tests hand over the
    JAX package's noise), else drawn from `generator`.
    """

    @torch.no_grad()
    def sample(cond_input: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               xyz: Optional[torch.Tensor] = None,
               x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cfg.stage == 2 and xyz is None:
            raise ValueError("stage-2 sampling needs the stage-1 xyz")
        B = cond_input.shape[0]
        cond = conditioner_model(cond_input)
        uncond = type(cond)(*(torch.zeros_like(a) for a in cond))
        xyz2 = None if xyz is None else torch.cat([xyz, xyz], dim=0)

        def velocity(x, t, c):
            return dit_model(x, t, c.crossattn, c.vector, xyz=xyz2)

        guided = cfg_velocity_fn(velocity, cond, uncond, cfg.cfg_scale)
        if x0 is None:
            x0 = torch.randn((B,) + tuple(latent_shape), generator=generator,
                             device=cond_input.device)
        return sample_ode(guided, x0.float(), num_steps=cfg.num_steps,
                          method=cfg.sampler)

    return sample


def unnormalize_stage1(xyz_latent: torch.Tensor) -> torch.Tensor:
    """Sampled 768×3 → world xyz (×0.164,
    `flow_matching_trainer.py:987,999`)."""
    return xyz_latent * XYZ_SCALE
