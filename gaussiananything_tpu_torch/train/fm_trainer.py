"""Flow-matching training and sampling (port of
`gaussiananything_tpu/train/fm_trainer.py`; the reference's
`FlowMatchingEngine(_gs)`, `nsr/lsgm/flow_matching_trainer.py:156-572,887`).

Training runs on pre-extracted latents (no VAE forward, `:536`): the
stage-1 target is the normalised FPS xyz (768 × 3, xyz / 0.164), the
stage-2 target the KL latent (768 × 10) given the stage-1 xyz. The
conditioner runs with its ucg dropout inside the loss
(`sgm/modules/encoders/modules.py:130-174`) and trains at 0.5× the DiT's
learning rate (`:374-399`), or is frozen; the loss is the transport's
velocity MSE (`transport/transport.py:148-190`).

Sampling (`:701-744`): x0 ~ N(0, 1) → CFG batch-doubled ODE integration
(Euler, Heun or adaptive dopri5) → ×`latent_divider`; ×0.164 to world
units (stage 1) or the split into (KL latent, xyz) (stage 2).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from gaussiananything_tpu_torch.diffusion.sampling import (
    cfg_velocity_fn, sample_ode, sample_ode_adaptive)
from gaussiananything_tpu_torch.diffusion.transport import Transport
from gaussiananything_tpu_torch.models.conditioner import ucg_keep_mask
from gaussiananything_tpu_torch.parallel.dist import average_, mean_scalars
from gaussiananything_tpu_torch.parallel.mesh import shard_batch
from gaussiananything_tpu_torch.train.state import (TrainState,
                                                    TrainStateConfig,
                                                    global_norm)
from gaussiananything_tpu_torch.utils import profiling

XYZ_SCALE = 0.164   # `datasets/g_buffer_objaverse.py:3645`


@dataclasses.dataclass(frozen=True)
class FMConfig:
    stage: int = 1                      # 1: geometry xyz; 2: texture latent
    cfg_scale: float = 4.5              # release i23d-stage1.sh
    num_steps: int = 250
    sampler: str = "heun"               # 'euler' | 'heun' | 'dopri5'
    latent_divider: float = 1.0         # triplane_scaling_divider


def _grads(loss: torch.Tensor, trees: List[Dict[str, torch.Tensor]]):
    """The loss's gradient for every entry of each tree (zeros where it
    does not reach), one dict per tree."""
    flat = [(i, k, p) for i, tree in enumerate(trees)
            for k, p in tree.items()]
    gs = torch.autograd.grad(loss, [p for _, _, p in flat],
                             allow_unused=True)
    out = [{} for _ in trees]
    for (i, k, p), g in zip(flat, gs):
        out[i][k] = torch.zeros_like(p) if g is None else g
    return out


def make_fm_train_step(dit_model, conditioner_model, transport: Transport,
                       cfg: FMConfig,
                       tx_cfg: Optional[TrainStateConfig] = None,
                       accum: int = 1, mesh=None) -> Callable:
    """Returns train_step(state, cond_state, batch, generator=None,
    draws=None, timer=None) → logs {"fm_loss", "t_mean", "grad_norm"}
    (detached; `grad_norm` is that of the DiT's averaged gradient before
    clipping), after one optimiser and EMA update of `state` and, unless
    it is frozen, of `cond_state` at 0.5× the learning rate (both in
    place). The conditioner's ucg dropout runs in its training mode
    (`conditioner_model.train()`).

    batch: "latent" (B, N, C), the target before `latent_divider`;
    "cond", the conditioner's input (images (B, 3, H, W) or token ids);
    stage 2 also "xyz" (B, N, 3).

    `accum` > 1 is gradient accumulation (the reference's micro-batch
    loop, `flow_matching_trainer.py:504-511`): the batch's `accum`
    consecutive slices run one after the other, their gradients are
    summed and scaled by 1/accum, then ONE update. Activations scale with
    B/accum.

    draws: optional list of one dict per micro-batch with "keep" (mb, 1, 1)
    (the ucg mask), "t" (mb,) and "x0" (mb, N, C); what is absent is
    drawn from `generator`, a host generator, in that order (the JAX
    package draws micro-batch i from `fold_in(rng, i)`).

    A frozen conditioner (a frozen `cond_state`) runs under
    `torch.no_grad()`, outside the differentiated function, with its ucg
    dropout still applied: only its outputs live into the DiT's backward.

    `mesh`: a `parallel.mesh.Mesh` (its data axis; the tile axis renders
    nothing here). `batch` is still the global batch: the step keeps the
    rank's rows, `shard_batch(mesh, batch, micro=accum)`, so its
    micro-batch i is its slice of the global micro-batch i; for every
    micro-batch the rank draws (or is given in `draws`) the draws of the
    global micro-batch, `mesh.data` times its own, and keeps its slice;
    the gradients and logs are the data group's means. The step equals
    the unsharded one on the global batch.
    """
    tx_cfg = tx_cfg or TrainStateConfig()
    # the embedder group at 0.5× lr (`flow_matching_trainer.py:374-399`)
    cond_tx = dataclasses.replace(tx_cfg, lr=tx_cfg.lr * 0.5)

    def micro(state, cond_state, sub, generator, d, timer):
        with torch.set_grad_enabled(not cond_state.frozen):
            cond = conditioner_model(sub["cond"], generator=generator,
                                     keep=d.get("keep"))
        if timer:
            timer.lap("conditioner")
        xyz = sub["xyz"] if cfg.stage == 2 else None

        def velocity(xt, t):
            return dit_model(xt, t, cond.crossattn, cond.vector, xyz=xyz)

        loss, aux = transport.training_loss(
            velocity, sub["latent"] / cfg.latent_divider,
            generator=generator, t=d.get("t"), x0=d.get("x0"))
        if cond_state.frozen:
            (g_dit,), g_cond = _grads(loss, [state.params]), None
        else:
            g_dit, g_cond = _grads(loss, [state.params, cond_state.params])
        if timer:
            timer.lap("forward_backward")
        return loss.detach(), aux["t"].mean().detach(), g_dit, g_cond

    n_data = 1 if mesh is None else mesh.data
    group = None if mesh is None else mesh.data_group

    def sliced_draws(d: dict, mb: int, latent: torch.Tensor,
                     generator) -> dict:
        """The global micro-batch's draws, in the order the unsharded
        step makes them (the ucg mask, t, x0), cut to this rank's rows."""
        d, n = dict(d), mb * n_data
        rate = getattr(conditioner_model, "ucg_rate", 0.0)
        if "keep" not in d and conditioner_model.training and rate > 0:
            d["keep"] = ucg_keep_mask(n, rate, generator)
        if "t" not in d:
            d["t"] = transport.sample_t(n, generator)
        if "x0" not in d:
            d["x0"] = torch.randn((n,) + tuple(latent.shape[1:]),
                                  generator=generator, dtype=latent.dtype)
        lo = mesh.data_index * mb
        return {k: v[lo:lo + mb] for k, v in d.items()}

    def train_step(state: TrainState, cond_state: TrainState, batch,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[List[dict]] = None, timer=None):
        if mesh is not None:
            batch = shard_batch(mesh, batch, micro=accum)
        B = batch["latent"].shape[0]
        if B % accum:
            raise ValueError(f"a batch of {B} does not split into {accum} "
                             "micro-batches")
        mb = B // accum
        if timer:
            timer.start()
        acc_d = acc_c = None
        losses, t_means = [], []
        for i in range(accum):
            sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            d = draws[i] if draws else {}
            if n_data > 1:
                d = sliced_draws(d, mb, sub["latent"], generator)
            loss, t_mean, g_dit, g_cond = micro(
                state, cond_state, sub, generator, d, timer)
            losses.append(loss)
            t_means.append(t_mean)
            if acc_d is None:
                acc_d, acc_c = g_dit, g_cond
            else:
                for k, g in g_dit.items():
                    acc_d[k].add_(g)
                for k, g in (g_cond or {}).items():
                    acc_c[k].add_(g)
        if accum > 1:
            for tree in (acc_d, acc_c or {}):
                for g in tree.values():
                    g.mul_(1.0 / accum)
        average_(acc_d, group)
        average_(acc_c or {}, group)
        logs = mean_scalars({"fm_loss": torch.stack(losses).mean(),
                             "t_mean": torch.stack(t_means).mean()}, group)
        logs["grad_norm"] = global_norm(acc_d)
        state.apply_gradients(acc_d, tx_cfg)
        if not cond_state.frozen:
            cond_state.apply_gradients(acc_c, cond_tx)
        if timer:
            timer.lap("optimizer")
        return logs

    return train_step


def make_sampler(dit_model, conditioner_model, cfg: FMConfig,
                 latent_shape) -> Callable:
    """Returns sample(cond_input, generator=None, xyz=None, x0=None,
    cfg_scale=None, num_steps=None) → latent samples (B, *latent_shape),
    × `cfg.latent_divider`.

    The conditioner runs on `cond_input`; its zeros are the unconditional
    branch. The initial noise is `x0` when given (the tests hand over the
    JAX package's noise), else drawn from `generator`. `cfg_scale` and
    `num_steps` override the config's; `cfg.sampler` "dopri5" integrates
    adaptively (rtol 1e-3, atol 1e-6) and ignores `num_steps`.
    `dit_model`/`conditioner_model` may be any callables with the modules'
    signatures (an EMA evaluation passes `torch.func.functional_call`
    wrappers)."""
    if cfg.sampler not in ("euler", "heun", "dopri5"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")

    @torch.no_grad()
    def sample(cond_input: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               xyz: Optional[torch.Tensor] = None,
               x0: Optional[torch.Tensor] = None,
               cfg_scale: Optional[float] = None,
               num_steps: Optional[int] = None) -> torch.Tensor:
        if cfg.stage == 2 and xyz is None:
            raise ValueError("stage-2 sampling needs the stage-1 xyz")
        B = cond_input.shape[0]
        with profiling.span("ga.condition"):
            cond = conditioner_model(cond_input)
        uncond = type(cond)(*(torch.zeros_like(a) for a in cond))
        xyz2 = None if xyz is None else torch.cat([xyz, xyz], dim=0)

        def velocity(x, t, c):
            return dit_model(x, t, c.crossattn, c.vector, xyz=xyz2)

        scale = cfg.cfg_scale if cfg_scale is None else cfg_scale
        guided = cfg_velocity_fn(velocity, cond, uncond, scale)
        if x0 is None:
            x0 = torch.randn((B,) + tuple(latent_shape), generator=generator,
                             device=cond_input.device)
        x0 = x0.float().to(cond_input.device)
        if cfg.sampler == "dopri5":
            x1 = sample_ode_adaptive(guided, x0)
        else:
            x1 = sample_ode(guided, x0, method=cfg.sampler,
                            num_steps=cfg.num_steps if num_steps is None
                            else num_steps)
        return x1 * cfg.latent_divider

    return sample


def unnormalize_stage1(xyz_latent: torch.Tensor) -> torch.Tensor:
    """Sampled 768×3 → world xyz (×0.164,
    `flow_matching_trainer.py:987,999`)."""
    return xyz_latent * XYZ_SCALE


def split_stage2(latent: torch.Tensor, z_channels: int = 10):
    """(B, N, z + 3) → (KL latent, anchor xyz in world units)
    (`flow_matching_trainer.py:1421-1422`)."""
    return latent[..., :z_channels], latent[..., z_channels:] * XYZ_SCALE
