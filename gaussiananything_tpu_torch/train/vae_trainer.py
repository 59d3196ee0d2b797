"""VAE training: multi-view reconstruction with per-LoD rendering, KL
annealing, the 2DGS geometry regularisers and the optional PatchGAN (port
of `gaussiananything_tpu/train/vae_trainer.py`).

`TrainLoop3DRecNVPatchSingleForwardMV_NoCrop(_adv)` (`nsr/train_nv_util.py:
1771-3048`): the batch carries input views (15 channels) and supervision
views (rgb, alpha, depth); encode with FPS anchors → decode every LoD →
render each LoD at its own resolution (the release ladder 128/256/384/512,
`vit/vit_triplane.py:1605-1613`; `rand_coarse_lod` renders ONE random
coarse LoD and the finest, `:1550-1591`); losses per LoD (L1, alpha, the
perceptual term on one drawn LoD, scale-invariant depth), KL on the
bottleneck, normal and distortion regularisers on the finest render after
their start steps (`:2158-2175`), scale/opacity regularisers
(`:2143-2155`), optional chamfer supervision (`:2244-2246`), and with a
discriminator the generator's hinge loss under the adaptive weight
(`:2877-3014`). `make_disc_step` is the discriminator's step,
`make_accum_train_step` the gradient accumulation over micro-batches.

The renders go through the differentiable rasterizer (`impl="cuda"`: the
training kernels on the card, their plain versions on the CPU; without
gradient, as in the discriminator's step, the forward-only kernel). The
step's random draws come from a `torch.Generator` or are passed in
(`draws`), so two implementations can be fed the same noise.

On a mesh (`parallel.mesh.make_mesh`, one process per rank) each step
takes the global batch and keeps the rank's rows (`shard_batch`); it
draws the noise of the whole global batch from the same generator and
keeps its slice, so a sharded step equals the unsharded one. The renders
take the mesh's tile axis (row bands, `render/sharded.py`). Every term
of the loss is a mean over the batch, whose gradient is the data group's
mean of the slices' gradients, except the scale-invariant depth loss, a
ratio of sums over the whole batch, which is summed over the group
before it is divided (`parallel.dist.sum_replicated`); the adaptive
weight's gradient norms are summed over the group as well. The gradients
are averaged over the data group before the optimizer; the logs are the
group's means.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from gaussiananything_tpu_torch.ops.pointcloud import chamfer_distance
from gaussiananything_tpu_torch.parallel.dist import (all_reduce_, average_,
                                                      mean_scalars,
                                                      sum_replicated)
from gaussiananything_tpu_torch.parallel.mesh import shard_batch
from gaussiananything_tpu_torch.render.renderer import render_multiview
from gaussiananything_tpu_torch.train import losses as L
from gaussiananything_tpu_torch.train.state import (TrainState,
                                                    TrainStateConfig,
                                                    global_norm)
from gaussiananything_tpu_torch.utils.image import resize


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    l1_weight: float = 1.0
    perceptual_weight: float = 0.5
    alpha_weight: float = 1.0
    depth_weight: float = 0.5
    kl_target: float = 1e-5
    kl_anneal_steps: int = 5000
    normal_weight: float = 0.05
    normal_start_step: int = 3500      # reference: 35k of 100k (`:2158`)
    dist_weight: float = 100.0
    dist_start_step: int = 1500        # reference: 15k (`:2167`)
    scale_reg_weight: float = 1.0
    opacity_reg_weight: float = 0.01
    chamfer_weight: float = 0.0
    # render resolution per LoD, coarse → fine; (128, 256, 384, 512) is
    # the release ladder
    lod_resolutions: Tuple[int, ...] = (64, 128, 192, 256)
    adv_weight: float = 0.0
    # the generator's adversarial term starts at this step and is balanced
    # against the reconstruction gradient (`nsr/train_nv_util.py:
    # 2877-3014`, `dnnlib/util.py:41`)
    adv_start_step: int = 0
    adaptive_adv: bool = True
    # supervise ONE random coarse LoD and the finest per step instead of
    # all LoDs (`vit/vit_triplane.py:1550-1591`)
    rand_coarse_lod: bool = False


class StageTimer:
    """Seconds per named stage of a step; each stage ends in a device
    synchronise so the host clock sees the device's work."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}
        self._t = None

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self):
        self._t = self._now()

    def lap(self, stage: str):
        t = self._now()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + t - self._t
        self._t = t


def render_lods(lods: Sequence[torch.Tensor], cam_view: torch.Tensor,
                cam_view_proj: torch.Tensor, bg: torch.Tensor,
                resolutions: Sequence[int], max_per_tile: int = 1024,
                impl: str = "cuda", chunk: int = 128, mesh=None,
                remat: bool = True) -> List[Dict[str, torch.Tensor]]:
    """Render each LoD at its ladder resolution: a list of the map dicts of
    `render_multiview` (row bands over `mesh`'s tile axis). chunk 128 is
    the training kernels' chunk.

    remat: under autograd, each LoD's render is checkpointed
    (`torch.utils.checkpoint`, as the JAX package's `jax.checkpoint`):
    the backward renders it again instead of holding what the render
    saved, so K2a runs twice per rendered view. The binning sorts are
    stable, so the recompute builds the same pair table; on a mesh every
    rank recomputes its bands, so the joins' collectives run again in the
    same order on every rank. Losses and gradients are the same with and
    without it."""
    B, V = cam_view.shape[:2]
    bg = bg.float().expand(B, V, 3)

    def render(g, res):
        return render_multiview(g, cam_view, cam_view_proj, bg, res, tile=16,
                                max_per_tile=max_per_tile, chunk=chunk,
                                impl=impl, mesh=mesh)

    out = []
    for g, res in zip(lods, resolutions):
        if remat and torch.is_grad_enabled() and g.requires_grad:
            out.append(checkpoint(render, g, res, use_reentrant=False))
        else:
            out.append(render(g, res))
    return out


def _resize_to(x: torch.Tensor, res: int) -> torch.Tensor:
    """(B, V, C, H, W) → antialiased bilinear resize to (res, res)."""
    if x.shape[-2] == res and x.shape[-1] == res:
        return x
    return resize(x, (res, res), "linear")


def draw_step_randomness(n_lod: int, cfg: VAELossConfig,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, Optional[int]]:
    """The step's discrete draws: which LoD gets the perceptual term and,
    under `rand_coarse_lod`, which coarse LoD is rendered. In that mode
    only {coarse_idx, finest} are rendered, so the perceptual draw is
    between those two."""
    def randint(n):
        return int(torch.randint(0, n, (), generator=generator))

    if cfg.rand_coarse_lod and n_lod > 2:
        coarse_idx = randint(n_lod - 1)
        lpips_lod = n_lod - 1 if randint(2) else coarse_idx
        return {"coarse_idx": coarse_idx, "lpips_lod": lpips_lod}
    return {"coarse_idx": None, "lpips_lod": randint(n_lod)}


def _data_axis(mesh):
    """(index, size, group) of this rank's data slice; (0, 1, None)
    without a mesh."""
    if mesh is None:
        return 0, 1, None
    return mesh.data_index, mesh.data, mesh.data_group


def _noise(model, batch, generator, draws, mesh=None) -> torch.Tensor:
    """The latent noise of `draws`, else drawn on the host from
    `generator` (so a seed gives the same noise on the card and the CPU),
    on the batch's device. On a mesh the noise (drawn or given) is the
    global batch's, of which the rank keeps its data slice."""
    idx, n_data, _ = _data_axis(mesh)
    b = batch["images_in"].shape[0]
    noise = (draws or {}).get("noise")
    if noise is None:
        noise = torch.randn((b * n_data,) + model.latent_shape,
                            generator=generator)
    if n_data > 1:
        noise = noise[idx * b:(idx + 1) * b]
    return noise.to(batch["images_in"].device)


def _depth_loss(pred, gt, mask, group):
    """`losses.depth_loss_scale_invariant` over the whole global batch:
    the per-view alignment is local, the final ratio's sums are summed over
    the data group."""
    if group is None:
        return L.depth_loss_scale_invariant(pred, gt, mask)
    num, den = L.depth_loss_scale_invariant(pred, gt, mask, sums=True)
    return sum_replicated(num, group) / torch.clamp(
        sum_replicated(den.detach(), group), min=1.0)


def vae_loss_fn(model, batch: Dict[str, torch.Tensor], step: int,
                cfg: VAELossConfig,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None, perceptual_net=None,
                timer: Optional[StageTimer] = None, disc_model=None,
                mesh=None):
    """Returns (total, (logs, renders, lods)).

    batch: images_in (B, V_in, 15, H, W); pcd (B, P, 3); cam_view and
    cam_view_proj (B, V_sup, 4, 4); tanfov scalar or (B, V_sup);
    images_sup (B, V_sup, 3, H, W); alpha_sup and optionally depth_sup
    (B, V_sup, 1, H, W).

    draws: optional {"noise": (B, K, z) latent noise, "lpips_lod": int,
    "coarse_idx": int}; what is absent is drawn from `generator`, a CPU
    generator. `perceptual_net`: as for `losses.perceptual_loss` (a
    `VGGLPIPS` for LPIPS). `disc_model`: the discriminator, whose hinge
    loss joins the total when `cfg.adv_weight` > 0. `mesh`: a
    `parallel.mesh.Mesh`; the batch is then the rank's data slice, the
    noise of `draws` the global batch's, and the returned total and logs
    the rank's (their data-group means are the unsharded step's; the logs
    named in `REPLICATED_LOGS` are already equal on every rank).
    """
    draws = dict(draws or {})
    dev = batch["images_in"].device
    _, _, data_group = _data_axis(mesh)
    out = model(batch["images_in"], batch["pcd"],
                noise=_noise(model, batch, generator, draws, mesh))
    lods = out["lods"]
    n_lod = len(lods)
    if "lpips_lod" not in draws:
        draws.update(draw_step_randomness(n_lod, cfg, generator))
    lpips_lod, coarse_idx = draws["lpips_lod"], draws.get("coarse_idx")
    bg = torch.ones(3, dtype=torch.float32, device=dev)
    if timer:
        timer.lap("forward")

    logs: Dict[str, torch.Tensor] = {}

    def lod_loss(rend, res, i, log=True):
        gt_img = _resize_to(batch["images_sup"], res)
        gt_alpha = _resize_to(batch["alpha_sup"], res)
        rec = L.l1(rend["image"], gt_img)
        al = L.mse(rend["alpha"], gt_alpha)
        sub = cfg.l1_weight * rec + cfg.alpha_weight * al
        if log:
            logs[f"l1_lod{i}"] = rec
            logs[f"alpha_lod{i}"] = al
        if cfg.perceptual_weight > 0:
            # the pyramid runs only for the drawn LoD
            p = L.perceptual_loss(rend["image"].flatten(0, 1),
                                  gt_img.flatten(0, 1), perceptual_net) \
                if lpips_lod == i else torch.zeros((), device=dev)
            sub = sub + cfg.perceptual_weight * p
            if log:
                logs[f"lpips_lod{i}"] = p
        if "depth_sup" in batch and cfg.depth_weight > 0:
            dl = _depth_loss(rend["depth"],
                             _resize_to(batch["depth_sup"], res), gt_alpha,
                             data_group)
            sub = sub + cfg.depth_weight * dl
            if log:
                logs[f"depth_lod{i}"] = dl
        if timer:
            timer.lap("loss")
        return sub

    def render(idx: Sequence[int]):
        rends = render_lods([lods[i] for i in idx], batch["cam_view"],
                            batch["cam_view_proj"], bg,
                            [cfg.lod_resolutions[i] for i in idx], mesh=mesh)
        if timer:
            timer.lap("render")
        return rends

    total = 0.0
    if cfg.rand_coarse_lod and n_lod > 2:
        coarse = lod_loss(render([coarse_idx])[0],
                          cfg.lod_resolutions[coarse_idx], coarse_idx,
                          log=False)
        logs["coarse_lod_loss"] = coarse
        renders = render([n_lod - 1])
        total = coarse + lod_loss(renders[-1],
                                  cfg.lod_resolutions[n_lod - 1], n_lod - 1)
    else:
        renders = render(range(n_lod))
        for i, rend in enumerate(renders):
            total = total + lod_loss(rend, cfg.lod_resolutions[i], i)

    kl = out["kl"].mean()
    total = total + L.kl_coeff_schedule(step, cfg.kl_target,
                                        cfg.kl_anneal_steps) * kl
    logs["kl"] = kl

    # 2DGS geometry regularisers on the finest render, gated by step. The
    # EXPECTED depth feeds the depth → normal surface, as in the reference
    # (`utils/point_utils.py:11,65`); the depth losses above use the median
    fin = renders[-1]
    dist = fin["dist"].mean()
    total = total + cfg.dist_weight * float(step >= cfg.dist_start_step) \
        * dist
    logs["dist"] = dist
    surf_n = L.depth_to_normal(fin["depth_expected"], batch["cam_view"],
                               batch["tanfov"])
    nl = L.normal_consistency_loss(fin["rend_normal"], surf_n, fin["alpha"])
    total = total + cfg.normal_weight \
        * float(step >= cfg.normal_start_step) * nl
    logs["normal"] = nl

    total = total + cfg.scale_reg_weight * L.scale_reg(lods[-1]) \
        + cfg.opacity_reg_weight * L.opacity_reg(lods[-1])
    with torch.no_grad():
        op = lods[-1][..., 3]
        sc = lods[-1][..., 4:6]
        logs["opacity_mean"] = op.mean()
        logs["opacity_p95"] = torch.quantile(_gather(op, mesh).flatten(),
                                             0.95)
        logs["scale_mean"] = sc.mean()
        logs["scale_max"] = all_reduce_(sc.max().clone(), data_group,
                                        torch.distributed.ReduceOp.MAX)

    if cfg.chamfer_weight > 0:
        cd = chamfer_distance(lods[-1][..., :3], batch["pcd"]).mean()
        total = total + cfg.chamfer_weight * cd
        logs["chamfer"] = cd

    if cfg.adv_weight > 0 and disc_model is not None:
        if timer:
            timer.lap("loss")
        img = fin["image"]
        g_loss = L.hinge_g_loss(disc_model(img.flatten(0, 1)))
        w_adapt = 1.0
        if cfg.adaptive_adv:
            # `calculate_adaptive_weight` (`dnnlib/util.py:41`):
            # ‖∇rec‖ / (‖∇adv‖ + 1e-4) clipped to [0, 1e4], without
            # gradient; as in the JAX package, the gradients are taken
            # with respect to the finest gaussians, not the decoder's last
            # layer. Both run back through the step's own finest render
            # (its graph retained): the JAX package renders a detached
            # copy again, which gives the same numbers, since the forward
            # is deterministic, for one render more. `autograd.grad` with
            # these inputs leaves every parameter's `.grad` untouched.
            rec = cfg.l1_weight * L.l1(img, _resize_to(
                batch["images_sup"], cfg.lod_resolutions[n_lod - 1]))
            g_rec, = torch.autograd.grad(rec, lods[-1], retain_graph=True)
            g_adv, = torch.autograd.grad(g_loss, lods[-1],
                                         retain_graph=True)
            # on a mesh each slice's mean carries n_data times its share
            # of the global mean's gradient: the global norms are the
            # group's root sums of squares over n_data
            _, n_data, _ = _data_axis(mesh)
            if n_data > 1:
                norms = torch.sqrt(all_reduce_(torch.stack(
                    [(g_rec ** 2).sum(), (g_adv ** 2).sum()]),
                    data_group)) / n_data
            else:
                norms = (torch.linalg.vector_norm(g_rec),
                         torch.linalg.vector_norm(g_adv))
            w_adapt = torch.clamp(norms[0] / (norms[1] + 1e-4),
                                  0.0, 1e4).detach()
            logs["adaptive_w"] = w_adapt
        total = total + cfg.adv_weight * float(step >= cfg.adv_start_step) \
            * w_adapt * g_loss
        logs["g_loss"] = g_loss
        if timer:
            timer.lap("adversarial")

    logs["total"] = total
    if timer:
        timer.lap("loss")
    return total, (logs, renders, lods)


# logs of `vae_loss_fn` that are equal on every rank of a mesh
REPLICATED_LOGS = ("opacity_p95", "scale_max", "adaptive_w")


def _gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch of a (detached) tensor whose leading dimension is
    the rank's data slice: each rank writes its slice into zeros and the
    data group sums them."""
    idx, n_data, group = _data_axis(mesh)
    if n_data == 1:
        return x
    b = x.shape[0]
    full = x.new_zeros((b * n_data,) + tuple(x.shape[1:]))
    full[idx * b:(idx + 1) * b] = x
    return all_reduce_(full, group)


def _loss_and_grads(model, state: TrainState, batch, cfg: VAELossConfig,
                    generator, draws, perceptual_net, disc_model, timer,
                    mesh=None):
    """The loss's logs (detached) and its gradient for every entry of
    `state.params` (zeros where the loss does not reach), this rank's."""
    total, (logs, _, _) = vae_loss_fn(
        model, batch, state.step, cfg, generator=generator, draws=draws,
        perceptual_net=perceptual_net, timer=timer, disc_model=disc_model,
        mesh=mesh)
    names = list(state.params)
    grads = torch.autograd.grad(total, [state.params[k] for k in names],
                                allow_unused=True)
    grads = {k: torch.zeros_like(state.params[k]) if g is None else g
             for k, g in zip(names, grads)}
    if timer:
        timer.lap("backward")
    logs = {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
            for k, v in logs.items()}
    return logs, grads


def _data_means(logs, grads, mesh):
    """The logs and gradients as the data group's means (one flat
    all_reduce of the gradients); unchanged without a mesh."""
    _, _, group = _data_axis(mesh)
    average_(grads, group)
    return mean_scalars(logs, group, skip=REPLICATED_LOGS), grads


def make_train_step(model, cfg: VAELossConfig,
                    tx_cfg: Optional[TrainStateConfig] = None,
                    perceptual_net=None, disc_model=None,
                    mesh=None) -> Callable:
    """Returns train_step(state, batch, generator=None, draws=None,
    timer=None) → logs (detached scalars, `grad_norm` among them): loss,
    gradients, the optimiser and EMA updates of `state` (in place).
    `perceptual_net` and `disc_model` as for `vae_loss_fn`; the
    discriminator's parameters are read as they are at each call. `mesh`:
    a `parallel.mesh.Mesh`, `batch` the global batch, of which the step
    keeps the rank's data slice (`shard_batch`); the gradients and logs are
    the data group's means (the all_reduce in the timer's "optimizer"
    stage), so every rank takes the same update as an unsharded step on the
    global batch."""
    tx_cfg = tx_cfg or TrainStateConfig()

    def train_step(state: TrainState, batch, generator=None, draws=None,
                   timer: Optional[StageTimer] = None):
        if timer:
            timer.start()
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        logs, grads = _data_means(*_loss_and_grads(
            model, state, batch, cfg, generator, draws, perceptual_net,
            disc_model, timer, mesh), mesh)
        logs["grad_norm"] = global_norm(grads)
        state.apply_gradients(grads, tx_cfg)
        if timer:
            timer.lap("optimizer")
        return logs

    return train_step


def make_disc_step(model, disc_model, cfg: VAELossConfig,
                   tx_cfg: Optional[TrainStateConfig] = None,
                   mesh=None) -> Callable:
    """Returns disc_step(disc_state, batch, generator=None, draws=None) →
    {"d_loss"}: the hinge loss of `disc_model` on the supervision images
    (resized to the finest LoD's resolution) against the finest render of
    the model's reconstruction, then one optimiser and EMA update of
    `disc_state` (in place; `nsr/train_nv_util.py:2877-3014`). The model's
    forward and the render run without gradient (the forward-only kernel on
    the card). draws: optional {"noise"}, else drawn from `generator`.
    `mesh`: as for `make_train_step` (the noise the global batch's, the
    gradients and `d_loss` the data group's means); the render is not
    banded, as in the JAX package."""
    tx_cfg = tx_cfg or TrainStateConfig()

    def disc_step(disc_state: TrainState, batch, generator=None,
                  draws=None):
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        res = cfg.lod_resolutions[-1]
        with torch.no_grad():
            out = model(batch["images_in"], batch["pcd"],
                        noise=_noise(model, batch, generator, draws, mesh))
            bg = torch.ones(3, dtype=torch.float32,
                            device=batch["images_in"].device)
            fin = render_lods(out["lods"][-1:], batch["cam_view"],
                              batch["cam_view_proj"], bg, [res])[0]
            fake = fin["image"].flatten(0, 1)
            real = _resize_to(batch["images_sup"], res).flatten(0, 1)
        d_loss = L.hinge_d_loss(disc_model(real), disc_model(fake))
        names = list(disc_state.params)
        grads = dict(zip(names, torch.autograd.grad(
            d_loss, [disc_state.params[k] for k in names])))
        _, _, group = _data_axis(mesh)
        disc_state.apply_gradients(average_(grads, group), tx_cfg)
        return mean_scalars({"d_loss": d_loss.detach()}, group)

    return disc_step


def _micro_slice(x, i: int, n_micro: int):
    """Slice i of n_micro along the leading dimension of a tensor with
    one; anything else (a 0-dim tensor, a scalar) passes whole."""
    if not torch.is_tensor(x) or x.dim() == 0:
        return x
    if x.shape[0] % n_micro:
        raise ValueError(f"a leading dimension of {x.shape[0]} does not "
                         f"split into {n_micro} micro-batches")
    m = x.shape[0] // n_micro
    return x[i * m:(i + 1) * m]


def make_accum_train_step(model, cfg: VAELossConfig, n_micro: int,
                          tx_cfg: Optional[TrainStateConfig] = None,
                          perceptual_net=None, disc_model=None,
                          mesh=None) -> Callable:
    """Gradient accumulation (the reference's micro-batch loop,
    `nsr/train_util.py:95`): the gradients of `n_micro` sequential slices
    of the batch's leading dimension, summed and divided by `n_micro`, then
    ONE optimiser step. Returns train_step(state, batch, generator=None,
    draws=None, timer=None) → logs, each the mean over the micro-batches,
    and `grad_norm` that of the averaged gradient. draws: optional list of
    one draws dict per micro-batch (the JAX package draws micro-batch i
    from `fold_in(rng, i)`). Peak memory is one micro-batch's. `mesh`: as
    for `make_train_step`, the step keeping the global batch's rows that
    `shard_batch(mesh, batch, micro=n_micro)` gives the rank: its
    micro-batch i is its slice of the global micro-batch i, whose noise
    it draws and whose depth-loss sums and `opacity_p95` it takes over
    the data group, so the step equals the unsharded one on the global
    batch."""
    tx_cfg = tx_cfg or TrainStateConfig()

    def train_step(state: TrainState, batch, generator=None, draws=None,
                   timer: Optional[StageTimer] = None):
        if timer:
            timer.start()
        if mesh is not None:
            batch = shard_batch(mesh, batch, micro=n_micro)
        acc, all_logs = None, []
        for i in range(n_micro):
            sub = {k: _micro_slice(v, i, n_micro) for k, v in batch.items()}
            logs, grads = _loss_and_grads(
                model, state, sub, cfg, generator,
                draws[i] if draws else None, perceptual_net, disc_model,
                timer, mesh)
            all_logs.append(logs)
            acc = grads if acc is None else {k: acc[k] + g
                                            for k, g in grads.items()}
        grads = {k: g / n_micro for k, g in acc.items()}
        logs, grads = _data_means(
            {k: torch.stack([lg[k] for lg in all_logs]).mean()
             for k in all_logs[0]}, grads, mesh)
        logs["grad_norm"] = global_norm(grads)
        state.apply_gradients(grads, tx_cfg)
        if timer:
            timer.lap("optimizer")
        return logs

    return train_step
