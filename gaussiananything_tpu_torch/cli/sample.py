"""Cascaded image-to-3D sampling, the release path (port of
`gaussiananything_tpu/cli/sample.py --release`).

  stage 1: DINOv2 conditioning → 768×3 point cloud → stage1_i.ply/.glb
  stage 2: + 768×10 KL latent → VAE decode → 4 LoDs of gaussians
           → gaussians_i.ply and an 8-view 512² turntable_i.png

    python -m gaussiananything_tpu_torch.cli.sample --release --full \
        --num 1 --steps 20 --out samples/

The official checkpoints are not in the repository, so `--full` runs the
release widths on random weights made from `--seed`: the same compute.
`sample_request` is the pipeline on modules the caller built, so a test can
drive it at small widths.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import torch

from gaussiananything_tpu_torch.config import (RenderConfig, preset,
                                               release_config)
from gaussiananything_tpu_torch.models.conditioner import ImageConditioner
from gaussiananything_tpu_torch.models.dit import (PointDiT,
                                                   stage1_dit_release,
                                                   stage2_dit_release)
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.render.renderer import render_multiview
from gaussiananything_tpu_torch.train.fm_trainer import (FMConfig, XYZ_SCALE,
                                                         make_sampler)
from gaussiananything_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ReleaseModels:
    cond: ImageConditioner
    dit1: PointDiT
    dit2: PointDiT
    vae: PointVAE


def build_release_models(cfg, device, seed: int) -> ReleaseModels:
    """The release-width modules of `cfg` on `device`, with random weights
    made from `seed`."""
    torch.manual_seed(seed)
    kw = dict(width=cfg.dit.cond_width, depth=cfg.dit.cond_depth,
              heads=cfg.dit.cond_heads)
    with torch.device(device):
        models = ReleaseModels(
            cond=ImageConditioner(img_size=cfg.dit.cond_img_size, **kw),
            dit1=stage1_dit_release(),
            dit2=stage2_dit_release(),
            vae=PointVAE.from_config(cfg.vae))
    for m in dataclasses.astuple(models):
        m.eval()
    return models


def demo_condition_image(img_size: int, device) -> torch.Tensor:
    """The demo conditioning: a procedural object rendered at 512² and
    resized to `img_size` → (1, 3, img_size, img_size)."""
    from gaussiananything_tpu_torch.data.synthetic import (make_object,
                                                           render_scene_views)
    obj = make_object(7, n=512, device=device)
    pose = cameras.generate_input_camera(1.8, [(20, 30)])
    return render_scene_views(obj, pose, img_size)["image"][:1]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def sample_request(models: ReleaseModels, cond_img: torch.Tensor,
                   fm1: FMConfig, fm2: FMConfig, render: RenderConfig,
                   generator: Optional[torch.Generator] = None,
                   x0_stage1: Optional[torch.Tensor] = None,
                   x0_stage2: Optional[torch.Tensor] = None,
                   log: Callable[[str], None] = print) -> Dict:
    """One image-to-3D request: stage 1 → stage 2 → VAE decode → 8-view
    turntable. The noise is `x0_stage*` when given, else drawn from
    `generator`. Returns xyz_n (1,K,3) normalised stage-1 sample, xyz (K,3)
    world points, kl (1,K,z), lods, the turntable maps and per-stage
    seconds under `timings`."""
    dev = cond_img.device
    timings: Dict[str, float] = {}

    def mark(label, t0):
        _sync(dev)
        t1 = time.perf_counter()
        timings[label] = t1 - t0
        log(f"    [t] {label}: {t1 - t0:.2f}s")
        return t1

    K = models.vae.decoder["vit_decoder"].pos_embed.shape[1]
    zc = models.dit2.in_channels
    t0 = time.perf_counter()
    xyz_n = make_sampler(models.dit1, models.cond, fm1, (K, 3))(
        cond_img, generator, x0=x0_stage1)
    t0 = mark("stage-1 sample", t0)
    # clip to the scene extent before the stage-2 conditioning and export
    # (`flow_matching_trainer.py:2131-2145`); the release stage 2 is
    # conditioned on xyz / 0.45 (PCD_Scaler, `modules.py:1746-1768`)
    xyz = torch.clamp(xyz_n[0] * XYZ_SCALE, -0.45, 0.45)
    kl = make_sampler(models.dit2, models.cond, fm2, (K, zc))(
        cond_img, generator, xyz=xyz[None] / 0.45, x0=x0_stage2)
    t0 = mark("stage-2 sample", t0)
    lods = models.vae.decode(kl, xyz[None])
    t0 = mark("VAE cascade decode", t0)
    sweep = cameras.uni_mesh_path(8)[:8]
    cam = cameras.pose_to_gs_camera(sweep, device=dev)
    out = render_multiview(
        lods[-1], cam["cam_view"][None], cam["cam_view_proj"][None],
        torch.ones((1, 8, 3), device=dev), render.output_size, tile=16,
        max_per_tile=render.max_per_tile, chunk=render.chunk)
    mark("8-view turntable render", t0)
    return {"xyz_n": xyz_n, "xyz": xyz, "kl": kl, "lods": lods,
            "render": out, "timings": timings}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--release", action="store_true",
                   help="release widths: DINOv2@518, CLAY-L DiTs, the "
                        "release VAE decoder, 512² rendering")
    p.add_argument("--full", action="store_true",
                   help="run stage 2, the VAE decode and the render on "
                        "random weights made from --seed")
    p.add_argument("--out", default="samples")
    p.add_argument("--num", type=int, default=1)
    p.add_argument("--cfg-scale", type=float, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not (args.release and args.full):
        p.error("the port runs the --release --full path only")

    from gaussiananything_tpu_torch.render.ply_io import (save_2dgs_ply,
                                                          save_pointcloud_glb,
                                                          save_pointcloud_ply)
    from gaussiananything_tpu_torch.utils.image import save_png

    dev = resolve_device(args.device)
    # the JAX CLI's default preset under --release: release widths, and
    # the preset's transport (Heun, 20 steps, CFG 4.5)
    cfg = release_config(preset("demo-e2e"))
    fm1 = FMConfig(stage=1, cfg_scale=(args.cfg_scale if args.cfg_scale
                                       is not None
                                       else cfg.transport.cfg_scale),
                   num_steps=(args.steps if args.steps is not None
                              else cfg.transport.num_steps),
                   sampler=cfg.transport.sampler)
    fm2 = dataclasses.replace(fm1, stage=2)
    os.makedirs(args.out, exist_ok=True)
    models = build_release_models(cfg, dev, args.seed)
    cond_img = demo_condition_image(cfg.dit.cond_img_size, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    results = []
    for i in range(args.num):
        res = sample_request(models, cond_img, fm1, fm2, cfg.render, gen)
        xyz = res["xyz"].cpu().numpy()
        save_pointcloud_ply(os.path.join(args.out, f"stage1_{i}.ply"), xyz)
        save_pointcloud_glb(os.path.join(args.out, f"stage1_{i}.glb"), xyz)
        print(f"[{i}] stage-1 point cloud: {xyz.shape} "
              f"range {xyz.min():.3f}..{xyz.max():.3f}", flush=True)
        save_2dgs_ply(os.path.join(args.out, f"gaussians_{i}.ply"),
                      res["lods"][-1][0].cpu().numpy())
        strip = torch.cat(list(res["render"]["image"][0]), dim=-1)
        save_png(os.path.join(args.out, f"turntable_{i}.png"),
                 (strip.clamp(0, 1) * 255).to(torch.uint8)
                 .permute(1, 2, 0).cpu().numpy())
        results.append(res)
    print("done", flush=True)
    return results


if __name__ == "__main__":
    main()
