"""Cascaded image-to-3D / text-to-3D sampling (port of
`gaussiananything_tpu/cli/sample.py`).

  stage 1: image or text conditioning → 768×3 point cloud
           → stage1_i.ply/.glb
  stage 2: + KL latent → VAE decode → 4 LoDs of gaussians → gaussians_i.ply,
           an 8-view turntable_i.png and, with --mesh, mesh_i.glb (TSDF
           at 176³ over a 50-view 256² sweep, surface nets)

    python -m gaussiananything_tpu_torch.cli.sample --release --full \\
        [--text "a chair" [--bpe-vocab V] | --image-dir D] [--bf16] [--mesh] \\
        --num 1 --steps 20 --out samples/

Checkpoints (`--stage1-ckpt` …) are npz files in the JAX package's layout
(what `cli/import_release` writes) or directories of this package's
training checkpoints (their EMA weights); the JAX trainer's Orbax
checkpoints need JAX and are not read. Without checkpoints the modules keep
random weights made from `--seed`: the same compute. Stage 2 runs with
`--full` or a stage-2/VAE checkpoint. `sample_request` is the pipeline on
modules the caller built, so a test can drive it at small widths.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from gaussiananything_tpu_torch.config import (RenderConfig, compute_dtype,
                                               preset, release_config)
from gaussiananything_tpu_torch.models.dit import PointDiT
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.render.renderer import render_multiview
from gaussiananything_tpu_torch.train.fm_trainer import (FMConfig, XYZ_SCALE,
                                                         make_sampler)
from gaussiananything_tpu_torch.utils import profiling
from gaussiananything_tpu_torch.utils.device import resolve_device

# --mesh: 176³ is the reference's voxel = radius/160 over the
# [-0.45, 0.45]³ × 1.1 box (`nsr/lsgm/flow_matching_trainer.py:1338-1343`),
# over `uni_mesh_path(10)`: 10 azimuths at 5 elevations, 50 views at 256²
# (`render/tsdf.export_mesh_from_gaussians`)
MESH = dict(resolution=176, n_views=10, render_size=256)


@dataclasses.dataclass
class ReleaseModels:
    """The cascade's modules. `dit2`/`vae` None: stage 1 only. `cond2`:
    stage 2's own conditioner (default `cond`). The release stage 2 is
    conditioned on xyz / 0.45 (PCD_Scaler); the JAX package's own presets
    on xyz (`xyz_cond_scale` 1). `latent_num` defaults to the VAE's."""
    cond: nn.Module
    dit1: PointDiT
    dit2: Optional[PointDiT] = None
    vae: Optional[PointVAE] = None
    cond2: Optional[nn.Module] = None
    xyz_cond_scale: float = 0.45
    latent_num: Optional[int] = None


def demo_condition_image(img_size: int, device) -> torch.Tensor:
    """The demo conditioning: a procedural object rendered at the nearest
    multiple of 16 and resized to `img_size` → (1, 3, img_size, img_size)."""
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
                   log: Callable[[str], None] = print,
                   mesh: Optional[Dict] = None) -> Dict:
    """One request: stage 1 → (with `models.dit2`) stage 2 → VAE decode →
    8-view turntable → (with `mesh`, the keyword arguments of
    `render.tsdf.mesh_from_gaussians`, as `MESH`) the mesh.

    `cond_img` is the conditioner's input: images (1, 3, H, W) or token
    ids (1, L). The noise is `x0_stage*` when given, else drawn from
    `generator`. Returns xyz_n (1,K,3) normalised stage-1 sample, xyz (K,3)
    world points, per-stage seconds under `timings` and, with stage 2, kl
    (1,K,z), lods, the turntable maps under `render` and the mesh (verts,
    faces, vertex colors) under `mesh`."""
    with profiling.span(profiling.REQUEST):
        dev = cond_img.device
        timings: Dict[str, float] = {}

        def mark(label, t0):
            _sync(dev)
            t1 = time.perf_counter()
            timings[label] = t1 - t0
            log(f"    [t] {label}: {t1 - t0:.2f}s")
            return t1

        K = models.latent_num or \
            models.vae.decoder["vit_decoder"].pos_embed.shape[1]
        t0 = time.perf_counter()
        with profiling.span("ga.stage1"):
            xyz_n = make_sampler(models.dit1, models.cond, fm1, (K, 3))(
                cond_img, generator, x0=x0_stage1)
            t0 = mark("stage-1 sample", t0)
        # clip to the scene extent before the stage-2 conditioning and
        # export (`flow_matching_trainer.py:2131-2145`)
        xyz = torch.clamp(xyz_n[0] * XYZ_SCALE, -0.45, 0.45)
        out = {"xyz_n": xyz_n, "xyz": xyz, "timings": timings}
        if models.dit2 is None:
            return out
        zc = models.dit2.in_channels
        with profiling.span("ga.stage2"):
            kl = make_sampler(models.dit2, models.cond2 or models.cond, fm2,
                              (K, zc))(cond_img, generator,
                                       xyz=xyz[None] / models.xyz_cond_scale,
                                       x0=x0_stage2)
            t0 = mark("stage-2 sample", t0)
        with profiling.span("ga.decode"):
            lods = models.vae.decode(kl, xyz[None])
            t0 = mark("VAE cascade decode", t0)
        with profiling.span("ga.render"):
            sweep = cameras.uni_mesh_path(8)[:8]
            cam = cameras.pose_to_gs_camera(sweep, device=dev)
            out["render"] = render_multiview(
                lods[-1], cam["cam_view"][None], cam["cam_view_proj"][None],
                torch.ones((1, 8, 3), device=dev), render.output_size,
                tile=16, max_per_tile=render.max_per_tile,
                chunk=render.chunk)
            t0 = mark("8-view turntable render", t0)
        out.update(kl=kl, lods=lods)
        if mesh is not None:
            from gaussiananything_tpu_torch.render.tsdf import \
                mesh_from_gaussians
            out["mesh"] = mesh_from_gaussians(lods[-1][0], timings=timings,
                                              **mesh)
            for k in ("mesh render", "mesh integrate", "mesh surface nets"):
                log(f"    [t] {k}: {timings[k]:.2f}s")
            mark("TSDF fuse + surface nets", t0)
        return out


def build_models(args, cfg, device) -> ReleaseModels:
    """The modules `args` asks for, on `device`: random weights from
    `args.seed`, then the checkpoints."""
    from gaussiananything_tpu_torch.models import dit as dits
    from gaussiananything_tpu_torch.models.conditioner import (
        ImageConditioner, TextConditioner)
    from gaussiananything_tpu_torch.train.state import \
        restore_inference_params as restore
    dtype = torch.bfloat16 if args.bf16 \
        else compute_dtype(cfg.dit.compute_dtype)
    vae_dtype = torch.bfloat16 if args.bf16 \
        else compute_dtype(cfg.vae.compute_dtype)
    t23d = args.text is not None
    wd = dict(cond_dim=cfg.dit.cond_width, vector_dim=cfg.dit.cond_width,
              dtype=dtype)
    torch.manual_seed(args.seed)
    with torch.device(device):
        if t23d and args.release:
            # the OpenCLIP ViT-L/14 text tower (width 768)
            cond = TextConditioner(width=768, depth=12, heads=12,
                                   backbone="openclip", dtype=dtype)
        elif t23d:
            cond = TextConditioner(width=cfg.dit.cond_width,
                                   depth=cfg.dit.cond_depth,
                                   heads=cfg.dit.cond_heads, dtype=dtype)
        else:
            cond = ImageConditioner(
                width=cfg.dit.cond_width, depth=cfg.dit.cond_depth,
                heads=cfg.dit.cond_heads, img_size=cfg.dit.cond_img_size,
                backbone="dinov2" if args.release else "scratch",
                dtype=dtype)
        if args.release:
            dit1 = (dits.t23d_stage1_dit_release if t23d
                    else dits.stage1_dit_release)(dtype=dtype)
        else:
            dit1 = dits.stage1_dit(cfg.dit.size, **wd)
        models = ReleaseModels(cond=cond, dit1=dit1,
                               xyz_cond_scale=0.45 if args.release else 1.0,
                               latent_num=cfg.vae.latent_num)
        if args.stage2_ckpt or args.vae_ckpt or args.full:
            if args.release:
                models.dit2 = (dits.t23d_stage2_dit_release if t23d
                               else dits.stage2_dit_release)(dtype=dtype)
            else:
                models.dit2 = dits.stage2_dit(
                    cfg.dit.size, z_channels=cfg.vae.z_channels, **wd)
            models.vae = PointVAE.from_config(cfg.vae, dtype=vae_dtype)
    restore(args.stage1_ckpt, models.dit1)
    restore(args.stage1_cond_ckpt, models.cond)
    if models.dit2 is not None:
        restore(args.stage2_ckpt, models.dit2)
        restore(args.vae_ckpt, models.vae)
        if args.stage2_cond_ckpt:
            models.cond2 = restore(args.stage2_cond_ckpt,
                                   copy.deepcopy(models.cond))
    for f in dataclasses.fields(models):
        m = getattr(models, f.name)     # (`astuple` would deep-copy them)
        if isinstance(m, nn.Module):
            m.eval()
            if args.bf16:
                # sampling only: the parameters themselves go to bf16 once
                # restored, as the JAX CLI's `_cast` does; the modules
                # compute in bf16 either way, the norms in fp32 from the
                # rounded weights
                m.to(torch.bfloat16)
    return models


def condition_input(args, cfg, device) -> torch.Tensor:
    """What the conditioner reads: token ids (1, 77) for --text, else the
    first image of --image-dir or the demo render (1, 3, S, S)."""
    if args.text is not None:
        from gaussiananything_tpu_torch.models.conditioner import \
            tokenize_bytes
        if args.release and args.bpe_vocab:
            from gaussiananything_tpu_torch.models.openclip_text import \
                ClipBPETokenizer
            ids = ClipBPETokenizer(args.bpe_vocab)([args.text])
        else:
            if args.release:
                print("WARNING: --release --text without --bpe-vocab falls "
                      "back to byte tokens; pass the open_clip "
                      "bpe_simple_vocab_16e6.txt.gz for checkpoint parity",
                      flush=True)
            ids = tokenize_bytes([args.text])
        return torch.from_numpy(ids).long().to(device)
    if args.image_dir:
        from gaussiananything_tpu_torch.data.real import RealImageDataset
        ds = RealImageDataset(args.image_dir, img_size=cfg.dit.cond_img_size)
        return torch.from_numpy(ds[0])[None].to(device)
    return demo_condition_image(cfg.dit.cond_img_size, device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="demo-e2e")
    p.add_argument("--release", action="store_true",
                   help="release widths: DINOv2@518 (or the OpenCLIP text "
                        "tower with --text), CLAY-L (t23d: DiT-PCD-L) DiTs, "
                        "the release VAE decoder, 512² rendering")
    ckpt = ("an npz in the JAX package's layout (cli/import_release) or a "
            "directory of this package's training checkpoints (EMA); "
            "Orbax checkpoints of the JAX trainer are not read")
    p.add_argument("--stage1-ckpt", default=None, help=ckpt)
    p.add_argument("--stage1-cond-ckpt", default=None,
                   help="conditioner weights: " + ckpt)
    p.add_argument("--stage2-ckpt", default=None, help=ckpt)
    p.add_argument("--stage2-cond-ckpt", default=None,
                   help="stage 2's own conditioner: " + ckpt)
    p.add_argument("--vae-ckpt", default=None, help=ckpt)
    p.add_argument("--out", default="samples")
    p.add_argument("--num", type=int, default=1)
    p.add_argument("--cfg-scale", type=float, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh", action="store_true",
                   help="TSDF mesh export (with stage 2)")
    p.add_argument("--full", action="store_true",
                   help="run stage 2, the VAE decode and the render without "
                        "checkpoints (random weights from --seed)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 inference: DiT, conditioner and VAE "
                        "decoder compute in bf16 and their restored weights "
                        "are cast to bf16; norms and softmax in fp32; the "
                        "gaussians the rasterizer reads stay fp32")
    p.add_argument("--image-dir", default=None,
                   help="folder of real conditioning images (i23d); the "
                        "first serves every request")
    p.add_argument("--text", default=None,
                   help="text prompt (t23d: the text conditioner)")
    p.add_argument("--bpe-vocab", default=None,
                   help="open_clip bpe_simple_vocab_16e6.txt.gz, for the "
                        "tokenizer of the released t23d checkpoints "
                        "(--release --text)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)

    from gaussiananything_tpu_torch.render.ply_io import (save_2dgs_ply,
                                                          save_pointcloud_glb,
                                                          save_pointcloud_ply)
    from gaussiananything_tpu_torch.render.tsdf import write_mesh
    from gaussiananything_tpu_torch.utils.image import save_png

    cfg = preset(args.preset)
    if args.release:
        cfg = release_config(cfg)
    fm1 = FMConfig(stage=1, cfg_scale=(args.cfg_scale if args.cfg_scale
                                       is not None
                                       else cfg.transport.cfg_scale),
                   num_steps=(args.steps if args.steps is not None
                              else cfg.transport.num_steps),
                   sampler=cfg.transport.sampler)
    fm2 = dataclasses.replace(fm1, stage=2)
    os.makedirs(args.out, exist_ok=True)
    models = build_models(args, cfg, dev)
    cond_in = condition_input(args, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    results = []
    for i in range(args.num):
        res = sample_request(models, cond_in, fm1, fm2, cfg.render, gen,
                             mesh=MESH if args.mesh else None)
        xyz = res["xyz"].cpu().numpy()
        save_pointcloud_ply(os.path.join(args.out, f"stage1_{i}.ply"), xyz)
        save_pointcloud_glb(os.path.join(args.out, f"stage1_{i}.glb"), xyz)
        print(f"[{i}] stage-1 point cloud: {xyz.shape} "
              f"range {xyz.min():.3f}..{xyz.max():.3f}", flush=True)
        if "lods" in res:
            save_2dgs_ply(os.path.join(args.out, f"gaussians_{i}.ply"),
                          res["lods"][-1][0].cpu().numpy())
            strip = torch.cat(list(res["render"]["image"][0]), dim=-1)
            save_png(os.path.join(args.out, f"turntable_{i}.png"),
                     (strip.clamp(0, 1) * 255).to(torch.uint8)
                     .permute(1, 2, 0).cpu().numpy())
        if "mesh" in res:
            write_mesh(os.path.join(args.out, f"mesh_{i}.glb"), *res["mesh"])
        results.append(res)
    print("done", flush=True)
    return results


if __name__ == "__main__":
    main()
