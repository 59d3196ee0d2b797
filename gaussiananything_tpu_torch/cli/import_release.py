"""Import the reference's torch checkpoints (port of
`gaussiananything_tpu/cli/import_release.py`).

Converts a released `.pt` state dict (README.md's release table:
`ckpts/vae/model_rec1965000.pt`, `checkpoints/i23d/stage-1/...`,
`checkpoints/i23d/stage-2/...`, and the frozen DINOv2 / OpenCLIP / VGG /
U²-Net towers) into the npz the port's CLIs restore
(`--vae-ckpt`, `--stage1-ckpt`, `--cond-ckpt`, `--lpips-npz`,
`--matting-ckpt`, ...): the JAX package's layout, leaf for leaf what the
JAX CLI writes for the same checkpoint.

    python -m gaussiananything_tpu_torch.cli.import_release \\
        --kind vae --ckpt ckpts/vae/model_rec1965000.pt --out vae.npz

Kinds: vae | dit-stage1 | dit-stage2 | dit-t23d-stage1 | dit-t23d-stage2
| dinov2 | clip-text | lpips-vgg | u2net; `--width`, `--depth`,
`--heads`, `--cond-dim`, `--latent-num` scale the structure (tests and
non-release sizes). Runs on the CPU; the layout is drawn from the port's
modules built on the "meta" device, so nothing of the model is allocated.
"""
from __future__ import annotations

import argparse

import numpy as np

KINDS = ["vae", "dit-stage1", "dit-stage2", "dit-t23d-stage1",
         "dit-t23d-stage2", "dinov2", "clip-text", "lpips-vgg", "u2net"]


def load_torch_checkpoint(path: str) -> dict:
    """A torch checkpoint → flat {name: float32 numpy array}, unwrapping
    the usual nestings (`state_dict` / `model` / `ema`) and DDP's
    `module.` prefix; entries that are not tensors are dropped."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "ema"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    sd = {}
    for k, v in obj.items():
        if not torch.is_tensor(v):
            continue
        if k.startswith("module."):
            k = k[len("module."):]
        sd[k] = np.asarray(v.detach().to(torch.float32).numpy())
    return sd


def template_module(kind: str, width=None, depth=None, heads=None,
                    cond_dim=None, latent_num=None):
    """The port module whose JAX layout a `kind` converts into (on the
    meta device), with the JAX CLI's structure and overrides; and the
    prefix its leaves take in the npz."""
    import torch
    with torch.device("meta"):
        if kind == "vae":
            from gaussiananything_tpu_torch.models.vae import PointVAE
            kw = {k: v for k, v in (("decoder_width", width),
                                    ("decoder_depth", depth),
                                    ("decoder_heads", heads),
                                    ("latent_num", latent_num)) if v}
            return PointVAE(encoder_width=256, release_parity=True,
                            with_encoder=True, **kw), "params/"
        if kind.startswith("dit-"):
            from gaussiananything_tpu_torch.models import dit as dit_mod
            factory = {
                "dit-stage1": dit_mod.stage1_dit_release,
                "dit-stage2": dit_mod.stage2_dit_release,
                "dit-t23d-stage1": dit_mod.t23d_stage1_dit_release,
                "dit-t23d-stage2": dit_mod.t23d_stage2_dit_release,
            }[kind]
            kw = {k: v for k, v in (("width", width), ("depth", depth),
                                    ("heads", heads)) if v}
            if cond_dim:
                kw.update(cond_dim=cond_dim, vector_dim=cond_dim)
            return factory(**kw), "params/"
        if kind == "dinov2":
            # under the ImageConditioner's submodule name, as the JAX CLI
            # nests it, so the npz restores into the conditioner
            from gaussiananything_tpu_torch.models.dinov2 import Dinov2ViT
            return Dinov2ViT(), "params/vit/"
        if kind == "clip-text":
            from gaussiananything_tpu_torch.models.openclip_text import \
                OpenClipTextTower
            return OpenClipTextTower(), "params/text/"
        if kind == "lpips-vgg":
            from gaussiananything_tpu_torch.train.losses import VGGLPIPS
            return VGGLPIPS(), "params/"
        if kind == "u2net":
            from gaussiananything_tpu_torch.models.matting import u2net
            return u2net(), "params/"
    raise ValueError(f"unknown kind {kind!r}")


def convert(kind: str, sd: dict, **structure) -> dict:
    """State dict → the flat npz tree {"params/...": float32 array}."""
    from gaussiananything_tpu_torch.utils import release_import as ri
    from gaussiananything_tpu_torch.utils.param_io import jax_layout
    module, prefix = template_module(kind, **structure)
    template = jax_layout(module)
    fn = {"vae": ri.convert_gaussiananything_vae,
          "dinov2": ri.convert_dinov2,
          "clip-text": ri.convert_openclip_text,
          "lpips-vgg": ri.convert_lpips_vgg,
          "u2net": ri.convert_u2net}.get(
        kind, ri.convert_gaussiananything_dit)
    return {prefix + k: v for k, v in fn(sd, template).items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--ckpt", required=True, help="torch .pt/.pth checkpoint")
    p.add_argument("--out", required=True, help="output .npz path")
    # scaled-structure overrides (testing / non-release sizes)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--heads", type=int, default=None)
    p.add_argument("--cond-dim", type=int, default=None)
    p.add_argument("--latent-num", type=int, default=None)
    args = p.parse_args(argv)

    flat = convert(args.kind, load_torch_checkpoint(args.ckpt),
                   width=args.width, depth=args.depth, heads=args.heads,
                   cond_dim=args.cond_dim, latent_num=args.latent_num)
    np.savez_compressed(args.out, **flat)
    n_params = sum(int(np.prod(x.shape)) for x in flat.values())
    print(f"converted {args.kind}: {n_params / 1e6:.2f}M params -> "
          f"{args.out}")
    return flat


if __name__ == "__main__":
    main()
