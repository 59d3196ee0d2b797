"""Extract the generator's training latents with a VAE (port of
`gaussiananything_tpu/cli/extract_latents.py`; the reference's
`scripts/save_pcd.py` and `eval_novelview_loop(save_latent=True)`,
`nsr/train_nv_util.py:2693`):

    python -m gaussiananything_tpu_torch.cli.extract_latents \\
        --preset vae-release [--ckpt CKPT] [--data-dir D] --num 32 \\
        --out latents/

The encoder runs over each instance and one npz per instance is written,
in the reference's latent.npz schema plus the caption sidecar
(`datasets/g_buffer_objaverse.py:3661-3687,3771`):

    latent_normalized (K, z)     the KL sample
    query_pcd_xyz     (K, 3)     the FPS anchors (world units)
    cond              (3, S, S)  a conditioning view at cond_img_size
    caption           ()         the instance's caption ('' if none)

Instances are procedural (`make_batch(seed=1000 + i)`, the views rendered
through the rasterizer; caption `describe_object((1000 + i)·131)`) or,
with `--data-dir`, drawn from a packed g-buffer dataset (`data/gbuffer.py`;
`data/objaverse_raw.convert_raw_dir` packs raw renders). The weights are a
random draw of seed 0 unless `--ckpt` (a JAX-layout npz or this package's
checkpoint directory). The conditioning view is the first supervision view
resized with antialiased bilinear weights (`jax.image.resize(...,
"bilinear")`). Runs on the card unless `--device cpu` is given (the JAX
CLI's `--platform`).
"""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None, noise=None):
    """Writes the npz files; returns {"files", "seconds"} (the seconds of
    each instance, from its data to its written file, each ending in a
    device synchronise). `noise`: optional sequence of (1, K, z) tensors,
    the KL sample's noise of instance i (the tests hand over the JAX
    package's `fold_in(PRNGKey(0), i)` draws); drawn from a generator
    seeded by i otherwise."""
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--ckpt", default=None,
                   help="VAE weights: a JAX-layout npz or this package's "
                        "checkpoint directory (omit for random weights)")
    p.add_argument("--preset", default="demo-e2e")
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, default=32)
    p.add_argument("--data-dir", default=None,
                   help="packed g-buffer npz dataset (data/gbuffer.py); "
                        "procedural scenes otherwise")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from gaussiananything_tpu_torch.config import preset
    from gaussiananything_tpu_torch.data.synthetic import (describe_object,
                                                           make_batch)
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.train.state import \
        restore_inference_params
    from gaussiananything_tpu_torch.utils.device import resolve_device
    from gaussiananything_tpu_torch.utils.image import resize

    dev = resolve_device(args.device)
    cfg = preset(args.preset)
    torch.manual_seed(0)
    with torch.device(dev):
        model = PointVAE.from_config(cfg.vae, with_encoder=True)
    restore_inference_params(args.ckpt, model)
    model.eval()
    os.makedirs(args.out, exist_ok=True)
    S = cfg.dit.cond_img_size

    ds = None
    if args.data_dir:
        from gaussiananything_tpu_torch.data.gbuffer import MultiViewDataset
        ds = MultiViewDataset(args.data_dir, n_views_in=cfg.data.n_views_in,
                              n_views_sup=1, n_points=cfg.data.n_points,
                              resolution=cfg.data.resolution, device=dev)

    files, seconds = [], []
    for i in range(args.num):
        t0 = time.perf_counter()
        with torch.no_grad():
            if ds is not None:
                b = ds.batch(1)
                caption = b["caption"][0]
            else:
                b = make_batch(seed=1000 + i, batch=1,
                               n_views_in=cfg.data.n_views_in, n_views_sup=1,
                               res=cfg.data.resolution,
                               n_pts=cfg.data.n_points, n_splats=512,
                               device=dev)
                caption = describe_object((1000 + i) * 131)
            dist, anchors = model.encode(b["images_in"], b["pcd"])
            eps = noise[i] if noise is not None else torch.randn(
                dist.mean.shape, generator=torch.Generator().manual_seed(i))
            z = dist.sample(noise=eps.to(dev, dist.mean.dtype))
            cond = resize(b["images_sup"][0, 0], (S, S), "linear")
        path = os.path.join(args.out, f"{i:05d}.npz")
        np.savez(path, latent_normalized=z[0].cpu().numpy(),
                 query_pcd_xyz=anchors[0].float().cpu().numpy(),
                 cond=cond.cpu().numpy(), caption=np.str_(caption))
        files.append(path)
        seconds.append(time.perf_counter() - t0)
    print(f"wrote {args.num} latents to {args.out}", flush=True)
    return {"files": files, "seconds": seconds}


if __name__ == "__main__":
    main()
