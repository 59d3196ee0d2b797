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
CLI's `--platform`). `extract_instance` is one instance's work, from its
batch to the npz's arrays; `main`'s loop and the benchmark's extraction
driver both call it. With `--data-dir` both draw the instances through
`instances`: the next ones are read and decoded while one encodes.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Iterator, Tuple

import torch

from gaussiananything_tpu_torch.utils import profiling

# the data set's loading: instances decoded ahead, and by how many threads
PREFETCH = 3
LOAD_WORKERS = 3


def instances(ds) -> Iterator[Dict]:
    """Batches of one out of `ds` (a `data.gbuffer.MultiViewDataset`),
    in the order of `ds.batch(1)` calls, their maps decoded `PREFETCH`
    ahead by `LOAD_WORKERS` threads; close it when done."""
    return ds.iterator(1, prefetch=PREFETCH, workers=LOAD_WORKERS)


@torch.no_grad()
def extract_instance(model, batch: Dict, noise: torch.Tensor,
                     cond_size: int) -> Tuple[Dict, Dict[str, float]]:
    """One instance through `model` (a `PointVAE` with its encoder):
    `batch` is a batch of one (`images_in` (1, V, 15, H, W), `pcd`
    (1, P, 3), `images_sup` (1, V_sup, 3, H, W)); `noise` (1, K, z) is the
    KL sample's. Returns the npz's arrays in host memory (the KL sample
    `latent_normalized`, the FPS anchors `query_pcd_xyz`, the first
    supervision view resized to `cond_size`² `cond`) and `timings`, the
    host seconds of "encode" and "latent and cond", each ending in a
    device synchronise. Opens the span `ga.extract`."""
    from gaussiananything_tpu_torch.utils.image import resize
    with profiling.span("ga.extract"):
        dev = batch["images_in"].device
        timings: Dict[str, float] = {}

        def mark(label, t0):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            timings[label] = t1 - t0
            return t1

        t0 = time.perf_counter()
        dist, anchors = model.encode(batch["images_in"], batch["pcd"])
        t0 = mark("encode", t0)
        z = dist.sample(noise=noise.to(dev, dist.mean.dtype))
        cond = resize(batch["images_sup"][0, 0], (cond_size, cond_size),
                      "linear")
        arrays = {"latent_normalized": z[0].cpu().numpy(),
                  "query_pcd_xyz": anchors[0].float().cpu().numpy(),
                  "cond": cond.cpu().numpy()}
        mark("latent and cond", t0)
    return arrays, timings


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

    from gaussiananything_tpu_torch.config import preset
    from gaussiananything_tpu_torch.data.synthetic import (describe_object,
                                                           make_batch)
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.train.state import \
        restore_inference_params
    from gaussiananything_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = preset(args.preset)
    torch.manual_seed(0)
    with torch.device(dev):
        model = PointVAE.from_config(cfg.vae, with_encoder=True)
    restore_inference_params(args.ckpt, model)
    model.eval()
    os.makedirs(args.out, exist_ok=True)
    S = cfg.dit.cond_img_size

    stream = None
    if args.data_dir:
        from gaussiananything_tpu_torch.data.gbuffer import MultiViewDataset
        stream = instances(MultiViewDataset(
            args.data_dir, n_views_in=cfg.data.n_views_in, n_views_sup=1,
            n_points=cfg.data.n_points, resolution=cfg.data.resolution,
            device=dev))

    files, seconds = [], []
    K, zc = model.latent_shape
    for i in range(args.num):
        t0 = time.perf_counter()
        with torch.no_grad():
            if stream is not None:
                b = next(stream)
                caption = b["caption"][0]
            else:
                b = make_batch(seed=1000 + i, batch=1,
                               n_views_in=cfg.data.n_views_in, n_views_sup=1,
                               res=cfg.data.resolution,
                               n_pts=cfg.data.n_points, n_splats=512,
                               device=dev)
                caption = describe_object((1000 + i) * 131)
        eps = noise[i] if noise is not None else torch.randn(
            (1, K, zc), generator=torch.Generator().manual_seed(i))
        arrays, _ = extract_instance(model, b, eps, S)
        path = os.path.join(args.out, f"{i:05d}.npz")
        np.savez(path, **arrays, caption=np.str_(caption))
        files.append(path)
        seconds.append(time.perf_counter() - t0)
    if stream is not None:
        stream.close()
    print(f"wrote {args.num} latents to {args.out}", flush=True)
    return {"files": files, "seconds": seconds}


if __name__ == "__main__":
    main()
