"""The check of latent extraction against the plain reference.

An extraction request draws one instance out of the G-buffer set, 4 input
views and 4,096 points, assembles the 15-channel encoder input, encodes
it (the SD trunk with its joint multi-view attention, farthest-point
anchors, the anchors' cross-attention, three transformer blocks, the
output and quant MLPs) and samples the KL latent with the request's noise.
The reference draws the same instance, views and points from the data
set's seed and assembles them itself (the G-buffer reader and the
assembly held apart from the program's), then encodes the inputs the
program was given (the encoder held apart from the assembly). What each
comparison reads:

  inputs    the program's 15-channel views (per channel group: rgb,
            normal, Plücker rays, xyz) and point cloud against the
            reference's own assembly of the same draw
  latent    the KL mean, the log-variance (soft-clamped) and the latent
            under the request's noise, the worst of the three, each as
            its mean absolute gap over the reference latent's mean
            magnitude (the scale of what the npz holds: the mean's and
            the log-variance's own mean magnitudes run from 0.11 to 0.56
            over seeds, and a gap over them swung with them)
  anchors   the largest |Δxyz| of the 768 anchors: the same fp32
            distances on the same points, ties to the lowest index in
            both, so any gap is a fault

each the worst over the checked requests; `inputs` as the mean error
relative to the reference's mean magnitude (`train._rel_mean`), the worst
of its parts. The latent's three parts are read too (`latent_mean`,
`latent_logvar`, `latent_z`), not compared.
"""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import nets, train
from benchmark.reference.precision import control as control_policy
from benchmark.reference.precision import ieee

GROUPS = (("rgb", 0, 3), ("normal", 3, 6), ("plucker", 6, 12),
          ("xyz", 12, 15))


def data_seed(seed: int) -> int:
    """The data set's generator's seed, from the run's."""
    return int(seed) % (2 ** 32) + 23


def build(cfg: dict, seed: int, device) -> nets.VAE:
    """The reference's VAE with the seeded weights."""
    with torch.device("meta"):
        m = nets.build("vae", cfg["vae"])
    weights.load(m, weights.make(seed, "vae", weights.leaves(m), device))
    return m.eval()


def draws(files: List[str], d: dict, seed: int, wanted) -> Dict[int, dict]:
    """The data set's draws `wanted` (0-based, in the order requests make
    them) from `seed`: per draw an instance, `n_views_in` + 1 distinct
    views (the first `n_views_in` the input) and `n_points` points, from
    one numpy generator in that order, as the program's data set draws
    them. Returns the input views' maps, poses and the points (host
    arrays) by draw."""
    rng = np.random.default_rng(seed)
    k = d["n_views_in"] + 1         # and the CLI's one supervision view
    out = {}
    for n in range(max(wanted) + 1):
        path = files[rng.integers(len(files))]
        with np.load(path) as z:
            V, P = z["pose"].shape[0], z["pcd"].shape[0]
        views = rng.choice(V, k, replace=V < k)[:d["n_views_in"]]
        pts = rng.choice(P, d["n_points"], replace=P < d["n_points"])
        if n in wanted:
            inst = train.load_instance(path)
            out[n] = {"rgb": np.moveaxis(inst["rgb"], -1, -3)[views],
                      "normal": np.moveaxis(inst["normal"], -1, -3)[views],
                      "depth": inst["depth"][views][:, None],
                      "alpha": inst["alpha"][views][:, None],
                      "pose": inst["pose"][views], "pcd": inst["pcd"][pts]}
    return out


def assemble(s: dict, device) -> Dict[str, torch.Tensor]:
    """One draw's encoder input (1, V, 15, H, W), in the world frame (the
    extraction's data set does not rebase the poses), and points."""
    t = {k: torch.from_numpy(v)[None].to(device) for k, v in s.items()}
    B, V, _, H, W = t["rgb"].shape
    pose = t["pose"]
    c2w = pose[..., :16].reshape(B, V, 4, 4)
    K = pose[..., 16:].reshape(B, V, 3, 3)
    mean = torch.tensor(train.IMAGENET_MEAN, device=device)
    std = torch.tensor(train.IMAGENET_STD, device=device)
    xyz = train._backproject(t["depth"], c2w, train._tanfov(pose[..., 16])) \
        * (t["alpha"] > 0.5)
    images = torch.cat([(t["rgb"] - mean[:, None, None]) / std[:, None, None],
                        t["normal"], train._plucker(c2w, K, H, W), xyz],
                       dim=2)
    return {"images": images, "pcd": t["pcd"]}


@torch.no_grad()
def encode(vae: nets.VAE, images, pcd, noise) -> Dict[str, torch.Tensor]:
    """The encoder, the quant MLP and the KL bottleneck of `nets.VAE`
    (its forward without the decode): the anchors, the mean, the
    soft-clamped log-variance and mean + std · noise."""
    h, anchors = vae.encoder(images, pcd)
    moments = vae.decoder["superresolution"]["quant_conv"](h).float()
    mean, logvar = moments.chunk(2, dim=-1)
    logvar = 20.0 * torch.tanh(logvar / 20.0)
    return {"anchors": anchors, "mean": mean, "logvar": logvar,
            "z": mean + torch.exp(0.5 * logvar) * noise.to(mean.device)}


def compare(vae: nets.VAE, ref_in: dict, rec: dict) -> Dict[str, float]:
    """The numbers of one recorded request (the module docstring)."""
    dev = ref_in["images"].device
    rec = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in rec.items()}
    out = {"inputs": max(
        [train._rel_mean(rec["images"][:, :, a:b], ref_in["images"][:, :, a:b])
         for _, a, b in GROUPS]
        + [train._rel_mean(rec["pcd"], ref_in["pcd"])])}
    ref = encode(vae, rec["images"], rec["pcd"], rec["noise"])
    scale = ref["z"].float().abs().mean().clamp_min(1e-30)
    for k in ("mean", "logvar", "z"):
        got = rec[k].float()
        out["latent_" + k] = float((got - ref[k].float()).abs().mean()
                                   / scale) \
            if got.shape == ref[k].shape else float("inf")
    out["latent"] = max(out["latent_" + k] for k in ("mean", "logvar",
                                                      "z"))
    a = rec["anchors"].float()
    out["anchors"] = float((a - ref["anchors"].float()).abs().max()) \
        if a.shape == ref["anchors"].shape else float("inf")
    return out


def check(cfg: dict, seed: int, files: List[str], records: List[dict],
          device, control: bool = False) -> Dict[str, float]:
    """Worst of each number over the recorded requests. Each record holds
    its data set draw (`draw`) and its noise, and, but with `control`,
    what the program's request produced (`images`, `pcd`, `anchors`,
    `mean`, `logvar`, `z`); with `control` the reference, one step lower,
    makes those itself from the same draws."""
    d = cfg["data"]
    got = draws(files, d, data_seed(seed), {r["draw"] for r in records})
    with ieee():
        vae = build(cfg, seed, device)
        if control:
            made = []
            with control_policy(cfg["precision"]["compute_dtype"]):
                for r in records:
                    ins = assemble(got[r["draw"]], device)
                    made.append(dict(r, **ins, **encode(
                        vae, ins["images"], ins["pcd"], r["noise"])))
            records = made
        per = [compare(vae, assemble(got[r["draw"]], device), r)
               for r in records]
    for r, p in zip(records, per):
        print(f"checked request (draw {r['draw']}): latent std "
              f"{float(r['z'].float().std()):.4g}, logvar mean "
              f"{float(r['logvar'].float().mean()):.4g}, "
              + ", ".join(f"{k} {v:.4g}" for k, v in p.items()),
              file=sys.stderr)
    return {k: max(p[k] for p in per) for k in per[0]}
