"""The check of an image-to-3D request against the plain reference.

A request is a cascade: the conditioner's tokens, stage 1's Heun steps
(the point cloud), stage 2's Heun steps (the latent, conditioned on stage
1's points), the VAE decode into four LoDs of gaussians, the 8-view
turntable. The reference follows the program stage by stage from the
program's own state (each Heun step from the program's x_k, the decode
from the program's latent, the render from the program's gaussians): a
whole cascade run twice diverges by its nature, since the sampler
amplifies any rounding. What each comparison reads:

  cond_tokens   the tokens and the pooled vector from the image
  velocity      each step's Euler half, x_k + dt·v(x_k), CFG-combined
  heun_update   each step's update x_k → x_k+1
  decode        each LoD's gaussians, per channel group
  render        the turntable's image, alpha, depth and normal maps

each the largest over the request's stages, steps, LoDs, channel groups
or maps: the first three the largest error relative to the largest value
of the reference's (its step's increment for the two sampler numbers),
the last two the mean error relative to the reference's mean magnitude
(a widest gap over 73,728 surfels is set by the few whose quaternion is
near zero, and the control's reading overlaps a sound run's).
"""
from __future__ import annotations

import sys
from typing import Dict, List

import torch

from benchmark import weights
from benchmark.reference import nets, raster
from benchmark.reference.precision import control as control_policy
from benchmark.reference.precision import ieee

XYZ_SCALE = 0.164   # stage 1's point cloud to world units
XYZ_COND = 0.45     # stage 2's conditioning scale
CHANNELS = ((0, 3), (3, 4), (4, 6), (6, 10), (10, 13))
MAPS = ("image", "alpha", "depth", "rend_normal")


def build(cfg: dict, seed: int, device) -> Dict[str, torch.nn.Module]:
    """The reference's modules with the seeded weights."""
    parts = {"cond": ("conditioner", cfg["conditioner"]),
             "dit1": ("dit", cfg["dit1"]), "dit2": ("dit", cfg["dit2"]),
             "vae": ("vae_decoder", cfg["vae"])}
    out = {}
    for tag, (kind, c) in parts.items():
        with torch.device("meta"):
            m = nets.build(kind, c)
        weights.load(m, weights.make(seed, tag, weights.leaves(m), device))
        out[tag] = m.eval()
    return out


def schedule(num_steps: int, device) -> torch.Tensor:
    return torch.arange(num_steps, dtype=torch.float32, device=device) \
        * (1.0 / num_steps)


def stage_xyz(final1: torch.Tensor) -> torch.Tensor:
    """Stage 1's sample → world points, clipped to the scene."""
    return torch.clamp(final1[0] * XYZ_SCALE, -XYZ_COND, XYZ_COND)[None]


def cameras(cfg: dict, device):
    c2w, focal = raster.orbit_poses(cfg["render"]["turntable_views"])
    return raster.cameras(c2w, focal, device)


def render(cfg: dict, gaussians: torch.Tensor, cams):
    r = cfg["render"]
    return raster.render_views(gaussians, cams, r["output_size"], r["tile"],
                               r["max_per_tile"], r["chunk"])


@torch.no_grad()
def request(cfg: dict, ref: Dict[str, torch.nn.Module], image, x0_1, x0_2
            ) -> dict:
    """The whole cascade through the reference, recorded as the program's
    requests are: the control runs this under its lower precision."""
    s = cfg["sampler"]
    tokens, vector = ref["cond"](image)
    rec = {"image": image, "tokens": tokens, "vector": vector, "stages": []}
    xyz = None
    for k, (dit, x) in enumerate(((ref["dit1"], x0_1), (ref["dit2"], x0_2))):
        if k == 1:
            xyz = stage_xyz(rec["stages"][0]["final"]) / XYZ_COND
        g = nets.cfg_guided(dit, tokens, vector, s["cfg_scale"], xyz)
        ts, dt = schedule(s["num_steps"], x.device), 1.0 / s["num_steps"]
        xs, mids = [], []
        for t in ts:
            tb = t.expand(1)
            v1 = g(x, tb)
            xs.append(x)
            mids.append(x + dt * v1)
            x = x + 0.5 * dt * (v1 + g(mids[-1], tb + dt))
        rec["stages"].append({"x": xs, "mid": mids, "final": x})
    lods = ref["vae"].decode(rec["stages"][1]["final"],
                             stage_xyz(rec["stages"][0]["final"]))
    maps, _ = render(cfg, lods[-1][0], cameras(cfg, image.device))
    rec["lods"] = lods
    rec["render"] = {k: v[None] for k, v in maps.items()}
    return rec


def _rel_max(got, ref, base=None) -> float:
    base = ref if base is None else base
    return float((got.float() - ref.float()).abs().max()
                 / base.float().abs().max().clamp_min(1e-30))


def _rel_mean(got, ref) -> float:
    return float((got.float() - ref.float()).abs().mean()
                 / ref.float().abs().mean().clamp_min(1e-30))


@torch.no_grad()
def compare(cfg: dict, ref: Dict[str, torch.nn.Module], rec: dict
            ) -> Dict[str, float]:
    """The numbers of one recorded request (see the module docstring) and
    the turntable's per-view, per-tile steps under `"steps"`."""
    s = cfg["sampler"]
    out = {}
    dev = rec["image"].device
    rec = dict(rec, lods=[g.to(dev) for g in rec["lods"]],
               render={k: v.to(dev) for k, v in rec["render"].items()})
    tokens, vector = ref["cond"](rec["image"])
    out["cond_tokens"] = max(_rel_max(rec["tokens"], tokens),
                             _rel_max(rec["vector"], vector))
    vel, upd = 0.0, 0.0
    finals = [st["final"] for st in rec["stages"]]
    for k, st in enumerate(rec["stages"]):
        xyz = None if k == 0 else stage_xyz(finals[0]) / XYZ_COND
        dit = ref["dit1"] if k == 0 else ref["dit2"]
        # the tokens the program handed its DiTs
        g = nets.cfg_guided(dit, rec["tokens"], rec["vector"],
                            s["cfg_scale"], xyz)
        dt = 1.0 / s["num_steps"]
        nxt = st["x"][1:] + [st["final"]]
        for t, x, mid, x1 in zip(schedule(s["num_steps"],
                                          st["x"][0].device),
                                 st["x"], st["mid"], nxt):
            tb = t.expand(1)
            v1 = g(x, tb)
            mid_ref = x + dt * v1
            x1_ref = x + 0.5 * dt * (v1 + g(mid_ref, tb + dt))
            vel = max(vel, _rel_max(mid, mid_ref, mid_ref - x))
            upd = max(upd, _rel_max(x1, x1_ref, x1_ref - x))
    out["velocity"], out["heun_update"] = vel, upd
    lods = ref["vae"].decode(finals[1], stage_xyz(finals[0]))
    out["decode"] = max(_rel_mean(got[..., a:b], want[..., a:b])
                        for got, want in zip(rec["lods"], lods)
                        for a, b in CHANNELS)
    if len(rec["lods"]) != len(lods):
        out["decode"] = float("inf")
    maps, work = render(cfg, rec["lods"][-1][0],
                        cameras(cfg, rec["image"].device))
    out["render"] = max(_rel_mean(rec["render"][m][0], maps[m])
                        for m in MAPS)
    out["steps"] = work["steps"]
    return out


def check(cfg: dict, seed: int, records: List[dict], device,
          control: bool = False):
    """Worst of each number over the recorded requests, and the per-view
    steps of each request. With `control` the records are first made by
    the reference itself in its lower precision."""
    with ieee():
        ref = build(cfg, seed, device)
        if control:
            with control_policy(cfg["precision"]["compute_dtype"]):
                records = [request(cfg, ref, r["image"], r["x0"][0],
                                   r["x0"][1]) for r in records]
        per = [compare(cfg, ref, r) for r in records]
    for r in records:
        g = r["lods"][-1][0]
        print("checked request: latents' std "
              + " ".join(f"{float(st['final'].std()):.4g}"
                         for st in r["stages"])
              + f", surfel scale median {float(g[:, 4:6].median()):.4g} "
              f"max {float(g[:, 4:6].max()):.4g}, turntable alpha mean "
              f"{float(r['render']['alpha'].mean()):.4g}",
              file=sys.stderr)
    worst = {k: max(p[k] for p in per) for k in per[0] if k != "steps"}
    return worst, [p["steps"] for p in per]
