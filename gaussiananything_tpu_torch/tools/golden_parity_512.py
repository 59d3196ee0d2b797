"""Golden parity at the release shape: the port's rasterizer against the
unbinned oracle (port of `tools/golden_parity_512.py --impl fused`).

    python -m gaussiananything_tpu_torch.tools.golden_parity_512 \\
        [--out tests/goldens/parity_512_cuda.json] [--device cuda]

On the card (the default) it renders the JAX tool's scene, a 73,728-splat
sphere (`make_object(0, kind="sphere")`) at 512² from (20°, 45°),
(-10°, 200°) and (55°, 310°) at radius 1.8 over a white background, tile
16, `max_per_tile` 8192 (above the densest tile, so no splat is dropped),
through three paths of `rasterize_tiled`:

  * the training path, under grad at chunk 128: K2a forward, K2b backward;
  * the forward path at chunk 256: K1;
  * `impl="plain"`: the plain PyTorch pair at chunk 128.

Each path's maps are held against `rasterize_naive`, which composites
every splat for every pixel (no binning, no footprint clamp, no cap), and
the training path's also against the plain path's. Backward: the gradient
of the JAX tool's weighted full-channel loss (`channel_loss`) with respect
to the 13-channel gaussians, through K2b, against torch autograd through
the oracle's own `composite_chunk` calls (`oracle_gradient`: an
independent derivation, not `composite_plain_backward`, which K2b shares),
and against the plain pair's analytic gradient.

Criteria (the JAX tool's, `tools/golden_parity_512.py:46-58`): every
continuous channel within `TOL` of the oracle; `depth_median`, which
selects the splat at the T = 0.5 crossing so that a last-ulp transmittance
difference moves it to a neighbouring splat, within `TOL` at the 99.9th
percentile, beyond it on at most `MEDIAN_FLIP_FRAC` of the pixels, and
never beyond `MEDIAN_FLIP_BOUND`; gradients within 2e-3·max(1, max|g_ref|).
The record, in the JAX artifact's schema plus the card's name, its power
limit, each view's seconds and, for each of the 13 gaussian channels, the
gradients' worst max|Δ| beside the reference gradient's max (which the
tests and the smoke hold to `GRAD_CHANNEL_REL` of that channel's own max),
goes to `--out` (default `tests/goldens/parity_512_cuda.json`; the JAX
artifacts are never written); the exit code is 1 when a criterion fails.
`run_parity`'s arguments take a smaller scene.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gaussiananything_tpu_torch.data.synthetic import make_object
from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.render import cameras
from gaussiananything_tpu_torch.utils.device import resolve_device

RES = 512
N_SPLATS = 73728
VIEWS = ((20, 45), (-10, 200), (55, 310))
RADIUS = 1.8
TILE = 16
MAX_PER_TILE = 8192
TRAIN_CHUNK, FORWARD_CHUNK, ORACLE_CHUNK = 128, 256, 256
# pixels per oracle block: a chunk holds about 30 (P, 256) float32
# intermediates, 2 GB at 65,536 pixels; at 8,192 (`rasterize_naive`'s
# default) the oracle's 9,216 chunk calls a view are bound by their
# launches: 11.5-14.1 s a view on an H100 80GB HBM3 at 700 W
ORACLE_PIXEL_BLOCK = 65536
CHANNELS = ("image", "alpha", "depth_median", "depth_expected",
            "normal_view", "dist")
# fp32 summation-order noise between the chunked oracle and the tiled
# paths' other chunk partitioning (`tools/golden_parity_512.py:37-45`)
TOL = {"image": 2e-3, "alpha": 2e-3, "depth_median": 5e-3,
       "depth_expected": 5e-3, "normal_view": 2e-3, "dist": 2e-3}
MEDIAN_FLIP_FRAC = 1e-4
MEDIAN_FLIP_BOUND = 0.2
GRAD_REL = 2e-3
# each gaussian channel's gradient error within this share of that
# channel's own max|g_ref|: the single bound above is set by the largest
# channel (the position's) and would let a small channel's fault through
GRAD_CHANNEL_REL = 1e-4
GAUSSIAN_CHANNELS = ("x", "y", "z", "opacity", "scale_u", "scale_v",
                     "rot_w", "rot_x", "rot_y", "rot_z", "r", "g", "b")
# the weighted full-channel objective: every output but the (piecewise
# constant) median depth participates (`tools/golden_parity_512.py:109-115`)
LOSS_WEIGHTS = {"image": 1.0, "alpha": 1.0, "dist": 0.1,
                "normal_view": 1.0, "depth_expected": 0.01}
DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "goldens",
    "parity_512_cuda.json")


def channel_loss(maps: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(w * maps[k].sum() for k, w in LOSS_WEIGHTS.items())


def _loss_row(device) -> torch.Tensor:
    """`channel_loss`'s weight on each of the N_OUT buffer channels."""
    row = torch.zeros(rz.N_OUT, device=device)
    for k, a, b in rz.OUT_CHANNELS:
        row[a:b] = LOSS_WEIGHTS.get(k, 0.0)
    return row


def oracle_gradient(gaussians: torch.Tensor, cam_view: torch.Tensor,
                    cam_view_proj: torch.Tensor, bg: torch.Tensor,
                    img_h: int, img_w: int, chunk: int = ORACLE_CHUNK,
                    pixel_block: int = ORACLE_PIXEL_BLOCK) -> torch.Tensor:
    """d `channel_loss`(`rasterize_naive`) / d gaussians by torch autograd.

    The loss is a sum over pixels, so its gradient is the sum of the
    pixel blocks' gradients: autograd runs back through one block of
    `pixel_block` pixels at a time, into the packed table, and the summed
    table gradient then runs back through the projection once. Inside a
    block every `composite_chunk` call is checkpointed (its intermediates
    recomputed in the backward), so a block holds only the pixel states
    between chunks."""
    g = gaussians.detach().requires_grad_(True)
    with torch.enable_grad():
        packed = rz.naive_table(g, cam_view, cam_view_proj, img_h, img_w,
                                chunk)
        leaf = packed.detach().requires_grad_(True)
        row = _loss_row(leaf.device)
        step = functools.partial(checkpoint, rz.composite_chunk,
                                 use_reentrant=False)
        px_all, py_all = rz.naive_pixels(img_h, img_w, leaf.device)
        d_packed = torch.zeros_like(leaf)
        for p0 in range(0, img_h * img_w, pixel_block):
            rows = rz.naive_block(leaf, px_all[p0:p0 + pixel_block],
                                  py_all[p0:p0 + pixel_block], bg, chunk,
                                  step=step)
            d_packed += torch.autograd.grad((rows * row).sum(), leaf)[0]
        packed.backward(d_packed)
    return g.grad


def channel_errors(got: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    """Per channel: max|Δ|, its 99.9th percentile and the share of pixels
    beyond `TOL`."""
    out = {}
    for c in CHANNELS:
        err = (got[c].float() - ref[c].float()).abs().flatten().cpu()
        out[c] = {"max_abs_diff": float(err.max()),
                  "p999": float(np.quantile(err.numpy(), 0.999)),
                  "frac_beyond_tol": float((err > TOL[c]).float().mean())}
    return out


def channels_pass(rec: Dict[str, dict]) -> bool:
    """The golden criterion over one path's worst channel errors."""
    ok = True
    for c, r in rec.items():
        if c == "depth_median":
            ok &= (r["p999"] <= TOL[c]
                   and r["frac_beyond_tol"] <= MEDIAN_FLIP_FRAC
                   and r["max_abs_diff"] <= MEDIAN_FLIP_BOUND)
        else:
            ok &= r["max_abs_diff"] <= TOL[c]
    return bool(ok)


def _worst(acc: Dict[str, dict], errs: Dict[str, dict]):
    for c, e in errs.items():
        cur = acc.setdefault(c, {"max_abs_diff": 0.0, "tol": TOL[c],
                                 "p999": 0.0, "frac_beyond_tol": 0.0})
        for k, v in e.items():
            cur[k] = max(cur[k], v)


def _grad_channels(acc: Dict[str, dict], got: torch.Tensor,
                   ref: torch.Tensor):
    """Fold one view's per-channel max|got - ref| and max|ref| into
    `acc` (the worst over the views)."""
    diff = (got - ref).abs().amax(dim=0).tolist()
    scale = ref.abs().amax(dim=0).tolist()
    for c, d, s in zip(GAUSSIAN_CHANNELS, diff, scale):
        cur = acc.setdefault(c, {"max_abs_diff": 0.0, "max_abs_ref": 0.0})
        cur["max_abs_diff"] = max(cur["max_abs_diff"], d)
        cur["max_abs_ref"] = max(cur["max_abs_ref"], s)


def grad_channels_pass(rec: dict) -> bool:
    """Each gaussian channel's gradient within `GRAD_CHANNEL_REL` of
    that channel's own max|g_ref| (in `rec["grad"]` and
    `rec["grad_vs_plain"]`)."""
    return all(r["max_abs_diff"] <= GRAD_CHANNEL_REL * r["max_abs_ref"]
               for key in ("grad", "grad_vs_plain")
               for r in rec[key]["channels"].values())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card(dev) -> tuple:
    """(device name, power limit) as `nvidia-smi` gives them; ("cpu",
    None) on the CPU."""
    from gaussiananything_tpu_torch.tools.rasterizer_timing import card_line
    line = card_line(dev)
    name, _, limit = line.partition(", ")
    return name, (limit or None)


def run_parity(res: int = RES, n_splats: int = N_SPLATS,
               views: Sequence = VIEWS, max_per_tile: int = MAX_PER_TILE,
               device="cuda", impl: str = "cuda",
               pixel_block: int = ORACLE_PIXEL_BLOCK,
               log: Callable[[str], None] = print) -> dict:
    """The parity record of `views` (the module docstring): per path and
    channel the worst error over the views, the gradients' worst errors,
    the training path's image hashes, the densest tile's pair count, each
    view's seconds (host clock, synchronised) and "pass". `impl` "cuda"
    runs the kernels on a CUDA device (their plain versions for CPU
    tensors); "plain" takes the plain pair for both tiled paths."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from gaussiananything_tpu_torch.ops import rasterize_cuda
        rasterize_cuda.build()          # no view's seconds include nvcc
    g = make_object(0, n=n_splats, kind="sphere", device=dev)
    poses = cameras.generate_input_camera(RADIUS, [tuple(v) for v in views])
    bg = torch.ones(3, device=dev)
    name, limit = _card(dev)
    rec = {"res": res, "n_splats": n_splats,
           "views": [list(v) for v in views], "impl": impl, "device": name,
           "power_limit": limit, "max_per_tile": max_per_tile,
           "densest_tile": 0, "channels": {}, "forward": {}, "plain": {},
           "vs_plain": {}, "tiled_image_sha256": [], "seconds": []}
    grad = {"max_abs_diff": 0.0, "max_abs_oracle_grad": 0.0,
            "channels": {}}
    grad_plain = {"max_abs_diff": 0.0, "max_abs_plain_grad": 0.0,
                  "channels": {}}

    def tiled(chunk, path_impl, with_grad):
        gq = g.detach().requires_grad_(with_grad)
        with torch.set_grad_enabled(with_grad):
            maps = rz.rasterize_tiled(gq, cam["cam_view"],
                                      cam["cam_view_proj"], bg, res, res,
                                      tile=TILE, max_per_tile=max_per_tile,
                                      chunk=chunk, impl=path_impl)
            d = torch.autograd.grad(channel_loss(maps), gq)[0] \
                if with_grad else None
        return {k: v.detach() for k, v in maps.items()}, d

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t0

    for vi, pose in enumerate(poses):
        cam = cameras.pose_to_gs_camera(pose, device=dev)
        with torch.no_grad():
            sp = rz.preprocess_splats(g, cam["cam_view"],
                                      cam["cam_view_proj"], res, res)
            counts = rz.build_tile_pairs(sp, res, res, TILE,
                                         max_per_tile)[2]
        densest = int(counts.max())
        rec["densest_tile"] = max(rec["densest_tile"], densest)
        (train, g_train), t_train = timed(
            lambda: tiled(TRAIN_CHUNK, impl, True))
        (fwd, _), t_fwd = timed(lambda: tiled(FORWARD_CHUNK, impl, False))
        (plain, g_plain), t_plain = timed(
            lambda: tiled(TRAIN_CHUNK, "plain", True))
        with torch.no_grad():
            oracle, t_oracle = timed(lambda: rz.rasterize_naive(
                g, cam["cam_view"], cam["cam_view_proj"], bg, res, res,
                chunk=ORACLE_CHUNK, pixel_block=pixel_block))
        g_oracle, t_ograd = timed(lambda: oracle_gradient(
            g, cam["cam_view"], cam["cam_view_proj"], bg, res, res,
            pixel_block=pixel_block))
        errs = {key: channel_errors(maps, oracle)
                for key, maps in (("channels", train), ("forward", fwd),
                                  ("plain", plain))}
        errs["vs_plain"] = channel_errors(train, plain)
        for key, e in errs.items():
            _worst(rec[key], e)
        gd = float((g_train - g_oracle).abs().max())
        gs = float(g_oracle.abs().max())
        grad["max_abs_diff"] = max(grad["max_abs_diff"], gd)
        grad["max_abs_oracle_grad"] = max(grad["max_abs_oracle_grad"], gs)
        gp = float((g_train - g_plain).abs().max())
        grad_plain["max_abs_diff"] = max(grad_plain["max_abs_diff"], gp)
        grad_plain["max_abs_plain_grad"] = max(
            grad_plain["max_abs_plain_grad"], float(g_plain.abs().max()))
        _grad_channels(grad["channels"], g_train, g_oracle)
        _grad_channels(grad_plain["channels"], g_train, g_plain)
        rec["tiled_image_sha256"].append(hashlib.sha256(
            train["image"].float().cpu().numpy().tobytes()).hexdigest())
        sec = {"train": t_train, "forward": t_fwd, "plain": t_plain,
               "oracle": t_oracle, "oracle_grad": t_ograd}
        rec["seconds"].append({k: round(v, 4) for k, v in sec.items()})
        log(f"view {vi} {tuple(views[vi])}: densest tile {densest} pairs "
            f"(max_per_tile {max_per_tile}); seconds "
            f"{json.dumps(rec['seconds'][-1])}; grad max|Δ| vs oracle "
            f"{gd:.3e} (max|g_oracle| {gs:.3e}), vs plain {gp:.3e}")
        for key, e in errs.items():
            log(f"  {key:>8}: " + ", ".join(
                f"{c} {r['max_abs_diff']:.3e}"
                + (f" (p99.9 {r['p999']:.3e}, beyond tol "
                   f"{r['frac_beyond_tol']:.2e})"
                   if c == "depth_median" else "")
                for c, r in e.items()))
    for c in CHANNELS:
        rec["vs_plain"][c] = {"max_abs_diff":
                              rec["vs_plain"][c]["max_abs_diff"],
                              "tol": TOL[c]}
    grad["tol"] = GRAD_REL * max(1.0, grad["max_abs_oracle_grad"])
    grad_plain["tol"] = GRAD_REL * max(1.0, grad_plain["max_abs_plain_grad"])
    rec["grad"], rec["grad_vs_plain"] = grad, grad_plain
    vs_plain_ok = all(
        r["max_abs_diff"] <= (MEDIAN_FLIP_BOUND if c == "depth_median"
                              else r["tol"])
        for c, r in rec["vs_plain"].items())
    rec["pass"] = bool(
        rec["densest_tile"] < max_per_tile
        and all(channels_pass(rec[k]) for k in ("channels", "forward",
                                                 "plain"))
        and vs_plain_ok
        and grad["max_abs_diff"] <= grad["tol"]
        and grad_plain["max_abs_diff"] <= grad_plain["tol"])
    return rec


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    rec = run_parity(device=a.device, log=lambda s: print(s, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=2)
    print(("PASS" if rec["pass"] else "FAIL"), "->", a.out, flush=True)
    if not rec["pass"]:
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
