#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the sampling path from `csrc/` with nvcc;
3. kernels: hold each kernel against its plain PyTorch version on the card,
   at every shape the main path gives it and on a scene that makes each
   output channel checkable, and time both;
4. small cascade: the sampling pipeline at small widths on the card
   against the same weights and noise on the CPU;
5. cascade: two release-width image-to-3D requests through the port's
   `cli/sample.py` on seeded random weights (a depth cut: 10 Heun steps),
   checking the outputs and that every kernel of the path was launched;
6. report: one JSON line of kernel records, the kernels launched, the
   card's name and power limit, then the `{"ok": true, ...}` line last.

It imports nothing of JAX; the port's package must sit beside this file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, dense
H100_HBM_BYTES_S = 3.35e12
# fp32 operations of one K1 (pixel, pair) step up to its keep test (plane
# evaluation, divide, rho, window, exp, clamp, tests); kept pairs add ~33
# more, so this count gives a least time
K1_OPS_PER_STEP = 43

GOLDEN_TOL = {"image": 2e-3, "alpha": 2e-3, "normal_view": 2e-3,
              "dist": 2e-3, "depth_expected": 5e-3, "depth_median": 5e-3}
MEDIAN_FLIP_FRAC = 1e-4
MEDIAN_FLIP_BOUND = 0.2


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of `fn()` over `reps` runs, CUDA events around
    each run."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_phase():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    from gaussiananything_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda"), smi_line


def build_phase():
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    t0 = time.perf_counter()
    rasterize_cuda._library()
    dt = time.perf_counter() - t0
    print(f"[build] K1 {rasterize_cuda.SOURCE}: {dt:.2f}s", flush=True)
    for line in rasterize_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build]   {line.strip()}", flush=True)


def _golden_errors(got, ref, names):
    """Per-channel errors with the golden criteria of
    tests/test_golden_parity.py:36-99."""
    import torch
    errs, ok = {}, True
    for k in names:
        d = (got[k] - ref[k]).abs().flatten()
        tol = GOLDEN_TOL[k]
        rec = {"max_abs": float(d.max())}
        if k == "depth_median":
            rec["p999"] = float(torch.quantile(d.double(), 0.999))
            rec["frac_beyond_tol"] = float((d > tol).double().mean())
            good = (rec["p999"] <= tol
                    and rec["frac_beyond_tol"] <= MEDIAN_FLIP_FRAC
                    and rec["max_abs"] <= MEDIAN_FLIP_BOUND)
        else:
            good = rec["max_abs"] <= tol
        ok &= good
        errs[k] = rec
    return ok, errs


# K1's cases: every configuration the main path launches it at, and a scene
# that makes its dist channel checkable. name: (make_object seed, n, kind,
# opacity or None to keep the object's, camera radius, (elevation,
# azimuth), image size, max_per_tile, chunk)
K1_CASES = {
    # the slice's render shape on the bench.py:42-56 scene, with
    # cfg.render.chunk 256 (bench.py itself uses 128); timed, and bounded
    "turntable": (0, 73728, "sphere", None, 1.8, (20, 45), 512, 2048, 256),
    # the demo conditioning view (cli/sample.py demo_condition_image)
    "demo view": (7, 512, None, None, 1.8, (20, 30), 512, 512, 128),
    # dist is built from squared gaps of the mapped depth m(z), dm/dz =
    # 0.01/z², so on the two scenes above it is ~1e-7, under its fp32 floor;
    # translucent shells seen from close range lift it to ~2e-4, and chunk
    # 32 spreads every tile's segment over several chunks, where the
    # entry-state cross terms carry nearly all of it
    "dist scene": (0, 73728, "sphere", 0.2, 0.6, (20, 45), 512, 2048, 32),
}
# the fp32 floor of dist's running sums is ~1e-6 (their terms are ~1 and
# cancel); held to DIST_REL of a largest value of at least DIST_FLOOR, a
# dist of 0, or one without the entry-state cross terms, fails
DIST_REL = 2e-2
DIST_FLOOR = 1e-4


def _k1_inputs(dev, seed, n, kind, opacity, radius, pose, res, mpt):
    """The K1 wrapper's inputs for one case: (tab, pairs, starts, counts,
    bg, res, res)."""
    import torch
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.render import cameras
    g = make_object(seed, n=n, kind=kind, device=dev)
    if opacity is not None:
        g[:, 3] = opacity
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(radius, [pose])[0], device=dev)
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    pairs, starts, counts = rz.build_tile_pairs(sp, res, res, 16, mpt)
    tab = rz.splat_table(rz.pack_splat_render(sp)).contiguous()
    return tab, pairs, starts, counts, torch.ones(3, device=dev), res, res


def _pair_steps(tab, pairs, starts, counts, bg, res, _res, chunk):
    """The (tile, pair) steps K1 evaluates: tile t runs chunk c while some
    pixel still has T > T_EPS after the chunks before it (the kernel's
    per-chunk saturation exit). T after c chunks is the plain version's
    image over bg 1 minus over bg 0 with the counts cut at c·chunk: the
    flushed T is exactly 0 or above T_EPS."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    tiles = res // 16
    live = torch.ones_like(counts, dtype=torch.bool)
    steps, c0 = 0, 0
    while bool((todo := live & (counts > c0)).any()):
        steps += int(torch.clamp(counts[todo] - c0, max=chunk).sum())
        cut = torch.clamp(counts, max=c0 + chunk)
        t = (rz.composite_plain(tab, pairs, starts, cut, bg, res, res,
                                chunk=chunk)[0]
             - rz.composite_plain(tab, pairs, starts, cut, 0 * bg, res, res,
                                  chunk=chunk)[0])
        live = t.reshape(tiles, 16, tiles, 16).amax((1, 3)).flatten() > 0
        c0 += chunk
    return steps


def k1_phase(dev):
    """K1 against its plain version on the card in every K1_CASES case, to
    the golden criteria, and dist to DIST_REL of its size on the dist
    scene; both timed at the slice's render shape ("turntable")."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda

    max_err = 0.0
    for name, (*scene, chunk) in K1_CASES.items():
        args = _k1_inputs(dev, *scene)
        got = rasterize_cuda.composite(*args, chunk=chunk)
        ref = rz.composite_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        got_maps, ref_maps = rz.split_outputs(got), rz.split_outputs(ref)
        ok, errs = _golden_errors(got_maps, ref_maps, GOLDEN_TOL)
        dist_max = float(ref_maps["dist"].abs().max())
        dist_rel = errs["dist"]["max_abs"] / max(dist_max, 1e-30)
        print(f"[K1] {name} ({scene[1]} splats, {scene[6]}², max_per_tile "
              f"{scene[7]}, chunk {chunk}) vs plain: "
              f"{json.dumps(errs, sort_keys=True)}; max|dist_ref| "
              f"{dist_max:.4g}, dist error / max|dist_ref| {dist_rel:.4g}",
              flush=True)
        if not torch.isfinite(got).all():
            fail(f"K1 output is not finite ({name})")
        if not ok:
            fail(f"K1 disagrees with its plain version beyond the golden "
                 f"criteria ({name})")
        if name == "dist scene" and not (dist_max >= DIST_FLOOR
                                         and dist_rel <= DIST_REL):
            fail(f"K1's dist disagrees with its plain version: error "
                 f"{dist_rel:.4g} of max|dist_ref| {dist_max:.4g} (limit "
                 f"{DIST_REL} of a max|dist_ref| of at least {DIST_FLOOR})")
        max_err = max(max_err, *(r["max_abs"] for r in errs.values()))
        if name == "turntable":
            timed = args

    tab, _, _, counts, _, res, _ = timed
    chunk, tile = K1_CASES["turntable"][-1], 16
    ms = time_cuda(lambda: rasterize_cuda.composite(*timed, chunk=chunk),
                   reps=50)
    plain_ms = time_cuda(lambda: rz.composite_plain(*timed, chunk=chunk),
                         reps=5, warmup=1)
    steps = _pair_steps(*timed, chunk)
    n_tiles = (res // tile) ** 2
    n_bytes = (tab.numel() * 4 + int(counts.sum()) * 4 + 2 * n_tiles * 4
               + 3 * 4 + rz.N_OUT * res * res * 4)
    n_ops = steps * tile * tile * K1_OPS_PER_STEP
    t_bytes = n_bytes / H100_HBM_BYTES_S * 1e3
    t_ops = n_ops / H100_FP32_FLOPS * 1e3
    print(f"[K1] turntable: {ms:.4f} ms (median of 50), plain "
          f"{plain_ms:.2f} ms; pairs {int(counts.sum())}, pair steps "
          f"{steps}, bytes {n_bytes}, ops {n_ops}", flush=True)
    return {
        "name": "K1", "route": "cuda",
        "source": "gaussiananything_tpu_torch/csrc/rasterize_v4.cu",
        "replaces": "gaussiananything_tpu/ops/rasterize_pallas.py:806",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no single PyTorch call composites 2DGS surfels
        "library_ms": None,
    }


def _small_models(device):
    from gaussiananything_tpu_torch.cli.sample import ReleaseModels
    from gaussiananything_tpu_torch.models.conditioner import \
        ImageConditioner
    from gaussiananything_tpu_torch.models.dit import PointDiT
    from gaussiananything_tpu_torch.models.vae import PointVAE
    import torch
    torch.manual_seed(0)
    kw = dict(width=128, depth=2, heads=2)
    with torch.device(device):
        m = ReleaseModels(
            cond=ImageConditioner(img_size=56, **kw),
            dit1=PointDiT(in_channels=3, cond_dim=128, vector_dim=128, **kw),
            dit2=PointDiT(in_channels=10, cond_dim=128, vector_dim=128,
                          use_xyz_pe=True, **kw),
            vae=PointVAE(latent_num=12, decoder_width=128, decoder_depth=2,
                         decoder_heads=2))
    for mod in (m.cond, m.dit1, m.dit2, m.vae):
        mod.eval()
    return m


def small_cascade_phase(dev):
    """The cascade at small widths on the card (cuBLAS, K1) against the
    same weights and noise on the CPU: stage outputs to 1e-3 of their
    scale, LoDs to 1e-3. The card's turntable is held to the golden
    criteria against the plain compositor on the same card and LoDs."""
    import copy
    import torch
    from gaussiananything_tpu_torch.cli.sample import (ReleaseModels,
                                                       sample_request)
    from gaussiananything_tpu_torch.config import RenderConfig
    from gaussiananything_tpu_torch.render import cameras
    from gaussiananything_tpu_torch.render.renderer import render_multiview
    from gaussiananything_tpu_torch.train.fm_trainer import FMConfig
    cpu = _small_models("cpu")
    card = ReleaseModels(*(copy.deepcopy(m).to(dev) for m in
                           (cpu.cond, cpu.dit1, cpu.dit2, cpu.vae)))
    g = torch.Generator().manual_seed(1)
    img = torch.rand((1, 3, 64, 64), generator=g)
    x0 = (torch.randn((1, 12, 3), generator=g),
          torch.randn((1, 12, 10), generator=g))
    fm1 = FMConfig(stage=1, cfg_scale=4.5, num_steps=4, sampler="heun")
    fm2 = dataclasses.replace(fm1, stage=2)
    rcfg = RenderConfig(output_size=64, max_per_tile=256, chunk=64)
    quiet = dict(log=lambda s: None)
    ref = sample_request(cpu, img, fm1, fm2, rcfg, x0_stage1=x0[0],
                         x0_stage2=x0[1], **quiet)
    got = sample_request(card, img.to(dev), fm1, fm2, rcfg,
                         x0_stage1=x0[0].to(dev), x0_stage2=x0[1].to(dev),
                         **quiet)
    errs = {}
    for k in ("xyz_n", "kl"):
        scale = float(ref[k].abs().max())
        errs[k] = float((got[k].cpu() - ref[k]).abs().max()) / scale
    errs["lods"] = max(float((a.cpu() - b).abs().max())
                       for a, b in zip(got["lods"], ref["lods"]))
    cam = cameras.pose_to_gs_camera(cameras.uni_mesh_path(8)[:8],
                                    device=dev)
    plain = render_multiview(got["lods"][-1], cam["cam_view"][None],
                             cam["cam_view_proj"][None],
                             torch.ones((1, 8, 3), device=dev), 64,
                             max_per_tile=256, chunk=64, impl="plain")
    names = {"image": "image", "alpha": "alpha", "depth": "depth_median",
             "depth_expected": "depth_expected", "dist": "dist",
             "rend_normal": "normal_view"}
    ok, rerr = _golden_errors(
        {names[k]: got["render"][k] for k in names},
        {names[k]: plain[k] for k in names}, names.values())
    print(f"[small cascade] card vs CPU: {json.dumps(errs)}; turntable K1 "
          f"vs plain: {json.dumps(rerr, sort_keys=True)}", flush=True)
    if not (errs["xyz_n"] <= 1e-3 and errs["kl"] <= 1e-3
            and errs["lods"] <= 1e-3 and ok):
        fail("the small cascade on the card disagrees with its reference")


def cascade_phase(dev):
    """Two release-width requests through the port's CLI on random weights
    (a depth cut: 10 Heun steps for the release's 250). K1's count is set
    to 0 just before and read just after: the demo conditioning image is
    one view, each request's turntable eight."""
    num, steps = 2, 10
    with tempfile.TemporaryDirectory() as out_dir:
        return _cascade_run(dev, num, steps, out_dir)


def _cascade_run(dev, num, steps, out_dir):
    import torch
    from gaussiananything_tpu_torch.cli import sample
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    rasterize_cuda.composite.launches = 0
    t0 = time.perf_counter()
    results = sample.main(["--release", "--full", "--num", str(num),
                           "--steps", str(steps), "--seed", "0",
                           "--out", out_dir, "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = {"K1": rasterize_cuda.composite.launches}
    print(f"[cascade] {num} requests, {steps} Heun steps, wall {wall:.2f}s "
          f"(model build included); launches {json.dumps(launches)}",
          flush=True)
    if launches["K1"] != 1 + 8 * num:
        fail(f"K1 launched {launches['K1']} times, expected 1 + 8 x {num}")
    for i, res in enumerate(results):
        print(f"[cascade] request {i} seconds: "
              f"{json.dumps(res['timings'])}", flush=True)
        lods = res["lods"]
        if [tuple(x.shape) for x in lods] != [(1, n, 13) for n in
                                              (768, 6144, 24576, 73728)]:
            fail(f"LoD shapes {[tuple(x.shape) for x in lods]}")
        for x in (res["xyz_n"], res["kl"], *lods,
                  *res["render"].values()):
            if not torch.isfinite(x).all():
                fail("non-finite values in the cascade's outputs")
        fin = lods[-1][0]
        op = fin[:, 3]
        qn = fin[:, 6:10].norm(dim=-1)
        if not (0 <= float(op.min()) and float(op.max()) <= 1):
            fail("opacity outside [0, 1]")
        if float((qn - 1).abs().max()) > 1e-4:
            fail("quaternions are not unit")
        cover = float((res["render"]["alpha"] > 1e-3).float().mean())
        print(f"[cascade] request {i}: alpha coverage {cover:.4f}, "
              f"xyz range {float(res['xyz'].min()):.3f}.."
              f"{float(res['xyz'].max()):.3f}", flush=True)
        if cover <= 0:
            fail("the turntable is empty")
        for name in (f"stage1_{i}.ply", f"stage1_{i}.glb",
                     f"gaussians_{i}.ply", f"turntable_{i}.png"):
            if not os.path.getsize(os.path.join(out_dir, name)):
                fail(f"{name} is empty")
    return launches


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "gaussiananything_tpu_torch")):
        fail("gaussiananything_tpu_torch/ is missing beside chip_smoke.py")
    dev, smi_line = device_phase()
    build_phase()
    k1 = k1_phase(dev)
    small_cascade_phase(dev)
    launches = cascade_phase(dev)
    k1["launches"] = launches["K1"]
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(f"kernels: {json.dumps(sorted(launches))}", flush=True)
    print(smi_line, flush=True)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
