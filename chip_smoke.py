#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel from `csrc/` with nvcc, the sources in
   parallel, and print what ptxas says of each; compile the mesh export's
   host library from `native/surface_nets.cc`;
3. kernels: hold each kernel (K1 forward, K2a forward with entry states,
   K2b backward, K6 segment-fed forward, K3/K4/K5 dense-list forwards, the
   eight stage instantiations of K4) against its plain PyTorch version on
   the card, at every shape the main paths give it and on a scene that
   makes each output channel checkable, and time both; K2b twice,
   bit-equal; K6 also against K1, K3-K5 also against K1 up to the image
   residue of their unflushed transmittance, K4 and K5 also against K3
   bit for bit; the gradient of
   `rasterize_tiled_v1_fused` against the plain route's;
4. small cascade: the sampling pipeline at small widths on the card
   against the same weights and noise on the CPU;
5. cascade: two release-width image-to-3D requests through the port's
   `cli/sample.py` on seeded random weights (a depth cut: 10 Heun steps),
   checking the outputs and that every kernel of the path was launched;
6. small train: three VAE training steps at small widths on the card
   against the same weights, batch and draws on the CPU;
7. train: three training steps at the `vae-release` preset's full width
   through the port's `cli/train_vae.py` on seeded random weights (the
   batch cut to TRAIN_BATCH), checking losses, the step count, that
   parameters and EMA moved, the kernels' launch counts (K2a twice per
   rendered view: the checkpointed render runs again in the backward),
   and timing the step's stages; then the same run with
   `vae.compute_dtype` bfloat16 in its `--config`, checking that the
   parameters, moments and EMA stay fp32 and that every norm weight at
   1.0 moved, its stages and peak printed beside the fp32 run's;
8. small adv train: an adversarial generator step (adaptive weight,
   seeded VGG-LPIPS), a discriminator step and a two-micro-batch
   accumulation step at small widths on the card against the CPU;
9. adv train: the release VAE recipe at the `vae-release` preset's full
   width through `cli/train_vae.py` (`--adv --lpips-npz --data-dir
   --holdout 1 --canonicalize --eval-every 2`, 3 steps, then a resume),
   on a 512² dataset that the port's `export_synthetic_dataset` writes
   and seeded LPIPS weights that numpy writes, checking the kernels'
   launch counts against the steps, discriminator steps and evaluations,
   the losses, the evaluation PNGs and both networks' checkpoints;
10. small flow train: generator training at small widths on the card
   against the same weights and draws on the CPU (stage 1, stage 2, a
   frozen conditioner, two micro-batches; `remat` bit-equal to its
   absence on the card), the adaptive dopri5 and SDE samplers, one
   `cli/extract_latents.py` encode;
11. flow train: the generator's training path at full width through the
   port's CLIs: `extract_latents --preset vae-release --num 8`, then
   `train_flow --preset stage1` (DiT-L against the frozen scratch ViT-L,
   batch 8 in 2 micro-batches, 3 steps, a checkpoint, an evaluation, a
   resume to step 4), the first three steps again with
   `dit.compute_dtype` bfloat16 (stages and peak beside fp32), `--stage
   2`, `--preset t23d --cond text` and one synthetic-stream step,
   checking losses, step counts, fp32 states, that each run's
   last update moved the DiT (and a trained conditioner) by its learning
   rate and the EMA by its decay from the checkpoint written before it,
   that a frozen conditioner ends with its `--cond-ckpt` weights, the
   evaluations, the checkpoints, K1's launches, and timing each step's
   stages;
12. fm-release-batch: the release flow-matching batch through
   `tools/fm_feasibility.py` (stage-1 DiT-L with `remat` against the frozen
   ViT-L, batch 256 in 8 micro-batches): a warm-up step and a timed step,
   their seconds and the peak; then `tools/release_feasibility.py` at its
   defaults in fp32 and with `--bf16`, a process each: the release VAE
   step's first and steady seconds and peak;
13. rasterizer tools: the rasterizer's own entry points at the release
   shape through `tools/rasterizer_timing.py --all`, `tools/bench.py` and
   `tools/kernel_stages.py`, checking every kernel's launch count against
   what the arguments predict;
14. parity-512: the port's 512² parity tool (`tools/golden_parity_512.py`:
   73,728 splats, `max_per_tile` 8192, three views): K2a, K1 and the plain
   pair against the unbinned oracle, K2b's gradient against the oracle's
   autograd gradient, within the tool's criteria;
15. bands (after the kernels of 3): K1 at the release render shape and
   K2a/K2b at the 512² and 384² LoDs, each view in 2 and in 4 bands of
   rows (`row0`), each band against the plain versions with its row0, the
   bands' pair lists equal to the whole view's, the joined bands bit-equal
   to the whole-view render, the summed band gradient against the whole
   view's, and every kernel timed per band;
16. multi-rank: two ranks on the one card over gloo under
   `torch.distributed.run`: `parallel/dryrun.py`'s five steps (two of
   them accumulation steps) against the unsharded ones, then
   `cli/train_vae.py --preset vae-release` on 2 x 1 and 1 x 2 meshes and
   `cli/train_flow.py --preset stage1 --accum 2` on a 2 x 1 mesh,
   checking steps, losses, launches, and printing each rank's seconds by
   stage and peak;
17. profile: `utils/profiling.trace` around one batch-2 release DiT-L
   evaluation and one 512² turntable view: top kernels by device time and
   the device-busy share;
18. import: mirrors of the released stage-1 DiT and VAE through
   `cli/import_release`, restored into the port's modules on the card and
   held against the mirrors' forward;
19. report: one JSON line of kernel records, the kernels launched, the
   card's name and power limit, then the `{"ok": true, ...}` line last.

It imports nothing of JAX; the port's package must sit beside this file
(and `tests/torch_mirror_ga.py`, torch only, for the import phase).
`chip_smoke.py --rank-run vae|flow ARGV_JSON OUT_DIR` is one rank of
phase 16, started by `torch.distributed.run`.

    python3 chip_smoke.py --probe-batch [--bf16] [batch ...]
                                                        (default: 8 4 2 1)

runs none of the phases: it looks for the largest batch of the
release-width training step that the card holds (with `--bf16`, under
`vae.compute_dtype` bfloat16). Each batch runs two steps
of `cli/train_vae.py --preset vae-release` in a process of its own (so a
failed allocation leaves nothing behind), largest first, stopping at the
first that fits, and prints one JSON line per batch: whether the allocation
failed, `torch.cuda.max_memory_allocated()`, the second step's seconds by
stage.
"""
from __future__ import annotations

import dataclasses
import functools
import io
import json
import math
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
# What the backward needs, whatever its design: the same 43 once for every
# executed step (the keep test must be recomputed), and for every step that
# blends with a weight above zero (`rasterize.active_steps`) the adjoints,
# counted from `chunk_backward` as K2b's second pass writes them out: the
# transmittance products and the median crossing 8, the weight and mapped
# depth 7, the weight cotangent 19, the alpha chain 12, the depth chain 15,
# the opacity/window/rho chain 18, the ray-plane chain 14, the 22 products
# of the pixel basis and the features 24, and 22 additions into the sums
# over the pixels. (K2b itself evaluates the 43 twice.)
K2B_ADJOINT_OPS = 8 + 7 + 19 + 12 + 15 + 18 + 14 + 24 + 22
# fp32 operations of one (pixel, pair) step of the list kernels K3-K5 up to
# the keep test: the two pixel planes 12, their cross product 9, the guard 2,
# two divisions, rho3d 3, the depth 4, rho2d 6, min and select 3, the window
# 4, exp and product 3, the clamp and the tests 5
V1_OPS_PER_STEP = 53
# the stage kernels stop earlier: planes, cross product, guard, divisions and
# rho 28; alpha 5 more; log1p, sum, exp, weight 7 more; four sums 7 more
STAGE_OPS_PER_STEP = (28, 33, 40, 47)
# the batch of the release-width training phase: the preset's 8 does not
# fit 80 GB in fp32 without activation checkpointing; see PERF.md for the
# measured peaks
TRAIN_BATCH = 2
TRAIN_STEPS = 3

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
    rasterize_cuda._library("fwd")
    dt = time.perf_counter() - t0
    names = {"fwd": "K1+K2a", "bwd": "K2b", "seg": "K6",
             "v1": "K3+K4+K5+stages"}
    print("[build] " + ", ".join(f"{names[k]} {path}" for k, path in
                                 rasterize_cuda.SOURCES.items())
          + f", in parallel: {dt:.2f}s", flush=True)
    for line in rasterize_cuda.build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "smem")):
            print(f"[build]   {line.strip()}", flush=True)
    # the mesh export's host library (native/surface_nets.cc)
    from gaussiananything_tpu_torch import native_bindings
    t0 = time.perf_counter()
    native_bindings.library()
    print(f"[build] {native_bindings.SOURCE} with "
          f"{native_bindings.build_log.splitlines()[0] if native_bindings.build_log else 'a cached build'}: "
          f"{time.perf_counter() - t0:.2f}s", flush=True)


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
    # the same frame as `tools/bench.py` renders it: chunk 128
    "bench": (0, 73728, "sphere", None, 1.8, (20, 45), 512, 2048, 128),
    # the demo conditioning view (cli/sample.py demo_condition_image)
    "demo view": (7, 512, None, None, 1.8, (20, 30), 512, 512, 128),
    # a ground-truth view of the trainer's batches (`make_batch` through
    # `render_scene_views`: the object of seed 1's first item, 4096 splats of
    # a drawn kind, one pose of its elevation and azimuth ranges)
    "ground truth": (131, 4096, None, None, 1.8, (35, 200), 512, 512, 128),
    # a conditioning view of `train_flow`'s synthetic stream
    # (`render_scene_views` at the stage-1 preset's cond_img_size 224: a
    # 14 × 14 tile grid; the first object and view the flow train phase's
    # synthetic step renders, 512 splats of a drawn kind)
    "flow cond view": (177413373, 512, None, None, 1.8, (1.9073, 349.4513),
                       224, 512, 128),
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
    tab = rz.splat_table(sp, res, res).contiguous()
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
    """K1 against its plain version on the card in every K1_CASES case and
    on every view of the mesh export's sweep, to the golden criteria, and
    dist to DIST_REL of its size on the dist scene; both timed at the
    slice's render shape ("turntable") and on a mesh-sweep view."""
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

    ms, plain_ms, t_bytes, t_ops = _k1_timing(timed, K1_CASES["turntable"][-1],
                                              "turntable")
    max_err = max(max_err, _mesh_sweep_case(dev))
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


def _k1_timing(args, chunk, name, reps=50):
    """K1 and its plain version timed on one frame's inputs, and the
    frame's least time by bytes and by operations (ms each)."""
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    tab, _, _, counts, _, res, _ = args
    tile = 16
    ms = time_cuda(lambda: rasterize_cuda.composite(*args, chunk=chunk),
                   reps=reps)
    plain_ms = time_cuda(lambda: rz.composite_plain(*args, chunk=chunk),
                         reps=5, warmup=1)
    steps = _pair_steps(*args, chunk)
    n_tiles = (res // tile) ** 2
    n_bytes = (tab.numel() * 4 + int(counts.sum()) * 4 + 2 * n_tiles * 4
               + 3 * 4 + rz.N_OUT * res * res * 4)
    n_ops = steps * tile * tile * K1_OPS_PER_STEP
    t_bytes = n_bytes / H100_HBM_BYTES_S * 1e3
    t_ops = n_ops / H100_FP32_FLOPS * 1e3
    print(f"[K1] {name}: {ms:.4f} ms (median of {reps}), plain "
          f"{plain_ms:.2f} ms; pairs {int(counts.sum())}, pair steps "
          f"{steps}, bytes {n_bytes}, ops {n_ops}; bound "
          f"{max(t_bytes, t_ops):.4f} ms by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'}", flush=True)
    return ms, plain_ms, t_bytes, t_ops


# the mesh export's sweep (`render/tsdf.mesh_from_gaussians`, as the JAX
# export: `uni_mesh_path(10)`, 10 azimuths at 5 elevations, 50 views) at
# 256², max_per_tile 1024, chunk 256, of a release-width bf16 decode
# (73,728 surfels, fp32 as the rasterizer reads them)
MESH_AZIMUTHS, MESH_RES, MESH_MPT, MESH_CHUNK = 10, 256, 1024, 256
MESH_VIEWS = 5 * MESH_AZIMUTHS


def _mesh_sweep_case(dev):
    """K1 against its plain version on every view of the mesh sweep of the
    release VAE decoder's gaussians (bf16, seeded random weights, anchors
    on a sphere), to the golden criteria; one view timed and bounded.
    Returns the largest error."""
    import torch
    from gaussiananything_tpu_torch.config import preset, release_config
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    from gaussiananything_tpu_torch.render import cameras
    torch.manual_seed(0)
    cfg = release_config(preset("demo-e2e"))
    with torch.device(dev):
        vae = PointVAE.from_config(cfg.vae, dtype=torch.bfloat16).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    K = cfg.vae.latent_num
    anchors = make_object(0, n=K, kind="sphere", device=dev)[None, :, :3]
    with torch.no_grad():
        gauss = vae.decode(torch.randn((1, K, cfg.vae.z_channels),
                                       generator=g, device=dev),
                           anchors)[-1][0]
    del vae
    cams = cameras.pose_to_gs_camera(cameras.uni_mesh_path(MESH_AZIMUTHS),
                                     device=dev)
    bg = torch.ones(3, device=dev)
    max_err, worst = 0.0, {}
    for v in range(MESH_VIEWS):
        sp = rz.preprocess_splats(gauss, cams["cam_view"][v],
                                  cams["cam_view_proj"][v], MESH_RES,
                                  MESH_RES)
        pairs, starts, counts = rz.build_tile_pairs(sp, MESH_RES, MESH_RES,
                                                    16, MESH_MPT)
        args = (rz.splat_table(sp, MESH_RES, MESH_RES).contiguous(), pairs,
                starts, counts, bg, MESH_RES, MESH_RES)
        got = rz.split_outputs(rasterize_cuda.composite(*args,
                                                        chunk=MESH_CHUNK))
        ref = rz.split_outputs(rz.composite_plain(*args, chunk=MESH_CHUNK))
        ok, errs = _golden_errors(got, ref, GOLDEN_TOL)
        if not ok:
            flips = (got["depth_median"] - ref["depth_median"]).abs() > \
                GOLDEN_TOL["depth_median"]
            fail(f"K1 disagrees with its plain version beyond the golden "
                 f"criteria on mesh-sweep view {v}: {json.dumps(errs)}; "
                 f"alpha at the median-depth flips (K1, plain): "
                 f"{got['alpha'][flips].tolist()}, "
                 f"{ref['alpha'][flips].tolist()}")
        if not all(torch.isfinite(x).all() for x in got.values()):
            fail(f"K1 output is not finite (mesh sweep view {v})")
        err = max(r["max_abs"] for r in errs.values())
        if err >= max_err:
            max_err, worst = err, errs
        if v == 0:
            timed = args
    print(f"[K1] mesh sweep ({MESH_VIEWS} views of {gauss.shape[0]} "
          f"decoded splats, {MESH_RES}², max_per_tile {MESH_MPT}, chunk "
          f"{MESH_CHUNK}) vs plain, worst view: "
          f"{json.dumps(worst, sort_keys=True)}", flush=True)
    _k1_timing(timed, MESH_CHUNK, "mesh sweep view 0")
    return max_err


# K2a/K2b's cases: the trainer's render call (`render_lods`: max_per_tile
# 1024, chunk 128) at each of the four LoDs of the ladder (768 splats at
# 128², 6,144 at 256², 24,576 at 384² with a 24 x 24 tile grid that is no
# power of two, 73,728 at 512²), on K1's scene; the dist scene with chunk
# 32; the forward + backward of `tools/rasterizer_timing.py` (max_per_tile
# 2048, chunk 128); and a small shape held to rtol/atol.
# name: (seed, n, kind, opacity, radius, pose, image size, max_per_tile,
# chunk)
K2_CASES = {
    "train 512": (0, 73728, "sphere", None, 1.8, (20, 45), 512, 1024, 128),
    "train 384": (0, 24576, "sphere", None, 1.8, (20, 45), 384, 1024, 128),
    "train 256": (0, 6144, "sphere", None, 1.8, (20, 45), 256, 1024, 128),
    "train 128": (0, 768, "sphere", None, 1.8, (20, 45), 128, 1024, 128),
    "tools 512": (0, 73728, "sphere", None, 1.8, (20, 45), 512, 2048, 128),
    "dist scene": (0, 73728, "sphere", 0.2, 0.6, (20, 45), 512, 1024, 32),
    "small": (0, 1024, "sphere", None, 1.8, (20, 45), 64, 256, 64),
}
# the cases the training pair is timed at: the trainer's four LoDs and the
# timing tool's frame, with their launches (per training step at
# TRAIN_BATCH: 4 views of each LoD per batch element; in the tools phase)
K2_TIMED = {"train 128": "step", "train 256": "step", "train 384": "step",
            "train 512": "step", "tools 512": "tools"}
GRAD_REL = 2e-3            # of max|g| per surfel channel
DIST_WEIGHT = 100.0        # the trainer's weight on the dist map
DIST_GRAD_SHARE = 1e-3


def _executed_steps(counts, n_exec, chunk):
    """(tile, pair) steps of the chunks the forward executed."""
    import torch
    return int(torch.minimum(counts, n_exec * chunk).sum())


def _k2_launches(name):
    """(launches of a K2_TIMED case, where): per training step or in the
    tools phase."""
    return ((TRAIN_BATCH * 4, "a step") if K2_TIMED[name] == "step"
            else (TOOLS_ITERS + 1, "in the tools"))


def _print_k2_times(kernel, times):
    """Each K2_TIMED case's median beside its launches and their product."""
    parts = []
    for name, ms in times.items():
        n, where = _k2_launches(name)
        parts.append(f"{name} {ms:.4f} ms x {n} {where} = {ms * n:.4f} ms")
    print(f"[{kernel}] times: " + "; ".join(parts), flush=True)


def k2a_phase(dev):
    """K2a against `composite_plain(return_entries=True)` on the card in
    every K2_CASES case: the buffer to the golden criteria (and equal to
    K1's bit for bit), the entry states (the first `chunk_off[-1]` rows of
    the buffer the wrapper sizes from shapes) to atol 2e-5 / rtol 1e-4,
    the executed chunk counts exactly. Timed at every K2_TIMED case; the
    record is "train 512"."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda

    max_err, times = 0.0, {}
    for name, (*scene, chunk) in K2_CASES.items():
        args = _k1_inputs(dev, *scene)
        buf, off, entries, n_exec, marks = rasterize_cuda.composite_entries(
            *args, chunk=chunk)
        k1 = rasterize_cuda.composite(*args, chunk=chunk)
        rbuf, rentries, rn_exec, rmarks = rz.composite_plain(
            *args, chunk=chunk, return_entries=True)
        torch.cuda.synchronize()
        ok, errs = _golden_errors(rz.split_outputs(buf),
                                  rz.split_outputs(rbuf), GOLDEN_TOL)
        if entries.shape[0] < rentries.shape[0]:
            fail(f"K2a's entries buffer has {entries.shape[0]} rows, the "
                 f"frame needs {rentries.shape[0]} ({name})")
        entries = entries[:rentries.shape[0]]
        if not torch.equal(marks[:rmarks.shape[0]], rmarks):
            fail(f"K2a marked other slots than its plain version ({name})")
        e_err = float((entries - rentries).abs().max())
        e_ok = bool(((entries - rentries).abs()
                     <= 2e-5 + 1e-4 * rentries.abs()).all())
        print(f"[K2a] {name} ({scene[1]} splats, {scene[6]}², max_per_tile "
              f"{scene[7]}, chunk {chunk}) vs plain: "
              f"{json.dumps(errs, sort_keys=True)}; entries max_abs "
              f"{e_err:.3g} over {int(off[-1])} rows, "
              f"{int(n_exec.sum())} executed", flush=True)
        if not torch.equal(buf, k1):
            fail(f"K2a's buffer is not K1's ({name})")
        if not (ok and e_ok and torch.isfinite(entries).all()):
            fail(f"K2a disagrees with its plain version ({name})")
        if not torch.equal(n_exec, rn_exec):
            fail(f"K2a executed other chunks than its plain version ({name})")
        max_err = max(max_err, e_err, *(r["max_abs"] for r in errs.values()))
        if name == "train 512":
            timed, t_exec, t_rows = args, n_exec, int(off[-1])
        if name in K2_TIMED:
            times[name] = time_cuda(lambda: rasterize_cuda.composite_entries(
                *args, chunk=chunk), reps=50)
    _print_k2_times("K2a", times)

    tab, _, _, counts, _, res, _ = timed
    chunk, tile = K2_CASES["train 512"][-1], 16
    ms = times["train 512"]
    plain_ms = time_cuda(lambda: rz.composite_plain(
        *timed, chunk=chunk, return_entries=True), reps=5, warmup=1)
    steps = _executed_steps(counts, t_exec, chunk)
    n_tiles = (res // tile) ** 2
    n_bytes = (tab.numel() * 4 + int(counts.sum()) * 4 + 4 * n_tiles * 4
               + 3 * 4 + rz.N_OUT * res * res * 4
               + int(t_exec.sum()) * 4 * tile * tile * 4)
    n_ops = steps * tile * tile * K1_OPS_PER_STEP
    t_bytes = n_bytes / H100_HBM_BYTES_S * 1e3
    t_ops = n_ops / H100_FP32_FLOPS * 1e3
    print(f"[K2a] train 512: {ms:.4f} ms (median of 50), plain "
          f"{plain_ms:.2f} ms; pair steps {steps}, entry rows {t_rows}, "
          f"bytes {n_bytes}, ops {n_ops}", flush=True)
    return {
        "name": "K2a", "route": "cuda",
        "source": "gaussiananything_tpu_torch/csrc/rasterize_v4.cu",
        "replaces": "gaussiananything_tpu/ops/rasterize_pallas.py:1280",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def _surfel_gradient(dev, scene, chunk, impl, dist_weight=1.0,
                     only_dist=False):
    """d(Σ_map Σ map · cotangent)/d(surfels) of one view through
    `rasterize_tiled(impl=...)`, or through `rasterize_tiled_v1_fused` for
    impl "v1_fused": a seeded N(0, 1) cotangent on every output map,
    dist's scaled by `dist_weight`."""
    import torch
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.render import cameras
    seed, n, kind, opacity, radius, pose, res, mpt = scene
    g = make_object(seed, n=n, kind=kind, device=dev)
    if opacity is not None:
        g[:, 3] = opacity
    g.requires_grad_(True)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(radius, [pose])[0], device=dev)
    render = rz.rasterize_tiled_v1_fused if impl == "v1_fused" else \
        functools.partial(rz.rasterize_tiled, impl=impl)
    out = render(g, cam["cam_view"], cam["cam_view_proj"],
                 torch.ones(3, device=dev), res, res, max_per_tile=mpt,
                 chunk=chunk)
    gen = torch.Generator().manual_seed(5)
    loss = 0.0
    for k in sorted(out):
        ct = torch.randn(out[k].shape, generator=gen).to(dev)
        if k == "dist":
            ct = ct * dist_weight
        elif only_dist:
            continue
        loss = loss + (out[k] * ct).sum()
    return torch.autograd.grad(loss, g)[0]


def _grad_rel(got, ref) -> float:
    """Largest error over the surfel channels, each as a share of the
    channel's largest reference gradient."""
    return float(((got - ref).abs().amax(0)
                  / ref.abs().amax(0).clamp(min=1e-30)).max())


def _float64_witness(dev, scene, chunk):
    """The cotangent of the splat table under a seeded N(0, 1) cotangent of
    the buffer's dist channel alone (a cotangent on the other maps would
    add the discrete median and keep decisions, which differ between
    float32 and float64): K2b and the plain version in float32, each
    against the plain version walked in float64 on the same float32
    inputs. Largest error over the table's columns, each as a share of the
    column's largest float64 value."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    tab, pairs, starts, counts, bg, res, _ = args = _k1_inputs(dev, *scene)
    ct = torch.zeros((rz.N_OUT, res, res), device=dev)
    ct[6] = torch.randn((res, res),
                        generator=torch.Generator().manual_seed(6)).to(dev)
    _, off, entries, n_exec, marks = rasterize_cuda.composite_entries(
        *args, chunk=chunk)
    order, seg = rasterize_cuda.splat_order(pairs, starts, counts,
                                            tab.shape[0])
    kernel = rasterize_cuda.composite_backward(
        tab, pairs, starts, counts, bg, ct, off, entries, n_exec, marks,
        order, seg, res, res, chunk=chunk)
    plain = rz.composite_plain_backward(tab, pairs, starts, counts, bg, ct,
                                        res, res, chunk=chunk)
    exact = rz.composite_plain_backward(tab.double(), pairs, starts, counts,
                                        bg, ct.double(), res, res,
                                        chunk=chunk)[:, :rz.PACKED_F]
    return {name: float(f"{_grad_rel(got[:, :rz.PACKED_F], exact):.3g}")
            for name, got in (("kernel", kernel), ("plain float32", plain))}


def _retained_backward_check(dev, scene, chunk):
    """The adaptive GAN weight's pattern: gradients under two cotangents,
    then the first again, through ONE K2a forward whose graph is retained
    (K2b three times on the tensors it saved). Each must be bit-equal to
    K2b after a fresh forward under the same cotangent."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    tab, *frame = _k1_inputs(dev, *scene)
    gen = torch.Generator().manual_seed(7)
    cts = [torch.randn((rz.N_OUT,) + tuple(frame[-2:]),
                       generator=gen).to(dev) for _ in range(2)]
    leaf = tab.clone().requires_grad_(True)
    buf = rasterize_cuda.composite_train(leaf, *frame, chunk=chunk)
    got = [torch.autograd.grad((buf * ct).sum(), leaf, retain_graph=True)[0]
           for ct in (cts[0], cts[1], cts[0])]
    equal = [torch.equal(got[0], got[2])]
    for ct, g in zip(cts, got):
        fresh = tab.clone().requires_grad_(True)
        want, = torch.autograd.grad((rasterize_cuda.composite_train(
            fresh, *frame, chunk=chunk) * ct).sum(), fresh)
        equal.append(torch.equal(g, want))
    print(f"[K2b] three backwards through one retained K2a forward: "
          f"bit-equal to each other and to fresh ones: {all(equal)}",
          flush=True)
    if not all(equal):
        fail("K2b on a retained K2a forward differs from a fresh one")


def k2b_phase(dev):
    """K2b (through the autograd Function, K2a in front) against the plain
    pair on the card: the gradient with respect to the 13-channel surfels
    under a random cotangent on every output map, dist's carrying the
    trainer's DIST_WEIGHT, per channel within GRAD_REL of the channel's
    largest gradient; rtol 2e-3 / atol 2e-4 of the largest gradient at the
    small shape. On the dist scene the gradient through dist alone must be
    a visible share of the total and is held to the plain version on its
    own, to DIST_REL of its largest value per channel: the plain version in
    float32 is itself some 2e-3 from its float64 walk there, which the
    phase prints. (On the other scenes dist is a difference of sums that
    cancel to its fp32 floor, and its true gradient is under the rounding
    of either version.) Every kernel gradient is taken twice and must be
    bit-equal, and at "train 512" three times through one retained K2a
    forward (`_retained_backward_check`). Timed at every K2_TIMED case;
    the record is "train 512"."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda

    def backward_frame(scene, chunk):
        """The wrapper's inputs for a seeded N(0, 1) cotangent."""
        tab, pairs, starts, counts, bg, res, _ = args = _k1_inputs(dev,
                                                                   *scene)
        ct = torch.randn((rz.N_OUT, res, res),
                         generator=torch.Generator().manual_seed(6)).to(dev)
        _, off, entries, n_exec, marks = rasterize_cuda.composite_entries(
            *args, chunk=chunk)
        order, seg = rasterize_cuda.splat_order(pairs, starts, counts,
                                                tab.shape[0])
        return (tab, pairs, starts, counts, bg, ct, off, entries, n_exec,
                marks, order, seg, res, res)

    max_err, times = 0.0, {}
    for name, (*scene, chunk) in K2_CASES.items():
        if name in K2_TIMED:
            frame = backward_frame(scene, chunk)
            times[name] = time_cuda(lambda: rasterize_cuda.composite_backward(
                *frame, chunk=chunk), reps=30)
        got = _surfel_gradient(dev, scene, chunk, "cuda", DIST_WEIGHT)
        again = _surfel_gradient(dev, scene, chunk, "cuda", DIST_WEIGHT)
        ref = _surfel_gradient(dev, scene, chunk, "plain", DIST_WEIGHT)
        torch.cuda.synchronize()
        err = (got - ref).abs().amax(0)
        peak = ref.abs().amax(0)
        rel = (err / peak.clamp(min=1e-30)).tolist()
        print(f"[K2b] {name} ({scene[1]} splats, {scene[6]}², chunk "
              f"{chunk}): surfel-gradient error / max|g| per channel "
              f"{json.dumps([float(f'{r:.3g}') for r in rel])}; max|g| "
              f"{float(peak.max()):.4g}", flush=True)
        if not torch.isfinite(got).all():
            fail(f"K2b's gradient is not finite ({name})")
        if not torch.equal(got, again):
            fail(f"K2b's gradient differs between two runs ({name})")
        if not (err <= GRAD_REL * peak).all():
            fail(f"K2b disagrees with its plain version beyond {GRAD_REL} "
                 f"of max|g| ({name})")
        if name == "small" and not torch.allclose(
                got, ref, rtol=2e-3, atol=2e-4 * float(peak.max())):
            fail("K2b disagrees with its plain version at the small shape")
        if name == "dist scene":
            d_got = _surfel_gradient(dev, scene, chunk, "cuda", DIST_WEIGHT,
                                     True)
            d_ref = _surfel_gradient(dev, scene, chunk, "plain", DIST_WEIGHT,
                                     True)
            share = float(d_ref.norm() / ref.norm())
            d_rel = _grad_rel(d_got, d_ref)
            print(f"[K2b] dist scene: |g through dist| / |g| {share:.4g}, "
                  f"its error / max|g| {d_rel:.3g}", flush=True)
            if share < DIST_GRAD_SHARE:
                fail(f"the gradient through dist is {share:.3g} of the "
                     f"total: the check says nothing about it")
            # dist is a difference of sums that nearly cancel, so alone it
            # is held as its forward is: to DIST_REL of its largest value
            if d_rel > DIST_REL:
                fail("K2b's gradient through dist disagrees with its "
                     "plain version")
        if name in ("train 256", "dist scene"):
            # what fp32 rounding alone does to the gradient through dist:
            # on the dist scene it says how sharp DIST_REL is, on an opaque
            # one that dist's gradient is under fp32's resolution
            print(f"[K2b] {name}: table-cotangent error / max|g| through "
                  f"dist alone against the plain version in float64 "
                  f"(reported, not held): "
                  f"{json.dumps(_float64_witness(dev, scene, chunk))}",
                  flush=True)
        max_err = max(max_err, float(err.max()))
    _print_k2_times("K2b", times)

    *scene, chunk = K2_CASES["train 512"]
    _retained_backward_check(dev, scene, chunk)
    (tab, pairs, starts, counts, bg, ct, off, entries, n_exec, marks, order,
     seg, res, _) = backward_frame(scene, chunk)
    ms = times["train 512"]
    plain_ms = time_cuda(lambda: rz.composite_plain_backward(
        tab, pairs, starts, counts, bg, ct, res, res, chunk=chunk),
        reps=3, warmup=1)
    tile = 16
    steps = _executed_steps(counts, n_exec, chunk)
    active = rz.active_steps(tab, pairs, starts, counts, res, res,
                             chunk=chunk)
    live = int(counts.sum())
    n_tiles = (res // tile) ** 2
    # inputs once, the output once; the 96-byte row per pair that K2b writes
    # and reads back between its two kernels is its own design, not counted
    n_bytes = (tab.numel() * 4                      # table read
               + live * 4 + 5 * n_tiles * 4 + 3 * 4  # pair ids, tile ints, bg
               + int(n_exec.sum()) * 4 * tile * tile * 4    # entries read
               + rz.N_OUT * res * res * 4           # cotangent maps
               + live * 4 + (tab.shape[0] + 1) * 4  # order, seg
               + tab.numel() * 4)                   # table cotangent
    n_ops = steps * tile * tile * K1_OPS_PER_STEP + active * K2B_ADJOINT_OPS
    t_bytes = n_bytes / H100_HBM_BYTES_S * 1e3
    t_ops = n_ops / H100_FP32_FLOPS * 1e3
    print(f"[K2b] train 512: {ms:.4f} ms (median of 30), plain "
          f"{plain_ms:.2f} ms; pair steps {steps}, (pixel, pair) steps "
          f"{steps * tile * tile} of which {active} blend, live pairs "
          f"{live}, bytes {n_bytes}, ops {n_ops}", flush=True)
    return {
        "name": "K2b", "route": "cuda",
        "source": "gaussiananything_tpu_torch/csrc/rasterize_v4_bwd.cu",
        "replaces": "gaussiananything_tpu/ops/rasterize_pallas.py:1306",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def _record(name, source, replaces, max_err, ms, plain_ms, n_bytes, n_ops):
    """One entry of the `kernels` line; the bound from this run's bytes and
    operations."""
    t_bytes = n_bytes / H100_HBM_BYTES_S * 1e3
    t_ops = n_ops / H100_FP32_FLOPS * 1e3
    return {
        "name": name, "route": "cuda",
        "source": f"gaussiananything_tpu_torch/csrc/{source}",
        "replaces": replaces, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no single PyTorch call composites 2DGS surfels
        "library_ms": None,
    }


# K6's cases: K1's bench shape and dist scene, and a small shape held to
# atol 2e-5 / rtol 1e-4
K6_CASES = {
    "turntable": K1_CASES["turntable"],
    "dist scene": K1_CASES["dist scene"],
    "small": K2_CASES["small"],
}


def k6_phase(dev):
    """K6 against `composite_segments_plain` on the card in every K6_CASES
    case, to K1's limits (the golden criteria; dist to DIST_REL of its size
    on the dist scene), and against K1 on the same frame, whose arithmetic
    it shares: equal bit for bit; and on the table cut to its live rows,
    equal again. Timed at the bench shape beside K1 and the gather that
    builds its table."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda

    max_err = 0.0
    for name, (*scene, chunk) in K6_CASES.items():
        tab, pairs, starts, counts, bg, res, _ = args = _k1_inputs(dev,
                                                                   *scene)
        seg = rz.segment_table(tab, pairs)
        got = rasterize_cuda.composite_segments(seg, starts, counts, bg, res,
                                                res, chunk=chunk)
        ref = rz.composite_segments_plain(seg, starts, counts, bg, res, res,
                                          chunk=chunk)
        k1 = rasterize_cuda.composite(*args, chunk=chunk)
        # the kernel copies no row at or past a tile's count: the table cut
        # to its live rows gives the same buffer
        live_rows = seg[:int((starts + counts).max())].clone()
        cut = rasterize_cuda.composite_segments(live_rows, starts, counts, bg,
                                                res, res, chunk=chunk)
        torch.cuda.synchronize()
        if not torch.equal(cut, got):
            fail(f"K6 read rows past a tile's count ({name})")
        ref_maps = rz.split_outputs(ref)
        ok, errs = _golden_errors(rz.split_outputs(got), ref_maps,
                                  GOLDEN_TOL)
        dist_max = float(ref_maps["dist"].abs().max())
        dist_rel = errs["dist"]["max_abs"] / max(dist_max, 1e-30)
        k1_err = float((got - k1).abs().max())
        print(f"[K6] {name} ({scene[1]} splats, {scene[6]}², max_per_tile "
              f"{scene[7]}, chunk {chunk}, {seg.shape[0]} table rows) vs "
              f"plain: {json.dumps(errs, sort_keys=True)}; limits "
              f"{json.dumps(GOLDEN_TOL, sort_keys=True)}; max|dist_ref| "
              f"{dist_max:.4g}, dist error / max|dist_ref| {dist_rel:.4g}; "
              f"max|K6 - K1| {k1_err:.3g}", flush=True)
        if not torch.isfinite(got).all():
            fail(f"K6 output is not finite ({name})")
        if not ok:
            fail(f"K6 disagrees with its plain version beyond the golden "
                 f"criteria ({name})")
        if not torch.equal(got, k1):
            fail(f"K6's buffer is not K1's ({name}): max|Δ| {k1_err:.3g}")
        if name == "dist scene" and not (dist_max >= DIST_FLOOR
                                         and dist_rel <= DIST_REL):
            fail(f"K6's dist disagrees with its plain version: error "
                 f"{dist_rel:.4g} of max|dist_ref| {dist_max:.4g}")
        if name == "small" and not torch.allclose(got, ref, atol=2e-5,
                                                  rtol=1e-4):
            fail("K6 disagrees with its plain version at the small shape")
        max_err = max(max_err, *(r["max_abs"] for r in errs.values()))
        if name == "turntable":
            timed, t_seg = args, seg

    tab, pairs, starts, counts, bg, res, _ = timed
    chunk, tile = K6_CASES["turntable"][-1], 16
    ms = time_cuda(lambda: rasterize_cuda.composite_segments(
        t_seg, starts, counts, bg, res, res, chunk=chunk), reps=50)
    k1_ms = time_cuda(lambda: rasterize_cuda.composite(*timed, chunk=chunk),
                      reps=50)
    gather_ms = time_cuda(lambda: rz.segment_table(tab, pairs), reps=50)
    plain_ms = time_cuda(lambda: rz.composite_segments_plain(
        t_seg, starts, counts, bg, res, res, chunk=chunk), reps=5, warmup=1)
    steps = _pair_steps(*timed, chunk)
    n_tiles = (res // tile) ** 2
    # the rows of the executed slices below each tile's count, read once
    n_bytes = (steps * tab.shape[1] * 4 + 2 * n_tiles * 4 + 3 * 4
               + rz.N_OUT * res * res * 4)
    n_ops = steps * tile * tile * K1_OPS_PER_STEP
    print(f"[K6] turntable: {ms:.4f} ms (median of 50), K1 on the same "
          f"frame {k1_ms:.4f} ms, the table's gather {gather_ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms; pair steps {steps}, bytes {n_bytes}, "
          f"ops {n_ops}", flush=True)
    return _record("K6", "rasterize_v4_seg.cu",
                   "gaussiananything_tpu/ops/rasterize_pallas.py:966",
                   max_err, ms, plain_ms, n_bytes, n_ops)


# The list kernels' cases. name: (seed, n, kind, opacity, camera radius,
# pose, image size, tile, max_per_tile, chunk)
LIST_CASES = {
    # the bench shape (timed, and bounded)
    "bench": (0, 73728, "sphere", None, 1.8, (20, 45), 512, 16, 2048, 256),
    # the defaults of `rasterize_tiled_v2` and `rasterize_tiled_v3`
    "defaults": (0, 73728, "sphere", None, 1.8, (20, 45), 512, 8, 512, 128),
    "small": (0, 1024, "sphere", None, 1.8, (20, 45), 64, 16, 256, 64),
    # K3 with aux: the scene where dist stands above its fp32 floor
    "dist scene": (0, 73728, "sphere", 0.2, 0.6, (20, 45), 512, 16, 2048,
                   32),
}
LIST_ATOL, LIST_RTOL = 2e-5, 1e-4
# v1-v3 leave T <= 1e-4 unflushed, so their image over a white background
# keeps up to that much more than K1's
IMAGE_RESIDUE = 1.1e-4


def _list_inputs(dev, seed, n, kind, opacity, radius, pose, res, tile, mpt):
    """The list wrappers' inputs for one case: dense geom and feat, counts,
    and the tiles' pixel tables in natural order."""
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
    lists, counts = rz.build_tile_lists(sp, res, res, tile, mpt)
    geom, feat = rz.pack_tile_inputs(rz.pad_dead_splat(sp), lists)
    px, py = rz.tile_pixel_tables(
        torch.arange(counts.shape[0], device=dev), res // tile, tile)
    return geom.contiguous(), feat.contiguous(), counts, px, py


def _list_errors(got, ref, res, tile):
    """(T, P, 16) list-kernel outputs as maps over a white background: per
    map the largest error and the largest error over its limit LIST_ATOL +
    LIST_RTOL·|ref|. Median depth passes by flips: at most
    MEDIAN_FLIP_FRAC of the pixels beyond the limit, none beyond
    MEDIAN_FLIP_BOUND."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    bg = torch.ones(3, device=got.device)
    gm = rz.list_outputs(got, bg, res, res, tile)
    rm = rz.list_outputs(ref, bg, res, res, tile)
    errs, ok = {}, True
    for k in rm:
        d = (gm[k] - rm[k]).abs()
        over = d / (LIST_ATOL + LIST_RTOL * rm[k].abs())
        rec = {"max_abs": float(d.max()),
               "max_over_limit": float(f"{float(over.max()):.3g}")}
        if k == "depth_median":
            rec["frac_beyond"] = float((over > 1).double().mean())
            good = (rec["frac_beyond"] <= MEDIAN_FLIP_FRAC
                    and rec["max_abs"] <= MEDIAN_FLIP_BOUND)
        else:
            good = rec["max_over_limit"] <= 1
        ok &= good and bool(torch.isfinite(gm[k]).all())
        errs[k] = rec
    return ok, errs, gm


def _against_k1(dev, scene, chunk, maps, kernel, name):
    """A list kernel's maps against K1's on the same frame: the golden
    criteria on every map but the image, which keeps the residue of the
    unflushed transmittance (IMAGE_RESIDUE), and dist, which K4, K5 and K3
    without aux do not compute."""
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    seed, n, kind, opacity, radius, pose, res, _tile, mpt = scene
    k1 = rz.split_outputs(rasterize_cuda.composite(
        *_k1_inputs(dev, seed, n, kind, opacity, radius, pose, res, mpt),
        chunk=chunk))
    names = [k for k in GOLDEN_TOL if k not in ("image", "dist")]
    ok, errs = _golden_errors(maps, k1, names)
    image = float((maps["image"] - k1["image"]).abs().max())
    print(f"[{kernel}] {name} vs K1: image {image:.6g} (limit "
          f"{IMAGE_RESIDUE}), {json.dumps(errs, sort_keys=True)}",
          flush=True)
    if not (ok and image <= IMAGE_RESIDUE):
        fail(f"{kernel} disagrees with K1 ({name})")


def _live_levels(geom, feat, counts, px, py, chunk):
    """live[c] (T,) bool for every chunk level some tile reaches: whether
    the tile still has a pixel above T_EPS after c chunks, from the plain
    version on the counts cut at c·chunk."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    levels, live, c = [], torch.ones_like(counts, dtype=torch.bool), 0
    while bool((live & (counts > c * chunk)).any()):
        levels.append(live)
        c += 1
        trans = rz.composite_lists_plain(
            geom[:, :c * chunk], feat[:, :c * chunk],
            torch.clamp(counts, max=c * chunk), px, py, chunk)[..., 10]
        live = trans.amax(1) > 1e-4
    return levels


def _list_record(name, replaces, max_err, ms, plain_ms, steps, counts, P,
                 extra_bytes=0):
    """Bound of a list kernel: the 96 bytes of every (tile, pair) row its
    executed chunks read (the dense tables are mostly the dead row), the
    counts, the output; V1_OPS_PER_STEP for every (pixel, pair) step."""
    n_tiles = counts.shape[0]
    n_bytes = steps * 96 + n_tiles * 4 + n_tiles * P * 16 * 4 + extra_bytes
    n_ops = steps * P * V1_OPS_PER_STEP
    print(f"[{name}] bench: {ms:.4f} ms (median of 30), plain "
          f"{plain_ms:.2f} ms; pairs {int(counts.sum())}, executed pair "
          f"steps {steps}, bytes {n_bytes}, ops {n_ops}", flush=True)
    return _record(name, "rasterize_v1.cu", replaces, max_err, ms, plain_ms,
                   n_bytes, n_ops)


def _chunk_steps(counts, c, chunk):
    """(T,) pairs of chunk c below each tile's count."""
    import torch
    return torch.clamp(counts - c * chunk, min=0, max=chunk)


def k3_phase(dev):
    """K3 with and without aux against `composite_lists_plain` on the card
    at the bench shape, a small shape and, with aux, the dist scene (dist to
    DIST_REL of its size); against K1 at the bench shape; the gradient of
    `rasterize_tiled_v1_fused` against the plain route's. Timed at the
    bench shape, in turns with K4 and K5 on the same frame."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda

    max_err = 0.0
    for name, auxes in (("bench", (False, True)), ("small", (False, True)),
                        ("dist scene", (True,))):
        *scene, chunk = LIST_CASES[name]
        res, tile = scene[6], scene[7]
        geom, feat, counts, px, py = _list_inputs(dev, *scene)
        for aux in auxes:
            got = rasterize_cuda.composite_lists(
                geom, feat, counts, res // tile, tile, chunk, with_aux=aux)
            ref = rz.composite_lists_plain(geom, feat, counts, px, py, chunk,
                                           with_aux=aux)
            torch.cuda.synchronize()
            ok, errs, maps = _list_errors(got, ref, res, tile)
            dist_max = float(ref[..., 6].abs().max())
            dist_rel = errs["dist"]["max_abs"] / max(dist_max, 1e-30)
            print(f"[K3] {name} aux={aux} ({scene[1]} splats, {res}², tile "
                  f"{tile}, max_per_tile {scene[8]}, chunk {chunk}) vs "
                  f"plain, limit {LIST_ATOL} + {LIST_RTOL}·|ref|: "
                  f"{json.dumps(errs, sort_keys=True)}; max|dist_ref| "
                  f"{dist_max:.4g}, dist error / max|dist_ref| "
                  f"{dist_rel:.4g}", flush=True)
            if not ok:
                fail(f"K3 disagrees with its plain version ({name}, "
                     f"aux={aux})")
            if not aux and float(got[..., 6].abs().max()) != 0.0:
                fail("K3 without aux wrote a dist")
            if name == "dist scene" and not (dist_max >= DIST_FLOOR
                                             and dist_rel <= DIST_REL):
                fail(f"K3's dist disagrees with its plain version: error "
                     f"{dist_rel:.4g} of max|dist_ref| {dist_max:.4g}")
            max_err = max(max_err, *(r["max_abs"] for r in errs.values()))
            if name == "bench":
                _against_k1(dev, scene, chunk, maps, "K3", f"aux={aux}")
        if name == "bench":
            timed = (geom, feat, counts, px, py, res, tile, chunk)

    for case in ("small", "train 256"):
        *scene, chunk = K2_CASES[case]
        got = _surfel_gradient(dev, scene, chunk, "v1_fused", DIST_WEIGHT)
        ref = _surfel_gradient(dev, scene, chunk, "plain", DIST_WEIGHT)
        peak = float(ref.abs().max())
        print(f"[K3] rasterize_tiled_v1_fused gradient, {case}: error / "
              f"max|g| {_grad_rel(got, ref):.3g}, max|g| {peak:.4g}",
              flush=True)
        if not torch.allclose(got, ref, rtol=2e-3, atol=2e-4 * peak):
            fail(f"rasterize_tiled_v1_fused's gradient disagrees with the "
                 f"plain route's ({case})")

    geom, feat, counts, px, py, res, tile, chunk = timed
    run = functools.partial(rasterize_cuda.composite_lists, geom, feat,
                            counts, res // tile, tile, chunk)
    ms = time_cuda(run, reps=30)
    aux_ms = time_cuda(lambda: run(with_aux=True), reps=30)
    # K4 and K5 (group 16) on the same frame, in turns with K3
    order = torch.sort(-counts, stable=True).indices
    cs = counts[order]
    k4_args = (cs.reshape(-1, 16).amax(1).int().contiguous(),
               geom[order].contiguous(), feat[order].contiguous(),
               px[order].contiguous(), py[order].contiguous(),
               cs.float()[:, None].contiguous())
    k4_ms = time_cuda(lambda: rasterize_cuda.composite_lists_grouped(
        *k4_args, 16, chunk), reps=30)
    k5_ms = time_cuda(lambda: rasterize_cuda.composite_lists_unrolled(
        geom, feat, counts, res // tile, tile, chunk, 16), reps=30)
    again_ms = time_cuda(run, reps=30)
    print(f"[K3] bench, medians of 30 in turns: K3 {ms:.4f} ms (with aux "
          f"{aux_ms:.4f}), K4 {k4_ms:.4f}, K5 {k5_ms:.4f}, K3 again "
          f"{again_ms:.4f}", flush=True)
    plain_ms = time_cuda(lambda: rz.composite_lists_plain(
        geom, feat, counts, px, py, chunk), reps=3, warmup=1)
    steps = sum(int(_chunk_steps(counts, c, chunk)[live].sum()) for c, live
                in enumerate(_live_levels(geom, feat, counts, px, py, chunk)))
    return _list_record("K3",
                        "gaussiananything_tpu/ops/rasterize_pallas.py:59",
                        max_err, ms, plain_ms, steps, counts, tile * tile)


def _equal_to_k3(kernel, name, got, again, k3):
    """A list kernel's output (natural order) against K3's without aux, bit
    for bit, and against its own second run."""
    import torch
    same = bool(torch.equal(got, k3))
    print(f"[{kernel}] {name}: equal to K3 bit for bit {same}, max|Δ| "
          f"{float((got - k3).abs().max()):.3g}; two runs bit-equal "
          f"{bool(torch.equal(got, again))}", flush=True)
    if not same:
        fail(f"{kernel} is not K3 bit for bit ({name})")
    if not torch.equal(got, again):
        fail(f"{kernel}'s two runs differ ({name})")


def _defaults_times(kernel, run, k3_run):
    """The kernel and K3, its control, at the defaults shape: medians of 30,
    in turns."""
    k3_a = time_cuda(k3_run, reps=30)
    ms = time_cuda(run, reps=30)
    k3_b = time_cuda(k3_run, reps=30)
    print(f"[{kernel}] defaults: {ms:.4f} ms (median of 30), K3 beside it "
          f"{k3_a:.4f} and {k3_b:.4f} ms", flush=True)


def k4_phase(dev):
    """K4 against `composite_lists_plain` on the card, on count-sorted
    groups as `rasterize_tiled_v2` forms them: the bench shape (group 16),
    the defaults of `rasterize_tiled_v2` (tile 8, max_per_tile 512, chunk
    128, group 16) and a small shape; dist exactly 0; equal to K3 (aux off)
    bit for bit and to its own second run in every case; against K1 at the
    bench shape. Timed at the bench shape, and beside K3 at the defaults."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda

    max_err = 0.0
    for name, group in (("bench", 16), ("defaults", 16), ("small", 4)):
        *scene, chunk = LIST_CASES[name]
        res, tile = scene[6], scene[7]
        geom, feat, counts, px, py = _list_inputs(dev, *scene)
        order = torch.sort(-counts, stable=True).indices
        inv = torch.sort(order, stable=True).indices
        counts_s = counts[order]
        args = (counts_s.reshape(-1, group).amax(1).int().contiguous(),
                geom[order], feat[order], px[order], py[order],
                counts_s.float()[:, None].contiguous())
        got = rasterize_cuda.composite_lists_grouped(*args, group, chunk)
        again = rasterize_cuda.composite_lists_grouped(*args, group, chunk)
        k3_run = functools.partial(rasterize_cuda.composite_lists, geom,
                                   feat, counts, res // tile, tile, chunk)
        k3 = k3_run()
        ref = rz.composite_lists_plain(args[1], args[2], counts_s, args[3],
                                       args[4], chunk)
        torch.cuda.synchronize()
        ok, errs, maps = _list_errors(got[inv], ref[inv], res, tile)
        cluster = rasterize_cuda.cluster_size(
            group, rasterize_cuda.cluster_limit(tile * tile, chunk))
        print(f"[K4] {name} ({scene[1]} splats, {res}², tile {tile}, "
              f"max_per_tile {scene[8]}, chunk {chunk}, group {group}, "
              f"clusters of {cluster}) vs plain, limit {LIST_ATOL} + "
              f"{LIST_RTOL}·|ref|: {json.dumps(errs, sort_keys=True)}",
              flush=True)
        if group == 16 and cluster != 16:
            fail(f"K4 runs a group of 16 as clusters of {cluster} ({name})")
        _equal_to_k3("K4", name, got[inv], again[inv], k3)
        if name == "defaults":
            _defaults_times("K4", lambda a=args, g=group, c=chunk:
                            rasterize_cuda.composite_lists_grouped(
                                *a, g, c), k3_run)
        if not ok:
            fail(f"K4 disagrees with its plain version ({name})")
        if float(got[..., 6].abs().max()) != 0.0:
            fail("K4 wrote a dist")
        max_err = max(max_err, *(r["max_abs"] for r in errs.values()))
        if name == "bench":
            _against_k1(dev, scene, chunk, maps, "K4", name)
            timed = (args, counts_s, group, tile, chunk)

    args, counts_s, group, tile, chunk = timed
    gmax, geom, feat, px, py, _ = args
    ms = time_cuda(lambda: rasterize_cuda.composite_lists_grouped(
        *args, group, chunk), reps=30)
    plain_ms = time_cuda(lambda: rz.composite_lists_plain(
        geom, feat, counts_s, px, py, chunk), reps=3, warmup=1)
    steps = 0
    for c, live in enumerate(_live_levels(geom, feat, counts_s, px, py,
                                          chunk)):
        runs = live.reshape(-1, group).any(1) & (c * chunk < gmax)
        steps += int((_chunk_steps(counts_s, c, chunk).reshape(-1, group)
                      .sum(1) * runs).sum())
    # K4 also reads the pixel tables, the float counts and gmax
    extra = px.numel() * 8 + counts_s.numel() * 4 + gmax.numel() * 4
    return _list_record("K4",
                        "gaussiananything_tpu/ops/rasterize_pallas.py:346",
                        max_err, ms, plain_ms, steps, counts_s, tile * tile,
                        extra)


def k5_phase(dev):
    """K5 against `composite_lists_plain` on the card: the bench shape
    (group 16), the defaults of `rasterize_tiled_v3` (tile 8, max_per_tile
    512, chunk 128, group 8) and a small shape; dist exactly 0; equal to K3
    (aux off) bit for bit and to its own second run in every case; against
    K1 at the bench shape. Timed at the bench shape, and beside K3 at the
    defaults."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda

    max_err = 0.0
    for name, group in (("bench", 16), ("defaults", 8), ("small", 4)):
        *scene, chunk = LIST_CASES[name]
        res, tile = scene[6], scene[7]
        geom, feat, counts, px, py = _list_inputs(dev, *scene)
        run = functools.partial(rasterize_cuda.composite_lists_unrolled,
                                geom, feat, counts, res // tile, tile, chunk,
                                group)
        got, again = run(), run()
        k3_run = functools.partial(rasterize_cuda.composite_lists, geom,
                                   feat, counts, res // tile, tile, chunk)
        k3 = k3_run()
        ref = rz.composite_lists_plain(geom, feat, counts, px, py, chunk)
        torch.cuda.synchronize()
        ok, errs, maps = _list_errors(got, ref, res, tile)
        print(f"[K5] {name} ({scene[1]} splats, {res}², tile {tile}, "
              f"max_per_tile {scene[8]}, chunk {chunk}, group {group}) vs "
              f"plain, limit {LIST_ATOL} + {LIST_RTOL}·|ref|: "
              f"{json.dumps(errs, sort_keys=True)}", flush=True)
        _equal_to_k3("K5", name, got, again, k3)
        if name == "defaults":
            _defaults_times("K5", run, k3_run)
        if not ok:
            fail(f"K5 disagrees with its plain version ({name})")
        if float(got[..., 6].abs().max()) != 0.0:
            fail("K5 wrote a dist")
        max_err = max(max_err, *(r["max_abs"] for r in errs.values()))
        if name == "bench":
            _against_k1(dev, scene, chunk, maps, "K5", name)
            timed = (geom, feat, counts, px, py, res, tile, chunk, group)

    geom, feat, counts, px, py, res, tile, chunk, group = timed
    ms = time_cuda(lambda: rasterize_cuda.composite_lists_unrolled(
        geom, feat, counts, res // tile, tile, chunk, group), reps=30)
    plain_ms = time_cuda(lambda: rz.composite_lists_plain(
        geom, feat, counts, px, py, chunk), reps=3, warmup=1)
    # K5 has no saturation test: every pair below the counts is a step
    return _list_record("K5",
                        "gaussiananything_tpu/ops/rasterize_pallas.py:555",
                        max_err, ms, plain_ms, int(counts.sum()), counts,
                        tile * tile)


def _stage_check(name, got, ref):
    """A stage kernel's output against `stage_plain`'s; returns max|Δ|."""
    import torch
    err = float((got - ref).abs().max())
    if not (torch.isfinite(got).all() and torch.allclose(
            got, ref, atol=LIST_ATOL, rtol=LIST_RTOL)):
        fail(f"{name} disagrees with its plain version: max|Δ| "
             f"{err:.3g} of max|ref| {float(ref.abs().max()):.3g}")
    return err


def stages_phase(dev):
    """The eight stage instantiations (stage 0-3, row- and field-major)
    against `stage_plain` on the card, to atol 2e-5 / rtol 1e-4, on seeded
    splats at the shape of `tools/kernel_stages.py` and on its witness
    scene (`make_witness`: tile 0 saturates at the end of chunk 1 while
    its group runs on, where a per-tile exit would differ beyond the
    tolerance; printed for stages 2 and 3); each timed and bounded by the
    chunks its groups execute on the seeded scene."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    from gaussiananything_tpu_torch.tools import kernel_stages as ks

    gmax, *row = ks.make_inputs(1, dev)
    w_gmax, *w_row = ks.make_witness(1, dev)
    n_tiles, M, _ = row[0].shape
    P = row[2].shape[1]
    records = []
    for field in (False, True):
        args = ks.to_field_major(*row) if field else tuple(row)
        w_args = ks.to_field_major(*w_row) if field else tuple(w_row)
        for stage in range(4):
            def run(fn, g=gmax, a=args, group=ks.G):
                return fn(stage, g, *a, group, ks.CHUNK, field_major=field)
            name = f"B{2 if field else 1}.{stage}"
            got, ref = run(rasterize_cuda.stage), run(rz.stage_plain)
            torch.cuda.synchronize()
            err = _stage_check(name, got, ref)
            w_got = run(rasterize_cuda.stage, w_gmax, w_args)
            w_ref = run(rz.stage_plain, w_gmax, w_args)
            w_err = _stage_check(f"{name} (witness)", w_got, w_ref)
            # the per-tile exit the kernel must not take: tile 0's T
            twin = run(rz.stage_plain, w_gmax.repeat_interleave(ks.G),
                       w_args, 1)
            pick = (lambda x: x[0, 0]) if field else (lambda x: x[0, :, 0])
            gap = float((pick(twin) - pick(w_ref)).abs().max())
            print(f"[stages] {name} witness: max|Δ| {w_err:.3g}; a per-tile "
                  f"exit would differ on tile 0's T by {gap:.3g}", flush=True)
            if stage >= 2 and gap <= LIST_ATOL:
                fail(f"the witness scene does not witness the group test "
                     f"({name}: {gap:.3g})")
            ms = time_cuda(lambda: run(rasterize_cuda.stage), reps=20)
            plain_ms = time_cuda(lambda: run(rz.stage_plain), reps=3,
                                 warmup=1)
            # a group runs chunk c while c·chunk < gmax and, after the c
            # chunks before it, some pixel of it is above the threshold
            steps = 0
            for c in range(M // ks.CHUNK):
                live = torch.ones_like(gmax, dtype=torch.bool)
                if c:
                    cut = c * ks.CHUNK
                    st = rz.stage_plain(stage, gmax, row[0][:, :cut],
                                        row[1][:, :cut], row[2], row[3],
                                        ks.G, ks.CHUNK)
                    live = st[..., 0].reshape(len(gmax), -1).amax(1) > 1e-4
                steps += int((live & (c * ks.CHUNK < gmax)).sum()) \
                    * ks.G * ks.CHUNK
            n_bytes = (steps * 96 + 2 * n_tiles * P * 4 + len(gmax) * 4
                       + n_tiles * P * 16 * 4)
            n_ops = steps * P * STAGE_OPS_PER_STEP[stage]
            print(f"[stages] {name} ({'field' if field else 'row'}-major, "
                  f"{len(gmax)} groups of {ks.G} tiles of {P} pixels, "
                  f"{M // ks.CHUNK} chunks of {ks.CHUNK}): max|Δ| {err:.3g} "
                  f"of max|ref| {float(ref.abs().max()):.4g} (limit "
                  f"{LIST_ATOL} + {LIST_RTOL}·|ref|); {ms:.4f} ms, plain "
                  f"{plain_ms:.2f} ms, executed pair steps {steps}",
                  flush=True)
            tool = "tools/pallas_bisect2.py:30" if field else \
                "tools/pallas_bisect.py:25"
            records.append(_record(name, "rasterize_v1.cu", tool,
                                   max(err, w_err), ms, plain_ms, n_bytes,
                                   n_ops))
    return records


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
    _reset_launches()
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


SMALL_W = 64


def _rel_err(got, ref) -> float:
    """max|got − ref| over max(max|ref|, 1), on the CPU."""
    ref = ref.float().cpu()
    return float((got.float().cpu() - ref).abs().max()) / max(
        float(ref.abs().max()), 1.0)


def small_serving_phase(dev):
    """The serving modules at small widths on the card against the same
    weights and inputs on the CPU: the text conditioners (bytes, OpenCLIP)
    and the scratch image conditioner to 1e-4 of their scale, `u2netp` at
    64² and `matting_alpha` to 1e-4, `integrate_tsdf` to 2e-5; a
    text-conditioned `sample_request` (the t23d release layout, 2 Heun
    steps) with the mesh, stage outputs to 1e-3 of their scale, LoDs to 1e-3, the meshes'
    vertex counts within 5% and mean radii within 0.02; and the bf16
    cascade against the card's own fp32 one stage by stage (each stage on
    the fp32 stage's input), within 0.05·max(scale, 1) (latents) and 0.05
    (LoDs, which are fp32)."""
    import copy
    import numpy as np
    import torch
    from gaussiananything_tpu_torch.cli.sample import (ReleaseModels,
                                                       sample_request)
    from gaussiananything_tpu_torch.config import RenderConfig
    from gaussiananything_tpu_torch.models.conditioner import (
        ImageConditioner, TextConditioner, tokenize_bytes)
    from gaussiananything_tpu_torch.models.dit import PointDiT
    from gaussiananything_tpu_torch.models.matting import (matting_alpha,
                                                           u2netp)
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.render.tsdf import integrate_tsdf
    from gaussiananything_tpu_torch.train.fm_trainer import (FMConfig,
                                                             make_sampler)
    errs = {}
    torch.manual_seed(0)
    ids = torch.from_numpy(tokenize_bytes(["a wooden chair"])).long()
    img = torch.rand((2, 3, 56, 56))
    for name, mod, x in (
            ("text bytes", TextConditioner(SMALL_W, 2, 4), ids),
            ("text openclip", TextConditioner(SMALL_W, 2, 4,
                                              backbone="openclip"), ids),
            ("scratch image", ImageConditioner(SMALL_W, 2, 4, img_size=56,
                                               backbone="scratch"), img)):
        mod.eval()
        with torch.no_grad():
            ref = mod(x)
            got = copy.deepcopy(mod).to(dev)(x.to(dev))
        errs[name] = max(_rel_err(a, b) for a, b in zip(got, ref))
    net = u2netp().eval()
    x = torch.rand((1, 3, 64, 64))
    with torch.no_grad():
        ref = net(x)
        net_dev = copy.deepcopy(net).to(dev)
        errs["u2netp"] = _rel_err(net_dev(x.to(dev)), ref)
    photo = torch.rand((80, 72, 3))
    errs["matting_alpha"] = _rel_err(
        matting_alpha(net_dev, photo.to(dev), res=64),
        matting_alpha(net, photo, res=64))
    r = np.random.default_rng(0)
    V, H, W, D = 4, 33, 31, 48
    depth = torch.from_numpy((1.5 + 0.3 * r.random((V, 1, H, W)))
                             .astype(np.float32))
    rgb = torch.from_numpy(r.random((V, 3, H, W)).astype(np.float32))
    alpha = torch.from_numpy((r.random((V, 1, H, W)) > 0.2)
                             .astype(np.float32))
    cv = torch.eye(4).repeat(V, 1, 1)
    cv[:, 3, 2] = 2.0 + 0.1 * torch.arange(V)
    ref = integrate_tsdf(depth, rgb, alpha, cv, 0.6, resolution=D)
    got = integrate_tsdf(depth.to(dev), rgb.to(dev), alpha.to(dev),
                         cv.to(dev), 0.6, resolution=D)
    errs["integrate_tsdf"] = max(float((a.cpu() - b).abs().max())
                                 for a, b in zip(got, ref))

    # a text-conditioned request with the mesh, t23d release layout
    K, ZC = 12, 10
    dk = dict(width=SMALL_W, depth=2, heads=4, cond_dim=SMALL_W,
              vector_dim=SMALL_W, variant="text")
    cpu = ReleaseModels(
        cond=TextConditioner(SMALL_W, 2, 4, backbone="openclip"),
        dit1=PointDiT(in_channels=3, **dk),
        dit2=PointDiT(in_channels=ZC, use_xyz_pe=True, **dk),
        vae=PointVAE(latent_num=K, decoder_width=SMALL_W, decoder_depth=2,
                     decoder_heads=2))
    for m in (cpu.cond, cpu.dit1, cpu.dit2, cpu.vae):
        m.eval()
    card = ReleaseModels(*(copy.deepcopy(m).to(dev) for m in
                           (cpu.cond, cpu.dit1, cpu.dit2, cpu.vae)))
    g = torch.Generator().manual_seed(1)
    x0 = (torch.randn((1, K, 3), generator=g),
          torch.randn((1, K, ZC), generator=g))
    fm1 = FMConfig(stage=1, cfg_scale=4.5, num_steps=2, sampler="heun")
    fm2 = dataclasses.replace(fm1, stage=2)
    rcfg = RenderConfig(output_size=64, max_per_tile=256, chunk=64)
    mesh = dict(resolution=48, n_views=4, render_size=64)
    quiet = dict(log=lambda s: None, mesh=mesh)
    ref = sample_request(cpu, ids, fm1, fm2, rcfg, x0_stage1=x0[0],
                         x0_stage2=x0[1], **quiet)
    got = sample_request(card, ids.to(dev), fm1, fm2, rcfg,
                         x0_stage1=x0[0].to(dev), x0_stage2=x0[1].to(dev),
                         **quiet)
    for k in ("xyz_n", "kl"):
        errs[f"t23d {k}"] = float((got[k].cpu() - ref[k]).abs().max()) \
            / float(ref[k].abs().max())
    errs["t23d lods"] = max(float((a.cpu() - b).abs().max())
                            for a, b in zip(got["lods"], ref["lods"]))
    (gv, gf, _), (rv, rf, _) = got["mesh"], ref["mesh"]
    counts = (len(gv), len(rv))
    radii = (float(np.linalg.norm(gv, axis=1).mean()) if len(gv) else 0.0,
             float(np.linalg.norm(rv, axis=1).mean()) if len(rv) else 0.0)

    # bf16 against the card's own fp32, stage by stage with the handoff
    # pinned to the fp32 one: stage 2 reads sin/cos of xyz at up to 2⁹ per
    # unit, so bf16's stage-1 difference alone would move it by far more
    # than the bf16 arithmetic of the stage itself
    def bf16(make, src):
        """`cli/sample.py --bf16`'s modules: bf16 compute, the restored
        weights then cast to bf16."""
        with torch.device(dev):
            m = make(dtype=torch.bfloat16).eval()
        m.load_state_dict(src.state_dict())
        return m.to(torch.bfloat16)

    c16 = bf16(functools.partial(TextConditioner, SMALL_W, 2, 4,
                                 backbone="openclip"), card.cond)
    d116 = bf16(functools.partial(PointDiT, in_channels=3, **dk), card.dit1)
    d216 = bf16(functools.partial(PointDiT, in_channels=ZC,
                                  use_xyz_pe=True, **dk), card.dit2)
    v16 = bf16(functools.partial(PointVAE, latent_num=K,
                                 decoder_width=SMALL_W, decoder_depth=2,
                                 decoder_heads=2), cpu.vae)
    ids_d = ids.to(dev)
    xyz32 = got["xyz"][None]
    got16 = {
        "xyz_n": make_sampler(d116, c16, fm1, (K, 3))(ids_d,
                                                     x0=x0[0].to(dev)),
        "kl": make_sampler(d216, c16, fm2, (K, ZC))(
            ids_d, xyz=xyz32 / 0.45, x0=x0[1].to(dev))}
    with torch.no_grad():
        got16["lods"] = v16.decode(got["kl"], xyz32)
    for k in ("xyz_n", "kl"):
        errs[f"bf16 {k}"] = _rel_err(got16[k], got[k])
    errs["bf16 lods"] = max(float((a - b).abs().max())
                            for a, b in zip(got16["lods"], got["lods"]))
    lods_fp32 = all(x.dtype == torch.float32 for x in got16["lods"])
    print(f"[small serving] card vs CPU (bf16 vs the card's fp32): "
          f"{json.dumps(errs, sort_keys=True)}; mesh vertices card/CPU "
          f"{counts}, mean radius {radii[0]:.4f}/{radii[1]:.4f}; bf16 LoDs "
          f"fp32: {lods_fp32}", flush=True)
    bounds = {"text bytes": 1e-4, "text openclip": 1e-4,
              "scratch image": 1e-4, "u2netp": 1e-4, "matting_alpha": 1e-4,
              "integrate_tsdf": 2e-5, "t23d xyz_n": 1e-3, "t23d kl": 1e-3,
              "t23d lods": 1e-3, "bf16 xyz_n": 0.05, "bf16 kl": 0.05,
              "bf16 lods": 0.05}
    bad = {k: v for k, v in errs.items() if not v <= bounds[k]}
    if bad:
        fail(f"small serving beyond its bounds: {bad}")
    if not (min(counts) > 0 and abs(counts[0] - counts[1]) <= 0.05
            * counts[1] and abs(radii[0] - radii[1]) <= 0.02):
        fail(f"the small request's meshes differ: vertices {counts}, mean "
             f"radii {radii}")
    if not lods_fp32:
        fail("the bf16 decode handed the renderer non-fp32 gaussians")


SERVE_STEPS = 10


def serving_phase(dev):
    """The rest of the serving path at release width, on seeded random
    weights and 10 Heun steps (the release takes 250):

    1. `cli/sample.py --release --full --text ... --mesh --num 1`: the
       OpenCLIP ViT-L/14 tower, the t23d DiT-Ls, the decode, the turntable
       and the 176³ mesh; K1 launched exactly 8 + MESH_VIEWS times (no
       demo image: the text path renders none);
    2. `--image-dir D --bf16 --num 2` on two PNGs written here; K1 exactly
       2 × 8 times, and every splat table reaching K1's wrapper fp32;
    3. `cli/serve.py --release` in a thread on port 0 with stage-2 and
       VAE checkpoints written by the port's `save_checkpoint` and a
       seeded U²-Net npz in the JAX layout; a multipart and a raw POST,
       their JSON, assets and /health; K1 launched 0 times.

    Prints each request's seconds by stage and the mesh's."""
    with tempfile.TemporaryDirectory() as root:
        return _serving_run(dev, root)


def _serving_run(dev, root):
    import numpy as np
    import torch
    from PIL import Image
    from gaussiananything_tpu_torch.cli import sample
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    launches = {}
    common = ["--release", "--full", "--steps", str(SERVE_STEPS), "--seed",
              "0", "--device", str(dev)]

    _reset_launches()
    t0 = time.perf_counter()
    (res,) = sample.main(common + ["--text", "a wooden chair", "--mesh",
                                   "--num", "1", "--out",
                                   os.path.join(root, "t23d")])
    wall = time.perf_counter() - t0
    n = rasterize_cuda.composite.launches
    launches["K1"] = n
    print(f"[serving] t23d + mesh: wall {wall:.2f}s (model build "
          f"included); seconds {json.dumps(res['timings'])}; K1 {n}; mesh "
          f"{len(res['mesh'][0])} vertices, {len(res['mesh'][1])} faces",
          flush=True)
    if n != 8 + MESH_VIEWS:
        fail(f"the t23d request launched K1 {n} times, expected 8 + "
             f"{MESH_VIEWS}")
    _check_request(res, "t23d")
    verts, faces, _ = res["mesh"]
    if not (len(verts) > 100 and np.isfinite(verts).all()
            and faces.max() < len(verts)):
        fail(f"the t23d mesh is malformed: {len(verts)} vertices")
    if not os.path.getsize(os.path.join(root, "t23d", "mesh_0.glb")):
        fail("mesh_0.glb is empty")

    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir)
    r = np.random.default_rng(0)
    for i in range(2):
        a = np.full((600, 520, 3), 235, np.uint8)
        a[120 + 40 * i:460, 100:420] = r.integers(20, 200, (340 - 40 * i,
                                                             320, 3))
        Image.fromarray(a).save(os.path.join(img_dir, f"view_{i}.png"))
    # the splat tables `rasterize_tiled` builds and hands to K1's wrapper
    dtypes = set()
    real_table = rz.splat_table

    def watched(*args, **kw):
        tab = real_table(*args, **kw)
        dtypes.add(tab.dtype)
        return tab

    _reset_launches()
    rz.splat_table = watched
    try:
        t0 = time.perf_counter()
        results = sample.main(common + ["--image-dir", img_dir, "--bf16",
                                        "--num", "2", "--out",
                                        os.path.join(root, "bf16")])
    finally:
        rz.splat_table = real_table
    wall = time.perf_counter() - t0
    n = rasterize_cuda.composite.launches
    launches["K1"] += n
    for i, res in enumerate(results):
        print(f"[serving] bf16 image-dir request {i} seconds: "
              f"{json.dumps(res['timings'])}", flush=True)
        _check_request(res, f"bf16 {i}")
    print(f"[serving] bf16 image-dir: wall {wall:.2f}s; K1 {n}; splat "
          f"tables reaching K1: {sorted(str(d) for d in dtypes)}",
          flush=True)
    if n != 2 * 8:
        fail(f"the bf16 requests launched K1 {n} times, expected 2 x 8")
    if dtypes != {torch.float32}:
        fail(f"K1 was handed splat tables of {dtypes} under --bf16")
    if not all(x.dtype == torch.float32 for res in results
               for x in res["lods"]):
        fail("the bf16 decode's gaussians are not fp32")

    _reset_launches()
    _serve_run(dev, root)
    n = rasterize_cuda.composite.launches
    print(f"[serving] server: K1 {n}", flush=True)
    if n != 0:
        fail(f"the server launched K1 {n} times; it renders nothing")
    return launches


def _check_request(res, name):
    import torch
    lods = res["lods"]
    if [tuple(x.shape) for x in lods] != [(1, n, 13) for n in
                                          (768, 6144, 24576, 73728)]:
        fail(f"{name}: LoD shapes {[tuple(x.shape) for x in lods]}")
    for x in (res["xyz_n"], res["kl"], *lods, *res["render"].values()):
        if not torch.isfinite(x.float()).all():
            fail(f"{name}: non-finite values in the outputs")
    if float((res["render"]["alpha"] > 1e-3).float().mean()) <= 0:
        fail(f"{name}: the turntable is empty")


def _seeded_u2net_npz(path: str, seed: int = 0):
    """Full U²-Net weights drawn from `seed` by numpy (He-scaled kernels,
    zero biases, BatchNorm with unit scale, zero mean and unit variance),
    written in the JAX package's npz layout: params/stageN/<block>/conv_s1/
    {kernel, bias} (HWIO), params/stageN/<block>/bn_{scale,bias,mean,var},
    params/sideN and params/outconv."""
    import numpy as np
    from gaussiananything_tpu_torch.models.matting import REBNCONV, u2net
    from gaussiananything_tpu_torch.utils.param_io import save_params_npz
    r = np.random.default_rng(seed)

    def conv(c):
        o, i, kh, kw = c.weight.shape
        return {"kernel": (r.standard_normal((kh, kw, i, o))
                           * math.sqrt(2.0 / (kh * kw * i)))
                .astype(np.float32), "bias": np.zeros(o, np.float32)}

    tree = {}
    for name, m in u2net().named_modules():
        node = tree
        if isinstance(m, REBNCONV):
            *parents, leaf = name.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            ch = m.conv_s1.weight.shape[0]
            node[leaf] = {"conv_s1": conv(m.conv_s1),
                          "bn_scale": np.ones(ch, np.float32),
                          "bn_bias": np.zeros(ch, np.float32),
                          "bn_mean": np.zeros(ch, np.float32),
                          "bn_var": np.ones(ch, np.float32)}
        elif name.startswith("side") or name == "outconv":
            tree[name] = conv(m)
    save_params_npz(path, {"params": tree})


def _serve_run(dev, root):
    import threading
    import urllib.request
    import torch
    from PIL import Image
    import numpy as np
    from gaussiananything_tpu_torch.cli import serve
    from gaussiananything_tpu_torch.config import preset, release_config
    from gaussiananything_tpu_torch.models.dit import stage2_dit_release
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        save_checkpoint)
    cfg = release_config(preset("demo-e2e"))
    t0 = time.perf_counter()
    torch.manual_seed(5)
    paths = {}
    for name, make in (("stage2", stage2_dit_release),
                       ("vae", lambda: PointVAE.from_config(cfg.vae))):
        with torch.device(dev):
            state = TrainState.create(make())
        paths[name] = os.path.join(root, f"ckpt_{name}")
        save_checkpoint(paths[name], state)
        del state
    paths["u2net"] = os.path.join(root, "u2net.npz")
    _seeded_u2net_npz(paths["u2net"])
    t_ckpt = time.perf_counter() - t0
    srv = serve.make_server(serve.parse_args([
        "--release", "--stage2-ckpt", paths["stage2"], "--vae-ckpt",
        paths["vae"], "--matting-ckpt", paths["u2net"], "--steps",
        str(SERVE_STEPS), "--host", "127.0.0.1", "--port", "0",
        "--assets", os.path.join(root, "assets"), "--device", str(dev)]))
    t_build = time.perf_counter() - t0 - t_ckpt
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    base = "http://127.0.0.1:%d" % srv.server_address[1]

    def get(url, data=None, headers=None):
        req = urllib.request.Request(base + url, data=data,
                                     headers=headers or {})
        with opener.open(req, timeout=600) as resp:
            return resp.status, resp.read()

    try:
        code, body = get("/health")
        if code != 200 or json.loads(body)["status"] != "ok":
            fail(f"/health answered {code} {body!r}")
        code, body = get("/")
        if code != 200 or b"/generate" not in body:
            fail("/ did not serve the upload form")
        a = np.full((480, 400, 3), 30, np.uint8)
        a[100:380, 90:310] = np.random.default_rng(1).integers(
            100, 255, (280, 220, 3))
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG")
        png = buf.getvalue()
        form = (b"--SMOKE\r\nContent-Disposition: form-data; "
                b"name=\"image\"; filename=\"a.png\"\r\n"
                b"Content-Type: image/png\r\n\r\n" + png
                + b"\r\n--SMOKE--\r\n")
        outs = []
        for label, data, ctype in (
                ("multipart", form, "multipart/form-data; boundary=SMOKE"),
                ("raw", png, "image/png")):
            t1 = time.perf_counter()
            code, body = get("/generate?seed=3", data,
                             {"Content-Type": ctype})
            out = json.loads(body)
            print(f"[serving] server POST ({label}): {code}, round trip "
                  f"{time.perf_counter() - t1:.2f}s, latency_s "
                  f"{out.get('latency_s')}, seconds "
                  f"{json.dumps(out.get('timings'))}", flush=True)
            if code != 200 or out.get("n_points") != 768 \
                    or out.get("n_gaussians") != 73728 \
                    or out.get("seed") != 3:
                fail(f"/generate ({label}) answered {code} {out}")
            for key in ("stage1_ply", "stage1_glb", "gaussians_ply"):
                code, asset = get(out[key])
                if code != 200 or not asset:
                    fail(f"{out[key]} answered {code}, {len(asset)} bytes")
            outs.append(out)
        print(f"[serving] server: checkpoints and U²-Net npz written in "
              f"{t_ckpt:.2f}s, pipeline built in {t_build:.2f}s", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    return outs


def _launch_counters():
    """{kernel name: (object, attribute or key)} of every wrapper's count."""
    from gaussiananything_tpu_torch.ops import rasterize_cuda as rc
    counters = {"K1": rc.composite, "K2a": rc.composite_entries,
                "K2b": rc.composite_backward, "K6": rc.composite_segments,
                "K3": rc.composite_lists, "K4": rc.composite_lists_grouped,
                "K5": rc.composite_lists_unrolled}
    return counters, rc.stage.launches


def _reset_launches():
    counters, stages = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    for key in stages:
        stages[key] = 0


def _read_launches():
    counters, stages = _launch_counters()
    out = {name: fn.launches for name, fn in counters.items()}
    out.update({f"B{2 if field else 1}.{stage}": n
                for (stage, field), n in sorted(stages.items(),
                                                key=lambda kv: kv[0][::-1])})
    return out


TOOLS_ITERS = 5


def raster_tools_phase(dev):
    """The rasterizer's own entry points at the release shape (512², 73,728
    splats, tile 16, max_per_tile 2048, chunk 256, group 16), as a user
    runs them: the timing tool with `--all` (every entry point's forward frame,
    forward + backward of the training route, the A/B of the two v4 feeds),
    the bench (8 batches of 20 frames) and the stage tool. Launch counts
    are set to 0 just before and read just after, and must be what the
    arguments predict."""
    from gaussiananything_tpu_torch.tools import (bench, kernel_stages,
                                                  rasterizer_timing)

    def log(line):
        print(f"[tools] {line}", flush=True)

    _reset_launches()
    rows = rasterizer_timing.main(
        ["--all", "--iters", str(TOOLS_ITERS), "--device", str(dev)], log=log)
    result = bench.main(["--device", str(dev)])
    stage_iters = 3
    digests = kernel_stages.main(
        ["--iters", str(stage_iters), "--device", str(dev)], log=log)
    launches = _read_launches()
    print(f"[tools] launches {json.dumps(launches)}", flush=True)

    n = TOOLS_ITERS + 1         # every timed row: one warm-up, then iters
    frames = (bench.REPEATS + 1) * bench.ITERS_PER_REPEAT
    expect = {
        "K1": 2 * n + frames,   # composite only, the cuda frame; the bench
        "K2a": n, "K2b": n,     # forward + backward
        "K6": 2 * n,            # the cuda_dma frame, composite only
        "K3": 2 * n,            # v1 and v1_aux
        "K4": n, "K5": n,
    }
    expect.update({f"B{b}.{stage}": stage_iters + 1 for b in (1, 2)
                   for stage in range(4)})
    if launches != expect:
        fail(f"the tools launched {launches}, expected {expect}")
    wanted = [f"forward frame [{impl}]" for impl in rasterizer_timing.IMPLS]
    wanted += ["preprocess", "binning", "composite only",
               "forward+backward [cuda]", "segment gather",
               "composite only [segments]"]
    bad = [k for k in wanted if not (rows.get(k, 0.0) > 0.0
                                     and math.isfinite(rows[k]))]
    if bad:
        fail(f"the timing tool gave no time for {bad}")
    if not (math.isfinite(result["value"]) and result["value"] > 0
            and result["unit"] == "rays/s"):
        fail(f"the bench result is {result}")
    if len(digests) != 8 or not all(math.isfinite(v) for v in
                                    digests.values()):
        fail(f"the stage tool's digests are {digests}")
    return launches


def small_train_phase(dev):
    """Three training steps at small widths (`vae-small`'s layout, cut) on
    the card against the same weights, batch and draws on the CPU, which
    runs the plain rasterizer pair. Per step: total loss within 2e-3,
    grad norm within 1e-2 (the first step; 2e-2 after it, once the
    parameters have drifted within tolerance)."""
    import copy
    import torch
    from gaussiananything_tpu_torch.data.synthetic import make_batch
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        TrainStateConfig)
    from gaussiananything_tpu_torch.train.vae_trainer import (
        VAELossConfig, make_train_step)
    torch.manual_seed(0)
    K, ZC = 48, 8
    cpu_model = PointVAE(latent_num=K, z_channels=ZC, encoder_width=96,
                         decoder_width=128, decoder_depth=2, decoder_heads=2,
                         up_factors=(8,), up_depths=(1,),
                         release_parity=False, with_encoder=True)
    card_model = copy.deepcopy(cpu_model).to(dev)
    batch = make_batch(seed=0, batch=2, n_views_in=2, n_views_sup=2, res=64,
                       n_pts=256, n_splats=512)
    batch.pop("gt_gaussians")
    loss_cfg = VAELossConfig(lod_resolutions=(32, 64), normal_start_step=0,
                             dist_start_step=0, kl_anneal_steps=2)
    tx_cfg = TrainStateConfig(lr=1e-3, warmup_steps=1)
    gen = torch.Generator().manual_seed(1)
    draws = [{"noise": torch.randn((2, K, ZC), generator=gen),
              "lpips_lod": i % 2} for i in range(3)]
    logs = {}
    for name, model, device in (("cpu", cpu_model, torch.device("cpu")),
                                ("card", card_model, dev)):
        step = make_train_step(model, loss_cfg, tx_cfg)
        state = TrainState.create(model)
        b = {k: v.to(device) for k, v in batch.items()}
        logs[name] = [step(state, b, draws={
            "noise": d["noise"].to(device), "lpips_lod": d["lpips_lod"]})
            for d in draws]
    rows = []
    ok = True
    for i, (c, r) in enumerate(zip(logs["card"], logs["cpu"])):
        row = {k: [float(c[k]), float(r[k])] for k in ("total", "grad_norm")}
        rows.append(row)
        rel = {k: abs(a - b) / max(abs(b), 1e-30) for k, (a, b) in
               row.items()}
        ok &= rel["total"] <= 2e-3 and rel["grad_norm"] <= (1e-2 if i == 0
                                                           else 2e-2)
    print(f"[small train] [card, CPU] per step: {json.dumps(rows)}",
          flush=True)
    if not ok:
        fail("the small training steps on the card disagree with the CPU")


def train_phase(dev, compute_dtype="float32", against=None):
    """TRAIN_STEPS steps at the `vae-release` preset's full width through
    the port's training CLI on seeded random weights: encoder width 256,
    768 latents x 10 channels, the DiT2 768 x 12 decoder, upsamplers to
    73,728 surfels, 4 + 4 views at 512², the (128, 256, 384, 512) ladder,
    each LoD's render checkpointed (K2a runs again in the backward). The
    batch is cut to TRAIN_BATCH and the warm-up to 1 step, and
    `vae.compute_dtype` is `compute_dtype` (through a `--config` file, the
    preset otherwise unchanged). Checks that the parameters, both moments
    and the EMA are fp32 and that every norm weight initialised at 1.0
    moved. Launch counts are set to 0 just before and read just after.
    Returns the launches and the run's seconds by stage and peak, which a
    later run prints beside its own (`against`)."""
    with tempfile.TemporaryDirectory() as logdir:
        return _train_run(dev, logdir, compute_dtype, against)


def _train_run(dev, logdir, compute_dtype, against):
    import torch
    from gaussiananything_tpu_torch.cli import train_vae
    from gaussiananything_tpu_torch.config import preset
    from gaussiananything_tpu_torch.models.layers import (GroupNorm32,
                                                          LayerNorm, RMSNorm)
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.ops import rasterize_cuda

    tag = "[train]" if compute_dtype == "float32" else \
        f"[train {compute_dtype}]"
    cfg = preset("vae-release")
    cfg.optim.warmup_steps = 1      # step 0 runs at lr 0, steps 1-2 at lr
    cfg.vae.compute_dtype = compute_dtype
    cfg_path = os.path.join(logdir, "vae-release.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    rasterize_cuda.event_log = []       # device time of every launch
    timers = []
    t0 = time.perf_counter()
    try:
        res = train_vae.main(
            ["--config", cfg_path, "--steps", str(TRAIN_STEPS), "--batch",
             str(TRAIN_BATCH), "--logdir", os.path.join(logdir, "run"),
             "--device", str(dev)], timers=timers)
        torch.cuda.synchronize()
        events = rasterize_cuda.event_log
    finally:
        rasterize_cuda.event_log = None
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    kernel_s = {k: sum(a.elapsed_time(b) for n, a, b in events if n == k)
                / 1e3 for k in ("K1", "K2a", "K2b")}
    used = {k: v for k, v in launches.items() if v}
    print(f"{tag} vae-release width, compute dtype {compute_dtype}, batch "
          f"{TRAIN_BATCH}, {TRAIN_STEPS} steps, wall {wall:.2f}s (model "
          f"build included); peak memory {peak / 2**30:.2f} GiB"
          + (f" (float32: {against['peak'] / 2**30:.2f} GiB)" if against
             else "") + f"; launches {json.dumps(used)}", flush=True)
    for i, (lg, tm) in enumerate(zip(res["logs"], timers)):
        beside = "" if against is None else \
            f"; float32 {json.dumps(_rounded(against['seconds'])[i])}"
        print(f"{tag} step {i}: total {lg['total']:.6g}, grad_norm "
              f"{lg['grad_norm']:.6g}; seconds by stage "
              f"{json.dumps(_rounded([tm])[0])}{beside}", flush=True)
    print(f"{tag} kernel seconds over the {TRAIN_STEPS} steps (K1 in data, "
          f"K2a in render and again in backward, K2b in backward): "
          f"{json.dumps({k: round(v, 5) for k, v in kernel_s.items()})}",
          flush=True)

    # every LoD view renders twice: the forward, and the checkpoint's
    # recompute in the backward
    expect = {"K1": TRAIN_BATCH * 8 * TRAIN_STEPS,
              "K2a": 2 * TRAIN_BATCH * 4 * 4 * TRAIN_STEPS,
              "K2b": TRAIN_BATCH * 4 * 4 * TRAIN_STEPS}
    expect.update({k: 0 for k in launches if k not in expect})
    if launches != expect:
        fail(f"launches {launches}, expected {expect}")
    state, model = res["state"], res["model"]
    if state.step != TRAIN_STEPS or len(res["logs"]) != TRAIN_STEPS:
        fail(f"the step counter is {state.step}")
    for lg in res["logs"]:
        for k, v in lg.items():
            if not (v == v and abs(v) != float("inf")):
                fail(f"{k} is not finite")
    torch.manual_seed(cfg.seed)
    with torch.device(dev), torch.no_grad():
        init = PointVAE.from_config(cfg.vae, with_encoder=True)
    moved = max(float((p.detach() - q.detach()).abs().max()) for p, q in
                zip(model.parameters(), init.parameters()))
    ema_gap = max(float((state.ema[k] - q.detach()).abs().max())
                  for (k, _), q in zip(model.named_parameters(),
                                       init.parameters()))
    n_par = sum(p.numel() for p in model.parameters())
    dtypes = sorted({str(v.dtype) for tree in (state.params, state.mu,
                                                state.nu, state.ema)
                     for v in tree.values()})
    trained = dict(model.named_modules())
    ones = [n for n, m in init.named_modules()
            if isinstance(m, (LayerNorm, RMSNorm, GroupNorm32))
            and m.weight is not None
            and bool((m.weight == 1.0).all())]
    still = [n for n in ones if bool((trained[n].weight == 1.0).all())]
    print(f"{tag} {n_par / 1e6:.1f}M parameters, compute dtype "
          f"{model.dtype}; parameters, moments and EMA {dtypes}; max "
          f"|param - init| {moved:.3g}, max |EMA - init| {ema_gap:.3g}; "
          f"norm weights initialised at 1.0 that moved: "
          f"{len(ones) - len(still)} of {len(ones)}", flush=True)
    if not (moved > 0 and ema_gap > 0):
        fail("parameters or EMA did not move")
    if dtypes != ["torch.float32"] or str(model.dtype) != \
            f"torch.{compute_dtype}":
        fail(f"{tag} state dtypes {dtypes}, compute dtype {model.dtype}")
    if not ones or still:
        fail(f"{tag} norm weights at 1.0 that did not move: {still}")
    shapes = {"encoder_width": cfg.vae.encoder_width,
              "latent": [cfg.vae.latent_num, cfg.vae.z_channels],
              "lods": list(cfg.render.lod_resolutions)}
    if shapes != {"encoder_width": 256, "latent": [768, 10],
                  "lods": [128, 256, 384, 512]}:
        fail(f"the preset is not the release's: {shapes}")
    return launches, {"seconds": timers, "peak": peak}


def small_adv_train_phase(dev):
    """The release recipe's steps at small widths on the card against the
    same weights, batch and draws on the CPU: an adversarial generator
    step (adaptive weight on, seeded VGG-LPIPS as the perceptual term), a
    discriminator step, then a gradient accumulation step over two
    micro-batches. The first two run at the warm-up's lr 0, so all three
    see the same weights on both sides. Held: losses within 2e-3; the
    gradient norms and the adaptive weight (a ratio of two gradient norms)
    within 1e-2."""
    import copy
    import torch
    from gaussiananything_tpu_torch.data.synthetic import make_batch
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.train.losses import (PatchDiscriminator,
                                                         VGGLPIPS)
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        TrainStateConfig)
    from gaussiananything_tpu_torch.train.vae_trainer import (
        VAELossConfig, make_accum_train_step, make_disc_step,
        make_train_step)
    torch.manual_seed(0)
    K, ZC = 48, 8
    cpu = {"model": PointVAE(latent_num=K, z_channels=ZC, encoder_width=96,
                             decoder_width=128, decoder_depth=2,
                             decoder_heads=2, up_factors=(8,),
                             up_depths=(1,), release_parity=False,
                             with_encoder=True),
           "disc": PatchDiscriminator(ch=32, layers=2),
           "lpips": VGGLPIPS().requires_grad_(False)}
    batch = make_batch(seed=0, batch=2, n_views_in=2, n_views_sup=2, res=64,
                       n_pts=256, n_splats=512)
    batch.pop("gt_gaussians")
    loss_cfg = VAELossConfig(lod_resolutions=(32, 64), normal_start_step=0,
                             dist_start_step=0, kl_anneal_steps=2,
                             adv_weight=0.05)
    tx_cfg = TrainStateConfig(lr=1e-3, warmup_steps=1)
    gen = torch.Generator().manual_seed(2)
    g_draws = {"noise": torch.randn((2, K, ZC), generator=gen),
               "lpips_lod": 1}
    d_draws = {"noise": torch.randn((2, K, ZC), generator=gen)}
    a_draws = [{"noise": torch.randn((1, K, ZC), generator=gen),
                "lpips_lod": i} for i in range(2)]
    card = {k: copy.deepcopy(v).to(dev) for k, v in cpu.items()}
    rows = {}
    for name, m, device in (("cpu", cpu, torch.device("cpu")),
                            ("card", card, dev)):
        b = {k: v.to(device) for k, v in batch.items()}

        def on(d):
            return {k: (v.to(device) if torch.is_tensor(v) else v)
                    for k, v in d.items()}

        state = TrainState.create(m["model"])
        dstate = TrainState.create(m["disc"])
        g = make_train_step(m["model"], loss_cfg, tx_cfg,
                            perceptual_net=m["lpips"],
                            disc_model=m["disc"])(state, b,
                                                  draws=on(g_draws))
        d = make_disc_step(m["model"], m["disc"], loss_cfg, tx_cfg)(
            dstate, b, draws=on(d_draws))
        a = make_accum_train_step(m["model"], loss_cfg, 2, tx_cfg,
                                  perceptual_net=m["lpips"],
                                  disc_model=m["disc"])(
            state, b, draws=[on(x) for x in a_draws])
        rows[name] = {"g_total": g["total"], "g_loss": g["g_loss"],
                      "adaptive_w": g["adaptive_w"],
                      "g_grad_norm": g["grad_norm"], "d_loss": d["d_loss"],
                      "accum_total": a["total"],
                      "accum_grad_norm": a["grad_norm"]}
        rows[name] = {k: float(v) for k, v in rows[name].items()}
    rel = {k: abs(rows["card"][k] - v) / max(abs(v), 1e-30)
           for k, v in rows["cpu"].items()}
    print(f"[small adv train] card {json.dumps(rows['card'])}; CPU "
          f"{json.dumps(rows['cpu'])}; relative differences "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in rel.items()})}",
          flush=True)
    bad = [k for k, v in rel.items()
           if v > (1e-2 if k in ("adaptive_w", "g_grad_norm",
                                 "accum_grad_norm") else 2e-3)]
    if bad or not all(math.isfinite(v) for v in rows["card"].values()):
        fail(f"the small adversarial steps on the card disagree with the "
             f"CPU in {bad}")


# the release-width adversarial run: a packed dataset of ADV_INSTANCES
# instances (the last held out) of ADV_VIEWS 512² views, and the step
# counts of the recipe's documented command
ADV_INSTANCES, ADV_VIEWS, ADV_STEPS, ADV_EVAL_EVERY = 3, 8, 3, 2


def _seeded_lpips_npz(path: str, seed: int = 0):
    """VGG-LPIPS weights drawn from `seed` by numpy (He-scaled 3x3 kernels,
    zero biases, positive 1x1 `lins`), written in the JAX package's npz
    layout: flax HWIO kernels under params/net/features.N and
    params/lins.k."""
    import numpy as np
    from gaussiananything_tpu_torch.train.losses import (_VGG_CONVS,
                                                         LPIPS_CHANNELS)
    from gaussiananything_tpu_torch.utils.param_io import save_params_npz
    r = np.random.default_rng(seed)
    tree, c_in = {"net": {}}, 3
    for idx, ch in _VGG_CONVS:
        tree["net"][f"features.{idx}"] = {
            "kernel": (r.standard_normal((3, 3, c_in, ch))
                       * math.sqrt(2.0 / (9 * c_in))).astype(np.float32),
            "bias": np.zeros(ch, np.float32)}
        c_in = ch
    for k, ch in enumerate(LPIPS_CHANNELS):
        tree[f"lins.{k}"] = {"kernel": np.abs(
            r.standard_normal((1, 1, ch, 1)) * 0.1).astype(np.float32)}
    save_params_npz(path, {"params": tree})


def adv_train_phase(dev):
    """The release VAE recipe at the `vae-release` preset's full width
    through the port's training CLI, as its documented command runs it:
    `--adv --adv-start 0 --lpips-npz W --data-dir D --holdout 1
    --canonicalize --eval-every 2 --steps 3 --batch 2`, then `--resume`
    for one step more. D is written by the port's
    `export_synthetic_dataset` (ADV_INSTANCES instances of ADV_VIEWS 512²
    views, through K1), W by `_seeded_lpips_npz`; both inside the counted
    run. Cut: seeded random weights, procedural scenes, 4 steps, batch 2
    (the preset's 8 does not fit; PERF.md §4)."""
    with tempfile.TemporaryDirectory() as root:
        return _adv_train_run(dev, root)


def _adv_train_run(dev, root):
    import torch
    from gaussiananything_tpu_torch.cli import train_vae
    from gaussiananything_tpu_torch.config import preset
    from gaussiananything_tpu_torch.data.gbuffer import \
        export_synthetic_dataset
    from gaussiananything_tpu_torch.ops import rasterize_cuda

    cfg = preset("vae-release")
    data, npz = os.path.join(root, "data"), os.path.join(root, "lpips.npz")
    logdir = os.path.join(root, "run")
    args = ["--preset", "vae-release", "--adv", "--adv-start", "0",
            "--lpips-npz", npz, "--data-dir", data, "--holdout", "1",
            "--canonicalize", "--eval-every", str(ADV_EVAL_EVERY),
            "--batch", str(TRAIN_BATCH), "--logdir", logdir, "--device",
            str(dev)]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    rasterize_cuda.event_log = []
    seconds, timers = {}, []
    try:
        t0 = time.perf_counter()
        export_synthetic_dataset(data, n_instances=ADV_INSTANCES,
                                 n_views=ADV_VIEWS, res=cfg.data.resolution,
                                 n_splats=cfg.data.n_points, device=dev)
        torch.cuda.synchronize()
        seconds["export"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _seeded_lpips_npz(npz)
        seconds["lpips npz"] = time.perf_counter() - t0
        peaks = {"export": torch.cuda.max_memory_allocated()}
        runs = []
        for name, extra in (("train", []), ("resume", [
                "--resume", os.path.join(logdir, "ckpt")])):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = train_vae.main(
                args + ["--steps", str(ADV_STEPS + len(runs))] + extra,
                timers=timers)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            peaks[name] = torch.cuda.max_memory_allocated()
            # keep the logs and step counts; the first run's networks go
            # before the resume builds its own
            runs.append({k: res[k] for k in ("logs", "d_logs", "evals")})
            runs[-1]["steps"] = (res["state"].step, res["disc_state"].step)
            del res
        events = rasterize_cuda.event_log
    finally:
        rasterize_cuda.event_log = None
    launches = _read_launches()
    kernel_s = {k: sum(a.elapsed_time(b) for n, a, b in events if n == k)
                / 1e3 for k in ("K1", "K2a", "K2b")}
    used = {k: v for k, v in launches.items() if v}
    print(f"[adv train] vae-release width, batch {TRAIN_BATCH}, "
          f"{ADV_STEPS} + 1 steps; wall seconds "
          f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"(model builds included); peak memory GiB "
          f"{json.dumps({k: round(v / 2**30, 2) for k, v in peaks.items()})}"
          f"; launches {json.dumps(used)}", flush=True)
    logs, d_logs, evals = ([x for r in runs for x in r[k]]
                           for k in ("logs", "d_logs", "evals"))
    for i, (lg, tm) in enumerate(zip(logs, timers)):
        print(f"[adv train] step {i}: total {lg['total']:.6g}, g_loss "
              f"{lg['g_loss']:.6g}, adaptive_w {lg['adaptive_w']:.6g}, "
              f"grad_norm {lg['grad_norm']:.6g}; seconds by stage "
              f"{json.dumps({k: round(v, 4) for k, v in tm.items()})}",
              flush=True)
    print(f"[adv train] d_loss {[round(d['d_loss'], 6) for d in d_logs]}; "
          f"evaluations {json.dumps(evals)}; kernel seconds (K1 in export, "
          f"disc_step and eval, K2a in render, adversarial and backward, "
          f"K2b in adversarial and backward): "
          f"{json.dumps({k: round(v, 5) for k, v in kernel_s.items()})}",
          flush=True)

    steps = ADV_STEPS + 1
    B, V, L = TRAIN_BATCH, cfg.data.n_views_sup, \
        len(cfg.render.lod_resolutions)
    n_disc = sum(i % 2 == 1 for i in range(steps))
    n_eval = sum((i + 1) % ADV_EVAL_EVERY == 0 for i in range(steps))
    expect = {
        # export, the discriminator's finest render, the held-out batch of
        # one instance at every LoD
        "K1": ADV_INSTANCES * ADV_VIEWS + n_disc * B * V + n_eval * V * L,
        # every LoD view twice (the forward and the checkpoint's recompute
        # in the step's backward), the finest twice more (the recompute
        # in each of the adaptive weight's two gradients)
        "K2a": steps * (2 * B * V * L + 2 * B * V),
        # the step's backward, and the adaptive weight's two gradients
        # through the finest render the step's forward made
        "K2b": steps * (B * V * L + 2 * B * V)}
    expect.update({k: 0 for k in launches if k not in expect})
    if launches != expect:
        fail(f"launches {launches}, expected {expect}")
    if runs[-1]["steps"][0] != steps or len(logs) != steps:
        fail(f"the step counter is {runs[-1]['steps'][0]}")
    if runs[-1]["steps"][1] != n_disc or len(d_logs) != n_disc:
        fail(f"the discriminator took {runs[-1]['steps'][1]} steps, "
             f"expected {n_disc}: it did not resume")
    values = [lg[k] for lg in logs for k in ("total", "g_loss",
                                             "adaptive_w", "grad_norm")]
    values += [d["d_loss"] for d in d_logs]
    values += [v for m in evals for v in m.values()]
    if len(evals) != n_eval or not all(math.isfinite(v) for v in values):
        fail("a loss, the adaptive weight or an evaluation is not finite")
    for name in [f"eval/eval_{i + 1:07d}.png" for i in range(steps)
                 if (i + 1) % ADV_EVAL_EVERY == 0] + [
            f"ckpt/step_{steps:08d}.pt", f"ckpt_disc/step_{n_disc:08d}.pt"]:
        path = os.path.join(logdir, name)
        if not (os.path.exists(path) and os.path.getsize(path)):
            fail(f"{name} was not written")
    return launches


# ------------------------------------------------------- generator training

def _flow_small_models():
    """Tiny flow-matching modules on the CPU: a scratch-ViT conditioner
    (width 64, depth 1, 28²), non-release stage-1/2 DiT-S cut to depth 2
    and width 128, and a release-layout stage-1 DiT (raw t: the field
    the adaptive sampler can be held on)."""
    import torch
    from gaussiananything_tpu_torch.models.conditioner import \
        ImageConditioner
    from gaussiananything_tpu_torch.models.dit import (PointDiT, stage1_dit,
                                                       stage2_dit)
    torch.manual_seed(3)
    dit = dict(depth=2, width=128, heads=4, cond_dim=64, vector_dim=64)
    return {"cond": ImageConditioner(width=64, depth=1, heads=2, img_size=28,
                                     backbone="scratch", ucg_rate=0.5),
            1: stage1_dit("S", **dit), 2: stage2_dit("S", z_channels=4,
                                                     **dit),
            "release": PointDiT(in_channels=3, release_parity=True, **dit)}


FLOW_SMALL_K, FLOW_SMALL_B = 64, 4
# three steps at lr 1e-3 with a warm-up of one step: the first update has
# lr 0, the second and third the whole lr, so the third step's logs are
# taken on parameters a real update moved. An element whose gradient sits
# at the rounding floor can take a whole Adam step of opposite sign on the
# two devices (`tests/test_torch_accum.py`): 2 · lr for each real update at
# most, and at most FLOW_SMALL_SHARE of the elements beyond
# FLOW_SMALL_GUARD, which a skipped (gap ~lr) or sign-flipped (~2 · lr)
# update on the card exceeds.
FLOW_SMALL_LR, FLOW_SMALL_STEPS = 1e-3, 3
FLOW_SMALL_GUARD, FLOW_SMALL_SHARE = 2e-4, 0.01


def _flow_small_run(models, device, stage, train_cond, accum, draws, batch,
                    remat=False):
    """`make_fm_train_step` steps of copies of `models` on `device`, one
    for each entry of `draws`: (logs, DiT state, conditioner state)."""
    import copy
    from gaussiananything_tpu_torch.diffusion.transport import \
        create_transport
    from gaussiananything_tpu_torch.train.fm_trainer import (
        FMConfig, make_fm_train_step)
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        TrainStateConfig)
    dit = copy.deepcopy(models[stage]).to(device).train()
    dit.remat = remat
    cond = copy.deepcopy(models["cond"]).to(device).train()
    step = make_fm_train_step(dit, cond, create_transport(),
                              FMConfig(stage=stage),
                              TrainStateConfig(lr=FLOW_SMALL_LR,
                                               warmup_steps=1),
                              accum=accum)
    state = TrainState.create(dit)
    cstate = TrainState.create(cond, frozen=not train_cond)
    b = {k: v.to(device) for k, v in batch.items()}
    logs = [{k: float(v) for k, v in step(state, cstate, b, draws=d).items()}
            for d in draws]
    return logs, state, cstate


def _max_gap(a, b):
    return max(float((a[k].detach().cpu() - b[k].detach().cpu()).abs().max())
               for k in a)


def _share_beyond(a, b, limit):
    """The share of the elements of trees `a` and `b` further apart than
    `limit`."""
    beyond = sum(int(((a[k].detach().cpu() - b[k].detach().cpu()).abs()
                      > limit).sum()) for k in a)
    return beyond / sum(v.numel() for v in a.values())


def small_flow_train_phase(dev):
    """Generator training at small widths on the card against the same
    weights and handed-over draws on the CPU: three steps each of stage 1,
    stage 2, a frozen conditioner and two micro-batches (losses and
    gradient norms within 1e-3 relative, t_mean 1e-6; parameters and EMA
    within 2 · lr for each real update, with at most 1% of the elements
    beyond 2e-4, `tests/test_torch_fm_training.py`'s bounds; a frozen
    conditioner unmoved); the
    frozen step with `remat` on, bit-equal on the card to the step with it
    off (every parameter, moment, EMA value and log); the adaptive dopri5
    through `make_sampler` (1e-3 of the output's scale, its rtol) and the
    SDE sampler (1e-4 of it) on the same noise on a release-layout DiT;
    one
    `cli/extract_latents.py` encode (demo preset, the weights of a CPU
    checkpoint; latent within 1e-4, anchors equal, the view within the
    golden image tolerance 2e-3 of the CPU's plain compositor)."""
    import copy
    import numpy as np
    import torch
    from gaussiananything_tpu_torch.cli import extract_latents
    from gaussiananything_tpu_torch.diffusion.sampling import (
        cfg_velocity_fn, sample_sde)
    from gaussiananything_tpu_torch.models.conditioner import ucg_keep_mask
    from gaussiananything_tpu_torch.train.fm_trainer import (FMConfig,
                                                             make_sampler)

    models = _flow_small_models()
    K, B = FLOW_SMALL_K, FLOW_SMALL_B
    g = torch.Generator().manual_seed(4)
    base = {"cond": torch.rand((B, 3, 28, 28), generator=g),
            "xyz": torch.randn((B, K, 3), generator=g) * 0.3}
    report, bad = {}, []
    for name, stage, train_cond, accum in (
            ("stage1", 1, True, 1), ("stage2", 2, True, 1),
            ("frozen", 1, False, 1), ("accum2", 1, True, 2)):
        C = 3 if stage == 1 else 4
        batch = {"cond": base["cond"],
                 "latent": base["xyz"] / 0.164 if stage == 1
                 else torch.randn((B, K, C), generator=g)}
        if stage == 2:
            batch["xyz"] = base["xyz"]
        mb = B // accum
        draws = [[{"keep": ucg_keep_mask(mb, 0.5, g),
                   "t": torch.rand(mb, generator=g),
                   "x0": torch.randn((mb, K, C), generator=g)}
                  for _ in range(accum)] for _ in range(FLOW_SMALL_STEPS)]
        cpu = _flow_small_run(models, "cpu", stage, train_cond, accum,
                              draws, batch)
        card = _flow_small_run(models, dev, stage, train_cond, accum, draws,
                               batch)
        rel = {k: max(abs(c[k] - r[k]) / max(abs(r[k]), 1e-30)
                      for c, r in zip(card[0], cpu[0]))
               for k in cpu[0][0]}
        trees = {"dit": (card[1].params, cpu[1].params),
                 "dit_ema": (card[1].ema, cpu[1].ema),
                 "cond": (card[2].params, cpu[2].params)}
        if train_cond:
            trees["cond_ema"] = (card[2].ema, cpu[2].ema)
        gaps = {k: _max_gap(*v) for k, v in trees.items()}
        shares = {k: _share_beyond(*v, FLOW_SMALL_GUARD)
                  for k, v in trees.items()}
        report[name] = {"rel": rel, "gaps": gaps,
                        f"share beyond {FLOW_SMALL_GUARD}": shares}
        floor = 2 * FLOW_SMALL_LR * (FLOW_SMALL_STEPS - 1) + 1e-6
        if rel["fm_loss"] > 1e-3 or rel["grad_norm"] > 1e-3 \
                or rel["t_mean"] > 1e-6 or max(gaps.values()) > floor \
                or max(shares.values()) > FLOW_SMALL_SHARE:
            bad.append(name)
        if not train_cond and not (card[2].frozen and card[2].step == 0
                                   and gaps["cond"] == 0.0):
            bad.append(name + " (frozen conditioner)")
        if name == "frozen":
            on = _flow_small_run(models, dev, stage, False, 1, draws, batch,
                                 remat=True)
            again = _flow_small_run(models, dev, stage, False, 1, draws,
                                    batch)
            equal = {}
            for label, other in (("remat on", on), ("remat off again",
                                                    again)):
                equal[label] = other[0] == card[0] and all(
                    torch.equal(getattr(other[1], t)[k],
                                getattr(card[1], t)[k])
                    for t in ("params", "mu", "nu", "ema")
                    for k in card[1].params)
            report["remat"] = equal
            if not equal["remat on"]:
                bad.append("remat")

    # the samplers on a release-layout DiT (raw t)
    dit = models["release"].eval()
    cond = models["cond"].eval()
    img = base["cond"][:2]
    x0 = torch.randn((2, K, 3), generator=g)
    noise = torch.randn((15, 2, K, 3), generator=g)
    outs = {}
    for device in ("cpu", dev):
        d = copy.deepcopy(dit).to(device)
        c = copy.deepcopy(cond).to(device)
        dopri = make_sampler(d, c, FMConfig(stage=1, cfg_scale=2.0,
                                            sampler="dopri5"), (K, 3))(
            img.to(device), x0=x0)
        with torch.no_grad():
            cc = c(img.to(device))
            guided = cfg_velocity_fn(
                lambda x, t, e: d(x, t, e.crossattn, e.vector), cc,
                type(cc)(*(torch.zeros_like(a) for a in cc)), 2.0)
            sde = sample_sde(guided, x0.to(device), num_steps=16,
                             noise=noise)
        outs[str(device)] = (dopri.cpu(), sde.cpu())
    sampler_err = {
        name: float((outs[str(dev)][i] - outs["cpu"][i]).abs().max())
        / float(outs["cpu"][i].abs().max())
        for i, name in enumerate(("dopri5", "sde"))}
    # dopri5's output is fixed only to its tolerance: where the error
    # estimate sits at the fp32 rounding floor, the controller's next step
    # (0.9 · ratio^-1/5) is set by rounding, so moving x0 by 1e-7 moves the
    # CPU's own result by as much as the two devices differ (up to 3.7e-4
    # of the output's scale on this field); it is held to the integrator's
    # rtol 1e-3 of that scale
    nudge = 1e-7 * torch.randn(x0.shape,
                               generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        spread = make_sampler(dit, cond, FMConfig(
            stage=1, cfg_scale=2.0, sampler="dopri5"), (K, 3))(
            img, x0=x0 * (1 + nudge))
    sampler_err["dopri5_cpu_under_1e-7_nudge"] = float(
        (spread - outs["cpu"][0]).abs().max()) / float(
            outs["cpu"][0].abs().max())
    report["samplers"] = sampler_err
    if sampler_err["sde"] > 1e-4 or sampler_err["dopri5"] > 1e-3:
        bad.append("samplers")

    # one extraction, card vs CPU, on the weights of a CPU checkpoint
    from gaussiananything_tpu_torch.config import preset
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        save_checkpoint)
    cfg = preset("demo-e2e")
    with tempfile.TemporaryDirectory() as root:
        torch.manual_seed(0)
        vae = PointVAE.from_config(cfg.vae, with_encoder=True)
        save_checkpoint(os.path.join(root, "vae"), TrainState.create(vae))
        eps = [torch.randn((1, cfg.vae.latent_num, cfg.vae.z_channels),
                           generator=g)]
        got = {}
        for device in ("cpu", str(dev)):
            out = os.path.join(root, device)
            extract_latents.main(["--preset", "demo-e2e", "--num", "1",
                                  "--ckpt", os.path.join(root, "vae"),
                                  "--out", out, "--device", device],
                                 noise=eps)
            with np.load(os.path.join(out, "00000.npz")) as z:
                got[device] = {k: z[k] for k in z.files}
    a, r = got[str(dev)], got["cpu"]
    ext = {"latent": float(np.abs(a["latent_normalized"]
                                  - r["latent_normalized"]).max()),
           "anchors": float(np.abs(a["query_pcd_xyz"]
                                   - r["query_pcd_xyz"]).max()),
           "cond": float(np.abs(a["cond"] - r["cond"]).max())}
    report["extract"] = ext
    if ext["latent"] > 1e-4 or ext["anchors"] != 0.0 or ext["cond"] > 2e-3 \
            or str(a["caption"]) != str(r["caption"]):
        bad.append("extract")
    print(f"[small flow train] card vs CPU: {json.dumps(report)}",
          flush=True)
    if bad:
        fail(f"the small flow training on the card disagrees with the CPU "
             f"in {bad}")


# the release-width generator run: extraction, stage 1 (3 steps, a
# resume to 4), stage 2 (2 steps), t23d (2 steps), one synthetic step
FLOW_LATENTS, FLOW_BATCH, FLOW_ACCUM, FLOW_SAMPLER_STEPS = 8, 8, 2, 10


def flow_train_phase(dev):
    """The generator's training path at full width through the port's
    CLIs: `extract_latents --preset vae-release --num 8` (the release VAE
    encoder, 4 input views at 512², K1 for the views); `train_flow
    --preset stage1` (DiT-L, 416M parameters, against the frozen scratch
    ViT-L at 224², seeded weights given by `--cond-ckpt`) `--latent-dir
    L --freeze-cond --accum 2 --batch 8 --steps 3 --save-every 2
    --eval-every 3`, then `--resume` to step 4; `--stage 2` for 2 steps
    with an evaluation; `--preset t23d --cond text` for 2 steps (trained
    byte-token text conditioner; the last two with `--save-every 1`, so
    that each last update has a checkpoint before it); one
    synthetic-stream stage-1 step without `--latent-dir` (views through
    K1). Cut: seeded random weights, procedural latents, the eval
    sampler's 250 Heun steps to 10 (a `--config` with `transport.
    num_steps` 10). Launch counts are set to 0 just before and read just
    after."""
    with tempfile.TemporaryDirectory() as root:
        return _flow_train_run(dev, root)


def _flow_cond_ckpt(cfg, dev, path):
    """A seeded scratch ViT conditioner at the preset's width, written under
    `path` as a frozen state's checkpoint for `--cond-ckpt`; its parameters
    on the host (a frozen run must end with exactly these)."""
    import torch
    from gaussiananything_tpu_torch.models.conditioner import \
        ImageConditioner
    from gaussiananything_tpu_torch.train.state import (TrainState,
                                                        save_checkpoint)
    torch.manual_seed(7)
    with torch.device(dev), torch.no_grad():
        cond = ImageConditioner(
            width=cfg.dit.cond_width, depth=cfg.dit.cond_depth,
            heads=cfg.dit.cond_heads, img_size=cfg.dit.cond_img_size,
            backbone="scratch")
    save_checkpoint(path, TrainState.create(cond, frozen=True))
    return {k: v.detach().cpu() for k, v in cond.named_parameters()}


def _update_check(state, pre, tx):
    """How a trained state's last update moved it from `pre`, the checkpoint
    written just before that update (step t, learning rate lr_t of
    `learning_rate(tx, t, name)`):

      * `max_step_over_lr`: the largest |Δparam| / lr_t, at least 0.5 for
        an update taken at its learning rate (0 for none);
      * `tensors_over`: tensors whose largest |Δparam| exceeds lr_t ·
        (1.02 + weight_decay · max|p|) + one fp32 ulp of max|p| (AdamW's
        step is lr_t · |m̂ / √v̂ + wd · p|, and |m̂ / √v̂| ≤ 1.007 in the
        first four steps: Cauchy–Schwarz on the moments' weights);
      * `ema_off`: EMA elements further than one ulp from d · ema_pre +
        (1 − d) · params, d = min(ema_decay, (1 + t) / (10 + t));
      * `ema_pre_off`: how many of `ema_pre`'s own elements are that far,
        so that the EMA check can tell an update from none."""
    from gaussiananything_tpu_torch.train.state import learning_rate
    t = int(pre["step"])
    d = min(tx.ema_decay, (1.0 + t) / (10.0 + t))
    ratio, over, ema_off, ema_pre_off = 0.0, [], 0, 0
    for k, p in state.params.items():
        p = p.detach()
        p0 = pre["params"][k].detach().to(p.device)
        lr = learning_rate(tx, t, k)
        big = float(p0.abs().max())
        step = float((p - p0).abs().max())
        ratio = max(ratio, step / lr)
        if step > lr * (1.02 + tx.weight_decay * big) + 2.0 ** -23 * big:
            over.append(k)
        e0 = pre["ema"][k].detach().to(p.device)
        want = e0.clone().mul_(d).add_(p, alpha=1.0 - d)
        ulp = want.abs() * 2.0 ** -23
        ema_off += int(((state.ema[k] - want).abs() > ulp).sum())
        ema_pre_off += int(((e0 - want).abs() > ulp).sum())
    return {"step": t, "lr": learning_rate(tx, t), "max_step_over_lr": ratio,
            "tensors_over": over, "ema_off": ema_off,
            "ema_pre_off": ema_pre_off}


def _rounded(timers):
    return [{k: round(v, 4) for k, v in tm.items()} for tm in timers]


def _update_ok(check):
    return (check["max_step_over_lr"] >= 0.5 and not check["tensors_over"]
            and check["ema_off"] == 0 and check["ema_pre_off"] > 0)


def _flow_train_run(dev, root):
    import gc
    import shutil
    import numpy as np
    import torch
    from gaussiananything_tpu_torch.cli import extract_latents, train_flow
    from gaussiananything_tpu_torch.config import preset
    from gaussiananything_tpu_torch.train.state import TrainStateConfig

    lat = os.path.join(root, "latents")
    cfgs = {}
    for name in ("stage1", "t23d", "stage1-bf16"):
        c = preset(name.split("-")[0])
        c.transport.num_steps = FLOW_SAMPLER_STEPS
        if name.endswith("bf16"):
            c.dit.compute_dtype = "bfloat16"
        cfgs[name] = os.path.join(root, f"{name}.json")
        with open(cfgs[name], "w") as f:
            f.write(c.to_json())
    common = ["--batch", str(FLOW_BATCH), "--accum", str(FLOW_ACCUM),
              "--device", str(dev)]
    # the frozen image conditioner of every stage-1/2 run
    cond_dir = os.path.join(root, "cond")
    cond0 = _flow_cond_ckpt(preset("stage1"), dev, cond_dir)
    frozen = ["--freeze-cond", "--cond-ckpt", cond_dir]
    # (name, arguments, steps the run ends at); every run of two steps or
    # more writes a checkpoint just before its last update
    runs = [
        ("stage1", ["--config", cfgs["stage1"], "--latent-dir", lat,
                    *frozen, "--steps", "3", "--save-every", "2",
                    "--eval-every", "3"], 3),
        ("stage1 resume", ["--config", cfgs["stage1"], "--latent-dir", lat,
                           *frozen, "--steps", "4", "--save-every", "2",
                           "--eval-every", "3", "--resume"], 4),
        # the stage-1 run's first three steps with bf16 compute
        ("stage1-bf16", ["--config", cfgs["stage1-bf16"], "--latent-dir",
                         lat, *frozen, "--steps", "3", "--save-every", "2"],
         3),
        ("stage2", ["--config", cfgs["stage1"], "--stage", "2",
                    "--latent-dir", lat, *frozen, "--steps", "2",
                    "--save-every", "1", "--eval-every", "2"], 2),
        ("t23d", ["--config", cfgs["t23d"], "--cond", "text",
                  "--latent-dir", lat, "--steps", "2", "--save-every",
                  "1"], 2),
        ("synthetic", ["--config", cfgs["stage1"], *frozen, "--steps", "1"],
         1)]

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ext = extract_latents.main(["--preset", "vae-release", "--num",
                                str(FLOW_LATENTS), "--out", lat, "--device",
                                str(dev)])
    torch.cuda.synchronize()
    ext_wall = time.perf_counter() - t0
    peaks = {"extract": torch.cuda.max_memory_allocated()}
    print(f"[flow train] extract_latents --preset vae-release --num "
          f"{FLOW_LATENTS}: {ext_wall:.2f}s wall (model build included); "
          f"seconds per instance "
          f"{json.dumps([round(s, 4) for s in ext['seconds']])}; peak "
          f"{peaks['extract'] / 2**30:.2f} GiB", flush=True)
    with np.load(ext["files"][0]) as z:
        shapes = {k: list(z[k].shape) for k in z.files}
    if shapes != {"latent_normalized": [768, 10], "query_pcd_xyz": [768, 3],
                  "cond": [3, 224, 224], "caption": []}:
        fail(f"the extracted npz holds {shapes}")

    results, bad, step_seconds = {}, [], {}
    for name, args, steps in runs:
        logdir = os.path.join(root, name.split()[0])
        if name == "stage1 resume":
            args = args + [os.path.join(logdir, "ckpt")]
        torch.cuda.reset_peak_memory_stats()
        timers = []
        t0 = time.perf_counter()
        res = train_flow.main(args + common + ["--logdir", logdir],
                              timers=timers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        peaks[name] = peak
        state, cstate = res["state"], res["cond_state"]
        cfg = preset("t23d" if name == "t23d" else "stage1")
        tx = TrainStateConfig(lr=cfg.optim.lr,
                              warmup_steps=cfg.optim.warmup_steps,
                              weight_decay=cfg.optim.weight_decay,
                              ema_decay=cfg.optim.ema_decay)
        checks = {}
        # the warm-up's first update has lr 0: a one-step run moves nothing
        if steps > 1:
            checks["dit"] = _update_check(state, torch.load(
                os.path.join(logdir, "ckpt", f"step_{steps - 1:08d}.pt"),
                map_location="cpu", mmap=True), tx)
            if not cstate.frozen:
                checks["cond"] = _update_check(cstate, torch.load(
                    os.path.join(logdir, "ckpt_cond",
                                 f"step_{steps - 1:08d}.pt"),
                    map_location="cpu", mmap=True),
                    dataclasses.replace(tx, lr=0.5 * tx.lr))
        if cstate.frozen:
            checks["frozen cond = --cond-ckpt"] = not cstate.mu and all(
                torch.equal(cstate.params[k].cpu(), v)
                for k, v in cond0.items())
        dtypes = sorted({str(v.dtype) for st in (state, cstate) for tree in
                         (st.params, st.mu, st.nu, st.ema)
                         for v in tree.values()})
        want_dt = "torch.bfloat16" if name.endswith("bf16") \
            else "torch.float32"
        checks["fp32 state, compute dtype"] = \
            dtypes == ["torch.float32"] and str(res["dit"].dtype) == want_dt
        n_dit = sum(p.numel() for p in state.params.values())
        n_cond = sum(p.numel() for p in cstate.params.values())
        print(f"[flow train] {name}: {n_dit / 1e6:.1f}M DiT + "
              f"{n_cond / 1e6:.1f}M conditioner "
              f"({'frozen' if cstate.frozen else 'trained'}), batch "
              f"{FLOW_BATCH} in {FLOW_ACCUM} micro-batches, steps "
              f"{steps - len(res['logs'])}..{steps}, wall {wall:.2f}s "
              f"(model build included), peak {peak / 2**30:.2f} GiB; "
              f"last update {json.dumps(checks)}", flush=True)
        for i, (lg, tm) in enumerate(zip(res["logs"], timers)):
            print(f"[flow train] {name} step {steps - len(res['logs']) + i}"
                  f": {json.dumps({k: round(v, 6) for k, v in lg.items()})}"
                  f"; seconds by stage "
                  f"{json.dumps({k: round(v, 4) for k, v in tm.items()})}",
                  flush=True)
        if res["evals"]:
            print(f"[flow train] {name} evaluations "
                  f"{json.dumps(res['evals'])}", flush=True)
        values = [v for lg in res["logs"] for v in lg.values()]
        values += [v for m in res["evals"] for v in m.values()]
        if state.step != steps or not all(math.isfinite(v) for v in values):
            bad.append(f"{name}: step {state.step}, or a value not finite")
        for part, check in checks.items():
            if check is False or (check is not True
                                  and not _update_ok(check)):
                bad.append(f"{name}: the last update of {part}: {check}")
        if name == "stage1-bf16":
            print(f"[flow train] stage1-bf16 against stage1 (float32): "
                  f"seconds by stage {json.dumps(_rounded(timers))} "
                  f"against {json.dumps(_rounded(step_seconds['stage1']))}"
                  f"; peak "
                  f"{peak / 2**30:.2f} GiB against "
                  f"{peaks['stage1'] / 2**30:.2f}", flush=True)
        step_seconds[name] = timers
        if cstate.frozen != (name != "t23d"):
            bad.append(f"{name}: the conditioner's state is "
                       f"{'frozen' if cstate.frozen else 'trained'}")
        want = {"stage1 resume": [f"ckpt/step_{steps:08d}.pt",
                                  "ckpt_cond/step_00000000.pt",
                                  "eval/sample_3.ply"],
                "stage2": ["ckpt/step_00000002.pt",
                           "ckpt_cond/step_00000000.pt"],
                "t23d": ["ckpt/step_00000002.pt",
                         "ckpt_cond/step_00000002.pt"]}.get(name, [])
        for f in want:
            p = os.path.join(logdir, f)
            if not (os.path.exists(p) and os.path.getsize(p)):
                bad.append(f"{name}: {f} was not written")
        if name == "stage1" and not (
                len(res["evals"]) == 1
                and set(res["evals"][0]) >= {"eval_chamfer", "eval_fscore"}):
            bad.append("stage1: no geometry evaluation")
        if name == "stage2" and not (
                len(res["evals"]) == 1 and set(res["evals"][0]) == {
                    "eval_latent_std", "eval_latent_absmax"}):
            bad.append("stage2: no latent evaluation")
        results[name] = len(res["logs"])
        del res, state, cstate
        gc.collect()
        torch.cuda.empty_cache()
        if name != "stage1":
            shutil.rmtree(logdir)     # a DiT-L checkpoint is 6.7 GB
    launches = _read_launches()
    used = {k: v for k, v in launches.items() if v}
    print(f"[flow train] peak memory GiB "
          f"{json.dumps({k: round(v / 2**30, 2) for k, v in peaks.items()})}"
          f"; launches {json.dumps(used)}", flush=True)
    # extraction: the 4 input views and the 1 supervision view of every
    # instance; the synthetic step: one conditioning view per sample
    expect = {"K1": FLOW_LATENTS * 5 + FLOW_BATCH}
    expect.update({k: 0 for k in launches if k not in expect})
    if launches != expect:
        bad.append(f"launches {launches}, expected {expect}")
    if results != {"stage1": 3, "stage1 resume": 1, "stage1-bf16": 3,
                   "stage2": 2, "t23d": 2, "synthetic": 1}:
        bad.append(f"steps run {results}")
    if bad:
        fail(f"flow train: {bad}")
    return launches


# ---------------------------------------------------------------------------
# Row bands, several ranks, the profiler and the checkpoint import.
# ---------------------------------------------------------------------------

# The bands phase: each case's view split into 2 and into 4 bands of rows,
# as `render/sharded.py` renders it over a tile group: K1 at the release
# render shape (max_per_tile 2048, chunk 256), K2a/K2b at the trainer's
# 512² and 384² LoDs (max_per_tile 1024, chunk 128).
RELEASE_BATCH, RELEASE_ACCUM = 256, 8


def parity_512_phase(dev):
    """The port's 512² parity tool (`tools/golden_parity_512.run_parity`)
    at the release shape: 73,728 splats, `max_per_tile` 8192, its three
    views; the training path (K2a, K2b), the forward path (K1) and the
    plain pair against the unbinned oracle, K2b's gradient against the
    oracle's autograd gradient and the plain pair's, each within the
    tool's criteria, and each gaussian channel's gradient within
    `GRAD_CHANNEL_REL` of that channel's own max. The record is printed,
    never written over the committed artifact. Launch counts are set to 0
    just before and read just after: K1, K2a and K2b once a view."""
    import torch
    from gaussiananything_tpu_torch.tools import golden_parity_512 as gp
    _reset_launches()
    t0 = time.perf_counter()
    rec = gp.run_parity(device=dev,
                        log=lambda s: print(f"[parity-512] {s}", flush=True))
    wall = time.perf_counter() - t0
    launches = _read_launches()
    torch.cuda.empty_cache()
    n = len(gp.VIEWS)
    print(f"[parity-512] {n} views in {wall:.1f}s; densest tile "
          f"{rec['densest_tile']} of {rec['max_per_tile']}; K2b vs oracle "
          f"{json.dumps(rec['grad'])}; vs plain "
          f"{json.dumps(rec['grad_vs_plain'])}; pass {rec['pass']}",
          flush=True)
    if not rec["pass"]:
        fail(f"the 512² parity tool: {json.dumps(rec)}")
    if not gp.grad_channels_pass(rec):
        fail("the 512² parity tool: a gaussian channel's gradient beyond "
             f"{gp.GRAD_CHANNEL_REL} of its own max")
    want = {"K1": n, "K2a": n, "K2b": n}
    if launches != {k: want.get(k, 0) for k in launches}:
        fail(f"parity-512 launches {_used(launches)}, expected {want}")
    return launches


def fm_release_batch_phase(dev):
    """The release flow-matching batch through
    `tools/fm_feasibility.feasibility`: stage-1 DiT-L (`remat`) against
    the frozen ViT-L, global batch RELEASE_BATCH in RELEASE_ACCUM
    micro-batches, seeded weights and inputs: a warm-up step and a timed
    step; the seconds, samples/s and the peak; finite logs, two updates."""
    import torch
    from gaussiananything_tpu_torch.tools import fm_feasibility
    out = fm_feasibility.feasibility(
        batch=RELEASE_BATCH, accum=RELEASE_ACCUM, stage=1, steps=1,
        device=dev, log=lambda s: print(f"[fm-release-batch] {s}",
                                        flush=True))
    torch.cuda.empty_cache()
    if out["steps_taken"] != 2 or not all(
            math.isfinite(v) for v in out["logs"].values()):
        fail(f"the release-batch step: {json.dumps(out)}")
    print(f"[fm-release-batch] batch {RELEASE_BATCH} = {RELEASE_ACCUM} x "
          f"{out['micro']}: warm-up step {out['first_step_s']:.3f}s, timed "
          f"step {out['steady_step_s']:.3f}s ({out['samples_per_s']:.2f} "
          f"samples/s), peak {out['peak_bytes'] / 2 ** 30:.2f} GiB; logs "
          f"{json.dumps(out['logs'])}", flush=True)


def release_feasibility_phase(dev):
    """`tools/release_feasibility.py` at its defaults (the `vae` preset,
    batch 1, 4 + 4 views at 512², the four-LoD ladder with
    `rand_coarse_lod`, render remat, 5 steady steps), with and without
    `--bf16`, each in a fresh process: parameters, the first and the
    steady step's seconds, steps/s and the peak of each, finite losses,
    six updates."""
    from gaussiananything_tpu_torch.tools import release_feasibility as rf
    here = os.path.dirname(os.path.abspath(__file__))
    outs = {}
    for extra in ([], ["--bf16"]):
        cmd = [sys.executable, "-m",
               "gaussiananything_tpu_torch.tools.release_feasibility",
               *extra]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600, cwd=here)
        wall = time.perf_counter() - t0
        lines = [ln[len(rf.TAG):] for ln in res.stdout.splitlines()
                 if ln.startswith(rf.TAG)]
        if res.returncode != 0 or not lines:
            fail(f"release feasibility {extra}: exit {res.returncode}\n"
                 f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        out = json.loads(lines[-1])
        outs[out["compute_dtype"]] = out
        print(f"[release feasibility] {out['compute_dtype']}: "
              f"{out['params'] / 1e6:.1f}M parameters, first step "
              f"{out['first_step_s']:.3f}s, steady step "
              f"{out['steady_step_s'] * 1e3:.1f} ms "
              f"({out['steps_per_s']:.2f} steps/s), peak "
              f"{out['peak_bytes'] / 2 ** 30:.2f} GiB; total "
              f"{out['logs']['total']:.6g}; {wall:.1f}s in its process; "
              f"{out['card']}", flush=True)
        if out["steps_taken"] != 6 or not all(
                math.isfinite(v) for v in out["logs"].values()):
            fail(f"release feasibility: {json.dumps(out)}")
    if sorted(outs) != ["bfloat16", "float32"]:
        fail(f"release feasibility ran {sorted(outs)}")


BAND_CASES = {"K1 512": ("K1", K1_CASES["turntable"]),
              "K2 512": ("K2", K2_CASES["train 512"]),
              "K2 384": ("K2", K2_CASES["train 384"])}
BAND_SPLITS = (2, 4)


def _band_frames(dev, scene, n_bands):
    """(tab, whole-view (pairs, starts, counts), [(row0, band lists)],
    res, band): the splats projected and tabled against the whole image,
    each band binned with its row0."""
    import torch
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.render import cameras
    seed, n, kind, opacity, radius, pose, res, mpt = scene
    g = make_object(seed, n=n, kind=kind, device=dev)
    if opacity is not None:
        g[:, 3] = opacity
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(radius, [pose])[0], device=dev)
    sp = rz.preprocess_splats(g, cam["cam_view"], cam["cam_view_proj"],
                              res, res)
    tab = rz.splat_table(sp, res, res).contiguous()
    band = res // n_bands
    whole = rz.build_tile_pairs(sp, res, res, 16, mpt)
    bands = [(i * band, rz.build_tile_pairs(sp, band, res, 16, mpt,
                                            row0=i * band))
             for i in range(n_bands)]
    torch.cuda.synchronize()
    return tab, whole, bands, res, band


def _unequal_lists(whole, lists, row0, tiles_x):
    """Tiles of a band whose depth-ordered pair list differs from the
    whole view's list of the same image tile."""
    wp, ws, wc = (x.tolist() for x in whole)
    bp, bs, bc = (x.tolist() for x in lists)
    off = row0 // 16 * tiles_x
    return [t for t, (s, c) in enumerate(zip(bs, bc))
            if bp[s:s + c] != wp[ws[off + t]:ws[off + t] + wc[off + t]]]


def bands_phase(dev):
    """Every BAND_CASES view in 2 and in 4 bands, each band through its
    kernels with its row0 against the plain versions with the same row0:
    K1's and K2a's buffers to the golden criteria, K2a's entry states to
    atol 2e-5 / rtol 1e-4 with its executed chunks and marks exact, K2b's
    table cotangent (the band's rows of one seeded cotangent of the whole
    view) to GRAD_REL of each column's largest value. On every tile whose
    pair list the band binned as the whole view did, the joined bands must
    equal the whole-view render bit for bit (K1, K2a), and the bands' K2b
    cotangents summed must equal the whole view's to 2e-3 of each column's
    largest value under the cotangent of those tiles. The tiles whose
    lists differ are counted: a band holds fewer big splats than the whole
    view, so where the view's big bucket overflows `big_capacity` the
    band bins some of them whole. Each kernel timed per band beside the
    whole view. Returns {kernel: largest error} for the records."""
    import torch
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.ops import rasterize_cuda as rc
    errs = {"K1": 0.0, "K2a": 0.0, "K2b": 0.0}
    bg = torch.ones(3, device=dev)
    for case, (kind, (*scene, chunk)) in BAND_CASES.items():
        for n_bands in BAND_SPLITS:
            tab, whole, bands, res, band = _band_frames(dev, scene, n_bands)
            tiles_x = res // 16
            # tiles (image rows of tiles x columns) binned alike
            same = torch.ones((tiles_x, tiles_x), dtype=torch.bool)
            for row0, lists in bands:
                for t in _unequal_lists(whole, lists, row0, tiles_x):
                    same[row0 // 16 + t // tiles_x, t % tiles_x] = False
            pix = same.repeat_interleave(16, 0).repeat_interleave(16, 1) \
                .to(dev)
            wargs = (tab, *whole, bg, res, res)
            times = {}
            if kind == "K1":
                full = rc.composite(*wargs, chunk=chunk)
                times["whole"] = [time_cuda(lambda: rc.composite(
                    *wargs, chunk=chunk), reps=20)]
            else:
                full, *wextra = rc.composite_entries(*wargs, chunk=chunk)
                ct = torch.randn((rz.N_OUT, res, res),
                                 generator=torch.Generator().manual_seed(6)
                                 ).to(dev)
                ct[6] *= DIST_WEIGHT
                ct = ct * pix
                w_order = rc.splat_order(*whole, tab.shape[0])
                d_whole = rc.composite_backward(
                    tab, *whole, bg, ct, *wextra, *w_order, res, res,
                    chunk=chunk)
                times["whole"] = [
                    time_cuda(lambda: rc.composite_entries(*wargs,
                                                           chunk=chunk),
                              reps=20),
                    time_cuda(lambda: rc.composite_backward(
                        tab, *whole, bg, ct, *wextra, *w_order, res, res,
                        chunk=chunk), reps=20)]
                d_sum = torch.zeros_like(tab)
            joined = torch.empty_like(full)
            for row0, lists in bands:
                args = (tab, *lists, bg, band, res)
                rows = slice(row0, row0 + band)
                if kind == "K1":
                    got = rc.composite(*args, chunk=chunk, row0=row0)
                    ref = rz.composite_plain(*args, chunk=chunk, row0=row0)
                    times.setdefault("bands", []).append([time_cuda(
                        lambda: rc.composite(*args, chunk=chunk, row0=row0),
                        reps=20)])
                else:
                    got, off, entries, n_exec, marks = rc.composite_entries(
                        *args, chunk=chunk, row0=row0)
                    ref, rent, rn_exec, rmarks = rz.composite_plain(
                        *args, chunk=chunk, row0=row0, return_entries=True)
                    e_err = float((entries[:rent.shape[0]] - rent).abs()
                                  .max()) if rent.numel() else 0.0
                    if not (torch.equal(n_exec, rn_exec) and torch.equal(
                            marks[:rmarks.shape[0]], rmarks)
                            and bool((entries[:rent.shape[0]] - rent).abs()
                                     .le(2e-5 + 1e-4 * rent.abs()).all())):
                        fail(f"K2a disagrees with its plain version on the "
                             f"band at row {row0} ({case}, {n_bands} bands)")
                    errs["K2a"] = max(errs["K2a"], e_err)
                    ct_b = ct[:, rows].contiguous()
                    order = rc.splat_order(*lists, tab.shape[0])
                    d_band = rc.composite_backward(
                        tab, *lists, bg, ct_b, off, entries, n_exec, marks,
                        *order, band, res, chunk=chunk, row0=row0)
                    d_ref = rz.composite_plain_backward(
                        tab, *lists, bg, ct_b, band, res, chunk=chunk,
                        row0=row0)
                    g_err = (d_band - d_ref).abs().amax(0)
                    if not bool((g_err <= GRAD_REL * d_ref.abs().amax(0)
                                 + 1e-12).all()):
                        fail(f"K2b disagrees with its plain version on the "
                             f"band at row {row0} ({case}, {n_bands} "
                             f"bands)")
                    errs["K2b"] = max(errs["K2b"], float(g_err.max()))
                    d_sum += d_band
                    times.setdefault("bands", []).append([
                        time_cuda(lambda: rc.composite_entries(
                            *args, chunk=chunk, row0=row0), reps=20),
                        time_cuda(lambda: rc.composite_backward(
                            tab, *lists, bg, ct_b, off, entries, n_exec,
                            marks, *order, band, res, chunk=chunk,
                            row0=row0), reps=20)])
                ok, gerrs = _golden_errors(rz.split_outputs(got),
                                           rz.split_outputs(ref), GOLDEN_TOL)
                if not ok:
                    fail(f"{'K1' if kind == 'K1' else 'K2a'} disagrees with "
                         f"its plain version on the band at row {row0} "
                         f"({case}, {n_bands} bands): {json.dumps(gerrs)}")
                k = "K1" if kind == "K1" else "K2a"
                errs[k] = max(errs[k], *(r["max_abs"]
                                         for r in gerrs.values()))
                joined[:, rows] = got
            torch.cuda.synchronize()
            if not torch.equal(joined * pix, full * pix):
                fail(f"the joined bands differ from the whole view's render "
                     f"on tiles binned alike ({case}, {n_bands} bands)")
            n_other = int((~same).sum())
            other = float(((joined - full).abs() * ~pix).max()) \
                if n_other else 0.0
            msg = (f"{n_other} of {tiles_x ** 2} tiles binned otherwise "
                   f"(max|joined - whole| there {other:.3g}), the rest "
                   f"bit-equal to the whole view")
            if kind == "K2":
                peak = d_whole.abs().amax(0)
                s_err = (d_sum - d_whole).abs().amax(0)
                rel = float((s_err / peak.clamp(min=1e-30)).max())
                if not bool((s_err <= 2e-3 * peak + 1e-12).all()):
                    fail(f"the bands' summed K2b cotangent is {rel:.3g} of "
                         f"max|g| from the whole view's ({case}, "
                         f"{n_bands} bands)")
                msg += f"; summed K2b cotangent / max|g| {rel:.3g}"
            names = ["K1"] if kind == "K1" else ["K2a", "K2b"]
            per = {nm: [round(b[j], 4) for b in times["bands"]]
                   for j, nm in enumerate(names)}
            whole_ms = {nm: round(times["whole"][j], 4)
                        for j, nm in enumerate(names)}
            print(f"[bands] {case}² ({scene[1]} splats, max_per_tile "
                  f"{scene[7]}, chunk {chunk}) in {n_bands} bands of "
                  f"{band} rows: {msg}; median ms per band "
                  f"{json.dumps(per)}, whole view {json.dumps(whole_ms)}",
                  flush=True)
    return errs


# the multi-rank phase: two ranks on the one card over gloo
RANKS = 2
RANK_STEPS = 2


def _torchrun(args, timeout):
    """`python -m torch.distributed.run --standalone --nproc_per_node RANKS
    <args>`; returns the JSON of every line of its output that starts
    with a tag, and the seconds it took."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(RANKS), *args]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-6000:], sep="\n", flush=True)
        fail(f"{' '.join(args[:3])} on {RANKS} ranks exited "
             f"{res.returncode}")
    out = {}
    for ln in res.stdout.splitlines():
        tag, _, rest = ln.partition(" ")
        if tag in ("DRYRUN", "DRYRUN-RANK"):
            out.setdefault(tag, []).append(json.loads(rest))
    return out, wall


def _used(launches):
    return {k: v for k, v in launches.items() if v}


def rank_run(kind: str, argv_json: str, out_dir: str):
    """One rank of a multi-rank CLI run (started by `_torchrun`): the
    launch counts set to 0, `cli/train_vae.py` or `cli/train_flow.py`
    with `argv_json`'s arguments, then `<out_dir>/rank<r>.json`: the mesh,
    the steps, the logs, the seconds by stage, the peak memory and the
    kernels' launches of this rank."""
    import torch
    from gaussiananything_tpu_torch.cli import train_flow, train_vae
    from gaussiananything_tpu_torch.parallel import dist as pdist
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    timers = []
    t0 = time.perf_counter()
    main_fn = train_vae.main if kind == "vae" else train_flow.main
    res = main_fn(json.loads(argv_json), timers=timers)
    torch.cuda.synchronize()
    out = {"rank": pdist.get_rank(), "mesh": [res["mesh"].data,
                                              res["mesh"].tile],
           "step": res["state"].step, "logs": res["logs"],
           "seconds": [{k: round(v, 4) for k, v in t.items()}
                       for t in timers],
           "wall_s": round(time.perf_counter() - t0, 2),
           "peak_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
           "launches": _read_launches()}
    with open(os.path.join(out_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def multi_rank_phase(dev):
    """Several ranks on the one card over gloo (RANKS processes under
    `torch.distributed.run`): the dry run's five phases at tiny widths
    (two of them accumulation steps of two micro-batches), each against
    the unsharded step on the card (`parallel/dryrun.py`: total rtol
    1e-5, grad_norm rtol 1e-4); then `cli/train_vae.py --preset
    vae-release` as a 2 x 1 mesh at batch 2 and a 1 x 2 mesh at batch 1,
    and `cli/train_flow.py --preset stage1 --freeze-cond --accum 2` as a
    2 x 1 mesh at batch 8 (synthetic stream), RANK_STEPS steps each
    (warm-up 1 step, the transport's evaluation steps cut to 10): steps,
    finite losses equal on every rank, each kernel's launches on each rank,
    and each rank's seconds by stage and peak. Returns the launches summed
    over the ranks of the full-width runs."""
    import torch
    from gaussiananything_tpu_torch.config import preset
    here = os.path.abspath(__file__)
    out, wall = _torchrun(["-m", "gaussiananything_tpu_torch.parallel.dryrun",
                           "--device", "cuda", "--backend", "gloo"], 600)
    phases = out.get("DRYRUN", [])
    if len(phases) != 5 or not all(p["ok"] for p in phases):
        fail(f"the multi-rank dry run: {phases}")
    for p in phases:
        print(f"[multi-rank] dry run {json.dumps(p)}", flush=True)
    print(f"[multi-rank] dry run ranks: {json.dumps(out['DRYRUN-RANK'])}; "
          f"{wall:.1f}s", flush=True)

    runs = [
        ("vae", "vae-release", 2, 1, 2),
        ("vae", "vae-release", 1, 2, 1),
        ("flow", "stage1", 2, 1, 8),
    ]
    total = {}
    with tempfile.TemporaryDirectory() as root:
        for kind, name, data, tile, batch in runs:
            cfg = preset(name)
            cfg.optim.warmup_steps = 1
            cfg.transport.num_steps = FLOW_SAMPLER_STEPS
            cfg.mesh_data, cfg.mesh_tile = data, tile
            tag = f"{kind}-{data}x{tile}"
            path = os.path.join(root, f"{tag}.json")
            with open(path, "w") as f:
                f.write(cfg.to_json())
            argv = ["--config", path, "--steps", str(RANK_STEPS), "--batch",
                    str(batch), "--logdir", os.path.join(root, tag),
                    "--dist-backend", "gloo", "--device", "cuda"]
            if kind == "flow":
                argv += ["--freeze-cond", "--accum", "2"]
            rank_dir = os.path.join(root, f"{tag}-ranks")
            os.makedirs(rank_dir)
            _, wall = _torchrun([here, "--rank-run", kind, json.dumps(argv),
                                 rank_dir], 900)
            ranks = []
            for r in range(RANKS):
                path = os.path.join(rank_dir, f"rank{r}.json")
                if not os.path.exists(path):
                    fail(f"{tag}: rank {r} reported nothing")
                with open(path) as f:
                    ranks.append(json.load(f))
            if len(ranks) != RANKS:
                fail(f"{tag}: {len(ranks)} ranks reported")
            local = batch // data
            if kind == "vae":
                want = {"K1": batch * 8 * RANK_STEPS,
                        "K2a": 2 * local * 16 * RANK_STEPS,
                        "K2b": local * 16 * RANK_STEPS}
            else:
                want = {"K1": batch * RANK_STEPS}
            key = "total" if kind == "vae" else "fm_loss"
            for r in ranks:
                exp = {k: want.get(k, 0) for k in r["launches"]}
                if r["launches"] != exp:
                    fail(f"{tag} rank {r['rank']}: launches "
                         f"{r['launches']}, expected {exp}")
                if r["mesh"] != [data, tile] or r["step"] != RANK_STEPS \
                        or len(r["logs"]) != RANK_STEPS:
                    fail(f"{tag} rank {r['rank']}: mesh {r['mesh']}, step "
                         f"{r['step']}")
                for lg in r["logs"]:
                    if not all(math.isfinite(v) for v in lg.values()):
                        fail(f"{tag} rank {r['rank']}: a loss is not finite")
                if [lg[key] for lg in r["logs"]] != \
                        [lg[key] for lg in ranks[0]["logs"]]:
                    fail(f"{tag}: the ranks logged different {key}s")
                print(f"[multi-rank] {tag} ({name}, batch {batch}) rank "
                      f"{r['rank']}: {key} "
                      f"{[round(lg[key], 6) for lg in r['logs']]}, "
                      f"grad_norm "
                      f"{[round(lg['grad_norm'], 6) for lg in r['logs']]}; "
                      f"seconds by stage {json.dumps(r['seconds'])}; peak "
                      f"{r['peak_gib']} GiB; launches "
                      f"{json.dumps(_used(r['launches']))}", flush=True)
                for k, v in r["launches"].items():
                    total[k] = total.get(k, 0) + v
            peak = sum(r["peak_gib"] for r in ranks)
            print(f"[multi-rank] {tag}: {wall:.1f}s; the ranks' peaks "
                  f"together {peak:.2f} GiB", flush=True)
            if peak * 2 ** 30 > torch.cuda.get_device_properties(
                    0).total_memory:
                fail(f"{tag}: the ranks together peak above the card")
    return total


def _trace_window(trace_path, window, n_top=8):
    """(device-busy seconds, window seconds, top kernels) of a trace: the
    kernels, copies and sets from the start of the CPU range named
    `window` to the later of its end and the last device activity; the
    top kernels by summed device time in it."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ann = [e for e in events if e.get("name") == window
           and e.get("cat") == "user_annotation"]
    if not ann:
        fail(f"the trace has no range {window!r}")
    t0, t1 = ann[0]["ts"], ann[0]["ts"] + ann[0]["dur"]
    acts = [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and e["ts"] >= t0]
    if not acts:
        fail(f"the trace shows no device activity in {window!r}")
    busy, end = 0.0, t0
    for a, b in sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in acts):
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    by_name = {}
    for e in acts:
        ms, calls = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e.get("dur", 0) * 1e-3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]
    return busy * 1e-6, (max(t1, end) - t0) * 1e-6, [
        {"kernel": k[:70], "ms": round(ms, 4), "calls": c}
        for k, (ms, c) in top]


def profile_phase(dev):
    """`utils/profiling.trace` (torch.profiler, CPU and CUDA activities)
    around one batch-2 evaluation of the release stage-1 DiT-L (fp32, TF32
    off; seeded weights; 1,369 DINOv2 context tokens, the cascade's CFG
    batch) and around one 512² turntable view of 73,728 splats through
    `rasterize_tiled` (K1): the top kernels by device time and the share of
    each window the card was busy. Launch counts are set to 0 just before
    and read just after."""
    import torch
    from gaussiananything_tpu_torch.data.synthetic import make_object
    from gaussiananything_tpu_torch.models.dit import stage1_dit_release
    from gaussiananything_tpu_torch.ops import rasterize as rz
    from gaussiananything_tpu_torch.render import cameras
    from gaussiananything_tpu_torch.utils import profiling
    torch.manual_seed(0)
    with torch.device(dev):
        dit = stage1_dit_release().eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 768, 3), generator=gen, device=dev)
    t = torch.rand((2,), generator=gen, device=dev)
    ctx = torch.randn((2, 1369, 1024), generator=gen, device=dev)
    vec = torch.randn((2, 1024), generator=gen, device=dev)
    g = make_object(0, n=73728, kind="sphere", device=dev)
    cam = cameras.pose_to_gs_camera(
        cameras.generate_input_camera(1.8, [(20, 45)])[0], device=dev)
    bg = torch.ones(3, device=dev)

    def view():
        return rz.rasterize_tiled(g, cam["cam_view"], cam["cam_view_proj"],
                                  bg, 512, 512, max_per_tile=2048, chunk=256)

    with torch.no_grad():
        for _ in range(2):                 # warm-up: allocator, cuBLAS
            dit(x, t, ctx, vec)
            view()
        torch.cuda.synchronize()
        _reset_launches()
        with tempfile.TemporaryDirectory() as logdir:
            found = {}
            for name, fn in (("dit_eval", lambda: dit(x, t, ctx, vec)),
                             ("turntable_view", view)):
                sub = os.path.join(logdir, name)
                with profiling.trace(sub):
                    with profiling.annotate(name):
                        fn()
                        torch.cuda.synchronize()
                found[name] = _trace_window(
                    os.path.join(sub, "trace.json"), name)
        launches = _read_launches()
    del dit
    for name, (busy, span, top) in found.items():
        print(f"[profile] {name}: window {span * 1e3:.3f} ms, device busy "
              f"{busy * 1e3:.3f} ms ({100 * busy / span:.1f}%); top kernels "
              f"by device time {json.dumps(top)}", flush=True)
    if launches["K1"] != 1:
        fail(f"the profiled view launched K1 {launches['K1']} times")
    return launches


def _fan_in_randomize(model, seed: int = 0):
    """Random weights that keep activations O(1) through deep stacks
    (tests/test_release_import.py's `_randomize`)."""
    import numpy as np
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1 and name.endswith("weight"):
                p.copy_(1.0 + 0.05 * torch.randn(p.shape, generator=g))
            elif p.ndim >= 2:
                fan_in = int(np.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=g)
                        / max(fan_in, 1) ** 0.5)
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model


def import_phase(dev):
    """The reference checkpoints' import: mirrors of the released
    stage-1 DiT (CLAY layout, width 1024, 16 heads, context 1024) and of
    the release VAE (768 latents, DiT2 width 768, 12 heads, the (8, 4, 3)
    upsamplers) with the true reference names (`tests/torch_mirror_ga.py`,
    depth cut to 2), written with `torch.save`, converted by the port's
    `cli/import_release`, restored into the port's modules on the card
    (`from_jax_params`), and held against the mirrors' own forward (on the
    host, as they were written): the velocity field to atol 2e-4 / rtol
    1e-3, the decoded LoDs to atol 3e-4 / rtol 1e-3
    (tests/test_dit_release_import.py, tests/test_release_import.py)."""
    import torch
    from gaussiananything_tpu_torch.cli import import_release
    from gaussiananything_tpu_torch.models.dit import stage1_dit_release
    from gaussiananything_tpu_torch.models.vae import PointVAE
    from gaussiananything_tpu_torch.utils.param_io import (from_jax_params,
                                                           load_params_npz)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_mirror_ga import TorchClayDiT, TorchReleaseVAE

    def check(name, got, ref, atol, rtol):
        err = float((got - ref).abs().max())
        ok = bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())
        print(f"[import] {name}: max|port - mirror| {err:.3g} (max|mirror| "
              f"{float(ref.abs().max()):.3g})", flush=True)
        if not (ok and torch.isfinite(got).all()):
            fail(f"the imported {name} disagrees with its mirror")

    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as root, torch.no_grad():
        pt, npz = os.path.join(root, "m.pt"), os.path.join(root, "m.npz")
        tm = _fan_in_randomize(TorchClayDiT(in_channels=3, dim=1024,
                                            depth=2, heads=16,
                                            ctx_dim=1024)).eval()
        torch.save(tm.state_dict(), pt)
        t0 = time.perf_counter()
        import_release.main(["--kind", "dit-stage1", "--ckpt", pt, "--out",
                             npz, "--depth", "2"])
        dt = time.perf_counter() - t0
        with torch.device(dev):
            pm = stage1_dit_release(depth=2).eval()
        pm.load_state_dict(from_jax_params(load_params_npz(npz), pm))
        x = torch.randn((2, 768, 3), generator=gen, device=dev)
        t = torch.rand((2,), generator=gen, device=dev)
        ctx = torch.randn((2, 257, 1024), generator=gen, device=dev) * 0.5
        vec = torch.randn((2, 1024), generator=gen, device=dev) * 0.5
        # the mirror runs where it was written for, on the host
        check(f"stage-1 DiT (import {dt:.1f}s)", pm(x, t, ctx, vec).cpu(),
              tm(x.cpu(), t.cpu(), ctx.cpu(), vec.cpu()), 2e-4, 1e-3)

        tm = _fan_in_randomize(TorchReleaseVAE(num_tokens=768, dim=768,
                                               depth=2, heads=12)).eval()
        torch.save(tm.state_dict(), pt)
        t0 = time.perf_counter()
        import_release.main(["--kind", "vae", "--ckpt", pt, "--out", npz,
                             "--depth", "2"])
        dt = time.perf_counter() - t0
        with torch.device(dev):
            pm = PointVAE(latent_num=768, decoder_width=768, decoder_depth=2,
                          decoder_heads=12, release_parity=True,
                          with_encoder=True, encoder_width=256).eval()
        pm.load_state_dict(from_jax_params(load_params_npz(npz), pm))
        z = torch.randn((1, 768, 10), generator=gen, device=dev)
        anchors = (torch.rand((1, 768, 3), generator=gen, device=dev)
                   - 0.5) * 0.6
        got = [lod.cpu() for lod in pm.decode(z, anchors)]
        ref = tm.decoder.decode(z.cpu(), anchors.cpu())
        if not len(got) == len(ref) == 4:
            fail(f"the imported VAE decodes {len(got)} LoDs, its mirror "
                 f"{len(ref)}")
        for i, (a, b) in enumerate(zip(got, ref)):
            check(f"VAE LoD {i} ({a.shape[1]} surfels; import {dt:.1f}s)",
                  a, b, 3e-4, 1e-3)


def probe_one(batch: int, compute_dtype: str):
    import torch
    from gaussiananything_tpu_torch.cli import train_vae
    from gaussiananything_tpu_torch.config import preset
    timers = []
    out = {"batch": batch, "compute_dtype": compute_dtype, "oom": False}
    with tempfile.TemporaryDirectory() as logdir:
        cfg = preset("vae-release")
        cfg.vae.compute_dtype = compute_dtype
        path = os.path.join(logdir, "vae-release.json")
        with open(path, "w") as f:
            f.write(cfg.to_json())
        try:
            train_vae.main(["--config", path, "--steps", "2",
                            "--batch", str(batch), "--logdir",
                            os.path.join(logdir, "run")], timers=timers)
            out["step_seconds"] = {k: round(v, 4)
                                   for k, v in timers[-1].items()}
        except torch.OutOfMemoryError:      # the answer the probe is after
            out["oom"] = True
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_gib"] = round(out["peak_bytes"] / 2 ** 30, 2)
    out["device"] = torch.cuda.get_device_name(0)
    print("PROBE " + json.dumps(out), flush=True)


def probe_batches(args):
    compute_dtype = "float32"
    if args[:1] == ["--bf16"]:
        compute_dtype, args = "bfloat16", args[1:]
    _, smi_line = device_phase()
    for batch in [int(a) for a in args] or [8, 4, 2, 1]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--probe-one", str(batch), compute_dtype],
                             capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("PROBE ")]
        if not lines:
            print(res.stdout[-2000:], res.stderr[-4000:], sep="\n")
            fail(f"batch {batch}: the run failed")
        print(lines[-1][6:], flush=True)
        if not json.loads(lines[-1][6:])["oom"]:
            break
    print(smi_line, flush=True)


def main():
    if sys.argv[1:2] == ["--probe-one"]:
        return probe_one(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--probe-batch"]:
        return probe_batches(sys.argv[2:])
    if sys.argv[1:2] == ["--rank-run"]:
        return rank_run(*sys.argv[2:5])
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "gaussiananything_tpu_torch")):
        fail("gaussiananything_tpu_torch/ is missing beside chip_smoke.py")
    dev, smi_line = device_phase()
    build_phase()
    records = [k1_phase(dev), k2a_phase(dev), k2b_phase(dev), k6_phase(dev),
               k3_phase(dev), k4_phase(dev), k5_phase(dev)]
    records += stages_phase(dev)
    band_errs = bands_phase(dev)
    for rec in records:
        if rec["name"] in band_errs:
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     band_errs[rec["name"]])
    small_cascade_phase(dev)
    paths = {"cascade": cascade_phase(dev)}
    small_serving_phase(dev)
    paths["serving"] = serving_phase(dev)
    small_train_phase(dev)
    paths["train"], train32 = train_phase(dev)
    paths["train bf16"], _ = train_phase(dev, "bfloat16", against=train32)
    small_adv_train_phase(dev)
    paths["adv_train"] = adv_train_phase(dev)
    small_flow_train_phase(dev)
    paths["flow_train"] = flow_train_phase(dev)
    fm_release_batch_phase(dev)
    release_feasibility_phase(dev)
    paths["raster_tools"] = raster_tools_phase(dev)
    paths["parity_512"] = parity_512_phase(dev)
    paths["multi_rank"] = multi_rank_phase(dev)
    paths["profile"] = profile_phase(dev)
    import_phase(dev)
    for rec in records:
        # a kernel's launches over the main paths, each read just after its
        # run: K1 is on all of them, K2a and K2b on training and the tools
        rec["launches"] = sum(p.get(rec["name"], 0) for p in paths.values())
        if rec["launches"] < 1:
            fail(f"{rec['name']} was not launched on a main path")
    print(json.dumps({"kernels": records}), flush=True)
    print("kernels launched: " + ", ".join(
        f"{name} {json.dumps({k: v for k, v in p.items() if v})}"
        for name, p in paths.items()), flush=True)
    print(smi_line, flush=True)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
