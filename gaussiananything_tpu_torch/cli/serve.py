"""HTTP front end of the image-to-3D cascade (port of
`gaussiananything_tpu/cli/serve.py`).

The reference's two-engine gradio app (`scripts/gradio_app_cascaded.py`:
preprocess → stage-1 point cloud → stage-2 latent → VAE decode) on the
standard library's `ThreadingHTTPServer`:

  GET  /            a minimal upload form
  GET  /health      liveness and the preset
  POST /generate    body: a PNG/JPEG (raw or multipart), `?seed=N` →
                    JSON with the asset URLs and per-stage seconds
  GET  /assets/...  the written ply/glb files

    python -m gaussiananything_tpu_torch.cli.serve --release \\
        [--stage2-ckpt C2 --vae-ckpt V] [--matting-ckpt U2NET.npz] --port 7860

Requests run one at a time on the model (a lock), each with the noise of a
`torch.Generator` seeded by its seed. Stage 2 and the decode run when a
stage-2 or VAE checkpoint is given. Nothing is rendered.
"""
from __future__ import annotations

import argparse
import io
import itertools
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np


def parse_multipart_file(body: bytes, content_type: str) -> Optional[bytes]:
    """The first file part's raw bytes of a multipart/form-data body, or
    None. Exactly one trailing CRLF (the separator before the next
    boundary) is stripped, so a payload ending in CR, LF or '-' keeps its
    bytes; a quoted boundary= parameter is taken."""
    bdry = content_type.split("boundary=")[-1].split(";")[0].strip()
    bdry = bdry.strip('"').encode()
    for part in body.split(b"--" + bdry):
        if b"filename=" in part:
            data = part.split(b"\r\n\r\n", 1)[-1]
            if data.endswith(b"\r\n"):
                data = data[:-2]
            return data
    return None


def build_pipeline(args):
    """Build the models once → (generate(image (H, W, 3) uint8, seed,
    out_dir) → dict, cfg)."""
    import torch

    from gaussiananything_tpu_torch.cli.sample import _sync, build_models
    from gaussiananything_tpu_torch.config import preset, release_config
    from gaussiananything_tpu_torch.data.real import (load_matting_net,
                                                      remove_background,
                                                      resize_foreground,
                                                      resize_square)
    from gaussiananything_tpu_torch.render.ply_io import (save_2dgs_ply,
                                                          save_pointcloud_glb,
                                                          save_pointcloud_ply)
    from gaussiananything_tpu_torch.train.fm_trainer import (FMConfig,
                                                             XYZ_SCALE,
                                                             make_sampler)
    from gaussiananything_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = preset(args.preset)
    if args.release:
        cfg = release_config(cfg)
    models = build_models(SimpleNamespace(
        release=args.release, text=None, bf16=False, full=False, seed=42,
        stage1_ckpt=args.stage1_ckpt, stage1_cond_ckpt=args.cond_ckpt,
        stage2_ckpt=args.stage2_ckpt, stage2_cond_ckpt=args.stage2_cond_ckpt,
        vae_ckpt=args.vae_ckpt), cfg, dev)
    K = cfg.vae.latent_num
    fm = FMConfig(stage=1, cfg_scale=cfg.transport.cfg_scale,
                  num_steps=(args.steps if args.steps is not None
                             else cfg.transport.num_steps),
                  sampler=cfg.transport.sampler)
    sampler1 = make_sampler(models.dit1, models.cond, fm, (K, 3))
    sampler2 = None
    if models.dit2 is not None:
        sampler2 = make_sampler(
            models.dit2, models.cond2 or models.cond,
            FMConfig(stage=2, cfg_scale=fm.cfg_scale,
                     num_steps=fm.num_steps, sampler=fm.sampler),
            (K, cfg.vae.z_channels))
    matting_net = (load_matting_net(args.matting_ckpt, dev)
                   if args.matting_ckpt else None)
    lock = threading.Lock()
    serial = itertools.count()

    def preprocess(img: np.ndarray) -> torch.Tensor:
        """The gradio app's preprocess (`scripts/gradio_app_cascaded.py:
        214-226`): background removal (U²-Net with --matting-ckpt, the
        corner chroma key otherwise), the foreground recentred at ratio
        0.85 on white, resized to the conditioner's size."""
        arr = np.asarray(img, np.float32)[..., :3] / 255.0
        arr = remove_background(arr, matting_net=matting_net)
        arr = resize_square(resize_foreground(arr), cfg.dit.cond_img_size)
        return torch.from_numpy(np.moveaxis(arr, -1, 0))[None].to(dev)

    @torch.no_grad()
    def generate(img: np.ndarray, seed: int, out_dir: str) -> dict:
        with lock:
            t_start = time.perf_counter()
            timings = {}

            def mark(label, t0):
                _sync(dev)
                t1 = time.perf_counter()
                timings[label] = t1 - t0
                return t1

            t0 = time.perf_counter()
            x = preprocess(img)
            t0 = mark("preprocess", t0)
            gen = torch.Generator(device=dev).manual_seed(seed)
            xyz_n = sampler1(x, gen)
            t0 = mark("stage-1 sample", t0)
            # the scene-extent clip before the stage-2 conditioning
            # (`flow_matching_trainer.py:2131-2145`)
            xyz_t = torch.clamp(xyz_n[0] * XYZ_SCALE, -0.45, 0.45)
            xyz = xyz_t.cpu().numpy()
            os.makedirs(out_dir, exist_ok=True)
            tag = f"{int(time.time() * 1000) % 10**9}_{next(serial)}"
            ply, glb = f"pcd_{tag}.ply", f"pcd_{tag}.glb"
            save_pointcloud_ply(os.path.join(out_dir, ply), xyz)
            save_pointcloud_glb(os.path.join(out_dir, glb), xyz)
            out = {"stage1_ply": f"/assets/{ply}",
                   "stage1_glb": f"/assets/{glb}",
                   "n_points": int(xyz.shape[0])}
            if sampler2 is not None:
                t0 = time.perf_counter()
                kl = sampler2(x, gen,
                              xyz=xyz_t[None] / models.xyz_cond_scale)
                t0 = mark("stage-2 sample", t0)
                lods = models.vae.decode(kl, xyz_t[None])
                t0 = mark("VAE cascade decode", t0)
                gply = f"gaussians_{tag}.ply"
                save_2dgs_ply(os.path.join(out_dir, gply),
                              lods[-1][0].cpu().numpy())
                out["gaussians_ply"] = f"/assets/{gply}"
                out["n_gaussians"] = int(lods[-1].shape[1])
            out["latency_s"] = round(time.perf_counter() - t_start, 2)
            out["timings"] = timings
            return out

    return generate, cfg


INDEX_HTML = """<!doctype html><title>GaussianAnything</title>
<h2>GaussianAnything: image &rarr; 3D</h2>
<form method=post enctype=multipart/form-data action=/generate>
<input type=file name=image accept=image/*>
<button type=submit>Generate</button></form>
<p>POST an image to /generate; JSON response links the generated assets.</p>
""".encode()


def make_server(args) -> ThreadingHTTPServer:
    """The pipeline and a server bound to (args.host, args.port), not yet
    serving; port 0 takes a free port (`server_address`)."""
    generate, cfg = build_pipeline(args)
    os.makedirs(args.assets, exist_ok=True)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(200, INDEX_HTML, "text/html")
            elif self.path == "/health":
                self._send(200, json.dumps(
                    {"status": "ok", "preset": cfg.name}).encode())
            elif self.path.startswith("/assets/"):
                fp = os.path.join(args.assets, os.path.basename(self.path))
                if os.path.isfile(fp):
                    with open(fp, "rb") as f:
                        self._send(200, f.read(), "application/octet-stream")
                else:
                    self._send(404, b'{"error":"not found"}')
            else:
                self._send(404, b'{"error":"not found"}')

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/generate":
                self._send(404, b'{"error":"not found"}')
                return
            length = int(self.headers.get("Content-Length", 0))
            if length == 0 or length > 64 * 1024 * 1024:
                self._send(400, b'{"error":"bad content length"}')
                return
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if "multipart" in ctype:
                body = parse_multipart_file(body, ctype)
                if body is None:
                    self._send(400, b'{"error":"no file in form"}')
                    return
            try:
                from PIL import Image
                img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
            except Exception as e:  # noqa: BLE001 (any undecodable body)
                self._send(400, json.dumps(
                    {"error": f"cannot decode image: {e}"}).encode())
                return
            # ?seed=N, else a fresh seed per request
            try:
                seed = int(parse_qs(url.query)["seed"][0])
            except (KeyError, ValueError):
                seed = int.from_bytes(os.urandom(4), "little")
            out = generate(img, seed=seed, out_dir=args.assets)
            out["seed"] = seed
            self._send(200, json.dumps(out).encode())

        def log_message(self, fmt, *a):  # quiet
            pass

    return ThreadingHTTPServer((args.host, args.port), Handler)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="demo-e2e")
    p.add_argument("--release", action="store_true",
                   help="release widths (npz checkpoints from "
                        "cli.import_release)")
    ckpt = ("an npz in the JAX package's layout or a directory of this "
            "package's training checkpoints (EMA); Orbax checkpoints of the "
            "JAX trainer are not read")
    p.add_argument("--stage1-ckpt", default=None, help=ckpt)
    p.add_argument("--stage2-ckpt", default=None, help=ckpt)
    p.add_argument("--stage2-cond-ckpt", default=None,
                   help="stage 2's own conditioner: " + ckpt)
    p.add_argument("--vae-ckpt", default=None, help=ckpt)
    p.add_argument("--cond-ckpt", default=None, help=ckpt)
    p.add_argument("--matting-ckpt", default=None,
                   help="U2Net npz for background removal (the rembg "
                        "role); the corner chroma key otherwise")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--assets", default=os.path.join(tempfile.gettempdir(),
                                                    "ga_serve_assets"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    srv = make_server(args)
    host, port = srv.server_address[:2]
    print(f"serving on http://{host}:{port} (preset {args.preset})",
          flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
