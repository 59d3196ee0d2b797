"""The port's HTTP server (`cli/serve.py`) against the JAX package's:
`parse_multipart_file` on the JAX test's cases (`tests/test_serve.py:
56-82`), `build_pipeline` stage-1-only and with a VAE npz that the JAX
package writes (`:26-53`), and one real HTTP round trip on 127.0.0.1."""
from __future__ import annotations

import argparse
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussiananything_tpu.cli import serve as jserve
from gaussiananything_tpu.config import preset as jpreset
from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.utils.param_io import \
    save_params_npz as jsave_params_npz
from gaussiananything_tpu_torch.cli import serve
from gaussiananything_tpu_torch.render.ply_io import (load_2dgs_ply,
                                                      load_pointcloud_ply)

torch.set_num_threads(2)


def _args(tmp_path, **kw):
    base = dict(preset="demo-e2e", release=False, stage1_ckpt=None,
                stage2_ckpt=None, stage2_cond_ckpt=None, vae_ckpt=None,
                cond_ckpt=None, matting_ckpt=None, steps=2,
                host="127.0.0.1", port=0, assets=str(tmp_path / "assets"),
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("tail", [b"\r", b"\n", b"-", b"---", b"\r\n", b"ok"])
def test_multipart_payload_tails(tail):
    payload = b"IMAGEBYTES" + tail
    body = (b"--BOUND\r\n"
            b'Content-Disposition: form-data; name="file"; '
            b'filename="x.png"\r\nContent-Type: image/png\r\n\r\n'
            + payload + b"\r\n--BOUND--\r\n")
    ctype = "multipart/form-data; boundary=BOUND"
    got = serve.parse_multipart_file(body, ctype)
    assert got == jserve.parse_multipart_file(body, ctype) == payload


def test_multipart_quoted_boundary_and_missing_file():
    body = (b"--B1\r\nContent-Disposition: form-data; name=\"file\"; "
            b"filename=\"a\"\r\n\r\nDATA\r\n--B1--\r\n")
    ctype = 'multipart/form-data; boundary="B1"'
    assert serve.parse_multipart_file(body, ctype) == b"DATA" \
        == jserve.parse_multipart_file(body, ctype)
    nofile = (b"--B1\r\nContent-Disposition: form-data; name=\"seed\""
              b"\r\n\r\n7\r\n--B1--\r\n")
    ctype = "multipart/form-data; boundary=B1"
    assert serve.parse_multipart_file(nofile, ctype) is None
    assert jserve.parse_multipart_file(nofile, ctype) is None


def _image(seed=0):
    return (np.random.RandomState(seed).rand(96, 96, 3) * 255) \
        .astype(np.uint8)


def test_stage1_only(tmp_path):
    generate, cfg = serve.build_pipeline(_args(tmp_path))
    out = generate(_image(), seed=1, out_dir=str(tmp_path))
    assert out["n_points"] == cfg.vae.latent_num == \
        jpreset("demo-e2e").vae.latent_num
    xyz, _ = load_pointcloud_ply(str(tmp_path / out["stage1_ply"]
                                     .split("/")[-1]))
    assert xyz.shape == (cfg.vae.latent_num, 3)
    assert np.abs(xyz).max() <= 0.45 + 1e-6
    assert "gaussians_ply" not in out
    assert set(out["timings"]) == {"preprocess", "stage-1 sample"}
    again = generate(_image(), seed=1, out_dir=str(tmp_path))
    xyz2, _ = load_pointcloud_ply(str(tmp_path / again["stage1_ply"]
                                      .split("/")[-1]))
    assert np.array_equal(xyz, xyz2)           # the seed fixes the noise


@pytest.fixture(scope="module")
def vae_npz(tmp_path_factory):
    """The JAX package's demo VAE (flax init), written by its own
    `save_params_npz` as `tests/test_serve.py` does."""
    cfg = jpreset("demo-e2e")
    vae = JPointVAE.from_config(cfg.vae)
    rng = jax.random.PRNGKey(0)
    params = jax.jit(vae.init)(rng, jnp.zeros((1, 1, 15, 64, 64)),
                               jnp.zeros((1, cfg.vae.latent_num, 3)), rng)
    path = str(tmp_path_factory.mktemp("ckpt") / "vae.npz")
    jsave_params_npz(path, params)
    return path


def test_full_cascade_with_npz_vae(tmp_path, vae_npz):
    generate, cfg = serve.build_pipeline(_args(tmp_path, vae_ckpt=vae_npz))
    out = generate(_image(1), seed=2, out_dir=str(tmp_path))
    n_up = int(np.prod(cfg.vae.up_factors))
    assert out["n_gaussians"] == cfg.vae.latent_num * n_up
    g = load_2dgs_ply(str(tmp_path / out["gaussians_ply"].split("/")[-1]))
    assert g.shape == (cfg.vae.latent_num * n_up, 13)
    assert np.isfinite(g).all()
    assert {"stage-2 sample", "VAE cascade decode"} <= set(out["timings"])


# no proxy: the server is on this host
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _request(url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with _OPENER.open(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_round_trip(tmp_path, vae_npz):
    srv = serve.make_server(_args(tmp_path, vae_ckpt=vae_npz))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = "http://127.0.0.1:%d" % srv.server_address[1]
        code, body = _request(base + "/")
        assert code == 200 and b"/generate" in body
        code, body = _request(base + "/health")
        assert code == 200 and json.loads(body) == {"status": "ok",
                                                    "preset": "demo-e2e"}
        buf = io.BytesIO()
        Image.fromarray(_image(3)).save(buf, format="PNG")
        png = buf.getvalue()
        form = (b"--XYZ\r\nContent-Disposition: form-data; name=\"image\"; "
                b"filename=\"a.png\"\r\nContent-Type: image/png\r\n\r\n"
                + png + b"\r\n--XYZ--\r\n")
        code, body = _request(base + "/generate?seed=5", form, {
            "Content-Type": "multipart/form-data; boundary=XYZ"})
        assert code == 200, body
        a = json.loads(body)
        code, body = _request(base + "/generate?seed=5", png,
                              {"Content-Type": "image/png"})
        b = json.loads(body)
        assert a["seed"] == b["seed"] == 5 and a["n_gaussians"] > 0
        for key in ("stage1_ply", "stage1_glb", "gaussians_ply"):
            code, asset = _request(base + a[key])
            code2, asset2 = _request(base + b[key])
            assert code == code2 == 200 and len(asset) > 0
            if key.endswith("ply"):
                assert asset == asset2         # one seed, one image
        assert _request(base + "/assets/absent.ply")[0] == 404
        assert _request(base + "/nowhere")[0] == 404
        assert _request(base + "/generate", b"not an image",
                        {"Content-Type": "image/png"})[0] == 400
        assert _request(base + "/generate", b"--XYZ--\r\n", {
            "Content-Type": "multipart/form-data; boundary=XYZ"})[0] == 400
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


def test_as_variables_matches_jax():
    """An npz tree loads wrapped or bare (`--matting-ckpt`)."""
    from gaussiananything_tpu.utils.param_io import \
        as_variables as jas_variables
    from gaussiananything_tpu_torch.utils.param_io import as_variables
    tree = {"stage1": {"w": np.zeros(2)}}
    for t in (tree, {"params": tree}):
        assert as_variables(t) == jas_variables(t) == {"params": tree}
