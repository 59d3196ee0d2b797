"""The port's networks against the JAX package's, module by module.

Each JAX module is initialised, its parameters are replaced by seeded
random values (flax's zero inits would hide wiring faults) and carried into
the port module with `utils.param_io.from_jax_params`; the same numpy
inputs go through both. Sizes are small: depth 2, width 128, 2 heads,
DINOv2 at 56².

Tolerance atol 2e-4 / rtol 1e-3: the bound of the JAX package's own torch
parity test (`tests/test_dit_release_import.py:87`); the two frameworks sum
the fp32 matmuls and softmaxes in other orders.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.models import dinov2 as jdinov2
from gaussiananything_tpu.models import layers as jlayers
from gaussiananything_tpu.models.conditioner import \
    ImageConditioner as JImageConditioner
from gaussiananything_tpu.models.dit import PointDiT as JPointDiT
from gaussiananything_tpu.models.dit2_decoder import DiT2 as JDiT2
from gaussiananything_tpu.models.upsampler import \
    GaussianUpsampler as JGaussianUpsampler
from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu_torch.models import layers
from gaussiananything_tpu_torch.models.conditioner import ImageConditioner
from gaussiananything_tpu_torch.models.dinov2 import Dinov2ViT
from gaussiananything_tpu_torch.models.dit import PointDiT
from gaussiananything_tpu_torch.models.dit2_decoder import DiT2
from gaussiananything_tpu_torch.models.upsampler import GaussianUpsampler
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.utils.param_io import from_jax_params

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=1e-3)
W, DEPTH, HEADS = 128, 2, 2


def randomize(jmodule, seed: int, *args, **kw):
    """Seeded numpy values for every parameter of `jmodule.init(*args)`
    (its shapes only): fan-in scaled kernels, norm scales near 1, small
    biases and tables."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v)
                continue
            shape = np.shape(v)
            if k == "kernel":
                a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
            elif k in ("scale", "gamma"):
                a = 1.0 + 0.05 * rng.normal(size=shape)
            elif k == "bias":
                a = 0.1 * rng.normal(size=shape)
            else:
                a = 0.2 * rng.normal(size=shape)
            out[k] = a.astype(np.float32)
        return out

    shapes = jax.eval_shape(
        lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kw))
    return walk(shapes)


def japply(jmodule, params, *args, **kw):
    """The JAX module's output, compiled (eager flax is ~10x slower)."""
    return jax.jit(functools.partial(jmodule.apply, **kw))(params, *args)


def carry(jparams, port_module):
    """Load the JAX params into the port module; return it in eval mode."""
    port_module.load_state_dict(from_jax_params(jparams, port_module))
    return port_module.eval()


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


@pytest.mark.parametrize("img", [56, 70])
def test_dinov2(img):
    """56 = the native grid; 70 exercises the bicubic pos-embed resize."""
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 3, img, img)).astype(np.float32)
    jm = jdinov2.Dinov2ViT(width=W, depth=DEPTH, heads=HEADS, img_size=56)
    p = randomize(jm, 1, jnp.asarray(x))
    ref_tok, ref_cls = japply(jm, p, jnp.asarray(x))
    pm = carry(p, Dinov2ViT(width=W, depth=DEPTH, heads=HEADS, img_size=56))
    with torch.no_grad():
        tok, cls = pm(t(x))
    close(tok, ref_tok)
    close(cls, ref_cls)


def test_image_conditioner():
    """64² input: the conditioner's own bicubic resize to 56 runs too."""
    r = np.random.default_rng(1)
    img = r.uniform(size=(2, 3, 64, 64)).astype(np.float32)
    jm = JImageConditioner(width=W, depth=DEPTH, heads=HEADS, img_size=56,
                           backbone="dinov2")
    p = randomize(jm, 2, jnp.asarray(img))
    ref = japply(jm, p, jnp.asarray(img))
    pm = carry(p, ImageConditioner(width=W, depth=DEPTH, heads=HEADS,
                                  img_size=56))
    with torch.no_grad():
        got = pm(t(img))
    close(got.crossattn, ref.crossattn)
    close(got.vector, ref.vector)


@pytest.mark.parametrize("stage", [1, 2])
def test_point_dit_release(stage):
    in_ch = 3 if stage == 1 else 10
    r = np.random.default_rng(stage)
    B, N, L, C = 2, 12, 9, 96
    x = r.normal(size=(B, N, in_ch)).astype(np.float32)
    tt = r.uniform(size=(B,)).astype(np.float32)
    tokens = (0.5 * r.normal(size=(B, L, C))).astype(np.float32)
    vec = (0.5 * r.normal(size=(B, C))).astype(np.float32)
    xyz = r.uniform(-0.45, 0.45, (B, N, 3)).astype(np.float32)
    jm = JPointDiT(in_channels=in_ch, width=W, depth=DEPTH, heads=HEADS,
                   cond_dim=C, vector_dim=C, use_xyz_pe=(stage == 2),
                   release_parity=True)
    kw = dict(xyz=jnp.asarray(xyz)) if stage == 2 else {}
    args = [jnp.asarray(a) for a in (x, tt, tokens, vec)]
    p = randomize(jm, 3, *args, **kw)
    ref = japply(jm, p, *args, **kw)
    pm = carry(p, PointDiT(in_channels=in_ch, width=W, depth=DEPTH,
                          heads=HEADS, cond_dim=C, vector_dim=C,
                          use_xyz_pe=(stage == 2)))
    with torch.no_grad():
        got = pm(t(x), t(tt), t(tokens), t(vec),
                 xyz=t(xyz) if stage == 2 else None)
    close(got, ref)


def test_dit2_release():
    r = np.random.default_rng(4)
    c = r.normal(size=(2, 12, W)).astype(np.float32)
    jm = JDiT2(num_tokens=12, width=W, depth=DEPTH, heads=HEADS,
               release_parity=True)
    p = randomize(jm, 5, jnp.asarray(c))
    ref = japply(jm, p, jnp.asarray(c))
    pm = carry(p, DiT2(num_tokens=12, width=W, depth=DEPTH, heads=HEADS))
    with torch.no_grad():
        got = pm(t(c))
    close(got, ref)


def test_gaussian_upsampler_release():
    r = np.random.default_rng(6)
    feat = r.normal(size=(2, 6, W)).astype(np.float32)
    raw = r.normal(size=(2, 6, 13)).astype(np.float32)
    pxyz = r.uniform(-0.4, 0.4, (2, 6, 3)).astype(np.float32)
    jm = JGaussianUpsampler(factor=4, depth=DEPTH, release_parity=True)
    args = [jnp.asarray(a) for a in (feat, raw, pxyz)]
    p = randomize(jm, 7, *args)
    ref = japply(jm, p, *args)
    pm = carry(p, GaussianUpsampler(W, factor=4, depth=DEPTH))
    with torch.no_grad():
        got = pm(t(feat), t(raw))
    for g, rr in zip(got, ref):
        close(g, rr)


def test_point_vae_decode_release():
    """up_factors (8, 4, 3): 12 → 96 → 384 → 1152 gaussians."""
    K, ZC = 12, 10
    r = np.random.default_rng(8)
    z = r.normal(size=(1, K, ZC)).astype(np.float32)
    anchors = r.uniform(-0.4, 0.4, (1, K, 3)).astype(np.float32)
    jm = JPointVAE(latent_num=K, z_channels=ZC, decoder_width=W,
                   decoder_depth=DEPTH, decoder_heads=HEADS,
                   up_factors=(8, 4, 3), up_depths=(2, 1, 1),
                   release_parity=True)
    p = randomize(jm, 9, jnp.asarray(z), jnp.asarray(anchors),
                  method=JPointVAE.decode)
    ref = japply(jm, p, jnp.asarray(z), jnp.asarray(anchors),
                   method=JPointVAE.decode)
    pm = carry(p, PointVAE(latent_num=K, z_channels=ZC, decoder_width=W,
                          decoder_depth=DEPTH, decoder_heads=HEADS,
                          up_factors=(8, 4, 3), up_depths=(2, 1, 1)))
    with torch.no_grad():
        got = pm.decode(t(z), t(anchors))
    assert [g.shape[1] for g in got] == [12, 96, 384, 1152]
    for g, rr in zip(got, ref):
        close(g, rr)


def test_cross_attention_block():
    r = np.random.default_rng(10)
    q = r.normal(size=(2, 7, W)).astype(np.float32)
    kv = r.normal(size=(2, 11, W)).astype(np.float32)
    jm = jlayers.CrossAttentionBlock(heads=HEADS)
    p = randomize(jm, 11, jnp.asarray(q), jnp.asarray(kv))
    ref = japply(jm, p, jnp.asarray(q), jnp.asarray(kv))
    pm = carry(p, layers.CrossAttentionBlock(W, HEADS))
    with torch.no_grad():
        got = pm(t(q), t(kv))
    close(got, ref)


def test_blocked_attention_matches_one_block(monkeypatch):
    """Query blocking changes no value (`layers.py:32-68`)."""
    r = np.random.default_rng(12)
    q, k, v = (t(r.normal(size=(1, 40, 2, 8))) for _ in range(3))
    whole = layers.dot_attention(q, k, v)
    monkeypatch.setattr(layers, "_SCORES_BLOCK_THRESHOLD", 100)
    monkeypatch.setattr(layers, "_QUERY_BLOCK", 16)
    blocked = layers.dot_attention(q, k, v)
    torch.testing.assert_close(blocked, whole, atol=1e-6, rtol=1e-6)
    ref = jlayers._blocked_attention(*(jnp.asarray(a.numpy())
                                       for a in (q, k, v)))
    close(whole, ref)


@pytest.mark.parametrize("multires", [4, 10])
def test_fourier_and_timestep_embed(multires):
    r = np.random.default_rng(13)
    xyz = r.uniform(-1, 1, (3, 5, 3)).astype(np.float32)
    close(layers.fourier_embed(t(xyz), multires),
          jlayers.fourier_embed(jnp.asarray(xyz), multires), atol=1e-5)
    tt = r.uniform(size=(4,)).astype(np.float32)
    jm = jlayers.TimestepEmbedder(W)
    p = randomize(jm, 14, jnp.asarray(tt))
    pm = layers.TimestepEmbedder(W)
    sd = {"mlp.0.weight": t(p["params"]["Dense_0"]["kernel"].T),
          "mlp.0.bias": t(p["params"]["Dense_0"]["bias"]),
          "mlp.2.weight": t(p["params"]["Dense_1"]["kernel"].T),
          "mlp.2.bias": t(p["params"]["Dense_1"]["bias"])}
    pm.load_state_dict(sd)
    with torch.no_grad():
        close(pm(t(tt)), japply(jm, p, jnp.asarray(tt)))
