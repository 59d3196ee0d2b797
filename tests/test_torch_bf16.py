"""bf16 compute in the port, against its own fp32 and against the JAX
package's bf16 (`tests/test_bf16.py`): the parameters fp32 (JAX
`tests/test_bf16.py:34-41`), the Linear layers' outputs bf16, norms and
softmax in fp32, the activated gaussians fp32.

Bounds are the JAX package's own: the DiT velocity within 0.05·max(scale,
1) (`tests/test_bf16.py:94-96`), the decoded gaussians within 0.05
(`:59-60`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.models.dit import PointDiT as JPointDiT
from gaussiananything_tpu.models.dit import stage1_dit as jstage1_dit
from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu_torch.models import layers
from gaussiananything_tpu_torch.models.conditioner import (ImageConditioner,
                                                           TextConditioner)
from gaussiananything_tpu_torch.models.dit import PointDiT, stage1_dit
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.ops.gaussians import (activate_gaussians,
                                                      activate_gaussians_at)
from gaussiananything_tpu_torch.utils.param_io import from_jax_params
from test_torch_models import randomize, t

torch.set_num_threads(2)
BF16 = torch.bfloat16


def _norm_dtypes(module):
    """Record the output dtype of every norm of `module` on a forward."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
             for m in module.modules()
             if isinstance(m, (layers.LayerNorm, layers.RMSNorm))]
    return seen, hooks


def _float_dtypes(module):
    return {p.dtype for p in module.parameters()} | {
        b.dtype for b in module.buffers() if b.is_floating_point()}


def _linear_dtypes(module):
    """Record the output dtype of every Linear of `module` on a forward."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
             for m in module.modules() if isinstance(m, layers.Linear)]
    return seen, hooks


def _dit_case(kind):
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 32, 3)).astype(np.float32)
    tt = np.full((2,), 0.3, np.float32)
    ctx = r.normal(size=(2, 5, 32)).astype(np.float32)
    vec = r.normal(size=(2, 32)).astype(np.float32)
    kw = dict(depth=2, width=64, heads=4, cond_dim=32, vector_dim=32)
    if kind == "S":
        return (x, tt, ctx, vec), functools.partial(jstage1_dit, "S", **kw), \
            functools.partial(stage1_dit, "S", **kw)
    variant = "text" if kind == "t23d" else "clay"
    return (x, tt, ctx, vec), \
        functools.partial(JPointDiT, release_parity=True, variant=variant,
                          **kw), \
        functools.partial(PointDiT, variant=variant, **kw)


@pytest.mark.parametrize("kind", ["S", "release", "t23d"])
def test_dit_bf16(kind):
    """The non-release `stage1_dit("S")` of the JAX test, and the release
    CLAY and text layouts."""
    args, jmake, make = _dit_case(kind)
    jargs = [jnp.asarray(a) for a in args]
    params = randomize(jmake(), 1, *jargs)
    jv16 = np.asarray(jax.jit(jmake(dtype=jnp.bfloat16).apply)(
        params, *jargs), np.float32)
    m32 = make()
    m32.load_state_dict(from_jax_params(params, m32))
    m16 = make(dtype=BF16)
    m16.load_state_dict(from_jax_params(params, m16))
    assert _float_dtypes(m16) == {torch.float32}
    seen, hooks = _norm_dtypes(m16)
    lin, lin_hooks = _linear_dtypes(m16)
    with torch.no_grad():
        v32 = m32(*map(t, args))
        v16 = m16(*map(t, args))
    for h in hooks + lin_hooks:
        h.remove()
    assert seen and set(seen) == {torch.float32}
    assert lin and set(lin) == {BF16}
    assert v16.dtype == torch.float32
    scale = float(v32.abs().max())
    np.testing.assert_allclose(v16.numpy(), v32.numpy(),
                               atol=0.05 * max(scale, 1.0))
    np.testing.assert_allclose(v16.numpy(), jv16,
                               atol=0.05 * max(scale, 1.0))


@pytest.mark.parametrize("release", [False, True])
def test_vae_decode_bf16(release):
    """The JAX test's tiny VAE on its own initialisation (flax init at
    PRNGKey(0), as `tests/test_bf16.py:51-60`): with fan-in seeded weights
    every head is live and the quaternion normalisation of small raw
    rotations lifts JAX's own bf16-vs-fp32 difference to 0.15, so the
    0.05 bound is the JAX test's for its init."""
    kw = dict(latent_num=12, z_channels=4, decoder_width=64,
              decoder_heads=4, decoder_depth=2, up_factors=(4,),
              up_depths=(1,), release_parity=release)
    r = np.random.default_rng(2)
    z = r.normal(size=(1, 12, 4)).astype(np.float32)
    anchors = r.uniform(-0.3, 0.3, size=(1, 12, 3)).astype(np.float32)
    jm = JPointVAE(encoder_width=64, **kw)
    params = jax.tree.map(np.array, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(anchors),
        method=JPointVAE.decode))
    jlods = jax.jit(functools.partial(
        JPointVAE(encoder_width=64, dtype=jnp.bfloat16, **kw).apply,
        method=JPointVAE.decode))(params, jnp.asarray(z),
                                  jnp.asarray(anchors))
    m32 = PointVAE(**kw)
    m32.load_state_dict(from_jax_params(params, m32))
    m16 = PointVAE(dtype=BF16, **kw)
    m16.load_state_dict(from_jax_params(params, m16))
    assert _float_dtypes(m16.decoder) == {torch.float32}
    seen, hooks = _norm_dtypes(m16)
    lin, lin_hooks = _linear_dtypes(m16.decoder)
    with torch.no_grad():
        g32 = m32.decode(t(z), t(anchors))
        g16 = m16.decode(t(z), t(anchors))
    for h in hooks + lin_hooks:
        h.remove()
    assert seen and set(seen) == {torch.float32}
    assert lin and set(lin) == {BF16}
    for a, b, j in zip(g16, g32, jlods):
        assert a.dtype == torch.float32          # what the rasterizer reads
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.05)
        np.testing.assert_allclose(a.numpy(), np.asarray(j, np.float32),
                                   atol=0.05)


def test_activation_pins_fp32():
    raw = torch.zeros((2, 8, 13), dtype=BF16)
    anchors = torch.zeros((2, 8, 3), dtype=BF16)
    assert activate_gaussians(raw, anchors).dtype == torch.float32
    assert activate_gaussians_at(anchors, raw).dtype == torch.float32


@pytest.mark.parametrize("which", ["scratch", "dinov2", "bytes", "openclip"])
def test_conditioners_bf16(which):
    """bf16 conditioners: fp32 weights, bf16 Linear outputs, finite
    outputs within 0.05 of their own fp32."""
    torch.manual_seed(0)
    if which in ("scratch", "dinov2"):
        make = functools.partial(ImageConditioner, width=32, depth=1,
                                 heads=4, img_size=28, backbone=which)
        inp = torch.rand((2, 3, 28, 28))
    else:
        make = functools.partial(TextConditioner, width=32, depth=1,
                                 heads=4, backbone=which)
        inp = torch.randint(1, 250, (2, 77))
    m32 = make().eval()
    m16 = make(dtype=BF16).eval()
    m16.load_state_dict(m32.state_dict())
    assert _float_dtypes(m16) == {torch.float32}
    lin, hooks = _linear_dtypes(m16)
    with torch.no_grad():
        c32, c16 = m32(inp), m16(inp)
    for h in hooks:
        h.remove()
    assert lin and set(lin) == {BF16}
    for a, b in zip(c16, c32):
        assert torch.isfinite(a.float()).all()
        scale = max(float(b.abs().max()), 1.0)
        np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                   atol=0.05 * scale)


def test_attention_softmax_in_fp32():
    """The scores and softmax run in fp32 on bf16 inputs; the second
    product in bf16, as `jax.nn.dot_product_attention`."""
    r = np.random.default_rng(5)
    q, k, v = (r.normal(size=(1, 6, 2, 8)).astype(np.float32)
               for _ in range(3))
    ref = jax.nn.dot_product_attention(*(jnp.asarray(a, jnp.bfloat16)
                                         for a in (q, k, v)))
    got = layers.dot_attention(*(t(a).to(BF16) for a in (q, k, v)))
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=1e-2)
