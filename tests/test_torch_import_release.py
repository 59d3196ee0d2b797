"""The port's checkpoint import (`cli/import_release.py`,
`utils/release_import.py`, the layout drawn by `utils/param_io.jax_layout`)
against the JAX package's: the same reference state dicts (the mirrors of
`tests/torch_mirror_ga.py` and the synthetic state dicts of the JAX import
tests) go through both, and the port's npz must equal the JAX CLI's leaf
for leaf, bit for bit (same names, dtypes and bytes).

The DiT kinds run the JAX CLI itself. For the others the JAX side is the
CLI's own steps (`load_torch_checkpoint`, the converter, the CLI's
nesting) on a template of zeros shaped by `jax.eval_shape` of the module's
init: the converters overwrite every leaf of these full-coverage state
dicts (the VAE's raises otherwise; the others are checked here), so the
init's values never reach the npz and an eager flax init (a minute for
the release VAE on the CPU) is not needed."""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from gaussiananything_tpu.cli import import_release as jcli
from gaussiananything_tpu.utils import param_io as jio
from gaussiananything_tpu_torch.cli import import_release as pcli
from gaussiananything_tpu_torch.utils import release_import as pri
from gaussiananything_tpu_torch.utils.param_io import (from_jax_params,
                                                       jax_layout,
                                                       load_params_npz)

from torch_mirror_ga import TorchClayDiT, TorchReleaseVAE, TorchTextDiT

torch.set_num_threads(2)


def _randomize(model: torch.nn.Module, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _save(tmp_path, sd_or_module):
    pt = tmp_path / "ckpt.pt"
    sd = sd_or_module.state_dict() if isinstance(
        sd_or_module, torch.nn.Module) else sd_or_module
    torch.save(sd, pt)
    return str(pt)


def _port_cli(tmp_path, pt, argv):
    out = tmp_path / "port.npz"
    pcli.main(["--ckpt", pt, "--out", str(out), *argv])
    return _npz(out)


def _both_clis(tmp_path, sd_or_module, argv):
    pt = _save(tmp_path, sd_or_module)
    out = tmp_path / "jax.npz"
    jcli.main(["--ckpt", pt, "--out", str(out), *argv])
    return _npz(out), _port_cli(tmp_path, pt, argv)


def _zeros_template(init, *args):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        jax.eval_shape(init, jax.random.PRNGKey(0), *args))


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in
            flatten_dict(jax.tree.map(np.asarray, tree), sep="/").items()}


def _covered(sd, name_map, template_params):
    """Every template leaf has a source in `sd`."""
    mapped = {name_map(k) for k in sd} - {None}
    assert mapped == set(_flat(template_params))


def test_vae_npz_equals_jax(tmp_path):
    """The release VAE mirror at a scaled width (the CLI's `--width
    --depth --heads --latent-num`); the port's npz then loads into the
    port's release-layout `PointVAE`."""
    from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
    tm = _randomize(TorchReleaseVAE(num_tokens=12, dim=128, depth=2,
                                    heads=2))
    pt = _save(tmp_path, tm)
    got = _port_cli(tmp_path, pt, [
        "--kind", "vae", "--width", "128", "--depth", "2", "--heads", "2",
        "--latent-num", "12"])
    jm = JPointVAE(encoder_width=256, release_parity=True,
                   decoder_width=128, decoder_depth=2, decoder_heads=2,
                   latent_num=12)
    tpl = _zeros_template(lambda r, *a: jm.init(r, *a, r),
                          jnp.zeros((1, 1, 15, 64, 64)),
                          jnp.zeros((1, 12, 3)))
    want = _flat(jio.convert_gaussiananything_vae(
        jcli.load_torch_checkpoint(pt), tpl))
    _assert_bit_equal(got, want)
    from gaussiananything_tpu_torch.models.vae import PointVAE
    pm = PointVAE(latent_num=12, decoder_width=128, decoder_depth=2,
                  decoder_heads=2, release_parity=True, with_encoder=True,
                  encoder_width=256)
    pm.load_state_dict(from_jax_params(
        load_params_npz(str(tmp_path / "port.npz")), pm))


@pytest.mark.parametrize("kind", ["dit-stage1", "dit-stage2",
                                  "dit-t23d-stage1", "dit-t23d-stage2"])
def test_dit_npz_equals_jax(tmp_path, kind):
    stage2 = kind.endswith("stage2")
    mirror = TorchTextDiT if "t23d" in kind else TorchClayDiT
    tm = _randomize(mirror(in_channels=10 if stage2 else 3, dim=128,
                           depth=2, heads=2, ctx_dim=96,
                           use_pe_cond=stage2), seed=len(kind))
    want, got = _both_clis(tmp_path, tm, [
        "--kind", kind, "--width", "128", "--depth", "2", "--heads", "2",
        "--cond-dim", "96"])
    _assert_bit_equal(got, want)


def test_lpips_npz_equals_jax(tmp_path):
    from test_lpips import synth_lpips_state_dict

    from gaussiananything_tpu.train.losses import VGGLPIPS
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
          synth_lpips_state_dict(np.random.default_rng(0)).items()}
    pt = _save(tmp_path, sd)
    got = _port_cli(tmp_path, pt, ["--kind", "lpips-vgg"])
    x = jnp.zeros((1, 32, 32, 3))
    tpl = _zeros_template(VGGLPIPS().init, x, x)
    jsd = jcli.load_torch_checkpoint(pt)
    _covered(jsd, jio.lpips_vgg_name_map, tpl["params"])
    _assert_bit_equal(got, _flat(jio.convert_lpips_vgg(jsd, tpl)))


def test_dinov2_and_clip_text_convert_like_jax():
    """The frozen towers at the JAX import tests' small widths (the CLI's
    kinds are the full ViT-L towers): each converter on the port's layout
    of the same architecture equals the JAX converter on the flax
    template, mask_token and the visual tower skipped."""
    from test_conditioners import (D, DEPTH, HEADS, IMG, PATCH, TD, TDEPTH,
                                   THEADS, TLEN, TVOCAB,
                                   synth_clip_text_state_dict,
                                   synth_dinov2_state_dict)

    from gaussiananything_tpu.models.dinov2 import Dinov2ViT as JDino
    from gaussiananything_tpu.models.openclip_text import \
        OpenClipTextTower as JClip
    from gaussiananything_tpu_torch.models.dinov2 import Dinov2ViT
    from gaussiananything_tpu_torch.models.openclip_text import \
        OpenClipTextTower

    sd = synth_dinov2_state_dict(np.random.default_rng(0))
    tpl = _zeros_template(JDino(patch=PATCH, width=D, depth=DEPTH,
                                heads=HEADS, num_registers=4,
                                img_size=IMG).init,
                          jnp.zeros((1, 3, IMG, IMG)))
    _covered(sd, jio.dinov2_name_map, tpl["params"])
    with torch.device("meta"):
        pm = Dinov2ViT(patch=PATCH, width=D, depth=DEPTH, heads=HEADS,
                       num_registers=4, img_size=IMG)
    _assert_bit_equal(pri.convert_dinov2(sd, jax_layout(pm)),
                      _flat(jio.convert_dinov2(sd, tpl["params"])))

    sd = synth_clip_text_state_dict(np.random.default_rng(2))
    tpl = _zeros_template(JClip(vocab=TVOCAB, width=TD, depth=TDEPTH,
                                heads=THEADS, max_len=TLEN,
                                embed_dim=TD).init,
                          jnp.zeros((1, TLEN), jnp.int32))
    _covered(sd, jio.openclip_text_name_map, tpl["params"])
    with torch.device("meta"):
        pm = OpenClipTextTower(vocab=TVOCAB, width=TD, depth=TDEPTH,
                               heads=THEADS, max_len=TLEN, embed_dim=TD)
    _assert_bit_equal(pri.convert_openclip_text(sd, jax_layout(pm)),
                      _flat(jio.convert_openclip_text(sd, tpl["params"])))


def test_u2net_converts_like_jax():
    """`u2netp` (the JAX matting test's net) from a state dict with the
    true torch names, BatchNorm statistics and `num_batches_tracked`
    included."""
    from test_matting import _inverse_torch_name

    from gaussiananything_tpu.models import matting as jm
    from gaussiananything_tpu_torch.models.matting import u2netp

    tpl = _zeros_template(jm.u2netp().init, jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(0)
    sd = {}
    for path, leaf in _flat(tpl["params"]).items():
        arr = (0.02 * rng.normal(size=leaf.shape)).astype(np.float32)
        sd[_inverse_torch_name(path)] = arr.transpose(3, 2, 0, 1) \
            if arr.ndim == 4 else arr
    sd["stage1.rebnconvin.bn_s1.num_batches_tracked"] = np.zeros(())
    with torch.device("meta"):
        pm = u2netp()
    _assert_bit_equal(pri.convert_u2net(sd, jax_layout(pm)),
                      _flat(jio.convert_u2net(sd, tpl["params"])))


def test_unwraps_nested_and_ddp(tmp_path):
    tm = TorchClayDiT(in_channels=3, dim=128, depth=1, heads=2, ctx_dim=96)
    wrapped = {"state_dict": {f"module.{k}": v
                              for k, v in tm.state_dict().items()},
               "step": 100}
    pt = tmp_path / "wrapped.pt"
    torch.save(wrapped, pt)
    sd = pcli.load_torch_checkpoint(str(pt))
    assert "final_layer.linear.weight" in sd
    assert not any(k.startswith("module.") for k in sd)
    assert "step" not in sd
    assert sd.keys() == jcli.load_torch_checkpoint(str(pt)).keys()
    for nest in ("model", "ema"):
        torch.save({nest: tm.state_dict()}, pt)
        assert pcli.load_torch_checkpoint(str(pt)).keys() == sd.keys()


def test_uncovered_leaf_raises():
    """A checkpoint that leaves a template leaf without a value is refused
    (the JAX converters keep the flax init's random value there)."""
    tm = TorchClayDiT(in_channels=3, dim=128, depth=1, heads=2, ctx_dim=96)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()
          if k != "final_layer.linear.bias"}
    with pytest.raises(KeyError):
        pcli.convert("dit-stage1", sd, width=128, depth=1, heads=2,
                     cond_dim=96)
