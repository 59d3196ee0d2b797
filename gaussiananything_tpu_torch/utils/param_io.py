"""Weights carried across from the JAX package's parameter trees.

`from_jax_params(params_np, module)` turns a flax parameter tree (nested
dicts of numpy arrays, bare or wrapped in `{"params": ...}`) into the
`state_dict` of the matching port module. It inverts the mappings of
`gaussiananything_tpu/utils/param_io.py` (`convert_dinov2`,
`convert_gaussiananything_dit`, `convert_gaussiananything_vae`,
`convert_lpips_vgg`, `convert_openclip_text`, `convert_u2net`): Dense
kernels (in, out) become Linear weights (out, in), conv kernels HWIO become
OIHW (the port's convolutions run NCHW), and the separate q/k/v kernels of
a packed attention are fused back into one `qkv` weight.

`save_params_npz` / `load_params_npz` write and read such trees in the JAX
package's npz layout: one array per leaf, keyed by the path joined with
"/" (`gaussiananything_tpu/utils/param_io.py:18-30`).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from gaussiananything_tpu_torch.models.conditioner import (ImageConditioner,
                                                           TextConditioner,
                                                           TextTransformer,
                                                           VisionTransformer)
from gaussiananything_tpu_torch.models.dinov2 import Dinov2ViT
from gaussiananything_tpu_torch.models.dit import PointDiT
from gaussiananything_tpu_torch.models.dit2_decoder import DiT2
from gaussiananything_tpu_torch.models.encoder import (HybridPCDEncoder,
                                                       MVConvEncoder)
from gaussiananything_tpu_torch.models.layers import CrossAttentionBlock
from gaussiananything_tpu_torch.models.matting import REBNCONV, U2Net
from gaussiananything_tpu_torch.models.openclip_text import OpenClipTextTower
from gaussiananything_tpu_torch.models.sd_encoder import SDEncoderTrunk
from gaussiananything_tpu_torch.models.upsampler import GaussianUpsampler
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.train.losses import (_VGG_CONVS,
                                                     LPIPS_CHANNELS,
                                                     PatchDiscriminator,
                                                     PerceptualNet, VGGLPIPS)

Flat = Dict[str, np.ndarray]


def _flatten(tree: Mapping, prefix: str = "") -> Flat:
    out: Flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def save_params_npz(path: str, params: Mapping):
    """Write a nested tree of arrays as a compressed npz, one entry per
    leaf keyed "a/b/c"."""
    np.savez_compressed(path, **_flatten(params))


def load_params_npz(path: str) -> dict:
    """Read an npz of "/"-joined keys back into a nested dict of numpy
    arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def as_variables(params: Mapping) -> dict:
    """A parameter tree in flax's variables form {"params": ...}, whether
    or not it was saved wrapped (`utils/param_io.as_variables`)."""
    if isinstance(params, Mapping) and set(params) == {"params"}:
        return dict(params)
    return {"params": params}


class _Mapper:
    """Collects port-name → array entries read from the flat JAX tree."""

    def __init__(self, flat: Flat):
        self.flat = flat
        self.out: Flat = {}

    def copy(self, tname: str, jname: str):
        self.out[tname] = self.flat[jname]

    def dense(self, tname: str, jname: str):
        """flax Dense (kernel (in,out), bias) → torch Linear."""
        self.out[f"{tname}.weight"] = self.flat[f"{jname}/kernel"].T
        if f"{jname}/bias" in self.flat:
            self.out[f"{tname}.bias"] = self.flat[f"{jname}/bias"]

    def conv(self, tname: str, jname: str):
        """flax Conv (kernel HWIO[, bias]) → torch Conv2d (OIHW)."""
        self.out[f"{tname}.weight"] = \
            self.flat[f"{jname}/kernel"].transpose(3, 2, 0, 1)
        if f"{jname}/bias" in self.flat:
            self.out[f"{tname}.bias"] = self.flat[f"{jname}/bias"]

    def norm(self, tname: str, jname: str):
        """flax LayerNorm/RMSNorm (scale[, bias]) → weight[, bias]."""
        self.out[f"{tname}.weight"] = self.flat[f"{jname}/scale"]
        if f"{jname}/bias" in self.flat:
            self.out[f"{tname}.bias"] = self.flat[f"{jname}/bias"]

    def mlp(self, tname: str, jname: str):
        self.dense(f"{tname}.fc1", f"{jname}/Dense_0")
        self.dense(f"{tname}.fc2", f"{jname}/Dense_1")

    def packed_attention(self, tname: str, jname: str):
        """JAX `Attention` (to_q/to_k/to_v/to_out [+ q_norm/k_norm]) →
        port `Attention` (fused qkv, proj)."""
        f = self.flat
        self.out[f"{tname}.qkv.weight"] = np.concatenate(
            [f[f"{jname}/to_{n}/kernel"].T for n in "qkv"], axis=0)
        if f"{jname}/to_q/bias" in f:
            self.out[f"{tname}.qkv.bias"] = np.concatenate(
                [f[f"{jname}/to_{n}/bias"] for n in "qkv"], axis=0)
        self._qk_norms(tname, jname)
        self.dense(f"{tname}.proj", f"{jname}/to_out")

    def cross_attention(self, tname: str, jname: str):
        for n in "qkv":
            self.dense(f"{tname}.to_{n}", f"{jname}/to_{n}")
        self._qk_norms(tname, jname)
        self.dense(f"{tname}.to_out.0", f"{jname}/to_out")

    def _qk_norms(self, tname: str, jname: str):
        if f"{jname}/q_norm/scale" in self.flat:
            self.norm(f"{tname}.q_norm", f"{jname}/q_norm")
            self.norm(f"{tname}.k_norm", f"{jname}/k_norm")

    def transformer_block(self, tname: str, jname: str):
        """JAX `TransformerBlock` → port `TransformerBlock`."""
        self.norm(f"{tname}.0.norm", f"{jname}/LayerNorm_0")
        self.packed_attention(f"{tname}.0.fn", f"{jname}/Attention_0")
        self.norm(f"{tname}.1.norm", f"{jname}/LayerNorm_1")
        self.mlp(f"{tname}.1.fn", f"{jname}/Mlp_0")


def _dinov2(m: _Mapper, t: str, j: str, depth: int):
    for n in ("cls_token", "pos_embed", "register_tokens"):
        m.copy(f"{t}{n}", f"{j}{n}")
    m.out[f"{t}patch_embed.proj.weight"] = \
        m.flat[f"{j}patch_embed/kernel"].transpose(3, 2, 0, 1)
    m.copy(f"{t}patch_embed.proj.bias", f"{j}patch_embed/bias")
    for i in range(depth):
        tb, jb = f"{t}blocks.{i}.", f"{j}blocks.{i}/"
        m.norm(tb + "norm1", jb + "norm1")
        m.norm(tb + "norm2", jb + "norm2")
        m.dense(tb + "attn.qkv", jb + "attn/qkv")
        m.dense(tb + "attn.proj", jb + "attn/proj")
        m.copy(tb + "ls1.gamma", jb + "ls1/gamma")
        m.copy(tb + "ls2.gamma", jb + "ls2/gamma")
        m.dense(tb + "mlp.fc1", jb + "mlp.fc1")
        m.dense(tb + "mlp.fc2", jb + "mlp.fc2")
    m.norm(f"{t}norm", f"{j}norm")


def _point_dit(m: _Mapper, module: PointDiT):
    m.mlp("x_embedder", "x_embedder")
    m.dense("t_embedder.mlp.0", "t_embedder/Dense_0")
    m.dense("t_embedder.mlp.2", "t_embedder/Dense_1")
    if module.release_parity:
        m.norm(f"{module.vec_name}.0", "pooled_vec_ln")
        m.dense(f"{module.vec_name}.1", "vector_proj")
    else:
        m.dense("vector_proj", "vector_proj")
        m.dense("cond_proj", "cond_proj")
    m.dense("adaLN_modulation.1", "shared_adaln")
    if module.xyz_pos_embed is not None:
        m.dense("xyz_pos_embed.xyz_projection", "xyz_pe/Dense_0")
    for i, blk in enumerate(module.blocks):
        t, j = f"blocks.{i}.", f"block_{i}/"
        m.copy(t + "scale_shift_table", j + "scale_shift_table")
        m.norm(t + "norm1", j + "norm1")
        m.norm(t + "norm2", j + "norm2")
        if blk.variant == "clay":
            m.norm(t + "prenorm_ca_dino", j + "prenorm_ca")
            m.cross_attention(t + "cross_attn_dino", j + "cross_attn")
        else:
            m.norm(t + "prenorm_ca_text", j + "prenorm_ca")
            if blk.attention_y_norm is not None:
                m.norm(t + "attention_y_norm", j + "attention_y_norm")
            m.cross_attention(t + "cross_attn", j + "cross_attn")
        m.packed_attention(t + "attn", j + "self_attn")
        m.mlp(t + "mlp", j + "Mlp_0")
    m.copy("final_layer.scale_shift_table", "final_scale_shift")
    if not module.release_parity:
        m.dense("final_layer.adaLN_modulation.1", "final_adaln")
        m.norm("final_layer.norm_final", "RMSNorm_0")
    m.dense("final_layer.linear", "final_proj")


def _scratch_vit(m: _Mapper, t: str, j: str, module: VisionTransformer):
    m.conv(f"{t}patch_embed", f"{j}patch_embed")
    m.copy(f"{t}cls_token", f"{j}cls_token")
    m.copy(f"{t}reg_tokens", f"{j}reg_tokens")
    for i in range(len(module.blocks)):
        m.transformer_block(f"{t}blocks.{i}", f"{j}block_{i}")
    m.norm(f"{t}norm", f"{j}LayerNorm_0")


def _text_transformer(m: _Mapper, t: str, j: str, module: TextTransformer):
    m.copy(f"{t}embed.weight", f"{j}Embed_0/embedding")
    m.copy(f"{t}pos", f"{j}pos")
    for i in range(len(module.blocks)):
        m.transformer_block(f"{t}blocks.{i}", f"{j}block_{i}")
    m.norm(f"{t}norm", f"{j}LayerNorm_0")


def _openclip_text(m: _Mapper, t: str, j: str, module: OpenClipTextTower):
    m.copy(f"{t}token_embedding.weight", f"{j}token_embedding/embedding")
    m.copy(f"{t}positional_embedding", f"{j}positional_embedding")
    m.copy(f"{t}text_projection", f"{j}text_projection")   # applied x @ W
    for i in range(len(module.transformer.resblocks)):
        tb, jb = f"{t}transformer.resblocks.{i}.", f"{j}resblocks.{i}/"
        m.norm(tb + "ln_1", jb + "ln_1")
        m.norm(tb + "ln_2", jb + "ln_2")
        m.out[tb + "attn.in_proj_weight"] = \
            m.flat[jb + "attn.in_proj/kernel"].T
        m.copy(tb + "attn.in_proj_bias", jb + "attn.in_proj/bias")
        m.dense(tb + "attn.out_proj", jb + "attn.out_proj")
        m.dense(tb + "mlp.c_fc", jb + "mlp.c_fc")
        m.dense(tb + "mlp.c_proj", jb + "mlp.c_proj")
    m.norm(f"{t}ln_final", f"{j}ln_final")


def _image_conditioner(m: _Mapper, module: ImageConditioner):
    if module.backbone == "scratch":
        _scratch_vit(m, "vit.", "vit/", module.vit)
    else:
        _dinov2(m, "vit.", "vit/", len(module.vit.blocks))


def _text_conditioner(m: _Mapper, module: TextConditioner):
    if isinstance(module.text, OpenClipTextTower):
        _openclip_text(m, "text.", "text/", module.text)
    else:
        _text_transformer(m, "text.", "text/", module.text)


def _u2net(m: _Mapper, module: U2Net):
    """Torch names `a.b.conv_s1` / `a.b.bn_s1.*`; flax `a/b/conv_s1`,
    `a/b/bn_{scale,bias,mean,var}`; the side and fused convs by name."""
    for name, sub in module.named_modules():
        j = name.replace(".", "/")
        if isinstance(sub, REBNCONV):
            m.conv(f"{name}.conv_s1", f"{j}/conv_s1")
            for tk, jk in (("weight", "bn_scale"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
                m.copy(f"{name}.bn_s1.{tk}", f"{j}/{jk}")
        elif name.startswith("side") or name == "outconv":
            m.conv(name, j)


def _dit2(m: _Mapper, t: str, j: str, depth: int):
    m.copy(f"{t}pos_embed", f"{j}query_pos_embed")
    if f"{j}LayerNorm_0/scale" in m.flat:          # the non-release layout
        m.norm(f"{t}norm", f"{j}LayerNorm_0")
    for i in range(depth):
        tb, jb = f"{t}blocks.{i}.", f"{j}block_{i}/"
        m.packed_attention(tb + "attn", jb + "Attention_0")
        m.mlp(tb + "mlp", jb + "Mlp_0")
        m.dense(tb + "adaLN_modulation.1", jb + "adaLN")


def _upsampler(m: _Mapper, t: str, j: str, module: GaussianUpsampler):
    m.out[f"{t}latent_embedding"] = m.flat[f"{j}latent_embedding"][0]
    if module.xyz_embed is not None:
        m.dense(f"{t}xyz_embed.xyz_projection", f"{j}XYZPosEmbed_0/Dense_0")
    for i in range(len(module.transformer.layers)):
        m.transformer_block(f"{t}transformer.layers.{i}", f"{j}tx_{i}")
    m.norm(f"{t}gaussian_residual_pred.norm", f"{j}LayerNorm_0")
    m.dense(f"{t}gaussian_residual_pred.fn", f"{j}res_head")


def _point_vae(m: _Mapper, module: PointVAE):
    _dit2(m, "decoder.vit_decoder.", "backbone/",
          len(module.decoder["vit_decoder"].blocks))
    sr = "decoder.superresolution."
    m.mlp(sr + "post_quant_conv", "post_quant_mlp")
    m.dense(sr + "conv_sr.gaussian_pred.1", "base_head/Dense_0")
    for k in range(len(module.up_factors)):
        name = f"ada_CA_f4_{k + 1}"
        _upsampler(m, f"{sr}{name}.", f"upsamplers_{k}/",
                   module.decoder["superresolution"][name])
    if not module.release_parity:
        m.dense(sr + "anchor_pe.xyz_projection", "anchor_pe/Dense_0")
    if module.encoder is not None:
        m.mlp(sr + "quant_conv", "quant_mlp")
        _hybrid_encoder(m, "encoder.", "encoder/", module.encoder)


def _res_block(m: _Mapper, t: str, j: str, sd_names: bool):
    """JAX `SDResnetBlock` (named children) or `ResBlock` (numbered)."""
    n1, n2, c1, c2, sc = ("norm1", "norm2", "conv1", "conv2",
                          "nin_shortcut") if sd_names else (
        "GroupNorm32_0", "GroupNorm32_1", "Conv_0", "Conv_1", "Conv_2")
    m.norm(f"{t}norm1", f"{j}{n1}/GroupNorm_0")
    m.conv(f"{t}conv1", f"{j}{c1}")
    m.norm(f"{t}norm2", f"{j}{n2}/GroupNorm_0")
    m.conv(f"{t}conv2", f"{j}{c2}")
    if f"{j}{sc}/kernel" in m.flat:
        m.conv(f"{t}nin_shortcut", f"{j}{sc}")


def _sd_trunk(m: _Mapper, t: str, j: str, module: SDEncoderTrunk):
    m.conv(f"{t}conv_in", f"{j}conv_in")
    for i, level in enumerate(module.down):
        _res_block(m, f"{t}down.{i}.block.0.", f"{j}down_{i}_block_0/", True)
        if hasattr(level, "downsample"):
            m.conv(f"{t}down.{i}.downsample.conv",
                   f"{j}down_{i}_downsample/conv")
    _res_block(m, f"{t}mid.block_1.", f"{j}mid_block_1/", True)
    _res_block(m, f"{t}mid.block_2.", f"{j}mid_block_2/", True)
    ta, ja = f"{t}mid.attn_1.", f"{j}mid_attn_1/"
    m.norm(ta + "norm", ja + "norm/GroupNorm_0")
    m.dense(ta + "proj_in", ja + "proj_in")
    for n in "123":
        m.norm(ta + f"norm{n}", ja + f"norm{n}")
    m.packed_attention(ta + "attn1", ja + "attn1")
    m.packed_attention(ta + "attn2", ja + "attn2")
    m.dense(ta + "ff.net.0.proj", ja + "ff/proj")
    m.dense(ta + "ff.net.2", ja + "ff/out")
    m.dense(ta + "proj_out", ja + "proj_out")
    m.norm(f"{t}norm_out", f"{j}norm_out/GroupNorm_0")


def _mv_conv_encoder(m: _Mapper, t: str, j: str, module: MVConvEncoder):
    n = len(module.blocks)
    m.conv(f"{t}conv_in", f"{j}Conv_0")
    for i in range(n):
        _res_block(m, f"{t}blocks.{i}.", f"{j}ResBlock_{i}/", False)
    for i in range(len(module.downs)):
        m.conv(f"{t}downs.{i}", f"{j}Conv_{i + 1}")
    _res_block(m, f"{t}mid_block_1.", f"{j}ResBlock_{n}/", False)
    m.norm(f"{t}mid_norm", f"{j}LayerNorm_0")
    m.packed_attention(f"{t}mid_attn", f"{j}Attention_0")
    _res_block(m, f"{t}mid_block_2.", f"{j}ResBlock_{n + 1}/", False)
    m.norm(f"{t}norm_out", f"{j}GroupNorm32_0/GroupNorm_0")
    m.conv(f"{t}conv_out", f"{j}Conv_{len(module.downs) + 1}")


def _hybrid_encoder(m: _Mapper, t: str, j: str, module: HybridPCDEncoder):
    if module.release_parity:
        _sd_trunk(m, f"{t}sd_trunk.", f"{j}sd_trunk/", module.sd_trunk)
        m.dense(f"{t}xyz_pos_embed.xyz_projection",
                f"{j}xyz_pos_embed/Dense_0")
        m.cross_attention(f"{t}agg_ca", f"{j}agg_ca")
    else:
        _mv_conv_encoder(m, f"{t}conv.", f"{j}MVConvEncoder_0/", module.conv)
        m.dense(f"{t}token_proj", f"{j}Dense_0")
        m.dense(f"{t}token_embed.xyz_projection",
                f"{j}XYZPosEmbed_0/Dense_0")
        m.dense(f"{t}anchor_embed.xyz_projection",
                f"{j}anchor_embed/Dense_0")
        _cross_attention_block(m, f"{t}agg_ca.", f"{j}agg_ca/")
    for i in range(len(module.srt)):
        m.transformer_block(f"{t}srt.{i}", f"{j}srt_{i}")
    m.norm(f"{t}norm_out", f"{j}LayerNorm_0")
    m.mlp(f"{t}mlp_out", f"{j}mlp_out")


def _perceptual_net(m: _Mapper):
    for i in range(4):
        m.conv(f"conv{i}a", f"conv{i}a")
        m.conv(f"conv{i}b", f"conv{i}b")


def _patch_discriminator(m: _Mapper, module: PatchDiscriminator):
    for i in range(len(module.convs)):
        m.conv(f"convs.{i}", f"Conv_{i}")
    for i in range(len(module.norms)):
        m.norm(f"norms.{i}", f"GroupNorm_{i}")


def _vgg_lpips(m: _Mapper):
    for idx, _ in _VGG_CONVS:
        m.conv(f"net.features.{idx}", f"net/features.{idx}")
    for k in range(len(LPIPS_CHANNELS)):
        m.conv(f"lins.{k}", f"lins.{k}")


def _cross_attention_block(m: _Mapper, t: str = "", j: str = ""):
    m.norm(f"{t}norm_q", f"{j}LayerNorm_0")
    m.norm(f"{t}norm_kv", f"{j}LayerNorm_1")
    m.cross_attention(f"{t}attn", f"{j}Attention_0")
    m.norm(f"{t}norm_mlp", f"{j}LayerNorm_2")
    m.mlp(f"{t}mlp", f"{j}Mlp_0")


_MAPPINGS: Dict[type, Callable[[_Mapper, nn.Module], None]] = {
    ImageConditioner: _image_conditioner,
    VisionTransformer: lambda m, mod: _scratch_vit(m, "", "", mod),
    TextConditioner: _text_conditioner,
    TextTransformer: lambda m, mod: _text_transformer(m, "", "", mod),
    OpenClipTextTower: lambda m, mod: _openclip_text(m, "", "", mod),
    U2Net: _u2net,
    Dinov2ViT: lambda m, mod: _dinov2(m, "", "", len(mod.blocks)),
    PointDiT: _point_dit,
    DiT2: lambda m, mod: _dit2(m, "", "", len(mod.blocks)),
    GaussianUpsampler: lambda m, mod: _upsampler(m, "", "", mod),
    PointVAE: _point_vae,
    CrossAttentionBlock: lambda m, mod: _cross_attention_block(m),
    SDEncoderTrunk: lambda m, mod: _sd_trunk(m, "", "", mod),
    MVConvEncoder: lambda m, mod: _mv_conv_encoder(m, "", "", mod),
    HybridPCDEncoder: lambda m, mod: _hybrid_encoder(m, "", "", mod),
    PerceptualNet: lambda m, mod: _perceptual_net(m),
    PatchDiscriminator: _patch_discriminator,
    VGGLPIPS: lambda m, mod: _vgg_lpips(m),
}


def from_jax_params(params_np: Mapping, module: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """JAX parameter tree → `module.state_dict()`-shaped dict of tensors.

    Covers `ImageConditioner` (both backbones)/`Dinov2ViT`/
    `VisionTransformer`, `TextConditioner` (both backbones)/
    `TextTransformer`/`OpenClipTextTower`, `PointDiT` (the release i23d and
    t23d layouts and the non-release one), `U2Net`, `PointVAE` (both
    layouts; the encoder and quant-MLP entries of
    the tree are read when the module was built with its encoder),
    `HybridPCDEncoder`, `SDEncoderTrunk`, `MVConvEncoder`, `DiT2`,
    `GaussianUpsampler`, `CrossAttentionBlock`, the perceptual pyramid
    `PerceptualNet`, `PatchDiscriminator` (flax's `Conv_i`, `GroupNorm_i`)
    and `VGGLPIPS` (`net/features.N`, `lins.k`). Raises if a port
    parameter is left without a value or a shape disagrees.
    """
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    mapping = _MAPPINGS.get(type(module))
    if mapping is None:
        raise TypeError(f"no JAX mapping for {type(module).__name__}")
    m = _Mapper(_flatten(params_np))
    mapping(m, module)
    target = module.state_dict()
    missing = sorted(set(target) - set(m.out))
    extra = sorted(set(m.out) - set(target))
    if missing or extra:
        raise KeyError(f"{type(module).__name__}: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    sd = {}
    for k, ref in target.items():
        a = np.ascontiguousarray(m.out[k])
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: JAX shape {a.shape}, port shape "
                             f"{tuple(ref.shape)}")
        sd[k] = torch.from_numpy(a).to(ref.dtype)
    return sd


# ---------------------------------------------------------------------------
# The JAX layout of a port module: which JAX leaf, of which shape, each
# port parameter reads. `_Mapper` knows the names; run it on a flat tree
# that records every read, then undo each read's transform on the port
# parameter's shape.
# ---------------------------------------------------------------------------

class _Probe:
    """A JAX leaf as `_Mapper` reads it: its name and the transforms the
    mapping applied (`.T`, `.transpose(axes)`, `[0]`)."""

    def __init__(self, name: str, ops: tuple = ()):
        self.name, self.ops = name, ops

    @property
    def T(self):
        return _Probe(self.name, self.ops + (("T",),))

    def transpose(self, *axes):
        return _Probe(self.name, self.ops + (("transpose", axes),))

    def __getitem__(self, idx):
        if idx != 0:
            raise TypeError(f"a JAX leaf is read at [{idx}]")
        return _Probe(self.name, self.ops + (("index0",),))

    def __array_function__(self, func, types, args, kwargs):
        if func is not np.concatenate:
            return NotImplemented
        return _Concat(list(args[0]), kwargs.get("axis", 0))

    def jax_shapes(self, shape: tuple) -> Dict[str, tuple]:
        """{JAX name: shape} of the leaf whose read gives `shape`."""
        for op in reversed(self.ops):
            if op[0] == "T":
                shape = shape[::-1]
            elif op[0] == "transpose":
                axes = op[1]
                shape = tuple(shape[axes.index(j)] for j in range(len(axes)))
            else:
                shape = (1,) + tuple(shape)
        return {self.name: tuple(shape)}


class _Concat:
    """`np.concatenate` of equal-sized probes (the fused qkv)."""

    def __init__(self, parts, axis: int):
        self.parts, self.axis = parts, axis

    def jax_shapes(self, shape: tuple) -> Dict[str, tuple]:
        part = list(shape)
        part[self.axis] //= len(self.parts)
        out = {}
        for p in self.parts:
            out.update(p.jax_shapes(tuple(part)))
        return out


class _Reads(dict):
    """A flat JAX tree that holds every name: each read is a `_Probe`."""

    def __contains__(self, name):
        return True

    def __getitem__(self, name):
        return _Probe(name)


def jax_layout(module: nn.Module) -> Dict[str, tuple]:
    """{"a/b/c": shape} of the JAX parameter tree `from_jax_params(tree,
    module)` reads: the names and shapes of the JAX package's template for
    the same architecture, drawn from the port module alone (which may
    live on the "meta" device). Covers the modules `from_jax_params`
    covers."""
    mapping = _MAPPINGS.get(type(module))
    if mapping is None:
        raise TypeError(f"no JAX mapping for {type(module).__name__}")
    m = _Mapper(_Reads())
    mapping(m, module)
    target = module.state_dict()
    missing = sorted(set(target) - set(m.out))
    if missing:
        raise KeyError(f"{type(module).__name__}: no JAX leaf for "
                       f"{missing[:5]}")
    out: Dict[str, tuple] = {}
    # optional leaves the mapper probed for but the module does not have
    # (a bias, q/k norms, a shortcut) read into port names it lacks
    for k, ref in target.items():
        for name, shape in m.out[k].jax_shapes(tuple(ref.shape)).items():
            if out.setdefault(name, shape) != shape:
                raise ValueError(f"{name}: read as {out[name]} and {shape}")
    return out
