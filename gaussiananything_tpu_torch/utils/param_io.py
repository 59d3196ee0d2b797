"""Weights carried across from the JAX package's parameter trees.

`from_jax_params(params_np, module)` turns a flax parameter tree (nested
dicts of numpy arrays, bare or wrapped in `{"params": ...}`) into the
`state_dict` of the matching port module. It inverts the mappings of
`gaussiananything_tpu/utils/param_io.py` (`convert_dinov2`,
`convert_gaussiananything_dit`, `convert_gaussiananything_vae`): Dense
kernels (in, out) become Linear weights (out, in), conv kernels HWIO become
OIHW, and the separate q/k/v kernels of a packed attention are fused back
into one `qkv` weight.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from gaussiananything_tpu_torch.models.conditioner import ImageConditioner
from gaussiananything_tpu_torch.models.dinov2 import Dinov2ViT
from gaussiananything_tpu_torch.models.dit import PointDiT
from gaussiananything_tpu_torch.models.dit2_decoder import DiT2
from gaussiananything_tpu_torch.models.layers import CrossAttentionBlock
from gaussiananything_tpu_torch.models.upsampler import GaussianUpsampler
from gaussiananything_tpu_torch.models.vae import PointVAE

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
    m.norm("pooled_vec_embedder.0", "pooled_vec_ln")
    m.dense("pooled_vec_embedder.1", "vector_proj")
    m.dense("adaLN_modulation.1", "shared_adaln")
    if module.xyz_pos_embed is not None:
        m.dense("xyz_pos_embed.xyz_projection", "xyz_pe/Dense_0")
    for i in range(len(module.blocks)):
        t, j = f"blocks.{i}.", f"block_{i}/"
        m.copy(t + "scale_shift_table", j + "scale_shift_table")
        m.norm(t + "norm1", j + "norm1")
        m.norm(t + "norm2", j + "norm2")
        m.norm(t + "prenorm_ca_dino", j + "prenorm_ca")
        m.cross_attention(t + "cross_attn_dino", j + "cross_attn")
        m.packed_attention(t + "attn", j + "self_attn")
        m.mlp(t + "mlp", j + "Mlp_0")
    m.copy("final_layer.scale_shift_table", "final_scale_shift")
    m.dense("final_layer.linear", "final_proj")


def _dit2(m: _Mapper, t: str, j: str, depth: int):
    m.copy(f"{t}pos_embed", f"{j}query_pos_embed")
    for i in range(depth):
        tb, jb = f"{t}blocks.{i}.", f"{j}block_{i}/"
        m.packed_attention(tb + "attn", jb + "Attention_0")
        m.mlp(tb + "mlp", jb + "Mlp_0")
        m.dense(tb + "adaLN_modulation.1", jb + "adaLN")


def _upsampler(m: _Mapper, t: str, j: str, module: GaussianUpsampler):
    m.out[f"{t}latent_embedding"] = m.flat[f"{j}latent_embedding"][0]
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


def _cross_attention_block(m: _Mapper):
    m.norm("norm_q", "LayerNorm_0")
    m.norm("norm_kv", "LayerNorm_1")
    m.cross_attention("attn", "Attention_0")
    m.norm("norm_mlp", "LayerNorm_2")
    m.mlp("mlp", "Mlp_0")


_MAPPINGS: Dict[type, Callable[[_Mapper, nn.Module], None]] = {
    ImageConditioner: lambda m, mod: _dinov2(m, "vit.", "vit/",
                                             len(mod.vit.blocks)),
    Dinov2ViT: lambda m, mod: _dinov2(m, "", "", len(mod.blocks)),
    PointDiT: _point_dit,
    DiT2: lambda m, mod: _dit2(m, "", "", len(mod.blocks)),
    GaussianUpsampler: lambda m, mod: _upsampler(m, "", "", mod),
    PointVAE: _point_vae,
    CrossAttentionBlock: lambda m, mod: _cross_attention_block(m),
}


def from_jax_params(params_np: Mapping, module: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """JAX parameter tree → `module.state_dict()`-shaped dict of tensors.

    Covers `ImageConditioner`/`Dinov2ViT`, `PointDiT` (both release
    stages), `PointVAE` (the release decoder; encoder and quant-MLP entries
    of the tree are not read), `DiT2`, `GaussianUpsampler` and
    `CrossAttentionBlock`. Raises if a port parameter is left without a
    value or a shape disagrees.
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
