"""The reference's torch checkpoints → the JAX package's parameter layout
(the port's own copy of the converters of
`gaussiananything_tpu/utils/param_io.py:44-637`, numpy only).

Each converter takes a state dict (torch name → numpy array) and a
template, {"a/b/c": shape} of the JAX-layout leaves, and returns the flat
tree {"a/b/c": float32 array}: the leaves `cli/import_release.py` writes
to an npz, which the port's CLIs restore (`train.state.
restore_inference_params`) and the JAX package's `load_params_npz` reads.
The templates come from the port's own modules (`utils/param_io.
jax_layout`), not from a flax init.

One difference from the JAX converters: where a checkpoint leaves a
template leaf without a value, they keep the template's random initial
value; here that raises, since a flax init cannot be reproduced without
JAX (and a silently random weight is never what an import wants).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import numpy as np

Flat = Dict[str, np.ndarray]
Template = Dict[str, tuple]


def _fill(out: Flat, template: Template) -> Flat:
    """Validate converted leaves against the template (names, shapes) and
    return them as float32, every template leaf covered."""
    res = {}
    for k, v in out.items():
        if k not in template:
            raise KeyError(f"converted name {k} not in template")
        v = np.asarray(v)
        if tuple(v.shape) != tuple(template[k]):
            raise ValueError(f"{k}: shape {v.shape} vs {template[k]}")
        res[k] = v.astype(np.float32)
    missing = set(template) - set(res)
    if missing:
        raise ValueError(
            f"checkpoint did not cover {len(missing)} template params, "
            f"e.g. {sorted(missing)[:5]} — wrong config for this checkpoint?")
    return res


def import_torch_state_dict(state_dict: Flat,
                            name_map: Callable[[str], Optional[str]],
                            template: Template,
                            verbatim: Optional[set] = None) -> Flat:
    """`param_io.import_torch_state_dict`: each torch name mapped to a JAX
    path by `name_map` (None skips it); 2-D kernels are transposed where
    the shapes say so (torch Linear (out, in)), 4-D ones OIHW → HWIO;
    `verbatim` names are copied untransposed."""
    out: Flat = {}
    verbatim = verbatim or set()
    for tname, arr in state_dict.items():
        fname = name_map(tname)
        if fname is None:
            continue
        if fname not in template:
            raise KeyError(f"mapped name {fname} not in template")
        tgt = tuple(template[fname])
        a = np.asarray(arr)
        if fname in verbatim:
            pass
        elif a.ndim == 2 and a.shape == tgt[::-1]:
            a = a.T
        elif a.ndim == 4 and a.shape != tgt:
            a = a.transpose(2, 3, 1, 0)
        if tuple(a.shape) != tgt:
            raise ValueError(f"{tname}->{fname}: shape {a.shape} vs {tgt}")
        out[fname] = a
    return _fill(out, template)


def dinov2_name_map(torch_name: str) -> Optional[str]:
    """torch-hub `dinov2_vit*14_reg` names → `Dinov2ViT` paths
    (`param_io.dinov2_name_map`); mask_token is not carried."""
    if torch_name in ("cls_token", "pos_embed", "register_tokens"):
        return torch_name
    if torch_name == "mask_token":
        return None
    if torch_name == "patch_embed.proj.weight":
        return "patch_embed/kernel"
    if torch_name == "patch_embed.proj.bias":
        return "patch_embed/bias"
    if torch_name in ("norm.weight", "norm.bias"):
        return "norm/" + ("scale" if torch_name.endswith("weight") else "bias")
    if torch_name.startswith("blocks."):
        idx, tail = torch_name.split(".", 2)[1:]
        table = {
            "norm1.weight": "norm1/scale", "norm1.bias": "norm1/bias",
            "norm2.weight": "norm2/scale", "norm2.bias": "norm2/bias",
            "attn.qkv.weight": "attn/qkv/kernel",
            "attn.qkv.bias": "attn/qkv/bias",
            "attn.proj.weight": "attn/proj/kernel",
            "attn.proj.bias": "attn/proj/bias",
            "ls1.gamma": "ls1/gamma", "ls2.gamma": "ls2/gamma",
            "mlp.fc1.weight": "mlp.fc1/kernel", "mlp.fc1.bias": "mlp.fc1/bias",
            "mlp.fc2.weight": "mlp.fc2/kernel", "mlp.fc2.bias": "mlp.fc2/bias",
        }
        if tail in table:
            return f"blocks.{idx}/" + table[tail]
    raise KeyError(f"unrecognised dinov2 param {torch_name}")


def openclip_text_name_map(torch_name: str) -> Optional[str]:
    """open_clip text-tower names (bare or with the full-CLIP prefix; the
    visual tower skipped) → `OpenClipTextTower` paths."""
    n = torch_name
    if n.startswith("visual.") or n in ("logit_scale", "logit_bias"):
        return None
    if n.startswith("text."):
        n = n[len("text."):]
    if n == "token_embedding.weight":
        return "token_embedding/embedding"
    if n in ("positional_embedding", "text_projection"):
        return n
    if n in ("ln_final.weight", "ln_final.bias"):
        return "ln_final/" + ("scale" if n.endswith("weight") else "bias")
    if n.startswith("transformer.resblocks."):
        idx, tail = n[len("transformer.resblocks."):].split(".", 1)
        table = {
            "ln_1.weight": "ln_1/scale", "ln_1.bias": "ln_1/bias",
            "ln_2.weight": "ln_2/scale", "ln_2.bias": "ln_2/bias",
            "attn.in_proj_weight": "attn.in_proj/kernel",
            "attn.in_proj_bias": "attn.in_proj/bias",
            "attn.out_proj.weight": "attn.out_proj/kernel",
            "attn.out_proj.bias": "attn.out_proj/bias",
            "mlp.c_fc.weight": "mlp.c_fc/kernel",
            "mlp.c_fc.bias": "mlp.c_fc/bias",
            "mlp.c_proj.weight": "mlp.c_proj/kernel",
            "mlp.c_proj.bias": "mlp.c_proj/bias",
        }
        if tail in table:
            return f"resblocks.{idx}/" + table[tail]
    raise KeyError(f"unrecognised open_clip text param {torch_name}")


def lpips_vgg_name_map(torch_name: str) -> Optional[str]:
    """pip `lpips` LPIPS(net='vgg') or bare torchvision VGG names →
    `VGGLPIPS` paths (the slice number is ignored: the children keep
    torchvision's conv index); the scaling layer is constant."""
    n = torch_name
    if n.startswith("scaling_layer."):
        return None
    m = re.fullmatch(r"(?:net\.slice\d+|features)\.(\d+)\.(weight|bias)", n)
    if m:
        return f"net/features.{m.group(1)}/" + (
            "kernel" if m.group(2) == "weight" else "bias")
    m = re.fullmatch(r"lin(\d)\.model\.1\.weight", n)
    if m:
        return f"lins.{m.group(1)}/kernel"
    raise KeyError(f"unrecognised lpips param {torch_name}")


def u2net_name_map(torch_name: str) -> Optional[str]:
    """xuebinqin/U-2-Net `u2net.pth` / `u2netp.pth` names → `U2Net`
    paths; the BatchNorm statistics become `bn_*` leaves."""
    n = torch_name
    if n.endswith(".num_batches_tracked"):
        return None
    parts = n.split(".")
    if parts[0] == "outconv" or parts[0].startswith("side"):
        return f"{parts[0]}/" + {"weight": "kernel", "bias": "bias"}[parts[1]]
    if parts[0].startswith("stage") and len(parts) == 4:
        stage, block, layer, kind = parts
        if layer == "conv_s1":
            return f"{stage}/{block}/conv_s1/" + (
                "kernel" if kind == "weight" else "bias")
        if layer == "bn_s1":
            table = {"weight": "bn_scale", "bias": "bn_bias",
                     "running_mean": "bn_mean", "running_var": "bn_var"}
            return f"{stage}/{block}/{table[kind]}"
    raise KeyError(f"unrecognised u2net param {torch_name}")


def convert_dinov2(state_dict: Flat, template: Template) -> Flat:
    return import_torch_state_dict(state_dict, dinov2_name_map, template)


def convert_openclip_text(state_dict: Flat, template: Template) -> Flat:
    # CLIP applies `text_projection` as x @ W: square, never transposed
    return import_torch_state_dict(state_dict, openclip_text_name_map,
                                   template, verbatim={"text_projection"})


def convert_lpips_vgg(state_dict: Flat, template: Template) -> Flat:
    return import_torch_state_dict(state_dict, lpips_vgg_name_map, template)


def convert_u2net(state_dict: Flat, template: Template) -> Flat:
    return import_torch_state_dict(state_dict, u2net_name_map, template)


def _norm_fused_mlp(sd: Flat, prefix: str) -> Flat:
    """One MLP's keys under `prefix.` as timm's fc1/fc2: the timm layout
    as it is, or xformers' FusedMLP (its Linears' biases on themselves or
    on the following FusedDropoutBias, matched by shape, nearest first)."""
    keys = [k for k in sd if k.startswith(prefix + ".")]
    if any(k.endswith("fc1.weight") for k in keys):
        return {k: sd[k] for k in keys}
    ws = sorted((k for k in keys if sd[k].ndim == 2),
                key=lambda k: int(k.rsplit(".", 2)[-2]))
    bs = [k for k in keys if sd[k].ndim == 1]
    if len(ws) != 2:
        raise ValueError(f"{prefix}: expected 2 Linear weights, got {ws}")
    out = {}
    for fc, wk in zip(("fc1", "fc2"), ws):
        w = sd[wk]
        out[f"{prefix}.{fc}.weight"] = w
        cand = [bk for bk in bs if sd[bk].shape == (w.shape[0],)]
        widx = int(wk.rsplit(".", 2)[-2])
        cand.sort(key=lambda bk: abs(int(bk.rsplit(".", 2)[-2]) - widx))
        if cand:
            out[f"{prefix}.{fc}.bias"] = sd[cand[0]]
            bs.remove(cand[0])
    return out


def _split_qkv(w, b):
    """A packed qkv Linear (3D, D) (+ (3D,)) → three (D, D) kernels
    (+ three biases)."""
    q, k, v = np.split(np.asarray(w), 3, axis=0)
    if b is None:
        return (q.T, k.T, v.T), None
    return (q.T, k.T, v.T), tuple(np.split(np.asarray(b), 3, axis=0))


def _attention_entries(sd, t: str, a: str, qkv: str, proj: str) -> Flat:
    """A packed attention (`{t}.{qkv}`, q/k norms, `{t}.{proj}`) → the JAX
    `Attention` at `a`."""
    out = {}
    (qw, kw, vw), qkvb = _split_qkv(sd[f"{t}.{qkv}.weight"],
                                    sd.get(f"{t}.{qkv}.bias"))
    out[f"{a}/to_q/kernel"], out[f"{a}/to_k/kernel"], \
        out[f"{a}/to_v/kernel"] = qw, kw, vw
    if qkvb is not None:
        out[f"{a}/to_q/bias"], out[f"{a}/to_k/bias"], \
            out[f"{a}/to_v/bias"] = qkvb
    out[f"{a}/q_norm/scale"] = sd[f"{t}.q_norm.weight"]
    out[f"{a}/k_norm/scale"] = sd[f"{t}.k_norm.weight"]
    out[f"{a}/to_out/kernel"] = np.asarray(sd[f"{t}.{proj}.weight"]).T
    out[f"{a}/to_out/bias"] = sd[f"{t}.{proj}.bias"]
    return out


def _mlp_entries(sd, t: str, f: str) -> Flat:
    """An MLP (timm or FusedMLP layout) under `t` → the JAX `Mlp` at `f`."""
    mlp = _norm_fused_mlp(sd, t)
    return {f"{f}/Dense_0/kernel": np.asarray(mlp[f"{t}.fc1.weight"]).T,
            f"{f}/Dense_0/bias": mlp[f"{t}.fc1.bias"],
            f"{f}/Dense_1/kernel": np.asarray(mlp[f"{t}.fc2.weight"]).T,
            f"{f}/Dense_1/bias": mlp[f"{t}.fc2.bias"]}


def _srt_tx_entries(sd, tprefix: str, fprefix: str, n_layers: int) -> Flat:
    """`nsr/srt/layers.py:146` Transformer (PreNorm attention + PreNorm
    FusedMLP) under `tprefix.layers.{i}` → the JAX `TransformerBlock`s
    `fprefix.format(i=i)`."""
    out = {}
    for i in range(n_layers):
        t, f = f"{tprefix}.layers.{i}", fprefix.format(i=i)
        out[f"{f}/LayerNorm_0/scale"] = sd[f"{t}.0.norm.weight"]
        out[f"{f}/LayerNorm_0/bias"] = sd[f"{t}.0.norm.bias"]
        out.update(_attention_entries(sd, f"{t}.0.fn", f"{f}/Attention_0",
                                      "qkv", "proj"))
        out[f"{f}/LayerNorm_1/scale"] = sd[f"{t}.1.norm.weight"]
        out[f"{f}/LayerNorm_1/bias"] = sd[f"{t}.1.norm.bias"]
        out.update(_mlp_entries(sd, f"{t}.1.fn", f"{f}/Mlp_0"))
    return out


def _timm_mlp_entries(sd, tprefix: str, fprefix: str) -> Flat:
    return {f"{fprefix}/Dense_0/kernel": np.asarray(
                sd[f"{tprefix}.fc1.weight"]).T,
            f"{fprefix}/Dense_0/bias": sd[f"{tprefix}.fc1.bias"],
            f"{fprefix}/Dense_1/kernel": np.asarray(
                sd[f"{tprefix}.fc2.weight"]).T,
            f"{fprefix}/Dense_1/bias": sd[f"{tprefix}.fc2.bias"]}


def _hwio(w):
    return np.asarray(w).transpose(2, 3, 1, 0)


def _resnet_block_entries(sd, tprefix: str, fprefix: str) -> Flat:
    out = {}
    for name in ("norm1", "norm2"):
        out[f"{fprefix}/{name}/GroupNorm_0/scale"] = \
            sd[f"{tprefix}.{name}.weight"]
        out[f"{fprefix}/{name}/GroupNorm_0/bias"] = \
            sd[f"{tprefix}.{name}.bias"]
    for name in ("conv1", "conv2", "nin_shortcut"):
        wk = f"{tprefix}.{name}.weight"
        if wk in sd:
            out[f"{fprefix}/{name}/kernel"] = _hwio(sd[wk])
            out[f"{fprefix}/{name}/bias"] = sd[f"{tprefix}.{name}.bias"]
    return out


def _meca_entries(sd, tprefix: str, fprefix: str, qk_norm: bool) -> Flat:
    """ldm `MemoryEfficientCrossAttention` → the JAX `Attention`."""
    out = {f"{fprefix}/{n}/kernel": np.asarray(sd[f"{tprefix}.{n}.weight"]).T
           for n in ("to_q", "to_k", "to_v")}
    out[f"{fprefix}/to_out/kernel"] = np.asarray(
        sd[f"{tprefix}.to_out.0.weight"]).T
    out[f"{fprefix}/to_out/bias"] = sd[f"{tprefix}.to_out.0.bias"]
    if qk_norm:
        out[f"{fprefix}/q_norm/scale"] = sd[f"{tprefix}.q_norm.weight"]
        out[f"{fprefix}/k_norm/scale"] = sd[f"{tprefix}.k_norm.weight"]
    return out


def _count(sd, prefix: str, field: int) -> int:
    return 1 + max(int(k.split(".")[field]) for k in sd
                   if k.startswith(prefix))


def convert_gaussiananything_vae(state_dict: Flat,
                                 template: Template) -> Flat:
    """The released VAE (`ckpts/vae/model_rec1965000.pt`: `encoder.*` =
    HybridEncoderPCDStructuredLatentSNoPCD, `decoder.*` = the cascaded
    structured-latent decoder) → the release-layout `PointVAE` leaves
    (`param_io.convert_gaussiananything_vae`); depths and widths come from
    the checkpoint, checked against the template."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    out: Flat = {}
    tr = "encoder/sd_trunk"
    out[f"{tr}/conv_in/kernel"] = _hwio(sd["encoder.conv_in.weight"])
    out[f"{tr}/conv_in/bias"] = sd["encoder.conv_in.bias"]
    for i in range(_count(sd, "encoder.down.", 2)):
        out.update(_resnet_block_entries(sd, f"encoder.down.{i}.block.0",
                                         f"{tr}/down_{i}_block_0"))
        dk = f"encoder.down.{i}.downsample.conv.weight"
        if dk in sd:
            out[f"{tr}/down_{i}_downsample/conv/kernel"] = _hwio(sd[dk])
            out[f"{tr}/down_{i}_downsample/conv/bias"] = \
                sd[f"encoder.down.{i}.downsample.conv.bias"]
    for blk in ("block_1", "block_2"):
        out.update(_resnet_block_entries(sd, f"encoder.mid.{blk}",
                                         f"{tr}/mid_{blk}"))
    ma, fa = "encoder.mid.attn_1", f"{tr}/mid_attn_1"
    out[f"{fa}/norm/GroupNorm_0/scale"] = sd[f"{ma}.norm.weight"]
    out[f"{fa}/norm/GroupNorm_0/bias"] = sd[f"{ma}.norm.bias"]
    for pj in ("proj_in", "proj_out"):
        out[f"{fa}/{pj}/kernel"] = sd[f"{ma}.{pj}.weight"][:, :, 0, 0].T
        out[f"{fa}/{pj}/bias"] = sd[f"{ma}.{pj}.bias"]
    tb = f"{ma}.transformer_blocks.0"
    for n in ("norm1", "norm2", "norm3"):
        out[f"{fa}/{n}/scale"] = sd[f"{tb}.{n}.weight"]
        out[f"{fa}/{n}/bias"] = sd[f"{tb}.{n}.bias"]
    out.update(_meca_entries(sd, f"{tb}.attn1", f"{fa}/attn1", qk_norm=False))
    out.update(_meca_entries(sd, f"{tb}.attn2", f"{fa}/attn2", qk_norm=False))
    out[f"{fa}/ff/proj/kernel"] = sd[f"{tb}.ff.net.0.proj.weight"].T
    out[f"{fa}/ff/proj/bias"] = sd[f"{tb}.ff.net.0.proj.bias"]
    out[f"{fa}/ff/out/kernel"] = sd[f"{tb}.ff.net.2.weight"].T
    out[f"{fa}/ff/out/bias"] = sd[f"{tb}.ff.net.2.bias"]
    out[f"{tr}/norm_out/GroupNorm_0/scale"] = sd["encoder.norm_out.weight"]
    out[f"{tr}/norm_out/GroupNorm_0/bias"] = sd["encoder.norm_out.bias"]

    out.update(_srt_tx_entries(
        sd, "encoder.srt.transformer", "encoder/srt_{i}",
        _count(sd, "encoder.srt.transformer.layers.", 4)))
    out.update(_meca_entries(sd, "encoder.agg_ca", "encoder/agg_ca",
                             qk_norm=True))
    out["encoder/xyz_pos_embed/Dense_0/kernel"] = \
        sd["encoder.xyz_pos_embed.xyz_projection.weight"].T
    out["encoder/xyz_pos_embed/Dense_0/bias"] = \
        sd["encoder.xyz_pos_embed.xyz_projection.bias"]
    out["encoder/LayerNorm_0/scale"] = sd["encoder.Mlp_out.norm.weight"]
    out["encoder/LayerNorm_0/bias"] = sd["encoder.Mlp_out.norm.bias"]
    out.update(_timm_mlp_entries(sd, "encoder.Mlp_out.fn", "encoder/mlp_out"))

    out["backbone/query_pos_embed"] = sd["decoder.vit_decoder.pos_embed"]
    for i in range(_count(sd, "decoder.vit_decoder.blocks.", 3)):
        t, f = f"decoder.vit_decoder.blocks.{i}", f"backbone/block_{i}"
        out.update(_attention_entries(sd, f"{t}.attn", f"{f}/Attention_0",
                                      "qkv", "proj"))
        out.update(_mlp_entries(sd, f"{t}.mlp", f"{f}/Mlp_0"))
        out[f"{f}/adaLN/kernel"] = sd[f"{t}.adaLN_modulation.1.weight"].T
        out[f"{f}/adaLN/bias"] = sd[f"{t}.adaLN_modulation.1.bias"]

    sr = "decoder.superresolution"
    out.update(_timm_mlp_entries(sd, f"{sr}.quant_conv", "quant_mlp"))
    out.update(_timm_mlp_entries(sd, f"{sr}.post_quant_conv",
                                 "post_quant_mlp"))
    out["base_head/Dense_0/kernel"] = \
        sd[f"{sr}.conv_sr.gaussian_pred.1.weight"].T
    out["base_head/Dense_0/bias"] = sd[f"{sr}.conv_sr.gaussian_pred.1.bias"]
    for k, tname in enumerate(("ada_CA_f4_1", "ada_CA_f4_2", "ada_CA_f4_3")):
        t, f = f"{sr}.{tname}", f"upsamplers_{k}"
        if f"{t}.latent_embedding" not in sd:
            break
        out[f"{f}/latent_embedding"] = np.asarray(
            sd[f"{t}.latent_embedding"])[None]
        lp = f"{t}.transformer.layers."
        depth = 1 + max(int(key[len(lp):].split(".")[0]) for key in sd
                        if key.startswith(lp))
        out.update(_srt_tx_entries(sd, f"{t}.transformer", f + "/tx_{i}",
                                   depth))
        out[f"{f}/LayerNorm_0/scale"] = \
            sd[f"{t}.gaussian_residual_pred.norm.weight"]
        out[f"{f}/LayerNorm_0/bias"] = \
            sd[f"{t}.gaussian_residual_pred.norm.bias"]
        out[f"{f}/res_head/kernel"] = \
            sd[f"{t}.gaussian_residual_pred.fn.weight"].T
        out[f"{f}/res_head/bias"] = sd[f"{t}.gaussian_residual_pred.fn.bias"]
    return _fill(out, template)


def convert_gaussiananything_dit(state_dict: Flat,
                                 template: Template) -> Flat:
    """The released flow-matching DiTs (`checkpoints/i23d/stage-1|stage-2`,
    `DiT_I23D_PCD_PixelArt_noclip[_clay_stage2]`, and the t23d text
    layout, `dit/dit_trilatent.py:262`) → the release-layout `PointDiT`
    leaves (`param_io.convert_gaussiananything_dit`). Parameters the
    reference never uses at run time are ignored."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    out: Flat = {}
    text_variant = "blocks.0.prenorm_ca_text.weight" in sd
    vec = "cap_embedder" if text_variant else "pooled_vec_embedder"

    out.update(_timm_mlp_entries(sd, "x_embedder", "x_embedder"))
    for i, j in ((0, 0), (2, 1)):
        out[f"t_embedder/Dense_{j}/kernel"] = np.asarray(
            sd[f"t_embedder.mlp.{i}.weight"]).T
        out[f"t_embedder/Dense_{j}/bias"] = sd[f"t_embedder.mlp.{i}.bias"]
    out["pooled_vec_ln/scale"] = sd[f"{vec}.0.weight"]
    out["pooled_vec_ln/bias"] = sd[f"{vec}.0.bias"]
    out["vector_proj/kernel"] = np.asarray(sd[f"{vec}.1.weight"]).T
    out["vector_proj/bias"] = sd[f"{vec}.1.bias"]
    out["shared_adaln/kernel"] = np.asarray(
        sd["adaLN_modulation.1.weight"]).T
    out["shared_adaln/bias"] = sd["adaLN_modulation.1.bias"]
    if "xyz_pos_embed.xyz_projection.weight" in sd:      # stage 2
        out["xyz_pe/Dense_0/kernel"] = np.asarray(
            sd["xyz_pos_embed.xyz_projection.weight"]).T
        out["xyz_pe/Dense_0/bias"] = sd["xyz_pos_embed.xyz_projection.bias"]

    for i in range(_count(sd, "blocks.", 1)):
        t, f = f"blocks.{i}", f"block_{i}"
        out[f"{f}/scale_shift_table"] = sd[f"{t}.scale_shift_table"]
        out[f"{f}/norm1/scale"] = sd[f"{t}.norm1.weight"]
        out[f"{f}/norm2/scale"] = sd[f"{t}.norm2.weight"]
        if text_variant:
            out[f"{f}/prenorm_ca/scale"] = sd[f"{t}.prenorm_ca_text.weight"]
            out[f"{f}/attention_y_norm/scale"] = \
                sd[f"{t}.attention_y_norm.weight"]
            out.update(_meca_entries(sd, f"{t}.cross_attn",
                                     f"{f}/cross_attn", qk_norm=True))
        else:
            out[f"{f}/prenorm_ca/scale"] = sd[f"{t}.prenorm_ca_dino.weight"]
            out.update(_meca_entries(sd, f"{t}.cross_attn_dino",
                                     f"{f}/cross_attn", qk_norm=True))
        out.update(_attention_entries(sd, f"{t}.attn", f"{f}/self_attn",
                                      "qkv", "proj"))
        out.update(_mlp_entries(sd, f"{t}.mlp", f"{f}/Mlp_0"))

    out["final_scale_shift"] = sd["final_layer.scale_shift_table"]
    out["final_proj/kernel"] = np.asarray(sd["final_layer.linear.weight"]).T
    out["final_proj/bias"] = sd["final_layer.linear.bias"]
    return _fill(out, template)
