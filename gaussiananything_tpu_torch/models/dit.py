"""The flow-matching point DiTs (port of
`gaussiananything_tpu/models/dit.PointDiT`).

Release layouts (`release_parity=True`, the official checkpoints):

  * i23d stage 1, `DiT-PixArt-PCD-CLAY-L` = `DiT_I23D_PCD_PixelArt_noclip`
    (`dit/dit_i23d.py:437,1516-1524`): denoises 768×3 point tokens;
  * i23d stage 2, `…_clay_stage2` (`dit/dit_i23d.py:664`): denoises 768×10
    KL tokens with the stage-1 xyz added through `xyz_pos_embed`;
  * t23d stages 1 and 2, `DiT-PCD-L[-stage2-xyz2feat]`
    (`dit/dit_trilatent.py:262,335`): the same trunk with the text blocks
    (`variant="text"`) over 768-wide CLIP tokens.

Raw t ∈ [0, 1] feeds the timestep embedder; t-embedding + LN/Linear pooled
vector drive one shared adaLN; the T2I final layer adds a (2, D) table to
the combined embedding. A CLAY block cross-attends the raw DINOv2 tokens
(bias-less, qk-normed, head dim D/heads), then runs adaLN-gated qk-norm
self-attention and an exact-GELU MLP; a text block runs the self-attention
first and cross-attends RMS-normalised context tokens with head dim 64.
Parameter names are the reference's state-dict names.

Without `release_parity` (the JAX package's own trained presets,
`stage1_dit`/`stage2_dit`): t·1000 feeds the embedder, the pooled vector a
plain Linear (`vector_proj`), the tokens are projected to the width
(`cond_proj`), the cross-attention has biases and no qk-norm, the MLPs use
the tanh GELU, and the final layer takes its shift/scale from a Linear on
SiLU(t-embedding) with an RMSNorm.

`dtype` is the compute dtype (`models/layers.py`): the parameters are
fp32, the products run in it, the norms, softmaxes and the adaLN sums with
the fp32 `scale_shift_table`s in fp32; the velocity is fp32.

`remat` recomputes each block's activations in the backward instead of
holding them (the JAX package's `nn.remat` per block, which its
flow-matching trainer always asks for): `torch.utils.checkpoint` per
`ClayDiTBlock` whenever gradients are on. The function and its gradients
are the same with and without it.

A no-grad forward on a CUDA device replays a CUDA graph of the same
kernels once its key has come twice (`_ForwardGraphs`): a DiT-L forward
is ~2,150 small launches, and eagerly the card waits on the host for a
third of it. The module call stays, so its hooks fire on every call.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from gaussiananything_tpu_torch.models.layers import (Attention,
                                                      CrossAttention,
                                                      LayerNorm, Linear, Mlp,
                                                      RMSNorm,
                                                      TimestepEmbedder,
                                                      XYZPosEmbed,
                                                      approx_gelu, exact_gelu,
                                                      modulate)
from gaussiananything_tpu_torch.utils import profiling


class ClayDiTBlock(nn.Module):
    """`ImageCondDiTBlockPixelArtRMSNormClayLRM`
    (`dit/dit_models_xformers.py:717-787`): CA → SA → FFN; or, with
    `variant="text"`, `PixelArtTextCondDiTBlock` (`:329-376`): SA → CA →
    FFN with the context RMS-normalised first (`attention_y_norm`)."""

    def __init__(self, dim: int, heads: int, ctx_dim: int,
                 mlp_ratio: float = 4.0, release_parity: bool = True,
                 variant: str = "clay", dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in ("clay", "text"):
            raise ValueError(f"unknown block variant {variant!r}")
        self.variant = variant
        self.norm1 = RMSNorm(dim)
        self.norm2 = RMSNorm(dim)
        self.attn = Attention(dim, heads, qk_norm=True, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim,
                       act=exact_gelu if release_parity else approx_gelu,
                       dtype=dtype)
        self.scale_shift_table = nn.Parameter(
            torch.randn(6, dim) * (0.02 / dim ** 0.5))
        if release_parity:
            # CLAY: head dim D/heads (`:746`); text: MECA's default 64
            # (`:346-347`); equal at every release width
            ca = CrossAttention(dim, ctx_dim, heads,
                                dim_head=dim // heads if variant == "clay"
                                else 64, qk_norm=True, dtype=dtype)
        else:
            ca = CrossAttention(dim, ctx_dim, heads, qkv_bias=True,
                                dtype=dtype)
        if variant == "clay":
            self.cross_attn_dino = ca
            self.prenorm_ca_dino = RMSNorm(dim)
        else:
            self.cross_attn = ca
            self.prenorm_ca_text = RMSNorm(dim)
            self.attention_y_norm = RMSNorm(ctx_dim) if release_parity \
                else None

    def _cross(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        if self.variant == "clay":
            return self.cross_attn_dino(self.prenorm_ca_dino(x), ctx)
        if self.attention_y_norm is not None:
            ctx = self.attention_y_norm(ctx)
        return self.cross_attn(self.prenorm_ca_text(x), ctx)

    def forward(self, x: torch.Tensor, cond_tokens: torch.Tensor,
                ada: torch.Tensor) -> torch.Tensor:
        """x (B,N,D); cond_tokens (B,L,C); ada (B,6,D) shared adaLN."""
        mod = ada + self.scale_shift_table[None]
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = (mod[:, i, None] for i in range(6))
        if self.variant == "clay":
            x = x + self._cross(x, cond_tokens)
        x = x + g_a * self.attn(modulate(self.norm1(x), sh_a, sc_a))
        if self.variant == "text":
            x = x + self._cross(x, cond_tokens)
        return x + g_m * self.mlp(modulate(self.norm2(x), sh_m, sc_m))


class FinalLayer(nn.Module):
    """`T2IFinalLayer` (`dit/dit_models_xformers.py:62-85`); without
    `release_parity` the shift/scale come from `adaLN_modulation` on the
    t-embedding and the norm is an RMSNorm."""

    def __init__(self, dim: int, out_ch: int, release_parity: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if release_parity:
            self.norm_final = LayerNorm(dim, elementwise_affine=False,
                                        eps=1e-6)
            self.adaLN_modulation = None
        else:
            self.norm_final = RMSNorm(dim)
            self.adaLN_modulation = nn.Sequential(
                nn.SiLU(), Linear(dim, 2 * dim, dtype=dtype))
        self.linear = Linear(dim, out_ch, dtype=dtype)
        self.scale_shift_table = nn.Parameter(
            torch.randn(2, dim) * (0.02 / dim ** 0.5))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if self.adaLN_modulation is None:
            t2 = self.scale_shift_table[None] + c[:, None, :]
        else:
            t2 = self.adaLN_modulation(c).reshape(c.shape[0], 2, -1) \
                + self.scale_shift_table[None]
        shift, scale = t2[:, 0, None], t2[:, 1, None]
        return self.linear(modulate(self.norm_final(x), shift, scale))


class _ForwardGraphs:
    """CUDA graphs of one module's no-grad forward, by key.

    A graph holds the addresses of the tensors it was captured on and the
    kernels chosen then, so the key is everything that fixes them: the
    inputs' shapes and dtypes, the device and current stream, the fp32
    matmul policy (`utils/precision.py`; cuBLAS picks TF32 or IEEE at
    capture), inference mode, and the address of every parameter and
    buffer (`functional_call` swaps them, a cast reallocates them; an
    in-place update keeps them and a replay reads the new values).

    The first call with a key runs eagerly (it creates cuBLAS handles and
    workspaces), the second captures on a side stream and replays, every
    later one copies its inputs into the graph's own and replays; each
    replay returns a clone of the graph's output. At most `LIMIT` keys
    are kept, the least recently used evicted, so a key that never comes
    back costs no capture. Each graph has its own memory pool: graphs
    share nothing, so two streams may replay two of them at once."""
    LIMIT = 4

    def __init__(self):
        self.lock = threading.Lock()
        self.tensors = None       # (dict, name) of each parameter and
        #                           buffer, read at the first call
        self.entries = collections.OrderedDict()   # key -> None (seen once)
        #                                            or (graph, ins, out)

    def __reduce__(self):
        # copies and pickles of the module start with no graph
        return type(self), ()

    def key(self, module: nn.Module, args) -> tuple:
        if self.tensors is None:
            self.tensors = [(d, name) for m in module.modules()
                            for d in (m._parameters, m._buffers)
                            for name, v in d.items() if v is not None]
        dev = args[0].device
        return (dev, torch.cuda.current_stream(dev).stream_id
                if dev.type == "cuda" else None,
                torch.backends.cuda.matmul.fp32_precision,
                torch.is_inference_mode_enabled(),
                tuple(None if a is None else (a.shape, a.dtype)
                      for a in args),
                tuple([d[name].data_ptr() for d, name in self.tensors]))

    def __call__(self, module: nn.Module, body, args) -> torch.Tensor:
        with self.lock:
            key = self.key(module, args)
            if key not in self.entries:
                out = body(*args)
                self.entries[key] = None
                if len(self.entries) > self.LIMIT:
                    self.entries.popitem(last=False)
                return out
            self.entries.move_to_end(key)
            entry = self.entries[key]
            if entry is None:
                with profiling.span("ga.dit.capture"):
                    ins = tuple(None if a is None else a.clone()
                                for a in args)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph,
                                          capture_error_mode="thread_local"):
                        out = body(*ins)
                self.entries[key] = (graph, ins, out)
            else:
                graph, ins, out = entry
                for dst, src in zip(ins, args):
                    if dst is not None:
                        dst.copy_(src)
            with profiling.span("ga.dit.replay"):
                graph.replay()
                return out.clone()


class PointDiT(nn.Module):
    def __init__(self, in_channels: int = 3, width: int = 1024,
                 depth: int = 24, heads: int = 16, cond_dim: int = 1024,
                 vector_dim: int = 1024, use_xyz_pe: bool = False,
                 release_parity: bool = True, variant: str = "clay",
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.remat = remat
        self.width = width
        self.release_parity = release_parity
        self.dtype = dtype
        self.x_embedder = Mlp(in_channels, width, width, dtype=dtype)
        self.t_embedder = TimestepEmbedder(width, dtype=dtype)
        if release_parity:
            # the t23d checkpoints name it `cap_embedder`
            self.vec_name = ("cap_embedder" if variant == "text"
                             else "pooled_vec_embedder")
            self.add_module(self.vec_name, nn.Sequential(
                LayerNorm(vector_dim, eps=1e-5),
                Linear(vector_dim, width, dtype=dtype)))
            self.cond_proj = None
        else:
            self.vec_name = "vector_proj"
            self.vector_proj = Linear(vector_dim, width, dtype=dtype)
            self.cond_proj = Linear(cond_dim, width, dtype=dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(width, 6 * width, dtype=dtype))
        ctx_dim = cond_dim if release_parity else width
        self.blocks = nn.ModuleList([
            ClayDiTBlock(width, heads, ctx_dim,
                         release_parity=release_parity, variant=variant,
                         dtype=dtype)
            for _ in range(depth)])
        self.final_layer = FinalLayer(width, in_channels, release_parity,
                                      dtype=dtype)
        self.xyz_pos_embed = XYZPosEmbed(width, dtype=dtype) \
            if use_xyz_pe else None
        self._graphs = _ForwardGraphs()

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond_tokens: torch.Tensor, cond_vector: torch.Tensor,
                xyz: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B,N,in_channels); t (B,) in [0,1]; cond_tokens (B,L,cond_dim);
        cond_vector (B,vector_dim); xyz (B,N,3) for stage 2 → velocity
        (B,N,in_channels), fp32."""
        args = (x, t, cond_tokens, cond_vector, xyz)
        if (x.is_cuda and not torch.is_grad_enabled()
                and not torch.is_autocast_enabled("cuda")
                and not torch.cuda.is_current_stream_capturing()):
            return self._graphs(self, self._forward_body, args)
        return self._forward_body(*args)

    def _forward_body(self, x: torch.Tensor, t: torch.Tensor,
                      cond_tokens: torch.Tensor, cond_vector: torch.Tensor,
                      xyz: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.x_embedder(x.float())
        if self.xyz_pos_embed is not None:
            if xyz is None:
                raise ValueError("the stage-2 DiT needs the stage-1 xyz")
            h = h + self.xyz_pos_embed(xyz)
        t_emb = self.t_embedder(t if self.release_parity else t * 1000.0)
        c = t_emb + getattr(self, self.vec_name)(cond_vector)
        ada = self.adaLN_modulation(c).reshape(c.shape[0], 6, self.width)
        if self.cond_proj is None:
            ctx = cond_tokens.to(self.dtype)
        else:
            ctx = self.cond_proj(cond_tokens)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            h = (checkpoint(blk, h, ctx, ada, use_reentrant=False) if remat
                 else blk(h, ctx, ada))
        return self.final_layer(
            h, c if self.release_parity else t_emb).float()


_SIZES = {"L": dict(depth=24, width=1024, heads=16),
          "B": dict(depth=12, width=768, heads=12),
          "S": dict(depth=6, width=384, heads=6)}


def stage1_dit(size: str = "L", **kw) -> PointDiT:
    """The JAX package's own stage-1 geometry DiT (non-release layout)."""
    cfg = dict(_SIZES[size])
    cfg.update(kw)
    return PointDiT(in_channels=3, use_xyz_pe=False, release_parity=False,
                    **cfg)


def stage2_dit(size: str = "L", z_channels: int = 10, **kw) -> PointDiT:
    """The JAX package's own stage-2 texture DiT (non-release layout)."""
    cfg = dict(_SIZES[size])
    cfg.update(kw)
    return PointDiT(in_channels=z_channels, use_xyz_pe=True,
                    release_parity=False, **cfg)


def _release(in_channels: int, cond: int, variant: str, **kw) -> PointDiT:
    cfg = dict(depth=24, width=1024, heads=16, cond_dim=cond,
               vector_dim=cond)
    cfg.update(kw)
    return PointDiT(in_channels=in_channels, use_xyz_pe=in_channels != 3,
                    release_parity=True, variant=variant, **cfg)


def stage1_dit_release(**kw) -> PointDiT:
    """The released stage-1 geometry denoiser (i23d-stage1.sh)."""
    return _release(3, 1024, "clay", **kw)


def stage2_dit_release(**kw) -> PointDiT:
    """The released stage-2 texture denoiser (i23d-stage2.sh)."""
    return _release(10, 1024, "clay", **kw)


def t23d_stage1_dit_release(**kw) -> PointDiT:
    """The released t23d geometry denoiser (stage1-t23d.sh: CLIP text
    context 768)."""
    return _release(3, 768, "text", **kw)


def t23d_stage2_dit_release(**kw) -> PointDiT:
    """The released t23d texture denoiser (stage2-t23d.sh)."""
    return _release(10, 768, "text", **kw)
