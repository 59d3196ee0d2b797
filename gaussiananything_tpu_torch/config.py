"""Single typed configuration tree (the port's own copy of
`gaussiananything_tpu/config.py`; only `compute_dtype` differs).

Collapses the reference's three overlapping config systems (argparse defaults
dicts `nsr/script_util.py:938-1195`, OmegaConf YAMLs selected by --snr-type
`nsr/lsgm/flow_matching_trainer.py:249-338`, frozen gradio JSON dumps
`configs/gradio_i23d_stage*_args.json`) into one dataclass tree with named
presets mirroring the 5 BASELINE.json configs.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class VAEModelConfig:
    latent_num: int = 768
    z_channels: int = 10
    encoder_width: int = 384
    decoder_width: int = 768
    decoder_depth: int = 12
    decoder_heads: int = 12
    up_factors: Tuple[int, ...] = (8, 4, 3)
    up_depths: Tuple[int, ...] = (2, 1, 1)
    skip_weight: float = 0.1
    # weight-compatible release mode (import official checkpoints); see
    # PointVAE.release_parity
    release_parity: bool = False
    # SurfelHead raw-scale bias init (−2.5 = reference-faithful sub-pixel
    # init; see models/vae.SurfelHead for the pixel-scale ablation)
    scale_bias: float = -2.5
    # "bfloat16" = mixed precision: bf16 matmul/activation compute, fp32
    # params + norms + adaLN + latent stats + gaussian activations (the
    # reference trains BF16 AMP, `nsr/train_util.py:119-127`).
    compute_dtype: str = "float32"


@dataclass
class DiTConfig:
    size: str = "L"                  # S/B/L
    stage: int = 1
    z_channels: int = 10             # stage-2 denoised channels
    cond: str = "image"              # image | text
    cond_width: int = 1024
    cond_depth: int = 24
    cond_heads: int = 16
    cond_img_size: int = 224
    ucg_rate: float = 0.1
    compute_dtype: str = "float32"   # see VAEModelConfig.compute_dtype


@dataclass
class RenderConfig:
    output_size: int = 512
    tile: int = 16
    max_per_tile: int = 2048
    chunk: int = 256
    lod_resolutions: Tuple[int, ...] = (128, 256, 384, 512)


@dataclass
class TransportConfig:
    path_type: str = "gvp"           # release: GVP + uniform t
    t_sampler: str = "uniform"
    cfg_scale: float = 4.5
    num_steps: int = 250
    sampler: str = "heun"            # euler|heun|dopri5


@dataclass
class OptimConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    ema_decay: float = 0.9999
    # extra EMA rates (reference `--ema_rate "0.9999,..."` list)
    extra_ema_decays: Tuple[float, ...] = ()
    warmup_steps: int = 1000
    batch_size: int = 8
    total_steps: int = 100_000
    # ((top-level submodule name, lr multiplier), …) — the reference's
    # decomposed optim groups (encoder_lr / vit_decoder_lr /
    # super_resolution_lr, `nsr/train_util.py:852-905`)
    lr_mults: Tuple[Tuple[str, float], ...] = ()


@dataclass
class DataConfig:
    source: str = "synthetic"        # synthetic | gbuffer | latents
    data_dir: Optional[str] = None
    latent_dir: Optional[str] = None
    n_views_in: int = 4
    n_views_sup: int = 4
    resolution: int = 512
    n_points: int = 4096


@dataclass
class RunConfig:
    name: str = "run"
    logdir: str = "logs"
    seed: int = 42
    vae: VAEModelConfig = field(default_factory=VAEModelConfig)
    dit: DiTConfig = field(default_factory=DiTConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    transport: TransportConfig = field(default_factory=TransportConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh_data: int = 0               # 0 = all devices
    mesh_tile: int = 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        def build(tp, d):
            kw = {}
            for f in dataclasses.fields(tp):
                if f.name not in d:
                    continue
                v = d[f.name]
                sub = getattr(tp(), f.name)
                if dataclasses.is_dataclass(sub):
                    v = build(type(sub), v)
                elif isinstance(v, list):
                    v = tuple(tuple(x) if isinstance(x, list) else x
                              for x in v)
                kw[f.name] = v
            return tp(**kw)

        return build(cls, json.loads(s))


# ------------------------------------------------------------------ presets

def preset(name: str) -> RunConfig:
    """Named presets mirroring BASELINE.json's five configs."""
    c = RunConfig(name=name)
    if name == "raster-demo":           # config 1: single-scene 2DGS, 256²
        c.render = RenderConfig(output_size=256, lod_resolutions=(256,))
    elif name == "render-512":          # config 2: multi-view 512² loop
        pass
    elif name == "vae":                 # config 3: full VAE
        pass
    elif name == "vae-release":         # weight-compat import of the
        # official `ckpts/vae/model_rec1965000.pt` (vae3d-adv-512.sh config:
        # tx_dim 256 encoder, DiT2-B/2 decoder, f=(8,4,3) cascade)
        c.vae = VAEModelConfig(encoder_width=256, release_parity=True)
    elif name == "vae-small":           # CI-scale VAE
        c.vae = VAEModelConfig(latent_num=192, z_channels=8,
                               encoder_width=192, decoder_width=384,
                               decoder_depth=6, decoder_heads=6,
                               up_factors=(8,), up_depths=(1,))
        c.render = RenderConfig(output_size=128, lod_resolutions=(64, 128))
        c.data = DataConfig(resolution=128)
    elif name == "stage1":              # config 4: geometry DiT
        c.dit = DiTConfig(size="L", stage=1)
    elif name == "stage2":              # config 5 part
        c.dit = DiTConfig(size="L", stage=2)
    elif name == "t23d":
        c.dit = DiTConfig(size="L", stage=1, cond="text", cond_width=768,
                          cond_depth=12, cond_heads=12)
    elif name == "demo-e2e":            # tiny end-to-end cascade
        c.vae = VAEModelConfig(latent_num=64, z_channels=4,
                               encoder_width=128, decoder_width=128,
                               decoder_depth=2, decoder_heads=4,
                               up_factors=(4,), up_depths=(1,))
        c.dit = DiTConfig(size="S", stage=1, cond_width=128, cond_depth=2,
                          cond_heads=4, cond_img_size=112)
        c.render = RenderConfig(output_size=128, lod_resolutions=(64, 128),
                                max_per_tile=512)
        c.transport = TransportConfig(num_steps=20)
        c.data = DataConfig(resolution=128, n_views_in=2, n_views_sup=2,
                            n_points=256)
        c.optim = OptimConfig(lr=2e-3, warmup_steps=10, batch_size=2)
    else:
        raise KeyError(name)
    return c


def compute_dtype(name: str):
    """Config string → torch dtype ("float32" | "bfloat16")."""
    import torch
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"compute_dtype must be one of {sorted(table)}, "
                         f"got {name!r}")
    return table[name]


def release_config(base: "RunConfig") -> "RunConfig":
    """Official-checkpoint shapes, shared by every --release entry point
    (sample/serve): CLAY-L DiTs on 768 tokens, DINOv2 ViT-L/14-reg @518
    conditioner, the release VAE ladder (768 -> x8 -> x4 -> x3) and
    512^2 rendering (i23d-stage1.sh / i23d-stage2.sh / vae3d-adv-512.sh).
    Previously duplicated per-CLI and already drifting."""
    return dataclasses.replace(
        base,
        dit=dataclasses.replace(base.dit, size="L", cond_width=1024,
                                cond_depth=24, cond_heads=16,
                                cond_img_size=518),
        vae=dataclasses.replace(base.vae, latent_num=768, z_channels=10,
                                encoder_width=256, decoder_width=768,
                                decoder_depth=12, decoder_heads=12,
                                up_factors=(8, 4, 3), up_depths=(2, 1, 1),
                                release_parity=True),
        render=dataclasses.replace(base.render, output_size=512,
                                   max_per_tile=2048, chunk=256))
