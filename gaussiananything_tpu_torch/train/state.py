"""Train state: parameters, the optimiser's moments and EMA copies, and
checkpoints (port of `gaussiananything_tpu/train/state.py`).

The update rule is written out here and held to optax by the tests:
global-norm clipping, then AdamW (betas (0.9, 0.95), eps 1e-8, decoupled
decay on EVERY parameter), with a learning rate that warms up linearly from
0 and is read at the step count BEFORE the increment (so the first update
has lr 0), scaled per top-level module by `lr_mults`. `torch.optim.AdamW`
differs in its eps placement's bias correction and has no such schedule or
clipping built in, so it is not used.

The parameters, both moments and every EMA copy are fp32 whatever the
models' compute dtype (`models/layers.py`): bf16 activations with fp32
parameters need no loss scaling, as in the JAX package. `TrainState`
refuses parameters of another dtype. A checkpoint of bf16 tensors loads by
`copy_`, which rounds nothing on the way up.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

Tree = Dict[str, torch.Tensor]
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainStateConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    ema_decay: float = 0.9999
    # one further EMA copy per rate (reference `--ema_rate "0.9999,0.999"`,
    # `nsr/train_util.py:97,159`)
    extra_ema_decays: tuple = ()
    warmup_steps: int = 1000
    betas: tuple = (0.9, 0.95)
    # ((module name, multiplier), …): a parameter whose dotted name has the
    # module name as a component trains at lr · multiplier (the reference's
    # encoder_lr / vit_decoder_lr / super_resolution_lr groups,
    # `nsr/train_util.py:852-905`)
    lr_mults: tuple = ()


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in tree.values()))


def learning_rate(cfg: TrainStateConfig, count: int, name: str = "") -> float:
    """lr · mult(name) · min(count / warmup_steps, 1)."""
    if cfg.warmup_steps <= 0:
        raise ValueError("warmup_steps must be positive")
    mult = 1.0
    parts = name.split(".")
    for key, m in cfg.lr_mults:
        if key in parts:
            mult = m
            break
    return cfg.lr * mult * min(count / cfg.warmup_steps, 1.0)


class TrainState:
    """`params` are the model's own parameter tensors, updated in place;
    `mu`/`nu` are AdamW's moments, `ema` the primary EMA copy, `ema_extra`
    {rate string: copy} for `extra_ema_decays`; `step` counts updates.

    A `frozen` state (a conditioner trained with `--freeze-cond`, the JAX
    package's `optax.identity()` state) holds no moments and no EMA copy:
    its `ema` IS its parameters, and it takes no update."""

    def __init__(self, params: Tree, extra_ema_decays: Tuple[float, ...] = (),
                 frozen: bool = False):
        if frozen and extra_ema_decays:
            raise ValueError("a frozen state keeps no EMA copies")
        low = sorted(k for k, p in params.items() if p.dtype != torch.float32)
        if low:
            raise ValueError(f"{len(low)} parameters are not float32, e.g. "
                             f"{low[:3]}: the compute dtype goes to the "
                             "modules, the parameters stay fp32")
        self.params = params
        self.frozen = frozen
        self.mu = {} if frozen else {k: torch.zeros_like(p)
                                     for k, p in params.items()}
        self.nu = {} if frozen else {k: torch.zeros_like(p)
                                     for k, p in params.items()}
        self.ema = params if frozen else {k: p.detach().clone()
                                          for k, p in params.items()}
        self.ema_extra = {f"{d:g}": {k: p.detach().clone()
                                     for k, p in params.items()}
                          for d in extra_ema_decays}
        self.step = 0

    @classmethod
    def create(cls, model: nn.Module,
               extra_ema_decays: Tuple[float, ...] = (),
               frozen: bool = False) -> "TrainState":
        """The trainable parameters of `model`; with `frozen`, all of them,
        which stop requiring gradients."""
        if frozen:
            model.requires_grad_(False)
            return cls(dict(model.named_parameters()), frozen=True)
        return cls({k: p for k, p in model.named_parameters()
                    if p.requires_grad}, extra_ema_decays)

    @torch.no_grad()
    def apply_gradients(self, grads: Tree, cfg: TrainStateConfig):
        """One optimiser update and the EMA updates, in place."""
        if self.frozen:
            raise RuntimeError("a frozen state takes no update")
        norm = global_norm(grads)
        # g unchanged below the clip norm, else g / norm · clip
        scale = torch.where(norm < cfg.grad_clip, torch.ones_like(norm),
                            cfg.grad_clip / norm)
        b1, b2 = cfg.betas
        count = self.step + 1
        c1 = 1.0 - b1 ** count
        c2 = 1.0 - b2 ** count
        for k, p in self.params.items():
            g = grads[k] * scale
            mu = self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
            nu = self.nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS) \
                + cfg.weight_decay * p
            p.add_(update, alpha=-learning_rate(cfg, self.step, k))
        ramp = (1.0 + self.step) / (10.0 + self.step)
        for decay, tree in [(cfg.ema_decay, self.ema)] + [
                (float(r), t) for r, t in self.ema_extra.items()]:
            d = min(decay, ramp)
            for k, p in self.params.items():
                tree[k].mul_(d).add_(p, alpha=1.0 - d)
        self.step += 1

    def state_dict(self) -> dict:
        """A frozen state's `ema` is its `params` (torch.save writes the
        shared tensors once)."""
        return {"params": self.params, "mu": self.mu, "nu": self.nu,
                "ema": self.ema, "ema_extra": self.ema_extra,
                "step": self.step, "frozen": self.frozen}

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        if sd.get("frozen", False) != self.frozen:
            raise ValueError(
                "a checkpoint of a frozen state restores only a frozen "
                "state, and one of a trained state only a trained one")
        for name in ("params", "mu", "nu", "ema"):
            tree = getattr(self, name)
            if set(tree) != set(sd[name]):
                raise KeyError(f"checkpoint {name} keys differ from the "
                               "state's")
            for k, v in sd[name].items():
                tree[k].copy_(v)
        if set(self.ema_extra) != set(sd["ema_extra"]):
            raise KeyError("checkpoint EMA rates differ from the state's")
        for r, tree in sd["ema_extra"].items():
            for k, v in tree.items():
                self.ema_extra[r][k].copy_(v)
        self.step = int(sd["step"])


# ------------------------------------------------------------ checkpoints

def _steps(path: str):
    return sorted(int(f[5:-3]) for f in os.listdir(path)
                  if f.startswith("step_") and f.endswith(".pt"))


def save_checkpoint(path: str, state: TrainState, keep: int = 3) -> str:
    """Write `path/step_XXXXXXXX.pt` (atomically: temporary name, then
    rename) and keep the newest `keep` files."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"step_{state.step:08d}.pt")
    torch.save(state.state_dict(), target + ".tmp")
    os.replace(target + ".tmp", target)
    if keep > 0:
        for s in _steps(path)[:-keep]:
            os.remove(os.path.join(path, f"step_{s:08d}.pt"))
    return target


def _load(path: str, state: TrainState, step: Optional[int]) -> dict:
    """The newest (or the given) step of `path`, on the state's device."""
    if step is None:
        steps = _steps(path) if os.path.isdir(path) else []
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {path}")
        step = steps[-1]
    return torch.load(os.path.join(path, f"step_{step:08d}.pt"),
                      map_location=next(iter(state.params.values())).device)


def restore_checkpoint(path: str, state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Load the newest (or the given) step of `path` into `state`."""
    state.load_state_dict(_load(path, state, step))
    return state


@torch.no_grad()
def load_submodule(path: str, state: TrainState, submodule: str,
                   step: Optional[int] = None, ema: bool = False
                   ) -> TrainState:
    """Graft ONE top-level submodule (the entries named `submodule.*`) of a
    checkpoint into `state`: its parameters, its EMA and every extra-rate
    EMA copy, in place; the other entries, the optimiser's moments and the
    step stay (`load_submodule_name`, `nsr/train_util.py:78,582-605`: warm
    starting a run from a pretrained encoder). `ema=True` grafts the
    checkpoint's EMA copy instead of its parameters. The checkpoint may
    come from a model whose other submodules differ.

    Raises KeyError naming the available submodules when the checkpoint
    has no `submodule`, ValueError when its entries' names or shapes differ
    from the state's."""
    src = _load(path, state, step)["ema" if ema else "params"]
    prefix = submodule + "."
    sub = {k: v for k, v in src.items() if k.startswith(prefix)}
    if not sub:
        raise KeyError(f"checkpoint has no submodule {submodule!r}; "
                       f"available: {sorted({k.split('.')[0] for k in src})}")
    cur = [k for k in state.params if k.startswith(prefix)]
    if sorted(cur) != sorted(sub):
        raise ValueError(f"structure mismatch grafting {submodule!r}: "
                         f"{len(cur)} vs {len(sub)} entries")
    for k in cur:
        if sub[k].shape != state.params[k].shape:
            raise ValueError(f"shape mismatch grafting {submodule!r} at {k}: "
                             f"{tuple(state.params[k].shape)} vs "
                             f"{tuple(sub[k].shape)}")
    for tree in (state.params, state.ema, *state.ema_extra.values()):
        for k in cur:
            tree[k].copy_(sub[k])
    return state


@torch.no_grad()
def restore_inference_params(ckpt: Optional[str], module: nn.Module,
                             step: Optional[int] = None) -> nn.Module:
    """The CLIs' restore (`train/state.restore_inference_params` of the
    JAX package), into `module` in place:

      * None: `module` as it is;
      * a `.npz` in the JAX package's layout (what `cli/import_release`
        and `save_params_npz` write, bare or wrapped in {"params": ...}):
        `load_params_npz` → `from_jax_params`;
      * a directory of this package's training checkpoints
        (`save_checkpoint`): the newest (or the given) step's EMA weights,
        the entries named like the module's parameters (a decoder-only VAE
        takes the decoder of a trained VAE).

    The JAX trainer's Orbax checkpoints need JAX to read and are not taken.
    Values are cast to the module's dtype."""
    if not ckpt:
        return module
    target = module.state_dict()
    if ckpt.endswith(".npz"):
        from gaussiananything_tpu_torch.utils.param_io import (
            from_jax_params, load_params_npz)
        sd = from_jax_params(load_params_npz(ckpt), module)
    else:
        if step is None:
            steps = _steps(ckpt) if os.path.isdir(ckpt) else []
            if not steps:
                raise FileNotFoundError(f"no checkpoint under {ckpt}")
            step = steps[-1]
        ema = torch.load(os.path.join(ckpt, f"step_{step:08d}.pt"),
                         map_location="cpu")["ema"]
        missing = sorted(set(target) - set(ema))
        if missing:
            raise KeyError(f"checkpoint {ckpt} lacks {len(missing)} of the "
                           f"module's entries, e.g. {missing[:5]}")
        sd = {k: ema[k] for k in target}
    module.load_state_dict(sd)
    return module
