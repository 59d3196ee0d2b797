"""Farthest point sampling (port of `gaussiananything_tpu/ops/fps.py`).

Picks the K latent anchors from the surface point cloud
(`nsr/srt/encoder.py:533`): a K-step loop of a distance update and an
argmax over the N points, batched over the leading dimensions.

The loop is about 13 small launches a step, ~10,000 for the release
encoder's 768 anchors, and nothing in it is read back to the host. Where
`fps_graph_engages` (CUDA points, grad mode off, no capture underway: the
extraction and sampling calls, not training's) it replays as one CUDA
graph (`FPS_GRAPHS`, `utils/graphs`: the same kernels on the same data)
once its key (`fps_key`) has come twice, so the host launches one graph
instead of ~10,000 kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gaussiananything_tpu_torch.utils import profiling
from gaussiananything_tpu_torch.utils.graphs import GraphCache

FPS_GRAPHS = GraphCache("ga.encode.fps")


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim with ties to the LOWEST index, as
    `jnp.argmax` promises and `torch.argmax` on CUDA does not."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    is_max = x == x.amax(dim=-1, keepdim=True)
    return torch.where(is_max, idx, torch.full_like(idx, n)).amin(dim=-1)


@torch.no_grad()
def _fps_indices(pts: torch.Tensor, k: int, valid: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    B, n, _ = pts.shape
    big = 1e10
    if valid is None:
        valid = torch.ones((B, n), dtype=torch.bool, device=pts.device)
    last = _first_argmax(valid.to(torch.uint8))             # first valid
    dists = torch.full((B, n), big, dtype=pts.dtype, device=pts.device)
    rows = torch.arange(B, device=pts.device)
    idxs = []
    for _ in range(k):
        idxs.append(last)
        d = ((pts - pts[rows, last][:, None, :]) ** 2).sum(-1)
        dists = torch.minimum(dists, d)
        last = _first_argmax(torch.where(valid, dists,
                                         torch.full_like(dists, -big)))
    return torch.stack(idxs, dim=1)


def fps_graph_engages(pts: torch.Tensor) -> bool:
    """Whether a call replays as a CUDA graph: the points on CUDA, grad
    mode off and no stream capture underway. Training's calls, and their
    recomputation under activation checkpointing, keep the eager loop."""
    return (pts.device.type == "cuda" and not torch.is_grad_enabled()
            and not torch.cuda.is_current_stream_capturing())


def fps_key(pts: torch.Tensor, k: int, valid: Optional[torch.Tensor]
            ) -> tuple:
    """What a capture of `_fps_indices` fixes: the device and current
    stream, inference mode, the points' and the mask's shapes, and k."""
    dev = pts.device
    return (dev, torch.cuda.current_stream(dev).stream_id,
            torch.is_inference_mode_enabled(), pts.shape,
            None if valid is None else valid.shape, k)


def sample_farthest_points(points: torch.Tensor, k: int,
                           mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (..., N, 3) → (selected (..., k, 3), indices (..., k)).

    `mask` (..., N) marks the valid input points. The start is the first
    valid point (pytorch3d's `random_start=False`). The indices carry no
    gradient; the selected points are a gather of `points`. Where
    `fps_graph_engages` the loop replays as a CUDA graph (module
    docstring). Opens the span `ga.encode.fps` (B, N, K).
    """
    batch = points.shape[:-2]
    flat = points.reshape((-1,) + points.shape[-2:])
    with profiling.span("ga.encode.fps", B=flat.shape[0], N=flat.shape[1],
                        K=k):
        mflat = None if mask is None else mask.reshape(-1, mask.shape[-1])
        pts = flat.detach().float()
        if fps_graph_engages(pts):
            with FPS_GRAPHS.lock:
                idx, _ = FPS_GRAPHS.run(
                    fps_key(pts, k, mflat),
                    lambda p, m: _fps_indices(p, k, m), (pts, mflat),
                    clone=True)
        else:
            idx = _fps_indices(pts, k, mflat)
        sel = torch.gather(flat, 1, idx[..., None].expand(-1, -1, 3))
        return sel.reshape(batch + (k, 3)), idx.reshape(batch + (k,))
