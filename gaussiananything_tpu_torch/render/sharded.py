"""Row-band rendering over the mesh's `tile` axis (port of
`gaussiananything_tpu/render/sharded.py`).

The rays/s scaling plan (SURVEY.md §5.7, "replicate primitives, shard
rays"): each rank of a tile group renders one horizontal band of the
view's rows against the full, replicated splat set, binning and
compositing only its band's tiles (`rasterize_tiled(..., full_h, row0)`:
K2a and K2b in training, K1 otherwise, on the card). The band maps are
joined into full maps on every rank of the group (each writes its band
into zeros and the group sums them), so everything after the render sees
the unsharded maps. In the backward each rank takes its band's rows of
the full-map cotangent (the loss on the full maps is the same on every
rank, so the band's cotangent is a slice of it, not a reduce-scatter,
which would scale it by the group's size), runs the band's backward, and
the group sums the splat gradients.

Only `all_reduce` is used: gloo takes it on CUDA tensors.
"""
from __future__ import annotations

from typing import Dict

import torch

from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.parallel.dist import all_reduce_
from gaussiananything_tpu_torch.parallel.mesh import Mesh

_KEYS = tuple(k for k, _, _ in rz.OUT_CHANNELS)


class _SumGrad(torch.autograd.Function):
    """Identity forward; the cotangent summed over the group backward: a
    splat set every rank of the group holds alike, each rank's gradient
    being its band's share."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_(ct.contiguous().clone(), ctx.group), None


class _JoinBands(torch.autograd.Function):
    """(C, band, W) band maps → (C, full_h, W) full maps on every rank of
    the group; backward, the band's rows of the full-map cotangent."""

    @staticmethod
    def forward(ctx, band, row0, full_h, group):
        ctx.rows = (row0, row0 + band.shape[1])
        full = band.new_zeros((band.shape[0], full_h, band.shape[2]))
        full[:, row0:row0 + band.shape[1]] = band
        return all_reduce_(full, group)

    @staticmethod
    def backward(ctx, ct):
        r0, r1 = ctx.rows
        return ct[:, r0:r1], None, None, None


def render_view_sharded(mesh: Mesh, gaussians: torch.Tensor,
                        cam_view: torch.Tensor, cam_view_proj: torch.Tensor,
                        bg: torch.Tensor, out_size: int, tile: int = 16,
                        max_per_tile: int = 1024, chunk: int = 256,
                        impl: str = "cuda") -> Dict[str, torch.Tensor]:
    """One view rendered with its rows over the mesh's tile group: rank i
    of the group renders rows [i·band, (i+1)·band), band = out_size //
    n_tile, and every rank returns the full channel-first maps of
    `rasterize.rasterize_tiled`. gaussians (N, 13), the same on every
    rank of the group; impl as for `rasterize_tiled`."""
    n_tile = mesh.tile
    if out_size % (n_tile * tile):
        raise ValueError(f"out_size {out_size} must be divisible by "
                         f"tile-axis {n_tile} × tile {tile}")
    band = out_size // n_tile
    row0 = mesh.tile_index * band
    group = mesh.tile_group
    g = _SumGrad.apply(gaussians, group) if group is not None else gaussians
    out = rz.rasterize_tiled(g, cam_view, cam_view_proj, bg, band, out_size,
                             tile=tile, max_per_tile=max_per_tile,
                             chunk=chunk, impl=impl, full_h=out_size,
                             row0=row0)
    buf = torch.cat([out[k] for k in _KEYS])
    if group is not None:
        buf = _JoinBands.apply(buf, row0, out_size, group)
    return rz.split_outputs(buf)
