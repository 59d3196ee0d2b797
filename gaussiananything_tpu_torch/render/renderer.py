"""Batched multi-view 2DGS renderer (port of
`gaussiananything_tpu/render/renderer.py`).

API parity with `GaussianRenderer2DGS.render` (`nsr/gs_surfel.py:41,195-202`).
Returns channel-first maps: image (B,V,3,H,W) in [0,1], alpha (B,V,1,H,W),
depth (median), rend_normal (world space, 3), dist and depth_expected.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from gaussiananything_tpu_torch.ops import rasterize as rz
from gaussiananything_tpu_torch.utils import profiling


class GaussianRenderer2DGS:
    """Stateless config holder mirroring the reference class."""

    def __init__(self, output_size: int = 512, tile: int = 16,
                 max_per_tile: int = 1024, chunk: int = 256,
                 bg_color=(1.0, 1.0, 1.0), impl: str = "cuda", mesh=None):
        self.output_size = output_size
        self.tile = tile
        self.max_per_tile = max_per_tile
        self.chunk = chunk
        self.bg_color = bg_color
        self.impl = impl
        self.mesh = mesh

    def render(self, gaussians: torch.Tensor, cam_view: torch.Tensor,
               cam_view_proj: torch.Tensor, bg_color=None,
               output_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """gaussians (B,N,13); cam_view/cam_view_proj (B,V,4,4)."""
        B, V = cam_view.shape[:2]
        bg = torch.as_tensor(self.bg_color if bg_color is None else bg_color,
                             dtype=torch.float32, device=gaussians.device)
        if bg.dim() == 1:
            bg = bg.expand(B, V, 3)
        return render_multiview(
            gaussians, cam_view, cam_view_proj, bg,
            output_size or self.output_size, self.tile, self.max_per_tile,
            self.chunk, impl=self.impl, mesh=self.mesh)


def render_multiview(gaussians: torch.Tensor, cam_view: torch.Tensor,
                     cam_view_proj: torch.Tensor, bg: torch.Tensor,
                     out_size: int, tile: int = 16, max_per_tile: int = 2048,
                     chunk: int = 256, impl: str = "cuda", mesh=None
                     ) -> Dict[str, torch.Tensor]:
    """Render B×V views, one rasterizer call per view (`renderer.py:70`).

    gaussians (B,N,13); cam_view/cam_view_proj (B,V,4,4); bg (B,V,3).
    impl: as for `rasterize.rasterize_tiled`: "cuda", the default, goes
    through the kernels' wrappers (for CUDA tensors K2a forward and K2b
    backward where a gradient will be asked for, as in training, and the
    forward-only K1 otherwise, as in sampling; their plain versions for
    CPU tensors); "plain" forces the plain
    versions (the kernels' reference). The JAX renderer's `tanfov` is not
    taken: the projection matrix already carries the field of view.

    mesh: a `parallel.mesh.Mesh` whose tile axis is longer than 1 → each
    view's rows are rendered in bands over the tile group
    (`render.sharded.render_view_sharded`); the returned maps, and so any
    loss on them, are those of the unsharded render.
    """
    B, V = cam_view.shape[:2]
    outs = []
    for s in range(B * V):
        with profiling.span("ga.render.view", view=s):
            b, v = divmod(s, V)
            if mesh is not None and mesh.tile > 1:
                from gaussiananything_tpu_torch.render.sharded import \
                    render_view_sharded
                out = render_view_sharded(
                    mesh, gaussians[b], cam_view[b, v].float(),
                    cam_view_proj[b, v], bg[b, v].contiguous(), out_size,
                    tile=tile, max_per_tile=max_per_tile, chunk=chunk,
                    impl=impl)
            else:
                out = rz.rasterize_tiled(
                    gaussians[b], cam_view[b, v].float(),
                    cam_view_proj[b, v], bg[b, v].contiguous(), out_size,
                    out_size, tile=tile, max_per_tile=max_per_tile,
                    chunk=chunk, impl=impl)
            outs.append(out)
    return _finish(outs, cam_view.reshape(B * V, 4, 4).float(), (B, V))


def _finish(outs, cv: torch.Tensor, lead) -> Dict[str, torch.Tensor]:
    """The views' rasterizer maps → the renderer's maps, all views at once
    with each view's elementwise expressions (the same bits as view by
    view, in a fixed number of launches). cv (S,4,4) fp32 world-to-view."""
    def stacked(k):
        return torch.stack([o[k] for o in outs])
    # world normal: n_world = n_view @ cv[:3,:3].T, componentwise fp32
    nv = stacked("normal_view")
    m = cv[:, :3, :3, None, None]
    n_world = torch.stack([nv[:, 0] * m[:, j, 0] + nv[:, 1] * m[:, j, 1]
                           + nv[:, 2] * m[:, j, 2] for j in range(3)], 1)
    alpha = stacked("alpha")
    depth_exp = stacked("depth_expected") / torch.clamp(alpha, min=1e-10)
    depth_exp = torch.where(alpha > 1e-6, depth_exp,
                            torch.zeros_like(depth_exp))
    maps = {"image": torch.clamp(stacked("image"), 0.0, 1.0),
            "alpha": alpha,
            "depth": stacked("depth_median"),
            "depth_expected": depth_exp,
            "rend_normal": n_world,
            "dist": stacked("dist")}
    return {k: x.reshape(tuple(lead) + x.shape[1:]) for k, x in maps.items()}
