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
    views = []
    for s in range(B * V):
        b, v = divmod(s, V)
        cv = cam_view[b, v].float()
        if mesh is not None and mesh.tile > 1:
            from gaussiananything_tpu_torch.render.sharded import \
                render_view_sharded
            out = render_view_sharded(
                mesh, gaussians[b], cv, cam_view_proj[b, v],
                bg[b, v].contiguous(), out_size, tile=tile,
                max_per_tile=max_per_tile, chunk=chunk, impl=impl)
        else:
            out = rz.rasterize_tiled(
                gaussians[b], cv, cam_view_proj[b, v], bg[b, v].contiguous(),
                out_size, out_size, tile=tile, max_per_tile=max_per_tile,
                chunk=chunk, impl=impl)
        # world normal: n_world = n_view @ cv[:3,:3].T, componentwise fp32
        nv = out["normal_view"]
        n_world = torch.stack([nv[0] * cv[j, 0] + nv[1] * cv[j, 1]
                               + nv[2] * cv[j, 2] for j in range(3)])
        alpha = out["alpha"]
        depth_exp = out["depth_expected"] / torch.clamp(alpha, min=1e-10)
        depth_exp = torch.where(alpha > 1e-6, depth_exp,
                                torch.zeros_like(depth_exp))
        views.append({
            "image": torch.clamp(out["image"], 0.0, 1.0),
            "alpha": alpha,
            "depth": out["depth_median"],
            "depth_expected": depth_exp,
            "rend_normal": n_world,
            "dist": out["dist"],
        })
    return {k: torch.stack([o[k] for o in views]).reshape(
        (B, V) + views[0][k].shape) for k in views[0]}
