"""The plain reference of the 2DGS rasterizer and the turntable cameras, a
frozen copy kept with the benchmark so that it reads the same whatever the
program's rasterizer becomes: the projection of surfels into a view, the
binning into depth-ordered tile lists (at most `max_per_tile` per tile,
the farthest dropped), and front-to-back compositing with the early exit
at T <= 1e-4 (Huang et al. 2024, 2D Gaussian Splatting; the expression
order of GaussianAnything's `composite_chunk_grouped`).

`composite` also counts the (tile, splat) steps a view needs: for each
tile, the splats of its list up to the one after which every pixel of the
tile has terminated. `benchmark/counts/raster.py` turns them into the
kernels' operations.

Products that the configuration states in IEEE fp32 (the camera matrices,
the tile sums) take their operands through `precision.geom`, which rounds
them to TF32 in the control.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference.precision import geom


def normalize(v: torch.Tensor, eps: float = 1e-8, dim: int = -1
              ) -> torch.Tensor:
    return v * torch.rsqrt((v * v).sum(dim, keepdim=True) + eps * eps)


def unpack_gaussians(g):
    return SplatsIn(xyz=g[..., 0:3], opacity=g[..., 3:4], scale=g[..., 4:6],
                    rotation=g[..., 6:10], rgb=g[..., 10:13])


class SplatsIn(NamedTuple):
    xyz: torch.Tensor
    opacity: torch.Tensor
    scale: torch.Tensor
    rotation: torch.Tensor
    rgb: torch.Tensor

FILTER_INV_SQUARE = 2.0
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR_CULL = 0.2
RHO_CUT = 9.0
RHO_RAMP = 1.0
ZNEAR, ZFAR = 0.01, 100.0

PACKED_F = 22       # rows of the packed table, layout below
# Packed row layout (`rasterize.py:313-321`): 0:3 p-coefficient A, 3:6 B,
# 6:9 C, 9:12 view-depth plane, 12/13 projected centre, 14 centre depth,
# 15 opacity (0 for invalid splats), 16:19 rgb, 19:22 view normal.
OUT_CHANNELS = (("image", 0, 3), ("alpha", 3, 4), ("depth_expected", 4, 5),
                ("depth_median", 5, 6), ("dist", 6, 7),
                ("normal_view", 7, 10))
N_OUT = 10
_TILE_GROUP = 128   # tiles the plain compositor evaluates at once


def _rho_window(rho: torch.Tensor) -> torch.Tensor:
    return torch.clamp((RHO_CUT - rho) / RHO_RAMP, 0.0, 1.0)


class SplatProj(NamedTuple):
    """Per-view projected splat parameters (all (N, …), fp32)."""

    t_x: torch.Tensor         # (N, 3) pixel-x plane coeffs over (u, v, 1)
    t_y: torch.Tensor         # (N, 3)
    t_w: torch.Tensor         # (N, 3) homogeneous-w coeffs
    t_z: torch.Tensor         # (N, 3) view-depth coeffs
    center_pix: torch.Tensor  # (N, 2)
    center_z: torch.Tensor    # (N,) view-space centre depth (sort key)
    opacity: torch.Tensor     # (N,)
    rgb: torch.Tensor         # (N, 3)
    normal_view: torch.Tensor  # (N, 3) camera-facing view-space normal
    bb_min: torch.Tensor      # (N, 2) screen AABB of the rho <= RHO_CUT set
    bb_max: torch.Tensor      # (N, 2)
    valid: torch.Tensor       # (N,) bool


def preprocess_splats(gaussians: torch.Tensor, cam_view: torch.Tensor,
                      cam_view_proj: torch.Tensor, img_h: int, img_w: int
                      ) -> SplatProj:
    """Project N 13-channel surfels into one view (`rasterize.py:85`).

    Componentwise on (N,) vectors with the JAX package's expression order;
    the screen AABB is the exact projective bound of the conic
    u² + v² = RHO_CUT (a centre-based 3σ radius underestimates tilted
    surfels and misses neighbouring tiles).
    """
    g = unpack_gaussians(gaussians.float())
    qn = normalize(g.rotation)
    qr, qx, qy, qz = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    su = g.scale[:, 0]
    sv = g.scale[:, 1]
    tu = ((1 - 2 * (qy * qy + qz * qz)) * su,
          (2 * (qx * qy + qr * qz)) * su,
          (2 * (qx * qz - qr * qy)) * su)
    tv = ((2 * (qx * qy - qr * qz)) * sv,
          (1 - 2 * (qx * qx + qz * qz)) * sv,
          (2 * (qy * qz + qr * qx)) * sv)
    nrm = (2 * (qx * qz + qr * qy),
           2 * (qy * qz - qr * qx),
           1 - 2 * (qx * qx + qy * qy))
    pxyz = (g.xyz[:, 0], g.xyz[:, 1], g.xyz[:, 2])
    P = cam_view_proj.float()
    V = cam_view.float()

    def _row_times(vec3, M, w_row, j):
        out = vec3[0] * M[0, j] + vec3[1] * M[1, j] + vec3[2] * M[2, j]
        return out + M[3, j] if w_row else out

    Tc = {(i, j): _row_times(row, P, w, j)
          for i, (row, w) in enumerate(((tu, 0), (tv, 0), (pxyz, 1)))
          for j in (0, 1, 3)}
    tz_c = tuple(_row_times(row, V, w, 2)
                 for row, w in ((tu, 0), (tv, 0), (pxyz, 1)))

    kx, bx = 0.5 * img_w, 0.5 * img_w - 0.5
    ky, by = 0.5 * img_h, 0.5 * img_h - 0.5
    tx_c = tuple(kx * Tc[(i, 0)] + bx * Tc[(i, 3)] for i in range(3))
    ty_c = tuple(ky * Tc[(i, 1)] + by * Tc[(i, 3)] for i in range(3))
    tw_c = tuple(Tc[(i, 3)] for i in range(3))

    cw = tw_c[2]
    safe_cw = torch.where(cw.abs() < 1e-8, torch.full_like(cw, 1e-8), cw)
    cpx = tx_c[2] / safe_cw
    cpy = ty_c[2] / safe_cw
    center_z = tz_c[2]

    nv = [_row_times(nrm, V, 0, j) for j in range(3)]
    pv = [_row_times(pxyz, V, 1, j) for j in range(3)]
    facing = nv[0] * pv[0] + nv[1] * pv[1] + nv[2] * pv[2]
    flip = 1.0 - 2.0 * (facing > 0).float()
    nv = [c * flip for c in nv]

    A_conic = RHO_CUT * (tw_c[0] * tw_c[0] + tw_c[1] * tw_c[1]) \
        - tw_c[2] * tw_c[2]
    bounded = A_conic < -1e-9
    safe_A = torch.where(bounded, A_conic, torch.full_like(A_conic, -1.0))

    def _axis_bounds(t_a):
        B = RHO_CUT * (t_a[0] * tw_c[0] + t_a[1] * tw_c[1]) \
            - t_a[2] * tw_c[2]
        C = RHO_CUT * (t_a[0] * t_a[0] + t_a[1] * t_a[1]) \
            - t_a[2] * t_a[2]
        mid = B / safe_A
        half = torch.sqrt(torch.clamp(mid * mid - C / safe_A, min=1e-4))
        return mid - half, mid + half

    x0, x1 = _axis_bounds(tx_c)
    y0, y1 = _axis_bounds(ty_c)
    rf = float(np.sqrt(RHO_CUT / FILTER_INV_SQUARE)) + 0.5
    bb_min = torch.stack([torch.minimum(x0, cpx - rf),
                          torch.minimum(y0, cpy - rf)], -1)
    bb_max = torch.stack([torch.maximum(x1, cpx + rf),
                          torch.maximum(y1, cpy + rf)], -1)
    valid = (center_z > NEAR_CULL) & (g.opacity[:, 0] > 0) \
        & torch.isfinite(cpx) & torch.isfinite(cpy) & bounded
    return SplatProj(
        t_x=torch.stack(tx_c, -1), t_y=torch.stack(ty_c, -1),
        t_w=torch.stack(tw_c, -1), t_z=torch.stack(tz_c, -1),
        center_pix=torch.stack([cpx, cpy], -1), center_z=center_z,
        opacity=g.opacity[:, 0], rgb=g.rgb, normal_view=torch.stack(nv, -1),
        bb_min=bb_min, bb_max=bb_max, valid=valid)


def pack_splat_render(sp: SplatProj) -> torch.Tensor:
    """SplatProj → (PACKED_F, N) hot-loop matrix (`rasterize.py:324`).

    The ray-plane cross product is bilinear in the pixel coordinates:
    p = px·A + py·B + C with A = t_y×t_w, B = t_w×t_x, C = t_x×t_y.
    """
    x0, x1, x2 = sp.t_x[:, 0], sp.t_x[:, 1], sp.t_x[:, 2]
    y0, y1, y2 = sp.t_y[:, 0], sp.t_y[:, 1], sp.t_y[:, 2]
    w0, w1, w2 = sp.t_w[:, 0], sp.t_w[:, 1], sp.t_w[:, 2]

    def _cross(a0, a1, a2, b0, b1, b2):
        return (a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0)

    A = _cross(y0, y1, y2, w0, w1, w2)
    B = _cross(w0, w1, w2, x0, x1, x2)
    C = _cross(x0, x1, x2, y0, y1, y2)
    op = torch.where(sp.valid, sp.opacity, torch.zeros_like(sp.opacity))
    return torch.stack([
        *A, *B, *C, sp.t_z[:, 0], sp.t_z[:, 1], sp.t_z[:, 2],
        sp.center_pix[:, 0], sp.center_pix[:, 1], sp.center_z, op,
        sp.rgb[:, 0], sp.rgb[:, 1], sp.rgb[:, 2],
        sp.normal_view[:, 0], sp.normal_view[:, 1], sp.normal_view[:, 2],
    ], dim=0)


def build_tile_pairs(sp: SplatProj, img_h: int, img_w: int, tile: int,
                     max_per_tile: int, row0: int = 0, big_capacity: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bin splats into a tile-sorted, depth-ordered flat pair array
    (`rasterize.py:675`, same semantics).

      * SMALL bucket: every splat gets 4 slots over a 2×2 tile window.
      * BIG bucket: splats spanning more than 2×2 tiles are compacted (depth
        order kept) into `big_capacity` 36-slot entries over a 6×6 window;
        bigs beyond capacity fall back to their top-left 2×2 window.
      * `big_capacity=0` → N for N ≤ 16384, else max(N // 16, 4096).
      * Footprints are clamped to 6×6 tiles about the bbox centre.
      * (tile, depth rank) sort; `counts` caps each tile at `max_per_tile`,
        dropping the farthest splats.
      * `row0` offsets rows for a band of a taller image.

    Returns int32 (pairs, starts, counts): `pairs` holds splat ids, the
    concatenated per-tile segments followed by `max_per_tile` zeros so any
    chunk read below a tile's count stays in range; `starts[t]` is tile t's
    segment offset and `counts[t]` its capped length.
    """
    dev = sp.center_z.device
    tiles_x = img_w // tile
    tiles_y = img_h // tile
    n_tiles = tiles_x * tiles_y
    N = sp.center_z.shape[0]
    if big_capacity <= 0:
        big_capacity = N if N <= 16384 else max(N // 16, 4096)
    big_capacity = min(big_capacity, N)

    key = torch.where(sp.valid, sp.center_z,
                      torch.full_like(sp.center_z, float("inf")))
    order = torch.sort(key, stable=True).indices
    x0 = sp.bb_min[order, 0]
    x1 = sp.bb_max[order, 0]
    y0 = sp.bb_min[order, 1] - row0
    y1 = sp.bb_max[order, 1] - row0
    big_span, span_side = 36, 6
    half_cap = (span_side - 1) * tile / 2
    mx, my = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
    x0 = torch.maximum(x0, mx - half_cap)
    x1 = torch.minimum(x1, mx + half_cap)
    y0 = torch.maximum(y0, my - half_cap)
    y1 = torch.minimum(y1, my + half_cap)
    valid = sp.valid[order]

    def _tile_of(v, n):
        # clamp in float first: the cast of an out-of-range float is
        # undefined, and clamping commutes with floor for in-range values
        return torch.clamp(torch.floor(v / tile), 0, n - 1).long()

    tx0, tx1 = _tile_of(x0, tiles_x), _tile_of(x1, tiles_x)
    ty0, ty1 = _tile_of(y0, tiles_y), _tile_of(y1, tiles_y)
    on_screen = (x1 >= 0) & (x0 < img_w) & (y1 >= 0) & (y0 < img_h)
    valid = valid & on_screen
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    rank = torch.arange(N, device=dev)

    # compact big splats by a gather on the inclusive big-count
    is_big = valid & ((span_x > 2) | (span_y > 2))
    incl = torch.cumsum(is_big.long(), 0)
    n_big = incl[-1] if N else torch.zeros((), dtype=torch.long, device=dev)
    sel = is_big & (incl - 1 < big_capacity)
    slots_b = torch.arange(big_capacity + 1, device=dev)
    src = torch.searchsorted(incl, slots_b + 1, side="left")
    b_valid = slots_b < torch.clamp(n_big, max=big_capacity)
    src = torch.where(b_valid, src, torch.zeros_like(src))

    def compact(a):
        return torch.where(b_valid, a[src], torch.zeros_like(a[src]))

    b_tx0, b_ty0 = compact(tx0), compact(ty0)
    b_span_x, b_span_y = compact(span_x), compact(span_y)
    b_rank, b_splat = compact(rank), compact(order)

    slots4 = torch.arange(4, device=dev)[:, None]
    s_off_x, s_off_y = slots4 % 2, slots4 // 2
    s_ok = valid[None] & ~sel[None] \
        & (s_off_x < torch.clamp(span_x, max=2)[None]) \
        & (s_off_y < torch.clamp(span_y, max=2)[None])
    s_tile4 = (ty0[None] + s_off_y) * tiles_x + (tx0[None] + s_off_x)
    s_tile4 = torch.where(s_ok, s_tile4, torch.full_like(s_tile4, n_tiles))

    slots36 = torch.arange(big_span, device=dev)[:, None]
    bsx = torch.clamp(b_span_x, min=1)[None]
    b_off_x, b_off_y = slots36 % bsx, slots36 // bsx
    b_ok = b_valid[None] & (slots36 < (b_span_x * b_span_y)[None]) \
        & (b_off_y < b_span_y[None])
    b_tile36 = (b_ty0[None] + b_off_y) * tiles_x + (b_tx0[None] + b_off_x)
    b_tile36 = torch.where(b_ok, b_tile36,
                           torch.full_like(b_tile36, n_tiles))

    flat_tile = torch.cat([s_tile4.reshape(-1), b_tile36.reshape(-1)])
    flat_rank = torch.cat([rank.expand(4, N).reshape(-1),
                           b_rank.expand(big_span, -1).reshape(-1)])
    flat_splat = torch.cat([order.expand(4, N).reshape(-1),
                            b_splat.expand(big_span, -1).reshape(-1)])
    # lexicographic (tile, depth rank): unique for every live pair
    perm = torch.sort(flat_tile * (N + 1) + flat_rank, stable=True).indices
    s_tile = flat_tile[perm]
    s_splat = flat_splat[perm]

    bounds = torch.searchsorted(
        s_tile, torch.arange(n_tiles + 1, device=dev), side="left")
    starts = bounds[:-1]
    counts = torch.clamp(bounds[1:] - starts, max=max_per_tile)
    pairs = torch.cat([s_splat,
                       torch.zeros(max_per_tile, dtype=s_splat.dtype,
                                   device=dev)])
    return pairs.int(), starts.int(), counts.int()


# ---------------------------------------------------------------------------
# The plain compositor: K1's counterpart in PyTorch.
# ---------------------------------------------------------------------------


class PixelState(NamedTuple):
    rgb: torch.Tensor        # (G, P, 3)
    trans: torch.Tensor      # (G, P)
    alpha_acc: torch.Tensor
    depth_exp: torch.Tensor  # Σ w·z
    depth_med: torch.Tensor
    normal: torch.Tensor     # (G, P, 3)
    dist: torch.Tensor
    dist_d: torch.Tensor     # Σ w·m
    dist_d2: torch.Tensor    # Σ w·m²


def _init_state(G: int, P: int, device, dtype=torch.float32) -> PixelState:
    z = torch.zeros((G, P), dtype=dtype, device=device)
    z3 = torch.zeros((G, P, 3), dtype=dtype, device=device)
    return PixelState(rgb=z3, trans=torch.ones_like(z), alpha_acc=z,
                      depth_exp=z, depth_med=z, normal=z3, dist=z, dist_d=z,
                      dist_d2=z)


def _mapped_depth(z: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(z, min=ZNEAR)
    return (ZFAR * (z - ZNEAR)) / (z * (ZFAR - ZNEAR))


def composite_chunk(state: PixelState, px: torch.Tensor, py: torch.Tensor,
                    data: torch.Tensor, return_weights: bool = False):
    """Composite one depth-sorted chunk for G tiles × P pixels
    (`composite_chunk_grouped`, `rasterize.py:360`, expression for
    expression). px, py: (G, P); data: (PACKED_F, G, K). Returns the new
    state; with `return_weights` also the (G, P, K) blend weights w."""
    a0, a1, a2 = data[0][:, None], data[1][:, None], data[2][:, None]
    b0, b1, b2 = data[3][:, None], data[4][:, None], data[5][:, None]
    c0, c1, c2 = data[6][:, None], data[7][:, None], data[8][:, None]
    tz0, tz1, tz2 = data[9][:, None], data[10][:, None], data[11][:, None]
    cx, cy = data[12][:, None], data[13][:, None]
    cz, op = data[14][:, None], data[15][:, None]

    pxe = px[..., None]                                     # (G, P, 1)
    pye = py[..., None]
    p0 = pxe * a0 + pye * b0 + c0                           # (G, P, K)
    p1 = pxe * a1 + pye * b1 + c1
    p2 = pxe * a2 + pye * b2 + c2
    safe = torch.where(p2.abs() < 1e-9, torch.full_like(p2, 1e-9), p2)
    inv = 1.0 / safe
    u = p0 * inv
    v = p1 * inv
    rho3d = u * u + v * v
    dx = pxe - cx
    dy = pye - cy
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(use3d, u * tz0 + v * tz1 + tz2, cz.expand_as(u))

    g = torch.exp(-0.5 * rho) * _rho_window(rho)
    alpha = torch.clamp(op * g, max=ALPHA_MAX)
    keep = (alpha >= ALPHA_EPS) & (depth > NEAR_CULL)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(keep, alpha, zero)
    depth = torch.where(keep, depth, zero)

    t_incl = torch.cumprod(1.0 - alpha, dim=-1)             # Π_{j<=i}(1−α_j)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]),
                        t_incl[..., :-1]], dim=-1)
    tau = state.trans[..., None]
    t_in = tau * t_excl
    below = t_in <= T_EPS
    w = torch.where(below, zero, tau * alpha * t_excl)

    feats = torch.stack([data[16], data[17], data[18], data[19], data[20],
                         data[21], torch.ones_like(data[0])], dim=-1)
    acc = torch.bmm(geom(w), geom(feats))                             # (G, P, 7)
    s_w = acc[..., 6]
    depth_exp = state.depth_exp + (w * depth).sum(-1)

    t_after = tau * t_incl
    crossed = (t_in > 0.5) & (t_after <= 0.5)
    depth_med = state.depth_med + torch.where(crossed, depth, zero).sum(-1)

    m = _mapped_depth(depth)
    wm = w * m
    s_wm = wm.sum(-1)
    s_wm2 = (wm * m).sum(-1)
    dist = state.dist \
        + state.alpha_acc * s_wm2 + state.dist_d2 * s_w \
        - 2.0 * state.dist_d * s_wm \
        + (s_w * s_wm2 - s_wm * s_wm)

    # below T_EPS every later weight is exactly zero: the ray is dead, and
    # flushing its transmittance makes that exact (bg blend included)
    trans_raw = state.trans * t_incl[..., -1]
    trans_out = torch.where(trans_raw > T_EPS, trans_raw,
                            torch.zeros_like(trans_raw))
    out = PixelState(
        rgb=state.rgb + acc[..., 0:3], trans=trans_out,
        alpha_acc=state.alpha_acc + s_w, depth_exp=depth_exp,
        depth_med=depth_med, normal=state.normal + acc[..., 3:6],
        dist=dist, dist_d=state.dist_d + s_wm,
        dist_d2=state.dist_d2 + s_wm2)
    return (out, w, t_in) if return_weights else out



class _TileWalk:
    """What the plain forward and backward share for a frame: the zero-row
    padded table, pixel coordinates, and the tiles in groups of
    `_TILE_GROUP` (a memory bound only: every chunk a saturated tile skips
    contributes exactly zero, to outputs and to gradients). The walk runs
    in the table's dtype: float32 is what the kernels compute; a float64
    table makes the same functions their own higher-precision witness."""

    def __init__(self, tab, pairs, starts, counts, img_h, img_w, tile,
                 chunk, row0=0):
        dev = tab.device
        self.dtype = tab.dtype
        self.tile, self.chunk = tile, chunk
        self.tiles_x, self.tiles_y = img_w // tile, img_h // tile
        self.n_tiles, self.P = self.tiles_x * self.tiles_y, tile * tile
        self.N = tab.shape[0]
        # zero dummy row: masked slots read opacity 0 ⇒ alpha 0, factor 1.0
        self.tab0 = torch.cat([tab[:, :PACKED_F],
                               tab.new_zeros((1, PACKED_F))])
        self.pairs, self.starts = pairs.long(), starts.long()
        self.counts = counts.long()
        lidx = torch.arange(self.P, device=dev)
        self.local_x = (lidx % tile).to(self.dtype)
        self.local_y = (lidx // tile).to(self.dtype) + row0
        self.j_chunk = torch.arange(chunk, device=dev)
        self.counts_host = self.counts.cpu()
        self.dev = dev

    def groups(self):
        """Yields (tiles, px, py, n_chunks) per tile group."""
        for g0 in range(0, self.n_tiles, _TILE_GROUP):
            tiles = torch.arange(g0, min(g0 + _TILE_GROUP, self.n_tiles),
                                 device=self.dev)
            px = self.local_x[None] \
                + (tiles % self.tiles_x).to(self.dtype)[:, None] * self.tile
            py = self.local_y[None] \
                + (tiles // self.tiles_x).to(self.dtype)[:, None] * self.tile
            gmax = int(self.counts_host[g0:g0 + len(tiles)].max())
            yield tiles, px, py, math.ceil(gmax / self.chunk)

    def chunk_ids(self, tiles, c):
        """(G, K) splat ids of chunk c, N (the zero row) out of range."""
        pos = c * self.chunk + self.j_chunk[None]
        in_rng = pos < self.counts[tiles][:, None]
        return torch.where(in_rng,
                           self.pairs[self.starts[tiles][:, None] + pos],
                           torch.full_like(pos, self.N))

    def init_state(self, G: int) -> PixelState:
        return _init_state(G, self.P, self.dev, self.dtype)

    def chunk_data(self, ids):
        return self.tab0[ids].permute(2, 0, 1)              # (22, G, K)



def composite(tab: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
              counts: torch.Tensor, bg: torch.Tensor, img_h: int, img_w: int,
              tile: int = 16, chunk: int = 256
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Composite every tile's depth-ordered list → ((N_OUT, H, W) buffer,
    counts per tile, (n_tiles,) int64: "steps", the list's splats up to
    and with the last one that some pixel of the tile entered at
    T > T_EPS; "blended", the (pixel, splat) pairs blended with a weight
    above zero)."""
    walk = _TileWalk(tab, pairs, starts, counts, img_h, img_w, tile, chunk)
    out = torch.empty((walk.n_tiles, walk.P, N_OUT), dtype=tab.dtype,
                      device=tab.device)
    steps = torch.zeros(walk.n_tiles, dtype=torch.long, device=tab.device)
    blended = torch.zeros_like(steps)
    bg = bg.to(tab.dtype)
    for tiles, px, py, n_chunks in walk.groups():
        state = walk.init_state(len(tiles))
        for c in range(n_chunks):
            live = (state.trans > T_EPS).any(dim=1)
            if not bool(live.any()):
                break
            # a slot is needed where some pixel enters it alive: T only
            # falls along the list, so it is the first slots of the chunk
            pos = c * chunk + walk.j_chunk[None]
            in_list = pos < walk.counts[tiles][:, None]
            state, w, t_in = composite_chunk(
                state, px, py, walk.chunk_data(walk.chunk_ids(tiles, c)),
                return_weights=True)
            steps[tiles] += ((t_in > T_EPS).any(dim=1) & in_list).sum(1)
            blended[tiles] += (w > 0).sum((1, 2))
        rgb = state.rgb + state.trans[..., None] * bg
        out[tiles] = torch.cat([
            rgb, state.alpha_acc[..., None], state.depth_exp[..., None],
            state.depth_med[..., None], state.dist[..., None],
            state.normal], dim=-1)
    return detile(out, img_h, img_w, tile), {"steps": steps,
                                              "blended": blended}


def detile(tiles: torch.Tensor, img_h: int, img_w: int, tile: int
           ) -> torch.Tensor:
    C = tiles.shape[-1]
    t = tiles.reshape(img_h // tile, img_w // tile, tile, tile, C)
    return t.permute(4, 0, 2, 1, 3).reshape(C, img_h, img_w)


def rasterize(gaussians: torch.Tensor, cam_view: torch.Tensor,
              cam_view_proj: torch.Tensor, bg: torch.Tensor, size: int,
              tile: int, max_per_tile: int, chunk: int
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One view → (maps, per-tile counts)."""
    sp = preprocess_splats(gaussians, cam_view, cam_view_proj, size, size)
    pairs, starts, counts = build_tile_pairs(sp, size, size, tile,
                                             max_per_tile)
    tab = pack_splat_render(sp).t().contiguous()
    buf, work = composite(tab, pairs, starts, counts, bg, size, size, tile,
                          chunk)
    return {k: buf[a:b] for k, a, b in OUT_CHANNELS}, work


def render_views(gaussians: torch.Tensor, cams: Dict[str, torch.Tensor],
                 size: int, tile: int, max_per_tile: int, chunk: int,
                 bg=(1.0, 1.0, 1.0)):
    """gaussians (N, 13), cams of V views → maps (V, C, H, W) by name as
    the renderer returns them, and the per-view counts (V, n_tiles) by
    name."""
    bgt = torch.tensor(bg, dtype=torch.float32, device=gaussians.device)
    views, steps = [], []
    for v in range(cams["cam_view"].shape[0]):
        cv = cams["cam_view"][v].float()
        out, st = rasterize(gaussians, cv, cams["cam_view_proj"][v], bgt,
                            size, tile, max_per_tile, chunk)
        nv = out["normal_view"]
        alpha = out["alpha"]
        depth_exp = out["depth_expected"] / torch.clamp(alpha, min=1e-10)
        views.append({
            "image": torch.clamp(out["image"], 0.0, 1.0),
            "alpha": alpha,
            "depth": out["depth_median"],
            "depth_expected": torch.where(alpha > 1e-6, depth_exp,
                                          torch.zeros_like(depth_exp)),
            "rend_normal": torch.stack([nv[0] * cv[j, 0] + nv[1] * cv[j, 1]
                                        + nv[2] * cv[j, 2]
                                        for j in range(3)]),
            "dist": out["dist"]})
        steps.append(st)
    return {k: torch.stack([o[k] for o in views]) for k in views[0]}, \
        {k: torch.stack([c[k] for c in steps]) for k in steps[0]}


# ---------------------------------------------------------------- cameras

ZNEAR_CAM, ZFAR_CAM = 0.01, 100.0


def look_at(cam_pos: np.ndarray) -> np.ndarray:
    """z-up look-at camera-to-world towards the origin (x right, y down,
    z forward)."""
    forward = -cam_pos / (np.linalg.norm(cam_pos) + 1e-8)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0], np.float32))
    right /= np.linalg.norm(right) + 1e-8
    up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, -up, forward, \
        cam_pos
    return c2w


def orbit_poses(views: int, radius: float = 1.8, fov_deg: float = 30.0,
                elevation: float = 0.0):
    """`views` cameras at one elevation, azimuths 0, 360/views, ...: the
    turntable (c2w (V, 4, 4) float32, the focal length over the width)."""
    c2w = []
    for a in np.linspace(0, 360, views, endpoint=False):
        e, a = math.radians(elevation), math.radians(a)
        pos = np.array([radius * math.cos(e) * math.cos(a),
                        radius * math.cos(e) * math.sin(a),
                        radius * math.sin(e)], dtype=np.float32)
        c2w.append(look_at(pos))
    return np.stack(c2w), 0.5 / math.tan(math.radians(fov_deg) / 2)


def cameras(c2w: np.ndarray, focal: float, device) -> Dict[str, torch.Tensor]:
    """Row-vector world-to-view and view-projection matrices (OpenGL
    projection, z mapped to [0, zfar / (zfar − znear)])."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    f = torch.full(c2w.shape[:-2], focal, dtype=torch.float32, device=device)
    tanfov = torch.tan(2 * torch.atan2(torch.ones_like(f), 2 * f) / 2)
    view = torch.linalg.inv(geom(c2w)).transpose(-1, -2)
    inv_tan, z, one = 1.0 / tanfov, torch.zeros_like(f), torch.ones_like(f)
    zz = one * (ZFAR_CAM / (ZFAR_CAM - ZNEAR_CAM))
    zw = one * (-(ZFAR_CAM * ZNEAR_CAM) / (ZFAR_CAM - ZNEAR_CAM))
    proj = torch.stack([torch.stack([inv_tan, z, z, z], -1),
                        torch.stack([z, inv_tan, z, z], -1),
                        torch.stack([z, z, zz, one], -1),
                        torch.stack([z, z, zw, z], -1)], -2)
    return {"cam_view": view,
            "cam_view_proj": torch.matmul(geom(view), geom(proj))}
