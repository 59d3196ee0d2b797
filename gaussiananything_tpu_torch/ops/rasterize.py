"""2DGS surfel rasterizer: projection, tile binning, packing and the plain
compositor (port of `gaussiananything_tpu/ops/rasterize.py`).

Each surfel is an oriented disk; a pixel ray meets the disk plane at (u, v)
in the disk frame, which gives the Gaussian response; splats composite front
to back in depth order (Huang et al. 2024, `nsr/gs_surfel.py:85-142`).

The forward frame pipeline of one view:

  preprocess_splats → build_tile_pairs → pack_splat_render/splat_table →
  composite (plain versions here; the CUDA kernels K1, K2a and K2b in
  `rasterize_cuda.py`)

`composite_plain` computes exactly what K1 and K2a compute, with the
expression order of the JAX package's `composite_chunk_grouped`
(`rasterize.py:360`): an independently ordered expression differs in the
last ulp, which flips the discrete `alpha >= ALPHA_EPS` keep decision and
shows up as 1/255 speckle. `composite_plain_backward` is the function K2b
computes: the reverse walk of `_composite_frame_bwd` (`rasterize.py:996`)
with the analytic chunk adjoints of `chunk_backward`. They are the
references the CPU tests hold against JAX and that `chip_smoke.py` holds
the kernels against; nothing on the card's main path calls them.

Output channels of the (10, H, W) composite buffer (`OUT_CHANNELS`):
image (3, rgb blended over bg), alpha, depth_expected (premultiplied by
alpha), depth_median, dist (depth distortion), normal_view (3, view space,
alpha-weighted and unnormalised).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from gaussiananything_tpu_torch.ops.gaussians import unpack_gaussians
from gaussiananything_tpu_torch.utils.quaternions import normalize

# Constants of `gaussiananything_tpu/ops/rasterize.py:44-65` (see there for
# the reasoning behind each).
FILTER_INV_SQUARE = 2.0
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR_CULL = 0.2
RHO_CUT = 9.0
RHO_RAMP = 1.0
ZNEAR, ZFAR = 0.01, 100.0

PACKED_F = 22       # rows of the packed table, layout below
TABLE_W = 24        # splat-major row width: 22 fields padded to 6 float4
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


def splat_table(packed: torch.Tensor) -> torch.Tensor:
    """(PACKED_F, N) → splat-major (N, TABLE_W) table, each row padded to
    96 bytes so the kernel reads a splat as six aligned float4 loads."""
    tab = packed.new_zeros((packed.shape[1], TABLE_W))
    tab[:, :PACKED_F] = packed.t()
    return tab


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
    acc = torch.bmm(w, feats)                               # (G, P, 7)
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
    return (out, w) if return_weights else out


def chunk_backward(state: PixelState, px: torch.Tensor, py: torch.Tensor,
                   data: torch.Tensor, ct: PixelState
                   ) -> Tuple[PixelState, torch.Tensor]:
    """Analytic VJP of `composite_chunk` with respect to (state, data)
    (`_chunk_backward`, `rasterize.py:475`, expression for expression).

    `ct` holds the cotangents of the output state. The per-splat forward
    quantities are recomputed from the chunk's entry state with the
    forward's expression order, then the adjoints are applied; gates
    (`where`, comparisons) route cotangents to the selected branch.
    Returns (cotangent of the entry state, cotangent of data (22, G, K)).
    """
    a0, a1, a2 = data[0][:, None], data[1][:, None], data[2][:, None]
    b0, b1, b2 = data[3][:, None], data[4][:, None], data[5][:, None]
    c0, c1, c2 = data[6][:, None], data[7][:, None], data[8][:, None]
    tz0b, tz1b, tz2b = data[9][:, None], data[10][:, None], data[11][:, None]
    tz0, tz1, tz2 = data[9], data[10], data[11]             # (G, K)
    cx, cy = data[12][:, None], data[13][:, None]
    cz, op = data[14][:, None], data[15][:, None]

    # ---- recompute (the forward's expressions) ----------------------------
    pxe = px[..., None]
    pye = py[..., None]
    p0 = pxe * a0 + pye * b0 + c0
    p1 = pxe * a1 + pye * b1 + c1
    p2 = pxe * a2 + pye * b2 + c2
    tiny = p2.abs() < 1e-9
    safe = torch.where(tiny, torch.full_like(p2, 1e-9), p2)
    inv = 1.0 / safe
    u = p0 * inv
    v = p1 * inv
    rho3d = u * u + v * v
    dx = pxe - cx
    dy = pye - cy
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(use3d, u * tz0b + v * tz1b + tz2b, cz.expand_as(u))
    expw = torch.exp(-0.5 * rho)
    win = _rho_window(rho)
    g = expw * win
    og = op * g
    alpha_raw = torch.clamp(og, max=ALPHA_MAX)
    keep = (alpha_raw >= ALPHA_EPS) & (depth > NEAR_CULL)
    zero = torch.zeros_like(og)
    alpha = torch.where(keep, alpha_raw, zero)
    depth = torch.where(keep, depth, zero)
    t_incl = torch.cumprod(1.0 - alpha, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]),
                        t_incl[..., :-1]], dim=-1)
    tau = state.trans[..., None]
    t_in = tau * t_excl
    below = t_in <= T_EPS
    w = torch.where(below, zero, tau * alpha * t_excl)
    t_after = tau * t_incl
    crossed = (t_in > 0.5) & (t_after <= 0.5)
    m = _mapped_depth(depth)
    wm = w * m
    s_w = w.sum(-1)
    s_wm = wm.sum(-1)
    s_wm2 = (wm * m).sum(-1)

    # ---- state-in cotangents ----------------------------------------------
    ct_A = ct.alpha_acc + ct.dist * s_wm2
    ct_Dw = ct.dist_d - 2.0 * ct.dist * s_wm
    ct_Dw2 = ct.dist_d2 + ct.dist * s_w
    # chunk-sum cotangents (the dist cross terms use the ENTRY accumulators)
    ct_s_w = ct.alpha_acc + ct.dist * (state.dist_d2 + s_wm2)
    ct_s_wm = ct.dist_d - 2.0 * ct.dist * (state.dist_d + s_wm)
    ct_s_wm2 = ct.dist_d2 + ct.dist * (state.alpha_acc + s_w)

    # ---- per-(pixel, splat) weight cotangent ------------------------------
    feats6 = torch.stack([data[16], data[17], data[18],
                          data[19], data[20], data[21]], dim=-1)  # (G, K, 6)
    ct_acc6 = torch.cat([ct.rgb, ct.normal], dim=-1)              # (G, P, 6)
    cw = torch.bmm(ct_acc6, feats6.transpose(1, 2))               # (G, P, K)
    cw = cw + ct_s_w[..., None] \
        + ct.depth_exp[..., None] * depth \
        + ct_s_wm[..., None] * m + ct_s_wm2[..., None] * (m * m)
    cw = torch.where(below, zero, cw)

    # ---- alpha / transmittance chain --------------------------------------
    # w_j = τ α_j t_excl_j with t_excl_j = Π_{i<j}(1−α_i):
    #   ∂w_k/∂α_k = τ t_excl_k,   ∂w_j/∂α_k = −w_j/(1−α_k) for j>k,
    #   ∂τ'/∂α_k = −τ'/(1−α_k)  (τ' = τ·t_incl_K).
    q = cw * w
    incl = torch.cumsum(q, dim=-1)
    suffix = incl[..., -1:] - incl                                # Σ_{j>k}
    trans_raw = state.trans * t_incl[..., -1]
    # no cotangent flows through a transmittance flushed to zero
    flushed = trans_raw <= T_EPS
    zero_p = torch.zeros_like(trans_raw)
    ct_trans_out = torch.where(flushed, zero_p, ct.trans)
    trans_out = torch.where(flushed, zero_p, trans_raw)
    bracket = suffix + (ct_trans_out * trans_out)[..., None]
    ct_alpha = cw * tau * t_excl - bracket / (1.0 - alpha)
    ct_trans = (cw * alpha * t_excl).sum(-1) + ct_trans_out * t_incl[..., -1]

    # ---- depth / mapped-depth chain ---------------------------------------
    ct_m = ct_s_wm[..., None] * w + ct_s_wm2[..., None] * (2.0 * w * m)
    zc = torch.clamp(depth, min=ZNEAR)
    dm_dz = torch.where(depth >= ZNEAR,
                        (ZFAR * ZNEAR / (ZFAR - ZNEAR)) / (zc * zc), zero)
    ct_depth = ct.depth_exp[..., None] * w \
        + ct.depth_med[..., None] * crossed + ct_m * dm_dz
    ct_depth = torch.where(keep, ct_depth, zero)
    k3 = keep & use3d
    ct_depth3 = torch.where(k3, ct_depth, zero)
    # the adjoint treats depth as (p0·tz0 + p1·tz1 + p2·tz2)·inv, equal to
    # the forward's u·tz0 + v·tz1 + tz2 up to rounding, so the depth chain
    # joins the coefficient product below as a fourth numerator column
    ct_num = ct_depth3 * inv
    ct_cz = torch.where(keep & ~use3d, ct_depth, zero).sum(1)

    # ---- opacity / gaussian-weight chain ----------------------------------
    ct_og = torch.where(keep & (og < ALPHA_MAX), ct_alpha, zero)
    ct_op = (ct_og * g).sum(1)
    ct_g = ct_og * op
    ramp = RHO_CUT - rho
    dwin = torch.where((ramp > 0.0) & (ramp < RHO_RAMP),
                       torch.full_like(ramp, -1.0 / RHO_RAMP), zero)
    ct_rho = ct_g * (expw * dwin - 0.5 * expw * win)
    ct_rho3d = torch.where(use3d, ct_rho, zero)
    ct_rho2d = torch.where(use3d, zero, ct_rho)
    ct_u = 2.0 * u * ct_rho3d
    ct_v = 2.0 * v * ct_rho3d
    ct_dx = ct_rho2d * FILTER_INV_SQUARE * 2.0 * dx
    ct_dy = ct_rho2d * FILTER_INV_SQUARE * 2.0 * dy
    ct_cx = -ct_dx.sum(1)
    ct_cy = -ct_dy.sum(1)

    # ---- projective ray-plane chain ---------------------------------------
    ct_p0 = ct_u * inv
    ct_p1 = ct_v * inv
    ct_inv = ct_u * p0 + ct_v * p1 + ct_depth3 * (depth * safe)
    ct_safe = -(inv * inv) * ct_inv
    ct_p2 = torch.where(tiny, zero, ct_safe)

    # coefficient adjoints: one product over the pixel basis [px, py, 1],
    # columns o = [p0, p1, p2, depth numerator]
    G, P, K = u.shape
    basis = torch.stack([px, py, torch.ones_like(px)], dim=1)     # (G, 3, P)
    ct_lin = torch.stack([ct_p0, ct_p1, ct_p2, ct_num], dim=2)    # (G,P,4,K)
    ct_coef = torch.bmm(basis, ct_lin.reshape(G, P, 4 * K)
                        ).reshape(G, 3, 4, K)
    ct_tza, ct_tzb, ct_tzc = ct_coef[:, 0, 3], ct_coef[:, 1, 3], \
        ct_coef[:, 2, 3]
    ca = [ct_coef[:, 0, i] + ct_tza * tz for i, tz in enumerate((tz0, tz1,
                                                                 tz2))]
    cb = [ct_coef[:, 1, i] + ct_tzb * tz for i, tz in enumerate((tz0, tz1,
                                                                 tz2))]
    cc = [ct_coef[:, 2, i] + ct_tzc * tz for i, tz in enumerate((tz0, tz1,
                                                                 tz2))]
    ct_tz = [ct_tza * data[i] + ct_tzb * data[3 + i] + ct_tzc * data[6 + i]
             for i in range(3)]
    ct_feats = torch.bmm(w.transpose(1, 2), ct_acc6)              # (G, K, 6)

    ct_data = torch.stack([*ca, *cb, *cc, *ct_tz, ct_cx, ct_cy, ct_cz, ct_op,
                           *ct_feats.unbind(-1)], dim=0)          # (22, G, K)
    ct_state = PixelState(
        rgb=ct.rgb, trans=ct_trans, alpha_acc=ct_A, depth_exp=ct.depth_exp,
        depth_med=ct.depth_med, normal=ct.normal, dist=ct.dist,
        dist_d=ct_Dw, dist_d2=ct_Dw2)
    return ct_state, ct_data


def chunk_offsets(counts: torch.Tensor, chunk: int) -> torch.Tensor:
    """(n_tiles + 1,) int32 exclusive cumsum of ceil(counts / chunk): tile
    t's chunk c keeps its entry state at row `offsets[t] + c` of the
    entries buffer; `offsets[-1]` is the buffer's length."""
    n = (counts.long() + (chunk - 1)) // chunk
    return torch.cat([n.new_zeros(1), torch.cumsum(n, 0)]).int()


class _TileWalk:
    """What the plain forward and backward share for a frame: the zero-row
    padded table, pixel coordinates, and the tiles in groups of
    `_TILE_GROUP` (a memory bound only: every chunk a saturated tile skips
    contributes exactly zero, to outputs and to gradients). The walk runs
    in the table's dtype: float32 is what the kernels compute; a float64
    table makes the same functions their own higher-precision witness."""

    def __init__(self, tab, pairs, starts, counts, img_h, img_w, tile,
                 chunk):
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
        self.local_y = (lidx // tile).to(self.dtype)
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


def composite_plain(tab: torch.Tensor, pairs: torch.Tensor,
                    starts: torch.Tensor, counts: torch.Tensor,
                    bg: torch.Tensor, img_h: int, img_w: int,
                    tile: int = 16, chunk: int = 256,
                    return_entries: bool = False):
    """The function K1 computes, in PyTorch: composite every tile's
    depth-ordered pair segment and return the (N_OUT, img_h, img_w) buffer
    (channels in `OUT_CHANNELS`, image blended over `bg`).

    tab: (N, TABLE_W) `splat_table`; pairs/starts/counts from
    `build_tile_pairs`.

    return_entries: also return what K2a adds to K1, `(entries, n_exec)`:
    entries (`chunk_offsets(counts, chunk)[-1]`, 4, tile²) holds, for every
    chunk a tile executes, each pixel's state on entry (T, Σw, Σw·m,
    Σw·m²), zero elsewhere; n_exec (n_tiles,) int32 counts the chunks each
    tile executes before all its pixels are at T <= T_EPS.
    """
    dev = tab.device
    walk = _TileWalk(tab, pairs, starts, counts, img_h, img_w, tile, chunk)
    n_tiles, P, tiles_x, tiles_y = walk.n_tiles, walk.P, walk.tiles_x, \
        walk.tiles_y
    out = torch.empty((n_tiles, P, N_OUT), dtype=tab.dtype, device=dev)
    bg = bg.to(tab.dtype)
    if return_entries:
        offs = chunk_offsets(counts, chunk).long()
        entries = torch.zeros((int(offs[-1]), 4, P), dtype=tab.dtype,
                              device=dev)
        n_exec = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    for tiles, px, py, n_chunks in walk.groups():
        state = walk.init_state(len(tiles))
        for c in range(n_chunks):
            live = (state.trans > T_EPS).any(dim=1)
            if not bool(live.any()):
                break
            if return_entries:
                ran = live & (c * chunk < walk.counts[tiles])
                entries[offs[tiles][ran] + c] = torch.stack(
                    [state.trans, state.alpha_acc, state.dist_d,
                     state.dist_d2], dim=1)[ran]
                n_exec[tiles] += ran.int()
            state = composite_chunk(
                state, px, py, walk.chunk_data(walk.chunk_ids(tiles, c)))
        rgb = state.rgb + state.trans[..., None] * bg
        out[tiles] = torch.cat([
            rgb, state.alpha_acc[..., None], state.depth_exp[..., None],
            state.depth_med[..., None], state.dist[..., None],
            state.normal], dim=-1)
    out = out.reshape(tiles_y, tiles_x, tile, tile, N_OUT)
    buf = out.permute(4, 0, 2, 1, 3).reshape(N_OUT, img_h, img_w)
    return (buf, entries, n_exec) if return_entries else buf


def active_steps(tab: torch.Tensor, pairs: torch.Tensor,
                 starts: torch.Tensor, counts: torch.Tensor, img_h: int,
                 img_w: int, tile: int = 16, chunk: int = 128) -> int:
    """How many (pixel, pair) steps of a frame blend with a weight above
    zero: the pair is kept (alpha >= ALPHA_EPS, depth > NEAR_CULL) and the
    pixel is entered at T > T_EPS. Only these carry a cotangent in the
    backward, so their number sets its least work."""
    walk = _TileWalk(tab, pairs, starts, counts, img_h, img_w, tile, chunk)
    n = 0
    for tiles, px, py, n_chunks in walk.groups():
        state = walk.init_state(len(tiles))
        for c in range(n_chunks):
            if not bool((state.trans > T_EPS).any()):
                break
            state, w = composite_chunk(
                state, px, py, walk.chunk_data(walk.chunk_ids(tiles, c)),
                return_weights=True)
            n += int((w > 0).sum())
    return n


def composite_plain_backward(tab: torch.Tensor, pairs: torch.Tensor,
                             starts: torch.Tensor, counts: torch.Tensor,
                             bg: torch.Tensor, ct_buf: torch.Tensor,
                             img_h: int, img_w: int, tile: int = 16,
                             chunk: int = 128) -> torch.Tensor:
    """The function K2b computes, in PyTorch: the cotangent of `tab`
    (N, TABLE_W) given the cotangent `ct_buf` (N_OUT, img_h, img_w) of
    `composite_plain`'s buffer.

    The reverse walk of `_composite_frame_bwd` (`rasterize.py:996`) over the
    pair lists: each tile group runs forward keeping every chunk's entry
    state, then walks its executed chunks back through `chunk_backward`,
    adding each chunk's per-slot cotangents into the splat rows. The image
    is blended over `bg` inside the buffer, so the final transmittance
    receives Σ_c ct_image_c · bg_c.
    """
    dev = tab.device
    walk = _TileWalk(tab, pairs, starts, counts, img_h, img_w, tile, chunk)
    P = walk.P
    bg = bg.to(tab.dtype)
    ct = ct_buf.to(tab.dtype).reshape(N_OUT, walk.tiles_y, tile,
                                      walk.tiles_x, tile)
    ct = ct.permute(1, 3, 2, 4, 0).reshape(walk.n_tiles, P, N_OUT)
    d_tab0 = torch.zeros((walk.N + 1, PACKED_F), dtype=tab.dtype,
                         device=dev)
    for tiles, px, py, n_chunks in walk.groups():
        G = len(tiles)
        state = walk.init_state(G)
        steps = []
        for c in range(n_chunks):
            if not bool((state.trans > T_EPS).any()):
                break
            ids = walk.chunk_ids(tiles, c)
            steps.append((state, ids))
            state = composite_chunk(state, px, py, walk.chunk_data(ids))
        c_g = ct[tiles]
        z = torch.zeros((G, P), dtype=tab.dtype, device=dev)
        ct_state = PixelState(
            rgb=c_g[..., 0:3], trans=(c_g[..., 0:3] * bg).sum(-1),
            alpha_acc=c_g[..., 3], depth_exp=c_g[..., 4],
            depth_med=c_g[..., 5], normal=c_g[..., 7:10], dist=c_g[..., 6],
            dist_d=z, dist_d2=z)
        for s_in, ids in reversed(steps):
            ct_state, ct_d = chunk_backward(s_in, px, py,
                                            walk.chunk_data(ids), ct_state)
            # out-of-range slots land on the dummy row N, dropped below
            d_tab0.index_add_(0, ids.reshape(-1),
                              ct_d.reshape(PACKED_F, -1).t())
    d_tab = torch.zeros_like(tab)
    d_tab[:, :PACKED_F] = d_tab0[:walk.N]
    return d_tab


class _CompositePlainTrain(torch.autograd.Function):
    """`composite_plain` with `composite_plain_backward` as its gradient:
    the analytic adjoints the backward kernel implements, on any device."""

    @staticmethod
    def forward(ctx, tab, pairs, starts, counts, bg, img_h, img_w, tile,
                chunk):
        ctx.save_for_backward(tab, pairs, starts, counts, bg)
        ctx.frame = (img_h, img_w, tile, chunk)
        return composite_plain(tab, pairs, starts, counts, bg, img_h, img_w,
                               tile=tile, chunk=chunk)

    @staticmethod
    def backward(ctx, ct_buf):
        img_h, img_w, tile, chunk = ctx.frame
        d_tab = composite_plain_backward(*ctx.saved_tensors, ct_buf, img_h,
                                         img_w, tile=tile, chunk=chunk)
        return (d_tab,) + (None,) * 8


def composite_plain_train(tab: torch.Tensor, pairs: torch.Tensor,
                          starts: torch.Tensor, counts: torch.Tensor,
                          bg: torch.Tensor, img_h: int, img_w: int,
                          tile: int = 16, chunk: int = 128) -> torch.Tensor:
    """The plain version of the training pair K2a + K2b: `composite_plain`,
    differentiable in `tab` through `composite_plain_backward`."""
    return _CompositePlainTrain.apply(tab, pairs, starts, counts, bg, img_h,
                                      img_w, tile, chunk)


def rasterize_naive(gaussians: torch.Tensor, cam_view: torch.Tensor,
                    cam_view_proj: torch.Tensor, bg: torch.Tensor,
                    img_h: int, img_w: int, chunk: int = 256,
                    pixel_block: int = 8192) -> Dict[str, torch.Tensor]:
    """The per-pixel oracle: every splat against every pixel
    (`rasterize.py:242`). O(N·H·W), for tests and small scenes: no binning,
    no footprint clamp, no per-tile cap, only the compositing semantics,
    through the same `composite_chunk` so alpha and depth are bit-identical
    per (pixel, splat) to the tiled path. Returns the maps of
    `rasterize_tiled`.
    """
    sp = preprocess_splats(gaussians, cam_view, cam_view_proj, img_h, img_w)
    key = torch.where(sp.valid, sp.center_z,
                      torch.full_like(sp.center_z, float("inf")))
    order = torch.sort(key, stable=True).indices
    packed = pack_splat_render(SplatProj(*(a[order] for a in sp)))
    N = packed.shape[1]
    pad = (-N) % chunk
    if pad:     # zero columns: opacity 0, no contribution
        packed = torch.cat([packed, packed.new_zeros((PACKED_F, pad))], 1)
    dev = packed.device
    ys, xs = torch.meshgrid(
        torch.arange(img_h, dtype=torch.float32, device=dev),
        torch.arange(img_w, dtype=torch.float32, device=dev), indexing="ij")
    px_all, py_all = xs.reshape(-1), ys.reshape(-1)
    blocks = []
    for p0 in range(0, img_h * img_w, pixel_block):
        px = px_all[None, p0:p0 + pixel_block]
        py = py_all[None, p0:p0 + pixel_block]
        state = _init_state(1, px.shape[1], dev)
        for c0 in range(0, packed.shape[1], chunk):
            state = composite_chunk(state, px, py,
                                    packed[:, None, c0:c0 + chunk])
        rgb = state.rgb + state.trans[..., None] * bg.float()
        blocks.append(torch.cat([
            rgb, state.alpha_acc[..., None], state.depth_exp[..., None],
            state.depth_med[..., None], state.dist[..., None],
            state.normal], dim=-1)[0])
    buf = torch.cat(blocks).t().reshape(N_OUT, img_h, img_w)
    return split_outputs(buf)


def split_outputs(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(N_OUT, H, W) composite buffer → channel-first maps by name."""
    return {k: buf[a:b] for k, a, b in OUT_CHANNELS}


def rasterize_tiled(gaussians: torch.Tensor, cam_view: torch.Tensor,
                    cam_view_proj: torch.Tensor, bg: torch.Tensor,
                    img_h: int, img_w: int, tile: int = 16,
                    max_per_tile: int = 2048, chunk: int = 256,
                    impl: str = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """One view, N splats → channel-first maps (image (3,H,W), alpha,
    depth_expected, depth_median, dist (1,H,W), normal_view (3,H,W)).

    impl:
      * "cuda" — the kernels' wrappers. Where autograd will ask for a
        gradient (grad mode on and the splat table requires one) this is
        `rasterize_cuda.composite_train`: K2a forward and K2b backward
        for CUDA tensors, the plain pair (`composite_plain` /
        `composite_plain_backward`) for CPU tensors. Otherwise it is the
        forward-only `rasterize_cuda.composite`: K1 for CUDA tensors,
        `composite_plain` for CPU tensors. Projection and packing stay
        plain PyTorch under autograd; binning reads the projected splats
        detached.
      * "plain" — the plain pair on any device (`composite_plain_train`):
        the reference the kernels are checked against.
    """
    if img_h % tile or img_w % tile:
        raise ValueError(f"image {img_h}x{img_w} is not a multiple of the "
                         f"tile {tile}")
    if max_per_tile % chunk:
        raise ValueError("max_per_tile must be a multiple of chunk")
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown rasterizer impl {impl!r}")
    sp = preprocess_splats(gaussians, cam_view, cam_view_proj, img_h, img_w)
    with torch.no_grad():
        pairs, starts, counts = build_tile_pairs(sp, img_h, img_w, tile,
                                                 max_per_tile)
    tab = splat_table(pack_splat_render(sp))
    if impl == "plain":
        buf = composite_plain_train(tab, pairs, starts, counts, bg, img_h,
                                    img_w, tile=tile, chunk=chunk)
    else:
        from gaussiananything_tpu_torch.ops import rasterize_cuda
        wants_grad = torch.is_grad_enabled() and tab.requires_grad
        fn = rasterize_cuda.composite_train if wants_grad \
            else rasterize_cuda.composite
        buf = fn(tab, pairs, starts, counts, bg, img_h, img_w, tile=tile,
                 chunk=chunk)
    return split_outputs(buf)
