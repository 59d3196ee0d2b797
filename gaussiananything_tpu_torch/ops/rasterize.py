"""2DGS surfel rasterizer: projection, tile binning, packing and the plain
compositor (port of `gaussiananything_tpu/ops/rasterize.py`).

Each surfel is an oriented disk; a pixel ray meets the disk plane at (u, v)
in the disk frame, which gives the Gaussian response; splats composite front
to back in depth order (Huang et al. 2024, `nsr/gs_surfel.py:85-142`).

The forward frame pipeline of one view:

  preprocess_splats → build_tile_pairs → pack_splat_render/splat_table →
  composite (plain version here; the CUDA kernel K1 in `rasterize_cuda.py`)

`composite_plain` computes exactly what K1 computes, with the expression
order of the JAX package's `composite_chunk_grouped` (`rasterize.py:360`):
an independently ordered expression differs in the last ulp, which flips
the discrete `alpha >= ALPHA_EPS` keep decision and shows up as 1/255
speckle. It is the reference the CPU tests hold against JAX and that
`chip_smoke.py` holds the kernel against; nothing on the card's main path
calls it.

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


def _init_state(G: int, P: int, device) -> PixelState:
    z = torch.zeros((G, P), dtype=torch.float32, device=device)
    return PixelState(rgb=torch.zeros((G, P, 3), device=device),
                      trans=torch.ones((G, P), device=device),
                      alpha_acc=z, depth_exp=z, depth_med=z,
                      normal=torch.zeros((G, P, 3), device=device),
                      dist=z, dist_d=z, dist_d2=z)


def _mapped_depth(z: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(z, min=ZNEAR)
    return (ZFAR * (z - ZNEAR)) / (z * (ZFAR - ZNEAR))


def composite_chunk(state: PixelState, px: torch.Tensor, py: torch.Tensor,
                    data: torch.Tensor) -> PixelState:
    """Composite one depth-sorted chunk for G tiles × P pixels
    (`composite_chunk_grouped`, `rasterize.py:360`, expression for
    expression). px, py: (G, P); data: (PACKED_F, G, K)."""
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
    return PixelState(
        rgb=state.rgb + acc[..., 0:3], trans=trans_out,
        alpha_acc=state.alpha_acc + s_w, depth_exp=depth_exp,
        depth_med=depth_med, normal=state.normal + acc[..., 3:6],
        dist=dist, dist_d=state.dist_d + s_wm,
        dist_d2=state.dist_d2 + s_wm2)


def composite_plain(tab: torch.Tensor, pairs: torch.Tensor,
                    starts: torch.Tensor, counts: torch.Tensor,
                    bg: torch.Tensor, img_h: int, img_w: int,
                    tile: int = 16, chunk: int = 256) -> torch.Tensor:
    """The function K1 computes, in PyTorch: composite every tile's
    depth-ordered pair segment and return the (N_OUT, img_h, img_w) buffer
    (channels in `OUT_CHANNELS`, image blended over `bg`).

    tab: (N, TABLE_W) `splat_table`; pairs/starts/counts from
    `build_tile_pairs`. Tiles run in groups of `_TILE_GROUP` (a memory bound
    only: every chunk a saturated tile skips contributes exactly zero).
    """
    dev = tab.device
    tiles_x, tiles_y = img_w // tile, img_h // tile
    n_tiles, P = tiles_x * tiles_y, tile * tile
    N = tab.shape[0]
    # zero dummy row: masked slots read opacity 0 ⇒ alpha 0, factor 1.0
    tab0 = torch.cat([tab[:, :PACKED_F].float(),
                      tab.new_zeros((1, PACKED_F))])
    pairs = pairs.long()
    starts = starts.long()
    counts = counts.long()
    lidx = torch.arange(P, device=dev)
    local_x = (lidx % tile).float()
    local_y = (lidx // tile).float()
    j_chunk = torch.arange(chunk, device=dev)
    out = torch.empty((n_tiles, P, N_OUT), dtype=torch.float32, device=dev)
    counts_host = counts.cpu()
    for g0 in range(0, n_tiles, _TILE_GROUP):
        tiles = torch.arange(g0, min(g0 + _TILE_GROUP, n_tiles), device=dev)
        st, ct = starts[tiles], counts[tiles]
        px = local_x[None] + (tiles % tiles_x).float()[:, None] * tile
        py = local_y[None] + (tiles // tiles_x).float()[:, None] * tile
        state = _init_state(len(tiles), P, dev)
        gmax = int(counts_host[g0:g0 + len(tiles)].max())
        for c in range(math.ceil(gmax / chunk)):
            live = (state.trans > T_EPS).any(dim=1)
            if not bool(live.any()):
                break
            pos = c * chunk + j_chunk[None]
            in_rng = pos < ct[:, None]
            ids = torch.where(in_rng, pairs[st[:, None] + pos],
                              torch.full_like(pos, N))
            data = tab0[ids].permute(2, 0, 1)               # (22, G, K)
            state = composite_chunk(state, px, py, data)
        rgb = state.rgb + state.trans[..., None] * bg.float()
        out[g0:g0 + len(tiles)] = torch.cat([
            rgb, state.alpha_acc[..., None], state.depth_exp[..., None],
            state.depth_med[..., None], state.dist[..., None],
            state.normal], dim=-1)
    out = out.reshape(tiles_y, tiles_x, tile, tile, N_OUT)
    return out.permute(4, 0, 2, 1, 3).reshape(N_OUT, img_h, img_w)


def split_outputs(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(N_OUT, H, W) composite buffer → channel-first maps by name."""
    return {k: buf[a:b] for k, a, b in OUT_CHANNELS}


def rasterize_tiled(gaussians: torch.Tensor, cam_view: torch.Tensor,
                    cam_view_proj: torch.Tensor, bg: torch.Tensor,
                    img_h: int, img_w: int, tile: int = 16,
                    max_per_tile: int = 2048, chunk: int = 256,
                    impl: str = "cuda_nograd"
                    ) -> Dict[str, torch.Tensor]:
    """One view, N splats → channel-first maps (image (3,H,W), alpha,
    depth_expected, depth_median, dist (1,H,W), normal_view (3,H,W)).

    impl: "cuda_nograd" = the K1 wrapper (`rasterize_cuda.composite`),
    which launches K1 for CUDA tensors and computes `composite_plain` for
    CPU tensors; "plain" = `composite_plain` on any device, the reference
    the kernel is checked against. Forward only: gradients through the
    render arrive with the training kernels.
    """
    if img_h % tile or img_w % tile:
        raise ValueError(f"image {img_h}x{img_w} is not a multiple of the "
                         f"tile {tile}")
    if max_per_tile % chunk:
        raise ValueError("max_per_tile must be a multiple of chunk")
    sp = preprocess_splats(gaussians, cam_view, cam_view_proj, img_h, img_w)
    pairs, starts, counts = build_tile_pairs(sp, img_h, img_w, tile,
                                             max_per_tile)
    tab = splat_table(pack_splat_render(sp))
    if impl == "cuda_nograd":
        from gaussiananything_tpu_torch.ops import rasterize_cuda
        buf = rasterize_cuda.composite(tab, pairs, starts, counts, bg,
                                       img_h, img_w, tile=tile, chunk=chunk)
    elif impl == "plain":
        buf = composite_plain(tab, pairs, starts, counts, bg, img_h, img_w,
                              tile=tile, chunk=chunk)
    else:
        raise ValueError(f"unknown rasterizer impl {impl!r}")
    return split_outputs(buf)
