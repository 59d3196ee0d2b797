"""2DGS surfel rasterizer: projection, tile binning, packing and the plain
compositor (port of `gaussiananything_tpu/ops/rasterize.py`).

Each surfel is an oriented disk; a pixel ray meets the disk plane at (u, v)
in the disk frame, which gives the Gaussian response; splats composite front
to back in depth order (Huang et al. 2024, `nsr/gs_surfel.py:85-142`).

The forward frame pipeline of one view:

  preprocess_splats → build_tile_pairs → splat_table (pack_splat_render,
  pixel_box) →
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
# the kernels' warps: each an 8 x 4 pixel rectangle of its 16 x 16 tile
# (`csrc/composite_v4.cuh`), which their marks and warp cull are per
WARP_W, WARP_H = 8, 4
MARK_WORDS = 4      # 32-slot mark words per warp and chunk (chunk <= 128)


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


def splat_table(sp: SplatProj, img_h: int, img_w: int) -> torch.Tensor:
    """SplatProj → splat-major (N, TABLE_W) table: the PACKED_F fields of
    `pack_splat_render` (differentiable), padded to 96 bytes so a kernel
    reads a splat as six aligned float4 loads, with the splat's pixel box
    (`pixel_box`, no gradient) in the two padding columns: the kernels' warp
    cull (`csrc/composite_v4.cuh`)."""
    packed = pack_splat_render(sp)
    tab = packed.new_zeros((packed.shape[1], TABLE_W))
    tab[:, :PACKED_F] = packed.t()
    tab[:, PACKED_F:] = pixel_box(sp.bb_min, sp.bb_max, img_h, img_w)
    return tab


def pixel_box(bb_min: torch.Tensor, bb_max: torch.Tensor, img_h: int,
              img_w: int) -> torch.Tensor:
    """(N, 2) float32 columns whose bits hold each splat's pixel box:
    x0 | x1 << 16 and y0 | y1 << 16 (int32), where [x0, x1] × [y0, y1] =
    [floor(bb_min), ceil(bb_max)] clamped to the image's pixels. Pixel
    centres lie on integers, so every pixel of the screen box
    (`preprocess_splats`) is inside. An invalid splat's bound may be
    infinite or NaN (its opacity in the table is 0, so no walk keeps it):
    ±inf clamps to the edges, NaN to 0."""
    with torch.no_grad():
        def _int(v, n, rnd):
            v = torch.nan_to_num(rnd(v.float()), nan=0.0, posinf=n,
                                 neginf=-1.0)
            return torch.clamp(v, 0, n - 1).int()
        x0 = _int(bb_min[:, 0], img_w, torch.floor)
        x1 = _int(bb_max[:, 0], img_w, torch.ceil)
        y0 = _int(bb_min[:, 1], img_h, torch.floor)
        y1 = _int(bb_max[:, 1], img_h, torch.ceil)
        bits = torch.stack([x0 | (x1 << 16), y0 | (y1 << 16)], dim=-1)
        return bits.contiguous().view(torch.float32)


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


def max_entry_rows(n_pairs: int, n_tiles: int, chunk: int) -> int:
    """A bound on `chunk_offsets(counts, chunk)[-1]` from shapes alone:
    Σ ceil(c_t / chunk) <= Σ c_t / chunk + n_tiles, and the counts sum to
    at most the pair list's length `n_pairs`. K2a sizes its entries buffer
    with it, so the host never waits for the counts."""
    return n_pairs // chunk + n_tiles


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


def composite_plain(tab: torch.Tensor, pairs: torch.Tensor,
                    starts: torch.Tensor, counts: torch.Tensor,
                    bg: torch.Tensor, img_h: int, img_w: int,
                    tile: int = 16, chunk: int = 256,
                    return_entries: bool = False, row0: int = 0):
    """The function K1 computes, in PyTorch: composite every tile's
    depth-ordered pair segment and return the (N_OUT, img_h, img_w) buffer
    (channels in `OUT_CHANNELS`, image blended over `bg`).

    tab: (N, TABLE_W) `splat_table`; pairs/starts/counts from
    `build_tile_pairs`; row0: the image row of the buffer's first row, for
    a band of a taller image.

    return_entries: also return what K2a adds to K1, `(entries, n_exec,
    marks)`: entries (`chunk_offsets(counts, chunk)[-1]`, 4, tile²) holds,
    for every chunk a tile executes, each pixel's state on entry (T, Σw,
    Σw·m, Σw·m²), zero elsewhere; n_exec (n_tiles,) int32 counts the chunks
    each tile executes before all its pixels are at T <= T_EPS; marks
    (rows, tile² / 32, MARK_WORDS) int32 holds, for every executed chunk
    and warp (`warp_marks`), bit k % 32 of word k / 32 set where some pixel
    of the warp blends slot k with a weight above zero, zero elsewhere.
    """
    dev = tab.device
    walk = _TileWalk(tab, pairs, starts, counts, img_h, img_w, tile, chunk,
                     row0)
    n_tiles, P = walk.n_tiles, walk.P
    out = torch.empty((n_tiles, P, N_OUT), dtype=tab.dtype, device=dev)
    bg = bg.to(tab.dtype)
    if return_entries:
        offs = chunk_offsets(counts, chunk).long()
        entries = torch.zeros((int(offs[-1]), 4, P), dtype=tab.dtype,
                              device=dev)
        n_exec = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        marks = torch.zeros((int(offs[-1]), P // 32,
                             max(MARK_WORDS, -(-chunk // 32))),
                            dtype=torch.int32, device=dev)
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
                state, w = composite_chunk(
                    state, px, py, walk.chunk_data(walk.chunk_ids(tiles, c)),
                    return_weights=True)
                marks[offs[tiles][ran] + c] = warp_marks(
                    w[ran], tile, marks.shape[2])
                continue
            state = composite_chunk(
                state, px, py, walk.chunk_data(walk.chunk_ids(tiles, c)))
        rgb = state.rgb + state.trans[..., None] * bg
        out[tiles] = torch.cat([
            rgb, state.alpha_acc[..., None], state.depth_exp[..., None],
            state.depth_med[..., None], state.dist[..., None],
            state.normal], dim=-1)
    buf = detile(out, img_h, img_w, tile)
    return (buf, entries, n_exec, marks) if return_entries else buf


def warp_marks(w: torch.Tensor, tile: int, words: int) -> torch.Tensor:
    """(G, tile², K) blend weights of G tiles' pixels over a chunk's K
    slots → (G, tile² / 32, words) int32: per warp (the kernels' 8 x 4
    pixel rectangles, `WARP_W` x `WARP_H`, numbered row-major over the
    tile), bit k % 32 of word k / 32 set where some pixel of the warp has
    w > 0 at slot k."""
    G, P, K = w.shape
    lidx = torch.arange(P, device=w.device)
    warp = (lidx // tile // WARP_H) * (tile // WARP_W) \
        + lidx % tile // WARP_W
    hit = torch.stack([(w[:, warp == i] > 0).any(1)
                       for i in range(P // 32)], 1)            # (G, W, K)
    hit = torch.nn.functional.pad(hit, (0, 32 * words - K))
    bits = (hit.reshape(G, P // 32, words, 32).long()
            << torch.arange(32, device=w.device)).sum(-1)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).int()


def active_steps(tab: torch.Tensor, pairs: torch.Tensor,
                 starts: torch.Tensor, counts: torch.Tensor, img_h: int,
                 img_w: int, tile: int = 16, chunk: int = 128,
                 row0: int = 0) -> int:
    """How many (pixel, pair) steps of a frame blend with a weight above
    zero: the pair is kept (alpha >= ALPHA_EPS, depth > NEAR_CULL) and the
    pixel is entered at T > T_EPS. Only these carry a cotangent in the
    backward, so their number sets its least work."""
    walk = _TileWalk(tab, pairs, starts, counts, img_h, img_w, tile, chunk,
                     row0)
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
                             chunk: int = 128, row0: int = 0
                             ) -> torch.Tensor:
    """The function K2b computes, in PyTorch: the cotangent of `tab`
    (N, TABLE_W) given the cotangent `ct_buf` (N_OUT, img_h, img_w) of
    `composite_plain`'s buffer; `row0` as there (the band's rows of the
    cotangent, the table built against the whole image).

    The reverse walk of `_composite_frame_bwd` (`rasterize.py:996`) over the
    pair lists: each tile group runs forward keeping every chunk's entry
    state, then walks its executed chunks back through `chunk_backward`,
    adding each chunk's per-slot cotangents into the splat rows. The image
    is blended over `bg` inside the buffer, so the final transmittance
    receives Σ_c ct_image_c · bg_c.
    """
    dev = tab.device
    walk = _TileWalk(tab, pairs, starts, counts, img_h, img_w, tile, chunk,
                     row0)
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
                chunk, row0):
        ctx.save_for_backward(tab, pairs, starts, counts, bg)
        ctx.frame = (img_h, img_w, tile, chunk, row0)
        return composite_plain(tab, pairs, starts, counts, bg, img_h, img_w,
                               tile=tile, chunk=chunk, row0=row0)

    @staticmethod
    def backward(ctx, ct_buf):
        img_h, img_w, tile, chunk, row0 = ctx.frame
        d_tab = composite_plain_backward(*ctx.saved_tensors, ct_buf, img_h,
                                         img_w, tile=tile, chunk=chunk,
                                         row0=row0)
        return (d_tab,) + (None,) * 9


def composite_plain_train(tab: torch.Tensor, pairs: torch.Tensor,
                          starts: torch.Tensor, counts: torch.Tensor,
                          bg: torch.Tensor, img_h: int, img_w: int,
                          tile: int = 16, chunk: int = 128, row0: int = 0
                          ) -> torch.Tensor:
    """The plain version of the training pair K2a + K2b: `composite_plain`,
    differentiable in `tab` through `composite_plain_backward`; `row0` as
    for `composite_plain`."""
    return _CompositePlainTrain.apply(tab, pairs, starts, counts, bg, img_h,
                                      img_w, tile, chunk, row0)


def rasterize_naive(gaussians: torch.Tensor, cam_view: torch.Tensor,
                    cam_view_proj: torch.Tensor, bg: torch.Tensor,
                    img_h: int, img_w: int, chunk: int = 256,
                    pixel_block: int = 8192) -> Dict[str, torch.Tensor]:
    """The per-pixel oracle: every splat against every pixel
    (`rasterize.py:242`). O(N·H·W), for tests and small scenes: no binning,
    no footprint clamp, no per-tile cap, only the compositing semantics,
    through the same `composite_chunk` so alpha and depth are bit-identical
    per (pixel, splat) to the tiled path. Returns the maps of
    `rasterize_tiled`. The work is `naive_table` once and `naive_block`
    for each block of `pixel_block` pixels.
    """
    packed = naive_table(gaussians, cam_view, cam_view_proj, img_h, img_w,
                         chunk)
    px_all, py_all = naive_pixels(img_h, img_w, packed.device)
    blocks = [naive_block(packed, px_all[p0:p0 + pixel_block],
                          py_all[p0:p0 + pixel_block], bg, chunk)
              for p0 in range(0, img_h * img_w, pixel_block)]
    buf = torch.cat(blocks).t().reshape(N_OUT, img_h, img_w)
    return split_outputs(buf)


def naive_table(gaussians: torch.Tensor, cam_view: torch.Tensor,
                cam_view_proj: torch.Tensor, img_h: int, img_w: int,
                chunk: int = 256) -> torch.Tensor:
    """The oracle's splats: projected, in depth order (invalid ones last),
    packed to (PACKED_F, N) and padded with zero columns (opacity 0, no
    contribution) to a multiple of `chunk`; differentiable in
    `gaussians`."""
    sp = preprocess_splats(gaussians, cam_view, cam_view_proj, img_h, img_w)
    key = torch.where(sp.valid, sp.center_z,
                      torch.full_like(sp.center_z, float("inf")))
    order = torch.sort(key, stable=True).indices
    packed = pack_splat_render(SplatProj(*(a[order] for a in sp)))
    pad = (-packed.shape[1]) % chunk
    if pad:
        packed = torch.cat([packed, packed.new_zeros((PACKED_F, pad))], 1)
    return packed


def naive_pixels(img_h: int, img_w: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(px, py) float32 of every pixel of the image, row-major."""
    ys, xs = torch.meshgrid(
        torch.arange(img_h, dtype=torch.float32, device=device),
        torch.arange(img_w, dtype=torch.float32, device=device),
        indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def naive_block(packed: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                bg: torch.Tensor, chunk: int = 256,
                step=composite_chunk) -> torch.Tensor:
    """The oracle's (P, N_OUT) output rows (channels in `OUT_CHANNELS`) of
    the P pixels (px, py): every chunk of the `naive_table` composited in
    order by `step` (`composite_chunk`, or a wrapper of it with its
    signature, such as a checkpointed one)."""
    state = _init_state(1, px.shape[0], packed.device)
    for c0 in range(0, packed.shape[1], chunk):
        state = step(state, px[None], py[None],
                     packed[:, None, c0:c0 + chunk])
    rgb = state.rgb + state.trans[..., None] * bg.float()
    return torch.cat([
        rgb, state.alpha_acc[..., None], state.depth_exp[..., None],
        state.depth_med[..., None], state.dist[..., None],
        state.normal], dim=-1)[0]


def split_outputs(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(N_OUT, H, W) composite buffer → channel-first maps by name."""
    return {k: buf[a:b] for k, a, b in OUT_CHANNELS}


def rasterize_tiled(gaussians: torch.Tensor, cam_view: torch.Tensor,
                    cam_view_proj: torch.Tensor, bg: torch.Tensor,
                    img_h: int, img_w: int, tile: int = 16,
                    max_per_tile: int = 2048, chunk: int = 256,
                    impl: str = "cuda", full_h: int = 0, row0: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """One view, N splats → channel-first maps (image (3,H,W), alpha,
    depth_expected, depth_median, dist (1,H,W), normal_view (3,H,W)).

    Band rendering (`render/sharded.py`): with `full_h` the camera's image
    is `full_h` rows tall and only rows [row0, row0 + img_h) are rendered:
    the splats are projected and their table built against `full_h`, and
    binned, composited and returned in the band's rows.

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
    _check_frame_args(img_h, img_w, tile, max_per_tile, chunk)
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown rasterizer impl {impl!r}")
    sp = preprocess_splats(gaussians, cam_view, cam_view_proj,
                           full_h or img_h, img_w)
    with torch.no_grad():
        pairs, starts, counts = build_tile_pairs(sp, img_h, img_w, tile,
                                                 max_per_tile, row0=row0)
    tab = splat_table(sp, full_h or img_h, img_w)
    if impl == "plain":
        buf = composite_plain_train(tab, pairs, starts, counts, bg, img_h,
                                    img_w, tile=tile, chunk=chunk, row0=row0)
    else:
        from gaussiananything_tpu_torch.ops import rasterize_cuda
        wants_grad = torch.is_grad_enabled() and tab.requires_grad
        fn = rasterize_cuda.composite_train if wants_grad \
            else rasterize_cuda.composite
        buf = fn(tab, pairs, starts, counts, bg, img_h, img_w, tile=tile,
                 chunk=chunk, row0=row0)
    return split_outputs(buf)


# ---------------------------------------------------------------------------
# The rasterizer's other entry points: the segment-fed v4 forward (K6) and
# the dense-list forwards v1, v2, v3 (K3, K4, K5) of
# `gaussiananything_tpu/ops/rasterize_pallas.py`, each with its plain version
# here and its kernel behind a wrapper in `rasterize_cuda.py`.
# ---------------------------------------------------------------------------

GEOM_W = 16     # list-kernel geometry row: t_x(3) t_y(3) t_w(3) t_z(3)
#                 centre x, y, centre depth, opacity (0 for invalid splats)
FEAT_W = 8      # feature row: rgb(3) view normal(3) 1 0
LIST_OUT_W = 16  # list-kernel output row: rgb(3) alpha Σw·z median dist
#                  normal(3) T, 5 zeros (`rasterize_pallas.py:27`)


def segment_table(tab: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """(N, TABLE_W) splat table → the segment-ordered (L, TABLE_W) table
    `tab[pairs]`: tile t's depth-ordered splat rows lie contiguously from
    row `starts[t]`, so a (tile, chunk) slice is ONE range of `chunk` rows
    (chunk × 96 bytes, 32-byte aligned). The JAX package's table is
    field-major, `packed24[:, pairs]` (24, L) (`rasterize_pallas.py:1217`);
    splat-major rows are what a 16-byte asynchronous copy needs. `pairs`
    ends in `max_per_tile` padding slots, so a slice that starts below a
    tile's count never leaves the table."""
    return tab[pairs.long()]


def composite_segments_plain(seg: torch.Tensor, starts: torch.Tensor,
                             counts: torch.Tensor, bg: torch.Tensor,
                             img_h: int, img_w: int, tile: int = 16,
                             chunk: int = 128, row0: int = 0
                             ) -> torch.Tensor:
    """The function K6 computes, in PyTorch: `composite_plain` reading tile
    t's rows `seg[starts[t] + i]`, i < counts[t], straight out of the
    segment-ordered table; rows at or past the count (the next tile's) are
    masked. Returns the (N_OUT, img_h, img_w) buffer."""
    ident = torch.arange(seg.shape[0], dtype=torch.int32, device=seg.device)
    return composite_plain(seg, ident, starts, counts, bg, img_h, img_w,
                           tile=tile, chunk=chunk, row0=row0)


def build_tile_lists(sp: SplatProj, img_h: int, img_w: int, tile: int,
                     max_per_tile: int, row0: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-tile depth-sorted index lists (`rasterize.py:884`):
    (n_tiles, max_per_tile) int32 splat ids, -1 past each tile's count, and
    the (n_tiles,) int32 counts. Only the list kernels read them."""
    pairs, starts, counts = build_tile_pairs(sp, img_h, img_w, tile,
                                             max_per_tile, row0=row0)
    j = torch.arange(max_per_tile, dtype=torch.int32, device=pairs.device)
    in_range = j[None, :] < counts[:, None]
    idx = torch.where(in_range, starts[:, None] + j[None, :],
                      torch.zeros_like(j)[None])
    lists = torch.where(in_range, pairs[idx.long()],
                        torch.full_like(idx, -1))
    return lists, counts


def pad_dead_splat(sp: SplatProj) -> SplatProj:
    """`sp` with one more, invalid, all-zero splat: row N, which the -1
    entries of `build_tile_lists` select (`rasterize_pallas.py:236-239`)."""
    return SplatProj(*(torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
                       for a in sp))


def pack_tile_inputs(sp_pad: SplatProj, lists: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the list kernels' dense inputs (`rasterize_pallas.py:193`):
    geom (n_tiles, max_per_tile, GEOM_W) and feat (n_tiles, max_per_tile,
    FEAT_W). `sp_pad` is `pad_dead_splat(sp)`; a list entry of -1 selects
    its last row, the dead splat with opacity 0."""
    opac = torch.where(sp_pad.valid, sp_pad.opacity,
                       torch.zeros_like(sp_pad.opacity))
    geom_all = torch.cat(
        [sp_pad.t_x, sp_pad.t_y, sp_pad.t_w, sp_pad.t_z, sp_pad.center_pix,
         sp_pad.center_z[:, None], opac[:, None]], dim=1)       # (N+1, 16)
    n1 = sp_pad.rgb.shape[0]
    feat_all = torch.cat(
        [sp_pad.rgb, sp_pad.normal_view, sp_pad.rgb.new_ones((n1, 1)),
         sp_pad.rgb.new_zeros((n1, 1))], dim=1)                 # (N+1, 8)
    idx = lists.long()      # -1 indexes the last row
    return geom_all[idx], feat_all[idx]


def tile_pixel_tables(tile_ids: torch.Tensor, tiles_x: int, tile: int,
                      row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(len(tile_ids), tile²) float32 pixel x and y of the given tiles'
    pixels, row-major inside a tile (`rasterize_pallas.py:488-494`)."""
    lidx = torch.arange(tile * tile, device=tile_ids.device)
    lx = (lidx % tile).float()
    ly = (lidx // tile).float()
    px = (tile_ids % tiles_x).float()[:, None] * tile + lx[None]
    py = (tile_ids // tiles_x).float()[:, None] * tile + ly[None] \
        + float(row0)
    return px, py


def _ray_uv(px, py, col):
    """The v1 kernels' ray-splat form (`rasterize_pallas.py:96-107`): the
    cross product of the two pixel planes evaluated per pair from t_x, t_y,
    t_w, and u = p0 / safe. `col(j)` is field j of the geometry rows,
    broadcast against the pixels. Returns the splat-plane (u, v)."""
    k0 = px * col(6) - col(0)
    k1 = px * col(7) - col(1)
    k2 = px * col(8) - col(2)
    l0 = py * col(6) - col(3)
    l1 = py * col(7) - col(4)
    l2 = py * col(8) - col(5)
    p0 = k1 * l2 - k2 * l1
    p1 = k2 * l0 - k0 * l2
    p2 = k0 * l1 - k1 * l0
    safe = torch.where(p2.abs() < 1e-9, torch.full_like(p2, 1e-9), p2)
    return p0 / safe, p1 / safe


def composite_lists_plain(geom: torch.Tensor, feat: torch.Tensor,
                          counts: torch.Tensor, px: torch.Tensor,
                          py: torch.Tensor, chunk: int,
                          with_aux: bool = False) -> torch.Tensor:
    """The function K3, K4 and K5 compute, in PyTorch (the body of
    `_make_kernel`, `rasterize_pallas.py:59`, expression for expression):
    composite every tile's dense depth-ordered list front to back.

    geom (T, M, GEOM_W), feat (T, M, FEAT_W) from `pack_tile_inputs`;
    counts (T,) int; px, py (T, P) pixel coordinates of each tile's pixels
    (`tile_pixel_tables`; `rasterize_tiled_v2` passes them in its sorted tile
    order). Returns (T, P, LIST_OUT_W).

    Transmittance runs in log space: log1p(−α) summed along the chunk,
    t_excl = exp(cums − log1m), and after pruning the pairs entered at
    T_in ≤ T_EPS the sum is taken again. T is NOT flushed to zero at chunk
    ends, so `trans·bg` keeps a residue of up to T_EPS that the v4 kernels
    do not have. `with_aux` adds the depth distortion from prefix sums
    (`:149-168`); without it dist is 0, as it always is for K4 and K5.

    A chunk that a kernel skips (a saturated tile or group, a chunk past
    the count) changes nothing here either: every pair of it is masked or
    pruned, so its weights are 0 and exp(0) leaves T as it was. The three
    kernels' different skipping therefore gives one function.
    """
    T, M, _ = geom.shape
    P = px.shape[1]
    dev = geom.device
    out = geom.new_zeros((T, P, LIST_OUT_W))
    counts = counts.long()
    counts_host = counts.cpu()
    lane = torch.arange(chunk, device=dev)
    for g0 in range(0, T, _TILE_GROUP):
        sl = slice(g0, min(g0 + _TILE_GROUP, T))
        G = sl.stop - sl.start
        pxe, pye = px[sl, :, None], py[sl, :, None]             # (G, P, 1)
        cnt = counts[sl, None, None]
        z = geom.new_zeros((G, P))
        trans = torch.ones_like(z)
        acc6 = geom.new_zeros((G, P, 6))        # rgb, normal
        a_acc, d_exp, d_med, dist, s_d, s_d2 = z, z, z, z, z, z
        n_chunks = min(math.ceil(int(counts_host[sl].max()) / chunk),
                       M // chunk)
        for c in range(n_chunks):
            if not bool((trans > T_EPS).any()):
                break
            ge = geom[sl, c * chunk:(c + 1) * chunk]            # (G, K, 16)
            fe = feat[sl, c * chunk:(c + 1) * chunk]

            def col(j):
                return ge[:, None, :, j]                        # (G, 1, K)

            u, v = _ray_uv(pxe, pye, col)
            rho3d = u * u + v * v
            z_int = u * col(9) + v * col(10) + col(11)
            dx = pxe - col(12)
            dy = pye - col(13)
            rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
            rho = torch.minimum(rho3d, rho2d)
            depth = torch.where(rho3d <= rho2d, z_int,
                                col(14).expand_as(z_int))
            g = torch.exp(-0.5 * rho) * _rho_window(rho)
            alpha = torch.clamp(col(15) * g, max=ALPHA_MAX)
            in_count = (c * chunk + lane)[None, None, :] < cnt
            keep = (alpha >= ALPHA_EPS) & (depth > NEAR_CULL) & in_count
            zero = torch.zeros_like(alpha)
            alpha = torch.where(keep, alpha, zero)
            depth = torch.where(keep, depth, zero)

            tau = trans[..., None]
            log1m = torch.log1p(-alpha)
            cums = torch.cumsum(log1m, dim=-1)
            t_in = tau * torch.exp(cums - log1m)
            # prune the tail entered below the threshold, then scan again
            alpha = torch.where(t_in > T_EPS, alpha, zero)
            log1m = torch.log1p(-alpha)
            cums = torch.cumsum(log1m, dim=-1)
            t_excl = torch.exp(cums - log1m)
            w = tau * alpha * t_excl                            # (G, P, K)

            acc = torch.bmm(w, fe)                              # (G, P, 8)
            w_sum = acc[..., 6]
            t_after = tau * torch.exp(cums)
            crossed = (t_in > 0.5) & (t_after <= 0.5)
            if with_aux:
                zc = torch.clamp(depth, min=ZNEAR)
                m = torch.where(keep, (ZFAR * (zc - ZNEAR))
                                / (zc * (ZFAR - ZNEAR)), zero)
                wm_r = w * m
                wm2_r = wm_r * m
                # Σ_{j<i} w_j = T_in·(1 − t_excl_i): no third scan
                a_pre = a_acc[..., None] + tau * (1.0 - t_excl)
                d_pre = s_d[..., None] + (torch.cumsum(wm_r, -1) - wm_r)
                d2_pre = s_d2[..., None] + (torch.cumsum(wm2_r, -1) - wm2_r)
                dist = dist + (w * (m * m * a_pre + d2_pre
                                    - 2 * m * d_pre)).sum(-1)
                s_d = s_d + wm_r.sum(-1)
                s_d2 = s_d2 + wm2_r.sum(-1)
            acc6 = acc6 + acc[..., :6]
            a_acc = a_acc + w_sum
            d_exp = d_exp + (w * depth).sum(-1)
            d_med = d_med + torch.where(crossed, depth, zero).sum(-1)
            trans = trans * torch.exp(cums[..., -1])
        o = out[sl]
        o[..., 0:3] = acc6[..., 0:3]
        o[..., 3] = a_acc
        o[..., 4] = d_exp
        o[..., 5] = d_med
        o[..., 6] = dist
        o[..., 7:10] = acc6[..., 3:6]
        o[..., 10] = trans
    return out


def stage_plain(stage: int, gmax: torch.Tensor, geom: torch.Tensor,
                feat: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                group: int, chunk: int, field_major: bool = False
                ) -> torch.Tensor:
    """The function the stage kernels compute, in PyTorch: the grouped (v2)
    kernel cut off after stage 0 (Σρ), 1 (Σα), 2 (Σw and T) or 3 (rgb, Σw
    and T), with the cut-down arithmetic of `make_kernel(stage)` in
    `tools/pallas_bisect.py:25` (ρ = u² + v² alone, no window, no depth, no
    count mask, no pruning pass) and its group-wide test: a group runs
    chunk c while c·chunk < gmax[group] and some pixel of it has T > 1e-4.

    Row-major (`field_major=False`, `tools/pallas_bisect.py`): geom (T, M,
    16), feat (T, M, 8), px, py (T, P); returns the state (T, P, 16): T,
    then the accumulated channels. Field-major
    (`tools/pallas_bisect2.py`): geom (16, T, M), feat (8, T, M), px, py
    (1, T, P); returns (16, T, P).
    """
    if field_major:
        geom, feat = geom.permute(1, 2, 0), feat.permute(1, 2, 0)
        px, py = px[0], py[0]
    T, M, _ = geom.shape
    P = px.shape[1]
    n_groups = T // group
    st = geom.new_zeros((n_groups, group, P, 16))
    st[..., 0] = 1.0
    ge = geom.reshape(n_groups, group, M, 16)
    fe = feat.reshape(n_groups, group, M, 8)
    pxe = px.reshape(n_groups, group, P, 1)
    pye = py.reshape(n_groups, group, P, 1)
    for c in range(M // chunk):
        trans = st[..., 0]
        active = (c * chunk < gmax) & (trans.amax((1, 2)) > T_EPS)
        if not bool(active.any()):
            continue
        rows = ge[:, :, None, c * chunk:(c + 1) * chunk]    # (g, G, 1, K, 16)
        u, v = _ray_uv(pxe, pye, lambda j: rows[..., j])
        rho = u * u + v * v
        new = st.clone()
        if stage == 0:
            new[..., 1] = st[..., 1] + rho.sum(-1)
        else:
            alpha = torch.clamp(rows[..., 15] * torch.exp(-0.5 * rho),
                                max=ALPHA_MAX)
            alpha = torch.where(alpha >= ALPHA_EPS, alpha,
                                torch.zeros_like(alpha))
            if stage == 1:
                new[..., 1] = st[..., 1] + alpha.sum(-1)
            else:
                log1m = torch.log1p(-alpha)
                cums = torch.cumsum(log1m, dim=-1)
                w = trans[..., None] * alpha * torch.exp(cums - log1m)
                if stage == 2:
                    new[..., 1] = st[..., 1] + w.sum(-1)
                else:
                    f = fe[:, :, None, c * chunk:(c + 1) * chunk]
                    for i in range(3):
                        new[..., 1 + i] = st[..., 1 + i] \
                            + (w * f[..., i]).sum(-1)
                    new[..., 4] = st[..., 4] + w.sum(-1)
                new[..., 0] = trans * torch.exp(cums[..., -1])
        st = torch.where(active[:, None, None, None], new, st)
    st = st.reshape(T, P, 16)
    return st.permute(2, 0, 1).contiguous() if field_major else st


def detile(tiles: torch.Tensor, img_h: int, img_w: int, tile: int
           ) -> torch.Tensor:
    """(n_tiles, tile², C) per-tile rows → (C, img_h, img_w)."""
    C = tiles.shape[-1]
    t = tiles.reshape(img_h // tile, img_w // tile, tile, tile, C)
    return t.permute(4, 0, 2, 1, 3).reshape(C, img_h, img_w)


def list_outputs(out: torch.Tensor, bg: torch.Tensor, img_h: int,
                 img_w: int, tile: int) -> Dict[str, torch.Tensor]:
    """(n_tiles, tile², LIST_OUT_W) list-kernel output → the maps of
    `rasterize_tiled`, the image blended over `bg` with the unflushed T."""
    buf = detile(out, img_h, img_w, tile)
    return {"image": buf[0:3] + buf[10:11] * bg.to(buf.dtype)[:, None, None],
            "alpha": buf[3:4], "depth_expected": buf[4:5],
            "depth_median": buf[5:6], "dist": buf[6:7],
            "normal_view": buf[7:10]}


def _check_frame_args(img_h, img_w, tile, max_per_tile, chunk):
    if img_h % tile or img_w % tile:
        raise ValueError(f"image {img_h}x{img_w} is not a multiple of the "
                         f"tile {tile}")
    if max_per_tile % chunk:
        raise ValueError("max_per_tile must be a multiple of chunk")


def _check_group(img_h, img_w, tile, group):
    n_tiles = (img_h // tile) * (img_w // tile)
    if n_tiles % group:
        raise ValueError(f"{n_tiles} tiles are not a multiple of the group "
                         f"{group}")


def tile_lists(gaussians: torch.Tensor, cam_view: torch.Tensor,
               cam_view_proj: torch.Tensor, img_h: int, img_w: int,
               tile: int, max_per_tile: int, chunk: int, full_h: int = 0,
               row0: int = 0):
    """What the list entry points share: project and bin into dense lists.
    Returns (the projected splats with the dead splat appended, lists,
    counts), for `pack_tile_inputs`."""
    _check_frame_args(img_h, img_w, tile, max_per_tile, chunk)
    sp = preprocess_splats(gaussians, cam_view, cam_view_proj,
                           full_h or img_h, img_w)
    lists, counts = build_tile_lists(sp, img_h, img_w, tile, max_per_tile,
                                     row0=row0)
    return pad_dead_splat(sp), lists, counts


@torch.no_grad()
def rasterize_tiled_v1(gaussians: torch.Tensor, cam_view: torch.Tensor,
                       cam_view_proj: torch.Tensor, bg: torch.Tensor,
                       img_h: int, img_w: int, tile: int = 16,
                       max_per_tile: int = 1024, chunk: int = 256,
                       full_h: int = 0, row0: int = 0,
                       with_aux: bool = False) -> Dict[str, torch.Tensor]:
    """The v1 forward, `rasterize_tiled_pallas`
    (`rasterize_pallas.py:216`): one program per tile over dense lists, K3
    (`rasterize_cuda.composite_lists`: the kernel for CUDA tensors,
    `composite_lists_plain` for CPU tensors). Same maps as
    `rasterize_tiled`; dist is 0 unless `with_aux`. `full_h`/`row0` render
    a band of rows of a taller image. Forward only."""
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    sp_pad, lists, counts = tile_lists(
        gaussians, cam_view, cam_view_proj, img_h, img_w, tile, max_per_tile,
        chunk, full_h, row0)
    geom, feat = pack_tile_inputs(sp_pad, lists)
    out = rasterize_cuda.composite_lists(
        geom, feat, counts, img_w // tile, tile, chunk, row0=row0,
        with_aux=with_aux)
    return list_outputs(out, bg, img_h, img_w, tile)


_MAP_ORDER = tuple(k for k, _, _ in OUT_CHANNELS)


class _V1Fused(torch.autograd.Function):
    """K3 (with the distortion) forward; the backward recomputes the
    differentiable route `rasterize_tiled` and takes its gradient: no
    residual but the surfels is kept."""

    @staticmethod
    def forward(ctx, gaussians, cam_view, cam_view_proj, bg, frame):
        img_h, img_w, tile, max_per_tile, chunk, full_h, row0 = frame
        ctx.save_for_backward(gaussians, cam_view, cam_view_proj, bg)
        ctx.frame = frame
        out = rasterize_tiled_v1(
            gaussians, cam_view, cam_view_proj, bg, img_h, img_w, tile=tile,
            max_per_tile=max_per_tile, chunk=chunk, full_h=full_h, row0=row0,
            with_aux=True)
        return tuple(out[k] for k in _MAP_ORDER)

    @staticmethod
    def backward(ctx, *cts):
        gaussians, cam_view, cam_view_proj, bg = ctx.saved_tensors
        img_h, img_w, tile, max_per_tile, chunk, _, _ = ctx.frame
        with torch.enable_grad():
            g = gaussians.detach().requires_grad_(True)
            out = rasterize_tiled(g, cam_view, cam_view_proj, bg, img_h,
                                  img_w, tile=tile,
                                  max_per_tile=max_per_tile, chunk=chunk)
            loss = sum((out[k] * ct).sum() for k, ct in zip(_MAP_ORDER, cts)
                       if ct is not None)
            grad, = torch.autograd.grad(loss, g)
        return grad, None, None, None, None


def rasterize_tiled_v1_fused(gaussians: torch.Tensor,
                             cam_view: torch.Tensor,
                             cam_view_proj: torch.Tensor, bg: torch.Tensor,
                             img_h: int, img_w: int, tile: int = 16,
                             max_per_tile: int = 1024, chunk: int = 64
                             ) -> Dict[str, torch.Tensor]:
    """`rasterize_tiled_fused` (`rasterize_pallas.py:290`): the v1 kernel
    forward (with the distortion, so dist's value matches its gradient)
    and, for the gradient with respect to the surfels, the differentiable
    route recomputed in the backward: `rasterize_tiled`, which is the
    K2a/K2b pair for CUDA tensors and the plain pair for CPU tensors (the
    JAX function differentiates its XLA path there, `:316-327`). The
    backward renders whole images only, so this function takes no band."""
    frame = (img_h, img_w, tile, max_per_tile, chunk, 0, 0)
    maps = _V1Fused.apply(gaussians, cam_view, cam_view_proj, bg, frame)
    return dict(zip(_MAP_ORDER, maps))


@torch.no_grad()
def rasterize_tiled_v2(gaussians: torch.Tensor, cam_view: torch.Tensor,
                       cam_view_proj: torch.Tensor, bg: torch.Tensor,
                       img_h: int, img_w: int, tile: int = 8,
                       max_per_tile: int = 512, chunk: int = 128,
                       group: int = 16, full_h: int = 0, row0: int = 0
                       ) -> Dict[str, torch.Tensor]:
    """The v2 forward, `rasterize_tiled_pallas_grouped`
    (`rasterize_pallas.py:455`): tiles sorted by count, descending, in
    groups of `group`; each group walks the chunks below its largest count
    (K4, `rasterize_cuda.composite_lists_grouped`). dist is 0. Forward
    only."""
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    _check_group(img_h, img_w, tile, group)
    sp_pad, lists, counts = tile_lists(
        gaussians, cam_view, cam_view_proj, img_h, img_w, tile, max_per_tile,
        chunk, full_h, row0)
    order = torch.sort(-counts, stable=True).indices
    inv_order = torch.sort(order, stable=True).indices
    counts_s = counts[order]
    geom, feat = pack_tile_inputs(sp_pad, lists[order])
    px, py = tile_pixel_tables(order, img_w // tile, tile, row0)
    gmax = counts_s.reshape(-1, group).amax(1).int()
    out = rasterize_cuda.composite_lists_grouped(
        gmax, geom, feat, px, py, counts_s.float()[:, None], group, chunk)
    return list_outputs(out[inv_order], bg, img_h, img_w, tile)


@torch.no_grad()
def rasterize_tiled_v3(gaussians: torch.Tensor, cam_view: torch.Tensor,
                       cam_view_proj: torch.Tensor, bg: torch.Tensor,
                       img_h: int, img_w: int, tile: int = 8,
                       max_per_tile: int = 512, chunk: int = 128,
                       group: int = 8, full_h: int = 0, row0: int = 0
                       ) -> Dict[str, torch.Tensor]:
    """The v3 forward, `rasterize_tiled_pallas_v3`
    (`rasterize_pallas.py:659`): `group` consecutive tiles per program,
    each over its own ceil(count / chunk) chunks (K5,
    `rasterize_cuda.composite_lists_unrolled`). dist is 0. Forward only."""
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    _check_group(img_h, img_w, tile, group)
    sp_pad, lists, counts = tile_lists(
        gaussians, cam_view, cam_view_proj, img_h, img_w, tile, max_per_tile,
        chunk, full_h, row0)
    geom, feat = pack_tile_inputs(sp_pad, lists)
    out = rasterize_cuda.composite_lists_unrolled(
        geom, feat, counts, img_w // tile, tile, chunk, group, row0=row0)
    return list_outputs(out, bg, img_h, img_w, tile)


@torch.no_grad()
def rasterize_tiled_v4_dma(gaussians: torch.Tensor, cam_view: torch.Tensor,
                           cam_view_proj: torch.Tensor, bg: torch.Tensor,
                           img_h: int, img_w: int, tile: int = 16,
                           max_per_tile: int = 2048, chunk: int = 128,
                           full_h: int = 0, row0: int = 0,
                           big_capacity: int = 0) -> Dict[str, torch.Tensor]:
    """The v4 forward fed by asynchronous copies, `rasterize_tiled_v4_dma`
    (`rasterize_pallas.py:1147`): ONE gather builds the segment-ordered
    table `segment_table(tab, pairs)`, and K6
    (`rasterize_cuda.composite_segments`) copies each (tile, chunk) slice
    of it into shared memory while it composites the one before. The same
    maps as `rasterize_tiled`. There is no `group` or `steps_per_group`:
    like K1, K6 walks every tile's whole segment, so no step is ever dead
    (the JAX function parks dead steps on a chunk it may composite twice,
    `:1204`). Forward only."""
    from gaussiananything_tpu_torch.ops import rasterize_cuda
    _check_frame_args(img_h, img_w, tile, max_per_tile, chunk)
    sp = preprocess_splats(gaussians, cam_view, cam_view_proj,
                           full_h or img_h, img_w)
    pairs, starts, counts = build_tile_pairs(
        sp, img_h, img_w, tile, max_per_tile, row0=row0,
        big_capacity=big_capacity)
    seg = segment_table(splat_table(sp, full_h or img_h, img_w), pairs)
    buf = rasterize_cuda.composite_segments(
        seg, starts, counts, bg, img_h, img_w, tile=tile, chunk=chunk,
        row0=row0)
    return split_outputs(buf)
