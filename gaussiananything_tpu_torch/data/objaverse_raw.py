"""Raw reference-dataset ingestion: EXR g-buffers + chunked-jpeg layout
(the port's own copy of `gaussiananything_tpu/data/objaverse_raw.py`, which
is numpy only; `convert_raw_dir` packs through the port's
`data/gbuffer.pack_instance`).

Mirrors the reference's raw Objaverse loaders without its cv2/kornia/imageio
dependency stack (`datasets/g_buffer_objaverse.py`):

  * `read_exr` / `write_exr` — pure-python OpenEXR scanline codec (HALF /
    FLOAT, NONE / ZIP / ZIPS compression). Blender's g-buffer EXRs are
    ZIP-compressed half scanlines, which this covers; PIZ raises.
  * `read_dnormal` — normal+depth decode with near-distance culling
    (`g_buffer_objaverse.py:2047-2077`). Channel order matches the
    reference's cv2.IMREAD_UNCHANGED convention (BGRA → [B,G,R] normal +
    depth), so `unity2blender_fix` applies to the same layout.
  * `unity2blender_fix` — the g-buffer normal coordinate fix (`:2140-2148`).
  * `read_camera_matrix_single` / `pose_25d` — blender c2w from the pose
    json's x/y/z/origin columns (`:2105-2126`) + the 25-dim (16 c2w + 9
    normalised-K) pose used everywhere downstream (`get_intri`, `:2079`).
  * `read_chunk` — the chunked layout (`:3225-3300`): `raw_img.jpg` strip,
    `c.npy` poses, `caption.txt`, `ins.txt`, `bbox.npy`,
    `depth_alpha.jpg` + `d_near_far.npy` dequantisation, alpha-erosion
    anti-alias fix, `normal.png` strip.
  * `raw_chunk_to_instance` — converts a chunk dir into the canonical
    instance dict consumed by `data/gbuffer.MultiViewDataset`.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Minimal OpenEXR scanline codec.
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_DTYPE = {_PT_UINT: np.dtype("<u4"), _PT_HALF: np.dtype("<f2"),
             _PT_FLOAT: np.dtype("<f4")}
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ = 0, 1, 2, 3, 4
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _unpredict_deinterleave(d: bytes) -> bytes:
    """OpenEXR ZIP post-inflate reconstruction (ImfZip.cpp): cumulative
    byte-delta with bias 128, then interleave the two halves."""
    b = np.frombuffer(d, np.uint8).astype(np.int64)
    b[1:] -= 128              # d[0] raw, d[i>=1] stored as delta+128
    a = np.cumsum(b).astype(np.uint8)
    n = len(a)
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = a[:half]
    out[1::2] = a[half:]
    return out.tobytes()


def _predict_interleave(d: bytes) -> bytes:
    """Inverse of `_unpredict_deinterleave` (for the writer)."""
    a = np.frombuffer(d, np.uint8)
    n = len(a)
    half = (n + 1) // 2
    sep = np.empty(n, np.uint8)
    sep[:half] = a[0::2]
    sep[half:] = a[1::2]
    s = sep.astype(np.int64)
    delta = np.empty(n, np.int64)
    delta[0] = s[0]
    delta[1:] = s[1:] - s[:-1] + 128
    return delta.astype(np.uint8).tobytes()


def read_exr(path_or_bytes) -> Dict[str, np.ndarray]:
    """Decode a scanline EXR → {channel_name: (H, W) float32 array}.

    Supports HALF/FLOAT/UINT channels and NONE/ZIPS/ZIP compression —
    the Blender g-buffer envelope. Raises on tiled files, PIZ, or
    subsampled channels.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("tiled EXR not supported (scanline only)")
    off = 8

    channels: List[Tuple[str, int]] = []
    compression = _COMP_ZIP
    data_window = None
    while True:
        name, off = _read_cstr(buf, off)
        if name == "":
            break
        atype, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off:off + size]
        off += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                cname, p = _read_cstr(payload, p)
                ptype, = struct.unpack_from("<i", payload, p)
                xs, ys = struct.unpack_from("<ii", payload, p + 8)
                if xs != 1 or ys != 1:
                    raise ValueError("subsampled channels unsupported")
                channels.append((cname, ptype))
                p += 16
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
    if data_window is None:
        raise ValueError("missing dataWindow")
    x0, y0, x1, y1 = data_window
    width, height = x1 - x0 + 1, y1 - y0 + 1
    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"compression {compression} unsupported "
                         "(NONE/ZIPS/ZIP only)")
    lpb = _LINES_PER_BLOCK[compression]
    # channels are stored sorted by name within each scanline
    channels.sort(key=lambda c: c[0])
    n_blocks = (height + lpb - 1) // lpb
    off += n_blocks * 8  # skip line-offset table (blocks are sequential)

    row_bytes = sum(width * _PT_DTYPE[pt].itemsize for _, pt in channels)
    out = {c: np.empty((height, width), np.float32) for c, _ in channels}
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", buf, off)
        off += 8
        raw = buf[off:off + size]
        off += size
        nlines = min(lpb, height - (y - y0))
        expect = row_bytes * nlines
        if compression != _COMP_NONE and size < expect:
            raw = _unpredict_deinterleave(zlib.decompress(raw))
        if len(raw) != expect:
            raise ValueError("block size mismatch")
        p = 0
        for line in range(nlines):
            yy = y - y0 + line
            for cname, ptype in channels:
                dt = _PT_DTYPE[ptype]
                nb = width * dt.itemsize
                out[cname][yy] = np.frombuffer(
                    raw, dt, width, p).astype(np.float32)
                p += nb
    return out


def write_exr(path: str, channels: Dict[str, np.ndarray],
              pixel_type: int = _PT_HALF, compression: int = _COMP_ZIP):
    """Write a scanline EXR (fixture/export use). float32 inputs are cast
    to `pixel_type`."""
    names = sorted(channels)
    h, w = channels[names[0]].shape
    dt = _PT_DTYPE[pixel_type]

    header = b""
    chpay = b""
    for n in names:
        chpay += n.encode() + b"\x00" + struct.pack(
            "<iBBBBii", pixel_type, 0, 0, 0, 0, 1, 1)
    chpay += b"\x00"

    def attr(name, atype, payload):
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += attr("channels", "chlist", chpay)
    header += attr("compression", "compression",
                   struct.pack("<B", compression))
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (h + lpb - 1) // lpb
    blocks = []
    for b in range(n_blocks):
        y = b * lpb
        nlines = min(lpb, h - y)
        raw = b""
        for line in range(nlines):
            for n in names:
                raw += np.ascontiguousarray(
                    channels[n][y + line]).astype(dt).tobytes()
        if compression != _COMP_NONE:
            comp = zlib.compress(_predict_interleave(raw))
            if len(comp) >= len(raw):
                comp = raw
        else:
            comp = raw
        blocks.append((y, comp))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _EXR_MAGIC, 2))
        f.write(header)
        base = 8 + len(header) + n_blocks * 8
        offsets = []
        pos = base
        for y, comp in blocks:
            offsets.append(pos)
            pos += 8 + len(comp)
        f.write(struct.pack(f"<{n_blocks}q", *offsets))
        for y, comp in blocks:
            f.write(struct.pack("<ii", y, len(comp)))
            f.write(comp)


# ---------------------------------------------------------------------------
# Reference decode helpers.
# ---------------------------------------------------------------------------

def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.INTER_NEAREST-equivalent resize (HW or HWC)."""
    sh, sw = img.shape[:2]
    yi = np.minimum((np.arange(h) * sh / h).astype(np.int64), sh - 1)
    xi = np.minimum((np.arange(w) * sw / w).astype(np.int64), sw - 1)
    return img[yi][:, xi]


def read_dnormal(normald_path, cond_pos: np.ndarray,
                 h: Optional[int] = None, w: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """`read_dnormal` parity (`g_buffer_objaverse.py:2047-2077`): decode the
    4-channel normal+depth EXR, cull depth nearer than |cam| − √3/2.

    Returns (depth (H, W), normal (H, W, 3)); normal channels are in the
    reference's cv2 order (BGRA → [B,G,R]) so downstream coordinate fixes
    match bit-for-bit.
    """
    ch = read_exr(normald_path)
    names = sorted(ch)
    # Blender writes R,G,B,A; cv2.IMREAD_UNCHANGED yields [B,G,R,A].
    if set("RGBA").issubset(names):
        normal = np.stack([ch["B"], ch["G"], ch["R"]], -1)
        depth = ch["A"]
    else:  # fall back to sorted order: last channel is depth
        normal = np.stack([ch[n] for n in names[:3]], -1)
        depth = ch[names[3]]
    cond_cam_dis = float(np.linalg.norm(np.asarray(cond_pos), 2))
    near_distance = cond_cam_dis - 0.867  # sqrt(3) * 0.5
    depth = np.where(depth < near_distance, 0.0, depth)
    if h is not None:
        assert w is not None
        if depth.shape[:2] != (h, w):
            depth = _resize_nearest(depth, h, w)
        if normal.shape[:2] != (h, w):
            normal = _resize_nearest(normal, h, w)
    return depth.astype(np.float32), normal.astype(np.float32)


def unity2blender_fix(normal: np.ndarray) -> np.ndarray:
    """G-buffer normal coordinate fix (`g_buffer_objaverse.py:2140-2148`)."""
    out = normal.copy()
    out[..., 0] = -normal[..., 0]
    out[..., 1] = -normal[..., 2]
    out[..., 2] = normal[..., 1]
    return out


def get_intri(h: int, w: int, normalize: bool = False) -> np.ndarray:
    """Reference intrinsics (`:2079-2093`): fx=fy=1422.222 @ 1024 raw."""
    fx = 1422.222
    f = fx * h / 1024.0
    K = np.array([f, 0, w / 2, 0, f, h / 2, 0, 0, 1],
                 np.float32).reshape(3, 3)
    if normalize:
        K[:2] /= h
    return K


def read_camera_matrix_single(json_file: str) -> np.ndarray:
    """Blender c2w from the pose json's x/y/z/origin columns (`:2105`)."""
    with open(json_file, "r", encoding="utf8") as f:
        j = json.load(f)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = np.asarray(j["x"], np.float32)
    c2w[:3, 1] = np.asarray(j["y"], np.float32)
    c2w[:3, 2] = np.asarray(j["z"], np.float32)
    c2w[:3, 3] = np.asarray(j["origin"], np.float32)
    return c2w


def pose_25d(c2w: np.ndarray, h: int = 512, w: int = 512) -> np.ndarray:
    """16 flattened c2w + 9 normalised-K — the 25-dim pose every consumer
    expects (`render/cameras.py` contract)."""
    K = get_intri(h, w, normalize=True)
    return np.concatenate([np.asarray(c2w, np.float32).reshape(16),
                           K.reshape(9)])


def _erode_cross(mask: np.ndarray) -> np.ndarray:
    """3×3 cross-kernel binary erosion (kornia.morphology.erosion parity
    with the reference's kernel [[0,1,0],[1,1,1],[0,1,0]])."""
    m = mask.astype(bool)
    p = np.pad(m, ((1, 1), (1, 1)), constant_values=False)
    return (p[1:-1, 1:-1] & p[:-2, 1:-1] & p[2:, 1:-1]
            & p[1:-1, :-2] & p[1:-1, 2:]).astype(mask.dtype)


def _imread(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path))


def read_chunk(chunk_path: str, chunk_size: int = 12, img_ext: str = "jpg",
               read_normal: bool = True):
    """Chunked-layout decode (`g_buffer_objaverse.py:3225-3300`).

    Layout: `raw_img.{ext}` horizontal strip (h, V·w, 3); `c.npy` (V, 25)
    poses; `caption.txt`; `ins.txt`; `bbox.npy`; depth+alpha either as the
    quantised `depth_alpha.jpg` strip + `d_near_far.npy` (V > 16 layout) or
    as `alpha.{ext}` strip + `depth.npz`; `normal.png` strip.

    Returns (rgb (V,h,w,3) uint8, depth (V,h,w) f32, normal (V,h,w,3) f32,
    alpha (V,h,w) uint8, c (V,25), bbox, caption, ins).
    """
    raw = _imread(os.path.join(chunk_path, f"raw_img.{img_ext}"))
    h, bw, c3 = raw.shape
    V = chunk_size
    rgb = raw.reshape(h, V, bw // V, c3).transpose(1, 0, 2, 3)
    c = np.load(os.path.join(chunk_path, "c.npy"))
    with open(os.path.join(chunk_path, "caption.txt"), encoding="utf-8") as f:
        caption = f.read()
    with open(os.path.join(chunk_path, "ins.txt"), encoding="utf-8") as f:
        ins = f.read()
    bbox = np.load(os.path.join(chunk_path, "bbox.npy"))

    da_path = os.path.join(chunk_path, "depth_alpha.jpg")
    if os.path.exists(da_path):
        da = _imread(da_path)
        da = da.reshape(h * 2, V, -1).transpose(1, 0, 2)
        depth_q, alpha = np.split(da, 2, axis=1)
        nf = np.load(os.path.join(chunk_path, "d_near_far.npy"))
        d_near = nf[0].reshape(V, 1, 1)
        d_far = nf[1].reshape(V, 1, 1)
        depth = 1.0 / ((depth_q / 255.0) * (d_far - d_near) + d_near)
        depth = np.where(depth > 2.9, 0.0, depth)
        erode = np.stack([_erode_cross(a == 255) for a in alpha])
        depth = (depth * erode).astype(np.float32)
    else:
        alpha = _imread(os.path.join(chunk_path, f"alpha.{img_ext}"))
        alpha = alpha.reshape(h, V, -1).transpose(1, 0, 2)
        depth = np.load(os.path.join(chunk_path, "depth.npz"))["depth"]
        depth = depth.astype(np.float32)

    normal = None
    if read_normal:
        npath = os.path.join(chunk_path, "normal.png")
        normal = _imread(npath).astype(np.float32) / 255.0
        normal = (normal * 2 - 1).reshape(h, V, -1, 3).transpose(1, 0, 2, 3)
        normal = unity2blender_fix(normal)
    return rgb, depth, normal, alpha, c, bbox, caption, ins


def raw_chunk_to_instance(chunk_path: str, chunk_size: int = 12,
                          img_ext: str = "jpg", n_pcd: int = 4096,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """Chunk dir → the canonical instance dict (`data/gbuffer.pack_instance`
    schema). The surface point cloud is back-projected from the depth maps
    (the reference ships a separate pcd_path; when absent it derives one the
    same way — `datasets/g_buffer_objaverse.py` load_pcd fallback)."""
    rgb, depth, normal, alpha, c, bbox, caption, ins = read_chunk(
        chunk_path, chunk_size, img_ext)
    V, h, w = depth.shape
    K = get_intri(h, w)
    pts = []
    for v in range(V):
        m = depth[v] > 0
        if not m.any():
            continue
        ys, xs = np.nonzero(m)
        z = depth[v][ys, xs]
        x_cam = (xs + 0.5 - K[0, 2]) / K[0, 0] * z
        y_cam = (ys + 0.5 - K[1, 2]) / K[1, 1] * z
        p_cam = np.stack([x_cam, y_cam, z, np.ones_like(z)], -1)
        c2w = c[v, :16].reshape(4, 4)
        # blender camera looks down -Z with +Y up; the stored c2w maps
        # camera coords (x right, y up, z backward) → world
        p_cam[:, 1] *= -1
        p_cam[:, 2] *= -1
        pts.append((p_cam @ c2w.T)[:, :3])
    pcd = (np.concatenate(pts, 0) if pts
           else np.zeros((1, 3), np.float32))
    rs = np.random.default_rng(seed)
    idx = rs.choice(len(pcd), size=min(n_pcd, len(pcd)), replace=False)
    pcd = pcd[idx].astype(np.float32)
    return {
        "rgb": rgb.astype(np.uint8),
        "normal": (normal if normal is not None
                   else np.zeros(rgb.shape, np.float32)),
        "depth": depth,
        "alpha": (alpha[..., 0] if alpha.ndim == 4 else alpha
                  ).astype(np.uint8),
        "pose": c.astype(np.float32),
        "pcd": pcd,
        "caption": caption,
        "ins": ins,
        "bbox": bbox,
    }


def convert_raw_dir(raw_dir: str, out_dir: str, chunk_size: int = 12,
                    img_ext: str = "jpg"):
    """Convert every chunk dir under `raw_dir` into canonical npz instances
    consumable by `data/gbuffer.MultiViewDataset`."""
    from gaussiananything_tpu_torch.data.gbuffer import pack_instance
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for root, dirs, files in os.walk(raw_dir):
        if f"raw_img.{img_ext}" not in files:
            continue
        inst = raw_chunk_to_instance(root, chunk_size, img_ext)
        name = os.path.relpath(root, raw_dir).replace(os.sep, "_")
        pack_instance(os.path.join(out_dir, name + ".npz"),
                      inst["rgb"], inst["normal"], inst["depth"],
                      inst["alpha"], inst["pose"], inst["pcd"])
        with open(os.path.join(out_dir, name + ".caption.txt"), "w",
                  encoding="utf-8") as f:
            f.write(inst["caption"])
        n += 1
    return n
