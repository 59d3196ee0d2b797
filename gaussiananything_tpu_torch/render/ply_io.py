"""PLY / GLB writers (the port's own copy of the writers in
`gaussiananything_tpu/render/ply_io.py` that sampling uses).

  * `save_2dgs_ply` (parity with `nsr/gs_surfel.py:206`, with the inverse
    activations of `compatible=True`: logit opacity, log scales, SH-DC
    color (rgb-0.5)/C0);
  * plain xyz[+rgb] point-cloud ply (stage-1 sample export,
    `nsr/lsgm/flow_matching_trainer.py:1742-1753`);
  * minimal GLB (glTF 2.0) point-cloud and triangle-mesh writers;
  * `read_ply` / `load_2dgs_ply` / `load_pointcloud_ply` to read them back.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Tuple

import numpy as np

SH_C0 = 0.28209479177387814


# ---------------------------------------------------------------- PLY core

def write_ply(path: str, fields: Dict[str, np.ndarray],
              binary: bool = True) -> str:
    """fields: name -> (N,) float32 arrays, written in insertion order as a
    binary little-endian (or ascii) vertex list. A binary file is written
    by the native library's `ga_write_ply` (`native_bindings.
    write_ply_native`), as the JAX package's writer does; numpy writes the
    same bytes where no C++ compiler exists to build the library. Returns
    which writer ran: "native" or "numpy"."""
    if binary:
        from gaussiananything_tpu_torch import native_bindings
        try:
            native_bindings.write_ply_native(path, fields)
            return "native"
        except native_bindings.NativeUnavailable:
            pass
    names = list(fields)
    n = len(fields[names[0]])
    cols = [np.asarray(fields[k], dtype=np.float32).reshape(n) for k in names]
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0", f"element vertex {n}"]
    header += [f"property float {k}" for k in names]
    header.append("end_header")
    data = np.stack(cols, axis=1)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            f.write(data.astype("<f4").tobytes())
        else:
            np.savetxt(f, data, fmt="%.8g")
    return "numpy"


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """A binary little-endian or ascii ply's vertex properties → name ->
    (N,) float32."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode().splitlines()
    body = raw[end:]
    fmt = next(ln.split()[1] for ln in header if ln.startswith("format"))
    n = int(next(ln.split()[2] for ln in header
                 if ln.startswith("element vertex")))
    dtmap = {"float": "<f4", "float32": "<f4", "double": "<f8",
             "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
             "short": "<i2", "ushort": "<u2", "char": "i1"}
    props, in_vertex = [], False
    for ln in header:
        if ln.startswith("element"):
            in_vertex = ln.split()[1] == "vertex"
        elif ln.startswith("property") and in_vertex:
            _, typ, name = ln.split()[:3]
            props.append((name, dtmap[typ]))
    if fmt.startswith("binary_little"):
        dt = np.dtype(props)
        arr = np.frombuffer(body[:n * dt.itemsize], dtype=dt)
        return {name: arr[name].astype(np.float32) for name, _ in props}
    if fmt.startswith("ascii"):
        arr = np.loadtxt(body.decode().splitlines()[:n],
                         dtype=np.float32).reshape(n, len(props))
        return {name: arr[:, i].astype(np.float32)
                for i, (name, _) in enumerate(props)}
    raise ValueError(f"unsupported ply format {fmt}")


# ------------------------------------------------------------ 2DGS ply IO

def save_2dgs_ply(path: str, gaussians: np.ndarray):
    """gaussians (N, 13) activated; writes the 2DGS-standard vertex layout
    with its inverse activations (logit opacity, log scales, SH-DC rgb)."""
    g = np.asarray(gaussians, dtype=np.float32)
    if g.ndim != 2 or g.shape[1] != 13:
        raise ValueError(f"expected (N, 13) gaussians, got {g.shape}")
    xyz, op, sc, rot, rgb = g[:, :3], g[:, 3:4], g[:, 4:6], g[:, 6:10], g[:, 10:13]
    opc = np.clip(op, 1e-6, 1 - 1e-6)
    op = np.log(opc) - np.log1p(-opc)
    sc = np.log(sc + 1e-8)
    rgb = (rgb - 0.5) / SH_C0
    fields = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
              "nx": np.zeros(len(g), np.float32),
              "ny": np.zeros(len(g), np.float32),
              "nz": np.zeros(len(g), np.float32)}
    for i in range(3):
        fields[f"f_dc_{i}"] = rgb[:, i]
    fields["opacity"] = op[:, 0]
    for i in range(2):
        fields[f"scale_{i}"] = sc[:, i]
    for i in range(4):
        fields[f"rot_{i}"] = rot[:, i]
    write_ply(path, fields)


def load_2dgs_ply(path: str) -> np.ndarray:
    """`save_2dgs_ply`'s file → (N, 13) activated gaussians."""
    f = read_ply(path)
    n = len(f["x"])
    xyz = np.stack([f["x"], f["y"], f["z"]], 1)
    op = 1.0 / (1.0 + np.exp(-f["opacity"][:, None]))
    sc = np.exp(np.stack([f[f"scale_{i}"] for i in range(2)], 1))
    rot = np.stack([f[f"rot_{i}"] for i in range(4)], 1)
    rgb = SH_C0 * np.stack([f.get(f"f_dc_{i}", np.zeros(n, np.float32))
                            for i in range(3)], 1) + 0.5
    return np.concatenate([xyz, op, sc, rot, rgb], 1).astype(np.float32)


def save_pointcloud_ply(path: str, xyz: np.ndarray,
                        rgb: Optional[np.ndarray] = None):
    fields = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    if rgb is not None:
        for i, k in enumerate(["red", "green", "blue"]):
            fields[k] = rgb[:, i]
    write_ply(path, fields)


def load_pointcloud_ply(path: str
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    f = read_ply(path)
    xyz = np.stack([f["x"], f["y"], f["z"]], 1)
    rgb = None
    if "red" in f:
        rgb = np.stack([f["red"], f["green"], f["blue"]], 1)
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
    return xyz, rgb


# ------------------------------------------------------------------ GLB

def _write_glb(path: str, blobs, views, accessors, primitive: dict):
    bin_blob = b"".join(blobs)
    bin_blob += b"\x00" * ((-len(bin_blob)) % 4)
    gltf = {
        "asset": {"version": "2.0", "generator": "gaussiananything_tpu_torch"},
        "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [primitive]}],
        "buffers": [{"byteLength": len(bin_blob)}],
        "bufferViews": views, "accessors": accessors,
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(bin_blob), 0x004E4942))
        f.write(bin_blob)

def save_pointcloud_glb(path: str, xyz: np.ndarray,
                        rgb: Optional[np.ndarray] = None):
    """Minimal glTF 2.0 binary point-cloud (mode=0 POINTS)."""
    xyz = np.asarray(xyz, np.float32)
    buffers = [xyz.tobytes()]
    attributes = {"POSITION": 0}
    accessors = [{
        "bufferView": 0, "componentType": 5126, "count": int(len(xyz)),
        "type": "VEC3", "min": xyz.min(0).tolist(), "max": xyz.max(0).tolist(),
    }]
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": len(buffers[0])}]
    if rgb is not None:
        rgb = np.asarray(rgb, np.float32)
        off = sum(len(b) for b in buffers)
        buffers.append(rgb.tobytes())
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(buffers[-1])})
        accessors.append({"bufferView": 1, "componentType": 5126,
                          "count": int(len(rgb)), "type": "VEC3"})
        attributes["COLOR_0"] = 1
    _write_glb(path, buffers, views, accessors,
               {"attributes": attributes, "mode": 0})


def save_mesh_glb(path: str, vertices: np.ndarray, faces: np.ndarray,
                  vertex_colors: Optional[np.ndarray] = None):
    """Minimal glTF 2.0 binary triangle mesh (mode 4)."""
    v = np.asarray(vertices, np.float32)
    f_idx = np.asarray(faces, np.uint32).reshape(-1)
    blobs = [v.tobytes(), f_idx.tobytes()]
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": len(blobs[0])},
             {"buffer": 0, "byteOffset": len(blobs[0]),
              "byteLength": len(blobs[1])}]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": int(len(v)),
         "type": "VEC3", "min": v.min(0).tolist(), "max": v.max(0).tolist()},
        {"bufferView": 1, "componentType": 5125, "count": int(len(f_idx)),
         "type": "SCALAR"},
    ]
    attributes = {"POSITION": 0}
    if vertex_colors is not None:
        c = np.asarray(vertex_colors, np.float32)
        views.append({"buffer": 0, "byteOffset": sum(len(b) for b in blobs),
                      "byteLength": len(c.tobytes())})
        blobs.append(c.tobytes())
        accessors.append({"bufferView": 2, "componentType": 5126,
                          "count": int(len(c)), "type": "VEC3"})
        attributes["COLOR_0"] = 2
    _write_glb(path, blobs, views, accessors,
               {"attributes": attributes, "indices": 1, "mode": 4})
