"""Multi-view g-buffer dataset (port of
`gaussiananything_tpu/data/gbuffer.py`).

`MultiViewObjverseDataset` and its chunked variants
(`datasets/g_buffer_objaverse.py:2173,2941`): per-instance multi-view
renders with rgb, normal, depth, 25-dim poses and a surface point cloud;
each sample draws views of one instance, splits them into input and
supervision views (`split_chunk_size=16 → 8+8`, `:109`) and assembles the
15-channel encoder input with `data.postprocess`. A batch's drawn views
are sent to its device as stored and converted there, to the values
`load_instance` gives.

On disk, one `{instance}.npz` per asset (`pack_instance`):
    rgb     (V, H, W, 3) uint8
    normal  (V, H, W, 3) float16    (world-space unit normals)
    depth   (V, H, W)    float16
    alpha   (V, H, W)    uint8
    pose    (V, 25)      float32
    pcd     (P, 3)       float32

The draws are the JAX package's, from `np.random.default_rng(seed +
shard[0])`, so both packages make the same batches from the same files.
Unlike the JAX package's, a batch keeps each supervision view's own
`tanfov` (B, V_sup): datasets whose views differ in their intrinsics
supervise each view with its own field of view.
"""
from __future__ import annotations

import collections
import glob
import io
import os
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from gaussiananything_tpu_torch.data.postprocess import (
    assemble_encoder_input, canonicalize_poses, canonicalize_pts)
from gaussiananything_tpu_torch.render import cameras


def pack_instance(path: str, rgb: np.ndarray, normal: np.ndarray,
                  depth: np.ndarray, alpha: np.ndarray, pose: np.ndarray,
                  pcd: np.ndarray):
    """Write one instance; `alpha` in [0, 1] is scaled to 0..255."""
    np.savez_compressed(
        path, rgb=rgb.astype(np.uint8),
        normal=normal.astype(np.float16), depth=depth.astype(np.float16),
        alpha=(alpha * 255).astype(np.uint8) if alpha.max() <= 1.0
        else alpha.astype(np.uint8),
        pose=pose.astype(np.float32), pcd=pcd.astype(np.float32))


def load_instance(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {
            "rgb": z["rgb"].astype(np.float32) / 255.0,
            "normal": z["normal"].astype(np.float32),
            "depth": z["depth"].astype(np.float32),
            "alpha": z["alpha"].astype(np.float32) / 255.0,
            "pose": z["pose"].astype(np.float32),
            "pcd": z["pcd"].astype(np.float32),
        }


def _read_members(path: str, names) -> Dict[str, np.ndarray]:
    """Arrays of an npz (read-only), each member inflated by one call:
    zlib then lets go of the GIL for the whole member. `np.load` inflates
    a member in 256 KiB pieces and takes the GIL back after each, so a
    decoding thread waits on a busy main thread at every piece."""
    header = {(1, 0): np.lib.format.read_array_header_1_0,
              (2, 0): np.lib.format.read_array_header_2_0}
    out = {}
    with zipfile.ZipFile(path) as zf:
        for n in names:
            raw = zf.read(n + ".npy")
            f = io.BytesIO(raw)
            shape, fortran, dtype = header[np.lib.format.read_magic(f)](f)
            out[n] = np.frombuffer(raw, dtype, offset=f.tell()).reshape(
                shape, order="F" if fortran else "C")
    return out


# a sample's maps stored as 0..255, which `load_instance` takes over 255
_OVER_255 = ("rgb_in", "alpha_in", "images_sup", "alpha_sup")


def _as_float32(t: torch.Tensor, over_255: bool) -> torch.Tensor:
    """A stored map as `load_instance` converts it, on `t`'s device."""
    x = t.to(torch.float32)
    if not over_255:
        return x
    # a tensor divisor: CUDA divides by a Python number through its
    # reciprocal, which is not numpy's float32 division
    return x / torch.full((), 255.0, device=x.device)


def _assemble_batch(rgb_in, normal_in, depth_in, alpha_in, pose_in,
                    pose_sup, pcd, canonicalize: bool):
    """Encoder input, supervision cameras and point cloud of a stacked
    batch. `canonicalize` (frame_0_as_canonical,
    `datasets/g_buffer_objaverse.py:355-399`) rebases every pose of a
    sample and its point cloud by the ONE transform that sends its input
    view 0 to the canonical camera, so the supervision views keep seeing
    the same scene."""
    if canonicalize:
        v_in = pose_in.shape[1]
        pcd = torch.stack([canonicalize_pts(p, c)
                           for p, c in zip(pose_in, pcd)])
        joint = torch.stack([canonicalize_poses(j) for j in
                             torch.cat([pose_in, pose_sup], dim=1)])
        pose_in, pose_sup = joint[:, :v_in], joint[:, v_in:]
    imgs_in = assemble_encoder_input(rgb_in, normal_in, depth_in, alpha_in,
                                     pose_in)
    cam = cameras.pose_to_gs_camera(pose_sup, device=pose_sup.device)
    return imgs_in, cam, pcd


class MultiViewDataset:
    """Random-view multi-view batches from a directory of packed instances,
    assembled on `device`."""

    def __init__(self, data_dir: str, n_views_in: int = 4,
                 n_views_sup: int = 4, n_points: int = 4096,
                 resolution: Optional[int] = None,
                 shard: Tuple[int, int] = (0, 1), seed: int = 0,
                 files: Optional[List[str]] = None,
                 canonicalize: bool = False, device="cpu"):
        """`files`: the instance list (default: the directory's `*.npz`),
        of which shard (i, n) takes every n-th from i — train and held-out
        splits of one directory. `resolution`: nearest-index resize of
        every map. `canonicalize`: the frame-0 rebase of each sample's
        poses and point cloud."""
        if files is None:
            files = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
        self.files = files[shard[0]::shard[1]]
        if not self.files:
            raise ValueError(f"no instances under {data_dir} for shard "
                             f"{shard}")
        self.n_in = n_views_in
        self.n_sup = n_views_sup
        self.n_points = n_points
        self.resolution = resolution
        self.canonicalize = canonicalize
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed + shard[0])

    @staticmethod
    def caption_for(npz_path: str) -> str:
        """The caption sidecar `<name>.caption.txt` beside `<name>.npz`;
        '' if absent."""
        cap = npz_path[:-4] + ".caption.txt"
        if os.path.exists(cap):
            with open(cap, encoding="utf-8") as f:
                return f.read().strip()
        return ""

    def _plan(self) -> Dict:
        """A sample's random draws, in their order: the instance, its
        views, its points (read here: they are small). `_load` decodes
        the maps."""
        path = self.files[self.rng.integers(len(self.files))]
        z = _read_members(path, ("pose", "pcd"))
        V = z["pose"].shape[0]
        k = self.n_in + self.n_sup
        views = self.rng.choice(V, k, replace=V < k)
        pose = z["pose"][views].astype(np.float32)
        pcd = z["pcd"].astype(np.float32)
        if len(pcd) >= self.n_points:
            pcd = pcd[self.rng.choice(len(pcd), self.n_points, replace=False)]
        else:
            pcd = pcd[self.rng.choice(len(pcd), self.n_points)]
        return {"path": path, "views": views, "pose": pose, "pcd": pcd}

    def _load(self, plan: Dict) -> Dict[str, np.ndarray]:
        """A planned sample with its maps: the drawn views alone, in the
        order drawn and as stored (`_to_device` converts them)."""
        views = plan["views"]
        z = _read_members(plan["path"], ("rgb", "normal", "depth", "alpha"))
        rgb, normal = (np.moveaxis(z[n][views], -1, -3)
                       for n in ("rgb", "normal"))
        depth, alpha = (z[n][views][:, None] for n in ("depth", "alpha"))
        vin, vsup = slice(None, self.n_in), slice(self.n_in, None)
        if self.resolution and rgb.shape[-1] != self.resolution:
            yi = (np.arange(self.resolution) * rgb.shape[-1]) \
                // self.resolution
            rgb, normal, depth, alpha = (
                x[..., yi[:, None], yi[None, :]]
                for x in (rgb, normal, depth, alpha))
        pose = plan["pose"]
        return {
            "rgb_in": rgb[vin], "normal_in": normal[vin],
            "depth_in": depth[vin], "alpha_in": alpha[vin],
            "pose_in": pose[vin],
            "images_sup": rgb[vsup], "alpha_sup": alpha[vsup],
            "depth_sup": depth[vsup], "pose_sup": pose[vsup],
            "pcd": plan["pcd"], "caption": self.caption_for(plan["path"]),
        }

    def _to_device(self, samples: List[Dict]) -> Dict[str, torch.Tensor]:
        """Loaded samples stacked, converted and assembled on
        `self.device` (`batch`'s schema)."""
        captions = [s.pop("caption") for s in samples]
        t = {k: _as_float32(torch.from_numpy(np.stack(
            [s[k] for s in samples])).to(self.device), k in _OVER_255)
            for k in samples[0]}
        imgs_in, cam, pcd = _assemble_batch(
            t["rgb_in"], t["normal_in"], t["depth_in"], t["alpha_in"],
            t["pose_in"], t["pose_sup"], t["pcd"], self.canonicalize)
        return {
            "images_in": imgs_in,
            "pcd": pcd,
            "cam_view": cam["cam_view"],
            "cam_view_proj": cam["cam_view_proj"],
            "cam_pos": cam["cam_pos"],
            "tanfov": cam["tanfov"],
            "images_sup": t["images_sup"],
            "alpha_sup": t["alpha_sup"],
            "depth_sup": t["depth_sup"],
            "caption": captions,
        }

    def batch(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The trainer's batch schema on `self.device`, plus `cam_pos`,
        the per-view `tanfov` (B, V_sup) and `caption` (a list)."""
        return self._to_device([self._load(self._plan())
                                for _ in range(batch_size)])

    def iterator(self, batch_size: int, prefetch: int = 2, workers: int = 1
                 ) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches whose maps `workers` background threads decode,
        `prefetch` batches ahead, so that decoding overlaps the step (zlib
        lets go of the GIL while it inflates). The random draws are made
        here, in turn, and each batch is put on the device here, when it
        is taken: the sequence is that of calling `batch` in turn, and
        only the caller's thread launches device work. An error in a
        thread is raised here."""
        pool = ThreadPoolExecutor(workers)
        ahead: collections.deque = collections.deque()
        try:
            while True:
                while len(ahead) < max(prefetch, 1):
                    ahead.append([pool.submit(self._load, self._plan())
                                  for _ in range(batch_size)])
                yield self._to_device([f.result() for f in ahead.popleft()])
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def export_synthetic_dataset(out_dir: str, n_instances: int = 8,
                             n_views: int = 12, res: int = 128,
                             n_splats: int = 1024, seed: int = 0,
                             device="cpu"):
    """Write procedural scenes in the npz layout above (the JAX package's
    draws): objects from `make_object`, views rendered on `device` through
    the forward-only rasterizer, so the dataset path runs without
    Objaverse."""
    from gaussiananything_tpu_torch.data.synthetic import (make_object,
                                                           render_scene_views)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_instances):
        g = make_object(seed * 997 + i, n=n_splats, device=device)
        poses = cameras.generate_input_camera(
            1.8, [(rng.uniform(-30, 60), rng.uniform(0, 360))
                  for _ in range(n_views)])
        with torch.no_grad():
            maps = {k: v.cpu().numpy()
                    for k, v in render_scene_views(g, poses, res).items()}
        pack_instance(
            os.path.join(out_dir, f"{i:05d}.npz"),
            rgb=np.moveaxis(maps["image"], 1, -1) * 255,
            normal=np.moveaxis(maps["rend_normal"], 1, -1),
            depth=maps["depth"][:, 0], alpha=maps["alpha"][:, 0] * 255,
            pose=poses, pcd=g[:, :3].cpu().numpy())
