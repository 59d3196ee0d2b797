"""Real conditioning images (port of `gaussiananything_tpu/data/real.py`).

`RealDataset` parity (`datasets/g_buffer_objaverse.py:4570,4692`): a folder
of images becomes (3, S, S) conditioning arrays. The reference removes the
background with rembg, a U²-Net (`utils/infer_utils.py:4,27`): pass a
`models/matting.U2Net` (or, to the dataset, its weights as an npz in the
JAX package's layout). Without one, a corner chroma key composites the
foreground on white (`utils/infer_utils.py:70`). PIL does the resizing.
"""
from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional

import numpy as np
import torch


def remove_background(img: np.ndarray, thresh: float = 0.12,
                      matting_net=None) -> np.ndarray:
    """(H, W, 3) float in [0, 1] → the foreground composited on white:
    with `matting_net` (a `U2Net`) by its soft alpha, else by a corner
    chroma key."""
    if matting_net is not None:
        from gaussiananything_tpu_torch.models.matting import matting_alpha
        dev = next(matting_net.parameters()).device
        a = matting_alpha(matting_net, torch.from_numpy(
            np.ascontiguousarray(img)).to(dev)).cpu().numpy()[..., None]
        return (img * a + (1 - a)).astype(img.dtype)
    corner = np.median(
        np.concatenate([img[:5, :5].reshape(-1, 3),
                        img[:5, -5:].reshape(-1, 3),
                        img[-5:, :5].reshape(-1, 3),
                        img[-5:, -5:].reshape(-1, 3)]), axis=0)
    dist = np.linalg.norm(img - corner, axis=-1)
    fg = (dist > thresh)[..., None].astype(img.dtype)
    return img * fg + (1 - fg)


def resize_foreground(img: np.ndarray, ratio: float = 0.85) -> np.ndarray:
    """Centre the foreground's box on a white square it fills to `ratio`."""
    fg = np.any(np.abs(img - 1.0) > 0.02, axis=-1)
    ys, xs = np.where(fg)
    if len(ys) == 0:
        return img
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    crop = img[y0:y1, x0:x1]
    h, w = crop.shape[:2]
    side = int(max(h, w) / ratio)
    canvas = np.ones((side, side, 3), img.dtype)
    oy, ox = (side - h) // 2, (side - w) // 2
    canvas[oy:oy + h, ox:ox + w] = crop
    return canvas


def resize_square(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) float in [0, 1] → (size, size, 3) through uint8 and PIL's
    default resampling, as the JAX package does."""
    from PIL import Image
    return np.asarray(
        Image.fromarray((img * 255).astype(np.uint8)).resize((size, size)),
        np.float32) / 255.0


def load_matting_net(npz_path: str, device="cpu"):
    """A full `U2Net` with the weights of an npz in the JAX package's
    layout (bare or wrapped in {"params": ...})."""
    from gaussiananything_tpu_torch.models.matting import u2net
    from gaussiananything_tpu_torch.utils.param_io import (from_jax_params,
                                                           load_params_npz)
    net = u2net()
    net.load_state_dict(from_jax_params(load_params_npz(npz_path), net))
    return net.to(device).eval()


class RealImageDataset:
    """Folder of images → preprocessed (3, S, S) float32 arrays."""

    def __init__(self, image_dir: str, img_size: int = 224,
                 remove_bg: bool = True,
                 matting_npz: Optional[str] = None, device="cpu"):
        exts = ("*.png", "*.jpg", "*.jpeg", "*.webp")
        self.paths: List[str] = sorted(
            p for e in exts for p in glob.glob(os.path.join(image_dir, e)))
        if not self.paths:
            raise FileNotFoundError(f"no images in {image_dir}")
        self.img_size = img_size
        self.remove_bg = remove_bg
        self.matting_net = (load_matting_net(matting_npz, device)
                            if matting_npz else None)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        from PIL import Image
        img = np.asarray(
            Image.open(self.paths[i]).convert("RGB"), np.float32) / 255.0
        if self.remove_bg:
            img = remove_background(img, matting_net=self.matting_net)
            img = resize_foreground(img)
        return np.moveaxis(resize_square(img, self.img_size), -1, 0)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]
