"""GaussianAnything in PyTorch and CUDA for NVIDIA Hopper.

The port mirrors `gaussiananything_tpu`'s layout (`ops/`, `render/`,
`models/`, `train/`, `utils/`, `data/`, `cli/`) so every module has an
obvious counterpart; it imports torch, numpy and the standard library only.
Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
