"""Measurement tools of the port's rasterizer: `rasterizer_timing`
(phases and frame times of every rasterizer entry point), `bench` (rays/s
of the production render) and `kernel_stages` (the grouped kernel cut off
stage by stage). Each runs as `python -m gaussiananything_tpu_torch.tools.X`
on the card, or with `--device cpu` at a small shape."""
