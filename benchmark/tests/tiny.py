"""Small-width copies of the benchmark's cells for CPU tests: a checkout
of the benchmark's data files in a temporary directory, with each
configuration cut to tiny widths."""
from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {
    "i23d-release": {
        "conditioner": dict(width=64, depth=2, heads=4, img_size=56),
        "dit1": dict(width=64, depth=2, heads=4, cond_dim=64, vector_dim=64),
        "dit2": dict(width=64, depth=2, heads=4, cond_dim=64, vector_dim=64),
        "vae": dict(latent_num=24, decoder_width=64, decoder_depth=2,
                    decoder_heads=4, up_factors=[2, 2, 2],
                    up_depths=[1, 1, 1]),
        "sampler": dict(num_steps=2),
        "render": dict(output_size=32, max_per_tile=256, chunk=64),
    },
    "vae-release": {
        "vae": dict(latent_num=24, decoder_width=64, decoder_depth=2,
                    decoder_heads=4, up_factors=[2, 2, 2],
                    up_depths=[1, 1, 1]),
        "data": dict(n_views_in=1, n_views_sup=1, resolution=32,
                     n_points=64),
        # max_per_tile and chunk stay the trainer's own (1024, 128)
        "render": dict(lod_resolutions=[16, 16, 16, 32]),
        "batch": 2,
    },
}
TINY_TRAFFIC = {"vae-release.train": dict(instances=2, views=4,
                                          points_stored=128)}


def tiny_config(name: str) -> dict:
    with open(os.path.join(REPO, "benchmark", "configs", name + ".json")) as f:
        cfg = json.load(f)
    for part, over in TINY[name].items():
        if isinstance(over, dict):
            cfg[part].update(over)
        else:
            cfg[part] = over
    return cfg


def checkout(tmp: str, tiny: bool = True) -> str:
    """BENCHMARK.json, with the entries of the cells queued under
    `benchmark/queued/`, and the benchmark's data files under `tmp`, each
    configuration at tiny widths unless not `tiny`; returns the root."""
    root = os.path.join(tmp, "checkout")
    os.makedirs(os.path.join(root, "benchmark"))
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(REPO, "benchmark", d),
                        os.path.join(root, "benchmark", d))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    # the queued cells' entries too, so that their code stays tested
    queued = os.path.join(REPO, "benchmark", "queued")
    for name in sorted(os.listdir(queued)):
        with open(os.path.join(queued, name)) as f:
            q = json.load(f)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            spec[key] += q[key]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    if not tiny:
        return root
    for name in TINY:
        with open(os.path.join(root, "benchmark", "configs",
                               name + ".json"), "w") as f:
            json.dump(tiny_config(name), f)
    for name, over in TINY_TRAFFIC.items():
        path = os.path.join(root, "benchmark", "traffic", name + ".json")
        with open(path) as f:
            traffic = json.load(f)
        traffic.update(over)
        with open(path, "w") as f:
            json.dump(traffic, f)
    return root
