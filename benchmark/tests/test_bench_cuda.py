"""On the card, at each cell's own size: the control (the reference one
step below the configuration, in the program's place:
`reference/precision.control`) comes out not correct on three seeds; the
queued training cell's control and planted faults print their readings
(a checkout with the queued cells' entries). Marked `cuda`; run on the
chip with

    python -m pytest -m cuda benchmark/tests/test_bench_cuda.py

It skips without a card."""
import json

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import REPO, checkout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs on the "
                    "card")


@pytest.fixture
def queued(tmp_path):
    return checkout(str(tmp_path), tiny=False)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202,
                                  2 ** 31 + 303])
def test_control_is_not_correct(card, seed):
    rec, _ = run.run_cell(REPO, "i23d-release.image", seed, 1.0, False,
                          control=True)
    print("CONTROL i23d-release.image", seed, json.dumps(rec["read"]))
    assert not rec["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202,
                                  2 ** 31 + 303])
def test_queued_train_control(card, queued, seed):
    """The training cell's control: its readings (no number of the
    queued cell's check separates it from sound runs yet)."""
    rec, _ = run.run_cell(queued, "vae-release.train", seed, 1.0, False,
                          control=True)
    print("CONTROL vae-release.train", seed, json.dumps(rec["read"]))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 404, 2 ** 31 + 505,
                                  2 ** 31 + 606])
def test_half_batch_is_not_correct(card, queued, seed, monkeypatch):
    """The training step with half of its batch left out, the mean taken
    over the rest, planted in the program: its readings are the loss's
    upper one."""
    from gaussiananything_tpu_torch.train import vae_trainer
    loss_fn = vae_trainer.vae_loss_fn

    def half(model, batch, *a, **kw):
        b = batch["images_in"].shape[0] // 2
        return loss_fn(model, {k: v[:b] if torch.is_tensor(v) and v.dim()
                               else v for k, v in batch.items()}, *a, **kw)

    monkeypatch.setattr(vae_trainer, "vae_loss_fn", half)
    rec, _ = run.run_cell(queued, "vae-release.train", seed, 1.0, False)
    print("HALF-BATCH", seed, json.dumps(rec["read"]))
    assert not rec["correct"]


@pytest.mark.cuda
def test_render_altered_is_not_correct(card, queued, monkeypatch):
    """The training renders' images altered where they are produced: each
    sample gets its neighbour's images."""
    from gaussiananything_tpu_torch.train import vae_trainer
    render = vae_trainer.render_multiview

    def altered(*a, **kw):
        out = dict(render(*a, **kw))
        out["image"] = out["image"].roll(1, dims=0)
        return out

    monkeypatch.setattr(vae_trainer, "render_multiview", altered)
    rec, _ = run.run_cell(queued, "vae-release.train", 2 ** 31 + 707, 1.0,
                          False)
    print("RENDER-ALTERED", json.dumps(rec["read"]))
    assert not rec["correct"]
