"""The training cell's run with its timed path broken underneath comes
out not correct (tiny widths on the CPU, the run's look for a card
skipped): a step that leaves its state unchanged, half of the batch left
out with the mean taken over the rest, a rendered answer altered where it
is produced. (It has no exchange between chips: it runs on one.)"""
import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import checkout

SEED = 2 ** 31 + 9090
CELL = "vae-release.train"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return checkout(str(tmp_path_factory.mktemp("train_faults")))


def _failed(root):
    rec, _ = run.run_cell(root, CELL, SEED, 0.05, False, device="cpu")
    assert not rec["correct"], rec["checks"]
    return {n for n, v, lim in rec["checks"] if not v <= lim}


def test_state_left_unchanged(root, monkeypatch):
    from gaussiananything_tpu_torch.train.state import TrainState
    monkeypatch.setattr(TrainState, "apply_gradients",
                        lambda self, grads, cfg: None)
    assert {"grad1_median", "update2_median"} <= _failed(root)


def test_half_the_batch(root, monkeypatch):
    from gaussiananything_tpu_torch.train import vae_trainer
    loss_fn = vae_trainer.vae_loss_fn

    def half(model, batch, *a, **kw):
        b = batch["images_in"].shape[0] // 2
        return loss_fn(model, {k: v[:b] if torch.is_tensor(v) and v.dim()
                               else v for k, v in batch.items()}, *a, **kw)

    monkeypatch.setattr(vae_trainer, "vae_loss_fn", half)
    assert "loss" in _failed(root)


def test_render_altered(root, monkeypatch):
    from gaussiananything_tpu_torch.train import vae_trainer
    render = vae_trainer.render_multiview

    def altered(*a, **kw):
        out = dict(render(*a, **kw))
        out["image"] = out["image"].roll(1, dims=0)    # each sample's
        return out                                     # neighbour's image

    monkeypatch.setattr(vae_trainer, "render_multiview", altered)
    assert "loss" in _failed(root)
