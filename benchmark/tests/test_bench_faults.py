"""A run with the timed path broken underneath comes out not correct:
the run's look for a card skipped, tiny widths on the CPU, one fault of
each kind the image-to-3D cell can have. (It has no exchange between
chips: it runs on one.)"""
import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import checkout

SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return checkout(str(tmp_path_factory.mktemp("faults")))


def _run(root):
    rec, _ = run.run_cell(root, "i23d-release.image", SEED, 0.05, False,
                          device="cpu")
    return rec


def _failed(rec):
    return sorted(n for n, v, lim in rec["checks"] if not v <= lim)


def test_sound_run_is_correct(root):
    assert _run(root)["correct"]


def test_step_that_returns_its_state(root, monkeypatch):
    from gaussiananything_tpu_torch.diffusion import sampling
    from gaussiananything_tpu_torch.train import fm_trainer

    def stuck(velocity_fn, x0, num_steps=250, method="heun"):
        calls = {"n": 0}

        def v(x, t):
            calls["n"] += 1
            out = velocity_fn(x, t)
            # the third call's step, k = 1, leaves x as it found it
            return torch.zeros_like(out) if calls["n"] in (3, 4) else out
        return sampling.sample_ode(v, x0, num_steps, method)

    monkeypatch.setattr(fm_trainer, "sample_ode", stuck)
    rec = _run(root)
    assert not rec["correct"] and "heun_update" in _failed(rec)


def test_half_the_batch_left_out(root, monkeypatch):
    """CFG's batch of two with the unconditional half dropped: the
    conditional velocity alone."""
    from gaussiananything_tpu_torch.train import fm_trainer

    def half(velocity_fn, cond, uncond, scale):
        c2 = type(cond)(*(torch.cat([a, b]) for a, b in zip(cond, uncond)))

        def guided(x, t):
            v_c, _ = velocity_fn(torch.cat([x, x]), torch.cat([t, t]),
                                 c2).chunk(2)
            return v_c
        return guided

    monkeypatch.setattr(fm_trainer, "cfg_velocity_fn", half)
    rec = _run(root)
    assert not rec["correct"] and "velocity" in _failed(rec)


def test_gaussians_altered_where_produced(root, monkeypatch):
    from gaussiananything_tpu_torch.models import vae
    decode = vae.PointVAE.decode

    def altered(self, z, anchors):
        lods = decode(self, z, anchors)
        lods[2] = lods[2].clone()
        lods[2][..., 3] += 0.05          # every opacity of one LoD
        return lods

    monkeypatch.setattr(vae.PointVAE, "decode", altered)
    rec = _run(root)
    assert not rec["correct"] and "decode" in _failed(rec)


def test_render_altered_where_produced(root, monkeypatch):
    from gaussiananything_tpu_torch.cli import sample
    render = sample.render_multiview

    def altered(*a, **kw):
        out = render(*a, **kw)
        out["image"] = out["image"].clone()
        out["image"][0, 3, :, 4:12, 4:12] = 0.0
        return out

    monkeypatch.setattr(sample, "render_multiview", altered)
    rec = _run(root)
    assert not rec["correct"] and "render" in _failed(rec)


def test_conditioner_altered_where_produced(root, monkeypatch):
    from gaussiananything_tpu_torch.models import conditioner
    fwd = conditioner.ImageConditioner.forward

    def altered(self, images, *a, **kw):
        c = fwd(self, images, *a, **kw)
        return c._replace(crossattn=c.crossattn * 1.05)

    monkeypatch.setattr(conditioner.ImageConditioner, "forward", altered)
    rec = _run(root)
    assert not rec["correct"] and "cond_tokens" in _failed(rec)
