"""Gradient accumulation on a data mesh (`shard_batch(..., micro=n)`, the
trainers' `accum` with `mesh`) on the CPU over gloo: two ranks, two
micro-batches, two steps (the first at the warm-up's lr 0, the second at
the full lr), from the same weights, global batch and per-micro-batch
draws as the port's unsharded step and the JAX package's step on a
2-device CPU mesh.

  * The flow-matching step (`make_fm_train_step`, a stage-1 DiT and a
    trained image conditioner; tests/test_torch_fm_training.py's widths)
    and the VAE step (`make_accum_train_step`, the full loss with the
    depth term, whose ratio of sums runs over each global micro-batch,
    and the perceptual term; tests/test_torch_parallel.py's widths).
  * Against the port's unsharded step: tests/test_torch_parallel.py's
    tolerances (total / fm_loss rtol 1e-5, grad_norm rtol 1e-4, atol
    1e-6; the second update within 0.5 lr).
  * Against JAX's step (its batch sharded over two devices): the
    port-vs-JAX training tolerances (rtol 2e-3 on the losses, 5e-3 on
    grad_norm at the first step, 1e-2 after it; atol 1e-5).
  * A witness: the same two ranks fed the global batch reordered so
    that each rank's rows are one block (`torch_dist_workers.block_order`:
    the rows `shard_batch(..., micro=1)` gives, the layout before the
    steps laid out their micro-batches) miss the unsharded step by more
    than those tolerances.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.diffusion.transport import \
    create_transport as jcreate_transport
from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.parallel import mesh as jmesh
from gaussiananything_tpu.train import fm_trainer as jfm
from gaussiananything_tpu.train import state as jstate
from gaussiananything_tpu.train import vae_trainer as jtrainer
from gaussiananything_tpu_torch.data.synthetic import make_batch
from gaussiananything_tpu_torch.diffusion.transport import create_transport
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.parallel.mesh import Mesh, shard_batch
from gaussiananything_tpu_torch.train import fm_trainer as fm
from gaussiananything_tpu_torch.train import state as pstate
from gaussiananything_tpu_torch.train import vae_trainer as ptrainer
from gaussiananything_tpu_torch.utils.param_io import from_jax_params
from test_torch_fm_training import (COND, DIT, IMG, K, _batch, _init,
                                    _jax_draws, _jax_grad_norm)
from test_torch_training import _jax_draws as _jax_vae_draws
from test_torch_training import _jax_perceptual_net

import torch_dist_workers as workers

torch.set_num_threads(2)

RANKS, ACCUM, STEPS = 2, 2, 2
TX = dict(lr=1e-4, warmup_steps=1)      # the second update at the full lr
VAE_SIZES = dict(latent_num=16, z_channels=4, encoder_width=64,
                 decoder_width=64, decoder_heads=4, decoder_depth=2,
                 up_factors=(4,), up_depths=(1,))
VAE_LOSS = dict(lod_resolutions=(32, 32), perceptual_weight=0.5,
                dist_start_step=0, normal_start_step=0)
VAE_BATCH = 4
LOSS_KEY = {"fm": "fm_loss", "vae": "total"}


def _step_rngs():
    return [jax.random.fold_in(jax.random.PRNGKey(7), i)
            for i in range(STEPS)]


def _jax_mesh():
    return jmesh.make_mesh(data=RANKS, tile=1,
                           devices=jax.devices()[:RANKS])


@pytest.fixture(scope="module")
def fm_steps(tmp_path_factory):
    """The flow-matching step on the two ranks in both layouts (started
    first), unsharded in the port, and JAX's on its sharded batch."""
    tmp = tmp_path_factory.mktemp("fm_accum")
    batch = _batch(1)
    n = batch["latent"].shape[0]
    jc, pc, jd, pd, cp, dp = _init(1, batch)
    draws = [_jax_draws(r, ACCUM, n // ACCUM, (K, 3), COND["ucg_rate"])
             for r in _step_rngs()]
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    inputs, out = tmp / "in.pt", tmp / "out.pt"
    torch.save({"kind": "fm", "dit": DIT, "dit_weights": pd.state_dict(),
                "cond": dict(COND, img_size=IMG, backbone="scratch"),
                "cond_weights": pc.state_dict(), "tx": TX, "accum": ACCUM,
                "batch": pbatch, "draws": draws,
                "layouts": ("micro", "block")}, inputs)
    ranks = workers.start(workers.accum_step, RANKS, str(inputs), str(out))

    mesh = _jax_mesh()
    jcfg = jstate.TrainStateConfig(**TX)
    tx = jstate.make_optimizer(jcfg)
    jstep = jfm.make_fm_train_step(jd, jc, jcreate_transport(),
                                   jfm.FMConfig(stage=1), jcfg,
                                   train_conditioner=True, accum=ACCUM)
    js = jstate.TrainState.create(jmesh.replicate(mesh, dp), tx)
    jcs = jstate.TrainState.create(jmesh.replicate(mesh, cp), tx)
    jb = jmesh.shard_batch(mesh, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    jlogs = []
    for r in _step_rngs():
        js, jcs, jl = jstep(js, jcs, jb, r)
        jlogs.append({k: float(v) for k, v in jl.items()})
    norm0 = _jax_grad_norm(jd, jc, dp, cp,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           _step_rngs()[0], 1, ACCUM, True)
    ps, pcs = pstate.TrainState.create(pd), pstate.TrainState.create(pc)
    pstep = fm.make_fm_train_step(pd, pc, create_transport(),
                                  fm.FMConfig(stage=1),
                                  pstate.TrainStateConfig(**TX), accum=ACCUM)
    plogs = [{k: float(v) for k, v in pstep(ps, pcs, pbatch,
                                            draws=d).items()}
             for d in draws]
    while not ranks.join():
        pass
    return dict(kind="fm", ranks=torch.load(out), unsharded=plogs,
                unsharded_params=ps.params, jax=jlogs, jax_norm0=norm0)


@pytest.fixture(scope="module")
def vae_steps(tmp_path_factory):
    """The VAE accumulation step on the two ranks in both layouts (started
    first), unsharded in the port, and JAX's on a 2 × 1 mesh."""
    tmp = tmp_path_factory.mktemp("vae_accum")
    pbatch = {k: v for k, v in make_batch(
        seed=3, batch=VAE_BATCH, n_views_in=2, n_views_sup=2, res=32,
        n_pts=128, n_splats=256).items()
        if k not in ("gt_gaussians", "caption")}
    assert "depth_sup" in pbatch
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in pbatch.items()}
    jm = JPointVAE(**VAE_SIZES)
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(jm.init)(key, jbatch["images_in"][:1],
                               jbatch["pcd"][:1], key)
    psizes = dict(VAE_SIZES, release_parity=False, with_encoder=True)
    pm = PointVAE(**psizes)
    pm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams),
                                       pm))
    mb = VAE_BATCH // ACCUM
    latent = (mb, VAE_SIZES["latent_num"], VAE_SIZES["z_channels"])
    draws = [[_jax_vae_draws(jax.random.fold_in(r, i),
                             len(VAE_LOSS["lod_resolutions"]), latent)
              for i in range(ACCUM)] for r in _step_rngs()]
    net = _jax_perceptual_net()
    inputs, out = tmp / "in.pt", tmp / "out.pt"
    torch.save({"kind": "vae", "sizes": psizes, "weights": pm.state_dict(),
                "perceptual": net.state_dict(), "loss": VAE_LOSS, "tx": TX,
                "accum": ACCUM, "batch": pbatch, "draws": draws,
                "layouts": ("micro", "block")}, inputs)
    ranks = workers.start(workers.accum_step, RANKS, str(inputs), str(out))

    mesh = _jax_mesh()
    jcfg = jstate.TrainStateConfig(**TX)
    sh = jmesh.shard_batch(mesh, {k: v for k, v in jbatch.items()
                                  if k != "tanfov"})
    sh["tanfov"] = jbatch["tanfov"]
    jstep = jtrainer.make_accum_train_step(
        jm, jtrainer.VAELossConfig(**VAE_LOSS), ACCUM, tx_cfg=jcfg,
        mesh=mesh)
    js = jstate.TrainState.create(jmesh.replicate(mesh, jparams),
                                  jstate.make_optimizer(jcfg))
    jlogs = []
    for r in _step_rngs():
        js, jl = jstep(js, sh, r)
        jlogs.append({k: float(v) for k, v in jl.items()})
    ps = pstate.TrainState.create(pm)
    pstep = ptrainer.make_accum_train_step(
        pm, ptrainer.VAELossConfig(**VAE_LOSS), ACCUM,
        pstate.TrainStateConfig(**TX), perceptual_net=net)
    plogs = [{k: float(v) for k, v in pstep(ps, pbatch, draws=d).items()}
             for d in draws]
    while not ranks.join():
        pass
    return dict(kind="vae", ranks=torch.load(out), unsharded=plogs,
                unsharded_params=ps.params, jax=jlogs)


@pytest.fixture(params=["fm", "vae"])
def steps(request):
    return request.getfixturevalue(f"{request.param}_steps")


def _close(got, want, rtol, atol=1e-6):
    return abs(got - want) <= atol + rtol * abs(want)


def test_shard_batch_gives_each_rank_its_slice_of_every_micro_batch():
    """Rank r's micro-batch i is rows [i·B/n + r·B/(n·R), ...) of the
    global batch: the ranks' micro-batches i, joined in rank order, are
    the global micro-batch i; `micro` 1 keeps one block per rank; a batch
    the micro-batches and slices do not split is refused."""
    x = np.arange(24 * 2).reshape(24, 2)
    for R, n in ((2, 2), (2, 3), (3, 4), (4, 1), (1, 3)):
        mb = 24 // n
        shards = [shard_batch(Mesh(R, 1, rank=r), {"x": torch.from_numpy(x),
                                                    "a": x, "s": 5},
                              micro=n) for r in range(R)]
        for s in shards:
            assert s["s"] == 5
            assert np.array_equal(s["x"].numpy(), s["a"])
        for i in range(n):
            joined = np.concatenate([s["a"][i * mb // R:(i + 1) * mb // R]
                                     for s in shards])
            assert np.array_equal(joined, x[i * mb:(i + 1) * mb]), (R, n, i)
    block = shard_batch(Mesh(2, 2, rank=3), x)
    assert np.array_equal(block, x[12:])
    with pytest.raises(ValueError, match="micro-batches"):
        shard_batch(Mesh(2, 1, rank=0), x, micro=5)


def test_block_order_gives_the_one_block_layout():
    """The witness's reordering: the step's layout of the reordered batch
    gives each rank the rows `micro` 1 gives it of the batch."""
    x = torch.arange(24 * 2).reshape(24, 2)
    for R, n in ((2, 2), (2, 3), (3, 4)):
        ordered = workers.block_order({"x": x, "s": torch.tensor(5)}, R, n)
        assert int(ordered["s"]) == 5
        for r in range(R):
            got = shard_batch(Mesh(R, 1, rank=r), ordered, micro=n)["x"]
            assert torch.equal(got, shard_batch(Mesh(R, 1, rank=r), x)), \
                (R, n, r)


def test_sharded_accumulation_equals_unsharded(steps):
    """Both steps' loss, t_mean where logged, every VAE log, and
    grad_norm, on rank 0, against the unsharded port's."""
    key = LOSS_KEY[steps["kind"]]
    got = steps["ranks"]["micro"]["logs"]
    for i, (g, ref) in enumerate(zip(got, steps["unsharded"])):
        assert set(g) == set(ref)
        print(f"{steps['kind']} step {i}: |Δ{key}| "
              f"{abs(g[key] - ref[key]):.3e}, |Δgrad_norm| "
              f"{abs(g['grad_norm'] - ref['grad_norm']):.3e}")
        np.testing.assert_allclose(g[key], ref[key], rtol=1e-5, atol=1e-6,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(g["grad_norm"], ref["grad_norm"],
                                   rtol=1e-4, atol=1e-6, err_msg=f"step {i}")
        for k in set(ref) - {key, "grad_norm"}:
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")


def test_sharded_accumulation_update_equals_unsharded(steps):
    """The second update (at the full lr) moves every parameter as the
    unsharded one does, within half a learning rate."""
    got = steps["ranks"]["micro"]["params"]
    for k, want in steps["unsharded_params"].items():
        d = float((got[k] - want.detach()).abs().max())
        assert d <= 0.5 * TX["lr"], (k, d)


def test_sharded_accumulation_equals_jax(steps):
    """Both steps' logs against JAX's step on its sharded batch (the flow
    step logs fm_loss and t_mean; its grad_norm is held against the norm
    of JAX's first averaged gradient)."""
    got = steps["ranks"]["micro"]["logs"]
    for i, (g, ref) in enumerate(zip(got, steps["jax"])):
        for k in ref:
            rtol = 1e-2 if i else (5e-3 if k == "grad_norm" else 2e-3)
            np.testing.assert_allclose(g[k], ref[k], rtol=rtol, atol=1e-5,
                                       err_msg=f"step {i} {k}")
    if steps["kind"] == "fm":
        np.testing.assert_allclose(got[0]["grad_norm"], steps["jax_norm0"],
                                   rtol=5e-3)


def test_block_layout_witness_misses_the_unsharded_step(steps):
    """With each rank's rows in one block, rows meet other draws and other
    rows share a micro-batch: the first step's loss and grad_norm both
    miss the unsharded step's by more than the tolerances above, so the
    tests above can see the fault."""
    key = LOSS_KEY[steps["kind"]]
    got = steps["ranks"]["block"]["logs"][0]
    ref = steps["unsharded"][0]
    print(f"{steps['kind']} block layout: |Δ{key}| "
          f"{abs(got[key] - ref[key]):.3e}, |Δgrad_norm| "
          f"{abs(got['grad_norm'] - ref['grad_norm']):.3e}")
    assert not _close(got[key], ref[key], 1e-5), (got[key], ref[key])
    assert not _close(got["grad_norm"], ref["grad_norm"], 1e-4), (
        got["grad_norm"], ref["grad_norm"])


def test_train_flow_refuses_a_batch_the_micro_batches_do_not_split(
        tmp_path):
    """`train_flow --batch 6 --accum 4` is refused before any model is
    built: the rows cannot be laid out as four micro-batches."""
    from gaussiananything_tpu_torch.cli import train_flow
    with pytest.raises(ValueError, match="4 micro-batches"):
        train_flow.main(["--device", "cpu", "--batch", "6", "--accum", "4",
                         "--steps", "1", "--logdir", str(tmp_path)])
    assert not os.listdir(tmp_path)
