"""The port's multi-rank training (`parallel/mesh.py`, `parallel/dist.py`,
the trainers' `mesh`) on the CPU over gloo, against the port's unsharded
steps and the JAX package's sharded ones.

  * The rank layout (rank r at (r // tile, r % tile)), `local_batch_slice`
    and `shard_batch` equal the JAX package's device layout and shards.
  * ONE spawn of four ranks (which also reports that layout) runs the
    VAE step on a 2 × 2 mesh (the full
    `vae_loss_fn` with the perceptual term and the regularisers from step
    0, the 32² renders in bands of 16 rows): against the port's unsharded
    step to the JAX tests' own tolerances (`tests/test_sharded_render.py:
    114-121`: total rtol 1e-5, grad_norm rtol 1e-4, atol 1e-6), and
    against JAX's 2 × 2 step to the port-vs-JAX training tolerances of
    tests/test_torch_training.py (first step: rtol 2e-3 on the logged
    terms, 5e-3 on grad_norm, atol 1e-5).
  * ONE spawn of two ranks runs the data-parallel flow-matching step,
    against the unsharded one (fm_loss rtol 1e-5, grad_norm rtol 1e-4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.models.vae import PointVAE as JPointVAE
from gaussiananything_tpu.parallel import dist as jdist
from gaussiananything_tpu.parallel import mesh as jmesh
from gaussiananything_tpu.train import state as jstate
from gaussiananything_tpu.train import vae_trainer as jtrainer
from gaussiananything_tpu_torch.data.synthetic import make_batch
from gaussiananything_tpu_torch.models.vae import PointVAE
from gaussiananything_tpu_torch.parallel import dist as pdist
from gaussiananything_tpu_torch.parallel.mesh import Mesh
from gaussiananything_tpu_torch.train import state as pstate
from gaussiananything_tpu_torch.train import vae_trainer as ptrainer
from gaussiananything_tpu_torch.utils.param_io import from_jax_params
from test_torch_training import _jax_draws, _jax_perceptual_net

import torch_dist_workers as workers

torch.set_num_threads(2)

SIZES = dict(latent_num=16, z_channels=4, encoder_width=64,
             decoder_width=64, decoder_heads=4, decoder_depth=2,
             up_factors=(4,), up_depths=(1,))
LOSS = dict(lod_resolutions=(32, 32), perceptual_weight=0.5,
            dist_start_step=0, normal_start_step=0)
TX = dict(lr=1e-4, warmup_steps=1)


def test_rank_layout_equals_jax():
    """Rank r of a data × tile mesh sits where device r sits in the JAX
    package's mesh over the 8 CPU devices."""
    for data, tile in ((2, 4), (4, 2), (8, 1), (1, 8)):
        jm = jmesh.make_mesh(data=data, tile=tile, devices=jax.devices()[:8])
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(8):
            m = Mesh(data, tile, rank=r)
            assert np.array_equal(m.layout(), ids)
            assert tuple(np.argwhere(ids == r)[0]) == (m.data_index,
                                                       m.tile_index)
    # one process: the whole batch, as JAX's with one process
    assert pdist.local_batch_slice(8) == jdist.local_batch_slice(8)
    assert pdist.get_world_size() == 1 and pdist.is_main()


def test_ranks_slices_and_shards_equal_jax(vae_2x2):
    """The four gloo ranks of the 2 × 2 step: each rank's mesh position,
    `local_batch_slice(8)` (JAX's rule with four processes) and
    `shard_batch` of an (8, 3) batch, against the shard the JAX package's
    `shard_batch` puts on device r of its 2 × 2 mesh."""
    rows = vae_2x2["sharded"]["layout"]
    jm = jmesh.make_mesh(data=2, tile=2, devices=jax.devices()[:4])
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    shards = {s.device.id: np.asarray(s.data) for s in
              jmesh.shard_batch(jm, jnp.asarray(x)).addressable_shards}
    for r in range(4):
        d, t, lo, hi = (int(v) for v in rows[r, :4])
        assert (d, t) == (r // 2, r % 2)
        assert (lo, hi) == (r * 2, r * 2 + 2)
        assert np.array_equal(rows[r, 4:].numpy(), shards[r].reshape(-1))


@pytest.fixture(scope="module")
def vae_2x2(tmp_path_factory):
    """The port's 2 × 2 step (four gloo ranks, started first), its
    unsharded step and JAX's 2 × 2 step, from the same weights, batch and
    draws."""
    tmp = tmp_path_factory.mktemp("vae2x2")
    pbatch = {k: v for k, v in make_batch(
        seed=3, batch=2, n_views_in=2, n_views_sup=2, res=32, n_pts=128,
        n_splats=256).items() if k not in ("gt_gaussians", "caption")}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in pbatch.items()}
    jm = JPointVAE(**SIZES)
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(jm.init)(key, jbatch["images_in"][:1],
                               jbatch["pcd"][:1], key)
    psizes = dict(SIZES, release_parity=False, with_encoder=True)
    pm = PointVAE(**psizes)
    pm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams),
                                       pm))
    draws = _jax_draws(key, len(LOSS["lod_resolutions"]),
                       (2, SIZES["latent_num"], SIZES["z_channels"]))
    net = _jax_perceptual_net()
    inputs, out = tmp / "in.pt", tmp / "out.pt"
    torch.save({"mesh": (2, 2), "sizes": psizes, "weights": pm.state_dict(),
                "perceptual": net.state_dict(), "loss": LOSS, "tx": TX,
                "batch": pbatch, "draws": draws}, inputs)
    ranks = workers.start(workers.vae_step, 4, str(inputs), str(out))

    # meanwhile, in this process: JAX's 2 × 2 step and the port unsharded
    mesh = jmesh.make_mesh(data=2, tile=2, devices=jax.devices()[:4])
    jcfg = jstate.TrainStateConfig(**TX)
    sh = jmesh.shard_batch(mesh, {k: v for k, v in jbatch.items()
                                  if k != "tanfov"})
    sh["tanfov"] = jbatch["tanfov"]
    step = jtrainer.make_train_step(jm, jtrainer.VAELossConfig(**LOSS),
                                    jcfg, mesh=mesh)
    _, jlogs = step(jstate.TrainState.create(
        jmesh.replicate(mesh, jparams), jstate.make_optimizer(jcfg)), sh,
        key)
    ps = pstate.TrainState.create(pm)
    plogs = ptrainer.make_train_step(
        pm, ptrainer.VAELossConfig(**LOSS), pstate.TrainStateConfig(**TX),
        perceptual_net=net)(ps, pbatch, draws=draws)
    while not ranks.join():
        pass
    got = torch.load(out)
    return dict(sharded=got, unsharded={k: float(v) for k, v in
                                        plogs.items()},
                unsharded_params=ps.params,
                jax={k: float(v) for k, v in jlogs.items()})


def test_vae_2x2_step_equals_unsharded(vae_2x2):
    got, ref = vae_2x2["sharded"]["logs"], vae_2x2["unsharded"]
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["total"], ref["total"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=1e-4, atol=1e-6)
    for k in ("kl", "dist", "normal", "l1_lod1", "lpips_lod1"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_vae_2x2_update_equals_unsharded(vae_2x2):
    """The averaged gradient gives the unsharded update: Adam's first step
    moves every element by about its learning rate in the direction of the
    gradient's sign, so the parameters agree to a share of lr."""
    got = vae_2x2["sharded"]["params"]
    for k, want in vae_2x2["unsharded_params"].items():
        d = float((got[k] - want.detach()).abs().max())
        assert d <= 0.5 * TX["lr"], (k, d)


def test_vae_2x2_step_equals_jax_2x2(vae_2x2):
    got, ref = vae_2x2["sharded"]["logs"], vae_2x2["jax"]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k],
                                   rtol=5e-3 if k == "grad_norm" else 2e-3,
                                   atol=1e-5, err_msg=k)


def test_fm_data_parallel_step_equals_unsharded(tmp_path):
    from gaussiananything_tpu_torch.parallel.dryrun import fm_step
    out = tmp_path / "fm.pt"
    workers.run(workers.fm_step, 2, str(out))
    got, ref = torch.load(out), fm_step(4, None, "cpu")
    np.testing.assert_allclose(got["fm_loss"], ref["fm_loss"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["t_mean"], ref["t_mean"], rtol=1e-5)
