from gaussiananything_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, replicate, shard_batch)
