from gaussiananything_tpu_torch.diffusion.transport import (  # noqa: F401
    Transport, create_transport)
from gaussiananything_tpu_torch.diffusion.sampling import (  # noqa: F401
    sample_ode, sample_ode_adaptive, sample_sde)
