"""torchsde_tpu_torch: the PyTorch and CUDA port of torchsde_tpu.

It runs on PyTorch (eagerly: JAX's ``jit`` has no counterpart), takes an
explicit ``torch.Generator`` wherever the JAX package takes a key, and
replaces the JAX package's Pallas TPU kernels with CUDA kernels written for
Hopper. It never imports JAX. Ported so far: fixed-step ``sdeint`` with
Euler (Itô, with ``logqp``) and reversible Heun (Stratonovich); the
latent-SDE model with its whole-solve kernels (``ops/latent_fused.py``);
the SDE-GAN model with the kernels of its generator and critic solves
(``ops/gan_fused.py``); and ``fused_sdeint`` and ``fused_sdeint_logqp``,
the whole-solve kernels of any SDE whose drift and diffusion (and, with the
KL channel, prior drift) are MLP towers (``ops/fused_solve.py``).
"""

from .brownian.base import BaseBrownian
from .core.base_sde import BaseSDE, SDEIto, SDEStratonovich
from .core.sdeint import sdeint
from .ops.fused_solve import (TowerSpec, fused_sdeint, fused_sdeint_logqp,
                              tower_sde)
from .settings import (LEVY_AREA_APPROXIMATIONS, METHOD_OPTIONS, METHODS,
                       NOISE_TYPES, SDE_TYPES)

__version__ = "0.1.0"

__all__ = [
    "BaseBrownian", "BaseSDE", "SDEIto", "SDEStratonovich", "sdeint",
    "TowerSpec", "fused_sdeint", "fused_sdeint_logqp", "tower_sde",
    "LEVY_AREA_APPROXIMATIONS", "METHOD_OPTIONS", "METHODS", "NOISE_TYPES",
    "SDE_TYPES", "__version__",
]
