"""torchsde_tpu_torch: the PyTorch and CUDA port of torchsde_tpu.

It runs on PyTorch (eagerly: JAX's ``jit`` has no counterpart), takes an
explicit ``torch.Generator`` wherever the JAX package takes a key, and
replaces the JAX package's Pallas TPU kernels with CUDA kernels written for
Hopper. It never imports JAX. Ported so far: fixed-step Euler ``sdeint``
with ``logqp``, and the latent-SDE model with its whole-solve forward kernel
(``ops/latent_fused.py``).
"""

from .brownian.base import BaseBrownian
from .core.base_sde import BaseSDE, SDEIto
from .core.sdeint import sdeint
from .settings import (LEVY_AREA_APPROXIMATIONS, METHOD_OPTIONS, METHODS,
                       NOISE_TYPES, SDE_TYPES)

__version__ = "0.1.0"

__all__ = [
    "BaseBrownian", "BaseSDE", "SDEIto", "sdeint",
    "LEVY_AREA_APPROXIMATIONS", "METHOD_OPTIONS", "METHODS", "NOISE_TYPES",
    "SDE_TYPES", "__version__",
]
