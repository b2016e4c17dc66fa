"""torchsde_tpu_torch: the PyTorch and CUDA port of torchsde_tpu.

It runs on PyTorch (eagerly: JAX's ``jit`` has no counterpart), takes an
explicit ``torch.Generator`` wherever the JAX package takes a key, and
replaces the JAX package's Pallas TPU kernels with CUDA kernels written for
Hopper. It never imports JAX. Ported so far: fixed-step ``sdeint`` with
every method of the JAX package (Euler, with ``logqp``, SRK and Milstein
for Itô; midpoint, Heun, Euler-Heun, reversible Heun, log-ODE midpoint and
Milstein for Stratonovich), all four noise types; fixed-step
``sdeint_adjoint`` (the adjoint SDE by Euler, Milstein, midpoint, Heun or
Euler-Heun, and the exact reversible-Heun pair), its gradients reaching
``y0`` and every tensor requiring grad that the SDE holds;
its default noise (W, U and A) drawn from the caller's generator or from
the port's Philox stream (``rng_impl``, ``ops/prng.py``), or from an
explicit Brownian object: ``BrownianInterval`` (the JAX package's
Threefry keys and bits, ``brownian/threefry.py``), ``BrownianPath``,
``BrownianTree``, ``ReverseBrownian`` and ``PrecomputedBrownian``; the
latent-SDE model with
its whole-solve kernels (``ops/latent_fused.py``), for one model or K
stacked replicas (``parallel/replicas.py``); the SDE-GAN model with the
kernels of its generator and critic solves (``ops/gan_fused.py``);
``fused_sdeint`` and ``fused_sdeint_logqp``, the whole-solve kernels of any
SDE whose drift and diffusion (and, with the KL channel, prior drift) are
MLP towers (``ops/fused_solve.py``); the whole srid2 solve of an
elementwise diagonal SDE (``ops/srk_fused.py``); adaptive stepping; traced
output times (a ``ts`` that requires grad, or one read inside a CUDA graph
capture: the solve steps an explicit ``bm``'s grid and interpolates on the
card); and the continuous DDPM (``models/unet.py``, ``models/cont_ddpm.py``).
"""

from .brownian.base import BaseBrownian
from .brownian.derived import BrownianPath, BrownianTree, ReverseBrownian
from .brownian.interval import BrownianInterval, brownian_interval_like
from .brownian.precomputed import PrecomputedBrownian
from .core.adjoint import sdeint_adjoint
from .core.base_sde import BaseSDE, SDEIto, SDEStratonovich
from .core.sdeint import sdeint
from .ops.fused_solve import (TowerSpec, fused_sdeint, fused_sdeint_logqp,
                              tower_sde)
from .settings import (LEVY_AREA_APPROXIMATIONS, METHOD_OPTIONS, METHODS,
                       NOISE_TYPES, SDE_TYPES)

__version__ = "0.1.0"

__all__ = [
    "BaseBrownian", "BrownianInterval", "brownian_interval_like",
    "BrownianPath", "BrownianTree", "ReverseBrownian", "PrecomputedBrownian",
    "BaseSDE", "SDEIto", "SDEStratonovich", "sdeint", "sdeint_adjoint",
    "TowerSpec", "fused_sdeint", "fused_sdeint_logqp", "tower_sde",
    "LEVY_AREA_APPROXIMATIONS", "METHOD_OPTIONS", "METHODS", "NOISE_TYPES",
    "SDE_TYPES", "__version__",
]
