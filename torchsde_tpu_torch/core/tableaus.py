"""Stochastic Runge-Kutta tableaus (a copy of
``torchsde_tpu/core/tableaus.py``; the port does not import the JAX
package).

Coefficients from Roessler, "Runge-Kutta methods for the strong
approximation of solutions of stochastic differential equations", SIAM J.
Numer. Anal. 48(3), 2010. ``sra*`` target additive noise, ``srid*``
diagonal noise. The SRK solver uses ``sra1`` and ``srid2``; the rest are
available alternates. ``ops/csrc/srk_srid2.cuh`` holds srid2 again as
constexpr functions for the CUDA kernel.
"""


class SRA1:
    STAGES = 2
    C0 = (0.0, 3 / 4)
    C1 = (1.0, 0.0)
    A0 = ((), (3 / 4,))
    B0 = ((), (3 / 2,))
    alpha = (1 / 3, 2 / 3)
    beta1 = (1.0, 0.0)
    beta2 = (-1.0, 1.0)


class SRA2:
    STAGES = 2
    C0 = (0.0, 3 / 4)
    C1 = (1 / 3, 1.0)
    A0 = ((), (3 / 4,))
    B0 = ((), (3 / 2,))
    alpha = (1 / 3, 2 / 3)
    beta1 = (0.0, 1.0)
    beta2 = (-3 / 2, 3 / 2)


class SRA3:
    STAGES = 3
    C0 = (0.0, 1.0, 1 / 2)
    C1 = (1.0, 0.0, 0.0)
    A0 = ((), (1.0,), (1 / 4, 1 / 4))
    B0 = ((), (0.0,), (1.0, 1 / 2))
    alpha = (1 / 6, 1 / 6, 2 / 3)
    beta1 = (1.0, 0.0, 0.0)
    beta2 = (1.0, -1.0, 0.0)


class SRID1:
    STAGES = 4
    C0 = (0.0, 3 / 4, 0.0, 0.0)
    C1 = (0.0, 1 / 4, 1.0, 1 / 4)
    A0 = ((), (3 / 4,), (0.0, 0.0), (0.0, 0.0, 0.0))
    A1 = ((), (1 / 4,), (1.0, 0.0), (0.0, 0.0, 1 / 4))
    B0 = ((), (3 / 2,), (0.0, 0.0), (0.0, 0.0, 0.0))
    B1 = ((), (1 / 2,), (-1.0, 0.0), (-5.0, 3.0, 1 / 2))
    alpha = (1 / 3, 2 / 3, 0.0, 0.0)
    beta1 = (-1.0, 4 / 3, 2 / 3, 0.0)
    beta2 = (-1.0, 4 / 3, -1 / 3, 0.0)
    beta3 = (2.0, -4 / 3, -2 / 3, 0.0)
    beta4 = (-2.0, 5 / 3, -2 / 3, 1.0)


class SRID2:
    STAGES = 4
    C0 = (0.0, 1.0, 1 / 2, 0.0)
    C1 = (0.0, 1 / 4, 1.0, 1 / 4)
    A0 = ((), (1.0,), (1 / 4, 1 / 4), (0.0, 0.0, 0.0))
    A1 = ((), (1 / 4,), (1.0, 0.0), (0.0, 0.0, 1 / 4))
    B0 = ((), (0.0,), (1.0, 1 / 2), (0.0, 0.0, 0.0))
    B1 = ((), (-1 / 2,), (1.0, 0.0), (2.0, -1.0, 1 / 2))
    alpha = (1 / 6, 1 / 6, 2 / 3, 0.0)
    beta1 = (-1.0, 4 / 3, 2 / 3, 0.0)
    beta2 = (1.0, -4 / 3, 1 / 3, 0.0)
    beta3 = (2.0, -4 / 3, -2 / 3, 0.0)
    beta4 = (-2.0, 5 / 3, -2 / 3, 1.0)
