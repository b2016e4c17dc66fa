"""SDE solver step functions (counterpart of ``torchsde_tpu/core/solvers.py``).

``step`` is a function ``(t0, t1, y0, extra0, noise) -> (y1, extra1)``; the
Brownian increments are handed in by the integrator. Every fixed-step method
of the JAX package is here: Euler–Maruyama and SRK (Itô), midpoint, Heun,
Euler–Heun, reversible Heun and log-ODE midpoint (Stratonovich) and Milstein
(both). ``adjoint_reversible_heun`` selects the placeholder of
``core/adjoint_solvers.py``: ``sdeint_adjoint`` runs that pair itself.

The steps form their linear combinations with ``utils.misc.tree_lc``, so
a state may be a tuple of tensors (the adjoint's augmented state); on a
tensor state each sum is the plain expression, term by term in order.
"""

import functools

import torch

from . import tableaus
from ..utils.misc import tree_lc, weak_scalar
from ..settings import (LEVY_AREA_APPROXIMATIONS, METHOD_OPTIONS, METHODS,
                        NOISE_TYPES, SDE_TYPES)

_ALL_LEVY = tuple(LEVY_AREA_APPROXIMATIONS.all())
_ALL_NOISE = tuple(NOISE_TYPES.all())


class BaseSDESolver:
    """Solver base: trait validation and the step interface."""

    strong_order = None
    weak_order = None
    sde_type = None
    noise_types = None
    levy_area_approximations = None
    needs_U = False
    needs_A = False

    def __init__(self, sde, bm=None, dt=None, options=None, **kwargs):
        del kwargs
        if sde.sde_type != self.sde_type:
            raise ValueError(f"SDE is of type {sde.sde_type} but solver is for type "
                             f"{self.sde_type}")
        if sde.noise_type not in self.noise_types:
            raise ValueError(f"SDE has noise type {sde.noise_type} but solver only "
                             f"supports noise types {self.noise_types}")
        if bm is not None and bm.levy_area_approximation not in self.levy_area_approximations:
            raise ValueError(f"SDE solver requires one of {self.levy_area_approximations} "
                             f"set as the `levy_area_approximation` on the Brownian motion.")
        if sde.noise_type == NOISE_TYPES.scalar and bm is not None:
            if tuple(bm.shape[1:]) != (1,):
                raise ValueError("The Brownian motion for scalar SDEs must of dimension 1.")
        self.sde = sde
        self.bm = bm
        self.dt = dt
        self.options = {} if options is None else dict(options)

    def __repr__(self):
        return (f"{self.__class__.__name__} of strong order: {self.strong_order}, "
                f"and weak order: {self.weak_order}")

    def init_extra_solver_state(self, t0, y0):
        return ()

    @property
    def nfe_per_step(self):
        """Vector-field evaluations per step: each call of ``f`` or ``g`` is
        one, so ``f_and_g`` and ``f_and_g_prod`` count 2, ``g_prod`` 1, and
        a derivative bracket its one primal diffusion evaluation."""
        raise NotImplementedError

    def step(self, t0, t1, y0, extra0, noise):
        """One step from t0 to t1. ``noise`` is ``(W, U, A)`` for the full step
        (entries are None unless the solver declared needs_U / needs_A)."""
        raise NotImplementedError


class Euler(BaseSDESolver):
    """Euler–Maruyama."""
    weak_order = 1.0
    sde_type = SDE_TYPES.ito
    noise_types = _ALL_NOISE
    levy_area_approximations = _ALL_LEVY

    def __init__(self, sde, **kwargs):
        self.strong_order = 1.0 if sde.noise_type == NOISE_TYPES.additive else 0.5
        super().__init__(sde=sde, **kwargs)

    nfe_per_step = 2  # one fused f_and_g_prod

    def step(self, t0, t1, y0, extra0, noise):
        del extra0
        dt = t1 - t0
        f, g_prod = self.sde.f_and_g_prod(t0, y0, noise[0])
        return tree_lc((1.0, y0), (dt, f), (1.0, g_prod)), ()


class Midpoint(BaseSDESolver):
    """Explicit midpoint, Stratonovich."""
    weak_order = 1.0
    sde_type = SDE_TYPES.stratonovich
    noise_types = _ALL_NOISE
    levy_area_approximations = _ALL_LEVY

    def __init__(self, sde, **kwargs):
        self.strong_order = 0.5 if sde.noise_type == NOISE_TYPES.general else 1.0
        super().__init__(sde=sde, **kwargs)

    nfe_per_step = 4  # two fused f_and_g_prod calls

    def step(self, t0, t1, y0, extra0, noise):
        del extra0
        dt = t1 - t0
        I_k = noise[0]
        f, g_prod = self.sde.f_and_g_prod(t0, y0, I_k)
        half_dt = 0.5 * dt
        y_prime = tree_lc((1.0, y0), (half_dt, f), (0.5, g_prod))
        f_prime, g_prod_prime = self.sde.f_and_g_prod(t0 + half_dt, y_prime,
                                                      I_k)
        return tree_lc((1.0, y0), (dt, f_prime), (1.0, g_prod_prime)), ()


class Heun(BaseSDESolver):
    """Stratonovich Heun, a trapezoidal predictor-corrector."""
    weak_order = 1.0
    sde_type = SDE_TYPES.stratonovich
    noise_types = _ALL_NOISE
    levy_area_approximations = _ALL_LEVY

    def __init__(self, sde, **kwargs):
        self.strong_order = 0.5 if sde.noise_type == NOISE_TYPES.general else 1.0
        super().__init__(sde=sde, **kwargs)

    nfe_per_step = 4  # two fused f_and_g_prod calls

    def step(self, t0, t1, y0, extra0, noise):
        del extra0
        dt = t1 - t0
        I_k = noise[0]
        f, g_prod = self.sde.f_and_g_prod(t0, y0, I_k)
        y0_prime = tree_lc((1.0, y0), (dt, f), (1.0, g_prod))
        f_prime, g_prod_prime = self.sde.f_and_g_prod(t1, y0_prime, I_k)
        y1 = tree_lc((1.0, y0), (0.5 * dt, f), (0.5 * dt, f_prime),
                     (0.5, g_prod), (0.5, g_prod_prime))
        return y1, ()


class EulerHeun(BaseSDESolver):
    """Euler drift with a Heun-averaged diffusion, Stratonovich."""
    weak_order = 1.0
    sde_type = SDE_TYPES.stratonovich
    noise_types = _ALL_NOISE
    levy_area_approximations = _ALL_LEVY

    def __init__(self, sde, **kwargs):
        self.strong_order = 0.5 if sde.noise_type == NOISE_TYPES.general else 1.0
        super().__init__(sde=sde, **kwargs)

    nfe_per_step = 3  # f_and_g_prod + one extra g_prod

    def step(self, t0, t1, y0, extra0, noise):
        del extra0
        dt = t1 - t0
        I_k = noise[0]
        f, g_prod = self.sde.f_and_g_prod(t0, y0, I_k)
        g_prod_prime = self.sde.g_prod(t1, tree_lc((1.0, y0), (1.0, g_prod)),
                                       I_k)
        return tree_lc((1.0, y0), (dt, f), (0.5, g_prod),
                       (0.5, g_prod_prime)), ()


class BaseMilstein(BaseSDESolver):
    """Milstein family: Euler plus the Levy-bracket correction
    ``0.5 * gdg_prod(v)``, its derivative from autograd (default) or from a
    second, derivative-free diffusion evaluation
    (``options={'grad_free': True}``)."""
    strong_order = 1.0
    weak_order = 1.0
    noise_types = (NOISE_TYPES.additive, NOISE_TYPES.diagonal, NOISE_TYPES.scalar)
    levy_area_approximations = _ALL_LEVY

    def __init__(self, sde, options=None, **kwargs):
        options = {} if options is None else dict(options)
        if METHOD_OPTIONS.grad_free not in options:
            options[METHOD_OPTIONS.grad_free] = False
        if options[METHOD_OPTIONS.grad_free] and sde.noise_type == NOISE_TYPES.additive:
            # dg = 0: the autodiff path already returns an exact zero correction.
            options[METHOD_OPTIONS.grad_free] = False
        if options[METHOD_OPTIONS.grad_free] and getattr(sde, "is_adjoint_sde", False):
            raise ValueError(
                "Derivative-free Milstein cannot be used for adjoint SDEs, because it "
                "requires direct access to the diffusion, whilst adjoint SDEs rely on "
                "a more efficient diffusion-vector product. Use derivative-using "
                "Milstein instead: `adjoint_options=dict(grad_free=False)`")
        super().__init__(sde=sde, options=options, **kwargs)

    @property
    def nfe_per_step(self):
        # grad-based: f + one primal g inside the vjp bracket; grad-free:
        # f_and_g + the extra derivative-free g evaluation.
        return 3 if self.options[METHOD_OPTIONS.grad_free] else 2

    def v_term(self, I_k, dt):
        raise NotImplementedError

    def y_prime_f_factor(self, dt, f):
        raise NotImplementedError

    def step(self, t0, t1, y0, extra0, noise):
        del extra0
        dt = t1 - t0
        I_k = noise[0]
        v = self.v_term(I_k, dt)

        if self.options[METHOD_OPTIONS.grad_free]:
            f, g = self.sde.f_and_g(t0, y0)
            g_ = g.squeeze(2) if g.ndim == 3 else g  # scalar vs diagonal noise
            sqrt_dt = torch.sqrt(dt)
            y0_prime = y0 + self.y_prime_f_factor(dt, f) + g_ * sqrt_dt
            g_prime = self.sde.g(t0, y0_prime)
            g_prod_I_k = self.sde.prod(g, I_k)
            gdg_prod = self.sde.prod(g_prime - g, v) / (2 * sqrt_dt)
            return y0 + f * dt + g_prod_I_k + gdg_prod, ()
        f = self.sde.f(t0, y0)
        g_prod_I_k, gdg_prod = self.sde.g_prod_and_gdg_prod(t0, y0, I_k, 0.5 * v)
        return tree_lc((1.0, y0), (dt, f), (1.0, g_prod_I_k),
                       (1.0, gdg_prod)), ()


class MilsteinIto(BaseMilstein):
    sde_type = SDE_TYPES.ito

    def v_term(self, I_k, dt):
        return I_k ** 2 - dt

    def y_prime_f_factor(self, dt, f):
        return dt * f


class MilsteinStratonovich(BaseMilstein):
    sde_type = SDE_TYPES.stratonovich

    def v_term(self, I_k, dt):
        return I_k ** 2

    def y_prime_f_factor(self, dt, f):
        return 0.0


class ReversibleHeun(BaseSDESolver):
    """Algebraically reversible Heun (arXiv:2105.13493). Carries the extra
    state ``(f0, g0, z0)``: the drift and diffusion at the last evaluation
    point ``z0``, so each step evaluates ``f_and_g`` once."""
    weak_order = 1.0
    sde_type = SDE_TYPES.stratonovich
    noise_types = _ALL_NOISE
    levy_area_approximations = _ALL_LEVY

    def __init__(self, sde, **kwargs):
        self.strong_order = 1.0 if sde.noise_type == NOISE_TYPES.additive else 0.5
        super().__init__(sde=sde, **kwargs)

    nfe_per_step = 2  # one f_and_g at z1; (f0, g0) ride in the carry

    def init_extra_solver_state(self, t0, y0):
        f0, g0 = self.sde.f_and_g(t0, y0)
        return (f0, g0, y0)

    def step(self, t0, t1, y0, extra0, noise):
        f0, g0, z0 = extra0
        dt = t1 - t0
        dW = noise[0]
        z1 = tree_lc((2.0, y0), (-1.0, z0), (dt, f0),
                     (1.0, self.sde.prod(g0, dW)))
        f1, g1 = self.sde.f_and_g(t1, z1)
        y1 = tree_lc((1.0, y0), (0.5 * dt, f0), (0.5 * dt, f1),
                     (1.0, self.sde.prod(g0 + g1, 0.5 * dW)))
        return y1, (f1, g1, z1)


class SRK(BaseSDESolver):
    """Strong order 1.5 stochastic Runge-Kutta (Roessler 2010): tableau
    srid2 for diagonal and scalar noise, sra1 for additive noise. Needs the
    space-time Levy integral U beside each increment."""
    strong_order = 1.5
    weak_order = 1.5
    sde_type = SDE_TYPES.ito
    noise_types = (NOISE_TYPES.additive, NOISE_TYPES.diagonal,
                   NOISE_TYPES.scalar)
    levy_area_approximations = (LEVY_AREA_APPROXIMATIONS.space_time,
                                LEVY_AREA_APPROXIMATIONS.davie,
                                LEVY_AREA_APPROXIMATIONS.foster)
    needs_U = True

    def __init__(self, sde, **kwargs):
        if getattr(sde, "is_adjoint_sde", False):
            raise ValueError(
                "Stochastic Runge-Kutta methods cannot be used for adjoint SDEs, "
                "because it requires direct access to the diffusion, whilst adjoint "
                "SDEs rely on a more efficient diffusion-vector product. Use a "
                "different method instead.")
        super().__init__(sde=sde, **kwargs)

    @property
    def nfe_per_step(self):
        # The stage loops below re-evaluate (f, g) for every (stage,
        # substage) pair and add one f and one g_prod per stage.
        s = (tableaus.SRA1 if self.sde.noise_type == NOISE_TYPES.additive
             else tableaus.SRID2).STAGES
        return s * (s - 1) + 2 * s

    def step(self, t0, t1, y0, extra0, noise):
        if self.sde.noise_type == NOISE_TYPES.additive:
            return self._additive_step(t0, t1, y0, extra0, noise)
        return self._diagonal_or_scalar_step(t0, t1, y0, extra0, noise)

    def _diagonal_or_scalar_step(self, t0, t1, y0, extra0, noise):
        del extra0
        tab = tableaus.SRID2
        dt = t1 - t0
        rdt = 1.0 / dt
        sqrt_dt = torch.sqrt(dt.to(noise[0].dtype))
        I_k, I_k0 = noise[0], noise[1]
        # Each tableau constant rounded to the dtype it meets, as the JAX
        # package's weak Python scalars are (exact above bfloat16).
        c = functools.partial(weak_scalar, dtype=y0.dtype)
        ct = functools.partial(weak_scalar, dtype=dt.dtype)
        I_kk = (I_k ** 2 - dt) * 0.5
        I_kkk = (I_k ** 3 - 3 * dt * I_k) * c(1.0 / 6.0)

        y1 = y0
        H0, H1 = [], []
        for s in range(tab.STAGES):
            H0s, H1s = y0, y0
            for j in range(s):
                f = self.sde.f(t0 + ct(tab.C0[j]) * dt, H0[j])
                g = self.sde.g(t0 + ct(tab.C1[j]) * dt, H1[j])
                g = g.squeeze(2) if g.ndim == 3 else g
                H0s = (H0s + c(tab.A0[s][j]) * f * dt
                       + c(tab.B0[s][j]) * g * I_k0 * rdt)
                H1s = (H1s + c(tab.A1[s][j]) * f * dt
                       + c(tab.B1[s][j]) * g * sqrt_dt)
            H0.append(H0s)
            H1.append(H1s)

            f = self.sde.f(t0 + ct(tab.C0[s]) * dt, H0s)
            g_weight = (c(tab.beta1[s]) * I_k +
                        c(tab.beta2[s]) * I_kk / sqrt_dt +
                        c(tab.beta3[s]) * I_k0 * rdt +
                        c(tab.beta4[s]) * I_kkk * rdt)
            g_prod = self.sde.g_prod(t0 + ct(tab.C1[s]) * dt, H1s, g_weight)
            y1 = y1 + c(tab.alpha[s]) * f * dt + g_prod
        return y1, ()

    def _additive_step(self, t0, t1, y0, extra0, noise):
        del extra0
        tab = tableaus.SRA1
        dt = t1 - t0
        rdt = 1.0 / dt
        I_k, I_k0 = noise[0], noise[1]
        c = functools.partial(weak_scalar, dtype=y0.dtype)
        ct = functools.partial(weak_scalar, dtype=dt.dtype)

        y1 = y0
        H0 = []
        for i in range(tab.STAGES):
            H0i = y0
            for j in range(i):
                f = self.sde.f(t0 + ct(tab.C0[j]) * dt, H0[j])
                g_weight = c(tab.B0[i][j]) * I_k0 * rdt
                g_prod = self.sde.g_prod(t0 + ct(tab.C1[j]) * dt, y0,
                                         g_weight)
                H0i = H0i + c(tab.A0[i][j]) * f * dt + g_prod
            H0.append(H0i)

            f = self.sde.f(t0 + ct(tab.C0[i]) * dt, H0i)
            g_weight = (c(tab.beta1[i]) * I_k
                        + c(tab.beta2[i]) * I_k0 * rdt)
            g_prod = self.sde.g_prod(t0 + ct(tab.C1[i]) * dt, y0, g_weight)
            y1 = y1 + c(tab.alpha[i]) * f * dt + g_prod
        return y1, ()


class LogODEMidpoint(BaseSDESolver):
    """Log-ODE scheme: midpoint plus the full-Levy-area correction."""
    weak_order = 1.0
    sde_type = SDE_TYPES.stratonovich
    noise_types = _ALL_NOISE
    levy_area_approximations = (LEVY_AREA_APPROXIMATIONS.davie,
                                LEVY_AREA_APPROXIMATIONS.foster)
    needs_A = True

    def __init__(self, sde, **kwargs):
        if getattr(sde, "is_adjoint_sde", False):
            raise ValueError(
                "Log-ODE schemes cannot be used for adjoint SDEs, because they "
                "require direct access to the diffusion, whilst adjoint SDEs rely on "
                "a more efficient diffusion-vector product. Use a different method "
                "instead.")
        self.strong_order = 0.5 if sde.noise_type == NOISE_TYPES.general else 1.0
        super().__init__(sde=sde, **kwargs)

    nfe_per_step = 5  # two f_and_g_prod + the jvp bracket's primal g

    def step(self, t0, t1, y0, extra0, noise):
        del extra0
        dt = t1 - t0
        I_k, A = noise[0], noise[2]
        f, g_prod = self.sde.f_and_g_prod(t0, y0, I_k)
        half_dt = 0.5 * dt
        t_prime = t0 + half_dt
        y_prime = y0 + half_dt * f + 0.5 * g_prod
        f_prime, g_prod_prime = self.sde.f_and_g_prod(t_prime, y_prime, I_k)
        dg_ga_prime = self.sde.dg_ga_jvp_column_sum(t_prime, y_prime, A)
        return y0 + dt * f_prime + g_prod_prime + dg_ga_prime, ()


SOLVER_REGISTRY = {
    METHODS.euler: {SDE_TYPES.ito: Euler},
    METHODS.milstein: {SDE_TYPES.ito: MilsteinIto,
                       SDE_TYPES.stratonovich: MilsteinStratonovich},
    METHODS.srk: {SDE_TYPES.ito: SRK},
    METHODS.midpoint: {SDE_TYPES.stratonovich: Midpoint},
    METHODS.heun: {SDE_TYPES.stratonovich: Heun},
    METHODS.euler_heun: {SDE_TYPES.stratonovich: EulerHeun},
    METHODS.reversible_heun: {SDE_TYPES.stratonovich: ReversibleHeun},
    METHODS.log_ode_midpoint: {SDE_TYPES.stratonovich: LogODEMidpoint},
}


def select(method, sde_type):
    """String -> solver class dispatch."""
    if method == METHODS.adjoint_reversible_heun:
        from .adjoint_solvers import AdjointReversibleHeun
        return AdjointReversibleHeun
    table = SOLVER_REGISTRY.get(method)
    if table is None:
        raise ValueError(f"Method '{method}' does not match any known method.")
    cls = table.get(sde_type)
    if cls is None:
        cls = next(iter(table.values()))
    return cls


def method_noise_needs(method):
    """``(needs_U, needs_A)`` of a method string without building the
    solver, or-ed over the method's sde_type variants."""
    if method == METHODS.adjoint_reversible_heun:
        return False, False
    table = SOLVER_REGISTRY.get(method)
    if table is None:
        raise ValueError(f"Method '{method}' does not match any known method.")
    return (any(c.needs_U for c in table.values()),
            any(c.needs_A for c in table.values()))
