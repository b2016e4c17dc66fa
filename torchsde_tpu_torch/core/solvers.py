"""SDE solver step functions (counterpart of ``torchsde_tpu/core/solvers.py``).

``step`` is a function ``(t0, t1, y0, extra0, noise) -> (y1, extra1)``; the
Brownian increments are handed in by the integrator. Ported so far:
Euler–Maruyama (Itô) and reversible Heun (Stratonovich).
"""

from ..settings import LEVY_AREA_APPROXIMATIONS, METHODS, NOISE_TYPES, SDE_TYPES

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

    def step(self, t0, t1, y0, extra0, noise):
        del extra0
        dt = t1 - t0
        f, g_prod = self.sde.f_and_g_prod(t0, y0, noise[0])
        return y0 + dt * f + g_prod, ()


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

    def init_extra_solver_state(self, t0, y0):
        f0, g0 = self.sde.f_and_g(t0, y0)
        return (f0, g0, y0)

    def step(self, t0, t1, y0, extra0, noise):
        f0, g0, z0 = extra0
        dt = t1 - t0
        dW = noise[0]
        z1 = 2.0 * y0 - z0 + dt * f0 + self.sde.prod(g0, dW)
        f1, g1 = self.sde.f_and_g(t1, z1)
        y1 = (y0 + 0.5 * dt * f0 + 0.5 * dt * f1
              + self.sde.prod(g0 + g1, 0.5 * dW))
        return y1, (f1, g1, z1)


SOLVER_REGISTRY = {
    METHODS.euler: {SDE_TYPES.ito: Euler},
    METHODS.reversible_heun: {SDE_TYPES.stratonovich: ReversibleHeun},
}


def select(method, sde_type):
    """String -> solver class dispatch."""
    table = SOLVER_REGISTRY.get(method)
    if table is None:
        if method in METHODS:
            raise ValueError(
                f"Method '{method}' is not ported to torchsde_tpu_torch yet; "
                f"ported methods: {sorted(SOLVER_REGISTRY)}.")
        raise ValueError(f"Method '{method}' does not match any known method.")
    cls = table.get(sde_type)
    if cls is None:
        cls = next(iter(table.values()))
    return cls
