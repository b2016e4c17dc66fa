"""The reversible-Heun adjoint pair: exact gradients by algebraic inversion
(counterpart of ``torchsde_tpu/core/adjoint_solvers.py``, arXiv:2105.13493).

The forward ``ReversibleHeun`` carries the extra state ``(f, g, z)``, from
which its input can be rebuilt exactly from its output. The backward
inverts the recurrence step by step and accumulates the adjoints ``(adj_y,
adj_f, adj_g, adj_z, adj_params)`` with one vjp of ``f_and_g`` a step, so
its gradients are those of the discrete forward computation (up to
rounding), not the continuous adjoint's. The forward steps to every output
time (``integrate.build_interval_grid``), so the backward re-steps the
exact forward sequence whatever ``ts`` is. Its noise follows
``SolvePlan``'s one choice, as the generic adjoint's does: precomputed and
drawn again, or made in the loop (the keyed stream, or the Brownian object
queried per step) and replayed by step index.
"""

import torch

from . import integrate, solvers
from .adjoint import SolvePlan, detached
from .adjoint_sde import at_leaf, plus, vjp
from ..settings import LEVY_AREA_APPROXIMATIONS, NOISE_TYPES


class AdjointReversibleHeun(solvers.BaseSDESolver):
    """Registry placeholder: the reversible adjoint is run by
    ``sdeint_adjoint_reversible_heun``, not by the generic solver loop."""
    weak_order = 1.0
    sde_type = "stratonovich"
    noise_types = tuple(NOISE_TYPES.all())
    levy_area_approximations = tuple(LEVY_AREA_APPROXIMATIONS.all())

    def __init__(self, *args, **kwargs):
        raise ValueError("adjoint_reversible_heun can only be used as the "
                         "adjoint_method of sdeint_adjoint with "
                         "method='reversible_heun'.")


def _adjoint_of_prod(sde, a, v):
    """Cotangent of ``prod(g, v)`` with respect to g: ``a * v`` for
    diagonal noise, the outer product otherwise."""
    if sde.noise_type == NOISE_TYPES.diagonal:
        return a * v
    return a[..., None] * v[..., None, :]


class _ReversiblePlan(SolvePlan):

    def forward(self, y0, extra0):
        solver = solvers.ReversibleHeun(sde=self.sde, bm=None, dt=self.dt)
        noise = self.noise(False, False)
        return integrate.integrate_to_outputs(
            solver, y0, extra0, self.grid, self.boundary_idx, noise,
            time_dtype=self.time_dtype)

    def backward(self, ys, extra_out, grad_ys, grad_extra):
        """``(grad_y0, grad_f0, grad_g0, grad_z0, *grad_params)``."""
        with self.backward_pass() as (targets, finish):
            fwd = self.sde
            noise_at = integrate.noise_getter(
                self.noise(False, False, again=True))
            grid = self.grid_on(ys.device)
            neg_grid = -grid
            inject = self.output_steps()
            create_graph = torch.is_grad_enabled()
            y = torch.zeros_like(ys[0])
            adj_y = torch.zeros_like(ys[0])
            adj_f, adj_g, adj_z = grad_extra
            adj_params = (None,) * len(targets)
            f0, g0, z0 = extra_out
            for k in reversed(range(len(self.grid) - 1)):
                out = inject.get(k)
                if out is not None:
                    y = ys[out]
                    adj_y = adj_y + grad_ys[out]
                t0b, t1b = neg_grid[k + 1], neg_grid[k]
                dt = t1b - t0b
                dW = noise_at(k, grid[k], grid[k + 1])[0]
                half_dt = 0.5 * dt
                half_dW = 0.5 * dW

                # Invert the forward recurrence: on the reversed clock the
                # forward update is subtracted.
                z1 = 2 * y - z0 - f0 * dt - fwd.prod(g0, dW)

                adj_y_half_dt = adj_y * half_dt
                adj_y_half_dW = _adjoint_of_prod(fwd, adj_y, half_dW)
                adj_f1 = adj_y_half_dt
                adj_f0 = adj_f + adj_y_half_dt
                adj_g1 = adj_y_half_dW
                adj_g0 = adj_g + adj_y_half_dW

                grads = at_leaf(
                    lambda z: vjp(fwd.f_and_g(-t0b, z), (z,) + targets,
                                  (adj_f0, adj_g0), create_graph,
                                  zeros=False), z0)
                adj_z0 = plus(adj_z, grads[0])
                adj_params = tuple(map(plus, adj_params, grads[1:]))

                f1, g1 = fwd.f_and_g(-t1b, z1)
                y1 = y - (f0 + f1) * half_dt - fwd.prod(g0 + g1, half_dW)

                adj_y = adj_y + 2 * adj_z0
                adj_z = -adj_z0
                adj_f = adj_f1 + adj_z0 * dt
                adj_g = adj_g1 + _adjoint_of_prod(fwd, adj_z0, dW)
                y = y1
                f0, g0, z0 = f1, g1, z1
            return finish((adj_y + grad_ys[0], adj_f, adj_g, adj_z)
                          + adj_params)


class _ReversibleSolve(torch.autograd.Function):
    """The solve over ``(y0, f0, g0, z0, *params)``; its backward is the
    algebraic inversion."""

    @staticmethod
    def forward(ctx, plan, y0, f0, g0, z0, *params):
        ys, (f, g, z) = plan.forward(y0, (f0, g0, z0))
        ctx.plan = plan
        ctx.save_for_backward(ys, f, g, z)
        return ys, f, g, z

    @staticmethod
    def backward(ctx, grad_ys, grad_f, grad_g, grad_z):
        ys, f, g, z = detached(ctx.saved_tensors)
        grads = ctx.plan.backward(ys, (f, g, z), grad_ys,
                                  (grad_f, grad_g, grad_z))
        return (None, *grads)


def sdeint_adjoint_reversible_heun(y0, extra_solver_state, **plan_kwargs):
    """The reversible-Heun solve of ``sdeint_adjoint``: ``(ys, (f, g,
    z))``. The initial ``(f0, g0, z0)``, when not given, is evaluated
    outside the Function, so its gradients reach ``y0`` and the parameters
    by ordinary backprop."""
    plan = _ReversiblePlan(**plan_kwargs)
    if extra_solver_state is None:
        solver = solvers.ReversibleHeun(sde=plan.sde, bm=None, dt=plan.dt)
        t0 = torch.as_tensor(plan.grid[0], dtype=plan.time_dtype,
                             device=y0.device)
        extra_solver_state = solver.init_extra_solver_state(t0, y0)
    ys, f, g, z = _ReversibleSolve.apply(plan, y0, *extra_solver_state,
                                         *plan.params)
    return ys, (f, g, z)
