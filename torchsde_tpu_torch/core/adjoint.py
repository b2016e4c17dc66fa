"""Stochastic-adjoint gradients as a ``torch.autograd.Function`` (counterpart
of ``torchsde_tpu/core/adjoint.py``).

The forward solve steps to every output time (``integrate.
build_interval_grid``), or with ``adaptive=True`` runs the adaptive loop
(``integrate.integrate_adaptive``), and keeps only the output states. The
backward re-steps the interval grid's ``(t0, t1)`` pairs in reverse on
negated time with the adjoint SDE (``core/adjoint_sde.py``): at the last
step of each output interval it resets the state to the saved output and
adds that output's cotangent, as the JAX package's merged scan does. With
``adjoint_adaptive=True`` the backward is instead one merged adaptive loop
over the segments ``T-1 -> 1`` at ``adjoint_rtol``/``adjoint_atol``
through ``ReverseBrownian``, each segment from the saved output with its
cotangent added, the step reset to ``dt`` and the controller's history
cleared; under ``create_graph`` it runs at most ``adjoint_max_steps``
iterations, and a budget run out makes every gradient NaN.

The noise is replayed in forward orientation. Both passes make one choice
(``SolvePlan``: ``integrate.should_precompute_noise`` on the union of the
two methods' U and A needs): precomputed, the default noise is drawn again
from the recorded generator state (``integrate.NoiseReplay``) and an
explicit Brownian object queried again on the same grid; in the loop, the
default noise is the keyed stream of a key drawn once
(``integrate.make_iid_noise_fn``) and the object is queried per step.
Where either direction is adaptive, the default noise is an interval
(``sdeint.check_contract``) that both passes query. Residuals are O(T):
the output states and the generator's state or the key, never the noise.

The gradients reach ``y0`` and every adjoint parameter: each floating
tensor requiring grad that the SDE module tree holds as a parameter, a
buffer or a plain tensor attribute (``base_sde.collect_adjoint_params``),
so a context or a path held by a view of the model passes its gradient on
to whatever made it. The backward is built from differentiable operations
under ``create_graph``, so it differentiates again (double backward).

A traced ``ts`` (``sdeint.is_traced``) solves the whole step grid of the
explicit ``bm``'s ``[t0, t1]`` with every grid point an output, then
interpolates onto ``ts`` and poisons outside ``_AdjointSolve``, as the JAX
package does: the output cotangents reach the adjoint through the
interpolation weights, and ``ts`` gets its gradient from autograd.
"""

import contextlib

import numpy as np
import torch

from . import integrate, solvers
from .adjoint_sde import AdjointSDE, splice
from .base_sde import adjoint_param_slots
from .sdeint import (_time_dtype, check_contract, check_jax_kwargs,
                     default_max_steps, is_traced, parse_return,
                     warn_if_coarser_than_dt_min)
from ..brownian.derived import ReverseBrownian
from ..brownian.interval import np_dtype
from ..settings import METHODS, NOISE_TYPES, SDE_TYPES


@contextlib.contextmanager
def leaf_stand_ins(params, slots):
    """Put a leaf copy of each non-leaf adjoint parameter where the SDE
    reads it, for the duration. A vjp over the parameters is then a partial
    derivative, as the JAX package's over its pytree leaves: without the
    stand-ins, autograd would also reach the parameters upstream of a
    computed tensor (the encoder behind a context) and count them twice.
    Yields the tensors to differentiate with respect to."""
    targets = list(params)
    for i, container, key in slots:
        targets[i] = params[i].detach().requires_grad_(True)
        container[key] = targets[i]
    try:
        yield tuple(targets)
    finally:
        for i, container, key in slots:
            container[key] = params[i]


def _check_adjoint_params(adjoint_params, collected):
    """An explicit ``adjoint_params`` may only name collected tensors, which
    makes it a no-op; anything else raises."""
    ids = {id(p) for p in collected}
    foreign = [i for i, p in enumerate(adjoint_params) if id(p) not in ids]
    if foreign:
        raise ValueError(
            f"`adjoint_params` entries at positions {foreign} are not tensors "
            f"of the SDE module that require grad, so the adjoint would not "
            f"differentiate with respect to them. Attach them to the SDE "
            f"module as parameters, buffers or tensor attributes (every such "
            f"tensor that requires grad receives its gradient); "
            f"`adjoint_params` itself is redundant in this framework.")


def select_default_adjoint_method(sde, method, adjoint_method):
    """The default adjoint method for a forward ``method``."""
    if adjoint_method is not None:
        return adjoint_method
    if method == METHODS.reversible_heun:
        return METHODS.adjoint_reversible_heun
    return {
        SDE_TYPES.ito: {
            NOISE_TYPES.diagonal: METHODS.milstein,
            NOISE_TYPES.additive: METHODS.euler,
            NOISE_TYPES.scalar: METHODS.euler,
            NOISE_TYPES.general: METHODS.euler,
        }[sde.noise_type],
        SDE_TYPES.stratonovich: METHODS.midpoint,
    }[sde.sde_type]


class SolvePlan:
    """What one adjoint solve needs in both passes: the forward SDE, its
    adjoint parameters (and the slots of the non-leaf ones), the interval
    grid and the noise source, with the one choice of precomputed or
    in-loop noise that both passes follow (``noise_precompute`` as
    ``sdeint``'s, sized on the noise ``methods`` need)."""

    def __init__(self, sde, params, slots, bm, ts, dt, time_dtype,
                 rng_impl, noise_precompute, methods):
        self.sde = sde
        self.params = params
        self.slots = slots
        self.ts = ts
        self.dt = dt
        self.time_dtype = time_dtype
        self.grid, self.boundary_idx = integrate.build_interval_grid(ts, dt)
        self.bm = bm
        self.rng_impl = rng_impl
        self.noise_precompute = noise_precompute
        needs = [solvers.method_noise_needs(m) for m in methods]
        self.precompute = integrate.should_precompute_noise(
            len(self.grid) - 1, bm.shape, bm.dtype,
            any(u for u, _ in needs), any(a for _, a in needs),
            override=noise_precompute)
        self.replay = self.key = None
        if isinstance(bm, integrate.DefaultNoise):
            if self.precompute:
                self.replay = integrate.NoiseReplay(
                    bm.generator, bm.shape, bm.dtype, bm.device, rng_impl,
                    bm.levy_area_approximation)
            else:
                self.key = integrate.draw_key(bm.generator, bm.device)

    def noise(self, needs_U, needs_A, again=False):
        """The grid's increments in forward orientation, precomputed or
        in-loop (``integrate.integrate_to_outputs``' ``noise``); ``again``
        replays what the first call gave."""
        if self.replay is not None:
            draw = self.replay.redraw if again else self.replay.draw
            return draw(self.grid, needs_U, needs_A)
        return integrate.solve_noise(self.bm, self.grid, needs_U, needs_A,
                                     self.precompute, self.rng_impl,
                                     self.noise_precompute, key=self.key)

    def grid_on(self, device):
        return torch.as_tensor(self.grid, dtype=self.time_dtype,
                               device=device)

    @contextlib.contextmanager
    def backward_pass(self):
        """The backward's setting: the leaf stand-ins in place; yields the
        tensors to differentiate with respect to and a function that
        returns the pass's results, spliced onto the non-leaf parameters
        where a double backward needs them."""
        with leaf_stand_ins(self.params, self.slots) as targets:
            def finish(outs):
                # A parameter slot no gradient reached is None until here.
                n = len(outs) - len(self.params)
                outs = outs[:n] + tuple(
                    torch.zeros_like(p) if g is None else g
                    for g, p in zip(outs[n:], self.params))
                if not torch.is_grad_enabled() or not self.slots:
                    return outs
                idx = [i for i, _, _ in self.slots]
                return splice([self.params[i] for i in idx],
                              [targets[i] for i in idx], outs)
            yield targets, finish

    def output_steps(self):
        """``{forward step index: output index}`` of each interval's last
        step, where the backward resets the state and adds the cotangent."""
        b = self.boundary_idx
        return {int(b[i + 1]) - 1: i + 1 for i in range(len(b) - 1)}


class _GenericPlan(SolvePlan):

    def __init__(self, solver, adjoint_method, adjoint_options, adaptive,
                 adjoint_adaptive, tolerances, adjoint_max_steps, **kwargs):
        super().__init__(**kwargs)
        self.solver = solver
        self.adjoint_method = adjoint_method
        self.adjoint_options = adjoint_options
        self.adaptive = adaptive
        self.adjoint_adaptive = adjoint_adaptive
        self.rtol, self.atol, self.adjoint_rtol, self.adjoint_atol, \
            self.dt_min = tolerances
        self.adjoint_max_steps = adjoint_max_steps
        self.extra_out = ()

    def forward(self, y0, extra0):
        if self.adaptive:
            ys, self.extra_out, _ = integrate.integrate_adaptive(
                self.solver, y0, extra0, self.ts, self.bm, self.dt,
                self.rtol, self.atol, self.dt_min,
                time_dtype=self.time_dtype)
            return ys
        noise = self.noise(self.solver.needs_U, self.solver.needs_A)
        ys, self.extra_out = integrate.integrate_to_outputs(
            self.solver, y0, extra0, self.grid, self.boundary_idx, noise,
            time_dtype=self.time_dtype)
        return ys

    def backward(self, ys, grad_ys):
        """``(grad_y0, *grad_params)``: the adjoint SDE solved back over
        every interval in one merged loop, on the grid or adaptive."""
        with self.backward_pass() as (targets, finish):
            adjoint_sde = AdjointSDE(self.sde, targets)
            cls = solvers.select(method=self.adjoint_method,
                                 sde_type=adjoint_sde.sde_type)
            solver = cls(sde=adjoint_sde, bm=None, dt=self.dt,
                         options=self.adjoint_options)
            if self.adjoint_adaptive:
                return finish(self._backward_adaptive(solver, ys, grad_ys,
                                                      targets))
            noise_at = integrate.noise_getter(
                self.noise(solver.needs_U, solver.needs_A, again=True))
            grid = self.grid_on(ys.device)
            neg_grid = -grid
            inject = self.output_steps()
            y = torch.zeros_like(ys[0])
            adj_y = torch.zeros_like(ys[0])
            adj_params = (None,) * len(targets)
            for k in reversed(range(len(self.grid) - 1)):
                out = inject.get(k)
                if out is not None:
                    y = ys[out]
                    adj_y = adj_y + grad_ys[out]
                noise = noise_at(k, grid[k], grid[k + 1])
                (y, adj_y, adj_params), _ = solver.step(
                    neg_grid[k + 1], neg_grid[k], (y, adj_y, adj_params), (),
                    noise)
            return finish((adj_y + grad_ys[0],) + adj_params)

    def _backward_adaptive(self, solver, ys, grad_ys, targets):
        """The merged adaptive backward: segments ``T-1 -> 1`` on negated
        time through ``ReverseBrownian``, one iteration a boundary or an
        attempt. At a boundary the state is reset to the saved output, its
        cotangent added, ``h`` reset to ``dt`` and the PI history cleared.
        Under grad mode (a double backward) at most ``adjoint_max_steps``
        iterations; a budget run out multiplies ``adj_y`` and every
        parameter's gradient by NaN, so values and gradients stay loud."""
        adj_params = tuple(torch.zeros_like(p) for p in targets)
        T = len(self.ts)
        if T == 1:
            return (grad_ys[0],) + adj_params
        c = np_dtype(self.time_dtype)
        neg_ts = (-np.asarray(self.ts, np.float64)).astype(c)
        rev_bm = ReverseBrownian(self.bm)
        budget = self.adjoint_max_steps if torch.is_grad_enabled() else None
        seg, curr_t = T - 1, neg_ts[T - 1]
        y, adj_y = ys[T - 1], grad_ys[T - 1]
        h, prev_ratio, prev_ratio_valid = c(self.dt), c(1.0), False
        iterations = 0
        while seg >= 1 and (budget is None or iterations < budget):
            iterations += 1
            seg_end = neg_ts[seg - 1]
            if curr_t >= seg_end:
                seg -= 1
                if seg >= 1:
                    y = ys[seg]
                    adj_y = adj_y + grad_ys[seg]
                    h, prev_ratio_valid = c(self.dt), False
                continue
            next_t = min(curr_t + h, seg_end)
            (aug, _, accept, h, prev_ratio,
             prev_ratio_valid) = integrate.adaptive_attempt(
                solver, rev_bm, curr_t, next_t, (y, adj_y, adj_params), (),
                h, prev_ratio, prev_ratio_valid, self.adjoint_rtol,
                self.adjoint_atol, self.dt_min)
            if accept:
                curr_t = next_t
                y, adj_y, adj_params = aug
        if seg >= 1:
            adj_y = adj_y * float("nan")
            adj_params = tuple(p * float("nan") for p in adj_params)
        return (adj_y + grad_ys[0],) + adj_params


def detached(tensors):
    """``tensors`` as a backward reads them: detached unless it builds a
    graph (a double backward). A view of a saved output taken without grad
    mode still reports ``requires_grad`` but is cut from the graph, so a
    vjp with respect to it would be zero."""
    if torch.is_grad_enabled():
        return tuple(tensors)
    return tuple(t.detach() for t in tensors)


class _AdjointSolve(torch.autograd.Function):
    """The solve over ``(y0, *params)``; its backward is the adjoint's."""

    @staticmethod
    def forward(ctx, plan, extra0, y0, *params):
        ys = plan.forward(y0, extra0)
        ctx.plan = plan
        ctx.save_for_backward(ys)
        return ys

    @staticmethod
    def backward(ctx, grad_ys):
        ys, = detached(ctx.saved_tensors)
        return (None, None) + tuple(ctx.plan.backward(ys, grad_ys))


def sdeint_adjoint(sde,
                   y0,
                   ts,
                   bm=None,
                   method=None,
                   adjoint_method=None,
                   dt=1e-3,
                   adaptive=False,
                   adjoint_adaptive=False,
                   rtol=1e-5,
                   adjoint_rtol=1e-5,
                   atol=1e-4,
                   adjoint_atol=1e-4,
                   dt_min=1e-5,
                   options=None,
                   adjoint_options=None,
                   adjoint_params=None,
                   names=None,
                   logqp=False,
                   extra=False,
                   extra_solver_state=None,
                   generator=None,
                   rng_impl="generator",
                   unroll=1,
                   adjoint_max_steps=None,
                   noise_precompute=None,
                   **unused_kwargs):
    """Integrate an SDE as ``sdeint`` does, with stochastic-adjoint
    gradients: memory O(len(ts)) in the number of steps.

    The solve steps to every output time, so where ``ts`` is not a multiple
    of ``dt`` its grid, and so its values, differ from ``sdeint``'s (which
    steps a uniform grid and interpolates); they are the JAX package's
    ``sdeint_adjoint``'s. Gradients reach ``y0`` and every tensor requiring
    grad that the SDE module holds (``base_sde.collect_adjoint_params``); an
    explicit ``adjoint_params`` may only name such tensors.
    ``adjoint_method`` defaults as in the JAX package: Milstein for Itô
    diagonal noise, Euler for other Itô noise, midpoint for Stratonovich,
    and ``adjoint_reversible_heun`` (exact gradients of the discrete solve)
    for ``method="reversible_heun"``. ``generator`` and ``rng_impl`` seed
    and pick the default noise as in ``sdeint``; the backward replays the
    forward's increments and leaves ``generator`` as the forward left it.

    ``adaptive=True`` solves forward adaptively at ``rtol``/``atol`` (no
    budget) and re-steps the interval grid backward; ``adjoint_adaptive=
    True`` solves backward adaptively at ``adjoint_rtol``/``adjoint_atol``
    (at most ``adjoint_max_steps`` iterations under a double backward,
    default ``sdeint.default_max_steps``). ``dt_min`` floors both and sets
    the default interval's depth. ``noise_precompute`` is ``sdeint``'s,
    decided once for both passes. ``unroll`` is accepted and ignored;
    ``key`` and ``entropy`` raise (``sdeint.check_jax_kwargs``).

    A traced ``ts`` (it requires grad, or a CUDA graph is being captured)
    takes an explicit ``bm`` with ``t0`` and ``t1`` and fixed steps, not
    the reversible-Heun pair: both passes step ``integrate.build_step_grid(
    bm.t0, bm.t1, dt)`` and keep every grid state (O(steps) memory), and
    ``ys`` is interpolated onto ``ts`` and NaN-poisoned as ``sdeint``'s.
    """
    del unroll
    check_jax_kwargs(unused_kwargs, "sdeint_adjoint")
    integrate.check_rng_impl(rng_impl)

    traced = is_traced(ts)
    sde, y0, ts, bm, method, options = check_contract(
        sde, y0, ts, bm, method, options, names, logqp, generator,
        adaptive=adaptive,
        dt_min=dt_min if (adaptive or adjoint_adaptive) else None)
    if traced and (adaptive or adjoint_adaptive):
        raise ValueError("Traced `ts` is only supported for fixed-step "
                         "adjoint solves (the adaptive loop's output "
                         "bookkeeping needs concrete output times).")
    # A traced schedule steers only the interpolation after the solve,
    # whose outputs are every point of the bm's step grid (which
    # build_interval_grid reproduces).
    ts_solve = (integrate.build_step_grid(bm.t0, bm.t1, dt) if traced
                else ts)
    params, slots = adjoint_param_slots(sde)
    if adjoint_params is not None:
        _check_adjoint_params(adjoint_params, params)
    adjoint_method = select_default_adjoint_method(sde, method,
                                                   adjoint_method)
    adjoint_options = {} if adjoint_options is None else dict(adjoint_options)
    time_dtype = _time_dtype(y0)
    plan_kwargs = dict(sde=sde, params=params, slots=slots, bm=bm,
                       ts=ts_solve, dt=float(dt), time_dtype=time_dtype,
                       rng_impl=rng_impl, noise_precompute=noise_precompute,
                       methods=(method, adjoint_method))

    if (method == METHODS.reversible_heun
            or adjoint_method == METHODS.adjoint_reversible_heun):
        if adaptive:
            raise ValueError("method='reversible_heun' with adaptive=True is "
                             "not supported under sdeint_adjoint: the "
                             "backward reconstruction must re-step the exact "
                             "forward grid.")
        if traced:
            raise ValueError(
                "Traced `ts` is not supported with method='reversible_heun' "
                "under sdeint_adjoint: its algebraically-reversed backward "
                "must re-step the exact forward grid, which a traced "
                "schedule cannot pin down. Use a concrete `ts`, or a "
                "non-reversible method.")
        from .adjoint_solvers import sdeint_adjoint_reversible_heun
        ys, extra_solver_state = sdeint_adjoint_reversible_heun(
            y0, extra_solver_state, **plan_kwargs)
        return parse_return(y0, ys, extra_solver_state, extra, logqp)

    if adaptive or adjoint_adaptive:
        warn_if_coarser_than_dt_min(bm, dt_min)
    if adjoint_max_steps is None:
        adjoint_max_steps = default_max_steps(ts_solve, dt, dt_min)
    cls = solvers.select(method=method, sde_type=sde.sde_type)
    solver = cls(sde=sde, bm=None, dt=dt, options=options)
    if bm.levy_area_approximation not in solver.levy_area_approximations:
        raise ValueError(f"SDE solver requires one of "
                         f"{solver.levy_area_approximations} set as the "
                         f"`levy_area_approximation` on the Brownian motion.")
    if extra_solver_state is None:
        t0 = torch.as_tensor(ts_solve[0], dtype=time_dtype, device=y0.device)
        extra_solver_state = solver.init_extra_solver_state(t0, y0)
    plan = _GenericPlan(
        solver, adjoint_method, adjoint_options, bool(adaptive),
        bool(adjoint_adaptive),
        (float(rtol), float(atol), float(adjoint_rtol), float(adjoint_atol),
         float(dt_min)), int(adjoint_max_steps), **plan_kwargs)
    ys = _AdjointSolve.apply(plan, tuple(extra_solver_state), y0, *params)
    if traced:
        grid = torch.as_tensor(ts_solve, dtype=time_dtype, device=y0.device)
        ys = integrate.poison_off_grid(
            integrate.linear_interp_on_grid(ts, grid, ys), ts, grid)
    return parse_return(y0, ys, plan.extra_out, extra, logqp)
