"""Stochastic-adjoint gradients as a ``torch.autograd.Function`` (counterpart
of ``torchsde_tpu/core/adjoint.py``, fixed-step).

The forward solve steps to every output time (``integrate.
build_interval_grid``) and keeps only the output states. The backward
re-steps the same ``(t0, t1)`` pairs in reverse on negated time with the
adjoint SDE (``core/adjoint_sde.py``): at the last step of each output
interval it resets the state to the saved output and adds that output's
cotangent, as the JAX package's merged scan does. The noise is replayed in
forward orientation: the default noise is drawn again from the recorded
generator state (``integrate.NoiseReplay``), an explicit Brownian object is
queried again on the same grid. Residuals are O(T): the output states and
the generator's state, never the noise.

The gradients reach ``y0`` and every adjoint parameter: each floating
tensor requiring grad that the SDE module tree holds as a parameter, a
buffer or a plain tensor attribute (``collect_adjoint_params``), so a
context or a path held by a view of the model passes its gradient on to
whatever made it. The backward is built from differentiable operations
under ``create_graph``, so it differentiates again (double backward).

Not ported yet (ROADMAP queue 1 item 2): ``adaptive`` and
``adjoint_adaptive``, traced ``ts``, and in-loop noise for long solves.
"""

import contextlib

import torch
from torch import nn

from . import integrate, solvers
from .adjoint_sde import AdjointSDE, splice
from .sdeint import (ADAPTIVE_NOT_PORTED, _DefaultNoise, _time_dtype,
                     check_contract, check_jax_kwargs, parse_return)
from ..settings import METHODS, NOISE_TYPES, SDE_TYPES


def collect_adjoint_params(sde):
    """Every floating tensor requiring grad that ``sde`` holds, each once by
    identity, in a fixed order: the parameters, buffers and plain tensor
    attributes of every module reached from it (through the ``ForwardSDE``,
    ``SDELogqp`` and ``RenameMethodsSDE`` wrappers, and through lists,
    tuples and dicts), and those of an SDE object that is not a module."""
    return _collect(sde)[0]


def _collect(sde):
    """``(tensors, slots)``: the adjoint parameters, and for each of them
    that is not a leaf (a context or a path computed upstream) its index
    and the ``(container, key)`` that holds it, where the backward puts a
    leaf stand-in (``leaf_stand_ins``)."""
    found, slots, seen = [], [], set()

    def visit(obj, container=None, key=None):
        if id(obj) in seen:
            return
        seen.add(id(obj))
        if torch.is_tensor(obj):
            if obj.is_floating_point() and obj.requires_grad:
                if not obj.is_leaf:
                    if not isinstance(container, (dict, list)):
                        raise ValueError(
                            "sdeint_adjoint differentiates a tensor the SDE "
                            "computes upstream only where a module attribute, "
                            "a buffer, a list or a dict holds it, not a tuple")
                    slots.append((len(found), container, key))
                found.append(obj)
        elif isinstance(obj, (list, tuple)):
            for i, item in enumerate(obj):
                visit(item, obj, i)
        elif isinstance(obj, dict):
            for k, item in obj.items():
                visit(item, obj, k)
        elif isinstance(obj, nn.Module) or hasattr(obj, "noise_type"):
            visit(vars(obj))

    visit(sde)
    return tuple(found), slots


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
    grid and the noise source."""

    def __init__(self, sde, params, slots, bm, ts, dt, time_dtype,
                 rng_impl):
        self.sde = sde
        self.params = params
        self.slots = slots
        self.dt = dt
        self.time_dtype = time_dtype
        self.grid, self.boundary_idx = integrate.build_interval_grid(ts, dt)
        self.bm = bm
        self.replay = None
        if isinstance(bm, _DefaultNoise):
            self.replay = integrate.NoiseReplay(
                bm.generator, bm.shape, bm.dtype, bm.device, rng_impl,
                bm.levy_area_approximation)

    def noise(self, needs_U, needs_A, again=False):
        """The grid's increments in forward orientation; ``again`` replays
        what the first call drew."""
        if self.replay is None:
            return integrate.precompute_bm_noise(self.bm, self.grid, needs_U,
                                                 needs_A)
        draw = self.replay.redraw if again else self.replay.draw
        return draw(self.grid, needs_U, needs_A)

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

    def __init__(self, solver, adjoint_method, adjoint_options, **kwargs):
        super().__init__(**kwargs)
        self.solver = solver
        self.adjoint_method = adjoint_method
        self.adjoint_options = adjoint_options
        self.extra_out = ()

    def forward(self, y0, extra0):
        noise = self.noise(self.solver.needs_U, self.solver.needs_A)
        ys, self.extra_out = integrate.integrate_to_outputs(
            self.solver, y0, extra0, self.grid, self.boundary_idx, noise,
            time_dtype=self.time_dtype)
        return ys

    def backward(self, ys, grad_ys):
        """``(grad_y0, *grad_params)``: the adjoint SDE solved back over
        the grid, one merged loop over every interval."""
        with self.backward_pass() as (targets, finish):
            adjoint_sde = AdjointSDE(self.sde, targets)
            cls = solvers.select(method=self.adjoint_method,
                                 sde_type=adjoint_sde.sde_type)
            solver = cls(sde=adjoint_sde, bm=None, dt=self.dt,
                         options=self.adjoint_options)
            W, U, A = self.noise(solver.needs_U, solver.needs_A, again=True)
            neg_grid = -self.grid_on(ys.device)
            inject = self.output_steps()
            y = torch.zeros_like(ys[0])
            adj_y = torch.zeros_like(ys[0])
            adj_params = (None,) * len(targets)
            for k in reversed(range(len(self.grid) - 1)):
                out = inject.get(k)
                if out is not None:
                    y = ys[out]
                    adj_y = adj_y + grad_ys[out]
                noise = (W[k], None if U is None else U[k],
                         None if A is None else A[k])
                (y, adj_y, adj_params), _ = solver.step(
                    neg_grid[k + 1], neg_grid[k], (y, adj_y, adj_params), (),
                    noise)
            return finish((adj_y + grad_ys[0],) + adj_params)


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
                   **unused_kwargs):
    """Integrate an SDE as ``sdeint`` does, with stochastic-adjoint
    gradients: memory O(len(ts)) in the number of steps.

    The solve steps to every output time, so where ``ts`` is not a multiple
    of ``dt`` its grid, and so its values, differ from ``sdeint``'s (which
    steps a uniform grid and interpolates); they are the JAX package's
    ``sdeint_adjoint``'s. Gradients reach ``y0`` and every tensor requiring
    grad that the SDE module holds (``collect_adjoint_params``); an
    explicit ``adjoint_params`` may only name such tensors.
    ``adjoint_method`` defaults as in the JAX package: Milstein for Itô
    diagonal noise, Euler for other Itô noise, midpoint for Stratonovich,
    and ``adjoint_reversible_heun`` (exact gradients of the discrete solve)
    for ``method="reversible_heun"``. ``generator`` and ``rng_impl`` seed
    and pick the default noise as in ``sdeint``; the backward draws the
    same increments again and leaves ``generator`` as the forward left it.
    ``unroll`` is accepted and ignored; ``key``, ``entropy`` and the
    adaptive keywords raise (``sdeint.check_jax_kwargs``).
    """
    del unroll
    check_jax_kwargs(unused_kwargs, "sdeint_adjoint")
    integrate.check_rng_impl(rng_impl)
    if adaptive or adjoint_adaptive:
        raise NotImplementedError(ADAPTIVE_NOT_PORTED)

    sde, y0, ts, bm, method, options = check_contract(
        sde, y0, ts, bm, method, options, names, logqp, generator)
    params, slots = _collect(sde)
    if adjoint_params is not None:
        _check_adjoint_params(adjoint_params, params)
    adjoint_method = select_default_adjoint_method(sde, method,
                                                   adjoint_method)
    adjoint_options = {} if adjoint_options is None else dict(adjoint_options)
    plan_kwargs = dict(sde=sde, params=params, slots=slots, bm=bm, ts=ts,
                       dt=float(dt),
                       time_dtype=_time_dtype(y0), rng_impl=rng_impl)

    if (method == METHODS.reversible_heun
            or adjoint_method == METHODS.adjoint_reversible_heun):
        from .adjoint_solvers import sdeint_adjoint_reversible_heun
        ys, extra_solver_state = sdeint_adjoint_reversible_heun(
            y0, extra_solver_state, **plan_kwargs)
        return parse_return(y0, ys, extra_solver_state, extra, logqp)

    cls = solvers.select(method=method, sde_type=sde.sde_type)
    solver = cls(sde=sde, bm=None, dt=dt, options=options)
    if bm.levy_area_approximation not in solver.levy_area_approximations:
        raise ValueError(f"SDE solver requires one of "
                         f"{solver.levy_area_approximations} set as the "
                         f"`levy_area_approximation` on the Brownian motion.")
    if extra_solver_state is None:
        t0 = torch.as_tensor(ts[0], dtype=_time_dtype(y0), device=y0.device)
        extra_solver_state = solver.init_extra_solver_state(t0, y0)
    plan = _GenericPlan(solver, adjoint_method, adjoint_options,
                        **plan_kwargs)
    ys = _AdjointSolve.apply(plan, tuple(extra_solver_state), y0, *params)
    return parse_return(y0, ys, plan.extra_out, extra, logqp)
