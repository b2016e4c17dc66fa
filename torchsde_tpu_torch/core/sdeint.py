"""Public forward-integration entry point (counterpart of
``torchsde_tpu/core/sdeint.py``).

Every method of the JAX package on a fixed step grid
(``adjoint_reversible_heun`` only as ``sdeint_adjoint``'s adjoint method,
as there) or adaptive (``adaptive=True``: ``integrate.integrate_adaptive``,
with ``rtol``, ``atol``, ``dt_min`` and ``max_steps``), with concrete
``ts``; the default noise source (W, U and A, with ``rng_impl``) and
explicit Brownian objects (``BrownianInterval`` and the classes built on
it, ``PrecomputedBrownian``, or any ``BaseBrownian``); ``logqp``,
``names``, ``return_stats``, ``remat`` and the contract checks with the
JAX package's wording. A fixed-step solve precomputes its noise unless the
buffers would pass 1 GiB or ``noise_precompute=False`` asks otherwise, and
keeps only the grid states that bracket an output (``core/integrate.py``).
The JAX package's ``key`` and ``entropy`` have no counterpart here: the
port seeds with a ``torch.Generator``.

Traced ``ts``, the counterpart of the JAX package's ``ts`` traced under
``jit``: a tensor of output times that requires grad, or any tensor of
times while the current CUDA stream captures a graph (``is_traced``). The
host never reads it: the solve steps the whole grid of an explicit
``bm``'s ``[t0, t1]``, keeps every grid state, and interpolates onto
``ts`` on the device (``integrate.integrate_traced``), so gradients reach
``ts`` and a captured graph replays for any schedule of the same length.
Every other ``ts`` is concrete and read on the host.
"""

import math
import warnings

import numpy as np
import torch

from . import base_sde, integrate, solvers
from ..brownian.interval import BrownianInterval, as_torch_dtype
from ..settings import METHODS, NOISE_TYPES, SDE_TYPES
from ..types import Scalar, Tensor, Vector
from ..utils import misc


def check_jax_kwargs(kwargs, entry):
    """Refuse the JAX package's seeds, so that none is dropped silently:
    ``key`` and ``entropy`` raise a TypeError naming ``generator=``. Any
    other unknown keyword warns, as in the JAX package."""
    for name in ("key", "entropy"):
        if name in kwargs:
            raise TypeError(
                f"{entry}() takes no `{name}` (a JAX seed): seed the default "
                f"noise with generator=torch.Generator(...), or pass "
                f"bm=BrownianInterval(..., {name}=...) for the JAX "
                f"package's Brownian path")
    misc.handle_unused_kwargs(kwargs, msg=f"`{entry}`")


def sdeint(sde,
           y0: Tensor,
           ts: Vector,
           bm=None,
           method=None,
           dt: Scalar = 1e-3,
           adaptive=False,
           rtol: Scalar = 1e-5,
           atol: Scalar = 1e-4,
           dt_min: Scalar = 1e-5,
           options=None,
           names=None,
           logqp=False,
           extra=False,
           extra_solver_state=None,
           generator=None,
           rng_impl="generator",
           max_steps=None,
           return_stats=False,
           unroll=1,
           remat=False,
           noise_precompute=None,
           **unused_kwargs):
    """Numerically integrate an SDE, on a fixed step grid of width ``dt``
    or, with ``adaptive=True``, with steps the error controller picks.

    ``generator`` (a ``torch.Generator`` on ``y0``'s device) seeds the
    default Brownian noise when ``bm`` is not supplied; without it the noise
    comes from PyTorch's default generator. ``rng_impl`` picks the default
    noise's normals when they are precomputed: ``"generator"`` (the
    generator's own stream) or ``"philox"`` (the port's Philox stream
    seeded from the generator; on the card a CUDA kernel, see
    ``core/integrate.sample_grid_noise``). Returns ``ys`` of shape
    ``(len(ts), batch, channels)``, then the per-interval ``log_ratio``
    when ``logqp``, the final solver state when ``extra``, and with
    ``return_stats`` the solve's counters ``{n_accepted, n_rejected, nfe,
    incomplete}`` (fixed-step: ``n_steps``, 0, ``n_steps`` times the
    solver's evaluations a step, False), as the JAX package gives them.

    ``adaptive=True`` runs ``integrate.integrate_adaptive`` from the step
    ``dt`` at ``rtol``/``atol``, no step below ``dt_min``. Its default
    noise is a ``BrownianInterval`` over ``[ts[0], ts[-1]]`` on ``y0``'s
    device keyed by two words drawn once from ``generator``, its depth
    from ``dt_min`` (``adaptive_default_levels``). Where autograd records
    the solve (grad mode on and ``y0`` or a tensor of the SDE requiring
    grad), the loop runs at most ``max_steps`` iterations (default
    ``default_max_steps``), as the JAX package's differentiable bounded
    scan: outputs not reached are NaN and ``incomplete`` is True.

    ``noise_precompute`` (fixed steps): True draws every increment before
    the loop, False makes them in the loop a step at a time, None (the
    default) precomputes unless the buffers would pass
    ``integrate.NOISE_PRECOMPUTE_MAX_BYTES``. With an explicit Brownian
    object both give the same bits; the default noise made in the loop is
    the keyed stream ``integrate.make_iid_noise_fn`` (a key drawn once
    from ``generator``), another stream of the same law, which
    ``rng_impl="philox"`` does not reach (it warns).

    A traced ``ts`` (``is_traced``: it requires grad, or a CUDA graph is
    being captured) needs an explicit ``bm`` with ``t0`` and ``t1`` (a
    ``BrownianInterval``) and fixed steps: the grid is
    ``integrate.build_step_grid(bm.t0, bm.t1, dt)``, made on the device,
    and the interval is queried there. ``ys`` is NaN, in values and
    gradients, unless ``ts[0] == bm.t0`` and ``ts[-1] <= bm.t1``; within
    them it equals the concrete call's where the grids coincide (``ts``
    from ``bm.t0``, ending at ``bm.t1`` or earlier on the grid).

    ``remat=True`` checkpoints each step (``torch.utils.checkpoint``):
    backprop through the solve keeps the states and recomputes each step's
    activations. ``unroll`` tunes the JAX package's ``lax.scan`` and
    changes no result; it is accepted and ignored. ``key`` and ``entropy``
    raise (``check_jax_kwargs``).
    """
    del unroll
    check_jax_kwargs(unused_kwargs, "sdeint")
    integrate.check_rng_impl(rng_impl)

    traced = is_traced(ts)
    sde, y0, ts, bm, method, options = check_contract(
        sde, y0, ts, bm, method, options, names, logqp, generator,
        adaptive=adaptive, dt_min=dt_min if adaptive else None)
    if adaptive and traced:
        raise ValueError("Traced `ts` is only supported for fixed-step "
                         "solves (the adaptive loop's output bookkeeping "
                         "needs concrete output times).")

    solver_cls = solvers.select(method=method, sde_type=sde.sde_type)
    bm_for_solver = None if isinstance(bm, integrate.DefaultNoise) else bm
    solver = solver_cls(sde=sde, bm=bm_for_solver, dt=dt, options=options)

    time_dtype = _time_dtype(y0)
    if extra_solver_state is None:
        t0 = torch.as_tensor(ts[0], dtype=time_dtype, device=y0.device)
        extra_solver_state = solver.init_extra_solver_state(t0, y0)

    if adaptive:
        warn_if_coarser_than_dt_min(bm, dt_min)
        if max_steps is None:
            max_steps = default_max_steps(ts, dt, dt_min)
        ys, extra_solver_state, stats = integrate.integrate_adaptive(
            solver, y0, extra_solver_state, ts, bm, dt, rtol, atol, dt_min,
            time_dtype=time_dtype,
            max_steps=int(max_steps) if _records(sde, y0) else None)
        return parse_return(y0, ys, extra_solver_state, extra, logqp,
                            stats=stats, return_stats=return_stats)

    if traced:
        grid = integrate.device_step_grid(bm.t0, bm.t1, dt, y0.device)
        solve = integrate.integrate_traced
    else:
        grid = integrate.build_step_grid(ts[0], ts[-1], dt)
        solve = integrate.integrate_fixed
    n_steps = len(grid) - 1
    precompute = integrate.should_precompute_noise(
        n_steps, bm.shape, bm.dtype, solver.needs_U, solver.needs_A,
        override=noise_precompute)
    noise = integrate.solve_noise(bm, grid, solver.needs_U, solver.needs_A,
                                  precompute, rng_impl, noise_precompute)
    ys, extra_solver_state = solve(
        solver, y0, extra_solver_state, grid, ts, noise,
        time_dtype=time_dtype, remat=remat)
    stats = dict(n_accepted=n_steps, n_rejected=0,
                 nfe=n_steps * solver.nfe_per_step, incomplete=False)
    return parse_return(y0, ys, extra_solver_state, extra, logqp,
                        stats=stats, return_stats=return_stats)


def _records(sde, y0):
    """Does autograd record a solve of ``sde`` from ``y0``: grad mode on
    and ``y0`` or a tensor the SDE holds requiring grad?"""
    if not torch.is_grad_enabled() or y0.requires_grad:
        return torch.is_grad_enabled()
    try:
        return bool(base_sde.collect_adjoint_params(sde))
    except ValueError:   # a computed tensor where the adjoint cannot swap it
        return True


def default_max_steps(ts, dt, dt_min):
    """The JAX package's iteration budget of a differentiated adaptive
    solve: ``min(max(4 ceil(span / dt) + 2T, 256), ceil(span / dt_min) +
    2T, 16384)``."""
    span = float(ts[-1] - ts[0])
    T = len(ts)
    need = int(math.ceil(span / dt_min)) + 2 * T
    guess = 4 * int(math.ceil(span / dt)) + 2 * T
    return min(max(guess, 256), need, 16384)


def warn_if_coarser_than_dt_min(bm, dt_min):
    """Warn, in the JAX package's words, when steps of ``dt_min`` are finer
    than a ``BrownianInterval``'s dyadic leaf (they would see no noise)."""
    if isinstance(bm, BrownianInterval):
        inner = bm
        leaf = (inner.t1 - inner.t0) / (1 << inner.levels)
        if dt_min < leaf:
            warnings.warn(
                f"Adaptive dt_min={dt_min:.3g} is finer than the "
                f"BrownianInterval's dyadic leaf width {leaf:.3g} "
                f"(levels={inner.levels}): steps narrower than a leaf observe "
                f"zero noise. Construct the interval with more `levels` (or a "
                f"smaller `tol`).")


_ADAPTIVE_LEVELS_CAP = 52


def adaptive_default_levels(t0, t1, dt_min, margin=2):
    """Dyadic depth of an adaptive solve's default interval: the shallowest
    whose leaf is at most ``dt_min / 2**margin``, capped at the float64
    exact 52 (20 at the reference defaults, span 2 and ``dt_min`` 1e-5)."""
    span = float(t1) - float(t0)
    if not (span > 0.0 and dt_min > 0.0):
        return _ADAPTIVE_LEVELS_CAP
    levels = int(math.ceil(math.log2(span / float(dt_min)))) + margin
    return max(0, min(_ADAPTIVE_LEVELS_CAP, levels))


def _time_dtype(y0):
    return y0.dtype if y0.dtype.is_floating_point else torch.float32


def is_traced(ts):
    """Is ``ts`` a traced schedule, one the host must not read: a tensor
    that requires grad (its gradient is wanted), or a tensor while the
    current CUDA stream is capturing a graph (a replay may see other
    times)? Lists, numpy arrays and other tensors are concrete."""
    if not torch.is_tensor(ts):
        return False
    return ts.requires_grad or (torch.cuda.is_available() and
                                torch.cuda.is_current_stream_capturing())


def host_times(ts):
    """Evaluation times as a host float64 array."""
    if torch.is_tensor(ts):
        ts = ts.detach().cpu().double()    # numpy has no bf16
    return np.asarray(ts, np.float64)


def check_contract(sde, y0, ts, bm, method, options, names, logqp,
                   generator=None, adaptive=False, dt_min=None):
    """Validate traits/shapes and fill in defaults, with the wording of
    ``torchsde_tpu.core.sdeint.check_contract``. The shape probes call the
    drift and diffusion once on ``y0`` (without recording gradients).
    Without ``bm`` the noise is the default source
    (``integrate.DefaultNoise``), or, where some direction of the solve is
    adaptive (``dt_min`` given), a ``BrownianInterval`` keyed from
    ``generator`` at the depth ``adaptive_default_levels`` picks."""
    if names is None:
        names_to_change = {}
    else:
        names_to_change = {k: names[k] for k in ("drift", "diffusion", "prior_drift",
                                                 "drift_and_diffusion",
                                                 "drift_and_diffusion_prod")
                           if k in names}
    if len(names_to_change) > 0:
        sde = base_sde.RenameMethodsSDE(sde, **names_to_change)

    if not hasattr(sde, "noise_type"):
        raise ValueError("sde does not have the attribute noise_type.")
    if sde.noise_type not in NOISE_TYPES:
        raise ValueError(f"Expected noise type in {NOISE_TYPES}, but found {sde.noise_type}.")
    if not hasattr(sde, "sde_type"):
        raise ValueError("sde does not have the attribute sde_type.")
    if sde.sde_type not in SDE_TYPES:
        raise ValueError(f"Expected sde type in {SDE_TYPES}, but found {sde.sde_type}.")

    y0 = torch.as_tensor(y0)
    if y0.ndim != 2:
        raise ValueError("`y0` must be a 2-dimensional tensor of shape (batch, channels).")

    if logqp:
        sde = base_sde.SDELogqp(sde)
        y0 = torch.cat([y0, y0.new_zeros((y0.shape[0], 1))], dim=1)

    if method is None:
        method = {
            SDE_TYPES.ito: {
                NOISE_TYPES.diagonal: METHODS.srk,
                NOISE_TYPES.additive: METHODS.srk,
                NOISE_TYPES.scalar: METHODS.srk,
                NOISE_TYPES.general: METHODS.euler,
            }[sde.noise_type],
            SDE_TYPES.stratonovich: METHODS.midpoint,
        }[sde.sde_type]
    if method not in METHODS:
        raise ValueError(f"Expected method in {METHODS}, but found {method}.")

    if is_traced(ts):
        # The JAX package's checks of a traced `ts`: no host-side check of
        # its values (the grid comes from the bm; integrate.poison_off_grid).
        if ts.ndim != 1:
            raise ValueError("Evaluation times `ts` must be one-dimensional.")
        if bm is None:
            raise ValueError(
                "Traced evaluation times `ts` require an explicit `bm` (e.g. a "
                "BrownianInterval): its [t0, t1] provides the static solve "
                "range that a traced `ts` cannot.")
        if not (hasattr(bm, "t0") and hasattr(bm, "t1")):
            raise ValueError(
                "Traced evaluation times `ts` require a `bm` exposing static "
                "`t0`/`t1` attributes (BrownianInterval does).")
        ts = ts.to(device=y0.device, dtype=_time_dtype(y0))
        t_probe = ts[0].detach()
    else:
        try:
            ts = host_times(ts)
        except Exception as e:
            raise ValueError("Evaluation times `ts` must be a 1-D array or "
                             "list/tuple of floats.") from e
        if ts.ndim != 1:
            raise ValueError("Evaluation times `ts` must be one-dimensional.")
        if not misc.is_strictly_increasing(ts):
            raise ValueError("Evaluation times `ts` must be strictly "
                             "increasing.")
        t_probe = ts[0]

    batch_sizes, state_sizes, noise_sizes = [], [], []
    batch_sizes.append(y0.shape[0])
    state_sizes.append(y0.shape[1])
    if bm is not None:
        if len(bm.shape) != 2:
            raise ValueError("`bm` must be of shape (batch, noise_channels).")
        batch_sizes.append(bm.shape[0])
        noise_sizes.append(bm.shape[1])
        # The JAX package promotes a mismatched dtype (or fails inside its
        # scan); the port names it.
        if as_torch_dtype(bm.dtype) != y0.dtype:
            raise ValueError(f"`bm` is of dtype {bm.dtype} but `y0` is of "
                             f"dtype {y0.dtype}.")
        bm_device = getattr(bm, "device", None)
        if bm_device is not None and not misc.same_device(bm_device,
                                                          y0.device):
            raise ValueError(f"`bm` is on {bm_device} but `y0` is on "
                             f"{y0.device}.")

    def _check_2d(name, shape):
        if len(shape) != 2:
            raise ValueError(f"{name} must be of shape (batch, state_channels), "
                             f"but got {tuple(shape)}.")
        batch_sizes.append(shape[0])
        state_sizes.append(shape[1])

    def _check_2d_or_3d(name, shape):
        if sde.noise_type == NOISE_TYPES.diagonal:
            if len(shape) != 2:
                raise ValueError(f"{name} must be of shape (batch, state_channels), "
                                 f"but got {tuple(shape)}.")
            batch_sizes.append(shape[0])
            state_sizes.append(shape[1])
            noise_sizes.append(shape[1])
        else:
            if len(shape) != 3:
                raise ValueError(f"{name} must be of shape (batch, state_channels, "
                                 f"noise_channels), but got {tuple(shape)}.")
            batch_sizes.append(shape[0])
            state_sizes.append(shape[1])
            noise_sizes.append(shape[2])

    t0 = torch.as_tensor(t_probe, dtype=_time_dtype(y0), device=y0.device)
    has_f = has_g = False
    with torch.no_grad():
        if base_sde.sde_has_method(sde, "f"):
            has_f = True
            _check_2d("Drift", sde.f(t0, y0).shape)
        if base_sde.sde_has_method(sde, "g"):
            has_g = True
            _check_2d_or_3d("Diffusion", sde.g(t0, y0).shape)
        if base_sde.sde_has_method(sde, "f_and_g"):
            has_f = has_g = True
            f, g = sde.f_and_g(t0, y0)
            _check_2d("Drift", f.shape)
            _check_2d_or_3d("Diffusion", g.shape)
        if base_sde.sde_has_method(sde, "g_prod"):
            has_g = True
            if len(noise_sizes) == 0:
                raise ValueError("Cannot infer noise size (i.e. number of Brownian motion "
                                 "channels). Either pass `bm` explicitly, or specify one "
                                 "of the `g`, `f_and_g` functions.`")
            v = y0.new_zeros((batch_sizes[0], noise_sizes[0]))
            _check_2d("Diffusion-vector product", sde.g_prod(t0, y0, v).shape)
        if base_sde.sde_has_method(sde, "f_and_g_prod"):
            has_f = has_g = True
            if len(noise_sizes) == 0:
                raise ValueError("Cannot infer noise size (i.e. number of Brownian motion "
                                 "channels). Either pass `bm` explicitly, or specify one "
                                 "of the `g`, `f_and_g` functions.`")
            v = y0.new_zeros((batch_sizes[0], noise_sizes[0]))
            f, gp = sde.f_and_g_prod(t0, y0, v)
            _check_2d("Drift", f.shape)
            _check_2d("Diffusion-vector product", gp.shape)

    if not has_f:
        raise ValueError("sde must define at least one of `f`, `f_and_g`, or "
                         "`f_and_g_prod`. (Or possibly more depending on the method "
                         "chosen.)")
    if not has_g:
        raise ValueError("sde must define at least one of `g`, `f_and_g`, `g_prod` or "
                         "`f_and_g_prod`. (Or possibly more depending on the method "
                         "chosen.)")

    for b in batch_sizes[1:]:
        if b != batch_sizes[0]:
            raise ValueError("Batch sizes not consistent.")
    for s in state_sizes[1:]:
        if s != state_sizes[0]:
            raise ValueError("State sizes not consistent.")
    for n in noise_sizes[1:]:
        if n != noise_sizes[0]:
            raise ValueError("Noise sizes not consistent.")

    if sde.noise_type == NOISE_TYPES.scalar and noise_sizes[0] != 1:
        raise ValueError(f"Scalar noise must have only one channel; the diffusion has "
                         f"{noise_sizes[0]} noise channels.")

    sde = base_sde.ForwardSDE(sde)

    if bm is None:
        bm = integrate.DefaultNoise(generator,
                                    (batch_sizes[0], noise_sizes[0]),
                                    y0.dtype, y0.device, method)
        if dt_min is not None:
            bm = BrownianInterval(
                t0=float(ts[0]), t1=float(ts[-1]), size=bm.shape,
                dtype=bm.dtype, key=integrate.draw_key(generator, y0.device),
                levy_area_approximation=bm.levy_area_approximation,
                levels=adaptive_default_levels(ts[0], ts[-1], dt_min),
                device=y0.device)

    options = {} if options is None else dict(options)

    if adaptive and method == METHODS.euler and sde.noise_type != NOISE_TYPES.additive:
        warnings.warn("Numerical solution is not guaranteed to converge to the correct "
                      "solution when using adaptive time-stepping with the "
                      "Euler--Maruyama method with non-additive noise.")
    return sde, y0, ts, bm, method, options


def parse_return(y0, ys, extra_solver_state, extra, logqp, stats=None,
                 return_stats=False):
    """Split off the logqp channel and difference it per output interval;
    with ``return_stats`` the counters ``stats`` come last."""
    if logqp:
        d = y0.shape[1] - 1
        ys, log_ratio = ys[..., :d], ys[..., d:]
        log_ratio_increments = (log_ratio[1:] - log_ratio[:-1]).squeeze(2)
        out = [ys, log_ratio_increments]
    else:
        out = [ys]
    if extra:
        out.append(extra_solver_state)
    if return_stats:
        out.append(stats)
    return tuple(out) if len(out) > 1 else out[0]

