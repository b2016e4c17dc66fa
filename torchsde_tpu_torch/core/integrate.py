"""Fixed-step and adaptive integration (counterpart of
``torchsde_tpu/core/integrate.py``).

A fixed-step solve (``integrate_fixed``) walks a host-side float64 step
grid in a Python loop, keeps only the grid states that bracket an output
time (the output times are concrete, so the host finds them) and
interpolates them onto ``ts``; the adjoint's solve steps to every output
time instead (``build_interval_grid``, ``integrate_to_outputs``). A traced
``ts``, which the host never reads, steps a grid made on the device
(``device_step_grid``), keeps every state and interpolates on the device
(``integrate_traced``).

Its noise takes one of three forms (``solve_noise``): drawn in one pass
before the loop (the default source's i.i.d. increments from the caller's
``torch.Generator``, ``sample_grid_noise``, drawn again by ``NoiseReplay``;
an explicit Brownian object's ``query_grid``, ``precompute_bm_noise``), or
made inside the loop a step at a time once the buffers would pass
``NOISE_PRECOMPUTE_MAX_BYTES`` (``should_precompute_noise``): the default
source's keyed stream ``make_iid_noise_fn``, a pure function of (key, step
index), or the object queried per step (``bm_noise_fn``).

An adaptive solve (``integrate_adaptive``) is one host-driven loop: each
iteration emits an output by linear interpolation or makes one attempt (a
full step against two half steps, the PI controller of ``adaptive_attempt``).
The attempt's error is its one device-to-host read; the controller, the
step times and the accept decision are host scalars of the solve's time
dtype. Autograd differentiates the loop as written; rejected attempts leave
no graph behind.
"""

import math
import warnings

import numpy as np
import torch
import torch.utils.checkpoint

from ..brownian import threefry
from ..brownian.base import BaseBrownian, levy_area
from ..brownian.interval import as_torch_dtype, np_dtype, on_host
from ..ops import prng
from ..settings import LEVY_AREA_APPROXIMATIONS, METHODS

# Sources of the default noise's normals: the generator's own stream, or
# the port's Philox stream seeded from it (ops/prng.py, kernel 16 on the
# card), the counterpart of the JAX package's rng_impl='pallas'.
RNG_IMPLS = ("generator", "philox")


# Noise buffers of a fixed grid past this size are made inside the loop a
# step at a time (``should_precompute_noise``), so that neither a solve nor
# the adjoint's O(T) memory grows with the number of steps.
NOISE_PRECOMPUTE_MAX_BYTES = 1 << 30


def _itemsize(dtype):
    return torch.empty((), dtype=as_torch_dtype(dtype)).element_size()


def noise_buffer_bytes(n_steps, size, dtype, needs_U, needs_A):
    """Bytes of the (W[, U][, A]) buffers precomputed for a fixed grid."""
    base = int(n_steps) * int(np.prod(size, dtype=np.int64)) if size \
        else int(n_steps)
    m = size[-1] if len(size) >= 2 else 1
    channels = 1 + int(bool(needs_U)) + (m if needs_A else 0)
    return base * _itemsize(dtype) * channels


def should_precompute_noise(n_steps, size, dtype, needs_U, needs_A,
                            override=None):
    """Precompute the noise of a fixed grid, or make it inside the loop?
    ``override`` True or False forces the choice (``noise_precompute=``);
    None precomputes unless the buffers would pass
    ``NOISE_PRECOMPUTE_MAX_BYTES``. A pure function of its arguments, so
    the adjoint's two passes decide alike."""
    if override is not None:
        return bool(override)
    return noise_buffer_bytes(n_steps, size, dtype, needs_U, needs_A) \
        <= NOISE_PRECOMPUTE_MAX_BYTES


def draw_key(generator, device):
    """A Threefry key (two 32-bit words, ``brownian/threefry.py``) drawn
    once from ``generator`` (PyTorch's default generator of ``device`` when
    None), on ``device`` without a host sync: the seed of a solve's keyed
    noise, the in-loop stream or an adaptive solve's default interval."""
    return torch.randint(0, 2 ** 32, (2,), generator=generator,
                         dtype=torch.int64, device=device)


def make_iid_noise_fn(key, size, dtype, needs_U=False, needs_A=False,
                      levy_area_approximation=LEVY_AREA_APPROXIMATIONS.none):
    """The default noise made inside the loop, a step at a time.

    Returns ``noise_fn(i, t0, t1) -> (W, U, A)`` for the grid's step ``i``
    from ``t0`` to ``t1`` (tensors of the time dtype on the key's device).
    Each channel's normals are keyed by ``fold_in(channel_key, i)`` with
    the channel keys ``split(key, 3)``, as the JAX package's
    ``make_iid_noise_fn`` keys them, so the stream is a pure function of
    (key, step index): the adjoint's backward replays it in any order, and
    from the same key words its W is the JAX package's to the rounding of
    ``erfinv``. The law is ``sample_grid_noise``'s, the stream another."""
    dtype = as_torch_dtype(dtype)
    size = tuple(size)
    key_w, key_h, key_a = threefry.split(key, 3)

    def noise_fn(i, t0, t1):
        h = (t1 - t0).to(dtype)
        W = threefry.normal(threefry.fold_in(key_w, i), size, dtype) \
            * torch.sqrt(h)
        U = A = H = None
        if needs_U or needs_A:
            H = threefry.normal(threefry.fold_in(key_h, i), size, dtype) \
                * torch.sqrt(h / 12.0)
            U = h * (0.5 * W + H)
        if needs_A:
            if len(size) in (0, 1):
                A = torch.zeros(size, dtype=dtype, device=W.device)
            else:
                noise = threefry.normal(threefry.fold_in(key_a, i),
                                        (*size, size[-1]), dtype)
                A = levy_area(W, H, h, noise, levy_area_approximation)
        return W, (U if needs_U else None), A

    return noise_fn


def bm_noise_fn(bm, grid, needs_U, needs_A):
    """An explicit Brownian object queried inside the loop: ``noise_fn(i,
    t0, t1)`` asks ``bm`` for the cell ``(grid[i], grid[i + 1])`` of the
    float64 ``grid``, so its increments are bitwise those of
    ``precompute_bm_noise`` over the same grid. A grid on the card
    (``device_step_grid``) is queried with its own 0-d tensors, which a
    ``BrownianInterval`` resolves there without a host read."""
    def noise_fn(i, t0, t1):
        if on_host(grid):
            return query_bm(bm, float(grid[i]), float(grid[i + 1]), needs_U,
                            needs_A)
        return query_bm(bm, grid[i], grid[i + 1], needs_U, needs_A)
    return noise_fn


def build_step_grid(t0, t1, dt):
    """Host-side step grid in float64: t0, t0+dt, ..., capped at t1 (the last
    step may be short)."""
    t0, t1, dt = float(t0), float(t1), float(dt)
    n = max(1, int(math.ceil((t1 - t0) / dt - 1e-9)))
    grid = t0 + dt * np.arange(n + 1, dtype=np.float64)
    grid[-1] = t1
    return grid


def device_step_grid(t0, t1, dt, device):
    """``build_step_grid(t0, t1, dt)`` as a float64 tensor made on
    ``device`` by its own arithmetic (``t0 + dt * k``, the last point
    ``t1``), bitwise the host grid's copy but with no host-to-device copy,
    so that it can be made inside a CUDA graph capture."""
    n = len(build_step_grid(t0, t1, dt)) - 1
    k = torch.arange(n + 1, dtype=torch.float64, device=device)
    return torch.where(k == n, torch.full_like(k, float(t1)),
                       float(t0) + float(dt) * k)


def check_rng_impl(rng_impl):
    if rng_impl not in RNG_IMPLS:
        raise ValueError(f"rng_impl must be one of {RNG_IMPLS}, got "
                         f"{rng_impl!r}")


def sample_grid_noise(generator, grid, size, dtype, device=None,
                      needs_U=False, needs_A=False, rng_impl="generator",
                      levy_area_approximation=LEVY_AREA_APPROXIMATIONS.none):
    """I.i.d. per-step Brownian increments for a fixed step grid, in one pass.

    Returns ``(W, U, A)`` with ``W`` of shape ``(N, *size)``, each increment
    ``N(0, 1)`` scaled by ``sqrt(dt)``, where the step widths are the
    float64 grid differences cast to ``dtype``. With ``needs_U`` also the
    space-time Levy integral ``U = dt * (W / 2 + H)`` with an independent
    ``H ~ N(0, dt / 12)``. With ``needs_A`` the full Levy area ``A`` of
    shape ``(N, *size, m)``: ``H (x) W - W (x) H`` plus antisymmetrised
    normal noise scaled by Davie's ``dt / sqrt(12)`` or, for
    ``levy_area_approximation='foster'``, Foster's
    ``sqrt(dt/10 (dt/10 + H_i^2 + H_j^2))``; zero for a size of rank 0 or 1.

    ``rng_impl='generator'`` draws the normals from ``generator`` (W's, then
    H's, then A's). ``rng_impl='philox'`` draws one seed from it, ``randint(0,
    2**31 - 1)`` kept as a one-element int32 tensor on ``device`` (no host
    sync), and takes W's normals from the Philox stream of that seed, H's
    from the seed plus one and A's from the seed plus two
    (``ops/prng.philox_normal``: the CUDA kernel on the card, its plain
    version on the CPU)."""
    check_rng_impl(rng_impl)
    n = len(grid) - 1
    shape = (n, *size)
    bshape = (n,) + (1,) * len(size)
    dts = torch.as_tensor(np.diff(grid), dtype=dtype,
                          device=device).reshape(bshape)
    if rng_impl == "philox":
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             dtype=torch.int32, device=device)

    def normal(stream, draw_shape):
        if rng_impl == "philox":
            return prng.philox_normal(seed + stream, draw_shape, dtype, device)
        return torch.randn(draw_shape, generator=generator, dtype=dtype,
                           device=device)

    W = normal(0, shape) * torch.sqrt(dts)
    U = A = None
    if needs_U or needs_A:
        H = normal(1, shape) * torch.sqrt(dts / 12.0)
        U = dts * (0.5 * W + H)
    if needs_A:
        if len(size) in (0, 1):
            A = torch.zeros(shape, dtype=dtype, device=device)
        else:
            A = levy_area(W, H, dts, normal(2, (*shape, size[-1])),
                          levy_area_approximation)
    return W, (U if needs_U else None), A


def precompute_bm_noise(bm, grid, needs_U, needs_A):
    """Every increment of a fixed grid from an explicit Brownian object, in
    one pass before the loop. Uses the sampler's bulk ``query_grid`` when it
    has one, else the generic implementation of ``BaseBrownian``."""
    if hasattr(bm, "query_grid"):
        return bm.query_grid(grid, return_U=needs_U, return_A=needs_A)
    return BaseBrownian.query_grid(bm, grid, return_U=needs_U,
                                   return_A=needs_A)


def linear_interp_on_grid(out_ts, grid, ys_grid):
    """Linear interpolation of grid states ``ys_grid`` (leading axis over
    ``grid``) onto ``out_ts``. Exact (the grid value itself) when an output
    time coincides with a grid point."""
    idx = torch.searchsorted(grid, out_ts, side="left").clamp(1, len(grid) - 1)
    t_lo = grid[idx - 1]
    t_hi = grid[idx]
    w = (out_ts - t_lo) / (t_hi - t_lo)
    w_b = w.reshape(w.shape + (1,) * (ys_grid.ndim - 1)).to(ys_grid.dtype)
    return ys_grid[idx - 1] * (1 - w_b) + ys_grid[idx] * w_b


def poison_off_grid(ys, ts, grid):
    """``ys`` times NaN where the traced schedule ``ts`` does not start at
    ``grid[0]`` or ends past ``grid[-1]``, else times one, decided on the
    device (the JAX package's rule for traced ``ts``): such a schedule would
    silently solve another problem than the same call with concrete times,
    or extrapolate the last cell. Multiplying, not selecting, keeps the NaN
    in the gradients too."""
    ok = (ts[0] == grid[0]) & (ts[-1] <= grid[-1])
    return ys * torch.where(ok, 1.0, float("nan")).to(ys.dtype)


def integrate_traced(solver, y0, extra0, grid, ts, noise, time_dtype=None,
                     remat=False):
    """Fixed-step solve over the whole float64 ``grid`` on ``y0``'s device
    (``device_step_grid``), keeping every grid state, since a traced
    schedule can bracket any cell; the states are interpolated onto the
    tensor ``ts`` on the device (``linear_interp_on_grid``, so gradients
    reach ``ts``) and poisoned where ``ts`` leaves the grid
    (``poison_off_grid``). Reads nothing to the host. ``noise`` as
    ``integrate_to_outputs`` takes it. Returns ``(ys, extra_final)``."""
    if time_dtype is None:
        time_dtype = y0.dtype
    grid_dev = grid.to(time_dtype)
    ys_grid, extra = integrate_to_outputs(
        solver, y0, extra0, grid_dev, range(len(grid)), noise,
        time_dtype=time_dtype, remat=remat)
    ys = linear_interp_on_grid(ts, grid_dev, ys_grid)
    return poison_off_grid(ys, ts, grid_dev), extra


def integrate_fixed(solver, y0, extra0, grid, ts, noise, time_dtype=None,
                    remat=False):
    """Fixed-step solve over the host float64 ``grid``, interpolated onto
    the host times ``ts``. Keeps only the grid states that bracket an
    output time (at most 2T + 1, found on the host), so its memory is O(T)
    for any ``dt``. The interpolation is ``linear_interp_on_grid``'s
    arithmetic on the host's bracketing indices, read through the kept
    states: exact where an output time is a grid point. The brackets are
    found on the grid and the times rounded to the time dtype, as
    ``linear_interp_on_grid`` finds them on the device: where two grid
    points round to one value (a last step shorter than the dtype
    resolves), an output time there takes the earlier interval, whose
    width is not zero. ``noise`` as ``integrate_to_outputs`` takes it;
    ``remat`` checkpoints only the step, never the kept states. Returns
    ``(ys, extra_final)`` with ``ys`` of leading dimension ``len(ts)``."""
    if time_dtype is None:
        time_dtype = y0.dtype
    grid = np.asarray(grid, np.float64)
    n_steps = len(grid) - 1
    ts_host = np.asarray(ts, np.float64)
    idx = np.clip(np.searchsorted(_rounded(grid, time_dtype),
                                  _rounded(ts_host, time_dtype),
                                  side="left"), 1, n_steps)
    lo, hi = idx - 1, idx
    kept = np.union1d([0], np.concatenate([lo, hi]))
    grid_dev = torch.as_tensor(grid, dtype=time_dtype, device=y0.device)
    buf, extra = integrate_to_outputs(solver, y0, extra0, grid_dev, kept,
                                      noise, time_dtype=time_dtype,
                                      remat=remat)
    pos_lo = torch.as_tensor(np.searchsorted(kept, lo), device=y0.device)
    pos_hi = torch.as_tensor(np.searchsorted(kept, hi), device=y0.device)
    t_lo = grid_dev[torch.as_tensor(lo, device=y0.device)]
    t_hi = grid_dev[torch.as_tensor(hi, device=y0.device)]
    ts_dev = torch.as_tensor(ts_host, dtype=time_dtype, device=y0.device)
    # Only a first step narrower than the dtype resolves is still 0 wide
    # (ts[0] on its two rounded ends): take its left end.
    w = torch.where(t_hi > t_lo, (ts_dev - t_lo) / (t_hi - t_lo), 0.0)
    w_b = w.reshape(w.shape + (1,) * (buf.ndim - 1)).to(buf.dtype)
    return buf[pos_lo] * (1 - w_b) + buf[pos_hi] * w_b, extra


def _rounded(times, dtype):
    """Host float64 times rounded to ``dtype`` (bf16 too, which numpy
    lacks), as float64."""
    return torch.as_tensor(times, dtype=torch.float64).to(dtype).double() \
        .numpy()


def build_interval_grid(ts, dt):
    """Per-output-interval step grid on the host, float64: each
    ``[ts[i], ts[i+1]]`` is stepped with size ``dt`` (its last step
    shortened), so every output time is a grid point. Returns ``(grid,
    boundary_idx)``, ``grid[boundary_idx[i]] == ts[i]``. The adjoint's
    backward re-steps exactly these ``(t0, t1)`` pairs in reverse."""
    ts = np.asarray(ts, np.float64)
    grid = [ts[0]]
    boundary_idx = [0]
    for a, b in zip(ts[:-1], ts[1:]):
        n = max(1, int(math.ceil((b - a) / dt - 1e-9)))
        sub = a + dt * np.arange(1, n + 1)
        sub[-1] = b
        grid.extend(sub.tolist())
        boundary_idx.append(len(grid) - 1)
    return np.asarray(grid, np.float64), np.asarray(boundary_idx, np.int64)


def noise_getter(noise):
    """``noise_at(i, t0, t1) -> (W, U, A)`` of step ``i`` from a
    precomputed ``(W, U, A)`` triple (indexed) or an in-loop ``noise(i,
    t0, t1)`` (called)."""
    if callable(noise):
        return noise
    W, U, A = noise

    def noise_at(i, t0, t1):
        return (W[i], None if U is None else U[i],
                None if A is None else A[i])
    return noise_at


def integrate_to_outputs(solver, y0, extra0, grid, boundary_idx, noise,
                         time_dtype=None, remat=False):
    """Fixed-step solve over ``grid`` that keeps only the states at the
    grid points ``boundary_idx`` (sorted, from 0; the output times: O(T)
    memory, not O(steps), for the adjoint). ``grid`` is host float64, or
    already a tensor of ``time_dtype`` on ``y0``'s device.
    ``noise`` is a ``(W, U, A)`` triple with leading dimension ``len(grid)
    - 1``, or ``noise(i, t0, t1) -> (W, U, A)`` called for each step ``i``
    inside the loop (``make_iid_noise_fn``, ``bm_noise_fn``). With
    ``remat`` each step, its in-loop noise included, runs under
    ``torch.utils.checkpoint``, so backprop keeps the states and recomputes
    the step. Returns ``(ys, extra_final)``."""
    if time_dtype is None:
        time_dtype = y0.dtype
    grid_dev = torch.as_tensor(grid, dtype=time_dtype, device=y0.device)
    noise_at = noise_getter(noise)

    def step(i, t0, t1, y, extra):
        return solver.step(t0, t1, y, extra, noise_at(i, t0, t1))

    if remat:
        def step(*args, step=step):
            return torch.utils.checkpoint.checkpoint(step, *args,
                                                     use_reentrant=False)
    outputs = set(int(b) for b in boundary_idx[1:])
    y, extra = y0, extra0
    ys = [y0]
    for i in range(len(grid) - 1):
        y, extra = step(i, grid_dev[i], grid_dev[i + 1], y, extra)
        if i + 1 in outputs:
            ys.append(y)
    return torch.stack(ys), extra


def query_bm(bm, t0, t1, needs_U, needs_A):
    """Query a Brownian object, normalising the return to a ``(W, U, A)``
    triple."""
    if needs_U and needs_A:
        W, U, A = bm(t0, t1, return_U=True, return_A=True)
    elif needs_U:
        W, U = bm(t0, t1, return_U=True)
        A = None
    elif needs_A:
        W, A = bm(t0, t1, return_A=True)
        U = None
    else:
        W = bm(t0, t1)
        U = A = None
    return W, U, A


def _generator_of(generator, device):
    """``generator``, or PyTorch's default generator of ``device``'s type
    (the one ``torch.randn`` draws from without a generator)."""
    if generator is not None:
        return generator
    device = torch.device(device)
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        return torch.cuda.default_generators[index]
    return torch.default_generator


class NoiseReplay:
    """The default noise of one solve, drawn once and drawn again on demand.

    ``draw`` records the state of the generator the solve draws from (the
    caller's, or PyTorch's default one of the device) and then calls
    ``sample_grid_noise`` with it, advancing it as a plain solve does.
    ``redraw`` draws the same increments from a fresh generator on the same
    device set to the recorded state, so the caller's generator is left as
    the first draw left it. This holds for ``rng_impl="generator"`` (the
    same stream) and ``"philox"`` (the same one-element seed, so the same
    Philox stream). Only the state is kept between the two, not the noise;
    W comes first from the stream, so the redraw's W is bitwise the draw's
    whether or not either asks for U or A."""

    def __init__(self, generator, size, dtype, device, rng_impl,
                 levy_area_approximation):
        self.generator = generator
        self.size = tuple(size)
        self.dtype = dtype
        self.device = device
        self.rng_impl = rng_impl
        self.levy_area_approximation = levy_area_approximation
        self.state = None

    def _sample(self, generator, grid, needs_U, needs_A):
        return sample_grid_noise(
            generator, grid, self.size, self.dtype, self.device,
            needs_U=needs_U, needs_A=needs_A, rng_impl=self.rng_impl,
            levy_area_approximation=self.levy_area_approximation)

    def draw(self, grid, needs_U=False, needs_A=False):
        self.state = _generator_of(self.generator, self.device).get_state()
        return self._sample(self.generator, grid, needs_U, needs_A)

    def redraw(self, grid, needs_U=False, needs_A=False):
        if self.state is None:
            raise RuntimeError("redraw before draw")
        replay = torch.Generator(device=self.device)
        replay.set_state(self.state)
        return self._sample(replay, grid, needs_U, needs_A)


class DefaultNoise:
    """Marker for the framework-owned noise source: i.i.d. increments of
    ``shape`` drawn from ``generator`` on the step grid, with the Levy-area
    approximation the JAX package's default interval takes for the
    method."""

    def __init__(self, generator, shape, dtype, device, method):
        self.generator = generator
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = device
        if method == METHODS.srk:
            self.levy_area_approximation = LEVY_AREA_APPROXIMATIONS.space_time
        elif method == METHODS.log_ode_midpoint:
            self.levy_area_approximation = LEVY_AREA_APPROXIMATIONS.foster
        else:
            self.levy_area_approximation = LEVY_AREA_APPROXIMATIONS.none


def solve_noise(bm, grid, needs_U, needs_A, precompute, rng_impl,
                noise_precompute=None, key=None):
    """The noise of a fixed-step solve over ``grid`` from ``bm`` (a
    ``DefaultNoise`` or a Brownian object), in the form
    ``integrate_to_outputs`` takes: precomputed where ``precompute``, else
    made in the loop. The default source's in-loop stream is keyed by
    ``key``, drawn from its generator when None, and ``rng_impl="philox"``
    warns that it does not reach it (worded by the caller's
    ``noise_precompute``)."""
    if not isinstance(bm, DefaultNoise):
        if precompute:
            return precompute_bm_noise(bm, grid, needs_U, needs_A)
        return bm_noise_fn(bm, grid, needs_U, needs_A)
    if precompute:
        return sample_grid_noise(
            bm.generator, grid, bm.shape, bm.dtype, bm.device,
            needs_U=needs_U, needs_A=needs_A, rng_impl=rng_impl,
            levy_area_approximation=bm.levy_area_approximation)
    if rng_impl == "philox":
        # The JAX package's warning for its bulk generator ('pallas').
        reason = ("noise_precompute=False was requested"
                  if noise_precompute is False else
                  "noise buffers exceed the precompute threshold")
        warnings.warn("rng_impl='philox' only applies to precomputed noise; "
                      "this solve generates per-step threefry noise inside "
                      f"the loop ({reason}).")
    if key is None:
        key = draw_key(bm.generator, bm.device)
    return make_iid_noise_fn(
        key, bm.shape, bm.dtype, needs_U=needs_U, needs_A=needs_A,
        levy_area_approximation=bm.levy_area_approximation)


# --------------------------------------------------------------------------- #
#  Adaptive stepping                                                          #
# --------------------------------------------------------------------------- #

_SAFETY = 0.9
_FACMAX = 1.4
_FACMIN = 0.2


def query_bm_pairs(bm, points, pairs, needs_U, needs_A):
    """Several intervals over shared endpoints as ``(W, U, A)`` triples:
    one descent a point through the sampler's ``query_pairs`` (bitwise the
    pairs' ``__call__``), else one query a pair."""
    if not hasattr(bm, "query_pairs"):
        return [query_bm(bm, points[ia], points[ib], needs_U, needs_A)
                for ia, ib in pairs]
    res = []
    for o in bm.query_pairs(points, pairs, return_U=needs_U,
                            return_A=needs_A):
        o = list(o) if (needs_U or needs_A) else [o]
        W = o.pop(0)
        U = o.pop(0) if needs_U else None
        A = o.pop(0) if needs_A else None
        res.append((W, U, A))
    return res


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [] if tree is None else [tree]


def _compute_error(y_full, y_half, rtol, atol, eps=1e-7):
    """RMS over every element of the state (each tensor of a tuple state)
    of ``(y_full - y_half) / tol``, ``tol = max(rtol * max(|a|, |b|) +
    atol, eps)``, floored at ``eps``; a NaN estimate is 1e30 (a reject), not
    an endless loop. A 0-d tensor on the state's device."""
    sq_sum, count = 0.0, 0
    for a, b in zip(_leaves(y_full), _leaves(y_half)):
        tol = torch.clamp_min(rtol * torch.maximum(a.abs(), b.abs()) + atol,
                              eps)
        sq_sum = sq_sum + torch.sum(torch.square((a - b) / tol))
        count += a.numel()
    error = torch.clamp_min(torch.sqrt(sq_sum / count), eps)
    return torch.where(torch.isnan(error), torch.full_like(error, 1e30),
                       error)


def _update_step_size(error, prev_h, prev_ratio, prev_ratio_valid):
    """The PI controller on host scalars: ``error``, ``prev_h`` and
    ``prev_ratio`` numpy scalars of one float dtype, every constant rounded
    to it first, as the JAX package's weakly typed constants are. Returns
    ``(new_h, new_prev_ratio, True)``."""
    c = type(error)
    reject = bool(error > 1.0)
    ifactor = c(1.0 / 1.5) if reject else c(1.0 / 4.5)
    pfactor = c(0.0) if reject else c(0.13)
    ratio = c(_SAFETY) / error
    prev_ratio_eff = prev_ratio if prev_ratio_valid else ratio
    factor = ratio ** ifactor * (ratio / prev_ratio_eff) ** pfactor
    facmin = c(_FACMIN) if reject else c(1.0)
    factor = min(c(_FACMAX), max(facmin, factor))
    return (prev_h * factor, prev_ratio_eff if reject else ratio, True)


def adaptive_attempt(solver, bm, t, next_t, state, extra, h, prev_ratio,
                     prev_ratio_valid, rtol, atol, dt_min):
    """One attempt from ``t`` to ``next_t``: a full step against two half
    steps over the three endpoints ``t``, ``mid``, ``next_t``, queried once
    each (``query_bm_pairs``), the RMS error read to the host (the
    attempt's one sync), the PI controller, the ``dt_min`` floor and the
    accept rule ``error <= 1 or h_new <= dt_min``. The times, ``h`` and
    ``prev_ratio`` are numpy scalars of the solve's time dtype; the error
    is data, not differentiated. Returns ``(y_next, extra_next, accept,
    h_new, prev_ratio, prev_ratio_valid)``."""
    c = type(t)
    mid_t = c(0.5) * (t + next_t)
    noise_full, noise_h1, noise_h2 = query_bm_pairs(
        bm, [float(t), float(mid_t), float(next_t)],
        ((0, 2), (0, 1), (1, 2)), solver.needs_U, solver.needs_A)
    device = _leaves(state)[0].device
    t_d, mid_d, next_d = torch.as_tensor(
        np.array([t, mid_t, next_t]), device=device).unbind(0)
    y_full, _ = solver.step(t_d, next_d, state, extra, noise_full)
    y_mid, extra_mid = solver.step(t_d, mid_d, state, extra, noise_h1)
    y_next, extra_next = solver.step(mid_d, next_d, y_mid, extra_mid,
                                     noise_h2)
    with torch.no_grad():
        error = _compute_error(y_full, y_next, rtol, atol)
    del y_full
    error = c(error.item())
    h_new, prev_ratio, prev_ratio_valid = _update_step_size(
        error, h, prev_ratio, prev_ratio_valid)
    floor = c(dt_min)
    hit_min = h_new < floor
    h_new = max(h_new, floor)
    prev_ratio_valid = prev_ratio_valid and not hit_min
    accept = bool(error <= 1.0) or bool(h_new <= floor)
    return y_next, extra_next, accept, h_new, prev_ratio, prev_ratio_valid


def integrate_adaptive(solver, y0, extra0, ts, bm, dt0, rtol, atol, dt_min,
                       time_dtype=None, max_steps=None):
    """Adaptive solve, one Python loop: each iteration either emits the
    next output by linear interpolation between the last two accepted
    states, or makes one ``adaptive_attempt``. Times and the controller
    run on the host in ``time_dtype``.

    ``max_steps`` (None for no bound) caps the iterations, emits included,
    as the JAX package's differentiable bounded scan counts them; outputs
    not reached hold NaN and ``incomplete`` is True. Returns ``(ys,
    extra_final, stats)``, ``stats`` ``{n_accepted, n_rejected, nfe,
    incomplete}`` with ``nfe = 3 * solver.nfe_per_step * attempts``."""
    if time_dtype is None:
        time_dtype = y0.dtype
    c = np_dtype(time_dtype)
    ts_t = np.asarray(ts, np.float64).astype(c)
    T = len(ts_t)
    t_end = ts_t[-1]
    curr_t = prev_t = ts_t[0]
    curr_y = prev_y = y0
    extra = extra0
    h, prev_ratio, prev_ratio_valid = c(dt0), c(1.0), False
    ys = [y0]
    n_accepted = n_rejected = iterations = 0
    while len(ys) < T and (max_steps is None or iterations < max_steps):
        iterations += 1
        out_t = ts_t[len(ys)]
        if curr_t >= out_t:
            denom = curr_t - prev_t if curr_t > prev_t else c(1.0)
            w = float((out_t - prev_t) / denom)
            ys.append(prev_y + (curr_y - prev_y) * w)
            continue
        next_t = min(curr_t + h, t_end)
        (y_next, extra_next, accept, h, prev_ratio,
         prev_ratio_valid) = adaptive_attempt(
            solver, bm, curr_t, next_t, curr_y, extra, h, prev_ratio,
            prev_ratio_valid, rtol, atol, dt_min)
        if accept:
            prev_t, prev_y = curr_t, curr_y
            curr_t, curr_y, extra = next_t, y_next, extra_next
            n_accepted += 1
        else:
            n_rejected += 1
    incomplete = len(ys) < T
    ys += [torch.full_like(y0, float("nan"))] * (T - len(ys))
    stats = dict(n_accepted=n_accepted, n_rejected=n_rejected,
                 nfe=3 * solver.nfe_per_step * (n_accepted + n_rejected),
                 incomplete=incomplete)
    return torch.stack(ys), extra, stats
