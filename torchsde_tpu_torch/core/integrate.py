"""Fixed-step integration (counterpart of ``torchsde_tpu/core/integrate.py``).

A fixed-step solve walks a host-side float64 step grid in a Python loop and
interpolates the grid states onto the requested ``ts``; the adjoint's solve
steps to every output time instead (``build_interval_grid``,
``integrate_to_outputs``). Its noise is drawn in one pass before the loop:
the default source draws i.i.d. increments from the caller's
``torch.Generator`` (``sample_grid_noise``, the only place solve noise is
drawn; ``NoiseReplay`` draws the same increments again), and an explicit
Brownian object is queried for every grid cell up front
(``precompute_bm_noise``). The JAX package's in-loop noise for buffers past
1 GiB (``make_iid_noise_fn``, ``should_precompute_noise``) is not ported
yet (ROADMAP queue 1 item 2): every solve here holds its whole noise.
"""

import math

import numpy as np
import torch
import torch.utils.checkpoint

from ..brownian.base import BaseBrownian, levy_area
from ..ops import prng
from ..settings import LEVY_AREA_APPROXIMATIONS

# Sources of the default noise's normals: the generator's own stream, or
# the port's Philox stream seeded from it (ops/prng.py, kernel 16 on the
# card), the counterpart of the JAX package's rng_impl='pallas'.
RNG_IMPLS = ("generator", "philox")


def build_step_grid(t0, t1, dt):
    """Host-side step grid in float64: t0, t0+dt, ..., capped at t1 (the last
    step may be short)."""
    t0, t1, dt = float(t0), float(t1), float(dt)
    n = max(1, int(math.ceil((t1 - t0) / dt - 1e-9)))
    grid = t0 + dt * np.arange(n + 1, dtype=np.float64)
    grid[-1] = t1
    return grid


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


def integrate_fixed(solver, y0, extra0, grid, ts, noise_xs, time_dtype=None,
                    remat=False):
    """Fixed-step solve over ``grid``, interpolated onto ``ts``: every grid
    state is kept (``integrate_to_outputs`` with every grid point an
    output). Returns ``(ys, extra_final)`` with ``ys`` of leading dimension
    ``len(ts)``."""
    if time_dtype is None:
        time_dtype = y0.dtype
    grid_dev = torch.as_tensor(grid, dtype=time_dtype, device=y0.device)
    ys, extra = integrate_to_outputs(solver, y0, extra0, grid_dev,
                                     np.arange(len(grid)), noise_xs,
                                     time_dtype=time_dtype, remat=remat)
    ts_dev = torch.as_tensor(np.asarray(ts, np.float64), dtype=time_dtype,
                             device=y0.device)
    return linear_interp_on_grid(ts_dev, grid_dev, ys), extra


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


def integrate_to_outputs(solver, y0, extra0, grid, boundary_idx, noise_xs,
                         time_dtype=None, remat=False):
    """Fixed-step solve over ``grid`` that keeps only the states at the
    grid points ``boundary_idx`` (the output times: O(T) memory, not
    O(steps), for the adjoint). ``grid`` is host float64, or already a
    tensor of ``time_dtype`` on ``y0``'s device. ``noise_xs`` is a ``(W, U, A)`` triple
    with leading dimension ``len(grid) - 1``. With ``remat`` each step runs
    under ``torch.utils.checkpoint``, so backprop keeps the states and
    recomputes the step. Returns ``(ys, extra_final)``."""
    if time_dtype is None:
        time_dtype = y0.dtype
    grid_dev = torch.as_tensor(grid, dtype=time_dtype, device=y0.device)
    step = solver.step
    if remat:
        def step(*args):
            return torch.utils.checkpoint.checkpoint(solver.step, *args,
                                                     use_reentrant=False)
    outputs = set(int(b) for b in boundary_idx[1:])
    W, U, A = noise_xs
    y, extra = y0, extra0
    ys = [y0]
    for i in range(len(grid) - 1):
        noise = (W[i], None if U is None else U[i], None if A is None else A[i])
        y, extra = step(grid_dev[i], grid_dev[i + 1], y, extra, noise)
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
