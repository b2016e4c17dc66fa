"""Fixed-step integration (counterpart of ``torchsde_tpu/core/integrate.py``).

A fixed-step solve walks a host-side float64 step grid in a Python loop and
interpolates the grid states onto the requested ``ts``. Its noise is drawn in
one pass before the loop: the default source draws i.i.d. increments from the
caller's ``torch.Generator`` (``sample_grid_noise``, the only place solve
noise is drawn), and an explicit Brownian object is queried for every grid
cell up front (``precompute_bm_noise``).
"""

import math

import numpy as np
import torch

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


def integrate_fixed(solver, y0, extra0, grid, ts, noise_xs, time_dtype=None):
    """Fixed-step solve over ``grid``, interpolated onto ``ts``.

    ``noise_xs`` is a ``(W, U, A)`` triple with leading dimension
    ``len(grid) - 1``. Returns ``(ys, extra_final)`` with ``ys`` of leading
    dimension ``len(ts)``."""
    if time_dtype is None:
        time_dtype = y0.dtype
    grid_dev = torch.as_tensor(grid, dtype=time_dtype, device=y0.device)
    W, U, A = noise_xs
    y, extra = y0, extra0
    ys = [y0]
    for i in range(len(grid) - 1):
        noise = (W[i], None if U is None else U[i], None if A is None else A[i])
        y, extra = solver.step(grid_dev[i], grid_dev[i + 1], y, extra, noise)
        ys.append(y)
    ts_dev = torch.as_tensor(np.asarray(ts, np.float64), dtype=time_dtype,
                             device=y0.device)
    return linear_interp_on_grid(ts_dev, grid_dev, torch.stack(ys)), extra
