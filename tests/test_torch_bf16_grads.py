"""bfloat16 gradients of the port against torchsde_tpu's, ulp for ulp.

Both packages solve the same bfloat16 SDEs on the same seeded tables
(made with numpy, rounded to bfloat16 once): backprop through ``sdeint``
and ``sdeint_adjoint``, by Euler (Itô) and by the reversible-Heun pair
(Stratonovich), on a linear SDE and on one with ``sin`` (ops that round
alike in both frameworks; tests/test_torch_srk_bf16.py holds the solves
themselves bitwise). Each gradient is held to the JAX package's within a
stated number of bfloat16 ulps of its largest entry, 0 where the two are
bitwise. The tables serve both the forward's queries and the adjoint's:
the whole grid (``query_grid``) or one step (``__call__``).

Where they differ, and why (ROADMAP.md queue 3):
- ``y0`` by the adjoint: bitwise. The port summed the adjoint drift's vjp
  and the Itô-conversion term's in one autograd pass, which adds their
  terms in another order than the JAX package's two vjps and a sum; 2 of
  15 entries were one ulp apart after three Euler steps. The port now
  takes the JAX package's two vjps (core/adjoint_sde.py: AdjointSDE.f).
- ``y0`` by backprop: within BACKPROP_Y0_ULPS. A state feeds a step three
  times (the update, f and g) and an output once; JAX's transpose adds a
  step's cotangents as (g + f) + update and then the output's, PyTorch's
  autograd engine adds them in the order they arrive (output, update, g,
  f). Every term is bitwise; only the order of the bfloat16 sums differs,
  which the solvers' code does not choose.
- ``theta``, a parameter broadcast over the batch, by either route: within
  PARAM_ULPS. Inside a vjp JAX sums a broadcast's cotangent over the batch
  in bfloat16 (the transpose of broadcast_in_dim: pairwise bfloat16 adds),
  PyTorch's autograd in float32 rounded once (sum_to_size), which is the
  more accurate; the backprop route adds the order above.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torchsde_tpu as jtsde
import torchsde_tpu_torch as ttsde
from torchsde_tpu.core import integrate as JI
from test_torch_srk_bf16 import JaxTable, TorchTable, to_jax, to_torch

B, D = 5, 3
DT = 0.05
# Output times: one interval of three steps, and two intervals of five.
TS_CASES = {"one-interval": (0.0, 0.15), "two-intervals": (0.0, 0.25, 0.5)}
# The largest differences measured over the cases below, in bfloat16 ulps
# of each gradient's largest entry (see the module's docstring for their
# causes).
BACKPROP_Y0_ULPS = 2
PARAM_ULPS = 2


def _grid(ts):
    return JI.build_interval_grid(np.asarray(ts, np.float64), DT)[0]


def _tables(grid, seed=1):
    """W, U and an antisymmetric A on ``grid``."""
    rng = np.random.default_rng(seed)
    dts = np.diff(grid)[:, None, None]
    W = rng.normal(size=(len(grid) - 1, B, D)) * np.sqrt(dts)
    U = dts * (0.5 * W + rng.normal(size=W.shape) * np.sqrt(dts / 12))
    a = rng.normal(size=W.shape + (D,)) * dts[..., None] / 3
    return W, U, a - np.swapaxes(a, -1, -2)


def _grid_query(self, grid, return_U=False, return_A=False):
    """The tables on any grid of the same steps (``sdeint`` steps
    build_step_grid, the adjoint build_interval_grid: the same times up to
    the last bits)."""
    assert len(grid) == len(self._grid)
    np.testing.assert_allclose(grid, self._grid, rtol=0, atol=1e-12)
    return (self._W, self._U if return_U else None,
            self._A if return_A else None)


def _step(self, ta, i, return_U, return_A):
    out = (self._W[i],) + ((self._U[i],) if return_U else ()) + (
        (self._A[i],) if return_A else ())
    return out[0] if len(out) == 1 else out


class JaxGridTable(JaxTable):
    """JaxTable serving the adjoint's queries too: a step (ta, tb) of the
    grid, forward-oriented (ReverseBrownian maps a reversed query onto
    one), by the index of ta (times are traced there)."""
    query_grid = _grid_query

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        i = jnp.argmin(jnp.abs(jnp.asarray(self._grid) - ta))
        return _step(self, ta, i, return_U, return_A)


class TorchGridTable(TorchTable):
    """The same for the port."""
    query_grid = _grid_query

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        i = int(np.argmin(np.abs(self._grid - float(ta))))
        return _step(self, ta, i, return_U, return_A)


def make_sde(pkg, kind, sde_type, theta):
    """A diagonal-noise SDE of parameter ``theta`` (shape (D,)): linear (f
    = -theta y, g = theta y / 2) or with sin (f = -theta y + sin(t)
    cos(y), g = 0.625 + 0.25 sin(theta y)); its constants exact in
    bfloat16."""
    lib = jnp if pkg is jtsde else torch

    class SDE(pkg.BaseSDE):
        def __init__(self):
            super().__init__(noise_type="diagonal", sde_type=sde_type)
            self.theta = theta

        def f(self, t, y):
            if kind == "linear":
                return -self.theta * y
            return -self.theta * y + lib.sin(t) * lib.cos(y)

        def g(self, t, y):
            if kind == "linear":
                return self.theta * y * 0.5
            return 0.625 + 0.25 * lib.sin(self.theta * y)

    return SDE()


# (method, sde_type, adjoint_method) of each route.
METHODS = {"euler": ("euler", "ito", None),
           "reversible_heun": ("reversible_heun", "stratonovich",
                               "adjoint_reversible_heun")}


def _grads(kind, method, adjoint, ts):
    """d sum(ys) / d(y0, theta) in both packages (the loss summed in
    float32 in each), on the same tables."""
    name, sde_type, adjoint_method = METHODS[method]
    grid = _grid(ts)
    tables = _tables(grid)
    rng = np.random.default_rng(0)
    theta0 = rng.uniform(0.5, 1.5, D)
    y0 = np.random.default_rng(2).normal(size=(B, D))
    kw = dict(method=name, dt=DT)
    if adjoint and adjoint_method:
        kw["adjoint_method"] = adjoint_method

    def jloss(y, theta):
        sde = make_sde(jtsde, kind, sde_type, theta)
        solve = jtsde.sdeint_adjoint if adjoint else jtsde.sdeint
        ys = solve(sde, y, ts, bm=JaxGridTable(*tables, grid=grid), **kw)
        return ys.astype(jnp.float32).sum()

    want = jax.grad(jloss, argnums=(0, 1))(to_jax(y0), to_jax(theta0))
    y = to_torch(y0).requires_grad_(True)
    theta = to_torch(theta0).requires_grad_(True)
    solve = ttsde.sdeint_adjoint if adjoint else ttsde.sdeint
    ys = solve(make_sde(ttsde, kind, sde_type, theta), y, ts,
               bm=TorchGridTable(*tables, grid=grid), **kw)
    ys.float().sum().backward()
    return (y.grad, theta.grad), want


def _ulps_apart(got, want):
    """The largest difference of ``got`` (bf16) from ``want`` in bfloat16
    ulps of ``want``'s largest entry."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want).astype(np.float32)
    assert tuple(got.shape) == want.shape
    got = got.float().numpy()
    scale = np.abs(want).max().astype(ml_dtypes.bfloat16)
    ulp = float(np.spacing(scale).astype(np.float32))
    return float(np.abs(got - want).max()) / ulp


CASES = [(k, m, a, t) for k in ("linear", "sin") for m in METHODS
         for a in (False, True) for t in TS_CASES]
IDS = [f"{k}-{m}-{'adjoint' if a else 'backprop'}-{t}"
       for k, m, a, t in CASES]


@pytest.mark.parametrize("kind,method,adjoint,ts", CASES, ids=IDS)
def test_bf16_gradients_match_jax(kind, method, adjoint, ts):
    """y0's and theta's gradients against the JAX package's: y0 by the
    adjoint bitwise, by backprop within BACKPROP_Y0_ULPS; theta within
    PARAM_ULPS (the causes are in the module's docstring)."""
    (gy, gtheta), (wy, wtheta) = _grads(kind, method, adjoint,
                                        TS_CASES[ts])
    assert _ulps_apart(gy, wy) <= (0 if adjoint else BACKPROP_Y0_ULPS)
    assert _ulps_apart(gtheta, wtheta) <= PARAM_ULPS


def test_adjoint_drift_vjp_in_two_passes_is_bitwise(monkeypatch):
    """The fix the adjoint's y0 needed: with the adjoint drift's vjp and
    the Itô-conversion term's summed in one autograd pass (their terms in
    another order than the JAX package's), y0's gradient by the Euler
    adjoint over three steps is no longer bitwise the JAX package's; with
    the two passes (the port's) it is."""
    from torchsde_tpu_torch.core import adjoint_sde as AS

    def one_pass_f(self, t, y_aug):
        y, adj_y, _ = y_aug
        sde = self.forward_sde
        create_graph = torch.is_grad_enabled()

        def fn(y):
            g = sde.g(-t, y)
            drift = sde.f(-t, y) - self._correction(y, g)
            return (drift,) + self._flat_vjp(
                (drift, g), y, (adj_y, self._ito_conversion_cotangent(
                    y, g, adj_y, create_graph)), create_graph)

        return AS._neg_first(AS._triple(AS.at_leaf(fn, y)))

    (gy, _), (wy, _) = _grads("linear", "euler", True,
                              TS_CASES["one-interval"])
    assert _ulps_apart(gy, wy) == 0
    monkeypatch.setattr(AS.AdjointSDE, "f", one_pass_f)
    (gy, _), (wy, _) = _grads("linear", "euler", True,
                              TS_CASES["one-interval"])
    assert _ulps_apart(gy, wy) > 0
