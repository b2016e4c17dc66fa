"""Traced ``ts`` in the port's ``sdeint`` and ``sdeint_adjoint`` against
torchsde_tpu's, in float64.

A traced ``ts`` is a tensor that requires grad (or any tensor while a CUDA
graph is being captured, which only the card can show; ``chip_smoke.py``
group ``traced_ts`` captures one). It solves the whole step grid of an
explicit ``BrownianInterval``'s ``[t0, t1]`` and interpolates onto ``ts``
on the device; the JAX package's counterpart is ``ts`` traced under
``jax.jit``. Each package gets its own ``BrownianInterval`` of the same
entropy, bitwise in keys and bits and within about 3e-12 relative in
normals. The cases, from ``tests/test_sdeint.py::test_traced_ts_fixed_step``
and ``tests/test_adjoint.py::test_traced_ts_adjoint``:

* values against the port's concrete path where the grids coincide, at
  1e-12 (the JAX package's tolerance there), and against the JAX package's
  traced solve at 1e-9 of scale;
* the NaN poison of schedules that leave the grid, in values and
  gradients;
* the refusals, in the JAX package's words;
* gradients to ``ts`` and to the parameters against ``jax.jit(jax.grad(...,
  argnums=(0, 1)))`` at 1e-9 of scale, for Euler and midpoint, with
  precomputed and in-loop noise, on both entry points;
* ``ts.grad`` after ``.backward()`` (which stayed None before the traced
  branch existed), and a ``ts`` that needs no gradient keeping the concrete
  path bitwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import problems
import torchsde_tpu as jtsde
import torchsde_tpu_torch as ttsde
from port_bridge import jax_named_arrays
from test_torch_adjoint import ProblemPort
from torchsde_tpu_torch.core import integrate as TI
from torchsde_tpu_torch.core.sdeint import is_traced

VAL_TOL = 1e-12   # traced against concrete, one package, one interval
TOL = 1e-9        # against the JAX package, of each gradient's scale

# tests/test_sdeint.py::test_traced_ts_fixed_step's problem.
B1, D1, DT1 = 4, 2, 0.05
SCHEDULES = {
    "linspace": np.linspace(0.0, 1.0, 5),
    "off_grid": np.array([0.0, 0.123, 0.5, 0.77, 1.0]),
    "ends_early": np.array([0.0, 0.25, 0.5, 0.6, 0.7]),
}


def _ex():
    jp = problems.ExDiagonal(d=D1, sde_type="ito")
    return jp, ProblemPort(jp)


def _bm1(lib):
    if lib == "jax":
        return jtsde.BrownianInterval(0.0, 1.0, (B1, D1), dtype=jnp.float64,
                                      entropy=8, levels=16)
    return ttsde.BrownianInterval(0.0, 1.0, (B1, D1), dtype=torch.float64,
                                  entropy=8, levels=16, device="cpu")


def _y01():
    return np.full((B1, D1), 0.1)


def _traced(ts):
    return torch.tensor(np.asarray(ts, np.float64), requires_grad=True)


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("entry", ["sdeint", "sdeint_adjoint"])
def test_traced_values_match_concrete_and_jax(name, entry):
    ts = SCHEDULES[name]
    _, sde = _ex()
    bm = _bm1("torch")
    solve = getattr(ttsde, entry)
    y0 = torch.as_tensor(_y01())
    with torch.no_grad():
        got = solve(sde, y0, _traced(ts), bm=bm, method="euler", dt=DT1)
        want = ttsde.sdeint(sde, y0, list(ts), bm=bm, method="euler", dt=DT1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=VAL_TOL,
                               atol=VAL_TOL)
    _close(got.numpy(), _jax_traced_solve(entry)(jnp.asarray(ts)), TOL)


@functools.lru_cache(maxsize=None)
def _jax_traced_solve(entry):
    """The JAX package's solve with ``ts`` traced under ``jax.jit``: one
    compilation serves every schedule of the same length."""
    jp, _ = _ex()
    jbm = _bm1("jax")
    return jax.jit(lambda t: getattr(jtsde, entry)(
        jp, jnp.asarray(_y01()), t, bm=jbm, method="euler", dt=DT1))


@pytest.mark.parametrize("entry", ["sdeint", "sdeint_adjoint"])
def test_traced_poison_values_and_gradients(entry):
    """A schedule starting after the grid's anchor or ending past its last
    point is NaN, values and gradients, as the JAX package's."""
    _, sde = _ex()
    bm = _bm1("torch")
    solve = getattr(ttsde, entry)
    y0 = torch.as_tensor(_y01())
    with torch.no_grad():
        shifted = solve(sde, y0, _traced([0.5, 0.75, 1.0, 1.1, 1.2]), bm=bm,
                        method="euler", dt=DT1)
        overrun = solve(sde, y0, _traced([0.0, 0.25, 0.5, 1.0, 1.2]), bm=bm,
                        method="euler", dt=DT1)
    assert bool(torch.isnan(shifted).all()) and bool(torch.isnan(
        overrun).all())
    y0 = y0.clone().requires_grad_(True)
    ts = _traced([0.0, 0.5, 1.2])
    solve(sde, y0, ts, bm=bm, method="euler", dt=DT1).sum().backward()
    assert bool(torch.isnan(y0.grad).all())
    assert bool(torch.isnan(ts.grad).all())
    assert all(bool(torch.isnan(p.grad).all()) for p in sde.parameters())


def test_traced_refusals():
    """The JAX package's refusals of a traced ``ts``, in its words."""
    _, sde = _ex()
    bm = _bm1("torch")
    y0 = torch.as_tensor(_y01())
    ts = _traced(SCHEDULES["linspace"])
    with pytest.raises(ValueError, match="[Tt]raced.*fixed-step"):
        ttsde.sdeint(sde, y0, ts, bm=bm, dt=DT1, method="euler",
                     adaptive=True)
    with pytest.raises(ValueError, match="[Tt]raced.*explicit `bm`"):
        ttsde.sdeint(sde, y0, ts, dt=DT1, method="euler")
    with pytest.raises(ValueError, match="[Tt]raced.*explicit `bm`"):
        ttsde.sdeint_adjoint(sde, y0, ts, dt=DT1, method="euler")
    with pytest.raises(ValueError, match="one-dimensional"):
        ttsde.sdeint(sde, y0, ts[:, None], bm=bm, dt=DT1, method="euler")
    table = ttsde.PrecomputedBrownian(0.0, 1.0, (B1, D1), 64,
                                      dtype=torch.float64, entropy=8,
                                      device="cpu")
    with pytest.raises(ValueError, match="`t0`/`t1`"):
        ttsde.sdeint(sde, y0, ts, bm=table, dt=DT1, method="euler")

    strat = ProblemPort(problems.NeuralDiagonal(d=D1,
                                                sde_type="stratonovich"))
    for kw in (dict(adaptive=True), dict(adjoint_adaptive=True)):
        with pytest.raises(ValueError, match="[Tt]raced.*fixed-step adjoint"):
            ttsde.sdeint_adjoint(strat, y0, ts, bm=bm, dt=DT1,
                                 method="midpoint", **kw)
    with pytest.raises(ValueError, match="reversible_heun"):
        ttsde.sdeint_adjoint(strat, y0, ts, bm=bm, dt=DT1,
                             method="reversible_heun")


def test_concrete_tensor_ts_keeps_the_host_path(monkeypatch):
    """A tensor ``ts`` that needs no gradient (and is not captured) is read
    on the host as before: bitwise the list's result, and the traced
    solve is never reached."""
    _, sde = _ex()
    bm = _bm1("torch")
    y0 = torch.as_tensor(_y01())
    ts = SCHEDULES["off_grid"]
    want = ttsde.sdeint(sde, y0, list(ts), bm=bm, method="euler", dt=DT1)

    def refuse(*args, **kwargs):
        raise AssertionError("traced path taken")

    monkeypatch.setattr(TI, "integrate_traced", refuse)
    for concrete in (torch.as_tensor(ts), np.asarray(ts)):
        got = ttsde.sdeint(sde, y0, concrete, bm=bm, method="euler", dt=DT1)
        assert torch.equal(got, want)
    assert not is_traced(list(ts)) and not is_traced(np.asarray(ts))
    assert not is_traced(torch.as_tensor(ts))
    assert is_traced(_traced(ts))


@pytest.mark.parametrize("t0,t1,dt", [(0.0, 1.0, 0.05), (0.0, 1.0, 1e-3),
                                      (-1.0, -0.05, 1e-2), (0.3, 2.0, 0.07),
                                      (0.0, 0.4, 0.025)])
def test_device_step_grid_is_the_host_grid(t0, t1, dt):
    """The traced branch's grid, made by tensor arithmetic on the device,
    is bitwise ``build_step_grid``'s."""
    got = TI.device_step_grid(t0, t1, dt, "cpu")
    want = TI.build_step_grid(t0, t1, dt)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
#  tests/test_adjoint.py::test_traced_ts_adjoint                              #
# --------------------------------------------------------------------------- #

b, d = 8, 3
DT = 0.025


def _neural(sde_type):
    jp = problems.NeuralDiagonal(d=d, sde_type=sde_type)
    return jp, ProblemPort(jp)


def _bms(lib):
    if lib == "jax":
        return jtsde.BrownianInterval(0.0, 0.4, (b, d), dtype=jnp.float64,
                                      entropy=3, levels=10)
    return ttsde.BrownianInterval(0.0, 0.4, (b, d), dtype=torch.float64,
                                  entropy=3, levels=10, device="cpu")


def _y0():
    return np.full((b, d), 0.1)


def _loss(ys):
    return (ys[-1] ** 2).sum() + ys[1].sum()


def _param_grads(sde, loss):
    params = [p for _, p in sde.named_parameters()]
    grads = torch.autograd.grad(loss, params)
    return {n: g.numpy() for (n, _), g in zip(sde.named_parameters(), grads)}


def test_traced_adjoint_matches_concrete_adjoint():
    """On a schedule on the grid the traced adjoint's parameter gradients
    are the concrete adjoint's; off it its values are ``sdeint``'s (the
    same grid, interval and steps)."""
    _, sde = _neural("stratonovich")
    bm = _bms("torch")
    y0 = torch.as_tensor(_y0())
    aligned = [0.0, 0.2, 0.4]
    got = _param_grads(sde, _loss(ttsde.sdeint_adjoint(
        sde, y0, _traced(aligned), bm=bm, method="midpoint", dt=DT)))
    want = _param_grads(sde, _loss(ttsde.sdeint_adjoint(
        sde, y0, aligned, bm=bm, method="midpoint", dt=DT)))
    for name, w in want.items():
        _close(got[name], w, TOL)
    off = [0.0, 0.137, 0.4]
    with torch.no_grad():
        vals = ttsde.sdeint_adjoint(sde, y0, _traced(off), bm=bm,
                                    method="midpoint", dt=DT)
        ref = ttsde.sdeint(sde, y0, off, bm=bm, method="midpoint", dt=DT)
    np.testing.assert_allclose(vals.numpy(), ref.numpy(), rtol=VAL_TOL,
                               atol=VAL_TOL)


METHODS = {"euler": "ito", "midpoint": "stratonovich"}
TS_OFF = np.array([0.0, 0.137, 0.29, 0.4])


@functools.lru_cache(maxsize=None)
def _jax_ts_grads(entry, method, noise_precompute):
    jp, _ = _neural(METHODS[method])
    bm = _bms("jax")

    def loss(ts_, sde_):
        ys = getattr(jtsde, entry)(sde_, jnp.asarray(_y0()), ts_, bm=bm,
                                   method=method, dt=DT,
                                   noise_precompute=noise_precompute)
        return jnp.sum(ys[-1] ** 2) + jnp.sum(ys[1])

    g_ts, g_sde = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(TS_OFF), jp)
    return np.asarray(g_ts), jax_named_arrays(g_sde)


@pytest.mark.parametrize("noise_precompute", [True, False],
                         ids=["precomputed", "in_loop"])
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("entry", ["sdeint", "sdeint_adjoint"])
def test_ts_and_param_gradients_match_jax(entry, method, noise_precompute):
    _, sde = _neural(METHODS[method])
    ts = _traced(TS_OFF)
    ys = getattr(ttsde, entry)(sde, torch.as_tensor(_y0()), ts,
                               bm=_bms("torch"), method=method, dt=DT,
                               noise_precompute=noise_precompute)
    loss = _loss(ys)
    names = [n for n, _ in sde.named_parameters()]
    grads = torch.autograd.grad(loss, [ts] + list(sde.parameters()))
    want_ts, want = _jax_ts_grads(entry, method, noise_precompute)
    assert float(np.max(np.abs(want_ts))) > 0
    _close(grads[0].numpy(), want_ts, TOL)
    assert set(names) == set(want)
    for name, g in zip(names, grads[1:]):
        _close(g.numpy(), want[name], TOL)


@pytest.mark.parametrize("entry", ["sdeint", "sdeint_adjoint"])
def test_ts_grad_is_filled_by_backward(entry):
    """``.backward()`` fills ``ts.grad`` with the JAX package's gradient
    (before the traced branch the port read ``ts`` to the host and left
    its gradient None)."""
    _, sde = _neural("ito")
    ts = _traced(TS_OFF)
    _loss(getattr(ttsde, entry)(sde, torch.as_tensor(_y0()), ts,
                                bm=_bms("torch"), method="euler",
                                dt=DT)).backward()
    assert ts.grad is not None
    _close(ts.grad.numpy(), _jax_ts_grads(entry, "euler", True)[0], TOL)
