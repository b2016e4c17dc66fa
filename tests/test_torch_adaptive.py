"""The port's adaptive stepping against torchsde_tpu's, in float64.

Both packages get a ``BrownianInterval`` of the same entropy and depth,
bitwise in keys and branch bits and within about 3e-12 relative in
normals, and the same problem with the same parameters; an adaptive solve
couples every row through its RMS error, so each case runs the whole
batch on both sides. The cases:

* the PI controller and the error norm against the JAX package's
  ``_update_step_size`` and ``_compute_error`` (``tests/test_adaptive.py``'s
  cases), in float64 and float32;
* ``sdeint(adaptive=True)`` by srk, milstein, euler and midpoint: ``ys``
  within 1e-9 of scale and ``n_accepted``, ``n_rejected`` and ``nfe``
  equal (one float32 case within 1e-5);
* the gradients of backprop through ``sdeint(adaptive=True)``, of
  ``sdeint_adjoint(adaptive=True)`` and of ``sdeint_adjoint(
  adjoint_adaptive=True)`` against ``jax.grad`` at 1e-9 of scale, and the
  double backward through ``adjoint_adaptive``;
* the budget: a differentiated solve stops at ``max_steps`` iterations
  with NaN where it did not reach (as the JAX package's bounded scan), an
  undifferentiated one runs to the end, a double backward out of budget
  gives NaN gradients; ``T == 1``;
* the default noise: ``adaptive_default_levels``, its interval's depth and
  Levy area, its key drawn from the generator (the JAX package's default
  interval of ``entropy=s`` when the key is ``PRNGKey(s)``'s);
* the warnings and refusals of the JAX package."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import problems
import torchsde_tpu as jtsde
import torchsde_tpu_torch as ttsde
from port_bridge import jax_named_arrays
from test_adaptive import _DiagSDE
from test_torch_adjoint import ProblemPort
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.core import sdeint as JS
from torchsde_tpu_torch.core import integrate as TI
from torchsde_tpu_torch.core import sdeint as TS

B, D = 8, 3
TOL = 1e-9


class DiagPort(ttsde.BaseSDE):
    """``test_adaptive._DiagSDE`` in the port: f = a sin(y), g = b cos(y)."""

    def __init__(self, dtype=torch.float64):
        super().__init__(noise_type="diagonal", sde_type="ito")
        self.a = nn.Parameter(torch.tensor([0.3, -0.2], dtype=dtype))
        self.b = nn.Parameter(torch.tensor([0.1, 0.2], dtype=dtype))

    def f(self, t, y):
        return self.a * torch.sin(y)

    def g(self, t, y):
        return self.b * torch.cos(y)


def _bms(t1, size, levy="none", levels=12, entropy=5, dtype="float64"):
    return (jtsde.BrownianInterval(0.0, t1, size, dtype=getattr(jnp, dtype),
                                   entropy=entropy, levels=levels,
                                   levy_area_approximation=levy),
            ttsde.BrownianInterval(0.0, t1, size,
                                   dtype=getattr(torch, dtype),
                                   entropy=entropy, levels=levels,
                                   levy_area_approximation=levy,
                                   device="cpu"))


def _close(got, want, rel=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = 1.0 + float(np.nanmax(np.abs(want)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _stats(stats):
    return {k: (bool(v) if k == "incomplete" else int(v))
            for k, v in stats.items()}


# --------------------------------------------------------------------------- #
#  The controller                                                             #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("error,prev_h,prev_ratio,valid", [
    (0.5, 0.1, 1.0, False),     # accept, no previous ratio
    (0.9, 0.1, 1.8, True),      # accept clamped at facmin 1
    (2.0, 0.1, 1.8, True),      # reject, prev ratio kept
    (1e6, 0.1, 1.0, False),     # reject clamped at facmin 0.2
    (1e-7, 0.1, 1.0, False),    # accept clamped at facmax 1.4
    (0.3, 0.02, 0.7, True),     # accept, PI term
])
def test_update_step_size_matches_jax(dtype, error, prev_h, prev_ratio,
                                      valid):
    c = getattr(np, dtype)
    h, r, v = JI._update_step_size(jnp.asarray(error, dtype),
                                   jnp.asarray(prev_h, dtype),
                                   jnp.asarray(prev_ratio, dtype),
                                   jnp.asarray(valid))
    th, tr, tv = TI._update_step_size(c(error), c(prev_h), c(prev_ratio),
                                      valid)
    assert type(th) is c and type(tr) is c
    assert th == np.asarray(h) and tr == np.asarray(r) and tv == bool(v)


@pytest.mark.parametrize("a,b,rtol,atol", [
    ([[3.0, -1.0]], [[1.0, 1.0]], 0.1, 0.01),
    ([[0.5, 2.0], [1.0, -3.0]], [[0.4, 2.5], [1.5, -3.0]], 1e-3, 1e-4),
    ([[float("nan")]], [[1.0]], 0.1, 0.01),
    ([[1.0]], [[1.0]], 0.1, 0.01),           # floored at eps
])
def test_compute_error_matches_jax(a, b, rtol, atol):
    want = float(JI._compute_error(jnp.asarray(a), jnp.asarray(b), rtol,
                                   atol))
    got = TI._compute_error(torch.tensor(a, dtype=torch.float64),
                            torch.tensor(b, dtype=torch.float64), rtol, atol)
    assert abs(float(got) - want) <= 1e-15 * want


def test_compute_error_over_a_tuple_state():
    """The adjoint's augmented state: one RMS over every tensor."""
    rng = np.random.default_rng(0)
    parts = [rng.normal(size=s) for s in ((4, 2), (4, 2), (2,), (3, 2))]
    other = [p + 1e-3 * rng.normal(size=p.shape) for p in parts]
    want = float(JI._compute_error(
        (jnp.asarray(parts[0]), jnp.asarray(parts[1]),
         tuple(jnp.asarray(p) for p in parts[2:])),
        (jnp.asarray(other[0]), jnp.asarray(other[1]),
         tuple(jnp.asarray(p) for p in other[2:])), 1e-3, 1e-4))
    t = [torch.as_tensor(p) for p in parts]
    o = [torch.as_tensor(p) for p in other]
    got = TI._compute_error((t[0], t[1], tuple(t[2:])),
                            (o[0], o[1], tuple(o[2:])), 1e-3, 1e-4)
    assert abs(float(got) - want) <= 1e-14 * want


# --------------------------------------------------------------------------- #
#  Values and stats                                                           #
# --------------------------------------------------------------------------- #

ADAPTIVE_CASES = [("srk", "ito", "space-time"), ("milstein", "ito", "none"),
                  ("euler", "ito", "none"),
                  ("midpoint", "stratonovich", "none")]


@pytest.mark.parametrize("method,sde_type,levy", ADAPTIVE_CASES)
def test_adaptive_matches_jax(method, sde_type, levy):
    jp = problems.ExDiagonal(d=D, sde_type=sde_type)
    ts = [0.0, 0.15, 0.3, 0.5]
    jbm, tbm = _bms(0.5, (B, D), levy)
    y0 = np.full((B, D), 0.1)
    kw = dict(method=method, dt=0.05, adaptive=True, rtol=1e-3, atol=1e-4,
              return_stats=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # adaptive Euler, diagonal noise
        jys, jstats = jtsde.sdeint(jp, jnp.asarray(y0), ts, bm=jbm, **kw)
        with torch.no_grad():
            ys, stats = ttsde.sdeint(ProblemPort(jp), torch.as_tensor(y0), ts,
                                     bm=tbm, **kw)
    assert stats == _stats(jstats)
    assert stats["n_rejected"] + stats["n_accepted"] > len(ts)
    _close(ys, jys)


def test_adaptive_float32_matches_jax():
    """float32: the controller runs in float32 on both sides (the step
    times, and so the noise, are float32 arithmetic), ys within 1e-5."""
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                problems.ExDiagonal(d=D, sde_type="ito"))
    ts = [0.0, 0.25, 0.5]
    jbm, tbm = _bms(0.5, (B, D), "space-time", dtype="float32")
    port = ProblemPort(jp)
    y0 = np.full((B, D), 0.1, np.float32)
    kw = dict(method="srk", dt=0.05, adaptive=True, rtol=1e-3, atol=1e-4,
              return_stats=True)
    kw.update(dt_min=1e-3)
    jys, jstats = jtsde.sdeint(jp, jnp.asarray(y0), ts, bm=jbm, **kw)
    with torch.no_grad():
        ys, stats = ttsde.sdeint(port, torch.as_tensor(y0), ts, bm=tbm, **kw)
    assert ys.dtype == torch.float32
    assert stats == _stats(jstats)
    _close(ys, np.asarray(jys), rel=1e-5)


# --------------------------------------------------------------------------- #
#  Gradients                                                                  #
# --------------------------------------------------------------------------- #

GRAD_TS = [0.0, 0.2, 0.4]


def _grad_problem():
    jbm, tbm = _bms(0.4, (4, 2), levels=10)
    return jnp.full((4, 2), 1.0), jbm, tbm


def _jax_grads(solve, **kw):
    y0, jbm, _ = _grad_problem()

    def loss(s, y):
        ys = solve(s, y, GRAD_TS, bm=jbm, method="milstein", **kw)
        return jnp.sum(ys[-1] ** 2) + jnp.sum(ys[1])

    g_sde, g_y0 = jax.grad(loss, argnums=(0, 1))(_DiagSDE(), y0)
    return {"y0": np.asarray(g_y0), **jax_named_arrays(g_sde)}


def _port_grads(solve, **kw):
    _, _, tbm = _grad_problem()
    sde = DiagPort()
    y0 = torch.ones((4, 2), dtype=torch.float64, requires_grad=True)
    ys = solve(sde, y0, GRAD_TS, bm=tbm, method="milstein", **kw)
    loss = (ys[-1] ** 2).sum() + ys[1].sum()
    g = torch.autograd.grad(loss, (y0, sde.a, sde.b))
    return dict(zip(("y0", "a", "b"), (x.numpy() for x in g)))


@pytest.mark.parametrize("entry,kw", [
    ("sdeint", dict(dt=0.05, adaptive=True, rtol=1e-4, atol=1e-5,
                    max_steps=256)),
    ("sdeint_adjoint", dict(dt=0.05, adaptive=True, rtol=1e-4, atol=1e-5)),
    ("sdeint_adjoint", dict(dt=0.05, adjoint_adaptive=True,
                            adjoint_rtol=1e-4, adjoint_atol=1e-5)),
    ("sdeint_adjoint", dict(dt=0.05, adaptive=True, adjoint_adaptive=True,
                            rtol=1e-4, atol=1e-5, adjoint_rtol=1e-4,
                            adjoint_atol=1e-5)),
], ids=["backprop", "adjoint-adaptive-forward", "adjoint-adaptive-backward",
        "adjoint-both"])
def test_adaptive_gradients_match_jax(entry, kw):
    want = _jax_grads(getattr(jtsde, entry), **kw)
    got = _port_grads(getattr(ttsde, entry), **kw)
    assert set(got) == set(want)
    for name, w in want.items():
        scale = float(np.max(np.abs(w)))
        assert scale > 0, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=TOL * scale,
                                   err_msg=name)


def test_adjoint_adaptive_double_backward_matches_jax():
    """Grad of grad through the merged adaptive backward, bounded by
    ``adjoint_max_steps`` as in the JAX package. The first derivative
    under ``create_graph`` is the JAX package's at 1e-9. The second is
    held within 5e-2 of scale, as the JAX package holds its own against
    backprop (``tests/test_adaptive.py:test_adjoint_adaptive_gradgrad``):
    JAX differentiates the forward of its custom vjp by backprop through
    the discrete solve where the port differentiates it by the adjoint
    again, on the fixed-step backward too (1.2e-2 apart here at dt 0.1)."""
    _, jbm, tbm = _grad_problem()
    kw = dict(method="milstein", dt=0.1, adjoint_adaptive=True,
              adjoint_rtol=1e-3, adjoint_atol=1e-4, adjoint_max_steps=256)
    y0 = jnp.ones((4, 2))

    def loss(a):
        s = _DiagSDE()
        s.a = a
        ys = jtsde.sdeint_adjoint(s, y0, GRAD_TS, bm=jbm, **kw)
        return jnp.mean(ys ** 2)

    a0 = _DiagSDE().a
    want_g = np.asarray(jax.grad(loss)(a0))
    want = np.asarray(jax.grad(lambda a: jnp.sum(jax.grad(loss)(a) ** 2))(a0))
    sde = DiagPort()
    ys = ttsde.sdeint_adjoint(sde, torch.ones((4, 2), dtype=torch.float64),
                              GRAD_TS, bm=tbm, **kw)
    g, = torch.autograd.grad((ys ** 2).mean(), sde.a, create_graph=True)
    gg, = torch.autograd.grad((g ** 2).sum(), sde.a)
    np.testing.assert_allclose(g.detach().numpy(), want_g, rtol=0,
                               atol=TOL * float(np.max(np.abs(want_g))))
    scale = float(np.max(np.abs(want)))
    assert scale > 0 and torch.isfinite(gg).all()
    np.testing.assert_allclose(gg.numpy(), want, rtol=0, atol=5e-2 * scale)


# --------------------------------------------------------------------------- #
#  Budget, T == 1                                                             #
# --------------------------------------------------------------------------- #

def test_exhausted_budget_is_nan_as_in_jax():
    """Differentiated, the loop stops after ``max_steps`` iterations (emits
    included): the outputs it did not reach are NaN, as the JAX package's
    bounded scan leaves them (a loss over them is NaN, never a silent
    value), and ``incomplete`` is True; the reached outputs and their
    gradient are JAX's. Without autograd the budget is not applied."""
    y0, jbm, tbm = _grad_problem()
    kw = dict(method="milstein", dt=0.01, adaptive=True, rtol=1e-4,
              atol=1e-5, max_steps=10)
    jys, vjp = jax.vjp(lambda s: jtsde.sdeint(s, y0, GRAD_TS, bm=jbm, **kw),
                       _DiagSDE())
    want = np.asarray(vjp(jnp.ones_like(jys))[0].a)
    sde = DiagPort()
    y0 = torch.ones((4, 2), dtype=torch.float64)
    ys, stats = ttsde.sdeint(sde, y0, GRAD_TS, bm=tbm, return_stats=True,
                             **kw)
    emits = int(torch.isfinite(ys[1:]).all(dim=(1, 2)).sum())
    assert stats["incomplete"] and emits == 1
    assert stats["n_accepted"] + stats["n_rejected"] + emits == 10
    assert torch.isnan(ys[2]).all() and torch.isfinite(ys[:2]).all()
    _close(ys.detach(), jys)
    g, = torch.autograd.grad(ys, sde.a, torch.ones_like(ys))
    np.testing.assert_allclose(g.numpy(), want, rtol=0,
                               atol=TOL * float(np.max(np.abs(want))))
    with torch.no_grad():
        ys, stats = ttsde.sdeint(sde, y0, GRAD_TS, bm=tbm, return_stats=True,
                                 **kw)
    assert not stats["incomplete"] and torch.isfinite(ys).all()
    assert stats["n_accepted"] + stats["n_rejected"] + 2 > 10


def test_budget_binds_wherever_autograd_records():
    """The budget binds for a tensor the SDE computes upstream too, held
    where the adjoint could not swap it (a tuple), and not under
    ``torch.no_grad``."""
    _, _, tbm = _grad_problem()
    sde = DiagPort()
    scale = torch.ones(2, dtype=torch.float64, requires_grad=True)
    sde.held = (scale * 2.0,)
    sde.f = lambda t, y: sde.a * sde.held[0] * torch.sin(y)
    kw = dict(method="milstein", dt=0.01, adaptive=True, rtol=1e-4,
              atol=1e-5, max_steps=10, return_stats=True)
    with torch.no_grad():
        sde.a.requires_grad_(False)
        sde.b.requires_grad_(False)
    y0 = torch.ones((4, 2), dtype=torch.float64)
    _, stats = ttsde.sdeint(sde, y0, GRAD_TS, bm=tbm, **kw)
    assert stats["incomplete"]
    with torch.no_grad():
        _, stats = ttsde.sdeint(sde, y0, GRAD_TS, bm=tbm, **kw)
    assert not stats["incomplete"]


def test_double_backward_out_of_budget_is_nan():
    """Under ``create_graph`` the merged adaptive backward stops after
    ``adjoint_max_steps`` iterations and multiplies ``adj_y`` and every
    parameter's gradient by NaN: the gradients, still functions of the
    parameters, are NaN, never a silent zero. Without ``create_graph``
    there is no budget."""
    _, _, tbm = _grad_problem()
    kw = dict(method="milstein", dt=0.02, adjoint_adaptive=True,
              adjoint_rtol=1e-3, adjoint_atol=1e-4, adjoint_max_steps=4)
    sde = DiagPort()
    y0 = torch.ones((4, 2), dtype=torch.float64, requires_grad=True)
    ys = ttsde.sdeint_adjoint(sde, y0, GRAD_TS, bm=tbm, **kw)
    g = torch.autograd.grad(ys.sum(), (y0, sde.a, sde.b), create_graph=True)
    assert all(torch.isnan(x).all() and x.requires_grad for x in g)
    ys = ttsde.sdeint_adjoint(sde, y0, GRAD_TS, bm=tbm, **kw)
    g = torch.autograd.grad(ys.sum(), (y0, sde.a, sde.b))
    assert all(torch.isfinite(x).all() for x in g)


def test_adjoint_adaptive_single_output_time():
    _, _, tbm = _grad_problem()
    y0 = torch.ones((4, 2), dtype=torch.float64, requires_grad=True)
    sde = DiagPort()
    ys = ttsde.sdeint_adjoint(sde, y0, [0.0], bm=tbm, method="milstein",
                              dt=0.02, adjoint_adaptive=True)
    g_y0, g_a = torch.autograd.grad(ys[0].sum(), (y0, sde.a),
                                    allow_unused=True)
    assert torch.equal(g_y0, torch.ones_like(y0))
    assert g_a is None or not g_a.any()


# --------------------------------------------------------------------------- #
#  The default noise of an adaptive solve                                     #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("t1,dt_min", [(2.0, 1e-5), (1.0, 1e-3),
                                       (10.0, 1e-7), (1.0, 1e-30),
                                       (0.0, 1e-5)])
def test_adaptive_default_levels_match_jax(t1, dt_min):
    assert (TS.adaptive_default_levels(0.0, t1, dt_min)
            == JS.adaptive_default_levels(0.0, t1, dt_min))


@pytest.mark.parametrize("method,levy", [("milstein", "none"),
                                         ("srk", "space-time")])
def test_adaptive_default_noise(method, levy):
    """Adaptive: a BrownianInterval on y0's device at the depth dt_min
    gives (20 at the reference defaults), with the method's Levy area;
    fixed-step: the default source."""
    sde = DiagPort()
    y0 = torch.ones((4, 2), dtype=torch.float64)
    ts = np.linspace(0.0, 2.0, 4)
    bm = TS.check_contract(sde, y0, ts, None, method, None, None, False,
                           torch.Generator().manual_seed(0), adaptive=True,
                           dt_min=1e-5)[3]
    assert isinstance(bm, ttsde.BrownianInterval)
    assert bm.levels == 20 and bm.levy_area_approximation == levy
    assert bm.device == torch.device("cpu") and bm.dtype == torch.float64
    bm = TS.check_contract(sde, y0, ts, None, method, None, None, False)[3]
    assert isinstance(bm, TI.DefaultNoise)


def test_adaptive_default_noise_is_keyed_from_the_generator(monkeypatch):
    """Two solves on one seed agree bitwise, another seed differs; with
    the key drawn as JAX's PRNGKey(11) the solve is the JAX package's on
    its default interval of entropy 11."""
    sde, jsde = DiagPort(), _DiagSDE()
    y0 = np.full((4, 2), 1.0)
    ts = [0.0, 0.25, 0.5]
    kw = dict(method="milstein", dt=0.05, adaptive=True, rtol=1e-4,
              atol=1e-5)

    def run(seed):
        with torch.no_grad():
            return ttsde.sdeint(sde, torch.as_tensor(y0), ts,
                                generator=torch.Generator().manual_seed(seed),
                                **kw)

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    want = jtsde.sdeint(jsde, jnp.asarray(y0), ts, entropy=11, **kw)
    key = np.asarray(jax.random.PRNGKey(11))
    monkeypatch.setattr(TI, "draw_key",
                        lambda generator, device: torch.as_tensor(
                            key.astype(np.int64), device=device))
    _close(run(1), want)


# --------------------------------------------------------------------------- #
#  Warnings and refusals                                                      #
# --------------------------------------------------------------------------- #

def test_warn_if_coarser_than_dt_min_as_jax():
    jbm, tbm = _bms(1.0, (4, 2), levels=4)
    with pytest.warns(UserWarning) as want:
        JS.warn_if_coarser_than_dt_min(jbm, 1e-3)
    with pytest.warns(UserWarning) as got:
        TS.warn_if_coarser_than_dt_min(tbm, 1e-3)
    assert str(got[0].message) == str(want[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TS.warn_if_coarser_than_dt_min(tbm, 0.1)
    with pytest.warns(UserWarning, match="dyadic leaf"):
        with torch.no_grad():
            ttsde.sdeint(DiagPort(), torch.ones((4, 2), dtype=torch.float64),
                         [0.0, 1.0], bm=tbm, method="milstein", dt=0.5,
                         adaptive=True, rtol=1e-2, atol=1e-2, dt_min=1e-3)


def test_adaptive_euler_warns_and_reversible_heun_refuses():
    jp = problems.ExDiagonal(d=D, sde_type="ito")
    _, tbm = _bms(0.5, (B, D))
    y0 = torch.full((B, D), 0.1, dtype=torch.float64)
    with pytest.warns(UserWarning, match="Euler--Maruyama"):
        with torch.no_grad():
            ttsde.sdeint(ProblemPort(jp), y0, [0.0, 0.1], bm=tbm,
                         method="euler", dt=0.05, adaptive=True, rtol=1e-2,
                         atol=1e-2)
    strat = ProblemPort(problems.ExDiagonal(d=D, sde_type="stratonovich"))
    with pytest.raises(ValueError, match="reversible_heun"):
        ttsde.sdeint_adjoint(strat, y0, [0.0, 0.1], bm=tbm,
                             method="reversible_heun", dt=0.05,
                             adaptive=True)
