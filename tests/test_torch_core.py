"""The port's core (sdeint, Euler, integrate, misc) against torchsde_tpu.

Whole solves are compared through injected Brownian tables: the same
increments, made with numpy from a seed, drive both packages."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu as jtsde
import torchsde_tpu_torch as ttsde
from torchsde_tpu.brownian import base as jbase
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.utils import misc as jmisc
from torchsde_tpu_torch.core import integrate as TI
from torchsde_tpu_torch.utils import misc as tmisc

B, D, M = 5, 3, 2
TS = np.linspace(0.0, 0.5, 5)
DT = 0.05
GRID = JI.build_step_grid(TS[0], TS[-1], DT)


# --------------------------------------------------------------------------- #
#  Test problems, written once per framework                                  #
# --------------------------------------------------------------------------- #

def _problem_params():
    rng = np.random.default_rng(0)
    return dict(theta=rng.uniform(0.5, 1.5, D), G=rng.normal(size=(D, M)),
                G0=rng.normal(size=(D, M)))


class JaxSDE(jtsde.SDEIto):
    def __init__(self, noise_type, p):
        super().__init__(noise_type=noise_type)
        self.theta = jnp.asarray(p["theta"])
        self.G = jnp.asarray(p["G"])
        self.G0 = jnp.asarray(p["G0"])

    def f(self, t, y):
        return -self.theta * y + jnp.sin(t) * jnp.cos(y)

    def h(self, t, y):
        return -y

    def g(self, t, y):
        if self.noise_type == "diagonal":
            return 0.6 + 0.3 * jnp.sin(y)
        return jnp.tanh(y)[..., None] * self.G + self.G0


class TorchSDE(ttsde.SDEIto):
    def __init__(self, noise_type, p):
        super().__init__(noise_type=noise_type)
        self.theta = torch.as_tensor(p["theta"])
        self.G = torch.as_tensor(p["G"])
        self.G0 = torch.as_tensor(p["G0"])

    def f(self, t, y):
        return -self.theta * y + torch.sin(t) * torch.cos(y)

    def h(self, t, y):
        return -y

    def g(self, t, y):
        if self.noise_type == "diagonal":
            return 0.6 + 0.3 * torch.sin(y)
        return torch.tanh(y)[..., None] * self.G + self.G0


class JaxTable(jbase.BaseBrownian):
    """Serves a fixed table of increments on GRID."""

    def __init__(self, W):
        self._W = jnp.asarray(W)

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        return self._W[int(np.argmin(np.abs(GRID - float(ta))))]

    def query_grid(self, grid, return_U=False, return_A=False):
        assert np.array_equal(grid, GRID)
        return self._W, None, None

    @property
    def shape(self):
        return tuple(self._W.shape[1:])

    @property
    def dtype(self):
        return self._W.dtype

    @property
    def levy_area_approximation(self):
        return "none"


class TorchTable(ttsde.BaseBrownian):
    """Port-side table Brownian: only ``__call__``, so solves go through
    BaseBrownian's default ``query_grid``."""

    def __init__(self, grid, W):
        self._grid = np.asarray(grid, np.float64)
        self._W = torch.as_tensor(W)

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        i = int(np.argmin(np.abs(self._grid - float(ta))))
        j = int(np.argmin(np.abs(self._grid - float(tb))))
        if j != i + 1:
            raise ValueError(f"TorchTable only serves consecutive grid "
                             f"cells, got ({ta}, {tb})")
        return self._W[i]

    @property
    def shape(self):
        return tuple(self._W.shape[1:])

    @property
    def dtype(self):
        return self._W.dtype

    @property
    def levy_area_approximation(self):
        return "none"


@pytest.mark.parametrize("noise_type", ["diagonal", "general"])
@pytest.mark.parametrize("logqp", [False, True])
def test_sdeint_euler_matches_jax_f64(noise_type, logqp):
    p = _problem_params()
    rng = np.random.default_rng(1)
    y0 = rng.normal(size=(B, D))
    m = (D + int(logqp)) if noise_type == "diagonal" else M
    W = rng.normal(size=(len(GRID) - 1, B, m)) * np.sqrt(DT)
    want = jtsde.sdeint(JaxSDE(noise_type, p), jnp.asarray(y0), TS,
                        bm=JaxTable(W), method="euler", dt=DT, logqp=logqp)
    got = ttsde.sdeint(TorchSDE(noise_type, p), torch.as_tensor(y0), TS,
                       bm=TorchTable(GRID, W), method="euler", dt=DT,
                       logqp=logqp)
    want = want if logqp else (want,)
    got = got if logqp else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9)


class JaxScalarSDE(jtsde.SDEIto):
    """Coefficients of Python scalars only, so a bf16 state stays bf16."""

    def __init__(self):
        super().__init__(noise_type="diagonal")

    def f(self, t, y):
        return -0.7 * y + 0.3 * jnp.sin(t)

    def g(self, t, y):
        return 0.6 + 0.3 * jnp.sin(y)


class TorchScalarSDE(torch.nn.Module):
    noise_type, sde_type = "diagonal", "ito"

    def f(self, t, y):
        return -0.7 * y + 0.3 * torch.sin(t)

    def g(self, t, y):
        return 0.6 + 0.3 * torch.sin(y)


# ys within one float32 rounding of the states (|y| < 2); in bf16 within
# two ulps at |y| < 1 (2^-7): both packages round each bf16 operation, but
# XLA fuses some of them in float32.
NAN_CASES = {"f32": (jnp.float32, torch.float32, torch.float32, 1e-6),
             "bf16": (jnp.bfloat16, torch.bfloat16, torch.float32, 2 ** -7),
             "bf16_ts": (jnp.bfloat16, torch.bfloat16, torch.bfloat16,
                         2 ** -7)}


@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_sdeint_is_finite_at_a_rounded_last_output_time(monkeypatch, case):
    """ts = linspace(0, 0.3, 4) in float32 (bf16) ends a hair past 0.3, so
    the step grid at dt 0.1 gets a last step of 1.2e-8 (7.8e-4) whose ends
    round to one value of the state's dtype: the output there must take
    the interval before it, finite, as the JAX package's default sdeint
    does on the same draws."""
    jdtype, dtype, ts_dtype, atol = NAN_CASES[case]
    ts = torch.linspace(0.0, 0.3, 4, dtype=ts_dtype)
    ts_host = ts.double().numpy()
    grid = JI.build_step_grid(ts_host[0], ts_host[-1], 0.1)
    ends = torch.as_tensor(grid[-2:]).to(dtype)
    assert len(grid) == 5 and grid[-1] > grid[-2] and ends[0] == ends[1]
    y0 = np.random.default_rng(2).normal(size=(B, D))
    key = jax.random.PRNGKey(3)
    want = jtsde.sdeint(JaxScalarSDE(), jnp.asarray(y0, jdtype),
                        jnp.asarray(ts_host, {torch.float32: jnp.float32}
                                    .get(ts_dtype, jnp.bfloat16)),
                        method="euler", dt=0.1, key=key)
    W = JI.sample_grid_noise(key, grid, (B, D), jdtype)[0]
    monkeypatch.setattr(TI, "sample_grid_noise",
                        lambda *args, **kwargs: (
                            torch.as_tensor(np.asarray(W, np.float32))
                            .to(dtype), None, None))
    got = ttsde.sdeint(TorchScalarSDE(), torch.as_tensor(y0).to(dtype), ts,
                       method="euler", dt=0.1)
    assert got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def test_sdeint_default_noise_follows_the_generator():
    p = _problem_params()
    y0 = torch.ones((B, D), dtype=torch.float64)

    def solve(seed):
        return ttsde.sdeint(TorchSDE("diagonal", p), y0, TS, method="euler",
                            dt=DT, generator=torch.Generator().manual_seed(seed))

    a, b, c = solve(0), solve(0), solve(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert a.shape == (len(TS), B, D)


def test_sample_grid_noise_scales_the_generator_draws():
    grid = JI.build_step_grid(0.0, 1.0, 0.3)          # last step short
    W, U, A = TI.sample_grid_noise(torch.Generator().manual_seed(4), grid,
                                   (B, M), torch.float64)
    z = torch.randn((len(grid) - 1, B, M), generator=torch.Generator()
                    .manual_seed(4), dtype=torch.float64)
    dts = torch.as_tensor(np.diff(grid))
    torch.testing.assert_close(W, z * dts.sqrt()[:, None, None], rtol=0,
                               atol=0)
    assert U is None and A is None
    # The A channel draws after W's and H's normals, leaving W's unchanged.
    W2, U2, A2 = TI.sample_grid_noise(torch.Generator().manual_seed(4), grid,
                                      (B, M), torch.float64, needs_A=True)
    torch.testing.assert_close(W2, W, rtol=0, atol=0)
    assert U2 is None and A2.shape == (len(grid) - 1, B, M, M)


@pytest.mark.parametrize("t0,t1,dt", [(0.0, 1.0, 1.0 / 32), (0.0, 1.0, 0.3),
                                      (0.1, 0.7, 0.05), (0.0, 1.0, 1.0 / 128),
                                      (0.0, 1e-3, 1.0)])
def test_build_step_grid_matches_jax(t0, t1, dt):
    got = TI.build_step_grid(t0, t1, dt)
    np.testing.assert_array_equal(got, JI.build_step_grid(t0, t1, dt))
    assert got[0] == t0 and got[-1] == t1


def test_linear_interp_on_grid_matches_jax():
    rng = np.random.default_rng(2)
    grid = JI.build_step_grid(0.0, 1.0, 0.1)
    ys = rng.normal(size=(len(grid), B, D))
    out_ts = np.concatenate([[0.0, 1.0, 0.3], rng.uniform(0, 1, 7)])
    out_ts.sort()
    want = JI.linear_interp_on_grid(jnp.asarray(out_ts), jnp.asarray(grid),
                                    jnp.asarray(ys))
    got = TI.linear_interp_on_grid(torch.as_tensor(out_ts),
                                   torch.as_tensor(grid), torch.as_tensor(ys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    # exact at grid points
    np.testing.assert_array_equal(got[0].numpy(), ys[0])
    np.testing.assert_array_equal(got[-1].numpy(), ys[-1])


def test_stable_division_matches_jax():
    a = np.array([1.0, 1.0, -2.0, 3.0, 1.0, 0.5])
    b = np.array([4.0, -1e-9, 1e-9, 0.0, -2.0, 1e-7])
    want = jmisc.stable_division(jnp.asarray(a), jnp.asarray(b))
    bt = torch.as_tensor(b).requires_grad_()
    got = tmisc.stable_division(torch.as_tensor(a), bt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert got[1] == -1e7 and got[2] == -2e7 and got[3] == 3e7
    # the clamp is on a detached magnitude: no gradient through clamped b
    got.sum().backward()
    want_grad = jax.grad(lambda b_: jnp.sum(jmisc.stable_division(
        jnp.asarray(a), b_)))(jnp.asarray(b))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want_grad))
    assert bt.grad[1] == 0 and bt.grad[3] == 0


def _contract_cases():
    y0 = np.ones((B, D))
    return {
        "1d_y0": dict(y0=np.ones(D)),
        "decreasing_ts": dict(ts=TS[::-1].copy()),
        "repeated_ts": dict(ts=np.array([0.0, 0.1, 0.1])),
        "unknown_method": dict(method="bogus"),
        "unknown_noise_type": dict(noise_type="bogus"),
        "ok": dict(y0=y0),
    }


@pytest.mark.parametrize("case", sorted(_contract_cases()))
def test_contract_errors_match_jax_wording(case):
    kw = dict(y0=np.ones((B, D)), ts=TS, method="euler",
              noise_type="diagonal")
    kw.update(_contract_cases()[case])
    p = _problem_params()
    messages = []
    for pkg, sde_cls, arr in ((jtsde, JaxSDE, jnp.asarray),
                              (ttsde, TorchSDE, torch.as_tensor)):
        sde = sde_cls("diagonal", p)
        sde.noise_type = kw["noise_type"]
        extra = {} if pkg is jtsde else dict(generator=torch.Generator())
        try:
            pkg.sdeint(sde, arr(kw["y0"]), kw["ts"], method=kw["method"],
                       dt=DT, **extra)
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    if case == "ok":
        assert messages == [None, None]
    else:
        assert messages[0] is not None and messages[1] == messages[0]


@pytest.mark.parametrize("method", ["adjoint_reversible_heun"])
def test_unported_methods_are_named(method):
    """sdeint names the one method it does not run itself, in the JAX
    package's words: the adjoint's reversible pair, which only
    sdeint_adjoint runs."""
    with pytest.raises(ValueError, match="only be used as the "
                       "adjoint_method of sdeint_adjoint"):
        ttsde.sdeint(TorchSDE("diagonal", _problem_params()),
                     torch.ones((B, D)), TS, method=method, dt=DT)


def test_base_sde_trait_errors_match_jax():
    for kw in (dict(noise_type="bogus", sde_type="ito"),
               dict(noise_type="diagonal", sde_type="bogus")):
        with pytest.raises(ValueError) as jerr:
            jtsde.BaseSDE(**kw)
        with pytest.raises(ValueError) as terr:
            ttsde.BaseSDE(**kw)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("method", ["euler", "milstein", "srk"])
def test_return_stats_match_jax(method):
    """The fixed-step counters: n_steps accepted, none rejected, n_steps
    times the solver's evaluations a step."""
    p = _problem_params()
    y0 = np.ones((B, D))
    _, jstats = jtsde.sdeint(JaxSDE("diagonal", p), jnp.asarray(y0), TS,
                             method=method, dt=DT, entropy=1,
                             return_stats=True)
    ys, stats = ttsde.sdeint(TorchSDE("diagonal", p), torch.as_tensor(y0),
                             TS, method=method, dt=DT, return_stats=True,
                             generator=torch.Generator().manual_seed(1))
    assert ys.shape == (len(TS), B, D)
    assert stats == {k: (bool(v) if k == "incomplete" else int(v))
                     for k, v in jstats.items()}


def test_remat_gives_the_same_values_and_gradients():
    p = _problem_params()
    W = np.random.default_rng(3).normal(size=(len(GRID) - 1, B, D)) * 0.1
    out = []
    for remat in (False, True):
        sde = TorchSDE("diagonal", p)
        sde.theta = sde.theta.clone().requires_grad_()
        ys = ttsde.sdeint(sde, torch.ones((B, D), dtype=torch.float64), TS,
                          bm=TorchTable(GRID, W), method="milstein", dt=DT,
                          remat=remat)
        out.append((ys.detach(), torch.autograd.grad(ys.sum(), sde.theta)))
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-12, atol=0)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(key=3), TypeError, "generator="),
    (dict(entropy=3), TypeError, "generator="),
    (dict(adaptive=True, rtol=1e-2), None, None),
    (dict(adaptive=True, atol=1e-2), None, None),
    (dict(adaptive=True, dt_min=4e-2), None, None),
    (dict(adaptive=True, max_steps=4), None, None),
    (dict(noise_precompute=False), None, None),
])
def test_jax_keywords_are_not_dropped(monkeypatch, kwargs, error, match):
    """``key`` and ``entropy`` raise; every other keyword of the JAX
    package takes effect as there: the solve with it is the JAX package's
    with it (on one ``BrownianInterval``; ``noise_precompute=False`` on the
    default noise keyed as JAX's, whose precomputed stream is another), and
    differs from the solve without it. ``max_steps`` binds a differentiated
    solve: NaN where it did not reach."""
    p = _problem_params()
    y0 = np.full((B, D), 0.5)
    if error is not None:
        with pytest.raises(error, match=match):
            ttsde.sdeint(TorchSDE("diagonal", p), torch.as_tensor(y0), TS,
                         method="euler", dt=DT, **kwargs)
        return
    jbm = jtsde.BrownianInterval(0.0, 0.5, (B, D), dtype=jnp.float64,
                                 entropy=3, levels=12)
    tbm = ttsde.BrownianInterval(0.0, 0.5, (B, D), dtype=torch.float64,
                                 entropy=3, levels=12, device="cpu")
    base = dict(method="milstein", dt=DT)
    if "adaptive" in kwargs:
        base.update({k: v for k, v in dict(rtol=1e-3, atol=1e-3,
                                           dt_min=1e-3).items()
                     if k not in kwargs})
        jkw, tkw = dict(bm=jbm), dict(bm=tbm)
    else:
        key = np.asarray(jax.random.PRNGKey(8))
        monkeypatch.setattr(TI, "draw_key", lambda generator, device:
                            torch.as_tensor(key.astype(np.int64)))
        jkw = dict(key=jax.random.PRNGKey(8))
        tkw = dict(generator=torch.Generator().manual_seed(8))
    if "max_steps" in kwargs:
        want = jax.vjp(lambda y: jtsde.sdeint(
            JaxSDE("diagonal", p), y, TS, **jkw, **base, **kwargs),
            jnp.asarray(y0))[0]
    else:
        want = jtsde.sdeint(JaxSDE("diagonal", p), jnp.asarray(y0), TS,
                            **jkw, **base, **kwargs)
    got = ttsde.sdeint(TorchSDE("diagonal", p),
                       torch.tensor(y0, requires_grad=True), TS, **tkw,
                       **base, **kwargs).detach()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    without = ttsde.sdeint(TorchSDE("diagonal", p), torch.as_tensor(y0), TS,
                           **tkw, **base, **{k: v for k, v in kwargs.items()
                                             if k == "adaptive"})
    assert not torch.equal(got, without)


@pytest.mark.parametrize("value", [None, True])
def test_noise_precompute_that_the_port_does_is_accepted(value):
    """The port precomputes the noise: ``noise_precompute`` None or True
    asks for just that, and changes nothing, without a warning."""
    sde = TorchSDE("diagonal", _problem_params())
    y0 = torch.ones((B, D), dtype=torch.float64)
    a = ttsde.sdeint(sde, y0, TS, method="euler", dt=DT,
                     generator=torch.Generator().manual_seed(2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = ttsde.sdeint(sde, y0, TS, method="euler", dt=DT,
                         noise_precompute=value,
                         generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)


def test_unroll_is_accepted_and_changes_nothing():
    sde = TorchSDE("diagonal", _problem_params())
    y0 = torch.ones((B, D), dtype=torch.float64)
    a = ttsde.sdeint(sde, y0, TS, method="euler", dt=DT,
                     generator=torch.Generator().manual_seed(2))
    b = ttsde.sdeint(sde, y0, TS, method="euler", dt=DT, unroll=4,
                     generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)


def test_names_renames_the_drift():
    p = _problem_params()
    y0 = torch.ones((B, D), dtype=torch.float64)
    W = np.random.default_rng(3).normal(size=(len(GRID) - 1, B, D)) * 0.1
    bm = TorchTable(GRID, W)
    with_h = ttsde.sdeint(TorchSDE("diagonal", p), y0, TS, bm=bm,
                          method="euler", dt=DT, names={"drift": "h"})

    class PriorOnly(TorchSDE):
        def f(self, t, y):
            return -y

    direct = ttsde.sdeint(PriorOnly("diagonal", p), y0, TS, bm=bm,
                          method="euler", dt=DT)
    torch.testing.assert_close(with_h, direct, rtol=0, atol=0)
