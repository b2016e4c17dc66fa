"""The port's fixed-step solvers against torchsde_tpu's, in float64.

Every method ported with this module (midpoint, Heun, Euler-Heun,
Milstein in both calculi with and without ``grad_free``, log-ODE midpoint)
is held to the JAX package at 1e-9 on the same noise, both through
injected tables made with numpy and through a ``BrownianInterval`` of the
same entropy; then its strong order on a problem of ``diagnostics/problems.py``,
the A channel of the default noise, the default Stratonovich method, the
method table and the Brownian contract checks."""

import math
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torchsde_tpu as jtsde
import torchsde_tpu_torch as ttsde
from torchsde_tpu.brownian import base as jbase
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.core import solvers as JS
from torchsde_tpu.core.base_sde import ForwardSDE as JForwardSDE
from torchsde_tpu_torch.core import integrate as TI
from torchsde_tpu_torch.core import solvers as TS
from torchsde_tpu_torch.core.base_sde import ForwardSDE as TForwardSDE
from torchsde_tpu_torch.diagnostics import problems as port_problems
from torchsde_tpu_torch.ops import prng
from torchsde_tpu_torch.utils import misc

B, D, M = 5, 3, 2
TS_OUT = np.linspace(0.0, 0.5, 5)
DT = 0.05
GRID = JI.build_step_grid(TS_OUT[0], TS_OUT[-1], DT)
TOL = 1e-9

# (method, sde_type, noise types, options)
CASES = [
    ("midpoint", "stratonovich", ("diagonal", "general", "scalar", "additive"),
     None),
    ("heun", "stratonovich", ("diagonal", "general", "scalar"), None),
    ("euler_heun", "stratonovich", ("diagonal", "general", "additive"), None),
    ("milstein", "ito", ("diagonal", "scalar", "additive"), None),
    ("milstein", "ito", ("diagonal", "scalar"), {"grad_free": True}),
    ("milstein", "stratonovich", ("diagonal", "scalar", "additive"), None),
    ("milstein", "stratonovich", ("diagonal", "scalar"), {"grad_free": True}),
    ("log_ode", "stratonovich", ("general", "diagonal", "scalar"), None),
]
FLAT_CASES = [(m, st, n, o) for m, st, ns, o in CASES for n in ns]
IDS = [f"{m}-{st}-{n}{'-gf' if o else ''}" for m, st, n, o in FLAT_CASES]


def _params():
    rng = np.random.default_rng(0)
    return dict(theta=rng.uniform(0.5, 1.5, D), G=rng.normal(size=(D, M)),
                G0=rng.normal(size=(D, M)))


def _m(noise):
    return {"general": M, "additive": M, "scalar": 1}.get(noise, D)


def make_sde(pkg, sde_type, noise, p=None):
    """One test SDE, written once for both packages: ``pkg`` is jtsde or
    ttsde. Its parameters are tensors (``theta`` a leaf requiring grad on
    the port, for the backprop test)."""
    p = _params() if p is None else p
    lib = jnp if pkg is jtsde else torch
    conv = jnp.asarray if pkg is jtsde else torch.as_tensor

    class SDE(pkg.BaseSDE):
        def __init__(self):
            super().__init__(noise_type=noise, sde_type=sde_type)
            self.theta = conv(p["theta"])
            self.G = conv(p["G"])
            self.G0 = conv(p["G0"])

        def f(self, t, y):
            return -self.theta * y + lib.sin(t) * lib.cos(y)

        def g(self, t, y):
            if noise == "diagonal":
                return 0.6 + 0.3 * lib.sin(self.theta * y)
            if noise == "scalar":
                return (0.6 + 0.3 * lib.sin(self.theta * y))[..., None]
            if noise == "additive":
                return self.G0 * (1.0 + 0.0 * y[..., None]) * lib.cos(t)
            return lib.tanh(self.theta * y)[..., None] * self.G + self.G0

    return SDE()


class JaxTable(jbase.BaseBrownian):
    """Serves fixed (W, A) tables on GRID to the JAX package."""

    def __init__(self, W, A=None):
        self._W = jnp.asarray(W)
        self._A = None if A is None else jnp.asarray(A)

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        raise NotImplementedError

    def query_grid(self, grid, return_U=False, return_A=False):
        assert np.array_equal(grid, GRID)
        return self._W, None, self._A if return_A else None

    shape = property(lambda self: tuple(self._W.shape[1:]))
    dtype = property(lambda self: self._W.dtype)
    levy_area_approximation = property(
        lambda self: "none" if self._A is None else "foster")


class TorchTable(ttsde.BaseBrownian):
    """The same tables for the port."""

    def __init__(self, W, A=None):
        self._W = torch.as_tensor(W)
        self._A = None if A is None else torch.as_tensor(A)

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        raise NotImplementedError

    def query_grid(self, grid, return_U=False, return_A=False):
        assert np.array_equal(grid, GRID)
        return self._W, None, self._A if return_A else None

    shape = property(lambda self: tuple(self._W.shape[1:]))
    dtype = property(lambda self: self._W.dtype)
    levy_area_approximation = property(
        lambda self: "none" if self._A is None else "foster")


def _tables(noise, method, seed=1):
    rng = np.random.default_rng(seed)
    n, m = len(GRID) - 1, _m(noise)
    W = rng.normal(size=(n, B, m)) * np.sqrt(DT)
    A = None
    if method == "log_ode":
        a = rng.normal(size=(n, B, m, m)) * DT / 3
        A = a - np.swapaxes(a, -1, -2)
    return W, A


def _close(got, want, tol=TOL):
    assert tuple(got.shape) == np.shape(want)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("method,sde_type,noise,options", FLAT_CASES, ids=IDS)
def test_solver_matches_jax_on_injected_noise(method, sde_type, noise,
                                              options):
    y0 = np.random.default_rng(2).normal(size=(B, D))
    W, A = _tables(noise, method)
    want = jtsde.sdeint(make_sde(jtsde, sde_type, noise), jnp.asarray(y0),
                        TS_OUT, bm=JaxTable(W, A), method=method, dt=DT,
                        options=options)
    got = ttsde.sdeint(make_sde(ttsde, sde_type, noise), torch.as_tensor(y0),
                       TS_OUT, bm=TorchTable(W, A), method=method, dt=DT,
                       options=options)
    _close(got, want)


@pytest.mark.parametrize("method,sde_type,noise,options", FLAT_CASES, ids=IDS)
def test_solver_matches_jax_on_a_brownian_interval(method, sde_type, noise,
                                                   options):
    y0 = np.random.default_rng(3).normal(size=(B, D))
    levy = "foster" if method == "log_ode" else "none"
    kw = dict(t0=0.0, t1=0.5, size=(B, _m(noise)), entropy=31, levels=16,
              levy_area_approximation=levy)
    want = jtsde.sdeint(make_sde(jtsde, sde_type, noise), jnp.asarray(y0),
                        TS_OUT, method=method, dt=DT, options=options,
                        bm=jtsde.BrownianInterval(dtype=jnp.float64, **kw))
    got = ttsde.sdeint(make_sde(ttsde, sde_type, noise), torch.as_tensor(y0),
                       TS_OUT, method=method, dt=DT, options=options,
                       bm=ttsde.BrownianInterval(dtype=torch.float64,
                                                 device="cpu", **kw))
    _close(got, want)


@pytest.mark.parametrize("method,sde_type,noise", [
    ("milstein", "ito", "diagonal"), ("milstein", "stratonovich", "scalar"),
    ("midpoint", "stratonovich", "general"),
    ("log_ode", "stratonovich", "general")])
def test_backprop_through_solve_matches_jax_grad(method, sde_type, noise):
    """The gradient of sum(ys) in theta through the whole solve, Milstein's
    and log-ODE's derivative terms differentiated too."""
    p = _params()
    y0 = np.random.default_rng(4).normal(size=(B, D))
    W, A = _tables(noise, method, seed=5)

    def jax_loss(theta):
        sde = make_sde(jtsde, sde_type, noise, p)
        sde.theta = theta
        return jnp.sum(jtsde.sdeint(sde, jnp.asarray(y0), TS_OUT,
                                    bm=JaxTable(W, A), method=method, dt=DT))

    want = jax.grad(jax_loss)(jnp.asarray(p["theta"]))
    sde = make_sde(ttsde, sde_type, noise, p)
    sde.theta = sde.theta.clone().requires_grad_()
    ttsde.sdeint(sde, torch.as_tensor(y0), TS_OUT, bm=TorchTable(W, A),
                 method=method, dt=DT).sum().backward()
    _close(sde.theta.grad, want)


def test_no_grad_solve_keeps_no_graph():
    sde = make_sde(ttsde, "ito", "diagonal")
    W, _ = _tables("diagonal", "milstein")
    with torch.no_grad():
        ys = ttsde.sdeint(sde, torch.ones((B, D), dtype=torch.float64),
                          TS_OUT, bm=TorchTable(W), method="milstein", dt=DT)
    assert not ys.requires_grad


def test_stratonovich_default_method_is_midpoint():
    y0 = torch.as_tensor(np.random.default_rng(6).normal(size=(B, D)))
    kw = dict(t0=0.0, t1=0.5, size=(B, D), entropy=8, levels=16,
              dtype=torch.float64, device="cpu")
    sde = make_sde(ttsde, "stratonovich", "diagonal")
    default = ttsde.sdeint(sde, y0, TS_OUT, bm=ttsde.BrownianInterval(**kw),
                           dt=DT)
    midpoint = ttsde.sdeint(sde, y0, TS_OUT, method="midpoint", dt=DT,
                            bm=ttsde.BrownianInterval(**kw))
    assert torch.equal(default, midpoint)
    # and on the default noise source
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    assert torch.equal(ttsde.sdeint(sde, y0, TS_OUT, dt=DT, generator=gen()),
                       ttsde.sdeint(sde, y0, TS_OUT, dt=DT, generator=gen(),
                                    method="midpoint"))


def test_select_matches_jax_for_every_method():
    """Every method selects the JAX package's class, the adjoint's
    placeholder too, which raises the JAX package's message when built
    outside sdeint_adjoint."""
    for method in ttsde.METHODS:
        for sde_type in ("ito", "stratonovich"):
            assert TS.select(method, sde_type).__name__ == \
                JS.select(method, sde_type).__name__
    sde = make_sde(ttsde, "stratonovich", "diagonal")
    with pytest.raises(ValueError) as terr:
        TS.select("adjoint_reversible_heun", "stratonovich")(sde=sde)
    with pytest.raises(ValueError) as jerr:
        JS.select("adjoint_reversible_heun", "stratonovich")(
            sde=make_sde(jtsde, "stratonovich", "diagonal"))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="does not match"):
        TS.select("bogus", "ito")


# Each step as the plain tensor expression the solvers computed before
# they took tuple states (``utils.misc.tree_lc``); a tensor state must still
# give these bits.
def _plain_step(method, sde, t0, t1, y0, extra0, I_k):
    dt = t1 - t0
    if method == "euler":
        f, g_prod = sde.f_and_g_prod(t0, y0, I_k)
        return y0 + dt * f + g_prod
    if method == "midpoint":
        f, g_prod = sde.f_and_g_prod(t0, y0, I_k)
        half_dt = 0.5 * dt
        y_prime = y0 + half_dt * f + 0.5 * g_prod
        f_prime, g_prod_prime = sde.f_and_g_prod(t0 + half_dt, y_prime, I_k)
        return y0 + dt * f_prime + g_prod_prime
    if method == "heun":
        f, g_prod = sde.f_and_g_prod(t0, y0, I_k)
        f_prime, g_prod_prime = sde.f_and_g_prod(t1, y0 + dt * f + g_prod,
                                                 I_k)
        return (y0 + (0.5 * dt) * f + (0.5 * dt) * f_prime + 0.5 * g_prod
                + 0.5 * g_prod_prime)
    if method == "euler_heun":
        f, g_prod = sde.f_and_g_prod(t0, y0, I_k)
        g_prod_prime = sde.g_prod(t1, y0 + g_prod, I_k)
        return y0 + dt * f + 0.5 * g_prod + 0.5 * g_prod_prime
    if method == "milstein":
        v = I_k ** 2 - dt if sde.sde_type == "ito" else I_k ** 2
        f = sde.f(t0, y0)
        g_prod, gdg_prod = sde.g_prod_and_gdg_prod(t0, y0, I_k, 0.5 * v)
        return y0 + dt * f + g_prod + gdg_prod
    f0, g0, z0 = extra0
    z1 = 2.0 * y0 - z0 + dt * f0 + sde.prod(g0, I_k)
    f1, g1 = sde.f_and_g(t1, z1)
    return (y0 + 0.5 * dt * f0 + 0.5 * dt * f1
            + sde.prod(g0 + g1, 0.5 * I_k))


STEP_CASES = [
    ("euler", "ito", "diagonal"), ("euler", "ito", "general"),
    ("midpoint", "stratonovich", "general"), ("heun", "stratonovich",
                                              "diagonal"),
    ("euler_heun", "stratonovich", "additive"),
    ("milstein", "ito", "diagonal"), ("milstein", "stratonovich", "scalar"),
    ("milstein", "ito", "additive"),
    ("reversible_heun", "stratonovich", "general")]


@pytest.mark.parametrize("method,sde_type,noise", STEP_CASES)
def test_tensor_state_steps_are_bitwise_the_plain_expressions(method,
                                                              sde_type,
                                                              noise):
    sde = TForwardSDE(make_sde(ttsde, sde_type, noise))
    rng = np.random.default_rng(6)
    y0 = torch.as_tensor(rng.normal(size=(B, D)))
    I_k = torch.as_tensor(rng.normal(size=(B, _m(noise))) * 0.2)
    t0 = torch.tensor(0.1, dtype=torch.float64)
    t1 = torch.tensor(0.15, dtype=torch.float64)
    solver = TS.select(method, sde_type)(sde=sde)
    extra0 = solver.init_extra_solver_state(t0, y0)
    got, _ = solver.step(t0, t1, y0, extra0, (I_k, None, None))
    assert torch.equal(got, _plain_step(method, sde, t0, t1, y0, extra0,
                                        I_k))


class _OpCount(TorchDispatchMode):
    """Counts the aten operations run under it: one each, as each is one
    kernel launch on the card."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("method,sde_type,noise", STEP_CASES)
def test_tensor_state_steps_run_the_plain_expressions_ops(method, sde_type,
                                                          noise):
    """A tensor state's step runs the operations of the plain expression,
    each as many times (the arguments of ``tree_lc`` are formed first, so
    the order may differ): ``tree_lc`` adds no launch (``-1.0`` is a
    subtraction)."""
    sde = TForwardSDE(make_sde(ttsde, sde_type, noise))
    rng = np.random.default_rng(6)
    y0 = torch.as_tensor(rng.normal(size=(B, D)))
    I_k = torch.as_tensor(rng.normal(size=(B, _m(noise))) * 0.2)
    t0 = torch.tensor(0.1, dtype=torch.float64)
    t1 = torch.tensor(0.15, dtype=torch.float64)
    solver = TS.select(method, sde_type)(sde=sde)
    extra0 = solver.init_extra_solver_state(t0, y0)
    with _OpCount() as got:
        solver.step(t0, t1, y0, extra0, (I_k, None, None))
    with _OpCount() as want:
        _plain_step(method, sde, t0, t1, y0, extra0, I_k)
    assert Counter(got.ops) == Counter(want.ops)


@pytest.mark.parametrize("method", sorted(ttsde.METHODS))
def test_method_noise_needs_match_jax(method):
    assert TS.method_noise_needs(method) == JS.method_noise_needs(method)


@pytest.mark.parametrize("method,sde_type,noise,options", FLAT_CASES
                         + [("euler", "ito", "diagonal", None),
                            ("srk", "ito", "diagonal", None),
                            ("srk", "ito", "additive", None),
                            ("reversible_heun", "stratonovich", "general",
                             None)])
def test_nfe_per_step_and_orders_match_jax(method, sde_type, noise, options):
    def build(pkg, S, forward):
        sde = forward(make_sde(pkg, sde_type, noise))
        return S.select(method, sde_type)(sde=sde, options=options)

    got = build(ttsde, TS, TForwardSDE)
    want = build(jtsde, JS, JForwardSDE)
    assert got.nfe_per_step == want.nfe_per_step
    assert (got.strong_order, got.weak_order) == (want.strong_order,
                                                 want.weak_order)


# --------------------------------------------------------------------------- #
#  The A channel of the default noise                                         #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("levy", ["davie", "foster"])
@pytest.mark.parametrize("rng_impl", ["generator", "philox"])
def test_sample_grid_noise_A_channel(levy, rng_impl):
    """A is H (x) W - W (x) H plus antisymmetrised normals scaled by
    Davie's or Foster's law, its normals the third draw (after W's and
    H's) of the generator, or the Philox stream of seed + 2."""
    grid = JI.build_step_grid(0.0, 1.0, 0.3)
    n, size = len(grid) - 1, (B, M)
    W, U, A = TI.sample_grid_noise(torch.Generator().manual_seed(4), grid,
                                   size, torch.float64, needs_A=True,
                                   rng_impl=rng_impl,
                                   levy_area_approximation=levy)
    assert U is None and A.shape == (n, B, M, M)
    gen = torch.Generator().manual_seed(4)
    if rng_impl == "philox":
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                             dtype=torch.int32)
        zw, zh, za = (prng.philox_normal(seed + k, s, torch.float64)
                      for k, s in ((0, (n, *size)), (1, (n, *size)),
                                   (2, (n, *size, M))))
    else:
        zw, zh, za = (torch.randn(s, generator=gen, dtype=torch.float64)
                      for s in ((n, *size), (n, *size), (n, *size, M)))
    dts = torch.as_tensor(np.diff(grid)).reshape(n, 1, 1)
    Wr = zw * dts.sqrt()
    H = zh * (dts / 12).sqrt()
    noise = za - za.transpose(-1, -2)
    Ar = H[..., :, None] * Wr[..., None, :] - Wr[..., :, None] * H[..., None, :]
    if levy == "foster":
        th = (0.1 * dts)[..., None]
        std = (th * (th + (H * H)[..., :, None] + (H * H)[..., None, :])).sqrt()
    else:
        std = (dts * dts / 12).sqrt()[..., None]
    torch.testing.assert_close(W, Wr, rtol=0, atol=0)
    torch.testing.assert_close(A, Ar + std * noise, rtol=1e-15, atol=1e-15)
    torch.testing.assert_close(A, -A.transpose(-1, -2), rtol=0, atol=1e-15)


def test_log_ode_runs_on_the_default_noise():
    sde = make_sde(ttsde, "stratonovich", "general")
    y0 = torch.ones((B, D), dtype=torch.float64)

    def solve(seed):
        return ttsde.sdeint(sde, y0, TS_OUT, method="log_ode", dt=DT,
                            generator=torch.Generator().manual_seed(seed))

    a, b, c = solve(0), solve(0), solve(1)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert not torch.equal(a, c)


# --------------------------------------------------------------------------- #
#  The Brownian contract                                                      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("size", [(B,), (B, M, 1), (B + 1, D), (B, D + 1)])
def test_wrong_bm_shape_raises_with_jax_wording(size):
    y0 = np.ones((B, D))
    messages = []
    for pkg, arr, kw in ((jtsde, jnp.asarray, dict(dtype=jnp.float64)),
                         (ttsde, torch.as_tensor, dict(dtype=torch.float64,
                                                       device="cpu"))):
        bm = pkg.BrownianInterval(0.0, 0.5, size, entropy=1, levels=8, **kw)
        with pytest.raises(ValueError) as err:
            pkg.sdeint(make_sde(pkg, "stratonovich", "diagonal"), arr(y0),
                       TS_OUT, bm=bm, method="midpoint", dt=DT)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_wrong_bm_dtype_raises():
    bm = ttsde.BrownianInterval(0.0, 0.5, (B, D), dtype=torch.float32,
                                entropy=1, levels=8, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        ttsde.sdeint(make_sde(ttsde, "stratonovich", "diagonal"),
                     torch.ones((B, D), dtype=torch.float64), TS_OUT, bm=bm,
                     method="midpoint", dt=DT)


class _NamedDevice(ttsde.BaseBrownian):
    """A user's Brownian object that reports its device by name."""

    def __init__(self, bm, device):
        self.bm, self.device = bm, device

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        return self.bm(ta, tb, return_U=return_U, return_A=return_A)

    dtype = property(lambda self: self.bm.dtype)
    shape = property(lambda self: self.bm.shape)
    levy_area_approximation = property(
        lambda self: self.bm.levy_area_approximation)


@pytest.mark.parametrize("name", ["cpu", "cpu:0", torch.device("cpu")],
                         ids=str)
def test_bm_device_by_any_name_of_y0s(name):
    """A bm that names y0's device without (or with) its index solves, bitwise
    the interval it wraps."""
    bm = ttsde.BrownianInterval(0.0, 0.5, (B, D), dtype=torch.float64,
                                entropy=1, levels=8, device="cpu")
    sde = make_sde(ttsde, "stratonovich", "diagonal")
    y0 = torch.ones((B, D), dtype=torch.float64)
    want = ttsde.sdeint(sde, y0, TS_OUT, bm=bm, method="midpoint", dt=DT)
    got = ttsde.sdeint(sde, y0, TS_OUT, bm=_NamedDevice(bm, name),
                       method="midpoint", dt=DT)
    assert torch.equal(got, want)


@pytest.mark.parametrize("a,b,same", [
    ("cuda", "cuda:0", True), ("cuda:0", "cuda", True),
    ("cuda", "cuda:1", False), ("cpu", "cpu:0", True),
    ("cpu", "cuda", False), ("cuda:1", "cuda:1", True)])
def test_same_device_fills_in_the_current_index(a, b, same, monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert misc.same_device(a, b) is same
    assert misc.same_device(torch.device(a), b) is same


def test_bm_on_another_device_raises():
    bm = ttsde.BrownianInterval(0.0, 0.5, (B, D), dtype=torch.float64,
                                entropy=1, levels=8, device="cpu")
    with pytest.raises(ValueError, match="`bm` is on cuda"):
        ttsde.sdeint(make_sde(ttsde, "stratonovich", "diagonal"),
                     torch.ones((B, D), dtype=torch.float64), TS_OUT,
                     bm=_NamedDevice(bm, "cuda"), method="midpoint", dt=DT)


def test_solver_rejects_a_bm_without_levy_area():
    bm = ttsde.BrownianInterval(0.0, 0.5, (B, M), dtype=torch.float64,
                                entropy=1, levels=8, device="cpu")
    with pytest.raises(ValueError, match="levy_area_approximation"):
        ttsde.sdeint(make_sde(ttsde, "stratonovich", "general"),
                     torch.ones((B, D), dtype=torch.float64), TS_OUT, bm=bm,
                     method="log_ode", dt=DT)


# --------------------------------------------------------------------------- #
#  Strong order (a small, fast case of tests/test_strong_order.py)            #
# --------------------------------------------------------------------------- #

ORDER_BATCH = 512
ORDER_DTS = tuple(2.0 ** -i for i in range(1, 6))
ORDER_T1 = 2.0


def _slope(dts, errs):
    x = np.log(dts) - np.log(dts).mean()
    y = 0.5 * np.log(errs)
    return float((x * (y - y.mean())).sum() / (x * x).sum())


@pytest.mark.parametrize("method,options,problem", [
    ("midpoint", None, "scalar"), ("heun", None, "scalar"),
    ("euler_heun", None, "scalar"), ("milstein", None, "scalar"),
    ("log_ode", None, "scalar"), ("milstein", None, "diagonal"),
    ("milstein", {"grad_free": True}, "diagonal")])
def test_strong_order(method, options, problem):
    """The slope of 0.5 log(MSE) against log(dt) over dt = 2^-1..2^-5 on the
    exact solution of the problem (diagnostics/problems.py, whose parameters
    are the JAX problem's), one PrecomputedBrownian path (foster)
    shared by every dt, as diagnostics/harness.inspect_orders does. Each
    method is of strong order 1 on these problems."""
    if problem == "scalar":
        sde = port_problems.ExScalar(
            d=D, sde_type="stratonovich" if method != "milstein" else "ito",
            device="cpu")
        m = 1
    else:
        sde = port_problems.ExDiagonal(d=D, sde_type="ito", device="cpu")
        m = D
    y0 = torch.full((ORDER_BATCH, D), 0.1, dtype=torch.float64)
    bm = ttsde.PrecomputedBrownian(0.0, ORDER_T1, (ORDER_BATCH, m), n=1024,
                                   dtype=torch.float64, entropy=7,
                                   levy_area_approximation="foster",
                                   device="cpu")
    W = bm(0.0, ORDER_T1)
    if problem == "scalar":
        true = torch.atan(sde.p * W + torch.tan(y0))
    else:
        true = y0 * torch.exp((sde.mu - 0.5 * sde.sigma ** 2) * ORDER_T1
                              + sde.sigma * W)
    errs = []
    with torch.no_grad():
        for dt in ORDER_DTS:
            y = ttsde.sdeint(sde, y0, [0.0, ORDER_T1], bm=bm, method=method,
                             dt=dt, options=options)[-1]
            errs.append(float(((y - true) ** 2).sum(1).mean()))
    assert 0.8 <= _slope(ORDER_DTS, errs) <= 1.5, errs
