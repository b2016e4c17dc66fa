"""The port's fixed-step ``sdeint_adjoint`` against torchsde_tpu's, in
float64.

The SDEs are the JAX package's ``tests/problems.py`` problems, carried
across with their parameters (``port_problem``); each package gets its own
``BrownianInterval(entropy=3, levels=10)``, bitwise in keys and bits and
within about 3e-12 relative in normals. The cases:

* against JAX: the port's gradients of ``y0`` and of every parameter
  against ``jax.grad`` of the JAX package's ``sdeint_adjoint``, for every
  case of ``tests/test_adjoint.py:test_against_sdeint``, the four
  reversible-Heun problems and ``logqp``, at 1e-9 of each gradient's
  scale;
* against backprop through the port's ``sdeint`` at the JAX package's
  tolerances (the reversible pair at 1e-9), and double backward at 1e-2;
* the default noise replayed: two runs bitwise, the reversible pair
  against backprop on one generator seed, the caller's generator left as
  the forward left it, under both ``rng_impl``s;
* the adjoint parameters: a buffer and a plain tensor attribute get their
  gradient, an explicit ``adjoint_params`` that is not collected raises;
* the keywords that are not ported raise."""

import functools

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
from torchsde_tpu_torch.core import integrate as TI
from torchsde_tpu_torch.core.base_sde import collect_adjoint_params

b, d, m = 8, 3, 2
TS = [0.0, 0.2, 0.4]
DT = 0.025
TOL = 1e-9


# --------------------------------------------------------------------------- #
#  problems.py in the port                                                    #
# --------------------------------------------------------------------------- #

def _param(a):
    return nn.Parameter(torch.as_tensor(np.array(a)))


class MLPPort(nn.Module):
    def __init__(self, jmlp):
        super().__init__()
        for name in ("w1", "b1", "w2", "b2"):
            setattr(self, name, _param(getattr(jmlp, name)))
        self.final_sigmoid = jmlp.final_sigmoid

    def forward(self, x):
        h = torch.nn.functional.softplus(x @ self.w1 + self.b1)
        out = h @ self.w2 + self.b2
        return torch.sigmoid(out) if self.final_sigmoid else out


def _t_cat(t, y):
    return torch.cat([torch.as_tensor(t, dtype=y.dtype).expand(y.shape[0], 1),
                      y], dim=1)


class ProblemPort(ttsde.BaseSDE):
    """A problem of ``tests/problems.py`` with the JAX problem's
    parameters as ``nn.Parameter``s of the same names."""

    def __init__(self, jp):
        super().__init__(noise_type=jp.noise_type, sde_type=jp.sde_type)
        self.kind = type(jp).__name__
        for name, value in vars(jp).items():
            if name in ("f_net", "g_net"):
                setattr(self, name, MLPPort(value))
            elif hasattr(value, "shape") and name not in ("noise_type",
                                                          "sde_type"):
                setattr(self, name, _param(value))
            elif name in ("d", "m"):
                setattr(self, name, value)

    def f(self, t, y):
        k, ito = self.kind, self.sde_type == "ito"
        if k == "ExDiagonal":
            return (self.mu * y if ito
                    else self.mu * y - 0.5 * self.sigma ** 2 * y)
        if k == "ExScalar":
            return (-self.p ** 2 * torch.sin(y) * torch.cos(y) ** 3 if ito
                    else torch.zeros_like(y))
        if k == "ExAdditive":
            return self.b / torch.sqrt(1.0 + t) - y / (2.0 + 2.0 * t)
        return self.f_net(_t_cat(t, y))

    def g(self, t, y):
        k = self.kind
        if k == "ExDiagonal":
            return self.sigma * y
        if k == "ExScalar":
            return (self.p * torch.cos(y) ** 2)[..., None]
        if k == "ExAdditive":
            fill = self.a * self.b / torch.sqrt(1.0 + t)
            return fill[None, :, None].expand(y.shape[0], fill.shape[0],
                                              self.m)
        if k == "NeuralDiagonal":
            return 0.1 * self.g_net(_t_cat(t, y))
        if k == "NeuralScalar":
            return 0.1 * self.g_net(_t_cat(t, y))[..., None]
        if k == "NeuralAdditive":
            t_in = torch.as_tensor(t, dtype=y.dtype).expand(y.shape[0], 1)
            return self.g_net(t_in).reshape(y.shape[0], self.d, self.m)
        return 0.1 * self.g_net(_t_cat(t, y)).reshape(y.shape[0], self.d,
                                                      self.m)

    def h(self, t, y):
        return torch.zeros_like(y)


def jax_problem(name, sde_type):
    kwargs = {"d": d}
    if name in ("ExAdditive", "NeuralGeneral", "NeuralAdditive"):
        kwargs["m"] = m
    return getattr(problems, name)(sde_type=sde_type, **kwargs)


def _noise(noise_type, logqp=False):
    return {"diagonal": d + (1 if logqp else 0), "scalar": 1}.get(noise_type,
                                                                  m)


def _bms(noise_type, logqp=False):
    size = (b, _noise(noise_type, logqp))
    return (jtsde.BrownianInterval(0.0, 0.4, size, dtype=jnp.float64,
                                   entropy=3, levels=10),
            ttsde.BrownianInterval(0.0, 0.4, size, dtype=torch.float64,
                                   entropy=3, levels=10, device="cpu"))


def _y0_np():
    return np.full((b, d), 0.1)


def _loss(ys):
    return (ys[-1] ** 2).sum() + ys[1].sum()


def _port_grads(sde, bm, solve, method, adjoint_method=None, **kw):
    y0 = torch.tensor(_y0_np(), requires_grad=True)
    if solve is ttsde.sdeint_adjoint:
        kw["adjoint_method"] = adjoint_method
    ys = solve(sde, y0, TS, bm=bm, method=method, dt=DT, **kw)
    loss = _loss(ys)
    names = [n for n, _ in sde.named_parameters()]
    grads = torch.autograd.grad(loss, [y0] + [p for _, p in
                                              sde.named_parameters()])
    return dict(zip(["y0"] + names, (g.detach().numpy() for g in grads)))


@functools.lru_cache(maxsize=None)
def _jax_grads(name, sde_type, method, adjoint_method, extra=()):
    sde = jax_problem(name, sde_type)
    bm, _ = _bms(sde.noise_type)

    def loss(sde_, y0_):
        ys = jtsde.sdeint_adjoint(sde_, y0_, TS, bm=bm, method=method, dt=DT,
                                  adjoint_method=adjoint_method, **dict(extra))
        return jnp.sum(ys[-1] ** 2) + jnp.sum(ys[1])

    g_sde, g_y0 = jax.grad(loss, argnums=(0, 1))(sde, jnp.asarray(_y0_np()))
    return {"y0": np.asarray(g_y0), **jax_named_arrays(g_sde)}


def _assert_grads_close(got, want, rel):
    """Each gradient within ``rel`` of its own largest entry."""
    assert set(got) == set(want)
    for name, w in want.items():
        scale = float(np.max(np.abs(w)))
        assert scale > 0, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=rel * scale,
                                   err_msg=name)


def _max_rel_err(got, want):
    """The JAX package's measure: the largest difference over the largest
    gradient entry."""
    scale = max(float(np.max(np.abs(w))) for w in want.values())
    return max(float(np.max(np.abs(got[k] - want[k]))) for k in want) / scale


# --------------------------------------------------------------------------- #
#  Against the JAX package, and against backprop                              #
# --------------------------------------------------------------------------- #

def _sde_type(method):
    return ("stratonovich" if method in ("midpoint", "heun", "euler_heun",
                                         "reversible_heun") else "ito")


# tests/test_adjoint.py:test_against_sdeint's cases, then its reversible
# problems: (problem, method, adjoint_method, tolerance against backprop).
CASES = [
    ("ExDiagonal", "milstein", "milstein", 2e-2),
    ("ExDiagonal", "euler", None, 5e-2),
    ("ExScalar", "euler", None, 1e-1),
    ("ExAdditive", "euler", None, 5e-2),
    ("NeuralGeneral", "euler", None, 5e-2),
    ("NeuralDiagonal", "midpoint", None, 1e-3),
    ("NeuralScalar", "midpoint", None, 1e-3),
    ("NeuralAdditive", "heun", None, 1e-3),
] + [(name, "reversible_heun", None, TOL)
     for name in ("NeuralDiagonal", "NeuralGeneral", "NeuralAdditive",
                  "NeuralScalar")]
IDS = [f"{n}-{meth}" for n, meth, _, _ in CASES]


@pytest.mark.parametrize("name,method,adjoint_method,tol", CASES, ids=IDS)
def test_gradients_match_jax_adjoint_f64(name, method, adjoint_method, tol):
    del tol
    jp = jax_problem(name, _sde_type(method))
    _, bm = _bms(jp.noise_type)
    got = _port_grads(ProblemPort(jp), bm, ttsde.sdeint_adjoint, method,
                      adjoint_method)
    _assert_grads_close(got, _jax_grads(name, _sde_type(method), method,
                                        adjoint_method), TOL)


@pytest.mark.parametrize("name,method,adjoint_method,tol", CASES, ids=IDS)
def test_adjoint_against_backprop(name, method, adjoint_method, tol):
    """The JAX package's test_against_sdeint and test_reversible_exact on
    the port: ``ts`` lies on the ``dt`` grid, so both solves step the same
    grid on the same interval."""
    sde = ProblemPort(jax_problem(name, _sde_type(method)))
    _, bm = _bms(sde.noise_type)
    ga = _port_grads(sde, bm, ttsde.sdeint_adjoint, method, adjoint_method)
    gb = _port_grads(sde, bm, ttsde.sdeint, method)
    assert _max_rel_err(ga, gb) < tol


def test_values_match_jax_adjoint_off_the_dt_grid():
    """Where ``ts`` is not on the ``dt`` grid the adjoint steps to every
    output time, as the JAX package's does, and differs from ``sdeint``."""
    ts = [0.0, 0.13, 0.4]
    jp = jax_problem("NeuralDiagonal", "stratonovich")
    jbm, tbm = _bms(jp.noise_type)
    want = jtsde.sdeint_adjoint(jp, jnp.asarray(_y0_np()), ts, bm=jbm,
                                method="midpoint", dt=DT)
    sde = ProblemPort(jp)
    y0 = torch.as_tensor(_y0_np())
    with torch.no_grad():
        got = ttsde.sdeint_adjoint(sde, y0, ts, bm=tbm, method="midpoint",
                                   dt=DT)
        plain = ttsde.sdeint(sde, y0, ts, bm=tbm, method="midpoint", dt=DT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    assert float((got - plain).abs().max()) > 1e-6


def test_logqp_gradients_match_jax_f64():
    jp = jax_problem("ExDiagonal", "ito")
    jbm, tbm = _bms(jp.noise_type, logqp=True)

    def jloss(sde_, y0_):
        ys, lq = jtsde.sdeint_adjoint(sde_, y0_, TS, bm=jbm, method="euler",
                                      dt=DT, logqp=True)
        return jnp.sum(ys[-1] ** 2) + jnp.sum(lq)

    g_sde, g_y0 = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(_y0_np()))
    want = {"y0": np.asarray(g_y0), **jax_named_arrays(g_sde)}
    sde = ProblemPort(jp)
    y0 = torch.tensor(_y0_np(), requires_grad=True)
    ys, lq = ttsde.sdeint_adjoint(sde, y0, TS, bm=tbm, method="euler", dt=DT,
                                  logqp=True)
    grads = torch.autograd.grad((ys[-1] ** 2).sum() + lq.sum(),
                                [y0, sde.mu, sde.sigma])
    got = dict(zip(("y0", "mu", "sigma"), (g.numpy() for g in grads)))
    _assert_grads_close(got, want, TOL)


class OwnGProd(ProblemPort):
    """A problem that also spells its diffusion-vector product."""

    def g_prod(self, t, y, v):
        return self.g(t, y) * v


@pytest.mark.parametrize("name", ["ExDiagonal", "NeuralDiagonal"])
def test_milstein_adjoint_with_the_sdes_own_g_prod(name):
    """An SDE that spells its own g_prod gets the Milstein adjoint's
    gradients of the JAX package (the correction pair is taken from g)."""
    jp = jax_problem(name, "ito")
    _, bm = _bms(jp.noise_type)
    got = _port_grads(OwnGProd(jp), bm, ttsde.sdeint_adjoint, "euler",
                      "milstein")
    _assert_grads_close(got, _jax_grads(name, "ito", "euler", "milstein"),
                        TOL)


def test_double_backward_matches_backprop():
    """Grad of the squared gradient of ``f_net.w1``, through the adjoint and
    through backprop, as tests/test_adjoint.py:test_gradgrad."""
    sde = ProblemPort(problems.NeuralDiagonal(d=2, sde_type="stratonovich"))
    bm = ttsde.BrownianInterval(0.0, 0.4, (4, 2), dtype=torch.float64,
                                entropy=3, levels=8, device="cpu")
    y0 = torch.full((4, 2), 0.1, dtype=torch.float64)
    w = sde.f_net.w1
    gg = []
    for solve in (ttsde.sdeint_adjoint, ttsde.sdeint):
        ys = solve(sde, y0, TS, bm=bm, method="midpoint", dt=DT)
        g, = torch.autograd.grad((ys[-1] ** 2).sum(), w, create_graph=True)
        gg.append(torch.autograd.grad((g ** 2).sum(), w)[0])
    scale = float(gg[1].abs().max())
    assert torch.isfinite(gg[0]).all()
    assert float((gg[0] - gg[1]).abs().max()) / scale < 1e-2


# --------------------------------------------------------------------------- #
#  The default noise, replayed                                                #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rng_impl", ["generator", "philox"])
def test_default_noise_replay(rng_impl):
    """Two runs on one seed give bitwise gradients; the reversible pair
    matches backprop through ``sdeint`` on the same seed (``ts`` on the
    ``dt`` grid); ``backward()`` leaves the generator as the forward left
    it."""
    sde = ProblemPort(problems.NeuralGeneral(d=d, m=m,
                                             sde_type="stratonovich"))
    params = list(sde.parameters())

    def grads(solve, method):
        gen = torch.Generator().manual_seed(11)
        ys = solve(sde, torch.as_tensor(_y0_np()), TS, method=method, dt=DT,
                   generator=gen, rng_impl=rng_impl)
        after_forward = gen.get_state()
        out = torch.autograd.grad(_loss(ys), params)
        assert torch.equal(gen.get_state(), after_forward)
        return out

    for method in ("midpoint", "reversible_heun"):
        first = grads(ttsde.sdeint_adjoint, method)
        second = grads(ttsde.sdeint_adjoint, method)
        assert all(torch.equal(x, y) for x, y in zip(first, second))
        assert any(float(x.abs().sum()) > 0 for x in first)
    backprop = grads(ttsde.sdeint, "reversible_heun")
    scale = max(float(x.abs().max()) for x in backprop)
    err = max(float((x - y).abs().max()) for x, y in zip(first, backprop))
    assert err / scale < TOL


def test_replay_with_pytorchs_default_generator():
    """Without a generator the noise comes from PyTorch's default one: the
    backward redraws from a copy of its state and does not advance it."""
    sde = ProblemPort(problems.NeuralDiagonal(d=d, sde_type="stratonovich"))
    torch.manual_seed(5)
    ys = ttsde.sdeint_adjoint(sde, torch.as_tensor(_y0_np()), TS,
                              method="reversible_heun", dt=DT)
    state = torch.get_rng_state()
    g_adj = torch.autograd.grad(_loss(ys), list(sde.parameters()))
    assert torch.equal(torch.get_rng_state(), state)
    torch.manual_seed(5)
    ys = ttsde.sdeint(sde, torch.as_tensor(_y0_np()), TS,
                      method="reversible_heun", dt=DT)
    g_bp = torch.autograd.grad(_loss(ys), list(sde.parameters()))
    scale = max(float(x.abs().max()) for x in g_bp)
    assert max(float((x - y).abs().max())
               for x, y in zip(g_adj, g_bp)) / scale < TOL


def test_noise_replay_redraws_the_draw():
    for rng_impl in ("generator", "philox"):
        gen = torch.Generator().manual_seed(3)
        replay = TI.NoiseReplay(gen, (4, 2), torch.float64, "cpu", rng_impl,
                                "space-time")
        grid = TI.build_interval_grid([0.0, 0.3, 1.0], 0.1)[0]
        W, U, _ = replay.draw(grid, needs_U=True)
        state = gen.get_state()
        W2, U2, _ = replay.redraw(grid, needs_U=True)
        W3, _, _ = replay.redraw(grid)
        assert torch.equal(W, W2) and torch.equal(U, U2)
        assert torch.equal(W, W3)
        assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("needs_U,needs_A", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_query_bm_normalises_to_a_triple(needs_U, needs_A):
    bm = ttsde.BrownianInterval(0.0, 1.0, (4, 3), dtype=torch.float64,
                                entropy=5, levels=8, device="cpu",
                                levy_area_approximation="foster")
    W, U, A = TI.query_bm(bm, 0.25, 0.5, needs_U, needs_A)
    want = bm(0.25, 0.5, return_U=True, return_A=True)
    assert torch.equal(W, want[0])
    assert (U is None) != needs_U and (A is None) != needs_A
    assert U is None or torch.equal(U, want[1])
    assert A is None or torch.equal(A, want[2])


def test_build_interval_grid_matches_jax():
    from torchsde_tpu.core import integrate as JI
    for ts, dt in (([0.0, 0.2, 0.4], 0.025), (np.linspace(0, 1, 32), 1 / 128),
                   ([0.0, 0.13, 0.4], 0.05), ([1.0], 0.1)):
        want = JI.build_interval_grid(ts, dt)
        got = TI.build_interval_grid(ts, dt)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    grid, bidx = TI.build_interval_grid(np.linspace(0, 1, 32), 1 / 128)
    assert len(grid) - 1 == 155 and bidx[-1] == 155


# --------------------------------------------------------------------------- #
#  Adjoint parameters                                                         #
# --------------------------------------------------------------------------- #

class HeldSDE(ttsde.SDEStratonovich):
    """Its drift reads a parameter, a buffer and a plain tensor attribute,
    the last two made by an upstream computation."""

    def __init__(self, scale, shift, rate):
        super().__init__(noise_type="diagonal")
        self.rate = nn.Parameter(rate)
        self.register_buffer("scale", scale)
        self.shift = shift

    def f(self, t, y):
        return -self.rate * y * self.scale + self.shift

    def g(self, t, y):
        return 0.3 * torch.sin(y) + 0.5


@pytest.mark.parametrize("method,tol", [("reversible_heun", TOL),
                                        ("midpoint", 2e-2)])
def test_gradients_reach_buffers_and_tensor_attributes(method, tol):
    """A buffer and a plain attribute that are outputs of a computation get
    their gradients as Function inputs, and autograd carries them on, as
    backprop through the same solve does."""
    base = torch.tensor([0.5, 1.0, 1.5], dtype=torch.float64,
                        requires_grad=True)
    bm = _bms("diagonal")[1]
    y0 = torch.as_tensor(_y0_np())
    grads = []
    for solve in (ttsde.sdeint_adjoint, ttsde.sdeint):
        sde = HeldSDE(base * 2.0, torch.cos(base),
                      torch.tensor([0.3, 0.2, 0.1], dtype=torch.float64))
        assert len(collect_adjoint_params(sde)) == 3
        ys = solve(sde, y0, TS, bm=bm, method=method, dt=DT)
        grads.append(torch.autograd.grad(_loss(ys), [base, sde.rate]))
    for a, bp in zip(*grads):
        assert float(a.abs().max()) > 0
        assert float((a - bp).abs().max()) / float(bp.abs().max()) < tol


def test_double_backward_through_a_computed_buffer():
    """The second derivative in the upstream tensor behind a buffer, by
    the adjoint (whose backward splices its leaf stand-in back onto the
    buffer) and by backprop, as test_double_backward_matches_backprop."""
    base = torch.tensor([0.5, 1.0, 1.5], dtype=torch.float64,
                        requires_grad=True)
    bm = _bms("diagonal")[1]
    y0 = torch.as_tensor(_y0_np())
    gg = []
    for solve in (ttsde.sdeint_adjoint, ttsde.sdeint):
        sde = HeldSDE(base * 2.0, torch.cos(base),
                      torch.tensor([0.3, 0.2, 0.1], dtype=torch.float64))
        ys = solve(sde, y0, TS, bm=bm, method="midpoint", dt=DT)
        g, = torch.autograd.grad(_loss(ys), base, create_graph=True)
        gg.append(torch.autograd.grad((g ** 2).sum(), base)[0])
    scale = float(gg[1].abs().max())
    assert scale > 0 and torch.isfinite(gg[0]).all()
    assert float((gg[0] - gg[1]).abs().max()) / scale < 1e-2


def test_collect_adjoint_params_walks_the_wrappers_once():
    sde = ProblemPort(problems.NeuralDiagonal(d=d, sde_type="ito"))
    sde.tied = sde.f_net.w1            # the same tensor twice
    sde.frozen = torch.ones(3)         # does not require grad
    from torchsde_tpu_torch.core.base_sde import (ForwardSDE,
                                                  RenameMethodsSDE,
                                                  SDELogqp)
    wrapped = ForwardSDE(SDELogqp(RenameMethodsSDE(sde)))
    got = collect_adjoint_params(wrapped)
    assert [id(p) for p in got] == [id(p) for p in sde.parameters()]


def test_adjoint_params_must_be_collected():
    sde = ProblemPort(problems.NeuralDiagonal(d=d, sde_type="stratonovich"))
    _, bm = _bms(sde.noise_type)
    y0 = torch.as_tensor(_y0_np())
    ys = ttsde.sdeint_adjoint(sde, y0, TS, bm=bm, method="midpoint", dt=DT,
                              adjoint_params=tuple(sde.parameters()))
    assert ys.shape == (len(TS), b, d)
    foreign = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError, match=r"positions \[1\]"):
        ttsde.sdeint_adjoint(sde, y0, TS, bm=bm, method="midpoint", dt=DT,
                             adjoint_params=(sde.f_net.w1, foreign))


# --------------------------------------------------------------------------- #
#  What is not ported                                                         #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kwargs,error,match", [
    (dict(key=3), TypeError, "generator="),
    (dict(entropy=3), TypeError, "generator="),
])
def test_unported_keywords_raise(kwargs, error, match):
    sde = ProblemPort(problems.NeuralDiagonal(d=d, sde_type="stratonovich"))
    with pytest.raises(error, match=match):
        ttsde.sdeint_adjoint(sde, torch.as_tensor(_y0_np()), TS,
                             method="midpoint", dt=DT, **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(adaptive=True),
    dict(adjoint_adaptive=True),
    dict(adaptive=True, rtol=1e-2),
    dict(adjoint_adaptive=True, adjoint_atol=1e-2),
    dict(noise_precompute=False),
], ids=["adaptive", "adjoint_adaptive", "rtol", "adjoint_atol",
        "noise_precompute"])
def test_jax_keywords_take_effect(kwargs):
    """The keywords that raised before adaptive stepping was ported: each
    gives the JAX package's gradients with the same keyword, on one
    BrownianInterval, at 1e-9 of scale (``noise_precompute=False``: the
    interval queried per step in both passes)."""
    name, sde_type = "ExDiagonal", "ito"
    base = dict(rtol=1e-3, atol=1e-3, adjoint_rtol=1e-3, adjoint_atol=1e-3,
                dt_min=1e-3)
    base.update(kwargs)
    want = _jax_grads(name, sde_type, "milstein", None,
                      tuple(sorted(base.items())))
    sde = ProblemPort(jax_problem(name, sde_type))
    _, bm = _bms(sde.noise_type)
    got = _port_grads(sde, bm, ttsde.sdeint_adjoint, "milstein", **base)
    _assert_grads_close(got, want, TOL)


def test_unroll_is_accepted_and_changes_nothing():
    sde = ProblemPort(problems.NeuralDiagonal(d=d, sde_type="stratonovich"))
    _, bm = _bms(sde.noise_type)
    y0 = torch.as_tensor(_y0_np())
    with torch.no_grad():
        a = ttsde.sdeint_adjoint(sde, y0, TS, bm=bm, method="midpoint",
                                 dt=DT)
        u = ttsde.sdeint_adjoint(sde, y0, TS, bm=bm, method="midpoint",
                                 dt=DT, unroll=8)
    assert torch.equal(a, u)
