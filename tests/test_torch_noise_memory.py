"""The port's noise policy, in-loop noise and sparse outputs against
torchsde_tpu's (``tests/test_noise_memory.py``), in float64.

* the policy: ``noise_buffer_bytes`` and ``should_precompute_noise`` give
  the JAX package's numbers, and the adjoint sizes its one choice on the
  union of its two methods' U and A needs;
* the default noise made in the loop: ``make_iid_noise_fn`` on a JAX key's
  words gives the JAX package's W, U and A to the rounding of ``erfinv``;
  a whole ``sdeint`` and ``sdeint_adjoint`` on it (the key drawn as the
  JAX key) are the JAX package's ``noise_precompute=False`` solves at
  1e-9; the adjoint replays it (its gradients against backprop on the
  same stream); ``rng_impl="philox"`` warns as JAX's ``pallas`` does;
* object mode: in-loop queries are bitwise the precomputed ones, in
  ``sdeint`` and in both passes of ``sdeint_adjoint``;
* the reversible-Heun pair follows the same choice: in the loop, object
  mode is the JAX pair's and bitwise the precomputed pair's, and the keyed
  stream replays (gradients against backprop on one stream);
* sparse outputs: the port keeps only the bracketing states, and its
  values and gradients are the JAX package's on its dense path and, with
  ``DENSE_OUTPUT_MAX_BYTES`` lowered, on its sparse path, with ``logqp``,
  ``srk``, in-loop noise and ``remat``.

The thresholds are lowered by ``monkeypatch``, as the JAX package's tests
lower them."""

import warnings

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
from torchsde_tpu.core import adjoint as JA
from torchsde_tpu.core import integrate as JI
from torchsde_tpu_torch.core import adjoint as TA
from torchsde_tpu_torch.core import integrate as TI

b, d = 8, 3
TS = [0.0, 0.2, 0.4]
DT = 0.025
TOL = 1e-9


def _bms(levy="none"):
    return (jtsde.BrownianInterval(0.0, 0.4, (b, d), dtype=jnp.float64,
                                   entropy=7, levels=12,
                                   levy_area_approximation=levy),
            ttsde.BrownianInterval(0.0, 0.4, (b, d), dtype=torch.float64,
                                   entropy=7, levels=12,
                                   levy_area_approximation=levy,
                                   device="cpu"))


def _y0():
    return np.full((b, d), 0.1)


def _close(got, want, rel=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * (1.0 + np.max(np.abs(want))))


def _jax_key_as_draw(monkeypatch, seed):
    """Make the port draw JAX's PRNGKey(seed) words as its solve key."""
    key = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    monkeypatch.setattr(TI, "draw_key", lambda generator, device:
                        torch.as_tensor(key, device=device))
    return jax.random.PRNGKey(seed)


# --------------------------------------------------------------------------- #
#  The policy                                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n_steps,size,dtype,needs_U,needs_A", [
    (100, (8, 4), "float32", False, False),
    (100, (8, 4), "float32", True, False),
    (100, (8, 4), "float32", True, True),
    (256, (16384, 128), "float32", False, False),
    (1000, (8,), "float64", True, True),
])
def test_policy_matches_jax(n_steps, size, dtype, needs_U, needs_A):
    want = JI.noise_buffer_bytes(n_steps, size, getattr(jnp, dtype), needs_U,
                                 needs_A)
    got = TI.noise_buffer_bytes(n_steps, size, getattr(torch, dtype),
                                needs_U, needs_A)
    assert got == want
    for override in (None, True, False):
        assert TI.should_precompute_noise(
            n_steps, size, getattr(torch, dtype), needs_U, needs_A,
            override) == JI.should_precompute_noise(
            n_steps, size, getattr(jnp, dtype), needs_U, needs_A, override)


def test_policy_threshold(monkeypatch):
    w = 100 * 32 * 4
    monkeypatch.setattr(TI, "NOISE_PRECOMPUTE_MAX_BYTES", w)
    assert TI.should_precompute_noise(100, (8, 4), torch.float32, False,
                                      False)
    assert not TI.should_precompute_noise(101, (8, 4), torch.float32, False,
                                          False)
    assert TI.should_precompute_noise(101, (8, 4), torch.float32, False,
                                      False, override=True)
    assert not TI.should_precompute_noise(1, (8, 4), torch.float32, False,
                                          False, override=False)


@pytest.mark.parametrize("method,adjoint_method", [
    ("euler", "euler"), ("srk", "euler"), ("euler", "srk"),
    ("log_ode", "euler")])
def test_adjoint_policy_counts_levy_buffers(monkeypatch, method,
                                            adjoint_method):
    """The adjoint's one choice for both passes is sized on the union of
    its methods' U and A needs, as the JAX package's ``_precompute_noise``:
    with the threshold at the W buffer alone, only euler/euler
    precomputes."""
    jbm, tbm = _bms()
    grid = TI.build_interval_grid([0.0, 1.0], 0.01)[0]
    n_steps = len(grid) - 1
    w = TI.noise_buffer_bytes(n_steps, (b, d), torch.float64, False, False)
    monkeypatch.setattr(TI, "NOISE_PRECOMPUTE_MAX_BYTES", w)
    monkeypatch.setattr(JI, "NOISE_PRECOMPUTE_MAX_BYTES", w)
    cfg = JA._Cfg(ts=(0.0, 1.0), dt=0.01, method=method,
                  adjoint_method=adjoint_method, grid_noise=False,
                  levy="space-time", options=(), adjoint_options=(),
                  rtol=1e-5, atol=1e-4, dt_min=1e-5)
    plan = TA.SolvePlan(sde=None, params=(), slots=[], bm=tbm, ts=[0.0, 1.0],
                        dt=0.01, time_dtype=torch.float64,
                        rng_impl="generator", noise_precompute=None,
                        methods=(method, adjoint_method))
    want = JA._precompute_noise(cfg, jbm, n_steps)
    assert plan.precompute == want == (method == adjoint_method == "euler")


# --------------------------------------------------------------------------- #
#  The default noise made in the loop                                         #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("size,needs_U,needs_A,levy", [
    ((b, d), False, False, "none"),
    ((b, d), True, False, "space-time"),
    ((b, d), True, True, "davie"),
    ((b, d), False, True, "foster"),
    ((b,), True, True, "davie"),
])
def test_in_loop_noise_matches_jax(size, needs_U, needs_A, levy):
    key = jax.random.PRNGKey(4)
    jfn = JI.make_iid_noise_fn(key, size, jnp.float64, needs_U, needs_A,
                               levy)
    tfn = TI.make_iid_noise_fn(torch.as_tensor(
        np.asarray(key).astype(np.int64)), size, torch.float64, needs_U,
        needs_A, levy)
    grid = np.array([0.0, 0.1, 0.25, 0.3])
    for i in range(3):
        want = jfn(i, jnp.asarray(grid[i]), jnp.asarray(grid[i + 1]))
        got = tfn(i, torch.tensor(grid[i]), torch.tensor(grid[i + 1]))
        for w, g in zip(want, got):
            assert (w is None) == (g is None)
            if w is not None:
                _close(g, w, rel=1e-12)


def test_in_loop_noise_is_a_function_of_key_and_index():
    key = torch.as_tensor(np.asarray(jax.random.PRNGKey(2)).astype(
        np.int64))
    fn = TI.make_iid_noise_fn(key, (b, d), torch.float64, True, True,
                              "foster")
    t0, t1 = torch.tensor(0.1, dtype=torch.float64), torch.tensor(
        0.2, dtype=torch.float64)
    first = [fn(i, t0, t1) for i in range(4)]
    again = [fn(i, t0, t1) for i in reversed(range(4))][::-1]
    for x, y in zip(first, again):
        assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert not torch.equal(first[0][0], first[1][0])


@pytest.mark.parametrize("method,levy", [("euler", "none"),
                                         ("srk", "space-time"),
                                         ("milstein", "none")])
def test_in_loop_sdeint_matches_jax(monkeypatch, method, levy):
    jp = problems.ExDiagonal(d=d, sde_type="ito")
    key = _jax_key_as_draw(monkeypatch, 11)
    sched = [0.0, 0.013, 0.2, 0.317, 0.4]
    want = jtsde.sdeint(jp, jnp.asarray(_y0()), sched, method=method, dt=DT,
                        key=key, noise_precompute=False)
    with torch.no_grad():
        got = ttsde.sdeint(ProblemPort(jp), torch.as_tensor(_y0()), sched,
                           method=method, dt=DT, noise_precompute=False)
    _close(got, want)


def test_in_loop_default_noise_draws_one_key():
    """The key is drawn once from the generator: one seed gives the same
    solve, the generator moves by the one draw."""
    sde = ProblemPort(problems.ExDiagonal(d=d, sde_type="ito"))
    y0 = torch.as_tensor(_y0())
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    with torch.no_grad():
        a = ttsde.sdeint(sde, y0, TS, method="euler", dt=DT, generator=gens[0],
                         noise_precompute=False)
        b_ = ttsde.sdeint(sde, y0, TS, method="euler", dt=DT,
                          generator=gens[1], noise_precompute=False)
    assert torch.equal(a, b_)
    ref = torch.Generator().manual_seed(3)
    TI.draw_key(ref, "cpu")
    assert torch.equal(gens[0].get_state(), ref.get_state())


def test_in_loop_adjoint_matches_jax(monkeypatch):
    """sdeint_adjoint with noise_precompute=False on the JAX key: its
    gradients are the JAX package's at 1e-9, the backward replaying the
    forward's increments by key and step index."""
    jp = problems.NeuralDiagonal(d=d, sde_type="stratonovich")
    key = _jax_key_as_draw(monkeypatch, 5)

    def jloss(s, y):
        ys = jtsde.sdeint_adjoint(s, y, TS, method="midpoint", dt=DT, key=key,
                                  noise_precompute=False)
        return jnp.sum(ys[-1] ** 2) + jnp.sum(ys[1])

    g_sde, g_y0 = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(_y0()))
    want = {"y0": np.asarray(g_y0), **jax_named_arrays(g_sde)}
    sde = ProblemPort(jp)
    y0 = torch.tensor(_y0(), requires_grad=True)
    ys = ttsde.sdeint_adjoint(sde, y0, TS, method="midpoint", dt=DT,
                              noise_precompute=False)
    names = ["y0"] + [n for n, _ in sde.named_parameters()]
    grads = torch.autograd.grad((ys[-1] ** 2).sum() + ys[1].sum(),
                                [y0] + list(sde.parameters()))
    got = dict(zip(names, (g.numpy() for g in grads)))
    assert set(got) == set(want)
    for name, w in want.items():
        _close(got[name], w)


def test_in_loop_adjoint_replays_the_forward():
    """Adjoint gradients on the in-loop stream against backprop through
    sdeint on the same stream (one generator seed, so one key), as the JAX
    package holds them (``test_grid_mode_adjoint_matches_backprop_in_
    scan``, 1e-3 of scale)."""
    sde = ProblemPort(problems.NeuralDiagonal(d=d, sde_type="stratonovich"))
    grads = []
    for solve in (ttsde.sdeint_adjoint, ttsde.sdeint):
        y0 = torch.tensor(_y0(), requires_grad=True)
        ys = solve(sde, y0, TS, method="midpoint", dt=DT,
                   generator=torch.Generator().manual_seed(5),
                   noise_precompute=False)
        grads.append(torch.autograd.grad((ys[-1] ** 2).sum() + ys[1].sum(),
                                         [y0] + list(sde.parameters())))
    scale = max(float(g.abs().max()) for g in grads[1])
    err = max(float((a - c).abs().max()) for a, c in zip(*grads))
    assert err / scale < 1e-3


def test_philox_in_loop_warns(monkeypatch):
    sde = ProblemPort(problems.ExDiagonal(d=d, sde_type="ito"))
    y0 = torch.as_tensor(_y0())
    with pytest.warns(UserWarning, match="philox.*noise_precompute=False"):
        with torch.no_grad():
            ttsde.sdeint(sde, y0, TS, method="euler", dt=DT,
                         rng_impl="philox", noise_precompute=False)
    monkeypatch.setattr(TI, "NOISE_PRECOMPUTE_MAX_BYTES", 0)
    with pytest.warns(UserWarning, match="philox.*exceed the precompute"):
        ys = ttsde.sdeint_adjoint(sde, y0.clone().requires_grad_(), TS,
                                  method="euler", dt=DT, rng_impl="philox")
        ys.sum().backward()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.no_grad():
            ttsde.sdeint(sde, y0, TS, method="euler", dt=DT,
                         rng_impl="philox", noise_precompute=True)


# --------------------------------------------------------------------------- #
#  Object mode                                                                #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("method,levy", [("euler", "none"),
                                         ("milstein", "none"),
                                         ("srk", "space-time")])
def test_object_mode_bitwise(method, levy):
    """In-loop queries of an explicit interval are bitwise its precomputed
    query_grid, every channel; and the JAX package's at 1e-9."""
    jp = problems.ExDiagonal(d=d, sde_type="ito")
    jbm, tbm = _bms(levy)
    sde = ProblemPort(jp)
    with torch.no_grad():
        a = ttsde.sdeint(sde, torch.as_tensor(_y0()), TS, bm=tbm,
                         method=method, dt=DT, noise_precompute=True)
        c = ttsde.sdeint(sde, torch.as_tensor(_y0()), TS, bm=tbm,
                         method=method, dt=DT, noise_precompute=False)
    assert torch.equal(a, c)
    want = jtsde.sdeint(jp, jnp.asarray(_y0()), TS, bm=jbm, method=method,
                        dt=DT, noise_precompute=False)
    _close(c, want)


def test_auto_policy_flips_to_in_loop(monkeypatch):
    """With the threshold at zero the default choice is in-loop: object
    mode bitwise the precomputed solve, default noise the keyed stream,
    and both passes of the adjoint in-loop, its gradients bitwise those
    of the forced choice."""
    jp = problems.ExDiagonal(d=d, sde_type="ito")
    _, tbm = _bms()
    sde = ProblemPort(jp)
    y0 = torch.as_tensor(_y0())
    with torch.no_grad():
        ref = ttsde.sdeint(sde, y0, TS, bm=tbm, method="milstein", dt=DT,
                           noise_precompute=True)
        keyed = ttsde.sdeint(sde, y0, TS, method="milstein", dt=DT,
                             generator=torch.Generator().manual_seed(1),
                             noise_precompute=False)
    monkeypatch.setattr(TI, "NOISE_PRECOMPUTE_MAX_BYTES", 0)
    with torch.no_grad():
        assert torch.equal(ttsde.sdeint(sde, y0, TS, bm=tbm,
                                        method="milstein", dt=DT), ref)
        assert torch.equal(ttsde.sdeint(
            sde, y0, TS, method="milstein", dt=DT,
            generator=torch.Generator().manual_seed(1)), keyed)
    grads = []
    for precompute in (None, False):
        ys = ttsde.sdeint_adjoint(sde, y0, TS, bm=tbm, method="milstein",
                                  dt=DT, noise_precompute=precompute)
        grads.append(torch.autograd.grad((ys[-1] ** 2).sum(),
                                         list(sde.parameters())))
    assert all(torch.equal(x, y) for x, y in zip(*grads))


def test_object_mode_adjoint_in_loop_is_precomputed(monkeypatch):
    """Both passes of the adjoint query the interval per step: gradients
    bitwise those of the precomputed noise."""
    jp = problems.ExDiagonal(d=d, sde_type="ito")
    _, tbm = _bms("space-time")
    sde = ProblemPort(jp)
    calls = []
    fn = TI.bm_noise_fn
    monkeypatch.setattr(TI, "bm_noise_fn", lambda *a: calls.append(1)
                        or fn(*a))
    grads = []
    for precompute in (True, False):
        y0 = torch.tensor(_y0(), requires_grad=True)
        ys = ttsde.sdeint_adjoint(sde, y0, TS, bm=tbm, method="srk",
                                  adjoint_method="euler", dt=DT,
                                  noise_precompute=precompute)
        grads.append(torch.autograd.grad(ys.sum(), [y0] + list(
            sde.parameters())))
    assert len(calls) == 2
    assert all(torch.equal(x, y) for x, y in zip(*grads))


# --------------------------------------------------------------------------- #
#  The reversible-Heun pair                                                   #
# --------------------------------------------------------------------------- #

def _pair_grads(sde, **kw):
    y0 = torch.tensor(_y0(), requires_grad=True)
    ys = ttsde.sdeint_adjoint(sde, y0, TS, method="reversible_heun", dt=DT,
                              **kw)
    names = ["y0"] + [n for n, _ in sde.named_parameters()]
    grads = torch.autograd.grad((ys[-1] ** 2).sum() + ys[1].sum(),
                                [y0] + list(sde.parameters()))
    return dict(zip(names, grads))


def test_reversible_pair_object_mode_in_loop(monkeypatch):
    """With noise_precompute=False the pair queries the interval per step
    in both passes, as the JAX pair does: its gradients are the JAX
    pair's at 1e-9 and bitwise the precomputed pair's."""
    jp = problems.NeuralDiagonal(d=d, sde_type="stratonovich")
    jbm, tbm = _bms()
    sde = ProblemPort(jp)
    calls = []
    fn = TI.bm_noise_fn
    monkeypatch.setattr(TI, "bm_noise_fn", lambda *a: calls.append(1)
                        or fn(*a))
    in_loop = _pair_grads(sde, bm=tbm, noise_precompute=False)
    assert len(calls) == 2
    pre = _pair_grads(sde, bm=tbm, noise_precompute=True)
    assert all(torch.equal(in_loop[k], pre[k]) for k in pre)

    def jloss(s, y):
        ys = jtsde.sdeint_adjoint(s, y, TS, bm=jbm, method="reversible_heun",
                                  dt=DT, noise_precompute=False)
        return jnp.sum(ys[-1] ** 2) + jnp.sum(ys[1])

    g_sde, g_y0 = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(_y0()))
    want = {"y0": np.asarray(g_y0), **jax_named_arrays(g_sde)}
    assert set(in_loop) == set(want)
    for name, w in want.items():
        _close(in_loop[name].numpy(), w)


@pytest.mark.parametrize("choice", ["forced", "policy"])
def test_reversible_pair_replays_in_loop_default_noise(monkeypatch, choice):
    """The pair's default noise made in the loop, by noise_precompute=False
    or by the policy past its threshold: the backward replays the keyed
    stream, so its exact gradients are those of backprop through sdeint on
    the same stream (one generator seed, one key) at 1e-9, as the
    precomputed pair's are."""
    sde = ProblemPort(problems.NeuralDiagonal(d=d, sde_type="stratonovich"))
    kw = dict(noise_precompute=False)
    if choice == "policy":
        monkeypatch.setattr(TI, "NOISE_PRECOMPUTE_MAX_BYTES", 0)
        kw = {}
    keyed = []
    fn = TI.make_iid_noise_fn
    monkeypatch.setattr(TI, "make_iid_noise_fn", lambda *a, **k: keyed.append(
        1) or fn(*a, **k))
    got = _pair_grads(sde, generator=torch.Generator().manual_seed(6), **kw)
    assert len(keyed) == 2   # the forward's stream and the backward's replay
    y0 = torch.tensor(_y0(), requires_grad=True)
    ys = ttsde.sdeint(sde, y0, TS, method="reversible_heun", dt=DT,
                      generator=torch.Generator().manual_seed(6),
                      noise_precompute=False)
    want = torch.autograd.grad((ys[-1] ** 2).sum() + ys[1].sum(),
                               [y0] + list(sde.parameters()))
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((got[k] - w).abs().max()) for k, w in zip(got, want))
    assert err / scale < TOL


# --------------------------------------------------------------------------- #
#  Sparse outputs                                                             #
# --------------------------------------------------------------------------- #

def _port_and_jax(monkeypatch, port_loss, jax_loss, jp):
    """The port's loss, its outputs and its parameter gradients, each held
    at 1e-9 to the JAX package's on its dense path and, with its
    threshold lowered, on its sparse one. ``port_loss(sde)`` and
    ``jax_loss(sde)`` return ``(loss, outputs)``."""
    sde = ProblemPort(jp)
    loss, outs = port_loss(sde)
    names = [n for n, _ in sde.named_parameters()]
    got = dict(zip(names, (g.numpy() for g in torch.autograd.grad(
        loss, list(sde.parameters())))))
    for dense in (True, False):
        if not dense:
            monkeypatch.setattr(JI, "DENSE_OUTPUT_MAX_BYTES", 0)
        g_sde, want = jax.grad(jax_loss, has_aux=True)(jp)
        want_g = jax_named_arrays(g_sde)
        assert set(got) == set(want_g)
        for name, w in want_g.items():
            _close(got[name], w)
        for o, w in zip(outs, want):
            _close(o.detach(), w)


def test_sparse_outputs_match_dense(monkeypatch):
    """Output times at the ends, on the grid, off it and two in one cell:
    the port keeps y0 and the grid states around the five others, and its
    values and gradients are the JAX package's dense path's and sparse
    path's at 1e-9."""
    jp = problems.ExDiagonal(d=d, sde_type="ito")
    jbm, tbm = _bms()
    sched = [0.0, 0.011, 0.013, 0.2, 0.317, 0.4]
    kept = []
    ito = TI.integrate_to_outputs
    monkeypatch.setattr(TI, "integrate_to_outputs",
                        lambda *a, **k: kept.append(len(a[4])) or ito(*a, **k))

    def port_loss(sde):
        ys = ttsde.sdeint(sde, torch.as_tensor(_y0()), sched, bm=tbm,
                          method="milstein", dt=DT)
        return (ys ** 2).sum(), (ys,)

    def jax_loss(sde):
        ys = jtsde.sdeint(sde, jnp.asarray(_y0()), sched, bm=jbm,
                          method="milstein", dt=DT)
        return jnp.sum(ys ** 2), (ys,)

    _port_and_jax(monkeypatch, port_loss, jax_loss, jp)
    assert kept == [8]   # y0 and the grid points around the five others


@pytest.mark.parametrize("remat", [False, True])
def test_sparse_outputs_srk_logqp_in_loop(monkeypatch, remat):
    """Sparse outputs with the U channel (srk), logqp, in-loop noise (the
    key drawn as JAX's) and remat: the JAX package's values and gradients
    on its dense and its sparse path at 1e-9."""
    jp = problems.ExDiagonal(d=d, sde_type="ito")
    key = _jax_key_as_draw(monkeypatch, 9)

    def port_loss(sde):
        ys, lq = ttsde.sdeint(sde, torch.as_tensor(_y0()), TS, method="srk",
                              dt=DT, logqp=True, remat=remat,
                              noise_precompute=False)
        return (ys ** 2).sum() + lq.sum(), (ys, lq)

    def jax_loss(sde):
        ys, lq = jtsde.sdeint(sde, jnp.asarray(_y0()), TS, method="srk",
                              dt=DT, logqp=True, remat=remat, key=key,
                              noise_precompute=False)
        return jnp.sum(ys ** 2) + jnp.sum(lq), (ys, lq)

    _port_and_jax(monkeypatch, port_loss, jax_loss, jp)


@pytest.mark.parametrize("in_loop", [False, True])
def test_remat_grads_match_nonremat(in_loop):
    sde = ProblemPort(problems.ExDiagonal(d=d, sde_type="ito"))
    grads = []
    for remat in (False, True):
        ys = ttsde.sdeint(sde, torch.as_tensor(_y0()), TS, dt=DT,
                          remat=remat, noise_precompute=not in_loop,
                          generator=torch.Generator().manual_seed(5))
        grads.append(torch.autograd.grad((ys ** 2).sum(),
                                         list(sde.parameters())))
    for x, y in zip(*grads):
        np.testing.assert_allclose(x, y, rtol=1e-14, atol=0)
