"""The port's order diagnostics (``diagnostics/problems.py``,
``harness.py``, ``inspection.py``, ``run_all.py`` and its eight wrappers)
against the JAX package's, in float64 on the CPU.

The problems' f, g and exact solutions are held to ``tests/problems.py``'s
at 1e-12 on the same W (both packages' ``PrecomputedBrownian`` of one
entropy draw the same path, to the rounding of ``erfinv``);
``inspect_orders`` to the JAX harness's MSEs and slopes at rtol 1e-9 on a
short ladder; ``check_bands`` to the JAX package's verdicts."""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import problems as jproblems
import torchsde_tpu as jtsde
from diagnostics import harness as jharness
from diagnostics import run_all as jrun_all
from torchsde_tpu_torch.brownian.precomputed import PrecomputedBrownian
from torchsde_tpu_torch.diagnostics import harness, inspection, run_all
from torchsde_tpu_torch.diagnostics import problems


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the tier-1 run's workers share the
    CPU, and oversubscribed threads slow these eager loops several times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

B, D, M = 16, 3, 5
T0, T1, N_FINE, ENTROPY = 0.0, 2.0, 64, 11
PROBLEM_TOL = 1e-12
ORDER_RTOL = 1e-9


def _pair(name, sde_type):
    """The JAX problem and the port's, and their noise width."""
    if name in ("ExAdditive", "NeuralGeneral"):
        return (getattr(jproblems, name)(d=D, m=M, sde_type=sde_type),
                getattr(problems, name)(d=D, m=M, sde_type=sde_type,
                                        device="cpu"), M)
    m = 1 if name == "ExScalar" else D
    return (getattr(jproblems, name)(d=D, sde_type=sde_type),
            getattr(problems, name)(d=D, sde_type=sde_type, device="cpu"), m)


def _close(got, want, tol=PROBLEM_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


NAMES = ("ExDiagonal", "ExScalar", "ExAdditive", "NeuralGeneral")


@pytest.mark.parametrize("sde_type", ["ito", "stratonovich"])
@pytest.mark.parametrize("name", NAMES)
def test_problem_f_and_g_match_the_jax_problem(name, sde_type):
    jp, tp, _ = _pair(name, sde_type)
    y = np.random.default_rng(0).uniform(-1, 1, (B, D))
    for t in (0.0, 0.7, 1.9):
        _close(tp.f(t, torch.as_tensor(y)), jp.f(t, jnp.asarray(y)))
        _close(tp.g(t, torch.as_tensor(y)), jp.g(t, jnp.asarray(y)))
    assert tp.noise_type == jp.noise_type and tp.sde_type == jp.sde_type


@pytest.mark.parametrize("name", ["ExDiagonal", "ExScalar", "ExAdditive"])
def test_analytical_sample_matches_the_jax_problem(name):
    jp, tp, m = _pair(name, "ito")
    y0 = np.full((B, D), 0.1)
    ts = [T0, 0.5, 1.25, T1]
    kw = dict(t0=T0, t1=T1, size=(B, m), n=N_FINE, dtype=jnp.float64,
              entropy=ENTROPY)
    jbm = jtsde.PrecomputedBrownian(**kw)
    tbm = PrecomputedBrownian(**dict(kw, dtype=torch.float64), device="cpu")
    _close(tbm(0.0, 1.25), jbm(0.0, 1.25))
    _close(tp.analytical_sample(torch.as_tensor(y0), ts, tbm),
           jp.analytical_sample(jnp.asarray(y0), ts, jbm))


def test_given_parameters_replace_the_draws():
    mu, sigma = torch.tensor([-0.5, -0.2]), torch.tensor([0.3, 0.4])
    sde = problems.ExDiagonal(2, mu=mu, sigma=sigma, dtype=torch.float32,
                              device="cpu")
    assert torch.equal(sde.mu, mu) and torch.equal(sde.sigma, sigma)
    assert not any(b.requires_grad for b in sde.buffers())


ORDER_CASES = {
    "ito_diagonal": ("ExDiagonal", "ito", ("milstein", "srk"),
                     (None, None)),
    "stratonovich_general": ("NeuralGeneral", "stratonovich",
                             ("midpoint",), (None,)),
}


@pytest.mark.parametrize("combo", sorted(ORDER_CASES))
def test_inspect_orders_matches_the_jax_harness(combo):
    name, sde_type, methods, options = ORDER_CASES[combo]
    jp, tp, m = _pair(name, sde_type)
    dts = (2.0 ** -1, 2.0 ** -2, 2.0 ** -3)
    y0 = np.full((128, D), 0.1)
    kw = dict(noise_size=m, dt_true=2.0 ** -7, entropy=ENTROPY)
    want = jharness.inspect_orders(jp, jnp.asarray(y0), T0, T1, dts,
                                   methods, options, **kw)
    got = harness.inspect_orders(tp, torch.as_tensor(y0), T0, T1, dts,
                                 methods, options, **kw)
    assert set(got) == set(want)
    for label in methods:
        for key in ("mses", "maes", "strong_order", "weak_order"):
            np.testing.assert_allclose(got[label][key], want[label][key],
                                       rtol=ORDER_RTOL, err_msg=key)


def test_order_bands_and_check_bands_match_the_jax_package():
    assert run_all.ORDER_BANDS == jrun_all.ORDER_BANDS
    results = {combo: {label: {"strong_order": band[0] + 0.1,
                               "weak_order": band[1] + 0.1}
                       for label, band in methods.items()}
               for combo, methods in jrun_all.ORDER_BANDS.items()}
    assert run_all.check_bands(results) == jrun_all.check_bands(results) \
        == []
    bad = copy.deepcopy(results)
    bad["ito_diagonal"]["milstein"]["strong_order"] = 0.5
    bad["stratonovich_additive"]["heun"]["weak_order"] = -1.0
    bad["ito_general"]["unbanded"] = {"strong_order": -9.0,
                                      "weak_order": -9.0}
    bad["other_combo"] = {"euler": {"strong_order": -9.0,
                                    "weak_order": -9.0}}
    want = jrun_all.check_bands(bad)
    assert run_all.check_bands(bad) == want and len(want) == 2


def test_run_all_writes_strict_json_and_exits_on_a_violation(tmp_path,
                                                             monkeypatch):
    path = tmp_path / "orders.json"
    argv = ["--cpu", "--batch", "32", "--dt-true", str(2.0 ** -7),
            "--only", "ito_additive", "--json", str(path)]
    results = run_all.main(argv + ["--no-check"])
    saved = json.loads(path.read_text(), parse_constant=lambda c: 1 / 0)
    assert saved == json.loads(json.dumps(results))
    assert set(saved) == {"ito_additive"}
    assert set(saved["ito_additive"]) == set(
        run_all.ORDER_BANDS["ito_additive"])
    monkeypatch.setitem(run_all.ORDER_BANDS, "ito_additive",
                        {"euler": (9.0, 9.0)})
    with pytest.raises(SystemExit) as e:
        run_all.main(argv)
    assert e.value.code == 1


WRAPPERS = tuple(run_all.COMBOS)


@pytest.mark.parametrize("combo", WRAPPERS)
def test_wrapper_runs_its_one_combination(combo):
    import importlib
    module = importlib.import_module(
        f"torchsde_tpu_torch.diagnostics.{combo}")
    results = module.main(["--cpu", "--batch", "8", "--d", "2", "--m", "2",
                           "--dt-true", str(2.0 ** -8), "--no-check"])
    assert list(results) == [combo]
    for r in results[combo].values():
        assert np.isfinite(r["strong_order"]) and np.isfinite(
            r["weak_order"])


def test_run_all_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_all.main(["--batch", "8", "--only", "ito_scalar"])


def test_inspect_samples_solves_every_method_on_one_path(tmp_path):
    _, tp, m = _pair("ExDiagonal", "ito")
    y0 = torch.full((4, D), 0.1, dtype=torch.float64)
    ts = [0.0, 0.5, 1.0]
    out = inspection.inspect_samples(tp, y0, ts, 0.25, ("euler",
                                                        "milstein"),
                                     noise_size=m, dt_true=2.0 ** -6,
                                     img_dir=tmp_path / "img")
    assert list(out) == ["euler", "milstein", "true"]
    assert all(v.shape == (3, 4, D) for v in out.values())
    again = inspection.inspect_samples(tp, y0, ts, 0.25, ("euler",),
                                       noise_size=m, dt_true=2.0 ** -6)
    np.testing.assert_array_equal(again["euler"], out["euler"])
