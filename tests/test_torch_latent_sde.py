"""The port's latent-SDE slice against torchsde_tpu: the ELBO and its
parameter gradients on both routes, posterior and prior sampling, the fused
route's guards, and the entry points' default device.

JAX's random draws are made on the JAX side and handed to the port by
replacing its two draw sites (the eps draw and ``sample_grid_noise``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu.ops.latent_fused as JLF
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.models.latent_sde as TL
from port_bridge import (jax_named_arrays, perturbed, port_latent_sde,
                         to_torch)
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import latent_sde as JL
from torchsde_tpu_torch.utils.misc import resolve_device

B, DATA, L, C, H, T = 8, 3, 4, 8, 16, 6
DT = 1.0 / 32
TS = np.linspace(0.0, 1.0, T)
KEY = jax.random.PRNGKey(7)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    return perturbed(JL.LatentSDE(jax.random.PRNGKey(0), DATA, L, C, H,
                                  dtype=DTYPES[name][0]), seed=1)


def _xs(name):
    xs = np.random.default_rng(5).standard_normal((T, B, DATA))
    return xs.astype(np.dtype(DTYPES[name][0]))


def _inject_jax_draws(monkeypatch, name, channels, eps_shape=(B, L),
                      adjoint=False):
    """Make the port draw exactly what JAX draws from KEY: eps from KEY,
    then the grid noise from fold_in(KEY, 1): on the step grid, or with
    ``adjoint`` on the adjoint's interval grid, where the backward draws it
    again from a fresh generator and gets the same W."""
    jdtype = DTYPES[name][0]
    eps = jax.random.normal(KEY, eps_shape, jdtype)
    grid = (JI.build_interval_grid(TS, DT)[0] if adjoint
            else JI.build_step_grid(TS[0], TS[-1], DT))
    W = JI.sample_grid_noise(jax.random.fold_in(KEY, 1), grid,
                             (B, channels), jdtype)[0]
    order = []

    def standard_normal(shape, generator, dtype, device):
        assert tuple(shape) == eps_shape and not order
        order.append("eps")
        return to_torch(eps)

    def sample_grid_noise(generator, g, size, dtype, device=None, **kwargs):
        assert size == (B, channels) and np.array_equal(g, grid)
        assert order == ["eps"] or (adjoint and order == ["eps", "W"])
        order.append("W")
        return to_torch(W), None, None

    monkeypatch.setattr(TL, "_standard_normal", standard_normal)
    monkeypatch.setattr(TI, "sample_grid_noise", sample_grid_noise)
    return order


@functools.lru_cache(maxsize=None)
def _jax_loss(name, fused):
    loss, aux = jax.jit(lambda m, xs: JL.latent_sde_loss(
        m, xs, TS, KEY, dt=DT, fused=fused))(_jax_model(name),
                                             jnp.asarray(_xs(name)))
    return float(loss), float(aux["log_pxs"]), float(aux["logqp"])


@pytest.mark.parametrize("fused", [False, True])
def test_loss_matches_jax_f64(monkeypatch, fused):
    order = _inject_jax_draws(monkeypatch, "f64", L + 1)
    model = port_latent_sde(_jax_model("f64"), torch.float64)
    with torch.no_grad():
        loss, aux = TL.latent_sde_loss(model, to_torch(_xs("f64")), TS,
                                       dt=DT, fused=fused)
    assert order == ["eps", "W"]
    got = (float(loss), float(aux["log_pxs"]), float(aux["logqp"]))
    np.testing.assert_allclose(got, _jax_loss("f64", False), rtol=1e-9,
                               atol=1e-9)


def test_fused_loss_matches_jax_pallas_f32(monkeypatch):
    monkeypatch.setattr(JLF, "_INTERPRET", True)
    want = _jax_loss("f32", True)
    _inject_jax_draws(monkeypatch, "f32", L + 1)
    model = port_latent_sde(_jax_model("f32"), torch.float32)
    with torch.no_grad():
        loss, aux = TL.latent_sde_loss(model, to_torch(_xs("f32")), TS,
                                       dt=DT, fused=True)
    got = (float(loss), float(aux["log_pxs"]), float(aux["logqp"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_param_grads():
    grads = jax.grad(lambda m: JL.latent_sde_loss(
        m, jnp.asarray(_xs("f64")), TS, KEY, dt=DT)[0])(_jax_model("f64"))
    return jax_named_arrays(grads)


@pytest.mark.parametrize("fused", [False, True])
def test_parameter_gradients_match_jax_f64(monkeypatch, fused):
    """Every parameter gradient of the port's ELBO, on the sdeint route and
    on the fused route (FusedLatentSolve with the plain forward and backward
    on the CPU), against jax.grad of torchsde_tpu's loss on its sdeint route,
    in float64 on the same draws: atol 1e-9 times each gradient's largest
    entry."""
    want = _jax_param_grads()
    _inject_jax_draws(monkeypatch, "f64", L + 1)
    model = port_latent_sde(_jax_model("f64"), torch.float64)
    loss, _ = TL.latent_sde_loss(model, to_torch(_xs("f64")), TS, dt=DT,
                                 fused=fused)
    loss.backward()
    names = [name for name, _ in model.named_parameters()]
    assert len(names) == 28 and set(names) <= set(want)
    for name, p in model.named_parameters():
        scale = float(np.max(np.abs(want[name])))
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                   atol=1e-9 * scale, err_msg=name)


def test_loss_gradients_flow_on_cpu():
    """On the CPU both routes are differentiable (the fused one through
    FusedLatentSolve's plain versions) and give the same gradient."""
    model = port_latent_sde(_jax_model("f64"), torch.float64)
    grads = []
    for fused in (False, True):
        model.zero_grad()
        loss, _ = TL.latent_sde_loss(
            model, to_torch(_xs("f64")), TS,
            torch.Generator().manual_seed(3), dt=DT, fused=fused)
        loss.backward()
        grads.append(model.f_net.layers[0].w.grad.clone())
    assert torch.isfinite(grads[0]).all() and grads[0].abs().max() > 0
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-9, atol=1e-9)


def test_sample_posterior_matches_jax_f64(monkeypatch):
    jm = _jax_model("f64")
    want = JL.sample_posterior(jm, jnp.asarray(_xs("f64")), TS, KEY, dt=DT)
    _inject_jax_draws(monkeypatch, "f64", L)
    with torch.no_grad():
        got = TL.sample_posterior(port_latent_sde(jm, torch.float64),
                                  to_torch(_xs("f64")), TS, dt=DT)
    assert got.shape == (T, B, DATA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9)


def test_sample_prior_matches_jax_f64(monkeypatch):
    jm = _jax_model("f64")
    want = JL.sample_prior(jm, B, TS, KEY, dt=DT)
    _inject_jax_draws(monkeypatch, "f64", L)
    with torch.no_grad():
        got = TL.sample_prior(port_latent_sde(jm, torch.float64), B, TS,
                              dt=DT)
    assert got.shape == (T, B, DATA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9)


def test_same_generator_seed_gives_same_loss_on_both_routes():
    model = port_latent_sde(_jax_model("f64"), torch.float64)
    xs = to_torch(_xs("f64"))
    losses = []
    with torch.no_grad():
        for seed, fused in ((11, False), (11, True), (12, True)):
            loss, _ = TL.latent_sde_loss(
                model, xs, TS, torch.Generator().manual_seed(seed), dt=DT,
                fused=fused)
            losses.append(float(loss))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-12)
    assert losses[2] != losses[1]


@pytest.mark.parametrize("kwargs", [dict(adjoint=True),
                                    dict(method="milstein"),
                                    dict(options={"x": 1})])
def test_fused_guards(kwargs):
    model = port_latent_sde(_jax_model("f32"), torch.float32)
    with pytest.raises(ValueError, match="fused=True supports"):
        TL.latent_sde_loss(model, to_torch(_xs("f32")), TS, dt=DT,
                           fused=True, **kwargs)


def test_fused_rejects_variant_architecture():
    model = port_latent_sde(_jax_model("f32"), torch.float32)
    model.f_net.activation = "tanh"
    with pytest.raises(ValueError, match="3-layer softplus"):
        TL.latent_sde_loss(model, to_torch(_xs("f32")), TS, dt=DT,
                           fused=True)


@functools.lru_cache(maxsize=None)
def _jax_adjoint_loss_and_grads():
    (loss, aux), grads = jax.value_and_grad(
        lambda m: JL.latent_sde_loss(m, jnp.asarray(_xs("f64")), TS, KEY,
                                     dt=DT, adjoint=True),
        has_aux=True)(_jax_model("f64"))
    return ((float(loss), float(aux["log_pxs"]), float(aux["logqp"])),
            jax_named_arrays(grads))


def test_adjoint_loss_and_gradients_match_jax_f64(monkeypatch):
    """latent_sde_loss(adjoint=True): Euler forward on the interval grid,
    Milstein adjoint, against the JAX package's on the same draws: the
    loss and every parameter gradient, the encoder's (through the context
    the adjoint differentiates) and qz0_net's (through z0) included, at
    1e-9 of each gradient's largest entry."""
    want_loss, want = _jax_adjoint_loss_and_grads()
    order = _inject_jax_draws(monkeypatch, "f64", L + 1, adjoint=True)
    model = port_latent_sde(_jax_model("f64"), torch.float64)
    loss, aux = TL.latent_sde_loss(model, to_torch(_xs("f64")), TS, dt=DT,
                                   adjoint=True)
    np.testing.assert_allclose(
        (loss.item(), aux["log_pxs"].item(), aux["logqp"].item()),
        want_loss, rtol=1e-9, atol=1e-9)
    loss.backward()
    assert order == ["eps", "W", "W"]
    names = [name for name, _ in model.named_parameters()]
    assert len(names) == 28 and set(names) <= set(want)
    assert any(name.startswith("encoder.") for name in names)
    for name, p in model.named_parameters():
        scale = float(np.max(np.abs(want[name])))
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                   atol=1e-9 * scale, err_msg=name)


def test_make_lorenz_data():
    gen = torch.Generator().manual_seed(0)
    xs = TL.make_lorenz_data(16, np.linspace(0.0, 1.0, 5), generator=gen,
                             dt=1e-2, device="cpu")
    assert xs.shape == (5, 16, 3) and torch.isfinite(xs).all()
    # normalised per channel before the 0.01 observation noise
    torch.testing.assert_close(xs.mean(dim=(0, 1)), torch.zeros(3),
                               atol=0.02, rtol=0)
    torch.testing.assert_close(xs.std(dim=(0, 1)), torch.ones(3), atol=0.05,
                               rtol=0)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device given the entry points build on the CUDA card, and
    raise where there is none rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.LatentSDE(3, 4, 8, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.StochasticLorenz()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.make_lorenz_data(4, np.linspace(0.0, 1.0, 3))
    assert next(TL.LatentSDE(3, 4, 8, 16, device="cpu").parameters()).is_cpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
