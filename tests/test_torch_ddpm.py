"""The port's continuous DDPM (``models/unet.py``, ``models/cont_ddpm.py``)
against torchsde_tpu's, in float64 on carried-over weights.

Two small U-Nets (base 8; ``ch_mults (1, 2)`` at 8x8, and ``(1, 2, 4)`` at
12x12 for three levels as at full width), every JAX leaf moved off its
initial value, carried across by ``load_jax_params``
(``port_bridge.port_unet``, ``port_score_sde``). JAX's random draws reach
the port through its draw sites (``models/cont_ddpm._standard_normal``,
``_uniform``; ``core/integrate.sample_grid_noise`` for the reverse SDE's
noise, recorded from the JAX package's own call) or through
``loss_on_draws``.

Tolerances. The float64 rule is 1e-9 of each quantity's scale. The time
embedding is float32 in both packages, and XLA's ``exp``/``sin``/``cos``
differ from PyTorch's by up to an ulp there (a quarter to a third of the
entries): ``sinusoidal_embedding`` is held to 2 float32 epsilons of the
JAX package's (half an epsilon measured), and the network beyond it to
1e-9 given JAX's embedding (the port's is monkeypatched with it).
``denoise`` takes ``t`` in float32 too, so its variance and mean
coefficient are held to 2 float32 epsilons of scale. The closed-form
Tweedie tests keep ``tests/test_models.py``'s bounds, and
the bfloat16 U-Net (as ``tests/test_mixed_precision.py``'s) is held to
finite outputs of the dtype kept."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.models.cont_ddpm as TD
import torchsde_tpu_torch.models.unet as TU
from port_bridge import (jax_named_arrays, jax_unet, port_score_sde,
                         port_unet, to_torch)
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import cont_ddpm as JD
from torchsde_tpu.models import unet as JU
from torchsde_tpu_torch.utils.convert import load_jax_params

TOL = 1e-9
EMBED_EPS = 2 * float(np.finfo(np.float32).eps)
B = 3
CONFIGS = {"two_levels": ((1, 2), 8), "three_levels": ((1, 2, 4), 12)}


@functools.lru_cache(maxsize=None)
def _jax_unet(config):
    return jax_unet(CONFIGS[config][0])


def _size(config):
    return (1, CONFIGS[config][1], CONFIGS[config][1])


def _jax_sde(config):
    return JD.ScoreMatchingSDE(_jax_unet(config), input_size=_size(config))


def _images(config, seed=0, n=B):
    return np.random.default_rng(seed).standard_normal((n, *_size(config)))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * scale)


def _grads_close(got, want):
    """Each gradient within 1e-9 of its own largest entry, that scale
    floored at 1e-6 of the largest gradient's: group norms over single
    channels make some gradients zero in exact arithmetic (a bias or a
    time projection a norm takes out again), whose entries are rounding."""
    assert set(got) == set(want)
    top = max(float(np.max(np.abs(w))) for w in want.values())
    for name, w in want.items():
        scale = max(float(np.max(np.abs(w))), 1e-6 * top)
        np.testing.assert_allclose(got[name], w, rtol=0, atol=TOL * scale,
                                   err_msg=name)


@pytest.fixture
def jax_embedding(monkeypatch):
    """The port's U-Net on the JAX package's time embedding."""
    def embed(t, dim):
        return to_torch(JU.sinusoidal_embedding(jnp.asarray(t.numpy()), dim))
    monkeypatch.setattr(TU, "sinusoidal_embedding", embed)


def _port_grads(module, loss):
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, list(module.parameters()))
    return dict(zip(names, (g.numpy() for g in grads)))


# --------------------------------------------------------------------------- #
#  Weights and the time embedding                                             #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_load_jax_params_carries_the_unet(config):
    """Name for name, the None slots (the last ``downs``, the last ``ups``,
    a ResBlock without a skip convolution) holding no tensor on either
    side; a wrong shape or a missing name raises."""
    jnet = _jax_unet(config)
    arrays = jax_named_arrays(jnet)
    net = port_unet(jnet, torch.float64)
    levels = len(CONFIGS[config][0])
    assert net.downs[levels - 1] is None and net.ups[levels - 1] is None
    assert net.mid_block1.skip is None
    assert set(dict(net.named_parameters())) == set(arrays)
    for name, p in net.named_parameters():
        assert np.array_equal(p.detach().numpy(), arrays[name]), name
    sde = port_score_sde(_jax_sde(config), torch.float64)
    assert set(dict(sde.named_parameters())) == {
        f"denoiser.{n}" for n in arrays}
    bad = dict(arrays)
    bad["conv_in.w"] = np.transpose(bad["conv_in.w"], (3, 2, 0, 1))
    with pytest.raises(ValueError, match="conv_in.w"):
        load_jax_params(net, bad)
    del bad["conv_in.w"]
    with pytest.raises(KeyError, match="conv_in.w"):
        load_jax_params(net, bad)


@pytest.mark.parametrize("dim", [8, 64])
def test_sinusoidal_embedding_within_float32_ulps(dim):
    t = np.random.default_rng(dim).random(256).astype(np.float32)
    got = TU.sinusoidal_embedding(torch.as_tensor(t), dim)
    assert got.dtype == torch.float32 and got.shape == (256, dim)
    with jax.enable_x64(False):
        want = np.asarray(JU.sinusoidal_embedding(jnp.asarray(t), dim))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EMBED_EPS)


# --------------------------------------------------------------------------- #
#  The U-Net                                                                  #
# --------------------------------------------------------------------------- #

@jax.jit
def _jax_forward_vjp(net, t, x, cot):
    out, vjp = jax.vjp(lambda n: n(t, x), net)
    return out, vjp(cot)[0]


# Each case compiles the JAX network's gradient once (about 5 s).
@pytest.mark.parametrize("config,layout", [("three_levels", "nchw"),
                                           ("two_levels", "nhwc")])
def test_unet_forward_and_gradients_match_jax(config, layout, jax_embedding):
    jnet = _jax_unet(config)
    x = _images(config)
    if layout == "nhwc":
        x = np.transpose(x, (0, 2, 3, 1))
    t = np.random.default_rng(1).random(B)
    cot = np.random.default_rng(2).standard_normal(x.shape)
    jout, jgrads = _jax_forward_vjp(jnet, jnp.asarray(t), jnp.asarray(x),
                                    jnp.asarray(cot))
    jgrads = jax_named_arrays(jgrads)
    net = port_unet(jnet, torch.float64)
    out = net(torch.as_tensor(t), torch.as_tensor(x))
    _close(out, jout)
    _grads_close(_port_grads(net, (out * torch.as_tensor(cot)).sum()), jgrads)


# --------------------------------------------------------------------------- #
#  ScoreMatchingSDE                                                           #
# --------------------------------------------------------------------------- #

def _loss_draws(config, key, partitions):
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, (B, partitions), jnp.float64)
    z = jax.random.normal(k2, (B * partitions, *_size(config)), jnp.float64)
    return np.array(u), np.array(z)


@functools.partial(jax.jit, static_argnums=3)
def _jax_loss_vjp(sde, key, x, partitions):
    vals, vjp = jax.vjp(lambda s: s.loss(key, x, partitions), sde)
    return vals, vjp(jnp.full_like(vals, 1.0 / vals.shape[0]))[0]


@pytest.mark.parametrize("config,partitions", [("two_levels", 2)])
def test_loss_and_gradients_match_jax(config, partitions, jax_embedding,
                                      monkeypatch):
    """The per-example loss on the JAX package's draws, stratified over two
    partitions, and the gradients of its mean (one case: each compiles
    the JAX loss's gradient, about 7 s)."""
    key = jax.random.PRNGKey(11)
    x = _images(config, seed=3)
    jsde = _jax_sde(config)
    jvals, jgrads = _jax_loss_vjp(jsde, key, jnp.asarray(x), partitions)
    jgrads = jax_named_arrays(jgrads)
    sde = port_score_sde(jsde, torch.float64)
    u, z = _loss_draws(config, key, partitions)
    vals = sde.loss_on_draws(torch.as_tensor(x), torch.as_tensor(u),
                             torch.as_tensor(z))
    _close(vals, jvals)
    _grads_close(_port_grads(sde, vals.mean()), jgrads)

    # loss() draws u, then z, and hands them to loss_on_draws.
    caller = torch.Generator()
    order = []

    def uniform(shape, generator, dtype, device):
        assert generator is caller and shape == u.shape and order == []
        order.append("u")
        return torch.as_tensor(u)

    def normal(shape, generator, dtype, device):
        assert generator is caller and shape == z.shape and order == ["u"]
        order.append("z")
        return torch.as_tensor(z)

    monkeypatch.setattr(TD, "_uniform", uniform)
    monkeypatch.setattr(TD, "_standard_normal", normal)
    with torch.no_grad():
        again = sde.loss(caller, torch.as_tensor(x), partitions)
    assert order == ["u", "z"] and torch.equal(again, vals.detach())


def test_forward_sde_and_marginal_match_jax():
    config = "two_levels"
    jsde = _jax_sde(config)
    sde = port_score_sde(jsde, torch.float64)
    y = np.random.default_rng(4).standard_normal((B, 64))
    for t in (0.0, 0.37, 1.0):
        _close(sde.f(torch.tensor(t, dtype=torch.float64),
                     torch.as_tensor(y)),
               jsde.f(jnp.asarray(t), jnp.asarray(y)))
        _close(sde.g(torch.tensor(t, dtype=torch.float64),
                     torch.as_tensor(y)),
               jsde.g(jnp.asarray(t), jnp.asarray(y)))
    ts = np.array([0.05, 0.5, 0.9])
    x = _images(config, seed=6)
    _close(sde.analytical_mean(torch.as_tensor(ts), torch.as_tensor(x)),
           jsde.analytical_mean(jnp.asarray(ts), jnp.asarray(x)))
    _close(sde.analytical_var(torch.as_tensor(ts)),
           jsde.analytical_var(jnp.asarray(ts)))
    key = jax.random.PRNGKey(2)
    z = jax.random.normal(key, x.shape, jnp.float64)
    x_t = sde.analytical_sample_on(torch.as_tensor(ts), torch.as_tensor(x),
                                   to_torch(z))
    _close(x_t, jsde.analytical_sample(key, jnp.asarray(ts), jnp.asarray(x)))
    _close(sde.analytical_score(x_t, torch.as_tensor(ts), torch.as_tensor(x)),
           jsde.analytical_score(jnp.asarray(x_t.numpy()), jnp.asarray(ts),
                                 jnp.asarray(x)))


# --------------------------------------------------------------------------- #
#  The samplers                                                               #
# --------------------------------------------------------------------------- #

SAMPLE_DT = 0.25


@pytest.mark.parametrize("denoise_t,tweedie", [(None, True), (None, False),
                                               (0.05, True)],
                         ids=["tweedie", "raw", "denoise_t"])
def test_sde_sample_matches_jax(denoise_t, tweedie, jax_embedding,
                                monkeypatch):
    """The reverse SDE by midpoint ``sdeint`` on the JAX package's t1
    marginal and Brownian increments, three output times."""
    config = "two_levels"
    jsde = _jax_sde(config)
    key = jax.random.PRNGKey(21)
    recorded = {}
    jax_draw = JI.sample_grid_noise

    def record(*args, **kwargs):
        out = jax_draw(*args, **kwargs)
        recorded["grid"], recorded["W"] = np.asarray(args[1]), out[0]
        return out

    monkeypatch.setattr(JI, "sample_grid_noise", record)
    kw = dict(batch_size=B, dt=SAMPLE_DT, t_size=3,
              tweedie_correction=tweedie, denoise_t=denoise_t)
    want = JD.ReverseDiffeqWrapper(jsde).sde_sample(key, **kw)
    y1 = jax.random.normal(jax.random.split(key)[0], (B, *_size(config)),
                           jnp.float64)

    caller = torch.Generator()

    def normal(shape, generator, dtype, device):
        assert generator is caller and tuple(shape) == y1.shape
        return to_torch(y1)

    def grid_noise(generator, grid, size, dtype, device=None, **kwargs):
        assert generator is caller
        assert np.array_equal(grid, recorded["grid"])
        return to_torch(recorded["W"]), None, None

    monkeypatch.setattr(TD, "_standard_normal", normal)
    monkeypatch.setattr(TI, "sample_grid_noise", grid_noise)
    rev = TD.ReverseDiffeqWrapper(port_score_sde(jsde, torch.float64))
    with torch.no_grad():
        got = rev.sde_sample(caller, **kw)
    _close(got, want)


def test_ode_sample_and_denoise_match_jax(jax_embedding):
    """The probability-flow sampler at 1e-9; ``denoise`` at 2 float32
    epsilons of scale: its variance and mean coefficient are float32 (``t``
    is, as in the JAX package), and XLA's float32 ``exp`` is an ulp from
    PyTorch's at some times (t = 0.4 here)."""
    config = "two_levels"
    jrev = JD.ReverseDiffeqWrapper(_jax_sde(config))
    rev = TD.ReverseDiffeqWrapper(port_score_sde(_jax_sde(config),
                                                 torch.float64))
    y = _images(config, seed=8)
    with torch.no_grad():
        _close(rev.ode_sample(y=torch.as_tensor(y), dt=SAMPLE_DT),
               jrev.ode_sample(y=jnp.asarray(y), dt=SAMPLE_DT))
        for t in (0.05, 0.4):
            _close(rev.denoise(t, torch.as_tensor(y)),
                   jrev.denoise(t, jnp.asarray(y)), tol=EMBED_EPS)
        _close(rev.tweedie_correction(0.0, torch.as_tensor(y), SAMPLE_DT),
               jrev.tweedie_correction(0.0, jnp.asarray(y), SAMPLE_DT))


# --------------------------------------------------------------------------- #
#  Closed form: Tweedie on an oracle score (tests/test_models.py:147-222)     #
# --------------------------------------------------------------------------- #

class OracleScore(nn.Module):
    """The exact score of the VP-SDE marginal of a point mass at ``x0``:
    ``-(x - mean_coeff(t) x0) / var(t)``, at the default beta schedule."""

    beta_min, beta_max = 0.1, 20.0

    def __init__(self, x0):
        super().__init__()
        self.register_buffer("x0", x0)

    def forward(self, t, x):
        ind = (self.beta_min * t[0]
               + 0.5 * t[0] ** 2 * (self.beta_max - self.beta_min))
        coeff, var = torch.exp(-0.5 * ind), 1.0 - torch.exp(-ind)
        return -(x - coeff * self.x0[None]) / torch.clamp_min(var, 1e-12)


def _oracle(seed):
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.rand((1, 4, 4), generator=gen, dtype=torch.float64) * 2 - 1
    sde = TD.ScoreMatchingSDE(OracleScore(x0), input_size=(1, 4, 4))
    return x0, sde, TD.ReverseDiffeqWrapper(sde), gen


def test_tweedie_denoise_recovers_point_mass():
    x0, sde, rev, gen = _oracle(0)
    for t in (0.03, 0.1, 0.5, 0.9):
        x_t = sde.analytical_sample(gen, torch.full((8,), t,
                                                    dtype=torch.float64),
                                    x0.expand(8, 1, 4, 4))
        x0_hat = rev.denoise(t, x_t)
        np.testing.assert_allclose(x0_hat.numpy(),
                                   x0.expand_as(x0_hat).numpy(), rtol=0,
                                   atol=1e-8)


def test_sde_sample_denoise_t_plumbing():
    x0, _, rev, gen = _oracle(3)
    with torch.no_grad():
        samp = rev.sde_sample_final(gen, batch_size=16, dt=5e-3,
                                    denoise_t=0.05)
        assert samp.shape == (16, 1, 4, 4)
        err = float((samp - x0[None]).abs().max())
        assert err < 0.12, err
        raw = rev.sde_sample(gen, batch_size=16, dt=5e-3, denoise_t=None,
                             tweedie_correction=False)
        assert float((rev.denoise(0.05, raw[-1]) - x0[None]).abs().max()) \
            < 0.2


# --------------------------------------------------------------------------- #
#  bfloat16 (tests/test_mixed_precision.py::test_ddpm_bf16_loss_and_samplers) #
# --------------------------------------------------------------------------- #

def test_bf16_unet_trains_and_samples():
    gen = torch.Generator().manual_seed(0)
    net = TU.UNet(1, 8, (1, 2), dtype=torch.bfloat16, device="cpu",
                  generator=gen)
    sde = TD.ScoreMatchingSDE(net, input_size=(1, 8, 8))
    x = torch.zeros((2, 1, 8, 8), dtype=torch.bfloat16)
    loss = sde.loss(gen, x).mean()
    assert torch.isfinite(loss.float())
    loss.backward()
    assert all(p.grad.dtype == torch.bfloat16 for p in net.parameters())
    rev = TD.ReverseDiffeqWrapper(sde)
    with torch.no_grad():
        samples = (rev.sde_sample_final(gen, batch_size=2, dt=0.5),
                   rev.ode_sample(batch_size=2, dt=0.5, generator=gen))
    for s in samples:
        assert s.dtype == torch.bfloat16 and s.shape == (2, 1, 8, 8)
        assert bool(torch.isfinite(s.float()).all())
