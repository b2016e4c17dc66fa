"""The port's SDE-GAN slice against torchsde_tpu: reversible-Heun sdeint,
the generator's paths and the critic's scores on both routes, gan_loss and
its gradients, the OU dataset and its NaN filling, weight clipping, the
weights' transfer, and the entry points' default device.

JAX's random draws are made on the JAX side and handed to the port by
replacing its draw sites (``models/sde_gan._standard_normal`` and
``core/integrate.sample_grid_noise``; ``_uniform`` and ``_bernoulli`` for the
dataset). All comparisons run in float64 at 1e-9 of scale."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu as jtsde
import torchsde_tpu_torch as ttsde
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.models.sde_gan as TG
from port_bridge import (CDE_PATH_KEYS, jax_named_arrays, port_discriminator,
                         port_generator, to_torch)
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import sde_gan as JG

B, T = 8, 6
TS = np.linspace(0.0, T - 1, T)
DT = 1.0
DATA, INIT_NOISE, NOISE, HIDDEN, MLP = 1, 5, 3, 16, 16
KEY = jax.random.PRNGKey(7)
GRID = JI.build_step_grid(TS[0], TS[-1], DT)
RTOL = ATOL = 1e-9


@functools.lru_cache(maxsize=None)
def _jax_models():
    gen = JG.Generator(jax.random.PRNGKey(2), DATA, INIT_NOISE, NOISE, HIDDEN,
                       MLP, 1, dtype=jnp.float64, init_mult1=3.0,
                       init_mult2=0.5)
    disc = JG.Discriminator(jax.random.PRNGKey(3), DATA, HIDDEN, MLP, 1,
                            dtype=jnp.float64)
    return gen, disc


@functools.lru_cache(maxsize=None)
def _real():
    _, data = JG.get_ou_data(jax.random.PRNGKey(1), B, T)
    return np.asarray(data, np.float64)


def _ported():
    gen, disc = _jax_models()
    return (port_generator(gen, torch.float64),
            port_discriminator(disc, torch.float64))


def _inject_jax_draws(monkeypatch, key=KEY):
    """Make the port draw what JAX's Generator draws from ``key``: the
    initial noise from split(key)[0], then the grid noise from split(key)[1].
    A critic solve on the sdeint route draws its own (B', 1) noise from a
    private generator, never the caller's; it gets zeros (its diffusion is
    zero). The backward of ``sdeint_adjoint`` draws the grid noise again
    from a fresh generator in the caller's state at the first draw; it gets
    the same W."""
    k1, k2 = jax.random.split(key)
    init = jax.random.normal(k1, (B, INIT_NOISE), jnp.float64)
    W = JI.sample_grid_noise(k2, GRID, (B, NOISE), jnp.float64)[0]
    caller = torch.Generator()
    order = []
    drawn_in = []

    def standard_normal(shape, generator, dtype, device):
        assert tuple(shape) == (B, INIT_NOISE) and generator is caller
        order.append("init")
        return to_torch(init)

    def sample_grid_noise(generator, grid, size, dtype, device=None,
                          **kwargs):
        assert np.array_equal(grid, GRID)
        if size == (B, NOISE):
            if generator is caller:
                assert order == ["init"]
                drawn_in.append(caller.get_state())
                order.append("W")
            else:
                assert torch.equal(generator.get_state(), drawn_in[0])
                order.append("W again")
            return to_torch(W), None, None
        assert size[1] == 1 and generator not in (caller, None)
        order.append("critic")
        return torch.zeros((len(grid) - 1, *size), dtype=dtype), None, None

    monkeypatch.setattr(TG, "_standard_normal", standard_normal)
    monkeypatch.setattr(TI, "sample_grid_noise", sample_grid_noise)
    return caller, order


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL * scale)


# --------------------------------------------------------------------------- #
#  Reversible-Heun sdeint                                                      #
# --------------------------------------------------------------------------- #

D, M_NOISE = 3, 2


def _sde_params():
    rng = np.random.default_rng(0)
    return dict(theta=rng.uniform(0.5, 1.5, D), G=rng.normal(size=(D, M_NOISE)),
                G0=rng.normal(size=(D, M_NOISE)))


class JaxStrat(jtsde.SDEStratonovich):
    def __init__(self, noise_type, p):
        super().__init__(noise_type=noise_type)
        self.theta = jnp.asarray(p["theta"])
        self.G = jnp.asarray(p["G"])
        self.G0 = jnp.asarray(p["G0"])

    def f(self, t, y):
        return -self.theta * y + jnp.sin(t) * jnp.cos(y)

    def g(self, t, y):
        if self.noise_type == "additive":
            return jnp.broadcast_to(self.G0 * jnp.cos(t), y.shape + (M_NOISE,))
        return jnp.tanh(y)[..., None] * self.G + self.G0


class TorchStrat(ttsde.SDEStratonovich):
    def __init__(self, noise_type, p):
        super().__init__(noise_type=noise_type)
        self.theta = torch.as_tensor(p["theta"])
        self.G = torch.as_tensor(p["G"])
        self.G0 = torch.as_tensor(p["G0"])

    def f(self, t, y):
        return -self.theta * y + torch.sin(t) * torch.cos(y)

    def g(self, t, y):
        if self.noise_type == "additive":
            return (self.G0 * torch.cos(t)).expand(y.shape + (M_NOISE,))
        return torch.tanh(y)[..., None] * self.G + self.G0


@pytest.mark.parametrize("noise_type", ["general", "additive"])
def test_sdeint_reversible_heun_matches_jax_f64(monkeypatch, noise_type):
    p = _sde_params()
    ts = np.linspace(0.0, 0.5, 5)
    dt = 0.05
    grid = JI.build_step_grid(ts[0], ts[-1], dt)
    y0 = np.random.default_rng(1).normal(size=(B, D))
    key = jax.random.PRNGKey(4)
    want, (f_w, g_w, z_w) = jtsde.sdeint(
        JaxStrat(noise_type, p), jnp.asarray(y0), ts,
        method="reversible_heun", dt=dt, key=key, extra=True)
    W = JI.sample_grid_noise(key, grid, (B, M_NOISE), jnp.float64)[0]

    def draw(generator, g, size, dtype, device=None, **kwargs):
        assert size == (B, M_NOISE) and np.array_equal(g, grid)
        return to_torch(W), None, None

    monkeypatch.setattr(TI, "sample_grid_noise", draw)
    got, (f_t, g_t, z_t) = ttsde.sdeint(
        TorchStrat(noise_type, p), torch.as_tensor(y0), ts,
        method="reversible_heun", dt=dt, extra=True)
    for g, w in ((got, want), (f_t, f_w), (g_t, g_w), (z_t, z_w)):
        _close(g, w)


def test_reversible_heun_is_registered_for_stratonovich():
    from torchsde_tpu_torch.core import solvers
    cls = solvers.select("reversible_heun", "stratonovich")
    assert cls is solvers.ReversibleHeun
    sde = TorchStrat("additive", _sde_params())
    assert cls(sde).strong_order == 1.0
    assert cls(TorchStrat("general", _sde_params())).strong_order == 0.5
    ito = TorchStrat("general", _sde_params())
    ito.sde_type = "ito"
    with pytest.raises(ValueError, match="solver is for type stratonovich"):
        ttsde.sdeint(ito, torch.ones((B, D), dtype=torch.float64), TS,
                     method="reversible_heun", dt=DT)


# --------------------------------------------------------------------------- #
#  Generator, critic, gan_loss                                                 #
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _jax_paths():
    gen, _ = _jax_models()
    return np.asarray(gen(KEY, TS, B, dt=DT, adjoint=False))


@pytest.mark.parametrize("fused", [False, True])
def test_generator_paths_match_jax_f64(monkeypatch, fused):
    caller, order = _inject_jax_draws(monkeypatch)
    gen, _ = _ported()
    with torch.no_grad():
        got = gen(caller, TS, B, dt=DT, adjoint=False, fused=fused)
    assert order == ["init", "W"]
    _close(got, _jax_paths())


@pytest.mark.parametrize("fused", [False, True])
def test_scores_match_jax_f64(fused):
    _, jdisc = _jax_models()
    paths = np.concatenate([_jax_paths(), _real()], axis=0)
    want = jdisc.scores(TS, jnp.asarray(paths), dt=DT, adjoint=False)
    _, disc = _ported()
    with torch.no_grad():
        got = disc.scores(TS, to_torch(paths), dt=DT, adjoint=False,
                          fused=fused)
        mean = disc(TS, to_torch(paths), dt=DT, adjoint=False)
    assert got.shape == (2 * B,)
    _close(got, want)
    _close(mean, jnp.mean(want))


@functools.lru_cache(maxsize=None)
def _jax_gan_grads(adjoint=False):
    gen, disc = _jax_models()
    real = jnp.asarray(_real())
    loss, g_gen, g_disc = jax.jit(lambda g, d: JG.gan_grads(
        g, d, KEY, TS, real, DT, adjoint, False))(gen, disc)
    return float(loss), jax_named_arrays(g_gen), jax_named_arrays(g_disc)


# (fused, adjoint): the fused route does not consult adjoint.
ROUTES = [(False, False), (True, False), (False, True), (True, True)]
ROUTE_IDS = ["sdeint", "fused", "adjoint", "fused-adjoint"]


@pytest.mark.parametrize("fused,adjoint", ROUTES, ids=ROUTE_IDS)
def test_gan_loss_matches_jax_f64(monkeypatch, fused, adjoint):
    caller, order = _inject_jax_draws(monkeypatch)
    gen, disc = _ported()
    with torch.no_grad():
        loss = TG.gan_loss(gen, disc, caller, TS, to_torch(_real()), dt=DT,
                           adjoint=adjoint, fused=fused)
    assert order == (["init", "W"] if fused else ["init", "W", "critic"])
    np.testing.assert_allclose(float(loss), _jax_gan_grads(adjoint)[0],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("fused,adjoint", ROUTES, ids=ROUTE_IDS)
def test_gan_grads_match_jax_f64(monkeypatch, fused, adjoint):
    """Every parameter gradient of gan_loss, by autograd through the sdeint
    route, through ``sdeint_adjoint``'s reversible-Heun pair (whose critic
    passes the generator's gradient on through the path it holds), or
    through the plain versions of the kernels, against jax.grad of
    torchsde_tpu's loss on its sdeint route with the same ``adjoint`` (the
    generator's negated on both sides): atol 1e-9 times each gradient's
    largest entry. The adjoint's backward draws the generator's noise
    again, from the caller's state at the first draw."""
    want_loss, want_gen, want_disc = _jax_gan_grads(adjoint)
    caller, order = _inject_jax_draws(monkeypatch)
    gen, disc = _ported()
    loss, g_gen, g_disc = TG.gan_grads(gen, disc, caller, TS,
                                       to_torch(_real()), dt=DT,
                                       adjoint=adjoint, fused=fused)
    if adjoint and not fused:
        assert order == ["init", "W", "critic", "critic", "W again"]
    np.testing.assert_allclose(float(loss), want_loss, rtol=0, atol=ATOL)
    for got, want in ((g_gen, want_gen), (g_disc, want_disc)):
        assert set(got) == set(want) - set(CDE_PATH_KEYS)
        for name, g in got.items():
            scale = float(np.max(np.abs(want[name])))
            # The critic's readout bias adds the same to both means.
            assert scale > 0 or (got is g_disc and name == "readout.b")
            np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                       atol=1e-9 * max(scale, 1e-3),
                                       err_msg=name)


def test_critic_never_draws_from_the_callers_generator():
    """One generator seed gives the same loss on both routes, and leaves
    the generator in the same state: the sdeint route's critic solve draws
    from its own generator, and not from PyTorch's default one either."""
    gen, disc = _ported()
    real = to_torch(_real())
    losses, states = [], []
    default_state = torch.get_rng_state()
    with torch.no_grad():
        for fused in (False, True):
            caller = torch.Generator().manual_seed(11)
            losses.append(float(TG.gan_loss(gen, disc, caller, TS, real,
                                            dt=DT, adjoint=False,
                                            fused=fused)))
            states.append(caller.get_state())
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-12, atol=1e-12)
    assert torch.equal(states[0], states[1])
    assert torch.equal(torch.get_rng_state(), default_state)


def test_adjoint_is_the_default_and_agrees_with_backprop():
    """gan_loss, gan_grads and the critic's scores run at their default
    adjoint=True; the reversible pair's loss and gradients are backprop's
    through sdeint on one generator seed (both exact for the same discrete
    solve), and the caller's generator ends in the same state."""
    gen, disc = _ported()
    real = to_torch(_real())
    out, states = {}, {}
    for adjoint in (True, False):
        caller = torch.Generator().manual_seed(11)
        kw = {} if adjoint else dict(adjoint=False)
        out[adjoint] = TG.gan_grads(gen, disc, caller, TS, real, dt=DT, **kw)
        states[adjoint] = caller.get_state()
    assert torch.equal(states[True], states[False])
    np.testing.assert_allclose(float(out[True][0]), float(out[False][0]),
                               rtol=0, atol=ATOL)
    for i in (1, 2):
        for name, g in out[False][i].items():
            scale = max(float(g.abs().max()), 1e-3)
            np.testing.assert_allclose(out[True][i][name].numpy(), g.numpy(),
                                       rtol=0, atol=1e-9 * scale,
                                       err_msg=name)
    with torch.no_grad():
        torch.testing.assert_close(disc.scores(TS, real, dt=DT),
                                   disc.scores(TS, real, dt=DT,
                                               adjoint=False),
                                   rtol=0, atol=ATOL)


def test_clip_weights_matches_jax():
    _, jdisc = _jax_models()
    want = jax_named_arrays(jdisc.clip_weights())
    _, disc = _ported()
    assert disc.clip_weights() is disc
    for name, p in disc.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name])
    assert float(disc.readout.w.detach().abs().max()) <= 1.0


def test_every_jax_leaf_maps_to_one_port_tensor():
    """Each JAX leaf of both modules maps to exactly one port tensor, except
    the critic's control path, which the port keeps out of the module."""
    for jax_module, port in zip(_jax_models(), _ported()):
        arrays = jax_named_arrays(jax_module)
        assert len(arrays) == len(jax.tree_util.tree_leaves(jax_module))
        tensors = dict(port.named_parameters()) | dict(port.named_buffers())
        assert set(tensors) == set(arrays) - set(CDE_PATH_KEYS)
        for name, t in tensors.items():
            np.testing.assert_array_equal(t.detach().numpy(), arrays[name])


# --------------------------------------------------------------------------- #
#  OU data                                                                     #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("drop_frac", [0.0, 0.3])
def test_get_ou_data_matches_jax_f64(monkeypatch, drop_frac):
    n, t_size, dt = 16, 7, 0.25
    key = jax.random.PRNGKey(9)
    ts_j, want = JG.get_ou_data(key, n, t_size, dt=dt, drop_frac=drop_frac)
    k1, k2, k3 = jax.random.split(key, 3)
    grid = JI.build_step_grid(0.0, t_size - 1, dt)
    u = jax.random.uniform(k1, (n, 1))
    W = JI.sample_grid_noise(k2, grid, (n, 1), jnp.float64)[0]
    drop = jax.random.bernoulli(k3, drop_frac, (t_size, n, 1))
    order = []

    def uniform(shape, generator, dtype, device):
        assert tuple(shape) == (n, 1) and not order
        order.append("y0")
        return to_torch(u)

    def sample_grid_noise(generator, g, size, dtype, device=None, **kwargs):
        assert size == (n, 1) and np.array_equal(g, grid)
        order.append("W")
        return to_torch(W), None, None

    def bernoulli(p, shape, generator, device):
        assert p == drop_frac and tuple(shape) == (t_size, n, 1)
        order.append("drop")
        return to_torch(drop)

    monkeypatch.setattr(TG, "_uniform", uniform)
    monkeypatch.setattr(TI, "sample_grid_noise", sample_grid_noise)
    monkeypatch.setattr(TG, "_bernoulli", bernoulli)
    ts_t, got = TG.get_ou_data(None, n, t_size, dt=dt, drop_frac=drop_frac,
                               dtype=torch.float64, device="cpu")
    assert order == (["y0", "W", "drop"] if drop_frac else ["y0", "W"])
    np.testing.assert_array_equal(ts_t.numpy(), np.asarray(ts_j))
    assert torch.isfinite(got).all()
    _close(got, want)


def test_linear_fill_nans_matches_jax():
    rng = np.random.default_rng(3)
    ts = np.cumsum(rng.uniform(0.2, 1.0, 9))
    ys = rng.normal(size=(4, 9, 3))
    ys[rng.random(ys.shape) < 0.4] = np.nan
    ys[0, :3, 0] = np.nan           # leading gap
    ys[1, -4:, 1] = np.nan          # trailing gap
    ys[2, :, 2] = np.nan            # no observation at all
    want = JG.linear_fill_nans(ts, jnp.asarray(ys))
    got = TG.linear_fill_nans(ts, torch.as_tensor(ys))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    assert (got[2, :, 2] == 0).all()


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device given the entry points build on the CUDA card, and
    raise where there is none rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.Generator(DATA, INIT_NOISE, NOISE, HIDDEN, MLP, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.Discriminator(DATA, HIDDEN, MLP, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.get_ou_data(torch.Generator(), 4, 3)
    gen = TG.Generator(DATA, INIT_NOISE, NOISE, HIDDEN, MLP, 1, device="cpu")
    assert all(p.is_cpu for p in gen.parameters())
