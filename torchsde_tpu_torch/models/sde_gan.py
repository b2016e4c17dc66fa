"""SDE-GAN: neural-SDE generator against a neural-CDE critic (counterpart of
``torchsde_tpu/models/sde_gan.py``, after "Neural SDEs as
Infinite-Dimensional GANs").

The generator is a Stratonovich general-noise SDE with a fused ``f_and_g``,
solved by reversible Heun at ``dt=1.0``; the critic is a neural CDE driven
by the linear interpolation of a path, written as the drift-only SDE
``dh = F(t, h) X'(t) dt`` and solved the same way.

Randomness comes from an explicit ``torch.Generator`` where the JAX package
takes a key: one generator first draws the generator's initial noise (the
module-level draw site :func:`_standard_normal`) and then the solve noise
(``core/integrate.sample_grid_noise``), in the same order on the ``sdeint``
route and the fused route. The critic never draws from it.

``fused=True`` runs both solves through the whole-solve CUDA kernels of
``ops/gan_fused.py`` (their plain PyTorch versions for CPU tensors), and
trains on the card: each solve is a ``torch.autograd.Function`` whose
backward is the solve's reverse-sweep kernel, so one :func:`gan_grads`
launches each of the four GAN kernels once. On the ``sdeint`` route
``adjoint=True`` (the default, as in the JAX package) solves with
``sdeint_adjoint``: reversible Heun and its exact adjoint pair, which keeps
O(len(ts)) memory and gives the same values and the same discrete gradient
as ``adjoint=False`` (backprop through ``sdeint``); its backward redraws
the generator's solve noise from a copy of the generator's state. The
fused route does not consult ``adjoint``, as in the JAX package.
"""

import copy

import numpy as np
import torch
from torch import nn

from .layers import Linear
from ..core.adjoint import sdeint_adjoint
from ..core.sdeint import host_times, sdeint
from ..ops.gan_fused import (cde_final_state_fused, generator_solve_fused,
                              time_column)
from ..utils.misc import resolve_device


def _standard_normal(shape, generator, dtype, device):
    """The generator's initial-noise draw."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _uniform(shape, generator, dtype, device):
    """U[0, 1) draws of the OU dataset's initial values."""
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def _bernoulli(p, shape, generator, device):
    """The OU dataset's drop mask: True with probability ``p``."""
    u = torch.rand(shape, generator=generator, device=device)
    return u < p


def lipswish(x):
    return 0.909 * torch.nn.functional.silu(x)


class LipMLP(nn.Module):
    """MLP with LipSwish activations and an optional final tanh."""

    def __init__(self, in_size, out_size, mlp_size, num_layers, tanh,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        sizes = [in_size] + [mlp_size] * num_layers + [out_size]
        self.layers = nn.ModuleList(
            Linear(a, b, dtype, device, generator)
            for a, b in zip(sizes[:-1], sizes[1:]))
        self.tanh = tanh

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = lipswish(layer(x))
        x = self.layers[-1](x)
        return torch.tanh(x) if self.tanh else x


class GeneratorFunc(nn.Module):
    """Stratonovich general-noise SDE with fused ``f_and_g``: drift
    (1+S -> S) and diffusion (1+S -> S*m) tanh LipMLPs of ``[t, x]``."""
    sde_type = "stratonovich"
    noise_type = "general"

    def __init__(self, noise_size, hidden_size, mlp_size, num_layers,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.drift = LipMLP(1 + hidden_size, hidden_size, mlp_size,
                            num_layers, tanh=True, **kw)
        self.diffusion = LipMLP(1 + hidden_size, hidden_size * noise_size,
                                mlp_size, num_layers, tanh=True, **kw)
        self.noise_size = noise_size
        self.hidden_size = hidden_size

    def f_and_g(self, t, x):
        tx = time_column(t, x)
        f = self.drift(tx)
        g = self.diffusion(tx).reshape(x.shape[0], self.hidden_size,
                                       self.noise_size)
        return f, g


class Generator(nn.Module):
    """Initial LipMLP on noise, the SDE, and a linear readout. Parameter
    names follow the JAX package's pytree paths (``initial.layers.0.w``,
    ``func.drift.layers.1.b``, ``readout.w``), so
    :func:`torchsde_tpu_torch.utils.convert.load_jax_params` loads its
    weights. It is built on the CUDA card unless ``device`` says otherwise.

    ``init_mult1`` scales the initial MLP's parameters and ``init_mult2`` the
    vector fields', as the reference initialises them."""

    def __init__(self, data_size, initial_noise_size, noise_size,
                 hidden_size, mlp_size, num_layers, dtype=torch.float32,
                 init_mult1=1.0, init_mult2=1.0, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.initial = LipMLP(initial_noise_size, hidden_size, mlp_size,
                              num_layers, tanh=False, **kw)
        self.func = GeneratorFunc(noise_size, hidden_size, mlp_size,
                                  num_layers, **kw)
        self.readout = Linear(hidden_size, data_size, **kw)
        self.initial_noise_size = initial_noise_size
        with torch.no_grad():
            for module, mult in ((self.initial, init_mult1),
                                 (self.func, init_mult2)):
                if mult != 1.0:
                    for p in module.parameters():
                        p.mul_(mult)

    def forward(self, generator, ts, batch_size, dt=1.0, adjoint=True,
                fused=False):
        """Generated paths with time as channel 0: (batch, len(ts),
        1 + data). Draws the initial noise, then the solve noise, from
        ``generator``. ``fused=True`` runs the solve through the whole-solve
        kernel (``adjoint`` is not consulted there, as in the JAX
        package)."""
        w = self.readout.w
        init_noise = _standard_normal((batch_size, self.initial_noise_size),
                                      generator, w.dtype, w.device)
        x0 = self.initial(init_noise)
        if fused:
            xs = generator_solve_fused(self.func, x0, ts, generator, dt)
        else:
            solve = sdeint_adjoint if adjoint else sdeint
            xs = solve(self.func, x0, ts, method="reversible_heun", dt=dt,
                       generator=generator)
        ys = self.readout(xs).transpose(0, 1)            # (B, T, data)
        ts_col = torch.as_tensor(host_times(ts), dtype=ys.dtype,
                                 device=ys.device)
        ts_chan = ts_col[None, :, None].expand(batch_size, len(ts_col), 1)
        return torch.cat([ts_chan, ys], dim=2)


class CDEFunc(nn.Module):
    """The critic's CDE ``dh = F(t, h) dX`` as a drift-only SDE,
    ``f(t, h) = F(t, h) @ X'(t)``, with X the linear interpolation of a path.

    The path's knot times ``_path_ts`` (T,) and values ``_path_ys``
    (B, T, 1+data) are per-batch data, not weights: they are plain
    attributes of the view that :meth:`attach` returns, outside the
    module's parameters and buffers, and the module's own stay None."""
    sde_type = "stratonovich"
    noise_type = "additive"

    def __init__(self, data_size, hidden_size, mlp_size, num_layers,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.func = LipMLP(1 + hidden_size, hidden_size * (1 + data_size),
                           mlp_size, num_layers, tanh=True, dtype=dtype,
                           device=device, generator=generator)
        self.data_size = data_size
        self.hidden_size = hidden_size
        self._path_ts = None
        self._path_ys = None

    def attach(self, ts, ys_paths):
        """A view of the CDE driven by the path ``ys_paths`` (B, T, 1+data)
        observed at the knot times ``ts``. The view shares this module's
        parameters and submodules, so this module is never written (the
        JAX package evolves a new func)."""
        view = copy.copy(self)
        view._path_ts = torch.as_tensor(host_times(ts), dtype=ys_paths.dtype,
                                        device=ys_paths.device)
        view._path_ys = ys_paths
        return view

    def _x_dot(self, t):
        """Slope of the linear interpolant at time t: the knot interval
        ``searchsorted(ts, t, 'right') - 1``, clipped to [0, T-2]."""
        ts = self._path_ts
        t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device).reshape(1)
        i = (torch.searchsorted(ts, t, side="right") - 1).clamp(
            0, len(ts) - 2)
        dt_knot = ts[i + 1] - ts[i]
        return ((self._path_ys.index_select(1, i + 1)
                 - self._path_ys.index_select(1, i))[:, 0] / dt_knot)

    def f(self, t, h):
        F = self.func(time_column(t, h)).reshape(
            h.shape[0], self.hidden_size, 1 + self.data_size)
        return torch.einsum("bhc,bc->bh", F, self._x_dot(t))

    def g(self, t, h):
        return h.new_zeros((h.shape[0], self.hidden_size, 1))


class Discriminator(nn.Module):
    """Initial LipMLP on the path's first value, the CDE, and a linear
    readout to one score per path."""

    def __init__(self, data_size, hidden_size, mlp_size, num_layers,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.initial = LipMLP(1 + data_size, hidden_size, mlp_size,
                              num_layers, tanh=False, **kw)
        self.func = CDEFunc(data_size, hidden_size, mlp_size, num_layers,
                            **kw)
        self.readout = Linear(hidden_size, 1, **kw)

    def scores(self, ts, ys_paths, dt=1.0, adjoint=True, fused=False):
        """Per-sample critic scores of ``ys_paths`` (batch, len(ts),
        1 + data), time in channel 0. The ``sdeint`` route gives the solve
        a private generator seeded 0 (the JAX package passes ``entropy=0``):
        the zero diffusion makes its noise irrelevant, and the caller's
        generator is left untouched on both routes."""
        h0 = self.initial(ys_paths[:, 0])
        func = self.func.attach(ts, ys_paths)
        if fused:
            h_last = cde_final_state_fused(func, h0, ts, dt)
        else:
            solve = sdeint_adjoint if adjoint else sdeint
            private = torch.Generator(device=h0.device).manual_seed(0)
            hs = solve(func, h0, ts, method="reversible_heun", dt=dt,
                       generator=private)
            h_last = hs[-1]
        return self.readout(h_last)[:, 0]

    def forward(self, ts, ys_paths, dt=1.0, adjoint=True):
        """Mean critic score over the batch."""
        return torch.mean(self.scores(ts, ys_paths, dt=dt, adjoint=adjoint))

    def clip_weights(self):
        """Lipschitz constraint: clamp each Linear's weight to
        +-1/out_features, in place. Returns the module."""
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, Linear):
                    lim = 1.0 / module.w.shape[1]
                    module.w.clamp_(-lim, lim)
        return self


# --------------------------------------------------------------------------- #
#  Synthetic dataset: time-dependent Ornstein-Uhlenbeck paths                  #
# --------------------------------------------------------------------------- #

class _OU(nn.Module):
    sde_type = "ito"
    noise_type = "scalar"

    def __init__(self, mu, theta, sigma, t_size):
        super().__init__()
        self.mu, self.theta, self.sigma = mu, theta, sigma
        self.t_size = t_size

    def f(self, t, y):
        return self.mu * t - self.theta * y

    def g(self, t, y):
        val = self.sigma * (2 * t / self.t_size)
        val = torch.as_tensor(val, dtype=y.dtype, device=y.device)
        return val.reshape(1, 1, 1).expand(y.shape[0], 1, 1)


def linear_fill_nans(ts, ys):
    """Fill NaN observations by linear interpolation between the nearest
    observed knots, constant past the first and last observation; a channel
    with no observation at all fills with zeros.

    ``ts`` is (T,); ``ys`` is (..., T, C) with NaNs marking missing
    observations."""
    ts = torch.as_tensor(host_times(ts), dtype=ys.dtype, device=ys.device)
    T = ys.shape[-2]
    obs = torch.isfinite(ys)                                  # (..., T, C)
    idx = torch.arange(T, device=ys.device)[:, None]          # (T, 1)
    # Nearest observed index at or before, and at or after, each position.
    prev = torch.cummax(torch.where(obs, idx, -1), dim=-2).values
    nxt = torch.cummin(torch.where(obs, idx, T).flip(-2), dim=-2).values
    nxt = nxt.flip(-2)
    has_prev, has_next = prev >= 0, nxt <= T - 1
    p = prev.clamp(0, T - 1)
    n = nxt.clamp(0, T - 1)
    ys0 = torch.where(obs, ys, torch.zeros_like(ys))
    y_p = torch.gather(ys0, -2, p)
    y_n = torch.gather(ys0, -2, n)
    t_p = ts[p]
    t_n = ts[n]
    width = t_n - t_p
    pos = width > 0
    w = torch.where(pos, (ts[:, None] - t_p)
                    / torch.where(pos, width, torch.ones_like(width)),
                    torch.zeros_like(width))
    interp = y_p * (1 - w) + y_n * w
    zero = torch.zeros_like(ys)
    filled = torch.where(has_prev & has_next, interp,
                         torch.where(has_prev, y_p,
                                     torch.where(has_next, y_n, zero)))
    return torch.where(obs, ys, filled)


def get_ou_data(generator, dataset_size, t_size, dt=1e-1, drop_frac=0.0,
                dtype=torch.float32, device=None):
    """OU dataset with a time channel, normalised by the statistics of the
    observed initial values. Returns ``(ts, paths)``: ts (t_size,) and paths
    (dataset_size, t_size, 2), on the CUDA card unless ``device`` says
    otherwise.

    Draws from ``generator`` in this order: the initial values, the solve
    noise, and (with ``drop_frac > 0``) the drop mask. ``drop_frac > 0``
    drops that fraction of the observations (NaN) before normalisation and
    fills them by linear interpolation for the CDE's knots."""
    device = resolve_device(device)
    ou = _OU(mu=0.02, theta=0.1, sigma=0.4, t_size=t_size)
    y0 = _uniform((dataset_size, 1), generator, dtype, device) * 2 - 1
    ts = torch.as_tensor(np.linspace(0.0, t_size - 1, t_size), dtype=dtype,
                         device=device)
    ys = sdeint(ou, y0, ts, dt=dt, method="euler", generator=generator)
    if drop_frac > 0.0:
        drop = _bernoulli(drop_frac, ys.shape, generator, device)
        ys = torch.where(drop, torch.full_like(ys, float("nan")), ys)
    y0_flat = ys[0].reshape(-1)
    y0_obs = torch.isfinite(y0_flat)
    denom = torch.clamp(y0_obs.sum(), min=1)
    zero = torch.zeros_like(y0_flat)
    mean = torch.where(y0_obs, y0_flat, zero).sum() / denom
    var = (torch.where(y0_obs, (y0_flat - mean) ** 2, zero).sum()
           / torch.clamp(denom - 1, min=1))
    # A single surviving observation gives var 0, which would turn the whole
    # dataset into NaNs.
    ys = (ys - mean) / torch.sqrt(torch.clamp(var, min=1e-12))
    ys = ys.transpose(0, 1)                                   # (B, T, 1)
    if drop_frac > 0.0:
        ys = linear_fill_nans(ts, ys)
    ts_chan = ts[None, :, None].expand(dataset_size, t_size, 1)
    return ts, torch.cat([ts_chan, ys], dim=2)


def gan_loss(generator, discriminator, gen, ts, real_paths, dt=1.0,
             adjoint=True, fused=False):
    """Wasserstein objective D(fake) - D(real); the training step negates
    the generator's gradients. The fake and real critic solves share their
    weights and knot times, so they run as one CDE solve at twice the
    batch. ``gen`` is the ``torch.Generator`` that the generator draws
    from."""
    B = real_paths.shape[0]
    fake = generator(gen, ts, B, dt=dt, adjoint=adjoint, fused=fused)
    both = torch.cat([fake, real_paths], dim=0)
    s = discriminator.scores(ts, both, dt=dt, adjoint=adjoint, fused=fused)
    return torch.mean(s[:B]) - torch.mean(s[B:])


def gan_grads(generator, discriminator, gen, ts, real_paths, dt=1.0,
              adjoint=True, fused=False):
    """``(loss, gen_grads, disc_grads)``: the gradients are dicts keyed by
    parameter name, the generator's already negated (it ascends the critic
    score)."""
    loss = gan_loss(generator, discriminator, gen, ts, real_paths, dt=dt,
                    adjoint=adjoint, fused=fused)
    g_params = dict(generator.named_parameters())
    d_params = dict(discriminator.named_parameters())
    grads = torch.autograd.grad(loss, list(g_params.values())
                                + list(d_params.values()))
    n = len(g_params)
    g_gen = {k: -g for k, g in zip(g_params, grads[:n])}
    g_disc = dict(zip(d_params, grads[n:]))
    return loss.detach(), g_gen, g_disc
