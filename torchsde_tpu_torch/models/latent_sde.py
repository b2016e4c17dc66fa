"""Latent SDE model family (counterpart of ``torchsde_tpu/models/latent_sde.py``).

A GRU encoder reads the observations backwards in time and produces a
context path; the posterior drift ``f`` conditions on the context, the prior
drift ``h`` does not, and per-dimension nets give a diagonal diffusion. The
ELBO integrates the KL between the two path measures through the ``logqp``
channel.

Randomness comes from an explicit ``torch.Generator`` where the JAX package
takes a key: one generator first draws the posterior's initial-state eps and
then the solve noise.
"""

import copy

import torch
from torch import nn

from .layers import GRU, Linear, MLP, softplus, uniform
from ..core.sdeint import host_times, sdeint
from ..ops.latent_fused import latent_logqp_solve_fused
from ..utils.misc import resolve_device


def _standard_normal(shape, generator, dtype, device):
    """Every N(0, 1) draw of the model outside the solve noise."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


class LatentSDE(nn.Module):
    """Posterior/prior latent SDE with GRU context encoder.

    Parameter names follow the JAX package's pytree paths
    (``f_net.layers.0.w``, ``g_nets.2``, ``encoder.cell.w_hh``), so
    :func:`torchsde_tpu_torch.utils.convert.load_jax_params` loads its
    weights. The context path ``_ctx_ts`` (T,) / ``_ctx`` (T, B, C) is held
    in two non-persistent buffers of the view that :meth:`contextualize`
    returns; the model's own stay as built. It is built on the CUDA card
    unless ``device`` says otherwise.
    """

    noise_type = "diagonal"
    sde_type = "ito"

    def __init__(self, data_size, latent_size, context_size, hidden_size,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.encoder = GRU(data_size, hidden_size, **kw)
        self.encoder_proj = Linear(hidden_size, context_size, **kw)
        self.qz0_net = Linear(context_size, 2 * latent_size, **kw)
        self.f_net = MLP((latent_size + context_size, hidden_size,
                          hidden_size, latent_size), **kw)
        self.h_net = MLP((latent_size, hidden_size, hidden_size, latent_size),
                         **kw)
        # Per-dimension diffusion nets, stacked over the latent dimension:
        # w1 (L,1,H), b1 (L,H), w2 (L,H,1), b2 (L,1).
        L, H = latent_size, hidden_size
        self.g_nets = nn.ParameterList([
            nn.Parameter(uniform((L, 1, H), 1.0, dtype, device, generator)),
            nn.Parameter(torch.zeros((L, H), dtype=dtype, device=device)),
            nn.Parameter(uniform((L, H, 1), H ** -0.5, dtype, device,
                                 generator)),
            nn.Parameter(torch.zeros((L, 1), dtype=dtype, device=device)),
        ])
        self.projector = Linear(latent_size, data_size, **kw)
        self.pz0_mean = nn.Parameter(torch.zeros((1, L), dtype=dtype,
                                                 device=device))
        self.pz0_logstd = nn.Parameter(torch.zeros((1, L), dtype=dtype,
                                                   device=device))
        self.latent_size = latent_size
        self.context_size = context_size
        self.register_buffer("_ctx_ts", torch.zeros((1,), dtype=dtype,
                                                    device=device),
                             persistent=False)
        self.register_buffer("_ctx", torch.zeros((1, 1, context_size),
                                                 dtype=dtype, device=device),
                             persistent=False)

    # -- encoder -------------------------------------------------------- #

    def encode(self, xs, ts):
        """xs: (T, B, data). Runs the GRU over the reversed sequence so the
        context at time t summarises the future."""
        hs, _ = self.encoder(torch.flip(xs, dims=(0,)))
        return self.encoder_proj(torch.flip(hs, dims=(0,)))

    def contextualize(self, ts, ctx):
        """A view of the model that reads the context path ``ctx`` (T, B, C)
        observed at ``ts``. The view shares this model's parameters and
        submodules and holds the context in buffers of its own, so this
        model is never written (the JAX package returns a new module)."""
        view = copy.copy(self)
        view._buffers = dict(self._buffers)
        view._ctx_ts = torch.as_tensor(host_times(ts), dtype=ctx.dtype,
                                       device=ctx.device)
        view._ctx = ctx
        return view

    def ctx_index(self, t):
        """Index of the context row in force at times ``t``:
        ``searchsorted(ctx_ts, t, side='left')`` clipped to [0, T-1]."""
        i = torch.searchsorted(self._ctx_ts, t.to(self._ctx_ts.dtype),
                               side="left")
        return i.clamp(0, self._ctx.shape[0] - 1)

    def _ctx_at(self, t):
        return self._ctx.index_select(0, self.ctx_index(t.reshape(1)))[0]

    # -- SDE interface --------------------------------------------------- #

    def f(self, t, y):
        return self.f_net(torch.cat([y, self._ctx_at(t)], dim=1))

    def h(self, t, y):
        return self.h_net(y)

    def f_and_h(self, t, y):
        """Posterior and prior drift together. The JAX package stacks the two
        towers into one batched product to halve its kernel launches; in
        eager PyTorch the stacking would add launches, so the towers run
        side by side."""
        return self.f(t, y), self.h(t, y)

    def g(self, t, y):
        w1, b1, w2, b2 = self.g_nets       # (L,1,H), (L,H), (L,H,1), (L,1)
        yi = y.T[..., None]                # (L, B, 1)
        a = softplus(torch.einsum("lbi,lih->lbh", yi, w1) + b1[:, None, :])
        out = torch.sigmoid(torch.einsum("lbh,lho->lbo", a, w2)
                            + b2[:, None, :])
        return out[..., 0].T               # (B, L)

    # -- training-time API ----------------------------------------------- #

    def posterior_z0(self, ctx0, generator=None):
        qz0_mean, qz0_logstd = self.qz0_net(ctx0).chunk(2, dim=1)
        eps = _standard_normal(qz0_mean.shape, generator, qz0_mean.dtype,
                               qz0_mean.device)
        z0 = qz0_mean + torch.exp(qz0_logstd) * eps
        return z0, qz0_mean, qz0_logstd


def _normal_logp(x, mean, std):
    var = std ** 2
    # The log of the constant is taken in float64 whatever x's dtype, as
    # jnp.log does for a Python scalar under x64.
    log_norm = torch.log(torch.as_tensor(2 * torch.pi * var,
                                         dtype=torch.float64))
    return -0.5 * (log_norm + (x - mean) ** 2 / var)


def _kl_diag_normal(mean1, logstd1, mean2, logstd2):
    var1 = torch.exp(2 * logstd1)
    var2 = torch.exp(2 * logstd2)
    return (logstd2 - logstd1 + (var1 + (mean1 - mean2) ** 2) / (2 * var2) - 0.5)


def latent_sde_loss(model, xs, ts, generator=None, noise_std=0.01,
                    kl_weight=1.0, dt=1e-2, method="euler", adjoint=False,
                    fused=False, **solve_kwargs):
    """ELBO loss: reconstruction log-likelihood under the projector decoder,
    KL at t0, and the pathwise KL integral from the ``logqp`` channel.

    ``fused=True`` runs the Euler logqp solve through the whole-solve kernels
    (``ops/latent_fused.py``), with the same eps and noise draws as the
    ``sdeint`` route for the same generator state. It trains: the forward
    kernel and the reverse-sweep kernel are joined in an autograd Function,
    whose gradients reach the encoder through the context and ``qz0_net``
    through the initial state."""
    ctx = model.encode(xs, ts)
    model = model.contextualize(ts, ctx)
    z0, qz0_mean, qz0_logstd = model.posterior_z0(ctx[0], generator)

    if fused:
        if adjoint or method != "euler" or solve_kwargs:
            raise ValueError(
                "fused=True supports the default euler/backprop path only")
        zs, log_ratio = latent_logqp_solve_fused(model, z0, ts, generator, dt)
    else:
        if adjoint:
            raise NotImplementedError(
                "sdeint_adjoint is not ported to torchsde_tpu_torch yet")
        zs, log_ratio = sdeint(model, z0, ts, dt=dt, method=method,
                               logqp=True, generator=generator,
                               **solve_kwargs)

    _xs = model.projector(zs)
    log_pxs = torch.sum(torch.mean(_normal_logp(xs, _xs, noise_std), dim=1))

    logqp0 = torch.sum(torch.mean(
        _kl_diag_normal(qz0_mean, qz0_logstd, model.pz0_mean,
                        model.pz0_logstd), dim=0))
    logqp_path = torch.mean(torch.sum(log_ratio, dim=0))
    loss = -log_pxs + kl_weight * (logqp0 + logqp_path)
    return loss, dict(log_pxs=log_pxs, logqp=logqp0 + logqp_path)


def sample_posterior(model, xs, ts, generator=None, dt=1e-2, method="euler"):
    """Posterior sample paths projected to data space."""
    ctx = model.encode(xs, ts)
    model = model.contextualize(ts, ctx)
    z0, _, _ = model.posterior_z0(ctx[0], generator)
    zs = sdeint(model, z0, ts, dt=dt, method=method, generator=generator)
    return model.projector(zs)


def sample_prior(model, batch_size, ts, generator=None, dt=1e-2,
                 method="euler"):
    """Prior sample paths: integrate the prior drift ``h`` with the same
    diffusion (through ``names={"drift": "h"}``). Like the JAX package it
    always solves with Euler."""
    del method
    mean = model.pz0_mean
    eps = _standard_normal((batch_size, model.latent_size), generator,
                           mean.dtype, mean.device)
    z0 = mean + torch.exp(model.pz0_logstd) * eps
    model = model.contextualize(
        [0.0], mean.new_zeros((1, batch_size, model.context_size)))
    zs = sdeint(model, z0, ts, dt=dt, method="euler", names={"drift": "h"},
                generator=generator)
    return model.projector(zs)


# --------------------------------------------------------------------------- #
#  Stochastic Lorenz attractor dataset                                        #
# --------------------------------------------------------------------------- #

class StochasticLorenz(nn.Module):
    noise_type = "diagonal"
    sde_type = "ito"

    def __init__(self, a=(10.0, 28.0, 8.0 / 3.0), b=(0.1, 0.28, 0.3),
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("a", torch.tensor(a, dtype=dtype, device=device))
        self.register_buffer("b", torch.tensor(b, dtype=dtype, device=device))

    def f(self, t, y):
        x1, x2, x3 = y[:, 0], y[:, 1], y[:, 2]
        a1, a2, a3 = self.a
        return torch.stack([a1 * (x2 - x1), a2 * x1 - x2 - x1 * x3,
                            x1 * x2 - a3 * x3], dim=1)

    def g(self, t, y):
        return self.b[None, :].expand(y.shape)


def make_lorenz_data(batch_size, ts, generator=None, noise_std=0.01, dt=1e-3,
                     dtype=torch.float32, device=None):
    """Simulate the stochastic Lorenz attractor, normalise, add observation
    noise. Returns xs of shape (len(ts), batch_size, 3), on the CUDA card
    unless ``device`` says otherwise."""
    device = resolve_device(device)
    scale = torch.tensor([15.0, 15.0, 6.0], dtype=dtype, device=device)
    y0 = _standard_normal((batch_size, 3), generator, dtype, device) * scale
    xs = sdeint(StochasticLorenz(dtype=dtype, device=device), y0, ts, dt=dt,
                method="euler", generator=generator)
    mean = torch.mean(xs, dim=(0, 1), keepdim=True)
    std = torch.std(xs, dim=(0, 1), keepdim=True, correction=0)
    xs = (xs - mean) / (std + 1e-8)
    return xs + noise_std * _standard_normal(xs.shape, generator, dtype,
                                             device)
