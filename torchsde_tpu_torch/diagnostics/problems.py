"""Test problems of the strong- and weak-order diagnostics (counterpart of
the JAX package's ``tests/problems.py``: ``ExDiagonal``, ``ExScalar``,
``ExAdditive`` and ``NeuralGeneral``).

The Ex* problems are examples 1-3 of Rackauckas & Nie (2017), with matched
Itô and Stratonovich drifts and exact sample solutions
(``analytical_sample``); ``NeuralGeneral`` is a tiny MLP SDE with general
noise and 0.1-scaled diffusion. Their parameters are drawn as the JAX
problems draw them, from the same Threefry keys (``PRNGKey(0)``, ``(1)``,
``(2)``, ``(6)`` by default, through ``brownian/threefry.py``) in float64,
so they equal the JAX package's to the rounding of ``erfinv``. The
parameters are buffers: a solve of a problem records no gradient of them.
"""

import math

import torch
from torch import nn

from ..brownian import threefry
from ..core.base_sde import BaseSDE
from ..models.layers import softplus
from ..settings import NOISE_TYPES, SDE_TYPES
from ..utils.misc import resolve_device


def _key(key, seed):
    return threefry.prng_key(seed) if key is None else torch.as_tensor(key)


def _normal(key, d):
    return threefry.normal(key, (d,), torch.float64)


def _root1p(t, y):
    """sqrt(1 + t) as a tensor of ``y``'s dtype and device."""
    return torch.sqrt(torch.as_tensor(1.0 + t, dtype=y.dtype,
                                      device=y.device))


def _t_cat(t, y):
    t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
    return torch.cat([t.expand(y.shape[0], 1), y], dim=1)


class _Problem(BaseSDE):
    """A problem's buffers in ``dtype`` on ``device`` (the card unless
    given)."""

    def __init__(self, noise_type, sde_type, dtype, device):
        super().__init__(noise_type=noise_type, sde_type=sde_type)
        self._to = dict(dtype=dtype, device=resolve_device(device))

    def _buffer(self, name, value):
        self.register_buffer(name, torch.as_tensor(value).to(**self._to))

    def h(self, t, y):
        return torch.zeros_like(y)

    def _outputs(self, y0, ts, bm, at):
        """``[y0] + [at(t0, t, W(t0, t)) for t in ts[1:]]`` stacked."""
        t0 = float(ts[0])
        outs = [y0] + [at(t0, float(t), bm(t0, float(t)))
                       for t in list(ts[1:])]
        return torch.stack(outs, dim=0)


class ExDiagonal(_Problem):
    """dy = mu y dt + sigma y dW (Itô; the Stratonovich form subtracts
    sigma^2 y / 2 from the drift), diagonal noise. ``mu`` and ``sigma``
    are drawn from ``key`` (``PRNGKey(0)``) unless given."""

    def __init__(self, d, key=None, sde_type=SDE_TYPES.ito, mu=None,
                 sigma=None, dtype=torch.float64, device=None):
        super().__init__(NOISE_TYPES.diagonal, sde_type, dtype, device)
        if mu is None or sigma is None:
            k1, k2 = threefry.split(_key(key, 0))
            draw_sigma = torch.sigmoid(_normal(k1, d))
            draw_mu = -draw_sigma ** 2 - torch.sigmoid(_normal(k2, d))
            mu = draw_mu if mu is None else mu
            sigma = draw_sigma if sigma is None else sigma
        self._buffer("mu", mu)
        self._buffer("sigma", sigma)

    def f(self, t, y):
        if self.sde_type == SDE_TYPES.ito:
            return self.mu * y
        return self.mu * y - 0.5 * (self.sigma ** 2) * y

    def g(self, t, y):
        return self.sigma * y

    def analytical_sample(self, y0, ts, bm):
        """y(t) = y0 exp((mu - sigma^2/2) (t - t0) + sigma W(t0, t))."""
        return self._outputs(y0, ts, bm, lambda t0, t, W: y0 * torch.exp(
            (self.mu - 0.5 * self.sigma ** 2) * (t - t0) + self.sigma * W))


class ExScalar(_Problem):
    """dy = -p^2 sin y cos^3 y dt + p cos^2 y dW (Itô), or its Stratonovich
    form with zero drift; scalar noise. ``p`` is drawn from ``key``
    (``PRNGKey(1)``)."""

    def __init__(self, d, key=None, sde_type=SDE_TYPES.ito,
                 dtype=torch.float64, device=None):
        super().__init__(NOISE_TYPES.scalar, sde_type, dtype, device)
        self._buffer("p", torch.sigmoid(_normal(_key(key, 1), d)))

    def f(self, t, y):
        if self.sde_type == SDE_TYPES.ito:
            return -self.p ** 2.0 * torch.sin(y) * torch.cos(y) ** 3.0
        return torch.zeros_like(y)

    def g(self, t, y):
        return (self.p * torch.cos(y) ** 2)[..., None]

    def analytical_sample(self, y0, ts, bm):
        """y(t) = arctan(p W(t0, t) + tan(y0))."""
        return self._outputs(y0, ts, bm, lambda t0, t, W: torch.atan(
            self.p * W + torch.tan(y0)))


class ExAdditive(_Problem):
    """dy = (b / sqrt(1 + t) - y / (2 + 2t)) dt + a b / sqrt(1 + t) sum_j
    dW^j, additive noise of m channels. ``a`` and ``b`` are drawn from
    ``key`` (``PRNGKey(2)``)."""

    def __init__(self, d, m, key=None, sde_type=SDE_TYPES.ito,
                 dtype=torch.float64, device=None):
        super().__init__(NOISE_TYPES.additive, sde_type, dtype, device)
        k1, k2 = threefry.split(_key(key, 2))
        self.m = m
        self._buffer("a", torch.sigmoid(_normal(k1, d)))
        self._buffer("b", torch.sigmoid(_normal(k2, d)))

    def f(self, t, y):
        return self.b / _root1p(t, y) - y / (2.0 + 2.0 * t)

    def g(self, t, y):
        fill = self.a * self.b / _root1p(t, y)
        return fill[None, :, None].expand(y.shape[0], fill.shape[0], self.m)

    def analytical_sample(self, y0, ts, bm):
        """With y = u / sqrt(1 + t): du = b dt + a b sum_j dW^j, so y(t) =
        (y0 sqrt(1 + t0) + b (t - t0) + a b sum_j W^j(t0, t)) /
        sqrt(1 + t)."""
        return self._outputs(y0, ts, bm, lambda t0, t, W: (
            y0 * math.sqrt(1.0 + t0) + self.b * (t - t0)
            + self.a * self.b * torch.sum(W, dim=-1, keepdim=True))
            / math.sqrt(1.0 + t))


class _MLP(nn.Module):
    """Linear -> softplus -> Linear [-> sigmoid], weights (in, out) drawn
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as the JAX problems' MLP."""

    def __init__(self, key, in_dim, hidden, out_dim, final_sigmoid, to):
        super().__init__()
        k1, k2 = threefry.split(key)
        for name, k, shape, fan_in in (("w1", k1, (in_dim, hidden), in_dim),
                                       ("w2", k2, (hidden, out_dim), hidden)):
            s = 1.0 / math.sqrt(fan_in)
            self.register_buffer(name, threefry.uniform(
                k, shape, torch.float64, -s, s).to(**to))
        self.register_buffer("b1", torch.zeros((hidden,), **to))
        self.register_buffer("b2", torch.zeros((out_dim,), **to))
        self.final_sigmoid = final_sigmoid

    def forward(self, x):
        h = softplus(x @ self.w1 + self.b1)
        out = h @ self.w2 + self.b2
        return torch.sigmoid(out) if self.final_sigmoid else out


class NeuralGeneral(_Problem):
    """f and g tiny MLPs of [t | y]; g is 0.1 times a sigmoid MLP shaped
    (B, d, m), general noise. The weights are drawn from ``key``
    (``PRNGKey(6)``). It has no exact solution: the diagnostics solve it
    at a fine step instead."""

    def __init__(self, d, m, key=None, sde_type=SDE_TYPES.ito,
                 dtype=torch.float64, device=None):
        super().__init__(NOISE_TYPES.general, sde_type, dtype, device)
        k1, k2 = threefry.split(_key(key, 6))
        self.d, self.m = d, m
        self.f_net = _MLP(k1, d + 1, 8, d, False, self._to)
        self.g_net = _MLP(k2, d + 1, 8, d * m, True, self._to)

    def f(self, t, y):
        return self.f_net(_t_cat(t, y))

    def g(self, t, y):
        return 0.1 * self.g_net(_t_cat(t, y)).reshape(
            y.shape[0], self.d, self.m)
