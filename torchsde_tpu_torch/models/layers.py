"""Linear, MLP and GRU layers (counterpart of ``torchsde_tpu/models/layers.py``).

The public layouts follow the JAX package so that weights carry over as they
are: ``Linear.w`` is (in, out), and the GRU keeps its gates ordered
[r | z | n] with ``b_hh`` inside ``r * h_n``.
"""

import math

import torch
from torch import nn

from ..utils.misc import resolve_device


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``. ``F.softplus`` switches to
    the identity above a threshold of 20 and would not match it."""
    return torch.logaddexp(x, x.new_zeros(()))


_ACTIVATIONS = {"softplus": softplus, "tanh": torch.tanh,
                "sigmoid": torch.sigmoid}


def uniform(shape, scale, dtype, device, generator):
    """U(-scale, scale) draws from ``generator`` (which fixes where they are
    drawn), moved to ``device`` (the card unless given)."""
    device = resolve_device(device)
    where = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, dtype=dtype, device=where)
    return ((2 * u - 1) * scale).to(device)


class Linear(nn.Module):
    def __init__(self, in_dim, out_dim, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        scale = 1.0 / math.sqrt(in_dim)
        self.w = nn.Parameter(uniform((in_dim, out_dim), scale, dtype, device,
                                      generator))
        self.b = nn.Parameter(uniform((out_dim,), scale, dtype, device,
                                      generator))

    def forward(self, x):
        w, b = self.w, self.b
        if x.dtype != w.dtype:
            # jnp's promotion (a float32 input to a bf16 layer computes in
            # float32), where torch refuses a matmul of mixed dtypes.
            dtype = torch.promote_types(x.dtype, w.dtype)
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
        return x @ w + b


class MLP(nn.Module):
    """Linear -> act -> ... -> Linear [-> final_activation]."""

    def __init__(self, sizes, activation="softplus", final_activation=None,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.layers = nn.ModuleList(
            Linear(a, b, dtype, device, generator)
            for a, b in zip(sizes[:-1], sizes[1:]))
        self.activation = activation
        self.final_activation = final_activation

    def forward(self, x):
        act = _ACTIVATIONS[self.activation]
        for layer in self.layers[:-1]:
            x = act(layer(x))
        x = self.layers[-1](x)
        if self.final_activation is not None:
            x = _ACTIVATIONS[self.final_activation](x)
        return x


class GRUCell(nn.Module):
    def __init__(self, input_size, hidden_size, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        scale = 1.0 / math.sqrt(hidden_size)
        H3 = 3 * hidden_size
        self.w_ih = nn.Parameter(uniform((input_size, H3), scale, dtype,
                                         device, generator))
        self.w_hh = nn.Parameter(uniform((hidden_size, H3), scale, dtype,
                                         device, generator))
        self.b_ih = nn.Parameter(uniform((H3,), scale, dtype, device,
                                         generator))
        self.b_hh = nn.Parameter(uniform((H3,), scale, dtype, device,
                                         generator))
        self.hidden_size = hidden_size

    def forward(self, x, h):
        return self.step_from_gi(x @ self.w_ih + self.b_ih, h)

    def step_from_gi(self, gi, h):
        """Advance from a precomputed input projection ``gi = x @ w_ih + b_ih``."""
        gh = h @ self.w_hh + self.b_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1 - z) * n + z * h


class GRU(nn.Module):
    """Unidirectional GRU over a (T, B, F) sequence."""

    def __init__(self, input_size, hidden_size, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cell = GRUCell(input_size, hidden_size, dtype, device, generator)

    def forward(self, xs, h0=None):
        if h0 is None:
            h0 = xs.new_zeros((xs.shape[1], self.cell.hidden_size))
        # The input projection of every step is one (T*B, in) @ (in, 3H)
        # product, outside the sequential loop.
        gi_all = xs @ self.cell.w_ih + self.cell.b_ih
        h, hs = h0, []
        for gi in gi_all:
            h = self.cell.step_from_gi(gi, h)
            hs.append(h)
        return torch.stack(hs), h
