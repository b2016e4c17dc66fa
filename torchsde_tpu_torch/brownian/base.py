"""Abstract Brownian motion interface (counterpart of
``torchsde_tpu/brownian/base.py``).

``bm(ta, tb, return_U=..., return_A=...)`` returns the increment
W(tb) - W(ta) (optionally with space-time Levy area U and full Levy area A),
and exposes shape/dtype/levy_area_approximation properties.
"""

import abc

import torch

from ..settings import LEVY_AREA_APPROXIMATIONS


def interval_stats(w_a, i_a, w_b, i_b, h, degenerate):
    """``(W, H, U)`` of the intervals ``(a, b)`` from prefix values at their
    ends: ``w`` the prefix increments ``W(t0, t)``, ``i`` the prefix time
    integrals ``\\int_{t0}^{t} (W_u - W_{t0}) du`` (None without space-time
    Levy area; then ``H`` and ``U`` are None too). ``h`` (the widths, in the
    noise's dtype) and ``degenerate`` (zero-width intervals, which give
    zeros) broadcast against ``W``."""
    W = w_b - w_a
    H = U = None
    if i_a is not None:
        # U_{a,b} = \int_a^b (W_u - W_a) du = I(b) - I(a) - h W(t0,a);
        # H_{a,b} = U/h - W/2.
        U = i_b - i_a - h * w_a
        h_safe = torch.where(degenerate, torch.ones_like(h), h)
        H = torch.where(degenerate, torch.zeros_like(U), U / h_safe - 0.5 * W)
    W = torch.where(degenerate, torch.zeros_like(W), W)
    if H is not None:
        U = h * (0.5 * W + H)
    return W, H, U


def levy_area(W, H, h, noise, approximation, degenerate=None):
    """Davie's or Foster's approximation of the full Levy area ``A``
    (``(..., m, m)``) from increments ``W`` and space-time Levy areas ``H``
    (``(..., m)``), widths ``h`` broadcasting against them, and normal
    ``noise`` of ``A``'s shape, skew-symmetrised here (variance 2):
    ``H (x) W - W (x) H`` plus the noise scaled by ``h / sqrt(12)``
    (Davie) or ``sqrt(h/10 (h/10 + H_i^2 + H_j^2))`` (Foster). The diagonal
    is exactly zero. Zero where ``degenerate`` (broadcasting against
    ``W``) is true."""
    noise = noise - noise.transpose(-1, -2)
    A = H[..., :, None] * W[..., None, :] - W[..., :, None] * H[..., None, :]
    h = h[..., None]
    if approximation == LEVY_AREA_APPROXIMATIONS.foster:
        tenth_h = 0.1 * h
        H_sq = H * H
        std = torch.sqrt(tenth_h * (tenth_h + H_sq[..., :, None]
                                    + H_sq[..., None, :]))
    else:  # davie
        std = torch.sqrt(h * h / 12.0)
    A = A + std * noise
    if degenerate is not None:
        A = torch.where(degenerate[..., None], torch.zeros_like(A), A)
    return A


class BaseBrownian(metaclass=abc.ABCMeta):

    @abc.abstractmethod
    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        raise NotImplementedError

    def query_grid(self, grid, return_U=False, return_A=False):
        """Bulk form of ``__call__``: all ``len(grid) - 1`` consecutive
        increments, stacked along a new leading axis. ``grid`` is a float64
        host array. Subclasses override with cheaper exact implementations
        where they have one. Returns ``(W, U, A)`` with ``U``/``A`` ``None``
        unless requested."""
        Ws, Us, As = [], [], []
        for a, b in zip(grid[:-1], grid[1:]):
            out = self(float(a), float(b), return_U=return_U,
                       return_A=return_A)
            if not (return_U or return_A):
                out = (out,)
            out = list(out)
            Ws.append(out.pop(0))
            if return_U:
                Us.append(out.pop(0))
            if return_A:
                As.append(out.pop(0))
        return (torch.stack(Ws), torch.stack(Us) if return_U else None,
                torch.stack(As) if return_A else None)

    @property
    @abc.abstractmethod
    def dtype(self):
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def shape(self):
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def levy_area_approximation(self):
        raise NotImplementedError

    def size(self):
        return self.shape
