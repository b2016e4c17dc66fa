"""Abstract Brownian motion interface (counterpart of
``torchsde_tpu/brownian/base.py``).

``bm(ta, tb, return_U=..., return_A=...)`` returns the increment
W(tb) - W(ta) (optionally with space-time Levy area U and full Levy area A),
and exposes shape/dtype/levy_area_approximation properties.
"""

import abc

import torch


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
