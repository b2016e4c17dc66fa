"""Precomputed-grid Brownian motion with O(1) interval queries (counterpart
of ``torchsde_tpu/brownian/precomputed.py``).

The whole path is sampled once on ``n`` uniform fine cells over
``[t0, t1]``; an interval ``(ta, tb)`` is two gathers from cumulative
arrays, its ends rounded to the nearest cell edge. Supports ``(W, U, A)``;
additivity and the U chain rule hold by construction. The draws are the
JAX package's (same keys and bits; normals to rounding).
"""

import numpy as np
import torch

from . import base, threefry
from .interval import _HAVE_A, _HAVE_H, _ret, as_key, as_torch_dtype, on_host
from ..settings import LEVY_AREA_APPROXIMATIONS
from ..utils.misc import resolve_device


class PrecomputedBrownian(base.BaseBrownian):
    """Brownian motion sampled on ``n`` uniform fine cells over [t0, t1],
    on ``device`` (the card unless given).

    Memory: O(n * prod(size)). Query cost: O(1).
    """

    def __init__(self, t0, t1, size, n, dtype=None, entropy=None, key=None,
                 levy_area_approximation=LEVY_AREA_APPROXIMATIONS.none,
                 device=None):
        t0, t1 = float(t0), float(t1)
        if t0 >= t1:
            raise ValueError(f"Initial time {t0} should be less than terminal time {t1}.")
        if levy_area_approximation not in LEVY_AREA_APPROXIMATIONS:
            raise ValueError(f"`levy_area_approximation` must be one of "
                             f"{LEVY_AREA_APPROXIMATIONS}.")
        size = tuple(int(s) for s in size)
        dtype = as_torch_dtype(torch.float32 if dtype is None else dtype)
        device = resolve_device(device)
        if key is None:
            if entropy is None:
                entropy = int(np.random.randint(0, 2 ** 31 - 1))
            key = threefry.prng_key(int(entropy), device)
        key = as_key(key, device)
        device = key.device  # with its index: torch.device("cuda:0")
        self._entropy = entropy
        self._device = device
        self._t0, self._t1 = t0, t1
        self._size = size
        self._dtype = dtype
        self._n = int(n)
        self._levy_area_approximation = levy_area_approximation
        self._have_H = levy_area_approximation in _HAVE_H
        self._have_A = levy_area_approximation in _HAVE_A

        h = (t1 - t0) / self._n
        key_w, key_h, self._key_a = threefry.split(key, 3)
        W = threefry.normal(key_w, (self._n, *size), dtype) * np.sqrt(h)
        zero = torch.zeros((1, *size), dtype=dtype, device=device)
        self._cumW = torch.cat([zero, torch.cumsum(W, dim=0)], dim=0)
        if self._have_H:
            H = threefry.normal(key_h, (self._n, *size), dtype) * np.sqrt(h / 12.0)
            U = h * (0.5 * W + H)
            # cumI[k] = int_{t0}^{t_k} (W_u - W_{t0}) du
            #         = sum_{j<k} (U_j + h * cumW[j])
            incr = U + h * self._cumW[:-1]
            self._cumI = torch.cat([zero, torch.cumsum(incr, dim=0)], dim=0)
        else:
            self._cumI = zero  # placeholder

    # -- properties ------------------------------------------------------- #

    @property
    def dtype(self):
        return self._dtype

    @property
    def shape(self):
        return self._size

    @property
    def device(self):
        return self._device

    @property
    def levy_area_approximation(self):
        return self._levy_area_approximation

    @property
    def entropy(self):
        return self._entropy

    @property
    def n(self):
        return self._n

    def __repr__(self):
        return (f"{self.__class__.__name__}(t0={self._t0:.3f}, t1={self._t1:.3f}, "
                f"size={self._size}, n={self._n}, "
                f"levy_area_approximation={self._levy_area_approximation!r})")

    # -- query ------------------------------------------------------------ #

    def _index(self, t):
        """Cell-edge index in float64 (on the host for host times), so fine
        grids do not misquantise: a float32 fractional position can land a
        cell off once ``n`` nears float32's resolution of the span."""
        if on_host(t):
            frac = (np.asarray(t, np.float64) - self._t0) / (self._t1 - self._t0)
            k = np.clip(np.round(frac * self._n), 0, self._n).astype(np.int64)
            return torch.as_tensor(k, device=self._device)
        frac = (t.to(device=self._device, dtype=torch.float64) - self._t0) \
            / (self._t1 - self._t0)
        return torch.round(frac * self._n).to(torch.int64).clamp(0, self._n)

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        if tb is None:
            ta, tb = self._t0, ta
        W, U, A = self._query(self._index(ta), self._index(tb), return_A)
        return _ret(W, U, A, return_U, return_A)

    def query_grid(self, grid, return_U=False, return_A=False):
        """Every cell of a host grid in one gather: bitwise each cell's
        ``__call__``."""
        k = self._index(np.asarray(grid, np.float64))
        W, U, A = self._query(k[:-1], k[1:], return_A)
        return W, (U if return_U else None), (A if return_A else None)

    def _query(self, ka, kb, return_A):
        """``(W, U, A)`` of the cells between edge indices ``ka`` and
        ``kb`` (0-d, or 1-d for a batch of intervals)."""
        kb = torch.maximum(ka, kb)
        bshape = ka.shape + (1,) * len(self._size)
        h_cell = (self._t1 - self._t0) / self._n
        h = ((kb - ka).to(self._dtype) * h_cell).reshape(bshape)
        degenerate = (kb == ka).reshape(bshape)

        have_H = self._have_H
        W, H, U = base.interval_stats(
            self._cumW[ka], self._cumI[ka] if have_H else None,
            self._cumW[kb], self._cumI[kb] if have_H else None, h, degenerate)
        A = None
        if self._have_A and return_A:
            A = self._levy_area(ka, kb, W, H, h, degenerate)
        return W, U, A

    def _levy_area(self, ka, kb, W, H, h, degenerate):
        if len(self._size) in (0, 1):
            return torch.zeros_like(W)
        key = threefry.fold_in(threefry.fold_in(self._key_a, ka), kb)
        noise = threefry.normal(key, (*self._size, self._size[-1]),
                                self._dtype)
        return base.levy_area(W, H, h, noise, self._levy_area_approximation,
                              degenerate)
