"""Derived Brownian motions (counterpart of
``torchsde_tpu/brownian/derived.py``).

``BrownianInterval`` is cache-free, reproducible and query-order
independent, so ``BrownianPath`` and ``BrownianTree`` are thin wrappers
that add the ``w0`` offset and the pinned endpoint; ``ReverseBrownian``
reverses time for the adjoint's backward solve.
"""

import numpy as np
import torch

from . import base
from .interval import BrownianInterval
from ..utils.misc import resolve_device


class ReverseBrownian(base.BaseBrownian):
    """Time reversal: ``rev(ta, tb) == base(-tb, -ta)``. The adjoint SDE
    negates its drift and diffusion, so the statistics are not negated
    here."""

    def __init__(self, base_brownian):
        self.base_brownian = base_brownian

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        return self.base_brownian(-tb, -ta, return_U=return_U, return_A=return_A)

    def query_grid(self, grid, return_U=False, return_A=False):
        """Interval ``i`` of a reversed grid is forward interval ``N-1-i``
        of the negated, order-reversed grid."""
        fwd = -np.asarray(grid, np.float64)[::-1]
        W, U, A = self.base_brownian.query_grid(fwd, return_U=return_U,
                                                return_A=return_A)
        flip = lambda x: None if x is None else x.flip(0)  # noqa: E731
        return flip(W), flip(U), flip(A)

    def query_pairs(self, points, pairs, return_U=False, return_A=False):
        """The reversed interval ``(points[ia], points[ib])`` is the forward
        interval ``(-tb, -ta)``: negate the points and swap each pair. A
        base without ``query_pairs`` is queried pair by pair, an inverted
        pair clamped to zero width (``BrownianInterval``'s ``tb = max(ta,
        tb)``)."""
        if not hasattr(self.base_brownian, "query_pairs"):
            outs = []
            for ia, ib in pairs:
                ta = points[ia]
                tb = max(ta, points[ib]) if not torch.is_tensor(ta) \
                    else torch.maximum(ta, points[ib])
                outs.append(self(ta, tb, return_U=return_U, return_A=return_A))
            return outs
        neg = -points if torch.is_tensor(points) else [-float(p) for p in points]
        return self.base_brownian.query_pairs(
            neg, [(ib, ia) for ia, ib in pairs],
            return_U=return_U, return_A=return_A)

    def __repr__(self):
        return f"{self.__class__.__name__}(base_brownian={self.base_brownian})"

    @property
    def dtype(self):
        return self.base_brownian.dtype

    @property
    def shape(self):
        return self.base_brownian.shape

    @property
    def device(self):
        return self.base_brownian.device

    @property
    def levy_area_approximation(self):
        return self.base_brownian.levy_area_approximation


def _on_device(w0, kwargs):
    """``w0`` as a tensor on the device the path lives on: ``device=`` when
    given, else ``w0``'s own when it is a tensor, else the card (or a
    raise, through ``resolve_device``). Sets ``kwargs["device"]``."""
    device = kwargs.get("device")
    if device is None and torch.is_tensor(w0):
        device = w0.device
    kwargs["device"] = resolve_device(device)
    return torch.as_tensor(w0, device=kwargs["device"])


class _OffsetInterval(base.BaseBrownian):
    """A BrownianInterval whose point evaluation ``bm(t)`` adds ``w0``;
    intervals carry no offset."""

    def __call__(self, t, tb=None, return_U=False, return_A=False):
        out = self._interval(t, tb, return_U=return_U, return_A=return_A)
        if tb is None and not return_U and not return_A:
            out = out + self._w0
        return out

    def query_grid(self, grid, return_U=False, return_A=False):
        return self._interval.query_grid(grid, return_U=return_U,
                                         return_A=return_A)

    def query_pairs(self, points, pairs, return_U=False, return_A=False):
        return self._interval.query_pairs(points, pairs, return_U=return_U,
                                          return_A=return_A)

    def __repr__(self):
        return f"{self.__class__.__name__}(interval={self._interval})"

    @property
    def dtype(self):
        return self._interval.dtype

    @property
    def shape(self):
        return self._interval.shape

    @property
    def device(self):
        return self._interval.device

    @property
    def levy_area_approximation(self):
        return self._interval.levy_area_approximation


class BrownianPath(_OffsetInterval):
    """Brownian path with point evaluation from an initial offset ``w0``,
    whose shape and dtype the path takes. It lives on ``device``, else on
    ``w0``'s when ``w0`` is a tensor, else on the card."""

    def __init__(self, t0, w0, window_size=8, t1=None, **kwargs):
        del window_size  # deprecated in torchsde; unused here
        if t1 is None:
            t1 = float(t0) + 1
        self._w0 = _on_device(w0, kwargs)
        self._interval = BrownianInterval(t0=t0, t1=t1, size=tuple(self._w0.shape),
                                          dtype=self._w0.dtype, **kwargs)


class BrownianTree(_OffsetInterval):
    """Brownian tree with fixed entropy, query-order independent; ``w1``
    pins the value at ``t1``. Its device is chosen as ``BrownianPath``'s."""

    def __init__(self, t0, w0, t1=None, w1=None, entropy=None, tol=1e-6,
                 pool_size=24, cache_depth=9, safety=None, **kwargs):
        del pool_size, cache_depth, safety  # host-cache tuning; unused
        if t1 is None:
            t1 = float(t0) + 1
        w0 = _on_device(w0, kwargs)
        W = None if w1 is None else torch.as_tensor(w1, device=w0.device) - w0
        self._w0 = w0
        self._interval = BrownianInterval(t0=t0, t1=t1, size=tuple(w0.shape),
                                          dtype=w0.dtype, entropy=entropy, tol=tol,
                                          W=W, **kwargs)
