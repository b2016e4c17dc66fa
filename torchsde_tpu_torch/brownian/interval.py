"""Virtual Brownian motion on a dyadic tree with a counter-based PRNG
(counterpart of ``torchsde_tpu/brownian/interval.py``).

A query ``(ta, tb)`` descends the dyadic tree over ``[t0, t1]`` once for
each endpoint. Each descent carries the prefix increment ``W(t0, t)`` and
the prefix time integral ``I(t) = \\int_{t0}^{t} (W_u - W_{t0}) du``,
splitting every node's ``(W, H)`` at its midpoint by the exact Brownian
bridge (no H) or space-time Levy bridge (with H); a child's key is its
parent's with the branch bit folded in (``threefry.fold_in``), so the
sampler is query-order independent and additive
(``W(a, b) + W(b, c) == W(a, c)`` to rounding). The full Levy area A is
Davie's or Foster's approximation with antisymmetric noise keyed by the two
endpoints' packed branch bits.

Times resolve into branch bits by successive float64 midpoint comparisons:
on the host for Python floats, numpy values and CPU tensors (the descent
then stops at the depth the times need), and on their own device for a
CUDA tensor of times (all ``levels`` levels, no host sync). Both give the
same bits, and the same bits and keys as the JAX package under x64.

The JAX package runs the descent under ``jit``/``vmap``; here it is a loop
over levels, each level's tensors batched over the query points, the
points taken in chunks so the hash's int32 temporaries stay within
``DESCENT_CHUNK_ELEMENTS`` each. The JAX package's per-depth compile caches
(``_cprefix_cache``, ``_cquery_cache``, ``_bucket_bits``) have no
counterpart: nothing here is compiled.

``dt``, ``cache_size``, ``pool_size`` and ``halfway_tree`` are accepted and
unused, as in the JAX package.
"""

import math
import warnings

import numpy as np
import torch

from . import base, threefry
from ..settings import LEVY_AREA_APPROXIMATIONS
from ..utils.misc import resolve_device

_RSQRT3 = 1.0 / math.sqrt(3.0)
# One leaf at depth 52 is span * 2**-52, the float64 resolution of the span.
_MAX_LEVELS = 52
_DEFAULT_LEVELS = 52
# Elements of one level's draw (points x the draw's shape) a chunk of the
# descent holds: each int32 temporary of the hash is 256 MiB at this count.
DESCENT_CHUNK_ELEMENTS = 1 << 26
_HAVE_H = (LEVY_AREA_APPROXIMATIONS.space_time, LEVY_AREA_APPROXIMATIONS.davie,
           LEVY_AREA_APPROXIMATIONS.foster)
_HAVE_A = (LEVY_AREA_APPROXIMATIONS.davie, LEVY_AREA_APPROXIMATIONS.foster)


def np_dtype(dtype):
    """The numpy scalar type of a torch float dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def as_torch_dtype(dtype):
    """A torch float dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[
        np.dtype(dtype).name]


def as_key(key, device):
    """The port's key (int64 words, (2,)) from a key tensor or a numpy
    uint32 array such as ``np.asarray(jax.random.PRNGKey(s))``."""
    if not torch.is_tensor(key):
        key = torch.as_tensor(np.asarray(key).astype(np.int64))
    return (key.to(device=device, dtype=torch.int64) & threefry.MASK)


def on_host(x):
    """Does ``x`` resolve on the host: a Python number, a numpy value or a
    CPU tensor (not a CUDA tensor)?"""
    if torch.is_tensor(x):
        return x.device.type == "cpu"
    return isinstance(x, (int, float, np.ndarray, np.generic, list, tuple))


def _ret(W, U, A, return_U, return_A):
    if return_U and return_A:
        return W, U, A
    if return_U:
        return W, U
    if return_A:
        return W, A
    return W


class BrownianInterval(base.BaseBrownian):
    """Queryable virtual Brownian motion: ``bm(ta, tb) -> W(tb) - W(ta)``.

    Lives on ``device`` (the card unless given; the device of ``W`` or
    ``H`` when they are tensors)."""

    def __init__(self,
                 t0=0.0,
                 t1=1.0,
                 size=None,
                 dtype=None,
                 entropy=None,
                 key=None,
                 dt=None,
                 tol=0.0,
                 pool_size=8,
                 cache_size=45,
                 halfway_tree=False,
                 levy_area_approximation=LEVY_AREA_APPROXIMATIONS.none,
                 levels=None,
                 W=None,
                 H=None,
                 device=None):
        del dt, pool_size, cache_size, halfway_tree  # API parity; unused here.
        t0 = float(t0)
        t1 = float(t1)
        if t0 >= t1:
            raise ValueError(f"Initial time {t0} should be less than terminal time {t1}.")
        if levy_area_approximation not in LEVY_AREA_APPROXIMATIONS:
            raise ValueError(
                f"`levy_area_approximation` must be one of {LEVY_AREA_APPROXIMATIONS}, "
                f"but got '{levy_area_approximation}'.")

        if size is None:
            for tensor in (W, H):
                if tensor is not None:
                    size = tuple(tensor.shape)
                    break
        if size is None:
            raise ValueError("Must either specify `size` or pass in `W` or `H` to "
                             "implicitly define the size.")
        size = tuple(int(s) for s in size)
        if dtype is None:
            given = W if W is not None else H
            dtype = given.dtype if given is not None else torch.float32
        dtype = as_torch_dtype(dtype)
        if device is None:
            given = [x for x in (W, H) if torch.is_tensor(x)]
            device = given[0].device if given else None
        device = resolve_device(device)

        if levels is None:
            if tol and tol > 0.0:
                levels = max(0, min(_MAX_LEVELS, int(math.ceil(math.log2((t1 - t0) / tol)))))
            else:
                levels = _DEFAULT_LEVELS
        levels = int(levels)
        if not (0 <= levels <= _MAX_LEVELS):
            raise ValueError(f"`levels` must be in [0, {_MAX_LEVELS}], got {levels}.")

        if key is None:
            if entropy is None:
                entropy = int(np.random.randint(0, 2 ** 31 - 1))
            key = threefry.prng_key(int(entropy), device)
        key = as_key(key, device)
        device = key.device  # with its index: torch.device("cuda:0")
        self._key = key
        self._entropy = entropy
        self._device = device

        self._t0 = t0
        self._t1 = t1
        self._size = size
        self._dtype = dtype
        self._levels = levels
        self._tol = float(tol)
        self._levy_area_approximation = levy_area_approximation
        self._have_H = levy_area_approximation in _HAVE_H
        self._have_A = levy_area_approximation in _HAVE_A

        # Root increment / space-time Levy area over [t0, t1].
        span = t1 - t0
        key_w, key_h, self._key_nodes, self._key_a = threefry.split(key, 4)
        if W is None:
            W = threefry.normal(key_w, size, dtype) * math.sqrt(span)
        else:
            W = torch.as_tensor(W, dtype=dtype, device=device)
        if H is None:
            if self._have_H:
                H = threefry.normal(key_h, size, dtype) * math.sqrt(span / 12.0)
            else:
                H = torch.zeros(size, dtype=dtype, device=device)
        else:
            H = torch.as_tensor(H, dtype=dtype, device=device)
        self._W_root = W
        self._H_root = H

    # ------------------------------------------------------------------ #
    #  Properties                                                        #
    # ------------------------------------------------------------------ #

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
    def levels(self):
        return self._levels

    @property
    def tol(self):
        return self._tol

    @property
    def t0(self):
        return self._t0

    @property
    def t1(self):
        return self._t1

    def __repr__(self):
        return (f"{self.__class__.__name__}(t0={self._t0:.3f}, t1={self._t1:.3f}, "
                f"size={self._size}, dtype={self._dtype}, entropy={self._entropy}, "
                f"levels={self._levels}, "
                f"levy_area_approximation={self._levy_area_approximation!r})")

    # ------------------------------------------------------------------ #
    #  Time resolution                                                   #
    # ------------------------------------------------------------------ #

    def _bits(self, times, trim=False):
        """Resolve 1-D float64 ``times`` into dyadic branch bits by
        successive exact float64 midpoint comparisons, on the times' own
        device. Returns ``(bits, starts, full)``: ``bits`` an ``(n, depth)``
        int64 matrix, ``starts`` the quantised (floor) times, ``t1`` where
        ``full``, the ``t >= t1`` mask. Points at t1 descend all-left and
        are patched with the root's statistics (``full``). ``depth`` is
        ``levels``, or with ``trim`` the depth the times need (a host sync
        on a device)."""
        t = times.clamp(self._t0, self._t1)
        full = t >= self._t1
        t = torch.where(full, torch.full_like(t, self._t0), t)
        start = torch.full_like(t, self._t0)
        span = self._t1 - self._t0
        bits = []
        for half in span * np.exp2(-np.arange(1, self._levels + 1,
                                              dtype=np.float64)):
            mid = start + float(half)
            # mid > start guards ulp saturation: once half underflows below
            # ulp(start) the time is resolved and all deeper bits are 0.
            b = (t >= mid) & (mid > start)
            bits.append(b)
            start = torch.where(b, mid, start)
        bits = (torch.stack(bits, dim=1).to(torch.int64) if bits else
                torch.zeros((t.shape[0], 0), dtype=torch.int64,
                            device=t.device))
        if trim:
            nz = bits.any(dim=0).nonzero()
            bits = bits[:, :int(nz[-1]) + 1 if len(nz) else 0]
        start = torch.where(full, torch.full_like(start, self._t1), start)
        return bits, start, full

    def _resolve(self, times):
        """:meth:`_bits` of ``times``: host times resolve on the host (CPU
        tensors, trimmed to the depth they need), a CUDA tensor of times on
        this device (all ``levels`` levels, no host sync)."""
        if on_host(times):
            return self._bits(torch.as_tensor(
                np.asarray(times, np.float64).reshape(-1)), trim=True)
        return self._bits(times.reshape(-1).to(self._device, torch.float64))

    # ------------------------------------------------------------------ #
    #  Dyadic descent                                                    #
    # ------------------------------------------------------------------ #

    def _words(self, bits):
        """Branch bits packed 30 to an int64 word (level i -> word i // 30,
        bit i % 30). The word count comes from ``levels``, not from the
        trimmed depth, so one interval's Levy-area key does not depend on
        the context it was queried in."""
        n_words = max(1, -(-self._levels // 30))
        depth = bits.shape[1]
        words = torch.zeros((bits.shape[0], n_words), dtype=torch.int64,
                            device=bits.device)
        for w in range(min(n_words, -(-depth // 30))):
            chunk = bits[:, 30 * w:30 * (w + 1)]
            pos = torch.arange(chunk.shape[1], dtype=torch.int64,
                               device=bits.device)
            words[:, w] = (chunk << pos).sum(dim=1)
        return words

    def _prefix(self, bits, full):
        """Prefix statistics at the dyadic points given by ``bits`` (an
        ``(n, depth)`` int64 tensor on this device) and ``full`` (``(n,)``
        bool). Returns ``(w_pref, i_pref, words)``: ``W(t0, t_q)`` and
        ``\\int_{t0}^{t_q} (W_u - W_{t0}) du`` (``(n, *size)``; ``i_pref``
        is None without H) and the packed branch bits (``(n, n_words)``,
        -1 where ``full``)."""
        n, depth = bits.shape
        dtype, size, have_H = self._dtype, self._size, self._have_H
        draw = (2,) + size if have_H else size
        per_point = max(1, math.prod(draw))
        chunk = max(1, DESCENT_CHUNK_ELEMENTS // per_point)
        npd = np_dtype(dtype)
        span = self._t1 - self._t0
        widths = span * np.exp2(-np.arange(depth, dtype=np.float64))
        hs = widths.astype(npd)
        sqrt_hs = np.sqrt(widths).astype(npd)
        bshape = (-1,) + (1,) * len(size)

        w_prefs = torch.empty((n,) + size, dtype=dtype, device=self._device)
        i_prefs = torch.empty_like(w_prefs) if have_H else None
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            p = hi - lo
            w_pref = torch.zeros((p,) + size, dtype=dtype, device=self._device)
            i_pref = torch.zeros_like(w_pref) if have_H else None
            w_node = self._W_root.expand((p,) + size)
            h_node = self._H_root.expand((p,) + size)
            key = self._key_nodes.expand(p, 2)
            for level in range(depth):
                bit = bits[lo:hi, level]
                go = bit.bool().reshape(bshape)
                h, sqrt_h = hs[level], sqrt_hs[level]
                hl = float(npd(0.5) * h)
                if have_H:
                    xs = threefry.normal(key, draw, dtype)
                    x1, x2 = xs[:, 0], xs[:, 1]
                    # Midpoint split of (W, H):
                    #   W_l = W/2 + (3/2) H + (sqrt(h)/4) X1
                    #   H_l = H/4 - (sqrt(h)/8) X1 + (sqrt(h)/(4 sqrt 3)) X2
                    #   W_r = W - W_l
                    #   H_r = H/4 - (sqrt(h)/8) X1 - (sqrt(h)/(4 sqrt 3)) X2
                    w_left = (0.5 * w_node + 1.5 * h_node
                              + float(npd(0.25) * sqrt_h) * x1)
                    h_common = 0.25 * h_node - float(npd(0.125) * sqrt_h) * x1
                    h_anti = float(npd(0.25 * _RSQRT3) * sqrt_h) * x2
                    h_left = h_common + h_anti
                    h_right = h_common - h_anti
                    w_right = w_node - w_left
                    # Passing over the left child adds its increment and
                    # \int_s^m W_u du = hl W(s) + hl (W_l / 2 + H_l).
                    u_left = hl * (0.5 * w_left + h_left)
                    i_pref = torch.where(go, i_pref + hl * w_pref + u_left,
                                         i_pref)
                    h_node = torch.where(go, h_right, h_left)
                else:
                    x1 = threefry.normal(key, size, dtype)
                    # Brownian bridge at the midpoint: W_l ~ N(W/2, h/4).
                    w_left = 0.5 * w_node + float(npd(0.5) * sqrt_h) * x1
                    w_right = w_node - w_left
                w_pref = torch.where(go, w_pref + w_left, w_pref)
                w_node = torch.where(go, w_right, w_left)
                key = threefry.fold_in(key, bit)
            w_prefs[lo:hi] = w_pref
            if have_H:
                i_prefs[lo:hi] = i_pref

        # full is the right edge of the root: patch in its exact statistics.
        full_b = full.reshape(bshape)
        w_prefs = torch.where(full_b, self._W_root, w_prefs)
        if have_H:
            i_full = span * (0.5 * self._W_root + self._H_root)
            i_prefs = torch.where(full_b, i_full, i_prefs)
        words = self._words(bits).masked_fill_(full[:, None], -1)
        return w_prefs, i_prefs, words

    def _prefix_at(self, times):
        """Resolve ``times`` and descend: ``(w_pref, i_pref, words,
        starts)``, ``starts`` on the CPU for host times and on the device
        for device times."""
        bits, starts, full = self._resolve(times)
        w_prefs, i_prefs, words = self._prefix(bits.to(self._device),
                                               full.to(self._device))
        return w_prefs, i_prefs, words, starts

    # ------------------------------------------------------------------ #
    #  Query                                                             #
    # ------------------------------------------------------------------ #

    def _pair_stats(self, w_a, i_a, w_b, i_b, words_a, words_b, h,
                    degenerate, return_A):
        """Interval statistics from two prefix descents, batched over a
        leading axis where the inputs have one. ``h`` (in this dtype) and
        ``degenerate`` broadcast against ``W``. Returns ``(W, U, A)``."""
        W, H, U = base.interval_stats(w_a, i_a, w_b, i_b, h, degenerate)
        A = None
        if self._have_A and return_A:
            A = self._levy_area(words_a, words_b, W, H, h, degenerate)
        return W, U, A

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        if tb is None:
            warnings.warn(f"{self.__class__.__name__} is optimised for interval-based "
                          f"queries, not point evaluation.")
            ta, tb = self._t0, ta

        if on_host(ta) and on_host(tb):
            fa, fb = float(ta), float(tb)
            if fa < self._t0 or fb < self._t0:
                warnings.warn(f"Query times should be >= t0={self._t0}; clamping.")
            if fa > self._t1 or fb > self._t1:
                warnings.warn(f"Query times should be <= t1={self._t1}; clamping.")
            if fa > fb:
                raise RuntimeError(f"Query times ta={fa:.3f} and tb={fb:.3f} must "
                                   f"respect ta <= tb.")
            w, i, words, eff = self._prefix_at([fa, fb])
            h_exact = float(eff[1] - eff[0])
            h = torch.tensor(h_exact, dtype=self._dtype, device=self._device)
            degenerate = torch.tensor(h_exact == 0.0, device=self._device)
        else:
            ta = torch.as_tensor(ta, dtype=torch.float64, device=self._device)
            tb = torch.as_tensor(tb, dtype=torch.float64, device=self._device)
            ta = ta.clamp(self._t0, self._t1)
            tb = torch.maximum(ta, tb.clamp(self._t0, self._t1))
            w, i, words, starts = self._prefix_at(torch.stack([ta, tb]))
            h = (starts[1] - starts[0]).to(self._dtype)
            degenerate = starts[1] == starts[0]
        i_a, i_b = (None, None) if i is None else (i[0], i[1])
        W, U, A = self._pair_stats(w[0], i_a, w[1], i_b, words[0], words[1],
                                   h, degenerate, return_A)
        return _ret(W, U, A, return_U, return_A)

    def query_pairs(self, points, pairs, return_U=False, return_A=False):
        """Several intervals over shared endpoints, one descent a point.

        ``points`` is a 1-D sequence of times (host values, or a CUDA
        tensor that resolves on the card without a host sync); ``pairs`` a
        sequence of ``(ia, ib)`` index pairs with ``points[ia] <=
        points[ib]``. Returns one result per pair in ``__call__``'s format,
        bitwise what ``__call__`` gives for the pair. An inverted pair
        gives the degenerate zero result."""
        w, i, words, starts = self._prefix_at(points)
        starts = starts.to(self._device)
        out = []
        for ia, ib in pairs:
            h = (starts[ib] - starts[ia]).to(self._dtype)
            degenerate = starts[ib] <= starts[ia]
            i_a, i_b = (None, None) if i is None else (i[ia], i[ib])
            W, U, A = self._pair_stats(w[ia], i_a, w[ib], i_b, words[ia],
                                       words[ib], h, degenerate, return_A)
            out.append(_ret(W, U, A, return_U, return_A))
        return out

    def query_grid(self, grid, return_U=False, return_A=False):
        """All ``len(grid) - 1`` consecutive increments of a 1-D grid in one
        pass: one descent per grid point (not two per cell), bitwise what
        ``__call__`` gives for each cell. A host grid resolves on the host;
        a float64 CUDA tensor of times resolves on the card with no host
        read, as ``__call__`` resolves one. Returns ``(W, U, A)`` with
        leading dimension ``len(grid) - 1``, ``U``/``A`` None unless
        requested."""
        if on_host(grid):
            grid = np.asarray(grid, np.float64)
        w, i, words, eff = self._prefix_at(grid)
        cells = torch.diff(eff).to(self._device)
        bshape = (-1,) + (1,) * len(self._size)
        h = cells.to(self._dtype).reshape(bshape)
        degenerate = (cells == 0.0).reshape(bshape)
        i_a, i_b = (None, None) if i is None else (i[:-1], i[1:])
        W, U, A = self._pair_stats(w[:-1], i_a, w[1:], i_b, words[:-1],
                                   words[1:], h, degenerate, return_A)
        return W, (U if return_U else None), (A if return_A else None)

    def _levy_area(self, words_a, words_b, W, H, h, degenerate):
        """Davie/Foster approximation of the full Levy area over the queried
        cells (``base.levy_area``), with antisymmetric noise keyed by the
        packed branch bits of the two endpoints. Batched over any leading
        axes of the words (``(..., n_words)``) and of ``W``, ``H``
        (``(..., *size)``). The JAX package zeroes A's diagonal again
        because ``jit`` may fuse it into an FMA; here it is exactly zero."""
        if len(self._size) in (0, 1):
            # Zero- or one-dimensional size: a batch of scalar Brownian
            # motions, whose Levy area is identically zero.
            return torch.zeros_like(W)
        key = self._key_a
        for w in torch.cat([words_a, words_b], dim=-1).unbind(-1):
            key = threefry.fold_in(key, w)
        noise = threefry.normal(key, (*self._size, self._size[-1]),
                                self._dtype)
        return base.levy_area(W, H, h, noise, self._levy_area_approximation,
                              degenerate)

def brownian_interval_like(y, t0=0.0, t1=1.0, size=None, dtype=None, **kwargs):
    """A BrownianInterval with the size, dtype and device of a tensor."""
    size = tuple(y.shape) if size is None else size
    dtype = y.dtype if dtype is None else dtype
    kwargs.setdefault("device", y.device)
    return BrownianInterval(t0=t0, t1=t1, size=size, dtype=dtype, **kwargs)
