"""Whole-solve kernels for SDEs whose drift and diffusion are MLP towers
(counterpart of ``torchsde_tpu/ops/fused_solve.py``).

Describe the drift and the diffusion as :class:`TowerSpec` towers (any
depth, every width at most 128, activations from {softplus, tanh, sigmoid,
lipswish, linear}) and :func:`fused_sdeint` runs the whole fixed-step solve
as one launch of a hand-written CUDA kernel, and its gradient as one launch
of a reverse-sweep kernel:

* ``method='euler'`` (Itô), diagonal or general noise:
  ``y1 = y0 + dt f(t0, [t0? | y0]) + g . dW`` (``csrc/tower_euler_fwd.cu``,
  its sweep ``csrc/tower_euler_bwd.cu``);
* ``method='reversible_heun'`` (Stratonovich), carrying ``(y, z, f, g)``::

      z1 = 2 y - z + dt f0 + g0 . dW
      (f1, g1) = towers(t1, z1)
      y1 = y + dt/2 (f0 + f1) + (g0 + g1) . dW/2

  (``csrc/tower_rh_fwd.cu``), whose sweep (``csrc/tower_rh_bwd.cu``) carries
  the cotangents ``(ay, az, af, ag)`` from the last step to the first and
  recomputes the towers at the stored ``z_{n+1}``::

      ay += gy_n;  Af = af + dt/2 ay;  Ag = ag + ay dW/2
      Az = az + (the towers' input cotangent of Af, Ag)
      dW_n = Az g_n + ay (g_n + g_{n+1})/2
      ay <- ay + 2 Az;  az <- -Az;  af <- dt/2 ay + dt Az
      ag <- (ay/2 + Az) dW

Here ``g . dW`` is ``g * dW`` for diagonal noise and the per-row ``(S, m) @
(m)`` product for general noise, whose diffusion tower outputs the row-major
flattening of ``(S, m)``. ``with_time=True`` feeds ``t`` as the towers' first
input column.

:func:`fused_sdeint_logqp` adds a prior-drift tower ``h`` and the KL
channel of ``sdeint(..., logqp=True)``: Euler (Itô), diagonal noise, with
``gs`` the diffusion clamped away from zero with its sign kept (as
``utils/misc.stable_division``)::

    u = (f - h) / gs;  q1 = q0 + dt/2 sum_i u_i^2;  y1 = y0 + dt f + g dW

(``csrc/tower_euler_logqp_fwd.cu``, its sweep
``csrc/tower_euler_logqp_bwd.cu``, which takes the reverse cumulative sum
of the cotangents of ``q``).

The noise is the one ``sdeint(..., generator=)`` draws
(``core/integrate.py:sample_grid_noise``), so the fused and the ``sdeint``
routes of one generator seed solve with the same increments. For reversible
Heun the initial evaluations ``f0, g0`` run as plain PyTorch outside the
kernels, so step 0 differentiates through autograd, as the JAX package runs
them in XLA.

The kernels read each tower as one flat, unpadded float32 pack
(:meth:`TowerSpec.pack`) and a small int32 layer table (each layer's input
and output widths and activation code): the TPU kernels' 128-lane padding
and 0/1 tile matrices are not ported. A CPU tensor goes to the kernels'
plain versions (:func:`euler_solve_forward_plain`,
:func:`euler_solve_backward_plain`, :func:`rh_solve_forward_plain`,
:func:`rh_solve_backward_plain`, :func:`euler_logqp_solve_forward_plain`,
:func:`euler_logqp_solve_backward_plain`: the same math as loops of PyTorch
operators); a CUDA tensor goes to the kernels, which raise rather than fall
back. ``euler_launches``, ``euler_bwd_launches``, ``rh_launches``,
``rh_bwd_launches``, ``logqp_launches`` and ``logqp_bwd_launches`` count
the kernels' launches.
"""

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .gan_fused import time_column
from ..core import base_sde, integrate
from ..core.sdeint import host_times
from ..models.layers import softplus
from ..utils.misc import check_kernel_tensor

# Launches of the six kernels since import (or since a caller reset them).
euler_launches = 0
euler_bwd_launches = 0
rh_launches = 0
rh_bwd_launches = 0
logqp_launches = 0
logqp_bwd_launches = 0

ACTS = ("softplus", "tanh", "sigmoid", "lipswish", "linear")
# Every tower width: the kernels give each output unit of a layer one
# thread of its tower's 128, and keep each layer's activations for a row
# tile in shared memory.
MAX_WIDTH = 128

# Kernel kinds of the C interface's tsde_tower_smem_bytes.
EULER_FWD, EULER_BWD, RH_FWD, RH_BWD, EULER_LOGQP_FWD, EULER_LOGQP_BWD = \
    range(6)
# stable_division's clamp of the diffusion in the KL integrand.
EPS = 1e-7


class TowerSpec:
    """Declarative MLP tower: ``[(W, b, act), ...]`` with act in
    {softplus, tanh, sigmoid, lipswish, linear}. ``W``: (in, out) tensors.

    Build from the library layers with :meth:`from_mlp` /
    :meth:`from_lipmlp`. Gradients of a solve reach the tensors given here.
    """

    def __init__(self, layers):
        for i, (w, b, act) in enumerate(layers):
            if act not in ACTS:
                raise ValueError(f"unknown activation {act!r} (use {ACTS})")
            if max(w.shape) > MAX_WIDTH or b.shape[0] > MAX_WIDTH:
                raise ValueError(f"tower dims must be <= {MAX_WIDTH}")
            if b.shape[0] != w.shape[1]:
                raise ValueError(
                    f"layer {i}: bias width {b.shape[0]} != weight output "
                    f"width {w.shape[1]}")
            if i > 0 and w.shape[0] != layers[i - 1][0].shape[1]:
                raise ValueError(
                    f"layer {i}: input width {w.shape[0]} does not chain from "
                    f"layer {i - 1} output width {layers[i - 1][0].shape[1]}")
        self.layers = list(layers)
        self.in_size = layers[0][0].shape[0]
        self.out_size = layers[-1][0].shape[1]

    @classmethod
    def from_mlp(cls, mlp, hidden_act="softplus", final_act="linear"):
        """From models.layers.MLP (hidden activations between Linears)."""
        ls = mlp.layers
        return cls([(l.w, l.b, hidden_act if i < len(ls) - 1 else final_act)
                    for i, l in enumerate(ls)])

    @classmethod
    def from_lipmlp(cls, mlp):
        """From models.sde_gan.LipMLP (lipswish hidden, optional tanh)."""
        ls = mlp.layers
        final = "tanh" if mlp.tanh else "linear"
        return cls([(l.w, l.b, "lipswish" if i < len(ls) - 1 else final)
                    for i, l in enumerate(ls)])

    def pack(self):
        """The tower as the kernels read it: every layer's W (row-major
        (in, out)) then its b, back to back in one 1-D tensor.
        Differentiable."""
        return torch.cat([t.reshape(-1) for (w, b, _) in self.layers
                          for t in (w, b)])

    @property
    def acts(self):
        return tuple(act for (_, _, act) in self.layers)

    @property
    def shapes(self):
        """``((in, out, act), ...)`` of the layers."""
        return tuple((w.shape[0], w.shape[1], act)
                     for (w, _, act) in self.layers)


class SolveSpec(NamedTuple):
    """What a whole solve's kernels need to know of its towers and noise:
    each tower's ``((in, out, act), ...)`` (``prior`` empty but for the
    logqp solve), the state width S, the noise channels m (S for diagonal
    noise), and whether the towers see a time column."""
    drift: tuple
    diffusion: tuple
    S: int
    m: int
    diag: bool
    with_time: bool
    prior: tuple = ()

    @property
    def gwidth(self):
        """The diffusion tower's output width: S, or S*m for general
        noise."""
        return self.S if self.diag else self.S * self.m


def solve_spec(drift, diffusion, S, m, diag, with_time, prior=None):
    return SolveSpec(drift.shapes, diffusion.shapes, S, m, bool(diag),
                     bool(with_time), prior.shapes if prior else ())


# --------------------------------------------------------------------------- #
#  Plain tower math                                                           #
# --------------------------------------------------------------------------- #

def apply_act(pre, act):
    if act == "softplus":
        return softplus(pre)
    if act == "tanh":
        return torch.tanh(pre)
    if act == "sigmoid":
        return torch.sigmoid(pre)
    if act == "lipswish":
        return 0.909 * pre * torch.sigmoid(pre)
    return pre


def act_bwd(dout, pre, out, act):
    """d pre given d out; uses pre or out, whichever is cheaper."""
    if act == "softplus":
        return dout * (1.0 - torch.exp(-out))
    if act == "tanh":
        return dout * (1.0 - out * out)
    if act == "sigmoid":
        return dout * out * (1.0 - out)
    if act == "lipswish":
        sig = torch.sigmoid(pre)
        return dout * (0.909 * (sig + pre * sig * (1.0 - sig)))
    return dout


def tower_forward(x, weights, acts):
    """x (B, in); weights ``[(W, b), ...]``. Returns (out, cache) where
    cache holds each layer's (pre, out)."""
    cache = []
    h = x
    for (w, b), act in zip(weights, acts):
        pre = h @ w + b
        h = apply_act(pre, act)
        cache.append((pre, h))
    return h, cache


def tower_backward(dout, cache, x, weights, acts):
    """VJP of :func:`tower_forward`: returns d x and the weights' gradients
    ``[dW0, db0, dW1, db1, ...]``."""
    grads = [None] * (2 * len(weights))
    d = dout
    for i in range(len(weights) - 1, -1, -1):
        pre, out = cache[i]
        d = act_bwd(d, pre, out, acts[i])
        inp = cache[i - 1][1] if i > 0 else x
        grads[2 * i] = inp.T @ d
        grads[2 * i + 1] = d.sum(0)
        d = d @ weights[i][0].T
    return d, grads


def unpack(flat, shapes):
    """Views ``[(W, b), ...]`` of a tower pack."""
    out, at = [], 0
    for n_in, n_out, _ in shapes:
        w = flat[at:at + n_in * n_out].view(n_in, n_out)
        at += n_in * n_out
        out.append((w, flat[at:at + n_out]))
        at += n_out
    return out


def pack_size(shapes):
    return sum(n_in * n_out + n_out for n_in, n_out, _ in shapes)


def tower_input(t, y, with_time):
    """``[t | y]`` with ``with_time``, else ``y``: the towers' input."""
    return time_column(t, y) if with_time else y


def _acts(shapes):
    return tuple(act for _, _, act in shapes)


def _noise_prod(g, dW, spec):
    """``g . dW``: ``g * dW`` for diagonal noise, the per-row (S, m) @ (m)
    product for general noise."""
    if spec.diag:
        return g * dW
    B = g.shape[0]
    return torch.einsum("bsm,bm->bs", g.reshape(B, spec.S, spec.m), dW)


def _noise_outer(a, dW, spec):
    """The cotangent of g in ``a . (g . dW)``: ``a * dW`` or, for general
    noise, the flattened outer product ``a[i] dW[j]``."""
    if spec.diag:
        return a * dW
    return (a[:, :, None] * dW[:, None, :]).reshape(a.shape[0], -1)


def _noise_vjp(a, g, spec):
    """The cotangent of dW in ``a . (g . dW)``: ``a * g`` or, for general
    noise, ``sum_i a[i] g[i, j]``."""
    if spec.diag:
        return a * g
    B = g.shape[0]
    return torch.einsum("bs,bsm->bm", a, g.reshape(B, spec.S, spec.m))


# --------------------------------------------------------------------------- #
#  Plain versions of kernels 9-12                                             #
# --------------------------------------------------------------------------- #

def euler_solve_forward_plain(y0, noise, t0s, dts, fw, gw, spec):
    """Kernel 9 as a loop of PyTorch operators (the JAX package's
    ``_euler_fwd_kernel``).

    y0 (B,S); noise (N,B,m); t0s, dts (N,); fw, gw the towers' packs.
    Returns ys (N,B,S), the state after each step."""
    fl, gl = unpack(fw, spec.drift), unpack(gw, spec.diffusion)
    facts, gacts = _acts(spec.drift), _acts(spec.diffusion)
    y, ys = y0, []
    for n in range(noise.shape[0]):
        x = tower_input(t0s[n], y, spec.with_time)
        f = tower_forward(x, fl, facts)[0]
        g = tower_forward(x, gl, gacts)[0]
        y = y + dts[n] * f + _noise_prod(g, noise[n], spec)
        ys.append(y)
    return torch.stack(ys)


def _cat_grads(grads):
    return torch.cat([g.reshape(-1) for g in grads])


def euler_solve_backward_plain(y0, noise, t0s, dts, fw, gw, spec, ys, gy):
    """Kernel 10 as a loop of PyTorch operators: the reverse sweep of the
    JAX package's ``_euler_bwd_kernel``, which recomputes both towers at
    each step's pre-step state.

    Takes the forward's inputs, its ys and the cotangent gy (N,B,S) of ys.
    Returns dy0 (B,S), dnoise (N,B,m) and the packs' gradients dfw, dgw."""
    fl, gl = unpack(fw, spec.drift), unpack(gw, spec.diffusion)
    facts, gacts = _acts(spec.drift), _acts(spec.diffusion)
    wt = 1 if spec.with_time else 0
    N = noise.shape[0]
    dy = torch.zeros_like(y0)
    dnoise = torch.empty_like(noise)
    dfw = [torch.zeros_like(t) for wb in fl for t in wb]
    dgw = [torch.zeros_like(t) for wb in gl for t in wb]
    for n in reversed(range(N)):
        y = y0 if n == 0 else ys[n - 1]
        x = tower_input(t0s[n], y, spec.with_time)
        _, fcache = tower_forward(x, fl, facts)
        g, gcache = tower_forward(x, gl, gacts)
        dy = dy + gy[n]
        dnoise[n] = _noise_vjp(dy, g, spec)
        dxf, gf = tower_backward(dy * dts[n], fcache, x, fl, facts)
        dxg, gg = tower_backward(_noise_outer(dy, noise[n], spec), gcache, x,
                                 gl, gacts)
        for acc, d in zip(dfw + dgw, gf + gg):
            acc += d
        dy = dy + (dxf + dxg)[:, wt:]
    return dy, dnoise, _cat_grads(dfw), _cat_grads(dgw)


def rh_solve_forward_plain(y0, f0, g0, noise, t1s, dts, fw, gw, spec):
    """Kernel 11 as a loop of PyTorch operators (the JAX package's
    ``_rh_fwd_kernel``).

    y0, f0 (B,S); g0 (B, S or S*m), the towers at the first time; noise
    (N,B,m); t1s, dts (N,). Returns ys, zs (N,B,S) and gs (N,B, S or S*m):
    the state, the evaluation point and the diffusion after each step."""
    fl, gl = unpack(fw, spec.drift), unpack(gw, spec.diffusion)
    facts, gacts = _acts(spec.drift), _acts(spec.diffusion)
    y, z, f, g = y0, y0, f0, g0
    ys, zs, gs = [], [], []
    for n in range(noise.shape[0]):
        dt, dW = dts[n], noise[n]
        z1 = 2.0 * y - z + dt * f + _noise_prod(g, dW, spec)
        x = tower_input(t1s[n], z1, spec.with_time)
        f1 = tower_forward(x, fl, facts)[0]
        g1 = tower_forward(x, gl, gacts)[0]
        y = y + 0.5 * dt * (f + f1) + _noise_prod(g + g1, 0.5 * dW, spec)
        z, f, g = z1, f1, g1
        ys.append(y)
        zs.append(z)
        gs.append(g)
    return torch.stack(ys), torch.stack(zs), torch.stack(gs)


def rh_solve_backward_plain(y0, f0, g0, noise, t1s, dts, fw, gw, spec, zs, gs,
                            gy):
    """Kernel 12 as a loop of PyTorch operators: the ``(ay, az, af, ag)``
    recurrence of the JAX package's ``_rh_bwd_kernel``, which recomputes the
    towers at each step's stored ``z_{n+1}`` and reads ``g_n`` and
    ``g_{n+1}`` from ``gs`` with ``g0`` in front.

    Takes the forward's inputs, its zs, gs and the cotangent gy (N,B,S) of
    ys. Returns dy0, df0 (B,S), dg0 (B, S or S*m), dnoise (N,B,m) and the
    packs' gradients dfw, dgw."""
    fl, gl = unpack(fw, spec.drift), unpack(gw, spec.diffusion)
    facts, gacts = _acts(spec.drift), _acts(spec.diffusion)
    wt = 1 if spec.with_time else 0
    N = noise.shape[0]
    g_all = torch.cat([g0[None], gs])
    ay, az, af = (torch.zeros_like(y0) for _ in range(3))
    ag = torch.zeros_like(g0)
    dnoise = torch.empty_like(noise)
    dfw = [torch.zeros_like(t) for wb in fl for t in wb]
    dgw = [torch.zeros_like(t) for wb in gl for t in wb]
    for n in reversed(range(N)):
        dt, dW = dts[n], noise[n]
        ay = ay + gy[n]
        Af = af + 0.5 * dt * ay
        Ag = ag + _noise_outer(ay, 0.5 * dW, spec)
        x = tower_input(t1s[n], zs[n], spec.with_time)
        _, fcache = tower_forward(x, fl, facts)
        _, gcache = tower_forward(x, gl, gacts)
        dxf, gf = tower_backward(Af, fcache, x, fl, facts)
        dxg, gg = tower_backward(Ag, gcache, x, gl, gacts)
        for acc, d in zip(dfw + dgw, gf + gg):
            acc += d
        Az = az + (dxf + dxg)[:, wt:]
        g_n, g_next = g_all[n], g_all[n + 1]
        dnoise[n] = _noise_vjp(Az, g_n, spec) + _noise_vjp(
            0.5 * ay, g_n + g_next, spec)
        ay, az, af, ag = (ay + 2.0 * Az, -Az, 0.5 * dt * ay + dt * Az,
                          _noise_outer(0.5 * ay + Az, dW, spec))
    return ay + az, af, ag, dnoise, _cat_grads(dfw), _cat_grads(dgw)


# --------------------------------------------------------------------------- #
#  Plain versions of kernels 13 and 14 (Euler logqp)                          #
# --------------------------------------------------------------------------- #

def _clamped(g):
    """stable_division's denominator and mask: ``g`` where ``|g| > EPS``,
    else ``EPS`` with the sign of ``g`` (``sign(0) = +1``)."""
    big = g.abs() > EPS
    sign = torch.where(g >= 0, 1.0, -1.0).to(g.dtype)
    return torch.where(big, g, EPS * sign), big


def _logqp_towers(fw, hw, gw, spec):
    return ((unpack(fw, spec.drift), _acts(spec.drift)),
            (unpack(hw, spec.prior), _acts(spec.prior)),
            (unpack(gw, spec.diffusion), _acts(spec.diffusion)))


def euler_logqp_solve_forward_plain(y0, noise, t0s, dts, fw, hw, gw, spec):
    """Kernel 13 as a loop of PyTorch operators (the JAX package's
    ``_euler_logqp_fwd_kernel``): diagonal noise, the drift, prior and
    diffusion towers on one input.

    y0 (B,S); noise (N,B,S); t0s, dts (N,); fw, hw, gw the towers' packs.
    Returns ys (N,B,S) and qs (N,B,1), the state and the KL channel after
    each step."""
    towers = _logqp_towers(fw, hw, gw, spec)
    y, q = y0, y0.new_zeros((y0.shape[0], 1))
    ys, qs = [], []
    for n in range(noise.shape[0]):
        x = tower_input(t0s[n], y, spec.with_time)
        f, h, g = (tower_forward(x, w, acts)[0] for w, acts in towers)
        u = (f - h) / _clamped(g)[0]
        q = q + 0.5 * torch.sum(u * u, dim=1, keepdim=True) * dts[n]
        y = y + f * dts[n] + g * noise[n]
        ys.append(y)
        qs.append(q)
    return torch.stack(ys), torch.stack(qs)


def euler_logqp_solve_backward_plain(y0, noise, t0s, dts, fw, hw, gw, spec,
                                     ys, gy, ginc):
    """Kernel 14 as a loop of PyTorch operators: the reverse sweep of the
    JAX package's ``_euler_logqp_bwd_kernel``, which recomputes the three
    towers at each step's pre-step state (y0 or ys[n-1]).

    Takes the forward's inputs, its ys, the cotangent gy (N,B,S) of ys and
    ginc (N,B,1), the reverse cumulative sum over steps of the cotangent of
    qs. Returns dy0 (B,S), dnoise (N,B,S) and the packs' gradients dfw,
    dhw, dgw. The clamp's mask stops the KL term's gradient to g where
    ``|g| <= EPS``, never the state's ``dy dW``."""
    towers = _logqp_towers(fw, hw, gw, spec)
    wt = 1 if spec.with_time else 0
    dy = torch.zeros_like(y0)
    dnoise = torch.empty_like(noise)
    dws = [[torch.zeros_like(t) for wb in w for t in wb] for w, _ in towers]
    for n in reversed(range(noise.shape[0])):
        dt = dts[n]
        x = tower_input(t0s[n], y0 if n == 0 else ys[n - 1], spec.with_time)
        (f, fcache), (h, hcache), (g, gcache) = (
            tower_forward(x, w, acts) for w, acts in towers)
        gs, big = _clamped(g)
        u = (f - h) / gs
        dy = dy + gy[n]
        dnoise[n] = dy * g
        du = ginc[n] * u * dt
        douts = (dy * dt + du / gs, -du / gs,
                 dy * noise[n] - (du * u / gs) * big.to(g.dtype))
        dx = None
        for (w, acts), cache, dout, acc in zip(towers, (fcache, hcache,
                                                        gcache), douts, dws):
            dxt, grads = tower_backward(dout, cache, x, w, acts)
            for a, d in zip(acc, grads):
                a += d
            dx = dxt if dx is None else dx + dxt
        dy = dy + dx[:, wt:]
    return (dy, dnoise, *(_cat_grads(d) for d in dws))


# --------------------------------------------------------------------------- #
#  CUDA kernels 9-14                                                          #
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=64)
def layer_table(spec):
    """The kernels' layer table: ``(in, out, activation code)`` of every
    drift layer, then every diffusion layer, then every prior layer, as a
    host int32 array."""
    rows = [(n_in, n_out, ACTS.index(act)) for n_in, n_out, act
            in spec.drift + spec.diffusion + spec.prior]
    return np.ascontiguousarray(np.asarray(rows, np.int32).reshape(-1))


def _host_table(spec):
    """The layer table as a ctypes pointer that keeps the array alive."""
    return layer_table(spec).ctypes.data_as(ctypes.c_void_p)


@functools.lru_cache(maxsize=64)
def _device_table(spec, device):
    return torch.as_tensor(layer_table(spec), device=device)


def check_spec(spec):
    """What the kernels take: towers that read ``[t? | y]`` and give the
    state's and the diffusion's widths, every width in [1, 128]. Raises
    ValueError beyond it."""
    wt = 1 if spec.with_time else 0
    towers = [("drift", spec.drift, spec.S),
              ("diffusion", spec.diffusion, spec.gwidth)]
    if spec.prior:
        if not spec.diag:
            raise ValueError("the logqp kernels take diagonal noise only")
        towers.append(("prior", spec.prior, spec.S))
    for name, shapes, out in towers:
        if not shapes:
            raise ValueError(f"the {name} tower has no layers")
        if shapes[0][0] != spec.S + wt or shapes[-1][1] != out:
            raise ValueError(f"the {name} tower maps {shapes[0][0]} -> "
                             f"{shapes[-1][1]}; the solve needs "
                             f"{spec.S + wt} -> {out}")
        for i, (n_in, n_out, act) in enumerate(shapes):
            if not (1 <= n_in <= MAX_WIDTH and 1 <= n_out <= MAX_WIDTH):
                raise ValueError(f"{name} layer {i} is {n_in} -> {n_out}; "
                                 f"the kernels take widths in [1, "
                                 f"{MAX_WIDTH}]")
            if i > 0 and n_in != shapes[i - 1][1]:
                raise ValueError(f"{name} layer {i} does not chain")
            if act not in ACTS:
                raise ValueError(f"unknown activation {act!r}")


def _check_common(spec, y0, noise, times, dts, fw, gw):
    if y0.ndim != 2 or noise.ndim != 3:
        raise ValueError("expected y0 (B,S) and noise (N,B,m)")
    check_spec(spec)
    B, S = y0.shape
    N = noise.shape[0]
    if S != spec.S:
        raise ValueError(f"y0 has {S} columns, the spec {spec.S}")
    for name, t, shape in (
            ("y0", y0, (B, S)), ("noise", noise, (N, B, spec.m)),
            ("times", times, (N,)), ("dts", dts, (N,)),
            ("fw", fw, (pack_size(spec.drift),)),
            ("gw", gw, (pack_size(spec.diffusion),))):
        check_kernel_tensor(name, t, shape, torch.float32, y0.device)
    return B, N


def _dims(spec):
    return (len(spec.drift), len(spec.diffusion), len(spec.prior), spec.S,
            spec.m, int(spec.diag), int(spec.with_time))


# The towers a kernel may stage in shared memory, as bitmasks (bit 0 the
# drift, 1 the diffusion, 2 the prior), in order of preference: all, then
# the drift before the prior before the diffusion.
STAGE_ORDER = {2: (3, 1, 2, 0), 3: (7, 5, 3, 6, 1, 4, 2, 0)}


@functools.lru_cache(maxsize=8)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def staged_towers(lib, kind, spec, B, device):
    """The towers a kernel of ``kind`` keeps in shared memory (the others
    it reads from device memory through the caches). When the solve's
    blocks outnumber the card's SMs, a forward kernel stages none: its
    threads read each weight column by column, side by side, which the
    caches serve well, and small blocks let more of them share an SM. A
    sweep also reads each weight row by row (the input cotangents), strided
    across its threads, which shared memory serves better: it stages the
    first set of :data:`STAGE_ORDER` that leaves room for two blocks an SM,
    if any does. A solve of one wave of blocks stages the first set that
    fits. Measured on an NVIDIA H100 80GB HBM3 (700 W, ``chip_smoke.py``)
    at batch 4096, d 32, hidden 128 (512 blocks): kernel 9 took 2.29 ms
    with both towers staged and 1.48 ms with none, kernel 10 10.9 and
    12.5-13.0 ms; kernel 13 about 5.1 ms with all three staged, 3.35-3.38
    with drift and prior and 3.19-3.23 with none; kernel 14 about 18.0,
    16.6-16.7 and 19.8 ms."""
    table = _host_table(spec)
    smem = {s: lib.tsde_tower_smem_bytes(kind, table, *_dims(spec), s)
            for s in STAGE_ORDER[3 if spec.prior else 2]}
    fits = [s for s, n in smem.items() if n <= _build.MAX_SMEM_BYTES]
    if lib.tsde_tower_blocks(B) > _sm_count(device):
        if kind in (EULER_FWD, RH_FWD, EULER_LOGQP_FWD):
            return 0
        two = [s for s in fits
               if 2 * (smem[s] + _build.BLOCK_SMEM_RESERVED)
               <= _build.SM_SMEM_BYTES]
        if two:
            return two[0]
    return fits[0]


def _library(kind, spec, B, device, stage=None):
    """The kernels' library once the solve's activations fit a block's
    shared memory with no tower staged there, and the launch's table
    arguments: the host and device layer tables, the dims and the towers to
    stage (``stage``, a bitmask of :data:`STAGE_ORDER`, or by the rule of
    :func:`staged_towers`)."""
    table = _host_table(spec)
    lib = _build.library_for("tsde_tower_smem_bytes", kind, table,
                             *_dims(spec), 0)
    if stage is None:
        stage = staged_towers(lib, kind, spec, B, device)
    elif lib.tsde_tower_smem_bytes(kind, table, *_dims(spec),
                                   stage) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"staging towers {stage} does not fit a block")
    return lib, (table, _device_table(spec, device).data_ptr(),
                 *_dims(spec), stage)


def _require_cuda(t):
    if not t.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{t.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def euler_solve_forward_cuda(y0, noise, t0s, dts, fw, gw, spec):
    """Launch kernel 9 on the current stream; returns what
    :func:`euler_solve_forward_plain` returns. Raises on tensors it does not
    take, on a failed build and on a refused launch."""
    global euler_launches
    _require_cuda(y0)
    B, N = _check_common(spec, y0, noise, t0s, dts, fw, gw)
    lib, table_dims = _library(EULER_FWD, spec, B, y0.device)
    ys = torch.empty((N, B, spec.S), dtype=torch.float32, device=y0.device)
    ptrs = [t.data_ptr() for t in (fw, gw, y0, noise, t0s, dts, ys)]
    rc = lib.tsde_tower_euler_fwd(*table_dims[:2], *ptrs, *table_dims[2:],
                                  B, N, y0.device.index or 0,
                                  _stream(y0.device))
    _build.check_launch(lib, rc, "tower_euler_fwd")
    euler_launches += 1
    return ys


def _partials(lib, B, spec, device):
    """The backward kernels' weight-gradient buffers: one float32 partial
    of all packs per block of the sweep, and the flat output
    ``[dfw | dgw | dhw]`` the second kernel sums them into."""
    P = (pack_size(spec.drift) + pack_size(spec.diffusion)
         + pack_size(spec.prior))
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((lib.tsde_tower_blocks(B), P), **f32),
            torch.empty(P, **f32))


def euler_solve_backward_cuda(y0, noise, t0s, dts, fw, gw, spec, ys, gy):
    """Launch kernel 10 (the reverse sweep, then the sum of its per-block
    weight-gradient partials) on the current stream; returns what
    :func:`euler_solve_backward_plain` returns."""
    global euler_bwd_launches
    _require_cuda(y0)
    B, N = _check_common(spec, y0, noise, t0s, dts, fw, gw)
    for name, t in (("ys", ys), ("gy", gy)):
        check_kernel_tensor(name, t, (N, B, spec.S), torch.float32,
                            y0.device)
    lib, table_dims = _library(EULER_BWD, spec, B, y0.device)
    dy0, dnoise = torch.empty_like(y0), torch.empty_like(noise)
    partials, dw = _partials(lib, B, spec, y0.device)
    ptrs = [t.data_ptr() for t in (fw, gw, y0, noise, t0s, dts, ys, gy, dy0,
                                   dnoise, partials, dw)]
    rc = lib.tsde_tower_euler_bwd(*table_dims[:2], *ptrs, *table_dims[2:],
                                  B, N, y0.device.index or 0,
                                  _stream(y0.device))
    _build.check_launch(lib, rc, "tower_euler_bwd")
    euler_bwd_launches += 1
    dfw, dgw = dw.split([fw.numel(), gw.numel()])
    return dy0, dnoise, dfw, dgw


def _check_rh(spec, y0, f0, g0, noise, t1s, dts, fw, gw):
    B, N = _check_common(spec, y0, noise, t1s, dts, fw, gw)
    check_kernel_tensor("f0", f0, (B, spec.S), torch.float32, y0.device)
    check_kernel_tensor("g0", g0, (B, spec.gwidth), torch.float32,
                        y0.device)
    return B, N


def rh_solve_forward_cuda(y0, f0, g0, noise, t1s, dts, fw, gw, spec):
    """Launch kernel 11 on the current stream; returns what
    :func:`rh_solve_forward_plain` returns."""
    global rh_launches
    _require_cuda(y0)
    B, N = _check_rh(spec, y0, f0, g0, noise, t1s, dts, fw, gw)
    lib, table_dims = _library(RH_FWD, spec, B, y0.device)
    f32 = dict(dtype=torch.float32, device=y0.device)
    ys = torch.empty((N, B, spec.S), **f32)
    zs = torch.empty((N, B, spec.S), **f32)
    gs = torch.empty((N, B, spec.gwidth), **f32)
    ptrs = [t.data_ptr() for t in (fw, gw, y0, f0, g0, noise, t1s, dts, ys,
                                   zs, gs)]
    rc = lib.tsde_tower_rh_fwd(*table_dims[:2], *ptrs, *table_dims[2:], B, N,
                               y0.device.index or 0, _stream(y0.device))
    _build.check_launch(lib, rc, "tower_rh_fwd")
    rh_launches += 1
    return ys, zs, gs


def rh_solve_backward_cuda(y0, f0, g0, noise, t1s, dts, fw, gw, spec, zs, gs,
                           gy):
    """Launch kernel 12 (the reverse sweep, then the sum of its per-block
    weight-gradient partials) on the current stream; returns what
    :func:`rh_solve_backward_plain` returns."""
    global rh_bwd_launches
    _require_cuda(y0)
    B, N = _check_rh(spec, y0, f0, g0, noise, t1s, dts, fw, gw)
    for name, t, width in (("zs", zs, spec.S), ("gs", gs, spec.gwidth),
                           ("gy", gy, spec.S)):
        check_kernel_tensor(name, t, (N, B, width), torch.float32, y0.device)
    lib, table_dims = _library(RH_BWD, spec, B, y0.device)
    dy0, df0, dg0 = (torch.empty_like(t) for t in (y0, f0, g0))
    dnoise = torch.empty_like(noise)
    partials, dw = _partials(lib, B, spec, y0.device)
    ptrs = [t.data_ptr() for t in (fw, gw, g0, noise, t1s, dts, zs, gs, gy,
                                   dy0, df0, dg0, dnoise, partials, dw)]
    rc = lib.tsde_tower_rh_bwd(*table_dims[:2], *ptrs, *table_dims[2:], B, N,
                               y0.device.index or 0, _stream(y0.device))
    _build.check_launch(lib, rc, "tower_rh_bwd")
    rh_bwd_launches += 1
    dfw, dgw = dw.split([fw.numel(), gw.numel()])
    return dy0, df0, dg0, dnoise, dfw, dgw


def _check_logqp(spec, y0, noise, t0s, dts, fw, hw, gw):
    if not spec.prior:
        raise ValueError("the logqp kernels need a prior tower in the spec")
    B, N = _check_common(spec, y0, noise, t0s, dts, fw, gw)
    check_kernel_tensor("hw", hw, (pack_size(spec.prior),), torch.float32,
                        y0.device)
    return B, N


def euler_logqp_solve_forward_cuda(y0, noise, t0s, dts, fw, hw, gw, spec,
                                   stage=None):
    """Launch kernel 13 on the current stream; returns what
    :func:`euler_logqp_solve_forward_plain` returns. ``stage`` overrides
    the towers staged in shared memory (a bitmask of :data:`STAGE_ORDER`).
    Raises on tensors it does not take, on a failed build and on a refused
    launch."""
    global logqp_launches
    _require_cuda(y0)
    B, N = _check_logqp(spec, y0, noise, t0s, dts, fw, hw, gw)
    lib, table_dims = _library(EULER_LOGQP_FWD, spec, B, y0.device,
                              stage)
    f32 = dict(dtype=torch.float32, device=y0.device)
    ys = torch.empty((N, B, spec.S), **f32)
    qs = torch.empty((N, B, 1), **f32)
    ptrs = [t.data_ptr() for t in (fw, gw, hw, y0, noise, t0s, dts, ys, qs)]
    rc = lib.tsde_tower_euler_logqp_fwd(*table_dims[:2], *ptrs,
                                        *table_dims[2:], B, N,
                                        y0.device.index or 0,
                                        _stream(y0.device))
    _build.check_launch(lib, rc, "tower_euler_logqp_fwd")
    logqp_launches += 1
    return ys, qs


def euler_logqp_solve_backward_cuda(y0, noise, t0s, dts, fw, hw, gw, spec,
                                    ys, gy, ginc, stage=None):
    """Launch kernel 14 (the reverse sweep, then the sum of its per-block
    weight-gradient partials) on the current stream; returns what
    :func:`euler_logqp_solve_backward_plain` returns."""
    global logqp_bwd_launches
    _require_cuda(y0)
    B, N = _check_logqp(spec, y0, noise, t0s, dts, fw, hw, gw)
    for name, t, width in (("ys", ys, spec.S), ("gy", gy, spec.S),
                           ("ginc", ginc, 1)):
        check_kernel_tensor(name, t, (N, B, width), torch.float32, y0.device)
    lib, table_dims = _library(EULER_LOGQP_BWD, spec, B, y0.device,
                              stage)
    dy0, dnoise = torch.empty_like(y0), torch.empty_like(noise)
    partials, dw = _partials(lib, B, spec, y0.device)
    ptrs = [t.data_ptr() for t in (fw, gw, hw, y0, noise, t0s, dts, ys, gy,
                                   ginc, dy0, dnoise, partials, dw)]
    rc = lib.tsde_tower_euler_logqp_bwd(*table_dims[:2], *ptrs,
                                        *table_dims[2:], B, N,
                                        y0.device.index or 0,
                                        _stream(y0.device))
    _build.check_launch(lib, rc, "tower_euler_logqp_bwd")
    logqp_bwd_launches += 1
    dfw, dgw, dhw = dw.split([fw.numel(), gw.numel(), hw.numel()])
    return dy0, dnoise, dfw, dhw, dgw


def _route(device, plain, cuda):
    """The plain version for CPU tensors, the kernel for CUDA tensors; no
    fallback between them."""
    if device.type == "cpu":
        return plain
    if device.type == "cuda":
        return cuda
    raise ValueError(f"no fused tower solve for device {device}")


class FusedEulerSolve(torch.autograd.Function):
    """The Euler whole solve as one differentiable operation (the
    counterpart of the JAX package's ``_make_euler`` custom VJP): kernels 9
    and 10 on CUDA tensors, their plain versions on CPU tensors. Gradients
    flow to the packs fw, gw, to y0 and to the noise; t0s and dts get
    none."""

    @staticmethod
    def forward(fctx, spec, fw, gw, y0, noise, t0s, dts):
        solve = _route(y0.device, euler_solve_forward_plain,
                       euler_solve_forward_cuda)
        ys = solve(y0, noise, t0s, dts, fw, gw, spec)
        fctx.spec = spec
        fctx.save_for_backward(fw, gw, y0, noise, t0s, dts, ys)
        return ys

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(fctx, gy):
        fw, gw, y0, noise, t0s, dts, ys = fctx.saved_tensors
        sweep = _route(y0.device, euler_solve_backward_plain,
                       euler_solve_backward_cuda)
        dy0, dnoise, dfw, dgw = sweep(y0, noise, t0s, dts, fw, gw, fctx.spec,
                                      ys, gy.contiguous())
        if not fctx.needs_input_grad[4]:
            dnoise = None
        return None, dfw, dgw, dy0, dnoise, None, None


class FusedRHSolve(torch.autograd.Function):
    """The reversible-Heun whole solve as one differentiable operation (the
    counterpart of the JAX package's ``_make_rh`` custom VJP): kernels 11
    and 12 on CUDA tensors, their plain versions on CPU tensors. Returns
    ys, zs and gs; zs and gs, which the backward reads, are not
    differentiable. Gradients flow to the packs, y0, f0, g0 and the noise;
    t1s and dts get none."""

    @staticmethod
    def forward(fctx, spec, fw, gw, y0, f0, g0, noise, t1s, dts):
        solve = _route(y0.device, rh_solve_forward_plain,
                       rh_solve_forward_cuda)
        ys, zs, gs = solve(y0, f0, g0, noise, t1s, dts, fw, gw, spec)
        fctx.spec = spec
        fctx.save_for_backward(fw, gw, y0, f0, g0, noise, t1s, dts, zs, gs)
        fctx.mark_non_differentiable(zs, gs)
        return ys, zs, gs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(fctx, gy, _gz, _gg):
        fw, gw, y0, f0, g0, noise, t1s, dts, zs, gs = fctx.saved_tensors
        sweep = _route(y0.device, rh_solve_backward_plain,
                       rh_solve_backward_cuda)
        dy0, df0, dg0, dnoise, dfw, dgw = sweep(
            y0, f0, g0, noise, t1s, dts, fw, gw, fctx.spec, zs, gs,
            gy.contiguous())
        if not fctx.needs_input_grad[6]:
            dnoise = None
        return None, dfw, dgw, dy0, df0, dg0, dnoise, None, None


class FusedEulerLogqpSolve(torch.autograd.Function):
    """The Euler logqp whole solve as one differentiable operation (the
    counterpart of the JAX package's ``_make_euler_logqp`` custom VJP):
    kernels 13 and 14 on CUDA tensors, their plain versions on CPU tensors.
    Returns ys (N,B,S) and qs (N,B,1). The backward turns the cotangent of
    qs into its reverse cumulative sum over steps before the sweep.
    Gradients flow to the packs fw, hw, gw, to y0 and to the noise; t0s and
    dts get none."""

    @staticmethod
    def forward(fctx, spec, fw, hw, gw, y0, noise, t0s, dts):
        solve = _route(y0.device, euler_logqp_solve_forward_plain,
                       euler_logqp_solve_forward_cuda)
        ys, qs = solve(y0, noise, t0s, dts, fw, hw, gw, spec)
        fctx.spec = spec
        fctx.save_for_backward(fw, hw, gw, y0, noise, t0s, dts, ys)
        return ys, qs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(fctx, gy, gq):
        fw, hw, gw, y0, noise, t0s, dts, ys = fctx.saved_tensors
        ginc = gq.flip(0).cumsum(0).flip(0).contiguous()
        sweep = _route(y0.device, euler_logqp_solve_backward_plain,
                       euler_logqp_solve_backward_cuda)
        dy0, dnoise, dfw, dhw, dgw = sweep(y0, noise, t0s, dts, fw, hw, gw,
                                           fctx.spec, ys, gy.contiguous(),
                                           ginc)
        if not fctx.needs_input_grad[5]:
            dnoise = None
        return None, dfw, dhw, dgw, dy0, dnoise, None, None


# --------------------------------------------------------------------------- #
#  Public API                                                                 #
# --------------------------------------------------------------------------- #

def _grid_indices(grid, ts_np, caller):
    """Nearest-grid-point index for each output time, with a tolerance that
    survives float64 step accumulation (exact searchsorted falsely rejects
    e.g. ts=2.1 on a dt=0.7 grid whose point is 2.0999999999999996)."""
    idx = np.abs(np.asarray(grid)[None, :] - ts_np[:, None]).argmin(axis=1)
    span = float(ts_np[-1] - ts_np[0]) or 1.0
    if not np.allclose(np.asarray(grid)[idx], ts_np,
                       atol=1e-9 * max(span, 1.0)):
        raise ValueError(f"{caller} requires every output time to lie on "
                         "the dt step grid")
    return idx


def _check_tower_io(spec, name, S, with_time, out_size=None):
    want_in = S + (1 if with_time else 0)
    if spec.in_size != want_in:
        raise ValueError(
            f"{name} tower expects input width {spec.in_size}, but the solve "
            f"feeds {want_in} ({'[t | y]' if with_time else '[y]'})")
    if out_size is not None and spec.out_size != out_size:
        raise ValueError(f"{name} tower must output width {out_size}, got "
                         f"{spec.out_size}")


def tower_sde(drift, diffusion, noise_type, sde_type, with_time=False,
              prior=None):
    """An SDE module whose ``f`` and ``g`` (and, given a ``prior`` tower,
    ``h``) evaluate exactly the given TowerSpecs: the ``sdeint`` view of a
    fused solve, for cross-checking :func:`fused_sdeint` and
    :func:`fused_sdeint_logqp` against ``sdeint`` on identical dynamics."""
    base = {"ito": base_sde.SDEIto,
            "stratonovich": base_sde.SDEStratonovich}[sde_type]

    class _TowerSDE(base):
        def __init__(self):
            super().__init__(noise_type=noise_type)
            self.fl = [(w, b) for (w, b, _) in drift.layers]
            self.gl = [(w, b) for (w, b, _) in diffusion.layers]
            if prior is not None:
                self.hl = [(w, b) for (w, b, _) in prior.layers]

        def _x(self, t, y):
            return tower_input(t, y, with_time)

        def f(self, t, y):
            return tower_forward(self._x(t, y), self.fl, drift.acts)[0]

        def g(self, t, y):
            out = tower_forward(self._x(t, y), self.gl, diffusion.acts)[0]
            if noise_type == "diagonal":
                return out
            d = y.shape[1]
            return out.reshape(y.shape[0], d, out.shape[1] // d)

        if prior is not None:
            def h(self, t, y):
                return tower_forward(self._x(t, y), self.hl, prior.acts)[0]

    return _TowerSDE()


def _auto_fuse(dtype):
    """Dispatch rule of ``dispatch='auto'``: the kernels for float32 towers
    (the only dtype they take), the ``sdeint`` route for the others. No
    shape threshold: on an NVIDIA H100 (80GB HBM3, 700 W) the kernel route's
    grad path (the gradient of sum(ys**2) to y0) beat the ``sdeint`` route's
    at every shape measured by ``chip_smoke.py``, because the latter is
    host-bound at some ten launches a step whatever the widths: Euler batch
    1024, d 8, hidden 64, 128 steps 4.6 against 146 ms; reversible Heun at
    the same shape 5.5 against 122 ms; Euler batch 4096, d 32, hidden 128
    15.6 against 94 ms; reversible Heun batch 1024, d 128, hidden 128 25.3
    against 125 ms; Euler batch 4, d 3, hidden 8, 2 steps 2.7 against
    4.2 ms. The same held for :func:`fused_sdeint_logqp` (the gradient of
    sum(ys**2) + sum(log_ratio) to y0): batch 1024, d 8, hidden 64, 128
    steps 4.5 against 157 ms; batch 4096, d 32, hidden 128 22.6 against
    171 ms; batch 4, d 3, hidden 8, 2 steps 1.8 against 5.9 ms. (The JAX
    package's rule, a threshold on 128-lane padding waste, has no
    counterpart: the port's kernels are unpadded.)"""
    return dtype == torch.float32


def fused_sdeint(drift, diffusion, y0, ts, generator, dt, method="euler",
                 noise_type="diagonal", with_time=False, dispatch="auto"):
    """Whole-solve fused ``sdeint`` for MLP-tower SDEs.

    ``drift``/``diffusion``: :class:`TowerSpec`; the diffusion tower's
    output is ``(B, d)`` for diagonal noise or the row-major flattening of
    ``(B, d, m)`` for general noise. ``with_time=True`` feeds ``t`` as the
    towers' first input column (time-dependent vector fields).

    Matches ``sdeint(sde, y0, ts, method=method, dt=dt,
    generator=generator)`` in the noise (the same draw from the same
    generator) and to float tolerance in values and gradients, for SDEs
    whose ``f``/``g`` evaluate exactly these towers on ``[t? | y]``. The
    solve computes in the towers' dtype and on their device: ``y0`` is cast
    and moved on entry, and the noise is the one ``sdeint`` would draw for
    a ``y0`` of that dtype, identically on every dispatch path. Fixed-step
    only, and the step grid must land on ``ts`` exactly (each output time a
    multiple of ``dt`` from ``t0``), enforced on every dispatch path.

    ``dispatch``: ``'auto'`` (default) runs the kernels for float32 towers,
    where they win at every measured shape (:func:`_auto_fuse`), and the
    ``sdeint`` route for other dtypes;
    ``'fused'`` / ``'xla'`` force a path (``'xla'`` names the ``sdeint``
    route, as in the JAX package). ``'fused'`` takes float32 towers only.
    On CUDA tensors the fused path runs the kernels or raises; on CPU
    tensors it runs their plain versions.
    """
    if method not in ("euler", "reversible_heun"):
        raise ValueError("fused_sdeint supports euler / reversible_heun")
    if noise_type not in ("diagonal", "general"):
        raise ValueError("fused_sdeint supports diagonal / general noise")
    if dispatch not in ("auto", "fused", "xla"):
        raise ValueError("dispatch must be 'auto', 'fused' or 'xla'")

    # All contract validation and the dtype contract come before the
    # dispatch decision, so 'auto' is purely a performance choice: both
    # paths accept and reject the same inputs, compute in the towers' dtype
    # and draw the same noise.
    wdtype = drift.layers[0][0].dtype
    wdevice = drift.layers[0][0].device
    y0 = torch.as_tensor(y0).to(device=wdevice, dtype=wdtype)
    diag = noise_type == "diagonal"
    B, S = y0.shape
    if diag:
        if diffusion.out_size != S:
            raise ValueError("diagonal diffusion tower must output d")
        m = S
    else:
        if diffusion.out_size % S:
            raise ValueError("general diffusion tower must output d*m")
        m = diffusion.out_size // S

    _check_tower_io(drift, "drift", S, with_time, out_size=S)
    _check_tower_io(diffusion, "diffusion", S, with_time)

    ts_np = host_times(ts)
    grid = integrate.build_step_grid(ts_np[0], ts_np[-1], dt)
    idx = _grid_indices(grid, ts_np, "fused_sdeint")

    # The kernels compute in float32: 'auto' routes other towers to the
    # sdeint route, 'fused' rejects them.
    if dispatch == "fused" and wdtype != torch.float32:
        raise ValueError(
            f"fused_sdeint kernels are float32-only (towers are {wdtype}); "
            f"use dispatch='xla'/'auto' or float32 towers")
    if dispatch == "xla" or (dispatch == "auto" and not _auto_fuse(wdtype)):
        from ..core.sdeint import sdeint
        sde_type = "ito" if method == "euler" else "stratonovich"
        sde = tower_sde(drift, diffusion, noise_type, sde_type,
                        with_time=with_time)
        return sdeint(sde, y0, ts_np, method=method, dt=dt,
                      generator=generator)

    W = integrate.sample_grid_noise(generator, grid, (B, m), wdtype,
                                    wdevice)[0]
    spec = solve_spec(drift, diffusion, S, m, diag, with_time)
    ys = solve_on_grid(method, drift, diffusion, y0, W, grid, spec)
    return ys[torch.as_tensor(idx, device=wdevice)]


def solve_on_grid(method, drift, diffusion, y0, W, grid, spec):
    """The fused solve of :func:`fused_sdeint` on its step grid, in any
    dtype (the kernels take float32 only): ``y0`` and the states after
    every step of ``grid`` (float64 host times), (len(grid), B, S), from
    the noise W (N,B,m), through :class:`FusedEulerSolve` or
    :class:`FusedRHSolve`. Euler takes each step's start time, reversible
    Heun its end time, and dts is the grid's subtraction in the towers'
    dtype, as the ``sdeint`` route's steps use them."""
    grid_dev = torch.as_tensor(grid, dtype=y0.dtype, device=y0.device)
    dts = grid_dev[1:] - grid_dev[:-1]
    y0 = y0.contiguous()
    fw, gw = drift.pack(), diffusion.pack()
    if method == "euler":
        ys = FusedEulerSolve.apply(spec, fw, gw, y0, W.contiguous(),
                                   grid_dev[:-1], dts)
    else:
        x0 = tower_input(grid_dev[0], y0, spec.with_time)
        f0 = tower_forward(x0, [(w, b) for w, b, _ in drift.layers],
                           drift.acts)[0]
        g0 = tower_forward(x0, [(w, b) for w, b, _ in diffusion.layers],
                           diffusion.acts)[0]
        ys = FusedRHSolve.apply(spec, fw, gw, y0, f0.contiguous(),
                                g0.contiguous(), W.contiguous(),
                                grid_dev[1:], dts)[0]
    return torch.cat([y0[None], ys], dim=0)


def logqp_solve_on_grid(drift, prior, diffusion, y0, W, grid, spec):
    """The fused solve of :func:`fused_sdeint_logqp` on its step grid, in
    any dtype (the kernels take float32 only): the states and the KL
    channel at every point of ``grid`` (float64 host times), (len(grid), B,
    S) and (len(grid), B, 1) with ``y0`` and ``q = 0`` first, from the
    noise W (N,B,S), through :class:`FusedEulerLogqpSolve`. Each step takes
    its start time, and dts is the grid's subtraction in the towers' dtype,
    as the ``sdeint`` route's steps use them."""
    grid_dev = torch.as_tensor(grid, dtype=y0.dtype, device=y0.device)
    dts = grid_dev[1:] - grid_dev[:-1]
    y0 = y0.contiguous()
    ys, qs = FusedEulerLogqpSolve.apply(spec, drift.pack(), prior.pack(),
                                        diffusion.pack(), y0, W.contiguous(),
                                        grid_dev[:-1], dts)
    q0 = y0.new_zeros((1, y0.shape[0], 1))
    return torch.cat([y0[None], ys], dim=0), torch.cat([q0, qs], dim=0)


def fused_sdeint_logqp(drift, prior, diffusion, y0, ts, generator, dt,
                       with_time=False, dispatch="auto"):
    """Whole-solve fused Euler logqp solve for MLP-tower SDEs: the generic
    form of the latent SDE's solve (``u = stable_division(f - h, g)``, KL
    integrand ``0.5 |u|^2``). Diagonal noise only; the drift, prior and
    diffusion towers all read the same ``[t? | y]`` row and output d.

    Returns ``(ys, log_ratio)`` as ``sdeint(tower_sde(drift, diffusion,
    'diagonal', 'ito', with_time=with_time, prior=prior), y0, ts,
    method='euler', dt=dt, logqp=True, generator=generator)`` does: ``ys``
    (T, B, d) on ``ts`` and ``log_ratio`` (T-1, B), the KL increment of
    each output interval. The noise is that call's draw: the KL channel
    makes its state (B, d+1), so the noise of size (B, d+1) is drawn from
    ``generator`` and its last channel left unused, as the ``sdeint``
    route's zero diffusion row leaves it. The contract (the towers' widths,
    the dtype, the step grid landing on ``ts``) is checked before dispatch,
    on every path, as in :func:`fused_sdeint`.

    ``dispatch``: ``'auto'`` (default) runs the kernels for float32 towers
    (:func:`_auto_fuse`) and the ``sdeint`` route for other dtypes;
    ``'fused'`` / ``'xla'`` force a path. On CUDA tensors the fused path
    runs kernels 13 and 14 or raises; on CPU tensors their plain versions.
    """
    if dispatch not in ("auto", "fused", "xla"):
        raise ValueError("dispatch must be 'auto', 'fused' or 'xla'")
    wdtype = drift.layers[0][0].dtype
    wdevice = drift.layers[0][0].device
    y0 = torch.as_tensor(y0).to(device=wdevice, dtype=wdtype)
    B, S = y0.shape
    for spec, name in ((drift, "drift"), (prior, "prior"),
                       (diffusion, "diffusion")):
        _check_tower_io(spec, name, S, with_time, out_size=S)
    ts_np = host_times(ts)
    grid = integrate.build_step_grid(ts_np[0], ts_np[-1], dt)
    idx = _grid_indices(grid, ts_np, "fused_sdeint_logqp")

    if dispatch == "fused" and wdtype != torch.float32:
        raise ValueError(
            f"fused_sdeint_logqp kernels are float32-only (towers are "
            f"{wdtype}); use dispatch='xla'/'auto' or float32 towers")
    if dispatch == "xla" or (dispatch == "auto" and not _auto_fuse(wdtype)):
        from ..core.sdeint import sdeint
        sde = tower_sde(drift, diffusion, "diagonal", "ito",
                        with_time=with_time, prior=prior)
        return sdeint(sde, y0, ts_np, method="euler", dt=dt,
                      generator=generator, logqp=True)

    W = integrate.sample_grid_noise(generator, grid, (B, S + 1), wdtype,
                                    wdevice)[0][..., :S]
    spec = solve_spec(drift, diffusion, S, S, True, with_time, prior=prior)
    ys, qs = logqp_solve_on_grid(drift, prior, diffusion, y0, W, grid, spec)
    at = torch.as_tensor(idx, device=wdevice)
    qs = qs[at, :, 0]
    return ys[at], qs[1:] - qs[:-1]
