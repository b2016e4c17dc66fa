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
and 0/1 tile matrices are not ported. The reverse sweeps (kernels 10, 12
and 14) carry only the step-to-step chain and write every layer's
pre-activation cotangent and input to a scratch workspace
(:func:`scratch_views`); a contraction of it over all steps and rows
(``csrc/tower_bwd_contract.cu``) gives the weight gradients. A CPU tensor
goes to the kernels' plain versions
(:func:`euler_solve_forward_plain`, :func:`euler_solve_backward_plain`,
:func:`rh_solve_forward_plain`, :func:`rh_solve_backward_plain`,
:func:`euler_logqp_solve_forward_plain`,
:func:`euler_logqp_solve_backward_plain`: the same math as PyTorch
operators, the backward ones split as their kernels are into a plain
sweep and :func:`tower_contract_plain`); a CUDA tensor goes to the
kernels, which raise rather than fall back. ``euler_launches``,
``euler_bwd_launches``, ``rh_launches``, ``rh_bwd_launches``,
``logqp_launches`` and ``logqp_bwd_launches`` count the kernels' launches.
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
    """Kernel 10 as PyTorch operators: the reverse sweep of the JAX
    package's ``_euler_bwd_kernel``, which recomputes both towers at each
    step's pre-step state (y0 or ys[n-1]); composed, as the kernel is, of
    :func:`euler_solve_backward_sweep_plain` and
    :func:`tower_contract_plain`.

    Takes the forward's inputs, its ys and the cotangent gy (N,B,S) of ys.
    Returns dy0 (B,S), dnoise (N,B,m) and the packs' gradients dfw, dgw."""
    dy0, dnoise, scratch = euler_solve_backward_sweep_plain(
        y0, noise, t0s, dts, fw, gw, spec, ys, gy)
    y_pre = torch.cat([y0[None], ys[:-1]])
    dfw, dgw = tower_contract_plain(
        spec, first_inputs(t0s, y_pre, spec.with_time), scratch)
    return dy0, dnoise, dfw, dgw


def euler_solve_backward_sweep_plain(y0, noise, t0s, dts, fw, gw, spec, ys,
                                     gy):
    """Kernel 10's sweep as a loop of PyTorch operators: for each step, last
    to first, both towers recomputed at ``[t0_n? | y_n]`` and
    backpropagated without their weight gradients, dy carried back.

    Returns dy0, dnoise and the scratch: per tower (drift, diffusion) the
    inputs of its layers after the first and every layer's pre-activation
    cotangent, each (N,B,width) (:func:`tower_contract_plain`)."""
    fl, gl = unpack(fw, spec.drift), unpack(gw, spec.diffusion)
    facts, gacts = _acts(spec.drift), _acts(spec.diffusion)
    wt = 1 if spec.with_time else 0
    N = noise.shape[0]
    dy = torch.zeros_like(y0)
    dnoise = torch.empty_like(noise)
    steps = _scratch_steps(spec, N)
    for n in reversed(range(N)):
        x = tower_input(t0s[n], y0 if n == 0 else ys[n - 1], spec.with_time)
        _, fcache = tower_forward(x, fl, facts)
        g, gcache = tower_forward(x, gl, gacts)
        dy = dy + gy[n]
        dnoise[n] = _noise_vjp(dy, g, spec)
        dxf, *f_scratch = _tower_chain(dy * dts[n], fcache, fl, facts)
        dxg, *g_scratch = _tower_chain(_noise_outer(dy, noise[n], spec),
                                       gcache, gl, gacts)
        _record(steps, n, (f_scratch, g_scratch))
        dy = dy + (dxf + dxg)[:, wt:]
    return dy, dnoise, _stacked(steps)


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


def _tower_chain(dout, cache, weights, acts):
    """The VJP of :func:`tower_forward` without the weight gradients: d x,
    the inputs of the layers after the first, and every layer's
    pre-activation cotangent (what a chain sweep writes to its scratch)."""
    dpres = [None] * len(weights)
    d = dout
    for i in range(len(weights) - 1, -1, -1):
        pre, out = cache[i]
        d = act_bwd(d, pre, out, acts[i])
        dpres[i] = d
        d = d @ weights[i][0].T
    return d, [out for _, out in cache[:-1]], dpres


def _spec_shapes(spec):
    """The towers' layer shapes in the kernels' order: drift, diffusion,
    then the prior if the solve has one."""
    return (spec.drift, spec.diffusion) + ((spec.prior,) if spec.prior
                                          else ())


def _scratch_steps(spec, N):
    """Per tower, empty per-step lists of its layers' inputs after the
    first and of every layer's pre-activation cotangent."""
    return [([[None] * N for _ in shapes[1:]], [[None] * N for _ in shapes])
            for shapes in _spec_shapes(spec)]


def _record(steps, n, towers):
    """Step n's ``(inputs, dpres)`` of each tower into :func:`_scratch_steps`'
    lists."""
    for (xs_n, ds_n), (xs, ds) in zip(steps, towers):
        for store, v in zip(xs_n + ds_n, xs + ds):
            store[n] = v


def _stacked(steps):
    return tuple((tuple(torch.stack(v) for v in xs),
                  tuple(torch.stack(v) for v in ds)) for xs, ds in steps)


def first_inputs(times, states, with_time):
    """Every step's first tower input ``[t_n? | state_n]``, (N,B,in), from
    times (N,) and states (N,B,S)."""
    if not with_time:
        return states
    N, B = states.shape[:2]
    t = times.to(states.dtype)[:, None, None].expand(N, B, 1)
    return torch.cat([t, states], dim=-1)


def tower_contract_plain(spec, x0, scratch):
    """The contraction of kernels 10, 12 and 14
    (``csrc/tower_bwd_contract.cu``)
    as PyTorch operators: each tower's pack gradient, layer by layer
    ``X^T D`` and the column sums of ``D`` over all rows of a chain
    sweep's scratch (the structure :func:`scratch_views` gives: per tower,
    the inputs of its layers after the first and every layer's
    pre-activation cotangent), ``X`` the layer's input: ``x0``
    (:func:`first_inputs`) for a tower's first layer. Returns the packs'
    gradients in the kernels' tower order (drift, diffusion, prior)."""
    x0 = x0.reshape(-1, x0.shape[-1])
    grads = []
    for xs, ds in scratch:
        parts = []
        for i, d in enumerate(ds):
            x = x0 if i == 0 else xs[i - 1].reshape(-1, xs[i - 1].shape[-1])
            d = d.reshape(-1, d.shape[-1])
            parts += [x.T @ d, d.sum(0)]
        grads.append(_cat_grads(parts))
    return tuple(grads)


def rh_solve_backward_plain(y0, f0, g0, noise, t1s, dts, fw, gw, spec, zs, gs,
                            gy):
    """Kernel 12 as PyTorch operators: the ``(ay, az, af, ag)`` recurrence
    of the JAX package's ``_rh_bwd_kernel``, which recomputes the towers at
    each step's stored ``z_{n+1}`` and reads ``g_n`` and ``g_{n+1}`` from
    ``gs`` with ``g0`` in front; composed, as the kernel is, of
    :func:`rh_solve_backward_sweep_plain` and :func:`tower_contract_plain`.

    Takes the forward's inputs, its zs, gs and the cotangent gy (N,B,S) of
    ys. Returns dy0, df0 (B,S), dg0 (B, S or S*m), dnoise (N,B,m) and the
    packs' gradients dfw, dgw."""
    *chain, scratch = rh_solve_backward_sweep_plain(
        y0, f0, g0, noise, t1s, dts, fw, gw, spec, zs, gs, gy)
    dfw, dgw = tower_contract_plain(
        spec, first_inputs(t1s, zs, spec.with_time), scratch)
    return (*chain, dfw, dgw)


def rh_solve_backward_sweep_plain(y0, f0, g0, noise, t1s, dts, fw, gw, spec,
                                  zs, gs, gy):
    """Kernel 12's sweep as a loop of PyTorch operators: for each step, last
    to first, the towers recomputed at ``[t1_n? | z_{n+1}]`` and
    backpropagated without their weight gradients, the cotangents carried
    back.

    Returns dy0, df0, dg0, dnoise and the scratch: per tower (drift,
    diffusion) the inputs of its layers after the first and every layer's
    pre-activation cotangent, each (N,B,width), whose products over all
    N*B rows give the packs' gradients (:func:`tower_contract_plain`)."""
    fl, gl = unpack(fw, spec.drift), unpack(gw, spec.diffusion)
    facts, gacts = _acts(spec.drift), _acts(spec.diffusion)
    wt = 1 if spec.with_time else 0
    N = noise.shape[0]
    g_all = torch.cat([g0[None], gs])
    ay, az, af = (torch.zeros_like(y0) for _ in range(3))
    ag = torch.zeros_like(g0)
    dnoise = torch.empty_like(noise)
    steps = _scratch_steps(spec, N)
    for n in reversed(range(N)):
        dt, dW = dts[n], noise[n]
        ay = ay + gy[n]
        Af = af + 0.5 * dt * ay
        Ag = ag + _noise_outer(ay, 0.5 * dW, spec)
        x = tower_input(t1s[n], zs[n], spec.with_time)
        _, fcache = tower_forward(x, fl, facts)
        _, gcache = tower_forward(x, gl, gacts)
        dxf, *f_scratch = _tower_chain(Af, fcache, fl, facts)
        dxg, *g_scratch = _tower_chain(Ag, gcache, gl, gacts)
        _record(steps, n, (f_scratch, g_scratch))
        Az = az + (dxf + dxg)[:, wt:]
        g_n, g_next = g_all[n], g_all[n + 1]
        dnoise[n] = _noise_vjp(Az, g_n, spec) + _noise_vjp(
            0.5 * ay, g_n + g_next, spec)
        ay, az, af, ag = (ay + 2.0 * Az, -Az, 0.5 * dt * ay + dt * Az,
                          _noise_outer(0.5 * ay + Az, dW, spec))
    return ay + az, af, ag, dnoise, _stacked(steps)


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
    """Kernel 14 as PyTorch operators: the reverse sweep of the JAX
    package's ``_euler_logqp_bwd_kernel``, which recomputes the three towers
    at each step's pre-step state (y0 or ys[n-1]); composed, as the kernel
    is, of :func:`euler_logqp_solve_backward_sweep_plain` and
    :func:`tower_contract_plain`.

    Takes the forward's inputs, its ys, the cotangent gy (N,B,S) of ys and
    ginc (N,B,1), the reverse cumulative sum over steps of the cotangent of
    qs. Returns dy0 (B,S), dnoise (N,B,S) and the packs' gradients dfw,
    dhw, dgw. The clamp's mask stops the KL term's gradient to g where
    ``|g| <= EPS``, never the state's ``dy dW``."""
    dy0, dnoise, scratch = euler_logqp_solve_backward_sweep_plain(
        y0, noise, t0s, dts, fw, hw, gw, spec, ys, gy, ginc)
    y_pre = torch.cat([y0[None], ys[:-1]])
    dfw, dgw, dhw = tower_contract_plain(
        spec, first_inputs(t0s, y_pre, spec.with_time), scratch)
    return dy0, dnoise, dfw, dhw, dgw


def euler_logqp_solve_backward_sweep_plain(y0, noise, t0s, dts, fw, hw, gw,
                                           spec, ys, gy, ginc):
    """Kernel 14's sweep as a loop of PyTorch operators: for each step, last
    to first, the three towers recomputed at ``[t0_n? | y_n]`` and
    backpropagated without their weight gradients, dy carried back.

    Returns dy0, dnoise and the scratch: per tower (drift, diffusion,
    prior: the kernels' order) the inputs of its layers after the first and
    every layer's pre-activation cotangent, each (N,B,width)
    (:func:`tower_contract_plain`)."""
    towers = _logqp_towers(fw, hw, gw, spec)          # f, h, g
    wt = 1 if spec.with_time else 0
    N = noise.shape[0]
    dy = torch.zeros_like(y0)
    dnoise = torch.empty_like(noise)
    steps = _scratch_steps(spec, N)
    for n in reversed(range(N)):
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
        dx, scratch = None, []
        for (w, acts), cache, dout in zip(towers, (fcache, hcache, gcache),
                                          douts):
            dxt, *xs_ds = _tower_chain(dout, cache, w, acts)
            scratch.append(xs_ds)
            dx = dxt if dx is None else dx + dxt
        _record(steps, n, (scratch[0], scratch[2], scratch[1]))
        dy = dy + dx[:, wt:]
    return dy, dnoise, _stacked(steps)


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
    """The towers kernel 9 or a sweep (kernels 10, 12, 14) of ``kind``
    keeps in shared memory (the others it reads from device memory through
    the caches); kernels 11 and 13 follow :func:`forward_design`. When the
    solve's 8-row blocks outnumber the card's SMs, kernel 9 stages none: its
    threads read each weight column by column, side by side, which the
    caches serve well, and small blocks let more of them share an SM. A
    sweep also reads each weight row by row (the input cotangents), strided
    across its threads, which shared memory serves better: it stages the
    first set of :data:`STAGE_ORDER` that leaves room for two blocks an SM,
    if any does. A solve of one wave of blocks stages the first set that
    fits. Measured on an NVIDIA H100 80GB HBM3 (700 W, ``chip_smoke.py``)
    at batch 4096, d 32, hidden 128 (512 blocks): kernel 9 took 2.29 ms
    with both towers staged and 1.48 ms with none; kernel 10 (its sweep
    split from the contraction) 5.55 ms with both, 9.96-10.08 with one and
    8.17 with none; kernel 14 about 18.0, 16.6-16.7 and 19.8 ms with all
    three, drift and prior, none. Kernel 13 took 3.19-3.23 ms with none
    staged in the 8-row design this rule chose for it before
    :func:`forward_design`, which puts all three in one block of 32 rows:
    2.03 ms (``chip_smoke.py --only ab``)."""
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
    """A sweep's library once the solve's activations fit a block's
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


# Kernels 11 and 13: a block of R rows runs the step loop (csrc/
# tower_fwd_tile.cuh). The rows a block may take; the threads a tower takes
# in a block that holds every tower (FWD_WIDE_THREADS where its widest
# layer times R reaches FWD_WIDE_ITEMS, else FWD_STREAM_THREADS); the
# threads of a cluster's block (one tower each); and the threads a tower
# takes when some towers stream from L2 (the 8-row design before the
# tiles).
FWD_ROWS = (8, 16, 32)
FWD_WIDE_THREADS = 256
FWD_WIDE_ITEMS = 4096
FWD_CLUSTER_THREADS = 512
FWD_STREAM_THREADS = 128
# Kernel 9's 3xTF32 tiles (csrc/tower_fwd_tile.cuh: mma_layer): MMA_ROWS
# rows a block (two m16 tiles: at 8 or 16 rows, an m16 tile half zero or
# one a block, they lost to the FMA tiles, forward_design), a warp a job of
# MMA_TILES_A_WARP 16 x 8 output tiles of a tower's widest layer, at most
# MMA_MAX_WARPS warps a tower.
MMA_ROWS = 32
MMA_TILES_A_WARP = 4
MMA_MAX_WARPS = 8
_PLAN_INTS = 10       # csrc/tower_solve_common.cuh: sizeof(Layer) / 4
_UNITS_A_PART = 8     # csrc/tower_fwd_tile.cuh: UP


class FwdDesign(NamedTuple):
    """How kernel 11 or 13 runs a solve: blocks of ``cluster`` (1, or a
    block for each tower), ``rows`` rows a block (or cluster), ``threads``
    threads a block, the towers of ``stage`` (bit t: tower t) in shared
    memory."""
    cluster: int
    rows: int
    threads: int
    stage: int


class EulerFwdDesign(NamedTuple):
    """How kernel 9 runs a solve: ``mma`` 1 for the 3xTF32 tiles (every
    tower in shared memory, split into TF32 halves), 0 for the FMA tiles of
    kernels 11 and 13; ``rows`` rows a block, ``threads`` threads a block,
    the towers of ``stage`` (bit t: tower t) in shared memory."""
    mma: int
    rows: int
    threads: int
    stage: int


def _pad8(n):
    return -(-n // 8) * 8


def _frag_ld(width):
    """csrc/mma_tf32.cuh: frag_ld, the stride of an activation array."""
    return width + (8 - width) % 32


def fwd_smem_bytes(kind, spec, stage, rows, cluster, mma=False):
    """Dynamic shared memory a block of kernel 9 (``EULER_FWD``), 11
    (``RH_FWD``) or 13 (``EULER_LOGQP_FWD``) takes at this design, as the C
    layout (``csrc/tower_fwd_tile.cuh: make_tile_layout``, or with ``mma``
    kernel 9's 3xTF32 ``make_mma_layout``: :data:`MMA_ROWS` rows, every
    tower split, the outputs of layers that feed another split too;
    ``stage``, ``rows`` and ``cluster`` unused) computes it."""
    def take(at, n):
        return at + (n + 3) // 4 * 4

    shapes = _spec_shapes(spec)
    if mma:
        rows = MR = MMA_ROWS
    RS = rows + 4
    at = take(0, sum(map(len, shapes)) * _PLAN_INTS)
    if mma:
        for tower in shapes:
            for n_in, n_out, _ in tower:
                at = take(take(at, _pad8(n_in) * _pad8(n_out) * 2),
                          _pad8(n_out))
        at = take(at, MR * _frag_ld(_pad8(spec.S + int(spec.with_time))))
        for tower in shapes:
            for p in (0, 1):
                wide = max((o for _, o, _ in tower[p::2]), default=0)
                # A layer that feeds another stores a lo twin.
                parts = 2 if len(tower) - 1 > p else 1
                at = take(at, MR * _frag_ld(_pad8(wide)) * parts)
        at = take(take(at, spec.m * RS), spec.m * RS)
        return 4 * take(at, 2)
    packs = [sum(i * o + o for i, o, _ in tower) for tower in shapes]
    wide = [[max((o for _, o, _ in tower[p::2]), default=0) for p in (0, 1)]
            for tower in shapes]
    if cluster > 1:
        at = take(at, max(packs))
    else:
        for t, size in enumerate(packs):
            if (stage >> t) & 1:
                at = take(at, size)
    at = take(at, (spec.S + int(spec.with_time)) * RS)
    if cluster > 1:
        for p in (0, 1):
            at = take(at, max(w[p] for w in wide) * RS)
    else:
        for w in wide:
            at = take(take(at, w[0] * RS), w[1] * RS)
    at = take(take(at, spec.m * RS), spec.m * RS)
    at = take(at, 2)
    if kind == RH_FWD:
        for width in (spec.S, spec.S, spec.gwidth):
            at = take(at, width * RS)
    elif kind == EULER_LOGQP_FWD:
        at = take(at, -(-spec.S // _UNITS_A_PART) * RS)
    return 4 * at


def mma_threads(spec):
    """Threads of a block of kernel 9's 3xTF32 tiles: for each tower, a
    warp for every :data:`MMA_TILES_A_WARP` 16 x 8 output tiles of the
    widest layer of any tower (two m-tiles), rounded up to a power of two
    (the kernel's 1, 2, 4 or 8 warps a tower), at most
    :data:`MMA_MAX_WARPS`."""
    widest = max(o for tower in _spec_shapes(spec) for _, o, _ in tower)
    tiles = MMA_ROWS // 16 * (_pad8(widest) // 8)
    warps = 1
    while warps < MMA_MAX_WARPS and warps * MMA_TILES_A_WARP < tiles:
        warps *= 2
    return 32 * warps * (3 if spec.prior else 2)


def _one_wave(rows, B, sms, cluster=1):
    """The fewest of ``rows`` whose blocks (clusters of ``cluster``) fill
    the card in one wave, else the most; None when there are none."""
    if not rows:
        return None
    one_wave = [R for R in rows if -(-B // R) * cluster <= sms]
    return one_wave[0] if one_wave else rows[-1]


def forward_design(kind, spec, B, sms):
    """The design of kernel 9 (``EULER_FWD``, an :class:`EulerFwdDesign`),
    11 (``RH_FWD``) or 13 (``EULER_LOGQP_FWD``, a :class:`FwdDesign`) for a
    solve of B rows on a card of ``sms`` SMs, from the widths and the
    shared-memory limit alone (a block an SM: at these widths its shared
    memory allows no more). Kernel 9 takes its 3xTF32 tiles where every
    tower fits a block split and the fewest rows of :data:`FWD_ROWS` that
    fill the card in one wave (or the most) are :data:`MMA_ROWS`, on
    :func:`mma_threads` threads, else the first and third designs below.
    In order of preference:

    1. every tower in one block's shared memory, on
       :data:`FWD_WIDE_THREADS` threads a tower where its widest layer times
       R reaches :data:`FWD_WIDE_ITEMS` (items of 16 rows for every
       thread), else :data:`FWD_STREAM_THREADS`;
    2. a cluster of a block for each tower, each tower in its block's
       shared memory, :data:`FWD_CLUSTER_THREADS` a block, where its blocks
       keep at least as many SMs busy as the third design's would;
    3. 8 rows, :data:`FWD_STREAM_THREADS` a tower, the first towers of
       :data:`STAGE_ORDER` that fit staged and the others read from L2 (or,
       past one wave of blocks, none staged).

    The first two take the fewest rows of :data:`FWD_ROWS` (a cluster 16
    or 32) that still fill the card in one wave (their blocks at most
    ``sms``), else the most rows that fit. Measured on an NVIDIA H100 80GB
    HBM3 at 700 W (``chip_smoke.py --only tiles``, ms): at L1 (batch 4096,
    d 32, hidden 128) one block of 32 rows and 768 threads 2.031, of 384
    threads 2.212, 16 rows 2.507-2.555, the 8-row streamed design 3.723; at
    R1 (batch 1024, d 128) a cluster of two at 16 rows and 512 threads
    1.834, 256 threads 2.035, 768 threads 2.073, one block of 8 rows and
    512 threads, the drift staged, 2.294; at L2 (batch 1024, d 128) a
    cluster of three at 32 rows 2.690 (96 blocks), the 8-row streamed
    design 2.515 (128 blocks); on general noise with time (batch 1024, d
    16, m 4, hidden 64) 8 rows on 256 threads 0.834, 512 threads 0.848; at
    the small solve (batch 256, d 8, hidden 16) 8 rows on 384 threads
    0.412, 768 threads 0.463. Kernel 9 at E1 (batch 4096, d 32, hidden
    128): the 3xTF32 tiles of 32 rows on 512 threads 1.215, 256 threads
    1.552, 16 rows 1.559-1.947, the FMA tiles of 32 rows 1.456, the 8-row
    streamed design 2.032; on general noise with time the FMA tiles of 8
    rows 0.738, the 3xTF32 tiles 0.992-3.133; at the narrow solve (batch
    256, d 8, hidden 16) 0.319 against 0.339-0.528."""
    towers = 3 if spec.prior else 2
    full = (1 << towers) - 1
    if kind != EULER_FWD:
        return _tile_design(kind, spec, B, sms, (1, towers))
    if _one_wave(FWD_ROWS, B, sms) == MMA_ROWS and fwd_smem_bytes(
            kind, spec, full, MMA_ROWS, 1, mma=True) <= _build.MAX_SMEM_BYTES:
        return EulerFwdDesign(1, MMA_ROWS, mma_threads(spec), full)
    design = _tile_design(kind, spec, B, sms, (1,))
    return EulerFwdDesign(0, design.rows, design.threads, design.stage)


def _tile_design(kind, spec, B, sms, clusters):
    """The first of :func:`forward_design`'s three FMA tile designs that
    fits, with a cluster of each size of ``clusters`` (1: none)."""
    towers = 3 if spec.prior else 2
    full = (1 << towers) - 1
    streamed = min(-(-B // 8), sms)
    widest = max(o for tower in _spec_shapes(spec) for _, o, _ in tower)
    for cluster in clusters:
        R = _one_wave([R for R in FWD_ROWS
                       if (cluster == 1 or R > 8)
                       and fwd_smem_bytes(kind, spec, full, R, cluster)
                       <= _build.MAX_SMEM_BYTES], B, sms, cluster)
        if R is None:
            continue
        if cluster == 1:
            per = (FWD_WIDE_THREADS if widest * R >= FWD_WIDE_ITEMS
                   else FWD_STREAM_THREADS)
            return FwdDesign(1, R, per * towers, full)
        if -(-B // R) * cluster >= streamed:
            return FwdDesign(cluster, R, FWD_CLUSTER_THREADS, full)
    stage = 0
    if -(-B // 8) <= sms:
        stage = next((st for st in STAGE_ORDER[towers]
                      if fwd_smem_bytes(kind, spec, st, 8, 1)
                      <= _build.MAX_SMEM_BYTES), None)
    if stage is None or fwd_smem_bytes(kind, spec, stage, 8, 1) \
            > _build.MAX_SMEM_BYTES:
        raise ValueError("the solve's activations need more shared memory "
                         "than a block has")
    return FwdDesign(1, 8, FWD_STREAM_THREADS * towers, stage)


def _forward_library(kind, spec, B, device, design=None, stage=None):
    """The kernels' library and the launch's table and design arguments
    for kernel 9, 11 or 13: the host and device layer tables, the dims, and
    the design's stage, rows, threads and cluster (kernel 9: ``mma``), by
    the rule of :func:`forward_design` or as ``design`` (and ``stage``)
    override it."""
    if design is None:
        design = forward_design(kind, spec, B, _sm_count(device))
    if stage is not None:
        design = design._replace(stage=stage)
    euler = kind == EULER_FWD
    if euler and design.mma and design.rows != MMA_ROWS:
        raise ValueError(f"kernel 9's 3xTF32 tiles take {MMA_ROWS} rows a "
                         f"block, got {design.rows}")
    last = design.mma if euler else design.cluster
    if fwd_smem_bytes(kind, spec, design.stage, design.rows,
                      1 if euler else design.cluster,
                      mma=euler and design.mma) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"the design {tuple(design)} needs more shared "
                         f"memory than a block has")
    lib = _build.load_library()
    table = _host_table(spec)
    return lib, (table, _device_table(spec, device).data_ptr(),
                 *_dims(spec), design.stage, design.rows, design.threads,
                 last)


def _require_cuda(t):
    if not t.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{t.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def euler_solve_forward_cuda(y0, noise, t0s, dts, fw, gw, spec,
                             design=None):
    """Launch kernel 9 on the current stream; returns what
    :func:`euler_solve_forward_plain` returns. ``design`` (an
    :class:`EulerFwdDesign`) overrides :func:`forward_design`'s; every FMA
    design gives the same bits, the 3xTF32 ones other bits within the
    kernels' tolerance. Raises on tensors it does not take, on a design
    that does not fit, on a failed build and on a refused launch."""
    global euler_launches
    _require_cuda(y0)
    B, N = _check_common(spec, y0, noise, t0s, dts, fw, gw)
    lib, table_dims = _forward_library(EULER_FWD, spec, B, y0.device,
                                       design)
    ys = torch.empty((N, B, spec.S), dtype=torch.float32, device=y0.device)
    ptrs = [t.data_ptr() for t in (fw, gw, y0, noise, t0s, dts, ys)]
    rc = lib.tsde_tower_euler_fwd(*table_dims[:2], *ptrs, *table_dims[2:],
                                  B, N, y0.device.index or 0,
                                  _stream(y0.device))
    _build.check_launch(lib, rc, "tower_euler_fwd")
    euler_launches += 1
    return ys


def _check_rh(spec, y0, f0, g0, noise, t1s, dts, fw, gw):
    B, N = _check_common(spec, y0, noise, t1s, dts, fw, gw)
    check_kernel_tensor("f0", f0, (B, spec.S), torch.float32, y0.device)
    check_kernel_tensor("g0", g0, (B, spec.gwidth), torch.float32,
                        y0.device)
    return B, N


def rh_solve_forward_cuda(y0, f0, g0, noise, t1s, dts, fw, gw, spec,
                          design=None):
    """Launch kernel 11 on the current stream; returns what
    :func:`rh_solve_forward_plain` returns. ``design`` (a
    :class:`FwdDesign`) overrides :func:`forward_design`'s; every design
    gives the same bits. Raises on tensors it does not take, on a design
    that does not fit, on a failed build and on a refused launch."""
    global rh_launches
    _require_cuda(y0)
    B, N = _check_rh(spec, y0, f0, g0, noise, t1s, dts, fw, gw)
    lib, table_dims = _forward_library(RH_FWD, spec, B, y0.device, design)
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


# The most bytes kernels 10, 12 and 14's workspace may take. A solve whose
# scratch would need more is swept in windows of steps (bwd_window): the
# window, and with it the order of the weight gradients' sums, depends on
# the shapes alone, so the gradients stay bitwise repeatable.
WORKSPACE_BYTES = 2 << 30
_CHUNK_ROWS = 512     # csrc/tower_solve_common.cuh: RC


def _scratch_ld(width):
    """A scratch tensor's row stride: its width rounded up to four."""
    return (width + 3) // 4 * 4


def bwd_window(spec, B, N):
    """The steps a window of kernel 10's, 12's or 14's backward covers: all
    N where their workspace fits in :data:`WORKSPACE_BYTES`, else the most
    that fit, and at least one. A window of W steps takes W*B rows of the
    scratch (:func:`scratch_views`), a partial row of all packs' floats
    for every 512 of them, and, whatever W, the carried cotangents
    ((3S + G) floats a row of the batch) and the windows' float64 sums
    (``csrc/tower_solve_common.cuh: chain_workspace``)."""
    shapes = _spec_shapes(spec)
    cols = (sum(_scratch_ld(n_in) for tower in shapes
                for n_in, _, _ in tower[1:])
            + sum(_scratch_ld(n_out) for tower in shapes
                  for _, n_out, _ in tower))
    P = sum(n_in * n_out + n_out for tower in shapes
            for n_in, n_out, _ in tower)
    rows = -(-B // 8) * 8
    # Besides W*B*cols: at most W*B/512 + 1 partial rows, the carry, the
    # sums and one float of alignment.
    fixed = P + rows * (3 * spec.S + spec.gwidth) + 2 * P + 1
    free = WORKSPACE_BYTES // 4 - fixed
    W = free * _CHUNK_ROWS // (B * (cols * _CHUNK_ROWS + P))
    return max(1, min(N, W))


def _workspace(lib, spec, B, window, device):
    """Kernels 10, 12 and 14's workspace for windows of ``window`` steps:
    the scratch tensors of :func:`scratch_views`, the contraction's
    partial rows, the carried cotangents and the windows' sums."""
    floats = lib.tsde_tower_bwd_workspace(_host_table(spec), *_dims(spec), B,
                                          window)
    return torch.empty(floats, dtype=torch.float32, device=device)


def scratch_views(workspace, spec, B, N):
    """The scratch tensors of kernel 10's, 12's or 14's workspace, as the
    sweep writes them and the contraction reads them: per tower (drift,
    diffusion, prior) the inputs of its layers after the first and every
    layer's pre-activation cotangent, each an (N*B, width) view (rows of
    the window's N steps of B rows, step-major; after a backward of one
    window, the whole solve). The sweep's row stride is the width rounded
    up to a multiple of four; all inputs come before all cotangents, each
    in layer order (``csrc/tower_solve_common.cuh: scratch_columns``)."""
    M, at = N * B, 0

    def take(width):
        nonlocal at
        ld = _scratch_ld(width)
        view = workspace[M * at:M * (at + ld)].view(M, ld)[:, :width]
        at += ld
        return view

    shapes = _spec_shapes(spec)
    xs = [tuple(take(n_in) for n_in, _, _ in tower[1:]) for tower in shapes]
    ds = [tuple(take(n_out) for _, n_out, _ in tower) for tower in shapes]
    return tuple(zip(xs, ds))


def euler_solve_backward_cuda(y0, noise, t0s, dts, fw, gw, spec, ys, gy):
    """Launch kernel 10 (the reverse sweep, the contraction of its scratch
    into the weight gradients and the sum of the contraction's partials) on
    the current stream; returns what :func:`euler_solve_backward_plain`
    returns. Its workspace holds the scratch, N x B x (the towers' widths
    after the input) floats (1.21 GB at batch 4096, d 32, hidden 128, 128
    steps), and the partial rows; a longer solve runs in windows of steps
    (:func:`bwd_window`)."""
    return _euler_backward_cuda(y0, noise, t0s, dts, fw, gw, spec, ys,
                                gy)[0]


def _euler_backward_cuda(y0, noise, t0s, dts, fw, gw, spec, ys, gy,
                         stage=None, stages=3, workspace=None):
    """One launch of kernel 10; returns its outputs and its workspace.
    ``stage``, ``stages`` and ``workspace`` as :func:`_rh_backward_cuda`'s,
    for measurement only."""
    global euler_bwd_launches
    _require_cuda(y0)
    B, N = _check_common(spec, y0, noise, t0s, dts, fw, gw)
    for name, t in (("ys", ys), ("gy", gy)):
        check_kernel_tensor(name, t, (N, B, spec.S), torch.float32,
                            y0.device)
    lib, table_dims = _library(EULER_BWD, spec, B, y0.device, stage)
    dy0, dnoise = torch.empty_like(y0), torch.empty_like(noise)
    window = bwd_window(spec, B, N)
    if workspace is None:
        workspace = _workspace(lib, spec, B, window, y0.device)
    dw = torch.empty(fw.numel() + gw.numel(), dtype=torch.float32,
                     device=y0.device)
    ptrs = [t.data_ptr() for t in (fw, gw, y0, noise, t0s, dts, ys, gy, dy0,
                                   dnoise, workspace, dw)]
    rc = lib.tsde_tower_euler_bwd(*table_dims[:2], *ptrs, *table_dims[2:],
                                  B, N, window, stages, y0.device.index or 0,
                                  _stream(y0.device))
    _build.check_launch(lib, rc, "tower_euler_bwd")
    euler_bwd_launches += 1
    dfw, dgw = dw.split([fw.numel(), gw.numel()])
    return (dy0, dnoise, dfw, dgw), workspace


def rh_solve_backward_cuda(y0, f0, g0, noise, t1s, dts, fw, gw, spec, zs, gs,
                           gy):
    """Launch kernel 12 (the reverse sweep, the contraction of its scratch
    into the weight gradients and the sum of the contraction's partials) on
    the current stream; returns what :func:`rh_solve_backward_plain`
    returns. Its workspace holds the scratch, N x B x (the towers' widths
    after the input) floats (403 MB at batch 1024, d 128, hidden 128, 128
    steps), and the partial rows; a longer solve runs in windows of steps
    (:func:`bwd_window`)."""
    return _rh_backward_cuda(y0, f0, g0, noise, t1s, dts, fw, gw, spec, zs,
                             gs, gy)[0]


def _rh_backward_cuda(y0, f0, g0, noise, t1s, dts, fw, gw, spec, zs, gs, gy,
                      stage=None, stages=3, workspace=None):
    """One launch of kernel 12; returns its outputs and its workspace. For
    measurement only: ``stage`` overrides the towers staged in shared
    memory (a bitmask of :data:`STAGE_ORDER`), and ``stages`` runs the
    sweep alone (1) or the contraction and the reduction alone (2) on the
    ``workspace`` of an earlier call of one window (:func:`bwd_window`)."""
    global rh_bwd_launches
    _require_cuda(y0)
    B, N = _check_rh(spec, y0, f0, g0, noise, t1s, dts, fw, gw)
    for name, t, width in (("zs", zs, spec.S), ("gs", gs, spec.gwidth),
                           ("gy", gy, spec.S)):
        check_kernel_tensor(name, t, (N, B, width), torch.float32, y0.device)
    lib, table_dims = _library(RH_BWD, spec, B, y0.device, stage)
    dy0, df0, dg0 = (torch.empty_like(t) for t in (y0, f0, g0))
    dnoise = torch.empty_like(noise)
    window = bwd_window(spec, B, N)
    if workspace is None:
        workspace = _workspace(lib, spec, B, window, y0.device)
    dw = torch.empty(fw.numel() + gw.numel(), dtype=torch.float32,
                     device=y0.device)
    ptrs = [t.data_ptr() for t in (fw, gw, g0, noise, t1s, dts, zs, gs, gy,
                                   dy0, df0, dg0, dnoise, workspace, dw)]
    rc = lib.tsde_tower_rh_bwd(*table_dims[:2], *ptrs, *table_dims[2:], B, N,
                               window, stages, y0.device.index or 0,
                               _stream(y0.device))
    _build.check_launch(lib, rc, "tower_rh_bwd")
    rh_bwd_launches += 1
    dfw, dgw = dw.split([fw.numel(), gw.numel()])
    return (dy0, df0, dg0, dnoise, dfw, dgw), workspace


def _check_logqp(spec, y0, noise, t0s, dts, fw, hw, gw):
    if not spec.prior:
        raise ValueError("the logqp kernels need a prior tower in the spec")
    B, N = _check_common(spec, y0, noise, t0s, dts, fw, gw)
    check_kernel_tensor("hw", hw, (pack_size(spec.prior),), torch.float32,
                        y0.device)
    return B, N


def euler_logqp_solve_forward_cuda(y0, noise, t0s, dts, fw, hw, gw, spec,
                                   stage=None, design=None):
    """Launch kernel 13 on the current stream; returns what
    :func:`euler_logqp_solve_forward_plain` returns. ``design`` (a
    :class:`FwdDesign`) overrides :func:`forward_design`'s, and ``stage``
    the towers its block stages in shared memory (a bitmask of
    :data:`STAGE_ORDER`); every design gives the same bits. Raises on
    tensors it does not take, on a design that does not fit, on a failed
    build and on a refused launch."""
    global logqp_launches
    _require_cuda(y0)
    B, N = _check_logqp(spec, y0, noise, t0s, dts, fw, hw, gw)
    lib, table_dims = _forward_library(EULER_LOGQP_FWD, spec, B, y0.device,
                                       design, stage)
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
    """Launch kernel 14 (the reverse sweep, the contraction of its scratch
    into the weight gradients and the sum of the contraction's partials) on
    the current stream; returns what
    :func:`euler_logqp_solve_backward_plain` returns. Its workspace holds
    the scratch, N x B x (the towers' widths after the input) floats
    (1.81 GB at batch 4096, d 32, hidden 128, 128 steps), and the partial
    rows; a longer solve runs in windows of steps (:func:`bwd_window`)."""
    return _euler_logqp_backward_cuda(y0, noise, t0s, dts, fw, hw, gw, spec,
                                      ys, gy, ginc, stage)[0]


def _euler_logqp_backward_cuda(y0, noise, t0s, dts, fw, hw, gw, spec, ys, gy,
                               ginc, stage=None, stages=3, workspace=None):
    """One launch of kernel 14; returns its outputs and its workspace.
    ``stage``, ``stages`` and ``workspace`` as :func:`_rh_backward_cuda`'s,
    for measurement only."""
    global logqp_bwd_launches
    _require_cuda(y0)
    B, N = _check_logqp(spec, y0, noise, t0s, dts, fw, hw, gw)
    for name, t, width in (("ys", ys, spec.S), ("gy", gy, spec.S),
                           ("ginc", ginc, 1)):
        check_kernel_tensor(name, t, (N, B, width), torch.float32, y0.device)
    lib, table_dims = _library(EULER_LOGQP_BWD, spec, B, y0.device, stage)
    dy0, dnoise = torch.empty_like(y0), torch.empty_like(noise)
    window = bwd_window(spec, B, N)
    if workspace is None:
        workspace = _workspace(lib, spec, B, window, y0.device)
    dw = torch.empty(fw.numel() + gw.numel() + hw.numel(),
                     dtype=torch.float32, device=y0.device)
    ptrs = [t.data_ptr() for t in (fw, gw, hw, y0, noise, t0s, dts, ys, gy,
                                   ginc, dy0, dnoise, workspace, dw)]
    rc = lib.tsde_tower_euler_logqp_bwd(*table_dims[:2], *ptrs,
                                        *table_dims[2:], B, N, window, stages,
                                        y0.device.index or 0,
                                        _stream(y0.device))
    _build.check_launch(lib, rc, "tower_euler_logqp_bwd")
    logqp_bwd_launches += 1
    dfw, dgw, dhw = dw.split([fw.numel(), gw.numel(), hw.numel()])
    return (dy0, dnoise, dfw, dhw, dgw), workspace


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
