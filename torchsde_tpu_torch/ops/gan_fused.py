"""Whole-solve kernels for the SDE-GAN's two solves (counterpart of
``torchsde_tpu/ops/gan_fused.py``).

Both solves are reversible Heun at ``dt=1.0`` over 2-Linear towers
(Linear, lipswish, Linear, tanh) of tiny width: a chain of dependent steps
whose per-step products are far too small to fill the card. On the
``sdeint`` route each step is some twenty kernel launches; here each solve
is one launch of a hand-written CUDA kernel:

* **generator** (``csrc/gan_gen_fwd.cu``): Stratonovich general noise, the
  drift ``(1+S -> M -> S)`` and diffusion ``(1+S -> M -> S*m)`` towers of
  ``[t, z]``. With the carry ``(x, z, f, g)``, each step is::

      z1 = 2 x - z + dt f0 + g0 . dW
      (f1, g1) = towers(t1, z1)
      x1 = x + dt/2 (f0 + f1) + (g0 + g1) . dW/2

  where ``g . dW`` is the per-row ``(S, m) @ (m)`` product;
* **critic** (``csrc/gan_cde_fwd.cu``): the drift-only CDE
  ``dh = F(t, h) X'(t) dt`` with the control slopes streamed in per step,
  ``f1 = F(t1, z1) @ slope`` and no noise.

The initial evaluations ``f0, g0`` (and the critic's ``f0``) run as plain
PyTorch outside the kernels, as the JAX package runs them in XLA.

Each solve's gradient is one reverse sweep of a backward kernel
(``csrc/gan_gen_bwd.cuh``, ``csrc/gan_cde_bwd.cu``; a second, small kernel
sums its weight-gradient partials), so GAN training runs on the card
through four kernels. The sweep is the hand-derived reverse recurrence
of the JAX package's module docstring. It carries the
cotangents ``(ay, az, af, ag)`` of the carry ``(x, z, f, g)`` from the last
step to the first, recomputes the towers at the stored ``z_{n+1}``, and
after their backward gives ``Az = az + dz``::

    ay <- ay + 2 Az        az <- -Az        af <- dt/2 ay + dt Az
    ag <- outer(ay/2 + Az, dW)

(the critic carries ``(ay, az, af)`` and emits the slopes' cotangent).
:class:`FusedGenSolve` and :class:`FusedCDESolve` join each forward kernel
with its backward kernel in a ``torch.autograd.Function``, the counterparts
of the JAX package's ``_gen_solve`` and ``_cde_solve`` custom VJPs.

The weights are the towers' own, unpadded: the TPU kernels' 128-lane
padding and 0/1 tile matrices are not ported. A CPU tensor goes to the
plain versions (:func:`gen_solve_forward_plain`,
:func:`cde_solve_forward_plain`, :func:`gen_solve_backward_plain`,
:func:`cde_solve_backward_plain`: the same math as loops of PyTorch
operators); a CUDA tensor goes to the kernels, which raise rather than
fall back. ``gen_launches``, ``cde_launches``, ``gen_bwd_launches`` and
``cde_bwd_launches`` count the kernels' launches.

bf16 mixed mode (the JAX package's rule ``sdtype = float32 if wdtype ==
bfloat16``): with bf16 weights the generator's noise is bf16 too (drawn in
the weights' dtype, the stream a bf16 ``sdeint`` solve draws), while the
states, f0, g0, the critic's slopes, t1s, dts, the outputs and every sum
are float32. Each product's inputs are rounded to bf16 and it sums in
float32 (the JAX package's ``_tower_fwd`` and ``_tower_bwd``); the biases,
lipswish, tanh, the ``g . dW`` and ``F . slope`` contractions and the
updates stay float32. Gradients come back in their inputs' dtypes: the
weights' summed in float32 and rounded to bf16 once, dnoise each step's
float32 value rounded once, the rest float32. The kernels take this set of
dtypes in their ``_bf16`` instantiations (``tsde_gan_gen_fwd_bf16`` and
the rest), counted apart by ``bf16_gen_launches``, ``bf16_cde_launches``,
``bf16_gen_bwd_launches`` and ``bf16_cde_bwd_launches``; a set that mixes
the two modes is refused. The bf16 reverse sweeps are kernels of their own
on bf16 tensor cores (``csrc/gan_gen_bwd_bf16.cu``,
``csrc/gan_cde_bwd_bf16.cu`` over ``csrc/gan_bwd_bf16.cuh``: eight rows a
group of warps, one weight-gradient partial a group, the weights'
gradients rounded to bf16 by the kernel that sums the partials).
"""

import numpy as np
import torch

from . import _build
from .latent_fused import _mixed, _mm, _rnd, _suffix, _up, state_dtype
from ..core import integrate
from ..core.sdeint import host_times
from ..utils.misc import check_kernel_tensor

# Launches of the generator's and the critic's forward and backward kernels
# since import (or since a caller reset them to 0).
gen_launches = 0
cde_launches = 0
gen_bwd_launches = 0
cde_bwd_launches = 0
# The same for the kernels' bf16 mixed-mode instantiations.
bf16_gen_launches = 0
bf16_cde_launches = 0
bf16_gen_bwd_launches = 0
bf16_cde_bwd_launches = 0

# Threads per block of both kernels. A row's work stays inside one warp
# (a group of lanes per row), so this only sets how many rows a block
# holds; chip_smoke.py measures 64, 128 and 256.
THREADS = 128
# The kernels give each row one lane per state unit and one per hidden
# unit, inside one warp, and keep a unit's noise channels (generator) or
# control channels (critic) in registers.
MAX_LANES = 32
MAX_CHANNELS = 8

GEN_WEIGHT_NAMES = ("W1f", "b1f", "W2f", "b2f", "W1g", "b1g", "W2g", "b2g")
CDE_WEIGHT_NAMES = ("W1", "b1", "W2", "b2")


def odd_quad(n):
    """The smallest multiple of 4 at least ``n`` whose quarter is odd: the
    stride of the kernels' lane-major weight copies (csrc/gan_warp_rows.cuh),
    so that the eight lanes of a quarter-warp read distinct banks."""
    q = (n + 3) // 4
    return 4 * (q + 1 - q % 2)


def gen_fwd_group(S, M):
    """Lane rows of kernel 5's weight copies, as kernel 6's: 16 where
    S, M <= 16 (a row's towers on the two half-warps, 16 lanes each), else
    32 (a row's towers on all 32 lanes). Either way one row a warp."""
    return gen_bwd_group(S, M)


def gen_fwd_layout(S, M, m):
    """Kernel 5's shared memory, in floats, as ``gen_fwd_layout`` of
    csrc/gan_gen_fwd.cu lays it out: the strides of the lane-major copies
    of W1's columns (``K1``, both towers) and W2's 1 + m columns of a unit
    (``K2``), the block's part (``block``) and a warp's slots (``warp``)."""
    G = gen_fwd_group(S, M)
    K1, K2 = odd_quad(S), odd_quad(M)
    return dict(G=G, K1=K1, K2=K2, block=G * (2 * K1 + (1 + m) * K2),
                warp=48 + 32 * m if G == 16 else 96)


def gen_fwd_smem_bytes(S, M, m, threads):
    """Dynamic shared memory of one block of kernel 5 (the host's mirror of
    ``tsde_gan_gen_fwd_smem_bytes``): the weight copies, then each warp's
    slots."""
    L = gen_fwd_layout(S, M, m)
    return 4 * (L["block"] + threads // 32 * L["warp"])


def gen_bwd_group(S, M):
    """Lanes of a row of kernel 6: 16 where S, M <= 16 (two rows a warp),
    else 32."""
    return 16 if max(S, M) <= 16 else 32


def gen_bwd_layout(S, M, m):
    """Kernel 6's shared memory, in floats, as ``gen_layout`` of
    csrc/gan_gen_bwd.cuh lays it out: the lane-major weight copies' strides
    (``K1`` layer 1, ``K2`` layer 2, ``K3`` the drift's and the diffusion's
    hidden cotangents, ``K4`` dz), the block's part (``block``) and a row's
    slot (``row``)."""
    G = gen_bwd_group(S, M)
    K1, K2, K4 = odd_quad(S), odd_quad(M), odd_quad(2 * M)
    K3 = (odd_quad(S), odd_quad(S * m))
    block = G * (2 * K1 + K2 + m * K2 + K3[0] + K3[1] + K4)
    return dict(G=G, K1=K1, K2=K2, K3=K3, K4=K4, block=block,
                row=(6 + m) * G)


def gen_bwd_smem_bytes(S, M, m, threads):
    """Dynamic shared memory of one block of kernel 6 (the host's mirror of
    ``tsde_gan_gen_bwd_smem_bytes``): the weight copies, then each warp's
    slots, 32 lanes' of 6 + m floats."""
    return 4 * (gen_bwd_layout(S, M, m)["block"] + threads // 32 * 32
                * (6 + m))


def cde_fwd_group(S, M):
    """Lanes of a row of kernel 7: the power of two at least max(S, M, 4)."""
    G = 4
    while G < max(S, M):
        G *= 2
    return G


def cde_fwd_layout(S, M, C):
    """Kernel 7's shared memory, in floats, as ``cde_fwd_layout`` of
    csrc/gan_cde_fwd.cu lays it out: the strides of W1's columns (``K1``)
    and W2's (``K2``), and the block's part (``block``)."""
    G = cde_fwd_group(S, M)
    K1, K2 = odd_quad(S), odd_quad(M)
    return dict(G=G, K1=K1, K2=K2, block=G * K1 + G * C * K2)


def cde_fwd_smem_bytes(S, M, C, threads):
    """Dynamic shared memory of one block of kernel 7 (the host's mirror of
    ``tsde_gan_cde_fwd_smem_bytes``): the weight copies, then 64 floats a
    warp for its rows' z1 and a1."""
    return 4 * (cde_fwd_layout(S, M, C)["block"] + threads // 32 * 64)


def _tower_weights(mlp, name):
    """The unpadded weights of a 2-Linear tanh LipMLP: W1 (in, M), b1 (M),
    W2 (M, out), b2 (out). Refuses the architectures the kernels do not
    implement."""
    if len(mlp.layers) != 2:
        raise ValueError(f"fused GAN kernels support num_layers=1 (2 Linear "
                         f"layers per tower), got {len(mlp.layers)} in "
                         f"{name}; use fused=False")
    if not mlp.tanh:
        raise ValueError(f"fused GAN kernels expect tanh towers ({name}); "
                         f"use fused=False")
    l0, l1 = mlp.layers
    return (l0.w, l0.b, l1.w, l1.b)


def gen_weights(func):
    """A GeneratorFunc's drift and diffusion weights, in GEN_WEIGHT_NAMES
    order."""
    return (_tower_weights(func.drift, "drift")
            + _tower_weights(func.diffusion, "diffusion"))


def cde_weights(func):
    """A CDEFunc's tower weights, in CDE_WEIGHT_NAMES order."""
    return _tower_weights(func.func, "func")


def lipswish_tower(x, W1, b1, W2, b2):
    """Linear, lipswish (``0.909 x sigmoid(x)``), Linear, tanh; with bf16
    weights each product's input rounded to bf16 and summed in float32."""
    return _tower_parts(x, W1, b1, W2, b2)[3]


def time_column(t, x):
    """``[t, x]``: the time ``t`` (a number or a 0-d tensor) as a first
    column of ``x``'s batch, the towers' input."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    return torch.cat([t.reshape(1, 1).expand(x.shape[0], 1), x], dim=1)


def gen_solve_forward_plain(x0, f0, g0, noise, t1s, dts, weights):
    """The generator kernel's function as a loop of PyTorch operators.

    x0, f0 (B,S); g0 (B,S*m) with ``g[b, i*m + j]`` the (i, j) entry;
    noise (N,B,m); t1s, dts (N,); weights in GEN_WEIGHT_NAMES order.
    Returns ys, zs (N,B,S) and gs (N,B,S*m): the state, the evaluation
    point and the diffusion after each step, in x0's dtype (float32 in
    mixed mode, where the weights and the noise are bf16)."""
    wf, wg = weights[:4], weights[4:]
    B, S = x0.shape
    m = noise.shape[2]
    x, z, f, g = x0, x0, f0, g0
    ys, zs, gs = [], [], []
    for s in range(noise.shape[0]):
        dt, dW = dts[s], _up(noise[s])
        g0dW = torch.einsum("bsm,bm->bs", g.reshape(B, S, m), dW)
        z1 = 2.0 * x - z + dt * f + g0dW
        zin = time_column(t1s[s], z1)
        f1 = lipswish_tower(zin, *wf)
        g1 = lipswish_tower(zin, *wg)
        gsum_dW = torch.einsum("bsm,bm->bs", (g + g1).reshape(B, S, m), dW)
        x = x + 0.5 * dt * (f + f1) + 0.5 * gsum_dW
        z, f, g = z1, f1, g1
        ys.append(x)
        zs.append(z)
        gs.append(g)
    return torch.stack(ys), torch.stack(zs), torch.stack(gs)


def cde_solve_forward_plain(h0, f0, slopes, t1s, dts, weights):
    """The critic kernel's function as a loop of PyTorch operators.

    h0, f0 (B,S); slopes (N,B,C), the control's slope at each step's end
    point; t1s, dts (N,); weights in CDE_WEIGHT_NAMES order, the tower's
    output ``F[b, i*C + c]``. Returns hs, zs (N,B,S)."""
    B, S = h0.shape
    C = slopes.shape[2]
    h, z, f = h0, h0, f0
    hs, zs = [], []
    for s in range(slopes.shape[0]):
        dt = dts[s]
        z1 = 2.0 * h - z + dt * f
        F = lipswish_tower(time_column(t1s[s], z1), *weights)
        f1 = torch.einsum("bsc,bc->bs", F.reshape(B, S, C), slopes[s])
        h = h + 0.5 * dt * (f + f1)
        z, f = z1, f1
        hs.append(h)
        zs.append(z)
    return torch.stack(hs), torch.stack(zs)


def _tower_parts(zin, W1, b1, W2, b2):
    """A tower's forward with what its backward needs: the hidden
    pre-activation, its sigmoid, the hidden activation and the output. In
    mixed mode (the JAX package's ``_tower_fwd``) ``zin`` and the hidden
    activation are rounded to bf16 as the products' inputs, the biases
    widened, the rest float32."""
    pre1 = _mm(zin, W1) + _up(b1)
    sig = torch.sigmoid(pre1)
    a1 = 0.909 * pre1 * sig
    return pre1, sig, a1, torch.tanh(_mm(a1, W2) + _up(b2))


def _tower_backward(zin, parts, W1, W2, dout):
    """The cotangent of a tower's input ``[t, z]`` from that of its output,
    and the gradients of its weights (W1, b1, W2, b2) in the state dtype.
    In mixed mode (the JAX package's ``_tower_bwd``) each product's inputs
    are rounded to bf16 and the bias sums take the unrounded cotangents."""
    cdt = W1.dtype
    pre1, sig, a1, out = parts
    dpre2 = dout * (1.0 - out * out)
    dpre1 = _mm(dpre2, W2.T) * (0.909 * (sig + pre1 * sig * (1.0 - sig)))
    grads = (_rnd(zin, cdt).T @ _rnd(dpre1, cdt), dpre1.sum(0),
             _rnd(a1, cdt).T @ _rnd(dpre2, cdt), dpre2.sum(0))
    return _mm(dpre1, W1.T), grads


def gen_solve_backward_plain(x0, f0, g0, noise, t1s, dts, weights, zs, gs,
                             gy):
    """The generator's backward kernel as a loop of PyTorch operators: the
    reverse recurrence of the JAX package's ``_gen_bwd_kernel``, which
    recomputes both towers at each step's stored ``z_{n+1}``.

    Takes the forward's inputs, its zs (N,B,S) and gs (N,B,S*m), and the
    cotangent gy (N,B,S) of ys. Returns dx0, df0 (B,S), dg0 (B,S*m), dnoise
    (N,B,m) and the weights' gradients in GEN_WEIGHT_NAMES order, each in
    its input's dtype: the weights' summed in x0's dtype (float32 in mixed
    mode) and rounded once, dnoise each step's value rounded once."""
    wf, wg = weights[:4], weights[4:]
    B, S = x0.shape
    N, _, m = noise.shape
    g_all = torch.cat([g0[None], gs]).reshape(N + 1, B, S, m)
    ay, az, af = (torch.zeros_like(x0) for _ in range(3))
    ag = x0.new_zeros((B, S, m))
    dnoise = torch.empty_like(noise)
    dw = [torch.zeros_like(w, dtype=x0.dtype) for w in weights]
    for n in reversed(range(N)):
        dt, dW = dts[n], _up(noise[n])[:, None, :]
        ay = ay + gy[n]
        Af = af + 0.5 * dt * ay
        Ag = ag + 0.5 * ay[..., None] * dW
        zin = time_column(t1s[n], zs[n])
        dzf, grads_f = _tower_backward(zin, _tower_parts(zin, *wf), wf[0],
                                       wf[2], Af)
        dzg, grads_g = _tower_backward(zin, _tower_parts(zin, *wg), wg[0],
                                       wg[2], Ag.reshape(B, S * m))
        for acc, d in zip(dw, grads_f + grads_g):
            acc += d
        Az = az + dzf[:, 1:] + dzg[:, 1:]
        g_n, g_next = g_all[n], g_all[n + 1]
        dnoise[n] = torch.einsum("bs,bsm->bm", Az, g_n) + 0.5 * torch.einsum(
            "bs,bsm->bm", ay, g_n + g_next)
        ay, az, af, ag = (ay + 2.0 * Az, -Az, 0.5 * dt * ay + dt * Az,
                          (0.5 * ay + Az)[..., None] * dW)
    return ay + az, af, ag.reshape(B, S * m), dnoise, tuple(
        d.to(w.dtype) for d, w in zip(dw, weights))


def cde_solve_backward_plain(h0, f0, slopes, t1s, dts, weights, zs, ghs):
    """The critic's backward kernel as a loop of PyTorch operators: the
    reverse recurrence of the JAX package's ``_cde_bwd_kernel``.

    Takes the forward's inputs, its zs (N,B,S) and the cotangent ghs
    (N,B,S) of hs. Returns dh0, df0 (B,S), dslopes (N,B,C) and the weights'
    gradients in CDE_WEIGHT_NAMES order, summed in h0's dtype (float32 in
    mixed mode) and rounded once to theirs. The knot times get no
    gradient, as in the JAX package."""
    B, S = h0.shape
    C = slopes.shape[2]
    ay, az, af = (torch.zeros_like(h0) for _ in range(3))
    dslopes = torch.empty_like(slopes)
    dw = [torch.zeros_like(w, dtype=h0.dtype) for w in weights]
    for n in reversed(range(slopes.shape[0])):
        dt = dts[n]
        ay = ay + ghs[n]
        Af = af + 0.5 * dt * ay
        zin = time_column(t1s[n], zs[n])
        parts = _tower_parts(zin, *weights)
        dslopes[n] = torch.einsum("bs,bsc->bc", Af,
                                  parts[3].reshape(B, S, C))
        dF = Af[..., None] * slopes[n][:, None, :]
        dz, grads = _tower_backward(zin, parts, weights[0], weights[2],
                                    dF.reshape(B, S * C))
        for acc, d in zip(dw, grads):
            acc += d
        Az = az + dz[:, 1:]
        ay, az, af = ay + 2.0 * Az, -Az, 0.5 * dt * ay + dt * Az
    return ay + az, af, dslopes, tuple(d.to(w.dtype)
                                       for d, w in zip(dw, weights))


def _wdtype(weights):
    """The dtype the kernels take for every weight (and the generator's
    noise): bf16 where the first weight is bf16 (mixed mode), else
    float32. Every other tensor is float32 in both."""
    return torch.bfloat16 if _mixed(weights) else torch.float32


def _check_tower(names, weights, in_size, out_size, dtype, device):
    W1 = weights[0]
    if W1.ndim != 2:
        raise ValueError(f"{names[0]} must be 2-D, got {tuple(W1.shape)}")
    M = W1.shape[1]
    shapes = ((in_size, M), (M,), (M, out_size), (out_size,))
    for name, w, shape in zip(names, weights, shapes):
        check_kernel_tensor(name, w, shape, dtype, device)
    return M


def check_gen_inputs(x0, f0, g0, noise, t1s, dts, weights):
    """What the generator kernel takes: contiguous tensors of matching
    shapes, all on one device, float32, or in mixed mode the eight weights
    and the noise bf16 (the rest float32). Returns (B, S, M, m, N); raises
    ValueError on anything else, a set mixing the two modes too."""
    if x0.ndim != 2 or noise.ndim != 3:
        raise ValueError("expected x0 (B,S) and noise (N,B,m)")
    if len(weights) != len(GEN_WEIGHT_NAMES):
        raise ValueError(f"expected {len(GEN_WEIGHT_NAMES)} weight tensors")
    B, S = x0.shape
    N, _, m = noise.shape
    wdtype = _wdtype(weights)
    for name, t, shape in (("x0", x0, (B, S)), ("f0", f0, (B, S)),
                           ("g0", g0, (B, S * m)), ("noise", noise, (N, B, m)),
                           ("t1s", t1s, (N,)), ("dts", dts, (N,))):
        dtype = wdtype if name == "noise" else torch.float32
        check_kernel_tensor(name, t, shape, dtype, x0.device)
    M = _check_tower(GEN_WEIGHT_NAMES[:4], weights[:4], 1 + S, S, wdtype,
                     x0.device)
    Mg = _check_tower(GEN_WEIGHT_NAMES[4:], weights[4:], 1 + S, S * m,
                      wdtype, x0.device)
    if Mg != M:
        raise ValueError(f"the drift and diffusion towers have widths {M} "
                         f"and {Mg}; the kernel takes one width")
    return B, S, M, m, N


def check_cde_inputs(h0, f0, slopes, t1s, dts, weights):
    """What the critic kernel takes: contiguous tensors of matching shapes,
    all on one device, float32, or in mixed mode the four weights bf16 (the
    rest float32). Returns (B, S, M, C, N); raises ValueError on anything
    else, a set mixing the two modes too."""
    if h0.ndim != 2 or slopes.ndim != 3:
        raise ValueError("expected h0 (B,S) and slopes (N,B,C)")
    if len(weights) != len(CDE_WEIGHT_NAMES):
        raise ValueError(f"expected {len(CDE_WEIGHT_NAMES)} weight tensors")
    B, S = h0.shape
    N, _, C = slopes.shape
    for name, t, shape in (("h0", h0, (B, S)), ("f0", f0, (B, S)),
                           ("slopes", slopes, (N, B, C)), ("t1s", t1s, (N,)),
                           ("dts", dts, (N,))):
        check_kernel_tensor(name, t, shape, torch.float32, h0.device)
    M = _check_tower(CDE_WEIGHT_NAMES, weights, 1 + S, S * C,
                     _wdtype(weights), h0.device)
    return B, S, M, C, N


def check_gen_backward_inputs(x0, f0, g0, noise, t1s, dts, weights, zs, gs,
                              gy):
    """What the generator's backward kernel takes: the forward kernel's
    inputs, and zs, gy (N,B,S) and gs (N,B,S*m), float32 contiguous on the
    same device. Returns (B, S, M, m, N)."""
    B, S, M, m, N = check_gen_inputs(x0, f0, g0, noise, t1s, dts, weights)
    for name, t, shape in (("zs", zs, (N, B, S)), ("gs", gs, (N, B, S * m)),
                           ("gy", gy, (N, B, S))):
        check_kernel_tensor(name, t, shape, torch.float32, x0.device)
    return B, S, M, m, N


def check_cde_backward_inputs(h0, f0, slopes, t1s, dts, weights, zs, ghs):
    """What the critic's backward kernel takes: the forward kernel's inputs,
    and zs, ghs (N,B,S), float32 contiguous on the same device. Returns
    (B, S, M, C, N)."""
    B, S, M, C, N = check_cde_inputs(h0, f0, slopes, t1s, dts, weights)
    for name, t in (("zs", zs), ("ghs", ghs)):
        check_kernel_tensor(name, t, (N, B, S), torch.float32, h0.device)
    return B, S, M, C, N


def check_widths(S, M, channels, threads=THREADS):
    """The kernels' limits: one lane per state unit and per hidden unit of
    a row, inside one warp (S, M <= 32), at most 8 noise or control
    channels per state unit (kept in registers), and a block of whole warps
    of at most 256 threads. Raises ValueError beyond them."""
    if not (1 <= S <= MAX_LANES and 1 <= M <= MAX_LANES):
        raise ValueError(f"the fused GAN kernels give each row one lane per "
                         f"state and hidden unit inside a warp, so S and M "
                         f"must be <= {MAX_LANES}; got S={S}, M={M}")
    if not 1 <= channels <= MAX_CHANNELS:
        raise ValueError(f"the fused GAN kernels keep at most {MAX_CHANNELS} "
                         f"noise or control channels per unit in registers; "
                         f"got {channels}")
    if threads % 32 or not 32 <= threads <= 256:
        raise ValueError(f"threads per block must be a multiple of 32 in "
                         f"[32, 256], got {threads}")


def _entry(lib, name, weights):
    """The C entry point of kernel ``name`` for the weights' dtype: its
    ``_bf16`` instantiation in mixed mode. The input checks have held every
    tensor to that entry's dtypes, so neither entry ever receives the
    other's pointers."""
    return getattr(lib, f"tsde_gan_{name}{_suffix(weights)}")


def gen_solve_forward_cuda(x0, f0, g0, noise, t1s, dts, weights,
                           threads=THREADS):
    """Launch the generator kernel (its bf16 instantiation for bf16
    weights) on the current stream; returns what
    :func:`gen_solve_forward_plain` returns. Raises on tensors it does not
    take, on a failed build and on a refused launch."""
    global gen_launches, bf16_gen_launches
    if not x0.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{x0.device}")
    B, S, M, m, N = check_gen_inputs(x0, f0, g0, noise, t1s, dts, weights)
    check_widths(S, M, m, threads)
    lib = _build.library_for("tsde_gan_gen_fwd_smem_bytes", S, M, m,
                             threads)
    f32 = dict(dtype=torch.float32, device=x0.device)
    ys = torch.empty((N, B, S), **f32)
    zs = torch.empty((N, B, S), **f32)
    gs = torch.empty((N, B, S * m), **f32)
    ptrs = [t.data_ptr() for t in (x0, f0, g0, noise, t1s, dts, *weights,
                                   ys, zs, gs)]
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    rc = _entry(lib, "gen_fwd", weights)(*ptrs, B, S, M, m, N, threads,
                                          x0.device.index or 0, stream)
    _build.check_launch(lib, rc, "gan_gen_fwd")
    if _mixed(weights):
        bf16_gen_launches += 1
    else:
        gen_launches += 1
    return ys, zs, gs


def cde_solve_forward_cuda(h0, f0, slopes, t1s, dts, weights,
                           threads=THREADS):
    """Launch the critic kernel (its bf16 instantiation for bf16 weights)
    on the current stream; returns what :func:`cde_solve_forward_plain`
    returns. Raises on tensors it does not take, on a failed build and on a
    refused launch."""
    global cde_launches, bf16_cde_launches
    if not h0.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{h0.device}")
    B, S, M, C, N = check_cde_inputs(h0, f0, slopes, t1s, dts, weights)
    check_widths(S, M, C, threads)
    lib = _build.library_for("tsde_gan_cde_fwd_smem_bytes", S, M, C,
                             threads)
    hs = torch.empty((N, B, S), dtype=torch.float32, device=h0.device)
    zs = torch.empty_like(hs)
    ptrs = [t.data_ptr() for t in (h0, f0, slopes, t1s, dts, *weights,
                                   hs, zs)]
    stream = torch.cuda.current_stream(h0.device).cuda_stream
    rc = _entry(lib, "cde_fwd", weights)(*ptrs, B, S, M, C, N, threads,
                                          h0.device.index or 0, stream)
    _build.check_launch(lib, rc, "gan_cde_fwd")
    if _mixed(weights):
        bf16_cde_launches += 1
    else:
        cde_launches += 1
    return hs, zs


def _weight_grads(lib, B, S, M, weights, device):
    """The backward kernels' weight-gradient buffers: one float32 partial
    per warp of the sweep (a group of 8 rows in bf16 mixed mode), and the
    flat output the second kernel sums them into, the weights' gradients
    back to back in the weights' dtype (the bf16 sum kernel rounds the
    float32 sums once)."""
    sizes = [w.numel() for w in weights]
    mixed = _mixed(weights)
    n = (lib.tsde_gan_bwd_partials_bf16(B) if mixed
         else lib.tsde_gan_bwd_partials(B, S, M))
    partials = torch.empty((n, sum(sizes)),
                           dtype=torch.float32, device=device)
    return sizes, partials, torch.empty(
        sum(sizes), dtype=weights[0].dtype if mixed else torch.float32,
        device=device)


def _split_grads(dw, sizes, weights):
    """The flat weight gradients (in the weights' dtype: bf16 in mixed
    mode, rounded once by the kernel) as the weights' shapes."""
    return tuple(d.view_as(w) for d, w in zip(dw.split(sizes), weights))


def gen_solve_backward_cuda(x0, f0, g0, noise, t1s, dts, weights, zs, gs, gy,
                            threads=THREADS):
    """Launch the generator's backward kernel (the reverse sweep, then the
    sum of its per-warp weight-gradient partials; its bf16 instantiation
    for bf16 weights) on the current stream; returns what
    :func:`gen_solve_backward_plain` returns. Raises on tensors it does not
    take, on a failed build and on a refused launch."""
    global gen_bwd_launches, bf16_gen_bwd_launches
    if not x0.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{x0.device}")
    B, S, M, m, N = check_gen_backward_inputs(x0, f0, g0, noise, t1s, dts,
                                              weights, zs, gs, gy)
    check_widths(S, M, m, threads)
    lib = _build.library_for(f"tsde_gan_gen_bwd_smem_bytes{_suffix(weights)}",
                             S, M, m, threads)
    dx0, df0 = torch.empty_like(x0), torch.empty_like(f0)
    dg0 = torch.empty_like(g0)
    dnoise = torch.empty_like(noise)
    sizes, partials, dw = _weight_grads(lib, B, S, M, weights, x0.device)
    ptrs = [t.data_ptr() for t in (g0, noise, t1s, dts, *weights, zs, gs, gy,
                                   dx0, df0, dg0, dnoise, partials, dw)]
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    rc = _entry(lib, "gen_bwd", weights)(*ptrs, B, S, M, m, N, threads,
                                          x0.device.index or 0, stream)
    _build.check_launch(lib, rc, "gan_gen_bwd")
    if _mixed(weights):
        bf16_gen_bwd_launches += 1
    else:
        gen_bwd_launches += 1
    return dx0, df0, dg0, dnoise, _split_grads(dw, sizes, weights)


def cde_solve_backward_cuda(h0, f0, slopes, t1s, dts, weights, zs, ghs,
                            threads=THREADS):
    """Launch the critic's backward kernel (the reverse sweep, then the sum
    of its per-warp weight-gradient partials; its bf16 instantiation for
    bf16 weights) on the current stream; returns what
    :func:`cde_solve_backward_plain` returns. Raises on tensors it does not
    take, on a failed build and on a refused launch."""
    global cde_bwd_launches, bf16_cde_bwd_launches
    if not h0.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{h0.device}")
    B, S, M, C, N = check_cde_backward_inputs(h0, f0, slopes, t1s, dts,
                                              weights, zs, ghs)
    check_widths(S, M, C, threads)
    lib = _build.library_for(f"tsde_gan_cde_bwd_smem_bytes{_suffix(weights)}",
                             S, M, C, threads)
    dh0, df0 = torch.empty_like(h0), torch.empty_like(f0)
    dslopes = torch.empty_like(slopes)
    sizes, partials, dw = _weight_grads(lib, B, S, M, weights, h0.device)
    ptrs = [t.data_ptr() for t in (slopes, t1s, dts, *weights, zs, ghs, dh0,
                                   df0, dslopes, partials, dw)]
    stream = torch.cuda.current_stream(h0.device).cuda_stream
    rc = _entry(lib, "cde_bwd", weights)(*ptrs, B, S, M, C, N, threads,
                                          h0.device.index or 0, stream)
    _build.check_launch(lib, rc, "gan_cde_bwd")
    if _mixed(weights):
        bf16_cde_bwd_launches += 1
    else:
        cde_bwd_launches += 1
    return dh0, df0, dslopes, _split_grads(dw, sizes, weights)


def _route(device, plain, cuda):
    """The plain version for CPU tensors, the kernel for CUDA tensors; no
    fallback between them."""
    if device.type == "cpu":
        return plain
    if device.type == "cuda":
        return cuda
    raise ValueError(f"no fused GAN solve for device {device}")


class FusedGenSolve(torch.autograd.Function):
    """The generator's whole solve as one differentiable operation (the
    counterpart of the JAX package's ``_gen_solve`` custom VJP): kernels 5
    and 6 on CUDA tensors, their plain versions on CPU tensors. Returns ys,
    zs and gs; zs and gs, which the backward reads, are not differentiable.
    Gradients flow to x0, f0, g0, noise and the weights; t1s and dts get
    none."""

    @staticmethod
    def forward(fctx, x0, f0, g0, noise, t1s, dts, *weights):
        solve = _route(x0.device, gen_solve_forward_plain,
                       gen_solve_forward_cuda)
        ys, zs, gs = solve(x0, f0, g0, noise, t1s, dts, weights)
        fctx.save_for_backward(x0, f0, g0, noise, t1s, dts, zs, gs,
                               *weights)
        fctx.mark_non_differentiable(zs, gs)
        return ys, zs, gs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(fctx, gy, _gz, _gg):
        x0, f0, g0, noise, t1s, dts, zs, gs, *weights = fctx.saved_tensors
        sweep = _route(x0.device, gen_solve_backward_plain,
                       gen_solve_backward_cuda)
        dx0, df0, dg0, dnoise, dweights = sweep(
            x0, f0, g0, noise, t1s, dts, weights, zs, gs, gy.contiguous())
        if not fctx.needs_input_grad[3]:
            dnoise = None
        return (dx0, df0, dg0, dnoise, None, None, *dweights)


class FusedCDESolve(torch.autograd.Function):
    """The critic's whole solve as one differentiable operation (the
    counterpart of the JAX package's ``_cde_solve`` custom VJP): kernels 7
    and 8 on CUDA tensors, their plain versions on CPU tensors. Returns hs
    and zs; zs, which the backward reads, is not differentiable. Gradients
    flow to h0, f0, slopes and the weights; t1s and dts get none."""

    @staticmethod
    def forward(fctx, h0, f0, slopes, t1s, dts, *weights):
        solve = _route(h0.device, cde_solve_forward_plain,
                       cde_solve_forward_cuda)
        hs, zs = solve(h0, f0, slopes, t1s, dts, weights)
        fctx.save_for_backward(h0, f0, slopes, t1s, dts, zs, *weights)
        fctx.mark_non_differentiable(zs)
        return hs, zs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(fctx, ghs, _gz):
        h0, f0, slopes, t1s, dts, zs, *weights = fctx.saved_tensors
        sweep = _route(h0.device, cde_solve_backward_plain,
                       cde_solve_backward_cuda)
        dh0, df0, dslopes, dweights = sweep(h0, f0, slopes, t1s, dts,
                                            weights, zs, ghs.contiguous())
        return (dh0, df0, dslopes, None, None, *dweights)


def gen_solve_forward(x0, f0, g0, noise, t1s, dts, weights):
    """The generator's whole solve through :class:`FusedGenSolve`: ys, zs,
    gs from the plain versions for CPU tensors and the kernels for CUDA
    tensors, differentiable in ys."""
    return FusedGenSolve.apply(x0, f0, g0, noise, t1s, dts, *weights)


def cde_solve_forward(h0, f0, slopes, t1s, dts, weights):
    """The critic's whole solve through :class:`FusedCDESolve`: hs, zs from
    the plain versions for CPU tensors and the kernels for CUDA tensors,
    differentiable in hs."""
    return FusedCDESolve.apply(h0, f0, slopes, t1s, dts, *weights)


def _step_grid(ts, dt, what):
    """The float64 step grid of a solve over ``ts``, which must coincide
    with ``ts`` (the SDE-GAN setting: dt=1.0 on integer knots)."""
    ts_np = host_times(ts)
    grid = integrate.build_step_grid(ts_np[0], ts_np[-1], dt)
    if len(grid) != len(ts_np) or not np.allclose(grid, ts_np, atol=1e-9):
        raise ValueError(f"fused {what} solve requires the dt-grid to "
                         f"coincide with ts (dt=1.0 on integer knots)")
    return ts_np, grid


def _grid_times(grid, dtype, device):
    """t1s, and dts by subtraction in the state dtype, as the sdeint
    route's steps use them."""
    grid_dev = torch.as_tensor(grid, dtype=dtype, device=device)
    return grid_dev[1:], grid_dev[1:] - grid_dev[:-1]


def prep_generator_solve(func, x0, ts, generator, dt):
    """The generator kernel's inputs for a solve of the GeneratorFunc
    ``func`` from ``x0`` over ``ts``: ``(x0, f0, g0, noise, t1s, dts)``,
    x0 cast (differentiably) to the state dtype (:func:`state_dtype`) and
    ``f0, g0`` evaluated at it in plain PyTorch, the noise drawn from
    ``generator`` in the weights' dtype, as a ``sdeint`` solve of the
    model draws it (the JAX package's ``generator_solve_fused``)."""
    B, S = x0.shape
    m = func.noise_size
    wdtype = func.drift.layers[0].w.dtype
    x0 = x0.to(state_dtype(wdtype))
    ts_np, grid = _step_grid(ts, dt, "generator")
    W, _, _ = integrate.sample_grid_noise(generator, grid, (B, m), wdtype,
                                          x0.device)
    f0, g0 = func.f_and_g(torch.as_tensor(ts_np[0], dtype=x0.dtype,
                                          device=x0.device), x0)
    t1s, dts = _grid_times(grid, x0.dtype, x0.device)
    return (x0.contiguous(), f0.contiguous(),
            g0.reshape(B, S * m).contiguous(), W.contiguous(), t1s, dts)


def generator_solve_fused(func, x0, ts, generator, dt):
    """Fused replacement for the Generator's
    ``sdeint(func, x0, ts, method='reversible_heun', dt=dt,
    generator=generator)``: the same noise draw and the same reversible-Heun
    algebra, states on ``ts`` (T,B,S) in the state dtype (float32 for bf16
    weights)."""
    args = prep_generator_solve(func, x0, ts, generator, dt)
    ys, _, _ = gen_solve_forward(*args, gen_weights(func))
    return torch.cat([args[0][None], ys], dim=0)


def prep_cde_solve(func, h0, ts, dt):
    """The critic kernel's inputs for a solve of the CDEFunc ``func`` (its
    path attached) from ``h0`` over ``ts``: ``(h0, f0, slopes, t1s, dts)``,
    h0 and the path cast (differentiably) to the state dtype
    (:func:`state_dtype`: float32 for bf16 weights, whose slopes are then
    float32). The path's knot times must coincide with ``ts``; they are
    constants, so gradients reach the knot values, not the knot times."""
    h0 = h0.to(state_dtype(func.func.layers[0].w.dtype))
    ts_np, grid = _step_grid(ts, dt, "CDE")
    path_ts = host_times(func._path_ts)
    if len(path_ts) != len(ts_np) or not np.allclose(path_ts, ts_np,
                                                     atol=1e-6):
        raise ValueError("fused CDE solve requires the control-path knot "
                         "times to coincide with ts")
    T = len(ts_np)
    N = T - 1
    # The slope at each step's end point t_k: the CDE's _x_dot uses the knot
    # interval searchsorted(ts, t_k, 'right') - 1, clipped to T-2.
    path = func._path_ys.to(h0.dtype)                        # (B, T, C)
    knot_dts = torch.as_tensor(np.diff(ts_np), dtype=h0.dtype,
                               device=h0.device)
    slopes = (path[:, 1:] - path[:, :-1]) / knot_dts[None, :, None]
    idx = torch.as_tensor(np.minimum(np.arange(1, N + 1), T - 2),
                          device=h0.device)
    slopes_eval = slopes.transpose(0, 1).index_select(0, idx)  # (N, B, C)
    f0 = func.f(torch.as_tensor(ts_np[0], dtype=h0.dtype, device=h0.device),
                h0)
    t1s, dts = _grid_times(grid, h0.dtype, h0.device)
    return (h0.contiguous(), f0.contiguous(), slopes_eval.contiguous(), t1s,
            dts)


def cde_final_state_fused(func, h0, ts, dt):
    """Fused replacement for the Discriminator's
    ``sdeint(func, h0, ts, method='reversible_heun', dt=dt)[-1]``, ``func``
    a CDEFunc with its path attached. Drift-only, so no noise is drawn.
    Returns the final state (B,S)."""
    hs, _ = cde_solve_forward(*prep_cde_solve(func, h0, ts, dt),
                              cde_weights(func))
    return hs[-1]
