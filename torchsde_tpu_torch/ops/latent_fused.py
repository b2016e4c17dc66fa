"""Whole-solve kernels for the flagship latent-SDE logqp Euler solve
(counterpart of ``torchsde_tpu/ops/latent_fused.py``).

The ``sdeint`` route runs some forty small operators per solver step (two
3-layer drift towers, the per-dimension diffusion nets, the logqp channel,
the state update), each a kernel launch and a round trip of (B, ·)
activations through device memory. Here the whole solve is one launch of a
hand-written CUDA kernel (``csrc/latent_fused_fwd.cu``): weights stay in
shared memory, the state in shared memory and registers, and each step reads
only its context row and noise and writes its state. Its gradient is
``csrc/latent_fused_bwd.cu``: the hand-derived reverse sweep of
``_backward_core``, which writes the towers' activations and cotangents to
a scratch workspace, then the contraction of those over all rows and steps
into the towers' weight gradients.

The kernel computes the same function as the JAX package's ``_fwd_kernel``
with ``_forward_core``, Euler–Maruyama with diagonal noise and the logqp
channel, on the unpadded per-tower weights (the TPU's 128-lane packing is not
ported). Each step, with x = [z | ctx]:

* f = softplus-MLP_f(x), h = softplus-MLP_h(z) (3 layers each);
* g_l = sigmoid(w2_l · softplus(z_l w1_l + b1_l) + b2_l) per dimension;
* u = (f - h) / where(g > 1e-7, g, 1e-7) from the pre-step z;
* q += 0.5 * sum(u * u) * dt; then z += f * dt + g * dW.

:func:`fused_solve_forward` runs the solve through :class:`FusedLatentSolve`,
which dispatches on the device of its tensors: a CPU tensor goes to the plain
versions (:func:`fused_solve_forward_plain`,
:func:`fused_solve_backward_plain`: the same math as loops of PyTorch
operators), a CUDA tensor to the kernels, which raise rather than fall back.
``launches`` and ``bwd_launches`` count the two kernels' launches. A long
solve's backward runs in windows of steps (:func:`bwd_window`), so that its
workspace stays within :data:`WORKSPACE_BYTES` a replica, and K replicas in
groups (:func:`replica_group`) within :data:`MULTI_WORKSPACE_BYTES` in all.

K independent replicas (the counterpart of the JAX package's
``_fused_solve_multi``) solve in one launch of each kernel with the replica
on the grid (``tsde_latent_fused_fwd_multi``, ``tsde_latent_fused_bwd_multi``):
:class:`FusedLatentSolveMulti` takes every per-replica tensor and weight
stacked on a leading K axis, and the replicas share ``ctx_idx`` and ``dts``.
``torch.func.vmap`` cannot map a ctypes launch, so the stacking is written
out. ``multi_launches`` and ``multi_bwd_launches`` count those launches.

bf16 mixed mode (the JAX package's rule ``sdtype = float32 if wdtype ==
bfloat16``): with bf16 weights the context, the noise and the states zs
are bf16 too, while z0, the carried state, the KL channel qs, dts, gq and
every accumulator are float32. Each product's inputs are rounded to bf16
and it sums in float32 (the JAX package's ``preferred_element_type``
dots), biases and all pointwise math are float32. Gradients come back in
their inputs' dtypes: dctx, dnoise and the weights' in bf16, each summed in
float32 and rounded once. The kernels take this set of dtypes in their
``_bf16`` instantiations (``tsde_latent_fused_fwd_bf16`` and the rest),
counted apart by ``bf16_launches``, ``bf16_bwd_launches``,
``bf16_multi_launches`` and ``bf16_multi_bwd_launches``; a set that mixes
the two modes is refused.
"""

import torch

from . import _build
from ..core import integrate
from ..core.sdeint import host_times
from ..models.layers import Linear, softplus
from ..utils.misc import check_kernel_tensor

_EPS = 1e-7   # stable_division clamp

# Launches of the forward and the backward kernel since import (or since a
# caller reset them to 0).
launches = 0
bwd_launches = 0
multi_launches = 0
multi_bwd_launches = 0
# The same for the kernels' bf16 mixed-mode instantiations.
bf16_launches = 0
bf16_bwd_launches = 0
bf16_multi_launches = 0
bf16_multi_bwd_launches = 0

# Order of the solve's weight tensors, as :func:`solve_weights` returns them.
WEIGHT_NAMES = ("f_w1", "f_b1", "f_w2", "f_b2", "f_w3", "f_b3",
                "h_w1", "h_b1", "h_w2", "h_b2", "h_w3", "h_b3",
                "g_w1", "g_b1", "g_w2", "g_b2")
# The LatentSDE parameters behind them, by dotted name.
WEIGHT_PARAMS = tuple(f"{net}_net.layers.{i}.{p}" for net in "fh"
                      for i in range(3) for p in "wb") + tuple(
                          f"g_nets.{i}" for i in range(4))


def solve_weights(model):
    """The unpadded per-tower weights of a LatentSDE, in WEIGHT_NAMES order:
    f (L+C,H), (H,), (H,H), (H,), (H,L), (L,); h (L,H), ...; g (L,1,H),
    (L,H), (L,H,1), (L,1). Refuses architectures the kernel does not
    implement."""
    for name, net in (("f_net", model.f_net), ("h_net", model.h_net)):
        if (len(net.layers) != 3 or net.activation != "softplus"
                or net.final_activation is not None):
            raise ValueError(
                f"fused latent solve requires {name} to be a 3-layer "
                f"softplus MLP with no final activation (got "
                f"{len(net.layers)} layers, activation={net.activation!r}, "
                f"final={net.final_activation!r}); use fused=False")
        if not all(isinstance(layer, Linear) for layer in net.layers):
            raise ValueError(
                f"fused latent solve takes whole weights and {name} is "
                f"split over a mesh (parallel/mesh.py:shard_latent_sde_tp); "
                f"use fused=False")
    out = []
    for net in (model.f_net, model.h_net):
        for layer in net.layers:
            out += [layer.w, layer.b]
    return tuple(out) + tuple(model.g_nets)


def state_dtype(wdtype):
    """The dtype of a solve's state, KL channel and accumulators for weights
    of ``wdtype``: float32 for bf16 weights (mixed mode), else the weights'
    own."""
    return torch.float32 if wdtype == torch.bfloat16 else wdtype


def _rnd(a, cdt):
    """``a`` as a product's input: rounded to bf16 and widened back to
    float32 where the products' dtype ``cdt`` is bf16 (mixed mode), else
    as it is."""
    return a.to(cdt).float() if cdt == torch.bfloat16 else a


def _up(t):
    """A bf16 tensor widened to float32 (exactly); any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _mm(a, w):
    """``a @ w`` as the JAX package's dot with ``preferred_element_type``
    float32: in mixed mode ``a`` rounded to bf16 and the product summed in
    float32 (a bf16 matmul on the CPU would round its output to bf16)."""
    return _rnd(a, w.dtype) @ _up(w)


def _mlp3(x, w1, b1, w2, b2, w3, b3):
    """A 3-layer softplus MLP: its two hidden activations and its output."""
    a1 = softplus(_mm(x, w1) + _up(b1))
    a2 = softplus(_mm(a1, w2) + _up(b2))
    return a1, a2, _mm(a2, w3) + _up(b3)


def _g_nets(z, gw1, gb1, gw2, gb2):
    """The per-dimension diffusion nets: their hidden activations a1g
    (L,B,H) and g (B,L)."""
    cdt = gw1.dtype
    a1g = softplus(_rnd(z, cdt).T[..., None] * _up(gw1)
                   + _up(gb1)[:, None, :])
    g = torch.sigmoid(torch.einsum("lbh,lho->lbo", _rnd(a1g, cdt), _up(gw2))
                      + _up(gb2)[:, None, :])[..., 0].T
    return a1g, g


def fused_solve_forward_plain(z0, ctx, ctx_idx, noise, dts, weights):
    """The kernel's function as a loop of PyTorch operators.

    z0 (B,L); ctx (T,B,C) with ctx_idx (n,) the context row of each step;
    noise (n,B,L); dts (n,); weights as :func:`solve_weights` returns them.
    Returns zs (n,B,L), the state after each step, in the weights' dtype
    (rounded to bf16 in mixed mode while the carried state stays float32),
    and qs (n,B,1), the running KL integral."""
    fw, hw = weights[0:6], weights[6:12]
    gw1, gb1, gw2, gb2 = weights[12:16]
    ctx_steps = ctx.index_select(0, ctx_idx.long())
    z = z0
    q = z0.new_zeros((z0.shape[0], 1))
    zs, qs = [], []
    for s in range(noise.shape[0]):
        dt = dts[s]
        f = _mlp3(torch.cat([z, _up(ctx_steps[s])], dim=1), *fw)[2]
        h = _mlp3(z, *hw)[2]
        _, g = _g_nets(z, gw1, gb1, gw2, gb2)
        gs = torch.where(g > _EPS, g, _EPS)
        u = (f - h) / gs
        q = q + 0.5 * torch.sum(u * u, dim=1, keepdim=True) * dt
        z = z + f * dt + g * _up(noise[s])
        zs.append(z)
        qs.append(q)
    return torch.stack(zs).to(weights[0].dtype), torch.stack(qs)


# The scratch tensors the reverse sweep writes for the contraction: the
# towers' hidden activations and pre-activation cotangents, each (n,B,H),
# then the output cotangents df and dh, each (n,B,L).
SCRATCH_NAMES = ("a1f", "a1h", "a2f", "a2h", "dpre1f", "dpre1h", "dpre2f",
                 "dpre2h", "df", "dh")


def fused_solve_backward_plain(z0, ctx, ctx_idx, noise, dts, weights, zs, gz,
                               gq, window=None):
    """The backward kernel's function as PyTorch operators: the reverse
    sweep of the JAX package's ``_backward_core``, which recomputes each
    step's towers from its pre-step state, composed, as the kernel is, of
    :func:`fused_solve_backward_sweep_plain` and
    :func:`fused_solve_backward_contract_plain`, over windows of ``window``
    steps, last first (all steps in one by default).

    Takes the forward's inputs, its states zs (n,B,L), and the cotangents gz
    (n,B,L) of zs and gq (n,B,1) of qs. Returns dz0 (B,L), dctx (T,B,C)
    (summed over the steps that read each context row), dnoise (n,B,L) and
    the weights' gradients in WEIGHT_NAMES order, each in its input's
    dtype (dctx and the weights' summed in the state dtype and rounded
    once)."""
    n = noise.shape[0]
    window = n if window is None else window
    carry, tower_grads = None, None
    for hi in range(n, 0, -window):
        lo = max(hi - window, 0)
        *carry, scratch = fused_solve_backward_sweep_plain(
            z0, ctx, ctx_idx, noise, dts, weights, zs, gz, gq, (lo, hi),
            carry)
        grads = fused_solve_backward_contract_plain(z0, ctx, ctx_idx, zs,
                                                    scratch, lo)
        tower_grads = grads if tower_grads is None else tuple(
            None if b is None else a + b for a, b in zip(tower_grads, grads))
    dz0, dctx, dnoise, swept = carry
    return dz0, dctx.to(ctx.dtype), dnoise, tuple(
        d.to(w.dtype) for d, w in zip(_join_grads(tower_grads, swept),
                                      weights))


def _join_grads(tower_grads, swept):
    """The 16 weights' gradients in WEIGHT_NAMES order from the
    contraction's twelve (None for a bias the sweep sums) and the sweep's
    sums: the g nets' four, then in mixed mode the towers' six biases."""
    biases = iter(swept[4:])
    return tuple(next(biases) if t is None else t
                 for t in tower_grads) + tuple(swept[:4])


def fused_solve_backward_sweep_plain(z0, ctx, ctx_idx, noise, dts, weights,
                                     zs, gz, gq, steps=None, carry=None):
    """The reverse sweep, kernel 2's first launch, as a loop of PyTorch
    operators: for each step, last to first, the towers recomputed, the
    cotangents carried back to dz, and what the later products need.

    ``steps`` ``(lo, hi)`` sweeps the window of those steps alone (all by
    default), and ``carry`` is what the sweep of the window after it
    returned (its first four outputs; None before the last window).
    Returns dz (B,L) before step lo (dz0 after the first window), dctx
    (T,B,C, in the state dtype) and dnoise (n,B,L) filled from step lo on,
    the gradients the sweep sums on chip (in the state dtype, from step lo
    on): the g nets' (gw1, gb1, gw2, gb2), and in mixed mode the towers'
    biases too (f_b1, f_b2, f_b3, h_b1, h_b2, h_b3: each step's column sums
    of the unrounded cotangents, as the JAX package's); and the window's
    scratch tensors in SCRATCH_NAMES order, each (hi - lo, B, ·), whose
    products over all its rows give the window's share of the towers'
    gradients (:func:`fused_solve_backward_contract_plain`). In mixed mode
    the scratch is bf16, what the products read: the activations and the
    cotangents rounded, as the kernel stores them."""
    fw, hw = weights[0:6], weights[6:12]
    gw1, gb1, gw2, gb2 = weights[12:16]
    cdt = weights[0].dtype
    mixed = cdt == torch.bfloat16
    lo, hi = (0, noise.shape[0]) if steps is None else steps
    idx = ctx_idx.long()
    z_pre = torch.cat([z0[None], _up(zs[:-1])])
    gz = _up(gz)
    ginc = gq.flip(0).cumsum(0).flip(0)      # cotangent of each KL increment
    if carry is None:
        dz = torch.zeros_like(z0)
        dctx = torch.zeros_like(ctx, dtype=z0.dtype)
        dnoise = torch.empty_like(noise)
        g_grads = [torch.zeros_like(w, dtype=z0.dtype) for w in (
            tuple(weights[12:16]) + (tuple(weights[1:6:2] + weights[7:12:2])
                                     if mixed else ()))]
    else:
        dz, dctx, dnoise, g_grads = carry
        dctx, dnoise = dctx.clone(), dnoise.clone()
        g_grads = [g.clone() for g in g_grads]
    records = [[None] * (hi - lo) for _ in SCRATCH_NAMES]
    L = z0.shape[1]
    for s in reversed(range(lo, hi)):
        z, dt = z_pre[s], dts[s]
        x = torch.cat([z, _up(ctx[idx[s]])], dim=1)
        a1f, a2f, f = _mlp3(x, *fw)
        a1h, a2h, h = _mlp3(z, *hw)
        a1g, g = _g_nets(z, gw1, gb1, gw2, gb2)
        big = g > _EPS
        gs = torch.where(big, g, _EPS)
        u = (f - h) / gs

        dz = dz + gz[s]
        dnoise[s] = dz * g
        du = ginc[s] * u * dt
        df = dz * dt + du / gs
        dh = -du / gs
        # stable_division clamps only the u-path; dz * dW is never masked.
        dg = dz * _up(noise[s]) - (du * u / gs) * big.to(z.dtype)

        dpre2f = _mm(df, fw[4].T) * (1 - torch.exp(-a2f))
        dpre1f = _mm(dpre2f, fw[2].T) * (1 - torch.exp(-a1f))
        dpre2h = _mm(dh, hw[4].T) * (1 - torch.exp(-a2h))
        dpre1h = _mm(dpre2h, hw[2].T) * (1 - torch.exp(-a1h))
        dx = _mm(dpre1f, fw[0].T)
        dzh = _mm(dpre1h, hw[0].T)
        dpre2g = dg * g * (1 - g)                                   # (B,L)
        dpre1g = (_rnd(dpre2g, cdt).T[..., None] * _up(gw2)[:, None, :, 0]
                  * (1 - torch.exp(-a1g)))                          # (L,B,H)
        sums = (torch.einsum("lbh,lb->lh", _rnd(dpre1g, cdt),
                             _rnd(z, cdt).T)[:, None, :],
                dpre1g.sum(1),
                torch.einsum("lbh,bl->lh", _rnd(a1g, cdt),
                             _rnd(dpre2g, cdt))[..., None],
                dpre2g.sum(0)[:, None])
        if mixed:
            sums += tuple(t.sum(0) for t in (dpre1f, dpre2f, df, dpre1h,
                                             dpre2h, dh))
        for acc, d in zip(g_grads, sums):
            acc += d
        for store, t in zip(records, (
                _rnd(a1f, cdt), _rnd(a1h, cdt), _rnd(a2f, cdt),
                _rnd(a2h, cdt), dpre1f, dpre1h, dpre2f, dpre2h, df, dh)):
            store[s - lo] = t.to(cdt) if mixed else t
        dzg = torch.einsum("lbh,lh->bl", _rnd(dpre1g, cdt),
                           _up(gw1)[:, 0, :])
        dz = dz + dx[:, :L] + dzh + dzg
        dctx.index_add_(0, idx[s:s + 1], dx[None, :, L:])
    scratch = tuple(torch.stack(t) for t in records)
    return dz, dctx, dnoise, tuple(g_grads), scratch


def fused_solve_backward_contract_plain(z0, ctx, ctx_idx, zs, scratch, lo=0):
    """The contraction, kernel 2's second launch, as PyTorch operators: the
    towers' gradients (WEIGHT_NAMES[:12]) as products and column sums over
    all rows of the sweep's scratch tensors (SCRATCH_NAMES order) of the
    steps from ``lo`` on, with the layer-1 inputs x = [z_pre |
    ctx[ctx_idx[s]]] gathered from z0, zs and ctx rather than stored. In
    mixed mode (a bf16 scratch) each product's inputs are rounded to bf16
    and the product summed in float32, and the biases are None: the sweep
    sums them."""
    a1f, a1h, a2f, a2h, dpre1f, dpre1h, dpre2f, dpre2h, df, dh = (
        t.reshape(-1, t.shape[-1]) for t in scratch)
    mixed = scratch[0].dtype == torch.bfloat16
    hi = lo + scratch[0].shape[0]
    z_pre = torch.cat([z0[None], _up(zs[:-1])])[lo:hi]
    x = torch.cat([z_pre, _up(ctx[ctx_idx[lo:hi].long()])], dim=-1)
    z_pre = z_pre.reshape(-1, z_pre.shape[-1])
    x = x.reshape(-1, x.shape[-1])

    def mm(a, b):
        return _rnd(a, zs.dtype).T @ _rnd(b, zs.dtype)

    def bias(t):
        return None if mixed else t.sum(0)

    return (mm(x, dpre1f), bias(dpre1f), mm(a1f, dpre2f), bias(dpre2f),
            mm(a2f, df), bias(df),
            mm(z_pre, dpre1h), bias(dpre1h), mm(a1h, dpre2h), bias(dpre2h),
            mm(a2h, dh), bias(dh))


def fused_solve_multi_forward_plain(z0, ctx, ctx_idx, noise, dts, weights):
    """Kernel 3's function (K stacked solves) as a loop of PyTorch
    operators: :func:`fused_solve_forward_plain` on each replica, stacked.
    Every argument but ctx_idx and dts carries a leading K axis; returns zs
    (K,n,B,L) and qs (K,n,B,1)."""
    outs = [fused_solve_forward_plain(z0[k], ctx[k], ctx_idx, noise[k], dts,
                                      [w[k] for w in weights])
            for k in range(z0.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def fused_solve_multi_backward_plain(z0, ctx, ctx_idx, noise, dts, weights,
                                     zs, gz, gq, window=None):
    """Kernel 4's function as a loop of PyTorch operators:
    :func:`fused_solve_backward_plain` on each replica (over windows of
    ``window`` steps), stacked. Returns dz0 (K,B,L), dctx (K,T,B,C), dnoise
    (K,n,B,L) and the weight gradients, each (K, ...)."""
    outs = [fused_solve_backward_plain(z0[k], ctx[k], ctx_idx, noise[k], dts,
                                       [w[k] for w in weights], zs[k], gz[k],
                                       gq[k], window)
            for k in range(z0.shape[0])]
    dz0, dctx, dnoise, dweights = zip(*outs)
    return (torch.stack(dz0), torch.stack(dctx), torch.stack(dnoise),
            tuple(torch.stack(d) for d in zip(*dweights)))


def check_kernel_inputs(z0, ctx, ctx_idx, noise, dts, weights):
    """What the kernel takes: contiguous tensors of matching shapes, all on
    one device, float32 (ctx_idx int32), or in mixed mode ctx, noise and
    every weight bf16 (z0 and dts float32). Raises ValueError on anything
    else, a set mixing the two modes too."""
    return _check_solve(z0, ctx, ctx_idx, noise, dts, weights, None)


def check_backward_inputs(z0, ctx, ctx_idx, noise, dts, weights, zs, gz, gq):
    """What the backward kernel takes: the forward kernel's inputs, and zs,
    gz (n,B,L) and gq (n,B,1), contiguous on the same device: zs and gz in
    the weights' dtype, gq float32."""
    return _check_solve(z0, ctx, ctx_idx, noise, dts, weights, None, zs, gz,
                        gq)


def check_multi_inputs(z0, ctx, ctx_idx, noise, dts, weights, *backward):
    """What the K-replica kernels take: the single kernels' tensors with a
    leading K axis on z0 (K,B,L), ctx (K,T,B,C), noise (K,n,B,L), every
    weight and, for the backward kernel, zs, gz and gq; ctx_idx (n,) and
    dts (n,) shared. Returns K, B, L, C, H, T, n."""
    if z0.ndim != 3:
        raise ValueError("expected z0 (K,B,L) for K stacked replicas")
    K = z0.shape[0]
    return (K, *_check_solve(z0, ctx, ctx_idx, noise, dts, weights, K,
                             *backward))


def _check_solve(z0, ctx, ctx_idx, noise, dts, weights, K, zs=None, gz=None,
                 gq=None):
    """The kernels' input checks; K is None for a single solve, else every
    per-replica tensor carries a leading K axis."""
    lead = () if K is None else (K,)
    nd = len(lead)
    if z0.ndim != 2 + nd or ctx.ndim != 3 + nd or noise.ndim != 3 + nd:
        raise ValueError("expected z0 (B,L), ctx (T,B,C), noise (n,B,L)"
                         + ("" if K is None else " each with a leading K"))
    B, L = z0.shape[nd:]
    T, _, C = ctx.shape[nd:]
    n = noise.shape[nd]
    if len(weights) != len(WEIGHT_NAMES):
        raise ValueError(f"expected {len(WEIGHT_NAMES)} weight tensors")
    H = weights[0].shape[-1]
    D = L + C
    want = {
        "z0": (B, L), "ctx": (T, B, C), "noise": (n, B, L),
        "f_w1": (D, H), "f_b1": (H,), "f_w2": (H, H), "f_b2": (H,),
        "f_w3": (H, L), "f_b3": (L,),
        "h_w1": (L, H), "h_b1": (H,), "h_w2": (H, H), "h_b2": (H,),
        "h_w3": (H, L), "h_b3": (L,),
        "g_w1": (L, 1, H), "g_b1": (L, H), "g_w2": (L, H, 1), "g_b2": (L, 1),
        "zs": (n, B, L), "gz": (n, B, L), "gq": (n, B, 1),
    }
    tensors = dict(z0=z0, ctx=ctx, noise=noise,
                   **dict(zip(WEIGHT_NAMES, weights)))
    if zs is not None:
        tensors.update(zs=zs, gz=gz, gq=gq)
    # The weights' dtype sets every stream's: all bf16 (mixed mode) or all
    # float32; the state, dts and gq are float32 in both.
    wdtype = weights[0].dtype
    if wdtype != torch.bfloat16:
        wdtype = torch.float32
    for name, t in tensors.items():
        dtype = wdtype if name in _STREAMS else torch.float32
        check_kernel_tensor(name, t, lead + want[name], dtype, z0.device)
    check_kernel_tensor("ctx_idx", ctx_idx, (n,), torch.int32, z0.device)
    check_kernel_tensor("dts", dts, (n,), torch.float32, z0.device)
    return B, L, C, H, T, n


# The tensors that come in the weights' dtype, bf16 in mixed mode.
_STREAMS = frozenset(("ctx", "noise", "zs", "gz") + WEIGHT_NAMES)


def _mixed(weights):
    return weights[0].dtype == torch.bfloat16


def fused_solve_forward_cuda(z0, ctx, ctx_idx, noise, dts, weights):
    """Launch the CUDA kernel on the current stream (its bf16 instantiation
    for bf16 weights). Raises on tensors it does not take, on a failed build
    and on a refused launch."""
    global launches, bf16_launches
    out = _forward_cuda(z0, ctx, ctx_idx, noise, dts, weights, multi=False)
    if _mixed(weights):
        bf16_launches += 1
    else:
        launches += 1
    return out


def fused_solve_backward_cuda(z0, ctx, ctx_idx, noise, dts, weights, zs, gz,
                              gq):
    """Launch the backward kernel (the reverse sweep, the contraction of its
    scratch tensors into the layer weights' gradients, and the sum of the
    partials) on the current stream; returns what
    :func:`fused_solve_backward_plain` returns. Its workspace holds the
    scratch tensors, n x B x (8H + 2L) floats (bf16 in mixed mode), and the
    partials: 588.4 MB at the flagship, 318.2 MB in mixed mode; a longer
    solve runs in windows of steps (:func:`bwd_window`). Raises on tensors
    it does not take, on a failed build and on a refused launch."""
    global bwd_launches, bf16_bwd_launches
    out = _backward_cuda(z0, ctx, ctx_idx, noise, dts, weights, zs, gz, gq,
                         multi=False)[0]
    if _mixed(weights):
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return out


def fused_solve_multi_forward_cuda(z0, ctx, ctx_idx, noise, dts, weights):
    """Launch kernel 3, K stacked solves with the replica on the grid, on the
    current stream; returns what :func:`fused_solve_multi_forward_plain`
    returns. Raises on tensors it does not take, on a failed build and on a
    refused launch."""
    global multi_launches, bf16_multi_launches
    out = _forward_cuda(z0, ctx, ctx_idx, noise, dts, weights, multi=True)
    if _mixed(weights):
        bf16_multi_launches += 1
    else:
        multi_launches += 1
    return out


def fused_solve_multi_backward_cuda(z0, ctx, ctx_idx, noise, dts, weights, zs,
                                    gz, gq):
    """Launch kernel 4, the reverse sweeps and contractions of K stacked
    solves and the sum of each replica's partials, on the current stream;
    returns what :func:`fused_solve_multi_backward_plain` returns. The
    replicas go in groups of :func:`replica_group` replicas, one launch of
    each phase a group and window, whose workspaces together stay within
    :data:`MULTI_WORKSPACE_BYTES` (2.35 GB, one group, at the flagship with
    K 4). Raises on tensors it does not take, on a failed build and on a
    refused launch."""
    global multi_bwd_launches, bf16_multi_bwd_launches
    out = _backward_cuda(z0, ctx, ctx_idx, noise, dts, weights, zs, gz, gq,
                         multi=True)[0]
    if _mixed(weights):
        bf16_multi_bwd_launches += 1
    else:
        multi_bwd_launches += 1
    return out


def _forward_cuda(z0, ctx, ctx_idx, noise, dts, weights, multi):
    """One launch of the forward kernel, single (kernel 1) or on K stacked
    replicas (kernel 3)."""
    if not z0.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {z0.device}")
    if multi:
        K, B, L, C, H, T, n = check_multi_inputs(z0, ctx, ctx_idx, noise, dts,
                                                 weights)
        lead = (K,)
    else:
        B, L, C, H, T, n = check_kernel_inputs(z0, ctx, ctx_idx, noise, dts,
                                               weights)
        lead = ()
    lib = _build.library_for("tsde_latent_fused_fwd_smem_bytes"
                             + _suffix(weights), L, C, H)
    zs = torch.empty(lead + (n, B, L), dtype=weights[0].dtype,
                     device=z0.device)
    qs = torch.empty(lead + (n, B, 1), dtype=torch.float32, device=z0.device)
    ptrs = [t.data_ptr() for t in (z0, ctx, ctx_idx, noise, dts, *weights,
                                   zs, qs)]
    stream = torch.cuda.current_stream(z0.device).cuda_stream
    name = ("latent_fused_fwd_multi" if multi else "latent_fused_fwd") \
        + _suffix(weights)
    rc = getattr(lib, f"tsde_{name}")(*ptrs, *lead, B, L, C, H, T, n,
                                      z0.device.index or 0, stream)
    _build.check_launch(lib, rc, name)
    return zs, qs


def _backward_cuda(z0, ctx, ctx_idx, noise, dts, weights, zs, gz, gq, multi,
                   stages=3, workspace=None):
    """The backward kernel, single (kernel 2) or on K stacked replicas
    (kernel 4, a launch of each phase for every group of
    :func:`replica_group` replicas): the sweep, the contraction and the
    reduction, over windows of :func:`bwd_window` steps. Returns its outputs
    and its workspace (replicas of a group, floats a replica; after a call
    of several groups, the last group's). In mixed mode the kernel sums dctx
    and the weights' gradients in float32, which are rounded to bf16 here,
    once.

    For measurement only, ``stages`` runs the sweep alone (1) or the
    contraction and the reduction alone (2) on the ``workspace`` of an
    earlier call of one window and one group."""
    if not z0.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{z0.device}")
    if multi:
        K, B, L, C, H, T, n = check_multi_inputs(z0, ctx, ctx_idx, noise, dts,
                                                 weights, zs, gz, gq)
        lead = (K,)
    else:
        B, L, C, H, T, n = check_backward_inputs(z0, ctx, ctx_idx, noise, dts,
                                                 weights, zs, gz, gq)
        lead = ()
    suffix = _suffix(weights)
    lib = _build.library_for(f"tsde_latent_fused_bwd_smem_bytes{suffix}", L,
                             C, H)
    f32 = dict(dtype=torch.float32, device=z0.device)
    dz0 = torch.zeros(lead + (B, L), **f32)
    dctx = torch.zeros_like(ctx, dtype=torch.float32)
    dnoise = torch.empty_like(noise)
    sizes = [w[0].numel() if multi else w.numel() for w in weights]
    dtype = weights[0].dtype
    window = bwd_window(B, L, C, H, n, dtype)
    K = lead[0] if multi else 1
    group = replica_group(K, B, L, C, H, n, dtype) if multi else 1
    if workspace is None:
        floats = getattr(lib, f"tsde_latent_fused_bwd_workspace{suffix}")
        workspace = torch.empty((group, floats(B, L, C, H, window)), **f32)
    elif stages != 3 and group < K:
        raise ValueError(f"a phase alone takes one group of replicas; "
                         f"{K} replicas go in groups of {group}")
    dw = torch.zeros(lead + (sum(sizes),), **f32)
    stream = torch.cuda.current_stream(z0.device).cuda_stream
    device = z0.device.index or 0
    name = ("latent_fused_bwd_multi" if multi else "latent_fused_bwd") + suffix
    fn = {stage: getattr(lib, f"tsde_latent_fused_bwd{stage}{suffix}")
          for stage in ("", "_multi", "_stages")}
    # Group by group on one stream, each on the same workspace: replica k's
    # launch sees only its own slices, so it is bitwise kernel 2 on them.
    for k0 in range(0, K, group):
        k1 = min(K, k0 + group)
        per = (lambda t: t[k0:k1]) if multi else (lambda t: t)
        ptrs = [t.data_ptr() for t in (
            per(z0), per(ctx), ctx_idx, per(noise), dts,
            *map(per, weights), per(zs), per(gz), per(gq), per(dz0),
            per(dctx), per(dnoise), workspace, per(dw))]
        if stages == 3 and multi:
            rc = fn["_multi"](*ptrs, k1 - k0, B, L, C, H, T, n, window,
                              device, stream)
        elif stages == 3:
            rc = fn[""](*ptrs, B, L, C, H, T, n, window, device, stream)
        else:
            rc = fn["_stages"](*ptrs, k1 - k0, B, L, C, H, T, n, window,
                               stages, device, stream)
        _build.check_launch(lib, rc, name)
    dweights = tuple(d.reshape(w.shape).to(w.dtype)
                     for d, w in zip(dw.split(sizes, dim=-1), weights))
    return (dz0, dctx.to(ctx.dtype), dnoise, dweights), workspace


def _suffix(weights):
    """The C entry points' suffix of the weights' instantiation."""
    return "_bf16" if _mixed(weights) else ""


# The most bytes a replica's workspace of kernels 2 and 4 may take. A solve
# whose scratch would need more is swept in windows of steps (bwd_window):
# the window, and with it the order of the weight gradients' sums, depends
# on one replica's shapes alone, so the gradients stay bitwise repeatable
# and replica k of kernel 4 bitwise kernel 2 on its inputs at any K.
WORKSPACE_BYTES = 2 << 30
_CHUNK_ROWS = 512     # csrc/latent_fused_bwd.cu: RC
_SWEEP_ROWS = 8       # csrc/latent_fused_bwd.cu: SWEEP_ROWS


def workspace_floats(B, L, C, H, W, dtype=torch.float32):
    """Floats of one replica's workspace of kernels 2 and 4 for windows of
    W steps and weights of ``dtype`` (``csrc/latent_fused_bwd.cu:
    sizes_of``): the scratch of W*B rows (8H + 2L floats each; in mixed
    mode as many bf16, rounded up to 4 floats), a partial row of all
    weights for every 512 rows or every sweep block of 8 rows, whichever
    are more, the blocks' carried chains (3LH + 8(2L + 1) floats each; in
    mixed mode 4H + 16L more, the bias sums) and the windows' float64 sums
    of all weights, on an even float (in mixed mode the whole rounded up to
    4 floats)."""
    mixed = dtype == torch.bfloat16
    D = L + C
    P = D * H + 2 * H * H + 2 * H * L + L * H + 4 * H + 2 * L \
        + 3 * L * H + L
    blocks = -(-B // _SWEEP_ROWS)
    parts = W * B * (8 * H + 2 * L)
    each = 3 * L * H + (2 * L + 1) * _SWEEP_ROWS
    if mixed:
        parts = _up4(parts // 2)
        each += 4 * H + 2 * L * _SWEEP_ROWS
    carry = parts + max(-(-W * B // _CHUNK_ROWS), blocks) * P
    sums = carry + blocks * each
    total = sums + sums % 2 + 2 * P
    return _up4(total) if mixed else total


def _up4(n):
    return -(-n // 4) * 4


def bwd_window(B, L, C, H, n, dtype=torch.float32):
    """The steps a window of kernel 2's or 4's backward covers for weights
    of ``dtype``: all n where one replica's workspace fits in
    :data:`WORKSPACE_BYTES`, else the most that fit, and at least one. It
    depends on one replica's shapes only, never on K; a bf16 scratch is
    half a float32 one, so mixed mode's windows are longer."""
    limit = WORKSPACE_BYTES // 4
    if workspace_floats(B, L, C, H, n, dtype) <= limit:
        return n
    lo, hi = 1, n                # the most that fit lies in [lo, hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if workspace_floats(B, L, C, H, mid, dtype) <= limit:
            lo = mid
        else:
            hi = mid
    return lo


# The most bytes kernel 4's workspaces may take together: its replicas are
# launched in groups (replica_group) whose windows' workspaces fit in it, so
# the workspace does not grow with K. A tenth of the H100's 80 GB: four
# replicas of the largest window (WORKSPACE_BYTES each), so that the
# flagship at K 4 (4 x 588.4 MB) stays one launch, and K 16 at dt 1/512
# (2,143.6 MB a replica) runs in four groups of four (8,574 MB), where
# WORKSPACE_BYTES itself would split the flagship's K 4 into 3 + 1.
MULTI_WORKSPACE_BYTES = 8 << 30


def replica_group(K, B, L, C, H, n, dtype=torch.float32):
    """The replicas one launch of kernel 4 takes for weights of ``dtype``:
    as many of the K as their workspaces for windows of :func:`bwd_window`
    steps fit together in :data:`MULTI_WORKSPACE_BYTES`, and at least one.
    Each replica's window, and so its arithmetic, is the same whatever the
    group."""
    window = bwd_window(B, L, C, H, n, dtype)
    each = 4 * workspace_floats(B, L, C, H, window, dtype)
    return max(1, min(K, MULTI_WORKSPACE_BYTES // each))


def scratch_views(workspace, B, L, H, n, dtype=torch.float32):
    """The scratch tensors of a backward kernel's workspace (K, floats) of
    one window of n steps, in SCRATCH_NAMES order, each (K, n*B, H) or (K,
    n*B, L): float32, or in mixed mode (``dtype`` bf16) bf16 views."""
    M = n * B
    K = workspace.shape[0]
    scratch = workspace
    if dtype == torch.bfloat16:
        scratch = workspace[:, :M * (4 * H + L)].view(torch.bfloat16)
    wide = scratch[:, :8 * M * H].reshape(K, 8, M, H).unbind(1)
    narrow = scratch[:, 8 * M * H:8 * M * H + 2 * M * L].reshape(
        K, 2, M, L).unbind(1)
    return wide + narrow


def _route(z0, plain, cuda):
    """The plain version for CPU tensors, the kernel for CUDA tensors; no
    fallback between them."""
    if z0.device.type == "cpu":
        return plain
    if z0.is_cuda:
        return cuda
    raise ValueError(f"no fused latent solve for device {z0.device}")


class FusedLatentSolve(torch.autograd.Function):
    """The whole solve as one differentiable operation (the counterpart of
    the JAX package's ``_fused_solve`` custom VJP): the forward kernel and
    the backward kernel on CUDA tensors, their plain versions on CPU
    tensors. Gradients flow to z0, ctx, noise and the weights; ctx_idx and
    dts get none. A cotangent that is None arrives as zeros (autograd
    materialises it)."""

    @staticmethod
    def forward(fctx, z0, ctx, ctx_idx, noise, dts, *weights):
        solve = _route(z0, fused_solve_forward_plain, fused_solve_forward_cuda)
        zs, qs = solve(z0, ctx, ctx_idx, noise, dts, weights)
        fctx.save_for_backward(z0, ctx, ctx_idx, noise, dts, zs, *weights)
        return zs, qs

    @staticmethod
    def backward(fctx, gz, gq):
        z0, ctx, ctx_idx, noise, dts, zs, *weights = fctx.saved_tensors
        sweep = _route(z0, fused_solve_backward_plain,
                       fused_solve_backward_cuda)
        dz0, dctx, dnoise, dweights = sweep(
            z0, ctx, ctx_idx, noise, dts, weights, zs, gz.contiguous(),
            gq.contiguous())
        return (dz0, dctx, None, dnoise, None, *dweights)


class FusedLatentSolveMulti(torch.autograd.Function):
    """K stacked solves as one differentiable operation (the counterpart of
    the JAX package's ``_fused_solve_multi`` custom VJP): kernels 3 and 4
    on CUDA tensors, their plain versions on CPU tensors, anything else
    raises. Takes what :func:`fused_solve_multi_forward_plain` takes;
    gradients flow to z0, ctx, noise and the weight stacks, none to ctx_idx
    and dts."""

    @staticmethod
    def forward(fctx, z0, ctx, ctx_idx, noise, dts, *weights):
        solve = _route(z0, fused_solve_multi_forward_plain,
                       fused_solve_multi_forward_cuda)
        zs, qs = solve(z0, ctx, ctx_idx, noise, dts, weights)
        fctx.save_for_backward(z0, ctx, ctx_idx, noise, dts, zs, *weights)
        return zs, qs

    @staticmethod
    def backward(fctx, gz, gq):
        z0, ctx, ctx_idx, noise, dts, zs, *weights = fctx.saved_tensors
        sweep = _route(z0, fused_solve_multi_backward_plain,
                       fused_solve_multi_backward_cuda)
        dz0, dctx, dnoise, dweights = sweep(
            z0, ctx, ctx_idx, noise, dts, weights, zs, gz.contiguous(),
            gq.contiguous())
        return (dz0, dctx, None, dnoise, None, *dweights)


def fused_solve_forward(z0, ctx, ctx_idx, noise, dts, weights):
    """Whole solve through :class:`FusedLatentSolve`: returns zs (n,B,L) and
    qs (n,B,1), differentiable, from the plain versions for CPU tensors and
    the CUDA kernels for CUDA tensors."""
    return FusedLatentSolve.apply(z0, ctx, ctx_idx, noise, dts, *weights)


def latent_logqp_solve_fused(model, z0, ts, generator, dt):
    """Fused replacement for ``sdeint(model, z0, ts, logqp=True,
    method='euler', generator=generator)``.

    Returns ``(zs, log_ratio)`` with the shapes and meaning of that route:
    zs (T,B,L) on ``ts`` by linear interpolation on the step grid, and the
    per-interval KL increments (T-1,B). It draws the same noise from
    ``generator`` as the ``sdeint`` route, so both routes of one generator
    state are directly comparable."""
    z0, ctx, ctx_idx, noise, dts, grid = _prep_solve(model, z0, ts,
                                                     generator, dt)
    zs_steps, qs_steps = fused_solve_forward(z0, ctx, ctx_idx, noise, dts,
                                             solve_weights(model))
    return _interp_tail(ts, grid, z0, zs_steps, qs_steps, model.latent_size)


def _prep_solve(model, z0, ts, generator, dt):
    """Step grid, noise, per-step context index and step widths of a solve:
    returns ``(z0, ctx, ctx_idx, noise, dts, grid)``, z0 in the state dtype
    and ctx and the noise in the weights' (:func:`state_dtype`; the
    JAX package's ``_prep_solve``). The cast of z0 is differentiable, so a
    bf16 z0 gets its gradient in bf16."""
    wdtype = model.f_net.layers[0].w.dtype
    z0 = z0.to(state_dtype(wdtype))
    grid, t0s, dts = _step_grid(ts, dt, z0)
    noise = _solve_noise(generator, grid, z0.shape[0], model.latent_size,
                         wdtype, z0.device)
    # Context row of each step: searchsorted(ctx_ts, t, 'left') at the
    # step's left end, as LatentSDE.ctx_index does on the sdeint route.
    ctx_idx = model.ctx_index(t0s).to(torch.int32)
    return z0, model._ctx.to(wdtype).contiguous(), ctx_idx, noise, dts, grid


def _step_grid(ts, dt, z0):
    """The host step grid, its left ends and its widths on z0's device. dt
    by subtraction on the grid cast to the state dtype: what the sdeint
    route's steps use, not the cast float64 differences that scale the
    noise."""
    grid = integrate.build_step_grid(*host_times(ts)[[0, -1]], dt)
    grid_dev = torch.as_tensor(grid, dtype=z0.dtype, device=z0.device)
    return grid, grid_dev[:-1], grid_dev[1:] - grid_dev[:-1]


def _solve_noise(generator, grid, B, L, dtype, device):
    """The solve's noise (n,B,L), drawn in ``dtype``, the weights' (bf16 in
    mixed mode, the stream a bf16 ``sdeint`` solve draws). The logqp state
    has one extra channel, so the sdeint route draws noise of size (B,
    L+1); drawing the same here keeps the two routes on one stream. The
    solve uses the first L channels (the logqp channel's diffusion is
    zero)."""
    W, _, _ = integrate.sample_grid_noise(generator, grid, (B, L + 1),
                                          dtype, device)
    return W[..., :L].contiguous()


def latent_logqp_solve_fused_multi(models, z0, ts, generators, dt):
    """K independent fused solves in one launch of kernel 3 (and of kernel
    4 going back), the counterpart of the JAX package's
    ``latent_logqp_solve_fused_multi``.

    ``models`` is a :class:`torchsde_tpu_torch.parallel.replicas.Replicas`
    of LatentSDEs contextualised on ``ts``: its buffers ``_ctx_ts`` (K,T)
    and ``_ctx`` (K,T,B,C) hold each replica's context. ``z0`` is
    (K,B,L), ``generators`` K generators, one a replica, each drawing the
    noise that :func:`latent_logqp_solve_fused` draws from it. Gradients
    reach the stacked parameters. Returns ``(zs, log_ratio)`` with leading
    replica axes, (K,T,B,L) and (K,T-1,B)."""
    module = models.module
    solve_weights(module)                   # refuses other architectures
    weights = [models.params[name] for name in WEIGHT_PARAMS]
    wdtype = weights[0].dtype
    z0 = z0.to(state_dtype(wdtype))
    K, B, L = z0.shape
    if len(generators) != K:
        raise ValueError(f"expected {K} generators, one a replica, got "
                         f"{len(generators)}")
    grid, t0s, dts = _step_grid(ts, dt, z0)
    noise = torch.stack([_solve_noise(g, grid, B, L, wdtype, z0.device)
                         for g in generators])
    ctx_ts, ctx = models.buffers["_ctx_ts"], models.buffers["_ctx"]
    tdtype = torch.promote_types(ctx_ts.dtype, t0s.dtype)
    ctx_idx = torch.searchsorted(ctx_ts[0].to(tdtype), t0s.to(tdtype),
                                 side="left").clamp(0, ctx.shape[1] - 1)
    zs_steps, qs_steps = FusedLatentSolveMulti.apply(
        z0, ctx.to(wdtype).contiguous(), ctx_idx.to(torch.int32), noise, dts,
        *weights)
    zs, log_ratio = zip(*(_interp_tail(ts, grid, z0[k], zs_steps[k],
                                       qs_steps[k], L) for k in range(K)))
    return torch.stack(zs), torch.stack(log_ratio)


def _interp_tail(ts, grid, z0, zs_steps, qs_steps, L):
    """States on the full grid (z0 and q0 = 0 prepended), interpolated onto
    ts and parsed as the sdeint route does (logqp -> per-interval
    differences). The bf16 zs of mixed mode join the float32 qs in
    float32, as jnp.concatenate promotes them."""
    B = z0.shape[0]
    zq_grid = torch.cat([zs_steps.to(qs_steps.dtype), qs_steps], dim=-1)
    zq0 = torch.cat([z0, z0.new_zeros((B, 1))], dim=-1)
    zq_full = torch.cat([zq0[None], zq_grid], dim=0)
    ys = integrate.linear_interp_on_grid(
        torch.as_tensor(host_times(ts), dtype=z0.dtype, device=z0.device),
        torch.as_tensor(grid, dtype=z0.dtype, device=z0.device), zq_full)
    zs = ys[:, :, :L]
    log_ratio = ys[1:, :, L] - ys[:-1, :, L]
    return zs, log_ratio
