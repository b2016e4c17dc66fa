"""Whole-solve forward kernel for the flagship latent-SDE logqp Euler solve
(counterpart of ``torchsde_tpu/ops/latent_fused.py``).

The ``sdeint`` route runs some forty small operators per solver step (two
3-layer drift towers, the per-dimension diffusion nets, the logqp channel,
the state update), each a kernel launch and a round trip of (B, ·)
activations through device memory. Here the whole solve is one launch of a
hand-written CUDA kernel (``csrc/latent_fused_fwd.cu``): weights stay in
shared memory, the state in shared memory and registers, and each step reads
only its context row and noise and writes its state.

The kernel computes the same function as the JAX package's ``_fwd_kernel``
with ``_forward_core``, Euler–Maruyama with diagonal noise and the logqp
channel, on the unpadded per-tower weights (the TPU's 128-lane packing is not
ported). Each step, with x = [z | ctx]:

* f = softplus-MLP_f(x), h = softplus-MLP_h(z) (3 layers each);
* g_l = sigmoid(w2_l · softplus(z_l w1_l + b1_l) + b2_l) per dimension;
* u = (f - h) / where(g > 1e-7, g, 1e-7) from the pre-step z;
* q += 0.5 * sum(u * u) * dt; then z += f * dt + g * dW.

:func:`fused_solve_forward` dispatches on the device of its tensors: a CPU
tensor goes to :func:`fused_solve_forward_plain` (the same math as a loop of
PyTorch operators), a CUDA tensor to the kernel, which raises rather than
falls back. ``launches`` counts kernel launches. The kernel has no backward
yet, so on CUDA the solve refuses to run while autograd records.
"""

import torch

from ..core import integrate
from ..core.sdeint import host_times
from ..models.layers import softplus

_EPS = 1e-7   # stable_division clamp

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

# Order of the solve's weight tensors, as :func:`solve_weights` returns them.
WEIGHT_NAMES = ("f_w1", "f_b1", "f_w2", "f_b2", "f_w3", "f_b3",
                "h_w1", "h_b1", "h_w2", "h_b2", "h_w3", "h_b3",
                "g_w1", "g_b1", "g_w2", "g_b2")


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
    out = []
    for net in (model.f_net, model.h_net):
        for layer in net.layers:
            out += [layer.w, layer.b]
    return tuple(out) + tuple(model.g_nets)


def _mlp3(x, w1, b1, w2, b2, w3, b3):
    a1 = softplus(x @ w1 + b1)
    a2 = softplus(a1 @ w2 + b2)
    return a2 @ w3 + b3


def fused_solve_forward_plain(z0, ctx, ctx_idx, noise, dts, weights):
    """The kernel's function as a loop of PyTorch operators.

    z0 (B,L); ctx (T,B,C) with ctx_idx (n,) the context row of each step;
    noise (n,B,L); dts (n,); weights as :func:`solve_weights` returns them.
    Returns zs (n,B,L), the state after each step, and qs (n,B,1), the
    running KL integral."""
    fw, hw = weights[0:6], weights[6:12]
    gw1, gb1, gw2, gb2 = weights[12:16]
    ctx_steps = ctx.index_select(0, ctx_idx.long())
    z = z0
    q = z0.new_zeros((z0.shape[0], 1))
    zs, qs = [], []
    for s in range(noise.shape[0]):
        dt = dts[s]
        f = _mlp3(torch.cat([z, ctx_steps[s]], dim=1), *fw)
        h = _mlp3(z, *hw)
        a1g = softplus(z.T[..., None] * gw1 + gb1[:, None, :])   # (L,B,H)
        g = torch.sigmoid(torch.einsum("lbh,lho->lbo", a1g, gw2)
                          + gb2[:, None, :])[..., 0].T          # (B,L)
        gs = torch.where(g > _EPS, g, _EPS)
        u = (f - h) / gs
        q = q + 0.5 * torch.sum(u * u, dim=1, keepdim=True) * dt
        z = z + f * dt + g * noise[s]
        zs.append(z)
        qs.append(q)
    return torch.stack(zs), torch.stack(qs)


def check_kernel_inputs(z0, ctx, ctx_idx, noise, dts, weights):
    """What the kernel takes: float32 contiguous tensors (ctx_idx int32) of
    matching shapes, all on one device. Raises ValueError on anything else."""
    if z0.ndim != 2 or ctx.ndim != 3 or noise.ndim != 3:
        raise ValueError("expected z0 (B,L), ctx (T,B,C), noise (n,B,L)")
    B, L = z0.shape
    T, _, C = ctx.shape
    n = noise.shape[0]
    if len(weights) != len(WEIGHT_NAMES):
        raise ValueError(f"expected {len(WEIGHT_NAMES)} weight tensors")
    H = weights[0].shape[-1]
    D = L + C
    want = {
        "z0": (B, L), "ctx": (T, B, C), "ctx_idx": (n,), "noise": (n, B, L),
        "dts": (n,),
        "f_w1": (D, H), "f_b1": (H,), "f_w2": (H, H), "f_b2": (H,),
        "f_w3": (H, L), "f_b3": (L,),
        "h_w1": (L, H), "h_b1": (H,), "h_w2": (H, H), "h_b2": (H,),
        "h_w3": (H, L), "h_b3": (L,),
        "g_w1": (L, 1, H), "g_b1": (L, H), "g_w2": (L, H, 1), "g_b2": (L, 1),
    }
    tensors = dict(z0=z0, ctx=ctx, ctx_idx=ctx_idx, noise=noise, dts=dts,
                   **dict(zip(WEIGHT_NAMES, weights)))
    for name, t in tensors.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        dtype = torch.int32 if name == "ctx_idx" else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes {dtype} "
                             f"(bf16 mixed mode is not ported yet)")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.device != z0.device:
            raise ValueError(f"{name} is on {t.device}, z0 on {z0.device}")
    return B, L, C, H, T, n


def fused_solve_forward_cuda(z0, ctx, ctx_idx, noise, dts, weights):
    """Launch the CUDA kernel on the current stream. Raises on tensors it
    does not take, on a failed build and on a refused launch."""
    global launches
    from . import _build

    if not z0.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {z0.device}")
    B, L, C, H, T, n = check_kernel_inputs(z0, ctx, ctx_idx, noise, dts,
                                           weights)
    lib = _build.load_library()
    smem = lib.tsde_latent_fused_fwd_smem_bytes(L, C, H)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"the solve's weights and activations need {smem} "
                         f"bytes of shared memory; a block has "
                         f"{_build.MAX_SMEM_BYTES}")
    zs = torch.empty((n, B, L), dtype=torch.float32, device=z0.device)
    qs = torch.empty((n, B, 1), dtype=torch.float32, device=z0.device)
    ptrs = [t.data_ptr() for t in (z0, ctx, ctx_idx, noise, dts, *weights,
                                   zs, qs)]
    stream = torch.cuda.current_stream(z0.device).cuda_stream
    rc = lib.tsde_latent_fused_fwd(*ptrs, B, L, C, H, T, n,
                                   z0.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError("latent_fused_fwd launch failed: "
                           + lib.tsde_cuda_error_string(rc).decode())
    launches += 1
    return zs, qs


def fused_solve_forward(z0, ctx, ctx_idx, noise, dts, weights):
    """Whole-solve forward: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (no fallback between them)."""
    if z0.device.type == "cpu":
        return fused_solve_forward_plain(z0, ctx, ctx_idx, noise, dts,
                                         weights)
    if z0.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (z0, ctx, noise, *weights)):
            raise NotImplementedError(
                "the fused latent solve has no backward kernel on CUDA yet "
                "(it is the next kernel to port); run it under "
                "torch.no_grad() or use fused=False")
        return fused_solve_forward_cuda(z0, ctx, ctx_idx, noise, dts,
                                        weights)
    raise ValueError(f"no fused latent solve for device {z0.device}")


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
    returns ``(z0, ctx, ctx_idx, noise, dts, grid)``."""
    L = model.latent_size
    B = z0.shape[0]
    ts_np = host_times(ts)
    grid = integrate.build_step_grid(ts_np[0], ts_np[-1], dt)

    # The logqp state has one extra channel, so the sdeint route draws noise
    # of size (B, L+1); drawing the same here keeps the two routes on one
    # stream. The solve uses the first L channels (the logqp channel's
    # diffusion is zero).
    W, _, _ = integrate.sample_grid_noise(generator, grid, (B, L + 1),
                                          z0.dtype, z0.device)
    noise = W[..., :L].contiguous()

    # Context row of each step: searchsorted(ctx_ts, t, 'left') at the
    # step's left end, as LatentSDE.ctx_index does on the sdeint route.
    t0s = torch.as_tensor(grid[:-1], dtype=z0.dtype, device=z0.device)
    ctx_idx = model.ctx_index(t0s).to(torch.int32)

    # dt by subtraction on the grid cast to the state dtype: what the sdeint
    # route's steps use, not the cast float64 differences that scale the
    # noise.
    grid_dev = torch.as_tensor(grid, dtype=z0.dtype, device=z0.device)
    dts = grid_dev[1:] - grid_dev[:-1]
    return z0, model._ctx.contiguous(), ctx_idx, noise, dts, grid


def _interp_tail(ts, grid, z0, zs_steps, qs_steps, L):
    """States on the full grid (z0 and q0 = 0 prepended), interpolated onto
    ts and parsed as the sdeint route does (logqp -> per-interval
    differences)."""
    B = z0.shape[0]
    zq_grid = torch.cat([zs_steps, qs_steps], dim=-1)
    zq0 = torch.cat([z0, z0.new_zeros((B, 1))], dim=-1)
    zq_full = torch.cat([zq0[None], zq_grid], dim=0)
    ys = integrate.linear_interp_on_grid(
        torch.as_tensor(host_times(ts), dtype=z0.dtype, device=z0.device),
        torch.as_tensor(grid, dtype=z0.dtype, device=z0.device), zq_full)
    zs = ys[:, :, :L]
    log_ratio = ys[1:, :, L] - ys[:-1, :, L]
    return zs, log_ratio
