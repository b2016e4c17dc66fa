"""Run torchsde_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and cuDNN;
2. build: builds the CUDA kernels from the repository's sources with nvcc
   (one process per source, in parallel) and prints ptxas's registers,
   spills and barriers for each kernel;
3. kernel 1 vs plain: the whole-solve forward kernel against its plain
   PyTorch version at the flagship shapes, with the error and median times;
4. kernel 2 vs plain: the reverse-sweep kernel against its plain version on
   the same seeded inputs and cotangents, with normal and with saturated
   diffusion; two calls must agree bitwise; median times;
5. serve: a flagship LatentSDE (batch 1024, data 3, latent 4, context 64,
   hidden 128, 32 output times on [0, 1], dt 1/128, float32, random
   weights from a seed) serves three forward passes of
   ``latent_sde_loss(fused=True)`` under ``torch.no_grad()`` on stochastic
   Lorenz data; each loss must be finite, agree with the ``sdeint`` route
   (``fused=False``) on the same generator seed, and kernel 1 must have
   been launched exactly once per pass;
6. train: the step-0 parameter gradients of the fused route against the
   ``sdeint`` route's autograd on one generator seed; then five Adam steps
   (lr 1e-2, KL weight min(1, step/50)) of each route in turns, each loss
   and gradient finite, each fused step launching kernels 1 and 2 once;
   the median train-step time of each route;
7. profile: a forward pass and a train step of each route under
   torch.profiler, for the kernel count, device time and the device's busy
   share;
8. GAN kernels vs plain: the SDE-GAN generator kernel (kernel 5) and critic
   kernel (kernel 7) against their plain versions on seeded inputs at the
   reference scale (batch 1024, the critic over 2048 rows, 63 steps),
   with each output's error, the median times, and the median time at 64,
   128 and 256 threads per block;
9. serve GAN: a Generator and a Discriminator at the reference scale
   (data 1, initial noise 5, noise 3, hidden 16 and 17, MLP 16, one hidden
   layer, init multipliers 3.0 and 0.5, float32, random weights from a seed)
   on OU data from ``get_ou_data`` answer three requests of
   ``gan_loss(fused=True)`` under ``torch.no_grad()``, each launching
   kernels 5 and 7 exactly once, and the same three on the ``sdeint`` route;
   the generated paths, the per-sample critic scores and the losses of the
   two routes must agree; request times and generated samples per second;
10. profile GAN: a served request of each route under torch.profiler;
11. GAN backward kernels vs plain: kernel 6 (the generator's reverse
    sweep) and kernel 8 (the critic's) against their plain versions at the
    reference scale, on the forward kernels' own zs and gs and seeded
    cotangents (for kernel 8 both dense ones and ones of the last state
    only, as a training step gives), every output and weight gradient in
    float32 and against a float64 run; two calls must agree bitwise; the
    median times at 64, 128 and 256 threads per block;
12. train GAN: the step-0 parameter gradients of ``gan_grads(fused=True)``
    against ``gan_grads(fused=False)`` on one generator seed; then five
    training steps of each route in turns from the same seeded weights and
    real batches: Adadelta with weight decay 0.01 (generator lr 2e-4,
    critic lr 1e-3, as examples/sde_gan.py) and the critic's weight clip;
    each loss and gradient finite, the critic's weights within 1/out, each
    fused step launching kernels 5, 6, 7 and 8 exactly once and the
    ``sdeint`` route none; the median train-step time of each route;
13. profile GAN train: a training step of each route under torch.profiler;
14. tower kernels vs plain: ``fused_sdeint``'s kernels 9 and 10 (Euler) at
    E1 (batch 4096, d 32, hidden 128) and 11 and 12 (reversible Heun) at R1
    (batch 1024, d 128, hidden 128, whose towers do not fit a block's
    shared memory), 128 steps, seeded inputs and cotangents: every output
    and weight gradient against the plain versions and a float64 run, two
    sweeps bitwise equal, median times and bounds; then all four on general
    noise with a time column and depth-3 towers (batch 1024, d 16, m 4,
    hidden 64);
15. serve and train ``fused_sdeint`` at E1 and at R1: three served solves
    per route (``dispatch="fused"`` and ``"xla"``, the ``sdeint`` route) on
    the same generator seeds, whose states must agree, each fused solve
    launching its forward kernel once; the step-0 gradients of both routes;
    three Adam steps (lr 1e-3) of mean(ys**2) per route in turns, each loss
    and gradient finite, each fused step launching the forward and the
    backward kernel once; median times;
16. profile: a training step of each route at E1 and R1 under
    torch.profiler;
17. auto dispatch: the grad path of the JAX package's
    benchmarks/fused_solve_bench.py on both routes at its narrow shapes,
    E1, R1 and a tiny solve, the measurement behind ``_auto_fuse``;
18. logqp kernels vs plain: ``fused_sdeint_logqp``'s kernels 13 and 14 at
    L1 (E1's towers and a prior drift shaped like the drift), L2 (R1's
    widths, batch 1024) and a small solve whose tanh diffusion takes both
    signs and passes near zero: every output and weight gradient against
    the plain versions and a float64 run, two sweeps bitwise equal, median
    times and bounds, and the times of each way of staging the towers;
19. serve and train ``fused_sdeint_logqp`` at L1: three served solves per
    route (``dispatch="fused"`` and the ``sdeint`` route of
    ``tower_sde(prior=)``), whose states and KL increments must agree; the
    step-0 gradients of both routes; three Adam steps (lr 1e-3) of
    mean(ys**2) + mean(sum(log_ratio, 0)) per route in turns, each fused
    step launching kernels 13 and 14 once; a profiled step of each route;
20. auto dispatch of ``fused_sdeint_logqp``: its grad path on both routes
    at the narrow shapes of phase 17, at L1 and on a tiny solve.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from torchsde_tpu_torch.models.latent_sde import (LatentSDE, latent_sde_loss,
                                                  make_lorenz_data)
from torchsde_tpu_torch.models.sde_gan import (Discriminator, Generator,
                                               gan_grads, gan_loss,
                                               get_ou_data)
from torchsde_tpu_torch.core import integrate as TI
from torchsde_tpu_torch.ops import _build
from torchsde_tpu_torch.ops import fused_solve as FS
from torchsde_tpu_torch.ops import gan_fused as GF
from torchsde_tpu_torch.ops import latent_fused as LF

# Flagship configuration (bench.py:26-34 of the JAX package).
BATCH, DATA, LATENT, CONTEXT, HIDDEN = 1024, 3, 4, 64, 128
N_TS, DT = 32, 1.0 / 128
SEED = 0

# Kernel vs plain on the same inputs, 128 dependent float32 steps
# (tests/test_fused_latent.py:55). The two sum the towers' products in
# another order (cuBLAS vs one FMA chain per hidden unit), and the steps
# carry that rounding forward.
KERNEL_ATOL = 1e-5
# Kernel 2 vs plain, per output tensor: the JAX package's rule for its fused
# against its XLA gradients (tests/test_fused_latent.py:73-79), atol
# max(1e-4, 3e-5 * the tensor's largest entry). The kernel sums every weight
# gradient over rows and steps in another order than the plain version's
# matmuls, in float32.
BWD_ATOL, BWD_REL = 1e-4, 3e-5
# Fused vs sdeint route on one loss (tests/test_fused_latent.py:86).
LOSS_RTOL = 1e-4
# Fused vs sdeint route, step-0 parameter gradients: atol GRAD_REL times
# each gradient's largest entry. Both are float32 through 128 steps and sum
# in other orders (the kernels' per-row FMA chains and fixed-order partials,
# cuBLAS on the other route). Measured 5.2e-7 at the flagship (NVIDIA H100
# 80GB HBM3, 700 W), so 1e-5 leaves a margin of 20.
GRAD_REL = 1e-5
TRAIN_STEPS, LR, KL_ANNEAL = 5, 1e-2, 50   # examples/latent_sde_lorenz.py
# SDE-GAN at the reference's scale (benchmarks/sde_gan_bench.py:195-203 of
# the JAX package, the reference example's defaults), nothing cut; the init
# multipliers of examples/sde_gan.py:34-37.
GAN_BATCH, GAN_T, GAN_DT = 1024, 64, 1.0
GAN_DATA, GAN_INIT_NOISE, GAN_NOISE = 1, 5, 3
GAN_HIDDEN, GAN_CRITIC_HIDDEN, GAN_MLP, GAN_LAYERS = 16, 17, 16, 1
GAN_MULT1, GAN_MULT2 = 3.0, 0.5
# Kernels 5 and 7 vs plain on the same inputs, 63 dependent float32 steps:
# atol max(GAN_KERNEL_ATOL, GAN_KERNEL_REL * the output's largest entry).
# 1e-5 is the JAX package's fused-vs-XLA tolerance at its test size
# (tests/test_fused_gan.py:58,81); at this scale the random-weight states
# grow to 80-100 by the last step, where one float32 ulp is 7.6e-6, and the
# kernel and its plain version sum in other orders (one FMA chain per lane
# against cuBLAS). Measured (NVIDIA H100 80GB HBM3, 700 W): at most 1.5e-6
# of scale, and the kernel as far from a float64 solve as the plain
# version (3.3e-5 and 3.4e-5 on ys); GAN_KERNEL_REL leaves a margin of 2.6.
GAN_KERNEL_ATOL, GAN_KERNEL_REL = 1e-5, 4e-6
# Fused vs sdeint route on one served request: generated paths within
# GAN_PATH_ATOL, critic scores and the loss within GAN_SCORE_REL times the
# scores' largest magnitude (the loss is a difference of two means and can
# be near zero, so it is held to the scores' scale, not its own). Measured
# 3.4e-5 on paths and 1.5e-6 of scale on scores (NVIDIA H100 80GB HBM3,
# 700 W).
GAN_PATH_ATOL = 1e-4
GAN_SCORE_REL = 1e-5
GAN_THREADS = (64, 128, 256)
# Kernels 6 and 8 vs plain, per output tensor: the JAX package's rule for
# its fused GAN gradients (tests/test_fused_gan.py:181), atol max(1e-4,
# 1e-5 * the tensor's largest entry); the kernel may also be at most twice
# as far from a float64 run as the float32 plain version, plus the atol.
GAN_BWD_ATOL, GAN_BWD_REL = 1e-4, 1e-5
# Fused vs sdeint route, step-0 GAN parameter gradients: atol GAN_GRAD_REL
# times each gradient's largest entry (both float32 through 63 steps,
# summed in other orders: the kernels' per-lane FMA chains and fixed-order
# partials, cuBLAS on the other route). Measured 8.3e-7 at the reference
# scale (NVIDIA H100 80GB HBM3, 700 W), so 1e-5 leaves a margin of 12.
GAN_GRAD_REL = 1e-5
# examples/sde_gan.py: Adadelta after decayed weights, per network.
GAN_TRAIN_STEPS, GAN_GEN_LR, GAN_CRITIC_LR, GAN_WEIGHT_DECAY = 5, 2e-4, 1e-3, \
    0.01
# fused_sdeint at full width, nothing cut (benchmarks/fused_solve_bench.py:
# 19-25,38-49,73-80 of the JAX package): drift (softplus, linear) and
# diffusion (lipswish, sigmoid) towers d -> hidden -> d, weights normal x
# 0.3/sqrt(fan_in), zero biases; 9 output times on [0, 1], dt 1/128 (128
# steps), float32, diagonal noise. E1 fits a block's shared memory with both
# towers (66,816 bytes), R1's towers (264,192 bytes) do not.
TOWER_CONFIGS = {"E1": ("euler", 4096, 32, 128),
                 "R1": ("reversible_heun", 1024, 128, 128)}
TOWER_FACTS, TOWER_GACTS = ("softplus", "linear"), ("lipswish", "sigmoid")
TOWER_N_TS, TOWER_DT = 9, 1.0 / 128
# General noise with a time column and depth-3 towers: batch, d, m, hidden.
TOWER_GENERAL = (1024, 16, 4, 64)
# Kernels 9-12 vs plain, per output tensor: the JAX package's rule for its
# fused against its XLA solves (tests/test_fused_solve.py:87,114-115), as
# max(atol, rel * scale): values max(2e-5, 4e-6 * scale) (4e-6 as kernels 5
# and 7: one float32 ulp at the states' scale, summed in another order over
# 128 steps), gradients max(1e-4, 1e-5 * scale); and each kernel at most
# twice as far from a float64 run as the plain version, plus the atol.
TOWER_VAL_ATOL, TOWER_VAL_REL = 2e-5, 4e-6
TOWER_GRAD_ATOL, TOWER_GRAD_REL = 1e-4, 1e-5
# Step-0 gradients of fused_sdeint's two routes, atol this times each
# gradient's largest entry (both float32, summed in other orders).
TOWER_ROUTE_GRAD_REL = 1e-5
TOWER_TRAIN_STEPS, TOWER_LR = 3, 1e-3
# fused_sdeint_logqp (kernels 13 and 14) at full width, nothing cut: E1's
# and R1's towers and a prior drift of the drift's shape and activations
# from its own seed; L1 batch 4096, d 32, hidden 128 (served and trained),
# L2 batch 1024, d 128, hidden 128 (kernels only). The small solve (batch,
# d, hidden) has a time column and a depth-2 diffusion ending in tanh with
# weights of scale 0.8, so g takes both signs and passes near zero
# (tests/test_fused_solve.py:188-212 of the JAX package).
LOGQP_CONFIGS = {"L1": (4096, 32, 128), "L2": (1024, 128, 128)}
LOGQP_SMALL = (256, 8, 16)
# On it float32 itself is ill-conditioned: u = (f - h) / g amplifies the
# rounding of g where g passes near zero (min |g| 1.9e-4 at y0), and the
# plain version's qs came 1.30e6 from a float64 run at a scale of 5.5e7
# (2.4 %; NVIDIA H100 80GB HBM3, 700 W). So its qs and gradients are held
# to the plain version within what float32 rounding gives there (three
# times the plain version's distance from float64), and to float64 within
# twice the plain version's distance plus the JAX package's relative
# tolerance for a signed diffusion times the scale, 3e-3 and 5e-3
# (tests/test_fused_solve.py:226,261-262).
LOGQP_SIGNED_RTOL = (3e-3, 5e-3)
# The ways of staging the three towers in shared memory that phase 18
# times (bit 0 the drift, 1 the diffusion, 2 the prior; fused_solve.
# STAGE_ORDER): all three, drift and prior, none at L1; one or none at L2.
LOGQP_STAGINGS = {"L1": (7, 5, 0), "L2": (1, 0)}
# Published H100 SXM peaks (NVIDIA H100 datasheet): float32 outside the
# tensor cores, and device memory.
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12


# Device cycles (about 1 ms) that each timed run waits behind, so that the
# host has enqueued the run's launches before the device reaches them: a
# run's events then time the device's work, not the wrapper's host-side
# checks, which take longer than the GAN kernels themselves. Work that
# takes the host longer than this to enqueue is timed with its host gaps.
QUEUE_AHEAD_CYCLES = 2_000_000


def median_cuda_ms(fn, reps, warmup=2):
    """Median over ``reps`` calls of ``fn``'s device time, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def solve_flops(B, L, C, H, n):
    """Floating-point operations of one forward solve, two per multiply-add:
    per row and step, layer 1 of f ((L+C)H) and of h (LH), layer 2 of both
    (2H^2), layer 3 of both (2HL) and the g nets' two layers (2LH). The
    softplus and sigmoid evaluations are not counted."""
    return 2 * B * n * ((L + C) * H + 2 * H * H + 5 * L * H)


def bound(flops, tensors):
    """The least time the card could take, in ms, and what bounds it: the
    larger of the operations at the float32 peak and of the bytes moved
    (each input read once, each output written once) at the memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda"), card


def phase_build():
    t0 = time.perf_counter()
    _build.load_library()
    seconds = time.perf_counter() - t0
    print(f"build: {seconds:.2f} s -> {_build.library_path()[0].name}",
          flush=True)
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line:
            kernel = line.split("'")[1]
            print(f"  nvcc: {kernel}", flush=True)
        elif ("registers" in line or "spill" in line or "error" in line
              or line.startswith("==")):
            print(f"  nvcc: {line.strip()}", flush=True)


def flagship_model(device):
    gen = torch.Generator().manual_seed(SEED)
    return LatentSDE(DATA, LATENT, CONTEXT, HIDDEN, device=device,
                     generator=gen)


def kernel_inputs(device, model):
    """Seeded solve inputs at the flagship shapes, as the main path makes
    them: z0, ctx, ctx_idx, noise, dts."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    ts = np.linspace(0.0, 1.0, N_TS)
    ctx = torch.randn((N_TS, BATCH, CONTEXT), generator=gen, device=device)
    view = model.contextualize(ts, ctx)
    z0 = torch.randn((BATCH, LATENT), generator=gen, device=device)
    with torch.no_grad():
        return LF._prep_solve(view, z0, ts, gen, DT)[:5]


def phase_kernel(device):
    """Kernel 1 vs its plain version on seeded inputs at the flagship
    shapes."""
    model = flagship_model(device)
    args = kernel_inputs(device, model)
    with torch.no_grad():
        weights = LF.solve_weights(model)
        n = args[3].shape[0]
        zs_k, qs_k = LF.fused_solve_forward_cuda(*args, weights)
        zs_p, qs_p = LF.fused_solve_forward_plain(*args, weights)
        torch.cuda.synchronize()
        for name, got, want in (("zs", zs_k, zs_p), ("qs", qs_k, qs_p)):
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise RuntimeError(f"kernel {name}: shape {tuple(got.shape)} "
                                   f"or non-finite values")
        err = max(float((zs_k - zs_p).abs().max()),
                  float((qs_k - qs_p).abs().max()))
        print(f"kernel 1 vs plain: n={n} steps, max|zs|="
              f"{float(zs_p.abs().max()):.4g}, max|qs|="
              f"{float(qs_p.abs().max()):.4g}, max_abs_err={err:.3e}",
              flush=True)
        torch.testing.assert_close(zs_k, zs_p, atol=KERNEL_ATOL, rtol=0)
        torch.testing.assert_close(qs_k, qs_p, atol=KERNEL_ATOL, rtol=0)
        ms = median_cuda_ms(lambda: LF.fused_solve_forward_cuda(*args,
                                                                weights), 20)
        plain_ms = median_cuda_ms(
            lambda: LF.fused_solve_forward_plain(*args, weights), 5)
    bound_ms, bound_by = bound(solve_flops(BATCH, LATENT, CONTEXT, HIDDEN, n),
                               [*args, *weights, zs_k, qs_k])
    print(f"kernel 1: median {ms:.4f} ms; plain: median {plain_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


GRAD_NAMES = ("dz0", "dctx", "dnoise") + LF.WEIGHT_NAMES


def _flat(out):
    dz0, dctx, dnoise, dweights = out
    return [dz0, dctx, dnoise, *dweights]


def compare_backward(label, got, want):
    """Holds kernel 2's outputs to the plain version's; returns the largest
    absolute error and the largest error relative to a tensor's scale."""
    worst_abs = worst_rel = 0.0
    cells = []
    for name, g, w in zip(GRAD_NAMES, _flat(got), _flat(want)):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"kernel 2 {label} {name}: shape "
                               f"{tuple(g.shape)} or non-finite values")
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        rel = err / scale if scale > 0 else 0.0
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        cells.append(f"{name} {err:.2e}/{scale:.2e}")
        if err > max(BWD_ATOL, BWD_REL * scale):
            raise RuntimeError(f"kernel 2 {label} {name}: max abs error "
                               f"{err:.3e} over max(|.|) {scale:.3e} exceeds "
                               f"max({BWD_ATOL}, {BWD_REL} * scale)")
    print(f"kernel 2 vs plain, {label} diffusion (abs err/max|plain|): "
          + ", ".join(cells), flush=True)
    print(f"kernel 2 vs plain, {label} diffusion: max_abs_err="
          f"{worst_abs:.3e}, max_rel_err={worst_rel:.3e}", flush=True)
    return worst_abs, worst_rel


def phase_kernel2(device):
    """Kernel 2 vs its plain version on seeded inputs and cotangents at the
    flagship shapes, with normal and with saturated diffusion; two calls
    must agree bitwise."""
    model = flagship_model(device)
    args = kernel_inputs(device, model)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    n = args[3].shape[0]
    gz = torch.randn((n, BATCH, LATENT), generator=gen, device=device)
    gq = torch.randn((n, BATCH, 1), generator=gen, device=device)
    errs = []
    with torch.no_grad():
        for label in ("normal", "saturated"):
            if label == "saturated":
                model.g_nets[3].sub_(25.0)      # g ~ 1e-11 < 1e-7
            weights = LF.solve_weights(model)
            zs, _ = LF.fused_solve_forward_cuda(*args, weights)
            bargs = (*args, weights, zs, gz, gq)
            got = LF.fused_solve_backward_cuda(*bargs)
            want = LF.fused_solve_backward_plain(*bargs)
            torch.cuda.synchronize()
            errs.append(compare_backward(label, got, want))
            if label == "saturated":
                g_max = max(float(d.abs().max()) for d in got[3][12:])
                print(f"saturated diffusion: max |g_nets gradient| "
                      f"{g_max:.3e}", flush=True)
                if not g_max > 0:
                    raise RuntimeError("g_nets gradients vanish under "
                                       "saturated diffusion")
            else:
                again = LF.fused_solve_backward_cuda(*bargs)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b)
                           for a, b in zip(_flat(got), _flat(again))):
                    raise RuntimeError("kernel 2 is not bitwise repeatable")
                print("kernel 2: two calls agree bitwise", flush=True)
                timed = bargs
                outputs = _flat(got)
        ms = median_cuda_ms(lambda: LF.fused_solve_backward_cuda(*timed), 20)
        plain_ms = median_cuda_ms(
            lambda: LF.fused_solve_backward_plain(*timed), 3, warmup=1)
    bound_ms, bound_by = bound(
        3 * solve_flops(BATCH, LATENT, CONTEXT, HIDDEN, n),
        [*timed[:5], *timed[5], *timed[6:], *outputs])
    print(f"kernel 2: median {ms:.4f} ms; plain: median {plain_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(max_abs_err=errs[0][0], max_abs_err_saturated=errs[1][0],
                max_rel_err=max(e[1] for e in errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def lorenz_data(device):
    ts = np.linspace(0.0, 1.0, N_TS)
    data_gen = torch.Generator(device=device).manual_seed(SEED + 2)
    with torch.no_grad():
        xs = make_lorenz_data(BATCH, ts, generator=data_gen, device=device)
    if xs.shape != (N_TS, BATCH, DATA) or not torch.isfinite(xs).all():
        raise RuntimeError(f"lorenz data: shape {tuple(xs.shape)}")
    return xs, ts


def phase_serve(device, xs, ts):
    """Three flagship forward passes through kernel 1, each checked against
    the sdeint route on the same generator seed."""
    model = flagship_model(device)

    def serve(seed, fused):
        gen = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss, aux = latent_sde_loss(model, xs, ts, gen, dt=DT,
                                        fused=fused)
        torch.cuda.synchronize()
        return float(loss), aux, (time.perf_counter() - t0) * 1e3

    serve(100, True)                   # warm-up of both routes
    serve(100, False)
    seeds = (101, 102, 103)
    LF.launches = LF.bwd_launches = 0
    fused = [serve(s, True) for s in seeds]
    launches = (LF.launches, LF.bwd_launches)
    plain = [serve(s, False) for s in seeds]
    if launches != (len(seeds), 0):
        raise RuntimeError(f"kernels launched {launches} times in "
                           f"{len(seeds)} fused forward passes")
    for seed, (lf, aux, _), (lp, _, _) in zip(seeds, fused, plain):
        if not (np.isfinite(lf) and np.isfinite(float(aux["logqp"]))):
            raise RuntimeError(f"seed {seed}: non-finite loss {lf}")
        rel = abs(lf - lp) / abs(lp)
        print(f"seed {seed}: loss fused {lf:.8g} sdeint {lp:.8g} "
              f"rel diff {rel:.3e} logqp {float(aux['logqp']):.6g}",
              flush=True)
        if rel > LOSS_RTOL:
            raise RuntimeError(f"seed {seed}: fused and sdeint losses "
                               f"differ by {rel:.3e} > {LOSS_RTOL}")
    fused_ms = float(np.median([t for _, _, t in fused]))
    plain_ms = float(np.median([t for _, _, t in plain]))
    print(f"forward pass: fused median {fused_ms:.3f} ms, sdeint median "
          f"{plain_ms:.3f} ms (host clock, synchronised)", flush=True)
    return launches[0], model


ROUTES = ("fused", "sdeint")


def train_step(model, opt, xs, ts, route, seed, kl_weight):
    """One Adam step of the ELBO on ``route``; returns the detached loss (a
    tensor: reading it is left to the caller)."""
    opt.zero_grad(set_to_none=True)
    gen = torch.Generator(device=xs.device).manual_seed(seed)
    loss, _ = latent_sde_loss(model, xs, ts, gen, dt=DT, kl_weight=kl_weight,
                              fused=route == "fused")
    loss.backward()
    opt.step()
    return loss.detach()


def check_step_gradients(models, xs, ts):
    """Step-0 parameter gradients of the fused route against the sdeint
    route's autograd on one generator seed. The KL weight is 1 here (the
    schedule's step 0 has 0), so the logqp path's cotangent is live."""
    grads = {}
    for route, model in models.items():
        gen = torch.Generator(device=xs.device).manual_seed(300)
        loss, _ = latent_sde_loss(model, xs, ts, gen, dt=DT, kl_weight=1.0,
                                  fused=route == "fused")
        loss.backward()
        grads[route] = {name: p.grad.detach().clone()
                        for name, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    ratios = []
    for name, want in grads["sdeint"].items():
        got = grads["fused"][name]
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError(f"step 0: non-finite gradient of {name}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ratios.append((err / scale if scale > 0 else 0.0, name, err, scale))
    ratios.sort(reverse=True)
    for rel, name, err, scale in ratios[:4]:
        print(f"step-0 gradient {name}: max abs diff {err:.3e}, "
              f"max|sdeint| {scale:.3e}, rel {rel:.3e}", flush=True)
    if ratios[0][0] > GRAD_REL:
        raise RuntimeError(f"step-0 gradient of {ratios[0][1]} differs "
                           f"between routes by {ratios[0][0]:.3e} of its "
                           f"scale > {GRAD_REL}")
    return ratios[0][0]


def phase_train(device, xs, ts):
    """Flagship Adam steps on both routes in turns, from the same seeded
    weights; checks and times them."""
    models = {route: flagship_model(device) for route in ROUTES}
    grad_rel = check_step_gradients(models, xs, ts)
    opts = {route: torch.optim.Adam(model.parameters(), lr=LR)
            for route, model in models.items()}
    times = {route: [] for route in ROUTES}
    LF.launches = LF.bwd_launches = 0
    for step in range(TRAIN_STEPS):
        kl_weight = min(1.0, step / KL_ANNEAL)
        for route in (ROUTES if step % 2 == 0 else ROUTES[::-1]):
            before = (LF.launches, LF.bwd_launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = train_step(models[route], opts[route], xs, ts, route,
                              400 + step, kl_weight)
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3)
            delta = (LF.launches - before[0], LF.bwd_launches - before[1])
            if delta != ((1, 1) if route == "fused" else (0, 0)):
                raise RuntimeError(f"{route} step {step}: kernels launched "
                                   f"{delta} times")
            grads_ok = all(torch.isfinite(p.grad).all()
                           for p in models[route].parameters())
            if not (np.isfinite(float(loss)) and grads_ok):
                raise RuntimeError(f"{route} step {step}: non-finite loss "
                                   f"{float(loss)} or gradient")
            print(f"train {route} step {step}: loss {float(loss):.8g} "
                  f"kl_weight {kl_weight:.2f} {times[route][-1]:.3f} ms",
                  flush=True)
    launches = (LF.launches, LF.bwd_launches)
    medians = {route: float(np.median(t)) for route, t in times.items()}
    print(f"train step: fused median {medians['fused']:.3f} ms, sdeint "
          f"median {medians['sdeint']:.3f} ms over {TRAIN_STEPS} steps "
          f"(host clock, synchronised)", flush=True)
    return launches, grad_rel, models, opts


def profile_run(label, fn):
    """``fn`` under torch.profiler: the number of kernels, their device time,
    the device's busy share of the (profiled) wall time, and the costliest
    kernels by name. The device-side ranges of annotations (such as
    ``Optimizer.step``) span kernels already counted, so they are left
    out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    device_ms = sum(us for _, us in by_name.values()) / 1e3
    kernels = sum(n for n, _ in by_name.values())
    print(f"profile {label}: wall {wall_ms:.3f} ms, device {device_ms:.3f} "
          f"ms, busy {device_ms / wall_ms:.3f}, {kernels} kernels",
          flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (n, us) in top:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x {name[:90]}", flush=True)


def phase_profile(device, served, trained, xs, ts):
    """A forward pass and a train step of each route under the profiler."""
    models, opts = trained
    for route in ROUTES:
        gen = torch.Generator(device=device).manual_seed(200)

        def forward():
            with torch.no_grad():
                latent_sde_loss(served, xs, ts, gen, dt=DT,
                                fused=route == "fused")

        profile_run(f"forward {route}", forward)
    for route in ROUTES:
        profile_run(f"train step {route}", lambda: train_step(
            models[route], opts[route], xs, ts, route, 500, 1.0))


# --------------------------------------------------------------------------- #
#  SDE-GAN: kernels 5 and 7, served requests                                  #
# --------------------------------------------------------------------------- #

def gan_models(device):
    gen = torch.Generator().manual_seed(SEED)
    generator = Generator(GAN_DATA, GAN_INIT_NOISE, GAN_NOISE, GAN_HIDDEN,
                          GAN_MLP, GAN_LAYERS, init_mult1=GAN_MULT1,
                          init_mult2=GAN_MULT2, device=device, generator=gen)
    critic = Discriminator(GAN_DATA, GAN_CRITIC_HIDDEN, GAN_MLP, GAN_LAYERS,
                           device=device, generator=gen)
    return generator, critic


def gan_data(device):
    """OU paths from get_ou_data (dataset 1024, 64 times): the real batch."""
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    t0 = time.perf_counter()
    with torch.no_grad():
        ts, data = get_ou_data(gen, GAN_BATCH, GAN_T, device=device)
    torch.cuda.synchronize()
    if (data.shape != (GAN_BATCH, GAN_T, 1 + GAN_DATA)
            or not torch.isfinite(data).all()):
        raise RuntimeError(f"OU data: shape {tuple(data.shape)} or "
                           f"non-finite values")
    print(f"OU data: {tuple(data.shape)} in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, std of the values "
          f"{float(data[..., 1].std()):.4f}", flush=True)
    return ts, data.contiguous()


def gan_kernel_inputs(device, models, ts, real):
    """Seeded inputs of kernels 5 and 7 at the reference scale, as a served
    request makes them: the generator's solve from the initial MLP on seeded
    noise, and the critic's over those paths and the real ones."""
    generator, critic = models
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    with torch.no_grad():
        noise0 = torch.randn((GAN_BATCH, GAN_INIT_NOISE), generator=gen,
                             device=device)
        x0 = generator.initial(noise0)
        gen_args = GF.prep_generator_solve(generator.func, x0, ts, gen,
                                           GAN_DT)
        fake = generator(gen, ts, GAN_BATCH, dt=GAN_DT, fused=True)
        both = torch.cat([fake, real], dim=0)
        func = critic.func.attach(ts, both)
        cde_args = GF.prep_cde_solve(func, critic.initial(both[:, 0]), ts,
                                     GAN_DT)
    return ((gen_args, GF.gen_weights(generator.func)),
            (cde_args, GF.cde_weights(critic.func)))


def gen_flops(B, S, M, m, n):
    """Operations of one generator solve, two per multiply-add: per row and
    step, layer 1 of both towers (2(1+S)M), layer 2 of the drift (MS) and
    of the diffusion (MSm), and the two g.dW products (2Sm). The lipswish
    and tanh evaluations are not counted."""
    return 2 * B * n * (2 * (1 + S) * M + M * S + M * S * m + 2 * S * m)


def cde_flops(B, S, M, C, n):
    """Operations of one critic solve, two per multiply-add: per row and
    step, layer 1 ((1+S)M), layer 2 (MSC) and F.slope (SC)."""
    return 2 * B * n * ((1 + S) * M + M * S * C + S * C)


def check_against_plain(label, names, got, want, exact, atol, rel_tol,
                        rtol=0.0):
    """Holds a kernel's outputs to its plain version's at max(atol, rel_tol
    * scale), and to twice the plain version's distance from the plain
    version run in float64 (``exact``) plus atol. With ``rtol`` (inputs on
    which float32 itself is ill-conditioned) the first bound adds three
    times the plain version's own distance from float64, what float32
    rounding alone gives on these inputs, and the second ``rtol`` times the
    scale. Returns the largest absolute and scale-relative errors against
    the plain version."""
    worst = worst_rel = 0.0
    cells, failures = [], []
    for name, g, w, e in zip(names, got, want, exact):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"{label} {name}: shape {tuple(g.shape)} or "
                               f"non-finite values")
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        rel = err / scale if scale > 0 else 0.0
        err64 = float((g.double() - e).abs().max())
        plain64 = float((w.double() - e).abs().max())
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        cells.append(f"{name} {err:.2e}/{scale:.3g} (f64: {err64:.2e} vs "
                     f"{plain64:.2e})")
        slack = 3 * plain64 if rtol else 0.0
        if err > max(atol, rel_tol * scale) + slack:
            failures.append(f"{name} differs by {err:.3e} > max({atol}, "
                            f"{rel_tol} * {scale:.4g}) + {slack:.3e}")
        if err64 > 2 * plain64 + atol + rtol * scale:
            failures.append(f"{name} is {err64:.3e} from the float64 run, "
                            f"the plain version {plain64:.3e}")
    print(f"{label} vs plain (abs err/max|plain|; from float64: kernel vs "
          f"plain): " + "; ".join(cells), flush=True)
    print(f"{label} vs plain: max_abs_err={worst:.3e}, max_rel_err="
          f"{worst_rel:.3e}", flush=True)
    if failures:
        raise RuntimeError(f"{label}: " + "; ".join(failures))
    return worst, worst_rel


def time_gan_kernel(label, run_cuda, run_plain, tensors, flops,
                    plain_reps=5):
    """Median device times of a GAN kernel (``run_cuda(threads)``, 20 runs
    at each block size, the default's for the record) and of its plain
    version (``run_plain()``), and the bound of ``flops`` and of the bytes
    of ``tensors``."""
    by_threads = {}
    for threads in GAN_THREADS:
        by_threads[threads] = median_cuda_ms(lambda: run_cuda(threads), 20)
    ms = by_threads[GF.THREADS]
    plain_ms = median_cuda_ms(run_plain, plain_reps, warmup=1)
    bound_ms, bound_by = bound(flops, tensors)
    sweep = ", ".join(f"{t}: {v:.4f}" for t, v in by_threads.items())
    print(f"{label}: median {ms:.4f} ms at {GF.THREADS} threads per block "
          f"(threads: ms {sweep}); plain: median {plain_ms:.4f} ms; bound "
          f"{bound_ms:.5f} ms ({bound_by}, {flops / 1e9:.4f} GFLOP)",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by,
                ms_by_threads={str(t): v for t, v in by_threads.items()})


def double(tensors):
    """The tensors in float64; a tuple among them (a backward's weights)
    stays a tuple."""
    return [tuple(double(t)) if isinstance(t, tuple) else t.double()
            for t in tensors]


def phase_gan_kernels(device, models, ts, real):
    """Kernels 5 and 7 against their plain versions on seeded inputs at the
    reference scale."""
    (gen_args, gen_w), (cde_args, cde_w) = gan_kernel_inputs(
        device, models, ts, real)
    lib = _build.load_library()
    B, S, M, m, n = GF.check_gen_inputs(*gen_args, gen_w)
    Bc, Sc, Mc, C, _ = GF.check_cde_inputs(*cde_args, cde_w)
    print(f"GAN kernels: shared memory per block "
          f"{lib.tsde_gan_gen_fwd_smem_bytes(S, M, m)} bytes (kernel 5), "
          f"{lib.tsde_gan_cde_fwd_smem_bytes(Sc, Mc, C)} bytes (kernel 7)",
          flush=True)
    with torch.no_grad():
        got = GF.gen_solve_forward_cuda(*gen_args, gen_w)
        want = GF.gen_solve_forward_plain(*gen_args, gen_w)
        exact = GF.gen_solve_forward_plain(*double(gen_args), double(gen_w))
        torch.cuda.synchronize()
        err5 = check_against_plain("kernel 5", ("ys", "zs", "gs"), got,
                                   want, exact, GAN_KERNEL_ATOL,
                                   GAN_KERNEL_REL)
        k5 = time_gan_kernel(
            "kernel 5",
            lambda t: GF.gen_solve_forward_cuda(*gen_args, gen_w, threads=t),
            lambda: GF.gen_solve_forward_plain(*gen_args, gen_w),
            [*gen_args, *gen_w, *got], gen_flops(B, S, M, m, n))
        got = GF.cde_solve_forward_cuda(*cde_args, cde_w)
        want = GF.cde_solve_forward_plain(*cde_args, cde_w)
        exact = GF.cde_solve_forward_plain(*double(cde_args), double(cde_w))
        torch.cuda.synchronize()
        err7 = check_against_plain("kernel 7", ("hs", "zs"), got, want,
                                   exact, GAN_KERNEL_ATOL, GAN_KERNEL_REL)
        k7 = time_gan_kernel(
            "kernel 7",
            lambda t: GF.cde_solve_forward_cuda(*cde_args, cde_w, threads=t),
            lambda: GF.cde_solve_forward_plain(*cde_args, cde_w),
            [*cde_args, *cde_w, *got], cde_flops(Bc, Sc, Mc, C, n))
    return (dict(max_abs_err=err5[0], max_rel_err=err5[1], **k5),
            dict(max_abs_err=err7[0], max_rel_err=err7[1], **k7))


def gan_request(models, ts, real, seed, fused):
    """One served request: gan_loss under no_grad on a generator seeded
    ``seed``; returns the loss (a float) and the host-clock ms."""
    generator, critic = models
    gen = torch.Generator(device=real.device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss = gan_loss(generator, critic, gen, ts, real, dt=GAN_DT,
                        adjoint=False, fused=fused)
    torch.cuda.synchronize()
    return float(loss), (time.perf_counter() - t0) * 1e3


def paths_and_scores(models, ts, real, seed, fused):
    """What a request computes on the way to its loss: the generated paths
    and the per-sample scores of fake and real paths."""
    generator, critic = models
    gen = torch.Generator(device=real.device).manual_seed(seed)
    with torch.no_grad():
        fake = generator(gen, ts, GAN_BATCH, dt=GAN_DT, adjoint=False,
                         fused=fused)
        scores = critic.scores(ts, torch.cat([fake, real], dim=0), dt=GAN_DT,
                               adjoint=False, fused=fused)
    return fake, scores


def phase_gan_serve(device, models, ts, real):
    """Three served GAN requests on each route from the same generator
    seeds; kernels 5 and 7 launched once per fused request; the two routes'
    paths, scores and losses agree."""
    gan_request(models, ts, real, 300, True)           # warm-up, both routes
    gan_request(models, ts, real, 300, False)
    seeds = (301, 302, 303)
    GF.gen_launches = GF.cde_launches = 0
    fused = []
    for seed in seeds:
        before = (GF.gen_launches, GF.cde_launches)
        fused.append(gan_request(models, ts, real, seed, True))
        delta = (GF.gen_launches - before[0], GF.cde_launches - before[1])
        if delta != (1, 1):
            raise RuntimeError(f"GAN request {seed}: kernels 5 and 7 "
                               f"launched {delta} times")
    launches = (GF.gen_launches, GF.cde_launches)
    plain = [gan_request(models, ts, real, seed, False) for seed in seeds]
    if (GF.gen_launches, GF.cde_launches) != launches:
        raise RuntimeError("the sdeint route launched a GAN kernel")
    for seed, (lf, _), (lp, _) in zip(seeds, fused, plain):
        fake_f, s_f = paths_and_scores(models, ts, real, seed, True)
        fake_p, s_p = paths_and_scores(models, ts, real, seed, False)
        for name, t in (("paths", fake_f), ("scores", s_f)):
            if not torch.isfinite(t).all():
                raise RuntimeError(f"GAN request {seed}: non-finite {name}")
        if fake_f.shape != (GAN_BATCH, GAN_T, 1 + GAN_DATA):
            raise RuntimeError(f"generated paths of shape "
                               f"{tuple(fake_f.shape)}")
        path_err = float((fake_f - fake_p).abs().max())
        scale = float(s_p.abs().max())
        score_err = float((s_f - s_p).abs().max())
        loss_err = abs(lf - lp)
        print(f"GAN request {seed}: loss fused {lf:.8g} sdeint {lp:.8g} "
              f"(diff {loss_err:.3e}); paths max diff {path_err:.3e} "
              f"(max|path| {float(fake_p.abs().max()):.4g}); scores max "
              f"diff {score_err:.3e} (max|score| {scale:.4g})", flush=True)
        if path_err > GAN_PATH_ATOL:
            raise RuntimeError(f"GAN request {seed}: generated paths differ "
                               f"by {path_err:.3e} > {GAN_PATH_ATOL}")
        if max(score_err, loss_err) > GAN_SCORE_REL * scale:
            raise RuntimeError(f"GAN request {seed}: scores or loss differ "
                               f"by {max(score_err, loss_err):.3e} > "
                               f"{GAN_SCORE_REL} * {scale:.4g}")
    fused_ms = float(np.median([t for _, t in fused]))
    plain_ms = float(np.median([t for _, t in plain]))
    print(f"GAN request: fused median {fused_ms:.3f} ms, sdeint median "
          f"{plain_ms:.3f} ms (host clock, synchronised)", flush=True)
    generator = models[0]
    times = []
    for i in range(11):
        gen = torch.Generator(device=device).manual_seed(400 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            generator(gen, ts, GAN_BATCH, dt=GAN_DT, fused=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sample_s = float(np.median(times[1:]))
    print(f"sampling: generator(fused=True) of {GAN_BATCH} paths, median "
          f"{sample_s * 1e3:.3f} ms, {GAN_BATCH / sample_s:.1f} samples/s "
          f"(host clock, synchronised)", flush=True)
    return launches


def phase_gan_profile(device, models, ts, real):
    """A served GAN request of each route under the profiler."""
    for route in ROUTES:
        profile_run(f"GAN request {route}", lambda: gan_request(
            models, ts, real, 500, route == "fused"))


# --------------------------------------------------------------------------- #
#  SDE-GAN training: kernels 6 and 8, train steps                             #
# --------------------------------------------------------------------------- #

def gen_bwd_flops(B, S, M, m, n):
    """Operations of one generator reverse sweep, two per multiply-add: per
    row and step, the towers' recomputed forward (2(1+S)M + MS(1+m)), twice
    that going back (weight gradients and input cotangents), and 4Sm for
    the noise terms (Ag, dnoise, ag). Transcendentals are not counted."""
    return 2 * B * n * (3 * (2 * (1 + S) * M + M * S * (1 + m)) + 4 * S * m)


def cde_bwd_flops(B, S, M, C, n):
    """Operations of one critic reverse sweep, two per multiply-add: per row
    and step, the tower's recomputed forward ((1+S)M + MSC), twice that
    going back, and 2SC for the slopes' cotangents and dF."""
    return 2 * B * n * (3 * ((1 + S) * M + M * S * C) + 2 * S * C)


def flat_grads(out):
    """A backward's outputs as one list: the tensors, then the weights'."""
    return [*out[:-1], *out[-1]]


def check_bitwise(label, sweep, bargs, first):
    again = sweep(*bargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(flat_grads(first),
                                                 flat_grads(again))):
        raise RuntimeError(f"{label} is not bitwise repeatable")
    print(f"{label}: two calls agree bitwise", flush=True)


def phase_gan_bwd_kernels(device, models, ts, real):
    """Kernels 6 and 8 against their plain versions at the reference scale,
    on the forward kernels' zs and gs and seeded cotangents."""
    (gen_args, gen_w), (cde_args, cde_w) = gan_kernel_inputs(
        device, models, ts, real)
    lib = _build.load_library()
    B, S, M, m, n = GF.check_gen_inputs(*gen_args, gen_w)
    Bc, Sc, Mc, C, _ = GF.check_cde_inputs(*cde_args, cde_w)
    print(f"GAN backward kernels: shared memory per block "
          f"{lib.tsde_gan_gen_bwd_smem_bytes(S, M, m)} bytes (kernel 6), "
          f"{lib.tsde_gan_cde_bwd_smem_bytes(Sc, Mc, C)} bytes (kernel 8); "
          f"weight-gradient partials {lib.tsde_gan_bwd_partials(B, S, M)} "
          f"and {lib.tsde_gan_bwd_partials(Bc, Sc, Mc)}", flush=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    with torch.no_grad():
        ys, zs, gs = GF.gen_solve_forward_cuda(*gen_args, gen_w)
        gy = torch.randn(ys.shape, generator=gen, device=device)
        bargs = (*gen_args, gen_w, zs, gs, gy)
        got = GF.gen_solve_backward_cuda(*bargs)
        want = GF.gen_solve_backward_plain(*bargs)
        exact = GF.gen_solve_backward_plain(*double(bargs))
        torch.cuda.synchronize()
        err6 = check_against_plain(
            "kernel 6", ("dx0", "df0", "dg0", "dnoise") + GF.GEN_WEIGHT_NAMES,
            flat_grads(got), flat_grads(want), flat_grads(exact),
            GAN_BWD_ATOL, GAN_BWD_REL)
        check_bitwise("kernel 6", GF.gen_solve_backward_cuda, bargs, got)
        k6 = time_gan_kernel(
            "kernel 6",
            lambda t: GF.gen_solve_backward_cuda(*bargs, threads=t),
            lambda: GF.gen_solve_backward_plain(*bargs),
            [gen_args[2], *gen_args[3:], *gen_w, zs, gs, gy,
             *flat_grads(got)],
            gen_bwd_flops(B, S, M, m, n), plain_reps=3)

        hs, czs = GF.cde_solve_forward_cuda(*cde_args, cde_w)
        last = torch.zeros_like(hs)
        last[-1] = torch.randn(hs.shape[1:], generator=gen, device=device)
        dense = torch.randn(hs.shape, generator=gen, device=device)
        errs = []
        for label, ghs in (("last-state", last), ("dense", dense)):
            cargs = (*cde_args, cde_w, czs, ghs)
            got = GF.cde_solve_backward_cuda(*cargs)
            want = GF.cde_solve_backward_plain(*cargs)
            exact = GF.cde_solve_backward_plain(*double(cargs))
            torch.cuda.synchronize()
            errs.append(check_against_plain(
                f"kernel 8, {label} cotangents",
                ("dh0", "df0", "dslopes") + GF.CDE_WEIGHT_NAMES,
                flat_grads(got), flat_grads(want), flat_grads(exact),
                GAN_BWD_ATOL, GAN_BWD_REL))
            check_bitwise(f"kernel 8, {label} cotangents",
                          GF.cde_solve_backward_cuda, cargs, got)
        cargs = (*cde_args, cde_w, czs, last)
        k8 = time_gan_kernel(
            "kernel 8",
            lambda t: GF.cde_solve_backward_cuda(*cargs, threads=t),
            lambda: GF.cde_solve_backward_plain(*cargs),
            [*cde_args[2:], *cde_w, czs, last, *flat_grads(got)],
            cde_bwd_flops(Bc, Sc, Mc, C, n), plain_reps=3)
    return (dict(max_abs_err=err6[0], max_rel_err=err6[1], **k6),
            dict(max_abs_err=errs[0][0], max_abs_err_dense=errs[1][0],
                 max_rel_err=max(e[1] for e in errs), **k8))


GAN_COUNTERS = ("gen_launches", "gen_bwd_launches", "cde_launches",
                "cde_bwd_launches")


def gan_counts():
    return tuple(getattr(GF, c) for c in GAN_COUNTERS)


def gan_train_step(models, opts, ts, batch, seed, fused):
    """One training step: gan_grads on a generator seeded ``seed``, an
    Adadelta update of each network, the critic's weight clip. Returns the
    detached loss (a tensor) and the gradients."""
    generator, critic = models
    gen = torch.Generator(device=batch.device).manual_seed(seed)
    loss, g_gen, g_disc = gan_grads(generator, critic, gen, ts, batch,
                                    dt=GAN_DT, adjoint=False, fused=fused)
    for module, grads in ((generator, g_gen), (critic, g_disc)):
        for name, p in module.named_parameters():
            p.grad = grads[name]
    for opt in opts:
        opt.step()
    critic.clip_weights()
    return loss, [*g_gen.values(), *g_disc.values()]


def check_gan_step_gradients(trained, ts, real):
    """Step-0 parameter gradients of gan_grads on the fused route against
    the sdeint route's on one generator seed."""
    grads = {}
    for route, (models, _) in trained.items():
        gen = torch.Generator(device=real.device).manual_seed(600)
        _, g_gen, g_disc = gan_grads(*models, gen, ts, real, dt=GAN_DT,
                                     adjoint=False, fused=route == "fused")
        grads[route] = {**{f"generator.{k}": v for k, v in g_gen.items()},
                        **{f"critic.{k}": v for k, v in g_disc.items()}}
    ratios = []
    for name, want in grads["sdeint"].items():
        got = grads["fused"][name]
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError(f"GAN step 0: non-finite gradient of {name}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if scale == 0 and err > 0:
            raise RuntimeError(f"GAN step 0: gradient of {name} is zero on "
                               f"the sdeint route, {err:.3e} fused")
        ratios.append((err / scale if scale > 0 else 0.0, name, err, scale))
    ratios.sort(reverse=True)
    for rel, name, err, scale in ratios[:4]:
        print(f"GAN step-0 gradient {name}: max abs diff {err:.3e}, "
              f"max|sdeint| {scale:.3e}, rel {rel:.3e}", flush=True)
    if ratios[0][0] > GAN_GRAD_REL:
        raise RuntimeError(f"GAN step-0 gradient of {ratios[0][1]} differs "
                           f"between routes by {ratios[0][0]:.3e} of its "
                           f"scale > {GAN_GRAD_REL}")
    return ratios[0][0]


def check_clipped(critic):
    """Every critic weight within 1/out (in its dtype) after the clip."""
    for name, p in critic.named_parameters():
        if not name.endswith(".w"):
            continue
        lim = torch.tensor(1.0 / p.shape[1], dtype=p.dtype)
        if float(p.detach().abs().max()) > lim:
            raise RuntimeError(f"critic weight {name} exceeds 1/"
                               f"{p.shape[1]} after the clip")


def phase_gan_train(device, ts, real):
    """Five training steps of each route in turns, from the same seeded
    weights and real batches; checks and times them."""
    trained = {}
    for route in ROUTES:
        generator, critic = gan_models(device)
        opts = (torch.optim.Adadelta(generator.parameters(), lr=GAN_GEN_LR,
                                     weight_decay=GAN_WEIGHT_DECAY),
                torch.optim.Adadelta(critic.parameters(), lr=GAN_CRITIC_LR,
                                     weight_decay=GAN_WEIGHT_DECAY))
        trained[route] = ((generator, critic), opts)
    grad_rel = check_gan_step_gradients(trained, ts, real)
    times = {route: [] for route in ROUTES}
    perm = torch.Generator(device=device).manual_seed(SEED + 7)
    GF.gen_launches = GF.gen_bwd_launches = 0
    GF.cde_launches = GF.cde_bwd_launches = 0
    for step in range(GAN_TRAIN_STEPS):
        batch = real[torch.randperm(real.shape[0], generator=perm,
                                    device=device)[:GAN_BATCH]]
        for route in (ROUTES if step % 2 == 0 else ROUTES[::-1]):
            models, opts = trained[route]
            before = gan_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = gan_train_step(models, opts, ts, batch, 700 + step,
                                         route == "fused")
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3)
            delta = tuple(a - b for a, b in zip(gan_counts(), before))
            if delta != ((1,) * 4 if route == "fused" else (0,) * 4):
                raise RuntimeError(f"GAN {route} step {step}: kernels 5, 6, "
                                   f"7, 8 launched {delta} times")
            if not (np.isfinite(float(loss))
                    and all(torch.isfinite(g).all() for g in grads)):
                raise RuntimeError(f"GAN {route} step {step}: non-finite "
                                   f"loss {float(loss)} or gradient")
            check_clipped(models[1])
            print(f"train GAN {route} step {step}: loss {float(loss):.8g} "
                  f"{times[route][-1]:.3f} ms", flush=True)
    launches = dict(zip(GAN_COUNTERS, gan_counts()))
    medians = {route: float(np.median(t)) for route, t in times.items()}
    print(f"GAN train step: fused median {medians['fused']:.3f} ms, sdeint "
          f"median {medians['sdeint']:.3f} ms over {GAN_TRAIN_STEPS} steps "
          f"(host clock, synchronised)", flush=True)
    return launches, grad_rel, trained, batch


def phase_gan_train_profile(trained, ts, batch):
    """A GAN training step of each route under the profiler."""
    for route in ROUTES:
        models, opts = trained[route]
        profile_run(f"GAN train step {route}", lambda: gan_train_step(
            models, opts, ts, batch, 800, route == "fused"))


# --------------------------------------------------------------------------- #
#  fused_sdeint on TowerSpec towers: kernels 9-12                             #
# --------------------------------------------------------------------------- #

def tower_spec(seed, sizes, acts, device, grad=True, scale=0.3):
    """A TowerSpec of the JAX package's benchmarks/fused_solve_bench.py:19-25:
    weights normal x scale/sqrt(fan_in) (scale 0.3) from a numpy seed, zero
    biases; with ``grad`` the tensors are leaves that record gradients."""
    rng = np.random.default_rng(seed)
    layers = []
    for (a, b), act in zip(zip(sizes[:-1], sizes[1:]), acts):
        w = torch.as_tensor(rng.standard_normal((a, b))
                            * (scale / np.sqrt(a)), dtype=torch.float32,
                            device=device)
        layers.append((w.requires_grad_(grad),
                       torch.zeros(b, device=device).requires_grad_(grad),
                       act))
    return FS.TowerSpec(layers)


def tower_config(device, name):
    """E1, R1, L1 or L2's method, batch, width and towers from their seeds:
    (drift, diffusion), or for the logqp configurations L1 and L2 (drift,
    prior, diffusion), the order of fused_sdeint_logqp."""
    if name in LOGQP_CONFIGS:
        method, (B, d, hidden) = "euler_logqp", LOGQP_CONFIGS[name]
    else:
        method, B, d, hidden = TOWER_CONFIGS[name]
    drift = tower_spec(SEED + 10, [d, hidden, d], TOWER_FACTS, device)
    diffusion = tower_spec(SEED + 11, [d, hidden, d], TOWER_GACTS, device)
    if method != "euler_logqp":
        return method, B, d, (drift, diffusion)
    prior = tower_spec(SEED + 20, [d, hidden, d], TOWER_FACTS, device)
    return method, B, d, (drift, prior, diffusion)


def tower_kernel_args(device, method, drift, diffusion, B, d, m, diag, wt,
                      seed):
    """A solve's spec and a forward kernel's inputs as fused_sdeint makes
    them, on seeded y0 and noise over the step grid of [0, 1] at
    TOWER_DT."""
    spec = FS.solve_spec(drift, diffusion, d, m, diag, wt)
    grid = TI.build_step_grid(0.0, 1.0, TOWER_DT)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        y0 = torch.randn((B, d), generator=gen, device=device)
        W = TI.sample_grid_noise(gen, grid, (B, m), torch.float32,
                                 device)[0]
        t = torch.as_tensor(grid, dtype=torch.float32, device=device)
        dts = t[1:] - t[:-1]
        fw, gw = drift.pack(), diffusion.pack()
        if method == "euler":
            return spec, (y0, W, t[:-1], dts, fw, gw, spec)
        x0 = FS.tower_input(t[0], y0, wt)
        f0 = FS.tower_forward(x0, FS.unpack(fw, spec.drift), drift.acts)[0]
        g0 = FS.tower_forward(x0, FS.unpack(gw, spec.diffusion),
                              diffusion.acts)[0]
        return spec, (y0, f0, g0, W, t[1:], dts, fw, gw, spec)


def tower_flops(spec, B, N, kind):
    """Operations of a kernel of ``kind``, two per multiply-add: per row and
    step, the towers' sum of in*out over every layer (three times that for
    a reverse sweep: the recompute, the weight gradients, the input
    cotangents) and the noise products (G = S or S*m multiply-adds each:
    one for Euler, two for reversible Heun; two and four going back); the
    logqp kernels add the KL integrand's sum of u^2 forward and its
    cotangents' two products going back (S each). Activations, divisions
    and biases are not counted."""
    macs = sum(i * o for i, o, _ in spec.drift + spec.diffusion + spec.prior)
    G = spec.gwidth
    per = {"euler_fwd": macs + G, "rh_fwd": macs + 2 * G,
           "euler_bwd": 3 * macs + 2 * G, "rh_bwd": 3 * macs + 4 * G,
           "euler_logqp_fwd": macs + 2 * G,
           "euler_logqp_bwd": 3 * macs + 4 * G}[kind]
    return 2 * B * N * per


def tensors_of(args):
    return [a for a in args if torch.is_tensor(a)]


def in_double(args):
    return [a.double() if torch.is_tensor(a) else a for a in args]


def run_tower_kernels(label, device, method, drift, diffusion, B, d, m, diag,
                      wt, seed, timed):
    """A forward kernel and its reverse sweep against their plain versions
    (and float64 runs) on seeded inputs and cotangents; two sweeps must
    agree bitwise. With ``timed``, median device times and bounds too.
    Returns a record for each kernel."""
    euler = method == "euler"
    spec, args = tower_kernel_args(device, method, drift, diffusion, B, d, m,
                                   diag, wt, seed)
    N = args[1 if euler else 3].shape[0]
    if euler:
        names = ("tower_euler_fwd", "tower_euler_bwd")
        fwd, fwd_plain = FS.euler_solve_forward_cuda, \
            FS.euler_solve_forward_plain
        bwd, bwd_plain = FS.euler_solve_backward_cuda, \
            FS.euler_solve_backward_plain
        kinds = (FS.EULER_FWD, FS.EULER_BWD)
        outs = ("ys",)
        douts = ("dy0", "dnoise", "dfw", "dgw")
    else:
        names = ("tower_rh_fwd", "tower_rh_bwd")
        fwd, fwd_plain = FS.rh_solve_forward_cuda, FS.rh_solve_forward_plain
        bwd, bwd_plain = FS.rh_solve_backward_cuda, \
            FS.rh_solve_backward_plain
        kinds = (FS.RH_FWD, FS.RH_BWD)
        outs = ("ys", "zs", "gs")
        douts = ("dy0", "df0", "dg0", "dnoise", "dfw", "dgw")
    lib = _build.load_library()
    table = FS._host_table(spec)
    layout = []
    for kind in kinds:
        stage = FS.staged_towers(lib, kind, spec, B, device)
        smem = lib.tsde_tower_smem_bytes(kind, table, *FS._dims(spec),
                                         stage)
        layout.append(f"{smem} bytes, towers staged {stage}")
    print(f"{label}: batch {B}, d {d}, m {m}, {N} steps, "
          f"{'diagonal' if diag else 'general'} noise, time column {wt}; "
          f"shared memory a block: {layout[0]} (forward), {layout[1]} "
          f"(backward)", flush=True)
    as_tuple = (lambda o: (o,)) if euler else tuple
    with torch.no_grad():
        got = as_tuple(fwd(*args))
        want = as_tuple(fwd_plain(*args))
        exact = as_tuple(fwd_plain(*in_double(args)))
        torch.cuda.synchronize()
        err_f = check_against_plain(f"{label} {names[0]}", outs, got, want,
                                    exact, TOWER_VAL_ATOL, TOWER_VAL_REL)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        gy = torch.randn(got[0].shape, generator=gen, device=device)
        bargs = (*args, *(got if euler else got[1:]), gy)
        got_b = bwd(*bargs)
        want_b = bwd_plain(*bargs)
        exact_b = bwd_plain(*in_double(bargs))
        torch.cuda.synchronize()
        err_b = check_against_plain(f"{label} {names[1]}", douts, got_b,
                                    want_b, exact_b, TOWER_GRAD_ATOL,
                                    TOWER_GRAD_REL)
        again = bwd(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
            raise RuntimeError(f"{label} {names[1]} is not bitwise "
                               f"repeatable")
        print(f"{label} {names[1]}: two calls agree bitwise", flush=True)
        if not timed:
            return None
        ms_f = median_cuda_ms(lambda: fwd(*args), 20)
        plain_f = median_cuda_ms(lambda: fwd_plain(*args), 5, warmup=1)
        ms_b = median_cuda_ms(lambda: bwd(*bargs), 10)
        plain_b = median_cuda_ms(lambda: bwd_plain(*bargs), 3, warmup=1)
    records = []
    for name, ms, plain_ms, err, io, kind in (
            (names[0], ms_f, plain_f, err_f, tensors_of(args) + list(got),
             names[0][6:]),
            (names[1], ms_b, plain_b, err_b,
             tensors_of(bargs) + list(got_b), names[1][6:])):
        flops = tower_flops(spec, B, N, kind)
        bound_ms, bound_by = bound(flops, io)
        print(f"{label} {name}: median {ms:.4f} ms; plain: median "
              f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
              f"{flops / 1e9:.3f} GFLOP); {flops / ms / 1e9:.2f} TFLOP/s",
              flush=True)
        records.append(dict(max_abs_err=err[0], max_rel_err=err[1], ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by))
    return records


def phase_tower_kernels(device):
    """Kernels 9 and 10 at E1, 11 and 12 at R1, and all four on general
    noise with a time column and depth-3 towers."""
    records = {}
    for name in ("E1", "R1"):
        method, B, d, (drift, diffusion) = tower_config(device, name)
        fwd, bwd = run_tower_kernels(name, device, method, drift, diffusion,
                                     B, d, d, True, False, SEED + 12, True)
        records[method] = (fwd, bwd)
    B, d, m, hidden = TOWER_GENERAL
    drift = tower_spec(SEED + 13, [d + 1, hidden, hidden, d],
                       ("softplus", "tanh", "linear"), device)
    diffusion = tower_spec(SEED + 14, [d + 1, hidden, hidden, d * m],
                           ("lipswish", "softplus", "sigmoid"), device)
    for method in ("euler", "reversible_heun"):
        run_tower_kernels(f"general {method}", device, method, drift,
                          diffusion, B, d, m, False, True, SEED + 15, False)
    return records


# --------------------------------------------------------------------------- #
#  fused_sdeint_logqp: kernels 13 and 14                                      #
# --------------------------------------------------------------------------- #

def logqp_kernel_args(device, towers, B, d, wt, seed):
    """A logqp solve's spec and kernel 13's inputs as fused_sdeint_logqp
    makes them (noise drawn at (B, d+1), its last channel unused), on
    seeded y0 and noise over the step grid of [0, 1] at TOWER_DT."""
    drift, prior, diffusion = towers
    spec = FS.solve_spec(drift, diffusion, d, d, True, wt, prior=prior)
    grid = TI.build_step_grid(0.0, 1.0, TOWER_DT)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        y0 = torch.randn((B, d), generator=gen, device=device)
        W = TI.sample_grid_noise(gen, grid, (B, d + 1), torch.float32,
                                 device)[0][..., :d].contiguous()
        t = torch.as_tensor(grid, dtype=torch.float32, device=device)
        return spec, (y0, W, t[:-1], t[1:] - t[:-1], drift.pack(),
                      prior.pack(), diffusion.pack(), spec)


def run_logqp_kernels(label, device, towers, B, d, wt, seed, stagings=(),
                      signed=False):
    """Kernels 13 and 14 against their plain versions (and float64 runs)
    on seeded inputs and cotangents; two sweeps must agree bitwise. With
    ``stagings``, median device times and bounds too, and the times of each
    way of staging the towers in ``stagings``. Returns a record for each
    kernel. A ``signed`` diffusion passes near zero, where u = (f - h) / g
    amplifies the two versions' rounding of g: qs and the gradients then
    also get the JAX package's relative tolerance for that case
    (LOGQP_SIGNED_RTOL)."""
    q_rtol, grad_rtol = LOGQP_SIGNED_RTOL if signed else (0.0, 0.0)
    spec, args = logqp_kernel_args(device, towers, B, d, wt, seed)
    N = args[1].shape[0]
    lib = _build.load_library()
    table = FS._host_table(spec)
    layout = []
    for kind in (FS.EULER_LOGQP_FWD, FS.EULER_LOGQP_BWD):
        stage = FS.staged_towers(lib, kind, spec, B, device)
        smem = lib.tsde_tower_smem_bytes(kind, table, *FS._dims(spec),
                                         stage)
        layout.append(f"{smem} bytes, towers staged {stage}")
    print(f"{label}: batch {B}, d {d}, {N} steps, time column {wt}; shared "
          f"memory a block: {layout[0]} (forward), {layout[1]} (backward)",
          flush=True)
    fwd, fwd_plain = (FS.euler_logqp_solve_forward_cuda,
                      FS.euler_logqp_solve_forward_plain)
    bwd, bwd_plain = (FS.euler_logqp_solve_backward_cuda,
                      FS.euler_logqp_solve_backward_plain)
    with torch.no_grad():
        got = fwd(*args)
        want = fwd_plain(*args)
        exact = fwd_plain(*in_double(args))
        torch.cuda.synchronize()
        g_min = float(FS.tower_forward(
            FS.tower_input(args[2][0], args[0], wt),
            FS.unpack(args[6], spec.diffusion), towers[2].acts)[0].abs().min())
        print(f"{label}: min |g| at y0 {g_min:.3e}", flush=True)
        err_f = check_against_plain(f"{label} tower_euler_logqp_fwd",
                                    ("ys",), got[:1], want[:1], exact[:1],
                                    TOWER_VAL_ATOL, TOWER_VAL_REL)
        err_q = check_against_plain(f"{label} tower_euler_logqp_fwd",
                                    ("qs",), got[1:], want[1:], exact[1:],
                                    TOWER_VAL_ATOL, TOWER_VAL_REL, q_rtol)
        err_f = tuple(max(a, b) for a, b in zip(err_f, err_q))
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        gy = torch.randn(got[0].shape, generator=gen, device=device)
        gq = torch.randn(got[1].shape, generator=gen, device=device)
        ginc = gq.flip(0).cumsum(0).flip(0).contiguous()
        bargs = (*args, got[0], gy, ginc)
        got_b = bwd(*bargs)
        want_b = bwd_plain(*bargs)
        exact_b = bwd_plain(*in_double(bargs))
        torch.cuda.synchronize()
        err_b = check_against_plain(f"{label} tower_euler_logqp_bwd",
                                    ("dy0", "dnoise", "dfw", "dhw", "dgw"),
                                    got_b, want_b, exact_b, TOWER_GRAD_ATOL,
                                    TOWER_GRAD_REL, grad_rtol)
        again = bwd(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
            raise RuntimeError(f"{label} tower_euler_logqp_bwd is not "
                               f"bitwise repeatable")
        print(f"{label} tower_euler_logqp_bwd: two calls agree bitwise",
              flush=True)
        if not stagings:
            return None
        ms_f = median_cuda_ms(lambda: fwd(*args), 20)
        plain_f = median_cuda_ms(lambda: fwd_plain(*args), 5, warmup=1)
        ms_b = median_cuda_ms(lambda: bwd(*bargs), 10)
        plain_b = median_cuda_ms(lambda: bwd_plain(*bargs), 3, warmup=1)
        by_stage = {}
        for stage in stagings:
            by_stage[stage] = (
                median_cuda_ms(lambda: fwd(*args, stage=stage), 10),
                median_cuda_ms(lambda: bwd(*bargs, stage=stage), 5))
    print(f"{label} staging (towers staged: forward / backward ms): "
          + "; ".join(f"{st}: {f:.4f} / {b:.4f}"
                      for st, (f, b) in by_stage.items()), flush=True)
    records = []
    for name, ms, plain_ms, err, io, kind, i in (
            ("tower_euler_logqp_fwd", ms_f, plain_f, err_f,
             tensors_of(args) + list(got), "euler_logqp_fwd", 0),
            ("tower_euler_logqp_bwd", ms_b, plain_b, err_b,
             tensors_of(bargs) + list(got_b), "euler_logqp_bwd", 1)):
        flops = tower_flops(spec, B, N, kind)
        bound_ms, bound_by = bound(flops, io)
        print(f"{label} {name}: median {ms:.4f} ms; plain: median "
              f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
              f"{flops / 1e9:.3f} GFLOP); {flops / ms / 1e9:.2f} TFLOP/s",
              flush=True)
        records.append(dict(max_abs_err=err[0], max_rel_err=err[1], ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by,
                            ms_by_staging={str(st): t[i] for st, t
                                           in by_stage.items()}))
    return records


def phase_logqp_kernels(device):
    """Kernels 13 and 14 at L1 and L2 (timed, with the stagings of
    LOGQP_STAGINGS) and on the small solve with a signed diffusion."""
    records = {}
    for name in ("L1", "L2"):
        _, B, d, towers = tower_config(device, name)
        records[name] = run_logqp_kernels(name, device, towers, B, d, False,
                                          SEED + 21, LOGQP_STAGINGS[name])
    B, d, hidden = LOGQP_SMALL
    towers = (tower_spec(SEED + 22, [d + 1, hidden, d], TOWER_FACTS, device),
              tower_spec(SEED + 23, [d + 1, hidden, d], TOWER_FACTS, device),
              tower_spec(SEED + 24, [d + 1, hidden, d], ("lipswish", "tanh"),
                         device, scale=0.8))
    run_logqp_kernels("small", device, towers, B, d, True, SEED + 25,
                      signed=True)
    return records


TOWER_COUNTERS = {"euler": ("euler_launches", "euler_bwd_launches"),
                  "reversible_heun": ("rh_launches", "rh_bwd_launches"),
                  "euler_logqp": ("logqp_launches", "logqp_bwd_launches")}


def tower_counts(method):
    """The forward and backward kernels' launch counts of ``method``."""
    return tuple(getattr(FS, c) for c in TOWER_COUNTERS[method])


def reset_tower_counts():
    for names in TOWER_COUNTERS.values():
        for c in names:
            setattr(FS, c, 0)


def tower_loss(config, y0, seed, dispatch):
    """One solve on a generator seeded ``seed`` and its loss: mean(ys**2)
    for fused_sdeint, mean(ys**2) + mean(sum(log_ratio, 0)) for
    fused_sdeint_logqp. Returns the loss and the solve's outputs."""
    method, *towers = config
    gen = torch.Generator(device=y0.device).manual_seed(seed)
    ts = np.linspace(0.0, 1.0, TOWER_N_TS)
    if method == "euler_logqp":
        ys, log_ratio = FS.fused_sdeint_logqp(*towers, y0, ts, gen,
                                              TOWER_DT, dispatch=dispatch)
        return (ys ** 2).mean() + log_ratio.sum(0).mean(), (ys, log_ratio)
    ys = FS.fused_sdeint(*towers, y0, ts, gen, TOWER_DT, method=method,
                         dispatch=dispatch)
    return (ys ** 2).mean(), (ys,)


def tower_leaves(config):
    return [t for spec in config[1:] for (w, b, _) in spec.layers
            for t in (w, b)]


def phase_tower_serve_train(device, name):
    """fused_sdeint at E1 or R1, or fused_sdeint_logqp at L1: three served
    solves per route, step-0 gradients of both routes, three Adam steps per
    route in turns, and a profiled training step of each."""
    method, B, d, towers = tower_config(device, name)
    config = (method, *towers)
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    y0 = torch.randn((B, d), generator=gen, device=device)
    routes = {"fused": "fused", "sdeint": "xla"}
    shapes = [(TOWER_N_TS, B, d), (TOWER_N_TS - 1, B)]
    out_names = ("states", "KL increments")

    def serve(seed, route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            outs = tower_loss(config, y0, seed, routes[route])[1]
        torch.cuda.synchronize()
        return outs, (time.perf_counter() - t0) * 1e3

    serve(100, "fused")                                 # warm-up
    serve(100, "sdeint")
    seeds = (101, 102, 103)
    reset_tower_counts()
    fused = []
    for seed in seeds:
        before = tower_counts(method)
        fused.append(serve(seed, "fused"))
        delta = tuple(a - b for a, b in zip(tower_counts(method), before))
        if delta != (1, 0):
            raise RuntimeError(f"{name} solve {seed}: kernels launched "
                               f"{delta} times")
    serve_launches = tower_counts(method)[0]
    plain = [serve(seed, "sdeint") for seed in seeds]
    if tower_counts(method)[0] != serve_launches:
        raise RuntimeError("the sdeint route launched a tower kernel")
    for seed, (outs_f, _), (outs_p, _) in zip(seeds, fused, plain):
        for what, shape, got, want in zip(out_names, shapes, outs_f, outs_p):
            if got.shape != shape or not torch.isfinite(got).all():
                raise RuntimeError(f"{name} solve {seed}: {what} of shape "
                                   f"{tuple(got.shape)} or non-finite")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            print(f"{name} solve {seed}: {what} fused vs sdeint max diff "
                  f"{err:.3e} (max {scale:.4g})", flush=True)
            if err > max(TOWER_VAL_ATOL, TOWER_VAL_REL * scale):
                raise RuntimeError(f"{name} solve {seed}: routes' {what} "
                                   f"differ by {err:.3e} > max("
                                   f"{TOWER_VAL_ATOL}, {TOWER_VAL_REL} * "
                                   f"{scale:.4g})")
    serve_ms = {route: float(np.median([t for _, t in runs]))
                for route, runs in (("fused", fused), ("sdeint", plain))}
    print(f"{name} served solve: fused median {serve_ms['fused']:.3f} ms, "
          f"sdeint median {serve_ms['sdeint']:.3f} ms (host clock, "
          f"synchronised)", flush=True)

    # Step-0 gradients of both routes, to y0 and every tower tensor.
    grads = {}
    for route in routes:
        config_r = (method, *tower_config(device, name)[3])
        y = y0.clone().requires_grad_()
        loss, _ = tower_loss(config_r, y, 300, routes[route])
        loss.backward()
        grads[route] = [t.grad for t in tower_leaves(config_r)] + [y.grad]
    worst = 0.0
    for i, (got, want) in enumerate(zip(grads["fused"], grads["sdeint"])):
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError(f"{name} step 0: non-finite gradient {i}")
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / scale if scale > 0 else 0.0
        worst = max(worst, rel)
    print(f"{name} step-0 gradients, fused vs sdeint: worst "
          f"{worst:.3e} of scale", flush=True)
    if worst > TOWER_ROUTE_GRAD_REL:
        raise RuntimeError(f"{name} step-0 gradients differ by {worst:.3e} "
                           f"of scale > {TOWER_ROUTE_GRAD_REL}")

    # Adam steps of both routes in turns, from the same seeded towers.
    trained = {}
    for route in routes:
        config_r = (method, *tower_config(device, name)[3])
        trained[route] = (config_r, torch.optim.Adam(tower_leaves(config_r),
                                                     lr=TOWER_LR))
    y = y0.clone().requires_grad_()

    def train_step(route, seed):
        config_r, opt = trained[route]
        opt.zero_grad(set_to_none=True)
        y.grad = None
        loss, _ = tower_loss(config_r, y, seed, routes[route])
        loss.backward()
        opt.step()
        return loss.detach()

    times = {route: [] for route in routes}
    reset_tower_counts()
    for step in range(TOWER_TRAIN_STEPS):
        for route in (("fused", "sdeint") if step % 2 == 0
                      else ("sdeint", "fused")):
            before = tower_counts(method)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = train_step(route, 400 + step)
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3)
            delta = tuple(a - b for a, b in zip(tower_counts(method),
                                                before))
            if delta != ((1, 1) if route == "fused" else (0, 0)):
                raise RuntimeError(f"{name} {route} step {step}: kernels "
                                   f"launched {delta} times")
            params = tower_leaves(trained[route][0]) + [y]
            if not (np.isfinite(float(loss))
                    and all(torch.isfinite(p.grad).all() for p in params)):
                raise RuntimeError(f"{name} {route} step {step}: non-finite "
                                   f"loss or gradient")
            print(f"train {name} {route} step {step}: loss "
                  f"{float(loss):.8g} {times[route][-1]:.3f} ms", flush=True)
    train_launches = tower_counts(method)
    medians = {route: float(np.median(t)) for route, t in times.items()}
    print(f"{name} train step: fused median {medians['fused']:.3f} ms, "
          f"sdeint median {medians['sdeint']:.3f} ms over "
          f"{TOWER_TRAIN_STEPS} steps (host clock, synchronised)", flush=True)
    # 16 and 19. A profiled training step of each route.
    for route in routes:
        profile_run(f"{name} train step {route}",
                    lambda: train_step(route, 500))
    return dict(launches_serve=serve_launches, launches=train_launches,
                step0_grad_rel_err=worst)


AUTO_SHAPES = (("euler", 1024, 8, 64, 128),
               ("reversible_heun", 1024, 8, 64, 128),
               ("euler", *TOWER_CONFIGS["E1"][1:], 128),
               ("reversible_heun", *TOWER_CONFIGS["R1"][1:], 128),
               ("euler", 4, 3, 8, 2))
AUTO_LOGQP_SHAPES = (("euler_logqp", 1024, 8, 64, 128),
                     ("euler_logqp", *LOGQP_CONFIGS["L1"], 128),
                     ("euler_logqp", 4, 3, 8, 2))


def phase_auto_dispatch(device, shapes):
    """The grad path of benchmarks/fused_solve_bench.py:51-53 (the gradient
    of sum(ys**2), plus sum(log_ratio) for the logqp solve, to y0) on the
    kernel route and on the sdeint route, at the bench's narrow shape (:73,
    and its reversible-Heun twin :75), at E1, R1 and L1, and at the narrow
    shape of tests/test_fused_solve.py:265-289: the measurement behind
    fused_solve._auto_fuse."""
    rows = []
    for method, B, d, hidden, steps in shapes:
        towers = [tower_spec(SEED + seed, [d, hidden, d], acts, device,
                             grad=False)
                  for seed, acts in ((17, TOWER_FACTS), (26, TOWER_FACTS),
                                     (18, TOWER_GACTS))]
        if method != "euler_logqp":
            towers = [towers[0], towers[2]]
        y0 = torch.randn((B, d), device=device,
                         generator=torch.Generator(device=device).manual_seed(
                             SEED + 19))
        ts = np.linspace(0.0, 1.0, 9 if steps > 8 else 3)
        ms = {}
        for dispatch in ("fused", "xla", "fused", "xla"):
            times = []
            for rep in range(6):
                y = y0.clone().requires_grad_()
                gen = torch.Generator(device=device).manual_seed(rep)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if method == "euler_logqp":
                    ys, log_ratio = FS.fused_sdeint_logqp(
                        *towers, y, ts, gen, 1.0 / steps, dispatch=dispatch)
                    loss = (ys ** 2).sum() + log_ratio.sum()
                else:
                    loss = (FS.fused_sdeint(
                        *towers, y, ts, gen, 1.0 / steps, method=method,
                        dispatch=dispatch) ** 2).sum()
                loss.backward()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms.setdefault(dispatch, []).append(float(np.median(times[1:])))
        fused_ms, xla_ms = min(ms["fused"]), min(ms["xla"])
        rows.append(dict(method=method, batch=B, d=d, hidden=hidden,
                         steps=steps, fused_grad_ms=fused_ms,
                         xla_grad_ms=xla_ms,
                         auto_fuses=FS._auto_fuse(torch.float32)))
        print(f"auto dispatch: {method} batch {B} d {d} hidden {hidden} "
              f"{steps} steps: grad path fused {fused_ms:.3f} ms, sdeint "
              f"{xla_ms:.3f} ms, x{xla_ms / fused_ms:.1f}; _auto_fuse "
              f"{rows[-1]['auto_fuses']} (host clock, synchronised; the "
              f"better of two medians of 5)", flush=True)
    return rows


def main():
    device, card = phase_device()
    phase_build()
    kernel1 = phase_kernel(device)
    kernel2 = phase_kernel2(device)
    xs, ts = lorenz_data(device)
    served_launches, served = phase_serve(device, xs, ts)
    launches, grad_rel, models, opts = phase_train(device, xs, ts)
    phase_profile(device, served, (models, opts), xs, ts)
    gan = gan_models(device)
    gan_ts, real = gan_data(device)
    kernel5, kernel7 = phase_gan_kernels(device, gan, gan_ts, real)
    gan_launches = phase_gan_serve(device, gan, gan_ts, real)
    phase_gan_profile(device, gan, gan_ts, real)
    kernel6, kernel8 = phase_gan_bwd_kernels(device, gan, gan_ts, real)
    train_launches, gan_grad_rel, trained, batch = phase_gan_train(
        device, gan_ts, real)
    phase_gan_train_profile(trained, gan_ts, batch)
    tower_kernels = phase_tower_kernels(device)
    tower_runs = {TOWER_CONFIGS[name][0]: phase_tower_serve_train(device,
                                                                 name)
                  for name in ("E1", "R1")}
    phase_auto_dispatch(device, AUTO_SHAPES)
    logqp_kernels = phase_logqp_kernels(device)["L1"]
    tower_runs["euler_logqp"] = phase_tower_serve_train(device, "L1")
    tower_kernels["euler_logqp"] = logqp_kernels
    phase_auto_dispatch(device, AUTO_LOGQP_SHAPES)
    torch.cuda.synchronize()
    csrc = "torchsde_tpu_torch/ops/csrc"
    records = [
        dict(name="latent_fused_fwd", route="cuda",
             source=f"{csrc}/latent_fused_fwd.cu",
             replaces="torchsde_tpu/ops/latent_fused.py:156",
             launches=launches[0], launches_serve=served_launches,
             library_ms=None, **kernel1),
        dict(name="latent_fused_bwd", route="cuda",
             source=f"{csrc}/latent_fused_bwd.cu",
             replaces="torchsde_tpu/ops/latent_fused.py:248",
             launches=launches[1], library_ms=None,
             step0_grad_rel_err=grad_rel, **kernel2),
        dict(name="gan_gen_fwd", route="cuda",
             source=f"{csrc}/gan_gen_fwd.cu",
             replaces="torchsde_tpu/ops/gan_fused.py:151",
             launches=gan_launches[0],
             launches_train=train_launches["gen_launches"], library_ms=None,
             **kernel5),
        dict(name="gan_cde_fwd", route="cuda",
             source=f"{csrc}/gan_cde_fwd.cu",
             replaces="torchsde_tpu/ops/gan_fused.py:422",
             launches=gan_launches[1],
             launches_train=train_launches["cde_launches"], library_ms=None,
             **kernel7),
        dict(name="gan_gen_bwd", route="cuda",
             source=f"{csrc}/gan_gen_bwd.cu",
             replaces="torchsde_tpu/ops/gan_fused.py:200",
             launches=train_launches["gen_bwd_launches"], library_ms=None,
             step0_grad_rel_err=gan_grad_rel, **kernel6),
        dict(name="gan_cde_bwd", route="cuda",
             source=f"{csrc}/gan_cde_bwd.cu",
             replaces="torchsde_tpu/ops/gan_fused.py:458",
             launches=train_launches["cde_bwd_launches"], library_ms=None,
             **kernel8),
    ]
    for method, names, lines in (("euler", ("tower_euler_fwd",
                                            "tower_euler_bwd"), (211, 242)),
                                 ("reversible_heun", ("tower_rh_fwd",
                                                      "tower_rh_bwd"),
                                  (302, 352)),
                                 ("euler_logqp", ("tower_euler_logqp_fwd",
                                                  "tower_euler_logqp_bwd"),
                                  (819, 853))):
        run = tower_runs[method]
        for i, (name, line) in enumerate(zip(names, lines)):
            extra = (dict(launches_serve=run["launches_serve"]) if i == 0
                     else dict(step0_grad_rel_err=run["step0_grad_rel_err"]))
            records.append(dict(
                name=name, route="cuda", source=f"{csrc}/{name}.cu",
                replaces=f"torchsde_tpu/ops/fused_solve.py:{line}",
                launches=run["launches"][i], library_ms=None, **extra,
                **tower_kernels[method][i]))
    for record in records:
        if record["launches"] < 1:
            raise RuntimeError(f"{record['name']} was not launched on the "
                               f"main path")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
