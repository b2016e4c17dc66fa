"""Run torchsde_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and cuDNN;
2. build: builds both CUDA kernels from the repository's sources with nvcc
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
   share.

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
from torchsde_tpu_torch.ops import _build
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
# Published H100 SXM peaks (NVIDIA H100 datasheet): float32 outside the
# tensor cores, and device memory.
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12


def median_cuda_ms(fn, reps, warmup=2):
    """Median over ``reps`` calls of ``fn``'s device time, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
    model.contextualize(ts, ctx)
    z0 = torch.randn((BATCH, LATENT), generator=gen, device=device)
    with torch.no_grad():
        return LF._prep_solve(model, z0, ts, gen, DT)[:5]


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
    kernels by name."""
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
        if e.device_type == DeviceType.CUDA:
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


def main():
    device, card = phase_device()
    phase_build()
    kernel1 = phase_kernel(device)
    kernel2 = phase_kernel2(device)
    xs, ts = lorenz_data(device)
    served_launches, served = phase_serve(device, xs, ts)
    launches, grad_rel, models, opts = phase_train(device, xs, ts)
    phase_profile(device, served, (models, opts), xs, ts)
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
    ]
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
