"""Run torchsde_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and cuDNN;
2. build: builds the CUDA kernel from the repository's sources with nvcc;
3. kernel vs plain: the whole-solve forward kernel against its plain PyTorch
   version at the flagship shapes, with the error and median times;
4. slice: a flagship LatentSDE (batch 1024, data 3, latent 4, context 64,
   hidden 128, 32 output times on [0, 1], dt 1/128, float32, random
   weights from a seed) serves three forward passes of
   ``latent_sde_loss(fused=True)`` under ``torch.no_grad()`` on stochastic
   Lorenz data; each loss must be finite, agree with the ``sdeint`` route
   (``fused=False``) on the same generator seed, and the kernel must have
   been launched exactly once per pass;
5. profile: one more forward pass of each route under torch.profiler,
   for the kernel count, device time and the device's busy share.

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
# Fused vs sdeint route on one loss (tests/test_fused_latent.py:86).
LOSS_RTOL = 1e-4


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
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  nvcc: {line.strip()}", flush=True)


def flagship_model(device):
    gen = torch.Generator().manual_seed(SEED)
    return LatentSDE(DATA, LATENT, CONTEXT, HIDDEN, device=device,
                     generator=gen)


def phase_kernel(device):
    """Kernel vs plain version on seeded inputs at the flagship shapes."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    model = flagship_model(device)
    ts = np.linspace(0.0, 1.0, N_TS)
    ctx = torch.randn((N_TS, BATCH, CONTEXT), generator=gen, device=device)
    model.contextualize(ts, ctx)
    z0 = torch.randn((BATCH, LATENT), generator=gen, device=device)
    with torch.no_grad():
        args = LF._prep_solve(model, z0, ts, gen, DT)[:5]
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
        print(f"kernel vs plain: n={n} steps, max|zs|="
              f"{float(zs_p.abs().max()):.4g}, max|qs|="
              f"{float(qs_p.abs().max()):.4g}, max_abs_err={err:.3e}",
              flush=True)
        torch.testing.assert_close(zs_k, zs_p, atol=KERNEL_ATOL, rtol=0)
        torch.testing.assert_close(qs_k, qs_p, atol=KERNEL_ATOL, rtol=0)
        ms = median_cuda_ms(lambda: LF.fused_solve_forward_cuda(*args,
                                                                weights), 20)
        plain_ms = median_cuda_ms(
            lambda: LF.fused_solve_forward_plain(*args, weights), 5)
    print(f"kernel: median {ms:.4f} ms; plain: median {plain_ms:.4f} ms",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_slice(device):
    """Three flagship forward passes through the kernel, each checked
    against the sdeint route on the same generator seed."""
    model = flagship_model(device)
    ts = np.linspace(0.0, 1.0, N_TS)
    data_gen = torch.Generator(device=device).manual_seed(SEED + 2)
    with torch.no_grad():
        xs = make_lorenz_data(BATCH, ts, generator=data_gen, device=device)
    if xs.shape != (N_TS, BATCH, DATA) or not torch.isfinite(xs).all():
        raise RuntimeError(f"lorenz data: shape {tuple(xs.shape)}")

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
    LF.launches = 0
    fused = [serve(s, True) for s in seeds]
    launches = LF.launches
    plain = [serve(s, False) for s in seeds]
    if launches != len(seeds):
        raise RuntimeError(f"kernel launched {launches} times in "
                           f"{len(seeds)} fused passes")
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
    return launches, (model, xs, ts)


def phase_profile(device, model, xs, ts):
    """One forward pass of each route under torch.profiler: the number of
    kernels, their device time, the device's busy share of the pass's
    (profiled) wall time, and the costliest kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fused in (True, False):
        route = "fused" if fused else "sdeint"
        gen = torch.Generator(device=device).manual_seed(200)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.no_grad():
                latent_sde_loss(model, xs, ts, gen, dt=DT, fused=fused)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        device_ms = sum(us for _, us in by_name.values()) / 1e3
        kernels = sum(n for n, _ in by_name.values())
        print(f"profile {route}: wall {wall_ms:.3f} ms, device "
              f"{device_ms:.3f} ms, busy {device_ms / wall_ms:.3f}, "
              f"{kernels} kernels", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        for name, (n, us) in top:
            print(f"  {us / 1e3:9.3f} ms {n:6d}x {name[:90]}", flush=True)


def main():
    device, card = phase_device()
    phase_build()
    kernel = phase_kernel(device)
    launches, served = phase_slice(device)
    phase_profile(device, *served)
    torch.cuda.synchronize()
    record = dict(name="latent_fused_fwd", route="cuda",
                  source="torchsde_tpu_torch/ops/csrc/latent_fused_fwd.cu",
                  replaces="torchsde_tpu/ops/latent_fused.py:156",
                  launches=launches, **kernel)
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
