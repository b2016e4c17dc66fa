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
4. kernel 2 vs plain: the reverse-sweep kernel against its plain version
   and a float64 run on the same seeded inputs and cotangents, with normal
   and with saturated diffusion; two calls must agree bitwise; median
   times, whole and of its sweep and its contraction apart, beside
   torch.matmul on the same scratch tensors;
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
    and weight gradient against the plain versions and a float64 run
    (kernels 10 and 12 within twice the plain version's distance from it
    plus 3e-6 of scale, as kernel 2), two sweeps bitwise equal, kernels 10
    and 12 bitwise the same at every staging of their towers that fits,
    median times and bounds, kernels 10 and 12 whole and by phase (the
    sweep; the contraction beside torch.matmul on the same scratch) and at
    each staging of EULER_STAGINGS and RH_STAGINGS; then all four on
    general noise with a time column and depth-3 towers (batch 1024, d 16,
    m 4, hidden 64); then kernel 12 on R1's towers over 1,024 steps and
    kernel 10 on E1's over 512, swept in windows (check_long_solve);
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
    the plain versions and a float64 run (kernel 14 as kernel 12 in phase
    14), two sweeps bitwise equal, kernel 14 bitwise the same at every
    staging that fits, median times and bounds (kernel 13 in the design
    fused_solve.forward_design picks), kernel 14 by phase beside
    torch.matmul on the same scratch, and the times of each way of staging
    the towers (kernel 13's in the 8-row streamed design); then kernel 14
    on L1's over 512 steps, in windows;
19. serve and train ``fused_sdeint_logqp`` at L1: three served solves per
    route (``dispatch="fused"`` and the ``sdeint`` route of
    ``tower_sde(prior=)``), whose states and KL increments must agree; the
    step-0 gradients of both routes; three Adam steps (lr 1e-3) of
    mean(ys**2) + mean(sum(log_ratio, 0)) per route in turns, each fused
    step launching kernels 13 and 14 once; a profiled step of each route;
20. auto dispatch of ``fused_sdeint_logqp``: its grad path on both routes
    at the narrow shapes of phase 17, at L1 and on a tiny solve;
21. kernels 3 and 4 vs plain: the K-replica forward and reverse sweep at
    the flagship with K = 4 on seeded inputs and cotangents, with normal
    and with saturated diffusion, against their plain versions and float64
    runs, each replica bitwise equal to kernels 1 and 2 on its own inputs,
    two sweeps bitwise equal; median times at K = 1, 2, 4, 8 beside K
    launches of kernels 1 and 2, the rows a block kernel 3 takes at each,
    and the bounds; kernel 4 at K = 4 by phase as phase 4; then kernels 2
    and 4 over the flagship's solve at dt 1/512, swept in two windows
    (check_latent_long_solve);
22. replicas: ``latent_sde_loss_multi(fused=True)`` at K = 4 under
    ``torch.no_grad()``, each replica's loss against the single fused loss
    on a clone of its generator and each call launching kernel 3 once; the
    step-0 gradients of both routes against a float64 run; MULTI_STEPS Adam
    steps (lr 1e-2) on the stacked state, each launching kernels 3 and 4
    once, in turns with the multi ``sdeint`` route and K single fused
    models; median step times and a profile of each;
22a. bf16 mixed mode of kernels 1-4 at the flagship: kernels 1 and 2 (2
    with normal and saturated diffusion) and kernels 3 and 4 at K = 4
    against their mixed-mode plain versions and a float32 reference (the
    float32 plain version on the same bf16 weights, context and noise),
    no nearer that reference, rounded, than half the plain version (which
    a float64 stand-in for a kernel that rounds nothing must fail), every
    output in its dtype, two calls bitwise equal, each replica of 3 and 4
    bitwise 1 and 2, median times and bounds in bf16 bytes and at the bf16
    peak; kernels 2 and 4 by phase (the tensor-core sweep and contraction)
    with the contraction's torch.matmul (K = 1) or torch.bmm (K = 4)
    yardstick in bf16 on the same scratch, the sweep's shared memory a
    block and blocks an SM, and the HMMA, F2F and F2FP counts of the bf16
    sweep's and contraction's SASS; the routes on the JAX package's bars
    (5e-3 relative, cosine above 0.999): fused against ``sdeint`` at that
    test's size for eight seeds, fused against a float32-state reference
    at the flagship for four seeds at dt 1/32 and 1/128 (the ``sdeint``
    route's distances
    printed); three Adam steps of each route in turns, each fused step
    launching kernels 1 and 2 in bf16 once and the float32 kernels never,
    a profile of each route; K = 4 bf16 replicas of
    ``latent_sde_loss_multi(fused=True)`` against the single fused route
    and two Adam steps, each launching kernels 3 and 4 in bf16 once;
22b. bf16 mixed mode of the SDE-GAN kernels 5-8 at the reference scale:
    each on the inputs of bf16 models against its mixed-mode plain version
    and the float32 reference (the float32 plain version on the same bf16
    weights and noise), with the floor of its roundings (a float64 stand-in
    must miss it; kernel 8 on last-state and dense cotangents), every
    output in its dtype, two calls bitwise equal, median times at 64, 128
    and 256 threads and bounds in bf16 bytes and at the bf16 peak; the
    routes on the JAX package's bars (loss within 2e-2, cosine above
    0.999): fused against ``sdeint`` at its test's size for eight seeds,
    fused against a float32-state reference at the reference scale for
    three seeds, with the fake paths within 2^-4 of their scale (the
    ``sdeint`` route's distances printed); three training steps of each
    route in turns, each fused step launching kernels 5-8 in bf16 once and
    the float32 ones never, a profile of each route;
23. kernel 15 at the four configurations of the JAX package's
    benchmarks/srk_fused.py (batch 1024 or 16384, d 8 or 128, 128 steps of
    ExDiagonal): against its plain version and a float64 run, its strong
    error against the exact solution on the same W, once against
    ``sdeint(method="srk")``, median times and the bytes bound; one solve
    at full width counted as the path; then in bf16, on the same inputs
    rounded: bitwise its bf16 plain version, its roundings shown present
    against a float32 stand-in, its distance from float64 printed, against
    ``sdeint(method="srk")`` in bf16 at (1024, 8), median times and the
    bf16 bound, and one bf16 solve at full width counted as the path;
24. kernel 16: against its plain version at (128, 1024, 9) and (128, 16384,
    128), the moments and a KS test of 2^20 draws, determinism, median
    times beside ``torch.randn``'s (another stream) and the bound, and one
    ``sdeint(method="srk", rng_impl="philox", noise_precompute=True)``
    solve at full width, which launches it twice;
25. brownian (no kernel: the dyadic descent and the solvers are plain
    PyTorch): (a) a float32 ``BrownianInterval`` (entropy 42) at the
    reference benchmarks' sizes (128, 5), (256, 128) and (512, 256), Levy
    area none and space-time (and Foster's at (128, 5)), two
    ``query_grid`` calls over 257 points bitwise equal and timed, and
    the same interval on the CPU: branch bits resolved on the card, packed
    words, keys, random bits and uniforms bitwise, W, U and A within
    BM_F32_ATOL and BM_F32_A_ATOL (every cell at (128, 5), BM_CPU_CELLS
    above); (b) W and U additive, query order and ``query_pairs`` over a
    CUDA tensor of times bitwise ``__call__`` on host floats; (c) the
    reference solver benchmark's path (f = y, a saturated exp(-y)
    diffusion, Ito or Stratonovich diagonal noise, 100 output times on
    [0, 1], dt 1/256, an explicit interval) by every ported fixed-step
    method at (128, 5) and (512, 256) (Milstein's grad_free option and
    log_ode on general noise at (128, 5) only), each on the noise (a)'s
    interval drew over the same grid (its query_grid's median is the
    solve's noise precompute, the loop timed alone): finite, against the
    CPU's solve (whole, on the CPU interval's noise, at (128, 5); the loop
    on the card's noise for 32 rows at (512, 256)); one backprop through
    the Euler and the midpoint solves against the CPU's gradient; an Euler
    solve on a fresh interval, its descent included, profiled (kernels
    launched, busy share) and bitwise the solve on (a)'s noise;
26. adjoint (no kernel: ``sdeint_adjoint`` is plain PyTorch, as the JAX
    package leaves it to XLA): the SDE-GAN train step at the reference
    widths with ``adjoint=True`` on the ``sdeint`` route (the
    reversible-Heun pair), its step-0 gradients within GAN_GRAD_REL of
    the fused route's (kernels 5-8) and of backprop through ``sdeint``;
    the flagship latent train step with ``adjoint=True`` (Euler forward
    on the 155-step interval grid, Milstein adjoint) against the CPU's on
    one table of draws at ADJ_CPU_ROWS rows (loss ADJ_LOSS_RTOL, gradients
    ADJ_GRAD_REL of scale), the same step with TF32 matmuls read beside
    it; each step timed and profiled beside the
    ``sdeint`` and fused routes'; the peak device memory of one latent
    step, adjoint against backprop, at each dt of ADJ_MEMORY_DTS; one
    ``rng_impl="philox"`` adjoint step whose backward's W is bitwise the
    forward's, kernel 16 launched once for each, the generator left as
    the forward left it;
27. adaptive (no kernel: the adaptive loop, in-loop noise and sparse
    outputs are plain PyTorch, as the JAX package leaves them to XLA; it
    needs no build): configuration A, the JAX package's
    benchmarks/adaptive_bench.py (ExDiagonal d 3 Ito with its float32
    mu and sigma, batch 1024, y0 0.1, 9 outputs on [0, 2], dt0 1e-3,
    rtol 1e-5, atol 1e-4, dt_min 1e-5, float32, a BrownianInterval keyed
    as PRNGKey(42) at 20 levels): (a) ``sdeint(adaptive=True)`` by srk
    and milstein, stats, ms, a profile (kernels, kernels an
    attempt, device ms, busy share), RMS against the exact solution, and
    the same-work fixed solve (dt = span / n_accepted, the same interval);
    (b) the same over [0, 0.5] (ADA_CHECK_TS) in float64 on the card and
    the CPU, whole batch, stats equal and ``ys`` within ADA_F64_REL of
    scale; (c) over [0, 0.5], d sum(ys)/d(y0, mu, sigma) in float64 by
    backprop through ``sdeint(adaptive=True)`` (its default budget; the
    iterations it ran),
    ``sdeint_adjoint(adaptive=True)`` and ``sdeint_adjoint(
    adjoint_adaptive=True)`` (ADA_ADJ_DT, ADA_ADJ_TOL), each within
    ADA_GRAD_REL of the CPU's, with ms, kernels and peak memory; (d) a
    backprop solve with ``max_steps=16`` (unreached outputs NaN,
    ``incomplete``) and a double backward with ``adjoint_max_steps=16``
    (NaN gradients); (e) configuration B, ExDiagonal Euler at (16384,
    128) float32 on [0, 1], dt 1/256, 5 outputs: the default policy makes
    the noise in the loop and keeps the bracketing states, its peak
    memory and ms against ``noise_precompute=True`` on the dense path (at
    least 3.5 GiB less), each y_T's channel means within 6 % of E y_T; an
    explicit interval queried in the loop bitwise its precomputed solve
    at (512, 256) over 100 steps; ``rng_impl="philox"`` in the loop
    warns; (f) adjoint gradients on the in-loop default stream against
    backprop through ``sdeint`` on the same stream, within 1e-3 of scale;
28. traced_ts (no kernel: traced ``ts`` is plain PyTorch; no build): a
    diagonal Ito SDE with a tanh MLP drift (batch 512, d 16, hidden 64,
    dt 1/100 on [0, 1], an explicit ``BrownianInterval``, entropy 28):
    (a) the values and the gradients to ``ts``, ``y0`` and the parameters
    of ``sdeint`` and ``sdeint_adjoint`` with a traced ``ts`` (a CUDA
    tensor that requires grad) in float64 on the card against the CPU,
    within TRACED_REL of scale; (b) schedules starting after the
    interval's ``t0`` or ending past its ``t1`` NaN on the card, values and
    gradients; (c) a float32 ``sdeint`` call with a CUDA ``ts``: an eager
    traced call under ``torch.cuda.set_sync_debug_mode("error")`` (no
    synchronising op), the whole call captured as a ``torch.cuda.CUDAGraph``,
    two other schedules copied into the captured ``ts`` and replayed, each
    bitwise an eager traced call on it, and one past ``t1`` NaN; replay
    and eager ms;
29. ddpm (no kernel: the U-Net, the score and the samplers are plain
    PyTorch; no build): the continuous DDPM at the reference scale of
    ``results/RESULTS.md`` section 2 (U-Net base 64, ch_mults (1, 2, 4),
    1x28x28 images, random weights from a seed): one train step's loss and
    gradients at batch 8 in float64 on the card against the CPU (within
    DDPM_REL of scale), and in float32 with and without cuDNN's TF32
    against that (recorded); then, under PyTorch's default TF32 setting,
    DDPM_STEPS Adam steps (lr 2e-4, batch 128) on seeded blobs of
    ``examples/cont_ddpm.py:105-112``, the loss on fixed draws lower after
    than before; 128 reverse-SDE samples (dt 1e-2, denoise_t 0.05, 95
    midpoint steps) and 4 probability-flow samples (100 RK4 steps),
    finite and of the right shape; step, sample and flow ms, images per
    second, peak memory, kernels a train step and a sampler step, busy
    share, each on a ``ddpm_*`` JSON line;
30. examples (kernels 1, 2 and 5-9 on the examples' own paths): each
    example's ``main`` in this process at its reference widths, for a
    short run: the sinusoid latent SDE (batch 512, 25 steps), Lorenz with
    ``--fused --no-adjoint`` (batch 256, default widths, 50 steps), the
    SDE-GAN with ``--fused`` (batch 1024, t-size 64, dataset 8192, 200
    steps, SWA from step 100), the DDPM on blobs at the reference U-Net
    (``--size 28 --base-ch 64 --ch-mults 1,2,4 --batch 128``, 60 steps,
    PyTorch's default cuDNN TF32) and the demo: every loss and sample
    finite, the loss lower at the end than at the start (sinusoid, Lorenz,
    DDPM), kernels 1 and 2 launched once a Lorenz step, 5-8 once a GAN
    step and 9 once in the demo, every JSONL and acceptance record strict
    JSON, the demo's captured solve bitwise its eager one; then Lorenz
    split at step 25 by ``--save`` and ``--restore``, and the GAN split at
    step 25 by ``utils/checkpoint.py``, each bitwise the run not split at
    step 50; each example's median step time;
31. diagnostics (no kernel; no build): ``diagnostics.run_all`` at its
    defaults (batch 4096, d 3, m 5, float64, dt 2^-1..2^-6 on [0, 2],
    dt_true 2^-11) on the card: every method's strong and weak slope of
    the eight combinations, none below its ``ORDER_BANDS`` minimum except
    where the JAX package's own slope on the same path is below it
    (DIAG_REFERENCE_MISSES), and there the port's slope must be that
    one.
32. mesh (kernels 1-4 inside the ranks; ``parallel/mesh.py`` adds no
    kernel): (1) ``make_mesh()`` with no arguments, a one-rank NCCL group
    on the card: a data-parallel fused flagship train step (SGD, lr
    MESH_LR) bitwise the plain fused step on the same generator seed,
    kernels 1 and 2 launched once, and its median time; (2) MESH_RANKS
    gloo ranks sharing the card (NCCL refuses two ranks on one device),
    started by ``mesh.run_ranks`` after this process built the kernels: a
    data-parallel fused flagship step on each rank's 512 rows and its rows
    of one table of draws, the loss and the averaged gradients against
    one process's full-batch step on the same draws (MESH_LOSS_RTOL,
    MESH_GRAD_REL), kernels 1 and 2 launched once in each rank, and
    MESH_STEPS timed steps (two ranks on one card: not a scaling figure);
    then K = 4 replicas sharded two to a rank, one SGD step on the
    K-replica fused route (kernels 3 and 4 once in each rank) against one
    process's K = 4 step; (3) a DP x TP step at the CPU tests' widths on a
    2 x 2 mesh of 4 gloo ranks on the card (the ``sdeint`` route): each
    rank's loss and the gradients of its shards against one process's,
    not scaled by the model axis. Multi-GPU NCCL and tensor parallelism
    over NVLink need more than one card and are not run.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. ``--only`` runs some phase groups (for
development; no ok line); ``--only tiles``, which no other run includes,
times kernels 13 (L1, L2) and 11 (R1, general noise) at the designs of
FWD_DESIGN_TILES beside the rule's, each bitwise the rule's, kernels 2
and 4 whole and their sweep alone at 128, 256 and 512 threads and at 16
rows a block, the blocks the sweep's was chosen over, and in bf16 at 8
and 16 rows a block with registers for one and for two blocks an SM,
kernels 1 and 3 at 256 and 512 threads and 8 and 16 rows a block, and
kernels 6, 7 and 8 at 1, 2, 4 and 8 warps a block; ``--only ab``
(phase_ab) times kernels 1-15 (6 and 7 also at the GPU tests' shapes; 15
in float32 and float64; 1-4 also in bf16, 2 and 4 by phase too) through
entry points every version of the port since PR 21 has and compares
their outputs with another run's, so
that a copy of this script in the parent commit's checkout times the
parent in the same call; ``--only steps`` (phase_steps), which builds
nothing, profiles the SDE-GAN train step on the ``sdeint`` route the same
way; ``--only srk_rounding`` (phase_srk_rounding) times bf16 kernel 15
with its rounding on the converter, in integer arithmetic and removed,
and counts the opcodes of each one's SASS. It imports nothing of JAX.
"""

import argparse
import contextlib
import copy
import ctypes
import functools
import json
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from torchsde_tpu_torch.models.latent_sde import (LatentSDE, latent_sde_loss,
                                                  make_lorenz_data)
from torchsde_tpu_torch.models.sde_gan import (Discriminator, Generator,
                                               gan_grads, gan_loss,
                                               get_ou_data)
from torchsde_tpu_torch.core import integrate as TI
from torchsde_tpu_torch.core import solvers as SOLVERS
from torchsde_tpu_torch.core.base_sde import ForwardSDE
from torchsde_tpu_torch.core import sdeint as TS_MOD
from torchsde_tpu_torch.core.adjoint import sdeint_adjoint
from torchsde_tpu_torch.core.sdeint import sdeint
from torchsde_tpu_torch.diagnostics.problems import ExDiagonal
from torchsde_tpu_torch.brownian import threefry as TF
from torchsde_tpu_torch.brownian.base import BaseBrownian
from torchsde_tpu_torch.brownian.interval import BrownianInterval
from torchsde_tpu_torch.diagnostics import run_all as DIAG
from torchsde_tpu_torch.examples import cont_ddpm as EX_DDPM
from torchsde_tpu_torch.examples import demo as EX_DEMO
from torchsde_tpu_torch.examples import latent_sde as EX_SINUSOID
from torchsde_tpu_torch.examples import latent_sde_lorenz as EX_LORENZ
from torchsde_tpu_torch.examples import sde_gan as EX_GAN
from torchsde_tpu_torch.models import cont_ddpm as DDPM
from torchsde_tpu_torch.models import latent_sde as TL
from torchsde_tpu_torch.models import unet as UNET
from torchsde_tpu_torch.models.latent_sde import latent_sde_loss_multi
from torchsde_tpu_torch.ops import _build
from torchsde_tpu_torch.ops import fused_solve as FS
from torchsde_tpu_torch.ops import gan_fused as GF
from torchsde_tpu_torch.ops import latent_fused as LF
from torchsde_tpu_torch.ops import prng as PR
from torchsde_tpu_torch.ops import srk_fused as SF
from torchsde_tpu_torch.parallel import mesh as PM
from torchsde_tpu_torch.parallel import replicas as RP
from torchsde_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

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
# Kernels 2 and 4 against a float64 run, per tensor: at most twice the
# plain version's distance plus BWD_F64_REL times the tensor's largest
# entry (25 float32 ulps of it), a floor for a tensor whose float32 plain
# version lands near float64 by chance; not the absolute 1e-4, which on a
# small tensor (dctx, scale 0.18) would be 1,700 times the plain version's
# distance. TF32 (about 1e-3 relative) exceeds it.
BWD_F64_REL = 3e-6
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
# Kernel 9's narrow solve: batch, d, hidden (E1's activations, diagonal
# noise, no time column).
EULER_NARROW = (256, 8, 16)
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
# times kernel 14 at, and kernel 13 in its 8-row streamed design (bit 0
# the drift, 1 the diffusion, 2 the prior; fused_solve.STAGE_ORDER): all
# three, drift and prior, none at L1; one or none at L2.
LOGQP_STAGINGS = {"L1": (7, 5, 0), "L2": (1, 0)}
# The ways of staging R1's two towers that phase 14 times kernel 12 at
# (both do not fit): the drift, the diffusion, none; and E1's, kernel 10's:
# both, the drift, the diffusion, none.
RH_STAGINGS = (1, 2, 0)
EULER_STAGINGS = (3, 1, 2, 0)
# K stacked flagship replicas (kernels 3 and 4, latent_sde_loss_multi): K 4
# for the checks, the serve and the training steps; the kernels timed at
# each K of MULTI_KS beside K launches of kernels 1 and 2.
MULTI_K, MULTI_KS = 4, (1, 2, 4, 8)
# latent_sde_loss_multi's served passes and Adam steps at K = MULTI_K (two
# of each, cut from three to keep the script within half its time limit;
# the multi group took 43.1 s on an H100 host, its sdeint step some
# 1.5-2.3 s).
MULTI_SERVE_SEEDS = (701, 702)
MULTI_STEPS = 2
# A replica of latent_sde_loss_multi(fused=True) against latent_sde_loss(
# fused=True) on a clone of its generator: the kernels are bitwise the same
# on the same inputs, but the multi route runs the encoder, qz0_net and the
# loss tail under vmap (batched products), which round in another order.
MULTI_LOSS_RTOL = 1e-5
# Step-0 gradients of latent_sde_loss_multi's two routes against a float64
# run on the same draws, per replica and parameter, atol this times the
# gradient's largest entry. The fused route runs encoder_proj under vmap,
# whose weight gradient is one batched float32 product summing T x B =
# 32,768 rows that largely cancel; it came 4.8e-5 of scale from float64
# where the replica-by-replica route's unbatched product came 6.4e-7
# (NVIDIA H100 80GB HBM3, 700 W; forward losses agree to 1e-7, so no TF32).
MULTI_GRAD_REL = 1e-4
# The srid2 solve (kernel 15) at the four configurations of the JAX
# package's benchmarks/srk_fused.py:85-86: (batch, d), 128 steps on [0, 1],
# ExDiagonal (f = mu y, g = sigma y; tests/problems.py:45-79) with mu and
# sigma from a numpy seed as its make_problem draws them, y0 = 0.1.
SRK_CONFIGS = ((1024, 8), (16384, 8), (1024, 128), (16384, 128))
SRK_STEPS = 128
# Kernel 15 vs its plain version: max abs error at most SRK_REL times the
# plain version's largest entry (the two round the same float32 stage
# arithmetic in another order, and nvcc contracts products into FMAs), and
# its distance from a float64 run at most twice the plain version's, plus
# one float32 ulp of the scale.
SRK_REL = 2e-5
# Operations of one element and step of the kernel, counted from
# srk_srid2.cuh with f = p0 * y and g = p1 * y (each multiply and add one).
SRID2_FLOPS = 114
# Kernel 15 in bf16 (phase_srk_bf16_kernel) against its bf16 plain version
# on the card, on the float32 phase's W, U and parameters rounded to bf16:
# bitwise, every element at every configuration (both do each operation in
# float32 and round it to bf16, the kernel with __fadd_rn and its kind,
# which nvcc does not contract, PyTorch one operation a kernel; the
# kernel's arithmetic compiled for the host matched the CPU plain version
# bit for bit). Its distance from float64 is printed and not held: an
# all-bf16 srid2 solve loses every increment under half an ulp.
SRK_BF16_DIFFERING = 0
# bf16 kernel 15 runs two elements a thread: at an odd D a pair straddles
# two rows, and an odd B D leaves the last thread one element; held to its
# twin bitwise there too.
SRK_ODD = (1023, 7)
# Its bf16x2 instructions (__hadd2_rn, __hsub2_rn, __hmul2_rn) and the pair
# type's four operators against float32 rounded to bf16 over all 2^32
# operand pairs (srk_fused.bf16x2_check), NaN as NaN: no difference at all.
SRK_BF16X2_DIFFS = 0
# Against sdeint(method='srk') in bf16 on the same tables, at (1024, 8):
# the two round differently (sdeint divides by its bf16 sqrt(dt) and forms
# dt as a difference of bf16 grid times), in the JAX package as in the
# port. JAX's own srk_solve_xla and sdeint at (1024, 8), 128 steps, bf16,
# on six numpy seeds of this law came 0.0197-0.0646 of scale apart (about
# 10 % of elements differing; CPU), so twice the largest (tests/
# test_torch_srk_bf16.py::test_chip_sdeint_bar_is_twice_jax_own_gap).
SRK_BF16_SDEINT_REL = 0.13
# Kernel 16 against its plain version, every element (both float32 Box-
# Muller on the same bits; logf and cosf differ from PyTorch's CPU and CUDA
# versions by an ulp or two, times r <= 5.9); the shapes (steps, batch, d)
# of the SRK configurations' narrow and widest noise.
PRNG_ATOL = 2e-6
PRNG_SHAPES = ((128, 1024, 9), (128, 16384, 128))
PRNG_LAW_DRAWS = 2 ** 20
# Published H100 SXM peaks (NVIDIA H100 datasheet, dense): float32 outside
# the tensor cores, bf16 on the tensor cores, and device memory.
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_S = 67e12, 989e12, 3.35e12


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


def bound(flops, tensors, peak=PEAK_F32_FLOPS):
    """The least time the card could take, in ms, and what bounds it: the
    larger of the operations at ``peak``, the card's rate for their
    operands' type (float32 unless given), and of the bytes moved (each
    input read once, each output written once) at the memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
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


def flagship_model(device, dtype=torch.float32):
    gen = torch.Generator().manual_seed(SEED)
    return LatentSDE(DATA, LATENT, CONTEXT, HIDDEN, dtype=dtype,
                     device=device, generator=gen)


def kernel_inputs(device, model, seed=SEED + 1, dt=DT):
    """Seeded solve inputs at the flagship shapes (steps of ``dt``), as the
    main path makes them: z0, ctx, ctx_idx, noise, dts."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ts = np.linspace(0.0, 1.0, N_TS)
    ctx = torch.randn((N_TS, BATCH, CONTEXT), generator=gen, device=device)
    view = model.contextualize(ts, ctx)
    z0 = torch.randn((BATCH, LATENT), generator=gen, device=device)
    with torch.no_grad():
        return LF._prep_solve(view, z0, ts, gen, dt)[:5]


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


def contraction_flops(M, L, C, H):
    """Operations of the contraction over M = n * B rows: two per
    multiply-add for the layer weights of f ((L+C)H + H^2 + HL) and h
    (LH + H^2 + HL), one per add for their biases' column sums (4H + 2L)."""
    return M * (2 * ((L + C) * H + 2 * H * H + 3 * H * L) + 4 * H + 2 * L)


def contraction_by_matmul(scratch, z_pre, ctx_rows, biases=True):
    """The contraction's products as PyTorch calls on the same scratch
    tensors (the yardstick, never on the path): seven torch.matmul, or with
    a leading replica axis seven torch.bmm, and six bias sums over the rows
    (``biases``; in mixed mode the sweep sums them, so the yardstick has
    none)."""
    a1f, a1h, a2f, a2h, dp1f, dp1h, dp2f, dp2h, df, dh = scratch

    def mm(a, b):
        return (torch.bmm(a.transpose(1, 2), b) if a.ndim == 3
                else torch.matmul(a.T, b))

    return (mm(z_pre, dp1f), mm(ctx_rows, dp1f), mm(a1f, dp2f), mm(a2f, df),
            mm(z_pre, dp1h), mm(a1h, dp2h), mm(a2h, dh),
            *(t.sum(-2) for t in ((dp1f, dp2f, df, dp1h, dp2h, dh)
                                  if biases else ())))


def backward_parts(label, bargs, multi, reps):
    """Median device times of kernel 2 (or 4)'s sweep alone and of its
    contraction and reduction alone on the sweep's workspace, with the
    contraction's bound (bf16 operations at the bf16 peak in mixed mode),
    and its yardstick on the same scratch tensors, made before timing:
    torch.matmul for K = 1, torch.bmm over the replicas for K > 1, in the
    scratch's dtype. Prints them with the workspace's bytes, and the
    sweep's shared memory a block (in mixed mode also its blocks an
    SM)."""
    z0, ctx, ctx_idx, noise, dts, weights, zs = bargs[:7]
    K = z0.shape[0] if multi else 1
    B, L = z0.shape[-2:]
    C, H, n = ctx.shape[-1], weights[0].shape[-1], noise.shape[-3]
    dtype = weights[0].dtype
    mixed = dtype == BF16
    _, ws = LF._backward_cuda(*bargs, multi=multi)

    def run(stages):
        return lambda: LF._backward_cuda(*bargs, multi=multi, stages=stages,
                                         workspace=ws)

    sweep = median_cuda_ms(run(1), reps)
    contraction = median_cuda_ms(run(2), reps)
    M = n * B
    scratch_bytes = (2 if mixed else 4) * K * M * (8 * H + 2 * L)
    out = dict(sweep_ms=sweep, contraction_ms=contraction,
               scratch_bytes=scratch_bytes,
               workspace_bytes=ws.numel() * ws.element_size())
    flops_c = K * contraction_flops(M, L, C, H)
    views = LF.scratch_views(ws, B, L, H, n, dtype)
    # Reads the scratch, ctx, z0 and zs; writes the towers' gradients (the
    # sizes of weights 0-11).
    bound_c = bound(flops_c, [*views, ctx, z0, zs, *weights[:12]],
                    PEAK_BF16_FLOPS if mixed else PEAK_F32_FLOPS)
    out.update(contraction_bound_ms=bound_c[0],
               contraction_bound_by=bound_c[1])
    scratch = [v[0] for v in views] if not multi else list(views)
    z_pre = torch.cat([z0[..., None, :, :], zs[..., :-1, :, :].to(z0.dtype)],
                      dim=-3).reshape(*z0.shape[:-2], M, L).to(dtype)
    ctx_rows = ctx[..., ctx_idx.long(), :, :].reshape(
        *z0.shape[:-2], M, C).to(dtype)
    key = "contraction_bmm_ms" if multi else "contraction_matmul_ms"
    out[key] = median_cuda_ms(lambda: contraction_by_matmul(
        scratch, z_pre, ctx_rows, biases=not mixed), reps)
    del scratch, z_pre, ctx_rows
    lib = _build.load_library()
    smem = (lib.tsde_latent_fused_bwd_smem_bytes_bf16 if mixed
            else lib.tsde_latent_fused_bwd_smem_bytes)(L, C, H)
    out["sweep_smem_bytes"] = smem
    line = f"sweep shared memory {smem} bytes a block"
    if mixed:
        out["sweep_blocks_per_sm"] = \
            lib.tsde_latent_fused_bwd_blocks_per_sm_bf16(
                L, C, H, K * -(-B // 8), z0.device.index or 0)
        line += f", {out['sweep_blocks_per_sm']} blocks an SM"
    print(f"{label}: sweep {sweep:.4f} ms; contraction and reduction "
          f"{contraction:.4f} ms (bound {bound_c[0]:.4f}, {bound_c[1]}); "
          f"{'torch.bmm' if multi else 'torch.matmul'} yardstick on the same "
          f"scratch ({str(dtype).split('.')[-1]}) {out[key]:.4f} ms",
          flush=True)
    print(f"{label}: scratch {scratch_bytes / 1e6:.1f} MB, workspace "
          f"{out['workspace_bytes'] / 1e6:.1f} MB; {line}", flush=True)
    return out


# The sweep's blocks, (threads, rows a block), that ``--only tiles`` times:
# the kernel's own (256, 8) and the ones it was chosen over. They are built
# into a library of their own from latent_fused_bwd.cu and TILE_ENTRY, not
# into the kernels' library.
SWEEP_TILES = ((128, 8), (256, 8), (512, 8), (256, 16))
# The bf16 sweep's blocks that ``--only tiles`` times, (blocks an SM that
# ptxas budgets registers for, rows a block) at 256 threads: the kernel's
# own (2, 8) first.
BF16_SWEEP_TILES = ((2, 8), (1, 8), (2, 16), (1, 16))
TILE_ENTRY = r"""
// Kernel 2 (K = 1) or 4 with the sweep at `threads` threads and `rows`
// rows a block, the phases as tsde_latent_fused_bwd_stages.
extern "C" int tsde_latent_bwd_tile(
    const float* z0, const float* ctx, const int* ctx_idx, const float* noise,
    const float* dts, TSDE_WEIGHT_PARAMS, const float* zs, const float* gz,
    const float* gq, float* dz0, float* dctx, float* dnoise, float* ws,
    float* dw, int K, int B, int L, int C, int H, int T, int n, int threads,
    int rows, int stages, int device, cudaStream_t stream) {
  using namespace tsde_latent_bwd;
  const float* w[NW] = TSDE_WEIGHTS;
  const Args a = make_args(z0, ctx, ctx_idx, noise, dts, w, zs, gz, gq, dz0,
                           dctx, dnoise, ws, B, L, C, H, T, n);
  if (rows == 8 && threads == 128)
    return launch<128, 8>(a, K, dw, stages, n, device, stream);
  if (rows == 8 && threads == 256)
    return launch<256, 8>(a, K, dw, stages, n, device, stream);
  if (rows == 8 && threads == 512)
    return launch<512, 8>(a, K, dw, stages, n, device, stream);
  if (rows == 16 && threads == 256)
    return launch<256, 16>(a, K, dw, stages, n, device, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same in mixed mode, the bf16 sweep at 256 threads, `rows` rows a
// block and ptxas's registers for `minb` blocks an SM.
extern "C" int tsde_latent_bwd_tile_bf16(
    const float* z0, const __nv_bfloat16* ctx, const int* ctx_idx,
    const __nv_bfloat16* noise, const float* dts,
    TSDE_WEIGHT_PARAMS_T(__nv_bfloat16), const __nv_bfloat16* zs,
    const __nv_bfloat16* gz, const float* gq, float* dz0, float* dctx,
    __nv_bfloat16* dnoise, float* ws, float* dw, int K, int B, int L, int C,
    int H, int T, int n, int minb, int rows, int stages, int device,
    cudaStream_t stream) {
  using namespace tsde_latent_bwd;
  using bf = __nv_bfloat16;
  const bf* w[NW] = TSDE_WEIGHTS;
  const auto a = make_args(z0, ctx, ctx_idx, noise, dts, w, zs, gz, gq, dz0,
                           dctx, dnoise, ws, B, L, C, H, T, n);
  if (rows == 8 && minb == 2)
    return launch<256, 8, bf, 2>(a, K, dw, stages, n, device, stream);
  if (rows == 8 && minb == 1)
    return launch<256, 8, bf, 1>(a, K, dw, stages, n, device, stream);
  if (rows == 16 && minb == 2)
    return launch<256, 16, bf, 2>(a, K, dw, stages, n, device, stream);
  if (rows == 16 && minb == 1)
    return launch<256, 16, bf, 1>(a, K, dw, stages, n, device, stream);
  if (rows == 8 && minb == 0)
    return launch<256, 8, bf, 0>(a, K, dw, stages, n, device, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tsde_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


# The forward's blocks, (threads, rows a block), that ``--only tiles``
# times kernels 1 and 3 at: the kernel picks 256 threads and 8 rows, or 16
# when 8-row blocks would outnumber the SMs (latent_fused_fwd.cu:
# rows_for). Built from latent_fused_fwd.cu and FWD_TILE_ENTRY.
FWD_TILES = ((256, 8), (512, 8), (512, 16), (1024, 8), (1024, 16))
FWD_TILE_ENTRY = r"""
// Kernel 1 (K = 1) or 3 at `threads` threads and `rows` rows a block.
extern "C" int tsde_latent_fwd_tile(
    const float* z0, const float* ctx, const int* ctx_idx, const float* noise,
    const float* dts, TSDE_WEIGHT_PARAMS, float* zs, float* qs, int K, int B,
    int L, int C, int H, int T, int n, int threads, int rows, int device,
    cudaStream_t stream) {
  using namespace tsde_latent_fwd;
  const float* w[NW] = TSDE_WEIGHTS;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a = make_args(z0, ctx, ctx_idx, noise, dts, w, zs, qs, B, L, C,
                           H, T, n);
  if (threads == 256 && rows == 8) return launch_rows<256, 8>(a, K, stream);
  if (threads == 512 && rows == 8) return launch_rows<512, 8>(a, K, stream);
  if (threads == 512 && rows == 16) return launch_rows<512, 16>(a, K, stream);
  if (threads == 1024 && rows == 8) return launch_rows<1024, 8>(a, K, stream);
  if (threads == 1024 && rows == 16)
    return launch_rows<1024, 16>(a, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 1 or 3 in bf16 mixed mode at `threads` threads, `rows` rows a
// block and ptxas's registers for `minb` blocks an SM (the flagship's
// towers: 2 m-tiles a warp at 256 threads, 1 at 512).
extern "C" int tsde_latent_fwd_tile_bf16(
    const float* z0, const __nv_bfloat16* ctx, const int* ctx_idx,
    const __nv_bfloat16* noise, const float* dts,
    TSDE_WEIGHT_PARAMS_T(__nv_bfloat16), __nv_bfloat16* zs, float* qs, int K,
    int B, int L, int C, int H, int T, int n, int threads, int rows, int minb,
    int device, cudaStream_t stream) {
  using namespace tsde_latent_fwd;
  const __nv_bfloat16* w[NW] = TSDE_WEIGHTS;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto a = make_args(z0, ctx, ctx_idx, noise, dts, w, zs, qs, B, L, C,
                           H, T, n);
#define TSDE_TILE(NT, R, MPW, MINB)                                      \
  if (threads == NT && rows == R && minb == MINB)                        \
    return launch_bf16_mpw<NT, R, MPW, MINB>(a, K, stream, false);
  TSDE_TILE(256, 8, 2, 1)
  TSDE_TILE(256, 8, 2, 2)
  TSDE_TILE(256, 16, 2, 2)
  TSDE_TILE(256, 16, 2, 1)
  TSDE_TILE(512, 8, 1, 1)
  TSDE_TILE(512, 16, 1, 1)
  TSDE_TILE(512, 16, 1, 2)
#undef TSDE_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
"""
# The bf16 forward's blocks that ``--only tiles`` times kernels 1 and 3 at,
# (threads, rows a block, blocks an SM that ptxas budgets registers for),
# in FWD_TILE_ENTRY's instantiations; the kernel's choices are (512, 8, 1),
# (512, 16, 1) and (256, 16, 2) (latent_fused_fwd.cu: bf16_design), and
# every block gives the same bits.
FWD_BF16_TILES = ((512, 8, 1), (512, 16, 1), (256, 16, 2), (256, 8, 1),
                  (256, 8, 2), (256, 16, 1), (512, 16, 2))


def fwd_tile_library():
    """The library of the forward's blocks, built at its first use."""
    source = (Path(LF.__file__).resolve().parent / "csrc"
              / "latent_fused_fwd.cu").read_text()
    lib = _build.library_for_source("tsde_latent_fwd_tiles",
                                    source + FWD_TILE_ENTRY)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tsde_latent_fwd_tile.argtypes = [P] * 23 + [I] * 10 + [P]
    lib.tsde_latent_fwd_tile.restype = I
    lib.tsde_latent_fwd_tile_bf16.argtypes = [P] * 23 + [I] * 11 + [P]
    lib.tsde_latent_fwd_tile_bf16.restype = I
    return lib


def fwd_tile_times(label, lib, args, weights, multi, reps):
    """Median device times of kernel 1 (or 3) at each of FWD_TILES, each
    block's zs and qs bitwise the kernel's own."""
    want = (LF.fused_solve_multi_forward_cuda if multi
            else LF.fused_solve_forward_cuda)(*args, weights)
    z0, ctx, ctx_idx, noise, dts = args
    K = z0.shape[0] if multi else 1
    B, L = z0.shape[-2:]
    T, C, H, n = ctx.shape[-3], ctx.shape[-1], weights[0].shape[-1], \
        noise.shape[-3]
    zs, qs = torch.empty_like(want[0]), torch.empty_like(want[1])
    ptrs = [t.data_ptr() for t in (*args, *weights, zs, qs)]
    stream = torch.cuda.current_stream(z0.device).cuda_stream
    out = {}
    for threads, rows in FWD_TILES:
        def run():
            rc = lib.tsde_latent_fwd_tile(*ptrs, K, B, L, C, H, T, n,
                                          threads, rows,
                                          z0.device.index or 0, stream)
            _build.check_launch(lib, rc, f"forward {threads} x {rows}")
        run()
        torch.cuda.synchronize()
        if not (torch.equal(zs, want[0]) and torch.equal(qs, want[1])):
            raise RuntimeError(f"{label} at {threads} x {rows} differs from "
                               f"the kernel's own")
        out[f"{threads}x{rows}"] = median_cuda_ms(run, reps)
    print(f"{label} by threads x rows a block, ms: "
          + ", ".join(f"{k}: {v:.4f}" for k, v in out.items()), flush=True)
    return out


def fwd_bf16_tile_times(label, lib, args, weights, multi, reps):
    """Median device times of bf16 kernel 1 (or 3) at each of
    FWD_BF16_TILES, each block's zs and qs bitwise the kernel's own."""
    want = (LF.fused_solve_multi_forward_cuda if multi
            else LF.fused_solve_forward_cuda)(*args, weights)
    z0, ctx, ctx_idx, noise, dts = args
    K = z0.shape[0] if multi else 1
    B, L = z0.shape[-2:]
    T, C, H, n = ctx.shape[-3], ctx.shape[-1], weights[0].shape[-1], \
        noise.shape[-3]
    zs, qs = torch.empty_like(want[0]), torch.empty_like(want[1])
    ptrs = [t.data_ptr() for t in (*args, *weights, zs, qs)]
    stream = torch.cuda.current_stream(z0.device).cuda_stream
    out = {}
    for threads, rows, minb in FWD_BF16_TILES:
        def run():
            rc = lib.tsde_latent_fwd_tile_bf16(*ptrs, K, B, L, C, H, T, n,
                                               threads, rows, minb,
                                               z0.device.index or 0, stream)
            _build.check_launch(lib, rc, f"bf16 forward {threads} x {rows} "
                                f"x {minb}")
        run()
        torch.cuda.synchronize()
        key = f"{threads}x{rows}x{minb}"
        if not (torch.equal(zs, want[0]) and torch.equal(qs, want[1])):
            raise RuntimeError(f"{label} at {key} differs from the kernel's "
                               f"own")
        out[key] = median_cuda_ms(run, reps)
    print(f"{label} by threads x rows x blocks an SM, ms: "
          + ", ".join(f"{k}: {v:.4g}" for k, v in out.items()), flush=True)
    return out


# The stages of the bf16 sweep whose clocks ``--only tiles`` reads
# (latent_fused_bwd.cu: TSDE_MARK), in order.
SWEEP_STAGES = ("B layer 1, g nets", "C layer 2, layer 3", "E cotangents",
                "F dpre2, g nets back", "G dpre1", "H dx, flush, inputs",
                "I dz")
CLOCK_ENTRY = r"""
extern "C" int tsde_stage_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(
      out, tsde_latent_bwd::tsde_stage_clocks, 8 * sizeof(unsigned long long));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[8] = {};
    err = cudaMemcpyToSymbol(tsde_latent_bwd::tsde_stage_clocks, zero,
                             sizeof(zero));
  }
  return static_cast<int>(err);
}
"""


# The stages of the bf16 forward whose clocks ``--only tiles`` reads
# (latent_fused_fwd.cu: TSDE_MARK), in order.
FWD_STAGES = ("A layer 1", "A g nets", "B layer 2, layer 3", "C update")
FWD_CLOCK_ENTRY = CLOCK_ENTRY.replace("tsde_latent_bwd::", "tsde_latent_fwd::")


def fwd_stage_clocks(label, args, weights, multi):
    """The bf16 forward's clock cycles a step and block in each of
    FWD_STAGES (thread 0's, barrier waits included), at the kernel's own
    block (its source built with TSDE_STAGE_CLOCKS into a library of its
    own), and its SM clock by nvidia-smi."""
    source = (Path(LF.__file__).resolve().parent / "csrc"
              / "latent_fused_fwd.cu").read_text()
    lib = _build.library_for_source(
        "tsde_latent_fwd_clocks",
        "#define TSDE_STAGE_CLOCKS\n" + source + FWD_TILE_ENTRY
        + FWD_CLOCK_ENTRY)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tsde_latent_fwd_tile_bf16.argtypes = [P] * 23 + [I] * 11 + [P]
    lib.tsde_latent_fwd_tile_bf16.restype = I
    lib.tsde_stage_clocks.argtypes = [P, I]
    clocks = (ctypes.c_ulonglong * 8)()
    z0, ctx, ctx_idx, noise, dts = args
    K = z0.shape[0] if multi else 1
    B, L = z0.shape[-2:]
    T, C, H, n = ctx.shape[-3], ctx.shape[-1], weights[0].shape[-1], \
        noise.shape[-3]
    rows, threads, minb = fwd_bf16_design(K, B)
    zs = torch.empty((K, n, B, L), dtype=BF16, device=z0.device)
    qs = torch.empty((K, n, B, 1), device=z0.device)
    ptrs = [t.data_ptr() for t in (*args, *weights, zs, qs)]
    for _ in range(2):
        lib.tsde_stage_clocks(clocks, 1)
        rc = lib.tsde_latent_fwd_tile_bf16(
            *ptrs, K, B, L, C, H, T, n, threads, rows, minb,
            z0.device.index or 0,
            torch.cuda.current_stream(z0.device).cuda_stream)
        _build.check_launch(lib, rc, "bf16 forward with stage clocks")
        torch.cuda.synchronize()
    lib.tsde_stage_clocks(clocks, 1)
    blocks = K * -(-B // rows)
    out = {name: clocks[i] / (blocks * n)
           for i, name in enumerate(FWD_STAGES)}
    out["rows"], out["threads"], out["minb"] = rows, threads, minb
    out["sm_clock_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{label}: bf16 forward cycles a step and block by stage: "
          + json.dumps(out), flush=True)
    return out


def fwd_bf16_design(K, B, sms=132):
    """latent_fused_fwd.cu:bf16_design on an H100's SMs: rows a block,
    threads, and the blocks an SM ptxas budgets registers for."""
    if K * -(-B // 8) <= sms:
        return 8, 512, 1
    return (16, 512, 1) if K * -(-B // 16) <= sms else (16, 256, 2)


def sweep_stage_clocks(label, bargs, multi):
    """The bf16 sweep's clock cycles a step and block in each of
    SWEEP_STAGES (thread 0's, barrier waits included; the kernel's own
    source built with TSDE_STAGE_CLOCKS into a library of its own), and
    its SM clock by nvidia-smi."""
    source = (Path(LF.__file__).resolve().parent / "csrc"
              / "latent_fused_bwd.cu").read_text()
    lib = _build.library_for_source(
        "tsde_latent_bwd_clocks",
        "#define TSDE_STAGE_CLOCKS\n" + source + TILE_ENTRY + CLOCK_ENTRY)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tsde_latent_bwd_tile_bf16.argtypes = [P] * 29 + [I] * 11 + [P]
    lib.tsde_latent_bwd_tile_bf16.restype = I
    lib.tsde_stage_clocks.argtypes = [P, I]
    clocks = (ctypes.c_ulonglong * 8)()
    _, ws = LF._backward_cuda(*bargs, multi=multi)
    z0, noise = bargs[0], bargs[3]
    K = z0.shape[0] if multi else 1
    blocks, n = K * -(-z0.shape[-2] // 8), noise.shape[-3]
    tile_backward(lib, bargs, multi, 0, 8, 1, ws)
    torch.cuda.synchronize()
    lib.tsde_stage_clocks(clocks, 1)
    tile_backward(lib, bargs, multi, 0, 8, 1, ws)
    torch.cuda.synchronize()
    lib.tsde_stage_clocks(clocks, 1)
    out = {name: clocks[i] / (blocks * n)
           for i, name in enumerate(SWEEP_STAGES)}
    out["sm_clock_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{label}: bf16 sweep cycles a step and block by stage: "
          + json.dumps(out), flush=True)
    return out


def tile_library():
    """The library of the sweep's tiles, built at its first use."""
    source = (Path(LF.__file__).resolve().parent / "csrc"
              / "latent_fused_bwd.cu").read_text()
    lib = _build.library_for_source("tsde_latent_bwd_tiles",
                                    source + TILE_ENTRY)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("tsde_latent_bwd_tile", "tsde_latent_bwd_tile_bf16"):
        getattr(lib, name).argtypes = [P] * 29 + [I] * 11 + [P]
        getattr(lib, name).restype = I
    return lib


def tile_backward(lib, bargs, multi, threads, rows, stages, ws):
    """One call of tsde_latent_bwd_tile (tsde_latent_bwd_tile_bf16 for bf16
    weights, ``threads`` then the blocks an SM) on a backward kernel's
    inputs and workspace ``ws`` (from LF._backward_cuda); returns dz0,
    dctx, dnoise and the weights' gradients back to back (dctx and the
    gradients float32)."""
    z0, ctx, ctx_idx, noise, dts, weights, zs, gz, gq = bargs
    K = z0.shape[0] if multi else 1
    B, L = z0.shape[-2:]
    T, C, H, n = ctx.shape[-3], ctx.shape[-1], weights[0].shape[-1], \
        noise.shape[-3]
    entry = (lib.tsde_latent_bwd_tile_bf16 if weights[0].dtype == BF16
             else lib.tsde_latent_bwd_tile)
    dz0 = torch.zeros_like(z0)
    dctx = torch.zeros_like(ctx, dtype=torch.float32)
    dnoise = torch.empty_like(noise)
    dw = torch.zeros((K, sum(w[0].numel() if multi else w.numel()
                             for w in weights)), device=z0.device)
    ptrs = [t.data_ptr() for t in (z0, ctx, ctx_idx, noise, dts, *weights,
                                   zs, gz, gq, dz0, dctx, dnoise, ws, dw)]
    rc = entry(
        *ptrs, K, B, L, C, H, T, n, threads, rows, stages,
        z0.device.index or 0, torch.cuda.current_stream(z0.device).cuda_stream)
    _build.check_launch(lib, rc, f"sweep tile {threads} x {rows}")
    return dz0, dctx, dnoise, dw


def tile_times(label, lib, bargs, multi, reps):
    """Median device times of the whole kernel and of its sweep alone at
    each of SWEEP_TILES (BF16_SWEEP_TILES for bf16 weights); each tile's
    outputs, in the kernel's dtypes, held to the kernel's own at kernel 2's
    tolerance (BF16_REL of scale in bf16)."""
    (dz0, dctx, dnoise, dweights), ws = LF._backward_cuda(*bargs,
                                                          multi=multi)
    lead = 1 if multi else 0
    want = [dz0, dctx, dnoise, torch.cat([d.flatten(lead) for d in dweights],
                                         dim=-1)]
    mixed = dnoise.dtype == BF16
    out = {}
    for threads, rows in BF16_SWEEP_TILES if mixed else SWEEP_TILES:
        got = tile_backward(lib, bargs, multi, threads, rows, 3, ws)
        torch.cuda.synchronize()
        for name, g, w in zip(("dz0", "dctx", "dnoise", "weights"), got,
                              want):
            g = g.reshape(w.shape).to(w.dtype).float()
            w = w.float()
            scale = float(w.abs().max())
            err = float((g - w).abs().max())
            bar = BF16_REL * scale if mixed else max(BWD_ATOL,
                                                     BWD_REL * scale)
            if not torch.isfinite(g).all() or err > bar:
                raise RuntimeError(f"{label} at {threads} x {rows}: {name} "
                                   f"differs from the kernel's by {err:.3e}")
        whole = median_cuda_ms(lambda: tile_backward(
            lib, bargs, multi, threads, rows, 3, ws), reps)
        sweep = median_cuda_ms(lambda: tile_backward(
            lib, bargs, multi, threads, rows, 1, ws), reps)
        out[f"{threads}x{rows}"] = dict(ms=whole, sweep_ms=sweep)
    cells = ", ".join(f"{k}: {v['ms']:.4f} (sweep {v['sweep_ms']:.4f})"
                      for k, v in out.items())
    print(f"{label} by sweep {'blocks an SM' if mixed else 'threads'} x "
          f"rows a block, ms: {cells}", flush=True)
    return out


def phase_tiles(device):
    """Kernel 2 at the flagship and kernel 4 at K = MULTI_K, whole and sweep
    alone, at each block of SWEEP_TILES, and in bf16 mixed mode at each of
    BF16_SWEEP_TILES; kernels 1 and 3 at K = 1, 2, MULTI_K and 8 at each
    block of FWD_TILES, and in bf16 at each of FWD_BF16_TILES (``--only
    tiles``)."""
    fwd_lib = fwd_tile_library()
    forward = {}
    with torch.no_grad():
        for Kt in MULTI_KS:
            a_t, w_t = multi_kernel_inputs(device, Kt)
            forward[str(Kt)] = fwd_tile_times(f"kernel 3 at K={Kt}", fwd_lib,
                                              a_t, w_t, True, 10)
            if Kt == 1:
                a_1, w_1 = replica(a_t, w_t, 0)
                forward["kernel1"] = fwd_tile_times("kernel 1", fwd_lib, a_1,
                                                    w_1, False, 10)
            del a_t, w_t
            a_t, w_t = multi_kernel_inputs(device, Kt, dtype=BF16)
            forward[f"bf16_{Kt}"] = fwd_bf16_tile_times(
                f"kernel 3 (bf16) at K={Kt}", fwd_lib, a_t, w_t, True, 10)
            forward[f"bf16_{Kt}"]["stage_clocks"] = fwd_stage_clocks(
                f"kernel 3 (bf16) at K={Kt}", a_t, w_t, True)
            if Kt == 1:
                a_1, w_1 = replica(a_t, w_t, 0)
                forward["kernel1_bf16"] = fwd_bf16_tile_times(
                    "kernel 1 (bf16)", fwd_lib, a_1, w_1, False, 10)
            del a_t, w_t
    lib = tile_library()
    model = flagship_model(device)
    args = kernel_inputs(device, model)
    n = args[3].shape[0]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    gz = torch.randn((n, BATCH, LATENT), generator=gen, device=device)
    gq = torch.randn((n, BATCH, 1), generator=gen, device=device)
    with torch.no_grad():
        weights = LF.solve_weights(model)
        zs, _ = LF.fused_solve_forward_cuda(*args, weights)
        single = tile_times("kernel 2", lib, (*args, weights, zs, gz, gq),
                            False, 10)
        del zs
        args, weights = multi_kernel_inputs(device, MULTI_K)
        zs = LF.fused_solve_multi_forward_cuda(*args, weights)[0]
        multi = tile_times(
            f"kernel 4 at K={MULTI_K}", lib,
            (*args, weights, zs, gz.expand(MULTI_K, -1, -1, -1).contiguous(),
             gq.expand(MULTI_K, -1, -1, -1).contiguous()), True, 5)
        del args, weights, zs
        # Mixed mode: the bf16 sweep's blocks.
        model16 = flagship_model(device, BF16)
        a16 = kernel_inputs(device, model16)
        w16 = LF.solve_weights(model16)
        zs = LF.fused_solve_forward_cuda(*a16, w16)[0]
        b16 = (*a16, w16, zs, gz.to(BF16), gq)
        single16 = tile_times("kernel 2 (bf16)", lib, b16, False, 10)
        single16["stage_clocks"] = sweep_stage_clocks("kernel 2 (bf16)", b16,
                                                      False)
        del a16, w16, zs, b16
        args, weights = multi_kernel_inputs(device, MULTI_K, dtype=BF16)
        zs = LF.fused_solve_multi_forward_cuda(*args, weights)[0]
        b16 = (*args, weights, zs,
               gz.to(BF16).expand(MULTI_K, -1, -1, -1).contiguous(),
               gq.expand(MULTI_K, -1, -1, -1).contiguous())
        multi16 = tile_times(f"kernel 4 (bf16) at K={MULTI_K}", lib, b16,
                             True, 5)
        multi16["stage_clocks"] = sweep_stage_clocks(
            f"kernel 4 (bf16) at K={MULTI_K}", b16, True)
    return dict(kernel2=single, kernel4=multi, kernel2_bf16=single16,
                kernel4_bf16=multi16, forward=forward)


# The designs (cluster, rows, threads, staged towers) of kernels 13 and 11
# that ``--only tiles`` times beside the rule's own (fused_solve.
# forward_design): rows x threads of a block holding every tower, clusters
# of a tower a block, and the 8-row design with the towers streamed from L2
# as the earlier kernels ran it; kernel 11's kernel-1-style block (512
# threads, 8 rows, the drift staged).
FWD_DESIGN_TILES = {
    "kernel13_L1": ((1, 16, 384, 7), (1, 16, 768, 7), (1, 32, 384, 7),
                    (1, 32, 768, 7), (1, 8, 768, 7), (1, 8, 384, 0)),
    "kernel13_L2": ((3, 32, 512, 7), (3, 32, 256, 7), (3, 16, 512, 7),
                    (1, 8, 384, 1), (1, 8, 768, 1)),
    "kernel11_R1": ((2, 16, 512, 3), (2, 16, 256, 3), (2, 16, 768, 3),
                    (1, 8, 512, 1), (1, 8, 256, 1), (1, 16, 512, 1)),
    "kernel11_general": ((1, 8, 512, 3), (1, 8, 256, 3), (1, 16, 512, 3),
                         (1, 8, 768, 3), (1, 8, 256, 1)),
    "kernel13_small": ((1, 8, 768, 7), (1, 8, 384, 7), (1, 16, 384, 7),
                       (1, 8, 384, 0)),
}


def phase_fwd_tiles(device):
    """Kernels 13 (L1, L2) and 11 (R1, general noise with time) at each
    design of FWD_DESIGN_TILES: outputs bitwise those of the rule's design,
    median device times (``--only tiles``)."""
    out = {}
    with torch.no_grad():
        inputs = [(f"kernel11_{k}", FS.RH_FWD, FS.rh_solve_forward_cuda, a)
                  for k, a in ab_rh_inputs(device)]
        inputs += [(f"kernel13_{k}", FS.EULER_LOGQP_FWD,
                    FS.euler_logqp_solve_forward_cuda, a)
                   for k, a in ab_logqp_inputs(device)]
        for label, kind, launch, args in inputs:
            spec, B = args[-1], args[0].shape[0]
            rule = FS.forward_design(kind, spec, B, FS._sm_count(device))
            clusters = getattr(_build.load_library(), "tsde_tower_"
                               + launch.__name__[:-len("_solve_forward_cuda")]
                               + "_fwd_clusters")
            resident = {}
            for design in map(FS.FwdDesign._make, FWD_DESIGN_TILES[label]):
                smem = FS.fwd_smem_bytes(kind, spec, design.stage,
                                         design.rows, design.cluster)
                if smem <= _build.MAX_SMEM_BYTES:
                    resident[str(tuple(design))] = clusters(
                        design.threads, smem, design.cluster)
            print(f"{label}: clusters (or blocks) resident at once: "
                  f"{resident}", flush=True)
            want = launch(*args)
            cells = {"rule": tuple(rule),
                     str(tuple(rule)): median_cuda_ms(lambda: launch(*args),
                                                      10)}
            for design in map(FS.FwdDesign._make, FWD_DESIGN_TILES[label]):
                if design == rule:
                    continue
                if FS.fwd_smem_bytes(kind, spec, design.stage, design.rows,
                                     design.cluster) > _build.MAX_SMEM_BYTES:
                    cells[str(tuple(design))] = "does not fit"
                    continue
                got = launch(*args, design=design)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(f"{label} at {tuple(design)} differs "
                                       f"from the rule's design")
                cells[str(tuple(design))] = median_cuda_ms(
                    lambda: launch(*args, design=design), 10)
            print(f"{label} by (cluster, rows, threads, staged), ms; bitwise "
                  f"the rule's {tuple(rule)}: "
                  + ", ".join(f"{k}: {v}" for k, v in cells.items()
                              if k != "rule"), flush=True)
            out[label] = cells
    return out


def ab_euler_inputs(device):
    """Kernel 9's inputs at E1, on general noise with time (phase 14's)
    and at the narrow solve (batch 256, d 8, hidden 16, diagonal noise),
    labelled."""
    method, B, d, (drift, diffusion) = tower_config(device, "E1")
    yield "E1", tower_kernel_args(device, method, drift, diffusion, B, d, d,
                                  True, False, SEED + 12)[1]
    B, d, m, hidden = TOWER_GENERAL
    drift = tower_spec(SEED + 13, [d + 1, hidden, hidden, d],
                       ("softplus", "tanh", "linear"), device)
    diffusion = tower_spec(SEED + 14, [d + 1, hidden, hidden, d * m],
                           ("lipswish", "softplus", "sigmoid"), device)
    yield "general", tower_kernel_args(device, "euler", drift, diffusion, B,
                                       d, m, False, True, SEED + 15)[1]
    B, d, hidden = EULER_NARROW
    drift = tower_spec(SEED + 16, [d, hidden, d], TOWER_FACTS, device)
    diffusion = tower_spec(SEED + 17, [d, hidden, d], TOWER_GACTS, device)
    yield "small", tower_kernel_args(device, "euler", drift, diffusion, B, d,
                                     d, True, False, SEED + 18)[1]


# Kernel 9's designs (3xTF32 or FMA tiles, rows, threads, staged towers)
# that ``--only tiles`` times beside the rule's: the 3xTF32 tiles (32 rows)
# at 256 and 512 threads, stage a (the FMA tiles with both towers in one
# block) at 8 and 32 rows, and the 8-row tiles streaming both towers from
# L2.
EULER_DESIGN_TILES = {
    "E1": ((1, 32, 512, 3), (1, 32, 256, 3), (0, 32, 512, 3),
           (0, 8, 256, 3), (0, 8, 256, 0)),
    "general": ((1, 32, 256, 3), (1, 32, 512, 3), (0, 32, 512, 3),
                (0, 8, 256, 3), (0, 8, 256, 0)),
    "small": ((1, 32, 64, 3), (1, 32, 256, 3), (0, 32, 256, 3),
              (0, 8, 256, 3), (0, 8, 256, 0)),
}


def phase_euler_tiles(device):
    """Kernel 9 at each design of EULER_DESIGN_TILES beside the rule's:
    every FMA design bitwise the 8-row one, every 3xTF32 design within the
    twin's tolerance of it; median device times (``--only tiles``)."""
    out = {}
    with torch.no_grad():
        for label, args in ab_euler_inputs(device):
            spec, B = args[-1], args[0].shape[0]
            rule = FS.forward_design(FS.EULER_FWD, spec, B,
                                     FS._sm_count(device))
            launch = FS.euler_solve_forward_cuda
            ref = launch(*args, design=FS.EulerFwdDesign(0, 8, 256, 0))
            scale = float(ref.abs().max())
            cells = {"rule": tuple(rule)}
            for design in map(FS.EulerFwdDesign._make,
                              EULER_DESIGN_TILES[label]):
                if FS.fwd_smem_bytes(FS.EULER_FWD, spec, design.stage,
                                     design.rows, 1, mma=design.mma) \
                        > _build.MAX_SMEM_BYTES:
                    cells[str(tuple(design))] = "does not fit"
                    continue
                got = launch(*args, design=design)
                torch.cuda.synchronize()
                diff = float((got - ref).abs().max())
                if (diff > 0.0 if not design.mma else
                        diff > max(TOWER_VAL_ATOL, TOWER_VAL_REL * scale)):
                    raise RuntimeError(f"kernel 9 {label} at "
                                       f"{tuple(design)} differs from the "
                                       f"8-row design by {diff:.3e}")
                cells[str(tuple(design))] = median_cuda_ms(
                    lambda: launch(*args, design=design), 10)
            print(f"kernel9_{label} by (3xTF32, rows, threads, staged), ms "
                  f"(rule {tuple(rule)}; FMA designs bitwise the 8-row "
                  f"one): " + ", ".join(f"{k}: {v}" for k, v in cells.items()
                                        if k != "rule"), flush=True)
            out[f"kernel9_{label}"] = cells
    return out


def phase_cde_tiles(device):
    """Kernel 8 at the reference scale at 1, 2, 4 and 8 warps a block
    (32 / G rows a warp, G the lanes of a row): every block size bitwise
    the others; median device times (``--only tiles``)."""
    gan = gan_models(device)
    ts, real = gan_data(device)
    (_, _), (cde_args, cde_w) = gan_kernel_inputs(device, gan, ts, real)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    cells = {}
    with torch.no_grad():
        hs, czs = GF.cde_solve_forward_cuda(*cde_args, cde_w)
        ghs = torch.zeros_like(hs)
        ghs[-1] = torch.randn(hs.shape[1:], generator=gen, device=device)
        cargs = (*cde_args, cde_w, czs, ghs)
        first = None
        for threads in (32, 64, 128, 256):
            got = flat_grads(GF.cde_solve_backward_cuda(*cargs,
                                                        threads=threads))
            torch.cuda.synchronize()
            if first is None:
                first = got
            elif not all(torch.equal(a, b) for a, b in zip(got, first)):
                raise RuntimeError(f"kernel 8 at {threads} threads differs "
                                   f"from 32 threads")
            cells[threads] = median_cuda_ms(
                lambda: GF.cde_solve_backward_cuda(*cargs, threads=threads),
                20)
    print(f"kernel8 by threads a block, ms (rule {GF.THREADS}): "
          + ", ".join(f"{k}: {v:.4f}" for k, v in cells.items()), flush=True)
    return cells


GAN_TILE_THREADS = (32, 64, 128, 256)


def gen_rows(gen_args, n):
    """Kernel 5's inputs cut to the batch's first ``n`` rows."""
    x0, f0, g0, noise, t1s, dts = gen_args
    return (x0[:n].contiguous(), f0[:n].contiguous(), g0[:n].contiguous(),
            noise[:, :n].contiguous(), t1s, dts)


def phase_gan_tiles(device):
    """Kernels 5, 6 and 7 at the reference scale at 1, 2, 4 and 8 warps a
    block: every cell of a kernel bitwise the others; median device times,
    and kernel 5's at B = 1, where one warp's chain of dependent steps is
    all the time (``--only tiles``)."""
    gan = gan_models(device)
    ts, real = gan_data(device)
    (gen_args, gen_w), (cde_args, cde_w) = gan_kernel_inputs(
        device, gan, ts, real)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    cells = {}
    with torch.no_grad():
        ys, zs, gs = GF.gen_solve_forward_cuda(*gen_args, gen_w)
        gy = torch.randn(ys.shape, generator=gen, device=device)
        bargs = (*gen_args, gen_w, zs, gs, gy)
        for k, run, flat in (
                (5, lambda t: GF.gen_solve_forward_cuda(*gen_args, gen_w,
                                                        threads=t), list),
                (6, lambda t: GF.gen_solve_backward_cuda(*bargs, threads=t),
                 flat_grads),
                (7, lambda t: GF.cde_solve_forward_cuda(*cde_args, cde_w,
                                                        threads=t), list)):
            first, times = None, {}
            for threads in GAN_TILE_THREADS:
                got = flat(run(threads))
                torch.cuda.synchronize()
                if first is None:
                    first = got
                elif not all(torch.equal(a, b) for a, b in zip(got, first)):
                    raise RuntimeError(f"kernel {k} at {threads} threads "
                                       f"differs from 32 threads")
                times[str(threads)] = median_cuda_ms(lambda: run(threads), 20)
            print(f"kernel{k} by threads a block, ms (default {GF.THREADS}; "
                  f"all bitwise equal): " + ", ".join(
                      f"{t}: {v:.4f}" for t, v in times.items()), flush=True)
            cells[f"kernel{k}"] = dict(default=str(GF.THREADS), **times)
        one = gen_rows(gen_args, 1)
        cells["kernel5"]["B1"] = median_cuda_ms(
            lambda: GF.gen_solve_forward_cuda(*one, gen_w), 20)
    print(f"kernel5 at B = 1, ms: {cells['kernel5']['B1']:.4f}", flush=True)
    return cells


def phase_kernel2(device):
    """Kernel 2 vs its plain version and a float64 run on seeded inputs and
    cotangents at the flagship shapes, with normal and with saturated
    diffusion; two calls must agree bitwise; its times whole and by phase
    and block size."""
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
            exact = LF.fused_solve_backward_plain(
                *in_double(args), [w.double() for w in weights], zs.double(),
                gz.double(), gq.double())
            torch.cuda.synchronize()
            errs.append(check_against_plain(
                f"kernel 2, {label} diffusion,", GRAD_NAMES, _flat(got),
                _flat(want), _flat(exact), BWD_ATOL, BWD_REL,
                f64_rel=BWD_F64_REL))
            del exact
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
        parts = backward_parts("kernel 2", timed, False, 10)
    bound_ms, bound_by = bound(
        3 * solve_flops(BATCH, LATENT, CONTEXT, HIDDEN, n),
        [*timed[:5], *timed[5], *timed[6:], *outputs])
    print(f"kernel 2: median {ms:.4f} ms; plain: median {plain_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(max_abs_err=errs[0][0], max_abs_err_saturated=errs[1][0],
                max_rel_err=max(e[1] for e in errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                **parts)


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


def profile_run(label, fn, cpu=True):
    """``fn`` under torch.profiler: the number of kernels, their device time,
    the device's busy share of the (profiled) wall time, and the costliest
    kernels by name. The device-side ranges of annotations (such as
    ``Optimizer.step``) span kernels already counted, so they are left
    out. ``cpu=False`` records the device's activity alone: a step of
    tens of thousands of eager ops then takes seconds, not a minute, to
    read back, and its profiled wall is less inflated (the ``sdeint``
    routes' profiles are taken so). Profiles of one run can count a few
    kernels apart (see ADA_PROFILES)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
    return dict(wall_ms=wall_ms, device_ms=device_ms, kernels=kernels,
                busy=device_ms / wall_ms)


def phase_profile(device, served, trained, xs, ts):
    """A forward pass and a train step of each route under the profiler."""
    models, opts = trained
    for route in ROUTES:
        gen = torch.Generator(device=device).manual_seed(200)

        def forward():
            with torch.no_grad():
                latent_sde_loss(served, xs, ts, gen, dt=DT,
                                fused=route == "fused")

        profile_run(f"forward {route}", forward, cpu=route == "fused")
    for route in ROUTES:
        profile_run(f"train step {route}", lambda: train_step(
            models[route], opts[route], xs, ts, route, 500, 1.0),
            cpu=route == "fused")


# --------------------------------------------------------------------------- #
#  SDE-GAN: kernels 5 and 7, served requests                                  #
# --------------------------------------------------------------------------- #

def gan_models(device, dtype=torch.float32):
    gen = torch.Generator().manual_seed(SEED)
    generator = Generator(GAN_DATA, GAN_INIT_NOISE, GAN_NOISE, GAN_HIDDEN,
                          GAN_MLP, GAN_LAYERS, dtype=dtype,
                          init_mult1=GAN_MULT1, init_mult2=GAN_MULT2,
                          device=device, generator=gen)
    critic = Discriminator(GAN_DATA, GAN_CRITIC_HIDDEN, GAN_MLP, GAN_LAYERS,
                           dtype=dtype, device=device, generator=gen)
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
                        rtol=0.0, f64_rel=None, ref="float64"):
    """Holds a kernel's outputs to its plain version's at max(atol, rel_tol
    * scale), and to twice the plain version's distance from the plain
    version run in float64 (``exact``; another reference named by ``ref``)
    plus atol, or plus ``f64_rel`` times the scale where that is given.
    With ``rtol`` (inputs on which float32 itself is ill-conditioned) the
    first bound adds three times the plain version's own distance from
    float64, what float32 rounding alone gives on these inputs, and the
    second ``rtol`` times the scale. Returns the largest absolute and scale-relative errors against
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
        cells.append(f"{name} {err:.2e}/{scale:.3g} ({ref}: {err64:.2e} vs "
                     f"{plain64:.2e})")
        slack = 3 * plain64 if rtol else 0.0
        if err > max(atol, rel_tol * scale) + slack:
            failures.append(f"{name} differs by {err:.3e} > max({atol}, "
                            f"{rel_tol} * {scale:.4g}) + {slack:.3e}")
        margin = atol if f64_rel is None else f64_rel * scale
        if err64 > 2 * plain64 + margin + rtol * scale:
            failures.append(f"{name} is {err64:.3e} from the {ref} run, "
                            f"the plain version {plain64:.3e}")
    print(f"{label} vs plain (abs err/max|plain|; from {ref}: kernel vs "
          f"plain): " + "; ".join(cells), flush=True)
    print(f"{label} vs plain: max_abs_err={worst:.3e}, max_rel_err="
          f"{worst_rel:.3e}", flush=True)
    if failures:
        raise RuntimeError(f"{label}: " + "; ".join(failures))
    return worst, worst_rel


def time_gan_kernel(label, run_cuda, run_plain, tensors, flops,
                    plain_reps=5, peak=PEAK_F32_FLOPS):
    """Median device times of a GAN kernel (``run_cuda(threads)``, 20 runs
    at each block size, the default's for the record) and of its plain
    version (``run_plain()``), and the bound of ``flops`` at ``peak`` and
    of the bytes of ``tensors``."""
    by_threads = {}
    for threads in GAN_THREADS:
        by_threads[threads] = median_cuda_ms(lambda: run_cuda(threads), 20)
    ms = by_threads[GF.THREADS]
    plain_ms = median_cuda_ms(run_plain, plain_reps, warmup=1)
    bound_ms, bound_by = bound(flops, tensors, peak)
    sweep = ", ".join(f"{t}: {v:.4f}" for t, v in by_threads.items())
    print(f"{label}: median {ms:.4f} ms at {GF.THREADS} threads per block "
          f"(threads: ms {sweep}); plain: median {plain_ms:.4f} ms; bound "
          f"{bound_ms:.5f} ms ({bound_by}, {flops / 1e9:.4f} GFLOP)",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by,
                ms_by_threads={str(t): v for t, v in by_threads.items()})


def double(tensors, dtype=torch.float64):
    """The tensors in float64 (or ``dtype``); a tuple among them (a
    backward's weights) stays a tuple."""
    return [tuple(double(t, dtype)) if isinstance(t, tuple) else t.to(dtype)
            for t in tensors]


def phase_gan_kernels(device, models, ts, real):
    """Kernels 5 and 7 against their plain versions on seeded inputs at the
    reference scale."""
    (gen_args, gen_w), (cde_args, cde_w) = gan_kernel_inputs(
        device, models, ts, real)
    lib = _build.load_library()
    B, S, M, m, n = GF.check_gen_inputs(*gen_args, gen_w)
    Bc, Sc, Mc, C, _ = GF.check_cde_inputs(*cde_args, cde_w)
    smem5 = lib.tsde_gan_gen_fwd_smem_bytes(S, M, m, GF.THREADS)
    smem7 = lib.tsde_gan_cde_fwd_smem_bytes(Sc, Mc, C, GF.THREADS)
    print(f"GAN kernels: shared memory per block at {GF.THREADS} threads "
          f"{smem5} bytes (kernel 5), {smem7} bytes (kernel 7)", flush=True)
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
            dict(max_abs_err=err7[0], max_rel_err=err7[1],
                 threads=GF.THREADS, **k7))


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
            models, ts, real, 500, route == "fused"), cpu=route == "fused")


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
    print(f"GAN backward kernels: shared memory per block at "
          f"{GF.THREADS} threads "
          f"{lib.tsde_gan_gen_bwd_smem_bytes(S, M, m, GF.THREADS)} bytes "
          f"(kernel 6), "
          f"{lib.tsde_gan_cde_bwd_smem_bytes(Sc, Mc, C, GF.THREADS)} bytes "
          f"(kernel 8); "
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
    return (dict(max_abs_err=err6[0], max_rel_err=err6[1],
                 threads=GF.THREADS, **k6),
            dict(max_abs_err=errs[0][0], max_abs_err_dense=errs[1][0],
                 max_rel_err=max(e[1] for e in errs), **k8))


GAN_COUNTERS = ("gen_launches", "gen_bwd_launches", "cde_launches",
                "cde_bwd_launches")


def gan_counts():
    return tuple(getattr(GF, c) for c in GAN_COUNTERS)


def gan_train_step(models, opts, ts, batch, seed, fused, adjoint=False):
    """One training step: gan_grads on a generator seeded ``seed``, an
    Adadelta update of each network, the critic's weight clip. Returns the
    detached loss (a tensor) and the gradients."""
    generator, critic = models
    gen = torch.Generator(device=batch.device).manual_seed(seed)
    loss, g_gen, g_disc = gan_grads(generator, critic, gen, ts, batch,
                                    dt=GAN_DT, adjoint=adjoint, fused=fused)
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
            models, opts, ts, batch, 800, route == "fused"),
            cpu=route == "fused")


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
                      seed, dt=TOWER_DT):
    """A solve's spec and a forward kernel's inputs as fused_sdeint makes
    them, on seeded y0 and noise over the step grid of [0, 1] at dt."""
    spec = FS.solve_spec(drift, diffusion, d, m, diag, wt)
    grid = TI.build_step_grid(0.0, 1.0, dt)
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


def fitting_stagings(kind, spec):
    """Every way of staging the solve's towers in shared memory (bitmasks
    of fused_solve.STAGE_ORDER) that fits a block of a kernel of
    ``kind``."""
    lib = _build.load_library()
    table = FS._host_table(spec)
    return [st for st in FS.STAGE_ORDER[3 if spec.prior else 2]
            if lib.tsde_tower_smem_bytes(kind, table, *FS._dims(spec), st)
            <= _build.MAX_SMEM_BYTES]


def check_stagings(label, launch, bargs, kind, spec, want):
    """Kernel 10, 12 or 14 at every staging of its towers that fits a block:
    each bitwise equal to ``want`` (staging moves only where the weights
    are read from)."""
    stagings = fitting_stagings(kind, spec)
    for st in stagings:
        got = launch(*bargs, stage=st)[0]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"{label}: staging {st} changes the result")
    print(f"{label}: stagings {stagings} agree bitwise", flush=True)


def forward_layout(kind, spec, B, device):
    """Kernel 9's, 11's or 13's design for this solve and its shared memory
    a block, for the log."""
    design = FS.forward_design(kind, spec, B, FS._sm_count(device))
    if kind == FS.EULER_FWD:
        smem = FS.fwd_smem_bytes(kind, spec, design.stage, design.rows, 1,
                                 mma=design.mma)
        return (f"{smem} bytes, {'3xTF32' if design.mma else 'FMA'} tiles, "
                f"{design.rows} rows, {design.threads} threads, towers "
                f"staged {design.stage}")
    smem = FS.fwd_smem_bytes(kind, spec, design.stage, design.rows,
                             design.cluster)
    return (f"{smem} bytes, clusters of {design.cluster}, {design.rows} "
            f"rows, {design.threads} threads, towers staged {design.stage}")


def staged_layout(kind, spec, B, device):
    """A sweep's staging (fused_solve.staged_towers) and shared memory a
    block, for the log."""
    lib = _build.load_library()
    stage = FS.staged_towers(lib, kind, spec, B, device)
    smem = lib.tsde_tower_smem_bytes(kind, FS._host_table(spec),
                                     *FS._dims(spec), stage)
    return f"{smem} bytes, towers staged {stage}"


def tower_contraction_by_matmul(views, x0):
    """Kernel 10's, 12's or 14's contraction as PyTorch calls on the same
    scratch
    (the yardstick, never on the path): a torch.matmul and a column sum a
    layer."""
    out = []
    for xs, ds in views:
        for i, d in enumerate(ds):
            out += [torch.matmul((x0 if i == 0 else xs[i - 1]).T, d),
                    d.sum(0)]
    return out


def chain_parts(label, launch, bargs, spec, B, N, x0, packs, reps):
    """Median device times of kernel 10's, 12's or 14's sweep alone and of its
    contraction and reduction alone on the sweep's workspace, the
    contraction's bound, and the torch.matmul yardstick on the same
    scratch (x0: every step's first tower input, (N,B,in)). Prints them
    with the workspace's bytes."""
    _, ws = launch(*bargs)
    sweep = median_cuda_ms(
        lambda: launch(*bargs, stages=1, workspace=ws), reps)
    contraction = median_cuda_ms(
        lambda: launch(*bargs, stages=2, workspace=ws), reps)
    views = FS.scratch_views(ws, spec, B, N)
    M = N * B
    x0 = x0.reshape(M, -1).contiguous()
    matmul_ms = median_cuda_ms(
        lambda: tower_contraction_by_matmul(views, x0), reps)
    shapes = [sh for tower in FS._spec_shapes(spec) for sh in tower]
    flops = M * sum(2 * i * o + o for i, o, _ in shapes)
    scratch = [v for xs, ds in views for v in xs + ds]
    # Reads the scratch and the gathered first inputs once, writes the
    # packs' gradients (the packs' sizes).
    bound_ms, bound_by = bound(flops, [*scratch, x0, *packs])
    scratch_bytes = sum(v.numel() for v in scratch) * 4
    print(f"{label}: sweep {sweep:.4f} ms; contraction and reduction "
          f"{contraction:.4f} ms (bound {bound_ms:.4f}, {bound_by}, "
          f"{flops / 1e9:.3f} GFLOP); torch.matmul yardstick on the same "
          f"scratch {matmul_ms:.4f} ms; scratch {scratch_bytes / 1e6:.1f} "
          f"MB, workspace {ws.numel() * 4 / 1e6:.1f} MB", flush=True)
    return dict(sweep_ms=sweep, contraction_ms=contraction,
                contraction_bound_ms=bound_ms, contraction_bound_by=bound_by,
                contraction_matmul_ms=matmul_ms, scratch_bytes=scratch_bytes,
                workspace_bytes=ws.numel() * 4)


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
        launch = FS._euler_backward_cuda
        kinds = (FS.EULER_FWD, FS.EULER_BWD)
        outs = ("ys",)
        douts = ("dy0", "dnoise", "dfw", "dgw")
    else:
        names = ("tower_rh_fwd", "tower_rh_bwd")
        fwd, fwd_plain = FS.rh_solve_forward_cuda, FS.rh_solve_forward_plain
        bwd, bwd_plain = FS.rh_solve_backward_cuda, \
            FS.rh_solve_backward_plain
        launch = FS._rh_backward_cuda
        kinds = (FS.RH_FWD, FS.RH_BWD)
        outs = ("ys", "zs", "gs")
        douts = ("dy0", "df0", "dg0", "dnoise", "dfw", "dgw")
    layout = [forward_layout(kinds[0], spec, B, device),
              staged_layout(kinds[1], spec, B, device)]
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
        again = as_tuple(fwd(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{label} {names[0]} is not bitwise "
                               f"repeatable")
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        gy = torch.randn(got[0].shape, generator=gen, device=device)
        bargs = (*args, *(got if euler else got[1:]), gy)
        got_b = bwd(*bargs)
        want_b = bwd_plain(*bargs)
        exact_b = bwd_plain(*in_double(bargs))
        torch.cuda.synchronize()
        # Kernels 10 and 12, each a sweep split from its contraction, are
        # held to the float64 run as kernels 2 and 4 are (BWD_F64_REL).
        err_b = check_against_plain(f"{label} {names[1]}", douts, got_b,
                                    want_b, exact_b, TOWER_GRAD_ATOL,
                                    TOWER_GRAD_REL, f64_rel=BWD_F64_REL)
        del exact_b
        again = bwd(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
            raise RuntimeError(f"{label} {names[1]} is not bitwise "
                               f"repeatable")
        print(f"{label} {names[1]}: two calls agree bitwise", flush=True)
        check_stagings(f"{label} {names[1]}", launch, bargs, kinds[1], spec,
                       got_b)
        if not timed:
            return None
        ms_f = median_cuda_ms(lambda: fwd(*args), 20)
        plain_f = median_cuda_ms(lambda: fwd_plain(*args), 5, warmup=1)
        ms_b = median_cuda_ms(lambda: bwd(*bargs), 10)
        plain_b = median_cuda_ms(lambda: bwd_plain(*bargs), 3, warmup=1)
        if euler:
            x0 = FS.first_inputs(args[2], torch.cat([args[0][None],
                                                     got[0][:-1]]), wt)
            packs = args[4:6]
        else:
            x0 = FS.first_inputs(args[4], got[1], wt)
            packs = args[6:8]
        parts = chain_parts(f"{label} {names[1]}", launch, bargs, spec, B, N,
                            x0, packs, 10)
        del x0
        stagings = [st for st in (EULER_STAGINGS if euler else RH_STAGINGS)
                    if st in fitting_stagings(kinds[1], spec)]
        parts["ms_by_staging"] = {
            str(st): median_cuda_ms(lambda: launch(*bargs, stage=st), 5)
            for st in stagings}
        print(f"{label} {names[1]} staging (towers staged: ms): "
              + "; ".join(f"{st}: {t:.4f}" for st, t
                          in parts["ms_by_staging"].items()), flush=True)
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
                            bound_by=bound_by,
                            **(parts if name == names[1] else {})))
    return records


# Kernels 10, 12 and 14 on a long solve (phases 14 and 18): E1's, R1's and
# L1's towers over these many steps of [0, 1], whose workspace of one
# window would outgrow fused_solve.WORKSPACE_BYTES.
LONG_STEPS = {"E1": 512, "R1": 1024, "L1": 512}


def check_long_solve(name, device):
    """Kernel 10 (E1), 12 (R1) or 14 (L1) over LONG_STEPS[name] steps: swept in
    windows (fused_solve.bwd_window), its workspace within
    fused_solve.WORKSPACE_BYTES, every output within max(TOWER_GRAD_ATOL,
    TOWER_GRAD_REL * scale) of its twin's, two calls bitwise equal.
    Returns the steps, the window, the workspace's bytes, the median time
    and the largest errors."""
    method, B, d, towers = tower_config(device, name)
    N = LONG_STEPS[name]
    gen = torch.Generator(device=device).manual_seed(SEED + 27)
    with torch.no_grad():
        if method == "euler_logqp":
            spec, args = logqp_kernel_args(device, towers, B, d, False,
                                           SEED + 26, 1.0 / N)
            ys, qs = FS.euler_logqp_solve_forward_cuda(*args)
            gy = torch.randn(ys.shape, generator=gen, device=device)
            gq = torch.randn(qs.shape, generator=gen, device=device)
            bargs = (*args, ys, gy, gq.flip(0).cumsum(0).flip(0).contiguous())
            launch = FS._euler_logqp_backward_cuda
            plain = FS.euler_logqp_solve_backward_plain
            names = ("dy0", "dnoise", "dfw", "dhw", "dgw")
        elif method == "euler":
            spec, args = tower_kernel_args(device, method, *towers, B, d, d,
                                           True, False, SEED + 26, 1.0 / N)
            ys = FS.euler_solve_forward_cuda(*args)
            gy = torch.randn(ys.shape, generator=gen, device=device)
            bargs = (*args, ys, gy)
            launch = FS._euler_backward_cuda
            plain = FS.euler_solve_backward_plain
            names = ("dy0", "dnoise", "dfw", "dgw")
        else:
            spec, args = tower_kernel_args(device, method, *towers, B, d, d,
                                           True, False, SEED + 26, 1.0 / N)
            _, zs, gs = FS.rh_solve_forward_cuda(*args)
            gy = torch.randn(zs.shape, generator=gen, device=device)
            bargs = (*args, zs, gs, gy)
            launch = FS._rh_backward_cuda
            plain = FS.rh_solve_backward_plain
            names = ("dy0", "df0", "dg0", "dnoise", "dfw", "dgw")
        window = FS.bwd_window(spec, B, N)
        got, ws = launch(*bargs)
        again, _ = launch(*bargs)
        want = plain(*bargs)
        torch.cuda.synchronize()
        label = f"{name} over {N} steps: {launch.__name__[1:]}"
        if window >= N or 4 * ws.numel() > FS.WORKSPACE_BYTES:
            raise RuntimeError(f"{label}: window {window}, workspace "
                               f"{4 * ws.numel()} bytes")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{label} is not bitwise repeatable")
        worst = worst_rel = 0.0
        cells = []
        for tensor, g, w in zip(names, got, want):
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            if not torch.isfinite(g).all() or err > max(
                    TOWER_GRAD_ATOL, TOWER_GRAD_REL * scale):
                raise RuntimeError(f"{label}: {tensor} differs from the "
                                   f"plain version by {err:.3e} (max "
                                   f"{scale:.4g})")
            worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
            cells.append(f"{tensor} {err:.2e}/{scale:.3g}")
        del want
        ms = median_cuda_ms(lambda: launch(*bargs), 5)
    windows = -(-N // window)
    print(f"{label}: {windows} windows of {window} steps, workspace "
          f"{4 * ws.numel() / 1e6:.1f} MB (of {FS.WORKSPACE_BYTES / 1e6:.1f});"
          f" vs plain (abs err/max|plain|): {'; '.join(cells)}; two calls "
          f"agree bitwise; median {ms:.4f} ms", flush=True)
    return dict(steps=N, window=window, workspace_bytes=4 * ws.numel(),
                ms=ms, max_abs_err=worst, max_rel_err=worst_rel)


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
    records["reversible_heun"][1]["long_solve"] = check_long_solve("R1",
                                                                   device)
    records["euler"][1]["long_solve"] = check_long_solve("E1", device)
    return records


# --------------------------------------------------------------------------- #
#  fused_sdeint_logqp: kernels 13 and 14                                      #
# --------------------------------------------------------------------------- #

def logqp_kernel_args(device, towers, B, d, wt, seed, dt=TOWER_DT):
    """A logqp solve's spec and kernel 13's inputs as fused_sdeint_logqp
    makes them (noise drawn at (B, d+1), its last channel unused), on
    seeded y0 and noise over the step grid of [0, 1] at dt."""
    drift, prior, diffusion = towers
    spec = FS.solve_spec(drift, diffusion, d, d, True, wt, prior=prior)
    grid = TI.build_step_grid(0.0, 1.0, dt)
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
    layout = [forward_layout(FS.EULER_LOGQP_FWD, spec, B, device),
              staged_layout(FS.EULER_LOGQP_BWD, spec, B, device)]
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
                                    TOWER_GRAD_REL, grad_rtol,
                                    f64_rel=BWD_F64_REL)
        del exact_b
        again = bwd(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
            raise RuntimeError(f"{label} tower_euler_logqp_bwd is not "
                               f"bitwise repeatable")
        print(f"{label} tower_euler_logqp_bwd: two calls agree bitwise",
              flush=True)
        launch = FS._euler_logqp_backward_cuda
        check_stagings(f"{label} tower_euler_logqp_bwd", launch, bargs,
                       FS.EULER_LOGQP_BWD, spec, got_b)
        if not stagings:
            return None
        ms_f = median_cuda_ms(lambda: fwd(*args), 20)
        plain_f = median_cuda_ms(lambda: fwd_plain(*args), 5, warmup=1)
        ms_b = median_cuda_ms(lambda: bwd(*bargs), 10)
        plain_b = median_cuda_ms(lambda: bwd_plain(*bargs), 3, warmup=1)
        y_pre = torch.cat([args[0][None], got[0][:-1]])
        parts = chain_parts(f"{label} tower_euler_logqp_bwd", launch, bargs,
                            spec, B, N, FS.first_inputs(args[2], y_pre, wt),
                            args[4:7], 10)
        # The forward at each staging in the 8-row streamed design (the
        # earlier kernel's), beside the sweep at it.
        by_stage = {}
        for stage in stagings:
            streamed = FS.FwdDesign(1, 8, 3 * FS.FWD_STREAM_THREADS, stage)
            by_stage[stage] = (
                median_cuda_ms(lambda: fwd(*args, design=streamed), 10),
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
                                           in by_stage.items()},
                            **(parts if i == 1 else {})))
    return records


def small_logqp_towers(device):
    """The small solve's drift, prior and diffusion (LOGQP_SMALL)."""
    B, d, hidden = LOGQP_SMALL
    return (tower_spec(SEED + 22, [d + 1, hidden, d], TOWER_FACTS, device),
            tower_spec(SEED + 23, [d + 1, hidden, d], TOWER_FACTS, device),
            tower_spec(SEED + 24, [d + 1, hidden, d], ("lipswish", "tanh"),
                       device, scale=0.8))


def phase_logqp_kernels(device):
    """Kernels 13 and 14 at L1 and L2 (timed, with the stagings of
    LOGQP_STAGINGS) and on the small solve with a signed diffusion."""
    records = {}
    for name in ("L1", "L2"):
        _, B, d, towers = tower_config(device, name)
        records[name] = run_logqp_kernels(name, device, towers, B, d, False,
                                          SEED + 21, LOGQP_STAGINGS[name])
    B, d, hidden = LOGQP_SMALL
    run_logqp_kernels("small", device, small_logqp_towers(device), B, d,
                      True, SEED + 25, signed=True)
    records["L1"][1]["long_solve"] = check_long_solve("L1", device)
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
                    lambda: train_step(route, 500), cpu=route == "fused")
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


# --------------------------------------------------------------------------- #
#  K stacked latent replicas: kernels 3 and 4, latent_sde_loss_multi          #
# --------------------------------------------------------------------------- #

def replica_models(device, K, seed, dtype=torch.float32):
    """K flagship LatentSDEs from the generator seeds seed .. seed + K - 1."""
    return [LatentSDE(DATA, LATENT, CONTEXT, HIDDEN, dtype=dtype,
                      device=device,
                      generator=torch.Generator().manual_seed(seed + k))
            for k in range(K)]


def multi_kernel_inputs(device, K, dt=DT, dtype=torch.float32):
    """Seeded inputs of kernels 3 and 4 at the flagship shapes (steps of
    ``dt``), as the main path makes them for K replicas of weights in
    ``dtype``: z0 (K,B,L), ctx (K,T,B,C), the shared ctx_idx and dts, noise
    (K,n,B,L), each weight stacked (K, ...)."""
    models = replica_models(device, K, SEED + 100, dtype)
    per = [kernel_inputs(device, m, SEED + 110 + k, dt)
           for k, m in enumerate(models)]
    _, _, ctx_idx, _, dts = per[0]
    stacked = [torch.stack([p[i] for p in per]).contiguous() for i in (0, 1, 3)]
    with torch.no_grad():
        weights = [torch.stack(ws).contiguous() for ws in
                   zip(*(LF.solve_weights(m) for m in models))]
    return (stacked[0], stacked[1], ctx_idx, stacked[2], dts), weights


def replica(args, weights, k):
    """Replica k's inputs of kernels 1 and 2."""
    z0, ctx, ctx_idx, noise, dts = args
    return (z0[k], ctx[k], ctx_idx, noise[k], dts), [w[k] for w in weights]


def phase_multi_kernels(device):
    """Kernels 3 and 4 against their plain versions (and float64 runs) at
    the flagship with K = MULTI_K on seeded inputs and cotangents; each
    replica bitwise equal to kernels 1 and 2 on its own inputs; two sweeps
    bitwise equal; the times at each K of MULTI_KS beside K launches of
    kernels 1 and 2."""
    K = MULTI_K
    args, weights = multi_kernel_inputs(device, K)
    n = args[3].shape[1]
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    gz = torch.randn((K, n, BATCH, LATENT), generator=gen, device=device)
    gq = torch.randn((K, n, BATCH, 1), generator=gen, device=device)
    with torch.no_grad():
        got = LF.fused_solve_multi_forward_cuda(*args, weights)
        want = LF.fused_solve_multi_forward_plain(*args, weights)
        exact = LF.fused_solve_multi_forward_plain(
            *in_double(args), [w.double() for w in weights])
        torch.cuda.synchronize()
        err3 = check_against_plain("kernel 3", ("zs", "qs"), got, want,
                                   exact, KERNEL_ATOL, 0.0)
        saturated = [w.clone() for w in weights]
        saturated[15].sub_(25.0)       # g_b2: g ~ 1e-11 < 1e-7, as phase 4
        errs4 = []
        for label, w_l in (("normal", weights), ("saturated", saturated)):
            fwd = (got if label == "normal" else
                   LF.fused_solve_multi_forward_cuda(*args, w_l))
            b_l = (*args, w_l, fwd[0], gz, gq)
            got_b = LF.fused_solve_multi_backward_cuda(*b_l)
            want_b = LF.fused_solve_multi_backward_plain(*b_l)
            exact_b = LF.fused_solve_multi_backward_plain(
                *in_double(args), [w.double() for w in w_l],
                fwd[0].double(), gz.double(), gq.double())
            torch.cuda.synchronize()
            errs4.append(check_against_plain(
                f"kernel 4, {label} diffusion,", GRAD_NAMES, _flat(got_b),
                _flat(want_b), _flat(exact_b), BWD_ATOL, BWD_REL,
                f64_rel=BWD_F64_REL))
            del want_b, exact_b
            if label == "saturated":
                g_max = max(float(d.abs().max()) for d in got_b[3][12:])
                print(f"kernel 4, saturated diffusion: max |g_nets gradient| "
                      f"{g_max:.3e}", flush=True)
                if not g_max > 0:
                    raise RuntimeError("kernel 4's g_nets gradients vanish "
                                       "under saturated diffusion")
            for k in range(K):
                a_k, w_k = replica(args, w_l, k)
                one = LF.fused_solve_forward_cuda(*a_k, w_k)
                one_b = LF.fused_solve_backward_cuda(*a_k, w_k, fwd[0][k],
                                                     gz[k], gq[k])
                torch.cuda.synchronize()
                same = (all(torch.equal(a[k], b) for a, b in zip(fwd, one))
                        and all(torch.equal(a[k], b) for a, b in
                                zip(_flat(got_b), _flat(one_b))))
                if not same:
                    raise RuntimeError(f"replica {k} of kernels 3 and 4 "
                                       f"differs from kernels 1 and 2 on its "
                                       f"inputs ({label} diffusion)")
            print(f"kernels 3 and 4, {label} diffusion: each of the {K} "
                  f"replicas bitwise equal to kernels 1 and 2 on its own "
                  f"inputs", flush=True)
            if label == "normal":
                bargs, first = b_l, got_b
        del saturated, fwd, got_b
        again = LF.fused_solve_multi_backward_cuda(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip(_flat(first), _flat(again))):
            raise RuntimeError("kernel 4 is not bitwise repeatable")
        print("kernel 4: two sweeps agree bitwise", flush=True)
        parts4 = backward_parts(f"kernel 4 at K={K}", bargs, True, 5)
        plain_f = median_cuda_ms(
            lambda: LF.fused_solve_multi_forward_plain(*args, weights), 3,
            warmup=1)
        plain_b = median_cuda_ms(
            lambda: LF.fused_solve_multi_backward_plain(*bargs), 3, warmup=1)
        by_k = {}
        for Kt in MULTI_KS:
            a_t, w_t = multi_kernel_inputs(device, Kt)
            zs_t = LF.fused_solve_multi_forward_cuda(*a_t, w_t)[0]
            g_t = (gz[:1].expand(Kt, -1, -1, -1).contiguous(),
                   gq[:1].expand(Kt, -1, -1, -1).contiguous())
            b_t = (*a_t, w_t, zs_t, *g_t)
            singles = [replica(a_t, w_t, k) for k in range(Kt)]

            def k_singles():
                for a_k, w_k in singles:
                    LF.fused_solve_forward_cuda(*a_k, w_k)

            def k_singles_b():
                for k, (a_k, w_k) in enumerate(singles):
                    LF.fused_solve_backward_cuda(*a_k, w_k, zs_t[k], g_t[0][k],
                                                 g_t[1][k])

            flops = Kt * solve_flops(BATCH, LATENT, CONTEXT, HIDDEN, n)
            bound_f = bound(flops, [*a_t, *w_t, zs_t, zs_t[..., :1]])
            bound_b = bound(3 * flops, [*b_t[:5], *w_t, *b_t[6:], *a_t[:2],
                                        a_t[3], *w_t])
            by_k[Kt] = dict(
                rows=_build.load_library().tsde_latent_fused_fwd_rows(
                    Kt, BATCH, LATENT, CONTEXT, HIDDEN, device.index or 0),
                fwd_ms=median_cuda_ms(
                    lambda: LF.fused_solve_multi_forward_cuda(*a_t, w_t), 10),
                fwd_singles_ms=median_cuda_ms(k_singles, 10),
                bwd_ms=median_cuda_ms(
                    lambda: LF.fused_solve_multi_backward_cuda(*b_t), 5),
                bwd_singles_ms=median_cuda_ms(k_singles_b, 5),
                fwd_bound_ms=bound_f[0], bwd_bound_ms=bound_b[0],
                fwd_bound_by=bound_f[1], bwd_bound_by=bound_b[1])
            r = by_k[Kt]
            print(f"K={Kt}: kernel 3 ({r['rows']} rows a block) "
                  f"{r['fwd_ms']:.4f} ms vs {Kt} launches "
                  f"of kernel 1 {r['fwd_singles_ms']:.4f} ms (bound "
                  f"{r['fwd_bound_ms']:.4f}, {r['fwd_bound_by']}); kernel 4 "
                  f"{r['bwd_ms']:.4f} ms vs {Kt} launches of kernel 2 "
                  f"{r['bwd_singles_ms']:.4f} ms (bound "
                  f"{r['bwd_bound_ms']:.4f}, {r['bwd_bound_by']})",
                  flush=True)
            del a_t, w_t, zs_t, g_t, b_t, singles
    at = by_k[K]
    print(f"kernel 3 at K={K}: median {at['fwd_ms']:.4f} ms; plain: median "
          f"{plain_f:.4f} ms; kernel 4: median {at['bwd_ms']:.4f} ms "
          f"({at['bwd_ms'] / by_k[1]['bwd_ms']:.3f} x kernel 4 at K=1); "
          f"plain: median {plain_b:.4f} ms", flush=True)
    by_k_ms = {str(k): v for k, v in by_k.items()}
    return (dict(max_abs_err=err3[0], max_rel_err=err3[1], ms=at["fwd_ms"],
                 plain_ms=plain_f, bound_ms=at["fwd_bound_ms"],
                 bound_by=at["fwd_bound_by"], K=K,
                 ms_by_K={k: v["fwd_ms"] for k, v in by_k_ms.items()},
                 rows_by_K={k: v["rows"] for k, v in by_k_ms.items()},
                 k_launches_of_kernel1_ms_by_K={
                     k: v["fwd_singles_ms"] for k, v in by_k_ms.items()}),
            dict(max_abs_err=errs4[0][0], max_abs_err_saturated=errs4[1][0],
                 max_rel_err=max(e[1] for e in errs4), ms=at["bwd_ms"],
                 plain_ms=plain_b, bound_ms=at["bwd_bound_ms"],
                 bound_by=at["bwd_bound_by"], K=K,
                 ratio_to_K1=at["bwd_ms"] / by_k[1]["bwd_ms"],
                 **parts4,
                 ms_by_K={k: v["bwd_ms"] for k, v in by_k_ms.items()},
                 k_launches_of_kernel2_ms_by_K={
                     k: v["bwd_singles_ms"] for k, v in by_k_ms.items()},
                 long_solve=check_latent_long_solve(device)))


# Kernels 2 and 4 on a long solve (phase 21): the flagship at dt 1/512,
# whose workspace of one window would outgrow latent_fused.WORKSPACE_BYTES
# a replica (two windows).
LATENT_LONG_DT = 1.0 / 512


def check_latent_long_solve(device):
    """Kernel 2 and kernel 4 at K = MULTI_K over the flagship's solve at
    LATENT_LONG_DT: swept in windows (latent_fused.bwd_window), each
    replica's workspace within latent_fused.WORKSPACE_BYTES; kernel 2
    within kernel 2's tolerances of its plain version; each replica of
    kernel 4 bitwise kernel 2 on its inputs; two calls bitwise equal.
    Returns the steps, the window, the workspace's bytes a replica, the
    median times and the largest errors."""
    K = MULTI_K
    args, weights = multi_kernel_inputs(device, K, LATENT_LONG_DT)
    n = args[3].shape[1]
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    gz = torch.randn((K, n, BATCH, LATENT), generator=gen, device=device)
    gq = torch.randn((K, n, BATCH, 1), generator=gen, device=device)
    window = LF.bwd_window(BATCH, LATENT, CONTEXT, HIDDEN, n)
    with torch.no_grad():
        zs = LF.fused_solve_multi_forward_cuda(*args, weights)[0]
        bargs = (*args, weights, zs, gz, gq)
        got, ws = LF._backward_cuda(*bargs, multi=True)
        again = LF.fused_solve_multi_backward_cuda(*bargs)
        singles = []
        for k in range(K):
            a_k, w_k = replica(args, weights, k)
            singles.append(_flat(LF._backward_cuda(
                *a_k, w_k, zs[k], gz[k], gq[k], multi=False)[0]))
        a_0, w_0 = replica(args, weights, 0)
        want = LF.fused_solve_backward_plain(*a_0, w_0, zs[0], gz[0], gq[0])
        torch.cuda.synchronize()
        label = (f"kernels 2 and 4 over {n} steps (dt 1/"
                 f"{round(1 / LATENT_LONG_DT)})")
        ws_bytes = ws.shape[1] * ws.element_size()
        if window >= n or ws_bytes > LF.WORKSPACE_BYTES:
            raise RuntimeError(f"{label}: window {window}, workspace "
                               f"{ws_bytes} bytes a replica")
        if not all(torch.equal(a, b) for a, b in zip(_flat(got),
                                                     _flat(again))):
            raise RuntimeError(f"{label}: kernel 4 is not bitwise "
                               f"repeatable")
        for k, single in enumerate(singles):
            if not all(torch.equal(a[k], b)
                       for a, b in zip(_flat(got), single)):
                raise RuntimeError(f"{label}: replica {k} of kernel 4 "
                                   f"differs from kernel 2 on its inputs")
        worst = worst_rel = 0.0
        for name, g, w in zip(GRAD_NAMES, singles[0], _flat(want)):
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            if not torch.isfinite(g).all() or err > max(BWD_ATOL,
                                                        BWD_REL * scale):
                raise RuntimeError(f"{label}: kernel 2's {name} differs "
                                   f"from the plain version by {err:.3e} "
                                   f"(max {scale:.4g})")
            worst = max(worst, err)
            worst_rel = max(worst_rel, err / max(scale, 1e-30))
        del want, singles, again
        ms2 = median_cuda_ms(lambda: LF.fused_solve_backward_cuda(
            *a_0, w_0, zs[0], gz[0], gq[0]), 3)
        ms4 = median_cuda_ms(lambda: LF.fused_solve_multi_backward_cuda(
            *bargs), 3)
    windows = -(-n // window)
    print(f"{label}: {windows} windows of {window} steps, workspace "
          f"{ws_bytes / 1e6:.1f} MB a replica (of "
          f"{LF.WORKSPACE_BYTES / 1e6:.1f}); kernel 2 vs plain max abs err "
          f"{worst:.3e} (rel {worst_rel:.2e}); each of the {K} replicas of "
          f"kernel 4 bitwise kernel 2; two calls agree bitwise; kernel 2 "
          f"median {ms2:.4f} ms, kernel 4 at K={K} {ms4:.4f} ms", flush=True)
    return dict(steps=n, window=window, workspace_bytes=ws_bytes,
                ms_K1=ms2, ms_K4=ms4, max_abs_err=worst,
                max_rel_err=worst_rel)


def multi_counts():
    return (LF.multi_launches, LF.multi_bwd_launches, LF.launches,
            LF.bwd_launches)


def reset_latent_counts():
    LF.launches = LF.bwd_launches = 0
    LF.multi_launches = LF.multi_bwd_launches = 0
    LF.bf16_launches = LF.bf16_bwd_launches = 0
    LF.bf16_multi_launches = LF.bf16_multi_bwd_launches = 0


def stacked_replicas(device, K, dtype=torch.float32):
    return RP.stack_replicas(
        lambda g: LatentSDE(DATA, LATENT, CONTEXT, HIDDEN, dtype=dtype,
                            device=device, generator=g),
        [torch.Generator().manual_seed(SEED + 200 + k) for k in range(K)])


def replica_generators(device, seed, K):
    return [torch.Generator(device=device).manual_seed(seed + k)
            for k in range(K)]


@contextlib.contextmanager
def float32_draws():
    """The model's eps and the solve noise drawn in float32 and cast to the
    dtype asked for, so a float64 run sees a float32 run's draws."""
    normal, grid_noise = TL._standard_normal, TI.sample_grid_noise

    def standard_normal(shape, generator, dtype, device):
        return normal(shape, generator, torch.float32, device).to(dtype)

    def sample_grid_noise(generator, grid, size, dtype, device=None, **kw):
        return tuple(None if t is None else t.to(dtype) for t in grid_noise(
            generator, grid, size, torch.float32, device, **kw))

    TL._standard_normal, TI.sample_grid_noise = standard_normal, \
        sample_grid_noise
    try:
        yield
    finally:
        TL._standard_normal, TI.sample_grid_noise = normal, grid_noise


def phase_multi_path(device, xs, ts):
    """latent_sde_loss_multi at K = MULTI_K: served losses against the single
    fused loss of each replica on a clone of its generator, each call
    launching kernel 3 once; step-0 gradients of both routes; MULTI_STEPS
    Adam steps (lr 1e-2) on the stacked state, each launching kernels 3 and 4
    once; median step times of the multi fused route, the multi sdeint route
    and K single fused steps, each beside its profile (the ``sdeint``
    route's of the device's activity alone)."""
    K = MULTI_K
    models = stacked_replicas(device, K)
    singles = [RP.unstack_replica(models, k) for k in range(K)]

    def serve(seed):
        gens = replica_generators(device, seed, K)
        clones = []
        for g in gens:
            clone = torch.Generator(device=device)
            clone.set_state(g.get_state())
            clones.append(clone)
        before = multi_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            total, losses = latent_sde_loss_multi(models, xs, ts, gens, dt=DT,
                                                  fused=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = tuple(a - b for a, b in zip(multi_counts(), before))
        if delta != (1, 0, 0, 0):
            raise RuntimeError(f"a multi forward pass launched kernels 3, 4, "
                               f"1, 2 {delta} times")
        with torch.no_grad():
            want = [float(latent_sde_loss(m, xs, ts, c, dt=DT, fused=True)[0])
                    for m, c in zip(singles, clones)]
        got = [float(v) for v in losses]
        worst = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        print(f"multi serve {seed}: losses {['%.8g' % v for v in got]} vs "
              f"single {['%.8g' % v for v in want]}, worst rel diff "
              f"{worst:.3e}; {ms:.3f} ms", flush=True)
        if not (np.isfinite(got).all() and worst <= MULTI_LOSS_RTOL
                and abs(float(total) - sum(got)) <= 1e-5 * abs(sum(got))):
            raise RuntimeError(f"multi losses {got} differ from the single "
                               f"fused losses {want} by {worst:.3e}")
        return ms, worst

    serve(700)                                   # warm-up
    reset_latent_counts()
    served = [serve(seed) for seed in MULTI_SERVE_SEEDS]
    serve_launches = LF.multi_launches

    # Step-0 gradients of both routes, from the same weights and generators,
    # against a float64 run of the sdeint route on the same (float32) draws:
    # each route within MULTI_GRAD_REL of each gradient's scale.
    grads = {}
    for fused in (True, False, "float64"):
        reps = stacked_replicas(device, K)
        x = xs
        if fused == "float64":
            reps = RP.Replicas(
                reps.module,
                {n: p.detach().double().requires_grad_()
                 for n, p in reps.params.items()},
                {n: b.double() for n, b in reps.buffers.items()})
            x = xs.double()
        with float32_draws():
            total, _ = latent_sde_loss_multi(
                reps, x, ts, replica_generators(device, 710, K), dt=DT,
                fused=fused is True)
        total.backward()
        grads[fused] = {n: p.grad for n, p in reps.named_parameters()}
    rows = []
    for name, exact in grads["float64"].items():
        got, want = grads[True][name], grads[False][name]
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError(f"multi step 0: non-finite gradient of {name}")
        for k in range(K):
            scale = float(exact[k].abs().max())
            err_f = float((got[k].double() - exact[k]).abs().max())
            err_s = float((want[k].double() - exact[k]).abs().max())
            diff = float((got[k] - want[k]).abs().max())
            rows.append((diff / scale, name, k, err_f / scale, err_s / scale,
                         max(err_f, err_s) > MULTI_GRAD_REL * scale))
    rows.sort(key=lambda r: -r[3])
    for diff, name, k, rf, rs, _ in rows[:4]:
        print(f"multi step-0 gradient {name}[{k}], of scale: fused vs sdeint "
              f"route {diff:.3e}; from float64: fused {rf:.3e}, sdeint "
              f"{rs:.3e}", flush=True)
    worst = max(r[0] for r in rows)
    print(f"multi step-0 gradients, every replica: fused vs sdeint route "
          f"worst {worst:.3e} of scale; from float64 worst fused "
          f"{rows[0][3]:.3e}, sdeint {max(r[4] for r in rows):.3e}",
          flush=True)
    failed = [f"{name}[{k}]" for _, name, k, _, _, bad in rows if bad]
    if failed:
        raise RuntimeError(f"multi step-0 gradients of {failed} are further "
                           f"than {MULTI_GRAD_REL} of scale from float64")

    # Adam steps: the multi fused route, the multi sdeint route, and K
    # single fused models stepping one by one, in turns.
    routes = {"multi fused": stacked_replicas(device, K),
              "multi sdeint": stacked_replicas(device, K),
              "K single fused": replica_models(device, K, SEED + 200)}
    opts = {"multi fused": torch.optim.Adam(routes["multi fused"].parameters(),
                                            lr=LR),
            "multi sdeint": torch.optim.Adam(
                routes["multi sdeint"].parameters(), lr=LR),
            "K single fused": [torch.optim.Adam(m.parameters(), lr=LR)
                               for m in routes["K single fused"]]}

    def step(route, seed):
        gens = replica_generators(device, seed, K)
        if route == "K single fused":
            losses = []
            for m, opt, g in zip(routes[route], opts[route], gens):
                opt.zero_grad(set_to_none=True)
                loss, _ = latent_sde_loss(m, xs, ts, g, dt=DT, fused=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            return torch.stack(losses)
        opts[route].zero_grad(set_to_none=True)
        total, losses = latent_sde_loss_multi(
            routes[route], xs, ts, gens, dt=DT,
            fused=route == "multi fused")
        total.backward()
        opts[route].step()
        return losses.detach()

    times = {r: [] for r in routes}
    reset_latent_counts()
    order = list(routes)
    for i in range(MULTI_STEPS):
        for route in (order if i % 2 == 0 else order[::-1]):
            before = multi_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = step(route, 720 + i)
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3)
            delta = tuple(a - b for a, b in zip(multi_counts(), before))
            want = {"multi fused": (1, 1, 0, 0), "multi sdeint": (0, 0, 0, 0),
                    "K single fused": (0, 0, K, K)}[route]
            if delta != want:
                raise RuntimeError(f"{route} step {i}: kernels 3, 4, 1, 2 "
                                   f"launched {delta} times, not {want}")
            if not torch.isfinite(losses).all():
                raise RuntimeError(f"{route} step {i}: non-finite loss")
            print(f"train {route} step {i}: losses "
                  f"{[round(float(v), 3) for v in losses]} "
                  f"{times[route][-1]:.3f} ms", flush=True)
    train_launches = (LF.multi_launches, LF.multi_bwd_launches)
    for route in ("multi fused", "multi sdeint"):
        if not all(torch.isfinite(p).all() for p in routes[route].parameters()):
            raise RuntimeError(f"{route}: non-finite parameters after Adam")
    profiles = {r: profile_run(f"K={K} train step {r}",
                               lambda r=r: step(r, 730),
                               cpu=r != "multi sdeint") for r in routes}
    medians = {r: float(np.median(t)) for r, t in times.items()}
    for r in routes:
        print(f"K={K} train step, {r}: median {medians[r]:.3f} ms "
              f"({K * 1e3 / medians[r]:.1f} replica steps/s; profiled: "
              f"{profiles[r]['kernels']} kernels, busy "
              f"{profiles[r]['busy']:.3f})", flush=True)
    print(f"K={K} multi forward pass: median "
          f"{float(np.median([m for m, _ in served])):.3f} ms (host clock, "
          f"synchronised)", flush=True)
    return dict(launches_serve=serve_launches, launches=train_launches,
                step0_grad_rel_err=worst,
                loss_rel_err=max(w for _, w in served),
                step_ms={r: medians[r] for r in routes})


# --------------------------------------------------------------------------- #
#  bf16 mixed mode of kernels 1-4                                             #
# --------------------------------------------------------------------------- #

BF16 = torch.bfloat16
# Kernels 1-4 in bf16 mixed mode against their mixed-mode plain versions,
# per tensor: within BF16_REL of its scale, at least two bf16 ulps of its
# largest entry (the two sum each product in another order, which now and
# then flips the bf16 rounding of a product's input, a state or a gradient,
# and a flip moves what follows; measured at most one ulp, 5.0e-3 of scale,
# kernel 2's f_w2 at the flagship, NVIDIA H100 80GB HBM3, 700 W), and each
# within twice the plain version's distance from a float32 reference (the
# float32 plain version on the same bf16 weights, context and noise,
# widened, no activation rounded) plus BF16_REF_REL of the scale (the
# rounding of a bf16 output itself).
BF16_REL, BF16_REF_REL = 2 ** -6, 2 ** -8
# Those bars bound a kernel's distance from above only, and a kernel that
# rounded no product's input would pass them. So a kernel must also carry
# mixed mode's roundings: its outputs' RMS distances from the float32
# reference rounded to each output's dtype, over each one's scale and
# summed, at least BF16_FLOOR of its plain version's. A kernel that rounded
# nothing would write the rounded reference but for the order of its sums;
# the float64 plain version on the same inputs, rounded to each dtype,
# stands in for it and must miss the floor, or the floor could not tell
# the two apart.
BF16_FLOOR = 0.5
# The bf16 routes, on the JAX package's bars for its fused against its XLA
# route at the same bf16 weights (tests/test_fused_latent.py:131-166): the
# fused loss within 5e-3 relative of the other's, the cosine of all
# parameter gradients above 0.999. The fused route is held to the sdeint
# route at that test's size (data 3, latent 4, context 16, hidden 32, batch
# 8, 4 times, dt 0.25) for each of BF16_JAX_SEEDS. At the flagship the
# sdeint route's bf16 state drifts with the steps and its loss is a bf16
# number (an ulp of 5.4e-3 of it there), so the fused route is held instead
# to a float32-state reference: the fused route of a float32 model on the
# same weights, widened, and the same draws, at dt 1/32 and 1/128 for each
# of BF16_FLAGSHIP_SEEDS; its distance from the sdeint route is printed.
# The multi route's replicas are held to the single fused route on the same
# bar: their encoders, run under vmap or not, round bf16 in other orders.
BF16_ROUTE_RTOL, BF16_ROUTE_COS = 5e-3, 0.999
BF16_JAX_WIDTHS, BF16_JAX_BATCH, BF16_JAX_TIMES, BF16_JAX_DT = \
    (3, 4, 16, 32), 8, 4, 0.25
BF16_JAX_SEEDS = range(8)
BF16_FLAGSHIP_SEEDS, BF16_FLAGSHIP_DTS = range(300, 304), (1.0 / 32, DT)
BF16_STEPS = 3


def bf16_counts():
    """Launches of kernels 1-4 in bf16, then of the float32 ones."""
    return (LF.bf16_launches, LF.bf16_bwd_launches, LF.bf16_multi_launches,
            LF.bf16_multi_bwd_launches, LF.launches, LF.bwd_launches,
            LF.multi_launches, LF.multi_bwd_launches)


def bytes_ms(tensors):
    """The time the card's memory rate takes to move these tensors once."""
    return sum(t.numel() * t.element_size() for t in tensors) \
        / PEAK_BYTES_S * 1e3


def bf16_bound(flops, tensors):
    """A bf16 kernel's bound (its operands are bf16: the bf16 peak), and
    that of the same operations at the float32 FMA rate, which the kernel
    uses."""
    bound_ms, bound_by = bound(flops, tensors, PEAK_BF16_FLOPS)
    return dict(bound_ms=bound_ms, bound_by=bound_by,
                fma_bound_ms=flops / PEAK_F32_FLOPS * 1e3)


def bf16_reference(args, weights, dtype=torch.float32):
    """A mixed-mode solve's reference inputs in ``dtype``: the bf16
    context, noise and weights widened (exactly), so the plain version
    rounds no activation."""
    z0, ctx, ctx_idx, noise, dts = args
    return ((z0.to(dtype), ctx.to(dtype), ctx_idx, noise.to(dtype),
             dts.to(dtype)), [w.to(dtype) for w in weights])


def rounding_share(outs, ref, dtypes):
    """Summed over the outputs: each one's RMS distance from the float32
    reference rounded to its dtype, over that rounded reference's scale."""
    total = 0.0
    for o, r, d in zip(outs, ref, dtypes):
        r = r.to(d).double()
        scale = float(r.abs().max())
        if scale > 0:
            total += float((o.double() - r).square().mean().sqrt()) / scale
    return total


def check_bf16(label, names, got, want, ref, dtypes, stand_in=None):
    """A bf16 kernel's outputs: in ``dtypes``, held to its plain version
    and the float32 reference at the bars above, and no nearer the rounded
    reference than BF16_FLOOR of the plain version's distance; with
    ``stand_in`` (the float64 plain version's outputs), that floor shown to
    fail a kernel that rounds nothing."""
    for name, g, w, d in zip(names, got, want, dtypes):
        if g.dtype != d or w.dtype != d:
            raise RuntimeError(f"{label} {name}: {g.dtype} (plain "
                               f"{w.dtype}), expected {d}")
    errs = check_against_plain(
        label, names, [g.float() for g in got], [w.float() for w in want],
        [r.double() for r in ref], 0.0, BF16_REL, f64_rel=BF16_REF_REL,
        ref="float32 reference")
    share = rounding_share(got, ref, dtypes)
    plain = rounding_share(want, ref, dtypes)
    line = (f"{label}: RMS distance from the rounded float32 reference, "
            f"summed over scales: {share:.4e}, plain version {plain:.4e}")
    if stand_in is not None:
        stand = rounding_share([s.to(d) for s, d in zip(stand_in, dtypes)],
                               ref, dtypes)
        line += f", float64 stand-in {stand:.4e}"
    print(line, flush=True)
    if not share >= BF16_FLOOR * plain:
        raise RuntimeError(f"{label}: {share:.3e} from the rounded float32 "
                           f"reference, under {BF16_FLOOR} of the plain "
                           f"version's {plain:.3e}: mixed mode's roundings "
                           f"are missing")
    if stand_in is not None and not stand < BF16_FLOOR * plain:
        raise RuntimeError(f"{label}: a float64 stand-in passes the floor "
                           f"({stand:.3e} >= {BF16_FLOOR} * {plain:.3e}); it "
                           f"cannot tell mixed mode from float32")
    return errs + (share / plain if plain > 0 else 1.0,)


GRAD_DTYPES = (torch.float32,) + (BF16,) * (len(GRAD_NAMES) - 1)


def same_bits(label, got, want):
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError(f"{label} differ")


def phase_bf16_kernels(device):
    """Kernels 1 and 2 in bf16 mixed mode at the flagship against their
    mixed-mode plain versions and the float32 reference, and the floor of
    their roundings shown against a float64 stand-in (kernel 2 with normal
    and with saturated diffusion); two calls of each bitwise equal; median
    times and bounds (bf16 bytes, bf16 operations)."""
    model = flagship_model(device, BF16)
    args = kernel_inputs(device, model)
    n = args[3].shape[0]
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    gz = torch.randn((n, BATCH, LATENT), generator=gen,
                     device=device).to(BF16)
    gq = torch.randn((n, BATCH, 1), generator=gen, device=device)
    flops = solve_flops(BATCH, LATENT, CONTEXT, HIDDEN, n)
    out = {}
    with torch.no_grad():
        weights = LF.solve_weights(model)
        fwd = LF.fused_solve_forward_cuda(*args, weights)
        again = LF.fused_solve_forward_cuda(*args, weights)
        plain = LF.fused_solve_forward_plain(*args, weights)
        r_args, r_w = bf16_reference(args, weights)
        ref = LF.fused_solve_forward_plain(*r_args, r_w)
        d_args, d_w = bf16_reference(args, weights, torch.float64)
        stand_in = LF.fused_solve_forward_plain(*d_args, d_w)
        torch.cuda.synchronize()
        same_bits("kernel 1 (bf16): two calls", fwd, again)
        err = check_bf16("kernel 1 (bf16)", ("zs", "qs"), fwd, plain, ref,
                         (BF16, torch.float32), stand_in)
        del stand_in
        ms = median_cuda_ms(
            lambda: LF.fused_solve_forward_cuda(*args, weights), 20)
        plain_ms = median_cuda_ms(
            lambda: LF.fused_solve_forward_plain(*args, weights), 5)
        bnd = bf16_bound(flops, [*args, *weights, *fwd])
        print(f"kernel 1 (bf16): median {ms:.4f} ms; plain: median "
              f"{plain_ms:.4f} ms; bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}; bytes "
              f"{bytes_ms([*args, *weights, *fwd]):.4f} ms; at the float32 "
              f"FMA rate {bnd['fma_bound_ms']:.4f} ms)", flush=True)
        lib = _build.load_library()
        widths = (LATENT, CONTEXT, HIDDEN)
        out["fwd"] = dict(
            max_abs_err=err[0], max_rel_err=err[1], rounding_ratio=err[2],
            ms=ms, plain_ms=plain_ms,
            smem_bytes=lib.tsde_latent_fused_fwd_smem_bytes_bf16(*widths),
            blocks_per_sm=lib.tsde_latent_fused_fwd_blocks_per_sm_bf16(
                1, BATCH, *widths, device.index or 0),
            ptxas=ptxas_info("latent_fwd_bf16"), **bnd)
        print(f"kernel 1 (bf16): {out['fwd']['smem_bytes']} B of shared "
              f"memory a block, {out['fwd']['blocks_per_sm']} blocks an SM; "
              f"ptxas {json.dumps(out['fwd']['ptxas'])}", flush=True)
        errs = []
        for label in ("normal", "saturated"):
            if label == "saturated":
                model.g_nets[3].sub_(25.0)      # g ~ 1e-11 < 1e-7
            weights = LF.solve_weights(model)
            zs = (fwd[0] if label == "normal" else
                  LF.fused_solve_forward_cuda(*args, weights)[0])
            bargs = (*args, weights, zs, gz, gq)
            got = LF.fused_solve_backward_cuda(*bargs)
            want = LF.fused_solve_backward_plain(*bargs)
            r_args, r_w = bf16_reference(args, weights)
            ref = LF.fused_solve_backward_plain(*r_args, r_w, zs.float(),
                                                gz.float(), gq)
            stand_in = None
            if label == "normal":
                d_args, d_w = bf16_reference(args, weights, torch.float64)
                stand_in = _flat(LF.fused_solve_backward_plain(
                    *d_args, d_w, zs.double(), gz.double(), gq.double()))
            torch.cuda.synchronize()
            errs.append(check_bf16(
                f"kernel 2 (bf16), {label} diffusion,", GRAD_NAMES,
                _flat(got), _flat(want), _flat(ref), GRAD_DTYPES, stand_in))
            del ref, stand_in
            if label == "normal":
                same_bits("kernel 2 (bf16): two calls", _flat(got),
                          _flat(LF.fused_solve_backward_cuda(*bargs)))
                timed, outputs = bargs, _flat(got)
            elif not max(float(d.abs().max()) for d in got[3][12:]) > 0:
                raise RuntimeError("kernel 2 (bf16): g_nets gradients "
                                   "vanish under saturated diffusion")
        print("kernels 1, 2 (bf16): two calls agree bitwise", flush=True)
        ms = median_cuda_ms(lambda: LF.fused_solve_backward_cuda(*timed), 20)
        plain_ms = median_cuda_ms(
            lambda: LF.fused_solve_backward_plain(*timed), 3, warmup=1)
        parts = backward_parts("kernel 2 (bf16)", timed, False, 10)
    moved = [*timed[:5], *timed[5], *timed[6:], *outputs]
    bnd = bf16_bound(3 * flops, moved)
    print(f"kernel 2 (bf16): median {ms:.4f} ms; plain: median "
          f"{plain_ms:.4f} ms; bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}; bytes {bytes_ms(moved):.4f} ms; at the "
          f"float32 FMA rate {bnd['fma_bound_ms']:.4f} ms)", flush=True)
    sass = sass_counts(_build.library_path()[0], BF16_SASS)
    print("kernels 1-4 (bf16) SASS opcodes: " + json.dumps(sass),
          flush=True)
    out["fwd"]["sass"] = {k: sass[k] for k in ("forward", "forward_one_block")
                          } if sass else None
    out["bwd"] = dict(max_abs_err=errs[0][0], max_abs_err_saturated=errs[1][0],
                      max_rel_err=max(e[1] for e in errs),
                      rounding_ratio=min(e[2] for e in errs), ms=ms,
                      plain_ms=plain_ms, sass=sass, **parts, **bnd)
    return out


def phase_bf16_multi_kernels(device):
    """Kernel 3 in bf16 at each K of MULTI_KS, 4 at K = MULTI_K: against
    their plain versions and the float32 reference (with the floor of
    their roundings), each replica bitwise kernels 1 and 2 (bf16) on its
    own inputs, two sweeps bitwise equal; median times and bounds, kernel
    3's shared memory and blocks an SM."""
    lib = _build.load_library()
    forward_ks, errs = {}, {}
    with torch.no_grad():
        for Kt in MULTI_KS:
            a_t, w_t = multi_kernel_inputs(device, Kt, dtype=BF16)
            ra_t, rw_t = bf16_reference(a_t, w_t)
            got = LF.fused_solve_multi_forward_cuda(*a_t, w_t)
            want = LF.fused_solve_multi_forward_plain(*a_t, w_t)
            ref = LF.fused_solve_multi_forward_plain(*ra_t, rw_t)
            torch.cuda.synchronize()
            err = errs[Kt] = check_bf16(f"kernel 3 (bf16) at K={Kt}",
                                        ("zs", "qs"), got, want, ref,
                                        (BF16, torch.float32))
            for k in range(Kt):
                a_k, w_k = replica(a_t, w_t, k)
                same_bits(f"kernel 3 (bf16) at K={Kt}, replica {k}, and "
                          f"kernel 1", [t[k] for t in got],
                          LF.fused_solve_forward_cuda(*a_k, w_k))
            forward_ks[str(Kt)] = dict(
                max_rel_err=err[1], rounding_ratio=err[2],
                blocks_per_sm=lib.tsde_latent_fused_fwd_blocks_per_sm_bf16(
                    Kt, BATCH, LATENT, CONTEXT, HIDDEN, device.index or 0))
            del a_t, w_t, ra_t, rw_t, got, want, ref
    print(f"kernel 3 (bf16) at K = {', '.join(map(str, MULTI_KS))}: on the "
          f"bars, every replica bitwise kernel 1; {json.dumps(forward_ks)}",
          flush=True)
    K = MULTI_K
    args, weights = multi_kernel_inputs(device, K, dtype=BF16)
    n = args[3].shape[1]
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    gz = torch.randn((K, n, BATCH, LATENT), generator=gen,
                     device=device).to(BF16)
    gq = torch.randn((K, n, BATCH, 1), generator=gen, device=device)
    r_args, r_w = bf16_reference(args, weights)
    flops = K * solve_flops(BATCH, LATENT, CONTEXT, HIDDEN, n)
    err3 = errs[K]
    with torch.no_grad():
        got = LF.fused_solve_multi_forward_cuda(*args, weights)
        bargs = (*args, weights, got[0], gz, gq)
        got_b = LF.fused_solve_multi_backward_cuda(*bargs)
        want_b = LF.fused_solve_multi_backward_plain(*bargs)
        ref_b = LF.fused_solve_multi_backward_plain(
            *r_args, r_w, got[0].float(), gz.float(), gq)
        torch.cuda.synchronize()
        err4 = check_bf16("kernel 4 (bf16)", GRAD_NAMES, _flat(got_b),
                          _flat(want_b), _flat(ref_b), GRAD_DTYPES)
        del want_b, ref_b
        same_bits("kernel 4 (bf16): two sweeps", _flat(got_b),
                  _flat(LF.fused_solve_multi_backward_cuda(*bargs)))
        for k in range(K):
            a_k, w_k = replica(args, weights, k)
            one_b = LF.fused_solve_backward_cuda(*a_k, w_k, got[0][k], gz[k],
                                                 gq[k])
            same_bits(f"kernel 4 (bf16) replica {k} and kernel 2",
                      [t[k] for t in _flat(got_b)], _flat(one_b))
        print(f"kernel 4 (bf16) at K={K}: every replica bitwise kernel 2; "
              f"two sweeps bitwise", flush=True)
        parts4 = backward_parts(f"kernel 4 (bf16) at K={K}", bargs, True, 5)
        times = dict(
            fwd=(median_cuda_ms(lambda: LF.fused_solve_multi_forward_cuda(
                *args, weights), 10),
                median_cuda_ms(lambda: LF.fused_solve_multi_forward_plain(
                    *args, weights), 2, warmup=1)),
            bwd=(median_cuda_ms(lambda: LF.fused_solve_multi_backward_cuda(
                *bargs), 10),
                median_cuda_ms(lambda: LF.fused_solve_multi_backward_plain(
                    *bargs), 2, warmup=1)))
    out = {}
    for kind, err, work, tensors in (
            ("fwd", err3, flops, [*args, *weights, *got]),
            ("bwd", err4, 3 * flops, [*bargs[:5], *weights, *bargs[6:],
                                      *_flat(got_b)])):
        bnd = bf16_bound(work, tensors)
        ms, plain_ms = times[kind]
        print(f"kernel {3 if kind == 'fwd' else 4} (bf16) at K={K}: median "
              f"{ms:.4f} ms; plain: median {plain_ms:.4f} ms; bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; bytes "
              f"{bytes_ms(tensors):.4f} ms; at the float32 FMA rate "
              f"{bnd['fma_bound_ms']:.4f} ms)", flush=True)
        out[kind] = dict(max_abs_err=err[0], max_rel_err=err[1],
                         rounding_ratio=err[2], ms=ms, plain_ms=plain_ms,
                         **(parts4 if kind == "bwd" else
                            dict(by_K=forward_ks)), **bnd)
    return out


def grad_cosine(got, want):
    num = sum(float((got[n].double() * want[n].double()).sum()) for n in got)
    na = sum(float((got[n].double() ** 2).sum()) for n in got) ** 0.5
    nb = sum(float((want[n].double() ** 2).sum()) for n in got) ** 0.5
    return num / (na * nb)


def loss_and_grads(model, xs, ts, seed, dt, fused):
    """One ELBO's loss and parameter gradients on a generator seed."""
    gen = torch.Generator(device=xs.device).manual_seed(seed)
    loss, _ = latent_sde_loss(model, xs, ts, gen, dt=dt, kl_weight=1.0,
                              fused=fused)
    loss.backward()
    grads = {name: p.grad.detach().clone()
             for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def route_gap(a, b):
    """The relative loss difference of two (loss, gradients) and the
    cosine of their gradients."""
    return (abs(float(a[0]) - float(b[0])) / abs(float(b[0])),
            grad_cosine(a[1], b[1]))


def widened(model, device):
    """A float32 flagship model holding a bf16 one's weights, widened."""
    ref = flagship_model(device)
    ref.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    return ref


def phase_bf16_routes(device, xs, ts):
    """The bf16 routes on the JAX package's bars: at its test's size, the
    fused route against the sdeint route for each of BF16_JAX_SEEDS; at the
    flagship, the fused route against a float32-state reference (a float32
    model on the widened weights and the same draws, which the card makes
    as the bf16 draws unrounded: checked first) for each of
    BF16_FLAGSHIP_SEEDS at each of BF16_FLAGSHIP_DTS, with the sdeint
    route's distances from both printed. Every bf16 loss and gradient in
    its dtype and finite."""
    for shape in [(round(1 / dt), BATCH, LATENT + 1)
                  for dt in BF16_FLAGSHIP_DTS] + [(BATCH, LATENT)]:
        a = torch.randn(shape, device=device, dtype=BF16,
                        generator=torch.Generator(device).manual_seed(7))
        b = torch.randn(shape, device=device,
                        generator=torch.Generator(device).manual_seed(7))
        if not torch.equal(a, b.to(BF16)):
            raise RuntimeError("bf16 draws are not the float32 draws "
                               "rounded: no float32-state reference")

    def run(model, xs, ts, seed, dt, fused, dtype=BF16):
        out = loss_and_grads(model, xs, ts, seed, dt, fused)
        want = torch.float32 if fused or dtype != BF16 else BF16
        bad = [n for n, t in out[1].items()
               if t.dtype != dtype or not torch.isfinite(t.float()).all()]
        if out[0].dtype != want or not torch.isfinite(out[0]) or bad:
            raise RuntimeError(f"bf16 routes: loss {out[0].dtype} (not "
                               f"{want}) or gradients {bad} not finite "
                               f"{dtype}")
        return out

    data, latent, context, hidden = BF16_JAX_WIDTHS
    jax_ts = np.linspace(0.0, 1.0, BF16_JAX_TIMES)
    small = []
    for seed in BF16_JAX_SEEDS:
        model = LatentSDE(data, latent, context, hidden, dtype=BF16,
                          device=device,
                          generator=torch.Generator().manual_seed(seed))
        jax_xs = torch.randn(
            (BF16_JAX_TIMES, BF16_JAX_BATCH, data), device=device,
            generator=torch.Generator(device).manual_seed(seed)).to(BF16)
        small.append(route_gap(
            *(run(model, jax_xs, jax_ts, seed, BF16_JAX_DT, fused)
              for fused in (True, False))))
    print("bf16 routes at the JAX test's size, fused vs sdeint (loss rel "
          "diff, gradient cosine): " + "; ".join(
              f"seed {s} {r:.3e} {c:.6f}"
              for s, (r, c) in zip(BF16_JAX_SEEDS, small)), flush=True)
    model = flagship_model(device, BF16)
    ref_model = widened(model, device)
    xs_bf = xs.to(BF16)
    flag = {}
    for dt in BF16_FLAGSHIP_DTS:
        for seed in BF16_FLAGSHIP_SEEDS:
            fused = run(model, xs_bf, ts, seed, dt, True)
            plain = run(model, xs_bf, ts, seed, dt, False)
            ref = run(ref_model, xs_bf.float(), ts, seed, dt, True,
                      torch.float32)
            flag[dt, seed] = dict(ref=route_gap(fused, ref),
                                  sdeint_ref=route_gap(plain, ref),
                                  sdeint=route_gap(fused, plain))
            print(f"bf16 routes at the flagship, dt 1/{round(1 / dt)}, seed "
                  f"{seed}: loss fused {float(fused[0]):.8g} (float32), "
                  f"sdeint {float(plain[0]):.8g} (bf16), float32 reference "
                  f"{float(ref[0]):.8g}; (loss rel diff, gradient cosine) "
                  + ", ".join(f"{k} {r:.3e} {c:.6f}"
                              for k, (r, c) in flag[dt, seed].items()),
                  flush=True)
    worst = dict(
        jax_size=(max(r for r, _ in small), min(c for _, c in small)),
        **{k: (max(v[k][0] for v in flag.values()),
               min(v[k][1] for v in flag.values()))
           for k in ("ref", "sdeint_ref", "sdeint")})
    print("bf16 routes, worst (loss rel diff, gradient cosine): " + ", ".join(
        f"{k} {r:.3e} {c:.6f}" for k, (r, c) in worst.items()), flush=True)
    for k in ("jax_size", "ref"):
        r, c = worst[k]
        if not (r <= BF16_ROUTE_RTOL and c > BF16_ROUTE_COS):
            raise RuntimeError(f"bf16 routes ({k}): loss {r:.3e} > "
                               f"{BF16_ROUTE_RTOL} or cosine {c:.6f} <= "
                               f"{BF16_ROUTE_COS}")
    return {f"{k}_loss_rel_err": v[0] for k, v in worst.items()} | {
        f"{k}_grad_cosine": v[1] for k, v in worst.items()}


def phase_bf16_train(device, xs, ts):
    """The bf16 flagship on both routes: BF16_STEPS Adam steps of each in
    turns, each fused step launching kernels 1 and 2 in bf16 once and the
    float32 kernels never; medians and profiles."""
    xs = xs.to(BF16)
    models = {route: flagship_model(device, BF16) for route in ROUTES}
    opts = {route: torch.optim.Adam(model.parameters(), lr=LR)
            for route, model in models.items()}
    times = {route: [] for route in ROUTES}
    reset_latent_counts()
    for step in range(BF16_STEPS):
        for route in (ROUTES if step % 2 == 0 else ROUTES[::-1]):
            before = bf16_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = train_step(models[route], opts[route], xs, ts, route,
                              410 + step, min(1.0, step / KL_ANNEAL))
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3)
            delta = tuple(a - b for a, b in zip(bf16_counts(), before))
            want = ((1, 1) if route == "fused" else (0, 0)) + (0,) * 6
            if delta != want:
                raise RuntimeError(f"bf16 {route} step {step}: kernels "
                                   f"launched {delta} times, not {want}")
            if not (np.isfinite(float(loss)) and all(
                    torch.isfinite(p.grad.float()).all()
                    for p in models[route].parameters())):
                raise RuntimeError(f"bf16 {route} step {step}: non-finite "
                                   f"loss or gradient")
            print(f"train bf16 {route} step {step}: loss {float(loss):.8g} "
                  f"{times[route][-1]:.3f} ms", flush=True)
    launches = (LF.bf16_launches, LF.bf16_bwd_launches)
    medians = {route: float(np.median(t)) for route, t in times.items()}
    profiles = {route: profile_run(f"bf16 train step {route}", lambda r=route:
                                   train_step(models[r], opts[r], xs, ts, r,
                                              420, 1.0),
                                   cpu=route == "fused")
                for route in ROUTES}
    for route in ROUTES:
        print(f"bf16 train step {route}: median {medians[route]:.3f} ms "
              f"over {BF16_STEPS} steps (host clock, synchronised); "
              f"profiled: {profiles[route]['kernels']} kernels, device "
              f"{profiles[route]['device_ms']:.3f} ms, busy "
              f"{profiles[route]['busy']:.3f}", flush=True)
    return launches, dict(step_ms=medians,
                          step_device_ms={r: p["device_ms"]
                                          for r, p in profiles.items()},
                          step_kernels={r: p["kernels"]
                                        for r, p in profiles.items()})


def phase_bf16_multi_path(device, xs, ts):
    """latent_sde_loss_multi(fused=True) on K = MULTI_K bf16 replicas: each
    replica's served loss against the single fused route on a clone of its
    generator; two Adam steps on the stacked state, each launching kernels
    3 and 4 in bf16 once and no other kernel of the solve; a third under
    the profiler, for its device time."""
    K = MULTI_K
    xs = xs.to(BF16)
    models = stacked_replicas(device, K, BF16)
    gens = replica_generators(device, 750, K)
    clones = []
    for g in gens:
        clones.append(torch.Generator(device=device))
        clones[-1].set_state(g.get_state())
    with torch.no_grad():
        _, losses = latent_sde_loss_multi(models, xs, ts, gens, dt=DT,
                                          fused=True)
        want = [float(latent_sde_loss(RP.unstack_replica(models, k), xs, ts,
                                      clones[k], dt=DT, fused=True)[0])
                for k in range(K)]
    got = [float(v) for v in losses]
    worst = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    print(f"bf16 multi serve: losses {['%.8g' % v for v in got]} vs single "
          f"{['%.8g' % v for v in want]}, worst rel diff {worst:.3e}",
          flush=True)
    if losses.dtype != torch.float32 or not worst <= BF16_ROUTE_RTOL:
        raise RuntimeError(f"bf16 multi losses ({losses.dtype}) differ from "
                           f"the single fused losses by {worst:.3e}")
    opt = torch.optim.Adam(models.parameters(), lr=LR)
    times = []
    reset_latent_counts()
    for i in range(2):
        before = bf16_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        total, losses = latent_sde_loss_multi(
            models, xs, ts, replica_generators(device, 760 + i, K), dt=DT,
            fused=True)
        total.backward()
        opt.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        delta = tuple(a - b for a, b in zip(bf16_counts(), before))
        if delta != (0, 0, 1, 1, 0, 0, 0, 0):
            raise RuntimeError(f"bf16 multi step {i}: kernels launched "
                               f"{delta} times")
        if not (torch.isfinite(losses).all() and all(
                p.grad.dtype == BF16 and torch.isfinite(p.grad.float()).all()
                for p in models.parameters() if p.grad is not None)):
            raise RuntimeError(f"bf16 multi step {i}: non-finite loss or "
                               f"gradient, or not bf16")
        print(f"train bf16 multi fused step {i}: losses "
              f"{[round(float(v), 3) for v in losses.detach()]} "
              f"{times[-1]:.3f} ms",
              flush=True)

    def step():
        opt.zero_grad(set_to_none=True)
        total, _ = latent_sde_loss_multi(
            models, xs, ts, replica_generators(device, 770, K), dt=DT,
            fused=True)
        total.backward()
        opt.step()

    prof = profile_run("bf16 multi fused train step", step)
    return (LF.bf16_multi_launches, LF.bf16_multi_bwd_launches), dict(
        loss_rel_err=worst, step_ms=float(np.median(times)),
        step_device_ms=prof["device_ms"])


# --------------------------------------------------------------------------- #
#  bf16 mixed mode of the SDE-GAN kernels 5-8                                 #
# --------------------------------------------------------------------------- #

# The bf16 SDE-GAN's routes, on the JAX package's bars for its fused against
# its XLA route at the same bf16 weights (tests/test_fused_gan.py:211-216):
# the loss within 2e-2 absolutely (a Wasserstein difference of O(1) critic
# scores, near zero), the cosine of all parameter gradients above 0.999.
# At that test's size (Generator(1, 5, 3, 16, 16, 1), Discriminator(1, 16,
# 16, 1), batch 8, 6 times at dt 1) the fused route is held to the sdeint
# route for each of GAN_BF16_JAX_SEEDS. At the reference scale the hidden
# states grow to 80-100, where a bf16 ulp is 0.5, and the sdeint route's
# loss is a bf16 number (an ulp of 1.6e-2 at 3.4): no oracle. There the
# fused route is held, for each of GAN_BF16_REF_SEEDS, to a float32-state
# reference (float32 models on the widened weights, fused, on the same
# draws unrounded) on the same bars, and its fake paths within
# GAN_BF16_PATH_REL of their largest value (x0 comes out of the bf16
# initial MLP and each step rounds the towers' inputs); the sdeint route's
# distances are printed. Measured on the CPU with the plain versions
# (seeds 300-302): the loss 2.5e-5 to 5.9e-3 apart, the cosine 1 - 2.4e-6,
# the paths 1.6e-2 to 2.3e-2 of their scale; the sdeint route 6.5e-2 to
# 1.3e-1, 1 - 7.3e-5, 6.0e-2.
GAN_BF16_LOSS_ATOL, GAN_BF16_COS, GAN_BF16_PATH_REL = 2e-2, 0.999, 2 ** -4
GAN_BF16_JAX_BATCH, GAN_BF16_JAX_T, GAN_BF16_JAX_HIDDEN = 8, 6, 16
GAN_BF16_JAX_SEEDS = range(8)
GAN_BF16_REF_SEEDS = range(300, 303)
GAN_BF16_STEPS = 3
GEN_GRAD_NAMES = ("dx0", "df0", "dg0", "dnoise") + GF.GEN_WEIGHT_NAMES
GEN_GRAD_DTYPES = (torch.float32,) * 3 + (BF16,) * 9
CDE_GRAD_NAMES = ("dh0", "df0", "dslopes") + GF.CDE_WEIGHT_NAMES
CDE_GRAD_DTYPES = (torch.float32,) * 3 + (BF16,) * 4
BF16_GAN_COUNTERS = ("bf16_gen_launches", "bf16_gen_bwd_launches",
                     "bf16_cde_launches", "bf16_cde_bwd_launches")


def bf16_gan_counts():
    """Launches of kernels 5-8 in bf16, then of the float32 ones."""
    return tuple(getattr(GF, c) for c in BF16_GAN_COUNTERS + GAN_COUNTERS)


def check_bf16_gan_kernel(label, names, dtypes, run_cuda, run_plain, args,
                          weights, extra=()):
    """A bf16 GAN kernel (``run_cuda(*args, weights, *extra)``) against its
    mixed-mode twin (``run_plain``), the float32 reference (the twin on the
    weights and noise widened) and the floor of its roundings (a float64
    stand-in must miss it); two calls bitwise equal. Returns its outputs
    and check_bf16's errors."""
    got = run_cuda(*args, weights, *extra)
    flat = flat_grads if isinstance(got[-1], tuple) else list
    same_bits(f"{label}: two calls", flat(got),
              flat(run_cuda(*args, weights, *extra)))
    want = run_plain(*args, weights, *extra)
    ref = run_plain(*double(args, torch.float32),
                    tuple(w.float() for w in weights), *extra)
    stand_in = run_plain(*double(args), tuple(w.double() for w in weights),
                         *double(extra))
    torch.cuda.synchronize()
    err = check_bf16(label, names, flat(got), flat(want), flat(ref), dtypes,
                     flat(stand_in))
    return got, err


def phase_bf16_gan_kernels(device, ts, real):
    """Kernels 5-8 in bf16 mixed mode at the reference scale, on the inputs
    of bf16 models (gan_kernel_inputs), each against its mixed-mode twin
    and the float32 reference with the floor of its roundings (kernel 8 on
    last-state and on dense cotangents); two calls bitwise equal; median
    times at GAN_THREADS and bounds (bf16 bytes, the bf16 peak)."""
    (gen_args, gen_w), (cde_args, cde_w) = gan_kernel_inputs(
        device, gan_models(device, BF16), ts, real.to(BF16))
    B, S, M, m, n = GF.check_gen_inputs(*gen_args, gen_w)
    Bc, Sc, Mc, C, _ = GF.check_cde_inputs(*cde_args, cde_w)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    out = {}

    def record(key, label, err, run_cuda, run_plain, tensors, flops,
               plain_reps):
        timed = time_gan_kernel(label, run_cuda, run_plain, tensors, flops,
                                plain_reps, PEAK_BF16_FLOPS)
        fma = flops / PEAK_F32_FLOPS * 1e3
        print(f"{label}: bytes {bytes_ms(tensors):.5f} ms; at the float32 "
              f"FMA rate {fma:.5f} ms", flush=True)
        out[key] = dict(max_abs_err=err[0], max_rel_err=err[1],
                        rounding_ratio=err[-1], fma_bound_ms=fma, **timed)

    with torch.no_grad():
        fwd, err = check_bf16_gan_kernel(
            "kernel 5 (bf16)", ("ys", "zs", "gs"), (torch.float32,) * 3,
            GF.gen_solve_forward_cuda, GF.gen_solve_forward_plain, gen_args,
            gen_w)
        record("gen_fwd", "kernel 5 (bf16)", err,
               lambda t: GF.gen_solve_forward_cuda(*gen_args, gen_w,
                                                   threads=t),
               lambda: GF.gen_solve_forward_plain(*gen_args, gen_w),
               [*gen_args, *gen_w, *fwd], gen_flops(B, S, M, m, n), 5)
        gy = torch.randn(fwd[0].shape, generator=gen, device=device)
        extra = (fwd[1], fwd[2], gy)
        bwd, err = check_bf16_gan_kernel(
            "kernel 6 (bf16)", GEN_GRAD_NAMES, GEN_GRAD_DTYPES,
            GF.gen_solve_backward_cuda, GF.gen_solve_backward_plain,
            gen_args, gen_w, extra)
        record("gen_bwd", "kernel 6 (bf16)", err,
               lambda t: GF.gen_solve_backward_cuda(*gen_args, gen_w, *extra,
                                                    threads=t),
               lambda: GF.gen_solve_backward_plain(*gen_args, gen_w, *extra),
               [*gen_args[2:], *gen_w, *extra, *flat_grads(bwd)],
               gen_bwd_flops(B, S, M, m, n), 3)
        fwd, err = check_bf16_gan_kernel(
            "kernel 7 (bf16)", ("hs", "zs"), (torch.float32,) * 2,
            GF.cde_solve_forward_cuda, GF.cde_solve_forward_plain, cde_args,
            cde_w)
        record("cde_fwd", "kernel 7 (bf16)", err,
               lambda t: GF.cde_solve_forward_cuda(*cde_args, cde_w,
                                                   threads=t),
               lambda: GF.cde_solve_forward_plain(*cde_args, cde_w),
               [*cde_args, *cde_w, *fwd], cde_flops(Bc, Sc, Mc, C, n), 5)
        last = torch.zeros_like(fwd[0])
        last[-1] = torch.randn(fwd[0].shape[1:], generator=gen,
                               device=device)
        dense = torch.randn(fwd[0].shape, generator=gen, device=device)
        errs = []
        for label, ghs in (("last-state", last), ("dense", dense)):
            bwd, err = check_bf16_gan_kernel(
                f"kernel 8 (bf16), {label} cotangents,", CDE_GRAD_NAMES,
                CDE_GRAD_DTYPES, GF.cde_solve_backward_cuda,
                GF.cde_solve_backward_plain, cde_args, cde_w, (fwd[1], ghs))
            errs.append(err)
        extra = (fwd[1], last)
        record("cde_bwd", "kernel 8 (bf16)",
               (errs[0][0], max(e[1] for e in errs),
                min(e[-1] for e in errs)),
               lambda t: GF.cde_solve_backward_cuda(*cde_args, cde_w, *extra,
                                                    threads=t),
               lambda: GF.cde_solve_backward_plain(*cde_args, cde_w, *extra),
               [*cde_args[2:], *cde_w, *extra, *flat_grads(bwd)],
               cde_bwd_flops(Bc, Sc, Mc, C, n), 3)
        out["cde_bwd"]["max_abs_err_dense"] = errs[1][0]
    # Kernels 6 and 8's bf16 sweeps on tensor cores: the instantiation
    # (100 channels + 10 state tiles + hidden tiles), shared memory a
    # block, ptxas's registers and spills of every instantiation, and the
    # SASS of the reference's.
    lib = _build.load_library()
    sass = sass_counts(_build.library_path()[0], BF16_SASS)
    for key, widths in (("gen_bwd", (S, M, m)), ("cde_bwd", (Sc, Mc, C))):
        name = f"gan_{key}"
        out[key].update(
            design=getattr(lib, f"tsde_{name}_design_bf16")(*widths),
            smem_bytes=getattr(lib, f"tsde_{name}_smem_bytes_bf16")(
                *widths, GF.THREADS),
            ptxas=ptxas_info(f"{name}_bf16"),
            sass=sass[name] if sass else None)
        print(f"kernel {6 if key == 'gen_bwd' else 8} (bf16) on tensor "
              f"cores: " + json.dumps({k: out[key][k] for k in (
                  "design", "smem_bytes", "ptxas", "sass")}), flush=True)
    return out


def gan_loss_and_grads(models, ts, real, seed, fused, want_dtype):
    """gan_grads on a generator seed (adjoint=False): the loss, every
    gradient by name and the fake paths of the same draws, each checked
    finite and in its dtype (the loss ``want_dtype``, the gradients the
    models')."""
    generator, critic = models
    loss, g_gen, g_disc = gan_grads(
        generator, critic, torch.Generator(device=real.device).manual_seed(
            seed), ts, real, dt=GAN_DT, adjoint=False, fused=fused)
    with torch.no_grad():
        fake = generator(torch.Generator(device=real.device).manual_seed(
            seed), ts, real.shape[0], dt=GAN_DT, adjoint=False, fused=fused)
    grads = {**{f"generator.{k}": v for k, v in g_gen.items()},
             **{f"critic.{k}": v for k, v in g_disc.items()}}
    dtype = generator.readout.w.dtype
    bad = [k for k, g in grads.items()
           if g.dtype != dtype or not torch.isfinite(g.float()).all()]
    if loss.dtype != want_dtype or not torch.isfinite(loss) or bad:
        raise RuntimeError(f"bf16 GAN routes: loss {loss.dtype} (not "
                           f"{want_dtype}) or gradients {bad} not finite "
                           f"{dtype}")
    return loss, grads, fake


def gan_route_gap(a, b):
    """The absolute loss difference of two gan_loss_and_grads and the
    cosine of their gradients."""
    return abs(float(a[0]) - float(b[0])), grad_cosine(a[1], b[1])


def phase_bf16_gan_routes(device, ts, real):
    """The bf16 SDE-GAN's routes on the JAX package's bars: at its test's
    size the fused route against the sdeint route for each of
    GAN_BF16_JAX_SEEDS; at the reference scale the fused route against the
    float32-state reference (whose draws the card makes as the bf16 draws
    unrounded: checked first), and the fake paths, for each of
    GAN_BF16_REF_SEEDS, the sdeint route's distances printed."""
    for shape in ((GAN_BATCH, GAN_INIT_NOISE),
                  (GAN_T - 1, GAN_BATCH, GAN_NOISE)):
        a = torch.randn(shape, device=device, dtype=BF16,
                        generator=torch.Generator(device).manual_seed(7))
        b = torch.randn(shape, device=device,
                        generator=torch.Generator(device).manual_seed(7))
        if not torch.equal(a, b.to(BF16)):
            raise RuntimeError("bf16 draws are not the float32 draws "
                               "rounded: no float32-state reference")
    small = []
    B, T, H = GAN_BF16_JAX_BATCH, GAN_BF16_JAX_T, GAN_BF16_JAX_HIDDEN
    for seed in GAN_BF16_JAX_SEEDS:
        init = torch.Generator().manual_seed(seed)
        models = (Generator(GAN_DATA, GAN_INIT_NOISE, GAN_NOISE, H, GAN_MLP,
                            GAN_LAYERS, dtype=BF16, device=device,
                            generator=init),
                  Discriminator(GAN_DATA, H, GAN_MLP, GAN_LAYERS, dtype=BF16,
                                device=device, generator=init))
        jax_ts, data = get_ou_data(
            torch.Generator(device).manual_seed(seed), B, T, device=device)
        data = data.to(BF16)
        small.append(gan_route_gap(
            gan_loss_and_grads(models, jax_ts, data, seed, True,
                               torch.float32),
            gan_loss_and_grads(models, jax_ts, data, seed, False, BF16)))
    print("bf16 GAN routes at the JAX test's size, fused vs sdeint (loss "
          "abs diff, gradient cosine): " + "; ".join(
              f"seed {s} {d:.3e} {c:.6f}"
              for s, (d, c) in zip(GAN_BF16_JAX_SEEDS, small)), flush=True)
    models = gan_models(device, BF16)
    ref_models = gan_models(device)
    for ref, bf in zip(ref_models, models):
        ref.load_state_dict({k: v.float() for k, v in bf.state_dict().items()})
    batch = real.to(BF16)
    big = {}
    for seed in GAN_BF16_REF_SEEDS:
        fused = gan_loss_and_grads(models, ts, batch, seed, True,
                                   torch.float32)
        plain = gan_loss_and_grads(models, ts, batch, seed, False, BF16)
        ref = gan_loss_and_grads(ref_models, ts, batch.float(), seed, True,
                                 torch.float32)
        scale = float(ref[2][..., 1:].abs().max())
        paths = {k: float((r[2][..., 1:].float() - ref[2][..., 1:]).abs()
                          .max()) / scale
                 for k, r in (("fused", fused), ("sdeint", plain))}
        big[seed] = dict(ref=gan_route_gap(fused, ref),
                         sdeint_ref=gan_route_gap(plain, ref),
                         sdeint=gan_route_gap(fused, plain), paths=paths)
        print(f"bf16 GAN routes at the reference scale, seed {seed}: loss "
              f"fused {float(fused[0]):.8g} (float32), sdeint "
              f"{float(plain[0]):.8g} (bf16), float32 reference "
              f"{float(ref[0]):.8g}; (loss abs diff, gradient cosine) "
              + ", ".join(f"{k} {d:.3e} {c:.6f}" for k, (d, c) in
                          big[seed].items() if k != "paths")
              + f"; fake paths from the reference, of their scale "
              f"{scale:.4g}: fused {paths['fused']:.3e}, sdeint "
              f"{paths['sdeint']:.3e}", flush=True)
    worst = dict(
        jax_size=(max(d for d, _ in small), min(c for _, c in small)),
        **{k: (max(v[k][0] for v in big.values()),
               min(v[k][1] for v in big.values()))
           for k in ("ref", "sdeint_ref", "sdeint")})
    path_rel = {k: max(v["paths"][k] for v in big.values())
                for k in ("fused", "sdeint")}
    print("bf16 GAN routes, worst (loss abs diff, gradient cosine): "
          + ", ".join(f"{k} {d:.3e} {c:.6f}" for k, (d, c) in worst.items())
          + f"; fake paths of scale: fused {path_rel['fused']:.3e}, sdeint "
          f"{path_rel['sdeint']:.3e}", flush=True)
    for k in ("jax_size", "ref"):
        d, c = worst[k]
        if not (d <= GAN_BF16_LOSS_ATOL and c > GAN_BF16_COS):
            raise RuntimeError(f"bf16 GAN routes ({k}): loss {d:.3e} > "
                               f"{GAN_BF16_LOSS_ATOL} or cosine {c:.6f} <= "
                               f"{GAN_BF16_COS}")
    if not path_rel["fused"] <= GAN_BF16_PATH_REL:
        raise RuntimeError(f"bf16 GAN fake paths {path_rel['fused']:.3e} of "
                           f"their scale from the float32-state reference "
                           f"> {GAN_BF16_PATH_REL}")
    return {f"{k}_loss_abs_err": v[0] for k, v in worst.items()} | {
        f"{k}_grad_cosine": v[1] for k, v in worst.items()} | {
        f"{k}_path_rel_err": v for k, v in path_rel.items()}


def phase_bf16_gan_train(device, ts, real):
    """GAN_BF16_STEPS training steps of the bf16 SDE-GAN on each route in
    turns (Adadelta as examples/sde_gan.py, the critic's clip), each fused
    step launching kernels 5-8 in bf16 once and the float32 ones never;
    medians and a profile of each route. The counts restart at 0 here: the
    path's run."""
    trained = {}
    for route in ROUTES:
        generator, critic = gan_models(device, BF16)
        opts = (torch.optim.Adadelta(generator.parameters(), lr=GAN_GEN_LR,
                                     weight_decay=GAN_WEIGHT_DECAY),
                torch.optim.Adadelta(critic.parameters(), lr=GAN_CRITIC_LR,
                                     weight_decay=GAN_WEIGHT_DECAY))
        trained[route] = ((generator, critic), opts)
    perm = torch.Generator(device=device).manual_seed(SEED + 9)
    times = {route: [] for route in ROUTES}
    for c in BF16_GAN_COUNTERS + GAN_COUNTERS:
        setattr(GF, c, 0)
    for step in range(GAN_BF16_STEPS):
        batch = real[torch.randperm(real.shape[0], generator=perm,
                                    device=device)[:GAN_BATCH]].to(BF16)
        for route in (ROUTES if step % 2 == 0 else ROUTES[::-1]):
            models, opts = trained[route]
            before = bf16_gan_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = gan_train_step(models, opts, ts, batch, 900 + step,
                                         route == "fused")
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3)
            delta = tuple(a - b for a, b in zip(bf16_gan_counts(), before))
            want = ((1,) * 4 if route == "fused" else (0,) * 4) + (0,) * 4
            if delta != want:
                raise RuntimeError(f"bf16 GAN {route} step {step}: kernels "
                                   f"launched {delta} times, not {want}")
            if not (np.isfinite(float(loss)) and all(
                    g.dtype == BF16 and torch.isfinite(g.float()).all()
                    for g in grads)):
                raise RuntimeError(f"bf16 GAN {route} step {step}: "
                                   f"non-finite loss or gradient, or not "
                                   f"bf16")
            check_clipped(models[1])
            print(f"train bf16 GAN {route} step {step}: loss "
                  f"{float(loss):.8g} ({loss.dtype}) "
                  f"{times[route][-1]:.3f} ms", flush=True)
    launches = bf16_gan_counts()[:4]
    medians = {route: float(np.median(t)) for route, t in times.items()}
    profiles = {route: profile_run(
        f"bf16 GAN train step {route}", lambda r=route: gan_train_step(
            *trained[r], ts, batch, 910, r == "fused"), cpu=route == "fused")
        for route in ROUTES}
    for route in ROUTES:
        print(f"bf16 GAN train step {route}: median {medians[route]:.3f} ms "
              f"over {GAN_BF16_STEPS} steps (host clock, synchronised); "
              f"profiled: {profiles[route]['kernels']} kernels, device "
              f"{profiles[route]['device_ms']:.3f} ms, busy "
              f"{profiles[route]['busy']:.3f}", flush=True)
    return launches, dict(step_ms=medians,
                          step_device_ms={r: p["device_ms"]
                                          for r, p in profiles.items()},
                          step_kernels={r: p["kernels"]
                                        for r, p in profiles.items()})


# --------------------------------------------------------------------------- #
#  srid2 SRK (kernel 15) and Philox normals (kernel 16)                       #
# --------------------------------------------------------------------------- #

def srk_problem(device, B, d, dtype=torch.float32):
    """ExDiagonal at (B, d): mu and sigma as benchmarks/srk_fused.py:26-31
    draws them (sigma = sigmoid(N), mu = -sigma^2 - sigmoid(N)), from a
    numpy seed; y0 = 0.1; W and U from the default noise of a seeded
    generator on the step grid of [0, 1]."""
    rng = np.random.default_rng(SEED + 300 + d)
    sigma = 1 / (1 + np.exp(-rng.standard_normal(d)))
    mu = -sigma ** 2 - 1 / (1 + np.exp(-rng.standard_normal(d)))
    grid = TI.build_step_grid(0.0, 1.0, 1.0 / SRK_STEPS)
    gen = torch.Generator(device=device).manual_seed(SEED + 301)
    W, U, _ = TI.sample_grid_noise(gen, grid, (B, d), dtype, device,
                                   needs_U=True)
    y0 = torch.full((B, d), 0.1, dtype=dtype, device=device)
    params = tuple(torch.as_tensor(p, dtype=dtype, device=device)
                   for p in (mu, sigma))
    return y0, W, U, params, (mu, sigma)


SRK_F = SF.Elementwise(lambda t, y, mu, sigma: mu * y, "p0 * y")
SRK_G = SF.Elementwise(lambda t, y, mu, sigma: sigma * y, "p1 * y")


class GridTable(BaseBrownian):
    """Serves fixed W and U tables on a step grid to sdeint."""

    def __init__(self, W, U):
        self._W, self._U = W, U

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        raise NotImplementedError("GridTable serves whole grids only")

    def query_grid(self, grid, return_U=False, return_A=False):
        return self._W, self._U if return_U else None, None

    @property
    def shape(self):
        return tuple(self._W.shape[1:])

    @property
    def dtype(self):
        return self._W.dtype

    @property
    def levy_area_approximation(self):
        return "space-time"


def srk_sde(params):
    """diagnostics/problems.py's ExDiagonal (Ito, diagonal noise) with
    srk_problem's mu and sigma, in their dtype and on their device."""
    mu, sigma = params
    return ExDiagonal(mu.shape[0], mu=mu, sigma=sigma, dtype=mu.dtype,
                      device=mu.device)


def phase_srk_kernel(device):
    """Kernel 15 at the four configurations: against its plain version and
    a float64 run, its strong error against ExDiagonal's exact solution on
    the same W, once against sdeint(method='srk'), median times and the
    bytes bound; then one solve at full width counted as the main path."""
    dt = 1.0 / SRK_STEPS
    records = {}
    with torch.no_grad():
        for B, d in SRK_CONFIGS:
            y0, W, U, params, (mu, sigma) = srk_problem(device, B, d)
            args = (SRK_F, SRK_G, y0, 0.0, dt, SRK_STEPS, W, U, params)
            got = SF.srk_solve_cuda(*args)
            want = SF.srk_solve_plain(*args)
            exact = SF.srk_solve_plain(SRK_F, SRK_G, y0.double(), 0.0, dt,
                                       SRK_STEPS, W.double(), U.double(),
                                       tuple(p.double() for p in params))
            torch.cuda.synchronize()
            if got.shape != (B, d) or not torch.isfinite(got).all():
                raise RuntimeError(f"kernel 15 ({B}, {d}): shape "
                                   f"{tuple(got.shape)} or non-finite")
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            err64 = float((got.double() - exact).abs().max())
            plain64 = float((want.double() - exact).abs().max())
            # ExDiagonal's exact solution at t = 1 on the same Brownian path.
            mu_t, sig_t = (torch.as_tensor(v, device=device) for v in
                           (mu, sigma))
            W_T = W.double().sum(0)
            y_T = 0.1 * torch.exp(mu_t - 0.5 * sig_t ** 2 + sig_t * W_T)
            strong = float((got.double() - y_T).abs().mean())
            strong64 = float((exact - y_T).abs().mean())
            print(f"kernel 15 ({B}, {d}): max|plain| {scale:.4g}, max abs "
                  f"err {err:.3e} ({err / scale:.2e} of scale); from float64 "
                  f"{err64:.3e} (plain {plain64:.3e}); strong error vs exact "
                  f"{strong:.4e} (float64 plain {strong64:.4e})", flush=True)
            if err > SRK_REL * scale:
                raise RuntimeError(f"kernel 15 ({B}, {d}) differs from its "
                                   f"plain version by {err:.3e} > {SRK_REL} "
                                   f"* {scale:.4g}")
            ulp = float(torch.finfo(torch.float32).eps) * scale
            if err64 > 2 * plain64 + ulp:
                raise RuntimeError(f"kernel 15 ({B}, {d}) is {err64:.3e} from "
                                   f"float64, the plain version {plain64:.3e}")
            if not strong <= 1.01 * strong64 + ulp:
                raise RuntimeError(f"kernel 15 ({B}, {d}) strong error "
                                   f"{strong:.4e} > the float64 solve's "
                                   f"{strong64:.4e}")
            if (B, d) == SRK_CONFIGS[0]:
                sde = srk_sde(params)
                ys = sdeint(sde, y0, [0.0, 1.0], bm=GridTable(W, U),
                            method="srk", dt=dt)
                err_sdeint = float((ys[-1] - got).abs().max())
                print(f"kernel 15 ({B}, {d}) vs sdeint(method='srk') on the "
                      f"same W, U: max abs diff {err_sdeint:.3e}", flush=True)
                if err_sdeint > SRK_REL * scale:
                    raise RuntimeError(f"kernel 15 and sdeint(method='srk') "
                                       f"differ by {err_sdeint:.3e}")
            ms = median_cuda_ms(lambda: SF.srk_solve_cuda(*args), 20)
            plain_ms = median_cuda_ms(lambda: SF.srk_solve_plain(*args), 3,
                                      warmup=1)
            bound_ms, bound_by = bound(SRID2_FLOPS * B * d * SRK_STEPS,
                                       [y0, W, U, *params, got])
            print(f"kernel 15 ({B}, {d}): median {ms:.4f} ms; plain: median "
                  f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})",
                  flush=True)
            records[(B, d)] = dict(max_abs_err=err, max_rel_err=err / scale,
                                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, strong_error=strong,
                                   strong_error_f64_plain=strong64)
        # The path: one solve at full width.
        y0, W, U, params, _ = srk_problem(device, *SRK_CONFIGS[-1])
        SF.launches = 0
        out = SF.srk_solve_fused(SRK_F, SRK_G, y0, 0.0, dt, SRK_STEPS, W, U,
                                 params)
        torch.cuda.synchronize()
        launches = SF.launches
        if launches != 1 or not torch.isfinite(out).all():
            raise RuntimeError(f"srk_solve_fused launched kernel 15 "
                               f"{launches} times or gave non-finite values")
    wide = dict(records[SRK_CONFIGS[-1]])
    wide["ms_by_config"] = {f"{B}x{d}": r["ms"] for (B, d), r in
                            records.items()}
    wide["bound_ms_by_config"] = {f"{B}x{d}": r["bound_ms"] for (B, d), r in
                                  records.items()}
    wide["max_rel_err"] = max(r["max_rel_err"] for r in records.values())
    return launches, wide



def phase_srk_bf16_kernel(device):
    """Kernel 15 in bf16 at the four configurations and at SRK_ODD, on the
    float32 phase's inputs rounded to bf16: bitwise its bf16 plain
    version; its roundings shown present (no nearer the rounded float32
    solve than BF16_FLOOR of the plain version's distance, which the
    float32 kernel with only its result rounded misses); its distance from
    float64 printed; at (1024, 8) against sdeint(method='srk') in bf16;
    median times and the bf16 bound; then one bf16 solve at full width
    counted as the main path. First its bf16x2 instructions and operators
    against float32 rounded to bf16 over all operand pairs, and its SASS
    and ptxas counts."""
    dt = 1.0 / SRK_STEPS
    records = {}
    t0 = time.perf_counter()
    check = SF.bf16x2_check(SRK_F, SRK_G, 2, device)
    print(f"kernel 15 bf16x2 check over 2^32 operand pairs "
          f"({time.perf_counter() - t0:.1f} s with the build): "
          + json.dumps(check), flush=True)
    for op, c in check.items():
        if c["operator"] > SRK_BF16X2_DIFFS or (
                c["native"] and c["instruction"] > SRK_BF16X2_DIFFS):
            raise RuntimeError(f"kernel 15's bf16x2 {op} differs from "
                               f"float32 rounded to bf16: {c}")
    lib_path = _build.source_library_path(
        "tsde_srk_srid2", SF.srk_source(SRK_F.cuda_expr, SRK_G.cuda_expr, 2))
    sass = sass_counts(lib_path, "srid2_kernel_bf16x2")
    ptxas = ptxas_info("srid2_kernel_bf16x2")
    print(f"kernel 15 bf16 SASS opcodes: {json.dumps(sass)}; ptxas: "
          f"{json.dumps(ptxas)}", flush=True)
    with torch.no_grad():
        for B, d in SRK_CONFIGS + (SRK_ODD,):
            y0, W, U, params, _ = srk_problem(device, B, d)
            y0, W, U = (t.to(BF16) for t in (y0, W, U))
            params = tuple(p.to(BF16) for p in params)
            args = (SRK_F, SRK_G, y0, 0.0, dt, SRK_STEPS, W, U, params)
            got = SF.srk_solve_cuda(*args)
            want = SF.srk_solve_plain(*args)
            wide = (y0.float(), 0.0, dt, SRK_STEPS, W.float(), U.float(),
                    tuple(p.float() for p in params))
            ref = SF.srk_solve_plain(SRK_F, SRK_G, *wide)
            stand_in = SF.srk_solve_cuda(SRK_F, SRK_G, *wide).to(BF16)
            exact = SF.srk_solve_plain(
                SRK_F, SRK_G, y0.double(), 0.0, dt, SRK_STEPS,
                W.double(), U.double(), tuple(p.double() for p in params))
            torch.cuda.synchronize()
            if got.dtype != BF16 or got.shape != (B, d) \
                    or not torch.isfinite(got.float()).all():
                raise RuntimeError(f"kernel 15 bf16 ({B}, {d}): "
                                   f"{got.dtype} {tuple(got.shape)} or "
                                   f"non-finite")
            differ = int((got != want).sum())
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            share = rounding_share([got], [ref], [BF16])
            plain = rounding_share([want], [ref], [BF16])
            stand = rounding_share([stand_in], [ref], [BF16])
            err64 = float((got.double() - exact).abs().max())
            print(f"kernel 15 bf16 ({B}, {d}): {differ} of {got.numel()} "
                  f"elements differ from the bf16 plain version (max abs "
                  f"{err:.3e}, max|plain| {scale:.4g}); RMS distance from "
                  f"the rounded float32 solve over scale {share:.4e}, plain "
                  f"{plain:.4e}, float32 kernel rounded at the end "
                  f"{stand:.4e}; from float64 {err64:.3e} "
                  f"({err64 / scale:.2e} of scale, not held)", flush=True)
            if differ > SRK_BF16_DIFFERING:
                raise RuntimeError(f"kernel 15 bf16 ({B}, {d}): {differ} "
                                   f"elements differ from its plain version")
            if not share >= BF16_FLOOR * plain:
                raise RuntimeError(f"kernel 15 bf16 ({B}, {d}): {share:.3e} "
                                   f"from the rounded float32 solve, under "
                                   f"{BF16_FLOOR} of the plain version's "
                                   f"{plain:.3e}")
            if not stand < BF16_FLOOR * plain:
                raise RuntimeError(f"kernel 15 bf16 ({B}, {d}): the float32 "
                                   f"stand-in passes the floor ({stand:.3e} "
                                   f">= {BF16_FLOOR} * {plain:.3e})")
            if (B, d) == SRK_CONFIGS[0]:
                ys = sdeint(srk_sde(params), y0, [0.0, 1.0],
                            bm=GridTable(W, U), method="srk", dt=dt)
                gap = float((ys[-1].float() - got.float()).abs().max())
                print(f"kernel 15 bf16 ({B}, {d}) vs sdeint(method='srk') "
                      f"in bf16 on the same W, U: max abs diff {gap:.3e} "
                      f"({gap / scale:.3e} of scale, "
                      f"{float((ys[-1] != got).float().mean()):.3f} of "
                      f"elements differ)", flush=True)
                if gap > SRK_BF16_SDEINT_REL * scale:
                    raise RuntimeError(f"kernel 15 bf16 and sdeint(method="
                                       f"'srk') differ by {gap:.3e} > "
                                       f"{SRK_BF16_SDEINT_REL} * {scale:.4g}")
            ms = median_cuda_ms(lambda: SF.srk_solve_cuda(*args), 20)
            plain_ms = median_cuda_ms(lambda: SF.srk_solve_plain(*args), 3,
                                      warmup=1)
            bounds = bf16_bound(SRID2_FLOPS * B * d * SRK_STEPS,
                                [y0, W, U, *params, got])
            print(f"kernel 15 bf16 ({B}, {d}): median {ms:.4f} ms; plain: "
                  f"median {plain_ms:.4f} ms; bound {bounds['bound_ms']:.4f} "
                  f"ms ({bounds['bound_by']}; its operations at the float32 "
                  f"rate {bounds['fma_bound_ms']:.4f} ms)", flush=True)
            records[(B, d)] = dict(max_abs_err=err, elements_differing=differ,
                                   rounding_ratio=share / plain, ms=ms,
                                   plain_ms=plain_ms, f64_abs_err=err64,
                                   **bounds)
            del got, want, ref, stand_in, exact, W, U
        # The path: one bf16 solve at full width.
        y0, W, U, params, _ = srk_problem(device, *SRK_CONFIGS[-1])
        y0, W, U = (t.to(BF16) for t in (y0, W, U))
        params = tuple(p.to(BF16) for p in params)
        SF.bf16_launches = 0
        out = SF.srk_solve_fused(SRK_F, SRK_G, y0, 0.0, dt, SRK_STEPS,
                                 W, U, params)
        torch.cuda.synchronize()
        launches = SF.bf16_launches
        if launches != 1 or out.dtype != BF16 \
                or not torch.isfinite(out.float()).all():
            raise RuntimeError(f"srk_solve_fused launched kernel 15 in bf16 "
                               f"{launches} times or gave {out.dtype} or "
                               f"non-finite values")
    wide = dict(records[SRK_CONFIGS[-1]])
    for key in ("ms", "bound_ms", "plain_ms"):
        wide[f"{key}_by_config"] = {f"{B}x{d}": r[key] for (B, d), r in
                                    records.items()}
    wide.update(bf16x2_check=check, sass=sass, ptxas=ptxas)
    return launches, wide


# Bf16x2::pack of csrc/srk_srid2.cuh (its packed conversion) as
# phase_srk_rounding rebuilds it, with the nvcc definitions of each build:
# the header's (cvt.rn.bf16x2.f32), the same with every operation on the
# packed conversion (no bf16x2 instruction), rounding in integer
# arithmetic, and truncation (what no conversion at all would cost).
SRK_ROUND_BODY = """const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    uint32_t u;
    memcpy(&u, &r, sizeof u);
    return of_bits(u);"""
SRK_ROUNDINGS = {
    "cvt": (None, ()),
    "packed": (SRK_ROUND_BODY, ("-DTSDE_BF16X2_ADD=0", "-DTSDE_BF16X2_SUB=0",
                                "-DTSDE_BF16X2_MUL=0")),
    "integer": ("""const float rl = round_bf16_bits(lo), rh = round_bf16_bits(hi);
    uint32_t a, b;
    memcpy(&a, &rl, sizeof a);
    memcpy(&b, &rh, sizeof b);
    return of_bits((a >> 16) | (b & 0xffff0000u));""", ()),
    "none": ("""uint32_t a, b;
    memcpy(&a, &lo, sizeof a);
    memcpy(&b, &hi, sizeof b);
    return of_bits((a >> 16) | (b & 0xffff0000u));""", ())}
SASS_OPS = ("F2FP", "F2F", "FADD", "FMUL", "FFMA", "IADD3", "LOP3", "SHF",
            "PRMT", "IMAD", "HMMA", "LDSM", "MOVM", "HADD2", "HMUL2",
            "HFMA2", "MUFU", "CALL", "BRA", "BSSY")
# The bf16 kernels of kernels 1-4 whose SASS phase 22a counts, by a part
# of their mangled names: the flagship's sweep (256 threads, 8 rows, 2
# m-tiles a warp) with registers for two blocks an SM (kernel 4's) and for
# one (kernel 2's), the tiled contraction, and the forward at 16 rows, 256
# threads, 2 m-tiles a warp, with registers for two blocks an SM (kernel 3
# at K = 4) and at 8 rows, 512 threads, 1 m-tile a warp, for one (kernel
# 1).
BF16_SASS = {"sweep": "latent_bwd_sweep_bf16ILi256ELi8ELi2ELi2E",
             "sweep_one_block": "latent_bwd_sweep_bf16ILi256ELi8ELi2ELi1E",
             "contraction": "latent_bwd_contract_bf16",
             "forward": "latent_fwd_bf16ILi256ELi16ELi2ELi2E",
             "forward_one_block": "latent_fwd_bf16ILi512ELi8ELi1ELi1E",
             # bf16 kernels 6 and 8 at the reference widths: the
             # generator's sweep for m <= 3 noise channels, one state and
             # one hidden tile; the critic's for C <= 2 channels, two
             # state tiles (S 17) and one hidden tile.
             "gan_gen_bwd": "gan_gen_bwd_bf16ILi3ELi1ELi1E",
             "gan_cde_bwd": "gan_cde_bwd_bf16ILi2ELi2ELi1E"}


def sass_counts(lib_path, marker="Bf16"):
    """Opcode counts in the SASS of the functions of ``lib_path`` whose
    names hold ``marker`` (cuobjdump beside nvcc), or None without it;
    for a dict of markers, a dict of counts by its keys, from one dump."""
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    markers = marker if isinstance(marker, dict) else {None: marker}
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True).stdout
    counts = {key: dict.fromkeys(SASS_OPS + ("total",), 0)
              for key in markers}
    inside = []
    for line in text.splitlines():
        if "Function :" in line:
            inside = [counts[k] for k, m in markers.items() if m in line]
        elif inside and line.strip().startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if not words or words[0].startswith("/*"):
                continue
            op = words[1] if words[0].startswith("@") else words[0]
            op = op.rstrip(";").split(".")[0]
            for c in inside:
                c["total"] += 1
                if op in c:
                    c[op] += 1
    return counts if isinstance(marker, dict) else counts[None]


def ptxas_info(marker):
    """Registers and spill bytes that ptxas reported (``_build.build_log``)
    for each kernel whose mangled name holds ``marker``."""
    out, name = {}, None
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if marker in line else None
        elif name and "spill stores" in line:
            words = line.replace(",", "").split()
            out.setdefault(name, {})["spill_store_bytes"] = int(
                words[words.index("spill") - 2])
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out.setdefault(name, {})["registers"] = int(
                words[words.index("registers") - 1])
    return out


def phase_srk_rounding(device):
    """Measurement only (``--only srk_rounding``): what binds bf16 kernel
    15. Builds phase 23's generated source against copies of
    csrc/srk_srid2.cuh whose packed conversion (Bf16x2::pack) carries
    every operation, rounds in integer arithmetic or truncates, holds the
    first two bitwise to the header's, times each at the widest SRK
    configuration, and counts the opcodes of each bf16 kernel's SASS."""
    B, d = SRK_CONFIGS[-1]
    dt = 1.0 / SRK_STEPS
    y0, W, U, params, _ = srk_problem(device, B, d)
    y0, W, U = (t.to(BF16) for t in (y0, W, U))
    params = tuple(p.to(BF16) for p in params)
    prm = torch.stack(params)
    text = SF.srk_source(SRK_F.cuda_expr, SRK_G.cuda_expr, len(params))
    header = (Path(SF.__file__).parent / "csrc" / "srk_srid2.cuh"
              ).read_text()
    if SRK_ROUND_BODY not in header:
        raise RuntimeError("Bf16x2::pack is not the one phase_srk_rounding "
                           "rewrites")
    root = Path(__file__).resolve().parent / "build" / "srk_rounding"
    out, records = {}, {}
    with torch.no_grad():
        for name, (body, defines) in SRK_ROUNDINGS.items():
            if body is None:
                SF.srk_solve_cuda(SRK_F, SRK_G, y0, 0.0, dt, 1, W[:1], U[:1],
                                  params)
                lib_path = _build.source_library_path("tsde_srk_srid2", text)
            else:
                folder = root / name
                folder.mkdir(parents=True, exist_ok=True)
                (folder / "srk_srid2.cuh").write_text(
                    header.replace(SRK_ROUND_BODY, body))
                (folder / "solve.cu").write_text(text)
                lib_path = folder / "libsolve.so"
                proc = subprocess.run(
                    [_build.find_nvcc(), *_build.NVCC_FLAGS, *defines,
                     "-shared", "-I", str(folder), "-o", str(lib_path),
                     str(folder / "solve.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"srk rounding {name}: nvcc failed\n"
                                       f"{proc.stdout}")
            fn = ctypes.CDLL(str(lib_path)).tsde_srk_srid2_bf16
            P = ctypes.c_void_p
            fn.argtypes = [P] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_double,
                                     ctypes.c_double, ctypes.c_int, P]
            res = torch.empty_like(y0)

            def run(fn=fn, res=res):
                rc = fn(y0.data_ptr(), W.data_ptr(), U.data_ptr(),
                        prm.data_ptr(), res.data_ptr(), B * d, d, SRK_STEPS,
                        0.0, dt, device.index or 0,
                        torch.cuda.current_stream(device).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"srk rounding {name}: launch {rc}")

            run()
            torch.cuda.synchronize()
            out[name] = res.clone()
            records[name] = dict(ms=median_cuda_ms(run, 20),
                                 sass=sass_counts(lib_path,
                                                  "srid2_kernel_bf16x2"))
    for name in ("packed", "integer"):
        records[name]["bitwise"] = bool(torch.equal(out[name], out["cvt"]))
        if not records[name]["bitwise"]:
            raise RuntimeError(f"srk rounding {name} differs from the "
                               f"header's")
    records["none"]["max_abs_diff"] = float(
        (out["none"].float() - out["cvt"].float()).abs().max())
    print(json.dumps({"srk_rounding": records}), flush=True)
    return records


def clocks_backward(fn, kind, bargs):
    """One launch of the clocks build's bf16 kernel 6 (``kind`` "gen") or 8
    ("cde") on its inputs at GF.THREADS threads a block, with the outputs
    of the port's wrapper: eight rows a weight-gradient partial, the
    gradients summed into bf16."""
    if kind == "gen":
        x0, f0, g0, noise, t1s, dts, weights, zs, gs, gy = bargs
        B, S = x0.shape
        N, _, K = noise.shape
        outs = [torch.empty_like(x0), torch.empty_like(f0),
                torch.empty_like(g0), torch.empty_like(noise)]
        tensors = (g0, noise, t1s, dts, *weights, zs, gs, gy)
    else:
        h0, f0, slopes, t1s, dts, weights, zs, ghs = bargs
        B, S = h0.shape
        N, _, K = slopes.shape
        outs = [torch.empty_like(h0), torch.empty_like(f0),
                torch.empty_like(slopes)]
        tensors = (slopes, t1s, dts, *weights, zs, ghs)
    M = weights[0].shape[1]
    sizes = [w.numel() for w in weights]
    partials = torch.empty(((B + 7) // 8, sum(sizes)), dtype=torch.float32,
                           device=zs.device)
    dw = torch.empty(sum(sizes), dtype=BF16, device=zs.device)
    rc = fn(*[t.data_ptr() for t in (*tensors, *outs, partials, dw)], B, S,
            M, K, N, GF.THREADS, zs.device.index or 0,
            torch.cuda.current_stream(zs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gan clocks {kind}: launch failed {rc}")


# Stage clocks of bf16 kernels 6 and 8 (measurement only): the marks of
# csrc/gan_gen_bwd_bf16.cu and gan_cde_bwd_bf16.cu (StageClocks), by warp
# of the first row group: mark k closes stage k; 10 is the staging of the
# weights (with the block's barrier), 11 the towers' constants, 8 the rest
# of the prologue (the first loads), 9 the epilogue.
GAN_CLOCK_STAGES = {
    "gen": {"forward": ("0 loads, pack", "1 drift tower", "2 diffusion "
                        "tower", "3 slot writes", "4 wait"),
            "backward": ("0 loads, ay", "1 wait for the slot", "2 slot "
                         "reads, dpre2", "3 tower backward", "4 dz swap",
                         "5 Az", "6 dnoise, update")},
    "cde": {"forward": ("0 loads, pack", "1 tower", "3 slot writes",
                        "4 wait"),
            "backward": ("0 loads, Af", "1 wait for the slot", "2 slot "
                         "reads, dslopes, dpre2", "3 tower backward",
                         "6 update")}}


def phase_gan_clocks(device):
    """Measurement only (``--only gan_clocks``): bf16 kernels 6 and 8 built
    with -DTSDE_GAN_CLOCKS from a copy of csrc/ into build/gan_clocks/,
    run once at the reference scale on the inputs of phase 22b; each warp
    of the first row group's cycles a step by stage (GAN_CLOCK_STAGES),
    and its prologue and epilogue. Then, on the port's own build, the
    device time of each kernel the wrappers of 6 and 8 launch
    (gan_bwd_kernel_profiles) and their times over steps and rows
    (gan_bwd_scaling), bf16 and float32."""
    csrc = Path(GF.__file__).parent / "csrc"
    folder = Path(__file__).resolve().parent / "build" / "gan_clocks"
    folder.mkdir(parents=True, exist_ok=True)
    for src in csrc.iterdir():
        (folder / src.name).write_text(src.read_text())
    lib_path = folder / "libclocks.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DTSDE_GAN_CLOCKS",
         "-shared", "-I", str(folder), "-o", str(lib_path),
         str(folder / "gan_gen_bwd_bf16.cu"),
         str(folder / "gan_cde_bwd_bf16.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"gan clocks: nvcc failed\n{proc.stdout}")
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    gan_ts, real = gan_data(device)
    (g16, gw16), (c16, cw16) = gan_kernel_inputs(
        device, gan_models(device, BF16), gan_ts, real.to(BF16))
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    record = {}
    with torch.no_grad():
        ys, zs, gs = GF.gen_solve_forward_plain(*g16, gw16)
        hs, czs = GF.cde_solve_forward_plain(*c16, cw16)
        ghs = torch.randn(hs.shape, generator=gen, device=device)
        for kind, bargs, n in (
                ("gen", (*g16, gw16, zs, gs, torch.randn(
                    ys.shape, generator=gen, device=device)), 21),
                ("cde", (*c16, cw16, czs, ghs), 14)):
            fn = getattr(lib, f"tsde_gan_{kind}_bwd_bf16")
            fn.argtypes = [P] * n + [I] * 7 + [P]
            fn.restype = I
            clocks = getattr(lib, f"tsde_gan_{kind}_bwd_clocks")
            clocks.argtypes = [P]
            clocks.restype = I
            counts = np.zeros(64, np.uint64)
            clocks_backward(fn, kind, bargs)
            torch.cuda.synchronize()
            clocks(counts.ctypes.data)              # zeroes the counters
            clocks_backward(fn, kind, bargs)
            torch.cuda.synchronize()
            if clocks(counts.ctypes.data) != 0:
                raise RuntimeError("gan clocks: reading the counters failed")
            steps = bargs[3].shape[0] if kind == "gen" else bargs[2].shape[0]
            rec = {}
            warps = 3 if kind == "gen" else 2
            for w in range(warps):
                role = "forward" if w == 0 else "backward"
                c = counts[16 * w:16 * w + 12].astype(np.float64)
                names = GAN_CLOCK_STAGES[kind][role]
                rec[f"warp{w}_{role}"] = dict(
                    {name: float(c[int(name.split()[0])] / steps)
                     for name in names},
                    staging=float(c[10]), constants=float(c[11]),
                    prologue=float(c[8]), epilogue=float(c[9]),
                    step_total=float(sum(c[int(nm.split()[0])]
                                         for nm in names) / steps))
            record[kind] = rec
    record["profile"] = gan_bwd_kernel_profiles(device)
    record["scaling"] = gan_bwd_scaling(device)
    print(json.dumps({"gan_clocks": record}), flush=True)
    return record


def gan_bwd_inputs(device, dtype):
    """Kernels 6 and 8's inputs at the reference scale (the models of
    ``dtype``; the backward from the twins' states, seeded cotangents)."""
    gan_ts, real = gan_data(device)
    (ga, gw), (ca, cw) = gan_kernel_inputs(
        device, gan_models(device, dtype), gan_ts, real.to(dtype))
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    ys, zs, gs = GF.gen_solve_forward_plain(*ga, gw)
    hs, czs = GF.cde_solve_forward_plain(*ca, cw)
    return ((*ga, gw, zs, gs, torch.randn(ys.shape, generator=gen,
                                          device=device)),
            (*ca, cw, czs, torch.randn(hs.shape, generator=gen,
                                       device=device)))


def gan_bwd_kernel_profiles(device, calls=20):
    """Device microseconds a call of each kernel that kernels 6 and 8's
    wrappers launch (the sweep, the partials' sum, any conversion), bf16
    and float32, from torch.profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    with torch.no_grad():
        for tag, dtype in (("bf16", BF16), ("f32", torch.float32)):
            b6, b8 = gan_bwd_inputs(device, dtype)
            for name, fn in (("k6", lambda: GF.gen_solve_backward_cuda(*b6)),
                             ("k8", lambda: GF.cde_solve_backward_cuda(*b8))):
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                sums = {}
                for e in prof.events():
                    if e.device_type == DeviceType.CUDA:
                        sums[e.name[:60]] = sums.get(e.name[:60], 0.0) + \
                            e.time_range.elapsed_us() / calls
                out[f"{tag}_{name}"] = sums
    return out


def gan_bwd_scaling(device):
    """Kernels 6 and 8 (bf16 and float32, through their wrappers) over the
    last N of the reference's steps and on its first B rows: the fixed
    cost (N = 1) against the cost a step, and one 8-row group against the
    whole batch."""
    out = {}
    with torch.no_grad():
        for tag, dtype in (("bf16", BF16), ("f32", torch.float32)):
            b6, b8 = gan_bwd_inputs(device, dtype)
            for N in (63, 16, 4, 1):
                for B in (None, 8):
                    b = slice(None) if B is None else slice(0, B)
                    x0, f0, g0, noise, t1s, dts, gw, zs, gs, gy = b6
                    a6 = (x0[b].contiguous(), f0[b].contiguous(),
                          g0[b].contiguous(), noise[-N:, b].contiguous(),
                          t1s[-N:].contiguous(), dts[-N:].contiguous(), gw,
                          zs[-N:, b].contiguous(), gs[-N:, b].contiguous(),
                          gy[-N:, b].contiguous())
                    h0, cf0, slopes, ct1s, cdts, cw, czs, ghs = b8
                    a8 = (h0[b].contiguous(), cf0[b].contiguous(),
                          slopes[-N:, b].contiguous(),
                          ct1s[-N:].contiguous(), cdts[-N:].contiguous(), cw,
                          czs[-N:, b].contiguous(), ghs[-N:, b].contiguous())
                    key = f"N{N}_B{B or 'all'}"
                    out[f"k6_{tag}_{key}"] = median_cuda_ms(
                        lambda: GF.gen_solve_backward_cuda(*a6), 20)
                    out[f"k8_{tag}_{key}"] = median_cuda_ms(
                        lambda: GF.cde_solve_backward_cuda(*a8), 20)
    return out


def phase_prng_kernel(device):
    """Kernel 16 against its plain version at PRNG_SHAPES, the law of 2^20
    draws (moments and a KS test against N(0, 1)), determinism, median
    times beside torch.randn's (another stream, a reference only), and one
    sdeint(method='srk', rng_impl='philox') solve as the main path, which
    launches the kernel twice (W's and H's normals)."""
    from scipy import stats

    seed = torch.tensor([SEED + 400], dtype=torch.int32, device=device)
    errs = []
    with torch.no_grad():
        for shape in PRNG_SHAPES:
            got = PR.philox_normal_cuda(seed, shape)
            want = PR.philox_normal_plain(seed, shape, device=device)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs.append(err)
            print(f"kernel 16 {shape}: max abs err vs plain {err:.3e}",
                  flush=True)
            if not torch.isfinite(got).all() or err > PRNG_ATOL:
                raise RuntimeError(f"kernel 16 {shape} differs from its plain "
                                   f"version by {err:.3e} > {PRNG_ATOL}")
        z = PR.philox_normal_cuda(seed, (PRNG_LAW_DRAWS,)).double().cpu()
        ks = stats.kstest(z.numpy(), "norm")
        mean, var = float(z.mean()), float(z.var())
        skew = float(((z - mean) ** 3).mean() / var ** 1.5)
        kurt = float(((z - mean) ** 4).mean() / var ** 2 - 3)
        print(f"kernel 16 law of {PRNG_LAW_DRAWS} draws: mean {mean:.2e}, "
              f"var {var:.5f}, skew {skew:.2e}, excess kurtosis {kurt:.2e}, "
              f"KS {ks.statistic:.2e} (p {ks.pvalue:.3f})", flush=True)
        sd = 1 / np.sqrt(PRNG_LAW_DRAWS)
        if not (abs(mean) < 5 * sd and abs(var - 1) < 5 * np.sqrt(2) * sd
                and abs(skew) < 5 * np.sqrt(6) * sd
                and abs(kurt) < 5 * np.sqrt(24) * sd and ks.pvalue > 1e-3):
            raise RuntimeError("kernel 16's draws fail the law of N(0, 1)")
        a = PR.philox_normal_cuda(seed, PRNG_SHAPES[0])
        b = PR.philox_normal_cuda(seed, PRNG_SHAPES[0])
        c = PR.philox_normal_cuda(seed + 1, PRNG_SHAPES[0])
        if not torch.equal(a, b) or torch.equal(a, c):
            raise RuntimeError("kernel 16 is not a function of its seed")
        print("kernel 16: one seed gives the same stream twice, the next "
              "seed another", flush=True)
        shape = PRNG_SHAPES[-1]
        out = PR.philox_normal_cuda(seed, shape)
        ms = median_cuda_ms(lambda: PR.philox_normal_cuda(seed, shape), 20)
        plain_ms = median_cuda_ms(
            lambda: PR.philox_normal_plain(seed, shape, device=device), 3,
            warmup=1)
        randn_ms = median_cuda_ms(lambda: torch.randn(shape, device=device),
                                  20)
        bound_ms, bound_by = bound(0, [seed, out])
        del out
        print(f"kernel 16 {shape}: median {ms:.4f} ms ({ms / randn_ms:.3f} x "
              f"torch.randn, {bound_ms / ms:.3f} of the bound); plain: median "
              f"{plain_ms:.4f} ms; torch.randn (another stream): median "
              f"{randn_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
        # The path: an srk solve on the Philox noise. Its W and U (2 GiB)
        # pass the in-loop threshold, where the bulk generator does not
        # reach (as the JAX package's 'pallas'), so it asks to precompute.
        B, d = SRK_CONFIGS[-1]
        y0, _, _, params, _ = srk_problem(device, B, d)
        PR.launches = 0
        ys = sdeint(srk_sde(params), y0, [0.0, 1.0], method="srk",
                    dt=1.0 / SRK_STEPS, rng_impl="philox",
                    noise_precompute=True,
                    generator=torch.Generator(device=device).manual_seed(
                        SEED + 401))
        torch.cuda.synchronize()
        launches = PR.launches
        if launches != 2 or not torch.isfinite(ys).all():
            raise RuntimeError(f"sdeint(method='srk', rng_impl='philox') "
                               f"launched kernel 16 {launches} times")
        print(f"sdeint(method='srk', rng_impl='philox') at ({B}, {d}): "
              f"kernel 16 launched {launches} times, mean y_T "
              f"{float(ys[-1].mean()):.5f}", flush=True)
    return launches, dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                          randn_ms=randn_ms, bound_ms=bound_ms,
                          bound_by=bound_by, ks_pvalue=float(ks.pvalue))


# --------------------------------------------------------------------------- #
#  Brownian classes and the fixed-step solvers (no kernels)                   #
# --------------------------------------------------------------------------- #

# The reference benchmarks' sizes (benchmarks/brownian.py:32 and
# benchmarks/sdeint_ab.py:31 of the JAX package).
BM_SIZES = ((128, 5), (256, 128), (512, 256))
# Bitwise the solves' step grid (integrate.build_step_grid(0, 1, SOLVE_DT)),
# so phase (c) replays the noise phase (a) draws. 257 points (the reference
# benchmarks' 1,001, cut to keep the script within half its time limit:
# the descent and the solves' loops scale with the points; PERF.md keeps
# the 1,001-point times).
BM_GRID = np.linspace(0.0, 1.0, 257)
# Card against CPU: W and U of a float32 interval within BM_F32_ATOL times
# sqrt(span) (CUDA's erfinv is not the CPU's; keys, bits and branch words
# are held bitwise), A within BM_F32_A_ATOL: A is built from H = U/h - W/2,
# and U of a cell is a difference of float32 prefix integrals of O(1), so
# an ulp of those (1e-7) is 1e-4 in H over a cell of h = 1e-3, times
# |W| ~ 0.1 in A.
BM_F32_ATOL = 2e-5
BM_F32_A_ATOL = 1e-4
# Cells of the grid held against the CPU above (128, 5), where the CPU
# descent of every point would take minutes.
BM_CPU_CELLS = (0, 1, 37, 128, 129, 201, 254, 255)
# W(a, b) + W(b, c) against W(a, c): prefix differences in float32.
BM_ADD_ATOL = 1e-5
# The reference solver benchmark (benchmarks/sdeint_ab.py:29-33, 66-70):
# f = y, Ito diagonal, 100 output times on [0, 1], an explicit
# BrownianInterval (entropy 42, phase (a)'s too), at dt 1/256 (its 1e-3 cut
# with BM_GRID); its g = exp(-y) is
# saturated to
# g = 1 / (1 + exp(y)) (about exp(-y) for y >> 0), because with exp(-y) a
# path that turns negative explodes (about 2 % of them are inf or nan by
# t = 1, measured on the CPU), and every solve here must be finite.
SOLVE_SIZE, SOLVE_SMALL = (512, 256), (128, 5)
SOLVE_TS = np.linspace(0.0, 1.0, 100)
SOLVE_DT = 1.0 / 256
SOLVE_ENTROPY = 42
# A card solve against the same solve on the CPU: max |diff| within this
# times (1 + max |y|) in float32. At SOLVE_SIZE the CPU twin solves the
# rows SOLVE_TWIN_ROWS.
SOLVE_F32_REL = 1e-4
SOLVE_TWIN_ROWS = slice(0, 32)
SOLVE_METHODS = (("euler", "ito", None), ("srk", "ito", None),
                 ("milstein", "ito", None),
                 ("milstein", "ito", {"grad_free": True}),
                 ("reversible_heun", "stratonovich", None),
                 ("midpoint", "stratonovich", None),
                 ("heun", "stratonovich", None),
                 ("euler_heun", "stratonovich", None),
                 ("milstein", "stratonovich", None),
                 ("milstein", "stratonovich", {"grad_free": True}))


class AbSDE(torch.nn.Module):
    """The reference solver benchmark's SDE, f = y and g = 1 / (1 + exp(y))
    (its exp(-y), saturated), with a trainable scale ``one`` on the drift;
    diagonal, or general with ``G`` (d, m) spreading the diffusion over m
    channels."""

    def __init__(self, sde_type, device, G=None):
        super().__init__()
        self.sde_type = sde_type
        self.noise_type = "diagonal" if G is None else "general"
        self.one = torch.nn.Parameter(torch.ones((), device=device))
        self.G = G

    def f(self, t, y):
        return self.one * y

    def g(self, t, y):
        g = torch.sigmoid(-y)
        return g if self.G is None else g[..., None] * self.G


class Recorder(BaseBrownian):
    """A Brownian object that passes ``query_grid`` to ``bm``, timing it
    (host clock, synchronised): the noise-precompute part of a solve."""

    def __init__(self, bm):
        self.bm, self.ms = bm, None

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        return self.bm(ta, tb, return_U=return_U, return_A=return_A)

    def query_grid(self, grid, return_U=False, return_A=False):
        noise, self.ms = timed_ms(lambda: self.bm.query_grid(
            grid, return_U=return_U, return_A=return_A))
        return noise

    shape = property(lambda self: self.bm.shape)
    dtype = property(lambda self: self.bm.dtype)
    device = property(lambda self: self.bm.device)
    levy_area_approximation = property(
        lambda self: self.bm.levy_area_approximation)


class NoiseTable(BaseBrownian):
    """Serves the rows ``rows`` of a recorded ``(W, U, A)`` of BM_GRID, on
    ``device``: a solve on the card replays the noise a query_grid of
    phase (a) drew, and a CPU twin the same noise or the CPU interval's."""

    def __init__(self, noise, levy, device, rows=slice(None)):
        self.noise = tuple(None if x is None else x[:, rows].to(device)
                           for x in noise)
        self.levy, self.device = levy, torch.device(device)

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        raise NotImplementedError("NoiseTable serves whole grids only")

    def query_grid(self, grid, return_U=False, return_A=False):
        if not np.array_equal(grid, BM_GRID):
            raise ValueError("NoiseTable serves BM_GRID only")
        W, U, A = self.noise
        return W, (U if return_U else None), (A if return_A else None)

    shape = property(lambda self: tuple(self.noise[0].shape[1:]))
    dtype = property(lambda self: self.noise[0].dtype)
    levy_area_approximation = property(lambda self: self.levy)


def interval(size, levy, device, entropy=None):
    entropy = SOLVE_ENTROPY if entropy is None else entropy
    return BrownianInterval(0.0, 1.0, size, dtype=torch.float32,
                            entropy=entropy, levy_area_approximation=levy,
                            device=device)


class CudaTraffic(TorchDispatchMode):
    """Counts the aten ops that run on the card, views left out (they launch
    nothing), and the bytes each names: every CUDA tensor among its inputs
    and outputs, once, at most its storage's size (an expanded tensor is
    read from its storage). In eager PyTorch each such op is a kernel that
    reads its inputs and writes its outputs, so for tensors larger than L2
    this is the DRAM traffic the ops ask for; the card's counters are not
    read."""

    def __init__(self):
        super().__init__()
        self.ops, self.bytes = 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            seen = set()
            for t in tree_flatten((args, kwargs, out))[0]:
                if torch.is_tensor(t) and t.is_cuda and id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += min(t.numel() * t.element_size(),
                                      t.untyped_storage().nbytes())
            self.ops += 1
        return out


def descent_traffic(bm, rU, rA, ms):
    """One query_grid of ``bm`` over BM_GRID under CudaTraffic: its ops and
    bytes, and the rate those bytes take in ``ms`` (the unobserved call's
    time) beside PEAK_BYTES_S."""
    with torch.no_grad(), CudaTraffic() as traffic:
        bm.query_grid(BM_GRID, return_U=rU, return_A=rA)
    rate = traffic.bytes / (ms * 1e-3)
    print(f"query_grid {bm.shape} {bm.levy_area_approximation}: "
          f"{traffic.ops} ops on the card, {traffic.bytes / 1e9:.2f} GB named "
          f"by them, {rate / 1e12:.3f} TB/s over {ms:.1f} ms "
          f"({rate / PEAK_BYTES_S:.3f} of {PEAK_BYTES_S / 1e12:.2f} TB/s)",
          flush=True)
    return dict(ops=traffic.ops, bytes=traffic.bytes, rate=rate,
                share=rate / PEAK_BYTES_S)


def timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_interval_twin(label, bm, bm_cpu, noise, rU, rA):
    """Card against CPU: branch bits resolved on the card and on the host,
    the packed words of the grid's descents, the node keys' random bits
    and uniforms bitwise; W, U and A within BM_F32_ATOL and BM_F32_A_ATOL
    (all cells at (128, 5), else BM_CPU_CELLS). Returns the largest
    difference of each, and the CPU's noise where it drew every cell (else
    None)."""
    grid_dev = torch.as_tensor(BM_GRID, device=bm.device)
    bits_dev, starts_dev, full_dev = bm._resolve(grid_dev)
    bits, starts, full = bm_cpu._resolve(BM_GRID)
    depth = bits.shape[1]
    same_bits = (torch.equal(bits_dev[:, :depth].cpu(), bits)
                 and not bits_dev[:, depth:].any()
                 and torch.equal(full_dev.cpu(), full)
                 and torch.equal(starts_dev.cpu(), starts))
    words_dev = bm._words(bits_dev).masked_fill_(full_dev[:, None], -1)
    words = bm_cpu._words(bits).masked_fill_(full[:, None], -1)
    keys = TF.split(bm._key_nodes, 64)
    keys_cpu = TF.split(bm_cpu._key_nodes, 64)
    same_draws = (torch.equal(words_dev.cpu(), words)
                  and torch.equal(keys.cpu(), keys_cpu)
                  and torch.equal(TF.random_bits(keys, bm.shape).cpu(),
                                  TF.random_bits(keys_cpu, bm.shape))
                  and torch.equal(TF.uniform(keys, bm.shape).cpu(),
                                  TF.uniform(keys_cpu, bm.shape)))
    if not (same_bits and same_draws):
        raise RuntimeError(f"{label}: the card's branch bits ({same_bits}) "
                           f"or keys, bits and uniforms ({same_draws}) are "
                           f"not the CPU's")
    whole = bm.shape == BM_SIZES[0]
    if whole:
        want = bm_cpu.query_grid(BM_GRID, return_U=rU, return_A=rA)
        cells = list(range(len(BM_GRID) - 1))
    else:
        cells = list(BM_CPU_CELLS)
        pts = sorted({c + k for c in cells for k in (0, 1)})
        outs = bm_cpu.query_pairs(BM_GRID[pts], [
            (pts.index(c), pts.index(c + 1)) for c in cells],
            return_U=rU, return_A=rA)
        cols = [torch.stack(c) for c in zip(*[
            o if isinstance(o, tuple) else (o,) for o in outs])]
        want = (cols.pop(0), cols.pop(0) if rU else None,
                cols.pop(0) if rA else None)
    err = {}
    for name, got, ref in zip("WUA", noise, want):
        if ref is None:
            continue
        d = float((got[cells].cpu() - ref).abs().max())
        err[name] = d
        tol = BM_F32_A_ATOL if name == "A" else BM_F32_ATOL   # span 1
        if not d <= tol:
            raise RuntimeError(f"{label}: {name} on the card differs from "
                               f"the CPU's by {d:.3e} > {tol}")
    return err, (want if whole else None)


def check_interval_laws(device):
    """Additivity, query-order independence and query_pairs over a CUDA
    tensor of times against __call__ on host floats, on the card."""
    rng = np.random.default_rng(SEED + 500)
    errs = []
    for size, levy in ((BM_SIZES[0], "foster"), (BM_SIZES[-1], "space-time")):
        bm = interval(size, levy, device, entropy=SEED + 501)
        # Three triples a < b < c in one query_pairs over host floats (one
        # descent a point; bitwise __call__, as checked below).
        abc = np.sort(rng.uniform(0.0, 1.0, (3, 3)), axis=1)
        outs = bm.query_pairs(abc.reshape(-1).tolist(), [
            (3 * k + i, 3 * k + j) for k in range(3)
            for i, j in ((0, 1), (1, 2), (0, 2))], return_U=True)
        for k, (a, b, c) in enumerate(abc):
            (W1, U1), (W2, U2), (W, U) = outs[3 * k:3 * k + 3]
            errs.append(float((W1 + W2 - W).abs().max()))
            errs.append(float((U1 + U2 + (c - b) * W1 - U).abs().max()))
        if max(errs) > BM_ADD_ATOL:
            raise RuntimeError(f"BrownianInterval {size} {levy}: W or U not "
                               f"additive on the card ({max(errs):.3e})")
        pts = np.sort(rng.uniform(0.0, 1.0, 6))
        pairs = ((0, 3), (1, 2), (2, 5), (0, 5), (4, 4))
        rA = levy == "foster"
        fwd = [bm(float(pts[i]), float(pts[j]), return_U=True, return_A=rA)
               for i, j in pairs]
        other = interval(size, levy, device, entropy=SEED + 501)
        rev = [other(float(pts[i]), float(pts[j]), return_U=True,
                     return_A=rA) for i, j in reversed(pairs)][::-1]
        on_card = bm.query_pairs(torch.as_tensor(pts, device=device), pairs,
                                 return_U=True, return_A=rA)
        for x, y, z in zip(fwd, rev, on_card):
            if not all(torch.equal(p, q) and torch.equal(p, r)
                       for p, q, r in zip(x, y, z)):
                raise RuntimeError(f"BrownianInterval {size} {levy}: query "
                                   f"order or query_pairs on the card "
                                   f"changed the noise")
    print(f"BrownianInterval laws on the card: W and U additive to "
          f"{max(errs):.3e}; query order and query_pairs over a CUDA "
          f"tensor of times bitwise __call__ on host floats", flush=True)


def solve_levy(method):
    return {"srk": "space-time", "log_ode": "foster"}.get(method, "none")


def solve_sde(method, sde_type, size, device):
    """The reference benchmark's SDE for ``method`` at ``size`` (general
    noise over m channels for log_ode) and its y0, on ``device``."""
    B, m = size
    G = None
    if method == "log_ode":
        G = torch.as_tensor(np.random.default_rng(SEED + 502).normal(
            size=(m, m)) / np.sqrt(m), dtype=torch.float32, device=device)
    return AbSDE(sde_type, device, G), torch.zeros((B, m), device=device)


def run_solve(method, sde_type, options, size, device, tables):
    """One solve on the card through ``sdeint`` on the noise phase (a) drew
    from the explicit interval at ``size`` (``tables``: its noise on the
    card and on the CPU, and its query_grid's median ms, the solve's noise
    precompute; the solve's own time is its loop), and its CPU twin: the
    whole solve on the CPU interval's noise at (128, 5), else the CPU's
    solver loop on the card's noise for the rows SOLVE_TWIN_ROWS (the SDE
    acts row by row). Returns the record of the solve."""
    levy = solve_levy(method)
    noise, noise_cpu, noise_ms = tables[size, levy]
    sde, y0 = solve_sde(method, sde_type, size, device)
    rows = slice(None)
    with torch.no_grad():
        ys, loop_ms = timed_ms(lambda: sdeint(
            sde, y0, SOLVE_TS, bm=NoiseTable(noise, levy, device),
            method=method, dt=SOLVE_DT, options=options))
        if noise_cpu is not None:
            sde_c, y0_c = solve_sde(method, sde_type, size, "cpu")
            bm_c = NoiseTable(noise_cpu, levy, "cpu")
        else:
            rows = SOLVE_TWIN_ROWS
            sde_c, y0_c = AbSDE(sde_type, "cpu"), y0[rows].cpu()
            bm_c = NoiseTable(noise, levy, "cpu", rows)
        want = sdeint(sde_c, y0_c, SOLVE_TS, bm=bm_c, method=method,
                      dt=SOLVE_DT, options=options)
    err = float((ys[:, rows].cpu() - want).abs().max())
    scale = 1.0 + float(want.abs().max())
    label = f"{method}{'' if not options else ' grad_free'} {sde_type} {size}"
    if (tuple(ys.shape) != (len(SOLVE_TS),) + tuple(y0.shape)
            or not torch.isfinite(ys).all() or err > SOLVE_F32_REL * scale):
        raise RuntimeError(f"sdeint {label}: not finite, misshapen, or "
                           f"{err:.3e} from the CPU's solve "
                           f"(> {SOLVE_F32_REL} x {scale:.3f})")
    print(f"sdeint {label}: {noise_ms + loop_ms:.1f} ms ({noise_ms:.1f} ms "
          f"noise precompute, the interval's query_grid; {loop_ms:.1f} ms "
          f"loop), max |diff| vs the CPU {err:.3e}, mean y_T "
          f"{float(ys[-1].mean()):.5f}", flush=True)
    return dict(method=method, sde_type=sde_type, size=list(size),
                grad_free=bool(options), ms=noise_ms + loop_ms,
                noise_ms=noise_ms, loop_ms=loop_ms, cpu_err=err)


def backprop_solve(method, sde_type, device, tables):
    """ys.sum().backward() through a solve at SOLVE_SIZE on the card, on
    phase (a)'s noise, the drift scale's gradient against the CPU's on the
    same noise."""
    levy = solve_levy(method)
    noise = tables[SOLVE_SIZE, levy][0]
    sde, y0 = solve_sde(method, sde_type, SOLVE_SIZE, device)
    ys, fwd_ms = timed_ms(lambda: sdeint(
        sde, y0, SOLVE_TS, bm=NoiseTable(noise, levy, device), method=method,
        dt=SOLVE_DT))
    _, bwd_ms = timed_ms(lambda: ys.sum().backward())
    sde_c = AbSDE(sde_type, "cpu")
    sdeint(sde_c, y0.cpu(), SOLVE_TS, bm=NoiseTable(noise, levy, "cpu"),
           method=method, dt=SOLVE_DT).sum().backward()
    got, want = float(sde.one.grad), float(sde_c.one.grad)
    rel = abs(got - want) / abs(want)
    if not np.isfinite(got) or rel > SOLVE_F32_REL:
        raise RuntimeError(f"backward through sdeint {method}: d/d one "
                           f"{got} on the card, {want} on the CPU")
    print(f"backward through sdeint {method} {SOLVE_SIZE}: forward loop "
          f"{fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, d sum(ys)/d one "
          f"{got:.6e} (CPU {want:.6e}, rel {rel:.2e})", flush=True)
    return dict(method=method, fwd_ms=fwd_ms, bwd_ms=bwd_ms, grad_rel=rel)


def phase_brownian(device, card):
    """(a) BrownianInterval at BM_SIZES: two query_grids over BM_GRID
    bitwise equal, their time, and the card against the CPU; (b) its laws
    on the card; (c) every ported fixed-step method on the reference
    solver benchmark's path, on (a)'s noise, with CPU twins, two backprops
    and a profiled Euler solve through a fresh interval. No kernel of the
    port runs here: the descent and the solvers are plain PyTorch."""
    out = dict(card=card, query_grid=[], solves=[], backprop=[])
    clock = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        out[f"{name}_s"] = now - clock[0]
        print(f"brownian ({name}): {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    tables = {}   # (size, levy): (card noise, CPU noise or None, median ms)
    for size in BM_SIZES:
        levys = ("none", "space-time") + (("foster",) if size == BM_SIZES[0]
                                          else ())
        for levy in levys:
            rU, rA = levy != "none", levy == "foster"
            bm = interval(size, levy, device)
            with torch.no_grad():
                first, ms1 = timed_ms(lambda: bm.query_grid(
                    BM_GRID, return_U=rU, return_A=rA))
                second, ms2 = timed_ms(lambda: bm.query_grid(
                    BM_GRID, return_U=rU, return_A=rA))
                same = all(a is None or torch.equal(a, b)
                           for a, b in zip(first, second))
                if not same or not all(a is None or torch.isfinite(a).all()
                                       for a in first):
                    raise RuntimeError(f"query_grid {size} {levy}: two calls "
                                       f"differ or are not finite")
                err, noise_cpu = check_interval_twin(
                    f"BrownianInterval {size} {levy}", bm,
                    interval(size, levy, "cpu"), first, rU, rA)
            median = float(np.median([ms1, ms2]))
            print(f"query_grid {size} {levy} over {len(BM_GRID)} points: "
                  f"{ms1:.1f} ms, {ms2:.1f} ms (median {median:.1f}; bitwise "
                  f"equal); card vs CPU: bits, words, keys, uniforms "
                  f"bitwise, max |diff| " +
                  ", ".join(f"{k} {v:.3e}" for k, v in err.items()),
                  flush=True)
            out["query_grid"].append(dict(size=list(size), levy=levy,
                                          ms=[ms1, ms2], cpu_err=err))
            if size == SOLVE_SIZE and levy == "none":
                out["query_grid"][-1]["traffic"] = descent_traffic(
                    bm, rU, rA, median)
            if size in (SOLVE_SMALL, SOLVE_SIZE):
                tables[size, levy] = (first, noise_cpu, median)
            del first, second
    part("a")
    check_interval_laws(device)
    part("b")
    for method, sde_type, options in SOLVE_METHODS:
        out["solves"].append(run_solve(method, sde_type, options,
                                       SOLVE_SMALL, device, tables))
        if not options:   # grad_free is an option of milstein: (128, 5)
            out["solves"].append(run_solve(method, sde_type, options,
                                           SOLVE_SIZE, device, tables))
    out["solves"].append(run_solve("log_ode", "stratonovich", None,
                                   SOLVE_SMALL, device, tables))
    for method, sde_type in (("euler", "ito"), ("midpoint", "stratonovich")):
        out["backprop"].append(backprop_solve(method, sde_type, device,
                                              tables))
    # The whole path once: an Euler solve on a fresh explicit interval, its
    # descent included, under the profiler; its noise must be (a)'s.
    noise = tables[SOLVE_SIZE, "none"][0]
    del tables
    sde, y0 = solve_sde("euler", "ito", SOLVE_SIZE, device)
    rec = Recorder(interval(SOLVE_SIZE, "none", device))

    def euler():
        with torch.no_grad():
            return sdeint(sde, y0, SOLVE_TS, bm=rec, method="euler",
                          dt=SOLVE_DT)

    with torch.no_grad():
        want = sdeint(sde, y0, SOLVE_TS, bm=NoiseTable(noise, "none", device),
                      method="euler", dt=SOLVE_DT)
    ys = []
    out["profile_euler"] = profile_run(f"sdeint euler {SOLVE_SIZE}",
                                       lambda: ys.append(euler()))
    if not torch.equal(ys[0], want):
        raise RuntimeError("sdeint euler on a fresh interval is not the "
                           "solve on phase (a)'s noise")
    out["profile_euler"]["noise_ms"] = rec.ms
    print(f"profiled Euler {SOLVE_SIZE} on a fresh interval: noise "
          f"precompute {rec.ms:.1f} ms of {out['profile_euler']['wall_ms']:.1f}"
          f" ms, bitwise the solve on phase (a)'s noise", flush=True)
    part("c")
    print(json.dumps({"brownian": out}), flush=True)


def ab_rh_inputs(device):
    """Kernel 11's inputs at R1 and on general noise with a time column
    (phase 14's), labelled."""
    method, B, d, (drift, diffusion) = tower_config(device, "R1")
    yield "R1", tower_kernel_args(device, method, drift, diffusion, B, d, d,
                                  True, False, SEED + 12)[1]
    B, d, m, hidden = TOWER_GENERAL
    drift = tower_spec(SEED + 13, [d + 1, hidden, hidden, d],
                       ("softplus", "tanh", "linear"), device)
    diffusion = tower_spec(SEED + 14, [d + 1, hidden, hidden, d * m],
                           ("lipswish", "softplus", "sigmoid"), device)
    yield "general", tower_kernel_args(device, "reversible_heun", drift,
                                       diffusion, B, d, m, False, True,
                                       SEED + 15)[1]


def ab_logqp_inputs(device):
    """Kernel 13's inputs at L1, L2 and the small signed solve (phase
    18's), labelled."""
    for name in ("L1", "L2"):
        _, B, d, towers = tower_config(device, name)
        yield name, logqp_kernel_args(device, towers, B, d, False,
                                      SEED + 21)[1]
    yield "small", logqp_kernel_args(device, small_logqp_towers(device),
                                     LOGQP_SMALL[0], LOGQP_SMALL[1], True,
                                     SEED + 25)[1]


# Kernels 5, 6 and 7 at the other shapes of tests/test_torch_gpu.py
# (GEN_REF_SHAPES, CDE_FWD_REF_SHAPES; batch, S, M, m or C, times): a
# ragged batch, one channel, a hidden layer wider than the state, the
# widest widths.
AB_GEN_SHAPES = ((1023, 16, 16, 3, 20), (300, 16, 16, 1, 20),
                 (300, 9, 24, 3, 20), (64, 32, 32, 8, 8))
AB_CDE_SHAPES = ((2047, 17, 16, 2, 20), (300, 17, 16, 1, 20),
                 (300, 9, 24, 3, 20), (64, 32, 32, 8, 8))


def ab_gan_inputs(device, kind, B, S, M, K, T, seed, dtype=torch.float32):
    """Seeded inputs of kernel 6 (``kind`` "gen": the backward from the
    plain forward's states, seeded cotangents) or kernel 7 ("cde") at
    these widths, with random weights (of ``dtype``: bf16 for the mixed
    mode) as the GPU tests make them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    init = torch.Generator().manual_seed(seed)
    ts = np.arange(T, dtype=np.float64)
    if kind == "gen":
        model = Generator(1, 5, K, S, M, 1, init_mult2=0.5, dtype=dtype,
                          device=device, generator=init)
        x0 = torch.randn((B, S), generator=gen, device=device)
        args = GF.prep_generator_solve(model.func, x0, ts, gen, 1.0)
        weights = GF.gen_weights(model.func)
        ys, zs, gs = GF.gen_solve_forward_plain(*args, weights)
        gy = torch.randn(ys.shape, generator=gen, device=device)
        return (*args, weights, zs, gs, gy)
    model = Discriminator(K - 1, S, M, 1, dtype=dtype, device=device,
                          generator=init)
    paths = torch.randn((B, T, K), generator=gen, device=device)
    func = model.func.attach(ts, paths)
    return (*GF.prep_cde_solve(func, model.initial(paths[:, 0]), ts, 1.0),
            GF.cde_weights(model.func))


def phase_ab(device, tag, against):
    """Times kernels 1, 2 (and its contraction alone), 3 (at each K of
    MULTI_KS), 4 (at MULTI_K), 1-4 in bf16 mixed mode (3 at each K, 4 at
    MULTI_K; 2 and 4 also their sweep and contraction apart), 5-8
    (at the GAN's reference scale; 5, 6 and 7 also at AB_GEN_SHAPES and
    AB_CDE_SHAPES), 9 (at E1, on general noise with time
    and at the narrow solve), 10 (at E1), 11 (at R1 and on general noise
    with time), 12 (at R1), 13 (at L1, L2 and the small signed solve) and 14
    (at L1) and 15 (float32 and float64 at SRK_CONFIGS, bf16 there and at
    SRK_ODD) through the entry points that every version of the port has,
    on the inputs of phases 3,
    4, 8, 11, 14, 18, 21 and 23, and keeps their
    outputs in
    build/ab_<tag>.pt. With ``against``, the outputs of the run tagged so
    are compared with this run's: bitwise, or the largest difference. Run
    by a copy of this script inside another checkout (its parent commit),
    it times that checkout's kernels: one call times both, in turns."""
    out, times = {}, {}
    with torch.no_grad():
        model = flagship_model(device)
        args = kernel_inputs(device, model)
        weights = LF.solve_weights(model)
        n = args[3].shape[0]
        gen = torch.Generator(device=device).manual_seed(SEED + 3)
        gz = torch.randn((n, BATCH, LATENT), generator=gen, device=device)
        gq = torch.randn((n, BATCH, 1), generator=gen, device=device)
        out["kernel1"] = list(LF.fused_solve_forward_cuda(*args, weights))
        times["kernel1"] = median_cuda_ms(
            lambda: LF.fused_solve_forward_cuda(*args, weights), 20)
        # Kernels 2 and 4 go back from the plain forward's states, the
        # same in every version of the port.
        zs = LF.fused_solve_forward_plain(*args, weights)[0]
        bargs = (*args, weights, zs, gz, gq)
        out["kernel2"] = _flat(LF.fused_solve_backward_cuda(*bargs))
        times["kernel2"] = median_cuda_ms(
            lambda: LF.fused_solve_backward_cuda(*bargs), 20)
        # Its contraction alone (the tiled and skinny products and the
        # reduction) on its sweep's workspace.
        _, ws = LF._backward_cuda(*bargs, multi=False)
        times["kernel2_contraction"] = median_cuda_ms(
            lambda: LF._backward_cuda(*bargs, multi=False, stages=2,
                                      workspace=ws), 20)
        del ws
        for Kt in MULTI_KS:
            a_t, w_t = multi_kernel_inputs(device, Kt)
            got = LF.fused_solve_multi_forward_cuda(*a_t, w_t)
            times[f"kernel3_K{Kt}"] = median_cuda_ms(
                lambda: LF.fused_solve_multi_forward_cuda(*a_t, w_t), 10)
            if Kt == MULTI_K:
                out["kernel3"] = list(got)
                g_t = (gz[None].expand(Kt, -1, -1, -1).contiguous(),
                       gq[None].expand(Kt, -1, -1, -1).contiguous())
                zs_t = LF.fused_solve_multi_forward_plain(*a_t, w_t)[0]
                b_t = (*a_t, w_t, zs_t, *g_t)
                out["kernel4"] = _flat(LF.fused_solve_multi_backward_cuda(
                    *b_t))
                times["kernel4"] = median_cuda_ms(
                    lambda: LF.fused_solve_multi_backward_cuda(*b_t), 10)
                del b_t, g_t
            del a_t, w_t, got
        # Kernels 1-4 in bf16 mixed mode (PR 21's entry points), 2 and 4
        # also by phase: the sweep alone, then the contraction and the
        # reduction alone on its workspace. 2 and 4 go back from the plain
        # forward's states.
        model16 = flagship_model(device, BF16)
        a16 = kernel_inputs(device, model16)
        w16 = LF.solve_weights(model16)
        g16 = (gz.to(BF16), gq)
        for key, multi, inputs in (
                ("", False, (a16, w16, g16)),
                ("_multi", True, (*multi_kernel_inputs(
                    device, MULTI_K, dtype=BF16),
                    tuple(t[None].expand(MULTI_K, -1, -1, -1).contiguous()
                          for t in g16)))):
            a_b, w_b, g_b = inputs
            fwd = (LF.fused_solve_multi_forward_cuda if multi
                   else LF.fused_solve_forward_cuda)
            bwd = (LF.fused_solve_multi_backward_cuda if multi
                   else LF.fused_solve_backward_cuda)
            plain = (LF.fused_solve_multi_forward_plain if multi
                     else LF.fused_solve_forward_plain)
            k_f, k_b = ("kernel3", "kernel4") if multi else ("kernel1",
                                                           "kernel2")
            out[f"{k_f}_bf16"] = list(fwd(*a_b, w_b))
            times[f"{k_f}_bf16"] = median_cuda_ms(lambda: fwd(*a_b, w_b), 10)
            b_b = (*a_b, w_b, plain(*a_b, w_b)[0], *g_b)
            out[f"{k_b}_bf16"] = _flat(bwd(*b_b))
            times[f"{k_b}_bf16"] = median_cuda_ms(lambda: bwd(*b_b), 10)
            _, ws = LF._backward_cuda(*b_b, multi=multi)
            for stages, part in ((1, "sweep"), (2, "contraction")):
                times[f"{k_b}_bf16_{part}"] = median_cuda_ms(
                    lambda: LF._backward_cuda(*b_b, multi=multi,
                                              stages=stages, workspace=ws),
                    10)
            del a_b, w_b, b_b, ws
        # Kernel 3 in bf16 at the other K of MULTI_KS.
        for Kt in MULTI_KS:
            if Kt == MULTI_K:
                continue
            a_b, w_b = multi_kernel_inputs(device, Kt, dtype=BF16)
            out[f"kernel3_bf16_K{Kt}"] = list(
                LF.fused_solve_multi_forward_cuda(*a_b, w_b))
            times[f"kernel3_bf16_K{Kt}"] = median_cuda_ms(
                lambda: LF.fused_solve_multi_forward_cuda(*a_b, w_b), 10)
            del a_b, w_b
        for label, e_args in ab_euler_inputs(device):
            key = "kernel9" if label == "E1" else f"kernel9_{label}"
            out[key] = [FS.euler_solve_forward_cuda(*e_args)]
            times[key] = median_cuda_ms(
                lambda: FS.euler_solve_forward_cuda(*e_args), 20)
            if label != "E1":
                continue
            # Stage a, the FMA tiles of 32 rows at E1, against the parent's
            # kernel 9 (a port with one design of kernel 9 runs that one).
            if hasattr(FS, "EulerFwdDesign"):
                design = FS.EulerFwdDesign(0, 32, 512, 3)
                out["kernel9_fma"] = [FS.euler_solve_forward_cuda(
                    *e_args, design=design)]
                times["kernel9_fma"] = median_cuda_ms(
                    lambda: FS.euler_solve_forward_cuda(*e_args,
                                                        design=design), 20)
            else:
                out["kernel9_fma"] = out[key]
            # Kernel 10 goes back from the twin's states, the same in every
            # version of the port.
            ys = FS.euler_solve_forward_plain(*e_args)
            gen = torch.Generator(device=device).manual_seed(SEED + 13)
            gy = torch.randn(ys.shape, generator=gen, device=device)
            out["kernel10"] = list(FS.euler_solve_backward_cuda(*e_args, ys,
                                                                gy))
            times["kernel10"] = median_cuda_ms(
                lambda: FS.euler_solve_backward_cuda(*e_args, ys, gy), 20)
            del ys, gy
        del e_args
        # Kernels 5-8 at the reference scale; kernels 6 and 8 go back from
        # the twins' states.
        gan = gan_models(device)
        gan_ts, real = gan_data(device)
        (gen_args, gen_w), (cde_args, cde_w) = gan_kernel_inputs(
            device, gan, gan_ts, real)
        gen = torch.Generator(device=device).manual_seed(SEED + 6)
        out["kernel5"] = list(GF.gen_solve_forward_cuda(*gen_args, gen_w))
        times["kernel5"] = median_cuda_ms(
            lambda: GF.gen_solve_forward_cuda(*gen_args, gen_w), 20)
        ys, zs, gs = GF.gen_solve_forward_plain(*gen_args, gen_w)
        b6 = (*gen_args, gen_w, zs, gs,
              torch.randn(ys.shape, generator=gen, device=device))
        out["kernel6"] = flat_grads(GF.gen_solve_backward_cuda(*b6))
        times["kernel6"] = median_cuda_ms(
            lambda: GF.gen_solve_backward_cuda(*b6), 20)
        out["kernel7"] = list(GF.cde_solve_forward_cuda(*cde_args, cde_w))
        times["kernel7"] = median_cuda_ms(
            lambda: GF.cde_solve_forward_cuda(*cde_args, cde_w), 20)
        hs, czs = GF.cde_solve_forward_plain(*cde_args, cde_w)
        ghs = torch.zeros_like(hs)
        ghs[-1] = torch.randn(hs.shape[1:], generator=gen, device=device)
        b8 = (*cde_args, cde_w, czs, ghs)
        out["kernel8"] = flat_grads(GF.cde_solve_backward_cuda(*b8))
        times["kernel8"] = median_cuda_ms(
            lambda: GF.cde_solve_backward_cuda(*b8), 20)
        del gan, b6, b8
        for i, shape in enumerate(AB_GEN_SHAPES):
            key = "x".join(map(str, shape))
            b6 = ab_gan_inputs(device, "gen", *shape, SEED + 30 + i)
            out["kernel6_" + key] = flat_grads(
                GF.gen_solve_backward_cuda(*b6))
            times["kernel6_" + key] = median_cuda_ms(
                lambda: GF.gen_solve_backward_cuda(*b6), 20)
            # Kernel 5 on the forward's inputs of the same draw.
            k5 = b6[:7]
            out["kernel5_" + key] = list(GF.gen_solve_forward_cuda(*k5))
            times["kernel5_" + key] = median_cuda_ms(
                lambda: GF.gen_solve_forward_cuda(*k5), 20)
        for i, shape in enumerate(AB_CDE_SHAPES):
            key = "kernel7_" + "x".join(map(str, shape))
            c7 = ab_gan_inputs(device, "cde", *shape, SEED + 40 + i)
            out[key] = list(GF.cde_solve_forward_cuda(*c7))
            times[key] = median_cuda_ms(
                lambda: GF.cde_solve_forward_cuda(*c7), 20)
        del b6, c7
        # Kernels 5-8 in bf16 mixed mode (the _bf16 entry points) at the
        # reference scale, on the inputs of bf16 models, and at
        # AB_GEN_SHAPES and AB_CDE_SHAPES; 6 and 8 go back from the twins'
        # states (8 on last-state cotangents at the reference, dense ones
        # at the other shapes).
        (g16, gw16), (c16, cw16) = gan_kernel_inputs(
            device, gan_models(device, BF16), gan_ts, real.to(BF16))
        runs = {}
        ys, zs, gs = GF.gen_solve_forward_plain(*g16, gw16)
        runs["kernel5_bf16"] = (GF.gen_solve_forward_cuda, (*g16, gw16))
        runs["kernel6_bf16"] = (GF.gen_solve_backward_cuda, (
            *g16, gw16, zs, gs,
            torch.randn(ys.shape, generator=gen, device=device)))
        runs["kernel7_bf16"] = (GF.cde_solve_forward_cuda, (*c16, cw16))
        hs, czs = GF.cde_solve_forward_plain(*c16, cw16)
        ghs = torch.zeros_like(hs)
        ghs[-1] = torch.randn(hs.shape[1:], generator=gen, device=device)
        runs["kernel8_bf16"] = (GF.cde_solve_backward_cuda,
                                (*c16, cw16, czs, ghs))
        for i, shape in enumerate(AB_GEN_SHAPES):
            key = "x".join(map(str, shape))
            b6 = ab_gan_inputs(device, "gen", *shape, SEED + 30 + i, BF16)
            runs["kernel6_bf16_" + key] = (GF.gen_solve_backward_cuda, b6)
            runs["kernel5_bf16_" + key] = (GF.gen_solve_forward_cuda,
                                           b6[:7])
        for i, shape in enumerate(AB_CDE_SHAPES):
            key = "x".join(map(str, shape))
            c7 = ab_gan_inputs(device, "cde", *shape, SEED + 40 + i, BF16)
            runs["kernel7_bf16_" + key] = (GF.cde_solve_forward_cuda, c7)
            hs, czs = GF.cde_solve_forward_plain(*c7)
            runs["kernel8_bf16_" + key] = (GF.cde_solve_backward_cuda, (
                *c7, czs, torch.randn(hs.shape, generator=gen,
                                      device=device)))
        for key, (fn, k_args) in runs.items():
            got = fn(*k_args)
            out[key] = (flat_grads(got) if isinstance(got[-1], tuple)
                        else list(got))
            times[key] = median_cuda_ms(lambda: fn(*k_args), 20)
        del runs, b6, c7
        # The bf16 GAN train step (fused, Adadelta) at the reference scale:
        # its device time, one profile after a warm-up step.
        models16 = gan_models(device, BF16)
        opts16 = tuple(torch.optim.Adadelta(
            m.parameters(), lr=lr, weight_decay=GAN_WEIGHT_DECAY)
            for m, lr in zip(models16, (GAN_GEN_LR, GAN_CRITIC_LR)))
        batch16 = real[:GAN_BATCH].to(BF16)
    with torch.enable_grad():
        gan_train_step(models16, opts16, gan_ts, batch16, 990, True)
        step = profile_run("ab bf16 GAN train step fused",
                           lambda: gan_train_step(models16, opts16, gan_ts,
                                                  batch16, 991, True),
                           cpu=False)
    times["gan_bf16_step_device"] = step["device_ms"]
    times["gan_bf16_step_kernels"] = step["kernels"]
    del models16, opts16
    with torch.no_grad():
        for label, r_args in ab_rh_inputs(device):
            out[f"kernel11_{label}"] = list(FS.rh_solve_forward_cuda(*r_args))
            times[f"kernel11_{label}"] = median_cuda_ms(
                lambda: FS.rh_solve_forward_cuda(*r_args), 20)
            if label == "R1":
                # Kernel 12 goes back from the twin's states, the same in
                # every version of the port.
                _, zs, gs = FS.rh_solve_forward_plain(*r_args)
                gen = torch.Generator(device=device).manual_seed(SEED + 13)
                gy = torch.randn(zs.shape, generator=gen, device=device)
                b_r = (*r_args, zs, gs, gy)
                out["kernel12"] = list(FS.rh_solve_backward_cuda(*b_r))
                times["kernel12"] = median_cuda_ms(
                    lambda: FS.rh_solve_backward_cuda(*b_r), 10)
                del b_r, zs, gs, gy
        for label, l_args in ab_logqp_inputs(device):
            out[f"kernel13_{label}"] = list(
                FS.euler_logqp_solve_forward_cuda(*l_args))
            times[f"kernel13_{label}"] = median_cuda_ms(
                lambda: FS.euler_logqp_solve_forward_cuda(*l_args), 20)
            if label == "L1":
                ys = FS.euler_logqp_solve_forward_plain(*l_args)[0]
                gen = torch.Generator(device=device).manual_seed(SEED + 13)
                gy = torch.randn(ys.shape, generator=gen, device=device)
                ginc = torch.randn(ys.shape[:2] + (1,), generator=gen,
                                   device=device)
                b_l = (*l_args, ys, gy, ginc)
                out["kernel14"] = list(
                    FS.euler_logqp_solve_backward_cuda(*b_l))
                times["kernel14"] = median_cuda_ms(
                    lambda: FS.euler_logqp_solve_backward_cuda(*b_l), 10)
                del b_l, ys, gy, ginc
        # Kernel 15 in float32 and float64 at the SRK configurations.
        for B, d in SRK_CONFIGS:
            for dtype, name in ((torch.float32, "f32"),
                                (torch.float64, "f64")):
                y0, W, U, params, _ = srk_problem(device, B, d, dtype)
                s_args = (SRK_F, SRK_G, y0, 0.0, 1.0 / SRK_STEPS, SRK_STEPS,
                          W, U, params)
                key = f"kernel15_{name}_{B}x{d}"
                out[key] = [SF.srk_solve_cuda(*s_args)]
                times[key] = median_cuda_ms(
                    lambda: SF.srk_solve_cuda(*s_args), 10)
                del s_args, W, U
        # Kernel 15 in bf16 there and at SRK_ODD, on
        # the float32 inputs rounded to bf16.
        for B, d in SRK_CONFIGS + (SRK_ODD,):
            y0, W, U, params, _ = srk_problem(device, B, d)
            s_args = (SRK_F, SRK_G, y0.to(BF16), 0.0, 1.0 / SRK_STEPS,
                      SRK_STEPS, W.to(BF16), U.to(BF16),
                      tuple(p.to(BF16) for p in params))
            key = f"kernel15_bf16_{B}x{d}"
            out[key] = [SF.srk_solve_cuda(*s_args)]
            times[key] = median_cuda_ms(lambda: SF.srk_solve_cuda(*s_args),
                                        10)
            del s_args, W, U
    torch.cuda.synchronize()
    print(f"ab {tag} (ms): " + json.dumps(times), flush=True)
    path = Path(__file__).resolve().parent / "build"
    path.mkdir(exist_ok=True)
    torch.save({k: [t.cpu() for t in v] for k, v in out.items()},
               path / f"ab_{tag}.pt")
    if against:
        other = torch.load(Path(against), map_location="cpu")
        for k, tensors in out.items():
            if k not in other:
                print(f"ab {tag} vs {against}: {k} not in the other run",
                      flush=True)
                continue
            diffs = [float((a.cpu() - b).abs().max())
                     for a, b in zip(tensors, other[k])]
            same = all(torch.equal(a.cpu(), b)
                       for a, b in zip(tensors, other[k]))
            print(f"ab {tag} vs {against}: {k} "
                  + ("bitwise equal" if same else
                     "max abs differences " + ", ".join(f"{x:.3e}"
                                                        for x in diffs)),
                  flush=True)
    return times


# --------------------------------------------------------------------------- #
#  sdeint_adjoint: no kernel of its own (plain PyTorch, as the JAX package    #
#  leaves it to XLA); its routes held to the kernels' and to the CPU         #
# --------------------------------------------------------------------------- #

# The step routes the adjoint group times: (name, gan_grads / latent_sde_loss
# keywords).
ADJ_ROUTES = (("adjoint", dict(adjoint=True, fused=False)),
              ("sdeint", dict(adjoint=False, fused=False)),
              ("fused", dict(adjoint=False, fused=True)))
# Timed steps of each route (one, cut from three to keep the script within
# half its time limit: the adjoint group took 51.6 s on a fast H100 host
# and 126.8 s on a slow one, its latent routes' part 23.4 and 73.1 s).
ADJ_STEPS = 1
# The latent adjoint step on the card against the CPU's on the same draws,
# float32 on both: the forward's 155 Euler steps and the Milstein
# adjoint's sum in other orders (cuBLAS against the CPU's BLAS). Measured
# at 32 rows 9.4e-8 on the loss and 7.7e-7 of scale on the gradients
# (NVIDIA H100 80GB HBM3, 700 W); 16 rows now, the rows of this
# host-bound check cut for time; the limits leave a margin of about
# 10 over those, and
# the same step with TF32 matmuls, a fault of the card's precision, is
# read beside them (PERF.md section 2).
ADJ_CPU_ROWS = 16
ADJ_LOSS_RTOL = 1e-6
ADJ_GRAD_REL = 1e-5
# Peak memory of one latent train step: adjoint against backprop at these dt
# (1/128, not 1/1024, whose adjoint step alone takes about 22 s, keeps the
# script within half its time limit; PERF.md keeps the 1/1024 peaks; cut
# first to 1/512, then to 1/64 and 1/128: at 1/128 and 1/512 the part
# took 10.0 s on a fast H100 host, at 1/128 and 1/256 13.3 s on a slow
# one).
ADJ_MEMORY_DTS = (1.0 / 64, 1.0 / 128)


def route_grads_rel(label, grads, want):
    """The largest gap between two routes' gradients, each over its own
    largest entry; prints the worst four."""
    ratios = []
    for name, w in want.items():
        g = grads[name]
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise RuntimeError(f"{label}: non-finite gradient of {name}")
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.abs().max())
        if scale == 0 and err > 0:
            raise RuntimeError(f"{label}: gradient of {name} is zero on one "
                               f"route, {err:.3e} on the other")
        ratios.append((err / scale if scale > 0 else 0.0, name))
    ratios.sort(reverse=True)
    print(f"{label}: worst {[(n, f'{r:.3e}') for r, n in ratios[:4]]}",
          flush=True)
    return ratios[0]


def timed_steps(label, run, n=ADJ_STEPS):
    """``run()`` n times (host clock, synchronised); the median in ms."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"{label}: {', '.join(f'{t:.1f}' for t in times)} ms", flush=True)
    return float(np.median(times))


def phase_adjoint_gan(device):
    """The SDE-GAN train step at the reference widths with adjoint=True on
    the sdeint route (the reversible-Heun pair), its step-0 gradients
    within GAN_GRAD_REL of the fused route's (kernels 5-8) and of backprop
    through sdeint; each route's step timed and profiled."""
    ts, real = gan_data(device)
    grads = {}
    for name, kw in ADJ_ROUTES:
        gen = torch.Generator(device=device).manual_seed(900)
        _, g_gen, g_disc = gan_grads(*gan_models(device), gen, ts, real,
                                     dt=GAN_DT, **kw)
        grads[name] = {**{f"generator.{k}": v for k, v in g_gen.items()},
                       **{f"critic.{k}": v for k, v in g_disc.items()}}
    out = {}
    for other in ("fused", "sdeint"):
        rel, name = route_grads_rel(f"GAN adjoint vs {other} step 0",
                                    grads["adjoint"], grads[other])
        if rel > GAN_GRAD_REL:
            raise RuntimeError(f"GAN adjoint step-0 gradient of {name} is "
                               f"{rel:.3e} of its scale from the {other} "
                               f"route's > {GAN_GRAD_REL}")
        out[f"grad_rel_{other}"] = rel
    for name, kw in ADJ_ROUTES:
        models = gan_models(device)
        opts = (torch.optim.Adadelta(models[0].parameters(), lr=GAN_GEN_LR,
                                     weight_decay=GAN_WEIGHT_DECAY),
                torch.optim.Adadelta(models[1].parameters(),
                                     lr=GAN_CRITIC_LR,
                                     weight_decay=GAN_WEIGHT_DECAY))
        seeds = iter(range(910, 1000))

        def step():
            loss, grads_ = gan_train_step(models, opts, ts, real,
                                          next(seeds), **kw)
            if not (np.isfinite(float(loss))
                    and all(torch.isfinite(g).all() for g in grads_)):
                raise RuntimeError(f"GAN {name} step: non-finite loss or "
                                   f"gradient")

        step()   # warm-up
        out[f"{name}_ms"] = timed_steps(f"GAN train step {name}", step)
        out[f"{name}_profile"] = profile_run(f"GAN train step {name}", step,
                                             cpu=False)
    return out


def cpu_table_draws(eps, W):
    """The latent model's eps and its solve noise served from fixed tables,
    moved to the device a call asks for: the card's solve and the CPU's
    see the same draws, and the adjoint's redraw the draw."""
    normal, grid_noise = TL._standard_normal, TI.sample_grid_noise

    def standard_normal(shape, generator, dtype, device):
        return eps.to(device=device, dtype=dtype)

    def sample_grid_noise(generator, grid, size, dtype, device=None, **kw):
        return W.to(device=device, dtype=dtype), None, None

    @contextlib.contextmanager
    def patched():
        TL._standard_normal, TI.sample_grid_noise = standard_normal, \
            sample_grid_noise
        try:
            yield
        finally:
            TL._standard_normal, TI.sample_grid_noise = normal, grid_noise

    return patched()


def latent_grads(model, xs, ts, **kw):
    """The ELBO's loss and every parameter gradient of one call."""
    loss, _ = latent_sde_loss(model, xs, ts, torch.Generator(
        device=xs.device).manual_seed(1000), dt=DT, **kw)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss.detach(), dict(zip(names, grads))


def peak_step_mib(model, xs, ts, dt, adjoint):
    """Peak device memory (MiB) of one latent train step's loss and
    gradients, above what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss, _ = latent_sde_loss(model, xs, ts, torch.Generator(
        device=xs.device).manual_seed(1100), dt=dt, adjoint=adjoint)
    loss.backward()
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20, ms


def phase_adjoint_latent(device):
    """The flagship latent train step with adjoint=True (Euler forward on
    the 155-step interval grid, Milstein adjoint): against the CPU's on the
    same draws at ADJ_CPU_ROWS rows; timed and profiled beside the sdeint
    and fused routes; the peak memory of adjoint against backprop at each
    dt of ADJ_MEMORY_DTS; one rng_impl='philox' step whose backward's W is
    bitwise the forward's, kernel 16 launched once for each."""
    t0 = time.perf_counter()
    xs, ts = lorenz_data(device)
    out = {}
    # (a) the card against the CPU on one table of draws.
    grid = TI.build_interval_grid(ts, DT)[0]
    draws = torch.Generator().manual_seed(1200)
    eps = torch.randn((ADJ_CPU_ROWS, LATENT), generator=draws)
    W = torch.randn((len(grid) - 1, ADJ_CPU_ROWS, LATENT + 1),
                    generator=draws) * torch.as_tensor(
                        np.sqrt(np.diff(grid)), dtype=torch.float32)[:, None,
                                                                     None]
    model = flagship_model(device)
    rows = xs[:, :ADJ_CPU_ROWS]
    with cpu_table_draws(eps, W):
        loss, grads = latent_grads(model, rows, ts, adjoint=True)
        cpu_loss, cpu_grads = latent_grads(
            copy.deepcopy(model).to("cpu"), rows.cpu(), ts, adjoint=True)
        # The same step with TF32 matmuls: what a fault of the card's
        # precision reads against the limits (read, not checked).
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_loss, tf32_grads = latent_grads(model, rows, ts,
                                                 adjoint=True)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def card_vs_cpu(label, loss, grads):
        loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
        grad_rel, name = route_grads_rel(
            f"{label} card vs CPU", {k: v.cpu() for k, v in grads.items()},
            cpu_grads)
        print(f"{label}, {ADJ_CPU_ROWS} rows: loss {float(loss):.8g} card, "
              f"{float(cpu_loss):.8g} CPU, rel {loss_rel:.3e}", flush=True)
        return loss_rel, grad_rel, name

    loss_rel, grad_rel, name = card_vs_cpu("latent adjoint", loss, grads)
    tf32_loss_rel, tf32_grad_rel, _ = card_vs_cpu("latent adjoint, TF32",
                                                  tf32_loss, tf32_grads)
    if loss_rel > ADJ_LOSS_RTOL or grad_rel > ADJ_GRAD_REL:
        raise RuntimeError(f"latent adjoint card vs CPU: loss rel "
                           f"{loss_rel:.3e} > {ADJ_LOSS_RTOL} or gradient of "
                           f"{name} {grad_rel:.3e} > {ADJ_GRAD_REL}")
    out.update(cpu_loss_rel=loss_rel, cpu_grad_rel=grad_rel,
               tf32_loss_rel=tf32_loss_rel, tf32_grad_rel=tf32_grad_rel,
               a_s=time.perf_counter() - t0)
    # (b) the step at full width on each route.
    t0 = time.perf_counter()
    for name, kw in ADJ_ROUTES:
        model = flagship_model(device)
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        seeds = iter(range(1300, 1400))

        def step():
            opt.zero_grad(set_to_none=True)
            gen = torch.Generator(device=device).manual_seed(next(seeds))
            loss, _ = latent_sde_loss(model, xs, ts, gen, dt=DT, **kw)
            loss.backward()
            opt.step()
            if not (np.isfinite(float(loss.detach())) and all(
                    torch.isfinite(p.grad).all()
                    for p in model.parameters())):
                raise RuntimeError(f"latent {name} step: non-finite loss or "
                                   f"gradient")

        step()   # warm-up
        out[f"{name}_ms"] = timed_steps(f"latent train step {name}", step)
        out[f"{name}_profile"] = profile_run(f"latent train step {name}",
                                             step, cpu=False)
    out["b_s"] = time.perf_counter() - t0
    # (c) peak memory, adjoint against backprop.
    t0 = time.perf_counter()
    model = flagship_model(device)
    for dt in ADJ_MEMORY_DTS:
        for adjoint in (True, False):
            mib, ms = peak_step_mib(model, xs, ts, dt, adjoint)
            key = f"{'adjoint' if adjoint else 'sdeint'}_dt{round(1 / dt)}"
            out[f"peak_mib_{key}"], out[f"step_ms_{key}"] = mib, ms
            print(f"latent step {key}: peak {mib:.1f} MiB above the "
                  f"weights and data, {ms:.1f} ms", flush=True)
    out["c_s"] = time.perf_counter() - t0
    # (d) philox: the backward redraws the forward's W bitwise.
    t0 = time.perf_counter()
    drawn, grid_noise = [], TI.sample_grid_noise

    def recorded(*args, **kw):
        noise = grid_noise(*args, **kw)
        drawn.append(noise[0].clone())
        return noise

    TI.sample_grid_noise = recorded
    PR.launches = 0
    try:
        gen = torch.Generator(device=device).manual_seed(1500)
        loss, _ = latent_sde_loss(model, xs, ts, gen, dt=DT, adjoint=True,
                                  rng_impl="philox")
        after_forward = gen.get_state()
        loss.backward()
        torch.cuda.synchronize()
    finally:
        TI.sample_grid_noise = grid_noise
    if (len(drawn) != 2 or not torch.equal(drawn[0], drawn[1])
            or PR.launches != 2
            or not torch.equal(gen.get_state(), after_forward)):
        raise RuntimeError(f"philox adjoint: {len(drawn)} draws, bitwise "
                           f"{len(drawn) == 2 and torch.equal(*drawn)}, "
                           f"kernel 16 launched {PR.launches} times, "
                           f"generator moved by the backward")
    print(f"philox adjoint step: W {tuple(drawn[0].shape)} drawn and redrawn "
          f"bitwise, kernel 16 launched {PR.launches} times", flush=True)
    out.update(philox_launches=PR.launches, d_s=time.perf_counter() - t0)
    return out


def phase_adjoint(device):
    """Phase 26 (no kernel of its own): its record is the ``{"adjoint":
    ...}`` line, with each part's seconds."""
    t0 = time.perf_counter()
    record = {"gan": phase_adjoint_gan(device)}
    record["gan_s"] = time.perf_counter() - t0
    record["latent"] = phase_adjoint_latent(device)
    record["seconds"] = time.perf_counter() - t0
    print(json.dumps({"adjoint": record}), flush=True)


# --------------------------------------------------------------------------- #
#  Phase 27: adaptive stepping, in-loop noise, sparse outputs                 #
# --------------------------------------------------------------------------- #

# Configuration A, the JAX package's benchmarks/adaptive_bench.py:39-43,
# 104-114: ExDiagonal (d 3, Ito) with the mu and sigma its make_problem
# draws in float32 (tests/problems.py:45-56, PRNGKey(0)), batch 1024,
# y0 0.1, 9 outputs on [0, 2], dt0 1e-3, rtol 1e-5, atol 1e-4, dt_min
# 1e-5, float32, a BrownianInterval keyed as PRNGKey(42) at 20 levels.
ADA_MU = (-0.6155921816825867, -0.1983073353767395, -0.6543879508972168)
ADA_SIGMA = (0.7318471074104309, 0.2877499461174011, 0.32121968269348145)
ADA_B, ADA_TS = 1024, np.linspace(0.0, 2.0, 9)
# (a)'s solves of configuration A run over [0, 1] (5 of its 9 outputs),
# the first half of its span, to keep the script within half its time
# limit ((a) took 36.1 s on a fast H100 host and 77.5 s on a slow one at
# [0, 2], which PERF.md keeps).
ADA_FORWARD_TS = ADA_TS[:5]
ADA_DT0, ADA_RTOL, ADA_ATOL, ADA_DT_MIN = 1e-3, 1e-5, 1e-4, 1e-5
ADA_KEY, ADA_LEVELS = np.array([0, 42], np.uint32), 20
ADA_METHODS = (("srk", "space-time"), ("milstein", "none"))
# Timed runs of each solve in (a) (PERF.md keeps the spread of two).
ADA_REPS = 1
# (b)'s float64 card-against-CPU solves and (c)'s gradients run
# configuration A over [0, 0.25] (3 outputs): the first eighth of its span,
# to keep the script within half its time limit (PERF.md keeps [0, 2]; cut
# first to [0, 0.5], then to [0, 0.25]: (b) and (c) took 6.3 and 19.8 s
# of the adaptive group's 75.2 at [0, 0.5] on an H100 host).
ADA_CHECK_TS = np.linspace(0.0, 0.25, 3)
# (a)'s kernels an attempt come from short solves of A from this time (a
# two-attempt and a no-attempt one), small enough that the profiler loses
# few events (a whole solve's hundreds of thousands it drops by up to a
# fifth). Its kernels an attempt must be the card's aten ops an attempt
# within ADA_KERNELS_PER_OP. Back-to-back profiles of one short solve
# count a few events apart (14,641, 14,642 and 14,662 kernels of one
# two-attempt solve, one hash kernel 1,579 times and then 1,580; 453, 478
# and 464 of a no-attempt one), so each is profiled ADA_PROFILES times and
# counted by the median, the counts within ADA_PROFILE_SPREAD of it. Now
# and then a profile loses far more (318 kernels of a no-attempt srk solve
# beside 461 and 476 on an H100): a set that spreads wider is printed and
# taken again, ADA_PROFILE_SETS sets at most. The solve's stats are held
# to the CPU's before it is profiled, once. Two profiles a set (cut from
# three to keep the script within half its time limit): the median of two
# is the larger, and the spread bar holds the pair.
ADA_SHORT_T0 = 0.3
ADA_KERNELS_PER_OP = 0.1
ADA_PROFILES = 2
ADA_PROFILE_SPREAD = 0.1
ADA_PROFILE_SETS = 3
# Card against CPU in float64 on the whole batch: ys within this times
# (1 + max |y|), stats equal; gradients within ADA_GRAD_REL of each
# gradient's largest entry (float64 sums in other orders).
ADA_F64_REL, ADA_GRAD_REL = 1e-9, 1e-8
# The adjoint modes of (c) step their fixed direction at ADA_ADJ_DT and
# the merged adaptive backward at ADA_ADJ_TOL (rtol and atol): at dt 1e-3
# the fixed backward is 2,000 Milstein adjoint steps, and at rtol 1e-5 /
# atol 1e-4 the merged backward took 420 attempts (the augmented state
# holds the parameters' gradients, sums over 1,024 rows), 30-90 s for the
# CPU twin alone.
ADA_ADJ_DT, ADA_ADJ_TOL = 1e-2, 1e-3
# (f)'s output times.
ADA_REPLAY_TS = np.linspace(0.0, 1.0, 3)
ADA_BUDGET = 16
# Configuration B: srk_fused.py's largest shape, ExDiagonal Euler at
# (16384, 128) float32 on [0, 1], dt 1/256, 5 outputs, no grad: its W
# alone is 2 GiB and its 257 grid states 2 GiB, so the default policy
# makes the noise in the loop, and the solve keeps only the bracketing
# states. The default run must peak at least ADA_B_SAVED bytes below the
# dense yardstick (precomputed noise, every state kept) and
# ADA_B_NOISE_SAVED below noise_precompute=True.
ADA_B_SHAPE, ADA_B_DT, ADA_B_TS = (16384, 128), 1.0 / 256, \
    np.linspace(0.0, 1.0, 5)
ADA_B_SAVED, ADA_B_NOISE_SAVED = 3.5 * 2 ** 30, 1.5 * 2 ** 30
# Object mode bitwise at BM_SIZES' widest over 100 steps (a 20-level
# interval: every step descends two points in the loop).
ADA_OBJ_STEPS = 100
# In-loop replay: adjoint against backprop on one stream, within the JAX
# package's 1e-3 of scale (tests/test_noise_memory.py:128-154).
ADA_REPLAY_REL = 1e-3


class AdaSDE(torch.nn.Module):
    """ExDiagonal with configuration A's mu and sigma, in ``dtype``:
    Ito f = mu y, g = sigma y, or its Stratonovich form."""
    noise_type = "diagonal"

    def __init__(self, device, dtype, sde_type="ito", mu=ADA_MU,
                 sigma=ADA_SIGMA):
        super().__init__()
        self.sde_type = sde_type
        self.mu = torch.nn.Parameter(torch.tensor(
            mu, dtype=torch.float32).to(device, dtype))
        self.sigma = torch.nn.Parameter(torch.tensor(
            sigma, dtype=torch.float32).to(device, dtype))

    def f(self, t, y):
        if self.sde_type == "ito":
            return self.mu * y
        return self.mu * y - 0.5 * self.sigma ** 2 * y

    def g(self, t, y):
        return self.sigma * y


def ada_interval(levy, device, dtype=torch.float32, t1=2.0, size=None):
    return BrownianInterval(0.0, t1, size or (ADA_B, 3), dtype=dtype,
                            key=ADA_KEY, levels=ADA_LEVELS,
                            levy_area_approximation=levy, device=device)


def ada_solve(method, levy, device, dtype=torch.float32, ts=ADA_TS, **kw):
    """Configuration A by ``method`` (no grad) to the outputs ``ts``:
    ``(ys, stats)``."""
    sde = AdaSDE(device, dtype)
    with torch.no_grad():
        return sdeint(sde, torch.full((ADA_B, 3), 0.1, dtype=dtype,
                                      device=device), ts,
                      bm=ada_interval(levy, device, dtype), method=method,
                      dt=ADA_DT0, adaptive=True, rtol=ADA_RTOL, atol=ADA_ATOL,
                      dt_min=ADA_DT_MIN, return_stats=True, **kw)


def ada_rms(ys, levy, device, ts=ADA_FORWARD_TS):
    """RMS of ys (at the outputs ``ts``) against ExDiagonal's exact
    solution y0 exp((mu - sigma^2 / 2) t + sigma W(0, t)) on the same
    interval."""
    bm = ada_interval(levy, device)
    mu = torch.tensor(ADA_MU, device=device)
    sigma = torch.tensor(ADA_SIGMA, device=device)
    exact = [torch.full((ADA_B, 3), 0.1, device=device)] + [
        0.1 * torch.exp((mu - 0.5 * sigma ** 2) * float(t)
                        + sigma * bm(0.0, float(t))) for t in ts[1:]]
    return float(torch.sqrt(((ys - torch.stack(exact)) ** 2).mean()))


def peak_mib(fn):
    """``fn()`` and the peak device memory (MiB) above what was allocated
    before it, and its ms (host clock, synchronised)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, ms = timed_ms(fn)
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 20, ms


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched on any device, views left out (they
    launch nothing): on the card each such op is a kernel or a copy in
    eager PyTorch. Autograd's worker threads inherit the mode, so a
    backward's ops count too."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def counted(fn):
    """``fn()`` and the number of aten ops it dispatched (``OpCount``)."""
    with OpCount() as count:
        out = fn()
    return out, count.ops


def ada_short(method, levy, device, n_out):
    """Configuration A from ADA_SHORT_T0 to ``n_out - 1`` steps of dt0
    later, on its interval, batch and tolerances: two attempts for
    ``n_out`` 3, none (the solve's fixed cost) for 1."""
    sde = AdaSDE(device, torch.float32)
    ts = ADA_SHORT_T0 + ADA_DT0 * np.arange(n_out)
    with torch.no_grad():
        return sdeint(sde, torch.full((ADA_B, 3), 0.1, device=device), ts,
                      bm=ada_interval(levy, device), method=method,
                      dt=ADA_DT0, adaptive=True, rtol=ADA_RTOL, atol=ADA_ATOL,
                      dt_min=ADA_DT_MIN, return_stats=True)


def ada_profiles(label, fn):
    """ADA_PROFILES profiles of ``fn`` (device activity alone) and the one
    at the median count, the counts within ADA_PROFILE_SPREAD of it
    (profiles of one solve count a few events apart). A set that spreads
    wider is printed and taken again, ADA_PROFILE_SETS sets at most; the
    counts of the set kept, in the order taken, and the sets taken."""
    for n_set in range(1, ADA_PROFILE_SETS + 1):
        profs = [profile_run(label, fn, cpu=False)
                 for _ in range(ADA_PROFILES)]
        counts = [p["kernels"] for p in profs]
        median = sorted(profs, key=lambda p: p["kernels"])[len(profs) // 2]
        spread = (max(counts) - min(counts)) / median["kernels"]
        if spread <= ADA_PROFILE_SPREAD:
            return median, counts, n_set
        print(f"{label}: profiled kernels {counts} spread {spread:.3f} > "
              f"{ADA_PROFILE_SPREAD} (the profiler lost events), set "
              f"{n_set} of {ADA_PROFILE_SETS}", flush=True)
    raise RuntimeError(f"{label}: {ADA_PROFILE_SETS} sets of profiles, the "
                       f"last counting kernels {counts}")


def ada_per_attempt(method, levy, device):
    """Kernels, device ms and aten ops an attempt, from a two-attempt solve
    less the same solve with no attempt, each with the CPU's stats and
    taken at the median of its profiles (``ada_profiles``), and the kernels
    must be the card's aten ops within ADA_KERNELS_PER_OP; the CPU's aten
    ops of the same solves beside them."""
    rec = {}
    for n_out in (3, 1):
        (_, stats), card_ops = counted(lambda: ada_short(method, levy, device,
                                                         n_out))
        (_, cpu_stats), cpu_ops = counted(lambda: ada_short(method, levy,
                                                            "cpu", n_out))
        if stats != cpu_stats:
            raise RuntimeError(f"adaptive {method} short solve: stats "
                               f"{stats} on the card and {cpu_stats} on "
                               f"the CPU")
        median, counts, sets = ada_profiles(
            f"adaptive {method} A, {n_out} outputs from {ADA_SHORT_T0}",
            lambda: ada_short(method, levy, device, n_out))
        rec[n_out] = dict(stats=stats, card_ops=card_ops, cpu_ops=cpu_ops,
                          kernels=median["kernels"],
                          device_ms=median["device_ms"],
                          busy=median["busy"], profiled_kernels=counts,
                          profile_sets=sets)
    attempts = rec[3]["stats"]["n_accepted"] + rec[3]["stats"]["n_rejected"]
    per = {k: (rec[3][k] - rec[1][k]) / attempts
           for k in ("kernels", "card_ops", "cpu_ops", "device_ms")}
    ratio = per["kernels"] / per["card_ops"]
    if attempts < 1 or abs(ratio - 1) > ADA_KERNELS_PER_OP:
        raise RuntimeError(f"adaptive {method}: {attempts} attempts, "
                           f"{per['kernels']:.1f} kernels and "
                           f"{per['card_ops']:.1f} aten ops an attempt")
    print(f"adaptive {method} A an attempt ({attempts} attempts less none): "
          f"{per['kernels']:.1f} kernels, {per['card_ops']:.1f} aten ops on "
          f"the card, {per['cpu_ops']:.1f} on the CPU, device "
          f"{per['device_ms']:.4f} ms; the solve's fixed cost "
          f"{rec[1]['kernels']} kernels; busy {rec[3]['busy']:.3f}",
          flush=True)
    return dict(short=rec, attempts=attempts, **{f"{k}_per_attempt": v
                                                   for k, v in per.items()},
                kernels_per_op=ratio)


def phase_adaptive_forward(device):
    """(a) configuration A (to ADA_FORWARD_TS) by srk and milstein on the
    card: stats, median
    ms, kernels and device ms an attempt (``ada_per_attempt``), the solve's
    aten ops (counted) and from them its kernels and device ms, the busy
    share, RMS against the exact solution; the same-work fixed solve (dt =
    span / n_accepted, the same interval) and the ratio."""
    out = {}
    for method, levy in ADA_METHODS:
        per = ada_per_attempt(method, levy, device)
        (ys, stats), ops = counted(lambda: ada_solve(
            method, levy, device, ts=ADA_FORWARD_TS))
        times = [timed_ms(lambda: ada_solve(method, levy, device,
                                            ts=ADA_FORWARD_TS))[1]
                 for _ in range(ADA_REPS)]
        attempts = stats["n_accepted"] + stats["n_rejected"]
        if stats["incomplete"] or not torch.isfinite(ys).all() or tuple(
                ys.shape) != (len(ADA_FORWARD_TS), ADA_B, 3):
            raise RuntimeError(f"adaptive {method}: incomplete, not finite "
                               f"or misshapen")
        rms = ada_rms(ys, levy, device)
        dt_fixed = (ADA_FORWARD_TS[-1] - ADA_FORWARD_TS[0]) / stats[
            "n_accepted"]
        sde = AdaSDE(device, torch.float32)
        y0 = torch.full((ADA_B, 3), 0.1, device=device)

        def fixed():
            with torch.no_grad():
                return sdeint(sde, y0, ADA_FORWARD_TS,
                              bm=ada_interval(levy, device), method=method,
                              dt=dt_fixed)

        fixed()
        fixed_ms = float(np.median([timed_ms(fixed)[1]
                                    for _ in range(ADA_REPS)]))
        ms = float(np.median(times))
        kernels = ops * per["kernels_per_op"]
        device_ms = per["device_ms_per_attempt"] * attempts
        rec = dict(stats=stats, attempts=attempts, ms=times, median_ms=ms,
                   ops=ops, kernels=kernels, device_ms=device_ms,
                   busy=device_ms / ms, per_attempt=per, rms=rms,
                   fixed_dt=dt_fixed, fixed_ms=fixed_ms, ratio=ms / fixed_ms)
        print(f"adaptive {method} A: {stats}, {ms:.1f} ms median of "
              f"{', '.join(f'{t:.1f}' for t in times)}, {ops} aten ops "
              f"({ops / attempts:.0f} an attempt), so about {kernels:.0f} "
              f"kernels and device {device_ms:.1f} ms (busy "
              f"{device_ms / ms:.3f}); RMS vs exact {rms:.3e}; same-work "
              f"fixed (dt {dt_fixed:.5f}) {fixed_ms:.1f} ms, ratio "
              f"{ms / fixed_ms:.1f}", flush=True)
        out[method] = rec
    return out


def phase_adaptive_cpu(device):
    """(b) configuration A to ADA_CHECK_TS in float64 on the card and on
    the CPU, whole batch: stats equal, ys within ADA_F64_REL of scale."""
    out = {}
    for method, levy in ADA_METHODS:
        ys, stats = ada_solve(method, levy, device, torch.float64,
                              ADA_CHECK_TS)
        want, want_stats = ada_solve(method, levy, "cpu", torch.float64,
                                     ADA_CHECK_TS)
        err = float((ys.cpu() - want).abs().max())
        scale = 1.0 + float(want.abs().max())
        if stats != want_stats or err > ADA_F64_REL * scale:
            raise RuntimeError(f"adaptive {method} float64: card {stats}, "
                               f"CPU {want_stats}, max |diff| {err:.3e} > "
                               f"{ADA_F64_REL} x {scale:.3f}")
        print(f"adaptive {method} A float64: card and CPU {stats}, max "
              f"|diff| {err:.3e}", flush=True)
        out[method] = dict(stats=stats, cpu_err=err)
    return out


def ada_grads(device, mode, ts=ADA_CHECK_TS, **extra):
    """d sum(ys) / d(y0, mu, sigma) of configuration A to the outputs
    ``ts`` in float64 by
    ``mode``: backprop through ``sdeint(adaptive=True)`` (srk; its default
    budget ``default_max_steps``, 8,018 iterations),
    ``sdeint_adjoint(adaptive=True)`` or ``sdeint_adjoint(
    adjoint_adaptive=True)`` (srk forward, Milstein adjoint; at
    ADA_ADJ_DT and ADA_ADJ_TOL). Returns ``(grads, ys, stats)``;
    ``adjoint_max_steps`` in ``extra`` asks for a double backward's
    graph."""
    sde = AdaSDE(device, torch.float64)
    y0 = torch.full((ADA_B, 3), 0.1, dtype=torch.float64, device=device,
                    requires_grad=True)
    bm = ada_interval("space-time", device, torch.float64)
    kw = dict(bm=bm, method="srk", dt_min=ADA_DT_MIN, rtol=ADA_RTOL,
              atol=ADA_ATOL, **extra)
    stats = None
    if mode == "backprop":
        ys, stats = sdeint(sde, y0, ts, dt=ADA_DT0, adaptive=True,
                           return_stats=True, **kw)
    else:
        ys = sdeint_adjoint(sde, y0, ts, dt=ADA_ADJ_DT,
                            adjoint_rtol=ADA_ADJ_TOL,
                            adjoint_atol=ADA_ADJ_TOL, **{mode: True}, **kw)
    create = extra.get("adjoint_max_steps") is not None
    grads = torch.autograd.grad(ys.sum(), [y0, sde.mu, sde.sigma],
                                create_graph=create)
    return grads, ys, stats


def phase_adaptive_grads(device, kernels_per_op):
    """(c) gradients by the three modes on the card against the CPU, with
    ms, peak memory and aten ops (counted; kernels about ``kernels_per_op``
    times as many, (a)'s ratio); (d) the exhausted budgets."""
    out = {}
    for mode in ("backprop", "adaptive", "adjoint_adaptive"):
        (grads, ys, stats), mib, ms = peak_mib(lambda: ada_grads(device,
                                                                 mode))
        _, ops = counted(lambda: ada_grads(device, mode))
        want, _, want_stats = ada_grads("cpu", mode)
        rel = max(float((g.cpu() - w).abs().max()) / float(w.abs().max())
                  for g, w in zip(grads, want))
        if not all(torch.isfinite(g).all() for g in grads) or \
                rel > ADA_GRAD_REL or stats != want_stats:
            raise RuntimeError(f"adaptive gradients {mode}: card vs CPU "
                               f"{rel:.3e} > {ADA_GRAD_REL}, or stats "
                               f"{stats} vs {want_stats}")
        rec = dict(ms=ms, peak_mib=mib, ops=ops,
                   kernels=ops * kernels_per_op, cpu_rel=rel)
        if stats is not None:
            rec.update(stats=stats, iterations=stats["n_accepted"]
                       + stats["n_rejected"] + len(ADA_CHECK_TS) - 1,
                       max_steps=TS_MOD.default_max_steps(
                           ADA_CHECK_TS, ADA_DT0, ADA_DT_MIN))
        print(f"adaptive gradients {mode}: {ms:.1f} ms, peak {mib:.1f} MiB, "
              f"{ops} aten ops (about {rec['kernels']:.0f} kernels), card "
              f"vs CPU {rel:.3e}"
              + (f", {rec['iterations']} iterations of a budget of "
                 f"{rec['max_steps']} ({stats})" if stats else ""),
              flush=True)
        out[mode] = rec
    # (d) budgets run out: a backprop solve, a double backward.
    grads, ys, stats = ada_grads(device, "backprop", ADA_TS,
                                 max_steps=ADA_BUDGET)
    reached = int(torch.isfinite(ys).all(dim=(1, 2)).sum())
    if not (stats["incomplete"] and reached < len(ADA_TS)
            and torch.isnan(ys[-1]).all()):
        raise RuntimeError(f"max_steps={ADA_BUDGET}: {stats}, {reached} "
                           f"outputs reached")
    grads, _, _ = ada_grads(device, "adjoint_adaptive", ADA_TS,
                            adjoint_max_steps=ADA_BUDGET)
    if not all(torch.isnan(g).all() for g in grads):
        raise RuntimeError(f"adjoint_max_steps={ADA_BUDGET} under "
                           f"create_graph: a gradient is not NaN")
    print(f"budgets of {ADA_BUDGET}: backprop {stats}, {reached} of "
          f"{len(ADA_TS)} outputs reached, the rest NaN; double "
          f"backward's gradients NaN", flush=True)
    out["budget"] = dict(stats=stats, reached=reached)
    return out


def dense_fixed_solve(sde, y0, ts, dt, generator):
    """(e)'s yardstick, the port's fixed-step Euler solve as it was before
    sparse outputs and in-loop noise: every increment drawn before the loop
    (``sample_grid_noise``), every grid state kept, then interpolated onto
    ``ts`` (``linear_interp_on_grid``)."""
    solver = SOLVERS.select(method="euler", sde_type="ito")(
        sde=ForwardSDE(sde), bm=None, dt=dt, options={})
    grid = TI.build_step_grid(ts[0], ts[-1], dt)
    noise = TI.sample_grid_noise(generator, grid, tuple(y0.shape), y0.dtype,
                                 y0.device)
    states, _ = TI.integrate_to_outputs(solver, y0, (), grid,
                                        np.arange(len(grid)), noise)
    grid_dev = torch.as_tensor(grid, dtype=y0.dtype, device=y0.device)
    return TI.linear_interp_on_grid(torch.as_tensor(
        ts, dtype=y0.dtype, device=y0.device), grid_dev, states)


def phase_adaptive_memory(device):
    """(e) configuration B: the default policy (in-loop noise, the kept
    bracketing states) against noise_precompute=True (the same kept
    states) and against ``dense_fixed_solve`` (precomputed noise, every
    state), peak memory and ms; the moments of y_T; object mode bitwise at
    (512, 256); the philox warning."""
    B, d = ADA_B_SHAPE
    rng = np.random.default_rng(SEED + 300 + d)   # srk_problem's draws
    sigma = 1 / (1 + np.exp(-rng.standard_normal(d)))
    mu = -sigma ** 2 - 1 / (1 + np.exp(-rng.standard_normal(d)))
    sde = AdaSDE(device, torch.float32, mu=tuple(mu), sigma=tuple(sigma))
    y0 = torch.full((B, d), 0.1, device=device)
    grid = TI.build_step_grid(0.0, 1.0, ADA_B_DT)
    w_bytes = TI.noise_buffer_bytes(len(grid) - 1, (B, d), torch.float32,
                                    False, False)
    s_bytes = len(grid) * y0.numel() * y0.element_size()
    if TI.should_precompute_noise(len(grid) - 1, (B, d), torch.float32,
                                  False, False):
        raise RuntimeError("configuration B's noise does not pass the "
                           "threshold")

    def gen():
        return torch.Generator(device=device).manual_seed(SEED + 700)

    def solve(**kw):
        with torch.no_grad():
            return sdeint(sde, y0, ADA_B_TS, method="euler", dt=ADA_B_DT,
                          generator=gen(), **kw)

    def dense():
        with torch.no_grad():
            return dense_fixed_solve(sde, y0, ADA_B_TS, ADA_B_DT, gen())

    solve()
    ys, mib, ms = peak_mib(solve)
    pre, pre_mib, pre_ms = peak_mib(lambda: solve(noise_precompute=True))
    ref, dense_mib, dense_ms = peak_mib(dense)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        solve(rng_impl="philox")
    philox = any("rng_impl='philox'" in str(w.message) for w in caught)
    # E y_T = y0 exp(mu T), each channel's mean over B rows; Euler at dt
    # 1/256 is biased by about mu^2 dt / 2 (0.5 %), the mean's spread by
    # sqrt(exp(sigma^2) - 1) / sqrt(B) (1 %).
    expect = 0.1 * torch.exp(torch.as_tensor(mu, dtype=torch.float32,
                                             device=device))
    errs = [float((y[-1].mean(0) / expect - 1).abs().max())
            for y in (ys, pre, ref)]
    saved = (dense_mib - mib) * 2 ** 20
    noise_saved = (pre_mib - mib) * 2 ** 20
    if not all(torch.isfinite(y).all() for y in (ys, pre, ref)) or \
            not torch.equal(pre, ref) or max(errs) > 0.06 or \
            saved < ADA_B_SAVED or noise_saved < ADA_B_NOISE_SAVED or \
            not philox:
        raise RuntimeError(f"configuration B: peak {mib:.1f} MiB default, "
                           f"{pre_mib:.1f} MiB precomputed, {dense_mib:.1f} "
                           f"MiB dense, precomputed bitwise dense "
                           f"{torch.equal(pre, ref)}, means {errs} from E "
                           f"y_T, philox warned {philox}")
    print(f"configuration B {ADA_B_SHAPE} Euler, 256 steps: W "
          f"{w_bytes / 2 ** 30:.2f} GiB, states {s_bytes / 2 ** 30:.2f} GiB; "
          f"default (in-loop) peak {mib:.1f} MiB, {ms:.1f} ms; "
          f"noise_precompute=True peak {pre_mib:.1f} MiB, {pre_ms:.1f} ms, "
          f"bitwise the dense yardstick's ys; dense peak {dense_mib:.1f} "
          f"MiB, {dense_ms:.1f} ms; saved {saved / 2 ** 30:.2f} GiB "
          f"({noise_saved / 2 ** 30:.2f} by the noise); y_T means within "
          f"{', '.join(f'{e:.3e}' for e in errs)} of E y_T; philox warns",
          flush=True)
    del ys, pre, ref
    # Object mode bitwise at (512, 256) over 100 steps.
    size = BM_SIZES[-1]
    bm = BrownianInterval(0.0, 1.0, size, dtype=torch.float32,
                          entropy=SOLVE_ENTROPY, levels=ADA_LEVELS,
                          levy_area_approximation="space-time", device=device)
    rng = np.random.default_rng(SEED + 300 + size[1])
    sigma = 1 / (1 + np.exp(-rng.standard_normal(size[1])))
    mu = -sigma ** 2 - 1 / (1 + np.exp(-rng.standard_normal(size[1])))
    sde = AdaSDE(device, torch.float32, mu=tuple(mu), sigma=tuple(sigma))
    y0 = torch.full(size, 0.1, device=device)
    with torch.no_grad():
        a, a_ms = timed_ms(lambda: sdeint(
            sde, y0, ADA_B_TS, bm=bm, method="srk", dt=1.0 / ADA_OBJ_STEPS,
            noise_precompute=True))
        c, c_ms = timed_ms(lambda: sdeint(
            sde, y0, ADA_B_TS, bm=bm, method="srk", dt=1.0 / ADA_OBJ_STEPS,
            noise_precompute=False))
    if not torch.equal(a, c):
        raise RuntimeError("object mode in the loop is not bitwise the "
                           "precomputed solve")
    print(f"object mode {size} srk over {ADA_OBJ_STEPS} steps: in-loop "
          f"{c_ms:.1f} ms bitwise precomputed {a_ms:.1f} ms", flush=True)
    return dict(w_gib=w_bytes / 2 ** 30, states_gib=s_bytes / 2 ** 30,
                peak_mib=mib, ms=ms, precompute_peak_mib=pre_mib,
                precompute_ms=pre_ms, dense_peak_mib=dense_mib,
                dense_ms=dense_ms, saved_gib=saved / 2 ** 30,
                noise_saved_gib=noise_saved / 2 ** 30, mean_errs=errs,
                object_ms=c_ms, object_precompute_ms=a_ms)


def phase_adaptive_replay(device):
    """(f) adjoint gradients on the in-loop default stream against
    backprop through sdeint on the same stream (one generator seed, one
    key), Stratonovich midpoint, float64, the diffusion a tenth of
    configuration A's as ``tests/problems.py``'s NeuralDiagonal scales
    its own (the JAX package's check, so the two discretisations' gap is
    well below the bound; a backward on other noise misses it by far)."""
    grads = []
    for solve in (sdeint_adjoint, sdeint):
        sde = AdaSDE(device, torch.float64, "stratonovich",
                     sigma=tuple(0.1 * s for s in ADA_SIGMA))
        y0 = torch.full((ADA_B, 3), 0.1, dtype=torch.float64, device=device,
                        requires_grad=True)
        ys = solve(sde, y0, ADA_REPLAY_TS, method="midpoint", dt=1.0 / 64,
                   generator=torch.Generator(device=device).manual_seed(
                       SEED + 800), noise_precompute=False)
        grads.append(torch.autograd.grad((ys[-1] ** 2).sum() + ys[1].sum(),
                                         [y0, sde.mu, sde.sigma]))
    scale = max(float(g.abs().max()) for g in grads[1])
    err = max(float((a - b).abs().max()) for a, b in zip(*grads)) / scale
    if err > ADA_REPLAY_REL:
        raise RuntimeError(f"in-loop replay: adjoint vs backprop {err:.3e} "
                           f"of scale > {ADA_REPLAY_REL}")
    print(f"in-loop replay: adjoint vs backprop on one stream {err:.3e} of "
          f"scale", flush=True)
    return dict(rel=err)


def phase_adaptive(device):
    """Phase 27 (no kernel of its own): its record is the ``{"adaptive":
    ...}`` line, with each part's seconds."""
    record = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        record[name] = fn(device, *args)
        record[f"{name}_s"] = time.perf_counter() - t0
        print(f"adaptive ({name}): {record[f'{name}_s']:.1f} s", flush=True)

    part("a", phase_adaptive_forward)
    part("b", phase_adaptive_cpu)
    part("c", phase_adaptive_grads, float(np.mean(
        [record["a"][m]["per_attempt"]["kernels_per_op"]
         for m, _ in ADA_METHODS])))
    part("e", phase_adaptive_memory)
    part("f", phase_adaptive_replay)
    print(json.dumps({"adaptive": record}), flush=True)


# --------------------------------------------------------------------------- #
#  Phase 28: traced ts (no kernel)                                            #
# --------------------------------------------------------------------------- #

TRACED_SIZE = (512, 16)
TRACED_HIDDEN = 64
TRACED_DT = 1.0 / 100
# The schedule of parts (a) and (b), and the two a captured graph replays.
TRACED_TS = (0.0, 0.137, 0.29, 0.5, 0.77, 1.0)
TRACED_REPLAY_TS = (0.0, 0.21, 0.33, 0.61, 0.8, 0.95)
TRACED_REL = 1e-9
TRACED_ENTRIES = (("sdeint", sdeint), ("sdeint_adjoint", sdeint_adjoint))


class TracedSDE(torch.nn.Module):
    """A diagonal Ito SDE: a tanh MLP drift that reads the time, a sigmoid
    diffusion; seeded weights on ``device`` in ``dtype``."""
    noise_type, sde_type = "diagonal", "ito"

    def __init__(self, device, dtype, seed=SEED + 28):
        super().__init__()
        d, h = TRACED_SIZE[1], TRACED_HIDDEN
        gen = torch.Generator().manual_seed(seed)

        def param(shape, scale):
            w = torch.randn(shape, generator=gen, dtype=torch.float64)
            return torch.nn.Parameter((w * scale).to(device, dtype))

        self.w1, self.b1 = param((d, h), d ** -0.5), param((h,), 0.1)
        self.w2 = param((h, d), h ** -0.5)
        self.wg, self.bg = param((d, d), d ** -0.5), param((d,), 0.1)

    def f(self, t, y):
        return torch.tanh(y @ self.w1 + self.b1 * t) @ self.w2 - 0.5 * y

    def g(self, t, y):
        return 0.3 * torch.sigmoid(y @ self.wg + self.bg)


def traced_interval(device, dtype):
    return BrownianInterval(0.0, 1.0, TRACED_SIZE, dtype=dtype, entropy=28,
                            device=device)


def traced_run(solve, device, sched, dtype=torch.float64):
    """Values and the gradients of sum(ys^2) + sum(ys[1]) to ts, y0 and the
    SDE's parameters of one Euler solve (a Milstein adjoint) with a traced
    ts on ``device``, as CPU tensors."""
    sde = TracedSDE(device, dtype)
    y0 = torch.full(TRACED_SIZE, 0.1, dtype=dtype, device=device,
                    requires_grad=True)
    ts = torch.tensor(sched, dtype=dtype, device=device, requires_grad=True)
    ys = solve(sde, y0, ts, bm=traced_interval(device, dtype),
               method="euler", dt=TRACED_DT)
    grads = torch.autograd.grad((ys ** 2).sum() + ys[1].sum(),
                                [ts, y0] + list(sde.parameters()))
    return [ys.detach().cpu()] + [g.cpu() for g in grads]


def traced_card_vs_cpu(device):
    """(a) Each entry point's values and gradients on the card against the
    CPU's in float64, each tensor within TRACED_REL of its scale; (b) the
    poison on the card, values and gradients."""
    out = {}
    for name, solve in TRACED_ENTRIES:
        traced_run(solve, device, TRACED_TS)   # warm-up
        (card, ms) = timed_ms(lambda: traced_run(solve, device, TRACED_TS))
        cpu = traced_run(solve, torch.device("cpu"), TRACED_TS)
        rel = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(card, cpu))
        if not (all(bool(torch.isfinite(b).all()) for b in cpu)
                and rel <= TRACED_REL):
            raise RuntimeError(f"traced ts ({name}): card vs CPU {rel:.3e}")
        shifted = traced_run(solve, device, (0.1,) + TRACED_TS[1:])
        over = traced_run(solve, device, TRACED_TS[:-1] + (1.1,))
        if not all(bool(torch.isnan(x).all()) for x in shifted + over):
            raise RuntimeError(f"traced ts ({name}): a schedule off the "
                               f"grid is not NaN in values and gradients")
        out[name] = dict(rel_err=rel, card_ms=ms,
                         ts_grad=card[1].tolist())
        print(f"traced ts ({name}): card vs CPU {rel:.3e}, {ms:.1f} ms; "
              f"off-grid schedules NaN in values and gradients", flush=True)
    return out


def traced_capture(device):
    """(c) One whole float32 ``sdeint`` call with a CUDA ts captured as a
    CUDA graph: first an eager traced call under
    ``torch.cuda.set_sync_debug_mode("error")`` (any synchronising op
    raises), then the capture, then replays on two schedules copied into
    the captured ts, each against an eager traced call on it, and one past
    the interval's end (NaN)."""
    sde = TracedSDE(device, torch.float32).requires_grad_(False)
    bm = traced_interval(device, torch.float32)
    y0 = torch.full(TRACED_SIZE, 0.1, device=device)
    scheds = {name: torch.tensor(s, device=device) for name, s in (
        ("a", TRACED_TS), ("b", TRACED_REPLAY_TS),
        ("over", TRACED_TS[:-1] + (1.1,)))}

    def eager(sched):
        with torch.no_grad():
            return sdeint(sde, y0, sched.clone().requires_grad_(True), bm=bm,
                          method="euler", dt=TRACED_DT)

    eager(scheds["a"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager(scheds["a"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    want = {name: eager(s) for name, s in scheds.items()}
    eager_ms = median_cuda_ms(lambda: eager(scheds["b"]), 3, warmup=1)

    ts_static = scheds["a"].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager(ts_static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        ys_static = sdeint(sde, y0, ts_static, bm=bm, method="euler",
                           dt=TRACED_DT)
    dist = {}
    for name in ("b", "a", "over"):
        ts_static.copy_(scheds[name])
        graph.replay()
        torch.cuda.synchronize()
        if name == "over":
            if not bool(torch.isnan(ys_static).all()):
                raise RuntimeError("traced ts: a replay past bm.t1 is not "
                                   "NaN")
            continue
        dist[name] = float((ys_static - want[name]).abs().max())
        if not bool(torch.isfinite(ys_static).all()):
            raise RuntimeError(f"traced ts: replay {name} is not finite")
    ts_static.copy_(scheds["b"])
    replay_ms = median_cuda_ms(graph.replay, 5)
    if max(dist.values()) > 0.0:
        raise RuntimeError(f"traced ts: replays differ from the eager calls "
                           f"by {dist}")
    print(f"traced ts (capture): no synchronising op; replays bitwise the "
          f"eager calls; replay {replay_ms:.3f} ms, eager {eager_ms:.3f} "
          f"ms", flush=True)
    return dict(sync_free=True, replay_vs_eager_max_abs=dist,
                replay_ms=replay_ms, eager_ms=eager_ms,
                steps=int(round(1.0 / TRACED_DT)))


def phase_traced_ts(device):
    """Phase 28 (no kernel: traced ts is plain PyTorch). Its record is the
    ``{"traced_ts": ...}`` line, with each part's seconds."""
    record = {}
    for name, fn in (("ab", traced_card_vs_cpu), ("c", traced_capture)):
        t0 = time.perf_counter()
        record[name] = fn(device)
        record[f"{name}_s"] = time.perf_counter() - t0
    print(json.dumps({"traced_ts": record}), flush=True)


# --------------------------------------------------------------------------- #
#  Phase 29: the continuous DDPM (no kernel)                                  #
# --------------------------------------------------------------------------- #

# results/RESULTS.md section 2 (the reference's cont_ddpm.py:305-309): a
# U-Net of base 64, ch_mults (1, 2, 4), on 1x28x28 images, batch 128, Adam
# at 2e-4; reverse-SDE samples at dt 1e-2 with denoise_t 0.05.
DDPM_BASE, DDPM_MULTS, DDPM_SIZE = 64, (1, 2, 4), 28
DDPM_BATCH, DDPM_LR, DDPM_DATA = 128, 2e-4, 512
DDPM_STEPS = 60
DDPM_DT, DDPM_DENOISE_T = 1e-2, 0.05
DDPM_SDE_SAMPLES, DDPM_ODE_SAMPLES = 128, 4
DDPM_CPU_BATCH = 8
DDPM_REL = 1e-9
# The float32 time embedding on the card against the CPU's: two float32
# epsilons (its values lie in [-1, 1]).
DDPM_EMBED_EPS = 2 * float(np.finfo(np.float32).eps)


def ddpm_blobs(n, seed):
    """``examples/cont_ddpm.py:105-112`` at 28x28: one gaussian blob of
    width H/8 at a uniform position in the central half, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    H = DDPM_SIZE
    cx, cy = (rng.uniform(0.25 * H, 0.75 * H, (n, 1, 1)) for _ in range(2))
    yy, xx = np.mgrid[0:H, 0:H]
    img = np.exp(-((xx[None] - cx) ** 2 + (yy[None] - cy) ** 2)
                 / (2 * (H / 8) ** 2))
    return (img * 2 - 1)[:, None].astype(np.float32)


def ddpm_model(device, dtype=torch.float32, seed=SEED + 29):
    net = UNET.UNet(1, DDPM_BASE, DDPM_MULTS, dtype=dtype, device=device,
                    generator=torch.Generator().manual_seed(seed))
    return DDPM.ScoreMatchingSDE(net, input_size=(1, DDPM_SIZE, DDPM_SIZE))


@contextlib.contextmanager
def cudnn_tf32(on):
    """cuDNN's TF32 for float32 convolutions, on (PyTorch's default) or
    off, for the duration."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def ddpm_step_grads(sde, x, u, z):
    loss = sde.loss_on_draws(x, u, z).mean()
    grads = torch.autograd.grad(loss, list(sde.parameters()))
    return [loss.detach().cpu().double()] + [g.cpu().double() for g in grads]


def ddpm_rel(got, want, floor=1e-6):
    """Largest error of the loss over its value and of each gradient over
    its scale, floored at ``floor`` times the largest gradient's (group
    norms over single channels zero some gradients in exact arithmetic, so
    their scale is rounding; ``floor=1`` holds every gradient to the
    largest one's scale)."""
    top = max(float(w.abs().max()) for w in want[1:])
    return max(float((g - w).abs().max())
               / max(float(w.abs().max()), floor * top * (i > 0))
               for i, (g, w) in enumerate(zip(got, want)))


@contextlib.contextmanager
def cpu_time_embedding():
    """The U-Net's float32 time embedding computed on the CPU and moved to
    the tensor's device, for the duration: CUDA's float32 ``sin``, ``cos``
    and ``exp`` differ from the CPU's by an ulp, so a float64 comparison
    holds the network beyond the embedding to the same embedding."""
    own = UNET.sinusoidal_embedding
    UNET.sinusoidal_embedding = lambda t, dim: own(t.cpu(), dim).to(t.device)
    try:
        yield
    finally:
        UNET.sinusoidal_embedding = own


def ddpm_card_vs_cpu(device):
    """One train step's loss and gradients at full width, batch 8, on
    seeded draws: float64 on the card against the CPU on the CPU's float32
    time embedding (checked; the embedding itself within DDPM_EMBED_EPS of
    the CPU's), and float32 on the card with and without cuDNN's TF32
    against that float64 (recorded)."""
    t = torch.rand(4096, generator=torch.Generator().manual_seed(SEED + 29))
    emb = float((UNET.sinusoidal_embedding(t.to(device), DDPM_BASE).cpu()
                 - UNET.sinusoidal_embedding(t, DDPM_BASE)).abs().max())
    if not emb <= DDPM_EMBED_EPS:
        raise RuntimeError(f"ddpm: the time embedding on the card is "
                           f"{emb:.3e} from the CPU's")
    rng = np.random.default_rng(SEED + 290)
    x = torch.as_tensor(ddpm_blobs(DDPM_CPU_BATCH, SEED + 291)).double()
    u = torch.as_tensor(rng.random((DDPM_CPU_BATCH, 1)))
    z = torch.as_tensor(rng.standard_normal(x.shape))
    cpu_sde = ddpm_model(torch.device("cpu"), torch.float64)
    card_sde = copy.deepcopy(cpu_sde).to(device)
    with cpu_time_embedding():
        (want, cpu_ms) = timed_ms(lambda: ddpm_step_grads(cpu_sde, x, u, z))
        rel64 = ddpm_rel(ddpm_step_grads(card_sde, x.to(device),
                                         u.to(device), z.to(device)), want)
    if not rel64 <= DDPM_REL:
        raise RuntimeError(f"ddpm: float64 train step on the card vs CPU "
                           f"{rel64:.3e}")
    rel32 = {}
    sde32 = copy.deepcopy(cpu_sde).to(device, torch.float32)
    args = [a.to(device, torch.float32) for a in (x, u, z)]
    for tf32 in (True, False):
        with cudnn_tf32(tf32):
            rel32["tf32" if tf32 else "no_tf32"] = ddpm_rel(
                ddpm_step_grads(sde32, *args), want, floor=1.0)
    print(f"ddpm (card vs CPU): time embedding {emb:.3e}; float64 "
          f"{rel64:.3e}; float32 against it "
          f"(of the largest gradient) {rel32['tf32']:.3e} with cuDNN TF32 "
          f"(PyTorch's default), {rel32['no_tf32']:.3e} without; CPU step "
          f"{cpu_ms:.0f} ms", flush=True)
    return dict(embedding_max_abs=emb, f64_rel_err=rel64, f32_rel_err=rel32,
                cpu_step_ms=cpu_ms)


def ddpm_train(device):
    """DDPM_STEPS Adam steps at full width on seeded blobs, cuDNN's TF32 as
    PyTorch ships it: each loss finite, the loss on one fixed set of
    draws lower after than before; the host median step, a profiled step
    and the peak memory of one."""
    sde = ddpm_model(device)
    opt = torch.optim.Adam(sde.parameters(), lr=DDPM_LR)
    data = torch.as_tensor(ddpm_blobs(DDPM_DATA, SEED + 292), device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 293)
    x_eval = data[:DDPM_BATCH]
    u_eval = torch.rand((DDPM_BATCH, 1), generator=gen, device=device)
    z_eval = torch.randn(x_eval.shape, generator=gen, device=device)

    def eval_loss():
        with torch.no_grad():
            return float(sde.loss_on_draws(x_eval, u_eval, z_eval).mean())

    def step():
        idx = torch.randperm(DDPM_DATA, generator=gen, device=device)
        loss = sde.loss(gen, data[idx[:DDPM_BATCH]]).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    before = eval_loss()
    losses, times = [], []
    for _ in range(DDPM_STEPS):
        loss, ms = timed_ms(step)
        losses.append(float(loss))
        times.append(ms)
    after = eval_loss()
    if not (all(np.isfinite(losses)) and after < before):
        raise RuntimeError(f"ddpm: training did not lower the loss "
                           f"({before:.2f} -> {after:.2f}; {losses})")
    _, peak, _ = peak_mib(step)
    prof = profile_run("ddpm train step", step)
    record = dict(step_ms=float(np.median(times[5:])), first_step_ms=times[0],
                  eval_loss_before=before, eval_loss_after=after,
                  losses=losses, peak_mib=peak, profile=prof)
    print(json.dumps({"ddpm_train_step": record}), flush=True)
    return sde


def ddpm_sample(device, sde):
    """The trained model's reverse-SDE samples (DDPM_SDE_SAMPLES at dt 1e-2,
    denoise_t 0.05: 95 midpoint steps) and probability-flow samples
    (DDPM_ODE_SAMPLES, 100 RK4 steps): finite, of the right shape; ms,
    images per second and peak memory. Kernels a sampler step: profiles
    of short samples that differ by a known number of steps."""
    rev = DDPM.ReverseDiffeqWrapper(sde)
    gen = torch.Generator(device=device).manual_seed(SEED + 294)
    shape = (1, DDPM_SIZE, DDPM_SIZE)

    def reverse(dt=DDPM_DT):
        with torch.no_grad():
            return rev.sde_sample(gen, batch_size=DDPM_SDE_SAMPLES, dt=dt,
                                  denoise_t=DDPM_DENOISE_T)

    def flow(dt=DDPM_DT, n=DDPM_ODE_SAMPLES):
        with torch.no_grad():
            return rev.ode_sample(batch_size=n, dt=dt, generator=gen)

    out = {}
    for name, fn, want in (
            ("reverse_sde", reverse, (2, DDPM_SDE_SAMPLES) + shape),
            ("probability_flow", flow, (DDPM_ODE_SAMPLES,) + shape)):
        samples, peak, first_ms = peak_mib(fn)
        if tuple(samples.shape) != want or not bool(
                torch.isfinite(samples).all()):
            raise RuntimeError(f"ddpm {name}: samples of shape "
                               f"{tuple(samples.shape)}, finite "
                               f"{bool(torch.isfinite(samples).all())}")
        ms = timed_steps(f"ddpm {name}", fn, n=2)
        n = DDPM_SDE_SAMPLES if name == "reverse_sde" else DDPM_ODE_SAMPLES
        out[name] = dict(ms=ms, first_ms=first_ms, images_per_s=n / ms * 1e3,
                         peak_mib=peak, final_mean=float(samples[-1].mean()),
                         final_std=float(samples[-1].std()))
    span = 1.0 - DDPM_DENOISE_T
    short = [profile_run(f"ddpm reverse SDE, {k} steps",
                         lambda k=k: reverse(span / k), cpu=False)
             for k in (5, 10)]
    out["reverse_sde"]["kernels_per_step"] = (short[1]["kernels"]
                                              - short[0]["kernels"]) / 5
    out["reverse_sde"]["profile_10_steps"] = short[1]
    short = [profile_run(f"ddpm probability flow, {k} steps",
                         lambda k=k: flow(1.0 / k), cpu=False)
             for k in (2, 4)]
    out["probability_flow"]["kernels_per_step"] = (short[1]["kernels"]
                                                   - short[0]["kernels"]) / 2
    out["probability_flow"]["profile_4_steps"] = short[1]
    for name, record in out.items():
        print(json.dumps({f"ddpm_{name}": record}), flush=True)


def phase_ddpm(device):
    """Phase 29 (no kernel: the U-Net, the score and the samplers are plain
    PyTorch, as the JAX package leaves them to XLA). Its records are the
    ``ddpm_*`` lines; the ``{"ddpm": ...}`` line has each part's
    seconds."""
    record = {}
    t0 = time.perf_counter()
    record["card_vs_cpu"] = ddpm_card_vs_cpu(device)
    record["card_vs_cpu_s"] = time.perf_counter() - t0
    with cudnn_tf32(True):
        t0 = time.perf_counter()
        sde = ddpm_train(device)
        record["train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ddpm_sample(device, sde)
        record["sample_s"] = time.perf_counter() - t0
    print(json.dumps({"ddpm": record}), flush=True)


# --------------------------------------------------------------------------- #
#  Phase 30: the examples; phase 31: the order diagnostics                    #
# --------------------------------------------------------------------------- #

EX_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_examples"
# The sinusoid at 25 steps (its loss falls by three quarters in 20; each
# step takes 0.34-0.51 s).
EX_SINUSOID_ARGS = ["--steps", "25", "--batch", "512"]
EX_LORENZ_ARGS = ["--steps", "50", "--batch", "256", "--fused",
                  "--no-adjoint"]
EX_GAN_ARGS = ["--steps", "200", "--batch", "1024", "--t-size", "64",
               "--dataset-size", "8192", "--swa-step-start", "100",
               "--fused"]
EX_DDPM_ARGS = ["--dataset", "blobs", "--size", "28", "--base-ch", "64",
                "--ch-mults", "1,2,4", "--batch", "128", "--steps", "60"]
# The checkpoint split: the step a run stops and saves at, and the steps of
# the whole run it must equal bitwise.
EX_SPLIT, EX_SPLIT_STEPS = 25, 50
# A loss falls when the mean of its last EX_TAIL records is below its
# first.
EX_TAIL = 5


def _reject_constant(name):
    raise ValueError(f"non-strict JSON constant {name}")


def strict_records(path):
    """Every line of ``path`` parsed as strict JSON (a bare NaN or
    Infinity raises)."""
    with open(path) as f:
        return [json.loads(line, parse_constant=_reject_constant)
                for line in f if line.strip()]


def run_example(name, module, argv):
    """``module.main(argv + its records' flags)``; checks the losses and
    samples finite and every record strict JSON. Returns the result and
    the median step ms."""
    out = EX_DIR / name
    result = module.main(argv + ["--log-jsonl", str(out / "train.jsonl"),
                                 "--artifacts-dir", str(out)])
    torch.cuda.synchronize()
    losses = result["losses"]
    if not (all(np.isfinite(losses)) and result["samples_finite"]):
        raise RuntimeError(f"example {name}: non-finite loss or sample")
    records = strict_records(out / "train.jsonl")
    for path in out.glob("*_acceptance.json"):
        records += strict_records(path)
    if len(records) < 3:
        raise RuntimeError(f"example {name}: {len(records)} records")
    step_ms = float(np.median(result["step_s"])) * 1e3 \
        if result["step_s"] else None
    print(f"example {name}: median step {step_ms} ms over "
          f"{len(result['step_s'])} steps, {len(records)} strict JSON "
          f"records, acceptance {result['acceptance']}", flush=True)
    return result, step_ms


def check_falls(name, losses):
    first, last = losses[0], float(np.mean(losses[-EX_TAIL:]))
    if not last < first:
        raise RuntimeError(f"example {name}: loss {first:.6g} -> {last:.6g}"
                           f" does not fall")
    return first, last


def same_tensors(label, got, want):
    """Two state dicts (or name -> tensor maps) equal bitwise."""
    if set(got) != set(want):
        raise RuntimeError(f"{label}: different entries")
    for k, v in want.items():
        if not torch.equal(got[k], v):
            raise RuntimeError(f"{label}: {k} differs by "
                               f"{float((got[k] - v).abs().max()):.3e}")


def examples_lorenz(record):
    """Lorenz: the fused run (kernels 1 and 2 once a step), then the run
    split at EX_SPLIT by --save and --restore, bitwise the whole run."""
    whole = EX_DIR / "lorenz_whole.pt"
    LF.launches = LF.bwd_launches = 0
    result, ms = run_example("latent_sde_lorenz", EX_LORENZ,
                             EX_LORENZ_ARGS + ["--save", str(whole)])
    launches = (LF.launches, LF.bwd_launches)
    if launches != (EX_SPLIT_STEPS, EX_SPLIT_STEPS):
        raise RuntimeError(f"Lorenz: kernels 1, 2 launched {launches} times"
                           f" in {EX_SPLIT_STEPS} fused steps")
    record["lorenz"] = dict(median_step_ms=ms, launches=launches,
                            loss=check_falls("Lorenz", result["losses"]))
    first, second = EX_DIR / "lorenz_25.pt", EX_DIR / "lorenz_split.pt"
    base = EX_LORENZ_ARGS[2:]
    EX_LORENZ.main(["--steps", str(EX_SPLIT), "--save", str(first)] + base)
    EX_LORENZ.main(["--steps", str(EX_SPLIT_STEPS - EX_SPLIT), "--restore",
                    str(first), "--save", str(second)] + base)
    got = torch.load(second, map_location="cpu", weights_only=True)
    want = torch.load(whole, map_location="cpu", weights_only=True)
    same_tensors("Lorenz split run", got["model"][1], want["model"][1])
    if got["step"][1] != EX_SPLIT_STEPS:
        raise RuntimeError(f"Lorenz split run ends at {got['step'][1]}")
    print(f"Lorenz: split at step {EX_SPLIT} by --save/--restore, bitwise "
          f"the whole run at step {EX_SPLIT_STEPS}", flush=True)
    record["lorenz"]["split_bitwise"] = True
    return launches


def examples_gan(record):
    """SDE-GAN: the fused run (kernels 5-8 once a step), then a run split
    at EX_SPLIT through utils/checkpoint.py, bitwise a whole run."""
    for counter in GAN_COUNTERS:
        setattr(GF, counter, 0)
    result, ms = run_example("sde_gan", EX_GAN, list(EX_GAN_ARGS))
    steps = int(EX_GAN_ARGS[1])
    launches = gan_counts()
    if launches != (steps,) * 4:
        raise RuntimeError(f"GAN: kernels 5-8 launched {launches} times in "
                           f"{steps} fused steps")
    record["sde_gan"] = dict(median_step_ms=ms, launches=launches,
                             loss_first_last=(result["losses"][0],
                                              result["losses"][-1]))
    args = EX_GAN.parse_args(EX_GAN_ARGS)
    whole = EX_GAN.GanRun(args)
    for step in range(EX_SPLIT_STEPS):
        whole.step(step)
    first = EX_GAN.GanRun(args)
    for step in range(EX_SPLIT):
        first.step(step)
    path = save_checkpoint(EX_DIR / "gan_25.pt", n_avg=first.n_avg,
                           **first.entries())
    resumed = EX_GAN.GanRun(args)
    resumed.n_avg = load_checkpoint(path, "cuda", **resumed.entries())[
        "n_avg"]
    for step in range(EX_SPLIT, EX_SPLIT_STEPS):
        resumed.step(step)
    for name in ("gen", "disc", "avg_gen", "avg_disc"):
        same_tensors(f"GAN split run ({name})",
                     resumed.entries()[name].state_dict(),
                     whole.entries()[name].state_dict())
    if resumed.n_avg != whole.n_avg:
        raise RuntimeError(f"GAN split run: n_avg {resumed.n_avg} != "
                           f"{whole.n_avg}")
    print(f"GAN: split at step {EX_SPLIT} through utils/checkpoint.py, "
          f"bitwise the whole run at step {EX_SPLIT_STEPS}", flush=True)
    record["sde_gan"]["split_bitwise"] = True
    return launches


def phase_examples(device):
    """Phase 30. Returns the launches of each kernel the examples ran, by
    kernel record name; the ``{"examples": ...}`` line has each example's
    median step ms and seconds."""
    shutil.rmtree(EX_DIR, ignore_errors=True)
    EX_DIR.mkdir(parents=True)
    record = {}
    t0 = time.perf_counter()
    result, ms = run_example("latent_sde", EX_SINUSOID,
                             list(EX_SINUSOID_ARGS))
    record["latent_sde"] = dict(median_step_ms=ms, loss=check_falls(
        "sinusoid", result["losses"]), s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    lorenz = examples_lorenz(record)
    record["lorenz"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gan = examples_gan(record)
    record["sde_gan"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with cudnn_tf32(True):
        result, ms = run_example("cont_ddpm", EX_DDPM, list(EX_DDPM_ARGS))
    record["cont_ddpm"] = dict(median_step_ms=ms, loss=check_falls(
        "DDPM", result["losses"]), s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    reset_tower_counts()
    demo = EX_DEMO.main([])
    torch.cuda.synchronize()
    euler = tower_counts("euler")
    if euler != (1, 0):
        raise RuntimeError(f"demo: kernels 9, 10 launched {euler} times")
    if not (demo["same_bm_identical"] and demo["graph_vs_eager"] == 0.0
            and np.isfinite(demo["adjoint_vs_backprop"])
            and all(bool(torch.isfinite(demo[k]).all())
                    for k in ("solution", "srk", "fused"))):
        raise RuntimeError(f"demo: {demo['same_bm_identical']=}, "
                           f"{demo['graph_vs_eager']=}")
    record["demo"] = dict(graph_vs_eager=demo["graph_vs_eager"],
                          adjoint_vs_backprop=demo["adjoint_vs_backprop"],
                          s=time.perf_counter() - t0)
    print(json.dumps({"examples": record}), flush=True)
    return {"latent_fused_fwd": lorenz[0], "latent_fused_bwd": lorenz[1],
            "gan_gen_fwd": gan[0], "gan_gen_bwd": gan[1],
            "gan_cde_fwd": gan[2], "gan_cde_bwd": gan[3],
            "tower_euler_fwd": euler[0]}


# Where the JAX package's own ORDER_BANDS miss at run_all's defaults: its
# run_all on the CPU (python -m diagnostics.run_all --cpu --only
# ito_diagonal --no-check --json out.json) gives ito_diagonal's Euler a
# weak order of 0.4260833336558704, below the 0.45 of its band (the bands
# were set at batch 1024; the default batch is 4096).
# tests/test_torch_diagnostics_defaults.py re-derives it: both packages'
# run_all at the defaults, the same slopes at rtol 1e-9 and the same
# violations. The port draws the same Brownian path, so its slope there
# must be the JAX package's within DIAG_REFERENCE_REL; every other slope
# must be within its band.
DIAG_REFERENCE_MISSES = {("ito_diagonal", "euler", "weak_order"):
                         0.4260833336558704}
DIAG_REFERENCE_REL = 1e-9


def phase_diagnostics(device):
    """Phase 31: run_all at its defaults on the card; its slopes are on
    the ``{"diagnostics": ...}`` line. ``check_bands`` must flag exactly
    the JAX package's own misses, each at the JAX package's slope."""
    EX_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    results = DIAG.main(["--json", str(EX_DIR / "orders.json"),
                         "--no-check"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    slopes = {combo: {label: [r["strong_order"], r["weak_order"]]
                      for label, r in methods.items()}
              for combo, methods in results.items()}
    if set(slopes) != set(DIAG.ORDER_BANDS):
        raise RuntimeError(f"diagnostics ran {sorted(slopes)}")
    violations = DIAG.check_bands(results)
    expected = [f"{c}/{label}: {order} " for c, label, order
                in DIAG_REFERENCE_MISSES]
    misses = {}
    for (combo, label, order), ref in DIAG_REFERENCE_MISSES.items():
        got = results[combo][label][order]
        misses[f"{combo}/{label}/{order}"] = dict(slope=got,
                                                  jax_package_slope=ref)
        if abs(got - ref) > DIAG_REFERENCE_REL * ref:
            raise RuntimeError(f"diagnostics: {combo}/{label} {order} "
                               f"{got!r}, the JAX package's {ref!r}")
    if len(violations) != len(expected) or not all(
            v.startswith(e) for v, e in zip(sorted(violations),
                                            sorted(expected))):
        raise RuntimeError(f"diagnostics: band violations {violations}; "
                           f"the JAX package's own are {expected}")
    n = 2 * sum(len(m) for m in DIAG.ORDER_BANDS.values())
    print(f"order bands: {n - len(misses)} of {n} slopes within "
          f"ORDER_BANDS; below their band, as the JAX package's own slopes "
          f"on the same path are: {violations}", flush=True)
    print(json.dumps({"diagnostics": dict(
        slopes=slopes, band_misses_as_jax=misses, s=seconds)}), flush=True)


# --------------------------------------------------------------------------- #
#  --only steps: the GAN sdeint step of any version of the port              #
# --------------------------------------------------------------------------- #

STEPS_RUNS = 5


def phase_steps(device):
    """The SDE-GAN train step at the reference widths on the sdeint route
    with adjoint=False (the reversible-Heun solve), through entry points
    that every version of the port has: one warm-up step, then STEPS_RUNS
    steps, each profiled (kernels launched, device time, busy share).
    Needs no kernel built. Run by a copy of this script inside another
    checkout (its parent commit), it measures that checkout's step: one
    call measures both, in turns."""
    ts, real = gan_data(device)
    models = gan_models(device)
    opts = (torch.optim.Adadelta(models[0].parameters(), lr=GAN_GEN_LR,
                                 weight_decay=GAN_WEIGHT_DECAY),
            torch.optim.Adadelta(models[1].parameters(), lr=GAN_CRITIC_LR,
                                 weight_decay=GAN_WEIGHT_DECAY))
    seeds = iter(range(1600, 1700))

    def step():
        gan_train_step(models, opts, ts, real, next(seeds), False)

    step()   # warm-up
    runs = [profile_run("GAN train step sdeint", step, cpu=False)
            for _ in range(STEPS_RUNS)]
    print(json.dumps({"steps": {"gan_sdeint": runs}}), flush=True)


# --------------------------------------------------------------------------- #
#  Phase 32: the mesh                                                         #
# --------------------------------------------------------------------------- #

# SGD on the flagship (the DP step's update is the caller's; a plain one
# keeps the bitwise comparison to the update's arithmetic).
MESH_LR = 1e-3
# Ranks that share the one card over gloo (NCCL refuses two ranks on one
# device), and timed DP steps after the checked one.
MESH_RANKS = 2
MESH_STEPS = 5
MESH_K = 4
# The 2-rank DP step against one process's full-batch step on the same
# draws, in float32: the loss is the mean of two half-batch means, and each
# gradient the mean of two half-batch contractions (kernel 2's partial sums
# over 512 rows where one process sums 1,024), so they differ by float32
# reassociation only: the loss within MESH_LOSS_RTOL, each gradient within
# MESH_GRAD_REL of its largest entry (GRAD_REL, the fused route against
# the sdeint route). The K-replica step: MULTI_LOSS_RTOL, MULTI_GRAD_REL.
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_REL = 1e-5
# DP x TP at the CPU tests' widths (tests/test_torch_mesh_tp.py): data 3,
# latent 4, context 8, hidden 16, batch 16, 4 times on [0, 0.3], dt 0.1,
# the sdeint route, on a 2 x 2 mesh of 4 gloo ranks on the card.
MESH_TP_DIMS = (3, 4, 8, 16)
MESH_TP_B, MESH_TP_TS, MESH_TP_DT = 16, np.linspace(0.0, 0.3, 4), 0.1


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def flagship_loss(model, batch, generator, ts):
    return latent_sde_loss(model, batch, ts, generator, dt=DT,
                           fused=True)[0]


def plain_sgd_step(model, loss, lr):
    """The update the DP step makes, without the mesh: the gradients of
    ``loss.sum()`` and ``p += -lr * g``."""
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss.sum(), [p for _, p in named])
    with torch.no_grad():
        for (_, p), g in zip(named, grads):
            p += -lr * g
    return loss.detach()


def recording_sgd(lr, store):
    """SGD by ``lr`` that keeps the gradients of its first call."""
    def update(grads, params):
        if not store:
            store.update({n: g.detach().clone() for n, g in grads.items()})
        return {n: -lr * g for n, g in grads.items()}
    return update


def grad_rel(got, want):
    """The largest of each gradient's max |got - want| over its max
    |want|, and the name."""
    return max((float((got[n].to(w.device) - w).abs().max())
                / max(float(w.abs().max()), 1e-30), n)
               for n, w in want.items())


def rows_of(n, mesh, axis_name="data"):
    rows = PM.shard_batch(torch.arange(n), mesh, axis_name=axis_name)
    return int(rows[0]), int(rows[-1]) + 1


def multi_sgd_step(models, xs, ts, gens, lr):
    """One SGD step of K stacked replicas on the K-replica fused route
    (kernels 3 and 4): the losses (K,) and the gradients by name."""
    _, losses = latent_sde_loss_multi(models, xs, ts, gens, dt=DT,
                                      fused=True)
    names = list(models.params)
    grads = torch.autograd.grad(losses.sum(), [models.params[n]
                                               for n in names])
    with torch.no_grad():
        for n, g in zip(names, grads):
            models.params[n] += -lr * g
    return losses.detach(), dict(zip(names, grads))


def mesh_nccl(device, xs, ts):
    """Part 1: ``make_mesh()`` with no arguments on the card, a one-rank
    NCCL group; its DP fused step must be bitwise the plain fused step on
    the same generator seed and launch kernels 1 and 2 once."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    mesh = PM.make_mesh()
    backend = dist.get_backend()
    try:
        step = PM.data_parallel_train_step(
            functools.partial(flagship_loss, ts=ts), mesh, lr=MESH_LR)
        dp, plain = flagship_model(device), flagship_model(device)
        reset_latent_counts()
        _, dp_loss = step(dp, xs, torch.Generator(device=device).manual_seed(
            SEED + 900))
        torch.cuda.synchronize()
        launches = (LF.launches, LF.bwd_launches)
        plain_loss = plain_sgd_step(plain, flagship_loss(
            plain, xs, torch.Generator(device=device).manual_seed(SEED + 900),
            ts), MESH_LR)
        bitwise = torch.equal(dp_loss, plain_loss) and all(
            torch.equal(a, b) for a, b in zip(dp.parameters(),
                                              plain.parameters()))
        want = "nccl" if device.type == "cuda" else "gloo"
        if backend != want or not bitwise or launches != (1, 1):
            raise RuntimeError(f"1-rank mesh: backend {backend}, DP step "
                               f"bitwise the plain step {bitwise}, kernels "
                               f"1 and 2 launched {launches}")
        times = []
        for i in range(MESH_STEPS):
            gen = torch.Generator(device=device).manual_seed(SEED + 901 + i)
            times.append(timed_ms(lambda: step(dp, xs, gen))[1])
    finally:
        dist.destroy_process_group()
    ms = float(np.median(times))
    print(f"mesh (1 rank, {backend}): DP step bitwise the plain fused step, "
          f"kernels 1 and 2 launched {launches}; {ms:.2f} ms median of "
          f"{MESH_STEPS}", flush=True)
    return dict(backend=backend, bitwise=bitwise, launches=list(launches),
                ms=times, median_ms=ms)


def mesh_gloo_rank(rank, world, cfg):
    """Part 2 in one of MESH_RANKS gloo ranks sharing the card (device
    ``cfg["device"]``, card 0): a DP fused
    flagship step on this rank's half of the batch and of the global
    draws, then K = MESH_K replicas sharded over the ranks on the
    K-replica fused route."""
    no_tf32()
    device = torch.device(cfg["device"])
    ts = cfg["ts"]
    mesh = PM.make_mesh(device=device)
    model = PM.replicate(flagship_model(device), mesh)
    xs = PM.shard_batch(cfg["xs"].to(device), mesh, batch_axis=1)
    lo, hi = rows_of(BATCH, mesh)
    grads = {}
    step = PM.data_parallel_train_step(
        functools.partial(flagship_loss, ts=ts), mesh,
        optimizer_update=recording_sgd(MESH_LR, grads))
    with cpu_table_draws(cfg["eps"][lo:hi].to(device),
                         cfg["W"][:, lo:hi].to(device)):
        reset_latent_counts()
        _, loss = step(model, xs, None)
        torch.cuda.synchronize()
        launches = dict(launches=LF.launches, bwd_launches=LF.bwd_launches)
        times = []
        for _ in range(MESH_STEPS):
            dist.barrier()
            times.append(timed_ms(lambda: step(model, xs, None))[1])
    dp = dict(loss=float(loss), rows=[lo, hi], launches=launches, ms=times,
              grads={n: g.cpu() for n, g in grads.items()})
    models = PM.shard_batch(stacked_replicas(device, MESH_K), mesh)
    k_lo, k_hi = rows_of(MESH_K, mesh)
    gens = replica_generators(device, SEED + 950, MESH_K)[k_lo:k_hi]
    reset_latent_counts()
    losses, grads = multi_sgd_step(models, cfg["xs"].to(device), ts, gens,
                                   MESH_LR)
    torch.cuda.synchronize()
    counts = dict(zip(("multi_launches", "multi_bwd_launches", "launches",
                       "bwd_launches"), multi_counts()))
    return dict(dp=dp, replicas=dict(
        replicas=[k_lo, k_hi], losses=losses.cpu(), launches=counts,
        grads={n: g.cpu() for n, g in grads.items()}))


def mesh_tp_rank(rank, world, cfg):
    """Part 3 in one of 4 gloo ranks sharing the card: a DP x TP step of the
    latent ELBO (sdeint route) on a 2 x 2 mesh, this rank's data rows and
    draws; its loss and the averaged gradients of its shards."""
    no_tf32()
    device = torch.device(cfg["device"])
    mesh = PM.make_mesh_2d(n_model=2, device=device)
    model = PM.shard_latent_sde_tp(tp_model(device), mesh)
    xs = PM.shard_batch(cfg["xs"].to(device), mesh, batch_axis=1)
    lo, hi = rows_of(MESH_TP_B, mesh)
    grads = {}
    step = PM.data_parallel_train_step(
        lambda m, batch, g: latent_sde_loss(m, batch, MESH_TP_TS, g,
                                            dt=MESH_TP_DT)[0],
        mesh, optimizer_update=recording_sgd(MESH_LR, grads))
    with cpu_table_draws(cfg["eps"][lo:hi].to(device),
                         cfg["W"][:, lo:hi].to(device)):
        _, loss = step(model, xs, None)
    want = {n: PM.tp_part(n, w.to(device), mesh)
            for n, w in cfg["grads"].items()}
    rel, name = grad_rel(grads, want)
    ratio = max(abs(float((grads[n] * w).sum() / (w * w).sum()) - 1.0)
                for n, w in want.items())
    return dict(loss=float(loss), grad_rel=rel, grad_name=name,
                scale_off=ratio, coords={n: mesh.get_local_rank(n)
                                         for n in mesh.mesh_dim_names},
                w0=list(model.f_net.layers[0].w.shape))


def tp_model(device):
    D, L, C, H = MESH_TP_DIMS
    return LatentSDE(D, L, C, H, device=device,
                     generator=torch.Generator().manual_seed(SEED + 960))


def latent_draws(device, B, L, ts, dt, seed):
    """Global eps (B, L) and W (n, B, L + 1) of a latent solve on ``ts``
    at ``dt``, drawn on the card from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    eps = torch.randn((B, L), generator=gen, device=device)
    grid = TI.build_step_grid(ts[0], ts[-1], dt)
    W = TI.sample_grid_noise(gen, grid, (B, L + 1), torch.float32, device)[0]
    return eps, W


def phase_mesh(device, card):
    """Phase 32 (kernels 1-4 in each rank; the mesh adds none): part 1 on
    a one-rank NCCL group, part 2 on MESH_RANKS gloo ranks sharing the card
    (the ranks load the kernels the parent built), part 3 on 4. Multi-GPU
    NCCL and tensor parallelism over NVLink need more than one card and
    are not run here. Returns the launches of kernels 1-4 in the ranks."""
    xs, ts = lorenz_data(device)
    out = dict(card=card, nccl=mesh_nccl(device, xs, ts))
    shared = str(device) if device.type != "cuda" else "cuda:0"
    eps, W = latent_draws(device, BATCH, LATENT, ts, DT, SEED + 910)
    t0 = time.perf_counter()
    ranks = PM.run_ranks(mesh_gloo_rank, MESH_RANKS, args=(dict(
        xs=xs.cpu(), eps=eps.cpu(), W=W.cpu(), ts=ts, device=shared),),
        device=shared, backend="gloo", timeout=600)
    wall = time.perf_counter() - t0
    with cpu_table_draws(eps, W):
        loss, grads = latent_grads(flagship_model(device), xs, ts,
                                   fused=True)
    models = stacked_replicas(device, MESH_K)
    reset_latent_counts()
    losses, mgrads = multi_sgd_step(models, xs, ts, replica_generators(
        device, SEED + 950, MESH_K), MESH_LR)
    gloo = []
    for r, rank in enumerate(ranks):
        dp, rep = rank["dp"], rank["replicas"]
        loss_rel = abs(dp["loss"] - float(loss)) / abs(float(loss))
        rel, name = grad_rel(dp["grads"], grads)
        k_lo, k_hi = rep["replicas"]
        m_loss = float((rep["losses"].to(device) - losses[k_lo:k_hi]).abs()
                       .max() / losses[k_lo:k_hi].abs().max())
        m_rel, m_name = grad_rel(rep["grads"], {n: g[k_lo:k_hi] for n, g in
                                                mgrads.items()})
        ok = (loss_rel <= MESH_LOSS_RTOL and rel <= MESH_GRAD_REL
              and dp["launches"] == dict(launches=1, bwd_launches=1)
              and m_loss <= MULTI_LOSS_RTOL and m_rel <= MULTI_GRAD_REL
              and rep["launches"]["multi_launches"] == 1
              and rep["launches"]["multi_bwd_launches"] == 1)
        print(f"mesh rank {r} of {MESH_RANKS} (gloo, {shared}): DP rows "
              f"{dp['rows']}, loss rel {loss_rel:.3e}, gradient rel "
              f"{rel:.3e} ({name}), kernels 1, 2 {dp['launches']}, step "
              f"{float(np.median(dp['ms'])):.2f} ms; replicas {rep['replicas']}"
              f": loss rel {m_loss:.3e}, gradient rel {m_rel:.3e} "
              f"({m_name}), launches {rep['launches']}", flush=True)
        if not ok:
            raise RuntimeError(f"mesh rank {r}: the DP or the replica step "
                               f"disagrees with one process's, or a kernel "
                               f"was not launched")
        gloo.append(dict(rows=dp["rows"], loss_rel=loss_rel, grad_rel=rel,
                         launches=dp["launches"], ms=dp["ms"],
                         median_ms=float(np.median(dp["ms"])),
                         replicas=rep["replicas"], replica_loss_rel=m_loss,
                         replica_grad_rel=m_rel,
                         replica_launches=rep["launches"]))
    out["gloo"] = dict(ranks=gloo, wall_s=wall)
    # Part 3: DP x TP at the CPU tests' widths.
    D, L, C, H = MESH_TP_DIMS
    tgen = torch.Generator(device=device).manual_seed(SEED + 970)
    txs = torch.randn((len(MESH_TP_TS), MESH_TP_B, D), generator=tgen,
                      device=device)
    teps, tW = latent_draws(device, MESH_TP_B, L, MESH_TP_TS, MESH_TP_DT,
                            SEED + 971)
    tmodel = tp_model(device)
    with cpu_table_draws(teps, tW):
        tloss = latent_sde_loss(tmodel, txs, MESH_TP_TS, None,
                                dt=MESH_TP_DT)[0]
        names = [n for n, _ in tmodel.named_parameters()]
        tgrads = dict(zip(names, torch.autograd.grad(
            tloss, list(tmodel.parameters()))))
    tloss = tloss.detach()
    t0 = time.perf_counter()
    tp = PM.run_ranks(mesh_tp_rank, 4, args=(dict(
        xs=txs.cpu(), eps=teps.cpu(), W=tW.cpu(), device=shared,
        grads={n: g.cpu() for n, g in tgrads.items()}),), device=shared,
        backend="gloo", timeout=600)
    tp_wall = time.perf_counter() - t0
    for r, rank in enumerate(tp):
        loss_rel = abs(rank["loss"] - float(tloss)) / abs(float(tloss))
        print(f"mesh DP x TP rank {r} {rank['coords']}: f_net.layers.0.w "
              f"{rank['w0']}, loss rel {loss_rel:.3e}, gradient rel "
              f"{rank['grad_rel']:.3e} ({rank['grad_name']}), gradient "
              f"scale off by {rank['scale_off']:.3e}", flush=True)
        if (loss_rel > MESH_LOSS_RTOL or rank["grad_rel"] > MESH_GRAD_REL
                or rank["scale_off"] > MESH_GRAD_REL
                or rank["w0"] != [L + C, H // 2]
                or rank["coords"] != {"data": r // 2, "model": r % 2}):
            raise RuntimeError(f"mesh DP x TP rank {r} disagrees with one "
                               f"process's step")
        rank["loss_rel"] = loss_rel
    out["tp"] = dict(ranks=tp, wall_s=tp_wall)
    out["note"] = (f"{MESH_RANKS} gloo ranks share one card: the DP step "
                   f"time is not a scaling figure")
    print(json.dumps({"mesh": out}), flush=True)
    return dict(
        latent_fused_fwd=[r["launches"]["launches"] for r in gloo],
        latent_fused_bwd=[r["launches"]["bwd_launches"] for r in gloo],
        latent_fused_fwd_multi=[r["replica_launches"]["multi_launches"]
                                for r in gloo],
        latent_fused_bwd_multi=[r["replica_launches"]["multi_bwd_launches"]
                                for r in gloo],
        nccl=out["nccl"]["launches"])


GROUPS = ("latent", "gan", "tower", "logqp", "multi", "bf16", "srk",
          "prng", "brownian", "adjoint", "adaptive", "traced_ts", "ddpm",
          "examples", "diagnostics", "mesh")
# Run only when asked for by --only.
EXTRA_GROUPS = ("tiles", "ab", "steps", "srk_rounding", "gan_clocks")
# Groups that launch no kernel of the port's own: they run without a build.
UNBUILT_GROUPS = ("steps", "adaptive", "traced_ts", "ddpm", "diagnostics")


def timed_phase(fn, *args):
    """``fn(*args)``, printing its seconds (the phases of the multi and
    bf16 groups, so that a run says which of them to cut)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", help="comma-separated phase groups to run, of "
                    f"{', '.join(GROUPS + EXTRA_GROUPS)} (for development: "
                    "prints the run's kernel records but no ok line); all "
                    "but tiles and ab by default")
    ap.add_argument("--ab-tag", default="run", help="ab: the name under "
                    "which build/ab_<tag>.pt keeps this run's outputs")
    ap.add_argument("--ab-against", help="ab: an earlier run's outputs "
                    "(a build/ab_<tag>.pt) to compare with")
    opts = ap.parse_args()
    groups = GROUPS if opts.only is None else tuple(opts.only.split(","))
    unknown = set(groups) - set(GROUPS + EXTRA_GROUPS)
    if unknown:
        raise SystemExit(f"unknown phase groups {sorted(unknown)}")
    device, card = phase_device()
    seconds = {}
    current = [None, time.perf_counter()]

    def start(name):
        """Close the running group's clock (printing its seconds) and start
        ``name``'s."""
        now = time.perf_counter()
        if current[0] is not None:
            seconds[current[0]] = now - current[1]
            print(f"group {current[0]}: {seconds[current[0]]:.1f} s",
                  flush=True)
        current[:] = [name, now]

    if not set(groups) <= set(UNBUILT_GROUPS):
        start("build")
        phase_build()
    csrc = "torchsde_tpu_torch/ops/csrc"
    records = []
    if "latent" in groups:
        start("latent")
        kernel1 = phase_kernel(device)
        kernel2 = phase_kernel2(device)
        xs, ts = lorenz_data(device)
        served_launches, served = phase_serve(device, xs, ts)
        launches, grad_rel, models, opts = phase_train(device, xs, ts)
        phase_profile(device, served, (models, opts), xs, ts)
        del served, models, opts
        records += [
            dict(name="latent_fused_fwd", route="cuda",
                 source=f"{csrc}/latent_fused_fwd.cu",
                 replaces="torchsde_tpu/ops/latent_fused.py:156",
                 launches=launches[0], launches_serve=served_launches,
                 library_ms=None, **kernel1),
            dict(name="latent_fused_bwd", route="cuda",
                 source=f"{csrc}/latent_fused_bwd.cu",
                 replaces="torchsde_tpu/ops/latent_fused.py:248",
                 launches=launches[1], library_ms=None,
                 step0_grad_rel_err=grad_rel, **kernel2)]
    if "gan" in groups:
        start("gan")
        gan = gan_models(device)
        gan_ts, real = gan_data(device)
        kernel5, kernel7 = phase_gan_kernels(device, gan, gan_ts, real)
        gan_launches = phase_gan_serve(device, gan, gan_ts, real)
        phase_gan_profile(device, gan, gan_ts, real)
        kernel6, kernel8 = phase_gan_bwd_kernels(device, gan, gan_ts, real)
        train_launches, gan_grad_rel, trained, batch = phase_gan_train(
            device, gan_ts, real)
        phase_gan_train_profile(trained, gan_ts, batch)
        del gan, trained
        records += [
            dict(name="gan_gen_fwd", route="cuda",
                 source=f"{csrc}/gan_gen_fwd.cu",
                 replaces="torchsde_tpu/ops/gan_fused.py:151",
                 launches=gan_launches[0],
                 launches_train=train_launches["gen_launches"],
                 library_ms=None, **kernel5),
            dict(name="gan_cde_fwd", route="cuda",
                 source=f"{csrc}/gan_cde_fwd.cu",
                 replaces="torchsde_tpu/ops/gan_fused.py:422",
                 launches=gan_launches[1],
                 launches_train=train_launches["cde_launches"],
                 library_ms=None, **kernel7),
            dict(name="gan_gen_bwd", route="cuda",
                 source=f"{csrc}/gan_gen_bwd.cu",
                 replaces="torchsde_tpu/ops/gan_fused.py:200",
                 launches=train_launches["gen_bwd_launches"],
                 library_ms=None, step0_grad_rel_err=gan_grad_rel,
                 **kernel6),
            dict(name="gan_cde_bwd", route="cuda",
                 source=f"{csrc}/gan_cde_bwd.cu",
                 replaces="torchsde_tpu/ops/gan_fused.py:458",
                 launches=train_launches["cde_bwd_launches"],
                 library_ms=None, **kernel8)]
    tower_kernels, tower_runs = {}, {}
    if "tower" in groups:
        start("tower")
        tower_kernels.update(phase_tower_kernels(device))
        tower_runs.update({TOWER_CONFIGS[name][0]: phase_tower_serve_train(
            device, name) for name in ("E1", "R1")})
        phase_auto_dispatch(device, AUTO_SHAPES)
    if "logqp" in groups:
        start("logqp")
        tower_kernels["euler_logqp"] = phase_logqp_kernels(device)["L1"]
        tower_runs["euler_logqp"] = phase_tower_serve_train(device, "L1")
        phase_auto_dispatch(device, AUTO_LOGQP_SHAPES)
    for method, names, lines in (("euler", ("tower_euler_fwd",
                                            "tower_euler_bwd"), (211, 242)),
                                 ("reversible_heun", ("tower_rh_fwd",
                                                      "tower_rh_bwd"),
                                  (302, 352)),
                                 ("euler_logqp", ("tower_euler_logqp_fwd",
                                                  "tower_euler_logqp_bwd"),
                                  (819, 853))):
        if method not in tower_runs:
            continue
        run = tower_runs[method]
        for i, (name, line) in enumerate(zip(names, lines)):
            extra = (dict(launches_serve=run["launches_serve"]) if i == 0
                     else dict(step0_grad_rel_err=run["step0_grad_rel_err"]))
            records.append(dict(
                name=name, route="cuda", source=f"{csrc}/{name}.cu",
                replaces=f"torchsde_tpu/ops/fused_solve.py:{line}",
                launches=run["launches"][i], library_ms=None, **extra,
                **tower_kernels[method][i]))
    if "multi" in groups:
        start("multi")
        kernel3, kernel4 = timed_phase(phase_multi_kernels, device)
        xs, ts = lorenz_data(device)
        path = timed_phase(phase_multi_path, device, xs, ts)
        records += [
            dict(name="latent_fused_fwd_multi", route="cuda",
                 source=f"{csrc}/latent_fused_fwd.cu",
                 replaces="torchsde_tpu/ops/latent_fused.py:455",
                 launches=path["launches"][0],
                 launches_serve=path["launches_serve"], library_ms=None,
                 loss_rel_err=path["loss_rel_err"],
                 step_ms=path["step_ms"], **kernel3),
            dict(name="latent_fused_bwd_multi", route="cuda",
                 source=f"{csrc}/latent_fused_bwd.cu",
                 replaces="torchsde_tpu/ops/latent_fused.py:475",
                 launches=path["launches"][1], library_ms=None,
                 step0_grad_rel_err=path["step0_grad_rel_err"], **kernel4)]
    if "bf16" in groups:
        start("bf16")
        single = timed_phase(phase_bf16_kernels, device)
        multi = timed_phase(phase_bf16_multi_kernels, device)
        xs, ts = lorenz_data(device)
        routes = timed_phase(phase_bf16_routes, device, xs, ts)
        step_launches, step = timed_phase(phase_bf16_train, device, xs, ts)
        multi_launches, multi_step = timed_phase(phase_bf16_multi_path,
                                                 device, xs, ts)
        gan_ts, real = gan_data(device)
        gan16 = timed_phase(phase_bf16_gan_kernels, device, gan_ts, real)
        gan_routes = timed_phase(phase_bf16_gan_routes, device, gan_ts,
                                 real)
        gan_launches, gan_step = timed_phase(phase_bf16_gan_train, device,
                                             gan_ts, real)
        for name, line, launched, kernel, extra in (
                ("latent_fused_fwd", 156, step_launches[0], single["fwd"],
                 dict(step=step, routes=routes)),
                ("latent_fused_bwd", 248, step_launches[1], single["bwd"],
                 {}),
                ("latent_fused_fwd_multi", 455, multi_launches[0],
                 multi["fwd"], dict(multi_step=multi_step)),
                ("latent_fused_bwd_multi", 475, multi_launches[1],
                 multi["bwd"], {})):
            records.append(dict(
                name=f"{name}_bf16", route="cuda",
                source=f"{csrc}/{name.replace('_multi', '')}.cu",
                replaces=f"torchsde_tpu/ops/latent_fused.py:{line}",
                launches=launched, library_ms=None, **extra, **kernel))
        for name, source, line, launched, extra in (
                ("gen_fwd", "gan_gen_fwd.cu", 151, gan_launches[0],
                 dict(step=gan_step, routes=gan_routes)),
                ("gen_bwd", "gan_gen_bwd_bf16.cu", 200, gan_launches[1], {}),
                ("cde_fwd", "gan_cde_fwd.cu", 422, gan_launches[2], {}),
                ("cde_bwd", "gan_cde_bwd_bf16.cu", 458, gan_launches[3], {})):
            records.append(dict(
                name=f"gan_{name}_bf16", route="cuda",
                source=f"{csrc}/{source}",
                replaces=f"torchsde_tpu/ops/gan_fused.py:{line}",
                launches=launched, library_ms=None, **extra,
                **gan16[name]))
    if "srk" in groups:
        start("srk")
        srk_launches, kernel15 = phase_srk_kernel(device)
        srk16_launches, kernel15_bf16 = phase_srk_bf16_kernel(device)
        for name, launched, kernel in (
                ("srk_srid2", srk_launches, kernel15),
                ("srk_srid2_bf16", srk16_launches, kernel15_bf16)):
            records.append(dict(
                name=name, route="cuda", source=f"{csrc}/srk_srid2.cuh",
                replaces="torchsde_tpu/ops/srk_fused.py:80",
                launches=launched, library_ms=None, **kernel))
    if "prng" in groups:
        start("prng")
        prng_launches, kernel16 = phase_prng_kernel(device)
        records.append(dict(
            name="philox_normal", route="cuda",
            source=f"{csrc}/philox_normal.cu",
            replaces="torchsde_tpu/ops/prng.py:37", launches=prng_launches,
            library_ms=None, **kernel16))
    if "brownian" in groups:
        start("brownian")
        phase_brownian(device, card)
    if "adjoint" in groups:
        start("adjoint")
        phase_adjoint(device)
    if "adaptive" in groups:
        start("adaptive")
        phase_adaptive(device)
    if "traced_ts" in groups:
        start("traced_ts")
        phase_traced_ts(device)
    if "ddpm" in groups:
        start("ddpm")
        phase_ddpm(device)
    if "examples" in groups:
        start("examples")
        example_launches = phase_examples(device)
        for record in records:
            if record["name"] in example_launches:
                record["launches_examples"] = example_launches[
                    record["name"]]
    if "diagnostics" in groups:
        start("diagnostics")
        phase_diagnostics(device)
    if "tiles" in groups:
        start("tiles")
        print(json.dumps({"euler_tiles": phase_euler_tiles(device)}),
              flush=True)
        print(json.dumps({"cde_bwd_tiles": phase_cde_tiles(device)}),
              flush=True)
        print(json.dumps({"gan_tiles": phase_gan_tiles(device)}), flush=True)
        print(json.dumps({"fwd_tiles": phase_fwd_tiles(device)}), flush=True)
        print(json.dumps({"sweep_tiles": phase_tiles(device)}), flush=True)
    if "ab" in groups:
        start("ab")
        phase_ab(device, opts.ab_tag, opts.ab_against)
    if "steps" in groups:
        start("steps")
        phase_steps(device)
    if "srk_rounding" in groups:
        start("srk_rounding")
        phase_srk_rounding(device)
    if "gan_clocks" in groups:
        start("gan_clocks")
        phase_gan_clocks(device)
    if "mesh" in groups:
        start("mesh")
        mesh_launches = phase_mesh(device, card)
        for record in records:
            if record["name"] in mesh_launches:
                record["launches_mesh"] = mesh_launches[record["name"]]
            if record["name"] in ("latent_fused_fwd", "latent_fused_bwd"):
                record["launches_mesh_nccl"] = mesh_launches["nccl"][
                    record["name"] == "latent_fused_bwd"]
    start(None)
    print(json.dumps({"group_seconds": seconds}), flush=True)
    torch.cuda.synchronize()
    for record in records:
        if record["launches"] < 1:
            raise RuntimeError(f"{record['name']} was not launched on the "
                               f"main path")
    print(card)
    print(json.dumps({"kernels": records}))
    if groups != GROUPS:
        print(f"partial run ({', '.join(groups)}): no ok line", flush=True)
        return
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
