"""Guided tour of torchsde_tpu_torch (counterpart of the JAX package's
``examples/demo.py``).

Covers: defining SDEs, the four noise types, fixed randomness via ``bm=``,
gradients (backprop and adjoint), one solve captured as a CUDA graph and
replayed, higher-order solvers, a whole-solve kernel, and a solve whose
batch is split over the ranks of a mesh.

Usage: python -m torchsde_tpu_torch.examples.demo [--cpu]
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

from ._evidence import example_device, stream
from ..brownian.interval import BrownianInterval
from ..core.adjoint import sdeint_adjoint
from ..core.base_sde import BaseSDE, SDEIto
from ..core.sdeint import sdeint
from ..ops.fused_solve import TowerSpec, fused_sdeint
from ..parallel.mesh import make_mesh, shard_batch


class GeneralSDE(BaseSDE):
    """dy = mu y dt + sigma(y) dW, general noise (d x m), Itô."""

    def __init__(self, d, m, generator, device):
        super().__init__(noise_type="general", sde_type="ito")
        self.mu = torch.nn.Parameter(0.1 * torch.randn(
            (d, d), generator=generator).to(device))
        self.sigma = torch.nn.Parameter(0.1 * torch.randn(
            (d, d * m), generator=generator).to(device))
        self.d, self.m = d, m

    def f(self, t, y):
        return y @ self.mu.T

    def g(self, t, y):
        return (y @ self.sigma).reshape(y.shape[0], self.d, self.m)


class DiagSDE(SDEIto):
    def __init__(self):
        super().__init__(noise_type="diagonal")

    def f(self, t, y):
        return torch.sin(torch.as_tensor(t, dtype=y.dtype,
                                         device=y.device)) + 0.1 * y

    def g(self, t, y):
        return 0.3 * torch.sigmoid(y)


def captured_solve(sde, y0, ts, bm, dt):
    """Section 4: one solve captured as a CUDA graph and replayed, with the
    output times a tensor on the card that the replay reads (the traced-ts
    route of ``sdeint``); returns the replay's and an eager solve's
    states."""
    ts_static = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    with torch.no_grad():
        eager = sdeint(sde, y0, ts_static.clone().requires_grad_(True),
                       bm=bm, method="euler", dt=dt)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # warm up off the capture stream
            sdeint(sde, y0, ts_static.clone().requires_grad_(True), bm=bm,
                   method="euler", dt=dt)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ys = sdeint(sde, y0, ts_static, bm=bm, method="euler", dt=dt)
    graph.replay()
    torch.cuda.synchronize()
    return ys, eager


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = example_device(args.cpu)
    out = {}

    print("== 1. Define an SDE (general noise, Ito) ==")
    sde = GeneralSDE(3, 2, stream("cpu", 0), device)
    y0 = torch.full((32, 3), 0.1, device=device)
    ts = np.linspace(0.0, 1.0, 20)
    with torch.no_grad():
        ys = sdeint(sde, y0, ts, method="euler", dt=1e-2,
                    generator=stream(device, 42))
    print("solution:", tuple(ys.shape), "final mean:", float(ys[-1].mean()))
    out["solution"] = ys

    print("== 2. Fixed randomness via bm= ==")
    bm = BrownianInterval(t0=0.0, t1=1.0, size=(32, 2), entropy=7,
                          levy_area_approximation="space-time",
                          device=device)
    with torch.no_grad():
        ys_a = sdeint(sde, y0, ts, bm=bm, method="euler", dt=1e-2)
        ys_b = sdeint(sde, y0, ts, bm=bm, method="euler", dt=1e-2)
    out["same_bm_identical"] = bool(torch.equal(ys_a, ys_b))
    print("same bm twice -> identical:", out["same_bm_identical"])
    W, U = bm(0.2, 0.7, return_U=True)
    print("bm(0.2, 0.7) increment std:", float(W.std()), "(expect ~0.707)")

    print("== 3. Gradients: backprop vs adjoint ==")
    params = list(sde.parameters())
    loss_bp = sdeint(sde, y0, ts, bm=bm, method="euler", dt=1e-2)[-1].sum()
    g_bp = torch.autograd.grad(loss_bp, params)
    loss_adj = sdeint_adjoint(sde, y0, ts, bm=bm, method="euler",
                              dt=1e-2)[-1].sum()
    g_adj = torch.autograd.grad(loss_adj, params)
    out["adjoint_vs_backprop"] = max(float((a - b).abs().max())
                                     for a, b in zip(g_bp, g_adj))
    print("adjoint vs backprop param-grad max diff:",
          out["adjoint_vs_backprop"])

    print("== 4. One solve captured as a CUDA graph ==")
    if device.type == "cuda":
        ys_graph, ys_eager = captured_solve(sde, y0, ts, bm, 1e-2)
        out["graph_vs_eager"] = float((ys_graph - ys_eager).abs().max())
        print("graph replay:", tuple(ys_graph.shape), "max diff from the "
              "eager solve:", out["graph_vs_eager"])
    else:
        with torch.no_grad():
            ys_eager = sdeint(sde, y0, ts, bm=bm, method="euler", dt=1e-2)
        print("on the CPU the solve runs eagerly:", tuple(ys_eager.shape))

    print("== 5. Other noise types + higher-order solvers ==")
    with torch.no_grad():
        ys_srk = sdeint(DiagSDE(), y0, ts, method="srk", dt=1e-2,
                        generator=stream(device, 1))
    print("SRK (strong order 1.5) diagonal solve:", tuple(ys_srk.shape))
    out["srk"] = ys_srk

    print("== 6. Whole-solve kernel ==")
    # Declare the SDE's towers and the whole solve runs as one kernel
    # forward and one kernel backward (fixed step, euler or
    # reversible_heun, diagonal or general noise); on the CPU the kernels'
    # plain versions run.
    gen = stream("cpu", 3)
    w1 = (torch.randn((3, 16), generator=gen) * 0.2).to(device)
    w2 = (torch.randn((16, 3), generator=gen) * 0.2).to(device)
    gw = (torch.randn((3, 3), generator=gen) * 0.2).to(device)
    zeros = torch.zeros
    drift = TowerSpec([(w1, zeros((16,), device=device), "softplus"),
                       (w2, zeros((3,), device=device), "linear")])
    diffusion = TowerSpec([(gw, zeros((3,), device=device), "sigmoid")])
    with torch.no_grad():
        ys_fused = fused_sdeint(drift, diffusion, y0,
                                [0.0, 0.25, 0.5, 0.75, 1.0],
                                stream(device, 4), 0.25)
    print("fused whole-solve kernel:", tuple(ys_fused.shape))
    out["fused"] = ys_fused

    print("== 7. Batch-axis data parallelism ==")
    # A mesh of the ranks there are (this process alone unless started by
    # torchrun); each rank solves its rows of y0 on its rows of the same
    # interval, which are the whole solve's rows.
    own_group = not dist.is_initialized()
    mesh = make_mesh(device=device)
    with torch.no_grad():
        ys_dp = sdeint(sde, shard_batch(y0, mesh), ts,
                       bm=shard_batch(bm, mesh), method="euler", dt=1e-2)
    n = mesh.size()
    print(f"sharded over {n} rank(s): this rank's rows", tuple(ys_dp.shape),
          "of", tuple(ys_a.shape))
    if n == 1:
        out["sharded_vs_whole"] = float((ys_dp - ys_a).abs().max())
        print("one rank, so the rows are the whole solve's (max diff "
              f"{out['sharded_vs_whole']}); run with torchrun "
              "--nproc-per-node=N -m torchsde_tpu_torch.examples.demo --cpu "
              "to see sharding")
    out["sharded"] = ys_dp
    if own_group:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
