"""1-D latent SDE fit to a noisy sinusoid (counterpart of the JAX package's
``examples/latent_sde.py``).

A scalar latent SDE with an OU prior (drift ``h = theta (mu - y)``), a
time-inhomogeneous posterior drift with a sinusoidal positional encoding,
the logqp channel augmented by hand through ``f_aug`` and ``g_aug`` and
``names=``, KL annealing, and SRK posterior samples on a space-time Lévy
area ``BrownianInterval``. ``--adjoint`` solves with ``sdeint_adjoint``.

Usage: python -m torchsde_tpu_torch.examples.latent_sde [--steps 100]
       [--adjoint] [--cpu]
"""

import argparse
import math
import time

import numpy as np
import torch
from torch import nn

from ._evidence import (JsonlLogger, artifact_path, example_device,
                        median_ms, pyplot, save_acceptance, stream)
from ..brownian.interval import BrownianInterval
from ..core.adjoint import sdeint_adjoint
from ..core.sdeint import sdeint
from ..models.layers import MLP
from ..utils.misc import resolve_device, stable_division

OBS = slice(1, -1)   # the interior observation times within the solve grid
SCALE = 0.05         # observation noise


class LatentSDE1D(nn.Module):
    """Every tensor is a parameter the optimiser trains, as every array
    leaf of the JAX example's module is; the names are its pytree paths."""

    noise_type = "diagonal"
    sde_type = "ito"

    def __init__(self, theta=1.0, mu=0.0, sigma=0.5, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        logvar = math.log(sigma ** 2 / (2.0 * theta))

        def scalar(v):
            return nn.Parameter(torch.tensor([[v]], dtype=dtype,
                                             device=device))

        self.theta, self.mu, self.sigma = scalar(theta), scalar(mu), \
            scalar(sigma)
        self.py0_mean, self.py0_logvar = scalar(mu), scalar(logvar)
        self.net = MLP((3, 200, 200, 1), activation="tanh", dtype=dtype,
                       device=device, generator=generator)
        # Glow-style zero init of the last layer.
        with torch.no_grad():
            self.net.layers[-1].w.zero_()
            self.net.layers[-1].b.zero_()
        self.qy0_mean, self.qy0_logvar = scalar(mu), scalar(logvar)

    def f(self, t, y):  # posterior drift with positional encoding
        tt = torch.as_tensor(t, dtype=y.dtype, device=y.device).expand(
            y.shape)
        return self.net(torch.cat([torch.sin(tt), torch.cos(tt), y], dim=-1))

    def g(self, t, y):
        return self.sigma.expand(y.shape)

    def h(self, t, y):  # OU prior drift
        return self.theta * (self.mu - y)

    def f_aug(self, t, y):
        y = y[:, 0:1]
        f, g, h = self.f(t, y), self.g(t, y), self.h(t, y)
        u = stable_division(f - h, g)
        f_logqp = 0.5 * torch.sum(u ** 2, dim=1, keepdim=True)
        return torch.cat([f, f_logqp], dim=1)

    def g_aug(self, t, y):
        y = y[:, 0:1]
        g = self.g(t, y)
        return torch.cat([g, torch.zeros_like(y)], dim=1)


def make_data(generator, batch):
    """Irregularly sampled sinusoid: 16 uniform times in [0.4, 1.6] plus
    the [0, 2] solve ends, ys = 0.8 sin(2 pi t) + 0.01 N(0, 1) observation
    noise (the likelihood reads only the 16 interior times). Returns the
    times (18,) as a float64 host array of float32 values and ys (16,
    batch, 1) on the generator's device."""
    device = generator.device
    u = torch.rand((16,), generator=generator, device=device)
    ts_obs = torch.sort(u * 1.2 + 0.4).values
    ys = 0.8 * torch.sin(ts_obs * (2.0 * math.pi))[None, :, None]
    ys = ys.repeat(batch, 1, 1)
    ys = ys + 0.01 * torch.randn(ys.shape, generator=generator,
                                 device=device)
    ts = np.concatenate([[0.0], ts_obs.cpu().numpy().astype(np.float64),
                         [2.0]])
    return ts, ys.transpose(0, 1).contiguous()


def loss_fn(model, ts, ys_data, eps, kl_coeff, method="euler", dt=1e-2,
            adjoint=False, **solve_kwargs):
    """The negative ELBO from the posterior's initial eps (batch, 1) and
    the solve's noise (``generator=`` or ``bm=`` in ``solve_kwargs``).
    Returns ``(loss, (logpy, logqp))``."""
    qy0_std = torch.exp(0.5 * model.qy0_logvar)
    py0_std = torch.exp(0.5 * model.py0_logvar)
    y0 = model.qy0_mean + eps * qy0_std
    logqp0 = torch.sum(
        model.py0_logvar / 2 - model.qy0_logvar / 2
        + (qy0_std ** 2 + (model.qy0_mean - model.py0_mean) ** 2)
        / (2 * py0_std ** 2) - 0.5)
    aug_y0 = torch.cat([y0, torch.zeros_like(y0)], dim=1)
    solve = sdeint_adjoint if adjoint else sdeint
    aug_ys = solve(model, aug_y0, ts, method=method, dt=dt,
                   names={"drift": "f_aug", "diffusion": "g_aug"},
                   **solve_kwargs)
    ys_model, logqp_path = aug_ys[OBS, :, 0:1], aug_ys[-1, :, 1]
    logpy = torch.sum(torch.mean(
        -0.5 * ((ys_data - ys_model) / SCALE) ** 2
        - math.log(SCALE * math.sqrt(2 * math.pi)), dim=1))
    logqp = logqp0 + torch.mean(logqp_path)
    return -logpy + kl_coeff * logqp, (logpy, logqp)


def train_step(model, opt, ts, ys_data, generator, kl_coeff, args):
    """One Adam step; the generator draws eps, then the solve noise."""
    opt.zero_grad(set_to_none=True)
    eps = torch.randn((args.batch, 1), generator=generator,
                      device=generator.device, dtype=ys_data.dtype)
    loss, (logpy, logqp) = loss_fn(model, ts, ys_data, eps, kl_coeff,
                                   method=args.method, dt=args.dt,
                                   adjoint=args.adjoint, generator=generator)
    loss.backward()
    opt.step()
    return loss.detach(), logpy.detach(), logqp.detach()


def posterior_fit_mse(model, ts, generator, dt, n=512):
    """MSE of the posterior mean (over n sampled paths) against the
    noiseless sinusoid at the observation times."""
    with torch.no_grad():
        p = model.qy0_mean
        eps = torch.randn((n, 1), generator=generator, device=p.device,
                          dtype=p.dtype)
        y0 = model.qy0_mean + eps * torch.exp(0.5 * model.qy0_logvar)
        zs = sdeint(model, y0, ts, method="euler", dt=dt,
                    generator=generator)
        post_mean = torch.mean(zs[OBS, :, 0], dim=1)            # (16,)
        ys_clean = 0.8 * torch.sin(torch.as_tensor(
            ts[OBS], dtype=p.dtype, device=p.device) * (2.0 * math.pi))
        return float(torch.mean((post_mean - ys_clean) ** 2))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--dt", type=float, default=1e-2)
    p.add_argument("--method", type=str, default="euler")
    p.add_argument("--adjoint", action="store_true")
    p.add_argument("--kl-anneal-iters", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--log-jsonl", type=str, default=None,
                   help="append per-step loss records here (JSONL)")
    p.add_argument("--artifacts-dir", type=str, default=None,
                   help="save the posterior-fit plot + acceptance record here")
    return p.parse_args(argv)


def main(argv=None):
    """Train, sample, write the records. Returns a dict of the run's
    losses, step times (s) and acceptance record."""
    args = parse_args(argv)
    device = example_device(args.cpu)
    ts, ys_data = make_data(stream(device, 0), args.batch)
    model = LatentSDE1D(device=device, generator=stream("cpu", 1))
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    logger = JsonlLogger(args.log_jsonl, device)

    mse0 = posterior_fit_mse(model, ts, stream(device, 999), args.dt)
    print(f"initial posterior-fit MSE {mse0:.4f}")

    log_every = max(1, args.steps // 200)
    losses, step_s = [], []
    for step in range(args.steps):
        kl_coeff = min(1.0, step / args.kl_anneal_iters)
        t0 = time.perf_counter()
        loss, logpy, logqp = train_step(model, opt, ts, ys_data,
                                        stream(device, 100 + step),
                                        kl_coeff, args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        if step % log_every == 0 or step == args.steps - 1:
            losses.append(float(loss))
            logger.write(step=step, loss=float(loss), logpy=float(logpy),
                         kl=float(logqp), kl_coeff=kl_coeff)
        if step % max(1, args.steps // 10) == 0:
            print(f"step {step:4d} loss {float(loss):10.3f} "
                  f"logpy {float(logpy):9.3f} kl {float(logqp):8.3f}")

    # Posterior sampling with SRK and a space-time Levy area interval.
    with torch.no_grad():
        bm = BrownianInterval(t0=float(ts[0]), t1=float(ts[-1]), size=(8, 1),
                              levy_area_approximation="space-time",
                              entropy=42, device=device)
        y0 = model.qy0_mean.expand(8, 1)
        zs = sdeint(model, y0, ts, bm=bm, method="srk", dt=args.dt)
    finite = bool(torch.isfinite(zs).all())
    print("SRK posterior sample:", tuple(zs.shape), "finite:", finite)
    if losses:
        print("final loss:", losses[-1])

    mse1 = posterior_fit_mse(model, ts, stream(device, 999), args.dt)
    print(f"median step {median_ms(step_s)} ms over {args.steps} steps")
    # Acceptance, pre-registered: the trained posterior mean tracks the
    # noiseless sinusoid, below 0.05 and at least 5x under the untrained
    # MSE.
    record = save_acceptance(
        args.artifacts_dir, "latent_sde_acceptance.json", device,
        workload="latent_sde_sinusoid", steps=args.steps, batch=args.batch,
        posterior_fit_mse_initial=mse0, posterior_fit_mse_final=mse1,
        accept_fit_mse_below=0.05, accept_improvement_factor=5.0,
        median_step_ms=median_ms(step_s),
        passed=bool(mse1 < 0.05 and mse1 * 5.0 < mse0))

    plt = pyplot(args.artifacts_dir)
    if plt is not None:
        _plot(plt, model, ts, ys_data, device, args, mse0, mse1)
    return dict(losses=losses, step_s=step_s, acceptance=record,
                samples_finite=finite, model=model)


def _plot(plt, model, ts, ys_data, device, args, mse0, mse1):
    """Dense posterior and prior 5-95% bands, the true sinusoid, the data."""
    t_dense = np.linspace(float(ts[0]), float(ts[-1]), 101)
    n_vis = 512
    with torch.no_grad():
        p = model.qy0_mean
        gen = stream(device, 555)
        eps = torch.randn((n_vis, 1), generator=gen, device=device,
                          dtype=p.dtype)
        y0v = model.qy0_mean + eps * torch.exp(0.5 * model.qy0_logvar)
        zs_post = sdeint(model, y0v, t_dense, method="euler", dt=args.dt,
                         generator=gen)[:, :, 0]
        gen = stream(device, 557)
        eps_p = torch.randn((n_vis, 1), generator=gen, device=device,
                            dtype=p.dtype)
        y0p = model.py0_mean + eps_p * torch.exp(0.5 * model.py0_logvar)
        zs_prior = sdeint(model, y0p, t_dense, method="euler", dt=args.dt,
                          names={"drift": "h"}, generator=gen)[:, :, 0]
    fig, ax = plt.subplots(figsize=(9, 5))
    for zs_v, color, label in ((zs_post, "C0", "posterior"),
                               (zs_prior, "C2", "prior")):
        lo, mid, hi = np.percentile(zs_v.cpu().numpy(), [5, 50, 95], axis=1)
        ax.fill_between(t_dense, lo, hi, alpha=0.2, color=color)
        ax.plot(t_dense, mid, color=color, label=f"{label} median (5-95%)")
    ax.plot(t_dense, 0.8 * np.sin(t_dense * 2 * np.pi), "k--", lw=1,
            label="true sinusoid")
    ax.scatter(ts[OBS], ys_data[:, :, 0].mean(1).cpu().numpy(), color="C3",
               zorder=5, label="data (batch mean)")
    ax.set_title(f"latent SDE sinusoid fit: posterior MSE "
                 f"{mse0:.3f} -> {mse1:.4f}")
    ax.legend()
    fig.tight_layout()
    out = artifact_path(args.artifacts_dir, "latent_sde_fit.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print("saved", out)


if __name__ == "__main__":
    main()
