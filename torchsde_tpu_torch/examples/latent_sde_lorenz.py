"""Latent SDE fit to the stochastic Lorenz attractor (counterpart of the JAX
package's ``examples/latent_sde_lorenz.py``).

The ``models.latent_sde`` family: a GRU encoder to a context path, the
posterior drift conditioned on it, a learned prior drift ``h``, diagonal
noise nets, the KL through the ``logqp`` channel, trained by Adam on
``latent_sde_loss``. The adjoint is on by default (``--no-adjoint`` turns
it off); ``--fused`` runs the whole-solve kernels and, as in the JAX
package, needs ``--no-adjoint``.

``--save`` writes a checkpoint of the model, the Adam state and the number
of steps taken; ``--restore`` loads one and continues from its step, so a
run split in two at any step ends with the same parameters, bit for bit,
as the run taken in one go.

Usage: python -m torchsde_tpu_torch.examples.latent_sde_lorenz
       [--steps 100] [--no-adjoint --fused] [--cpu]
"""

import argparse
import time

import numpy as np
import torch

from ._evidence import (JsonlLogger, artifact_path, example_device,
                        median_ms, pyplot, save_acceptance, stream)
from ..models.latent_sde import (LatentSDE, latent_sde_loss,
                                 make_lorenz_data, sample_posterior)
from ..utils.checkpoint import load_checkpoint, save_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--t-size", type=int, default=32)
    p.add_argument("--latent", type=int, default=4)
    p.add_argument("--context", type=int, default=64)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--dt", type=float, default=1e-2)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--kl-anneal-iters", type=int, default=50)
    p.add_argument("--no-adjoint", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--save", type=str, default=None,
                   help="checkpoint path to save the trained model")
    p.add_argument("--fused", action="store_true",
                   help="whole-solve CUDA kernels (needs --no-adjoint)")
    p.add_argument("--restore", type=str, default=None,
                   help="checkpoint path to restore before training")
    p.add_argument("--log-jsonl", type=str, default=None,
                   help="append per-step loss records to this JSONL file")
    p.add_argument("--artifacts-dir", type=str, default=None,
                   help="save the posterior-fit plot + acceptance record here")
    return p.parse_args(argv)


def setup(args):
    """``(device, ts, xs, model, opt)``: the data, the model and its Adam,
    from fixed streams."""
    device = example_device(args.cpu)
    ts = np.linspace(0.0, 1.0, args.t_size)
    with torch.no_grad():
        xs = make_lorenz_data(args.batch, ts, generator=stream(device, 0),
                              device=device)
    model = LatentSDE(3, args.latent, args.context, args.hidden,
                      device=device, generator=stream("cpu", 1))
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    return device, ts, xs, model, opt


def train_step(model, opt, xs, ts, step, args):
    """Step ``step``: its own stream, the annealed KL weight, one Adam
    update. Returns the detached loss and aux."""
    kl_weight = min(1.0, step / args.kl_anneal_iters)
    opt.zero_grad(set_to_none=True)
    loss, aux = latent_sde_loss(model, xs, ts, stream(xs.device, 100 + step),
                                dt=args.dt, kl_weight=kl_weight,
                                adjoint=not args.no_adjoint,
                                fused=args.fused)
    loss.backward()
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, kl_weight


def recon_error(samples, xs):
    """Mean squared error of sample paths against the data."""
    return float(torch.mean((samples - xs) ** 2))


def recon_mse(model, xs, ts, dt):
    """Reconstruction MSE of one posterior sample path against the data,
    in normalised data units; returns it and the samples."""
    with torch.no_grad():
        samples = sample_posterior(model, xs, ts, stream(xs.device, 999),
                                   dt=dt)
        return recon_error(samples, xs), samples


def main(argv=None):
    """Train, sample, write the records. Returns a dict of the run's
    losses, step times (s), acceptance record and model."""
    args = parse_args(argv)
    device, ts, xs, model, opt = setup(args)
    start = 0
    if args.restore:
        start = load_checkpoint(args.restore, device, model=model,
                                opt=opt)["step"]
        print("restored from", args.restore, "at step", start)
    logger = JsonlLogger(args.log_jsonl, device)

    mse0, _ = recon_mse(model, xs, ts, args.dt)
    print(f"initial reconstruction MSE {mse0:.4f}")

    log_every = max(1, args.steps // 200)
    losses, step_s = [], []
    for step in range(start, start + args.steps):
        t0 = time.perf_counter()
        loss, aux, kl_weight = train_step(model, opt, xs, ts, step, args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        i = step - start
        if i % log_every == 0 or i == args.steps - 1:
            losses.append(float(loss))
            logger.write(step=step, loss=float(loss),
                         log_pxs=float(aux["log_pxs"]),
                         kl=float(aux["logqp"]), kl_weight=kl_weight)
        if i % max(1, args.steps // 10) == 0:
            print(f"step {step:4d} loss {float(loss):12.3f} "
                  f"log_pxs {float(aux['log_pxs']):10.3f} "
                  f"kl {float(aux['logqp']):10.3f}")

    if args.save:
        print("saved to", save_checkpoint(args.save, model=model, opt=opt,
                                          step=start + args.steps))

    mse1, samples = recon_mse(model, xs, ts, args.dt)
    finite = bool(torch.isfinite(samples).all())
    print("posterior samples:", tuple(samples.shape), "finite:", finite)
    print(f"median step {median_ms(step_s)} ms over {args.steps} steps")
    # Acceptance, pre-registered: the trained posterior reconstructs the
    # (unit-variance normalised) Lorenz paths below 0.15 AND at least 4x
    # under the untrained MSE.
    record = save_acceptance(
        args.artifacts_dir, "latent_sde_lorenz_acceptance.json", device,
        workload="latent_sde_lorenz", steps=args.steps, batch=args.batch,
        adjoint=not args.no_adjoint, fused=args.fused,
        recon_mse_initial=mse0, recon_mse_final=mse1,
        accept_recon_mse_below=0.15, accept_improvement_factor=4.0,
        median_step_ms=median_ms(step_s),
        passed=bool(mse1 < 0.15 and mse1 * 4.0 < mse0))

    plt = pyplot(args.artifacts_dir)
    if plt is not None:
        _plot(plt, xs.cpu().numpy(), samples.cpu().numpy(), ts, args, mse0,
              mse1)
    return dict(losses=losses, step_s=step_s, acceptance=record,
                samples_finite=finite, model=model)


def _plot(plt, xs, samples, ts, args, mse0, mse1):
    fig = plt.figure(figsize=(12, 7))
    n_show = 4
    for dim, label in enumerate("xyz"):
        ax = fig.add_subplot(2, 3, dim + 1)
        for b in range(n_show):
            ax.plot(ts, xs[:, b, dim], lw=1.0, alpha=0.8, color=f"C{b}")
            ax.plot(ts, samples[:, b, dim], lw=1.0, ls="--", color=f"C{b}")
        ax.set_title(f"{label}(t): data (solid) vs posterior (dashed)")
    for pos, paths, title, ls in ((4, xs, "data", "-"),
                                  (5, samples, "posterior samples", "--")):
        ax3d = fig.add_subplot(2, 3, pos, projection="3d")
        for b in range(n_show):
            ax3d.plot(paths[:, b, 0], paths[:, b, 1], paths[:, b, 2],
                      lw=0.8, ls=ls, color=f"C{b}")
        ax3d.set_title(title)
    ax = fig.add_subplot(2, 3, 6)
    ax.set_title(f"recon MSE {mse0:.3f} -> {mse1:.4f}")
    ax.axis("off")
    fig.tight_layout()
    out = artifact_path(args.artifacts_dir, "latent_sde_lorenz_fit.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print("saved", out)


if __name__ == "__main__":
    main()
