"""SDE-GAN on time-dependent Ornstein-Uhlenbeck data (counterpart of the
JAX package's ``examples/sde_gan.py``).

A reversible-Heun generator with adjoint gradients (dt 1.0), a
linear-interpolation neural-CDE critic, the Wasserstein objective with the
generator's gradients negated, Adadelta with coupled weight decay, the
critic's weight clip after every step, and stochastic weight averaging.
``--fused`` trains through the whole-solve kernels (kernels 5-8); without
it the solves take the adjoint route, as in the JAX example.

Usage: python -m torchsde_tpu_torch.examples.sde_gan [--steps 200]
       [--fused] [--cpu]
"""

import argparse
import copy
import time

import numpy as np
import torch

from ._evidence import (JsonlLogger, artifact_path, example_device,
                        median_ms, pyplot, save_acceptance, stream)
from ..models import sde_gan as G


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--t-size", type=int, default=32)
    p.add_argument("--dataset-size", type=int, default=1024)
    p.add_argument("--init-noise", type=int, default=5)
    p.add_argument("--noise-size", type=int, default=3)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--mlp-size", type=int, default=16)
    p.add_argument("--num-layers", type=int, default=1)
    p.add_argument("--drop-frac", type=float, default=0.0,
                   help="fraction of observations dropped to NaN and filled "
                        "by linear interpolation")
    p.add_argument("--init-mult1", type=float, default=3.0,
                   help="initial-MLP parameter scale")
    p.add_argument("--init-mult2", type=float, default=0.5,
                   help="vector-field parameter scale")
    p.add_argument("--gen-lr", type=float, default=2e-4)
    p.add_argument("--disc-lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--swa-step-start", type=int, default=100)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--fused", action="store_true",
                   help="whole-solve CUDA kernels")
    p.add_argument("--log-jsonl", type=str, default=None,
                   help="append per-step loss/KS records to this JSONL file")
    p.add_argument("--artifacts-dir", type=str, default=None,
                   help="save the marginals plot + acceptance record here")
    p.add_argument("--eval-every", type=int, default=None,
                   help="evaluate generated-vs-real marginal KS every N steps")
    p.add_argument("--eval-final-n", type=int, default=8192,
                   help="generated-sample count for the final acceptance "
                        "eval (in-training evals use n=1024)")
    return p.parse_args(argv)


# Disjoint streams a step: the batch permutation, the training noise, the
# evaluation (the JAX example's fold_in(key, 17 / 18 / 19)).
PERM, NOISE, EVAL = 17, 18, 19


class GanRun:
    """The example's training state: data, networks, their Adadelta
    optimisers and the SWA running average of both networks."""

    def __init__(self, args):
        self.args = args
        self.device = device = example_device(args.cpu)
        with torch.no_grad():
            ts, self.data = G.get_ou_data(stream(device, 0),
                                          args.dataset_size, args.t_size,
                                          drop_frac=args.drop_frac,
                                          device=device)
        self.ts = ts.cpu().numpy().astype(np.float64)
        self.gen = G.Generator(
            1, args.init_noise, args.noise_size, args.hidden, args.mlp_size,
            args.num_layers, init_mult1=args.init_mult1,
            init_mult2=args.init_mult2, device=device,
            generator=stream("cpu", 1))
        self.disc = G.Discriminator(1, args.hidden + 1, args.mlp_size,
                                    args.num_layers, device=device,
                                    generator=stream("cpu", 2))
        # Coupled weight decay, as optax's add_decayed_weights before
        # adadelta: both add decay * w to the gradient (rho 0.9, eps 1e-6).
        self.opt_g = torch.optim.Adadelta(self.gen.parameters(),
                                          lr=args.gen_lr,
                                          weight_decay=args.weight_decay)
        self.opt_d = torch.optim.Adadelta(self.disc.parameters(),
                                          lr=args.disc_lr,
                                          weight_decay=args.weight_decay)
        self.avg_gen = copy.deepcopy(self.gen).requires_grad_(False)
        self.avg_disc = copy.deepcopy(self.disc).requires_grad_(False)
        self.n_avg = 0

    def entries(self):
        """Everything a checkpoint must hold to resume, by name."""
        return dict(gen=self.gen, disc=self.disc, opt_g=self.opt_g,
                    opt_d=self.opt_d, avg_gen=self.avg_gen,
                    avg_disc=self.avg_disc)

    def step(self, step):
        """Training step ``step``: a batch, ``gan_grads``, both updates,
        the clip, the SWA update. Returns the detached loss."""
        args, device = self.args, self.device
        perm = torch.randperm(args.dataset_size,
                              generator=stream(device, PERM, step),
                              device=device)
        batch = self.data[perm[:args.batch]]
        loss, g_gen, g_disc = G.gan_grads(
            self.gen, self.disc, stream(device, NOISE, step), self.ts, batch,
            adjoint=not args.fused, fused=args.fused)
        for module, grads in ((self.gen, g_gen), (self.disc, g_disc)):
            for name, p in module.named_parameters():
                p.grad = grads[name]
        self.opt_g.step()
        self.opt_d.step()
        self.disc.clip_weights()
        # SWA: before --swa-step-start track the live weights, after it
        # fold them into the running mean.
        averaging = step >= args.swa_step_start
        w = 1.0 / (self.n_avg + 1) if averaging else 1.0
        with torch.no_grad():
            for avg, live in ((self.avg_gen, self.gen),
                              (self.avg_disc, self.disc)):
                for a, b in zip(avg.parameters(), live.parameters()):
                    a.copy_((1 - w) * a + w * b)
        self.n_avg += int(averaging)
        return loss

    def marginal_ks(self, generator, gen, n=1024):
        """Mean and max two-sample KS distance between generated and real
        marginals over every observation time, and the time of the max."""
        with torch.no_grad():
            fake = generator(gen, self.ts, n)[..., 1].cpu().numpy()
        real = self.data[:, :, 1].cpu().numpy()
        return marginal_ks(fake, real)


def marginal_ks(fake, real):
    """``(mean, max, argmax)`` over times of ``ks_2samp(fake[:, t],
    real[:, t])``, for (n, T) and (N, T) arrays."""
    from scipy import stats
    # The statistic alone is read: the asymptotic method skips the exact
    # p-value, which takes seconds a time at these sample sizes.
    ks = [stats.ks_2samp(fake[:, t], real[:, t], method="asymp").statistic
          for t in range(fake.shape[1])]
    return float(np.mean(ks)), float(np.max(ks)), int(np.argmax(ks))


def main(argv=None):
    """Train, evaluate, write the records. Returns a dict of the run's
    losses, step times (s), acceptance record and state."""
    args = parse_args(argv)
    run = GanRun(args)
    device = run.device
    logger = JsonlLogger(args.log_jsonl, device)

    eval_every = args.eval_every or max(1, args.steps // 20)
    ks0_mean, ks0_max, _ = run.marginal_ks(run.gen, stream(device, 555))
    print(f"initial marginal KS mean {ks0_mean:.4f} max {ks0_max:.4f}")

    log_every = max(1, args.steps // 200)
    losses, step_s = [], []
    t_train = time.perf_counter()
    for step in range(args.steps):
        t0 = time.perf_counter()
        loss = run.step(step)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        # The eval cadence is independent of the log cadence (an eval step
        # always writes a record).
        do_eval = step % eval_every == 0 or step == args.steps - 1
        if do_eval or step % log_every == 0:
            rec = dict(step=step, loss=float(loss))
            losses.append(float(loss))
            if do_eval:
                rec["ks_mean"], rec["ks_max"], rec["ks_argmax"] = \
                    run.marginal_ks(run.avg_gen, stream(device, EVAL, step))
            logger.write(**rec)
        if step % max(1, args.steps // 10) == 0:
            print(f"step {step:4d} wasserstein loss {float(loss):9.4f}")
    wall = time.perf_counter() - t_train
    print(f"trained {args.steps} steps in {wall:.1f}s (median step "
          f"{median_ms(step_s)} ms)")

    with torch.no_grad():
        fake = run.avg_gen(stream(device, 9999), run.ts, 8)
    finite = bool(torch.isfinite(fake).all())
    print("generated paths:", tuple(fake.shape), "finite:", finite)
    print(f"real mean {float(run.data[..., 1].mean()):+.3f}  generated "
          f"mean {float(fake[..., 1].mean()):+.3f}")

    ks1_mean, ks1_max, ks1_argmax = run.marginal_ks(
        run.avg_gen, stream(device, 556), n=args.eval_final_n)
    # Acceptance, pre-registered: the SWA generator's per-time marginals
    # sit within KS 0.12 of the data on average, the worst single time
    # under KS 0.15, and the mean improved at least 3x.
    record = save_acceptance(
        args.artifacts_dir, "sde_gan_acceptance.json", device,
        workload="sde_gan", steps=args.steps, batch=args.batch,
        fused=args.fused, ks_mean_initial=ks0_mean, ks_mean_final=ks1_mean,
        ks_max_final=ks1_max, ks_argmax_final=ks1_argmax,
        accept_ks_mean_below=0.12, accept_ks_max_below=0.15,
        accept_improvement_factor=3.0, median_step_ms=median_ms(step_s),
        passed=bool(ks1_mean < 0.12 and ks1_max < 0.15
                    and ks1_mean * 3.0 < ks0_mean))

    plt = pyplot(args.artifacts_dir)
    if plt is not None:
        _plot(plt, run, args, ks0_mean, ks1_mean)
    return dict(losses=losses, step_s=step_s, acceptance=record,
                samples_finite=finite, run=run)


def _plot(plt, run, args, ks0_mean, ks1_mean):
    device = run.device
    with torch.no_grad():
        fake_paths = run.avg_gen(stream(device, 777), run.ts, 30)[..., 1]
        fake_big = run.avg_gen(stream(device, 778), run.ts, 1024)[..., 1]
    fake_paths, fake_big = fake_paths.cpu().numpy(), fake_big.cpu().numpy()
    data = run.data[..., 1].cpu().numpy()
    ts = run.ts
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    axes[0].plot(ts, data[:30].T, lw=0.7, color="C0", alpha=0.5)
    axes[0].plot(ts, fake_paths.T, lw=0.7, color="C1", alpha=0.5)
    axes[0].set_title("real (blue) vs generated (orange) paths")
    for ax, t_idx in zip(axes[1:], (len(ts) // 2, len(ts) - 1)):
        ax.hist(data[:, t_idx], bins=40, density=True, alpha=0.5,
                label="real", color="C0")
        ax.hist(fake_big[:, t_idx], bins=40, density=True, alpha=0.5,
                label="generated", color="C1")
        ax.set_title(f"marginal at t={float(ts[t_idx]):.1f}")
        ax.legend()
    fig.suptitle(f"SDE-GAN marginals: KS mean {ks0_mean:.3f} -> "
                 f"{ks1_mean:.3f}")
    fig.tight_layout()
    out = artifact_path(args.artifacts_dir, "sde_gan_marginals.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print("saved", out)


if __name__ == "__main__":
    main()
