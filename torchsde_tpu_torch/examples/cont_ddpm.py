"""Continuous-time DDPM on synthetic blobs or real digit images
(counterpart of the JAX package's ``examples/cont_ddpm.py``).

VP-SDE score matching with a U-Net denoiser, reverse-time SDE sampling
through ``sdeint`` (with the Tweedie correction, or ``--denoise-t``'s exact
jump) and probability-flow ODE sampling.

Datasets (generated or read offline, nothing is downloaded):
  --dataset blobs   single-gaussian synthetic blobs.
  --dataset digits  sklearn.datasets.load_digits()'s 1,797 real 8x8 images
                    of handwritten digits, 10 classes, read from the copy of
                    its file in data/ (data/README.md), bilinearly upsampled
                    to --size; scikit-learn is not needed.
                    Acceptance is class-aware: 5-NN purity, nearest-data
                    distance and class coverage of reverse-SDE samples.

The reference U-Net scale is --base-ch 64 --ch-mults 1,2,4.

Usage: python -m torchsde_tpu_torch.examples.cont_ddpm [--dataset blobs]
       [--steps 200] [--cpu]
"""

import argparse
import gzip
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ._evidence import (JsonlLogger, artifact_path, example_device,
                        median_ms, pyplot, save_acceptance, stream)
from ..models.cont_ddpm import ReverseDiffeqWrapper, ScoreMatchingSDE
from ..models.unet import UNet
from ..utils.checkpoint import load_checkpoint, save_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=("blobs", "digits"), default="blobs")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--base-ch", type=int, default=32)
    p.add_argument("--ch-mults", type=str, default="1,2",
                   help="comma-separated U-Net channel multipliers; the "
                        "reference example scale is 1,2,4 with --base-ch 64")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--sample-dt", type=float, default=2e-2)
    p.add_argument("--sweep-sample-dts", type=str, default=None,
                   help="comma-separated sampling dts to evaluate after the "
                        "one training run (digits only); the best-purity dt "
                        "is scored again on a fresh stream for the "
                        "acceptance and the sample grid, and every row is "
                        "recorded in the acceptance JSON")
    p.add_argument("--accept-purity", type=float, default=0.8,
                   help="acceptance bound on generated 5-NN class purity")
    p.add_argument("--denoise-t", type=float, default=None,
                   help="stop the reverse solve at this time and jump to t0 "
                        "with the exact Tweedie posterior mean")
    p.add_argument("--save-ckpt", type=str, default=None,
                   help="save the trained model here")
    p.add_argument("--load-ckpt", type=str, default=None,
                   help="load a model and skip training (for sampling-only "
                        "sweeps)")
    p.add_argument("--eval-samples", type=int, default=128,
                   help="reverse-SDE samples drawn for the acceptance metric")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--log-jsonl", type=str, default=None,
                   help="append per-step loss records to this JSONL file")
    p.add_argument("--artifacts-dir", type=str, default=None,
                   help="save the sample grid + acceptance record here")
    return p.parse_args(argv)


def make_blobs(generator, n, H):
    """(n, 1, H, H) images in [-1, 1] of one gaussian blob of width H/8,
    centred uniformly in the middle half of the image."""
    device = generator.device
    cx = torch.rand((n, 1, 1), generator=generator, device=device) \
        * (0.5 * H) + 0.25 * H
    cy = torch.rand((n, 1, 1), generator=generator, device=device) \
        * (0.5 * H) + 0.25 * H
    yy, xx = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(H, device=device), indexing="ij")
    img = torch.exp(-((xx[None] - cx) ** 2 + (yy[None] - cy) ** 2)
                    / (2 * (H / 8) ** 2))
    return (img * 2 - 1)[:, None, :, :]


DIGITS_CSV = Path(__file__).resolve().parent / "data" / "digits.csv.gz"


def read_digits():
    """``(images, target)`` as ``sklearn.datasets.load_digits()`` gives
    them, (1797, 8, 8) float64 pixel counts 0-16 and int digits, parsed
    from the committed copy of scikit-learn's ``digits.csv.gz`` as
    scikit-learn parses it."""
    with gzip.open(DIGITS_CSV, mode="rt", encoding="utf-8") as fh:
        data = np.loadtxt(fh, delimiter=",")
    return data[:, :-1].reshape(-1, 8, 8), data[:, -1].astype(int)


def load_digit_images(H):
    """``(train, train_labels, held, held_labels)``: the digits' images in
    [-1, 1], shuffled by RandomState(0), upsampled bilinearly to H x H, the
    last 197 held out."""
    images, labels = read_digits()
    imgs = images.astype("float32") / 16.0 * 2.0 - 1.0
    perm = np.random.RandomState(0).permutation(len(imgs))
    imgs, labels = imgs[perm], labels[perm]
    imgs = F.interpolate(torch.as_tensor(imgs)[:, None], size=(H, H),
                         mode="bilinear", align_corners=False)
    n_train = len(imgs) - 197
    return imgs[:n_train], labels[:n_train], imgs[n_train:], labels[n_train:]


def blob_fit(samples):
    """Mean Pearson correlation between each (1, H, H) sample and the ideal
    blob rendered at the sample's own peak (of the image smoothed by a
    gaussian of width 1): 1.0 for exactly the data family, ~0 for noise."""
    from scipy import ndimage
    samples = np.asarray(samples, np.float32)
    H = samples.shape[-1]
    yy, xx = np.mgrid[0:H, 0:H]
    corrs = []
    for img in samples[:, 0]:
        sm = ndimage.gaussian_filter(img, 1.0)
        cy, cx = np.unravel_index(int(sm.argmax()), sm.shape)
        ideal = (np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                        / (2 * (H / 8) ** 2)) * 2 - 1).astype(np.float32)
        a = (img - img.mean()).ravel()
        b = (ideal - ideal.mean()).ravel()
        corrs.append(float((a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                      + 1e-12)))
    return float(np.mean(np.asarray(corrs, np.float32)))


def knn_stats(samples, ref_x, ref_y, k=5):
    """k-NN class purity, mean nearest-data distance, and predicted class
    of each sample against the labelled training set."""
    s = np.asarray(samples).reshape(len(samples), -1)
    r = np.asarray(ref_x).reshape(len(ref_x), -1)
    d2 = ((s[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1)[:, :k]
    purs, nnd, pred = [], [], []
    for i in range(len(s)):
        cls = np.asarray(ref_y)[idx[i]]
        vals, cnts = np.unique(cls, return_counts=True)
        purs.append(cnts.max() / k)
        pred.append(int(vals[cnts.argmax()]))
        nnd.append(float(np.sqrt(d2[i, idx[i, 0]])))
    return (float(np.mean(purs)), float(np.mean(nnd)), pred)


def main(argv=None):
    """Train (or load), sample, write the records. Returns a dict of the
    run's losses, step times (s), acceptance record and samples."""
    args = parse_args(argv)
    device = example_device(args.cpu)
    H = args.size
    if args.dataset == "digits":
        data, train_labels, held_data, held_labels = load_digit_images(H)
        data = data.to(device)
        print(f"digits: {data.shape[0]} train / {held_data.shape[0]} "
              f"held-out images at {H}x{H}")
    else:
        data = make_blobs(stream(device, 0), 512, H)

    ch_mults = tuple(int(c) for c in args.ch_mults.split(","))
    denoiser = UNet(1, args.base_ch, ch_mults, device=device,
                    generator=stream("cpu", 1))
    sde = ScoreMatchingSDE(denoiser, input_size=(1, H, H))
    opt = torch.optim.Adam(sde.parameters(), lr=args.lr)
    logger = JsonlLogger(args.log_jsonl, device)

    losses, step_s = [], []
    log_every = max(1, args.steps // 200)
    if args.load_ckpt:
        load_checkpoint(args.load_ckpt, device, sde=sde)
        print(f"loaded checkpoint {args.load_ckpt}; skipping training")
        args.steps = 0
    for step in range(args.steps):
        t0 = time.perf_counter()
        idx = torch.randperm(data.shape[0], generator=stream(device,
                                                             100 + step),
                             device=device)[:args.batch]
        opt.zero_grad(set_to_none=True)
        loss = sde.loss(stream(device, 200 + step), data[idx],
                        partitions=1).mean()
        loss.backward()
        opt.step()
        loss = loss.detach()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        if step % log_every == 0 or step == args.steps - 1:
            losses.append(float(loss))
            logger.write(step=step, loss=float(loss))
        if step % max(1, args.steps // 10) == 0:
            print(f"step {step:4d} score-matching loss {float(loss):10.3f}")
    if args.save_ckpt:
        print("saved checkpoint", save_checkpoint(
            args.save_ckpt, sde=sde, opt=opt, step=args.steps))

    rev = ReverseDiffeqWrapper(sde)
    n_eval = args.eval_samples if args.dataset == "digits" else 16
    sweep_rows = []
    with torch.no_grad():
        if args.sweep_sample_dts and args.dataset == "digits":
            # One training run, several sampling resolutions, all on one
            # stream: the comparison varies only the grid.
            best = (None, -1.0)
            for sdt in (float(s) for s in args.sweep_sample_dts.split(",")):
                s_sde = rev.sde_sample_final(stream(device, 900), n_eval,
                                             dt=sdt, denoise_t=args.denoise_t)
                pur, nnd, prd = knn_stats(s_sde[:, 0].cpu(), data[:, 0].cpu(),
                                          train_labels)
                cov = len(set(prd))
                sweep_rows.append(dict(sample_dt=sdt, knn_purity=pur,
                                       mean_nn_dist=nnd, class_coverage=cov))
                print(f"  sweep dt={sdt:g}: purity={pur:.3f} "
                      f"nn_dist={nnd:.2f} classes={cov}/10")
                if pur > best[1]:
                    best = (sdt, pur)
            args.sample_dt = best[0]
            print(f"sweep winner: dt={args.sample_dt:g} (purity "
                  f"{best[1]:.3f}); scored again on a fresh stream")
        # The acceptance's samples: after a sweep, a stream the sweep did
        # not use, so the winner is not scored on the samples that chose it.
        samp_sde = rev.sde_sample_final(
            stream(device, 903 if sweep_rows else 900), n_eval,
            dt=args.sample_dt, denoise_t=args.denoise_t)
        samp_ode = rev.ode_sample(batch_size=4, dt=args.sample_dt,
                                  generator=stream(device, 901))
    finite = bool(torch.isfinite(samp_sde).all()
                  and torch.isfinite(samp_ode).all())
    print("reverse-SDE samples:", tuple(samp_sde.shape), "finite:",
          bool(torch.isfinite(samp_sde).all()), "range",
          float(samp_sde.min()), float(samp_sde.max()))
    print("prob-flow ODE samples:", tuple(samp_ode.shape), "finite:",
          bool(torch.isfinite(samp_ode).all()))

    # Absent when training was skipped: written as null.
    loss0 = losses[0] if losses else None
    loss1 = float(np.mean(losses[-10:])) if losses else None
    loss_ok = True if args.load_ckpt else bool(loss1 * 3.0 < loss0)
    samples = samp_sde.cpu().numpy()

    if args.dataset == "digits":
        train_np = data[:, 0].cpu().numpy()
        purity, nn_dist, pred = knn_stats(samples[:, 0], train_np,
                                          train_labels)
        coverage = len(set(pred))
        pur_real, nnd_real, pred_real = knn_stats(
            held_data[:n_eval, 0].numpy(), train_np, train_labels)
        noise_imgs = torch.randn((n_eval, H, H), generator=stream(device,
                                                                  902),
                                 device=device).cpu().numpy()
        pur_noise, nnd_noise, _ = knn_stats(noise_imgs, train_np,
                                            train_labels)
        held_acc = float(np.mean(np.asarray(pred_real)
                                 == np.asarray(held_labels[:n_eval])))
        print(f"generated: purity={purity:.3f} nn_dist={nn_dist:.2f} "
              f"classes={coverage}/10")
        print(f"held-out real: purity={pur_real:.3f} nn_dist={nnd_real:.2f} "
              f"(1-NN-majority label accuracy {held_acc:.3f})")
        print(f"noise baseline: purity={pur_noise:.3f} "
              f"nn_dist={nnd_noise:.2f}")
        passed = bool(purity >= args.accept_purity and nn_dist <= 12.0
                      and coverage >= 7 and loss_ok)
        record = save_acceptance(
            args.artifacts_dir, "cont_ddpm_acceptance.json", device,
            workload="cont_ddpm_digits", steps=args.steps, batch=args.batch,
            size=H, base_ch=args.base_ch, ch_mults=list(ch_mults),
            n_eval_samples=n_eval, sample_dt=args.sample_dt,
            denoise_t=args.denoise_t, sample_dt_sweep=sweep_rows or None,
            loss_first=loss0, loss_final_mean10=loss1,
            knn_purity=purity, mean_nn_dist=nn_dist, class_coverage=coverage,
            calib_heldout_purity=pur_real, calib_heldout_nn_dist=nnd_real,
            calib_heldout_label_acc=held_acc,
            calib_noise_purity=pur_noise, calib_noise_nn_dist=nnd_noise,
            accept_purity_at_least=args.accept_purity,
            accept_nn_dist_at_most=12.0,
            accept_class_coverage_at_least=7, accept_loss_drop_factor=3.0,
            median_step_ms=median_ms(step_s), passed=passed)
        title = (f"cont-DDPM (digits {H}x{H}, base {args.base_ch}, mults "
                 f"{ch_mults}): purity {purity:.3f}, nn-dist {nn_dist:.1f}, "
                 f"{coverage}/10 classes")
    else:
        corr = blob_fit(samples)
        # Acceptance, pre-registered: the samples are blob-shaped (mean
        # correlation with the ideal blob at each sample's own peak > 0.8)
        # and the loss dropped at least 3x from its first record.
        record = save_acceptance(
            args.artifacts_dir, "cont_ddpm_acceptance.json", device,
            workload="cont_ddpm", steps=args.steps, batch=args.batch,
            size=H, base_ch=args.base_ch, ch_mults=list(ch_mults),
            loss_first=loss0, loss_final_mean10=loss1, blob_corr=corr,
            accept_blob_corr_above=0.8, accept_loss_drop_factor=3.0,
            median_step_ms=median_ms(step_s),
            passed=bool(corr > 0.8 and loss_ok))
        title = (f"cont-DDPM reverse-SDE samples vs data "
                 f"(blob corr {corr:.3f}, loss {loss0} -> {loss1})")

    plt = pyplot(args.artifacts_dir)
    if plt is not None:
        _plot(plt, samples, data[:16, 0].cpu().numpy(), min(16, n_eval),
              title, args)
    return dict(losses=losses, step_s=step_s, acceptance=record,
                samples_finite=finite, sde=sde)


def _plot(plt, samples, data, n_show, title, args):
    fig, axes = plt.subplots(4, 8, figsize=(14, 7))
    for i in range(n_show):
        ax = axes[i // 8][i % 8]
        ax.imshow(samples[i, 0], cmap="gray", vmin=-1, vmax=1)
        ax.set_title("sample", fontsize=7)
        ax.axis("off")
    for j in range(min(16, len(data))):
        ax = axes[2 + j // 8][j % 8]
        ax.imshow(data[j], cmap="gray", vmin=-1, vmax=1)
        ax.set_title("data", fontsize=7)
        ax.axis("off")
    fig.suptitle(title)
    fig.tight_layout()
    out = artifact_path(args.artifacts_dir, "cont_ddpm_samples.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print("saved", out)


if __name__ == "__main__":
    main()
