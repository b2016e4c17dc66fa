"""The port's examples (``torchsde_tpu_torch/examples/``) on the CPU.

Each example's ``main`` runs in this process with ``--cpu`` at the tiny
arguments of ``tests/test_examples.py`` and prints no NaN. The pieces the
JAX examples define inside their ``main`` are transcribed here in JAX and
held to the port's: the sinusoid model's ``f_aug``, ``g_aug`` and loss at
1e-9 in float64 (weights carried across by ``load_jax_params``, the noise
a ``PrecomputedBrownian`` table both packages draw alike), and
``marginal_ks``, ``knn_stats``, ``blob_fit`` and the Lorenz reconstruction
error on the same arrays. Then the contracts the port adds: Adadelta with
weight decay is optax's chain, SWA is the running mean, the streams are
the JAX examples' ``fold_in`` keys, a Lorenz run split by ``--save`` and
``--restore`` is bitwise the whole run, the DDPM records are strict JSON
and its sweep's winner is scored on a fresh stream, and without ``--cpu``
an example raises where there is no card."""

import importlib
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchsde_tpu as jtsde
from port_bridge import jax_named_arrays, perturbed
from torchsde_tpu.models.layers import MLP as JMLP
from torchsde_tpu.utils.misc import stable_division as jstable_division
from torchsde_tpu_torch.brownian.precomputed import PrecomputedBrownian
from torchsde_tpu_torch.examples import _evidence
from torchsde_tpu_torch.examples import cont_ddpm, latent_sde
from torchsde_tpu_torch.examples import latent_sde_lorenz, sde_gan
from torchsde_tpu_torch.utils.convert import load_jax_params


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the tier-1 run's workers share the
    CPU, and oversubscribed threads slow these eager loops several times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# tests/test_examples.py's tiny arguments.
CASES = {
    "demo": ["--cpu"],
    "latent_sde": ["--steps", "2", "--batch", "8", "--cpu"],
    "latent_sde_lorenz": ["--steps", "2", "--batch", "8", "--t-size", "8",
                          "--latent", "3", "--context", "8", "--hidden", "8",
                          "--cpu"],
    "sde_gan": ["--steps", "2", "--batch", "8", "--t-size", "8",
                "--dataset-size", "16", "--hidden", "4", "--mlp-size", "4",
                "--swa-step-start", "1", "--cpu"],
    "cont_ddpm": ["--steps", "2", "--batch", "4", "--size", "8",
                  "--base-ch", "8", "--sample-dt", "0.25", "--cpu"],
}
F64_TOL = 1e-9


def _module(name):
    return importlib.import_module(f"torchsde_tpu_torch.examples.{name}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_main_runs_on_the_cpu(name, capsys, tmp_path):
    argv = list(CASES[name])
    if name != "demo":
        argv += ["--log-jsonl", str(tmp_path / "train.jsonl")]
    _module(name).main(argv)
    out = capsys.readouterr().out
    assert "nan" not in out.lower().replace("finite: true", ""), out
    if name != "demo":
        for line in (tmp_path / "train.jsonl").read_text().splitlines():
            json.loads(line, parse_constant=lambda c: 1 / 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_without_cpu_raises_where_there_is_no_card(name,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in CASES[name] if a != "--cpu"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _module(name).main(argv)


# --------------------------------------------------------------------------- #
#  The sinusoid: examples/latent_sde.py:50-141, transcribed with eps and bm   #
# --------------------------------------------------------------------------- #

class JLatentSDE1D(jtsde.Module):
    noise_type = "diagonal"
    sde_type = "ito"

    def __init__(self, key, theta=1.0, mu=0.0, sigma=0.5):
        logvar = math.log(sigma ** 2 / (2.0 * theta))
        self.theta = jnp.asarray([[theta]])
        self.mu = jnp.asarray([[mu]])
        self.sigma = jnp.asarray([[sigma]])
        self.py0_mean = jnp.asarray([[mu]])
        self.py0_logvar = jnp.asarray([[logvar]])
        self.net = JMLP(key, (3, 200, 200, 1), activation="tanh",
                        dtype=jnp.float64)
        self.net.layers[-1].w = jnp.zeros_like(self.net.layers[-1].w)
        self.net.layers[-1].b = jnp.zeros_like(self.net.layers[-1].b)
        self.qy0_mean = jnp.asarray([[mu]])
        self.qy0_logvar = jnp.asarray([[logvar]])

    def f(self, t, y):
        tt = jnp.broadcast_to(jnp.asarray(t, y.dtype), y.shape)
        return self.net(jnp.concatenate([jnp.sin(tt), jnp.cos(tt), y],
                                        axis=-1))

    def g(self, t, y):
        return jnp.broadcast_to(self.sigma, y.shape)

    def h(self, t, y):
        return self.theta * (self.mu - y)

    def f_aug(self, t, y):
        y = y[:, 0:1]
        f, g, h = self.f(t, y), self.g(t, y), self.h(t, y)
        u = jstable_division(f - h, g)
        f_logqp = 0.5 * jnp.sum(u ** 2, axis=1, keepdims=True)
        return jnp.concatenate([f, f_logqp], axis=1)

    def g_aug(self, t, y):
        y = y[:, 0:1]
        g = self.g(t, y)
        return jnp.concatenate([g, jnp.zeros_like(y)], axis=1)


def jax_loss(model, ts, ys_data, eps, kl_coeff, bm, dt, scale=0.05):
    qy0_std = jnp.exp(0.5 * model.qy0_logvar)
    py0_std = jnp.exp(0.5 * model.py0_logvar)
    y0 = model.qy0_mean + eps * qy0_std
    logqp0 = jnp.sum(
        model.py0_logvar / 2 - model.qy0_logvar / 2 +
        (qy0_std ** 2 + (model.qy0_mean - model.py0_mean) ** 2) /
        (2 * py0_std ** 2) - 0.5)
    aug_y0 = jnp.concatenate([y0, jnp.zeros((eps.shape[0], 1))], axis=1)
    aug_ys = jtsde.sdeint(model, aug_y0, ts, method="euler", dt=dt,
                          names={"drift": "f_aug", "diffusion": "g_aug"},
                          bm=bm)
    ys_model, logqp_path = aug_ys[1:-1, :, 0:1], aug_ys[-1, :, 1]
    logpy = jnp.sum(jnp.mean(
        -0.5 * ((ys_data - ys_model) / scale) ** 2
        - math.log(scale * math.sqrt(2 * math.pi)), axis=1))
    logqp = logqp0 + jnp.mean(logqp_path)
    return -logpy + kl_coeff * logqp, (logpy, logqp)


SIN_B = 6


def _sinusoid_pair():
    jm = perturbed(JLatentSDE1D(jax.random.PRNGKey(3)), seed=4)
    tm = latent_sde.LatentSDE1D(dtype=torch.float64, device="cpu")
    load_jax_params(tm, jax_named_arrays(jm))
    return jm, tm


def test_sinusoid_parameters_carry_over_by_name():
    jm, tm = _sinusoid_pair()
    assert set(jax_named_arrays(jm)) == set(dict(tm.named_parameters()))


def test_sinusoid_f_aug_and_g_aug_match_jax_f64():
    jm, tm = _sinusoid_pair()
    y = np.random.default_rng(5).standard_normal((SIN_B, 2))
    for t in (0.0, 0.37, 1.6):
        for name in ("f_aug", "g_aug", "h"):
            want = np.asarray(getattr(jm, name)(t, jnp.asarray(y)))
            got = getattr(tm, name)(t, torch.as_tensor(y)).detach().numpy()
            np.testing.assert_allclose(got, want, rtol=F64_TOL,
                                       atol=F64_TOL, err_msg=name)


@pytest.mark.parametrize("kl_coeff", [0.0, 0.4, 1.0])
def test_sinusoid_loss_matches_jax_f64(kl_coeff):
    jm, tm = _sinusoid_pair()
    rng = np.random.default_rng(6)
    ts = np.concatenate([[0.0], np.sort(rng.uniform(0.4, 1.6, 16)), [2.0]])
    ys = rng.standard_normal((16, SIN_B, 1)) * 0.5
    eps = rng.standard_normal((SIN_B, 1))
    kw = dict(t0=0.0, t1=2.0, size=(SIN_B, 2), n=2000, entropy=8)
    jbm = jtsde.PrecomputedBrownian(dtype=jnp.float64, **kw)
    tbm = PrecomputedBrownian(dtype=torch.float64, device="cpu", **kw)
    want, (jlogpy, jlogqp) = jax_loss(jm, ts, jnp.asarray(ys),
                                      jnp.asarray(eps), kl_coeff, jbm, 0.05)
    got, (logpy, logqp) = latent_sde.loss_fn(
        tm, ts, torch.as_tensor(ys), torch.as_tensor(eps), kl_coeff,
        dt=0.05, bm=tbm)
    for g, w in ((got, want), (logpy, jlogpy), (logqp, jlogqp)):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=F64_TOL)


def test_sinusoid_data_are_sorted_times_and_noisy_sines():
    ts, ys = latent_sde.make_data(torch.Generator().manual_seed(0), 4)
    assert ts.shape == (18,) and ts[0] == 0.0 and ts[-1] == 2.0
    assert np.all(np.diff(ts) > 0) and 0.4 <= ts[1] and ts[-2] < 1.6
    clean = 0.8 * np.sin(ts[1:-1] * 2 * np.pi)[:, None, None]
    assert ys.shape == (16, 4, 1)
    assert np.abs(ys.numpy() - clean).max() < 0.06


# --------------------------------------------------------------------------- #
#  Metrics on the same arrays (float32 sums to a few ulps)                    #
# --------------------------------------------------------------------------- #

def jax_marginal_ks(fake_, real_):
    """examples/sde_gan.py:134-139 on given arrays."""
    from scipy import stats
    ks = [stats.ks_2samp(fake_[:, t], real_[:, t]).statistic
          for t in range(fake_.shape[1])]
    return float(np.mean(ks)), float(np.max(ks)), int(np.argmax(ks))


def jax_knn_stats(samples, ref_x, ref_y, k=5):
    """examples/cont_ddpm.py:179-199."""
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


def jax_blob_fit(samples, H):
    """examples/cont_ddpm.py:138-157."""
    from scipy import ndimage
    yy, xx = jnp.mgrid[0:H, 0:H]
    corrs = []
    for img in samples[:, 0]:
        sm = ndimage.gaussian_filter(jnp.asarray(img), 1.0)
        cy, cx = jnp.unravel_index(int(sm.argmax()), sm.shape)
        ideal = jnp.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                        / (2 * (H / 8) ** 2)) * 2 - 1
        a = (img - img.mean()).ravel()
        b = (ideal - ideal.mean()).ravel()
        corrs.append(float((a @ b) / (jnp.linalg.norm(a)
                                      * jnp.linalg.norm(b) + 1e-12)))
    return float(jnp.mean(jnp.asarray(corrs)))


def test_marginal_ks_is_the_jax_examples():
    rng = np.random.default_rng(7)
    fake = rng.standard_normal((300, 9)).astype(np.float32)
    real = (rng.standard_normal((500, 9)) * 1.1 + 0.1).astype(np.float32)
    got, want = sde_gan.marginal_ks(fake, real), jax_marginal_ks(fake, real)
    # The port asks for the asymptotic p-value (the statistic alone is
    # read), whose code path rounds the statistic by an ulp or so.
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-12)
    assert got[2] == want[2]


def test_knn_stats_is_the_jax_examples():
    rng = np.random.default_rng(8)
    ref = rng.standard_normal((40, 6, 6)).astype(np.float32)
    labels = rng.integers(0, 10, 40)
    samples = ref[:12] + 0.3 * rng.standard_normal((12, 6, 6)).astype(
        np.float32)
    assert cont_ddpm.knn_stats(samples, ref, labels) == jax_knn_stats(
        samples, ref, labels)


def test_blob_fit_is_the_jax_examples():
    H = 12
    blobs = cont_ddpm.make_blobs(torch.Generator().manual_seed(9), 5, H)
    noisy = blobs + 0.5 * torch.randn(blobs.shape,
                                      generator=torch.Generator()
                                      .manual_seed(10))
    for x in (blobs, noisy):
        samples = x.numpy().astype(np.float32)
        np.testing.assert_allclose(cont_ddpm.blob_fit(samples),
                                   jax_blob_fit(samples, H), rtol=1e-6)
    assert cont_ddpm.blob_fit(blobs.numpy()) > 0.95


def test_recon_error_is_the_jax_examples():
    rng = np.random.default_rng(11)
    samples = rng.standard_normal((8, 5, 3)).astype(np.float32)
    xs = rng.standard_normal((8, 5, 3)).astype(np.float32)
    want = float(jnp.mean((jnp.asarray(samples) - jnp.asarray(xs)) ** 2))
    got = latent_sde_lorenz.recon_error(torch.as_tensor(samples),
                                        torch.as_tensor(xs))
    np.testing.assert_allclose(got, want, rtol=1e-6)   # float32 sums


# --------------------------------------------------------------------------- #
#  What the port adds                                                         #
# --------------------------------------------------------------------------- #

def test_adadelta_with_weight_decay_is_optax_chain():
    rng = np.random.default_rng(12)
    w = rng.standard_normal((4, 3))
    grads = [rng.standard_normal((4, 3)) for _ in range(3)]
    lr, wd = 1e-3, 0.01
    p = torch.nn.Parameter(torch.as_tensor(w.copy()))
    opt = torch.optim.Adadelta([p], lr=lr, weight_decay=wd)
    chain = optax.chain(optax.add_decayed_weights(wd), optax.adadelta(lr))
    jw = jnp.asarray(w)
    state = chain.init(jw)
    for g in grads:
        p.grad = torch.as_tensor(g)
        opt.step()
        updates, state = chain.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, updates)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw),
                                   rtol=1e-12, atol=1e-15)


GAN_TINY = CASES["sde_gan"][:-1] + ["--swa-step-start", "2", "--cpu"]


def test_swa_is_the_running_mean_from_its_start_step():
    run = sde_gan.GanRun(sde_gan.parse_args(GAN_TINY))
    live = []
    for step in range(6):
        run.step(step)
        if step >= 2:
            live.append([p.detach().clone() for p in run.gen.parameters()])
        else:
            for a, b in zip(run.avg_gen.parameters(), run.gen.parameters()):
                assert torch.equal(a, b)
    assert run.n_avg == 4
    for i, a in enumerate(run.avg_gen.parameters()):
        mean = torch.stack([ps[i] for ps in live]).mean(0)
        torch.testing.assert_close(a, mean, rtol=1e-5, atol=1e-7)
    for p in run.disc.parameters():
        if p.ndim == 2:
            lim = torch.tensor(1.0 / p.shape[1], dtype=p.dtype)
            assert float(p.detach().abs().max()) <= lim


@pytest.mark.parametrize("path", [(0,), (17, 3), (18, 3), (19, 3),
                                  (100,), (999,)])
def test_streams_are_seeded_from_the_jax_examples_keys(path):
    key = jax.random.PRNGKey(0)
    for p in path:
        key = jax.random.fold_in(key, p)
    hi, lo = (int(w) for w in np.asarray(key))
    gen = _evidence.stream("cpu", *path)
    assert gen.initial_seed() == (hi << 32) | lo
    want = torch.Generator().manual_seed((hi << 32) | lo)
    assert torch.equal(torch.rand(5, generator=gen),
                       torch.rand(5, generator=want))


def test_gan_streams_are_disjoint():
    seeds = {_evidence.stream("cpu", s, step).initial_seed()
             for s in (17, 18, 19) for step in range(50)}
    assert len(seeds) == 150


LORENZ_TINY = CASES["latent_sde_lorenz"] + ["--no-adjoint", "--fused"]


def _lorenz(tmp_path, steps, *extra):
    argv = [a for a in LORENZ_TINY]
    argv[argv.index("--steps") + 1] = str(steps)
    return latent_sde_lorenz.main(argv + list(extra))


def test_lorenz_split_by_save_and_restore_is_bitwise_the_whole_run(
        tmp_path):
    whole = _lorenz(tmp_path, 4)["model"]
    first = tmp_path / "first.pt"
    _lorenz(tmp_path, 2, "--save", str(first))
    second = tmp_path / "second.pt"
    resumed = _lorenz(tmp_path, 2, "--restore", str(first), "--save",
                      str(second))["model"]
    for (name, p), q in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(p, q), name
    saved = torch.load(second, weights_only=True)
    assert saved["step"] == ("value", 4)


def test_lorenz_fused_needs_no_adjoint():
    with pytest.raises(ValueError, match="fused=True"):
        latent_sde_lorenz.main(CASES["latent_sde_lorenz"] + ["--fused"])


DDPM_TINY = CASES["cont_ddpm"]


def test_ddpm_load_ckpt_writes_null_losses_in_strict_json(tmp_path):
    ck = tmp_path / "ddpm.pt"
    trained = cont_ddpm.main(DDPM_TINY + ["--save-ckpt", str(ck)])
    loaded = cont_ddpm.main(DDPM_TINY + ["--load-ckpt", str(ck),
                                         "--artifacts-dir",
                                         str(tmp_path / "art")])
    for a, b in zip(trained["sde"].parameters(),
                    loaded["sde"].parameters()):
        assert torch.equal(a, b)
    record = json.loads((tmp_path / "art" / "cont_ddpm_acceptance.json")
                        .read_text(), parse_constant=lambda c: 1 / 0)
    assert record["loss_first"] is None
    assert record["loss_final_mean10"] is None
    assert record["device"] == "cpu" and record["steps"] == 0


def test_ddpm_sweep_winner_is_scored_on_a_fresh_stream(monkeypatch):
    used = []
    real_stream = _evidence.stream

    def recording(device, *path):
        used.append(path)
        return real_stream(device, *path)

    monkeypatch.setattr(cont_ddpm, "stream", recording)
    cont_ddpm.main(["--dataset", "digits", "--steps", "1", "--batch", "4",
                    "--size", "8", "--base-ch", "8", "--eval-samples", "6",
                    "--sweep-sample-dts", "0.5,0.25", "--cpu"])
    sampled = [p for p in used if p[0] in (900, 903)]
    assert sampled == [(900,), (900,), (903,)]


def test_ddpm_digits_runs_without_scikit_learn(monkeypatch):
    """The digits are read from the committed copy of scikit-learn's file:
    the example runs with scikit-learn blocked."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    out = cont_ddpm.main(["--dataset", "digits", "--steps", "1", "--batch",
                          "4", "--size", "8", "--base-ch", "8",
                          "--eval-samples", "6", "--cpu"])
    assert out["acceptance"]["workload"] == "cont_ddpm_digits"


def test_digits_file_parses_as_load_digits():
    """read_digits gives load_digits()'s images and targets bit for bit
    (where scikit-learn imports)."""
    datasets = pytest.importorskip("sklearn.datasets")
    want = datasets.load_digits()
    images, target = cont_ddpm.read_digits()
    assert images.dtype == want.images.dtype and images.shape == (1797, 8, 8)
    np.testing.assert_array_equal(images, want.images)
    assert target.dtype == want.target.dtype
    np.testing.assert_array_equal(target, want.target)


def test_records_reject_nan_and_head_with_the_device(tmp_path):
    logger = _evidence.JsonlLogger(str(tmp_path / "log.jsonl"), "cpu")
    logger.write(step=0, loss=1.5, absent=None)
    with pytest.raises(ValueError):
        logger.write(step=1, loss=float("nan"))
    lines = (tmp_path / "log.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in lines] == [
        {"device": "cpu"}, {"step": 0, "loss": 1.5, "absent": None}]
