"""Rank functions of the port's mesh tests (``tests/test_torch_mesh*.py``).

Each runs in a process of its own, started by
``torchsde_tpu_torch.parallel.mesh.run_ranks`` on the CPU (gloo): a spawned
process imports this module by name, so it imports torch, numpy and the
port, never JAX. The test process carries models across as ``torch.save``
bytes (:func:`pack`) and the JAX package's draws as numpy tables, which a
rank installs at the port's draw sites (its slice of the global draws, so
that the ranks together draw what one process draws)."""

import io
import warnings

import numpy as np
import torch

import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.models.cont_ddpm as TD
import torchsde_tpu_torch.models.latent_sde as TL
import torchsde_tpu_torch.models.sde_gan as TG
import torchsde_tpu_torch.models.unet as TU
import torchsde_tpu_torch.ops.latent_fused as TLF
from torchsde_tpu_torch.brownian.interval import BrownianInterval
from torchsde_tpu_torch.core.sdeint import sdeint
from torchsde_tpu_torch.models.layers import MLP, softplus
from torchsde_tpu_torch.parallel import mesh as PM
from torchsde_tpu_torch.parallel import replicas as RP


def pack(obj):
    """``obj`` (a module, a ``Replicas``, tensors) as the bytes of
    ``torch.save``, which a rank unpacks into a copy of its own."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def unpack(data):
    return torch.load(io.BytesIO(data), weights_only=False)


def _t(a):
    return torch.as_tensor(np.array(a))


def rows_of(n, mesh, axis_name="data"):
    """This rank's ``[lo, hi)`` of ``n`` rows split over ``axis_name``."""
    rows = PM.shard_batch(torch.arange(n), mesh, axis_name=axis_name)
    return int(rows[0]), int(rows[-1]) + 1


def _named(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def _update_recording(lr, store):
    """SGD by ``lr`` that keeps the averaged gradients it is given."""
    def update(grads, params):
        store.update({n: g.clone() for n, g in grads.items()})
        return {n: -lr * g for n, g in grads.items()}
    return update


def coords(mesh):
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


# --------------------------------------------------------------------------- #
#  Draws                                                                      #
# --------------------------------------------------------------------------- #

def install_latent_draws(eps, W):
    """The latent model's eps and its solve's W from tables (this rank's
    rows), as ``latent_sde_loss`` draws them: eps, then W."""
    def standard_normal(shape, generator, dtype, device):
        assert tuple(shape) == eps.shape, (shape, eps.shape)
        return _t(eps).to(dtype)

    def sample_grid_noise(generator, grid, size, dtype, device=None, **kw):
        assert tuple(size) == W.shape[1:], (size, W.shape)
        return _t(W).to(dtype), None, None

    TL._standard_normal = standard_normal
    TI.sample_grid_noise = sample_grid_noise


def install_replica_draws(gens, eps, W):
    """Replica k's eps and W from ``eps[k]``, ``W[k]``, keyed by the
    generator it was given (``gens[k]``)."""
    which = {id(g): k for k, g in enumerate(gens)}

    def standard_normal(shape, generator, dtype, device):
        return _t(eps[which[id(generator)]]).to(dtype)

    def sample_grid_noise(generator, grid, size, dtype, device=None, **kw):
        return _t(W[which[id(generator)]]).to(dtype), None, None

    TL._standard_normal = standard_normal
    TI.sample_grid_noise = sample_grid_noise


# --------------------------------------------------------------------------- #
#  tests/problems.py's NeuralDiagonal                                         #
# --------------------------------------------------------------------------- #

class _MLP(torch.nn.Module):
    def __init__(self, arrays, final_sigmoid):
        super().__init__()
        for name in ("w1", "b1", "w2", "b2"):
            setattr(self, name, torch.nn.Parameter(_t(arrays[name])))
        self.final_sigmoid = final_sigmoid

    def forward(self, x):
        out = softplus(x @ self.w1 + self.b1) @ self.w2 + self.b2
        return torch.sigmoid(out) if self.final_sigmoid else out


class NeuralDiagonal(torch.nn.Module):
    """``problems.NeuralDiagonal`` on the JAX problem's weights."""
    noise_type = "diagonal"

    def __init__(self, f_arrays, g_arrays, sde_type):
        super().__init__()
        self.sde_type = sde_type
        self.f_net = _MLP(f_arrays, False)
        self.g_net = _MLP(g_arrays, True)

    def _cat(self, t, y):
        return torch.cat([torch.as_tensor(t, dtype=y.dtype).expand(
            y.shape[0], 1), y], dim=1)

    def f(self, t, y):
        return self.f_net(self._cat(t, y))

    def g(self, t, y):
        return 0.1 * self.g_net(self._cat(t, y))


def solve_neural_diagonal(sde, y0, ts, bm):
    with torch.no_grad():
        return sdeint(sde, y0, ts, bm=bm, method="midpoint", dt=0.05)


def interval_16x3():
    return BrownianInterval(0.0, 0.4, (16, 3), dtype=torch.float64,
                            entropy=5, levels=8, device="cpu")


# --------------------------------------------------------------------------- #
#  Rank functions                                                             #
# --------------------------------------------------------------------------- #

# The port's draw sites that the rank functions replace with tables.
DRAW_SITES = ((TL, "_standard_normal"), (TI, "sample_grid_noise"),
              (TG, "_standard_normal"), (TD, "_uniform"),
              (TD, "_standard_normal"), (TU, "sinusoidal_embedding"))


def jobs(rank, world, calls):
    """Several rank functions of this module, one after another in one
    process group (a test file's cases share one start of the ranks), each
    finding the port's draw sites as they were: ``calls`` lists ``(name,
    args)``; returns each result in order."""
    out = []
    for name, args in calls:
        saved = [(module, attr, getattr(module, attr))
                 for module, attr in DRAW_SITES]
        try:
            out.append(globals()[name](rank, world, *args))
        finally:
            for module, attr, fn in saved:
                setattr(module, attr, fn)
    return out


def sharded_solve(rank, world, f_arrays, g_arrays, y0, ts):
    """``tests/test_parallel.py:25``: this rank's rows of a midpoint solve
    on its rows of one explicit interval."""
    mesh = PM.make_mesh(device="cpu")
    sde = PM.replicate(NeuralDiagonal(f_arrays, g_arrays, "stratonovich"),
                       mesh)
    ys = solve_neural_diagonal(sde, PM.shard_batch(_t(y0), mesh), ts,
                               PM.shard_batch(interval_16x3(), mesh))
    return dict(ys=ys, coords=coords(mesh))


def latent_step(rank, world, cfg):
    """One data-parallel (``n_model`` 1) or DP x TP SGD step of the latent
    ELBO on this rank's columns of the batch (axis 1 of xs), on its rows of
    the global eps and W. Returns the global loss, this rank's parameters
    after the step and the averaged gradients the update was given."""
    n_model = cfg.get("n_model", 1)
    if n_model == 1:
        mesh = PM.make_mesh(device="cpu")
        model = PM.replicate(unpack(cfg["model"]), mesh)
    else:
        mesh = PM.make_mesh_2d(n_model=n_model, device="cpu")
        model = PM.shard_latent_sde_tp(unpack(cfg["model"]), mesh)
    xs = PM.shard_batch(_t(cfg["xs"]), mesh, batch_axis=1)
    lo, hi = rows_of(cfg["xs"].shape[1], mesh)
    install_latent_draws(cfg["eps"][lo:hi], cfg["W"][:, lo:hi])
    ts, dt = cfg["ts"], cfg["dt"]

    def loss_fn(m, batch, generator):
        return TL.latent_sde_loss(m, batch, ts, generator, dt=dt,
                                  fused=cfg.get("fused", False))[0]

    grads = {}
    step = PM.data_parallel_train_step(
        loss_fn, mesh, optimizer_update=_update_recording(cfg["lr"], grads))
    model, loss = step(model, xs, None)
    return dict(loss=loss, params=_named(model), grads=grads,
                coords=coords(mesh), rows=(lo, hi),
                model_ranks=(torch.distributed.get_process_group_ranks(
                    mesh.get_group("model")) if n_model > 1 else None))


def fused_per_shard(rank, world, cfg):
    """``tests/test_parallel.py:211``: the fused solve (FusedLatentSolve, its
    plain version on the CPU) on this rank's rows. (a) with a shard-local
    generator from equal initial states on every rank; (b) on its rows of
    the global W."""
    mesh = PM.make_mesh(device="cpu")
    model = PM.replicate(unpack(cfg["model"]), mesh)
    ts, dt = cfg["ts"], cfg["dt"]
    ctx, z0 = _t(cfg["ctx"]), _t(cfg["z0"])
    gen = PM.shard_generator(7, mesh, device="cpu")
    view = model.contextualize(ts, ctx[:, :2].contiguous())
    with torch.no_grad():
        same = TLF.latent_logqp_solve_fused(view, z0[:2], ts, gen, dt)
    lo, hi = rows_of(z0.shape[0], mesh)
    install_latent_draws(None, cfg["W"][:, lo:hi])
    view = model.contextualize(ts, PM.shard_batch(ctx, mesh, batch_axis=1))
    TLF.launches = 0
    with torch.no_grad():
        zs, log_ratio = TLF.latent_logqp_solve_fused(
            view, PM.shard_batch(z0, mesh), ts, None, dt)
    return dict(same_start=same[0], zs=zs, log_ratio=log_ratio,
                rows=(lo, hi), launches=TLF.launches)


def gan_step(rank, world, cfg):
    """``tests/test_parallel.py:122``: one SGD step of the generator and the
    critic (the generator ascending) with the critic's clip, the real paths
    and the generator's draws split over the ranks."""
    mesh = PM.make_mesh(device="cpu")
    pair = PM.replicate(unpack(cfg["pair"]), mesh)
    paths = PM.shard_batch(_t(cfg["paths"]), mesh)
    lo, hi = rows_of(cfg["paths"].shape[0], mesh)
    init, W = cfg["init"][lo:hi], cfg["W"][:, lo:hi]
    B = hi - lo
    drawn = []

    def standard_normal(shape, generator, dtype, device):
        return _t(init).to(dtype)

    def sample_grid_noise(generator, grid, size, dtype, device=None, **kw):
        if tuple(size) == W.shape[1:]:
            drawn.append(size)
            return _t(W).to(dtype), None, None
        # the critic's own (rows, 1) noise: its diffusion is zero
        return torch.zeros((len(grid) - 1, *size), dtype=dtype), None, None

    TG._standard_normal = standard_normal
    TI.sample_grid_noise = sample_grid_noise
    ts, lr = cfg["ts"], cfg["lr"]

    def loss_fn(p, batch, generator):
        return TG.gan_loss(p["gen"], p["disc"], generator, ts, batch,
                           dt=1.0, adjoint=True)

    def update(grads, params):
        # The generator ascends the critic's score (gan_grads negates its
        # gradients), the critic descends.
        return {n: (lr if n.startswith("gen.") else -lr) * g
                for n, g in grads.items()}

    step = PM.data_parallel_train_step(loss_fn, mesh, optimizer_update=update)
    pair, loss = step(pair, paths, None)
    pair["disc"].clip_weights()
    assert len(drawn) == 2 and all(s == (B, W.shape[2]) for s in drawn)
    return dict(loss=loss, params=_named(pair))


def ddpm_step(rank, world, cfg):
    """``tests/test_parallel.py:76``: one SGD step of the mean
    score-matching loss with the images and their draws split over the
    ranks, the U-Net on the JAX package's time embedding (a table by
    row)."""
    mesh = PM.make_mesh(device="cpu")
    sde = PM.replicate(unpack(cfg["sde"]), mesh)
    x = PM.shard_batch(_t(cfg["x"]), mesh)
    lo, hi = rows_of(cfg["x"].shape[0], mesh)
    u, z, emb = cfg["u"][lo:hi], cfg["z"][lo:hi], cfg["emb"][lo:hi]
    TD._uniform = lambda shape, generator, dtype, device: _t(u).to(dtype)
    TD._standard_normal = lambda shape, generator, dtype, device: \
        _t(z).to(dtype)
    TU.sinusoidal_embedding = lambda t, dim: _t(emb)
    step = PM.data_parallel_train_step(
        lambda s, batch, g: torch.mean(s.loss(g, batch)), mesh,
        lr=cfg["lr"])
    sde, loss = step(sde, x, None)
    return dict(loss=loss, params=_named(sde))


def replicas_dp(rank, world, cfg):
    """``tests/test_parallel.py:326``: K replicas over the ``replica`` axis
    of a (replica, data) mesh, each data-parallel over its ``data`` group
    (gradients reduced only there), the K-replica fused solve (kernels 3
    and 4's plain versions) on each rank's replicas and rows."""
    K = cfg["K"]
    mesh = PM.make_mesh_2d(n_model=world // K,
                           axis_names=("replica", "data"), device="cpu")
    models = PM.shard_batch(unpack(cfg["models"]), mesh,
                            axis_name="replica")
    xs = PM.shard_batch(PM.shard_batch(_t(cfg["xs"]), mesh,
                                       axis_name="replica"),
                        mesh, batch_axis=2, axis_name="data")
    k_lo, k_hi = rows_of(K, mesh, "replica")
    lo, hi = rows_of(cfg["xs"].shape[2], mesh)
    gens = [torch.Generator() for _ in range(k_hi - k_lo)]
    install_replica_draws(gens, cfg["eps"][k_lo:k_hi, lo:hi],
                          cfg["W"][k_lo:k_hi, :, lo:hi])
    ts, dt = cfg["ts"], cfg["dt"]

    def loss_fn(m, batch, generators):
        return TL.latent_sde_loss_multi(m, batch, ts, generators, dt=dt,
                                        fused=True)[1]

    step = PM.data_parallel_train_step(loss_fn, mesh, lr=cfg["lr"])
    models, losses = step(models, xs, gens)
    return dict(losses=losses, replicas=(k_lo, k_hi), rows=(lo, hi),
                params={n: p.detach().clone()
                        for n, p in models.params.items()},
                data_ranks=torch.distributed.get_process_group_ranks(
                    mesh.get_group("data")))


def replicas_sharded(rank, world, cfg):
    """``tests/test_parallel.py:414``: K replicas over the ranks, each
    rank's trained by ``replica_train_step`` on the K-replica fused route
    with no collective."""
    mesh = PM.make_mesh(device="cpu")
    models = PM.shard_batch(unpack(cfg["models"]), mesh)
    K = cfg["K"]
    k_lo, k_hi = rows_of(K, mesh)
    gens = [torch.Generator() for _ in range(k_hi - k_lo)]
    install_replica_draws(gens, cfg["eps"][k_lo:k_hi], cfg["W"][k_lo:k_hi])
    ts, dt, xs = cfg["ts"], cfg["dt"], _t(cfg["xs"])

    def loss_fn(m, batch, generator):
        return TL.latent_sde_loss(m, batch, ts, generator, dt=dt,
                                  fused=True)[0]

    step = RP.replica_train_step(loss_fn, lr=cfg["lr"])
    models, losses = step(models, [xs] * len(gens), gens)
    return dict(losses=losses, replicas=(k_lo, k_hi),
                params={n: p.detach().clone()
                        for n, p in models.params.items()})


def tp_fallback(rank, world):
    """``tests/test_parallel.py:261``: the warnings of shard_mlp_tp on a
    width that does not divide and on one that does, on a 2 x 2 mesh, and
    the fallback's output against the whole MLP's."""
    mesh = PM.make_mesh_2d(n_model=2, device="cpu")
    out = {}
    for sizes in ((4, 5, 3), (4, 8, 4), (4, 5, 8, 4)):
        gen = torch.Generator().manual_seed(0)
        mlp = MLP(sizes, dtype=torch.float64, device="cpu", generator=gen)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            tp = PM.shard_mlp_tp(mlp, mesh)
        x = torch.linspace(-1.0, 1.0, 2 * sizes[0],
                           dtype=torch.float64).reshape(2, sizes[0])
        out[sizes] = dict(messages=[str(r.message) for r in rec],
                          kinds=[type(layer).__name__ for layer in tp.layers],
                          got=tp(x).detach(), want=mlp(x).detach())
    return out


def guards(rank, world, cfg):
    """The mesh's refusals, each message (None where nothing raised): a
    model axis that does not divide the ranks, a batch that does not
    divide the data axis, the fused route on a tensor-parallel model."""
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)

    attempt("n_model", lambda: PM.make_mesh_2d(n_model=3, device="cpu"))
    mesh = PM.make_mesh_2d(n_model=world, device="cpu")
    attempt("world", lambda: PM.make_mesh(world=world + 1, device="cpu"))
    flat = PM.make_mesh(device="cpu")
    attempt("batch", lambda: PM.shard_batch(torch.zeros(world + 1, 3), flat))
    model = PM.shard_latent_sde_tp(unpack(cfg["model"]), mesh)
    xs = _t(cfg["xs"])
    attempt("fused_tp", lambda: TL.latent_sde_loss(
        model, xs, cfg["ts"], torch.Generator(), dt=cfg["dt"], fused=True))
    return out
