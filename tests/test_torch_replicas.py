"""K stacked latent-SDE replicas: the port's kernels 3 and 4's plain
versions, ``FusedLatentSolveMulti``, ``latent_sde_loss_multi`` and
``parallel/replicas.py`` against torchsde_tpu.

JAX's random draws reach the port by replacing its two draw sites (the eps
draw and ``sample_grid_noise``), keyed by the generator each replica is
given. The CUDA kernels are held to the plain versions on the card
(chip_smoke.py, tests/test_torch_gpu.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu.ops.latent_fused as JLF
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.models.latent_sde as TL
import torchsde_tpu_torch.ops.latent_fused as TLF
from port_bridge import (jax_named_arrays, perturbed, port_latent_sde,
                         to_torch, unsplit_latent_backward)
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import latent_sde as JL
from torchsde_tpu_torch.parallel import replicas as RP

K, B, DATA, L, C, H, T = 3, 8, 3, 4, 8, 16, 6
DT = 1.0 / 32
TS = np.linspace(0.0, 1.0, T)
KEYS = jax.random.split(jax.random.PRNGKey(7), K)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


@functools.lru_cache(maxsize=None)
def _jax_models(name):
    """K stacked JAX LatentSDEs, every leaf moved off its initialisation."""
    jdtype = DTYPES[name][0]
    models = jax.vmap(lambda k: JL.LatentSDE(k, DATA, L, C, H, dtype=jdtype))(
        jax.random.split(jax.random.PRNGKey(0), K))
    return perturbed(models, seed=1)


def _replica(tree, k):
    return jax.tree_util.tree_map(lambda a: a[k], tree)


def _port_replicas(name):
    """The port's Replicas holding the JAX replicas' weights."""
    models = [port_latent_sde(_replica(_jax_models(name), k),
                              DTYPES[name][1]) for k in range(K)]
    return RP.stack_replicas(lambda m: m, models)


def _xs(name, per_replica=False):
    rng = np.random.default_rng(5)
    shape = (K, T, B, DATA) if per_replica else (T, B, DATA)
    return rng.standard_normal(shape).astype(np.dtype(DTYPES[name][0]))


def _inject_jax_draws(monkeypatch, name, gens):
    """Make replica k draw what JAX draws from KEYS[k]: eps from the key,
    then the grid noise from fold_in(key, 1), in that order."""
    jdtype = DTYPES[name][0]
    grid = JI.build_step_grid(TS[0], TS[-1], DT)
    which = {id(g): k for k, g in enumerate(gens)}
    eps = [jax.random.normal(KEYS[k], (B, L), jdtype) for k in range(K)]
    W = [JI.sample_grid_noise(jax.random.fold_in(KEYS[k], 1), grid,
                              (B, L + 1), jdtype)[0] for k in range(K)]
    order = {k: [] for k in range(K)}

    def standard_normal(shape, generator, dtype, device):
        k = which[id(generator)]
        assert tuple(shape) == (B, L) and order[k] == []
        order[k].append("eps")
        return to_torch(eps[k])

    def sample_grid_noise(generator, g, size, dtype, device=None, **kwargs):
        k = which[id(generator)]
        assert size == (B, L + 1) and np.array_equal(g, grid)
        assert order[k] == ["eps"]
        order[k].append("W")
        return to_torch(W[k]), None, None

    monkeypatch.setattr(TL, "_standard_normal", standard_normal)
    monkeypatch.setattr(TI, "sample_grid_noise", sample_grid_noise)
    return order


def _solve_inputs(rng, dtype):
    grid = JI.build_step_grid(0.0, 1.0, DT)
    n = len(grid) - 1
    g = grid.astype(dtype)
    z0 = rng.standard_normal((K, B, L)).astype(dtype)
    ctx = rng.standard_normal((K, T, B, C)).astype(dtype)
    idx = np.clip(np.searchsorted(TS.astype(dtype), g[:-1], side="left"),
                  0, T - 1).astype(np.int32)
    noise = (rng.standard_normal((K, n, B, L)) * np.sqrt(DT)).astype(dtype)
    return z0, ctx, idx, noise, g[1:] - g[:-1]


def _stacked_weights(replicas):
    return [replicas.params[name] for name in TLF.WEIGHT_PARAMS]


def test_multi_twins_match_the_pallas_multi_kernels_f32():
    """The plain versions of kernels 3 and 4 against the JAX package's
    _fused_solve_multi_fwd_impl and _bwd_impl (Pallas in interpret mode) on
    the same inputs, states and cotangents, at K = 3: the tolerances of the
    kernel 1 and 2 tests, atol 1e-5 forward and max(1e-4, 3e-5 * scale)
    going back (tests/test_fused_latent.py:73-79)."""
    jm = _jax_models("f32")
    weights = [w.detach() for w in _stacked_weights(_port_replicas("f32"))]
    rng = np.random.default_rng(6)
    z0, ctx, idx, noise, dts = _solve_inputs(rng, np.float32)
    n = noise.shape[1]
    gz = (0.1 * rng.standard_normal((K, n, B, L))).astype(np.float32)
    gq = (0.1 * rng.standard_normal((K, n, B, 1))).astype(np.float32)
    packed = jax.vmap(JLF.pack_weights)(jm)
    ctx_steps = jnp.asarray(ctx[:, idx])
    zs_j, qs_j = JLF._fused_solve_multi_fwd_impl(
        packed, jnp.asarray(z0), ctx_steps, jnp.asarray(noise),
        jnp.asarray(dts), interpret=True)
    args = [to_torch(a) for a in (z0, ctx, idx, noise, dts)]
    zs_t, qs_t = TLF.fused_solve_multi_forward_plain(*args, weights)
    assert float(np.max(np.abs(qs_j))) > 1e-2     # the KL channel is live
    np.testing.assert_allclose(zs_t.numpy(), np.asarray(zs_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(qs_t.numpy(), np.asarray(qs_j), rtol=0,
                               atol=1e-5)

    dpacked, dz0_j, dctx_steps, dnoise_j = JLF._fused_solve_multi_bwd_impl(
        packed, jnp.asarray(z0), ctx_steps, jnp.asarray(noise),
        jnp.asarray(dts), zs_j, jnp.asarray(gz), jnp.asarray(gq),
        interpret=True)
    dmodels = jax.vjp(jax.vmap(JLF.pack_weights), jm)[1](dpacked)[0]
    dz0, dctx, dnoise, dweights = TLF.fused_solve_multi_backward_plain(
        *args, weights, to_torch(zs_j), to_torch(gz), to_torch(gq))

    def close(got, want):
        scale = max(float(np.max(np.abs(w))) for w in want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=max(1e-4, 3e-5 * scale))

    for k in range(K):
        dctx_k = np.zeros_like(ctx[k])
        np.add.at(dctx_k, idx, np.asarray(dctx_steps[k]))
        close([dz0[k]], [np.asarray(dz0_j[k])])
        close([dctx[k]], [dctx_k])
        close([dnoise[k]], [np.asarray(dnoise_j[k])])
        want = jax_named_arrays(_replica(dmodels, k))
        for sl in (slice(0, 6), slice(6, 12), slice(12, 16)):
            close([d[k] for d in dweights[sl]],
                  [want[name] for name in TLF.WEIGHT_PARAMS[sl]])


def _random_multi(rng, dtype=torch.float64, K_=3, B_=5, L_=3, C_=4, H_=6,
                  T_=4, n_=7):
    def randn(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape), dtype=dtype)

    D = L_ + C_
    shapes = [(D, H_), (H_,), (H_, H_), (H_,), (H_, L_), (L_,),
              (L_, H_), (H_,), (H_, H_), (H_,), (H_, L_), (L_,),
              (L_, 1, H_), (L_, H_), (L_, H_, 1), (L_, 1)]
    weights = [randn(K_, *s, scale=0.4) for s in shapes]
    diff = [randn(K_, B_, L_), randn(K_, T_, B_, C_),
            randn(K_, n_, B_, L_, scale=0.3), *weights]
    idx = torch.as_tensor(np.sort(rng.integers(0, T_, n_)), dtype=torch.int32)
    dts = torch.as_tensor(rng.uniform(0.05, 0.2, n_), dtype=dtype)
    return diff, idx, dts


def test_multi_twins_are_the_single_twins_replica_by_replica():
    """Each replica of the multi plain versions is bitwise the single plain
    version on that replica's inputs."""
    rng = np.random.default_rng(8)
    (z0, ctx, noise, *weights), idx, dts = _random_multi(rng)
    zs, qs = TLF.fused_solve_multi_forward_plain(z0, ctx, idx, noise, dts,
                                                 weights)
    gz = torch.as_tensor(rng.standard_normal(zs.shape))
    gq = torch.as_tensor(rng.standard_normal(qs.shape))
    back = TLF.fused_solve_multi_backward_plain(z0, ctx, idx, noise, dts,
                                                weights, zs, gz, gq)
    for k in range(z0.shape[0]):
        w_k = [w[k] for w in weights]
        one = TLF.fused_solve_forward_plain(z0[k], ctx[k], idx, noise[k],
                                            dts, w_k)
        assert torch.equal(one[0], zs[k]) and torch.equal(one[1], qs[k])
        one_b = TLF.fused_solve_backward_plain(z0[k], ctx[k], idx, noise[k],
                                               dts, w_k, zs[k], gz[k], gq[k])
        for a, b in zip((*one_b[:3], *one_b[3]),
                        (*back[:3], *back[3])):
            assert torch.equal(a, b[k])


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("K_", [1, 3])
def test_multi_split_twin_matches_the_unsplit_backward_f64(K_, saturated):
    """Kernel 4's plain version, the plain sweep composed with the plain
    contraction on each replica, against the unsplit step-by-step loop on
    that replica's inputs: 1e-12 of each tensor's scale in float64; and each
    replica's contraction is torch.einsum over its scratch."""
    rng = np.random.default_rng(20 + K_)
    (z0, ctx, noise, *weights), idx, dts = _random_multi(rng, K_=K_)
    if saturated:
        weights[15] = weights[15] - 25.0
    zs, qs = TLF.fused_solve_multi_forward_plain(z0, ctx, idx, noise, dts,
                                                 weights)
    gz = torch.as_tensor(rng.standard_normal(zs.shape))
    gq = torch.as_tensor(rng.standard_normal(qs.shape))
    back = TLF.fused_solve_multi_backward_plain(z0, ctx, idx, noise, dts,
                                                weights, zs, gz, gq)
    for k in range(K_):
        w_k = [w[k] for w in weights]
        args = (z0[k], ctx[k], idx, noise[k], dts, w_k, zs[k], gz[k], gq[k])
        want = unsplit_latent_backward(*args)
        for g, w in zip((*back[:3], *back[3]), (*want[:3], *want[3])):
            torch.testing.assert_close(
                g[k], w, rtol=0, atol=1e-12 * max(1.0, float(w.abs().max())))
        scratch = TLF.fused_solve_backward_sweep_plain(*args)[4]
        a1f, a2h, dpre2f, dh = (scratch[TLF.SCRATCH_NAMES.index(name)]
                                for name in ("a1f", "a2h", "dpre2f", "dh"))
        got = TLF.fused_solve_backward_contract_plain(z0[k], ctx[k], idx,
                                                      zs[k], scratch)
        torch.testing.assert_close(
            got[2], torch.einsum("sbi,sbj->ij", a1f, dpre2f), rtol=0,
            atol=1e-12 * float(got[2].abs().max()))
        torch.testing.assert_close(
            got[10], torch.einsum("sbi,sbj->ij", a2h, dh), rtol=0,
            atol=1e-12 * float(got[10].abs().max()))


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("window", [1, 2, None], ids=["w1", "w2", "all"])
@pytest.mark.parametrize("K_", [1, 3])
def test_multi_windowed_twin_matches_the_unsplit_backward_f64(K_, window,
                                                               saturated):
    """Kernel 4's plain version swept in windows of 1, 2 and all steps
    (each replica's windows in turn, the chain carried between them, as
    the kernel sweeps them with one window for every K): each replica
    within 1e-12 of its scale of the unsplit step-by-step loop on its own
    inputs (float64), and bitwise the single plain version in the same
    windows."""
    rng = np.random.default_rng(30 + K_)
    (z0, ctx, noise, *weights), idx, dts = _random_multi(rng, K_=K_)
    if saturated:
        weights[15] = weights[15] - 25.0
    zs, qs = TLF.fused_solve_multi_forward_plain(z0, ctx, idx, noise, dts,
                                                 weights)
    gz = torch.as_tensor(rng.standard_normal(zs.shape))
    gq = torch.as_tensor(rng.standard_normal(qs.shape))
    back = TLF.fused_solve_multi_backward_plain(z0, ctx, idx, noise, dts,
                                                weights, zs, gz, gq,
                                                window=window)
    for k in range(K_):
        args = (z0[k], ctx[k], idx, noise[k], dts, [w[k] for w in weights],
                zs[k], gz[k], gq[k])
        want = unsplit_latent_backward(*args)
        one = TLF.fused_solve_backward_plain(*args, window=window)
        for g, w, o in zip((*back[:3], *back[3]), (*want[:3], *want[3]),
                           (*one[:3], *one[3])):
            torch.testing.assert_close(
                g[k], w, rtol=0, atol=1e-12 * max(1.0, float(w.abs().max())))
            assert torch.equal(g[k], o)


def test_multi_function_gradients_match_autograd_f64():
    """FusedLatentSolveMulti's backward (the plain multi sweep on the CPU)
    against autograd through the plain multi forward: rounding only."""
    rng = np.random.default_rng(9)
    diff, idx, dts = _random_multi(rng)
    for t in diff:
        t.requires_grad_(True)
    z0, ctx, noise, *weights = diff
    zs, qs = TLF.fused_solve_multi_forward_plain(z0, ctx, idx, noise, dts,
                                                 weights)
    gz = torch.as_tensor(rng.standard_normal(zs.shape))
    gq = torch.as_tensor(rng.standard_normal(qs.shape))
    want = torch.autograd.grad((zs * gz).sum() + (qs * gq).sum(), diff)
    zs_f, qs_f = TLF.FusedLatentSolveMulti.apply(z0, ctx, idx, noise, dts,
                                                 *weights)
    assert torch.equal(zs_f, zs) and torch.equal(qs_f, qs)
    got = torch.autograd.grad((zs_f * gz).sum() + (qs_f * gq).sum(), diff)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-12 * float(w.abs().max()))


@functools.lru_cache(maxsize=None)
def _jax_multi_loss_and_grads(name, fused):
    (total, losses), grads = jax.value_and_grad(
        lambda m: JL.latent_sde_loss_multi(m, jnp.asarray(_xs(name)), TS,
                                           KEYS, dt=DT, fused=fused),
        has_aux=True)(_jax_models(name))
    return float(total), np.asarray(losses), grads


@pytest.mark.parametrize("fused", [False, True])
def test_multi_loss_and_gradients_match_jax_f64(monkeypatch, fused):
    """latent_sde_loss_multi on both routes against the JAX package's in
    float64 on the same draws: each replica's loss and every replica's
    parameter gradients within 1e-9 (of each gradient's largest entry).
    The JAX reference is its fused=False route: its multi kernels
    accumulate weight gradients in float32 and do not run in float64, and
    both JAX routes compute the same function (the port's fused route is
    held to its Pallas kernels in float32 below)."""
    want_total, want, want_grads = _jax_multi_loss_and_grads("f64", False)
    gens = [torch.Generator() for _ in range(K)]
    order = _inject_jax_draws(monkeypatch, "f64", gens)
    models = _port_replicas("f64")
    total, losses = TL.latent_sde_loss_multi(
        models, to_torch(_xs("f64")), TS, gens, dt=DT, fused=fused)
    assert all(o == ["eps", "W"] for o in order.values())
    np.testing.assert_allclose(losses.detach().numpy(), want, rtol=1e-9)
    np.testing.assert_allclose(float(total.detach()), want_total, rtol=1e-9)
    total.backward()
    for k in range(K):
        ref = jax_named_arrays(_replica(want_grads, k))
        for name, p in models.named_parameters():
            scale = float(np.max(np.abs(ref[name])))
            assert scale > 0, name
            np.testing.assert_allclose(p.grad[k].numpy(), ref[name], rtol=0,
                                       atol=1e-9 * scale,
                                       err_msg=f"{name}[{k}]")


def test_fused_multi_matches_jax_pallas_f32(monkeypatch):
    """The fused route in float32 against the JAX package's fused=True
    route, whose K solves run in its multi Pallas kernels (interpret
    mode): losses rtol 1e-4 (as the single fused loss's test), parameter
    gradients max(1e-4, 1e-4 * scale): the two sum in other orders through
    the encoder, the solve and its hand-derived sweep, in float32."""
    monkeypatch.setattr(JLF, "_INTERPRET", True)
    _, want, want_grads = _jax_multi_loss_and_grads("f32", True)
    gens = [torch.Generator() for _ in range(K)]
    _inject_jax_draws(monkeypatch, "f32", gens)
    models = _port_replicas("f32")
    total, losses = TL.latent_sde_loss_multi(
        models, to_torch(_xs("f32")), TS, gens, dt=DT, fused=True)
    np.testing.assert_allclose(losses.detach().numpy(), want, rtol=1e-4)
    total.backward()
    for k in range(K):
        ref = jax_named_arrays(_replica(want_grads, k))
        for name, p in models.named_parameters():
            scale = float(np.max(np.abs(ref[name])))
            np.testing.assert_allclose(p.grad[k].numpy(), ref[name], rtol=0,
                                       atol=max(1e-4, 1e-4 * scale),
                                       err_msg=f"{name}[{k}]")


@pytest.mark.parametrize("fused", [False, True])
def test_per_replica_xs_and_routes_match_single_losses(fused):
    """Per-replica data (K, T, B, D): replica k's loss equals the single
    latent_sde_loss(fused=True) of its model on xs[k] and a clone of its
    generator (the draws follow the single loss's order), on both routes."""
    models = _port_replicas("f64")
    xs = to_torch(_xs("f64", per_replica=True))
    gens = [torch.Generator().manual_seed(30 + k) for k in range(K)]
    clones = [torch.Generator().manual_seed(30 + k) for k in range(K)]
    with torch.no_grad():
        _, losses = TL.latent_sde_loss_multi(models, xs, TS, gens, dt=DT,
                                             fused=fused)
        for k in range(K):
            want, _ = TL.latent_sde_loss(RP.unstack_replica(models, k), xs[k],
                                         TS, clones[k], dt=DT, fused=True)
            np.testing.assert_allclose(float(losses[k]), float(want),
                                       rtol=1e-9)
    assert len({float(v) for v in losses}) == K


def test_generator_count_and_architecture_are_checked():
    models = _port_replicas("f32")
    xs = to_torch(_xs("f32"))
    with pytest.raises(ValueError, match="generators"):
        TL.latent_sde_loss_multi(models, xs, TS, [torch.Generator()], dt=DT,
                                 fused=True)
    models.module.f_net.activation = "tanh"
    with pytest.raises(ValueError, match="3-layer softplus"):
        TL.latent_sde_loss_multi(models, xs, TS,
                                 [torch.Generator() for _ in range(K)],
                                 dt=DT, fused=True)


def _multi_port_inputs():
    rng = np.random.default_rng(4)
    z0, ctx, idx, noise, dts = _solve_inputs(rng, np.float32)
    weights = [w.detach() for w in _stacked_weights(_port_replicas("f32"))]
    return [to_torch(a) for a in (z0, ctx, idx, noise, dts)], weights


@pytest.mark.parametrize("fault", ["single_z0", "weight_without_k",
                                   "k_mismatch", "int64_idx", "f64_ctx",
                                   "replica_dts", "gq_width"])
def test_multi_input_checks(fault):
    args, weights = _multi_port_inputs()
    n = args[3].shape[1]
    zs = torch.zeros((K, n, B, L))
    back = [zs, zs.clone(), torch.zeros((K, n, B, 1))]
    assert TLF.check_multi_inputs(*args, weights, *back)[0] == K
    z0, ctx, idx, noise, dts = args
    weights = list(weights)
    if fault == "single_z0":
        z0 = z0[0]
    elif fault == "weight_without_k":
        weights[3] = weights[3][0]
    elif fault == "k_mismatch":
        noise = noise[:-1]
    elif fault == "int64_idx":
        idx = idx.long()
    elif fault == "f64_ctx":
        ctx = ctx.double()
    elif fault == "replica_dts":
        dts = dts.expand(K, -1)
    elif fault == "gq_width":
        back[2] = torch.zeros((K, n, B, L))
    with pytest.raises(ValueError):
        TLF.check_multi_inputs(z0, ctx, idx, noise, dts, weights, *back)


def test_multi_cpu_takes_the_plain_version_and_other_devices_raise():
    args, weights = _multi_port_inputs()
    before = (TLF.multi_launches, TLF.multi_bwd_launches)
    got = TLF.FusedLatentSolveMulti.apply(*args, *weights)
    want = TLF.fused_solve_multi_forward_plain(*args, weights)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (TLF.multi_launches, TLF.multi_bwd_launches) == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no fused latent solve"):
        TLF.FusedLatentSolveMulti.apply(*meta, *weights)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TLF.fused_solve_multi_forward_cuda(*args, weights)
    zs = torch.zeros_like(args[3])
    with pytest.raises(ValueError, match="CUDA tensors"):
        TLF.fused_solve_multi_backward_cuda(*args, weights, zs, zs,
                                            zs[..., :1])


# --------------------------------------------------------------------------- #
#  parallel/replicas.py (tests/test_parallel.py:283-324 of the JAX package)   #
# --------------------------------------------------------------------------- #

RT, RB, RDT = 4, 8, 0.25


def _make(seed):
    return TL.LatentSDE(DATA, 2, 8, 16, dtype=torch.float64, device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def _loss_fn(model, batch, generator):
    ts = np.linspace(0.0, 1.0, RT)
    return TL.latent_sde_loss(model, batch, ts, generator, dt=RDT)[0]


def _batch():
    return torch.as_tensor(np.random.default_rng(3).standard_normal(
        (RT, RB, DATA)))


def test_stack_and_unstack_replicas():
    models = RP.stack_replicas(_make, [10, 11, 12])
    assert len(models) == 3 and models.module.f_net.layers[0].w.is_meta
    for k, seed in enumerate((10, 11, 12)):
        ref = _make(seed)
        got = RP.unstack_replica(models, k)
        for (n1, a), (n2, b) in zip(got.named_parameters(),
                                    ref.named_parameters()):
            assert n1 == n2 and torch.equal(a, b)
            assert torch.equal(models.params[n1][k], b)


def test_replica_train_step_matches_independent_sgd():
    """K = 3 replicas trained in one step function equal the same three
    trained one by one with SGD, loss and parameters, over two steps."""
    seeds = (20, 21, 22)
    models = RP.stack_replicas(_make, seeds)
    batches = _batch().expand(3, -1, -1, -1)
    step = RP.replica_train_step(_loss_fn, lr=1e-6)
    for i in range(2):
        models, losses = step(models, batches,
                              [torch.Generator().manual_seed(40 + i + 10 * k)
                               for k in range(3)])
        assert losses.shape == (3,) and not losses.requires_grad
    for k, seed in enumerate(seeds):
        m = _make(seed)
        for i in range(2):
            loss = _loss_fn(m, _batch(),
                            torch.Generator().manual_seed(40 + i + 10 * k))
            grads = torch.autograd.grad(loss, list(m.parameters()))
            with torch.no_grad():
                for p, g in zip(m.parameters(), grads):
                    p += -1e-6 * g
        if k == 2:
            np.testing.assert_allclose(float(losses[k]), float(loss.detach()),
                                       rtol=1e-12)
        for name, p in m.named_parameters():
            torch.testing.assert_close(models.params[name][k], p, rtol=1e-12,
                                       atol=1e-14)


def test_replica_train_step_optimizer_update_is_per_replica():
    """optimizer_update is called once a replica with that replica's
    gradients and parameters; lr and optimizer_update exclude each other."""
    calls = []

    def update(grads, params):
        calls.append(set(grads) == set(params))
        return {n: -0.5e-3 * g for n, g in grads.items()}

    a = RP.stack_replicas(_make, (30, 31))
    b = RP.stack_replicas(_make, (30, 31))
    gens = lambda: [torch.Generator().manual_seed(s) for s in (1, 2)]  # noqa
    batches = _batch().expand(2, -1, -1, -1)
    RP.replica_train_step(_loss_fn, optimizer_update=update)(a, batches,
                                                             gens())
    RP.replica_train_step(_loss_fn, lr=0.5e-3)(b, batches, gens())
    assert calls == [True, True]
    for name in a.params:
        torch.testing.assert_close(a.params[name], b.params[name], rtol=0,
                                   atol=0)
    for kwargs in ({}, dict(lr=1e-3, optimizer_update=update)):
        with pytest.raises(ValueError, match="exactly one"):
            RP.replica_train_step(_loss_fn, **kwargs)


def test_one_adam_over_stacked_replicas_is_k_adams():
    """Adam over the stacked leaves moves each replica as its own Adam
    would (the update is elementwise): two steps of the fused multi loss
    against K models stepping with latent_sde_loss(fused=True)."""
    seeds = (50, 51, 52)
    models = RP.stack_replicas(_make, seeds)
    opt = torch.optim.Adam(models.parameters(), lr=1e-2)
    singles = [_make(s) for s in seeds]
    opts = [torch.optim.Adam(m.parameters(), lr=1e-2) for m in singles]
    ts = np.linspace(0.0, 1.0, RT)
    for i in range(2):
        opt.zero_grad()
        total, _ = TL.latent_sde_loss_multi(
            models, _batch(), ts,
            [torch.Generator().manual_seed(60 + i + 10 * k)
             for k in range(3)], dt=RDT, fused=True)
        total.backward()
        opt.step()
        for k, (m, o) in enumerate(zip(singles, opts)):
            o.zero_grad()
            loss, _ = TL.latent_sde_loss(
                m, _batch(), ts, torch.Generator().manual_seed(60 + i + 10 * k),
                dt=RDT, fused=True)
            loss.backward()
            o.step()
    for k, m in enumerate(singles):
        for name, p in m.named_parameters():
            torch.testing.assert_close(models.params[name][k], p, rtol=1e-10,
                                       atol=1e-12)


def test_replica_groups_bound_kernel_4s_total_workspace(monkeypatch):
    """Kernel 4 launches its replicas in groups whose workspaces together
    stay within MULTI_WORKSPACE_BYTES: the flagship (batch 1024, latent 4,
    context 64, hidden 128) at K 4 is one group (4 x 588.4 MB); K 16 at dt
    1/512 (512 steps, 2,143.6 MB a replica) goes in groups of four; a group
    never has fewer than one replica, nor more than K."""
    flagship = (1024, 4, 64, 128)
    assert TLF.replica_group(4, *flagship, 128) == 4
    assert TLF.replica_group(1, *flagship, 128) == 1
    window = TLF.bwd_window(*flagship, 512)
    each = 4 * TLF.workspace_floats(*flagship, window)
    assert 2143e6 < each < 2144e6
    group = TLF.replica_group(16, *flagship, 512)
    assert group == 4
    assert group * each <= TLF.MULTI_WORKSPACE_BYTES < (group + 1) * each
    monkeypatch.setattr(TLF, "MULTI_WORKSPACE_BYTES", each - 1)
    assert TLF.replica_group(16, *flagship, 512) == 1
