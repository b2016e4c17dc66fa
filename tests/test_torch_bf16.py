"""The port's bf16 mixed mode of the latent path against torchsde_tpu.

Mixed mode (the JAX package's ``_prep_solve`` rule: the state is float32
where the weights are bf16) runs the fused latent solve with bf16 weights,
context, noise and states zs, and float32 z0, carry, KL channel and sums.
On the CPU ``FusedLatentSolve`` runs the plain versions of kernels 1-4,
which these tests hold to the JAX package's Pallas kernels in interpret
mode, to the port's own ``sdeint`` route in bf16 (the JAX test's bars), to
autograd through the forward, and replica by replica to the single solve.
The JAX package's own bf16 tests (``tests/test_mixed_precision.py``) have
their counterparts here. JAX's draws are made on the JAX side and handed to
the port by replacing its two draw sites, as in
``tests/test_torch_latent_sde.py``."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu as jtsde
import torchsde_tpu.ops.latent_fused as JLF
import torchsde_tpu_torch as ttsde
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.models.latent_sde as TL
import torchsde_tpu_torch.ops.latent_fused as TLF
from port_bridge import jax_named_arrays, port_latent_sde, to_torch
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import latent_sde as JL
from torchsde_tpu_torch.parallel.replicas import stack_replicas

BF16 = torch.bfloat16
KEY = jax.random.PRNGKey(0)
# tests/test_fused_latent.py::test_bf16_mixed_mode_matches_xla_bf16: data 3,
# latent 4, context 16, hidden 32, batch 8, 4 times on [0, 1], dt 0.25.
DIMS, B, TS, DT = (3, 4, 16, 32), 8, np.linspace(0.0, 1.0, 4), 0.25
# Its bars for the fused route against the sdeint route at the same bf16
# weights: the loss within 5e-3 relative, the cosine of all parameter
# gradients above 0.999.
ROUTE_LOSS_RTOL, ROUTE_COS = 5e-3, 0.999
# The port's fused loss against the JAX package's fused (Pallas) loss. The
# solves agree to the bit (test_fused_solve_matches_jax_pallas); the rest
# of the loss runs in bf16 (the GRU encoder, qz0_net, the KL at t0), where
# XLA fuses operations that eager PyTorch rounds one by one, and at
# noise_std 0.01 the loss weighs a state's error by 1e4: measured 3.5e-4
# relative, so 2e-3. Each gradient within 2^-5 of its largest entry
# (measured at most 1.9e-2, 3 bf16 ulps at that scale, encoder.cell.w_ih,
# from the encoder's rounding; the solve's weights' at most 6.5e-3), the
# cosine of all above 0.9999 (measured 0.999993).
JAX_LOSS_RTOL, JAX_GRAD_REL, JAX_COS = 2e-3, 2 ** -5, 0.9999


def _cos(a, b):
    num = sum(float((a[n].double() * b[n].double()).sum()) for n in a)
    na = math.sqrt(sum(float((a[n].double() ** 2).sum()) for n in a))
    nb = math.sqrt(sum(float((b[n].double() ** 2).sum()) for n in b))
    return num / (na * nb)


def _inject_jax_draws(monkeypatch, key, eps_shape, grid, channels):
    """The port draws eps from ``key`` and the grid noise from fold_in(key,
    1), in bf16, as the JAX package does."""
    eps = to_torch(jax.random.normal(key, eps_shape, jnp.bfloat16))
    W = to_torch(JI.sample_grid_noise(jax.random.fold_in(key, 1), grid,
                                      (eps_shape[0], channels),
                                      jnp.bfloat16)[0])
    monkeypatch.setattr(TL, "_standard_normal", lambda *a, **k: eps)
    monkeypatch.setattr(TI, "sample_grid_noise",
                        lambda *a, **k: (W, None, None))


@functools.lru_cache(maxsize=None)
def _jax_model():
    return JL.LatentSDE(KEY, *DIMS, dtype=jnp.bfloat16)


def _xs():
    return jnp.asarray(jax.random.normal(jax.random.fold_in(KEY, 9),
                                         (len(TS), B, DIMS[0])),
                       jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _jax_fused_loss():
    """The JAX package's fused loss and gradients, its kernels interpreted
    (float32 loss, bf16 gradients)."""
    old, JLF._INTERPRET = JLF._INTERPRET, True
    try:
        (loss, _), grads = jax.value_and_grad(
            lambda m: JL.latent_sde_loss(m, _xs(), TS, KEY, dt=DT,
                                         fused=True), has_aux=True)(
            _jax_model())
    finally:
        JLF._INTERPRET = old
    return loss, jax_named_arrays(grads)


def _port_loss(monkeypatch, fused):
    grid = JI.build_step_grid(TS[0], TS[-1], DT)
    _inject_jax_draws(monkeypatch, KEY, (B, DIMS[1]), grid, DIMS[1] + 1)
    model = port_latent_sde(_jax_model(), BF16)
    loss, _ = TL.latent_sde_loss(model, to_torch(_xs()), TS, dt=DT,
                                 fused=fused)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_fused_route_matches_the_sdeint_route(monkeypatch):
    """The counterpart of the JAX package's
    test_bf16_mixed_mode_matches_xla_bf16: the fused route (float32 loss,
    mixed mode) against the sdeint route (entirely bf16) on the same draws,
    on that test's bars; every gradient in bf16."""
    fused, g_fused = _port_loss(monkeypatch, True)
    ref, g_ref = _port_loss(monkeypatch, False)
    assert fused.dtype == torch.float32 and ref.dtype == BF16
    assert all(g.dtype == BF16 for g in g_fused.values())
    assert abs(float(fused) - float(ref)) / abs(float(ref)) < ROUTE_LOSS_RTOL
    assert _cos(g_fused, g_ref) > ROUTE_COS


def test_fused_route_matches_jax_pallas(monkeypatch):
    """The port's fused loss (float32) and every parameter gradient (bf16)
    against the JAX package's fused route in interpret mode, on the same
    weights and draws."""
    want, want_grads = _jax_fused_loss()
    got, grads = _port_loss(monkeypatch, True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert abs(float(got) - float(want)) / abs(float(want)) < JAX_LOSS_RTOL
    assert len(grads) == 28 and set(grads) <= set(want_grads)
    want_t = {n: torch.as_tensor(np.asarray(want_grads[n], np.float64))
              for n in grads}
    for name, g in grads.items():
        assert g.dtype == BF16, name
        scale = float(want_t[name].abs().max())
        err = float((g.double() - want_t[name]).abs().max())
        assert err <= JAX_GRAD_REL * scale, (name, err, scale)
    assert _cos(grads, want_t) > JAX_COS


# A solve alone, its context and z0 given: batch 16, latent 4, context 16,
# hidden 32, 6 times at dt 1/32 (32 steps).
SOLVE_DIMS, SOLVE_B, SOLVE_TS, SOLVE_DT = (3, 4, 16, 32), 16, \
    np.linspace(0.0, 1.0, 6), 1.0 / 32
# The states zs come out of both in bf16 and agree to the bit (measured);
# the KL increments within 3e-4 of their scale (u = (f - h) / g divides
# float32 sums taken in another order by g; measured 1.25e-4);
# every gradient within 2^-7 (two bf16 ulps) of its largest entry: each is
# a float32 sum over rows and steps in another order, rounded to bf16 once
# (measured at most 4.0e-3 of scale, f_net.layers.1.w).
SOLVE_KL_REL, SOLVE_GRAD_REL = 3e-4, 2 ** -7


def test_fused_solve_matches_jax_pallas(monkeypatch):
    """latent_logqp_solve_fused in mixed mode (bf16 model, context and z0)
    against the JAX package's, its kernels interpreted: the states zs on
    ts, the KL increments, and the gradients of sum(zs^2) + sum(kl) to
    every solve weight, the context and z0."""
    L, C = SOLVE_DIMS[1], SOLVE_DIMS[2]
    rng = np.random.default_rng(0)
    ctx = jnp.asarray(rng.standard_normal((len(SOLVE_TS), SOLVE_B, C)),
                      jnp.bfloat16)
    z0 = jnp.asarray(rng.standard_normal((SOLVE_B, L)), jnp.bfloat16)
    model = JL.LatentSDE(KEY, *SOLVE_DIMS, dtype=jnp.bfloat16)
    nkey = jax.random.fold_in(KEY, 1)
    grid = JI.build_step_grid(SOLVE_TS[0], SOLVE_TS[-1], SOLVE_DT)

    def jax_loss(m, ctx, z0):
        zs, kl = JLF.latent_logqp_solve_fused(
            m.contextualize(SOLVE_TS, ctx), z0, SOLVE_TS, nkey, SOLVE_DT)
        return jnp.sum(zs ** 2) + jnp.sum(kl), (zs, kl)

    monkeypatch.setattr(JLF, "_INTERPRET", True)
    (_, (zs_j, kl_j)), grads_j = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(model, ctx, z0)
    W = to_torch(JI.sample_grid_noise(nkey, grid, (SOLVE_B, L + 1),
                                      jnp.bfloat16)[0])
    monkeypatch.setattr(TI, "sample_grid_noise",
                        lambda *a, **k: (W, None, None))
    port = port_latent_sde(model, BF16)
    ctx_t = to_torch(ctx).requires_grad_()
    z0_t = to_torch(z0).requires_grad_()
    zs, kl = TLF.latent_logqp_solve_fused(
        port.contextualize(SOLVE_TS, ctx_t), z0_t, SOLVE_TS, None, SOLVE_DT)
    ((zs ** 2).sum() + kl.sum()).backward()

    assert zs.dtype == kl.dtype == torch.float32
    np.testing.assert_array_equal(zs.detach().numpy(), np.asarray(zs_j))
    kl_j = np.asarray(kl_j)
    np.testing.assert_allclose(kl.detach().numpy(), kl_j, rtol=0,
                               atol=SOLVE_KL_REL * np.abs(kl_j).max())
    want = jax_named_arrays(grads_j[0])
    got = {n: p.grad for n, p in port.named_parameters()
           if n in TLF.WEIGHT_PARAMS}
    got.update(ctx=ctx_t.grad, z0=z0_t.grad)
    want.update(ctx=np.asarray(grads_j[1]), z0=np.asarray(grads_j[2]))
    assert len(got) == len(TLF.WEIGHT_PARAMS) + 2
    for name, g in got.items():
        assert g.dtype == BF16, name
        w = np.asarray(want[name], np.float64)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=SOLVE_GRAD_REL * scale, err_msg=name)


# ``tests/test_mixed_precision.py`` of the JAX package, ported.

class DiagSDE(torch.nn.Module):
    noise_type, sde_type = "diagonal", "ito"

    def __init__(self, dtype):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones((4, 4), dtype=dtype) * 0.1)

    def f(self, t, y):
        return torch.tanh(y @ self.w)

    def g(self, t, y):
        return 0.1 * torch.sigmoid(y)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_solve_and_adjoint_dtype(dtype):
    """bf16 and float32 flow through sdeint and sdeint_adjoint with no
    drift of dtype in the carries, finite, the gradient in the weight's
    dtype."""
    sde = DiagSDE(dtype)
    y0 = torch.full((8, 4), 0.1, dtype=dtype)
    ts = [0.0, 0.1, 0.2]
    ys = ttsde.sdeint(sde, y0, ts, method="euler", dt=0.05,
                      generator=torch.Generator().manual_seed(0))
    assert ys.dtype == dtype
    assert torch.isfinite(ys.float()).all()
    loss = ttsde.sdeint_adjoint(
        sde, y0, ts, method="euler", dt=0.05, adjoint_method="euler",
        generator=torch.Generator().manual_seed(0))[-1].float().sum()
    loss.backward()
    assert sde.w.grad.dtype == dtype
    assert torch.isfinite(sde.w.grad.float()).all()


@pytest.mark.parametrize("fused", [False, True])
def test_latent_model_bf16_step(fused):
    """The JAX package's test_latent_model_bf16_step (a bf16 LatentSDE,
    data 3, latent 2, context 4, hidden 8, ts = linspace(0, 0.2, 4) at dt
    0.1, whose last output time ends a float32 hair past the step grid) on
    both routes: the loss finite, the projector's gradient bf16."""
    gen = torch.Generator().manual_seed(0)
    ts = torch.linspace(0.0, 0.2, 4)
    xs = torch.randn((4, 8, 3), generator=gen).to(BF16)
    model = TL.LatentSDE(3, 2, 4, 8, dtype=BF16, device="cpu", generator=gen)
    loss, _ = TL.latent_sde_loss(model, xs, ts, gen, dt=0.1, fused=fused)
    loss.float().backward()
    assert torch.isfinite(loss.float())
    assert model.projector.w.grad.dtype == BF16
    assert all(torch.isfinite(p.grad.float()).all()
               for p in model.parameters() if p.grad is not None)


def _mixed_inputs(seed, K=None, B=6, L=3, C=5, H=8, T=4, n=9):
    """Seeded mixed-mode solve inputs and cotangents: z0, dts and gq
    float32, the rest bf16; a leading K on the per-replica ones."""
    gen = torch.Generator().manual_seed(seed)
    lead = () if K is None else (K,)

    def rand(*shape, scale=1.0, dtype=BF16):
        return (scale * torch.randn(lead + shape, generator=gen)).to(dtype)

    weights = [rand(*s, scale=0.4) for s in (
        (L + C, H), (H,), (H, H), (H,), (H, L), (L,),
        (L, H), (H,), (H, H), (H,), (H, L), (L,),
        (L, 1, H), (L, H), (L, H, 1), (L, 1))]
    args = (rand(B, L, dtype=torch.float32), rand(T, B, C),
            torch.randint(0, T, (n,), generator=gen, dtype=torch.int32),
            rand(n, B, L, scale=0.2),
            torch.full((n,), 1.0 / n, dtype=torch.float32))
    cot = (rand(n, B, L), rand(n, B, 1, dtype=torch.float32))
    return args, weights, cot


def test_twins_keep_the_mixed_mode_dtypes():
    """The plain forward gives zs in bf16 and qs in float32, the plain
    backward each gradient in its input's dtype; the kernels' input check
    takes this set and refuses a set that mixes the modes."""
    args, weights, (gz, gq) = _mixed_inputs(1)
    TLF.check_kernel_inputs(*args, weights)
    zs, qs = TLF.fused_solve_forward_plain(*args, weights)
    assert zs.dtype == BF16 and qs.dtype == torch.float32
    TLF.check_backward_inputs(*args, weights, zs, gz, gq)
    dz0, dctx, dnoise, dweights = TLF.fused_solve_backward_plain(
        *args, weights, zs, gz, gq)
    assert dz0.dtype == torch.float32
    assert dctx.dtype == dnoise.dtype == BF16
    assert all(d.dtype == BF16 and d.shape == w.shape
               for d, w in zip(dweights, weights))
    z0, ctx, idx, noise, dts = args
    for bad in ((z0.to(BF16), ctx, idx, noise, dts),
                (z0, ctx.float(), idx, noise, dts),
                (z0, ctx, idx, noise.float(), dts),
                (z0, ctx, idx, noise, dts.to(BF16))):
        with pytest.raises(ValueError):
            TLF.check_kernel_inputs(*bad, weights)
    with pytest.raises(ValueError):
        TLF.check_backward_inputs(*args, weights, zs, gz.float(), gq)
    with pytest.raises(ValueError):
        TLF.check_backward_inputs(*args, weights, zs.float(), gz, gq)


@pytest.mark.parametrize("kind", ["forward", "backward"])
@torch.no_grad()
def test_rounding_floor_tells_mixed_mode_from_float32(kind):
    """chip_smoke.py's floor on a bf16 kernel's roundings, on the CPU: the
    mixed-mode plain version, as the kernel, passes it against itself;
    the float64 plain version on the same inputs, rounded to each output's
    dtype (what a kernel that rounds nothing writes), fails it, and so
    does the float32 reference rounded so."""
    import chip_smoke as CS
    B_, (data, L, C, H), n_ts = 32, DIMS, 8
    gen = torch.Generator().manual_seed(3)
    ts = np.linspace(0.0, 1.0, n_ts)
    model = TL.LatentSDE(data, L, C, H, dtype=BF16, device="cpu",
                         generator=gen).contextualize(
        ts, torch.randn((n_ts, B_, C), generator=gen))
    args = TLF._prep_solve(model, torch.randn((B_, L), generator=gen), ts,
                           gen, 1.0 / 32)[:5]
    weights = TLF.solve_weights(model)
    gz = torch.randn(args[3].shape, generator=gen).to(BF16)
    gq = torch.randn(args[3].shape[:2] + (1,), generator=gen)
    r_args, r_w = CS.bf16_reference(args, weights)
    d_args, d_w = CS.bf16_reference(args, weights, torch.float64)
    if kind == "forward":
        names, dtypes = ("zs", "qs"), (BF16, torch.float32)
        mixed = TLF.fused_solve_forward_plain(*args, weights)
        ref = TLF.fused_solve_forward_plain(*r_args, r_w)
        exact = TLF.fused_solve_forward_plain(*d_args, d_w)
    else:
        names, dtypes = CS.GRAD_NAMES, CS.GRAD_DTYPES
        zs = TLF.fused_solve_forward_plain(*args, weights)[0]
        mixed = CS._flat(TLF.fused_solve_backward_plain(*args, weights, zs,
                                                        gz, gq))
        ref = CS._flat(TLF.fused_solve_backward_plain(
            *r_args, r_w, zs.float(), gz.float(), gq))
        exact = CS._flat(TLF.fused_solve_backward_plain(
            *d_args, d_w, zs.double(), gz.double(), gq.double()))
    assert CS.check_bf16(kind, names, mixed, mixed, ref, dtypes,
                         exact)[2] == 1.0
    for plain in (exact, ref):
        rounded = [t.to(d) for t, d in zip(plain, dtypes)]
        with pytest.raises(RuntimeError, match="roundings are missing"):
            CS.check_bf16(kind, names, rounded, mixed, ref, dtypes)


@pytest.mark.parametrize("window", [None, 4])
def test_multi_twins_are_the_single_twins_replica_by_replica(window):
    """The K-replica plain versions (kernels 3 and 4) in mixed mode, each
    replica bitwise the single plain versions (kernels 1 and 2) on its own
    inputs, over one window or in windows."""
    K = 3
    args, weights, (gz, gq) = _mixed_inputs(2, K=K)
    z0, ctx, idx, noise, dts = args
    zs, qs = TLF.fused_solve_multi_forward_plain(*args, weights)
    back = TLF.fused_solve_multi_backward_plain(*args, weights, zs, gz, gq,
                                                window)
    for k in range(K):
        one = (z0[k], ctx[k], idx, noise[k], dts)
        w_k = [w[k] for w in weights]
        zs_k, qs_k = TLF.fused_solve_forward_plain(*one, w_k)
        assert torch.equal(zs[k], zs_k) and torch.equal(qs[k], qs_k)
        want = TLF.fused_solve_backward_plain(*one, w_k, zs_k, gz[k], gq[k],
                                              window)
        for got, w in zip((back[0][k], back[1][k], back[2][k],
                           *(d[k] for d in back[3])),
                          (*want[:3], *want[3])):
            assert got.dtype == w.dtype and torch.equal(got, w)


def test_windows_change_only_the_order_of_sums():
    """The mixed-mode backward over windows of steps against one window:
    the carried chain is float32, so only the order of the float32 sums of
    the towers' gradients moves (each rounded to bf16 once): within one
    bf16 ulp of each tensor's scale."""
    args, weights, (gz, gq) = _mixed_inputs(3)
    zs, _ = TLF.fused_solve_forward_plain(*args, weights)
    whole = TLF.fused_solve_backward_plain(*args, weights, zs, gz, gq)
    split = TLF.fused_solve_backward_plain(*args, weights, zs, gz, gq, 2)
    for a, b in zip((*whole[:3], *whole[3]), (*split[:3], *split[3])):
        assert a.dtype == b.dtype
        scale = float(a.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2 ** -8 * scale


# FusedLatentSolve's hand-derived backward against autograd through the
# mixed-mode forward, per tensor within 2^-6 of its scale (measured at most
# 5.8e-3, f_b2), the cosine of all above 0.99999 (measured 0.9999973).
# They are two roundings of one function: the hand-derived
# sweep rounds each product's cotangent input to bf16 (the JAX package's
# _backward_core) and sums each weight's gradient over rows and steps in
# float32; autograd rounds the cotangents of the rounded activations and,
# each step's bf16 weight read being a cast, each step's weight gradient,
# and sums them in bf16.
AUTOGRAD_REL, AUTOGRAD_COS = 2 ** -6, 0.99999


def test_fused_solve_gradients_match_autograd_through_the_forward():
    args, weights, (gz, gq) = _mixed_inputs(4)
    z0, ctx, idx, noise, dts = args

    def leaves():
        return [t.detach().clone().requires_grad_()
                for t in (z0, ctx, noise, *weights)]

    def loss(zs, qs):
        return (zs.float() * gz.float()).sum() + (qs * gq).sum()

    a = leaves()
    loss(*TLF.FusedLatentSolve.apply(a[0], a[1], idx, a[2], dts,
                                     *a[3:])).backward()
    b = leaves()
    loss(*TLF.fused_solve_forward_plain(b[0], b[1], idx, b[2], dts,
                                        b[3:])).backward()
    names = ("z0", "ctx", "noise") + TLF.WEIGHT_NAMES
    got = {n: t.grad for n, t in zip(names, a)}
    want = {n: t.grad for n, t in zip(names, b)}
    for name in names:
        assert got[name].dtype == want[name].dtype, name
        scale = float(want[name].float().abs().max())
        err = float((got[name].float() - want[name].float()).abs().max())
        assert err <= AUTOGRAD_REL * scale, (name, err, scale)
    assert _cos(got, want) > AUTOGRAD_COS


def test_fused_multi_route_in_bf16():
    """latent_sde_loss_multi(fused=True) on K = 2 bf16 replicas: float32
    losses, each the single fused route's on a clone of its generator
    within the vmapped encoder's rounding, gradients in bf16 on the stacked
    parameters."""
    K, dims = 2, (3, 2, 4, 8)
    ts = np.linspace(0.0, 1.0, 4)
    models = stack_replicas(
        lambda g: TL.LatentSDE(*dims, dtype=BF16, device="cpu", generator=g),
        [torch.Generator().manual_seed(10 + k) for k in range(K)])
    xs = torch.randn((4, 5, 3), generator=torch.Generator().manual_seed(1)
                     ).to(BF16)
    gens = [torch.Generator().manual_seed(20 + k) for k in range(K)]
    clones = [torch.Generator().set_state(g.get_state()) for g in gens]
    total, losses = TL.latent_sde_loss_multi(models, xs, ts, gens, dt=0.125,
                                             fused=True)
    total.backward()
    assert losses.dtype == torch.float32 and torch.isfinite(losses).all()
    assert all(p.grad.dtype == BF16 and torch.isfinite(p.grad.float()).all()
               for p in models.parameters() if p.grad is not None)
    for k in range(K):
        single = models.call(k, lambda m, x, g: TL.latent_sde_loss(
            m, x, ts, g, dt=0.125, fused=True)[0], xs, clones[k])
        assert single.dtype == torch.float32
        torch.testing.assert_close(losses[k], single.detach(), rtol=2e-3,
                                   atol=0)
