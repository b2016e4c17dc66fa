"""The CUDA whole-solve kernels against their plain versions on the card, at
shapes the flagship runs of chip_smoke.py do not reach.

Latent SDE (kernels 1 and 2): a ragged last batch tile, a hidden width
above the block's 128 threads, the smallest widths, a width whose weights
do not fit in shared memory; saturated diffusion, bitwise repeatability of
the gradients, the guards of the CUDA route, and the fused route's training
gradients against the sdeint route's. SDE-GAN (kernels 5 and 7, and
their backward kernels 6 and 8): a batch that is not a multiple of the
rows per block, one noise or control channel, the widest state and hidden
widths the kernels take, 32 to 256 threads per block; bitwise repeatable
gradients, the too-wide case, training through the four kernels, and a
small gan_loss and its gradients on both routes. TowerSpec solves (kernels
9-12): depth 1 and 3, widths 1, 33 and 128, all five activations, a time
column, m 1 and 8, bitwise repeatable gradients, refused widths and layer
tables, and training steps of fused_sdeint against its sdeint route.

Run on a machine with a CUDA card from the repository's root:
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest`` (the
tests' conftest imports JAX, which a GPU machine need not have). Each test
skips itself where CUDA is not available."""

import numpy as np
import pytest
import torch

import torchsde_tpu_torch.ops.fused_solve as FS
import torchsde_tpu_torch.ops.gan_fused as GF
import torchsde_tpu_torch.ops.latent_fused as LF
from torchsde_tpu_torch.models.latent_sde import LatentSDE, latent_sde_loss

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


SHAPES = [
    (13, 3, 5, 40, 4, 1.0 / 17),      # ragged tile, short last step
    (9, 4, 64, 136, 6, 1.0 / 16),     # H > 128 threads: strided units
    (1, 1, 1, 1, 2, 0.5),             # smallest widths
]


def _solve_args(device, B, L, C, H, n_ts, dt, seed, saturated=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    model = LatentSDE(3, L, C, H, device=device,
                      generator=torch.Generator().manual_seed(seed))
    if saturated:
        with torch.no_grad():      # g ~ 1e-11, below stable_division's 1e-7
            model.g_nets[3].sub_(25.0)
    ts = np.linspace(0.0, 1.0, n_ts)
    model = model.contextualize(ts, torch.randn((n_ts, B, C), generator=gen,
                                                device=device))
    z0 = torch.randn((B, L), generator=gen, device=device)
    args = LF._prep_solve(model, z0, ts, gen, dt)[:5]
    return args, LF.solve_weights(model)


def _cotangents(zs, qs, seed):
    gen = torch.Generator(device=zs.device).manual_seed(seed)
    return (0.1 * torch.randn(zs.shape, generator=gen, device=zs.device),
            0.1 * torch.randn(qs.shape, generator=gen, device=qs.device))


def _flat(out):
    dz0, dctx, dnoise, dweights = out
    return [dz0, dctx, dnoise, *dweights]


def _assert_grads_close(got, want):
    """Tolerance of the JAX package's fused against XLA gradients
    (tests/test_fused_latent.py:73-79), per tensor: atol max(1e-4,
    3e-5 * its largest entry). The kernel sums each weight gradient over
    rows and steps in another order than the plain version's matmuls."""
    for g, w in zip(_flat(got), _flat(want)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        scale = float(w.abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(g, w, rtol=0, atol=max(1e-4, 3e-5 * scale))


@pytest.mark.parametrize("B,L,C,H,n_ts,dt", SHAPES)
def test_kernel_matches_plain(cuda, B, L, C, H, n_ts, dt):
    with torch.no_grad():
        args, weights = _solve_args(cuda, B, L, C, H, n_ts, dt, 0)
        before = LF.launches
        zs, qs = LF.fused_solve_forward(*args, weights)
        assert LF.launches == before + 1
        zs_p, qs_p = LF.fused_solve_forward_plain(*args, weights)
    torch.cuda.synchronize()
    torch.testing.assert_close(zs, zs_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(qs, qs_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,L,C,H,n_ts,dt", SHAPES)
@pytest.mark.parametrize("saturated", [False, True])
def test_backward_kernel_matches_plain(cuda, B, L, C, H, n_ts, dt, saturated):
    with torch.no_grad():
        args, weights = _solve_args(cuda, B, L, C, H, n_ts, dt, 0, saturated)
        zs, qs = LF.fused_solve_forward_plain(*args, weights)
        gz, gq = _cotangents(zs, qs, 1)
        before = LF.bwd_launches
        got = LF.fused_solve_backward_cuda(*args, weights, zs, gz, gq)
        assert LF.bwd_launches == before + 1
        want = LF.fused_solve_backward_plain(*args, weights, zs, gz, gq)
    torch.cuda.synchronize()
    _assert_grads_close(got, want)
    if saturated:        # only the u-path is masked: dz * dW reaches g
        assert max(float(d.abs().max()) for d in want[3][12:]) > 0


def test_backward_kernel_is_bitwise_repeatable(cuda):
    with torch.no_grad():
        args, weights = _solve_args(cuda, 37, 4, 16, 32, 6, 1.0 / 32, 3)
        zs, qs = LF.fused_solve_forward_cuda(*args, weights)
        gz, gq = _cotangents(zs, qs, 4)
        first = _flat(LF.fused_solve_backward_cuda(*args, weights, zs, gz,
                                                   gq))
        second = _flat(LF.fused_solve_backward_cuda(*args, weights, zs, gz,
                                                    gq))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_too_wide_for_shared_memory_raises(cuda):
    with torch.no_grad():
        args, weights = _solve_args(cuda, 8, 4, 64, 256, 4, 0.25, 1)
        with pytest.raises(ValueError, match="shared memory"):
            LF.fused_solve_forward(*args, weights)
        zs = torch.zeros_like(args[3])
        qs = torch.zeros(zs.shape[:2] + (1,), device=cuda)
        with pytest.raises(ValueError, match="shared memory"):
            LF.fused_solve_backward_cuda(*args, weights, zs, zs, qs)


def test_cuda_route_refuses_bf16(cuda):
    args, weights = _solve_args(cuda, 8, 4, 8, 16, 4, 0.25, 2)
    with torch.no_grad(), pytest.raises(ValueError, match="bf16"):
        LF.fused_solve_forward(args[0], args[1], args[2],
                               args[3].bfloat16(), args[4], weights)
    zs = torch.zeros_like(args[3])
    qs = torch.zeros(zs.shape[:2] + (1,), device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        LF.fused_solve_backward_cuda(*args, weights, zs, zs.bfloat16(), qs)


def test_loss_on_both_routes_agrees(cuda):
    model = LatentSDE(3, 4, 16, 32, device=cuda,
                      generator=torch.Generator().manual_seed(3))
    xs = torch.randn((6, 37, 3), device=cuda)
    ts = np.linspace(0.0, 1.0, 6)
    losses = []
    with torch.no_grad():
        for fused in (True, False):
            gen = torch.Generator(device=cuda).manual_seed(4)
            loss, _ = latent_sde_loss(model, xs, ts, gen, dt=1.0 / 32,
                                      fused=fused)
            losses.append(float(loss))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


def test_fused_gradients_match_sdeint_route(cuda):
    """One small ELBO's parameter gradients through the two kernels against
    autograd through the sdeint route on the same generator seed. Both run
    in float32 and sum in other orders over 32 steps; atol 1e-4 times each
    gradient's largest entry."""
    model = LatentSDE(3, 4, 16, 32, device=cuda,
                      generator=torch.Generator().manual_seed(5))
    xs = torch.randn((6, 37, 3), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(6))
    ts = np.linspace(0.0, 1.0, 6)
    grads = []
    for fused in (True, False):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=cuda).manual_seed(7)
        before = (LF.launches, LF.bwd_launches)
        loss, _ = latent_sde_loss(model, xs, ts, gen, dt=1.0 / 32,
                                  fused=fused)
        loss.backward()
        assert (LF.launches - before[0], LF.bwd_launches - before[1]) == \
            ((1, 1) if fused else (0, 0))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, want in grads[1].items():
        got = grads[0][name]
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()),
                                   msg=name)


# --------------------------------------------------------------------------- #
#  SDE-GAN kernels 5 (generator) and 7 (critic)                               #
# --------------------------------------------------------------------------- #

GEN_SHAPES = [
    (37, 16, 16, 3, 6),     # batch not a multiple of the rows per block
    (5, 8, 32, 1, 4),       # m = 1, hidden wider than the state
    (64, 32, 32, 8, 3),     # the widest the kernel takes
    (3, 1, 1, 1, 2),        # the smallest widths, one step
]
CDE_SHAPES = [
    (37, 17, 16, 2, 6),     # the critic's widths, ragged batch
    (5, 32, 32, 8, 3),      # the widest the kernel takes
    (9, 5, 20, 1, 4),       # one control channel
]


def _gan_gen_args(device, B, S, M, m, T, seed):
    from torchsde_tpu_torch.models.sde_gan import Generator
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Generator(1, 5, m, S, M, 1, init_mult2=0.5, device=device,
                      generator=torch.Generator().manual_seed(seed))
    ts = np.arange(T, dtype=np.float64)
    x0 = torch.randn((B, S), generator=gen, device=device)
    return (GF.prep_generator_solve(model.func, x0, ts, gen, 1.0),
            GF.gen_weights(model.func))


def _gan_cde_args(device, B, S, M, C, T, seed):
    from torchsde_tpu_torch.models.sde_gan import Discriminator
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Discriminator(C - 1, S, M, 1, device=device,
                          generator=torch.Generator().manual_seed(seed))
    ts = np.arange(T, dtype=np.float64)
    paths = torch.randn((B, T, C), generator=gen, device=device)
    func = model.func.attach(ts, paths)
    return (GF.prep_cde_solve(func, model.initial(paths[:, 0]), ts, 1.0),
            GF.cde_weights(model.func))


@pytest.mark.parametrize("B,S,M,m,T", GEN_SHAPES)
@pytest.mark.parametrize("threads", [32, 128, 256])
def test_gan_gen_kernel_matches_plain(cuda, B, S, M, m, T, threads):
    with torch.no_grad():
        args, weights = _gan_gen_args(cuda, B, S, M, m, T, 0)
        before = GF.gen_launches
        got = GF.gen_solve_forward_cuda(*args, weights, threads=threads)
        assert GF.gen_launches == before + 1
        want = GF.gen_solve_forward_plain(*args, weights)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,S,M,C,T", CDE_SHAPES)
@pytest.mark.parametrize("threads", [32, 128, 256])
def test_gan_cde_kernel_matches_plain(cuda, B, S, M, C, T, threads):
    with torch.no_grad():
        args, weights = _gan_cde_args(cuda, B, S, M, C, T, 1)
        before = GF.cde_launches
        got = GF.cde_solve_forward_cuda(*args, weights, threads=threads)
        assert GF.cde_launches == before + 1
        want = GF.cde_solve_forward_plain(*args, weights)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_gan_too_wide_raises(cuda):
    with torch.no_grad():
        args, weights = _gan_gen_args(cuda, 4, 33, 16, 3, 3, 2)
        with pytest.raises(ValueError, match="<= 32"):
            GF.gen_solve_forward(*args, weights)
        args, weights = _gan_cde_args(cuda, 4, 17, 16, 9, 3, 2)
        with pytest.raises(ValueError, match="channels"):
            GF.cde_solve_forward(*args, weights)


def _assert_gan_grads_close(got, want):
    """The JAX package's rule for the fused GAN gradients
    (tests/test_fused_gan.py:181), per tensor: atol max(1e-4, 1e-5 * its
    largest entry). The kernels sum every weight gradient over rows and
    steps in another order than the plain versions' matmuls."""
    got, want = [*got[:-1], *got[-1]], [*want[:-1], *want[-1]]
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        scale = float(w.abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(g, w, rtol=0, atol=max(1e-4, 1e-5 * scale))


def _gan_gen_backward_args(device, B, S, M, m, T, seed):
    args, weights = _gan_gen_args(device, B, S, M, m, T, seed)
    ys, zs, gs = GF.gen_solve_forward_plain(*args, weights)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    gy = torch.randn(ys.shape, generator=gen, device=device)
    return (*args, weights, zs, gs, gy)


def _gan_cde_backward_args(device, B, S, M, C, T, seed, last_only=False):
    args, weights = _gan_cde_args(device, B, S, M, C, T, seed)
    hs, zs = GF.cde_solve_forward_plain(*args, weights)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    ghs = torch.randn(hs.shape, generator=gen, device=device)
    if last_only:
        ghs[:-1] = 0.0
    return (*args, weights, zs, ghs)


@pytest.mark.parametrize("B,S,M,m,T", GEN_SHAPES)
@pytest.mark.parametrize("threads", [32, 128, 256])
def test_gan_gen_backward_kernel_matches_plain(cuda, B, S, M, m, T, threads):
    with torch.no_grad():
        bargs = _gan_gen_backward_args(cuda, B, S, M, m, T, 0)
        before = GF.gen_bwd_launches
        got = GF.gen_solve_backward_cuda(*bargs, threads=threads)
        assert GF.gen_bwd_launches == before + 1
        want = GF.gen_solve_backward_plain(*bargs)
    torch.cuda.synchronize()
    _assert_gan_grads_close(got, want)


@pytest.mark.parametrize("B,S,M,C,T", CDE_SHAPES)
@pytest.mark.parametrize("threads", [32, 128, 256])
def test_gan_cde_backward_kernel_matches_plain(cuda, B, S, M, C, T, threads):
    with torch.no_grad():
        bargs = _gan_cde_backward_args(cuda, B, S, M, C, T, 1,
                                       last_only=threads == 128)
        before = GF.cde_bwd_launches
        got = GF.cde_solve_backward_cuda(*bargs, threads=threads)
        assert GF.cde_bwd_launches == before + 1
        want = GF.cde_solve_backward_plain(*bargs)
    torch.cuda.synchronize()
    _assert_gan_grads_close(got, want)


def test_gan_backward_kernels_are_bitwise_repeatable(cuda):
    """No atomics: the per-warp partials are summed in a fixed order, at
    any block size."""
    with torch.no_grad():
        for sweep, bargs in (
                (GF.gen_solve_backward_cuda,
                 _gan_gen_backward_args(cuda, 37, 16, 16, 3, 6, 3)),
                (GF.cde_solve_backward_cuda,
                 _gan_cde_backward_args(cuda, 37, 17, 16, 2, 6, 3))):
            runs = [sweep(*bargs, threads=t) for t in (128, 128, 64)]
            torch.cuda.synchronize()
            flat = [[*r[:-1], *r[-1]] for r in runs]
            for other in flat[1:]:
                assert all(torch.equal(a, b) for a, b in zip(flat[0], other))


def _small_gan(device):
    from torchsde_tpu_torch.models.sde_gan import (Discriminator, Generator,
                                                   get_ou_data)
    init = torch.Generator().manual_seed(4)
    generator = Generator(1, 5, 3, 16, 16, 1, init_mult1=3.0, init_mult2=0.5,
                          device=device, generator=init)
    critic = Discriminator(1, 17, 16, 1, device=device, generator=init)
    ts, real = get_ou_data(torch.Generator(device=device).manual_seed(5), 37,
                           9, device=device)
    return generator, critic, ts, real


def test_gan_cuda_route_trains_through_the_four_kernels(cuda):
    """gan_grads(fused=True) on the card: each of kernels 5, 6, 7 and 8
    launches once, and every parameter gets a finite gradient."""
    from torchsde_tpu_torch.models.sde_gan import gan_grads
    generator, critic, ts, real = _small_gan(cuda)
    counters = ("gen_launches", "gen_bwd_launches", "cde_launches",
                "cde_bwd_launches")
    before = [getattr(GF, c) for c in counters]
    gen = torch.Generator(device=cuda).manual_seed(6)
    loss, g_gen, g_disc = gan_grads(generator, critic, gen, ts, real,
                                    adjoint=False, fused=True)
    torch.cuda.synchronize()
    assert [getattr(GF, c) - b for c, b in zip(counters, before)] == [1] * 4
    assert torch.isfinite(loss)
    assert set(g_gen) == dict(generator.named_parameters()).keys()
    assert set(g_disc) == dict(critic.named_parameters()).keys()
    for g in (*g_gen.values(), *g_disc.values()):
        assert torch.isfinite(g).all()


def test_gan_grads_on_both_routes_agree(cuda):
    """Every parameter gradient through the four kernels against autograd
    through the sdeint route on the same generator seed: atol 1e-5 times
    each gradient's largest entry (both float32, summed in other
    orders)."""
    from torchsde_tpu_torch.models.sde_gan import gan_grads
    generator, critic, ts, real = _small_gan(cuda)
    grads = []
    for fused in (True, False):
        gen = torch.Generator(device=cuda).manual_seed(7)
        _, g_gen, g_disc = gan_grads(generator, critic, gen, ts, real,
                                     adjoint=False, fused=fused)
        grads.append({**g_gen, **{"critic." + k: v
                                  for k, v in g_disc.items()}})
    for name, want in grads[1].items():
        torch.testing.assert_close(grads[0][name], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=name)


def test_gan_loss_on_both_routes_agrees(cuda):
    from torchsde_tpu_torch.models.sde_gan import gan_loss
    generator, critic, ts, real = _small_gan(cuda)
    losses = []
    with torch.no_grad():
        for fused in (True, False):
            gen = torch.Generator(device=cuda).manual_seed(6)
            before = (GF.gen_launches, GF.cde_launches)
            losses.append(float(gan_loss(generator, critic, gen, ts, real,
                                         adjoint=False, fused=fused)))
            assert (GF.gen_launches - before[0],
                    GF.cde_launches - before[1]) == \
                ((1, 1) if fused else (0, 0))
    np.testing.assert_allclose(losses[0], losses[1], rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- #
#  TowerSpec solves: kernels 9 and 10 (Euler), 11 and 12 (reversible Heun)    #
# --------------------------------------------------------------------------- #

# (method, diag, S, m, with_time, drift (hidden..., acts), diffusion, B, N,
# drift weight scale): depth 1 and 3, widths 1, 33 and 128, all five
# activations, a time column, m 1 and 8, a drift whose softplus sees
# pre-activations in the hundreds.
TOWER_CASES = [
    ("euler", True, 1, 1, False, ((), ("softplus",)), ((), ("sigmoid",)),
     13, 3, 100.0),
    ("euler", False, 5, 8, True,
     ((33, 33), ("softplus", "tanh", "linear")),
     ((33, 33), ("lipswish", "sigmoid", "sigmoid")), 37, 5, 0.3),
    ("euler", True, 128, 128, False, ((128,), ("lipswish", "linear")),
     ((128,), ("softplus", "sigmoid")), 9, 3, 0.3),
    ("reversible_heun", True, 127, 127, True, ((33,), ("tanh", "linear")),
     ((33,), ("lipswish", "softplus")), 11, 4, 0.3),
    ("reversible_heun", False, 16, 1, False,
     ((128, 128), ("sigmoid", "lipswish", "tanh")),
     ((128, 128), ("tanh", "softplus", "linear")), 20, 6, 0.3),
    ("reversible_heun", False, 8, 8, True, ((), ("linear",)),
     ((), ("sigmoid",)), 8, 2, 0.3),
]


def _tower(rng, sizes, acts, scale, device):
    return FS.TowerSpec([
        (torch.as_tensor(rng.standard_normal((a, b)) * (scale / np.sqrt(a)),
                         dtype=torch.float32, device=device),
         torch.as_tensor(0.05 * rng.standard_normal(b), dtype=torch.float32,
                         device=device), act)
        for (a, b), act in zip(zip(sizes[:-1], sizes[1:]), acts)])


def _tower_solve(device, case, seed=0):
    """The solve's spec and the kernels' inputs (a forward's, then gy)."""
    method, diag, S, m, wt, (fh, facts), (gh, gacts), B, N, scale = case
    rng = np.random.default_rng(seed)
    n_in = S + (1 if wt else 0)
    gwidth = S if diag else S * m
    drift = _tower(rng, [n_in, *fh, S], facts, scale, device)
    diffusion = _tower(rng, [n_in, *gh, gwidth], gacts, 0.3, device)
    spec = FS.solve_spec(drift, diffusion, S, m, diag, wt)
    grid = np.linspace(0.0, 1.0, N + 1)
    f32 = dict(dtype=torch.float32, device=device)
    y0 = torch.as_tensor(rng.standard_normal((B, S)), **f32)
    noise = torch.as_tensor(rng.standard_normal((N, B, m)) / np.sqrt(N),
                            **f32)
    t = torch.as_tensor(grid, **f32)
    dts = t[1:] - t[:-1]
    fw, gw = drift.pack(), diffusion.pack()
    gy = torch.as_tensor(rng.standard_normal((N, B, S)), **f32)
    if method == "euler":
        return spec, (y0, noise, t[:-1], dts, fw, gw, spec), gy
    x0 = FS.tower_input(t[0], y0, wt)
    f0 = FS.tower_forward(x0, FS.unpack(fw, spec.drift), drift.acts)[0]
    g0 = FS.tower_forward(x0, FS.unpack(gw, spec.diffusion),
                          diffusion.acts)[0]
    return spec, (y0, f0, g0, noise, t[1:], dts, fw, gw, spec), gy


def _assert_close(got, want, atol, rel, rtol=0.0):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        scale = float(w.abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(g, w, rtol=rtol,
                                   atol=max(atol, rel * scale))


@pytest.mark.parametrize("case", TOWER_CASES,
                         ids=[f"{c[0]}-S{c[2]}-m{c[3]}" for c in TOWER_CASES])
def test_tower_kernels_match_plain(cuda, case):
    """Each forward and backward kernel against its plain version: values
    within max(2e-5, 4e-6 * scale), gradients within max(1e-4, 1e-5 *
    scale) (chip_smoke.py's rules)."""
    with torch.no_grad():
        spec, args, gy = _tower_solve(cuda, case)
        counts = (FS.euler_launches, FS.euler_bwd_launches, FS.rh_launches,
                  FS.rh_bwd_launches)
        if case[0] == "euler":
            got = [FS.euler_solve_forward_cuda(*args)]
            want = [FS.euler_solve_forward_plain(*args)]
            got_b = FS.euler_solve_backward_cuda(*args, want[0], gy)
            want_b = FS.euler_solve_backward_plain(*args, want[0], gy)
            launched = (1, 1, 0, 0)
        else:
            got = list(FS.rh_solve_forward_cuda(*args))
            want = list(FS.rh_solve_forward_plain(*args))
            got_b = FS.rh_solve_backward_cuda(*args, *want[1:], gy)
            want_b = FS.rh_solve_backward_plain(*args, *want[1:], gy)
            launched = (0, 0, 1, 1)
    torch.cuda.synchronize()
    assert (FS.euler_launches - counts[0], FS.euler_bwd_launches - counts[1],
            FS.rh_launches - counts[2],
            FS.rh_bwd_launches - counts[3]) == launched
    _assert_close(got, want, 2e-5, 4e-6)
    _assert_close(got_b, want_b, 1e-4, 1e-5)


def test_tower_backward_kernels_are_bitwise_repeatable(cuda):
    with torch.no_grad():
        for case in (TOWER_CASES[1], TOWER_CASES[4]):
            spec, args, gy = _tower_solve(cuda, case, seed=1)
            if case[0] == "euler":
                ys = FS.euler_solve_forward_cuda(*args)
                runs = [FS.euler_solve_backward_cuda(*args, ys, gy)
                        for _ in range(2)]
            else:
                _, zs, gs = FS.rh_solve_forward_cuda(*args)
                runs = [FS.rh_solve_backward_cuda(*args, zs, gs, gy)
                        for _ in range(2)]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_tower_too_wide_layer_table_raises(cuda):
    """A width past 128 is refused before any launch; so is a layer table
    whose activations do not fit a block's shared memory (15 layers of
    width 128 a tower keep 240 KiB in the backward kernels)."""
    case = ("euler", True, 4, 4, False, ((16,), ("tanh", "linear")),
            ((16,), ("tanh", "sigmoid")), 8, 2, 0.3)
    with torch.no_grad():
        spec, args, gy = _tower_solve(cuda, case)
        wide = spec._replace(drift=((4, 129, "tanh"), (129, 4, "linear")))
        with pytest.raises(ValueError, match="widths in"):
            FS.euler_solve_forward_cuda(*args[:-1], wide)
        deep_case = ("euler", True, 4, 4, False,
                     ((128,) * 14, ("tanh",) * 14 + ("linear",)),
                     ((128,) * 14, ("tanh",) * 14 + ("sigmoid",)), 8, 2,
                     0.3)
        spec, args, gy = _tower_solve(cuda, deep_case)
        ys = FS.euler_solve_forward_cuda(*args)        # the forward fits
        with pytest.raises(ValueError, match="shared memory"):
            FS.euler_solve_backward_cuda(*args, ys, gy)
        with pytest.raises(ValueError, match="float32"):
            FS.euler_solve_forward_cuda(args[0].double(), *args[1:])


def _train_step(method, device, dispatch):
    """One Adam step of mean(ys**2) through fused_sdeint on a small
    general-noise, time-dependent solve; returns the loss and gradients."""
    rng = np.random.default_rng(2)
    S, m = 6, 3
    drift = _tower(rng, [S + 1, 32, S], ("softplus", "linear"), 0.3, device)
    diffusion = _tower(rng, [S + 1, 32, S * m], ("lipswish", "sigmoid"), 0.3,
                       device)
    leaves = [t.requires_grad_() for spec in (drift, diffusion)
              for (w, b, _) in spec.layers for t in (w, b)]
    y0 = torch.as_tensor(rng.standard_normal((50, S)), dtype=torch.float32,
                         device=device).requires_grad_()
    opt = torch.optim.Adam(leaves, lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(3)
    ys = FS.fused_sdeint(drift, diffusion, y0, np.linspace(0, 1, 5), gen,
                         1.0 / 16, method=method, noise_type="general",
                         with_time=True, dispatch=dispatch)
    loss = (ys ** 2).mean()
    loss.backward()
    grads = [t.grad.clone() for t in leaves + [y0]]
    opt.step()
    return loss.detach(), grads


def test_fused_sdeint_trains_through_the_four_kernels(cuda):
    """A training step of each method launches its forward and backward
    kernel once, and its gradients match the sdeint route's on the same
    generator seed within 1e-5 of each gradient's scale."""
    counters = ("euler_launches", "euler_bwd_launches", "rh_launches",
                "rh_bwd_launches")
    for method, launched in (("euler", [1, 1, 0, 0]),
                             ("reversible_heun", [0, 0, 1, 1])):
        before = [getattr(FS, c) for c in counters]
        loss, grads = _train_step(method, cuda, "fused")
        torch.cuda.synchronize()
        assert [getattr(FS, c) - b for c, b in zip(counters, before)] == \
            launched
        before = [getattr(FS, c) for c in counters]
        loss_x, grads_x = _train_step(method, cuda, "xla")
        assert [getattr(FS, c) for c in counters] == before
        torch.testing.assert_close(loss, loss_x, rtol=1e-5, atol=0)
        for g, w in zip(grads, grads_x):
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-5 * float(w.abs().max()))


# Kernels 13 and 14 (fused_sdeint_logqp): (S, with_time, drift hidden and
# acts (the prior's the same), diffusion hidden and acts, diffusion weight
# scale, B, N).
LOGQP_CASES = [
    (8, True, ((16,), ("softplus", "linear")),
     ((16,), ("lipswish", "tanh")), 0.8, 37, 6),       # g of both signs
    (32, False, ((64,), ("softplus", "linear")),
     ((), ("sigmoid",)), 0.3, 20, 4),
    (128, False, ((128,), ("softplus", "linear")),
     ((128,), ("lipswish", "sigmoid")), 0.3, 9, 3),    # one tower staged
    (127, True, ((33,), ("tanh", "linear")),
     ((33, 33), ("lipswish", "softplus", "sigmoid")), 0.3, 11, 3),
]


def _logqp_solve(device, case, seed=0):
    """The spec, the forward kernel's inputs, and cotangents of ys and of
    the KL channel's increments (ginc)."""
    S, wt, (fh, facts), (gh, gacts), gscale, B, N = case
    rng = np.random.default_rng(seed)
    n_in = S + (1 if wt else 0)
    drift = _tower(rng, [n_in, *fh, S], facts, 0.3, device)
    prior = _tower(rng, [n_in, *fh, S], facts, 0.3, device)
    diffusion = _tower(rng, [n_in, *gh, S], gacts, gscale, device)
    spec = FS.solve_spec(drift, diffusion, S, S, True, wt, prior=prior)
    f32 = dict(dtype=torch.float32, device=device)
    y0 = torch.as_tensor(rng.standard_normal((B, S)), **f32)
    noise = torch.as_tensor(rng.standard_normal((N, B, S)) / np.sqrt(N),
                            **f32)
    t = torch.as_tensor(np.linspace(0.0, 1.0, N + 1), **f32)
    gy = torch.as_tensor(rng.standard_normal((N, B, S)), **f32)
    ginc = torch.as_tensor(rng.standard_normal((N, B, 1)), **f32)
    args = (y0, noise, t[:-1], t[1:] - t[:-1], drift.pack(), prior.pack(),
            diffusion.pack(), spec)
    return spec, args, gy, ginc


@pytest.mark.parametrize("case", LOGQP_CASES,
                         ids=[f"S{c[0]}-t{int(c[1])}" for c in LOGQP_CASES])
def test_logqp_kernels_match_plain(cuda, case):
    """Kernels 13 and 14 against their plain versions: ys and qs within
    max(2e-5, 4e-6 * scale), gradients within max(1e-4, 1e-5 * scale)
    (chip_smoke.py's rules); each launched once. Where the diffusion takes
    both signs, u = (f - h) / g amplifies the two versions' rounding of g
    near zero, so qs and the gradients also get the JAX package's relative
    tolerance for that case (rtol 3e-3 and 5e-3,
    tests/test_fused_solve.py:226,261-262)."""
    signed = case[3][1][-1] in ("tanh", "linear")
    with torch.no_grad():
        spec, args, gy, ginc = _logqp_solve(cuda, case)
        counts = (FS.logqp_launches, FS.logqp_bwd_launches)
        got = FS.euler_logqp_solve_forward_cuda(*args)
        want = FS.euler_logqp_solve_forward_plain(*args)
        got_b = FS.euler_logqp_solve_backward_cuda(*args, want[0], gy, ginc)
        want_b = FS.euler_logqp_solve_backward_plain(*args, want[0], gy,
                                                     ginc)
    torch.cuda.synchronize()
    assert (FS.logqp_launches - counts[0],
            FS.logqp_bwd_launches - counts[1]) == (1, 1)
    _assert_close(got, want, 2e-5, 4e-6, 3e-3 if signed else 0.0)
    _assert_close(got_b, want_b, 1e-4, 1e-5, 5e-3 if signed else 0.0)


def test_logqp_backward_is_bitwise_repeatable_and_staging_exact(cuda):
    """Two sweeps agree bitwise, and the towers' staging (shared memory or
    device memory) changes no bit of either kernel's results."""
    with torch.no_grad():
        spec, args, gy, ginc = _logqp_solve(cuda, LOGQP_CASES[1], seed=1)
        ys, qs = FS.euler_logqp_solve_forward_cuda(*args)
        runs = [FS.euler_logqp_solve_backward_cuda(*args, ys, gy, ginc)
                for _ in range(2)]
        unstaged = FS.euler_logqp_solve_forward_cuda(*args, stage=0)
        runs.append(FS.euler_logqp_solve_backward_cuda(*args, ys, gy, ginc,
                                                       stage=0))
    torch.cuda.synchronize()
    assert torch.equal(ys, unstaged[0]) and torch.equal(qs, unstaged[1])
    assert all(torch.equal(a, b) for run in runs[1:]
               for a, b in zip(runs[0], run))


def test_logqp_three_towers_too_big_raises(cuda):
    """The layout counts the third tower: with nine width-128 layers a
    tower, the logqp sweep keeps over 227 KiB of activations in a block
    and is refused before any launch, while the forward, and kernel 10 on
    two such towers, fit."""
    case = (128, False, ((128,) * 8, ("tanh",) * 8 + ("linear",)),
            ((128,) * 8, ("tanh",) * 8 + ("sigmoid",)), 0.3, 8, 2)
    with torch.no_grad():
        spec, args, gy, ginc = _logqp_solve(cuda, case)
        ys, _ = FS.euler_logqp_solve_forward_cuda(*args)
        with pytest.raises(ValueError, match="shared memory"):
            FS.euler_logqp_solve_backward_cuda(*args, ys, gy, ginc)
        y0, noise, t0s, dts, fw, _, gw, _ = args
        two = spec._replace(prior=())
        ys2 = FS.euler_solve_forward_cuda(y0, noise, t0s, dts, fw, gw, two)
        FS.euler_solve_backward_cuda(y0, noise, t0s, dts, fw, gw, two, ys2,
                                     gy)
    torch.cuda.synchronize()


def _logqp_train_step(device, dispatch):
    """One Adam step of mean(ys**2) + mean(sum(log_ratio, 0)) through
    fused_sdeint_logqp with a time column; returns the loss and
    gradients."""
    rng = np.random.default_rng(4)
    S = 6
    towers = [_tower(rng, [S + 1, 32, S], acts, 0.3, device)
              for acts in (("softplus", "linear"), ("softplus", "linear"),
                           ("lipswish", "sigmoid"))]
    leaves = [t.requires_grad_() for spec in towers
              for (w, b, _) in spec.layers for t in (w, b)]
    y0 = torch.as_tensor(rng.standard_normal((50, S)), dtype=torch.float32,
                         device=device).requires_grad_()
    opt = torch.optim.Adam(leaves, lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(5)
    ys, log_ratio = FS.fused_sdeint_logqp(*towers, y0, np.linspace(0, 1, 5),
                                          gen, 1.0 / 16, with_time=True,
                                          dispatch=dispatch)
    loss = (ys ** 2).mean() + log_ratio.sum(0).mean()
    loss.backward()
    grads = [t.grad.clone() for t in leaves + [y0]]
    opt.step()
    return loss.detach(), grads


def test_fused_sdeint_logqp_trains_through_kernels_13_and_14(cuda):
    """A training step launches kernels 13 and 14 once each, and its loss
    and gradients match the sdeint route's on the same generator seed
    within 1e-5 of each gradient's scale."""
    before = (FS.logqp_launches, FS.logqp_bwd_launches)
    loss, grads = _logqp_train_step(cuda, "fused")
    torch.cuda.synchronize()
    assert (FS.logqp_launches - before[0],
            FS.logqp_bwd_launches - before[1]) == (1, 1)
    loss_x, grads_x = _logqp_train_step(cuda, "xla")
    assert (FS.logqp_launches, FS.logqp_bwd_launches) == (before[0] + 1,
                                                          before[1] + 1)
    torch.testing.assert_close(loss, loss_x, rtol=1e-5, atol=0)
    for g, w in zip(grads, grads_x):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))
