"""The CUDA whole-solve kernels (forward and backward) against their plain
versions on the card, at shapes the flagship run of chip_smoke.py does not
reach: a ragged last batch tile, a hidden width above the block's 128
threads, the smallest widths, a width whose weights do not fit in shared
memory; saturated diffusion, bitwise repeatability of the gradients, the
guards of the CUDA route, and the fused route's training gradients against
the sdeint route's.

Run on a machine with a CUDA card from the repository's root:
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest`` (the
tests' conftest imports JAX, which a GPU machine need not have). Each test
skips itself where CUDA is not available."""

import numpy as np
import pytest
import torch

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
    model.contextualize(ts, torch.randn((n_ts, B, C), generator=gen,
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
