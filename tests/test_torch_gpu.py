"""The CUDA whole-solve kernel against its plain version on the card, at
shapes the flagship run of chip_smoke.py does not reach: a ragged last batch
tile, a hidden width above the block's 128 threads, a width whose weights do
not fit in shared memory, and the guards of the CUDA route.

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


def _solve_args(device, B, L, C, H, n_ts, dt, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    model = LatentSDE(3, L, C, H, device=device,
                      generator=torch.Generator().manual_seed(seed))
    ts = np.linspace(0.0, 1.0, n_ts)
    model.contextualize(ts, torch.randn((n_ts, B, C), generator=gen,
                                        device=device))
    z0 = torch.randn((B, L), generator=gen, device=device)
    args = LF._prep_solve(model, z0, ts, gen, dt)[:5]
    return args, LF.solve_weights(model)


@pytest.mark.parametrize("B,L,C,H,n_ts,dt", [
    (13, 3, 5, 40, 4, 1.0 / 17),      # ragged tile, short last step
    (9, 4, 64, 136, 6, 1.0 / 16),     # H > 128 threads: strided units
    (1, 1, 1, 1, 2, 0.5),             # smallest widths
])
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


def test_too_wide_for_shared_memory_raises(cuda):
    with torch.no_grad():
        args, weights = _solve_args(cuda, 8, 4, 64, 256, 4, 0.25, 1)
        with pytest.raises(ValueError, match="shared memory"):
            LF.fused_solve_forward(*args, weights)


def test_cuda_route_refuses_autograd_and_bf16(cuda):
    args, weights = _solve_args(cuda, 8, 4, 8, 16, 4, 0.25, 2)
    with pytest.raises(NotImplementedError, match="backward"):
        LF.fused_solve_forward(*args, weights)
    with torch.no_grad(), pytest.raises(ValueError, match="bf16"):
        LF.fused_solve_forward(args[0], args[1], args[2],
                               args[3].bfloat16(), args[4], weights)


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
