"""The CUDA whole-solve kernels against their plain versions on the card, at
shapes the flagship runs of chip_smoke.py do not reach.

Latent SDE (kernels 1 and 2): a ragged last batch tile, a hidden width
above the block's 128 threads, the smallest widths, a width whose weights
do not fit in shared memory; saturated diffusion, bitwise repeatability of
the gradients, kernel 2's sweep and contraction run apart at each block
size of the sweep, its scratch tensors, the guards of the CUDA route, and the fused route's training
gradients against the sdeint route's. SDE-GAN (kernels 5 and 7, and
their backward kernels 6 and 8): a batch that is not a multiple of the
rows per block, one noise or control channel, the widest state and hidden
widths the kernels take, 32 to 256 threads per block; bitwise repeatable
gradients, the too-wide case, training through the four kernels, and a
small gan_loss and its gradients on both routes; in bf16 mixed mode, the
bf16 entries of kernels 5-8 against the plain versions at the JAX bf16
test's and the reference widths, their counters, the refused mixes of
modes, and a bf16 training step through them. TowerSpec solves (kernels
9-12): depth 1 and 3, widths 1, 33 and 128, all five activations, a time
column, m 1 and 8, bitwise repeatable gradients, refused widths and layer
tables, and training steps of fused_sdeint against its sdeint route.

Run on a machine with a CUDA card from the repository's root:
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest`` (the
tests' conftest imports JAX, which a GPU machine need not have). Each test
skips itself where CUDA is not available.

Kernels 10, 12 and 14 (each a sweep and a contraction of its scratch): against
the unsplit loops of ``tests/port_bridge.py`` on the card, bitwise
repeatable, one launch a backward, run phase by phase, and in windows of
steps under a smaller workspace. Kernels 11 and 13 in their row-tile
designs at R1, L1, L2, general noise and the small signed solve, every
design bitwise the rule's, and the host's shared-memory layout against the
C one; kernel 4 in groups of replicas under a smaller total workspace.
Kernels 6 and 7 (a row's vectors through the warp's shared memory) at the
GAN's reference scale, a ragged batch, one channel, a hidden layer wider
than the state and the widest widths, against the twin and float64, every
block size of each bitwise the others; their C layouts against the host's
mirror.

BrownianInterval (no kernel: plain PyTorch) on the card against the CPU:
branch bits resolved on the card, packed words, keys, random bits and
uniforms bitwise; W and U within 2e-5 and A within 1e-4 (CUDA's erfinv is
not the CPU's, and A is built from H = U/h - W/2 of float32 prefix
integrals); query_pairs over a CUDA tensor of times bitwise __call__ on
host floats; each fixed-step method's solve on it against the CPU's.

sdeint_adjoint (no kernel: plain PyTorch) on the card: its gradients
(parameters, y0, a buffer computed upstream) against the CPU's in float64
on one table of increments, by Euler, Milstein and the reversible pair;
under rng_impl='philox' the backward's W bitwise the forward's, kernel 16
launched once for each; a small gan_grads at its default adjoint=True
against the fused route's (kernels 5-8).

Adaptive stepping and in-loop noise (no kernel: plain PyTorch) on the
card: ``sdeint(adaptive=True)`` in float64 against the CPU on the whole
batch (the error norm couples the rows), its stats equal; the gradients
of backprop and of both adaptive adjoint modes against the CPU's; the
in-loop queries of an explicit interval bitwise its precomputed noise;
the default in-loop stream on the card against the CPU's on one key."""

import numpy as np
import pytest
import torch

import torchsde_tpu_torch.ops.fused_solve as FS
import torchsde_tpu_torch.ops.gan_fused as GF
import torchsde_tpu_torch.ops.latent_fused as LF
from torchsde_tpu_torch import BrownianInterval, sdeint
from torchsde_tpu_torch.brownian import threefry as TF
from torchsde_tpu_torch.brownian.base import BaseBrownian
from torchsde_tpu_torch.ops import _build
from torchsde_tpu_torch.models.latent_sde import LatentSDE, latent_sde_loss
from port_bridge import (unsplit_euler_backward, unsplit_logqp_backward,
                         unsplit_rh_backward)

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


def _solve_args(device, B, L, C, H, n_ts, dt, seed, saturated=False,
                dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(seed)
    model = LatentSDE(3, L, C, H, dtype=dtype, device=device,
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


@pytest.mark.parametrize("multi", [False, True])
def test_backward_phases_match_whole_call(cuda, multi):
    """Kernel 2's (or 4's) sweep alone, then its contraction alone on the
    sweep's workspace, give the whole call's outputs bitwise; the whole
    matches the plain version, and the workspace holds the plain sweep's
    scratch tensors."""
    B, L, C, H, K = 13, 3, 5, 40, 2
    with torch.no_grad():
        if multi:
            args, weights = _multi_args(cuda, K, B, L, C, H, 4, 1.0 / 17, 5)
            zs, qs = LF.fused_solve_multi_forward_cuda(*args, weights)
            plain = LF.fused_solve_multi_backward_plain
        else:
            args, weights = _solve_args(cuda, B, L, C, H, 4, 1.0 / 17, 5)
            zs, qs = LF.fused_solve_forward_cuda(*args, weights)
            plain = LF.fused_solve_backward_plain
        gz, gq = _cotangents(zs, qs, 6)
        bargs = (*args, weights, zs, gz, gq)
        whole, _ = LF._backward_cuda(*bargs, multi=multi)
        swept, ws = LF._backward_cuda(*bargs, multi=multi, stages=1)
        contracted, _ = LF._backward_cuda(*bargs, multi=multi, stages=2,
                                          workspace=ws)
        want = plain(*bargs)
        if multi:
            replicas = [_replica(args, weights, k) for k in range(K)]
            scratch = [torch.stack(t) for t in zip(*(
                LF.fused_solve_backward_sweep_plain(
                    *a_k, w_k, zs[k], gz[k], gq[k])[4]
                for k, (a_k, w_k) in enumerate(replicas)))]
        else:
            scratch = [t[None] for t in
                       LF.fused_solve_backward_sweep_plain(*bargs)[4]]
    torch.cuda.synchronize()
    _assert_grads_close(whole, want)
    assert all(torch.equal(a, b) for a, b in zip(whole[:3], swept[:3]))
    assert all(torch.equal(a, b) for a, b in zip(whole[3], contracted[3]))
    n = args[3].shape[-3]
    for got, plain in zip(LF.scratch_views(ws, B, L, H, n), scratch):
        plain = plain.reshape(got.shape)
        torch.testing.assert_close(
            got, plain, rtol=0,
            atol=max(1e-4, 3e-5 * float(plain.abs().max())))


@pytest.mark.parametrize("multi", [False, True])
def test_backward_in_windows(cuda, multi, monkeypatch):
    """With WORKSPACE_BYTES cut to a replica's workspace of two steps,
    kernel 2 (or 4) sweeps the solve in windows through its public wrapper:
    each replica's workspace stays within the bytes; dz0, dctx, dnoise and
    the g nets' gradients (summed on chip, their flushes carried across
    windows) are bitwise the one-window call's, the towers' within kernel
    2's tolerance of it (their float32 sums are chunked by window) and of
    the plain version in the same windows; two calls are bitwise equal;
    each replica of kernel 4 is bitwise kernel 2; the phases apart refuse
    windows."""
    _check_backward_in_windows(cuda, multi, monkeypatch, torch.float32)


@pytest.mark.parametrize("multi", [False, True])
def test_bf16_backward_in_windows(cuda, multi, monkeypatch):
    """test_backward_in_windows for the bf16 instantiations (mixed mode):
    a later window's first pre-step state is read from zs in bf16, and the
    skinny products take z0 only in the first window. The towers' bf16
    gradients within BF16_REL of the one-window call's and of the plain
    version in the same windows."""
    _check_backward_in_windows(cuda, multi, monkeypatch, torch.bfloat16)


def _check_backward_in_windows(cuda, multi, monkeypatch, dtype):
    B, L, C, H, K = 13, 3, 5, 40, 2
    with torch.no_grad():
        if multi:
            args, weights = _multi_args(cuda, K, B, L, C, H, 4, 1.0 / 17, 7,
                                        dtype=dtype)
            zs, qs = LF.fused_solve_multi_forward_cuda(*args, weights)
            wrapper = LF.fused_solve_multi_backward_cuda
            plain = LF.fused_solve_multi_backward_plain
        else:
            args, weights = _solve_args(cuda, B, L, C, H, 4, 1.0 / 17, 7,
                                        dtype=dtype)
            zs, qs = LF.fused_solve_forward_cuda(*args, weights)
            wrapper = LF.fused_solve_backward_cuda
            plain = LF.fused_solve_backward_plain
        gz, gq = _cotangents(zs.float(), qs, 8)
        bargs = (*args, weights, zs, gz.to(zs.dtype), gq)
        n = args[3].shape[-3]
        assert LF.bwd_window(B, L, C, H, n) == n
        one, _ = LF._backward_cuda(*bargs, multi=multi)
        lib = _build.load_library()
        suffix = "_bf16" if dtype == torch.bfloat16 else ""
        two_steps = getattr(lib, f"tsde_latent_fused_bwd_workspace{suffix}")(
            B, L, C, H, 2)
        assert two_steps == LF.workspace_floats(B, L, C, H, 2, dtype)
        monkeypatch.setattr(LF, "WORKSPACE_BYTES", 4 * two_steps)
        assert LF.bwd_window(B, L, C, H, n, dtype) == 2
        got = wrapper(*bargs)
        again = wrapper(*bargs)
        _, ws = LF._backward_cuda(*bargs, multi=multi)
        want = plain(*bargs, window=2)
        with pytest.raises(RuntimeError):
            LF._backward_cuda(*bargs, multi=multi, stages=1)
        if multi:
            singles = [LF.fused_solve_backward_cuda(*a_k, w_k, zs[k],
                                                    bargs[-2][k], gq[k])
                       for k, (a_k, w_k) in enumerate(
                           _replica(args, weights, k) for k in range(K))]
    torch.cuda.synchronize()
    assert 4 * ws.shape[1] <= LF.WORKSPACE_BYTES
    flat, flat_one = _flat(got), _flat(one)
    assert all(torch.equal(a, b) for a, b in zip(flat[:3] + flat[15:],
                                                 flat_one[:3] + flat_one[15:]))
    if dtype == torch.float32:
        _assert_grads_close(got, one)
        _assert_grads_close(got, want)
    else:
        for g, w1, w in zip(flat, flat_one, _flat(want)):
            assert g.dtype == w.dtype == w1.dtype
            assert torch.isfinite(g.float()).all()
            for other in (w1, w):
                scale = float(other.float().abs().max())
                torch.testing.assert_close(g.float(), other.float(), rtol=0,
                                           atol=BF16_REL * scale)
    assert all(torch.equal(a, b) for a, b in zip(flat, _flat(again)))
    if multi:
        for k, single in enumerate(singles):
            assert all(torch.equal(a[k], b)
                       for a, b in zip(flat, _flat(single)))


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
    """A set of dtypes that mixes the two modes is refused before any
    launch: a bf16 tensor among float32 ones, a float32 one among bf16
    ones (mixed mode), one bf16 weight among float32 ones."""
    args, weights = _solve_args(cuda, 8, 4, 8, 16, 4, 0.25, 2)
    bf_args, bf_weights = _solve_args(cuda, 8, 4, 8, 16, 4, 0.25, 2,
                                      dtype=torch.bfloat16)
    before = _latent_counts()
    with torch.no_grad(), pytest.raises(ValueError, match="bfloat16"):
        LF.fused_solve_forward(args[0], args[1], args[2],
                               args[3].bfloat16(), args[4], weights)
    zs = torch.zeros_like(args[3])
    qs = torch.zeros(zs.shape[:2] + (1,), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        LF.fused_solve_backward_cuda(*args, weights, zs, zs.bfloat16(), qs)
    with torch.no_grad(), pytest.raises(ValueError, match="float32"):
        LF.fused_solve_forward(bf_args[0], bf_args[1].float(), *bf_args[2:],
                               bf_weights)
    with torch.no_grad(), pytest.raises(ValueError):
        LF.fused_solve_forward(*args, [bf_weights[0], *weights[1:]])
    with pytest.raises(ValueError, match="bfloat16"):
        LF.fused_solve_backward_cuda(*bf_args, bf_weights, zs.bfloat16(),
                                     zs.bfloat16(), qs.bfloat16())
    assert _latent_counts() == before
    # The SDE-GAN kernels (5-8) likewise: bf16 noise with float32 weights,
    # float32 noise or a bf16 x0 with bf16 weights, one bf16 weight among
    # float32 ones, a bf16 cotangent; the critic's one bf16 weight among
    # float32 ones and bf16 slopes.
    gan_before = _gan_counts()
    with torch.no_grad():
        (x0, f0, g0, noise, t1s, dts), gw = _gan_gen_args(
            cuda, 8, 16, 16, 3, 4, 2)
        _, bw = _gan_gen_args(cuda, 8, 16, 16, 3, 4, 2, torch.bfloat16)
        for bad_args, bad_w in (
                ((x0, f0, g0, noise.bfloat16(), t1s, dts), gw),
                ((x0, f0, g0, noise, t1s, dts), bw),
                ((x0.bfloat16(), f0, g0, noise.bfloat16(), t1s, dts), bw),
                ((x0, f0, g0, noise, t1s, dts), (bw[0], *gw[1:]))):
            with pytest.raises(ValueError, match="bfloat16|float32"):
                GF.gen_solve_forward(*bad_args, bad_w)
        ys, zs_g, gs = GF.gen_solve_forward_cuda(x0, f0, g0, noise, t1s, dts,
                                                 gw)
        with pytest.raises(ValueError, match="bfloat16"):
            GF.gen_solve_backward_cuda(x0, f0, g0, noise, t1s, dts, gw, zs_g,
                                       gs, ys.bfloat16())
        cargs, cw = _gan_cde_args(cuda, 8, 17, 16, 2, 4, 2)
        with pytest.raises(ValueError, match="bfloat16"):
            GF.cde_solve_forward(*cargs, (*cw[:2], cw[2].bfloat16(), cw[3]))
        with pytest.raises(ValueError, match="bfloat16"):
            GF.cde_solve_forward(cargs[0], cargs[1], cargs[2].bfloat16(),
                                 *cargs[3:], cw)
    assert _gan_counts() == tuple(
        a + d for a, d in zip(gan_before, (1, 0, 0, 0, 0, 0, 0, 0)))


def _latent_counts():
    return (LF.launches, LF.bwd_launches, LF.bf16_launches,
            LF.bf16_bwd_launches)


# Kernels 1 and 2 in bf16 mixed mode against their mixed-mode plain
# versions, per tensor within 2^-7 of its scale, one to two bf16 ulps of
# its largest entry (the two sum each product in another order; passed on
# an NVIDIA H100 80GB HBM3 at 700 W; chip_smoke.BF16_REL, at the flagship,
# allows two).
BF16_REL = 2 ** -7


@pytest.mark.parametrize("B,L,C,H,n_ts,dt", SHAPES)
def test_cuda_route_takes_bf16_mixed_mode(cuda, B, L, C, H, n_ts, dt):
    """A consistent bf16 set (a bf16 model's _prep_solve) reaches the bf16
    instantiations of kernels 1 and 2, each launched once and the float32
    kernels never, with each output in its dtype and within BF16_REL of
    the mixed-mode plain versions."""
    args, weights = _solve_args(cuda, B, L, C, H, n_ts, dt, 4,
                                dtype=torch.bfloat16)
    before = _latent_counts()
    with torch.no_grad():
        got = LF.fused_solve_forward(*args, weights)
        gz, gq = _cotangents(got[0].float(), got[1], 5)
        gz = gz.bfloat16()
        got_b = LF.fused_solve_backward_cuda(*args, weights, got[0], gz, gq)
        want = LF.fused_solve_forward_plain(*args, weights)
        want_b = LF.fused_solve_backward_plain(*args, weights, got[0], gz, gq)
    torch.cuda.synchronize()
    assert _latent_counts() == tuple(
        a + d for a, d in zip(before, (0, 0, 1, 1)))
    for g, w in zip((*got, *_flat(got_b)), (*want, *_flat(want_b))):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        scale = float(w.float().abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=BF16_REL * scale)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert got_b[0].dtype == torch.float32
    assert all(d.dtype == torch.bfloat16 for d in _flat(got_b)[1:])


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


def _gan_gen_args(device, B, S, M, m, T, seed, dtype=torch.float32):
    from torchsde_tpu_torch.models.sde_gan import Generator
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Generator(1, 5, m, S, M, 1, init_mult2=0.5, dtype=dtype,
                      device=device,
                      generator=torch.Generator().manual_seed(seed))
    ts = np.arange(T, dtype=np.float64)
    x0 = torch.randn((B, S), generator=gen, device=device)
    return (GF.prep_generator_solve(model.func, x0, ts, gen, 1.0),
            GF.gen_weights(model.func))


def _gan_cde_args(device, B, S, M, C, T, seed, dtype=torch.float32):
    from torchsde_tpu_torch.models.sde_gan import Discriminator
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Discriminator(C - 1, S, M, 1, dtype=dtype, device=device,
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


def _gan_gen_backward_args(device, B, S, M, m, T, seed,
                           dtype=torch.float32):
    args, weights = _gan_gen_args(device, B, S, M, m, T, seed, dtype)
    ys, zs, gs = GF.gen_solve_forward_plain(*args, weights)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    gy = torch.randn(ys.shape, generator=gen, device=device)
    return (*args, weights, zs, gs, gy)


def _gan_cde_backward_args(device, B, S, M, C, T, seed, last_only=False,
                           dtype=torch.float32):
    args, weights = _gan_cde_args(device, B, S, M, C, T, seed, dtype)
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


# The GAN kernels' launch counters: the float32 entries', then the bf16
# mixed-mode entries'.
GAN_COUNTERS = ("gen_launches", "gen_bwd_launches", "cde_launches",
                "cde_bwd_launches", "bf16_gen_launches",
                "bf16_gen_bwd_launches", "bf16_cde_launches",
                "bf16_cde_bwd_launches")


def _gan_counts():
    return tuple(getattr(GF, c) for c in GAN_COUNTERS)


def _flat_gan(out):
    return [*out[:-1], *out[-1]]


# Kernels 5-8 in bf16 mixed mode (B, S, M, m, C, T, the critic's state) at
# the JAX bf16 test's widths (critic state 16), at the reference widths
# (critic state 17), and at the widest hidden layer with one channel, each
# with a ragged batch, against their mixed-mode plain versions: per tensor
# within GAN_BF16_REL of its scale, two bf16 ulps of its largest entry (the
# two sum each product in another order, which now and then flips the bf16
# rounding of a product's input; chip_smoke.py holds them to 2^-6 at the
# reference scale).
GAN_BF16_SHAPES = [(37, 16, 16, 3, 2, 6, 16), (37, 16, 16, 3, 2, 6, 17),
                   (5, 8, 32, 1, 1, 4, 32)]
GAN_BF16_REL = 2 ** -7


def _assert_bf16_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        scale = float(w.float().abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=GAN_BF16_REL * scale)


@pytest.mark.parametrize("B,S,M,m,C,T,Sc", GAN_BF16_SHAPES)
def test_gan_cuda_route_takes_bf16_mixed_mode(cuda, B, S, M, m, C, T, Sc):
    """A consistent mixed-mode set (bf16 models' prep_generator_solve and
    prep_cde_solve) reaches the bf16 instantiations of kernels 5-8, each
    launched once and the float32 kernels never, every output in its dtype
    (states, dx0, df0, dg0, dh0, dslopes float32; dnoise and the weights'
    gradients bf16) and within GAN_BF16_REL of the plain versions."""
    bf16 = torch.bfloat16
    before = _gan_counts()
    with torch.no_grad():
        args, weights = _gan_gen_args(cuda, B, S, M, m, T, 8, bf16)
        assert args[3].dtype == bf16 and args[0].dtype == torch.float32
        got = GF.gen_solve_forward_cuda(*args, weights)
        want = GF.gen_solve_forward_plain(*args, weights)
        gy = torch.randn(got[0].shape, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(9))
        bargs = (*args, weights, want[1], want[2], gy)
        got_b = GF.gen_solve_backward_cuda(*bargs)
        want_b = GF.gen_solve_backward_plain(*bargs)
        cargs, cw = _gan_cde_args(cuda, B, Sc, M, C, T, 10, bf16)
        got_c = GF.cde_solve_forward_cuda(*cargs, cw)
        want_c = GF.cde_solve_forward_plain(*cargs, cw)
        ghs = torch.randn(got_c[0].shape, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(11))
        cbargs = (*cargs, cw, want_c[1], ghs)
        got_cb = GF.cde_solve_backward_cuda(*cbargs)
        want_cb = GF.cde_solve_backward_plain(*cbargs)
    torch.cuda.synchronize()
    assert _gan_counts() == tuple(
        a + d for a, d in zip(before, (0, 0, 0, 0, 1, 1, 1, 1)))
    assert all(t.dtype == torch.float32 for t in (*got, *got_c))
    assert [t.dtype for t in got_b[:4]] == [torch.float32] * 3 + [bf16]
    assert all(d.dtype == bf16 for d in (*got_b[4], *got_cb[3]))
    assert all(t.dtype == torch.float32 for t in got_cb[:3])
    _assert_bf16_close(got, want)
    _assert_bf16_close(_flat_gan(got_b), _flat_gan(want_b))
    _assert_bf16_close(got_c, want_c)
    _assert_bf16_close(_flat_gan(got_cb), _flat_gan(want_cb))


# bf16 kernels 6 and 8 (the reverse sweeps on bf16 tensor cores, eight
# rows a group of warps) at every float32 GPU test shape, the reference
# widths of the bf16 GAN, a ragged batch of one row past a group, and a
# batch of more groups than two an SM, whose blocks hold several groups at
# 256 threads (each group on named barriers of its own): against their
# mixed-mode twins within GAN_BF16_REL of each tensor's scale, at 32 and
# 256 threads a block (which change the blocks, never a sum), each launch
# counted once, and two calls bitwise equal.
# The widths of the instantiations that no shape above reaches (each
# sweep's host rule picks one by the state's and hidden units' tiles and
# the channels: kernel 6 by m <= 3 or 8, kernel 8 by C <= 2, 4 or 8), so
# that every instantiation runs against its twin.
GAN_BF16_GEN_DESIGN_SHAPES = [(13, 24, 16, 2, 4), (21, 17, 32, 3, 3),
                              (11, 16, 12, 5, 4), (19, 10, 20, 8, 3),
                              (8, 32, 16, 4, 3)]
GAN_BF16_CDE_DESIGN_SHAPES = [(13, 24, 9, 2, 4), (10, 20, 32, 1, 3),
                              (11, 16, 12, 3, 4), (19, 9, 24, 3, 3),
                              (8, 32, 16, 4, 3), (7, 25, 30, 3, 3),
                              (12, 6, 10, 8, 4), (9, 16, 17, 5, 3),
                              (6, 18, 16, 7, 3)]
GAN_BF16_BWD_GEN_SHAPES = GEN_SHAPES + [(1024, 16, 16, 3, 8),
                                        (9, 16, 16, 3, 5),
                                        (4224, 16, 16, 3, 4)] \
    + GAN_BF16_GEN_DESIGN_SHAPES
GAN_BF16_BWD_CDE_SHAPES = CDE_SHAPES + [(2048, 17, 16, 2, 8),
                                        (37, 16, 16, 2, 6),
                                        (9, 17, 16, 2, 5),
                                        (4224, 17, 16, 2, 4)] \
    + GAN_BF16_CDE_DESIGN_SHAPES


def test_gan_bf16_bwd_shapes_reach_every_instantiation(cuda):
    """The shapes of the two tests below reach every instantiation of
    bf16 kernels 6 and 8 (tsde_gan_*_bwd_design_bf16: 100 channels + 10
    state tiles + hidden tiles): kernel 6's channels 3 or 8, kernel 8's 2,
    4 or 8, by one or two tiles of state and of hidden units each."""
    from torchsde_tpu_torch.ops import _build
    lib = _build.load_library()
    for name, shapes, channels in (
            ("gen", GAN_BF16_BWD_GEN_SHAPES, (3, 8)),
            ("cde", GAN_BF16_BWD_CDE_SHAPES, (2, 4, 8))):
        design = getattr(lib, f"tsde_gan_{name}_bwd_design_bf16")
        got = {design(S, M, k) for _, S, M, k, _ in shapes}
        assert got == {100 * c + 10 * u + h for c in channels
                       for u in (1, 2) for h in (1, 2)}, name


@pytest.mark.parametrize("B,S,M,m,T", GAN_BF16_BWD_GEN_SHAPES)
def test_gan_bf16_gen_backward_on_tensor_cores(cuda, B, S, M, m, T):
    with torch.no_grad():
        bargs = _gan_gen_backward_args(cuda, B, S, M, m, T, 20,
                                       torch.bfloat16)
        want = _flat_gan(GF.gen_solve_backward_plain(*bargs))
        runs = []
        for threads in (32, 256, 256):
            before = GF.bf16_gen_bwd_launches
            runs.append(_flat_gan(GF.gen_solve_backward_cuda(
                *bargs, threads=threads)))
            assert GF.bf16_gen_bwd_launches == before + 1
    torch.cuda.synchronize()
    _assert_bf16_close(runs[0], want)
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.parametrize("B,S,M,C,T", GAN_BF16_BWD_CDE_SHAPES)
def test_gan_bf16_cde_backward_on_tensor_cores(cuda, B, S, M, C, T):
    with torch.no_grad():
        bargs = _gan_cde_backward_args(cuda, B, S, M, C, T, 21,
                                       dtype=torch.bfloat16)
        want = _flat_gan(GF.cde_solve_backward_plain(*bargs))
        runs = []
        for threads in (32, 256, 256):
            before = GF.bf16_cde_bwd_launches
            runs.append(_flat_gan(GF.cde_solve_backward_cuda(
                *bargs, threads=threads)))
            assert GF.bf16_cde_bwd_launches == before + 1
    torch.cuda.synchronize()
    _assert_bf16_close(runs[0], want)
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def test_gan_bf16_route_trains_through_the_bf16_kernels(cuda):
    """gan_grads(fused=True) on bf16 models on the card: the bf16 kernels
    5-8 launch once each and the float32 ones never, the loss is float32,
    every gradient bf16 and finite, and two calls give the same bits."""
    from torchsde_tpu_torch.models.sde_gan import (Discriminator, Generator,
                                                   gan_grads, get_ou_data)
    init = torch.Generator().manual_seed(12)
    generator = Generator(1, 5, 3, 16, 16, 1, dtype=torch.bfloat16,
                          device=cuda, generator=init)
    critic = Discriminator(1, 16, 16, 1, dtype=torch.bfloat16, device=cuda,
                           generator=init)
    ts, real = get_ou_data(torch.Generator(device=cuda).manual_seed(13), 37,
                           6, device=cuda)
    runs = []
    for _ in range(2):
        before = _gan_counts()
        gen = torch.Generator(device=cuda).manual_seed(14)
        loss, g_gen, g_disc = gan_grads(generator, critic, gen, ts,
                                        real.bfloat16(), adjoint=False,
                                        fused=True)
        torch.cuda.synchronize()
        assert _gan_counts() == tuple(
            a + d for a, d in zip(before, (0, 0, 0, 0, 1, 1, 1, 1)))
        assert loss.dtype == torch.float32 and torch.isfinite(loss)
        grads = [*g_gen.values(), *g_disc.values()]
        assert all(g.dtype == torch.bfloat16
                   and torch.isfinite(g.float()).all() for g in grads)
        runs.append([loss, *grads])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


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


# Kernels 10, 12 and 14, each a chain sweep and a contraction of its
# scratch: (kind, case) of TOWER_CASES' Euler and reversible Heun solves
# and LOGQP_CASES.
SPLIT_CASES = [("euler" if c[0] == "euler" else "rh", c)
               for c in TOWER_CASES] + [("logqp", c) for c in LOGQP_CASES]
COUNTERS = {"euler": "euler_bwd_launches", "rh": "rh_bwd_launches",
            "logqp": "logqp_bwd_launches"}
SPLIT_IDS = [f"{k}-S{c[0] if k == 'logqp' else c[2]}"
             for k, c in SPLIT_CASES]


def _split_solve(device, kind, case, seed=0):
    """The backward kernel's arguments on a forward kernel's outputs, its
    launch function, the unsplit loop, the plain sweep, and the solve's
    batch and steps."""
    if kind == "euler":
        spec, args, gy = _tower_solve(device, case, seed)
        ys = FS.euler_solve_forward_cuda(*args)
        return ((*args, ys, gy), FS._euler_backward_cuda,
                unsplit_euler_backward, FS.euler_solve_backward_sweep_plain,
                args[0].shape[0], args[1].shape[0])
    if kind == "rh":
        spec, args, gy = _tower_solve(device, case, seed)
        _, zs, gs = FS.rh_solve_forward_cuda(*args)
        return ((*args, zs, gs, gy), FS._rh_backward_cuda,
                unsplit_rh_backward, FS.rh_solve_backward_sweep_plain,
                args[0].shape[0], args[3].shape[0])
    spec, args, gy, ginc = _logqp_solve(device, case, seed)
    ys, _ = FS.euler_logqp_solve_forward_cuda(*args)
    return ((*args, ys, gy, ginc), FS._euler_logqp_backward_cuda,
            unsplit_logqp_backward, FS.euler_logqp_solve_backward_sweep_plain,
            args[0].shape[0], args[1].shape[0])


@pytest.mark.parametrize("kind,case", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_tower_sweeps_match_the_unsplit_loops(cuda, kind, case):
    """Kernel 10, 12 or 14 (one launch a backward: the sweep, the contraction
    and the reduction) against the loop that sums every weight gradient
    step by step, on the card: max(1e-4, 1e-5 * scale) (with the JAX
    package's relative tolerance where the logqp diffusion takes both
    signs, as test_logqp_kernels_match_plain); two calls bitwise equal."""
    signed = kind == "logqp" and case[3][1][-1] in ("tanh", "linear")
    counter = COUNTERS[kind]
    with torch.no_grad():
        bargs, launch, unsplit, _, _, _ = _split_solve(cuda, kind, case)
        before = getattr(FS, counter)
        got, _ = launch(*bargs)
        again, _ = launch(*bargs)
        want = unsplit(*bargs)
    torch.cuda.synchronize()
    assert getattr(FS, counter) - before == 2
    _assert_close(got, want, 1e-4, 1e-5, 5e-3 if signed else 0.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("kind,case",
                         [SPLIT_CASES[1], SPLIT_CASES[4], SPLIT_CASES[-1]],
                         ids=["euler", "rh", "logqp"])
def test_split_tower_phases_match_whole_call(cuda, kind, case):
    """The sweep alone, then the contraction alone on its workspace, give
    the whole call's outputs bitwise; the workspace holds the plain sweep's
    scratch (scratch_views) within max(1e-4, 1e-5 * scale)."""
    with torch.no_grad():
        bargs, launch, _, sweep_plain, B, N = _split_solve(cuda, kind, case,
                                                           seed=2)
        whole, _ = launch(*bargs)
        swept, ws = launch(*bargs, stages=1)
        contracted, _ = launch(*bargs, stages=2, workspace=ws)
        scratch = sweep_plain(*bargs)[-1]
    torch.cuda.synchronize()
    n_chain = len(whole) - (3 if kind == "logqp" else 2)
    assert all(torch.equal(a, b) for a, b in zip(whole[:n_chain],
                                                 swept[:n_chain]))
    assert all(torch.equal(a, b) for a, b in zip(whole[n_chain:],
                                                 contracted[n_chain:]))
    spec = {"euler": bargs[6], "rh": bargs[8], "logqp": bargs[7]}[kind]
    for (vx, vd), (px, pd) in zip(FS.scratch_views(ws, spec, B, N),
                                  scratch):
        for v, t in zip(vx + vd, px + pd):
            t = t.reshape(v.shape)
            torch.testing.assert_close(
                v, t, rtol=0, atol=max(1e-4, 1e-5 * float(t.abs().max())))


@pytest.mark.parametrize("kind,case", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_tower_sweeps_in_windows(cuda, kind, case, monkeypatch):
    """With WORKSPACE_BYTES cut to the workspace of two steps, kernel 10,
    12 or 14 sweeps the solve in windows through its public wrapper: the
    workspace stays within the bytes; the chain's outputs are bitwise the
    one-window call's and the weight gradients within max(1e-4, 1e-5 *
    scale) of it (their float32 sums are chunked by window); two calls are
    bitwise equal, one launch each; the phases apart refuse windows."""
    counter = COUNTERS[kind]
    wrapper = {"euler": FS.euler_solve_backward_cuda,
               "rh": FS.rh_solve_backward_cuda,
               "logqp": FS.euler_logqp_solve_backward_cuda}[kind]
    with torch.no_grad():
        bargs, launch, _, _, B, N = _split_solve(cuda, kind, case, seed=3)
        spec = {"euler": bargs[6], "rh": bargs[8], "logqp": bargs[7]}[kind]
        assert FS.bwd_window(spec, B, N) == N
        one, _ = launch(*bargs)
        lib = _build.load_library()
        two_steps = lib.tsde_tower_bwd_workspace(FS._host_table(spec),
                                                 *FS._dims(spec), B, 2)
        monkeypatch.setattr(FS, "WORKSPACE_BYTES", 4 * two_steps)
        window = FS.bwd_window(spec, B, N)
        assert 1 <= window < N
        before = getattr(FS, counter)
        got = wrapper(*bargs)
        again = wrapper(*bargs)
        assert getattr(FS, counter) - before == 2
        _, ws = launch(*bargs)
        assert 4 * ws.numel() <= FS.WORKSPACE_BYTES
        with pytest.raises(RuntimeError):
            launch(*bargs, stages=1)
    torch.cuda.synchronize()
    n_chain = len(one) - (3 if kind == "logqp" else 2)
    assert all(torch.equal(a, b) for a, b in zip(got[:n_chain],
                                                 one[:n_chain]))
    _assert_close(got[n_chain:], one[n_chain:], 1e-4, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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


# --------------------------------------------------------------------------- #
#  K stacked latent replicas: kernels 3 and 4                                 #
# --------------------------------------------------------------------------- #

def _multi_args(device, K, B, L, C, H, n_ts, dt, seed, saturated=False,
                dtype=torch.float32):
    """K replicas' kernel inputs, stacked, from K models and generators."""
    per = [_solve_args(device, B, L, C, H, n_ts, dt, seed + k, saturated,
                       dtype)
           for k in range(K)]
    (_, _, idx, _, dts), _ = per[0]
    args = [torch.stack([p[0][i] for p in per]).contiguous()
            for i in (0, 1, 3)]
    weights = [torch.stack(ws).contiguous() for ws in zip(*(p[1]
                                                            for p in per))]
    return (args[0], args[1], idx, args[2], dts), weights


def _replica(args, weights, k):
    """Replica k's single-solve inputs and weights."""
    z0, ctx, idx, noise, dts = args
    return (z0[k], ctx[k], idx, noise[k], dts), [w[k] for w in weights]


@pytest.mark.parametrize("K", [1, 2, 4, 8])
@pytest.mark.parametrize("B,L,C,H,n_ts,dt", SHAPES)
def test_bf16_multi_forward_replicas_are_single_solves(cuda, K, B, L, C, H,
                                                       n_ts, dt):
    """Kernel 3 in bf16 mixed mode at K = 1, 2, 4 and 8 (other rows a block
    and register budgets as the grid grows): within BF16_REL of its plain
    version, and every replica bitwise kernel 1 on its own inputs; its
    blocks an SM and shared memory reported."""
    with torch.no_grad():
        args, weights = _multi_args(cuda, K, B, L, C, H, n_ts, dt, 20,
                                    dtype=torch.bfloat16)
        got = LF.fused_solve_multi_forward_cuda(*args, weights)
        want = LF.fused_solve_multi_forward_plain(*args, weights)
        singles = []
        for k in range(K):
            a_k, w_k = _replica(args, weights, k)
            singles.append(LF.fused_solve_forward_cuda(*a_k, w_k))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.isfinite(g.float()).all()
        torch.testing.assert_close(
            g.float(), w.float(), rtol=0,
            atol=BF16_REL * float(w.float().abs().max()))
    for k, one in enumerate(singles):
        assert all(torch.equal(a[k], b) for a, b in zip(got, one))
    lib = _build.load_library()
    assert lib.tsde_latent_fused_fwd_blocks_per_sm_bf16(
        K, B, L, C, H, cuda.index or 0) >= 1
    assert 0 < lib.tsde_latent_fused_fwd_smem_bytes_bf16(L, C, H) \
        <= _build.MAX_SMEM_BYTES


MULTI_SHAPES = [(3, 13, 3, 5, 40, 4, 1.0 / 17), (2, 9, 4, 64, 136, 6, 1.0 / 16),
                (5, 1, 1, 1, 1, 2, 0.5)]


@pytest.mark.parametrize("K,B,L,C,H,n_ts,dt", MULTI_SHAPES)
@pytest.mark.parametrize("saturated", [False, True])
def test_multi_kernels_match_plain_and_single_kernels(cuda, K, B, L, C, H,
                                                      n_ts, dt, saturated):
    """Kernels 3 and 4 against their plain versions (kernel 1's and 2's
    tolerances), and each replica bitwise equal to kernels 1 and 2 on its
    own inputs, with normal and with saturated diffusion."""
    with torch.no_grad():
        args, weights = _multi_args(cuda, K, B, L, C, H, n_ts, dt, 10,
                                    saturated)
        before = (LF.multi_launches, LF.multi_bwd_launches)
        zs, qs = LF.fused_solve_multi_forward_cuda(*args, weights)
        gen = torch.Generator(device=cuda).manual_seed(11)
        gz = 0.1 * torch.randn(zs.shape, generator=gen, device=cuda)
        gq = 0.1 * torch.randn(qs.shape, generator=gen, device=cuda)
        got = LF.fused_solve_multi_backward_cuda(*args, weights, zs, gz, gq)
        assert (LF.multi_launches, LF.multi_bwd_launches) == (before[0] + 1,
                                                              before[1] + 1)
        zs_p, qs_p = LF.fused_solve_multi_forward_plain(*args, weights)
        want = LF.fused_solve_multi_backward_plain(*args, weights, zs, gz,
                                                   gq)
        singles = []
        for k in range(K):
            a_k, w_k = _replica(args, weights, k)
            singles.append((LF.fused_solve_forward_cuda(*a_k, w_k),
                            LF.fused_solve_backward_cuda(*a_k, w_k, zs[k],
                                                         gz[k], gq[k])))
    torch.cuda.synchronize()
    for g, w in ((zs, zs_p), (qs, qs_p)):
        # Under saturated diffusion the KL grows to ~1e12: there the
        # forward kernels' rule relative to scale, max(1e-5, 4e-6 * scale).
        scale = float(w.abs().max()) if saturated else 0.0
        torch.testing.assert_close(g, w, rtol=0, atol=max(1e-5, 4e-6 * scale))
    _assert_grads_close(got, want)
    if saturated:        # only the u-path is masked: dz * dW reaches g
        assert max(float(d.abs().max()) for d in want[3][12:]) > 0
    for k, ((zs1, qs1), back1) in enumerate(singles):
        assert torch.equal(zs[k], zs1) and torch.equal(qs[k], qs1)
        assert all(torch.equal(a[k], b)
                   for a, b in zip(_flat(got), _flat(back1)))


def test_multi_forward_at_16_rows_is_kernel_1_bitwise(cuda):
    """Past one wave of 8-row blocks (K x B / 8 over the card's SMs) kernel
    3 takes 16 rows a block; each replica is still bitwise kernel 1 (8 rows
    a block) on its own inputs, and within kernel 1's tolerance of the
    plain version."""
    K, B, L, C, H = 3, 360, 3, 5, 40
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    lib = _build.load_library()
    if K * -(-B // 8) <= sms:
        pytest.skip(f"{sms} SMs take K x B / 8 blocks in one wave")
    assert lib.tsde_latent_fused_fwd_rows(K, B, L, C, H, cuda.index or 0) \
        == 16
    assert lib.tsde_latent_fused_fwd_rows(1, B, L, C, H, cuda.index or 0) \
        == 8
    with torch.no_grad():
        args, weights = _multi_args(cuda, K, B, L, C, H, 4, 1.0 / 13, 12)
        zs, qs = LF.fused_solve_multi_forward_cuda(*args, weights)
        zs_p, qs_p = LF.fused_solve_multi_forward_plain(*args, weights)
        singles = [LF.fused_solve_forward_cuda(*a_k, w_k) for a_k, w_k in
                   (_replica(args, weights, k) for k in range(K))]
    torch.cuda.synchronize()
    torch.testing.assert_close(zs, zs_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(qs, qs_p, rtol=0, atol=1e-5)
    for k, (zs1, qs1) in enumerate(singles):
        assert torch.equal(zs[k], zs1) and torch.equal(qs[k], qs1)


def test_multi_backward_is_bitwise_repeatable(cuda):
    with torch.no_grad():
        args, weights = _multi_args(cuda, 3, 37, 4, 16, 32, 6, 1.0 / 32, 3)
        zs, qs = LF.fused_solve_multi_forward_cuda(*args, weights)
        gz, gq = _cotangents(zs, qs, 4)
        first = _flat(LF.fused_solve_multi_backward_cuda(*args, weights, zs,
                                                         gz, gq))
        second = _flat(LF.fused_solve_multi_backward_cuda(*args, weights, zs,
                                                          gz, gq))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_multi_loss_trains_through_kernels_3_and_4(cuda):
    """latent_sde_loss_multi(fused=True) on the card: each replica's loss
    is the single fused loss on a clone of its generator, and a step's
    backward launches kernels 3 and 4 once."""
    from torchsde_tpu_torch.models.latent_sde import latent_sde_loss_multi
    from torchsde_tpu_torch.parallel import replicas as RP
    K = 3
    models = RP.stack_replicas(
        lambda g: LatentSDE(3, 4, 16, 32, device=cuda, generator=g),
        [torch.Generator().manual_seed(20 + k) for k in range(K)])
    xs = torch.randn((6, 37, 3), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(6))
    ts = np.linspace(0.0, 1.0, 6)
    gens = [torch.Generator(device=cuda).manual_seed(30 + k)
            for k in range(K)]
    before = (LF.multi_launches, LF.multi_bwd_launches)
    total, losses = latent_sde_loss_multi(models, xs, ts, gens,
                                          dt=1.0 / 32, fused=True)
    total.backward()
    assert (LF.multi_launches - before[0],
            LF.multi_bwd_launches - before[1]) == (1, 1)
    assert all(torch.isfinite(p.grad).all() for p in models.parameters())
    with torch.no_grad():
        for k in range(K):
            want, _ = latent_sde_loss(
                RP.unstack_replica(models, k), xs, ts,
                torch.Generator(device=cuda).manual_seed(30 + k),
                dt=1.0 / 32, fused=True)
            np.testing.assert_allclose(float(losses[k]), float(want),
                                       rtol=1e-5)


# --------------------------------------------------------------------------- #
#  srid2 SRK (kernel 15) and Philox normals (kernel 16)                       #
# --------------------------------------------------------------------------- #

def _srk_case(device, B, d, n, dtype, seed=0):
    from torchsde_tpu_torch.core import integrate as TI
    rng = np.random.default_rng(seed)
    sigma = 1 / (1 + np.exp(-rng.standard_normal(d)))
    mu = -sigma ** 2 - 1 / (1 + np.exp(-rng.standard_normal(d)))
    grid = TI.build_step_grid(0.0, 1.0, 1.0 / n)
    W, U, _ = TI.sample_grid_noise(
        torch.Generator(device=device).manual_seed(seed), grid, (B, d), dtype,
        device, needs_U=True)
    y0 = torch.as_tensor(rng.uniform(0.05, 0.2, (B, d)), dtype=dtype,
                         device=device)
    params = tuple(torch.as_tensor(p, dtype=dtype, device=device)
                   for p in (mu, sigma))
    return y0, W, U, params


@pytest.mark.parametrize("B,d,n", [(1, 1, 1), (37, 5, 9), (300, 3, 64),
                                   (2048, 16, 16), (1023, 7, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_srk_kernel_matches_plain(cuda, B, d, n, dtype):
    """Kernel 15 against its plain version, with a drift that reads t and a
    parameter-free diffusion too: 2e-5 of scale in float32, 1e-12 in
    float64, bitwise in bfloat16 (both round every operation's float32
    result, and the drift's 0.1 is rounded as the kernel's T(0.1))."""
    import torchsde_tpu_torch.ops.srk_fused as SF
    from torchsde_tpu_torch.utils.misc import weak_scalar
    f = SF.Elementwise(lambda t, y, mu, sigma: mu * y + weak_scalar(
        0.1, y.dtype) * torch.sin(t) * y, "p0 * y + T(0.1) * sin(t) * y")
    g = SF.Elementwise(lambda t, y, mu, sigma: sigma * y, "p1 * y")
    y0, W, U, params = _srk_case(cuda, B, d, n, dtype)
    counter = "bf16_launches" if dtype == torch.bfloat16 else "launches"
    before = getattr(SF, counter)
    got = SF.srk_solve_fused(f, g, y0, 0.25, 1.0 / n, n, W, U, params)
    assert getattr(SF, counter) == before + 1
    want = SF.srk_solve_plain(f, g, y0, 0.25, 1.0 / n, n, W, U, params)
    torch.cuda.synchronize()
    tol = {torch.float32: 2e-5, torch.float64: 1e-12,
           torch.bfloat16: 0.0}[dtype] * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    no_params = SF.Elementwise(lambda t, y: 0.3 * torch.ones_like(y), "0.3")
    drift = SF.Elementwise(lambda t, y: -y, "-y")
    got = SF.srk_solve_fused(drift, no_params, y0, 0.0, 1.0 / n, n, W, U)
    want = SF.srk_solve_plain(drift, no_params, y0, 0.0, 1.0 / n, n, W, U)
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_srk_bf16x2_arithmetic_matches_float32_rounding(cuda):
    """The bf16x2 instructions of bf16 kernel 15 (__hadd2_rn, __hsub2_rn,
    __hmul2_rn) and its pair type's + - * / against float32 rounded to
    bf16, over all 2^32 pairs of bf16 operands (subnormals, overflow and
    NaN among them; NaN matching NaN): no difference."""
    import torchsde_tpu_torch.ops.srk_fused as SF
    f = SF.Elementwise(lambda t, y, mu: mu * y, "p0 * y")
    check = SF.bf16x2_check(f, f, 1, cuda)
    assert set(check) == set(SF.BF16X2_OPS)
    for op, c in check.items():
        assert c["operator"] == 0, (op, c)
        assert op == "div" or c["instruction"] == 0, (op, c)
        assert c["native"] == (op != "div"), (op, c)


def test_srk_kernel_refuses_what_it_cannot_run(cuda):
    import torchsde_tpu_torch.ops.srk_fused as SF
    y0, W, U, params = _srk_case(cuda, 8, 2, 4, torch.float32)
    f = SF.Elementwise(lambda t, y, mu, sigma: mu * y, "p0 * y")
    with pytest.raises(ValueError, match="cuda_expr"):
        SF.srk_solve_fused(lambda t, y, mu, sigma: mu * y, f, y0, 0.0, 0.25,
                           4, W, U, params)
    with pytest.raises(ValueError, match="bfloat16, float32 or float64"):
        SF.srk_solve_fused(f, f, y0.half(), 0.0, 0.25, 4, W.half(), U.half(),
                           params)
    with pytest.raises(ValueError, match="must be contiguous"):
        SF.srk_solve_fused(f, f, y0, 0.0, 0.25, 4, W[:, :, :1], U, params)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        SF.srk_solve_fused(SF.Elementwise(f.torch_fn, "p0 * * y"), f, y0,
                           0.0, 0.25, 4, W, U, params)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5, 9), (128, 1024, 9)])
def test_philox_kernel_matches_plain(cuda, shape):
    import torchsde_tpu_torch.ops.prng as PR
    seed = torch.tensor([11], dtype=torch.int32, device=cuda)
    before = PR.launches
    got = PR.philox_normal(seed, shape)
    assert PR.launches == before + 1 and got.shape == shape
    want = PR.philox_normal_plain(seed, shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    torch.testing.assert_close(PR.philox_normal(11, shape, device=cuda), got,
                               rtol=0, atol=0)
    cpu = PR.philox_normal_plain(11, shape, device="cpu")
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=2e-6)


def test_sdeint_srk_philox_launches_kernel_16_twice(cuda):
    import torchsde_tpu_torch as ttsde
    import torchsde_tpu_torch.ops.prng as PR

    class Gbm(ttsde.SDEIto):
        def __init__(self):
            super().__init__(noise_type="diagonal")

        def f(self, t, y):
            return -0.5 * y

        def g(self, t, y):
            return 0.3 * y

    y0 = torch.ones((64, 3), device=cuda)
    before = PR.launches
    ys = ttsde.sdeint(Gbm(), y0, [0.0, 1.0], method="srk", dt=0.1,
                      rng_impl="philox",
                      generator=torch.Generator(device=cuda).manual_seed(1))
    assert PR.launches == before + 2 and torch.isfinite(ys).all()
    again = ttsde.sdeint(Gbm(), y0, [0.0, 1.0], method="srk", dt=0.1,
                         rng_impl="philox",
                         generator=torch.Generator(device=cuda).manual_seed(1))
    assert torch.equal(ys, again)


# Kernels 11 and 13 in their row-tile designs (fused_solve.forward_design):
# (kind, S, m, with_time, hidden widths, depth, B, N, signed diffusion) at
# R1, on general noise with time (depth 3), L1, L2 and the small signed
# solve, and at batches that are not a multiple of the rows a block (or
# cluster) or smaller than them.
FWD_TILE_CASES = [
    ("rh", 128, 128, False, 128, 2, 1024, 16, False),        # R1: cluster
    ("rh", 128, 128, False, 128, 2, 1000, 8, False),         # ragged
    ("rh", 128, 128, False, 128, 2, 5, 8, False),            # < 16 rows
    ("rh", 16, 4, True, 64, 3, 1024, 16, False),             # general
    ("logqp", 32, 32, False, 128, 2, 4096, 16, False),       # L1
    ("logqp", 32, 32, False, 128, 2, 4001, 8, False),        # ragged
    ("logqp", 128, 128, False, 128, 2, 1024, 8, False),      # L2: streamed
    ("logqp", 128, 128, False, 128, 2, 37, 8, False),        # cluster, < R
    ("logqp", 8, 8, True, 16, 2, 256, 32, True),             # small
]
FWD_TILE_IDS = [f"{c[0]}-S{c[1]}-m{c[2]}-B{c[6]}" for c in FWD_TILE_CASES]


def _fwd_tile_solve(device, case, seed=0):
    """The kind, spec and forward kernel's inputs of a FWD_TILE_CASES case;
    weights normal x 0.3/sqrt(fan_in) (0.8 for a signed diffusion ending in
    tanh)."""
    kind, S, m, wt, hidden, depth, B, N, signed = case
    rng = np.random.default_rng(seed)
    n_in = S + (1 if wt else 0)
    hs = [hidden] * (depth - 1)
    facts = ("softplus", "tanh")[:depth - 1] + ("linear",)
    gacts = (("lipswish", "tanh") if signed else
             ("lipswish", "softplus")[:depth - 1] + ("sigmoid",))
    diag = m == S
    G = S if diag else S * m
    drift = _tower(rng, [n_in, *hs, S], facts, 0.3, device)
    diffusion = _tower(rng, [n_in, *hs, G], gacts, 0.8 if signed else 0.3,
                       device)
    f32 = dict(dtype=torch.float32, device=device)
    y0 = torch.as_tensor(rng.standard_normal((B, S)), **f32)
    noise = torch.as_tensor(rng.standard_normal((N, B, m)) / np.sqrt(N),
                            **f32)
    t = torch.as_tensor(np.linspace(0.0, 1.0, N + 1), **f32)
    dts = t[1:] - t[:-1]
    if kind == "logqp":
        prior = _tower(rng, [n_in, *hs, S], facts, 0.3, device)
        spec = FS.solve_spec(drift, diffusion, S, S, True, wt, prior=prior)
        return FS.EULER_LOGQP_FWD, spec, (y0, noise, t[:-1], dts,
                                          drift.pack(), prior.pack(),
                                          diffusion.pack(), spec)
    spec = FS.solve_spec(drift, diffusion, S, m, diag, wt)
    x0 = FS.tower_input(t[0], y0, wt)
    fw, gw = drift.pack(), diffusion.pack()
    f0 = FS.tower_forward(x0, FS.unpack(fw, spec.drift), drift.acts)[0]
    g0 = FS.tower_forward(x0, FS.unpack(gw, spec.diffusion),
                          diffusion.acts)[0]
    return FS.RH_FWD, spec, (y0, f0, g0, noise, t[1:], dts, fw, gw, spec)


def _fwd_launch(kind):
    if kind == FS.RH_FWD:
        return FS.rh_solve_forward_cuda, FS.rh_solve_forward_plain
    return FS.euler_logqp_solve_forward_cuda, \
        FS.euler_logqp_solve_forward_plain


@pytest.mark.parametrize("case", FWD_TILE_CASES, ids=FWD_TILE_IDS)
def test_forward_tile_kernels_match_plain(cuda, case):
    """Kernels 11 and 13 in the rule's design against their twins: values
    within max(2e-5, 4e-6 * scale), each launched once, and at most twice
    the twin's distance from float64 plus 2e-5 (chip_smoke.py's rule; on a
    signed diffusion plus three times the twin's distance from float64,
    and 3e-3 of scale from float64, the JAX package's rtol)."""
    with torch.no_grad():
        kind, spec, args = _fwd_tile_solve(cuda, case)
        launch, plain = _fwd_launch(kind)
        counts = (FS.rh_launches, FS.logqp_launches)
        got = launch(*args)
        want = plain(*args)
        exact = plain(*[a.double() if torch.is_tensor(a) else a
                        for a in args])
    torch.cuda.synchronize()
    rh = kind == FS.RH_FWD
    assert (FS.rh_launches - counts[0],
            FS.logqp_launches - counts[1]) == ((1, 0) if rh else (0, 1))
    signed = case[-1]
    for g, w, e in zip(got, want, exact):
        assert g.shape == w.shape and torch.isfinite(g).all()
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        plain64 = float((w.double() - e).abs().max())
        # Where g passes near zero float32 itself is ill-conditioned: the
        # twin's own distance from float64, three times, joins the bound
        # (chip_smoke.py: check_against_plain).
        assert err <= max(2e-5, 4e-6 * scale) + (3 * plain64 if signed
                                                 else 0.0)
        assert float((g.double() - e).abs().max()) <= \
            2 * plain64 + 2e-5 + (3e-3 * scale if signed else 0.0)


# Designs each case is also run at: (cluster, rows, threads, staged).
FWD_DESIGNS = {
    FS.RH_FWD: ((1, 8, 256, 0), (1, 8, 512, 1), (1, 16, 512, 1),
                (1, 32, 256, 2), (2, 16, 512, 3), (2, 16, 256, 3),
                (2, 32, 512, 3)),
    FS.EULER_LOGQP_FWD: ((1, 8, 384, 0), (1, 16, 768, 5), (1, 32, 768, 7),
                         (1, 32, 384, 7), (1, 8, 768, 7), (3, 16, 512, 7),
                         (3, 32, 256, 7)),
}


@pytest.mark.parametrize("case", [FWD_TILE_CASES[i] for i in (2, 3, 7, 8)],
                         ids=[FWD_TILE_IDS[i] for i in (2, 3, 7, 8)])
def test_forward_designs_are_bitwise_equal(cuda, case):
    """Every design that fits gives the rule's design's bits (a row's
    arithmetic depends on neither the rows a block, the threads nor the
    cluster), and two calls agree bitwise; a design that does not fit a
    block is refused before any launch."""
    with torch.no_grad():
        kind, spec, args = _fwd_tile_solve(cuda, case, seed=3)
        launch, _ = _fwd_launch(kind)
        want = launch(*args)
        runs = [launch(*args)]
        for design in map(FS.FwdDesign._make, FWD_DESIGNS[kind]):
            if FS.fwd_smem_bytes(kind, spec, design.stage, design.rows,
                                 design.cluster) > _build.MAX_SMEM_BYTES:
                with pytest.raises(ValueError, match="shared memory"):
                    launch(*args, design=design)
                continue
            runs.append(launch(*args, design=design))
    torch.cuda.synchronize()
    assert len(runs) > 3
    for run in runs:
        assert all(torch.equal(a, b) for a, b in zip(run, want))


def test_forward_smem_bytes_match_the_c_layout(cuda):
    """fused_solve.fwd_smem_bytes (the host rule's) equals the C layout's
    tsde_tower_fwd_smem_bytes for every case, design and staging."""
    lib = _build.load_library()
    for case in FWD_TILE_CASES:
        kind, spec, _ = _fwd_tile_solve(torch.device("cpu"), case)
        towers = 3 if spec.prior else 2
        for cluster in (1, towers):
            for rows in FS.FWD_ROWS:
                for stage in range(1 << towers):
                    assert FS.fwd_smem_bytes(kind, spec, stage, rows,
                                             cluster) == \
                        lib.tsde_tower_fwd_smem_bytes(
                            kind, FS._host_table(spec), *FS._dims(spec),
                            stage, rows, cluster)


@pytest.mark.parametrize("budget_replicas", [1, 2])
def test_multi_backward_in_replica_groups(cuda, budget_replicas,
                                          monkeypatch):
    """With MULTI_WORKSPACE_BYTES cut to the workspaces of one or two
    replicas, kernel 4 runs K = 3 replicas in groups of that many: its
    workspace holds one group's, and every replica stays bitwise kernel 2
    on its own inputs and bitwise the one-group call's."""
    K, B, L, C, H = 3, 13, 3, 5, 40
    with torch.no_grad():
        args, weights = _multi_args(cuda, K, B, L, C, H, 4, 1.0 / 17, 21)
        zs, qs = LF.fused_solve_multi_forward_cuda(*args, weights)
        gz, gq = _cotangents(zs, qs, 22)
        bargs = (*args, weights, zs, gz, gq)
        n = args[3].shape[-3]
        assert LF.replica_group(K, B, L, C, H, n) == K
        whole = LF.fused_solve_multi_backward_cuda(*bargs)
        each = 4 * LF.workspace_floats(B, L, C, H, LF.bwd_window(B, L, C,
                                                                  H, n))
        monkeypatch.setattr(LF, "MULTI_WORKSPACE_BYTES",
                            budget_replicas * each)
        assert LF.replica_group(K, B, L, C, H, n) == budget_replicas
        before = LF.multi_bwd_launches
        got = LF.fused_solve_multi_backward_cuda(*bargs)
        assert LF.multi_bwd_launches == before + 1
        _, ws = LF._backward_cuda(*bargs, multi=True)
        singles = [LF.fused_solve_backward_cuda(*a_k, w_k, zs[k], gz[k],
                                                gq[k])
                   for k, (a_k, w_k) in enumerate(
                       _replica(args, weights, k) for k in range(K))]
    torch.cuda.synchronize()
    assert ws.shape[0] == budget_replicas
    assert 4 * ws.numel() <= LF.MULTI_WORKSPACE_BYTES
    assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(whole)))
    for k, single in enumerate(singles):
        assert all(torch.equal(a[k], b)
                   for a, b in zip(_flat(got), _flat(single)))


# Kernel 9's designs (fused_solve.forward_design): (S, m, with_time,
# hidden, depth, B, N) at E1, on general noise with time (depth 3), the
# narrow solve, a ragged batch and a batch under one block's rows.
EULER_CASES = [
    (32, 32, False, 128, 2, 4096, 16),      # E1: 3xTF32, 32 rows
    (16, 4, True, 64, 3, 1024, 16),         # general noise with time
    (8, 8, False, 16, 2, 256, 16),          # narrow
    (32, 32, False, 128, 2, 4001, 8),       # ragged
    (32, 32, False, 128, 2, 5, 8),          # under one block's rows
]
EULER_IDS = [f"S{c[0]}-m{c[1]}-B{c[5]}" for c in EULER_CASES]


def _euler_solve(device, case, seed=0):
    S, m, wt, hidden, depth, B, N = case
    tower_case = ("euler", m == S, S, m, wt,
                  ((hidden,) * (depth - 1),
                   ("softplus", "tanh")[:depth - 1] + ("linear",)),
                  ((hidden,) * (depth - 1),
                   ("lipswish", "softplus")[:depth - 1] + ("sigmoid",)),
                  B, N, 0.3)
    spec, args, _ = _tower_solve(device, tower_case, seed)
    return spec, args


@pytest.mark.parametrize("case", EULER_CASES, ids=EULER_IDS)
def test_euler_forward_mma_matches_plain_and_float64(cuda, case):
    """Kernel 9 in the rule's design (3xTF32 at E1's widths and batch, the
    FMA tiles on general noise and the narrow solve) and in the 3xTF32
    design of 32 rows, against its twin within max(2e-5, 4e-6 * scale) and
    at most twice the twin's distance from float64 plus 2e-5
    (chip_smoke.py's rules); one launch a call, two calls bitwise equal."""
    with torch.no_grad():
        spec, args = _euler_solve(cuda, case)
        design = FS.forward_design(FS.EULER_FWD, spec, case[5],
                                   FS._sm_count(cuda))
        assert design.mma == (case[0] == 32 and case[5] >= 4000)
        mma = FS.EulerFwdDesign(1, FS.MMA_ROWS, FS.mma_threads(spec), 3)
        before = FS.euler_launches
        runs = [(FS.euler_solve_forward_cuda(*args),
                 FS.euler_solve_forward_cuda(*args))]
        runs.append((FS.euler_solve_forward_cuda(*args, design=mma),
                     FS.euler_solve_forward_cuda(*args, design=mma)))
        want = FS.euler_solve_forward_plain(*args)
        exact = FS.euler_solve_forward_plain(
            *[a.double() if torch.is_tensor(a) else a for a in args])
    torch.cuda.synchronize()
    assert FS.euler_launches == before + 4
    scale = float(want.abs().max())
    plain64 = float((want.double() - exact).abs().max())
    for got, again in runs:
        assert torch.equal(got, again)
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= max(2e-5, 4e-6 * scale)
        assert float((got.double() - exact).abs().max()) <= \
            2 * plain64 + 2e-5


# Kernel 9's FMA tile designs (mma, rows, threads, staged): every one gives
# the bits of the 8-row design that streams both towers from L2, which
# the earlier kernel 9 ran.
EULER_FMA_DESIGNS = ((0, 8, 256, 0), (0, 8, 256, 3), (0, 16, 512, 3),
                     (0, 32, 512, 3), (0, 32, 256, 1), (0, 32, 768, 3))


@pytest.mark.parametrize("case", [EULER_CASES[i] for i in (0, 1, 2, 4)],
                         ids=[EULER_IDS[i] for i in (0, 1, 2, 4)])
def test_euler_forward_fma_designs_are_bitwise_the_8_row_design(cuda, case):
    """Stage a of kernel 9 (every tower in one block, FMA tiles) and every
    other FMA design that fits are bitwise the 8-row streamed design; the
    3xTF32 designs at 256 and 512 threads stay within the twin's tolerance
    of it."""
    with torch.no_grad():
        spec, args = _euler_solve(cuda, case, seed=2)
        want = FS.euler_solve_forward_cuda(
            *args, design=FS.EulerFwdDesign(*EULER_FMA_DESIGNS[0]))
        runs = []
        for design in map(FS.EulerFwdDesign._make, EULER_FMA_DESIGNS[1:]):
            if FS.fwd_smem_bytes(FS.EULER_FWD, spec, design.stage,
                                 design.rows, 1) > _build.MAX_SMEM_BYTES:
                continue
            runs.append(FS.euler_solve_forward_cuda(*args, design=design))
        mma = [FS.euler_solve_forward_cuda(
                   *args, design=FS.EulerFwdDesign(1, 32, threads, 3))
               for threads in (256, 512)
               if FS.fwd_smem_bytes(FS.EULER_FWD, spec, 3, 32, 1, mma=True)
               <= _build.MAX_SMEM_BYTES]
    torch.cuda.synchronize()
    assert len(runs) >= 3 and mma
    for run in runs:
        assert torch.equal(run, want)
    scale = float(want.abs().max())
    for run in mma:
        assert float((run - want).abs().max()) <= max(2e-5, 4e-6 * scale)


def test_euler_mma_smem_bytes_match_the_c_layout(cuda):
    """fused_solve.fwd_smem_bytes(mma=True) equals the C layout's
    tsde_tower_euler_fwd_mma_smem_bytes, and the FMA tiles'
    tsde_tower_fwd_smem_bytes, for every case, rows and staging."""
    lib = _build.load_library()
    for case in EULER_CASES:
        spec, _ = _euler_solve(torch.device("cpu"), case)
        table = FS._host_table(spec)
        nf, ng, _, S, m, diag, wt = FS._dims(spec)
        assert FS.fwd_smem_bytes(FS.EULER_FWD, spec, 3, 32, 1, mma=True) == \
            lib.tsde_tower_euler_fwd_mma_smem_bytes(table, nf, ng, S, m,
                                                    diag, wt)
        for rows in FS.FWD_ROWS:
            for stage in range(4):
                assert FS.fwd_smem_bytes(FS.EULER_FWD, spec, stage, rows,
                                         1) == \
                    lib.tsde_tower_fwd_smem_bytes(
                        FS.EULER_FWD, table, *FS._dims(spec), stage, rows, 1)


# Kernel 8 at the critic's reference scale (2048 rows, S 17, M 16, C 2, 64
# times: 63 steps), a ragged batch, and one and three control channels.
CDE_REF_SHAPES = [
    (2048, 17, 16, 2, 64),
    (2047, 17, 16, 2, 20),
    (300, 17, 16, 1, 20),
    (300, 9, 24, 3, 20),
]


@pytest.mark.parametrize("B,S,M,C,T", CDE_REF_SHAPES)
@pytest.mark.parametrize("last_only", [True, False], ids=["last", "dense"])
def test_cde_backward_matches_plain_and_float64(cuda, B, S, M, C, T,
                                                last_only):
    """Kernel 8 against its twin at max(1e-4, 1e-5 * scale) and at most
    twice the twin's distance from float64 plus 1e-4 (chip_smoke.py's
    rules), on last-state and dense cotangents; 1, 4 and 8 warps a block
    give the same bits, and two calls too."""
    with torch.no_grad():
        bargs = _gan_cde_backward_args(cuda, B, S, M, C, T, 4,
                                       last_only=last_only)
        want = GF.cde_solve_backward_plain(*bargs)
        exact = GF.cde_solve_backward_plain(
            *[tuple(w.double() for w in a) if isinstance(a, tuple)
              else a.double() for a in bargs])
        runs = {t: GF.cde_solve_backward_cuda(*bargs, threads=t)
                for t in (32, 128, 256)}
        again = GF.cde_solve_backward_cuda(*bargs)
    torch.cuda.synchronize()
    flat = [*want[:-1], *want[-1]]
    flat64 = [*exact[:-1], *exact[-1]]
    first = [*runs[32][:-1], *runs[32][-1]]
    for threads, got in runs.items():
        _assert_gan_grads_close(got, want)
        got = [*got[:-1], *got[-1]]
        for g, w, e in zip(got, flat, flat64):
            plain64 = float((w.double() - e).abs().max())
            assert float((g.double() - e).abs().max()) <= \
                2 * plain64 + 1e-4, threads
        assert all(torch.equal(a, b) for a, b in zip(got, first))
    assert all(torch.equal(a, b) for a, b in
               zip([*again[:-1], *again[-1]], first))


def test_cde_backward_smem_grows_with_warps(cuda):
    """Kernel 8's shared memory: the weights' lane-major copies once a
    block, then 32 x (3 + C) floats a warp for its rows' vectors."""
    lib = _build.load_library()
    for S, M, C in ((17, 16, 2), (9, 24, 3), (32, 32, 8)):
        one = lib.tsde_gan_cde_bwd_smem_bytes(S, M, C, 32)
        for threads in (64, 128, 256):
            assert lib.tsde_gan_cde_bwd_smem_bytes(S, M, C, threads) == \
                one + 4 * 32 * (3 + C) * (threads // 32 - 1)
        assert lib.tsde_gan_cde_bwd_smem_bytes(S, M, C, 256) \
            <= _build.MAX_SMEM_BYTES


# Kernels 6 and 7 with a row's vectors through the warp's shared memory:
# the reference scale (kernel 6: batch 1024, S 16, M 16, m 3; kernel 7: the
# critic's 2048 rows, S 17, M 16, C 2; 64 times: 63 steps), a ragged batch,
# one channel, a hidden layer wider than the state, and the widest widths.
GEN_REF_SHAPES = [
    (1024, 16, 16, 3, 64),
    (1023, 16, 16, 3, 20),
    (300, 16, 16, 1, 20),
    (300, 9, 24, 3, 20),
    (64, 32, 32, 8, 8),
]
CDE_FWD_REF_SHAPES = [
    (2048, 17, 16, 2, 64),
    (2047, 17, 16, 2, 20),
    (300, 17, 16, 1, 20),
    (300, 9, 24, 3, 20),
    (64, 32, 32, 8, 8),
]


def _in_double(args):
    return [tuple(w.double() for w in a) if isinstance(a, tuple)
            else a.double() for a in args]


@pytest.mark.parametrize("B,S,M,m,T", GEN_REF_SHAPES)
def test_gen_backward_blocks_match_plain_and_float64(cuda, B, S, M, m, T):
    """Kernel 6 against its twin at the tolerance max(1e-4, 1e-5 * scale)
    and at most twice the twin's distance from float64 plus the tolerance
    (PERF.md section 2) at 1, 2, 4 and 8 warps a block: all of them and a
    second call give the same bits."""
    with torch.no_grad():
        bargs = _gan_gen_backward_args(cuda, B, S, M, m, T, 5)
        want = GF.gen_solve_backward_plain(*bargs)
        exact = GF.gen_solve_backward_plain(*_in_double(bargs))
        before = GF.gen_bwd_launches
        runs = {t: GF.gen_solve_backward_cuda(*bargs, threads=t)
                for t in (32, 64, 128, 256)}
        again = GF.gen_solve_backward_cuda(*bargs)
        assert GF.gen_bwd_launches == before + 5
    torch.cuda.synchronize()
    flat = [*want[:-1], *want[-1]]
    flat64 = [*exact[:-1], *exact[-1]]
    first = [*runs[GF.THREADS][:-1], *runs[GF.THREADS][-1]]
    _assert_gan_grads_close(runs[GF.THREADS], want)
    for g, w, e in zip(first, flat, flat64):
        tol = max(1e-4, 1e-5 * float(w.abs().max()))
        plain64 = float((w.double() - e).abs().max())
        assert float((g.double() - e).abs().max()) <= 2 * plain64 + tol
    for threads, got in [*runs.items(), ("again", again)]:
        got = [*got[:-1], *got[-1]]
        assert all(torch.equal(a, b) for a, b in zip(got, first)), threads


@pytest.mark.parametrize("B,S,M,m,T", GEN_REF_SHAPES)
def test_gen_forward_matches_plain_and_float64(cuda, B, S, M, m, T):
    """Kernel 5 against its twin at the tolerance max(1e-5, 4e-6 * scale)
    and at most twice the twin's distance from float64 plus the tolerance
    (PERF.md section 2); 1, 2, 4 and 8 warps a block and a second call
    give the same bits."""
    with torch.no_grad():
        args, weights = _gan_gen_args(cuda, B, S, M, m, T, 7)
        want = GF.gen_solve_forward_plain(*args, weights)
        exact = GF.gen_solve_forward_plain(*_in_double(args),
                                           _in_double(weights))
        before = GF.gen_launches
        runs = {t: GF.gen_solve_forward_cuda(*args, weights, threads=t)
                for t in (32, 64, 128, 256)}
        again = GF.gen_solve_forward_cuda(*args, weights)
        assert GF.gen_launches == before + 5
    torch.cuda.synchronize()
    first = runs[GF.THREADS]
    for g, w, e in zip(first, want, exact):
        assert g.shape == w.shape and torch.isfinite(g).all()
        tol = max(1e-5, 4e-6 * float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol
        plain64 = float((w.double() - e).abs().max())
        assert float((g.double() - e).abs().max()) <= 2 * plain64 + tol
    for threads, got in [*runs.items(), ("again", again)]:
        assert all(torch.equal(a, b) for a, b in zip(got, first)), threads


@pytest.mark.parametrize("B,S,M,C,T", CDE_FWD_REF_SHAPES)
def test_cde_forward_matches_plain_and_float64(cuda, B, S, M, C, T):
    """Kernel 7 against its twin at the tolerance max(1e-5, 4e-6 * scale)
    and at most twice the twin's distance from float64 plus the tolerance
    (PERF.md section 2); 1, 2, 4 and 8 warps a block and a second call
    give the same bits."""
    with torch.no_grad():
        args, weights = _gan_cde_args(cuda, B, S, M, C, T, 6)
        want = GF.cde_solve_forward_plain(*args, weights)
        exact = GF.cde_solve_forward_plain(*_in_double(args),
                                           _in_double(weights))
        runs = {t: GF.cde_solve_forward_cuda(*args, weights, threads=t)
                for t in (32, 64, 128, 256)}
        again = GF.cde_solve_forward_cuda(*args, weights)
    torch.cuda.synchronize()
    first = runs[GF.THREADS]
    for g, w, e in zip(first, want, exact):
        assert g.shape == w.shape and torch.isfinite(g).all()
        tol = max(1e-5, 4e-6 * float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol
        plain64 = float((w.double() - e).abs().max())
        assert float((g.double() - e).abs().max()) <= 2 * plain64 + tol
    for threads, got in [*runs.items(), ("again", again)]:
        assert all(torch.equal(a, b) for a, b in zip(got, first)), threads


def test_gan_kernels_6_and_7_smem_bytes_match_the_host_layout(cuda):
    """The C layouts of kernels 6 and 7 (tsde_gan_gen_bwd_smem_bytes,
    tsde_gan_cde_fwd_smem_bytes) are their host mirrors in gan_fused,
    within a block's shared memory."""
    lib = _build.load_library()
    for S, M, m in ((16, 16, 3), (17, 16, 2), (9, 24, 3), (32, 32, 8),
                    (1, 1, 1), (16, 16, 8)):
        for threads in (32, 64, 128, 256):
            assert lib.tsde_gan_cde_fwd_smem_bytes(S, M, m, threads) == \
                GF.cde_fwd_smem_bytes(S, M, m, threads)
            smem = GF.gen_bwd_smem_bytes(S, M, m, threads)
            assert lib.tsde_gan_gen_bwd_smem_bytes(S, M, m, threads) == smem
            assert smem <= _build.MAX_SMEM_BYTES


def test_gan_kernel_5_smem_bytes_match_the_host_layout(cuda):
    """Kernel 5's C layout (tsde_gan_gen_fwd_smem_bytes) is its host mirror
    in gan_fused, grows by a warp's slots with each warp, and fits a
    block's shared memory."""
    lib = _build.load_library()
    for S, M, m in ((16, 16, 3), (16, 16, 1), (9, 24, 3), (32, 32, 8),
                    (1, 1, 1), (16, 16, 8), (8, 32, 1)):
        one = lib.tsde_gan_gen_fwd_smem_bytes(S, M, m, 32)
        for threads in (32, 64, 128, 256):
            smem = GF.gen_fwd_smem_bytes(S, M, m, threads)
            assert lib.tsde_gan_gen_fwd_smem_bytes(S, M, m, threads) == smem
            assert smem == one + 4 * GF.gen_fwd_layout(S, M, m)["warp"] * (
                threads // 32 - 1)
            assert smem <= _build.MAX_SMEM_BYTES


# --------------------------------------------------------------------------- #
#  BrownianInterval and the fixed-step solvers on the card                    #
# --------------------------------------------------------------------------- #

BM_GRID = np.linspace(0.0, 1.0, 101)


def _interval(size, levy, device, **kw):
    return BrownianInterval(0.0, 1.0, size, dtype=torch.float32, entropy=77,
                            levy_area_approximation=levy, device=device,
                            **kw)


@pytest.mark.parametrize("levy", ["none", "space-time", "foster"])
@pytest.mark.parametrize("size", [(16, 5), (8, 33)])
def test_brownian_interval_on_the_card_matches_the_cpu(cuda, levy, size):
    rU, rA = levy != "none", levy == "foster"
    bm, bm_cpu = _interval(size, levy, cuda), _interval(size, levy, "cpu")
    bits_dev, starts_dev, full_dev = bm._resolve(
        torch.as_tensor(BM_GRID, device=cuda))
    bits, starts, full = bm_cpu._resolve(BM_GRID)
    depth = bits.shape[1]
    assert torch.equal(bits_dev[:, :depth].cpu(), bits)
    assert not bits_dev[:, depth:].any()
    assert torch.equal(full_dev.cpu(), full)
    assert torch.equal(starts_dev.cpu(), starts)
    _, _, words, _ = bm._prefix_at(BM_GRID)
    _, _, words_cpu, _ = bm_cpu._prefix_at(BM_GRID)
    assert torch.equal(words.cpu(), words_cpu)
    keys, keys_cpu = TF.split(bm._key_nodes, 16), TF.split(bm_cpu._key_nodes,
                                                           16)
    assert torch.equal(keys.cpu(), keys_cpu)
    for bits_of in (lambda k: TF.random_bits(k, size),
                    lambda k: TF.random_bits(k, size, 64),
                    lambda k: TF.uniform(k, size),
                    lambda k: TF.uniform(k, size, torch.float64)):
        assert torch.equal(bits_of(keys).cpu(), bits_of(keys_cpu))
    got = bm.query_grid(BM_GRID, return_U=rU, return_A=rA)
    again = bm.query_grid(BM_GRID, return_U=rU, return_A=rA)
    want = bm_cpu.query_grid(BM_GRID, return_U=rU, return_A=rA)
    for name, g, a, w in zip("WUA", got, again, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert torch.equal(g, a)
        tol = 1e-4 if name == "A" else 2e-5
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=tol)
    pts = np.sort(np.random.default_rng(1).uniform(0.0, 1.0, 5))
    pairs = ((0, 4), (1, 2), (2, 3), (3, 3))
    on_card = bm.query_pairs(torch.as_tensor(pts, device=cuda), pairs,
                             return_U=rU, return_A=rA)
    for (i, j), out in zip(pairs, on_card):
        call = bm(float(pts[i]), float(pts[j]), return_U=rU, return_A=rA)
        for x, y in zip(out if isinstance(out, tuple) else (out,),
                        call if isinstance(call, tuple) else (call,)):
            assert torch.equal(x, y)


class _SolveSDE(torch.nn.Module):
    def __init__(self, sde_type, G=None):
        super().__init__()
        self.sde_type = sde_type
        self.noise_type = "diagonal" if G is None else "general"
        self.G = G

    def f(self, t, y):
        return y

    def g(self, t, y):
        g = torch.sigmoid(-y)
        return g if self.G is None else g[..., None] * self.G


@pytest.mark.parametrize("method,sde_type,options", [
    ("euler", "ito", None), ("srk", "ito", None), ("milstein", "ito", None),
    ("milstein", "ito", {"grad_free": True}),
    ("reversible_heun", "stratonovich", None),
    ("midpoint", "stratonovich", None), ("heun", "stratonovich", None),
    ("euler_heun", "stratonovich", None),
    ("milstein", "stratonovich", None), ("log_ode", "stratonovich", None)])
def test_fixed_step_solves_on_the_card_match_the_cpu(cuda, method, sde_type,
                                                     options):
    levy = {"srk": "space-time", "log_ode": "foster"}.get(method, "none")
    B, m = 32, 4
    ts = np.linspace(0.0, 1.0, 11)
    G = None
    if method == "log_ode":
        G = torch.as_tensor(np.random.default_rng(2).normal(size=(m, m)) / 2,
                            dtype=torch.float32)
    out = []
    for device in (cuda, torch.device("cpu")):
        sde = _SolveSDE(sde_type, None if G is None else G.to(device))
        with torch.no_grad():
            out.append(sdeint(sde, torch.zeros((B, m), device=device), ts,
                              bm=_interval((B, m), levy, device, levels=20),
                              method=method, dt=0.01, options=options))
    assert torch.isfinite(out[0]).all()
    torch.testing.assert_close(out[0].cpu(), out[1], rtol=0,
                               atol=1e-4 * (1 + float(out[1].abs().max())))


class _NamedDevice(BaseBrownian):
    """A user's Brownian object that reports its device by name."""

    def __init__(self, bm, device):
        self.bm, self.device = bm, device

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        return self.bm(ta, tb, return_U=return_U, return_A=return_A)

    def query_grid(self, grid, return_U=False, return_A=False):
        return self.bm.query_grid(grid, return_U=return_U, return_A=return_A)

    dtype = property(lambda self: self.bm.dtype)
    shape = property(lambda self: self.bm.shape)
    levy_area_approximation = property(
        lambda self: self.bm.levy_area_approximation)


@pytest.mark.parametrize("name", ["cuda", "cuda:0"])
def test_bm_named_cuda_solves_with_y0_on_cuda_0(cuda, name):
    """``"cuda"`` names the current card: a bm reporting it solves beside a
    y0 on ``cuda:0``, bitwise the interval it wraps."""
    bm = _interval((8, 3), "none", cuda, levels=20)
    y0 = torch.zeros((8, 3), device="cuda:0")
    sde = _SolveSDE("stratonovich")
    with torch.no_grad():
        want = sdeint(sde, y0, np.linspace(0.0, 1.0, 5), bm=bm,
                      method="midpoint", dt=0.05)
        got = sdeint(sde, y0, np.linspace(0.0, 1.0, 5),
                     bm=_NamedDevice(bm, name), method="midpoint", dt=0.05)
    assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
#  sdeint_adjoint (no kernel: plain PyTorch) on the card                      #
# --------------------------------------------------------------------------- #

class _GridTable(BaseBrownian):
    """Fixed increments of one grid, on one device."""

    def __init__(self, W, levy="none"):
        self.W, self.levy = W, levy

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        raise NotImplementedError

    def query_grid(self, grid, return_U=False, return_A=False):
        assert len(grid) - 1 == self.W.shape[0]
        return self.W, None, None

    shape = property(lambda self: tuple(self.W.shape[1:]))
    dtype = property(lambda self: self.W.dtype)
    device = property(lambda self: self.W.device)
    levy_area_approximation = property(lambda self: self.levy)


class _TanhSDE(torch.nn.Module):
    """A diagonal Itô SDE with a tower drift, a context buffer and a
    state-dependent diffusion, so the Milstein adjoint's every term is
    live."""
    noise_type, sde_type = "diagonal", "ito"

    def __init__(self, d, device, dtype, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.w = torch.nn.Parameter((torch.randn((d, d), generator=gen)
                                     / d ** 0.5).to(device, dtype))
        self.s = torch.nn.Parameter(
            (0.3 + 0.1 * torch.rand(d, generator=gen)).to(device, dtype))

    def f(self, t, y):
        return torch.tanh(y @ self.w) - y + self.ctx

    def g(self, t, y):
        return self.s * torch.sin(y) + 0.5


@pytest.mark.parametrize("method", ["euler", "milstein", "reversible_heun"])
def test_adjoint_on_the_card_matches_the_cpu(cuda, method):
    """Loss gradients of sdeint_adjoint in float64 on the card against the
    CPU's on one table of increments: parameters, y0 and a buffer computed
    upstream."""
    from torchsde_tpu_torch import sdeint_adjoint
    from torchsde_tpu_torch.core.integrate import build_interval_grid
    B, d, ts, dt = 64, 6, [0.0, 0.13, 0.3, 0.5], 0.05
    grid = build_interval_grid(ts, dt)[0]
    gen = torch.Generator().manual_seed(7)
    W = torch.randn((len(grid) - 1, B, d), generator=gen,
                    dtype=torch.float64) * dt ** 0.5
    y0 = torch.randn((B, d), generator=gen, dtype=torch.float64)
    out = []
    for device in (cuda, torch.device("cpu")):
        sde = _TanhSDE(d, device, torch.float64)
        if method == "reversible_heun":
            sde.sde_type = "stratonovich"
        base = torch.linspace(-0.2, 0.2, d, dtype=torch.float64,
                              device=device, requires_grad=True)
        sde.register_buffer("ctx", base * 2.0)
        y = y0.to(device).requires_grad_()
        ys = sdeint_adjoint(sde, y, ts, bm=_GridTable(W.to(device)),
                            method=method, dt=dt)
        loss = (ys ** 2).sum() + ys[1].sum()
        out.append([g.cpu() for g in torch.autograd.grad(
            loss, [y, base, sde.w, sde.s])])
    for got, want in zip(*out):
        assert float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


def test_philox_adjoint_redraws_the_forward_noise_bitwise(cuda):
    """Under rng_impl='philox' the backward's W is bitwise the forward's,
    each drawn by kernel 16, and the generator ends as the forward left it;
    the gradients repeat bitwise."""
    import torchsde_tpu_torch.core.integrate as TI
    from torchsde_tpu_torch import sdeint_adjoint
    from torchsde_tpu_torch.ops import prng
    sde = _TanhSDE(8, cuda, torch.float32)
    sde.ctx = torch.zeros(8, device=cuda)
    drawn, grid_noise = [], TI.sample_grid_noise

    def recorded(*args, **kw):
        noise = grid_noise(*args, **kw)
        drawn.append(noise[0].clone())
        return noise

    grads = []
    for _ in range(2):
        TI.sample_grid_noise = recorded
        prng.launches = 0
        try:
            gen = torch.Generator(device=cuda).manual_seed(3)
            ys = sdeint_adjoint(sde, torch.ones((256, 8), device=cuda),
                                [0.0, 0.5, 1.0], dt=0.05, method="euler",
                                generator=gen, rng_impl="philox")
            state = gen.get_state()
            grads.append(torch.autograd.grad(ys.square().sum(),
                                             [sde.w, sde.s]))
            torch.cuda.synchronize()
        finally:
            TI.sample_grid_noise = grid_noise
        assert prng.launches == 2
        assert torch.equal(gen.get_state(), state)
    assert len(drawn) == 4 and all(torch.equal(drawn[0], w) for w in drawn)
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_gan_adjoint_gradients_match_the_fused_route(cuda):
    """A small gan_grads at the default adjoint=True (the reversible pair)
    against the fused route's (kernels 5-8) on one generator seed."""
    from torchsde_tpu_torch.models.sde_gan import (Discriminator, Generator,
                                                   gan_grads)
    ts = torch.linspace(0.0, 9.0, 10, device=cuda)
    real = torch.randn((32, 10, 2), generator=torch.Generator().manual_seed(
        1)).to(cuda)
    real[..., 0] = ts
    out = {}
    for fused in (False, True):
        wgen = torch.Generator().manual_seed(0)
        models = (Generator(1, 5, 3, 16, 16, 1, device=cuda, generator=wgen),
                  Discriminator(1, 17, 16, 1, device=cuda, generator=wgen))
        gen = torch.Generator(device=cuda).manual_seed(5)
        out[fused] = gan_grads(*models, gen, ts, real, fused=fused)
    for i in (1, 2):
        for name, want in out[True][i].items():
            got = out[False][i][name]
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-5 * max(scale,
                                                                 1e-3), name


class _ExDiagonal(torch.nn.Module):
    """dy = mu y dt + sigma y dW (Ito, diagonal noise)."""
    noise_type, sde_type = "diagonal", "ito"

    def __init__(self, device, d=3):
        super().__init__()
        rng = np.random.default_rng(0)
        sigma = 1 / (1 + np.exp(-rng.standard_normal(d)))
        mu = -sigma ** 2 - 1 / (1 + np.exp(-rng.standard_normal(d)))
        self.mu = torch.nn.Parameter(torch.as_tensor(mu, device=device))
        self.sigma = torch.nn.Parameter(torch.as_tensor(sigma, device=device))

    def f(self, t, y):
        return self.mu * y

    def g(self, t, y):
        return self.sigma * y


@pytest.mark.parametrize("method,levy", [("srk", "space-time"),
                                         ("milstein", "none")])
def test_adaptive_on_the_card_matches_the_cpu(cuda, method, levy):
    out = []
    for device in (cuda, torch.device("cpu")):
        bm = BrownianInterval(0.0, 1.0, (64, 3), dtype=torch.float64,
                              entropy=42, levels=16,
                              levy_area_approximation=levy, device=device)
        with torch.no_grad():
            out.append(sdeint(_ExDiagonal(device), torch.full(
                (64, 3), 0.1, dtype=torch.float64, device=device),
                np.linspace(0.0, 1.0, 5), bm=bm, method=method, dt=1e-2,
                adaptive=True, rtol=1e-4, atol=1e-5, return_stats=True))
    (ys, stats), (want, want_stats) = out
    assert stats == want_stats and stats["n_accepted"] > 4
    scale = 1.0 + float(want.abs().max())
    assert float((ys.cpu() - want).abs().max()) <= 1e-9 * scale


@pytest.mark.parametrize("mode", ["backprop", "adaptive", "adjoint_adaptive"])
def test_adaptive_gradients_on_the_card_match_the_cpu(cuda, mode):
    from torchsde_tpu_torch import sdeint_adjoint
    kw = dict(method="milstein", dt=0.05)
    solve = sdeint_adjoint
    if mode == "backprop":
        solve = sdeint
        kw.update(adaptive=True, rtol=1e-4, atol=1e-5)
    else:
        kw.update({mode: True, "rtol": 1e-4, "atol": 1e-5,
                   "adjoint_rtol": 1e-4, "adjoint_atol": 1e-5})
    out = []
    for device in (cuda, torch.device("cpu")):
        bm = BrownianInterval(0.0, 0.5, (32, 3), dtype=torch.float64,
                              entropy=7, levels=14, device=device)
        sde = _ExDiagonal(device)
        y0 = torch.full((32, 3), 0.1, dtype=torch.float64, device=device,
                        requires_grad=True)
        ys = solve(sde, y0, [0.0, 0.25, 0.5], bm=bm, **kw)
        out.append([g.cpu() for g in torch.autograd.grad(
            (ys ** 2).sum() + ys[1].sum(), [y0, sde.mu, sde.sigma])])
    for got, want in zip(*out):
        assert float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-9 * float(want.abs().max()))


class _StratDiagonal(_ExDiagonal):
    """_ExDiagonal read as a Stratonovich SDE."""
    sde_type = "stratonovich"


def test_reversible_pair_in_loop_on_the_card(cuda):
    """The reversible-Heun pair with its noise made in the loop on the
    card: on an explicit interval its gradients are bitwise the
    precomputed pair's; on the default keyed stream they are backprop's
    through sdeint on the same stream (one generator seed) at 1e-9 of
    scale."""
    from torchsde_tpu_torch import sdeint_adjoint
    sde = _StratDiagonal(cuda)

    def grads(solve, **kw):
        y0 = torch.full((64, 3), 0.1, dtype=torch.float64, device=cuda,
                        requires_grad=True)
        ys = solve(sde, y0, [0.0, 0.5, 1.0], method="reversible_heun",
                   dt=1 / 32, **kw)
        return torch.autograd.grad((ys ** 2).sum(), [y0, sde.mu, sde.sigma])

    bm = BrownianInterval(0.0, 1.0, (64, 3), dtype=torch.float64, entropy=3,
                          levels=16, device=cuda)
    a, c = (grads(sdeint_adjoint, bm=bm, noise_precompute=p)
            for p in (True, False))
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    got, want = (grads(solve, noise_precompute=False,
                       generator=torch.Generator(device=cuda).manual_seed(4))
                 for solve in (sdeint_adjoint, sdeint))
    scale = max(float(w.abs().max()) for w in want)
    assert max(float((g - w).abs().max())
               for g, w in zip(got, want)) < 1e-9 * scale


def test_in_loop_noise_on_the_card(cuda):
    """An explicit interval queried per step is bitwise its precomputed
    noise on the card; the default stream made in the loop on one key is
    the CPU's to the rounding of erfinv."""
    import torchsde_tpu_torch.core.integrate as TI
    sde = _ExDiagonal(cuda).float()
    y0 = torch.full((256, 3), 0.1, device=cuda)
    bm = BrownianInterval(0.0, 1.0, (256, 3), entropy=3, levels=16,
                          levy_area_approximation="space-time", device=cuda)
    with torch.no_grad():
        a, c = (sdeint(sde, y0, [0.0, 0.5, 1.0], bm=bm, method="srk",
                       dt=1 / 64, noise_precompute=p) for p in (True, False))
    assert torch.equal(a, c)
    key = torch.tensor([0, 42], dtype=torch.int64)
    t0, t1 = torch.tensor(0.25), torch.tensor(0.5)
    want = TI.make_iid_noise_fn(key, (256, 3), torch.float32, True)(
        5, t0, t1)
    got = TI.make_iid_noise_fn(key.to(cuda), (256, 3), torch.float32, True)(
        5, t0.to(cuda), t1.to(cuda))
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=2e-6)


# --------------------------------------------------------------------------- #
#  Traced ts and the continuous DDPM (no kernel: plain PyTorch)               #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("entry", ["sdeint", "sdeint_adjoint"])
@pytest.mark.parametrize("noise_precompute", [True, False],
                         ids=["precomputed", "in_loop"])
def test_traced_ts_on_the_card_matches_the_cpu(cuda, entry,
                                               noise_precompute):
    """A traced ``ts`` (a CUDA tensor that requires grad) in float64: the
    values and the gradients to ``ts``, ``y0`` and the parameters against
    the CPU's on one explicit interval, at 1e-9 of scale."""
    import torchsde_tpu_torch as ttsde
    out = []
    for device in (cuda, torch.device("cpu")):
        bm = BrownianInterval(0.0, 1.0, (64, 3), dtype=torch.float64,
                              entropy=5, levels=16, device=device)
        sde = _ExDiagonal(device)
        y0 = torch.full((64, 3), 0.1, dtype=torch.float64, device=device,
                        requires_grad=True)
        ts = torch.tensor([0.0, 0.137, 0.5, 0.91], dtype=torch.float64,
                          device=device, requires_grad=True)
        ys = getattr(ttsde, entry)(sde, y0, ts, bm=bm, method="milstein",
                                   dt=1 / 32,
                                   noise_precompute=noise_precompute)
        out.append([ys.detach().cpu()] + [g.cpu() for g in torch.autograd.grad(
            (ys ** 2).sum() + ys[1].sum(), [ts, y0, sde.mu, sde.sigma])])
    for got, want in zip(*out):
        assert bool(torch.isfinite(want).all())
        assert float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-9 * float(want.abs().max()))


def test_traced_ts_poison_on_the_card(cuda):
    """A schedule past the interval's end is NaN on the card, values and
    gradients."""
    bm = BrownianInterval(0.0, 1.0, (64, 3), dtype=torch.float64, entropy=5,
                          levels=16, device=cuda)
    sde = _ExDiagonal(cuda)
    ts = torch.tensor([0.0, 0.5, 1.2], dtype=torch.float64, device=cuda,
                      requires_grad=True)
    ys = sdeint(sde, torch.full((64, 3), 0.1, dtype=torch.float64,
                                device=cuda), ts, bm=bm, method="euler",
                dt=1 / 32)
    ys.sum().backward()
    assert bool(torch.isnan(ys).all()) and bool(torch.isnan(ts.grad).all())
    assert bool(torch.isnan(sde.mu.grad).all())


def _small_score_sde(device, dtype=torch.float64, seed=0):
    from torchsde_tpu_torch.models.cont_ddpm import ScoreMatchingSDE
    from torchsde_tpu_torch.models.unet import UNet
    net = UNet(1, 8, (1, 2, 4), dtype=dtype, device=device,
               generator=torch.Generator().manual_seed(seed))
    return ScoreMatchingSDE(net, input_size=(1, 12, 12))


@pytest.fixture
def cpu_time_embedding(monkeypatch):
    """The U-Net's float32 time embedding computed on the CPU: CUDA's
    float32 sin, cos and exp are an ulp from the CPU's, so the float64
    comparisons hold the network beyond the embedding to the same one."""
    from torchsde_tpu_torch.models import unet
    own = unet.sinusoidal_embedding
    monkeypatch.setattr(unet, "sinusoidal_embedding",
                        lambda t, dim: own(t.cpu(), dim).to(t.device))
    return own


def test_ddpm_time_embedding_on_the_card(cuda, cpu_time_embedding):
    """The float32 embedding on the card within two float32 epsilons of
    the CPU's (its values lie in [-1, 1])."""
    own = cpu_time_embedding
    t = torch.rand(4096, generator=torch.Generator().manual_seed(0))
    got = own(t.to(cuda), 64)
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), own(t, 64), rtol=0,
                               atol=2 * float(np.finfo(np.float32).eps))


def test_ddpm_score_and_loss_on_the_card_match_the_cpu(cuda,
                                                       cpu_time_embedding):
    """A small U-Net's score and the score-matching loss with its
    parameter gradients, in float64 on the card against the CPU on the
    same weights, draws and time embedding, at 1e-9 of scale."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 1, 12, 12), generator=gen, dtype=torch.float64)
    u = torch.rand((4, 2), generator=gen, dtype=torch.float64)
    z = torch.randn((8, 1, 12, 12), generator=gen, dtype=torch.float64)
    t = torch.rand(4, generator=gen, dtype=torch.float64)
    out = []
    for device in (cuda, torch.device("cpu")):
        sde = _small_score_sde(device)
        score = sde.score(t.to(device), x.to(device))
        loss = sde.loss_on_draws(x.to(device), u.to(device), z.to(device))
        grads = torch.autograd.grad(loss.mean(), list(sde.parameters()))
        out.append([score.detach().cpu(), loss.detach().cpu()]
                   + [g.cpu() for g in grads])
    top = max(float(w.abs().max()) for w in out[1][2:])
    for got, want in zip(*out):
        scale = max(float(want.abs().max()), 1e-6 * top)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-9 * scale)


def test_ddpm_samplers_on_the_card(cuda, cpu_time_embedding):
    """A small reverse-SDE sample (``denoise_t``) and a probability-flow
    sample in float32 on the card: finite, of the right shape and dtype.
    The reverse solve in float64 on the card against the CPU's on the same
    t1 draws, increments and time embedding, at 1e-9 of scale."""
    from torchsde_tpu_torch.models.cont_ddpm import ReverseDiffeqWrapper
    rev = ReverseDiffeqWrapper(_small_score_sde(cuda, torch.float32))
    gen = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        sample = rev.sde_sample(gen, batch_size=8, dt=0.05, t_size=3,
                                denoise_t=0.05)
        flow = rev.ode_sample(batch_size=4, dt=0.1, generator=gen)
    assert sample.shape == (3, 8, 1, 12, 12) and flow.shape == (4, 1, 12, 12)
    for s in (sample, flow):
        assert s.dtype == torch.float32 and bool(torch.isfinite(s).all())
    gen = torch.Generator().manual_seed(2)
    y1 = torch.randn((8, 144), generator=gen, dtype=torch.float64)
    W = torch.randn((19, 8, 144), generator=gen,
                    dtype=torch.float64) * 0.05 ** 0.5
    out = []
    for device in (cuda, torch.device("cpu")):
        rev = ReverseDiffeqWrapper(_small_score_sde(device))
        with torch.no_grad():
            out.append(sdeint(rev, y1.to(device), [-1.0, -0.05], dt=0.05,
                              method="midpoint",
                              bm=_GridTable(W.to(device))).cpu())
    assert bool(torch.isfinite(out[1]).all())
    torch.testing.assert_close(out[0], out[1], rtol=0,
                               atol=1e-9 * float(out[1].abs().max()))


# --------------------------------------------------------------------------- #
#  Checkpoints, the order diagnostics and the demo on the card                #
# --------------------------------------------------------------------------- #

def test_checkpoint_resume_is_bitwise_on_the_card(cuda, tmp_path):
    """Six fused Adam steps of a small LatentSDE (kernels 1 and 2) with one
    CUDA generator carried across them, against three, a checkpoint of the
    model, the optimiser and the generator, a load into fresh ones, and
    three more: the parameters and the generator's state bitwise."""
    from torchsde_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    ts = np.linspace(0.0, 1.0, 5)
    xs = torch.randn((5, 64, 3), generator=torch.Generator().manual_seed(3))
    xs = xs.to(cuda)

    def fresh():
        model = LatentSDE(3, 4, 16, 32, device=cuda,
                          generator=torch.Generator().manual_seed(4))
        return (model, torch.optim.Adam(model.parameters(), lr=1e-2),
                torch.Generator(device=cuda).manual_seed(5))

    def train(model, opt, gen, steps):
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss, _ = latent_sde_loss(model, xs, ts, gen, dt=0.05,
                                      fused=True)
            loss.backward()
            opt.step()

    whole = fresh()
    train(*whole, 6)
    first = fresh()
    train(*first, 3)
    path = save_checkpoint(tmp_path / "ck.pt", model=first[0], opt=first[1],
                           gen=first[2], step=3)
    resumed = fresh()
    assert load_checkpoint(path, cuda, model=resumed[0], opt=resumed[1],
                           gen=resumed[2]) == {"step": 3}
    train(*resumed, 3)
    for (name, p), q in zip(whole[0].named_parameters(),
                            resumed[0].parameters()):
        assert p.is_cuda and torch.equal(p, q), name
    assert torch.equal(whole[2].get_state(), resumed[2].get_state())


def test_ito_diagonal_orders_within_their_bands_on_the_card(cuda):
    """diagnostics.run_all on ito_diagonal at batch 1024 in float64 on the
    card: every slope within ORDER_BANDS (a violation exits 1)."""
    from torchsde_tpu_torch.diagnostics import ito_diagonal
    results = ito_diagonal.main(["--batch", "1024"])
    assert set(results["ito_diagonal"]) == {"euler", "milstein",
                                            "milstein_grad_free", "srk"}


def test_demo_runs_on_the_card(cuda):
    """The demo's sections on the card: the fixed bm reproduces, the
    captured solve's replay is bitwise its eager solve, every solve is
    finite, and its whole-solve section launches kernel 9 once."""
    from torchsde_tpu_torch.examples import demo
    FS.euler_launches = 0
    out = demo.main([])
    torch.cuda.synchronize()
    assert FS.euler_launches == 1
    assert out["same_bm_identical"] and out["graph_vs_eager"] == 0.0
    assert np.isfinite(out["adjoint_vs_backprop"])
    for key in ("solution", "srk", "fused"):
        assert out[key].is_cuda and bool(torch.isfinite(out[key]).all())
