"""torchsde_tpu_torch.ops.latent_fused against torchsde_tpu.ops.latent_fused.

On the CPU the port runs its CUDA kernels' plain PyTorch versions; here they
are held against the Pallas kernels run in interpret mode on the same inputs,
and the autograd Function that joins them against autograd through the
plain forward. chip_smoke.py holds the CUDA kernels against the plain
versions on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu.ops.latent_fused as JLF
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.ops.latent_fused as TLF
from port_bridge import (jax_named_arrays, perturbed, port_latent_sde,
                         to_torch, unsplit_latent_backward)
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models.latent_sde import LatentSDE as JLatentSDE
from torchsde_tpu_torch.ops import _build

B, DATA, L, C, H, T = 8, 3, 4, 8, 16, 6
DT = 1.0 / 32
# The port's names of the solve's weights, in WEIGHT_NAMES order.
PARAM_NAMES = tuple(f"{net}_net.layers.{i}.{p}" for net in "fh"
                    for i in range(3) for p in "wb") + tuple(
                        f"g_nets.{i}" for i in range(4))


@functools.lru_cache(maxsize=None)
def _models(jdtype, tdtype, saturated=False):
    jm = perturbed(JLatentSDE(jax.random.PRNGKey(0), DATA, L, C, H,
                              dtype=jdtype), seed=1)
    if saturated:
        # g = sigmoid(... - 25) ~ 1e-11 < stable_division's 1e-7
        w1, b1, w2, b2 = jm.g_nets
        jm = jm.evolve(g_nets=(w1, b1, w2, b2 - 25.0))
    return jm, port_latent_sde(jm, tdtype)


def _solve_inputs(rng, dtype):
    ts = np.linspace(0.0, 1.0, T)
    grid = JI.build_step_grid(0.0, 1.0, DT)
    n = len(grid) - 1
    g = grid.astype(dtype)
    z0 = rng.standard_normal((B, L)).astype(dtype)
    ctx = rng.standard_normal((T, B, C)).astype(dtype)
    idx = np.clip(np.searchsorted(ts.astype(dtype), g[:-1], side="left"),
                  0, T - 1).astype(np.int32)
    noise = (rng.standard_normal((n, B, L)) * np.sqrt(DT)).astype(dtype)
    return z0, ctx, idx, noise, g[1:] - g[:-1]


def test_plain_matches_pallas_kernel_f32():
    jm, tm = _models(jnp.float32, torch.float32)
    z0, ctx, idx, noise, dts = _solve_inputs(np.random.default_rng(0),
                                             np.float32)
    zs_j, qs_j = JLF._fused_solve_fwd_impl(
        JLF.pack_weights(jm), jnp.asarray(z0), jnp.asarray(ctx[idx]),
        jnp.asarray(noise), jnp.asarray(dts), interpret=True)
    with torch.no_grad():
        zs_t, qs_t = TLF.fused_solve_forward_plain(
            to_torch(z0), to_torch(ctx), to_torch(idx), to_torch(noise),
            to_torch(dts), TLF.solve_weights(tm))
    assert float(np.max(np.abs(qs_j))) > 1e-2     # the KL channel is live
    np.testing.assert_allclose(zs_t.numpy(), np.asarray(zs_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(qs_t.numpy(), np.asarray(qs_j), rtol=0,
                               atol=1e-5)


def test_prep_solve_and_interp_tail_match_jax_f64(monkeypatch):
    jm, tm = _models(jnp.float64, torch.float64)
    rng = np.random.default_rng(2)
    ts = np.linspace(0.0, 1.0, T)
    xs = rng.standard_normal((T, B, DATA))
    z0 = rng.standard_normal((B, L))
    key = jax.random.PRNGKey(3)

    ctx_j = jm.encode(jnp.asarray(xs), ts)
    mj = jm.contextualize(ts, ctx_j)
    with torch.no_grad():
        ctx_t = tm.encode(to_torch(xs), ts)
    tm = tm.contextualize(ts, ctx_t)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), rtol=0,
                               atol=1e-12)

    z0_j, ctx_steps, noise_j, dts_j, grid_j = JLF._prep_solve(
        mj, jnp.asarray(z0), ts, key, DT)
    W = JI.sample_grid_noise(key, grid_j, (B, L + 1), jnp.float64)[0]

    def draw(generator, grid, size, dtype, device=None, **kwargs):
        assert size == (B, L + 1) and np.array_equal(grid, grid_j)
        return to_torch(W), None, None

    monkeypatch.setattr(TI, "sample_grid_noise", draw)
    z0_t, ctx, idx, noise_t, dts_t, grid_t = TLF._prep_solve(
        tm, to_torch(z0), ts, None, DT)
    np.testing.assert_array_equal(grid_t, grid_j)
    assert idx.dtype == torch.int32 and noise_t.is_contiguous()
    np.testing.assert_allclose(ctx[idx.long()].numpy(), np.asarray(ctx_steps),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(noise_t.numpy(), np.asarray(noise_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dts_t.numpy(), np.asarray(dts_j), rtol=0,
                               atol=1e-12)

    n = len(grid_j) - 1
    zs_steps = rng.standard_normal((n, B, L))
    qs_steps = np.cumsum(rng.random((n, B, 1)), axis=0)
    zs_j, lr_j = JLF._interp_tail(ts, grid_j, jnp.asarray(z0),
                                  jnp.asarray(zs_steps),
                                  jnp.asarray(qs_steps), L)
    zs_t, lr_t = TLF._interp_tail(ts, grid_t, to_torch(z0),
                                  to_torch(zs_steps), to_torch(qs_steps), L)
    assert zs_t.shape == (T, B, L) and lr_t.shape == (T - 1, B)
    np.testing.assert_allclose(zs_t.numpy(), np.asarray(zs_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(lr_t.numpy(), np.asarray(lr_j), rtol=0,
                               atol=1e-12)


def _port_inputs(dtype=np.float32):
    _, tm = _models(jnp.float32, torch.float32)
    z0, ctx, idx, noise, dts = _solve_inputs(np.random.default_rng(4), dtype)
    return ([to_torch(z0), to_torch(ctx), to_torch(idx), to_torch(noise),
             to_torch(dts)], TLF.solve_weights(tm))


def _backward_extras(args):
    """zs, gz, gq for a backward call on the solve inputs ``args``."""
    n, B_, L_ = args[3].shape
    return [torch.zeros((n, B_, L_)), torch.ones((n, B_, L_)),
            torch.ones((n, B_, 1))]


def test_cpu_tensors_take_the_plain_version():
    args, weights = _port_inputs()
    weights = [w.detach().requires_grad_() for w in weights]
    before = (TLF.launches, TLF.bwd_launches)
    got = TLF.fused_solve_forward(*args, weights)
    with torch.no_grad():
        want = TLF.fused_solve_forward_plain(*args, weights)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    got[0].sum().backward()
    assert all(w.grad is not None for w in weights)
    assert (TLF.launches, TLF.bwd_launches) == before


def test_other_devices_raise_instead_of_falling_back():
    args, weights = _port_inputs()
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no fused latent solve"):
        TLF.fused_solve_forward(*meta, weights)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TLF.fused_solve_forward_cuda(*args, weights)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TLF.fused_solve_backward_cuda(*args, weights, *_backward_extras(args))


@pytest.mark.parametrize("fault", ["f64", "bf16_weight", "strided_noise",
                                   "int64_idx", "short_dts", "wide_w1"])
def test_kernel_input_checks(fault):
    args, good_weights = _port_inputs()
    TLF.check_kernel_inputs(*args, good_weights)
    weights = list(good_weights)
    z0, ctx, idx, noise, dts = args
    if fault == "f64":
        z0 = z0.double()
    elif fault == "bf16_weight":
        weights[2] = weights[2].bfloat16()
    elif fault == "strided_noise":
        noise = torch.cat([noise, noise], dim=2)[..., ::2]
    elif fault == "int64_idx":
        idx = idx.long()
    elif fault == "short_dts":
        dts = dts[:-1]
    elif fault == "wide_w1":
        weights[0] = torch.zeros((L + C + 1, H))
    with pytest.raises(ValueError):
        TLF.check_kernel_inputs(z0, ctx, idx, noise, dts, weights)


@pytest.mark.parametrize("fault", ["zs_steps", "gq_width", "gz_f64",
                                   "strided_gz"])
def test_backward_input_checks(fault):
    args, weights = _port_inputs()
    zs, gz, gq = _backward_extras(args)
    TLF.check_backward_inputs(*args, weights, zs, gz, gq)
    if fault == "zs_steps":
        zs = zs[:-1]
    elif fault == "gq_width":
        gq = torch.ones(gz.shape)
    elif fault == "gz_f64":
        gz = gz.double()
    elif fault == "strided_gz":
        gz = torch.cat([gz, gz], dim=2)[..., ::2]
    with pytest.raises(ValueError):
        TLF.check_backward_inputs(*args, weights, zs, gz, gq)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert not (tmp_path / "kernels").exists()


@pytest.mark.parametrize("saturated", [False, True])
def test_plain_backward_matches_pallas_kernel_f32(saturated):
    """fused_solve_backward_plain against the Pallas _bwd_kernel on the same
    inputs, states and cotangents. The packed gradients go back to the
    per-tower weights through the VJP of pack_weights. Tolerance: the JAX
    package's own for its fused against its XLA gradients
    (tests/test_fused_latent.py:73-79), atol max(1e-4, 3e-5 * scale) with
    scale the largest gradient entry of the net or stream. With saturated
    diffusion only the u-path is masked, so the g nets' gradients (dz * dW)
    stay nonzero and must match too."""
    jm, tm = _models(jnp.float32, torch.float32, saturated)
    rng = np.random.default_rng(6)
    z0, ctx, idx, noise, dts = _solve_inputs(rng, np.float32)
    n = noise.shape[0]
    gz = (0.1 * rng.standard_normal((n, B, L))).astype(np.float32)
    gq = (0.1 * rng.standard_normal((n, B, 1))).astype(np.float32)
    packed = JLF.pack_weights(jm)
    ctx_steps = jnp.asarray(ctx[idx])
    zs, _ = JLF._fused_solve_fwd_impl(packed, jnp.asarray(z0), ctx_steps,
                                      jnp.asarray(noise), jnp.asarray(dts),
                                      interpret=True)
    dpacked, dz0_j, dctx_steps, dnoise_j = JLF._fused_solve_bwd_impl(
        packed, jnp.asarray(z0), ctx_steps, jnp.asarray(noise),
        jnp.asarray(dts), zs, jnp.asarray(gz), jnp.asarray(gq),
        interpret=True)
    dmodel = jax_named_arrays(jax.vjp(JLF.pack_weights, jm)[1](dpacked)[0])
    dctx_j = np.zeros_like(ctx)
    np.add.at(dctx_j, idx, np.asarray(dctx_steps))

    dz0, dctx, dnoise, dweights = TLF.fused_solve_backward_plain(
        to_torch(z0), to_torch(ctx), to_torch(idx), to_torch(noise),
        to_torch(dts), TLF.solve_weights(tm), to_torch(zs), to_torch(gz),
        to_torch(gq))

    def close(got, want):
        scale = max(float(np.max(np.abs(w))) for w in want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                       atol=max(1e-4, 3e-5 * scale))

    close([dz0], [np.asarray(dz0_j)])
    close([dctx], [dctx_j])
    close([dnoise], [np.asarray(dnoise_j)])
    for net, sl in (("f", slice(0, 6)), ("h", slice(6, 12)),
                    ("g", slice(12, 16))):
        close(dweights[sl], [dmodel[name] for name in PARAM_NAMES[sl]])
    g_scale = max(float(np.max(np.abs(dmodel[name])))
                  for name in PARAM_NAMES[12:])
    assert g_scale > 1e-6


def _tiny_solve(rng, B_, L_, C_, H_, T_, n_):
    """Seeded float64 solve inputs and weights at tiny widths, every input
    that takes a gradient marked so."""
    def randn(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape))

    D = L_ + C_
    weights = [randn(D, H_), randn(H_), randn(H_, H_, scale=0.3), randn(H_),
               randn(H_, L_), randn(L_),
               randn(L_, H_), randn(H_), randn(H_, H_, scale=0.3), randn(H_),
               randn(H_, L_), randn(L_),
               randn(L_, 1, H_), randn(L_, H_), randn(L_, H_, 1), randn(L_, 1)]
    diff = [randn(B_, L_), randn(T_, B_, C_), randn(n_, B_, L_, scale=0.3),
            *weights]
    for t in diff:
        t.requires_grad_(True)
    idx = torch.as_tensor(np.sort(rng.integers(0, T_, n_)), dtype=torch.int32)
    dts = torch.as_tensor(rng.uniform(0.05, 0.2, n_))
    return diff, idx, dts


def _apply(idx, dts):
    def solve(z0, ctx, noise, *weights):
        return TLF.FusedLatentSolve.apply(z0, ctx, idx, noise, dts, *weights)
    return solve


def test_function_gradients_match_autograd_through_plain_forward_f64():
    """FusedLatentSolve's backward (the plain reverse sweep on the CPU)
    against torch.autograd through fused_solve_forward_plain, in float64 on
    the same seeded inputs and cotangents: atol 1e-12 relative to each
    gradient's scale, rounding only. No gradient goes to ctx_idx or dts."""
    rng = np.random.default_rng(8)
    diff, idx, dts = _tiny_solve(rng, 5, 3, 4, 6, 4, 9)
    dts.requires_grad_(True)
    z0, ctx, noise, *weights = diff
    zs, qs = TLF.fused_solve_forward_plain(z0, ctx, idx, noise, dts, weights)
    gz = torch.as_tensor(rng.standard_normal(zs.shape))
    gq = torch.as_tensor(rng.standard_normal(qs.shape))
    want = torch.autograd.grad((zs * gz).sum() + (qs * gq).sum(), diff)
    zs_f, qs_f = TLF.fused_solve_forward(z0, ctx, idx, noise, dts, weights)
    torch.testing.assert_close(zs_f, zs, rtol=0, atol=0)
    torch.testing.assert_close(qs_f, qs, rtol=0, atol=0)
    loss = (zs_f * gz).sum() + (qs_f * gq).sum()
    got = torch.autograd.grad(loss, diff + [dts], allow_unused=True)
    assert got[-1] is None
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-12 * float(w.abs().max()))


def test_function_gradcheck_f64():
    """Finite differences of the whole solve against FusedLatentSolve's
    backward, with one of the two outputs unused (its cotangent is None and
    arrives as zeros)."""
    diff, idx, dts = _tiny_solve(np.random.default_rng(9), 2, 2, 1, 3, 2, 3)
    solve = _apply(idx, dts)
    assert torch.autograd.gradcheck(solve, diff)
    assert torch.autograd.gradcheck(lambda *a: solve(*a)[1], diff)


# (B, L, C, H, T, n) of the split's checks: a ragged batch, one latent and
# context dimension, a hidden width of one.
SPLIT_SHAPES = [(5, 3, 4, 6, 4, 9), (3, 1, 1, 5, 3, 4), (4, 2, 3, 1, 2, 5)]


def _split_case(seed, shape, saturated):
    """Seeded float64 inputs, states and cotangents of a backward call."""
    rng = np.random.default_rng(seed)
    diff, idx, dts = _tiny_solve(rng, *shape)
    z0, ctx, noise, *weights = [t.detach() for t in diff]
    if saturated:
        weights[15] = weights[15] - 25.0     # g ~ 1e-11 < 1e-7
    zs, qs = TLF.fused_solve_forward_plain(z0, ctx, idx, noise, dts, weights)
    gz = torch.as_tensor(rng.standard_normal(zs.shape))
    gq = torch.as_tensor(rng.standard_normal(qs.shape))
    return (z0, ctx, idx, noise, dts, weights, zs, gz, gq)


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_sweep_and_contraction_compose_to_the_unsplit_backward_f64(
        shape, saturated):
    """fused_solve_backward_plain, now the plain sweep composed with the
    plain contraction, against the unsplit loop that sums every weight
    gradient step by step: 1e-12 of each tensor's scale in float64 (the
    two sum over rows and steps in another order)."""
    case = _split_case(10, shape, saturated)
    got = TLF.fused_solve_backward_plain(*case)
    want = unsplit_latent_backward(*case)
    for g, w in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-12 * max(1.0, float(w.abs().max())))
    if saturated:      # only the u-path is masked: dz * dW reaches g
        assert max(float(d.abs().max()) for d in got[3][12:]) > 0


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_plain_contraction_is_einsum_over_rows_and_steps(shape):
    """The plain contraction against torch.einsum on the sweep's own scratch
    tensors, summed over steps s and rows b, with x = [z_pre | ctx[idx]],
    each bias the sum of its layer's cotangent: rounding only (float64)."""
    z0, ctx, idx, noise, dts, weights, zs, gz, gq = _split_case(11, shape,
                                                                False)
    sweep = TLF.fused_solve_backward_sweep_plain(z0, ctx, idx, noise, dts,
                                                 weights, zs, gz, gq)
    scratch = dict(zip(TLF.SCRATCH_NAMES, sweep[4]))
    n, B_, H_ = scratch["a1f"].shape
    assert all(scratch[k].shape == (n, B_, H_) for k in TLF.SCRATCH_NAMES[:8])
    assert scratch["df"].shape == scratch["dh"].shape == (n, B_, z0.shape[1])
    z_pre = torch.cat([z0[None], zs[:-1]])
    x = torch.cat([z_pre, ctx[idx.long()]], dim=-1)
    want = []
    for a, d in ((x, "dpre1f"), (scratch["a1f"], "dpre2f"),
                 (scratch["a2f"], "df"), (z_pre, "dpre1h"),
                 (scratch["a1h"], "dpre2h"), (scratch["a2h"], "dh")):
        want += [torch.einsum("sbi,sbj->ij", a, scratch[d]),
                 torch.einsum("sbj->j", scratch[d])]
    got = TLF.fused_solve_backward_contract_plain(z0, ctx, idx, zs,
                                                  sweep[4])
    assert len(got) == 12
    for g, w, weight in zip(got, want, weights):
        assert g.shape == w.shape == weight.shape
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-12 * max(1.0, float(w.abs().max())))


def test_scratch_views_follow_the_kernels_workspace_layout():
    """scratch_views reads a workspace laid out as the kernel writes it:
    per replica the eight (n*B, H) tensors, then df and dh (n*B, L), then
    the partials."""
    z0, ctx, idx, noise, dts, weights, zs, gz, gq = _split_case(
        12, SPLIT_SHAPES[0], False)
    scratch = TLF.fused_solve_backward_sweep_plain(
        z0, ctx, idx, noise, dts, weights, zs, gz, gq)[4]
    n, B_, L_ = zs.shape
    H_ = weights[0].shape[1]
    flat = torch.cat([t.reshape(-1) for t in scratch])
    workspace = torch.stack([flat, 2 * flat])
    workspace = torch.cat([workspace, torch.zeros((2, 7))], dim=1)
    views = TLF.scratch_views(workspace, B_, L_, H_, n)
    assert len(views) == len(TLF.SCRATCH_NAMES)
    for v, t in zip(views, scratch):
        assert v.shape == (2, n * B_, t.shape[-1])
        assert torch.equal(v[0], t.reshape(n * B_, -1))
        assert torch.equal(v[1], 2 * t.reshape(n * B_, -1))


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("window", [1, 2, None], ids=["w1", "w2", "all"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES[:2])
def test_windowed_sweep_and_contraction_compose_to_the_unsplit_backward_f64(
        shape, window, saturated):
    """The plain sweep and contraction swept window by window, last first,
    each window's sweep taking what the one after it carried (dz, dctx,
    dnoise, the g nets' sums) and each window's contraction added to the
    towers' gradients, against the unsplit step-by-step loop: 1e-12 of
    each tensor's scale in float64, at windows of 1, 2 and all steps."""
    case = _split_case(13, shape, saturated)
    n = case[3].shape[0]
    got = TLF.fused_solve_backward_plain(*case, window=window)
    want = unsplit_latent_backward(*case)
    for g, w in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-12 * max(1.0, float(w.abs().max())))
    if window is not None:
        # The windows' scratch, stacked, is the one window's.
        whole = TLF.fused_solve_backward_sweep_plain(*case)[4]
        carry, parts = None, []
        for hi in range(n, 0, -window):
            *carry, scratch = TLF.fused_solve_backward_sweep_plain(
                *case, steps=(max(hi - window, 0), hi), carry=carry)
            parts.insert(0, scratch)
        for t, *windows in zip(whole, *parts):
            torch.testing.assert_close(torch.cat(windows), t, rtol=0,
                                       atol=1e-12 * float(t.abs().max()))


def _workspace_floats_as_the_kernel_lays_it_out(B, L, C, H, W):
    """csrc/latent_fused_bwd.cu: sizes_of, written out: the scratch of W*B
    rows of 8H + 2L floats, max(chunks of 512 rows, blocks of 8 rows)
    partial rows of every weight's floats, each block's carry (dz, ginc,
    the g nets' sums), then P float64 sums from an even float."""
    P = sum(int(np.prod(s)) for s in (
        (L + C, H), (H,), (H, H), (H,), (H, L), (L,), (L, H), (H,), (H, H),
        (H,), (H, L), (L,), (L, 1, H), (L, H), (L, H, 1), (L, 1)))
    blocks = -(-B // 8)
    rows = max(-(-(W * B) // 512), blocks)
    sums = W * B * (8 * H + 2 * L) + rows * P + blocks * (
        L * 8 + 8 + 3 * L * H + L * 8)
    sums += sums % 2
    return sums + 2 * P


@pytest.mark.parametrize("B_,L_,C_,H_,n,windows", [
    (1024, 4, 64, 128, 128, 1),       # the flagship: one window
    (1024, 4, 64, 128, 512, 2),       # dt 1/512
    (1024, 4, 64, 128, 2048, 5),      # dt 1/2048
    (4096, 8, 64, 256, 300, 6),       # a wider model
    (1 << 20, 4, 64, 128, 3, 3),      # a step alone outgrows the bytes
], ids=["flagship", "dt512", "dt2048", "wide", "huge-batch"])
def test_bwd_window_bounds_the_workspace(B_, L_, C_, H_, n, windows):
    """bwd_window: a solve whose workspace fits WORKSPACE_BYTES (2 GiB a
    replica) runs in one window; a longer one in windows of the most steps
    that fit, so each replica's workspace stays within the bytes however
    many steps it takes; at least one step a window. It takes no K: each
    replica's workspace is its own, so the window is the same at every
    K."""
    W = TLF.bwd_window(B_, L_, C_, H_, n)
    assert -(-n // W) == windows
    floats = _workspace_floats_as_the_kernel_lays_it_out(B_, L_, C_, H_, W)
    assert TLF.workspace_floats(B_, L_, C_, H_, W) == floats
    if W == 1:
        return
    assert 4 * floats <= TLF.WORKSPACE_BYTES
    if W < n:
        assert 4 * _workspace_floats_as_the_kernel_lays_it_out(
            B_, L_, C_, H_, W + 1) > TLF.WORKSPACE_BYTES
