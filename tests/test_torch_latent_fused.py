"""torchsde_tpu_torch.ops.latent_fused against torchsde_tpu.ops.latent_fused.

On the CPU the port runs its CUDA kernel's plain PyTorch version; here it is
held against the Pallas kernel run in interpret mode on the same inputs.
chip_smoke.py holds the CUDA kernel against the plain version on the card.
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
from port_bridge import perturbed, port_latent_sde, to_torch
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models.latent_sde import LatentSDE as JLatentSDE
from torchsde_tpu_torch.ops import _build

B, DATA, L, C, H, T = 8, 3, 4, 8, 16, 6
DT = 1.0 / 32


@functools.lru_cache(maxsize=None)
def _models(jdtype, tdtype):
    jm = perturbed(JLatentSDE(jax.random.PRNGKey(0), DATA, L, C, H,
                              dtype=jdtype), seed=1)
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
    tm.contextualize(ts, ctx_t)
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


def test_cpu_tensors_take_the_plain_version():
    args, weights = _port_inputs()
    before = TLF.launches
    with torch.no_grad():
        got = TLF.fused_solve_forward(*args, weights)
        want = TLF.fused_solve_forward_plain(*args, weights)
    assert TLF.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_other_devices_raise_instead_of_falling_back():
    args, weights = _port_inputs()
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no fused latent solve"):
        TLF.fused_solve_forward(*meta, weights)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TLF.fused_solve_forward_cuda(*args, weights)


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


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert not (tmp_path / "kernels").exists()
