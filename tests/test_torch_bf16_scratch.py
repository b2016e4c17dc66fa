"""The bf16 scratch of kernels 2 and 4 in mixed mode, on the CPU.

In mixed mode the reverse sweep writes what the weight products read, the
towers' activations and cotangents rounded, as bf16 scratch, and sums the
biases' gradients from the unrounded float32 cotangents itself, as it sums
the g nets' (``csrc/latent_fused_bwd.cu``: latent_bwd_sweep_bf16). These
tests hold the workspace that layout needs, the windows and replica groups
it allows, and the plain versions that mirror it against the JAX package's
``_bwd_kernel`` and ``_bwd_kernel_multi`` in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu.ops.latent_fused as JLF
import torchsde_tpu_torch.ops.latent_fused as TLF
from port_bridge import (jax_named_arrays, perturbed, port_latent_sde,
                         to_torch)
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import latent_sde as JL
from torchsde_tpu_torch.parallel import replicas as RP

BF16 = torch.bfloat16
FLAGSHIP = (1024, 4, 64, 128)        # B, L, C, H (bench.py)
# tests/test_fused_latent.py::test_bf16_mixed_mode_matches_xla_bf16's
# widths: data 3, latent 4, context 16, hidden 32, batch 8, 4 times on [0,
# 1]; 16 steps of 1/16 here, so that windows of 3 steps split the solve
# into six.
DATA, L, C, H, B, T, DT = 3, 4, 16, 32, 8, 4, 1.0 / 16
K = 3
# Each gradient against the JAX kernel's within 2^-7 (two bf16 ulps) of its
# largest entry: both are float32 sums of the same rounded products over
# rows and steps in another order, each rounded to bf16 once (the bar of
# test_torch_bf16.py::test_fused_solve_matches_jax_pallas). dz0 (float32 in
# both) too: a recomputed activation whose float32 sum lands the other side
# of a bf16 rounding moves it by that rounding (measured 2.8e-3 of an
# element, 5.5e-4 absolute, in one replica of the K = 3 case).
GRAD_REL = 2 ** -7


def _workspace_floats_as_the_kernel_lays_it_out(B_, L_, C_, H_, W, mixed):
    """csrc/latent_fused_bwd.cu: sizes_of, written out: the scratch of W*B
    rows of 8H + 2L elements (bf16 in mixed mode, rounded up to 4 floats),
    a partial row of every weight for each chunk of 512 rows or block of 8,
    whichever are more, each block's carry (dz, ginc, the g nets' sums; in
    mixed mode the bias sums 4H + 2 L 8 too), P float64 sums from an even
    float; in mixed mode all rounded up to 4 floats."""
    P = sum(int(np.prod(s)) for s in (
        (L_ + C_, H_), (H_,), (H_, H_), (H_,), (H_, L_), (L_,), (L_, H_),
        (H_,), (H_, H_), (H_,), (H_, L_), (L_,), (L_, 1, H_), (L_, H_),
        (L_, H_, 1), (L_, 1)))
    blocks = -(-B_ // 8)
    scratch = W * B_ * (8 * H_ + 2 * L_)
    carry = L_ * 8 + 8 + 3 * L_ * H_ + L_ * 8
    if mixed:
        scratch = -(-(scratch // 2) // 4) * 4
        carry += 4 * H_ + 2 * L_ * 8
    sums = scratch + max(-(-(W * B_) // 512), blocks) * P + blocks * carry
    sums += sums % 2
    total = sums + 2 * P
    return -(-total // 4) * 4 if mixed else total


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,windows,mb", [
    (128, (1, 1), (588.398688, 318.160992)),       # the flagship, dt 1/128
    (512, (2, 1), (2143.600512, 1268.207712)),     # dt 1/512
], ids=["flagship", "dt512"])
def test_workspace_and_window_at_the_flagship(dtype, n, windows, mb):
    """The workspace of one replica at the flagship: its floats as the
    kernel lays them out, its bytes, the windows it takes (a bf16 scratch
    is half a float32 one, so mixed mode sweeps dt 1/512 in one window
    where float32 needs two), and no window that would outgrow
    WORKSPACE_BYTES."""
    mixed = dtype == BF16
    W = TLF.bwd_window(*FLAGSHIP, n, dtype)
    assert -(-n // W) == windows[mixed]
    floats = TLF.workspace_floats(*FLAGSHIP, W, dtype)
    assert floats == _workspace_floats_as_the_kernel_lays_it_out(
        *FLAGSHIP, W, mixed)
    assert 4 * floats / 1e6 == pytest.approx(mb[mixed], abs=1e-6)
    assert 4 * floats <= TLF.WORKSPACE_BYTES
    if W < n:
        assert 4 * TLF.workspace_floats(*FLAGSHIP, W + 1, dtype) \
            > TLF.WORKSPACE_BYTES
    if mixed:
        assert floats % 4 == 0        # every replica's scratch on 16 bytes
        assert floats < 0.55 * TLF.workspace_floats(*FLAGSHIP, W,
                                                     torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K_,n,group", [
    (4, 128, (4, 4)), (16, 128, (14, 16)), (4, 512, (4, 4)),
    (16, 512, (4, 6))], ids=["K4", "K16", "K4-dt512", "K16-dt512"])
def test_replica_groups_at_the_flagship(dtype, K_, n, group):
    """Kernel 4's replica groups at the flagship: as many replicas as fit
    MULTI_WORKSPACE_BYTES together at their window's workspace, so the
    bf16 workspace takes more a launch (all 16 at dt 1/128, 6 at 1/512,
    against float32's 14 and 4); the group never changes a replica's
    window."""
    mixed = dtype == BF16
    got = TLF.replica_group(K_, *FLAGSHIP, n, dtype)
    assert got == group[mixed]
    each = 4 * TLF.workspace_floats(*FLAGSHIP,
                                    TLF.bwd_window(*FLAGSHIP, n, dtype),
                                    dtype)
    assert got * each <= TLF.MULTI_WORKSPACE_BYTES
    assert got == K_ or (got + 1) * each > TLF.MULTI_WORKSPACE_BYTES


def test_bf16_scratch_views_read_the_kernels_layout():
    """scratch_views in mixed mode reads the first floats of a workspace as
    bf16, the eight (n*B, H) tensors then df and dh (n*B, L), in
    SCRATCH_NAMES order, as views (no copy)."""
    n, B_, L_, H_ = 3, 5, 3, 8
    M = n * B_
    elems = M * (8 * H_ + 2 * L_)
    floats = TLF.workspace_floats(B_, L_, 2, H_, n, BF16)
    ws = torch.zeros((2, floats))
    flat = ws[:, :elems // 2].view(BF16)
    flat.copy_(torch.arange(2 * elems, dtype=torch.float32).reshape(2, -1)
               .remainder(251).to(BF16))
    views = TLF.scratch_views(ws, B_, L_, H_, n, BF16)
    assert len(views) == len(TLF.SCRATCH_NAMES)
    at = 0
    for v, name in zip(views, TLF.SCRATCH_NAMES):
        width = L_ if name in ("df", "dh") else H_
        assert v.dtype == BF16 and v.shape == (2, M, width)
        assert torch.equal(v.reshape(2, -1), flat[:, at:at + M * width])
        assert v.data_ptr() == flat.data_ptr() + 2 * at
        at += M * width


def _solve_inputs(rng, lead=()):
    ts = np.linspace(0.0, 1.0, T)
    grid = JI.build_step_grid(0.0, 1.0, DT)
    n = len(grid) - 1
    z0 = rng.standard_normal(lead + (B, L)).astype(np.float32)
    ctx = rng.standard_normal(lead + (T, B, C)).astype(jnp.bfloat16)
    idx = np.clip(np.searchsorted(ts, grid[:-1], side="left"),
                  0, T - 1).astype(np.int32)
    noise = (rng.standard_normal(lead + (n, B, L))
             * np.sqrt(DT)).astype(jnp.bfloat16)
    dts = (grid[1:] - grid[:-1]).astype(np.float32)
    gz = (0.1 * rng.standard_normal(lead + (n, B, L))).astype(jnp.bfloat16)
    gq = (0.1 * rng.standard_normal(lead + (n, B, 1))).astype(np.float32)
    return z0, ctx, idx, noise, dts, gz, gq


def _bf16(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)


@functools.lru_cache(maxsize=None)
def _jax_model(seed=0):
    """A bf16 JAX LatentSDE, every leaf moved off its initialisation."""
    return _bf16(perturbed(JL.LatentSDE(jax.random.PRNGKey(seed), DATA, L,
                                        C, H, dtype=jnp.bfloat16),
                           seed=seed + 1))


def _close(name, got, want, rel):
    w = np.asarray(want, np.float64)
    scale = np.abs(w).max()
    assert scale > 0, name
    np.testing.assert_allclose(got.double().numpy(), w, rtol=0,
                               atol=rel * scale, err_msg=name)


@pytest.mark.parametrize("window", [None, 3], ids=["one", "windows"])
def test_bf16_twin_matches_the_pallas_bwd_kernel(window):
    """The mixed-mode plain backward (bf16 scratch, float32 bias sums from
    the sweep) against the JAX package's _bwd_kernel in interpret mode on
    the same bf16 weights, inputs, states and cotangents, in one window and
    in six: dz0, dctx, dnoise and every weight's gradient, each in its
    input's dtype."""
    jm = _jax_model()
    z0, ctx, idx, noise, dts, gz, gq = _solve_inputs(
        np.random.default_rng(3))
    packed = JLF.pack_weights(jm)
    ctx_steps = jnp.asarray(ctx[idx])
    zs, _ = JLF._fused_solve_fwd_impl(packed, jnp.asarray(z0), ctx_steps,
                                      jnp.asarray(noise), jnp.asarray(dts),
                                      interpret=True)
    dpacked, dz0_j, dctx_steps, dnoise_j = JLF._fused_solve_bwd_impl(
        packed, jnp.asarray(z0), ctx_steps, jnp.asarray(noise),
        jnp.asarray(dts), zs, jnp.asarray(gz), jnp.asarray(gq),
        interpret=True)
    want = jax_named_arrays(jax.vjp(JLF.pack_weights, jm)[1](dpacked)[0])
    dctx_j = np.zeros(ctx.shape, np.float32)
    np.add.at(dctx_j, idx, np.asarray(dctx_steps, np.float32))

    weights = TLF.solve_weights(port_latent_sde(jm, BF16))
    with torch.no_grad():
        dz0, dctx, dnoise, dweights = TLF.fused_solve_backward_plain(
            to_torch(z0), to_torch(ctx), to_torch(idx), to_torch(noise),
            to_torch(dts), weights, to_torch(zs), to_torch(gz),
            to_torch(gq), window)
    assert dz0.dtype == torch.float32
    assert dctx.dtype == dnoise.dtype == BF16
    _close("dz0", dz0, dz0_j, GRAD_REL)
    _close("dctx", dctx, dctx_j, GRAD_REL)
    _close("dnoise", dnoise, dnoise_j, GRAD_REL)
    for name, d in zip(TLF.WEIGHT_PARAMS, dweights):
        assert d.dtype == BF16, name
        _close(name, d, want[name], GRAD_REL)


@pytest.mark.parametrize("window", [None, 3], ids=["one", "windows"])
def test_bf16_multi_twin_matches_the_pallas_multi_kernel(window):
    """Kernel 4's mixed-mode plain version on K = 3 replicas against the
    JAX package's _bwd_kernel_multi in interpret mode, replica by replica,
    in one window and in six."""
    jms = jax.vmap(lambda k: JL.LatentSDE(k, DATA, L, C, H,
                                          dtype=jnp.bfloat16))(
        jax.random.split(jax.random.PRNGKey(4), K))
    jms = _bf16(perturbed(jms, seed=5))
    z0, ctx, idx, noise, dts, gz, gq = _solve_inputs(
        np.random.default_rng(6), (K,))
    packed = jax.vmap(JLF.pack_weights)(jms)
    ctx_steps = jnp.asarray(ctx[:, idx])
    zs, _ = JLF._fused_solve_multi_fwd_impl(
        packed, jnp.asarray(z0), ctx_steps, jnp.asarray(noise),
        jnp.asarray(dts), interpret=True)
    dpacked, dz0_j, dctx_steps, dnoise_j = JLF._fused_solve_multi_bwd_impl(
        packed, jnp.asarray(z0), ctx_steps, jnp.asarray(noise),
        jnp.asarray(dts), zs, jnp.asarray(gz), jnp.asarray(gq),
        interpret=True)
    dmodels = jax.vjp(jax.vmap(JLF.pack_weights), jms)[1](dpacked)[0]

    replicas = RP.stack_replicas(lambda m: m, [
        port_latent_sde(jax.tree_util.tree_map(lambda a: a[k], jms), BF16)
        for k in range(K)])
    weights = [replicas.params[name].detach() for name in TLF.WEIGHT_PARAMS]
    with torch.no_grad():
        dz0, dctx, dnoise, dweights = TLF.fused_solve_multi_backward_plain(
            to_torch(z0), to_torch(ctx), to_torch(idx), to_torch(noise),
            to_torch(dts), weights, to_torch(zs), to_torch(gz),
            to_torch(gq), window)
    for k in range(K):
        dctx_k = np.zeros(ctx.shape[1:], np.float32)
        np.add.at(dctx_k, idx, np.asarray(dctx_steps[k], np.float32))
        _close(f"dz0[{k}]", dz0[k], dz0_j[k], GRAD_REL)
        _close(f"dctx[{k}]", dctx[k], dctx_k, GRAD_REL)
        _close(f"dnoise[{k}]", dnoise[k], dnoise_j[k], GRAD_REL)
        want = jax_named_arrays(jax.tree_util.tree_map(lambda a: a[k],
                                                       dmodels))
        for name, d in zip(TLF.WEIGHT_PARAMS, dweights):
            assert d.dtype == BF16, name
            _close(f"{name}[{k}]", d[k], want[name], GRAD_REL)


def test_bf16_sweep_writes_bf16_scratch_and_sums_biases_unrounded():
    """The mixed-mode plain sweep: its ten scratch tensors bf16, each
    product of the contraction a float32 sum of them; its biases' sums
    (after the g nets' four) float32 and the sums of the unrounded
    cotangents, which its bf16 scratch only rounds: within a bf16 rounding
    of the scratch's own column sums, and the contraction gives no bias."""
    jm = _jax_model()
    z0, ctx, idx, noise, dts, gz, gq = _solve_inputs(
        np.random.default_rng(8))
    weights = TLF.solve_weights(port_latent_sde(jm, BF16))
    args = [to_torch(a) for a in (z0, ctx, idx, noise, dts)]
    with torch.no_grad():
        zs, _ = TLF.fused_solve_forward_plain(*args, weights)
        *_, swept, scratch = TLF.fused_solve_backward_sweep_plain(
            *args, weights, zs, to_torch(gz), to_torch(gq))
        tower = TLF.fused_solve_backward_contract_plain(
            args[0], args[1], args[2], zs, scratch)
    assert all(t.dtype == BF16 for t in scratch)
    assert len(swept) == 10 and all(t.dtype == torch.float32 for t in swept)
    assert all(tower[i] is None for i in (1, 3, 5, 7, 9, 11))
    cot = dict(zip(TLF.SCRATCH_NAMES, scratch))
    for got, name in zip(swept[4:], ("dpre1f", "dpre2f", "df", "dpre1h",
                                     "dpre2h", "dh")):
        rounded = cot[name].float().sum((0, 1))
        scale = float(cot[name].float().abs().max()) * cot[name][..., 0].numel()
        assert got.shape == rounded.shape
        torch.testing.assert_close(got, rounded, rtol=0, atol=2 ** -8 * scale)
