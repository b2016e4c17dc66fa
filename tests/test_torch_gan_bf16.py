"""The port's bf16 mixed mode of the SDE-GAN against torchsde_tpu.

Mixed mode (the JAX package's rule ``sdtype = float32 if wdtype ==
bfloat16``, ``ops/gan_fused.py:387-391``, ``:626-628``) runs the fused GAN
solves with bf16 weights and a bf16 noise stream, and float32 states,
slopes, cotangents and sums. On the CPU ``FusedGenSolve`` and
``FusedCDESolve`` run the plain versions of kernels 5-8, which these tests
hold to the JAX package's Pallas kernels in interpret mode, to its fused
route, and to the port's own ``sdeint`` route in bf16 on the bars of the
JAX package's ``test_bf16_mixed_mode_matches_xla_bf16``. The size is that
test's: Generator(1, 5, 3, 16, 16, 1) and Discriminator(1, 16, 16, 1) in
bf16, batch 8, 6 times at dt 1. JAX's draws are made on the JAX side and
handed to the port by replacing its two draw sites, as in
``tests/test_torch_sde_gan.py``."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu.ops.gan_fused as JGF
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.models.sde_gan as TG
import torchsde_tpu_torch.ops.gan_fused as TGF
from port_bridge import (CDE_PATH_KEYS, jax_named_arrays, port_discriminator,
                         port_generator, to_torch)
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import sde_gan as JG

BF16 = torch.bfloat16
KEY = jax.random.PRNGKey(0)
B, T = 8, 6
TS = np.linspace(0.0, T - 1, T)
N = T - 1
GRID = JI.build_step_grid(TS[0], TS[-1], 1.0)
DATA, INIT_NOISE, NOISE, HIDDEN, MLP = 1, 5, 3, 16, 16
C = 1 + DATA
# tests/test_fused_gan.py::test_bf16_mixed_mode_matches_xla_bf16: the fused
# loss within 2e-2 of the sdeint route's (absolutely: a Wasserstein
# difference of O(1) critic scores near zero, and the sdeint route carries
# bf16 state), the cosine of all parameter gradients above 0.999.
ROUTE_LOSS_ATOL, ROUTE_COS = 2e-2, 0.999
# The port's fused route against the JAX package's (interpret mode), on the
# same weights and draws. The solves agree to a float32 ulp or two
# (test_gen_twins_match_pallas_kernels), but the initial MLPs run entirely
# in bf16, where XLA rounds a fused chain of elementwise operations once
# and PyTorch rounds each: x0 comes out one bf16 ulp apart (3.9e-3 at a
# scale of 0.88), and the critic's h0 likewise. Measured: the loss 2.0e-5
# apart, each gradient at most 6.0e-3 of its largest entry (1.5 bf16 ulps,
# critic.initial.layers.1.b), the cosine 1 - 3.8e-6. So the loss within
# 1e-4, each gradient within 2^-6 of its largest entry, the cosine above
# 0.9999.
JAX_LOSS_ATOL, JAX_GRAD_REL, JAX_COS = 1e-4, 2 ** -6, 0.9999
# The twins of kernels 5-8 against the Pallas kernels on the same inputs:
# the states within 2^-20 of their scale (the same roundings of the
# products' inputs, summed in another order: measured at most 2.2e-7 of
# scale, a float32 ulp or two); the gradients within 2^-12 of their largest
# entry (measured: every weight's bitwise, dnoise bitwise, dx0, df0, dg0,
# dslopes at most 2.7e-7 of scale; a product's input whose bf16 rounding
# flipped would move a sum by about 2^-9 of one term).
STATE_REL, GRAD_REL = 2 ** -20, 2 ** -12


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JGF, "_INTERPRET", True)


@functools.lru_cache(maxsize=None)
def _jax_models():
    gen = JG.Generator(jax.random.fold_in(KEY, 2), DATA, INIT_NOISE, NOISE,
                       HIDDEN, MLP, 1, dtype=jnp.bfloat16)
    disc = JG.Discriminator(jax.random.fold_in(KEY, 3), DATA, HIDDEN, MLP, 1,
                            dtype=jnp.bfloat16)
    return gen, disc


def _ported():
    gen, disc = _jax_models()
    return port_generator(gen, BF16), port_discriminator(disc, BF16)


@functools.lru_cache(maxsize=None)
def _real():
    _, data = JG.get_ou_data(jax.random.fold_in(KEY, 1), B, T)
    return jnp.asarray(data[:B], jnp.bfloat16)


def _f64(a):
    """A JAX or torch array as float64 numpy (bf16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _assert_rel(got, want, rel, name=""):
    want = _f64(want)
    assert tuple(got.shape) == want.shape, name
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_f64(got), want, rtol=0, atol=rel * scale,
                               err_msg=name)


def _cos(a, b):
    num = sum(float(np.sum(_f64(a[n]) * _f64(b[n]))) for n in a)
    na = math.sqrt(sum(float(np.sum(_f64(a[n]) ** 2)) for n in a))
    nb = math.sqrt(sum(float(np.sum(_f64(b[n]) ** 2)) for n in a))
    return num / (na * nb)


# --------------------------------------------------------------------------- #
#  The twins of kernels 5-8 against the Pallas kernels                        #
# --------------------------------------------------------------------------- #

def _grid_times():
    g = TS.astype(np.float32)
    return jnp.asarray(g[1:]), jnp.asarray(g[1:] - g[:-1])


def _gen_inputs(seed=0):
    """Mixed-mode inputs of the generator solve as JAX arrays: x0 float32,
    f0 and g0 from the bf16 towers at x0 (float32), the noise bf16, t1s
    and dts float32."""
    gen = _jax_models()[0]
    rng = np.random.default_rng(seed)
    x0 = jnp.asarray(rng.standard_normal((B, HIDDEN)), jnp.float32)
    f0, g0 = gen.func.f_and_g(jnp.float32(TS[0]), x0)
    noise = jnp.asarray(rng.standard_normal((N, B, NOISE)), jnp.bfloat16)
    return (x0, f0, g0.reshape(B, HIDDEN * NOISE), noise, *_grid_times())


def _cde_inputs(seed=1):
    """Mixed-mode inputs of the critic solve as JAX arrays, every one
    float32 (h0, f0, the slopes, t1s, dts)."""
    rng = np.random.default_rng(seed)
    h0 = jnp.asarray(rng.standard_normal((B, HIDDEN)), jnp.float32)
    f0 = jnp.asarray(0.5 * rng.standard_normal((B, HIDDEN)), jnp.float32)
    slopes = jnp.asarray(rng.standard_normal((N, B, C)), jnp.float32)
    return (h0, f0, slopes, *_grid_times())


def _unpad(padded, like):
    a = _f64(padded)
    return a[0, :like.shape[0]] if like.ndim == 1 else \
        a[:like.shape[0], :like.shape[1]]


@functools.lru_cache(maxsize=None)
def _jax_gen_kernels():
    """The Pallas generator kernels, interpreted, on _gen_inputs: (ys, zs,
    gs) and (dweights, dx0, df0, dg0, dnoise) for a seeded gy."""
    old, JGF._INTERPRET = JGF._INTERPRET, True
    try:
        packed = JGF.pack_gen_weights(_jax_models()[0].func)
        args = _gen_inputs()
        fwd = JGF._gen_solve_fwd_impl(packed, *args)
        gy = jnp.asarray(np.random.default_rng(3).standard_normal(
            (N, B, HIDDEN)), jnp.float32)
        bwd = JGF._gen_solve_bwd_impl(packed, *args, fwd[1], fwd[2], gy)
    finally:
        JGF._INTERPRET = old
    return fwd, bwd, gy


@functools.lru_cache(maxsize=None)
def _jax_cde_kernels():
    """The Pallas critic kernels, interpreted, on _cde_inputs: (hs, zs) and
    (dweights, dh0, df0, dslopes) for seeded dense cotangents."""
    old, JGF._INTERPRET = JGF._INTERPRET, True
    try:
        packed = dict(zip(JGF._CDE_WNAMES,
                          JGF._pack_mlp2(_jax_models()[1].func.func)))
        args = _cde_inputs()
        fwd = JGF._cde_solve_fwd_impl(packed, *args)
        ghs = jnp.asarray(np.random.default_rng(4).standard_normal(
            (N, B, HIDDEN)), jnp.float32)
        bwd = JGF._cde_solve_bwd_impl(packed, *args, fwd[1], ghs)
    finally:
        JGF._INTERPRET = old
    return fwd, bwd, ghs


@torch.no_grad()
def test_gen_twins_match_pallas_kernels():
    """Kernels 5 and 6's plain versions in mixed mode against the Pallas
    kernels on bf16 weights and noise: ys, zs, gs float32; dx0, df0, dg0
    float32, dnoise and every weight's gradient bf16."""
    (ys_j, zs_j, gs_j), (dw_j, *douts_j), gy = _jax_gen_kernels()
    weights = TGF.gen_weights(_ported()[0].func)
    assert all(w.dtype == BF16 for w in weights)
    args = [to_torch(a) for a in _gen_inputs()]
    assert [a.dtype for a in args] == [torch.float32] * 3 + [BF16] + \
        [torch.float32] * 2
    got = TGF.gen_solve_forward_plain(*args, weights)
    for name, g, w in zip(("ys", "zs", "gs"), got, (ys_j, zs_j, gs_j)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32, name
        _assert_rel(g, w, STATE_REL, name)
    back = TGF.gen_solve_backward_plain(*args, weights, to_torch(zs_j),
                                        to_torch(gs_j), to_torch(gy))
    names = ("dx0", "df0", "dg0", "dnoise")
    for name, g, w in zip(names, back[:4], douts_j):
        mixed = name == "dnoise"
        assert g.dtype == (BF16 if mixed else torch.float32), name
        assert w.dtype == (jnp.bfloat16 if mixed else jnp.float32), name
        _assert_rel(g, w, GRAD_REL, name)
    for name, g, w in zip(TGF.GEN_WEIGHT_NAMES, back[4], weights):
        assert g.dtype == BF16 and dw_j[name].dtype == jnp.bfloat16, name
        _assert_rel(g, _unpad(dw_j[name], w), GRAD_REL, name)
    assert float(back[3].float().abs().max()) > 1e-2       # dnoise is live


@torch.no_grad()
def test_cde_twins_match_pallas_kernels():
    """Kernels 7 and 8's plain versions in mixed mode against the Pallas
    kernels on bf16 weights and float32 slopes: hs, zs, dh0, df0 and
    dslopes float32, every weight's gradient bf16."""
    (hs_j, zs_j), (dw_j, *douts_j), ghs = _jax_cde_kernels()
    weights = TGF.cde_weights(_ported()[1].func)
    args = [to_torch(a) for a in _cde_inputs()]
    got = TGF.cde_solve_forward_plain(*args, weights)
    for name, g, w in zip(("hs", "zs"), got, (hs_j, zs_j)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _assert_rel(g, w, STATE_REL, name)
    back = TGF.cde_solve_backward_plain(*args, weights, to_torch(zs_j),
                                        to_torch(ghs))
    for name, g, w in zip(("dh0", "df0", "dslopes"), back[:3], douts_j):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32, name
        _assert_rel(g, w, GRAD_REL, name)
    for name, g, w in zip(TGF.CDE_WEIGHT_NAMES, back[3], weights):
        assert g.dtype == BF16 and dw_j[name].dtype == jnp.bfloat16, name
        _assert_rel(g, _unpad(dw_j[name], w), GRAD_REL, name)


@torch.no_grad()
def test_generator_solve_fused_matches_jax(interpret, monkeypatch):
    """The whole wrapper on a bf16 x0 (what the bf16 initial MLP gives):
    x0 widened to float32, the noise drawn in bf16, f0 and g0 at float32,
    the solve; the states float32 and within STATE_REL of the JAX
    package's."""
    gen, tgen = _jax_models()[0], _ported()[0]
    x0 = jnp.asarray(np.random.default_rng(2).standard_normal((B, HIDDEN)),
                     jnp.bfloat16)
    key = jax.random.PRNGKey(5)
    want = JGF.generator_solve_fused(gen.func, x0, TS, key, 1.0)
    W = JI.sample_grid_noise(key, GRID, (B, NOISE), jnp.bfloat16)[0]
    drawn = []

    def draw(generator, grid, size, dtype, device=None, **kwargs):
        drawn.append(dtype)
        return to_torch(W), None, None

    monkeypatch.setattr(TI, "sample_grid_noise", draw)
    got = TGF.generator_solve_fused(tgen.func, to_torch(x0), TS, None, 1.0)
    assert drawn == [BF16]
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _assert_rel(got, want, STATE_REL)


@torch.no_grad()
def test_cde_final_state_fused_matches_jax(interpret):
    """The critic's wrapper on float32 paths (the fake ones, as gan_loss
    joins them with the real) and h0 from the bf16 initial MLP: the final
    state float32 and within STATE_REL of the JAX package's."""
    _, disc = _jax_models()
    tdisc = _ported()[1]
    paths = jnp.asarray(_real(), jnp.float32)
    h0 = disc.initial(paths[:, 0])
    assert h0.dtype == jnp.float32
    func = disc.func.evolve(_path_ts=jnp.asarray(TS, jnp.float32),
                            _path_ys=paths)
    want = JGF.cde_final_state_fused(func, h0, TS, 1.0)
    got = TGF.cde_final_state_fused(tdisc.func.attach(TS, to_torch(paths)),
                                    to_torch(h0), TS, 1.0)
    assert got.dtype == torch.float32
    _assert_rel(got, want, STATE_REL)


# --------------------------------------------------------------------------- #
#  The loss and its gradients                                                 #
# --------------------------------------------------------------------------- #

def _inject_jax_draws(monkeypatch, key):
    """Make the port draw what JAX's Generator draws from ``key``, in bf16:
    the initial noise from split(key)[0], the grid noise from split(key)[1].
    A critic solve on the sdeint route draws its own noise, which its zero
    diffusion ignores: zeros."""
    k1, k2 = jax.random.split(key)
    init = to_torch(jax.random.normal(k1, (B, INIT_NOISE), jnp.bfloat16))
    W = to_torch(JI.sample_grid_noise(k2, GRID, (B, NOISE),
                                      jnp.bfloat16)[0])

    def standard_normal(shape, generator, dtype, device):
        assert tuple(shape) == (B, INIT_NOISE) and dtype == BF16
        return init

    def sample_grid_noise(generator, grid, size, dtype, device=None,
                          **kwargs):
        assert np.array_equal(grid, GRID) and dtype == BF16
        if size == (B, NOISE):
            return W, None, None
        return torch.zeros((len(grid) - 1, *size), dtype=dtype), None, None

    monkeypatch.setattr(TG, "_standard_normal", standard_normal)
    monkeypatch.setattr(TI, "sample_grid_noise", sample_grid_noise)


def _port_gan(monkeypatch, fused, key=jax.random.fold_in(KEY, 4)):
    """The port's gan_grads (the generator's negated) at the JAX test's
    size on its draws: the loss, and every gradient keyed as the JAX
    package's pytree paths."""
    _inject_jax_draws(monkeypatch, key)
    gen, disc = _ported()
    loss, g_gen, g_disc = TG.gan_grads(gen, disc, torch.Generator(), TS,
                                       to_torch(_real()), dt=1.0,
                                       adjoint=False, fused=fused)
    return loss, {**{f"generator.{k}": v for k, v in g_gen.items()},
                  **{f"critic.{k}": v for k, v in g_disc.items()}}


@functools.lru_cache(maxsize=None)
def _jax_fused_gan():
    """The JAX package's fused gan_grads, its kernels interpreted: the loss
    (float32) and the gradients (bf16) by pytree path."""
    real = _real()
    old, JGF._INTERPRET = JGF._INTERPRET, True
    try:
        loss, g_gen, g_disc = jax.jit(lambda g, d: JG.gan_grads(
            g, d, jax.random.fold_in(KEY, 4), TS, real, 1.0, False, True))(
            *_jax_models())
    finally:
        JGF._INTERPRET = old
    grads = {f"generator.{k}": v for k, v in jax_named_arrays(g_gen).items()}
    grads.update({f"critic.{k}": v for k, v in jax_named_arrays(g_disc).items()
                  if k not in CDE_PATH_KEYS})
    return loss, grads


def test_fused_loss_and_fake_paths_are_float32(monkeypatch):
    """The fault that mixed mode fixes: a bf16 SDE-GAN's fused route ran
    the solves all in bf16 and gave a bf16 loss. Now the fake paths are
    float32 (the state), the critic scores them joined with the bf16 real
    paths in float32, and every gradient is bf16, as in the JAX package."""
    _inject_jax_draws(monkeypatch, jax.random.fold_in(KEY, 4))
    gen, disc = _ported()
    with torch.no_grad():
        fake = gen(torch.Generator(), TS, B, adjoint=False, fused=True)
        scores = disc.scores(TS, torch.cat([fake, to_torch(_real())]),
                             adjoint=False, fused=True)
    assert fake.dtype == scores.dtype == torch.float32
    loss, grads = _port_gan(monkeypatch, True)
    assert loss.dtype == torch.float32
    assert all(g.dtype == BF16 for g in grads.values())


def test_fused_route_matches_the_sdeint_route(monkeypatch):
    """The counterpart of the JAX package's
    test_bf16_mixed_mode_matches_xla_bf16: the fused route (mixed mode)
    against the sdeint route (entirely bf16) on the same weights and draws,
    on that test's bars."""
    fused, g_fused = _port_gan(monkeypatch, True)
    ref, g_ref = _port_gan(monkeypatch, False)
    assert fused.dtype == torch.float32 and ref.dtype == BF16
    assert all(g.dtype == BF16 for g in (*g_fused.values(), *g_ref.values()))
    assert abs(float(fused) - float(ref)) < ROUTE_LOSS_ATOL
    assert _cos(g_fused, g_ref) > ROUTE_COS


def test_fused_route_matches_jax_pallas(monkeypatch):
    """The port's fused loss and every parameter gradient against the JAX
    package's fused route in interpret mode, on the same weights and
    draws."""
    want, want_grads = _jax_fused_gan()
    got, grads = _port_gan(monkeypatch, True)
    assert want.dtype == jnp.float32
    assert abs(float(got) - float(want)) < JAX_LOSS_ATOL
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        assert g.dtype == BF16 and want_grads[name].dtype == jnp.bfloat16
        w = _f64(want_grads[name])
        scale = float(np.abs(w).max())
        # The critic's readout bias adds the same to both means.
        assert scale > 0 or name == "critic.readout.b", name
        np.testing.assert_allclose(_f64(g), w, rtol=0,
                                   atol=JAX_GRAD_REL * scale, err_msg=name)
    assert _cos(grads, want_grads) > JAX_COS


# --------------------------------------------------------------------------- #
#  The kernels' checks, and the float32 and float64 routes                    #
# --------------------------------------------------------------------------- #

def _port_args(kind):
    gen, disc = _ported()
    if kind == "gen":
        return ([to_torch(a) for a in _gen_inputs()],
                list(TGF.gen_weights(gen.func)))
    return ([to_torch(a) for a in _cde_inputs()],
            list(TGF.cde_weights(disc.func)))


def test_checks_take_the_mixed_set():
    """The kernels' checks take a consistent mixed set, and the float32
    set; the backward checks add zs, gs, gy (float32)."""
    args, weights = _port_args("gen")
    assert TGF.check_gen_inputs(*args, weights) == (B, HIDDEN, MLP, NOISE, N)
    f32 = [a.float() for a in args]
    TGF.check_gen_inputs(*f32, [w.float() for w in weights])
    zs = torch.zeros((N, B, HIDDEN))
    gs = torch.zeros((N, B, HIDDEN * NOISE))
    TGF.check_gen_backward_inputs(*args, weights, zs, gs, zs)
    args, weights = _port_args("cde")
    assert TGF.check_cde_inputs(*args, weights) == (B, HIDDEN, MLP, C, N)
    TGF.check_cde_backward_inputs(*args, weights, zs, zs)


GEN_FAULTS = ["one_bf16_weight", "one_f32_weight", "bf16_noise_f32_weights",
              "f32_noise", "bf16_x0", "bf16_f0", "bf16_g0", "bf16_dts",
              "diffusion_tower_f32", "bf16_zs", "bf16_gy"]


@pytest.mark.parametrize("fault", GEN_FAULTS)
def test_gen_checks_refuse_a_mixed_set(fault):
    """A set that mixes the two modes is refused: one bf16 weight among
    float32 ones, one float32 weight among bf16 ones, bf16 noise with
    float32 weights, float32 noise with bf16 weights, a bf16 x0, f0, g0 or
    dts, one tower in each mode, a bf16 zs or gy."""
    args, weights = _port_args("gen")
    x0, f0, g0, noise, t1s, dts = args
    zs = torch.zeros((N, B, HIDDEN))
    gs = torch.zeros((N, B, HIDDEN * NOISE))
    gy = torch.zeros((N, B, HIDDEN))
    if fault == "one_bf16_weight":
        weights = [w.float() for w in weights]
        weights[2] = weights[2].to(BF16)
        noise = noise.float()
    elif fault == "one_f32_weight":
        weights[6] = weights[6].float()
    elif fault == "bf16_noise_f32_weights":
        weights = [w.float() for w in weights]
    elif fault == "f32_noise":
        noise = noise.float()
    elif fault == "bf16_x0":
        x0 = x0.to(BF16)
    elif fault == "bf16_f0":
        f0 = f0.to(BF16)
    elif fault == "bf16_g0":
        g0 = g0.to(BF16)
    elif fault == "bf16_dts":
        dts = dts.to(BF16)
    elif fault == "diffusion_tower_f32":
        weights[4:] = [w.float() for w in weights[4:]]
    elif fault == "bf16_zs":
        zs = zs.to(BF16)
    else:
        gy = gy.to(BF16)
    with pytest.raises(ValueError, match="float32|bfloat16"):
        TGF.check_gen_backward_inputs(x0, f0, g0, noise, t1s, dts, weights,
                                      zs, gs, gy)


CDE_FAULTS = ["one_bf16_weight", "one_f32_weight", "bf16_h0", "bf16_slopes",
              "bf16_t1s", "bf16_ghs"]


@pytest.mark.parametrize("fault", CDE_FAULTS)
def test_cde_checks_refuse_a_mixed_set(fault):
    """The critic's: one bf16 weight among float32 ones, one float32
    weight among bf16 ones, a bf16 h0, slopes, t1s or ghs."""
    args, weights = _port_args("cde")
    h0, f0, slopes, t1s, dts = args
    zs = torch.zeros((N, B, HIDDEN))
    ghs = torch.zeros((N, B, HIDDEN))
    if fault == "one_bf16_weight":
        weights = [w.float() for w in weights]
        weights[1] = weights[1].to(BF16)
    elif fault == "one_f32_weight":
        weights[3] = weights[3].float()
    elif fault == "bf16_h0":
        h0 = h0.to(BF16)
    elif fault == "bf16_slopes":
        slopes = slopes.to(BF16)
    elif fault == "bf16_t1s":
        t1s = t1s.to(BF16)
    else:
        ghs = ghs.to(BF16)
    with pytest.raises(ValueError, match="float32|bfloat16"):
        TGF.check_cde_backward_inputs(h0, f0, slopes, t1s, dts, weights, zs,
                                      ghs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_float32_and_float64_routes_keep_their_dtype(dtype):
    """A float32 or float64 SDE-GAN's fused route is not mixed mode: the
    towers are the unrounded expression, the solves, the loss and every
    gradient in the model's dtype, and the fused loss and gradients agree
    with the sdeint route's (float64 at 1e-10 of scale, float32 at 1e-5),
    no bf16 kernel launched."""
    init = torch.Generator().manual_seed(6)
    gen = TG.Generator(DATA, INIT_NOISE, NOISE, HIDDEN, MLP, 1, dtype=dtype,
                       init_mult1=3.0, init_mult2=0.5, device="cpu",
                       generator=init)
    disc = TG.Discriminator(DATA, HIDDEN, MLP, 1, dtype=dtype, device="cpu",
                            generator=init)
    weights = TGF.gen_weights(gen.func)[:4]
    x = torch.randn((B, 1 + HIDDEN), generator=init, dtype=dtype)
    pre = x @ weights[0] + weights[1]
    assert torch.equal(TGF.lipswish_tower(x, *weights), torch.tanh(
        (0.909 * pre * torch.sigmoid(pre)) @ weights[2] + weights[3]))
    _, real = TG.get_ou_data(torch.Generator().manual_seed(7), B, T,
                             dtype=dtype, device="cpu")
    out = {}
    for fused in (True, False):
        loss, g_gen, g_disc = TG.gan_grads(
            gen, disc, torch.Generator().manual_seed(8), TS, real,
            adjoint=False, fused=fused)
        assert loss.dtype == dtype
        assert all(g.dtype == dtype for g in (*g_gen.values(),
                                              *g_disc.values()))
        out[fused] = loss, {**g_gen, **{"c." + k: v for k, v in
                                        g_disc.items()}}
    rel = 1e-10 if dtype == torch.float64 else 1e-5
    scale = float(out[False][0].abs())
    assert abs(float(out[True][0]) - float(out[False][0])) <= max(
        rel * scale, rel)
    for name, want in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], want, rtol=0,
                                   atol=rel * float(want.abs().max()),
                                   msg=name)
