"""torchsde_tpu_torch.ops.gan_fused against torchsde_tpu.ops.gan_fused.

On the CPU the port runs its CUDA kernels' plain PyTorch versions; here they
are held against the Pallas kernels run in interpret mode on the same
float32 inputs: the forward ones (_gen_fwd_kernel, _cde_fwd_kernel) at atol
1e-5 (the JAX package's own tolerance for its fused against its XLA solves,
tests/test_fused_gan.py:58,81), together with the wrappers' preparation of
the solves, and the backward ones (_gen_bwd_kernel, _cde_bwd_kernel) at
atol max(1e-4, 1e-5 * each gradient's largest entry) (the JAX package's
rule for these gradients, tests/test_fused_gan.py:181). The backward plain
versions are also held to autograd of the forward ones in float64, and the
autograd Functions to gradcheck. chip_smoke.py holds the CUDA kernels
against the plain versions on the card. Also: the wrappers' guards, routes
and input checks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu.ops.gan_fused as JGF
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.ops.gan_fused as TGF
from port_bridge import port_discriminator, port_generator, to_torch
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import sde_gan as JG

B, T = 8, 6
TS = np.linspace(0.0, T - 1, T)
N = T - 1
S, M, NOISE = 16, 16, 3
S_CDE, C = 17, 2
ATOL = 1e-5


@pytest.fixture
def interpret():
    old = JGF._INTERPRET
    JGF._INTERPRET = True
    yield
    JGF._INTERPRET = old


@functools.lru_cache(maxsize=None)
def _models():
    """JAX float32 generator and critic (critic hidden 17, as the
    reference-scale config) and their ports."""
    gen = JG.Generator(jax.random.PRNGKey(2), 1, 5, NOISE, S, M, 1,
                       dtype=jnp.float32, init_mult1=3.0, init_mult2=0.5)
    disc = JG.Discriminator(jax.random.PRNGKey(3), 1, S_CDE, M, 1,
                            dtype=jnp.float32)
    return (gen, disc, port_generator(gen, torch.float32),
            port_discriminator(disc, torch.float32))


def _grid_times():
    g = TS.astype(np.float32)
    return g[1:], g[1:] - g[:-1]


def _gen_inputs(seed=0):
    """x0 (B,S), its f0 and g0 from the JAX drift and diffusion, noise
    (N,B,m), t1s, dts: float32 numpy arrays."""
    gen = _models()[0]
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, S)).astype(np.float32)
    f0, g0 = gen.func.f_and_g(jnp.float32(TS[0]), jnp.asarray(x0))
    noise = rng.standard_normal((N, B, NOISE)).astype(np.float32)
    return (x0, np.asarray(f0), np.asarray(g0).reshape(B, S * NOISE), noise,
            *_grid_times())


def _cde_inputs(seed=1):
    """h0 (B,S), f0 (B,S), slopes (N,B,C), t1s, dts: float32 numpy."""
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((B, S_CDE)).astype(np.float32)
    f0 = (0.5 * rng.standard_normal((B, S_CDE))).astype(np.float32)
    slopes = rng.standard_normal((N, B, C)).astype(np.float32)
    return (h0, f0, slopes, *_grid_times())


def test_gen_plain_matches_pallas_kernel_f32(interpret):
    gen, _, tgen, _ = _models()
    args = _gen_inputs()
    want = JGF._gen_solve_fwd_impl(JGF.pack_gen_weights(gen.func),
                                   *map(jnp.asarray, args))
    with torch.no_grad():
        got = TGF.gen_solve_forward_plain(*map(to_torch, args),
                                          TGF.gen_weights(tgen.func))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    assert float(got[2].abs().max()) > 1e-2           # the noise is live


def test_cde_plain_matches_pallas_kernel_f32(interpret):
    _, disc, _, tdisc = _models()
    args = _cde_inputs()
    packed = dict(zip(JGF._CDE_WNAMES, JGF._pack_mlp2(disc.func.func)))
    want = JGF._cde_solve_fwd_impl(packed, *map(jnp.asarray, args))
    with torch.no_grad():
        got = TGF.cde_solve_forward_plain(*map(to_torch, args),
                                          TGF.cde_weights(tdisc.func))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_generator_solve_fused_matches_jax_f32(interpret, monkeypatch):
    """The whole wrapper (noise draw, f0 and g0, the grid's times, the
    solve) against JAX's generator_solve_fused through the Pallas kernel."""
    gen, _, tgen, _ = _models()
    x0 = np.random.default_rng(2).standard_normal((B, S)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = JGF.generator_solve_fused(gen.func, jnp.asarray(x0), TS, key, 1.0)
    W = JI.sample_grid_noise(key, TS, (B, NOISE), jnp.float32)[0]

    def draw(generator, grid, size, dtype, device=None, **kwargs):
        assert size == (B, NOISE) and np.array_equal(grid, TS)
        return to_torch(W), None, None

    monkeypatch.setattr(TI, "sample_grid_noise", draw)
    with torch.no_grad():
        got = TGF.generator_solve_fused(tgen.func, to_torch(x0), TS, None,
                                        1.0)
    assert got.shape == (T, B, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_cde_final_state_fused_matches_jax_f32(interpret):
    _, disc, _, tdisc = _models()
    _, data = JG.get_ou_data(jax.random.PRNGKey(1), B, T)
    real = np.asarray(data, np.float32)
    h0 = disc.initial(jnp.asarray(real[:, 0]))
    func = disc.func.evolve(_path_ts=jnp.asarray(TS, jnp.float32),
                            _path_ys=jnp.asarray(real))
    want = JGF.cde_final_state_fused(func, h0, TS, 1.0)
    with torch.no_grad():
        got = TGF.cde_final_state_fused(tdisc.func.attach(TS, to_torch(real)),
                                        to_torch(h0), TS, 1.0)
    assert got.shape == (B, S_CDE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_grid_guards_raise():
    _, _, tgen, tdisc = _models()
    x0 = torch.zeros((B, S))
    with pytest.raises(ValueError, match="coincide with ts"):
        TGF.generator_solve_fused(tgen.func, x0, TS, torch.Generator(), 0.5)
    with pytest.raises(ValueError, match="coincide with ts"):
        TGF.generator_solve_fused(tgen.func, x0, np.linspace(0, 5, 11),
                                  torch.Generator(), 1.0)
    paths = torch.zeros((B, T, 2))
    h0 = torch.zeros((B, S_CDE))
    with pytest.raises(ValueError, match="coincide with ts"):
        TGF.cde_final_state_fused(tdisc.func.attach(TS, paths), h0, TS, 0.5)
    with pytest.raises(ValueError, match="knot times"):
        TGF.cde_final_state_fused(tdisc.func.attach(2 * TS, paths), h0, TS,
                                  1.0)


def _port_gen_args():
    _, _, tgen, _ = _models()
    return [to_torch(a) for a in _gen_inputs()], TGF.gen_weights(tgen.func)


def _port_cde_args():
    _, _, _, tdisc = _models()
    return [to_torch(a) for a in _cde_inputs()], TGF.cde_weights(tdisc.func)


def test_cpu_tensors_take_the_plain_version():
    before = (TGF.gen_launches, TGF.cde_launches)
    args, weights = _port_gen_args()
    ys = TGF.gen_solve_forward(*args, weights)[0]
    with torch.no_grad():
        want = TGF.gen_solve_forward_plain(*args, weights)[0]
    torch.testing.assert_close(ys, want, rtol=0, atol=0)
    ys.sum().backward()                # the plain version is differentiable
    assert all(w.grad is not None for w in weights)
    args, weights = _port_cde_args()
    hs = TGF.cde_solve_forward(*args, weights)[0]
    hs.sum().backward()
    assert weights[0].grad is not None
    assert (TGF.gen_launches, TGF.cde_launches) == before


def test_other_devices_raise_instead_of_falling_back():
    for (args, weights), solve, cuda in (
            (_port_gen_args(), TGF.gen_solve_forward,
             TGF.gen_solve_forward_cuda),
            (_port_cde_args(), TGF.cde_solve_forward,
             TGF.cde_solve_forward_cuda)):
        meta = [a.to("meta") for a in args]
        with pytest.raises(ValueError, match="no fused GAN solve"):
            solve(*meta, weights)
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda(*args, weights)


@pytest.mark.parametrize("fault", ["f64", "strided_noise", "short_dts",
                                   "g0_width", "wide_w2g", "tower_widths"])
def test_gen_input_checks(fault):
    args, good = _port_gen_args()
    assert TGF.check_gen_inputs(*args, good) == (B, S, M, NOISE, N)
    weights = list(good)
    x0, f0, g0, noise, t1s, dts = args
    if fault == "f64":
        x0 = x0.double()
    elif fault == "strided_noise":
        noise = torch.cat([noise, noise], dim=2)[..., ::2]
    elif fault == "short_dts":
        dts = dts[:-1]
    elif fault == "g0_width":
        g0 = g0[:, :-1].contiguous()
    elif fault == "wide_w2g":
        weights[6] = torch.zeros((M, S * NOISE + 1))
    else:
        weights[4:8] = [torch.zeros((1 + S, M + 1)), torch.zeros(M + 1),
                        torch.zeros((M + 1, S * NOISE)),
                        torch.zeros(S * NOISE)]
    with pytest.raises(ValueError):
        TGF.check_gen_inputs(x0, f0, g0, noise, t1s, dts, weights)


@pytest.mark.parametrize("fault", ["f64_weight", "slopes_batch", "strided_h0",
                                   "w2_width"])
def test_cde_input_checks(fault):
    args, good = _port_cde_args()
    assert TGF.check_cde_inputs(*args, good) == (B, S_CDE, M, C, N)
    weights = list(good)
    h0, f0, slopes, t1s, dts = args
    if fault == "f64_weight":
        weights[2] = weights[2].double()
    elif fault == "slopes_batch":
        slopes = slopes[:, :-1]
    elif fault == "strided_h0":
        h0 = torch.cat([h0, h0], dim=1)[:, ::2]
    else:
        weights[2] = torch.zeros((M, S_CDE * C + 1))
    with pytest.raises(ValueError):
        TGF.check_cde_inputs(h0, f0, slopes, t1s, dts, weights)


@pytest.mark.parametrize("S_,M_,K,threads", [(33, 16, 3, 128),
                                             (16, 33, 3, 128),
                                             (16, 16, 9, 128),
                                             (16, 16, 3, 48),
                                             (16, 16, 3, 512)])
def test_width_limits_raise(S_, M_, K, threads):
    TGF.check_widths(32, 32, 8, 256)
    with pytest.raises(ValueError):
        TGF.check_widths(S_, M_, K, threads)


@pytest.mark.parametrize("variant", ["two_hidden_layers", "no_tanh"])
def test_tower_weights_refuse_other_architectures(variant):
    from torchsde_tpu_torch.models.sde_gan import LipMLP
    if variant == "two_hidden_layers":
        mlp = LipMLP(3, 4, 8, 2, tanh=True, device="cpu")
        match = "num_layers=1"
    else:
        mlp = LipMLP(3, 4, 8, 1, tanh=False, device="cpu")
        match = "tanh"
    with pytest.raises(ValueError, match=match):
        TGF._tower_weights(mlp, "tower")


# --------------------------------------------------------------------------- #
#  Backward: kernels 6 (_gen_bwd_kernel) and 8 (_cde_bwd_kernel)              #
# --------------------------------------------------------------------------- #

def _unpad(padded, like):
    """A JAX kernel's padded weight gradient, cut to the port weight's
    shape: (128,128) -> (rows, cols), (1,128) -> (n,)."""
    a = np.asarray(padded)
    return a[0, :like.shape[0]] if like.ndim == 1 else \
        a[:like.shape[0], :like.shape[1]]


def _flat(out):
    return [*out[:-1], *out[-1]]


def _assert_grads_close(got, want):
    """Per tensor, atol max(1e-4, 1e-5 * its largest entry)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = float(np.max(np.abs(w)))
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=max(1e-4, 1e-5 * scale))


def test_gen_backward_plain_matches_pallas_kernel_f32(interpret):
    gen, _, tgen, _ = _models()
    args = _gen_inputs()
    packed = JGF.pack_gen_weights(gen.func)
    jargs = [jnp.asarray(a) for a in args]
    _, zs, gs = JGF._gen_solve_fwd_impl(packed, *jargs)
    gy = np.random.default_rng(3).standard_normal((N, B, S)).astype(
        np.float32)
    dweights, *douts = JGF._gen_solve_bwd_impl(packed, *jargs, zs, gs,
                                               jnp.asarray(gy))
    weights = TGF.gen_weights(tgen.func)
    with torch.no_grad():
        got = TGF.gen_solve_backward_plain(
            *map(to_torch, args), weights, to_torch(zs), to_torch(gs),
            to_torch(gy))
    want = douts + [_unpad(dweights[k], w)
                    for k, w in zip(JGF._GEN_WNAMES, weights)]
    _assert_grads_close(_flat(got), want)
    assert float(got[3].abs().max()) > 1e-2           # dnoise is live


@pytest.mark.parametrize("dense", [True, False])
def test_cde_backward_plain_matches_pallas_kernel_f32(interpret, dense):
    """Dense cotangents, and cotangents of the last state only (what
    cde_final_state_fused gives)."""
    _, disc, _, tdisc = _models()
    args = _cde_inputs()
    packed = dict(zip(JGF._CDE_WNAMES, JGF._pack_mlp2(disc.func.func)))
    jargs = [jnp.asarray(a) for a in args]
    _, zs = JGF._cde_solve_fwd_impl(packed, *jargs)
    ghs = np.random.default_rng(4).standard_normal((N, B, S_CDE)).astype(
        np.float32)
    if not dense:
        ghs[:-1] = 0.0
    dweights, *douts = JGF._cde_solve_bwd_impl(packed, *jargs, zs,
                                               jnp.asarray(ghs))
    weights = TGF.cde_weights(tdisc.func)
    with torch.no_grad():
        got = TGF.cde_solve_backward_plain(*map(to_torch, args), weights,
                                           to_torch(zs), to_torch(ghs))
    want = douts + [_unpad(dweights[k], w)
                    for k, w in zip(JGF._CDE_WNAMES, weights)]
    _assert_grads_close(_flat(got), want)


def _tower(rng, n_in, n_hidden, n_out):
    return [torch.as_tensor(0.5 * rng.standard_normal(shape))
            for shape in ((n_in, n_hidden), (n_hidden,), (n_hidden, n_out),
                          (n_out,))]


def _f64_solve(kind, b, t, seed=0):
    """float64 inputs of the generator or critic solve (S, M and the
    channel count as above): the differentiable inputs, then t1s, dts."""
    rng = np.random.default_rng(seed)
    n = t - 1
    t1s = torch.arange(1, t, dtype=torch.float64)
    dts = torch.ones(n, dtype=torch.float64)
    if kind == "gen":
        leaves = [torch.as_tensor(rng.standard_normal(shape)) for shape in
                  ((b, S), (b, S), (b, S * NOISE), (n, b, NOISE))]
        weights = (_tower(rng, 1 + S, M, S)
                   + _tower(rng, 1 + S, M, S * NOISE))
    else:
        leaves = [torch.as_tensor(rng.standard_normal(shape)) for shape in
                  ((b, S_CDE), (b, S_CDE), (n, b, C))]
        weights = _tower(rng, 1 + S_CDE, M, S_CDE * C)
    return leaves, weights, t1s, dts


@pytest.mark.parametrize("kind", ["gen", "cde"])
def test_backward_plain_matches_autograd_f64(kind):
    """The hand-derived reverse sweeps against autograd of the forward
    plain versions, every input and weight, at 1e-9 of each gradient's
    largest entry."""
    leaves, weights, t1s, dts = _f64_solve(kind, B, T)
    inputs = [x.requires_grad_() for x in leaves + weights]
    if kind == "gen":
        ys, zs, gs = TGF.gen_solve_forward_plain(*leaves, t1s, dts, weights)
        extra = (zs.detach(), gs.detach())
        backward = TGF.gen_solve_backward_plain
    else:
        ys, zs = TGF.cde_solve_forward_plain(*leaves, t1s, dts, weights)
        extra = (zs.detach(),)
        backward = TGF.cde_solve_backward_plain
    gy = torch.as_tensor(np.random.default_rng(5).standard_normal(ys.shape))
    want = torch.autograd.grad((ys * gy).sum(), inputs)
    with torch.no_grad():
        got = _flat(backward(*leaves, t1s, dts, weights, *extra, gy))
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert scale > 0
        torch.testing.assert_close(g, w, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("kind", ["gen", "cde"])
def test_fused_functions_pass_gradcheck_f64(kind):
    leaves, weights, t1s, dts = _f64_solve(kind, 2, 4, seed=1)
    fn = TGF.FusedGenSolve if kind == "gen" else TGF.FusedCDESolve
    n_leaves = len(leaves)

    def first_output(*inputs):
        return fn.apply(*inputs[:n_leaves], t1s, dts, *inputs[n_leaves:])[0]

    inputs = [x.requires_grad_() for x in leaves + weights]
    assert torch.autograd.gradcheck(first_output, inputs)


def test_cpu_gradients_run_the_functions_and_no_kernel():
    """On CPU tensors the gradients of gen_solve_forward and
    cde_solve_forward come from the autograd Functions' plain backward
    versions, and no kernel is launched."""
    counters = ("gen_launches", "cde_launches", "gen_bwd_launches",
                "cde_bwd_launches")
    before = [getattr(TGF, c) for c in counters]
    for solve, plain, (args, weights) in (
            (TGF.gen_solve_forward, TGF.gen_solve_backward_plain,
             _port_gen_args()),
            (TGF.cde_solve_forward, TGF.cde_solve_backward_plain,
             _port_cde_args())):
        leaves = [a.requires_grad_() for a in args[:-2]]
        outs = solve(*leaves, *args[-2:], weights)
        assert type(outs[0].grad_fn).__name__.startswith(
            "Fused" + ("Gen" if solve is TGF.gen_solve_forward else "CDE"))
        assert all(not o.requires_grad for o in outs[1:])
        cot = torch.ones_like(outs[0])
        got = torch.autograd.grad(outs[0], leaves + list(weights), cot)
        with torch.no_grad():
            want = _flat(plain(*args, weights, *outs[1:], cot))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [getattr(TGF, c) for c in counters] == before
