"""torchsde_tpu_torch.ops.fused_solve against torchsde_tpu.ops.fused_solve.

On the CPU the port runs its CUDA kernels' plain PyTorch versions; here they
are held against the Pallas kernels (_euler_fwd_kernel, _euler_bwd_kernel,
_rh_fwd_kernel, _rh_bwd_kernel) run in interpret mode on the same float32
inputs, with weights carried over by utils/convert.load_jax_tower: values
at atol 2e-5 and gradients at atol max(1e-4, 1e-5 * each gradient's scale),
the JAX package's rule for its fused against its XLA solves
(tests/test_fused_solve.py:87,114-115). The port's fused_sdeint is held to
JAX fused_sdeint on injected noise by the same rule, and in float64 the
autograd Functions to JAX sdeint of the same towers at 1e-9 of scale.
chip_smoke.py holds the CUDA kernels against the plain versions on the
card. Also: the contract checks, the routes and the input checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu.ops.fused_solve as JFS
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.ops.fused_solve as TFS
from port_bridge import port_tower_grads as _port_grads
from port_bridge import to_torch, tower_triples as _triples
from port_bridge import unpad_tower_grads as _unpad
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.core.sdeint import sdeint as jax_sdeint
from torchsde_tpu_torch.core.sdeint import sdeint as port_sdeint
from torchsde_tpu_torch.utils.convert import load_jax_tower

ATOL = 2e-5
B, N, DT = 8, 4, 0.25
GRID = np.linspace(0.0, 1.0, N + 1)

CASES = [
    # (method, noise_type, d, m, with_time, depth): tests/test_fused_solve.py
    ("euler", "diagonal", 4, 4, False, 2),
    ("euler", "general", 3, 2, True, 3),
    ("reversible_heun", "diagonal", 4, 4, False, 2),
    ("reversible_heun", "general", 3, 2, True, 2),
    ("euler", "diagonal", 128, 128, False, 2),   # exact width: forward only
]
SMALL = CASES[:4]


@pytest.fixture
def interpret():
    old = JFS._INTERPRET
    JFS._INTERPRET = True
    yield
    JFS._INTERPRET = old


def _jax_tower(triples):
    return JFS.TowerSpec([(jnp.asarray(w), jnp.asarray(b), act)
                          for w, b, act in triples])


def _case(method, noise_type, d, m, with_time, depth, seed=0,
          dtype=np.float32):
    """Drift and diffusion triples (softplus/linear and lipswish/sigmoid
    towers of hidden width 16, as the JAX package's test), y0, noise and a
    cotangent of ys."""
    rng = np.random.default_rng(seed)
    n_in = d + (1 if with_time else 0)
    gout = d if noise_type == "diagonal" else d * m
    hidden = [16] * (depth - 1)
    drift = _triples(rng, [n_in] + hidden + [d],
                     ["softplus"] * (depth - 1) + ["linear"], dtype=dtype)
    diffusion = _triples(rng, [n_in] + hidden + [gout],
                         ["lipswish"] * (depth - 1) + ["sigmoid"],
                         dtype=dtype)
    y0 = rng.standard_normal((B, d)).astype(dtype)
    noise = (np.sqrt(DT) * rng.standard_normal((N, B, m))).astype(dtype)
    gy = rng.standard_normal((N, B, d)).astype(dtype)
    return drift, diffusion, y0, noise, gy


def _times(method):
    g = GRID.astype(np.float32)
    return (g[:-1] if method == "euler" else g[1:]), g[1:] - g[:-1]


def _assert_grads_close(got, want):
    """Per tensor, atol max(1e-4, 1e-5 * its largest entry)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = float(np.max(np.abs(w)))
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=max(1e-4, 1e-5 * scale))


@pytest.mark.parametrize("method,noise_type,d,m,with_time,depth", CASES)
def test_plain_versions_match_pallas_kernels_f32(interpret, method,
                                                 noise_type, d, m, with_time,
                                                 depth):
    """Kernels 9-12's plain versions against the Pallas kernels: values,
    and every gradient of the reverse sweeps (the d = 128 case forward
    only)."""
    ftr, gtr, y0, noise, gy = _case(method, noise_type, d, m, with_time,
                                    depth)
    diag = noise_type == "diagonal"
    jdrift, jdiff = _jax_tower(ftr), _jax_tower(gtr)
    drift = load_jax_tower(ftr, device="cpu")
    diffusion = load_jax_tower(gtr, device="cpu")
    spec = TFS.solve_spec(drift, diffusion, d, m, diag, with_time)
    times, dts = _times(method)
    fw, gw = drift.pack(), diffusion.pack()
    forward_only = d == 128
    if method == "euler":
        solve = JFS._make_euler(jdrift.acts, jdiff.acts, d, m, diag,
                                with_time, jnp.float32)
        jargs = (jdrift.pack(), jdiff.pack(), jnp.asarray(y0),
                 jnp.asarray(noise), jnp.asarray(times), jnp.asarray(dts))
        ys_j, res = solve.fwd(*jargs)
        want = [ys_j]
        args = (to_torch(y0), to_torch(noise), to_torch(times),
                to_torch(dts), fw, gw, spec)
        with torch.no_grad():
            got = [TFS.euler_solve_forward_plain(*args)]
    else:
        x0 = TFS.tower_input(torch.tensor(0.0), to_torch(y0), with_time)
        with torch.no_grad():
            f0 = TFS.tower_forward(x0, TFS.unpack(fw, spec.drift),
                                   drift.acts)[0]
            g0 = TFS.tower_forward(x0, TFS.unpack(gw, spec.diffusion),
                                   diffusion.acts)[0]
        solve = JFS._make_rh(jdrift.acts, jdiff.acts, d, m, diag, with_time,
                             jnp.float32)
        jargs = (jdrift.pack(), jdiff.pack(), jnp.asarray(y0),
                 jnp.asarray(f0.numpy()), jnp.asarray(g0.numpy()),
                 jnp.asarray(noise), jnp.asarray(times), jnp.asarray(dts))
        ys_j, res = solve.fwd(*jargs)
        want = [ys_j, res[-2], res[-1]]
        args = (to_torch(y0), f0, g0, to_torch(noise), to_torch(times),
                to_torch(dts), fw, gw, spec)
        with torch.no_grad():
            got = list(TFS.rh_solve_forward_plain(*args))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    assert float(got[0].abs().max()) > 0.1
    if forward_only:
        return

    jgrads = solve.bwd(res, jnp.asarray(gy))
    with torch.no_grad():
        if method == "euler":
            dy0, dnoise, dfw, dgw = TFS.euler_solve_backward_plain(
                *args, got[0], to_torch(gy))
            douts, want_d = [dy0, dnoise], [jgrads[2], jgrads[3]]
        else:
            dy0, df0, dg0, dnoise, dfw, dgw = TFS.rh_solve_backward_plain(
                *args, got[1], got[2], to_torch(gy))
            douts = [dy0, df0, dg0, dnoise]
            want_d = list(jgrads[2:6])
    _assert_grads_close(
        douts + _port_grads(dfw, ftr) + _port_grads(dgw, gtr),
        want_d + _unpad(jgrads[0], ftr) + _unpad(jgrads[1], gtr))
    assert float(dnoise.abs().max()) > 1e-2             # dnoise is live


def _injected_noise(monkeypatch, key, m):
    """JAX's grid noise of ``key``, handed to the port's draw site."""
    W = JI.sample_grid_noise(key, GRID, (B, m), jnp.float32)[0]

    def draw(generator, grid, size, dtype, device=None, **kwargs):
        assert size == (B, m) and np.allclose(grid, GRID)
        return to_torch(W).to(dtype), None, None

    monkeypatch.setattr(TI, "sample_grid_noise", draw)


@pytest.mark.parametrize("method,noise_type,d,m,with_time,depth", SMALL)
def test_fused_sdeint_matches_jax_fused_sdeint(interpret, monkeypatch,
                                               method, noise_type, d, m,
                                               with_time, depth):
    """The whole entry point (noise, grid times, f0 and g0, the solve, the
    gather onto ts) on the CPU against JAX fused_sdeint through the Pallas
    kernels: values and the gradients of sum(ys**2) for every tower tensor
    and y0."""
    ftr, gtr, y0, _, _ = _case(method, noise_type, d, m, with_time, depth,
                               seed=1)
    key = jax.random.PRNGKey(7)
    _injected_noise(monkeypatch, key, m)
    ts = GRID[::2]
    kw = dict(method=method, noise_type=noise_type, with_time=with_time,
              dispatch="fused")

    def loss_jax(fp, gp, y):
        ys = JFS.fused_sdeint(
            JFS.TowerSpec([(w, b, a) for (w, b), (_, _, a) in zip(fp, ftr)]),
            JFS.TowerSpec([(w, b, a) for (w, b), (_, _, a) in zip(gp, gtr)]),
            y, ts, key, DT, **kw)
        return jnp.sum(ys ** 2), ys

    jp = ([(jnp.asarray(w), jnp.asarray(b)) for w, b, _ in ftr],
          [(jnp.asarray(w), jnp.asarray(b)) for w, b, _ in gtr],
          jnp.asarray(y0))
    (_, ys_j), jgrads = jax.value_and_grad(loss_jax, argnums=(0, 1, 2),
                                           has_aux=True)(*jp)

    drift = load_jax_tower(ftr, device="cpu")
    diffusion = load_jax_tower(gtr, device="cpu")
    leaves = [t.requires_grad_() for spec in (drift, diffusion)
              for (w, b, _) in spec.layers for t in (w, b)]
    y0_t = to_torch(y0).requires_grad_()
    ys = TFS.fused_sdeint(drift, diffusion, y0_t, ts, None, DT, **kw)
    assert ys.shape == (len(ts), B, d)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), rtol=0,
                               atol=ATOL)
    (ys ** 2).sum().backward()
    want = jax.tree_util.tree_leaves(jgrads)
    _assert_grads_close([t.grad for t in leaves] + [y0_t.grad], want)


F64_CASES = [
    ("euler", "diagonal", 4, 4, False, 2),
    ("euler", "general", 3, 2, True, 3),
    ("reversible_heun", "diagonal", 4, 4, True, 2),
    ("reversible_heun", "general", 3, 2, False, 3),
]


@pytest.mark.parametrize("method,noise_type,d,m,with_time,depth", F64_CASES)
def test_fused_functions_match_jax_sdeint_f64(method, noise_type, d, m,
                                              with_time, depth):
    """FusedEulerSolve / FusedRHSolve on the plain versions against JAX
    sdeint of the same towers in float64, on JAX's noise of one key: values
    and every gradient (towers and y0) at 1e-9 of scale."""
    ftr, gtr, y0, _, _ = _case(method, noise_type, d, m, with_time, depth,
                               seed=2, dtype=np.float64)
    sde_type = "ito" if method == "euler" else "stratonovich"
    key = jax.random.PRNGKey(3)
    ts = GRID[::2]

    def loss_jax(fp, gp, y):
        sde = JFS.tower_sde(
            JFS.TowerSpec([(w, b, a) for (w, b), (_, _, a) in zip(fp, ftr)]),
            JFS.TowerSpec([(w, b, a) for (w, b), (_, _, a) in zip(gp, gtr)]),
            noise_type, sde_type, with_time=with_time)
        ys = jax_sdeint(sde, y, ts, method=method, dt=DT, key=key)
        return jnp.sum(ys ** 2), ys

    jp = ([(jnp.asarray(w), jnp.asarray(b)) for w, b, _ in ftr],
          [(jnp.asarray(w), jnp.asarray(b)) for w, b, _ in gtr],
          jnp.asarray(y0))
    (_, ys_j), jgrads = jax.value_and_grad(loss_jax, argnums=(0, 1, 2),
                                           has_aux=True)(*jp)
    W = to_torch(JI.sample_grid_noise(key, GRID, (B, m), jnp.float64)[0])

    drift = load_jax_tower(ftr, device="cpu", dtype=torch.float64)
    diffusion = load_jax_tower(gtr, device="cpu", dtype=torch.float64)
    leaves = [t.requires_grad_() for spec in (drift, diffusion)
              for (w, b, _) in spec.layers for t in (w, b)]
    y0_t = to_torch(y0).requires_grad_()
    spec = TFS.solve_spec(drift, diffusion, d, m, noise_type == "diagonal",
                          with_time)
    ys = TFS.solve_on_grid(method, drift, diffusion, y0_t, W, GRID,
                           spec)[::2]
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j),
                               rtol=0, atol=1e-9 * float(np.abs(ys_j).max()))
    (ys ** 2).sum().backward()
    for got, want in zip([t.grad for t in leaves] + [y0_t.grad],
                         jax.tree_util.tree_leaves(jgrads)):
        scale = float(np.max(np.abs(want)))
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-9 * scale)


def _narrow(seed=3, d=3, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    drift = load_jax_tower(_triples(rng, [d, 8, d], ["softplus", "linear"]),
                           device=device, dtype=dtype)
    diffusion = load_jax_tower(_triples(rng, [d, 8, d],
                                        ["lipswish", "sigmoid"]),
                               device=device, dtype=dtype)
    return drift, diffusion


def test_tower_spec_validation():
    w, b = torch.zeros((4, 4)), torch.zeros(4)
    with pytest.raises(ValueError):
        TFS.TowerSpec([(w, b, "relu")])                # unsupported act
    with pytest.raises(ValueError):
        TFS.TowerSpec([(torch.zeros((4, 200)), torch.zeros(200), "tanh")])
    with pytest.raises(ValueError, match="bias width"):
        TFS.TowerSpec([(w, torch.zeros(3), "tanh")])
    with pytest.raises(ValueError, match="chain"):
        TFS.TowerSpec([(w, b, "tanh"), (torch.zeros((5, 4)), b, "linear")])
    spec = TFS.TowerSpec([(torch.zeros((4, 128)), torch.zeros(128), "tanh"),
                          (torch.zeros((128, 4)), b, "linear")])
    assert spec.in_size == 4 and spec.out_size == 4
    assert spec.acts == ("tanh", "linear")
    assert spec.pack().shape == (4 * 128 + 128 + 128 * 4 + 4,)


def test_tower_spec_from_library_layers():
    from torchsde_tpu_torch.models.layers import MLP
    from torchsde_tpu_torch.models.sde_gan import LipMLP
    mlp = MLP([3, 8, 8, 2], device="cpu")
    spec = TFS.TowerSpec.from_mlp(mlp)
    assert spec.acts == ("softplus", "softplus", "linear")
    assert spec.layers[1][0] is mlp.layers[1].w
    x = torch.randn(5, 3)
    torch.testing.assert_close(
        TFS.tower_forward(x, [(w, b) for w, b, _ in spec.layers],
                          spec.acts)[0], mlp(x), rtol=0, atol=1e-6)
    lip = LipMLP(3, 2, 8, 2, tanh=True, device="cpu")
    lspec = TFS.TowerSpec.from_lipmlp(lip)
    assert lspec.acts == ("lipswish", "lipswish", "tanh")
    torch.testing.assert_close(
        TFS.tower_forward(x, [(w, b) for w, b, _ in lspec.layers],
                          lspec.acts)[0], lip(x), rtol=0, atol=1e-6)
    assert TFS.TowerSpec.from_lipmlp(
        LipMLP(3, 2, 8, 1, tanh=False, device="cpu")).acts == ("lipswish",
                                                               "linear")


@pytest.mark.parametrize("act", TFS.ACTS)
def test_activations_match_jax_at_large_inputs(act):
    """Each activation and its derivative against the JAX package's, out
    to |pre| = 100, where softplus' exp would overflow if written
    naively."""
    pre = np.concatenate([np.linspace(-100.0, 100.0, 41),
                          np.linspace(-3.0, 3.0, 13)]).astype(np.float32)
    dout = np.linspace(-1.0, 1.0, pre.size).astype(np.float32)
    out_j = JFS._apply_act(jnp.asarray(pre), act)
    out_t = TFS.apply_act(to_torch(pre), act)
    assert torch.isfinite(out_t).all()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6,
                               atol=1e-6)
    d_j = JFS._act_bwd(jnp.asarray(dout), jnp.asarray(pre), out_j, act)
    d_t = TFS.act_bwd(to_torch(dout), to_torch(pre), out_t, act)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dispatch", ["fused", "xla", "auto"])
def test_grid_guard_on_every_dispatch_path(dispatch):
    drift = TFS.TowerSpec([(torch.zeros((2, 2)), torch.zeros(2), "linear")])
    diffusion = TFS.TowerSpec([(torch.zeros((2, 2)), torch.zeros(2),
                                "sigmoid")])
    with pytest.raises(ValueError, match="dt step grid"):
        TFS.fused_sdeint(drift, diffusion, torch.zeros((4, 2)),
                         [0.0, 0.3, 1.0], torch.Generator(), 0.25,
                         dispatch=dispatch)


def test_dispatch_dtype_contract():
    """Both usable dispatch paths compute in the towers' dtype (bf16 towers
    and a float32 y0 give bf16 states); 'fused' takes float32 towers
    only."""
    drift, diffusion = _narrow(dtype=torch.bfloat16)
    y0 = torch.zeros((4, 3), dtype=torch.float32)
    for dispatch in ("xla", "auto"):
        ys = TFS.fused_sdeint(drift, diffusion, y0, np.linspace(0., 1., 3),
                              torch.Generator().manual_seed(0), 0.5,
                              dispatch=dispatch)
        assert ys.dtype == torch.bfloat16, dispatch
    with pytest.raises(ValueError, match="float32-only"):
        TFS.fused_sdeint(drift, diffusion, y0, np.linspace(0., 1., 3),
                         torch.Generator(), 0.5, dispatch="fused")


def test_argument_and_tower_checks():
    drift, diffusion = _narrow()
    y0 = torch.zeros((4, 3))
    gen = torch.Generator()
    for kw, match in ((dict(method="milstein"), "euler"),
                      (dict(noise_type="scalar"), "diagonal"),
                      (dict(dispatch="pallas"), "dispatch")):
        with pytest.raises(ValueError, match=match):
            TFS.fused_sdeint(drift, diffusion, y0, [0.0, 1.0], gen, 0.5,
                             **kw)
    with pytest.raises(ValueError, match="input width"):
        TFS.fused_sdeint(drift, diffusion, y0, [0.0, 1.0], gen, 0.5,
                         with_time=True)
    with pytest.raises(ValueError, match="d\\*m"):
        TFS.fused_sdeint(drift, TFS.TowerSpec([(torch.zeros((3, 4)),
                                                torch.zeros(4), "tanh")]),
                         y0, [0.0, 1.0], gen, 0.5, noise_type="general")
    with pytest.raises(ValueError, match="prior tower must output"):
        TFS.fused_sdeint_logqp(drift, TFS.TowerSpec([(torch.zeros((3, 4)),
                                                      torch.zeros(4),
                                                      "tanh")]),
                               diffusion, y0, [0.0, 1.0], gen, 0.5)


def test_auto_dispatch_of_narrow_towers_matches_sdeint_bitwise():
    """'auto' is a performance choice only. It takes the kernels for every
    float32 solve (they won at every shape measured on the H100, the
    narrowest included), and on the CPU, where that means their plain
    versions, narrow towers give bitwise what the port's sdeint gives on the
    same generator seed."""
    assert TFS._auto_fuse(torch.float32)
    assert not TFS._auto_fuse(torch.float64)
    assert not TFS._auto_fuse(torch.bfloat16)
    drift, diffusion = _narrow()
    y0 = torch.as_tensor(np.random.default_rng(4).standard_normal((4, 3)),
                         dtype=torch.float32)
    ts = np.linspace(0.0, 1.0, 3)
    ys_auto = TFS.fused_sdeint(drift, diffusion, y0, ts,
                               torch.Generator().manual_seed(5), 0.5)
    sde = TFS.tower_sde(drift, diffusion, "diagonal", "ito")
    ys_ref = port_sdeint(sde, y0, ts, method="euler", dt=0.5,
                         generator=torch.Generator().manual_seed(5))
    assert torch.equal(ys_auto, ys_ref)


def _port_args(method, seed=5):
    ftr, gtr, y0, noise, gy = _case(method, "general", 3, 2, True, 2,
                                    seed=seed)
    drift = load_jax_tower(ftr, device="cpu")
    diffusion = load_jax_tower(gtr, device="cpu")
    spec = TFS.solve_spec(drift, diffusion, 3, 2, False, True)
    times, dts = _times(method)
    fw, gw = drift.pack().detach(), diffusion.pack().detach()
    y0, noise = to_torch(y0), to_torch(noise)
    if method == "euler":
        return spec, (fw, gw, y0, noise, to_torch(times), to_torch(dts))
    f0 = torch.zeros_like(y0) + 0.1
    g0 = torch.full((B, spec.gwidth), 0.2)
    return spec, (fw, gw, y0, f0, g0, noise, to_torch(times), to_torch(dts))


@pytest.mark.parametrize("method", ["euler", "reversible_heun"])
def test_cpu_gradients_run_the_functions_and_no_kernel(method):
    counters = ("euler_launches", "euler_bwd_launches", "rh_launches",
                "rh_bwd_launches")
    before = [getattr(TFS, c) for c in counters]
    spec, args = _port_args(method)
    leaves = [a.requires_grad_() for a in args[:-2]]
    if method == "euler":
        ys = TFS.FusedEulerSolve.apply(spec, *args)
        assert type(ys.grad_fn).__name__.startswith("FusedEuler")
    else:
        ys, zs, gs = TFS.FusedRHSolve.apply(spec, *args)
        assert type(ys.grad_fn).__name__.startswith("FusedRH")
        assert not (zs.requires_grad or gs.requires_grad)
    cot = torch.ones_like(ys)
    got = torch.autograd.grad(ys, leaves, cot)
    with torch.no_grad():
        y0, noise, times, dts = (args[2], args[-3], args[-2], args[-1])
        fw, gw = args[0], args[1]
        if method == "euler":
            dy0, dnoise, dfw, dgw = TFS.euler_solve_backward_plain(
                y0, noise, times, dts, fw, gw, spec, ys, cot)
            want = [dfw, dgw, dy0, dnoise]
        else:
            out = TFS.rh_solve_backward_plain(
                y0, args[3], args[4], noise, times, dts, fw, gw, spec, zs,
                gs, cot)
            want = [out[4], out[5], *out[:4]]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [getattr(TFS, c) for c in counters] == before


@pytest.mark.parametrize("method", ["euler", "reversible_heun"])
def test_backward_plain_matches_autograd_f64(method):
    """The hand-derived sweeps against autograd of the forward plain
    versions, every input, at 1e-9 of each gradient's scale."""
    spec, args = _port_args(method, seed=6)
    args = [a.double() for a in args]
    leaves = [a.requires_grad_() for a in args[:-2]]
    if method == "euler":
        ys = TFS.euler_solve_forward_plain(*args[2:], args[0], args[1], spec)
        extra = (ys.detach(),)
        backward = TFS.euler_solve_backward_plain
        order = [2, 3, 0, 1]                 # dy0, dnoise, dfw, dgw
    else:
        ys, zs, gs = TFS.rh_solve_forward_plain(*args[2:], args[0], args[1],
                                                spec)
        extra = (zs.detach(), gs.detach())
        backward = TFS.rh_solve_backward_plain
        order = [2, 3, 4, 5, 0, 1]           # dy0, df0, dg0, dnoise, dfw, dgw
    gy = torch.as_tensor(np.random.default_rng(7).standard_normal(ys.shape))
    want = torch.autograd.grad((ys * gy).sum(), leaves)
    with torch.no_grad():
        got = backward(*[a.detach() for a in args[2:]],
                       args[0].detach(), args[1].detach(), spec, *extra, gy)
    for g, i in zip(got, order):
        scale = float(want[i].abs().max())
        assert scale > 0
        torch.testing.assert_close(g, want[i], rtol=0, atol=1e-9 * scale)


def test_other_devices_raise_instead_of_falling_back():
    spec, args = _port_args("euler")
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no fused tower solve"):
        TFS.FusedEulerSolve.apply(spec, *meta)
    fw, gw, y0, noise, t0s, dts = args
    with pytest.raises(ValueError, match="CUDA tensors"):
        TFS.euler_solve_forward_cuda(y0, noise, t0s, dts, fw, gw, spec)
    spec_rh, rh = _port_args("reversible_heun")
    fw, gw, y0, f0, g0, noise, t1s, dts = rh
    with pytest.raises(ValueError, match="CUDA tensors"):
        TFS.rh_solve_forward_cuda(y0, f0, g0, noise, t1s, dts, fw, gw,
                                  spec_rh)


@pytest.mark.parametrize("fault", ["wide", "unchained", "io", "act"])
def test_spec_checks(fault):
    spec = TFS.SolveSpec(((4, 16, "softplus"), (16, 3, "linear")),
                         ((4, 16, "lipswish"), (16, 6, "sigmoid")),
                         3, 2, False, True)
    TFS.check_spec(spec)
    if fault == "wide":
        bad = spec._replace(drift=((4, 129, "softplus"), (129, 3, "linear")))
    elif fault == "unchained":
        bad = spec._replace(drift=((4, 16, "softplus"), (15, 3, "linear")))
    elif fault == "io":
        bad = spec._replace(with_time=False)
    else:
        bad = spec._replace(drift=((4, 16, "relu"), (16, 3, "linear")))
    with pytest.raises(ValueError):
        TFS.check_spec(bad)


@pytest.mark.parametrize("fault", ["f64", "strided", "short_dts",
                                   "pack_size"])
def test_kernel_input_checks(fault):
    spec, (fw, gw, y0, noise, t0s, dts) = _port_args("euler")
    assert TFS._check_common(spec, y0, noise, t0s, dts, fw, gw) == (B, N)
    if fault == "f64":
        y0 = y0.double()
    elif fault == "strided":
        noise = torch.cat([noise, noise], dim=2)[..., ::2]
    elif fault == "short_dts":
        dts = dts[:-1]
    else:
        gw = gw[:-1]
    with pytest.raises(ValueError):
        TFS._check_common(spec, y0, noise, t0s, dts, fw, gw)


def test_layer_table():
    spec, _ = _port_args("euler")
    table = TFS.layer_table(spec)
    assert table.dtype == np.int32
    np.testing.assert_array_equal(
        table, [4, 16, 0, 16, 3, 4, 4, 16, 3, 16, 6, 2])


def _tower_shapes(n_in, hidden, out, depth):
    sizes = [n_in] + [hidden] * (depth - 1) + [out]
    acts = ("softplus",) * (depth - 1) + ("linear",)
    return tuple(zip(sizes[:-1], sizes[1:], acts))


def _rh_spec(d, hidden, m=None, wt=False, depth=2):
    """A reversible-Heun solve's spec: diagonal noise unless m is given."""
    diag = m is None
    n_in = d + int(wt)
    return TFS.SolveSpec(_tower_shapes(n_in, hidden, d, depth),
                         _tower_shapes(n_in, hidden, d if diag else d * m,
                                       depth),
                         d, d if diag else m, diag, wt)


@pytest.mark.parametrize("B,d,m,wt,hidden,depth,sms,want", [
    # R1: the towers (264 KB) fit no block; a cluster of two at 16 rows
    # makes one wave (64 clusters, 128 blocks).
    (1024, 128, None, False, 128, 2, 132, (2, 16, 512, 3)),
    # Past one wave no rows make one; the most that fit a cluster's block.
    (4096, 128, None, False, 128, 2, 132, (2, 16, 512, 3)),
    # General noise with time, depth 3: both towers in one block, 8 rows,
    # 128 threads a tower (64 units x 8 rows).
    (1024, 16, 4, True, 64, 3, 132, (1, 8, 256, 3)),
    # E1's widths: one block, 32 rows for one wave, 256 threads a tower
    # (128 units x 32 rows); 16 rows and 128 threads on twice the SMs.
    (4096, 32, None, False, 128, 2, 132, (1, 32, 512, 3)),
    (4096, 32, None, False, 128, 2, 264, (1, 16, 256, 3)),
    (40, 8, None, False, 16, 2, 132, (1, 8, 256, 3)),
])
def test_forward_design_rule_kernel_11(B, d, m, wt, hidden, depth, sms,
                                       want):
    """Kernel 11's design from the widths, the batch and the SMs: every
    tower in one block where they fit, else a cluster of a block a tower,
    at the fewest rows that fill the card in one wave, on 256 threads a
    tower where the widest layer has 4,096 unit-rows, else 128; the design
    fits a block's shared memory."""
    spec = _rh_spec(d, hidden, m, wt, depth)
    design = TFS.forward_design(TFS.RH_FWD, spec, B, sms)
    assert tuple(design) == want
    assert TFS.fwd_smem_bytes(TFS.RH_FWD, spec, design.stage, design.rows,
                              design.cluster) <= TFS._build.MAX_SMEM_BYTES


def test_forward_design_rule_kernel_11_shared_memory_limits(monkeypatch):
    """The shared memory the rule reads is the C layout's
    (csrc/tower_fwd_tile.cuh: make_tile_layout): at R1 two towers at 16
    rows take 366,768 bytes in a block, one a cluster's block 214,192. Below
    that limit R1 streams the diffusion from L2 in the 8-row design (the
    drift staged), and past one wave of 8-row blocks stages none."""
    spec = _rh_spec(128, 128)
    assert TFS.fwd_smem_bytes(TFS.RH_FWD, spec, 3, 16, 1) == 366768
    assert TFS.fwd_smem_bytes(TFS.RH_FWD, spec, 3, 16, 2) == 214192
    assert TFS.fwd_smem_bytes(TFS.RH_FWD, spec, 3, 32, 2) == 279728
    assert TFS.fwd_smem_bytes(TFS.RH_FWD, spec, 1, 8, 1) == 193712
    monkeypatch.setattr(TFS._build, "MAX_SMEM_BYTES", 200000)
    assert tuple(TFS.forward_design(TFS.RH_FWD, spec, 1024, 132)) == \
        (1, 8, 256, 1)
    assert tuple(TFS.forward_design(TFS.RH_FWD, spec, 2048, 132)) == \
        (1, 8, 256, 0)
    monkeypatch.setattr(TFS._build, "MAX_SMEM_BYTES", 40000)
    with pytest.raises(ValueError, match="shared memory"):
        TFS.forward_design(TFS.RH_FWD, spec, 1024, 132)
