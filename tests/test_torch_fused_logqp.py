"""torchsde_tpu_torch's fused_sdeint_logqp against torchsde_tpu's.

On the CPU the port runs kernels 13 and 14's plain versions; here they are
held against the Pallas kernels (_euler_logqp_fwd_kernel,
_euler_logqp_bwd_kernel) run in interpret mode on the same float32 inputs,
with weights carried over by utils/convert.load_jax_tower, by the JAX
package's own rule for its fused against its sdeint logqp solve
(tests/test_fused_solve.py:223-262): values at atol 2e-5, the KL channel at
rtol 3e-3 and atol 2e-5, gradients at rtol 5e-3 and atol max(1e-4, 1e-5 *
scale); the relative parts absorb the 1/g^2 amplification of summation
order where the diffusion passes near zero. The cases are that test's
(with and without a time column, sigmoid, linear and tanh diffusion
finals; the last two take both signs), and one whose diffusion is exactly
zero, where the clamp and its mask act on every entry. The port's entry
point is held to JAX fused_sdeint_logqp on injected noise by the same rule,
and in float64 the autograd Function and the sdeint route of
tower_sde(prior=) to JAX sdeint(logqp=True) at 1e-9 of scale. Also: the
contract checks on every dispatch path and the routes."""

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

B, D, N, DT = 8, 4, 4, 0.25
GRID = np.linspace(0.0, 1.0, N + 1)
TS = GRID[::2]
VAL_ATOL, Q_RTOL, GRAD_RTOL = 2e-5, 3e-3, 5e-3

CASES = [
    # (with_time, diffusion final): tests/test_fused_solve.py:188-194
    (False, "sigmoid"), (True, "sigmoid"), (False, "linear"), (True, "tanh"),
    (False, "zero"),
]


@pytest.fixture
def interpret():
    old = JFS._INTERPRET
    JFS._INTERPRET = True
    yield
    JFS._INTERPRET = old


def _case(with_time, gact, seed=0, dtype=np.float32):
    """Drift and prior (softplus, linear; hidden 16) and diffusion triples
    as the JAX package's test builds them, y0, noise and cotangents of ys
    and of qs."""
    rng = np.random.default_rng(seed)
    n_in = D + (1 if with_time else 0)
    drift = _triples(rng, [n_in, 16, D], ["softplus", "linear"], dtype=dtype)
    prior = _triples(rng, [n_in, 16, D], ["softplus", "linear"], dtype=dtype)
    if gact == "sigmoid":
        diffusion = _triples(rng, [n_in, D], ["sigmoid"], dtype=dtype)
    elif gact == "zero":
        diffusion = [(np.zeros((n_in, D), dtype), np.zeros(D, dtype),
                      "linear")]
    else:
        diffusion = _triples(rng, [n_in, 8, D], ["lipswish", gact],
                             scale=0.8, dtype=dtype)
    y0 = rng.standard_normal((B, D)).astype(dtype)
    noise = (np.sqrt(DT) * rng.standard_normal((N, B, D))).astype(dtype)
    gy = rng.standard_normal((N, B, D)).astype(dtype)
    gq = rng.standard_normal((N, B, 1)).astype(dtype)
    return drift, prior, diffusion, y0, noise, gy, gq


def _jax_tower(triples):
    return JFS.TowerSpec([(jnp.asarray(w), jnp.asarray(b), act)
                          for w, b, act in triples])


def _port_towers(triples_list, dtype=torch.float32):
    return [load_jax_tower(tr, device="cpu", dtype=dtype)
            for tr in triples_list]


def _times():
    g = GRID.astype(np.float32)
    return g[:-1], g[1:] - g[:-1]


def _assert_grads_close(got, want):
    """Per tensor, rtol 5e-3 and atol max(1e-4, 1e-5 * its largest
    entry)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = float(np.max(np.abs(w)))
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=GRAD_RTOL,
                                   atol=max(1e-4, 1e-5 * scale))


@pytest.mark.parametrize("with_time,gact", CASES)
def test_plain_versions_match_pallas_kernels_f32(interpret, with_time, gact):
    """Kernels 13 and 14's plain versions against the Pallas kernels: ys,
    qs, and dy0, dnoise and every weight gradient of the three towers."""
    ftr, htr, gtr, y0, noise, gy, gq = _case(with_time, gact)
    jf, jh, jg = (_jax_tower(t) for t in (ftr, htr, gtr))
    drift, prior, diffusion = _port_towers((ftr, htr, gtr))
    spec = TFS.solve_spec(drift, diffusion, D, D, True, with_time,
                          prior=prior)
    t0s, dts = _times()
    solve = JFS._make_euler_logqp(jf.acts, jh.acts, jg.acts, D, with_time,
                                  jnp.float32)
    (ys_j, qs_j), res = solve.fwd(jf.pack(), jh.pack(), jg.pack(),
                                  jnp.asarray(y0), jnp.asarray(noise),
                                  jnp.asarray(t0s), jnp.asarray(dts))
    args = (to_torch(y0), to_torch(noise), to_torch(t0s), to_torch(dts),
            drift.pack(), prior.pack(), diffusion.pack(), spec)
    with torch.no_grad():
        ys, qs = TFS.euler_logqp_solve_forward_plain(*args)
    assert ys.shape == (N, B, D) and qs.shape == (N, B, 1)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=0,
                               atol=VAL_ATOL)
    np.testing.assert_allclose(qs.numpy(), np.asarray(qs_j), rtol=Q_RTOL,
                               atol=VAL_ATOL)
    assert float(qs.abs().max()) > 1e-2                 # the KL is live

    jgrads = solve.bwd(res, (jnp.asarray(gy), jnp.asarray(gq)))
    ginc = to_torch(np.cumsum(gq[::-1], axis=0)[::-1])
    with torch.no_grad():
        dy0, dnoise, dfw, dhw, dgw = TFS.euler_logqp_solve_backward_plain(
            *args, ys, to_torch(gy), ginc)
    _assert_grads_close(
        [dy0, dnoise] + _port_grads(dfw, ftr) + _port_grads(dhw, htr)
        + _port_grads(dgw, gtr),
        [jgrads[3], jgrads[4]] + _unpad(jgrads[0], ftr)
        + _unpad(jgrads[1], htr) + _unpad(jgrads[2], gtr))


def _injected_noise(monkeypatch, key):
    """JAX's grid noise of ``key`` at the logqp size (B, d+1), handed to the
    port's draw site."""
    W = JI.sample_grid_noise(key, GRID, (B, D + 1), jnp.float32)[0]

    def draw(generator, grid, size, dtype, device=None, **kwargs):
        assert size == (B, D + 1) and np.allclose(grid, GRID)
        return to_torch(W).to(dtype), None, None

    monkeypatch.setattr(TI, "sample_grid_noise", draw)


def _respec(params, triples):
    return JFS.TowerSpec([(w, b, a) for (w, b), (_, _, a)
                          in zip(params, triples)])


@pytest.mark.parametrize("with_time,gact", CASES[:4])
def test_fused_sdeint_logqp_matches_jax(interpret, monkeypatch, with_time,
                                        gact):
    """The whole entry point (noise, grid times, the solve, the gather onto
    ts and the KL increments) on the CPU against JAX fused_sdeint_logqp
    through the Pallas kernels: ys, log_ratio and the gradients of
    sum(ys**2) + sum(mean(log_ratio, 1)) to every tower tensor and y0."""
    ftr, htr, gtr, y0, _, _, _ = _case(with_time, gact, seed=1)
    key = jax.random.PRNGKey(7)
    _injected_noise(monkeypatch, key)
    kw = dict(with_time=with_time, dispatch="fused")

    def loss_jax(fp, hp, gp, y):
        ys, kl = JFS.fused_sdeint_logqp(
            _respec(fp, ftr), _respec(hp, htr), _respec(gp, gtr), y, TS,
            key, DT, **kw)
        return jnp.sum(ys ** 2) + jnp.sum(jnp.mean(kl, axis=1)), (ys, kl)

    jp = tuple([(jnp.asarray(w), jnp.asarray(b)) for w, b, _ in tr]
               for tr in (ftr, htr, gtr)) + (jnp.asarray(y0),)
    (_, (ys_j, kl_j)), jgrads = jax.value_and_grad(
        loss_jax, argnums=(0, 1, 2, 3), has_aux=True)(*jp)

    towers = _port_towers((ftr, htr, gtr))
    leaves = [t.requires_grad_() for spec in towers
              for (w, b, _) in spec.layers for t in (w, b)]
    y0_t = to_torch(y0).requires_grad_()
    ys, kl = TFS.fused_sdeint_logqp(*towers, y0_t, TS, None, DT, **kw)
    assert ys.shape == (len(TS), B, D) and kl.shape == (len(TS) - 1, B)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j),
                               rtol=0, atol=VAL_ATOL)
    np.testing.assert_allclose(kl.detach().numpy(), np.asarray(kl_j),
                               rtol=Q_RTOL, atol=VAL_ATOL)
    ((ys ** 2).sum() + kl.mean(1).sum()).backward()
    _assert_grads_close([t.grad for t in leaves] + [y0_t.grad],
                        jax.tree_util.tree_leaves(jgrads))


@pytest.mark.parametrize("with_time,gact", CASES)
def test_function_and_sdeint_route_match_jax_sdeint_f64(monkeypatch,
                                                        with_time, gact):
    """FusedEulerLogqpSolve on the plain versions, and the port's sdeint
    route of tower_sde(prior=), against JAX sdeint(logqp=True) of the same
    towers in float64 on JAX's noise of one key: ys, log_ratio and every
    gradient (three towers and y0) at 1e-9 of scale."""
    ftr, htr, gtr, y0, _, _, _ = _case(with_time, gact, seed=2,
                                       dtype=np.float64)
    key = jax.random.PRNGKey(3)

    def loss_jax(fp, hp, gp, y):
        sde = JFS.tower_sde(_respec(fp, ftr), _respec(gp, gtr), "diagonal",
                            "ito", with_time=with_time,
                            prior=_respec(hp, htr))
        ys, kl = jax_sdeint(sde, y, TS, method="euler", dt=DT, key=key,
                            logqp=True)
        return jnp.sum(ys ** 2) + jnp.sum(jnp.mean(kl, axis=1)), (ys, kl)

    jp = tuple([(jnp.asarray(w), jnp.asarray(b)) for w, b, _ in tr]
               for tr in (ftr, htr, gtr)) + (jnp.asarray(y0),)
    (_, (ys_j, kl_j)), jgrads = jax.value_and_grad(
        loss_jax, argnums=(0, 1, 2, 3), has_aux=True)(*jp)
    want_grads = jax.tree_util.tree_leaves(jgrads)
    W = to_torch(JI.sample_grid_noise(key, GRID, (B, D + 1),
                                      jnp.float64)[0])
    monkeypatch.setattr(TI, "sample_grid_noise",
                        lambda *args, **kwargs: (W, None, None))

    for route in ("function", "sdeint"):
        towers = _port_towers((ftr, htr, gtr), dtype=torch.float64)
        drift, prior, diffusion = towers
        leaves = [t.requires_grad_() for spec in towers
                  for (w, b, _) in spec.layers for t in (w, b)]
        y0_t = to_torch(y0).requires_grad_()
        if route == "function":
            spec = TFS.solve_spec(drift, diffusion, D, D, True, with_time,
                                  prior=prior)
            ys, qs = TFS.logqp_solve_on_grid(drift, prior, diffusion, y0_t,
                                             W[..., :D], GRID, spec)
            ys, qs = ys[::2], qs[::2, :, 0]
            kl = qs[1:] - qs[:-1]
        else:
            sde = TFS.tower_sde(drift, diffusion, "diagonal", "ito",
                                with_time=with_time, prior=prior)
            ys, kl = port_sdeint(sde, y0_t, TS, method="euler", dt=DT,
                                 logqp=True)
        for got, want in ((ys, ys_j), (kl, kl_j)):
            np.testing.assert_allclose(
                got.detach().numpy(), np.asarray(want), rtol=0,
                atol=1e-9 * float(np.abs(want).max()))
        ((ys ** 2).sum() + kl.mean(1).sum()).backward()
        for got, want in zip([t.grad for t in leaves] + [y0_t.grad],
                             want_grads):
            scale = float(np.max(np.abs(want)))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-9 * scale,
                                       err_msg=route)


def _narrow(seed=3, d=3, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [load_jax_tower(_triples(rng, [d, 8, d], acts), device="cpu",
                           dtype=dtype)
            for acts in (["softplus", "linear"], ["softplus", "linear"],
                         ["lipswish", "sigmoid"])]


@pytest.mark.parametrize("dispatch", ["fused", "xla", "auto"])
def test_contract_on_every_dispatch_path(dispatch):
    """The grid guard and the towers' widths are checked on every path."""
    towers = _narrow()
    y0 = torch.zeros((4, 3))
    gen = torch.Generator()
    with pytest.raises(ValueError, match="dt step grid"):
        TFS.fused_sdeint_logqp(*towers, y0, [0.0, 0.3, 1.0], gen, 0.25,
                               dispatch=dispatch)
    drift, prior, diffusion = towers
    wide = load_jax_tower(_triples(np.random.default_rng(0), [3, 8, 4],
                                   ["softplus", "linear"]), device="cpu")
    with pytest.raises(ValueError, match="prior tower must output"):
        TFS.fused_sdeint_logqp(drift, wide, diffusion, y0, [0.0, 1.0], gen,
                               0.5, dispatch=dispatch)
    with pytest.raises(ValueError, match="input width"):
        TFS.fused_sdeint_logqp(*towers, y0, [0.0, 1.0], gen, 0.5,
                               with_time=True, dispatch=dispatch)


def test_dispatch_dtype_contract_and_argument_checks():
    """Both usable paths compute in the towers' dtype (bf16 towers and a
    float32 y0 give bf16 states); 'fused' takes float32 towers only."""
    towers = _narrow(dtype=torch.bfloat16)
    y0 = torch.zeros((4, 3), dtype=torch.float32)
    ts = np.linspace(0.0, 1.0, 3)
    for dispatch in ("xla", "auto"):
        ys, kl = TFS.fused_sdeint_logqp(*towers, y0, ts,
                                        torch.Generator().manual_seed(0),
                                        0.5, dispatch=dispatch)
        assert ys.dtype == kl.dtype == torch.bfloat16, dispatch
    with pytest.raises(ValueError, match="float32-only"):
        TFS.fused_sdeint_logqp(*towers, y0, ts, torch.Generator(), 0.5,
                               dispatch="fused")
    with pytest.raises(ValueError, match="dispatch"):
        TFS.fused_sdeint_logqp(*_narrow(), y0, ts, torch.Generator(), 0.5,
                               dispatch="pallas")


def _auto_and_sdeint(dtype):
    towers = _narrow(dtype=dtype)
    y0 = torch.as_tensor(np.random.default_rng(4).standard_normal((4, 3)),
                         dtype=dtype)
    ts = np.linspace(0.0, 1.0, 3)
    got = TFS.fused_sdeint_logqp(*towers, y0, ts,
                                 torch.Generator().manual_seed(5), 0.5)
    drift, prior, diffusion = towers
    sde = TFS.tower_sde(drift, diffusion, "diagonal", "ito", prior=prior)
    want = port_sdeint(sde, y0, ts, method="euler", dt=0.5, logqp=True,
                       generator=torch.Generator().manual_seed(5))
    return towers, y0, ts, got, want


def test_auto_on_narrow_float32_towers_equals_fused():
    """'auto' runs the kernels for every float32 solve (on the CPU their
    plain versions): narrow towers give bitwise what dispatch='fused'
    gives, and agree with the sdeint route on the same generator seed."""
    towers, y0, ts, got, want = _auto_and_sdeint(torch.float32)
    fused = TFS.fused_sdeint_logqp(*towers, y0, ts,
                                   torch.Generator().manual_seed(5), 0.5,
                                   dispatch="fused")
    for a, b, c in zip(got, fused, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6)


def test_auto_on_float64_equals_the_sdeint_route_bitwise():
    """'auto' sends float64 towers to the sdeint route, with the same noise
    from the same generator seed (the counterpart of the JAX package's
    logqp fallback parity, tests/test_fused_solve.py:291-300)."""
    assert not TFS._auto_fuse(torch.float64)
    _, _, _, got, want = _auto_and_sdeint(torch.float64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _port_args(with_time=True, gact="tanh", seed=5):
    ftr, htr, gtr, y0, noise, gy, gq = _case(with_time, gact, seed=seed)
    drift, prior, diffusion = _port_towers((ftr, htr, gtr))
    spec = TFS.solve_spec(drift, diffusion, D, D, True, with_time,
                          prior=prior)
    t0s, dts = _times()
    packs = [t.pack().detach() for t in (drift, prior, diffusion)]
    return spec, (*packs, to_torch(y0), to_torch(noise), to_torch(t0s),
                  to_torch(dts)), to_torch(gy), to_torch(gq)


def test_cpu_gradients_run_the_function_and_no_kernel():
    """On CPU tensors FusedEulerLogqpSolve's backward is the plain sweep on
    the reverse cumulative sum of the qs cotangent, and no kernel runs."""
    before = (TFS.logqp_launches, TFS.logqp_bwd_launches)
    spec, args, gy, gq = _port_args()
    leaves = [a.requires_grad_() for a in args[:5]]
    ys, qs = TFS.FusedEulerLogqpSolve.apply(spec, *args)
    assert type(ys.grad_fn).__name__.startswith("FusedEulerLogqp")
    got = torch.autograd.grad((ys, qs), leaves, (gy, gq))
    fw, hw, gw, y0, noise, t0s, dts = (a.detach() for a in args)
    with torch.no_grad():
        dy0, dnoise, dfw, dhw, dgw = TFS.euler_logqp_solve_backward_plain(
            y0, noise, t0s, dts, fw, hw, gw, spec, ys,
            gy, gq.flip(0).cumsum(0).flip(0))
    for g, w in zip(got, (dfw, dhw, dgw, dy0, dnoise)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (TFS.logqp_launches, TFS.logqp_bwd_launches) == before


@pytest.mark.parametrize("gact", ["tanh", "zero"])
def test_backward_plain_matches_autograd_f64(gact):
    """The hand-derived sweep against autograd of the forward plain
    version, every input, at 1e-9 of each gradient's scale; with a zero
    diffusion the clamp's mask acts on every entry."""
    spec, args, gy, gq = _port_args(gact=gact, seed=6)
    args = [a.double() for a in args]
    gy, gq = gy.double(), gq.double()
    leaves = [a.requires_grad_() for a in args[:5]]
    fw, hw, gw, y0, noise, t0s, dts = args
    ys, qs = TFS.euler_logqp_solve_forward_plain(y0, noise, t0s, dts, fw,
                                                 hw, gw, spec)
    want = torch.autograd.grad((ys * gy).sum() + (qs * gq).sum(), leaves)
    with torch.no_grad():
        got = TFS.euler_logqp_solve_backward_plain(
            *[a.detach() for a in (y0, noise, t0s, dts, fw, hw, gw)], spec,
            ys.detach(), gy, gq.flip(0).cumsum(0).flip(0))
    for g, i in zip(got, (3, 4, 0, 1, 2)):   # dy0, dnoise, dfw, dhw, dgw
        scale = float(want[i].abs().max())
        assert scale > 0 or (gact == "zero" and i == 4)  # dnoise = dy g
        torch.testing.assert_close(g, want[i], rtol=0, atol=1e-9 * scale)


def test_other_devices_raise_instead_of_falling_back():
    spec, args, gy, gq = _port_args()
    with pytest.raises(ValueError, match="no fused tower solve"):
        TFS.FusedEulerLogqpSolve.apply(spec, *[a.to("meta") for a in args])
    fw, hw, gw, y0, noise, t0s, dts = args
    with pytest.raises(ValueError, match="CUDA tensors"):
        TFS.euler_logqp_solve_forward_cuda(y0, noise, t0s, dts, fw, hw, gw,
                                           spec)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TFS.euler_logqp_solve_backward_cuda(y0, noise, t0s, dts, fw, hw, gw,
                                            spec, noise, gy, gq)


@pytest.mark.parametrize("fault", ["no_prior", "general", "prior_io",
                                   "hw_size"])
def test_spec_and_input_checks(fault):
    spec, (fw, hw, gw, y0, noise, t0s, dts), _, _ = _port_args()
    assert TFS._check_logqp(spec, y0, noise, t0s, dts, fw, hw, gw) == (B, N)
    if fault == "no_prior":
        spec = spec._replace(prior=())
    elif fault == "general":
        spec = spec._replace(diag=False)
    elif fault == "prior_io":
        spec = spec._replace(prior=spec.prior[:1] + ((16, 3, "linear"),))
    else:
        hw = hw[:-1]
    with pytest.raises(ValueError):
        TFS._check_logqp(spec, y0, noise, t0s, dts, fw, hw, gw)


def test_layer_table_with_prior():
    spec, _, _, _ = _port_args(with_time=False, gact="sigmoid")
    np.testing.assert_array_equal(
        TFS.layer_table(spec),
        [4, 16, 0, 16, 4, 4, 4, 4, 2, 4, 16, 0, 16, 4, 4])
    assert TFS._dims(spec) == (2, 1, 2, 4, 4, 1, 0)


def test_tower_sde_prior_gives_h():
    drift, prior, diffusion = _narrow()
    sde = TFS.tower_sde(drift, diffusion, "diagonal", "ito", prior=prior)
    y = torch.randn(5, 3)
    t = torch.tensor(0.0)
    want = TFS.tower_forward(y, [(w, b) for w, b, _ in prior.layers],
                             prior.acts)[0]
    assert torch.equal(sde.h(t, y), want)
    assert not hasattr(TFS.tower_sde(drift, diffusion, "diagonal", "ito"),
                       "h")


class _Layouts:
    """Stands in for the kernels' library: the shared memory a block of
    each staging takes (the layout function's numbers for batch 4096, d 32,
    hidden 128 and its logqp sweep), and the blocks of a batch."""

    def __init__(self, sizes):
        self.sizes = sizes

    def tsde_tower_smem_bytes(self, kind, table, *dims_and_stage):
        return self.sizes[dims_and_stage[-1]]

    @staticmethod
    def tsde_tower_blocks(B):
        return (B + 7) // 8


@pytest.mark.parametrize("kind,B,want", [
    (TFS.EULER_LOGQP_FWD, 4096, 0),    # many blocks: a forward stages none
    (TFS.EULER_LOGQP_BWD, 4096, 5),    # drift and prior leave two an SM
    (TFS.EULER_LOGQP_BWD, 1024, 7),    # one wave: all that fit a block
    (TFS.EULER_LOGQP_FWD, 1024, 7),
])
def test_staging_rule(monkeypatch, kind, B, want):
    monkeypatch.setattr(TFS, "_sm_count", lambda device: 132)
    sizes = {7: 147440, 5: 113392, 3: 113392, 6: 113392, 1: 79344,
             4: 79344, 2: 79344, 0: 45296}
    spec, _, _, _ = _port_args()
    assert TFS.staged_towers(_Layouts(sizes), kind, spec, B, None) == want
    two = spec._replace(prior=())
    assert TFS.staged_towers(_Layouts({3: 98976, 1: 64928, 2: 64928,
                                       0: 30880}),
                             TFS.EULER_BWD, two, 4096, None) == 3
    big = {**sizes, 7: 240000}                 # all three no longer fit
    assert TFS.staged_towers(_Layouts(big), TFS.EULER_LOGQP_BWD, spec,
                             1024, None) == 5
