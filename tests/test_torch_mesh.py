"""The port's mesh (``torchsde_tpu_torch/parallel/mesh.py``) against
``tests/test_parallel.py``: a sharded solve, the latent data-parallel step,
the fused solve on each shard, the tensor-parallel fallback and the
guards.

The JAX references run here, in the test process (the conftest's 8
virtual CPU devices, float64). The port's ranks are processes of their
own (``mesh.run_ranks``: spawn, gloo, a FileStore in a temporary
directory), running the functions of ``tests/mesh_ranks.py``, which never
import JAX; the JAX package's draws reach them as tables, each rank taking
its rows. Tolerances: the port's ranks against one port process at 1e-12
(float64 sums split over the ranks), against the JAX package at 1e-9 of
each quantity's scale."""

import functools
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks as MR
import problems
import torchsde_tpu as jtsde
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.ops.latent_fused as TLF
from mesh_refs import (DT, KEY, LR, PORT, SPLIT, TS, WORLD, close,
                       jax_latent_sde, latent_case, latent_cfg, run,
                       single_step, T)
from port_bridge import jax_named_arrays, port_latent_sde, to_torch
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models.layers import MLP as JMLP
from torchsde_tpu.parallel import mesh as pmesh
from torchsde_tpu_torch.parallel import mesh as PM


# --------------------------------------------------------------------------- #
#  The cases on 8 ranks, in one start of the ranks                            #
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def sharded_case():
    """test_parallel.py:25's problem, data and interval: the JAX package's
    ys, the nets' weights and the rank function's arguments."""
    sde = problems.NeuralDiagonal(d=3, sde_type="stratonovich")
    y0 = np.full((16, 3), 0.1)
    ts = [0.0, 0.2, 0.4]
    bm = jtsde.BrownianInterval(0.0, 0.4, (16, 3), dtype=jnp.float64,
                                entropy=5, levels=8)
    want = np.asarray(jax.jit(lambda s, y: jtsde.sdeint(
        s, y, ts, bm=bm, method="midpoint", dt=0.05))(sde, jnp.asarray(y0)))
    nets = [{n: np.asarray(getattr(net, n)) for n in ("w1", "b1", "w2", "b2")}
            for net in (sde.f_net, sde.g_net)]
    return want, nets, (*nets, y0, ts)


FUSED_B, FUSED_T, FUSED_DT = 16, 6, 1.0 / 32
FUSED_TS = np.linspace(0.0, 1.0, FUSED_T)


@functools.lru_cache(maxsize=None)
def fused_case():
    """test_parallel.py:211's model (3, 4, 16, 32), context and initial
    states, W of one key, the JAX package's sdeint of the logqp solve on
    them, and the rank function's configuration."""
    ts, dt = FUSED_TS, FUSED_DT
    jmodel = jax_latent_sde(KEY, 4, 16, 32, seed=4)
    xs = jax.random.normal(jax.random.fold_in(KEY, 1), (FUSED_T, FUSED_B, 3),
                           jnp.float64)
    ctx = jmodel.encode(xs, jnp.asarray(ts))
    jm = jmodel.contextualize(ts, ctx)
    z0 = jax.random.normal(jax.random.fold_in(KEY, 2), (FUSED_B, 4),
                           jnp.float64)
    nkey = jax.random.PRNGKey(7)
    grid = JI.build_step_grid(ts[0], ts[-1], dt)
    W = np.asarray(JI.sample_grid_noise(nkey, grid, (FUSED_B, 5),
                                        jnp.float64)[0])
    want = jax.jit(lambda m, z: jtsde.sdeint(
        m, z, ts, dt=dt, method="euler", logqp=True, key=nkey))(jm, z0)
    model = port_latent_sde(jmodel, torch.float64)
    cfg = dict(model=MR.pack(model), ctx=np.asarray(ctx), z0=np.asarray(z0),
               W=W, ts=ts, dt=dt)
    return model, cfg, [np.asarray(w) for w in want]


@pytest.fixture(scope="module")
def ranks8():
    """Each 8-rank case's results by name, from one start of 8 ranks."""
    jmodel, xs, eps, W, _, _ = latent_case(2, 4, 8)
    model = port_latent_sde(jmodel, torch.float64)
    calls = {"sharded": ("sharded_solve", sharded_case()[2]),
             "dp": ("latent_step", (latent_cfg(model, xs, eps, W),)),
             "dp_fused": ("latent_step", (latent_cfg(model, xs, eps, W,
                                                     fused=True),)),
             "fused": ("fused_per_shard", (fused_case()[1],))}
    out = run(MR.jobs, WORLD, list(calls.values()))
    return {name: [rank[i] for rank in out]
            for i, name in enumerate(calls)}


# --------------------------------------------------------------------------- #
#  A sharded solve (test_parallel.py:25)                                      #
# --------------------------------------------------------------------------- #

def test_sharded_solve_matches_single_process_and_jax(ranks8):
    """A midpoint Stratonovich solve of NeuralDiagonal, 16 x 3 over 8 ranks:
    each rank's rows, on its rows of one explicit BrownianInterval
    (entropy 5, the JAX package's bits), equal one process's solve and the
    JAX package's."""
    want, nets, (_, _, y0, ts) = sharded_case()
    ranks = ranks8["sharded"]
    single = MR.solve_neural_diagonal(
        MR.NeuralDiagonal(*nets, "stratonovich"), torch.as_tensor(y0), ts,
        MR.interval_16x3())
    for r, out in enumerate(ranks):
        assert out["coords"] == {"data": r}
        rows = slice(2 * r, 2 * r + 2)
        close(out["ys"], single[:, rows], SPLIT)
        close(out["ys"], want[:, rows], PORT)
    close(torch.cat([out["ys"] for out in ranks], dim=1), want, PORT)


# --------------------------------------------------------------------------- #
#  The latent data-parallel step (test_parallel.py:45)                        #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("fused", [False, True])
def test_dp_train_step_matches_single_process_and_jax(ranks8, fused):
    """8 ranks, batch 16, the model replicated: every rank's loss is the
    whole batch's, and every rank's parameters after the step are one
    process's and the JAX package's (its gradients, the same step). With
    ``fused`` each rank runs FusedLatentSolve (kernels 1 and 2's plain
    versions here)."""
    jmodel, xs, eps, W, jloss, jgrads = latent_case(2, 4, 8)
    model = port_latent_sde(jmodel, torch.float64)
    ranks = ranks8["dp_fused" if fused else "dp"]
    loss, grads, params = single_step(model, xs, eps, W, fused)
    jparams = jax_named_arrays(jmodel)
    assert len(params) == 28
    for out in ranks:
        close(out["loss"], loss, SPLIT)
        close(out["loss"], jloss, PORT)
        for name, p in out["params"].items():
            close(p, params[name], SPLIT)
            close(p, jparams[name] - LR * jgrads[name], PORT)
            close(out["grads"][name], jgrads[name], PORT)


# --------------------------------------------------------------------------- #
#  The fused solve on each shard (test_parallel.py:211)                       #
# --------------------------------------------------------------------------- #

def test_fused_latent_solve_per_shard(ranks8):
    """LatentSDE(3, 4, 16, 32), batch 16 over 8 ranks, dt 1/32: each rank
    runs the fused solve (FusedLatentSolve; on the CPU its plain version,
    no kernel launch). With shard-local generators the ranks' paths from
    equal initial states differ; on the global W sliced, the ranks' rows
    are one process's fused solve and the JAX package's sdeint."""
    model, cfg, (want_zs, want_lr) = fused_case()
    ranks = ranks8["fused"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TI, "sample_grid_noise", lambda *a, **k: (
            to_torch(cfg["W"]), None, None))
        with torch.no_grad():
            zs, log_ratio = TLF.latent_logqp_solve_fused(
                model.contextualize(FUSED_TS, to_torch(cfg["ctx"])),
                to_torch(cfg["z0"]), FUSED_TS, None, FUSED_DT)
    for r, out in enumerate(ranks):
        assert out["rows"] == (2 * r, 2 * r + 2) and out["launches"] == 0
        rows = slice(*out["rows"])
        close(out["zs"], zs[:, rows], SPLIT)
        close(out["log_ratio"], log_ratio[:, rows], SPLIT)
        close(out["zs"], want_zs[:, rows], PORT)
        close(out["log_ratio"], want_lr[:, rows], PORT)
        assert torch.isfinite(out["same_start"]).all()
    finals = [out["same_start"][-1] for out in ranks]
    for a in range(WORLD):
        for b in range(a + 1, WORLD):
            assert not torch.allclose(finals[a], finals[b])


# --------------------------------------------------------------------------- #
#  Tensor-parallel fallback (test_parallel.py:261) and the guards             #
# --------------------------------------------------------------------------- #

FALLBACK_SIZES = ((4, 5, 3), (4, 8, 4), (4, 5, 8, 4))


@pytest.fixture(scope="module")
def fallback_ranks():
    return run(MR.tp_fallback, 4)


@pytest.mark.parametrize("sizes", FALLBACK_SIZES)
def test_tp_fallback_warns_as_jax(fallback_ranks, sizes):
    """On a 2 x 2 mesh, shard_mlp_tp warns with the JAX package's words, in
    its order, for each array whose split width does not divide (none for
    divisible widths), keeps those layers whole, and the MLP's output is
    the whole MLP's."""
    mesh = pmesh.make_mesh_2d(n_model=2, devices=jax.devices()[:4])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pmesh.shard_mlp_tp(JMLP(KEY, sizes=list(sizes)), mesh)
    want = [str(r.message) for r in rec]
    assert ("fallback" in " ".join(want)) == (5 in sizes)
    kinds = {(4, 5, 3): ["Linear", "Linear"],
             (4, 8, 4): ["ColumnParallelLinear", "RowParallelLinear"],
             (4, 5, 8, 4): ["Linear", "Linear", "ColumnParallelLinear"]}
    for out in fallback_ranks:
        got = out[sizes]
        assert got["messages"] == want
        assert got["kinds"] == kinds[sizes]
        close(got["got"], got["want"], SPLIT)


@pytest.fixture(scope="module")
def guard_ranks():
    jmodel = jax_latent_sde(KEY, 4, 8, 16, seed=5)
    xs = np.random.default_rng(0).standard_normal((T, 4, 3))
    cfg = dict(model=MR.pack(port_latent_sde(jmodel, torch.float64)), xs=xs,
               ts=TS, dt=DT)
    return run(MR.guards, 2, cfg)


@pytest.mark.parametrize("name,match", [
    ("n_model", "2 ranks not divisible by n_model=3"),
    ("world", "a mesh of 3 ranks in a process group of 2"),
    ("batch", "not divisible by mesh axis 'data' \\(size 2\\)"),
    ("fused_tp", "takes whole weights")])
def test_mesh_guards(guard_ranks, name, match):
    """Each refusal raises ValueError on every rank: a model axis that does
    not divide the ranks (as make_mesh_2d's JAX counterpart), a mesh of
    another size than the group, a batch the data axis does not divide, the
    fused route on a tensor-parallel model."""
    for out in guard_ranks:
        assert out[name] is not None and re.search(match, out[name]), out


def test_mesh_on_the_card_by_default():
    """Without a card, make_mesh and run_ranks raise unless given
    device='cpu', as every entry point of the port; the step takes exactly
    one of lr and optimizer_update."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.run_ranks(MR.guards, 2)
    with pytest.raises(ValueError, match="exactly one"):
        PM.data_parallel_train_step(lambda *a: 0, None)
    with pytest.raises(ValueError, match="exactly one"):
        PM.data_parallel_train_step(lambda *a: 0, None, lr=1.0,
                                    optimizer_update=lambda g, p: g)
