"""K stacked latent replicas over the port's mesh against
``tests/test_parallel.py:326`` (replicas x data parallelism on a (replica,
data) mesh) and ``:414`` (the replica axis sharded over the ranks): each
replica's loss and parameters after one SGD step equal one port process's
``replica_train_step`` on all K (1e-12) and the JAX package's value and
gradient of that replica's loss (1e-9 of scale). Each rank solves its
replicas through the K-replica fused route (``FusedLatentSolveMulti``,
kernels 3 and 4's plain versions on the CPU). The ranks run
``tests/mesh_ranks.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks as MR
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.models.latent_sde as TL
from mesh_refs import PORT, SPLIT, WORLD, close, run
from port_bridge import (jax_named_arrays, port_latent_sde, seeded_leaves,
                         to_torch)
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import latent_sde as JL
from torchsde_tpu_torch.parallel import replicas as RP

T, B, DATA = 4, 8, 3
TS = np.linspace(0.0, 1.0, T)
DT, LR = 0.25, 0.5


@functools.lru_cache(maxsize=None)
def replica_case(K, seed, per_replica):
    """K JAX LatentSDE(3, 2, 8, 16)s (every weight moved off its initial
    value), their batches, the draws of their keys, and each replica's JAX
    loss and gradients."""
    key = jax.random.PRNGKey(seed)
    models = seeded_leaves(jax.eval_shape(jax.vmap(lambda k: JL.LatentSDE(
        k, DATA, 2, 8, 16, dtype=jnp.float64)), jax.random.split(
            jax.random.fold_in(key, 2), K)), seed=6)
    skeys = jax.random.split(jax.random.fold_in(key, 4), K)
    shape = (K, T, B, DATA) if per_replica else (T, B, DATA)
    xs = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), shape,
                                      jnp.float64))
    grid = JI.build_step_grid(TS[0], TS[-1], DT)
    eps = np.stack([np.asarray(jax.random.normal(k, (B, 2), jnp.float64))
                    for k in skeys])
    W = np.stack([np.asarray(JI.sample_grid_noise(
        jax.random.fold_in(k, 1), grid, (B, 3), jnp.float64)[0])
        for k in skeys])
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda m, x, k: JL.latent_sde_loss(m, x, TS, k, dt=DT)[0]))
    replicas = [jax.tree_util.tree_map(lambda a: a[k], models)
                for k in range(K)]
    jax_out = []
    for k, m in enumerate(replicas):
        loss, grads = value_and_grad(m, jnp.asarray(xs[k] if per_replica
                                                    else xs), skeys[k])
        grads = jax_named_arrays(grads)
        params = jax_named_arrays(m)
        jax_out.append((float(loss), {n: params[n] - LR * grads[n]
                                      for n in grads}))
    port = RP.stack_replicas(lambda m: m, [
        port_latent_sde(m, torch.float64) for m in replicas])
    return port, xs, eps, W, jax_out


def single_replica_step(port, xs, eps, W, per_replica):
    """``replica_train_step`` on all K replicas in one port process, the
    K-replica fused route's loss of each, every replica drawing its own
    eps and W (keyed by its generator)."""
    models = MR.unpack(MR.pack(port))
    K = len(models)
    gens = [torch.Generator() for _ in range(K)]
    with pytest.MonkeyPatch.context() as mp:
        which = {id(g): k for k, g in enumerate(gens)}
        mp.setattr(TL, "_standard_normal", lambda shape, g, dtype, device:
                   to_torch(eps[which[id(g)]]))
        mp.setattr(TI, "sample_grid_noise", lambda g, grid, size, dtype,
                   device=None, **kw: (to_torch(W[which[id(g)]]), None,
                                       None))

        def loss_fn(m, batch, generator):
            return TL.latent_sde_loss(m, batch, TS, generator, dt=DT,
                                      fused=True)[0]

        batches = [to_torch(xs[k] if per_replica else xs) for k in range(K)]
        models, losses = RP.replica_train_step(loss_fn, lr=LR)(
            models, batches, gens)
    return losses, models.params


def check_replica(k, loss, params, single, jax_out):
    """Replica k's loss and parameters against one process's and JAX's."""
    losses, stacked = single
    close(loss, losses[k], SPLIT)
    close(loss, jax_out[k][0], PORT)
    assert len(params) == 28 and set(params) <= set(jax_out[k][1])
    for name, p in params.items():
        close(p, stacked[name][k], SPLIT)
        close(p, jax_out[k][1][name], PORT)


CASES = {"dp": (4, 11, True), "sharded": (8, 9, False)}   # K, seed, own xs


@pytest.fixture(scope="module")
def replica_ranks():
    """Both cases on 8 ranks, one after the other in one start of the
    ranks."""
    calls = []
    for name, fn in (("dp", "replicas_dp"), ("sharded", "replicas_sharded")):
        K = CASES[name][0]
        port, xs, eps, W, _ = replica_case(*CASES[name])
        calls.append((fn, (dict(models=MR.pack(port), xs=xs, eps=eps, W=W,
                                ts=TS, dt=DT, lr=LR, K=K),)))
    out = run(MR.jobs, WORLD, calls)
    return {name: [rank[i] for rank in out] for i, name in enumerate(CASES)}


def test_replica_dp_2d_mesh(replica_ranks):
    """K 4 replicas on the ``replica`` axis of a 4 x 2 (replica, data) mesh,
    each data-parallel over its pair of ranks on its own batch (8 rows, 4 a
    rank): gradients are averaged only within a replica's data group, and
    every replica equals its single-process training."""
    port, xs, eps, W, jax_out = replica_case(*CASES["dp"])
    ranks = replica_ranks["dp"]
    single = single_replica_step(port, xs, eps, W, True)
    for r, out in enumerate(ranks):
        assert out["replicas"] == (r // 2, r // 2 + 1)
        assert out["rows"] == (4 * (r % 2), 4 * (r % 2) + 4)
        assert out["data_ranks"] == [r - r % 2, r - r % 2 + 1]
        k = r // 2
        check_replica(k, out["losses"][0], {n: p[0] for n, p in
                                            out["params"].items()},
                      single, jax_out)


def test_replicas_sharded_over_mesh(replica_ranks):
    """K 8 replicas sharded over 8 ranks, one each, trained by
    ``replica_train_step`` with no collective: each rank's replica is its
    slice of one process's K-replica step and the JAX package's."""
    port, xs, eps, W, jax_out = replica_case(*CASES["sharded"])
    ranks = replica_ranks["sharded"]
    single = single_replica_step(port, xs, eps, W, False)
    for r, out in enumerate(ranks):
        assert out["replicas"] == (r, r + 1)
        assert all(p.shape[0] == 1 for p in out["params"].values())
        check_replica(r, out["losses"][0], {n: p[0] for n, p in
                                            out["params"].items()},
                      single, jax_out)
