"""The JAX references and the comparisons of the port's mesh tests
(``tests/test_torch_mesh*.py``), run in the test process; the ranks run
``tests/mesh_ranks.py``, which never imports JAX.

Tolerances: the port's ranks against one port process at 1e-12 (float64
sums split over the ranks), against the JAX package at 1e-9 of each
quantity's scale."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks as MR
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.models.latent_sde as TL
from port_bridge import jax_named_arrays, seeded_leaves, to_torch
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import latent_sde as JL
from torchsde_tpu_torch.parallel import mesh as PM

SPLIT, PORT = 1e-12, 1e-9
WORLD = 8
TIMEOUT = 240.0


def run(fn, world, *args):
    return PM.run_ranks(fn, world, args=args, device="cpu", timeout=TIMEOUT)


def close(got, want, tol):
    """``got`` within ``tol`` of ``want``'s largest magnitude."""
    got, want = (x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)
                 for x in (got, want))
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def inject(monkeypatch, eps, W):
    """This process's port draws the tables' eps and W (all rows)."""
    monkeypatch.setattr(TL, "_standard_normal",
                        lambda shape, generator, dtype, device: to_torch(eps))
    monkeypatch.setattr(TI, "sample_grid_noise",
                        lambda generator, grid, size, dtype, device=None,
                        **kw: (to_torch(W), None, None))


T, B = 4, 16
TS = np.linspace(0.0, 0.3, T)
DT, LR = 0.1, 0.5
KEY = jax.random.PRNGKey(0)


@functools.lru_cache(maxsize=None)
def latent_case(latent, context, hidden):
    """The JAX model (every weight moved off its initial value), the data,
    the draws of ``fold_in(KEY, 3)`` and the JAX package's loss and
    gradients in float64."""
    xs = np.asarray(jax.random.normal(jax.random.fold_in(KEY, 1), (T, B, 3),
                                      jnp.float64))
    model = jax_latent_sde(jax.random.fold_in(KEY, 2), latent, context,
                           hidden, seed=3)
    skey = jax.random.fold_in(KEY, 3)
    eps = np.asarray(jax.random.normal(skey, (B, latent), jnp.float64))
    grid = JI.build_step_grid(TS[0], TS[-1], DT)
    W = np.asarray(JI.sample_grid_noise(jax.random.fold_in(skey, 1), grid,
                                        (B, latent + 1), jnp.float64)[0])
    loss, grads = jax.jit(jax.value_and_grad(lambda m: JL.latent_sde_loss(
        m, jnp.asarray(xs), TS, skey, dt=DT)[0]))(model)
    return model, xs, eps, W, float(loss), jax_named_arrays(grads)


def jax_latent_sde(key, latent, context, hidden, seed, data=3):
    """A float64 JAX LatentSDE of these widths holding seeded weights
    (``port_bridge.seeded_leaves``: no eager draw to compile)."""
    return seeded_leaves(jax.eval_shape(lambda k: JL.LatentSDE(
        k, data, latent, context, hidden, dtype=jnp.float64), key), seed)


def single_step(model, xs, eps, W, fused=False):
    """One port process's SGD step on the whole batch: the loss, the
    gradients and the parameters after the step."""
    with pytest.MonkeyPatch.context() as mp:
        inject(mp, eps, W)
        loss = TL.latent_sde_loss(model, torch.as_tensor(xs), TS, None,
                                  dt=DT, fused=fused)[0]
        names = [n for n, _ in model.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss, list(
            model.parameters()))))
    with torch.no_grad():
        params = {n: p - LR * grads[n] for n, p in model.named_parameters()}
    return float(loss.detach()), grads, params


def latent_cfg(model, xs, eps, W, **extra):
    return dict(model=MR.pack(model), xs=xs, eps=eps, W=W, ts=TS, dt=DT,
                lr=LR, **extra)


