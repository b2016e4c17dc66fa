"""The other two model families' data-parallel steps over the port's mesh
against ``tests/test_parallel.py:122`` (the SDE-GAN: the generator's
reversible-Heun solve and the critic's CDE solve, both through the adjoint)
and ``:76`` (the continuous DDPM's score-matching loss on a U-Net): the
batch and its draws split over 8 ranks, each rank's loss and parameters
after one SGD step equal one port process's step (1e-12) and the JAX
package's (1e-9 of scale), in float64. The ranks run
``tests/mesh_ranks.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks as MR
import torchsde_tpu_torch.core.integrate as TI
import torchsde_tpu_torch.models.cont_ddpm as TD
import torchsde_tpu_torch.models.sde_gan as TG
import torchsde_tpu_torch.models.unet as TU
from mesh_refs import PORT, SPLIT, WORLD, close, run
from port_bridge import (jax_named_arrays, jax_unet, port_discriminator,
                         port_generator, port_score_sde, seeded_leaves,
                         to_torch)
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.models import cont_ddpm as JD
from torchsde_tpu.models import sde_gan as JG
from torchsde_tpu.models import unet as JU


def check_step(ranks, loss, params, jloss, jparams):
    for out in ranks:
        close(out["loss"], loss, SPLIT)
        close(out["loss"], jloss, PORT)
        assert set(out["params"]) == set(params)
        for name, p in out["params"].items():
            close(p, params[name], SPLIT)
            close(p, jparams[name], PORT)


# --------------------------------------------------------------------------- #
#  SDE-GAN (test_parallel.py:122)                                             #
# --------------------------------------------------------------------------- #

GAN_B, GAN_T, GAN_LR = 16, 4, 0.05


@functools.lru_cache(maxsize=None)
def gan_case():
    """The JAX generator and critic (data 1, initial noise 3, noise 2,
    hidden 4, MLP 8, one layer) in float64, OU paths, the generator's draws
    of the step's key and the JAX package's step (SGD, the generator
    ascending, the critic's clip)."""
    key = jax.random.PRNGKey(5)
    gen = seeded_leaves(jax.eval_shape(lambda k: JG.Generator(
        k, data_size=1, initial_noise_size=3, noise_size=2, hidden_size=4,
        mlp_size=8, num_layers=1, dtype=jnp.float64),
        jax.random.fold_in(key, 1)), seed=7)
    disc = seeded_leaves(jax.eval_shape(lambda k: JG.Discriminator(
        k, data_size=1, hidden_size=4, mlp_size=8, num_layers=1,
        dtype=jnp.float64), jax.random.fold_in(key, 2)), seed=8)
    ts, paths = JG.get_ou_data(jax.random.fold_in(key, 3), GAN_B, GAN_T)
    ts, paths = np.asarray(ts), np.asarray(paths, np.float64)
    skey = jax.random.fold_in(key, 4)
    k1, k2 = jax.random.split(skey)
    init = np.asarray(jax.random.normal(k1, (GAN_B, 3), jnp.float64))
    grid = JI.build_step_grid(ts[0], ts[-1], 1.0)
    W = np.asarray(JI.sample_grid_noise(k2, grid, (GAN_B, 2),
                                        jnp.float64)[0])

    @jax.jit
    def step(gen, disc, paths):
        loss, g_gen, g_disc = JG.gan_grads(gen, disc, skey, ts, paths,
                                           dt=1.0, adjoint=True)
        gen = jax.tree_util.tree_map(lambda p, g: p - GAN_LR * g, gen, g_gen)
        disc = jax.tree_util.tree_map(lambda p, g: p - GAN_LR * g, disc,
                                      g_disc)
        return gen, disc.clip_weights(), loss

    gen2, disc2, loss = step(gen, disc, jnp.asarray(paths))
    jparams = {f"gen.{n}": a for n, a in jax_named_arrays(gen2).items()}
    jparams.update({f"disc.{n}": a for n, a in jax_named_arrays(disc2).items()
                    if n not in ("func._path_ts", "func._path_ys")})
    pair = torch.nn.ModuleDict({
        "gen": port_generator(gen, torch.float64),
        "disc": port_discriminator(disc, torch.float64)})
    return pair, ts, paths, init, W, float(loss), jparams


@pytest.fixture(scope="module")
def model_ranks():
    """Both steps on 8 ranks, one after the other in one start of the
    ranks."""
    pair, ts, paths, init, W, _, _ = gan_case()
    sde, x, u, z, emb, _, _ = ddpm_case()
    gan, ddpm = zip(*run(MR.jobs, WORLD, [
        ("gan_step", (dict(pair=MR.pack(pair), ts=ts, paths=paths,
                           init=init, W=W, lr=GAN_LR),)),
        ("ddpm_step", (dict(sde=MR.pack(sde), x=x, u=u, z=z, emb=emb,
                            lr=DDPM_LR),))]))
    return dict(gan=gan, ddpm=ddpm)


def test_dp_train_step_sde_gan(model_ranks):
    """One generator and critic step with the real paths (16) split over 8
    ranks, each rank's generator drawing its rows of the initial noise and
    of W (again in the adjoint's backward), the critic's own noise zero."""
    pair, ts, paths, init, W, jloss, jparams = gan_case()
    ranks = model_ranks["gan"]
    pair = MR.unpack(MR.pack(pair))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TG, "_standard_normal", lambda shape, g, dtype, device:
                   to_torch(init))

        def grid_noise(g, grid, size, dtype, device=None, **kw):
            if tuple(size) == W.shape[1:]:
                return to_torch(W), None, None
            return torch.zeros((len(grid) - 1, *size), dtype=dtype), None, \
                None

        mp.setattr(TI, "sample_grid_noise", grid_noise)
        loss, g_gen, g_disc = TG.gan_grads(pair["gen"], pair["disc"], None,
                                           ts, to_torch(paths), dt=1.0,
                                           adjoint=True)
    with torch.no_grad():
        for name, p in pair["gen"].named_parameters():
            p -= GAN_LR * g_gen[name]
        for name, p in pair["disc"].named_parameters():
            p -= GAN_LR * g_disc[name]
    pair["disc"].clip_weights()
    params = {n: p.detach() for n, p in pair.named_parameters()}
    assert len(params) == len(jparams)
    check_step(ranks, float(loss), params, jloss, jparams)


# --------------------------------------------------------------------------- #
#  Continuous DDPM (test_parallel.py:76)                                      #
# --------------------------------------------------------------------------- #

DDPM_B, DDPM_H, DDPM_LR = 16, 8, 1e-3


@functools.lru_cache(maxsize=None)
def ddpm_case():
    """A float64 U-Net (base 8, (1, 2), 8x8, seeded weights), images in
    [-1, 1], the step key's draws, the JAX package's time embedding of each
    row's time, and the JAX package's SGD step on the mean loss."""
    key = jax.random.PRNGKey(0)
    sde = JD.ScoreMatchingSDE(jax_unet((1, 2)), input_size=(1, DDPM_H,
                                                            DDPM_H))
    x = np.asarray(jax.random.uniform(jax.random.fold_in(key, 2),
                                      (DDPM_B, 1, DDPM_H, DDPM_H),
                                      jnp.float64)) * 2 - 1
    skey = jax.random.fold_in(key, 3)
    k1, k2 = jax.random.split(skey)
    u = np.asarray(jax.random.uniform(k1, (DDPM_B, 1), jnp.float64))
    z = np.asarray(jax.random.normal(k2, x.shape, jnp.float64))
    t = (u[:, 0] * (sde.t1 - sde.t0) + sde.t0).astype(np.float32)
    emb = np.asarray(JU.sinusoidal_embedding(jnp.asarray(t), 8))

    @jax.jit
    def step(sde, x):
        loss, grads = jax.value_and_grad(
            lambda s: jnp.mean(s.loss(skey, x, partitions=1)))(sde)
        return jax.tree_util.tree_map(lambda p, g: p - DDPM_LR * g, sde,
                                      grads), loss

    sde2, loss = step(sde, jnp.asarray(x))
    return (port_score_sde(sde, torch.float64), x, u, z, emb, float(loss),
            jax_named_arrays(sde2))


def test_dp_train_step_cont_ddpm(model_ranks):
    """One SGD step of the mean score-matching loss with the images (16)
    split over 8 ranks, each rank drawing its rows of the times' uniforms
    and the normals, the U-Net on the JAX package's time embedding."""
    sde, x, u, z, emb, jloss, jparams = ddpm_case()
    ranks = model_ranks["ddpm"]
    sde = MR.unpack(MR.pack(sde))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "_uniform", lambda shape, g, dtype, device:
                   to_torch(u))
        mp.setattr(TD, "_standard_normal", lambda shape, g, dtype, device:
                   to_torch(z))
        mp.setattr(TU, "sinusoidal_embedding", lambda t, dim: to_torch(emb))
        loss = torch.mean(sde.loss(None, to_torch(x)))
        names = [n for n, _ in sde.named_parameters()]
        grads = torch.autograd.grad(loss, list(sde.parameters()))
    with torch.no_grad():
        params = {n: p - DDPM_LR * g for n, (_, p), g in zip(
            names, sde.named_parameters(), grads)}
    assert set(params) <= set(jparams)
    check_step(ranks, float(loss.detach()), params, jloss, jparams)
