"""Helpers shared by the tests that hold torchsde_tpu_torch against
torchsde_tpu: export a JAX module's leaves by dotted name, build the same
model in both packages, and make and compare MLP towers."""

import jax
import numpy as np
import torch

from torchsde_tpu.utils.module import Module, _flatten_module
from torchsde_tpu_torch.utils.convert import load_jax_params


def jax_named_arrays(tree):
    """``{dotted pytree path: numpy array}`` for every leaf of a JAX
    ``Module`` tree, from ``jax.tree_util.tree_flatten_with_path``. A module
    flattens to an index into its dynamic attribute names, which this maps
    back to the name."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node, names = tree, []
        for entry in path:
            if isinstance(node, Module):
                dyn_names = _flatten_module(node)[1][0]
                name = dyn_names[entry.key]
                node = getattr(node, name)
            else:
                name = str(entry.idx)
                node = node[entry.idx]
            names.append(name)
        out[".".join(names)] = np.asarray(leaf)
    return out


def perturbed(tree, seed, scale=0.1):
    """``tree`` with every leaf moved by ``scale`` times a standard normal,
    so that no weight the tests compare keeps its zero initialisation."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        leaf + scale * rng.standard_normal(leaf.shape).astype(leaf.dtype)
        for leaf in leaves])


def to_torch(a):
    return torch.as_tensor(np.array(a))


def port_latent_sde(jax_model, dtype):
    """A torchsde_tpu_torch LatentSDE holding ``jax_model``'s weights."""
    from torchsde_tpu_torch.models.latent_sde import LatentSDE
    enc = jax_model.encoder.cell
    m = LatentSDE(enc.w_ih.shape[0], jax_model.latent_size,
                  jax_model.context_size, enc.hidden_size, dtype=dtype,
                  device="cpu")
    return load_jax_params(m, jax_named_arrays(jax_model))


def port_generator(jax_gen, dtype):
    """A torchsde_tpu_torch SDE-GAN Generator holding ``jax_gen``'s
    weights."""
    from torchsde_tpu_torch.models.sde_gan import Generator
    func = jax_gen.func
    drift = func.drift.layers
    m = Generator(jax_gen.readout.w.shape[1], jax_gen.initial_noise_size,
                  func.noise_size, func.hidden_size, drift[0].w.shape[1],
                  len(drift) - 1, dtype=dtype, device="cpu")
    return load_jax_params(m, jax_named_arrays(jax_gen))


# The critic CDE's control path: per-batch data that the JAX module carries
# as leaves and the port keeps outside the module's state.
CDE_PATH_KEYS = ("func._path_ts", "func._path_ys")


def port_discriminator(jax_disc, dtype):
    """A torchsde_tpu_torch SDE-GAN Discriminator holding ``jax_disc``'s
    weights (its control-path leaves are dropped)."""
    from torchsde_tpu_torch.models.sde_gan import Discriminator
    layers = jax_disc.func.func.layers
    m = Discriminator(jax_disc.func.data_size, jax_disc.func.hidden_size,
                      layers[0].w.shape[1], len(layers) - 1, dtype=dtype,
                      device="cpu")
    arrays = jax_named_arrays(jax_disc)
    for key in CDE_PATH_KEYS:
        del arrays[key]
    return load_jax_params(m, arrays)


def tower_triples(rng, sizes, acts, scale=0.3, dtype=np.float32):
    """A tower's ``(W, b, act)`` of numpy arrays: normal weights times
    scale/sqrt(fan_in), small normal biases."""
    return [((rng.standard_normal((a, b)) * (scale / np.sqrt(a))
              ).astype(dtype),
             (0.05 * rng.standard_normal(b)).astype(dtype), act)
            for (a, b), act in zip(zip(sizes[:-1], sizes[1:]), acts)]


def unpad_tower_grads(padded, triples):
    """The Pallas kernels' padded weight gradients, cut to the towers'
    shapes: (128,128) -> (in, out), (1,128) -> (out,)."""
    out = []
    for (w, _, _), dw, db in zip(triples, padded[::2], padded[1::2]):
        out += [np.asarray(dw)[:w.shape[0], :w.shape[1]],
                np.asarray(db)[0, :w.shape[1]]]
    return out


def port_tower_grads(flat, triples):
    """The port's flat pack gradient as ``[dW0, db0, dW1, ...]``."""
    from torchsde_tpu_torch.ops.fused_solve import unpack
    shapes = tuple((w.shape[0], w.shape[1], a) for w, _, a in triples)
    return [t for wb in unpack(flat, shapes) for t in wb]
