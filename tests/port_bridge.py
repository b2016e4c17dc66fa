"""Helpers shared by the tests that hold torchsde_tpu_torch against
torchsde_tpu: export a JAX module's leaves by dotted name, and build the same
model in both packages."""

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
