"""Load parameters exported from the JAX package into the port's modules."""

import numpy as np
import torch

from .misc import resolve_device


def load_jax_params(module, arrays):
    """Copy ``arrays`` into ``module``'s parameters and buffers, in place.

    ``arrays`` maps each JAX leaf's pytree path, dotted (``f_net.layers.0.w``,
    ``g_nets.2``, ``encoder.cell.w_hh``, ``denoiser.downs.0.conv.w``), to a
    numpy array. The port keeps the JAX layouts (a U-Net convolution's ``w``
    too: ``(kh, kw, in, out)``, permuted in its ``forward``), so names and
    shapes correspond one to one; a JAX list's None entry (the U-Net's last
    ``downs``) has no leaf, as the port's ``nn.ModuleList`` slot holding None
    has no tensor. Raises
    ``KeyError`` when a tensor of the module has no array or an array has no
    tensor, and ``ValueError`` on a shape mismatch; nothing is copied then.
    Values are cast to each tensor's dtype (bf16 arrays are read bit for
    bit, :func:`as_tensor`). Returns ``module``."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    missing = sorted(set(targets) - set(arrays))
    unused = sorted(set(arrays) - set(targets))
    if missing or unused:
        raise KeyError(f"load_jax_params: missing {missing}, unused {unused}")
    for name, t in targets.items():
        shape = np.shape(arrays[name])
        if shape != tuple(t.shape):
            raise ValueError(f"load_jax_params: {name} has shape {shape}, "
                             f"the module's is {tuple(t.shape)}")
    with torch.no_grad():
        for name, t in targets.items():
            t.copy_(as_tensor(arrays[name]))
    return module


def as_tensor(a):
    """A CPU tensor of the array ``a``, bit for bit: a bf16 array (JAX's
    ``ml_dtypes.bfloat16``, which torch cannot read) through its 16-bit
    view."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def load_jax_tower(layers, device=None, dtype=torch.float32):
    """A port :class:`~torchsde_tpu_torch.ops.fused_solve.TowerSpec` from the
    JAX package's tower layers, given as ``(W, b, act)`` triples of numpy
    arrays and activation names (``W`` (in, out), ``b`` (out,)), on
    ``device`` (the card unless given) in ``dtype``. The tensors are new
    leaves; set ``requires_grad`` on them to differentiate a solve."""
    from ..ops.fused_solve import TowerSpec
    device = resolve_device(device)
    return TowerSpec([
        (torch.as_tensor(np.array(w), dtype=dtype, device=device),
         torch.as_tensor(np.array(b), dtype=dtype, device=device), act)
        for w, b, act in layers])


def load_jax_key(key, device=None):
    """The port's Threefry key for a JAX ``PRNGKey``, given as a numpy
    uint32 array of shape (2,) (``np.asarray(jax.random.PRNGKey(s))``, or
    ``jax.random.key_data`` of a typed key), on ``device`` (the card unless
    given). ``BrownianInterval(key=...)`` of either package then draws the
    same path; ``entropy=s`` gives the key of ``PRNGKey(s)`` directly."""
    from ..brownian.interval import as_key
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError(f"a JAX PRNGKey is a uint32 array of shape (2,), "
                         f"got {key.dtype} {key.shape}")
    return as_key(key, resolve_device(device))
