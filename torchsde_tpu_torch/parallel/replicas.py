"""Stacked independent replicas (counterpart of
``torchsde_tpu/parallel/replicas.py``).

K independent models of one architecture (an ensemble, a seed sweep, a
hyperparameter sweep) train side by side: their parameters are stacked on
a leading replica axis (``torch.func.stack_module_state``) and each
replica runs the one model's code on its slice of the stack
(``torch.func.functional_call``), or all of them at once under
``torch.func.vmap`` where the code allows it. The JAX package vmaps the
whole train step; here the parts that draw from a ``torch.Generator``
(which ``vmap`` cannot map) loop over the replicas, and the K-replica
latent solve is one launch of a kernel that puts the replica on its grid
(``ops/latent_fused.py:FusedLatentSolveMulti``).
"""

import copy

import torch
from torch import nn
from torch.func import functional_call, stack_module_state


class _Call(nn.Module):
    """Runs ``fn(module, *args)`` as a forward, so that ``functional_call``
    can swap the module's parameters and buffers around any function of
    it, not only its ``forward``."""

    def __init__(self, module):
        super().__init__()
        self.m = module

    def forward(self, fn, *args):
        return fn(self.m, *args)


class Replicas:
    """K models of one architecture with stacked state.

    ``module`` is the architecture (on the ``meta`` device: its own tensors
    are never used); ``params`` and ``buffers`` map each dotted name to a
    tensor with a leading replica axis K. The stacked parameters are leaf
    tensors, so gradients of a sum of the replicas' losses land on them
    replica by replica, and one ``torch.optim.Adam`` over
    :meth:`parameters` is K independent Adams: its update is elementwise
    (moments, bias correction and step are per element, the step count
    shared by replicas that step together), so each replica's slice moves
    exactly as it would under an optimizer of its own."""

    def __init__(self, module, params, buffers):
        self.module = module
        self.params = dict(params)
        self.buffers = dict(buffers)
        self._call = _Call(module)

    def __len__(self):
        return next(iter(self.params.values())).shape[0]

    def parameters(self):
        return list(self.params.values())

    def named_parameters(self):
        return list(self.params.items())

    def with_buffers(self, **stacked):
        """A view sharing the parameters with some buffers replaced by
        stacked ones (K, ...), such as a per-replica context."""
        return Replicas(self.module, self.params,
                        {**self.buffers, **stacked})

    def _state(self, params, buffers):
        return {**{f"m.{k}": v for k, v in params.items()},
                **{f"m.{k}": v for k, v in buffers.items()}}

    def call(self, k, fn, *args):
        """``fn(model_k, *args)`` with model_k replica k: the architecture
        holding slice k of every stacked tensor."""
        state = self._state({n: p[k] for n, p in self.params.items()},
                            {n: b[k] for n, b in self.buffers.items()})
        return functional_call(self._call, state, (fn, *args))

    def vmap(self, fn, *args, in_dims=None):
        """``fn(model_k, *args_k)`` for every replica at once under
        ``torch.func.vmap``, stacked on a leading K axis. ``in_dims`` gives
        each argument's replica axis (None: shared), all shared by
        default."""
        in_dims = (None,) * len(args) if in_dims is None else tuple(in_dims)

        def one(params, buffers, *a):
            return functional_call(self._call, self._state(params, buffers),
                                   (fn, *a))

        return torch.func.vmap(one, in_dims=(0, 0, *in_dims))(
            self.params, self.buffers, *args)


def stack_replicas(make_fn, generators):
    """Construct K independent models with stacked state.

    ``make_fn(generator) -> module`` is the single-model constructor;
    ``generators`` holds K ``torch.Generator``s, the counterpart of the JAX
    package's (K, ...) key array. Returns a :class:`Replicas`."""
    models = [make_fn(g) for g in generators]
    if not models:
        raise ValueError("stack_replicas needs at least one generator")
    params, buffers = stack_module_state(models)
    return Replicas(copy.deepcopy(models[0]).to("meta"), params, buffers)


def unstack_replica(models, i):
    """Replica ``i`` of a :class:`Replicas` as a module of its own, holding
    copies of its slices."""
    any_tensor = next(iter(models.params.values()))
    module = copy.deepcopy(models.module).to_empty(device=any_tensor.device)
    with torch.no_grad():
        for name, t in module.named_parameters():
            t.copy_(models.params[name][i])
        for name, t in module.named_buffers():
            t.copy_(models.buffers[name][i])
    return module


def replica_train_step(loss_fn, lr=None, optimizer_update=None):
    """Build a K-replica training step.

    ``loss_fn(model, batch, generator) -> loss`` is the SINGLE-replica loss;
    the returned ``step(models, batches, generators) -> (models, losses)``
    runs it on each replica of a :class:`Replicas` with ``batches[k]`` and
    ``generators[k]`` (a loop through ``functional_call``: the loss draws
    from its generator, which ``vmap`` cannot map), takes every replica's
    gradients in one backward pass of the summed losses, and updates the
    stacked parameters in place; it returns the same ``models`` and the
    losses (K,).

    Exactly one of ``lr`` (plain SGD) or ``optimizer_update(grads, params)
    -> updates`` must be given; both apply per replica: ``optimizer_update``
    is called once a replica with dicts of that replica's gradients and
    parameters by name."""
    if (lr is None) == (optimizer_update is None):
        raise ValueError("pass exactly one of lr= or optimizer_update=")

    def step(models, batches, generators):
        K = len(models)
        losses = torch.stack([models.call(k, loss_fn, batches[k],
                                          generators[k]) for k in range(K)])
        names = list(models.params)
        grads = torch.autograd.grad(
            losses.sum(), [models.params[n] for n in names],
            allow_unused=True)
        grads = {n: torch.zeros_like(models.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        with torch.no_grad():
            for k in range(K):
                if optimizer_update is not None:
                    updates = optimizer_update(
                        {n: g[k] for n, g in grads.items()},
                        {n: models.params[n][k] for n in names})
                else:
                    updates = {n: -lr * g[k] for n, g in grads.items()}
                for n in names:
                    models.params[n][k] += updates[n]
        return models, losses.detach()

    return step
