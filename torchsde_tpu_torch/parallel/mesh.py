"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``torchsde_tpu/parallel/mesh.py``).

The JAX package runs one process over all devices and lets the partitioner
split the batch and insert the gradient reduction. Here the program is
SPMD with one process a device, ``torch.distributed``'s model: every rank
runs the same code on plain local tensors, and the collectives are written
out.

* A mesh is a ``DeviceMesh`` of the ranks there are (:func:`make_mesh`,
  :func:`make_mesh_2d`), in row-major rank order, so that each model group
  of a 2-D mesh is a run of adjacent ranks: within a node (NVLink) when a
  node's ranks are adjacent, with only the data axis across nodes.
* Placement (:func:`batch_sharding`, :func:`replicated`) names a
  ``Shard(axis)`` or ``Replicate()`` for each mesh axis, as
  ``torch.distributed.tensor``'s placements do. :func:`shard_batch` takes this rank's
  slice of a global tensor (of each stacked tensor of a ``Replicas``, of
  each increment of a Brownian motion) with no communication; every rank
  holds the global value, made from one seed. :func:`replicate` broadcasts
  from the mesh's first rank.
* :func:`data_parallel_train_step` runs the local loss and backward on each
  rank, averages the gradients over the ``data`` group in one flat
  all-reduce, and applies the update. The solver itself is
  communication-free, so each rank runs the fused kernels on its shard.
* Megatron-style tensor parallelism (:func:`shard_mlp_tp`,
  :func:`shard_latent_sde_tp`) splits an MLP's layers alternately by
  output (column-parallel) and input features (row-parallel), with the two
  operators of Megatron written as autograd functions over
  ``torch.distributed.all_reduce``.

Noise is shard-local by default: :func:`shard_generator` seeds each rank's
generator from ``(seed, rank on the data axis)``, the counterpart of
``fold_in(key, axis_index)``. A run that must equal a single-process run
draws the global noise and gives each rank its slice.

:func:`run_ranks` starts ranks as spawned processes that meet through a
``FileStore`` in a temporary directory (no fixed port), each group with a
timeout, and returns each rank's result.
"""

import copy
import datetime
import os
import shutil
import tempfile
import time
import warnings
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..brownian import threefry
from ..brownian.base import BaseBrownian
from ..models.layers import _ACTIVATIONS
from ..utils.misc import resolve_device
from .replicas import Replicas

# Every process group's timeout: a rank that dies fails the others' next
# collective after this long instead of hanging them.
TIMEOUT = datetime.timedelta(seconds=60)


def init_process_group(rank, world, init_method, device=None, backend=None,
                       timeout=TIMEOUT):
    """Join rank ``rank`` of ``world`` to the default process group at
    ``init_method`` (such as ``file:///tmp/dir/store``) and return its
    device: ``device`` when given (``"cuda"`` without an index is card
    ``rank % device_count``), else the card, through ``resolve_device``.
    The backend is NCCL on a card and gloo on the CPU unless ``backend``
    names one."""
    device = _rank_device(resolve_device(device), rank)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    return device


def _rank_device(device, rank):
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _ensure_group(device):
    """The default process group: the caller's, else one of torchrun's
    environment (``RANK`` set), else one of this process alone."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ:
        rank = int(os.environ["RANK"])
        device = _rank_device(device, int(os.environ.get("LOCAL_RANK",
                                                         rank)))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, timeout=TIMEOUT)
        return
    if device.type == "cuda":
        torch.cuda.set_device(_rank_device(device, 0))
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=TIMEOUT)


def make_mesh(world=None, axis_name="data", device=None):
    """A 1-D mesh over the ranks of the default process group (which
    ``world``, when given, must count), on ``device``'s type: the card
    unless ``device`` says otherwise. Without a process group it starts
    one: torchrun's where its environment is set, else one of this process
    alone (NCCL on a card, gloo on the CPU)."""
    device = resolve_device(device)
    _ensure_group(device)
    n = dist.get_world_size()
    if world is not None and world != n:
        raise ValueError(f"a mesh of {world} ranks in a process group of "
                         f"{n}")
    return init_device_mesh(device.type, (n,), mesh_dim_names=(axis_name,))


def make_mesh_2d(n_model=1, axis_names=("data", "model"), device=None):
    """A 2-D ``(data, model)`` mesh: batch data parallelism on the first
    axis, tensor parallelism on the second. Ranks are laid out row-major,
    so a model group is ``n_model`` adjacent ranks: start the ranks of a
    node together, and the model axis (a collective every layer) stays
    within the node while only the data axis (a gradient all-reduce a
    step) crosses nodes."""
    device = resolve_device(device)
    _ensure_group(device)
    n = dist.get_world_size()
    if n % n_model != 0:
        raise ValueError(f"{n} ranks not divisible by n_model={n_model}")
    return init_device_mesh(device.type, (n // n_model, n_model),
                            mesh_dim_names=tuple(axis_names))


@dataclass(frozen=True)
class Shard:
    """Tensor dimension ``dim`` split over a mesh axis, as
    ``torch.distributed.tensor.Shard`` (whose package takes 1.5 s to import
    in every rank)."""
    dim: int


@dataclass(frozen=True)
class Replicate:
    """The whole tensor on every rank of a mesh axis, as
    ``torch.distributed.tensor.Replicate``."""


class Placement(NamedTuple):
    """Where a value lives on ``mesh``: one ``Shard(dim)`` or
    ``Replicate()`` for each mesh axis, as a DTensor's placements."""
    mesh: DeviceMesh
    placements: tuple


def _axis(mesh, axis_name):
    names = mesh.mesh_dim_names
    if axis_name not in names:
        raise ValueError(f"mesh axes {names} have no axis '{axis_name}'")
    return names.index(axis_name)


def batch_sharding(mesh, batch_axis=0, axis_name="data"):
    """Tensor dimension ``batch_axis`` split over the mesh axis
    ``axis_name``, replicated over the others."""
    i = _axis(mesh, axis_name)
    return Placement(mesh, tuple(Shard(batch_axis) if k == i else Replicate()
                                 for k in range(mesh.ndim)))


def replicated(mesh):
    return Placement(mesh, (Replicate(),) * mesh.ndim)


def _bounds(n, placement, dim):
    """This rank's ``[lo, hi)`` of a dimension of ``n`` entries that
    ``placement`` shards (the whole of it if none does)."""
    lo, hi = 0, n
    for axis, p in enumerate(placement.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size = placement.mesh.size(axis)
            width = hi - lo
            if width % size != 0:
                name = placement.mesh.mesh_dim_names[axis]
                raise ValueError(f"dimension {dim} of {width} entries not "
                                 f"divisible by mesh axis '{name}' (size "
                                 f"{size})")
            width //= size
            lo += placement.mesh.get_local_rank(axis) * width
            hi = lo + width
    return lo, hi


def _local_slice(x, placement):
    """This rank's part of the global tensor ``x`` under ``placement``, a
    contiguous tensor; no communication."""
    for p in placement.placements:
        if isinstance(p, Shard):
            lo, hi = _bounds(x.shape[p.dim], placement, p.dim)
            x = x.narrow(p.dim, lo, hi - lo)
    return x.contiguous()


def shard_batch(x, mesh, batch_axis=0, axis_name="data"):
    """This rank's slice, along ``batch_axis`` over the mesh axis
    ``axis_name``, of a global tensor, of each stacked tensor of a
    :class:`Replicas` (its replica axis, ``batch_axis`` 0: each rank holds
    K / size replicas as a ``Replicas`` of leaf tensors of its own), or of
    each increment of a Brownian motion whose shape is ``(batch,
    channels)`` (batch_axis 0). The batch must divide by the axis size, or
    it raises."""
    placement = batch_sharding(mesh, batch_axis, axis_name)
    if torch.is_tensor(x):
        return _local_slice(x, placement)
    if isinstance(x, Replicas):
        if batch_axis != 0:
            raise ValueError("a Replicas shards over its replica axis, 0")

        def part(stack):
            return {n: _local_slice(t.detach(), placement).requires_grad_(
                t.requires_grad) for n, t in stack.items()}

        return Replicas(x.module, part(x.params), part(x.buffers))
    if isinstance(x, BaseBrownian):
        if batch_axis != 0:
            raise ValueError("a Brownian motion shards over its batch axis, "
                             "0")
        return _RowShard(x, *_bounds(x.shape[0], placement, 0))
    raise TypeError(f"shard_batch takes tensors, Replicas and Brownian "
                    f"motions, not {type(x).__name__}")


class _RowShard(BaseBrownian):
    """Rows ``[lo, hi)`` of every increment (and Levy area) of a Brownian
    motion of shape ``(batch, channels)``: a rank's part of a global path,
    each row the global path's own."""

    def __init__(self, bm, lo, hi):
        self.bm, self.lo, self.hi = bm, lo, hi

    def _rows(self, out, axis):
        if isinstance(out, (tuple, list)):
            return type(out)(self._rows(o, axis) for o in out)
        if out is None:
            return None
        return out.narrow(axis, self.lo, self.hi - self.lo)

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        return self._rows(self.bm(ta, tb, return_U=return_U,
                                  return_A=return_A), 0)

    def query_grid(self, grid, return_U=False, return_A=False):
        return self._rows(self.bm.query_grid(grid, return_U=return_U,
                                             return_A=return_A), 1)

    def query_pairs(self, points, pairs, return_U=False, return_A=False):
        if not hasattr(self.bm, "query_pairs"):
            return [self(points[ia], points[ib], return_U=return_U,
                         return_A=return_A) for ia, ib in pairs]
        return [self._rows(o, 0) for o in self.bm.query_pairs(
            points, pairs, return_U=return_U, return_A=return_A)]

    def __repr__(self):
        return (f"{self.__class__.__name__}(bm={self.bm}, rows=[{self.lo}, "
                f"{self.hi}))")

    t0 = property(lambda self: self.bm.t0)
    t1 = property(lambda self: self.bm.t1)
    dtype = property(lambda self: self.bm.dtype)
    device = property(lambda self: self.bm.device)
    levy_area_approximation = property(
        lambda self: self.bm.levy_area_approximation)

    @property
    def shape(self):
        return (self.hi - self.lo, *self.bm.shape[1:])


def _first_rank(mesh):
    return int(mesh.mesh.flatten()[0])


def replicate(obj, mesh):
    """Rank 0 of ``mesh``'s value on every rank: a module's (or a
    ``Replicas``') parameters and buffers broadcast in place, the module
    returned; a tensor's broadcast into a copy, which is returned."""
    src = _first_rank(mesh)
    if torch.is_tensor(obj):
        out = obj.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src=src)
        return out
    if isinstance(obj, Replicas):
        tensors = [*obj.params.values(), *obj.buffers.values()]
    elif isinstance(obj, nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
    else:
        raise TypeError(f"replicate takes tensors, modules and Replicas, not "
                        f"{type(obj).__name__}")
    with torch.no_grad():
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("replicate broadcasts contiguous tensors "
                                 "in place")
            dist.broadcast(t, src=src)
    return obj


def shard_generator(seed, mesh, axis_name="data", device=None):
    """A ``torch.Generator`` on ``device`` (the card unless given) seeded
    from the Threefry key ``fold_in(PRNGKey(seed), rank on axis_name)``:
    shard-local noise, different on each rank of the axis, the same on
    ranks that differ only on other axes."""
    coord = mesh.get_local_rank(_axis(mesh, axis_name))
    hi, lo = threefry.fold_in_words((0, seed), coord)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed((hi << 32) | lo)
    return gen


# --------------------------------------------------------------------------- #
#  Data-parallel training                                                     #
# --------------------------------------------------------------------------- #

def _named_parameters(model):
    if isinstance(model, Replicas):
        return model.named_parameters()
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def _all_reduce_mean(tensors, group, n):
    """The mean over ``group`` (of ``n`` ranks) of each tensor, by one
    all-reduce of a flat buffer a dtype."""
    out = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= n
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def data_parallel_train_step(loss_fn, mesh, lr=None, optimizer_update=None,
                             axis_name="data"):
    """Build a data-parallel training step.

    ``loss_fn(model, batch, generator) -> loss`` is the loss of this rank's
    shard of the batch: a scalar, or one a replica for a ``Replicas``
    (whose sum is differentiated). The returned ``step(model, batch,
    generator) -> (model, loss)`` differentiates it, averages the gradients
    over the ``axis_name`` group of ``mesh`` (one flat all-reduce, the loss
    in the same buffer), updates ``model``'s parameters in place and
    returns the model and the mean of the loss over the group: for a loss
    that is a batch mean over equal shards, the full batch's loss, as every
    rank's gradients are the full batch's.

    ``model`` is a module or a :class:`Replicas`, replicated over the
    group (or tensor-parallel over another axis: its shards' gradients are
    averaged with the shards of the same place). Exactly one of ``lr``
    (plain SGD) or ``optimizer_update(grads, params) -> updates`` (dicts by
    parameter name) must be given, as for ``replica_train_step``."""
    if (lr is None) == (optimizer_update is None):
        raise ValueError("pass exactly one of lr= or optimizer_update=")
    group = mesh.get_group(axis_name)
    n = mesh.size(_axis(mesh, axis_name))

    def step(model, batch, generator):
        loss = loss_fn(model, batch, generator)
        named = _named_parameters(model)
        names = [name for name, _ in named]
        params = [p for _, p in named]
        grads = torch.autograd.grad(loss.sum(), params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        *grads, loss = _all_reduce_mean([*grads, loss.detach()], group, n)
        grads = dict(zip(names, grads))
        with torch.no_grad():
            if optimizer_update is not None:
                updates = optimizer_update(grads, dict(named))
            else:
                updates = {name: -lr * g for name, g in grads.items()}
            for name, p in named:
                p += updates[name]
        return model, loss

    return step


# --------------------------------------------------------------------------- #
#  Tensor parallelism                                                         #
# --------------------------------------------------------------------------- #

class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity going forward, the all-reduce of the
    input's gradient over the model group going back (each rank holds the
    part of it that its shard of the next layer gives)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the all-reduce of the partial sums going forward, the
    identity going back (the cotangent is already every rank's)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The last dimension's shards put together: each rank writes its shard
    into a zero-filled full-width buffer and the buffers are all-reduced
    (exact: every other entry is a zero), a collective that every backend
    has for CUDA tensors; going back, this rank's slice of the
    cotangent."""

    @staticmethod
    def forward(ctx, x, group, coord, size):
        w = x.shape[-1]
        full = x.new_zeros((*x.shape[:-1], w * size))
        full[..., coord * w:(coord + 1) * w] = x
        dist.all_reduce(full, group=group)
        ctx.bounds = (coord * w, (coord + 1) * w)
        return full

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.bounds
        return grad[..., lo:hi].contiguous(), None, None, None


class _ModelAxis:
    """A rank's place on the model axis: the group, the rank's coordinate,
    the axis size."""

    def __init__(self, mesh, axis_name):
        self.name = axis_name
        self.group = mesh.get_group(axis_name)
        self.coord = mesh.get_local_rank(_axis(mesh, axis_name))
        self.size = mesh.size(_axis(mesh, axis_name))


class ColumnParallelLinear(nn.Module):
    """A ``Linear`` whose output features are split over the model axis:
    ``w`` (in, out / size) and ``b`` (out / size,) are this rank's columns.
    Takes the whole input, gives this rank's part of the output."""

    def __init__(self, w, b, axis):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)
        self.axis = axis

    def forward(self, x):
        return _CopyToModel.apply(x, self.axis.group) @ self.w + self.b


class RowParallelLinear(nn.Module):
    """A ``Linear`` whose input features are split over the model axis:
    ``w`` (in / size, out) is this rank's rows, ``b`` (out,) whole. Takes
    this rank's part of the input, gives the whole output."""

    def __init__(self, w, b, axis):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)
        self.axis = axis

    def forward(self, x):
        return _ReduceFromModel.apply(x @ self.w, self.axis.group) + self.b


class TensorParallelMLP(nn.Module):
    """An ``MLP`` whose layers are column-parallel, row-parallel or (where
    a width does not divide) whole ``Linear``s. A row-parallel layer takes
    the split output of the column-parallel layer before it (the two split
    one width, so both are split or both whole); the last layer's output,
    split when it is column-parallel, is put together, so the output is
    whole on every rank."""

    def __init__(self, layers, activation, final_activation, axis):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.activation = activation
        self.final_activation = final_activation
        self.axis = axis

    def forward(self, x):
        act = _ACTIVATIONS[self.activation]
        for layer in self.layers[:-1]:
            x = act(layer(x))
        x = self.layers[-1](x)
        if isinstance(self.layers[-1], ColumnParallelLinear):
            ax = self.axis
            x = _GatherFromModel.apply(x, ax.group, ax.coord, ax.size)
        if self.final_activation is not None:
            x = _ACTIVATIONS[self.final_activation](x)
        return x


def _divides(shape, dim, axis, context):
    """Whether dimension ``dim`` of an array of ``shape`` divides by the
    model axis; warns (the JAX package's words) when it does not."""
    if len(shape) > dim and shape[dim] % axis.size == 0:
        return True
    warnings.warn(
        f"Tensor-parallel sharding fallback{context}: array of shape "
        f"{tuple(shape)} has dim {dim} not divisible by mesh axis "
        f"'{axis.name}' (size {axis.size}); replicating instead. "
        f"Pad the layer width to a multiple of the mesh axis for "
        f"true tensor parallelism.")
    return False


def shard_mlp_tp(mlp, mesh, axis_name="model"):
    """Megatron-style tensor parallelism of a ``models.layers.MLP``:
    alternately column-parallel (its output features split) and
    row-parallel (its input features split) layers, so that a pair of
    layers needs one all-reduce. Biases follow their layer's output: split
    with a column-parallel layer, whole with a row-parallel one. A layer
    whose split width does not divide by the axis stays a whole
    ``Linear`` (with the JAX package's warning); a column-parallel layer
    and the row-parallel layer after it split the same width, so both
    split or both stay whole. Returns a :class:`TensorParallelMLP` holding
    this rank's shards of rank 0's weights."""
    axis = _ModelAxis(mesh, axis_name)
    layers = []
    for i, layer in enumerate(mlp.layers):
        ctx = f" (MLP layer {i})"
        w = replicate(layer.w, mesh)
        b = replicate(layer.b, mesh)
        if i % 2 == 0:
            fits = _divides(w.shape, 1, axis, ctx)
            fits = _divides(b.shape, 0, axis, ctx) and fits
            if fits:
                k = w.shape[1] // axis.size
                cols = slice(axis.coord * k, (axis.coord + 1) * k)
                layers.append(ColumnParallelLinear(
                    w[:, cols].contiguous(), b[cols].contiguous(), axis))
                continue
        elif _divides(w.shape, 0, axis, ctx):
            k = w.shape[0] // axis.size
            rows = slice(axis.coord * k, (axis.coord + 1) * k)
            layers.append(RowParallelLinear(w[rows].contiguous(), b, axis))
            continue
        whole = copy.deepcopy(layer)
        with torch.no_grad():
            whole.w.copy_(w)
            whole.b.copy_(b)
        layers.append(whole)
    return TensorParallelMLP(layers, mlp.activation, mlp.final_activation,
                             axis)


def shard_latent_sde_tp(model, mesh, axis_name="model"):
    """Tensor-parallel placement of a ``models.latent_sde.LatentSDE``: a
    copy of ``model`` holding rank 0's weights, its two hidden-size MLPs
    (the posterior drift ``f_net`` and the prior drift ``h_net``)
    Megatron-split over ``axis_name`` and everything else (the encoder,
    the heads, the per-dimension diffusion nets) whole on every rank.
    Compose with ``shard_batch`` on the data for 2-D (data x model)
    training. It runs the ``sdeint`` route: the fused kernels take whole
    weights, so ``fused=True`` raises."""
    model = replicate(copy.deepcopy(model), mesh)
    model.f_net = shard_mlp_tp(model.f_net, mesh, axis_name)
    model.h_net = shard_mlp_tp(model.h_net, mesh, axis_name)
    return model


def tp_part(name, whole, mesh, axis_name="model"):
    """This rank's part of the whole parameter ``name`` (a dotted name of
    the unsplit model) of a model that :func:`shard_latent_sde_tp` splits:
    the columns of a column-parallel layer (an even layer of ``f_net`` or
    ``h_net``: ``w`` and ``b``), the rows of a row-parallel layer's ``w``;
    anything else whole. Where a width does not divide, the layers stay
    whole, and so does the part."""
    parts = name.split(".")
    axis = _ModelAxis(mesh, axis_name)
    if parts[0] not in ("f_net", "h_net") or len(parts) != 4:
        return whole
    column = int(parts[2]) % 2 == 0
    dim = whole.ndim - 1 if column else 0
    if (not column and parts[3] == "b") or whole.shape[dim] % axis.size:
        return whole
    k = whole.shape[dim] // axis.size
    return whole.narrow(dim, axis.coord * k, k)


# --------------------------------------------------------------------------- #
#  Starting ranks                                                             #
# --------------------------------------------------------------------------- #

def _rank_main(rank, fn, world, tmp, device, backend):
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    init_process_group(rank, world, f"file://{tmp}/store", device, backend)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, args=(), device=None, backend=None, timeout=600.0):
    """``[fn(rank, world, *args) for each rank]``, each call in a process
    of its own started by ``spawn``, the ranks joined in a default process
    group (``init_process_group``: NCCL on a card, gloo on the CPU, unless
    ``backend`` names one) that meets through a ``FileStore`` in a fresh
    temporary directory, on ``device`` (the card unless given; ``"cuda"``
    spreads the ranks over the cards). ``fn`` must be importable by name
    and its results picklable by ``torch.save``. A rank that raises fails
    the call (``torch.multiprocessing.ProcessRaisedException``); ranks
    still running after ``timeout`` seconds are killed and it raises
    TimeoutError. The ranks talk over the loopback interface: one host."""
    device = str(resolve_device(device))
    tmp = tempfile.mkdtemp(prefix="tsde_ranks_")
    try:
        # The arguments go through a file: the pipe to a spawned process
        # holds 64 kB, and past that each start waits until its process
        # has imported torch and read them, so the ranks would start one
        # after another.
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        procs = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, tmp, device, backend),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not procs.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in procs.processes:
                    p.kill()
                for p in procs.processes:
                    p.join()
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
