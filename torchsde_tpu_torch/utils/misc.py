"""Small tensor utilities (counterpart of ``torchsde_tpu/utils/misc.py``)."""

import functools
import warnings

import numpy as np
import torch


def resolve_device(device=None):
    """The device an entry point builds on: ``device`` when given, else the
    CUDA card. There is no fallback: without a card it raises, and the CPU
    is used only when asked for by ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torchsde_tpu_torch runs on the CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def same_device(a, b):
    """Do devices ``a`` and ``b`` (``torch.device`` or their names) name the
    same device? A device without an index names the current one of its
    type: ``"cuda"`` is ``"cuda:0"`` while card 0 is current, ``"cpu"`` is
    ``"cpu:0"``."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False

    def index(d):
        if d.index is not None:
            return d.index
        return torch.cuda.current_device() if d.type == "cuda" else 0

    return index(a) == index(b)


def handle_unused_kwargs(unused_kwargs, msg=None):
    if len(unused_kwargs) > 0:
        if msg is not None:
            warnings.warn(f"{msg}: Unexpected arguments {unused_kwargs}")
        else:
            warnings.warn(f"Unexpected arguments {unused_kwargs}")


def tree_lc(*pairs):
    """Linear combination ``c1 * x1 + c2 * x2 + ...`` of tensors, or of
    (nested) tuples of tensors of one structure, taken leaf by leaf: the
    counterpart of the JAX package's ``tree_lc``. A coefficient is a number
    or a tensor; a term may be the number ``0.0`` (an exact zero, as
    ``ForwardSDE.g_prod_and_gdg_prod`` returns for additive noise), which
    broadcasts over any structure, and a leaf may be None, an exact zero
    that is skipped (the adjoint's parameter slots that no gradient has
    reached; all None gives None). A term of coefficient ``1.0`` enters
    unscaled, so a sum over tensors is bitwise ``x1 + c2 * x2 + ...`` in
    this order, and a later term of coefficient ``-1.0`` is subtracted, so
    ``x1 - x2`` is bitwise and one operation. The result keeps the first
    term's dtype."""
    first = pairs[0][1]
    if isinstance(first, tuple):
        return tuple(
            tree_lc(*((c, x if _is_number(x) else x[i]) for c, x in pairs))
            for i in range(len(first)))
    out = None
    for c, x in pairs:
        if x is None:
            continue
        if out is not None and _is_number(c) and c == -1.0:
            out = out - x
            continue
        term = x if _is_number(c) and c == 1.0 else c * x
        out = term if out is None else out + term
    dtype = getattr(first, "dtype", None)
    if dtype is not None and torch.is_tensor(out) and out.dtype != dtype:
        out = out.to(dtype)
    return out


def _is_number(x):
    return isinstance(x, (int, float))


def weak_scalar(x, dtype):
    """The Python number ``x`` as JAX rounds it where it meets an array of
    ``dtype``: a Python scalar is weakly typed there, so it takes the
    array's dtype before the operation. PyTorch keeps a scalar at float32
    in a bfloat16 or float16 operation; for those dtypes this returns the
    Python float that the dtype rounds ``x`` to (bfloat16 through float32,
    as ml_dtypes converts; float16 directly, as numpy does). For every
    other dtype PyTorch already rounds the scalar so, and ``x`` is returned
    as it is. Compute a scalar expression in double first, then round it
    once, as Python does before JAX sees it."""
    if dtype in (torch.bfloat16, torch.float16):
        return _half_rounded(float(x), dtype)
    return x


@functools.lru_cache(maxsize=None)
def _half_rounded(x, dtype):
    if dtype == torch.float16:
        return float(np.float16(x))
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def is_strictly_increasing(ts):
    ts = np.asarray(ts)
    return bool(np.all(ts[:-1] < ts[1:]))


def batch_mvp(m, v):
    """Batched matrix-vector product: (..., d, m) x (..., m) -> (..., d)."""
    return torch.einsum("...dm,...m->...d", m, v)


def stable_division(a, b, epsilon=1e-7):
    """a / b with |b| clamped away from zero, keeping the sign of b.

    The magnitude test is taken on ``b.abs().detach()``, so no gradient flows
    through the comparison."""
    big = b.abs().detach() > epsilon
    sign = torch.where(b >= 0, 1.0, -1.0).to(b.dtype)
    b_safe = torch.where(big, b, epsilon * sign)
    return a / b_safe


def check_kernel_tensor(name, t, shape, dtype, device):
    """What a CUDA kernel's wrapper takes: ``t`` of exactly this shape,
    dtype and device, contiguous. Raises ValueError on anything else."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}; the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the solve on {device}")


class LinearScheduler:
    """Linear 0->1 ramp over ``iters`` steps (the KL annealing of the
    latent-SDE examples)."""

    def __init__(self, iters, maxval=1.0):
        self._iters = max(1, iters)
        self._val = maxval / self._iters
        self._maxval = maxval

    def step(self):
        self._val = min(self._maxval, self._val + self._maxval / self._iters)

    @property
    def val(self):
        return self._val


class EMAMetric:
    """Exponential moving average of a scalar metric."""

    def __init__(self, gamma=0.99):
        self._val = 0.0
        self._gamma = gamma

    def step(self, x):
        self._val = self._gamma * self._val + (1 - self._gamma) * float(x)
        return self._val

    @property
    def val(self):
        return self._val
