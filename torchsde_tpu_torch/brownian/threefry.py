"""The port's copy of what ``jax.random`` gives the JAX package's Brownian
samplers: Threefry-2x32 keys, ``split``, ``fold_in``, random bits, uniforms
and normals, in the partitionable form JAX uses by default
(``jax_threefry_partitionable``).

A key is an int64 tensor whose last axis holds two 32-bit words (values in
``[0, 2**32)``), or a batch of them: ``(..., 2)``. Every function maps over
the batch, so a descent can fold a different bit into each point's key.
Keys, ``split``, ``fold_in`` and the random bits equal JAX's bitwise on
any device. The hash runs in int32 (its additions wrap like uint32's, and
a logical right shift is an arithmetic one masked), which moves half the
bytes of int64.

``normal`` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
``(nextafter(-1, 0), 1)``, as ``jax.random.normal`` forms it; ``torch.erfinv``
is not XLA's ``erf_inv`` (nor is CUDA's the CPU's), so normals, and what is
computed from them, agree with JAX's to rounding only.
"""

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _to_i32(x):
    """int64 words in ``[0, 2**32)`` -> int32 tensors of the same bits."""
    x = x & MASK
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _to_u32(x):
    """int32 bits -> int64 words in ``[0, 2**32)``."""
    return x.to(torch.int64) & MASK


def _rotl(x, r):
    """Rotate 32-bit words left by ``r``, in place on ``x``."""
    hi = x << r
    return x.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1) \
        .bitwise_or_(hi)


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on int32 tensors (broadcast against
    each other), as ``jax._src.prng._threefry2x32_lowering``. Returns the
    two output words as int32 tensors of the broadcast shape."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + k0
    x1 = x1 + k1
    shape = torch.broadcast_shapes(x0.shape, x1.shape)
    x0 = x0.expand(shape).contiguous()
    x1 = x1.expand(shape).contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def _key_words(key):
    """The two words of ``key`` (..., 2) as int32 tensors of shape (..., 1)."""
    key = _to_i32(torch.as_tensor(key))
    return key[..., 0:1], key[..., 1:2]


def prng_key(seed, device=None):
    """``jax.random.PRNGKey(seed)`` for a 64-bit seed: its high and low
    words. Returns an int64 tensor of shape (2,)."""
    s = int(seed) & (2 ** 64 - 1)
    return torch.tensor([s >> 32, s & MASK], dtype=torch.int64, device=device)


def split(key, num=2):
    """``jax.random.split(key, num)``: (..., 2) -> (..., num, 2)."""
    k0, k1 = _key_words(key)
    counts = torch.arange(num, dtype=torch.int32, device=k0.device)
    y0, y1 = _threefry(k0, k1, torch.zeros_like(counts), counts)
    return torch.stack([_to_u32(y0), _to_u32(y1)], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: ``data`` (an int or an integer
    tensor broadcast against the key's batch; int32 values are taken as
    uint32, so -1 is 0xFFFFFFFF). Returns the new key (..., 2)."""
    key = torch.as_tensor(key)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    k0, k1 = _key_words(key)
    y0, y1 = _threefry(k0[..., 0], k1[..., 0], torch.zeros_like(data),
                       _to_i32(data))
    return torch.stack([_to_u32(y0), _to_u32(y1)], dim=-1)


def _bits_pair(key, shape):
    """Threefry of the flat index of ``shape`` under each key: the words
    (``bits1``, ``bits2``) of ``jax.random.bits``' partitionable form, as
    int32 tensors of shape ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 2 ** 31:
        raise ValueError(f"random bits of {n} elements a key: at most "
                         f"2**31 - 1 are supported")
    k0, k1 = _key_words(key)
    counts = torch.arange(n, dtype=torch.int32, device=k0.device)
    y0, y1 = _threefry(k0, k1, torch.zeros((1,), dtype=torch.int32,
                                           device=k0.device), counts)
    batch = tuple(k0.shape[:-1])
    return y0.reshape(batch + shape), y1.reshape(batch + shape)


def random_bits(key, shape, bit_width=32):
    """``jax.random.bits(key, shape, uint32 | uint64)``: int64 tensors of
    shape ``key.shape[:-1] + shape`` holding the 32-bit words, or the
    64-bit words' bit patterns (two's complement)."""
    y0, y1 = _bits_pair(key, shape)
    if bit_width == 32:
        return _to_u32(y0 ^ y1)
    if bit_width == 64:
        return (_to_u32(y0) << 32) | _to_u32(y1)
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _unit_floats(key, shape, dtype):
    """Floats in [1, 2) from the mantissa bits, as ``jax.random.uniform``'s
    bit trick, minus one: uniforms on [0, 1)."""
    y0, y1 = _bits_pair(key, shape)
    if dtype == torch.float32:
        bits = (y0 ^ y1).bitwise_right_shift_(9).bitwise_and_(0x7FFFFF)
        return bits.bitwise_or_(0x3F800000).view(torch.float32) - 1.0
    if dtype == torch.float64:
        bits = ((_to_u32(y0) << 20) | (_to_u32(y1) >> 12)
                | 0x3FF0000000000000)
        return bits.view(torch.float64) - 1.0
    raise ValueError(f"uniform and normal take float32 or float64, got "
                     f"{dtype}")


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = np_dtype(minval)
    scale = np_dtype(maxval) - lo
    u = _unit_floats(key, shape, dtype)
    return u.mul_(float(scale)).add_(float(lo)).clamp_min_(float(lo))


def normal(key, shape, dtype=torch.float32):
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2) * erfinv(u)``,
    ``u`` uniform on ``(nextafter(-1, 0), 1)``."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = np.nextafter(np_dtype(-1.0), np_dtype(0.0))
    u = uniform(key, shape, dtype, lo, 1.0)
    return u.erfinv_().mul_(float(np_dtype(np.sqrt(2))))


def fold_in_words(key, data):
    """``fold_in`` of one key given as two Python ints (its 32-bit words)
    and one int ``data``, on the host without tensors: the same words as
    :func:`fold_in`, in microseconds."""
    k0, k1 = (int(w) & MASK for w in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = k0, (int(data) + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1
