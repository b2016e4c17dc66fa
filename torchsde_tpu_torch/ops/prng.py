"""Bulk standard normals from a counter-based generator (counterpart of
``torchsde_tpu/ops/prng.py``).

The JAX package's opt-in bulk generator (``rng_impl='pallas'``) draws bits
from the TPU's hardware PRNG inside a Pallas kernel. That stream exists only
on a TPU, so the port has a stream of its own, which the CUDA kernel
(``csrc/philox_normal.cu``, kernel 16's port) and :func:`philox_normal_plain`
compute alike, and which depends on (seed, flat index) only:

* Philox4x32-10 with key (seed, 0); element e takes the counter (e // 4 as
  a 64-bit value in words 0-1, 0, 0): words 0 and 1 give elements 4c and
  4c+1, words 2 and 3 elements 4c+2 and 4c+3;
* paired Box-Muller on 24-bit uniforms in float32: u = (bits >> 8) * 2^-24
  + 2^-25, r = sqrt(-2 log u1), theta = 2 pi u2, and the pair is r cos(theta),
  r sin(theta). Each cosine is the JAX kernel's formula on its two words.

So one Philox call gives four normals, as ``torch.randn`` draws them (a
stream of its own). Seeded draws differ from the port's first layout (one
counter a pair of elements, cosines only); the law is the same.

:func:`philox_normal` routes a CPU request to the plain version and a CUDA
request to the kernel (which raises rather than fall back); ``launches``
counts the kernel's launches. ``core/integrate.sample_grid_noise`` uses it
under ``rng_impl='philox'``.
"""

import math

import torch

from . import _build

launches = 0

_M = (0xD2511F53, 0xCD9E8D57)       # round multipliers
_W = (0x9E3779B9, 0xBB67AE85)       # key bumps
_MASK = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi


def _mulhilo(m, x):
    """The high and low 32-bit words of m * x, m a 32-bit constant and x an
    int64 tensor of 32-bit words. The 64-bit product would overflow int64's
    sign bit, so m is split into 16-bit halves: x * m_lo and x * m_hi are
    below 2^48, and m * x = (x * m_hi >> 16) * 2^32 + s with
    s = x * m_lo + ((x * m_hi) & 0xffff) * 2^16 below 2^49."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11, Random123's constants) on int64
    tensors holding 32-bit words: ``counter`` four words, ``key`` two (ints
    or tensors). Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W[0]) & _MASK
            k1 = (k1 + _W[1]) & _MASK
        hi0, lo0 = _mulhilo(_M[0], c0)
        hi1, lo1 = _mulhilo(_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def box_muller(bits1, bits2):
    """Two standard normals in float32 from two tensors of 32-bit words: the
    cosine half, as the JAX package's ``_normal_kernel`` forms it
    (``prng.py:42-49``), and the sine half of the same radius and angle."""
    u1 = (bits1 >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    u2 = (bits2 >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    r = torch.sqrt(-2.0 * torch.log(u1))
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32, device=u2.device)
    theta = two_pi * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def philox_normal_plain(seed, shape, dtype=torch.float32, device=None):
    """The kernel's stream as PyTorch operators: standard normals of
    ``shape`` for ``seed`` (an int, or a one-element integer tensor on
    ``device``), computed in float32 and cast to ``dtype``."""
    device = _device_of(seed, device)
    n = math.prod(shape)
    quads = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(quads)
    key = (_seed_word(seed, device), 0)
    w0, w1, w2, w3 = philox4x32_10((quads & _MASK, quads >> 32, zero, zero),
                                   key)
    z = torch.stack([*box_muller(w0, w1), *box_muller(w2, w3)], dim=1)
    return z.reshape(-1)[:n].reshape(shape).to(dtype)


def philox_normal_cuda(seed, shape, dtype=torch.float32, device=None):
    """Launch the kernel on the current stream: the stream of
    :func:`philox_normal_plain`, written as float32 and cast to ``dtype``.
    ``seed`` is a one-element int32 tensor on the card (read there, so the
    call needs no host sync) or an int. Raises on a failed build and on a
    refused launch."""
    global launches
    device = _device_of(seed, device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel runs on the card, got {device}")
    if not torch.is_tensor(seed):
        seed = torch.tensor([seed], dtype=torch.int32, device=device)
    if (seed.dtype != torch.int32 or seed.numel() != 1
            or seed.device != device):
        raise ValueError(f"seed must be one int32 on {device}, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    lib = _build.load_library()
    out = torch.empty(shape, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.tsde_philox_normal(seed.data_ptr(), out.data_ptr(), out.numel(),
                                device.index or 0, stream)
    _build.check_launch(lib, rc, "philox_normal")
    launches += 1
    return out.to(dtype)


def philox_normal(seed, shape, dtype=torch.float32, device=None):
    """Standard normals of ``shape`` from the port's Philox stream: the
    plain version for the CPU, the kernel for the card, no fallback between
    them. ``device`` defaults to the seed tensor's."""
    device = _device_of(seed, device)
    if device.type == "cpu":
        return philox_normal_plain(seed, shape, dtype, device)
    if device.type == "cuda":
        return philox_normal_cuda(seed, shape, dtype, device)
    raise ValueError(f"no Philox normals for device {device}")


def _device_of(seed, device):
    """``device`` (the seed's by default), a CUDA one with its index."""
    if device is None:
        if not torch.is_tensor(seed):
            raise ValueError("pass device= with an int seed")
        return seed.device
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _seed_word(seed, device):
    """The key's first word: the seed's low 32 bits as an int64 scalar
    tensor (read on the device, with no host sync)."""
    if torch.is_tensor(seed):
        if seed.numel() != 1 or seed.dtype.is_floating_point:
            raise ValueError(f"seed must be one integer, got {seed.dtype} "
                             f"{tuple(seed.shape)}")
        return seed.reshape(()).to(device=device, dtype=torch.int64) & _MASK
    return torch.tensor(int(seed) & _MASK, dtype=torch.int64, device=device)
