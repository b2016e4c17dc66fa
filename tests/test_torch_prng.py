"""The port's Philox normal stream (kernel 16's plain version) and the
``rng_impl`` option of ``sample_grid_noise`` and ``sdeint``.

The JAX package's bulk generator draws from the TPU's hardware PRNG, which
has no counterpart off the TPU (and no CPU lowering), so the port's stream
is its own: the plain version is held to Random123's known answers for
Philox4x32-10, to the JAX kernel's Box–Muller formula (``prng.py:42-49``)
on given bits, and to the law of N(0, 1). The CUDA kernel is held to the
plain version on the card (chip_smoke.py, tests/test_torch_gpu.py)."""

import math

import numpy as np
import pytest
import torch
from scipy import stats

import torchsde_tpu_torch as ttsde
from torchsde_tpu.core import integrate as JI
from torchsde_tpu_torch.core import integrate as TI
from torchsde_tpu_torch.ops import prng as PR

# Random123's known-answer vectors for philox4x32_10: (counter, key, output).
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS)
def test_philox_known_answers(counter, key, want):
    words = [torch.tensor(c, dtype=torch.int64) for c in counter]
    got = PR.philox4x32_10(words, key)
    assert tuple(int(w) for w in got) == want


def test_mulhilo_never_overflows():
    """The 16-bit split gives the exact 64-bit product for the largest
    words, where a plain int64 product would wrap."""
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000, 0x12345678],
                     dtype=torch.int64)
    for m in (0xD2511F53, 0xCD9E8D57):
        hi, lo = PR._mulhilo(m, x)
        for xi, h, lw in zip(x.tolist(), hi.tolist(), lo.tolist()):
            assert (h << 32) | lw == m * xi


def test_box_muller_matches_the_jax_kernels_formula():
    """The plain version's transform of given 32-bit words against
    ``prng.py:42-49`` written in numpy float32: the cosine half as that
    formula, the sine half as its counterpart, sqrt(-2 log u1) sin(2 pi u2);
    atol 2e-6 (numpy and PyTorch compute log, cos and sin in float32 by
    different vectorised routines, an ulp or two apart, times r <= 5.9)."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64)
    bits[:, :4] = [[0, 255, 2 ** 32 - 1, 2 ** 31], [0, 2 ** 32 - 1, 7, 1]]
    cos_half, sin_half = PR.box_muller(
        torch.as_tensor(bits[0].astype(np.int64)),
        torch.as_tensor(bits[1].astype(np.int64)))
    i1 = (bits[0] >> 8).astype(np.int32)
    i2 = (bits[1] >> 8).astype(np.int32)
    u1 = i1.astype(np.float32) * np.float32(2.0 ** -24) + np.float32(2.0 ** -25)
    u2 = i2.astype(np.float32) * np.float32(2.0 ** -24) + np.float32(2.0 ** -25)
    r = np.sqrt(np.float32(-2.0) * np.log(u1))
    theta = np.float32(2.0 * math.pi) * u2
    for got, want in ((cos_half, r * np.cos(theta)),
                      (sin_half, r * np.sin(theta))):
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_stream_follows_the_layout():
    """Element e takes counter e // 4 under key (seed, 0): words 0, 1 give
    elements 4c and 4c+1 (cosine, sine), words 2, 3 elements 4c+2 and
    4c+3; a ragged tail keeps the stream's first elements."""
    seed = 12345
    z = PR.philox_normal_plain(seed, (11,), device="cpu")
    zero = torch.zeros((), dtype=torch.int64)
    for e in range(11):
        c = torch.tensor(e // 4, dtype=torch.int64)
        w = PR.philox4x32_10((c, zero, zero, zero), (seed, 0))
        pair = (w[0], w[1]) if e % 4 < 2 else (w[2], w[3])
        assert float(PR.box_muller(*pair)[e % 2]) == float(z[e])


def test_normals_pass_ks_against_n01():
    """2^17 draws: a KS test against N(0, 1) and the first four moments
    within five standard errors."""
    n = 2 ** 17
    z = PR.philox_normal(torch.tensor([2024], dtype=torch.int32), (n,))
    z = z.double().numpy()
    sd = 1 / math.sqrt(n)
    assert stats.kstest(z, "norm").pvalue > 1e-3
    assert abs(z.mean()) < 5 * sd
    assert abs(z.var() - 1) < 5 * math.sqrt(2) * sd
    assert abs(stats.skew(z)) < 5 * math.sqrt(6) * sd
    assert abs(stats.kurtosis(z)) < 5 * math.sqrt(24) * sd


def test_stream_is_a_function_of_seed_and_index():
    """The same seed gives the same stream; any shape is a reshape of the
    flat stream (so the tiling of a launch cannot matter); another seed
    gives another stream; the dtype is a cast of the float32 stream."""
    seed = torch.tensor([7], dtype=torch.int32)
    flat = PR.philox_normal(seed, (105,))
    torch.testing.assert_close(PR.philox_normal(seed, (3, 5, 7)),
                               flat.reshape(3, 5, 7), rtol=0, atol=0)
    torch.testing.assert_close(PR.philox_normal(7, (104,), device="cpu"),
                               flat[:104], rtol=0, atol=0)
    torch.testing.assert_close(PR.philox_normal(seed, (105,)), flat, rtol=0,
                               atol=0)
    assert not torch.equal(PR.philox_normal(seed + 1, (105,)), flat)
    f64 = PR.philox_normal(seed, (105,), torch.float64)
    assert f64.dtype == torch.float64
    torch.testing.assert_close(f64, flat.double(), rtol=0, atol=0)


def test_no_fallback_off_the_cpu():
    seed = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="no Philox normals"):
        PR.philox_normal(seed.to("meta"), (4,))
    with pytest.raises(ValueError, match="runs on the card"):
        PR.philox_normal_cuda(seed, (4,))
    with pytest.raises(ValueError, match="device="):
        PR.philox_normal(3, (4,))


def test_sample_grid_noise_philox():
    """rng_impl='philox': one seed randint(0, 2^31 - 1) from the generator,
    W's normals from its stream and H's from seed + 1; the same generator
    state gives the same noise, another state other noise, and W scaled
    back is N(0, 1)."""
    grid = JI.build_step_grid(0.0, 1.0, 0.05)
    size = (512, 4)
    W, U, A = TI.sample_grid_noise(torch.Generator().manual_seed(9), grid,
                                   size, torch.float64, needs_U=True,
                                   rng_impl="philox")
    gen = torch.Generator().manual_seed(9)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         dtype=torch.int32)
    shape = (len(grid) - 1, *size)
    dts = torch.as_tensor(np.diff(grid))[:, None, None]
    z_w = PR.philox_normal(seed, shape, torch.float64)
    z_h = PR.philox_normal(seed + 1, shape, torch.float64)
    torch.testing.assert_close(W, z_w * dts.sqrt(), rtol=0, atol=0)
    torch.testing.assert_close(U, dts * (0.5 * W + z_h * torch.sqrt(dts / 12)),
                               rtol=0, atol=0)
    assert A is None
    again = TI.sample_grid_noise(torch.Generator().manual_seed(9), grid, size,
                                 torch.float64, needs_U=True,
                                 rng_impl="philox")
    assert torch.equal(again[0], W) and torch.equal(again[1], U)
    other = TI.sample_grid_noise(torch.Generator().manual_seed(10), grid,
                                 size, torch.float64, rng_impl="philox")
    assert not torch.equal(other[0], W)
    assert stats.kstest((W / dts.sqrt()).flatten().numpy(),
                        "norm").pvalue > 1e-3


class Brownian(ttsde.SDEIto):
    """dy = dW: srid2 then gives y_T = y0 + W_T exactly."""

    def __init__(self):
        super().__init__(noise_type="diagonal")

    def f(self, t, y):
        return torch.zeros_like(y)

    def g(self, t, y):
        return torch.ones_like(y)


def test_sdeint_philox_law_and_determinism():
    """sdeint(method='srk', rng_impl='philox'): a seeded generator gives the
    same solve twice and another than rng_impl='generator'; y_T of dy = dW
    on [0, 1] is N(0, 1) (KS)."""
    y0 = torch.zeros((4096, 2), dtype=torch.float64)

    def solve(impl, seed=0):
        return ttsde.sdeint(Brownian(), y0, [0.0, 1.0], method="srk", dt=0.1,
                            rng_impl=impl,
                            generator=torch.Generator().manual_seed(seed))

    a, b = solve("philox"), solve("philox")
    assert torch.equal(a, b) and not torch.equal(a, solve("generator"))
    assert not torch.equal(a, solve("philox", 1))
    assert stats.kstest(a[-1].flatten().numpy(), "norm").pvalue > 1e-3


def test_bad_rng_impl_raises():
    grid = JI.build_step_grid(0.0, 1.0, 0.5)
    with pytest.raises(ValueError, match="rng_impl"):
        TI.sample_grid_noise(None, grid, (2, 2), torch.float64,
                             rng_impl="pallas")
    with pytest.raises(ValueError, match="rng_impl"):
        ttsde.sdeint(Brownian(), torch.zeros((2, 2)), [0.0, 1.0], dt=0.5,
                     rng_impl="threefry")
