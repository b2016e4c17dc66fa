"""Kernel 9's 3xTF32 tensor-core tiles, what the CPU can check of them.

The TF32 split and the 3xTF32 product of
``torchsde_tpu_torch/ops/csrc/mma_tf32.cuh``, emulated in numpy (TF32 is
float32 rounded to nearest at 11 significant bits; an ``mma.sync.m16n8k8``
adds eight exact products of TF32 values to a float32 accumulator, here
rounded to nearest), at the layer shapes of kernel 9 at E1 and of the
critic's tower (kernel 8's widths), held against float64 with the kernels'
tolerances (chip_smoke.py: values max(2e-5, 4e-6 * scale), gradients
max(1e-4, 1e-5 * scale)). Then the host rules around the kernel: kernel
9's design (``fused_solve.forward_design`` for ``EULER_FWD``) and the
shared memory of its 3xTF32 layout (``fwd_smem_bytes(mma=True)``, the C
``make_mma_layout``). The kernels themselves run only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest

import torchsde_tpu_torch.ops.fused_solve as TFS


def tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to nearest (ties away from zero)
    at 10 stored mantissa bits."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x, parts):
    """x as ``parts`` TF32 values, each the rounding of what is left."""
    out, rest = [], np.asarray(x, np.float32)
    for _ in range(parts):
        p = tf32(rest)
        out.append(p)
        rest = (rest - p).astype(np.float32)
    return out


# The products of mma_tf32.cuh's mma3, in its order: (index of A's part,
# index of B's part), the smallest first.
TERMS = ((1, 0), (0, 1), (0, 0))


def mma_product(a, b):
    """a (M, K) . b (K, N) as kernel 9 forms it: for each k-tile of 8, the
    products of TERMS, each eight exact products of TF32 values added to
    the float32 accumulator."""
    pa, pb = split(a, 2), split(b, 2)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        for i, j in TERMS:
            tile = pa[i][:, k:k + 8].astype(np.float64) @ \
                pb[j][k:k + 8].astype(np.float64)
            acc = (acc + tile).astype(np.float32)
    return acc


def test_tf32_split_is_round_to_nearest_and_near_exact():
    """Every part is a TF32 value (13 low bits zero); two parts hold x to
    2^-22 of it, three parts exactly, over eight decades and both signs."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000)
         * 10.0 ** rng.uniform(-4, 4, 20000)).astype(np.float32)
    for parts in (2, 3):
        ps = split(x, parts)
        for p in ps:
            assert not np.any(p.view(np.uint32) & np.uint32(0x1FFF))
        rest = x.astype(np.float64) - sum(p.astype(np.float64) for p in ps)
        bound = 2.0 ** -22 if parts == 2 else 0.0
        assert np.all(np.abs(rest) <= bound * np.abs(x.astype(np.float64)))
    # Round to nearest, not truncation: 1 + 2^-11 + 2^-13 rounds up.
    assert tf32(np.float32(1 + 2 ** -11 + 2 ** -13)) == np.float32(1 + 2 ** -10)


# (M, K, N) of the per-step products: kernel 9 at E1 (32 rows, d 32,
# hidden 128: both layers), on general noise with time (16 rows, K 17
# padded to 24); the critic's tower at kernel 8's widths (16 rows, S 17, M
# 16, C 2: layer 1 over [t | z | 1], layer 2, and the two input
# cotangents' products).
KERNEL9 = [(32, 32, 128), (32, 128, 32), (16, 24, 64), (16, 64, 64)]
CRITIC = [(16, 24, 16), (16, 16, 48), (16, 48, 16), (16, 16, 24)]


@pytest.mark.parametrize("shape", KERNEL9 + CRITIC)
def test_3xtf32_products_against_float64(shape):
    """One product at each layer shape, on activations of unit scale and
    weights of the JAX benchmark's scale (0.3 / sqrt(fan_in)): within 1e-6
    of the output's scale from float64, a quarter of kernel 9's relative
    tolerance (4e-6) and a tenth of kernel 8's (1e-5); and within 2^-21 of
    sum |a| |b| per output, what the operands' rounding to 2^-22 allows."""
    M, K, N = shape
    rng = np.random.default_rng(M * K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.3 / np.sqrt(K)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    err = np.abs(mma_product(a, b) - exact)
    assert err.max() <= 1e-6 * np.abs(exact).max()
    assert np.all(err <= 2.0 ** -21 * mag)


def _spec(d, hidden, m=None, wt=False, depth=2):
    """An Euler solve's spec: softplus/linear drift and lipswish/sigmoid
    diffusion towers, diagonal noise unless m is given."""
    diag = m is None
    n_in = d + int(wt)

    def tower(out, acts):
        sizes = [n_in] + [hidden] * (depth - 1) + [out]
        return tuple(zip(sizes[:-1], sizes[1:], acts))

    return TFS.SolveSpec(
        tower(d, ("softplus",) * (depth - 1) + ("linear",)),
        tower(d if diag else d * m, ("lipswish",) * (depth - 1) + ("sigmoid",)),
        d, d if diag else m, diag, wt)


@pytest.mark.parametrize("B,d,m,wt,hidden,depth,sms,want", [
    # E1: both towers split (226,736 bytes) in one block of 32 rows, one
    # wave of 128 blocks; 8 warps a tower (32 output tiles of layer 1, 4 a
    # warp). On twice the SMs one wave takes 16 rows: the FMA tiles, both
    # towers staged, 128 threads a tower.
    (4096, 32, None, False, 128, 2, 132, (1, 32, 512, 3)),
    (4096, 32, None, False, 128, 2, 264, (0, 16, 256, 3)),
    # General noise with time, depth 3, and the narrow solve: one wave at 8
    # rows, the FMA tiles with both towers staged.
    (1024, 16, 4, True, 64, 3, 132, (0, 8, 256, 3)),
    (256, 8, None, False, 16, 2, 132, (0, 8, 256, 3)),
    # R1's widths: split, the towers fit no block at any rows (599,728
    # bytes at 8), nor staged (307,376): 8 rows, the drift staged; past
    # one wave of 8-row blocks none.
    (1024, 128, None, False, 128, 2, 132, (0, 8, 256, 1)),
    (4096, 128, None, False, 128, 2, 132, (0, 8, 256, 0)),
])
def test_forward_design_rule_kernel_9(B, d, m, wt, hidden, depth, sms, want):
    """Kernel 9's design from the widths, the batch and the SMs: 3xTF32
    tiles where every tower fits a block split and the fewest rows that
    fill the card in one wave are 32, a warp a tower for every four 16 x 8
    output tiles of the widest layer (at most eight); else kernels 11 and
    13's FMA designs without a cluster. The design fits a block."""
    spec = _spec(d, hidden, m, wt, depth)
    design = TFS.forward_design(TFS.EULER_FWD, spec, B, sms)
    assert isinstance(design, TFS.EulerFwdDesign)
    assert tuple(design) == want
    assert TFS.fwd_smem_bytes(TFS.EULER_FWD, spec, design.stage, design.rows,
                              1, mma=design.mma) <= \
        TFS._build.MAX_SMEM_BYTES


def test_forward_design_rule_kernel_9_shared_memory_limits(monkeypatch):
    """The shared memory the rule reads is the C layouts' (csrc/
    tower_fwd_tile.cuh: make_mma_layout, make_tile_layout): at E1 the split
    towers, with the hidden layer's output split too, take 226,736 bytes
    at 32 rows, the FMA tiles with both towers staged
    86,960 / 100,272 / 126,896 and with none 20,144 at 8. Under a cut limit
    that leaves the split towers no block of 32 rows the rule takes the
    FMA tiles, then the 8-row design streaming from L2."""
    spec = _spec(32, 128)
    assert TFS.fwd_smem_bytes(TFS.EULER_FWD, spec, 3, 32, 1, mma=True) == \
        226736
    assert [TFS.fwd_smem_bytes(TFS.EULER_FWD, spec, 3, R, 1)
            for R in TFS.FWD_ROWS] == [86960, 100272, 126896]
    assert TFS.fwd_smem_bytes(TFS.EULER_FWD, spec, 0, 8, 1) == 20144
    # The split layout takes 32 rows whatever the staging or rows asked.
    assert TFS.fwd_smem_bytes(TFS.EULER_FWD, spec, 0, 8, 1, mma=True) == \
        226736
    monkeypatch.setattr(TFS._build, "MAX_SMEM_BYTES", 180000)
    assert tuple(TFS.forward_design(TFS.EULER_FWD, spec, 4096, 132)) == \
        (0, 32, 512, 3)
    monkeypatch.setattr(TFS._build, "MAX_SMEM_BYTES", 100000)
    assert tuple(TFS.forward_design(TFS.EULER_FWD, spec, 4096, 132)) == \
        (0, 8, 256, 3)
    monkeypatch.setattr(TFS._build, "MAX_SMEM_BYTES", 60000)
    assert tuple(TFS.forward_design(TFS.EULER_FWD, spec, 4096, 132)) == \
        (0, 8, 256, 0)
    assert tuple(TFS.forward_design(TFS.EULER_FWD, spec, 1024, 132)) == \
        (0, 8, 256, 1)
    monkeypatch.setattr(TFS._build, "MAX_SMEM_BYTES", 15000)
    with pytest.raises(ValueError, match="shared memory"):
        TFS.forward_design(TFS.EULER_FWD, spec, 1024, 132)


@pytest.mark.parametrize("widest,want", [
    (128, 512), (64, 256), (40, 256), (16, 64), (8, 64),
])
def test_mma_threads(widest, want):
    """Kernel 9's 3xTF32 threads: two towers, a warp for every four output
    tiles (two m-tiles of 16 rows x n-tiles of 8 units) of the widest
    layer, one to eight warps a tower."""
    assert TFS.mma_threads(_spec(8, widest)) == want


def test_mma_design_takes_32_rows():
    """A 3xTF32 design of other rows than MMA_ROWS is refused on the host,
    before any build or launch."""
    spec = _spec(32, 128)
    with pytest.raises(ValueError, match="32 rows"):
        TFS._forward_library(TFS.EULER_FWD, spec, 4096, None,
                             design=TFS.EulerFwdDesign(1, 16, 256, 3))
