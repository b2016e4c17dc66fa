"""The host's mirror of kernels 5, 6 and 7's shared-memory layouts
(``torchsde_tpu_torch/ops/gan_fused.py``), on the CPU.

Kernels 5 (``csrc/gan_gen_fwd.cu``), 6 (``csrc/gan_gen_bwd.cuh``) and 7
(``csrc/gan_cde_fwd.cu``) move a row's vectors through the warp's shared
memory and read each lane's
weights from lane-major copies at strides of 4 x an odd number of floats
(``csrc/gan_warp_rows.cuh``). These tests hold the host's mirror of that
layout to the bytes it must come to, to a block's shared memory, and to
the bank rule. The C
functions themselves are held to the mirror on the card
(``tests/test_torch_gpu.py``)."""

import itertools

import pytest

import torchsde_tpu_torch.ops.gan_fused as GF
from torchsde_tpu_torch.ops import _build

THREADS = (32, 64, 128, 256)
# The GPU tests' shapes of kernels 6 and 7 (batch, S, M, m or C, times).
GEN_SHAPES = ((1024, 16, 16, 3, 64), (1023, 16, 16, 3, 20),
              (300, 16, 16, 1, 20), (300, 9, 24, 3, 20), (64, 32, 32, 8, 8))
CDE_SHAPES = ((2048, 17, 16, 2, 64), (2047, 17, 16, 2, 20),
              (300, 17, 16, 1, 20), (300, 9, 24, 3, 20), (64, 32, 32, 8, 8))
# Kernel 5 runs at the shapes of kernel 6 and at four more.
GEN_FWD_SHAPES = GEN_SHAPES + ((37, 16, 16, 3, 6), (5, 8, 32, 1, 4),
                               (64, 32, 32, 8, 3), (3, 1, 1, 1, 2))


def _banks(stride, lanes=8, quads=4):
    """For each float4 of a lane-major row, the groups of four banks (of
    32) that ``lanes`` consecutive lanes' loads fall in."""
    return [[((lane * stride + 4 * q) % 32) // 4 for lane in range(lanes)]
            for q in range(quads)]


def test_odd_quad_is_four_times_an_odd_number_at_least_n():
    for n in range(1, 300):
        k = GF.odd_quad(n)
        assert k >= n and k % 4 == 0 and (k // 4) % 2 == 1
        assert k - n < 8


def test_every_lane_major_stride_spreads_a_quarter_warp_over_the_banks():
    """At every width the kernels take (S, M <= 32, m or C <= 8), every
    stride of kernels 6 and 7's weight copies is 4 x an odd number of
    floats, so the float4 loads of the eight lanes of a quarter-warp,
    which the card serves together, fall in eight distinct groups of four
    banks."""
    spread = {}
    for S, M, m in itertools.product(range(1, 33), range(1, 33),
                                     range(1, 9)):
        L6 = GF.gen_bwd_layout(S, M, m)
        L7 = GF.cde_fwd_layout(S, M, m)
        assert L6["K3"] == (GF.odd_quad(S), GF.odd_quad(S * m))
        assert L6["K4"] == GF.odd_quad(2 * M)
        for k in (L6["K1"], L6["K2"], *L6["K3"], L6["K4"], L7["K1"],
                  L7["K2"]):
            if k not in spread:
                spread[k] = all(sorted(g) == list(range(8))
                                for g in _banks(k))
            assert k % 4 == 0 and (k // 4) % 2 == 1 and spread[k], k


def test_gen_backward_smem_at_the_reference_widths():
    """Kernel 6 at S 16, M 16, m 3 (G 16): the block's weight copies are
    16 lanes x (2 x 20 + 20 + 3 x 20 + 20 + 52 + 36) = 3,648 floats; a
    warp's two rows' slots 32 lanes x (6 + 3) floats."""
    L = GF.gen_bwd_layout(16, 16, 3)
    assert (L["G"], L["K1"], L["K2"], L["K3"], L["K4"]) == \
        (16, 20, 20, (20, 52), 36)
    assert L["block"] == 3648 and L["row"] == 144
    for threads in THREADS:
        warps = threads // 32
        assert GF.gen_bwd_smem_bytes(16, 16, 3, threads) == \
            4 * (3648 + warps * 288)
    assert GF.gen_bwd_smem_bytes(16, 16, 3, 128) == 19200


def test_gen_backward_smem_at_the_widest_widths():
    """Kernel 6 at S = M = 32, m 8 (G 32, one row a warp):
    32 lanes x (2 x 36 + 36 + 8 x 36 + 36 + 260 + 68) = 24,320 floats of
    weights, then 32 x (6 + 8) floats a warp; 111,616 bytes at 256
    threads, within a block's shared memory."""
    L = GF.gen_bwd_layout(32, 32, 8)
    assert (L["G"], L["K1"], L["K2"], L["K3"], L["K4"]) == \
        (32, 36, 36, (36, 260), 68)
    assert L["block"] == 24320
    for threads in THREADS:
        smem = GF.gen_bwd_smem_bytes(32, 32, 8, threads)
        assert smem == 4 * (24320 + threads // 32 * 448)
        assert smem <= _build.MAX_SMEM_BYTES
    assert GF.gen_bwd_smem_bytes(32, 32, 8, 256) == 111616


def test_cde_forward_smem_at_the_reference_and_widest_widths():
    """Kernel 7: the critic's S 17, M 16, C 2 take 32 lanes a row, W1's
    columns at a stride of 20 and W2's at 20 (1,920 floats), then 64
    floats a warp; S = M = 32, C 8 take 32 x 36 + 256 x 36 = 10,368."""
    L = GF.cde_fwd_layout(17, 16, 2)
    assert (L["G"], L["K1"], L["K2"], L["block"]) == (32, 20, 20, 1920)
    W = GF.cde_fwd_layout(32, 32, 8)
    assert (W["G"], W["K1"], W["K2"], W["block"]) == (32, 36, 36, 10368)
    for threads in THREADS:
        warps = threads // 32
        assert GF.cde_fwd_smem_bytes(17, 16, 2, threads) == \
            4 * (1920 + 64 * warps)
        widest = GF.cde_fwd_smem_bytes(32, 32, 8, threads)
        assert widest == 4 * (10368 + 64 * warps)
        assert widest <= _build.MAX_SMEM_BYTES
    assert GF.cde_fwd_smem_bytes(17, 16, 2, 128) == 8704


@pytest.mark.parametrize("S,M,G", [(1, 1, 4), (3, 2, 4), (5, 8, 8),
                                   (9, 16, 16), (17, 16, 32), (5, 20, 32),
                                   (32, 32, 32)])
def test_cde_forward_group_width(S, M, G):
    """Kernel 7's rows take the power of two at least max(S, M, 4) lanes,
    so a row's slot holds whole float4."""
    assert GF.cde_fwd_group(S, M) == G


@pytest.mark.parametrize("S,M,G", [(16, 16, 16), (1, 1, 16), (9, 16, 16),
                                   (17, 16, 32), (9, 24, 32), (32, 32, 32)])
def test_gen_backward_group_width(S, M, G):
    """Kernel 6's rows take 16 lanes, two rows a warp, where S, M <= 16,
    else 32: its slots hold a warp's 32 lanes either way."""
    assert GF.gen_bwd_group(S, M) == G
    assert GF.gen_bwd_layout(S, M, 3)["row"] * (32 // G) == 32 * 9


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("shape", GEN_SHAPES + CDE_SHAPES)
def test_gpu_test_shapes_fit_a_block(shape, threads):
    """Every shape the GPU tests launch kernels 6 and 7 at fits a block's
    shared memory at every block size, and its weight copies stay the
    lane-major ones (each lane row a stride of 4 x an odd number)."""
    _, S, M, K, _ = shape
    if shape in GEN_SHAPES:
        L = GF.gen_bwd_layout(S, M, K)
        assert L["block"] == L["G"] * (2 * L["K1"] + (1 + K) * L["K2"]
                                       + sum(L["K3"]) + L["K4"])
        assert GF.gen_bwd_smem_bytes(S, M, K, threads) <= \
            _build.MAX_SMEM_BYTES
    if shape in CDE_SHAPES:
        L = GF.cde_fwd_layout(S, M, K)
        assert L["block"] == L["G"] * (L["K1"] + K * L["K2"])
        assert GF.cde_fwd_smem_bytes(S, M, K, threads) <= \
            _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("S,M,G", [(16, 16, 16), (1, 1, 16), (9, 16, 16),
                                   (16, 9, 16), (17, 16, 32), (9, 24, 32),
                                   (32, 32, 32)])
def test_gen_forward_group_width(S, M, G):
    """Kernel 5 runs one row a warp: where S, M <= 16 its towers sit on the
    two half-warps (16 lanes a tower; a warp's slot holds z1, both towers'
    hidden activations and each half's m outputs a lane), else on all 32
    lanes (z1 and the two towers' activations)."""
    assert GF.gen_fwd_group(S, M) == G
    for m in (1, 3, 8):
        L = GF.gen_fwd_layout(S, M, m)
        assert L["G"] == G
        assert L["warp"] == (3 * 16 + 2 * 16 * m if G == 16 else 3 * 32)


def test_gen_forward_smem_at_the_reference_widths():
    """Kernel 5 at S 16, M 16, m 3: W1's columns of both towers and W2's
    four columns of a unit, 16 lane rows each at a stride of 20, are
    16 x (2 x 20 + 4 x 20) = 1,920 floats; a warp's row 16 + 32 + 96."""
    L = GF.gen_fwd_layout(16, 16, 3)
    assert (L["G"], L["K1"], L["K2"], L["block"], L["warp"]) == \
        (16, 20, 20, 1920, 144)
    for threads in THREADS:
        assert GF.gen_fwd_smem_bytes(16, 16, 3, threads) == \
            4 * (1920 + threads // 32 * 144)
    assert GF.gen_fwd_smem_bytes(16, 16, 3, 128) == 9984


def test_gen_forward_smem_at_the_widest_widths():
    """Kernel 5 at S = M = 32, m 8: 32 lane rows at a stride of 36 for
    W1's columns of both towers and W2's nine columns of a unit, 12,672
    floats, then 96 floats a warp; 53,760 bytes at 256 threads."""
    L = GF.gen_fwd_layout(32, 32, 8)
    assert (L["G"], L["K1"], L["K2"], L["block"], L["warp"]) == \
        (32, 36, 36, 12672, 96)
    for threads in THREADS:
        smem = GF.gen_fwd_smem_bytes(32, 32, 8, threads)
        assert smem == 4 * (12672 + threads // 32 * 96)
        assert smem <= _build.MAX_SMEM_BYTES
    assert GF.gen_fwd_smem_bytes(32, 32, 8, 256) == 53760


@pytest.mark.parametrize("m", range(1, 9))
def test_gen_forward_strides_spread_a_quarter_warp(m):
    """At every S, M <= 32 kernel 5's two strides are 4 x an odd number of
    floats, so a quarter-warp's float4 loads of its weight rows fall in
    eight distinct groups of four banks; the block's part is whole lane
    rows, and each warp's row starts on a float4."""
    for S, M in itertools.product(range(1, 33), range(1, 33)):
        L = GF.gen_fwd_layout(S, M, m)
        for k in (L["K1"], L["K2"]):
            assert k % 4 == 0 and (k // 4) % 2 == 1
            assert all(sorted(g) == list(range(8)) for g in _banks(k))
        assert L["block"] == L["G"] * (2 * L["K1"] + (1 + m) * L["K2"])
        assert L["block"] % 4 == 0 and L["warp"] % 4 == 0


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("shape", GEN_FWD_SHAPES)
def test_gen_forward_gpu_test_shapes_fit_a_block(shape, threads):
    """Every shape the GPU tests launch kernel 5 at fits a block's shared
    memory at every block size."""
    _, S, M, m, _ = shape
    L = GF.gen_fwd_layout(S, M, m)
    smem = GF.gen_fwd_smem_bytes(S, M, m, threads)
    assert smem == 4 * (L["block"] + threads // 32 * L["warp"])
    assert smem <= _build.MAX_SMEM_BYTES
