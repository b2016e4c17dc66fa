"""Kernels 10, 12 and 14's plain versions, split as the kernels are into a
sweep that carries only the step-to-step chain and writes a scratch, and a
contraction of that scratch into the towers' weight gradients
(``ops/fused_solve.py``: ``euler_solve_backward_sweep_plain``,
``rh_solve_backward_sweep_plain``,
``euler_logqp_solve_backward_sweep_plain``, ``tower_contract_plain``,
``scratch_views``).

The composed versions are held to the unsplit loops they replaced
(``tests/port_bridge.py``: ``unsplit_euler_backward``,
``unsplit_rh_backward``, ``unsplit_logqp_backward``), which the JAX
package's tests already hold to
its Pallas kernels; the contraction to ``torch.einsum`` over steps and rows;
and the workspace views to the layout the CUDA sweeps write. All in
float64 at small shapes, inputs from numpy seeds."""

import numpy as np
import pytest
import torch

from port_bridge import (unsplit_euler_backward, unsplit_logqp_backward,
                         unsplit_rh_backward)
from torchsde_tpu_torch.ops import fused_solve as FS

F64 = dict(dtype=torch.float64)

# (kind, S, m, diag, with_time, drift (hidden, acts), diffusion (hidden,
# acts), B, N): Euler ("euler") and reversible Heun ("rh") on diagonal and
# general noise, with and without a time column, depth 1 to 3, a width of
# 1, ragged batches; the logqp solve ("logqp", the prior shaped like the
# drift) on a signed diffusion and on one with a column that is zero
# throughout (the |g| > 1e-7 mask).
CASES = [
    ("rh", 4, 4, True, False, ((16,), ("softplus", "linear")),
     ((16,), ("lipswish", "sigmoid")), 13, 3),
    ("rh", 3, 2, False, True, ((9, 7), ("softplus", "tanh", "linear")),
     ((5, 6), ("lipswish", "softplus", "sigmoid")), 9, 4),
    ("rh", 1, 1, True, True, ((), ("linear",)), ((), ("sigmoid",)), 5, 2),
    ("rh", 5, 3, False, False, ((1,), ("tanh", "linear")),
     ((1,), ("softplus", "tanh")), 7, 3),
    ("logqp", 6, 6, True, True, ((12,), ("softplus", "linear")),
     ((10,), ("lipswish", "tanh")), 11, 4),
    ("logqp", 3, 3, True, False, ((4, 5), ("tanh", "softplus", "linear")),
     ((), ("sigmoid",)), 6, 3),
    ("logqp", 1, 1, True, True, ((), ("linear",)), ((1,), ("tanh", "tanh")),
     4, 2),
    ("logqp", 4, 4, True, False, ((8,), ("softplus", "linear")),
     ((8,), ("softplus", "linear")), 5, 3),    # a zero diffusion column
    ("euler", 4, 4, True, False, ((16,), ("softplus", "linear")),
     ((16,), ("lipswish", "sigmoid")), 13, 3),
    ("euler", 3, 2, False, True, ((9, 7), ("softplus", "tanh", "linear")),
     ((5, 6), ("lipswish", "softplus", "sigmoid")), 9, 4),
    ("euler", 1, 1, True, True, ((), ("linear",)), ((), ("sigmoid",)), 5, 2),
    ("euler", 5, 3, False, False, ((1,), ("tanh", "linear")),
     ((1,), ("softplus", "tanh")), 7, 3),
]
IDS = [f"{c[0]}-S{c[1]}-m{c[2]}-t{int(c[4])}-depth{len(c[5][0]) + 1}-"
       f"B{c[7]}" for c in CASES]


def _tower(rng, sizes, acts, scale):
    return FS.TowerSpec([
        (torch.as_tensor(rng.standard_normal((a, b)) * (scale / np.sqrt(a)),
                         **F64),
         torch.as_tensor(0.1 * rng.standard_normal(b), **F64), act)
        for (a, b), act in zip(zip(sizes[:-1], sizes[1:]), acts)])


def _case(case, seed):
    """The backward's arguments for ``case`` on its forward's outputs, the
    sweep and the unsplit loop, and the first tower inputs x0 (N,B,in)."""
    kind, S, m, diag, wt, (fh, facts), (gh, gacts), B, N = case
    rng = np.random.default_rng(seed)
    n_in = S + (1 if wt else 0)
    gwidth = S if diag else S * m
    drift = _tower(rng, [n_in, *fh, S], facts, 0.6)
    diffusion = _tower(rng, [n_in, *gh, gwidth], gacts, 0.8)
    y0 = torch.as_tensor(rng.standard_normal((B, S)), **F64)
    noise = torch.as_tensor(rng.standard_normal((N, B, m)) / np.sqrt(N), **F64)
    t = torch.as_tensor(np.linspace(0.0, 1.0, N + 1), **F64)
    dts = t[1:] - t[:-1]
    gy = torch.as_tensor(rng.standard_normal((N, B, S)), **F64)
    if kind == "euler":
        spec = FS.solve_spec(drift, diffusion, S, m, diag, wt)
        args = (y0, noise, t[:-1], dts, drift.pack(), diffusion.pack(), spec)
        ys = FS.euler_solve_forward_plain(*args)
        y_pre = torch.cat([y0[None], ys[:-1]])
        return ((*args, ys, gy), FS.euler_solve_backward_plain,
                FS.euler_solve_backward_sweep_plain, unsplit_euler_backward,
                spec, FS.first_inputs(t[:-1], y_pre, wt))
    if kind == "rh":
        spec = FS.solve_spec(drift, diffusion, S, m, diag, wt)
        fw, gw = drift.pack(), diffusion.pack()
        x0 = FS.tower_input(t[0], y0, wt)
        f0 = FS.tower_forward(x0, FS.unpack(fw, spec.drift), drift.acts)[0]
        g0 = FS.tower_forward(x0, FS.unpack(gw, spec.diffusion),
                              diffusion.acts)[0]
        args = (y0, f0, g0, noise, t[1:], dts, fw, gw, spec)
        _, zs, gs = FS.rh_solve_forward_plain(*args)
        return ((*args, zs, gs, gy), FS.rh_solve_backward_plain,
                FS.rh_solve_backward_sweep_plain, unsplit_rh_backward, spec,
                FS.first_inputs(t[1:], zs, wt))
    prior = _tower(rng, [n_in, *fh, S], facts, 0.6)
    if gacts[-1] == "linear":          # g's column 0 is zero throughout
        w, b, act = diffusion.layers[-1]
        with torch.no_grad():
            w[:, 0] = 0.0
            b[0] = 0.0
    spec = FS.solve_spec(drift, diffusion, S, S, True, wt, prior=prior)
    args = (y0, noise, t[:-1], dts, drift.pack(), prior.pack(),
            diffusion.pack(), spec)
    ys, _ = FS.euler_logqp_solve_forward_plain(*args)
    ginc = torch.as_tensor(rng.standard_normal((N, B, 1)), **F64)
    y_pre = torch.cat([y0[None], ys[:-1]])
    return ((*args, ys, gy, ginc), FS.euler_logqp_solve_backward_plain,
            FS.euler_logqp_solve_backward_sweep_plain, unsplit_logqp_backward,
            spec, FS.first_inputs(t[:-1], y_pre, wt))


def _close(got, want):
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sweep_and_contraction_compose_to_the_unsplit_backward_f64(case):
    """euler_solve_backward_plain, rh_solve_backward_plain and
    euler_logqp_solve_backward_plain, each a plain sweep composed with the
    plain contraction, against the unsplit loops that sum every weight
    gradient step by step: 1e-12 of each
    tensor's scale in float64 (the two sum over rows and steps in another
    order)."""
    bargs, composed, _, unsplit, _, _ = _case(case, 10)
    got, want = composed(*bargs), unsplit(*bargs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    if case[0] == "logqp" and case[6][1][-1] == "linear":
        # Where g is zero the KL term's gradient is masked, never dy dW:
        # the zero column's weights and bias still get a gradient.
        spec = bargs[7]
        w_last, b_last = FS.unpack(got[4], spec.diffusion)[-1]
        assert float(w_last[:, 0].abs().max()) > 0
        assert float(b_last[0].abs()) > 0


EINSUM = [1, 3, 4, 5, 8, 9, 11]


@pytest.mark.parametrize("case", [CASES[i] for i in EINSUM],
                         ids=[IDS[i] for i in EINSUM])
def test_plain_contraction_is_einsum_over_rows_and_steps(case):
    """The plain contraction against torch.einsum on the sweep's own
    scratch, summed over steps n and rows b: each layer's X^T D (X the
    first inputs [t | state] for a tower's first layer, the scratch's
    inputs after) and its bias the sum of D; rounding only (float64)."""
    bargs, _, sweep, _, spec, x0 = _case(case, 11)
    scratch = sweep(*bargs)[-1]
    N, B = x0.shape[:2]
    shapes = FS._spec_shapes(spec)
    assert len(scratch) == len(shapes)
    got = FS.tower_contract_plain(spec, x0, scratch)
    for (xs, ds), tower, pack in zip(scratch, shapes, got):
        assert [x.shape for x in xs] == [(N, B, i) for i, _, _ in tower[1:]]
        assert [d.shape for d in ds] == [(N, B, o) for _, o, _ in tower]
        want = []
        for i, d in enumerate(ds):
            x = x0 if i == 0 else xs[i - 1]
            want += [torch.einsum("nbi,nbj->ij", x, d).reshape(-1),
                     torch.einsum("nbj->j", d)]
        assert pack.shape == (FS.pack_size(tower),)
        _close(pack, torch.cat(want))


@pytest.mark.parametrize("case", [CASES[1], CASES[5], CASES[9]],
                         ids=[IDS[1], IDS[5], IDS[9]])
def test_scratch_views_follow_the_kernels_workspace_layout(case):
    """scratch_views reads a workspace laid out as the CUDA sweeps write it
    (tower_solve_common.cuh: scratch_columns): every tower's layer inputs
    after the first, then every layer's dpre, in layer order, each (N*B,
    width) with rows padded to a multiple of four floats, then the
    contraction's partial rows."""
    bargs, _, sweep, _, spec, x0 = _case(case, 12)
    scratch = sweep(*bargs)[-1]
    N, B = x0.shape[:2]
    tensors = [x for xs, _ in scratch for x in xs] + [
        d for _, ds in scratch for d in ds]
    blocks = []
    for t in tensors:
        w = t.shape[-1]
        block = torch.full((N * B, (w + 3) // 4 * 4), float("nan"), **F64)
        block[:, :w] = t.reshape(N * B, w)
        blocks.append(block.reshape(-1))
    workspace = torch.cat(blocks + [torch.zeros(9, **F64)])
    views = FS.scratch_views(workspace, spec, B, N)
    assert len(views) == len(scratch)
    for (vx, vd), (px, pd) in zip(views, scratch):
        assert len(vx) == len(px) and len(vd) == len(pd)
        for v, t in zip(vx + vd, px + pd):
            assert torch.equal(v, t.reshape(N * B, -1))


def _chain_workspace_floats(spec, B, W):
    """The floats of kernel 10's, 12's or 14's workspace for windows of W
    steps, as csrc/tower_solve_common.cuh: chain_workspace lays it out: the
    scratch of W*B rows, a partial row of all packs a chunk of 512 rows,
    the carried cotangents of the batch's rows rounded up to eight, then
    the windows' float64 sums on an even float."""
    shapes = FS._spec_shapes(spec)
    ld = [(w + 3) // 4 * 4 for w in
          [i for tower in shapes for i, _, _ in tower[1:]]
          + [o for tower in shapes for _, o, _ in tower]]
    P = sum(FS.pack_size(tower) for tower in shapes)
    M = W * B
    carry = M * sum(ld) + -(-M // 512) * P
    sums = carry + -(-B // 8) * 8 * (3 * spec.S + spec.gwidth)
    return sums + sums % 2 + 2 * P


def _wide_spec(S, hidden, prior):
    """A diagonal-noise spec of one-hidden-layer towers, S -> hidden -> S
    (the prior shaped like the drift)."""
    rng = np.random.default_rng(0)

    def tower():
        return _tower(rng, [S, hidden, S], ("softplus", "linear"), 0.5)

    return FS.solve_spec(tower(), tower(), S, S, True, False,
                         prior=tower() if prior else None)


@pytest.mark.parametrize("S,hidden,prior,B,N,windows", [
    (128, 128, False, 1024, 128, 1),       # R1: one window
    (128, 128, False, 1024, 1024, 2),      # R1 at 1,024 steps
    (32, 128, True, 4096, 128, 1),         # L1: one window
    (32, 128, True, 4096, 1000, 7),        # L1 at 1,000 steps
    (32, 128, False, 4096, 128, 1),        # E1: one window
    (32, 128, False, 4096, 512, 3),        # E1 at 512 steps
    (128, 128, False, 1 << 22, 4, 4),      # a step alone outgrows the bytes
], ids=["R1", "R1-long", "L1", "L1-long", "E1", "E1-long", "huge-batch"])
def test_bwd_window_bounds_the_workspace(S, hidden, prior, B, N, windows):
    """bwd_window: a solve whose workspace fits WORKSPACE_BYTES (2 GiB)
    runs in one window; a longer one in windows of the most steps that fit
    (within one of the exact most), so its workspace stays within the
    bytes however many steps it takes; at least one step a window."""
    spec = _wide_spec(S, hidden, prior)
    W = FS.bwd_window(spec, B, N)
    assert -(-N // W) == windows
    if W == 1:
        return
    assert 4 * _chain_workspace_floats(spec, B, W) <= FS.WORKSPACE_BYTES
    if W < N:
        assert 4 * _chain_workspace_floats(spec, B, W + 2) > \
            FS.WORKSPACE_BYTES
