"""Whole-solve srid2 stochastic Runge–Kutta for diagonal noise (counterpart
of ``torchsde_tpu/ops/srk_fused.py``).

:func:`srk_solve_fused` runs every step of a fixed-step srid2 solve of an
SDE with elementwise drift and diffusion, ``dy = f(t, y) dt + g(t, y) dW``
on (B, D) states, given the per-step increments W and space-time Lévy
integrals U (n, B, D). On the card it is one launch of a CUDA kernel (the
template ``csrc/srk_srid2.cuh``): one thread an element (two in bfloat16,
on bf16x2 arithmetic), the state in a register, W and U streamed in. On the CPU it is :func:`srk_solve_plain`,
the counterpart of the JAX package's ``srk_solve_xla`` and the kernel's
plain version. ``launches`` counts the kernel's launches in float32 and
float64, ``bf16_launches`` in bfloat16.

The JAX package traces Python callables into its kernel. A CUDA kernel
cannot call Python, so f and g are :class:`Elementwise` values: a torch
function for the plain version and a C++ expression for the kernel.
:func:`srk_source` writes a short ``.cu`` defining two functors from the
expressions and including the header, and ``_build.library_for_source``
compiles it at first use and keeps it, named by a hash of its text. A CUDA
solve whose f or g has no expression raises. The TPU's lane packing, tile
size and interpret mode are not ported.
"""

import ctypes
import functools
import math

import torch

from . import _build
from ..core import tableaus
from ..utils.misc import weak_scalar

launches = 0
bf16_launches = 0


class Elementwise:
    """An elementwise drift or diffusion of :func:`srk_solve_fused`.

    ``torch_fn(t, y, *params)`` computes it with PyTorch operators (the
    plain version, and any CPU solve): t a 0-dim tensor, y (B, D), each
    parameter a (D,) row. ``cuda_expr`` is the same function as a C++
    expression of the state's type in ``t``, ``y`` and ``p0``, ``p1``, …,
    each the parameter row's entry at the element's column (f = mu * y is
    ``"p0 * y"``). The kernel is built in float32, float64 and bfloat16, so
    write its math with CUDA's overloaded functions, not the float-only
    ones (``expf``). In bfloat16, ``T`` is ``csrc/srk_srid2.cuh:Bf16x2``
    (two elements, each half reading its own column's parameters), which
    takes ``+ - * /``, unary minus and ``sin``, ``cos``, ``tan``, ``exp``,
    ``log``, ``sqrt``, ``tanh`` and ``fabs``, each bitwise float32 rounded
    to bfloat16, as a PyTorch or XLA bf16 operation rounds.
    Write a constant as ``T(0.1)``: in bfloat16 it is rounded as JAX
    rounds a Python scalar, and a bare double literal beside a ``T`` does
    not compile. PyTorch keeps a Python scalar at float32 in a bf16
    operation, so a ``torch_fn`` for bfloat16 rounds its non-exact
    constants with ``utils.misc.weak_scalar`` to match. None leaves it
    CPU-only."""

    def __init__(self, torch_fn, cuda_expr=None):
        if cuda_expr is not None and (not isinstance(cuda_expr, str)
                                      or not cuda_expr.strip()):
            raise ValueError(f"cuda_expr must be a C++ expression string, "
                             f"got {cuda_expr!r}")
        self.torch_fn = torch_fn
        self.cuda_expr = cuda_expr

    def __call__(self, t, y, *params):
        return self.torch_fn(t, y, *params)


def _srid2_step(f, g, t, dt, y0, I_k, I_k0):
    """One srid2 step (``srk_fused.py:_srid2_step`` of the JAX package,
    the math of ``solvers.SRK`` with the diffusion kept (B, D)); ``dt`` is a
    Python float, ``t`` a 0-dim tensor. Each scalar expression is formed in
    double and rounded once to the state's dtype, as JAX rounds its weak
    Python scalars (a no-op above bfloat16)."""
    tab = tableaus.SRID2
    c = functools.partial(weak_scalar, dtype=y0.dtype)
    rdt = 1.0 / dt
    sqrt_dt = math.sqrt(dt)
    I_kk = (I_k * I_k - c(dt)) * 0.5
    I_kkk = (I_k * I_k * I_k - c(3.0 * dt) * I_k) * c(1.0 / 6.0)

    y1 = y0
    H0, H1 = [], []
    for s in range(tab.STAGES):
        H0s, H1s = y0, y0
        for j in range(s):
            fj = f(t + c(tab.C0[j] * dt), H0[j])
            gj = g(t + c(tab.C1[j] * dt), H1[j])
            if tab.A0[s][j] != 0.0:
                H0s = H0s + c(tab.A0[s][j]) * fj * c(dt)
            if tab.B0[s][j] != 0.0:
                H0s = H0s + c(tab.B0[s][j]) * gj * I_k0 * c(rdt)
            if tab.A1[s][j] != 0.0:
                H1s = H1s + c(tab.A1[s][j]) * fj * c(dt)
            if tab.B1[s][j] != 0.0:
                H1s = H1s + c(tab.B1[s][j]) * gj * c(sqrt_dt)
        H0.append(H0s)
        H1.append(H1s)

        fs = f(t + c(tab.C0[s] * dt), H0s)
        g_weight = (c(tab.beta1[s]) * I_k
                    + c(tab.beta2[s]) * I_kk * c(1.0 / sqrt_dt)
                    + c(tab.beta3[s]) * I_k0 * c(rdt)
                    + c(tab.beta4[s]) * I_kkk * c(rdt))
        y1 = (y1 + c(tab.alpha[s]) * fs * c(dt)
              + g(t + c(tab.C1[s] * dt), H1s) * g_weight)
    return y1


def _step_times(t0, dt, n_steps, y0):
    """t0 + s * dt for every step, with the index in at least float32 (a
    bfloat16 index would be wrong past 256), cast to the state's type."""
    tdtype = torch.promote_types(y0.dtype, torch.float32)
    s = torch.arange(n_steps, dtype=tdtype, device=y0.device)
    return (t0 + s * dt).to(y0.dtype)


def srk_solve_plain(f, g, y0, t0, dt, n_steps, W, U, params=()):
    """The solve as a loop of PyTorch operators (the JAX package's
    ``srk_solve_xla``): ``n_steps`` srid2 steps of width ``dt`` from ``y0``
    (B, D) at ``t0``, step s taking W[s] and U[s]. ``f`` and ``g`` are
    called as ``f(t, y, *params)``. Returns the final state (B, D)."""
    params = tuple(torch.as_tensor(p, dtype=y0.dtype, device=y0.device)
                   for p in params)

    def fp(t, y):
        return f(t, y, *params)

    def gp(t, y):
        return g(t, y, *params)

    ts = _step_times(t0, dt, int(n_steps), y0)
    y = y0
    for s in range(int(n_steps)):
        y = _srid2_step(fp, gp, ts[s], float(dt), y, W[s], U[s])
    return y


def srk_source(f_expr, g_expr, n_params):
    """The ``.cu`` text of a solve: the drift and diffusion functors from
    their C++ expressions, the header, and its entry points."""
    lines = ['// The srid2 solve of csrc/srk_srid2.cuh for one drift and '
             'diffusion,', '// written by ops/srk_fused.py:srk_source.',
             '#include "srk_srid2.cuh"', '', 'namespace {', '']
    names = ["t", "y", "p"] + [f"p{i}" for i in range(n_params)]
    for name, expr in (("Drift", f_expr), ("Diffusion", g_expr)):
        lines += [f"struct {name} {{",
                  "  template <typename T>",
                  "  __device__ __forceinline__ T operator()(T t, T y, "
                  "const T* p) const {"]
        lines += [f"    const T p{i} = p[{i}];" for i in range(n_params)]
        lines += ["    " + " ".join(f"(void){v};" for v in names),
                  f"    return T({expr});", "  }", "};", ""]
    lines += ["}  // namespace", "",
              f"TSDE_SRID2_ENTRY_POINTS(Drift, Diffusion, {n_params})", ""]
    return "\n".join(lines)


_ENTRY = {torch.float32: "tsde_srk_srid2_f32",
          torch.float64: "tsde_srk_srid2_f64",
          torch.bfloat16: "tsde_srk_srid2_bf16"}


def srk_solve_cuda(f, g, y0, t0, dt, n_steps, W, U, params=()):
    """Launch the kernel on the current stream; returns the final state.
    Raises for an f or g without a ``cuda_expr``, for tensors it does not
    take, on a failed build and on a refused launch."""
    global launches, bf16_launches
    for name, fn in (("f", f), ("g", g)):
        if getattr(fn, "cuda_expr", None) is None:
            raise ValueError(
                f"srk_solve_fused on the card needs {name} as an "
                f"Elementwise with a cuda_expr; got {fn!r}")
    if y0.dtype not in _ENTRY:
        raise ValueError(f"the SRK kernel takes bfloat16, float32 or float64 "
                         f"states, got {y0.dtype}")
    if not y0.is_cuda or y0.ndim != 2:
        raise ValueError(f"expected a (B, D) CUDA state, got "
                         f"{tuple(y0.shape)} on {y0.device}")
    B, D = y0.shape
    n = int(n_steps)
    for name, t, shape in (("y0", y0, (B, D)), ("W", W, (n, B, D)),
                           ("U", U, (n, B, D))):
        if (tuple(t.shape) != shape or t.dtype != y0.dtype
                or t.device != y0.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {y0.dtype} of shape "
                             f"{shape} on {y0.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    rows = [torch.as_tensor(p, dtype=y0.dtype, device=y0.device).reshape(D)
            for p in params]
    prm = (torch.stack(rows) if rows
           else torch.zeros((1, D), dtype=y0.dtype, device=y0.device))
    lib = _build.library_for_source(
        "tsde_srk_srid2", srk_source(f.cuda_expr, g.cuda_expr, len(rows)))
    fn = getattr(lib, _ENTRY[y0.dtype])
    P = ctypes.c_void_p
    fn.argtypes = [P] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_double, ctypes.c_double, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    out = torch.empty_like(y0)
    stream = torch.cuda.current_stream(y0.device).cuda_stream
    rc = fn(y0.data_ptr(), W.data_ptr(), U.data_ptr(), prm.data_ptr(),
            out.data_ptr(), B * D, D, n, float(t0), float(dt),
            y0.device.index or 0, stream)
    _build.check_launch(lib, rc, "srk_srid2")
    if y0.dtype == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return out


# The operations of tsde_srk_bf16x2_diffs, in the order of its counts.
BF16X2_OPS = ("add", "sub", "mul", "div")


def bf16x2_check(f, g, n_params, device):
    """The bf16x2 check of the library of f and g (built at first use):
    for each operation of ``BF16X2_OPS`` over all 2^32 pairs of bf16
    operands, how many results of its bf16x2 instruction (``div`` has
    none) and of the pair type's operator as built differ from float32
    rounded to bf16, NaN matching NaN, and whether the build runs it as
    the instruction. For measurement and checks on the card."""
    lib = _build.library_for_source(
        "tsde_srk_srid2", srk_source(f.cuda_expr, g.cuda_expr, n_params))
    fn = lib.tsde_srk_bf16x2_diffs
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tsde_srk_bf16x2_native.argtypes = [ctypes.c_int]
    lib.tsde_srk_bf16x2_native.restype = ctypes.c_int
    counts = torch.zeros(8, dtype=torch.int64, device=device)
    rc = fn(counts.data_ptr(), device.index or 0,
            torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(lib, rc, "bf16x2 check")
    got = counts.view(4, 2).tolist()
    return {op: dict(instruction=None if op == "div" else c[0], operator=c[1],
                     native=bool(lib.tsde_srk_bf16x2_native(i)))
            for i, (op, c) in enumerate(zip(BF16X2_OPS, got))}


def srk_solve_fused(f, g, y0, t0, dt, n_steps, W, U, params=()):
    """Solve ``n_steps`` srid2 steps of a diagonal-noise SDE with elementwise
    ``f`` and ``g`` (``(t, y, *params) -> (B, D)``; on the card
    :class:`Elementwise` values with a ``cuda_expr``) from ``y0`` (B, D) at
    ``t0``, on the grid ``t0 + s * dt``, with increments ``W`` and Lévy
    integrals ``U`` (n_steps, B, D) and per-dimension parameter rows
    ``params`` (each (D,)). The kernel for CUDA tensors, the plain version
    for CPU tensors, no fallback between them. Returns the final state."""
    if y0.device.type == "cpu":
        return srk_solve_plain(f, g, y0, t0, dt, n_steps, W, U, params)
    if y0.is_cuda:
        return srk_solve_cuda(f, g, y0, t0, dt, n_steps, W, U, params)
    raise ValueError(f"no SRK solve for device {y0.device}")
