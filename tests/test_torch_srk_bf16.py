"""The port's bfloat16 solves against torchsde_tpu, bit for bit.

JAX rounds a Python scalar to the dtype of the array it meets (a weak
type); PyTorch keeps it at float32 in a bfloat16 operation. The tableau of
srid2 and sra1 holds constants that bfloat16 cannot hold (1/3, 2/3, 1/6),
so the port rounds each one as JAX does (``utils.misc.weak_scalar``). Here
every fixed-step ``sdeint`` method, on every noise type it takes, and the
whole-solve SRK (kernel 15's plain version) run in bfloat16 on the same
injected tables, made with numpy from a seed and rounded to bfloat16 once,
through both packages; the drifts and diffusions use only constants that
bfloat16 holds, so the solvers' own roundings are what is compared. The
bf16 kernel itself is held to the plain version on the card
(chip_smoke.py, tests/test_torch_gpu.py); here its entry in the generated
source is checked without nvcc."""

from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torchsde_tpu as jtsde
import torchsde_tpu_torch as ttsde
from torchsde_tpu.brownian import base as jbase
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.core import solvers as JS
from torchsde_tpu.ops import srk_fused as JSF
from torchsde_tpu_torch.ops import srk_fused as TSF
from torchsde_tpu_torch.utils.misc import weak_scalar

BF16 = torch.bfloat16
B, D, M = 5, 3, 2
TS_OUT = np.linspace(0.0, 0.5, 5)
DT = 0.05
GRID = JI.build_step_grid(TS_OUT[0], TS_OUT[-1], DT)
NOISES = ("diagonal", "scalar", "additive", "general")
# Every fixed-step method with its calculus and options; each runs on
# every noise type its JAX solver takes.
METHODS = [("euler", "ito", None), ("srk", "ito", None),
           ("milstein", "ito", None), ("milstein", "ito", {"grad_free": True}),
           ("milstein", "stratonovich", None),
           ("milstein", "stratonovich", {"grad_free": True}),
           ("midpoint", "stratonovich", None), ("heun", "stratonovich", None),
           ("euler_heun", "stratonovich", None),
           ("reversible_heun", "stratonovich", None),
           ("log_ode", "stratonovich", None)]
CASES = [(m, st, n, o) for m, st, o in METHODS for n in NOISES
         if n in JS.select(m, st).noise_types
         and not (o and n == "additive")]
IDS = [f"{m}-{st}-{n}{'-gf' if o else ''}" for m, st, n, o in CASES]
# The one case that is not bitwise: log-ODE on general noise differentiates
# g = tanh(theta y) G + G0 (its Lévy-area term is a Jacobian-vector
# product). PyTorch's autograd computes tanh's derivative in one kernel,
# grad (1 - tanh^2) in float32 rounded once; JAX's jvp rounds each of its
# operations to bfloat16. Measured 5 of 75 outputs apart, by at most 2
# bfloat16 ulps; with sin in place of tanh (a derivative of one operation
# in both) the case is bitwise. So each output within 2 ulps of JAX's.
ULPS = {("log_ode", "general"): 2}


def bf16(a):
    """A numpy array rounded to bfloat16 (ml_dtypes, JAX's type)."""
    return np.asarray(a).astype(ml_dtypes.bfloat16)


def to_jax(a):
    return jnp.asarray(bf16(a))


def to_torch(a):
    return torch.from_numpy(bf16(a).astype(np.float32)).to(BF16)


def _m(noise):
    return {"general": M, "additive": M, "scalar": 1}.get(noise, D)


def _params():
    rng = np.random.default_rng(0)
    return dict(theta=rng.uniform(0.5, 1.5, D), G=rng.normal(size=(D, M)),
                G0=rng.normal(size=(D, M)))


def make_sde(pkg, sde_type, noise, conv=None):
    """One test SDE for both packages (``pkg`` jtsde or ttsde), its
    constants exact in bfloat16, its parameters bfloat16 (or made by
    ``conv``)."""
    p = _params()
    lib = jnp if pkg is jtsde else torch
    conv = conv or (to_jax if pkg is jtsde else to_torch)

    class SDE(pkg.BaseSDE):
        def __init__(self):
            super().__init__(noise_type=noise, sde_type=sde_type)
            self.theta = conv(p["theta"])
            self.G = conv(p["G"])
            self.G0 = conv(p["G0"])

        def f(self, t, y):
            return -self.theta * y + lib.sin(t) * lib.cos(y)

        def g(self, t, y):
            if noise == "diagonal":
                return 0.625 + 0.25 * lib.sin(self.theta * y)
            if noise == "scalar":
                return (0.625 + 0.25 * lib.sin(self.theta * y))[..., None]
            if noise == "additive":
                return self.G0 * (1.0 + 0.0 * y[..., None]) * lib.cos(t)
            return lib.tanh(self.theta * y)[..., None] * self.G + self.G0

    return SDE()


def _tables(noise, seed=1):
    """W, U (space-time Lévy integral) and an antisymmetric A on GRID."""
    rng = np.random.default_rng(seed)
    n, m = len(GRID) - 1, _m(noise)
    dts = np.diff(GRID)[:, None, None]
    W = rng.normal(size=(n, B, m)) * np.sqrt(dts)
    U = dts * (0.5 * W + rng.normal(size=W.shape) * np.sqrt(dts / 12))
    a = rng.normal(size=(n, B, m, m)) * dts[..., None] / 3
    return W, U, a - np.swapaxes(a, -1, -2)


class JaxTable(jbase.BaseBrownian):
    """Serves fixed W, U and A tables on ``grid`` (Foster's area)."""
    conv = staticmethod(to_jax)

    def __init__(self, W, U, A, grid=GRID):
        self._W, self._U, self._A = map(self.conv, (W, U, A))
        self._grid = grid

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        raise NotImplementedError

    def query_grid(self, grid, return_U=False, return_A=False):
        assert np.array_equal(grid, self._grid)
        return (self._W, self._U if return_U else None,
                self._A if return_A else None)

    shape = property(lambda self: tuple(self._W.shape[1:]))
    dtype = property(lambda self: self._W.dtype)
    levy_area_approximation = property(lambda self: "foster")


class TorchTable(ttsde.BaseBrownian):
    """The same tables for the port."""
    conv = staticmethod(to_torch)
    __init__ = JaxTable.__init__
    __call__ = JaxTable.__call__
    query_grid = JaxTable.query_grid
    shape = JaxTable.shape
    dtype = JaxTable.dtype
    levy_area_approximation = JaxTable.levy_area_approximation


def _bitwise(got, want, ulps=0):
    """``got`` bf16 and bitwise ``want`` (or within ``ulps`` bfloat16 ulps
    of it, element by element)."""
    assert got.dtype == BF16
    want = np.asarray(want).astype(np.float32)
    assert tuple(got.shape) == want.shape
    got = got.detach().float().numpy()
    if not ulps:
        np.testing.assert_array_equal(got, want)
        return
    ulp = np.spacing(np.abs(want).astype(ml_dtypes.bfloat16)).astype(
        np.float32)
    assert (np.abs(got - want) <= ulps * ulp).all()


@pytest.mark.parametrize("method,sde_type,noise,options", CASES, ids=IDS)
def test_sdeint_bf16_matches_jax_bitwise(method, sde_type, noise, options):
    """sdeint in bfloat16 on the same tables: every output bitwise the JAX
    package's (log_ode reads the A table)."""
    y0 = np.random.default_rng(2).normal(size=(B, D))
    tables = _tables(noise)
    want = jtsde.sdeint(make_sde(jtsde, sde_type, noise), to_jax(y0), TS_OUT,
                        bm=JaxTable(*tables), method=method, dt=DT,
                        options=options)
    got = ttsde.sdeint(make_sde(ttsde, sde_type, noise), to_torch(y0),
                       TS_OUT, bm=TorchTable(*tables), method=method, dt=DT,
                       options=options)
    _bitwise(got, want, ULPS.get((method, noise), 0))


def test_every_fixed_step_method_is_covered():
    assert {m for m, _, _, _ in CASES} == set(ttsde.METHODS) - {
        "adjoint_reversible_heun"}
    assert {n for _, _, n, _ in CASES} == set(NOISES)


# The whole-solve SRK: kernel 15's plain version.

SB, SD = 64, 8                  # tests/test_torch_srk.py's problem
# 0.1 as bfloat16 rounds it, so the drift's constant is the same bits in
# both packages (a bare 0.1 stays float32 in a PyTorch bf16 product).
TENTH = float(torch.tensor(0.1).to(BF16))


def _fused_problem(n, seed=5):
    rng = np.random.default_rng(seed)
    sigma = 1 / (1 + np.exp(-rng.standard_normal(SD)))
    mu = -sigma ** 2 - 1 / (1 + np.exp(-rng.standard_normal(SD)))
    dt = 1.0 / n
    W = rng.standard_normal((n, SB, SD)) * np.sqrt(dt)
    U = dt * (0.5 * W + rng.standard_normal(W.shape) * np.sqrt(dt / 12))
    y0 = rng.uniform(0.05, 0.2, (SB, SD))
    return y0, W, U, (mu, sigma), dt


def _jf(t, y, mu, sigma):
    return mu * y + 0.1 * jnp.sin(t) * y


def _jg(t, y, mu, sigma):
    return sigma * y


F = TSF.Elementwise(lambda t, y, mu, sigma: mu * y + TENTH * torch.sin(t) * y,
                    "p0 * y + T(0.1) * sin(t) * y")
G = TSF.Elementwise(lambda t, y, mu, sigma: sigma * y, "p1 * y")


@pytest.mark.parametrize("n", [16, 300])
def test_srk_solve_plain_bf16_matches_jax_bitwise(n):
    """srk_solve_plain in bfloat16 against the JAX package's srk_solve_xla
    and its Pallas kernel in interpret mode, with a drift that reads t: bit
    for bit at 16 steps and at 300, where a bfloat16 step index would be
    wrong (the times are formed in float32)."""
    y0, W, U, params, dt = _fused_problem(n)
    j_args = (to_jax(y0), 0.25, dt, n, to_jax(W), to_jax(U))
    j_params = tuple(map(to_jax, params))
    got = TSF.srk_solve_plain(F, G, to_torch(y0), 0.25, dt, n, to_torch(W),
                              to_torch(U), tuple(map(to_torch, params)))
    _bitwise(got, JSF.srk_solve_xla(_jf, _jg, *j_args, params=j_params))
    _bitwise(got, JSF.srk_solve_fused(_jf, _jg, *j_args, params=j_params,
                                      interpret=True))


def _sdeint_srk(pkg, conv, y0, W, U, params, dt):
    """sdeint(method='srk') of f = mu y, g = sigma y over [0, 1] at ``dt``
    on the tables W and U."""
    mu, sigma = params

    class Sde(pkg.SDEIto):
        def __init__(self):
            super().__init__(noise_type="diagonal")
            self.mu, self.sigma = conv(mu), conv(sigma)

        def f(self, t, y):
            return self.mu * y

        def g(self, t, y):
            return self.sigma * y

    table = (JaxTable if pkg is jtsde else TorchTable)(
        W, U, W, grid=JI.build_step_grid(0.0, 1.0, dt))
    return pkg.sdeint(Sde(), conv(y0), [0.0, 1.0], bm=table, method="srk",
                      dt=dt)[-1]


def test_srk_solve_plain_bf16_and_sdeint_srk_as_jax():
    """The whole solve and sdeint(method='srk') in bfloat16 on the same
    tables. sdeint's step times are bf16 grid points and its dt their bf16
    difference; the whole solve forms t0 + s dt in float32 and rounds the
    Python dt: the two round differently, in the JAX package as in the
    port. Each is bitwise its JAX counterpart, so the port's gap between
    them is JAX's."""
    n = 16
    y0, W, U, params, dt = _fused_problem(n)
    f = TSF.Elementwise(lambda t, y, mu, sigma: mu * y, "p0 * y")
    plain = TSF.srk_solve_plain(f, G, to_torch(y0), 0.0, dt, n, to_torch(W),
                                to_torch(U), tuple(map(to_torch, params)))
    xla = JSF.srk_solve_xla(lambda t, y, mu, sigma: mu * y, _jg, to_jax(y0),
                            0.0, dt, n, to_jax(W), to_jax(U),
                            params=tuple(map(to_jax, params)))
    _bitwise(plain, xla)
    port = _sdeint_srk(ttsde, to_torch, y0, W, U, params, dt)
    jax_ = _sdeint_srk(jtsde, to_jax, y0, W, U, params, dt)
    _bitwise(port, jax_)
    jax_gap = np.abs(np.asarray(jax_).astype(np.float64)
                     - np.asarray(xla).astype(np.float64)).max()
    assert float((port.double() - plain.double()).abs().max()) == jax_gap


def test_weak_scalar_rounds_as_jax():
    """The scalar as JAX's weak type rounds it: bfloat16 through float32
    (a tie after float32 goes to even), float16 directly; float32 and
    float64 leave it as it is."""
    for x in (0.1, 1.0 / 3.0, 1 + 2 ** -8 + 2 ** -30, -2.0 / 3.0,
              1 + 2 ** -11 + 2 ** -40):
        for dtype, jdtype in ((BF16, jnp.bfloat16),
                              (torch.float16, jnp.float16)):
            want = float((jnp.ones((), jdtype) * x).astype(jnp.float64))
            assert weak_scalar(x, dtype) == want, (x, dtype)
        assert weak_scalar(x, torch.float32) == x
        assert weak_scalar(x, torch.float64) == x
    assert weak_scalar(1 + 2 ** -8 + 2 ** -30, BF16) == 1.0
    assert weak_scalar(1 + 2 ** -11 + 2 ** -40, torch.float16) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rounding_leaves_float32_and_float64_as_they_were(dtype,
                                                          monkeypatch):
    """Above bfloat16 the rounding is PyTorch's own: the whole solve and
    sdeint(method='srk') (srid2 and sra1) give the same bits with
    weak_scalar replaced by the identity."""
    from torchsde_tpu_torch.core import solvers as TS

    def conv(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    class Table(TorchTable):
        pass

    Table.conv = staticmethod(conv)
    n = 16
    y0, W, U, params, dt = _fused_problem(n)

    def run():
        outs = [TSF.srk_solve_plain(F, G, conv(y0), 0.25, dt, n, conv(W),
                                    conv(U), tuple(map(conv, params)))]
        for noise in ("diagonal", "additive"):
            yn = np.random.default_rng(2).normal(size=(B, D))
            outs.append(ttsde.sdeint(
                make_sde(ttsde, "ito", noise, conv), conv(yn), TS_OUT,
                bm=Table(*_tables(noise)), method="srk", dt=DT))
        return outs

    want = run()
    for mod in (TSF, TS):
        monkeypatch.setattr(mod, "weak_scalar", lambda x, dtype: x)
    for a, b in zip(run(), want):
        assert a.dtype == dtype and torch.equal(a, b)


def test_bf16_entry_in_the_generated_source():
    """The bf16 solve is an entry point of every generated source, and the
    wrapper takes it for bf16 states; float16 has none."""
    assert TSF._ENTRY[BF16] == "tsde_srk_srid2_bf16"
    assert torch.float16 not in TSF._ENTRY
    header = (Path(TSF.__file__).parent / "csrc" / "srk_srid2.cuh"
              ).read_text()
    macro = header[header.index("#define TSDE_SRID2_ENTRY_POINTS"):]
    for name in TSF._ENTRY.values():
        assert f'extern "C" int {name}(' in macro
    assert "launch<tsde_srk::Bf16," in macro


# The bf16 arithmetic of csrc/srk_srid2.cuh, compiled for the host: the
# header and a generated source built by the host C++ compiler against
# stand-ins for the CUDA headers (the launch syntax removed, one pair of
# elements a call), so the kernel's Bf16x2 operators, step times and
# constants are held to the plain version bit for bit without nvcc. The
# stand-in bf16x2 instructions round the exact result once (in double: a
# product of two bf16 values is exact there, a sum loses no bit that
# reaches a bf16 rounding), as the PTX ISA defines add, sub and mul .rn
# .bf16x2; the card's are held to that over all operand pairs by
# chip_smoke.py.

CUDA_STUB = """#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0 };
struct tsde_dim { unsigned x; };
static tsde_dim blockIdx, blockDim, threadIdx;
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaMemsetAsync(void*, int, size_t, cudaStream_t) {
  return 0;
}
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return *p += v;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
"""

BF16_STUB = """#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  u = (u & 0x7fffffffu) > 0x7f800000u ? (u | 0x00400000u)
                                       : u + 0x7fffu + ((u >> 16) & 1u);
  __nv_bfloat16 b;
  b.x = (unsigned short)(u >> 16);
  return b;
}
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return __nv_bfloat162{__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
// The exact result (a double) rounded once to bf16, to nearest even.
inline __nv_bfloat16 tsde_round_once(double x) {
  __nv_bfloat16 b;
  if (x != x) {
    b.x = 0x7fc0;
    return b;
  }
  if (x != 0.0 && !isinf(x)) {
    int e;
    frexp(x, &e);
    const double q = ldexp(1.0, (e > -125 ? e : -125) - 8);
    x = nearbyint(x / q) * q;
    if (fabs(x) >= ldexp(1.0, 128)) x = x > 0 ? INFINITY : -INFINITY;
  }
  const float f = (float)x;          // exact: x is a bf16 value
  uint32_t u;
  memcpy(&u, &f, 4);
  b.x = (unsigned short)(u >> 16);
  return b;
}
inline __nv_bfloat162 tsde_pairwise(__nv_bfloat162 a, __nv_bfloat162 b,
                                    int op) {
  const __nv_bfloat16 in[2][2] = {{a.x, b.x}, {a.y, b.y}};
  __nv_bfloat16 out[2];
  for (int i = 0; i < 2; ++i) {
    const double p = __bfloat162float(in[i][0]), q = __bfloat162float(in[i][1]);
    out[i] = tsde_round_once(op == 0 ? p + q : op == 1 ? p - q : p * q);
  }
  return __nv_bfloat162{out[0], out[1]};
}
inline __nv_bfloat162 __hadd2_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return tsde_pairwise(a, b, 0);
}
inline __nv_bfloat162 __hsub2_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return tsde_pairwise(a, b, 1);
}
inline __nv_bfloat162 __hmul2_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return tsde_pairwise(a, b, 2);
}
"""

HOST_DRIVER = """
extern "C" void run_bf16(const __nv_bfloat16* y0, const __nv_bfloat16* W,
                         const __nv_bfloat16* U, const __nv_bfloat16* prm,
                         __nv_bfloat16* out, long long BD, int D, int n,
                         double t0, double dt) {
  const bool vec = BD % 2 == 0 && tsde_srk::aligned4(y0) &&
                   tsde_srk::aligned4(W) && tsde_srk::aligned4(U) &&
                   tsde_srk::aligned4(out);
  blockDim.x = 1;
  threadIdx.x = 0;
  for (long long q = 0; 2 * q < BD; ++q) {
    blockIdx.x = (unsigned)q;
    tsde_srk::srid2_kernel_bf16x2<Drift, Diffusion, 2>(
        y0, W, U, prm, out, BD, D, n, t0, dt, vec);
  }
}
"""


@pytest.fixture(scope="module")
def host_srid2(tmp_path_factory):
    """The bf16 solve of F and G, built for the host; skipped where there
    is no host C++ compiler."""
    import ctypes
    import re
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_srid2")
    header = (Path(TSF.__file__).parent / "csrc" / "srk_srid2.cuh"
              ).read_text()
    (d / "srk_srid2.cuh").write_text(re.sub(r"<<<.*?>>>", "", header,
                                            flags=re.S))
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    (d / "cuda_bf16.h").write_text(BF16_STUB)
    src = TSF.srk_source(F.cuda_expr, G.cuda_expr, 2).replace(
        "}  // namespace\n", "}  // namespace\n" + HOST_DRIVER)
    (d / "solve.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-ffp-contract=off", f"-I{d}", "-o", str(d / "solve.so"),
                    str(d / "solve.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "solve.so"))
    P = ctypes.c_void_p
    lib.run_bf16.argtypes = [P] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_double,
                                       ctypes.c_double]
    return lib


@pytest.mark.parametrize("n,B,t0", [(16, SB, 0.25), (300, SB, 0.25),
                                    (9, 37, 0.3)])
def test_kernel_bf16_arithmetic_on_the_host_matches_plain(host_srid2, n, B,
                                                          t0):
    """The kernel's bf16 solve, compiled for the host, against the bf16
    plain version: bit for bit, with f reading sin(t) and its T(0.1)."""
    y0, W, U, params, dt = _fused_problem(n)
    y0, W, U = to_torch(y0[:B]), to_torch(W[:, :B]).contiguous(), \
        to_torch(U[:, :B]).contiguous()
    prm = torch.stack([to_torch(p) for p in params])
    out = torch.empty_like(y0)
    host_srid2.run_bf16(y0.data_ptr(), W.data_ptr(), U.data_ptr(),
                        prm.data_ptr(), out.data_ptr(), y0.numel(), SD, n,
                        t0, dt)
    want = TSF.srk_solve_plain(F, G, y0, t0, dt, n, W, U, (prm[0], prm[1]))
    assert torch.equal(out, want)


@pytest.mark.parametrize("B,D", [(37, 7), (5, 3), (1, 1)])
def test_kernel_bf16_pairs_straddling_rows_on_the_host(host_srid2, B, D):
    """Pairs across two rows (an odd D), an odd B D (the last thread's
    lone element) and unaligned pairs: the host build of the bf16 solve
    against the plain version, bit for bit."""
    y0, W, U, params, dt = _fused_problem(12)
    y0 = to_torch(y0[:B, :D]).contiguous()
    W, U = (to_torch(a[:, :B, :D]).contiguous() for a in (W, U))
    prm = torch.stack([to_torch(p[:D]) for p in params])
    out = torch.empty_like(y0)
    host_srid2.run_bf16(y0.data_ptr(), W.data_ptr(), U.data_ptr(),
                        prm.data_ptr(), out.data_ptr(), y0.numel(), D, 12,
                        0.25, dt)
    want = TSF.srk_solve_plain(F, G, y0, 0.25, dt, 12, W, U,
                               (prm[0], prm[1]))
    assert torch.equal(out, want)


def _round_bf16_once(x):
    """float64 values rounded once to bf16 (to nearest even, subnormals
    and overflow as bf16 has them), as float64."""
    x = np.asarray(x, np.float64)
    out = x.copy()
    fin = np.isfinite(x) & (x != 0)
    _, e = np.frexp(x[fin])
    q = np.ldexp(1.0, np.maximum(e, -125) - 8)
    r = np.rint(x[fin] / q) * q
    r[np.abs(r) >= 2.0 ** 128] = np.inf * np.sign(r[np.abs(r) >= 2.0 ** 128])
    out[fin] = r
    return out


def _round_bf16_twice(x):
    """float64 values rounded to float32, then to bf16 (the kernel's Bf16
    and the JAX package's bf16 operations), as float64."""
    with np.errstate(over="ignore"):
        f = np.asarray(x, np.float64).astype(np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7fff + ((u >> 16) & 1)) & 0xffff0000).astype(np.uint32)
    out = r.view(np.float32).astype(np.float64)
    nan = np.isnan(f)
    out[nan] = np.nan
    return out


def _same(a, b):
    return (a == b) & (np.signbit(a) == np.signbit(b)) \
        | (np.isnan(a) & np.isnan(b))


def _bf16_values(bits):
    with np.errstate(invalid="ignore"):
        return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(
            np.float64)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_bf16_single_rounding_matches_float32_then_bf16(op):
    """The claim behind bf16 kernel 15's bf16x2 instructions: rounding the
    exact sum, difference or product of two bf16 values once to bf16 gives
    the bits of float32 rounded to bf16, over 4M seeded random bit
    patterns (NaN and infinity among them) and the edge classes: subnormal
    and underflowing products, sums that cancel to a few ulps, sums with
    exponent gaps of 16 to 40, overflow. The exact result is float64's (a
    product of two 8-bit significands is exact there, and so is a sum
    across a gap of at most 44; past that, float64's 53 bits round
    innocuously for a target of 8)."""
    rng = np.random.default_rng(25)
    n = 1 << 22
    a = _bf16_values(rng.integers(0, 1 << 16, n))
    b = _bf16_values(rng.integers(0, 1 << 16, n))
    m = rng.integers(128, 256, (8, n // 8)).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], (8, n // 8))
    ea = rng.integers(-140, -60, n // 8)
    classes = [
        # products near and below the smallest subnormal (2^-133)
        (sign[0] * m[0] * np.ldexp(1.0, ea - 7),
         m[1] * np.ldexp(1.0, -140 - ea + rng.integers(-12, 12, n // 8))),
        # cancellation: b a few ulps from -a (+ and -: its negation)
        (sign[1] * m[2] * np.ldexp(1.0, rng.integers(-130, 120, n // 8)),
         None),
        # exponent gaps of 16 to 40
        (sign[2] * m[3] * np.ldexp(1.0, rng.integers(-60, 60, n // 8)),
         sign[3] * m[4]),
        # overflow: products and sums near bf16's largest value
        (sign[4] * m[5] * np.ldexp(1.0, rng.integers(110, 121, n // 8)),
         sign[5] * m[6] * np.ldexp(1.0, rng.integers(0, 14, n // 8))),
    ]
    xs, ys = [a], [b]
    for i, (x, y) in enumerate(classes):
        x = _round_bf16_once(x)
        if i == 1:
            ulp = np.ldexp(1.0, np.frexp(x)[1] - 8)
            y = -x + rng.integers(-4, 5, x.shape) * ulp
        elif i == 2:
            gap = rng.integers(16, 41, x.shape)
            y = y * np.ldexp(1.0, np.frexp(x)[1] - 8 - gap)
        elif i == 3:
            y = np.where(rng.random(x.shape) < 0.5, y,
                         sign[6] * np.ldexp(m[7], 120))
        xs.append(x)
        ys.append(_round_bf16_once(y))
    x, y = np.concatenate(xs), np.concatenate(ys)
    assert np.array_equal(_round_bf16_once(x), x, equal_nan=True)
    assert np.array_equal(_round_bf16_once(y), y, equal_nan=True)
    with np.errstate(invalid="ignore", over="ignore"):
        exact = x + y if op == "add" else x - y if op == "sub" else x * y
    once, twice = _round_bf16_once(exact), _round_bf16_twice(exact)
    assert _same(once, twice).all()
    # The edge classes reached what they were drawn for.
    tiny = np.abs(once[n:n + n // 8])
    assert op != "mul" or ((tiny > 0) & (tiny < 2.0 ** -126)).sum() > 1000
    assert op != "mul" or (np.isinf(once[-(n // 8):]).sum() > 1000)


def test_chip_sdeint_bar_is_twice_jax_own_gap():
    """chip_smoke.SRK_BF16_SDEINT_REL, the bar on bf16 kernel 15 against
    bf16 sdeint(method='srk') at (1024, 8) over 128 steps, is twice the
    largest gap between the JAX package's own srk_solve_xla and sdeint
    there, over six numpy seeds of the chip phase's law (its mu and sigma,
    y0 = 0.1): measured 0.0197-0.0646 of scale, about 10 % of elements
    differing."""
    import chip_smoke as CS
    B, d = CS.SRK_CONFIGS[0]
    n = CS.SRK_STEPS
    dt = 1.0 / n
    rng = np.random.default_rng(CS.SEED + 300 + d)
    sigma = 1 / (1 + np.exp(-rng.standard_normal(d)))
    mu = -sigma ** 2 - 1 / (1 + np.exp(-rng.standard_normal(d)))
    y0 = np.full((B, d), 0.1)
    gaps = []
    for seed in range(100, 106):
        r = np.random.default_rng(seed)
        W = r.standard_normal((n, B, d)) * np.sqrt(dt)
        U = dt * (0.5 * W + r.standard_normal(W.shape) * np.sqrt(dt / 12))
        xla = np.asarray(JSF.srk_solve_xla(
            lambda t, y, m, s: m * y, _jg, to_jax(y0), 0.0, dt, n,
            to_jax(W), to_jax(U), params=(to_jax(mu), to_jax(sigma))))
        ys = np.asarray(_sdeint_srk(jtsde, to_jax, y0, W, U, (mu, sigma),
                                    dt))
        xla, ys = xla.astype(np.float64), ys.astype(np.float64)
        gaps.append(np.abs(xla - ys).max() / np.abs(xla).max())
    assert 0.01 < max(gaps) and 2 * max(gaps) <= CS.SRK_BF16_SDEINT_REL
