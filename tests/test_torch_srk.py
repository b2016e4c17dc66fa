"""The port's srid2/sra1 SRK solver and whole-solve SRK (kernel 15's plain
version) against torchsde_tpu.

Whole solves are compared through injected Brownian tables: the same
increments W and space-time Lévy integrals U, made with numpy from a seed,
drive both packages. The CUDA kernel itself is held against the plain
version on the card (chip_smoke.py, tests/test_torch_gpu.py); here its
generated source and the build's guards are checked without nvcc."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsde_tpu as jtsde
import torchsde_tpu_torch as ttsde
from problems import ExAdditive, ExDiagonal, ExScalar
from torchsde_tpu.brownian import base as jbase
from torchsde_tpu.core import integrate as JI
from torchsde_tpu.core import solvers as JS
from torchsde_tpu.core import tableaus as JT
from torchsde_tpu.ops import srk_fused as JSF
from torchsde_tpu_torch.core import integrate as TI
from torchsde_tpu_torch.core import solvers as TS
from torchsde_tpu_torch.core import tableaus as TT
from torchsde_tpu_torch.ops import _build
from torchsde_tpu_torch.ops import srk_fused as TSF

B, D, M = 6, 3, 2
TS_OUT = np.linspace(0.0, 0.6, 4)
DT = 0.05
GRID = JI.build_step_grid(TS_OUT[0], TS_OUT[-1], DT)


def _noise(m, seed=1):
    """W and U on GRID with the law of sample_grid_noise, from numpy."""
    rng = np.random.default_rng(seed)
    dts = np.diff(GRID)[:, None, None]
    W = rng.standard_normal((len(GRID) - 1, B, m)) * np.sqrt(dts)
    H = rng.standard_normal(W.shape) * np.sqrt(dts / 12.0)
    return W, dts * (0.5 * W + H)


class JaxTable(jbase.BaseBrownian):
    """Serves fixed W and U tables on GRID (space-time Lévy area)."""

    def __init__(self, W, U):
        self._W, self._U = jnp.asarray(W), jnp.asarray(U)

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        raise NotImplementedError

    def query_grid(self, grid, return_U=False, return_A=False):
        assert np.array_equal(grid, GRID)
        return self._W, self._U if return_U else None, None

    @property
    def shape(self):
        return tuple(self._W.shape[1:])

    @property
    def dtype(self):
        return self._W.dtype

    @property
    def levy_area_approximation(self):
        return "space-time"


class TorchTable(ttsde.BaseBrownian):
    def __init__(self, W, U, levy="space-time"):
        self._W, self._U = torch.as_tensor(W), torch.as_tensor(U)
        self._levy = levy

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        raise NotImplementedError

    def query_grid(self, grid, return_U=False, return_A=False):
        assert np.array_equal(grid, GRID)
        return self._W, self._U if return_U else None, None

    @property
    def shape(self):
        return tuple(self._W.shape[1:])

    @property
    def dtype(self):
        return self._W.dtype

    @property
    def levy_area_approximation(self):
        return self._levy


class TorchExDiagonal(ttsde.SDEIto):
    def __init__(self, j):
        super().__init__(noise_type="diagonal")
        self.mu = torch.as_tensor(np.array(j.mu))
        self.sigma = torch.as_tensor(np.array(j.sigma))

    def f(self, t, y):
        return self.mu * y

    def g(self, t, y):
        return self.sigma * y


class TorchExScalar(ttsde.SDEIto):
    def __init__(self, j):
        super().__init__(noise_type="scalar")
        self.p = torch.as_tensor(np.array(j.p))

    def f(self, t, y):
        return -self.p ** 2.0 * torch.sin(y) * torch.cos(y) ** 3.0

    def g(self, t, y):
        return (self.p * torch.cos(y) ** 2)[..., None]


class TorchExAdditive(ttsde.SDEIto):
    def __init__(self, j):
        super().__init__(noise_type="additive")
        self.m = j.m
        self.a = torch.as_tensor(np.array(j.a))
        self.b = torch.as_tensor(np.array(j.b))

    def f(self, t, y):
        return self.b / torch.sqrt(1.0 + t) - y / (2.0 + 2.0 * t)

    def g(self, t, y):
        fill = self.a * self.b / torch.sqrt(1.0 + t)
        return fill[None, :, None].expand(y.shape[0], fill.shape[0], self.m)


PROBLEMS = {"diagonal": (lambda: ExDiagonal(D), TorchExDiagonal, D),
            "scalar": (lambda: ExScalar(D), TorchExScalar, 1),
            "additive": (lambda: ExAdditive(D, M), TorchExAdditive, M)}


@pytest.mark.parametrize("name", ["SRA1", "SRA2", "SRA3", "SRID1", "SRID2"])
def test_tableaus_equal_jax(name):
    want, got = getattr(JT, name), getattr(TT, name)
    fields = [k for k in vars(want) if not k.startswith("_")]
    assert fields and fields == [k for k in vars(got)
                                 if not k.startswith("_")]
    for k in fields:
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("noise", ["diagonal", "scalar", "additive"])
def test_sdeint_srk_matches_jax_f64(noise):
    """sdeint(method='srk'): srid2 for diagonal and scalar noise, sra1 for
    additive, on the same injected W and U: 1e-9 in float64."""
    make_jax, make_torch, m = PROBLEMS[noise]
    jsde = make_jax()
    W, U = _noise(m)
    y0 = np.random.default_rng(2).uniform(0.2, 0.9, (B, D))
    want = jtsde.sdeint(jsde, jnp.asarray(y0), TS_OUT, bm=JaxTable(W, U),
                        method="srk", dt=DT)
    got = ttsde.sdeint(make_torch(jsde), torch.as_tensor(y0), TS_OUT,
                       bm=TorchTable(W, U), method="srk", dt=DT)
    assert got.shape == (len(TS_OUT), B, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9)


def test_default_method_is_srk_for_ito_diagonal():
    """With no method an Itô diagonal sdeint picks srk (check_contract), and
    the default noise now carries U: the call runs, and equals an explicit
    method='srk' on the same generator seed."""
    sde = TorchExDiagonal(ExDiagonal(D))
    y0 = torch.full((B, D), 0.5, dtype=torch.float64)
    a = ttsde.sdeint(sde, y0, TS_OUT, dt=DT,
                     generator=torch.Generator().manual_seed(3))
    b = ttsde.sdeint(sde, y0, TS_OUT, dt=DT, method="srk",
                     generator=torch.Generator().manual_seed(3))
    assert a.shape == (len(TS_OUT), B, D) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sample_grid_noise_U_from_the_generator_draws():
    """U = dt (W / 2 + H): W's normals are the generator's first draw and
    H ~ N(0, dt / 12) its second (JAX core/integrate.py:155-160)."""
    grid = JI.build_step_grid(0.0, 1.0, 0.3)             # last step short
    W, U, A = TI.sample_grid_noise(torch.Generator().manual_seed(4), grid,
                                   (B, M), torch.float64, needs_U=True)
    gen = torch.Generator().manual_seed(4)
    shape = (len(grid) - 1, B, M)
    z_w = torch.randn(shape, generator=gen, dtype=torch.float64)
    z_h = torch.randn(shape, generator=gen, dtype=torch.float64)
    dts = torch.as_tensor(np.diff(grid))[:, None, None]
    torch.testing.assert_close(W, z_w * dts.sqrt(), rtol=0, atol=0)
    torch.testing.assert_close(U, dts * (0.5 * W + z_h * torch.sqrt(dts / 12)),
                               rtol=0, atol=0)
    assert A is None
    # The A channel draws third: W and U stay these.
    W2, U2, A2 = TI.sample_grid_noise(torch.Generator().manual_seed(4), grid,
                                      (B, M), torch.float64, needs_U=True,
                                      needs_A=True)
    torch.testing.assert_close(W2, W, rtol=0, atol=0)
    torch.testing.assert_close(U2, U, rtol=0, atol=0)
    assert A2.shape == shape + (M,)


def test_srk_refuses_adjoint_sdes_with_jax_wording():
    class Adjoint:
        is_adjoint_sde = True
        noise_type, sde_type = "diagonal", "ito"

    with pytest.raises(ValueError) as jerr:
        JS.SRK(Adjoint())
    with pytest.raises(ValueError) as terr:
        TS.SRK(Adjoint())
    assert str(terr.value) == str(jerr.value)


def test_explicit_bm_without_space_time_area_is_refused():
    """srk needs U: an explicit Brownian motion without space-time Lévy
    area is refused, in the JAX package's words; the default noise gets
    it."""
    W, U = _noise(D)
    jsde = ExDiagonal(D)
    y0 = np.full((B, D), 0.5)

    class JaxNone(JaxTable):
        @property
        def levy_area_approximation(self):
            return "none"

    with pytest.raises(ValueError) as jerr:
        jtsde.sdeint(jsde, jnp.asarray(y0), TS_OUT, bm=JaxNone(W, U),
                     method="srk", dt=DT)
    with pytest.raises(ValueError) as terr:
        ttsde.sdeint(TorchExDiagonal(jsde), torch.as_tensor(y0), TS_OUT,
                     bm=TorchTable(W, U, levy="none"), method="srk", dt=DT)
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------------------- #
#  The whole-solve SRK: kernel 15's plain version and its generated source     #
# --------------------------------------------------------------------------- #

SB, SD, SN = 64, 8, 16     # benchmarks/srk_fused.py:88, its interpret-mode size


def _fused_problem(dtype, seed=5):
    rng = np.random.default_rng(seed)
    sigma = 1 / (1 + np.exp(-rng.standard_normal(SD)))
    mu = -sigma ** 2 - 1 / (1 + np.exp(-rng.standard_normal(SD)))
    dt = 1.0 / SN
    W = rng.standard_normal((SN, SB, SD)) * np.sqrt(dt)
    U = dt * (0.5 * W + rng.standard_normal(W.shape) * np.sqrt(dt / 12))
    y0 = rng.uniform(0.05, 0.2, (SB, SD))
    cast = lambda a: a.astype(dtype)     # noqa: E731
    return cast(y0), cast(W), cast(U), (cast(mu), cast(sigma)), dt


def _jf(t, y, mu, sigma):
    return mu * y + 0.1 * jnp.sin(t) * y


def _jg(t, y, mu, sigma):
    return sigma * y


F = TSF.Elementwise(lambda t, y, mu, sigma: mu * y + 0.1 * torch.sin(t) * y,
                    "p0 * y + T(0.1) * sin(t) * y")
G = TSF.Elementwise(lambda t, y, mu, sigma: sigma * y, "p1 * y")


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_srk_solve_plain_matches_jax(dtype, tol):
    """srk_solve_plain against the JAX package's srk_solve_xla and its
    Pallas kernel in interpret mode, with a drift that reads t (so the step
    and stage times count): 1e-12 of scale in float64; in float32 1e-6 of
    scale (PyTorch and XLA round the same operations, in orders that may
    differ by an FMA or a reassociation)."""
    y0, W, U, params, dt = _fused_problem(dtype)
    j_args = (jnp.asarray(y0), 0.25, dt, SN, jnp.asarray(W), jnp.asarray(U))
    xla = JSF.srk_solve_xla(_jf, _jg, *j_args,
                            params=tuple(map(jnp.asarray, params)))
    pallas = JSF.srk_solve_fused(_jf, _jg, *j_args,
                                 params=tuple(map(jnp.asarray, params)),
                                 interpret=True)
    got = TSF.srk_solve_plain(F, G, torch.as_tensor(y0), 0.25, dt, SN,
                              torch.as_tensor(W), torch.as_tensor(U),
                              tuple(map(torch.as_tensor, params)))
    assert got.dtype == torch.as_tensor(y0).dtype and got.shape == (SB, SD)
    scale = float(np.max(np.abs(np.asarray(xla))))
    for want in (xla, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol * scale)


def test_srk_solve_fused_takes_the_plain_version_on_the_cpu():
    y0, W, U, params, dt = _fused_problem(np.float32)
    args = (torch.as_tensor(y0), 0.0, dt, SN, torch.as_tensor(W),
            torch.as_tensor(U), tuple(map(torch.as_tensor, params)))
    before = TSF.launches
    got = TSF.srk_solve_fused(F, G, *args)
    torch.testing.assert_close(got, TSF.srk_solve_plain(F, G, *args),
                               rtol=0, atol=0)
    # A plain callable serves the CPU as well.
    plain = TSF.srk_solve_fused(F.torch_fn, G.torch_fn, *args)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)
    assert TSF.launches == before


def test_srk_solve_guards():
    y0, W, U, params, dt = _fused_problem(np.float32)
    args = [torch.as_tensor(y0), 0.0, dt, SN, torch.as_tensor(W),
            torch.as_tensor(U), tuple(map(torch.as_tensor, params))]
    # The card needs a C++ expression for f and g: no fallback to the plain
    # version.
    with pytest.raises(ValueError, match="cuda_expr"):
        TSF.srk_solve_cuda(TSF.Elementwise(F.torch_fn), G, *args)
    with pytest.raises(ValueError, match="cuda_expr"):
        TSF.srk_solve_cuda(F, G.torch_fn, *args)
    with pytest.raises(ValueError, match="CUDA state"):
        TSF.srk_solve_cuda(F, G, *args)
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError, match="no SRK solve"):
        TSF.srk_solve_fused(F, G, *meta)
    with pytest.raises(ValueError, match="C\\+\\+ expression"):
        TSF.Elementwise(F.torch_fn, "  ")


def test_generated_source_and_its_hash():
    """The .cu a CUDA solve compiles, and the library name built from its
    hash (text, the headers it includes, the flags), without nvcc."""
    text = TSF.srk_source("p0 * y", "p1 * y", 2)
    assert '#include "srk_srid2.cuh"' in text
    assert "struct Drift {" in text and "struct Diffusion {" in text
    assert "const T p0 = p[0];" in text and "const T p1 = p[1];" in text
    assert "return T(p0 * y);" in text and "return T(p1 * y);" in text
    assert text.rstrip().endswith(
        "TSDE_SRID2_ENTRY_POINTS(Drift, Diffusion, 2)")
    assert "p[0]" not in TSF.srk_source("-y", "0.5", 0)
    path = _build.source_library_path("tsde_srk_srid2", text)
    assert path == _build.source_library_path("tsde_srk_srid2",
                                              TSF.srk_source("p0 * y",
                                                             "p1 * y", 2))
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libtsde_srk_srid2_")
    assert path.name.endswith(".so")
    other = _build.source_library_path(
        "tsde_srk_srid2", TSF.srk_source("p0 * y", "p1 * y * y", 2))
    assert other != path


def test_source_hash_follows_the_flags(monkeypatch):
    text = TSF.srk_source("p0 * y", "p1 * y", 2)
    path = _build.source_library_path("tsde_srk_srid2", text)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.source_library_path("tsde_srk_srid2", text) != path


def test_generated_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_source_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library_for_source("tsde_srk_srid2",
                                  TSF.srk_source("p0 * y", "p1 * y", 2))
    assert not (tmp_path / "kernels").exists()


def test_srk_solve_plain_matches_sdeint_srk():
    """The whole-solve plain version and the port's sdeint(method='srk')
    are one method: on ExDiagonal with the same W and U they agree."""
    y0, W, U, params, dt = _fused_problem(np.float64)
    f = TSF.Elementwise(lambda t, y, mu, sigma: mu * y, "p0 * y")
    got = TSF.srk_solve_plain(f, G, torch.as_tensor(y0), 0.0, dt, SN,
                              torch.as_tensor(W), torch.as_tensor(U),
                              tuple(map(torch.as_tensor, params)))

    class Sde(ttsde.SDEIto):
        def __init__(self):
            super().__init__(noise_type="diagonal")

        def f(self, t, y):
            return torch.as_tensor(params[0]) * y

        def g(self, t, y):
            return torch.as_tensor(params[1]) * y

    grid = JI.build_step_grid(0.0, 1.0, dt)

    class Table(TorchTable):
        def query_grid(self, g, return_U=False, return_A=False):
            assert np.array_equal(g, grid)
            return self._W, self._U, None

    ys = ttsde.sdeint(Sde(), torch.as_tensor(y0), [0.0, 1.0],
                      bm=Table(W, U), method="srk", dt=dt)
    torch.testing.assert_close(ys[-1], got, rtol=1e-12, atol=1e-12)


def test_jax_pallas_normal_does_not_lower_on_the_cpu():
    """Why the port's Philox stream is held to the formula and not to the
    JAX kernel: the hardware PRNG has no CPU lowering."""
    from torchsde_tpu.ops.prng import pallas_normal
    with pytest.raises(Exception, match="prng_seed"):
        jax.block_until_ready(pallas_normal(1, (8, 128), jnp.float32, True))


def _fake_build(monkeypatch, tmp_path, fail):
    """Points the generated-source build at tmp_path with a stand-in for
    nvcc that records the source it was given (and its text at that
    moment) and writes the library, or fails; returns the records."""
    import types
    calls = []

    def run(args, **_):
        src, out = args[-1], args[args.index("-o") + 1]
        calls.append((src, open(src).read()))
        if fail:
            return types.SimpleNamespace(returncode=1, stdout="error: x\n")
        open(out, "wb").close()
        return types.SimpleNamespace(returncode=0, stdout="")

    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_source_libs", {})
    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.
                        SimpleNamespace(tsde_cuda_error_string=types.
                                        SimpleNamespace()))
    return calls


def test_generated_builds_write_sources_of_their_own(monkeypatch, tmp_path):
    """Two processes building one generated source give nvcc two source
    files, each named with its pid, and leave neither behind."""
    text = TSF.srk_source("p0 * y", "p1 * y", 2)
    calls = _fake_build(monkeypatch, tmp_path, fail=False)
    for pid in (101, 202):
        monkeypatch.setattr(_build.os, "getpid", lambda pid=pid: pid)
        monkeypatch.setattr(_build, "_source_libs", {})
        _build.library_for_source("tsde_srk_srid2", text)
        _build.source_library_path("tsde_srk_srid2", text).unlink()
    (src1, text1), (src2, text2) = calls
    assert src1 != src2 and ".101." in src1 and ".202." in src2
    assert text1 == text2 == text
    assert not list(tmp_path.glob("*.cu")) and not list(tmp_path.glob("*tmp"))


def test_failed_generated_build_leaves_no_source(monkeypatch, tmp_path):
    """A build that fails raises, removes its source and library files and
    keeps the source's text in build_log."""
    text = TSF.srk_source("p0 * y", "p1 * y * y", 2)
    calls = _fake_build(monkeypatch, tmp_path, fail=True)
    monkeypatch.setattr(_build, "build_log", "")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.library_for_source("tsde_srk_srid2", text)
    assert len(calls) == 1 and calls[0][1] == text
    assert not list(tmp_path.iterdir())
    assert text in _build.build_log and "error: x" in _build.build_log
