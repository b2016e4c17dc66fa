"""The port's Brownian classes against torchsde_tpu's.

Keys, ``split``, ``fold_in``, random bits, uniforms, branch bits and packed
words are held bitwise; normals, and the W, U and A computed from them, to
a tolerance: ``torch.erfinv`` is not XLA's ``erf_inv``. Float64 within
1e-10 * sqrt(span), float32 within 2e-5 * sqrt(span) (absolute; measured
here at most 3.6e-7 for W, U and A at span 1). Then the laws the JAX
package's tests check (tests/test_brownian_interval.py,
tests/test_brownian_derived.py), on the port, at small sizes."""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import kstest

import torchsde_tpu as jtsde
import torchsde_tpu_torch as ttsde
from torchsde_tpu_torch.brownian import interval as TI
from torchsde_tpu_torch.brownian import threefry as TF
from torchsde_tpu_torch.utils.convert import load_jax_key

F64_TOL = 1e-10
F32_TOL = 2e-5
ALPHA = 1e-5
LEVYS = ("none", "space-time", "davie", "foster")
DTYPES = {"float64": (jnp.float64, torch.float64, F64_TOL),
          "float32": (jnp.float32, torch.float32, F32_TOL)}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _returns(levy):
    return levy != "none", levy in ("davie", "foster")


def _pair(levy, dtype="float64", size=(6, 3), t0=0.0, t1=1.0, **kw):
    """The same interval in both packages."""
    jd, td, _ = DTYPES[dtype]
    kw = dict(t0=t0, t1=t1, size=size, entropy=123,
              levy_area_approximation=levy, **kw)
    return (jtsde.BrownianInterval(dtype=jd, **kw),
            ttsde.BrownianInterval(dtype=td, device="cpu", **kw))


def _bm(levy="none", size=(4, 3), dtype=torch.float64, **kw):
    kw.setdefault("entropy", 5)
    return ttsde.BrownianInterval(0.0, 1.0, size, dtype=dtype, device="cpu",
                                  levy_area_approximation=levy, **kw)


# --------------------------------------------------------------------------- #
#  Threefry                                                                   #
# --------------------------------------------------------------------------- #

SEEDS = [0, 1234, 2 ** 31 - 1, 2 ** 40 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    np.testing.assert_array_equal(TF.prng_key(seed).numpy(), want)


@pytest.mark.parametrize("num", [2, 3, 4])
def test_split_matches_jax(num):
    key = jax.random.PRNGKey(1234)
    want = np.asarray(jax.random.split(key, num)).astype(np.int64)
    np.testing.assert_array_equal(TF.split(TF.prng_key(1234), num).numpy(),
                                  want)


@pytest.mark.parametrize("data", [0, 1, 7, -1, 2 ** 31 - 1, -(2 ** 31)])
def test_fold_in_matches_jax(data):
    key = jax.random.PRNGKey(99)
    want = np.asarray(jax.random.fold_in(key, jnp.int32(data)))
    got = TF.fold_in(TF.prng_key(99), data)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a batch of keys folds each its own datum
    keys = TF.split(TF.prng_key(99), 3)
    batch = TF.fold_in(keys, torch.tensor([data, 1, 2]))
    np.testing.assert_array_equal(batch[0].numpy(),
                                  TF.fold_in(keys[0], data).numpy())


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("shape", [(3, 5), (7,), ()])
def test_random_bits_match_jax(bits, shape):
    key = jax.random.PRNGKey(1234)
    dt = jnp.uint32 if bits == 32 else jnp.uint64
    want = np.asarray(jax.random.bits(key, shape, dt))
    want = want.astype(np.int64) if bits == 32 else want.view(np.int64)
    got = TF.random_bits(TF.prng_key(1234), shape, bits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_uniform_is_bitwise_and_normal_within_tolerance(dtype):
    jd, td, _ = DTYPES[dtype]
    key = jax.random.PRNGKey(7)
    lo = float(np.nextafter(np.dtype(dtype).type(-1), np.dtype(dtype).type(0)))
    for a, b in ((0.0, 1.0), (lo, 1.0)):     # normal's range: exact scaling
        np.testing.assert_array_equal(
            TF.uniform(TF.prng_key(7), (4096,), td, a, b).numpy(),
            np.asarray(jax.random.uniform(key, (4096,), jd, a, b)))
    # A scale that rounds: XLA fuses the scale and shift into one FMA.
    np.testing.assert_allclose(
        TF.uniform(TF.prng_key(7), (4096,), td, -0.5, 2.0).numpy(),
        np.asarray(jax.random.uniform(key, (4096,), jd, -0.5, 2.0)),
        rtol=np.finfo(np.dtype(dtype)).eps, atol=0)
    want = np.asarray(jax.random.normal(key, (1 << 16,), jd))
    got = TF.normal(TF.prng_key(7), (1 << 16,), td).numpy()
    # torch.erfinv against XLA's erf_inv: relative 6e-6 (float32) and
    # 3e-12 (float64) at most, measured on 2**20 draws.
    rel = 1e-5 if dtype == "float32" else 1e-11
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel)


def test_batched_keys_draw_each_keys_stream():
    keys = TF.split(TF.prng_key(3), 4)
    batch = TF.normal(keys, (2, 5), torch.float64)
    for i in range(4):
        torch.testing.assert_close(batch[i], TF.normal(keys[i], (2, 5),
                                                       torch.float64),
                                   rtol=0, atol=0)


# --------------------------------------------------------------------------- #
#  BrownianInterval against the JAX package                                   #
# --------------------------------------------------------------------------- #

GRIDS = {"uniform": np.linspace(0.0, 1.0, 11),
         "random": np.sort(np.random.default_rng(0).uniform(0.0, 1.0, 9)),
         "dyadic": np.arange(9) / 8.0,
         "edges": np.array([0.0, 0.0, 0.5, 1.0, 1.0])}


@pytest.mark.parametrize("levels", [20, None])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_branch_bits_and_words_match_jax(grid, levels):
    jb, tb = _pair("space-time", levels=levels)
    times = GRIDS[grid]
    jbits, jstarts, jfull = jb._host_bits(times)
    tbits, tstarts, tfull = tb._resolve(times)   # on the host, trimmed
    np.testing.assert_array_equal(tbits.numpy(), jbits)
    np.testing.assert_array_equal(tstarts.numpy(),
                                  np.where(jfull, tb.t1, jstarts))
    np.testing.assert_array_equal(tfull.numpy(), jfull)
    jwords = jb._concrete_prefix(jbits, jfull)[3]
    _, _, twords, _ = tb._prefix_at(times)
    np.testing.assert_array_equal(twords.numpy(),
                                  np.asarray(jwords).astype(np.int64))
    # as a CUDA tensor of times resolves: the same bits, untrimmed
    dbits, dstarts, dfull = tb._bits(torch.as_tensor(times))
    depth = tbits.shape[1]
    assert torch.equal(dbits[:, :depth], tbits)
    assert not dbits[:, depth:].any()
    assert torch.equal(dfull, tfull) and torch.equal(dstarts, tstarts)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("levy", LEVYS)
def test_interval_matches_jax(levy, dtype):
    t0, t1 = 0.25, 2.25
    jb, tb = _pair(levy, dtype, t0=t0, t1=t1, levels=20)
    tol = DTYPES[dtype][2] * math.sqrt(t1 - t0)
    rU, rA = _returns(levy)
    grid = np.linspace(t0, t1, 12)
    want = jb.query_grid(grid, return_U=rU, return_A=rA)
    got = tb.query_grid(grid, return_U=rU, return_A=rA)
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            assert tuple(g.shape) == w.shape and g.dtype == DTYPES[dtype][1]
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=tol)
    for ta, tb_ in ((0.3, 1.7), (t0, t1), (1.0, 1.0)):
        want = _as_tuple(jb(ta, tb_, return_U=rU, return_A=rA))
        got = _as_tuple(tb(ta, tb_, return_U=rU, return_A=rA))
        for w, g in zip(want, got):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=tol)


def test_key_carried_from_jax_draws_jax_path():
    raw = np.asarray(jax.random.PRNGKey(2024))
    jb = jtsde.BrownianInterval(0.0, 1.0, (4, 2), dtype=jnp.float64, key=raw,
                                levels=16)
    tb = ttsde.BrownianInterval(0.0, 1.0, (4, 2), dtype=torch.float64,
                                key=load_jax_key(raw, device="cpu"),
                                levels=16, device="cpu")
    ref = ttsde.BrownianInterval(0.0, 1.0, (4, 2), dtype=torch.float64,
                                 entropy=2024, levels=16, device="cpu")
    np.testing.assert_allclose(_np(tb(0.2, 0.7)), np.asarray(jb(0.2, 0.7)),
                               rtol=0, atol=F64_TOL)
    torch.testing.assert_close(tb(0.2, 0.7), ref(0.2, 0.7), rtol=0, atol=0)
    with pytest.raises(ValueError, match="uint32"):
        load_jax_key(raw.astype(np.int64), device="cpu")


# --------------------------------------------------------------------------- #
#  The JAX package's laws, on the port                                        #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("levy", LEVYS)
@pytest.mark.parametrize("size,A_size", [((16, 3), (16, 3, 3)),
                                          ((16,), (16,)), ((), ())])
def test_shape(levy, size, A_size):
    rU, rA = _returns(levy)
    bm = _bm(levy, size, levels=20)
    with pytest.warns(UserWarning):
        point = _as_tuple(bm(0.4, return_U=rU, return_A=rA))
    interval = _as_tuple(bm(0.2, 0.6, return_U=rU, return_A=rA))
    for out in (point, interval):
        assert tuple(out[0].shape) == size
        if rU:
            assert tuple(out[1].shape) == size
        if rA:
            assert tuple(out[-1].shape) == A_size


@pytest.mark.parametrize("levy", LEVYS)
def test_determinism(levy):
    """Two calls, and a fresh interval of the same entropy queried in
    another order, give the same noise bitwise."""
    rU, rA = _returns(levy)
    rng = np.random.default_rng(1)
    pairs = [tuple(sorted(rng.uniform(0, 1, 2))) for _ in range(8)]
    bm = _bm(levy, levels=20)
    first = [_as_tuple(bm(a, b, return_U=rU, return_A=rA)) for a, b in pairs]
    again = [_as_tuple(bm(a, b, return_U=rU, return_A=rA)) for a, b in pairs]
    other = _bm(levy, levels=20)
    order = rng.permutation(len(pairs))
    shuffled = {i: _as_tuple(other(*pairs[i], return_U=rU, return_A=rA))
                for i in order}
    for i in range(len(pairs)):
        for x, y, z in zip(first[i], again[i], shuffled[i]):
            assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("levy", LEVYS)
def test_consistency(levy):
    """W is additive and U obeys the chain rule."""
    rU, _ = _returns(levy)
    bm = _bm(levy, size=(512,), levels=30)
    rng = np.random.default_rng(2)
    for _ in range(3):
        ta, t_, tb = np.sort(rng.uniform(0, 1, 3))
        if rU:
            (W, U), (W1, U1), (W2, U2) = (bm(a, b, return_U=True) for a, b in
                                          ((ta, tb), (ta, t_), (t_, tb)))
            torch.testing.assert_close(U1 + U2 + (tb - t_) * W1, U,
                                       rtol=1e-6, atol=1e-6)
        else:
            W, W1, W2 = bm(ta, tb), bm(ta, t_), bm(t_, tb)
        torch.testing.assert_close(W1 + W2, W, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("levy", LEVYS)
def test_normality_simple(levy):
    """W(t0, t) of an interval pinned to W(t0, t1) is the bridge's normal,
    and H is N(0, h / 12) (KS at alpha 1e-5)."""
    rng = np.random.default_rng(3)
    base_W = torch.full((8192,), float(rng.normal()), dtype=torch.float64)
    bm = ttsde.BrownianInterval(0.0, 1.0, W=base_W, entropy=11, levels=30,
                                levy_area_approximation=levy)
    t = float(rng.uniform(0.05, 0.95))
    W = bm(0.0, t)
    mean = base_W * t
    std = math.sqrt((1 - t) * t)
    assert kstest(_np((W - mean) / std), "norm").pvalue >= ALPHA
    if levy != "none":
        W, U = bm(0.0, t, return_U=True)
        H = U / t - 0.5 * W
        assert kstest(_np(H / math.sqrt(t / 12)), "norm").pvalue >= ALPHA


@pytest.mark.parametrize("levy", ["none", "space-time"])
def test_normality_conditional(levy):
    """The conditional bridge laws of W and H at an interior point."""
    have_H = levy != "none"
    bm = _bm(levy, size=(8192,), levels=30, entropy=12)
    ta, t_, tb = 0.2, 0.45, 0.9
    q = (lambda a, b: bm(a, b, return_U=True)) if have_H else \
        (lambda a, b: (bm(a, b), None))
    (W, U), (W1, U1), (W2, U2) = q(ta, tb), q(ta, t_), q(t_, tb)
    std_W = math.sqrt((tb - t_) * (t_ - ta) / (tb - ta))
    for Wi, frac in ((W1, (t_ - ta) / (tb - ta)), (W2, (tb - t_) / (tb - ta))):
        assert kstest(_np((Wi - W * frac) / std_W), "norm").pvalue >= ALPHA
    if have_H:
        h, h1, h2 = tb - ta, t_ - ta, tb - t_
        denom = math.sqrt(h1 ** 3 + h2 ** 3)
        a = h1 ** 3.5 * h2 ** 0.5 / (2 * h * denom)
        b = h1 ** 0.5 * h2 ** 3.5 / (2 * h * denom)
        c = math.sqrt(3) * h1 ** 1.5 * h2 ** 1.5 / (6 * denom)
        H, H1, H2 = U / h - W / 2, U1 / h1 - W1 / 2, U2 / h2 - W2 / 2
        for Hi, hi, ab in ((H1, h1, a), (H2, h2, b)):
            z = (Hi - H * (hi / h) ** 2) / (math.sqrt(ab ** 2 + c ** 2) / hi)
            assert kstest(_np(z), "norm").pvalue >= ALPHA


@pytest.mark.parametrize("levy", ["davie", "foster"])
def test_levy_area_query_context_independent(levy):
    """A of one interval is bitwise the same through __call__ (a shallow
    descent) and query_grid beside a non-dyadic point (a full-depth one)."""
    bm = _bm(levy, size=(2, 3), entropy=99)
    W_d, A_d = bm(0.25, 0.375, return_A=True)
    W_g, _, A_g = bm.query_grid(np.asarray([0.0, 0.1, 0.25, 0.375, 1.0]),
                                return_A=True)
    assert torch.equal(W_g[2], W_d) and torch.equal(A_g[2], A_d)


def _device_path(monkeypatch):
    """Route CPU tensors of times through the on-device resolution, as a
    CUDA tensor would go."""
    monkeypatch.setattr(TI, "on_host", lambda x: not torch.is_tensor(x))


@pytest.mark.parametrize("levy", LEVYS)
def test_query_pairs_bitwise_matches_call(levy, monkeypatch):
    """query_pairs (one descent a point), on host points and on a tensor of
    times resolved on its device, is bitwise __call__ on host floats."""
    rU, rA = _returns(levy)
    bm = _bm(levy, levels=24)
    pairs = ((0, 2), (0, 1), (1, 2), (2, 2))
    pts = [0.2, 0.35321, 0.5]
    want = [_as_tuple(bm(pts[i], pts[j], return_U=rU, return_A=rA))
            for i, j in pairs]
    host = bm.query_pairs(pts, pairs, return_U=rU, return_A=rA)
    _device_path(monkeypatch)
    device = bm.query_pairs(torch.tensor(pts, dtype=torch.float64), pairs,
                            return_U=rU, return_A=rA)
    call = [_as_tuple(bm(torch.tensor(pts[i], dtype=torch.float64),
                         torch.tensor(pts[j], dtype=torch.float64),
                         return_U=rU, return_A=rA)) for i, j in pairs]
    for w, h, d, c in zip(want, host, device, call):
        for a, b, e, f in zip(w, _as_tuple(h), _as_tuple(d), c):
            assert torch.equal(a, b) and torch.equal(a, e) and \
                torch.equal(a, f)
    # ReverseBrownian: the reversed interval is the forward (-tb, -ta)
    rev = ttsde.ReverseBrownian(bm)
    rpts = [-0.5, -0.35321, -0.2]
    for (i, j), got in zip(pairs[:3], rev.query_pairs(rpts, pairs[:3])):
        assert torch.equal(got, rev(rpts[i], rpts[j]))


def test_query_pairs_inverted_pair_clamps_to_zero(monkeypatch):
    bm = _bm("space-time", levels=24)
    for pts in ([0.2, 0.6], torch.tensor([0.2, 0.6], dtype=torch.float64)):
        if torch.is_tensor(pts):
            _device_path(monkeypatch)
        (W_f, U_f), (W_i, U_i) = bm.query_pairs(pts, ((0, 1), (1, 0)),
                                                return_U=True)
        assert float(W_f.abs().max()) > 0
        assert not W_i.any() and not U_i.any()


def test_call_rejects_inverted_times_and_warns_out_of_range():
    bm = _bm(levels=10)
    with pytest.raises(RuntimeError, match="ta <= tb"):
        bm(0.6, 0.2)
    with pytest.warns(UserWarning, match="clamping"):
        bm(0.5, 1.5)


def test_w_h_overrides_repr_and_like():
    W = torch.ones((4, 2), dtype=torch.float64)
    bm = ttsde.BrownianInterval(0.0, 1.0, W=W, entropy=1,
                                levy_area_approximation="space-time")
    torch.testing.assert_close(bm(0.0, 1.0), W, rtol=0, atol=1e-12)
    assert "BrownianInterval" in repr(bm)
    assert bm.shape == (4, 2) and bm.device == torch.device("cpu")
    like = ttsde.brownian_interval_like(torch.zeros((5, 3), dtype=torch.float64),
                                        entropy=9)
    assert like.shape == (5, 3) and like.dtype == torch.float64
    assert like.device == torch.device("cpu")


@pytest.mark.parametrize("tol,levels", [(1e-9, 30), (0.0, 52), (1e-3, 10),
                                        (1e-12, 40)])
def test_tol_sets_levels(tol, levels):
    assert ttsde.BrownianInterval(0., 1., size=(2,), tol=tol,
                                  device="cpu").levels == levels
    assert jtsde.BrownianInterval(0., 1., size=(2,), tol=tol).levels == levels


@pytest.mark.parametrize("kw", [dict(levels=53), dict(levels=-1),
                                dict(t0=1.0, t1=0.5),
                                dict(levy_area_approximation="bogus"),
                                dict(size=None)])
def test_constructor_errors_match_jax(kw):
    args = dict(t0=0.0, t1=1.0, size=(2,))
    args.update(kw)
    with pytest.raises(ValueError) as jerr:
        jtsde.BrownianInterval(**args)
    with pytest.raises(ValueError) as terr:
        ttsde.BrownianInterval(device="cpu", **args)
    assert str(terr.value) == str(jerr.value)


NO_DEVICE = {
    "interval": lambda: ttsde.BrownianInterval(0.0, 1.0, size=(2,)),
    "precomputed": lambda: ttsde.PrecomputedBrownian(0.0, 1.0, (2,), 8),
    "path numpy w0": lambda: ttsde.BrownianPath(0.0, np.zeros((2, 3))),
    "path list w0": lambda: ttsde.BrownianPath(0.0, [0.0, 1.0]),
    "tree numpy w0": lambda: ttsde.BrownianTree(0.0, np.zeros((2, 3)),
                                                w1=np.ones((2, 3))),
    "tree float w0": lambda: ttsde.BrownianTree(0.0, 0.0, entropy=1),
}


@pytest.mark.parametrize("entry", sorted(NO_DEVICE))
def test_no_card_and_no_device_raises(entry, monkeypatch):
    """With no ``device=`` and no tensor to take one from, every entry point
    resolves to the card, and raises without one: none lands on the CPU
    unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NO_DEVICE[entry]()


@pytest.mark.parametrize("cls", ["BrownianPath", "BrownianTree"])
def test_derived_device_from_w0_or_device(cls, monkeypatch):
    """A tensor w0 gives its device; a numpy w0 goes where ``device=`` says,
    as a tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = getattr(ttsde, cls)
    on_cpu = make(0.0, torch.zeros((2, 3), dtype=torch.float64), entropy=4)
    asked = make(0.0, np.zeros((2, 3)), entropy=4, device="cpu")
    for bm in (on_cpu, asked):
        assert bm.device == torch.device("cpu")
        assert torch.is_tensor(bm._w0) and bm._w0.device == bm.device
    assert torch.equal(on_cpu(0.2, 0.7), asked(0.2, 0.7))


@pytest.mark.parametrize("levels,width", [(30, 1e-9), (52, 1e-9),
                                          (52, 1e-12)])
def test_fine_scale_queries(levels, width):
    """At levels 30 a fine query quantises to whole leaves (floor) and keeps
    the law at the quantised width; at the default depth it resolves the
    width itself; both are additive at that scale."""
    bm = _bm("space-time", size=(4096,), levels=levels, entropy=13)
    t = 0.123456789
    W = bm(t, t + width)
    if levels == 30:
        leaf = 2.0 ** -30
        k = math.floor((t + width) / leaf) - math.floor(t / leaf)
        assert k >= 1
        scale = math.sqrt(k * leaf)
    else:
        scale = math.sqrt(width)
    assert kstest(_np(W) / scale, "norm").pvalue > ALPHA
    a, b, c = bm(t, t + width), bm(t + width, t + 2 * width), \
        bm(t, t + 2 * width)
    torch.testing.assert_close(a + b, c, rtol=0, atol=1e-13)
    if levels == 52:   # the U chain rule at the unquantised widths
        (W1, U1), (W2, U2), (_, Uf) = (bm(x, y, return_U=True) for x, y in (
            (t, t + width), (t + width, t + 2 * width), (t, t + 2 * width)))
        torch.testing.assert_close(U1 + U2 + width * W1, Uf, rtol=0,
                                   atol=1e-18)


def test_chunked_descent_is_bitwise_one_chunk(monkeypatch):
    """Splitting the points into chunks changes no bit."""
    bm = _bm("foster", size=(3, 4), levels=20)
    grid = np.linspace(0.0, 1.0, 9)
    whole = bm.query_grid(grid, return_U=True, return_A=True)
    monkeypatch.setattr(TI, "DESCENT_CHUNK_ELEMENTS", 2 * 12 * 2)
    chunked = bm.query_grid(grid, return_U=True, return_A=True)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
#  Derived classes                                                            #
# --------------------------------------------------------------------------- #

def test_brownian_path_offset_and_additivity():
    w0 = torch.full((4, 2), 5.0, dtype=torch.float64)
    bm = ttsde.BrownianPath(t0=0.0, w0=w0, entropy=2)
    assert bm.shape == (4, 2) and bm.device == torch.device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        point = bm(0.3)
    torch.testing.assert_close(point, bm(0.0, 0.3) + w0, rtol=0, atol=1e-12)
    torch.testing.assert_close(bm(0.1, 0.4) + bm(0.4, 0.9), bm(0.1, 0.9),
                               rtol=0, atol=1e-12)
    jw0 = jnp.full((4, 2), 5.0, jnp.float64)
    jbm = jtsde.BrownianPath(t0=0.0, w0=jw0, entropy=2)
    np.testing.assert_allclose(_np(bm(0.1, 0.4)), np.asarray(jbm(0.1, 0.4)),
                               rtol=0, atol=F64_TOL)


def test_brownian_tree_pins_endpoint_and_matches_jax():
    w0 = torch.zeros((16, 3), dtype=torch.float64)
    w1 = torch.full((16, 3), 0.7, dtype=torch.float64)
    bm = ttsde.BrownianTree(t0=0.0, w0=w0, t1=1.0, w1=w1, entropy=3)
    torch.testing.assert_close(bm(0.0, 1.0), w1 - w0, rtol=0, atol=1e-9)
    assert torch.equal(bm(0.2, 0.6), bm(0.2, 0.6))
    jbm = jtsde.BrownianTree(t0=0.0, w0=jnp.zeros((16, 3), jnp.float64),
                             t1=1.0, w1=jnp.full((16, 3), 0.7, jnp.float64),
                             entropy=3)
    np.testing.assert_allclose(_np(bm(0.2, 0.6)), np.asarray(jbm(0.2, 0.6)),
                               rtol=0, atol=F64_TOL)


def test_brownian_tree_pinned_bridge_law():
    n = 8192
    bm = ttsde.BrownianTree(t0=0.0, w0=torch.zeros(n, dtype=torch.float64),
                            t1=1.0, w1=torch.full((n,), 0.7,
                                                  dtype=torch.float64),
                            entropy=7)
    z = (bm(0.0, 0.5) - 0.35) / math.sqrt(0.25)
    assert kstest(_np(z), "norm").pvalue > ALPHA


def test_reverse_brownian_call_and_grid():
    base = _bm("space-time", size=(8, 2), levels=20, entropy=11)
    rev = ttsde.ReverseBrownian(base)
    assert torch.equal(rev(-0.7, -0.2), base(0.2, 0.7))
    assert rev.shape == base.shape and rev.dtype == base.dtype
    grid = -np.linspace(0.0, 1.0, 9)[::-1]
    W, U, _ = rev.query_grid(grid, return_U=True)
    for i in range(8):
        w, u = rev(grid[i], grid[i + 1], return_U=True)
        assert torch.equal(W[i], w) and torch.equal(U[i], u)


@pytest.mark.parametrize("levy", LEVYS)
def test_precomputed_matches_jax(levy):
    rU, rA = _returns(levy)
    kw = dict(t0=0.0, t1=1.0, size=(6, 3), n=64, entropy=5,
              levy_area_approximation=levy)
    jb = jtsde.PrecomputedBrownian(dtype=jnp.float64, **kw)
    tb = ttsde.PrecomputedBrownian(dtype=torch.float64, device="cpu", **kw)
    for ta, tb_ in ((0.13, 0.77), (0.5, 0.5), (0.0, 1.0)):
        for w, g in zip(_as_tuple(jb(ta, tb_, return_U=rU, return_A=rA)),
                        _as_tuple(tb(ta, tb_, return_U=rU, return_A=rA))):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                       atol=F64_TOL)
    grid = np.linspace(0.0, 1.0, 9)
    cells = tb.query_grid(grid, return_U=rU, return_A=rA)
    for i in range(8):
        one = _as_tuple(tb(grid[i], grid[i + 1], return_U=rU, return_A=rA))
        for x, c in zip(one, [c for c in cells if c is not None]):
            assert torch.equal(x, c[i])


@pytest.mark.parametrize("levy", ["none", "space-time", "foster"])
def test_precomputed_laws(levy):
    bm = ttsde.PrecomputedBrownian(0.0, 1.0, (8192,), 256,
                                   dtype=torch.float64, entropy=5,
                                   levy_area_approximation=levy, device="cpu")
    assert kstest(_np(bm(0.25, 0.75)) / math.sqrt(0.5), "norm").pvalue > ALPHA
    if levy != "none":
        w, u = bm(0.25, 0.75, return_U=True)
        H = u / 0.5 - 0.5 * w
        assert kstest(_np(H) / math.sqrt(0.5 / 12), "norm").pvalue > ALPHA
        w1, u1 = bm(0.25, 0.5, return_U=True)
        _, u2 = bm(0.5, 0.75, return_U=True)
        torch.testing.assert_close(u1 + u2 + 0.25 * w1, u, rtol=0, atol=1e-9)
    if levy == "foster":
        _, _, a = bm(0.25, 0.75, return_U=True, return_A=True)
        assert a.shape == (8192,) and not a.any()
