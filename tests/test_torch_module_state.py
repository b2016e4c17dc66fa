"""Per-call data stays off the caller's modules.

The JAX package's modules are immutable: ``LatentSDE.contextualize``
returns a new model and the critic evolves a new CDE func. The port's
counterparts return views that share the parameters and hold the context
or the control path themselves, so the caller's module is never written: a
weight-averaging copy (``copy.deepcopy``) works after a loss, and a prior
sample does not replace a context the caller holds."""

import copy

import numpy as np
import pytest
import torch

from torchsde_tpu_torch.models.latent_sde import (LatentSDE, latent_sde_loss,
                                                  sample_posterior,
                                                  sample_prior)
from torchsde_tpu_torch.models.sde_gan import (Discriminator, Generator,
                                               gan_loss)

T, B, DATA, L, C, H = 5, 6, 3, 4, 8, 16
TS = np.linspace(0.0, 1.0, T)
DT = 0.125


def _latent():
    model = LatentSDE(DATA, L, C, H, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    xs = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (T, B, DATA)), dtype=torch.float32)
    return model, xs


def _context(model):
    return model._ctx, model._ctx_ts


def _assert_context_kept(model, before):
    (ctx, ctx_ts), (ctx0, ctx_ts0, ctx_v, ctx_ts_v) = _context(model), before
    assert ctx is ctx0 and ctx_ts is ctx_ts0
    assert torch.equal(ctx, ctx_v) and torch.equal(ctx_ts, ctx_ts_v)


def _snapshot(model):
    ctx, ctx_ts = _context(model)
    return ctx, ctx_ts, ctx.clone(), ctx_ts.clone()


@pytest.mark.parametrize("fused", [False, True])
def test_deepcopy_after_latent_loss(fused):
    """After a loss (its context a non-leaf tensor that records gradients)
    the model deep-copies, and the copy computes the same loss."""
    model, xs = _latent()
    before = _snapshot(model)
    loss, _ = latent_sde_loss(model, xs, TS, torch.Generator().manual_seed(2),
                              dt=DT, fused=fused)
    loss.backward()
    _assert_context_kept(model, before)
    twin = copy.deepcopy(model)
    with torch.no_grad():
        again = latent_sde_loss(twin, xs, TS,
                                torch.Generator().manual_seed(2), dt=DT,
                                fused=fused)[0]
    assert torch.equal(again, loss.detach())


def test_view_shares_parameters_and_leaves_the_model():
    model, xs = _latent()
    ctx = model.encode(xs, TS)
    view = model.contextualize(TS, ctx)
    assert view is not model and view._ctx is ctx
    assert model._ctx.shape == (1, 1, C)
    assert view.f_net is model.f_net
    assert dict(view.named_parameters()).keys() == dict(
        model.named_parameters()).keys()
    assert all(a is b for a, b in zip(view.parameters(), model.parameters()))


@pytest.mark.parametrize("sample", ["prior", "posterior", "loss"])
def test_calls_leave_the_callers_context(sample):
    """A context the caller attached stays the same object with the same
    values, whichever call runs on the model."""
    model, xs = _latent()
    model.register_buffer("_ctx", torch.randn((T, B, C)), persistent=False)
    model.register_buffer("_ctx_ts", torch.as_tensor(TS, dtype=torch.float32),
                          persistent=False)
    before = _snapshot(model)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        if sample == "prior":
            out = sample_prior(model, B, TS, gen, dt=DT)
        elif sample == "posterior":
            out = sample_posterior(model, xs, TS, gen, dt=DT)
        else:
            out = latent_sde_loss(model, xs, TS, gen, dt=DT)[0]
    assert torch.isfinite(out).all()
    _assert_context_kept(model, before)


def _gan():
    gen = torch.Generator().manual_seed(4)
    generator = Generator(1, 3, 2, 4, 8, 1, device="cpu", generator=gen)
    critic = Discriminator(1, 5, 8, 1, device="cpu", generator=gen)
    rng = np.random.default_rng(5)
    ts = np.linspace(0.0, T - 1.0, T)
    real = torch.as_tensor(np.concatenate(
        [np.broadcast_to(ts[None, :, None], (B, T, 1)),
         rng.standard_normal((B, T, 1))], axis=2), dtype=torch.float32)
    return generator, critic, ts, real


@pytest.mark.parametrize("fused", [False, True])
def test_deepcopy_after_gan_loss(fused):
    """After gan_loss the critic carries no path and deep-copies, and the
    copy scores the same."""
    generator, critic, ts, real = _gan()
    loss = gan_loss(generator, critic, torch.Generator().manual_seed(6), ts,
                    real, adjoint=False, fused=fused)
    loss.backward()
    assert critic.func._path_ts is None and critic.func._path_ys is None
    twin = copy.deepcopy(critic)
    with torch.no_grad():
        want = critic.scores(ts, real, adjoint=False, fused=fused)
        got = twin.scores(ts, real, adjoint=False, fused=fused)
    assert torch.equal(got, want)
    assert critic.func._path_ts is None


def test_attach_returns_a_view():
    _, critic, ts, real = _gan()
    func = critic.func.attach(ts, real)
    assert func is not critic.func and func._path_ys is real
    assert func.func is critic.func.func
    assert critic.func._path_ys is None
