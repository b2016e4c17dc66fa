"""Continuous-time DDPM: variance-preserving score-based diffusion
(counterpart of ``torchsde_tpu/models/cont_ddpm.py``).

The VP-SDE with a linear beta schedule, its analytical conditional sample
and score, the variance-weighted denoising score-matching loss with
stratified times, reverse-time SDE sampling through ``sdeint`` (midpoint)
on the flattened image state with negated time, the probability-flow ODE
sampler (fixed-step RK4) and the Tweedie denoising jump.

Where the JAX package takes a key the port takes a ``torch.Generator``.
Each draw is made apart from the arithmetic that uses it, at a module-level
draw site (``_standard_normal``, ``_uniform``), and the arithmetic is a
deterministic function of the draws (``ScoreMatchingSDE.loss_on_draws``),
so that tests can hand the port the JAX package's draws. The reverse SDE's
Brownian noise is ``sdeint``'s default noise from the same generator.
"""

import itertools
import math

import numpy as np
import torch
from torch import nn

from ..core.sdeint import sdeint


def _standard_normal(shape, generator, dtype, device):
    """Normal draws: the t1 marginal's samples and the loss's noise."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _uniform(shape, generator, dtype, device):
    """U[0, 1) draws: the loss's stratified times."""
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def _fill_tail_dims(t, ref):
    return t.reshape(t.shape + (1,) * (ref.ndim - t.ndim))


def _first_param(module):
    """The denoiser's first tensor (a parameter, else a buffer): its dtype
    and device are the denoiser's, as the JAX package reads them from its
    first pytree leaf."""
    return next(itertools.chain(module.parameters(), module.buffers()))


class ScoreMatchingSDE(nn.Module):
    """Forward (noising) VP-SDE and its score-matching objective around a
    ``denoiser(t, x)`` (a ``models.unet.UNet``)."""
    noise_type = "diagonal"
    sde_type = "ito"

    def __init__(self, denoiser, input_size=(1, 28, 28), t0=0.0, t1=1.0,
                 beta_min=0.1, beta_max=20.0):
        super().__init__()
        if t0 > t1:
            raise ValueError(f"Expected t0 <= t1, but found t0={t0:.4f}, "
                             f"t1={t1:.4f}")
        self.denoiser = denoiser
        self.input_size = tuple(input_size)
        self.t0, self.t1 = float(t0), float(t1)
        self.beta_min, self.beta_max = beta_min, beta_max

    def score(self, t, y):
        """The denoiser in its first parameter's dtype, ``t`` as float32
        broadcast over the batch (the U-Net embeds time in float32), the
        result cast back to ``y``'s dtype."""
        param_dtype = _first_param(self.denoiser).dtype
        t = torch.as_tensor(t, dtype=torch.float32,
                            device=y.device).expand(y.shape[0])
        return self.denoiser(t, y.to(param_dtype)).to(y.dtype)

    def _beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def _indefinite_int(self, t):
        return (self.beta_min * t
                + 0.5 * t ** 2 * (self.beta_max - self.beta_min))

    def _mean_coeff(self, t):
        return torch.exp(-0.5 * (self._indefinite_int(t)
                                 - self._indefinite_int(self.t0)))

    def analytical_mean(self, t, x_t0):
        return x_t0 * _fill_tail_dims(self._mean_coeff(t), x_t0)

    def analytical_var(self, t):
        return 1 - torch.exp(-self._indefinite_int(t)
                             + self._indefinite_int(self.t0))

    def analytical_sample(self, generator, t, x_t0):
        z = _standard_normal(x_t0.shape, generator, x_t0.dtype, x_t0.device)
        return self.analytical_sample_on(t, x_t0, z)

    def analytical_sample_on(self, t, x_t0, z):
        """The conditional sample at ``t`` from standard normals ``z``."""
        mean = self.analytical_mean(t, x_t0)
        std = torch.sqrt(self.analytical_var(t))
        return mean + z * _fill_tail_dims(std, mean)

    def analytical_score(self, x_t, t, x_t0):
        mean = self.analytical_mean(t, x_t0)
        var = torch.clamp_min(self.analytical_var(t), 1e-5)
        return -(x_t - mean) / _fill_tail_dims(var, mean)

    # The forward (noising) SDE on flattened state, for sdeint.
    def f(self, t, y):
        return -0.5 * self._beta(t) * y

    def g(self, t, y):
        beta = self._beta(torch.as_tensor(t, dtype=y.dtype, device=y.device))
        return torch.sqrt(beta).expand(y.shape)

    def sample_t1_marginal(self, generator, batch_size, tau=1.0):
        """N(0, tau) images in the denoiser's parameter dtype and device."""
        p = _first_param(self.denoiser)
        return (_standard_normal((batch_size, *self.input_size), generator,
                                 p.dtype, p.device) * math.sqrt(tau))

    def loss(self, generator, x_t0, partitions=1):
        """Stratified score-matching objective: a per-example loss vector of
        length ``batch * partitions``. Draws the times' uniforms, then the
        conditional samples' normals, from ``generator``."""
        B = x_t0.shape[0]
        u = _uniform((B, partitions), generator, x_t0.dtype, x_t0.device)
        z = _standard_normal((B * partitions, *x_t0.shape[1:]), generator,
                             x_t0.dtype, x_t0.device)
        return self.loss_on_draws(x_t0, u, z)

    def loss_on_draws(self, x_t0, u, z):
        """``loss`` on given draws: ``u`` (B, partitions) uniforms, ``z``
        (B * partitions, *image) standard normals; the time of example
        ``b``'s partition ``p`` is row ``b * partitions + p``."""
        partitions = u.shape[1]
        width = (self.t1 - self.t0) / partitions
        shifts = (torch.arange(partitions, dtype=x_t0.dtype,
                               device=x_t0.device)[None, :] * width + self.t0)
        t = (u * width + shifts).reshape(-1)
        lambda_t = self.analytical_var(t)

        x_rep = torch.repeat_interleave(x_t0, partitions, dim=0)
        x_t = self.analytical_sample_on(t, x_rep, z)
        fake_score = self.score(t, x_t)
        true_score = self.analytical_score(x_t, t, x_rep)
        sq = ((fake_score - true_score) ** 2).reshape(x_t.shape[0], -1) \
            .sum(dim=1)
        return lambda_t * sq


class ReverseDiffeqWrapper(nn.Module):
    """Reverse-time dynamics by the negated-time trick: solve on
    increasing -t."""
    noise_type = "diagonal"
    sde_type = "stratonovich"

    def __init__(self, module: ScoreMatchingSDE):
        super().__init__()
        self.module = module

    @property
    def t0(self):
        return self.module.t0

    @property
    def t1(self):
        return self.module.t1

    def _unflatten(self, y):
        return y.reshape(-1, *self.module.input_size)

    def ode_f(self, t, y):
        """The probability-flow ODE's vector field."""
        m = self.module
        return -(m.f(-t, y) - 0.5 * m.g(-t, y) ** 2 *
                 m.score(-t, self._unflatten(y)).reshape(y.shape))

    def f(self, t, y):
        m = self.module
        x = self._unflatten(y)
        out = -(m.f(-t, x) - m.g(-t, x) ** 2 * m.score(-t, x))
        return out.reshape(y.shape[0], -1)

    def g(self, t, y):
        x = self._unflatten(y)
        return -self.module.g(-t, x).reshape(y.shape[0], -1)

    def sde_sample(self, generator=None, batch_size=64, tau=1.0, dt=1e-2,
                   t_size=2, tweedie_correction=True, denoise_t=None):
        """Reverse-time SDE samples of flattened images by midpoint
        ``sdeint`` over ``linspace(-t1, -t_lo, t_size)``: ``(t_size, B,
        *image)``. The t1 marginal is drawn from ``generator``, then the
        solve's Brownian noise.

        ``denoise_t > 0`` stops the reverse solve at that time and jumps to
        ``t0`` with the exact Tweedie posterior mean (``denoise``): near
        ``t0`` the learned score is too weak to scrub the last injected
        noise. Without it the last state gets ``tweedie_correction``."""
        y = self.module.sample_t1_marginal(generator, batch_size, tau)
        t_lo = float(denoise_t) if denoise_t else self.t0
        ts = np.linspace(-self.t1, -t_lo, t_size)
        ys = sdeint(self, y.reshape(batch_size, -1), ts, dt=dt,
                    method="midpoint", generator=generator)
        ys = ys.reshape(t_size, batch_size, *self.module.input_size)
        if denoise_t:
            last = self.denoise(t_lo, ys[-1])
        elif tweedie_correction:
            last = self.tweedie_correction(self.t0, ys[-1], dt)
        else:
            return ys
        return torch.cat([ys[:-1], last.to(ys.dtype)[None]])

    def sde_sample_final(self, generator=None, batch_size=64, tau=1.0,
                         dt=1e-2, denoise_t=None):
        return self.sde_sample(generator, batch_size, tau, dt,
                               denoise_t=denoise_t)[-1]

    def denoise(self, t, y):
        """Exact Tweedie denoising from the time-``t`` marginal to ``t0``:
        ``(x_t + var(t) score(t, x_t)) / mean_coeff(t)``, ``t`` in
        float32."""
        m = self.module
        t = torch.as_tensor(t, dtype=torch.float32, device=y.device)
        return (y + m.analytical_var(t) * m.score(t, y)) / m._mean_coeff(t)

    def ode_sample(self, batch_size=64, tau=1.0, y=None, dt=1e-2,
                   generator=None):
        """Probability-flow ODE samples by fixed-step RK4 over
        ``round((t1 - t0) / dt)`` steps, the state in at least float32 and
        the time grid in the state's dtype; ``y`` (the t1 marginal) is
        drawn from ``generator`` when not given."""
        if y is None:
            y = self.module.sample_t1_marginal(generator, batch_size, tau)
        shape, out_dtype = y.shape, y.dtype
        y = y.reshape(shape[0], -1).to(torch.promote_types(y.dtype,
                                                           torch.float32))
        n = int(round((self.t1 - self.t0) / dt))
        t_grid = torch.linspace(-self.t1, -self.t0, n + 1, dtype=y.dtype,
                                device=y.device)
        for i in range(n):
            t = t_grid[i]
            h = t_grid[i + 1] - t_grid[i]
            k1 = self.ode_f(t, y)
            k2 = self.ode_f(t + h / 2, y + h * k1 / 2)
            k3 = self.ode_f(t + h / 2, y + h * k2 / 2)
            k4 = self.ode_f(t + h, y + h * k3)
            y = y + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
        return y.reshape(shape).to(out_dtype)

    def tweedie_correction(self, t, y, dt):
        """The final denoising jump: ``y + dt score(t, y)``."""
        return y + dt * self.module.score(t, y)
