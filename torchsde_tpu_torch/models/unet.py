"""U-Net denoiser for the continuous DDPM (counterpart of
``torchsde_tpu/models/unet.py``).

A sinusoidal time embedding, ResNet blocks with group normalisation,
self-attention at the lowest resolution, stride-2 downsampling and nearest
2x upsampling, with additive skip connections. Images are ``(B, C, H, W)``
at the boundary; inside, the input enters in PyTorch's channels_last
memory format, the counterpart of the JAX package's NHWC (``F.group_norm``
on CUDA returns NCHW, and cuDNN converts where it runs NHWC; a group norm
on the NHWC view, which keeps channels_last throughout, measured slower
on the H100: more kernels and a larger peak). The parameters
keep the JAX layouts (a convolution's ``w`` is ``(kh, kw, in, out)``,
permuted to PyTorch's ``(out, in, kh, kw)`` in ``forward``), so
``utils.convert.load_jax_params`` carries a JAX U-Net across name for name.
Convolutions, norms and the attention are plain PyTorch operators, as the
JAX package leaves them to XLA; no numeric flag is set here (cuDNN's TF32
for float32 convolutions stays as PyTorch ships it).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, uniform
from ..utils.misc import resolve_device

CHANNELS_LAST = torch.channels_last


class Conv2d(nn.Module):
    """``ksize`` x ``ksize`` convolution with symmetric zero padding of
    ``ksize // 2``, weights U(-s, s), s = 1/sqrt(in * ksize^2)."""

    def __init__(self, in_ch, out_ch, ksize=3, stride=1, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        scale = 1.0 / math.sqrt(in_ch * ksize * ksize)
        self.w = nn.Parameter(uniform((ksize, ksize, in_ch, out_ch), scale,
                                      dtype, device, generator))
        self.b = nn.Parameter(uniform((out_ch,), scale, dtype, device,
                                      generator))
        self.stride = stride
        self.ksize = ksize

    def forward(self, x):
        return F.conv2d(x, self.w.permute(3, 2, 0, 1), self.b,
                        stride=self.stride, padding=self.ksize // 2)


class GroupNorm(nn.Module):
    """``min(groups, C)`` groups of contiguous channels, population
    variance, eps 1e-5, then a per-channel scale and bias."""

    def __init__(self, channels, groups=8, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.scale = nn.Parameter(torch.ones((channels,), dtype=dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros((channels,), dtype=dtype,
                                             device=device))
        self.groups = min(groups, channels)

    def forward(self, x):
        return F.group_norm(x, self.groups, self.scale, self.bias, eps=1e-5)


def sinusoidal_embedding(t, dim):
    """(B,) -> (B, dim): ``[sin(t f), cos(t f)]`` with ``f_k =
    exp(-log(10000) k / (dim/2 - 1))``, in ``t``'s dtype."""
    half = dim // 2
    k = torch.arange(half, dtype=t.dtype, device=t.device)
    freqs = torch.exp(-math.log(10000.0) * k / (half - 1))
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


class ResBlock(nn.Module):
    def __init__(self, in_ch, out_ch, time_dim, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm(in_ch, **kw)
        self.conv1 = Conv2d(in_ch, out_ch, generator=generator, **kw)
        self.time_proj = Linear(time_dim, out_ch, generator=generator, **kw)
        self.norm2 = GroupNorm(out_ch, **kw)
        self.conv2 = Conv2d(out_ch, out_ch, generator=generator, **kw)
        self.skip = (Conv2d(in_ch, out_ch, ksize=1, generator=generator, **kw)
                     if in_ch != out_ch else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        skip = self.skip(x) if self.skip is not None else x
        return h + skip


class SelfAttention2d(nn.Module):
    """One head over the ``H * W`` positions, scaled by ``1 / sqrt(C)``;
    the qkv projection's channels are ``[q | k | v]``."""

    def __init__(self, channels, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm = GroupNorm(channels, **kw)
        self.qkv = Conv2d(channels, 3 * channels, ksize=1,
                          generator=generator, **kw)
        self.proj = Conv2d(channels, channels, ksize=1, generator=generator,
                           **kw)
        self.channels = channels

    def forward(self, x):
        B, C, H, W = x.shape
        qkv = self.qkv(self.norm(x)).reshape(B, 3, C, H * W)
        q, k, v = (qkv[:, i].transpose(1, 2) for i in range(3))
        attn = torch.softmax(torch.einsum("bic,bjc->bij", q, k)
                             / math.sqrt(C), dim=-1)
        out = torch.einsum("bij,bjc->bic", attn, v)
        out = out.transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj(out.contiguous(memory_format=CHANNELS_LAST))


class Downsample(nn.Module):
    """A stride-2 3x3 convolution with padding 1: 28 -> 14 -> 7."""

    def __init__(self, channels, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, ksize=3, stride=2,
                           dtype=dtype, device=device, generator=generator)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x (output pixel i reads input i // 2), then a 3x3
    convolution."""

    def __init__(self, channels, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, ksize=3, dtype=dtype,
                           device=device, generator=generator)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet(nn.Module):
    """Compact U-Net: channel multipliers per resolution, ResBlocks,
    attention at the lowest resolution, additive skip connections. Built on
    ``device`` (the card unless given) from ``generator``'s draws."""

    def __init__(self, in_ch=1, base_ch=32, ch_mults=(1, 2, 2), attn_level=-1,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        del attn_level  # attention sits at the lowest level, as in JAX's
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        time_dim = base_ch * 4
        self.time_mlp1 = Linear(base_ch, time_dim, **kw)
        self.time_mlp2 = Linear(time_dim, time_dim, **kw)
        self.base_ch = base_ch

        self.conv_in = Conv2d(in_ch, base_ch, **kw)
        chans = [base_ch * m for m in ch_mults]
        self.down_blocks = nn.ModuleList()
        self.downs = nn.ModuleList()
        prev = base_ch
        for i, ch in enumerate(chans):
            self.down_blocks.append(ResBlock(prev, ch, time_dim, **kw))
            self.downs.append(Downsample(ch, **kw)
                              if i < len(chans) - 1 else None)
            prev = ch

        self.mid_block1 = ResBlock(prev, prev, time_dim, **kw)
        self.mid_attn = SelfAttention2d(prev, **kw)
        self.mid_block2 = ResBlock(prev, prev, time_dim, **kw)

        self.up_blocks = nn.ModuleList()
        self.ups = nn.ModuleList()
        for i, ch in reversed(list(enumerate(chans))):
            self.up_blocks.append(ResBlock(prev + ch, ch, time_dim, **kw))
            self.ups.append(Upsample(ch, **kw) if i > 0 else None)
            prev = ch

        self.norm_out = GroupNorm(prev, dtype=dtype, device=device)
        self.conv_out = Conv2d(prev, in_ch, **kw)

    def forward(self, t, x):
        """t: (B,) times; x: (B, C, H, W) or (B, H, W, C), told apart as
        the JAX package does. Returns the input's layout. The time
        embedding is computed in float32 whatever the parameters' dtype
        (its ``t * freqs`` products are precision-sensitive), then cast."""
        chw = x.shape[1] < x.shape[-1] or x.shape[1] <= 4
        x = (x.contiguous(memory_format=CHANNELS_LAST) if chw
             else x.permute(0, 3, 1, 2))
        temb = sinusoidal_embedding(t.to(torch.float32), self.base_ch)
        temb = temb.to(self.time_mlp1.w.dtype)
        temb = self.time_mlp2(F.silu(self.time_mlp1(temb)))

        h = self.conv_in(x)
        skips = []
        for block, down in zip(self.down_blocks, self.downs):
            h = block(h, temb)
            skips.append(h)
            if down is not None:
                h = down(h)

        h = self.mid_block1(h, temb)
        h = self.mid_attn(h)
        h = self.mid_block2(h, temb)

        for block, up in zip(self.up_blocks, self.ups):
            h = block(torch.cat([h, skips.pop()], dim=1), temb)
            if up is not None:
                h = up(h)

        out = self.conv_out(F.silu(self.norm_out(h)))
        return out if chw else out.permute(0, 2, 3, 1)
