"""SDXL AutoencoderKL (port of imagharmony_tpu/models/vae.py): the encoder
training runs and the decoder the edit pipeline runs.

NCHW; diffusers parameter names (``encoder.*``, ``quant_conv``,
``decoder.*``, ``post_quant_conv``). The mid-block attention is single-head
over the H*W tokens and stays a plain product with fp32 logits and softmax,
as in the JAX package: at 1024² it is S=16384 with one 512-wide head, whose
fp32 logits take 1 GiB.

The encode always computes in fp32, as the JAX training step asks of it
(``policy=FP32`` on whatever the weights' dtype): ``encode_moments`` runs
the encoder and ``quant_conv`` through ``torch.func.functional_call`` with
fp32 copies of their weights, so bf16 weights are cast once per call and
no layer changes. The decode computes in the weights' dtype.

Not ported yet: the tiled decode.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from imagharmony_tpu_torch import dtypes
from imagharmony_tpu_torch.models.unet import ResnetBlock2D, Upsample2D
from imagharmony_tpu_torch.nn.layers import Conv2d, GroupNorm, Linear


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Defaults = SDXL-base-1.0 vae/config.json."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def tiny_config(**overrides) -> VAEConfig:
    base = dict(block_out_channels=(16, 32), norm_num_groups=8, scaling_factor=0.13025)
    base.update(overrides)
    return VAEConfig(**base)


class VAEAttention(nn.Module):
    """Single-head self-attention of the VAE mid block (biased to_q/k/v)."""

    def __init__(self, ch, *, groups, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.group_norm = GroupNorm(groups, ch, eps=1e-6, **kw)
        self.to_q = Linear(ch, ch, **kw)
        self.to_k = Linear(ch, ch, **kw)
        self.to_v = Linear(ch, ch, **kw)
        self.to_out = nn.ModuleList([Linear(ch, ch, **kw)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        f32 = dtypes.SOFTMAX_DTYPE
        logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2))
        probs = torch.softmax(logits * (c**-0.5), dim=-1).to(v.dtype)
        del logits
        o = self.to_out[0](torch.matmul(probs, v))
        return x + o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class _MidBlock(nn.Module):
    def __init__(self, ch, *, groups, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, None, groups=groups, eps=1e-6, **kw),
            ResnetBlock2D(ch, ch, None, groups=groups, eps=1e-6, **kw),
        ])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups=groups, **kw)])

    def forward(self, h):
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class _DownBlock(nn.Module):
    def __init__(self, in_ch, out_ch, *, n_resnets, groups, downsample, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, groups=groups, eps=1e-6, **kw)
            for j in range(n_resnets)
        ])
        # stride-2 conv without padding after diffusers' asymmetric (0, 1) pad
        self.downsamplers = (
            nn.ModuleList([_Downsample(out_ch, **kw)]) if downsample else None
        )

    def forward(self, h):
        for res in self.resnets:
            h = res(h)
        if self.downsamplers is not None:
            h = self.downsamplers[0](h)
        return h


class _Downsample(nn.Module):
    def __init__(self, ch, *, device=None, dtype=None):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1, **kw)
        self.down_blocks = nn.ModuleList([
            _DownBlock(ch[max(i - 1, 0)], ch[i], n_resnets=cfg.layers_per_block, groups=g,
                       downsample=i < len(ch) - 1, **kw)
            for i in range(len(ch))
        ])
        self.mid_block = _MidBlock(ch[-1], groups=g, **kw)
        self.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6, **kw)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1, **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class _UpBlock(nn.Module):
    def __init__(self, in_ch, out_ch, *, n_resnets, groups, upsample, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, groups=groups, eps=1e-6, **kw)
            for j in range(n_resnets)
        ])
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch, **kw)]) if upsample else None

    def forward(self, h):
        for res in self.resnets:
            h = res(h)
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.latent_channels, ch[-1], 3, padding=1, **kw)
        self.mid_block = _MidBlock(ch[-1], groups=g, **kw)
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList([
            _UpBlock(rev[max(i - 1, 0)], rev[i], n_resnets=cfg.layers_per_block + 1,
                     groups=g, upsample=i < len(ch) - 1, **kw)
            for i in range(len(ch))
        ])
        self.conv_norm_out = GroupNorm(g, ch[0], eps=1e-6, **kw)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1, **kw)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class _EncodePath(nn.Module):
    """encoder + quant_conv, the function ``encode_moments`` calls in fp32."""

    def __init__(self, encoder, quant_conv):
        super().__init__()
        self.encoder, self.quant_conv = encoder, quant_conv

    def forward(self, images):
        return self.quant_conv(self.encoder(images))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = Encoder(cfg, **kw)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, **kw)
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1, **kw)
        self.decoder = Decoder(cfg, **kw)

    def encode_moments(self, images):
        """Images (B, 3, H, W) in [-1, 1] -> (mean, logvar), each fp32
        (B, 4, h, w), logvar clipped to [-30, 20]; computed in fp32 whatever
        the weights' dtype."""
        path = _EncodePath(self.encoder, self.quant_conv)
        params = {k: v.float() for k, v in path.named_parameters()}
        moments = torch.func.functional_call(path, params, (images.float(),))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, images, eps=None):
        """Images -> scaled latents, fp32: the posterior mean, or with
        ``eps`` (a N(0, 1) draw of the mean's shape) the posterior sample
        mean + exp(logvar / 2) * eps, times the scaling factor."""
        mean, logvar = self.encode_moments(images)
        if eps is not None:
            mean = mean + torch.exp(0.5 * logvar) * eps.float()
        return mean * self.cfg.scaling_factor

    def decode(self, latents):
        """Scaled latents (B, 4, h, w) -> images (B, 3, H, W) in [-1, 1]."""
        return self.decoder(self.post_quant_conv(latents / self.cfg.scaling_factor))
