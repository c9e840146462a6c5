"""SDXL AutoencoderKL decoder (port of the decode path of
imagharmony_tpu/models/vae.py).

NCHW; diffusers parameter names (``decoder.*``, ``post_quant_conv``). The
mid-block attention is single-head over the H*W tokens and stays a plain
product with fp32 logits and softmax, as in the JAX package: at 1024² it is
S=16384 with one 512-wide head, whose fp32 logits take 1 GiB.

Not ported yet: the encoder (img2img) and the tiled decode.
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


class AutoencoderKL(nn.Module):
    """Decode half of the VAE: ``post_quant_conv`` + ``decoder``."""

    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1,
                                      device=device, dtype=dtype)
        self.decoder = Decoder(cfg, device=device, dtype=dtype)

    def decode(self, latents):
        """Scaled latents (B, 4, h, w) -> images (B, 3, H, W) in [-1, 1]."""
        return self.decoder(self.post_quant_conv(latents / self.cfg.scaling_factor))
