"""ControlNet for the SDXL and SD1.5 UNets (port of
imagharmony_tpu/models/controlnet.py).

The UNet's conv_in, time and add embeddings, down blocks and mid block (the
trunk, ``UNet2DConditionModel(encoder_only=True)``, diffusers' parameter
names), a conditioning-image embedder (a stride-2 conv pyramid down to the
latent size, added to conv_in's output) and one zero-initialized 1x1 output
conv a skip and one for the mid block: a fresh ControlNet is an exact no-op
on the base model. Its cross-attentions see the text alone, never the
image-prompt tokens (the reference's CNAttnProcessor contract), so they have
no IP projections and its K2 launches take no IP keys. The outputs feed the UNet's
``down_block_additional_residuals`` / ``mid_block_additional_residual``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from imagharmony_tpu_torch.models import unet as unet_lib
from imagharmony_tpu_torch.nn.layers import Conv2d


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    base: unet_lib.UNetConfig = dataclasses.field(default_factory=unet_lib.UNetConfig)
    conditioning_channels: int = 3
    conditioning_embedding_channels: Tuple[int, ...] = (16, 32, 96, 256)

    @property
    def cond_upscale(self) -> int:
        """The control image's size over the latents' (2 per stride-2 conv)."""
        return 2 ** (len(self.conditioning_embedding_channels) - 1)


def tiny_config(**overrides) -> ControlNetConfig:
    base = dict(base=unet_lib.tiny_config(), conditioning_embedding_channels=(8, 16))
    base.update(overrides)
    return ControlNetConfig(**base)


class ControlNetConditioningEmbedding(nn.Module):
    """conv_in, then per level a 3x3 conv and a stride-2 3x3 conv, each with
    a SiLU, then a zero-initialized conv_out to the UNet's first width."""

    def __init__(self, cfg: ControlNetConfig, **kw):
        super().__init__()
        cc = cfg.conditioning_embedding_channels
        self.conv_in = Conv2d(cfg.conditioning_channels, cc[0], 3, padding=1, **kw)
        self.blocks = nn.ModuleList()
        for i in range(len(cc) - 1):
            self.blocks.append(Conv2d(cc[i], cc[i], 3, padding=1, **kw))
            self.blocks.append(Conv2d(cc[i], cc[i + 1], 3, stride=2, padding=1, **kw))
        self.conv_out = Conv2d(cc[-1], cfg.base.block_out_channels[0], 3, padding=1, **kw)

    def forward(self, x):
        x = F.silu(self.conv_in(x))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


def skip_channels(u: unet_lib.UNetConfig):
    """The channels of the UNet's skip stack, conv_in's first."""
    ch, out = u.block_out_channels, [u.block_out_channels[0]]
    for i in range(len(u.down_block_types)):
        out += [ch[i]] * u.layers_per_block
        if i < len(u.down_block_types) - 1:
            out.append(ch[i])
    return out


class ControlNetModel(unet_lib.UNet2DConditionModel):
    def __init__(self, cfg: ControlNetConfig, *, device=None, dtype=None):
        super().__init__(cfg.base, encoder_only=True, with_ip=False, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        self.cn_cfg = cfg
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(cfg, **kw)
        self.controlnet_down_blocks = nn.ModuleList(
            [Conv2d(c, c, 1, **kw) for c in skip_channels(cfg.base)])
        c = cfg.base.block_out_channels[-1]
        self.controlnet_mid_block = Conv2d(c, c, 1, **kw)

    def output_convs(self):
        """The zero-initialized convs: the embedder's conv_out and the 1x1s."""
        return [self.controlnet_cond_embedding.conv_out, *self.controlnet_down_blocks,
                self.controlnet_mid_block]

    @torch.no_grad()
    def zero_outputs_(self):
        for conv in self.output_convs():
            conv.weight.zero_()
            conv.bias.zero_()
        return self

    def forward(self, sample, timesteps, encoder_hidden_states, controlnet_cond, *,
                pooled_text_embeds=None, time_ids=None, conditioning_scale=1.0):
        """-> (the down residuals, one a skip, the mid residual), each times
        ``conditioning_scale``. controlnet_cond: the control image in [0, 1],
        NCHW, ``cond_upscale`` times the latents' size."""
        temb = self.embed(timesteps, sample.shape[0], pooled_text_embeds, time_ids)
        dt = self.conv_in.weight.dtype
        ctx = encoder_hidden_states.to(dt)
        h = self.conv_in(sample) + self.controlnet_cond_embedding(controlnet_cond)
        res_stack, h = self.encode(h, temb, ctx)
        h = self.mid(h, temb, ctx)
        down = tuple(conv(r) * conditioning_scale
                     for conv, r in zip(self.controlnet_down_blocks, res_stack))
        return down, self.controlnet_mid_block(h) * conditioning_scale
