"""UNet2DConditionModel of SDXL and of the SD1.5 family, forward pass (port
of imagharmony_tpu/models/unet.py).

NCHW activations, diffusers parameter names. The IP-Adapter is a static
config (``UNetConfig.ip_layers``): each transformer knows at build time
whether its cross-attentions take the image-prompt tokens, and the
image-prompt tokens are a separate ``ip_tokens`` input, never concatenated
into the text sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from imagharmony_tpu_torch.nn import layers
from imagharmony_tpu_torch.nn.layers import Conv2d, GroupNorm, Linear
from imagharmony_tpu_torch.nn.transformer import Transformer2DModel


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Defaults = SDXL-base-1.0 unet/config.json."""

    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    # SDXL's attention_head_dim=[5,10,20] is the number of heads; width 64
    num_attention_heads: Tuple[int, ...] = (5, 10, 20)
    # None -> head_dim = block_channels // heads
    attention_head_dim: int | None = None
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    # "text_time" (SDXL micro-conditioning) or None (SD1.5: no add-embeds)
    addition_embed_type: str | None = "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    # layers whose text cross-attention carries a live IP branch (the
    # reference's single target block); every other cross-attention keeps
    # inert to_k_ip/to_v_ip weights
    ip_layers: Tuple[str, ...] = ("down_blocks.2.attentions.1",)
    num_ip_tokens: int = 4

    @staticmethod
    def ip_all_layers() -> Tuple[str, ...]:
        """``ip_layers`` value that makes the IP branch live on every
        cross-attention (the vanilla IP-Adapter of the SD1.5 family)."""
        return ("",)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads_for(self, block_idx: int) -> int:
        return self.num_attention_heads[block_idx]

    def head_dim_for(self, block_idx: int) -> int:
        if self.attention_head_dim is not None:
            return self.attention_head_dim
        return self.block_out_channels[block_idx] // self.num_attention_heads[block_idx]

    def is_ip_active(self, layer_name: str) -> bool:
        return any(t in layer_name for t in self.ip_layers)


def tiny_config(**overrides) -> UNetConfig:
    """Small UNet for tests: same topology, tiny widths."""
    base = dict(
        sample_size=8,
        block_out_channels=(32, 64, 128),
        transformer_layers_per_block=(1, 1, 2),
        num_attention_heads=(1, 2, 4),
        attention_head_dim=32,
        cross_attention_dim=64,
        norm_num_groups=8,
        addition_time_embed_dim=16,
        projection_class_embeddings_input_dim=16 * 6 + 32,
    )
    base.update(overrides)
    return UNetConfig(**base)


def sd15_config(**overrides) -> UNetConfig:
    """Stable Diffusion 1.5 UNet: four stages, 8 heads everywhere (head dims
    40/80/160), one transformer layer per block, no add-embedding, the IP
    branch on every cross-attention."""
    base = dict(
        sample_size=64,
        block_out_channels=(320, 640, 1280, 1280),
        down_block_types=(
            "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        up_block_types=(
            "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        ),
        transformer_layers_per_block=(1, 1, 1, 1),
        num_attention_heads=(8, 8, 8, 8),
        attention_head_dim=None,
        cross_attention_dim=768,
        addition_embed_type=None,
        ip_layers=UNetConfig.ip_all_layers(),
    )
    base.update(overrides)
    return UNetConfig(**base)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim, *, groups, eps=1e-5, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm(groups, in_ch, eps=eps, **kw)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, **kw)
        self.time_emb_proj = Linear(temb_dim, out_ch, **kw) if temb_dim else None
        self.norm2 = GroupNorm(groups, out_ch, eps=eps, **kw)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, **kw)
        self.conv_shortcut = Conv2d(in_ch, out_ch, 1, **kw) if in_ch != out_ch else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, ch, *, device=None, dtype=None):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=1, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch, *, device=None, dtype=None):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1, device=device, dtype=dtype)

    def forward(self, x):
        return layers.upsample2x_conv(self.conv, x)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, dim, *, device=None, dtype=None):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim, device=device, dtype=dtype)
        self.linear_2 = Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class DownBlock2D(nn.Module):
    """Resnets, optional transformers, optional stride-2 downsampler (one
    module in ``downsamplers``, diffusers' layout)."""

    def __init__(self, resnets, attentions, downsampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        self.downsamplers = nn.ModuleList([downsampler]) if downsampler is not None else None


class UpBlock2D(nn.Module):
    """Resnets over the concatenated skips, optional transformers, optional
    upsampler (one module in ``upsamplers``)."""

    def __init__(self, resnets, attentions, upsampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        self.upsamplers = nn.ModuleList([upsampler]) if upsampler is not None else None


class MidBlock2D(nn.Module):
    def __init__(self, resnets, attentions):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        temb_dim = cfg.time_embed_dim
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1, **kw)
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim, **kw)
        self.add_embedding = (
            TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb_dim, **kw)
            if cfg.addition_embed_type == "text_time" else None
        )

        def transformer(block_idx, channels, name):
            return Transformer2DModel(
                channels,
                num_layers=cfg.transformer_layers_per_block[block_idx],
                heads=cfg.heads_for(block_idx),
                head_dim=cfg.head_dim_for(block_idx),
                context_dim=cfg.cross_attention_dim,
                ip_active=cfg.is_ip_active(name),
                **kw,
            )

        self.down_blocks = nn.ModuleList()
        out_c = ch[0]
        for i, btype in enumerate(cfg.down_block_types):
            in_c, out_c = out_c, ch[i]
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(in_c if j == 0 else out_c, out_c, temb_dim,
                                             groups=g, **kw))
                if btype == "CrossAttnDownBlock2D":
                    attns.append(transformer(i, out_c, f"down_blocks.{i}.attentions.{j}"))
            last = i == len(cfg.down_block_types) - 1
            self.down_blocks.append(
                DownBlock2D(resnets, attns, None if last else Downsample2D(out_c, **kw))
            )

        mid_c = ch[-1]
        self.mid_block = MidBlock2D(
            [ResnetBlock2D(mid_c, mid_c, temb_dim, groups=g, **kw),
             ResnetBlock2D(mid_c, mid_c, temb_dim, groups=g, **kw)],
            [transformer(len(ch) - 1, mid_c, "mid_block.attentions.0")],
        )

        self.up_blocks = nn.ModuleList()
        rev_ch = list(reversed(ch))
        prev_c = mid_c
        for i, btype in enumerate(cfg.up_block_types):
            out_c = rev_ch[i]
            skip_c = rev_ch[min(i + 1, len(ch) - 1)]
            block_idx = len(ch) - 1 - i
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                res_skip = skip_c if j == cfg.layers_per_block else out_c
                res_in = prev_c if j == 0 else out_c
                resnets.append(ResnetBlock2D(res_in + res_skip, out_c, temb_dim, groups=g, **kw))
                if btype == "CrossAttnUpBlock2D":
                    attns.append(transformer(block_idx, out_c, f"up_blocks.{i}.attentions.{j}"))
            last = i == len(cfg.up_block_types) - 1
            self.up_blocks.append(
                UpBlock2D(resnets, attns, None if last else Upsample2D(out_c, **kw))
            )
            prev_c = out_c

        self.conv_norm_out = GroupNorm(g, ch[0], **kw)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1, **kw)

    def forward(self, sample, timesteps, encoder_hidden_states, *, pooled_text_embeds=None,
                time_ids=None, ip_tokens=None, ip_scale=1.0,
                return_encoder: bool = False, encoder_override=None):
        """Predict noise.

        sample:                (B, 4, H, W) NCHW latents
        timesteps:             (B,) or scalar
        encoder_hidden_states: (B, S_text, cross_attention_dim)
        pooled_text_embeds:    (B, 1280) pooled text embedding (tower 2);
                               None without an add-embedding (SD1.5)
        time_ids:              (B, 6) SDXL micro-conditioning; None likewise
        ip_tokens:             (B, num_ip_tokens, cross_attention_dim) or None
        ip_scale:              IP branch weight

        return_encoder / encoder_override (encoder propagation) are part of
        the interface but not implemented in the port yet.
        """
        if return_encoder or encoder_override is not None:
            raise NotImplementedError("encoder propagation is not ported yet")
        cfg = self.cfg
        ts = torch.as_tensor(timesteps, device=sample.device)
        if ts.dim() == 0:
            ts = ts.expand(sample.shape[0])

        temb = self.time_embedding(layers.timestep_embedding(ts, cfg.block_out_channels[0]))
        if self.add_embedding is not None:
            tid_emb = layers.timestep_embedding(
                time_ids.reshape(-1), cfg.addition_time_embed_dim
            ).reshape(ts.shape[0], -1)
            add_embeds = torch.cat([pooled_text_embeds.float(), tid_emb], dim=-1)
            temb = temb + self.add_embedding(add_embeds)

        dt = self.conv_in.weight.dtype
        ctx = encoder_hidden_states.to(dt)
        ip = ip_tokens.to(dt) if ip_tokens is not None else None

        h = self.conv_in(sample)
        res_stack = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = res(h, temb)
                if len(block.attentions):
                    h = block.attentions[j](h, ctx, ip_context=ip, ip_scale=ip_scale)
                res_stack.append(h)
            if block.downsamplers is not None:
                h = block.downsamplers[0](h)
                res_stack.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, ctx, ip_context=ip, ip_scale=ip_scale)
        h = mid.resnets[1](h, temb)

        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = res(torch.cat([h, res_stack.pop()], dim=1), temb)
                if len(block.attentions):
                    h = block.attentions[j](h, ctx, ip_context=ip, ip_scale=ip_scale)
            if block.upsamplers is not None:
                h = block.upsamplers[0](h)

        h = self.conv_norm_out(h)
        return self.conv_out(F.silu(h))
