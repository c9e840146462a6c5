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


def sdxl_refiner_config(**overrides) -> UNetConfig:
    """SDXL-refiner-1.0 UNet (diffusers stable-diffusion-xl-refiner-1.0
    unet/config.json): four stages of width 384/768/1536/1536, cross-attention
    on the middle two only, four transformer layers a block, heads of 64,
    conditioned on the bigG tower alone (1280) with the aesthetic-score
    micro-conditioning (5 time ids x 256 + 1280 pooled = 2560). No IP
    branch: the image prompt conditions the base."""
    base = dict(
        sample_size=128,
        block_out_channels=(384, 768, 1536, 1536),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                          "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
        transformer_layers_per_block=(4, 4, 4, 4),
        num_attention_heads=(6, 12, 24, 24),
        attention_head_dim=None,
        cross_attention_dim=1280,
        projection_class_embeddings_input_dim=2560,
        ip_layers=(),
    )
    base.update(overrides)
    return UNetConfig(**base)


def config_from_diffusers(d: dict, **overrides) -> UNetConfig:
    """A UNetConfig from a diffusers UNet2DConditionModel ``config.json``
    dict; raises on architecture options this UNet does not implement.

    The head-count quirk, as diffusers documents it: without
    ``num_attention_heads``, ``attention_head_dim`` holds the per-block
    *number of heads* (SDXL ships attention_head_dim=[5,10,20]); with both,
    ``attention_head_dim`` is the head width."""
    n_blocks = len(d["block_out_channels"])
    unsupported = {
        "class_embed_type": None,
        "encoder_hid_dim": None,
        "time_cond_proj_dim": None,
        "dual_cross_attention": False,
        "mid_block_type": "UNetMidBlock2DCrossAttn",
        "resnet_time_scale_shift": "default",
        "class_embeddings_concat": False,
    }
    for key, ok in unsupported.items():
        val = d.get(key, ok)
        if val != ok and val is not None:
            raise ValueError(f"diffusers UNet config option {key}={val!r} is not supported by "
                             f"this implementation (expected {ok!r})")
    for key in ("down_block_types", "up_block_types"):
        bad = set(d.get(key, ())) - {"DownBlock2D", "CrossAttnDownBlock2D", "UpBlock2D",
                                     "CrossAttnUpBlock2D"}
        if bad:
            raise ValueError(f"unsupported {key} entries: {sorted(bad)}")

    def per_block(v, name):
        if isinstance(v, (list, tuple)):
            if len(v) != n_blocks:
                raise ValueError(f"{name} length {len(v)} != {n_blocks} blocks")
            return tuple(int(x) for x in v)
        return (int(v),) * n_blocks

    heads_raw = d.get("num_attention_heads")
    ahd = d.get("attention_head_dim", 8)
    if heads_raw is not None:
        heads = per_block(heads_raw, "num_attention_heads")
        head_dim = int(ahd) if isinstance(ahd, (int, float)) else None
    else:
        heads = per_block(ahd, "attention_head_dim")
        head_dim = None

    def uniform(key, default):
        v = d.get(key, default)
        if isinstance(v, (list, tuple)):
            if len(set(v)) != 1:
                raise ValueError(f"non-uniform {key} {v} unsupported")
            v = v[0]
        return int(v)

    cfg = dict(
        sample_size=int(d.get("sample_size", 128)),
        in_channels=int(d.get("in_channels", 4)),
        out_channels=int(d.get("out_channels", 4)),
        block_out_channels=tuple(int(c) for c in d["block_out_channels"]),
        down_block_types=tuple(d["down_block_types"]),
        up_block_types=tuple(d["up_block_types"]),
        layers_per_block=uniform("layers_per_block", 2),
        transformer_layers_per_block=per_block(d.get("transformer_layers_per_block", 1),
                                               "transformer_layers_per_block"),
        num_attention_heads=heads,
        attention_head_dim=head_dim,
        cross_attention_dim=uniform("cross_attention_dim", 1280),
        norm_num_groups=int(d.get("norm_num_groups", 32)),
        addition_embed_type=d.get("addition_embed_type"),
        addition_time_embed_dim=int(d.get("addition_time_embed_dim") or 256),
        projection_class_embeddings_input_dim=int(
            d.get("projection_class_embeddings_input_dim") or 2816),
    )
    cfg.update(overrides)
    return UNetConfig(**cfg)


def config_to_diffusers(cfg: UNetConfig) -> dict:
    """The inverse of ``config_from_diffusers`` (what a tree's
    ``unet/config.json`` holds); the IP layout is not part of it."""
    heads = list(cfg.num_attention_heads)
    return {
        "_class_name": "UNet2DConditionModel",
        "sample_size": cfg.sample_size,
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "down_block_types": list(cfg.down_block_types),
        "up_block_types": list(cfg.up_block_types),
        "layers_per_block": cfg.layers_per_block,
        "transformer_layers_per_block": list(cfg.transformer_layers_per_block),
        # diffusers' quirk: with no num_attention_heads, attention_head_dim
        # holds the head counts
        "num_attention_heads": heads if cfg.attention_head_dim is not None else None,
        "attention_head_dim": cfg.attention_head_dim if cfg.attention_head_dim is not None
        else heads,
        "cross_attention_dim": cfg.cross_attention_dim,
        "norm_num_groups": cfg.norm_num_groups,
        "addition_embed_type": cfg.addition_embed_type,
        "addition_time_embed_dim": cfg.addition_time_embed_dim,
        "projection_class_embeddings_input_dim": cfg.projection_class_embeddings_input_dim,
    }


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
    """``encoder_only``: conv_in, the embeddings, the down blocks and the mid
    block alone (a ControlNet's trunk). ``with_ip=False``: cross-attentions
    without IP projections (a ControlNet's, which sees the text alone)."""

    def __init__(self, cfg: UNetConfig, *, encoder_only=False, with_ip=True, device=None,
                 dtype=None):
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
                ip_active=with_ip and cfg.is_ip_active(name),
                with_ip=with_ip,
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
        if encoder_only:
            return

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

    def embed(self, timesteps, batch, pooled_text_embeds=None, time_ids=None):
        """The time embedding (B, 4 * C0), with the add-embedding of the
        pooled text and the micro-conditioning where the config has one."""
        cfg = self.cfg
        ts = torch.as_tensor(timesteps, device=self.conv_in.weight.device)
        if ts.dim() == 0:
            ts = ts.expand(batch)
        temb = self.time_embedding(layers.timestep_embedding(ts, cfg.block_out_channels[0]))
        if self.add_embedding is not None:
            tid_emb = layers.timestep_embedding(
                time_ids.reshape(-1), cfg.addition_time_embed_dim
            ).reshape(ts.shape[0], -1)
            add_embeds = torch.cat([pooled_text_embeds.float(), tid_emb], dim=-1)
            temb = temb + self.add_embedding(add_embeds)
        return temb

    def encode(self, h, temb, ctx, ip=None, ip_scale=1.0, collect_ip_probs=None):
        """The down blocks from conv_in's output ``h``: (the skip stack, one
        skip a resnet and a downsampler and conv_in's, the mid block's
        input)."""
        res_stack = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = res(h, temb)
                if len(block.attentions):
                    h = block.attentions[j](h, ctx, ip_context=ip, ip_scale=ip_scale,
                                            collect_ip_probs=collect_ip_probs)
                res_stack.append(h)
            if block.downsamplers is not None:
                h = block.downsamplers[0](h)
                res_stack.append(h)
        return res_stack, h

    def mid(self, h, temb, ctx, ip=None, ip_scale=1.0, collect_ip_probs=None):
        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, ctx, ip_context=ip, ip_scale=ip_scale,
                              collect_ip_probs=collect_ip_probs)
        return mid.resnets[1](h, temb)

    def forward(self, sample, timesteps, encoder_hidden_states, *, pooled_text_embeds=None,
                time_ids=None, ip_tokens=None, ip_scale=1.0,
                down_block_additional_residuals=None, mid_block_additional_residual=None,
                return_encoder: bool = False, encoder_override=None, collect_ip_probs=None):
        """Predict noise.

        sample:                (B, 4, H, W) NCHW latents
        timesteps:             (B,) or scalar
        encoder_hidden_states: (B, S_text, cross_attention_dim)
        pooled_text_embeds:    (B, 1280) pooled text embedding (tower 2);
                               None without an add-embedding (SD1.5)
        time_ids:              (B, 6) SDXL micro-conditioning ((B, 5) with
                               the refiner's aesthetic score); None likewise
        ip_tokens:             (B, num_ip_tokens, cross_attention_dim) or None
        ip_scale:              IP branch weight: a float, a 0-dim fp32 tensor,
                               or a (B,) fp32 vector, one weight a row (K2
                               reads a tensor on the card)
        down_block_additional_residuals / mid_block_additional_residual:
                               a ControlNet's residuals, added to the skip
                               stack and to the mid block's output
        collect_ip_probs:      a list: each live IP layer's attention
                               probabilities (B, heads, Sq, S_ip), fp32, are
                               appended to it (``utils/attn_maps.py``)

        Encoder propagation (Faster Diffusion, arXiv 2312.09608), the JAX
        package's ``unet.apply`` interface:
        return_encoder:   also return ``(skip stack, mid block input)``, the
                          stack with the ControlNet residuals added;
        encoder_override: such a pair from an earlier call: conv_in and the
                          down blocks are skipped, the mid block and the
                          decoder run on it.
        """
        cfg = self.cfg
        temb = self.embed(timesteps, sample.shape[0], pooled_text_embeds, time_ids)
        dt = self.conv_in.weight.dtype
        ctx = encoder_hidden_states.to(dt)
        ip = ip_tokens.to(dt) if ip_tokens is not None else None
        probs = dict(collect_ip_probs=collect_ip_probs)

        if encoder_override is not None:
            res_stack, h = list(encoder_override[0]), encoder_override[1]
        else:
            res_stack, h = self.encode(self.conv_in(sample), temb, ctx, ip, ip_scale, **probs)
            if down_block_additional_residuals is not None:
                res_stack = [s + r for s, r in zip(res_stack, down_block_additional_residuals)]
        encoder_feats = (tuple(res_stack), h)

        h = self.mid(h, temb, ctx, ip, ip_scale, **probs)
        if mid_block_additional_residual is not None:
            h = h + mid_block_additional_residual

        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = res(torch.cat([h, res_stack.pop()], dim=1), temb)
                if len(block.attentions):
                    h = block.attentions[j](h, ctx, ip_context=ip, ip_scale=ip_scale, **probs)
            if block.upsamplers is not None:
                h = block.upsamplers[0](h)

        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return (h, encoder_feats) if return_encoder else h
