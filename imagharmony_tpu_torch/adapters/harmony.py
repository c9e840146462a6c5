"""Harmony-Aware (HA) fusion head, ``cross_attention`` variant (port of
imagharmony_tpu/adapters/harmony.py):

    delta = fc2(LN(flatten(cross_attn(reshape(fc1(img)), text)))) * scale
    image_embed <- image_embed + delta

The qformer, mlp and gated-attention fusions are not ported yet.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from imagharmony_tpu_torch.nn.attention import merge_heads, sdpa, split_heads
from imagharmony_tpu_torch.nn.layers import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class HarmonyConfig:
    """Defaults = the shipped training config."""

    image_hidden_size: int = 1280
    text_context_dim: int = 2048
    inter_dim: int = 2560
    cross_heads: int = 8
    reshape_blocks: int = 8
    cross_value_dim: int = 64
    scale: float = 1.0
    fusion_method: str = "cross_attention"

    @property
    def query_dim(self) -> int:
        return self.inter_dim // self.reshape_blocks

    @property
    def flattened_dim(self) -> int:
        return self.cross_heads * self.cross_value_dim * self.reshape_blocks


def tiny_config(**overrides) -> HarmonyConfig:
    base = dict(image_hidden_size=24, text_context_dim=80, inter_dim=64, cross_heads=2,
                reshape_blocks=4, cross_value_dim=8)
    base.update(overrides)
    return HarmonyConfig(**base)


class CrossAttention(nn.Module):
    """Multi-head cross-attention whose value width differs from the query
    width; logits are divided by sqrt(head_dim)."""

    def __init__(self, cfg: HarmonyConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        qd, h, vd = cfg.query_dim, cfg.cross_heads, cfg.cross_value_dim
        hd = qd // h
        self.heads = h
        self.scale = hd**-0.5
        self.to_q = Linear(qd, h * hd, **kw)
        self.to_k = Linear(cfg.text_context_dim, h * hd, **kw)
        self.to_v = Linear(cfg.text_context_dim, h * vd, **kw)
        self.out_proj = Linear(h * vd, h * vd, **kw)

    def forward(self, x, text):
        q = split_heads(self.to_q(x), self.heads)
        k = split_heads(self.to_k(text), self.heads)
        v = split_heads(self.to_v(text), self.heads)
        return self.out_proj(merge_heads(sdpa(q, k, v, scale=self.scale)))


class HarmonyAttention(nn.Module):
    def __init__(self, cfg: HarmonyConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.fusion_method != "cross_attention":
            raise ValueError(f"fusion_method {cfg.fusion_method!r} is not ported yet")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.fc1 = Linear(cfg.image_hidden_size, cfg.inter_dim, **kw)
        self.fusion_text_image = CrossAttention(cfg, **kw)
        self.ln = LayerNorm(cfg.flattened_dim, **kw)
        self.fc2 = Linear(cfg.flattened_dim, cfg.image_hidden_size, **kw)

    def forward(self, text_embeds, image_embeds):
        """text_embeds (B, T, text_dim), image_embeds (B, img_dim) -> the
        (B, img_dim) delta added to the image embedding."""
        cfg = self.cfg
        b = image_embeds.shape[0]
        x = self.fc1(image_embeds).reshape(b, cfg.reshape_blocks, cfg.query_dim)
        fused = self.fusion_text_image(x, text_embeds.to(x.dtype))
        return self.fc2(self.ln(fused.reshape(b, -1))) * cfg.scale


def fuse_image_embeds(ha: HarmonyAttention, text_embeds, image_embeds):
    """image_embed + HA(text, image): the composition every call site uses."""
    return image_embeds + ha(text_embeds, image_embeds)
