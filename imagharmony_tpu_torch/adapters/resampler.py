"""Perceiver-style image-token resampler, the IPAdapterPlus head (port of
imagharmony_tpu/adapters/resampler.py).

Learned latent queries attend to CLIP penultimate patch features over
``depth`` attention + feed-forward blocks with residuals:

* keys and values are computed over concat(x, latents);
* the logits are (q * d^-1/4)(k * d^-1/4)^T, the fp16 stability trick of the
  reference module, kept so that its checkpoints give the same numbers;
* optional positional embedding and mean-pooled extra latents.

Parameter names are the JAX tree's in exported form: ``latents``,
``proj_in``, ``proj_out``, ``norm_out``, ``layers.N.0`` (attention:
``norm1``, ``norm2``, ``to_q``, ``to_kv``, ``to_out.0``) and ``layers.N.1``
(feed-forward: ``0`` LayerNorm, ``1`` Linear, ``3`` Linear).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from imagharmony_tpu_torch.nn.attention import merge_heads, split_heads
from imagharmony_tpu_torch.nn.layers import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 1280
    depth: int = 4
    dim_head: int = 64
    heads: int = 20
    num_queries: int = 16
    embedding_dim: int = 1664
    output_dim: int = 2048
    ff_mult: int = 4
    max_seq_len: int = 257
    apply_pos_emb: bool = False
    num_latents_mean_pooled: int = 0


def plus_config(cross_attention_dim=768, clip_hidden_size=1280, num_tokens=16) -> ResamplerConfig:
    """IPAdapterPlus (SD1.5): dim = cross-attention width, depth 4, 12 heads."""
    return ResamplerConfig(
        dim=cross_attention_dim, depth=4, dim_head=64, heads=12,
        num_queries=num_tokens, embedding_dim=clip_hidden_size,
        output_dim=cross_attention_dim, ff_mult=4,
    )


def plus_xl_config(clip_hidden_size=1664, num_tokens=16) -> ResamplerConfig:
    """IPAdapterPlusXL: dim 1280, 20 heads, output 2048."""
    return ResamplerConfig(
        dim=1280, depth=4, dim_head=64, heads=20,
        num_queries=num_tokens, embedding_dim=clip_hidden_size,
        output_dim=2048, ff_mult=4,
    )


def tiny_config(**overrides) -> ResamplerConfig:
    base = dict(dim=32, depth=2, dim_head=8, heads=4, num_queries=4,
                embedding_dim=24, output_dim=40, ff_mult=2)
    base.update(overrides)
    return ResamplerConfig(**base)


class PerceiverAttention(nn.Module):
    def __init__(self, cfg: ResamplerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = cfg.dim_head * cfg.heads
        self.heads = cfg.heads
        self.scale = cfg.dim_head**-0.25
        self.norm1 = LayerNorm(cfg.dim, **kw)
        self.norm2 = LayerNorm(cfg.dim, **kw)
        self.to_q = Linear(cfg.dim, inner, bias=False, **kw)
        self.to_kv = Linear(cfg.dim, inner * 2, bias=False, **kw)
        self.to_out = nn.ModuleList([Linear(inner, cfg.dim, bias=False, **kw)])

    def forward(self, x, latents):
        """x: (B, P, dim) image features; latents: (B, L, dim) -> (B, L, dim)."""
        xn, ln = self.norm1(x), self.norm2(latents)
        q = split_heads(self.to_q(ln), self.heads)
        k, v = (split_heads(t, self.heads)
                for t in self.to_kv(torch.cat([xn, ln], dim=-2)).chunk(2, dim=-1))
        # fp32 logits from the operands scaled in their own dtype
        w = torch.matmul((q * self.scale).float(), (k * self.scale).float().transpose(-1, -2))
        out = torch.matmul(torch.softmax(w, dim=-1).to(v.dtype), v)
        return self.to_out[0](merge_heads(out))


def _feed_forward(dim, mult, *, device=None, dtype=None):
    kw = dict(device=device, dtype=dtype)
    return nn.Sequential(LayerNorm(dim, **kw), Linear(dim, dim * mult, bias=False, **kw),
                         nn.GELU(), Linear(dim * mult, dim, bias=False, **kw))


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.latents = nn.Parameter(torch.empty(1, cfg.num_queries, cfg.dim, **kw))
        self.proj_in = Linear(cfg.embedding_dim, cfg.dim, **kw)
        self.proj_out = Linear(cfg.dim, cfg.output_dim, **kw)
        self.norm_out = LayerNorm(cfg.output_dim, **kw)
        self.layers = nn.ModuleList([
            nn.ModuleList([PerceiverAttention(cfg, **kw),
                           _feed_forward(cfg.dim, cfg.ff_mult, **kw)])
            for _ in range(cfg.depth)
        ])
        self.pos_emb = (nn.Embedding(cfg.max_seq_len, cfg.embedding_dim, **kw)
                        if cfg.apply_pos_emb else None)
        self.to_latents_from_mean_pooled_seq = (
            nn.Sequential(LayerNorm(cfg.dim, **kw),
                          Linear(cfg.dim, cfg.dim * cfg.num_latents_mean_pooled, **kw))
            if cfg.num_latents_mean_pooled > 0 else None
        )

    def forward(self, x):
        """x (B, P, embedding_dim) CLIP patch features ->
        (B, num_queries [+ mean_pooled], output_dim) prompt tokens."""
        b = x.shape[0]
        if self.pos_emb is not None:
            x = x + self.pos_emb(torch.arange(x.shape[1], device=x.device))[None]
        latents = self.latents.expand(b, -1, -1)
        x = self.proj_in(x)
        if self.to_latents_from_mean_pooled_seq is not None:
            extra = self.to_latents_from_mean_pooled_seq(x.mean(dim=1))
            extra = extra.reshape(b, self.cfg.num_latents_mean_pooled, self.cfg.dim)
            latents = torch.cat([extra, latents], dim=-2)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return self.norm_out(self.proj_out(latents))
