"""Harmony-Aware (HA) fusion head (port of imagharmony_tpu/adapters/harmony.py):

    delta = fc2(LN(flatten(fuse(reshape(fc1(img)), text)))) * scale
    image_embed <- image_embed + delta

All four fusions: ``cross_attention`` (the shipped config), ``qformer``
(learned queries and a post-LN transformer encoder over [queries, image,
text]), ``mlp`` (mean-pooled modalities through a 3-layer ReLU MLP to N
tokens) and ``gated-attention`` (a sigmoid-gated mix of the pooled
modalities). The LN/fc2 width is the fusion's own output width
(``flattened_dim``), as in the JAX package. The fusions' attentions are a
few tokens wide and run in plain torch (``sdpa``), as the JAX package runs
them outside Pallas.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
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
    qformer_queries: int = 16
    qformer_layers: int = 1
    qformer_ff_dim: int = 2048  # torch TransformerEncoderLayer's default
    mlp_tokens: int = 16
    gate_hidden_dim: int = 512

    @property
    def query_dim(self) -> int:
        return self.inter_dim // self.reshape_blocks

    @property
    def flattened_dim(self) -> int:
        if self.fusion_method == "cross_attention":
            return self.cross_heads * self.cross_value_dim * self.reshape_blocks
        if self.fusion_method == "qformer":
            return self.qformer_queries * self.query_dim
        return self.mlp_tokens * self.query_dim


def legacy_composed_config(**overrides) -> HarmonyConfig:
    """The older Composed_Attention shape (reference shared_models.py:93-122;
    JAX imagharmony_tpu/adapters/harmony.py:83): 4 blocks of 640, 10 heads,
    value dim 32. ``io/checkpoints`` reads its legacy key names."""
    base = dict(inter_dim=2560, reshape_blocks=4, cross_heads=10, cross_value_dim=32)
    base.update(overrides)
    return HarmonyConfig(**base)


def tiny_config(**overrides) -> HarmonyConfig:
    base = dict(image_hidden_size=24, text_context_dim=80, inter_dim=64, cross_heads=2,
                reshape_blocks=4, cross_value_dim=8, qformer_ff_dim=32, gate_hidden_dim=16)
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


class QFormerSelfAttention(nn.Module):
    """torch MultiheadAttention's packed ``in_proj`` (q, k, v rows) and
    ``out_proj``."""

    def __init__(self, d, heads, **kw):
        super().__init__()
        self.heads = heads
        self.in_proj = Linear(d, 3 * d, **kw)
        self.out_proj = Linear(d, d, **kw)

    def forward(self, x):
        q, k, v = (split_heads(t, self.heads) for t in self.in_proj(x).chunk(3, dim=-1))
        return self.out_proj(merge_heads(sdpa(q, k, v)))


class QFormerLayer(nn.Module):
    """torch TransformerEncoderLayer semantics: post-LN, a ReLU FFN."""

    def __init__(self, d, heads, ff_dim, **kw):
        super().__init__()
        self.self_attn = QFormerSelfAttention(d, heads, **kw)
        self.linear1 = Linear(d, ff_dim, **kw)
        self.linear2 = Linear(ff_dim, d, **kw)
        self.norm1 = LayerNorm(d, **kw)
        self.norm2 = LayerNorm(d, **kw)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class QFormerEncoder(nn.Module):
    def __init__(self, cfg: HarmonyConfig, **kw):
        super().__init__()
        self.layers = nn.ModuleList([
            QFormerLayer(cfg.query_dim, cfg.cross_heads, cfg.qformer_ff_dim, **kw)
            for _ in range(cfg.qformer_layers)])


class QFormer(nn.Module):
    """Learned queries and a post-LN transformer encoder over
    concat[queries, image, text], the image and text tokens tagged by a
    modality embedding; the queries' outputs are the fusion's."""

    def __init__(self, cfg: HarmonyConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.query_dim
        self.num_queries = cfg.qformer_queries
        self.query_tokens = nn.Parameter(torch.zeros(1, cfg.qformer_queries, d, **kw))
        self.modality_embed = nn.Embedding(2, d, **kw)
        self.image_proj = Linear(d, d, **kw)
        self.text_proj = Linear(cfg.text_context_dim, d, **kw)
        self.transformer = QFormerEncoder(cfg, **kw)

    def forward(self, x, text):
        img, txt = self.image_proj(x), self.text_proj(text)
        mod = torch.cat([self.modality_embed.weight[0].expand(img.shape[1], -1),
                         self.modality_embed.weight[1].expand(txt.shape[1], -1)])
        kv = torch.cat([img, txt], dim=1) + mod.to(img.dtype)
        queries = self.query_tokens.to(img.dtype).expand(x.shape[0], -1, -1)
        seq = torch.cat([queries, kv], dim=1)
        for layer in self.transformer.layers:
            seq = layer(seq)
        return seq[:, : self.num_queries]


class MLPFusion(nn.Module):
    """Mean-pool both modalities, concat, a 3-layer ReLU MLP -> N tokens."""

    def __init__(self, cfg: HarmonyConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.query_dim
        self.tokens, self.dim = cfg.mlp_tokens, d
        self.image_proj = Linear(d, d, **kw)
        self.text_proj = Linear(cfg.text_context_dim, d, **kw)
        self.mlp = nn.Sequential(Linear(2 * d, d, **kw), nn.ReLU(), Linear(d, d, **kw), nn.ReLU(),
                                 Linear(d, d * cfg.mlp_tokens, **kw))

    def forward(self, x, text):
        h = torch.cat([self.image_proj(x.mean(dim=1)), self.text_proj(text.mean(dim=1))], dim=-1)
        return self.mlp(h).reshape(x.shape[0], self.tokens, self.dim)


class GatedFusion(nn.Module):
    """Sigmoid-gated convex mix alpha·img + (1 - alpha)·txt of the pooled
    modalities, widened to N tokens."""

    def __init__(self, cfg: HarmonyConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.query_dim
        self.tokens, self.dim = cfg.mlp_tokens, d
        self.img_proj = Linear(d, d, **kw)
        self.txt_proj = Linear(cfg.text_context_dim, d, **kw)
        self.fusion = nn.Module()
        self.fusion.gate_mlp = nn.Sequential(Linear(2 * d, cfg.gate_hidden_dim, **kw), nn.ReLU(),
                                             Linear(cfg.gate_hidden_dim, 1, **kw))
        self.dim_transfer = Linear(d, d * cfg.mlp_tokens, **kw)

    def forward(self, x, text):
        img, txt = self.img_proj(x.mean(dim=1)), self.txt_proj(text.mean(dim=1))
        alpha = torch.sigmoid(self.fusion.gate_mlp(torch.cat([img, txt], dim=-1)))
        fused = alpha * img + (1.0 - alpha) * txt
        return self.dim_transfer(fused).reshape(x.shape[0], self.tokens, self.dim)


FUSIONS = {"cross_attention": CrossAttention, "qformer": QFormer, "mlp": MLPFusion,
           "gated-attention": GatedFusion}


class HarmonyAttention(nn.Module):
    def __init__(self, cfg: HarmonyConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.fusion_method not in FUSIONS:
            raise ValueError(f"unknown fusion_method {cfg.fusion_method!r}")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.fc1 = Linear(cfg.image_hidden_size, cfg.inter_dim, **kw)
        self.fusion_text_image = FUSIONS[cfg.fusion_method](cfg, **kw)
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
