"""CLIP text encoders, both SDXL towers (port of
imagharmony_tpu/models/clip_text.py).

HF parameter names (``embeddings.*``, ``encoder.layers.N.*``,
``final_layer_norm``, ``text_projection``). ``forward`` returns the tensors
SDXL consumes: the penultimate hidden state, the final-LN'd last state, the
EOS-pooled state and, for the projection tower, its projection.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from imagharmony_tpu_torch.nn import layers
from imagharmony_tpu_torch.nn.attention import merge_heads, sdpa, split_heads
from imagharmony_tpu_torch.nn.layers import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = None  # set for the WithProjection tower
    eos_token_id: int = 49407


def clip_l_config() -> CLIPTextConfig:
    return CLIPTextConfig()


def clip_bigg_config() -> CLIPTextConfig:
    return CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                          intermediate_size=5120, hidden_act="gelu", projection_dim=1280)


def tiny_config(**overrides) -> CLIPTextConfig:
    base = dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_position_embeddings=16, eos_token_id=999)
    base.update(overrides)
    return CLIPTextConfig(**base)


class CLIPAttention(nn.Module):
    def __init__(self, d, heads, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.heads = heads
        self.q_proj = Linear(d, d, **kw)
        self.k_proj = Linear(d, d, **kw)
        self.v_proj = Linear(d, d, **kw)
        self.out_proj = Linear(d, d, **kw)

    def forward(self, x, mask=None):
        q, k, v = (split_heads(p(x), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(merge_heads(sdpa(q, k, v, mask=mask)))


class CLIPMLP(nn.Module):
    def __init__(self, d, inter, act, *, device=None, dtype=None):
        super().__init__()
        self.act = layers.ACTIVATIONS[act]
        self.fc1 = Linear(d, inter, device=device, dtype=dtype)
        self.fc2 = Linear(inter, d, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, d, inter, heads, act, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1 = LayerNorm(d, **kw)
        self.self_attn = CLIPAttention(d, heads, **kw)
        self.layer_norm2 = LayerNorm(d, **kw)
        self.mlp = CLIPMLP(d, inter, act, **kw)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask=mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                             cfg.hidden_act, device=device, dtype=dtype)
            for _ in range(cfg.num_layers)
        ])


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None, dtype=None):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            device=device, dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                               device=device, dtype=dtype)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embeddings = CLIPTextEmbeddings(cfg, **kw)
        self.encoder = CLIPEncoder(cfg, **kw)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, **kw)
        self.text_projection = (
            Linear(cfg.hidden_size, cfg.projection_dim, bias=False, **kw)
            if cfg.projection_dim else None
        )

    def forward(self, input_ids):
        """input_ids (B, S) -> dict of penultimate (B, S, D), last (B, S, D),
        pooled (B, D) and, with a projection, projected (B, P)."""
        cfg = self.cfg
        s = input_ids.shape[1]
        x = self.embeddings(input_ids)
        # CLIP text towers are causal
        causal = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        penultimate = None
        for i, layer in enumerate(self.encoder.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, mask=causal)
        last = self.final_layer_norm(x)
        # EOS pooling: first position holding the EOS token id
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos_pos]
        out = {"penultimate": penultimate, "last": last, "pooled": pooled}
        if self.text_projection is not None:
            out["projected"] = self.text_projection(pooled)
        return out


def encode_for_sdxl(text_l: CLIPTextModel, text_g: CLIPTextModel, ids_l, ids_g):
    """The SDXL dual-tower conditioning: concatenated penultimates
    (768 + 1280 -> 2048) and the projected pooled embedding of tower 2."""
    out_l = text_l(ids_l)
    out_g = text_g(ids_g)
    context = torch.cat([out_l["penultimate"], out_g["penultimate"]], dim=-1)
    return context, out_g["projected"]
