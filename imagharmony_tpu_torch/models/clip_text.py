"""CLIP text encoders, both SDXL towers (port of
imagharmony_tpu/models/clip_text.py).

HF parameter names (``embeddings.*``, ``encoder.layers.N.*``,
``final_layer_norm``, ``text_projection``). ``forward`` returns the tensors
SDXL consumes: the penultimate hidden state, the final-LN'd last state, the
EOS-pooled state and, for the projection tower, its projection.
"""

from __future__ import annotations

import copy
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


def config_from_transformers(d: dict, *, with_projection=None, **overrides) -> CLIPTextConfig:
    """A CLIPTextConfig from a transformers CLIPTextModel ``config.json``
    dict. ``with_projection`` forces the projection head on or off; None
    keeps it when the architectures list names a WithProjection class.

    The published SD1.5 and SDXL towers' configs say ``eos_token_id: 2``,
    which transformers reads as its legacy rule, pooling at the highest id:
    CLIP's ``<|endoftext|>``, the vocab's last. Here that becomes
    ``vocab_size - 1`` (the JAX package keeps 2, and pools at position 0)."""
    if with_projection is None:
        with_projection = any("WithProjection" in a for a in d.get("architectures") or [])
    vocab_size = int(d.get("vocab_size", 49408))
    eos = int(d.get("eos_token_id", 49407))
    cfg = dict(
        vocab_size=vocab_size,
        hidden_size=int(d.get("hidden_size", 768)),
        num_layers=int(d.get("num_hidden_layers", 12)),
        num_heads=int(d.get("num_attention_heads", 12)),
        intermediate_size=int(d.get("intermediate_size", 3072)),
        max_position_embeddings=int(d.get("max_position_embeddings", 77)),
        hidden_act=d.get("hidden_act", "quick_gelu"),
        projection_dim=int(d["projection_dim"]) if with_projection else None,
        eos_token_id=vocab_size - 1 if eos == 2 else eos,
    )
    cfg.update(overrides)
    return CLIPTextConfig(**cfg)


def config_to_transformers(cfg: CLIPTextConfig) -> dict:
    """The inverse of ``config_from_transformers``."""
    d = {
        "architectures": ["CLIPTextModelWithProjection" if cfg.projection_dim is not None
                          else "CLIPTextModel"],
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "hidden_act": cfg.hidden_act,
        "eos_token_id": cfg.eos_token_id,
    }
    if cfg.projection_dim is not None:
        d["projection_dim"] = cfg.projection_dim
    return d


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

    def forward(self, input_ids, clip_skip: int = 0):
        """input_ids (B, S) -> dict of penultimate (B, S, D), last (B, S, D),
        pooled (B, D) and, with a projection, projected (B, P).

        ``clip_skip`` > 0 conditions on an earlier layer (diffusers'
        clip_skip): ``penultimate`` becomes hidden_states[-(2 + clip_skip)]
        and ``last`` the final layer norm of hidden_states[-(1 + clip_skip)];
        ``pooled`` and ``projected`` come from the whole tower."""
        cfg = self.cfg
        if not 0 <= clip_skip < cfg.num_layers - 1:
            raise ValueError(f"clip_skip must be in [0, {cfg.num_layers - 2}], got {clip_skip}")
        s = input_ids.shape[1]
        x = self.embeddings(input_ids)
        # CLIP text towers are causal
        causal = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        penultimate = skip_hidden = None
        for i, layer in enumerate(self.encoder.layers):
            if i == cfg.num_layers - 1 - clip_skip:
                penultimate = x
            if clip_skip and i == cfg.num_layers - clip_skip:
                skip_hidden = x
            x = layer(x, mask=causal)
        last_full = self.final_layer_norm(x)
        last = self.final_layer_norm(skip_hidden) if clip_skip else last_full
        # EOS pooling: first position holding the EOS token id
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = last_full[torch.arange(last_full.shape[0], device=x.device), eos_pos]
        out = {"penultimate": penultimate, "last": last, "pooled": pooled}
        if self.text_projection is not None:
            out["projected"] = self.text_projection(pooled)
        return out

    def with_token_rows(self, rows):
        """A copy of this tower with ``rows`` (n, D) appended to its token
        table (textual inversion) and the first new id: the table is new,
        every other module is shared."""
        table = self.embeddings.token_embedding.weight
        rows = torch.atleast_2d(torch.as_tensor(rows, dtype=torch.float32))
        if rows.shape[-1] != table.shape[1]:
            raise ValueError(f"embedding dim {rows.shape[-1]} != tower hidden {table.shape[1]}")
        new_table = torch.cat([table, rows.to(table.device, table.dtype)])
        emb = copy.copy(self.embeddings)
        emb._modules = dict(emb._modules)
        emb.token_embedding = nn.Embedding.from_pretrained(new_table, freeze=True)
        tower = copy.copy(self)
        tower._modules = dict(tower._modules)
        tower.embeddings = emb
        tower.cfg = dataclasses.replace(self.cfg, vocab_size=int(new_table.shape[0]))
        return tower, int(table.shape[0])


def encode_for_sdxl(text_l: CLIPTextModel, text_g: CLIPTextModel, ids_l, ids_g,
                    clip_skip: int = 0):
    """The SDXL dual-tower conditioning: concatenated penultimates
    (768 + 1280 -> 2048) and the projected pooled embedding of tower 2."""
    out_l = text_l(ids_l, clip_skip=clip_skip)
    out_g = text_g(ids_g, clip_skip=clip_skip)
    context = torch.cat([out_l["penultimate"], out_g["penultimate"]], dim=-1)
    return context, out_g["projected"]
