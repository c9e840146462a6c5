"""CLIP image embedding -> prompt tokens (port of
imagharmony_tpu/adapters/projections.py).

* ``ImageProjModel`` (``image_proj``): linear, reshape to N tokens, LayerNorm;
* ``MLPProjModel`` (``mlp_proj``): per-patch Linear / GELU / Linear /
  LayerNorm, the IPAdapterFull head.
"""

from __future__ import annotations

from torch import nn

from imagharmony_tpu_torch.nn.layers import LayerNorm, Linear


class ImageProjModel(nn.Module):
    def __init__(self, *, clip_embed_dim=1280, cross_attention_dim=2048, num_tokens=4,
                 device=None, dtype=None):
        super().__init__()
        self.num_tokens = num_tokens
        self.proj = Linear(clip_embed_dim, num_tokens * cross_attention_dim,
                           device=device, dtype=dtype)
        self.norm = LayerNorm(cross_attention_dim, device=device, dtype=dtype)

    def forward(self, image_embeds):
        """(B, clip_dim) -> (B, num_tokens, cross_dim)."""
        x = self.proj(image_embeds).reshape(image_embeds.shape[0], self.num_tokens, -1)
        return self.norm(x)


class MLPProjModel(nn.Module):
    def __init__(self, *, clip_hidden_dim=1664, cross_attention_dim=2048, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.proj = nn.Sequential(
            Linear(clip_hidden_dim, clip_hidden_dim, **kw), nn.GELU(),
            Linear(clip_hidden_dim, cross_attention_dim, **kw),
            LayerNorm(cross_attention_dim, **kw),
        )

    def forward(self, patch_embeds):
        """(B, P, hidden) -> (B, P, cross_dim): one token per patch."""
        return self.proj(patch_embeds)
