"""ImageProjModel: CLIP image embedding -> prompt tokens (port of
``image_proj`` in imagharmony_tpu/adapters/projections.py): linear,
reshape to N tokens, LayerNorm. The IPAdapterFull MLP head is not ported
yet."""

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
