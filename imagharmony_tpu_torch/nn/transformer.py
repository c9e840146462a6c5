"""Spatial transformer of the SDXL UNet (port of
imagharmony_tpu/nn/transformer.py): diffusers' Transformer2DModel with
use_linear_projection=True and its BasicTransformerBlocks. Whether the
decoupled IP branch is live is a static flag of the module, set from
UNetConfig.ip_layers when the UNet is built."""

from __future__ import annotations

from torch import nn

from imagharmony_tpu_torch.nn.attention import Attention
from imagharmony_tpu_torch.nn.layers import GEGLU, GroupNorm, LayerNorm, Linear


class FeedForward(nn.Module):
    """diffusers FeedForward: net.0 = GEGLU (net.0.proj), net.1 = dropout,
    net.2 = Linear."""

    def __init__(self, dim, *, device=None, dtype=None):
        super().__init__()
        inner = dim * 4
        self.net = nn.ModuleList([
            GEGLU(dim, inner, device=device, dtype=dtype),
            nn.Identity(),
            Linear(inner, dim, device=device, dtype=dtype),
        ])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, *, heads, head_dim, context_dim, with_ip, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn1 = Attention(dim, heads=heads, head_dim=head_dim, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.attn2 = Attention(dim, heads=heads, head_dim=head_dim,
                               context_dim=context_dim, with_ip=with_ip, **kw)
        self.norm3 = LayerNorm(dim, **kw)
        self.ff = FeedForward(dim, **kw)

    def forward(self, x, context, ip_context=None, ip_scale=1.0, collect_ip_probs=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context, ip_context=ip_context,
                           ip_scale=ip_scale, collect_ip_probs=collect_ip_probs)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GN -> linear in -> blocks -> linear out -> residual, on NCHW input.

    ``ip_active``: feed the IP tokens to this layer's cross-attentions. The
    IP projections exist on every layer where ``with_ip`` (checkpoint
    parity) but are used only where ``ip_active`` is set."""

    def __init__(self, in_channels, *, num_layers, heads, head_dim, context_dim,
                 ip_active=False, with_ip=True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = heads * head_dim
        self.ip_active = ip_active
        # 32 groups whatever the UNet's norm_num_groups, as in the JAX package
        self.norm = GroupNorm(32, in_channels, eps=1e-6, **kw)
        self.proj_in = Linear(in_channels, inner, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads=heads, head_dim=head_dim,
                                  context_dim=context_dim, with_ip=with_ip, **kw)
            for _ in range(num_layers)
        ])
        self.proj_out = Linear(inner, in_channels, **kw)

    def forward(self, x, context, ip_context=None, ip_scale=1.0, collect_ip_probs=None):
        b, c, hgt, wid = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, hgt * wid, c)
        h = self.proj_in(h)
        ip = ip_context if self.ip_active else None
        for block in self.transformer_blocks:
            h = block(h, context, ip_context=ip, ip_scale=ip_scale,
                      collect_ip_probs=collect_ip_probs if ip is not None else None)
        h = self.proj_out(h)
        return h.reshape(b, hgt, wid, c).permute(0, 3, 1, 2) + x
