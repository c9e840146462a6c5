"""Multi-head attention with a decoupled image-prompt (IP) branch
(port of imagharmony_tpu/nn/attention.py).

* Self-attention goes through the kernels of kernels/flash_attention.py, by
  head dim: K1 on the packed (B, S, H*D) layout at K1's head dims (SDXL's
  64), K4 on head-split (B, H, S, D) views at any other (the SD1.5 family's
  40/80/160). On a CUDA tensor that is the hand-written kernel, on a CPU
  tensor its plain version. With packed projections
  (``pack_inference_params``) q, k and v are column views of one
  (B, S, 3*H*D) ``to_qkv`` output and go to either kernel without a copy.
  When the input needs a gradient (training, downstream of a trainable
  layer) K1's call goes through its autograd Function, whose backward is K3;
  K4's call likewise goes through its Function, whose backward is K3 at
  K4's head dims.
* Every cross-attention (77 text keys) goes through K2
  (kernels/cross_attention.py), text-only or with the IP branch (4, 16 or
  257 keys) fused in: text_attn + ip_scale * ip_attn in one pass over the
  packed q, with k and v as column views of the packed ``to_kv`` output and
  no head split or merge. The JAX package keeps these on XLA, where its K2
  lost on a TPU; the port's plain chain was ~10-20 kernels per call. Its
  gradient is K2's plain-formula backward, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from imagharmony_tpu_torch import dtypes
from imagharmony_tpu_torch.kernels import cross_attention, flash_attention
from imagharmony_tpu_torch.nn.layers import Linear


def split_heads(x, heads):
    b, s, d = x.shape
    return x.reshape(b, s, heads, d // heads).transpose(1, 2)


def merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def sdpa(q, k, v, *, scale=None, mask=None):
    """softmax(q k^T * scale + mask) v with fp32 logits and softmax.

    q: (B, H, Sq, D); k, v: (B, H, Sk, D); mask additive, broadcastable to
    (B, H, Sq, Sk). The probabilities are cast to v's dtype for PV."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    f32 = dtypes.SOFTMAX_DTYPE
    logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.to(f32)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def self_attention(q, k, v, heads):
    """softmax(q k^T / sqrt(D)) v per head on packed (B, S, H*D) tensors (row
    strides free): through K1 at K1's head dims, else through K4 on
    ``split_heads`` views, whose (B, H, S, D) output merges without a copy.
    On CUDA tensors a head dim neither kernel takes raises."""
    head_dim = q.shape[-1] // heads
    scale = head_dim**-0.5
    if head_dim in flash_attention.HEAD_DIMS:
        return flash_attention.flash_attention_nhd(q, k, v, scale=scale, head_dim=head_dim)
    out = flash_attention.flash_attention(
        split_heads(q, heads), split_heads(k, heads), split_heads(v, heads), scale=scale
    )
    return merge_heads(out)


class Attention(nn.Module):
    """The attention layer of the UNets' transformer blocks (diffusers Attention
    parameter names: to_q/to_k/to_v without bias, to_out.0 with bias, plus
    to_k_ip/to_v_ip when ``with_ip``). ``context_dim`` set means
    cross-attention."""

    def __init__(self, query_dim, *, heads, head_dim=None, context_dim=None,
                 with_ip=False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = heads * (head_dim or query_dim // heads)
        ctx = context_dim or query_dim
        self.heads = heads
        self.is_cross = context_dim is not None
        self.to_q = Linear(query_dim, inner, bias=False, **kw)
        self.to_k = Linear(ctx, inner, bias=False, **kw)
        self.to_v = Linear(ctx, inner, bias=False, **kw)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, **kw)])
        if with_ip:
            self.to_k_ip = Linear(ctx, inner, bias=False, **kw)
            self.to_v_ip = Linear(ctx, inner, bias=False, **kw)

    def forward(self, x, context=None, ip_context=None, ip_scale=1.0, collect_ip_probs=None):
        """context=None -> self-attention. ip_context: (B, S_ip, ctx_dim)
        image-prompt tokens for the decoupled branch, weighted by ip_scale:
        a float, a 0-dim fp32 tensor, or a (B,) fp32 vector, one weight a
        row (K2's ``ip_scale``). ``collect_ip_probs``: a list to which the
        IP branch's probabilities softmax(q k_ip^T / sqrt(D)) (B, heads,
        Sq, S_ip), fp32, are appended: computed apart in plain torch, as
        K2 never forms them (the attention-map probe's)."""
        if context is None and hasattr(self, "to_qkv"):
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        elif context is not None and hasattr(self, "to_kv"):
            q = self.to_q(x)
            k, v = self.to_kv(context).chunk(2, dim=-1)
        else:
            ctx = x if context is None else context
            q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)

        if context is None and ip_context is None:
            return self.to_out[0](self_attention(q, k, v, self.heads))

        head_dim = q.shape[-1] // self.heads
        k_ip = v_ip = None
        if ip_context is not None:
            k_ip, v_ip = self.to_k_ip(ip_context), self.to_v_ip(ip_context)
            if collect_ip_probs is not None:
                f32 = dtypes.SOFTMAX_DTYPE
                logits = torch.matmul(split_heads(q, self.heads).to(f32),
                                      split_heads(k_ip, self.heads).to(f32).transpose(-1, -2))
                collect_ip_probs.append(torch.softmax(logits * head_dim**-0.5, dim=-1))
        out = cross_attention.flash_cross_nhd(q, k, v, scale=head_dim**-0.5, head_dim=head_dim,
                                              k_ip=k_ip, v_ip=v_ip, ip_scale=ip_scale)
        return self.to_out[0](out)

    @torch.no_grad()
    def pack_(self):
        """Merge to_q/to_k/to_v into one to_qkv (self-attention) or to_k/to_v
        into to_kv (cross-attention), in place: one wide projection instead
        of three narrow ones. The unpacked modules are removed, so the
        state_dict keys change; pack an inference copy only."""
        if not hasattr(self, "to_k"):  # already packed
            return
        names = ("to_k", "to_v") if self.is_cross else ("to_q", "to_k", "to_v")
        mods = [getattr(self, n) for n in names]
        w = torch.cat([m.weight for m in mods], dim=0)
        packed = Linear(w.shape[1], w.shape[0], bias=False, device=w.device, dtype=w.dtype)
        packed.weight.copy_(w)
        for n in names:
            delattr(self, n)
        setattr(self, "to_kv" if self.is_cross else "to_qkv", packed)


def pack_inference_params(module: nn.Module) -> nn.Module:
    """Pack every Attention under ``module`` in place (see Attention.pack_)
    and return it."""
    for m in module.modules():
        if isinstance(m, Attention):
            m.pack_()
    return module
