"""NN primitives (port of imagharmony_tpu/nn/layers.py).

Layout: activations are NCHW inside the models; Linear weights are
(out, in) and conv weights OIHW, with diffusers/HF parameter names, so a
diffusers ``state_dict`` loads without re-keying.

``Linear`` and ``Conv2d`` cast their input to the weight dtype, the role of
``policy.cast`` in the JAX layers: a module moved to bf16 computes in bf16
whatever dtype arrives (e.g. the fp32 timestep embedding).

The TPU dispatch of the JAX layers is not ported: the shifted-9 3x3 conv
allowlist and the subpixel upsample-conv are v5e rewrites of the same math,
here a plain conv2d and nearest-2x upsampling followed by conv2d.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from imagharmony_tpu_torch import dtypes
from imagharmony_tpu_torch.kernels import geglu as kgeglu


class Linear(nn.Linear):
    """``tp_group`` set (``parallel/tp_rules.py``): a row-parallel shard,
    whose partial product is all-reduced over the model group before its
    bias is added, once."""

    tp_group = None

    def forward(self, x):
        if self.tp_group is None:
            return F.linear(x.to(self.weight.dtype), self.weight, self.bias)
        y = F.linear(x.to(self.weight.dtype), self.weight)
        dist.all_reduce(y, group=self.tp_group)
        return y if self.bias is None else y + self.bias


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


# ---------------------------------------------------------------------------
# Normalization: fp32 statistics, centering and scaling in the input dtype
# ---------------------------------------------------------------------------


def layer_norm(x, weight, bias, *, eps=1e-5):
    """LayerNorm over the last axis. The mean and variance accumulate in
    fp32; the centering and scaling stay in x's dtype (as the JAX layer
    does, which never materializes an fp32 copy of x). Returns the weight's
    dtype."""
    dt = x.dtype
    mean = x.mean(dim=-1, keepdim=True, dtype=dtypes.NORM_DTYPE)
    diff = x - mean.to(dt)
    var = (diff * diff).mean(dim=-1, keepdim=True, dtype=dtypes.NORM_DTYPE)
    y = diff * torch.rsqrt(var + eps).to(dt)
    y = y * weight.to(dt) + bias.to(dt)
    return y.to(weight.dtype)


def group_norm(x, weight, bias, *, num_groups, eps=1e-5):
    """GroupNorm over an NCHW (or N, C, ...) tensor, with layer_norm's
    fp32-statistics scheme."""
    dt = x.dtype
    n, c = x.shape[:2]
    grouped = x.reshape(n, num_groups, -1)
    mean = grouped.mean(dim=-1, keepdim=True, dtype=dtypes.NORM_DTYPE)
    diff = grouped - mean.to(dt)
    var = (diff * diff).mean(dim=-1, keepdim=True, dtype=dtypes.NORM_DTYPE)
    y = (diff * torch.rsqrt(var + eps).to(dt)).reshape(x.shape)
    affine = (1, c) + (1,) * (x.dim() - 2)
    y = y * weight.to(dt).reshape(affine) + bias.to(dt).reshape(affine)
    return y.to(weight.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with eps 1e-5 (every LayerNorm of the slice)."""

    def __init__(self, dim, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class GroupNorm(nn.Module):
    def __init__(self, num_groups, channels, *, eps=1e-5, device=None, dtype=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, num_groups=self.num_groups, eps=self.eps)


# ---------------------------------------------------------------------------
# Convolution helpers
# ---------------------------------------------------------------------------


def upsample2x_conv(conv: Conv2d, x):
    """Nearest-2x upsample followed by a 3x3 SAME conv (diffusers
    Upsample2D)."""
    return conv(F.interpolate(x.to(conv.weight.dtype), scale_factor=2.0, mode="nearest"))


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def silu(x):
    return F.silu(x)


def gelu(x):
    # torch.nn.GELU default = exact erf formulation
    return F.gelu(x)


def quick_gelu(x):
    # CLIP-L text tower activation (x * sigmoid(1.702 x))
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"silu": silu, "gelu": gelu, "quick_gelu": quick_gelu}


class GEGLU(nn.Module):
    """SDXL transformer FFN input: proj to 2*inner, then h * gelu(gate).

    The gelu is the tanh approximation when the compute dtype is bf16 (its
    2.6e-3 relative deviation is below bf16 resolution) and the exact erf
    form otherwise, so fp32 parity paths keep the exact form."""

    def __init__(self, dim, inner, *, device=None, dtype=None):
        super().__init__()
        self.proj = Linear(dim, inner * 2, device=device, dtype=dtype)

    def forward(self, x):
        return geglu(self.proj, x)


def geglu(proj: Linear, x):
    """GEGLU over a packed (dim -> 2*inner) projection, through K5
    (kernels/geglu.py): its plain version on the CPU, the fused kernel on
    the card."""
    w = proj.weight
    gelu = "tanh" if w.dtype == torch.bfloat16 else "erf"
    return kgeglu.geglu(x.to(w.dtype), w, proj.bias, gelu=gelu)


# ---------------------------------------------------------------------------
# Timestep (sinusoidal) embedding — diffusers get_timestep_embedding
# ---------------------------------------------------------------------------


def timestep_embedding(timesteps, dim):
    """Sinusoidal embedding of scalar timesteps -> (..., dim), fp32, with
    SDXL's settings (max period 10000, cos first, no frequency shift; dim
    even)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                  device=timesteps.device)
    freqs = torch.exp(exponent / half)
    args = timesteps.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
