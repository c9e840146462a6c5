"""Port (imagharmony_tpu_torch.nn) vs JAX (imagharmony_tpu.nn) on the CPU:
each layer, attention (self, cross, cross+IP) and the transformer blocks,
fp32 on both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagharmony_tpu import dtypes as jdt
from imagharmony_tpu.nn import attention as jattn
from imagharmony_tpu.nn import layers as jl
from imagharmony_tpu.nn import transformer as jtr
from imagharmony_tpu_torch.nn import attention as pattn
from imagharmony_tpu_torch.nn import layers as pl
from imagharmony_tpu_torch.nn import transformer as ptr
from torch_port_util import close, load, nchw, nhwc, randn, t

FP32 = jdt.FP32


def test_linear():
    jp = jl.linear_init(0, 24, 40)
    x = randn(1, 2, 5, 24)
    port = load(pl.Linear(24, 40), jp)
    close(port(t(x)), jl.linear(jp, jnp.asarray(x), policy=FP32))


def test_linear_casts_input_to_weight_dtype():
    lin = pl.Linear(8, 4).to(torch.bfloat16)
    y = lin(t(randn(0, 3, 8)))  # fp32 in
    assert y.dtype == torch.bfloat16


def test_layer_norm():
    x = randn(2, 3, 7, 48) * 3 + 1
    jp = {"weight": randn(3, 48), "bias": randn(4, 48)}
    port = load(pl.LayerNorm(48), jp)
    close(port(t(x)), jl.layer_norm(jp, jnp.asarray(x), policy=FP32))


@pytest.mark.parametrize("groups", [8, 32])
def test_group_norm(groups):
    x = randn(5, 2, 6, 6, 64) * 2 - 0.5  # NHWC for JAX
    jp = {"weight": randn(6, 64), "bias": randn(7, 64)}
    port = load(pl.GroupNorm(groups, 64, eps=1e-6), jp)
    ref = jl.group_norm(jp, jnp.asarray(x), num_groups=groups, eps=1e-6, policy=FP32)
    close(nhwc(port(nchw(x))), ref)


@pytest.mark.parametrize("kernel,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_conv2d(kernel, stride, padding):
    jp = jl.conv2d_init(0, 16, 24, kernel)
    x = randn(8, 2, 10, 10, 16)
    port = load(pl.Conv2d(16, 24, kernel, stride=stride, padding=padding), jp)
    ref = jl.conv2d(jp, jnp.asarray(x), stride=stride, padding=padding, policy=FP32)
    close(nhwc(port(nchw(x))), ref)


def test_upsample2x_conv():
    jp = jl.conv2d_init(1, 16, 16, 3)
    x = randn(9, 2, 5, 6, 16)
    port = load(pl.Conv2d(16, 16, 3, padding=1), jp)
    ref = jl.upsample2x_conv(jp, jnp.asarray(x), policy=FP32)
    close(nhwc(pl.upsample2x_conv(port, nchw(x))), ref)


def test_geglu_fp32_matches_jax():
    jp = jl.linear_init(2, 32, 2 * 64)
    x = randn(10, 2, 5, 32)
    port = load(pl.GEGLU(32, 64), {"proj": jp})
    close(port(t(x)), jl.geglu(jp, jnp.asarray(x), policy=FP32))


def test_geglu_bf16_uses_tanh_gelu():
    """In bf16 the gate uses the tanh-approximate gelu (JAX geglu's
    approximate=None rule); in fp32 the exact erf form."""
    g = pl.GEGLU(16, 32).to(torch.bfloat16)
    x = t(randn(11, 3, 16)).to(torch.bfloat16)
    h, gate = g.proj(x).chunk(2, dim=-1)
    torch.testing.assert_close(g(x), h * torch.nn.functional.gelu(gate, approximate="tanh"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dim", [320, 256, 16])
def test_timestep_embedding(dim):
    """SDXL's widths (320 time, 256 per micro-conditioning id). Tolerance
    1e-4 absolute: at t=999 the fp32 sin/cos argument carries ~6e-5 of
    rounding (one ulp of 999), and XLA and PyTorch round exp() differently."""
    ts = np.array([1.0, 250.0, 999.0], np.float32)
    close(pl.timestep_embedding(t(ts), dim), jl.timestep_embedding(jnp.asarray(ts), dim),
          rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["silu", "gelu", "quick_gelu"])
def test_activations(name):
    x = randn(12, 4, 33) * 3
    close(pl.ACTIVATIONS[name](t(x)), jl.ACTIVATIONS[name](jnp.asarray(x)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn(with_ip=False, context_dim=None):
    jp = jattn.attention_init(3, 64, heads=2, head_dim=32, context_dim=context_dim,
                              with_ip=with_ip)
    port = load(pattn.Attention(64, heads=2, head_dim=32, context_dim=context_dim,
                                with_ip=with_ip), jp)
    return jp, port


def test_self_attention():
    jp, port = _attn()
    x = randn(13, 2, 40, 64)
    close(port(t(x)), jattn.attention(jp, jnp.asarray(x), heads=2, policy=FP32))


def test_self_attention_gradient_goes_through_k1_function():
    """The unpacked self-attention, given an input that needs a gradient,
    reaches K1's autograd Function, and the input's gradient equals JAX's
    vjp."""
    jp, port = _attn()
    x, g = randn(17, 2, 40, 64), randn(18, 2, 40, 64)
    tx = t(x).requires_grad_()
    out = port(tx)
    nodes, seen = [out.grad_fn], set()
    while nodes:
        n = nodes.pop()
        if n is not None and n not in seen:
            seen.add(n)
            nodes.extend(f for f, _ in n.next_functions)
    assert any("FlashAttnNHD" in type(n).__name__ for n in seen)
    out.backward(t(g))
    _, vjp = jax.vjp(lambda x: jattn.attention(jp, x, heads=2, policy=FP32), jnp.asarray(x))
    close(tx.grad, vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("ip_scale", [None, 0.7])
def test_cross_attention(ip_scale):
    """Text cross-attention, and text + ip_scale * IP (ip_scale != 1)."""
    jp, port = _attn(with_ip=True, context_dim=48)
    x, ctx, ipc = randn(14, 2, 40, 64), randn(15, 2, 9, 48), randn(16, 2, 4, 48)
    ip = None if ip_scale is None else ipc
    ref = jattn.attention(jp, jnp.asarray(x), heads=2, context=jnp.asarray(ctx),
                          ip_context=None if ip is None else jnp.asarray(ip),
                          ip_scale=ip_scale or 1.0, policy=FP32)
    out = port(t(x), context=t(ctx), ip_context=None if ip is None else t(ip),
               ip_scale=ip_scale or 1.0)
    close(out, ref)


def test_pack_inference_params_keeps_outputs():
    """Packed to_qkv (self) / to_kv (cross) give the unpacked outputs; the
    cross layer packs by role, even when its widths equal the query's."""
    block = ptr.BasicTransformerBlock(64, heads=2, head_dim=32, context_dim=64, with_ip=True)
    x, ctx, ipc = t(randn(17, 2, 12, 64)), t(randn(18, 2, 5, 64)), t(randn(19, 2, 4, 64))
    with torch.no_grad():
        a1, a2 = block.attn1(x), block.attn2(x, context=ctx, ip_context=ipc, ip_scale=0.5)
        pattn.pack_inference_params(block)
        assert hasattr(block.attn1, "to_qkv") and not hasattr(block.attn1, "to_q")
        assert hasattr(block.attn2, "to_kv") and hasattr(block.attn2, "to_q")
        assert hasattr(block.attn2, "to_k_ip")
        torch.testing.assert_close(block.attn1(x), a1, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(
            block.attn2(x, context=ctx, ip_context=ipc, ip_scale=0.5), a2, rtol=1e-5, atol=1e-6
        )


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


def test_basic_transformer_block():
    jp = jtr.basic_transformer_block_init(4, 64, heads=2, head_dim=32, context_dim=48,
                                          with_ip=True)
    port = load(ptr.BasicTransformerBlock(64, heads=2, head_dim=32, context_dim=48,
                                          with_ip=True), jp)
    x, ctx, ipc = randn(20, 2, 16, 64), randn(21, 2, 7, 48), randn(22, 2, 4, 48)
    block = jax.jit(functools.partial(jtr.basic_transformer_block, heads=2, ip_scale=0.6,
                                      policy=FP32))
    ref = block(jp, jnp.asarray(x), context=jnp.asarray(ctx), ip_context=jnp.asarray(ipc))
    close(port(t(x), t(ctx), ip_context=t(ipc), ip_scale=0.6), ref)


def test_transformer_2d():
    jp = jtr.transformer_2d_init(5, 64, num_layers=2, heads=2, head_dim=32, context_dim=48,
                                 with_ip=True)
    port = load(ptr.Transformer2DModel(64, num_layers=2, heads=2, head_dim=32,
                                       context_dim=48, ip_active=True), jp)
    x, ctx, ipc = randn(23, 2, 4, 5, 64), randn(24, 2, 7, 48), randn(25, 2, 4, 48)
    tr = jax.jit(functools.partial(jtr.transformer_2d, heads=2, ip_scale=0.6, policy=FP32))
    ref = tr(jp, jnp.asarray(x), context=jnp.asarray(ctx), ip_context=jnp.asarray(ipc))
    close(nhwc(port(nchw(x), t(ctx), ip_context=t(ipc), ip_scale=0.6)), ref)
