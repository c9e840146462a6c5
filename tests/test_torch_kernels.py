"""K1 (imagharmony_tpu_torch/kernels/flash_attention.py).

On the CPU: the plain version against the JAX package's Pallas
``flash_attention_nhd`` run in interpret mode (Sk >= 512, where the JAX
kernel accepts the shape), and the wrapper's routing. On a card (tests
marked ``cuda``, taking the ``cuda`` fixture): the CUDA kernel against the
plain version; they skip without one. The machine with the card has no
JAX, so this module imports JAX only inside the tests that compare with it;
run the card's tests there with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider
"""

import pytest
import torch

from imagharmony_tpu_torch.kernels import build
from imagharmony_tpu_torch.kernels import flash_attention as fa
from torch_port_util import close, cuda, randn, t  # noqa: F401  (cuda is a fixture)


@pytest.fixture()
def jfa(monkeypatch):
    """The JAX package's kernel module, in Pallas interpret mode."""
    from imagharmony_tpu.kernels import flash_attention as jfa

    monkeypatch.setattr(jfa, "_INTERPRET", True)
    return jfa


@pytest.mark.parametrize("s,heads,d", [(512, 2, 64), (512, 4, 32), (600, 2, 64)],
                         ids=["d64", "d32", "odd_s600"])
def test_plain_matches_pallas_interpret(jfa, s, heads, d):
    """fp32, at the per-module tolerance: in fp32 the Pallas kernel's
    clamped no-max exp2 softmax and the true softmax agree to ~1e-6 at
    these inputs."""
    import jax.numpy as jnp

    q, k, v = (randn(i, 1, s, heads * d) for i in range(3))
    ref = jfa.flash_attention_nhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  scale=d**-0.5, head_dim=d)
    assert ref is not None
    out = fa.flash_attention_nhd_plain(t(q), t(k), t(v), scale=d**-0.5, head_dim=d)
    close(out, ref)


def test_wrapper_routes_cpu_to_plain_and_takes_strided_slices():
    """A CPU tensor takes the plain version (no launch counted); q/k/v as
    column views of one packed (B, S, 3*H*D) tensor give the result of
    contiguous copies."""
    qkv = t(randn(3, 2, 70, 3 * 2 * 32))
    q, k, v = qkv.chunk(3, dim=-1)
    assert q.stride(1) == 3 * 2 * 32
    before = fa.launches
    out = fa.flash_attention_nhd(q, k, v, scale=32**-0.5, head_dim=32)
    assert fa.launches == before
    ref = fa.flash_attention_nhd_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                       scale=32**-0.5, head_dim=32)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert out.shape == (2, 70, 64) and out.is_contiguous()


def test_wrapper_raises_off_cpu_and_cuda():
    q = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_nhd(q, q, q, scale=0.125, head_dim=64)


def test_library_path_is_keyed_by_source():
    """The built library's name carries a hash of the source and the flags,
    so an edited source rebuilds instead of loading a stale library."""
    path = build.library_path("flash_attn_nhd")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libflash_attn_nhd-")
    assert path == build.library_path("flash_attn_nhd")


@pytest.mark.cuda
@pytest.mark.parametrize("s,heads,d", [(1024, 20, 64), (1000, 2, 64), (64, 4, 32), (5, 3, 128)])
def test_cuda_kernel_matches_plain(cuda, s, heads, d):
    """bf16 kernel vs the fp32 plain version on the same bf16 inputs, passed
    as strided slices of one packed tensor. Tolerance: bf16 rounding of P
    and of the output."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((2, s, 3 * heads * d), generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    before = fa.launches
    out = fa.flash_attention_nhd(q, k, v, scale=d**-0.5, head_dim=d)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_nhd_plain(q.float(), k.float(), v.float(), scale=d**-0.5,
                                       head_dim=d)
    assert float((out.float() - ref).abs().max()) <= 2e-2
    cos = torch.nn.functional.cosine_similarity(out.float().flatten(), ref.flatten(), dim=0)
    assert float(cos) >= 0.9999


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.zeros((1, 64, 128), device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention_nhd(x, x, x, scale=0.125, head_dim=64)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_nhd(xb, xb, xb, scale=0.125, head_dim=16)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_nhd(xb, xb.cpu(), xb, scale=0.125, head_dim=64)
