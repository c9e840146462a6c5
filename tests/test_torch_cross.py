"""K2, the fused text + IP cross-attention
(imagharmony_tpu_torch/kernels/cross_attention.py), and K3 at K4's head dims
as K4's backward (``FlashAttn`` in kernels/flash_attention.py).

On the CPU, against the JAX package (fp32 on both sides): K2's plain version
against the Pallas ``flash_cross_nhd`` in interpret mode, its five
gradients against ``jax.grad`` of it, the port's cross ``Attention`` with IP
at the SD1.5 head dims, the wiring (every cross-attention of both UNets
reaches K2 on the packed ``to_kv`` views), K2's checks, ``FlashAttn``'s
backward against ``jax.vjp`` of the interpret-mode ``flash_attention``, and
the narrow SD1.5 UNet's gradient with respect to the IP projections.

On a card (tests marked ``cuda``, taking the ``cuda`` fixture): K2 against
its plain version at the UNets' cross shapes, at branches longer than 80
keys and on operands expanded over the batch, ip_scale 0 against the text
branch alone, its gradient, K4's gradient through K3 at head dims
40/80/160, and the launch counters. The machine with
the card has no JAX, so this module imports JAX only inside the tests that
compare with it; run the card's tests there with

    python -m pytest tests/test_torch_cross.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from imagharmony_tpu_torch.io import from_jax
from imagharmony_tpu_torch.kernels import cross_attention as ca
from imagharmony_tpu_torch.kernels import flash_attention as fa
from imagharmony_tpu_torch.models import unet as punet
from imagharmony_tpu_torch.nn import attention as pattn
from imagharmony_tpu_torch.pipelines import components as pcomp
from torch_port_util import close, cuda, load, nchw, randn, t  # noqa: F401  (cuda is a fixture)


@pytest.fixture()
def jfa(monkeypatch):
    """The JAX package's kernel module, in Pallas interpret mode."""
    from imagharmony_tpu.kernels import flash_attention as jfa

    monkeypatch.setattr(jfa, "_INTERPRET", True)
    return jfa


def _cross_case(seed, b, sq, heads, d, sk_ip, sk=77):
    """numpy q, k, v, k_ip, v_ip (k_ip, v_ip None when sk_ip is 0)."""
    hd = heads * d
    q, k, v = randn(seed, b, sq, hd), randn(seed + 1, b, sk, hd), randn(seed + 2, b, sk, hd)
    ip = (randn(seed + 3, b, sk_ip, hd), randn(seed + 4, b, sk_ip, hd)) if sk_ip else (None, None)
    return q, k, v, *ip


def _jnp(*xs):
    import jax.numpy as jnp

    return [None if x is None else jnp.asarray(x) for x in xs]


# --- K2 on the CPU against the JAX package -------------------------------------


@pytest.mark.parametrize("sq,heads,d,sk_ip", [(512, 2, 64, 0), (600, 4, 32, 4), (512, 2, 64, 16)],
                         ids=["d64_text", "d32_ip4_sq600", "d64_ip16"])
def test_k2_plain_matches_pallas_interpret(jfa, sq, heads, d, sk_ip):
    """``flash_cross_nhd_plain`` against the JAX ``flash_cross_nhd`` in Pallas
    interpret mode (Sq >= 512 and heads packing into 128 lanes, which its
    rules need; it pads Sq to 128 and the keys to 128 and masks them), text
    alone and with the IP branch at ip_scale 0.7, which the JAX kernel takes
    folded into v_ip. fp32 at the per-module tolerance: in fp32 its exp2
    softmax is exact."""
    q, k, v, k_ip, v_ip = _cross_case(0, 1, sq, heads, d, sk_ip)
    kw = dict(scale=d**-0.5, head_dim=d)
    ip_scale = 0.7
    jip = {} if k_ip is None else dict(k_ip=_jnp(k_ip)[0], v_ip=_jnp(v_ip * ip_scale)[0])
    ref = jfa.flash_cross_nhd(*_jnp(q, k, v), **kw, **jip)
    assert ref is not None
    tip = {} if k_ip is None else dict(k_ip=t(k_ip), v_ip=t(v_ip), ip_scale=ip_scale)
    out = ca.flash_cross_nhd_plain(t(q), t(k), t(v), **kw, **tip)
    assert out.shape == (1, sq, heads * d)
    close(out, ref)


def test_k2_gradients_match_jax_grad(jfa):
    """The five gradients of K2 through ``FlashCrossNHD`` on CPU tensors
    against ``jax.vjp`` of the interpret-mode JAX ``flash_cross_nhd`` (whose
    backward is ``_flash_cross_ip_bwd`` -> ``_cross_xla_bwd``), with v_ip
    scaled by ip_scale = 0.7 inside the JAX function so d(v_ip) carries the
    factor. fp32; tolerance 1e-4: sums in another order."""
    import jax

    d, heads, sq = 64, 2, 512
    q, k, v, k_ip, v_ip = _cross_case(10, 1, sq, heads, d, 16)
    g = randn(20, 1, sq, heads * d)
    kw = dict(scale=d**-0.5, head_dim=d)

    def f(q, k, v, k_ip, v_ip):
        return jfa.flash_cross_nhd(q, k, v, k_ip=k_ip, v_ip=v_ip * 0.7, **kw)

    _, vjp = jax.vjp(f, *_jnp(q, k, v, k_ip, v_ip))
    ref = vjp(_jnp(g)[0])
    leaves = [t(x).requires_grad_() for x in (q, k, v, k_ip, v_ip)]
    out = ca.flash_cross_nhd(leaves[0], leaves[1], leaves[2], k_ip=leaves[3], v_ip=leaves[4],
                             ip_scale=0.7, **kw)
    assert "FlashCrossNHD" in type(out.grad_fn).__name__
    out.backward(t(g))
    for leaf, r in zip(leaves, ref):
        close(leaf.grad, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d,sk_ip", [(40, 4), (80, 16), (160, 257)],
                         ids=["d40_ip4", "d80_ip16", "d160_ip257"])
def test_cross_attention_with_ip_matches_jax(d, sk_ip):
    """The port's cross ``Attention`` with the IP branch at the SD1.5 head
    dims and the IP key counts of ImageProj, Resampler and MLPProj, against
    the JAX ``attention.attention(..., context=, ip_context=, ip_scale=)``,
    unpacked and packed (k, v as column views of ``to_kv``). fp32, the
    per-module tolerance."""
    import jax.numpy as jnp
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.nn import attention as jattn

    jp = jattn.attention_init(3, 64, heads=2, head_dim=d, context_dim=48, with_ip=True)
    port = load(pattn.Attention(64, heads=2, head_dim=d, context_dim=48, with_ip=True), jp)
    x, ctx, ipc = randn(13, 2, 40, 64), randn(14, 2, 77, 48), randn(15, 2, sk_ip, 48)
    ref = jattn.attention(jp, jnp.asarray(x), heads=2, context=jnp.asarray(ctx),
                          ip_context=jnp.asarray(ipc), ip_scale=0.7, policy=jdt.FP32)
    with torch.no_grad():
        close(port(t(x), context=t(ctx), ip_context=t(ipc), ip_scale=0.7), ref)
        pattn.pack_inference_params(port)
        close(port(t(x), context=t(ctx), ip_context=t(ipc), ip_scale=0.7), ref)


# --- wiring and checks ----------------------------------------------------------


def _unet(cfg):
    gen = torch.Generator().manual_seed(0)
    return pcomp.init_weights_(punet.UNet2DConditionModel(cfg), gen).eval()


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_every_cross_attention_reaches_k2(monkeypatch, family):
    """Each cross-attention of a UNet call (SD1.5: all 16, IP live on each;
    SDXL tiny: IP live on its ip layer only) calls ``flash_cross_nhd`` once,
    with k and v as column views of one packed ``to_kv`` output (shared
    storage, row stride 2*H*D) and the IP projections where the branch is
    live; no plain ``sdpa`` runs on the way."""
    calls = []
    k2 = ca.flash_cross_nhd

    def spy(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return k2(q, k, v, **kw)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain sdpa ran on the cross path")

    monkeypatch.setattr(ca, "flash_cross_nhd", spy)
    monkeypatch.setattr(pattn, "sdpa", refuse)
    if family == "sd15":
        cfg = punet.sd15_config(block_out_channels=(32, 64, 128, 128), cross_attention_dim=24,
                                num_attention_heads=(4, 4, 4, 4), norm_num_groups=8)
        kw = {}
    else:
        cfg = punet.tiny_config()
        kw = dict(pooled_text_embeds=torch.zeros(2, 32), time_ids=torch.zeros(2, 6))
    unet = pattn.pack_inference_params(_unet(cfg))
    n_cross = sum(isinstance(m, pattn.Attention) and m.is_cross for m in unet.modules())
    ctx = t(randn(1, 2, 7, cfg.cross_attention_dim))
    ip = t(randn(2, 2, 4, cfg.cross_attention_dim))
    with torch.no_grad():
        out = unet(t(randn(0, 2, 4, 16, 16)), torch.tensor([10.0, 500.0]), ctx, ip_tokens=ip,
                   ip_scale=0.5, **kw)
    assert torch.isfinite(out).all()
    assert len(calls) == n_cross > 0
    live = [c for c in calls if c[3]["k_ip"] is not None]
    if family == "sd15":
        assert len(live) == n_cross == 16
    else:
        assert 0 < len(live) < n_cross
    for q, k, v, kw_ in calls:
        hd = q.shape[-1]
        assert k.untyped_storage().data_ptr() == v.untyped_storage().data_ptr()
        assert k.stride(1) == v.stride(1) == 2 * hd and k.shape[1] == 7
        assert kw_["head_dim"] in (8, 16, 32) and kw_["scale"] == kw_["head_dim"] ** -0.5
        if kw_["k_ip"] is not None:
            assert kw_["k_ip"].shape == (2, 4, hd) and kw_["ip_scale"] == 0.5


def test_k2_checks_name_k2():
    """What K2 refuses, checked on CPU tensors through the layout check its
    CUDA path runs, and the device check on meta tensors: each message names
    ``flash_cross_nhd``."""
    bf = torch.bfloat16
    q = torch.zeros((2, 64, 2 * 40), dtype=bf)
    kv = torch.zeros((2, 77, 2 * 2 * 40), dtype=bf)
    k, v = kv.chunk(2, dim=-1)
    ip = torch.zeros((2, 4, 2 * 40), dtype=bf)
    ca._check_layout(q, k, v, None, None, 40)
    ca._check_layout(q, k, v, ip, ip, 40)
    with pytest.raises(TypeError, match="flash_cross_nhd: the CUDA kernel takes bf16"):
        ca._check_layout(q.float(), k, v, None, None, 40)
    with pytest.raises(ValueError, match=r"flash_cross_nhd: head_dim 48 not in \(32, 40"):
        ca._check_layout(torch.zeros((2, 64, 96), dtype=bf), k, v, None, None, 48)
    with pytest.raises(ValueError, match=r"flash_cross_nhd: k_ip must be \(2, S, 80\)"):
        ca._check_layout(q, k, v, ip[..., :40], ip, 40)
    with pytest.raises(ValueError, match="flash_cross_nhd: q must have unit stride"):
        ca._check_layout(torch.zeros((2, 80, 64), dtype=bf).transpose(1, 2), k, v, None, None, 40)
    with pytest.raises(ValueError, match="flash_cross_nhd: k's rows must be 16-byte aligned"):
        ca._check_layout(q, torch.zeros((2, 77, 84), dtype=bf)[..., 4:], v, None, None, 40)
    with pytest.raises(ValueError, match="flash_cross_nhd: k_ip and v_ip lengths differ"):
        ca._check_layout(q, k, v, ip, ip[:, :3], 40)
    with pytest.raises(ValueError, match="flash_cross_nhd: k and v are empty"):
        ca._check_layout(q, k[:, :0], v[:, :0], None, None, 40)
    with pytest.raises(ValueError, match="flash_cross_nhd: give both k_ip and v_ip"):
        ca.flash_cross_nhd(q, k, v, scale=1.0, head_dim=40, k_ip=ip)
    meta = torch.empty((1, 8, 80), device="meta", dtype=bf)
    with pytest.raises(ValueError, match="flash_cross_nhd: q, k, v must all be on one CUDA"):
        ca.flash_cross_nhd(meta, meta, meta, scale=1.0, head_dim=40)
    with pytest.raises(ValueError, match="flash_cross_nhd: q, k, v, k_ip, v_ip must all be on"):
        ca.flash_cross_nhd(meta, meta, meta, scale=1.0, head_dim=40, k_ip=meta, v_ip=meta)


def test_k2_on_cpu_is_plain_and_ip_scale_zero_is_text():
    """CPU tensors take the plain version (no launch counted); ip_scale 0
    gives the text branch alone, and zero gradients to the IP keys; a 0-dim
    fp32 tensor ip_scale gives what its float gives, bit for bit; without a
    gradient request there is no Function."""
    q, k, v, k_ip, v_ip = (t(x) for x in _cross_case(30, 2, 70, 2, 40, 4))
    kw = dict(scale=40**-0.5, head_dim=40)
    before = ca.cross_launches
    text = ca.flash_cross_nhd(q, k, v, **kw)
    zero = ca.flash_cross_nhd(q, k, v, k_ip=k_ip, v_ip=v_ip, ip_scale=0.0, **kw)
    # the IP weight as a 0-dim fp32 tensor (what the denoise loop reads from
    # its table) gives the float's output exactly, 0.0 the text branch
    as_float = ca.flash_cross_nhd(q, k, v, k_ip=k_ip, v_ip=v_ip, ip_scale=0.7, **kw)
    as_tensor = ca.flash_cross_nhd(q, k, v, k_ip=k_ip, v_ip=v_ip, ip_scale=torch.tensor(0.7),
                                   **kw)
    zero_tensor = ca.flash_cross_nhd(q, k, v, k_ip=k_ip, v_ip=v_ip, ip_scale=torch.tensor(0.0),
                                     **kw)
    assert ca.cross_launches == before
    torch.testing.assert_close(zero, text, rtol=0, atol=0)
    torch.testing.assert_close(as_tensor, as_float, rtol=0, atol=0)
    torch.testing.assert_close(zero_tensor, text, rtol=0, atol=0)
    assert not torch.equal(as_float, text)
    with pytest.raises(ValueError, match="a tensor ip_scale must be 0-dim fp32"):
        ca._ip_weight(torch.ones(1), torch.device("cpu"))
    assert text.grad_fn is None and text.shape == (2, 70, 80) and text.is_contiguous()
    leaves = [x.clone().requires_grad_() for x in (k_ip, v_ip)]
    ca.flash_cross_nhd(q, k, v, k_ip=leaves[0], v_ip=leaves[1], ip_scale=0.0, **kw).sum().backward()
    assert all(float(x.grad.abs().max()) == 0.0 for x in leaves)


# --- K3 at K4's head dims, through FlashAttn ------------------------------------


@pytest.mark.parametrize("d", [40, 80, 160])
def test_flash_attn_cpu_backward_matches_jax_vjp(jfa, d):
    """``FlashAttn``'s CPU backward (K3's plain head-split formulas) against
    ``jax.vjp`` of the JAX ``flash_attention`` in Pallas interpret mode, whose
    backward is ``_flash_bwd`` -> ``_flash_bwd_impl`` -> ``_attn_bwd_kernel``
    with d zero-padded to 64. Sk = 2048 (its gate for padded head dims),
    B*H = 1, an odd Sq. fp32; tolerance 1e-4: the Pallas kernel's no-max
    exp clamped at 80 is exact at these logits, sums run in another order."""
    import jax

    q, k, v = randn(40, 1, 1, 200, d), randn(41, 1, 1, 2048, d), randn(42, 1, 1, 2048, d)
    g = randn(43, 1, 1, 200, d)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, scale=d**-0.5),
                     *_jnp(q, k, v))
    ref = vjp(_jnp(g)[0])
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, scale=d**-0.5)
    assert "FlashAttn" in type(out.grad_fn).__name__
    out.backward(t(g))
    for leaf, r in zip(leaves, ref):
        close(leaf.grad, r, rtol=1e-4, atol=1e-4)


def test_sd15_unet_ip_gradient_matches_jax_grad():
    """An SD1.5-family UNet cut to one narrow block of one layer, down, mid
    and up (no add-embedding, the IP branch live on all 4 cross-attentions,
    head dim 8, so the self-attentions take K4's path; the cut keeps the JAX
    compile short), fp32: the gradient of sum(out * g) with respect to every
    IP projection (to_k_ip, to_v_ip) against ``jax.grad`` of the JAX
    ``unet.apply``. The gradient runs back through K2's Function and
    FlashAttn (the self-attentions after the first IP layer). Tolerance 2e-4
    absolute and relative: fp32 sums over a deep graph in another order."""
    import jax
    import jax.numpy as jnp
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.models import unet as junet

    kw = dict(block_out_channels=(32,), num_attention_heads=(4,), cross_attention_dim=24,
              norm_num_groups=8, layers_per_block=1, down_block_types=("CrossAttnDownBlock2D",),
              up_block_types=("CrossAttnUpBlock2D",))
    jcfg = junet.sd15_config(**kw)
    jp = junet.init(0, jcfg)
    x = dict(sample=randn(1, 1, 8, 8, 4), timesteps=np.array([500.0], np.float32),
             encoder_hidden_states=randn(2, 1, 5, 24), ip_tokens=randn(3, 1, 4, 24))
    g = randn(4, 1, 8, 8, 4)

    def loss(params):
        out = junet.apply(params, jcfg, **{k: jnp.asarray(v) for k, v in x.items()},
                          ip_scale=0.7, policy=jdt.FP32)
        return jnp.sum(out * jnp.asarray(g))

    ref = from_jax.state_dict(jax.device_get(jax.jit(jax.grad(loss))(jp)))
    port = load(punet.UNet2DConditionModel(punet.sd15_config(**kw)), jp)
    ip_params = {n: p for n, p in port.named_parameters() if "_ip." in n}
    assert len(ip_params) == 2 * 4
    for p in ip_params.values():
        p.requires_grad_(True)
    out = port(nchw(x["sample"]), t(x["timesteps"]), t(x["encoder_hidden_states"]),
               ip_tokens=t(x["ip_tokens"]), ip_scale=0.7)
    (out * nchw(g)).sum().backward()
    for name, p in ip_params.items():
        close(p.grad, ref[name], rtol=2e-4, atol=2e-4)


# --- on the card -----------------------------------------------------------------


def _agree(out, ref, *, max_abs=2e-2, min_cos=0.9999, what=None):
    ref = ref.float()
    err = float((out.float() - ref).abs().max())
    cos = torch.nn.functional.cosine_similarity(out.float().flatten(), ref.flatten(), dim=0)
    assert err <= max_abs and float(cos) >= min_cos, (what, err, float(cos))


def _agree_rel(out, ref, *, max_rel=2e-2, min_cos=0.9995):
    """K3's tolerance: max abs within 2e-2 of the reference's max-abs."""
    _agree(out, ref, max_abs=max_rel * float(ref.float().abs().max()), min_cos=min_cos)


def _card_cross(cuda, b, sq, heads, d, sk_ip, seed=0):
    """bf16 q, k, v (column views of one packed to_kv tensor), k_ip, v_ip."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    q = rnd(b, sq, heads * d)
    k, v = rnd(b, 77, 2 * heads * d).chunk(2, dim=-1)
    ip = (rnd(b, sk_ip, heads * d), rnd(b, sk_ip, heads * d)) if sk_ip else (None, None)
    return q, k, v, *ip


# (B, Sq, H, D, Sk_ip, ip_scale): SDXL's two cross shapes (IP live at S=1024),
# SD1.5's four with IP, the Resampler's 16 and MLPProj's 257 IP keys,
# ip_scale 0, an odd Sq, training's batch 1
K2_CARD_SHAPES = [(2, 4096, 10, 64, 0, 1.0), (2, 1024, 20, 64, 4, 1.0), (2, 1024, 20, 64, 0, 1.0),
                  (2, 4096, 8, 40, 4, 1.0), (2, 1024, 8, 80, 4, 1.0), (2, 256, 8, 160, 4, 1.0),
                  (2, 64, 8, 160, 4, 1.0), (2, 1024, 8, 80, 16, 0.7), (2, 256, 8, 160, 257, 0.7),
                  (2, 1024, 8, 80, 4, 0.0), (2, 1000, 8, 40, 4, 0.5), (1, 1024, 10, 64, 4, 1.0)]


@pytest.mark.cuda
def test_cuda_k2_matches_plain(cuda):
    """bf16 K2 vs the fp32 plain version on the same bf16 inputs (max abs
    2e-2, cosine >= 0.9999: bf16 rounding of P and of the output), one launch
    each: at every shape of ``K2_CARD_SHAPES`` with k and v as views of one
    packed to_kv tensor; at branches of more than 80 keys, which the kernel
    walks in 64-key chunks (MLPProj's 257 IP keys at every head-dim class, a
    200-key text branch, a 130-key IP branch); and with the text and IP keys
    expanded over the batch (batch stride 0, the prompt and image of both
    halves of the CFG pair), which also gives the bits of contiguous copies.
    Then, at the UNets' IP shapes, ip_scale 0 with the IP keys gives the
    text-only call's output bit for bit, also as a 0-dim fp32 tensor on the
    card (the kernel reads the weight from device memory), where 0.7 gives
    the float's output bit for bit; a tensor on another device raises."""
    def check(q, k, v, k_ip, v_ip, ip_scale, what):
        d = what[3]
        kw = dict(scale=d**-0.5, head_dim=d, k_ip=k_ip, v_ip=v_ip, ip_scale=ip_scale)
        before = ca.cross_launches
        out = ca.flash_cross_nhd(q, k, v, **kw)
        torch.cuda.synchronize()
        assert ca.cross_launches == before + 1
        assert out.shape == q.shape and out.is_contiguous() and out.dtype == torch.bfloat16
        f32 = [None if x is None else x.float() for x in (q, k, v, k_ip, v_ip)]
        ref = ca.flash_cross_nhd_plain(f32[0], f32[1], f32[2], scale=d**-0.5, head_dim=d,
                                       k_ip=f32[3], v_ip=f32[4], ip_scale=ip_scale)
        _agree(out, ref, what=what)
        return out

    for b, sq, heads, d, sk_ip, ip_scale in K2_CARD_SHAPES:
        check(*_card_cross(cuda, b, sq, heads, d, sk_ip), ip_scale, (b, sq, heads, d, sk_ip))
    gen = torch.Generator(device=cuda).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    for b, sq, heads, d, sk, sk_ip in [(2, 256, 8, 160, 77, 257), (2, 300, 4, 64, 77, 257),
                                       (1, 128, 2, 40, 77, 257), (2, 100, 2, 80, 200, 4),
                                       (1, 200, 3, 32, 200, 130)]:
        k, v = rnd(b, sk, 2 * heads * d).chunk(2, dim=-1)
        check(rnd(b, sq, heads * d), k, v, rnd(b, sk_ip, heads * d), rnd(b, sk_ip, heads * d),
              0.7, (b, sq, heads, d, sk, sk_ip))
    q = torch.cat([_card_cross(cuda, 1, 1000, 8, 80, 0, seed=6)[0] for _ in range(2)])
    wide = [x.expand(2, -1, -1) for x in _card_cross(cuda, 1, 1000, 8, 80, 4, seed=5)[1:]]
    assert all(x.stride(0) == 0 for x in wide)
    out = check(q, *wide, 0.5, (2, 1000, 8, 80, "expanded"))
    copies = ca.flash_cross_nhd(q, *(x.contiguous() for x in wide[:2]), scale=80**-0.5,
                                head_dim=80, k_ip=wide[2].contiguous(),
                                v_ip=wide[3].contiguous(), ip_scale=0.5)
    assert torch.equal(out, copies)
    for b, sq, heads, d, sk_ip in [(2, 1024, 20, 64, 4), (2, 4096, 8, 40, 4), (2, 256, 8, 160, 4),
                                   (2, 1024, 8, 80, 16), (2, 256, 8, 160, 257)]:
        q, k, v, k_ip, v_ip = _card_cross(cuda, b, sq, heads, d, sk_ip, seed=4)
        kw = dict(scale=d**-0.5, head_dim=d)
        text = ca.flash_cross_nhd(q, k, v, **kw)
        zero = ca.flash_cross_nhd(q, k, v, k_ip=k_ip, v_ip=v_ip, ip_scale=0.0, **kw)
        # the weight from a table on the card, as a captured denoise step reads it
        table = torch.tensor([0.0, 0.7], device=cuda)
        zero_t = ca.flash_cross_nhd(q, k, v, k_ip=k_ip, v_ip=v_ip, ip_scale=table[0], **kw)
        live_t = ca.flash_cross_nhd(q, k, v, k_ip=k_ip, v_ip=v_ip, ip_scale=table[1], **kw)
        live = ca.flash_cross_nhd(q, k, v, k_ip=k_ip, v_ip=v_ip, ip_scale=0.7, **kw)
        torch.cuda.synchronize()
        assert torch.equal(zero, text) and torch.equal(zero_t, text), (b, sq, heads, d, sk_ip)
        assert torch.equal(live_t, live) and not torch.equal(live, text), (b, sq, heads, d, sk_ip)
    with pytest.raises(ValueError, match="a tensor ip_scale must be 0-dim fp32 on cuda"):
        ca.flash_cross_nhd(q, k, v, k_ip=k_ip, v_ip=v_ip, ip_scale=table[1].cpu(), **kw)


@pytest.mark.cuda
def test_cuda_k2_gradient(cuda):
    """On CUDA tensors that need a gradient K2 returns a result with a
    grad_fn (one launch), and its backward (plain formulas on the card)
    equals the fp32 plain backward on the same bf16 inputs."""
    q, k, v, k_ip, v_ip = _card_cross(cuda, 1, 1024, 10, 64, 4, seed=1)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, k_ip, v_ip)]
    dout = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    before = ca.cross_launches
    out = ca.flash_cross_nhd(*leaves[:3], k_ip=leaves[3], v_ip=leaves[4], ip_scale=0.7,
                             scale=0.125, head_dim=64)
    assert out.grad_fn is not None and ca.cross_launches == before + 1
    out.backward(dout)
    ref = ca.flash_cross_nhd_bwd_plain(*(x.float() for x in (q, k, v, k_ip, v_ip)),
                                       dout.float(), scale=0.125, head_dim=64, ip_scale=0.7)
    for leaf, r in zip(leaves, ref):
        _agree_rel(leaf.grad, r)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,heads,d", [(1, 4096, 8, 40), (1, 1024, 8, 80), (1, 256, 8, 160),
                                         (1, 64, 8, 160), (2, 1000, 2, 40), (1, 5, 3, 80),
                                         (2, 100, 2, 128), (2, 300, 2, 32), (1, 256, 4, 64)])
def test_cuda_k4_gradient_goes_through_k3(cuda, monkeypatch, b, s, heads, d):
    """K4 on ``split_heads`` views of a packed to_qkv tensor that needs a
    gradient: a grad_fn, one K4 launch, and a backward that launches K3's
    head-split entry once, never the plain backward, and agrees with the
    fp32 plain backward (each gradient within 2e-2 of the reference's
    max-abs, cosine >= 0.9995: bf16 rounding of P, dS and the outputs)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn((b, s, 3 * heads * d), generator=gen, device=cuda).to(torch.bfloat16)
    dout = torch.randn((b, heads, s, d), generator=gen, device=cuda).to(torch.bfloat16)
    leaf = qkv.detach().clone().requires_grad_()
    q, k, v = (pattn.split_heads(x, heads) for x in leaf.chunk(3, dim=-1))
    k4, k3 = fa.bhsd_launches, fa.bwd_launches
    out = fa.flash_attention(q, k, v, scale=d**-0.5)
    assert out.grad_fn is not None
    plain = fa.flash_attention_bwd_plain

    def refuse(*args, **kwargs):
        raise AssertionError("the plain backward ran on CUDA tensors")

    monkeypatch.setattr(fa, "flash_attention_bwd_plain", refuse)
    out.backward(dout)
    torch.cuda.synchronize()
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", plain)
    assert (fa.bhsd_launches, fa.bwd_launches) == (k4 + 1, k3 + 1)
    views = [pattn.split_heads(x, heads).float() for x in qkv.chunk(3, dim=-1)]
    ref = plain(*views, dout.float(), scale=d**-0.5)
    for grad, r in zip(leaf.grad.chunk(3, dim=-1), ref):
        _agree_rel(pattn.split_heads(grad, heads), r)


@pytest.mark.cuda
def test_cuda_launch_counters_count_cuda_launches_only(cuda):
    """One K2 launch per CUDA call, with or without the IP branch; none for
    CPU tensors; K2's checks raise before anything launches."""
    q, k, v, k_ip, v_ip = _card_cross(cuda, 2, 64, 2, 40, 4)
    before = ca.cross_launches
    ca.flash_cross_nhd(q, k, v, scale=0.1, head_dim=40)
    ca.flash_cross_nhd(q, k, v, scale=0.1, head_dim=40, k_ip=k_ip, v_ip=v_ip)
    ca.flash_cross_nhd(q.cpu(), k.cpu(), v.cpu(), scale=0.1, head_dim=40)
    with pytest.raises(ValueError, match="flash_cross_nhd: head_dim 20"):
        ca.flash_cross_nhd(q, k, v, scale=0.1, head_dim=20)
    with pytest.raises(ValueError, match="CUDA device"):
        ca.flash_cross_nhd(q, k.cpu(), v, scale=0.1, head_dim=40)
    torch.cuda.synchronize()
    assert ca.cross_launches == before + 2
