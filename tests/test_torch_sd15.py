"""The SD1.5 slice of the port (imagharmony_tpu_torch) against the JAX
package on the CPU, fp32 on both sides: K4's plain version against the
Pallas ``flash_attention`` in interpret mode, the self-attention routing by
head dim, the SD1.5 UNet, the Resampler and MLPProj heads, the ViT-H-shaped
vision tower's penultimate and CLIP-L's last state, and the slice as a whole
(the SD1.5 tiny pipeline and the SDXL tiny pipeline with the Plus and Full
heads, per-step latents and image against the JAX pipeline).

On a card (tests marked ``cuda``, taking the ``cuda`` fixture): K4 against
its plain version, and what a gradient request takes. The machine with the card has
no JAX, so this module imports JAX only inside the tests that compare with
it; run the card's tests there with

    python -m pytest tests/test_torch_sd15.py -m cuda --noconftest -p no:cacheprovider
"""

import functools

import numpy as np
import pytest
import torch

from imagharmony_tpu_torch.adapters import resampler as prs
from imagharmony_tpu_torch.adapters.projections import MLPProjModel
from imagharmony_tpu_torch.io import from_jax
from imagharmony_tpu_torch.kernels import flash_attention as fa
from imagharmony_tpu_torch.models import clip_text as pct
from imagharmony_tpu_torch.models import clip_vision as pcv
from imagharmony_tpu_torch.models import unet as punet
from imagharmony_tpu_torch.nn import attention as pattn
from imagharmony_tpu_torch.pipelines import components as pcomp
from imagharmony_tpu_torch.pipelines import harmony_edit as phe
from imagharmony_tpu_torch.utils import parity
from torch_port_util import close, cuda, load, nchw, nhwc, randn, t  # noqa: F401  (cuda is a fixture)


# --- K4: plain version, routing, checks ------------------------------------


@pytest.mark.parametrize("sq,d", [(256, 40), (256, 80), (256, 160), (300, 40)],
                         ids=["d40", "d80", "d160", "odd_sq300"])
def test_k4_plain_matches_pallas_interpret(monkeypatch, sq, d):
    """``flash_attention_plain`` against the JAX ``flash_attention`` in Pallas
    interpret mode at Sk=2048, where its gate admits the padded head dims;
    B*H = 1 (interpret mode is slow). fp32, at the per-module tolerance: the
    kernel's clamped no-max exp2 softmax and the true softmax agree to ~1e-6
    at these inputs."""
    import jax.numpy as jnp
    from imagharmony_tpu.kernels import flash_attention as jfa

    monkeypatch.setattr(jfa, "_INTERPRET", True)
    q, k, v = randn(0, 1, 1, sq, d), randn(1, 1, 1, 2048, d), randn(2, 1, 1, 2048, d)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=d**-0.5)
    assert ref is not None
    close(fa.flash_attention_plain(t(q), t(k), t(v), scale=d**-0.5), ref)


@pytest.mark.parametrize("d,entry", [(40, "K4"), (80, "K4"), (160, "K4"), (8, "K4"),
                                     (32, "K1"), (64, "K1"), (128, "K1")])
def test_self_attention_routes_by_head_dim(monkeypatch, d, entry):
    """K1's head dims go to K1 on the packed layout, every other to K4 on
    ``split_heads`` views of the packed to_qkv output (no copy: the views
    share its storage and have the (S*3HD, D, 3HD, 1) strides); the result
    is the plain attention of contiguous copies either way."""
    heads, s = 2, 24
    seen = []
    k1, k4 = fa.flash_attention_nhd, fa.flash_attention

    def spy_k1(q, k, v, **kw):
        seen.append(("K1", q))
        return k1(q, k, v, **kw)

    def spy_k4(q, k, v, **kw):
        seen.append(("K4", q))
        return k4(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention_nhd", spy_k1)
    monkeypatch.setattr(fa, "flash_attention", spy_k4)
    qkv = t(randn(d, 2, s, 3 * heads * d))
    q, k, v = qkv.chunk(3, dim=-1)
    out = pattn.self_attention(q, k, v, heads)
    assert [name for name, _ in seen] == [entry]
    arg = seen[0][1]
    assert arg.untyped_storage().data_ptr() == qkv.untyped_storage().data_ptr()
    if entry == "K4":
        assert arg.shape == (2, heads, s, d)
        assert arg.stride() == (s * 3 * heads * d, d, 3 * heads * d, 1)
    ref = fa.flash_attention_nhd_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                       scale=d**-0.5, head_dim=d)
    close(out, ref, rtol=1e-6, atol=1e-6)
    assert out.shape == (2, s, heads * d)


def test_k4_wrapper_on_cpu_is_plain_and_differentiable():
    """CPU tensors take the plain version (no launch counted) at any head
    dim, and a gradient request gives autograd's backward of it: equal to
    K3's plain formulas on the packed layout. fp32, tolerance 1e-5."""
    b, h, s, d = 2, 2, 30, 40
    q, k, v = (t(randn(i, b, h, s, d)).requires_grad_() for i in range(3))
    g = t(randn(3, b, h, s, d))
    before = fa.bhsd_launches
    out = fa.flash_attention(q, k, v, scale=d**-0.5)
    assert fa.bhsd_launches == before and out.grad_fn is not None
    out.backward(g)
    packed = [pattn.merge_heads(x.detach()) for x in (q, k, v, g)]
    ref = fa.flash_attention_nhd_bwd_plain(*packed, scale=d**-0.5, head_dim=d)
    for x, r in zip((q, k, v), ref):
        close(pattn.merge_heads(x.grad), r, rtol=1e-5, atol=1e-5)


def test_k4_checks_name_k4_and_its_head_dims():
    """What K4 refuses, checked on CPU tensors through the layout check the
    CUDA path runs, and the device check on a meta tensor: the messages name
    ``flash_attention`` and K4's own head dims."""
    ok = torch.zeros((2, 3, 16, 40), dtype=torch.bfloat16)
    fa._check_bhsd_layout(ok, ok, ok)
    packed = torch.zeros((2, 16, 3 * 3 * 40), dtype=torch.bfloat16)
    fa._check_bhsd_layout(*(pattn.split_heads(x, 3) for x in packed.chunk(3, dim=-1)))
    with pytest.raises(TypeError, match="flash_attention: the CUDA kernel takes bf16"):
        fa._check_bhsd_layout(ok.float(), ok.float(), ok.float())
    bad_d = torch.zeros((2, 3, 16, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"flash_attention: head_dim 48 not in \(32, 40, 64"):
        fa._check_bhsd_layout(bad_d, bad_d, bad_d)
    with pytest.raises(ValueError, match="unit stride"):
        fa._check_bhsd_layout(torch.zeros((2, 3, 40, 16), dtype=torch.bfloat16).transpose(2, 3),
                              ok, ok)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_bhsd_layout(torch.zeros((2, 3, 16, 44), dtype=torch.bfloat16)[..., 4:], ok, ok)
    with pytest.raises(ValueError, match=r"\(B, H, Sq, D\)"):
        fa._check_bhsd_layout(ok, ok[:, :2], ok[:, :2])
    with pytest.raises(ValueError, match="k is empty"):
        fa._check_bhsd_layout(ok, ok[:, :, :0], ok[:, :, :0])
    meta = torch.empty((1, 2, 8, 40), device="meta")
    with pytest.raises(ValueError, match="flash_attention: .* CUDA device"):
        fa.flash_attention(meta, meta, meta, scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160),
                                     (2, 64, 8, 160), (2, 1000, 8, 40), (1, 5, 3, 80)])
@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed_views"])
def test_cuda_k4_matches_plain(cuda, b, s, h, d, packed):
    """bf16 K4 vs the fp32 plain version on the same bf16 inputs, contiguous
    (B, H, S, D) or strided views of one packed to_qkv tensor. Tolerance:
    bf16 rounding of P and of the output."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    if packed:
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=cuda).to(torch.bfloat16)
        q, k, v = (pattn.split_heads(x, h) for x in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda).to(torch.bfloat16)
                   for _ in range(3))
    before = fa.bhsd_launches
    out = fa.flash_attention(q, k, v, scale=d**-0.5)
    torch.cuda.synchronize()
    assert fa.bhsd_launches == before + 1
    assert out.shape == (b, h, s, d) and out.transpose(1, 2).is_contiguous()
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), scale=d**-0.5)
    assert float((out.float() - ref).abs().max()) <= 2e-2
    cos = torch.nn.functional.cosine_similarity(out.float().flatten(), ref.flatten(), dim=0)
    assert float(cos) >= 0.9999


@pytest.mark.cuda
def test_cuda_k4_gradient_request_raises(cuda):
    """A gradient request through K4 on CUDA tensors that K3 does not take
    raises before anything launches, naming the head dim; it never returns
    a tensor without a grad_fn and never runs the plain version. At K4's own
    head dims it gets a grad_fn (K3 is its backward)."""
    x = torch.zeros((1, 8, 64, 40), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    assert fa.flash_attention(x, x, x, scale=40**-0.5).grad_fn is not None
    before = fa.bhsd_launches
    with pytest.raises(ValueError, match="head_dim 48"):
        y = torch.zeros((1, 8, 64, 48), device=cuda, dtype=torch.bfloat16, requires_grad=True)
        fa.flash_attention(y, y, y, scale=1.0)
    assert fa.bhsd_launches == before
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention(x.detach().float(), x.detach().float(), x.detach().float(), scale=1.0)


# --- modules ------------------------------------------------------------------


def _narrow_sd15_unet_kwargs():
    """SD1.5 topology at narrow widths: head dims 8/16/32/32 (the JAX
    sd15_tiny_configs UNet)."""
    return dict(block_out_channels=(32, 64, 128, 128), cross_attention_dim=24,
                num_attention_heads=(4, 4, 4, 4), norm_num_groups=8)


@pytest.fixture(scope="module")
def sd15_unet_case():
    import jax
    import jax.numpy as jnp
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.models import unet as junet

    cfg = junet.sd15_config(**_narrow_sd15_unet_kwargs())
    jp = junet.init(0, cfg)
    inputs = dict(sample=randn(1, 2, 16, 16, 4), timesteps=np.array([999.0, 10.0], np.float32),
                  encoder_hidden_states=randn(2, 2, 5, 24), ip_tokens=randn(4, 2, 4, 24))
    apply = jax.jit(functools.partial(junet.apply, cfg=cfg, policy=jdt.FP32, ip_scale=0.7))
    ref = apply(jp, **{k: jnp.asarray(v) for k, v in inputs.items()})
    return jp, inputs, ref


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_sd15_unet_forward(sd15_unet_case, packed):
    """The four-stage SD1.5 UNet (no add-embedding, IP live on every
    cross-attention, ip_scale != 1, pooled and time ids None) with its skip
    wiring, against ``unet.apply``; packed = the inference packing."""
    jp, x, ref = sd15_unet_case
    cfg = punet.sd15_config(**_narrow_sd15_unet_kwargs())
    assert cfg.is_ip_active("up_blocks.3.attentions.2") and cfg.ip_layers == ("",)
    port = load(punet.UNet2DConditionModel(cfg), jp)
    assert port.add_embedding is None
    if packed:
        pattn.pack_inference_params(port)
    with torch.no_grad():
        out = port(nchw(x["sample"]), t(x["timesteps"]), t(x["encoder_hidden_states"]),
                   pooled_text_embeds=None, time_ids=None, ip_tokens=t(x["ip_tokens"]),
                   ip_scale=0.7)
    close(nhwc(out), ref)


def test_sd15_full_config_matches_jax():
    """The full-width configs field by field, and the head dims K4 serves."""
    import dataclasses
    from imagharmony_tpu.models import clip_vision as jcv
    from imagharmony_tpu.models import unet as junet
    from imagharmony_tpu.pipelines import components as jcomp

    assert dataclasses.asdict(punet.sd15_config()) == dataclasses.asdict(junet.sd15_config())
    assert dataclasses.asdict(pcv.vit_h_config()) == dataclasses.asdict(jcv.vit_h_config())
    cfg = punet.sd15_config()
    assert [cfg.head_dim_for(i) for i in range(4)] == [40, 80, 160, 160]
    ours, theirs = pcomp.sd15_configs(), jcomp.sd15_configs()
    for name in ("unet", "vae", "text_l", "vision"):
        assert dataclasses.asdict(getattr(ours, name)) == dataclasses.asdict(getattr(theirs, name))
    assert (ours.text_g, ours.harmony, ours.family, ours.proj_kind, ours.num_ip_tokens) == (
        theirs.text_g, theirs.harmony, theirs.family, theirs.proj_kind, theirs.num_ip_tokens)
    for make in ("plus_config", "plus_xl_config", "tiny_config"):
        from imagharmony_tpu.adapters import resampler as jrs
        assert dataclasses.asdict(getattr(prs, make)()) == dataclasses.asdict(getattr(jrs, make)())


@pytest.mark.parametrize("overrides", [{}, dict(apply_pos_emb=True, num_latents_mean_pooled=2)],
                         ids=["plain", "pos_emb_mean_pooled"])
def test_resampler(overrides):
    import jax.numpy as jnp
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.adapters import resampler as jrs

    jcfg = jrs.tiny_config(**overrides)
    jp = jrs.init(0, jcfg)
    port = load(prs.Resampler(prs.tiny_config(**overrides)), jp)
    x = randn(7, 2, 17, jcfg.embedding_dim)
    ref = jrs.apply(jp, jcfg, jnp.asarray(x), policy=jdt.FP32)
    with torch.no_grad():
        out = port(t(x))
    assert tuple(out.shape) == (2, jcfg.num_queries + jcfg.num_latents_mean_pooled,
                                jcfg.output_dim)
    close(out, ref)


def test_mlp_proj():
    import jax.numpy as jnp
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.adapters import projections as jproj

    jp = jproj.mlp_proj_init(0, clip_hidden_dim=32, cross_attention_dim=24)
    port = load(MLPProjModel(clip_hidden_dim=32, cross_attention_dim=24), jp)
    x = randn(8, 2, 17, 32)
    ref = jproj.mlp_proj(jp, jnp.asarray(x), policy=jdt.FP32)
    with torch.no_grad():
        close(port(t(x)), ref)


def test_vision_penultimate_and_text_last():
    """What the SD1.5 family reads: the vision tower's penultimate patch
    features (ViT-H's shape at a narrow width: 16 heads, no extra
    projection width) and CLIP-L's final-LN'd last hidden state."""
    import jax.numpy as jnp
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.models import clip_text as jct
    from imagharmony_tpu.models import clip_vision as jcv

    kw = dict(hidden_size=64, num_heads=16, num_layers=3, intermediate_size=128,
              projection_dim=20)
    jcfg = jcv.tiny_config(**kw)
    jp = jcv.init(0, jcfg)
    port = load(pcv.CLIPVisionModelWithProjection(pcv.tiny_config(**kw)), jp)
    px = randn(9, 2, 28, 28, 3)
    ref = jcv.apply(jp, jcfg, jnp.asarray(px), policy=jdt.FP32)
    with torch.no_grad():
        out = port(t(px))
    for key in ("penultimate", "projected"):
        close(out[key], ref[key])

    tcfg = jct.tiny_config(hidden_size=24, num_heads=4)
    tp = jct.init(1, tcfg)
    tower = load(pct.CLIPTextModel(pct.tiny_config(hidden_size=24, num_heads=4)), tp)
    ids = np.random.default_rng(2).integers(0, 998, (2, 16))
    ids[:, -1] = tcfg.eos_token_id
    tref = jct.apply(tp, tcfg, jnp.asarray(ids), policy=jdt.FP32)
    with torch.no_grad():
        close(tower(t(ids))["last"], tref["last"])


# --- the slice as a whole -------------------------------------------------------


def _image():
    return np.random.default_rng(0).integers(0, 255, (40, 40, 3), dtype=np.uint8)


def _pipes(kind):
    """(JAX tiny pipeline, the port over the same weights), fp32 on the CPU,
    for "sd15" or an SDXL tiny pipeline with the given proj_kind."""
    import jax
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.pipelines import HarmonyPipeline as JaxPipeline

    if kind == "sd15":
        jpipe = JaxPipeline.random_tiny_sd15(seed=0)
        cfgs = pcomp.sd15_tiny_configs(vocab_size=len(jpipe.tokenizers.tok1.encoder))
    else:
        jpipe = JaxPipeline.random_tiny(seed=0, proj_kind=kind)
        cfgs = pcomp.tiny_configs(vocab_size=len(jpipe.tokenizers.tok1.encoder), proj_kind=kind)
    jpipe.policy = jdt.FP32
    sd = from_jax.state_dict(jax.device_get(jpipe.params))
    return jpipe, phe.HarmonyPipeline.from_state_dict(sd, cfgs, device="cpu"), sd


@pytest.mark.parametrize("kind", ["sd15", "resampler", "mlp_proj"])
def test_tiny_pipeline_matches_jax(kind):
    """The whole slice: weights carried across with io/from_jax (no missing
    or unexpected key), the same initial noise, every per-step latent and
    the decoded image at cosine > 0.9999 against the JAX pipeline's
    capture."""
    from imagharmony_tpu.io import hf_import
    from imagharmony_tpu.utils import parity as jparity

    jpipe, port, sd = _pipes(kind)
    assert set(sd) == set(hf_import.export_tree(jpipe.params))
    assert port.cfgs.family == ("sd15" if kind == "sd15" else "sdxl")
    if kind == "sd15":
        assert port.components.harmony is None and port.components.text_encoder_2 is None
    noise = randn(11, 1, 8, 8, 4)
    kw = dict(prompt="a dog", steps=3, height=32, width=32, noise=noise)
    ref = jparity.run_capture(jpipe, _image(), **kw)
    cap = parity.run_capture(port, _image(), **kw)
    rep = parity.compare(cap, ref)
    assert len(rep["per_step_cosine"]) == 4
    assert rep["min_cosine"] > 0.9999, rep
    assert rep["image_cosine"] > 0.9999, rep


def test_sd15_conditioning_matches_jax():
    """CFG-packed SD1.5 conditioning with num_samples=2: the context is
    CLIP-L's last state, pooled and time ids are None, the unconditional IP
    tokens come from a zeroed embedding."""
    import jax
    import jax.numpy as jnp
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.pipelines import harmony_edit as jhe

    jpipe, port, _ = _pipes("sd15")
    ids_j, ids_p = {}, {}
    for name, text in (("pos", "a dog"), ("neg", "lowres")):
        ids_j[f"{name}_l"], ids_j[f"{name}_g"] = jpipe._tokenize(text)
        ids_p[f"{name}_l"], ids_p[f"{name}_g"] = port._tokenize(text)
    px = port._pixel_values(_image())
    build = jax.jit(functools.partial(
        jhe.build_conditioning, cfgs=jpipe.cfgs, opts=jhe.EditOptions(height=32, width=32),
        num_samples=2, policy=jdt.FP32))
    ref = build(jpipe.params, ids=ids_j, pixel_values=jnp.asarray(px.numpy()))
    with torch.no_grad():
        out = phe.build_conditioning(port.components, phe.EditOptions(height=32, width=32),
                                     ids_p, px, num_samples=2)
    assert out[1] is None and out[2] is None and ref[1] is None and ref[2] is None
    for i in (0, 3):
        assert tuple(out[i].shape) == tuple(ref[i].shape)
        close(out[i], ref[i])


def test_sd15_generate_and_scale():
    """generate() of the SD1.5 tiny pipeline on the CPU: uint8 (1, H, W, 3),
    deterministic for a seed, and the IP scale matters (the branch is live
    on every cross-attention)."""
    pipe = phe.HarmonyPipeline.random_tiny_sd15(seed=0, device="cpu")
    kw = dict(prompt="a dog", num_inference_steps=2, height=32, width=32, seed=7)
    a = pipe.generate(_image(), scale=1.0, **kw)
    b = pipe.generate(_image(), scale=1.0, **kw)
    c = pipe.generate(_image(), scale=0.0, **kw)
    assert a.shape == (1, 32, 32, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - c.astype(int)).max() > 0


@pytest.mark.parametrize("kind", ["resampler", "mlp_proj"])
def test_generate_with_plus_and_full_heads(kind):
    """random_tiny(proj_kind=...) end to end: the tokens come from the
    penultimate patch features (4 queries for the resampler, one per patch
    and the class token for the MLP head), the output is finite."""
    pipe = phe.HarmonyPipeline.random_tiny(seed=0, proj_kind=kind, device="cpu")
    px = pipe._pixel_values(_image())
    with torch.no_grad():
        cond, uncond = phe.image_prompt_tokens(pipe.components, px, None)
    n_tokens = 4 if kind == "resampler" else pipe.cfgs.vision.num_positions
    assert cond.shape == uncond.shape == (1, n_tokens, pipe.cfgs.unet.cross_attention_dim)
    assert not torch.equal(cond, uncond)
    raw = pipe.generate(_image(), prompt="a dog", num_inference_steps=2, height=32, width=32,
                        seed=1, output_type="raw")
    assert raw.shape == (1, 32, 32, 3) and torch.isfinite(raw).all()
