"""Port (imagharmony_tpu_torch.models/adapters/schedulers) vs JAX on the
CPU at the tiny configs, fp32 on both sides: the UNet forward (the SDXL
base and the refiner) and its encoder propagation, the ControlNet's
residuals, the VAE encode and decode (tiled too), both CLIP text towers
(with clip_skip), the CLIP vision tower, the four HA fusions with
ImageProjModel and their adapter files, every sampler's schedule and step,
and the training forward process."""

import copy
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagharmony_tpu import dtypes as jdt
from imagharmony_tpu.adapters import harmony as jha
from imagharmony_tpu.adapters import projections as jproj
from imagharmony_tpu.models import controlnet as jcn
from imagharmony_tpu.models import clip_text as jct
from imagharmony_tpu.models import clip_vision as jcv
from imagharmony_tpu.models import unet as junet
from imagharmony_tpu.models import vae as jvae
from imagharmony_tpu.schedulers import diffusion as jsched
from imagharmony_tpu_torch.adapters import harmony as pha
from imagharmony_tpu_torch.adapters.projections import ImageProjModel
from imagharmony_tpu_torch.models import clip_text as pct
from imagharmony_tpu_torch.models import clip_vision as pcv
from imagharmony_tpu_torch.models import controlnet as pcn
from imagharmony_tpu_torch.models import unet as punet
from imagharmony_tpu_torch.models import vae as pvae
from imagharmony_tpu_torch.nn.attention import pack_inference_params
from imagharmony_tpu_torch.schedulers import diffusion as psched
from torch_port_util import (close, edit_parity, load, nchw, nhwc, nonzero_controlnet_outputs,
                             randn, t, tiny_pipes)

FP32 = jdt.FP32


@pytest.fixture(scope="module")
def unet_case():
    """Tiny SDXL UNet weights, inputs and the JAX output (computed once)."""
    cfg = junet.tiny_config()
    jp = junet.init(0, cfg)
    inputs = dict(
        sample=randn(1, 2, 8, 8, 4), timesteps=np.array([999.0, 10.0], np.float32),
        encoder_hidden_states=randn(2, 2, 5, 64), pooled_text_embeds=randn(3, 2, 32),
        time_ids=np.tile(np.array([[32, 32, 0, 0, 32, 32]], np.float32), (2, 1)),
        ip_tokens=randn(4, 2, 4, 64),
    )
    apply = jax.jit(functools.partial(junet.apply, cfg=cfg, policy=FP32, ip_scale=0.7))
    ref = apply(jp, **{k: jnp.asarray(v) for k, v in inputs.items()})
    return jp, inputs, ref


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_unet_forward(unet_case, packed):
    """The tiny SDXL UNet (text_time micro-conditioning, IP live on
    down_blocks.2.attentions.1, ip_scale != 1); packed = the inference
    packing the pipeline runs. Unpacked, also the tiny refiner UNet (four
    stages, the aesthetic time ids, no IP); packed, also the ControlNet's
    residuals (its output convs non-zero, conditioning scale 0.7; through
    the UNet in the pipeline tests' ControlNet edit)."""
    jp, x, ref = unet_case
    port = load(punet.UNet2DConditionModel(punet.tiny_config()), jp)
    if packed:
        pack_inference_params(port)
    with torch.no_grad():
        out = port(nchw(x["sample"]), t(x["timesteps"]), t(x["encoder_hidden_states"]),
                   pooled_text_embeds=t(x["pooled_text_embeds"]), time_ids=t(x["time_ids"]),
                   ip_tokens=t(x["ip_tokens"]), ip_scale=0.7)
    close(nhwc(out), ref)
    if not packed:
        from imagharmony_tpu.pipelines import components as jcomp
        from imagharmony_tpu_torch.pipelines import components as pcomp

        rcfg = jcomp.sdxl_refiner_tiny_configs().unet
        assert dataclasses.asdict(rcfg) == dataclasses.asdict(
            pcomp.sdxl_refiner_tiny_configs().unet)
        jr = junet.init(0, rcfg)
        inp = dict(sample=randn(40, 2, 16, 16, 4), timesteps=x["timesteps"],
                   encoder_hidden_states=randn(41, 2, 5, 40),
                   pooled_text_embeds=randn(42, 2, 40),
                   time_ids=np.tile(np.array([[32, 32, 0, 0, 6]], np.float32), (2, 1)))
        ref = jax.jit(functools.partial(junet.apply, cfg=rcfg, policy=FP32))(
            jr, **{k: jnp.asarray(v) for k, v in inp.items()})
        refiner = load(punet.UNet2DConditionModel(pcomp.sdxl_refiner_tiny_configs().unet), jr)
        with torch.no_grad():
            out = refiner(nchw(inp["sample"]), t(inp["timesteps"]),
                          t(inp["encoder_hidden_states"]),
                          pooled_text_embeds=t(inp["pooled_text_embeds"]),
                          time_ids=t(inp["time_ids"]))
        close(nhwc(out), ref)
        return
    ccfg = jcn.tiny_config()
    jc = nonzero_controlnet_outputs(jcn.init(0, ccfg), 5)
    cn = pack_inference_params(load(pcn.ControlNetModel(pcn.tiny_config()), jc))
    cond = np.random.default_rng(6).random((2, 16, 16, 3)).astype(np.float32)
    args = [x[k] for k in ("sample", "timesteps", "encoder_hidden_states")] + [cond]
    kw = {k: x[k] for k in ("pooled_text_embeds", "time_ids")}
    ref_down, ref_mid = jax.jit(lambda p, a, k: jcn.apply(
        p, ccfg, *a, conditioning_scale=0.7, policy=FP32, **k))(
        jc, [jnp.asarray(a) for a in args], {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        down, mid = cn(nchw(args[0]), t(args[1]), t(args[2]), nchw(cond),
                       conditioning_scale=0.7, **{k: t(v) for k, v in kw.items()})
    assert len(down) == len(ref_down) == len(pcn.skip_channels(ccfg.base))
    for a, b in zip(down, ref_down):
        close(nhwc(a), b)
    close(nhwc(mid), ref_mid)
    assert float(nhwc(mid).std()) > 0.1  # the residuals are not zero


def test_unet_encoder_propagation_not_ported(unet_case):
    """Encoder propagation, now ported: ``return_encoder`` gives JAX's
    output and the (skip stack, mid-block input) pair, one skip a resnet and
    a downsampler and conv_in's; ``encoder_override`` runs the mid block
    and the decoder on them, whatever the sample (the encoder is skipped),
    to JAX's output. Then the pipeline's encoder_interval 2, with prompt
    weighting and tile_vae, against the JAX package's generate(), every
    step and the image at cosine > 0.9999."""
    jp, x, ref = unet_case
    port = load(punet.UNet2DConditionModel(punet.tiny_config()), jp)
    pack_inference_params(port)
    kw = dict(pooled_text_embeds=t(x["pooled_text_embeds"]), time_ids=t(x["time_ids"]),
              ip_tokens=t(x["ip_tokens"]), ip_scale=0.7)
    args = (t(x["timesteps"]), t(x["encoder_hidden_states"]))
    with torch.no_grad():
        eps, (stack, mid) = port(nchw(x["sample"]), *args, return_encoder=True, **kw)
        other = port(nchw(randn(30, 2, 8, 8, 4)), *args, encoder_override=(stack, mid), **kw)
    close(nhwc(eps), ref)
    cfg = punet.tiny_config()
    assert len(stack) == 1 + len(cfg.down_block_types) * (cfg.layers_per_block + 1) - 1
    assert mid.shape == (2, cfg.block_out_channels[-1], 2, 2)
    close(nhwc(other), ref)

    jpipe, pipe = tiny_pipes()
    image = np.random.default_rng(0).integers(0, 255, (48, 48, 3), dtype=np.uint8)
    edit_parity(jpipe, pipe, image, steps=4, encoder_interval=2, prompt_weighting=True,
                prompt="a (dog:1.4) on [grass]", negative_prompt="(lowres:0.8)", tile_vae=True)


def test_vae_decode():
    """Tiny VAE decode incl. the mid-block attention."""
    cfg = jvae.tiny_config()
    jp = jvae.init(0, cfg)
    port = load(pvae.AutoencoderKL(pvae.tiny_config()), jp)
    lat = randn(5, 1, 8, 8, 4)
    ref = jax.jit(functools.partial(jvae.decode, cfg=cfg, policy=FP32))(jp, latents=jnp.asarray(lat))
    with torch.no_grad():
        out = port.decode(nchw(lat))
    close(nhwc(out), ref)
    # tile by tile with blended seams: 3 x 2 tiles of 8 latents, 2 apart
    lat = randn(31, 1, 20, 12, 4)
    ref = jax.jit(functools.partial(jvae.decode_tiled, cfg=cfg, policy=FP32, tile_latent_size=8,
                                    overlap=2))(jp, latents=jnp.asarray(lat))
    with torch.no_grad():
        out = port.decode_tiled(nchw(lat), tile_latent_size=8, overlap=2)
        whole = port.decode_tiled(nchw(lat[:, :8, :8]), tile_latent_size=8, overlap=2)
    close(nhwc(out), ref)
    torch.testing.assert_close(whole, port.decode(nchw(lat[:, :8, :8])), rtol=0, atol=0)


@pytest.fixture(scope="module")
def vae_case():
    cfg = jvae.tiny_config()
    jp = jvae.init(0, cfg)
    return cfg, jp, load(pvae.AutoencoderKL(pvae.tiny_config()), jp)


def test_vae_encode_moments(vae_case):
    """The tiny encoder (asymmetric-pad downsample, mid-block attention,
    quant_conv, logvar clip) and the posterior sample on the JAX draw."""
    cfg, jp, port = vae_case
    img = randn(20, 2, 16, 16, 3)
    key = jax.random.PRNGKey(3)

    @jax.jit
    def ref_fn(jp, img):
        return (jvae.encode_moments(jp, cfg, img, policy=FP32),
                jvae.encode(jp, cfg, img, key, policy=FP32))

    (mean, logvar), ref = ref_fn(jp, jnp.asarray(img))
    eps = np.asarray(jax.random.normal(key, mean.shape, mean.dtype))
    with torch.no_grad():
        pm, plv = port.encode_moments(nchw(img))
        sample = port.encode(nchw(img), eps=nchw(eps))
        # img2img's start: JAX's encode(sample=False), the scaled mean
        scaled = port.encode_mean(nchw(img))
    close(nhwc(pm), mean)
    close(nhwc(plv), logvar)
    close(nhwc(sample), ref)
    close(nhwc(scaled), mean * cfg.scaling_factor)


def test_vae_encode_is_fp32_on_bf16_weights(vae_case):
    """bf16 weights encode in fp32: the result is fp32 and equals an fp32
    encoder holding the same (bf16-rounded) weights, exactly."""
    _, _, port = vae_case
    bf = copy.deepcopy(port).to(torch.bfloat16)
    rounded = copy.deepcopy(bf).float()
    img = nchw(randn(21, 1, 16, 16, 3))
    with torch.no_grad():
        a, b = bf.encode_moments(img), rounded.encode_moments(img)
    assert a[0].dtype == torch.float32
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("zero_snr", [False, True], ids=["scaled_linear", "zero_snr"])
def test_training_forward_process(zero_snr):
    """alphas_cumprod (with the zero-terminal-SNR rescale), add_noise and
    velocity_target against JAX, fp32."""
    jcfg = jsched.NoiseScheduleConfig(rescale_betas_zero_snr=zero_snr)
    acp = psched.alphas_cumprod(psched.NoiseScheduleConfig(rescale_betas_zero_snr=zero_snr))
    np.testing.assert_array_equal(acp, jsched.alphas_cumprod(jcfg))
    lat, noise = randn(22, 3, 4, 4, 4), randn(23, 3, 4, 4, 4)
    ts = np.array([0, 517, 999], np.int32)
    for pfn, jfn in ((psched.add_noise, jsched.add_noise),
                     (psched.velocity_target, jsched.velocity_target)):
        out = pfn(acp, t(lat), t(noise), torch.as_tensor(ts).long())
        close(out, jfn(acp, jnp.asarray(lat), jnp.asarray(noise), jnp.asarray(ts)),
              rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tower", ["clip_l", "bigg"])
def test_clip_text(tower):
    """Both SDXL tower kinds: quick_gelu without projection (CLIP-L) and
    gelu with text_projection (bigG)."""
    if tower == "clip_l":
        cfg = dict(hidden_size=24, num_heads=4)
    else:
        cfg = dict(hidden_size=40, num_heads=4, projection_dim=32, hidden_act="gelu")
    jcfg = jct.tiny_config(**cfg)
    jp = jct.init(0, jcfg)
    port = load(pct.CLIPTextModel(pct.tiny_config(**cfg)), jp)
    ids = np.random.default_rng(6).integers(0, 990, (2, 16)).astype(np.int32)
    ids[0, 9], ids[1, 15] = jcfg.eos_token_id, jcfg.eos_token_id
    ref = jax.jit(functools.partial(jct.apply, cfg=jcfg, policy=FP32))(jp, input_ids=jnp.asarray(ids))
    with torch.no_grad():
        out = port(torch.as_tensor(ids, dtype=torch.long))
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], ref[k])
    # clip_skip on a three-layer tower: an earlier layer's states, the whole
    # tower's pooled output; out-of-range values raise on both sides
    jcfg = jct.tiny_config(num_layers=3, **cfg)
    jp = jct.init(1, jcfg)
    port = load(pct.CLIPTextModel(pct.tiny_config(num_layers=3, **cfg)), jp)
    for skip in (0, 1):
        ref = jct.apply(jp, jcfg, jnp.asarray(ids), policy=FP32, clip_skip=skip)
        with torch.no_grad():
            out = port(torch.as_tensor(ids, dtype=torch.long), clip_skip=skip)
        for k in ref:
            close(out[k], ref[k])
    with pytest.raises(ValueError, match="clip_skip"):
        jct.apply(jp, jcfg, jnp.asarray(ids), clip_skip=2)
    with pytest.raises(ValueError, match="clip_skip"):
        port(torch.as_tensor(ids, dtype=torch.long), clip_skip=2)


def test_encode_for_sdxl():
    cl, cg = dict(hidden_size=24, num_heads=4), dict(hidden_size=40, num_heads=4,
                                                     projection_dim=32, hidden_act="gelu")
    jl_cfg, jg_cfg = jct.tiny_config(**cl), jct.tiny_config(**cg)
    jpl, jpg = jct.init(1, jl_cfg), jct.init(2, jg_cfg)
    pl_, pg = load(pct.CLIPTextModel(pct.tiny_config(**cl)), jpl), \
        load(pct.CLIPTextModel(pct.tiny_config(**cg)), jpg)
    ids = np.random.default_rng(7).integers(0, 1000, (2, 16)).astype(np.int32)
    enc = jax.jit(functools.partial(jct.encode_for_sdxl, cfg_l=jl_cfg, cfg_g=jg_cfg,
                                    policy=FP32))
    ref_ctx, ref_pooled = enc(jpl, params_g=jpg, ids_l=jnp.asarray(ids), ids_g=jnp.asarray(ids))
    with torch.no_grad():
        ctx, pooled = pct.encode_for_sdxl(pl_, pg, torch.as_tensor(ids).long(),
                                          torch.as_tensor(ids).long())
    close(ctx, ref_ctx)
    close(pooled, ref_pooled)


def test_clip_vision():
    jcfg = jcv.tiny_config(projection_dim=32)
    jp = jcv.init(0, jcfg)
    port = load(pcv.CLIPVisionModelWithProjection(pcv.tiny_config(projection_dim=32)), jp)
    px = randn(8, 2, 28, 28, 3)
    ref = jax.jit(functools.partial(jcv.apply, cfg=jcfg, policy=FP32))(jp, pixel_values=jnp.asarray(px))
    with torch.no_grad():
        out = port(t(px))
    for k in ref:
        close(out[k], ref[k])


def test_clip_preprocess_matches_jax():
    img = np.random.default_rng(9).integers(0, 255, (40, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pcv.preprocess_numpy(img, image_size=28),
                                  jcv.preprocess_numpy(img, image_size=28))


def test_harmony_cross_attention_and_image_proj():
    """HA cross_attention fusion (image_embed + delta) then ImageProjModel
    into 4 prompt tokens. And the older Composed_Attention shape,
    ``legacy_composed_config``: JAX's defaults, and the head built at the
    overrides of tests/test_pipeline_features.py's legacy test from its
    JAX params against JAX's forward."""
    jcfg = jha.tiny_config(image_hidden_size=32, text_context_dim=64)
    jp_ha = jha.init(0, jcfg)
    jp_proj = jproj.image_proj_init(1, clip_embed_dim=32, cross_attention_dim=64, num_tokens=4)
    ha = load(pha.HarmonyAttention(pha.tiny_config(image_hidden_size=32, text_context_dim=64)),
              jp_ha)
    proj = load(ImageProjModel(clip_embed_dim=32, cross_attention_dim=64, num_tokens=4), jp_proj)
    text, img = randn(10, 2, 16, 64), randn(11, 2, 32)

    @jax.jit
    def ref_fn(jp_ha, jp_proj, text, img):
        fused = jha.fuse_image_embeds(jp_ha, jcfg, text, img, policy=FP32)
        return fused, jproj.image_proj(jp_proj, fused, num_tokens=4, policy=FP32)

    ref_fused, ref_tokens = ref_fn(jp_ha, jp_proj, jnp.asarray(text), jnp.asarray(img))
    with torch.no_grad():
        fused = pha.fuse_image_embeds(ha, t(text), t(img))
        tokens = proj(fused)
    close(fused, ref_fused)
    close(tokens, ref_tokens)
    assert tuple(tokens.shape) == (2, 4, 64)

    jlegacy, plegacy = jha.legacy_composed_config(), pha.legacy_composed_config()
    assert {f.name: getattr(jlegacy, f.name) for f in dataclasses.fields(plegacy)} == \
        dataclasses.asdict(plegacy)
    assert (plegacy.inter_dim, plegacy.reshape_blocks, plegacy.cross_heads,
            plegacy.cross_value_dim) == (2560, 4, 10, 32)
    over = dict(image_hidden_size=16, text_context_dim=24, inter_dim=32, reshape_blocks=4,
                cross_heads=2, cross_value_dim=4)
    jcfg = jha.legacy_composed_config(**over)
    jp_ha = jha.init(0, jcfg)
    ha = load(pha.HarmonyAttention(pha.legacy_composed_config(**over)), jp_ha)
    text, img = randn(12, 2, 7, 24), randn(13, 2, 16)
    ref = jax.jit(functools.partial(jha.fuse_image_embeds, cfg=jcfg, policy=FP32))(
        jp_ha, text_embeds=jnp.asarray(text), image_embeds=jnp.asarray(img))
    with torch.no_grad():
        close(pha.fuse_image_embeds(ha, t(text), t(img)), ref)


def test_harmony_other_fusions_not_ported(tmp_path):
    """The other three HA fusions, now ported: ``qformer``, ``mlp`` and
    ``gated-attention`` against JAX ``fuse_image_embeds`` (max abs <= 2e-5),
    their LN/fc2 widths the fusion's own; each in an adapter file the JAX
    writer writes (.bin and .safetensors), read by the port's reader into
    its config and weights, bit for bit; an unknown fusion raises."""
    from imagharmony_tpu.io import checkpoints as jckpt
    from imagharmony_tpu.models import unet as junet_
    from imagharmony_tpu_torch.io import checkpoints as pckpt

    text, img = randn(10, 2, 16, 64), randn(11, 2, 32)
    ucfg = junet_.tiny_config()
    junet_params = junet_.init(0, ucfg)
    jp_proj = jproj.image_proj_init(1, clip_embed_dim=32, cross_attention_dim=64, num_tokens=4)
    for i, fusion in enumerate(("qformer", "mlp", "gated-attention")):
        jcfg = jha.tiny_config(image_hidden_size=32, text_context_dim=64, fusion_method=fusion,
                               qformer_queries=6, mlp_tokens=5)
        pcfg = pha.tiny_config(image_hidden_size=32, text_context_dim=64, fusion_method=fusion,
                               qformer_queries=6, mlp_tokens=5)
        assert pcfg.flattened_dim == jcfg.flattened_dim != jcfg.cross_heads * \
            jcfg.cross_value_dim * jcfg.reshape_blocks
        jp_ha = jha.init(i, jcfg)
        ha = load(pha.HarmonyAttention(pcfg), jp_ha)
        ref = jax.jit(functools.partial(jha.fuse_image_embeds, cfg=jcfg, policy=FP32))(
            jp_ha, text_embeds=jnp.asarray(text), image_embeds=jnp.asarray(img))
        with torch.no_grad():
            close(pha.fuse_image_embeds(ha, t(text), t(img)), ref)
        for ext in (".bin", ".safetensors"):
            path = str(tmp_path / f"{fusion}{ext}")
            jckpt.save_adapter_checkpoint(path, unet_params=junet_params, unet_cfg=ucfg,
                                          image_proj_params=jp_proj, harmony_params=jp_ha,
                                          harmony_cfg=jcfg)
            _, _, composed, cfg = pckpt.load_adapter_checkpoint(path)
            assert cfg == pcfg
            got = pckpt.import_harmony(pha.HarmonyAttention(cfg), composed).state_dict()
            for k, v in ha.state_dict().items():
                torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    with pytest.raises(ValueError, match="unknown fusion_method"):
        pha.HarmonyAttention(pha.tiny_config(fusion_method="concat"))


KINDS = ("euler", "euler_a", "ddim", "dpm++", "lcm")


@pytest.mark.parametrize("steps", [1, 3, 30, 50])
def test_euler_schedule_constants(steps):
    """SDXL's scheduler config (scaled_linear betas, leading spacing), and
    every sampler kind at every combination of spacing, Karras sigmas,
    prediction type, zero-SNR and beta schedule: the same timesteps, sigmas
    (alpha-cumprods for ddim and lcm) and initial sigma as JAX's, or the
    same refusal."""
    np.testing.assert_array_equal(psched.alphas_cumprod(psched.NoiseScheduleConfig()),
                                  jsched.alphas_cumprod(jsched.NoiseScheduleConfig()))
    ref, out = jsched.euler_schedule(steps), psched.euler_schedule(steps)
    np.testing.assert_array_equal(out.timesteps, np.asarray(ref.timesteps))
    np.testing.assert_array_equal(out.sigmas, np.asarray(ref.sigmas))
    assert out.init_noise_sigma == ref.init_noise_sigma
    refused = 0
    for kind, spacing, karras, pred, zsnr, betas in itertools.product(
            KINDS, ("leading", "trailing", "linspace"), (False, True), psched.PREDICTION_TYPES,
            (False, True), ("scaled_linear", "linear")):
        kw = dict(timestep_spacing=spacing, use_karras_sigmas=karras, prediction_type=pred,
                  rescale_betas_zero_snr=zsnr, beta_schedule=betas)
        try:
            ref = jsched.make(kind, steps, jsched.NoiseScheduleConfig(**kw))
        except ValueError:
            refused += 1
            with pytest.raises(ValueError):
                psched.make(kind, steps, psched.NoiseScheduleConfig(**kw))
            continue
        out = psched.make(kind, steps, psched.NoiseScheduleConfig(**kw))
        assert (out.kind, out.init_noise_sigma) == (ref.kind, ref.init_noise_sigma)
        np.testing.assert_array_equal(out.timesteps, np.asarray(ref.timesteps))
        np.testing.assert_array_equal(out.sigmas, np.asarray(ref.sigmas))
    assert refused == 3 * 3 * 2 * 2 * 3  # Karras on euler_a, ddim and lcm


def test_euler_step_and_input_scaling():
    """The port's step functions take each step's constants as 0-dim fp32
    tensors read from its ``scan_constants`` tables. For every kind and
    prediction type (v-prediction at zero terminal SNR) on seeded fp32
    inputs, over a 3-step chain, each side fed its own last output: the
    input scaling, ``step_c`` and ``step_s`` against JAX's (DPM++'s history
    through first-order, second-order and the final first-order step onto
    sigma 0; Euler-a and LCM fed the z that JAX's key splitting draws), and
    ``noise_to_level`` and ``img2img_init``."""
    lat, noise = randn(12, 2, 8, 8, 4) * 10, randn(13, 2, 8, 8, 4)
    for kind, pred in itertools.product(KINDS, psched.PREDICTION_TYPES):
        kw = dict(prediction_type=pred, rescale_betas_zero_snr=pred == "v_prediction")
        sched_j = jsched.make(kind, 3, jsched.NoiseScheduleConfig(**kw))
        sched_p = psched.make(kind, 3, psched.NoiseScheduleConfig(**kw))
        ts, sigmas, sigmas_next = psched.scan_constants(sched_p)
        key = jax.random.PRNGKey(5) if kind in psched.STOCHASTIC else None
        state_j = jsched.init_solver_state(kind, jnp.asarray(lat), key)
        state_p = psched.init_solver_state(kind, t(lat))
        x_j, x_p = jnp.asarray(lat), t(lat)
        for i in range(3):
            s, sn, tt = sched_j.sigmas[i], sched_j.sigmas[i + 1], sched_j.timesteps[i]
            m = randn(20 + i, 2, 8, 8, 4)
            close(psched.scale_model_input_c(kind, sigmas[i], x_p),
                  jsched.scale_model_input_c(kind, s, x_j))
            z = None
            if key is not None:  # the draw JAX's step_s makes from its key
                z = t(jax.random.normal(jax.random.split(state_j["key"])[1], x_j.shape))
            if kind in ("euler", "ddim"):
                close(psched.step_c(kind, sigmas[i], sigmas_next[i], t(m), x_p, pred),
                      jsched.step_c(kind, s, sn, jnp.asarray(m), x_j, pred))
            x_j, state_j = jsched.step_s(kind, s, sn, jnp.asarray(m), x_j, state_j, pred,
                                         timestep=tt)
            x_p, state_p = psched.step_s(kind, sigmas[i], sigmas_next[i], t(m), x_p, state_p,
                                         pred, timestep=ts[i], z=z)
            close(x_p, x_j)
            if kind == "dpm++":
                for k in ("x0", "lam", "valid"):
                    close(state_p[k], state_j[k])
        close(psched.noise_to_level(kind, sigmas[1], t(lat), t(noise)),
              jsched.noise_to_level(kind, sched_j.sigmas[1], jnp.asarray(lat),
                                    jnp.asarray(noise)))
        close(psched.img2img_init(sched_p, t(lat), t(noise)),
              jsched.img2img_init(sched_j, jnp.asarray(lat), jnp.asarray(noise)))


def test_other_schedulers_not_ported():
    """Every sampler is ported now; what this holds is the schedule's cuts
    against JAX's (the base/refiner split's denoising_end and
    denoising_start, img2img's skipped steps) and the refusals: an unknown
    kind, lcm with a split, a strength outside (0, 1], a missing draw."""
    for kind, steps, end, start, strength in itertools.product(
            KINDS, (5, 30), (None, 0.5, 0.8), (None, 0.8), (None, 0.3, 0.6, 1.0)):
        skip = 0 if strength is None else jsched.img2img_skip_steps(steps, strength)
        assert skip == (0 if strength is None else psched.img2img_skip_steps(steps, strength))
        kw = dict(denoising_end=end, denoising_start=start, skip_steps=skip)
        try:
            ref = jsched.make(kind, steps, **kw)
        except ValueError:
            with pytest.raises(ValueError, match="lcm"):
                psched.make(kind, steps, **kw)
            continue
        out = psched.make(kind, steps, **kw)
        assert out.init_noise_sigma == ref.init_noise_sigma and out.kind == ref.kind
        np.testing.assert_array_equal(out.timesteps, np.asarray(ref.timesteps))
        np.testing.assert_array_equal(out.sigmas, np.asarray(ref.sigmas))
        if end is not None:
            assert psched.steps_for_denoising_end(steps, end) == \
                jsched.steps_for_denoising_end(steps, end)
    with pytest.raises(ValueError, match="unknown scheduler"):
        psched.make("heun", 10)
    with pytest.raises(ValueError, match="strength"):
        psched.img2img_skip_steps(10, 0.0)
    one = torch.ones(())
    with pytest.raises(ValueError, match="draw"):
        psched.step_s("euler_a", one, one, torch.zeros(2), torch.zeros(2), None)
    with pytest.raises(ValueError, match="multistep"):
        psched.step_c("dpm++", one, one, torch.zeros(2), torch.zeros(2))
