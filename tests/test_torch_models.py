"""Port (imagharmony_tpu_torch.models/adapters/schedulers) vs JAX on the
CPU at the tiny configs, fp32 on both sides: the UNet forward, the VAE
encode and decode, both CLIP text towers, the CLIP vision tower, the HA
``cross_attention`` fusion with ImageProjModel, the Euler schedule and
step, and the training forward process."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagharmony_tpu import dtypes as jdt
from imagharmony_tpu.adapters import harmony as jha
from imagharmony_tpu.adapters import projections as jproj
from imagharmony_tpu.models import clip_text as jct
from imagharmony_tpu.models import clip_vision as jcv
from imagharmony_tpu.models import unet as junet
from imagharmony_tpu.models import vae as jvae
from imagharmony_tpu.schedulers import diffusion as jsched
from imagharmony_tpu_torch.adapters import harmony as pha
from imagharmony_tpu_torch.adapters.projections import ImageProjModel
from imagharmony_tpu_torch.models import clip_text as pct
from imagharmony_tpu_torch.models import clip_vision as pcv
from imagharmony_tpu_torch.models import unet as punet
from imagharmony_tpu_torch.models import vae as pvae
from imagharmony_tpu_torch.nn.attention import pack_inference_params
from imagharmony_tpu_torch.schedulers import diffusion as psched
from torch_port_util import close, load, nchw, nhwc, randn, t

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
    packing the pipeline runs."""
    jp, x, ref = unet_case
    port = load(punet.UNet2DConditionModel(punet.tiny_config()), jp)
    if packed:
        pack_inference_params(port)
    with torch.no_grad():
        out = port(nchw(x["sample"]), t(x["timesteps"]), t(x["encoder_hidden_states"]),
                   pooled_text_embeds=t(x["pooled_text_embeds"]), time_ids=t(x["time_ids"]),
                   ip_tokens=t(x["ip_tokens"]), ip_scale=0.7)
    close(nhwc(out), ref)


def test_unet_encoder_propagation_not_ported():
    port = punet.UNet2DConditionModel(punet.tiny_config())
    with pytest.raises(NotImplementedError):
        port(torch.zeros(1, 4, 8, 8), 1.0, torch.zeros(1, 5, 64), return_encoder=True)


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
    close(nhwc(pm), mean)
    close(nhwc(plv), logvar)
    close(nhwc(sample), ref)


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
    into 4 prompt tokens."""
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


def test_harmony_other_fusions_not_ported():
    with pytest.raises(ValueError, match="not ported"):
        pha.HarmonyAttention(pha.tiny_config(fusion_method="qformer"))


@pytest.mark.parametrize("steps", [1, 3, 30, 50])
def test_euler_schedule_constants(steps):
    """SDXL's scheduler config: scaled_linear betas, leading spacing."""
    np.testing.assert_array_equal(psched.alphas_cumprod(psched.NoiseScheduleConfig()),
                                  jsched.alphas_cumprod(jsched.NoiseScheduleConfig()))
    ref, out = jsched.euler_schedule(steps), psched.euler_schedule(steps)
    np.testing.assert_array_equal(out.timesteps, np.asarray(ref.timesteps))
    np.testing.assert_array_equal(out.sigmas, np.asarray(ref.sigmas))
    assert out.init_noise_sigma == ref.init_noise_sigma


def test_euler_step_and_input_scaling():
    """The port's step functions take each step's sigmas as 0-dim fp32
    tensors, read from its ``scan_constants`` tables; Euler carries no
    solver state, so the port's step is JAX's ``step_s`` without one."""
    sched_j, sched_p = jsched.make("euler", 5), psched.make("euler", 5)
    _, sigmas, sigmas_next = psched.scan_constants(sched_p)
    lat, eps = randn(12, 2, 8, 8, 4) * 10, randn(13, 2, 8, 8, 4)
    for i in range(5):
        s, sn = sched_j.sigmas[i], sched_j.sigmas[i + 1]
        ps, psn = sigmas[i], sigmas_next[i]
        close(psched.scale_model_input_c("euler", ps, t(lat)),
              jsched.scale_model_input_c("euler", s, jnp.asarray(lat)), rtol=1e-6, atol=1e-6)
        out = psched.step_c("euler", ps, psn, t(eps), t(lat))
        ref, _ = jsched.step_s("euler", s, sn, jnp.asarray(eps), jnp.asarray(lat), ())
        close(out, ref, rtol=1e-6, atol=1e-5)


def test_other_schedulers_not_ported():
    with pytest.raises(ValueError, match="not ported"):
        psched.make("ddim", 10)
