"""The QL-Edit pipeline: reference image + prompt + extra_text -> edited
image (port of imagharmony_tpu/pipelines/harmony_edit.py).

The path: text encoders -> vision encoder -> HA fusion -> image projection
-> a denoise loop with the CFG pair packed on the batch axis
([uncond | cond]) -> VAE decode. The device and dtype come from the
weights. The module functions run it eagerly (``edit``: what generate()
runs on the CPU, and the reference on a card); on a CUDA device generate()
runs the same functions as captured CUDA graphs (``programs.py``). The
loop's body, ``denoise_step``, reads each step's constants from a device
table at a device step index, as the JAX package's ``lax.scan`` reads its
xs, and its scalars (guidance, rescale) from a device vector.

Every sampler of ``schedulers/diffusion.py`` runs it (DPM++'s history as
tensors the step takes and returns, the stochastic samplers' draws made by
the caller from a generator seeded from the run's seed(s)), with or
without classifier-free guidance (guidance_scale <= 1: batch B, not 2B),
guidance rescale, text-to-image with no image prompt, img2img and
inpainting from an init image encoded by the VAE, the base/refiner latent
handoff (denoising_end / denoising_start), SDXL micro-conditioning
overrides, clip_skip, prompt weighting, textual inversion, encoder
propagation (encoder_interval) and a tiled VAE decode.

Three families run it. SDXL: both text towers, micro-conditioning, the HA
fusion with extra_text (any of its four fusions). SD1.5
(``cfgs.family == "sd15"``): CLIP-L's last hidden state alone as the
context, no pooled embedding and no time ids, no HA head, the IP branch on
every cross-attention. Either takes the ``image_proj`` head or, from the
penultimate patch features, the ``resampler`` (Plus) or ``mlp_proj``
(Full) head. The SDXL refiner (``"sdxl_refiner"``): bigG's penultimate
state and projected pooled embedding alone, the aesthetic-score
micro-conditioning (5 time ids), no image prompt; it finishes a base run
from its ``denoising_end`` latents (``generate(latents=...,
denoising_start=...)``) or refines an init image.

Any family may carry a ControlNet (``cfgs.controlnet``): with a
``control_image`` its residuals, computed each step on the CFG-packed text
conditioning (no image prompt), feed the UNet's skips and mid block.
``with_lora`` merges LoRA factors into a copy of the UNet.

The pipeline surface keeps the JAX layout: noise and latents are
(B, h, w, 4) and images (B, H, W, 3) in [-1, 1]. Inside the models
activations are NCHW.

Besides generate(): ``generate_batch`` packs B requests into one program
(the CFG-packed UNet batch 2B), and ``callback_on_step_end`` /
``chunk_steps`` run the chunked runner (``continuous.py``), whose step is
``denoise_rows_step``: every row at its own step of the schedule.

``with_mesh`` makes a clone over a ``parallel/mesh.py`` mesh, run by every
rank with the same arguments (one process per card, as under torchrun):
the noise rows split over the data axis (``_local_call``: a rank denoises
and decodes its rows, then every rank gathers all of them), and with
``tensor_parallel`` the attention and FFN projections split over the
model axis (``parallel/tp_rules.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import os
import time
from typing import Optional

import numpy as np
import torch

from imagharmony_tpu_torch import dtypes
from imagharmony_tpu_torch.adapters import harmony
from imagharmony_tpu_torch.models import clip_text, clip_vision
from imagharmony_tpu_torch.models import tokenizer as tok_lib
from imagharmony_tpu_torch.nn.attention import pack_inference_params
from imagharmony_tpu_torch.pipelines import components as comp
from imagharmony_tpu_torch.schedulers import diffusion as sched

DEFAULT_NEGATIVE = "monochrome, lowres, bad anatomy, worst quality, low quality"
DEFAULT_PROMPT = "best quality, high quality"

# rows of the denoise loop's per-step table: timestep, sigma, next sigma,
# IP scale, inpaint blend level
STEP_ROWS = 5
OUTPUT_TYPES = ("np", "raw", "latent", "pil")
# the per-step noise's stream, apart from the initial noise's (the JAX
# package folds the same tag into its key, ``ancestral_key``)
STEP_NOISE_TAG = 0xA9CE57


@dataclasses.dataclass(frozen=True)
class EditOptions:
    """Knobs of one edit call (the JAX package's; ``controlnet_scale`` is a
    value of the call, ``EditCall.scalars``)."""

    height: int = 1024
    width: int = 1024
    num_inference_steps: int = 30
    scheduler: str = "euler"
    # "leading" (SDXL's shipped config) | "trailing" | "linspace"
    timestep_spacing: str = "leading"
    # Karras rho=7 sigma spacing (euler and dpm++ only)
    use_karras: bool = False
    guidance_scale: float = 5.0
    ip_scale: float = 1.0
    # the per-step IP-scale window (fractions of the schedule)
    control_guidance_start: float = 0.0
    control_guidance_end: float = 1.0
    use_harmony: bool = True
    tile_vae: bool = False
    # CFG rescale (arXiv 2305.08891 §3.4)
    guidance_rescale: float = 0.0
    # stop at this fraction of the schedule and return latents (the base
    # side of a base/refiner handoff)
    denoising_end: Optional[float] = None
    # skip this fraction and start from given latents (the other side)
    denoising_start: Optional[float] = None
    # return the pre-decode latents (B, h, w, 4)
    return_latents: bool = False
    # img2img: skip the first N steps and start from the init image
    # noised to step N
    img2img_skip: int = 0
    # SDXL micro-conditioning overrides ((h, w) and (top, left) tuples;
    # None -> the output size and a zero crop)
    original_size: Optional[tuple] = None
    crops_coords_top_left: tuple = (0, 0)
    target_size: Optional[tuple] = None
    negative_original_size: Optional[tuple] = None
    negative_crops_coords_top_left: Optional[tuple] = None
    negative_target_size: Optional[tuple] = None
    # encoder propagation (Faster Diffusion, arXiv 2312.09608): the UNet
    # encoder runs on every k-th step only; 1 is exact
    encoder_interval: int = 1
    # "epsilon" | "v_prediction" | "sample"
    prediction_type: str = "epsilon"
    # zero terminal SNR betas (arXiv 2305.08891 §3.1)
    rescale_zero_snr: bool = False
    # condition on an earlier text-encoder layer (diffusers clip_skip)
    clip_skip: int = 0
    # the refiner's aesthetic-score micro-conditioning (diffusers XLImg2Img
    # defaults)
    aesthetic_score: float = 6.0
    negative_aesthetic_score: float = 2.5

    def time_ids(self, negative=False, aesthetic=False):
        """SDXL micro-conditioning: original size, crop (top, left), target
        size; the negative row takes its own overrides where given. The
        refiner's (``aesthetic``): original size, crop and the aesthetic
        score, no target size."""
        osz = self.original_size or (self.height, self.width)
        tsz = self.target_size or (self.height, self.width)
        crop = self.crops_coords_top_left
        if negative:
            osz = self.negative_original_size or osz
            tsz = self.negative_target_size or tsz
            crop = self.negative_crops_coords_top_left or crop
        head = [float(osz[0]), float(osz[1]), float(crop[0]), float(crop[1])]
        if aesthetic:
            return head + [float(self.negative_aesthetic_score if negative
                                 else self.aesthetic_score)]
        return head + [float(tsz[0]), float(tsz[1])]


def rescale_noise_cfg(eps_cfg, eps_text, rescale):
    """arXiv 2305.08891 eq. 16: the guided output's std brought back toward
    the text branch's, by ``rescale`` (a float or a 0-dim fp32 tensor)."""
    dims = tuple(range(1, eps_text.dim()))
    std_text = eps_text.float().std(dim=dims, keepdim=True, correction=0)
    std_cfg = eps_cfg.float().std(dim=dims, keepdim=True, correction=0)
    rescaled = eps_cfg * (std_text / std_cfg.clamp_min(1e-8)).to(eps_cfg.dtype)
    return rescale * rescaled + (1.0 - rescale) * eps_cfg


def sched_config(opts: EditOptions) -> sched.NoiseScheduleConfig:
    """The NoiseScheduleConfig an EditOptions implies."""
    return sched.NoiseScheduleConfig(
        timestep_spacing=opts.timestep_spacing,
        use_karras_sigmas=opts.use_karras,
        prediction_type=opts.prediction_type,
        rescale_betas_zero_snr=opts.rescale_zero_snr,
    )


def ip_scale_schedule(opts: EditOptions) -> np.ndarray:
    """Per-step IP scale over the whole schedule: 0 outside the
    [start, end) window."""
    n = opts.num_inference_steps
    i = np.arange(n, dtype=np.float32)
    on = (i / n >= opts.control_guidance_start) & ((i + 1) / n <= opts.control_guidance_end)
    return np.where(on, opts.ip_scale, 0.0).astype(np.float32)


def schedule_for(opts: EditOptions):
    """The schedule the edit runs, cut for img2img and the base/refiner
    split, and its per-step IP scales: the whole schedule's, less the
    skipped steps (the first lines of the JAX package's ``_edit_jit``)."""
    cfg = sched_config(opts)
    schedule = sched.make(opts.scheduler, opts.num_inference_steps, cfg,
                          denoising_end=opts.denoising_end,
                          denoising_start=opts.denoising_start, skip_steps=opts.img2img_skip)
    n_skip = opts.img2img_skip
    if opts.denoising_start is not None and 0.0 < opts.denoising_start < 1.0:
        n_skip += sched.steps_for_denoising_end(opts.num_inference_steps,
                                                opts.denoising_start, cfg)
    return schedule, ip_scale_schedule(opts)[n_skip: n_skip + schedule.num_steps]


def encode_texts(comps: comp.Components, ids_l, ids_g, clip_skip: int = 0):
    """Text conditioning (context, pooled): the dual-tower concatenation for
    SDXL; CLIP-L's last hidden state alone, with pooled None, for SD1.5;
    bigG's penultimate state and projected pooled embedding for the
    refiner."""
    if comps.cfgs.family == "sd15":
        return comps.text_encoder(ids_l, clip_skip=clip_skip)["last"], None
    if comps.cfgs.family == "sdxl_refiner":
        out = comps.text_encoder_2(ids_g, clip_skip=clip_skip)
        return out["penultimate"], out["projected"]
    return clip_text.encode_for_sdxl(comps.text_encoder, comps.text_encoder_2, ids_l, ids_g,
                                     clip_skip=clip_skip)


def image_prompt_tokens(comps: comp.Components, pixel_values, extra_context):
    """CLIP vision -> (HA fuse with extra_text) -> prompt tokens, plus the
    unconditional tokens: from a zeroed embedding for ``image_proj``, from a
    black image's patch features for ``resampler`` and ``mlp_proj``."""
    vision_out = comps.image_encoder(pixel_values)
    if comps.cfgs.proj_kind != "image_proj":
        black = comps.image_encoder(torch.zeros_like(pixel_values))
        return comps.project_image_embeds(vision_out), comps.project_image_embeds(black)
    embeds = vision_out["projected"]
    if extra_context is not None and comps.harmony is not None:
        embeds = harmony.fuse_image_embeds(comps.harmony, extra_context, embeds)
    cond = comps.image_proj(embeds)
    uncond = comps.image_proj(torch.zeros_like(embeds))
    return cond, uncond


def _repeat_rows(x, n):
    """Each row of x n times in a row (repeat_interleave on the batch axis,
    with no host read)."""
    return x.unsqueeze(1).expand(-1, n, *x.shape[1:]).reshape(-1, *x.shape[1:])


def apply_prompt_weights(ctx, w):
    """Each token's context embedding times its weight (B, S), then the
    per-row mean restored (the A1111 rule, ``utils/prompts.py``), in fp32."""
    z = ctx.float()
    mean0 = z.mean(dim=(1, 2), keepdim=True)
    z = z * w[:, :, None]
    mean1 = z.mean(dim=(1, 2), keepdim=True)
    ratio = torch.where(mean1.abs() < 1e-7, torch.ones_like(mean1), mean0 / mean1)
    return (z * ratio).to(ctx.dtype)


def time_ids_rows(opts: EditOptions, family: str = "sdxl") -> torch.Tensor:
    """The (2, 6) fp32 micro-conditioning rows [negative, positive] on the
    CPU; (2, 5) with the refiner's aesthetic score."""
    aes = family == "sdxl_refiner"
    return torch.tensor([opts.time_ids(negative=True, aesthetic=aes),
                         opts.time_ids(aesthetic=aes)], dtype=torch.float32)


def build_conditioning(comps: comp.Components, opts: EditOptions, ids, pixel_values, *,
                       num_samples, time_ids=None):
    """CFG-packed conditioning, each (2 * B * num_samples, ...) in
    [uncond | cond] row order for B requests (the rows of ``ids``):
    (context2, pooled2, time_ids2, ip2). pooled2 and time_ids2 are None for
    the SD1.5 family, ip2 when ``pixel_values`` is None (text-to-image, the
    IP branch off, and always for the refiner).

    ``ids``: token ids keyed pos_l/pos_g/neg_l/neg_g (extra_l/extra_g with
    an extra_text), and pos_w/neg_w (B, S) fp32 prompt weights where a
    prompt carries weights. ``time_ids``: the (2, 6) fp32 rows [negative,
    positive] on the device (a captured program's buffer; (2, 5) for the
    refiner), else made from ``opts``."""
    breq = ids["pos_l"].shape[0]
    ids_l = torch.cat([ids["neg_l"], ids["pos_l"]])
    ids_g = torch.cat([ids["neg_g"], ids["pos_g"]])
    context, pooled = encode_texts(comps, ids_l, ids_g, opts.clip_skip)
    neg_ctx, pos_ctx = context[:breq], context[breq:]
    # prompt weights scale the combined context, so both towers' halves
    # scale together; the pooled embeddings stay unweighted
    if "pos_w" in ids:
        pos_ctx = apply_prompt_weights(pos_ctx, ids["pos_w"])
    if "neg_w" in ids:
        neg_ctx = apply_prompt_weights(neg_ctx, ids["neg_w"])

    extra_ctx = None
    if opts.use_harmony and "extra_l" in ids:
        extra_ctx, _ = encode_texts(comps, ids["extra_l"], ids["extra_g"], opts.clip_skip)

    def rep(x):
        return _repeat_rows(x, num_samples)

    ip2 = None
    if pixel_values is not None and comps.cfgs.proj_kind != "none":
        ip_cond, ip_uncond = image_prompt_tokens(comps, pixel_values, extra_ctx)
        ip2 = torch.cat([rep(ip_uncond), rep(ip_cond)])
    context2 = torch.cat([rep(neg_ctx), rep(pos_ctx)])
    if comps.cfgs.family == "sd15":
        return context2, None, None, ip2
    pooled2 = torch.cat([rep(pooled[:breq]), rep(pooled[breq:])])
    if time_ids is None:
        time_ids = time_ids_rows(opts, comps.cfgs.family).to(context.device)
    tid_neg, tid_pos = (time_ids[i:i + 1].expand(breq, -1) for i in range(2))
    return context2, pooled2, torch.cat([rep(tid_neg), rep(tid_pos)]), ip2


def inpaint_blend_levels(schedule: sched.Schedule) -> np.ndarray:
    """The inpaint blend's per-step re-noise levels: the next step's entry,
    but the last step blends the clean init latents (sigma 0, or an
    alpha-cumprod of 1 for ddim and lcm)."""
    tail = np.array(schedule.sigmas[1:], dtype=np.float32)
    if schedule.num_steps:
        tail[-1] = 1.0 if schedule.kind in ("ddim", "lcm") else 0.0
    return tail


def scan_tables(schedule: sched.Schedule, ip_scales, device=None) -> torch.Tensor:
    """The denoise loop's per-step constants as one (STEP_ROWS, num_steps)
    fp32 tensor on ``device``, rows (timestep, sigma, next sigma, IP scale,
    inpaint blend level): the xs of the JAX package's scan."""
    rows = [*sched.scan_constants(schedule, device),
            torch.as_tensor(np.asarray(ip_scales, dtype=np.float32), device=device),
            torch.as_tensor(inpaint_blend_levels(schedule), device=device)]
    return torch.stack(rows)


@dataclasses.dataclass(frozen=True)
class Branches:
    """What an edit's code does, as opposed to the values it does it on:
    with the shapes, the key of a captured program. Every value (steps,
    sigmas, scales, sizes, prompts) reaches the code through tensors."""

    kind: str
    prediction_type: str
    cfg: bool                 # guidance_scale > 1: the CFG pair, batch 2B
    rescale: bool             # guidance rescale (with CFG only)
    image_prompt: bool        # an image prompt, else the IP branch is off
    harmony: bool             # the HA fusion with an extra_text
    weights: tuple            # prompt weights on (positive, negative)
    init_image: bool          # a VAE-encoded init image (img2img, inpaint)
    from_image: bool          # the loop starts from it noised, not from noise
    inpaint: bool
    latent_output: bool       # no decode: latents (B, h, w, 4)
    tile_vae: bool
    clip_skip: int
    encoder_interval: int
    controlnet: bool = False  # a control image through the pipeline's ControlNet


def cfg_rows(cond, use_cfg):
    """The conditioning a step takes: the CFG-packed rows (context, pooled,
    time ids, IP tokens, control images), or without CFG the conditional
    half alone."""
    if use_cfg:
        return cond
    return tuple(None if x is None else x[x.shape[0] // 2:] for x in cond)


def image_latents(comps: comp.Components, init_pixels, num_samples):
    """An init image (1, 3, H, W) in [-1, 1] -> its scaled posterior-mean
    latents (num_samples, 4, h, w), fp32, encoded in the weights' dtype."""
    return _repeat_rows(comps.vae.encode_mean(init_pixels), num_samples)


def initial_latents(kind, scalars, noise, img_lat, dtype):
    """The loop's first latents in ``dtype``: ``img_lat`` noised to the first
    step's level (img2img; ``scalars[2]``), else the noise times the
    schedule's initial sigma (``scalars[3]``)."""
    if img_lat is not None:
        return sched.noise_to_level(kind, scalars[2], img_lat, noise).to(dtype)
    return (noise * scalars[3]).to(dtype)


def inpaint_blend(kind, level, latents, inpaint):
    """mask 1 keeps the step's latents, mask 0 the init image's latents
    re-noised to ``level`` with the run's initial noise; fp32, cast back."""
    mask, img_lat, noise = inpaint
    keep = sched.noise_to_level(kind, level, img_lat, noise)
    return (mask * latents.float() + (1.0 - mask) * keep).to(latents.dtype)


def controlnet_residuals(controlnet, lat_in, t, cond, scalars, encoder):
    """(down residuals, mid residual) of ``controlnet`` on the step's UNet
    input and the text conditioning (``cond``'s control rows), times the
    conditioning scale ``scalars[4]``; or (None, the key step's mid
    residual) on an encoder-propagation reuse step, whose kept skips hold
    the down residuals already. (None, None) without a control image."""
    context, pooled, time_ids, _, control = cond
    if control is None:
        return None, None
    if encoder is not None:
        return None, encoder[2]
    return controlnet(lat_in, t, context, control, pooled_text_embeds=pooled,
                      time_ids=time_ids, conditioning_scale=scalars[4])


def denoise_step(unet, latents, index, tables, scalars, cond, br: Branches, *, state=None,
                 z=None, inpaint=None, encoder=None, want_encoder=False, controlnet=None):
    """One step of the denoise loop, the body of the JAX package's scan: the
    UNet call on [latents | latents] (or on the latents alone without CFG)
    against ``cond`` (``cfg_rows``' output), classifier-free guidance and
    its rescale, the scheduler step, the inpaint blend. Returns
    (next latents (B, 4, h, w), the solver state, the encoder features).

    Every per-step value is read on the device: ``index`` is a (1,) int64
    tensor, the step, at which the timestep, sigmas, IP scale and blend
    level are gathered from ``tables`` (``scan_tables``, as long as the loop
    or longer); ``scalars`` is a (4,) fp32 tensor whose first two entries
    are the guidance scale and the rescale, applied in the guided output's
    dtype. ``state``: DPM++'s history (``sched.init_solver_state``); ``z``:
    this step's N(0, 1) draw for the stochastic samplers; ``inpaint``:
    (mask (1, 1, h, w), image latents, noise), fp32. Encoder propagation:
    ``want_encoder`` (a key step) returns this call's encoder features,
    ``encoder`` (a reuse step) runs the mid block and the decoder on given
    ones. ``controlnet``: the ControlNet that ``cond``'s control rows go
    through (``controlnet_residuals``); its mid residual is kept with the
    encoder features. So one captured step serves every step of its kind."""
    context, pooled, time_ids, ip_tokens, _ = cond
    t, sigma, sigma_next, ip_scale, level = tables.index_select(1, index).view(STEP_ROWS).unbind(0)
    lat_in = torch.cat([latents, latents]) if br.cfg else latents
    lat_in = sched.scale_model_input_c(br.kind, sigma, lat_in)
    ts = t.expand(lat_in.shape[0])
    down_res, mid_res = controlnet_residuals(controlnet, lat_in, ts, cond, scalars, encoder)
    eps = unet(lat_in, ts, context, pooled_text_embeds=pooled,
               time_ids=time_ids, ip_tokens=ip_tokens, ip_scale=ip_scale,
               down_block_additional_residuals=down_res, mid_block_additional_residual=mid_res,
               return_encoder=want_encoder, encoder_override=encoder)
    if want_encoder:
        eps, encoder = eps
        encoder = encoder + (mid_res,)
    if br.cfg:
        eps_u, eps_c = eps.chunk(2)
        eps = eps_u + scalars[0] * (eps_c - eps_u)
        if br.rescale:
            eps = rescale_noise_cfg(eps, eps_c, scalars[1])
    latents, state = sched.step_s(br.kind, sigma, sigma_next, eps, latents, state,
                                  br.prediction_type, timestep=t, z=z)
    if inpaint is not None:
        latents = inpaint_blend(br.kind, level, latents, inpaint)
    return latents, state, encoder


def denoise_rows_step(unet, latents, index, num_steps, tables, scalars, cond, br: Branches, *,
                      state=None, encoder=None, want_encoder=False, controlnet=None):
    """One step of the chunked runner, every row at its own step of the
    schedule (the JAX package's ``_chunk_jit`` body,
    imagharmony_tpu/pipelines/continuous.py:60-150): what the slot engine
    runs eagerly on the CPU and captures as its chunk step on a card.
    Returns (latents, index, solver state, encoder features).

    latents: (S, 4, h, w); ``index``: (S,) int64, each row's step; rows at
    ``num_steps`` ((1,) int64) or beyond are frozen (finished or empty
    slots): they compute but keep their latents and their DPM++ history
    under one ``torch.where`` mask, and their index does not advance. The
    index, clamped to num_steps - 1, gathers each row's column of
    ``tables`` (``scan_tables``): its timestep, sigma, next sigma and IP
    weight, as (S, 1, 1, 1) per-row constants, the timestep and the IP
    weight as 2S rows in [uncond | cond] order (K2 reads a (2S,) weight).
    The CFG pair always runs, as in ``_chunk_jit``; ``cond`` is
    ``start``'s 2S rows. Deterministic samplers only (the JAX runner
    refuses Euler-a and LCM); no inpaint blend. Encoder propagation and the
    ControlNet as in ``denoise_step``."""
    context, pooled, time_ids, ip_tokens, _ = cond
    live = index < num_steps
    t, sigma, sigma_next, ip_scale, _ = tables.index_select(
        1, torch.minimum(index, num_steps - 1)).unbind(0)

    def rows(x):
        return x.view(x.shape[0], 1, 1, 1)

    def pair(x):
        return torch.cat([x, x])

    lat_in = sched.scale_model_input_c(br.kind, rows(pair(sigma)), pair(latents))
    down_res, mid_res = controlnet_residuals(controlnet, lat_in, pair(t), cond, scalars, encoder)
    eps = unet(lat_in, pair(t), context, pooled_text_embeds=pooled, time_ids=time_ids,
               ip_tokens=ip_tokens, ip_scale=pair(ip_scale),
               down_block_additional_residuals=down_res, mid_block_additional_residual=mid_res,
               return_encoder=want_encoder, encoder_override=encoder)
    if want_encoder:
        eps, encoder = eps
        encoder = encoder + (mid_res,)
    eps_u, eps_c = eps.chunk(2)
    eps = eps_u + scalars[0] * (eps_c - eps_u)
    if br.rescale:
        eps = rescale_noise_cfg(eps, eps_c, scalars[1])
    stepped, new_state = sched.step_s(br.kind, rows(sigma), rows(sigma_next), eps, latents,
                                      state, br.prediction_type)
    keep = rows(live)
    latents = torch.where(keep, stepped, latents)
    if state is not None:
        state = {k: torch.where(keep, new_state[k], v) for k, v in state.items()}
    return latents, index + live.long(), state, encoder


def draw_step_noise(generator: torch.Generator, out: torch.Tensor) -> torch.Tensor:
    """One step's N(0, 1) draw for the stochastic samplers, into ``out`` (a
    captured program's static buffer, or a new tensor of the eager loop):
    the same generator gives both the same numbers."""
    return out.normal_(generator=generator)


def denoise(unet, latents, cond, tables, scalars, br: Branches, *, inpaint=None,
            step_noise=None, on_step=None, controlnet=None):
    """The denoise loop, eagerly: ``denoise_step`` once per step (a column
    of ``tables``), the step index advanced on the device. latents
    (B, 4, h, w); ``cond`` from ``cfg_rows``. With encoder propagation every
    ``br.encoder_interval``-th step is a key step and the others reuse its
    features. ``step_noise(i)``: step i's draw (stochastic samplers).
    ``on_step``, if given, is called with the latents before the first step
    and after each."""
    on_step = on_step or (lambda _: None)
    index = torch.zeros(1, dtype=torch.long, device=latents.device)
    state = sched.init_solver_state(br.kind, latents)
    prop, encoder = br.encoder_interval > 1, None
    on_step(latents)
    for i in range(tables.shape[1]):
        key = i % br.encoder_interval == 0
        latents, state, encoder = denoise_step(
            unet, latents, index, tables, scalars, cond, br, state=state,
            z=step_noise(i) if step_noise is not None else None, inpaint=inpaint,
            encoder=None if key else encoder, want_encoder=prop and key, controlnet=controlnet)
        index += 1
        on_step(latents)
    return latents


def decode(comps: comp.Components, latents):
    """Scaled latents (B, 4, h, w) -> images (B, H, W, 3) in [-1, 1]."""
    return comps.vae.decode(latents).permute(0, 2, 3, 1)


# above this many rows the decode runs row by row: at 1024² the decoder's
# activations grow with the batch (the JAX package's ``_edit_jit``,
# imagharmony_tpu/pipelines/harmony_edit.py:654-660, on one device)
BATCHED_DECODE_ROWS = 2


def finish(comps: comp.Components, br: Branches, latents):
    """The edit's output from the loop's last latents: the latents
    (B, h, w, 4) when they are the output, else the images (B, H, W, 3),
    tile by tile with ``tile_vae``, one row at a time above
    ``BATCHED_DECODE_ROWS`` rows."""
    if br.latent_output:
        return latents.permute(0, 2, 3, 1)
    if br.tile_vae:
        return comps.vae.decode_tiled(latents).permute(0, 2, 3, 1)
    if latents.shape[0] > BATCHED_DECODE_ROWS:
        return torch.cat([decode(comps, latents[i:i + 1]) for i in range(latents.shape[0])])
    return decode(comps, latents)


def to_uint8(images: torch.Tensor) -> np.ndarray:
    arr = images.float().cpu().numpy()
    return (np.clip(arr / 2 + 0.5, 0.0, 1.0) * 255).round().astype(np.uint8)


@dataclasses.dataclass
class EditCall:
    """One edit after the host's preprocessing, what the JAX package's
    ``_edit_jit`` takes, on the pipeline's device: the options; the token
    ids (and prompt weights), keyed as ``build_conditioning`` reads them,
    one row a request; the CLIP pixels, one row a request (R, H, W, 3), or
    None; the initial N(0, 1) noise, or the handed-off latents, (B, 4, h, w)
    fp32, B = requests x samples, each request's samples in a row; the
    micro-conditioning rows (2, 6); the schedule and its per-step table (``scan_tables``); the
    scalars (guidance scale, rescale, the first step's level, the initial
    sigma); the init image (1, 3, H, W) and the inpaint mask (1, 1, h, w),
    fp32, or None; the seed of the stochastic samplers' draws, and, for
    tests only, the draws themselves (num_steps, B, 4, h, w); the control
    images, one row a request (R, 3, Hc, Wc) in [0, 1], or None.
    ``scalars`` holds the ControlNet's conditioning scale fifth.
    ``rows``: (start, stop, total) where the call is this rank's rows of a
    call of ``total`` rows split over a mesh's data axis (the stochastic
    samplers then draw all ``total`` rows and keep these), else None."""

    opts: EditOptions
    ids: dict
    pixel_values: Optional[torch.Tensor]
    noise: torch.Tensor
    time_ids: torch.Tensor
    schedule: sched.Schedule
    tables: torch.Tensor
    scalars: torch.Tensor
    init_pixels: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    step_seed: Optional[int] = None
    step_noise: Optional[torch.Tensor] = None
    control: Optional[torch.Tensor] = None
    rows: Optional[tuple] = None

    @property
    def requests(self) -> int:
        """The requests the call packs: ``generate_batch``'s B, else 1."""
        return self.ids["pos_l"].shape[0]

    @property
    def samples(self) -> int:
        """The samples of each request (``num_samples``)."""
        return self.noise.shape[0] // self.requests

    @property
    def branches(self) -> Branches:
        o = self.opts
        cfg = o.guidance_scale > 1.0
        return Branches(
            kind=self.schedule.kind, prediction_type=o.prediction_type, cfg=cfg,
            rescale=cfg and o.guidance_rescale > 0.0,
            image_prompt=self.pixel_values is not None,
            harmony=o.use_harmony and "extra_l" in self.ids,
            weights=("pos_w" in self.ids, "neg_w" in self.ids),
            init_image=self.init_pixels is not None,
            # inpainting at strength 1 starts from pure noise
            from_image=self.init_pixels is not None
            and not (self.mask is not None and o.img2img_skip == 0),
            inpaint=self.mask is not None,
            latent_output=o.return_latents or o.denoising_end is not None,
            tile_vae=o.tile_vae, clip_skip=o.clip_skip, encoder_interval=o.encoder_interval,
            controlnet=self.control is not None)


class PhaseClock:
    """Wall seconds of the phases of a call, the device synchronized at each
    mark; does nothing without a ``timings`` dict."""

    def __init__(self, timings, device, t0):
        self.timings, self.device, self.t = timings, device, t0

    def mark(self, name):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name], self.t = now - self.t, now


def start(comps: comp.Components, br: Branches, opts: EditOptions, ids, pixel_values,
          init_pixels, noise, time_ids, scalars, control=None):
    """The edit's first part, what a captured program's conditioning graph
    runs: the step's conditioning (``cfg_rows`` of ``build_conditioning``
    and, with ``br.controlnet``, the control images (R, 3, Hc, Wc) in the
    weights' dtype, each of the ids' requests repeated for its samples:
    the noise's rows over the requests), the loop's first latents and the
    init image's latents (or None)."""
    b = noise.shape[0]
    n = b // ids["pos_l"].shape[0]
    cond = build_conditioning(comps, opts, ids, pixel_values, num_samples=n, time_ids=time_ids)
    ctrl = None
    if br.controlnet:
        ctrl = _repeat_rows(control.to(comps.unet.conv_in.weight.dtype), n)
        ctrl = torch.cat([ctrl, ctrl])
    cond = cfg_rows(cond + (ctrl,), br.cfg)
    img_lat = image_latents(comps, init_pixels, b) if br.init_image else None
    latents = initial_latents(br.kind, scalars, noise, img_lat if br.from_image else None,
                              comps.unet.conv_in.weight.dtype)
    return cond, latents, img_lat


def step_noise_of(call: EditCall, like: torch.Tensor):
    """The eager loop's draws: None for a deterministic sampler, the call's
    own draws where a test gives them, else one draw a step from a
    generator seeded with the call's ``step_seed``."""
    if call.schedule.kind not in sched.STOCHASTIC:
        return None
    if call.step_noise is not None:
        return lambda i: call.step_noise[i]
    gen = torch.Generator(device=like.device).manual_seed(call.step_seed)
    if call.rows is None:
        return lambda i: draw_step_noise(gen, torch.empty(like.shape, dtype=torch.float32,
                                                          device=like.device))
    start, stop, total = call.rows
    shape = (total,) + tuple(like.shape[1:])
    return lambda i: draw_step_noise(gen, torch.empty(shape, dtype=torch.float32,
                                                      device=like.device))[start:stop]


def edit(comps: comp.Components, call: EditCall, clock: Optional[PhaseClock] = None,
         on_step=None):
    """The edit after preprocessing, eagerly: ``start``, ``denoise``,
    ``finish``. Images (B, H, W, 3) in [-1, 1], or latents (B, h, w, 4).
    generate() runs this on the CPU; on a CUDA device it is the eager
    reference of the captured programs (``programs.py``), which generate()
    runs there. ``on_step``: as ``denoise`` takes it."""
    clock = clock or PhaseClock(None, None, 0.0)
    br = call.branches
    cond, latents, img_lat = start(comps, br, call.opts, call.ids, call.pixel_values,
                                   call.init_pixels, call.noise, call.time_ids, call.scalars,
                                   call.control)
    clock.mark("conditioning_s")
    inpaint = (call.mask, img_lat, call.noise) if br.inpaint else None
    latents = denoise(comps.unet, latents, cond, call.tables, call.scalars, br, inpaint=inpaint,
                      step_noise=step_noise_of(call, latents), on_step=on_step,
                      controlnet=comps.controlnet)
    clock.mark("denoise_s")
    out = finish(comps, br, latents)
    clock.mark("decode_s")
    return out


def preprocess_control(cfgs: comp.ComponentConfigs, control_image, height, width):
    """One control image (PIL or HWC uint8 array) resized to the ControlNet's
    input size (the latents' size times ``cond_upscale``: the output size
    for SDXL's embedder), (1, Hc, Wc, 3) float32 in [0, 1]."""
    from PIL import Image

    if cfgs.controlnet is None:
        raise ValueError("control_image given, but the pipeline has no ControlNet (load one "
                         "with load_pipeline(..., controlnet_dir=...) or with_controlnet)")
    if isinstance(control_image, np.ndarray):
        control_image = Image.fromarray(control_image.astype(np.uint8))
    up, down = cfgs.controlnet.cond_upscale, cfgs.vae.downscale
    ch, cw = (height // down) * up, (width // down) * up
    return (np.asarray(control_image.convert("RGB").resize((cw, ch)), np.float32) / 255.0)[None]


def preprocess_init_image(image, height, width):
    """One RGB image (PIL or HWC uint8 array) resized to the output size,
    (1, H, W, 3) float32 in [-1, 1]: the VAE encoder's input (img2img)."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image.astype(np.uint8))
    arr = np.asarray(image.convert("RGB").resize((width, height)), np.float32)
    return (arr / 127.5 - 1.0)[None]


def preprocess_mask(mask_image, height, width, downscale):
    """One inpaint mask (PIL, an HW/HWC uint8 array, or an (h, w) / (h, w, 1)
    float array in [0, 1]) -> (1, h_lat, w_lat, 1) float32 in {0, 1}; white
    or 1 is repainted (diffusers' convention). Nearest-neighbour to the
    latent size, binarized at 0.5."""
    from PIL import Image

    hl, wl = height // downscale, width // downscale
    if isinstance(mask_image, np.ndarray) and mask_image.dtype != np.uint8:
        arr = np.squeeze(np.asarray(mask_image, np.float32))
        mask_image = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if isinstance(mask_image, np.ndarray):
        mask_image = Image.fromarray(mask_image)
    m = mask_image.convert("L").resize((wl, hl), Image.NEAREST)
    arr = (np.asarray(m, np.float32) >= 127.5).astype(np.float32)
    return arr[None, :, :, None]


def step_seed(seeds) -> int:
    """The seed of the stochastic samplers' per-step draws for a run's
    seed(s): a stream apart from the initial noise's."""
    state = np.random.SeedSequence([int(s) for s in seeds] + [STEP_NOISE_TAG])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _pair(x):
    return tuple(x) if x else None


def check_options(cfgs: comp.ComponentConfigs, *, prediction_type, encoder_interval, clip_skip):
    """The option checks every entry point makes before any work."""
    if prediction_type not in sched.PREDICTION_TYPES:
        raise ValueError(f"prediction_type must be one of {sched.PREDICTION_TYPES}, got "
                         f"{prediction_type!r}")
    if int(encoder_interval) != encoder_interval or encoder_interval < 1:
        raise ValueError(f"encoder_interval must be an int >= 1, got {encoder_interval}")
    for tower in (cfgs.text_l, cfgs.text_g):
        if tower is not None and not 0 <= clip_skip < tower.num_layers - 1:
            raise ValueError(f"clip_skip must be in [0, {tower.num_layers - 2}], got {clip_skip}")


def check_output_type(output_type):
    if output_type not in OUTPUT_TYPES:
        raise ValueError(f"output_type must be one of {OUTPUT_TYPES}, got {output_type!r}")


# what the chunked runner cannot run, refused with the JAX package's
# messages (imagharmony_tpu/pipelines/harmony_edit.py:1098-1125)
CHUNKED_SAMPLERS_REFUSED = ("euler_a", "euler_ancestral", "lcm")


def check_chunked(*, prompt_weighting=False, latents=None, denoising_start=None,
                  scheduler="euler", init_image=None, mask_image=None, **_):
    """Raises for what ``callback_on_step_end`` / ``chunk_steps`` (the
    chunked runner) does not run, before any work."""
    if prompt_weighting:
        raise ValueError("prompt_weighting is not supported on the chunked/continuous runner; "
                         "use the one-jit path")
    if latents is not None or denoising_start is not None:
        raise ValueError("callback_on_step_end/chunk_steps does not support the refiner-stage "
                         "inputs (latents=, denoising_start=); use the one-jit path for the "
                         "handoff consumer")
    if scheduler in CHUNKED_SAMPLERS_REFUSED:
        raise ValueError(f"{scheduler} is not supported on the chunked/continuous runner (its "
                         "rows sit at different schedule positions and cannot share one "
                         "per-step noise key stream); use the one-jit path")
    if init_image is not None or mask_image is not None:
        raise ValueError("callback_on_step_end/chunk_steps does not support img2img/inpainting "
                         "(init_image=/mask_image=); use the one-jit path")


class HarmonyPipeline:
    """Host front end: tokenization and CLIP preprocessing, then the edit
    on the device the weights live on.

    generate(pil_image, prompt=..., extra_text=..., ...) mirrors the
    reference entry point (IPAdapterXL.generate) with the JAX package's
    one-call signature (``prepare``'s arguments); ``generate_batch`` packs
    several requests into one program, the serving path's
    (``serving.py``)."""

    def __init__(self, components: comp.Components, tokenizers):
        from imagharmony_tpu_torch.pipelines import programs

        self.components = components
        self.cfgs = components.cfgs
        self.tokenizers = tokenizers
        p = next(components.parameters())
        self.device, self.dtype = p.device, p.dtype
        # the captured programs by key, a bounded LRU (programs.py)
        self.programs = programs.ProgramCache()
        # with_mesh's: the mesh, whether the projections are TP-sharded, and
        # the unsharded pipeline the clone was made from
        self.mesh, self.tensor_parallel, self._source = None, False, None

    # -- constructors ------------------------------------------------------

    @classmethod
    def _build(cls, comps, tokenizers=None):
        """The pipeline over loaded ``comps``, with ``tokenizers`` or, for
        random weights (whose vocab does not matter), the toy tokenizer."""
        # inference packing: one to_qkv per self-attention, so K1 and K4 get
        # q/k/v as strided column views of a single projection output
        pack_inference_params(comps.unet)
        if comps.controlnet is not None:
            pack_inference_params(comps.controlnet)
        if tokenizers is None:
            toy = tok_lib.build_toy_tokenizer()
            tokenizers = tok_lib.SDXLTokenizers(toy, toy)
        return cls(comps.eval().requires_grad_(False), tokenizers)

    @classmethod
    def random(cls, cfgs: comp.ComponentConfigs, seed=0, *, device="cuda",
               dtype=torch.float32):
        """Random-weight pipeline over ``cfgs`` with the toy tokenizer (random
        weights make the vocab irrelevant), built on ``device``."""
        gen = torch.Generator(device=device).manual_seed(seed)
        return cls._build(comp.init_params(gen, cfgs, dtype=dtype, device=device))

    @classmethod
    def random_tiny(cls, seed=0, *, proj_kind="image_proj", device="cuda",
                    dtype=torch.float32):
        """Random-weight miniature SDXL pipeline (tests)."""
        cfgs = comp.tiny_configs(vocab_size=len(tok_lib.build_toy_tokenizer().encoder),
                                 proj_kind=proj_kind)
        return cls.random(cfgs, seed, device=device, dtype=dtype)

    @classmethod
    def random_tiny_sd15(cls, seed=0, *, device="cuda", dtype=torch.float32):
        """Random-weight miniature SD1.5 pipeline (single text tower, vanilla
        IP-Adapter on every cross-attention, no HA)."""
        cfgs = comp.sd15_tiny_configs(vocab_size=len(tok_lib.build_toy_tokenizer().encoder))
        return cls.random(cfgs, seed, device=device, dtype=dtype)

    @classmethod
    def random_full(cls, seed=0, *, device="cuda", dtype=dtypes.COMPUTE_DTYPE):
        """Full-size random-weight SDXL pipeline."""
        return cls.random(comp.sdxl_configs(), seed, device=device, dtype=dtype)

    @classmethod
    def random_tiny_refiner(cls, seed=0, *, device="cuda", dtype=torch.float32):
        """Random-weight miniature SDXL-refiner pipeline (the bigG tower
        alone, aesthetic-score micro-conditioning, no image prompt)."""
        cfgs = comp.sdxl_refiner_tiny_configs(
            vocab_size=len(tok_lib.build_toy_tokenizer().encoder))
        return cls.random(cfgs, seed, device=device, dtype=dtype)

    @classmethod
    def random_full_refiner(cls, seed=0, *, device="cuda", dtype=dtypes.COMPUTE_DTYPE):
        """Full-size random-weight SDXL-refiner-1.0 pipeline (widths
        384/768/1536/1536, four transformer layers a block, bigG)."""
        return cls.random(comp.sdxl_refiner_configs(), seed, device=device, dtype=dtype)

    @classmethod
    def random_full_sd15(cls, seed=0, *, device="cuda", dtype=dtypes.COMPUTE_DTYPE):
        """Full-size random-weight SD1.5 pipeline (CLIP-L, ViT-H, 4 tokens)."""
        return cls.random(comp.sd15_configs(), seed, device=device, dtype=dtype)

    @classmethod
    def from_state_dict(cls, state_dict, cfgs: comp.ComponentConfigs, *, device="cuda",
                        dtype=torch.float32):
        """Pipeline over given weights (e.g. io/from_jax.state_dict of a
        JAX bundle), with the toy tokenizer, whose vocab is the tiny
        configs' (real weights come with their tokenizers:
        ``io/checkpoints.load_pipeline`` reads a tree's)."""
        with torch.device("meta"):
            comps = comp.Components(cfgs, dtype=dtype)
        comps = comps.to_empty(device=device)
        return cls._build(comp.load_state_dict_(comps, state_dict))

    def _clone(self, cfgs=None, tokenizers=None, **modules):
        """A new pipeline over this one's components with ``modules``
        replaced (every other weight shared), ``cfgs`` and ``tokenizers`` if
        given, and no captured programs: a graph captured on the old weights
        never runs on the new ones."""
        comps = copy.copy(self.components)
        comps._modules = dict(comps._modules)
        for name, m in modules.items():
            setattr(comps, name, m)
        if cfgs is not None:
            comps.cfgs = cfgs
        return HarmonyPipeline(comps, self.tokenizers if tokenizers is None else tokenizers)

    def with_mesh(self, mesh, *, tensor_parallel=False):
        """A clone over ``mesh`` (``parallel/mesh.py``; every rank calls
        generate with the same arguments): the request's noise rows split
        over the ``data`` axis where their count divides it (each rank
        denoises and decodes its rows, then all ranks gather the whole
        output), every rank computes all rows where it does not, as JAX's
        ``_place_request`` replicates them, and where a rank's rows would
        cross a request's edge (``_local_call``). Each rank draws every row's
        noise from the seed, so the rows are the one-device call's.

        ``tensor_parallel=True`` also splits the attention and FFN
        projections of every tower over the ``model`` axis
        (``tp_rules.shard_module_tp``: heads whole, row-parallel outputs
        all-reduced), cutting one image's latency. The clone's modules are
        new and share every unsharded tensor with this pipeline, which is
        left as it was; it starts with no captured programs (their key
        holds the mesh). The decode rule of JAX's ``_use_batched_decode``
        (batched only at two rows or fewer a shard) is ``finish``'s
        row-by-row decode above ``BATCHED_DECODE_ROWS`` applied to each
        rank's rows."""
        from imagharmony_tpu_torch.parallel import tp_rules

        source = self._source if self._source is not None else self
        if tensor_parallel and mesh.n_model > 1:
            comps = comp.share_copy(source.components)
            tp_rules.shard_module_tp(mesh, comps)
        else:
            comps = copy.copy(source.components)
            comps._modules = dict(comps._modules)
        clone = HarmonyPipeline(comps, source.tokenizers)
        clone.mesh, clone.tensor_parallel, clone._source = mesh, tensor_parallel, source
        return clone

    def _remesh(self, build):
        """``build(pipeline)``'s new pipeline; on a mesh clone built from the
        unsharded source and put on the mesh again (JAX's with_* re-establish
        the placement the same way)."""
        if self.mesh is None:
            return build(self)
        return build(self._source).with_mesh(self.mesh, tensor_parallel=self.tensor_parallel)

    def with_lora(self, lora, *, scale=1.0, lora_cfg=None):
        """A new pipeline whose UNet has LoRA factors merged in:
        ``W + scale * (alpha/r) * A @ B`` at every factored projection, in
        fp32 (``adapters/lora.apply_lora``; no cost a step after). ``lora``:
        a ``save_lora`` or community ``.safetensors`` path, or a factor dict
        with ``lora_cfg``. Every other weight is shared with this pipeline,
        which is left as it was; the new one starts with no captured
        programs. Repeatable: merges add."""
        from imagharmony_tpu_torch.adapters import lora as lora_lib

        if isinstance(lora, (str, bytes, os.PathLike)):
            lora, lora_cfg = lora_lib.load_lora(os.fsdecode(lora))
        elif lora_cfg is None:
            raise ValueError("pass lora_cfg when giving a factor dict")
        return self._remesh(lambda pipe: pipe._clone(unet=lora_lib.apply_lora(
            pipe.components.unet, lora, lora_cfg, scale=scale)))

    def with_controlnet(self, controlnet):
        """A new pipeline with ``controlnet`` (a ``models/controlnet``
        ControlNetModel on this pipeline's device, built on its UNet's
        config) as its ControlNet branch; every other weight shared, no
        captured programs."""
        from imagharmony_tpu_torch.nn.attention import pack_inference_params

        if controlnet.cn_cfg.base != self.cfgs.unet:
            raise ValueError("the ControlNet's base config is not this pipeline's UNet's")
        packed = pack_inference_params(controlnet.eval().requires_grad_(False))
        return self._remesh(lambda pipe: pipe._clone(
            dataclasses.replace(pipe.cfgs, controlnet=controlnet.cn_cfg), controlnet=packed))

    def with_textual_inversion(self, source, token=None):
        """A new pipeline with a learned textual-inversion embedding
        installed (diffusers load_textual_inversion role): the placeholder
        ``token`` becomes a literal tokenizer token whose ids are rows
        appended to the text towers' token tables; a multi-vector
        embedding's one prompt token expands to its n ids. Every other
        weight is shared with this pipeline, which is left as it was; the
        new one starts with no captured programs.

        ``source``: a ``.safetensors`` file, an A1111 ``.pt``/``.bin`` file
        (``{"string_to_param": {"*": rows}, "name": ...}`` or a bare
        ``{token: rows}``), or a ``{key: (n, D) rows}`` dict. SDXL takes the
        dual-tower ``{"clip_l": ..., "clip_g": ...}``; SD1.5 one entry whose
        key is the token name (or ``token=``), as does the refiner (bigG's
        rows: ``clip_g`` of a dual file). Chainable: once per concept."""
        from imagharmony_tpu_torch.io import safetensors, torch_zip

        if isinstance(source, (str, bytes, os.PathLike)):
            name = os.fsdecode(source)
            if name.endswith((".pt", ".bin")):
                obj = torch_zip.load(name)
                if isinstance(obj, dict) and "string_to_param" in obj:
                    vec = next(iter(obj["string_to_param"].values()))
                    if token is None and isinstance(obj.get("name"), str):
                        token = obj["name"]
                    tensors = {token or "<concept>": vec}
                else:
                    tensors = {k: v for k, v in obj.items() if hasattr(v, "shape")}
            else:
                tensors, _ = safetensors.load(name)
        else:
            tensors = dict(source)

        dual = "clip_l" in tensors and "clip_g" in tensors
        if not dual and len(tensors) != 1:
            raise ValueError("expected {'clip_l', 'clip_g'} (SDXL) or a single token-keyed "
                             f"entry, got keys {sorted(tensors)}")
        if token is None:
            token = "<concept>" if dual else next(iter(tensors))
        token = token.lower()
        if self.cfgs.family == "sd15":
            jobs = [("text_encoder", "text_l", "tok1", tensors[next(iter(tensors))])]
        elif self.cfgs.family == "sdxl_refiner":
            rows = tensors["clip_g"] if dual else tensors[next(iter(tensors))]
            jobs = [("text_encoder_2", "text_g", "tok2", rows)]
        elif dual:
            jobs = [("text_encoder", "text_l", "tok1", tensors["clip_l"]),
                    ("text_encoder_2", "text_g", "tok2", tensors["clip_g"])]
        else:
            raise ValueError("SDXL textual inversion needs the dual-tower format "
                             "{'clip_l': (n, 768), 'clip_g': (n, 1280)}")

        return self._remesh(lambda pipe: pipe._install_tokens(jobs, token))

    def _install_tokens(self, jobs, token):
        """``with_textual_inversion``'s new pipeline: each job's rows
        appended to its tower's token table and the token added to its
        tokenizer."""
        toks = {"tok1": copy.copy(self.tokenizers.tok1), "tok2": copy.copy(self.tokenizers.tok2)}
        for t in toks.values():  # their own added tokens, even where tok1 is tok2
            t.added_tokens = dict(t.added_tokens)
        cfgs, n_vec, towers = self.cfgs, None, {}
        for attr, field, tok, rows in jobs:
            rows = torch.atleast_2d(torch.as_tensor(np.asarray(rows, np.float32)))
            if n_vec is not None and rows.shape[0] != n_vec:
                raise ValueError("clip_l/clip_g vector counts differ")
            n_vec = rows.shape[0]
            towers[attr], first = getattr(self.components, attr).with_token_rows(rows)
            cfgs = dataclasses.replace(cfgs, **{field: towers[attr].cfg})
            toks[tok].add_token(token, range(first, first + n_vec))
        return self._clone(cfgs, tok_lib.SDXLTokenizers(toks["tok1"], toks["tok2"]), **towers)

    # -- pieces ------------------------------------------------------------

    def _max_len(self):
        return (self.cfgs.text_l or self.cfgs.text_g).max_position_embeddings

    def _tokenize(self, text):
        ids1, ids2 = self.tokenizers(text or "")
        max_l = self._max_len()
        as_t = lambda a: torch.as_tensor(np.asarray(a)[:, :max_l], dtype=torch.long,
                                         device=self.device)
        return as_t(ids1), as_t(ids2)

    def _tokenize_weighted(self, text):
        """Tokenize with the A1111 ``(word:1.5)`` grammar
        (``utils/prompts.py``): (ids_l, ids_g, weights (1, S) fp32 or None).
        With no weighting syntax the ids are ``_tokenize``'s; weighted
        prompts are tokenized fragment by fragment, so the weights line up
        with the ids."""
        from imagharmony_tpu_torch.utils import prompts

        frags = prompts.parse_prompt_attention(text or "")
        if not prompts.is_weighted(frags):
            return self._tokenize(prompts.plain_text(frags)) + (None,)
        max_l = self._max_len()

        def build(tok):
            toks, ws = [], []
            for frag, w in frags:
                fids = tok.encode(frag, pad_to_max=False)[1:-1]
                toks.extend(fids)
                ws.extend([w] * len(fids))
            toks, ws = toks[: max_l - 2], ws[: max_l - 2]
            ids = [tok.bos_token_id] + toks + [tok.eos_token_id]
            ids += [tok.pad_token_id] * (max_l - len(ids))
            return ids, [1.0] + ws + [1.0] * (max_l - 1 - len(ws))

        (i1, w1), (i2, w2) = build(self.tokenizers.tok1), build(self.tokenizers.tok2)
        if w1 != w2:
            raise ValueError("the two text towers tokenize the weighted prompt to different "
                             "lengths: prompt weighting needs aligned tokens")
        as_t = lambda a, dt: torch.tensor([a], dtype=dt, device=self.device)
        return as_t(i1, torch.long), as_t(i2, torch.long), as_t(w1, torch.float32)

    def _pixel_values(self, pil_image):
        arr = clip_vision.preprocess_numpy(pil_image, image_size=self.cfgs.vision.image_size)
        return torch.as_tensor(arr[:1], device=self.device)

    def _ids(self, prompt, extra_text, negative_prompt=DEFAULT_NEGATIVE, weighting=False):
        """Token ids of the prompt, the negative prompt and (if given) the
        extra_text, and the prompts' weights where ``weighting`` finds
        any, keyed as build_conditioning expects."""
        ids = {}
        if weighting:
            ids["pos_l"], ids["pos_g"], w_pos = self._tokenize_weighted(prompt)
            ids["neg_l"], ids["neg_g"], w_neg = self._tokenize_weighted(negative_prompt)
            for k, w in (("pos_w", w_pos), ("neg_w", w_neg)):
                if w is not None:
                    ids[k] = w
        else:
            ids["pos_l"], ids["pos_g"] = self._tokenize(prompt)
            ids["neg_l"], ids["neg_g"] = self._tokenize(negative_prompt)
        if extra_text is not None:
            ids["extra_l"], ids["extra_g"] = self._tokenize(extra_text)
        return ids

    def set_scale(self, scale: float):
        """Kept for API familiarity (the reference's ip_adapter.py:179-182),
        as in the JAX package, which stores the value and reads it nowhere:
        pass scale= to generate()."""
        self._default_scale = scale

    def _noise(self, seed, num_samples, lat_shape):
        """The initial N(0, 1) noise (num_samples, h, w, 4) on the device:
        one generator a sample for a seed list, so that sample i of a list
        is a one-sample run of seed i."""
        if isinstance(seed, (list, tuple)):
            if len(seed) != num_samples:
                raise ValueError(f"len(seed) {len(seed)} != num_samples {num_samples}")
            return torch.cat([torch.randn((1,) + lat_shape, device=self.device,
                                          generator=torch.Generator(device=self.device)
                                          .manual_seed(int(s))) for s in seed])
        gen = torch.Generator(device=self.device).manual_seed(0 if seed is None else int(seed))
        return torch.randn((num_samples,) + lat_shape, generator=gen, device=self.device)

    # -- main entry --------------------------------------------------------

    def prepare(self, pil_image=None, *, pixel_values=None, prompt: Optional[str] = None,
                negative_prompt: Optional[str] = None, extra_text: Optional[str] = None,
                scale: float = 1.0, num_samples: int = 1, seed=None,
                guidance_scale: float = 5.0, num_inference_steps: int = 30,
                height: int = 1024, width: int = 1024, scheduler: str = "euler",
                control_guidance_start: float = 0.0, control_guidance_end: float = 1.0,
                tile_vae: bool = False, control_image=None,
                controlnet_conditioning_scale: float = 1.0, guidance_rescale: float = 0.0,
                denoising_end: Optional[float] = None, denoising_start: Optional[float] = None,
                latents=None, init_image=None, mask_image=None,
                strength: Optional[float] = None, timestep_spacing: str = "leading",
                use_karras_sigmas: bool = False, original_size=None,
                crops_coords_top_left=(0, 0), target_size=None, negative_original_size=None,
                negative_crops_coords_top_left=None, negative_target_size=None,
                output_type: str = "np", callback_on_step_end=None,
                chunk_steps: Optional[int] = None, encoder_interval: int = 1,
                prediction_type: str = "epsilon", rescale_zero_snr: bool = False,
                aesthetic_score: float = 6.0, negative_aesthetic_score: float = 2.5,
                clip_skip: int = 0, prompt_weighting: bool = False, noise=None,
                _step_noise=None) -> EditCall:
        """The host's part of generate(): checks, CLIP preprocessing,
        tokenization, the schedule and its table, the initial noise, the
        init image and mask, on the pipeline's device. The arguments are the
        JAX package's ``generate()``'s, with its defaults:

        pil_image / pixel_values: the image prompt (a PIL image or HWC uint8
        array, or CLIP-preprocessed (1, H, W, 3)); neither: text-to-image,
        the IP branch off. scale: the IP branch's weight, over the
        [control_guidance_start, control_guidance_end) window of the steps.
        seed: an int, or one a sample (sample i of a list is a one-sample
        run of seed i); the stochastic samplers draw their per-step noise
        from a generator seeded from the seed(s) on a stream apart.
        scheduler: euler, euler_a, ddim, dpm++ or lcm, with
        timestep_spacing, use_karras_sigmas, prediction_type and
        rescale_zero_snr. guidance_scale <= 1 runs no CFG. denoising_end:
        stop at that fraction and return latents; latents= (num_samples,
        h, w, 4) with denoising_start: the other side of the handoff.
        init_image (img2img, strength default 0.8) and mask_image
        (inpainting, white repainted, strength default 1.0). The SDXL
        micro-conditioning overrides, clip_skip, encoder_interval, tile_vae
        and prompt_weighting as in ``EditOptions``. output_type: "np"
        (uint8), "raw" (float tensor in [-1, 1]), "latent" or "pil".
        noise: the initial N(0, 1) noise (num_samples, h, w, 4) in place of
        the seed's. ``_step_noise`` (tests only): the stochastic samplers'
        draws (num_steps, num_samples, h, w, 4).

        control_image (PIL or HWC uint8) runs the pipeline's ControlNet at
        controlnet_conditioning_scale. aesthetic_score and
        negative_aesthetic_score are the refiner's micro-conditioning (read
        by that family only); the refiner takes no image prompt.
        callback_on_step_end / chunk_steps run the chunked runner, which
        generate() takes (``continuous.py``); this one-call path refuses
        them. Every refused combination raises before any work."""
        if callback_on_step_end is not None or chunk_steps is not None:
            raise ValueError("callback_on_step_end / chunk_steps run the chunked runner: "
                             "generate() takes them, prepare() is the one-call path's")
        if self.cfgs.vision is None and (pil_image is not None or pixel_values is not None):
            raise ValueError(f"this pipeline has no image encoder (family={self.cfgs.family}); "
                             "pass init_image=/latents= to refine an image, not pil_image=")
        control = None
        if control_image is not None:
            control = preprocess_control(self.cfgs, control_image, height, width)
        check_output_type(output_type)
        check_options(self.cfgs, prediction_type=prediction_type,
                      encoder_interval=encoder_interval, clip_skip=clip_skip)
        if mask_image is not None and init_image is None:
            raise ValueError("mask_image= requires init_image= (the image whose unmasked "
                             "region is kept)")
        if latents is not None and denoising_start is None:
            raise ValueError("latents= requires denoising_start= (the base run's "
                             "denoising_end)")
        if latents is not None and noise is not None:
            raise ValueError("give latents= or noise=, not both")
        if init_image is not None and (latents is not None or denoising_start is not None):
            raise ValueError("init_image= cannot combine with the refiner-stage inputs "
                             "(latents=, denoising_start=)")
        if strength is None:
            strength = 1.0 if mask_image is not None else 0.8
        img2img_skip = 0
        if init_image is not None:
            img2img_skip = sched.img2img_skip_steps(num_inference_steps, strength)

        opts = EditOptions(
            height=height, width=width, num_inference_steps=num_inference_steps,
            scheduler=scheduler, timestep_spacing=timestep_spacing, use_karras=use_karras_sigmas,
            guidance_scale=guidance_scale, ip_scale=scale,
            control_guidance_start=control_guidance_start,
            control_guidance_end=control_guidance_end, use_harmony=extra_text is not None,
            tile_vae=tile_vae, guidance_rescale=guidance_rescale, denoising_end=denoising_end,
            denoising_start=denoising_start, return_latents=output_type == "latent",
            img2img_skip=img2img_skip, original_size=_pair(original_size),
            crops_coords_top_left=tuple(crops_coords_top_left), target_size=_pair(target_size),
            negative_original_size=_pair(negative_original_size),
            negative_crops_coords_top_left=_pair(negative_crops_coords_top_left),
            negative_target_size=_pair(negative_target_size),
            encoder_interval=int(encoder_interval), prediction_type=prediction_type,
            rescale_zero_snr=rescale_zero_snr, clip_skip=clip_skip,
            aesthetic_score=aesthetic_score, negative_aesthetic_score=negative_aesthetic_score)
        schedule, ip_scales = schedule_for(opts)
        stochastic = schedule.kind in sched.STOCHASTIC
        if _step_noise is not None and (not stochastic or self.device.type == "cuda"):
            raise ValueError("_step_noise is for the stochastic samplers' eager loop on the "
                             "CPU (tests); a card's programs draw from the seed")

        down = self.cfgs.vae.downscale
        lat_shape = (height // down, width // down, 4)
        if latents is not None:
            noise = latents  # the handed-off latents: their schedule applies no initial sigma
        if noise is None:
            noise = self._noise(seed, num_samples, lat_shape)
        if not isinstance(noise, torch.Tensor):
            noise = torch.from_numpy(np.array(noise, np.float32))
        noise = noise.to(device=self.device, dtype=torch.float32)
        if tuple(noise.shape) != (num_samples,) + lat_shape:
            what = "latents" if latents is not None else "noise"
            raise ValueError(f"{what} must be {(num_samples,) + lat_shape}, got "
                             f"{tuple(noise.shape)}")

        if pil_image is not None or pixel_values is not None:
            if pixel_values is None:
                pixel_values = clip_vision.preprocess_numpy(
                    pil_image, image_size=self.cfgs.vision.image_size)
            if not isinstance(pixel_values, torch.Tensor):
                pixel_values = torch.from_numpy(np.array(pixel_values, np.float32))
            pixel_values = pixel_values[:1].to(self.device, torch.float32)
        ids = self._ids(prompt or DEFAULT_PROMPT, extra_text,
                        negative_prompt or DEFAULT_NEGATIVE, prompt_weighting)

        def on_device(x, nhwc_to_nchw=True):
            x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            return x.permute(0, 3, 1, 2).contiguous() if nhwc_to_nchw else x

        scalars = [guidance_scale, guidance_rescale, float(schedule.sigmas[0]),
                   schedule.init_noise_sigma, controlnet_conditioning_scale]
        step_noise = None
        if _step_noise is not None:
            want = (schedule.num_steps, num_samples) + lat_shape
            if np.shape(_step_noise) != want:
                raise ValueError(f"_step_noise must be {want}, got {np.shape(_step_noise)}")
            step_noise = on_device(_step_noise, False).permute(0, 1, 4, 2, 3).contiguous()
        return EditCall(
            opts=opts, ids=ids, pixel_values=pixel_values,
            noise=noise.permute(0, 3, 1, 2).contiguous(),
            time_ids=time_ids_rows(opts, self.cfgs.family).to(self.device), schedule=schedule,
            tables=scan_tables(schedule, ip_scales, self.device),
            scalars=torch.tensor(scalars, dtype=torch.float32, device=self.device),
            control=None if control is None else on_device(control),
            init_pixels=None if init_image is None
            else on_device(preprocess_init_image(init_image, height, width)),
            mask=None if mask_image is None
            else on_device(preprocess_mask(mask_image, height, width, down)),
            step_seed=step_seed(seed if isinstance(seed, (list, tuple))
                                else [0 if seed is None else seed]) if stochastic else None,
            step_noise=step_noise)

    def prepare_batch(self, images, prompts, *, extra_texts=None, negative_prompts=None,
                      seeds=None, control_images=None, noise=None, **shared_kw) -> EditCall:
        """``generate_batch``'s host work: B requests as one ``EditCall``
        (ids, pixels and noise one row a request, num_samples 1). The
        requests share every option; each brings its image (all or none:
        none is text-to-image), prompt, extra_text (the HA fusion runs only
        when every request has one), negative prompt and seed (default
        ``range(B)``: one generator a seed, as a seed list draws).
        ``shared_kw``: the JAX ``generate_batch``'s, ``EditOptions``' fields
        with num_inference_steps, scheduler, guidance_scale, scale, height
        and width, and ``controlnet_scale``. ``control_images``: one a
        request (all or none) for the pipeline's ControlNet. ``noise``
        (tests): the initial N(0, 1) noise (B, h, w, 4) in place of the
        seeds'."""
        b = len(images) if images is not None else len(prompts)
        prompts = [p or DEFAULT_PROMPT for p in prompts]
        negative_prompts = [n or DEFAULT_NEGATIVE for n in (negative_prompts or [None] * b)]
        extra_texts = list(extra_texts) if extra_texts is not None else [None] * b
        seeds = list(seeds) if seeds else list(range(b))
        if any(len(x) != b for x in (prompts, negative_prompts, extra_texts, seeds)):
            raise ValueError(f"generate_batch: {b} requests, but {len(prompts)} prompts, "
                             f"{len(negative_prompts)} negative prompts, {len(extra_texts)} "
                             f"extra_texts and {len(seeds)} seeds")
        use_extra = all(e is not None for e in extra_texts)
        pixel_values = None
        if images is not None and any(im is not None for im in images):
            if self.cfgs.vision is None:
                raise ValueError(f"this pipeline has no image encoder (family="
                                 f"{self.cfgs.family}); pass images=None")
            if any(im is None for im in images):
                raise ValueError("generate_batch: images must be all-or-none within a packed "
                                 "batch (none is text-to-image)")
            pixel_values = torch.as_tensor(np.concatenate([
                clip_vision.preprocess_numpy(im, image_size=self.cfgs.vision.image_size)
                for im in images]), device=self.device)

        def rows(texts):
            toks = [self._tokenize(t) for t in texts]
            return torch.cat([x[0] for x in toks]), torch.cat([x[1] for x in toks])

        ids = {}
        ids["pos_l"], ids["pos_g"] = rows(prompts)
        ids["neg_l"], ids["neg_g"] = rows(negative_prompts)
        if use_extra:
            ids["extra_l"], ids["extra_g"] = rows(extra_texts)
        cn_scale = shared_kw.pop("controlnet_scale", 1.0)
        opts = EditOptions(
            height=shared_kw.pop("height", 1024), width=shared_kw.pop("width", 1024),
            num_inference_steps=shared_kw.pop("num_inference_steps", 30),
            scheduler=shared_kw.pop("scheduler", "euler"),
            guidance_scale=shared_kw.pop("guidance_scale", 5.0),
            ip_scale=shared_kw.pop("scale", 1.0), use_harmony=use_extra, **shared_kw)
        check_options(self.cfgs, prediction_type=opts.prediction_type,
                      encoder_interval=opts.encoder_interval, clip_skip=opts.clip_skip)
        schedule, ip_scales = schedule_for(opts)
        down = self.cfgs.vae.downscale
        lat_shape = (opts.height // down, opts.width // down, 4)
        if noise is None:
            noise = self._noise(seeds, b, lat_shape)
        if not isinstance(noise, torch.Tensor):
            noise = torch.from_numpy(np.array(noise, np.float32))
        noise = noise.to(self.device, torch.float32)
        if tuple(noise.shape) != (b,) + lat_shape:
            raise ValueError(f"noise must be {(b,) + lat_shape}, got {tuple(noise.shape)}")
        control = None
        if control_images is not None:
            if any(c is None for c in control_images):
                raise ValueError("control_images must be all-or-none within a packed batch")
            control = torch.as_tensor(np.concatenate([
                preprocess_control(self.cfgs, c, opts.height, opts.width)
                for c in control_images]), device=self.device).permute(0, 3, 1, 2).contiguous()
        scalars = [opts.guidance_scale, opts.guidance_rescale, float(schedule.sigmas[0]),
                   schedule.init_noise_sigma, cn_scale]
        return EditCall(
            opts=opts, ids=ids, pixel_values=pixel_values,
            noise=noise.permute(0, 3, 1, 2).contiguous(),
            time_ids=time_ids_rows(opts, self.cfgs.family).to(self.device), schedule=schedule,
            tables=scan_tables(schedule, ip_scales, self.device),
            scalars=torch.tensor(scalars, dtype=torch.float32, device=self.device),
            step_seed=step_seed(seeds) if schedule.kind in sched.STOCHASTIC else None,
            control=control)

    def _local_call(self, call: EditCall) -> EditCall:
        """This rank's part of ``call`` on a mesh clone: its rows of the
        noise (``mesh.row_slice``), the requests those rows belong to, and
        ``rows`` set. ``call`` itself where every rank takes all rows: where
        the data axis does not divide the rows, and where a rank's rows
        would cross a request's edge (3 requests of 2 samples on 2 ranks),
        since a call's requests hold the same number of samples each."""
        from imagharmony_tpu_torch.parallel import mesh as mesh_lib

        total = call.noise.shape[0]
        sl = mesh_lib.row_slice(self.mesh, total)
        if sl is None:
            return call
        per, n = sl.stop - sl.start, call.samples
        if per % n and n % per:
            return call
        first = sl.start // n
        reqs = slice(first, sl.stop // n) if per % n == 0 else slice(first, first + 1)
        if reqs == slice(0, call.requests):
            ids, pixel_values, control = call.ids, call.pixel_values, call.control
        else:
            ids = {k: v[reqs] for k, v in call.ids.items()}
            pixel_values = None if call.pixel_values is None else call.pixel_values[reqs]
            control = None if call.control is None else call.control[reqs]
        return dataclasses.replace(
            call, ids=ids, pixel_values=pixel_values, control=control, noise=call.noise[sl],
            step_noise=None if call.step_noise is None else call.step_noise[:, sl],
            rows=(sl.start, sl.stop, total))

    def _run(self, call: EditCall, clock: PhaseClock):
        """The edit of a prepared call: its captured programs on a CUDA
        device (``programs.py``), the eager module functions on the CPU.
        On a mesh clone, this rank's rows, then all rows gathered."""
        local = self._local_call(call) if self.mesh is not None else call
        if self.device.type == "cuda":
            from imagharmony_tpu_torch.pipelines import programs

            out = programs.run(self, local, clock)
        else:
            out = edit(self.components, local, clock)
        if local is call:
            return out
        from imagharmony_tpu_torch.parallel import mesh as mesh_lib

        return mesh_lib.gather_rows(self.mesh, out)

    @staticmethod
    def _output(out, latent: bool, output_type: str):
        if latent or output_type == "raw":
            return out
        arr = to_uint8(out)
        if output_type == "pil":
            from PIL import Image

            return [Image.fromarray(a) for a in arr]
        return arr

    @torch.inference_mode()
    def generate(self, pil_image=None, *, timings: Optional[dict] = None, **options):
        """Edit ``pil_image`` (a PIL image or HWC uint8 array; None:
        text-to-image). ``options``: ``prepare``'s arguments, the JAX
        package's generate() signature. Returns, by ``output_type``: "np"
        uint8 (B, H, W, 3), "raw" a float tensor (B, H, W, 3) in [-1, 1],
        "pil" a list of PIL images; latents (B, h, w, 4) for "latent" or a
        ``denoising_end``.

        timings: if a dict is given, the call synchronizes the device at
        its phase boundaries and records conditioning_s, denoise_s and
        decode_s wall seconds in it.

        On a CUDA device the edit runs as the captured programs of
        ``programs.py`` (captured at the first call of a key: the device,
        the shapes and the ``Branches``; replayed after); on the CPU it runs
        ``edit``, the eager module functions. The pipeline keeps a bounded
        number of keys (``pipe.programs``, least recently used evicted),
        and a key's programs serve one call at a time (a lock each).

        callback_on_step_end / chunk_steps: the chunked runner
        (``continuous.generate_chunked``: the same edit in chunks of
        chunk_steps steps, 5 by default, ``callback_on_step_end(step,
        latents)`` after each), with the JAX package's refusals: prompt
        weighting, latents= / denoising_start, Euler-a and LCM, img2img and
        inpainting."""
        if options.get("callback_on_step_end") is not None \
                or options.get("chunk_steps") is not None:
            return self._chunked(pil_image, **options)
        clock = PhaseClock(timings, self.device, time.perf_counter())
        call = self.prepare(pil_image, **options)
        out = self._run(call, clock)
        return self._output(out, call.branches.latent_output,
                            options.get("output_type", "np"))

    def _chunked(self, pil_image, *, pixel_values=None, prompt=None, negative_prompt=None,
                 extra_text=None, seed=None, num_samples=1, chunk_steps=None,
                 callback_on_step_end=None, output_type="np", scale=1.0,
                 use_karras_sigmas=False, controlnet_conditioning_scale=1.0, noise=None,
                 control_image=None, aesthetic_score=6.0, negative_aesthetic_score=2.5,
                 _step_noise=None, strength=None, original_size=None,
                 crops_coords_top_left=(0, 0), target_size=None, negative_original_size=None,
                 negative_crops_coords_top_left=None, negative_target_size=None, **options):
        """generate() through the chunked runner, after its refusals (the
        JAX package's ``generate``, harmony_edit.py:1098-1155)."""
        from imagharmony_tpu_torch.pipelines import continuous

        unknown = set(options) - set(inspect.signature(HarmonyPipeline.prepare).parameters)
        if unknown:
            raise TypeError(f"generate() got unexpected keyword arguments {sorted(unknown)}")
        check_chunked(**options)
        check_output_type(output_type)
        opts_kw = {k: options[k] for k in (
            "guidance_scale", "num_inference_steps", "height", "width", "scheduler",
            "control_guidance_start", "control_guidance_end", "tile_vae", "guidance_rescale",
            "denoising_end", "encoder_interval", "prediction_type", "rescale_zero_snr",
            "clip_skip", "timestep_spacing") if k in options}
        return continuous.generate_chunked(
            self, pil_image=pil_image, pixel_values=pixel_values, prompt=prompt,
            negative_prompt=negative_prompt, extra_text=extra_text, seed=seed,
            num_samples=num_samples, chunk_steps=chunk_steps or 5,
            callback_on_step_end=callback_on_step_end, output_type=output_type, noise=noise,
            scale=scale, use_karras=use_karras_sigmas, original_size=_pair(original_size),
            crops_coords_top_left=tuple(crops_coords_top_left), target_size=_pair(target_size),
            negative_original_size=_pair(negative_original_size),
            negative_crops_coords_top_left=_pair(negative_crops_coords_top_left),
            negative_target_size=_pair(negative_target_size), control_image=control_image,
            controlnet_scale=controlnet_conditioning_scale, **opts_kw)

    def edit(self, image, prompt, extra_text=None, **kw):
        """generate(image, prompt=prompt, extra_text=extra_text, **kw): the
        JAX package's alias."""
        return self.generate(image, prompt=prompt, extra_text=extra_text, **kw)

    @torch.inference_mode()
    def generate_batch(self, images, prompts, *, extra_texts=None, negative_prompts=None,
                       seeds=None, control_images=None, output_type="np",
                       timings: Optional[dict] = None, noise=None, **shared_kw):
        """Pack B independent edit requests into one program (the JAX
        package's ``generate_batch``): the CFG-packed UNet batch becomes 2B
        and the host's and the launches' cost is paid once. ``images``
        (all or none), ``prompts`` and the keywords as ``prepare_batch``
        takes them; every option is shared. Returns, by ``output_type``,
        "np" uint8 (B, H, W, 3), "raw" the float images, "pil" a list.
        Above two rows the decode runs row by row. On a CUDA device it runs
        the key's captured programs (the key counts the requests), on the
        CPU the eager module functions."""
        check_output_type(output_type)
        if output_type == "latent":
            shared_kw["return_latents"] = True
        clock = PhaseClock(timings, self.device, time.perf_counter())
        call = self.prepare_batch(images, prompts, extra_texts=extra_texts,
                                  negative_prompts=negative_prompts, seeds=seeds,
                                  control_images=control_images, noise=noise, **shared_kw)
        return self._output(self._run(call, clock), call.branches.latent_output, output_type)
