"""The QL-Edit pipeline: reference image + prompt + extra_text -> edited
image (port of the main path of imagharmony_tpu/pipelines/harmony_edit.py).

The path, in eager PyTorch: text encoders -> vision encoder -> HA fusion ->
image projection -> an Euler denoise loop with the CFG pair packed on the
batch axis ([uncond | cond]) -> VAE decode. The device and dtype come from
the weights; there is no platform switch.

Two families run it. SDXL: both text towers, micro-conditioning, the HA
fusion with extra_text. SD1.5 (``cfgs.family == "sd15"``): CLIP-L's last
hidden state alone as the context, no pooled embedding and no time ids, no
HA head, the IP branch on every cross-attention. Either takes the
``image_proj`` head or, from the penultimate patch features, the
``resampler`` (Plus) or ``mlp_proj`` (Full) head.

The pipeline surface keeps the JAX layout: noise is (B, h, w, 4) and images
are (B, H, W, 3) in [-1, 1]. Inside the models activations are NCHW.

Not ported yet: the other samplers, no-CFG, guidance rescale, img2img,
inpainting, ControlNet, LoRA, the refiner, prompt weighting, textual
inversion, encoder propagation and batched/serving entry points.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class EditOptions:
    """Knobs of one edit call (the subset the ported path uses)."""

    height: int = 1024
    width: int = 1024
    num_inference_steps: int = 30
    guidance_scale: float = 5.0
    ip_scale: float = 1.0
    # the per-step IP-scale window (fractions of the schedule)
    control_guidance_start: float = 0.0
    control_guidance_end: float = 1.0
    use_harmony: bool = True

    def time_ids(self):
        """SDXL micro-conditioning: original size, crop (0, 0), target size,
        both the output size."""
        h, w = float(self.height), float(self.width)
        return [h, w, 0.0, 0.0, h, w]


def ip_scale_schedule(opts: EditOptions) -> np.ndarray:
    """Per-step IP scale: 0 outside the [start, end) window."""
    n = opts.num_inference_steps
    i = np.arange(n, dtype=np.float32)
    on = (i / n >= opts.control_guidance_start) & ((i + 1) / n <= opts.control_guidance_end)
    return np.where(on, opts.ip_scale, 0.0).astype(np.float32)


def encode_texts(comps: comp.Components, ids_l, ids_g):
    """Text conditioning (context, pooled): the dual-tower concatenation for
    SDXL; CLIP-L's last hidden state alone, with pooled None, for SD1.5."""
    if comps.cfgs.family == "sd15":
        return comps.text_encoder(ids_l)["last"], None
    return clip_text.encode_for_sdxl(comps.text_encoder, comps.text_encoder_2, ids_l, ids_g)


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


def build_conditioning(comps: comp.Components, opts: EditOptions, ids, pixel_values, *,
                       num_samples):
    """CFG-packed conditioning, each (2 * num_samples, ...) in [uncond | cond]
    row order: (context2, pooled2, time_ids, ip2); pooled2 and time_ids are
    None for the SD1.5 family."""
    ids_l = torch.cat([ids["neg_l"], ids["pos_l"]])
    ids_g = torch.cat([ids["neg_g"], ids["pos_g"]])
    context, pooled = encode_texts(comps, ids_l, ids_g)
    neg_ctx, pos_ctx = context.chunk(2)

    extra_ctx = None
    if opts.use_harmony and "extra_l" in ids:
        extra_ctx, _ = encode_texts(comps, ids["extra_l"], ids["extra_g"])

    def rep(x):
        return x.repeat_interleave(num_samples, dim=0)

    ip_cond, ip_uncond = image_prompt_tokens(comps, pixel_values, extra_ctx)
    ip2 = torch.cat([rep(ip_uncond), rep(ip_cond)])
    context2 = torch.cat([rep(neg_ctx), rep(pos_ctx)])
    if comps.cfgs.family == "sd15":
        return context2, None, None, ip2
    neg_pooled, pos_pooled = pooled.chunk(2)
    pooled2 = torch.cat([rep(neg_pooled), rep(pos_pooled)])
    tid = torch.tensor([opts.time_ids()], dtype=torch.float32, device=context.device)
    time_ids = tid.repeat(2 * num_samples, 1)
    return context2, pooled2, time_ids, ip2


def cfg_eps(unet, lat, t, sigma, context, pooled, time_ids, ip_tokens, *, kind,
            guidance_scale, ip_scale):
    """One CFG-pair UNet evaluation: the batch is [lat | lat] against the
    [uncond | cond] conditioning (pooled and time_ids None for SD1.5);
    returns the epsilon after classifier-free guidance."""
    lat_in = sched.scale_model_input_c(kind, sigma, torch.cat([lat, lat]))
    ts = torch.full((lat_in.shape[0],), float(t), dtype=torch.float32, device=lat.device)
    eps = unet(lat_in, ts, context, pooled_text_embeds=pooled, time_ids=time_ids,
               ip_tokens=ip_tokens, ip_scale=ip_scale)
    eps_u, eps_c = eps.chunk(2)
    return eps_u + guidance_scale * (eps_c - eps_u)


def denoise(unet, latents, context, pooled, time_ids, ip_tokens, schedule: sched.Schedule,
            ip_scales, *, guidance_scale):
    """The Euler denoise loop. latents (B, 4, h, w); the conditioning is
    CFG-packed (2B, ...) [uncond | cond]."""
    if guidance_scale <= 1.0:
        raise NotImplementedError("the no-CFG path (guidance_scale <= 1) is not ported yet")
    kind = schedule.kind
    state = sched.init_solver_state(kind, latents)
    for i in range(schedule.num_steps):
        sigma, sigma_next = schedule.sigmas[i], schedule.sigmas[i + 1]
        eps = cfg_eps(unet, latents, schedule.timesteps[i], sigma, context, pooled,
                      time_ids, ip_tokens, kind=kind, guidance_scale=guidance_scale,
                      ip_scale=float(ip_scales[i]))
        latents, state = sched.step_s(kind, sigma, sigma_next, eps, latents, state)
    return latents


def decode(comps: comp.Components, latents):
    """Scaled latents (B, 4, h, w) -> images (B, H, W, 3) in [-1, 1]."""
    return comps.vae.decode(latents).permute(0, 2, 3, 1)


def to_uint8(images: torch.Tensor) -> np.ndarray:
    arr = images.float().cpu().numpy()
    return (np.clip(arr / 2 + 0.5, 0.0, 1.0) * 255).round().astype(np.uint8)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class HarmonyPipeline:
    """Host front end: tokenization and CLIP preprocessing, then the edit
    on the device the weights live on.

    generate(pil_image, prompt=..., extra_text=...) mirrors the reference
    entry point (IPAdapterXL.generate)."""

    def __init__(self, components: comp.Components, tokenizers):
        self.components = components
        self.cfgs = components.cfgs
        self.tokenizers = tokenizers
        p = next(components.parameters())
        self.device, self.dtype = p.device, p.dtype

    # -- constructors ------------------------------------------------------

    @classmethod
    def _build(cls, comps):
        # inference packing: one to_qkv per self-attention, so K1 and K4 get
        # q/k/v as strided column views of a single projection output
        pack_inference_params(comps.unet)
        toy = tok_lib.build_toy_tokenizer()
        return cls(comps.eval().requires_grad_(False), tok_lib.SDXLTokenizers(toy, toy))

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
    def random_full_sd15(cls, seed=0, *, device="cuda", dtype=dtypes.COMPUTE_DTYPE):
        """Full-size random-weight SD1.5 pipeline (CLIP-L, ViT-H, 4 tokens)."""
        return cls.random(comp.sd15_configs(), seed, device=device, dtype=dtype)

    @classmethod
    def from_state_dict(cls, state_dict, cfgs: comp.ComponentConfigs, *, device="cuda",
                        dtype=torch.float32):
        """Pipeline over given weights (e.g. io/from_jax.state_dict of a
        JAX bundle), with the toy tokenizer."""
        with torch.device("meta"):
            comps = comp.Components(cfgs, dtype=dtype)
        comps = comps.to_empty(device=device)
        return cls._build(comp.load_state_dict_(comps, state_dict))

    # -- pieces ------------------------------------------------------------

    def _tokenize(self, text):
        ids1, ids2 = self.tokenizers(text or "")
        max_l = self.cfgs.text_l.max_position_embeddings
        as_t = lambda a: torch.as_tensor(np.asarray(a)[:, :max_l], dtype=torch.long,
                                         device=self.device)
        return as_t(ids1), as_t(ids2)

    def _pixel_values(self, pil_image):
        arr = clip_vision.preprocess_numpy(pil_image, image_size=self.cfgs.vision.image_size)
        return torch.as_tensor(arr[:1], device=self.device)

    def _ids(self, prompt, extra_text):
        """Token ids of the prompt, the default negative and (if given) the
        extra_text, keyed as build_conditioning expects."""
        ids = {}
        ids["pos_l"], ids["pos_g"] = self._tokenize(prompt)
        ids["neg_l"], ids["neg_g"] = self._tokenize(DEFAULT_NEGATIVE)
        if extra_text is not None:
            ids["extra_l"], ids["extra_g"] = self._tokenize(extra_text)
        return ids

    # -- main entry --------------------------------------------------------

    @torch.inference_mode()
    def generate(self, pil_image, *, prompt: Optional[str] = None,
                 extra_text: Optional[str] = None, num_samples: int = 1,
                 scale: float = 1.0, seed: Optional[int] = None,
                 guidance_scale: float = 5.0,
                 num_inference_steps: int = 30, height: int = 1024, width: int = 1024,
                 noise=None, output_type: str = "np", timings: Optional[dict] = None):
        """Edit ``pil_image`` (PIL image or HWC uint8 array).

        scale: the weight of the image-prompt (IP) branch.
        noise: optional (num_samples, h, w, 4) initial N(0, 1) latents;
        otherwise drawn from ``seed`` with a torch.Generator on the device.
        output_type: "np" (uint8 (B, H, W, 3)) or "raw" (float tensor in
        [-1, 1], (B, H, W, 3)).
        timings: if a dict is given, the call synchronizes the device at
        its phase boundaries and records conditioning_s, denoise_s and
        decode_s wall seconds in it.
        """
        t0 = time.perf_counter()
        pixel_values = self._pixel_values(pil_image)
        ids = self._ids(prompt or DEFAULT_PROMPT, extra_text)
        opts = EditOptions(height=height, width=width, num_inference_steps=num_inference_steps,
                           guidance_scale=guidance_scale, ip_scale=scale,
                           use_harmony=extra_text is not None)
        schedule = sched.make("euler", opts.num_inference_steps)
        ip_scales = ip_scale_schedule(opts)

        down = self.cfgs.vae.downscale
        lat_shape = (num_samples, height // down, width // down, 4)
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(0 if seed is None else seed)
            noise = torch.randn(lat_shape, generator=gen, device=self.device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        if tuple(noise.shape) != lat_shape:
            raise ValueError(f"noise must be {lat_shape}, got {tuple(noise.shape)}")

        comps = self.components
        context2, pooled2, time_ids, ip2 = build_conditioning(
            comps, opts, ids, pixel_values, num_samples=num_samples
        )
        latents = (noise * schedule.init_noise_sigma).to(self.dtype).permute(0, 3, 1, 2)
        if timings is not None:
            _sync(self.device)
            t1 = time.perf_counter()
            timings["conditioning_s"] = t1 - t0
        latents = denoise(comps.unet, latents, context2, pooled2, time_ids, ip2, schedule,
                          ip_scales, guidance_scale=opts.guidance_scale)
        if timings is not None:
            _sync(self.device)
            t2 = time.perf_counter()
            timings["denoise_s"] = t2 - t1
        images = decode(comps, latents)
        if timings is not None:
            _sync(self.device)
            timings["decode_s"] = time.perf_counter() - t2
        if output_type == "raw":
            return images
        return to_uint8(images)
