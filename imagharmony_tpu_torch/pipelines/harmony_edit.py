"""The QL-Edit pipeline: reference image + prompt + extra_text -> edited
image (port of the main path of imagharmony_tpu/pipelines/harmony_edit.py).

The path: text encoders -> vision encoder -> HA fusion -> image projection
-> an Euler denoise loop with the CFG pair packed on the batch axis
([uncond | cond]) -> VAE decode. The device and dtype come from the
weights. The module functions run it eagerly (``edit``: what generate()
runs on the CPU, and the reference on a card); on a CUDA device generate()
runs the same functions as captured CUDA graphs (``programs.py``). The
loop's body, ``denoise_step``, reads each step's constants from a device
table at a device step index, as the JAX package's ``lax.scan`` reads its
xs.

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
import functools
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


def _repeat_rows(x, n):
    """Each row of x n times in a row (repeat_interleave on the batch axis,
    with no host read)."""
    return x.unsqueeze(1).expand(-1, n, *x.shape[1:]).reshape(-1, *x.shape[1:])


@functools.lru_cache(maxsize=None)
def _time_ids(time_ids, device):
    """SDXL's micro-conditioning row on ``device``, made once per (row,
    device), so that a captured conditioning program copies nothing from the
    host."""
    return torch.tensor([time_ids], dtype=torch.float32, device=device)


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
        return _repeat_rows(x, num_samples)

    ip_cond, ip_uncond = image_prompt_tokens(comps, pixel_values, extra_ctx)
    ip2 = torch.cat([rep(ip_uncond), rep(ip_cond)])
    context2 = torch.cat([rep(neg_ctx), rep(pos_ctx)])
    if comps.cfgs.family == "sd15":
        return context2, None, None, ip2
    neg_pooled, pos_pooled = pooled.chunk(2)
    pooled2 = torch.cat([rep(neg_pooled), rep(pos_pooled)])
    tid = _time_ids(tuple(opts.time_ids()), context.device)
    time_ids = tid.expand(2 * num_samples, -1)
    return context2, pooled2, time_ids, ip2


def scan_tables(schedule: sched.Schedule, ip_scales, device=None) -> torch.Tensor:
    """The denoise loop's per-step constants as one (4, num_steps) fp32
    tensor on ``device``, rows (timestep, sigma, next sigma, IP scale): the
    xs of the JAX package's scan, ``sched.scan_constants(schedule) +
    (ip_scales,)``."""
    ip = torch.as_tensor(np.asarray(ip_scales, dtype=np.float32), device=device)
    return torch.stack([*sched.scan_constants(schedule, device), ip])


def denoise_step(unet, latents, index, tables, cond, *, kind, guidance_scale):
    """One step of the denoise loop, the body of the JAX package's scan:
    the CFG-pair UNet call on [latents | latents] against the CFG-packed
    ``cond`` (context2, pooled2, time_ids, ip2; pooled2 and time_ids None for
    SD1.5), classifier-free guidance, the scheduler step. Returns the next
    latents (B, 4, h, w).

    Every per-step constant is read on the device: ``index`` is a (1,)
    int64 tensor, the step, at which the timestep, sigmas and IP scale are
    gathered from ``tables`` (``scan_tables``, as long as the loop or
    longer); ``guidance_scale`` is a 0-dim fp32 tensor, applied in the
    guided epsilon's dtype. So one captured step serves every step."""
    context, pooled, time_ids, ip_tokens = cond
    t, sigma, sigma_next, ip_scale = tables.index_select(1, index).view(4).unbind(0)
    lat_in = sched.scale_model_input_c(kind, sigma, torch.cat([latents, latents]))
    eps = unet(lat_in, t.expand(lat_in.shape[0]), context, pooled_text_embeds=pooled,
               time_ids=time_ids, ip_tokens=ip_tokens, ip_scale=ip_scale)
    eps_u, eps_c = eps.chunk(2)
    eps = eps_u + guidance_scale * (eps_c - eps_u)
    return sched.step_c(kind, sigma, sigma_next, eps, latents)


def check_guidance(guidance_scale):
    if guidance_scale <= 1.0:
        raise NotImplementedError("the no-CFG path (guidance_scale <= 1) is not ported yet")


def denoise(unet, latents, context, pooled, time_ids, ip_tokens, schedule: sched.Schedule,
            ip_scales, *, guidance_scale, on_step=None):
    """The Euler denoise loop, eagerly: ``denoise_step`` once per step, the
    step index advanced on the device. latents (B, 4, h, w); the
    conditioning is CFG-packed (2B, ...) [uncond | cond]. ``on_step``, if
    given, is called with the latents before the first step and after each."""
    check_guidance(guidance_scale)
    on_step = on_step or (lambda _: None)
    dev = latents.device
    tables = scan_tables(schedule, ip_scales, dev)
    guidance = torch.full((), guidance_scale, dtype=torch.float32, device=dev)
    index = torch.zeros(1, dtype=torch.long, device=dev)
    cond = (context, pooled, time_ids, ip_tokens)
    on_step(latents)
    for _ in range(schedule.num_steps):
        latents = denoise_step(unet, latents, index, tables, cond, kind=schedule.kind,
                               guidance_scale=guidance)
        index += 1
        on_step(latents)
    return latents


def decode(comps: comp.Components, latents):
    """Scaled latents (B, 4, h, w) -> images (B, H, W, 3) in [-1, 1]."""
    return comps.vae.decode(latents).permute(0, 2, 3, 1)


def to_uint8(images: torch.Tensor) -> np.ndarray:
    arr = images.float().cpu().numpy()
    return (np.clip(arr / 2 + 0.5, 0.0, 1.0) * 255).round().astype(np.uint8)


@dataclasses.dataclass
class EditCall:
    """One edit after the host's preprocessing, what the JAX package's
    ``_edit_jit`` takes: the options, the token ids (keyed as
    ``build_conditioning`` reads them), the CLIP pixels (1, H, W, 3), the
    initial latents (B, 4, h, w), contiguous, in the weights' dtype (noise
    times the schedule's initial sigma) and the schedule."""

    opts: EditOptions
    ids: dict
    pixel_values: torch.Tensor
    latents: torch.Tensor
    schedule: sched.Schedule

    @property
    def num_samples(self) -> int:
        return self.latents.shape[0]


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


def edit(comps: comp.Components, call: EditCall, clock: Optional[PhaseClock] = None):
    """The edit after preprocessing, eagerly: ``build_conditioning``,
    ``denoise``, ``decode``. Images (B, H, W, 3) in [-1, 1]. generate()
    runs this on the CPU; on a CUDA device it is the eager reference of the
    captured programs (``programs.py``), which generate() runs there."""
    clock = clock or PhaseClock(None, None, 0.0)
    opts = call.opts
    context2, pooled2, time_ids, ip2 = build_conditioning(
        comps, opts, call.ids, call.pixel_values, num_samples=call.num_samples)
    clock.mark("conditioning_s")
    latents = denoise(comps.unet, call.latents, context2, pooled2, time_ids, ip2, call.schedule,
                      ip_scale_schedule(opts), guidance_scale=opts.guidance_scale)
    clock.mark("denoise_s")
    images = decode(comps, latents)
    clock.mark("decode_s")
    return images


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
        self.programs = {}  # the captured edit programs by key (programs.py)

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

    def prepare(self, pil_image, *, prompt: Optional[str] = None,
                extra_text: Optional[str] = None, num_samples: int = 1, scale: float = 1.0,
                seed: Optional[int] = None, guidance_scale: float = 5.0,
                num_inference_steps: int = 30, height: int = 1024, width: int = 1024,
                noise=None) -> EditCall:
        """The host's part of generate(): CLIP preprocessing, tokenization,
        the schedule and the initial latents, on the pipeline's device."""
        check_guidance(guidance_scale)
        pixel_values = self._pixel_values(pil_image)
        ids = self._ids(prompt or DEFAULT_PROMPT, extra_text)
        opts = EditOptions(height=height, width=width, num_inference_steps=num_inference_steps,
                           guidance_scale=guidance_scale, ip_scale=scale,
                           use_harmony=extra_text is not None)
        schedule = sched.make("euler", opts.num_inference_steps)

        down = self.cfgs.vae.downscale
        lat_shape = (num_samples, height // down, width // down, 4)
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(0 if seed is None else seed)
            noise = torch.randn(lat_shape, generator=gen, device=self.device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        if tuple(noise.shape) != lat_shape:
            raise ValueError(f"noise must be {lat_shape}, got {tuple(noise.shape)}")
        latents = (noise * schedule.init_noise_sigma).to(self.dtype).permute(0, 3, 1, 2)
        return EditCall(opts, ids, pixel_values, latents.contiguous(), schedule)

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

        On a CUDA device the edit runs as the captured programs of
        ``programs.py`` (captured at the first call of a (device, height,
        width, num_samples, extra_text or not) key, replayed after); on the
        CPU it runs ``edit``, the eager module functions. A pipeline keeps
        every key's programs for its life, and one key's programs serve one
        call at a time: two concurrent calls of a key on one pipeline would
        overwrite each other's inputs.
        """
        clock = PhaseClock(timings, self.device, time.perf_counter())
        call = self.prepare(pil_image, prompt=prompt, extra_text=extra_text,
                            num_samples=num_samples, scale=scale, seed=seed,
                            guidance_scale=guidance_scale,
                            num_inference_steps=num_inference_steps, height=height,
                            width=width, noise=noise)
        if self.device.type == "cuda":
            from imagharmony_tpu_torch.pipelines import programs

            images = programs.run(self, call, clock)
        else:
            images = edit(self.components, call, clock)
        if output_type == "raw":
            return images
        return to_uint8(images)
