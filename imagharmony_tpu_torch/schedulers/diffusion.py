"""Diffusion schedulers: DDPM's training forward process and the inference
samplers Euler, Euler-ancestral, DDIM, DPM-Solver++ 2M and LCM (port of
imagharmony_tpu/schedulers/diffusion.py).

A schedule is a bundle of precomputed per-step host constants (timesteps
and sigmas as float32 numpy arrays; for DDIM and LCM the "sigmas" are
alpha-cumprods); ``scan_constants`` stacks them as fp32 tables on a device,
as the JAX package's ``lax.scan`` takes them, and the step functions take
one step's constants as 0-dim fp32 tensors read from those tables, never
as host floats, so one captured step serves every step of a loop.

What the JAX package keeps in a scan carry is explicit here too:
DPM++ 2M's history (the previous x0, its log-SNR and whether it exists) is
a dict of tensors that ``step_s`` takes and returns (``init_solver_state``
makes it, zeroed: "no history"), and the stochastic samplers (Euler-a, LCM)
take each step's fresh N(0, 1) draw ``z`` as an argument, drawn by the
caller, where the JAX package splits a PRNG key in the carry.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

STOCHASTIC = ("euler_a", "lcm")
PREDICTION_TYPES = ("epsilon", "v_prediction", "sample")


@dataclasses.dataclass(frozen=True)
class NoiseScheduleConfig:
    """Defaults = SDXL scheduler_config.json (scaled_linear betas, leading
    spacing, epsilon prediction)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    timestep_spacing: str = "leading"
    prediction_type: str = "epsilon"
    # DDIM's final alpha_prev: SD1.5 and SDXL ship False (acp[0]); True
    # lands on x0 exactly
    set_alpha_to_one: bool = False
    # Karras et al. 2022 rho=7 sigma spacing (euler and dpm++ only)
    use_karras_sigmas: bool = False
    # zero terminal SNR: sqrt(acp) shifted and rescaled so its last entry
    # is exactly 0 (arXiv 2305.08891 §3.1)
    rescale_betas_zero_snr: bool = False


def alphas_cumprod(cfg: NoiseScheduleConfig) -> np.ndarray:
    """The betas of ``cfg.beta_schedule`` -> cumulative alpha products,
    float32. With ``rescale_betas_zero_snr``, sqrt(acp) is shifted and
    rescaled so its first entry is kept and its last is exactly 0 (diffusers
    rescale_zero_terminal_snr)."""
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    else:
        raise ValueError(cfg.beta_schedule)
    acp = np.cumprod(1.0 - betas)
    if cfg.rescale_betas_zero_snr:
        sa = np.sqrt(acp)
        sa0, sa_t = sa[0], sa[-1]
        acp = ((sa - sa_t) * (sa0 / (sa0 - sa_t))) ** 2
    return acp.astype(np.float32)


@functools.lru_cache(maxsize=None)
def alphas_cumprod_on(cfg: NoiseScheduleConfig, device) -> torch.Tensor:
    """``alphas_cumprod(cfg)`` as an fp32 tensor on ``device``, made once per
    (config, device), so that a captured train step copies nothing from the
    host; ``add_noise`` and ``velocity_target`` take it as it is."""
    return torch.as_tensor(alphas_cumprod(cfg), device=device)


def _sqrt_alphas(acp, latents, timesteps):
    """sqrt(acp_t) and sqrt(1 - acp_t) per sample, fp32 then cast to the
    latents' dtype, shaped to broadcast over the non-batch axes. ``acp``:
    the numpy table, or ``alphas_cumprod_on``'s tensor on the latents'
    device, which is read in place."""
    a = torch.as_tensor(acp, dtype=torch.float32, device=latents.device)[timesteps]
    shape = (-1,) + (1,) * (latents.dim() - 1)
    return (a.sqrt().reshape(shape).to(latents.dtype),
            (1.0 - a).sqrt().reshape(shape).to(latents.dtype))


def add_noise(acp, latents, noise, timesteps):
    """q(x_t | x_0) = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps (training
    forward); timesteps (B,) integer indices into ``acp``."""
    sa, sb = _sqrt_alphas(acp, latents, timesteps)
    return sa * latents + sb * noise


def velocity_target(acp, latents, noise, timesteps):
    """v-prediction target sqrt(acp_t) eps - sqrt(1 - acp_t) x0."""
    sa, sb = _sqrt_alphas(acp, latents, timesteps)
    return sa * noise - sb * latents


# ---------------------------------------------------------------------------
# Inference schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Schedule:
    """kind: "euler" | "euler_a" | "ddim" | "dpm++" | "lcm"; timesteps
    (num_steps,); sigmas (num_steps + 1,): Karras sigmas with a last 0 for
    euler, euler_a and dpm++, alpha-cumprods with the final alpha for ddim
    and lcm; init_noise_sigma multiplies the initial N(0, 1) latents."""

    kind: str
    timesteps: np.ndarray
    sigmas: np.ndarray
    init_noise_sigma: float

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def _spaced_timesteps(num_steps, cfg: NoiseScheduleConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        ratio = n // num_steps
        ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.float32)
        ts += cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        ratio = n / num_steps
        ts = np.arange(n, 0, -ratio).round().astype(np.float32) - 1
    elif cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, n - 1, num_steps)[::-1].round().astype(np.float32)
    else:
        raise ValueError(f"unknown timestep_spacing {cfg.timestep_spacing!r}")
    return ts


def _sigma_to_t(sigmas, log_sigmas):
    """The trained sigma curve inverted at ``sigmas`` by piecewise-linear
    interpolation in log-sigma (diffusers EulerDiscrete._sigma_to_t):
    fractional timesteps for Karras-spaced sigmas."""
    log_sigma = np.log(np.maximum(sigmas, 1e-10))
    dists = log_sigma[None, :] - log_sigmas[:, None]
    low_idx = np.cumsum(dists >= 0, axis=0).argmax(axis=0)
    low_idx = np.clip(low_idx, 0, len(log_sigmas) - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0.0, 1.0)
    return ((1.0 - w) * low_idx + w * high_idx).astype(np.float32)


def euler_schedule(num_steps, cfg: NoiseScheduleConfig = NoiseScheduleConfig()) -> Schedule:
    # at zero terminal SNR acp[-1] == 0 gives an infinite sigma; diffusers
    # EulerDiscrete puts 2^-24 there (a no-op otherwise)
    acp = np.maximum(alphas_cumprod(cfg), np.float32(2.0**-24))
    all_sigmas = ((1.0 - acp) / acp) ** 0.5
    ts = _spaced_timesteps(num_steps, cfg)
    sigmas = np.interp(ts, np.arange(len(all_sigmas)), all_sigmas)
    if cfg.use_karras_sigmas:
        # rho=7 ramp between the spaced grid's extreme sigmas, then the
        # matching fractional timesteps from the trained curve
        rho = 7.0
        smax, smin = sigmas[0], sigmas[-1]
        ramp = np.linspace(0.0, 1.0, num_steps)
        sigmas = (smax ** (1 / rho) + ramp * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
        ts = _sigma_to_t(sigmas, np.log(all_sigmas))
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    # diffusers EulerDiscreteScheduler.init_noise_sigma: the max sigma for
    # linspace and trailing spacing, sqrt(max² + 1) for leading
    if cfg.timestep_spacing in ("linspace", "trailing"):
        init_sigma = float(sigmas.max())
    else:
        init_sigma = float((sigmas.max() ** 2 + 1.0) ** 0.5)
    return Schedule(kind="euler", timesteps=ts, sigmas=sigmas, init_noise_sigma=init_sigma)


def ddim_schedule(num_steps, cfg: NoiseScheduleConfig = NoiseScheduleConfig()) -> Schedule:
    if cfg.use_karras_sigmas:
        raise ValueError("use_karras_sigmas is not supported for ddim "
                         "(matching diffusers DDIMScheduler)")
    acp = alphas_cumprod(cfg)
    ts = _spaced_timesteps(num_steps, cfg).astype(np.int64)
    prev_ts = ts - cfg.num_train_timesteps // num_steps
    final_alpha = 1.0 if cfg.set_alpha_to_one else float(acp[0])
    alphas_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, None)], final_alpha)
    # alpha_t at i, and the last step's alpha_prev as entry num_steps
    seq = np.concatenate([acp[ts], alphas_prev[-1:]]).astype(np.float32)
    return Schedule(kind="ddim", timesteps=ts.astype(np.float32), sigmas=seq,
                    init_noise_sigma=1.0)


def dpmpp_schedule(num_steps, cfg: NoiseScheduleConfig = NoiseScheduleConfig()) -> Schedule:
    """DPM-Solver++ 2M on Euler's grid, the sample carried at VP scale
    (x = alpha x0 + sigma_vp eps stays ~N(0, 1)): init_noise_sigma 1 and no
    input scaling. A latent handoff must keep the kind on both sides (Euler
    carries latents at VE scale)."""
    s = euler_schedule(num_steps, cfg)
    return Schedule(kind="dpm++", timesteps=s.timesteps, sigmas=s.sigmas, init_noise_sigma=1.0)


def lcm_schedule(num_steps, cfg: NoiseScheduleConfig = NoiseScheduleConfig(),
                 original_inference_steps: int = 50) -> Schedule:
    """LCM's grid (diffusers LCMScheduler.set_timesteps): the distillation's
    ``original_inference_steps`` origin timesteps k·i − 1, ``num_steps`` of
    them by floor-linspace over the descending order. VP storage, the
    alpha-cumprods with a trailing 1.0, so the last step's re-noise gives
    the clean denoised output."""
    if cfg.use_karras_sigmas:
        raise ValueError("use_karras_sigmas is not supported for lcm "
                         "(matching diffusers LCMScheduler)")
    if num_steps > original_inference_steps:
        raise ValueError(f"lcm supports at most original_inference_steps="
                         f"{original_inference_steps} steps, got {num_steps}")
    k = cfg.num_train_timesteps // original_inference_steps
    acp = alphas_cumprod(cfg)
    origin = (np.arange(1, original_inference_steps + 1) * k - 1)[::-1]
    idx = np.floor(np.linspace(0.0, len(origin), num_steps, endpoint=False)).astype(np.int64)
    ts = origin[idx]
    seq = np.concatenate([acp[ts], [1.0]]).astype(np.float32)
    return Schedule(kind="lcm", timesteps=ts.astype(np.float32), sigmas=seq, init_noise_sigma=1.0)


# LCM's boundary-condition constants (diffusers LCMScheduler defaults)
LCM_SIGMA_DATA = 0.5
LCM_TIMESTEP_SCALING = 10.0


def scan_constants(schedule: Schedule, device=None):
    """The per-step constants of the denoise loop as fp32 tensors on
    ``device``: (timesteps, sigmas[:-1], sigmas[1:]), each (num_steps,)."""
    def table(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return table(schedule.timesteps), table(schedule.sigmas[:-1]), table(schedule.sigmas[1:])


def scale_model_input_c(kind: str, sigma: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """Pre-UNet input scaling from one step's sigma, a 0-dim fp32 tensor on
    the sample's device: for euler and euler_a the divisor sqrt(sigma² + 1)
    in fp32, cast to the sample's dtype; the VP kinds take the sample as it
    is."""
    if kind in ("euler", "euler_a"):
        return sample / torch.sqrt(sigma * sigma + 1.0).to(sample.dtype)
    return sample


def to_epsilon(kind: str, sigma, model_output, sample, prediction_type: str):
    """A UNet output of any parametrization as epsilon at this step, so each
    solver runs its epsilon form. ``sigma`` is the step's alpha-cumprod for
    ddim and lcm, the Karras sigma otherwise; ``sample`` is at the kind's
    storage scale. With x = a x0 + s eps (a² + s² = 1) and v = a eps − s x0,
    eps = s x + a v: division-free, finite at zero terminal SNR."""
    if prediction_type == "epsilon":
        return model_output
    m32, s32 = model_output.float(), sample.float()
    if kind in ("ddim", "lcm"):
        a, s = torch.sqrt(sigma), torch.sqrt(1.0 - sigma)
        if prediction_type == "v_prediction":
            return s * s32 + a * m32
        if prediction_type == "sample":
            return (s32 - a * m32) / s
        raise ValueError(prediction_type)
    # VE storage for euler (x0 + sigma eps), VP for dpm++: a = alpha =
    # 1/sqrt(sigma² + 1), s = sigma·alpha
    alpha = 1.0 / torch.sqrt(sigma * sigma + 1.0)
    x_vp = s32 * alpha if kind in ("euler", "euler_a") else s32
    if prediction_type == "v_prediction":
        return (sigma * alpha) * x_vp + alpha * m32
    if prediction_type == "sample":
        return (x_vp - alpha * m32) / (sigma * alpha)
    raise ValueError(prediction_type)


def step_c(kind: str, sigma, sigma_next, model_output, sample, prediction_type="epsilon"):
    """Reverse step of the single-step deterministic kinds in fp32, cast
    back to the sample's dtype; sigma and sigma_next are 0-dim fp32 tensors
    on the sample's device ((alpha_t, alpha_prev) for ddim)."""
    if kind == "dpm++":
        raise ValueError("dpm++ is multistep: use step_s with a solver state")
    if kind in STOCHASTIC:
        raise ValueError(f"{kind} is stochastic: use step_s with its draw z")
    s32 = sample.float()
    eps = to_epsilon(kind, sigma, model_output, sample, prediction_type).float()
    if kind == "euler":
        denoised = s32 - sigma * eps
        derivative = (s32 - denoised) / sigma
        return (s32 + derivative * (sigma_next - sigma)).to(sample.dtype)
    if kind != "ddim":
        raise ValueError(f"unknown scheduler kind {kind!r}")
    # x0 division-free for v and sample predictions (the epsilon form
    # divides by sqrt(alpha_t), 0 at zero terminal SNR)
    if prediction_type == "v_prediction":
        x0 = torch.sqrt(sigma) * s32 - torch.sqrt(1.0 - sigma) * model_output.float()
    elif prediction_type == "sample":
        x0 = model_output.float()
    else:
        x0 = (s32 - torch.sqrt(1.0 - sigma) * eps) / torch.sqrt(sigma)
    dir_xt = torch.sqrt(1.0 - sigma_next) * eps
    return (torch.sqrt(sigma_next) * x0 + dir_xt).to(sample.dtype)


def init_solver_state(kind: str, latents):
    """DPM++ 2M's history for ``step_s``, zeroed ("no history": the first
    step is first order): x0 (B, ...) fp32, the previous step's converted
    output; lam and valid (B, 1, ...) fp32, its -log(sigma) and 1 once it
    exists. None for every other kind."""
    if kind != "dpm++":
        return None
    b1 = (latents.shape[0],) + (1,) * (latents.dim() - 1)
    zeros = functools.partial(torch.zeros, dtype=torch.float32, device=latents.device)
    return {"x0": zeros(latents.shape), "lam": zeros(b1), "valid": zeros(b1)}


def step_s(kind: str, sigma, sigma_next, model_output, sample, state,
           prediction_type: str = "epsilon", *, timestep=None, z=None):
    """State-carrying reverse step: ``(new_sample, new_state)``.

    euler and ddim are ``step_c`` with no state. dpm++ is DPM-Solver++ 2M
    (arXiv 2211.01095; diffusers' multistep second-order update, final sigma
    0): the first step of a run (valid == 0) and the last (sigma_next == 0)
    take the first-order update, chosen by ``torch.where`` with no branch
    on the host. euler_a (Euler-ancestral) and lcm take this step's fresh
    N(0, 1) draw ``z`` (fp32, the sample's shape); lcm also the step's
    ``timestep``, which its boundary scalings read."""
    if kind == "lcm":
        if timestep is None or z is None:
            raise ValueError("lcm's step takes its timestep and its draw z")
        s32, m32 = sample.float(), model_output.float()
        a = sigma
        if prediction_type == "v_prediction":
            x0 = torch.sqrt(a) * s32 - torch.sqrt(1.0 - a) * m32
        elif prediction_type == "sample":
            x0 = m32
        else:
            x0 = (s32 - torch.sqrt(1.0 - a) * m32) / torch.sqrt(a)
        st = timestep * LCM_TIMESTEP_SCALING
        sd2 = LCM_SIGMA_DATA**2
        c_skip = sd2 / (st * st + sd2)
        c_out = st / torch.sqrt(st * st + sd2)
        denoised = c_out * x0 + c_skip * s32
        out = torch.sqrt(sigma_next) * denoised + torch.sqrt(1.0 - sigma_next) * z
        return out.to(sample.dtype), state
    if kind == "euler_a":
        # the Euler move to sigma_down plus fresh noise at sigma_up,
        # sigma_down² + sigma_up² = sigma_next²; the last step is noise-free
        if z is None:
            raise ValueError("euler_a's step takes its draw z")
        s32 = sample.float()
        eps = to_epsilon(kind, sigma, model_output, sample, prediction_type).float()
        var_up = sigma_next**2 * (sigma**2 - sigma_next**2) / sigma**2
        sigma_up = torch.sqrt(var_up.clamp_min(0.0))
        sigma_down = torch.sqrt((sigma_next**2 - var_up).clamp_min(0.0))
        out = s32 + eps * (sigma_down - sigma)
        return (out + sigma_up * z).to(sample.dtype), state
    if kind != "dpm++":
        return step_c(kind, sigma, sigma_next, model_output, sample, prediction_type), state
    s32 = sample.float()
    eps = to_epsilon(kind, sigma, model_output, sample, prediction_type).float()
    # VP from the Karras sigma: alpha = 1/sqrt(sig² + 1), sigma_vp =
    # sig·alpha, lambda = -log(sig)
    alpha = 1.0 / torch.sqrt(sigma**2 + 1.0)
    alpha_n = 1.0 / torch.sqrt(sigma_next**2 + 1.0)
    x0 = s32 * torch.sqrt(sigma**2 + 1.0) - sigma * eps
    ratio_vp = (sigma_next * alpha_n) / (sigma * alpha)
    ehm1 = sigma_next / sigma - 1.0  # exp(-h) - 1, exact at sigma_next = 0
    first = ratio_vp * s32 - alpha_n * ehm1 * x0
    lam = -torch.log(sigma)
    h = -torch.log(sigma_next.clamp_min(1e-10)) - lam
    h0 = lam - state["lam"]
    d1 = (x0 - state["x0"]) * (h / h0.clamp_min(1e-10))
    second = ratio_vp * s32 - alpha_n * ehm1 * (x0 + 0.5 * d1)
    use_first = (state["valid"] == 0.0) | (sigma_next == 0.0)
    out = torch.where(use_first, first, second).to(sample.dtype)
    return out, {"x0": x0, "lam": lam.expand_as(state["lam"]),
                 "valid": torch.ones_like(state["valid"])}


def steps_for_denoising_end(num_steps, denoising_end,
                            cfg: NoiseScheduleConfig = NoiseScheduleConfig()):
    """How many of ``num_steps`` run when stopping at ``denoising_end`` of
    the noise schedule (the base/refiner split)."""
    ts = _spaced_timesteps(num_steps, cfg)
    cutoff = round(cfg.num_train_timesteps - denoising_end * cfg.num_train_timesteps)
    return int((ts >= cutoff).sum())


def _truncate(schedule: Schedule, n: int) -> Schedule:
    return dataclasses.replace(schedule, timesteps=schedule.timesteps[:n],
                               sigmas=schedule.sigmas[: n + 1])


def _tail(schedule: Schedule, n_skip: int) -> Schedule:
    """Drop the first ``n_skip`` steps: the input latents are already at
    step ``n_skip``'s level, so no initial sigma applies."""
    return dataclasses.replace(schedule, timesteps=schedule.timesteps[n_skip:],
                               sigmas=schedule.sigmas[n_skip:], init_noise_sigma=1.0)


def img2img_skip_steps(num_steps: int, strength: float) -> int:
    """diffusers' img2img mapping (get_timesteps): run the last
    ``int(num_steps * strength)`` steps."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    init_steps = min(int(num_steps * strength), num_steps)
    return max(num_steps - init_steps, 0)


def noise_to_level(kind: str, level, image_latents, noise):
    """q(x_level | x0) at the kind's storage scale, fp32: VE for euler and
    euler_a, VP for dpm++, and for ddim and lcm ``level`` is an
    alpha-cumprod. A 0 sigma, or an alpha of 1, gives the clean latents
    exactly."""
    x, eps = image_latents.float(), noise.float()
    if kind in ("euler", "euler_a"):
        return x + level * eps
    if kind == "dpm++":
        return 1.0 / torch.sqrt(level * level + 1.0) * (x + level * eps)
    return torch.sqrt(level) * x + torch.sqrt(1.0 - level) * eps


def img2img_init(schedule: Schedule, image_latents, noise):
    """Image latents noised to the schedule's first step: img2img's start,
    at the kind's storage scale."""
    level = torch.tensor(float(schedule.sigmas[0]), dtype=torch.float32,
                         device=image_latents.device)
    return noise_to_level(schedule.kind, level, image_latents, noise)


def make(kind: str, num_steps: int, cfg: NoiseScheduleConfig = NoiseScheduleConfig(), *,
         denoising_end=None, denoising_start=None, skip_steps: int = 0) -> Schedule:
    """The schedule of a sampler kind (aliases euler_ancestral and dpmpp),
    cut for a base/refiner split (``denoising_end``: its first part;
    ``denoising_start``: the rest) or for img2img (``skip_steps``)."""
    if kind == "euler":
        s = euler_schedule(num_steps, cfg)
    elif kind in ("euler_a", "euler_ancestral"):
        if cfg.use_karras_sigmas:
            raise ValueError("use_karras_sigmas is not supported for euler_a "
                             "(matching diffusers EulerAncestralDiscreteScheduler)")
        s = dataclasses.replace(euler_schedule(num_steps, cfg), kind="euler_a")
    elif kind == "ddim":
        s = ddim_schedule(num_steps, cfg)
    elif kind in ("dpm++", "dpmpp"):
        s = dpmpp_schedule(num_steps, cfg)
    elif kind == "lcm":
        if denoising_end is not None or denoising_start is not None:
            raise ValueError("denoising_end/denoising_start are not supported for lcm (its "
                             "grid is the distillation's, not the split's spaced grid)")
        s = lcm_schedule(num_steps, cfg)
    else:
        raise ValueError(f"unknown scheduler kind {kind!r}")
    if denoising_end is not None and 0.0 < denoising_end < 1.0:
        s = _truncate(s, steps_for_denoising_end(num_steps, denoising_end, cfg))
    if denoising_start is not None and 0.0 < denoising_start < 1.0:
        s = _tail(s, steps_for_denoising_end(num_steps, denoising_start, cfg))
    if skip_steps:
        s = _tail(s, skip_steps)
    return s
