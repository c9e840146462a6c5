"""Euler discrete scheduler and the DDPM training forward process (port of
the Euler path and the training half of
imagharmony_tpu/schedulers/diffusion.py).

A schedule is a bundle of precomputed per-step host constants (timesteps
and sigmas as float32 numpy arrays); ``scan_constants`` stacks them as
fp32 tables on a device, as the JAX package's ``lax.scan`` takes them, and
the step functions take one step's constants as 0-dim fp32 tensors read
from those tables, never as host floats. For inference only the SDXL default is ported: scaled_linear
betas, leading timestep spacing, epsilon prediction. Training adds the
zero-terminal-SNR rescale of ``alphas_cumprod``, ``add_noise`` and
``velocity_target``. The other samplers and options of the JAX module
(euler_a, ddim, dpm++, lcm, trailing/linspace spacing, karras sigmas) are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseScheduleConfig:
    """Defaults = SDXL scheduler_config.json (scaled_linear betas)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    steps_offset: int = 1
    # read by training only: the loss target, and the zero terminal SNR
    # rescale of alphas_cumprod (arXiv 2305.08891 §3.1)
    prediction_type: str = "epsilon"
    rescale_betas_zero_snr: bool = False


def alphas_cumprod(cfg: NoiseScheduleConfig) -> np.ndarray:
    """scaled_linear betas -> cumulative alpha products, float32. With
    ``rescale_betas_zero_snr``, sqrt(acp) is shifted and rescaled so its
    first entry is kept and its last is exactly 0 (diffusers
    rescale_zero_terminal_snr)."""
    betas = np.linspace(
        cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_timesteps, dtype=np.float64
    ) ** 2
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


@dataclasses.dataclass(frozen=True)
class Schedule:
    """kind: "euler"; timesteps (num_steps,); sigmas (num_steps + 1,), last
    entry 0; init_noise_sigma multiplies the initial N(0, 1) latents."""

    kind: str
    timesteps: np.ndarray
    sigmas: np.ndarray
    init_noise_sigma: float

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def _leading_timesteps(num_steps, cfg: NoiseScheduleConfig) -> np.ndarray:
    ratio = cfg.num_train_timesteps // num_steps
    ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.float32)
    return ts + cfg.steps_offset


def euler_schedule(num_steps, cfg: NoiseScheduleConfig = NoiseScheduleConfig()) -> Schedule:
    acp = alphas_cumprod(cfg)
    all_sigmas = ((1.0 - acp) / acp) ** 0.5
    ts = _leading_timesteps(num_steps, cfg)
    sigmas = np.interp(ts, np.arange(len(all_sigmas)), all_sigmas)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    # diffusers EulerDiscreteScheduler.init_noise_sigma with leading spacing
    init_sigma = float((sigmas.max() ** 2 + 1.0) ** 0.5)
    return Schedule(kind="euler", timesteps=ts, sigmas=sigmas, init_noise_sigma=init_sigma)


def make(kind: str, num_steps: int, cfg: NoiseScheduleConfig = NoiseScheduleConfig()) -> Schedule:
    if kind != "euler":
        raise ValueError(f"scheduler {kind!r} is not ported yet (euler only)")
    return euler_schedule(num_steps, cfg)


def scan_constants(schedule: Schedule, device=None):
    """The per-step constants of the denoise loop as fp32 tensors on
    ``device``: (timesteps, sigmas[:-1], sigmas[1:]), each (num_steps,)."""
    def table(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return table(schedule.timesteps), table(schedule.sigmas[:-1]), table(schedule.sigmas[1:])


def scale_model_input_c(kind: str, sigma: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """Pre-UNet input scaling from one step's sigma, a 0-dim fp32 tensor on
    the sample's device: the divisor sqrt(sigma² + 1) in fp32, cast to the
    sample's dtype."""
    if kind != "euler":
        raise ValueError(kind)
    return sample / torch.sqrt(sigma * sigma + 1.0).to(sample.dtype)


def step_c(kind: str, sigma: torch.Tensor, sigma_next: torch.Tensor, model_output, sample):
    """Euler reverse step (epsilon prediction) in fp32, cast back to the
    sample's dtype; sigma and sigma_next are 0-dim fp32 tensors on the
    sample's device."""
    if kind != "euler":
        raise ValueError(kind)
    s32 = sample.float()
    eps = model_output.float()
    denoised = s32 - sigma * eps
    derivative = (s32 - denoised) / sigma
    return (s32 + derivative * (sigma_next - sigma)).to(sample.dtype)

