"""Numerical-parity harness (port of imagharmony_tpu/utils/parity.py).

``run_capture`` runs an edit of either family (SDXL, or SD1.5 with no pooled
embedding and no time ids) through the eager denoise loop
(``harmony_edit.denoise``, over the body that generate()'s captured step
runs, ``denoise_step``) and keeps every intermediate latent,
reusing a given initial noise so that two implementations share x_T; ``compare``
scores the per-step cosine between two captures. Captures hold numpy
arrays in the JAX layout (latents (steps+1, B, h, w, 4), image
(B, H, W, 3)), so a capture of the port compares directly with the JAX
package's and with its golden files.
"""

from __future__ import annotations

import numpy as np
import torch


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom else 0.0


def _nhwc(x) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().cpu().numpy()


@torch.inference_mode()
def run_capture(pipe, pil_image, *, prompt, extra_text=None, steps=8, height=256,
                width=256, seed=0, noise=None, guidance_scale=5.0):
    """Run an edit and capture every intermediate latent.

    Returns dict: noise (1, h, w, 4), latents (steps+1, 1, h, w, 4), image
    (1, H, W, 3). ``noise``: optional (1, h, w, 4) initial N(0, 1) latents;
    otherwise drawn from ``seed`` with a torch.Generator."""
    from imagharmony_tpu_torch.pipelines import harmony_edit as he
    from imagharmony_tpu_torch.schedulers import diffusion as sched

    comps, dev = pipe.components, pipe.device
    opts = he.EditOptions(height=height, width=width, num_inference_steps=steps,
                          guidance_scale=guidance_scale, use_harmony=extra_text is not None)
    cond = he.build_conditioning(
        comps, opts, pipe._ids(prompt, extra_text), pipe._pixel_values(pil_image), num_samples=1
    )

    schedule = sched.make("euler", steps)
    down = pipe.cfgs.vae.downscale
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn((1, height // down, width // down, 4), generator=gen, device=dev)
    noise = torch.as_tensor(noise, dtype=torch.float32).to(dev)
    lat = (noise * schedule.init_noise_sigma).to(pipe.dtype).permute(0, 3, 1, 2).contiguous()

    traj = []
    lat = he.denoise(comps.unet, lat, *cond, schedule, he.ip_scale_schedule(opts),
                     guidance_scale=guidance_scale, on_step=lambda x: traj.append(_nhwc(x)))

    img = he.decode(comps, lat)
    return {
        "noise": noise.cpu().numpy(),
        "latents": np.stack(traj),
        "image": img.float().cpu().numpy(),
    }


def compare(capture_a, capture_b):
    """Per-step cosine table between two captures. When the latent traces
    differ in length by one, the longer drops its x_T entry."""
    la, lb = capture_a["latents"], capture_b["latents"]
    if len(la) == len(lb) + 1:
        la = la[1:]
    elif len(lb) == len(la) + 1:
        lb = lb[1:]
    n = min(len(la), len(lb))
    per_step = [cosine(la[i], lb[i]) for i in range(n)]
    return {
        "per_step_cosine": per_step,
        "min_cosine": min(per_step),
        "image_cosine": cosine(capture_a["image"], capture_b["image"]),
    }


def load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
