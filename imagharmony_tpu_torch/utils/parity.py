"""Numerical-parity harness (port of imagharmony_tpu/utils/parity.py).

``run_capture`` runs an edit of either family (SDXL, or SD1.5 with no pooled
embedding and no time ids), with any of generate()'s options, through the
eager module functions (``harmony_edit.edit``, whose loop runs the body
that generate()'s captured step runs, ``denoise_step``) and keeps every
intermediate latent, reusing a given initial noise so that two
implementations share x_T; ``compare`` scores the per-step cosine between
two captures. Captures hold numpy arrays in the JAX layout (latents
(steps+1, B, h, w, 4), image (B, H, W, 3), or the output latents
(B, h, w, 4)), so a capture of the port compares directly with the JAX
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
                width=256, seed=0, noise=None, guidance_scale=5.0, **options):
    """Run an edit and capture every intermediate latent.

    Returns dict: noise (B, h, w, 4), latents (steps+1, B, h, w, 4), image:
    the output (B, H, W, 3), or the latents (B, h, w, 4) where the edit
    returns latents. ``noise``: optional (B, h, w, 4) initial N(0, 1)
    latents; otherwise drawn from ``seed`` as generate() draws it.
    ``options``: any other argument of ``HarmonyPipeline.prepare`` (the
    sampler, img2img, inpaint, the handoff, ``_step_noise``...)."""
    from imagharmony_tpu_torch.pipelines import harmony_edit as he

    call = pipe.prepare(pil_image, prompt=prompt, extra_text=extra_text,
                        num_inference_steps=steps, height=height, width=width, seed=seed,
                        noise=noise, guidance_scale=guidance_scale, **options)
    traj = []
    out = he.edit(pipe.components, call, on_step=lambda x: traj.append(_nhwc(x)))
    return {
        "noise": call.noise.permute(0, 2, 3, 1).cpu().numpy(),
        "latents": np.stack(traj),
        "image": out.float().cpu().numpy(),
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


def save(path, capture):
    np.savez_compressed(path, **capture)


def load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def reference_capture_script() -> str:
    """The text of the repo's diffusers-side capture script,
    ``tools/capture_reference.py``."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with open(os.path.join(root, "tools", "capture_reference.py")) as f:
        return f.read()
