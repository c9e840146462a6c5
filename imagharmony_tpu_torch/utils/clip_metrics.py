"""CLIP-space quality metrics, CLIP-T and CLIP-I, on the pipeline's own towers
(port of imagharmony_tpu/utils/clip_metrics.py).

The IMAGHarmony paper evaluates edits with CLIP-T (edited image against the
target prompt) and CLIP-I (edited image against the reference image).
CLIP-T is ``pipelines/pns.clip_scores`` (the bigG joint space, the PNS
scorer); CLIP-I compares the vision tower's projected embeddings. With
random weights they are smoke metrics, for relative comparisons only.

Images are (K, H, W, 3) floats in [-1, 1] (``generate(output_type="raw")``)
or uint8 in [0, 255]; results are numpy fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from imagharmony_tpu_torch.models import clip_vision
from imagharmony_tpu_torch.pipelines import pns


def _as_float(pipe, raw) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(raw) if not torch.is_tensor(raw) else raw)
    if x.dtype == torch.uint8:
        x = x.float() / 127.5 - 1.0
    return x.float().to(pipe.device)


@torch.inference_mode()
def image_embeds(pipe, raw) -> np.ndarray:
    """L2-normalized projected CLIP image embeddings (K, D) of ``raw``,
    resized to the tower's size with antialiasing (as ``jax.image.resize``
    shrinks)."""
    imgs = _as_float(pipe, raw)
    size = pipe.cfgs.vision.image_size
    x = F.interpolate(imgs.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    x01 = torch.clamp(x.permute(0, 2, 3, 1) / 2.0 + 0.5, 0.0, 1.0)
    mean = torch.tensor(clip_vision.IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(clip_vision.IMAGE_STD, dtype=torch.float32, device=x.device)
    emb = pipe.components.image_encoder((x01 - mean) / std)["projected"].float()
    return (emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)).cpu().numpy()


def clip_i(pipe, edited_raw, reference_raw) -> np.ndarray:
    """CLIP-I: the cosine of each edited image with the reference, (K,); a
    single reference is compared with every edited image."""
    a = image_embeds(pipe, edited_raw)
    b = image_embeds(pipe, reference_raw)
    if b.shape[0] == 1 and a.shape[0] > 1:
        b = np.broadcast_to(b, a.shape)
    return (a * b).sum(-1)


def clip_t(pipe, edited_raw, prompt: str) -> np.ndarray:
    """CLIP-T: the bigG joint-space similarity of each image to ``prompt``,
    (K,)."""
    if pipe.components.text_encoder_2 is None:
        raise ValueError("CLIP-T needs the bigG tower (SDXL bundles)")
    ids_g = pipe._tokenize(prompt)[1]
    return pns.clip_scores(pipe.components, _as_float(pipe, edited_raw), ids_g).cpu().numpy()
