"""Preference-guided noise selection (PNS) (port of
imagharmony_tpu/pipelines/pns.py).

K candidate seeds are denoised as one batch (``num_samples=K``: 2K UNet
rows with the CFG pair), each candidate is scored for agreement with the
prompt in the OpenCLIP-bigG joint space the bundle already carries (the
image encoder's and text_encoder_2's projections), and the best is kept.
On a ``with_mesh`` clone the K candidates are the noise rows the data axis
splits (JAX's data-parallel fan-out): each rank denoises its candidates,
every rank gets all K back and scores them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from imagharmony_tpu_torch.models import clip_vision
from imagharmony_tpu_torch.pipelines import harmony_edit as he


@torch.inference_mode()
def clip_scores(comps, images, ids_g) -> torch.Tensor:
    """Cosine similarity between images (K, H, W, 3) in [-1, 1] and a
    prompt's token ids (1, S) in the bigG joint space -> (K,) fp32. The
    images are resized to the vision tower's size bilinearly with
    antialiasing, as ``jax.image.resize(..., "bilinear")`` does when it
    shrinks (``F.interpolate`` does not by default)."""
    if comps.cfgs.text_g is None:
        raise ValueError("clip_scores needs the bigG text tower (text_encoder_2): the SDXL "
                         "family's")
    size = comps.cfgs.vision.image_size
    x = F.interpolate(images.float().permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    x01 = torch.clamp(x.permute(0, 2, 3, 1) / 2.0 + 0.5, 0.0, 1.0)
    mean = torch.tensor(clip_vision.IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(clip_vision.IMAGE_STD, dtype=torch.float32, device=x.device)
    img = comps.image_encoder((x01 - mean) / std)["projected"].float()
    txt = comps.text_encoder_2(ids_g)["projected"].float()
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    return img @ txt[0]


def generate_with_pns(pipe, pil_image, *, num_seeds: int = 8, seed: int = 0, prompt=None,
                      return_all: bool = False, **generate_kw):
    """Denoises ``num_seeds`` candidates in one ``num_samples`` call,
    scores them (``clip_scores``) and keeps the best. Returns the winning
    image (generate()'s output types, "pil" by default), or (best, images,
    scores) with ``return_all``."""
    generate_kw.pop("num_samples", None)
    output_type = generate_kw.pop("output_type", "pil")
    decoded = pipe.generate(pil_image, prompt=prompt, num_samples=num_seeds, seed=seed,
                            output_type="raw", **generate_kw)
    ids_g = pipe._tokenize(prompt or "")[1]
    scores = clip_scores(pipe.components, decoded, ids_g).cpu().numpy()
    best = int(np.argmax(scores))
    arr = he.to_uint8(decoded)
    if output_type == "pil":
        from PIL import Image

        images = [Image.fromarray(a) for a in arr]
    else:
        images = arr
    if return_all:
        return images[best], images, scores
    return images[best]
