"""IP cross-attention maps (port of imagharmony_tpu/utils/attn_maps.py).

One UNet call on a noise latent returns every live IP layer's attention
probabilities (B, heads, Sq, num_ip_tokens) through the UNet's
``collect_ip_probs`` list (no hooks, no module state). K2 never forms the
probabilities, so the probe computes them apart in plain torch; the call's
output itself still goes through K2. They are upscaled to the image size,
averaged into one heatmap a token and rendered over the input image (the
reference's utils.py:6-79). The reference's 2_0 path stores
``query @ key.T.softmax(-1)`` (a precedence bug, SURVEY.md §2); this is the
actual attention.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from imagharmony_tpu_torch.pipelines import harmony_edit as he


@torch.inference_mode()
def probe(pipe, ids, pixel_values, noise, *, timestep, latent_size):
    """The live IP layers' probabilities, a list of (B, heads, Sq, T) fp32
    tensors, from one conditional UNet call at ``timestep`` on ``noise``
    (B, 4, h, w) with the prompt's text, the image prompt fused with the
    extra_text where ``ids`` has one, and the micro-conditioning of a
    square ``latent_size * 8`` image (the JAX package's ``_probe_jit``)."""
    comps = pipe.components
    context, pooled = he.encode_texts(comps, ids["pos_l"], ids["pos_g"])
    extra = None
    if "extra_l" in ids:
        extra, _ = he.encode_texts(comps, ids["extra_l"], ids["extra_g"])
    ip_cond, _ = he.image_prompt_tokens(comps, pixel_values, extra)
    px = latent_size * 8.0
    time_ids = torch.tensor([[px, px, 0.0, 0.0, px, px]], device=noise.device)
    probs = []
    comps.unet(noise, torch.tensor([float(timestep)], device=noise.device), context,
               pooled_text_embeds=pooled, time_ids=time_ids, ip_tokens=ip_cond,
               collect_ip_probs=probs)
    return probs


def ip_attention_maps(pipe, pil_image, *, prompt, extra_text=None, timestep=500,
                      latent_size=64, seed=0):
    """-> (num_ip_tokens, latent_size*8, latent_size*8) float heatmaps in
    [0, 1], averaged over the live layers and their heads, from a probe on
    N(0, 1) noise drawn from ``seed``."""
    ids = {}
    ids["pos_l"], ids["pos_g"] = pipe._tokenize(prompt)
    if extra_text is not None:
        ids["extra_l"], ids["extra_g"] = pipe._tokenize(extra_text)
    gen = torch.Generator(device=pipe.device).manual_seed(int(seed))
    noise = torch.randn((1, 4, latent_size, latent_size), generator=gen, device=pipe.device)
    probs = probe(pipe, ids, pipe._pixel_values(pil_image), noise, timestep=timestep,
                  latent_size=latent_size)
    return postprocess_ip_probs([p[0].float().cpu().numpy() for p in probs], latent_size * 8)


def postprocess_ip_probs(probs_list, out_size, *, token_softmax=False, minmax=True):
    """Per-layer (heads, Sq, T) probabilities -> (T, out, out) heatmaps:
    the mean over heads, tokens first, the square grid, a bilinear upscale
    (half-pixel centres, torch's align_corners=False), the mean over layers,
    then each token's map min-max normalized to [0, 1]. The reference
    instead takes a per-layer softmax over the tokens after the upscale
    (its utils.py:44) and no normalization: ``token_softmax=True`` and
    ``minmax=False`` give its composition."""
    maps = []
    for p in probs_list:
        p = torch.tensor(np.asarray(p, np.float32))  # (heads, Sq, T)
        hw = int(round(p.shape[1] ** 0.5))
        m = p.mean(dim=0).T.reshape(1, -1, hw, hw)
        m = F.interpolate(m, size=(out_size, out_size), mode="bilinear", align_corners=False)[0]
        if token_softmax:
            m = torch.softmax(m, dim=0)
        maps.append(m.numpy())
    avg = np.mean(maps, axis=0)
    if not minmax:
        return avg
    lo, hi = avg.min(axis=(1, 2), keepdims=True), avg.max(axis=(1, 2), keepdims=True)
    return (avg - lo) / np.maximum(hi - lo, 1e-8)


def heatmap_to_pil(maps, base_image=None, alpha=0.5):
    """Token heatmaps as PIL images, blended over ``base_image`` if given
    (the reference's attnmaps2images and blend, utils.py:61-79)."""
    from PIL import Image

    out = []
    for m in maps:
        im = Image.fromarray((m * 255).astype(np.uint8)).convert("RGB")
        if base_image is not None:
            im = Image.blend(base_image.convert("RGB").resize(im.size), im, alpha)
        out.append(im)
    return out
