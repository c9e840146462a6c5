"""CLIP vision encoder with projection (port of
imagharmony_tpu/models/clip_vision.py).

HF ``vision_model.*`` parameter names. The pipeline surface keeps the JAX
layout: ``forward`` takes CLIP-normalized pixels as (B, H, W, 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from imagharmony_tpu_torch.models.clip_text import CLIPEncoder
from imagharmony_tpu_torch.nn.layers import Conv2d, LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """Defaults = the IP-Adapter SDXL image encoder (OpenCLIP ViT-bigG-14)."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1664
    num_layers: int = 48
    num_heads: int = 16
    intermediate_size: int = 8192
    projection_dim: int = 1280
    hidden_act: str = "gelu"

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


def vit_h_config() -> CLIPVisionConfig:
    """CLIP ViT-H/14 (the SD1.5 IP-Adapter image encoder)."""
    return CLIPVisionConfig(hidden_size=1280, num_layers=32, num_heads=16,
                            intermediate_size=5120, projection_dim=1024)


def tiny_config(**overrides) -> CLIPVisionConfig:
    base = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, projection_dim=24)
    base.update(overrides)
    return CLIPVisionConfig(**base)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device=None, dtype=None):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size, device=device, dtype=dtype))
        self.patch_embedding = Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size,
                                      bias=False, device=device, dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.num_positions, cfg.hidden_size,
                                               device=device, dtype=dtype)

    def forward(self, pixels_nchw):
        patches = self.patch_embedding(pixels_nchw).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + self.position_embedding(pos)[None]


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg, **kw)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, **kw)
        self.encoder = CLIPEncoder(cfg, **kw)
        self.post_layernorm = LayerNorm(cfg.hidden_size, **kw)
        self.visual_projection = Linear(cfg.hidden_size, cfg.projection_dim, bias=False, **kw)

    def forward(self, pixel_values):
        """pixel_values (B, H, W, 3), CLIP-normalized -> dict of penultimate
        (B, 1+P, D), last (B, 1+P, D), pooled (B, D), projected (B, proj)."""
        x = self.embeddings(pixel_values.permute(0, 3, 1, 2))
        x = self.pre_layrnorm(x)
        penultimate = None
        for i, layer in enumerate(self.encoder.layers):
            if i == self.cfg.num_layers - 1:
                penultimate = x
            x = layer(x)
        pooled = self.post_layernorm(x[:, 0])
        return {"penultimate": penultimate, "last": x, "pooled": pooled,
                "projected": self.visual_projection(pooled)}


# CLIPImageProcessor defaults: shortest side to 224 bicubic, center-crop 224,
# scale 1/255, normalize with these stats.
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_numpy(images, image_size=224):
    """Host-side CLIP preprocessing: PIL image(s) / uint8 HWC arrays ->
    (B, H, W, 3) float32 normalized (CLIPImageProcessor's bicubic
    shortest-edge resize + center crop)."""
    from PIL import Image

    if not isinstance(images, (list, tuple)):
        images = [images]
    out = []
    for im in images:
        if isinstance(im, np.ndarray):
            im = Image.fromarray(im.astype(np.uint8))
        im = im.convert("RGB")
        w, h = im.size
        # shortest-edge resize with HF's truncating long-side arithmetic
        if w <= h:
            nw, nh = image_size, int(image_size * h / w)
        else:
            nw, nh = int(image_size * w / h), image_size
        im = im.resize((nw, nh), Image.BICUBIC)
        left = (nw - image_size) // 2
        top = (nh - image_size) // 2
        im = im.crop((left, top, left + image_size, top + image_size))
        arr = np.asarray(im, dtype=np.float32) / 255.0
        arr = (arr - np.array(IMAGE_MEAN, np.float32)) / np.array(IMAGE_STD, np.float32)
        out.append(arr)
    return np.stack(out)
