"""The model bundle a pipeline runs (port of
imagharmony_tpu/pipelines/components.py): the SDXL family with the HA head,
and the SD1.5 family (single text tower, vanilla IP-Adapter on every
cross-attention), each with the ``image_proj``, ``resampler`` (Plus) or
``mlp_proj`` (Full) image-prompt head.

``Components`` holds every sub-model the family has as one ``nn.Module``; its
state_dict keys are the JAX bundle's keys in diffusers form (``unet.*``,
``vae.*``, ``text_encoder.*``, ``text_encoder_2.*``, ``image_encoder.*``,
``harmony.*``, ``image_proj.*``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from imagharmony_tpu_torch.adapters import harmony, resampler
from imagharmony_tpu_torch.adapters.projections import ImageProjModel, MLPProjModel
from imagharmony_tpu_torch.models import clip_text, clip_vision, unet, vae
from imagharmony_tpu_torch.nn.layers import GroupNorm, LayerNorm


@dataclasses.dataclass(frozen=True)
class ComponentConfigs:
    unet: unet.UNetConfig
    vae: vae.VAEConfig
    text_l: clip_text.CLIPTextConfig
    # the second tower is SDXL-only; None for the SD1.5 family
    text_g: Optional[clip_text.CLIPTextConfig]
    vision: clip_vision.CLIPVisionConfig
    # the HA module is the SDXL QL-Edit head; None for the SD1.5 family
    harmony: Optional[harmony.HarmonyConfig]
    # "image_proj" (IPAdapter/XL), "resampler" (IPAdapterPlus/PlusXL) or
    # "mlp_proj" (IPAdapterFull)
    proj_kind: str = "image_proj"
    resampler: Optional[resampler.ResamplerConfig] = None
    num_ip_tokens: int = 4
    # "sdxl" (dual towers, micro-conditioning) or "sd15" (single tower)
    family: str = "sdxl"


def sdxl_configs(harmony_cfg: harmony.HarmonyConfig | None = None) -> ComponentConfigs:
    """Full-size SDXL-base + ViT-bigG image encoder + the shipped HA dims
    (or ``harmony_cfg``)."""
    return ComponentConfigs(
        unet=unet.UNetConfig(),
        vae=vae.VAEConfig(),
        text_l=clip_text.clip_l_config(),
        text_g=clip_text.clip_bigg_config(),
        vision=clip_vision.CLIPVisionConfig(),
        harmony=harmony_cfg or harmony.HarmonyConfig(),
    )


def sd15_configs() -> ComponentConfigs:
    """Full-size SD1.5 + vanilla IP-Adapter: CLIP-L text tower, CLIP ViT-H
    image encoder, the IP branch on every cross-attention."""
    return ComponentConfigs(
        unet=unet.sd15_config(),
        vae=vae.VAEConfig(scaling_factor=0.18215),
        text_l=clip_text.clip_l_config(),
        text_g=None,
        vision=clip_vision.vit_h_config(),
        harmony=None,
        family="sd15",
    )


def sd15_tiny_configs(vocab_size=1000) -> ComponentConfigs:
    """Miniature SD1.5 bundle for tests (the JAX sd15_tiny_configs): head
    dims 8/16/32/32."""
    u = unet.sd15_config(
        block_out_channels=(32, 64, 128, 128),
        cross_attention_dim=24,
        num_attention_heads=(4, 4, 4, 4),
        norm_num_groups=8,
    )
    # SD1.5 conditions on CLIP-L's last hidden state: its width is the
    # UNet's cross_attention_dim
    tl = clip_text.tiny_config(vocab_size=vocab_size, hidden_size=24, num_heads=4)
    return ComponentConfigs(
        unet=u, vae=vae.tiny_config(scaling_factor=0.18215), text_l=tl, text_g=None,
        vision=clip_vision.tiny_config(projection_dim=20), harmony=None, family="sd15",
    )


def tiny_configs(vocab_size=1000, *, proj_kind="image_proj") -> ComponentConfigs:
    """Topology-faithful SDXL miniature for tests (the JAX tiny_configs)."""
    u = unet.tiny_config()
    tl = clip_text.tiny_config(vocab_size=vocab_size, hidden_size=24, num_heads=4)
    tg = clip_text.tiny_config(vocab_size=vocab_size, hidden_size=40, num_heads=4,
                               projection_dim=32)
    vis = clip_vision.tiny_config(projection_dim=32)
    return ComponentConfigs(
        unet=u,
        vae=vae.tiny_config(),
        text_l=tl,
        text_g=tg,
        vision=vis,
        harmony=harmony.tiny_config(image_hidden_size=32,
                                    text_context_dim=tl.hidden_size + tg.hidden_size),
        proj_kind=proj_kind,
        resampler=resampler.tiny_config(embedding_dim=vis.hidden_size,
                                        output_dim=u.cross_attention_dim, num_queries=4),
    )


def _image_proj(cfgs: ComponentConfigs, **kw) -> nn.Module:
    if cfgs.proj_kind == "image_proj":
        return ImageProjModel(
            clip_embed_dim=cfgs.vision.projection_dim,
            cross_attention_dim=cfgs.unet.cross_attention_dim,
            num_tokens=cfgs.num_ip_tokens, **kw,
        )
    if cfgs.proj_kind == "resampler":
        return resampler.Resampler(cfgs.resampler, **kw)
    if cfgs.proj_kind == "mlp_proj":
        return MLPProjModel(clip_hidden_dim=cfgs.vision.hidden_size,
                            cross_attention_dim=cfgs.unet.cross_attention_dim, **kw)
    raise ValueError(f"unknown proj_kind {cfgs.proj_kind!r}")


class Components(nn.Module):
    """The sub-models of one family; ``text_encoder_2`` and ``harmony`` are
    None where the family has none."""

    def __init__(self, cfgs: ComponentConfigs, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfgs = cfgs
        self.unet = unet.UNet2DConditionModel(cfgs.unet, **kw)
        self.vae = vae.AutoencoderKL(cfgs.vae, **kw)
        self.text_encoder = clip_text.CLIPTextModel(cfgs.text_l, **kw)
        self.text_encoder_2 = (clip_text.CLIPTextModel(cfgs.text_g, **kw)
                               if cfgs.text_g is not None else None)
        self.image_encoder = clip_vision.CLIPVisionModelWithProjection(cfgs.vision, **kw)
        self.harmony = (harmony.HarmonyAttention(cfgs.harmony, **kw)
                        if cfgs.harmony is not None else None)
        self.image_proj = _image_proj(cfgs, **kw)

    def project_image_embeds(self, vision_out):
        """CLIP vision output -> image-prompt tokens: ``image_proj`` takes the
        projected pooled embedding, ``resampler`` and ``mlp_proj`` the
        penultimate patch features."""
        key = "projected" if self.cfgs.proj_kind == "image_proj" else "penultimate"
        return self.image_proj(vision_out[key])


def load_state_dict_(comps: Components, state_dict) -> Components:
    """Load a bundle state_dict (e.g. io/from_jax.state_dict) into ``comps``,
    casting to its dtype and device. The keys must match exactly."""
    missing, unexpected = comps.load_state_dict(state_dict, strict=False)
    if missing or unexpected:
        raise KeyError(
            f"state_dict mismatch: {len(missing)} missing (first: {missing[:5]}), "
            f"{len(unexpected)} unexpected (first: {unexpected[:5]})"
        )
    return comps


@torch.no_grad()
def init_weights_(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's init scales, in place: Linear/Conv weights and
    biases uniform in ±1/sqrt(fan_in) (nn/layers.py:38), norms ones/zeros,
    embedding tables N(0, 1), the CLIP vision class embedding N(0, 1), its
    patch conv N(0, 0.02²) and the resampler's latents N(0, 1/dim). These
    keep random full-size bf16 activations finite."""
    for m in root.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (LayerNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(generator=generator)
    for m in root.modules():
        if isinstance(m, clip_vision.CLIPVisionEmbeddings):
            m.class_embedding.normal_(generator=generator)
            m.patch_embedding.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, resampler.Resampler):
            m.latents.normal_(0.0, m.cfg.dim**-0.5, generator=generator)
    return root


def init_params(generator: torch.Generator, cfgs: ComponentConfigs, *,
                dtype=torch.float32, device="cuda") -> Components:
    """Random-weight bundle built directly on ``device`` (no host copy of
    the full-size weights); ``generator`` must live on the same device."""
    with torch.device("meta"):
        comps = Components(cfgs, dtype=dtype)
    comps = comps.to_empty(device=device)
    return init_weights_(comps, generator)


@torch.no_grad()
def seed_ip_from_unet(unet_module: nn.Module) -> nn.Module:
    """Copy each cross-attention's to_k/to_v weights into its to_k_ip/to_v_ip
    (the JAX trainer's ``_seed_ip_from_unet``, reference train.py:554-561): a
    warm start for a fresh IP branch. In place; returns the module."""
    for m in unet_module.modules():
        if hasattr(m, "to_k_ip") and hasattr(m, "to_k"):
            m.to_k_ip.weight.copy_(m.to_k.weight)
            m.to_v_ip.weight.copy_(m.to_v.weight)
    return unet_module
