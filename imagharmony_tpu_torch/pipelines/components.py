"""The SDXL + adapters model bundle a pipeline runs (port of
imagharmony_tpu/pipelines/components.py, SDXL family with the
``image_proj`` head).

``Components`` holds every sub-model as one ``nn.Module``; its state_dict
keys are the JAX bundle's keys in diffusers form (``unet.*``, ``vae.*``,
``text_encoder.*``, ``text_encoder_2.*``, ``image_encoder.*``,
``harmony.*``, ``image_proj.*``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from imagharmony_tpu_torch.adapters import harmony
from imagharmony_tpu_torch.adapters.projections import ImageProjModel
from imagharmony_tpu_torch.models import clip_text, clip_vision, unet, vae
from imagharmony_tpu_torch.nn.layers import GroupNorm, LayerNorm


@dataclasses.dataclass(frozen=True)
class ComponentConfigs:
    unet: unet.UNetConfig
    vae: vae.VAEConfig
    text_l: clip_text.CLIPTextConfig
    text_g: clip_text.CLIPTextConfig
    vision: clip_vision.CLIPVisionConfig
    harmony: harmony.HarmonyConfig
    num_ip_tokens: int = 4


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


def tiny_configs(vocab_size=1000) -> ComponentConfigs:
    """Topology-faithful miniature for tests (the JAX tiny_configs)."""
    tl = clip_text.tiny_config(vocab_size=vocab_size, hidden_size=24, num_heads=4)
    tg = clip_text.tiny_config(vocab_size=vocab_size, hidden_size=40, num_heads=4,
                               projection_dim=32)
    return ComponentConfigs(
        unet=unet.tiny_config(),
        vae=vae.tiny_config(),
        text_l=tl,
        text_g=tg,
        vision=clip_vision.tiny_config(projection_dim=32),
        harmony=harmony.tiny_config(image_hidden_size=32,
                                    text_context_dim=tl.hidden_size + tg.hidden_size),
    )


class Components(nn.Module):
    def __init__(self, cfgs: ComponentConfigs, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfgs = cfgs
        self.unet = unet.UNet2DConditionModel(cfgs.unet, **kw)
        self.vae = vae.AutoencoderKL(cfgs.vae, **kw)
        self.text_encoder = clip_text.CLIPTextModel(cfgs.text_l, **kw)
        self.text_encoder_2 = clip_text.CLIPTextModel(cfgs.text_g, **kw)
        self.image_encoder = clip_vision.CLIPVisionModelWithProjection(cfgs.vision, **kw)
        self.harmony = harmony.HarmonyAttention(cfgs.harmony, **kw)
        self.image_proj = ImageProjModel(
            clip_embed_dim=cfgs.vision.projection_dim,
            cross_attention_dim=cfgs.unet.cross_attention_dim,
            num_tokens=cfgs.num_ip_tokens, **kw,
        )


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
    embedding tables N(0, 1), the CLIP vision class embedding N(0, 1) and its
    patch conv N(0, 0.02²). These keep random full-size bf16 activations
    finite."""
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
