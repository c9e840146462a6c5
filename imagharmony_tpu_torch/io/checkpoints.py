"""Adapter checkpoint export (port of the export half of
imagharmony_tpu/io/checkpoints.py).

The 3-dict ``{"image_proj", "ip_adapter", "composed_adapter"}`` format of
reference convert_bin.py:36-43, plus the HA config as a JSON string under
``"harmony_config"``, written with ``torch.save`` so that stock
``torch.load`` reads it. The ``ip_adapter`` keys are ``<N>.to_k_ip.weight``
where N indexes diffusers' ``unet.attn_processors`` enumeration (attn1 and
attn2 processors of every transformer block in registration order:
down_blocks, up_blocks, mid_block).

The readers (``load_pipeline``, ``load_adapter_checkpoint``) and the
``.safetensors`` writer are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from imagharmony_tpu_torch.adapters.harmony import HarmonyConfig
from imagharmony_tpu_torch.models.unet import UNetConfig


def attn_processor_paths(cfg: UNetConfig) -> List[Tuple[str, Optional[str]]]:
    """The diffusers ``unet.attn_processors`` enumeration for this config:
    [(processor name, dotted name of our attn2 module or None), ...] in
    registration order. attn1 rows map to None: they carry no IP weights but
    still take an index."""
    rows = []

    def add_transformer(prefix, block_idx):
        for tb in range(cfg.transformer_layers_per_block[block_idx]):
            base = f"{prefix}.transformer_blocks.{tb}"
            rows.append((f"{base}.attn1.processor", None))
            rows.append((f"{base}.attn2.processor", f"{base}.attn2"))

    for i, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            for j in range(cfg.layers_per_block):
                add_transformer(f"down_blocks.{i}.attentions.{j}", i)
    for i, btype in enumerate(cfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            for j in range(cfg.layers_per_block + 1):
                add_transformer(f"up_blocks.{i}.attentions.{j}",
                                len(cfg.block_out_channels) - 1 - i)
    add_transformer("mid_block.attentions.0", len(cfg.block_out_channels) - 1)
    return rows


def _export(t: torch.Tensor) -> torch.Tensor:
    # a standalone CPU copy: torch.save of a view would write its whole storage
    return t.detach().to("cpu").contiguous().clone()


def extract_adapter_state(unet: nn.Module, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """Our UNet -> the reference-format ``ip_adapter`` flat dict (torch
    (out, in) weights)."""
    out = {}
    for idx, (_, path) in enumerate(attn_processor_paths(cfg)):
        if path is None:
            continue
        attn = unet.get_submodule(path)
        for proj in ("to_k_ip", "to_v_ip"):
            out[f"{idx}.{proj}.weight"] = _export(getattr(attn, proj).weight)
    return out


def _harmony_export_key(k: str) -> str:
    # a packed qformer in_proj -> torch MultiheadAttention's in_proj_weight/bias
    return k.replace("in_proj.weight", "in_proj_weight").replace(
        "in_proj.bias", "in_proj_bias"
    )


def save_adapter_checkpoint(path, *, unet: nn.Module, unet_cfg: UNetConfig,
                            image_proj: nn.Module, harmony: nn.Module,
                            harmony_cfg: HarmonyConfig):
    """Write the 3-dict adapter checkpoint to a ``.bin`` with torch.save."""
    path = str(path)
    if path.endswith(".safetensors"):
        raise NotImplementedError("the .safetensors export is not ported yet (ROADMAP A10)")
    torch.save(
        {
            "image_proj": {k: _export(v) for k, v in image_proj.state_dict().items()},
            "ip_adapter": extract_adapter_state(unet, unet_cfg),
            "composed_adapter": {_harmony_export_key(k): _export(v)
                                 for k, v in harmony.state_dict().items()},
            "harmony_config": json.dumps(dataclasses.asdict(harmony_cfg)),
        },
        path,
    )
