"""HF/diffusers checkpoint keys <-> the port's modules (port of
imagharmony_tpu/io/hf_import.py).

The port's modules carry the diffusers and transformers parameter names and
torch's layouts already (see ``io/from_jax.py``), so importing a
checkpoint is a walk over the module's ``state_dict`` with no transpose:

* the CLIP towers' keys sit under ``text_model.`` / ``vision_model.``
  (``prefix``), and ``text_projection`` / ``visual_projection`` outside it
  (``key_map``);
* a key the module has and the checkpoint lacks raises, listing the first
  10; a shape that differs raises, naming the key;
* a key the checkpoint has and the module lacks is ignored (transformers
  dumps carry buffers such as ``text_model.embeddings.position_ids``);
* a 1x1 conv weight (out, in, 1, 1) fills a linear weight (out, in): the
  SD1.5 UNet (``use_linear_projection: false``) stores its transformers'
  ``proj_in``/``proj_out`` so, where the port has linear maps (the JAX
  importer refuses those files);
* values are cast to the parameter's dtype and copied onto its device.

``export_state`` is the inverse, one component's ``{hf_key: tensor}``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

TEXT_PREFIX = "text_model."
VISION_PREFIX = "vision_model."


def text_key_map(k: str) -> str:
    """The projection tower's ``text_projection`` lies outside ``text_model.``."""
    return k.replace("text_model.text_projection", "text_projection")


def vision_key_map(k: str) -> str:
    return k.replace("vision_model.visual_projection", "visual_projection")


@torch.no_grad()
def import_state(module: nn.Module, flat: Dict[str, torch.Tensor], *, prefix: str = "",
                 key_map: Optional[Callable[[str], str]] = None) -> nn.Module:
    """Copy ``flat`` ({hf_key: tensor}) into ``module``'s parameters, in place;
    returns the module."""
    targets, missing = {}, []
    for name, p in module.state_dict(keep_vars=True).items():
        key = prefix + name
        if key_map is not None:
            key = key_map(key)
        if key not in flat:
            missing.append(key)
        else:
            targets[key] = p
    if missing:
        raise KeyError(f"{len(missing)} keys missing from checkpoint (first 10): {missing[:10]}")
    for key, p in targets.items():
        src = flat[key]
        if src.dim() == 4 and p.dim() == 2 and tuple(src.shape) == (*p.shape, 1, 1):
            src = src.reshape(p.shape)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint {tuple(src.shape)} vs model "
                             f"{tuple(p.shape)}")
        p.copy_(src)
    return module


def export_state(module: nn.Module, *, prefix: str = "",
                 key_map: Optional[Callable[[str], str]] = None) -> Dict[str, torch.Tensor]:
    """``module``'s weights as {hf_key: tensor}, each on its own device and in
    its own dtype."""
    out = {}
    for name, t in module.state_dict().items():
        key = prefix + name
        out[key_map(key) if key_map is not None else key] = t.detach()
    return out
