"""The trainable surface of adapter training (port of the predicates of
imagharmony_tpu/utils/tree.py).

The JAX package splits its parameter tree into a trainable and a frozen
subtree (``split_by_path``/``merge``); here the split is ``requires_grad``
on the one module, and the predicates read the parameter's dotted
``named_parameters()`` name.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn


def adapter_predicate(name: str) -> bool:
    """The reference's optimizer surface (train.py:600-601): every
    decoupled-attention projection (to_k_ip/to_v_ip live on all
    cross-attention layers, trained even where the IP branch is inert) and
    the HA module."""
    segs = name.split(".")
    return "to_k_ip" in segs or "to_v_ip" in segs or segs[0] == "harmony"


def adapter_plus_proj_predicate(name: str) -> bool:
    """The adapter surface plus the image projection head."""
    return adapter_predicate(name) or name.startswith("image_proj.")


def set_trainable(module: nn.Module, predicate: Callable[[str], bool]) -> Dict[str, torch.Tensor]:
    """Make exactly the parameters whose name satisfies ``predicate``
    require grad (all others frozen) and return them by name, in
    ``named_parameters()`` order."""
    trainable = {}
    for name, p in module.named_parameters():
        p.requires_grad_(predicate(name))
        if p.requires_grad:
            trainable[name] = p
    return trainable
