"""JAX parameter tree -> the port's state_dict.

The JAX package names its parameter trees after the HF/diffusers
checkpoints, so the conversion is one walk over the tree with the layout
rules of the JAX package's checkpoint importer (reimplemented here, the
port never imports the JAX package):

* path segments join with "." (list indices included); ``encoder_layers``
  becomes ``encoder.layers`` and the FFN's ``net_0_proj``/``net_2`` become
  ``net.0.proj``/``net.2``;
* a diffusers ``to_out`` is a ModuleList, so its weight and bias live at
  ``to_out.0`` (the resampler's bias-free ``to_out`` too, as the JAX
  exporter writes it);
* 2-D ``weight`` leaves are transposed from (in, out) to torch's (out, in),
  except embedding tables;
* 4-D ``weight`` leaves go from HWIO to OIHW;
* None leaves (absent submodules) are skipped.

The input is nested dicts/lists of numpy arrays (or anything np.asarray
takes); the output maps each key to a torch tensor on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

_EMBEDDING_PARENTS = {"token_embedding", "position_embedding", "modality_embed",
                      "shared_embedding", "pos_emb"}
_SEGMENT_REWRITES = {"encoder_layers": "encoder.layers", "net_0_proj": "net.0.proj",
                     "net_2": "net.2"}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def key_for(path) -> str:
    segs = [_SEGMENT_REWRITES.get(s, s) for s in path]
    if len(segs) >= 2 and segs[-2] == "to_out" and segs[-1] in ("weight", "bias"):
        segs[-2] = "to_out.0"
    return ".".join(segs)


def to_torch_layout(path, arr) -> np.ndarray:
    a = np.asarray(arr)
    if path[-1] == "weight":
        if a.ndim == 2 and not (len(path) >= 2 and path[-2] in _EMBEDDING_PARENTS):
            a = a.T
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return a


def state_dict(tree) -> dict:
    """Flat {diffusers key: torch tensor} for a JAX parameter tree."""
    return {key_for(path): torch.tensor(to_torch_layout(path, leaf))
            for path, leaf in _leaves(tree)}
