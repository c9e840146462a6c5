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
takes); the output maps each key to a torch tensor on the CPU. A bundle
with a ControlNet gives its ``controlnet.*`` keys (the embedder's
``controlnet_cond_embedding.blocks.N``, the 1x1 ``controlnet_down_blocks.N``)
without the IP projections the JAX ControlNet carries unused (the port's
ControlNet has none: its cross-attention is text only), and a LoRA factor tree gives ``adapters/lora.py``'s flat factors
(``....to_q.weight.lora_a``, not transposed) by the same rules.

``train_state_dict`` carries a JAX trainer state (``init_state``'s or a
step's: the trainable tree with its ``"lora"`` factors, optax's AdamW
moments and count, the EMA) into what the port's
``TrainState.load_state_dict`` takes, so a test can run both trainers from
the same numbers.
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


def jax_order(name: str, ndim: int):
    """The torch dims of the parameter ``name`` (a port key) in the order of
    the JAX leaf's dims (``to_torch_layout`` inverted): a 2-D weight's
    (in, out) is torch (1, 0), except an embedding table's; a conv's HWIO
    is torch (2, 3, 1, 0); every other leaf keeps its order. The FSDP rule
    walks the dims in this order, so it shards the axis JAX shards."""
    segs = name.split(".")
    if segs[-1] == "weight":
        if ndim == 2 and not (len(segs) >= 2 and segs[-2] in _EMBEDDING_PARENTS):
            return (1, 0)
        if ndim == 4:
            return (2, 3, 1, 0)
    return tuple(range(ndim))


def _controlnet_ip(tree, path) -> bool:
    """Whether ``path`` is an IP projection of a ControlNet: of the tree
    itself or of its ``controlnet`` entry."""
    if len(path) < 2 or path[-2] not in ("to_k_ip", "to_v_ip"):
        return False
    return isinstance(tree, dict) and ("controlnet_cond_embedding" in tree
                                       or path[0] == "controlnet")


def state_dict(tree) -> dict:
    """Flat {diffusers key: torch tensor} for a JAX parameter tree."""
    return {key_for(path): torch.tensor(to_torch_layout(path, leaf))
            for path, leaf in _leaves(tree) if not _controlnet_ip(tree, path)}


def trainable_state_dict(tree) -> dict:
    """{port trainable name: tensor} of a tree shaped as the JAX trainable
    tree: its ``"lora"`` entry's factors under ``lora.``."""
    tree = dict(tree)
    factors = tree.pop("lora", None)
    out = state_dict(tree)
    if factors is not None:
        out.update({f"lora.{k}": v for k, v in state_dict(factors).items()})
    return out


def _adam_state(opt_state):
    """The ScaleByAdamState (count, mu, nu) inside an optax state."""
    stack = [opt_state]
    while stack:
        x = stack.pop()
        if all(hasattr(x, f) for f in ("count", "mu", "nu")):
            return x
        if isinstance(x, (tuple, list)):
            stack.extend(x)
    raise ValueError("no AdamW moments in the optax state")


def train_state_dict(jax_state, state) -> dict:
    """A JAX trainer state -> ``state.load_state_dict``'s argument for the
    port's ``TrainState`` ``state`` (whose optimizer's param groups give
    the parameters' order): the trainable values, each parameter's AdamW
    step, exp_avg and exp_avg_sq (optax's count, mu and nu), the update
    count and the EMA. The lr is left at ``state``'s."""
    adam = _adam_state(jax_state["opt_state"])
    count = int(np.asarray(adam.count))
    mu, nu = trainable_state_dict(adam.mu), trainable_state_dict(adam.nu)
    names = {id(p): n for n, p in state.trainable.items()}
    opt = state.optimizer.state_dict()
    capturable = state.lr.device.type == "cuda"
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    opt["state"] = {i: {"step": torch.tensor(float(count), device=p.device if capturable
                                             else "cpu"),
                        "exp_avg": mu[names[id(p)]].to(p.device),
                        "exp_avg_sq": nu[names[id(p)]].to(p.device)}
                    for i, p in enumerate(params)}
    ema = jax_state.get("ema")
    return {"trainable": trainable_state_dict(jax_state["trainable"]), "optimizer": opt,
            "count": torch.tensor([count], device=state.count.device), "lr": state.lr.clone(),
            "step": count, "ema": None if ema is None else trainable_state_dict(ema)}
