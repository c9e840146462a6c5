"""Tensor-parallel sharding of the projections over the ``model`` axis (port
of imagharmony_tpu/parallel/tp_rules.py).

The JAX rules annotate parameters by name and GSPMD inserts the
all-reduces. Here ``shard_module_tp`` slices the weights in place, one
shard a rank, and the modules compute on their shard: a column-parallel
projection (``_COL``: q/k/v and the IP keys and values, the GEGLU
up-projection, CLIP's ``fc1``, the Q-Former's ``linear1``) keeps rows of
its torch (out, in) weight and of its bias, dim 0; a row-parallel one
(``_ROW``: ``to_out``, ``out_proj``, the FFN's ``net.2``, ``fc2``,
``linear2``) keeps columns, dim 1, and all-reduces its partial product
over the model group before it adds its bias, once (``nn/layers.Linear``).
Convs, norms and everything else stay whole on every rank, as in JAX.

Three things GSPMD does behind the JAX rules that the port does by hand:

* packed weights shard part by part: rank r holds [q_r | k_r | v_r] of a
  ``to_qkv``, [k_r | v_r] of a ``to_kv`` and [h_r | g_r] of a GEGLU
  ``proj``, so the modules' ``chunk`` after the product still splits q
  from k and h from g;
* heads split whole: an attention keeps heads / n_model heads of the
  packed layout, which is what K1 and K2 then see, and its IP projections
  split with ``to_q``. A layer whose head count (or FFN width) n_model
  does not divide stays whole on every rank, where GSPMD would split
  inside a head: the tiny UNet's one-head block, SDXL's 10-head blocks at
  4-way;
* the modules whose products reshape across the sharded dim (the HA
  head's ``fc1``/``fc2``, its cross-attention, the resampler) stay whole.

TP is an inference layout here, as JAX's ``with_mesh`` uses it: the
all-reduce carries no gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from imagharmony_tpu_torch.models import clip_text
from imagharmony_tpu_torch.nn import transformer
from imagharmony_tpu_torch.nn.attention import Attention
from imagharmony_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

# Linears whose OUTPUT dim shards over the model axis (column parallel)
_COL = {
    "to_q", "to_k", "to_v", "to_k_ip", "to_v_ip", "to_kv", "to_qkv",
    "q_proj", "k_proj", "v_proj",
    "net_0_proj",  # the GEGLU up-projection
    "fc1", "linear1",
}
# Linears whose INPUT dim shards (row parallel): their partial sums are
# all-reduced
_ROW = {"to_out", "out_proj", "net_2", "fc2", "linear2"}


def _parent(name: str) -> str:
    """The JAX name of the layer owning parameter ``name`` (a torch key)."""
    s = name.replace("net.0.proj.", "net_0_proj.").replace("net.2.", "net_2.")
    s = s.replace("to_out.0.", "to_out.")
    segs = s.split(".")
    return segs[-2] if len(segs) >= 2 else ""


def tp_spec(name: str, shape) -> tuple:
    """The TP spec of the torch parameter ``name`` of ``shape`` by the JAX
    rules, in torch layout: ("model", None) for a column-parallel (out, in)
    weight, (None, "model") for a row-parallel one, ("model",) for a
    column-parallel bias, () for the rest. ``shard_module_tp`` applies it
    where the layer's heads divide."""
    ndim, last, parent = len(shape), name.rsplit(".", 1)[-1], _parent(name)
    if ndim == 2 and last == "weight":
        if parent in _COL:
            return (MODEL_AXIS, None)
        if parent in _ROW:
            return (None, MODEL_AXIS)
    if ndim == 1 and last == "bias" and parent in _COL:
        return (MODEL_AXIS,)
    return ()


def _rows(x: torch.Tensor, parts: int, n: int, r: int) -> torch.Tensor:
    """Rank r's rows of each of ``parts`` equal blocks of dim 0, joined."""
    return torch.cat([p.chunk(n)[r] for p in x.chunk(parts)]).clone()


@torch.no_grad()
def _column(lin: nn.Linear, n: int, r: int, parts: int = 1):
    lin.weight = nn.Parameter(_rows(lin.weight, parts, n, r), requires_grad=False)
    if lin.bias is not None:
        lin.bias = nn.Parameter(_rows(lin.bias, parts, n, r), requires_grad=False)
    lin.out_features = lin.weight.shape[0]


@torch.no_grad()
def _row(lin: nn.Linear, n: int, r: int, group):
    lin.weight = nn.Parameter(lin.weight.chunk(n, dim=1)[r].clone(), requires_grad=False)
    lin.in_features = lin.weight.shape[1]
    lin.tp_group = group


def _shard_attention(m: Attention, n, r, group) -> bool:
    if m.heads % n:
        return False
    for name, parts in (("to_q", 1), ("to_k", 1), ("to_v", 1), ("to_k_ip", 1),
                        ("to_v_ip", 1), ("to_qkv", 3), ("to_kv", 2)):
        if hasattr(m, name):
            _column(getattr(m, name), n, r, parts)
    _row(m.to_out[0], n, r, group)
    m.heads //= n
    return True


def _shard_ffn(m: transformer.FeedForward, n, r, group) -> bool:
    proj = m.net[0].proj
    if (proj.weight.shape[0] // 2) % n:
        return False
    _column(proj, n, r, parts=2)
    _row(m.net[2], n, r, group)
    return True


def _shard_clip_attention(m: clip_text.CLIPAttention, n, r, group) -> bool:
    if m.heads % n:
        return False
    for lin in (m.q_proj, m.k_proj, m.v_proj):
        _column(lin, n, r)
    _row(m.out_proj, n, r, group)
    m.heads //= n
    return True


def _shard_mlp(up: nn.Linear, down: nn.Linear, n, r, group) -> bool:
    if up.weight.shape[0] % n:
        return False
    _column(up, n, r)
    _row(down, n, r, group)
    return True


def shard_module_tp(mesh: Mesh, module: nn.Module) -> int:
    """Shard every attention and FFN of ``module`` (a UNet, a ControlNet,
    the CLIP towers, the HA head's Q-Former, or a ``Components``) over
    ``mesh``'s model axis, in place: rank ``mesh.model_index`` keeps its
    shard. Returns the layers sharded (0 at n_model 1)."""
    from imagharmony_tpu_torch.adapters import harmony

    n, r, group = mesh.n_model, mesh.model_index, mesh.model_group
    if n == 1:
        return 0
    done = 0
    for m in list(module.modules()):
        if isinstance(m, Attention):
            done += _shard_attention(m, n, r, group)
        elif isinstance(m, transformer.FeedForward):
            done += _shard_ffn(m, n, r, group)
        elif isinstance(m, clip_text.CLIPAttention):
            done += _shard_clip_attention(m, n, r, group)
        elif isinstance(m, clip_text.CLIPMLP):
            done += _shard_mlp(m.fc1, m.fc2, n, r, group)
        elif isinstance(m, harmony.QFormerLayer):
            done += _shard_mlp(m.linear1, m.linear2, n, r, group)
    return done
