"""Low-rank adaptation (LoRA) of the UNet's attention projections, merged for
inference (port of imagharmony_tpu/adapters/lora.py).

Each targeted linear W gets factors A (in, r) and B (r, out) and the
effective weight ``W + scale * (alpha/r) * A @ B``. The factors live in a
flat dict keyed as the JAX package's ``flatten`` writes them, which is also
the ``save_lora`` file's layout: ``<block path>.attn1.to_q.weight.lora_a``
(``to_out`` for the output projection, whose torch module is ``to_out.0``).
The JAX package's nested tree and its ``flatten``/``unflatten`` have no
counterpart here: the flat dict is the tree.

``apply_lora`` merges in fp32 and casts back to the weight's dtype, as the
JAX package's does, into a copy of the UNet that shares every untouched
parameter with the original; a merged weight is a new tensor, so the
original UNet (and any CUDA graph captured on it) is left as it was. It
merges into packed projections (``to_qkv``, ``to_kv``) row block by row
block. ``merged_weights`` is the same merge for training, differentiable in
the factors (the JAX ``apply_lora`` inside ``loss_fn``): it returns the
merged weights by parameter name, for ``torch.func.functional_call``, and
gives ``apply_lora``'s values bit for bit.

``load_lora`` also reads the community formats (kohya ``lora_unet_*`` and
diffusers-peft ``unet.*.lora_A``) through ``load_community_lora``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Dict, Tuple

import torch
from torch import nn

from imagharmony_tpu_torch.nn.attention import Attention
from imagharmony_tpu_torch.pipelines.components import share_copy

ATTN_KEYS = ("attn1", "attn2")
PROJECTIONS = ("to_q", "to_k", "to_v", "to_out")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    # the scaling numerator; None -> rank (alpha/r == 1)
    alpha: float | None = None
    # which projections get factors ("to_out" is the output projection)
    targets: Tuple[str, ...] = PROJECTIONS
    # self ("attn1") and/or cross ("attn2") attention
    attn: Tuple[str, ...] = ATTN_KEYS

    @property
    def scale(self) -> float:
        a = self.rank if self.alpha is None else self.alpha
        return a / self.rank


def _projection_dims(attn: Attention, proj: str) -> Tuple[int, int]:
    """(in, out) of one of an Attention's projections, packed or not."""
    out = attn.to_out[0].weight
    query_dim, inner = out.shape
    if proj == "to_out":
        return inner, query_dim
    if proj == "to_q" or not attn.is_cross:
        return query_dim, inner
    ctx = (attn.to_kv if hasattr(attn, "to_kv") else attn.to_k).weight.shape[1]
    return ctx, inner


def _targets(unet: nn.Module, cfg: LoRAConfig):
    """[(JAX-layout weight key, module path, projection, (in, out))] of every
    projection ``cfg`` targets (the JAX package's ``_is_target``), in the
    UNet's module order."""
    rows = []
    for name, m in unet.named_modules():
        if isinstance(m, Attention) and name.split(".")[-1] in cfg.attn:
            for proj in PROJECTIONS:
                if proj in cfg.targets:
                    rows.append((f"{name}.{proj}.weight", name, proj, _projection_dims(m, proj)))
    return rows


def init_lora(generator: torch.Generator, unet: nn.Module, cfg: LoRAConfig) -> Dict[str, torch.Tensor]:
    """Factors for every targeted projection of ``unet``: A ~ N(0, 1/r²)
    (stddev 1/r, the JAX package's), B = 0, so a fresh LoRA changes nothing.
    fp32, on the generator's device."""
    dev = generator.device
    factors = {}
    for key, _, _, (d_in, d_out) in _targets(unet, cfg):
        factors[key + ".lora_a"] = torch.randn((d_in, cfg.rank), generator=generator,
                                               device=dev) / cfg.rank
        factors[key + ".lora_b"] = torch.zeros((cfg.rank, d_out), device=dev)
    return factors


def _row_slice(attn: Attention, proj: str):
    """(the Linear holding ``proj``, the rows of its weight that are it)."""
    if proj == "to_out":
        return attn.to_out[0], slice(None)
    if proj == "to_q" and attn.is_cross:
        return attn.to_q, slice(None)
    packed = "to_kv" if attn.is_cross else "to_qkv"
    if not hasattr(attn, packed):
        return getattr(attn, proj), slice(None)
    order = ("to_k", "to_v") if attn.is_cross else ("to_q", "to_k", "to_v")
    n = attn.to_out[0].weight.shape[1]
    i = order.index(proj)
    return getattr(attn, packed), slice(i * n, (i + 1) * n)


@torch.no_grad()
def apply_lora(unet: nn.Module, factors: Dict[str, torch.Tensor], cfg: LoRAConfig, *,
               scale: float = 1.0) -> nn.Module:
    """A copy of ``unet`` (``components.share_copy``) with ``W + scale * (alpha/r) *
    A @ B`` merged at every factored projection: in fp32, cast to the
    weight's dtype. Each merged Linear gets a new weight tensor."""
    s = cfg.scale * scale
    out = share_copy(unet)
    merged = {}  # id(Linear) -> (the Linear, its fp32 merged weight)
    for key in sorted(k[: -len(".lora_a")] for k in factors if k.endswith(".lora_a")):
        path = key.split(".")
        lin, rows = _row_slice(out.get_submodule(".".join(path[:-2])), path[-2])
        if id(lin) not in merged:
            merged[id(lin)] = (lin, lin.weight.float().clone())
        w = merged[id(lin)][1]
        a = factors[key + ".lora_a"].to(w.device, torch.float32)
        b = factors[key + ".lora_b"].to(w.device, torch.float32)
        w[rows] += (a @ b).T * s
    for lin, w in merged.values():
        lin.weight = nn.Parameter(w.to(lin.weight.dtype), requires_grad=False)
    return out


def merged_weights(unet: nn.Module, factors: Dict[str, torch.Tensor],
                   cfg: LoRAConfig) -> Dict[str, torch.Tensor]:
    """{parameter name in ``unet``: W'} for every factored projection of an
    unpacked UNet, W' = (W.float() + (alpha/r) * (A @ B)^T) cast to W's
    dtype: the JAX order (add in fp32, then cast) and ``apply_lora``'s
    arithmetic. Differentiable in the factors (the cast's gradient is the
    identity, so the fp32 factors get fp32 gradients)."""
    s = cfg.scale
    out = {}
    for key in sorted(k[: -len(".lora_a")] for k in factors if k.endswith(".lora_a")):
        path = key.split(".")
        attn_path = ".".join(path[:-2])
        lin, rows = _row_slice(unet.get_submodule(attn_path), path[-2])
        if rows != slice(None):
            raise ValueError(f"{attn_path} is packed: train on the unpacked UNet")
        name = f"{attn_path}.to_out.0.weight" if path[-2] == "to_out" else key
        w = lin.weight
        delta = (factors[key + ".lora_a"] @ factors[key + ".lora_b"]).T * s
        out[name] = (w.float() + delta).to(w.dtype)
    return out


def num_params(factors) -> int:
    return sum(v.numel() for v in factors.values())


def save_lora(path, factors: Dict[str, torch.Tensor], cfg: LoRAConfig):
    """A ``.safetensors`` file of the factors with the config as metadata
    (the JAX package's ``save_lora`` format)."""
    from imagharmony_tpu_torch.io import safetensors

    meta = {"format": "imagharmony-lora", "rank": str(cfg.rank),
            "alpha": str(cfg.rank if cfg.alpha is None else cfg.alpha),
            "targets": ",".join(cfg.targets), "attn": ",".join(cfg.attn)}
    safetensors.save(path, {k: v.float() for k, v in factors.items()}, metadata=meta)


def load_lora(path):
    """-> (factors, LoRAConfig) from a ``save_lora`` file, or from a
    community-format UNet LoRA (``load_community_lora``), told apart by
    their keys. CPU fp32 tensors."""
    from imagharmony_tpu_torch.io import safetensors

    tensors, meta = safetensors.load(path)
    if meta.get("format") != "imagharmony-lora" and _looks_community(tensors):
        return load_community_lora(tensors)
    cfg = LoRAConfig(
        rank=int(meta.get("rank", 8)),
        alpha=float(meta["alpha"]) if "alpha" in meta else None,
        targets=tuple((meta.get("targets") or ",".join(PROJECTIONS)).split(",")),
        attn=tuple((meta.get("attn") or ",".join(ATTN_KEYS)).split(",")),
    )
    return {k: v.float() for k, v in tensors.items()}, cfg


# ---------------------------------------------------------------------------
# Community formats (kohya sd-scripts, diffusers-peft UNet LoRAs)
# ---------------------------------------------------------------------------

_KOHYA_BLOCK = re.compile(
    r"^(down_blocks|up_blocks)_(\d+)_attentions_(\d+)_transformer_blocks_"
    r"(\d+)_(attn[12])_(to_q|to_k|to_v|to_out_0)$")
_KOHYA_MID = re.compile(
    r"^mid_block_attentions_(\d+)_transformer_blocks_(\d+)_(attn[12])_(to_q|to_k|to_v|to_out_0)$")
_PEFT_PATH = re.compile(
    r"^(?:down_blocks|up_blocks)\.\d+\.attentions\.\d+\.transformer_blocks\."
    r"\d+\.attn[12]\.(?:to_q|to_k|to_v|to_out)$")
_PEFT_MID = re.compile(
    r"^mid_block\.attentions\.\d+\.transformer_blocks\.\d+\.attn[12]\.(?:to_q|to_k|to_v|to_out)$")


def _looks_community(tensors) -> bool:
    return any(k.startswith(("lora_unet_", "lora_te", "unet.", "text_encoder")) for k in tensors)


def _community_module_path(name):
    """A community module name -> the JAX-layout weight key, or None outside
    the attention projections."""
    if name.startswith("lora_unet_"):
        body = name[len("lora_unet_"):]
        m = _KOHYA_BLOCK.match(body)
        if m:
            bk, bi, ai, ti, attn, proj = m.groups()
            proj = "to_out" if proj == "to_out_0" else proj
            return f"{bk}.{bi}.attentions.{ai}.transformer_blocks.{ti}.{attn}.{proj}.weight"
        m = _KOHYA_MID.match(body)
        if m:
            ai, ti, attn, proj = m.groups()
            proj = "to_out" if proj == "to_out_0" else proj
            return f"mid_block.attentions.{ai}.transformer_blocks.{ti}.{attn}.{proj}.weight"
        return None
    if name.startswith("unet."):
        body = name[len("unet."):].replace(".to_out.0", ".to_out")
        if _PEFT_PATH.match(body) or _PEFT_MID.match(body):
            return body + ".weight"
    return None


def load_community_lora(tensors):
    """Kohya (``lora_unet_*.lora_down/lora_up.weight`` and a per-module
    ``.alpha``) or diffusers-peft (``unet.*.lora_A/lora_B.weight``) ->
    (factors, LoRAConfig of scale 1): each module's alpha/r is folded into
    its B, so modules of different ranks load. Modules outside the UNet's
    attention projections (text-encoder, feed-forward, conv LoRA) are
    skipped with a warning; raises if none maps."""
    mods, skipped = {}, set()
    for k, v in tensors.items():
        for suf, slot in ((".lora_down.weight", "down"), (".lora_up.weight", "up"),
                          (".alpha", "alpha"), (".lora_A.weight", "down"),
                          (".lora_B.weight", "up")):
            if k.endswith(suf):
                mods.setdefault(k[: -len(suf)], {})[slot] = v
                break
        else:
            skipped.add(k)
    factors = {}
    for name, parts in sorted(mods.items()):
        path = _community_module_path(name)
        if path is None or "down" not in parts or "up" not in parts:
            skipped.add(name)
            continue
        down = torch.as_tensor(parts["down"]).float()  # (r, in)
        up = torch.as_tensor(parts["up"]).float()      # (out, r)
        r = down.shape[0]
        alpha = float(torch.as_tensor(parts.get("alpha", r)).reshape(()).item())
        factors[path + ".lora_a"] = down.T.contiguous()
        factors[path + ".lora_b"] = (up.T * (alpha / r)).contiguous()
    if not factors:
        raise ValueError("no UNet attention-projection LoRA modules found "
                         f"(first skipped: {sorted(skipped)[:5]})")
    if skipped:
        logging.getLogger("imagharmony.lora").warning(
            "community LoRA: %d module(s)/key(s) outside the UNet attention-projection surface "
            "were SKIPPED (e.g. %s) - outputs will differ from stacks that apply the full "
            "adapter", len(skipped), sorted(skipped)[:3])
    return factors, LoRAConfig(rank=1, alpha=1.0)


def parse_spec(spec: str, default_scale: float = 1.0):
    """A CLI spec ``PATH[:SCALE]`` -> (path, scale); a file whose name holds
    a colon wins over the suffix reading."""
    if os.path.exists(spec) or ":" not in spec:
        return spec, default_scale
    path, suffix = spec.rsplit(":", 1)
    try:
        return path, float(suffix)
    except ValueError:
        return spec, default_scale
