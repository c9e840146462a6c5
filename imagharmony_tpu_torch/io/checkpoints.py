"""Checkpoint IO (port of imagharmony_tpu/io/checkpoints.py): diffusers trees,
the 3-dict adapter checkpoint, training-run conversion.

* **Bases**: a diffusers SDXL, SDXL-refiner or SD1.5 directory (a
  ``config.json`` and ``.safetensors`` or ``.bin`` weights per component,
  index-sharded or not, ``tokenizer/`` and ``tokenizer_2/``) ->
  ``load_pipeline`` / ``load_components``; a diffusers ControlNetModel
  directory beside it (``controlnet_dir``). ``.safetensors`` goes through ``io/safetensors.py``
  and ``.bin`` through ``io/torch_zip.py``, neither of which runs code from
  the file.
* **Adapters**: the 3-dict ``{"image_proj", "ip_adapter",
  "composed_adapter"}`` format of reference convert_bin.py:36-43, plus the
  HA config as a JSON string (``"harmony_config"``), read from and written
  to ``.bin`` (``torch.save``) or ``.safetensors`` (flat keys under the
  dict names, the HA config as metadata).
* **Training runs**: ``convert_training_checkpoints`` re-keys
  accelerate-style dumps into the 3-dict form.

The ``ip_adapter`` keys are ``<N>.to_k_ip.weight`` where N indexes
diffusers' ``unet.attn_processors`` enumeration (attn1 and attn2 processors
of every transformer block in registration order: down_blocks, up_blocks,
mid_block). The reference's weights are (out, in), as torch's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from imagharmony_tpu_torch import dtypes
from imagharmony_tpu_torch.adapters.harmony import HarmonyConfig
from imagharmony_tpu_torch.io import hf_import, safetensors, torch_zip
from imagharmony_tpu_torch.models import clip_text, clip_vision, controlnet, unet, vae
from imagharmony_tpu_torch.models import tokenizer as tok_lib
from imagharmony_tpu_torch.models.unet import UNetConfig
from imagharmony_tpu_torch.pipelines import components as comp

# ---------------------------------------------------------------------------
# Generic file loading
# ---------------------------------------------------------------------------


def load_flat(path) -> Dict[str, torch.Tensor]:
    """Any checkpoint file -> a flat {key: CPU tensor} dict."""
    path = str(path)
    if path.endswith(".safetensors"):
        return safetensors.load(path)[0]
    return flatten_nested(torch_zip.load(path))


def flatten_nested(obj, prefix=""):
    flat = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            flat.update(flatten_nested(v, f"{prefix}{k}."))
    else:
        flat[prefix[:-1]] = obj
    return flat


def load_sharded_dir(dirpath) -> Dict[str, torch.Tensor]:
    """A HF model dir (one file, or shards named by a ``*.index.json``)."""
    entries = sorted(os.listdir(dirpath))
    index = [e for e in entries if e.endswith(".index.json")]
    if index:
        with open(os.path.join(dirpath, index[0])) as f:
            weight_map = json.load(f)["weight_map"]
        flat = {}
        for shard in sorted(set(weight_map.values())):
            flat.update(load_flat(os.path.join(dirpath, shard)))
        return flat
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.bin"):
        p = os.path.join(dirpath, name)
        if os.path.exists(p):
            return load_flat(p)
    raise FileNotFoundError(f"no model weights found in {dirpath}")


# ---------------------------------------------------------------------------
# Attention-processor enumeration (diffusers order)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Adapter 3-dict format
# ---------------------------------------------------------------------------


def _export(t: torch.Tensor) -> torch.Tensor:
    # a standalone CPU copy: torch.save of a view would write its whole storage
    return t.detach().to("cpu").contiguous().clone()


def adapter_projections(unet_module: nn.Module, cfg: UNetConfig) -> Dict[str, nn.Module]:
    """The reference-format ``ip_adapter`` key ("N.to_k_ip.weight") -> the
    UNet's Linear that holds it."""
    out = {}
    for idx, (_, path) in enumerate(attn_processor_paths(cfg)):
        if path is None:
            continue
        attn = unet_module.get_submodule(path)
        for proj in ("to_k_ip", "to_v_ip"):
            out[f"{idx}.{proj}.weight"] = getattr(attn, proj)
    return out


def extract_adapter_state(unet_module: nn.Module, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """Our UNet -> the reference-format ``ip_adapter`` flat dict."""
    return {k: _export(lin.weight) for k, lin in adapter_projections(unet_module, cfg).items()}


@torch.no_grad()
def apply_adapter_state(unet_module: nn.Module, cfg: UNetConfig,
                        ip_flat: Dict[str, torch.Tensor]) -> nn.Module:
    """Load the reference's ``ip_adapter`` dict ("N.to_k_ip.weight") into our
    UNet, in place; returns it."""
    for idx, (_, path) in enumerate(attn_processor_paths(cfg)):
        if path is None:
            continue
        attn = unet_module.get_submodule(path)
        for proj in ("to_k_ip", "to_v_ip"):
            key = f"{idx}.{proj}.weight"
            if key not in ip_flat:
                raise KeyError(f"adapter checkpoint missing {key}")
            target = getattr(attn, proj).weight
            if tuple(ip_flat[key].shape) != tuple(target.shape):
                raise ValueError(f"{key}: ckpt {tuple(ip_flat[key].shape)} vs model "
                                 f"{tuple(target.shape)}")
            target.copy_(ip_flat[key])
    return unet_module


def _harmony_export_key(k: str) -> str:
    # a packed qformer in_proj -> torch MultiheadAttention's in_proj_weight/bias
    return k.replace("in_proj.weight", "in_proj_weight").replace(
        "in_proj.bias", "in_proj_bias"
    )


def _harmony_import_key(k: str) -> str:
    k = k.replace("in_proj_weight", "in_proj.weight").replace("in_proj_bias", "in_proj.bias")
    # the legacy Composed_Attention names its fusion module "cross_attention"
    # (reference shared_models.py:90)
    if k.startswith("cross_attention."):
        k = "fusion_text_image." + k[len("cross_attention."):]
    return k


def import_harmony(module: nn.Module, composed_flat: Dict[str, torch.Tensor]) -> nn.Module:
    """The reference's ``composed_adapter`` dict -> our HA module, in place."""
    return hf_import.import_state(
        module, {_harmony_import_key(k): v for k, v in composed_flat.items()})


def harmony_config_from_json(s: str) -> HarmonyConfig:
    """The ``harmony_config`` string of an adapter file (every fusion's
    fields); keys this config does not know are dropped."""
    names = {f.name for f in dataclasses.fields(HarmonyConfig)}
    return HarmonyConfig(**{k: v for k, v in json.loads(s).items() if k in names})


def save_adapter_checkpoint(path, *, unet: nn.Module, unet_cfg: UNetConfig,
                            image_proj: nn.Module, harmony: nn.Module,
                            harmony_cfg: HarmonyConfig):
    """Write the 3-dict adapter checkpoint: ``.safetensors`` as flat keys
    under the dict names with the HA config as metadata, anything else with
    ``torch.save``."""
    groups = {
        "image_proj": {k: _export(v) for k, v in image_proj.state_dict().items()},
        "ip_adapter": extract_adapter_state(unet, unet_cfg),
        "composed_adapter": {_harmony_export_key(k): _export(v)
                             for k, v in harmony.state_dict().items()},
    }
    ha_json = json.dumps(dataclasses.asdict(harmony_cfg))
    path = str(path)
    if path.endswith(".safetensors"):
        flat = {f"{g}.{k}": v for g, d in groups.items() for k, v in d.items()}
        safetensors.save(path, flat, metadata={"harmony_config": ha_json})
    else:
        torch.save({**groups, "harmony_config": ha_json}, path)


def load_adapter_checkpoint(path):
    """-> (image_proj_flat, ip_adapter_flat, composed_flat, HarmonyConfig or
    None), CPU tensors."""
    path = str(path)
    if path.endswith(".safetensors"):
        tensors, meta = safetensors.load(path)
        groups = {"image_proj": {}, "ip_adapter": {}, "composed_adapter": {}}
        for k, v in tensors.items():
            head, rest = k.split(".", 1)
            groups[head][rest] = v
        cfg = harmony_config_from_json(meta["harmony_config"]) if "harmony_config" in meta \
            else None
        return groups["image_proj"], groups["ip_adapter"], groups["composed_adapter"], cfg
    obj = torch_zip.load(path)
    cfg = harmony_config_from_json(obj["harmony_config"]) if "harmony_config" in obj else None
    return (flatten_nested(obj["image_proj"]), flatten_nested(obj["ip_adapter"]),
            flatten_nested(obj.get("composed_adapter", {})), cfg)


def convert_training_checkpoints(log_dir, *, pattern="checkpoint-"):
    """Walk ``log_dir`` for accelerate-style ``checkpoint-*/pytorch_model.bin``
    and write ``ip_adapter.bin`` (the 3-dict form) next to each that has
    none (reference convert_bin.py:58-102). Returns the files written."""
    converted = []
    for root, _, _ in os.walk(log_dir):
        if not os.path.basename(root).startswith(pattern):
            continue
        src = os.path.join(root, "pytorch_model.bin")
        dst = os.path.join(root, "ip_adapter.bin")
        if not os.path.exists(src) or os.path.exists(dst):
            continue
        out = {"image_proj": {}, "ip_adapter": {}, "composed_adapter": {}}
        for k, v in flatten_nested(torch_zip.load(src)).items():
            for group, head in (("image_proj", "image_proj_model."),
                                ("ip_adapter", "adapter_modules."),
                                ("composed_adapter", "composed_modules.")):
                if k.startswith(head):
                    out[group][k[len(head):]] = v
        if any(out.values()):
            torch.save(out, dst)
            converted.append(dst)
    return converted


# ---------------------------------------------------------------------------
# Pipeline assembly from a diffusers tree
# ---------------------------------------------------------------------------


def detect_family(model_dir) -> str:
    """"sdxl", "sdxl_refiner" or "sd15": ``model_index.json``'s
    ``_class_name`` where there is one, else whether the tree has a
    ``text_encoder_2`` (SDXL's second tower)."""
    has_te1 = os.path.isdir(os.path.join(model_dir, "text_encoder"))
    has_te2 = os.path.isdir(os.path.join(model_dir, "text_encoder_2"))
    idx = os.path.join(model_dir, "model_index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            cls = json.load(f).get("_class_name", "")
        if "XL" in cls:
            # the refiner ships only the bigG tower
            return "sdxl_refiner" if (has_te2 and not has_te1) else "sdxl"
        if "StableDiffusion" in cls:
            return "sd15"
    if has_te2:
        return "sdxl_refiner" if not has_te1 else "sdxl"
    return "sd15"


def seed_ip_weights(flat):
    """Missing ``to_k_ip``/``to_v_ip`` entries as copies of the layer's own
    ``to_k``/``to_v`` (reference train.py:553-560): a plain diffusers UNet
    has no IP weights. Present keys are never overwritten."""
    out = dict(flat)
    for k, v in flat.items():
        for src, dst in (("attn2.to_k.weight", "attn2.to_k_ip.weight"),
                         ("attn2.to_v.weight", "attn2.to_v_ip.weight")):
            if k.endswith(src):
                tgt = k[: -len(src)] + dst
                if tgt not in flat:
                    out[tgt] = v
    return out


def _read_json(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _apply_component_configs(cfgs: comp.ComponentConfigs, model_dir, image_encoder_dir=None):
    """The family's default sub-configs, each replaced by the tree's own
    ``config.json`` where there is one (the UNet keeping the family's IP
    layout). Unlike the JAX package, the image encoder's config.json is read
    too."""
    rep = {}
    d = _read_json(os.path.join(model_dir, "unet", "config.json"))
    if d is not None:
        rep["unet"] = unet.config_from_diffusers(d, ip_layers=cfgs.unet.ip_layers)
    d = _read_json(os.path.join(model_dir, "vae", "config.json"))
    if d is not None:
        rep["vae"] = vae.config_from_diffusers(d)
    d = _read_json(os.path.join(model_dir, "text_encoder", "config.json"))
    if d is not None and cfgs.text_l is not None:
        rep["text_l"] = clip_text.config_from_transformers(d)
    if cfgs.text_g is not None:
        d = _read_json(os.path.join(model_dir, "text_encoder_2", "config.json"))
        if d is not None:
            rep["text_g"] = clip_text.config_from_transformers(d, with_projection=True)
    d = _read_json(os.path.join(image_encoder_dir or os.path.join(model_dir, "image_encoder"),
                                "config.json"))
    if d is not None and cfgs.vision is not None:
        rep["vision"] = clip_vision.config_from_transformers(d)
    return dataclasses.replace(cfgs, **rep) if rep else cfgs


def _parts(cfgs: comp.ComponentConfigs, model_dir, image_encoder_dir=None):
    """(component, its directory, import keywords) of the tree, in load order."""
    parts = [("unet", os.path.join(model_dir, "unet"), {}),
             ("vae", os.path.join(model_dir, "vae"), {})]
    if cfgs.text_l is not None:
        parts.append(("text_encoder", os.path.join(model_dir, "text_encoder"),
                      dict(prefix=hf_import.TEXT_PREFIX)))
    if cfgs.text_g is not None:
        parts.append(("text_encoder_2", os.path.join(model_dir, "text_encoder_2"),
                      dict(prefix=hf_import.TEXT_PREFIX, key_map=hf_import.text_key_map)))
    if cfgs.vision is not None:
        parts.append(("image_encoder",
                      image_encoder_dir or os.path.join(model_dir, "image_encoder"),
                      dict(prefix=hf_import.VISION_PREFIX, key_map=hf_import.vision_key_map)))
    return parts


FAMILY_CONFIGS = {"sdxl": comp.sdxl_configs, "sdxl_refiner": comp.sdxl_refiner_configs,
                  "sd15": comp.sd15_configs}


def controlnet_config(controlnet_dir, base: UNetConfig) -> controlnet.ControlNetConfig:
    """A ControlNet directory's config on ``base`` (a diffusers
    ControlNetModel copies its UNet's encoder; the conditioning embedder's
    widths come from its ``config.json`` where it has them)."""
    kw = {}
    d = _read_json(os.path.join(controlnet_dir, "config.json")) or {}
    if "conditioning_embedding_out_channels" in d:
        kw["conditioning_embedding_channels"] = tuple(d["conditioning_embedding_out_channels"])
    if "conditioning_channels" in d:
        kw["conditioning_channels"] = int(d["conditioning_channels"])
    return controlnet.ControlNetConfig(base=base, **kw)


def load_components(model_dir=None, adapter_ckpt=None, image_encoder_dir=None,
                    controlnet_dir=None, *, cfgs=None, device="cuda",
                    dtype=dtypes.COMPUTE_DTYPE, timings=None):
    """(cfgs, Components, tokenizers) from a diffusers tree, the adapter
    checkpoint and the ControlNet directory if given, and the tree's
    tokenizers. The modules are built on
    the meta device, allocated on ``device`` in ``dtype``, and each
    component's file is read and copied in before the next is read, so the
    host holds one component at a time. Without an adapter ``image_proj``
    and the HA module are zeros and each IP projection is its layer's
    ``to_k``/``to_v``, as in the JAX package. ``cfgs`` overrides the
    detected family's configs; ``timings``, if a dict, gets the seconds of
    each stage (the adapter's read, the modules' allocation, each
    component's read and copy with its bytes, the adapter's copy, the
    tokenizers)."""
    if model_dir is None:
        raise ValueError("no model_dir given; for a checkpoint-free run use "
                         "HarmonyPipeline.random_tiny() or random_full()")
    t = time.perf_counter()
    if cfgs is None:
        cfgs = FAMILY_CONFIGS[detect_family(model_dir)]()
        cfgs = _apply_component_configs(cfgs, model_dir, image_encoder_dir)
    if controlnet_dir and cfgs.controlnet is None:
        cfgs = dataclasses.replace(cfgs, controlnet=controlnet_config(controlnet_dir, cfgs.unet))
    if adapter_ckpt and cfgs.proj_kind == "none":
        raise ValueError("adapter_ckpt does not apply to the refiner family (no image prompt; "
                         "the IP-Adapter conditions the base stage)")
    adapter = load_adapter_checkpoint(adapter_ckpt) if adapter_ckpt else None
    if adapter is not None and adapter[3] is not None and adapter[3] != cfgs.harmony:
        cfgs = dataclasses.replace(cfgs, harmony=adapter[3])

    t = _lap(timings, "adapter_read", t, device)
    with torch.device("meta"):
        comps = comp.Components(cfgs, dtype=dtype)
    comps = comps.to_empty(device=device)
    t = _lap(timings, "modules", t, device)
    parts = _parts(cfgs, model_dir, image_encoder_dir)
    if controlnet_dir:
        parts.append(("controlnet", controlnet_dir, {}))
    for name, path, kw in parts:
        flat = load_sharded_dir(path)
        nbytes = sum(v.numel() * v.element_size() for v in flat.values() if torch.is_tensor(v))
        if name == "unet":
            flat = seed_ip_weights(flat)
        hf_import.import_state(getattr(comps, name), flat, **kw)
        del flat
        t = _lap(timings, name, t, device, bytes=nbytes)
    with torch.no_grad():
        for m in (comps.image_proj, comps.harmony):
            for p in m.parameters() if m is not None else ():
                p.zero_()
    if adapter is not None:
        image_proj_flat, ip_flat, composed_flat, _ = adapter
        hf_import.import_state(comps.image_proj, image_proj_flat)
        apply_adapter_state(comps.unet, cfgs.unet, ip_flat)
        if composed_flat and comps.harmony is not None:
            import_harmony(comps.harmony, composed_flat)
    t = _lap(timings, "adapter_apply", t, device)

    if cfgs.family == "sdxl_refiner":
        # the refiner ships tokenizer_2 alone; both streams see it (the
        # second alone reaches bigG)
        t2 = tok_lib.CLIPTokenizer.from_pretrained_dir(os.path.join(model_dir, "tokenizer_2"),
                                                      pad_token="!")
        tokenizers = tok_lib.SDXLTokenizers(t2, t2)
    elif cfgs.text_g is not None:
        tokenizers = tok_lib.SDXLTokenizers.from_pretrained_dir(model_dir)
    else:
        # SD1.5: one tokenizer, which the dual front end sees twice
        t1 = tok_lib.CLIPTokenizer.from_pretrained_dir(os.path.join(model_dir, "tokenizer"))
        tokenizers = tok_lib.SDXLTokenizers(t1, t1)
    _lap(timings, "tokenizers", t, device)
    return cfgs, comps, tokenizers


def _lap(timings, name, t0, device, **extra):
    """Record the seconds since ``t0`` (the device synchronized) under
    ``name`` in ``timings``, if it is a dict; returns the time now."""
    if timings is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    if timings is not None:
        timings[name] = {"s": now - t0, **extra}
    return now


def load_pipeline(model_dir=None, adapter_ckpt=None, image_encoder_dir=None,
                  controlnet_dir=None, *, cfgs=None, device="cuda",
                  dtype=dtypes.COMPUTE_DTYPE, timings=None):
    """A HarmonyPipeline from a diffusers SDXL, SDXL-refiner or SD1.5 tree,
    the 3-dict adapter checkpoint, a diffusers ControlNetModel directory and
    the tree's tokenizers (reference test.py:66-104); the family comes from
    ``model_index.json`` (``detect_family``). See ``load_components`` for
    the arguments."""
    from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline

    _, comps, tokenizers = load_components(model_dir, adapter_ckpt, image_encoder_dir,
                                           controlnet_dir, cfgs=cfgs, device=device,
                                           dtype=dtype, timings=timings)
    t = time.perf_counter()
    pipe = HarmonyPipeline._build(comps, tokenizers)
    _lap(timings, "pack", t, device)
    return pipe


def save_tree(root, comps: comp.Components, *, tokenizers=None) -> int:
    """Write ``comps`` as a diffusers tree: ``model_index.json``, per
    component its ``config.json`` and one ``.safetensors`` in the modules'
    dtype, and the tokenizers' files if given. The UNet is written without
    its IP projections, as diffusers writes one.
    ``comps`` must be unpacked (not through ``pack_inference_params``).
    Returns the bytes of the weight files."""
    cfgs = comps.cfgs
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"_class_name": {"sdxl": "StableDiffusionXLPipeline",
                                   "sdxl_refiner": "StableDiffusionXLImg2ImgPipeline",
                                   "sd15": "StableDiffusionPipeline"}[cfgs.family]}, f)
    configs = {"unet": unet.config_to_diffusers(cfgs.unet),
               "vae": vae.config_to_diffusers(cfgs.vae),
               "text_encoder": cfgs.text_l and clip_text.config_to_transformers(cfgs.text_l),
               "text_encoder_2": cfgs.text_g and clip_text.config_to_transformers(cfgs.text_g),
               "image_encoder": cfgs.vision and clip_vision.config_to_transformers(cfgs.vision)}
    written = 0
    for name, path, kw in _parts(cfgs, root):
        flat = hf_import.export_state(getattr(comps, name), **kw)
        if any(".to_qkv." in k or ".to_kv." in k for k in flat):
            raise ValueError("save_tree needs unpacked modules (to_q/to_k/to_v)")
        if name == "unet":
            flat = {k: v for k, v in flat.items() if "_ip." not in k}
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(configs[name], f, indent=1)
        fname = "diffusion_pytorch_model" if name in ("unet", "vae") else "model"
        written += safetensors.save(os.path.join(path, f"{fname}.safetensors"), flat)
    if tokenizers is not None:
        if cfgs.text_l is not None:
            tokenizers.tok1.save_pretrained_dir(os.path.join(root, "tokenizer"))
        if cfgs.text_g is not None:
            tokenizers.tok2.save_pretrained_dir(os.path.join(root, "tokenizer_2"))
    return written


def save_controlnet(path, module: nn.Module) -> int:
    """Write a ControlNetModel as a diffusers ControlNet directory: its
    ``config.json`` (the trunk's UNet config and the embedder's widths) and
    one ``.safetensors``. ``module`` must be unpacked. Returns the bytes
    written."""
    cfg = module.cn_cfg
    os.makedirs(path, exist_ok=True)
    d = dict(unet.config_to_diffusers(cfg.base), _class_name="ControlNetModel",
             conditioning_channels=cfg.conditioning_channels,
             conditioning_embedding_out_channels=list(cfg.conditioning_embedding_channels))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f, indent=1)
    flat = hf_import.export_state(module)
    if any(".to_qkv." in k or ".to_kv." in k for k in flat):
        raise ValueError("save_controlnet needs an unpacked module (to_q/to_k/to_v)")
    return safetensors.save(os.path.join(path, "diffusion_pytorch_model.safetensors"), flat)

