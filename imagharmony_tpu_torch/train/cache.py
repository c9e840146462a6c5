"""Encoder-output caching for adapter training (port of
imagharmony_tpu/train/cache.py).

The trainable surface never feeds back into the frozen encoders, so their
outputs are computed once (``precompute``) and the towers leave the device
(``drop_towers``):

* the VAE posterior moments (mean, logvar) of each record, fp32: the step
  still draws a fresh latent sample from them at every visit;
* both towers' context and pooled embeddings of ``text``, and of the empty
  prompt (CFG text dropout becomes a swap to that row);
* the context of ``extra_text`` (never dropped);
* the projected CLIP image embedding (image dropout is a zeroing).

The cache is numpy, fp32, in the JAX layout, and ``batches_from_cache`` is
the JAX package's numpy code with its draw order, so its batches are the
JAX package's bit for bit. Random crops would invalidate the cached VAE
moments, so ``precompute`` requires ``center_crop``.
"""

from __future__ import annotations

import numpy as np
import torch

from imagharmony_tpu_torch.models import clip_text
from imagharmony_tpu_torch.train import step as step_lib

TOWERS = ("vae", "text_encoder", "text_encoder_2", "image_encoder")


def _host(x) -> np.ndarray:
    return x.float().cpu().numpy()


@torch.no_grad()
def precompute(comps, cfgs, dataset, *, batch_size=8, mesh=None):
    """-> dict of numpy arrays stacked over every record of ``dataset`` (a
    ``HarmonyDataset`` with ``center_crop``), in batches of ``batch_size``
    on the towers' device, plus the empty prompt's row. Dropout is off
    while caching: the dataset's three rates are set to 0 for each batch
    and restored. Over a ``parallel/mesh.py`` mesh each rank of the data
    group encodes one contiguous share of the records (the last record
    repeated to make the shares equal, so FSDP's gathers pair up), and the
    shares are all-gathered: every rank holds the whole cache."""
    if not dataset.center_crop:
        raise ValueError("the encoder cache requires center_crop")
    device = comps.unet.conv_in.weight.device
    rng = np.random.default_rng(0)
    max_pos = cfgs.text_l.max_position_embeddings
    rows = {k: [] for k in (
        "latent_mean", "latent_logvar", "context", "pooled", "extra_context",
        "image_embeds", "original_size", "crop_coords", "target_size",
    )}
    n = len(dataset)
    records = list(range(n))
    size = 1 if mesh is None or mesh.data_group is None else mesh.data_size
    if size > 1:
        per = -(-n // size)
        records = [min(mesh.data_pos * per + i, n - 1) for i in range(per)]
    for start in range(0, len(records), batch_size):
        idx = records[start:start + batch_size]
        saved = (dataset.i_drop_rate, dataset.t_drop_rate, dataset.ti_drop_rate)
        dataset.i_drop_rate = dataset.t_drop_rate = dataset.ti_drop_rate = 0.0
        try:
            batch = dataset.make_batch(idx, rng)
        finally:
            dataset.i_drop_rate, dataset.t_drop_rate, dataset.ti_drop_rate = saved
        b = step_lib.to_device({k: v for k, v in batch.items() if k != "drop_image"}, device)
        mean, logvar = comps.vae.encode_moments(b["images"].permute(0, 3, 1, 2))
        ctx, pooled = clip_text.encode_for_sdxl(
            comps.text_encoder, comps.text_encoder_2, b["ids_l"][:, :max_pos],
            b["ids_g"][:, :max_pos])
        extra_ctx, _ = clip_text.encode_for_sdxl(
            comps.text_encoder, comps.text_encoder_2, b["extra_l"][:, :max_pos],
            b["extra_g"][:, :max_pos])
        img = comps.image_encoder(b["clip_pixels"])["projected"]
        rows["latent_mean"].append(_host(mean.permute(0, 2, 3, 1)))
        rows["latent_logvar"].append(_host(logvar.permute(0, 2, 3, 1)))
        rows["context"].append(_host(ctx))
        rows["pooled"].append(_host(pooled))
        rows["extra_context"].append(_host(extra_ctx))
        rows["image_embeds"].append(_host(img))
        for k in ("original_size", "crop_coords", "target_size"):
            rows[k].append(batch[k])
    cache = {k: np.concatenate(v) for k, v in rows.items()}
    if size > 1:
        cache = {k: _gather_shares(v, n, mesh, device) for k, v in cache.items()}

    # the empty prompt's row, for CFG text dropout
    el, eg = dataset.tokenizers("")
    ids = step_lib.to_device({"l": el[:, :max_pos], "g": eg[:, :max_pos]}, device)
    ectx, epooled = clip_text.encode_for_sdxl(comps.text_encoder, comps.text_encoder_2,
                                              ids["l"], ids["g"])
    cache["empty_context"] = _host(ectx)
    cache["empty_pooled"] = _host(epooled)
    return cache


def _gather_shares(x: np.ndarray, n: int, mesh, device) -> np.ndarray:
    """The first ``n`` rows of every data rank's share ``x``, in rank order."""
    local = torch.as_tensor(x).to(device)
    out = local.new_empty((mesh.data_size * local.shape[0],) + tuple(local.shape[1:]))
    torch.distributed.all_gather_into_tensor(out, local, group=mesh.data_group)
    return out[:n].cpu().numpy()


def tower_bytes(comps) -> int:
    """Bytes of the parameters and buffers of the four frozen towers."""
    return sum(t.numel() * t.element_size() for name in TOWERS
               if getattr(comps, name, None) is not None
               for t in [*getattr(comps, name).parameters(), *getattr(comps, name).buffers()])


def drop_towers(comps) -> int:
    """Removes the VAE, both text towers and the image encoder from
    ``comps`` (each set to None), so that their memory is released once
    nothing else holds them; returns their bytes (``tower_bytes``)."""
    freed = tower_bytes(comps)
    for name in TOWERS:
        setattr(comps, name, None)
    return freed


def batches_from_cache(cache, batch_size, *, seed=0, epochs=None, i_drop_rate=0.05,
                       t_drop_rate=0.05, ti_drop_rate=0.05, drop_remainder=True):
    """Yields train-step batches (numpy, the cached schema plus
    ``drop_image``) with CFG condition dropout as cached-row swaps and
    zeroing, at the live dataset's probabilities."""
    rng = np.random.default_rng(seed)
    n = cache["latent_mean"].shape[0]
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n)
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size and drop_remainder:
                continue
            b = {k: cache[k][idx] for k in (
                "latent_mean", "latent_logvar", "context", "pooled",
                "extra_context", "image_embeds", "original_size",
                "crop_coords", "target_size")}
            drop_image = np.zeros(len(idx), np.float32)
            for i in range(len(idx)):
                r = rng.random()
                if r < i_drop_rate:
                    drop_image[i] = 1.0
                elif r < i_drop_rate + t_drop_rate:
                    b["context"][i] = cache["empty_context"][0]
                    b["pooled"][i] = cache["empty_pooled"][0]
                elif r < i_drop_rate + t_drop_rate + ti_drop_rate:
                    b["context"][i] = cache["empty_context"][0]
                    b["pooled"][i] = cache["empty_pooled"][0]
                    drop_image[i] = 1.0
            b["drop_image"] = drop_image
            yield b
        epoch += 1
