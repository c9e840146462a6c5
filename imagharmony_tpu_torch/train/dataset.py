"""Training dataset: JSON-driven QL-Edit records -> numpy batches (port of
imagharmony_tpu/train/dataset.py).

Records ``{image_file, text, extra_text}`` under an image root (reference
train.py:39-184). Per sample:

* resize the shortest edge to ``size`` (bilinear) and crop, center or
  random, with the SDXL micro-conditioning triplet (original_size,
  crop_coords, target_size; reference train.py:73-91);
* pixels normalized to [-1, 1] for the VAE, a CLIP-preprocessed copy for
  the vision tower;
* CFG condition dropout: 5% image / 5% text / 5% both; extra_text is never
  dropped (reference train.py:96-104);
* both tokenizers on text and extra_text.

Host side only; a background thread keeps ``prefetch`` batches ready. The
resize, crop and normalize is the C++ code of ``native.batch_preprocess``,
as in the JAX package (which falls back to PIL only without a compiler;
the port raises instead).
"""

from __future__ import annotations

import json
import os
import queue
import threading

import numpy as np
from PIL import Image

from imagharmony_tpu_torch import native
from imagharmony_tpu_torch.models import clip_vision


class HarmonyDataset:
    def __init__(self, json_file, tokenizers, *, size=1024, clip_image_size=224,
                 center_crop=True, max_token_length=None, i_drop_rate=0.05,
                 t_drop_rate=0.05, ti_drop_rate=0.05, image_root_path=""):
        with open(json_file) as f:
            self.records = json.load(f)
        self.tokenizers = tokenizers
        self.size = size
        self.clip_image_size = clip_image_size
        self.max_token_length = max_token_length
        self.center_crop = center_crop
        self.i_drop_rate = i_drop_rate
        self.t_drop_rate = t_drop_rate
        self.ti_drop_rate = ti_drop_rate
        self.image_root_path = image_root_path

    def __len__(self):
        return len(self.records)

    def load_sample(self, idx, rng: np.random.Generator):
        rec = self.records[idx]
        text = rec["text"]
        extra = rec.get("extra_text", "")
        img = Image.open(os.path.join(self.image_root_path, rec["image_file"])).convert("RGB")
        ow, oh = img.size

        short = min(ow, oh)
        nw, nh = round(ow * self.size / short), round(oh * self.size / short)
        dh, dw = nh - self.size, nw - self.size
        if self.center_crop:
            top, left = dh // 2, dw // 2
        else:
            top = int(rng.integers(0, dh + 1)) if dh > 0 else 0
            left = int(rng.integers(0, dw + 1)) if dw > 0 else 0
        pixels = native.batch_preprocess(
            [np.asarray(img, np.uint8)], self.size, tops=[top], lefts=[left],
            mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))[0]
        clip_pixels = clip_vision.preprocess_numpy(img, image_size=self.clip_image_size)[0]

        drop_image = 0.0
        r = rng.random()
        if r < self.i_drop_rate:
            drop_image = 1.0
        elif r < self.i_drop_rate + self.t_drop_rate:
            text = ""
        elif r < self.i_drop_rate + self.t_drop_rate + self.ti_drop_rate:
            text = ""
            drop_image = 1.0

        ids_l, ids_g = self.tokenizers(text)
        extra_l, extra_g = self.tokenizers(extra)
        if self.max_token_length:
            m = self.max_token_length
            ids_l, ids_g = ids_l[:, :m], ids_g[:, :m]
            extra_l, extra_g = extra_l[:, :m], extra_g[:, :m]
        return {
            "pixels": pixels,
            "clip_pixels": clip_pixels,
            "ids_l": ids_l[0],
            "ids_g": ids_g[0],
            "extra_l": extra_l[0],
            "extra_g": extra_g[0],
            "drop_image": np.float32(drop_image),
            "original_size": np.array([oh, ow], np.float32),
            "crop_coords": np.array([top, left], np.float32),
            "target_size": np.array([self.size, self.size], np.float32),
        }

    def make_batch(self, indices, rng):
        samples = [self.load_sample(i, rng) for i in indices]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        batch["images"] = batch.pop("pixels")
        return batch

    def batches(self, batch_size, *, seed=0, epochs=None, drop_remainder=True, prefetch=2):
        """Shuffled epoch iterator with a prefetch thread."""

        def producer(q):
            rng = np.random.default_rng(seed)
            epoch = 0
            while epochs is None or epoch < epochs:
                order = rng.permutation(len(self.records))
                for start in range(0, len(order), batch_size):
                    idx = order[start:start + batch_size]
                    if len(idx) < batch_size and drop_remainder:
                        continue
                    q.put(self.make_batch(idx, rng))
                epoch += 1
            q.put(None)

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        t = threading.Thread(target=producer, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item
