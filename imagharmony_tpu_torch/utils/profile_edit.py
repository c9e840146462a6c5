"""Where the time of one denoise step of the edit goes, on the card.

    python imagharmony_tpu_torch/utils/profile_edit.py [--family sdxl|sd15] [--steps N]

Builds the full-size pipeline of the family (random bf16 weights, seed 0:
SDXL at 1024², SD1.5 at 512²; CFG 5.0, one sample), runs one warm-up
``generate()``, then profiles ``generate()`` at 2 and at 2 + N Euler steps
under torch.profiler. The difference of the two, over N, is one denoise
step: one CFG-pair UNet call and its Euler update. It prints one JSON line:
kernels, kernel ms, device-busy ms and wall ms per step (wall with the
profiler on), the idle share 1 - busy / wall, and kernel ms per class of
``utils/profiling.KERNEL_CLASSES``.

It calls only ``HarmonyPipeline.random_full`` / ``random_full_sd15``,
``generate()`` and ``utils/profiling``, which every slice of the port has,
so it profiles another checkout of the package as well: put that checkout
first on PYTHONPATH and run this file by its path. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline
from imagharmony_tpu_torch.utils import profiling

BASE_STEPS = 2


def _profile(pipe, img, kw, steps):
    _, wall_ms, kernels = profiling.profiled(
        lambda: pipe.generate(img, num_inference_steps=steps, **kw))
    return profiling.summarize(kernels, 1, wall_ms)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("sdxl", "sd15"), default="sdxl")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_edit needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(prompt="a photo of six sheep on a meadow", num_samples=1, seed=0,
              guidance_scale=5.0, output_type="raw")
    if args.family == "sdxl":
        pipe = HarmonyPipeline.random_full(seed=0, device="cuda", dtype=torch.bfloat16)
        size, kw["extra_text"] = 1024, "six sheep"
    else:
        pipe = HarmonyPipeline.random_full_sd15(seed=0, device="cuda", dtype=torch.bfloat16)
        size = 512
        kw.update(height=512, width=512)
    img = np.random.default_rng(0).integers(0, 255, (size, size, 3), dtype=np.uint8)
    pipe.generate(img, num_inference_steps=BASE_STEPS, **kw)  # cuDNN/cuBLAS set-up
    a = _profile(pipe, img, kw, BASE_STEPS)
    b = _profile(pipe, img, kw, BASE_STEPS + args.steps)
    per = {key: (b[key + "_per_step"] - a[key + "_per_step"]) / args.steps
           for key in ("wall_ms", "kernel_ms", "device_busy_ms", "kernels")}
    classes = set(a["class_ms_per_step"]) | set(b["class_ms_per_step"])
    by_class = {c: (b["class_ms_per_step"].get(c, 0.0) - a["class_ms_per_step"].get(c, 0.0))
                / args.steps for c in classes}
    out = {
        "family": args.family,
        "package": profiling.__file__,
        "device": torch.cuda.get_device_name(0),
        "steps": [BASE_STEPS, BASE_STEPS + args.steps],
        **{f"{key}_per_unet_call": v for key, v in per.items()},
        "idle_share": 1.0 - per["device_busy_ms"] / per["wall_ms"],
        "class_ms_per_unet_call": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
