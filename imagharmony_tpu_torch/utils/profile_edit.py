"""Where the time of one denoise step of the edit goes, on the card, run
eagerly and as the captured programs that generate() replays.

    PYTHONPATH=. python imagharmony_tpu_torch/utils/profile_edit.py [--family sdxl|sd15] [--steps N]

Builds the full-size pipeline of the family (random bf16 weights, seed 0:
SDXL at 1024², SD1.5 at 512²; CFG 5.0, one sample), runs one warm-up call
of each mode, then profiles each mode at 2 and at 2 + N Euler steps under
torch.profiler: "eager", the module functions (``harmony_edit.edit``), and
"replayed", ``generate()``, whose programs the warm-up captured. The
difference of the two, over N, is one denoise step: one CFG-pair UNet call
and its Euler update. It prints one JSON line with a row per mode:
kernels, kernel ms, device-busy ms and wall ms per step (wall with the
profiler on), the idle share 1 - busy / wall, kernel ms per class of
``utils/profiling.KERNEL_CLASSES``, and the elementwise class split by the
operation each kernel runs (``elementwise_op``: PyTorch's functor or kernel
function in the kernel's name, e.g. ``GeluCUDAKernelImpl``, ``MulFunctor``),
so the GEGLU epilogue's gelu and multiply show apart.

It calls only ``HarmonyPipeline.random_full`` / ``random_full_sd15``,
``prepare()``, ``generate()``, ``harmony_edit.edit`` and
``utils/profiling``, so it profiles another checkout of the package that
has them as well: put that checkout first on PYTHONPATH instead of the
root of this one and run this file by its path. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np
import torch

from imagharmony_tpu_torch.pipelines import harmony_edit
from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline
from imagharmony_tpu_torch.utils import profiling

BASE_STEPS = 2

# template and wrapper names of PyTorch's elementwise kernels that say
# nothing of the operation
_WRAPPERS = {"vectorized_elementwise_kernel", "unrolled_elementwise_kernel", "elementwise_kernel",
             "elementwise_kernel_with_index", "BinaryFunctor", "AUnaryFunctor", "BUnaryFunctor",
             "gpu_kernel_impl", "gpu_kernel_impl_nocast", "launch_legacy_kernel"}
_OP = re.compile(r"(Functor\w*|Impl|_kernel\w*|_cuda)$")


def elementwise_op(name: str) -> str:
    """The operation of a PyTorch elementwise kernel, from its name: the first
    functor or kernel function in it that is not a generic wrapper; else the
    name up to its argument list."""
    for token in re.findall(r"[A-Za-z_]\w*", name):
        if token not in _WRAPPERS and _OP.search(token):
            return token
    return name.split("(")[0][:80]


def _profile(run, steps):
    _, wall_ms, kernels = profiling.profiled(lambda: run(steps))
    out = profiling.summarize(kernels, 1, wall_ms)
    ops = {}
    for e in kernels:
        if profiling.kernel_class(e["name"]) == "elementwise":
            op = elementwise_op(e["name"])
            ops[op] = ops.get(op, 0.0) + e["dur"] / 1000.0
    out["elementwise_ms"] = ops
    return out


def per_step(run, steps=4):
    """One denoise step of ``run(num_steps)`` (an edit, the card synchronized
    at its end): the difference of profiled runs at BASE_STEPS + ``steps``
    and BASE_STEPS steps, over ``steps``, after one profiled run that is
    dropped (the first profiled run of a mode has come out longer than the
    longer run, which made the difference negative). Warm ``run`` up
    first."""
    _profile(run, BASE_STEPS)
    a = _profile(run, BASE_STEPS)
    b = _profile(run, BASE_STEPS + steps)
    per = {key: (b[key + "_per_step"] - a[key + "_per_step"]) / steps
           for key in ("wall_ms", "kernel_ms", "device_busy_ms", "kernels")}
    classes = set(a["class_ms_per_step"]) | set(b["class_ms_per_step"])
    by_class = {c: (b["class_ms_per_step"].get(c, 0.0) - a["class_ms_per_step"].get(c, 0.0))
                / steps for c in classes}
    ops = set(a["elementwise_ms"]) | set(b["elementwise_ms"])
    by_op = {op: (b["elementwise_ms"].get(op, 0.0) - a["elementwise_ms"].get(op, 0.0))
             / steps for op in ops}
    return {
        **{f"{key}_per_unet_call": v for key, v in per.items()},
        "idle_share": 1.0 - per["device_busy_ms"] / per["wall_ms"],
        "class_ms_per_unet_call": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "elementwise_ms_per_unet_call": dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
    }


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
              guidance_scale=5.0)
    if args.family == "sdxl":
        pipe = HarmonyPipeline.random_full(seed=0, device="cuda", dtype=torch.bfloat16)
        size, kw["extra_text"] = 1024, "six sheep"
    else:
        pipe = HarmonyPipeline.random_full_sd15(seed=0, device="cuda", dtype=torch.bfloat16)
        size = 512
        kw.update(height=512, width=512)
    img = np.random.default_rng(0).integers(0, 255, (size, size, 3), dtype=np.uint8)

    def replayed(n):
        pipe.generate(img, num_inference_steps=n, output_type="raw", **kw)
        torch.cuda.synchronize()

    @torch.inference_mode()
    def eager(n):
        harmony_edit.edit(pipe.components, pipe.prepare(img, num_inference_steps=n, **kw))
        torch.cuda.synchronize()

    rows = {}
    for name, run in {"eager": eager, "replayed": replayed}.items():
        run(BASE_STEPS)  # cuDNN/cuBLAS set-up; the programs' capture
        rows[name] = per_step(run, args.steps)
    out = {
        "family": args.family,
        "package": profiling.__file__,
        "device": torch.cuda.get_device_name(0),
        "steps": [BASE_STEPS, BASE_STEPS + args.steps],
        **rows,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
