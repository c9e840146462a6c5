"""Where the time of full-width adapter-training steps goes, on the card.

    python -m imagharmony_tpu_torch.utils.profiling

Builds the trainer's ``--full_random`` bundle at the trainer's defaults
(SDXL-base widths, 512², batch 1, bf16, gradient checkpointing, seed 0),
runs ``WARMUP_STEPS`` train steps (the first ones pay cuDNN/cuBLAS set-up),
then ``PROFILED_STEPS`` more under torch.profiler.
It prints one JSON line: wall ms per step (host clock around synchronized
steps, profiler on), device kernel ms per step, the device idle share
(1 - the union of kernel intervals / the wall window), kernels per step and
the kernel ms per step of each class in ``KERNEL_CLASSES``. The kernel
times come from the profiler's chrome trace (events of category
``kernel``). Needs a CUDA card; fails without one.

``kernel_ms`` times any callable the same way, and ``event_ms`` by its
CUDA-event median; ``chip_smoke.py`` and the probe tools (``probes/``) use
them to hold a kernel, its plain version and the library call against
each other.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time

import torch

WARMUP_STEPS = 3
PROFILED_STEPS = 2

# the kernels of flash_attn_nhd_bwd.cu, in launch order
K3_KERNELS = ("attn_bwd_prep_kernel", "attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel")

# first match wins; names are lowercased
KERNEL_CLASSES = (
    ("K1/K4", ("attn_fwd_wgmma_kernel",)),  # one device kernel under both entry points
    ("K2", ("cross_attn_wgmma_kernel",)),
    ("K3", K3_KERNELS),  # under both of its entry points
    ("K5", ("geglu_wgmma_kernel",)),  # ahead of "gemm": the GEGLU projection and its epilogue
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "nhwc", "nchw", "cudnn")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("optimizer", ("multi_tensor", "adam")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce", "norm")),
    ("copy/cast", ("copy", "cat", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise",)),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def kernel_events(trace_path):
    """The kernel events (category ``kernel``, with a duration) of a chrome
    trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e]


def profiled(fn):
    """Runs ``fn`` under torch.profiler, the card synchronized at its end.
    Returns its result, the host ms of the run and its kernel events."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000.0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return out, wall_ms, kernel_events(path)


def event_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of ``fn`` in milliseconds, after ``warmup``
    calls; unlike ``kernel_ms`` it holds the host's launch work."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def kernel_ms(fn, names=(), reps=5, tries=6):
    """Device ms per call of ``fn``, the mean of ``reps`` profiled calls
    after one unprofiled: under "total" all the kernels it launches, under
    each of ``names`` those whose name holds it. Unlike CUDA-event times
    these leave out the host's launch work.

    The profiler now and then loses kernel events: a session's trace comes
    back short or empty. So sessions run until two in a row hold the same
    number of kernel events, a multiple of ``reps``; after ``tries``
    sessions with no such pair every value is None."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    prev = None
    for _ in range(tries):
        _, _, kernels = profiled(run)
        if kernels and len(kernels) % reps == 0 and prev == len(kernels):
            break
        prev = len(kernels)
    else:
        kernels = []
    us = {n: sum(e["dur"] for e in kernels if n in e["name"]) for n in names}
    us["total"] = sum(e["dur"] for e in kernels)
    return {n: (t / 1000.0 / reps or None) for n, t in us.items()}


def summarize(kernels, n_steps, wall_ms):
    """Per-step numbers of ``n_steps`` steps whose kernel events are
    ``kernels`` and whose host time per step is ``wall_ms``."""
    by_class = {}
    for e in kernels:
        cls = kernel_class(e["name"])
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"] / 1000.0 / n_steps
    busy_ms = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels]) / 1000.0 / n_steps
    return {
        "wall_ms_per_step": wall_ms,
        "kernel_ms_per_step": sum(by_class.values()),
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "kernels_per_step": len(kernels) / n_steps,
        "class_ms_per_step": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
    }


def main():
    from imagharmony_tpu_torch.train import step as step_lib
    from imagharmony_tpu_torch.train import trainer

    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    args = trainer.parse_args(["--full_random"])
    cfgs, comps, _ = trainer.build_components(args)
    tcfg = step_lib.TrainConfig(unet_cfg=cfgs.unet)
    state = step_lib.init_state(comps, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = step_lib.to_device(step_lib.dummy_batch(cfgs, 1, args.resolution), "cuda")

    def run(n):
        for _ in range(n):
            m = step_lib.train_step(state, comps, cfgs, tcfg, batch, gen, args.resolution)
        torch.cuda.synchronize()
        return m

    run(WARMUP_STEPS)
    m, wall_ms, kernels = profiled(lambda: run(PROFILED_STEPS))
    out = summarize(kernels, PROFILED_STEPS, wall_ms / PROFILED_STEPS)
    out.update(loss=float(m["loss"]), device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
