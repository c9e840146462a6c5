"""Where the time of full-width adapter-training steps goes, on the card,
run eagerly and as the captured program that the trainer replays.

    python -m imagharmony_tpu_torch.utils.profiling

Builds the trainer's ``--full_random`` bundle at the trainer's defaults
(SDXL-base widths, 512², batch 1, bf16, gradient checkpointing, seed 0).
For each mode, "eager" (``step.train_step`` called directly) and then
"replayed" (``train/programs.run``, whose first step captures), it runs
``WARMUP_STEPS`` train steps (the first ones pay cuDNN/cuBLAS set-up, or
the capture), then ``PROFILED_STEPS`` more under torch.profiler, again
until two such sessions in a row hold as many kernel events
(``profiled_agreeing``).
It prints one JSON line with a row per mode: wall ms per step (host clock
around synchronized steps, profiler on), device kernel ms per step, the
device idle share (1 - the union of kernel intervals / the wall window),
kernels per step and the kernel ms per step of each class in
``KERNEL_CLASSES``, the idle stretches between kernels (``summarize``),
the host ms of a step call that returns before the card finishes (the
median of ``PROFILED_STEPS`` unprofiled, synchronized calls: for the
replayed mode the batch copy, the draws and the graph's launch), the wall
ms per step of ``PROFILED_STEPS`` unprofiled steps in a row and the idle
share it gives with the profiled busy time (the profiler slows the host's
launch of a large graph several times over), and the peak memory
allocated over the mode (its capture included). The kernel
times come from the profiler's chrome trace (events of category
``kernel``). Needs a CUDA card; fails without one.

``kernel_ms`` times any callable the same way, and ``event_ms`` by its
CUDA-event median; ``chip_smoke.py`` and the probe tools (``probes/``) use
them to hold a kernel, its plain version and the library call against
each other.

The JAX package's helpers (imagharmony_tpu/utils/profiling.py), on either
device::

    with profiling.trace("/tmp/torch-trace"):   # a Chrome/Perfetto trace JSON
        with profiling.annotate("denoise"):
            pipe.generate(...)

    stats = profiling.compiled_stats(fn, *args)  # flops / bytes / peak memory

    timer = profiling.StepTimer()
    loss = step(); timer.lap(sync_on=loss)       # seconds, the card synchronized
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import tempfile
import time

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

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
    """Runs ``fn`` under ``trace``, the card synchronized at its end.
    Returns its result, the host ms of the run and its kernel events."""
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000.0
        [name] = os.listdir(tmp)
        return out, wall_ms, kernel_events(os.path.join(tmp, name))


def profiled_agreeing(fn, tries=8):
    """``profiled(fn)`` until two sessions in a row hold as many kernel
    events, none of them zero (the profiler now and then loses some).
    Returns the second of the two, or None after ``tries`` sessions, and
    the event counts of the sessions run."""
    counts = []
    for _ in range(tries):
        out = profiled(fn)
        counts.append(len(out[2]))
        if len(counts) > 1 and counts[-1] and counts[-1] == counts[-2]:
            return out, counts
    return None, counts


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


def _gaps_us(intervals):
    """The idle stretches between the first start and the last end of
    (start, end) intervals."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append(s - end)
        end = e if end is None else max(end, e)
    return gaps


def summarize(kernels, n_steps, wall_ms):
    """Per-step numbers of ``n_steps`` steps whose kernel events are
    ``kernels`` and whose host time per step is ``wall_ms``; the idle
    between kernels also as its largest stretch and the sum of the
    stretches over 20 us (the rest is many short ones, or lies outside the
    kernels' span)."""
    by_class = {}
    for e in kernels:
        cls = kernel_class(e["name"])
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"] / 1000.0 / n_steps
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in kernels]
    busy_ms = _busy_us(intervals) / 1000.0 / n_steps
    gaps = _gaps_us(intervals)
    return {
        "wall_ms_per_step": wall_ms,
        "kernel_ms_per_step": sum(by_class.values()),
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "largest_gap_ms": max(gaps, default=0.0) / 1000.0,
        "gaps_over_20us_ms_per_step": sum(g for g in gaps if g > 20) / 1000.0 / n_steps,
        "kernels_per_step": len(kernels) / n_steps,
        "class_ms_per_step": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
    }


@contextlib.contextmanager
def trace(log_dir):
    """Profiles the block (CPU activity, and CUDA activity where a card is
    present, the card synchronized at the block's end) and writes its
    Chrome/Perfetto trace JSON, ``trace-<pid>-<ns>.json``, into ``log_dir``.
    Yields the ``torch.profiler.profile``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(str(log_dir), f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name):
    """A named span in ``trace``'s timeline (``record_function``)."""
    return torch.profiler.record_function(name)


# ops that read and write no tensor data: allocations
_NO_ACCESS = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
              torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def _nbytes(tree):
    return sum(x.numel() * x.element_size() for x in _pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


class _BytesAccessed(TorchDispatchMode):
    """Sums each dispatched op's operand and result bytes, as XLA's cost
    analysis counts "bytes accessed" per op; views (an aliasing, read-only
    result) and allocations move no data and add nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        if not view and func.overloadpacket not in _NO_ACCESS:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def _cuda_tensors(tree):
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor) and x.device.type == "cuda"]


def compiled_stats(fn, *args, **kwargs):
    """Runs ``fn(*args, **kwargs)`` once, eagerly, and reports what it
    costs: {"flops", "bytes_accessed", "peak_temp_bytes"}, the counterpart
    of the JAX package's cost analysis of the compiled ``fn``.

    flops: ``FlopCounterMode``'s count of the aten ops it runs plus what the
    hand-written kernels it launches declare (``kernels/cost.py``, the JAX
    ``pl.CostEstimate`` formulas; ctypes launches are invisible to aten),
    a backward's included, which autograd runs on threads of its own.
    bytes_accessed: each dispatched op's operand and result bytes, views
    and allocations left out, plus the kernels' declared bytes.
    peak_temp_bytes: the CUDA allocator's peak over the call less what was
    allocated before it, on the device of the first CUDA tensor among the
    arguments; None when no argument is on a card.

    Only what runs eagerly is counted: replaying a captured program (a
    ``generate()`` on a card after its key's first call, a trainer's
    captured step) runs no Python and dispatches no op, so count an eager
    call (a UNet call, ``harmony_edit.edit``, ``step.train_step``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from imagharmony_tpu_torch.kernels import cost

    cuda = _cuda_tensors((args, kwargs))
    dev = cuda[0].device if cuda else None
    if dev is not None:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    flop_mode, byte_mode = FlopCounterMode(display=False), _BytesAccessed()
    with flop_mode, byte_mode, cost.counting() as declared:
        fn(*args, **kwargs)
    peak = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - before
    return {"flops": flop_mode.get_total_flops() + declared.flops,
            "bytes_accessed": byte_mode.bytes + declared.bytes_accessed,
            "peak_temp_bytes": peak}


class StepTimer:
    """Rolling step timer for train loops: ``lap`` reads the host clock
    after the card has finished the work of ``sync_on``."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.history = []

    def lap(self, sync_on=None):
        """Seconds since the last lap (or the timer's start). ``sync_on``: a
        tensor, or a tuple, list or dict of them; the devices of its CUDA
        tensors are synchronized before the clock is read."""
        for dev in {x.device for x in _cuda_tensors(sync_on)}:
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        self.history.append(dt)
        return dt

    @property
    def mean(self):
        return sum(self.history) / max(len(self.history), 1)


def main():
    from imagharmony_tpu_torch.train import programs
    from imagharmony_tpu_torch.train import step as step_lib
    from imagharmony_tpu_torch.train import trainer

    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    args = trainer.parse_args(["--full_random"])
    cfgs, comps, _ = trainer.build_components(args)
    tcfg = trainer.train_config(args, cfgs)
    state = step_lib.init_state(comps, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = step_lib.to_device(step_lib.dummy_batch(cfgs, 1, args.resolution), "cuda")
    progs = {}
    steps = {
        "eager": lambda: step_lib.train_step(
            state, comps, tcfg, batch, step_lib.step_draws(gen, cfgs, tcfg, 1, args.resolution)),
        "replayed": lambda: programs.run(progs, state, comps, cfgs, tcfg, batch, gen,
                                         args.resolution),
    }
    out = {"device": torch.cuda.get_device_name(0)}
    for mode, step in steps.items():
        def run(n):
            for _ in range(n):
                m = step()
            torch.cuda.synchronize()
            return m

        torch.cuda.reset_peak_memory_stats()
        run(WARMUP_STEPS)
        host_ms = []
        for _ in range(PROFILED_STEPS):
            t0 = time.perf_counter()
            step()  # returns once the host has enqueued the step
            host_ms.append((time.perf_counter() - t0) * 1000.0)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(PROFILED_STEPS)  # the steps overlap the host's work as in training
        unprofiled_ms = (time.perf_counter() - t0) * 1000.0 / PROFILED_STEPS
        got, counts = profiled_agreeing(lambda: run(PROFILED_STEPS))
        if got is None:
            raise SystemExit(f"{mode}: no two profiler sessions in a row agree on the kernel "
                             f"events: {counts}")
        m, wall_ms, kernels = got
        row = out[mode] = summarize(kernels, PROFILED_STEPS, wall_ms / PROFILED_STEPS)
        row.update(loss=float(m["loss"]), host_ms_per_call=statistics.median(host_ms),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   unprofiled_wall_ms_per_step=unprofiled_ms,
                   unprofiled_idle_share=1.0 - row["device_busy_ms_per_step"] / unprofiled_ms)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
