"""What the port's probe tools share: their arguments, the card's name and
power limit, and timing.

A time is taken twice, as chip_smoke.py takes it: the device time of the
kernels a call launches, from the profiler's trace
(``utils/profiling.kernel_ms``), and the median CUDA-event time of the
call, which also holds the host's launch work. On the CPU (``--device
cpu``) the tools run the plain versions and time nothing.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from imagharmony_tpu_torch.utils import profiling


def parse(argv, description):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (default): the kernels, timed; cpu: the plain versions, untimed")
    args = p.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is false (run with "
                         "--device cpu for the plain versions)")
    return args


def header(device):
    """Prints where the probe runs: the card with its name and power limit
    (nvidia-smi), or the CPU, whose runs are the plain versions, untimed."""
    if device.type != "cuda":
        print(f"device {device}: the plain versions, not timed", flush=True)
        return
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        smi = "power limit not read (nvidia-smi failed)"
    print(f"device {device}: {torch.cuda.get_device_name(device)}; {smi}", flush=True)


def timed(fn, device):
    """(device ms from the profiler's trace, CUDA-event ms) of ``fn`` on a
    card; None on the CPU."""
    if device.type != "cuda":
        return None
    return profiling.kernel_ms(fn)["total"], profiling.event_ms(fn)


def fmt(t, work, unit):
    """A time of ``timed`` with the rate ``work`` (operations) gives, in
    T``unit``/s at the device time."""
    if t is None:
        return "not timed"
    dev, ev = t
    if dev is None:
        return f"device not measured (event {ev:.4f} ms)"
    return f"{dev:.4f} ms (event {ev:.4f}) {work / dev / 1e9:6.1f} T{unit}/s"
