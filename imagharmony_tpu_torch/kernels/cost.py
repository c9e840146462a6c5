"""The kernels' declared costs: the counterpart of the ``pl.CostEstimate``
every attention and GEGLU Pallas call of the JAX package passes
(imagharmony_tpu/kernels/flash_attention.py:165, :311, :521, :719;
tools/probe_geglu_v2.py:57), which XLA's cost analysis adds to a compiled
program's flops and bytes.

A hand-written kernel launched through ctypes runs no aten op, so
``torch.utils.flop_counter.FlopCounterMode`` never sees it. Each wrapper
therefore declares its launch here, with the JAX formula, where it counts
the launch (on the CUDA path only: a plain version runs aten ops, which the
flop counter counts, so a CPU call is never counted twice). ``counting()``
opens a count for the whole process, not for one thread: on CUDA tensors
the autograd engine runs a backward on threads of its own, and a launch
there (K3, and the K1, K2 and K5 launches that gradient checkpointing reruns
inside ``backward()``) belongs to the count opened around the step. So a
count also sees what other threads launch while it is open. ``declare``
adds to every open count, and the wrappers call it only when ``active()``,
so a launch outside a count does no more than before. A captured program's
replay runs no Python and declares nothing.

Where a formula differs from ``chip_smoke.py``'s ``*_bound`` arithmetic, the
declaration keeps JAX's: K3 declares 11·b·h·sq·sk·d (JAX's estimate), one
b·h·sq·sk·d above the five products of its plain backward (10). And where
K1 saves the lse for a backward, its plain version on the CPU runs one more
product, ``lse_plain``'s q·kᵀ (2·b·h·sq·sk·d), that K1 does in its one pass.
So a gradient-checkpointed train step on the card counts 3·b·h·sq·sk·d less
than on the CPU for each K3 launch: two K1 launches with the lse (the
forward and its rerun) at -2 each, K3 at +1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

# the open counts, in opening order; _lock guards the list and the counts in it
_counts = []
_lock = threading.Lock()


@dataclasses.dataclass
class Count:
    """What the kernels launched inside one ``counting()`` declared: the
    totals, and flops and launches by kernel."""

    flops: int = 0
    bytes_accessed: int = 0
    transcendentals: int = 0
    flops_by_kernel: dict = dataclasses.field(default_factory=dict)
    launches_by_kernel: dict = dataclasses.field(default_factory=dict)


def active() -> bool:
    """Whether a count is open."""
    return bool(_counts)


def declare(kernel, flops, bytes_accessed, transcendentals):
    """Adds one launch of ``kernel`` and its cost to every open count,
    from any thread; a no-op when none is open."""
    with _lock:
        for c in _counts:
            c.flops += flops
            c.bytes_accessed += bytes_accessed
            c.transcendentals += transcendentals
            c.flops_by_kernel[kernel] = c.flops_by_kernel.get(kernel, 0) + flops
            c.launches_by_kernel[kernel] = c.launches_by_kernel.get(kernel, 0) + 1


@contextlib.contextmanager
def counting():
    """Opens a ``Count`` for the block and yields it; it takes what every
    thread declares until the block ends."""
    count = Count()
    with _lock:
        _counts.append(count)
    try:
        yield count
    finally:
        with _lock:  # by identity: two counts may be equal
            _counts[:] = [c for c in _counts if c is not count]


# the JAX formulas: (flops, bytes accessed, transcendentals) of one call


def attention(b, h, sq, sk, d, itemsize):
    """K1 and K4 (JAX :165, :521): q, k, v read and the output written once."""
    return (4 * b * h * sq * sk * d, (2 * b * h * sq * d + 2 * b * h * sk * d) * itemsize,
            b * h * sq * sk)


def attention_bwd(b, h, sq, sk, d, itemsize):
    """K3 (JAX :311): 11·b·h·sq·sk·d, and q, k, v, dout read three times."""
    return (11 * b * h * sq * sk * d, 3 * (2 * b * h * sq * d + 2 * b * h * sk * d) * itemsize,
            b * h * sq * sk)


def cross(b, h, sq, sk_text, sk_ip, d, itemsize):
    """K2 (JAX :719): both branches' products over sk_text + sk_ip keys; the
    bytes are JAX's, q twice and the text k and v (the IP keys left out)."""
    sk = sk_text + sk_ip
    return (4 * b * h * sq * sk * d, (2 * b * sq * h * d + 2 * b * sk_text * h * d) * itemsize,
            b * h * sq * sk)


def geglu(m, k, inner):
    """K5 (tools/probe_geglu_v2.py:57): the (m, k) x (k, 2·inner) product;
    x, W and the output in bf16."""
    return 2 * m * k * 2 * inner, (m * k + k * 2 * inner + m * inner) * 2, m * inner
