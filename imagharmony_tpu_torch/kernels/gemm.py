"""Host side of the GEMM mainloop that P1 (``probe_matmul``) and K5
(``geglu``) share, ``csrc/sm90_gemm.cuh``: the tile counters of its split
K loop and the reading of a launch's schedule.

A launch whose tiles would leave the card's last wave part empty cuts
some tiles along K into chunks that other CTAs run. Each chunk stores its
partial accumulator to a workspace the wrapper takes from torch's
allocator on the call's stream (sized by the library's ``*_plan``), and
counts itself on its tile's counter; the chunk that counts last sums the
partials and sets the counter back to 0. So the counters are allocated
zero once per (device, stream) here and every launch leaves them zero: no
launch clears them, and a call stays one kernel.
"""

from __future__ import annotations

import torch

# sm90::gemm::kMaxCounters: the counters a launch may use
MAX_COUNTERS = 1024

# what a library's *_plan writes, in order
FIELDS = ("bn", "tiles_m", "tiles_n", "k_panels", "grid", "whole_tiles", "split_tiles", "chunks")

_counters = {}


def counters(device, stream):
    """The int32 tile counters for launches on ``device``'s stream
    ``stream`` (its handle): zeros at the first call for that (device,
    stream), kept zero by the kernels after."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None:
        buf = _counters[key] = torch.zeros(MAX_COUNTERS, dtype=torch.int32, device=device)
    return buf


def describe(workspace_bytes, info):
    """A schedule as a dict: ``FIELDS``, then ``units`` (the whole tiles and
    the split tiles' chunks) and ``workspace_bytes``."""
    plan = dict(zip(FIELDS, (int(v) for v in info)))
    return {**plan, "units": plan["whole_tiles"] + plan["split_tiles"] * plan["chunks"],
            "workspace_bytes": int(workspace_bytes)}
