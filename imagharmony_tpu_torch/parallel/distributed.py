"""Process groups and cross-rank helpers (port of
imagharmony_tpu/parallel/distributed.py).

The reference's launcher is ``accelerate launch``, one process per GPU over
NCCL (reference run.sh:1, train.py:492-496). The port keeps that model: one
process per card, started by ``torchrun`` (which sets ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), joined by
``torch.distributed``: NCCL on CUDA devices, gloo on the CPU. A world of
one process is the single-device path, untouched.

``spawn`` starts ranks of a function of this package on this host (the CPU
tests' gloo drills and ``chip_smoke.py``'s two-card phase), forked from a
fresh server process: a rank imports only the port and torch.
"""

from __future__ import annotations

import datetime
import gc
import importlib
import multiprocessing
import os
import pickle
import socket
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# how long a collective may wait for its peers before the group gives up
TIMEOUT = datetime.timedelta(minutes=10)


def init_group(backend: str, world_size: int, rank: int, local_rank: int = 0,
               timeout: datetime.timedelta = TIMEOUT):
    """``init_process_group`` over ``MASTER_ADDR``/``MASTER_PORT``. NCCL
    binds the group to ``cuda:local_rank`` (and makes it the current
    device); a failure raises, nothing falls back to gloo or the CPU."""
    kw = {}
    if backend == "nccl":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method="env://", world_size=world_size, rank=rank,
                            timeout=timeout, **kw)


def initialize(device="cuda", timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group torchrun describes. A no-op returning False
    for a world of one process (no ``WORLD_SIZE``, or 1), as the JAX
    ``initialize`` is on one host; True once joined (or if already).
    ``device``: the device type the ranks compute on; a CUDA one takes
    NCCL on ``cuda:LOCAL_RANK``, the CPU gloo."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    init_group("nccl" if torch.device(device).type == "cuda" else "gloo", world, rank, local,
               timeout)
    return True


def local_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for a CUDA device type
    under torchrun, else ``device`` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def barrier():
    """Every rank waits here for the others (no-op without a group)."""
    if dist.is_initialized():
        dist.barrier()


# -- spawn ------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _target(fn) -> str:
    """"module:qualname" of a function of this package."""
    mod = fn.__module__
    if not mod.startswith("imagharmony_tpu_torch."):
        raise ValueError(f"spawn runs functions of imagharmony_tpu_torch, not {mod}")
    return f"{mod}:{fn.__qualname__}"


def spawn(fn, world_size: int, backend: str = "gloo", kwargs=None, timeout: float = 600.0,
          threads: int = 2):
    """Run ``fn(**kwargs)`` on ``world_size`` ranks in a process group of
    ``backend`` on a free localhost port (rank r on ``cuda:r`` under NCCL),
    each with ``threads`` intra-op threads. ``fn``: a function of this
    package, which a rank imports by name. The ranks are forked from
    multiprocessing's fork server, a fresh interpreter that has imported
    this module (torch, not CUDA) once, so a rank neither pays torch's
    import nor inherits the caller's state: it imports only the port and
    torch. Returns each rank's return value in rank order (pickled by the
    rank: numpy arrays and plain values). A rank that fails or outlives
    ``timeout`` seconds has every rank killed and raises here with its
    traceback."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    work = tempfile.mkdtemp(prefix="imagharmony_spawn_")
    job = (_target(fn), kwargs or {}, backend, threads, world_size, _free_port())
    procs = [ctx.Process(target=_child, args=(work, r) + job) for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.exitcode is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)), None)
            if failed is None and time.monotonic() > deadline:
                failed = next(r for r, p in enumerate(procs) if p.exitcode is None)
            time.sleep(0.02)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
        if failed is not None:
            code = procs[failed].exitcode
            for p in procs:
                p.kill()
                p.join()
            err = os.path.join(work, f"error{failed}.txt")
            tail = open(err).read()[-6000:] if os.path.exists(err) else "(no traceback)"
            why = f"outlived {timeout} s" if code is None else f"exit {code}"
            raise RuntimeError(f"rank {failed} of {world_size} failed ({why}):\n{tail}")
        out = []
        for r in range(world_size):
            with open(os.path.join(work, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))  # written by our own rank
        return out
    finally:
        for p in procs:
            if p.exitcode is None and p.pid is not None:
                p.kill()
            if p.pid is not None:
                p.join()
        for name in os.listdir(work):
            os.remove(os.path.join(work, name))
        os.rmdir(work)


def _child(work, rank, target, kwargs, backend, threads, world_size, port):
    """One rank of ``spawn``: join the group, run the target, write its
    result (or its traceback) under ``work``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world_size), RANK=str(rank), LOCAL_RANK=str(rank))
    torch.set_num_threads(threads)
    try:
        init_group(backend, world_size, rank, rank)
        mod, name = target.split(":")
        fn = importlib.import_module(mod)
        for part in name.split("."):
            fn = getattr(fn, part)
        result = fn(**kwargs)
        # this rank's collectives are done once its device work is: then it
        # leaves without tearing the group down (with NCCL, a teardown while
        # CUDA graphs that captured collectives live may wait forever; a
        # two-card run's ranks were seen to hang there)
        gc.collect()
        if backend == "nccl":
            torch.cuda.synchronize()
        tmp = os.path.join(work, f"result{rank}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(work, f"result{rank}.pkl"))
        code = 0
    except BaseException:
        with open(os.path.join(work, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        code = 1  # the caller kills the ranks still in a collective with this one
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
