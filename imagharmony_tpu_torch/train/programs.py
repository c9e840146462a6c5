"""The adapter train step as one captured program: the port's counterpart
of the JAX trainer's donated ``jax.jit(raw_step, donate_argnums=(0,))``
(imagharmony_tpu/train/trainer.py:302-309) over ``make_train_step``
(imagharmony_tpu/train/step.py:308-366).

On a CUDA device ``trainer.main`` runs every optimizer step as one CUDA
graph, replayed once a step: ``step.train_step`` (the forward with its
checkpoint recompute and the backward of each microbatch, unrolled, the
clip, AdamW, the EMA) captured at the first step of a key, after any
resume has loaded the state. A key is (device, resolution, rows per
microbatch, the batch's keys, the ``TrainConfig``): the shapes, the
branches (a live or a cached-encoder batch, prediction type, Min-SNR,
noise offset, EMA, clip, grad_accum, the LoRA rank, alpha and targets) and
the constants the graph bakes in. With LoRA the factors and their AdamW
moments are state tensors like the adapters', changed in place by each
replay, and the graph merges them into the UNet's weights anew at every
replay (``step.loss_fn``): no merged weight outlives a step. Over a mesh
the key holds it (rank, data and model sizes) and the graph holds the
step's collectives: the flat all-reduces of the gradients and the loss and,
under FSDP, each weight's gather (again in the recompute) and its
gradient's reduce-scatter. The eager warm-up step below runs them first on
the capture stream, so NCCL's communicator and its per-stream state exist
before the capture and are not created under it.

A step copies its batch into the program's static input buffers and draws
its random numbers with the trainer's generator, outside the graph, into
the static draw buffers (``step.step_draws`` with ``out=``: the values and
the generator's state are those of the eager step), then replays. The
metrics it returns are the graph's static outputs, which the next replay
overwrites: clone what is kept. A capture or replay error raises; nothing
falls back to the eager step, which stays the reference and the CPU path.

Before the capture one eager step runs on the stream the capture uses, so
that what the kernels' libraries do once per thread, device or stream
happens there and not under capture (the ``cudaFree(nullptr)`` and the
shared-memory attributes of ``sm90_tiles.cuh``, K2's register count, the
cached GEMM plans, the GEMM tile counters kept per (device, stream)), and
so that AdamW's state exists: the warm-up step runs on the first step's
batch and draws (from a copy of the generator), and the parameters, the
optimizer state, the EMA, the update count and the lr are set back after
it from copies in host memory, so the first replay is the first step.

What the program keeps between steps, for its life: the graph and its
memory pool (the activations of one step and the gradients, which live
there from the capture on), the static batch, draw and metric buffers, and
it captures the addresses of the state's tensors (parameters, optimizer
state, EMA, count, lr table). So the state must be changed only in place:
``TrainState.load_state_dict`` replaces the optimizer's state tensors, and
a program captured before a load is stale. ``run`` keeps one program, so
one trainer drives one key at a time: a new key, or a load, drops the old
program and captures anew. Its static buffers make a program serve one
step at a time.
"""

from __future__ import annotations

import time

import torch

from imagharmony_tpu_torch.train import step as step_lib


def _snapshot(state: step_lib.TrainState):
    """Copies of what a step changes in ``state``, in host memory (so the
    warm-up step's peak on the device is an eager step's)."""
    def host(x):
        return x.detach().to("cpu", copy=True)

    return {
        "trainable": [host(p) for p in state.trainable.values()],
        "ema": None if state.ema is None else [host(e) for e in state.ema.values()],
        "optimizer": {p: {k: host(v) for k, v in s.items() if torch.is_tensor(v)}
                      for p, s in state.optimizer.state.items()},
        "count": host(state.count),
        "lr": host(state.lr),
        "step": state.step,
    }


@torch.no_grad()
def _restore(state: step_lib.TrainState, saved):
    """Sets ``state`` back to ``saved`` in place. Optimizer state that the
    step created is zeroed, which is AdamW's fresh state."""
    for p, x in zip(state.trainable.values(), saved["trainable"]):
        p.copy_(x)
    if state.ema is not None:
        for e, x in zip(state.ema.values(), saved["ema"]):
            e.copy_(x)
    for p, s in state.optimizer.state.items():
        old = saved["optimizer"].get(p)
        for k, v in s.items():
            if not torch.is_tensor(v):
                continue
            if old is None:
                v.zero_()
            else:
                v.copy_(old[k])
    state.count.copy_(saved["count"])
    state.lr.copy_(saved["lr"])
    state.step = saved["step"]


class TrainProgram:
    """The captured step of one key and the static buffers it reads and
    writes."""

    def __init__(self, state: step_lib.TrainState, comps, cfgs, cfg: step_lib.TrainConfig,
                 batch, gen: torch.Generator, resolution):
        t0 = time.perf_counter()
        self.state, self.cfgs, self.cfg, self.resolution = state, cfgs, cfg, resolution
        self.loads = state.loads
        device = state.lr.device
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self._load(batch)
        warm_gen = torch.Generator(device)
        warm_gen.set_state(gen.get_state())
        self.draws = step_lib.step_draws(warm_gen, cfgs, cfg, self.rows, resolution)

        saved = _snapshot(state)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):  # the warm-up, on the capture stream
            step_lib.train_step(state, comps, cfg, self.batch, self.draws)
        torch.cuda.current_stream(device).wait_stream(stream)
        _restore(state, saved)
        step = saved["step"]

        # the gradients are None at the capture, so its backward allocates
        # them in the graph's pool
        state.optimizer.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.metrics = step_lib.train_step(state, comps, cfg, self.batch, self.draws)
        state.step = step  # the capture ran the body's host part, not a step
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0  # the warm-up and the capture

    @property
    def rows(self):
        return next(iter(self.batch.values())).shape[0]

    def _load(self, batch):
        for k, buf in self.batch.items():
            buf.copy_(batch[k])

    def run(self, batch, gen: torch.Generator):
        """One optimizer step on ``batch`` (tensors on the device, the shapes
        of the key) with draws from ``gen``, by one replay; returns the
        static {"loss", "grad_norm"}."""
        self._load(batch)
        step_lib.step_draws(gen, self.cfgs, self.cfg, self.rows, self.resolution, out=self.draws)
        self.graph.replay()
        self.state.step += 1
        return self.metrics


def run(programs, state: step_lib.TrainState, comps, cfgs, cfg: step_lib.TrainConfig, batch,
        gen: torch.Generator, resolution):
    """One optimizer step of ``state`` on its CUDA device through the key's
    program in ``programs`` (a dict the caller keeps for this state),
    captured first if the key has none or its program is stale."""
    device = state.lr.device
    rows = next(iter(batch.values())).shape[0]
    mesh = None if state.mesh is None else state.mesh.key
    key = (device, resolution, rows // max(cfg.grad_accum, 1), tuple(sorted(batch)), cfg, mesh)
    with torch.cuda.device(device):
        if key not in programs or programs[key].loads != state.loads:
            programs.clear()  # one key at a time: the old graph's pool goes first
            programs[key] = TrainProgram(state, comps, cfgs, cfg, batch, gen, resolution)
        return programs[key].run(batch, gen)
