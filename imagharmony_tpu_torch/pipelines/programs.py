"""The edit as captured programs: the port's counterpart of the JAX
package's ``_edit_jit`` (imagharmony_tpu/pipelines/harmony_edit.py:556-560)
and of its ``lax.scan`` denoise loop (:427).

On a CUDA device ``HarmonyPipeline.generate()`` runs the edit as three CUDA
graphs, captured at the first call of a key (device, height, width,
num_samples, whether an extra_text is given: the shapes and the branches of
the programs) into one memory pool:

(a) conditioning: static token-id and pixel buffers to the CFG-packed
    (context2, pooled2, time_ids, ip2) (``harmony_edit.build_conditioning``);
(b) one denoise step (``harmony_edit.denoise_step``) on static latents,
    the static (4, MAX_STEPS) table of per-step constants and a static step
    index that the graph itself advances, so the loop is ``num_steps``
    replays with no per-step host work and the key does not depend on the
    step count; the IP weight K2 reads is the table's entry for the step;
(c) decode (``harmony_edit.decode``).

A call copies its inputs into the static buffers, replays (a), (b) as many
times as it has steps, and (c), and returns a copy of the images. A capture
or replay error raises; nothing falls back to the eager functions, which
stay the reference (``harmony_edit.edit``) and the CPU path.

Before the first capture of a key, one eager pass of each piece runs on the
stream the capture uses, so that what the kernels' libraries do once per
thread, device or stream happens there and not under capture: the
``cudaFree(nullptr)`` and the shared-memory attributes of
``sm90_tiles.cuh``, K2's register count, the cached GEMM plans and the GEMM
tile counters kept per (device, stream) (``kernels/gemm.py``). Tensors the
graphs read stay alive with the program: the weights, the static buffers,
the cached tensors of ``build_conditioning`` and K2.

The kernels' Python launch counters count the launches of the warm-up and
of the capture, not those of replays; a replay's launches show only in a
profiler trace, by kernel name.

Two limits, left to the serving layer: a pipeline keeps every key's
programs (``pipe.programs``: the graphs, their pool and the static
buffers) for its life, with no eviction; and a key's static buffers make
generate() non-reentrant for that key, so two concurrent calls of one key
on one pipeline would overwrite each other's inputs.
"""

from __future__ import annotations

import time

import torch

from imagharmony_tpu_torch.pipelines import harmony_edit as he

# the longest denoise loop a program takes: leading spacing needs one
# training timestep a step
MAX_STEPS = 1000


class EditProgram:
    """The three graphs of one key and the static buffers they read and
    write."""

    def __init__(self, pipe, call: he.EditCall):
        t0 = time.perf_counter()
        self.comps, self.device = pipe.components, pipe.device
        self.opts = he.EditOptions(height=call.opts.height, width=call.opts.width,
                                   use_harmony=call.opts.use_harmony)
        self.num_samples = call.num_samples
        self.ids = {k: torch.empty_like(v) for k, v in call.ids.items()}
        self.pixel_values = torch.empty_like(call.pixel_values)
        self.latents = torch.empty_like(call.latents)
        self.tables = torch.zeros((4, MAX_STEPS), dtype=torch.float32, device=self.device)
        self.guidance = torch.zeros((), dtype=torch.float32, device=self.device)
        self.index = torch.zeros(1, dtype=torch.long, device=self.device)
        self.load(call)

        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):  # the warm-up, on the capture stream
            self._step(self._conditioning())
            self._decode()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.load(call)  # the warm-up step moved the latents and the index

        pool = torch.cuda.graph_pool_handle()
        self.conditioning, self.step, self.decode = (torch.cuda.CUDAGraph() for _ in range(3))
        with torch.cuda.graph(self.conditioning, pool=pool, stream=stream):
            self.cond = self._conditioning()
        with torch.cuda.graph(self.step, pool=pool, stream=stream):
            self._step(self.cond)
        with torch.cuda.graph(self.decode, pool=pool, stream=stream):
            self.images = self._decode()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0  # the warm-up and the captures

    def _conditioning(self):
        return he.build_conditioning(self.comps, self.opts, self.ids, self.pixel_values,
                                     num_samples=self.num_samples)

    def _step(self, cond):
        nxt = he.denoise_step(self.comps.unet, self.latents, self.index, self.tables, cond,
                              kind="euler", guidance_scale=self.guidance)
        self.latents.copy_(nxt)
        self.index.add_(1)

    def _decode(self):
        return he.decode(self.comps, self.latents)

    def load(self, call: he.EditCall):
        """Copies a call's inputs into the static buffers and sets the step
        index to 0."""
        n = call.schedule.num_steps
        if n > MAX_STEPS:
            raise ValueError(f"num_inference_steps {n} > {MAX_STEPS}, the longest loop a "
                             f"program takes")
        for k, buf in self.ids.items():
            buf.copy_(call.ids[k])
        self.pixel_values.copy_(call.pixel_values)
        self.latents.copy_(call.latents)
        table = torch.zeros((4, MAX_STEPS), dtype=torch.float32)
        table[:, :n] = he.scan_tables(call.schedule, he.ip_scale_schedule(call.opts))
        self.tables.copy_(table)
        self.guidance.fill_(call.opts.guidance_scale)
        self.index.zero_()

    def run(self, call: he.EditCall, clock: he.PhaseClock):
        """The call's images (B, H, W, 3) in [-1, 1], by replays."""
        self.load(call)
        self.conditioning.replay()
        clock.mark("conditioning_s")
        for _ in range(call.schedule.num_steps):
            self.step.replay()
        clock.mark("denoise_s")
        self.decode.replay()
        images = self.images.clone()
        clock.mark("decode_s")
        return images


def run(pipe, call: he.EditCall, clock: he.PhaseClock):
    """The edit of ``call`` on ``pipe``'s CUDA device through the key's
    programs, captured first if the key has none."""
    k = (pipe.device, call.opts.height, call.opts.width, call.num_samples, "extra_l" in call.ids)
    with torch.cuda.device(pipe.device):
        prog = pipe.programs.get(k)
        if prog is None:
            prog = pipe.programs[k] = EditProgram(pipe, call)
        return prog.run(call, clock)
