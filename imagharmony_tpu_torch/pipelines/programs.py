"""The edit as captured programs: the port's counterpart of the JAX
package's ``_edit_jit`` (imagharmony_tpu/pipelines/harmony_edit.py:556-560)
and of its ``lax.scan`` denoise loop (:427).

On a CUDA device ``HarmonyPipeline.generate()`` and ``generate_batch()``
run the edit as CUDA graphs, captured at the first call of a key into one
memory pool. The key is the device, the output size, the requests the call
packs, the samples of each and the call's ``harmony_edit.Branches``: what
the code does (the sampler, the prediction
type, CFG or not, the rescale, the image prompt, img2img, inpaint, latent
output, clip_skip, encoder_interval, tile_vae, prompt weights), never a
value and never the step count. The graphs:

(a) conditioning (``harmony_edit.start``): static token-id, weight,
    pixel, control-image, init-image, noise, time-id and scalar buffers to
    the step's conditioning, the init image's latents and the first
    latents;
(b) one denoise step (``harmony_edit.denoise_step``) on the static latents,
    the static (STEP_ROWS, MAX_STEPS) table of per-step constants and a
    static step index that the graph itself advances, so the loop is
    ``num_steps`` replays with no per-step host read; with a control image
    the ControlNet's residuals are computed inside the step graph. With encoder
    propagation there are two: a key step, which writes the encoder
    features the program keeps, and a reuse step, which reads them; the
    host replays one or the other by the step index (``i % k == 0``),
    known before the loop;
(c) the finish (``harmony_edit.finish``: decode, tiled or not), which a
    latent output does without.
On a ``with_mesh`` clone the key also holds the mesh (rank, data and model
sizes) and the call's rows (``EditCall.rows``): a rank captures its rows'
programs, and with tensor parallelism the model group's all-reduces are
inside the step graph (and the conditioning's and the decode's, where the
towers are sharded); the gather of the rows runs after the finish.

DPM++'s history lives in static buffers that every call's ``load`` zeroes
(a first step is first order); its first/second-order choice is a
``torch.where`` in the graph. The stochastic samplers (Euler-a, LCM) read
each step's draw from a static buffer that the host refills before each
step's replay from the call's generator (``harmony_edit.draw_step_noise``,
the eager loop's draw): one latent-sized fp32 buffer, 256 KiB for one
1024² sample.

A call copies its inputs into the static buffers, replays (a), (b) as many
times as it has steps, and (c), and returns a copy of the output. A capture
or replay error raises; nothing falls back to the eager functions, which
stay the reference (``harmony_edit.edit``) and the CPU path.

Each graph is a ``Piece``: before its capture, one eager pass of it runs on
the stream the capture uses, so that what the kernels' libraries do once per
thread, device or stream happens there and not under capture: the
``cudaFree(nullptr)`` and the shared-memory attributes of
``sm90_tiles.cuh``, K2's register count, the cached GEMM plans and the GEMM
tile counters kept per (device, stream) (``kernels/gemm.py``). Tensors the
graphs read stay alive with the program: the weights, the static buffers,
the cached tensors of K2.

The kernels' Python launch counters count the launches of the warm-up and
of the capture, not those of replays; a replay's launches show only in a
profiler trace, by kernel name.

A pipeline keeps its programs in a ``ProgramCache`` (``pipe.programs``):
at most ``capacity`` keys, the least recently used evicted first, which
drops its graphs, their pool and its static buffers (the memory returns to
the card at the allocator's next ``empty_cache()``). Each program has a
lock, taken for the whole of a call, so two threads never run one key's
buffers at once. A capture wants the device to itself: the serving
workers run all device work on one thread (``serving.py``).
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from imagharmony_tpu_torch.pipelines import harmony_edit as he
from imagharmony_tpu_torch.schedulers import diffusion as sched

# the longest denoise loop a program takes: leading spacing needs one
# training timestep a step
MAX_STEPS = 1000
# keys a pipeline keeps. What a 1024² SDXL key keeps on one NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md §5): a one-request CFG key 4.74-4.76 GiB,
# img2img 6.15-6.33, a 4-request generate_batch key 7.09, a 4-slot engine
# 7.14, a 2-sample key or 2-slot engine with its 2-row decode 9.56-9.57;
# the weights take 12.3 GiB and a call peaks at 15.6 GiB allocated. Six of
# the largest (57.4 GiB) fit beside that in the card's 79.18 GiB.
DEFAULT_CAPACITY = 6


class ProgramCache(collections.OrderedDict):
    """A pipeline's captured programs by key, least recently used first: at
    most ``capacity`` of them. ``acquire`` builds a key's program when the
    cache has none, evicting the least recently used unpinned ones first
    (a slot engine pins its program while it holds slots); ``captures``
    counts the programs built, ``evictions`` those dropped."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        super().__init__()
        self.lock = threading.RLock()
        self.captures = self.evictions = 0
        self.resize(capacity)

    def acquire(self, key, build):
        """The program of ``key``, now the most recently used; ``build()``
        makes it where the cache has none, after room is made for it."""
        with self.lock:
            prog = self.get(key)
            if prog is not None:
                self.move_to_end(key)
                return prog
            self._evict(self.capacity - 1)
            prog = self[key] = build()
            self.captures += 1
            return prog

    def resize(self, capacity: int):
        """Sets the bound, evicting down to it now."""
        if capacity < 1:
            raise ValueError(f"a program cache keeps at least one key, got {capacity}")
        with self.lock:
            self.capacity = capacity
            self._evict(capacity)

    def _evict(self, keep: int):
        """Drops the least recently used unpinned programs until ``keep``
        are left (pinned ones stay, over the bound if they must), each once
        a call of it running on another thread has ended."""
        while len(self) > keep:
            victim = next((k for k, p in self.items() if not p.pinned), None)
            if victim is None:
                return
            with self.pop(victim).lock:
                self.evictions += 1


def _like(x):
    return None if x is None else torch.empty_like(x)


class Piece:
    """One piece of a program. Without a stream (the CPU) a call runs
    ``fn``. With one, a call replays a CUDA graph of ``fn`` and returns
    the tensors ``fn`` returned under capture; the graph is captured at
    ``capture()`` or at the first call, after one eager run of ``fn`` on
    the capture stream (the warm-up: ``fn`` writes only its own outputs,
    or its caller resets what it moves).

    The pieces of a program capture into one memory pool, ``pool``. A
    later capture may place its temporaries and its outputs where an
    earlier one's temporaries were, and never where a living output is.
    So a piece's outputs stay valid while pieces captured after it replay,
    and a replay of a piece captured before it may overwrite them: its
    caller reads or copies them before then. Pieces captured lazily (a slot
    engine's decodes and second conditioning) come after the steps: their
    outputs are copied out at once."""

    def __init__(self, fn, stream=None, pool=None):
        self.fn, self.stream, self.pool = fn, stream, pool
        self.graph = self.out = None

    def capture(self):
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.fn()
        current.wait_stream(self.stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream):
            self.out = self.fn()

    def __call__(self):
        if self.stream is None:
            return self.fn()
        if self.graph is None:
            self.capture()
        self.graph.replay()
        return self.out


class EditProgram:
    """The graphs of one key and the static buffers they read and write;
    ``lock`` is held for the whole of a call."""

    pinned = False

    def __init__(self, pipe, call: he.EditCall):
        t0 = time.perf_counter()
        self.lock = threading.Lock()
        self.comps, self.device = pipe.components, pipe.device
        self.br = br = call.branches
        # the conditioning reads use_harmony and clip_skip, both in the key
        self.opts = he.EditOptions(height=call.opts.height, width=call.opts.width,
                                   use_harmony=br.harmony, clip_skip=br.clip_skip)
        self.ids = {k: torch.empty_like(v) for k, v in call.ids.items()}
        self.pixel_values, self.init_pixels, self.mask, self.control = (
            _like(call.pixel_values), _like(call.init_pixels), _like(call.mask),
            _like(call.control))
        self.noise, self.time_ids = torch.empty_like(call.noise), torch.empty_like(call.time_ids)
        self.tables = torch.zeros((he.STEP_ROWS, MAX_STEPS), dtype=torch.float32,
                                  device=self.device)
        self.scalars = torch.zeros_like(call.scalars)
        self.index = torch.zeros(1, dtype=torch.long, device=self.device)
        self.latents = torch.empty(call.noise.shape, dtype=pipe.dtype, device=self.device)
        self.state = sched.init_solver_state(br.kind, self.latents)
        self.z = self.z_all = None
        if br.kind in sched.STOCHASTIC:
            # a mesh rank's call draws every row and its graphs read its own
            start, stop, total = call.rows or (0, call.noise.shape[0], call.noise.shape[0])
            self.z_all = call.noise.new_zeros((total,) + tuple(call.noise.shape[1:]))
            self.z = self.z_all[start:stop]
        self.gen = torch.Generator(device=self.device) if self.z is not None else None
        self.load(call)
        prop = br.encoder_interval > 1

        # each piece captured after its warm-up and replayed once, in the
        # order a call runs them, so that every warm-up reads real inputs
        stream, pool = torch.cuda.Stream(self.device), torch.cuda.graph_pool_handle()
        self.conditioning = Piece(self._start, stream, pool)
        self.cond, self.img_lat = self.conditioning()
        self.key_step = Piece(lambda: self._step(key=True), stream, pool)
        self.encoder = self.key_step()
        self.reuse_step = Piece(lambda: self._step(key=False), stream, pool) if prop else None
        if prop:
            self.reuse_step()
        self.finish = None if br.latent_output else Piece(self._finish, stream, pool)
        if self.finish is not None:
            self.finish()
        torch.cuda.synchronize(self.device)
        self.load(call)  # the warm-ups and replays moved the latents, the state and the index
        self.capture_s = time.perf_counter() - t0  # the warm-up and the captures

    def _start(self):
        cond, latents, img_lat = he.start(self.comps, self.br, self.opts, self.ids,
                                          self.pixel_values, self.init_pixels, self.noise,
                                          self.time_ids, self.scalars, self.control)
        self.latents.copy_(latents)
        return cond, img_lat

    def _step(self, key):
        """One step; a key step (or any step without encoder propagation)
        returns the encoder features it computed, a reuse step reads the
        kept ones."""
        br = self.br
        inpaint = (self.mask, self.img_lat, self.noise) if br.inpaint else None
        nxt, state, encoder = he.denoise_step(
            self.comps.unet, self.latents, self.index, self.tables, self.scalars, self.cond, br,
            state=self.state, z=self.z, inpaint=inpaint, encoder=None if key else self.encoder,
            want_encoder=key and br.encoder_interval > 1, controlnet=self.comps.controlnet)
        self.latents.copy_(nxt)
        if self.state is not None:
            for k, buf in self.state.items():
                buf.copy_(state[k])
        self.index.add_(1)
        return encoder

    def _finish(self):
        return he.finish(self.comps, self.br, self.latents)

    def load(self, call: he.EditCall):
        """Copies a call's inputs into the static buffers, sets the step
        index to 0 and zeroes the solver state."""
        n = call.schedule.num_steps
        if n > MAX_STEPS:
            raise ValueError(f"num_inference_steps {n} > {MAX_STEPS}, the longest loop a "
                             f"program takes")
        for k, buf in self.ids.items():
            buf.copy_(call.ids[k])
        for buf, x in ((self.pixel_values, call.pixel_values),
                       (self.init_pixels, call.init_pixels), (self.mask, call.mask),
                       (self.control, call.control)):
            if buf is not None:
                buf.copy_(x)
        self.noise.copy_(call.noise)
        self.time_ids.copy_(call.time_ids)
        self.scalars.copy_(call.scalars)
        self.tables.zero_()
        self.tables[:, :n].copy_(call.tables)
        self.index.zero_()
        if self.state is not None:
            for buf in self.state.values():
                buf.zero_()
        if self.gen is not None:
            self.gen.manual_seed(call.step_seed)

    def run(self, call: he.EditCall, clock: he.PhaseClock):
        """The call's output by replays: images (B, H, W, 3) in [-1, 1], or
        latents (B, h, w, 4)."""
        self.load(call)
        self.conditioning()
        clock.mark("conditioning_s")
        k = self.br.encoder_interval
        for i in range(call.schedule.num_steps):
            if self.z is not None:
                he.draw_step_noise(self.gen, self.z_all)
            (self.key_step if i % k == 0 else self.reuse_step)()
        clock.mark("denoise_s")
        if self.finish is None:
            out = self.latents.permute(0, 2, 3, 1).clone()
        else:
            out = self.finish().clone()
        clock.mark("decode_s")
        return out


def run(pipe, call: he.EditCall, clock: he.PhaseClock):
    """The edit of ``call`` on ``pipe``'s CUDA device through the key's
    programs, captured first if the key has none."""
    k = (pipe.device, call.opts.height, call.opts.width, call.requests, call.samples,
         call.branches, None if pipe.mesh is None else pipe.mesh.key, call.rows)
    with torch.cuda.device(pipe.device):
        prog = pipe.programs.acquire(k, lambda: EditProgram(pipe, call))
        with prog.lock:
            return prog.run(call, clock)
