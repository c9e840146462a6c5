"""Chunked denoising: progress callbacks and continuous (rolling) batching
(port of imagharmony_tpu/pipelines/continuous.py).

The one-call edit (``harmony_edit.HarmonyPipeline.generate``) is all or
nothing: no progress between its first and its last step, and no way for a
request to join a running batch. This module splits the device work into
three pieces that share the one-call path's math, and so its outputs:

1. the conditioning of one request (``harmony_edit.start``: the same
   ``build_conditioning``, the CFG pair's two rows) and its first latents;
2. the chunk: ``chunk`` denoise steps with a step index per row
   (``harmony_edit.denoise_rows_step``), so rows at different depths share
   one UNet batch; finished and empty rows are frozen;
3. the decode of one finished row, or of every row.

``SlotEngine`` keeps S request slots on the device. At every chunk
boundary finished slots are decoded and freed, and waiting requests are
admitted into free slots mid-flight: continuous batching at the
granularity of a denoise step. ``generate_chunked`` is generate() through
an engine of num_samples slots, with a callback after each chunk.

On the CPU the pieces run eagerly. On a CUDA device they are CUDA graphs
(``EngineProgram``, each a ``programs.Piece``, in one memory pool): the
chunk step captured once (a key and a reuse step under encoder
propagation) and replayed ``chunk`` times;
a request's conditioning a captured one-request graph whose rows ``admit``
copies into slot i and slot S + i of the engine's static buffers (the slot's
DPM++ history zeroed, its index set to 0: the JAX package's ``_write_slot``);
``harvest`` decodes a row through a captured one-row decode graph. The
step reads each row's timestep, sigmas and IP weight from a device table at
the row's device index, so the graphs serve every schedule of their key;
``progress()`` is the one host read a chunk. The program is kept in the
pipeline's ``ProgramCache`` under ("engine", device, size, slots,
Branches) and pinned while an engine holds it.

With a ControlNet (``use_controlnet``, by default whether the pipeline has
one) every row's control image is part of its conditioning rows and the
chunk step runs the ControlNet on them; a request admitted without one
runs on an all-zero image, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from imagharmony_tpu_torch.pipelines import harmony_edit as he
from imagharmony_tpu_torch.pipelines import programs
from imagharmony_tpu_torch.pipelines.programs import Piece
from imagharmony_tpu_torch.schedulers import diffusion as sched


def engine_branches(opts: he.EditOptions, kind: str, controlnet: bool = False) -> he.Branches:
    """What an engine's code does: the CFG pair and an image prompt always
    (a request without an image takes a black one, as in the JAX package),
    no init image, the per-request HA fusion decided by its conditioning
    graph, the ControlNet or not."""
    return he.Branches(
        kind=kind, prediction_type=opts.prediction_type, cfg=True,
        rescale=opts.guidance_rescale > 0.0, image_prompt=True, harmony=False,
        weights=(False, False), init_image=False, from_image=False, inpaint=False,
        latent_output=opts.return_latents or opts.denoising_end is not None,
        tile_vae=opts.tile_vae, clip_skip=opts.clip_skip, encoder_interval=opts.encoder_interval,
        controlnet=controlnet)


@dataclasses.dataclass
class Request:
    """One request after the host's work, on the device: the token ids (one
    row each), the CLIP pixels (1, H, W, 3), the initial noise (1, 4, h, w)
    fp32, the micro-conditioning rows (2, 6) and, with a ControlNet, the
    control image (1, 3, Hc, Wc) in [0, 1]."""

    ids: dict
    pixel_values: torch.Tensor
    noise: torch.Tensor
    time_ids: torch.Tensor
    control: Optional[torch.Tensor] = None


def device_scope(device):
    """``torch.cuda.device(device)`` on a card, nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class EngineProgram:
    """A slot engine's static buffers and the pieces that run on them: the
    (STEP_ROWS, MAX_STEPS) table, scalars and step count of the owner's
    schedule; the slots' latents, step indices and DPM++ history; the
    conditioning of every slot's CFG pair, (2S, ...) in [uncond | cond]
    order. ``lock`` is held for each piece's run; ``owner`` is the engine
    whose schedule is loaded, ``pinned`` while one holds it."""

    def __init__(self, pipe, br: he.Branches, slots: int, req: Request, owner):
        self.lock = threading.RLock()
        self.owner, self.pinned = None, False
        self.comps, self.device, self.br, self.slots = pipe.components, pipe.device, br, slots
        # the conditioning reads use_harmony (with the request's extra_text
        # ids) and clip_skip; the time ids come with the request
        self.opts = he.EditOptions(use_harmony=True, clip_skip=br.clip_skip)
        graphs = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if graphs else None
        self.pool = torch.cuda.graph_pool_handle() if graphs else None
        dev = dict(device=self.device)
        self.tables = torch.zeros((he.STEP_ROWS, programs.MAX_STEPS), dtype=torch.float32, **dev)
        self.scalars = torch.zeros(5, dtype=torch.float32, **dev)
        self.num_steps = torch.ones(1, dtype=torch.long, **dev)
        self.index = torch.ones(slots, dtype=torch.long, **dev)
        self.latents = torch.zeros((slots,) + tuple(req.noise.shape[1:]), dtype=pipe.dtype, **dev)
        self.state = sched.init_solver_state(br.kind, self.latents)
        self.claim(owner)
        self._conds = {}
        cond1, _ = self.condition(req)
        self.bundle = tuple(None if x is None else torch.zeros(
            (2 * slots,) + tuple(x.shape[1:]), dtype=x.dtype, **dev) for x in cond1)
        self.encoder = None
        self.key_step = Piece(lambda: self._step(key=True), self.stream, self.pool)
        self.reuse_step = (Piece(lambda: self._step(key=False), self.stream, self.pool)
                           if br.encoder_interval > 1 else None)
        if graphs:  # every row frozen: the warm-ups change nothing
            self.key_step.capture()
            self.encoder = self.key_step.out
            if self.reuse_step is not None:
                self.reuse_step.capture()
        self.row = torch.zeros((1,) + tuple(self.latents.shape[1:]), dtype=pipe.dtype, **dev)
        decode_br = dataclasses.replace(br, latent_output=False)
        self.decode_row_piece = Piece(lambda: he.finish(self.comps, decode_br, self.row),
                                      self.stream, self.pool)
        self.decode_all_piece = Piece(lambda: he.finish(self.comps, br, self.latents),
                                      self.stream, self.pool)

    def claim(self, engine):
        """Loads ``engine``'s schedule, empties every slot (its index at the
        step count: frozen) and pins the program for it."""
        n = engine.num_steps
        self.tables.zero_()
        self.tables[:, :n].copy_(engine.tables)
        self.scalars.copy_(engine.scalars)
        self.num_steps.fill_(n)
        self.index.fill_(n)
        self.latents.zero_()
        for buf in (self.state or {}).values():
            buf.zero_()
        self.owner, self.pinned = engine, True

    def condition(self, req: Request):
        """A request's conditioning, two rows each ([uncond | cond]), and its
        first latents (1, 4, h, w), from the conditioning piece of its kind
        (with an extra_text or without)."""
        harmony = "extra_l" in req.ids
        if harmony not in self._conds:
            static = Request(ids={k: torch.empty_like(v) for k, v in req.ids.items()},
                             pixel_values=torch.empty_like(req.pixel_values),
                             noise=torch.empty_like(req.noise),
                             time_ids=torch.empty_like(req.time_ids),
                             control=programs._like(req.control))
            br = dataclasses.replace(self.br, harmony=harmony)

            def start():
                cond, latents, _ = he.start(self.comps, br, self.opts, static.ids,
                                            static.pixel_values, None, static.noise,
                                            static.time_ids, self.scalars, static.control)
                return cond, latents

            self._conds[harmony] = (static, Piece(start, self.stream, self.pool))
        static, piece = self._conds[harmony]
        for k, buf in static.ids.items():
            buf.copy_(req.ids[k])
        for buf, x in ((static.pixel_values, req.pixel_values), (static.noise, req.noise),
                       (static.time_ids, req.time_ids), (static.control, req.control)):
            if buf is not None:
                buf.copy_(x)
        return piece()

    def write_slot(self, i: int, req: Request):
        """Installs a request in slot i: its CFG pair's rows at i and S + i,
        its first latents, step 0 and a zeroed DPM++ history (so its first
        step is first order, as a solo run's)."""
        cond1, lat1 = self.condition(req)
        for dst, src in zip(self.bundle, cond1):
            if dst is not None:
                dst[i].copy_(src[0])
                dst[self.slots + i].copy_(src[1])
        self.latents[i].copy_(lat1[0])
        self.index[i] = 0
        for buf in (self.state or {}).values():
            buf[i].zero_()

    def _step(self, key):
        """One step of every row; a key step (or any step without encoder
        propagation) returns the encoder features it computed, a reuse step
        reads the kept ones."""
        br = self.br
        latents, index, state, encoder = he.denoise_rows_step(
            self.comps.unet, self.latents, self.index, self.num_steps, self.tables, self.scalars,
            self.bundle, br, state=self.state, encoder=None if key else self.encoder,
            want_encoder=key and br.encoder_interval > 1, controlnet=self.comps.controlnet)
        self.latents.copy_(latents)
        self.index.copy_(index)
        for k, buf in (self.state or {}).items():
            buf.copy_(state[k])
        return encoder

    def run_chunk(self, chunk: int):
        """``chunk`` steps of every row. Rows enter at steps that are
        multiples of the encoder interval (admission is at chunk
        boundaries and chunk is a multiple of it), so the chunk's own key
        steps are every row's."""
        k = self.br.encoder_interval
        for j in range(chunk):
            if j % k == 0:
                self.encoder = self.key_step()
            else:
                self.reuse_step()

    def decode_row(self, i: int):
        """Slot i's image (1, H, W, 3) in [-1, 1]."""
        self.row.copy_(self.latents[i:i + 1])
        return self.decode_row_piece()

    def decode_all(self):
        """Every slot's output as the one-call path's finish gives it."""
        return self.decode_all_piece()


@dataclasses.dataclass
class _Slot:
    request: object = None  # the caller's token
    started: float = 0.0


class SlotEngine:
    """S request slots on the device, advanced ``chunk`` steps at a time.

    Every admitted request shares the engine's ``EditOptions`` (the serving
    layer groups requests by batch key); rows differ in conditioning, noise
    and step. Empty slots run frozen: they compute and do not advance, the
    price of a static batch. The JAX package's interface: ``prepare``,
    ``admit``, ``free_slots``, ``active``, ``run_chunk``, ``progress``,
    ``harvest``; ``finish`` is every slot's output, ``close`` gives the
    program back to the pipeline's cache."""

    def __init__(self, pipe, opts: he.EditOptions, *, slots: int = 4, chunk: int = 5,
                 use_controlnet: Optional[bool] = None, controlnet_scale: float = 1.0):
        # a static choice of the engine: a static batch cannot skip the
        # branch row by row
        self.use_controlnet = (pipe.cfgs.controlnet is not None if use_controlnet is None
                               else use_controlnet)
        if self.use_controlnet and pipe.cfgs.controlnet is None:
            raise ValueError("use_controlnet=True but the pipeline has no ControlNet")
        if pipe.cfgs.vision is None:
            raise ValueError(f"the chunked runner takes an image prompt; this pipeline has no "
                             f"image encoder (family={pipe.cfgs.family})")
        he.check_options(pipe.cfgs, prediction_type=opts.prediction_type,
                         encoder_interval=opts.encoder_interval, clip_skip=opts.clip_skip)
        he.check_chunked(scheduler=opts.scheduler)
        if opts.encoder_interval > 1 and chunk % opts.encoder_interval != 0:
            # every row must enter a chunk at a step that is a multiple of
            # the interval, so its key steps are the one-call path's
            raise ValueError(f"chunk={chunk} must be a multiple of "
                             f"encoder_interval={opts.encoder_interval}")
        self.pipe, self.opts, self.num_slots, self.chunk = pipe, opts, slots, chunk
        schedule, ip_scales = he.schedule_for(opts)
        self.num_steps = schedule.num_steps
        if self.num_steps > programs.MAX_STEPS:
            raise ValueError(f"num_inference_steps {self.num_steps} > {programs.MAX_STEPS}, the "
                             f"longest loop an engine takes")
        self.br = engine_branches(opts, schedule.kind, self.use_controlnet)
        self.tables = he.scan_tables(schedule, ip_scales, pipe.device)
        self.scalars = torch.tensor([opts.guidance_scale, opts.guidance_rescale,
                                     float(schedule.sigmas[0]), schedule.init_noise_sigma,
                                     controlnet_scale], dtype=torch.float32, device=pipe.device)
        self.time_ids = he.time_ids_rows(opts).to(pipe.device)
        self.key = ("engine", pipe.device, opts.height, opts.width, slots, self.br)
        self.slots: List[_Slot] = [_Slot() for _ in range(slots)]
        # the slots' steps at the last host read (progress(), admit())
        self.last_progress = [self.num_steps] * slots
        self.prog: Optional[EngineProgram] = None

    # -- request lifecycle -------------------------------------------------

    def prepare(self, *, pil_image=None, pixel_values=None, prompt=None, negative_prompt=None,
                extra_text=None, seed=0, control_image=None, noise=None) -> Request:
        """The host's work for one request. No image: a black one, as the
        JAX engine takes; with the ControlNet and no control image, an
        all-zero one. ``noise``: a (1, h, w, 4) initial-noise row in place of
        ``seed``'s (``generate_chunked`` gives the one-call path's draw)."""
        pipe, opts = self.pipe, self.opts
        control = None
        if self.use_controlnet:
            if control_image is None:
                up, d = pipe.cfgs.controlnet.cond_upscale, pipe.cfgs.vae.downscale
                control = np.zeros((1, opts.height // d * up, opts.width // d * up, 3),
                                   np.float32)
            else:
                control = he.preprocess_control(pipe.cfgs, control_image, opts.height,
                                                opts.width)
            control = torch.as_tensor(control, device=pipe.device).permute(0, 3, 1, 2)
            control = control.contiguous()
        elif control_image is not None:
            raise ValueError("control_image given, but this engine runs no ControlNet")
        if pixel_values is None:
            pixel_values = pipe._pixel_values(
                np.zeros((64, 64, 3), np.uint8) if pil_image is None else pil_image)
        else:
            if not isinstance(pixel_values, torch.Tensor):
                pixel_values = torch.from_numpy(np.array(pixel_values, np.float32))
            pixel_values = pixel_values[:1].to(pipe.device, torch.float32)
        ids = pipe._ids(prompt or he.DEFAULT_PROMPT, extra_text,
                        negative_prompt or he.DEFAULT_NEGATIVE)
        down = pipe.cfgs.vae.downscale
        shape = (1, opts.height // down, opts.width // down, 4)
        if noise is None:
            noise = pipe._noise(int(seed), 1, shape[1:])
        if not isinstance(noise, torch.Tensor):
            noise = torch.from_numpy(np.array(noise, np.float32))
        noise = noise.to(pipe.device, torch.float32)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise must be {shape}, got {tuple(noise.shape)}")
        return Request(ids=ids, pixel_values=pixel_values,
                       noise=noise.permute(0, 3, 1, 2).contiguous(), time_ids=self.time_ids,
                       control=control)

    def free_slots(self) -> List[int]:
        return [i for i, sl in enumerate(self.slots) if sl.request is None]

    def active(self) -> int:
        return sum(1 for sl in self.slots if sl.request is not None)

    def _program(self, req: Optional[Request] = None) -> EngineProgram:
        """This engine's program: on the first admission the key's program
        from the pipeline's cache (a card) or a new one (the CPU), loaded
        with this engine's schedule. Raises if another engine has taken it
        since."""
        if self.prog is None:
            if req is None:
                raise RuntimeError("no request admitted yet")

            def build():
                return EngineProgram(self.pipe, self.br, self.num_slots, req, self)

            if self.pipe.device.type == "cuda":
                prog = self.pipe.programs.acquire(self.key, build)
            else:
                prog = build()
            with prog.lock:
                if prog.owner is not self:
                    prog.claim(self)
            self.prog = prog
        elif self.prog.owner is not self:
            raise RuntimeError("another SlotEngine of this key has taken its program")
        return self.prog

    @torch.inference_mode()
    def admit(self, request_token, *, pil_image=None, pixel_values=None, prompt=None,
              negative_prompt=None, extra_text=None, seed=0, control_image=None,
              noise=None) -> int:
        """Places a request in a free slot (mid-flight is fine); returns the
        slot; raises if no slot is free."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        i = free[0]
        req = self.prepare(pil_image=pil_image, pixel_values=pixel_values, prompt=prompt,
                           negative_prompt=negative_prompt, extra_text=extra_text, seed=seed,
                           control_image=control_image, noise=noise)
        with device_scope(self.pipe.device):
            prog = self._program(req)
            with prog.lock:
                prog.write_slot(i, req)
        self.slots[i] = _Slot(request=request_token, started=time.time())
        self.last_progress[i] = 0
        return i

    @torch.inference_mode()
    def run_chunk(self):
        """Advances every active row by up to ``chunk`` steps."""
        prog = self._program()
        with device_scope(self.pipe.device), prog.lock:
            prog.run_chunk(self.chunk)

    def progress(self) -> np.ndarray:
        """Each slot's step (a host read of the device's indices; empty
        slots sit at the step count)."""
        if self.prog is None:
            return np.asarray(self.last_progress)
        prog = self._program()
        with device_scope(self.pipe.device), prog.lock:
            steps = prog.index.tolist()
        self.last_progress = steps
        return np.asarray(steps)

    @torch.inference_mode()
    def harvest(self):
        """Decodes and frees the finished slots: [(request token, uint8
        (H, W, 3) image)]."""
        idx = self.progress()
        done = [i for i, sl in enumerate(self.slots)
                if sl.request is not None and idx[i] >= self.num_steps]
        out = []
        prog = self._program()
        with device_scope(self.pipe.device), prog.lock:
            for i in done:
                out.append((self.slots[i].request, he.to_uint8(prog.decode_row(i))[0]))
                self.slots[i] = _Slot()
        return out

    @property
    def latents(self) -> torch.Tensor:
        """The slots' latents (S, h, w, 4), a view of the engine's buffer."""
        return self._program().latents.permute(0, 2, 3, 1)

    @torch.inference_mode()
    def finish(self) -> torch.Tensor:
        """Every slot's output, as the one-call path's finish gives it: the
        latents (S, h, w, 4) for a latent output, else the images
        (S, H, W, 3) in [-1, 1]."""
        prog = self._program()
        with device_scope(self.pipe.device), prog.lock:
            if self.br.latent_output:
                return prog.latents.permute(0, 2, 3, 1).clone()
            return prog.decode_all().clone()

    def close(self):
        """Gives the program back: unpinned, the pipeline's cache may evict
        it."""
        if self.prog is not None and self.prog.owner is self:
            with self.prog.lock:
                self.prog.owner, self.prog.pinned = None, False
        self.prog = None


@torch.inference_mode()
def generate_chunked(pipe, *, pil_image=None, pixel_values=None, prompt=None,
                     negative_prompt=None, extra_text=None, seed=0, num_samples=1,
                     chunk_steps=5, callback_on_step_end: Optional[Callable] = None,
                     output_type="np", control_image=None, controlnet_scale=1.0, noise=None,
                     **opts_kw):
    """generate() through the chunked runner: the one-call path's edit, with
    ``callback_on_step_end(step, latents)`` after every chunk (the step all
    rows have reached, the (S, h, w, 4) latents: a view of the engine's
    buffer) - the reference's per-step progress callback. The initial noise
    is the one-call path's draw (``seed`` an int or a list, or ``noise``).
    ``control_image``: every row's, through the pipeline's ControlNet at
    ``controlnet_scale``. ``opts_kw``: ``EditOptions``' fields, with scale
    and num_inference_steps."""
    he.check_output_type(output_type)
    opts = he.EditOptions(use_harmony=extra_text is not None,
                          ip_scale=opts_kw.pop("scale", 1.0),
                          num_inference_steps=opts_kw.pop("num_inference_steps", 30),
                          return_latents=output_type == "latent", **opts_kw)
    k = opts.encoder_interval
    if k > 1 and chunk_steps % k:
        # round the chunk up to the key-step quantum: the chunking changes
        # no output
        chunk_steps += k - chunk_steps % k
    if control_image is not None and pipe.cfgs.controlnet is None:
        raise ValueError("control_image given, but the pipeline has no ControlNet")
    eng = SlotEngine(pipe, opts, slots=num_samples, chunk=chunk_steps,
                     use_controlnet=control_image is not None, controlnet_scale=controlnet_scale)
    try:
        down = pipe.cfgs.vae.downscale
        row = (opts.height // down, opts.width // down, 4)
        if noise is None:
            noise = pipe._noise(seed, num_samples, row)
        if not isinstance(noise, torch.Tensor):
            noise = torch.from_numpy(np.array(noise, np.float32))
        if tuple(noise.shape) != (num_samples,) + row:
            raise ValueError(f"noise must be {(num_samples,) + row}, got {tuple(noise.shape)}")
        for i in range(num_samples):
            eng.admit(i, pil_image=pil_image, pixel_values=pixel_values, prompt=prompt,
                      negative_prompt=negative_prompt, extra_text=extra_text,
                      control_image=control_image, noise=noise[i:i + 1])
        done = 0
        while done < eng.num_steps:
            eng.run_chunk()
            done = int(eng.progress().min())
            if callback_on_step_end is not None:
                callback_on_step_end(done, eng.latents)
        out = eng.finish()
    finally:
        eng.close()
    return he.HarmonyPipeline._output(out, eng.br.latent_output, output_type)
