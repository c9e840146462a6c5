"""Batched multi-prompt editing service (port of
imagharmony_tpu/pipelines/serving.py, the reference demo.py path).

A dependency-free HTTP server with a minimal HTML front end and a JSON API,
in front of one of two workers:

* ``BatchingWorker`` packs concurrent requests with identical static
  options (size, steps, scheduler, ...) into one ``generate_batch`` call:
  one program, the CFG pairs of every request on the batch axis;
* ``ContinuousWorker`` keeps a ``continuous.SlotEngine`` running and
  admits requests into free slots at chunk boundaries, mid-flight.

All device work runs on the worker's thread, under
``torch.cuda.device(pipe.device)`` on a card: a CUDA graph capture fails
when another thread touches the device meanwhile. The HTTP handler threads
do host work only (JSON, base64 and PIL).

API:
  GET  /           -> HTML demo page
  GET  /healthz    -> {"ok": true}
  GET  /status     -> the worker's state (the engine's slot steps)
  POST /edit       -> JSON {image: b64, prompt, extra_text, negative_prompt,
                      scale, guidance_scale, steps, seed, height, width, ...}
                      -> {"image": b64 PNG, "seconds": float}

Run: ``python -m imagharmony_tpu_torch.pipelines.serving [--model-dir DIR
--adapter-ckpt CKPT] [--continuous] [--device cpu]``; without a model
directory it serves the random tiny pipeline.
"""

from __future__ import annotations

import argparse
import base64
import collections
import io
import json
import logging
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from imagharmony_tpu_torch.pipelines import continuous
from imagharmony_tpu_torch.pipelines.harmony_edit import (EditOptions, HarmonyPipeline,
                                                          check_chunked)

log = logging.getLogger("imagharmony_torch.serving")

_HTML = """<!doctype html><title>IMAGHarmony</title>
<h2>IMAGHarmony &mdash; quantity & layout consistent editing</h2>
<form id=f>
<input type=file id=img accept=image/*><br>
prompt: <input id=prompt value="a dog" size=40><br>
extra text: <input id=extra value="six dogs" size=40><br>
steps: <input id=steps value=30 size=4> scale: <input id=scale value=1.0 size=4>
guidance: <input id=cfg value=5.0 size=4> seed: <input id=seed value=42 size=6><br>
<button type=submit>Edit</button></form>
<p id=status></p><img id=out style="max-width:512px">
<script>
f.onsubmit = async (e) => {
  e.preventDefault(); status.textContent = 'running...';
  const file = img.files[0];
  const b64 = file ? await new Promise(r => {const fr=new FileReader();
    fr.onload=()=>r(fr.result.split(',')[1]); fr.readAsDataURL(file);}) : null;
  const body = {image: b64, prompt: prompt.value, extra_text: extra.value,
    steps: +steps.value, scale: +scale.value, guidance_scale: +cfg.value, seed: +seed.value};
  const resp = await fetch('/edit', {method:'POST', body: JSON.stringify(body)});
  const j = await resp.json();
  if (j.error) { status.textContent = 'error: ' + j.error; return; }
  out.src = 'data:image/png;base64,' + j.image;
  status.textContent = j.seconds.toFixed(1) + 's';
};
</script>"""


class _Request:
    """One request: its payload, its batch key (computed here, so a
    malformed field raises ValueError in the submitting thread, not in the
    worker's), the event set when it is answered, its result or error."""

    def __init__(self, payload):
        self.payload = payload
        self.key = self._key()
        self.event = threading.Event()
        self.result = None
        self.error = None

    def batch_key(self):
        return self.key

    def _key(self):
        """The static options a device batch shares (the JAX package's key,
        field for field)."""
        p = self.payload
        if not isinstance(p, dict):
            raise ValueError(f"the payload must be a JSON object, got {type(p).__name__}")
        return (
            int(p.get("height", 1024)),
            int(p.get("width", 1024)),
            int(p.get("steps", 30)),
            str(p.get("scheduler", "euler")),
            float(p.get("guidance_scale", 5.0)),
            float(p.get("scale", 1.0)),
            # ControlNet participation is a property of the program
            bool(p.get("control_image")),
            float(p.get("controlnet_scale", 1.0)),
            # encoder propagation changes the program and the outputs
            int(p.get("encoder_interval", 1)),
            str(p.get("prediction_type", "epsilon")),
            bool(p.get("zero_snr")),
            # the schedule's shape and the CFG rescale
            str(p.get("timestep_spacing", "leading")),
            bool(p.get("use_karras_sigmas")),
            float(p.get("guidance_rescale", 0.0)),
            int(p.get("clip_skip", 0)),
            # weighted prompts and img2img/inpaint run per request
            bool(p.get("prompt_weighting")),
            # text-to-image is another program than an image-prompted edit
            bool(p.get("image")),
            bool(p.get("init_image")),
            bool(p.get("mask_image")),
        )


def _png_b64(img) -> str:
    """A PIL image or uint8 HWC array as base64 PNG."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class BatchingWorker(threading.Thread):
    """Packs compatible queued requests into one device batch.

    Requests sharing a ``batch_key`` are merged up to ``max_batch`` and run
    as one ``generate_batch`` call; each brings its image, prompt and seed
    row. A group that fails to pack falls back to one ``generate`` a
    request, loudly: the traceback is logged and ``pack_errors`` counts it
    (on the same device and kernels)."""

    def __init__(self, pipe, *, max_batch=4, max_wait_s=0.05):
        super().__init__(daemon=True)
        self.pipe = pipe
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self.running = True
        self.pack_errors = 0  # packed batches that fell back to per-request

    def submit(self, payload) -> _Request:
        req = _Request(payload)
        self.q.put(req)
        return req

    def stop(self, timeout=None):
        self.running = False
        self.join(timeout)

    def run(self):
        with continuous.device_scope(self.pipe.device):
            while self.running:
                try:
                    first = self.q.get(timeout=0.2)
                except queue.Empty:
                    continue
                group = [first]
                deadline = time.time() + self.max_wait_s
                while len(group) < self.max_batch and time.time() < deadline:
                    try:
                        nxt = self.q.get(timeout=max(0.0, deadline - time.time()))
                    except queue.Empty:
                        break
                    if nxt.batch_key() == first.batch_key():
                        group.append(nxt)
                    else:
                        self.q.put(nxt)
                        break
                self._run_group(group)

    def _run_group(self, group):
        first = group[0].payload
        if len(group) > 1 and not (first.get("init_image") or first.get("mask_image")
                                   or first.get("prompt_weighting")):
            try:
                self._run_packed(group)
                return
            except Exception:
                # a packing bug must surface, not hide behind the fallback
                log.error("packed batch of %d failed; falling back to per-request:\n%s",
                          len(group), traceback.format_exc())
                self.pack_errors += 1
        for req in group:
            try:
                req.result = self._run_one(req.payload)
            except Exception as e:  # surfaces to the HTTP client
                req.error = f"{type(e).__name__}: {e}"
            req.event.set()

    def _run_packed(self, group):
        """The group as one program (``HarmonyPipeline.generate_batch``)."""
        t0 = time.time()
        payloads = [r.payload for r in group]
        first = payloads[0]
        extra_texts = [p.get("extra_text") or None for p in payloads]
        if any(e is None for e in extra_texts) and any(e is not None for e in extra_texts):
            raise ValueError("mixed extra_text presence; fall back")
        control_images = None
        if first.get("control_image"):  # the batch key makes it all or none
            control_images = [_payload_control(p) for p in payloads]
        outs = self.pipe.generate_batch(
            [_payload_image(p) for p in payloads],
            [p.get("prompt") or None for p in payloads],
            extra_texts=extra_texts if extra_texts[0] is not None else None,
            negative_prompts=[p.get("negative_prompt") or None for p in payloads],
            seeds=[int(p.get("seed", 42)) for p in payloads],
            control_images=control_images,
            num_inference_steps=int(first.get("steps", 30)),
            guidance_scale=float(first.get("guidance_scale", 5.0)),
            scale=float(first.get("scale", 1.0)),
            controlnet_scale=float(first.get("controlnet_scale", 1.0)),
            height=int(first.get("height", 1024)),
            width=int(first.get("width", 1024)),
            scheduler=str(first.get("scheduler", "euler")),
            encoder_interval=int(first.get("encoder_interval", 1)),
            prediction_type=str(first.get("prediction_type", "epsilon")),
            rescale_zero_snr=bool(first.get("zero_snr")),
            timestep_spacing=str(first.get("timestep_spacing", "leading")),
            use_karras=bool(first.get("use_karras_sigmas")),
            guidance_rescale=float(first.get("guidance_rescale", 0.0)),
            clip_skip=int(first.get("clip_skip", 0)),
            output_type="np",
        )
        dt = time.time() - t0
        for req, im in zip(group, outs):
            req.result = {"image": _png_b64(im), "seconds": dt, "batched": len(group)}
            req.event.set()

    def _run_one(self, p):
        t0 = time.time()
        out = self.pipe.generate(
            _payload_image(p),
            prompt=p.get("prompt") or None,
            negative_prompt=p.get("negative_prompt") or None,
            extra_text=p.get("extra_text") or None,
            scale=float(p.get("scale", 1.0)),
            guidance_scale=float(p.get("guidance_scale", 5.0)),
            num_inference_steps=int(p.get("steps", 30)),
            seed=int(p.get("seed", 42)),
            height=int(p.get("height", 1024)),
            width=int(p.get("width", 1024)),
            scheduler=str(p.get("scheduler", "euler")),
            control_image=_payload_control(p),
            controlnet_conditioning_scale=float(p.get("controlnet_scale", 1.0)),
            encoder_interval=int(p.get("encoder_interval", 1)),
            prediction_type=str(p.get("prediction_type", "epsilon")),
            rescale_zero_snr=bool(p.get("zero_snr")),
            timestep_spacing=str(p.get("timestep_spacing", "leading")),
            use_karras_sigmas=bool(p.get("use_karras_sigmas")),
            guidance_rescale=float(p.get("guidance_rescale", 0.0)),
            clip_skip=int(p.get("clip_skip", 0)),
            prompt_weighting=bool(p.get("prompt_weighting")),
            init_image=_payload_b64_image(p.get("init_image")),
            mask_image=_payload_b64_image(p.get("mask_image")),
            strength=float(p["strength"]) if p.get("strength") is not None else None,
            output_type="np",
        )[0]
        return {"image": _png_b64(out), "seconds": time.time() - t0}


def _payload_b64_image(b64str):
    """An optional base64 PNG/JPEG payload field -> PIL image, or None."""
    from PIL import Image

    if not b64str:
        return None
    return Image.open(io.BytesIO(base64.b64decode(b64str)))


def _payload_image(p):
    """The reference image, or None: a request without one runs plain
    text-to-image."""
    return _payload_b64_image(p.get("image"))


def _payload_control(p):
    """The optional control_image field -> RGB array (for the pipeline's
    ControlNet)."""
    img = _payload_b64_image(p.get("control_image"))
    return None if img is None else np.asarray(img.convert("RGB"))


class ContinuousWorker(threading.Thread):
    """Continuous batching: requests join a running batch at denoise-step
    granularity instead of waiting for the current program to finish.

    The device keeps ``max_batch`` request slots advanced ``chunk`` steps at
    a time (``continuous.SlotEngine``); at every chunk boundary finished
    slots are decoded and freed, and queued requests with the same static
    options are admitted into free slots mid-flight. Requests of another
    batch key wait until the engine drains; once one has waited longer than
    ``fairness_timeout_s``, same-key admissions younger than it pause so the
    engine drains (steady same-key traffic would starve it otherwise)."""

    def __init__(self, pipe, *, max_batch=4, chunk=5, fairness_timeout_s=30.0):
        super().__init__(daemon=True)
        self.pipe = pipe
        self.max_batch = max_batch
        self.chunk = chunk
        self.fairness_timeout_s = fairness_timeout_s
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self.running = True
        self.pack_errors = 0
        self._engine = None
        # (wall time, the engine's least step at the admission), bounded
        self.admissions = collections.deque(maxlen=4096)
        self.total_admissions = 0

    def submit(self, payload) -> _Request:
        req = _Request(payload)
        req._t0 = time.time()
        self.q.put(req)
        return req

    def stop(self, timeout=None):
        self.running = False
        self.join(timeout)

    def _make_engine(self, req):
        p = req.payload
        # what the chunked runner does not run fails the request, rather
        # than answering it with another edit (the batch key holds these)
        check_chunked(prompt_weighting=bool(p.get("prompt_weighting")),
                      init_image=p.get("init_image") or None,
                      mask_image=p.get("mask_image") or None)
        opts = EditOptions(
            height=int(p.get("height", 1024)),
            width=int(p.get("width", 1024)),
            num_inference_steps=int(p.get("steps", 30)),
            scheduler=str(p.get("scheduler", "euler")),
            guidance_scale=float(p.get("guidance_scale", 5.0)),
            ip_scale=float(p.get("scale", 1.0)),
            use_harmony=bool(p.get("extra_text")),
            encoder_interval=int(p.get("encoder_interval", 1)),
            prediction_type=str(p.get("prediction_type", "epsilon")),
            rescale_zero_snr=bool(p.get("zero_snr")),
            timestep_spacing=str(p.get("timestep_spacing", "leading")),
            use_karras=bool(p.get("use_karras_sigmas")),
            guidance_rescale=float(p.get("guidance_rescale", 0.0)),
            clip_skip=int(p.get("clip_skip", 0)),
        )
        chunk = self.chunk
        if opts.encoder_interval > 1 and chunk % opts.encoder_interval:
            chunk += opts.encoder_interval - chunk % opts.encoder_interval
        return continuous.SlotEngine(self.pipe, opts, slots=self.max_batch, chunk=chunk,
                                     use_controlnet=bool(p.get("control_image")),
                                     controlnet_scale=float(p.get("controlnet_scale", 1.0)))

    def _admit(self, engine, req):
        p = req.payload
        img = _payload_image(p)
        engine.admit(
            req,
            pil_image=np.asarray(img.convert("RGB")) if img is not None else None,
            prompt=p.get("prompt") or None,
            negative_prompt=p.get("negative_prompt") or None,
            extra_text=p.get("extra_text") or None,
            seed=int(p.get("seed", 42)),
            control_image=_payload_control(p),
        )

    def status(self):
        """The engine's state for GET /status: the slots' steps as the
        worker last read them (no device access from the caller's
        thread)."""
        eng = self._engine
        if eng is None:
            return {"mode": "continuous", "active": 0, "queued": self.q.qsize(),
                    "admissions": self.total_admissions, "pack_errors": self.pack_errors}
        return {
            "mode": "continuous",
            "active": eng.active(),
            "queued": self.q.qsize(),
            "num_steps": eng.num_steps,
            "slot_steps": [int(s) if sl.request is not None else None
                           for s, sl in zip(eng.last_progress, eng.slots)],
            "admissions": self.total_admissions,
            "pack_errors": self.pack_errors,
        }

    def _drop_engine(self, engine):
        engine.close()
        self._engine = None

    def run(self):
        with continuous.device_scope(self.pipe.device):
            self._loop()

    def _loop(self):
        engine = None
        key = None
        pending = []
        self._engine = None
        while self.running:
            try:
                pending.append(self.q.get(timeout=0.02 if engine else 0.2))
            except queue.Empty:
                pass
            # burst drain: a burst fills every free slot at this boundary
            while True:
                try:
                    pending.append(self.q.get_nowait())
                except queue.Empty:
                    break
            now = time.time()
            for req in pending:
                if not hasattr(req, "_pend_t0"):
                    req._pend_t0 = now
            starved = [r for r in pending if now - r._pend_t0 > self.fairness_timeout_s]
            if engine is None and pending:
                # build for the longest-starved request, if any
                first = min(starved, key=lambda r: r._pend_t0) if starved else pending[0]
                try:
                    engine = self._make_engine(first)
                    self._engine = engine
                    key = first.batch_key()
                except Exception as e:
                    log.error("continuous engine init failed: %s", e)
                    first.error = f"{type(e).__name__}: {e}"
                    first.event.set()
                    pending.remove(first)
                    continue
            if engine is None:
                continue

            # fairness: while a request of another key is starved, same-key
            # requests younger than it wait, so the engine drains
            oldest_mismatch = min((r._pend_t0 for r in starved if r.batch_key() != key),
                                  default=None)
            still = []
            for req in pending:
                if (req.batch_key() == key and engine.free_slots()
                        and (oldest_mismatch is None or req._pend_t0 <= oldest_mismatch)):
                    mid = int(engine.progress().min()) if engine.active() else 0
                    try:
                        self._admit(engine, req)
                        self.admissions.append((time.time(), mid))
                        self.total_admissions += 1
                    except Exception as e:
                        log.error("admission failed:\n%s", traceback.format_exc())
                        self.pack_errors += 1
                        req.error = f"{type(e).__name__}: {e}"
                        req.event.set()
                else:
                    still.append(req)
            pending = still

            if engine.active():
                try:
                    engine.run_chunk()
                    for req, img in engine.harvest():
                        req.result = {"image": _png_b64(img),
                                      "seconds": time.time() - getattr(req, "_t0", time.time()),
                                      "continuous": True}
                        req.event.set()
                except Exception as e:
                    # a failed chunk or decode fails its requests, not the worker
                    log.error("continuous chunk failed:\n%s", traceback.format_exc())
                    self.pack_errors += 1
                    for sl in engine.slots:
                        if sl.request is not None:
                            sl.request.error = f"{type(e).__name__}: {e}"
                            sl.request.event.set()
                    self._drop_engine(engine)
                    engine = None
            else:
                # idle: what is pending needs another key; drain so the next
                # iteration builds its engine
                self._drop_engine(engine)
                engine = None
        if engine is not None:
            self._drop_engine(engine)


def make_server(pipe, port=7860, *, continuous=False, payload_defaults=None, host="0.0.0.0",
                **worker_kw):
    """A ThreadingHTTPServer (not yet serving) over a started worker
    (``server.worker``); ``continuous`` picks ``ContinuousWorker`` over
    ``BatchingWorker``. ``payload_defaults`` fill fields a request leaves
    out. Port 0 takes a free port (``server.server_address``)."""
    worker_cls = ContinuousWorker if continuous else BatchingWorker
    worker = worker_cls(pipe, **worker_kw)
    worker.start()
    payload_defaults = payload_defaults or {}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, json.dumps({"ok": True}))
            elif self.path == "/status":
                if hasattr(worker, "status"):
                    self._send(200, json.dumps(worker.status()))
                else:
                    self._send(200, json.dumps({"mode": "packed", "queued": worker.q.qsize(),
                                                "pack_errors": worker.pack_errors}))
            elif self.path == "/":
                self._send(200, _HTML, "text/html")
            else:
                self._send(404, json.dumps({"error": "not found"}))

        def do_POST(self):
            if self.path != "/edit":
                self._send(404, json.dumps({"error": "not found"}))
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except ValueError as e:  # a bad length or body
                self._send(400, json.dumps({"error": str(e)}))
                return
            try:
                for k, v in payload_defaults.items():
                    payload.setdefault(k, v)
                req = worker.submit(payload)
            except (AttributeError, TypeError, ValueError) as e:  # a malformed field
                self._send(400, json.dumps({"error": f"{type(e).__name__}: {e}"}))
                return
            req.event.wait()
            if req.error:
                self._send(500, json.dumps({"error": req.error}))
            else:
                self._send(200, json.dumps(req.result))

    server = ThreadingHTTPServer((host, port), Handler)
    server.worker = worker
    return server


def build_server(args):
    """The server ``main`` runs, not yet serving: a pipeline (the tree of
    ``--model-dir`` with ``--adapter-ckpt``, or without one the random tiny
    pipeline, demo mode) on ``args.device`` in the CLI's dtype for it, with
    the CLI's ``--lora`` merges and ``--textual-inversion`` installs
    (``cli._merge_loras``), behind ``make_server``."""
    from imagharmony_tpu_torch.cli import _dtype, _merge_loras
    from imagharmony_tpu_torch.io import checkpoints

    device = getattr(args, "device", "cuda")
    dtype = _dtype(device)
    if getattr(args, "model_dir", None):
        pipe = checkpoints.load_pipeline(model_dir=args.model_dir, adapter_ckpt=args.adapter_ckpt,
                                         device=device, dtype=dtype)
    else:
        print("no --model-dir: serving the random tiny pipeline (demo mode)")
        pipe = HarmonyPipeline.random_tiny(device=device, dtype=dtype)
    pipe = _merge_loras(pipe, args)
    # encoder propagation by default: changes outputs; a request's own
    # encoder_interval overrides it
    defaults = {"encoder_interval": 2} if getattr(args, "turbo", False) else {}
    continuous = getattr(args, "continuous", False)
    server = make_server(pipe, port=args.port, continuous=continuous,
                         payload_defaults=defaults, host=getattr(args, "host", "0.0.0.0"))
    print(f"serving on http://{server.server_address[0]}:{server.server_address[1]} "
          f"({'continuous' if continuous else 'packed'} batching)")
    return server


def main(args):
    """Serve ``build_server(args)`` until interrupted."""
    server = build_server(args)
    try:
        server.serve_forever()
    finally:
        server.worker.stop()


def build_parser():
    p = argparse.ArgumentParser(description="the batched editing service")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--adapter-ckpt", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--lora", action="append", default=None, metavar="PATH[:SCALE]",
                   help="lora-N.safetensors merged into the UNet at startup (repeatable; "
                        ":SCALE suffix per adapter)")
    p.add_argument("--lora-scale", type=float, default=1.0)
    p.add_argument("--textual-inversion", action="append", default=None,
                   metavar="PATH[:TOKEN]", help="embedding(s) installed at startup")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: admit requests mid-denoise")
    p.add_argument("--turbo", action="store_true",
                   help="encoder_interval 2 for requests that do not set one (changes "
                        "outputs)")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
