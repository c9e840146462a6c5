"""The ported slice as a whole, on the CPU: the port loaded with the JAX
tiny pipeline's weights against the fp32 golden trajectory, the CFG-packed
conditioning against JAX's, generate() with the JAX one-call signature and
the sampler zoo and edit features against the JAX package's generate() in
grouped calls (every step and the output at cosine > 0.9999), the
tokenizer with prompt weighting and textual inversion, io/from_jax, the
checkpoint loader against JAX's on trees the JAX package wrote (SDXL,
SD1.5, the refiner, a ControlNet directory); the serving path:
generate_batch against JAX's, the chunked runner and the slot engine bit
for bit against the one-call path, both workers through make_server, the
program cache, PNS's CLIP scores against JAX's; the variants: ControlNet,
LoRA (ingestion and merge), the refiner and the base -> refiner handoff,
the IP attention maps; the CLI against the JAX CLI; and that the port runs
without JAX."""

import base64
import copy
import dataclasses
import functools
import io
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagharmony_tpu import dtypes as jdt
from imagharmony_tpu.io import hf_import
from imagharmony_tpu.models import tokenizer as jtok
from imagharmony_tpu.pipelines import HarmonyPipeline as JaxPipeline
from imagharmony_tpu.pipelines import harmony_edit as jhe
from imagharmony_tpu.schedulers import diffusion as jsched
from imagharmony_tpu_torch.io import checkpoints as pckpt
from imagharmony_tpu_torch.io import hf_import as hf_import_torch
from imagharmony_tpu_torch.io import from_jax
from imagharmony_tpu_torch.models import tokenizer as ptok
from imagharmony_tpu_torch.kernels import cross_attention as pca
from imagharmony_tpu_torch.pipelines import components as pcomp
from imagharmony_tpu_torch.pipelines import continuous as pcont
from imagharmony_tpu_torch.pipelines import harmony_edit as phe
from imagharmony_tpu_torch.pipelines import pns as ppns
from imagharmony_tpu_torch.pipelines import programs as pprog
from imagharmony_tpu_torch.pipelines import serving as pserving
from imagharmony_tpu_torch.schedulers import diffusion as psched
from imagharmony_tpu_torch.utils import parity
from torch_port_util import (close, controlnet_pipes, edit_parity, nonzero_controlnet_outputs,
                             refiner_pipes, tiny_pipes)

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "goldens" / "tiny_edit_fp32.npz"


@pytest.fixture(scope="module")
def pipes():
    """(JAX tiny pipeline, the port over the same weights, fp32 on the CPU)."""
    return tiny_pipes()


def _image():
    return np.random.default_rng(0).integers(0, 255, (48, 48, 3), dtype=np.uint8)


def test_tiny_edit_matches_golden(pipes, tmp_path, monkeypatch):
    """The call and thresholds of tests/test_golden.py, with the golden's
    initial noise handed to the port, through the denoise loop's body that
    generate() runs; generate() gives the capture's image bit for bit. And
    PNS: ``clip_scores`` (an antialiased bilinear resize into the bigG
    joint space) against JAX's (abs <= 1e-5), and ``generate_with_pns``
    keeping the argmax of K seeds' scores. Then the evaluation tools
    against the JAX package's (``_check_eval_tools``), and profiling's
    ``trace``, ``annotate`` and ``StepTimer`` around a CPU generate()."""
    _, port = pipes
    gold = parity.load(GOLDEN)
    cap = parity.run_capture(port, _image(), prompt="a dog", extra_text="six dogs",
                             steps=3, height=32, width=32, seed=5, noise=gold["noise"])
    rep = parity.compare(cap, gold)
    assert rep["min_cosine"] > 0.9999, rep
    assert rep["image_cosine"] > 0.9999, rep
    # generate() runs the same body (harmony_edit.denoise_step) on the CPU
    img = port.generate(_image(), prompt="a dog", extra_text="six dogs", num_inference_steps=3,
                        height=32, width=32, noise=gold["noise"], output_type="raw")
    np.testing.assert_array_equal(img.numpy(), cap["image"])
    # the base/refiner handoff: denoising_end returns JAX's latents, which
    # denoising_start takes (each side a grouped call against JAX's)
    jpipe, _ = pipes
    _, lat = edit_parity(jpipe, port, _image(), steps=5, denoising_end=0.6)
    assert lat.shape == (1, 16, 16, 4)
    edit_parity(jpipe, port, _image(), steps=5, denoising_start=0.6, latents=lat)

    # PNS: 64x48 images shrunk to the tiny tower's 28x28, where JAX's
    # bilinear resize antialiases (F.interpolate's default would not: the
    # scores then differ by ~1e-3)
    from imagharmony_tpu.pipelines import pns as jpns

    imgs = np.random.default_rng(1).uniform(-1, 1, (3, 64, 48, 3)).astype(np.float32)
    ref = jpns.clip_scores(jpipe.params, jpipe.cfgs, jnp.asarray(imgs),
                           jpipe._tokenize("a dog")[1], policy=jpipe.policy)
    close(ppns.clip_scores(port.components, torch.as_tensor(imgs), port._tokenize("a dog")[1]),
          ref, rtol=0, atol=1e-5)
    best, images, scores = ppns.generate_with_pns(
        port, _image(), num_seeds=3, prompt="a dog", extra_text="six dogs",
        num_inference_steps=2, height=32, width=32, return_all=True, output_type="np")
    assert len(images) == 3 and scores.shape == (3,) and np.abs(scores).max() <= 1.0 + 1e-5
    np.testing.assert_array_equal(best, images[int(np.argmax(scores))])

    # CLIP-I and CLIP-T (utils/clip_metrics.py) against JAX's, floats and
    # uint8, a single reference broadcast over the edited images
    from imagharmony_tpu.utils import clip_metrics as jcm
    from imagharmony_tpu_torch.utils import clip_metrics as pcm

    u8 = np.random.default_rng(2).integers(0, 255, (3, 40, 56, 3), dtype=np.uint8)
    for edited, reference in ((imgs, u8[:1]), (u8, imgs), (u8, u8[:1])):
        close(pcm.clip_i(port, edited, reference), jcm.clip_i(jpipe, edited, reference),
              rtol=0, atol=1e-5)
    for edited in (imgs, u8):
        close(pcm.clip_t(port, edited, "a dog"), jcm.clip_t(jpipe, edited, "a dog"),
              rtol=0, atol=1e-5)
    close(pcm.image_embeds(port, u8), jcm.image_embeds(jpipe, u8), rtol=0, atol=1e-5)

    _check_eval_tools(jpipe, port, tmp_path, monkeypatch)

    from imagharmony_tpu_torch.utils import profiling

    timer = profiling.StepTimer()
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("denoise"):
            out = port.generate(_image(), prompt="a dog", num_inference_steps=1, height=32,
                                width=32, output_type="raw")
    timer.lap(sync_on=(out, {"image": out}))
    [path] = (tmp_path / "trace").glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "denoise" in names, names
    assert len(timer.history) == 1 and timer.mean >= 0


class _JaxNoise:
    """A pipeline whose generate() starts from the JAX package's initial
    noise for the seed it is given (the frameworks draw different numbers
    from one seed; ``edit_parity`` hands the port JAX's noise the same
    way); everything else is the pipeline's."""

    def __init__(self, pipe):
        self._pipe = pipe

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate(self, *args, seed, height, width, **kw):
        down = self._pipe.cfgs.vae.downscale
        noise = jax.random.normal(jax.random.PRNGKey(seed), (1, height // down, width // down, 4))
        return self._pipe.generate(*args, seed=seed, height=height, width=width,
                                   noise=np.asarray(noise, np.float32), **kw)


def _jax_tool(name):
    """The JAX package's tools/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_eval_tools(jpipe, port, tmp_path, monkeypatch):
    """The port's tools/eval_benchmark.py and validate_presets.py against
    the JAX package's, each run once through its ``main`` on the CPU: the
    JAX tools unchanged on the fp32 JAX tiny pipeline, the port's on the
    port over the same weights, started from JAX's noise for the seed. The
    eval at 2 synthetic records, 2 steps, 32²: each record's CLIP-T and
    CLIP-I within 1e-3 of JAX's, the files' keys JAX's, the last line the
    summary written. The presets: ``presets`` is the JAX tool's table at 2,
    5 and 30 steps; at 2 steps, 32², the exact and fast+turbo rows (raw
    cosine and CLIP-I against exact, CLIP-T) within 1e-3 of the JAX tool's
    (fast and turbo, each a JAX compile of its own, are left out for CPU
    time), the report and the PNGs written."""
    from PIL import Image

    from imagharmony_tpu_torch.tools import eval_benchmark as pev
    from imagharmony_tpu_torch.tools import validate_presets as pvp

    jdir, pdir = tmp_path / "jax_eval", tmp_path / "port_eval"
    monkeypatch.setattr(JaxPipeline, "random_tiny", classmethod(lambda cls, seed=0: jpipe))
    for tool in (pev, pvp):  # each tool's main imports the builder by name
        monkeypatch.setattr(tool, "build_pipeline", lambda args: _JaxNoise(port))
    argv = ["--random", "tiny", "--steps", "2"]
    monkeypatch.setattr(sys, "argv", ["eval_benchmark.py", *argv, "--synthetic", "2",
                                      "--out_dir", str(jdir)])
    _jax_tool("eval_benchmark").main()
    summary = pev.main([*argv, "--synthetic", "2", "--device", "cpu", "--out_dir", str(pdir)])
    read = lambda d: ([json.loads(line) for line in (d / "records.jsonl").read_text()
                       .splitlines()], json.loads((d / "summary.json").read_text()))
    (jrows, jsum), (prows, psum) = read(jdir), read(pdir)
    assert psum == summary and len(prows) == 2
    assert set(psum) == set(jsum) and [set(r) for r in prows] == [set(r) for r in jrows]
    assert {k: psum[k] for k in ("n", "steps", "res", "weights")} == \
        {k: jsum[k] for k in ("n", "steps", "res", "weights")}
    for p, j in zip(prows, jrows):
        assert p["text"] == j["text"] and p["index"] == j["index"], (p, j)
        assert abs(p["clip_t"] - j["clip_t"]) <= 1e-3 and abs(p["clip_i"] - j["clip_i"]) <= 1e-3, \
            (p, j)

    jvp = _jax_tool("validate_presets")
    seen = []

    class Done(Exception):
        pass

    class TableOnly:  # records the presets' options; stops before any scoring
        def generate(self, **kw):
            seen.append(kw)
            if len(seen) % 4 == 0:
                raise Done
            return np.full((1, 8, 8, 3), 0.5, np.float32)

    base = {"pil_image", "prompt", "extra_text", "guidance_scale", "seed", "height", "width",
            "output_type"}
    for steps in (2, 5, 30):
        monkeypatch.setattr(jvp, "build_pipe", lambda args: TableOnly())
        monkeypatch.setattr(sys, "argv", ["validate_presets.py", "--random", "tiny", "--steps",
                                          str(steps), "--out_dir", str(tmp_path / "table")])
        with pytest.raises(Done):
            jvp.main()
        table = [{k: v for k, v in kw.items() if k not in base} for kw in seen[-4:]]
        assert table == list(pvp.presets(steps).values()) and list(pvp.PRESETS) == [
            "exact", "fast", "turbo", "fast+turbo"], (steps, table)

    compared = ("exact", "fast+turbo")
    which = lambda kw: tuple(kw.get(k) for k in ("num_inference_steps", "timestep_spacing",
                                                 "encoder_interval"))
    run_jax = {which(pvp.presets(2)[name]) for name in compared}

    class TwoPresets:  # the JAX pipeline for exact and fast+turbo, a stand-in for the others
        def __getattr__(self, name):
            return getattr(jpipe, name)

        def generate(self, **kw):
            if which(kw) in run_jax:
                return jpipe.generate(**kw)
            return np.full((1, 32, 32, 3), 0.5, np.float32)

    jout, pout = tmp_path / "jax_presets", tmp_path / "port_presets"
    monkeypatch.setattr(jvp, "build_pipe", lambda args: TwoPresets())
    monkeypatch.setattr(sys, "argv", ["validate_presets.py", *argv, "--out_dir", str(jout)])
    jvp.main()
    jrep = json.loads((jout / "report.json").read_text())
    prep = pvp.main([*argv, "--device", "cpu", "--out_dir", str(pout)])
    assert prep == json.loads((pout / "report.json").read_text())
    assert prep["inputs"] == jrep["inputs"] and list(prep) == list(jrep)
    assert [set(prep[n]) for n in pvp.PRESETS] == [set(jrep[n]) for n in pvp.PRESETS]
    for name in compared:
        for key in set(jrep[name]) - {"seconds"}:
            assert abs(prep[name][key] - jrep[name][key]) <= 1e-3, (name, key, prep, jrep)
    pngs = sorted(pout.glob("*.png"))
    assert [p.name for p in pngs] == ["exact.png", "fast.png", "fast_turbo.png", "turbo.png"]
    assert all(np.asarray(Image.open(p)).shape == (32, 32, 3) for p in pngs)


def test_build_conditioning_matches_jax(pipes):
    """CFG-packed [uncond | cond] conditioning with num_samples=2. Then
    ``generate_batch``, whose B requests' ids are B rows: three requests
    with their own images, prompts, extra_texts, negative prompts and seeds,
    3 steps, on JAX's noise, against JAX's ``generate_batch`` (image cosine
    > 0.9999 a row); without extra_texts at four rows (the decode row by
    row), 2 steps, against the port's own generate() of each request (max
    abs <= 1e-5). And the IP attention-map probe: every live IP layer's
    probabilities against JAX ``_probe_jit`` on the same numpy noise, then
    ``postprocess_ip_probs`` (both compositions) and ``heatmap_to_pil``
    against JAX's."""
    jpipe, port = pipes
    _attn_maps(jpipe, port)
    opts_j = jhe.EditOptions(height=32, width=32)
    opts_p = phe.EditOptions(height=32, width=32)
    ids_j, ids_p = {}, {}
    for name, text in (("pos", "a dog"), ("neg", "lowres"), ("extra", "six dogs")):
        ids_j[f"{name}_l"], ids_j[f"{name}_g"] = jpipe._tokenize(text)
        ids_p[f"{name}_l"], ids_p[f"{name}_g"] = port._tokenize(text)
    px = port._pixel_values(_image())
    build = jax.jit(functools.partial(jhe.build_conditioning, cfgs=jpipe.cfgs, opts=opts_j,
                                      num_samples=2, policy=jdt.FP32))
    ref = build(jpipe.params, ids=ids_j, pixel_values=jnp.asarray(px.numpy()))
    with torch.no_grad():
        out = phe.build_conditioning(port.components, opts_p, ids_p, px, num_samples=2)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        close(o, r)
    # prompt weights on both prompts, the micro-conditioning overrides with
    # their negative rows, and no image: ip2 is None (text-to-image)
    sizes = dict(original_size=(64, 48), crops_coords_top_left=(4, 8), target_size=(40, 32),
                 negative_original_size=(16, 16), negative_crops_coords_top_left=(2, 0))
    opts_j, opts_p = jhe.EditOptions(height=32, width=32, **sizes), \
        phe.EditOptions(height=32, width=32, **sizes)
    w = np.linspace(0.5, 1.5, ids_p["pos_l"].shape[1], dtype=np.float32)[None]
    ids_j.update(pos_w=jnp.asarray(w), neg_w=jnp.asarray(w[:, ::-1]))
    ids_p.update(pos_w=torch.as_tensor(w), neg_w=torch.as_tensor(w[:, ::-1].copy()))
    ref = jax.jit(functools.partial(jhe.build_conditioning, cfgs=jpipe.cfgs, opts=opts_j,
                                    num_samples=2, policy=jdt.FP32))(
        jpipe.params, ids=ids_j, pixel_values=None)
    with torch.no_grad():
        out = phe.build_conditioning(port.components, opts_p, ids_p, None, num_samples=2)
    assert out[3] is None and ref[3] is None
    for o, r in zip(out[:3], ref[:3]):
        close(o, r)
    np.testing.assert_array_equal(phe.time_ids_rows(opts_p).numpy(),
                                  [opts_j.time_ids(negative=True), opts_j.time_ids()])
    # a grouped call: DPM++ 2M Karras, guidance_rescale, the overrides, a
    # negative prompt and clip_skip 1, on three-layer text towers
    jdeep, deep = tiny_pipes(3)
    edit_parity(jdeep, deep, _image(), steps=4, scheduler="dpm++", use_karras_sigmas=True,
                guidance_rescale=0.7, clip_skip=1, negative_prompt="ugly, blurry",
                **{k: v for k, v in sizes.items() if k != "target_size"},
                negative_target_size=(24, 24))

    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 255, (40 + 8 * i, 48, 3), dtype=np.uint8) for i in range(4)]
    reqs = dict(prompts=["a dog", "eight sheep", "a cat", "a bird"],
                extras=["six dogs", "eight sheep", "two cats"],
                negatives=["ugly", None, "blurry"], seeds=[3, 4, 5])
    shared = dict(num_inference_steps=3, height=32, width=32)
    ref = jpipe.generate_batch(imgs[:3], reqs["prompts"][:3], extra_texts=reqs["extras"],
                               negative_prompts=reqs["negatives"], seeds=reqs["seeds"], **shared)
    noise = np.concatenate([np.asarray(jax.random.normal(jax.random.PRNGKey(s), (1, 16, 16, 4),
                                                         jnp.float32)) for s in reqs["seeds"]])
    out = port.generate_batch(imgs[:3], reqs["prompts"][:3], extra_texts=reqs["extras"],
                              negative_prompts=reqs["negatives"], seeds=reqs["seeds"],
                              noise=noise, output_type="raw", **shared)
    assert out.shape == ref.shape == (3, 32, 32, 3)
    for got, want in zip(phe.to_uint8(out), ref):
        assert parity.cosine(got, want) > 0.9999
    shared["num_inference_steps"] = 2
    four = port.generate_batch(imgs, reqs["prompts"], seeds=[1, 2, 3, 4], output_type="raw",
                               **shared)
    for i, (img, prompt) in enumerate(zip(imgs, reqs["prompts"])):
        solo = port.generate(img, prompt=prompt, seed=[i + 1], output_type="raw", **shared)
        torch.testing.assert_close(four[i:i + 1], solo, rtol=0, atol=1e-5)
    assert not torch.equal(four[0], four[1])


def _attn_maps(jpipe, port):
    from PIL import Image

    from imagharmony_tpu.utils import attn_maps as jam
    from imagharmony_tpu_torch.utils import attn_maps as pam

    ids_j, ids_p = {}, {}
    for name, text in (("pos", "a dog"), ("extra", "six dogs")):
        ids_j[f"{name}_l"], ids_j[f"{name}_g"] = jpipe._tokenize(text)
        ids_p[f"{name}_l"], ids_p[f"{name}_g"] = port._tokenize(text)
    px = port._pixel_values(_image())
    noise = np.random.default_rng(8).standard_normal((1, 8, 8, 4)).astype(np.float32)
    ref = jam._probe_jit(jpipe.params, jpipe.cfgs, ids_j, jnp.asarray(px.numpy()),
                         jnp.asarray(noise), timestep=500, latent_size=8, policy=jdt.FP32)
    got = pam.probe(port, ids_p, px, torch.as_tensor(noise).permute(0, 3, 1, 2), timestep=500,
                    latent_size=8)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(r.shape)
        close(g, r)
    probs = [np.asarray(r)[0] for r in ref]
    for kw in (dict(), dict(token_softmax=True, minmax=False)):
        np.testing.assert_allclose(pam.postprocess_ip_probs(probs, 64, **kw),
                                   jam.postprocess_ip_probs(probs, 64, **kw), rtol=0, atol=1e-5)
    maps = jam.postprocess_ip_probs(probs, 64)
    base = Image.fromarray(_image())
    for a, b in zip(pam.heatmap_to_pil(maps, base_image=base),
                    jam.heatmap_to_pil(maps, base_image=base)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_generate_tiny(pipes, tmp_path):
    """generate() end to end on the CPU: uint8 (1, H, W, 3), deterministic
    for a seed, phase timings recorded on request; the output types, seed
    lists, text-to-image and pixel_values; the refusals (unported items
    raise NotImplementedError, bad combinations ValueError, before any
    work); and two grouped calls against the JAX package's generate():
    Euler-a with inpainting, LCM with no CFG and no image. The serving
    entry points: ``edit`` and ``set_scale``; the chunked runner's refusals
    with the JAX package's messages; both workers through ``make_server``
    on a free port (two same-key requests packed, one of another key
    answered, a request admitted mid-flight, a malformed payload refused,
    ``/status``, no pack error); the program cache's bound and locks. Then
    ControlNet and LoRA (``_controlnet_and_lora``), and ``with_mesh``
    (``_check_mesh``)."""
    pipe = phe.HarmonyPipeline.random_tiny(seed=0, device="cpu")
    kw = dict(prompt="a dog", extra_text="six dogs", num_inference_steps=2, height=32,
              width=32, seed=3)
    timings = {}
    a = pipe.generate(_image(), timings=timings, **kw)
    raw = pipe.generate(_image(), output_type="raw", **kw)
    assert a.shape == (1, 32, 32, 3) and a.dtype == np.uint8
    assert raw.shape == (1, 32, 32, 3) and torch.isfinite(raw).all()
    np.testing.assert_array_equal(a, phe.to_uint8(raw))
    assert set(timings) == {"conditioning_s", "denoise_s", "decode_s"}
    with pytest.raises(ValueError, match="noise must be"):
        pipe.generate(_image(), noise=np.zeros((1, 8, 8, 4), np.float32), **kw)
    pil = pipe.generate(_image(), output_type="pil", **kw)
    assert len(pil) == 1 and pil[0].size == (32, 32)
    np.testing.assert_array_equal(np.asarray(pil[0]), a[0])
    lat = pipe.generate(_image(), output_type="latent", **kw)
    assert lat.shape == (1, 16, 16, 4)
    np.testing.assert_array_equal(phe.to_uint8(phe.decode(pipe.components, lat.permute(
        0, 3, 1, 2))), a)
    px = pipe._pixel_values(_image()).numpy()
    np.testing.assert_array_equal(pipe.generate(pixel_values=px, **kw), a)
    t2i = pipe.generate(None, output_type="raw", **kw)
    assert torch.isfinite(t2i).all() and not torch.equal(t2i, raw)
    # a seed list: one generator a sample, so sample i is a run of seed i
    two = dict(kw, seed=[5, 3], num_samples=2)
    call, one = pipe.prepare(_image(), **two), pipe.prepare(_image(), **kw)
    assert torch.equal(call.noise[1:], one.noise)
    out = pipe.generate(_image(), output_type="raw", **two)
    torch.testing.assert_close(out[1:], raw, rtol=0, atol=1e-5)
    refused = [(ValueError, dict(control_image=_image())),  # no ControlNet on this pipeline
               (ValueError, dict(callback_on_step_end=lambda *a: None)),
               (ValueError, dict(chunk_steps=2)),
               (ValueError, dict(mask_image=np.ones((32, 32), np.float32))),
               (ValueError, dict(latents=np.zeros((1, 16, 16, 4), np.float32))),
               (ValueError, dict(init_image=_image(), denoising_start=0.5)),
               (ValueError, dict(init_image=_image(), strength=0.0)),
               (ValueError, dict(scheduler="heun")),
               (ValueError, dict(scheduler="ddim", use_karras_sigmas=True)),
               (ValueError, dict(scheduler="lcm", denoising_end=0.5)),
               (ValueError, dict(output_type="tensor")),
               (ValueError, dict(prediction_type="x0")),
               (ValueError, dict(encoder_interval=0)),
               (ValueError, dict(clip_skip=1)),
               (ValueError, dict(seed=[1, 2])),
               (ValueError, dict(_step_noise=np.zeros((2, 1, 16, 16, 4), np.float32)))]
    for err, extra in refused:
        with pytest.raises(err):
            pipe.prepare(_image(), **dict(kw, **extra))

    jpipe, port = pipes
    mask = np.zeros((32, 32), np.float32)
    mask[8:24, 4:20] = 1.0
    cap, _ = edit_parity(jpipe, port, _image(), scheduler="euler_a", init_image=_image(),
                         mask_image=mask)
    keep = phe.preprocess_mask(mask, 32, 32, 2)[0, :, :, 0] == 0
    assert keep.any() and not keep.all()
    edit_parity(jpipe, port, None, scheduler="lcm", guidance_scale=1.0)

    # the refiner's micro-conditioning: read by that family only, as in JAX
    np.testing.assert_array_equal(pipe.generate(_image(), aesthetic_score=9.0, **kw), a)
    np.testing.assert_array_equal(pipe.edit(_image(), "a dog", "six dogs", **{
        k: v for k, v in kw.items() if k not in ("prompt", "extra_text")}), a)
    pipe.set_scale(0.5)
    np.testing.assert_array_equal(pipe.generate(_image(), **kw), a)  # as JAX: stored only
    # the chunked runner refuses what the JAX package's refuses, with its
    # messages (imagharmony_tpu/pipelines/harmony_edit.py:1098-1125)
    chunked = [(ValueError, "prompt_weighting is not supported", dict(prompt_weighting=True)),
               (ValueError, "refiner-stage inputs", dict(denoising_start=0.5)),
               (ValueError, "euler_a is not supported", dict(scheduler="euler_a")),
               (ValueError, "lcm is not supported", dict(scheduler="lcm")),
               (ValueError, "img2img/inpainting", dict(init_image=_image())),
               (ValueError, "but the pipeline has no ControlNet", dict(control_image=_image())),
               (TypeError, "unexpected keyword", dict(bogus=1))]
    for err, msg, extra in chunked:
        with pytest.raises(err, match=re.escape(msg)):
            pipe.generate(_image(), chunk_steps=2, **dict(kw, **extra))
        if err is ValueError:
            with pytest.raises(err, match=re.escape(msg)):
                jpipe.generate(_image(), chunk_steps=2, **dict(kw, **extra))
    with pytest.raises(ValueError, match="chunk=3 must be a multiple of encoder_interval=2"):
        pcont.SlotEngine(pipe, phe.EditOptions(encoder_interval=2), chunk=3)
    with pytest.raises(ValueError, match="no ControlNet"):
        pipe.generate_batch([_image()], ["a dog"], control_images=[_image()], **{
            k: v for k, v in kw.items() if k not in ("prompt", "extra_text", "seed")})

    _serve_both_modes(pipe)
    _program_cache_units()
    _controlnet_and_lora(tmp_path)
    _check_mesh(pipes, tmp_path, pipe, kw, raw)


def _check_mesh(pipes, tmp_path, pipe, kw, raw):
    """``with_mesh``: in a world of one (a gloo group of this process) the
    TP clone's edit of ``pipe`` is ``raw``, its one-device edit of ``kw``,
    bit for bit; then one spawn of four gloo
    ranks as a 2 x 2 (data x model) mesh (``parallel.drills.edit_drills``)
    on the tiny pipeline's weights and JAX's noise for two samples: the
    ``tensor_parallel=True`` edit (every attention's heads halved: the
    tiny UNet's attentions have 2 or 4) and PNS over a DP clone, whose
    candidates are that clone's edit, against JAX's single-device images,
    per image cosine > 0.999 and max uint8 diff <= 8 (JAX
    test_batch_generate.py's tolerance), ``generate_batch`` on the DP clone
    against the one-device one, bit for bit for 3 requests (which every
    rank computes whole) and at that tolerance for 2 (one a rank), and
    ``_local_call``'s split of packed requests (``_check_local_call``),
    and the PNS scores against JAX's
    single-device scores (atol 5e-3, the same winner; JAX
    test_pns.py's); the UNet forward with TP, and with TP and FSDP
    (``shard_params_tp_fsdp``, JAX's production layout), against the
    one-device UNet's (which test_unet_forward holds to JAX's) at rtol =
    atol = 2e-4 (JAX test_parallel.py's TP check); and ``with_mesh`` then ``with_lora``
    bit for bit ``with_lora`` then ``with_mesh`` (JAX test_lora.py's
    composition). And the sharding itself: a packed projection keeps rank
    r's rows of each of q, k and v, and a layer whose heads the model axis
    does not divide stays whole."""
    import jax
    import jax.numpy as jnp

    from imagharmony_tpu.pipelines import pns as jpns
    from imagharmony_tpu_torch.io import from_jax
    from imagharmony_tpu_torch.parallel import distributed, drills
    from imagharmony_tpu_torch.parallel import mesh as pmesh
    from imagharmony_tpu_torch.utils.parity import cosine
    from torch_port_util import group_of_one

    from imagharmony_tpu_torch.nn.attention import Attention, pack_inference_params
    from imagharmony_tpu_torch.parallel import tp_rules

    second = pmesh.Mesh(n_data=1, n_model=2, world=2, rank=1)
    odd = Attention(24, heads=3, head_dim=8)
    even = pack_inference_params(Attention(16, heads=2, head_dim=8))
    w, w_out = even.to_qkv.weight.detach().clone(), even.to_out[0].weight.detach().clone()
    assert tp_rules.shard_module_tp(second, odd) == 0
    assert odd.heads == 3 and odd.to_q.weight.shape == (24, 24) and odd.to_out[0].tp_group is None
    assert tp_rules.shard_module_tp(second, even) == 1 and even.heads == 1
    torch.testing.assert_close(even.to_qkv.weight, torch.cat([w[8:16], w[24:32], w[40:48]]),
                               rtol=0, atol=0)
    torch.testing.assert_close(even.to_out[0].weight, w_out[:, 8:], rtol=0, atol=0)
    _check_local_call(pipe)

    jpipe, port = pipes
    one_kw = kw
    kw = dict(extra_text="six dogs", num_inference_steps=2, height=32, width=32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 16, 16, 4), jnp.float32))
    _, jimages, jscores = jpns.generate_with_pns(jpipe, _image(), num_seeds=2, seed=3,
                                                 prompt="a dog", return_all=True,
                                                 output_type="np", **kw)
    with group_of_one(tmp_path):
        one = pipe.with_mesh(pmesh.make_mesh(), tensor_parallel=True)
        torch.testing.assert_close(one.generate(_image(), output_type="raw", **one_kw), raw,
                                   rtol=0, atol=0)
    kw = dict(kw, prompt="a dog", num_samples=2, seed=3, noise=noise)

    r = np.random.default_rng
    inputs = dict(
        sample=r(1).standard_normal((2, 8, 8, 4)).astype(np.float32),
        timesteps=np.array([999.0, 10.0], np.float32),
        encoder_hidden_states=r(2).standard_normal((2, 5, 64)).astype(np.float32),
        pooled_text_embeds=r(3).standard_normal((2, 32)).astype(np.float32),
        time_ids=np.tile(np.array([[32, 32, 0, 0, 32, 32]], np.float32), (2, 1)),
        ip_tokens=r(4).standard_normal((2, 4, 64)).astype(np.float32))
    x = {k: torch.as_tensor(v) for k, v in inputs.items()}
    with torch.no_grad():
        one_unet = port.components.unet(
            x["sample"].permute(0, 3, 1, 2), x["timesteps"], x["encoder_hidden_states"],
            pooled_text_embeds=x["pooled_text_embeds"], time_ids=x["time_ids"],
            ip_tokens=x["ip_tokens"], ip_scale=0.7).permute(0, 2, 3, 1).numpy()
    sd = {k: v.numpy() for k, v in from_jax.state_dict(jax.device_get(jpipe.params)).items()}
    ranks = distributed.spawn(drills.edit_drills, 4, threads=1, kwargs=dict(
        state_dict=sd, vocab_size=port.cfgs.text_l.vocab_size, image=_image(), kw=kw,
        unet_inputs=inputs))

    def images_close(got, want):
        assert got.shape == want.shape
        for a, b in zip(got, want):
            assert cosine(a.astype(np.float32), b.astype(np.float32)) > 0.999
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 8

    for rank in ranks:
        assert rank["heads"] and all(a == 2 * b for a, b in rank["heads"]), rank["heads"]
        for got in (rank["tp"], rank["pns"]["images"]):
            images_close(got, np.asarray(jimages))
        np.testing.assert_allclose(rank["pns"]["scores"], jscores, atol=5e-3)
        assert int(np.argmax(rank["pns"]["scores"])) == int(np.argmax(jscores))
        np.testing.assert_allclose(rank["unet"], one_unet, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(rank["unet_tp_fsdp"], one_unet, rtol=2e-4, atol=2e-4)
        assert rank["tp_fsdp_sliced"] > 50, rank["tp_fsdp_sliced"]
        assert rank["lora_equal"] and rank["lora_moved"]
        np.testing.assert_array_equal(rank["tp"], ranks[0]["tp"])
        one, meshed = rank["batch"][3]  # every rank computes all 3 rows
        np.testing.assert_array_equal(meshed, one)
        one, meshed = rank["batch"][2]  # a request a rank
        images_close(meshed, one)


def _check_local_call(pipe):
    """A rank's share of a packed call over a 2-way data axis (no group
    needed): 2 requests of 2 samples give each rank one request and its two
    rows; 3 requests of 2 samples, whose 3-row halves would cross a
    request's edge, leave every rank all 6 rows."""
    import dataclasses

    from imagharmony_tpu_torch.parallel import mesh as pmesh

    for reqs, want in ((2, [(slice(0, 2), slice(0, 1)), (slice(2, 4), slice(1, 2))]),
                       (3, None)):
        call = pipe.prepare_batch([_image()] * reqs, [f"a dog {i}" for i in range(reqs)],
                                  num_inference_steps=1, height=32, width=32)
        call = dataclasses.replace(call, noise=call.noise.repeat_interleave(2, 0))
        assert (call.requests, call.samples) == (reqs, 2)
        for r in range(2):
            local = pipe.with_mesh(pmesh.Mesh(n_data=2, n_model=1, world=2, rank=r))._local_call(
                call)
            if want is None:
                assert local is call
                continue
            rows, req = want[r]
            assert local.rows == (rows.start, rows.stop, 4) and local.samples == 2
            torch.testing.assert_close(local.noise, call.noise[rows], rtol=0, atol=0)
            for k, v in call.ids.items():
                torch.testing.assert_close(local.ids[k], v[req], rtol=0, atol=0)
            torch.testing.assert_close(local.pixel_values, call.pixel_values[req], rtol=0,
                                       atol=0)


def _lora_files(tmp_path, jpipe):
    """Two LoRA files the JAX package writes (``save_lora``) on ``jpipe``'s
    UNet, their B drawn non-zero (a fresh LoRA is an exact no-op): rank 4,
    alpha 2 on every projection; rank 2 on attn2's to_q and to_out. And the
    first as kohya- and peft-keyed community files (alpha 3 in kohya's).
    -> ([(path, flat JAX factors, LoRAConfig)], {format: path})."""
    from imagharmony_tpu.adapters import lora as jlora
    from imagharmony_tpu.io import safetensors_io

    rng = np.random.default_rng(11)
    out = []
    for i, cfg in enumerate((jlora.LoRAConfig(rank=4, alpha=2.0),
                             jlora.LoRAConfig(rank=2, targets=("to_q", "to_out"),
                                              attn=("attn2",)))):
        flat = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
                if k.endswith("lora_b") else v
                for k, v in jlora.flatten(jlora.init_lora(i, jpipe.params["unet"], cfg)).items()}
        path = str(tmp_path / f"lora{i}.safetensors")
        jlora.save_lora(path, jlora.unflatten(flat), cfg)
        out.append((path, flat, cfg))
    kohya, peft = {"lora_te1_text_model_skipped.alpha": np.ones((), np.float32)}, {}
    for k, a in out[0][1].items():
        if k.endswith(".lora_a"):
            base, b = k[: -len(".weight.lora_a")], out[0][1][k[:-1] + "b"]
            kname = "lora_unet_" + base.replace(".to_out", ".to_out_0").replace(".", "_")
            kohya.update({kname + ".lora_down.weight": a.T.copy(),
                          kname + ".lora_up.weight": b.T.copy(),
                          kname + ".alpha": np.array(3.0, np.float32)})
            pname = "unet." + base.replace(".to_out", ".to_out.0")
            peft.update({pname + ".lora_A.weight": a.T.copy(),
                         pname + ".lora_B.weight": b.T.copy()})
    community = {}
    for name, d in (("kohya", kohya), ("peft", peft)):
        community[name] = str(tmp_path / f"{name}.safetensors")
        safetensors_io.save(community[name], d)
    return out, community


def _controlnet_and_lora(tmp_path):
    """LoRA: ``load_lora`` of two JAX ``save_lora`` files and
    ``load_community_lora`` of kohya- and peft-keyed files give JAX's
    factors and configs; ``with_lora`` of both (the first at scale 0.7)
    merges into the packed UNet exactly what ``from_jax`` of JAX's
    ``apply_lora`` gives (to 1e-6), and leaves the source pipeline as it was.
    ControlNet (a tiny one, its output convs non-zero): that pipeline
    edits with a control image at conditioning scale 0.8 and
    encoder_interval 2 (the key steps' mid residual reused) against JAX's
    ``with_lora`` pipeline, every step and the image at cosine > 0.9999; the
    residuals change the image; ``generate_batch`` with two control images
    equals each request's solo run, and the slot engine's rows (generate()
    through ``chunk_steps``) the one-call path, bit for bit."""
    from imagharmony_tpu.adapters import lora as jlora
    from imagharmony_tpu_torch.adapters import lora as plora

    jc, pc = controlnet_pipes()
    files, community = _lora_files(tmp_path, jc)
    for path, flat, _ in files:
        got, got_cfg = plora.load_lora(path)
        tree = from_jax.state_dict(jlora.unflatten(flat))  # the factor tree crosses too
        assert set(got) == set(flat) == set(tree)
        assert all(torch.equal(tree[k], got[k]) for k in flat)
        assert dataclasses.asdict(got_cfg) == dataclasses.asdict(jlora.load_lora(path)[1])
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k].numpy(), v)
    for path in community.values():
        jtree, jcfg = jlora.load_lora(path)
        got, got_cfg = plora.load_lora(path)
        want = jlora.flatten(jtree)
        assert set(got) == set(want) and (got_cfg.rank, got_cfg.scale) == (jcfg.rank, jcfg.scale)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6, atol=1e-7)
    assert plora.parse_spec(f"{files[0][0]}:0.5") == (files[0][0], 0.5)
    assert plora.parse_spec(files[0][0], 0.3) == (files[0][0], 0.3)
    before = {k: v.clone() for k, v in pc.components.unet.state_dict().items()}
    jm = jc.with_lora(files[0][0], scale=0.7).with_lora(files[1][0])
    pm = pc.with_lora(files[0][0], scale=0.7).with_lora(files[1][0])
    want = phe.HarmonyPipeline.from_state_dict(from_jax.state_dict(jax.device_get(jm.params)),
                                               pc.cfgs, device="cpu").components.unet
    got, changed = pm.components.unet.state_dict(), 0
    for k, v in want.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6, msg=k)
        changed += not torch.equal(v, before[k])
    assert changed and len(pm.programs) == 0
    for k, v in pc.components.unet.state_dict().items():
        assert torch.equal(v, before[k]), k

    ctrl = np.random.default_rng(3).integers(0, 255, (40, 40, 3), dtype=np.uint8)
    # encoder propagation: steps 0 and 2 run the ControlNet and the whole
    # UNet, steps 1 and 3 reuse their skips and mid residual
    cap, _ = edit_parity(jm, pm, _image(), steps=4, control_image=ctrl,
                         controlnet_conditioning_scale=0.8, encoder_interval=2)
    kw = dict(prompt="a dog", extra_text="six dogs", num_inference_steps=4, height=32, width=32,
              seed=7, output_type="raw", encoder_interval=2)
    no_cn = pm.generate(_image(), **kw)
    assert float((no_cn.numpy() - cap["image"]).std()) > 1e-2
    ctrls = [ctrl, np.random.default_rng(4).integers(0, 255, (32, 32, 3), dtype=np.uint8)]
    shared = dict(num_inference_steps=2, height=32, width=32, output_type="raw")
    two = pc.generate_batch([_image(), _image()[::-1]], ["a dog", "a cat"], seeds=[1, 2],
                            control_images=ctrls, controlnet_scale=0.6, **shared)
    for i, (img, prompt) in enumerate(((_image(), "a dog"), (_image()[::-1], "a cat"))):
        solo = pc.generate(img, prompt=prompt, seed=[i + 1], control_image=ctrls[i],
                           controlnet_conditioning_scale=0.6, **shared)
        torch.testing.assert_close(two[i:i + 1], solo, rtol=0, atol=1e-5)
    one = pc.generate(_image(), control_image=ctrl, **dict(kw, encoder_interval=1))
    rows = pc.generate(_image(), control_image=ctrl, chunk_steps=2,
                       **dict(kw, encoder_interval=1))
    torch.testing.assert_close(rows, one, rtol=0, atol=0)


def _b64(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _serve_both_modes(pipe):
    """Both workers behind make_server on a free local port: two same-key
    requests and one of another key, all answered; the packed worker packs
    the two, the continuous one admits the second mid-flight (/status shows
    two slots at different steps); a malformed payload gets 400; a weighted
    prompt is answered by the packed worker and refused by the continuous
    one (500); no pack error. The order is made deterministic, not timed: the packed worker
    waits long for a second request of its key, and the continuous one's
    engine lock is held while the later requests are submitted."""
    for continuous in (False, True):
        steps = 6 if continuous else 3
        base = dict(image=_b64(_image()), prompt="a dog", extra_text="six dogs", steps=steps,
                    height=32, width=32)
        jobs = [dict(base, seed=1), dict(base, seed=2, prompt="a cat"),
                dict(base, steps=2, seed=3)]
        kw = dict(max_batch=2, chunk=1) if continuous else dict(max_batch=2, max_wait_s=60.0)
        srv = pserving.make_server(pipe, 0, continuous=continuous, host="127.0.0.1", **kw)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        worker, submitted = srv.worker, threading.Semaphore(0)
        submit = worker.submit

        def counted(payload):
            req = submit(payload)
            submitted.release()
            return req

        worker.submit = counted  # the handlers call the worker's submit

        def post(payload, body=None):
            req = urllib.request.Request(url + "/edit", method="POST",
                                         data=body or json.dumps(payload).encode())
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        def get(path):
            with urllib.request.urlopen(url + path, timeout=60) as r:
                return json.loads(r.read())

        results, statuses = [None] * 3, []
        posts = [threading.Thread(target=lambda i=i: results.__setitem__(i, post(jobs[i])))
                 for i in range(3)]
        try:
            posts[0].start()
            if continuous:  # once the first is in flight, hold its engine
                deadline = time.time() + 60
                while not any(get("/status").get("slot_steps") or []) \
                        and time.time() < deadline:
                    time.sleep(0.01)
                with worker._engine.prog.lock:
                    posts[1].start()
                    posts[2].start()
                    for _ in range(3):
                        assert submitted.acquire(timeout=60)
            else:  # the two of one key make a group, then the other key alone
                posts[1].start()
                for p in posts[:2]:
                    p.join(120)
                worker.max_wait_s = 0.05
                posts[2].start()
            while any(p.is_alive() for p in posts):
                statuses.append(get("/status"))
                time.sleep(0.01)
            bad = [post(None, body=b"not json"), post(dict(base, steps="x"))]
            # the chunked runner refuses weighted prompts: an error, not another edit
            weighted = post(dict(base, seed=4, prompt="a (dog:1.5)", prompt_weighting=True))
            assert get("/healthz") == {"ok": True}
        finally:
            srv.shutdown()
            worker.stop(30)
            srv.server_close()
        assert not worker.is_alive()
        assert [r[0] for r in results] == [200] * 3, results
        assert [b[0] for b in bad] == [400, 400]
        assert worker.pack_errors == 0
        if continuous:
            assert weighted[0] == 500 and "prompt_weighting" in weighted[1]["error"], weighted
        else:
            assert weighted[0] == 200, weighted
        if continuous:
            assert all(r[1]["continuous"] for r in results)
            assert any(sum(s is not None for s in st.get("slot_steps") or []) == 2
                       and len({s for s in st["slot_steps"]}) == 2 for st in statuses), statuses
            assert len(worker.admissions) == 3 and worker.admissions[1][1] > 0
        else:
            assert [r[1].get("batched") for r in results] == [2, 2, None]


def _program_cache_units():
    """ProgramCache: a bounded LRU that evicts the least recently used
    unpinned program, waits for an evicted program's lock, and builds a key
    once however many threads ask for it."""
    class Prog:
        def __init__(self, name):
            self.name, self.pinned, self.lock = name, False, threading.Lock()

    built = []

    def build(name):
        def make():
            built.append(name)
            time.sleep(0.01)
            return Prog(name)
        return make

    cache = pprog.ProgramCache(2)
    assert pprog.ProgramCache().capacity == pprog.DEFAULT_CAPACITY
    a = cache.acquire("a", build("a"))
    cache.acquire("b", build("b"))
    assert cache.acquire("a", build("a")) is a and list(cache) == ["b", "a"]
    cache.acquire("c", build("c"))  # b is the least recently used
    assert list(cache) == ["a", "c"] and cache.evictions == 1 and cache.captures == 3
    cache["a"].pinned = True
    cache.acquire("d", build("d"))  # a is pinned: c goes
    assert list(cache) == ["a", "d"]
    cache.resize(1)
    assert list(cache) == ["a"] and cache.evictions == 3
    cache.resize(3)
    with pytest.raises(ValueError, match="at least one key"):
        cache.resize(0)
    # an evicted program's running call ends first
    e = cache.acquire("e", build("e"))
    e.lock.acquire()
    released = []
    threading.Timer(0.05, lambda: (released.append(True), e.lock.release())).start()
    cache.resize(1)
    assert released and "e" not in cache
    # many threads, one key: one build
    cache, built[:] = pprog.ProgramCache(4), []
    got = []
    threads = [threading.Thread(target=lambda: got.append(cache.acquire("k", build("k"))))
               for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    assert built == ["k"] and len(got) == 8 and all(g is got[0] for g in got)


def test_ip_scale_schedule_and_time_ids_match_jax(pipes):
    """The per-step IP scales, the micro-conditioning rows (with negative
    overrides), the scan's five-row table (JAX's xs with the inpaint blend
    levels), the schedule and IP scales an img2img or denoising_start call
    runs (JAX's ``_edit_jit`` slicing), and a grouped call: DDIM with
    trailing spacing, v-prediction and zero-SNR on an img2img at strength
    0.6 with an IP window. Then the chunked runner, whose rows read their
    own column of those tables: generate()'s ``chunk_steps`` bit for bit the
    one-call path (as JAX's test_chunked_matches_one_jit asserts) with Euler
    at chunks 2 and 3, encoder_interval 2, and DPM++ 2M on two samples of a
    seed list, the callback at [2, 4]; the slot engine under DPM++ (whose
    history resets at admission): a request admitted after one chunk equals
    its solo engine run bit for bit, while under an IP window the mid-flight
    rows carry different IP weights into K2 the same step. The refiner
    family: its aesthetic-score time ids, its refusal of an image prompt,
    and against JAX's refiner an img2img at strength 0.6 with its own
    aesthetic scores and the handoff (given latents from
    denoising_start 0.5), every step and the output at cosine > 0.9999; a
    random tiny refiner refines an image."""
    for start, end in [(0.0, 1.0), (0.2, 0.7)]:
        kw = dict(num_inference_steps=10, ip_scale=0.6, control_guidance_start=start,
                  control_guidance_end=end)
        np.testing.assert_array_equal(phe.ip_scale_schedule(phe.EditOptions(**kw)),
                                      jhe.ip_scale_schedule(jhe.EditOptions(**kw)))
    assert phe.EditOptions(height=768).time_ids() == jhe.EditOptions(height=768).time_ids()
    sizes = dict(height=768, original_size=(512, 640), negative_target_size=(256, 256),
                 negative_crops_coords_top_left=(3, 5))
    for neg in (False, True):
        assert phe.EditOptions(**sizes).time_ids(negative=neg) == \
            jhe.EditOptions(**sizes).time_ids(negative=neg)
        aes = dict(sizes, aesthetic_score=7.5, negative_aesthetic_score=1.5)
        assert phe.EditOptions(**aes).time_ids(negative=neg, aesthetic=True) == \
            jhe.EditOptions(**aes).time_ids(negative=neg, aesthetic=True)
    # the scan's per-step tables: JAX's xs, scan_constants(schedule) +
    # (ip_scales, inpaint blend levels), for a cut schedule too
    for kind, steps, extra in (("euler", 1, {}), ("euler", 30, {}), ("ddim", 30, {}),
                               ("lcm", 4, {}), ("dpm++", 30, dict(img2img_skip=12)),
                               ("euler_a", 30, dict(denoising_start=0.8)),
                               ("euler", 30, dict(denoising_end=0.8))):
        kw = dict(num_inference_steps=steps, ip_scale=0.6, scheduler=kind,
                  control_guidance_start=0.2, control_guidance_end=0.7, **extra)
        opts_p, opts_j = phe.EditOptions(**kw), jhe.EditOptions(**kw)
        sched_p, ip_p = phe.schedule_for(opts_p)
        cfg_j = jhe.sched_config(opts_j)
        sched_j = jsched.make(kind, steps, cfg_j, denoising_end=opts_j.denoising_end,
                              denoising_start=opts_j.denoising_start,
                              skip_steps=opts_j.img2img_skip)
        n_skip = opts_j.img2img_skip + (jsched.steps_for_denoising_end(
            steps, opts_j.denoising_start, cfg_j) if opts_j.denoising_start else 0)
        ref = [np.asarray(x) for x in jsched.scan_constants(sched_j)]
        ref += [jhe.ip_scale_schedule(opts_j)[n_skip: n_skip + sched_j.num_steps],
                np.asarray(jhe._inpaint_blend_levels(sched_j))]
        for o, r in zip(psched.scan_constants(sched_p), ref):
            assert o.dtype == torch.float32 and o.shape == (sched_j.num_steps,)
            np.testing.assert_array_equal(o.numpy(), r)
        np.testing.assert_array_equal(ip_p, ref[3])
        tables = phe.scan_tables(sched_p, ip_p)
        assert tables.shape == (phe.STEP_ROWS, sched_j.num_steps)
        np.testing.assert_array_equal(tables.numpy(), np.stack(ref))

    jpipe, port = pipes
    edit_parity(jpipe, port, _image(), steps=5, scheduler="ddim", timestep_spacing="trailing",
                prediction_type="v_prediction", rescale_zero_snr=True, init_image=_image(),
                strength=0.6, control_guidance_start=0.2, control_guidance_end=0.8)
    jr, pr = refiner_pipes()
    with pytest.raises(ValueError, match="no image encoder"):
        pr.prepare(_image(), height=32, width=32)
    assert pr.prepare(None, height=32, width=32).time_ids.shape == (2, 5)
    edit_parity(jr, pr, None, steps=4, extra_text=None, init_image=_image(), strength=0.6,
                aesthetic_score=7.0, negative_aesthetic_score=2.0)
    # the handoff's latents (the base's side is test_tiny_edit_matches_golden's)
    lat = 2.0 * np.random.default_rng(9).standard_normal((1, 16, 16, 4)).astype(np.float32)
    edit_parity(jr, pr, None, steps=4, extra_text=None, latents=lat, denoising_start=0.5)
    tiny = phe.HarmonyPipeline.random_tiny_refiner(device="cpu")
    out = tiny.generate(init_image=_image(), strength=0.5, num_inference_steps=2, height=32,
                        width=32, output_type="raw")
    assert tiny.cfgs.family == "sdxl_refiner" and torch.isfinite(out).all()

    kw = dict(prompt="a dog", extra_text="six dogs", num_inference_steps=4, height=32,
              width=32, seed=9, output_type="raw")
    for extra, chunks in (({}, (2, 3)), (dict(encoder_interval=2), (2,)),
                          (dict(num_samples=2, seed=[3, 4], scheduler="dpm++"), (2,))):
        one = port.generate(_image(), **dict(kw, **extra))
        for chunk in chunks:
            seen = []
            got = port.generate(_image(), chunk_steps=chunk, **dict(kw, **extra),
                                callback_on_step_end=lambda i, lat: seen.append((i, lat.shape)))
            torch.testing.assert_close(got, one, rtol=0, atol=0)
            assert [i for i, _ in seen] == ([2, 4] if chunk == 2 else [3, 4])
            assert seen[0][1] == (one.shape[0], 16, 16, 4)

    def engine_run(opts, jobs):
        eng = pcont.SlotEngine(port, opts, slots=2, chunk=1)
        out, started = {}, []
        for _ in range(12):
            for tok, job in jobs:
                if tok not in started and eng.free_slots():
                    eng.admit(tok, pil_image=_image(), **job)
                    started.append(tok)
                    break  # one admission a chunk: the second joins mid-flight
            eng.run_chunk()
            out.update(eng.harvest())
            if len(out) == len(jobs):
                break
        eng.close()
        return out

    jobs = [("A", dict(prompt="a dog", seed=1)),
            ("B", dict(prompt="a cat", extra_text="two cats", seed=2))]
    weights = []
    k2 = pca.flash_cross_nhd

    def record(q, k, v, **kw_):
        if kw_.get("k_ip") is not None:
            weights.append(kw_["ip_scale"].clone())
        return k2(q, k, v, **kw_)

    opts = phe.EditOptions(height=32, width=32, num_inference_steps=4, scheduler="dpm++",
                           ip_scale=0.8, control_guidance_start=0.25, control_guidance_end=0.75)
    pca.flash_cross_nhd = record
    try:
        both = engine_run(opts, jobs)
    finally:
        pca.flash_cross_nhd = k2
    np.testing.assert_array_equal(both["B"], engine_run(opts, jobs[1:])["B"])
    # A at step 1 of the window [1, 3), B at step 0: weights 0.8 and 0.0 on
    # each half of the CFG pair, one (2S,) vector into K2
    assert weights and all(w.shape == (4,) for w in weights)
    assert any(torch.equal(w, torch.tensor([0.8, 0.0, 0.8, 0.0])) for w in weights)


@pytest.mark.parametrize("text", ["a dog", "a photo of eight sheep!", "", "Six   CATS, a dog"])
def test_tokenizer_ids_match_jax(text, pipes, tmp_path):
    """The toy tokenizer's ids; the prompt-attention grammar and the
    weighted tokenization (ids and weights) against JAX's; and textual
    inversion from a synthesized dual-tower .safetensors file: the token
    ids of a prompt holding the placeholder and the text conditioning
    against JAX's, the base pipeline untouched."""
    from imagharmony_tpu.io import safetensors_io
    from imagharmony_tpu.utils import prompts as jprompts
    from imagharmony_tpu_torch.utils import prompts as pprompts

    ours, theirs = ptok.build_toy_tokenizer(), jtok.build_toy_tokenizer()
    assert ours.encode(text) == theirs.encode(text)
    for a, b in zip(ptok.SDXLTokenizers(ours, ours)(text), jtok.SDXLTokenizers(theirs, theirs)(text)):
        np.testing.assert_array_equal(a, b)
    jpipe, port = pipes
    for prompt in (text, f"({text}:1.3), [red] (((sheep)))", f"\\({text}\\) [x:0.5]"):
        assert pprompts.parse_prompt_attention(prompt) == jprompts.parse_prompt_attention(prompt)
        ours, theirs = port._tokenize_weighted(prompt), jpipe._tokenize_weighted(prompt)
        for a, b in zip(ours[:2], theirs[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (ours[2] is None) == (theirs[2] is None)
        if ours[2] is not None:
            np.testing.assert_array_equal(ours[2].numpy(), theirs[2])

    rng = np.random.default_rng(len(text))
    rows = {"clip_l": rng.standard_normal((2, port.cfgs.text_l.hidden_size)).astype(np.float32),
            "clip_g": rng.standard_normal((2, port.cfgs.text_g.hidden_size)).astype(np.float32)}
    path = tmp_path / "ti.safetensors"
    safetensors_io.save(str(path), rows)
    ti_p = port.with_textual_inversion(str(path), token="<cat-toy>")
    ti_j = jpipe.with_textual_inversion(str(path), token="<cat-toy>")
    assert ti_p.programs == {} and ti_p.components.unet is port.components.unet
    assert port.cfgs.text_l.vocab_size == ti_p.cfgs.text_l.vocab_size - 2
    prompt = f"{text} <cat-toy> dog"
    ids_p, ids_j = ti_p._tokenize(prompt), ti_j._tokenize(prompt)
    for a, b in zip(ids_p, ids_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with torch.no_grad():
        ctx, pooled = phe.encode_texts(ti_p.components, *ids_p)
    ref_ctx, ref_pooled = jhe.encode_texts(ti_j.params, ti_j.cfgs, *ids_j, policy=jdt.FP32)
    close(ctx, ref_ctx)
    close(pooled, ref_pooled)
    assert port._tokenize(prompt)[0].shape == ids_p[0].shape  # the base tokenizer is as it was
    assert "<cat-toy>" not in port.tokenizers.tok1.added_tokens


def _write_jax_tree(root, params, cfgs, toy):
    """A diffusers tree of a JAX bundle, written by the JAX package's writers
    as tests/test_load_pipeline.py writes one: the UNet without its IP
    projections (as diffusers writes it) and sharded in two under an
    index.json, CLIP-L as a torch .bin, the rest .safetensors, the
    tokenizers' files and the 3-dict ``ip_adapter.bin``."""
    from imagharmony_tpu.io import checkpoints as jckpt
    from imagharmony_tpu.io import safetensors_io, torch_pickle

    sdxl = cfgs.text_g is not None
    root.mkdir()
    (root / "model_index.json").write_text(json.dumps(
        {"_class_name": "StableDiffusionXLPipeline" if sdxl else "StableDiffusionPipeline"}))
    for sub in ("unet", "vae", "text_encoder", "image_encoder"):
        (root / sub).mkdir()
    unet = {k: v for k, v in hf_import.export_tree(params["unet"]).items() if "_ip." not in k}
    keys = sorted(unet)
    names = [f"diffusion_pytorch_model-0000{i}-of-00002.safetensors" for i in (1, 2)]
    shards = (keys[: len(keys) // 2], keys[len(keys) // 2:])
    for name, part in zip(names, shards):
        safetensors_io.save(root / "unet" / name, {k: unet[k] for k in part})
    (root / "unet" / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: n for n, part in zip(names, shards) for k in part}}))
    safetensors_io.save(root / "vae" / "diffusion_pytorch_model.safetensors",
                        hf_import.export_tree(params["vae"]))
    torch_pickle.save(str(root / "text_encoder" / "pytorch_model.bin"),
                      hf_import.export_tree(params["text_encoder"], prefix="text_model."))
    if sdxl:
        (root / "text_encoder_2").mkdir()
        te2 = hf_import.export_tree(params["text_encoder_2"], prefix="text_model.")
        safetensors_io.save(root / "text_encoder_2" / "model.safetensors", {
            k.replace("text_model.text_projection", "text_projection"): v
            for k, v in te2.items()})
    vis = hf_import.export_tree(params["image_encoder"], prefix="vision_model.")
    safetensors_io.save(root / "image_encoder" / "model.safetensors", {
        k.replace("vision_model.visual_projection", "visual_projection"): v
        for k, v in vis.items()})
    for sub in ("tokenizer", "tokenizer_2") if sdxl else ("tokenizer",):
        (root / sub).mkdir()
        (root / sub / "vocab.json").write_text(json.dumps(toy.encoder))
        merges = sorted(toy.bpe_ranks, key=toy.bpe_ranks.get)
        (root / sub / "merges.txt").write_text(
            "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    if sdxl:
        jckpt.save_adapter_checkpoint(
            root / "ip_adapter.bin", unet_params=params["unet"], unet_cfg=cfgs.unet,
            image_proj_params=params["image_proj"], harmony_params=params["harmony"],
            harmony_cfg=cfgs.harmony)
    else:  # SD1.5 adapters carry no composed_adapter (no HA head)
        torch_pickle.save(str(root / "ip_adapter.bin"), {
            "image_proj": hf_import.export_tree(params["image_proj"]),
            "ip_adapter": jckpt.extract_adapter_state(params["unet"], cfgs.unet)})
    return str(root)


def _write_jax_refiner_tree(root, params, cfgs, toy):
    """A refiner tree as tests/test_refiner.py writes one with the JAX
    package's writers: XLImg2Img's model_index, unet/, vae/ and
    text_encoder_2/ with their config.json files, tokenizer_2/."""
    from imagharmony_tpu.io import safetensors_io

    u, v, tg = cfgs.unet, cfgs.vae, cfgs.text_g
    parts = {
        "unet": (hf_import.export_tree(params["unet"]), dict(
            sample_size=u.sample_size, block_out_channels=list(u.block_out_channels),
            down_block_types=list(u.down_block_types), up_block_types=list(u.up_block_types),
            layers_per_block=u.layers_per_block,
            transformer_layers_per_block=list(u.transformer_layers_per_block),
            num_attention_heads=list(u.num_attention_heads),
            attention_head_dim=u.attention_head_dim,
            cross_attention_dim=u.cross_attention_dim, norm_num_groups=u.norm_num_groups,
            addition_embed_type="text_time", addition_time_embed_dim=u.addition_time_embed_dim,
            projection_class_embeddings_input_dim=u.projection_class_embeddings_input_dim)),
        "vae": (hf_import.export_tree(params["vae"]), dict(
            block_out_channels=list(v.block_out_channels), layers_per_block=v.layers_per_block,
            norm_num_groups=v.norm_num_groups, scaling_factor=v.scaling_factor,
            latent_channels=v.latent_channels)),
        "text_encoder_2": ({k.replace("text_model.text_projection", "text_projection"): x
                            for k, x in hf_import.export_tree(
                                params["text_encoder_2"], prefix="text_model.").items()}, dict(
            vocab_size=tg.vocab_size, hidden_size=tg.hidden_size,
            num_hidden_layers=tg.num_layers, num_attention_heads=tg.num_heads,
            intermediate_size=tg.intermediate_size,
            max_position_embeddings=tg.max_position_embeddings, hidden_act=tg.hidden_act,
            projection_dim=tg.projection_dim, eos_token_id=tg.eos_token_id,
            architectures=["CLIPTextModelWithProjection"]))}
    for sub, (flat, config) in parts.items():
        (root / sub).mkdir(parents=True)
        name = "model.safetensors" if sub.startswith("text") else \
            "diffusion_pytorch_model.safetensors"
        safetensors_io.save(root / sub / name, flat)
        (root / sub / "config.json").write_text(json.dumps(config))
    (root / "tokenizer_2").mkdir()
    (root / "tokenizer_2" / "vocab.json").write_text(json.dumps(toy.encoder))
    merges = sorted(toy.bpe_ranks, key=toy.bpe_ranks.get)
    (root / "tokenizer_2" / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    (root / "model_index.json").write_text(json.dumps(
        {"_class_name": "StableDiffusionXLImg2ImgPipeline", "requires_aesthetics_score": True}))
    return str(root)


def _write_jax_controlnet(path, params, ccfg):
    """A diffusers ControlNetModel directory of a JAX ControlNet tree: its
    weights without IP projections and the embedder's widths in config.json."""
    from imagharmony_tpu.io import safetensors_io

    path.mkdir()
    safetensors_io.save(path / "diffusion_pytorch_model.safetensors",
                        {k: v for k, v in hf_import.export_tree(params).items() if "_ip." not in k})
    (path / "config.json").write_text(json.dumps(dict(
        _class_name="ControlNetModel", conditioning_channels=ccfg.conditioning_channels,
        conditioning_embedding_out_channels=list(ccfg.conditioning_embedding_channels))))
    return str(path)


def _cli(tmp_path, jpipe, root, cn_dir, monkeypatch):
    """The port's CLI (``cli.main``, ``--device cpu``) against the JAX
    CLI: ``edit`` on the tiny tree with its adapter, a LoRA at :0.7 and the
    ControlNet with a control image, the PNGs at uint8 cosine > 0.9999 (the
    JAX CLI computes in bf16 on the CPU, the port in fp32); ``demo`` with
    attention maps (one PNG an IP token); ``convert`` writing JAX's
    ``ip_adapter.bin``; ``parity --save`` then ``--ours --theirs`` of that
    capture (min cosine 1, pass); ``serve --lora``'s arguments through the
    server ``serving.main`` runs (``build_server``: ``make_server`` over the
    merged pipeline) answering one request. ``edit`` of the refiner family and the
    ensemble run in ``test_from_jax_keys_and_shapes_match_export_tree``.
    The tiny tree has no config.json files, so both loaders take the tiny
    configs as the SDXL family's defaults here, and the port draws the JAX
    package's initial noise for the seed."""
    from PIL import Image

    from imagharmony_tpu import cli as jcli
    from imagharmony_tpu.io import torch_pickle
    from imagharmony_tpu.pipelines import components as jcomp
    from imagharmony_tpu_torch import cli as pcli

    vocab = len(jpipe.tokenizers.tok1.encoder)
    monkeypatch.setattr(jcomp, "sdxl_configs", lambda *a, **k: jpipe.cfgs)
    monkeypatch.setitem(pckpt.FAMILY_CONFIGS, "sdxl", lambda: pcomp.tiny_configs(vocab))
    monkeypatch.setattr(phe.HarmonyPipeline, "_noise", lambda self, seed, n, shape: torch.tensor(
        np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,) + shape, jnp.float32))))

    lora = _lora_files(tmp_path, jpipe)[0][0][0]
    inp, ctrl = str(tmp_path / "in.png"), str(tmp_path / "ctrl.png")
    Image.fromarray(_image()).save(inp)
    Image.fromarray(np.random.default_rng(3).integers(0, 255, (40, 40, 3), np.uint8)).save(ctrl)
    argv = ["edit", "--input", inp, "--model-dir", root, "--adapter-ckpt", f"{root}/ip_adapter.bin",
            "--lora", f"{lora}:0.7", "--controlnet-dir", cn_dir, "--control-image", ctrl,
            "--extra-text", "six dogs", "--steps", "3", "--height", "32", "--width", "32"]
    out_j, out_p = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    assert jcli.main(argv + ["--output", out_j]) == 0
    assert pcli.main(argv + ["--output", out_p, "--device", "cpu"]) == 0
    a, b = (np.asarray(Image.open(p)) for p in (out_p, out_j))
    assert a.shape == b.shape == (32, 32, 3) and parity.cosine(a, b) > 0.9999

    maps = tmp_path / "maps"
    assert pcli.main(["demo", "--device", "cpu", "--output", str(tmp_path / "demo.png"),
                      "--attn-maps", str(maps)]) == 0
    assert Image.open(tmp_path / "demo.png").size == (32, 32)
    assert sorted(p.name for p in maps.iterdir()) == [f"ip_token_{i}.png" for i in range(4)]

    sd = {f"{head}x.weight": np.full((2, 3), i, np.float32) for i, head in enumerate(
        ("image_proj_model.", "adapter_modules.0.to_k_ip.", "composed_modules.fc1."))}
    for run in ("jax", "port"):
        (tmp_path / run / "checkpoint-5").mkdir(parents=True)
        torch_pickle.save(str(tmp_path / run / "checkpoint-5" / "pytorch_model.bin"), sd)
    jcli.main(["convert", "--log-dir", str(tmp_path / "jax")])
    assert pcli.main(["convert", "--log-dir", str(tmp_path / "port")]) == 0
    got, want = (pckpt.flatten_nested(torch_pickle.load(str(
        tmp_path / run / "checkpoint-5" / "ip_adapter.bin"))) for run in ("port", "jax"))
    assert set(got) == set(want) and len(want) == 3
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))

    cap = str(tmp_path / "cap.npz")
    assert pcli.main(["parity", "--device", "cpu", "--input", inp, "--steps", "2", "--size",
                      "32", "--save", cap]) == 0
    rep = pcli.cmd_parity(pcli.build_parser().parse_args(
        ["parity", "--ours", cap, "--theirs", cap]))
    assert rep["pass"] and rep["min_cosine"] > 0.999999 and len(rep["per_step_cosine"]) == 3
    assert parity.load(cap)["latents"].shape == (3, 1, 16, 16, 4)

    args = pcli.build_parser().parse_args(["serve", "--port", "0", "--host", "127.0.0.1",
                                           "--device", "cpu", "--lora", f"{lora}:0.5"])
    srv = pserving.build_server(args)  # what ``serve`` runs until interrupted
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        body = dict(image=_b64(_image()), prompt="a dog", steps=2, height=32, width=32, seed=1)
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/edit",
                                     method="POST", data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and "image" in json.loads(r.read())
    finally:
        srv.shutdown()
        srv.worker.stop(30)


# published config.json values (stabilityai/stable-diffusion-xl-base-1.0,
# runwayml/stable-diffusion-v1-5), the keys the importers read and some
# they ignore
_SDXL_UNET = dict(
    _class_name="UNet2DConditionModel", act_fn="silu", addition_embed_type="text_time",
    addition_embed_type_num_heads=64, addition_time_embed_dim=256,
    attention_head_dim=[5, 10, 20], block_out_channels=[320, 640, 1280],
    class_embed_type=None, class_embeddings_concat=False, cross_attention_dim=2048,
    down_block_types=["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    dual_cross_attention=False, encoder_hid_dim=None, in_channels=4, layers_per_block=2,
    mid_block_type="UNetMidBlock2DCrossAttn", norm_num_groups=32, num_attention_heads=None,
    out_channels=4, projection_class_embeddings_input_dim=2816,
    resnet_time_scale_shift="default", sample_size=128, time_cond_proj_dim=None,
    transformer_layers_per_block=[1, 2, 10],
    up_block_types=["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
    use_linear_projection=True)
_SD15_UNET = dict(
    _class_name="UNet2DConditionModel", act_fn="silu", attention_head_dim=8,
    block_out_channels=[320, 640, 1280, 1280], cross_attention_dim=768,
    down_block_types=["CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                      "DownBlock2D"], in_channels=4, layers_per_block=2, norm_num_groups=32,
    out_channels=4, sample_size=64,
    up_block_types=["UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                    "CrossAttnUpBlock2D"])
_VAE = dict(_class_name="AutoencoderKL", act_fn="silu", block_out_channels=[128, 256, 512, 512],
            in_channels=3, latent_channels=4, layers_per_block=2, norm_num_groups=32,
            out_channels=3, sample_size=1024, scaling_factor=0.13025)
_CLIP_L = dict(architectures=["CLIPTextModel"], bos_token_id=0, eos_token_id=2,
               hidden_act="quick_gelu", hidden_size=768, intermediate_size=3072,
               max_position_embeddings=77, num_attention_heads=12, num_hidden_layers=12,
               pad_token_id=1, projection_dim=768, vocab_size=49408)
_CLIP_G = dict(_CLIP_L, architectures=["CLIPTextModelWithProjection"], hidden_act="gelu",
               hidden_size=1280, intermediate_size=5120, num_attention_heads=20,
               num_hidden_layers=32, projection_dim=1280)


def test_from_jax_keys_and_shapes_match_export_tree(pipes, tmp_path, monkeypatch):
    """io/from_jax gives export_tree's keys and shapes, and the port's
    modules have exactly those keys. The port's loader on trees the JAX
    package wrote (SDXL and SD1.5, with and without the adapter) gives
    exactly from_jax.state_dict of the JAX load_pipeline's params, the same
    token ids and family, on a refiner tree too (written as
    tests/test_refiner.py writes one) and with a ControlNet directory; the
    config importers equal the JAX ones on the published SDXL and SD1.5
    configs. Then the CLI (``_cli``) on the SDXL tree, and the port CLI's
    ``edit`` of the refiner tree (img2img of ``--input``) and of the
    base -> refiner ensemble (``--refiner-dir``), each a PNG of the size
    asked for."""
    from imagharmony_tpu.io import checkpoints as jckpt
    from imagharmony_tpu.models import clip_text as jclip
    from imagharmony_tpu.models import unet as junet
    from imagharmony_tpu.models import vae as jvae
    from imagharmony_tpu.pipelines import components as jcomp
    from imagharmony_tpu_torch.models import clip_text as pclip
    from imagharmony_tpu_torch.models import unet as punet
    from imagharmony_tpu_torch.models import vae as pvae

    jpipe, _ = pipes
    params = jax.device_get(jpipe.params)
    sd = from_jax.state_dict(params)
    ref = hf_import.export_tree(params)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    toy = jpipe.tokenizers.tok1
    with torch.device("meta"):
        comps = pcomp.Components(pcomp.tiny_configs(vocab_size=len(toy.encoder)))
    assert set(comps.state_dict()) == set(sd)

    sd15_jcfgs = jcomp.sd15_tiny_configs(vocab_size=len(toy.encoder))
    trees = [("sdxl", jpipe.cfgs, params, pcomp.tiny_configs(vocab_size=len(toy.encoder))),
             ("sd15", sd15_jcfgs, jax.device_get(jcomp.init_params(0, sd15_jcfgs)),
              pcomp.sd15_tiny_configs(vocab_size=len(toy.encoder)))]
    for family, jcfgs, jparams, pcfgs in trees:
        root = _write_jax_tree(tmp_path / family, jparams, jcfgs, toy)
        assert pckpt.detect_family(root) == jckpt.detect_family(root) == family
        for adapter in (f"{root}/ip_adapter.bin", None):
            want = from_jax.state_dict(
                jckpt.load_pipeline(model_dir=root, adapter_ckpt=adapter, cfgs=jcfgs).params)
            _, got, _ = pckpt.load_components(root, adapter, cfgs=pcfgs, device="cpu",
                                              dtype=torch.float32)
            got_unet, got = got.unet, got.state_dict()
            assert set(got) == set(want), (family, adapter)
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
        if family == "sd15":  # published SD1.5 UNets store proj_in/out as 1x1 convs
            flat = pckpt.load_sharded_dir(f"{root}/unet")
            conv = {k: v[..., None, None] if ".proj_in.w" in k or ".proj_out.w" in k else v
                    for k, v in pckpt.seed_ip_weights(flat).items()}
            assert sum(v.dim() == 4 for v in conv.values()) > sum(
                v.dim() == 4 for v in flat.values())
            unet_sd = hf_import_torch.import_state(copy.deepcopy(got_unet), conv).state_dict()
            for k, v in got_unet.state_dict().items():
                torch.testing.assert_close(unet_sd[k], v, rtol=0, atol=0)
        port = pckpt.load_pipeline(root, cfgs=pcfgs, device="cpu", dtype=torch.float32)
        jaxp = jckpt.load_pipeline(model_dir=root, cfgs=jcfgs)
        for text in ("a dog", "a photo of eight sheep!", ""):
            for a, b in zip(port.tokenizers(text), jaxp.tokenizers(text)):
                np.testing.assert_array_equal(a, b)

    from imagharmony_tpu.models import controlnet as jcn

    rcfgs = jcomp.sdxl_refiner_tiny_configs(vocab_size=len(toy.encoder))
    rroot = _write_jax_refiner_tree(tmp_path / "refiner", jax.device_get(
        jcomp.init_params(1, rcfgs)), rcfgs, toy)
    ccfg = jcn.ControlNetConfig(base=jpipe.cfgs.unet, conditioning_embedding_channels=(8, 16))
    cn_dir = _write_jax_controlnet(tmp_path / "controlnet", nonzero_controlnet_outputs(
        jax.device_get(jcn.init(2, ccfg)), 5), ccfg)
    sdxl_root = str(tmp_path / "sdxl")
    for root, cn, cfgs_j in ((rroot, None, None), (sdxl_root, cn_dir, jpipe.cfgs)):
        assert pckpt.detect_family(root) == jckpt.detect_family(root)
        jaxp = jckpt.load_pipeline(model_dir=root, controlnet_dir=cn, cfgs=cfgs_j)
        want = from_jax.state_dict(jaxp.params)
        cfgs_p = None if cfgs_j is None else pcomp.tiny_configs(vocab_size=len(toy.encoder))
        got_cfgs, got, toks = pckpt.load_components(root, None, None, cn, cfgs=cfgs_p,
                                                    device="cpu", dtype=torch.float32)
        assert got_cfgs.family == jaxp.cfgs.family
        assert (got_cfgs.controlnet is None) == (cn is None)
        got = got.state_dict()
        # the adapter's weights are zeros on both sides without an adapter
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
        for a, b in zip(toks("a dog"), jaxp.tokenizers("a dog")):
            np.testing.assert_array_equal(a, b)

    _cli(tmp_path, jpipe, sdxl_root, cn_dir, monkeypatch)
    from PIL import Image

    from imagharmony_tpu_torch import cli as pcli

    common = ["--input", str(tmp_path / "in.png"), "--steps", "4", "--height", "32", "--width",
              "32", "--device", "cpu"]
    for extra in (["--model-dir", rroot], ["--model-dir", sdxl_root, "--refiner-dir", rroot,
                                           "--extra-text", "six dogs"]):
        out = tmp_path / "refined.png"
        assert pcli.main(["edit", *common, *extra, "--output", str(out)]) == 0
        assert Image.open(out).size == (32, 32)
        out.unlink()

    sd15_vae = dict(_VAE, sample_size=512, scaling_factor=0.18215)
    for d in (_SDXL_UNET, _SD15_UNET):
        for ip in (("down_blocks.2.attentions.1",), ("",)):
            assert dataclasses.asdict(punet.config_from_diffusers(d, ip_layers=ip)) == \
                dataclasses.asdict(junet.config_from_diffusers(d, ip_layers=ip))
    for d in (_VAE, sd15_vae):
        assert dataclasses.asdict(pvae.config_from_diffusers(d)) == \
            dataclasses.asdict(jvae.config_from_diffusers(d))
    assert pvae.config_from_diffusers(sd15_vae).scaling_factor == 0.18215
    for d, proj in ((_CLIP_L, None), (_CLIP_G, True), (_CLIP_G, None),
                    (dict(_CLIP_L, eos_token_id=49407), None)):
        ours = pclip.config_from_transformers(d, with_projection=proj)
        theirs = jclip.config_from_transformers(d, with_projection=proj)
        # "eos_token_id": 2 is transformers' legacy "the highest id": the
        # port pools at <|endoftext|>, the JAX package at id 2
        assert ours.eos_token_id == 49407
        assert dataclasses.asdict(ours) == dataclasses.asdict(
            dataclasses.replace(theirs, eos_token_id=49407))
    # the full-size defaults are the published configs
    assert punet.config_from_diffusers(_SDXL_UNET) == pcomp.sdxl_configs().unet
    assert punet.config_from_diffusers(_SD15_UNET, ip_layers=("",)) == pcomp.sd15_configs().unet
    assert pclip.config_from_transformers(_CLIP_L) == pcomp.sdxl_configs().text_l
    assert pclip.config_from_transformers(_CLIP_G) == pcomp.sdxl_configs().text_g
    with pytest.raises(ValueError, match="class_embed_type"):
        punet.config_from_diffusers(dict(_SDXL_UNET, class_embed_type="timestep"))


def test_port_imports_no_jax():
    """Every module of the port (its ``tools/`` included), and
    chip_smoke.py, import without JAX or the JAX package; and no line of
    their sources imports either, lazily inside a function included (the
    JAX serving.main's ``from imagharmony_tpu.cli import _merge_loras`` is
    such an import)."""
    pattern = re.compile(r"^\s*(from\s+(jax|jaxlib|imagharmony_tpu)(\.|\s)"
                         r"|import\s+(jax|jaxlib|imagharmony_tpu)(\.|\s|,|$))")
    sources = sorted((REPO / "imagharmony_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [f"{path.relative_to(REPO)}:{n}: {line.strip()}" for path in sources
           for n, line in enumerate(path.read_text().splitlines(), 1) if pattern.match(line)]
    assert len(sources) > 40 and not bad, bad
    assert {"__init__.py", "eval_benchmark.py", "validate_presets.py"} <= {
        p.name for p in sources if p.parent == REPO / "imagharmony_tpu_torch" / "tools"}
    assert pattern.match("    from imagharmony_tpu.cli import _merge_loras")
    assert pattern.match("import jax.numpy as jnp") and pattern.match("  import jax")
    assert not pattern.match("from imagharmony_tpu_torch.pipelines import serving")
    assert not pattern.match("import imagharmony_tpu_torch")
    code = (
        "import importlib, pkgutil, sys\n"
        "import imagharmony_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import imagharmony_tpu_torch.tools.eval_benchmark\n"
        "import imagharmony_tpu_torch.tools.validate_presets\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'imagharmony_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
