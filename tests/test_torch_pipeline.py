"""The ported slice as a whole, on the CPU: the port loaded with the JAX
tiny pipeline's weights against the fp32 golden trajectory, the CFG-packed
conditioning against JAX's, generate(), the tokenizer, io/from_jax, and
that the port runs without JAX."""

import functools
import subprocess
import sys
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
from imagharmony_tpu_torch.io import from_jax
from imagharmony_tpu_torch.models import tokenizer as ptok
from imagharmony_tpu_torch.pipelines import components as pcomp
from imagharmony_tpu_torch.pipelines import harmony_edit as phe
from imagharmony_tpu_torch.schedulers import diffusion as psched
from imagharmony_tpu_torch.utils import parity
from torch_port_util import close

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "goldens" / "tiny_edit_fp32.npz"


@pytest.fixture(scope="module")
def pipes():
    """(JAX tiny pipeline, the port over the same weights, fp32 on the CPU)."""
    jpipe = JaxPipeline.random_tiny(seed=0)
    jpipe.policy = jdt.FP32
    params = jax.device_get(jpipe.params)
    cfgs = pcomp.tiny_configs(vocab_size=len(jpipe.tokenizers.tok1.encoder))
    port = phe.HarmonyPipeline.from_state_dict(from_jax.state_dict(params), cfgs, device="cpu")
    return jpipe, port


def _image():
    return np.random.default_rng(0).integers(0, 255, (48, 48, 3), dtype=np.uint8)


def test_tiny_edit_matches_golden(pipes):
    """The call and thresholds of tests/test_golden.py, with the golden's
    initial noise handed to the port, through the denoise loop's body that
    generate() runs; generate() gives the capture's image bit for bit."""
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


def test_build_conditioning_matches_jax(pipes):
    """CFG-packed [uncond | cond] conditioning with num_samples=2."""
    jpipe, port = pipes
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


def test_generate_tiny():
    """generate() end to end on the CPU: uint8 (1, H, W, 3), deterministic
    for a seed, phase timings recorded on request."""
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


def test_ip_scale_schedule_and_time_ids_match_jax():
    for start, end in [(0.0, 1.0), (0.2, 0.7)]:
        kw = dict(num_inference_steps=10, ip_scale=0.6, control_guidance_start=start,
                  control_guidance_end=end)
        np.testing.assert_array_equal(phe.ip_scale_schedule(phe.EditOptions(**kw)),
                                      jhe.ip_scale_schedule(jhe.EditOptions(**kw)))
    assert phe.EditOptions(height=768).time_ids() == jhe.EditOptions(height=768).time_ids()
    # the scan's per-step tables: JAX's xs, scan_constants(schedule) + (ip_scales,)
    for steps in (1, 30):
        opts_p = phe.EditOptions(num_inference_steps=steps, ip_scale=0.6,
                                 control_guidance_start=0.2, control_guidance_end=0.7)
        opts_j = jhe.EditOptions(num_inference_steps=steps, ip_scale=0.6,
                                 control_guidance_start=0.2, control_guidance_end=0.7)
        sched_p, sched_j = psched.make("euler", steps), jsched.make("euler", steps)
        ref = [np.asarray(x) for x in jsched.scan_constants(sched_j)]
        for o, r in zip(psched.scan_constants(sched_p), ref):
            assert o.dtype == torch.float32 and o.shape == (steps,)
            np.testing.assert_array_equal(o.numpy(), r)
        tables = phe.scan_tables(sched_p, phe.ip_scale_schedule(opts_p))
        np.testing.assert_array_equal(tables.numpy(),
                                      np.stack(ref + [jhe.ip_scale_schedule(opts_j)]))


@pytest.mark.parametrize("text", ["a dog", "a photo of eight sheep!", "", "Six   CATS, a dog"])
def test_tokenizer_ids_match_jax(text):
    ours, theirs = ptok.build_toy_tokenizer(), jtok.build_toy_tokenizer()
    assert ours.encode(text) == theirs.encode(text)
    for a, b in zip(ptok.SDXLTokenizers(ours, ours)(text), jtok.SDXLTokenizers(theirs, theirs)(text)):
        np.testing.assert_array_equal(a, b)


def test_from_jax_keys_and_shapes_match_export_tree(pipes):
    """io/from_jax gives export_tree's keys and shapes, and the port's
    modules have exactly those keys."""
    jpipe, _ = pipes
    params = jax.device_get(jpipe.params)
    sd = from_jax.state_dict(params)
    ref = hf_import.export_tree(params)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    with torch.device("meta"):
        comps = pcomp.Components(pcomp.tiny_configs(vocab_size=len(jpipe.tokenizers.tok1.encoder)))
    assert set(comps.state_dict()) == set(sd)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without JAX or
    the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import imagharmony_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'imagharmony_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
