"""Shared helpers of the tests/test_torch_*.py files, which hold the PyTorch
port (imagharmony_tpu_torch) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides; JAX
weights come from the JAX package's tiny inits and reach the port through
io/from_jax. Both sides run in fp32 (the JAX conftest sets "highest"
matmul precision).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import pytest
import torch

from imagharmony_tpu_torch.io import from_jax

torch.set_num_threads(2)

# per-module parity tolerance, as the repo's reference-oracle tests use
TOL = dict(rtol=2e-5, atol=2e-5)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(x):
    """numpy -> CPU torch tensor."""
    return torch.as_tensor(np.asarray(x))


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def nchw(x):
    return t(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def nhwc(x):
    return np_(x.permute(0, 2, 3, 1))


def load(module, jax_tree, *, skip_prefixes=()):
    """Load a JAX parameter tree into ``module`` through io/from_jax; every
    parameter of the module must be covered."""
    import jax

    sd = {k: v for k, v in from_jax.state_dict(jax.device_get(jax_tree)).items()
          if not k.startswith(tuple(skip_prefixes))}
    module.load_state_dict(sd, strict=True)
    return module.eval().requires_grad_(False)


def close(port, ref, **tol):
    np.testing.assert_allclose(np_(port), np.asarray(ref, np.float32), **(tol or TOL))


@pytest.fixture()
def cuda():
    """The CUDA device, or a skip: K1 has no CPU mode, its own tests run on
    the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def tiny_pipes(text_layers=2):
    """(JAX tiny SDXL pipeline, the port over the same weights), fp32 on the
    CPU, built once a process; ``text_layers``: the depth of both text
    towers (clip_skip needs three)."""
    import dataclasses

    import jax
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.models import tokenizer as jtok
    from imagharmony_tpu.pipelines import HarmonyPipeline as JaxPipeline
    from imagharmony_tpu.pipelines import components as jcomp
    from imagharmony_tpu_torch.pipelines import components as pcomp
    from imagharmony_tpu_torch.pipelines import harmony_edit as phe

    def deepen(cfgs):
        return dataclasses.replace(
            cfgs, text_l=dataclasses.replace(cfgs.text_l, num_layers=text_layers),
            text_g=dataclasses.replace(cfgs.text_g, num_layers=text_layers))

    if text_layers == 2:
        jpipe = JaxPipeline.random_tiny(seed=0)
    else:
        toy = jtok.build_toy_tokenizer()
        cfgs = deepen(jcomp.tiny_configs(vocab_size=len(toy.encoder)))
        jpipe = JaxPipeline(jcomp.init_params(0, cfgs), cfgs, jtok.SDXLTokenizers(toy, toy))
    jpipe.policy = jdt.FP32
    cfgs = deepen(pcomp.tiny_configs(vocab_size=len(jpipe.tokenizers.tok1.encoder)))
    port = phe.HarmonyPipeline.from_state_dict(
        from_jax.state_dict(jax.device_get(jpipe.params)), cfgs, device="cpu")
    return jpipe, port


def nonzero_controlnet_outputs(tree, seed):
    """A JAX ControlNet tree with its zero-initialized output convs drawn
    N(0, 0.2²), in place: a fresh ControlNet is an exact no-op and would
    prove nothing."""
    rng = np.random.default_rng(seed)

    def draw(conv):
        return {k: (0.2 * rng.standard_normal(np.shape(v))).astype(np.float32)
                for k, v in conv.items()}

    tree["controlnet_cond_embedding"]["conv_out"] = draw(
        tree["controlnet_cond_embedding"]["conv_out"])
    tree["controlnet_down_blocks"] = [draw(c) for c in tree["controlnet_down_blocks"]]
    tree["controlnet_mid_block"] = draw(tree["controlnet_mid_block"])
    return tree


@functools.lru_cache(maxsize=None)
def controlnet_pipes():
    """(JAX tiny SDXL pipeline with a tiny ControlNet whose output convs are
    non-zero, the port over the same weights), fp32 on the CPU."""
    import dataclasses

    import jax
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.models import controlnet as jcn
    from imagharmony_tpu.models import tokenizer as jtok
    from imagharmony_tpu.pipelines import HarmonyPipeline as JaxPipeline
    from imagharmony_tpu.pipelines import components as jcomp
    from imagharmony_tpu_torch.models import controlnet as pcn
    from imagharmony_tpu_torch.pipelines import components as pcomp
    from imagharmony_tpu_torch.pipelines import harmony_edit as phe

    toy = jtok.build_toy_tokenizer()
    cfgs = jcomp.tiny_configs(vocab_size=len(toy.encoder))
    cfgs = dataclasses.replace(cfgs, controlnet=jcn.ControlNetConfig(
        base=cfgs.unet, conditioning_embedding_channels=(8, 16)))
    params = jax.device_get(jcomp.init_params(0, cfgs))
    nonzero_controlnet_outputs(params["controlnet"], 5)
    jpipe = JaxPipeline(params, cfgs, jtok.SDXLTokenizers(toy, toy))
    jpipe.policy = jdt.FP32
    pcfgs = pcomp.tiny_configs(vocab_size=len(toy.encoder))
    pcfgs = dataclasses.replace(pcfgs, controlnet=pcn.ControlNetConfig(
        base=pcfgs.unet, conditioning_embedding_channels=(8, 16)))
    port = phe.HarmonyPipeline.from_state_dict(from_jax.state_dict(params), pcfgs, device="cpu")
    return jpipe, port


@functools.lru_cache(maxsize=None)
def refiner_pipes():
    """(JAX tiny SDXL-refiner pipeline, the port over the same weights),
    fp32 on the CPU."""
    import jax
    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.pipelines import HarmonyPipeline as JaxPipeline
    from imagharmony_tpu_torch.pipelines import components as pcomp
    from imagharmony_tpu_torch.pipelines import harmony_edit as phe

    jpipe = JaxPipeline.random_tiny_refiner(seed=1)
    jpipe.policy = jdt.FP32
    cfgs = pcomp.sdxl_refiner_tiny_configs(vocab_size=len(jpipe.tokenizers.tok1.encoder))
    port = phe.HarmonyPipeline.from_state_dict(
        from_jax.state_dict(jax.device_get(jpipe.params)), cfgs, device="cpu")
    return jpipe, port


def jax_capture(jpipe, image, **kw):
    """The JAX package's generate(image, **kw) with every step's latents
    recorded: a debug callback on the scheduler step (on the inpaint blend,
    where there is one) inside its one jitted program. -> (list of
    (B, h, w, 4) step latents, the output as numpy)."""
    import jax
    from imagharmony_tpu.pipelines import harmony_edit as jhe
    from imagharmony_tpu.schedulers import diffusion as jsched

    steps, blends = [], []
    step_s, blend = jsched.step_s, jhe._inpaint_blend

    def recorded(fn, store):
        def run(*a, **k):
            out = fn(*a, **k)
            lat = out[0] if isinstance(out, tuple) else out
            jax.debug.callback(lambda x: store.append(np.asarray(x, np.float32)), lat,
                               ordered=True)
            return out
        return run

    # a jit of its own, traced anew with the callbacks; the shared one's cache
    # is left as it is
    edit_jit = jhe._edit_jit
    jhe._edit_jit = jax.jit(edit_jit.__wrapped__, static_argnames=(
        "cfgs", "opts", "policy", "backend", "num_samples"))
    jsched.step_s, jhe._inpaint_blend = recorded(step_s, steps), recorded(blend, blends)
    try:
        out = np.asarray(jpipe.generate(image, **kw), np.float32)
    finally:
        jsched.step_s, jhe._inpaint_blend, jhe._edit_jit = step_s, blend, edit_jit
    return blends or steps, out


def jax_step_draws(scheduler, seed, n, shape):
    """The N(0, 1) draws the JAX package's stochastic samplers make in a
    run of ``seed``: the ancestral key split once a step."""
    import jax
    import jax.numpy as jnp
    from imagharmony_tpu.pipelines import harmony_edit as jhe

    key, out = jhe.ancestral_key(scheduler, [seed]), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def edit_parity(jpipe, port, image, *, steps=3, seed=7, height=32, width=32, **kw):
    """One grouped call: the JAX package's generate() and the port's eager
    edit (``parity.run_capture``, the loop body generate()'s programs
    capture) on JAX's initial noise (or the given handoff ``latents``) and,
    for the stochastic samplers, JAX's per-step draws; every step's latents
    and the output at cosine > 0.9999. Returns (port capture, JAX output)."""
    import jax
    import jax.numpy as jnp
    from imagharmony_tpu_torch.utils import parity

    kw = dict(dict(prompt="a dog", extra_text="six dogs", output_type="raw"), **kw)
    j_steps, j_out = jax_capture(jpipe, image, num_inference_steps=steps, seed=seed,
                                 height=height, width=width, **kw)
    down = port.cfgs.vae.downscale
    shape = (1, height // down, width // down, 4)
    if kw.get("latents") is None:
        kw["noise"] = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    if kw.get("scheduler") in ("euler_a", "lcm"):
        kw["_step_noise"] = jax_step_draws(kw["scheduler"], seed, len(j_steps), shape)
    cap = parity.run_capture(port, image, steps=steps, seed=seed, height=height, width=width,
                             **kw)
    rep = parity.compare(cap, {"latents": np.stack(j_steps), "image": j_out})
    assert len(rep["per_step_cosine"]) == len(j_steps) == len(cap["latents"]) - 1, rep
    assert cap["image"].shape == j_out.shape
    assert rep["min_cosine"] > 0.9999, rep
    assert rep["image_cosine"] > 0.9999, rep
    return cap, j_out


@contextlib.contextmanager
def group_of_one(tmp_path):
    """A gloo process group of this process alone (a world of one), for the
    block: the parallel code paths with every collective over one rank."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "group_of_one"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
