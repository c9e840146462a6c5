"""Adapter training in the port (imagharmony_tpu_torch/train/, the VAE
encoder, the export) against the JAX package on the CPU, fp32, tiny
configs, and the port's trainer on its own.

The JAX side runs as its own tests run it on the CPU (attention through
XLA). The machine with the card has no JAX: this module imports JAX only
inside fixtures and tests, and its card-only test (marked ``cuda``) runs
there with

    python -m pytest tests/test_torch_train.py -m cuda --noconftest -p no:cacheprovider
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from imagharmony_tpu_torch.io import checkpoints as pckpt
from imagharmony_tpu_torch.io import from_jax
from imagharmony_tpu_torch.kernels import flash_attention as fa
from imagharmony_tpu_torch.pipelines import components as pcomp
from imagharmony_tpu_torch.train import step as pstep
from imagharmony_tpu_torch.train import trainer as ptrainer
from torch_port_util import close, cuda, np_  # noqa: F401  (cuda is a fixture)


def _jax_train_config(**kw):
    from imagharmony_tpu.train import step as jstep

    return jstep.TrainConfig(**kw)


@pytest.fixture(scope="module")
def case():
    """The JAX tiny bundle, the port over the same weights (CPU, fp32), a
    dummy batch, and JAX's loss, gradients and draws for one key. The JAX
    loss and gradients are what make_train_step computes (its
    value_and_grad(loss_fn)); JAX's remat is off here (it changes no value
    and doubles the compile), the port's checkpointing stays on."""
    return _case()


def _case(fusion_method="cross_attention"):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.pipelines import components as jcomp
    from imagharmony_tpu.train import step as jstep

    jcfgs = jcomp.tiny_configs()
    jcfgs = dataclasses.replace(jcfgs, harmony=dataclasses.replace(
        jcfgs.harmony, fusion_method=fusion_method))
    params = jax.device_get(jcomp.init_params(jax.random.PRNGKey(0), jcfgs))
    tcfg_j = jstep.TrainConfig(unet_cfg=jcfgs.unet, gradient_checkpoint=False)
    state, frozen = jstep.init_state(params, tcfg_j)
    batch = jstep.dummy_batch(jcfgs, 2, 32)
    rng = jax.random.PRNGKey(7)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda tr, fr, b, r: jstep.loss_fn(tr, fr, jcfgs, tcfg_j, b, r, policy=jdt.FP32)))
    loss, grads = grad_fn(state["trainable"], frozen, batch, rng)
    # the draws loss_fn takes from rng (step.py:189, 204, 216-223)
    r_noise, r_t, r_lat, _ = jax.random.split(rng, 4)
    shape = (2, 32 // jcfgs.vae.downscale, 32 // jcfgs.vae.downscale, 4)
    draws = pstep.Draws(
        noise=torch.tensor(np.asarray(jax.random.normal(r_noise, shape, jnp.float32))),
        timesteps=torch.tensor(np.asarray(jax.random.randint(r_t, (2,), 0, 1000))).long(),
        latent_eps=torch.tensor(np.asarray(jax.random.normal(r_lat, shape, jnp.float32))),
    )
    pcfgs = pcomp.tiny_configs()
    pcfgs = dataclasses.replace(pcfgs, harmony=dataclasses.replace(
        pcfgs.harmony, fusion_method=fusion_method))
    comps = pcomp.Components(pcfgs)
    pcomp.load_state_dict_(comps, from_jax.state_dict(params))
    return dict(jcfgs=jcfgs, params=params, pcfgs=pcfgs, comps=comps, batch=batch,
                draws=draws, loss=float(loss), grads=jax.device_get(grads),
                grad_norm=float(optax.global_norm(grads)), state=state, frozen=frozen)


LORA = dict(lora_rank=2, lora_alpha=3.0)  # scale 1.5


@pytest.fixture(scope="module")
def lora_case(case):
    """The JAX trainer state with LoRA factors (``LORA``) whose B is drawn
    nonzero (a fresh B is 0, and then dA = s * dW' B^T is exactly 0), and
    JAX's loss and gradients for the case's batch and key."""
    import jax
    import optax

    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.train import step as jstep

    jcfgs = case["jcfgs"]
    tcfg_j = jstep.TrainConfig(unet_cfg=jcfgs.unet, gradient_checkpoint=False, **LORA)
    state, frozen = jstep.init_state(case["params"], tcfg_j, seed=7)
    r = np.random.default_rng(11)  # B at 1e-2: deltas ~15% of the weights' spread
    state["trainable"]["lora"] = jax.tree_util.tree_map_with_path(
        lambda path, x: (r.normal(size=x.shape).astype(np.float32) * 0.01
                         if path[-1].key == "lora_b" else x), state["trainable"]["lora"])
    grad_fn = jax.jit(jax.value_and_grad(
        lambda tr, fr, b, k: jstep.loss_fn(tr, fr, jcfgs, tcfg_j, b, k, policy=jdt.FP32)))
    loss, grads = grad_fn(state["trainable"], frozen, case["batch"], jax.random.PRNGKey(7))
    return dict(tcfg_j=tcfg_j, state=state, loss=float(loss), grads=jax.device_get(grads),
                grad_norm=float(optax.global_norm(grads)))


def _cached_batch(jcfgs, rows=2, resolution=32):
    """A batch in train/cache.py's schema, random (JAX layout, numpy)."""
    r = np.random.default_rng(12)
    side = resolution // jcfgs.vae.downscale
    seq = jcfgs.text_l.max_position_embeddings
    ctx = jcfgs.text_l.hidden_size + jcfgs.text_g.hidden_size

    def f32(*shape):
        return r.normal(size=shape).astype(np.float32)

    return {"latent_mean": f32(rows, side, side, 4), "latent_logvar": f32(rows, side, side, 4) - 2,
            "context": f32(rows, seq, ctx), "pooled": f32(rows, jcfgs.text_g.projection_dim),
            "extra_context": f32(rows, seq, ctx),
            "image_embeds": f32(rows, jcfgs.vision.projection_dim),
            "original_size": np.full((rows, 2), resolution, np.float32),
            "crop_coords": np.zeros((rows, 2), np.float32),
            "target_size": np.full((rows, 2), resolution, np.float32),
            "drop_image": np.array([0.0, 1.0], np.float32)[:rows]}


def test_train_step_loss_and_gradients_match_jax(case, lora_case, tmp_path):
    """The port's loss on the JAX draws: loss and grad_norm within 1e-5
    relative, every trainable gradient within 1e-4 of its leaf's max-abs
    (with a floor of 1e-9: a leaf whose gradient is zero in exact arithmetic,
    such as the HA cross-attention's to_k bias, carries only ~1e-12 of fp32
    noise on both sides). Inert IP projections have no gradient in the port
    and exact zeros in JAX. Then the same with the HA head's ``qformer``
    fusion (the trainer's ``--fusion_method qformer``); with LoRA factors
    carried from the JAX state (B nonzero), their A and B gradients
    included; with ``lora_alpha`` 0, the plain step's loss and gradients
    (the JAX package's own check); on a cached-encoder batch with the
    towers dropped, against JAX's cached branch; and over ranks
    (``_check_parallel``: the spec functions, a world of one, 2-rank DP
    and FSDP steps, the DP+FSDP resume)."""
    _check_loss_and_gradients(case)
    _check_loss_and_gradients(_case("qformer"))
    grads = _check_loss_and_gradients(
        case, pstep.TrainConfig(unet_cfg=case["pcfgs"].unet, **LORA), lora_case)
    lora_grads = [g for n, g in grads.items() if n.startswith("lora.")]
    assert lora_grads and all(g is not None and float(g.abs().max()) > 0 for g in lora_grads)

    # lora_alpha 0: the merge adds exact zeros, so the plain step's values
    plain = _loss_and_grads(case, pstep.TrainConfig(unet_cfg=case["pcfgs"].unet))
    zero = _loss_and_grads(case, pstep.TrainConfig(unet_cfg=case["pcfgs"].unet, lora_rank=2,
                                                   lora_alpha=0.0))
    assert abs(zero[0] - plain[0]) <= 1e-6 * abs(plain[0])
    for name, g in plain[1].items():
        close(zero[1][name], g, rtol=0, atol=max(1e-6 * float(g.abs().max()), 1e-9))
    assert all(float(g.abs().max()) == 0 for n, g in zero[1].items() if n.startswith("lora."))

    _check_cached(case)
    _check_parallel(case, tmp_path)


def _check_spec_functions(case):
    """``fit_data_axis``, ``fsdp_spec`` and ``tp_spec`` against the JAX
    package's: its cases of test_parallel.py, then every leaf of the tiny
    bundle and of the LoRA factors, where the port's spec (torch layout)
    must put the axis on the JAX leaf's axis (``from_jax.jax_order``)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from imagharmony_tpu.parallel import fsdp as jfsdp
    from imagharmony_tpu.parallel import mesh as jmesh
    from imagharmony_tpu.parallel import tp_rules as jtp
    from imagharmony_tpu.train import step as jstep
    from imagharmony_tpu_torch.parallel import fsdp as pfsdp
    from imagharmony_tpu_torch.parallel import mesh as pmesh
    from imagharmony_tpu_torch.parallel import tp_rules as ptp

    for world in (1, 2, 3, 8):
        for batch in range(1, 10):
            want = jmesh.fit_data_mesh(batch, devices=jax.devices()[:world]).devices.shape
            assert (pmesh.fit_data_axis(batch, world), 1) == want, (batch, world)
    for shape, n, kw in [((128, 64), 4, {}), ((64, 128), 4, {}),
                         ((128, 64), 4, {"base": (None, "model")}), ((3, 3, 16, 64), 4, {}),
                         ((7, 9), 4, {}), ((32,), 4, {"min_elems": 2**13}),
                         ((), 4, {"min_elems": 0}), ((128,), 1, {})]:
        kw = {"min_elems": 1, **kw}
        jkw = dict(kw, base=P(*kw["base"])) if "base" in kw else kw
        assert pfsdp.fsdp_spec(shape, n, **kw) == tuple(
            jfsdp.fsdp_spec(np.zeros(shape), n, **jkw)), shape

    def torch_spec(jspec, order):
        out = [None] * len(order)
        for j, axis in enumerate(tuple(jspec) + (None,) * (len(order) - len(tuple(jspec)))):
            out[order[j]] = axis
        return tuple(out)

    lora = jstep.init_state(case["params"], jstep.TrainConfig(
        unet_cfg=case["jcfgs"].unet, lora_rank=2))[0]["trainable"]["lora"]
    seen = {"data": 0, "model": 0}
    for tree in (case["params"], lora):
        for path, leaf in from_jax._leaves(tree):
            key = from_jax.key_for(path)
            order = from_jax.jax_order(key, np.ndim(leaf))
            tshape = from_jax.to_torch_layout(path, leaf).shape
            got = pfsdp.fsdp_spec(tshape, 2, min_elems=64, order=order)
            want = torch_spec(jfsdp.fsdp_spec(leaf, 2, min_elems=64), order)
            assert (got or (None,) * len(order)) == want, (key, got, want)
            seen["data"] += "data" in want
            got = ptp.tp_spec(key, tshape)
            want = torch_spec(jtp.tp_spec(path, leaf), order)
            assert (got + (None,) * (len(order) - len(got))) == want, (key, got, want)
            seen["model"] += "model" in want
    assert seen["data"] > 300 and seen["model"] > 50, seen


def _check_parallel(case, tmp_path):
    """The parallel layer: the spec functions (``_check_spec_functions``);
    in a world of one (a gloo group of this process) the mesh's train step
    bit for bit the one-device step; then one spawn of two gloo ranks
    (``parallel.drills.train_drills``): a DP and a DP+FSDP step on the
    case's global batch and draws against JAX's single-device loss (1e-5
    relative), gradients (the tolerance above) and its optax update of the
    parameters (rtol 1e-4, atol 1e-5: JAX's own FSDP check), FSDP slicing
    as JAX's does (more than 20 frozen leaves, 5 trainable, 5 AdamW
    moments, each slice global / 2); the bf16 VAE's fp32 encode sliced bit
    for bit whole; the DP+FSDP trainer (an EMA, LoRA factors, the encoder
    cache of 3 JSON records, which each rank encodes its share of, padded
    to 2 and 2) 2 steps straight equal to 1 step and a --resume, bit for
    bit: losses and exports (live and EMA adapters, the factors); the
    straight run against the one-device run of the same arguments, losses
    at 1e-5 relative and every export at JAX's FSDP tolerance; and
    ``replicate`` giving every rank rank 0's tensor."""
    import jax
    import optax

    from imagharmony_tpu.train import step as jstep
    from imagharmony_tpu_torch.parallel import distributed, drills
    from imagharmony_tpu_torch.parallel import mesh as pmesh
    from torch_port_util import group_of_one

    _check_spec_functions(case)
    sd = {k: v.numpy() for k, v in from_jax.state_dict(case["params"]).items()}
    draws = {k: np_(getattr(case["draws"], k)) for k in ("noise", "latent_eps")}
    draws["timesteps"] = case["draws"].timesteps.numpy()
    kw = dict(gradient_checkpoint=False, learning_rate=1e-3)
    with group_of_one(tmp_path):
        plain = drills.train_step_once(sd, case["batch"], draws, kw, None)
        meshed = drills.train_step_once(sd, case["batch"], draws, kw, pmesh.make_mesh())
    assert (meshed["loss"], meshed["grad_norm"]) == (plain["loss"], plain["grad_norm"])
    for n, x in plain["params"].items():
        np.testing.assert_array_equal(meshed["params"][n], x, err_msg=n)

    (tmp_path / "records").mkdir()
    records = _records(tmp_path / "records", n=3)
    ranks = distributed.spawn(drills.train_drills, 2, threads=1, kwargs=dict(
        state_dict=sd, batch=case["batch"], draws=draws, root=str(tmp_path / "drill"),
        records=str(records)))
    one_dir = tmp_path / "one_device"
    assert ptrainer.main([*drills.resume_argv(records), "--max_steps", "2", "--output_dir",
                          str(one_dir)]) == 2
    one = drills.read_run(one_dir)
    tx = jstep.make_optimizer(jstep.TrainConfig(unet_cfg=case["jcfgs"].unet, learning_rate=1e-3))
    trainable = case["state"]["trainable"]
    updates, _ = jax.jit(tx.update)(case["grads"], tx.init(trainable), trainable)
    want = from_jax.trainable_state_dict(jax.device_get(optax.apply_updates(trainable, updates)))
    grads = from_jax.trainable_state_dict(case["grads"])
    for r in ranks:
        for mode in ("dp", "fsdp"):
            got = r[mode]
            assert abs(got["loss"] - case["loss"]) <= 1e-5 * abs(case["loss"]), (mode, got["loss"])
            assert abs(got["grad_norm"] - case["grad_norm"]) <= 1e-5 * case["grad_norm"], mode
            for n, g in grads.items():
                ref = g.numpy()
                mine = np.zeros_like(ref) if got["grads"][n] is None else got["grads"][n]
                np.testing.assert_allclose(mine, ref, rtol=0, err_msg=f"{mode} {n}",
                                           atol=max(1e-4 * np.abs(ref).max(), 1e-9))
                np.testing.assert_allclose(got["params"][n], want[n].numpy(), rtol=1e-4,
                                           atol=1e-5, err_msg=f"{mode} {n}")
        f = r["fsdp"]
        assert f["sliced_frozen"] > 20 and f["sliced_trainable"] > 5, f
        assert f["sliced_moments"] > 5 and f["local_numel_ok"], f
        assert r["dp"]["sliced"] == 0
        assert r["vae_bf16"][0] > 20 and r["vae_bf16"][1], r["vae_bf16"]
        straight, resumed = r["resume"]["straight"], r["resume"]["resumed"]
        assert straight["losses"] == resumed["losses"] and len(straight["losses"]) == 2
        assert resumed["checkpoints"] == ["step-1.pt", "step-2.pt"]
        for tag, x in straight["exports"].items():
            assert set(x) == set(resumed["exports"][tag]) and x
            for k, v in x.items():
                np.testing.assert_array_equal(resumed["exports"][tag][k], v, err_msg=k)
        np.testing.assert_allclose(straight["losses"], one["losses"], rtol=1e-5, atol=0)
        assert set(straight["exports"]) == set(one["exports"])
        for tag, x in one["exports"].items():
            assert set(straight["exports"][tag]) == set(x)
            for k, v in x.items():
                np.testing.assert_allclose(straight["exports"][tag][k], v, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{tag} {k}")
        np.testing.assert_array_equal(r["replicated"], np.ones(3, np.float32))
    for mode in ("dp", "fsdp"):
        assert ranks[0][mode]["loss"] == ranks[1][mode]["loss"]


def _loss_and_grads(case, tcfg):
    """The port's loss on the case's batch and draws and its trainable
    gradients by name (None for none)."""
    comps = copy.deepcopy(case["comps"])
    state = pstep.init_state(comps, tcfg, seed=3)
    loss = pstep.loss_fn(comps, tcfg, pstep.to_device(case["batch"], "cpu"), case["draws"],
                         state.factors)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in state.trainable.items() if p.grad is not None}


def _check_cached(case):
    """loss_fn on a cached-encoder batch, the four towers dropped, against
    JAX's cached branch (the same latent draw as the live path's), loss and
    gradients under the live check's tolerances."""
    import jax

    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.train import step as jstep
    from imagharmony_tpu_torch.train import cache as pcache

    jcfgs = case["jcfgs"]
    batch = _cached_batch(jcfgs)
    frozen = {k: (None if k in pcache.TOWERS else v) for k, v in case["frozen"].items()}
    tcfg_j = jstep.TrainConfig(unet_cfg=jcfgs.unet, gradient_checkpoint=False)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda tr, fr, b, k: jstep.loss_fn(tr, fr, jcfgs, tcfg_j, b, k, policy=jdt.FP32)))(
        case["state"]["trainable"], frozen, batch, jax.random.PRNGKey(7))
    comps = copy.deepcopy(case["comps"])
    assert pcache.drop_towers(comps) > 0 and comps.vae is None and comps.image_encoder is None
    tcfg = pstep.TrainConfig(unet_cfg=case["pcfgs"].unet)
    state = pstep.init_state(comps, tcfg)
    got = pstep.loss_fn(comps, tcfg, pstep.to_device(batch, "cpu"), case["draws"])
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    ref = from_jax.state_dict(jax.device_get(grads))
    for name, p in state.trainable.items():
        r = ref[name].numpy()
        g = np.zeros_like(r) if p.grad is None else np_(p.grad)
        np.testing.assert_allclose(g, r, rtol=0, atol=max(1e-4 * np.abs(r).max(), 1e-9),
                                   err_msg=name)
    comps.cfgs = dataclasses.replace(case["pcfgs"], proj_kind="resampler")
    with pytest.raises(ValueError, match="image_proj"):
        pstep.loss_fn(comps, tcfg, pstep.to_device(batch, "cpu"), case["draws"])


def _check_loss_and_gradients(case, tcfg=None, ref_case=None):
    """The port's loss and trainable gradients against ``ref_case``'s JAX
    ones (``case``'s by default); with LoRA the port's state is carried from
    the JAX state (``from_jax.train_state_dict``). Returns the gradients."""
    ref_case = ref_case or case
    comps = copy.deepcopy(case["comps"])
    tcfg = tcfg or pstep.TrainConfig(unet_cfg=case["pcfgs"].unet)
    state = pstep.init_state(comps, tcfg)
    if tcfg.lora_rank:
        state.load_state_dict(from_jax.train_state_dict(ref_case["state"], state))
    loss = pstep.loss_fn(comps, tcfg, pstep.to_device(case["batch"], "cpu"), case["draws"],
                         state.factors)
    loss.backward()
    assert abs(loss.item() - ref_case["loss"]) <= 1e-5 * abs(ref_case["loss"])
    ref = from_jax.trainable_state_dict(ref_case["grads"])
    assert set(ref) == set(state.trainable)
    norm = pstep.global_norm([p.grad for p in state.trainable.values()])
    assert abs(float(norm) - ref_case["grad_norm"]) <= 1e-5 * ref_case["grad_norm"]
    assert case["pcfgs"].harmony.fusion_method == case["jcfgs"].harmony.fusion_method
    n_live = 0
    for name, p in state.trainable.items():
        r = ref[name].numpy()
        g = np.zeros_like(r) if p.grad is None else np_(p.grad)
        np.testing.assert_allclose(g, r, rtol=0, atol=max(1e-4 * np.abs(r).max(), 1e-9),
                                   err_msg=name)
        n_live += p.grad is not None
    assert 0 < n_live < len(state.trainable)  # inert projections get none
    return {n: p.grad for n, p in state.trainable.items()}


@pytest.mark.parametrize("train_image_proj", [False, True], ids=["adapter", "adapter+proj"])
def test_trainable_surface_matches_jax(case, train_image_proj):
    """set_trainable with each predicate marks exactly the parameters the
    JAX split_by_path selects, and freezes the rest."""
    from imagharmony_tpu.utils import tree as jtree

    jpred = (jtree.adapter_plus_proj_predicate if train_image_proj
             else jtree.adapter_predicate)
    selected, _ = jtree.split_by_path(case["params"], jpred)
    comps = copy.deepcopy(case["comps"])
    trainable = pstep.init_state(
        comps, pstep.TrainConfig(train_image_proj=train_image_proj)).trainable
    assert set(trainable) == set(from_jax.state_dict(selected))
    assert all(p.requires_grad == (n in trainable) for n, p in comps.named_parameters())


def test_adamw_matches_optax(case, lora_case):
    """The same gradients into optax (JAX make_optimizer: clip_by_global_norm
    then masked adamw) and into the port's update: parameters after one and
    two updates within 1e-6. Both branches of the port's branch-free clip:
    the gradients' norm above max_grad_norm (the clip scales them), then a
    quarter of the gradients, exact in fp32, whose norm is below it (the
    clip keeps them). Then with LoRA factors (decayed, as JAX's mask gives
    them) and the EMA (JAX make_train_step's formula): the port's state
    carried from the JAX state before the first update, and a second port
    state carried from JAX's after it (AdamW moments and count included),
    both against optax after the second."""
    import jax
    import optax

    from imagharmony_tpu.train import step as jstep

    kw = dict(learning_rate=1e-3, weight_decay=0.1, max_grad_norm=0.5 * case["grad_norm"])
    tcfg_j = jstep.TrainConfig(unet_cfg=case["jcfgs"].unet, **kw)
    tx = jstep.make_optimizer(tcfg_j)
    tcfg = pstep.TrainConfig(unet_cfg=case["pcfgs"].unet, **kw)

    @jax.jit
    def update(grads, opt_state, trainable):
        updates, opt_state = tx.update(grads, opt_state, trainable)
        return optax.apply_updates(trainable, updates), opt_state

    for f in (1.0, 0.25):
        jgrads = jax.tree.map(lambda g: g * np.float32(f), case["grads"])
        grads = from_jax.state_dict(jgrads)
        trainable = case["state"]["trainable"]
        opt_state = tx.init(trainable)
        state = pstep.init_state(copy.deepcopy(case["comps"]), tcfg)
        for _ in range(2):
            trainable, opt_state = update(jgrads, opt_state, trainable)
            for n, p in state.trainable.items():
                p.grad = grads[n].clone()
            pstep.apply_update(state, tcfg)
            ref = from_jax.state_dict(jax.device_get(trainable))
            for n, p in state.trainable.items():
                close(p, ref[n], rtol=0, atol=1e-6)

    # LoRA factors and the EMA
    decay = 0.9
    lkw = dict(kw, max_grad_norm=0.5 * lora_case["grad_norm"], ema_decay=decay)
    tx_l = jstep.make_optimizer(dataclasses.replace(lora_case["tcfg_j"], **lkw))
    tcfg = pstep.TrainConfig(unet_cfg=case["pcfgs"].unet, **lkw, **LORA)

    @jax.jit
    def update_l(grads, opt_state, trainable):
        updates, opt_state = tx_l.update(grads, opt_state, trainable)
        return optax.apply_updates(trainable, updates), opt_state

    jgrads = lora_case["grads"]
    grads = from_jax.trainable_state_dict(jgrads)
    jstate = {"trainable": lora_case["state"]["trainable"],
              "opt_state": tx_l.init(lora_case["state"]["trainable"]),
              "ema": lora_case["state"]["trainable"]}
    ports = []
    for step in range(2):
        state = pstep.init_state(copy.deepcopy(case["comps"]), tcfg)
        state.load_state_dict(from_jax.train_state_dict(jstate, state))
        ports.append(state)
        trainable, opt_state = update_l(jgrads, jstate["opt_state"], jstate["trainable"])
        jstate = {"trainable": trainable, "opt_state": opt_state,
                  "ema": jax.tree.map(lambda e, p: e * decay + p * (1.0 - decay),
                                      jstate["ema"], trainable)}
        for state in ports:
            for n, p in state.trainable.items():
                p.grad = grads[n].clone()
            pstep.apply_update(state, tcfg)
    ref = from_jax.trainable_state_dict(jax.device_get(jstate["trainable"]))
    ref_ema = from_jax.trainable_state_dict(jax.device_get(jstate["ema"]))
    assert any(n.startswith("lora.") for n in ref) and set(ref) == set(ports[0].trainable)
    for state in ports:
        assert state.step == 2 and int(state.count) == 2
        for n, p in state.trainable.items():
            close(p, ref[n], rtol=0, atol=1e-6)
            close(state.ema[n], ref_ema[n], rtol=0, atol=1e-6)


def test_inert_ip_projections_not_decayed(case):
    """One port train step with weight decay: the inert mid-block IP
    projection stays bit-identical, the live one moves. The step's draws go
    into static buffers first (``step_draws`` with ``out=``, as a captured
    program takes them): they equal ``draw``'s values on the same generator
    bit for bit, also with a noise offset and two microbatches, and leave
    the generator in the same state."""
    import dataclasses

    comps = copy.deepcopy(case["comps"])
    tcfg = pstep.TrainConfig(learning_rate=1e-2, weight_decay=0.1, gradient_checkpoint=False,
                             unet_cfg=case["pcfgs"].unet)
    state = pstep.init_state(comps, tcfg)
    inert = "unet.mid_block.attentions.0.transformer_blocks.0.attn2.to_k_ip.weight"
    live = "unet.down_blocks.2.attentions.1.transformer_blocks.0.attn2.to_k_ip.weight"
    before = {n: state.trainable[n].detach().clone() for n in (inert, live)}
    step_draws = None
    for cfg in (tcfg, dataclasses.replace(tcfg, noise_offset=0.05, grad_accum=2)):
        ref_gen = torch.Generator().manual_seed(0)
        ref = [pstep.draw(ref_gen, case["pcfgs"], cfg, 2 // cfg.grad_accum, 32)
               for _ in range(cfg.grad_accum)]
        bufs = [pstep.Draws(*(None if x is None else torch.full_like(x, 7) for x in
                              (d.noise, d.timesteps, d.latent_eps, d.offset))) for d in ref]
        gen = torch.Generator().manual_seed(0)
        draws = pstep.step_draws(gen, case["pcfgs"], cfg, 2, 32, out=bufs)
        assert torch.equal(gen.get_state(), ref_gen.get_state())
        for got, want, buf in zip(draws, ref, bufs):
            for f in ("noise", "timesteps", "latent_eps", "offset"):
                x, y, b = (getattr(d, f) for d in (got, want, buf))
                assert (x is b is y is None) or (x is b and torch.equal(x, y)), f
        step_draws = step_draws or draws
    m = pstep.train_step(state, comps, tcfg, pstep.to_device(case["batch"], "cpu"), step_draws)
    assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0
    torch.testing.assert_close(state.trainable[inert], before[inert], rtol=0, atol=0)
    assert float((state.trainable[live] - before[live]).detach().abs().max()) > 0


@pytest.mark.parametrize("sched", [dict(), dict(lr_warmup_steps=3),
                                   dict(lr_schedule="cosine", lr_warmup_steps=2,
                                        lr_total_steps=6)],
                         ids=["constant", "warmup", "cosine"])
def test_lr_schedule_matches_optax(sched):
    """The lr the port's optimizer applies at its k-th update, gathered from
    the schedule's device table (``lr_table``) at the update count into the
    0-dim lr tensor every param group reads, equals optax's schedule at
    count k (0-based), checked through step 0, 1, the warmup end and past
    the horizon (where the table's last entry holds); 1e-6 relative, as
    optax evaluates its schedules in fp32."""
    from imagharmony_tpu.train import step as jstep

    ref = jstep.learning_rate(_jax_train_config(learning_rate=1e-3, **sched))
    fn = ref if callable(ref) else (lambda count: ref)
    cfg = pstep.TrainConfig(learning_rate=1e-3, **sched)
    p = torch.nn.Parameter(torch.zeros(3))
    table, lr = pstep.lr_table(cfg), torch.zeros(())
    count = torch.zeros(1, dtype=torch.long)
    opt = pstep.make_optimizer({"harmony.w": p}, cfg, lr)
    for k in range(8):
        want = float(fn(k))
        lr.copy_(pstep.lr_at(table, count))
        assert all(g["lr"] is lr for g in opt.param_groups)
        got = float(lr)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), (k, got, want)
        assert pstep.learning_rate(cfg)(k) == pytest.approx(want, rel=1e-6, abs=1e-12)
        p.grad = torch.ones(3)
        opt.step()
        count += 1


def test_seed_ip_from_unet_matches_jax(case):
    from imagharmony_tpu.train import trainer as jtrainer

    params = copy.deepcopy(case["params"])
    jtrainer._seed_ip_from_unet(params["unet"], case["jcfgs"].unet)
    comps = copy.deepcopy(case["comps"])
    pcomp.seed_ip_from_unet(comps.unet)
    ref = from_jax.state_dict(params["unet"])
    sd = comps.unet.state_dict()
    assert set(sd) == set(ref)
    for k in sd:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)


def test_export_matches_jax(case, tmp_path):
    """save_adapter_checkpoint from JAX and from the port over the same
    weights, both read with torch.load: the same keys and equal values; the
    port's HA config is the JAX one less the unported fusions' fields."""
    from imagharmony_tpu.io import checkpoints as jckpt

    params, jcfgs = case["params"], case["jcfgs"]
    jckpt.save_adapter_checkpoint(
        tmp_path / "jax.bin", unet_params=params["unet"], unet_cfg=jcfgs.unet,
        image_proj_params=params["image_proj"], harmony_params=params["harmony"],
        harmony_cfg=jcfgs.harmony)
    comps = case["comps"]
    pckpt.save_adapter_checkpoint(
        tmp_path / "port.bin", unet=comps.unet, unet_cfg=case["pcfgs"].unet,
        image_proj=comps.image_proj, harmony=comps.harmony, harmony_cfg=case["pcfgs"].harmony)
    # the JAX writer pickles numpy arrays: a full load of a file this test wrote
    a = torch.load(tmp_path / "jax.bin", weights_only=False)
    b = torch.load(tmp_path / "port.bin", weights_only=True)
    assert set(a) == set(b) == {"image_proj", "ip_adapter", "composed_adapter", "harmony_config"}
    for group in ("image_proj", "ip_adapter", "composed_adapter"):
        assert set(a[group]) == set(b[group]), group
        for k in a[group]:
            torch.testing.assert_close(b[group][k], torch.as_tensor(a[group][k]), rtol=0, atol=0)
    cfg_a, cfg_b = json.loads(a["harmony_config"]), json.loads(b["harmony_config"])
    assert {k: cfg_a[k] for k in cfg_b} == cfg_b
    # JAX's own reader takes the port's files, .bin and .safetensors
    pckpt.save_adapter_checkpoint(
        tmp_path / "port.safetensors", unet=comps.unet, unet_cfg=case["pcfgs"].unet,
        image_proj=comps.image_proj, harmony=comps.harmony, harmony_cfg=case["pcfgs"].harmony)
    jckpt.save_adapter_checkpoint(
        tmp_path / "jax.safetensors", unet_params=params["unet"], unet_cfg=jcfgs.unet,
        image_proj_params=params["image_proj"], harmony_params=params["harmony"],
        harmony_cfg=jcfgs.harmony)
    for name in ("port.bin", "port.safetensors"):
        proj, ip, composed, ha_cfg = jckpt.load_adapter_checkpoint(tmp_path / name)
        assert {k: getattr(ha_cfg, k) for k in cfg_b} == cfg_b
        for group, got in (("image_proj", proj), ("ip_adapter", ip),
                           ("composed_adapter", composed)):
            assert set(got) == set(b[group]), (name, group)
            for k in got:
                np.testing.assert_array_equal(got[k], b[group][k].numpy())
    # the port's reader on every file: the JAX reader's values
    for name in ("jax.bin", "jax.safetensors", "port.bin", "port.safetensors"):
        ours, theirs = pckpt.load_adapter_checkpoint(tmp_path / name), \
            jckpt.load_adapter_checkpoint(tmp_path / name)
        assert {k: getattr(ours[3], k) for k in cfg_b} == cfg_b
        for got, want in zip(ours[:3], theirs[:3]):
            assert set(got) == set(want), name
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # the legacy composed layout ("cross_attention." for "fusion_text_image.")
    legacy = {k.replace("fusion_text_image.", "cross_attention."): v
              for k, v in pckpt.load_adapter_checkpoint(tmp_path / "jax.bin")[2].items()}
    ha = copy.deepcopy(comps.harmony)
    for p in ha.parameters():
        p.data.zero_()
    pckpt.import_harmony(ha, legacy)
    want = from_jax.state_dict(jckpt.import_harmony(
        params["harmony"], {k: v.numpy() for k, v in legacy.items()}))
    for k, v in ha.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)

    # safetensors both ways, and with the safetensors package
    import ml_dtypes
    from safetensors.torch import load_file

    from imagharmony_tpu.io import safetensors_io
    from imagharmony_tpu_torch.io import safetensors as pst

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
               "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
               "i64": torch.arange(-4, 5, dtype=torch.int64), "scalar": torch.tensor(2.5)}
    pst.save(tmp_path / "port.st", tensors, metadata={"k": "v"})
    back, meta = pst.load(tmp_path / "port.st")
    jax_back, jax_meta = safetensors_io.load(tmp_path / "port.st")
    pkg_back = load_file(tmp_path / "port.st")
    assert meta == jax_meta == {"k": "v"}
    for k, v in tensors.items():
        for got in (back[k], pkg_back[k], torch.from_numpy(
                np.asarray(jax_back[k], np.float32) if k == "bf16" else jax_back[k].copy())):
            torch.testing.assert_close(got.to(v.dtype), v, rtol=0, atol=0)
    # (the JAX writer stores a 0-dim array as shape [1])
    safetensors_io.save(tmp_path / "jax.st", {
        k: v.float().numpy().astype(ml_dtypes.bfloat16) if k == "bf16" else v.numpy()
        for k, v in tensors.items() if v.dim()})
    back = pst.load(tmp_path / "jax.st")[0]
    assert set(back) == set(tensors) - {"scalar"}
    for k, v in back.items():
        torch.testing.assert_close(v, tensors[k], rtol=0, atol=0)

    # convert_training_checkpoints on an accelerate-style dump
    dump = {f"image_proj_model.{k}": v for k, v in comps.image_proj.state_dict().items()}
    dump.update({f"adapter_modules.{k}": v for k, v in b["ip_adapter"].items()})
    dump.update({f"composed_modules.{k}": v for k, v in comps.harmony.state_dict().items()})
    for side in ("jax", "port"):
        (tmp_path / side / "checkpoint-2").mkdir(parents=True)
        torch.save(dump, tmp_path / side / "checkpoint-2" / "pytorch_model.bin")
    assert len(jckpt.convert_training_checkpoints(tmp_path / "jax")) == 1
    assert len(pckpt.convert_training_checkpoints(tmp_path / "port")) == 1
    x, y = (pckpt.load_adapter_checkpoint(tmp_path / side / "checkpoint-2" / "ip_adapter.bin")
            for side in ("jax", "port"))
    for got, want in zip(y[:3], x[:3]):
        assert set(got) == set(want) and got
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)

    # the .bin reader runs no code from the file
    import pickle
    import zipfile

    from imagharmony_tpu_torch.io import torch_zip

    with zipfile.ZipFile(tmp_path / "evil.bin", "w") as zf:
        zf.writestr("archive/data.pkl", pickle.dumps({"x": os.system}, protocol=2))
    with pytest.raises(pickle.UnpicklingError, match="blocked global"):
        torch_zip.load(tmp_path / "evil.bin")


def _records(tmp_path, n=2):
    from PIL import Image

    rng = np.random.default_rng(3)
    recs = []
    for i, (h, w) in enumerate([(40, 56), (64, 48), (48, 40)][:n]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
        recs.append({"image_file": f"img{i}.png", "text": "a photo of six sheep",
                     "extra_text": "six sheep"})
    path = tmp_path / "train.json"
    path.write_text(json.dumps(recs))
    return path


@pytest.mark.parametrize("center_crop", [True, False], ids=["center", "random"])
def test_dataset_load_sample_matches_jax(case, tmp_path, monkeypatch, center_crop):
    """load_sample against the JAX HarmonyDataset, the same numpy rng: equal
    values, the pixels bit for bit (both through the C++ resize, the port's
    ``native`` binding and the JAX package's). The binding on its own: bit
    for bit the JAX ``native.batch_preprocess`` with one thread, eight and
    the default, and within ``tests/test_native.py``'s tolerance of its PIL
    version; a source g++ refuses raises with its message. With the centre
    crop, the encoder cache: ``precompute`` on 4 PNG records (48², batch 2)
    against JAX's, and ``batches_from_cache`` bit for bit JAX's, with
    dropout rates 0 and 1."""
    from imagharmony_tpu import native as jnative
    from imagharmony_tpu.models import tokenizer as jtok
    from imagharmony_tpu.train.dataset import HarmonyDataset as JaxDataset
    from imagharmony_tpu_torch import native
    from imagharmony_tpu_torch.models import tokenizer as ptok
    from imagharmony_tpu_torch.train.dataset import HarmonyDataset

    assert jnative.available()
    path = _records(tmp_path)
    kw = dict(size=32, clip_image_size=28, center_crop=center_crop, max_token_length=16,
              image_root_path=str(tmp_path), i_drop_rate=0.3, t_drop_rate=0.3)
    jt, pt = jtok.build_toy_tokenizer(), ptok.build_toy_tokenizer()
    jds = JaxDataset(path, jtok.SDXLTokenizers(jt, jt), **kw)
    pds = HarmonyDataset(path, ptok.SDXLTokenizers(pt, pt), **kw)
    for idx in range(2):
        a = jds.load_sample(idx, np.random.default_rng(idx))
        b = pds.load_sample(idx, np.random.default_rng(idx))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (96, 64, 3), dtype=np.uint8),
            rng.integers(0, 255, (64, 100, 3), dtype=np.uint8)] * 4
    pre = dict(tops=[4, 0] * 4, lefts=[0, 6] * 4, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
    want = jnative.batch_preprocess(imgs, 32, **pre)
    for threads in (0, 1, 8):
        np.testing.assert_array_equal(native.batch_preprocess(imgs, 32, num_threads=threads,
                                                              **pre), want)
    err = np.abs(want - native.batch_preprocess_plain(imgs, 32, **pre))
    assert np.median(err) < 0.02 and err.mean() < 0.05
    if center_crop:
        _check_cache(case, tmp_path)
    else:
        from imagharmony_tpu_torch.kernels import build

        (tmp_path / "csrc").mkdir()
        (tmp_path / "csrc" / "image_ops.cpp").write_text("int broken(;\n")
        monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
        with pytest.raises(RuntimeError, match=r"g\+\+ failed to build image_ops.cpp(.|\n)*"
                                               r"error"):
            build.load_host.__wrapped__("image_ops")


def _check_cache(case, tmp_path):
    from PIL import Image

    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.models import tokenizer as jtok
    from imagharmony_tpu.train import cache as jcache
    from imagharmony_tpu.train.dataset import HarmonyDataset as JaxDataset
    from imagharmony_tpu_torch.models import tokenizer as ptok
    from imagharmony_tpu_torch.train import cache as pcache
    from imagharmony_tpu_torch.train.dataset import HarmonyDataset

    rng = np.random.default_rng(0)
    records = []
    for i in range(4):  # the JAX package's own cache drill's records
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(
            tmp_path / f"c{i}.png")
        records.append({"image_file": f"c{i}.png", "text": "a dog", "extra_text": "six dogs"})
    (tmp_path / "c.json").write_text(json.dumps(records))
    jcfgs, pcfgs = case["jcfgs"], case["pcfgs"]
    kw = dict(size=32, clip_image_size=jcfgs.vision.image_size, center_crop=True,
              image_root_path=str(tmp_path))
    jt, pt = jtok.build_toy_tokenizer(), ptok.build_toy_tokenizer()
    jds = JaxDataset(tmp_path / "c.json", jtok.SDXLTokenizers(jt, jt), **kw)
    pds = HarmonyDataset(tmp_path / "c.json", ptok.SDXLTokenizers(pt, pt), **kw)
    want = jcache.precompute(case["params"], jcfgs, jds, batch_size=2, policy=jdt.FP32)
    got = pcache.precompute(case["comps"], pcfgs, pds, batch_size=2)
    assert set(got) == set(want) and got["latent_mean"].shape == want["latent_mean"].shape
    for k in want:
        close(got[k], want[k], rtol=2e-5, atol=2e-5, err_msg=k)
    assert (pds.i_drop_rate, pds.t_drop_rate) == (0.05, 0.05)
    with pytest.raises(ValueError, match="center_crop"):
        pds.center_crop = False
        pcache.precompute(case["comps"], pcfgs, pds)
    for rates in ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)):
        drop = dict(zip(("i_drop_rate", "t_drop_rate", "ti_drop_rate"), rates))
        a = jcache.batches_from_cache(want, 3, seed=5, epochs=2, drop_remainder=False, **drop)
        b = pcache.batches_from_cache(want, 3, seed=5, epochs=2, drop_remainder=False, **drop)
        n = 0
        for x, y in zip(a, b, strict=True):
            assert set(x) == set(y)
            for k in x:
                np.testing.assert_array_equal(y[k], x[k], err_msg=k)
            n += 1
        assert n == 4


def _tiny_args(out, *extra):
    return ["--tiny", "--synthetic_data", "6", "--train_batch_size", "2", "--resolution", "32",
            "--save_steps", "2", "--learning_rate", "1e-3", "--mixed_precision", "no",
            "--device", "cpu", "--log_every", "1", "--output_dir", str(out), *extra]


def test_trainer_resume_is_bit_identical(tmp_path):
    """4 steps straight equal 2 steps plus a --resume to 4, bit for bit:
    the losses of every step and every exported tensor (live and EMA); and
    the same with LoRA factors in the state (``--lora_rank 2 --ema_decay
    0.99``, the JAX package's LoRA drill), their exports included."""
    for extra in (("--ema_decay", "0.9"), ("--lora_rank", "2", "--ema_decay", "0.99")):
        _resume_drill(tmp_path / extra[0].strip("-"), extra)


def _resume_drill(root, extra):
    from imagharmony_tpu_torch.adapters import lora as plora

    a, b = root / "straight", root / "resumed"
    assert ptrainer.main(_tiny_args(a, "--max_steps", "4", *extra)) == 4
    assert ptrainer.main(_tiny_args(b, "--max_steps", "2", *extra)) == 2
    assert ptrainer.main(_tiny_args(b, "--max_steps", "4", "--resume", *extra)) == 4

    def losses(d):
        return [json.loads(line)["loss"] for line in open(d / "metrics.jsonl")]

    assert losses(a) == losses(b) and len(losses(a)) == 4
    for tag in ("-4", "-ema-4"):
        x = torch.load(a / f"ip_adapter{tag}.bin", weights_only=True)
        y = torch.load(b / f"ip_adapter{tag}.bin", weights_only=True)
        for group in ("image_proj", "ip_adapter", "composed_adapter"):
            assert set(x[group]) == set(y[group])
            for k in x[group]:
                torch.testing.assert_close(x[group][k], y[group][k], rtol=0, atol=0)
        if "--lora_rank" in extra:
            (x, cx), (y, cy) = (plora.load_lora(d / f"lora{tag}.safetensors") for d in (a, b))
            assert cx == cy and set(x) == set(y) and x
            for k in x:
                torch.testing.assert_close(x[k], y[k], rtol=0, atol=0)
    assert sorted(os.listdir(b / "checkpoints")) == ["step-2.pt", "step-4.pt"]
    line = json.loads(open(a / "metrics.jsonl").readline())
    assert set(line) == {"step", "loss", "grad_norm", "step_time_s", "data_time_s", "wall"}


def test_trainer_json_data_one_step(tmp_path):
    """One step on synthesized records through --data_json_file; the
    exported .bin loads with torch.load and holds every IP projection."""
    path = _records(tmp_path)
    out = tmp_path / "run"
    args = ["--tiny", "--data_json_file", str(path), "--data_root_path", str(tmp_path),
            "--train_batch_size", "2", "--resolution", "32", "--max_steps", "1",
            "--mixed_precision", "no", "--device", "cpu", "--output_dir", str(out)]
    assert ptrainer.main(args) == 1
    ckpt = torch.load(out / "ip_adapter-1.bin", weights_only=True)
    n_attn2 = sum(p is not None for _, p in
                  pckpt.attn_processor_paths(pcomp.tiny_configs().unet))
    assert len(ckpt["ip_adapter"]) == 2 * n_attn2
    assert json.loads(ckpt["harmony_config"])["fusion_method"] == "cross_attention"

    # the trainer from a diffusers tree the port wrote from the --tiny
    # bundle: with its adapter, one step bit-identical to --tiny; without,
    # every IP projection starts as its layer's to_k/to_v
    from imagharmony_tpu_torch.models import tokenizer as ptok

    toy = ptok.build_toy_tokenizer()
    cfgs = pcomp.tiny_configs(vocab_size=len(toy.encoder))
    tiny = pcomp.init_params(torch.Generator().manual_seed(0), cfgs, device="cpu")
    tree = tmp_path / "tree"
    pckpt.save_tree(tree, tiny, tokenizers=ptok.SDXLTokenizers(toy, toy))
    pckpt.save_adapter_checkpoint(tree / "ip_adapter.safetensors", unet=tiny.unet,
                                  unet_cfg=cfgs.unet, image_proj=tiny.image_proj,
                                  harmony=tiny.harmony, harmony_cfg=cfgs.harmony)
    steps = ["--synthetic_data", "1", "--train_batch_size", "2", "--resolution", "32",
             "--max_steps", "1", "--mixed_precision", "no", "--device", "cpu"]
    ha = ["--composed_inter_dim", "64", "--composed_cross_heads", "2",
          "--composed_reshape_blocks", "4", "--composed_cross_value_dim", "8"]
    runs = {"tiny": ["--tiny"],
            "tree": ["--pretrained_model_name_or_path", str(tree), *ha,
                     "--pretrained_ip_adapter_path", str(tree / "ip_adapter.safetensors")],
            "bare": ["--pretrained_model_name_or_path", str(tree), *ha]}
    for name, argv in runs.items():
        assert ptrainer.main([*argv, *steps, "--output_dir", str(tmp_path / name)]) == 1
    tiny_m, tree_m, bare_m = (json.loads(open(tmp_path / name / "metrics.jsonl").readline())
                              for name in runs)
    assert (tree_m["loss"], tree_m["grad_norm"]) == (tiny_m["loss"], tiny_m["grad_norm"])
    assert bare_m["grad_norm"] > 0
    _, bare, _ = ptrainer.build_components(ptrainer.parse_args([*runs["bare"], *steps]))
    sd = bare.unet.state_dict()
    for k in (k for k in sd if "_ip." in k):
        torch.testing.assert_close(sd[k], sd[k.replace("_ip.", ".")], rtol=0, atol=0)


def test_trainer_refuses_unported_modes(tmp_path, monkeypatch):
    """The CLI's ``train`` passes its arguments through to the trainer (two
    tiny steps with the qformer fusion, their metrics written); a missing
    tree raises. The modes that used to raise run: ``--lora_rank 2`` trains
    two steps, its exported ``lora-2.safetensors`` loads with JAX's
    ``load_lora`` to the same arrays (and a file JAX's ``save_lora`` wrote
    loads with the port's), and the port's ``with_lora`` of it, on the
    packed inference UNet, gives the training merge's weights bit for bit;
    ``--cache_encoders`` on a JSON dataset trains two steps with the four
    towers gone from the components and their tensors freed."""
    import gc
    import weakref

    from imagharmony_tpu.adapters import lora as jlora
    from imagharmony_tpu_torch import cli as pcli
    from imagharmony_tpu_torch.adapters import lora as plora
    from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline
    from imagharmony_tpu_torch.train import cache as pcache

    assert pcli.main(["train", *_tiny_args(tmp_path / "cli", "--max_steps", "2",
                                           "--fusion_method", "qformer")]) == 0
    lines = (tmp_path / "cli" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    # a missing tree raises, as the JAX load_pipeline does
    with pytest.raises(FileNotFoundError):
        ptrainer.main(["--pretrained_model_name_or_path", str(tmp_path / "missing"),
                       "--device", "cpu", "--output_dir", str(tmp_path)])

    # LoRA: two steps, the export read by both packages
    out = tmp_path / "lora"
    argv = _tiny_args(out, "--lora_rank", "2", "--lora_alpha", "4", "--max_steps", "2")
    assert ptrainer.main(argv) == 2
    factors, cfg = plora.load_lora(out / "lora-2.safetensors")
    assert (cfg.rank, cfg.scale) == (2, 2.0) and factors
    trained = torch.load(out / "checkpoints" / "step-2.pt", weights_only=True)["trainable"]
    jtree, jcfg = jlora.load_lora(str(out / "lora-2.safetensors"))
    assert (jcfg.rank, jcfg.alpha, jcfg.targets) == (2, 4.0, cfg.targets)
    flat = jlora.flatten(jtree)
    assert set(flat) == set(factors)
    for k, v in factors.items():
        np.testing.assert_array_equal(flat[k], v.numpy(), err_msg=k)
        torch.testing.assert_close(v, trained[f"lora.{k}"], rtol=0, atol=0)
        assert float(v.abs().max()) > 0
    jlora.save_lora(str(tmp_path / "jax_lora.safetensors"), jtree, jcfg)
    back, back_cfg = plora.load_lora(tmp_path / "jax_lora.safetensors")
    assert back_cfg == cfg and set(back) == set(factors)
    for k in back:
        torch.testing.assert_close(back[k], factors[k], rtol=0, atol=0)
    # with_lora on the packed inference UNet: the training merge's bits
    _, comps, _ = ptrainer.build_components(ptrainer.parse_args(argv))
    merged = plora.merged_weights(comps.unet, factors, cfg)
    pipe = HarmonyPipeline._build(copy.deepcopy(comps)).with_lora(out / "lora-2.safetensors")
    n_proj = 0
    for name, w in merged.items():
        attn = name[:name.index(".attn") + len(".attn1")]
        proj = name[len(attn) + 1:].split(".")[0]
        lin, rows = plora._row_slice(pipe.components.unet.get_submodule(attn), proj)
        torch.testing.assert_close(lin.weight[rows], w, rtol=0, atol=0)
        n_proj += 1
    assert n_proj == len(factors) // 2

    # the encoder cache: the towers gone by the first step
    data = _records(tmp_path)
    refs, seen = [], []
    drop = pcache.drop_towers

    def drop_watched(comps):
        refs.extend(weakref.ref(t) for name in pcache.TOWERS
                    for t in getattr(comps, name).parameters())
        return drop(comps)

    step = pstep.train_step

    def step_watched(state, comps, *a, **kw):
        gc.collect()
        seen.append((all(getattr(comps, n) is None for n in pcache.TOWERS),
                     sum(r() is not None for r in refs)))
        return step(state, comps, *a, **kw)

    monkeypatch.setattr(pcache, "drop_towers", drop_watched)
    monkeypatch.setattr(pstep, "train_step", step_watched)
    out = tmp_path / "cached"
    assert ptrainer.main(["--tiny", "--data_json_file", str(data), "--data_root_path",
                          str(tmp_path), "--cache_encoders", "--train_batch_size", "2",
                          "--resolution", "32", "--max_steps", "2", "--mixed_precision", "no",
                          "--device", "cpu", "--output_dir", str(out)]) == 2
    assert refs and seen == [(True, 0), (True, 0)]
    losses = [json.loads(x)["loss"] for x in open(out / "metrics.jsonl")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def _eager_trainer(argv, steps):
    """What ``trainer.main(argv)`` computes for ``steps`` steps of its
    synthetic data, through the eager ``train_step``: the losses, the grad
    norms and the trainable parameters after the last step."""
    args = ptrainer.parse_args(argv)
    cfgs, comps, _ = ptrainer.build_components(args)
    tcfg = ptrainer.train_config(args, cfgs)
    state = pstep.init_state(comps, tcfg, seed=args.seed)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    metrics = []
    for i in range(steps):
        batch = pstep.to_device(pstep.dummy_batch(cfgs, args.train_batch_size, args.resolution,
                                                  rng=i), args.device)
        draws = pstep.step_draws(gen, cfgs, tcfg, args.train_batch_size, args.resolution)
        m = pstep.train_step(state, comps, tcfg, batch, draws)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, {n: p.detach().clone() for n, p in state.trainable.items()}


@pytest.mark.cuda
def test_cuda_tiny_train_step_matches_cpu(cuda, tmp_path, monkeypatch):
    """One tiny train step's loss and gradients in bf16 on the card (K1 and
    K3) against the same weights and draws in fp32 on the CPU: loss within
    2e-2 relative, cosine of the flattened trainable gradients >= 0.99, and
    K3 launched. Then the tiny trainer on the card, whose steps are one
    captured program (``train/programs.py``): it captures once and then only
    replays, and its losses, grad norms and trainable parameters after 4
    steps equal the eager ``train_step``'s on the same seed bit for bit
    (where two eager runs differ, they are no further from the first than
    the second is); and 2 steps plus a ``--resume`` to 4, each run through a
    captured program, equal 4 straight, bit for bit. The step and the
    trainer's 4 captured steps again with LoRA factors (``--lora_rank 2``;
    for the step, B drawn nonzero), their gradients in the cosine."""
    from imagharmony_tpu_torch.train import programs as ptprograms

    cfgs = pcomp.tiny_configs()
    cpu = pcomp.init_params(torch.Generator().manual_seed(0), cfgs, device="cpu")
    card = copy.deepcopy(cpu).to(device=cuda, dtype=torch.bfloat16)
    batch = pstep.dummy_batch(cfgs, 2, 32)
    for tcfg in (pstep.TrainConfig(unet_cfg=cfgs.unet),
                 pstep.TrainConfig(unet_cfg=cfgs.unet, lora_rank=2)):
        draws = pstep.draw(torch.Generator().manual_seed(1), cfgs, tcfg, 2, 32)
        grads = []
        for comps, dev in ((cpu, "cpu"), (card, cuda)):
            state = pstep.init_state(comps, tcfg)
            gen = torch.Generator().manual_seed(2)
            with torch.no_grad():
                for k, f in (state.factors or {}).items():
                    if k.endswith(".lora_b"):
                        f.copy_(torch.randn(f.shape, generator=gen) * 0.01)
            d = pstep.Draws(*(x.to(dev) for x in (draws.noise, draws.timesteps,
                                                   draws.latent_eps)))
            k3 = fa.bwd_launches
            loss = pstep.loss_fn(comps, tcfg, pstep.to_device(batch, dev), d, state.factors)
            loss.backward()
            grads.append((float(loss.detach()), torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p)).float().cpu().flatten()
                for p in state.trainable.values()])))
            for p in comps.parameters():
                p.grad = None
        (l_cpu, g_cpu), (l_card, g_card) = grads
        assert fa.bwd_launches > k3
        assert abs(l_card - l_cpu) <= 2e-2 * abs(l_cpu)
        assert float(torch.nn.functional.cosine_similarity(g_card, g_cpu, dim=0)) >= 0.99

    captures = []
    init = ptprograms.TrainProgram.__init__

    def counted(self, *a, **kw):
        captures.append(1)
        init(self, *a, **kw)

    monkeypatch.setattr(ptprograms.TrainProgram, "__init__", counted)

    def card_args(out, steps, *extra):  # bf16 weights, the kernels' dtype
        return ["--tiny", "--synthetic_data", "4", "--train_batch_size", "2", "--resolution",
                "32", "--save_steps", "2", "--learning_rate", "1e-3", "--ema_decay", "0.9",
                "--log_every", "1", "--device", "cuda", "--max_steps", str(steps),
                "--output_dir", str(out), *extra]

    def losses(d):
        return [(m["loss"], m["grad_norm"]) for m in map(json.loads, open(d / "metrics.jsonl"))]

    def trained(d):
        return torch.load(d / "checkpoints" / "step-4.pt", weights_only=True)["trainable"]

    def dist(p, q):
        return max(float((p[n].float().cpu() - q[n].float().cpu()).abs().max()) for n in p)

    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    assert ptrainer.main(card_args(straight, 4)) == 4 and len(captures) == 1
    got, got_p = losses(straight), trained(straight)
    (want, want_p), (want2, want2_p) = (_eager_trainer(card_args(tmp_path, 4), 4)
                                        for _ in range(2))
    def gap(x, y):
        return max(abs(a - b) for u, v in zip(x, y) for a, b in zip(u, v))

    if want == want2 and dist(want_p, want2_p) == 0:
        assert got == want and dist(got_p, want_p) == 0
    else:  # a backward that is not deterministic: no further than two eager runs
        assert gap(got, want) <= gap(want2, want)
        assert dist(got_p, want_p) <= dist(want2_p, want_p)

    assert ptrainer.main(card_args(resumed, 2)) == 2
    assert ptrainer.main(card_args(resumed, 4, "--resume")) == 4
    assert len(captures) == 3
    assert losses(resumed) == got and dist(trained(resumed), got_p) == 0

    lora = tmp_path / "lora"
    assert ptrainer.main(card_args(lora, 4, "--lora_rank", "2")) == 4 and len(captures) == 4
    got, got_p = losses(lora), trained(lora)
    (want, want_p), (want2, want2_p) = (_eager_trainer(card_args(tmp_path, 4, "--lora_rank",
                                                                  "2"), 4) for _ in range(2))
    assert any(n.startswith("lora.") for n in got_p)
    if want == want2 and dist(want_p, want2_p) == 0:
        assert got == want and dist(got_p, want_p) == 0
    else:
        assert gap(got, want) <= gap(want2, want)
        assert dist(got_p, want_p) <= dist(want2_p, want_p)


def test_profile_summary_classes_and_idle_share(tmp_path):
    """The profiling tool's summary of a chrome trace: kernel events only,
    kernel classes by name, device busy time as the union of overlapping
    kernels, idle share against the wall window, the idle stretches
    between kernels."""
    from imagharmony_tpu_torch.utils import profiling

    events = [
        {"cat": "kernel", "name": "void (anonymous namespace)::attn_bwd_dkdv_kernel<64>(BwdMaps, "
                                 "BwdArgs)", "ts": 0, "dur": 400},
        {"cat": "kernel", "name": "void (anonymous namespace)::attn_fwd_wgmma_kernel<64, 2>("
                                 "FwdMaps, FwdArgs)", "ts": 1400, "dur": 50},
        {"cat": "kernel", "name": "void (anonymous namespace)::attn_fwd_wgmma_kernel<40, 1>("
                                 "FwdMaps, FwdArgs)", "ts": 1500, "dur": 30},
        {"cat": "kernel", "name": "void (anonymous namespace)::cross_attn_wgmma_kernel<40>("
                                 "CrossMaps, CrossArgs)", "ts": 1600, "dur": 20},
        {"cat": "kernel", "name": "void (anonymous namespace)::geglu_wgmma_kernel<128, 1>("
                                 "GegluMaps, GegluArgs)", "ts": 1700, "dur": 10},
        {"cat": "kernel", "name": "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT", "ts": 300,
         "dur": 200},
        {"cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm_bf16", "ts": 1000, "dur": 100},
        {"cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>",
         "ts": 1200, "dur": 100},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5000},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = profiling.summarize(profiling.kernel_events(path), n_steps=1, wall_ms=2.0)
    assert out["class_ms_per_step"] == {"K3": 0.4, "gemm": 0.2, "conv": 0.1, "elementwise": 0.1,
                                        "K1/K4": 0.08, "K2": 0.02, "K5": 0.01}
    assert out["device_busy_ms_per_step"] == pytest.approx(0.81)
    assert out["idle_share"] == pytest.approx(0.595)
    assert out["kernels_per_step"] == 8
    # the stretches between kernels: 500, 100, 100, 50, 70 and 80 us
    assert out["largest_gap_ms"] == pytest.approx(0.5)
    assert out["gaps_over_20us_ms_per_step"] == pytest.approx(0.9)


def test_kernel_ms_takes_only_traces_that_agree(monkeypatch):
    """kernel_ms uses a profiler trace only when the one before it holds as
    many kernel events, a multiple of the calls made; traces that lost
    events (short or empty) are run again, and with no agreeing pair every
    value is None. ``profiled_agreeing`` likewise keeps the second session
    of the first agreeing pair, or None. The profiler is faked: it needs
    the card."""
    from imagharmony_tpu_torch.utils import profiling

    def events(n_calls):  # each call launches a (10 us) and b (30 us)
        return [{"name": name, "dur": dur} for _ in range(n_calls)
                for name, dur in (("a_kernel", 10), ("b_kernel", 30))]

    traces = iter([events(5)[:-3], [], events(5), events(5)])
    monkeypatch.setattr(profiling, "profiled", lambda run: (None, 0.0, next(traces)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    out = profiling.kernel_ms(lambda: None, ("a_kernel",), reps=5)
    assert out == {"a_kernel": pytest.approx(0.01), "total": pytest.approx(0.04)}
    traces = iter([events(5)[:-1], events(5)[:-3], [], events(4)])
    assert profiling.kernel_ms(lambda: None, ("a_kernel",), reps=5, tries=4) == {
        "a_kernel": None, "total": None}
    # profiled_agreeing: the second of two sessions in a row with as many
    # events, never two empty ones
    traces = iter([[], [], events(2)[:-1], events(2), events(2)])
    got, counts = profiling.profiled_agreeing(lambda: None, tries=5)
    assert got[2] == events(2) and counts == [0, 0, 3, 4, 4]
    traces = iter([[], [], events(1), events(2)])
    assert profiling.profiled_agreeing(lambda: None, tries=4) == (None, [0, 0, 2, 4])
