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
    import jax
    import jax.numpy as jnp
    import optax

    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.pipelines import components as jcomp
    from imagharmony_tpu.train import step as jstep

    jcfgs = jcomp.tiny_configs()
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
    comps = pcomp.Components(pcfgs)
    pcomp.load_state_dict_(comps, from_jax.state_dict(params))
    return dict(jcfgs=jcfgs, params=params, pcfgs=pcfgs, comps=comps, batch=batch,
                draws=draws, loss=float(loss), grads=jax.device_get(grads),
                grad_norm=float(optax.global_norm(grads)), state=state, frozen=frozen)


def test_train_step_loss_and_gradients_match_jax(case):
    """The port's loss on the JAX draws: loss and grad_norm within 1e-5
    relative, every trainable gradient within 1e-4 of its leaf's max-abs
    (with a floor of 1e-9: a leaf whose gradient is zero in exact arithmetic,
    such as the HA cross-attention's to_k bias, carries only ~1e-12 of fp32
    noise on both sides). Inert IP projections have no gradient in the port
    and exact zeros in JAX."""
    comps = copy.deepcopy(case["comps"])
    tcfg = pstep.TrainConfig(unet_cfg=case["pcfgs"].unet)
    state = pstep.init_state(comps, tcfg)
    loss = pstep.loss_fn(comps, tcfg, pstep.to_device(case["batch"], "cpu"), case["draws"])
    loss.backward()
    assert abs(loss.item() - case["loss"]) <= 1e-5 * abs(case["loss"])
    ref = from_jax.state_dict(case["grads"])
    assert set(ref) == set(state.trainable)
    norm = pstep.global_norm([p.grad for p in state.trainable.values()])
    assert abs(float(norm) - case["grad_norm"]) <= 1e-5 * case["grad_norm"]
    n_live = 0
    for name, p in state.trainable.items():
        r = ref[name].numpy()
        g = np.zeros_like(r) if p.grad is None else np_(p.grad)
        np.testing.assert_allclose(g, r, rtol=0, atol=max(1e-4 * np.abs(r).max(), 1e-9),
                                   err_msg=name)
        n_live += p.grad is not None
    assert 0 < n_live < len(state.trainable)  # inert projections get none


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


def test_adamw_matches_optax(case):
    """The same gradients into optax (JAX make_optimizer: clip_by_global_norm
    then masked adamw) and into the port's update: parameters after one and
    two updates within 1e-6."""
    import jax
    import optax

    from imagharmony_tpu.train import step as jstep

    kw = dict(learning_rate=1e-3, weight_decay=0.1, max_grad_norm=0.5 * case["grad_norm"])
    tcfg_j = jstep.TrainConfig(unet_cfg=case["jcfgs"].unet, **kw)
    tx = jstep.make_optimizer(tcfg_j)
    trainable = case["state"]["trainable"]
    opt_state = tx.init(trainable)

    comps = copy.deepcopy(case["comps"])
    tcfg = pstep.TrainConfig(unet_cfg=case["pcfgs"].unet, **kw)
    state = pstep.init_state(comps, tcfg)
    grads = from_jax.state_dict(case["grads"])

    @jax.jit
    def update(grads, opt_state, trainable):
        updates, opt_state = tx.update(grads, opt_state, trainable)
        return optax.apply_updates(trainable, updates), opt_state

    for _ in range(2):
        trainable, opt_state = update(case["grads"], opt_state, trainable)
        for n, p in state.trainable.items():
            p.grad = grads[n].clone()
        pstep.apply_update(state, tcfg)
        ref = from_jax.state_dict(jax.device_get(trainable))
        for n, p in state.trainable.items():
            close(p, ref[n], rtol=0, atol=1e-6)


def test_inert_ip_projections_not_decayed(case):
    """One port train step with weight decay: the inert mid-block IP
    projection stays bit-identical, the live one moves."""
    comps = copy.deepcopy(case["comps"])
    tcfg = pstep.TrainConfig(learning_rate=1e-2, weight_decay=0.1, gradient_checkpoint=False,
                             unet_cfg=case["pcfgs"].unet)
    state = pstep.init_state(comps, tcfg)
    inert = "unet.mid_block.attentions.0.transformer_blocks.0.attn2.to_k_ip.weight"
    live = "unet.down_blocks.2.attentions.1.transformer_blocks.0.attn2.to_k_ip.weight"
    before = {n: state.trainable[n].detach().clone() for n in (inert, live)}
    gen = torch.Generator().manual_seed(0)
    m = pstep.train_step(state, comps, case["pcfgs"], tcfg,
                         pstep.to_device(case["batch"], "cpu"), gen, 32)
    assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0
    torch.testing.assert_close(state.trainable[inert], before[inert], rtol=0, atol=0)
    assert float((state.trainable[live] - before[live]).detach().abs().max()) > 0


@pytest.mark.parametrize("sched", [dict(), dict(lr_warmup_steps=3),
                                   dict(lr_schedule="cosine", lr_warmup_steps=2,
                                        lr_total_steps=6)],
                         ids=["constant", "warmup", "cosine"])
def test_lr_schedule_matches_optax(sched):
    """The lr the port's optimizer applies at its k-th update equals optax's
    schedule at count k (0-based), checked through step 0, 1, the warmup end
    and past the horizon; 1e-6 relative, as optax evaluates its schedules
    in fp32."""
    from imagharmony_tpu.train import step as jstep

    ref = jstep.learning_rate(_jax_train_config(learning_rate=1e-3, **sched))
    fn = ref if callable(ref) else (lambda count: ref)
    cfg = pstep.TrainConfig(learning_rate=1e-3, **sched)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, lr_sched = pstep.make_optimizer({"harmony.w": p}, cfg)
    for count in range(8):
        want = float(fn(count))
        got = opt.param_groups[0]["lr"]
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), (count, got, want)
        assert pstep.learning_rate(cfg)(count) == pytest.approx(want, rel=1e-6, abs=1e-12)
        p.grad = torch.ones(3)
        opt.step()
        lr_sched.step()


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
    # JAX's own reader takes the port's file
    proj, ip, composed, ha_cfg = jckpt.load_adapter_checkpoint(tmp_path / "port.bin")
    assert {k: getattr(ha_cfg, k) for k in cfg_b} == cfg_b and len(ip) == len(b["ip_adapter"])


def _records(tmp_path, n=2):
    from PIL import Image

    rng = np.random.default_rng(3)
    recs = []
    for i, (h, w) in enumerate([(40, 56), (64, 48)][:n]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
        recs.append({"image_file": f"img{i}.png", "text": "a photo of six sheep",
                     "extra_text": "six sheep"})
    path = tmp_path / "train.json"
    path.write_text(json.dumps(recs))
    return path


@pytest.mark.parametrize("center_crop", [True, False], ids=["center", "random"])
def test_dataset_load_sample_matches_jax(tmp_path, monkeypatch, center_crop):
    """load_sample against the JAX HarmonyDataset on its PIL path (its
    native library switched off here), the same numpy rng: equal values."""
    from imagharmony_tpu import native
    from imagharmony_tpu.models import tokenizer as jtok
    from imagharmony_tpu.train.dataset import HarmonyDataset as JaxDataset
    from imagharmony_tpu_torch.models import tokenizer as ptok
    from imagharmony_tpu_torch.train.dataset import HarmonyDataset

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
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


def _tiny_args(out, *extra):
    return ["--tiny", "--synthetic_data", "6", "--train_batch_size", "2", "--resolution", "32",
            "--save_steps", "2", "--learning_rate", "1e-3", "--mixed_precision", "no",
            "--device", "cpu", "--log_every", "1", "--output_dir", str(out), *extra]


def test_trainer_resume_is_bit_identical(tmp_path):
    """4 steps straight equal 2 steps plus a --resume to 4, bit for bit:
    the losses of every step and every exported tensor (live and EMA)."""
    a, b = tmp_path / "straight", tmp_path / "resumed"
    extra = ("--ema_decay", "0.9")
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


def test_trainer_refuses_unported_modes(tmp_path):
    with pytest.raises(NotImplementedError, match="A13"):
        ptrainer.main(_tiny_args(tmp_path, "--lora_rank", "2", "--max_steps", "1"))
    with pytest.raises(NotImplementedError, match="A10"):
        ptrainer.main(["--pretrained_model_name_or_path", "x", "--device", "cpu",
                       "--output_dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="cache"):
        pstep.loss_fn(None, pstep.TrainConfig(), {"context": None}, None)


@pytest.mark.cuda
def test_cuda_tiny_train_step_matches_cpu(cuda):
    """One tiny train step's loss and gradients in bf16 on the card (K1 and
    K3) against the same weights and draws in fp32 on the CPU: loss within
    2e-2 relative, cosine of the flattened trainable gradients >= 0.99, and
    K3 launched."""
    cfgs = pcomp.tiny_configs()
    cpu = pcomp.init_params(torch.Generator().manual_seed(0), cfgs, device="cpu")
    card = copy.deepcopy(cpu).to(device=cuda, dtype=torch.bfloat16)
    tcfg = pstep.TrainConfig(unet_cfg=cfgs.unet)
    batch = pstep.dummy_batch(cfgs, 2, 32)
    draws = pstep.draw(torch.Generator().manual_seed(1), cfgs, tcfg, 2, 32)
    grads = []
    for comps, dev in ((cpu, "cpu"), (card, cuda)):
        state = pstep.init_state(comps, tcfg)
        d = pstep.Draws(*(x.to(dev) for x in (draws.noise, draws.timesteps, draws.latent_eps)))
        k3 = fa.bwd_launches
        loss = pstep.loss_fn(comps, tcfg, pstep.to_device(batch, dev), d)
        loss.backward()
        grads.append((float(loss.detach()), torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).float().cpu().flatten()
            for p in state.trainable.values()])))
    (l_cpu, g_cpu), (l_card, g_card) = grads
    assert fa.bwd_launches > k3
    assert abs(l_card - l_cpu) <= 2e-2 * abs(l_cpu)
    assert float(torch.nn.functional.cosine_similarity(g_card, g_cpu, dim=0)) >= 0.99


def test_profile_summary_classes_and_idle_share(tmp_path):
    """The profiling tool's summary of a chrome trace: kernel events only,
    kernel classes by name, device busy time as the union of overlapping
    kernels, idle share against the wall window."""
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


def test_kernel_ms_takes_only_traces_that_agree(monkeypatch):
    """kernel_ms uses a profiler trace only when the one before it holds as
    many kernel events, a multiple of the calls made; traces that lost
    events (short or empty) are run again, and with no agreeing pair every
    value is None. The profiler is faked: it needs the card."""
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
