"""Multi-rank drills, run on every rank by ``distributed.spawn`` (the
counterpart of the JAX package's tools/multihost_worker.py): the tiny
configs on the CPU over gloo, the shapes a caller gives on cards over
NCCL. Each returns plain values and numpy arrays, which ``spawn`` hands to
its caller, who holds them against the JAX package or a one-device run.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from imagharmony_tpu_torch.parallel import distributed, fsdp
from imagharmony_tpu_torch.parallel import mesh as mesh_lib


def _np(x):
    return x.detach().float().cpu().numpy()


def train_step_once(state_dict, batch, draws, tcfg_kw, mesh, min_elems=None):
    """One port train step of the tiny bundle over ``mesh`` on the global
    ``batch`` and ``draws`` (the JAX layout, numpy), FSDP-sliced with
    ``min_elems`` set. -> loss, grad norm, gradients and parameters after
    the update (whole), and the FSDP slicing's counts."""
    from imagharmony_tpu_torch.pipelines import components as comp
    from imagharmony_tpu_torch.train import step as step_lib

    cfgs = comp.tiny_configs()
    comps = comp.load_state_dict_(comp.Components(cfgs),
                                  {k: torch.as_tensor(v) for k, v in state_dict.items()})
    sliced = 0
    if min_elems is not None:
        sliced = fsdp.shard_tree(mesh, comps, min_elems=min_elems)
    tcfg = step_lib.TrainConfig(unet_cfg=cfgs.unet, **tcfg_kw)
    state = step_lib.init_state(comps, tcfg, mesh=mesh)
    d = step_lib.Draws(*(torch.as_tensor(draws[k]) for k in ("noise", "timesteps",
                                                              "latent_eps")))
    m = step_lib.train_step(state, comps, tcfg, step_lib.to_device(batch, "cpu"), [d])
    params = list(state.trainable.values())
    grads = {n: None if p.grad is None else fsdp.full_tensor(p.grad, fsdp.info(p))
             for n, p in state.trainable.items()}
    moments = sum(fsdp.info(p) is not None for p in params if p in state.optimizer.state)
    frozen = [p for n, p in comps.named_parameters() if n not in state.trainable]
    local_ok = all(p.numel() * fsdp.info(p).n == int(np.prod(fsdp.info(p).full_shape))
                   for p in comps.parameters() if fsdp.info(p) is not None)
    return {
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "grads": {n: None if g is None else _np(g) for n, g in grads.items()},
        "params": {n: _np(fsdp.full_tensor(p.detach(), fsdp.info(p)))
                   for n, p in state.trainable.items()},
        "sliced": sliced,
        "sliced_frozen": sum(fsdp.info(p) is not None for p in frozen),
        "sliced_trainable": sum(fsdp.info(p) is not None for p in params),
        "sliced_moments": moments, "local_numel_ok": local_ok,
    }


def _trainer_runs(root, argv):
    """The resume drill: ``argv``'s trainer 2 steps straight, and 1 step
    then a --resume to 2; each run's ``read_run``."""
    from imagharmony_tpu_torch.train import trainer

    out = {}
    for name, runs in (("straight", [["--max_steps", "2"]]),
                       ("resumed", [["--max_steps", "1"], ["--max_steps", "2", "--resume"]])):
        d = os.path.join(root, name)
        for extra in runs:
            trainer.main([*argv, *extra, "--output_dir", d])
        distributed.barrier()  # rank 0's files are whole
        out[name] = read_run(d)
    return out


def resume_argv(records):
    """The resume drill's tiny trainer: the JSON ``records`` (their images
    beside them) through the encoder cache, an EMA and rank-2 LoRA factors,
    a checkpoint and the exports every step."""
    return ["--tiny", "--data_json_file", str(records), "--data_root_path",
            os.path.dirname(str(records)), "--cache_encoders", "--train_batch_size", "2",
            "--resolution", "32", "--save_steps", "1", "--learning_rate", "1e-3",
            "--mixed_precision", "no", "--device", "cpu", "--log_every", "1",
            "--ema_decay", "0.9", "--lora_rank", "2"]


def read_run(out, step=2):
    """A trainer run's logged losses, its checkpoints and its ``step``
    exports (the adapters, live and EMA, and the LoRA factors), flat."""
    from imagharmony_tpu_torch.adapters import lora as lora_lib

    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    exports = {}
    for tag in (f"ip_adapter-{step}.bin", f"ip_adapter-ema-{step}.bin"):
        sd = torch.load(os.path.join(out, tag), weights_only=True)
        exports[tag] = {f"{g}.{k}": v.float().numpy()
                        for g in ("image_proj", "ip_adapter", "composed_adapter")
                        for k, v in sd[g].items()}
    factors, _ = lora_lib.load_lora(os.path.join(out, f"lora-{step}.safetensors"))
    exports[f"lora-{step}"] = {k: v.float().numpy() for k, v in factors.items()}
    return {"losses": losses, "exports": exports,
            "checkpoints": sorted(os.listdir(os.path.join(out, "checkpoints")))}


def train_drills(state_dict, batch, draws, root, records, min_elems=64):
    """On each of the ranks: one DP step and one DP+FSDP step of the tiny
    bundle on the global batch, then the DP+FSDP trainer's resume drill
    under ``root`` (rank 0 writes its files; ``resume_argv``: the JSON
    ``records`` through the encoder cache, each rank encoding its share,
    and LoRA factors, whole with the projections they factor); the bf16
    VAE's fp32 encode, sliced, against its encode whole (the encode passes
    fp32 copies of its parameters, which the hooks gather); and
    ``replicate`` of each rank's own tensor (-> rank 0's values
    everywhere)."""
    mesh = mesh_lib.make_mesh()
    mine = torch.full((3,), float(mesh.rank + 1))
    tcfg_kw = dict(gradient_checkpoint=True, learning_rate=1e-3)
    argv = resume_argv(records) + ["--fsdp", "--fsdp_min_shard", str(min_elems)]
    return {"rank": mesh.rank, "mesh": repr(mesh),
            "dp": train_step_once(state_dict, batch, draws, tcfg_kw, mesh),
            "fsdp": train_step_once(state_dict, batch, draws, tcfg_kw, mesh, min_elems),
            "vae_bf16": _sliced_vae_encode(state_dict, mesh, min_elems),
            "resume": _trainer_runs(root, argv),
            "replicated": _np(mesh_lib.replicate(mesh, [mine])[0])}


def _sliced_vae_encode(state_dict, mesh, min_elems):
    """(slices made, whether the bf16 VAE's fp32 encode of a random image
    is bit for bit the same sliced as whole)."""
    from imagharmony_tpu_torch.pipelines import components as comp

    comps = comp.load_state_dict_(comp.Components(comp.tiny_configs()),
                                  {k: torch.as_tensor(v) for k, v in state_dict.items()})
    vae = comps.vae.to(torch.bfloat16)
    images = torch.randn((1, 3, 32, 32), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        whole = vae.encode_moments(images)
        n = fsdp.shard_tree(mesh, vae, min_elems=min_elems)
        sliced = vae.encode_moments(images)
    return n, all(torch.equal(a, b) for a, b in zip(whole, sliced))


def _pipe(state_dict, cfgs):
    from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline

    return HarmonyPipeline.from_state_dict({k: torch.as_tensor(v) for k, v in
                                            state_dict.items()}, cfgs, device="cpu")


def edit_drills(state_dict, vocab_size, image, kw, unet_inputs, lora_seed=5, n_model=2):
    """On each rank of a (world // n_model) x n_model mesh: the tiny
    pipeline's edit through ``with_mesh(tensor_parallel=True)``, PNS over a
    DP-only clone (its candidates are that clone's edit), the UNet forward
    with TP and with TP and FSDP (``shard_params_tp_fsdp``), ``with_mesh``
    -> ``with_lora`` against ``with_lora`` -> ``with_mesh`` (one sample,
    one step), and ``generate_batch`` on the DP clone against the
    one-device ``generate_batch``, one step, of 3 requests (rows the data
    axis does not divide: every rank takes all; raw floats) and of 2 (a
    request a rank; uint8)."""
    from imagharmony_tpu_torch.adapters import lora as lora_lib
    from imagharmony_tpu_torch.nn.attention import Attention
    from imagharmony_tpu_torch.pipelines import components as comp
    from imagharmony_tpu_torch.pipelines import pns

    pipe = _pipe(state_dict, comp.tiny_configs(vocab_size=vocab_size))
    mesh = mesh_lib.make_mesh(n_model=n_model)
    tp = pipe.with_mesh(mesh, tensor_parallel=True)
    dp = pipe.with_mesh(mesh)
    heads = [(m.heads, m2.heads) for m, m2 in zip(pipe.components.unet.modules(),
                                                    tp.components.unet.modules())
             if isinstance(m, Attention)]
    out = {"rank": mesh.rank, "heads": heads, "tp": tp.generate(image, **kw)}
    pns_kw = {k: v for k, v in kw.items() if k not in ("num_samples", "seed", "output_type")}
    _, images, scores = pns.generate_with_pns(dp, image, num_seeds=kw["num_samples"],
                                              seed=kw["seed"], return_all=True,
                                              output_type="np", **pns_kw)
    out["pns"] = {"images": np.stack(images), "scores": np.asarray(scores)}
    x = {k: torch.as_tensor(v) for k, v in unet_inputs.items()}
    tp_fsdp = copy.deepcopy(pipe.components.unet)
    out["tp_fsdp_sliced"] = fsdp.shard_params_tp_fsdp(mesh, tp_fsdp, min_elems=64)

    def unet_out(unet):
        with torch.no_grad():
            return _np(unet(x["sample"].permute(0, 3, 1, 2), x["timesteps"],
                            x["encoder_hidden_states"], pooled_text_embeds=x["pooled_text_embeds"],
                            time_ids=x["time_ids"], ip_tokens=x["ip_tokens"],
                            ip_scale=0.7).permute(0, 2, 3, 1))

    out["unet"], out["unet_tp_fsdp"] = unet_out(tp.components.unet), unet_out(tp_fsdp)
    lcfg = lora_lib.LoRAConfig(rank=2, alpha=3.0)
    gen = torch.Generator().manual_seed(lora_seed)
    factors = {k: torch.randn(v.shape, generator=gen) * 0.1
               for k, v in lora_lib.init_lora(gen, pipe.components.unet, lcfg).items()}
    small = dict(kw, num_samples=1, num_inference_steps=1, noise=kw["noise"][:1])
    a = tp.with_lora(factors, lora_cfg=lcfg).generate(image, **small)
    b = pipe.with_lora(factors, lora_cfg=lcfg).with_mesh(mesh, tensor_parallel=True).generate(
        image, **small)
    out["lora_equal"] = bool(np.array_equal(a, b))
    out["lora_moved"] = bool(not np.array_equal(a, out["tp"]))
    out["batch"] = {}
    for reqs, output_type in ((3, "raw"), (2, "np")):
        args = ([image] * reqs, [f"a dog {i}" for i in range(reqs)])
        batch_kw = dict(extra_texts=[kw["extra_text"]] * reqs, num_inference_steps=1,
                        height=kw["height"], width=kw["width"], output_type=output_type)
        out["batch"][reqs] = tuple(np.asarray(p.generate_batch(*args, **batch_kw))
                                   for p in (pipe, dp))
    return out


def card_drills(steps, image, kw, root):
    """On each of two ranks, one card each (NCCL): the full-width random
    trainer at 512² with two rows a step, data-parallel (captured steps,
    the all-reduce inside), then the same with ``--fsdp`` (the bytes of
    this rank's parameters after the slicing beside one card's, and the
    card's allocated bytes then); then the full-width 1024² edit of
    ``kw`` through ``with_mesh(tensor_parallel=True)`` on a 1 x 2 mesh."""
    from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline
    from imagharmony_tpu_torch.train import trainer

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": torch.distributed.get_rank(), "device": str(dev)}
    argv = ["--full_random", "--synthetic_data", str(steps), "--train_batch_size", "2",
            "--max_steps", str(steps), "--log_every", "1"]
    shard = fsdp.shard_tree

    def watched(mesh, module, **kw_):
        n = shard(mesh, module, **kw_)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        local = sum(p.numel() * p.element_size() for p in module.parameters())
        whole = sum((int(np.prod(fsdp.info(p).full_shape)) if fsdp.info(p) else p.numel())
                    * p.element_size() for p in module.parameters())
        out["fsdp_state"] = {"sliced": n, "param_bytes": local, "one_card_param_bytes": whole,
                             "allocated_bytes": torch.cuda.memory_allocated(dev)}
        return n

    for mode, extra in (("dp", []), ("fsdp", ["--fsdp"])):
        d = os.path.join(root, mode)
        fsdp.shard_tree = watched
        try:
            trainer.main([*argv, *extra, "--output_dir", d])
        finally:
            fsdp.shard_tree = shard
        distributed.barrier()
        with open(os.path.join(d, "metrics.jsonl")) as f:
            out[mode] = [(json.loads(line)["loss"], json.loads(line)["grad_norm"]) for line in f]
        torch.cuda.empty_cache()
    pipe = HarmonyPipeline.random_full(seed=0, device=dev)
    tp = pipe.with_mesh(mesh_lib.make_mesh(n_data=1, n_model=2), tensor_parallel=True)
    out["tp_image"] = _np(tp.generate(image, **kw))
    return out
