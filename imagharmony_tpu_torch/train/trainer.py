"""Adapter fine-tuning entry point (port of imagharmony_tpu/train/trainer.py,
the reference's train.py main()).

    python -m imagharmony_tpu_torch.train.trainer --full_random --synthetic_data 4 --max_steps 4

    torchrun --nproc_per_node 8 -m imagharmony_tpu_torch.train.trainer --full_random --fsdp ...

Runs on the card unless ``--device cpu``. On a CUDA device every optimizer
step is one CUDA graph, captured at the first step (after any resume) and
replayed once a step (``train/programs.py``, the program layer: the
counterpart of the JAX trainer's donated ``jax.jit`` step); the CPU runs
``step.train_step`` eagerly. Against the JAX trainer:

* several devices are several processes (torchrun; ``parallel/``): each
  joins the group (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
  cpu``), the data axis is ``fit_data_mesh(--train_batch_size)``, every
  rank reads the global batches and draws and computes its rows
  (``step.train_step``), and ``--fsdp`` slices the parameters, AdamW
  moments and frozen towers over it (``parallel/fsdp.py``; with
  ``--lora_rank`` the factored projections and the factors stay whole, as
  their merge reads them whole). Rank 0 alone writes the metrics, the
  exports and the checkpoints, the sliced state gathered first, so a
  checkpoint is one device's and a resume at the same world size is bit
  for bit an uninterrupted run;
* resume through torch.save/torch.load of the trainable weights, the
  optimizer state, the update count and lr, the EMA, the step and the
  state of the torch.Generator the draws come from (the JAX trainer used
  orbax and replayed its key splits), so a resumed run is bit-identical to
  an uninterrupted one on the same device;
* the weights take the compute dtype (bf16 under ``--mixed_precision
  bf16``, fp32 under ``no``), the port's dtype rule;
* ``--pretrained_model_name_or_path`` reads a local diffusers SDXL tree
  (``io/checkpoints.load_components``, with ``--pretrained_ip_adapter_path``
  and ``--image_encoder_path``); the HA head's widths come from the tree's
  towers, its other sizes from the ``--composed_*`` flags;
* ``--fusion_method`` takes each of the HA head's four fusions;
* ``--lora_rank`` trains LoRA factors of the UNet's attention projections
  with the adapters (``train/step.py``), their A drawn from ``--seed``;
* ``--cache_encoders`` with ``--data_json_file`` reads the records with a
  centre crop, computes the towers' outputs once (``train/cache.py``),
  then removes the four towers from the components and trains on cached
  batches (with ``--synthetic_data`` it is ignored, as in the JAX
  trainer).

Metrics go to ``metrics.jsonl`` with the JAX trainer's keys, and every
``--save_steps`` (and at ``--max_steps``) the adapters are exported as
``ip_adapter-N.bin`` (and ``ip_adapter-ema-N.bin`` with ``--ema_decay``),
with LoRA also ``lora-N.safetensors`` (and ``lora-ema-N.safetensors``) in
the JAX ``save_lora`` format.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time

import torch
import torch.distributed as dist

from imagharmony_tpu_torch.adapters import harmony as harmony_lib
from imagharmony_tpu_torch.adapters import lora as lora_lib
from imagharmony_tpu_torch.io import checkpoints as ckpt_io
from imagharmony_tpu_torch.models import tokenizer as tok_lib
from imagharmony_tpu_torch.parallel import distributed, fsdp
from imagharmony_tpu_torch.parallel import mesh as mesh_lib
from imagharmony_tpu_torch.pipelines import components as comp
from imagharmony_tpu_torch.train import cache as cache_lib
from imagharmony_tpu_torch.train import programs as train_programs
from imagharmony_tpu_torch.train import step as step_lib

KEEP_CHECKPOINTS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HA-module / IP-adapter fine-tuning")
    p.add_argument("--pretrained_model_name_or_path", default=None,
                   help="a local diffusers SDXL directory (unet/, vae/, text_encoder/, "
                        "text_encoder_2/, image_encoder/, tokenizer/, tokenizer_2/)")
    p.add_argument("--pretrained_ip_adapter_path", default=None,
                   help="a 3-dict adapter checkpoint (.bin or .safetensors) to start from; "
                        "without it the HA head is fresh from --seed and each IP projection "
                        "starts as its layer's to_k/to_v")
    p.add_argument("--image_encoder_path", default=None,
                   help="the CLIP vision directory, if not the tree's image_encoder/")
    p.add_argument("--data_json_file", default=None)
    p.add_argument("--data_root_path", default="")
    p.add_argument("--output_dir", default="harmony-train")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--learning_rate", type=float, default=2.5e-4)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--noise_offset", type=float, default=None)
    p.add_argument("--prediction_type", default="epsilon",
                   choices=["epsilon", "v_prediction", "sample"])
    p.add_argument("--zero_snr", action="store_true",
                   help="zero terminal SNR beta rescale (arXiv 2305.08891)")
    p.add_argument("--snr_gamma", type=float, default=None,
                   help="min-SNR loss weighting (arXiv 2303.09556)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="EMA of the trainable adapters; also exports ip_adapter-ema-N.bin")
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--lr_scheduler", default="constant", choices=["constant", "cosine"],
                   help="cosine decays to 0 over --max_steps")
    p.add_argument("--lora_rank", type=int, default=None,
                   help="train LoRA factors of this rank on the UNet's attention projections "
                        "with the adapters (exported as lora-N.safetensors)")
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="the LoRA scaling numerator (default: the rank)")
    p.add_argument("--lora_targets", default="to_q,to_k,to_v,to_out",
                   help="comma list of the projections to factor")
    p.add_argument("--save_steps", type=int, default=2000)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    p.add_argument("--mixed_precision", default="bf16", choices=["no", "bf16"])
    # HA hyperparameters (reference run.sh:17-20 naming)
    p.add_argument("--composed_inter_dim", type=int, default=2560)
    p.add_argument("--composed_cross_heads", type=int, default=8)
    p.add_argument("--composed_reshape_blocks", type=int, default=8)
    p.add_argument("--composed_cross_value_dim", type=int, default=64)
    p.add_argument("--fusion_method", default="cross_attention",
                   choices=list(harmony_lib.FUSIONS))
    p.add_argument("--train_image_proj", action="store_true")
    p.add_argument("--tiny", action="store_true", help="random tiny bundle (no checkpoints needed)")
    p.add_argument("--full_random", action="store_true",
                   help="full-size random SDXL bundle (no checkpoints needed)")
    p.add_argument("--cache_encoders", action="store_true",
                   help="compute the VAE and CLIP outputs once and train without the frozen "
                        "towers on the device (centre crop only)")
    p.add_argument("--synthetic_data", type=int, default=0,
                   help="use N synthetic batches instead of --data_json_file")
    p.add_argument("--log_every", type=int, default=10,
                   help="read metrics from the device every N steps")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: shard params + AdamW moments + frozen towers over the data "
                        "axis (parallel/fsdp.py) instead of replicating them: per-card memory "
                        "drops about linearly with the ranks; each weight is gathered where "
                        "it is used and its gradient reduce-scattered")
    p.add_argument("--fsdp_min_shard", type=int, default=None,
                   help="smallest leaf (elements) FSDP shards; below it leaves replicate "
                        "(default parallel/fsdp.py MIN_SHARD_ELEMS)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu); under torchrun cuda is cuda:LOCAL_RANK")
    return p.parse_args(argv)


def _harmony_config(args, **widths) -> harmony_lib.HarmonyConfig:
    return harmony_lib.HarmonyConfig(
        inter_dim=args.composed_inter_dim,
        cross_heads=args.composed_cross_heads,
        reshape_blocks=args.composed_reshape_blocks,
        cross_value_dim=args.composed_cross_value_dim,
        fusion_method=args.fusion_method,
        **widths,
    )


def build_components(args):
    """(cfgs, components on args.device in the compute dtype, tokenizers):
    random weights from --seed for --tiny or --full_random, else the tree
    of --pretrained_model_name_or_path (JAX trainer.py:149-171)."""
    dtype = torch.float32 if args.mixed_precision == "no" else torch.bfloat16
    toy = tok_lib.build_toy_tokenizer()
    toks = tok_lib.SDXLTokenizers(toy, toy)
    if args.tiny:
        cfgs = comp.tiny_configs(vocab_size=len(toy.encoder))
    elif args.full_random:
        cfgs = comp.sdxl_configs(_harmony_config(args))
    elif args.pretrained_model_name_or_path:
        return _pretrained_components(args, dtype)
    else:
        raise SystemExit("--pretrained_model_name_or_path required (or use --tiny)")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    return cfgs, comp.init_params(gen, cfgs, dtype=dtype, device=args.device), toks


def _pretrained_components(args, dtype):
    """The tree and adapter of ``args``. The HA config is the flags' at the
    tree's widths (the vision projection, both text towers); an adapter's
    HA weights must have that config. Without an adapter the HA head and
    the image projection are fresh from --seed (the reference builds a new
    ImageProjModel; the JAX trainer keeps the loader's zeros, through which
    no gradient reaches the adapter) and each IP projection copies its
    layer's to_k/to_v (reference train.py:554-561)."""
    cfgs, comps, toks = ckpt_io.load_components(
        args.pretrained_model_name_or_path, args.pretrained_ip_adapter_path,
        args.image_encoder_path, device=args.device, dtype=dtype)
    if cfgs.family != "sdxl":
        raise NotImplementedError(f"the train step is ported for the SDXL family only, not "
                                  f"{cfgs.family}")
    ha_cfg = _harmony_config(args, image_hidden_size=cfgs.vision.projection_dim,
                             text_context_dim=cfgs.text_l.hidden_size + cfgs.text_g.hidden_size)
    if args.pretrained_ip_adapter_path is None:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        with torch.device("meta"):
            fresh = harmony_lib.HarmonyAttention(ha_cfg, dtype=dtype)
        comps.harmony = comp.init_weights_(fresh.to_empty(device=args.device), gen)
        comp.init_weights_(comps.image_proj, gen)
        comp.seed_ip_from_unet(comps.unet)
    else:
        # the fusions' own sizes have no flag: the adapter's stand
        ha_cfg = dataclasses.replace(ha_cfg, **{f: getattr(cfgs.harmony, f) for f in (
            "scale", "qformer_queries", "qformer_layers", "qformer_ff_dim", "mlp_tokens",
            "gate_hidden_dim")})
        if ha_cfg != cfgs.harmony:
            raise ValueError(f"the adapter's HA config {cfgs.harmony} is not the flags' "
                             f"{ha_cfg}")
    cfgs = dataclasses.replace(cfgs, harmony=ha_cfg)
    comps.cfgs = cfgs
    return cfgs, comps, toks


def train_config(args, cfgs) -> step_lib.TrainConfig:
    """The TrainConfig of ``args`` (weight decay masked off the inert IP
    projections of ``cfgs.unet``; a cosine schedule decays over
    --max_steps)."""
    return step_lib.TrainConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        noise_offset=args.noise_offset,
        prediction_type=args.prediction_type,
        rescale_zero_snr=args.zero_snr,
        snr_gamma=args.snr_gamma,
        train_image_proj=args.train_image_proj,
        unet_cfg=cfgs.unet,
        grad_accum=args.grad_accum,
        ema_decay=args.ema_decay,
        lr_warmup_steps=args.lr_warmup_steps,
        lr_schedule=args.lr_scheduler,
        lr_total_steps=args.max_steps or 0,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        lora_targets=args.lora_targets,
    )


def make_batches(args, cfgs, comps, tokenizers, mesh=None):
    """The trainer's batches (numpy dicts of ``--train_batch_size`` times
    ``--grad_accum`` rows): ``--synthetic_data``'s dummy batches, else the
    dataset of ``--data_json_file``; with ``--cache_encoders`` the
    dataset's encoder cache (``cache.precompute``, each rank of ``mesh``
    encoding its share of the records), after which the four towers are
    dropped from ``comps``."""
    step_rows = args.train_batch_size * max(args.grad_accum, 1)
    if args.synthetic_data:
        return (step_lib.dummy_batch(cfgs, batch_size=step_rows, resolution=args.resolution,
                                     rng=i) for i in range(args.synthetic_data))
    from imagharmony_tpu_torch.train.dataset import HarmonyDataset

    ds = HarmonyDataset(
        args.data_json_file, tokenizers, size=args.resolution,
        clip_image_size=cfgs.vision.image_size, image_root_path=args.data_root_path,
        max_token_length=cfgs.text_l.max_position_embeddings,
    )
    if not args.cache_encoders:
        return ds.batches(step_rows, seed=args.seed, epochs=args.num_train_epochs)
    print(f"precomputing the encoder cache over {len(ds)} records...")
    enc_cache = cache_lib.precompute(comps, cfgs, ds, mesh=mesh)
    freed = cache_lib.drop_towers(comps)  # the step never reads them now
    print(f"dropped the frozen towers: {freed / 2**30:.3f} GiB")
    return cache_lib.batches_from_cache(enc_cache, step_rows, seed=args.seed,
                                        epochs=args.num_train_epochs)


def _checkpoints(ckpt_dir):
    """{step: path} of the saved training states."""
    if not os.path.isdir(ckpt_dir):
        return {}
    found = {}
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step-(\d+)\.pt", name)
        if m:
            found[int(m.group(1))] = os.path.join(ckpt_dir, name)
    return found


def _save_checkpoint(ckpt_dir, state, gen, sharded=False):
    """Rank 0 writes the state (made whole first when ``sharded``: every
    rank takes part in the gathers)."""
    main_rank = distributed.is_main_process()
    sd = state.state_dict() if sharded or main_rank else None
    if sharded:
        sd = fsdp.full_state_dict(sd, state)
    if main_rank:
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"step-{state.step}.pt")
        tmp = path + ".tmp"
        torch.save({**sd, "generator": gen.get_state()}, tmp)
        os.replace(tmp, path)  # a crash never leaves half a checkpoint under the final name
        old = sorted(_checkpoints(ckpt_dir))[:-KEEP_CHECKPOINTS]
        for s in old:
            os.remove(os.path.join(ckpt_dir, f"step-{s}.pt"))
    distributed.barrier()


def _fsdp_skip(args, cfgs, comps):
    """The parameters ``--fsdp`` keeps whole: with ``--lora_rank`` the
    factored projections, which the step's merge reads whole."""
    lcfg = train_config(args, cfgs).lora_config()
    if lcfg is None:
        return lambda name: False
    keep = {f"unet.{path}.to_out.0.weight" if proj == "to_out" else f"unet.{key}"
            for key, path, proj, _ in lora_lib._targets(comps.unet, lcfg)}
    return keep.__contains__


def main(argv=None):
    args = parse_args(argv)
    if args.lr_scheduler == "cosine" and not args.max_steps:
        raise SystemExit("--lr_scheduler cosine needs --max_steps (the decay horizon)")
    # one process per device: torchrun's ranks join the group here (a world
    # of one stays the one-device path, unless the caller made a group)
    args.device = str(distributed.local_device(args.device))
    distributed.initialize(args.device)
    mesh = mesh_lib.fit_data_mesh(args.train_batch_size) if dist.is_initialized() else None
    main_rank = distributed.is_main_process()
    os.makedirs(args.output_dir, exist_ok=True)

    cfgs, comps, tokenizers = build_components(args)
    tcfg = train_config(args, cfgs)
    if args.fsdp and mesh is not None:
        kw = {} if args.fsdp_min_shard is None else {"min_elems": args.fsdp_min_shard}
        fsdp.shard_tree(mesh, comps, skip=_fsdp_skip(args, cfgs, comps), **kw)
    state = step_lib.init_state(comps, tcfg, seed=args.seed, mesh=mesh)
    sharded = any(fsdp.info(p) is not None for p in state.trainable.values())
    n_train = sum(p.numel() for p in state.trainable.values())
    print(f"trainable params: {n_train / 1e6:.2f}M" + (f" on this rank, {mesh}" if mesh else ""))

    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    saved = _checkpoints(ckpt_dir)
    if args.resume and saved:
        sd = torch.load(saved[max(saved)], map_location=args.device, weights_only=True)
        state.load_state_dict(fsdp.local_state_dict(sd, state) if sharded else sd)
        gen.set_state(sd["generator"].cpu())
        print(f"resumed from step {state.step}")
    start_step = state.step
    if main_rank:
        with open(os.path.join(args.output_dir, "harmony_config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfgs.harmony), f, indent=2)

    step_rows = args.train_batch_size * max(args.grad_accum, 1)
    batches = make_batches(args, cfgs, comps, tokenizers, mesh)
    # skip the batches the interrupted run consumed; the generator state
    # came back with the checkpoint
    for _ in range(start_step):
        next(batches, None)

    device = torch.device(args.device)
    programs = {}  # the captured step, on a CUDA device
    global_step = start_step
    log_path = os.path.join(args.output_dir, "metrics.jsonl") if main_rank else os.devnull
    with open(log_path, "a") as metrics_log:
        # metrics stay on the device between log points: reading one is a
        # sync; each step's are a clone, as a replay overwrites the program's
        pending = []  # (step, metrics, data_time)
        window_t0 = time.perf_counter()

        def drain_pending():
            nonlocal window_t0
            if not pending:
                return
            # reading the metrics waits for their steps, so the window's
            # time is that of finished steps
            rows = [(s, float(m["loss"]), float(m["grad_norm"]), dtm) for s, m, dtm in pending]
            per_step = (time.perf_counter() - window_t0) / len(pending)
            for s, loss, grad_norm, dtm in rows:
                metrics_log.write(json.dumps({
                    "step": s, "loss": loss, "grad_norm": grad_norm,
                    "step_time_s": round(per_step, 4), "data_time_s": round(dtm, 4),
                    "wall": time.time(),
                }) + "\n")
            metrics_log.flush()
            if main_rank:
                print(f"step {rows[-1][0]}, {per_step * 1000:.0f} ms/step, "
                      f"step_loss: {rows[-1][1]:.5f}")
            pending.clear()
            window_t0 = time.perf_counter()

        t_begin = time.perf_counter()
        for batch in batches:
            if args.max_steps and global_step >= args.max_steps:
                break
            data_time = time.perf_counter() - t_begin
            batch = step_lib.to_device(batch, device)
            if device.type == "cuda":
                metrics = train_programs.run(programs, state, comps, cfgs, tcfg, batch, gen,
                                             args.resolution)
            else:
                draws = step_lib.step_draws(gen, cfgs, tcfg, step_rows, args.resolution)
                metrics = step_lib.train_step(state, comps, tcfg, batch, draws)
            global_step = state.step
            pending.append((global_step, {k: v.clone() for k, v in metrics.items()}, data_time))
            last = bool(args.max_steps and global_step >= args.max_steps)
            if global_step % args.log_every == 0 or last:
                drain_pending()
            t_begin = time.perf_counter()
            if global_step % args.save_steps == 0 or last:
                drain_pending()
                _save_checkpoint(ckpt_dir, state, gen, sharded)
                _export_adapter(args, cfgs, comps, state, global_step)
        drain_pending()
    print("training done at step", global_step)
    return global_step


def _export_adapter(args, cfgs, comps, state, step):
    """Rank 0 writes the adapters (and LoRA factors) of ``comps``, and with
    an EMA the EMA weights swapped in. Every rank swaps, and gathers the
    FSDP slices of what the export reads: the UNet's IP projections, the
    image projection and the HA module (the LoRA factors are never
    sliced)."""
    ip = list(ckpt_io.adapter_projections(comps.unet, cfgs.unet).values())

    def export(tag):
        with fsdp.gathered(*ip, comps.image_proj, comps.harmony):
            if distributed.is_main_process():
                write(tag)

    def write(tag):
        path = os.path.join(args.output_dir, f"ip_adapter{tag}.bin")
        ckpt_io.save_adapter_checkpoint(
            path, unet=comps.unet, unet_cfg=cfgs.unet, image_proj=comps.image_proj,
            harmony=comps.harmony, harmony_cfg=cfgs.harmony,
        )
        print("exported", path)
        if state.factors is not None:
            lpath = os.path.join(args.output_dir, f"lora{tag}.safetensors")
            lora_lib.save_lora(lpath, state.factors, train_config(args, cfgs).lora_config())
            print("exported", lpath)

    export(f"-{step}")
    if state.ema is not None:
        # the EMA weights swapped in for the export, then the live ones back
        live = {n: p.detach().clone() for n, p in state.trainable.items()}
        with torch.no_grad():
            for n, p in state.trainable.items():
                p.copy_(state.ema[n])
            try:
                export(f"-ema-{step}")
            finally:
                for n, p in state.trainable.items():
                    p.copy_(live[n])


if __name__ == "__main__":
    main()
