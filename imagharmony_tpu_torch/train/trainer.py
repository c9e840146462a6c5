"""Adapter fine-tuning entry point (port of imagharmony_tpu/train/trainer.py,
the reference's train.py main()).

    python -m imagharmony_tpu_torch.train.trainer --full_random --synthetic_data 4 --max_steps 4

Runs on the card unless ``--device cpu``. Against the JAX trainer:

* one device, no mesh: the ``--fsdp`` flags are not ported (ROADMAP A15);
* resume through torch.save/torch.load of the trainable weights, the
  optimizer and lr-schedule state, the EMA, the step and the state of the
  torch.Generator the draws come from (the JAX trainer used orbax and
  replayed its key splits), so a resumed run is bit-identical to an
  uninterrupted one on the same device;
* the weights take the compute dtype (bf16 under ``--mixed_precision
  bf16``, fp32 under ``no``), the port's dtype rule;
* not ported yet: ``--pretrained_model_name_or_path`` (checkpoint loading,
  ROADMAP A10), ``--cache_encoders`` (train/cache.py) and ``--lora_rank``
  (ROADMAP A13); each raises.

Metrics go to ``metrics.jsonl`` with the JAX trainer's keys, and every
``--save_steps`` (and at ``--max_steps``) the adapters are exported as
``ip_adapter-N.bin`` (and ``ip_adapter-ema-N.bin`` with ``--ema_decay``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time

import torch

from imagharmony_tpu_torch.adapters import harmony as harmony_lib
from imagharmony_tpu_torch.io import checkpoints as ckpt_io
from imagharmony_tpu_torch.models import tokenizer as tok_lib
from imagharmony_tpu_torch.pipelines import components as comp
from imagharmony_tpu_torch.train import step as step_lib

FUSION_METHODS = ("cross_attention", "qformer", "mlp", "gated-attention")
KEEP_CHECKPOINTS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HA-module / IP-adapter fine-tuning")
    p.add_argument("--pretrained_model_name_or_path", default=None)
    p.add_argument("--pretrained_ip_adapter_path", default=None)
    p.add_argument("--image_encoder_path", default=None)
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
    p.add_argument("--lora_rank", type=int, default=None)
    p.add_argument("--lora_alpha", type=float, default=None)
    p.add_argument("--lora_targets", default="to_q,to_k,to_v,to_out")
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
    p.add_argument("--fusion_method", default="cross_attention", choices=list(FUSION_METHODS))
    p.add_argument("--train_image_proj", action="store_true")
    p.add_argument("--tiny", action="store_true", help="random tiny bundle (no checkpoints needed)")
    p.add_argument("--full_random", action="store_true",
                   help="full-size random SDXL bundle (no checkpoints needed)")
    p.add_argument("--cache_encoders", action="store_true")
    p.add_argument("--synthetic_data", type=int, default=0,
                   help="use N synthetic batches instead of --data_json_file")
    p.add_argument("--log_every", type=int, default=10,
                   help="read metrics from the device every N steps")
    p.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    return p.parse_args(argv)


def build_components(args):
    """(cfgs, components on args.device, tokenizers) for --tiny or
    --full_random, random weights from --seed."""
    dtype = torch.float32 if args.mixed_precision == "no" else torch.bfloat16
    toy = tok_lib.build_toy_tokenizer()
    toks = tok_lib.SDXLTokenizers(toy, toy)
    if args.tiny:
        cfgs = comp.tiny_configs(vocab_size=len(toy.encoder))
    elif args.full_random:
        cfgs = comp.sdxl_configs(harmony_lib.HarmonyConfig(
            inter_dim=args.composed_inter_dim,
            cross_heads=args.composed_cross_heads,
            reshape_blocks=args.composed_reshape_blocks,
            cross_value_dim=args.composed_cross_value_dim,
            fusion_method=args.fusion_method,
        ))
    elif args.pretrained_model_name_or_path:
        raise NotImplementedError(
            "loading a pretrained model is not ported yet (ROADMAP A10): use --tiny or "
            "--full_random")
    else:
        raise SystemExit("--pretrained_model_name_or_path required (or use --tiny)")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    return cfgs, comp.init_params(gen, cfgs, dtype=dtype, device=args.device), toks


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


def _save_checkpoint(ckpt_dir, state, gen):
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step-{state.step}.pt")
    tmp = path + ".tmp"
    torch.save({**state.state_dict(), "generator": gen.get_state()}, tmp)
    os.replace(tmp, path)  # a crash never leaves half a checkpoint under the final name
    old = sorted(_checkpoints(ckpt_dir))[:-KEEP_CHECKPOINTS]
    for s in old:
        os.remove(os.path.join(ckpt_dir, f"step-{s}.pt"))


def main(argv=None):
    args = parse_args(argv)
    if args.lr_scheduler == "cosine" and not args.max_steps:
        raise SystemExit("--lr_scheduler cosine needs --max_steps (the decay horizon)")
    if args.cache_encoders and not args.synthetic_data:
        raise NotImplementedError(
            "--cache_encoders (train/cache.py) is not ported yet (ROADMAP A11)")
    os.makedirs(args.output_dir, exist_ok=True)

    cfgs, comps, tokenizers = build_components(args)
    tcfg = step_lib.TrainConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        noise_offset=args.noise_offset,
        prediction_type=args.prediction_type,
        rescale_zero_snr=args.zero_snr,
        snr_gamma=args.snr_gamma,
        train_image_proj=args.train_image_proj,
        unet_cfg=cfgs.unet,  # masks weight decay off the inert IP projections
        grad_accum=args.grad_accum,
        ema_decay=args.ema_decay,
        lr_warmup_steps=args.lr_warmup_steps,
        lr_schedule=args.lr_scheduler,
        lr_total_steps=args.max_steps or 0,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        lora_targets=args.lora_targets,
    )
    state = step_lib.init_state(comps, tcfg)
    n_train = sum(p.numel() for p in state.trainable.values())
    print(f"trainable params: {n_train / 1e6:.2f}M")

    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    saved = _checkpoints(ckpt_dir)
    if args.resume and saved:
        sd = torch.load(saved[max(saved)], map_location=args.device, weights_only=True)
        state.load_state_dict(sd)
        gen.set_state(sd["generator"].cpu())
        print(f"resumed from step {state.step}")
    start_step = state.step
    with open(os.path.join(args.output_dir, "harmony_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfgs.harmony), f, indent=2)

    step_rows = args.train_batch_size * max(args.grad_accum, 1)
    if args.synthetic_data:
        batches = (step_lib.dummy_batch(cfgs, batch_size=step_rows,
                                        resolution=args.resolution, rng=i)
                   for i in range(args.synthetic_data))
    else:
        from imagharmony_tpu_torch.train.dataset import HarmonyDataset

        ds = HarmonyDataset(
            args.data_json_file, tokenizers, size=args.resolution,
            clip_image_size=cfgs.vision.image_size, image_root_path=args.data_root_path,
            max_token_length=cfgs.text_l.max_position_embeddings,
        )
        batches = ds.batches(step_rows, seed=args.seed, epochs=args.num_train_epochs)
    # skip the batches the interrupted run consumed; the generator state
    # came back with the checkpoint
    for _ in range(start_step):
        next(batches, None)

    device = torch.device(args.device)
    global_step = start_step
    with open(os.path.join(args.output_dir, "metrics.jsonl"), "a") as metrics_log:
        # metrics stay on the device between log points: reading one is a sync
        pending = []  # (step, metrics, data_time)
        window_t0 = time.perf_counter()

        def drain_pending():
            nonlocal window_t0
            if not pending:
                return
            per_step = (time.perf_counter() - window_t0) / len(pending)
            for s, m, dtm in pending:
                metrics_log.write(json.dumps({
                    "step": s, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "step_time_s": round(per_step, 4), "data_time_s": round(dtm, 4),
                    "wall": time.time(),
                }) + "\n")
            metrics_log.flush()
            print(f"step {pending[-1][0]}, {per_step * 1000:.0f} ms/step, "
                  f"step_loss: {float(pending[-1][1]['loss']):.5f}")
            pending.clear()
            window_t0 = time.perf_counter()

        t_begin = time.perf_counter()
        for batch in batches:
            if args.max_steps and global_step >= args.max_steps:
                break
            data_time = time.perf_counter() - t_begin
            metrics = step_lib.train_step(state, comps, cfgs, tcfg,
                                          step_lib.to_device(batch, device), gen,
                                          args.resolution)
            global_step = state.step
            pending.append((global_step, metrics, data_time))
            last = bool(args.max_steps and global_step >= args.max_steps)
            if global_step % args.log_every == 0 or last:
                drain_pending()
            t_begin = time.perf_counter()
            if global_step % args.save_steps == 0 or last:
                drain_pending()
                _save_checkpoint(ckpt_dir, state, gen)
                _export_adapter(args, cfgs, comps, state, global_step)
        drain_pending()
    print("training done at step", global_step)
    return global_step


def _export_adapter(args, cfgs, comps, state, step):
    def export(tag):
        path = os.path.join(args.output_dir, f"ip_adapter{tag}.bin")
        ckpt_io.save_adapter_checkpoint(
            path, unet=comps.unet, unet_cfg=cfgs.unet, image_proj=comps.image_proj,
            harmony=comps.harmony, harmony_cfg=cfgs.harmony,
        )
        print("exported", path)

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
