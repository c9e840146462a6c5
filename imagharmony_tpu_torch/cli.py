"""Command-line entry points (port of imagharmony_tpu/cli.py):

    python -m imagharmony_tpu_torch.cli edit|demo|serve|parity|convert|train ...

``edit`` is the reference's test.py: load a diffusers tree with its adapter
(and a ControlNet), merge ``--lora`` files and install textual inversions,
edit ``--input``; with ``--refiner-dir`` the base denoises to
``--denoising-end`` and the refiner finishes from its latents; a refiner
tree given as ``--model-dir`` refines ``--input`` by img2img;
``--attn-maps`` also writes the IP tokens' attention heatmaps. ``demo``
runs a few-step edit on the random tiny pipeline, ``serve`` the editing
service (``pipelines/serving.py``), ``parity`` the per-step cosine against
a diffusers capture, ``convert`` re-keys training checkpoints into adapter
files, ``train`` passes its arguments to the trainer
(``train/trainer.py``). Each runs on the card unless ``--device cpu``
(the trainer takes its own ``--device``); the weights are bf16 on the card
and fp32 on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; bf16 weights) or cpu (fp32)")


def _dtype(device):
    import torch

    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def _add_edit_args(p):
    p.add_argument("--input", help="reference image path")
    p.add_argument("--prompt", default="best quality, high quality")
    p.add_argument("--extra-text", default=None, help="count+class caption, e.g. 'eight sheep'")
    p.add_argument("--negative-prompt", default=None)
    p.add_argument("--output", default="output.png")
    p.add_argument("--model-dir", default=None, help="SDXL checkpoint directory")
    p.add_argument("--adapter-ckpt", default=None, help="ip_adapter.bin / .safetensors")
    p.add_argument("--lora", action="append", default=None, metavar="PATH[:SCALE]",
                   help="lora-N.safetensors merged into the UNet before generation; "
                        "repeatable (the merges add); :SCALE overrides --lora-scale")
    p.add_argument("--lora-scale", type=float, default=1.0)
    p.add_argument("--textual-inversion", action="append", default=None,
                   metavar="PATH[:TOKEN]",
                   help="learned textual-inversion embedding (safetensors; SDXL dual "
                        "{clip_l, clip_g} or single-tower token-keyed); repeatable; :TOKEN "
                        "overrides the placeholder name")
    p.add_argument("--image-encoder-dir", default=None)
    p.add_argument("--controlnet-dir", default=None,
                   help="diffusers ControlNetModel directory (optional)")
    p.add_argument("--refiner-dir", default=None,
                   help="SDXL refiner checkpoint directory: the base denoises "
                        "[0, --denoising-end), the refiner finishes from its latents")
    p.add_argument("--denoising-end", type=float, default=None,
                   help="base/refiner split (default 0.8 with --refiner-dir)")
    p.add_argument("--control-image", default=None,
                   help="conditioning image for the ControlNet branch")
    p.add_argument("--init-image", default=None,
                   help="img2img: start from this image noised to --strength")
    p.add_argument("--mask-image", default=None,
                   help="inpaint mask (white = repaint); requires --init-image")
    p.add_argument("--strength", type=float, default=None,
                   help="img2img strength in (0, 1]: the fraction of the schedule denoised")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--guidance-scale", type=float, default=5.0)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--scheduler", default="euler",
                   choices=["euler", "euler_a", "ddim", "dpm++", "lcm"],
                   help="lcm: the few-step sampler of LCM-distilled checkpoints (--steps 4..8, "
                        "--guidance-scale 1.0)")
    p.add_argument("--fast", action="store_true",
                   help="latency preset: 15 steps and trailing spacing (changes outputs)")
    p.add_argument("--turbo", action="store_true",
                   help="encoder propagation: the UNet encoder every 2nd step (changes "
                        "outputs)")
    p.add_argument("--timestep-spacing", default=None,
                   choices=["leading", "trailing", "linspace"])
    p.add_argument("--prediction-type", default="epsilon",
                   choices=["epsilon", "v_prediction", "sample"])
    p.add_argument("--zero-snr", action="store_true", help="zero terminal SNR betas")
    p.add_argument("--karras", action="store_true", help="Karras sigmas (euler, dpm++)")
    p.add_argument("--prompt-weighting", action="store_true",
                   help="parse the (word:1.5)/[word] grammar in the prompts")
    p.add_argument("--clip-skip", type=int, default=0)
    p.add_argument("--tile-vae", action="store_true")
    p.add_argument("--pns", type=int, default=0,
                   help="preference-guided noise selection over K seeds")
    p.add_argument("--attn-maps", default=None, metavar="DIR",
                   help="also save one IP token cross-attention heatmap a token over the "
                        "input image to DIR")
    _add_device(p)


def _open(path):
    from PIL import Image

    return Image.open(path) if path else None


def _save_attn_maps(pipe, image, args):
    """The IP branch's attention as token heatmaps over the input
    (``utils/attn_maps.py``), one PNG a token in ``--attn-maps``."""
    from imagharmony_tpu_torch.utils import attn_maps as am

    os.makedirs(args.attn_maps, exist_ok=True)
    maps = am.ip_attention_maps(pipe, image, prompt=args.prompt, extra_text=args.extra_text,
                                latent_size=args.height // pipe.cfgs.vae.downscale,
                                seed=args.seed)
    for i, im in enumerate(am.heatmap_to_pil(maps, base_image=image)):
        im.save(os.path.join(args.attn_maps, f"ip_token_{i}.png"))
    print(f"saved {len(maps)} IP attention heatmaps to {args.attn_maps}")


def _merge_loras(pipe, args):
    """Every --lora PATH[:SCALE] merged into the UNet (the merges add), then
    every --textual-inversion PATH[:TOKEN] installed."""
    from imagharmony_tpu_torch.adapters import lora as lora_lib

    for spec in getattr(args, "lora", None) or []:
        path, scale = lora_lib.parse_spec(spec, default_scale=getattr(args, "lora_scale", 1.0))
        pipe = pipe.with_lora(path, scale=scale)
        print(f"merged LoRA {path} (scale {scale})")
    for spec in getattr(args, "textual_inversion", None) or []:
        path, token = spec, None
        if ":" in spec and not os.path.exists(spec):
            path, token = spec.rsplit(":", 1)
        pipe = pipe.with_textual_inversion(path, token=token)
        print(f"installed textual inversion {path}" + (f" as {token}" if token else ""))
    return pipe


def edit_kwargs(args):
    """generate()'s options for ``edit``'s arguments, the latency presets
    applied: ``--fast`` runs 15 steps where --steps is 30 and trailing
    spacing where none is given, ``--turbo`` encoder_interval 2."""
    steps, spacing = args.steps, args.timestep_spacing or "leading"
    if args.fast:
        if steps == 30:
            steps = 15
        if args.timestep_spacing is None:
            spacing = "trailing"
    return dict(
        encoder_interval=2 if args.turbo else 1, control_image=_open(args.control_image),
        init_image=_open(args.init_image), mask_image=_open(args.mask_image),
        strength=args.strength, prompt=args.prompt, negative_prompt=args.negative_prompt,
        extra_text=args.extra_text, scale=args.scale, guidance_scale=args.guidance_scale,
        num_inference_steps=steps, timestep_spacing=spacing, use_karras_sigmas=args.karras,
        prediction_type=args.prediction_type, rescale_zero_snr=args.zero_snr,
        clip_skip=args.clip_skip, prompt_weighting=args.prompt_weighting, seed=args.seed,
        num_samples=args.num_samples, height=args.height, width=args.width,
        scheduler=args.scheduler, tile_vae=args.tile_vae, output_type="pil")


def cmd_edit(args):
    from imagharmony_tpu_torch.io import checkpoints

    pipe = checkpoints.load_pipeline(model_dir=args.model_dir, adapter_ckpt=args.adapter_ckpt,
                                     image_encoder_dir=args.image_encoder_dir,
                                     controlnet_dir=args.controlnet_dir, device=args.device,
                                     dtype=_dtype(args.device))
    pipe = _merge_loras(pipe, args)
    image = _open(args.input).resize((512, 512))
    t0 = time.time()
    kw = edit_kwargs(args)
    if pipe.cfgs.vision is None:
        # the refiner family has no image prompt: --input is the image it
        # refines (img2img), unless --init-image names another
        if kw["init_image"] is None:
            kw["init_image"] = image
            if kw["strength"] is None:
                kw["strength"] = 0.3
        kw.pop("scale")
        images = pipe.generate(**kw)
    elif args.refiner_dir:
        # the mixture of denoisers: the base runs [0, end), the refiner takes
        # its latents from denoising_start=end
        end = args.denoising_end or 0.8
        lat = pipe.generate(pil_image=image, denoising_end=end, **kw)
        refiner = checkpoints.load_pipeline(model_dir=args.refiner_dir, device=args.device,
                                            dtype=_dtype(args.device))
        rkw = {k: kw[k] for k in ("prompt", "negative_prompt", "guidance_scale",
                                  "num_inference_steps", "timestep_spacing", "use_karras_sigmas",
                                  "seed", "num_samples", "height", "width", "scheduler",
                                  "tile_vae")}
        images = refiner.generate(latents=lat, denoising_start=end, output_type="pil", **rkw)
    elif args.pns:
        from imagharmony_tpu_torch.pipelines import pns

        images = [pns.generate_with_pns(pipe, image, num_seeds=args.pns, **kw)]
    else:
        images = pipe.generate(pil_image=image, **kw)
    for i, im in enumerate(images):
        path = args.output if len(images) == 1 else args.output.replace(".png", f"_{i}.png")
        im.save(path)
        print(f"saved {path}")
    if args.attn_maps:
        if pipe.cfgs.vision is None:
            print("--attn-maps skipped: no IP branch on the refiner family")
        else:
            _save_attn_maps(pipe, image, args)
    print(f"done in {time.time() - t0:.1f}s")


def cmd_demo(args):
    """A few-step edit on the random tiny pipeline: text, vision, HA, the
    denoise loop and the VAE, with no checkpoint."""
    import numpy as np
    from PIL import Image

    from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline

    pipe = HarmonyPipeline.random_tiny(seed=0, device=args.device, dtype=_dtype(args.device))
    if args.input:
        ref = np.asarray(Image.open(args.input).convert("RGB"))
    else:
        ref = np.random.default_rng(args.seed).integers(0, 255, size=(64, 64, 3), dtype=np.uint8)
    t0 = time.time()
    out = pipe.generate(
        ref, prompt=args.prompt, extra_text=args.extra_text or "six dogs",
        num_inference_steps=args.steps, height=args.height, width=args.width, seed=args.seed,
        scale=args.scale, scheduler=args.scheduler, guidance_scale=args.guidance_scale,
        timestep_spacing=args.timestep_spacing or "leading", use_karras_sigmas=args.karras,
        prediction_type=args.prediction_type, rescale_zero_snr=args.zero_snr,
        clip_skip=args.clip_skip, init_image=_open(args.init_image),
        mask_image=_open(args.mask_image), strength=args.strength,
        encoder_interval=2 if args.turbo else 1, output_type="pil")
    out[0].save(args.output)
    if args.attn_maps:
        _save_attn_maps(pipe, Image.fromarray(ref), args)
    print(json.dumps({"saved": args.output, "seconds": round(time.time() - t0, 2),
                      "steps": args.steps, "size": [args.height, args.width]}))


def cmd_serve(args):
    from imagharmony_tpu_torch.pipelines import serving

    serving.main(args)


def cmd_parity(args):
    """Per-step cosine against a diffusers capture (``--theirs``, made by
    tools/capture_reference.py): our run replays its noise, prompt and
    schedule. With --ours and --theirs, compares two saved captures."""
    import numpy as np

    from imagharmony_tpu_torch.utils import parity

    if args.ours and args.theirs:
        rep = parity.compare(parity.load(args.ours), parity.load(args.theirs))
        rep["pass"] = rep["min_cosine"] >= args.target
        print(json.dumps(rep))
        return rep
    theirs = parity.load(args.theirs) if args.theirs else None
    meta = json.loads(str(theirs["meta"])) if theirs is not None and "meta" in theirs else {}
    if args.model_dir:
        from imagharmony_tpu_torch.io import checkpoints

        pipe = checkpoints.load_pipeline(model_dir=args.model_dir, adapter_ckpt=args.adapter_ckpt,
                                         image_encoder_dir=args.image_encoder_dir,
                                         device=args.device, dtype=_dtype(args.device))
    else:
        from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline

        print("no --model-dir: capturing from the random tiny pipeline")
        pipe = HarmonyPipeline.random_tiny(device=args.device, dtype=_dtype(args.device))
    img = _open(args.input) if args.input else np.zeros((64, 64, 3), np.uint8)
    size = int(meta.get("size", args.size))
    cap = parity.run_capture(
        pipe, img, prompt=meta.get("prompt", args.prompt),
        negative_prompt=meta.get("negative_prompt"), steps=int(meta.get("steps", args.steps)),
        height=size, width=size, seed=int(meta.get("seed", args.seed)),
        scheduler=meta.get("scheduler", args.scheduler),
        guidance_scale=float(meta.get("guidance_scale", 5.0)),
        # against a stock-diffusers capture the IP branch is off
        scale=float(meta.get("ip_scale", 0.0 if theirs is not None else 1.0)),
        noise=theirs["noise"] if theirs is not None and "noise" in theirs else None)
    if args.save:
        parity.save(args.save, cap)
        print(f"saved our capture to {args.save}")
    if theirs is not None:
        rep = parity.compare(cap, theirs)
        rep["target"] = args.target
        rep["pass"] = rep["min_cosine"] >= args.target
        print(json.dumps(rep))
        return rep


def cmd_convert(args):
    from imagharmony_tpu_torch.io import checkpoints

    for path in checkpoints.convert_training_checkpoints(args.log_dir):
        print(f"wrote {path}")


def cmd_train(args, extra):
    from imagharmony_tpu_torch.train import trainer

    trainer.main(extra)


def build_parser():
    parser = argparse.ArgumentParser(prog="imagharmony_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)

    _add_edit_args(sub.add_parser("edit", help="QL-Edit inference (test.py equivalent)"))
    p_demo = sub.add_parser("demo", help="random-weight smoke edit")
    _add_edit_args(p_demo)
    p_demo.set_defaults(steps=4, height=32, width=32)

    p_conv = sub.add_parser("convert", help="convert training checkpoints to adapter files")
    p_conv.add_argument("--log-dir", required=True)

    p_par = sub.add_parser("parity", help="per-step cosine parity against a diffusers capture")
    p_par.add_argument("--ours", default=None, help="our saved capture .npz")
    p_par.add_argument("--theirs", default=None,
                       help="diffusers capture .npz (tools/capture_reference.py)")
    p_par.add_argument("--model-dir", default=None)
    p_par.add_argument("--adapter-ckpt", default=None)
    p_par.add_argument("--image-encoder-dir", default=None)
    p_par.add_argument("--input", default=None, help="reference image (IP branch)")
    p_par.add_argument("--save", default=None, help="save our capture here")
    p_par.add_argument("--prompt", default="best quality, high quality")
    p_par.add_argument("--steps", type=int, default=8)
    p_par.add_argument("--size", type=int, default=256)
    p_par.add_argument("--seed", type=int, default=0)
    # deterministic samplers only: Euler-a draws from another generator
    p_par.add_argument("--scheduler", default="euler", choices=["euler", "ddim", "dpm++"])
    p_par.add_argument("--target", type=float, default=0.999)
    _add_device(p_par)

    p_serve = sub.add_parser("serve", help="batched editing service")
    p_serve.add_argument("--port", type=int, default=7860)
    p_serve.add_argument("--host", default="0.0.0.0")
    p_serve.add_argument("--model-dir", default=None)
    p_serve.add_argument("--adapter-ckpt", default=None)
    p_serve.add_argument("--lora", action="append", default=None, metavar="PATH[:SCALE]",
                         help="lora-N.safetensors merged into the UNet at startup (repeatable; "
                              ":SCALE suffix per adapter)")
    p_serve.add_argument("--lora-scale", type=float, default=1.0)
    p_serve.add_argument("--textual-inversion", action="append", default=None,
                         metavar="PATH[:TOKEN]",
                         help="textual-inversion embedding(s) installed at startup")
    p_serve.add_argument("--continuous", action="store_true",
                         help="continuous batching: admit requests mid-denoise")
    p_serve.add_argument("--turbo", action="store_true",
                         help="encoder_interval 2 for requests that set none (changes "
                              "outputs)")
    _add_device(p_serve)

    sub.add_parser("train", help="adapter fine-tuning (arguments passed through)",
                   add_help=False)
    return parser


def main(argv=None):
    args, extra = build_parser().parse_known_args(argv)
    {"edit": cmd_edit, "demo": cmd_demo, "convert": cmd_convert, "parity": cmd_parity,
     "serve": cmd_serve}.get(args.cmd, lambda a: cmd_train(a, extra))(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
