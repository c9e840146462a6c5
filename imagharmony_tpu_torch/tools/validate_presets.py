"""Quality-validation protocol for the latency presets (``--fast`` /
``--turbo``) (port of tools/validate_presets.py): one command that, given
weights, produces the exact edit plus each preset on the same inputs and
reports how far each preset's output moves, runnable the day real weights
exist, and as a random-weight drill today.

    # drill (no weights needed; the tiny pipeline, on the CPU or on the card)
    python -m imagharmony_tpu_torch.tools.validate_presets --random tiny --steps 8 --device cpu

    # real validation (weights on disk; reference demo inputs)
    python -m imagharmony_tpu_torch.tools.validate_presets \\
        --model_dir /ckpts/sdxl-base --adapter_ckpt /ckpts/ip_adapter.bin \\
        --image "demo/six dogs.jpg" --prompt "eight sheep in a field" \\
        --extra_text "six dogs" --out_dir preset_report

Reports, per preset, against the exact ``--steps``-step output:
  raw_cosine_vs_exact: cosine over the decoded float images (a structure
                       proxy);
  clip_i_vs_exact:     CLIP image-image similarity on the pipeline's own
                       vision tower (``utils/clip_metrics.image_embeds``);
  clip_t:              CLIP-T prompt alignment of each output in the bigG
                       joint space, PNS's scorer (``pipelines/pns.py``),
                       reported where the pipeline has a bigG tower (not
                       the SD1.5 family).
Presets change outputs by design; this tool quantifies by how much. It
writes one PNG a preset and ``report.json`` into ``--out_dir``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from imagharmony_tpu_torch.tools.eval_benchmark import build_pipeline, default_resolution

# the JAX tool's table: preset -> generate() options for an exact edit of
# ``steps`` steps
PRESETS = {
    "exact": lambda steps: dict(num_inference_steps=steps),
    "fast": lambda steps: dict(num_inference_steps=max(2, steps // 2),
                               timestep_spacing="trailing"),
    "turbo": lambda steps: dict(num_inference_steps=steps, encoder_interval=2),
    "fast+turbo": lambda steps: dict(num_inference_steps=max(2, steps // 2),
                                     timestep_spacing="trailing", encoder_interval=2),
}


def presets(steps):
    """{preset: generate() options} for an exact edit of ``steps`` steps."""
    return {name: options(steps) for name, options in PRESETS.items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_dir")
    ap.add_argument("--adapter_ckpt")
    ap.add_argument("--image_encoder_dir")
    ap.add_argument("--random", choices=["tiny", "full"],
                    help="random-weight drill instead of real checkpoints")
    ap.add_argument("--image", help="input image (default: synthetic)")
    ap.add_argument("--prompt", default="a photo of eight sheep")
    ap.add_argument("--extra_text", default="six dogs")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--guidance_scale", type=float, default=5.0)
    ap.add_argument("--out_dir", default="preset_report")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; bf16 weights) or cpu (fp32)")
    args = ap.parse_args(argv)
    if not args.random and not args.model_dir:
        ap.error("need --model_dir (real weights) or --random tiny|full")
    return args


def input_image(path=None):
    """``path`` as RGB resized to 512², or the JAX tool's synthetic 512²
    image (``default_rng(0)``)."""
    if path:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB").resize((512, 512)))
    return np.random.default_rng(0).integers(0, 255, (512, 512, 3), np.uint8)


def validate(pipe, image, *, prompt, extra_text, steps, height, width, seed=42,
             guidance_scale=5.0, weights=None):
    """Runs the exact edit and each preset of ``presets(steps)`` on the same
    inputs. Returns (report, outputs): the report as the JAX tool writes it
    (its "inputs", then one row a preset), outputs {preset: the (1, H, W, 3)
    float32 CPU tensor in [-1, 1]}. A preset's seconds are read once its
    image has reached host memory."""
    from imagharmony_tpu_torch.pipelines import pns
    from imagharmony_tpu_torch.utils import clip_metrics
    from imagharmony_tpu_torch.utils.parity import cosine

    base = dict(pil_image=image, prompt=prompt, extra_text=extra_text,
                guidance_scale=guidance_scale, seed=seed, height=height, width=width,
                output_type="raw")
    outputs, seconds = {}, {}
    for name, kw in presets(steps).items():
        t0 = time.time()
        outputs[name] = pipe.generate(**dict(base, **kw)).float().cpu()
        seconds[name] = time.time() - t0

    has_bigg = pipe.cfgs.text_g is not None
    ids_g = pipe._tokenize(prompt)[1] if has_bigg else None
    exact = outputs["exact"]
    exact_emb = clip_metrics.image_embeds(pipe, exact)
    report = {"inputs": {"prompt": prompt, "extra_text": extra_text, "steps": steps,
                         "res": [height, width], "seed": seed, "weights": weights}}
    for name, raw in outputs.items():
        row = {"seconds": round(seconds[name], 2)}
        if name != "exact":
            row["raw_cosine_vs_exact"] = round(cosine(raw.numpy(), exact.numpy()), 5)
            emb = clip_metrics.image_embeds(pipe, raw)
            row["clip_i_vs_exact"] = round(float((emb * exact_emb).sum(-1).mean()), 5)
        if has_bigg:
            score = pns.clip_scores(pipe.components, raw.to(pipe.device), ids_g)
            row["clip_t"] = round(float(score.float().mean()), 5)
        report[name] = row
    return report, outputs


def main(argv=None):
    from PIL import Image

    from imagharmony_tpu_torch.pipelines import harmony_edit as he

    args = parse_args(argv)
    pipe = build_pipeline(args)
    res = default_resolution(args.random)
    report, outputs = validate(
        pipe, input_image(args.image), prompt=args.prompt, extra_text=args.extra_text,
        steps=args.steps, height=args.height or res, width=args.width or res, seed=args.seed,
        guidance_scale=args.guidance_scale,
        weights="random-" + args.random if args.random else args.model_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, raw in outputs.items():
        Image.fromarray(he.to_uint8(raw)[0]).save(
            os.path.join(args.out_dir, f"{name.replace('+', '_')}.png"))
    with open(os.path.join(args.out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2), flush=True)
    print(f"# images + report written to {args.out_dir}/", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
