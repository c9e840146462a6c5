"""HarmonyBench-style dataset evaluation: CLIP-T / CLIP-I over a manifest
(port of tools/eval_benchmark.py).

The paper (arXiv 2506.01949) reports CLIP-T and CLIP-I on HarmonyBench;
the reference repo ships neither the bench nor any eval code. This tool
runs the protocol the day a benchmark manifest and weights exist, and as a
random-weight drill today:

    # drill (no weights, synthetic records), on the CPU or on the card
    python -m imagharmony_tpu_torch.tools.eval_benchmark --random tiny --synthetic 4 \\
        --steps 2 --device cpu
    python -m imagharmony_tpu_torch.tools.eval_benchmark --random full --synthetic 4

    # real evaluation
    python -m imagharmony_tpu_torch.tools.eval_benchmark \\
        --model_dir /ckpts/sdxl-base --adapter_ckpt /ckpts/ip_adapter.bin \\
        --manifest harmonybench.json --data_root images/ --out_dir eval_report

Manifest schema = the training-data schema (reference train.py:53):
[{"image_file": ..., "text": <target prompt>, "extra_text": <count+class
caption>}, ...]. Per record it runs the QL-Edit and reports CLIP-T
(edited vs text) and CLIP-I (edited vs source image) on the pipeline's own
towers (``utils/clip_metrics.py``); it writes ``records.jsonl`` and
``summary.json`` into ``--out_dir`` and prints the aggregate as its last
line, one JSON object. A record's ``seconds`` is read once its edit has
reached host memory and been scored. This is the quality evaluation, not a
performance benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

SYNTHETIC_COUNTS = ("two", "three", "four", "five", "six", "seven", "eight")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_dir")
    ap.add_argument("--adapter_ckpt")
    ap.add_argument("--image_encoder_dir")
    ap.add_argument("--random", choices=["tiny", "full"],
                    help="random-weight drill instead of real checkpoints")
    ap.add_argument("--manifest", help="JSON list of records (train.json schema)")
    ap.add_argument("--data_root", default="")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="N synthetic records instead of --manifest")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--guidance_scale", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--limit", type=int, default=None, help="evaluate first N records")
    ap.add_argument("--out_dir", default="eval_report")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; bf16 weights) or cpu (fp32)")
    args = ap.parse_args(argv)
    if not args.random and not args.model_dir:
        ap.error("need --model_dir (real weights) or --random tiny|full")
    if not args.manifest and not args.synthetic:
        ap.error("need --manifest or --synthetic N")
    return args


def build_pipeline(args):
    """``--random tiny|full`` (seed 0) or the tree of ``--model_dir``, on
    ``--device`` in the CLI's dtype for it."""
    from imagharmony_tpu_torch.cli import _dtype

    kw = dict(device=args.device, dtype=_dtype(args.device))
    if args.random:
        from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline

        make = HarmonyPipeline.random_tiny if args.random == "tiny" else HarmonyPipeline.random_full
        return make(seed=0, **kw)
    from imagharmony_tpu_torch.io import checkpoints

    return checkpoints.load_pipeline(model_dir=args.model_dir, adapter_ckpt=args.adapter_ckpt,
                                     image_encoder_dir=args.image_encoder_dir, **kw)


def default_resolution(random):
    return 32 if random == "tiny" else 1024


def synthetic_records(n):
    """The JAX tool's synthetic records: 64x64 uint8 images from
    ``default_rng(0)``, "a photo of <count> sheep", extra text "six dogs"."""
    rng = np.random.default_rng(0)
    return [{"image": rng.integers(0, 255, (64, 64, 3), np.uint8),
             "text": f"a photo of {count} sheep", "extra_text": "six dogs"}
            for count in SYNTHETIC_COUNTS][:n]


def manifest_records(path, data_root="", limit=None):
    """The manifest's records, each image opened as RGB and resized to 512²."""
    from PIL import Image

    with open(path) as f:
        raw = json.load(f)
    if limit:
        raw = raw[:limit]
    return [{"image": np.asarray(Image.open(os.path.join(data_root, r["image_file"]))
                                 .convert("RGB").resize((512, 512))),
             "text": r["text"], "extra_text": r.get("extra_text", "")} for r in raw]


def evaluate(pipe, records, *, steps, guidance_scale, seed, height, width, out_dir,
             weights=None):
    """Edits and scores each record, writing ``records.jsonl`` (one row a
    record) and ``summary.json`` into ``out_dir``. Returns (summary, rows,
    images): images the edited (1, H, W, 3) float32 numpy arrays in [-1, 1],
    one a record. ``weights``: what the summary names as the weights."""
    from imagharmony_tpu_torch.utils import clip_metrics

    os.makedirs(out_dir, exist_ok=True)
    rows, images = [], []
    t_all = time.time()
    with open(os.path.join(out_dir, "records.jsonl"), "w") as logf:
        for i, r in enumerate(records):
            t0 = time.time()
            edited = pipe.generate(
                pil_image=r["image"], prompt=r["text"], extra_text=r["extra_text"] or None,
                num_inference_steps=steps, guidance_scale=guidance_scale, seed=seed,
                height=height, width=width, output_type="raw")
            edited = edited.float().cpu().numpy()  # on the host: the card has finished
            row = {
                "index": i,
                "text": r["text"],
                "clip_t": round(float(clip_metrics.clip_t(pipe, edited, r["text"]).mean()), 5),
                "clip_i": round(float(
                    clip_metrics.clip_i(pipe, edited, r["image"][None]).mean()), 5),
                "seconds": round(time.time() - t0, 2),
            }
            rows.append(row)
            images.append(edited)
            logf.write(json.dumps(row) + "\n")
            print(f"[{i + 1}/{len(records)}] clip_t={row['clip_t']} "
                  f"clip_i={row['clip_i']} ({row['seconds']}s)", flush=True)
    summary = {
        "n": len(rows),
        "clip_t_mean": round(float(np.mean([r["clip_t"] for r in rows])), 5),
        "clip_i_mean": round(float(np.mean([r["clip_i"] for r in rows])), 5),
        "steps": steps, "res": [height, width],
        "weights": weights,
        "total_seconds": round(time.time() - t_all, 1),
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary, rows, images


def main(argv=None):
    args = parse_args(argv)
    pipe = build_pipeline(args)
    res = default_resolution(args.random)
    records = (synthetic_records(args.synthetic) if args.synthetic
               else manifest_records(args.manifest, args.data_root, args.limit))
    summary, _, _ = evaluate(
        pipe, records, steps=args.steps, guidance_scale=args.guidance_scale, seed=args.seed,
        height=args.height or res, width=args.width or res, out_dir=args.out_dir,
        weights=("random-" + args.random) if args.random else args.model_dir)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
