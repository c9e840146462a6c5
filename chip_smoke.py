"""On-card smoke test of the PyTorch/CUDA port (imagharmony_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as it finishes; any failure raises and the exit code
is non-zero:

1. device and power limit (nvidia-smi); no CUDA -> fail;
2. build K1 (the hand-written CUDA attention kernel) from the sources in
   the checkout;
3. K1 against its plain PyTorch version on the card, bf16 inputs passed as
   strided column slices of one packed (B, S, 3*H*D) tensor, at the main
   path's two shapes and two edge shapes, with timings;
4. the tiny pipeline on the card (bf16, K1) against the same weights on the
   CPU (fp32, plain attention);
5. the full-size SDXL QL-Edit ``generate()`` at 1024², 30 Euler steps,
   random weights from a seed, with the K1 launch count checked.

The line before the last is a JSON object describing each kernel of the
path; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# K1 against its plain version: bf16 kernel vs fp32 reference on the same
# bf16 inputs. Tolerances: one bf16 rounding of P and of the output, well
# inside 2e-2 absolute at unit-variance inputs.
K1_MAX_ABS = 2e-2
K1_MIN_COSINE = 0.9999
# tiny pipeline, bf16 on the card vs fp32 on the CPU over 3 Euler steps:
# bf16 weights and activations alone give a cosine of ~0.9998 here (the same
# comparison run bf16 vs fp32 on the CPU)
TINY_MIN_COSINE = 0.999
FULL_STEPS = 30
SELF_ATTN_PER_UNET_CALL = 70  # SDXL at 1024²: 10 at S=4096 + 60 at S=1024

MAIN_SHAPES = [(4096, 10, 64), (1024, 20, 64)]
EDGE_SHAPES = [(1000, 2, 64), (64, 4, 32)]


def _cuda_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build(fa):
    t0 = time.perf_counter()
    fa._entry()
    print(f"phase 2 build K1: {time.perf_counter() - t0:.2f} s", flush=True)


@torch.inference_mode()
def phase_k1(fa):
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err, main_ms = 0.0, {}
    for s, h, d in MAIN_SHAPES + EDGE_SHAPES:
        qkv = torch.randn((2, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        scale = d**-0.5
        out = fa.flash_attention_nhd(q, k, v, scale=scale, head_dim=d)
        torch.cuda.synchronize()
        ref = fa.flash_attention_nhd_plain(q.float(), k.float(), v.float(),
                                           scale=scale, head_dim=d)
        err = float((out.float() - ref).abs().max())
        cos = _cosine(out.float(), ref)
        print(f"phase 3 K1 B=2 S={s} H={h} D={d}: max_abs={err:.3e} cosine={cos:.7f}", flush=True)
        if not (err <= K1_MAX_ABS and cos >= K1_MIN_COSINE):
            raise AssertionError(f"K1 disagrees with its plain version at S={s} H={h} D={d}")
        max_err = max(max_err, err)
        if (s, h, d) in MAIN_SHAPES:
            ms = _cuda_ms(lambda: fa.flash_attention_nhd(q, k, v, scale=scale, head_dim=d))
            plain_ms = _cuda_ms(
                lambda: fa.flash_attention_nhd_plain(q, k, v, scale=scale, head_dim=d))
            main_ms[(s, h, d)] = (ms, plain_ms)
            print(f"phase 3 time S={s} H={h} D={d}: K1 {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
    return max_err, main_ms


def phase_tiny(fa, HarmonyPipeline):
    cpu = HarmonyPipeline.random_tiny(seed=0)
    card = HarmonyPipeline(
        copy.deepcopy(cpu.components).to(device="cuda", dtype=torch.bfloat16), cpu.tokenizers
    )
    img = np.random.default_rng(0).integers(0, 255, (48, 48, 3), dtype=np.uint8)
    noise = np.random.default_rng(1).standard_normal((1, 32, 32, 4)).astype(np.float32)
    kw = dict(prompt="a dog", extra_text="six dogs", num_inference_steps=3,
              height=64, width=64, noise=noise, output_type="raw")
    ref = cpu.generate(img, **kw)
    fa.launches = 0
    out = card.generate(img, **kw)
    torch.cuda.synchronize()
    cos = _cosine(out.float().cpu(), ref)
    print(f"phase 4 tiny pipeline card bf16 vs cpu fp32: image cosine={cos:.6f}, "
          f"K1 launches={fa.launches}", flush=True)
    if not (torch.isfinite(out).all() and cos >= TINY_MIN_COSINE and fa.launches > 0):
        raise AssertionError("tiny pipeline on the card disagrees with the CPU")


def phase_full(fa, HarmonyPipeline):
    t0 = time.perf_counter()
    pipe = HarmonyPipeline.random_full(seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.components.parameters())
    print(f"phase 5 built random_full: {n_params / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    img = np.random.default_rng(0).integers(0, 255, (1024, 1024, 3), dtype=np.uint8)
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    fa.launches = 0
    t0 = time.perf_counter()
    out = pipe.generate(img, prompt="a photo of six sheep on a meadow", extra_text="six sheep",
                        num_samples=1, seed=0, num_inference_steps=FULL_STEPS,
                        guidance_scale=5.0, output_type="raw", timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    finite = bool(torch.isfinite(out).all())
    print(f"phase 5 generate 1024² {FULL_STEPS} steps: total {wall:.3f} s, "
          f"conditioning {timings['conditioning_s']:.3f} s, denoise {timings['denoise_s']:.3f} s, "
          f"decode {timings['decode_s']:.3f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K1 launches {launches}, "
          f"shape {tuple(out.shape)}, finite {finite}", flush=True)
    expected = SELF_ATTN_PER_UNET_CALL * FULL_STEPS
    if tuple(out.shape) != (1, 1024, 1024, 3) or not finite:
        raise AssertionError(f"bad output: shape {tuple(out.shape)}, finite {finite}")
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, expected {expected}")
    return launches


def main():
    from imagharmony_tpu_torch.kernels import flash_attention as fa
    from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline

    phase_device()
    phase_build(fa)
    max_err, main_ms = phase_k1(fa)
    phase_tiny(fa, HarmonyPipeline)
    launches = phase_full(fa, HarmonyPipeline)
    ms, plain_ms = main_ms[MAIN_SHAPES[0]]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_nhd",
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/flash_attn_nhd.cu",
        "replaces": "imagharmony_tpu/kernels/flash_attention.py:415",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
