"""On-card smoke test of the PyTorch/CUDA port (imagharmony_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as it finishes; any failure raises and the exit code
is non-zero:

1. device and power limit (nvidia-smi), and whether ``import triton``
   works; no CUDA -> fail;
2. build K1 and K4 (one source, one device kernel, attn_fwd_wgmma_kernel,
   under the packed and the head-split entry point), K3 (their backward,
   under the same two layouts), K2 (the fused text + IP cross-attention,
   cross_attn_wgmma_kernel), K5 (the fused GEGLU projection,
   geglu_wgmma_kernel), P1 (the matmul probe's product, mm_wgmma_kernel;
   K5 and P1 on the GEMM mainloop of csrc/sm90_gemm.cuh) and P2-P6 (the
   attention probes' no-max attention and the softmax probes' recipes,
   attn_nomax_wgmma_kernel) from the sources in the checkout, one nvcc per
   source, in parallel, with what ptxas reports per kernel instance
   (registers, shared memory, spills, whether it serialized the wgmma
   products, whether it ignored setmaxnreg; a spill, a serialization or an
   ignored setmaxnreg fails), for each instance of attn_nomax_wgmma_kernel
   the registers its setmaxnreg asks for per role (the source's constants,
   taken where ptxas does not report setmaxnreg ignored), its K/V ring and
   its shared memory (from the library's plan), and the dynamic shared
   memory K3's launches ask for;
3. K1 against its plain PyTorch version on the card, bf16 inputs passed as
   strided column slices of one packed (B, S, 3*H*D) tensor, at the main
   path's two shapes and two edge shapes (one of them B=2, S=1000: a
   ragged last tile in each batch), with timings of K1, the plain version
   and, as a yardstick, F.scaled_dot_product_attention; and K4's entry
   point on head-split views of the same tensors timed around K1 in one
   call (K4, K1, K1, K4): both must run attn_fwd_wgmma_kernel alone;
3b. K1's row log-sum-exp and K3 against their plain versions at the
   training shapes (512² and 1024²) and two edge shapes, K3 twice on the
   same inputs (bit-identical or fail), with timings of K1 with its lse
   (training's forward), K3 (in total and per kernel), the plain backward
   and, as a yardstick, F.scaled_dot_product_attention's forward and
   backward;
3c. K4 against its plain version at the four self-attention shapes of the
   SD1.5 UNet at 512² (head dims 40, 80, 160) and at an odd length, on
   contiguous (B, H, S, D) tensors and on strided views of one packed
   to_qkv tensor, with timings of K4, the plain version and SDPA, and K4 at
   d=64 on the first shape's sequence (what d=40's narrower head saves);
3d. K2 against its plain version at every cross-attention shape of both
   UNets (77 text keys; 4, 16 and 257 IP keys; ip_scale 0; an odd length),
   k and v as views of one packed to_kv tensor, with timings of K2, the
   plain version and, as a yardstick, SDPA on the text branch plus SDPA on
   the IP branch; at every IP shape of the UNets, K2 with ip_scale 0 gives
   the text-only call's output bit for bit, and so does the weight given as
   a 0-dim fp32 tensor on the card (the kernel reads it from device memory,
   as a captured denoise step gives it), which at the shape's ip_scale
   gives the float's output bit for bit;
3e. K4's lse and K3 at head dims 40/80/160 against their plain versions at
   the SD1.5 training shapes, on views of a packed to_qkv tensor, K3 twice
   on the same inputs (bit-identical or fail), with timings of K3, the
   plain backward and SDPA's backward;
3f. with two cards or more: K1 (with its lse), K3, K4, K2, K5, P1 (both
   pairs, and bf16 with tiles split along K), P2 and P6 v0 launched on
   cuda:1 after cuda:0, each against its plain
   version (the libraries keep their state per device), then on each the
   tiny edit eagerly and through generate()'s captured programs, which are
   kept per device (as in phase 4); with one card, one line that says so;
3g. K5 against its plain version computed in fp32 from the same bf16
   inputs, with each gelu (tanh, erf, none), at the UNet feed-forward
   shapes of both families and of training (with the bias), at ragged
   M, K and inner (one with more tiles than SMs, so a CTA walks several)
   and at a long K whose tiles are split along K,
   two calls on the same inputs bit-identical, with each timed shape's
   schedule (work units, CTAs, the K split) and timings of K5, the plain
   version (cuBLAS GEMM, gelu, multiply), F.linear alone (the GEMM it
   replaces, the yardstick) and K5 with no gelu (what the epilogue costs)
   at the six inference shapes;
3h. P1 against its plain version at the matmul probe's four SDXL shapes
   and ragged M, K and N (one with more tiles than SMs), bf16 (cosine >=
   0.9999, max abs <= 1e-2 of the reference's max) and int8 (bit-exact),
   two calls on the same inputs bit-identical, with each timed shape's
   schedule, timed against torch.matmul and torch._int_mm; then the port's
   matmul probe
   (``probes/probe_pallas_matmul.py``, P1's path) once, its P1 launches
   counted;
3i. P2-P4 against their plain version (max abs <= 2e-2, cosine >= 0.9999)
   at SDXL's two self-attention shapes, every (bq, kb) tile, a ragged S,
   kv_len < S and head dims 32 and 128; P3 and P4 (every g) bit-identical
   to P2 at the same tiles, and two P2 calls on the same inputs (more work
   items than SMs at the SDXL shapes); saturated logits keep the TPU
   kernel's clamp and overflow; each timed shape's schedule (work items,
   CTAs, rings) printed; timed against the plain version, SDPA and K1 (the
   current kernel, online softmax); then the two attention probes
   (``probes/probe_attn_kblock.py``, ``probe_attn_lanegroup.py``) once,
   their launches counted;
3j. P5-P6, every softmax recipe through its entry point (``softmax_nomax``'s
   six (no_max, mxu_sum), ``softmax_tricks``' three variants) against its
   plain version (max abs <= 2e-2, cosine >= 0.9999: P2's gate, which every
   recipe meets against the TPU recipe with the row's max although the
   kernel subtracts a running one) at SDXL's two self-attention shapes, a
   ragged S and head dims 32 and 128; P6 v2 bit-identical to P5's base,
   P5's fp32 clamp recipe at P2's clamp (115) bit-identical to P2; the
   clamp recipes keep the TPU kernel's saturation and overflow at P5's clamp
   and the max-subtract ones give v; each recipe timed against its plain
   version, SDPA, K1 and P2 at the same tile; then the two softmax probes
   (``probes/probe_softmax_nomax.py``, ``probe_softmax_tricks.py``) once,
   their launches counted;
4. the tiny pipeline on the card (bf16, K1, K5) against the same weights
   on the CPU (fp32, plain versions), run as phases 5, 8 and 9 run their
   edits (``edit_modes``): twice eagerly through the module functions
   (``harmony_edit.edit``: the launch counts, and the two runs bit for
   bit), then three times through ``generate()``, whose first call
   captures the key's CUDA graphs (``pipelines/programs.py``: conditioning,
   one denoise step, decode) and whose later calls only replay them (one
   capture, then none, and no launch through a wrapper), the third under
   the profiler, whose trace must hold as many launches of each kernel,
   by name, as the eager run's wrappers counted; the replay bit-identical
   to the eager run (or, where two eager runs differ, no further from it
   than they are); each with its wall time per call and per denoise step,
   capture time, peak memory and the memory the key's programs keep;
5. the full-size SDXL QL-Edit at 1024², 30 Euler steps, random weights
   from a seed, eager and through ``generate()``'s graphs as in phase 4,
   with the K1, K2 and K5 launch counts of the eager run (2100 each, 300
   K2 with the IP branch) and of the replayed ``generate()`` (2100 each)
   checked, then one denoise step of each mode
   under the profiler (``utils/profile_edit.per_step``: kernels, kernel
   and wall ms, the device's idle share);
6. one tiny training step on the card (bf16, K1, K3 and K5) against the
   same weights and draws on the CPU (fp32, plain versions);
7. the adapter trainer at full width (``--full_random``, its defaults: 512²,
   batch 1, bf16, gradient checkpointing) for 4 steps on synthetic data,
   with the K3 launches per step checked against the count the UNet config
   gives, and the K2 and K5 launches per step (forward and recompute: 140
   each);
8. a narrow SD1.5 pipeline (head dims 40/80/160) on the card (bf16, K4,
   K5), eager and through ``generate()``'s graphs as in phase 4, the eager
   run against the same weights on the CPU (fp32, plain versions), and a
   short ``generate()`` of it with the ``resampler`` and with the
   ``mlp_proj`` head;
9. the full-width SD1.5 edit at 512², 30 Euler steps, random weights from
   a seed, eager and through ``generate()``'s graphs as in phase 4, with
   the K4, K2 and K5 launch counts of the eager run (480 each, and no K1
   launch) and of the replayed ``generate()`` (480 each) checked, then one
   denoise step of each mode under the profiler as in phase 5;
10. the full-width SD1.5 UNet at 512², batch 1, bf16, forward and backward
   to the IP projections: 16 K4, 16 K2, 16 K5 and the K3 launches the
   config gives (15), then the narrow SD1.5 UNet's IP gradients on the card
   (bf16) against the CPU (fp32).

Each timing is taken twice: as the device time of the kernels the call
launches, from the profiler's trace (``utils/profiling.kernel_ms``), and as
the median CUDA-event time of the call, which also holds the host's launch
work (for SDPA's backward, the autograd call). The line before the last is
a JSON object describing each kernel of the paths: its ``ms``, ``plain_ms``
and ``library_ms`` (SDPA; for K2 SDPA on the text branch plus SDPA on the
IP branch; for K5 F.linear alone; for P1 torch.matmul or torch._int_mm;
for P2-P6 SDPA) are device times, all taken the same way, and
``event_ms`` holds the three CUDA-event times; P2-P6 also carry
``current_ms``, K1's time on the same inputs, and P5-P6 ``p2_ms``, P2's
at the same tile, with one ``by_shape`` row per setting of the entry. A shape's ``shape`` is
(B, S, H, D), for K2 (B, Sq, H, D, IP keys) with 77 text keys, for K5
(M, K, inner), for P1 (M, K, N). The probes' launches are those of the
probe tools' run (``launches_by_path`` "probes"), where K1 (the attention
tools' current kernel) and K5 (the matmul tool's GEGLU half) are counted
too; no pipeline launches P1-P6. ``launches`` of K1, K2 and K5, and
``launches_by_path`` "generate" and "generate_sd15" (K4's ``launches``),
are those of one warm ``generate()``, the main path, which only replays
its programs: counted by kernel name in its profiler trace, since a replay
launches through no wrapper (``replay_launches``); "edit_eager" and
"edit_eager_sd15" are the wrappers' counts of the eager module functions
on the same inputs, "edit_eager_ip" K2's launches with the IP branch
there.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from imagharmony_tpu_torch.utils import profiling
from imagharmony_tpu_torch.utils.kernel_ab import K5_SHAPES, P1_SHAPES

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

SD15_SELF_ATTN_PER_UNET_CALL = 16  # SD1.5 at 512²: 5 + 5 + 5 + 1, see K4_SHAPES

MAIN_SHAPES = [(4096, 10, 64), (1024, 20, 64)]
EDGE_SHAPES = [(1000, 2, 64), (64, 4, 32)]

# K4, (B, S, H, D): the SD1.5 UNet's self-attentions at 512² with the CFG pair
# on the batch axis (5, 5, 5 and 1 per UNet call), then an odd length
K4_SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160), (2, 64, 8, 160)]
K4_EDGES = [(2, 1000, 8, 40)]
# timed beside the first shape: the same S and H at d=64, whose PV runs over
# the same one 64-column panel and whose exp2 count is the same
K4_WIDER = (2, 4096, 8, 64)

# K2, (B, Sq, H, D, Sk_ip, ip_scale), 77 text keys: the main paths' shapes
# (timed) -- SDXL at 1024² with the CFG pair on the batch axis (10 calls at
# S=4096, 60 at S=1024 per UNet call, 10 of those with the IP branch), the
# SD1.5 UNet at 512² (5, 5, 5 and 1 per UNet call, IP on all) -- then the
# Resampler's 16 and MLPProj's 257 IP keys, ip_scale 0, an odd length and
# training's batch 1
K2_SHAPES = [(2, 4096, 10, 64, 0, 1.0), (2, 1024, 20, 64, 0, 1.0), (2, 1024, 20, 64, 4, 1.0),
             (2, 4096, 8, 40, 4, 1.0), (2, 1024, 8, 80, 4, 1.0), (2, 256, 8, 160, 4, 1.0),
             (2, 64, 8, 160, 4, 1.0)]
K2_EDGES = [(2, 1024, 8, 80, 16, 0.7), (2, 256, 8, 160, 257, 0.7), (2, 1024, 8, 80, 4, 0.0),
            (2, 1000, 8, 40, 4, 0.5), (1, 256, 20, 64, 4, 1.0)]
TEXT_KEYS = 77
SDXL_CROSS_PER_UNET_CALL = 70
SDXL_IP_CROSS_PER_UNET_CALL = 10  # down_blocks.2.attentions.1: 10 blocks at S=1024

# K3 against the fp32 plain backward on the same bf16 inputs: bf16 rounding
# of P, dS and the outputs
K3_MAX_REL = 2e-2  # of the reference's max-abs, per gradient
K3_MIN_COSINE = 0.9995
# K1 rounds q*scale*log2(e) to bf16 (relative 2^-9): ~1e-2 log2 units at |s| ~ 5
LSE_MAX_ABS = 2e-2
# (B, S, H, D): 512² training (the first is K3's headline shape), then 1024²
K3_SHAPES = [(1, 1024, 10, 64), (1, 256, 20, 64), (1, 4096, 10, 64), (1, 1024, 20, 64)]
K3_EDGES = [(2, 1000, 2, 64), (2, 64, 4, 32)]
# K3 on K4's layout: the SD1.5 UNet's self-attentions at 512², batch 1, then
# an odd length
K3_BHSD_SHAPES = [(1, 4096, 8, 40), (1, 1024, 8, 80), (1, 256, 8, 160), (1, 64, 8, 160)]
K3_BHSD_EDGES = [(2, 1000, 2, 40)]
# tiny training step, bf16 on the card vs fp32 on the CPU
TRAIN_MAX_LOSS_REL = 2e-2
TRAIN_MIN_GRAD_COSINE = 0.99
TRAIN_STEPS = 4

# the device kernel behind K1's and K4's entry points
FWD_KERNEL = "attn_fwd_wgmma_kernel"
CROSS_KERNEL = "cross_attn_wgmma_kernel"

# K5, (M, K, inner): timed at kernel_ab.K5_SHAPES, the SDXL and SD1.5
# inference shapes; checked also: training at 512², batch 1 (10 and 60 per
# forward), ragged M, K and inner (the second with more tiles than SMs), and
# K5_SPLIT, a long K whose tiles the tanh and no-gelu forms split along K
# (the erf form keeps 64-column tiles whole there)
K5_SPLIT = (2048, 5120, 1280)
K5_EDGES = [(1024, 640, 2560), (256, 1280, 5120), (300, 200, 456), (4000, 200, 4104),
            K5_SPLIT]
# K5 against the fp32 plain version on the same bf16 inputs: the bf16
# rounding of the output (2^-9 of its magnitude) and K5's tanh.approx
K5_MAX_REL = 1e-2  # of the reference's max-abs
K5_MIN_COSINE = 0.9999
GEGLU_KERNEL = "geglu_wgmma_kernel"

# the edit's kernels, each under the device kernel's name its launches
# carry in a profiler trace (K1 and K4 launch one device kernel)
PATH_KERNELS = {"K1/K4": FWD_KERNEL, "K2": CROSS_KERNEL, "K5": GEGLU_KERNEL}

# P1, (M, K, N): timed at kernel_ab.P1_SHAPES, the matmul probe's SDXL
# feed-forward products, in both pairs, of which P1_SPLIT's tiles are split
# along K; then ragged M, K and N for each pair (int8 rows are whole 16-byte
# units, so its K and N are multiples of 16), the last with more tiles than
# SMs
P1_SPLIT = (2048, 5120, 1280)
P1_EDGES = [("bf16", (300, 144, 200)), ("int8", (300, 144, 208)), ("bf16", (4000, 208, 4112)),
            ("int8", (4000, 208, 4112))]
# P1 bf16 against the fp32 product of the same bf16 inputs: the bf16
# rounding of the output; int8 is exact
P1_MAX_REL = 1e-2  # of the reference's max-abs
P1_MIN_COSINE = 0.9999
MM_KERNEL = "mm_wgmma_kernel"

# P2-P4, (B, S, H, D, kv_len or None): SDXL's two self-attention shapes at
# 1024² (timed), a ragged S, kv_len < S, and head dims 32 and 128
P2_SHAPES = [(2, 4096, 10, 64, None), (2, 1024, 20, 64, None)]
P2_EDGES = [(2, 333, 4, 64, None), (2, 1024, 20, 64, 777), (1, 300, 2, 32, 211),
            (2, 200, 2, 128, 129)]
# against the fp32 plain version on the same bf16 inputs: the bf16
# rounding of qs, of e before PV and of the output, as for K1
P2_MAX_ABS = 2e-2
P2_MIN_COSINE = 0.9999
NOMAX_KERNEL = "attn_nomax_wgmma_kernel"

# P5-P6, (B, S, H, D): SDXL's two self-attention shapes at 1024² (timed), a
# ragged S, and head dims 32 and 128; each recipe against its plain version
# under P2's gate (the plain version is the TPU recipe with the row's max,
# the kernel streams the keys with a running max: its bf16 argument differs
# from the plain one by a rounding, inside the gate)
P5_SHAPES = [shape[:4] for shape in P2_SHAPES]
P5_EDGES = [(2, 333, 4, 64), (1, 300, 2, 32), (2, 200, 2, 128)]

# one H100 SXM (NVIDIA's data sheet): dense bf16 and int8 tensor-core rates,
# HBM rate
PEAK_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def _device_ms(fn, names=()):
    """Device ms per call of ``fn`` (in total and per named kernel); fails
    where no two profiler traces in a row agree on its kernels."""
    ms = profiling.kernel_ms(fn, names)
    if ms["total"] is None:
        raise RuntimeError("the profiler's traces give no kernel time on the card")
    return ms


def _timings(fns, names=()):
    """{key: (device ms, CUDA-event ms)} of each callable in ``fns``; the
    device time of "kernel" also per kernel in ``names``."""
    out = {}
    for key, fn in fns.items():
        dev = _device_ms(fn, names if key == "kernel" else ())
        out[key] = (dev.pop("total"), profiling.event_ms(fn))
        if key == "kernel":
            out["per_kernel"] = dev
    return out


def _fmt(t):
    return f"{t[0]:.4f} ms (event {t[1]:.4f})"


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
    try:
        import triton

        has_triton = f"imports (version {triton.__version__})"
    except ImportError as exc:
        has_triton = f"does not import ({exc})"
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}; triton {has_triton}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _nomax_roles(pa, kernel):
    """For an instance of the no-max kernel (``NOMAX_KERNEL<D, NWG, BN, R>``
    in ptxas's report), the registers its setmaxnreg asks for per role, its
    ring and its shared memory, from the library's plan; "" for other
    kernels."""
    if not kernel.startswith(NOMAX_KERNEL + "<"):
        return ""
    d, nwg, bn, recipe = (int(x) for x in kernel[len(NOMAX_KERNEL) + 1:-1].split(","))
    q = torch.empty((1, 64 * nwg, d), device="cuda", dtype=torch.bfloat16)
    p = pa.plan(q, d, 64 * nwg, bn, recipe=recipe)
    return (f"; {p['threads']} threads, setmaxnreg asks for {p['producer_regs']} registers a "
            f"producer thread and {p['consumer_regs']} a consumer thread, {p['rings']} ring(s) "
            f"of {p['stages']} K and V stages, {p['smem_bytes']} B dynamic shared memory")


def _nomax_sched(p):
    """A no-max schedule (``probe_attention.plan``) in one phrase."""
    return (f"{p['items']} work items of {p['units_per_item']} unit(s) on {p['grid']} CTAs "
            f"({p['rings']} ring(s) a CTA, {p['items'] / (p['grid'] * p['rings']):.2f} items a "
            f"ring)")


def phase_build(fa, ca, kg, pm, pa, build):
    """Builds the kernels and, beside them, asks ptxas what each uses."""
    sources = ("flash_attn_nhd", "flash_attn_nhd_bwd", "cross_attn_nhd", "geglu", "probe_mm",
               "probe_attn")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(12) as pool:
        builds = [pool.submit(fa._entry), pool.submit(fa._bwd_entry), pool.submit(ca._entry),
                  pool.submit(kg._entry), pool.submit(pm._entry), pool.submit(pa._entry)]
        usage = [pool.submit(build.resource_usage, name) for name in sources]
        for f in builds:
            f.result()
        fa._bhsd_entry()  # K4: the second entry point of K1's library
        fa._bhsd_bwd_entry()  # K3 on K4's layout
        print(f"phase 2 build K1/K4, K3, K2, K5, P1 and P2-P6 (in parallel): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        spilled, serialized, ignored = [], [], []
        for name, f in zip(sources, usage):
            for kernel, u in sorted(f.result().items()):
                print(f"phase 2 ptxas {name}.cu {kernel}: {u['registers']} registers, "
                      f"{u['smem_bytes']} B shared memory, {u['spill_bytes']} B spilled, wgmma "
                      f"serialized {u['wgmma_serialized']}, setmaxnreg ignored "
                      f"{u.get('setmaxnreg_ignored', False)}{_nomax_roles(pa, kernel)}",
                      flush=True)
                spilled += [kernel] if u["spill_bytes"] else []
                serialized += [kernel] if u["wgmma_serialized"] else []
                ignored += [kernel] if u.get("setmaxnreg_ignored") else []
    for d in fa.BWD_HEAD_DIMS:
        dyn = fa.bwd_smem_bytes(d)
        print(f"phase 2 K3 d={d}: dynamic shared memory per launch "
              + ", ".join(f"{k} {v} B" for k, v in dyn.items()), flush=True)
    if spilled:
        raise AssertionError(f"a kernel spills registers: {spilled}")
    if serialized:
        # ptxas made the products wait for each other (C7515, C7511): right, but slow
        raise AssertionError(f"ptxas serialized the wgmma products of: {serialized}")
    if ignored:
        # the producer keeps its registers and the consumers get none more:
        # right, but the accumulators spill or the design's point is lost
        raise AssertionError(f"ptxas ignored setmaxnreg in: {ignored}")


def _bound(flops, nbytes, peak_ops=PEAK_FLOPS):
    """(least ms, "operations" or "bytes") at the card's peak rates."""
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mm_bound(m, k, n, pair):
    # x and W read once and the output written once; 2 m k n operations at
    # the pair's tensor-core rate (bf16 out, or int32 out from int8 in)
    if pair == "bf16":
        return _bound(2 * m * k * n, 2 * (m * k + k * n + m * n))
    return _bound(2 * m * k * n, m * k + k * n + 4 * m * n, PEAK_INT8_OPS)


def fwd_bound(b, s, h, d):
    # K1 and K4: q, k, v read once and out written once, bf16; QK^T and PV
    return _bound(4 * b * h * s * s * d, 2 * 4 * b * s * h * d)


def k3_bound(b, s, h, d):
    # q, k, v, out, dout and the fp32 lse read once, dq, dk, dv written
    # once; S, dP, dV, dQ, dK
    return _bound(10 * b * h * s * s * d, 2 * 8 * b * s * h * d + 4 * b * h * s)


def geglu_bound(m, k, inner):
    # x, W and the bias read once and the output written once, bf16; the
    # products of x with the 2*inner rows of W
    return _bound(2 * m * k * 2 * inner, 2 * (m * k + 2 * inner * (k + 1) + m * inner))


def k2_bound(b, sq, h, d, sk_ip):
    # q, k, v, k_ip, v_ip read once and out written once, bf16; QK^T and PV
    # over the text and the IP keys
    keys = TEXT_KEYS + sk_ip
    return _bound(4 * b * h * sq * keys * d, 2 * b * h * d * (2 * sq + 2 * keys))


@torch.inference_mode()
def phase_k1(fa, split_heads):
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
            # the yardstick: one PyTorch call for the same function on the
            # same tensors viewed (B, H, S, D); the port never calls it
            qh, kh, vh = (x.view(2, s, h, d).transpose(1, 2) for x in (q, k, v))

            def k1():
                return fa.flash_attention_nhd(q, k, v, scale=scale, head_dim=d)

            def k4():  # K4's entry point on head-split views of the same tensors
                return fa.flash_attention(*(split_heads(x, h) for x in (q, k, v)), scale=scale)

            def wgmma_only(fn):  # device ms of fn, which must all be K1's device kernel
                ms = _device_ms(fn, (FWD_KERNEL,))
                if ms[FWD_KERNEL] is None or ms[FWD_KERNEL] != ms["total"]:
                    raise AssertionError(f"not {FWD_KERNEL} alone: {ms}")
                return ms["total"]

            via_k4 = [wgmma_only(k4)]
            t = _timings({
                "kernel": k1,
                "plain": lambda: fa.flash_attention_nhd_plain(q, k, v, scale=scale, head_dim=d),
                "library": lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh),
            })
            again = wgmma_only(k1)
            via_k4.append(wgmma_only(k4))
            t["via_k4"] = statistics.mean(via_k4)
            main_ms[(s, h, d)] = t
            print(f"phase 3 time S={s} H={h} D={d}, device (CUDA event): K1 "
                  f"{_fmt(t['kernel'])}, plain {_fmt(t['plain'])}, SDPA {_fmt(t['library'])}; "
                  f"device, in turn, {FWD_KERNEL} alone: K4 on head-split views {via_k4[0]:.4f}, "
                  f"K1 {t['kernel'][0]:.4f}, K1 {again:.4f}, K4 on head-split views "
                  f"{via_k4[1]:.4f} ms", flush=True)
    return max_err, main_ms


def phase_k3(fa):
    """K1's lse and K3 against their plain versions, and their timings."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err, times, fwd_times = 0.0, {}, {}
    for b, s, h, d in K3_SHAPES + K3_EDGES:
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        dout = torch.randn((b, s, h * d), generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(scale=d**-0.5, head_dim=d)
        out, lse = fa.flash_attention_nhd_fwd(q, k, v, **kw)
        grads = fa.flash_attention_nhd_bwd(q, k, v, out, lse, dout, **kw)
        again = fa.flash_attention_nhd_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        f32 = [x.float() for x in (q, k, v, dout)]
        lse_err = float((lse - fa.lse_plain(f32[0], f32[1], **kw)).abs().max())
        msg = [f"lse max_abs={lse_err:.3e}", f"two calls bit-identical {same}"]
        ok = lse_err <= LSE_MAX_ABS and same
        for name, g, r in zip(("dq", "dk", "dv"), grads, fa.flash_attention_nhd_bwd_plain(*f32, **kw)):
            err, cos, ref_max = float((g.float() - r).abs().max()), _cosine(g.float(), r), \
                float(r.abs().max())
            msg.append(f"{name} max_abs={err:.3e} (ref max {ref_max:.3e}) cosine={cos:.7f}")
            ok = ok and err <= K3_MAX_REL * ref_max and cos >= K3_MIN_COSINE
            max_err = max(max_err, err)
        print(f"phase 3b K3 B={b} S={s} H={h} D={d}: " + ", ".join(msg), flush=True)
        if not ok:
            raise AssertionError(f"K1's lse or K3 disagrees with the plain version at "
                                 f"B={b} S={s} H={h} D={d}")
        if (b, s, h, d) not in K3_SHAPES:
            continue
        # K1 with and without its lse output, same inputs, alternated
        k1 = [profiling.event_ms(lambda: fa.flash_attention_nhd(q, k, v, **kw)),
              profiling.event_ms(lambda: fa.flash_attention_nhd_fwd(q, k, v, **kw)),
              profiling.event_ms(lambda: fa.flash_attention_nhd(q, k, v, **kw))]
        # the yardstick: one PyTorch call for the same function on the same
        # tensors viewed (B, H, S, D); the port never calls it
        qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v))
        sdpa_fwd = profiling.event_ms(lambda: sdpa(qh, kh, vh))
        # K1 as training runs it: with its lse (the table's K1 training rows)
        fwd = _timings({
            "kernel": lambda: fa.flash_attention_nhd_fwd(q, k, v, **kw),
            "plain": lambda: (fa.flash_attention_nhd_plain(q, k, v, **kw),
                              fa.lse_plain(q, k, **kw)),
            "library": lambda: sdpa(qh, kh, vh),
        })
        fb = fwd_bound(b, s, h, d)
        fwd_times[(b, s, h, d)] = dict(fwd, bound=fb)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
            o = sdpa(*leaves)
            doh = dout.view(b, s, h, d).transpose(1, 2)
            t = _timings({
                "kernel": lambda: fa.flash_attention_nhd_bwd(q, k, v, out, lse, dout, **kw),
                "plain": lambda: fa.flash_attention_nhd_bwd_plain(q, k, v, dout, **kw),
                "library": lambda: torch.autograd.grad(o, leaves, doh, retain_graph=True),
            }, profiling.K3_KERNELS)
        bound, by = k3_bound(b, s, h, d)
        times[(b, s, h, d)] = dict(t, bound=(bound, by))
        kern = ", ".join(f"{n} {v:.4f}" if v else f"{n} not measured"
                         for n, v in t["per_kernel"].items())
        print(f"phase 3b time B={b} S={s} H={h} D={d}, device (CUDA event): K3 "
              f"{_fmt(t['kernel'])} ({kern}), plain backward {_fmt(t['plain'])}, SDPA "
              f"backward {_fmt(t['library'])}; CUDA event: K1 {k1[0]:.4f} / with lse "
              f"{k1[1]:.4f} / {k1[2]:.4f} ms, SDPA forward {sdpa_fwd:.4f} ms; K3 bound "
              f"{bound:.4f} ms ({by}); K1 with lse, device (CUDA event): "
              f"{_fmt(fwd['kernel'])}, plain {_fmt(fwd['plain'])}, SDPA forward "
              f"{_fmt(fwd['library'])}, bound {fb[0]:.4f} ms ({fb[1]})", flush=True)
    return max_err, times, fwd_times


@torch.inference_mode()
def phase_k4(fa):
    """K4 against its plain version, contiguous and as views of a packed
    to_qkv tensor, and its timings on the packed views (what the UNet hands
    it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err, times = 0.0, {}
    for b, s, h, d in K4_SHAPES + K4_EDGES:
        scale = d**-0.5
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        views = tuple(x.view(b, s, h, d).transpose(1, 2) for x in qkv.chunk(3, dim=-1))
        for layout, (q, k, v) in (("packed views", views),
                                  ("contiguous", tuple(x.contiguous() for x in views))):
            out = fa.flash_attention(q, k, v, scale=scale)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), scale=scale)
            err, cos = float((out.float() - ref).abs().max()), _cosine(out.float(), ref)
            print(f"phase 3c K4 B={b} S={s} H={h} D={d} {layout}: max_abs={err:.3e} "
                  f"cosine={cos:.7f}", flush=True)
            if not (err <= K1_MAX_ABS and cos >= K1_MIN_COSINE):
                raise AssertionError(f"K4 disagrees with its plain version at B={b} S={s} "
                                     f"H={h} D={d} ({layout})")
            max_err = max(max_err, err)
        if (b, s, h, d) not in K4_SHAPES:
            continue
        q, k, v = views
        t = _timings({
            "kernel": lambda: fa.flash_attention(q, k, v, scale=scale),
            "plain": lambda: fa.flash_attention_plain(q, k, v, scale=scale),
            "library": lambda: sdpa(q, k, v),
        })
        bound, by = fwd_bound(b, s, h, d)
        times[(b, s, h, d)] = dict(t, bound=(bound, by))
        print(f"phase 3c time B={b} S={s} H={h} D={d}, device (CUDA event): K4 "
              f"{_fmt(t['kernel'])}, plain {_fmt(t['plain'])}, SDPA {_fmt(t['library'])}; "
              f"bound {bound:.5f} ms ({by})", flush=True)
    b, s, h, d = K4_WIDER
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    narrow = [x[..., :K4_SHAPES[0][3]].contiguous() for x in (q, k, v)]
    ms = [_device_ms(lambda: fa.flash_attention(*narrow, scale=d**-0.5))["total"],
          _device_ms(lambda: fa.flash_attention(q, k, v, scale=d**-0.5))["total"],
          _device_ms(lambda: fa.flash_attention(*narrow, scale=d**-0.5))["total"]]
    print(f"phase 3c time B={b} S={s} H={h}, contiguous, device, in turn: D={K4_SHAPES[0][3]} "
          f"{ms[0]:.4f}, D={d} {ms[1]:.4f}, D={K4_SHAPES[0][3]} {ms[2]:.4f} ms", flush=True)
    return max_err, times


@torch.inference_mode()
def phase_k2(ca):
    """K2 against its plain version, k and v as views of a packed to_kv
    tensor (what the UNet hands it), and its timings at the main paths'
    shapes."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(4)
    max_err, times = 0.0, {}
    for b, sq, h, d, sk_ip, ip_scale in K2_SHAPES + K2_EDGES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

        q = rnd(b, sq, h * d)
        k, v = rnd(b, TEXT_KEYS, 2 * h * d).chunk(2, dim=-1)
        k_ip, v_ip = (rnd(b, sk_ip, h * d), rnd(b, sk_ip, h * d)) if sk_ip else (None, None)
        kw = dict(scale=d**-0.5, head_dim=d, k_ip=k_ip, v_ip=v_ip, ip_scale=ip_scale)
        out = ca.flash_cross_nhd(q, k, v, **kw)
        torch.cuda.synchronize()
        f32 = [None if x is None else x.float() for x in (q, k, v, k_ip, v_ip)]
        ref = ca.flash_cross_nhd_plain(*f32[:3], scale=d**-0.5, head_dim=d, k_ip=f32[3],
                                       v_ip=f32[4], ip_scale=ip_scale)
        err, cos = float((out.float() - ref).abs().max()), _cosine(out.float(), ref)
        label = f"B={b} Sq={sq} H={h} D={d} IP keys={sk_ip} ip_scale={ip_scale}"
        same = "-"
        if sk_ip and (b, sq, h, d, sk_ip, ip_scale) in K2_SHAPES:
            # ip_scale 0 adds exactly 0: the text-only call's output, bit for bit
            zero = ca.flash_cross_nhd(q, k, v, **dict(kw, ip_scale=0.0))
            text = ca.flash_cross_nhd(q, k, v, **dict(kw, k_ip=None, v_ip=None))
            # the weight as a 0-dim fp32 tensor on the card, as the captured
            # denoise step gives it: 0.0 is the text branch, ip_scale the float's
            table = torch.tensor([0.0, ip_scale], device="cuda")
            zero_t = ca.flash_cross_nhd(q, k, v, **dict(kw, ip_scale=table[0]))
            live_t = ca.flash_cross_nhd(q, k, v, **dict(kw, ip_scale=table[1]))
            torch.cuda.synchronize()
            same = (torch.equal(zero, text) and torch.equal(zero_t, text)
                    and torch.equal(live_t, out))
        print(f"phase 3d K2 {label}: max_abs={err:.3e} cosine={cos:.7f}, ip_scale 0 bit-identical "
              f"to text only and a device-tensor weight to the float {same}", flush=True)
        if not (err <= K1_MAX_ABS and cos >= K1_MIN_COSINE and same is not False):
            raise AssertionError(f"K2 disagrees with its plain version at {label}")
        max_err = max(max_err, err)
        if (b, sq, h, d, sk_ip, ip_scale) not in K2_SHAPES:
            continue
        # the yardstick: SDPA on each branch, on (B, H, S, D) views of the
        # same tensors; the port never calls it
        heads = [x if x is None else x.view(b, -1, h, d).transpose(1, 2)
                 for x in (q, k, v, k_ip, v_ip)]

        def library():
            sdpa(*heads[:3])
            if sk_ip:
                sdpa(heads[0], heads[3], heads[4])

        t = _timings({
            "kernel": lambda: ca.flash_cross_nhd(q, k, v, **kw),
            "plain": lambda: ca.flash_cross_nhd_plain(q, k, v, **kw),
            "library": library,
        })
        bound, by = k2_bound(b, sq, h, d, sk_ip)
        times[(b, sq, h, d, sk_ip)] = dict(t, bound=(bound, by))
        print(f"phase 3d time {label}, device (CUDA event): K2 {_fmt(t['kernel'])}, plain "
              f"{_fmt(t['plain'])}, SDPA text + IP {_fmt(t['library'])}; bound {bound:.5f} ms "
              f"({by})", flush=True)
    return max_err, times


def phase_k3_bhsd(fa, split_heads):
    """K4's lse and K3 on K4's layout against their plain versions, on views
    of a packed to_qkv tensor, and their timings at the SD1.5 training
    shapes."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(5)
    max_err, times = 0.0, {}
    for b, s, h, d in K3_BHSD_SHAPES + K3_BHSD_EDGES:
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (split_heads(x, h) for x in qkv.chunk(3, dim=-1))
        dout = torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        scale = d**-0.5
        out, lse = fa.flash_attention_fwd(q, k, v, scale=scale)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, scale=scale)
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, scale=scale)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        f32 = [x.float() for x in (q, k, v, dout)]
        logits = f32[0] @ f32[1].transpose(-1, -2) * scale
        ref_lse = torch.logsumexp(logits, dim=-1) * 1.4426950408889634  # log2 domain
        lse_err = float((lse - ref_lse).abs().max())
        msg = [f"lse max_abs={lse_err:.3e}", f"two calls bit-identical {same}"]
        ok = lse_err <= LSE_MAX_ABS and same
        refs = fa.flash_attention_bwd_plain(*f32, scale=scale)
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            err, cos, ref_max = float((g.float() - r).abs().max()), _cosine(g.float(), r), \
                float(r.abs().max())
            msg.append(f"{name} max_abs={err:.3e} (ref max {ref_max:.3e}) cosine={cos:.7f}")
            ok = ok and err <= K3_MAX_REL * ref_max and cos >= K3_MIN_COSINE
            max_err = max(max_err, err)
        print(f"phase 3e K3 B={b} S={s} H={h} D={d}: " + ", ".join(msg), flush=True)
        if not ok:
            raise AssertionError(f"K4's lse or K3 disagrees with the plain version at "
                                 f"B={b} S={s} H={h} D={d}")
        if (b, s, h, d) not in K3_BHSD_SHAPES:
            continue
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            o = sdpa(*leaves)
            t = _timings({
                "kernel": lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, scale=scale),
                "plain": lambda: fa.flash_attention_bwd_plain(q, k, v, dout, scale=scale),
                "library": lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
            }, profiling.K3_KERNELS)
        bound, by = k3_bound(b, s, h, d)
        times[(b, s, h, d)] = dict(t, bound=(bound, by))
        kern = ", ".join(f"{n} {v:.4f}" if v else f"{n} not measured"
                         for n, v in t["per_kernel"].items())
        print(f"phase 3e time B={b} S={s} H={h} D={d}, device (CUDA event): K3 "
              f"{_fmt(t['kernel'])} ({kern}), plain backward {_fmt(t['plain'])}, SDPA "
              f"backward {_fmt(t['library'])}; bound {bound:.5f} ms ({by})", flush=True)
    return max_err, times


def _sched(s):
    """A K5 or P1 schedule (``gemm.describe``) in one phrase."""
    split = (f"{s['split_tiles']} split into {s['chunks']} K chunks "
             f"({s['workspace_bytes'] / 2**20:.1f} MiB of partials)"
             if s["split_tiles"] else "none split")
    return (f"schedule: {s['units']} work units on {s['grid']} CTAs, tiles 128x{s['bn']} "
            f"({s['tiles_m']}x{s['tiles_n']}, {s['k_panels']} K panels), {s['whole_tiles']} "
            f"whole, {split}")


def _alone(t, name):
    """Fails unless the timed kernel call launched ``name`` alone."""
    if t["per_kernel"][name] != t["kernel"][0]:
        raise AssertionError(f"the call is not {name} alone: {t['per_kernel']}, {t['kernel']}")


@torch.inference_mode()
def phase_k5(kg):
    """K5 against its plain version with each gelu, and its timings at the
    inference shapes; each timed K5 call must be geglu_wgmma_kernel alone."""
    linear = torch.nn.functional.linear
    gen = torch.Generator(device="cuda").manual_seed(7)
    max_err, times = 0.0, {}
    for m, k, inner in K5_SHAPES + K5_EDGES:
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

        x, w, b = rnd(m, k), rnd(2 * inner, k, scale=k**-0.5), rnd(2 * inner)
        msg, ok = [], True
        for gelu in kg.GELUS:
            out = kg.geglu(x, w, b, gelu=gelu)
            again = kg.geglu(x, w, b, gelu=gelu)
            torch.cuda.synchronize()
            ref = kg.geglu_plain(x.float(), w.float(), b.float(), gelu=gelu)
            err, cos = float((out.float() - ref).abs().max()), _cosine(out.float(), ref)
            ref_max = float(ref.abs().max())
            same = torch.equal(out, again)
            msg.append(f"{gelu} max_abs={err:.3e} (ref max {ref_max:.3e}) cosine={cos:.7f} "
                       f"bit-identical {same}")
            ok = ok and err <= K5_MAX_REL * ref_max and cos >= K5_MIN_COSINE and same
            max_err = max(max_err, err)
        sched = kg.plan(x, w, gelu="tanh")
        print(f"phase 3g K5 M={m} K={k} inner={inner}: " + ", ".join(msg) + "; " + _sched(sched),
              flush=True)
        if (m, k, inner) == K5_SPLIT and not sched["split_tiles"]:
            raise AssertionError(f"K5 split no tile along K at {K5_SPLIT}: {sched}")
        if not ok:
            raise AssertionError(f"K5 disagrees with its plain version at M={m} K={k} "
                                 f"inner={inner}")
        if (m, k, inner) not in K5_SHAPES:
            continue
        t = _timings({
            "kernel": lambda: kg.geglu(x, w, b, gelu="tanh"),
            "plain": lambda: kg.geglu_plain(x, w, b, gelu="tanh"),
            # the yardstick: the GEMM K5 replaces, alone; the port never calls it
            "library": lambda: linear(x, w, b),
            "no_gelu": lambda: kg.geglu(x, w, b, gelu="none"),
        }, (GEGLU_KERNEL,))
        _alone(t, GEGLU_KERNEL)
        bound, by = geglu_bound(m, k, inner)
        times[(m, k, inner)] = dict(t, bound=(bound, by), schedule=sched)
        print(f"phase 3g time M={m} K={k} inner={inner}, device (CUDA event): K5 "
              f"{_fmt(t['kernel'])}, plain {_fmt(t['plain'])}, F.linear alone "
              f"{_fmt(t['library'])}, K5 with no gelu {_fmt(t['no_gelu'])}; bound "
              f"{bound:.5f} ms ({by}), {bound / t['kernel'][0]:.1%} of it", flush=True)
    return max_err, times


@torch.inference_mode()
def phase_p1(pm):
    """P1 against its plain version in both pairs (bf16 within tolerance,
    int8 bit for bit), its timings at the probe's four shapes against
    torch.matmul and torch._int_mm, each timed call mm_wgmma_kernel alone."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    max_err, times = 0.0, {}
    cases = [(pair, shape) for shape in P1_SHAPES for pair in ("bf16", "int8")]
    for pair, shape in cases + P1_EDGES:
        m, k, n = shape
        if pair == "bf16":
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            w = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
            out_dtype, library = torch.bfloat16, torch.matmul
            out = pm.probe_mm(x, w, out_dtype=out_dtype)
            torch.cuda.synchronize()
            ref = pm.probe_mm_plain(x, w, out_dtype=torch.float32)
            err, cos = float((out.float() - ref).abs().max()), _cosine(out.float(), ref)
            ref_max = float(ref.abs().max())
            ok = err <= P1_MAX_REL * ref_max and cos >= P1_MIN_COSINE
            msg = f"max_abs={err:.3e} (ref max {ref_max:.3e}) cosine={cos:.7f}"
            max_err = max(max_err, err)
        else:
            x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
            w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
            out_dtype, library = torch.int32, torch._int_mm
            out = pm.probe_mm(x, w, out_dtype=out_dtype)
            torch.cuda.synchronize()
            ok = torch.equal(out, pm.probe_mm_plain(x, w, out_dtype=out_dtype))
            msg = f"bit-exact {ok}"
        same = torch.equal(out, pm.probe_mm(x, w, out_dtype=out_dtype))
        ok = ok and same
        sched = pm.plan(x, w, out_dtype=out_dtype)
        print(f"phase 3h P1 {pair} M={m} K={k} N={n}: {msg}, bit-identical {same}; "
              f"{_sched(sched)}", flush=True)
        if shape == P1_SPLIT and not sched["split_tiles"]:
            raise AssertionError(f"P1 {pair} split no tile along K at {P1_SPLIT}: {sched}")
        if not ok:
            raise AssertionError(f"P1 {pair} disagrees with its plain version at {shape}")
        if shape not in P1_SHAPES:
            continue
        t = _timings({
            "kernel": lambda: pm.probe_mm(x, w, out_dtype=out_dtype),
            "plain": lambda: pm.probe_mm_plain(x, w, out_dtype=out_dtype),
            # the yardstick; the port never calls it
            "library": lambda: library(x, w),
        }, (MM_KERNEL,))
        _alone(t, MM_KERNEL)
        bound, by = mm_bound(m, k, n, pair)
        times[(pair, shape)] = dict(t, bound=(bound, by), schedule=sched)
        lib = "torch.matmul" if pair == "bf16" else "torch._int_mm"
        print(f"phase 3h time {pair} M={m} K={k} N={n}, device (CUDA event): P1 "
              f"{_fmt(t['kernel'])}, plain {_fmt(t['plain'])}, {lib} {_fmt(t['library'])}; "
              f"bound {bound:.5f} ms ({by}), {bound / t['kernel'][0]:.1%} of it", flush=True)
    return max_err, times


def _probe_main(name, fa, kg, pm, pa, ps):
    """Runs the port's probe tool ``name`` once on the card (its main path)
    with every count it can reach set to 0 just before; returns the
    launches it made: P1's, P2-P6's by entry point, and K1's and K5's (the
    attention tools' "current" kernel, the matmul tool's GEGLU half)."""
    import importlib

    tool = importlib.import_module(f"imagharmony_tpu_torch.probes.{name}")
    fa.launches = kg.geglu_launches = pm.launches = 0
    for counts in (pa.launches, ps.launches):
        counts.update(dict.fromkeys(counts, 0))
    t0 = time.perf_counter()
    tool.main([])
    torch.cuda.synchronize()
    launched = {"probe_mm": pm.launches, **pa.launches, **ps.launches,
                "flash_attention_nhd": fa.launches, "geglu": kg.geglu_launches}
    print(f"phase 3h-3j probe {name}: {time.perf_counter() - t0:.1f} s, launches {launched}",
          flush=True)
    return launched


@torch.inference_mode()
def phase_p2(pa, fa):
    """P2-P4 against their plain version, P3 and P4 bit for bit against P2
    at the same tiles, the clamp's overflow kept, and their timings at the
    SDXL shapes against K1 (the current kernel), the plain version and
    SDPA, each timed call attn_nomax_wgmma_kernel alone."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(9)
    max_err, times = 0.0, {}
    for b, s, h, d, kv_len in P2_SHAPES + P2_EDGES:
        q, k, v = torch.randn((b, s, 3 * h * d), generator=gen,
                              device="cuda").to(torch.bfloat16).chunk(3, dim=-1)
        scale, kb0 = d**-0.5, pa.default_kb(d)
        label = f"B={b} S={s} H={h} D={d} kv_len={kv_len or s}"
        if kv_len is None:
            runs = {f"P2 bq={bq} kb={kb}": (kb, lambda bq=bq, kb=kb: pa.kblock_attn(
                q, k, v, scale, d, bq, kb)) for bq in pa.BQS for kb in pa.kbs(d)}
        else:
            runs = {f"P4 g={d}": (kb0, lambda: pa.nhd_with_g(q, k, v, scale, d, kv_len, d))}
        msg = []
        for tag, (kb, fn) in runs.items():
            out = fn()
            torch.cuda.synchronize()
            ref = pa.nomax_attn_plain(q.float(), k.float(), v.float(), scale, d, kv_len=kv_len,
                                      kb=kb)
            err, cos = float((out.float() - ref).abs().max()), _cosine(out.float(), ref)
            msg.append(f"{tag} max_abs={err:.3e} cosine={cos:.7f}")
            if not (err <= P2_MAX_ABS and cos >= P2_MIN_COSINE):
                raise AssertionError(f"{tag} disagrees with its plain version at {label}")
            max_err = max(max_err, err)
        if kv_len is None:
            # one function under three schedules: the same bits at the same
            # tiles; and two calls on the same inputs (the persistent walk
            # deals the items to the CTAs the same way each time)
            p2 = pa.kblock_attn(q, k, v, scale, d, pa.DEFAULT_BQ, kb0)
            same = [torch.equal(pa.batchpack_attn(q, k, v, scale, d), p2)] + [
                torch.equal(pa.nhd_with_g(q, k, v, scale, d, s, g), p2)
                for g in range(d, h * d + 1, d) if (h * d) % g == 0]
            twice = torch.equal(pa.kblock_attn(q, k, v, scale, d, pa.DEFAULT_BQ, kb0), p2)
            msg.append(f"P3 and P4 (every g) bit-identical to P2 {all(same)}, two P2 calls "
                       f"bit-identical {twice}")
            if not all(same):
                raise AssertionError(f"P3 or P4 differs from P2 at {label}: {same}")
            if not twice:
                raise AssertionError(f"two P2 calls on the same inputs differ at {label}")
        print(f"phase 3i {label}: " + ", ".join(msg), flush=True)
        if (b, s, h, d, kv_len) not in P2_SHAPES:
            continue
        qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v))
        t = {}
        for entry, fn in (
                ("kblock_attn", lambda: pa.kblock_attn(q, k, v, scale, d, pa.DEFAULT_BQ, kb0)),
                ("batchpack_attn", lambda: pa.batchpack_attn(q, k, v, scale, d)),
                ("nhd_with_g", lambda: pa.nhd_with_g(q, k, v, scale, d, s, 2 * d))):
            t[entry] = _timings({
                "kernel": fn,
                "plain": lambda: pa.nomax_attn_plain(q, k, v, scale, d, kb=kb0),
                # the yardstick; the port never calls it
                "library": lambda: sdpa(qh, kh, vh),
            } if entry == "kblock_attn" else {"kernel": fn}, (NOMAX_KERNEL,))
            _alone(t[entry], NOMAX_KERNEL)
        t["tiles"] = {(bq, kb): _timings({"kernel": lambda bq=bq, kb=kb: pa.kblock_attn(
            q, k, v, scale, d, bq, kb)})["kernel"] for bq in pa.BQS for kb in pa.kbs(d)}
        t["current"] = _timings(
            {"kernel": lambda: fa.flash_attention_nhd(q, k, v, scale=scale, head_dim=d)})["kernel"]
        bound, by = fwd_bound(b, s, h, d)
        sched = {"P2": pa.plan(q, d, pa.DEFAULT_BQ, kb0),
                 "P3": pa.plan(q, d, pa.DEFAULT_BQ, kb0, batch_rows=None),
                 "P4": pa.plan(q, d, pa.DEFAULT_BQ, kb0, heads_per_cta=2)}
        print(f"phase 3i schedule {label}: " + "; ".join(f"{entry} {_nomax_sched(p)}"
                                                         for entry, p in sched.items()),
              flush=True)
        times[(b, s, h, d)] = dict(t, bound=(bound, by), schedule=sched)
        tiles = ", ".join(f"bq={bq} kb={kb} {_fmt(x)}" for (bq, kb), x in t["tiles"].items())
        print(f"phase 3i time {label}, device (CUDA event): P2 {_fmt(t['kblock_attn']['kernel'])}"
              f", P3 {_fmt(t['batchpack_attn']['kernel'])}, P4 (g={2 * d}) "
              f"{_fmt(t['nhd_with_g']['kernel'])}, plain {_fmt(t['kblock_attn']['plain'])}, SDPA "
              f"{_fmt(t['kblock_attn']['library'])}, K1 (current, online softmax) "
              f"{_fmt(t['current'])}; P2 by tile: {tiles}; bound {bound:.5f} ms ({by})",
              flush=True)

    # the clamp saturates and nothing guards the sums: 4096 keys at the clamp
    # sum to 2^127, so v = 1 gives 1 and v = 2 overflows to inf
    qc = torch.full((1, 4096, 64), 4.0, device="cuda", dtype=torch.bfloat16)
    ones = torch.ones_like(qc)
    one = torch.equal(pa.kblock_attn(qc, qc, ones, 0.125, 64, 128, 128), ones)
    inf = bool(torch.isinf(pa.kblock_attn(qc, qc, 2 * ones, 0.125, 64, 128, 128)).all())
    print(f"phase 3i saturated logits (1, 4096, 64): v=1 gives exactly 1 {one}, v=2 overflows to "
          f"inf {inf}", flush=True)
    if not (one and inf):
        raise AssertionError("P2 does not keep the TPU kernel's clamp and overflow")
    return max_err, times


def _recipe_calls(ps):
    """P5's and P6's recipes as their entry points run them: {recipe:
    (entry, its setting, call(q, k, v, scale, head_dim))}; P6 v2 is P5's
    base recipe, listed once."""
    calls = {recipe: ("softmax_nomax", f"no_max={no_max} mxu_sum={int(mxu_sum)}",
                      lambda q, k, v, s, d, n=no_max, m=mxu_sum: ps.softmax_nomax(
                          q, k, v, s, d, no_max=n, mxu_sum=m))
             for (no_max, mxu_sum), recipe in ps.NOMAX.items()}
    for variant, recipe in ps.TRICKS.items():
        calls.setdefault(recipe, ("softmax_tricks", f"v{variant}", lambda q, k, v, s, d,
                                  n=variant: ps.softmax_tricks(q, k, v, s, d, n)))
    return calls


@torch.inference_mode()
def phase_p5(ps, pa, fa):
    """P5-P6: each recipe against its plain version, P6 v2 bit for bit P5's
    base, P5's fp32 clamp recipe at P2's clamp bit for bit P2, the clamp's
    saturation and overflow kept, and each recipe's timings at the SDXL
    shapes against its plain version, SDPA, K1 (the current kernel) and P2
    at the same tile, each timed recipe attn_nomax_wgmma_kernel alone."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = _recipe_calls(ps)
    gen = torch.Generator(device="cuda").manual_seed(10)
    errs, times = dict.fromkeys(calls, 0.0), {}
    for b, s, h, d in P5_SHAPES + P5_EDGES:
        q, k, v = torch.randn((b, s, 3 * h * d), generator=gen,
                              device="cuda").to(torch.bfloat16).chunk(3, dim=-1)
        scale, label = d**-0.5, f"B={b} S={s} H={h} D={d}"
        msg = []
        for recipe, (_, setting, call) in calls.items():
            out = call(q, k, v, scale, d)
            torch.cuda.synchronize()
            ref = ps.softmax_recipe_plain(q.float(), k.float(), v.float(), scale, d,
                                          recipe=recipe)
            err, cos = float((out.float() - ref).abs().max()), _cosine(out.float(), ref)
            msg.append(f"{recipe} ({setting}) max_abs={err:.3e} cosine={cos:.7f}")
            if not (err <= P2_MAX_ABS and cos >= P2_MIN_COSINE):
                raise AssertionError(f"{recipe} disagrees with its plain version at {label}")
            errs[recipe] = max(errs[recipe], err)
        base = ps.softmax_nomax(q, k, v, scale, d, no_max=False, mxu_sum=False)
        v2_same = torch.equal(ps.softmax_tricks(q, k, v, scale, d, 2), base)
        p2 = pa.kblock_attn(q, k, v, scale, d, pa.DEFAULT_BQ, pa.default_kb(d))
        clamp, ps.CLAMP = ps.CLAMP, pa.CLAMP
        try:
            p2_same = torch.equal(ps.softmax_nomax(q, k, v, scale, d, no_max="fp32",
                                                   mxu_sum=False), p2)
        finally:
            ps.CLAMP = clamp
        msg.append(f"P6 v2 bit-identical to P5's base {v2_same}, no_max=fp32 at P2's clamp "
                   f"bit-identical to P2 {p2_same}")
        print(f"phase 3j {label}: " + ", ".join(msg), flush=True)
        if not (v2_same and p2_same):
            raise AssertionError(f"a recipe is not the function it shares at {label}")
        if (b, s, h, d) not in P5_SHAPES:
            continue
        qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v))
        t = {"library": _timings({"kernel": lambda: sdpa(qh, kh, vh)})["kernel"],
             "current": _timings({"kernel": lambda: fa.flash_attention_nhd(
                 q, k, v, scale=scale, head_dim=d)})["kernel"],
             "p2": _timings({"kernel": lambda: pa.kblock_attn(
                 q, k, v, scale, d, pa.DEFAULT_BQ, pa.default_kb(d))})["kernel"]}
        for recipe, (_, _, call) in calls.items():
            t[recipe] = _timings({
                "kernel": lambda: call(q, k, v, scale, d),
                "plain": lambda: ps.softmax_recipe_plain(q, k, v, scale, d, recipe=recipe),
            }, (NOMAX_KERNEL,))
            _alone(t[recipe], NOMAX_KERNEL)
        bound, by = fwd_bound(b, s, h, d)
        times[(b, s, h, d)] = dict(t, bound=(bound, by))
        recipes = ", ".join(f"{recipe} {_fmt(t[recipe]['kernel'])} (plain "
                            f"{_fmt(t[recipe]['plain'])})" for recipe in calls)
        print(f"phase 3j time {label}, device (CUDA event): {recipes}; SDPA "
              f"{_fmt(t['library'])}, K1 (current, online softmax) {_fmt(t['current'])}, P2 at "
              f"the same tile {_fmt(t['p2'])}; bound {bound:.5f} ms ({by})", flush=True)

    # P5's clamp saturates as P2's: 4096 keys at it sum to 2^127.4 or
    # 2^127.5 (finite), so v = 1 gives 1 and v = 2 overflows to inf; the
    # max-subtract recipes give 2
    qc = torch.full((1, 4096, 64), 4.0, device="cuda", dtype=torch.bfloat16)
    ones = torch.ones_like(qc)
    kept = {}
    for recipe, (_, _, call) in calls.items():
        two = call(qc, qc, 2 * ones, 0.125, 64)
        kept[recipe] = (torch.equal(call(qc, qc, ones, 0.125, 64), ones)
                        and bool(torch.isinf(two).all())) if recipe.startswith("clamp") \
            else torch.equal(two, 2 * ones)
    print(f"phase 3j saturated logits (1, 4096, 64), the clamp recipes v=1 gives exactly 1 and "
          f"v=2 inf, the others v=2 gives 2: {kept}", flush=True)
    if not all(kept.values()):
        raise AssertionError(f"a recipe does not keep the TPU kernel's saturation: {kept}")
    return errs, times


def _reset_launches(fa, ca, kg):
    fa.launches = fa.bhsd_launches = ca.cross_launches = ca.cross_ip_launches = 0
    kg.geglu_launches = 0


def _launches(fa, ca, kg):
    return {"K1": fa.launches, "K4": fa.bhsd_launches, "K2": ca.cross_launches,
            "K2 IP": ca.cross_ip_launches, "K5": kg.geglu_launches}


def _eager_edit(pipe, img, kw, timings=None):
    """The eager reference of generate(img, **kw): the module functions
    (``harmony_edit.edit``) on the same prepared inputs."""
    from imagharmony_tpu_torch.pipelines import harmony_edit as he

    call_kw = {k: v for k, v in kw.items() if k != "output_type"}
    with torch.inference_mode():
        clock = he.PhaseClock(timings, pipe.device, time.perf_counter())
        return he.edit(pipe.components, pipe.prepare(img, **call_kw), clock)


def _timed(fn, dev):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def replay_launches(run, label, tries=4):
    """Launches of each kernel of PATH_KERNELS in one call of ``run`` (a warm
    generate(), the card synchronized at its end), counted from zero by name
    in the profiler's trace: a replay launches through no wrapper, so no
    wrapper's count sees it. The profiler now and then loses kernel events,
    so sessions run until two in a row hold as many kernel events."""
    prev = None
    for _ in range(tries):
        _, _, kernels = profiling.profiled(run)
        if prev == len(kernels):
            return {k: sum(name in e["name"] for e in kernels) for k, name in PATH_KERNELS.items()}
        prev = len(kernels)
    raise AssertionError(f"{label}: no two profiler traces of generate() in a row agree on "
                         f"its kernels")


def edit_modes(pipe, img, kw, fa, ca, kg, label):
    """The edit generate(img, **kw) asks for, run twice eagerly through the
    module functions, then through generate() three times: the first call
    captures the key's programs (CUDA graphs, ``pipelines/programs.py``), the
    second only replays them and is timed, the third only replays them under
    the profiler, whose trace counts its launches of each kernel
    (``replay_launches``). Fails unless the first generate() captured one key
    and the later ones none and launched nothing through a kernel's wrapper,
    the replayed launches by kernel name equal the eager run's by wrapper,
    the first two generate() calls agree bit for bit, and the replay is
    bit-identical to the eager run; where the two eager runs already differ,
    the replay may differ from the first eager run by no more than they do.
    Returns the outputs, the second eager run's launch counts (each eager run
    must give the same) and the replayed generate()'s (``generate``)."""
    dev, steps = pipe.device, kw["num_inference_steps"]
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for _ in range(2):
        _reset_launches(fa, ca, kg)
        timings = {}
        out, wall = _timed(lambda: _eager_edit(pipe, img, kw, timings), dev)
        runs.append((out, wall, timings, _launches(fa, ca, kg)))
    peak_eager = torch.cuda.max_memory_allocated(dev) / 2**30
    (eager, _, _, first_counts), (eager2, eager_s, eager_t, launches) = runs
    if first_counts != launches:
        raise AssertionError(f"{label}: two eager runs launched {first_counts} and {launches}")
    eager_same = torch.equal(eager, eager2)
    eager_diff = float((eager.float() - eager2.float()).abs().max())

    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    calls = []
    for _ in range(2):
        _reset_launches(fa, ca, kg)
        before = len(pipe.programs)
        timings = {}
        out, wall = _timed(lambda: pipe.generate(img, timings=timings, **kw), dev)
        calls.append((out, wall, timings, _launches(fa, ca, kg), len(pipe.programs) - before))
        if len(calls) == 1:  # what the key's programs keep, and the call's output
            torch.cuda.empty_cache()
            kept = (torch.cuda.memory_reserved(dev) - reserved) / 2**30
    peak_graphs = torch.cuda.max_memory_allocated(dev) / 2**30
    (first, first_s, _, captured, n_first), (replay, replay_s, replay_t, replayed, n_second) = calls
    _reset_launches(fa, ca, kg)
    before = len(pipe.programs)
    graph = replay_launches(lambda: _timed(lambda: pipe.generate(img, **kw), dev), label)
    profiled, n_profiled = _launches(fa, ca, kg), len(pipe.programs) - before
    expected = {"K1/K4": launches["K1"] + launches["K4"], "K2": launches["K2"],
                "K5": launches["K5"]}
    capture_s = list(pipe.programs.values())[-1].capture_s
    replay_diff = float((replay.float() - eager.float()).abs().max())
    eager_step_ms, replay_step_ms = (t["denoise_s"] / steps * 1e3 for t in (eager_t, replay_t))
    print(f"{label} eager (module functions) vs generate() (CUDA graphs), {steps} steps: "
          f"eager {eager_s:.4f} s a call, {eager_step_ms:.3f} ms a denoise step; replayed "
          f"{replay_s:.4f} s a call, {replay_step_ms:.3f} ms a denoise step; first "
          f"generate() {first_s:.4f} s, of it capture with warm-up {capture_s:.4f} s; peak "
          f"memory allocated eager {peak_eager:.2f} GiB, with graphs {peak_graphs:.2f} GiB; "
          f"kept by the key's programs {kept:.3f} GiB (reserved after empty_cache, before "
          f"and after the capture, the call's output included); captures {n_first} then "
          f"{n_second}; two eager runs bit-identical {eager_same} (max abs {eager_diff:.3e}); "
          f"replay bit-identical to eager {torch.equal(replay, eager)} (max abs "
          f"{replay_diff:.3e}); launches eager {launches}, first generate() {captured}, "
          f"second {replayed}; replayed generate() by kernel name in its trace {graph}",
          flush=True)
    if (n_first, n_second, n_profiled) != (1, 0, 0) or any(replayed.values()) \
            or any(profiled.values()):
        raise AssertionError(f"{label}: captures {n_first}, {n_second}, {n_profiled} and "
                             f"launches {replayed}, {profiled} of the later generate() calls: "
                             f"they did not only replay")
    if graph != expected:
        raise AssertionError(f"{label}: the replayed generate() launched {graph}, the eager run "
                             f"{expected}")
    if not torch.equal(first, replay):
        raise AssertionError(f"{label}: two generate() calls differ")
    if not (torch.equal(replay, eager) if eager_same else replay_diff <= eager_diff):
        raise AssertionError(f"{label}: the replay differs from the eager run by {replay_diff} "
                             f"(two eager runs: {eager_diff})")
    if any(captured[k] != 2 * launches[k] // steps for k in launches):
        raise AssertionError(f"{label}: the first generate() launched {captured}, expected "
                             f"twice one step's of {launches}")
    return dict(eager=eager, replay=replay, launches=launches, generate=graph)


def profile_modes(pipe, img, kw, label):
    """Prints one denoise step of the eager module functions and of
    generate()'s replayed programs under the profiler
    (``utils/profile_edit.per_step``): kernels, kernel ms, wall ms and the
    device's idle share a step."""
    from imagharmony_tpu_torch.utils import profile_edit

    call_kw = {k: v for k, v in kw.items() if k not in ("num_inference_steps", "output_type")}
    runs = {"eager": lambda n: _eager_edit(pipe, img, dict(call_kw, num_inference_steps=n)),
            "replayed": lambda n: pipe.generate(img, num_inference_steps=n, output_type="raw",
                                                **call_kw)}
    for mode, run in runs.items():
        row = profile_edit.per_step(lambda n: _timed(lambda: run(n), pipe.device))
        print(f"{label} profile of one denoise step, {mode}: " + json.dumps(
            {k.replace("_per_unet_call", ""): v for k, v in row.items()}), flush=True)


def phase_second_device(fa, ca, kg, pm, pa, ps, split_heads, HarmonyPipeline):
    """Each kernel (P1 in both pairs and split along K, P2, and P6 v0 of the
    P5-P6 recipes) on cuda:0 and then on cuda:1 in this process, against
    its plain version: the libraries' shared-memory attributes, SM counts,
    thread contexts and K5's and P1's tile counters are kept per device.
    Then on each device the tiny edit eagerly and through generate()'s
    captured programs (``edit_modes``; the programs are keyed by device)."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 3f second device: skipped, {n} card", flush=True)
        return
    cpu = HarmonyPipeline.random_tiny(seed=0, device="cpu")
    img, edit_kw = _tiny_edit()
    errs = {}
    for dev in ("cuda:0", "cuda:1"):
        gen = torch.Generator(device=dev).manual_seed(6)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        q, k, v = rnd(1, 1024, 3 * 640).chunk(3, dim=-1)
        dout = rnd(1, 1024, 640)
        kw = dict(scale=0.125, head_dim=64)
        out, lse = fa.flash_attention_nhd_fwd(q, k, v, **kw)
        grads = fa.flash_attention_nhd_bwd(q, k, v, out, lse, dout, **kw)
        views = [split_heads(x, 8) for x in rnd(2, 1000, 3 * 320).chunk(3, dim=-1)]
        k4 = fa.flash_attention(*views, scale=40**-0.5)
        ckw = dict(scale=40**-0.5, head_dim=40, ip_scale=0.6)
        cq, (ck, cv), kip, vip = rnd(2, 300, 320), rnd(2, 77, 640).chunk(2, dim=-1), \
            rnd(2, 4, 320), rnd(2, 4, 320)
        k2 = ca.flash_cross_nhd(cq, ck, cv, k_ip=kip, v_ip=vip, **ckw)
        gx, gw, gb = rnd(300, 320), rnd(2 * 1280, 320), rnd(2 * 1280)
        k5 = kg.geglu(gx, gw, gb, gelu="tanh")
        mx, mw = rnd(300, 144), rnd(144, 200)
        p1 = pm.probe_mm(mx, mw, out_dtype=torch.bfloat16)
        sx, sw = rnd(*P1_SPLIT[:2]), rnd(*P1_SPLIT[1:])  # split along K: per-device counters
        if not pm.plan(sx, sw, out_dtype=torch.bfloat16)["split_tiles"]:
            raise AssertionError(f"P1 split no tile along K at {P1_SPLIT} on {dev}")
        p1s = pm.probe_mm(sx, sw, out_dtype=torch.bfloat16)
        xq, wq = (torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                  for shape in ((300, 144), (144, 208)))
        p1q = pm.probe_mm(xq, wq, out_dtype=torch.int32)
        p2 = pa.kblock_attn(q, k, v, 0.125, 64, 128, 128)
        p6 = ps.softmax_tricks(q, k, v, 0.125, 64, 0)
        torch.cuda.synchronize(dev)
        f32 = [x.float() for x in (q, k, v, dout)]
        e = {"K1": float((out.float() - fa.flash_attention_nhd_plain(*f32[:3], **kw)).abs().max()),
             "K4": float((k4.float() - fa.flash_attention_plain(
                 *(x.float() for x in views), scale=40**-0.5)).abs().max()),
             "K2": float((k2.float() - ca.flash_cross_nhd_plain(
                 cq.float(), ck.float(), cv.float(), k_ip=kip.float(), v_ip=vip.float(),
                 **ckw)).abs().max())}
        refs = fa.flash_attention_nhd_bwd_plain(*f32, **kw)
        e["K3"] = max(float((g.float() - r).abs().max()) / float(r.abs().max())
                      for g, r in zip(grads, refs))
        k5_ref = kg.geglu_plain(gx.float(), gw.float(), gb.float(), gelu="tanh")
        e["K5"] = float((k5.float() - k5_ref).abs().max()) / float(k5_ref.abs().max())
        p1_ref = pm.probe_mm_plain(mx, mw, out_dtype=torch.float32)
        e["P1"] = float((p1.float() - p1_ref).abs().max()) / float(p1_ref.abs().max())
        p1s_ref = pm.probe_mm_plain(sx, sw, out_dtype=torch.float32)
        e["P1 split"] = float((p1s.float() - p1s_ref).abs().max()) / float(p1s_ref.abs().max())
        p1q_exact = torch.equal(p1q, pm.probe_mm_plain(xq, wq, out_dtype=torch.int32))
        p2_ref = pa.nomax_attn_plain(*f32[:3], 0.125, 64, kb=128)
        e["P2"] = float((p2.float() - p2_ref).abs().max())
        p2_cos = float(torch.nn.functional.cosine_similarity(
            p2.double().flatten(), p2_ref.double().flatten(), dim=0))
        p6_ref = ps.softmax_recipe_plain(*f32[:3], 0.125, 64, recipe="norm_first")
        e["P6"] = float((p6.float() - p6_ref).abs().max())
        p6_cos = _cosine(p6.float(), p6_ref)
        errs[dev] = e
        print(f"phase 3f {dev}: max_abs K1 {e['K1']:.3e}, K4 {e['K4']:.3e}, K2 {e['K2']:.3e}, "
              f"K3 max_abs / ref max {e['K3']:.3e}, K5 max_abs / ref max {e['K5']:.3e}, "
              f"P1 bf16 max_abs / ref max {e['P1']:.3e} (split along K {e['P1 split']:.3e}), "
              f"P1 int8 bit-exact {p1q_exact}, "
              f"P2 max_abs {e['P2']:.3e} cosine {p2_cos:.6f}, P6 v0 max_abs {e['P6']:.3e} "
              f"cosine {p6_cos:.6f}", flush=True)
        if (max(e["K1"], e["K4"], e["K2"], e["P2"], e["P6"]) > K1_MAX_ABS
                or e["K3"] > K3_MAX_REL or e["K5"] > K5_MAX_REL
                or max(e["P1"], e["P1 split"]) > P1_MAX_REL
                or not p1q_exact or not min(p2_cos, p6_cos) >= K1_MIN_COSINE):
            raise AssertionError(f"a kernel disagrees with its plain version on {dev}: {e}")
        card = HarmonyPipeline(
            copy.deepcopy(cpu.components).to(device=dev, dtype=torch.bfloat16), cpu.tokenizers)
        edit_modes(card, img, edit_kw, fa, ca, kg, f"phase 3f {dev} tiny edit")


def _tiny_edit():
    """The tiny edit's image and generate() arguments (phases 3f and 4)."""
    img = np.random.default_rng(0).integers(0, 255, (48, 48, 3), dtype=np.uint8)
    noise = np.random.default_rng(1).standard_normal((1, 32, 32, 4)).astype(np.float32)
    return img, dict(prompt="a dog", extra_text="six dogs", num_inference_steps=3,
                     height=64, width=64, noise=noise, output_type="raw")


def phase_tiny(fa, ca, kg, HarmonyPipeline):
    cpu = HarmonyPipeline.random_tiny(seed=0, device="cpu")
    card = HarmonyPipeline(
        copy.deepcopy(cpu.components).to(device="cuda", dtype=torch.bfloat16), cpu.tokenizers
    )
    img, kw = _tiny_edit()
    ref = cpu.generate(img, **kw)
    r = edit_modes(card, img, kw, fa, ca, kg, "phase 4 tiny pipeline")
    out, n = r["eager"], r["launches"]
    cos = _cosine(out.float().cpu(), ref)
    print(f"phase 4 tiny pipeline card bf16 (eager) vs cpu fp32: image cosine={cos:.6f}, "
          f"K1 launches={n['K1']}, K5 launches={n['K5']}", flush=True)
    if not (torch.isfinite(out).all() and cos >= TINY_MIN_COSINE and n["K1"] > 0
            and n["K5"] > 0):
        raise AssertionError("tiny pipeline on the card disagrees with the CPU")


def phase_full(fa, ca, kg, HarmonyPipeline):
    t0 = time.perf_counter()
    pipe = HarmonyPipeline.random_full(seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.components.parameters())
    print(f"phase 5 built random_full: {n_params / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    img = np.random.default_rng(0).integers(0, 255, (1024, 1024, 3), dtype=np.uint8)
    kw = dict(prompt="a photo of six sheep on a meadow", extra_text="six sheep", num_samples=1,
              seed=0, num_inference_steps=FULL_STEPS, guidance_scale=5.0, output_type="raw")
    r = edit_modes(pipe, img, kw, fa, ca, kg, "phase 5 SDXL 1024²")
    out, n, g = r["replay"], r["launches"], r["generate"]
    finite = bool(torch.isfinite(out).all())
    launches, k2, k5 = n["K1"], (n["K2"], n["K2 IP"]), n["K5"]
    print(f"phase 5 generate 1024² {FULL_STEPS} steps: replayed K1 launches {g['K1/K4']}, K2 "
          f"{g['K2']}, K5 {g['K5']}; eager K1 {launches}, K2 {k2[0]} ({k2[1]} with the IP "
          f"branch), K5 {k5}; shape {tuple(out.shape)}, finite {finite}", flush=True)
    expected = SELF_ATTN_PER_UNET_CALL * FULL_STEPS  # one feed-forward per self-attention
    expected_k2 = (SDXL_CROSS_PER_UNET_CALL * FULL_STEPS, SDXL_IP_CROSS_PER_UNET_CALL * FULL_STEPS)
    if tuple(out.shape) != (1, 1024, 1024, 3) or not finite:
        raise AssertionError(f"bad output: shape {tuple(out.shape)}, finite {finite}")
    if launches != expected or k2 != expected_k2 or k5 != expected or n["K4"]:
        raise AssertionError(f"eager: K1 launched {launches} times, expected {expected}; K2 "
                             f"{k2}, expected {expected_k2}; K5 {k5}, expected {expected}; K4 "
                             f"{n['K4']}, expected 0")
    if g != {"K1/K4": expected, "K2": expected_k2[0], "K5": expected}:
        raise AssertionError(f"the replayed generate() launched {g}, expected {expected} K1, "
                             f"{expected_k2[0]} K2 and {expected} K5")
    profile_modes(pipe, img, kw, "phase 5 SDXL 1024²")
    return n, g


def _loss_and_grads(comps, tcfg, batch, draws, dev, step_lib):
    state = step_lib.init_state(comps, tcfg)
    d = step_lib.Draws(*(x.to(dev) for x in (draws.noise, draws.timesteps, draws.latent_eps)))
    loss = step_lib.loss_fn(comps, tcfg, step_lib.to_device(batch, dev), d)
    loss.backward()
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().cpu()
                      .flatten() for p in state.trainable.values()])
    return float(loss.detach()), flat


def phase_train_tiny(fa, kg, comp, step_lib):
    cfgs = comp.tiny_configs()
    cpu = comp.init_params(torch.Generator().manual_seed(0), cfgs, device="cpu")
    card = copy.deepcopy(cpu).to(device="cuda", dtype=torch.bfloat16)
    tcfg = step_lib.TrainConfig(unet_cfg=cfgs.unet)
    batch = step_lib.dummy_batch(cfgs, 2, 32)
    draws = step_lib.draw(torch.Generator().manual_seed(1), cfgs, tcfg, 2, 32)
    loss_cpu, g_cpu = _loss_and_grads(cpu, tcfg, batch, draws, "cpu", step_lib)
    fa.launches = fa.bwd_launches = kg.geglu_launches = 0
    loss_card, g_card = _loss_and_grads(card, tcfg, batch, draws, "cuda", step_lib)
    torch.cuda.synchronize()
    cos = _cosine(g_card, g_cpu)
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    print(f"phase 6 tiny train step card bf16 vs cpu fp32: loss {loss_card:.6f} vs "
          f"{loss_cpu:.6f} (rel {rel:.3e}), gradient cosine={cos:.6f}, K1 launches "
          f"{fa.launches}, K3 launches {fa.bwd_launches}, K5 launches {kg.geglu_launches}",
          flush=True)
    if not (rel <= TRAIN_MAX_LOSS_REL and cos >= TRAIN_MIN_GRAD_COSINE and fa.bwd_launches > 0
            and kg.geglu_launches > 0):
        raise AssertionError("the tiny train step on the card disagrees with the CPU")


def expected_k3_per_step(ucfg):
    """Self-attentions that need a gradient in one UNet backward: those
    downstream of the first IP-active cross-attention (in forward order, a
    transformer block runs attn1 then attn2)."""
    layers = []
    for i, btype in enumerate(ucfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            layers += [(f"down_blocks.{i}.attentions.{j}", ucfg.transformer_layers_per_block[i])
                       for j in range(ucfg.layers_per_block)]
    last = len(ucfg.block_out_channels) - 1
    layers.append(("mid_block.attentions.0", ucfg.transformer_layers_per_block[last]))
    for i, btype in enumerate(ucfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            layers += [(f"up_blocks.{i}.attentions.{j}",
                        ucfg.transformer_layers_per_block[last - i])
                       for j in range(ucfg.layers_per_block + 1)]
    count, live = 0, False
    for name, n_blocks in layers:
        for _ in range(n_blocks):
            count += live  # this block's attn1
            live = live or ucfg.is_ip_active(name)  # its attn2
    return count


def phase_train_full(fa, ca, kg, comp, step_lib, trainer):
    """trainer.main at full width; a wrapper around the step's update
    records the launch counts and the gradients of each step."""
    expected = expected_k3_per_step(comp.sdxl_configs().unet)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    steps = []
    update = step_lib.apply_update

    def watched(state, cfg):
        def max_grad(pred):
            gs = [p.grad.abs().max() for n, p in state.trainable.items()
                  if pred(n) and p.grad is not None]
            return float(torch.stack(gs).max()) if gs else 0.0

        steps.append({
            "k1": fa.launches, "k3": fa.bwd_launches, "k2": ca.cross_launches,
            "k5": kg.geglu_launches,
            "ip": max_grad(lambda n: "down_blocks.2.attentions.1." in n and "_ip." in n),
            "harmony": max_grad(lambda n: n.startswith("harmony.")),
        })
        return update(state, cfg)

    step_lib.apply_update = watched
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.bwd_launches = ca.cross_launches = kg.geglu_launches = 0
        t0 = time.perf_counter()
        final = trainer.main(["--full_random", "--synthetic_data", str(TRAIN_STEPS),
                              "--max_steps", str(TRAIN_STEPS), "--log_every", "1",
                              "--output_dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
    finally:
        step_lib.apply_update = update
        shutil.rmtree(out_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    k1, k2, k3, k5 = ([s[key] - (steps[i - 1][key] if i else 0) for i, s in enumerate(steps)]
                      for key in ("k1", "k2", "k3", "k5"))
    step_s = statistics.median(m["step_time_s"] for m in metrics[1:])
    for m, s, a, c, x, g in zip(metrics, steps, k1, k3, k2, k5):
        print(f"phase 7 step {m['step']}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6e}, "
              f"step {m['step_time_s']:.4f} s, max |grad| live IP {s['ip']:.3e}, harmony "
              f"{s['harmony']:.3e}, K1 launches {a}, K3 launches {c}, K2 launches {x}, "
              f"K5 launches {g}", flush=True)
    expected_k2 = 2 * SDXL_CROSS_PER_UNET_CALL  # forward and checkpoint recompute
    expected_k5 = 2 * SELF_ATTN_PER_UNET_CALL  # one feed-forward a block, twice
    print(f"phase 7 full-width training {final} steps: total {wall:.3f} s, step time median "
          f"of steps 2-{TRAIN_STEPS} {step_s:.4f} s, peak memory {peak:.2f} GiB, K1/K3/K2/K5 "
          f"launches per step {k1[-1]}/{k3[-1]}/{k2[-1]}/{k5[-1]} (K3 expected {expected}, K2 "
          f"{expected_k2}, K5 {expected_k5})", flush=True)
    if final != TRAIN_STEPS or len(metrics) != TRAIN_STEPS or len(steps) != TRAIN_STEPS:
        raise AssertionError(f"the trainer ran {final} steps, logged {len(metrics)}")
    for m, s in zip(metrics, steps):
        if not (m["loss"] == m["loss"] and abs(m["loss"]) < float("inf")
                and m["grad_norm"] > 0 and s["ip"] > 0 and s["harmony"] > 0):
            raise AssertionError(f"step {m['step']}: non-finite loss or a zero gradient")
    if (any(c != expected for c in k3) or min(k1) <= 0 or any(x != expected_k2 for x in k2)
            or any(g != expected_k5 for g in k5)):
        raise AssertionError(f"K3 launches per step {k3}, expected {expected}; K2 {k2}, "
                             f"expected {expected_k2}; K5 {k5}, expected {expected_k5}; K1 {k1}")
    return sum(k1), sum(k3), sum(k2), sum(k5)


def narrow_sd15_configs(comp, proj_kind="image_proj"):
    """The SD1.5 bundle at narrow widths whose head dims are the real 40, 80
    and 160 (``sd15_tiny_configs`` has 8, 16 and 32, which K4 does not take).
    Channel counts divide by 32, the transformers' group count."""
    from imagharmony_tpu_torch.adapters import resampler
    from imagharmony_tpu_torch.models import unet

    cfgs = comp.sd15_tiny_configs()
    u = unet.sd15_config(block_out_channels=(160, 320, 640, 640),
                         num_attention_heads=(4, 4, 4, 4), cross_attention_dim=24,
                         sample_size=8)
    rs = resampler.tiny_config(embedding_dim=cfgs.vision.hidden_size,
                               output_dim=u.cross_attention_dim)
    return dataclasses.replace(cfgs, unet=u, proj_kind=proj_kind, resampler=rs)


def phase_sd15_narrow(fa, ca, kg, comp, HarmonyPipeline):
    img = np.random.default_rng(0).integers(0, 255, (48, 48, 3), dtype=np.uint8)
    noise = np.random.default_rng(1).standard_normal((1, 32, 32, 4)).astype(np.float32)
    kw = dict(prompt="a dog", height=64, width=64, noise=noise, num_inference_steps=3,
              output_type="raw")
    cpu = HarmonyPipeline.random(narrow_sd15_configs(comp), seed=0, device="cpu")
    card = HarmonyPipeline(
        copy.deepcopy(cpu.components).to(device="cuda", dtype=torch.bfloat16), cpu.tokenizers
    )
    ref = cpu.generate(img, **kw)
    r = edit_modes(card, img, kw, fa, ca, kg, "phase 8 narrow SD1.5 pipeline")
    out, n = r["eager"], r["launches"]
    cos = _cosine(out.float().cpu(), ref)
    expected = 3 * SD15_SELF_ATTN_PER_UNET_CALL  # as many feed-forwards
    print(f"phase 8 narrow SD1.5 pipeline card bf16 (eager) vs cpu fp32: image cosine={cos:.6f}, "
          f"K4 launches={n['K4']}, K5 launches={n['K5']} (expected {expected} each), K1 "
          f"launches={n['K1']}", flush=True)
    if not (torch.isfinite(out).all() and cos >= TINY_MIN_COSINE):
        raise AssertionError("the narrow SD1.5 pipeline on the card disagrees with the CPU")
    if (n["K4"], n["K5"], n["K1"]) != (expected, expected, 0):
        raise AssertionError(f"K4 launched {n['K4']} times, K5 {n['K5']}, expected {expected}; "
                             f"K1 {n['K1']}, expected 0")
    for kind in ("resampler", "mlp_proj"):
        pipe = HarmonyPipeline.random(narrow_sd15_configs(comp, kind), seed=0, device="cuda",
                                      dtype=torch.bfloat16)
        fa.bhsd_launches = 0
        out = pipe.generate(img, **dict(kw, num_inference_steps=2))
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all())
        print(f"phase 8 narrow SD1.5 with proj_kind={kind}: shape {tuple(out.shape)}, "
              f"finite {finite}, K4 launches={fa.bhsd_launches}", flush=True)
        if tuple(out.shape) != (1, 64, 64, 3) or not finite or fa.bhsd_launches <= 0:
            raise AssertionError(f"the {kind} pipeline on the card gave a bad output")


def phase_sd15_full(fa, ca, kg, HarmonyPipeline):
    t0 = time.perf_counter()
    pipe = HarmonyPipeline.random_full_sd15(seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.components.parameters())
    print(f"phase 9 built random_full_sd15: {n_params / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    img = np.random.default_rng(0).integers(0, 255, (512, 512, 3), dtype=np.uint8)
    kw = dict(prompt="a photo of six sheep on a meadow", num_samples=1, seed=0,
              guidance_scale=5.0, height=512, width=512, num_inference_steps=FULL_STEPS,
              output_type="raw")
    torch.cuda.empty_cache()
    r = edit_modes(pipe, img, kw, fa, ca, kg, "phase 9 SD1.5 512²")
    out, n, g = r["replay"], r["launches"], r["generate"]
    k1, k4, k2, k5 = n["K1"], n["K4"], (n["K2"], n["K2 IP"]), n["K5"]
    finite = bool(torch.isfinite(out).all())
    print(f"phase 9 SD1.5 generate 512² {FULL_STEPS} steps: replayed K4 launches "
          f"{g['K1/K4']}, K2 {g['K2']}, K5 {g['K5']}; eager K4 {k4}, K1 {k1}, K2 {k2[0]} "
          f"({k2[1]} with the IP branch), K5 {k5}; shape {tuple(out.shape)}, finite {finite}",
          flush=True)
    if tuple(out.shape) != (1, 512, 512, 3) or not finite:
        raise AssertionError(f"bad output: shape {tuple(out.shape)}, finite {finite}")
    # as many cross-attentions (IP on all) and feed-forwards as self-attentions
    expected = SD15_SELF_ATTN_PER_UNET_CALL * FULL_STEPS
    if (k4, k1, k2, k5) != (expected, 0, (expected, expected), expected):
        raise AssertionError(f"K4 launched {k4} times, expected {expected}; K1 {k1}, expected 0; "
                             f"K2 {k2}, expected {expected} with the IP branch; K5 {k5}, "
                             f"expected {expected}")
    if g != {"K1/K4": expected, "K2": expected, "K5": expected}:
        raise AssertionError(f"the replayed generate() launched {g}, expected {expected} K4, "
                             f"K2 and K5")
    profile_modes(pipe, img, kw, "phase 9 SD1.5 512²")
    return n, g


def _unet_ip_grads(unet, inputs, dev):
    """sum(out^2)'s gradient with respect to the UNet's IP projections (the
    only parameters that need one), flat fp32 on the CPU."""
    unet.requires_grad_(False)
    ip = [p for n, p in unet.named_parameters() if "_ip." in n]
    for p in ip:
        p.requires_grad_(True)
    sample, ts, ctx, tokens = (x.to(dev) for x in inputs)
    dt = next(unet.parameters()).dtype
    out = unet(sample.to(dt), ts, ctx.to(dt), ip_tokens=tokens.to(dt))
    out.float().square().sum().backward()
    return torch.cat([p.grad.float().cpu().flatten() for p in ip]), len(ip)


def phase_sd15_grad(fa, ca, kg, comp, punet):
    """The full-width SD1.5 UNet's gradient to its IP projections on the
    card, with the launch counts, then the narrow one's against the CPU."""
    cfg = comp.sd15_configs().unet
    unet = punet.UNet2DConditionModel(cfg, device="cuda", dtype=torch.bfloat16)
    comp.init_weights_(unet, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    inputs = (torch.randn((1, 4, 64, 64), generator=gen), torch.tensor([500.0]),
              torch.randn((1, TEXT_KEYS, cfg.cross_attention_dim), generator=gen),
              torch.randn((1, 4, cfg.cross_attention_dim), generator=gen))
    expected = (SD15_SELF_ATTN_PER_UNET_CALL, SD15_SELF_ATTN_PER_UNET_CALL,
                expected_k3_per_step(cfg), SD15_SELF_ATTN_PER_UNET_CALL, 0)
    walls = []
    for _ in range(2):  # the first call pays cuDNN/cuBLAS set-up at these shapes
        unet.zero_grad(set_to_none=True)
        fa.launches = fa.bhsd_launches = fa.bwd_launches = ca.cross_launches = 0
        kg.geglu_launches = 0
        t0 = time.perf_counter()
        grads, n_ip = _unet_ip_grads(unet, inputs, "cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = (fa.bhsd_launches, ca.cross_launches, fa.bwd_launches, kg.geglu_launches,
                  fa.launches)
    finite = bool(torch.isfinite(grads).all())
    print(f"phase 10 SD1.5 UNet 512² batch 1 forward + backward to its {n_ip} IP projections: "
          f"{walls[0]:.3f} s first, {walls[1]:.3f} s second, max |grad| "
          f"{float(grads.abs().max()):.3e}, finite {finite}, K4/K2/K3/K5/K1 launches {counts} "
          f"(expected {expected})", flush=True)
    if not finite or float(grads.abs().max()) <= 0 or counts != expected:
        raise AssertionError(f"the SD1.5 UNet's IP gradient on the card: finite {finite}, "
                             f"launches {counts}, expected {expected}")
    full = counts

    narrow = narrow_sd15_configs(comp).unet
    cpu = comp.init_weights_(punet.UNet2DConditionModel(narrow), torch.Generator().manual_seed(2))
    card = copy.deepcopy(cpu).to(device="cuda", dtype=torch.bfloat16)
    inputs = (torch.randn((1, 4, 32, 32), generator=gen), torch.tensor([500.0]),
              torch.randn((1, TEXT_KEYS, narrow.cross_attention_dim), generator=gen),
              torch.randn((1, 4, narrow.cross_attention_dim), generator=gen))
    ref, _ = _unet_ip_grads(cpu, inputs, "cpu")
    fa.bhsd_launches = fa.bwd_launches = ca.cross_launches = kg.geglu_launches = 0
    got, _ = _unet_ip_grads(card, inputs, "cuda")
    torch.cuda.synchronize()
    cos = _cosine(got, ref)
    narrow_counts = (fa.bhsd_launches, ca.cross_launches, fa.bwd_launches, kg.geglu_launches)
    print(f"phase 10 narrow SD1.5 UNet IP gradients card bf16 vs cpu fp32: cosine={cos:.6f}, "
          f"K4/K2/K3/K5 launches {narrow_counts}", flush=True)
    if not (cos >= TRAIN_MIN_GRAD_COSINE and min(narrow_counts) > 0):
        raise AssertionError("the narrow SD1.5 UNet's IP gradients on the card disagree with "
                             "the CPU")
    return full[:4]


def _line_times(t, bound):
    """The times of a kernel's entry in the kernels line: device times, all
    three taken the same way, and the CUDA-event times, which hold the
    host's launch work, apart."""
    return {
        "ms": t["kernel"][0],
        "plain_ms": t["plain"][0],
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": t["library"][0],
        "event_ms": {k: t[k][1] for k in ("kernel", "plain", "library")},
    }


def main():
    from imagharmony_tpu_torch.kernels import build
    from imagharmony_tpu_torch.kernels import cross_attention as ca
    from imagharmony_tpu_torch.kernels import flash_attention as fa
    from imagharmony_tpu_torch.kernels import geglu as kg
    from imagharmony_tpu_torch.kernels import probe_attention as pa
    from imagharmony_tpu_torch.kernels import probe_matmul as pm
    from imagharmony_tpu_torch.kernels import probe_softmax as ps
    from imagharmony_tpu_torch.models import unet as punet
    from imagharmony_tpu_torch.nn.attention import split_heads
    from imagharmony_tpu_torch.pipelines import components as comp
    from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline
    from imagharmony_tpu_torch.train import step as step_lib
    from imagharmony_tpu_torch.train import trainer

    phase_device()
    phase_build(fa, ca, kg, pm, pa, build)
    max_err, main_ms = phase_k1(fa, split_heads)
    k3_err, k3_times, k1_train_times = phase_k3(fa)
    k4_err, k4_times = phase_k4(fa)
    k2_err, k2_times = phase_k2(ca)
    k3b_err, k3b_times = phase_k3_bhsd(fa, split_heads)
    k5_err, k5_times = phase_k5(kg)
    p1_err, p1_times = phase_p1(pm)
    probes = _probe_main("probe_pallas_matmul", fa, kg, pm, pa, ps)
    p2_err, p2_times = phase_p2(pa, fa)
    p5_errs, p5_times = phase_p5(ps, pa, fa)
    for tool in ("probe_attn_kblock", "probe_attn_lanegroup", "probe_softmax_nomax",
                 "probe_softmax_tricks"):
        got = _probe_main(tool, fa, kg, pm, pa, ps)
        probes = {k: probes[k] + got[k] for k in probes}
    missing = [k for k, n in probes.items() if not n]
    if missing:
        raise AssertionError(f"a kernel was not launched on the probes' path: {missing} "
                             f"of {probes}")
    p1_launches = probes["probe_mm"]
    phase_second_device(fa, ca, kg, pm, pa, ps, split_heads, HarmonyPipeline)
    phase_tiny(fa, ca, kg, HarmonyPipeline)
    sdxl, sdxl_gen = phase_full(fa, ca, kg, HarmonyPipeline)
    phase_train_tiny(fa, kg, comp, step_lib)
    k1_train, k3_train, k2_train, k5_train = phase_train_full(fa, ca, kg, comp, step_lib, trainer)
    phase_sd15_narrow(fa, ca, kg, comp, HarmonyPipeline)
    sd15, sd15_gen = phase_sd15_full(fa, ca, kg, HarmonyPipeline)
    k4_grad, k2_grad, k3_grad, k5_grad = phase_sd15_grad(fa, ca, kg, comp, punet)
    k3 = k3_times[K3_SHAPES[0]]
    k4 = k4_times[K4_SHAPES[0]]
    k2 = k2_times[K2_SHAPES[0][:5]]
    k5 = k5_times[K5_SHAPES[0]]
    p1 = p1_times[("bf16", P1_SHAPES[0])]
    p2 = p2_times[P2_SHAPES[0][:4]]

    def nomax_times(entry, t):  # P3 and P4 share P2's plain version and SDPA
        merged = dict(t["kblock_attn"], kernel=t[entry]["kernel"])
        return {"current_ms": t["current"][0], **_line_times(merged, t["bound"])}

    def recipe_times(recipe, t):  # a P5-P6 recipe with SDPA, K1 and P2 on its inputs
        merged = dict(t[recipe], library=t["library"])
        return {"current_ms": t["current"][0], "p2_ms": t["p2"][0],
                **_line_times(merged, t["bound"])}

    # each entry's settings -> recipe; the first is the entry's headline
    settings = {"softmax_nomax": {f"no_max={n} mxu_sum={int(m)}": recipe
                                  for (n, m), recipe in ps.NOMAX.items()},
                "softmax_tricks": {f"v{v}": recipe for v, recipe in ps.TRICKS.items()}}

    print(json.dumps({"kernels": [{
        "name": "flash_attention_nhd",
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/flash_attn_nhd.cu",
        "replaces": "imagharmony_tpu/kernels/flash_attention.py:415",
        "launches": sdxl_gen["K1/K4"],
        "launches_by_path": {"generate": sdxl_gen["K1/K4"], "edit_eager": sdxl["K1"],
                             "train": k1_train,
                             "probes": probes["flash_attention_nhd"]},
        "max_abs_err": max_err,
        "shape": [2, *MAIN_SHAPES[0]],
        **_line_times(main_ms[MAIN_SHAPES[0]], fwd_bound(2, *MAIN_SHAPES[0])),
        "by_shape": [{"shape": [2, *shape], "head_split_entry_ms": t["via_k4"],
                      **_line_times(t, fwd_bound(2, *shape))} for shape, t in main_ms.items()]
                    + [{"shape": list(shape), "with_lse": True, **_line_times(t, t["bound"])}
                       for shape, t in k1_train_times.items()],
    }, {
        "name": "flash_attention_nhd_bwd",
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/flash_attn_nhd_bwd.cu",
        "replaces": "imagharmony_tpu/kernels/flash_attention.py:220",
        "launches": k3_train,
        "launches_by_path": {"train": k3_train, "sd15_unet_grad": k3_grad},
        "max_abs_err": max(k3_err, k3b_err),
        "shape": list(K3_SHAPES[0]),
        **_line_times(k3, k3["bound"]),
        "by_shape": [{"shape": list(shape), "layout": layout, **_line_times(t, t["bound"])}
                     for layout, times in (("packed", k3_times), ("head-split", k3b_times))
                     for shape, t in times.items()],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/flash_attn_nhd.cu",
        "replaces": "imagharmony_tpu/kernels/flash_attention.py:95",
        "launches": sd15_gen["K1/K4"],
        "launches_by_path": {"generate_sd15": sd15_gen["K1/K4"], "edit_eager_sd15": sd15["K4"],
                             "sd15_unet_grad": k4_grad},
        "max_abs_err": k4_err,
        "shape": list(K4_SHAPES[0]),
        **_line_times(k4, k4["bound"]),
        "by_shape": [{"shape": list(shape), **_line_times(t, t["bound"])}
                     for shape, t in k4_times.items()],
    }, {
        "name": "flash_cross_nhd",
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/cross_attn_nhd.cu",
        "replaces": "imagharmony_tpu/kernels/flash_attention.py:630",
        "launches": sdxl_gen["K2"],
        "launches_by_path": {"generate": sdxl_gen["K2"], "edit_eager": sdxl["K2"],
                             "edit_eager_ip": sdxl["K2 IP"], "train": k2_train,
                             "generate_sd15": sd15_gen["K2"], "edit_eager_sd15": sd15["K2"],
                             "sd15_unet_grad": k2_grad},
        "max_abs_err": k2_err,
        "shape": list(K2_SHAPES[0][:5]),
        **_line_times(k2, k2["bound"]),
        "by_shape": [{"shape": list(shape), **_line_times(t, t["bound"])}
                     for shape, t in k2_times.items()],
    }, {
        "name": "geglu",
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/geglu.cu",
        "replaces": "tools/probe_geglu_v2.py:36 (also tools/probe_geglu_epilogue.py:64, "
                    "tools/probe_geglu_tune.py:37, tools/probe_pallas_matmul.py:60)",
        "launches": sdxl_gen["K5"],
        "launches_by_path": {"generate": sdxl_gen["K5"], "edit_eager": sdxl["K5"],
                             "train": k5_train, "generate_sd15": sd15_gen["K5"],
                             "edit_eager_sd15": sd15["K5"], "sd15_unet_grad": k5_grad,
                             "probes": probes["geglu"]},
        "max_abs_err": k5_err,
        "shape": list(K5_SHAPES[0]),
        **_line_times(k5, k5["bound"]),
        "no_gelu_ms": k5["no_gelu"][0],
        "by_shape": [{"shape": list(shape), "no_gelu_ms": t["no_gelu"][0],
                      "schedule": t["schedule"], **_line_times(t, t["bound"])}
                     for shape, t in k5_times.items()],
    }, {
        "name": "probe_mm",
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/probe_mm.cu",
        "replaces": "tools/probe_pallas_matmul.py:34",
        "launches": p1_launches,
        "launches_by_path": {"probes": p1_launches},
        "max_abs_err": p1_err,
        "shape": list(P1_SHAPES[0]),
        "dtype": "bf16",
        **_line_times(p1, p1["bound"]),
        "by_shape": [{"shape": list(shape), "dtype": pair, "schedule": t["schedule"],
                      **_line_times(t, t["bound"])} for (pair, shape), t in p1_times.items()],
    }] + [{
        "name": entry,
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/probe_attn.cu",
        "replaces": replaces,
        "launches": probes[entry],
        "launches_by_path": {"probes": probes[entry]},
        "max_abs_err": p2_err,
        "shape": list(P2_SHAPES[0][:4]),
        **nomax_times(entry, p2),
        "by_shape": [{"shape": list(shape), "schedule": t["schedule"][probe],
                      **nomax_times(entry, t)} for shape, t in p2_times.items()]
                    + ([{"shape": list(shape), "bq": bq, "kb": kb, "ms": x[0], "event_ms": x[1]}
                        for shape, t in p2_times.items() for (bq, kb), x in t["tiles"].items()]
                       if entry == "kblock_attn" else []),
    } for entry, probe, replaces in (
        ("kblock_attn", "P2", "tools/probe_attn_kblock.py:33"),
        ("batchpack_attn", "P3", "tools/probe_attn_kblock.py:89"),
        ("nhd_with_g", "P4", "tools/probe_attn_lanegroup.py:34 (its pallas_call of "
                             "imagharmony_tpu/kernels/flash_attention.py:415)"))] + [{
        "name": entry,
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/probe_attn.cu",
        "replaces": replaces,
        "launches": probes[entry],
        "launches_by_path": {"probes": probes[entry]},
        "max_abs_err": max(p5_errs[recipe] for recipe in settings[entry].values()),
        "shape": list(P5_SHAPES[0]),
        "setting": next(iter(settings[entry])),
        **recipe_times(next(iter(settings[entry].values())), p5_times[P5_SHAPES[0]]),
        "by_shape": [{"shape": list(shape), "setting": setting, "recipe": recipe,
                      **recipe_times(recipe, t)}
                     for shape, t in p5_times.items()
                     for setting, recipe in settings[entry].items()],
    } for entry, replaces in (("softmax_nomax", "tools/probe_softmax_nomax.py:32"),
                              ("softmax_tricks", "tools/probe_softmax_tricks.py:41"))]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
