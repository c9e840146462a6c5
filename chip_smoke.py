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
   path's two shapes, the SDXL refiner's three (12 and 24 heads of 64) and
   two edge shapes (one of them B=2, S=1000: a
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
   UNets and of the SDXL refiner (77 text keys; 4, 16 and 257 IP keys;
   ip_scale 0; an odd length),
   k and v as views of one packed to_kv tensor, with timings of K2, the
   plain version and, as a yardstick, SDPA on the text branch plus SDPA on
   the IP branch; at every IP shape of the UNets, K2 with ip_scale 0 gives
   the text-only call's output bit for bit, and so does the weight given as
   a 0-dim fp32 tensor on the card (the kernel reads it from device memory,
   as a captured denoise step gives it), which at the shape's ip_scale
   gives the float's output bit for bit; a (B,) weight, one a row (the slot
   engine's rows at different steps), matches the plain version under the
   same gate, a vector of equal values gives the 0-dim weight's bits and a
   row weighted 0 the text-only call's row;
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
   shapes of both families, of the SDXL refiner (widths 768 and 1536) and
   of training (with the bias), at ragged
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
   same weights and draws on the CPU (fp32, plain versions); then the tiny
   trainer on the card as phase 7 runs the full one (``train_modes``), and
   every branch of the step (grad_accum 2, v-prediction, Min-SNR, noise
   offset, EMA, warmup-cosine lr, the clip scaling and keeping) through
   ``train/programs.run`` against the eager ``train_step``;
7. the adapter trainer at full width (``--full_random``, its defaults: 512²,
   batch 1, bf16, gradient checkpointing) on synthetic data, first through
   ``step.train_step`` called directly (eager: every step's K1, K2 and K5
   launches, 140 each, forward and recompute, and its K3 launches, the
   count the UNet config gives, 55; nonzero gradients on the live IP
   projections and the HA head), then through ``trainer.main``, whose every
   step is one replay of the step's CUDA graph (``train/programs.py``): one
   capture, which launches twice one eager step's kernels (its warm-up and
   itself), then replays that launch through no wrapper; the last
   TRAIN_PROFILED replays under the profiler, two in a row of which must
   agree on their kernel events and launch 140 ``attn_fwd_wgmma_kernel``,
   140 ``cross_attn_wgmma_kernel``, 140 ``geglu_wgmma_kernel`` and 55
   ``attn_bwd_dkdv_kernel`` by name; the replayed steps' losses, grad norms
   and trainable parameters equal the eager run's bit for bit (or, where two
   eager runs differ, are no further from it than they are), with the step
   wall of each mode, the replayed step's kernels, kernel ms and idle
   share, the capture time, the peak memory allocated and what the program
   keeps;
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
   (bf16) against the CPU (fp32);
11. checkpoint IO at full width: phase 5's and 7's bundle written as a
   diffusers tree (``io/checkpoints.save_tree``, ~10.4 GiB, plus the
   adapter as ``.bin`` and ``.safetensors``) in a temporary directory, read
   back by ``load_pipeline`` (the bundle's weights exactly; its edit as in
   phase 5, phase 5's image bit for bit, 2100 K1, K2 and K5 launches
   replayed) and by the trainer's ``--pretrained_model_name_or_path`` (phase
   7's captured run bit for bit), with the write and read times and the
   peak host RSS;
12. the sampler zoo and the edit's features at full width, on phase 5's
   SDXL bf16 pipeline (``feature_configs``), at FEATURE_STEPS (10) steps,
   a depth cut from 30 that the phase prints: DPM++ 2M Karras with
   guidance_rescale, micro-conditioning overrides, a negative prompt and
   clip_skip; Euler-a; DDIM with trailing spacing, v-prediction and
   zero-SNR; LCM at 4 steps with no CFG and no image; img2img at strength
   0.6; inpainting; the denoising_end 0.8 -> denoising_start 0.8 latent
   handoff; encoder_interval 2 with prompt weighting and tile_vae; then an
   SD1.5 512² DPM++ edit. Each configuration is one key, run as phase 5's
   edit is (``edit_modes``: the replay bit-identical to the eager module
   functions, one capture then none, the replayed launches by kernel name
   equal to the eager run's), its launches against what the UNet config
   gives (70 K1, K2 and K5 a UNet call, 46 on an encoder-reuse step, 16
   K4, K2 and K5 for SD1.5) over the steps its schedule runs, its output
   finite; each with its wall time,
   per-step time, capture time and the memory its programs keep, dropped
   before the next key's capture;
13. the serving path at full width on a fresh SDXL bf16 random_full(0)
   (``phase_serve``): (a) ``generate_batch`` of four requests (their own
   images, prompts, extra_texts and seeds), SERVE_DEPTH (10) steps in
   (a)-(c), a depth cut from 30 that the phase prints, eagerly through the
   module functions and through its captured programs (one capture, the
   replay bit for bit the eager run, 700 K1, K2 and K5 launches replayed
   by kernel name, 100 K2 with the IP branch eagerly), each row against its
   solo ``generate()`` (image cosine >= 0.999), with warm seconds, images/s
   against four solo calls, peak memory and what the key keeps; then the
   program cache's bound cut below its keys: the least recently used key
   evicted and its memory returned; (b) the chunked runner
   (``chunk_steps`` 5, a callback at each chunk) against generate() with
   num_samples 2, bit for bit, 700 of each kernel replayed; (c) a 4-slot
   ``SlotEngine`` with a request admitted one chunk after another: its
   latents and image bit for bit its solo engine run's, the chunk's
   replayed launches (350 of each kernel), what the engine keeps; (d) both
   workers through ``make_server`` on localhost, six requests of two batch
   keys at 8 steps: every one answered, the packed worker packing, the
   continuous one admitting mid-flight (``/status`` and ``admissions``),
   ``pack_errors`` 0;
14. the variants and the CLI (``phase_variants``, ``phase_cli``) at full
   width, random bf16 weights from seed 0: (a) the base -> refiner
   ensemble, ``random_full()`` to denoising_end 0.8 and
   ``random_full_refiner()`` (SDXL-refiner-1.0's widths) from its latents,
   1024², 30 Euler steps, CFG 5.0, each run as phase 5's edit
   (``edit_modes``), their eager launches the configs' (``blocks_per_call``:
   70 and 44 a UNet call), what each key keeps, and the memory with the
   one key a pipeline that the CLI's ensemble keeps;
   (b) a ControlNet at the base's widths, its output convs drawn (a fresh
   one is a no-op), with a 1024² control image: 30 x (70 + 34) launches of
   each kernel, 300 K2 with the IP branch, the image moved against the same
   call without it, and a two-request ``generate_batch`` with control
   images bit for bit its eager run; (c) a rank-64 LoRA with B drawn,
   merged by ``with_lora``: every merged weight W + (alpha/r)·A·B in fp32
   to bf16 rounding, the merged edit as phase 5's; (d) the qformer, mlp and
   gated-attention HA fusions at the shipped dims swapped in: the image
   prompt's tokens bf16 on the card against fp32 on the CPU (cosine >=
   0.999), a FUSION_STEPS (2)-step edit each as phase 5's; (e), run inside phase 11 on its
   tree before the tree is removed: the CLI (``cli.main``), one ``edit``
   with a LoRA, a ControlNet directory, a control image, ``--refiner-dir``
   (a random refiner written as a tree) and ``--attn-maps``, ``demo`` and
   ``serve --lora``'s server answering one request, each exiting 0 with its
   files written, its wall time (loads included) printed;
15. the training variants at full width (``phase_training_variants``):
   (a) the trainer with ``--lora_rank`` 8 (``--full_random``, 512², batch
   1, bf16, gradient checkpointing) as phase 7 runs it: the replays bit for
   bit the eager steps, 140 K1, K2 and K5 launches a step and the K3
   launches ``expected_k3_per_step`` derives with the LoRA targets (70:
   every attn1's q needs a gradient; the derivation first checked against
   counted launches at tiny size for four target sets), dA exactly 0 and
   dB nonzero at step 1 and both nonzero later, the exported
   ``lora-N.safetensors`` read back bit for bit, the merged weights' and
   the factors' sizes, the step times and what the program keeps; (b) the
   trainer with ``--cache_encoders`` on a JSON dataset of 8 random
   1024x768 PNGs at 512² (resize and centre crop through the image-ops
   binding): the precompute's seconds, the memory allocated before and
   after the four towers are dropped (the fall is their bytes), the
   replays bit for bit the eager steps, phase 7's launches; (c) the
   image-ops binding (host C++) on those 8 images: built, its threads bit
   for bit, within ``tests/test_native.py``'s tolerance of PIL, its host
   time against PIL's on a line of its own;
16. the parallel layer (``parallel/``; (a) runs after 3j with the kernel
   phases, (b) after 7, whose run it repeats, (c) last): (a) K1, K2 and K5 at the 2-way
   tensor-parallel shard shapes of the SDXL edit (heads and FFN widths
   halved: K1 (2, 4096, 5, 64) and (2, 1024, 10, 64), K2 the same with
   and without 4 IP keys, K5 (8192, 640, 1280) and (2048, 1280, 2560))
   against their plain versions under phase 3's gates, timed against them
   and the library call, K5's schedule printed; (b) a world of one process
   through NCCL: phase 7's trainer over its 1 x 1 mesh, the all-reduce of
   the gradients inside each captured step, bit for bit phase 7's losses,
   grad norms and parameters with phase 7's launches by name, the
   collective's device events printed by name from a replayed step's
   trace; phase 5's edit through ``with_mesh``, bit for bit phase 5's
   image with its launches; (c) with two cards or more (else skipped,
   printed): two NCCL ranks (``parallel.drills.card_drills``), the
   trainer data-parallel and with ``--fsdp`` against one card on the same
   two rows a step, each rank's FSDP-sliced parameter bytes, and the
   1 x 2 tensor-parallel 1024² edit against phase 5's image.
17. the evaluation tools and profiling's helpers, on phase 5's pipeline
   (run right after phase 5, its programs dropped at the end): (a)
   ``tools/eval_benchmark.evaluate`` over 4 synthetic records at 1024², 30
   steps: the first record's image bit for bit ``generate()`` called
   directly with the same arguments, no record capturing a new key or
   launching through a wrapper (phase 5's key serves them), every CLIP-T and
   CLIP-I finite and in [-1, 1], and one record's launches of K1, K2 and K5
   by kernel name in the trace ``profiling.trace`` writes around it (2100
   each), the direct call inside an ``annotate`` span its trace holds; (b)
   ``tools/validate_presets.validate`` over its four presets at 30 steps:
   each preset's image bit for bit the CLI's own call
   (``cli.edit_kwargs`` of ``edit`` with ``--fast``, ``--turbo``, both or
   neither), with its launches by kernel name in a trace (2100, 1050, 1740
   and 882: encoder propagation's key steps run 70 transformer blocks, its
   reuse steps 46) and the captures it made; (c) ``profiling.compiled_stats``
   of one eager SDXL UNet CFG call at 1024²: its flops, bytes and peak, the
   kernels' declared flops by kernel (each the sum of its JAX formula over
   the call's shapes) and their share; a tiny UNet's count on the card
   (bf16, the kernels declaring) equal to the CPU's (fp32, the plain
   versions' products) exactly, and a tiny eager train step's (its
   backward and the checkpoint's reruns on the autograd engine's threads)
   the CPU's less 3/11 of K3's declared flops exactly, each kernel's
   declared launches its wrapper's count; (d) both tools' ``main`` as
   ``python -m`` processes on the card (``--random tiny``), in parallel,
   exit 0 with their files and last lines.

``python3 chip_smoke.py --cards`` on a machine with two cards or more runs
phase 16c alone (``main_cards``): the main path's kernels built, phase 5's
1024² edit once on one card for its image, then 16c; it prints no kernels
line and its last line is the same ok line.

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
there. "train" is one replayed full-width train step's launches (by kernel
name in its trace; K3's ``launches`` too) and "train_eager" one eager
step's (the wrappers' counts). "generate_loaded" is phase 11's warm
``generate()`` of the pipeline loaded from the tree, counted as
"generate" is, and "generate_<tag>" phase 12's of each configuration
(``feature_configs``' tags; "generate_sd15_dpmpp" the SD1.5 DPM++ edit).
"generate_batch" is phase 13's replayed four-request ``generate_batch``
("edit_eager_batch" its eager run's wrapper counts, "edit_eager_batch_ip"
K2's with the IP branch), "generate_chunked" its replayed chunked runner,
"engine_chunk" one replayed chunk (5 steps) of the 4-slot engine.
"generate_ensemble_base" and "generate_refiner" are phase 14a's replayed
calls, "generate_controlnet", "generate_lora" and "generate_ha_<fusion>"
14b-d's. "train_lora" and "train_cached" are one replayed train step's of
phases 15a and 15b (by kernel name), "train_lora_eager" and
"train_cached_eager" an eager step's (the wrappers' counts).
"train_dp" is phase 16b's replayed step over the mesh (by kernel name),
"generate_mesh" its replayed ``with_mesh`` edit; K1's, K2's and K5's
``tp_shard_shapes`` rows are phase 16a's. "eval_record" is phase 17a's
record and "preset_<name>" 17b's call of each preset (by kernel name).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
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
# the denoise depth of phases 12 and 13, cut from FULL_STEPS (phases 5, 9, 11
# and 14 run the 30-step edits) to keep the whole script within its time
# (986 s of command time with them at 30 on one H100, where hosts have
# differed by 30%; 15 until phase 15 came; PERF.md §6); each phase prints
# the cut
FEATURE_STEPS = 10
SERVE_DEPTH = 10
SELF_ATTN_PER_UNET_CALL = 70  # SDXL at 1024²: 10 at S=4096 + 60 at S=1024

SD15_SELF_ATTN_PER_UNET_CALL = 16  # SD1.5 at 512²: 5 + 5 + 5 + 1, see K4_SHAPES

MAIN_SHAPES = [(4096, 10, 64), (1024, 20, 64)]
# the SDXL refiner's self-attentions at 1024² with the CFG pair (phase 14):
# 16 at S=4096 with 12 heads, 16 at S=1024 and 4 (the mid block) at S=256
# with 24 heads, per UNet call; checked and timed as MAIN_SHAPES are
REFINER_SHAPES = [(4096, 12, 64), (1024, 24, 64), (256, 24, 64)]
EDGE_SHAPES = [(1000, 2, 64), (64, 4, 32)]
# the serving path's UNet batch (phase 13): four requests' CFG pairs in
# generate_batch, or a 4-slot engine's 2S rows. K1, K2 and K5 are held
# against their plain versions at its shapes too (not timed)
SERVE_BATCH = 8

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
# the SDXL refiner's cross-attentions at 1024² (phase 14), text only (77
# keys of bigG's 1280 context projected to 768 or 1536): 16 at S=4096 with
# 12 heads, 28 at S=1024 and S=256 with 24 heads per UNet call; timed too
K2_SHAPES += [(2, 4096, 12, 64, 0, 1.0), (2, 1024, 24, 64, 0, 1.0), (2, 256, 24, 64, 0, 1.0)]
K2_EDGES = [(2, 1024, 8, 80, 16, 0.7), (2, 256, 8, 160, 257, 0.7), (2, 1024, 8, 80, 4, 0.0),
            (2, 1000, 8, 40, 4, 0.5), (1, 256, 20, 64, 4, 1.0)]
# K2 at the serving path's SDXL shapes, batch SERVE_BATCH
K2_SERVE = [(SERVE_BATCH, sq, h, d, sk_ip, 1.0) for _, sq, h, d, sk_ip, _ in K2_SHAPES[:3]]
# the per-row IP weights a check gives K2's first rows: distinct, row 1 zero,
# within [0, 1] as the pipeline's are (0 or the IP scale, 1.0 by default;
# a weight of 1.7 takes outputs to [4, 8), where one bf16 step is 0.03125,
# past K1_MAX_ABS)
K2_ROW_WEIGHTS = (0.75, 0.0, 1.0, 0.25, 0.9, 0.45, 0.6, 0.1)
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
# the full-width trainer: steps 2 to TRAIN_STEPS - TRAIN_PROFILED time the
# replays, the last TRAIN_PROFILED are profiled (two in a row must agree)
TRAIN_STEPS = 10
TRAIN_PROFILED = 6

# the device kernel behind K1's and K4's entry points
FWD_KERNEL = "attn_fwd_wgmma_kernel"
CROSS_KERNEL = "cross_attn_wgmma_kernel"

# K5, (M, K, inner): timed at kernel_ab.K5_SHAPES, the SDXL and SD1.5
# inference shapes; checked also: training at 512², batch 1 (10 and 60 per
# forward), ragged M, K and inner (the second with more tiles than SMs), and
# K5_SPLIT, a long K whose tiles the tanh and no-gelu forms split along K
# (the erf form keeps 64-column tiles whole there)
K5_SPLIT = (2048, 5120, 1280)
# the SDXL feed-forwards at the serving path's batch (4096 and 1024 tokens a
# row at 1024²)
K5_SERVE = [(SERVE_BATCH * 4096, 640, 2560), (SERVE_BATCH * 1024, 1280, 5120)]
# the SDXL refiner's feed-forwards at 1024² with the CFG pair (phase 14): 16
# at 64² (width 768), 16 at 32² and 4 at 16² (width 1536) per UNet call;
# checked and timed as K5_SHAPES are
K5_REFINER = [(8192, 768, 3072), (2048, 1536, 6144), (512, 1536, 6144)]
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
# and training's: K3 by the one of its three kernels that runs its main loop
TRAIN_KERNELS = {**PATH_KERNELS, "K3": "attn_bwd_dkdv_kernel"}

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
    for b, (s, h, d) in ([(2, shape) for shape in MAIN_SHAPES + REFINER_SHAPES + EDGE_SHAPES]
                         + [(SERVE_BATCH, shape) for shape in MAIN_SHAPES]):
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        scale = d**-0.5
        out = fa.flash_attention_nhd(q, k, v, scale=scale, head_dim=d)
        torch.cuda.synchronize()
        ref = fa.flash_attention_nhd_plain(q.float(), k.float(), v.float(),
                                           scale=scale, head_dim=d)
        err = float((out.float() - ref).abs().max())
        cos = _cosine(out.float(), ref)
        print(f"phase 3 K1 B={b} S={s} H={h} D={d}: max_abs={err:.3e} cosine={cos:.7f}",
              flush=True)
        if not (err <= K1_MAX_ABS and cos >= K1_MIN_COSINE):
            raise AssertionError(f"K1 disagrees with its plain version at B={b} S={s} H={h} "
                                 f"D={d}")
        max_err = max(max_err, err)
        if b == 2 and (s, h, d) in MAIN_SHAPES + REFINER_SHAPES:
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
    for b, sq, h, d, sk_ip, ip_scale in K2_SHAPES + K2_SERVE + K2_EDGES:
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
        out_err = err
        label = f"B={b} Sq={sq} H={h} D={d} IP keys={sk_ip} ip_scale={ip_scale}"
        same = "-"
        if sk_ip and (b, sq, h, d, sk_ip, ip_scale) in K2_SHAPES + K2_SERVE:
            # ip_scale 0 adds exactly 0: the text-only call's output, bit for bit
            zero = ca.flash_cross_nhd(q, k, v, **dict(kw, ip_scale=0.0))
            text = ca.flash_cross_nhd(q, k, v, **dict(kw, k_ip=None, v_ip=None))
            # the weight as a 0-dim fp32 tensor on the card, as the captured
            # denoise step gives it: 0.0 is the text branch, ip_scale the float's
            table = torch.tensor([0.0, ip_scale], device="cuda")
            zero_t = ca.flash_cross_nhd(q, k, v, **dict(kw, ip_scale=table[0]))
            live_t = ca.flash_cross_nhd(q, k, v, **dict(kw, ip_scale=table[1]))
            # one weight a row (the slot engine's rows at different steps):
            # equal values are the 0-dim weight's bits, a zero row the text
            # branch's row, any weights the plain version's within the gate
            equal = ca.flash_cross_nhd(q, k, v, **dict(kw, ip_scale=table[1].expand(b)
                                                       .contiguous()))
            rows = torch.tensor(K2_ROW_WEIGHTS[:b], device="cuda")
            per_row = ca.flash_cross_nhd(q, k, v, **dict(kw, ip_scale=rows))
            torch.cuda.synchronize()
            row_ref = ca.flash_cross_nhd_plain(*f32[:3], scale=d**-0.5, head_dim=d, k_ip=f32[3],
                                               v_ip=f32[4], ip_scale=rows)
            row_errs = (per_row.float() - row_ref).abs().flatten(1).amax(1).tolist()
            row_err, row_cos = max(row_errs), _cosine(per_row.float(), row_ref)
            err, cos = max(err, row_err), min(cos, row_cos)
            same = (torch.equal(zero, text) and torch.equal(zero_t, text)
                    and torch.equal(live_t, out) and torch.equal(equal, out)
                    and torch.equal(per_row[1], text[1]))
        rows_msg = (f"; ip_scale {ip_scale} alone max_abs={out_err:.3e}, per-row weights "
                    f"{[round(w, 2) for w in rows.tolist()]} max_abs by row "
                    f"{[f'{e:.2e}' for e in row_errs]}" if same != "-" else "")
        print(f"phase 3d K2 {label}: max_abs={err:.3e} cosine={cos:.7f} (with a per-row weight "
              f"too{rows_msg}), ip_scale 0 bit-identical to text only, a device-tensor weight "
              f"to the float, a per-row weight of equal values to the 0-dim one and its zero "
              f"row to text only {same}", flush=True)
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
    for m, k, inner in K5_SHAPES + K5_REFINER + K5_SERVE + K5_EDGES:
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
        if (m, k, inner) not in K5_SHAPES + K5_REFINER:
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

    with torch.inference_mode():
        clock = he.PhaseClock(timings, pipe.device, time.perf_counter())
        return he.edit(pipe.components, pipe.prepare(img, **kw), clock)


def _timed(fn, dev):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def replay_launches(run, label, tries=10):
    """Launches of each kernel of PATH_KERNELS in one call of ``run`` (a warm
    generate(), the card synchronized at its end), counted from zero by name
    in the profiler's trace: a replay launches through no wrapper, so no
    wrapper's count sees it. The profiler now and then loses kernel events
    (more often the more a call launches: ~132k events in a DPM++ SDXL
    call), so sessions run until two of them count the same launches of
    those kernels, as many as any session counted."""
    seen = []
    for _ in range(tries):
        _, _, events = profiling.profiled(run)
        counts = {k: sum(name in e["name"] for e in events) for k, name in PATH_KERNELS.items()}
        seen.append(counts)
        if seen.count(counts) > 1 and sum(counts.values()) >= max(sum(c.values()) for c in seen):
            return counts
    raise AssertionError(f"{label}: no two profiler traces of generate() agree on its "
                         f"launches of {list(PATH_KERNELS)} at the most counted: {seen}")


def edit_modes(pipe, img, kw, fa, ca, kg, label, run_steps=None, first_call=None,
               eager_runs=2):
    """The edit generate(img, **kw) asks for, run ``eager_runs`` times (twice,
    or once where the replay must then equal that run bit for bit) eagerly
    through the module functions, then through generate() three times: the first call
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
    must give the same) and the replayed generate()'s (``generate``).
    ``run_steps``: the denoise steps the call runs (img2img and the handoff
    run fewer than num_inference_steps); ``first_call``: the launches the
    first generate() makes, by wrapper (its warm-up and capture), where they
    are not twice one step's (encoder propagation: a key and a reuse step,
    each warmed up and captured)."""
    dev, steps = pipe.device, run_steps or kw["num_inference_steps"]
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for _ in range(eager_runs):
        _reset_launches(fa, ca, kg)
        timings = {}
        out, wall = _timed(lambda: _eager_edit(pipe, img, kw, timings), dev)
        runs.append((out, wall, timings, _launches(fa, ca, kg)))
    peak_eager = torch.cuda.max_memory_allocated(dev) / 2**30
    (eager, _, _, first_counts), (eager2, eager_s, eager_t, launches) = runs[0], runs[-1]
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
        before = pipe.programs.captures
        timings = {}
        out, wall = _timed(lambda: pipe.generate(img, timings=timings, **kw), dev)
        calls.append((out, wall, timings, _launches(fa, ca, kg), pipe.programs.captures - before))
        if len(calls) == 1:  # what the key's programs keep, and the call's output
            torch.cuda.empty_cache()
            kept = (torch.cuda.memory_reserved(dev) - reserved) / 2**30
    peak_graphs = torch.cuda.max_memory_allocated(dev) / 2**30
    (first, first_s, _, captured, n_first), (replay, replay_s, replay_t, replayed, n_second) = calls
    _reset_launches(fa, ca, kg)
    before = pipe.programs.captures
    graph = replay_launches(lambda: _timed(lambda: pipe.generate(img, **kw), dev), label)
    profiled, n_profiled = _launches(fa, ca, kg), pipe.programs.captures - before
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
    first_call = first_call or {k: 2 * launches[k] // steps for k in launches}
    if captured != first_call:
        raise AssertionError(f"{label}: the first generate() launched {captured}, expected "
                             f"{first_call} (its warm-up and capture)")
    return dict(eager=eager, replay=replay, launches=launches, generate=graph, eager_s=eager_s,
                replay_s=replay_s, replay_step_ms=replay_step_ms, capture_s=capture_s,
                kept_gib=kept)


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


def _full_edit():
    """The full-size SDXL edit's image and generate() arguments (phases 5
    and 11)."""
    img = np.random.default_rng(0).integers(0, 255, (1024, 1024, 3), dtype=np.uint8)
    return img, dict(prompt="a photo of six sheep on a meadow", extra_text="six sheep",
                     num_samples=1, seed=0, num_inference_steps=FULL_STEPS, guidance_scale=5.0,
                     output_type="raw")


def phase_full(fa, ca, kg, HarmonyPipeline):
    t0 = time.perf_counter()
    pipe = HarmonyPipeline.random_full(seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.components.parameters())
    print(f"phase 5 built random_full: {n_params / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    img, kw = _full_edit()
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
    return n, g, out, pipe


def _loss_and_grads(comps, tcfg, batch, draws, dev, step_lib):
    state = step_lib.init_state(comps, tcfg)
    d = step_lib.Draws(*(x.to(dev) for x in (draws.noise, draws.timesteps, draws.latent_eps)))
    loss = step_lib.loss_fn(comps, tcfg, step_lib.to_device(batch, dev), d)
    loss.backward()
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().cpu()
                      .flatten() for p in state.trainable.values()])
    return float(loss.detach()), flat


def _reset_train_launches(fa, ca, kg):
    _reset_launches(fa, ca, kg)
    fa.bwd_launches = 0


def _train_launches(fa, ca, kg):
    """The wrappers' counts under TRAIN_KERNELS' keys."""
    return {"K1/K4": fa.launches + fa.bhsd_launches, "K2": ca.cross_launches,
            "K5": kg.geglu_launches, "K3": fa.bwd_launches}


def _max_grad(state, pred):
    gs = [p.grad.abs().max() for n, p in state.trainable.items()
          if pred(n) and p.grad is not None]
    return float(torch.stack(gs).max()) if gs else 0.0


def _gap(a, b):
    """Largest difference of two runs: (per-step (loss, grad_norm) pairs,
    trainable parameters by name)."""
    (ma, pa), (mb, pb) = a, b
    metrics = max(abs(x - y) for u, v in zip(ma, mb) for x, y in zip(u, v))
    params = max(float((pa[n].float() - pb[n].float()).abs().max()) for n in pa)
    return metrics, params


def _agrees(label, replayed, eager, eager_again):
    """Fails unless the replayed run equals the eager one bit for bit, or,
    where a second eager run (``eager_again()``, called only then) differs
    from the first, the replay is no further from the first than it is.
    Returns (replay's gap, two eager runs' gap) as printed."""
    gap = _gap(replayed, eager)
    if gap == (0.0, 0.0):
        return gap, "not run (the replay is bit-identical)"
    gap2 = _gap(eager_again(), eager)
    if gap2 == (0.0, 0.0) or gap[0] > gap2[0] or gap[1] > gap2[1]:
        raise AssertionError(f"{label}: the replayed steps differ from the eager ones by {gap} "
                             f"(metrics, parameters), two eager runs by {gap2}")
    return gap, gap2


def eager_train(argv, steps, fa, ca, kg, step_lib, trainer):
    """The steps ``trainer.main(argv)`` takes on its data, through the eager
    ``step_lib.train_step`` called directly: the trainer's components,
    config, seed, batches (``trainer.make_batches``: with
    ``--cache_encoders`` the precompute and the towers' drop) and
    generator. Per step the loss and grad norm, the wrappers' launch
    counts, the largest |gradient| of the live IP projections, of the HA
    head and of the LoRA factors A and B, and the host time of the
    synchronized step; then the trainable parameters after the last step
    and the peak memory allocated."""
    args = trainer.parse_args(argv)
    cfgs, comps, toks = trainer.build_components(args)
    tcfg = trainer.train_config(args, cfgs)
    state = step_lib.init_state(comps, tcfg, seed=args.seed)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    rows = args.train_batch_size * max(args.grad_accum, 1)
    batches = trainer.make_batches(args, cfgs, comps, toks)
    torch.cuda.reset_peak_memory_stats()
    out = []
    for _ in range(steps):
        batch = step_lib.to_device(next(batches), args.device)
        _reset_train_launches(fa, ca, kg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_lib.train_step(state, comps, tcfg, batch,
                                step_lib.step_draws(gen, cfgs, tcfg, rows, args.resolution))
        torch.cuda.synchronize()
        out.append({"wall": time.perf_counter() - t0, "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]), "launches": _train_launches(fa, ca, kg),
                    "ip": _max_grad(state, lambda n: "down_blocks.2.attentions.1." in n
                                    and "_ip." in n),
                    "harmony": _max_grad(state, lambda n: n.startswith("harmony.")),
                    "lora_a": _max_grad(state, lambda n: n.endswith(".lora_a")),
                    "lora_b": _max_grad(state, lambda n: n.endswith(".lora_b"))})
    trained = {n: p.detach().clone() for n, p in state.trainable.items()}
    return out, trained, torch.cuda.max_memory_allocated() / 2**30


def captured_train(argv, profile_from, fa, ca, kg, trainer):
    """``trainer.main(argv)`` on the card, each step one replay of its
    captured program (``train/programs.py``), watched: each capture's time
    (warm-up included), the wrappers' launches during it, the memory it
    keeps (reserved after ``empty_cache()``, before and after, less the
    AdamW state its warm-up step creates, which the trainer keeps anyway)
    and that state; per replay the wrappers' launches (a replay launches
    through no wrapper) and, from step ``profile_from`` on, its profiler
    trace (``profiling.profiled``: those steps' host times carry the
    profiler). Returns them with the logged metrics, the trainable
    parameters of the last checkpoint, the peak memory allocated and, with
    LoRA, the exported ``lora-N.safetensors`` read back (``load_lora``)."""
    from imagharmony_tpu_torch.adapters import lora as lora_lib
    from imagharmony_tpu_torch.train import programs

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = [*argv, "--log_every", "1", "--output_dir", out_dir]
    captures, replays = [], []
    init, run = programs.TrainProgram.__init__, programs.TrainProgram.run

    def init_watched(self, state, *a, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        _reset_train_launches(fa, ca, kg)
        init(self, state, *a, **kw)
        launches = _train_launches(fa, ca, kg)
        torch.cuda.empty_cache()
        opt = sum(v.numel() * v.element_size() for st in state.optimizer.state.values()
                  for v in st.values() if torch.is_tensor(v))
        captures.append({"s": self.capture_s, "launches": launches, "opt_gib": opt / 2**30,
                         "kept_gib": (torch.cuda.memory_reserved() - before - opt) / 2**30})

    def run_watched(self, batch, gen):
        _reset_train_launches(fa, ca, kg)
        kernels, wall_ms = None, None
        if len(replays) + 1 >= profile_from:
            m, wall_ms, kernels = profiling.profiled(lambda: run(self, batch, gen))
        else:
            m = run(self, batch, gen)
        replays.append({"launches": _train_launches(fa, ca, kg), "kernels": kernels,
                        "wall_ms": wall_ms})
        return m

    programs.TrainProgram.__init__, programs.TrainProgram.run = init_watched, run_watched
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        final = trainer.main(argv)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        trained = torch.load(os.path.join(out_dir, "checkpoints", f"step-{final}.pt"),
                             map_location="cuda", weights_only=True)["trainable"]
        lora_path = os.path.join(out_dir, f"lora-{final}.safetensors")
        lora_file = lora_lib.load_lora(lora_path) if os.path.exists(lora_path) else None
    finally:
        programs.TrainProgram.__init__, programs.TrainProgram.run = init, run
        shutil.rmtree(out_dir, ignore_errors=True)
    return dict(final=final, metrics=metrics, trained=trained, peak=peak, captures=captures,
                replays=replays, lora_file=lora_file)


def train_modes(argv, steps, profile_from, fa, ca, kg, step_lib, trainer, label):
    """``argv``'s trainer for ``steps`` steps eagerly (``eager_train``), then
    through ``trainer.main`` (``captured_train``, the replays from step
    ``profile_from`` on profiled). Fails unless the trainer captured once
    and its capture launched twice one eager step's kernels (warm-up and
    capture), every replay launched through no wrapper, two profiled
    replays in a row hold as many kernel events (the profiler now and then
    loses some) and as many launches of each of TRAIN_KERNELS, by name, as
    an eager step's wrappers count, and the replayed steps agree with the
    eager ones (``_agrees``). Returns the eager steps, the replayed step's
    launches by name and summary (``profiling.summarize``), and the rest."""
    eager, eager_p, eager_peak = eager_train(argv, steps, fa, ca, kg, step_lib, trainer)
    gc.collect()
    torch.cuda.empty_cache()
    run = captured_train([*argv, "--max_steps", str(steps)], profile_from, fa, ca, kg, trainer)
    per_step = eager[-1]["launches"]
    if any(e["launches"] != per_step for e in eager):
        raise AssertionError(f"{label}: eager steps launched {[e['launches'] for e in eager]}")
    caps, reps = run["captures"], run["replays"]
    if run["final"] != steps or len(run["metrics"]) != steps or len(reps) != steps:
        raise AssertionError(f"{label}: the trainer ran {run['final']} steps, logged "
                             f"{len(run['metrics'])}, replayed {len(reps)}")
    if len(caps) != 1 or caps[0]["launches"] != {k: 2 * n for k, n in per_step.items()}:
        raise AssertionError(f"{label}: captures {caps}, expected one launching twice "
                             f"{per_step}")
    if any(any(r["launches"].values()) for r in reps):
        raise AssertionError(f"{label}: a replay launched through a wrapper: "
                             f"{[r['launches'] for r in reps]}")
    traced = [r for r in reps if r["kernels"] is not None]
    pair = next((b for a, b in zip(traced, traced[1:])
                 if a["kernels"] and len(a["kernels"]) == len(b["kernels"])), None)
    if pair is None:
        raise AssertionError(f"{label}: no two profiled replays in a row agree on their kernel "
                             f"events: {[len(r['kernels']) for r in traced]}")
    by_name = {k: sum(name in e["name"] for e in pair["kernels"])
               for k, name in TRAIN_KERNELS.items()}
    if by_name != per_step:
        raise AssertionError(f"{label}: a replayed step launched {by_name} by kernel name, an "
                             f"eager step {per_step}")
    summary = profiling.summarize(pair["kernels"], 1, pair["wall_ms"])

    def runs(metrics, trained):
        return [(m["loss"], m["grad_norm"]) for m in metrics], trained

    def again():
        gc.collect()
        torch.cuda.empty_cache()
        e, p, _ = eager_train(argv, steps, fa, ca, kg, step_lib, trainer)
        return runs(e, p)

    gap, gap2 = _agrees(label, runs(run["metrics"], run["trained"]), runs(eager, eager_p), again)
    replay_s = statistics.median(m["step_time_s"] for m in run["metrics"][1:profile_from - 1])
    return dict(eager=eager, eager_peak=eager_peak, replayed=by_name, summary=summary,
                gap=gap, gap2=gap2, profile_from=profile_from, replay_s=replay_s, **run)


def _print_train_modes(r, label):
    """One line per step of each mode, then the comparison."""
    steps_from = 2  # the first step of each mode pays cuDNN/cuBLAS set-up or the capture
    for i, (e, m) in enumerate(zip(r["eager"], r["metrics"])):
        print(f"{label} step {i + 1}: eager loss {e['loss']:.6f}, grad_norm "
              f"{e['grad_norm']:.6e}, {e['wall']:.4f} s, max |grad| live IP {e['ip']:.3e}, "
              f"harmony {e['harmony']:.3e}, launches {e['launches']}; replayed loss "
              f"{m['loss']:.6f}, grad_norm {m['grad_norm']:.6e}, {m['step_time_s']:.4f} s "
              + ("logged, profiled" if i + 1 >= r["profile_from"] else "logged"), flush=True)
    cap = r["captures"][0]
    eager_s = statistics.median(e["wall"] for e in r["eager"][steps_from - 1:])
    s = r["summary"]
    print(f"{label}: eager step median of steps {steps_from}-{len(r['eager'])} {eager_s:.4f} "
          f"s; replayed step median of the unprofiled steps {steps_from}-"
          f"{r['profile_from'] - 1} {r['replay_s']:.4f} s; a profiled replayed step: wall "
          f"{s['wall_ms_per_step']:.2f} ms, kernels {s['kernels_per_step']:.0f}, kernel ms "
          f"{s['kernel_ms_per_step']:.2f}, device busy {s['device_busy_ms_per_step']:.2f} ms, "
          f"idle {s['idle_share']:.3%} (between kernels: the largest stretch "
          f"{s['largest_gap_ms']:.3f} ms, those over 20 us {s['gaps_over_20us_ms_per_step']:.3f} "
          f"ms); capture with its warm-up step {cap['s']:.3f} s, "
          f"launching {cap['launches']}; kept by the program {cap['kept_gib']:.3f} GiB "
          f"(reserved after empty_cache, before and after the capture, less the AdamW state "
          f"of {cap['opt_gib']:.3f} GiB that its warm-up step creates); peak memory "
          f"allocated eager {r['eager_peak']:.2f} GiB, replayed {r['peak']:.2f} GiB; captures "
          f"{len(r['captures'])}, replays {len(r['replays'])}, each launching through no "
          f"wrapper; replayed step by kernel name {r['replayed']}; eager step by wrapper "
          f"{r['eager'][-1]['launches']}; replay vs eager max abs (metrics, parameters) "
          f"{r['gap']}, two eager runs {r['gap2']}", flush=True)
    print(f"{label} replayed step by kernel class (ms): " + json.dumps(s["class_ms_per_step"]),
          flush=True)


def _branch_programs(comp, step_lib, label):
    """Every branch of the step under capture on the tiny bundle (bf16):
    grad_accum 2, v-prediction, Min-SNR, a noise offset, the EMA, a
    warmup-cosine lr, and the clip both scaling (max_grad_norm 1e-3) and
    keeping; three steps through ``train/programs.run`` against three eager
    ``train_step`` on a copy of the same components and generator."""
    from imagharmony_tpu_torch.train import programs

    cfgs = comp.tiny_configs()
    base = comp.init_params(torch.Generator(device="cuda").manual_seed(0), cfgs,
                            dtype=torch.bfloat16, device="cuda")
    batches = [step_lib.to_device(step_lib.dummy_batch(cfgs, 4, 32, rng=i), "cuda")
               for i in range(3)]
    for max_norm in (1e-3, 1e3):
        tcfg = step_lib.TrainConfig(
            unet_cfg=cfgs.unet, grad_accum=2, prediction_type="v_prediction", snr_gamma=5.0,
            noise_offset=0.05, ema_decay=0.9, lr_schedule="cosine", lr_warmup_steps=1,
            lr_total_steps=3, max_grad_norm=max_norm)

        def steps(replay):
            comps = copy.deepcopy(base)
            state = step_lib.init_state(comps, tcfg)
            gen = torch.Generator(device="cuda").manual_seed(1)
            progs, metrics = {}, []
            for batch in batches:
                if replay:
                    m = programs.run(progs, state, comps, cfgs, tcfg, batch, gen, 32)
                else:
                    m = step_lib.train_step(state, comps, tcfg, batch,
                                            step_lib.step_draws(gen, cfgs, tcfg, 4, 32))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            return metrics, {n: p.detach().clone() for n, p in state.trainable.items()}

        eager = steps(False)
        gap, gap2 = _agrees(f"{label} max_grad_norm {max_norm}", steps(True), eager,
                            lambda: steps(False))
        print(f"{label} every branch (grad_accum 2, v-prediction, Min-SNR, noise offset, EMA, "
              f"warmup-cosine lr, max_grad_norm {max_norm}, grad norms "
              f"{[f'{g:.3e}' for _, g in eager[0]]}), 3 steps through train/programs.run vs "
              f"eager: max abs (metrics, parameters) {gap}, two eager runs {gap2}", flush=True)


def phase_train_tiny(fa, ca, kg, comp, step_lib, trainer):
    """The tiny train step card vs CPU; then the tiny trainer captured
    against eager (``train_modes``), and every branch of the step under
    capture (``_branch_programs``)."""
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
    argv = ["--tiny", "--synthetic_data", "6", "--train_batch_size", "2", "--resolution", "32",
            "--learning_rate", "1e-3", "--ema_decay", "0.9"]
    r = train_modes(argv, 6, 3, fa, ca, kg, step_lib, trainer, "phase 6 tiny trainer")
    _print_train_modes(r, "phase 6 tiny trainer")
    _branch_programs(comp, step_lib, "phase 6 tiny")


def expected_k3_per_step(ucfg, lcfg=None):
    """Self-attentions that need a gradient in one UNet backward: those whose
    q, k or v needs one. In forward order (a transformer block runs attn1
    then attn2) the residual stream needs a gradient from the first
    trainable thing on: an IP-active cross-attention, or with the LoRA
    config ``lcfg`` the first factored projection; an attn1 whose own
    to_q, to_k or to_v is factored needs one wherever it is."""
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

    def factored(attn, projs):
        return lcfg is not None and attn in lcfg.attn and any(p in lcfg.targets for p in projs)

    qkv1 = factored("attn1", ("to_q", "to_k", "to_v"))
    any1 = factored("attn1", ("to_q", "to_k", "to_v", "to_out"))
    any2 = factored("attn2", ("to_q", "to_k", "to_v", "to_out"))
    count, live = 0, False
    for name, n_blocks in layers:
        for _ in range(n_blocks):
            count += live or qkv1  # this block's attn1
            live = live or any1 or any2 or ucfg.is_ip_active(name)  # after its attn1, attn2
    return count


def phase_train_full(fa, ca, kg, comp, step_lib, trainer):
    """The adapter trainer at full width (``--full_random``: 512², batch 1,
    bf16, gradient checkpointing) for TRAIN_STEPS steps, eagerly and
    through ``trainer.main``'s captured program (``train_modes``), the last
    TRAIN_PROFILED of them profiled, at the trainer's own TF32 setting.
    Every eager step launches K3 as often
    as the UNet config gives and K1, K2 and K5 140 times each (forward and
    checkpoint recompute), with nonzero gradients on the live IP
    projections and the HA head; a replayed step launches the same by
    kernel name. Returns the replayed step's launches by name, an eager
    step's by wrapper, and the run (``train_modes``)."""
    expected = {"K1/K4": 2 * SELF_ATTN_PER_UNET_CALL, "K2": 2 * SDXL_CROSS_PER_UNET_CALL,
                "K5": 2 * SELF_ATTN_PER_UNET_CALL, "K3": expected_k3_per_step(
                    comp.sdxl_configs().unet)}
    argv = ["--full_random", "--synthetic_data", str(TRAIN_STEPS)]
    label = "phase 7 full-width trainer"
    # the trainer's own settings: cuDNN may use TF32 for the fp32 VAE encode
    # (PyTorch's default; phase 1 turns it off for the fp32 references)
    torch.backends.cudnn.allow_tf32 = True
    try:
        r = train_modes(argv, TRAIN_STEPS, TRAIN_STEPS - TRAIN_PROFILED + 1, fa, ca, kg,
                        step_lib, trainer, label)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    _print_train_modes(r, label)
    for e in r["eager"]:
        if not (abs(e["loss"]) < float("inf") and e["grad_norm"] > 0 and e["ip"] > 0
                and e["harmony"] > 0):
            raise AssertionError(f"{label}: an eager step gave a non-finite loss or a zero "
                                 f"gradient: {e}")
    if r["eager"][-1]["launches"] != expected or r["replayed"] != expected:
        raise AssertionError(f"{label}: an eager step launched {r['eager'][-1]['launches']}, a "
                             f"replayed one {r['replayed']}, expected {expected}")
    return r["replayed"], r["eager"][-1]["launches"], r


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


def _peak_rss_gib():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB on Linux


def phase_load_full(fa, ca, kg, comp, trainer, image5, run7, during=None):
    """Checkpoint IO at full width: the bundle of phases 5 and 7 (the
    weights ``random_full()`` and the trainer's ``--full_random`` build from
    seed 0, bf16) written as a diffusers tree with the port's writer (the
    UNet without its IP projections, as diffusers writes one; the adapter
    as ``ip_adapter.bin`` and ``ip_adapter.safetensors``), then read back
    through the entry points a user calls. ``load_pipeline(tree, adapter)``
    must give the bundle's weights exactly, and its edit (phase 5's inputs,
    eager and through ``generate()``'s graphs, ``edit_modes``: 2100 K1, K2
    and K5 launches replayed) phase 5's image bit for bit; the trainer with
    ``--pretrained_model_name_or_path`` and ``--pretrained_ip_adapter_path``
    must give phase 7's captured run bit for bit: every step's loss and grad
    norm and the trainable parameters. The tree's tokenizer_2 pads with
    "!", as SDXL's does, where the toy pair of ``random_full()`` pads with
    EOS: the edit's comparison takes ``random_full()``'s tokenizers, after
    the tree's are checked. Prints the tree's bytes, the write time, each
    component's read time and rate, and the process's peak host RSS; the
    tree is removed afterwards, whatever the outcome; before that,
    ``during(tree, ip_adapter.bin)`` runs if given (phase 14e, the CLI).
    Returns the loaded edit's replayed launches by kernel name and what
    ``during`` returned."""
    from imagharmony_tpu_torch.io import checkpoints as ckpt_io
    from imagharmony_tpu_torch.models import tokenizer as tok_lib
    from imagharmony_tpu_torch.nn.attention import pack_inference_params

    label = "phase 11 checkpoint IO"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfgs = comp.sdxl_configs()
    bundle = comp.init_params(torch.Generator(device="cuda").manual_seed(0), cfgs,
                              dtype=torch.bfloat16, device="cuda")
    ip_bytes = sum(p.numel() * p.element_size() for n, p in bundle.unet.named_parameters()
                   if "_ip." in n)
    unet_bytes = sum(p.numel() * p.element_size() for p in bundle.unet.parameters())
    tree_bytes = sum(p.numel() * p.element_size() for p in bundle.parameters()) - ip_bytes \
        - sum(p.numel() * p.element_size() for m in (bundle.image_proj, bundle.harmony)
              for p in m.parameters())
    root = tempfile.mkdtemp(prefix="chip_smoke_tree_")
    free = shutil.disk_usage(root).free
    print(f"{label} ({smi}): the tree holds {tree_bytes / 2**30:.3f} GiB of weights (the UNet "
          f"{(unet_bytes - ip_bytes) / 2**30:.3f} GiB without its IP projections), the adapter "
          f"about {ip_bytes / 2**30:.3f} GiB twice more; {free / 2**30:.1f} GiB free under "
          f"{os.path.dirname(root)}; peak host RSS so far {_peak_rss_gib():.2f} GiB", flush=True)
    try:
        toy = tok_lib.build_toy_tokenizer()
        toy_pair = tok_lib.SDXLTokenizers(toy, toy)
        t0 = time.perf_counter()
        written = ckpt_io.save_tree(root, bundle, tokenizers=toy_pair)
        write_s = time.perf_counter() - t0
        adapters = {}
        for ext in ("bin", "safetensors"):
            adapters[ext] = os.path.join(root, f"ip_adapter.{ext}")
            t0 = time.perf_counter()
            ckpt_io.save_adapter_checkpoint(
                adapters[ext], unet=bundle.unet, unet_cfg=cfgs.unet, image_proj=bundle.image_proj,
                harmony=bundle.harmony, harmony_cfg=cfgs.harmony)
            adapter_s = time.perf_counter() - t0
            print(f"{label}: wrote ip_adapter.{ext}, {os.path.getsize(adapters[ext]) / 2**30:.3f} "
                  f"GiB in {adapter_s:.2f} s", flush=True)
        print(f"{label}: wrote the tree, {written / 2**30:.3f} GiB in {write_s:.2f} s "
              f"({written / write_s / 1e9:.3f} GB/s); peak host RSS {_peak_rss_gib():.2f} GiB",
              flush=True)

        timings = {}
        t0 = time.perf_counter()
        pipe = ckpt_io.load_pipeline(root, adapters["bin"], device="cuda", dtype=torch.bfloat16,
                                     timings=timings)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        per = ", ".join(f"{k} {v['bytes'] / 2**30:.3f} GiB in {v['s']:.2f} s "
                        f"({v['bytes'] / v['s'] / 1e9:.3f} GB/s)" if "bytes" in v
                        else f"{k} {v['s']:.2f} s" for k, v in timings.items())
        print(f"{label}: load_pipeline(tree, ip_adapter.bin) {load_s:.2f} s in all: {per}; peak "
              f"host RSS {_peak_rss_gib():.2f} GiB", flush=True)
        pack_inference_params(bundle.unet)
        want, got = bundle.state_dict(), pipe.components.state_dict()
        differ = [k for k in want if k not in got or not torch.equal(want[k], got[k])]
        if differ or set(got) != set(want):
            raise AssertionError(f"{label}: the loaded weights differ from the bundle's at "
                                 f"{len(differ)} keys (first {differ[:5]}), keys "
                                 f"{len(got)} vs {len(want)}")
        del bundle, want, got
        for text in ("a photo of six sheep on a meadow", "six sheep"):
            ids, pad = pipe.tokenizers(text), toy_pair(text)
            bang = toy.encoder["!"]  # tokenizer_2's pad
            if not np.array_equal(ids[0], pad[0]) or not np.array_equal(
                    np.where(ids[1] == bang, toy.eos_token_id, ids[1]), pad[1]):
                raise AssertionError(f"{label}: the tree's tokenizers give {ids} for {text!r}")
        pipe.tokenizers = toy_pair
        img, kw = _full_edit()
        r = edit_modes(pipe, img, kw, fa, ca, kg, f"{label} SDXL 1024² loaded")
        same = torch.equal(r["replay"], image5)
        diff = float((r["replay"].float() - image5.float()).abs().max())
        print(f"{label}: the loaded pipeline's generate() vs phase 5's random_full(): "
              f"bit-identical {same} (max abs {diff:.3e}); replayed launches {r['generate']}",
              flush=True)
        expected = SELF_ATTN_PER_UNET_CALL * FULL_STEPS
        if r["generate"] != {"K1/K4": expected, "K2": expected, "K5": expected}:
            raise AssertionError(f"{label}: the replayed generate() launched {r['generate']}")
        if not same:
            raise AssertionError(f"{label}: the loaded pipeline's image differs from phase 5's "
                                 f"by {diff}")
        loaded_gen = r["generate"]
        del pipe, r
        gc.collect()
        torch.cuda.empty_cache()

        argv = ["--pretrained_model_name_or_path", root, "--pretrained_ip_adapter_path",
                adapters["safetensors"], "--synthetic_data", str(TRAIN_STEPS)]
        torch.backends.cudnn.allow_tf32 = True  # the trainer's setting, as in phase 7
        try:
            t0 = time.perf_counter()
            run = captured_train([*argv, "--max_steps", str(TRAIN_STEPS)], TRAIN_STEPS + 1, fa,
                                 ca, kg, trainer)
            train_s = time.perf_counter() - t0
        finally:
            torch.backends.cudnn.allow_tf32 = False
        ours = [(m["loss"], m["grad_norm"]) for m in run["metrics"]]
        theirs = [(m["loss"], m["grad_norm"]) for m in run7["metrics"]]
        params_same = set(run["trained"]) == set(run7["trained"]) and all(
            torch.equal(run["trained"][n], run7["trained"][n]) for n in run7["trained"])
        print(f"{label}: the trainer from the tree (--pretrained_model_name_or_path, "
              f"--pretrained_ip_adapter_path ip_adapter.safetensors), {TRAIN_STEPS} captured "
              f"steps in {train_s:.2f} s with the load: losses and grad norms "
              f"{'equal' if ours == theirs else 'differ from'} phase 7's --full_random run "
              f"({ours[0]} ... {ours[-1]}), trainable parameters bit-identical {params_same}; "
              f"captures {len(run['captures'])}; peak host RSS {_peak_rss_gib():.2f} GiB",
              flush=True)
        if ours != theirs or not params_same:
            raise AssertionError(f"{label}: the trainer from the tree differs from phase 7's run: "
                                 f"{ours} vs {theirs}, parameters equal {params_same}")
        del run
        gc.collect()
        torch.cuda.empty_cache()
        extra = during(root, adapters["bin"]) if during is not None else None
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return loaded_gen, extra


# phase 12: a reuse step of encoder propagation runs the mid block and the
# decoder alone, 46 of SDXL's 70 transformer blocks (10 mid, 36 up); the IP
# layer (down_blocks.2.attentions.1, 10 blocks) is in the cached encoder
SDXL_REUSE_PER_UNET_CALL = 46


def feature_configs(init, mask):
    """Phase 12's SDXL keys: (tag, what it runs, generate() arguments over
    phase 5's at FEATURE_STEPS steps, whether the IP branch is live). The
    steps a key runs and its launches follow from its schedule
    (``_steps_of``) and the UNet config. ``init``: the img2img and inpaint
    init image; ``mask``: the inpaint mask. The denoising_start key takes
    the denoising_end key's latents (``latents=None`` here)."""
    return [
        ("dpmpp_karras", "DPM++ 2M Karras, guidance_rescale 0.7, micro-conditioning overrides, "
         "negative prompt, clip_skip 1",
         dict(scheduler="dpm++", use_karras_sigmas=True, guidance_rescale=0.7,
              original_size=(768, 1024), crops_coords_top_left=(64, 0),
              negative_original_size=(512, 512), negative_target_size=(1024, 1024),
              negative_prompt="blurry, lowres", clip_skip=1), True),
        ("euler_a", "Euler-a, seed 3", dict(scheduler="euler_a", seed=3), True),
        ("ddim_vpred_zsnr", "DDIM, trailing spacing, v-prediction, zero-SNR",
         dict(scheduler="ddim", timestep_spacing="trailing", prediction_type="v_prediction",
              rescale_zero_snr=True), True),
        ("lcm_t2i", "LCM 4 steps, guidance_scale 1.0 (no CFG: batch 1), no image",
         dict(scheduler="lcm", num_inference_steps=4, guidance_scale=1.0, image=None), False),
        ("img2img", "img2img at strength 0.6", dict(init_image=init, strength=0.6), True),
        ("inpaint", "inpaint, Euler", dict(init_image=init, mask_image=mask), True),
        ("denoising_end", "denoising_end 0.8, latents out", dict(denoising_end=0.8), True),
        ("denoising_start", "denoising_start 0.8 from those latents",
         dict(denoising_start=0.8, latents=None), True),
        ("encoder_prop", "encoder_interval 2, prompt weighting, tile_vae",
         dict(encoder_interval=2, prompt_weighting=True, tile_vae=True,
              prompt="a photo of (six sheep:1.3) on a [meadow]"), True),
    ]


def phase_features(fa, ca, kg, HarmonyPipeline):
    """Phase 12: the sampler zoo and the edit's features at full width on
    phase 5's SDXL bf16 pipeline (the same seed), then one SD1.5 512²
    DPM++ edit: each configuration one key, run by ``edit_modes`` (the
    replayed generate() bit-identical to the eager module functions, one
    capture and then none, the replayed launches by kernel name equal to
    the eager run's), its launches against what the UNet config gives and
    its output finite; each key's programs dropped before the next key's
    capture; one eager run a key (phase 5 shows two agree), which the replay
    must equal bit for bit. Returns the replayed launches by tag."""
    t0 = time.perf_counter()
    pipe = HarmonyPipeline.random_full(seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"phase 12 built random_full in {time.perf_counter() - t0:.1f} s; its keys run "
          f"{FEATURE_STEPS} steps, not {FULL_STEPS}: the path's depth is cut to keep the script "
          f"within its time", flush=True)
    img, base = _full_edit()
    base["num_inference_steps"] = FEATURE_STEPS
    init = np.random.default_rng(12).integers(0, 255, (1024, 1024, 3), dtype=np.uint8)
    mask = np.zeros((1024, 1024), np.uint8)
    mask[256:768, 256:768] = 255
    out, handoff = {}, None

    def run(pipe, tag, what, kw, image, steps, per_run, ip_per_run, k_self="K1", size=1024):
        first = None
        if kw.get("encoder_interval", 1) > 1:  # a key and a reuse step, warmed up and captured
            both = SELF_ATTN_PER_UNET_CALL + SDXL_REUSE_PER_UNET_CALL
            first = {"K1": 2 * both, "K4": 0, "K2": 2 * both,
                     "K2 IP": 2 * SDXL_IP_CROSS_PER_UNET_CALL, "K5": 2 * both}
        r = edit_modes(pipe, image, kw, fa, ca, kg, f"phase 12 {tag}", run_steps=steps,
                       first_call=first, eager_runs=1)
        n, g, res = r["launches"], r["generate"], r["replay"]
        latent = kw.get("output_type") == "latent" or kw.get("denoising_end") is not None
        shape = (1, size // 8, size // 8, 4) if latent else (1, size, size, 3)
        finite = bool(torch.isfinite(res).all())
        other = "K4" if k_self == "K1" else "K1"
        eager = {k_self: n[k_self], other: n[other], "K2": n["K2"], "K2 IP": n["K2 IP"],
                 "K5": n["K5"]}
        want = {k_self: per_run, other: 0, "K2": per_run, "K2 IP": ip_per_run, "K5": per_run}
        row = dict(tag=tag, what=what, steps=steps, replayed=g, eager=eager,
                   wall_s=r["replay_s"], step_ms=r["replay_step_ms"],
                   capture_s=r["capture_s"], kept_gib=r["kept_gib"])
        print(f"phase 12 {tag} ({what}): {json.dumps(row)}; shape {tuple(res.shape)}, "
              f"finite {finite}", flush=True)
        if tuple(res.shape) != shape or not finite:
            raise AssertionError(f"phase 12 {tag}: bad output: shape {tuple(res.shape)}, "
                                 f"finite {finite}")
        if eager != want or g != {"K1/K4": per_run, "K2": per_run, "K5": per_run}:
            raise AssertionError(f"phase 12 {tag}: eager launches {eager}, expected {want}; "
                                 f"replayed {g}, expected {per_run} each")
        out[tag] = g
        pipe.programs.clear()  # one key's programs on the card at a time
        gc.collect()
        torch.cuda.empty_cache()
        return res

    full, ip = SELF_ATTN_PER_UNET_CALL, SDXL_IP_CROSS_PER_UNET_CALL
    for tag, what, extra, ip_live in feature_configs(init, mask):
        kw = dict(base, **extra)
        image = kw.pop("image", img)
        if tag == "denoising_start":
            kw["latents"] = handoff
        steps = _steps_of(pipe, image, kw)
        # encoder propagation: a key step every encoder_interval-th, the
        # others reuse its encoder (SDXL_REUSE_PER_UNET_CALL blocks)
        keys = -(-steps // kw.get("encoder_interval", 1))
        per_run = keys * full + (steps - keys) * SDXL_REUSE_PER_UNET_CALL
        res = run(pipe, tag, what, kw, image, steps, per_run, keys * ip if ip_live else 0)
        if tag == "denoising_end":
            handoff = res
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    pipe = HarmonyPipeline.random_full_sd15(seed=0, device="cuda", dtype=torch.bfloat16)
    img15 = np.random.default_rng(0).integers(0, 255, (512, 512, 3), dtype=np.uint8)
    kw = dict(prompt="a photo of six sheep on a meadow", num_samples=1, seed=0,
              guidance_scale=5.0, height=512, width=512, num_inference_steps=FEATURE_STEPS,
              output_type="raw", scheduler="dpm++")
    per_run = SD15_SELF_ATTN_PER_UNET_CALL * FEATURE_STEPS
    run(pipe, "sd15_dpmpp", "SD1.5 512², DPM++ 2M", kw, img15, FEATURE_STEPS, per_run, per_run,
        k_self="K4", size=512)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


SERVE_REQUESTS = 4
SERVE_STEPS = 8  # (d)'s requests: the HTTP path, not the denoise depth, is its point
SERVE_CHUNK = 5
# (c)'s IP window: a row admitted a chunk after another runs steps off the
# window while the other runs steps on it, so one replayed chunk gives K2
# rows of weight 0 and of weight 1
SERVE_IP_WINDOW = (0.1, 0.9)


def _serve_requests(n):
    """Phase 13's requests: 1024² images, prompts, extra_texts, seeds."""
    rng = np.random.default_rng(13)
    imgs = [rng.integers(0, 255, (1024, 1024, 3), dtype=np.uint8) for _ in range(n)]
    prompts = ["a photo of six sheep on a meadow", "three red apples on a table",
               "a photo of two dogs on a beach", "five birds on a wire"][:n]
    extras = ["six sheep", "three apples", "two dogs", "five birds"][:n]
    return imgs, prompts, extras, [11 + i for i in range(n)]


def _reserved(dev):
    """Bytes the allocator reserves on ``dev`` after empty_cache()."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev)


def _kept(dev, reserved):
    """GiB reserved since ``reserved`` (both after empty_cache())."""
    return (_reserved(dev) - reserved) / 2**30


def _drop_programs(pipe):
    pipe.programs.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _serve_batch(pipe, fa, ca, kg, imgs, prompts, extras, seeds):
    """(a) generate_batch of the requests, eager and replayed."""
    from imagharmony_tpu_torch.pipelines import harmony_edit as he

    dev, n = pipe.device, len(imgs)
    kw = dict(extra_texts=extras, seeds=seeds, num_inference_steps=SERVE_DEPTH)
    _reset_launches(fa, ca, kg)
    with torch.inference_mode():
        eager, eager_s = _timed(lambda: he.edit(pipe.components, pipe.prepare_batch(
            imgs, prompts, **kw)), dev)
    eager_n = _launches(fa, ca, kg)
    reserved = _reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = pipe.programs.captures
    first, first_s = _timed(lambda: pipe.generate_batch(imgs, prompts, output_type="raw", **kw),
                            dev)
    kept = _kept(dev, reserved)
    _reset_launches(fa, ca, kg)
    timings = {}
    replay, replay_s = _timed(lambda: pipe.generate_batch(imgs, prompts, output_type="raw",
                                                          timings=timings, **kw), dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    wrapped = _launches(fa, ca, kg)
    graph = replay_launches(lambda: _timed(lambda: pipe.generate_batch(
        imgs, prompts, output_type="raw", **kw), dev), "phase 13a")
    captures = pipe.programs.captures - before
    # each request alone, on its own seed's noise: one warm-up call captures
    # the solo key, then the four timed
    solo_kw = dict(num_inference_steps=SERVE_DEPTH, output_type="raw")
    pipe.generate(imgs[0], prompt=prompts[0], extra_text=extras[0], seed=[seeds[0]], **solo_kw)
    solos, solo_s = [], 0.0
    for i in range(n):
        out, wall = _timed(lambda: pipe.generate(imgs[i], prompt=prompts[i], extra_text=extras[i],
                                                 seed=[seeds[i]], **solo_kw), dev)
        solos.append(out[0])
        solo_s += wall
    cos = [_cosine(replay[i].float(), solos[i].float()) for i in range(n)]
    row = dict(requests=n, steps=SERVE_DEPTH, eager_s=eager_s, first_s=first_s, replay_s=replay_s,
               replay_step_ms=timings["denoise_s"] / SERVE_DEPTH * 1e3,
               decode_s=timings["decode_s"], images_per_s=n / replay_s,
               solo_images_per_s=n / solo_s, solo_s=solo_s, peak_gib=peak, kept_gib=kept,
               captures=captures, replay_equals_eager=torch.equal(replay, eager),
               replay_equals_first=torch.equal(replay, first), row_cosine_vs_solo=cos,
               launches_eager=eager_n, launches_replayed=graph)
    print(f"phase 13a generate_batch of {n} requests at 1024², {SERVE_DEPTH} steps: "
          f"{json.dumps(row)}", flush=True)
    want = SELF_ATTN_PER_UNET_CALL * SERVE_DEPTH
    if tuple(replay.shape) != (n, 1024, 1024, 3) or not bool(torch.isfinite(replay).all()):
        raise AssertionError(f"phase 13a: bad output {tuple(replay.shape)}")
    if not (row["replay_equals_eager"] and row["replay_equals_first"]):
        raise AssertionError("phase 13a: the replayed generate_batch differs from the eager run "
                             "or from the first call")
    if min(cos) < TINY_MIN_COSINE:
        raise AssertionError(f"phase 13a: a packed row differs from its solo generate(): {cos}")
    if graph != {"K1/K4": want, "K2": want, "K5": want} or any(wrapped.values()) \
            or captures != 1 or eager_n["K2 IP"] != SDXL_IP_CROSS_PER_UNET_CALL * SERVE_DEPTH:
        raise AssertionError(f"phase 13a: replayed launches {graph} (expected {want} each), "
                             f"wrapper launches {wrapped}, captures {captures}, eager {eager_n}")
    return row


def _serve_lru(pipe):
    """A key past the cache's bound is evicted and its memory returned."""
    from imagharmony_tpu_torch.pipelines import programs

    dev = pipe.device
    n_keys = len(pipe.programs)
    reserved = _reserved(dev)
    evictions = pipe.programs.evictions
    pipe.programs.resize(n_keys - 1)
    freed = -_kept(dev, reserved)
    pipe.programs.resize(programs.DEFAULT_CAPACITY)
    row = dict(keys_before=n_keys, keys_after=len(pipe.programs),
               evicted=pipe.programs.evictions - evictions, freed_gib=freed)
    print(f"phase 13 cache bound {n_keys - 1}: {json.dumps(row)}", flush=True)
    if row["evicted"] != 1 or row["keys_after"] != n_keys - 1 or freed <= 0.5:
        raise AssertionError(f"phase 13: eviction did not return the key's memory: {row}")
    return row


def _serve_chunked(pipe, img, prompt, extra):
    """(b) generate_chunked, 2 samples, chunk 5, against generate()."""
    dev = pipe.device
    kw = dict(prompt=prompt, extra_text=extra, num_samples=2, seed=0,
              num_inference_steps=SERVE_DEPTH, output_type="raw")
    reserved = _reserved(dev)
    pipe.generate(img, **kw)  # captures the two-sample key
    generate_kept = _kept(dev, reserved)
    # timed twice: the first warm call follows the allocator's empty_cache()
    ref, first_ref_s = _timed(lambda: pipe.generate(img, **kw), dev)
    ref_again, ref_s = _timed(lambda: pipe.generate(img, **kw), dev)
    reserved = _reserved(dev)
    seen = []
    first, first_s = _timed(lambda: pipe.generate(
        img, chunk_steps=SERVE_CHUNK, callback_on_step_end=lambda i, _: seen.append(i), **kw),
        dev)
    kept = _kept(dev, reserved)
    out, out_s = _timed(lambda: pipe.generate(img, chunk_steps=SERVE_CHUNK, **kw), dev)
    graph = replay_launches(lambda: _timed(lambda: pipe.generate(
        img, chunk_steps=SERVE_CHUNK, **kw), dev), "phase 13b")
    diff = float((out.float() - ref.float()).abs().max())
    row = dict(samples=2, chunk=SERVE_CHUNK, steps=SERVE_DEPTH, first_generate_s=first_ref_s,
               generate_s=ref_s, generate_kept_gib=generate_kept, first_chunked_s=first_s,
               chunked_s=out_s, kept_gib=kept, callback_steps=seen,
               bit_identical=torch.equal(out, ref) and torch.equal(ref_again, ref),
               max_abs=diff, image_cosine=_cosine(out.float(), ref.float()),
               replays_equal=torch.equal(out, first), launches_replayed=graph)
    print(f"phase 13b generate_chunked vs generate(num_samples=2): {json.dumps(row)}", flush=True)
    want = SELF_ATTN_PER_UNET_CALL * SERVE_DEPTH
    if not (row["bit_identical"] and row["replays_equal"]):
        raise AssertionError(f"phase 13b: the chunked runner differs from generate(): {row}")
    if seen != list(range(SERVE_CHUNK, SERVE_DEPTH + 1, SERVE_CHUNK)) \
            or graph != {"K1/K4": want, "K2": want, "K5": want}:
        raise AssertionError(f"phase 13b: callback steps {seen}, launches {graph}")
    return row


def _engine_run(pipe, opts, jobs, admit_at):
    """A 4-slot engine: ``jobs`` [(token, admit kwargs)], job j admitted
    before chunk ``admit_at[j]``; until all are harvested. -> ({token:
    (uint8 image, its final latents)}, [slot steps at each admission],
    seconds a chunk, the engine)."""
    from imagharmony_tpu_torch.pipelines import continuous

    eng = continuous.SlotEngine(pipe, opts, slots=SERVE_REQUESTS, chunk=SERVE_CHUNK)
    out, at_admit, chunk_s, slot_of = {}, [], [], {}
    for c in range(4 * SERVE_DEPTH):
        for (tok, kw), when in zip(jobs, admit_at):
            if when == c:
                at_admit.append(eng.progress().tolist())
                slot_of[tok] = eng.admit(tok, **kw)
        steps = eng.progress()
        for tok, i in slot_of.items():  # the finished rows' latents, before harvest
            if tok not in out and steps[i] >= eng.num_steps:
                out[tok] = [None, eng.latents[i].clone()]
        for tok, img in eng.harvest():
            out[tok][0] = img
        if len(out) == len(jobs) and all(v[0] is not None for v in out.values()):
            break
        _, wall = _timed(eng.run_chunk, pipe.device)
        chunk_s.append(wall)
    return out, at_admit, statistics.median(chunk_s[1:] or chunk_s), eng


def _serve_engine(pipe, img, prompts, extras, seeds):
    """(c) a 4-slot engine with a mid-flight admission, against B's solo
    engine run, under an IP window that gives the rows of one chunk
    different weights."""
    from imagharmony_tpu_torch.pipelines import harmony_edit as he

    dev = pipe.device
    opts = he.EditOptions(num_inference_steps=SERVE_DEPTH, guidance_scale=5.0, use_harmony=True,
                          control_guidance_start=SERVE_IP_WINDOW[0],
                          control_guidance_end=SERVE_IP_WINDOW[1])
    # the IP weight of each row at each step of the chunk the second row
    # joins: the first row at steps 5-9, the second at 0-4
    ip = he.schedule_for(opts)[1]
    chunk_weights = [[float(ip[SERVE_CHUNK + j]), float(ip[j])] for j in range(SERVE_CHUNK)]
    if all(a == b for a, b in chunk_weights):
        raise AssertionError(f"phase 13c: the window gives both rows one weight: {chunk_weights}")
    jobs = [(f"r{i}", dict(pil_image=img, prompt=prompts[i], extra_text=extras[i],
                           seed=seeds[i])) for i in range(2)]
    reserved = _reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    both, at_admit, chunk_s, eng = _engine_run(pipe, opts, jobs, [0, 1])
    eng.close()
    kept = _kept(dev, reserved)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    solo, _, _, solo_eng = _engine_run(pipe, opts, jobs[1:], [0])
    # one chunk's replayed launches, every slot frozen
    graph = replay_launches(lambda: _timed(solo_eng.run_chunk, dev), "phase 13c")
    solo_eng.close()
    b = jobs[1][0]
    row = dict(slots=SERVE_REQUESTS, chunk=SERVE_CHUNK, steps=SERVE_DEPTH,
               slot_steps_at_admission=at_admit, chunk_s=chunk_s,
               step_ms=chunk_s / SERVE_CHUNK * 1e3, kept_gib=kept, peak_gib=peak,
               ip_window=SERVE_IP_WINDOW, ip_weights_of_the_rows_in_chunk_1=chunk_weights,
               latents_bit_identical=torch.equal(both[b][1], solo[b][1]),
               image_bit_identical=bool(np.array_equal(both[b][0], solo[b][0])),
               launches_per_chunk=graph)
    print(f"phase 13c 4-slot engine, {b} admitted mid-flight vs its solo engine run: "
          f"{json.dumps(row)}", flush=True)
    want = SELF_ATTN_PER_UNET_CALL * SERVE_CHUNK
    if not (row["latents_bit_identical"] and row["image_bit_identical"]):
        raise AssertionError(f"phase 13c: the mid-flight row differs from its solo run: {row}")
    if at_admit[1][0] != SERVE_CHUNK or graph != {"K1/K4": want, "K2": want, "K5": want}:
        raise AssertionError(f"phase 13c: admission steps {at_admit}, launches {graph}")
    return row


def _serve_http(pipe, imgs, prompts, extras, seeds):
    """(d) both workers through make_server on localhost: six requests of
    two batch keys (guidance 5 and 4), SERVE_STEPS steps."""
    import base64
    import io
    import threading
    import urllib.request

    from PIL import Image

    from imagharmony_tpu_torch.pipelines import serving

    def b64(a):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    payloads = [dict(image=b64(imgs[i % 3]), prompt=prompts[i % 3], extra_text=extras[i % 3],
                     seed=seeds[0] + i, steps=SERVE_STEPS, height=1024, width=1024,
                     guidance_scale=5.0 if i < 3 else 4.0) for i in range(6)]
    rows = {}
    for mode in ("packed", "continuous"):
        kw = dict(max_batch=SERVE_REQUESTS, chunk=2) if mode == "continuous" \
            else dict(max_batch=SERVE_REQUESTS, max_wait_s=1.0)
        srv = serving.make_server(pipe, 0, continuous=mode == "continuous", host="127.0.0.1",
                                  **kw)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        results, statuses = [None] * 6, []

        def post(i):
            req = urllib.request.Request(url + "/edit", data=json.dumps(payloads[i]).encode(),
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    results[i] = (r.status, json.loads(r.read()))
            except urllib.error.HTTPError as e:
                results[i] = (e.code, json.loads(e.read()))

        def status():
            with urllib.request.urlopen(url + "/status", timeout=60) as r:
                return json.loads(r.read())

        try:
            t0 = time.perf_counter()
            posts = [threading.Thread(target=post, args=(i,)) for i in range(6)]
            if mode == "continuous":  # the first alone, the next once it is mid-flight
                posts[0].start()
                deadline = time.time() + 300
                while time.time() < deadline:
                    st = status()
                    statuses.append(st)
                    if any(s for s in st.get("slot_steps") or [] if s):
                        break
                    time.sleep(0.02)
                for p in posts[1:]:
                    p.start()
            else:
                for p in posts[:3]:
                    p.start()
                time.sleep(0.2)
                for p in posts[3:]:
                    p.start()
            while any(p.is_alive() for p in posts):
                statuses.append(status())
                time.sleep(0.05)
            wall = time.perf_counter() - t0
            worker = srv.worker
            rows[mode] = dict(requests=6, steps=SERVE_STEPS, wall_s=wall,
                              answered=[r[0] for r in results],
                              batched=[r[1].get("batched") for r in results],
                              pack_errors=worker.pack_errors,
                              mid_flight_statuses=[st["slot_steps"] for st in statuses
                                                   if sum(s is not None for s in
                                                          st.get("slot_steps") or []) > 1
                                                   and any(st["slot_steps"])][:3],
                              admissions=[m for _, m in getattr(worker, "admissions", [])])
            sizes = {Image.open(io.BytesIO(base64.b64decode(r[1]["image"]))).size
                     for r in results if r[0] == 200}
        finally:
            srv.shutdown()
            srv.worker.stop(60)
            srv.server_close()
        print(f"phase 13d {mode} server: {json.dumps(rows[mode])}", flush=True)
        if rows[mode]["answered"] != [200] * 6 or sizes != {(1024, 1024)} \
                or rows[mode]["pack_errors"] or srv.worker.is_alive():
            raise AssertionError(f"phase 13d {mode}: {rows[mode]}, sizes {sizes}")
        if mode == "packed" and max(b or 1 for b in rows[mode]["batched"]) < 2:
            raise AssertionError(f"phase 13d packed: no request was packed: {rows[mode]}")
        if mode == "continuous" and (not rows[mode]["mid_flight_statuses"]
                                     or not any(rows[mode]["admissions"])):
            raise AssertionError(f"phase 13d continuous: no mid-flight admission: {rows[mode]}")
    return rows


def phase_serve(fa, ca, kg, HarmonyPipeline):
    """Phase 13: the serving path at full width on a fresh SDXL bf16
    random_full(0): (a) generate_batch of four requests, (b) the chunked
    runner against generate(), (c) a 4-slot engine with a mid-flight
    admission, (d) both workers through make_server on localhost; between
    them the cache's eviction. Returns the replayed launches by path."""
    t0 = time.perf_counter()
    pipe = HarmonyPipeline.random_full(seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"phase 13 runs (a)-(c) at {SERVE_DEPTH} steps, not {FULL_STEPS}: the path's depth is "
          f"cut to keep the script within its time", flush=True)
    print(f"phase 13 built random_full in {time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated(pipe.device) / 2**30:.3f} GiB allocated of the card's "
          f"{torch.cuda.get_device_properties(pipe.device).total_memory / 2**30:.3f} GiB; the "
          f"program cache keeps {pipe.programs.capacity} keys", flush=True)
    imgs, prompts, extras, seeds = _serve_requests(SERVE_REQUESTS)
    a = _serve_batch(pipe, fa, ca, kg, imgs, prompts, extras, seeds)
    lru = _serve_lru(pipe)
    _drop_programs(pipe)
    b = _serve_chunked(pipe, imgs[0], prompts[0], extras[0])
    _drop_programs(pipe)
    c = _serve_engine(pipe, imgs[0], prompts, extras, seeds)
    _drop_programs(pipe)
    d = _serve_http(pipe, imgs, prompts, extras, seeds)
    print(f"phase 13 serving path in {time.perf_counter() - t0:.1f} s", flush=True)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return dict(batch=a, lru=lru, chunked=b, engine=c, http=d)


# phase 14: the variants at full width and the CLI
ENSEMBLE_END = 0.8  # the base's denoising_end, the refiner's denoising_start
BATCH_CN_STEPS = 10  # (b)'s two-request generate_batch with control images
FUSION_STEPS = 2  # (d)'s replayed edit with each HA fusion
FUSION_MIN_COSINE = 0.999  # (d): bf16 conditioning on the card vs fp32 on the CPU
LORA_RANK = 64
CLI_STEPS = 10  # (e)'s edits: the CLI path, not the denoise depth, is its point


def blocks_per_call(ucfg, encoder_only=False):
    """Transformer blocks (a self-attention, a cross-attention and a
    feed-forward each: one K1, one K2 and one K5 launch) in one call of a
    UNet of ``ucfg``, or of its encoder and mid block alone (a
    ControlNet's)."""
    tl = ucfg.transformer_layers_per_block
    n = tl[-1]  # the mid block
    for i, kind in enumerate(ucfg.down_block_types):
        n += ucfg.layers_per_block * tl[i] if kind == "CrossAttnDownBlock2D" else 0
    if not encoder_only:
        for i, kind in enumerate(ucfg.up_block_types):
            if kind == "CrossAttnUpBlock2D":
                n += (ucfg.layers_per_block + 1) * tl[len(ucfg.block_out_channels) - 1 - i]
    return n


def _steps_of(pipe, img, kw):
    """The denoise steps generate(img, **kw) runs (the handoff cuts them)."""
    with torch.inference_mode():
        return pipe.prepare(img, **kw).schedule.num_steps


def _weights_gib(module):
    return sum(p.numel() * p.element_size() for p in module.parameters()) / 2**30


def _eager_counts(r, steps, blocks, ip_blocks, label):
    """Fails unless the eager run launched ``blocks`` K1, K2 and K5 a step
    (``ip_blocks`` of the K2 with the IP branch) and no K4."""
    want = {"K1": steps * blocks, "K4": 0, "K2": steps * blocks, "K2 IP": steps * ip_blocks,
            "K5": steps * blocks}
    if r["launches"] != want:
        raise AssertionError(f"{label}: the eager run launched {r['launches']}, the configs give "
                             f"{want}")


def _random_controlnet(comp, ucfg, seed):
    """A ControlNet on ``ucfg`` in bf16 on the card, random from ``seed``,
    its output convs drawn too (a fresh one is an exact no-op)."""
    from imagharmony_tpu_torch.models import controlnet as cn_lib

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("meta"):
        cn = cn_lib.ControlNetModel(cn_lib.ControlNetConfig(base=ucfg), dtype=torch.bfloat16)
    cn = comp.init_weights_(cn.to_empty(device="cuda"), gen)
    with torch.no_grad():
        for conv in cn.output_convs():
            bound = conv.weight[0].numel() ** -0.5
            conv.weight.uniform_(-bound, bound, generator=gen)
            conv.bias.uniform_(-bound, bound, generator=gen)
    return cn


def _random_lora(unet, seed, lora_lib):
    """Rank-64 factors on every to_q, to_k, to_v and to_out of ``unet``,
    B drawn N(0, 0.1²) (a fresh LoRA's B is zero: an exact no-op)."""
    cfg = lora_lib.LoRAConfig(rank=LORA_RANK, alpha=LORA_RANK / 2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    factors = lora_lib.init_lora(gen, unet, cfg)
    for k, v in factors.items():
        if k.endswith(".lora_b"):
            v.normal_(0.0, 0.1, generator=gen)
    return factors, cfg


def phase_variants(fa, ca, kg, comp, HarmonyPipeline):
    """Phase 14 (a)-(d): the ensemble, ControlNet, LoRA and the HA fusions at
    full width on a fresh SDXL bf16 random_full(0). Returns the replayed
    launches by path and what was measured."""
    from imagharmony_tpu_torch.adapters import harmony as ha_lib
    from imagharmony_tpu_torch.adapters import lora as lora_lib
    from imagharmony_tpu_torch.pipelines import harmony_edit as he

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    base = HarmonyPipeline.random_full(seed=0, device="cuda", dtype=torch.bfloat16)
    refiner = HarmonyPipeline.random_full_refiner(seed=0, device="cuda")
    torch.cuda.synchronize()
    w_base, w_ref = _weights_gib(base.components), _weights_gib(refiner.components)
    print(f"phase 14a built random_full and random_full_refiner in {time.perf_counter() - t0:.1f} "
          f"s: weights {w_base:.3f} GiB and {w_ref:.3f} GiB ({refiner.cfgs.unet.block_out_channels}"
          f", heads {refiner.cfgs.unet.num_attention_heads}, context "
          f"{refiner.cfgs.unet.cross_attention_dim}, add-embedding "
          f"{refiner.cfgs.unet.projection_class_embeddings_input_dim})", flush=True)
    out = {}
    img, kw = _full_edit()
    sdxl_blocks = blocks_per_call(base.cfgs.unet)
    ref_blocks = blocks_per_call(refiner.cfgs.unet)

    # (a) the ensemble: the base to denoising_end, the refiner from its latents
    bkw = dict(kw, denoising_end=ENSEMBLE_END)
    steps_b = _steps_of(base, img, bkw)
    # one eager run a key, which the replay must equal bit for bit (phase 5
    # shows two agree), as in phase 12
    rb = edit_modes(base, img, bkw, fa, ca, kg, "phase 14a ensemble base", run_steps=steps_b,
                    eager_runs=1)
    _eager_counts(rb, steps_b, sdxl_blocks, SDXL_IP_CROSS_PER_UNET_CALL, "phase 14a base")
    lat = rb["replay"]
    rkw = dict(prompt=kw["prompt"], num_inference_steps=FULL_STEPS, guidance_scale=5.0, seed=0,
               latents=lat, denoising_start=ENSEMBLE_END, output_type="raw")
    steps_r = _steps_of(refiner, None, rkw)
    rr = edit_modes(refiner, None, rkw, fa, ca, kg, "phase 14a ensemble refiner",
                    run_steps=steps_r, eager_runs=1)
    _eager_counts(rr, steps_r, ref_blocks, 0, "phase 14a refiner")
    image = rr["replay"]
    if tuple(image.shape) != (1, 1024, 1024, 3) or not torch.isfinite(image).all():
        raise AssertionError(f"phase 14a: the refiner's image is {tuple(image.shape)}, finite "
                             f"{bool(torch.isfinite(image).all())}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # the CLI's ensemble makes one call a pipeline: one key in each cache
    budget = peak + rb["kept_gib"] + rr["kept_gib"]
    print(f"phase 14a ensemble 1024², {FULL_STEPS} Euler steps, CFG 5.0, handoff at "
          f"{ENSEMBLE_END}: base {steps_b} steps {rb['replay_step_ms']:.3f} ms a step replayed, "
          f"its key keeps {rb['kept_gib']:.3f} GiB; refiner {steps_r} steps "
          f"{rr['replay_step_ms']:.3f} ms a step ({ref_blocks} transformer blocks a UNet call), "
          f"its key keeps {rr['kept_gib']:.3f} GiB; replayed launches base {rb['generate']}, "
          f"refiner {rr['generate']}; peak allocated {peak:.2f} GiB with both pipelines; with "
          f"the one key each that the CLI's ensemble keeps: {budget:.2f} GiB of the card's "
          f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f} GiB", flush=True)
    out["ensemble_base"], out["ensemble_refiner"] = rb["generate"], rr["generate"]
    out["refiner_step_ms"], out["refiner_kept_gib"] = rr["replay_step_ms"], rr["kept_gib"]
    _drop_programs(refiner)
    del refiner, rr, lat, image
    _drop_programs(base)

    # (b) ControlNet at the base's widths: its residuals in every step
    cn = _random_controlnet(comp, base.cfgs.unet, 1)
    cpipe = base.with_controlnet(cn)
    cn_blocks = blocks_per_call(base.cfgs.unet, encoder_only=True)
    rng = np.random.default_rng(14)
    ctrl = rng.integers(0, 255, (1024, 1024, 3), dtype=np.uint8)
    ckw = dict(kw, control_image=ctrl)
    rc = edit_modes(cpipe, img, ckw, fa, ca, kg, "phase 14b ControlNet", eager_runs=1)
    _eager_counts(rc, FULL_STEPS, sdxl_blocks + cn_blocks, SDXL_IP_CROSS_PER_UNET_CALL,
                  "phase 14b ControlNet")
    with torch.inference_mode():
        plain = cpipe.generate(img, **kw)  # the same call without a control image
    moved = float((plain.float() - rc["replay"].float()).abs().mean())
    _drop_programs(cpipe)
    imgs = [img, rng.integers(0, 255, (768, 1024, 3), dtype=np.uint8)]
    ctrls = [ctrl, rng.integers(0, 255, (512, 512, 3), dtype=np.uint8)]
    bkw2 = dict(num_inference_steps=BATCH_CN_STEPS, seeds=[1, 2], control_images=ctrls,
                extra_texts=["six sheep", "two dogs"])
    prompts = [kw["prompt"], "two dogs on a sofa"]
    with torch.inference_mode():
        eager = he.edit(cpipe.components, cpipe.prepare_batch(imgs, prompts, **bkw2))
    first, first_s = _timed(lambda: cpipe.generate_batch(imgs, prompts, output_type="raw",
                                                         **bkw2), dev)
    again, again_s = _timed(lambda: cpipe.generate_batch(imgs, prompts, output_type="raw",
                                                         **bkw2), dev)
    batch_same = torch.equal(first, again) and torch.equal(again, eager)
    print(f"phase 14b ControlNet ({cn_blocks} transformer blocks, weights "
          f"{_weights_gib(cn):.3f} GiB, output convs drawn): replayed launches {rc['generate']}, "
          f"{rc['replay_step_ms']:.3f} ms a step replayed, its key keeps {rc['kept_gib']:.3f} GiB; "
          f"the control image moves the image by {moved:.4f} mean abs; a 2-request "
          f"generate_batch with control images, {BATCH_CN_STEPS} steps: first call (capture) "
          f"{first_s:.2f} s, replay {again_s:.2f} s, bit-identical to its eager run "
          f"{batch_same}", flush=True)
    if moved < 1e-3:
        raise AssertionError(f"phase 14b: the ControlNet's residuals do not change the image "
                             f"({moved})")
    if not batch_same:
        raise AssertionError("phase 14b: generate_batch with control images does not replay its "
                             "eager run bit for bit")
    out["controlnet"], out["cn_step_ms"], out["cn_kept_gib"] = (
        rc["generate"], rc["replay_step_ms"], rc["kept_gib"])
    _drop_programs(cpipe)
    del cpipe, cn, rc, plain, eager, first, again

    # (c) LoRA merged into the base's UNet
    factors, lcfg = _random_lora(base.components.unet, 2, lora_lib)
    lpipe = base.with_lora(factors, lora_cfg=lcfg)
    worst, n = 0.0, 0
    for key in sorted(k[: -len(".lora_a")] for k in factors if k.endswith(".lora_a")):
        path = key.split(".")
        old, rows = lora_lib._row_slice(base.components.unet.get_submodule(
            ".".join(path[:-2])), path[-2])
        new, _ = lora_lib._row_slice(lpipe.components.unet.get_submodule(
            ".".join(path[:-2])), path[-2])
        want = old.weight[rows].float() + lcfg.scale * (
            factors[key + ".lora_a"] @ factors[key + ".lora_b"]).T
        err = (new.weight[rows].float() - want).abs()
        # one bf16 rounding of the fp32 sum: within 2^-8 of it, relative
        # (bf16 keeps 8 significant bits)
        if not bool((err <= 2 ** -8 * want.abs()).all()):
            raise AssertionError(f"phase 14c: the merged {key} is not W + (alpha/r)·A·B in fp32 "
                                 f"to bf16 rounding")
        worst = max(worst, float((err / want.abs().clamp_min(2 ** -126)).max()))
        n += 1
        if new.weight is old.weight:
            raise AssertionError(f"phase 14c: {key} merged into the base's own tensor")
    rl = edit_modes(lpipe, img, kw, fa, ca, kg, "phase 14c LoRA", eager_runs=1)
    _eager_counts(rl, FULL_STEPS, sdxl_blocks, SDXL_IP_CROSS_PER_UNET_CALL, "phase 14c LoRA")
    print(f"phase 14c LoRA rank {LORA_RANK}, alpha {lcfg.alpha} on {n} projections "
          f"({lora_lib.num_params(factors) / 1e6:.1f} M factors): merged weights against "
          f"W + (alpha/r)·A·B in fp32, worst relative error {worst:.3e} (bf16 rounding "
          f"{2 ** -8:.3e}); replayed launches {rl['generate']}", flush=True)
    if n != 4 * 2 * sdxl_blocks:
        raise AssertionError(f"phase 14c: {n} projections merged, the config has "
                             f"{4 * 2 * sdxl_blocks}")
    out["lora"] = rl["generate"]
    _drop_programs(lpipe)
    del lpipe, factors, rl

    # (d) the HA fusions, each swapped into the base at the shipped dims
    fkw = dict(kw, num_inference_steps=FUSION_STEPS)
    with torch.inference_mode():
        ids = base._ids(kw["prompt"], kw["extra_text"])
        ctx, _ = he.encode_texts(base.components, ids["extra_l"], ids["extra_g"])
        emb = base.components.image_encoder(base._pixel_values(img))["projected"]
    proj_cpu = copy.deepcopy(base.components.image_proj).to(device="cpu", dtype=torch.float32)
    out["fusions"] = {}
    for i, fusion in enumerate(("qformer", "mlp", "gated-attention")):
        hcfg = dataclasses.replace(base.cfgs.harmony, fusion_method=fusion)
        with torch.device("meta"):
            ha = ha_lib.HarmonyAttention(hcfg, dtype=torch.float32)
        ha = comp.init_weights_(ha.to_empty(device="cpu"), torch.Generator().manual_seed(i))
        ha_card = copy.deepcopy(ha).to(device="cuda", dtype=torch.bfloat16).eval()
        with torch.inference_mode():
            card = base.components.image_proj(ha_lib.fuse_image_embeds(ha_card, ctx, emb))
            cpu = proj_cpu(ha_lib.fuse_image_embeds(ha, ctx.float().cpu(), emb.float().cpu()))
        cos = _cosine(card.float().cpu(), cpu)
        fpipe = base._clone(dataclasses.replace(base.cfgs, harmony=hcfg),
                            harmony=ha_card.requires_grad_(False))
        rf = edit_modes(fpipe, img, fkw, fa, ca, kg, f"phase 14d HA {fusion}", eager_runs=1)
        print(f"phase 14d HA {fusion} (flattened {hcfg.flattened_dim}, "
              f"{sum(p.numel() for p in ha.parameters()) / 1e6:.2f} M parameters): the image "
              f"prompt's tokens bf16 on the card vs fp32 on the CPU cosine {cos:.6f}; replayed "
              f"{FUSION_STEPS}-step edit {rf['generate']}", flush=True)
        if cos < FUSION_MIN_COSINE:
            raise AssertionError(f"phase 14d: the {fusion} fusion's conditioning on the card "
                                 f"disagrees with the CPU's ({cos})")
        out["fusions"][fusion] = rf["generate"]
        _drop_programs(fpipe)
        del fpipe, ha_card, rf
    print(f"phase 14a-d variants in {time.perf_counter() - t0:.1f} s", flush=True)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_cli(root, adapter, comp, HarmonyPipeline):
    """Phase 14 (e): the CLI (``imagharmony_tpu_torch.cli.main``) on phase
    11's tree before it is removed: one ``edit`` with a rank-64 LoRA, a
    ControlNet directory, a control image, ``--refiner-dir`` (a full-width
    random refiner written as a tree: the ensemble) and the IP attention
    maps; ``demo``; ``serve --lora``'s arguments through the server
    ``serving.main`` runs (``build_server``) answering one request. Each command must
    exit 0 and write its files; prints each one's wall time, its loads
    included."""
    import threading
    import urllib.request

    from PIL import Image

    from imagharmony_tpu_torch import cli
    from imagharmony_tpu_torch.adapters import lora as lora_lib
    from imagharmony_tpu_torch.io import checkpoints as ckpt_io
    from imagharmony_tpu_torch.models import tokenizer as tok_lib
    from imagharmony_tpu_torch.models import unet as unet_lib
    from imagharmony_tpu_torch.pipelines import serving

    label = "phase 14e CLI"
    work = os.path.join(root, "cli")
    os.makedirs(work)
    t0 = time.perf_counter()
    cfgs = comp.sdxl_configs()
    rng = np.random.default_rng(15)
    inp, ctrl = os.path.join(work, "in.png"), os.path.join(work, "ctrl.png")
    Image.fromarray(rng.integers(0, 255, (768, 768, 3), dtype=np.uint8)).save(inp)
    Image.fromarray(rng.integers(0, 255, (1024, 1024, 3), dtype=np.uint8)).save(ctrl)
    cn_dir = os.path.join(work, "controlnet")
    cn_bytes = ckpt_io.save_controlnet(cn_dir, _random_controlnet(comp, cfgs.unet, 3))
    with torch.device("meta"):
        meta_unet = unet_lib.UNet2DConditionModel(cfgs.unet)
    factors, lcfg = _random_lora(meta_unet, 4, lora_lib)
    lora = os.path.join(work, "lora.safetensors")
    lora_lib.save_lora(lora, factors, lcfg)
    del factors
    rroot = os.path.join(work, "refiner")
    refiner = comp.init_params(torch.Generator(device="cuda").manual_seed(5),
                               comp.sdxl_refiner_configs(), dtype=torch.bfloat16, device="cuda")
    toy = tok_lib.build_toy_tokenizer()
    r_bytes = ckpt_io.save_tree(rroot, refiner, tokenizers=tok_lib.SDXLTokenizers(toy, toy))
    del refiner
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: wrote a ControlNet directory ({cn_bytes / 2**30:.3f} GiB), a rank-"
          f"{LORA_RANK} LoRA ({os.path.getsize(lora) / 2**30:.3f} GiB) and a refiner tree "
          f"({r_bytes / 2**30:.3f} GiB) in {time.perf_counter() - t0:.1f} s", flush=True)

    def run(argv, files):
        t = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t
        missing = [f for f in files if not os.path.exists(f)]
        print(f"{label}: {' '.join(a if not a.startswith(root) else os.path.basename(a) for a in argv)}"
              f" -> exit {rc} in {wall:.2f} s (its loads included); files written "
              f"{[os.path.basename(f) for f in files]}, missing {missing}", flush=True)
        if rc != 0 or missing:
            raise AssertionError(f"{label}: {argv[0]} exited {rc}, missing {missing}")
        gc.collect()
        torch.cuda.empty_cache()
        return wall

    # one edit takes every flag (each tree load is ~12 s): the base with the
    # merged LoRA and the ControlNet to denoising_end, the refiner from its
    # latents, the maps from the base
    walls = {}
    maps, out1 = os.path.join(work, "maps"), os.path.join(work, "edit.png")
    walls["edit"] = run(["edit", "--input", inp, "--model-dir", root, "--adapter-ckpt", adapter,
                         "--extra-text", "six sheep", "--steps", str(CLI_STEPS), "--lora",
                         f"{lora}:0.8", "--controlnet-dir", cn_dir, "--control-image", ctrl,
                         "--refiner-dir", rroot, "--attn-maps", maps, "--output", out1],
                        [out1] + [os.path.join(maps, f"ip_token_{i}.png")
                                  for i in range(cfgs.num_ip_tokens)])
    if Image.open(out1).size != (1024, 1024):
        raise AssertionError(f"{label}: {out1} is {Image.open(out1).size}")
    out3 = os.path.join(work, "demo.png")
    walls["demo"] = run(["demo", "--output", out3], [out3])

    t = time.perf_counter()
    args = cli.build_parser().parse_args(["serve", "--port", "0", "--host", "127.0.0.1",
                                          "--model-dir", root, "--adapter-ckpt", adapter,
                                          "--lora", lora])
    srv = serving.build_server(args)  # what ``cli serve`` runs until interrupted
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        body = dict(prompt="a photo of six sheep", extra_text="six sheep", steps=4, seed=1)
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/edit",
                                     method="POST", data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=600) as r:
            status, answer = r.status, json.loads(r.read())
    finally:
        srv.shutdown()
        srv.worker.stop(60)
    walls["serve"] = time.perf_counter() - t
    print(f"{label}: serve --lora (its load and merge included) answered one 4-step 1024² request "
          f"with {status} in {walls['serve']:.2f} s", flush=True)
    if status != 200 or "image" not in answer:
        raise AssertionError(f"{label}: serve answered {status}: {str(answer)[:200]}")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return walls


LORA_TRAIN_RANK = 8  # phase 15a's --lora_rank
CACHE_RECORDS = 8  # phase 15b's synthetic records, 15c's batch
CACHE_IMAGE_HW = (768, 1024)  # their size: the resize and the centre crop both work at 512²
TOWERS_SLACK = 1 << 20  # what else a collection may free beside the towers' blocks


def _lora_sizes(ucfg, lcfg, lora_lib, unet_mod):
    """(factored projections, their weights' elements, the factors'
    elements) of the UNet of ``ucfg`` under ``lcfg``, from a UNet on the
    meta device."""
    with torch.device("meta"):
        u = unet_mod.UNet2DConditionModel(ucfg)
    rows = lora_lib._targets(u, lcfg)
    return (len(rows), sum(i * o for *_, (i, o) in rows),
            sum((i + o) * lcfg.rank for *_, (i, o) in rows))


def _k3_derivation(comp, step_lib, fa, label):
    """``expected_k3_per_step`` against the K3 launches of one tiny loss
    backward on the card (bf16), plain and with LoRA on each target set."""
    cfgs = comp.tiny_configs()
    base = comp.init_params(torch.Generator(device="cuda").manual_seed(0), cfgs,
                            dtype=torch.bfloat16, device="cuda")
    batch = step_lib.to_device(step_lib.dummy_batch(cfgs, 2, 32), "cuda")
    got = {}
    for targets in (None, "to_q,to_k,to_v,to_out", "to_out", "to_v"):
        kw = {} if targets is None else dict(lora_rank=2, lora_targets=targets)
        tcfg = step_lib.TrainConfig(unet_cfg=cfgs.unet, **kw)
        comps = copy.deepcopy(base)
        state = step_lib.init_state(comps, tcfg)
        draws = step_lib.draw(torch.Generator(device="cuda").manual_seed(1), cfgs, tcfg, 2, 32)
        fa.bwd_launches = 0
        step_lib.loss_fn(comps, tcfg, batch, draws, state.factors).backward()
        torch.cuda.synchronize()
        got[targets] = (fa.bwd_launches, expected_k3_per_step(cfgs.unet, tcfg.lora_config()))
    print(f"{label}: K3 launches of a tiny loss backward by LoRA targets (counted, derived): "
          f"{got}", flush=True)
    if any(n != want for n, want in got.values()):
        raise AssertionError(f"{label}: K3 launches differ from expected_k3_per_step: {got}")


def phase_train_lora(fa, ca, kg, comp, step_lib, trainer):
    """15a: the trainer with ``--lora_rank`` LORA_TRAIN_RANK at full width
    (``--full_random``: 512², batch 1, bf16, gradient checkpointing) as
    phase 7 runs it (``train_modes``: eager and captured, the replays bit
    for bit the eager steps). K1, K2 and K5 140 launches a step, K3 as
    ``expected_k3_per_step`` derives with the targets (first checked
    against the counted launches at tiny size); dA exactly 0 and dB nonzero
    at step 1 (B starts at 0), both nonzero from step 2; the exported
    ``lora-N.safetensors`` read back bit for bit the trained factors. Prints
    the merged weights' size, the factors', the step times and what the
    program keeps. Returns the replayed step's launches by name and an eager
    step's by wrapper."""
    from imagharmony_tpu_torch.adapters import lora as lora_lib
    from imagharmony_tpu_torch.models import unet as unet_mod

    label = "phase 15a LoRA trainer"
    _k3_derivation(comp, step_lib, fa, label)
    argv = ["--full_random", "--synthetic_data", str(TRAIN_STEPS), "--lora_rank",
            str(LORA_TRAIN_RANK)]
    cfgs = comp.sdxl_configs()
    lcfg = trainer.train_config(trainer.parse_args(argv), cfgs).lora_config()
    n_proj, n_merged, n_factors = _lora_sizes(cfgs.unet, lcfg, lora_lib, unet_mod)
    expected = {"K1/K4": 2 * SELF_ATTN_PER_UNET_CALL, "K2": 2 * SDXL_CROSS_PER_UNET_CALL,
                "K5": 2 * SELF_ATTN_PER_UNET_CALL,
                "K3": expected_k3_per_step(cfgs.unet, lcfg)}
    torch.backends.cudnn.allow_tf32 = True  # the trainer's own setting, as in phase 7
    try:
        r = train_modes(argv, TRAIN_STEPS, TRAIN_STEPS - TRAIN_PROFILED + 1, fa, ca, kg,
                        step_lib, trainer, label)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    _print_train_modes(r, label)
    grads = [(e["lora_a"], e["lora_b"]) for e in r["eager"]]
    print(f"{label}: {n_proj} factored projections, merged weights {n_merged} elements "
          f"({n_merged * 2 / 2**30:.3f} GiB in bf16), factors {n_factors} elements "
          f"({n_factors * 4 / 2**20:.1f} MiB in fp32, the same again for each AdamW moment); "
          f"max |dA|, |dB| per eager step {[(f'{a:.3e}', f'{b:.3e}') for a, b in grads]}; "
          f"launches expected {expected}", flush=True)
    for e in r["eager"]:
        if not (abs(e["loss"]) < float("inf") and e["grad_norm"] > 0 and e["ip"] > 0):
            raise AssertionError(f"{label}: a non-finite loss or a zero gradient: {e}")
    if not (grads[0][0] == 0 and grads[0][1] > 0 and all(a > 0 and b > 0 for a, b in grads[1:])):
        raise AssertionError(f"{label}: expected dA = 0 and dB != 0 at step 1, both nonzero "
                             f"later: {grads}")
    if r["eager"][-1]["launches"] != expected or r["replayed"] != expected:
        raise AssertionError(f"{label}: an eager step launched {r['eager'][-1]['launches']}, a "
                             f"replayed one {r['replayed']}, expected {expected}")
    factors, fcfg = r["lora_file"]
    trained = {n[len("lora."):]: p for n, p in r["trained"].items() if n.startswith("lora.")}
    if ((fcfg.rank, fcfg.scale, fcfg.targets) != (lcfg.rank, lcfg.scale, lcfg.targets)
            or set(factors) != set(trained) or len(factors) != 2 * n_proj
            or any(not torch.equal(factors[k], trained[k].cpu()) for k in factors)):
        raise AssertionError(f"{label}: the exported factors are not the trained ones bit for "
                             f"bit ({fcfg} vs {lcfg})")
    print(f"{label}: lora-{r['final']}.safetensors read back bit for bit the trained factors "
          f"({len(factors)} tensors)", flush=True)
    return r["replayed"], r["eager"][-1]["launches"]


def _cache_records(root, n=CACHE_RECORDS):
    """``n`` random PNGs of CACHE_IMAGE_HW and their JSON records under
    ``root``; returns the JSON's path and the images."""
    from PIL import Image

    rng = np.random.default_rng(0)
    images, records = [], []
    for i in range(n):
        img = rng.integers(0, 255, (*CACHE_IMAGE_HW, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"{i}.png"))
        images.append(img)
        records.append({"image_file": f"{i}.png", "text": f"a photo of {i + 2} sheep",
                        "extra_text": f"{i + 2} sheep"})
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(records, f)
    return path, images


def phase_train_cached(fa, ca, kg, comp, step_lib, trainer, path, root):
    """15b: the trainer with ``--cache_encoders`` on ``path``, a JSON dataset
    of CACHE_RECORDS PNGs under ``root`` (CACHE_IMAGE_HW, resized and
    centre-cropped to 512²) at full width, as phase 7 runs it
    (``train_modes``, each run precomputing the cache and dropping the four
    towers): the precompute's seconds; the memory allocated before and
    after the drop, whose fall must be at least the towers' bytes from
    their numel and dtype and, to TOWERS_SLACK, the allocator's blocks
    that hold them (each rounded to 512 B; a large one keeps the rest of
    its segment when that is under 1 MiB); the replays
    bit for bit the eager steps; phase 7's launches (140 K1, K2, K5; K3 as
    the UNet config gives). Returns the replayed step's launches by name and
    an eager step's by wrapper."""
    from imagharmony_tpu_torch.train import cache as cache_lib

    label = "phase 15b cached-encoder trainer"
    argv = ["--full_random", "--data_json_file", path, "--data_root_path", root,
            "--cache_encoders"]
    expected = {"K1/K4": 2 * SELF_ATTN_PER_UNET_CALL, "K2": 2 * SDXL_CROSS_PER_UNET_CALL,
                "K5": 2 * SELF_ATTN_PER_UNET_CALL,
                "K3": expected_k3_per_step(comp.sdxl_configs().unet)}
    watched = []
    precompute, drop = cache_lib.precompute, cache_lib.drop_towers

    def precompute_watched(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = precompute(*a, **kw)
        torch.cuda.synchronize()
        watched.append({"precompute_s": time.perf_counter() - t0})
        return out

    def drop_watched(comps):
        gc.collect()
        torch.cuda.synchronize()
        ptrs = {t.untyped_storage().data_ptr() for name in cache_lib.TOWERS
                for m in [getattr(comps, name)] for t in [*m.parameters(), *m.buffers()]}
        blocks = _block_bytes(ptrs)
        before = torch.cuda.memory_allocated()
        freed = drop(comps)
        gc.collect()
        torch.cuda.synchronize()
        watched[-1].update(before=before, after=torch.cuda.memory_allocated(), towers=freed,
                           blocks=sum(blocks.values()), missing=len(ptrs) - len(blocks))
        return freed

    cache_lib.precompute, cache_lib.drop_towers = precompute_watched, drop_watched
    torch.backends.cudnn.allow_tf32 = True
    try:
        r = train_modes(argv, TRAIN_STEPS, TRAIN_STEPS - TRAIN_PROFILED + 1, fa, ca, kg,
                        step_lib, trainer, label)
    finally:
        cache_lib.precompute, cache_lib.drop_towers = precompute, drop
        torch.backends.cudnn.allow_tf32 = False
    _print_train_modes(r, label)
    for w in watched:
        fell = w["before"] - w["after"]
        print(f"{label}: precompute of {CACHE_RECORDS} records {w['precompute_s']:.3f} s; "
              f"allocated before the drop {w['before'] / 2**30:.3f} GiB, after "
              f"{w['after'] / 2**30:.3f} GiB, fell {fell} bytes ({fell / 2**30:.4f} GiB); the "
              f"towers {w['towers']} bytes by numel ({w['towers'] / 2**30:.4f} GiB), "
              f"{w['blocks']} bytes in the allocator's blocks (fall - blocks "
              f"{fell - w['blocks']} bytes, blocks - numel bytes "
              f"{w['blocks'] - w['towers']})", flush=True)
        if w["missing"] or fell < w["towers"] or not 0 <= fell - w["blocks"] <= TOWERS_SLACK:
            raise AssertionError(f"{label}: the drop freed {fell} bytes, the towers hold "
                                 f"{w['towers']} in {w['blocks']} bytes of blocks "
                                 f"({w['missing']} storages not found)")
    if len(watched) < 2:
        raise AssertionError(f"{label}: {len(watched)} precomputes, expected one a run")
    for e in r["eager"]:
        if not (abs(e["loss"]) < float("inf") and e["grad_norm"] > 0 and e["ip"] > 0
                and e["harmony"] > 0):
            raise AssertionError(f"{label}: a non-finite loss or a zero gradient: {e}")
    if r["eager"][-1]["launches"] != expected or r["replayed"] != expected:
        raise AssertionError(f"{label}: an eager step launched {r['eager'][-1]['launches']}, a "
                             f"replayed one {r['replayed']}, expected {expected}")
    return r["replayed"], r["eager"][-1]["launches"]


def _block_bytes(ptrs):
    """{address: size} of the caching allocator's blocks that start at one
    of ``ptrs`` (``torch.cuda.memory_snapshot``)."""
    sizes = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for blk in seg["blocks"]:
            addr = blk.get("address", addr)
            if addr in ptrs and blk["state"] == "active_allocated":
                sizes[addr] = blk["size"]
            addr += blk["size"]
    return sizes


def phase_binding(images):
    """15c: the image-ops binding (``native.py``, host C++ built with g++)
    on phase 15b's CACHE_RECORDS images as one batch, resized and
    centre-cropped to 512² as the dataset does: one thread and the default
    bit for bit, within ``tests/test_native.py``'s tolerance of the PIL
    version; their host times, median of three."""
    from imagharmony_tpu_torch import native

    size = 512
    h, w = CACHE_IMAGE_HW
    nh, nw = round(h * size / min(h, w)), round(w * size / min(h, w))
    kw = dict(tops=[(nh - size) // 2] * len(images), lefts=[(nw - size) // 2] * len(images),
              mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
    from imagharmony_tpu_torch.kernels import build

    built = build.host_library_path("image_ops").exists()  # by 15b's dataset
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    out = native.batch_preprocess(images, size, **kw)
    one = native.batch_preprocess(images, size, num_threads=1, **kw)
    plain = native.batch_preprocess_plain(images, size, **kw)
    err = np.abs(out - plain)

    def timed(fn):
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t)
        return statistics.median(walls)

    t_cpp = timed(lambda: native.batch_preprocess(images, size, **kw))
    t_one = timed(lambda: native.batch_preprocess(images, size, num_threads=1, **kw))
    t_pil = timed(lambda: native.batch_preprocess_plain(images, size, **kw))
    print(f"phase 15c image-ops binding (host code, not a device kernel; {os.cpu_count()} host "
          f"CPUs): {'load (built before)' if built else 'build and load'} {build_s:.3f} s; a batch of {len(images)} {w}x{h} -> "
          f"{size}²: C++ {t_cpp:.4f} s ({min(len(images), os.cpu_count() or 1)} threads), "
          f"C++ one thread {t_one:.4f} s, PIL {t_pil:.4f} s; vs PIL max abs {err.max():.4e}, "
          f"median {np.median(err):.4e}, mean {err.mean():.4e}", flush=True)
    if not (np.array_equal(out, one) and np.median(err) < 0.02 and err.mean() < 0.05):
        raise AssertionError("phase 15c: the binding's threads disagree or it is far from PIL")


def phase_training_variants(fa, ca, kg, comp, step_lib, trainer):
    """Phase 15: 15a, then 15b and 15c on one temporary directory of
    records."""
    lora = phase_train_lora(fa, ca, kg, comp, step_lib, trainer)
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_records_")
    try:
        path, images = _cache_records(root)
        cached = phase_train_cached(fa, ca, kg, comp, step_lib, trainer, path, root)
        phase_binding(images)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return lora, cached


# phase 16: the parallel layer (parallel/). The kernels at the 2-way
# tensor-parallel shard shapes of the SDXL edit (each attention's heads and
# each FFN's inner width halved), a world of one process through NCCL, and
# with two cards two NCCL ranks
TP_K1_SHAPES = [(2, 4096, 5, 64), (2, 1024, 10, 64)]
TP_K2_SHAPES = [(2, 4096, 5, 64, 0, 1.0), (2, 1024, 10, 64, 0, 1.0), (2, 1024, 10, 64, 4, 1.0)]
TP_K5_SHAPES = [(8192, 640, 1280), (2048, 1280, 2560)]
MESH_CARD_STEPS = 3  # 16c's train steps on one card and on two ranks
TP_MIN_COSINE = 0.999  # 16c: the TP edit against one card (JAX test_batch_generate's)


@torch.inference_mode()
def phase_tp_kernels(fa, ca, kg):
    """16a: K1, K2 and K5 at the 2-way TP shard shapes against their plain
    versions (phase 3's gates), timed against the plain versions and the
    library call. -> {kernel: {shape: times}}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(16)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def gate(name, shape, out, ref, max_abs):
        err, cos = float((out.float() - ref).abs().max()), _cosine(out.float(), ref)
        ok = err <= max_abs and cos >= (K5_MIN_COSINE if name == "K5" else K1_MIN_COSINE)
        print(f"phase 16a {name} at the TP shard shape {shape}: max_abs={err:.3e} "
              f"cosine={cos:.7f}", flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {shape}")
        return err

    def report(name, shape, t, bound, err):
        print(f"phase 16a time {name} {shape}, device (CUDA event): kernel {_fmt(t['kernel'])}, "
              f"plain {_fmt(t['plain'])}, library {_fmt(t['library'])}; bound {bound[0]:.5f} "
              f"ms ({bound[1]}), {bound[0] / t['kernel'][0]:.1%} of it", flush=True)
        return dict(t, bound=bound, max_abs=err)

    out = {"K1": {}, "K2": {}, "K5": {}}
    for b, s, h, d in TP_K1_SHAPES:
        q, k, v = rnd(b, s, 3 * h * d).chunk(3, dim=-1)
        scale = d**-0.5
        err = gate("K1", (b, s, h, d), fa.flash_attention_nhd(q, k, v, scale=scale, head_dim=d),
                   fa.flash_attention_nhd_plain(q.float(), k.float(), v.float(), scale=scale,
                                                head_dim=d), K1_MAX_ABS)
        heads = [x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v)]
        t = _timings({
            "kernel": lambda: fa.flash_attention_nhd(q, k, v, scale=scale, head_dim=d),
            "plain": lambda: fa.flash_attention_nhd_plain(q, k, v, scale=scale, head_dim=d),
            "library": lambda: sdpa(*heads)})
        out["K1"][(b, s, h, d)] = report("K1", (b, s, h, d), t, fwd_bound(b, s, h, d), err)
    for b, sq, h, d, sk_ip, ip_scale in TP_K2_SHAPES:
        q = rnd(b, sq, h * d)
        k, v = rnd(b, TEXT_KEYS, 2 * h * d).chunk(2, dim=-1)
        k_ip, v_ip = (rnd(b, sk_ip, h * d), rnd(b, sk_ip, h * d)) if sk_ip else (None, None)
        kw = dict(scale=d**-0.5, head_dim=d, k_ip=k_ip, v_ip=v_ip, ip_scale=ip_scale)
        f32 = [None if x is None else x.float() for x in (q, k, v, k_ip, v_ip)]
        shape = (b, sq, h, d, sk_ip)
        err = gate("K2", shape, ca.flash_cross_nhd(q, k, v, **kw), ca.flash_cross_nhd_plain(
            *f32[:3], scale=d**-0.5, head_dim=d, k_ip=f32[3], v_ip=f32[4], ip_scale=ip_scale),
            K1_MAX_ABS)
        heads = [x if x is None else x.view(b, -1, h, d).transpose(1, 2)
                 for x in (q, k, v, k_ip, v_ip)]

        def library():
            sdpa(*heads[:3])
            if sk_ip:
                sdpa(heads[0], heads[3], heads[4])

        t = _timings({"kernel": lambda: ca.flash_cross_nhd(q, k, v, **kw),
                      "plain": lambda: ca.flash_cross_nhd_plain(q, k, v, **kw),
                      "library": library})
        out["K2"][shape] = report("K2", shape, t, k2_bound(b, sq, h, d, sk_ip), err)
    for m, k, inner in TP_K5_SHAPES:
        x, w, bias = rnd(m, k), rnd(2 * inner, k, scale=k**-0.5), rnd(2 * inner)
        ref = kg.geglu_plain(x.float(), w.float(), bias.float(), gelu="tanh")
        err = gate("K5", (m, k, inner), kg.geglu(x, w, bias, gelu="tanh"), ref,
                   K5_MAX_REL * float(ref.abs().max()))
        print(f"phase 16a K5 schedule at {(m, k, inner)}: {_sched(kg.plan(x, w, gelu='tanh'))}",
              flush=True)
        t = _timings({"kernel": lambda: kg.geglu(x, w, bias, gelu="tanh"),
                      "plain": lambda: kg.geglu_plain(x, w, bias, gelu="tanh"),
                      "library": lambda: torch.nn.functional.linear(x, w, bias)},
                     (GEGLU_KERNEL,))
        _alone(t, GEGLU_KERNEL)
        out["K5"][(m, k, inner)] = report("K5", (m, k, inner), t, geglu_bound(m, k, inner), err)
    return out


def _device_events(path):
    """A chrome trace's device events: kernels, copies and sets."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]


def _collective_events():
    """The device events of the group's all-reduce of a 1 MiB fp32 tensor,
    eager and as a replayed CUDA graph, by name: what NCCL launches for the
    train step's flat all-reduces (a kernel, a copy, or nothing)."""
    import collections

    x = torch.ones(1 << 18, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        torch.distributed.all_reduce(x)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        torch.distributed.all_reduce(x)
    out = {}
    for mode, fn in (("eager", lambda: torch.distributed.all_reduce(x)),
                     ("replayed", graph.replay)):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with tempfile.TemporaryDirectory() as tmp:
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            out[mode] = dict(collections.Counter(e["name"] for e in _device_events(path)))
    return out, bool(torch.all(x == 1.0))


def phase_mesh_one(fa, ca, kg, trainer, image5, run7, HarmonyPipeline):
    """16b: a world of one process through NCCL (``init_process_group`` on
    this card). Phase 7's trainer (``--full_random``, captured steps) over
    its 1 x 1 mesh, the flat all-reduces of the gradients and the loss
    inside each captured step: bit for bit phase 7's losses, grad norms
    and parameters, and phase 7's launches by kernel name in a replayed
    step; the device events of the collective, by name, from the trace.
    Then phase 5's 1024² edit through ``with_mesh(make_mesh(),
    tensor_parallel=True)``: bit for bit phase 5's image, its replayed
    launches counted by name. -> (the replayed step's launches, the mesh
    edit's)."""
    from imagharmony_tpu_torch.parallel import distributed
    from imagharmony_tpu_torch.parallel import mesh as mesh_lib

    label = "phase 16b"
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(distributed._free_port()))
    t0 = time.perf_counter()
    distributed.init_group("nccl", 1, 0, 0)
    print(f"{label}: NCCL group of one on {torch.cuda.get_device_name(0)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    events = profiling.kernel_events
    try:
        profiling.kernel_events = _device_events  # the collective may be a copy
        torch.backends.cudnn.allow_tf32 = True  # phase 7's setting
        try:
            run = captured_train(["--full_random", "--synthetic_data", str(TRAIN_STEPS),
                                  "--max_steps", str(TRAIN_STEPS)], TRAIN_STEPS - 2, fa, ca,
                                 kg, trainer)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            profiling.kernel_events = events
        got = [(m["loss"], m["grad_norm"]) for m in run["metrics"]]
        want = [(m["loss"], m["grad_norm"]) for m in run7["metrics"]]
        same = set(run["trained"]) == set(run7["trained"]) and all(
            torch.equal(v, run7["trained"][n]) for n, v in run["trained"].items())
        traced = [r for r in run["replays"] if r["kernels"] is not None]
        pair = next((b for a, b in zip(traced, traced[1:])
                     if a["kernels"] and len(a["kernels"]) == len(b["kernels"])), None)
        if pair is None:
            raise AssertionError(f"{label}: no two profiled replays agree on their events")
        by_name = {k: sum(name in e["name"] for e in pair["kernels"] if e["cat"] == "kernel")
                   for k, name in TRAIN_KERNELS.items()}
        import collections

        step_events = collections.Counter(e["name"] for e in pair["kernels"])
        ref = next((b for a, b in zip(run7["replays"], run7["replays"][1:]) if a["kernels"]
                    and b["kernels"] and len(a["kernels"]) == len(b["kernels"])), None)
        added = step_events - collections.Counter(e["name"] for e in ref["kernels"])
        copies = {n: c for n, c in step_events.items() if n.startswith(("Memcpy", "Memset"))}
        added = {n: c for n, c in added.items() if n not in copies}
        collective, unchanged = _collective_events()
        print(f"{label}: the group's all-reduce of one rank launches, by name, eager "
              f"{collective['eager']}, replayed {collective['replayed']}; the values "
              f"unchanged {unchanged}", flush=True)
        print(f"{label} trainer over a 1 x 1 mesh, {TRAIN_STEPS} captured steps: losses and "
              f"grad norms {'equal' if got == want else 'DIFFER'} to phase 7's, parameters "
              f"bit-identical {same}; captures {len(run['captures'])} "
              f"({run['captures'][0]['s']:.2f} s); replayed step launches {by_name}; a "
              f"replayed step's kernels beyond phase 7's, by name {dict(added)} (and its "
              f"copies and sets, which phase 7's trace does not list: {copies}); median step "
              f"{statistics.median(m['step_time_s'] for m in run['metrics'][1:]):.4f} s",
              flush=True)
        expected = {k: run7["replayed"][k] for k in TRAIN_KERNELS}
        missing = [n for n in collective["replayed"] if n not in step_events]
        if got != want or not same or by_name != expected or missing or not unchanged:
            raise AssertionError(f"{label}: the mesh trainer is not phase 7's: {got} vs {want}, "
                                 f"parameters equal {same}, launches {by_name} vs {expected}, "
                                 f"the collective's events not in the step {missing}")
        gc.collect()
        torch.cuda.empty_cache()
        pipe = HarmonyPipeline.random_full(seed=0, device="cuda", dtype=torch.bfloat16)
        meshed = pipe.with_mesh(mesh_lib.make_mesh(), tensor_parallel=True)
        img, kw = _full_edit()
        first, t_first = _timed(lambda: meshed.generate(img, **kw), "cuda")
        again, t_again = _timed(lambda: meshed.generate(img, **kw), "cuda")
        launches = replay_launches(lambda: meshed.generate(img, **kw), label)
        ok = torch.equal(first, image5) and torch.equal(again, image5)
        print(f"{label} 1024² edit through with_mesh(1 x 1, tensor_parallel=True): first call "
              f"(captures) {t_first:.2f} s, replayed {t_again:.2f} s, both bit-identical to "
              f"phase 5's image {ok}; replayed launches {launches}", flush=True)
        expect = {"K1/K4": SELF_ATTN_PER_UNET_CALL * FULL_STEPS,
                  "K2": SDXL_CROSS_PER_UNET_CALL * FULL_STEPS,
                  "K5": SELF_ATTN_PER_UNET_CALL * FULL_STEPS}
        if not ok or launches != expect:
            raise AssertionError(f"{label}: the mesh edit is not phase 5's (equal {ok}) or "
                                 f"launched {launches}, expected {expect}")
        del pipe, meshed
    finally:
        torch.distributed.destroy_process_group()
    return by_name, launches


def phase_mesh_cards(image5, trainer):
    """16c, with two or more cards (else skipped, printed): two NCCL ranks
    on cuda:0 and cuda:1 (``parallel.drills.card_drills``). The
    full-width trainer at two rows a step, data-parallel and then with
    ``--fsdp``, against one card's trainer on the same two rows, loss and
    grad norm within TRAIN_MAX_LOSS_REL (bf16; two ranks reduce in another
    order); each rank's FSDP-sliced parameter bytes against one card's; the
    1 x 2 tensor-parallel 1024² edit against phase 5's image, cosine >
    TP_MIN_COSINE."""
    from imagharmony_tpu_torch.parallel import distributed, drills

    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 16c two NCCL ranks: skipped, {n} card", flush=True)
        return
    label = "phase 16c"
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        one_dir = os.path.join(root, "one")
        torch.backends.cudnn.allow_tf32 = True
        try:
            trainer.main(["--full_random", "--synthetic_data", str(MESH_CARD_STEPS),
                          "--train_batch_size", "2", "--max_steps", str(MESH_CARD_STEPS),
                          "--log_every", "1", "--output_dir", one_dir])
        finally:
            torch.backends.cudnn.allow_tf32 = False
        with open(os.path.join(one_dir, "metrics.jsonl")) as f:
            one = [(json.loads(line)["loss"], json.loads(line)["grad_norm"]) for line in f]
        gc.collect()
        torch.cuda.empty_cache()
        img, kw = _full_edit()
        t0 = time.perf_counter()
        ranks = distributed.spawn(drills.card_drills, 2, backend="nccl", timeout=600,
                                  threads=4, kwargs=dict(steps=MESH_CARD_STEPS, image=img,
                                                         kw=kw, root=root))
        print(f"{label}: two ranks ran in {time.perf_counter() - t0:.1f} s", flush=True)
        worst = 0.0
        for mode in ("dp", "fsdp"):
            got = ranks[0][mode]
            gaps = [max(abs(a - b) / abs(b) for a, b in zip(x, y)) for x, y in zip(got, one)]
            worst = max(worst, *gaps)
            print(f"{label} {mode} on two ranks (loss, grad norm) {got}; one card {one}; "
                  f"largest relative gap a step {[f'{g:.2e}' for g in gaps]}", flush=True)
        for r in ranks:
            st = r["fsdp_state"]
            print(f"{label} rank {r['rank']} ({r['device']}): FSDP sliced {st['sliced']} "
                  f"parameters, {st['param_bytes'] / 2**30:.3f} GiB of parameters on the "
                  f"rank against {st['one_card_param_bytes'] / 2**30:.3f} GiB on one card, "
                  f"{st['allocated_bytes'] / 2**30:.3f} GiB allocated after the slicing",
                  flush=True)
        cos = _cosine(torch.as_tensor(ranks[0]["tp_image"]), image5.float().cpu())
        print(f"{label} TP 1 x 2 1024² edit against phase 5's image: cosine {cos:.6f}",
              flush=True)
        if (worst > TRAIN_MAX_LOSS_REL or cos <= TP_MIN_COSINE or any(
                r["fsdp_state"]["param_bytes"] >= 0.75 * r["fsdp_state"]["one_card_param_bytes"]
                for r in ranks)):
            raise AssertionError(f"{label}: two ranks disagree with one card (worst gap "
                                 f"{worst:.3e}, TP cosine {cos:.6f}) or FSDP did not slice")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 17: the evaluation tools on phase 5's pipeline
EVAL_RECORDS = 4
SDXL_REUSE = 46  # a reuse step's transformer blocks (encoder propagation), as in phase 12
PRESET_FLAGS = {"exact": [], "fast": ["--fast"], "turbo": ["--turbo"],
                "fast+turbo": ["--fast", "--turbo"]}


class _Watched:
    """A pipeline whose generate() records the captures and the wrappers'
    launches of each call; everything else is the pipeline's."""

    def __init__(self, pipe, fa, ca, kg):
        self._pipe, self._kernels, self.calls = pipe, (fa, ca, kg), []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate(self, *args, **kw):
        _reset_launches(*self._kernels)
        before = self._pipe.programs.captures
        out = self._pipe.generate(*args, **kw)
        self.calls.append((self._pipe.programs.captures - before, _launches(*self._kernels)))
        return out


def _tools_eval(pipe, fa, ca, kg):
    """17a: ``evaluate`` over EVAL_RECORDS synthetic records at 1024²."""
    from imagharmony_tpu_torch.tools import eval_benchmark as ev

    label = "phase 17a eval"
    dev = pipe.device
    records = ev.synthetic_records(EVAL_RECORDS)
    args = dict(steps=FULL_STEPS, guidance_scale=5.0, seed=42, height=1024, width=1024)
    watched = _Watched(pipe, fa, ca, kg)
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        summary, rows, images = ev.evaluate(watched, records, out_dir=out_dir,
                                            weights="random-full", **args)
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(out_dir))
    r0 = records[0]
    with tempfile.TemporaryDirectory() as log_dir:  # the direct call inside a named span
        with profiling.trace(log_dir), profiling.annotate("direct generate"):
            direct = pipe.generate(pil_image=r0["image"], prompt=r0["text"],
                                   extra_text=r0["extra_text"], num_inference_steps=FULL_STEPS,
                                   guidance_scale=5.0, seed=42, height=1024, width=1024,
                                   output_type="raw").float().cpu().numpy()
        [name] = os.listdir(log_dir)
        with open(os.path.join(log_dir, name)) as f:
            spans = sum(e.get("cat") == "user_annotation" and e.get("name") == "direct generate"
                        for e in json.load(f)["traceEvents"])
    same = bool(np.array_equal(direct, images[0]))

    traced = []

    def one_record():
        with tempfile.TemporaryDirectory() as out_dir:
            traced.append(ev.evaluate(pipe, records[:1], out_dir=out_dir, **args)[1][0])

    torch.cuda.synchronize(dev)
    counts = replay_launches(one_record, "eval record")
    scores = [r[k] for r in rows for k in ("clip_t", "clip_i")]
    print(f"{label}: {EVAL_RECORDS} synthetic records at 1024², {FULL_STEPS} steps, in "
          f"{wall:.2f} s: {json.dumps(rows)}; summary {json.dumps(summary)}; files {files}; "
          f"captures and wrapper launches a record {watched.calls}; the first image bit for "
          f"bit generate() called directly: {same} (its trace holding {spans} span of "
          f"annotate's name); one record in a trace: {counts}, its row "
          f"{json.dumps(traced[0])}", flush=True)
    want = FULL_STEPS * SELF_ATTN_PER_UNET_CALL
    if not (same and spans == 1 and files == ["records.jsonl", "summary.json"]
            and len(rows) == EVAL_RECORDS
            and all(np.isfinite(x) and -1.0 <= x <= 1.0 for x in scores)):
        raise AssertionError(f"{label}: first image equal {same}, {spans} spans, files {files}, "
                             f"scores {scores}")
    if any(n or sum(c.values()) for n, c in watched.calls[1:]):
        raise AssertionError(f"{label}: a record after the first captured or launched "
                             f"through a wrapper: {watched.calls}")
    if counts != {"K1/K4": want, "K2": want, "K5": want}:
        raise AssertionError(f"{label}: one record launched {counts}, expected {want} each")
    return counts


def _tools_presets(pipe, fa, ca, kg):
    """17b: ``validate`` over the four presets, each against the CLI's own
    call of it."""
    from PIL import Image

    from imagharmony_tpu_torch import cli
    from imagharmony_tpu_torch.tools import validate_presets as vp

    label = "phase 17b presets"
    prompt, extra = "a photo of eight sheep", "six dogs"
    image = vp.input_image()
    watched = _Watched(pipe, fa, ca, kg)
    t0 = time.perf_counter()
    report, outputs = vp.validate(watched, image, prompt=prompt, extra_text=extra,
                                  steps=FULL_STEPS, height=1024, width=1024,
                                  weights="random-full")
    wall = time.perf_counter() - t0
    parser = cli.build_parser()
    launches, rows = {}, {}
    for (name, flags), (captured, _) in zip(PRESET_FLAGS.items(), watched.calls):
        kw = cli.edit_kwargs(parser.parse_args(["edit", "--prompt", prompt, "--extra-text",
                                                extra, "--height", "1024", "--width", "1024",
                                                "--steps", str(FULL_STEPS), *flags]))
        kw["output_type"] = "raw"
        steps = kw["num_inference_steps"]
        keys = -(-steps // kw["encoder_interval"])
        per = keys * SELF_ATTN_PER_UNET_CALL + (steps - keys) * SDXL_REUSE
        outs = []
        counts = replay_launches(
            lambda: outs.append(pipe.generate(pil_image=Image.fromarray(image), **kw).float()
                                .cpu()), f"preset {name}")
        same = torch.equal(outs[0], outputs[name])
        launches[name] = counts
        rows[name] = dict(report[name], steps=steps, encoder_interval=kw["encoder_interval"],
                          timestep_spacing=kw["timestep_spacing"], captures=captured,
                          launches=counts, expected=per, cli_bit_for_bit=same)
        print(f"{label} {name}: {json.dumps(rows[name])}", flush=True)
        if not same or counts != {"K1/K4": per, "K2": per, "K5": per}:
            raise AssertionError(f"{label} {name}: the CLI's call equal {same}, launches "
                                 f"{counts}, expected {per} each")
    print(f"{label}: validate() in {wall:.2f} s, {len(pipe.programs)} keys in the pipeline's "
          f"cache; report inputs {json.dumps(report['inputs'])}", flush=True)
    captures = [n for n, _ in watched.calls]
    if captures != [0, 0, 1, 0] or any(sum(c.values()) for n, c in watched.calls if not n) \
            or not all(
            np.isfinite(v) for row in rows.values() for k, v in row.items()
            if k in ("raw_cosine_vs_exact", "clip_i_vs_exact", "clip_t")):
        raise AssertionError(f"{label}: captures and wrapper launches {watched.calls} (exact "
                             f"and fast on phase 5's key, turbo and fast+turbo on one new "
                             f"key), rows {rows}")
    return launches


def _unet_inputs(cfg, batch, size, dtype, device):
    """Random inputs of a UNet call from a seed: NCHW latents of ``size``²,
    timesteps, TEXT_KEYS of text context, the pooled text, the
    micro-conditioning time ids and the IP tokens."""
    g = torch.Generator().manual_seed(17)
    r = lambda *shape: torch.randn(*shape, generator=g).to(device=device, dtype=dtype)
    pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
    return (r(batch, cfg.in_channels, size, size), torch.full((batch,), 999.0, device=device),
            r(batch, TEXT_KEYS, cfg.cross_attention_dim)), dict(
        pooled_text_embeds=r(batch, pooled),
        time_ids=torch.tensor([[size * 8.0, size * 8.0, 0, 0, size * 8.0, size * 8.0]] * batch,
                              device=device),
        ip_tokens=r(batch, cfg.num_ip_tokens, cfg.cross_attention_dim))


def _unet_stats(unet, args, kw):
    """``compiled_stats`` of one eager UNet call and what the kernels
    declared in it."""
    from imagharmony_tpu_torch.kernels import cost

    with torch.inference_mode(), cost.counting() as declared:
        stats = profiling.compiled_stats(lambda *a: unet(*a, **kw), *args)
    return stats, declared


def _tools_stats(pipe):
    """17c: ``compiled_stats`` of an eager SDXL UNet CFG call at 1024², and
    a tiny UNet's flops on the card against the CPU's."""
    from imagharmony_tpu_torch.kernels import cost

    label = "phase 17c compiled_stats"
    unet, cfg = pipe.components.unet, pipe.cfgs.unet
    args, kw = _unet_inputs(cfg, 2, 128, torch.bfloat16, pipe.device)
    t0 = time.perf_counter()
    stats, declared = _unet_stats(unet, args, kw)
    wall = time.perf_counter() - t0
    (s4, h4, d), (s1, h1, _) = MAIN_SHAPES
    want = {"K1": 10 * cost.attention(2, h4, s4, s4, d, 2)[0]
            + 60 * cost.attention(2, h1, s1, s1, d, 2)[0],
            "K2": 10 * cost.cross(2, h4, s4, TEXT_KEYS, 0, d, 2)[0]
            + 50 * cost.cross(2, h1, s1, TEXT_KEYS, 0, d, 2)[0]
            + 10 * cost.cross(2, h1, s1, TEXT_KEYS, 4, d, 2)[0],
            "K5": 10 * cost.geglu(*K5_SHAPES[0])[0] + 60 * cost.geglu(*K5_SHAPES[1])[0]}
    share = declared.flops / stats["flops"]
    print(f"{label} SDXL UNet CFG call at 1024² (eager, bf16, IP on its live layer): "
          f"{stats['flops'] / 1e12:.4f} TFLOP ({stats['flops']}), bytes accessed "
          f"{stats['bytes_accessed'] / 2**30:.3f} GiB ({stats['bytes_accessed']}), peak temp "
          f"{stats['peak_temp_bytes'] / 2**30:.3f} GiB; the kernels declared "
          f"{declared.flops / 1e12:.4f} TFLOP, {share:.4f} of the flops, by kernel "
          f"{declared.flops_by_kernel} in {declared.launches_by_kernel} launches "
          f"(expected {want}); {wall:.2f} s under the counters", flush=True)
    if (declared.flops_by_kernel != want or declared.launches_by_kernel != {
            "K1": 70, "K2": 70, "K5": 70} or not stats["peak_temp_bytes"] > 0):
        raise AssertionError(f"{label}: declared {declared}, expected {want}; {stats}")

    from imagharmony_tpu_torch.models import unet as punet
    from imagharmony_tpu_torch.nn.attention import pack_inference_params

    ucfg = punet.tiny_config()
    torch.manual_seed(0)
    cpu = pack_inference_params(punet.UNet2DConditionModel(ucfg).eval())
    card = copy.deepcopy(cpu).to(device="cuda", dtype=torch.bfloat16)
    size = 32  # phase 4's latents
    runs = {}
    for name, (module, dtype, dev) in {"cpu": (cpu, torch.float32, "cpu"),
                                       "card": (card, torch.bfloat16, "cuda")}.items():
        a, k = _unet_inputs(ucfg, 2, size, dtype, dev)
        runs[name] = _unet_stats(module, a, k)
    (cs, cd), (gs, gd) = runs["cpu"], runs["card"]
    print(f"{label} tiny UNet, latents {size}², CFG pair: flops on the card {gs['flops']} "
          f"(the kernels declaring {gd.flops} in {gd.launches_by_kernel}), on the CPU {cs['flops']} "
          f"(declared {cd.flops}); bytes card {gs['bytes_accessed']}, CPU "
          f"{cs['bytes_accessed']}", flush=True)
    if gs["flops"] != cs["flops"] or cd.flops or not gd.flops or set(gd.launches_by_kernel) != {
            "K1", "K2", "K5"}:
        raise AssertionError(f"{label}: the tiny UNet's flops differ: card {gs}, {gd}; "
                             f"CPU {cs}, {cd}")
    return dict(flops=stats["flops"], bytes_accessed=stats["bytes_accessed"],
                peak_temp_bytes=stats["peak_temp_bytes"], kernel_share=share)


def _tools_train_stats(fa, ca, kg):
    """17c: ``compiled_stats`` of one eager tiny train step
    (``step.train_step``: the loss, its gradient-checkpointed backward, the
    update) on the CPU (fp32, the plain versions' products counted) and on
    the card (bf16, the kernels declaring: K3 and the checkpoint's reruns of
    K1, K2 and K5 run on the autograd engine's threads). The card counts
    3·b·h·sq·sk·d less than the CPU for each K3 launch (kernels/cost.py:
    two K1 launches with the lse at -2, K3 at +1), so card = CPU - 3/11 of
    K3's declared flops, exactly; the declared launches are the wrappers'."""
    from imagharmony_tpu_torch.kernels import cost
    from imagharmony_tpu_torch.pipelines import components as comp
    from imagharmony_tpu_torch.train import step as step_lib

    label = "phase 17c compiled_stats tiny train step"
    cfgs = comp.tiny_configs()
    cpu = comp.init_params(torch.Generator().manual_seed(0), cfgs, device="cpu")
    card = copy.deepcopy(cpu).to(device="cuda", dtype=torch.bfloat16)
    tcfg = step_lib.TrainConfig(unet_cfg=cfgs.unet)
    batch = step_lib.dummy_batch(cfgs, 2, 32)
    draws = step_lib.draw(torch.Generator().manual_seed(1), cfgs, tcfg, 2, 32)
    runs = {}
    for dev, comps in (("cpu", cpu), ("cuda", card)):
        state = step_lib.init_state(comps, tcfg)
        d = [step_lib.Draws(*(x.to(dev) for x in (draws.noise, draws.timesteps,
                                                   draws.latent_eps)))]
        _reset_train_launches(fa, ca, kg)
        with cost.counting() as declared:
            stats = profiling.compiled_stats(step_lib.train_step, state, comps, tcfg,
                                             step_lib.to_device(batch, dev), d)
        runs[dev] = stats, declared, _train_launches(fa, ca, kg)
    (cs, cd, _), (gs, gd, wrappers) = runs["cpu"], runs["cuda"]
    k3 = gd.flops_by_kernel.get("K3", 0)
    launched = {("K1" if k == "K1/K4" else k): n for k, n in wrappers.items()}
    print(f"{label}, batch 2 at 32² (gradient checkpointing): flops on the card {gs['flops']} "
          f"(the kernels declaring {gd.flops}: {gd.flops_by_kernel} in "
          f"{gd.launches_by_kernel} launches, the wrappers counting {launched}), on the CPU "
          f"{cs['flops']} (declared {cd.flops}); CPU - card {cs['flops'] - gs['flops']}, "
          f"3/11 of K3's declared {3 * k3 // 11} (K3 declares JAX's 11·b·h·sq·sk·d, its plain "
          f"backward 10); peak temp on the card {gs['peak_temp_bytes']}", flush=True)
    if (cd.flops or k3 % 11 or cs["flops"] - gs["flops"] != 3 * k3 // 11
            or gd.launches_by_kernel != launched or not all(launched.values())):
        raise AssertionError(f"{label}: card {gs}, {gd}; CPU {cs}, {cd}; wrappers {launched}")
    return dict(cpu_flops=cs["flops"], card_flops=gs["flops"], declared=gd.flops_by_kernel,
                launches=gd.launches_by_kernel)


def _tools_main():
    """17d: both tools as ``python -m`` processes on the card, in parallel."""
    label = "phase 17d tools' main"
    root = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    cmds = {"eval_benchmark": ["--random", "tiny", "--synthetic", "2", "--steps", "2"],
            "validate_presets": ["--random", "tiny", "--steps", "4"]}
    procs = {}
    try:
        t0 = time.perf_counter()
        for name, argv in cmds.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"imagharmony_tpu_torch.tools.{name}", *argv,
                 "--out_dir", os.path.join(root, name)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        outs = {name: p.communicate(timeout=240) for name, p in procs.items()}
        wall = time.perf_counter() - t0
        rcs = {name: p.returncode for name, p in procs.items()}
        summary = json.loads(outs["eval_benchmark"][0].strip().splitlines()[-1])
        with open(os.path.join(root, "validate_presets", "report.json")) as f:
            report = json.load(f)
        files = {name: sorted(os.listdir(os.path.join(root, name))) for name in cmds}
        print(f"{label}: exit codes {rcs} in {wall:.1f} s (both at once); eval's last line "
              f"{json.dumps(summary)}; presets' rows "
              f"{json.dumps({k: v for k, v in report.items() if k != 'inputs'})}; files "
              f"{files}", flush=True)
        if any(rcs.values()) or summary["n"] != 2 or files != {
                "eval_benchmark": ["records.jsonl", "summary.json"],
                "validate_presets": ["exact.png", "fast.png", "fast_turbo.png", "report.json",
                                     "turbo.png"]}:
            raise AssertionError(f"{label}: {rcs}, {files}; stderr "
                                 f"{ {n: o[1][-2000:] for n, o in outs.items()} }")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)


def phase_tools(pipe, fa, ca, kg):
    """Phase 17 on phase 5's pipeline; its programs dropped at the end.
    Returns the launches by path for the kernels line and the UNet call's
    counts."""
    t0 = time.perf_counter()
    paths = {"eval_record": _tools_eval(pipe, fa, ca, kg)}
    paths.update({f"preset_{name}": counts
                  for name, counts in _tools_presets(pipe, fa, ca, kg).items()})
    stats = _tools_stats(pipe)
    stats["train_step"] = _tools_train_stats(fa, ca, kg)
    _drop_programs(pipe)
    _tools_main()
    print(f"phase 17 tools in {time.perf_counter() - t0:.1f} s", flush=True)
    return paths, stats


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


T0 = time.perf_counter()


def _mark(phase):
    print(f"{phase} done, {time.perf_counter() - T0:.1f} s since the script started", flush=True)


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
    _mark("phase 2")
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
    _mark("phases 3-3j")
    for tool in ("probe_attn_kblock", "probe_attn_lanegroup", "probe_softmax_nomax",
                 "probe_softmax_tricks"):
        got = _probe_main(tool, fa, kg, pm, pa, ps)
        probes = {k: probes[k] + got[k] for k in probes}
    missing = [k for k, n in probes.items() if not n]
    if missing:
        raise AssertionError(f"a kernel was not launched on the probes' path: {missing} "
                             f"of {probes}")
    p1_launches = probes["probe_mm"]
    tp_times = phase_tp_kernels(fa, ca, kg)
    _mark("phase 16a")
    phase_second_device(fa, ca, kg, pm, pa, ps, split_heads, HarmonyPipeline)
    _mark("phase 3f")
    phase_tiny(fa, ca, kg, HarmonyPipeline)
    sdxl, sdxl_gen, sdxl_image, pipe5 = phase_full(fa, ca, kg, HarmonyPipeline)
    _mark("phases 4-5")
    tool_paths, _ = phase_tools(pipe5, fa, ca, kg)
    del pipe5
    gc.collect()
    torch.cuda.empty_cache()
    _mark("phase 17")
    phase_train_tiny(fa, ca, kg, comp, step_lib, trainer)
    train, train_eager, train_run = phase_train_full(fa, ca, kg, comp, step_lib, trainer)
    _mark("phases 6-7")
    train_dp, generate_mesh = phase_mesh_one(fa, ca, kg, trainer, sdxl_image, train_run,
                                             HarmonyPipeline)
    _mark("phase 16b")
    phase_sd15_narrow(fa, ca, kg, comp, HarmonyPipeline)
    sd15, sd15_gen = phase_sd15_full(fa, ca, kg, HarmonyPipeline)
    k4_grad, k2_grad, k3_grad, k5_grad = phase_sd15_grad(fa, ca, kg, comp, punet)
    _mark("phases 8-10")
    loaded_gen, cli_walls = phase_load_full(
        fa, ca, kg, comp, trainer, sdxl_image, train_run,
        during=lambda root, adapter: phase_cli(root, adapter, comp, HarmonyPipeline))
    _mark("phase 11 and 14e")
    features = phase_features(fa, ca, kg, HarmonyPipeline)
    _mark("phase 12")
    feature_paths = {f"generate_{tag}": g for tag, g in features.items()}
    serve = phase_serve(fa, ca, kg, HarmonyPipeline)
    _mark("phase 13")
    serve_paths = {"generate_batch": serve["batch"]["launches_replayed"],
                   "generate_chunked": serve["chunked"]["launches_replayed"],
                   "engine_chunk": serve["engine"]["launches_per_chunk"]}
    serve_eager = serve["batch"]["launches_eager"]
    variants = phase_variants(fa, ca, kg, comp, HarmonyPipeline)
    variant_paths = {"generate_ensemble_base": variants["ensemble_base"],
                     "generate_refiner": variants["ensemble_refiner"],
                     "generate_controlnet": variants["controlnet"],
                     "generate_lora": variants["lora"],
                     **{f"generate_ha_{f}": g for f, g in variants["fusions"].items()}}
    print(f"phase 14 CLI wall times (s): {cli_walls}", flush=True)
    _mark("phase 14")
    (lora, lora_eager), (cached, cached_eager) = phase_training_variants(
        fa, ca, kg, comp, step_lib, trainer)
    train_paths = {"train_lora": lora, "train_lora_eager": lora_eager, "train_cached": cached,
                   "train_cached_eager": cached_eager}
    _mark("phase 15")
    phase_mesh_cards(sdxl_image, trainer)
    _mark("phase 16c")

    def tp_rows(kernel):  # the kernels line's rows at the TP shard shapes
        return [{"shape": list(shape), "max_abs_err": t["max_abs"],
                 **_line_times(t, t["bound"])} for shape, t in tp_times[kernel].items()]
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
                             "generate_loaded": loaded_gen["K1/K4"],
                             "train": train["K1/K4"], "train_eager": train_eager["K1/K4"],
                             **{p: g["K1/K4"] for p, g in train_paths.items()},
                             "probes": probes["flash_attention_nhd"],
                             **{p: g["K1/K4"] for p, g in feature_paths.items()
                                if p != "generate_sd15_dpmpp"},
                             **{p: g["K1/K4"] for p, g in serve_paths.items()},
                             **{p: g["K1/K4"] for p, g in variant_paths.items()},
                             "edit_eager_batch": serve_eager["K1"],
                             "train_dp": train_dp["K1/K4"],
                             "generate_mesh": generate_mesh["K1/K4"],
                             **{p: g["K1/K4"] for p, g in tool_paths.items()}},
        "max_abs_err": max_err,
        "shape": [2, *MAIN_SHAPES[0]],
        **_line_times(main_ms[MAIN_SHAPES[0]], fwd_bound(2, *MAIN_SHAPES[0])),
        "by_shape": [{"shape": [2, *shape], "head_split_entry_ms": t["via_k4"],
                      **_line_times(t, fwd_bound(2, *shape))} for shape, t in main_ms.items()]
                    + [{"shape": list(shape), "with_lse": True, **_line_times(t, t["bound"])}
                       for shape, t in k1_train_times.items()],
        "tp_shard_shapes": tp_rows("K1"),
    }, {
        "name": "flash_attention_nhd_bwd",
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/flash_attn_nhd_bwd.cu",
        "replaces": "imagharmony_tpu/kernels/flash_attention.py:220",
        "launches": train["K3"],
        "launches_by_path": {"train": train["K3"], "train_eager": train_eager["K3"],
                             **{p: g["K3"] for p, g in train_paths.items()},
                             "sd15_unet_grad": k3_grad, "train_dp": train_dp["K3"]},
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
                             "sd15_unet_grad": k4_grad,
                             "generate_sd15_dpmpp": features["sd15_dpmpp"]["K1/K4"]},
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
                             "generate_loaded": loaded_gen["K2"],
                             "edit_eager_ip": sdxl["K2 IP"], "train": train["K2"],
                             "train_eager": train_eager["K2"],
                             **{p: g["K2"] for p, g in train_paths.items()},
                             "generate_sd15": sd15_gen["K2"], "edit_eager_sd15": sd15["K2"],
                             "sd15_unet_grad": k2_grad,
                             **{p: g["K2"] for p, g in feature_paths.items()},
                             **{p: g["K2"] for p, g in serve_paths.items()},
                             **{p: g["K2"] for p, g in variant_paths.items()},
                             "edit_eager_batch": serve_eager["K2"],
                             "edit_eager_batch_ip": serve_eager["K2 IP"],
                             "train_dp": train_dp["K2"], "generate_mesh": generate_mesh["K2"],
                             **{p: g["K2"] for p, g in tool_paths.items()}},
        "max_abs_err": k2_err,
        "shape": list(K2_SHAPES[0][:5]),
        **_line_times(k2, k2["bound"]),
        "by_shape": [{"shape": list(shape), **_line_times(t, t["bound"])}
                     for shape, t in k2_times.items()],
        "tp_shard_shapes": tp_rows("K2"),
    }, {
        "name": "geglu",
        "route": "cuda",
        "source": "imagharmony_tpu_torch/kernels/csrc/geglu.cu",
        "replaces": "tools/probe_geglu_v2.py:36 (also tools/probe_geglu_epilogue.py:64, "
                    "tools/probe_geglu_tune.py:37, tools/probe_pallas_matmul.py:60)",
        "launches": sdxl_gen["K5"],
        "launches_by_path": {"generate": sdxl_gen["K5"], "edit_eager": sdxl["K5"],
                             "generate_loaded": loaded_gen["K5"],
                             "train": train["K5"], "train_eager": train_eager["K5"],
                             **{p: g["K5"] for p, g in train_paths.items()},
                             "generate_sd15": sd15_gen["K5"],
                             "edit_eager_sd15": sd15["K5"], "sd15_unet_grad": k5_grad,
                             "probes": probes["geglu"],
                             **{p: g["K5"] for p, g in feature_paths.items()},
                             **{p: g["K5"] for p, g in serve_paths.items()},
                             **{p: g["K5"] for p, g in variant_paths.items()},
                             "edit_eager_batch": serve_eager["K5"],
                             "train_dp": train_dp["K5"], "generate_mesh": generate_mesh["K5"],
                             **{p: g["K5"] for p, g in tool_paths.items()}},
        "max_abs_err": k5_err,
        "shape": list(K5_SHAPES[0]),
        **_line_times(k5, k5["bound"]),
        "no_gelu_ms": k5["no_gelu"][0],
        "by_shape": [{"shape": list(shape), "no_gelu_ms": t["no_gelu"][0],
                      "schedule": t["schedule"], **_line_times(t, t["bound"])}
                     for shape, t in k5_times.items()],
        "tp_shard_shapes": tp_rows("K5"),
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


def main_cards():
    """Phase 16c alone (``--cards``): K1/K4, K3, K2 and K5 built, phase 5's
    edit once for its image, then ``phase_mesh_cards``."""
    from imagharmony_tpu_torch.kernels import cross_attention as ca
    from imagharmony_tpu_torch.kernels import flash_attention as fa
    from imagharmony_tpu_torch.kernels import geglu as kg
    from imagharmony_tpu_torch.pipelines.harmony_edit import HarmonyPipeline
    from imagharmony_tpu_torch.train import trainer

    phase_device()
    if torch.cuda.device_count() < 2:
        raise RuntimeError(f"--cards needs two cards, found {torch.cuda.device_count()}")
    with ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(e) for e in (fa._entry, fa._bwd_entry, ca._entry, kg._entry)]:
            f.result()
    fa._bhsd_entry()
    fa._bhsd_bwd_entry()
    _mark("phase 2 (the main path's kernels)")
    pipe = HarmonyPipeline.random_full(seed=0, device="cuda", dtype=torch.bfloat16)
    img, kw = _full_edit()
    image5 = pipe.generate(img, **kw)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    _mark("phase 5's image")
    phase_mesh_cards(image5, trainer)
    _mark("phase 16c")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_cards() if sys.argv[1:] == ["--cards"] else main())
