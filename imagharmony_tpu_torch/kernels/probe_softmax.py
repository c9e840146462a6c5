"""P5 and P6: the softmax recipes of the two softmax probes, on the packed
(B, S, H*D) layout, as recipes of the attention probes' kernel
(``attn_nomax_wgmma_kernel`` in ``csrc/probe_attn.cu``, sm_90a; see
``probe_attention``). Per head, with s the logits and e what PV and the row
sum take:

========================  ==============  ============  ======  ===========================
recipe                    scale           subtracted    exp     row sum; normalised
========================  ==============  ============  ======  ===========================
``max_exp2``              q, log2 e       row max       exp2    Σ bf16 e; after PV
``max_exp2_ones``         q, log2 e       row max       exp2    the ones column; after PV
``clamp_bf16``            q, log2 e       min(s, c)     exp2    Σ bf16 e; after PV
``clamp_bf16_ones``       q, log2 e       min(s, c)     exp2    the ones column; after PV
``clamp_fp32``            q, log2 e       min(s, c)     exp2    Σ fp32 e; after PV
``clamp_fp32_ones``       q, log2 e       min(s, c)     exp2    the ones column; after PV
``max_exp``               q               row max       exp     Σ bf16 e; after PV
``norm_first``            the logits      row max       exp     Σ bf16 e; before PV
========================  ==============  ============  ======  ===========================

The scale folded into q is rounded to q's dtype; every recipe but the two
``clamp_fp32`` ones rounds the exp's argument and e to bf16, as the TPU
kernels cast them; the ones column (the TPU kernel's extra column of ones
in V) sums e rounded to v's dtype; ``norm_first`` multiplies bf16 e by
bf16(1 / sum) before PV. The clamp c is P5's, 80·log2(e) ≈ 115.416 (P2's
is 115). ``clamp_fp32`` is P2-P4's recipe at that clamp.

Two entry points, each with its probe's signature:

* ``softmax_nomax`` (P5) replaces ``_kernel_variant``
  (tools/probe_softmax_nomax.py:32, entry ``run_variant`` :76): ``no_max``
  False (max-subtract), True (the clamp, bf16 argument) or "fp32" (the
  clamp, fp32 argument), ``mxu_sum`` the ones column;
* ``softmax_tricks`` (P6) replaces ``_kernel_v``
  (tools/probe_softmax_tricks.py:41, entry ``run_variant`` :84):
  ``variant`` 0 (``norm_first``), 1 (``max_exp``) or 2 (``max_exp2``, P5's
  base recipe: the two give the same bits).

On CPU tensors each runs ``softmax_recipe_plain``, the TPU recipe with the
whole row at once; on CUDA tensors it launches the kernel or raises. The
kernel streams the keys, 128 query rows and 128 keys a tile (64 at head
dim 128), the tile the TPU tools' lack of a tile knob leaves: the
max-subtract recipes keep a running max and rescale O and the sum by
exp2(m_old - m_new) in fp32, so their bf16 argument is s minus the running
max, not the row's (a rounding apart from the TPU function), and
``norm_first`` takes a statistics pass over K before its PV pass. A ragged
S is masked in the kernel. No pipeline of the port calls them: their path
is the port's softmax probes (``imagharmony_tpu_torch/probes/``).

What bounds them on an H100: the tensor cores and the exponentials alike,
as P2 (86 GFLOP and 335.5 M exp2 at (2, 4096, 10, 64), 0.087 ms each at
989 TFLOP/s and 16 exp2 a clock an SM, against 42 MB); ``norm_first``'s
statistics pass adds a third of the products and a second round of exp2.
The kernel runs each recipe's exponentials under the products (see
``probe_attention``): a tile's exp, roundings and sums run while the
previous tile's PV and the other consumer warpgroup's products hold the
tensor cores.
"""

from __future__ import annotations

import torch

from imagharmony_tpu_torch.kernels import flash_attention as fa
from imagharmony_tpu_torch.kernels import probe_attention as pa

# kernel launches since the last reset, per entry point (P5, P6); only the
# CUDA launches add to them
launches = {"softmax_nomax": 0, "softmax_tricks": 0}

HEAD_DIMS = pa.HEAD_DIMS
CLAMP = 80.0 * fa._LOG2E  # P5's exp2 argument bound (fp32 exp2 overflows at 128)

# recipe -> the kernel's Recipe (csrc/probe_attn.cu)
RECIPES = {"clamp_fp32": 0, "max_exp2": 1, "max_exp2_ones": 2, "clamp_bf16": 3,
           "clamp_bf16_ones": 4, "clamp_fp32_ones": 5, "max_exp": 6, "norm_first": 7}
# P5's (no_max, mxu_sum) and P6's variant -> recipe
NOMAX = {(False, False): "max_exp2", (False, True): "max_exp2_ones",
         (True, False): "clamp_bf16", (True, True): "clamp_bf16_ones",
         ("fp32", False): "clamp_fp32", ("fp32", True): "clamp_fp32_ones"}
TRICKS = {0: "norm_first", 1: "max_exp", 2: "max_exp2"}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def softmax_recipe_plain(q, k, v, scale, head_dim, *, recipe):
    """The reference: ``recipe`` as the TPU kernel computes it, the whole key
    row at once (its max is the row's), fp32 products, rounded where the
    TPU kernel casts.

    q: (B, Sq, H*D); k, v: (B, Sk, H*D) -> (B, Sq, H*D) in q's dtype."""
    if recipe not in RECIPES:
        raise ValueError(f"recipe {recipe!r} not in {tuple(RECIPES)}")
    natural = recipe in ("max_exp", "norm_first")
    kh, vh = fa._split(k, head_dim), fa._split(v, head_dim)
    if recipe == "norm_first":
        logits = torch.matmul(fa._split(q, head_dim), kh.transpose(-1, -2)) * scale
    else:
        mul = scale if natural else scale * fa._LOG2E
        qs = (fa._split(q, head_dim) * mul).to(q.dtype).float()
        logits = torch.matmul(qs, kh.transpose(-1, -2))
    if recipe.startswith("clamp"):
        arg = torch.clamp(logits, max=CLAMP)
    else:
        arg = logits - logits.amax(dim=-1, keepdim=True)
    if not recipe.startswith("clamp_fp32"):  # a bf16 argument, a bf16 e
        e = _bf16(torch.exp(_bf16(arg)) if natural else torch.exp2(_bf16(arg)))
    else:
        e = torch.exp2(arg)
    ev = e.to(v.dtype).float()
    if recipe == "norm_first":
        probs = _bf16(e * _bf16(1.0 / e.sum(dim=-1, keepdim=True))).to(v.dtype).float()
        out = torch.matmul(probs, vh)
    else:
        denom = (ev if recipe.endswith("_ones") else e).sum(dim=-1, keepdim=True)
        out = torch.matmul(ev, vh) * (1.0 / denom)
    return fa._merge(out).to(q.dtype)


def _run(name, q, k, v, scale, head_dim, recipe):
    """The two entry points' common body: the checks, then the plain version
    on CPU tensors or the kernel on CUDA tensors, at the default tile."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {head_dim} not in {HEAD_DIMS}")
    if q.shape[-1] % head_dim:
        raise ValueError(f"{name}: width {q.shape[-1]} is not a multiple of head_dim "
                         f"{head_dim}")
    if fa._on_cpu(q, k, v):
        return softmax_recipe_plain(q, k, v, scale, head_dim, recipe=recipe)
    scale_q = float(scale) * (1.0 if recipe == "max_exp" else fa._LOG2E)
    return pa.launch(name, launches, q, k, v, head_dim, bq=pa.DEFAULT_BQ,
                     kb=pa.default_kb(head_dim), kv_len=k.shape[1], recipe=RECIPES[recipe],
                     scale_q=scale_q, scale_s=float(scale), clamp=CLAMP)


def softmax_nomax(q, k, v, scale, head_dim, *, no_max, mxu_sum):
    """P5: ``no_max`` False subtracts the row max, True clamps the exp2
    argument at ``CLAMP`` and rounds it to bf16, "fp32" clamps it and keeps
    it in fp32; ``mxu_sum`` takes the row sum from the ones column.
    q: (B, Sq, H*D); k, v: (B, Sk, H*D), bf16 on a card (row-strided views
    allowed), any float dtype on the CPU -> (B, Sq, H*D)."""
    if no_max not in (False, True, "fp32") or mxu_sum not in (False, True):
        raise ValueError(f"softmax_nomax: no_max {no_max!r} not in (False, True, 'fp32') or "
                         f"mxu_sum {mxu_sum!r} not a bool")
    return _run("softmax_nomax", q, k, v, scale, head_dim, NOMAX[(no_max, bool(mxu_sum))])


def softmax_tricks(q, k, v, scale, head_dim, variant):
    """P6: ``variant`` 0 scales the fp32 logits and normalises before PV, 1
    folds the scale into q and normalises after PV, 2 is 1 with exp2 and
    log2(e) folded into q. Operands as ``softmax_nomax``."""
    if variant not in TRICKS:
        raise ValueError(f"softmax_tricks: variant {variant!r} not in {tuple(TRICKS)}")
    return _run("softmax_tricks", q, k, v, scale, head_dim, TRICKS[variant])
