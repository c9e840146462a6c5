"""P2-P4: the no-max attention of the attention probes, on the packed
(B, S, H*D) layout. Per head, in the probes' recipe:

    qs = round(q * scale * log2(e)),  e = exp2(min(qs k^T, 115)) in fp32,
    out = (sum_j round(e_j) v_j) / (sum_j e_j)

(``round``: to q's and v's dtype), with no row max and no rescale: the
clamp at 115 keeps exp2 finite, so a key block only adds to the output and
to the row sum. Keys at or past ``kv_len`` score -inf. Exact softmax
whenever a row's largest scaled logit is below 115; saturated above it.
Nothing guards the sums against overflow: 4096 keys at the clamp reach
2^127 in the sum, and the output overflows once |v| >= 2, as the TPU
kernels do.

Three entry points, each with its probe's signature, one CUDA kernel
(``attn_nomax_wgmma_kernel`` in ``csrc/probe_attn.cu``, sm_90a) under three
schedules:

* ``kblock_attn`` (P2) replaces ``_kblock_kernel``
  (tools/probe_attn_kblock.py:33, entry ``kblock_attn`` :64): query blocks
  of ``bq`` rows, key blocks of ``kb`` keys;
* ``batchpack_attn`` (P3) replaces ``_batchpack_kernel`` (:89, entry
  ``batchpack_attn`` :116): a work item walks every batch row of its head
  and query block;
* ``nhd_with_g`` (P4) replaces ``_attn_nhd_kernel``
  (imagharmony_tpu/kernels/flash_attention.py:415) as
  ``tools/probe_attn_lanegroup.py`` ``nhd_with_g`` (:26) launches it: a
  work item walks ``g / head_dim`` heads, keys past ``kv_len`` masked.

The TPU's knobs become the card's: ``bq`` is the query rows of a work
item (64 or 128: at 128 the CTA's two consumer warpgroups take 64 rows of
one item each, at 64 each takes items of its own); ``kb`` the keys of a
tile (64 or 128; 64 at head dim 128); ``g`` the heads an item walks. A value the kernel is not
built for raises, on either device. ``batchpack_attn`` and ``nhd_with_g``
run at ``DEFAULT_BQ`` and ``default_kb(head_dim)``, where they give
``kblock_attn``'s bits at the same tiles.

On CPU tensors each entry point runs ``nomax_attn_plain``; on CUDA tensors
it launches the kernel or raises. No pipeline of the port calls them: their
path is the port's attention probes (``imagharmony_tpu_torch/probes/``).

What bounds them on an H100: the tensor cores and the exponentials alike.
At (2, 4096, 10, 64) the products are 86 GFLOP (0.087 ms at 989 TFLOP/s)
and the 335.5 M exp2 take 0.087 ms too (an SM's MUFU unit gives 16 a
clock, its tensor cores 16 scores a clock at head dim 64; at head dim 32
the exp2 take twice the products' time, at 128 half), against 42 MB. So
the kernel runs the exponentials under the products: 384-thread CTAs, a
producer warpgroup that gives its registers to two consumer warpgroups
(``setmaxnreg``), each consumer issuing tile j+1's QK^T with tile j's PV
and running tile j+1's exp2 while PV runs; at ``bq`` 128 the two consumers
share one ring and run unsynchronised, so one's exp2 also runs under the
other's products (making them take turns, ping-pong, measured slower); at
``bq`` 64 each walks its own query tiles through a ring of its own. K and
V wait on barriers of their own, and the CTAs are persistent, at most one
an SM (``plan`` reports an instance's roles and schedule).
"""

from __future__ import annotations

import functools

import torch

from imagharmony_tpu_torch.kernels import build
from imagharmony_tpu_torch.kernels import flash_attention as fa

# kernel launches since the last reset, per entry point (P2, P3, P4); only
# the CUDA launches add to them
launches = {"kblock_attn": 0, "batchpack_attn": 0, "nhd_with_g": 0}

HEAD_DIMS = (32, 64, 128)
BQS = (64, 128)
CLAMP = 115.0  # the TPU kernels' _EXP2_ARG_MAX
DEFAULT_BQ = 128


def kbs(head_dim):
    """The key-tile sizes the kernel is built for at ``head_dim``."""
    return (64,) if head_dim > 64 else (64, 128)


def default_kb(head_dim):
    return max(kbs(head_dim))


def nomax_attn_plain(q, k, v, scale, head_dim, *, kv_len=None, kb=None):
    """The reference, in the probes' recipe: qs rounded to q's dtype, e in
    fp32 clamped at 115, the row sum from the fp32 e, e rounded to v's dtype
    for PV, the division after PV. ``kv_len``: keys at or past it score -inf
    (None: every key). ``kb``: the keys are taken in blocks of ``kb`` (the
    sums accumulate block by block; blocks wholly past ``kv_len`` are
    skipped, as the TPU kernels skip them); None: one block.

    q: (B, Sq, H*D); k, v: (B, Sk, H*D) -> (B, Sq, H*D) in q's dtype."""
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    qs = (fa._split(q, head_dim) * (scale * fa._LOG2E)).to(q.dtype).float()
    kh, vh = fa._split(k, head_dim), fa._split(v, head_dim)
    step = sk if kb is None else kb
    pv = denom = None
    for j in range(0, min(sk, kv_len), step):
        je = min(j + step, sk)
        logits = torch.matmul(qs, kh[:, :, j:je].transpose(-1, -2))
        if kv_len < je:
            logits[..., kv_len - j:] = -torch.inf
        e = torch.exp2(torch.clamp(logits, max=CLAMP))
        pvj = torch.matmul(e.to(v.dtype).float(), vh[:, :, j:je])
        dj = e.sum(dim=-1, keepdim=True)
        pv = pvj if pv is None else pv + pvj
        denom = dj if denom is None else denom + dj
    return fa._merge(pv * (1.0 / denom)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    import ctypes

    fn = build.load("probe_attn").attn_nomax_bf16
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # without argtypes ctypes passes Python ints as 32-bit C ints and cuts
    # the pointers
    fn.argtypes = [ptr] * 4 + [i32] * 10 + [i64] * 6 + [i32] + [ctypes.c_float] * 3 + [ptr]
    fn.restype = i32
    return fn


# what ``plan`` reports, in the order attn_nomax_plan writes it
PLAN_FIELDS = ("threads", "producer_regs", "consumer_regs", "stages", "rings", "smem_bytes",
               "items", "units_per_item", "grid")


def plan(q, head_dim, bq, kb, *, recipe=0, heads_per_cta=1, batch_rows=1):
    """How the kernel runs on q's card (B, Sq, H*D) at these tiles, recipe
    and schedule (``heads_per_cta`` heads and ``batch_rows`` batch rows an
    item, None: all of them): {"threads", "producer_regs" and
    "consumer_regs" (the registers a thread's setmaxnreg asks for: the
    kernel's constants; ptxas's report says whether it took them),
    "stages" (K and V stages a ring), "rings" (1 at bq 128, both consumer
    warpgroups on one; 2 at bq 64), "smem_bytes", "items" (query tiles
    times head and batch groups), "units_per_item", "grid" (CTAs, at most
    one an SM)}."""
    import ctypes

    fn = build.load("probe_attn").attn_nomax_plan
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    b, sq, hd = q.shape
    info = (ctypes.c_longlong * len(PLAN_FIELDS))()
    with torch.cuda.device(q.device):
        rc = fn(head_dim, bq // 64, kb, recipe, b, sq, hd // head_dim, heads_per_cta,
                b if batch_rows is None else batch_rows, info)
    if rc:
        raise ValueError(f"attn_nomax_plan: no instance or schedule for head_dim {head_dim}, "
                         f"bq {bq}, kb {kb}, recipe {recipe} at {tuple(q.shape)}")
    return dict(zip(PLAN_FIELDS, info))


def _check_tiles(name, q, head_dim, bq, kb, g, kv_len, sk):
    """The schedule the kernel is built for, whatever the device."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {head_dim} not in {HEAD_DIMS}")
    if bq not in BQS:
        raise ValueError(f"{name}: bq {bq} not in {BQS} (64 query rows a warpgroup)")
    if kb not in kbs(head_dim):
        raise ValueError(f"{name}: kb {kb} not in {kbs(head_dim)} at head_dim {head_dim}")
    hd = q.shape[-1]
    if g % head_dim or g <= 0 or hd % g:
        raise ValueError(f"{name}: g {g} must be a multiple of head_dim {head_dim} that "
                         f"divides the width {hd}")
    if not 1 <= kv_len <= sk:
        raise ValueError(f"{name}: kv_len {kv_len} must be in [1, {sk}]")


def _run(name, q, k, v, scale, head_dim, *, bq, kb, kv_len=None, g=None, batch_rows=1):
    """The three entry points' common body: the checks, then the plain
    version on CPU tensors or the kernel on CUDA tensors, a work item walking
    ``g / head_dim`` heads (None: one) of ``batch_rows`` batch rows (None:
    all of them)."""
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    _check_tiles(name, q, head_dim, bq, kb, head_dim if g is None else g, kv_len, sk)
    if fa._on_cpu(q, k, v):
        return nomax_attn_plain(q, k, v, scale, head_dim, kv_len=kv_len, kb=kb)
    return launch(name, launches, q, k, v, head_dim, bq=bq, kb=kb, kv_len=kv_len,
                  heads_per_cta=1 if g is None else g // head_dim, batch_rows=batch_rows,
                  scale_q=float(scale) * fa._LOG2E)


def launch(name, counts, q, k, v, head_dim, *, bq, kb, kv_len, scale_q, heads_per_cta=1,
           batch_rows=1, recipe=0, scale_s=0.0, clamp=CLAMP):
    """One launch of ``attn_nomax_wgmma_kernel`` on CUDA tensors, the tiles
    checked already: the operands' device and layout checked, the output
    allocated, ``counts[name]`` raised by one once the kernel is launched.
    ``recipe``: the kernel's softmax recipe (0, P2-P4's, by default;
    ``probe_softmax.RECIPES`` names the others), with ``scale_q`` multiplying
    q, ``scale_s`` the logits and ``clamp`` bounding the exp2 argument where
    the recipe reads them."""
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v must all be on one CUDA device or all on the CPU, "
                         f"got {q.device}, {k.device}, {v.device}")
    fa._check_layout(q, k, v, head_dim, HEAD_DIMS, name)
    b, sq, hd = q.shape
    out = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q.device)
    if b == 0 or sq == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, k.shape[1], kv_len, hd // head_dim, head_dim, bq // 64, kb,
            heads_per_cta, b if batch_rows is None else batch_rows,
            q.stride(1), k.stride(1), v.stride(1), q.stride(0), k.stride(0), v.stride(0),
            recipe, scale_q, scale_s, clamp, stream,
        )
    fa._check_rc(name, rc)
    counts[name] += 1
    return out


def kblock_attn(q, k, v, scale, head_dim, bq, kb):
    """P2: no-max attention, ``bq`` query rows and ``kb`` keys a tile.
    q: (B, Sq, H*D); k, v: (B, Sk, H*D), bf16 on a card (row-strided views
    allowed), any float dtype on the CPU -> (B, Sq, H*D)."""
    return _run("kblock_attn", q, k, v, scale, head_dim, bq=bq, kb=kb)


def batchpack_attn(q, k, v, scale, head_dim):
    """P3: P2's function with every batch row of a (head, query block) in
    one work item, at ``DEFAULT_BQ`` and ``default_kb(head_dim)``."""
    return _run("batchpack_attn", q, k, v, scale, head_dim, bq=DEFAULT_BQ,
                kb=default_kb(head_dim), batch_rows=None)


def nhd_with_g(q, k, v, scale, head_dim, kv_len, g):
    """P4: P2's function with ``g / head_dim`` heads an item and the keys at or
    past ``kv_len`` masked, at ``DEFAULT_BQ`` and ``default_kb(head_dim)``."""
    return _run("nhd_with_g", q, k, v, scale, head_dim, bq=DEFAULT_BQ,
                kb=default_kb(head_dim), kv_len=kv_len, g=g)
