"""K1: fused self-attention on the packed (B, S, H*D) layout; K3, its
backward; K4: the same forward on the head-split (B, H, S, D) layout.

``flash_attention_nhd`` replaces the TPU kernel ``_attn_nhd_kernel``
(imagharmony_tpu/kernels/flash_attention.py:415, entry
``flash_attention_nhd`` :576). On a CUDA tensor it launches the hand-written
sm_90a kernel ``attn_fwd_wgmma_kernel`` in ``csrc/flash_attn_nhd.cu``
(wgmma products, TMA copies through a two-stage ring; see the source); on a
CPU tensor it runs ``flash_attention_nhd_plain``. There is no fallback
between the two: a CUDA tensor the kernel does not take raises.

When a gradient is needed (grad mode on and an input requires grad) the
call goes through ``FlashAttnNHD``, whose backward replaces the TPU kernel
``_attn_bwd_kernel`` (:220, reached from ``_flash_nhd_bwd`` :540): on CUDA
tensors K3 (``csrc/flash_attn_nhd_bwd.cu``: a prep kernel, then the dK/dV
and the dQ kernels, wgmma and TMA as K1), fed by the row log-sum-exp K1
writes in that case; on CPU tensors ``flash_attention_nhd_bwd_plain``.

What bounds K1 on an H100: at head_dim 64 it is compute-bound. S=4096 with
10 heads and B=2 is 4*B*H*S*S*D = 86 GFLOP per call against ~42 MB of q, k,
v and output, about 2000 flop/byte, far above the ~295 flop/byte at which
the tensor cores become the limit. The kernel therefore keeps the (Sq, Sk)
logits in registers (online softmax over key tiles) and never writes them
to device memory, which the plain version does in fp32. K3 does
10*B*H*S*S*D flops with the same property and the same design.

All of them read their operands with TMA, which takes a base address and
strides that are multiples of 16 bytes; the wrappers check that before any
launch and raise otherwise.

Each launch declares its cost to ``kernels/cost.py`` with the JAX
``pl.CostEstimate`` formula (K1 and K4 4·b·h·sq·sk·d flops, K3
11·b·h·sq·sk·d), so ``utils/profiling.compiled_stats`` counts it; a CPU call
declares nothing, its plain version's products being counted instead.

``flash_attention`` (K4) replaces the TPU kernel ``_attn_kernel`` (:95, entry
``flash_attention`` :369 through ``_flash_fwd_impl`` :138): the same forward
on (B, H, S, D) tensors with a batch, a head and a row stride each, at head
dims 40, 80 and 160 (the SD1.5 family) besides K1's. On CUDA tensors it
launches the second entry point of ``csrc/flash_attn_nhd.cu``, which runs
K1's device kernel on K4's strides: a head of d columns is ceil(d/64)
panels of 64, the columns past d zero-filled by TMA in shared memory only,
where the TPU kernel pads d to a multiple of 64 in device memory. At d=40
and S=4096 (B=2, H=8) it is compute-bound like K1: 43 GFLOP against 21 MB.
When a gradient is needed the call goes through ``FlashAttn``, whose
backward replaces the same TPU kernel K1's does (``_attn_bwd_kernel`` :220,
here reached from ``_flash_bwd`` :350): on CUDA tensors K3's head-split
entry point, fed by the lse K4 then writes; on CPU tensors
``flash_attention_bwd_plain``.

The TPU kernels' dispatch rules (Sk >= 512, heads packed into 128 lanes, the
no-max clamped exp2, sequences padded to 256, the measured gate on head dim
and length) are TPU rules and are not carried over: every self-attention of
the UNets goes through K1 or K4, and both compute the exact softmax with the
ragged edges masked in the kernel.
"""

from __future__ import annotations

import functools

import torch

from imagharmony_tpu_torch.kernels import build, cost

# Kernel launches since the last reset; only the CUDA launches add to them.
launches = 0       # K1
bwd_launches = 0   # K3, either layout (one per backward call: its three kernels)
bhsd_launches = 0  # K4

HEAD_DIMS = (32, 64, 128)
BHSD_HEAD_DIMS = (32, 40, 64, 80, 128, 160)
BWD_HEAD_DIMS = BHSD_HEAD_DIMS
_LOG2E = 1.4426950408889634


def _split(x, head_dim):
    b, s, hd = x.shape
    return x.reshape(b, s, hd // head_dim, head_dim).transpose(1, 2).float()


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def flash_attention_nhd_plain(q, k, v, *, scale, head_dim):
    """Reference: fp32 logits, fp32 softmax, fp32 PV, cast back to q's dtype.

    q: (B, Sq, H*D); k, v: (B, Sk, H*D) -> (B, Sq, H*D)."""
    logits = torch.matmul(_split(q, head_dim), _split(k, head_dim).transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    return _merge(torch.matmul(probs, _split(v, head_dim))).to(q.dtype)


def lse_plain(q, k, *, scale, head_dim):
    """The row log-sum-exp K1 writes, in its scaled-log2 domain:
    log2(sum_j 2^(s_j)) with s = q.k * scale * log2(e), i.e. the natural
    logsumexp of the logits times log2(e). fp32 (B, H, Sq)."""
    logits = torch.matmul(_split(q, head_dim), _split(k, head_dim).transpose(-1, -2)) * scale
    return torch.logsumexp(logits, dim=-1) * _LOG2E


def _bwd_formulas(qh, kh, vh, gh, scale):
    """The attention backward in explicit fp32 formulas on (B, H, S, D)
    tensors (the counterpart of the JAX package's ``_bwd_xla``):
    P = softmax(q k^T scale), dV = P^T dO, dP = dO V^T,
    dS = P o (dP - rowsum(dP o P)), dQ = scale dS K, dK = scale dS^T Q."""
    qh, kh, vh, gh = (x.float() for x in (qh, kh, vh, gh))
    probs = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(probs.transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True)) * scale
    return torch.matmul(ds, kh), torch.matmul(ds.transpose(-1, -2), qh), dv


def flash_attention_nhd_bwd_plain(q, k, v, dout, *, scale, head_dim):
    """K3's reference on K1's layout: ``_bwd_formulas`` on packed
    (B, S, H*D) tensors. Returns (dq, dk, dv) in the inputs' dtypes, packed
    (B, S, H*D)."""
    grads = _bwd_formulas(*(_split(x, head_dim) for x in (q, k, v, dout)), scale)
    return tuple(_merge(g).to(x.dtype) for g, x in zip(grads, (q, k, v)))


@functools.lru_cache(maxsize=None)
def _entry():
    import ctypes

    fn = build.load("flash_attn_nhd").flash_attn_nhd_bf16
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # without argtypes ctypes passes Python ints as 32-bit C ints and cuts
    # the pointers
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                   i64, i64, i64, i64, i64, i64, ctypes.c_float, ptr]
    fn.restype = i32
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    import ctypes

    fn = build.load("flash_attn_nhd_bwd").flash_attn_nhd_bwd_bf16
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [ptr] * 10 + [i32] * 5 + [i64] * 10 + [f32, f32, ptr]
    fn.restype = i32
    return fn


@functools.lru_cache(maxsize=None)
def _bhsd_entry():
    import ctypes

    fn = build.load("flash_attn_nhd").flash_attn_bhsd_bf16
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [ptr] * 5 + [i32] * 5 + [i64] * 12 + [ctypes.c_float, ptr]
    fn.restype = i32
    return fn


@functools.lru_cache(maxsize=None)
def _bhsd_bwd_entry():
    import ctypes

    fn = build.load("flash_attn_nhd_bwd").flash_attn_bhsd_bwd_bf16
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [ptr] * 10 + [i32] * 5 + [i64] * 24 + [f32, f32, ptr]
    fn.restype = i32
    return fn


def bwd_smem_bytes(head_dim):
    """The dynamic shared memory K3's launches ask for at ``head_dim``:
    {"attn_bwd_dkdv_kernel": bytes, "attn_bwd_dq_kernel": bytes}, read from
    the built library."""
    import ctypes

    fn = build.load("flash_attn_nhd_bwd").flash_attn_bwd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    return {"attn_bwd_dkdv_kernel": fn(head_dim, 0), "attn_bwd_dq_kernel": fn(head_dim, 1)}


def _bwd_scratch(b, sq, heads, head_dim, device):
    """The scratch K3 takes as its ``delta`` argument: the lse and Delta,
    fp32 (B, H, Sq rounded up to 64) each, then q times scale*log2(e) as
    bf16 (B, Sq, H, D), the layout ``flash_attn_nhd_bwd.cu`` documents."""
    sq_pad = -(-sq // 64) * 64
    n = 8 * b * heads * sq_pad + 2 * b * sq * heads * head_dim
    return torch.empty((-(-n // 4),), dtype=torch.float32, device=device)


def _check_operand(name, x, batch, hd):
    """A packed (batch, S, hd) operand with unit stride on its last axis and
    its address and row and batch strides multiples of 16 bytes (the TMA's
    rule), checked before any library is loaded."""
    if x.dim() != 3 or x.shape[0] != batch or x.shape[2] != hd:
        raise ValueError(f"{name} must be ({batch}, S, {hd}), got {tuple(x.shape)}")
    if x.stride(2) != 1:
        raise ValueError(f"{name} must have unit stride on its last axis, got {x.stride()}")
    if x.stride(1) % 8 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(
            f"{name} rows must be 16-byte aligned (strides {x.stride()}, "
            f"address {x.data_ptr():#x})"
        )


def _check_cuda(q, k, v, head_dim, head_dims):
    """The checks K1 and K3 share: one CUDA device, then ``_check_layout``."""
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention_nhd: q, k, v must all be on one CUDA device or all "
            f"on the CPU, got {q.device}, {k.device}, {v.device}"
        )
    _check_layout(q, k, v, head_dim, head_dims)


def _check_layout(q, k, v, head_dim, head_dims, entry="flash_attention_nhd"):
    """The packed attention kernels' operands whatever their device (K1's
    and K3's, and the no-max probes', whose ``entry`` names them in the
    errors): bf16, a supported head dim, packed shapes with 16-byte aligned
    rows (``_check_operand``), a nonempty k."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(
            f"{entry}: the CUDA kernel takes bf16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if head_dim not in head_dims:
        raise ValueError(f"{entry}: head_dim {head_dim} not in {head_dims}")
    b, _, hd = q.shape
    if hd % head_dim:
        raise ValueError(f"{entry}: width {hd} is not a multiple of {head_dim}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(f"{entry}: {name}", x, b, hd)
    if v.shape[1] != k.shape[1]:
        raise ValueError(f"{entry}: k and v lengths differ: {k.shape[1]} vs {v.shape[1]}")
    if k.shape[1] == 0:
        raise ValueError(f"{entry}: k is empty")


_TMA_REFUSED = 12  # cudaErrorInvalidPitchValue: the libraries' code for a refused tensor map


def _check_rc(name, rc):
    if rc == _TMA_REFUSED:
        raise RuntimeError(f"{name}: the driver refused a TMA tensor map for an operand "
                           f"(CUDA error {rc}); no kernel was launched")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _on_cpu(*xs):
    return all(x.device.type == "cpu" for x in xs)


def _launch_fwd(q, k, v, *, scale, head_dim, with_lse):
    """K1 on CUDA tensors -> (out, lse or None)."""
    global launches
    _check_cuda(q, k, v, head_dim, HEAD_DIMS)
    b, sq, hd = q.shape
    out = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((b, hd // head_dim, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or sq == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            b, sq, k.shape[1], hd // head_dim, head_dim,
            q.stride(1), k.stride(1), v.stride(1),
            q.stride(0), k.stride(0), v.stride(0),
            float(scale) * _LOG2E, stream,
        )
    _check_rc("flash_attention_nhd", rc)
    launches += 1
    if cost.active():
        cost.declare("K1", *cost.attention(b, hd // head_dim, sq, k.shape[1], head_dim, 2))
    return out, lse


def flash_attention_nhd_fwd(q, k, v, *, scale, head_dim):
    """The forward with the row log-sum-exp the backward needs: (out, lse),
    lse fp32 (B, H, Sq) in the scaled-log2 domain (see ``lse_plain``). CPU
    tensors take the plain versions; CUDA tensors launch K1."""
    if _on_cpu(q, k, v):
        return (flash_attention_nhd_plain(q, k, v, scale=scale, head_dim=head_dim),
                lse_plain(q, k, scale=scale, head_dim=head_dim))
    return _launch_fwd(q, k, v, scale=scale, head_dim=head_dim, with_lse=True)


def flash_attention_nhd_bwd(q, k, v, out, lse, dout, *, scale, head_dim):
    """K3 on CUDA tensors: (dq, dk, dv), each contiguous bf16 (B, S, H*D).

    q, k, v as for K1 (row-strided views allowed); out and lse from
    ``flash_attention_nhd_fwd`` on the same inputs; dout the gradient of
    out. Raises on anything the kernel does not take (including head dims
    outside BWD_HEAD_DIMS)."""
    global bwd_launches
    _check_cuda(q, k, v, head_dim, BWD_HEAD_DIMS)
    b, sq, hd = q.shape
    sk = k.shape[1]
    heads = hd // head_dim
    for name, x in (("out", out), ("dout", dout)):
        if x.device != q.device or x.dtype != torch.bfloat16 or x.shape != q.shape:
            raise ValueError(f"{name} must be bf16 {tuple(q.shape)} on {q.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        _check_operand(name, x, b, hd)
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, heads, sq) or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous fp32 {(b, heads, sq)} on {q.device}")
    dq = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q.device)
    dk = torch.empty((b, sk, hd), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty((b, sk, hd), dtype=torch.bfloat16, device=q.device)
    if b == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    scratch = _bwd_scratch(b, sq, heads, head_dim, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, sk, heads, head_dim,
            q.stride(1), k.stride(1), v.stride(1), out.stride(1), dout.stride(1),
            q.stride(0), k.stride(0), v.stride(0), out.stride(0), dout.stride(0),
            float(scale), float(scale) * _LOG2E, stream,
        )
    _check_rc("flash_attention_nhd_bwd", rc)
    bwd_launches += 1
    if cost.active():
        cost.declare("K3", *cost.attention_bwd(b, heads, sq, sk, head_dim, 2))
    return dq, dk, dv


class FlashAttnNHD(torch.autograd.Function):
    """K1 with a gradient. Forward saves q, k, v, out and lse; backward runs
    K3 on CUDA tensors and ``flash_attention_nhd_bwd_plain`` on CPU tensors,
    and returns the gradients of the inputs that need them."""

    @staticmethod
    def forward(ctx, q, k, v, scale, head_dim):
        out, lse = flash_attention_nhd_fwd(q, k, v, scale=scale, head_dim=head_dim)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.head_dim = scale, head_dim
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        kw = dict(scale=ctx.scale, head_dim=ctx.head_dim)
        if _on_cpu(q, k, v):
            grads = flash_attention_nhd_bwd_plain(q, k, v, dout, **kw)
        else:
            grads = flash_attention_nhd_bwd(q, k, v, out, lse, _aligned(dout), **kw)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad[:3])) + (None, None)


def flash_attention_nhd(q, k, v, *, scale, head_dim):
    """softmax(q k^T * scale) v per head on packed (B, S, H*D) tensors.

    q: (B, Sq, H*D); k, v: (B, Sk, H*D), each with unit stride on the last
    axis and any row stride (column slices of one packed to_qkv output are
    taken as they are). Returns a contiguous (B, Sq, H*D) tensor.

    CPU tensors go to ``flash_attention_nhd_plain``. CUDA tensors must be
    bf16 with head_dim in HEAD_DIMS (all of which K3 takes too); anything
    else raises. With grad mode on and an input that requires grad, the call
    goes through ``FlashAttnNHD`` so the result has a ``grad_fn``.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if not _on_cpu(q, k, v):
            _check_cuda(q, k, v, head_dim, BWD_HEAD_DIMS)
        return FlashAttnNHD.apply(q, k, v, scale, head_dim)
    if _on_cpu(q, k, v):
        return flash_attention_nhd_plain(q, k, v, scale=scale, head_dim=head_dim)
    return _launch_fwd(q, k, v, scale=scale, head_dim=head_dim, with_lse=False)[0]


def flash_attention_plain(q, k, v, *, scale):
    """K4's reference: fp32 logits, fp32 softmax, fp32 PV, cast back to q's
    dtype. q: (B, H, Sq, D); k, v: (B, H, Sk, D) -> (B, H, Sq, D)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, dout, *, scale):
    """K3's reference on K4's layout: ``_bwd_formulas`` on (B, H, S, D)
    tensors. Returns (dq, dk, dv) in the inputs' dtypes."""
    grads = _bwd_formulas(q, k, v, dout, scale)
    return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))


def _check_bhsd(q, k, v):
    """What K4 takes: one CUDA device and an operand layout
    ``_check_bhsd_layout`` accepts."""
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention: q, k, v must all be on one CUDA device or all on the "
            f"CPU, got {q.device}, {k.device}, {v.device}"
        )
    _check_bhsd_layout(q, k, v)


def _check_bhsd_operand(name, x):
    """Unit stride along D, every other stride and the address 16-byte
    aligned."""
    if x.stride(3) != 1:
        raise ValueError(
            f"flash_attention: {name} must have unit stride on its last axis, got {x.stride()}"
        )
    if any(st % 8 for st in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {name}'s batches, heads and rows must be 16-byte "
            f"aligned (strides {x.stride()}, address {x.data_ptr():#x})"
        )


def _check_bhsd_layout(q, k, v):
    """K4's operands whatever their device: bf16, (B, H, S, D) with a head
    dim in BHSD_HEAD_DIMS, unit stride along D, every other stride and the
    address 16-byte aligned, a nonempty k, grid-sized batch and heads."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(
            f"flash_attention: the CUDA kernel takes bf16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
            (q.shape[0], q.shape[1], q.shape[3]) != (k.shape[0], k.shape[1], k.shape[3])):
        raise ValueError(
            f"flash_attention: q must be (B, H, Sq, D) and k, v (B, H, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, _, d = q.shape
    if d not in BHSD_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {BHSD_HEAD_DIMS}")
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: batch {b} and heads {h} must each be <= 65535")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: k is empty")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_bhsd_operand(name, x)


def _heads_last(b, h, s, d, device):
    """An empty bf16 (B, H, S, D) view of a contiguous (B, S, H*D) buffer:
    merging its heads is free."""
    return torch.empty((b, s, h, d), dtype=torch.bfloat16, device=device).transpose(1, 2)


def _launch_bhsd(q, k, v, *, scale, with_lse):
    """K4 on CUDA tensors -> (out, lse or None); out a (B, H, Sq, D) view of a
    contiguous (B, Sq, H*D) buffer, lse fp32 (B, H, Sq)."""
    global bhsd_launches
    _check_bhsd(q, k, v)
    b, h, sq, d = q.shape
    out = _heads_last(b, h, sq, d, q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or h == 0 or sq == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bhsd_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            b, sq, k.shape[2], h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale) * _LOG2E, stream,
        )
    _check_rc("flash_attention", rc)
    bhsd_launches += 1
    if cost.active():
        cost.declare("K4", *cost.attention(b, h, sq, k.shape[2], d, 2))
    return out, lse


def flash_attention_fwd(q, k, v, *, scale):
    """K4's forward with what its backward needs: (out, lse). CPU tensors
    take the plain version and no lse (None); CUDA tensors launch K4, which
    writes lse as K1 does (see ``lse_plain``)."""
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale=scale), None
    return _launch_bhsd(q, k, v, scale=scale, with_lse=True)


def _aligned(x):
    """x itself where K3 takes its layout, else a contiguous copy (autograd
    may hand an expanded, zero-stride gradient)."""
    aligned = not any(st % 8 for st in x.stride()[:-1]) and x.data_ptr() % 16 == 0
    return x if x.stride(-1) == 1 and aligned else x.contiguous()


def flash_attention_bwd(q, k, v, out, lse, dout, *, scale):
    """K3 on K4's layout, CUDA tensors: (dq, dk, dv), each a bf16
    (B, H, S, D) view of a contiguous (B, S, H*D) buffer.

    q, k, v as for K4 (strided views allowed); out and lse from
    ``flash_attention_fwd`` on the same inputs; dout the gradient of out, any
    16-byte aligned strides. Raises on anything the kernel does not take."""
    global bwd_launches
    _check_bhsd(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for name, x in (("out", out), ("dout", dout)):
        if x.device != q.device or x.dtype != torch.bfloat16 or x.shape != q.shape:
            raise ValueError(f"flash_attention: {name} must be bf16 {tuple(q.shape)} on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        _check_bhsd_operand(name, x)
    if (lse is None or lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, h, sq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: lse must be contiguous fp32 {(b, h, sq)} on "
                         f"{q.device}")
    dq, dk, dv = (_heads_last(b, h, n, d, q.device) for n in (sq, sk, sk))
    if b == 0 or h == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    scratch = _bwd_scratch(b, sq, h, d, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bhsd_bwd_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, sk, h, d,
            *(st for x in (q, k, v, out, dout, dq, dk, dv) for st in x.stride()[:3]),
            float(scale), float(scale) * _LOG2E, stream,
        )
    _check_rc("flash_attention: K3", rc)
    bwd_launches += 1
    if cost.active():
        cost.declare("K3", *cost.attention_bwd(b, h, sq, sk, d, 2))
    return dq, dk, dv


class FlashAttn(torch.autograd.Function):
    """K4 with a gradient. Forward saves q, k, v, out and lse; backward runs
    K3's head-split entry point on CUDA tensors and
    ``flash_attention_bwd_plain`` on CPU tensors, and returns the gradients
    of the inputs that need them."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if _on_cpu(q, k, v):
            grads = flash_attention_bwd_plain(q, k, v, dout, scale=ctx.scale)
        else:
            grads = flash_attention_bwd(q, k, v, out, lse, _aligned(dout), scale=ctx.scale)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad[:3])) + (None,)


def flash_attention(q, k, v, *, scale):
    """softmax(q k^T * scale) v per head on head-split tensors (K4).

    q: (B, H, Sq, D); k, v: (B, H, Sk, D), each with unit stride along D and
    any 16-byte aligned batch, head and row stride: ``split_heads`` views of a
    packed to_qkv output are taken as they are. Returns (B, H, Sq, D) as a
    view of a contiguous (B, Sq, H*D) buffer, so merging the heads is free.

    CPU tensors go to ``flash_attention_plain``. CUDA tensors must be bf16
    with D in BHSD_HEAD_DIMS (all of which K3 takes too); anything else
    raises. With grad mode on and an input that requires grad, the call goes
    through ``FlashAttn`` so the result has a ``grad_fn``; on CUDA tensors
    its operands are checked before.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if not _on_cpu(q, k, v):
            _check_bhsd(q, k, v)
        return FlashAttn.apply(q, k, v, scale)
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale=scale)
    return _launch_bhsd(q, k, v, scale=scale, with_lse=False)[0]
