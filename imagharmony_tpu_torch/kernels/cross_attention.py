"""K2: fused cross-attention with the decoupled image-prompt (IP) branch on
the packed (B, S, H*D) layout:

    out = softmax(q k^T * scale) v + ip_scale * softmax(q k_ip^T * scale) v_ip

``flash_cross_nhd`` replaces the TPU kernel ``_cross_ip_nhd_kernel``
(imagharmony_tpu/kernels/flash_attention.py:630, entry ``flash_cross_nhd``
:795 through ``_cross_nhd_impl`` :670). On a CUDA tensor it launches the
hand-written sm_90a kernel ``cross_attn_wgmma_kernel`` in
``csrc/cross_attn_nhd.cu``; on a CPU tensor it runs
``flash_cross_nhd_plain``. There is no fallback between the two: a CUDA
tensor the kernel does not take raises.

The JAX model keeps these cross-attentions on XLA (its K2 lost to XLA on a
TPU); the port sends every one of them, text-only or with the IP branch,
through K2: one launch where the plain chain is ~10-20 kernels. Both
branches use the exact fp32 softmax with their own max and normaliser, as
the JAX model's XLA path does; ``ip_scale`` is an argument, not folded into
v_ip, so 0.0 (``ip_scale_schedule``'s off steps) gives the text branch
alone. The kernel reads ``ip_scale`` from device memory: a 0-dim fp32
tensor on q's device is passed as it is (so a captured launch reads each
step's weight from the table the denoise loop indexes), a float goes
through a tensor kept per (device, value), and a (B,) fp32 vector gives
each batch row its own weight (the slot engine's rows sit at different
steps of the schedule: the JAX chunk step's (2S, 1, 1, 1) ``ip_scale``,
imagharmony_tpu/pipelines/continuous.py:96,119). A 0-dim weight launches
the same kernel with a row stride of 0, so its bits are the vector's of
equal values.

When a gradient is needed the call goes through ``FlashCrossNHD``, whose
backward is the plain-formula backward of each branch on either device: the
counterpart of ``_cross_xla_bwd`` (:739) and ``_flash_cross_ip_bwd`` (:785),
which are XLA in the JAX package, not Pallas.

What bounds K2 on an H100: bytes. At SDXL's (2, 4096, 10, 64) with 77 + 4
keys it does 1.7 GFLOP against ~21 MB of q, output and K/V. So the kernel
keeps a head's few keys in shared memory for a whole run of query tiles and
streams q in and the output out by TMA (wgmma products, an mbarrier ring;
see the source). Like K1, it reads its operands with TMA, which takes base
addresses and strides that are multiples of 16 bytes (checked here before
any launch); an operand expanded over the batch (batch stride 0) is read
as one batch.

Each launch declares its cost to ``kernels/cost.py`` with the JAX
``pl.CostEstimate`` formula (4·b·h·sq·(text + IP keys)·d flops); a CPU call
declares nothing.
"""

from __future__ import annotations

import functools

import torch

from imagharmony_tpu_torch.kernels import build, cost
from imagharmony_tpu_torch.kernels import flash_attention as fa

# K2 launches since the last reset, all and those with the IP branch; only
# the CUDA launches add to them.
cross_launches = 0
cross_ip_launches = 0

HEAD_DIMS = (32, 40, 64, 80, 128, 160)
_LOG2E = 1.4426950408889634


def _attend(qh, k, v, scale, head_dim):
    """fp32 softmax(qh k^T scale) v on (B, H, Sq, D) qh and packed k, v."""
    logits = torch.matmul(qh, fa._split(k, head_dim).transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1), fa._split(v, head_dim))


def _per_row(ip_scale, dims):
    """``ip_scale`` shaped to multiply a (B, ...) tensor of ``dims`` axes:
    a (B,) vector as (B, 1, ...), a float or 0-dim tensor as it is."""
    if isinstance(ip_scale, torch.Tensor) and ip_scale.dim() == 1:
        return ip_scale.view(-1, *(1,) * (dims - 1))
    return ip_scale


def flash_cross_nhd_plain(q, k, v, *, scale, head_dim, k_ip=None, v_ip=None, ip_scale=1.0):
    """K2's reference: fp32 logits, softmax and PV per branch, the IP branch
    times ``ip_scale`` (a float, a 0-dim fp32 tensor or a (B,) fp32 vector,
    one weight a batch row) added in fp32, cast to q's dtype.

    q: (B, Sq, H*D); k, v: (B, Sk, H*D); k_ip, v_ip: (B, Sk_ip, H*D) or None
    -> (B, Sq, H*D)."""
    qh = fa._split(q, head_dim)
    out = _attend(qh, k, v, scale, head_dim)
    if k_ip is not None:
        out = out + _per_row(ip_scale, 4) * _attend(qh, k_ip, v_ip, scale, head_dim)
    return fa._merge(out).to(q.dtype)


def flash_cross_nhd_bwd_plain(q, k, v, k_ip, v_ip, dout, *, scale, head_dim, ip_scale):
    """The gradients of (q, k, v, k_ip, v_ip) in explicit formulas, each
    branch as softmax attention (``fa.flash_attention_nhd_bwd_plain``), the
    IP branch with dout * ip_scale; dq sums both. k_ip, v_ip None -> their
    gradients None."""
    kw = dict(scale=scale, head_dim=head_dim)
    dq, dk, dv = fa.flash_attention_nhd_bwd_plain(q, k, v, dout, **kw)
    if k_ip is None:
        return dq, dk, dv, None, None
    dq_ip, dk_ip, dv_ip = fa.flash_attention_nhd_bwd_plain(
        q, k_ip, v_ip, dout * _per_row(ip_scale, dout.dim()), **kw)
    return dq + dq_ip, dk, dv, dk_ip, dv_ip


@functools.lru_cache(maxsize=None)
def _entry():
    import ctypes

    fn = build.load("cross_attn_nhd").cross_attn_nhd_bf16
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # without argtypes ctypes passes Python ints as 32-bit C ints and cuts
    # the pointers
    fn.argtypes = [ptr] * 6 + [i32] * 6 + [i64] * 18 + [f32, ptr, i32, ptr]
    fn.restype = i32
    return fn


@functools.lru_cache(maxsize=None)
def _weight(device, value):
    """A float IP weight as the one fp32 on ``device`` that the kernel
    reads; kept for the process, so a launch captured with it stays valid."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _check_ip_scale(ip_scale, device, batch):
    """A tensor ``ip_scale`` must be fp32 on ``device``, 0-dim or one
    weight a batch row, (``batch``,)."""
    if not isinstance(ip_scale, torch.Tensor):
        return
    if (ip_scale.dim() > 1 or ip_scale.dtype != torch.float32 or ip_scale.device != device
            or (ip_scale.dim() == 1 and ip_scale.shape[0] != batch)):
        raise ValueError(f"flash_cross_nhd: a tensor ip_scale must be 0-dim or ({batch},) fp32 "
                         f"on {device}, got {tuple(ip_scale.shape)} {ip_scale.dtype} on "
                         f"{ip_scale.device}")


def _ip_weight(ip_scale, device, batch):
    """(the fp32 weights on ``device`` holding ``ip_scale``, the elements
    between two batch rows' weights): a float or a 0-dim fp32 tensor there
    gives every row one weight (stride 0), a (``batch``,) fp32 vector there
    one weight a row."""
    if not isinstance(ip_scale, torch.Tensor):
        return _weight(device, float(ip_scale)), 0
    _check_ip_scale(ip_scale, device, batch)
    return ip_scale, ip_scale.stride(0) if ip_scale.dim() == 1 else 0


def _operands(q, k, v, k_ip, v_ip):
    ops = [("q", q), ("k", k), ("v", v)]
    return ops + ([("k_ip", k_ip), ("v_ip", v_ip)] if k_ip is not None else [])


def _check_cuda(q, k, v, k_ip, v_ip, head_dim):
    """What K2 takes: one CUDA device and operands ``_check_layout``
    accepts."""
    ops = _operands(q, k, v, k_ip, v_ip)
    if not (q.is_cuda and all(x.device == q.device for _, x in ops)):
        raise ValueError(f"flash_cross_nhd: {', '.join(n for n, _ in ops)} must all be on one "
                         f"CUDA device or all on the CPU, got "
                         f"{', '.join(str(x.device) for _, x in ops)}")
    _check_layout(q, k, v, k_ip, v_ip, head_dim)


def _check_layout(q, k, v, k_ip, v_ip, head_dim):
    """K2's operands whatever their device: bf16, a head dim in HEAD_DIMS,
    packed (B, S, H*D) operands with unit stride on the last axis and
    16-byte aligned rows, nonempty keys of equal length in k and v (and in
    k_ip and v_ip), grid-sized batch and heads."""
    ops = _operands(q, k, v, k_ip, v_ip)
    if any(x.dtype != torch.bfloat16 for _, x in ops):
        raise TypeError(f"flash_cross_nhd: the CUDA kernel takes bf16, got "
                        f"{', '.join(str(x.dtype) for _, x in ops)}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_cross_nhd: head_dim {head_dim} not in {HEAD_DIMS}")
    if q.dim() != 3 or q.shape[2] % head_dim:
        raise ValueError(f"flash_cross_nhd: q must be (B, Sq, H*{head_dim}), got "
                         f"{tuple(q.shape)}")
    b, _, hd = q.shape
    if b > 65535 or hd // head_dim > 65535:
        raise ValueError(f"flash_cross_nhd: batch {b} and heads {hd // head_dim} must each "
                         f"be <= 65535")
    for name, x in ops:
        if x.dim() != 3 or x.shape[0] != b or x.shape[2] != hd:
            raise ValueError(f"flash_cross_nhd: {name} must be ({b}, S, {hd}), got "
                             f"{tuple(x.shape)}")
        if x.stride(2) != 1:
            raise ValueError(f"flash_cross_nhd: {name} must have unit stride on its last "
                             f"axis, got {x.stride()}")
        if x.stride(1) % 8 or x.stride(0) % 8 or x.data_ptr() % 16:
            raise ValueError(f"flash_cross_nhd: {name}'s rows must be 16-byte aligned "
                             f"(strides {x.stride()}, address {x.data_ptr():#x})")
    for kx, vx, what in ((k, v, "k and v"), (k_ip, v_ip, "k_ip and v_ip")):
        if kx is None:
            continue
        if kx.shape[1] != vx.shape[1]:
            raise ValueError(f"flash_cross_nhd: {what} lengths differ: {kx.shape[1]} vs "
                             f"{vx.shape[1]}")
        if kx.shape[1] == 0:
            raise ValueError(f"flash_cross_nhd: {what} are empty")


def _launch(q, k, v, k_ip, v_ip, *, scale, head_dim, ip_scale):
    """K2 on CUDA tensors -> a contiguous bf16 (B, Sq, H*D) tensor."""
    global cross_launches, cross_ip_launches
    _check_cuda(q, k, v, k_ip, v_ip, head_dim)
    b, sq, hd = q.shape
    out = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q.device)
    if b == 0 or sq == 0:
        return out

    def strides(x):  # batch, head, row
        return (x.stride(0), head_dim, x.stride(1)) if x is not None else (0, 0, 0)

    weight, ip_stride = _ip_weight(ip_scale, q.device, b) if k_ip is not None else (None, 0)

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(
            *(x.data_ptr() if x is not None else None for x in (q, k, v, k_ip, v_ip, out)),
            b, sq, k.shape[1], k_ip.shape[1] if k_ip is not None else 0, hd // head_dim,
            head_dim, *(st for x in (q, k, v, k_ip, v_ip, out) for st in strides(x)),
            float(scale) * _LOG2E, None if weight is None else weight.data_ptr(), ip_stride,
            stream,
        )
    fa._check_rc("flash_cross_nhd", rc)
    cross_launches += 1
    cross_ip_launches += k_ip is not None
    if cost.active():
        cost.declare("K2", *cost.cross(b, hd // head_dim, sq, k.shape[1],
                                       k_ip.shape[1] if k_ip is not None else 0, head_dim, 2))
    return out


def _forward(q, k, v, k_ip, v_ip, *, scale, head_dim, ip_scale):
    if fa._on_cpu(*(x for x in (q, k, v, k_ip, v_ip) if x is not None)):
        return flash_cross_nhd_plain(q, k, v, scale=scale, head_dim=head_dim, k_ip=k_ip,
                                     v_ip=v_ip, ip_scale=ip_scale)
    return _launch(q, k, v, k_ip, v_ip, scale=scale, head_dim=head_dim, ip_scale=ip_scale)


class FlashCrossNHD(torch.autograd.Function):
    """K2 with a gradient. Forward saves its inputs; backward is
    ``flash_cross_nhd_bwd_plain`` on either device, and returns the
    gradients of the inputs that need them (d(v_ip) carries ip_scale)."""

    @staticmethod
    def forward(ctx, q, k, v, k_ip, v_ip, scale, head_dim, ip_scale):
        ctx.save_for_backward(q, k, v, k_ip, v_ip)
        ctx.kw = dict(scale=scale, head_dim=head_dim, ip_scale=ip_scale)
        return _forward(q, k, v, k_ip, v_ip, **ctx.kw)

    @staticmethod
    def backward(ctx, dout):
        grads = flash_cross_nhd_bwd_plain(*ctx.saved_tensors, dout, **ctx.kw)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad[:5])) + (None,) * 3


def flash_cross_nhd(q, k, v, *, scale, head_dim, k_ip=None, v_ip=None, ip_scale=1.0):
    """softmax(q k^T * scale) v + ip_scale * softmax(q k_ip^T * scale) v_ip per
    head on packed tensors; the text branch alone when k_ip, v_ip are None.

    q: (B, Sq, H*D); k, v: (B, Sk, H*D); k_ip, v_ip: (B, Sk_ip, H*D), each
    with unit stride on the last axis and any 16-byte aligned row and batch
    stride (k and v as column views of one packed to_kv output are taken as
    they are). Returns a contiguous (B, Sq, H*D) tensor.

    ip_scale: a float, a 0-dim fp32 tensor on q's device, or a (B,) fp32
    vector there, one weight a batch row (a tensor is read there by the
    kernel, never by the host).

    CPU tensors go to ``flash_cross_nhd_plain``. CUDA tensors must be bf16
    with head_dim in HEAD_DIMS; anything else raises. With grad mode on and
    an input that requires grad, the call goes through ``FlashCrossNHD`` so
    the result has a ``grad_fn``; on CUDA tensors its operands are checked
    before.
    """
    if (k_ip is None) != (v_ip is None):
        raise ValueError("flash_cross_nhd: give both k_ip and v_ip, or neither")
    if not isinstance(ip_scale, torch.Tensor):
        ip_scale = float(ip_scale)
    elif k_ip is not None:
        _check_ip_scale(ip_scale, q.device, q.shape[0])
    kw = dict(scale=scale, head_dim=head_dim, ip_scale=ip_scale)
    ops = [x for x in (q, k, v, k_ip, v_ip) if x is not None]
    if torch.is_grad_enabled() and any(x.requires_grad for x in ops):
        if not fa._on_cpu(*ops):
            _check_cuda(q, k, v, k_ip, v_ip, head_dim)
        return FlashCrossNHD.apply(q, k, v, k_ip, v_ip, *kw.values())
    return _forward(q, k, v, k_ip, v_ip, **kw)
