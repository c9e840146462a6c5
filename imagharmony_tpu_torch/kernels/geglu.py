"""K5: the fused GEGLU projection of the UNet's feed-forward:

    out = (x Wh^T + bh) * gelu(x Wg^T + bg),   [Wh; Wg] = weight, [bh; bg] = bias

``geglu`` replaces the TPU kernels of the GEGLU probes, which compute this
function with the product in VMEM: ``_packed_kernel``
(tools/probe_geglu_v2.py:36, entry ``geglu_packed`` :43), ``make_kernel``
(tools/probe_geglu_epilogue.py:64, entry ``geglu`` :75), ``_geglu_kernel``
(tools/probe_geglu_tune.py:37, entry ``pallas_geglu`` :46) and
``_geglu_kernel`` (tools/probe_pallas_matmul.py:60, entry ``pallas_geglu``
:82). On a CUDA tensor it launches the hand-written sm_90a kernel
``geglu_wgmma_kernel`` in ``csrc/geglu.cu``; on a CPU tensor it runs
``geglu_plain``. There is no fallback between the two: a CUDA tensor the
kernel does not take raises.

The JAX model computes GEGLU as two XLA dots and an elementwise epilogue
(imagharmony_tpu/nn/layers.py:290); the port's plain version is one GEMM
to (rows, 2*inner), ``chunk``, gelu and a multiply, whose product goes to
device memory and is read back twice. K5 keeps the product in registers
and writes only the output. ``gelu`` is "tanh" (the tanh approximation,
the bf16 path's rule), "erf" (exact) or "none" (h * g, the epilogue
probe's floor).

When a gradient is needed the call goes through ``GEGLUFn``, whose
backward is plain on either device: the counterpart of JAX's autodiff of
``geglu``, which is XLA, not Pallas.

What bounds K5 on an H100: operations (at SDXL's (8192, 640, 2560) 53.7
GFLOP, 0.054 ms at 989 TFLOP/s, against 59 MB of x, W and the output,
0.018 ms at 3.35 TB/s). The kernel runs the GEMM mainloop it shares with
P1 (``csrc/sm90_gemm.cuh``): persistent CTAs with a producer warp, and the
K loop split across CTAs where whole tiles would leave the card's last
wave part empty and K is long enough to pay for the split; a split tile's
[h | g] partials are summed in fp32 before the epilogue. No shape of the
pipelines is cut so: their K is 320-1280 (5-20 panels), too short to pay
for a split's partial stores and sum, and the small-M shapes (SD1.5's
(512, 1280, 5120), the mid block's (128, 1280, 5120)) take 64-column
whole tiles instead. The split runs where K is long, as at (2048, 5120,
1280) with the tanh or no gelu. A split launch takes its partials' workspace from torch's
allocator here and the tile counters of ``kernels/gemm.py``; ``plan`` says
how a shape is cut. Like the attention kernels it reads its operands with
TMA, which takes base addresses and row strides that are multiples of 16
bytes: checked here before any launch.

Each launch declares its cost to ``kernels/cost.py`` with the formula of
the JAX probe's ``pl.CostEstimate`` (tools/probe_geglu_v2.py:57:
2·m·k·2·inner flops); a CPU call declares nothing.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from imagharmony_tpu_torch.kernels import build, cost
from imagharmony_tpu_torch.kernels import flash_attention as fa
from imagharmony_tpu_torch.kernels import gemm

# K5 launches since the last reset; only the CUDA launches add to it.
geglu_launches = 0

GELUS = {"none": 0, "tanh": 1, "erf": 2}  # the kernel's gelu argument
_APPROXIMATE = {"tanh": "tanh", "erf": "none"}  # F.gelu's


def geglu_plain(x, weight, bias=None, *, gelu):
    """K5's reference: ``F.linear`` to (..., 2*inner), ``chunk``, gelu and a
    multiply, in x's dtype (x, weight and bias of one dtype)."""
    h, g = F.linear(x, weight, bias).chunk(2, dim=-1)
    return h * (g if gelu == "none" else F.gelu(g, approximate=_APPROXIMATE[gelu]))


def geglu_bwd_plain(x, weight, bias, dout, *, gelu, need=(True, True, True)):
    """The gradients of (x, weight, bias) in explicit formulas: h and g
    recomputed with ``F.linear``, dh = dout gelu(g), dg = dout h gelu'(g)
    (``aten.gelu_backward``), then dx = [dh | dg] W, dW = [dh | dg]^T x and
    db the column sums, all in x's dtype; None for a bias that is None and
    for what ``need`` (per input) leaves out."""
    h, g = F.linear(x, weight, bias).chunk(2, dim=-1)
    if gelu == "none":
        dh, dg = dout * g, dout * h
    else:
        dh = dout * F.gelu(g, approximate=_APPROXIMATE[gelu])
        dg = torch.ops.aten.gelu_backward(dout * h, g, approximate=_APPROXIMATE[gelu])
    dhg = torch.cat([dh, dg], dim=-1)
    rows = dhg.reshape(-1, dhg.shape[-1])
    dx = dhg @ weight if need[0] else None
    dw = rows.t() @ x.reshape(-1, x.shape[-1]) if need[1] else None
    db = rows.sum(dim=0) if bias is not None and need[2] else None
    return dx, dw, db


@functools.lru_cache(maxsize=None)
def _entry():
    import ctypes

    fn = build.load("geglu").geglu_bf16
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # without argtypes ctypes passes Python ints as 32-bit C ints and cuts
    # the pointers
    fn.argtypes = [ptr] * 4 + [i32] * 3 + [i64] * 2 + [i32] + [ptr] * 3
    fn.restype = i32
    return fn


@functools.lru_cache(maxsize=None)
def _plan(device_index, m, k, inner, gelu):
    """(workspace bytes, the schedule's fields) of K5 at this shape and
    gelu on that device (its SM count sets the grid)."""
    import ctypes

    fn = build.load("geglu").geglu_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_longlong
    info = (ctypes.c_longlong * len(gemm.FIELDS))()
    with torch.cuda.device(device_index):
        nbytes = fn(m, k, inner, GELUS[gelu], info)
    if nbytes < 0:
        raise ValueError(f"geglu: no schedule at ({m}, {k}, {inner}) with gelu {gelu!r}")
    return nbytes, tuple(info)


def plan(x, weight, *, gelu):
    """How K5 cuts the projection of these CUDA tensors with this gelu:
    ``gemm.describe``'s dict (tile columns, tiles, K panels, CTAs, whole and
    split tiles, chunks a split tile, work units, the split's workspace)."""
    k, inner = weight.shape[1], weight.shape[0] // 2
    return gemm.describe(*_plan(x.device.index, x.numel() // k, k, inner, gelu))


def _check_cuda(x, weight, bias, gelu):
    """What K5 takes: one CUDA device and operands ``_check_layout``
    accepts."""
    ops = [("x", x), ("weight", weight)] + ([("bias", bias)] if bias is not None else [])
    if not (x.is_cuda and all(t.device == x.device for _, t in ops)):
        raise ValueError(f"geglu: {', '.join(n for n, _ in ops)} must all be on one CUDA "
                         f"device or all on the CPU, got "
                         f"{', '.join(str(t.device) for _, t in ops)}")
    _check_layout(x, weight, bias, gelu)


def _check_layout(x, weight, bias, gelu):
    """K5's operands whatever their device: bf16; a (2*inner, K) weight with
    unit stride along K, its address and row stride multiples of 16 bytes; a
    contiguous (2*inner,) bias or None; x of width K; a known gelu."""
    if gelu not in GELUS:
        raise ValueError(f"geglu: gelu must be one of {tuple(GELUS)}, got {gelu!r}")
    ops = [x, weight] + ([bias] if bias is not None else [])
    if any(t.dtype != torch.bfloat16 for t in ops):
        raise TypeError(f"geglu: the CUDA kernel takes bf16, got "
                        f"{', '.join(str(t.dtype) for t in ops)}")
    if weight.dim() != 2 or weight.shape[0] % 2 or weight.shape[0] == 0:
        raise ValueError(f"geglu: weight must be (2*inner, K), got {tuple(weight.shape)}")
    k = weight.shape[1]
    if weight.stride(1) != 1 or weight.stride(0) % 8 or weight.data_ptr() % 16:
        raise ValueError(f"geglu: weight rows must be 16-byte aligned with unit stride "
                         f"(strides {weight.stride()}, address {weight.data_ptr():#x})")
    if k % 8:
        raise ValueError(f"geglu: K must be a multiple of 8 (16-byte rows), got {k}")
    if bias is not None and (bias.shape != (weight.shape[0],) or not bias.is_contiguous()):
        raise ValueError(f"geglu: bias must be contiguous ({weight.shape[0]},), got "
                         f"{tuple(bias.shape)}")
    if x.dim() < 1 or x.shape[-1] != k:
        raise ValueError(f"geglu: x must be (..., {k}), got {tuple(x.shape)}")
    if (weight.shape[0] // 2) % 8:
        raise ValueError(f"geglu: inner must be a multiple of 8 (16-byte output rows), got "
                         f"{weight.shape[0] // 2}")


def _launch(x, weight, bias, *, gelu):
    """K5 on CUDA tensors -> a contiguous bf16 (..., inner) tensor."""
    global geglu_launches
    _check_cuda(x, weight, bias, gelu)
    k, inner = weight.shape[1], weight.shape[0] // 2
    rows = x.reshape(-1, k)
    if rows.stride(1) != 1 or rows.stride(0) % 8 or rows.data_ptr() % 16:
        rows = rows.contiguous()
    m = rows.shape[0]
    out = torch.empty((m, inner), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out.reshape(*x.shape[:-1], inner)
    nbytes, _ = _plan(x.device.index, m, k, inner, gelu)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
        rc = _entry()(
            rows.data_ptr(), weight.data_ptr(), bias.data_ptr() if bias is not None else None,
            out.data_ptr(), m, k, inner, rows.stride(0), weight.stride(0), GELUS[gelu],
            workspace.data_ptr() if nbytes else None, gemm.counters(x.device, stream).data_ptr(),
            stream,
        )
    fa._check_rc("geglu", rc)
    geglu_launches += 1
    if cost.active():
        cost.declare("K5", *cost.geglu(m, k, inner))
    return out.reshape(*x.shape[:-1], inner)


def _forward(x, weight, bias, *, gelu):
    if fa._on_cpu(*(t for t in (x, weight, bias) if t is not None)):
        return geglu_plain(x, weight, bias, gelu=gelu)
    return _launch(x, weight, bias, gelu=gelu)


class GEGLUFn(torch.autograd.Function):
    """K5 with a gradient. Forward saves its inputs, not the product;
    backward is ``geglu_bwd_plain`` on either device, and returns the
    gradients of the inputs that need them."""

    @staticmethod
    def forward(ctx, x, weight, bias, gelu):
        ctx.save_for_backward(x, weight, bias)
        ctx.gelu = gelu
        return _forward(x, weight, bias, gelu=gelu)

    @staticmethod
    def backward(ctx, dout):
        x, weight, bias = ctx.saved_tensors
        grads = geglu_bwd_plain(x, weight, bias, dout, gelu=ctx.gelu,
                                need=ctx.needs_input_grad[:3])
        return (*grads, None)


def geglu(x, weight, bias=None, *, gelu):
    """h * gelu(g) with [h | g] = x W^T + b: x (..., K), weight (2*inner, K)
    (Wh its first inner rows), bias (2*inner,) or None -> (..., inner).

    CPU tensors go to ``geglu_plain``. CUDA tensors must be bf16 with K and
    inner multiples of 8 and a 16-byte aligned weight; anything else raises.
    With grad mode on and an input that requires grad, the call goes through
    ``GEGLUFn`` so the result has a ``grad_fn``; on CUDA tensors its operands
    are checked before.
    """
    ops = [t for t in (x, weight, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        if not fa._on_cpu(*ops):
            _check_cuda(x, weight, bias, gelu)
        return GEGLUFn.apply(x, weight, bias, gelu)
    return _forward(x, weight, bias, gelu=gelu)
