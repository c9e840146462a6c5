"""P1: the plain matrix product of the matmul probe, out = x W, in the two
type pairs the probe runs: bf16 -> bf16 with fp32 accumulation, and int8
-> int32 with int32 accumulation.

``probe_mm`` replaces the TPU kernel ``_mm_kernel``
(tools/probe_pallas_matmul.py:34, entry ``pallas_mm`` :42). On CUDA tensors
it launches the hand-written sm_90a kernel ``mm_wgmma_kernel`` in
``csrc/probe_mm.cu``; on CPU tensors it runs ``probe_mm_plain``. There is
no fallback between the two: a CUDA tensor the kernel does not take
raises. x is (M, K) and W (K, N), both row-major, as the probe takes them.

No entry point of the port's pipelines calls it: its path is the port's
matmul probe, ``imagharmony_tpu_torch/probes/probe_pallas_matmul.py``.

What bounds it on an H100: bf16 at (8192, 640, 5120), the operations (53.7
GFLOP, 0.0543 ms at 989 TFLOP/s, against 101 MB, 0.030 ms at 3.35 TB/s);
int8 at the same shape, the bytes (the int32 output alone is 168 MB, 0.050
ms, against 0.0271 ms of operations at 1979 TOP/s). The kernel is K5's
GEMM mainloop (``csrc/sm90_gemm.cuh``): persistent CTAs with a producer
warp, and the K loop split across CTAs where whole tiles would leave the
card's last wave part empty and K is long enough to pay for it: of the
probe's four shapes only (2048, 5120, 1280), whose 160 tiles of 128 x 128
would run 1.2 waves on 132 SMs. A split launch takes its fp32 or int32 partials'
workspace from torch's allocator here and the tile counters of
``kernels/gemm.py``; ``plan`` says how a shape is cut. The int8 ``wgmma``
reads W only K-major, so the kernel transposes each W tile in shared
memory (see the source); the wrapper makes no copy of W.
"""

from __future__ import annotations

import functools

import torch

from imagharmony_tpu_torch.kernels import build
from imagharmony_tpu_torch.kernels import flash_attention as fa
from imagharmony_tpu_torch.kernels import gemm

# P1 launches since the last reset; only the CUDA launches add to it.
launches = 0

# input dtype -> (the output dtype, the kernel's kind argument, elements in 16 bytes)
PAIRS = {torch.bfloat16: (torch.bfloat16, 0, 8), torch.int8: (torch.int32, 1, 16)}


def probe_mm_plain(x, w, *, out_dtype):
    """P1's reference. Floating inputs: ``torch.matmul`` in fp32, cast to
    ``out_dtype``. Integer inputs: the product in float64, exact while
    |sum| < 2^53 (int8: 128^2 K, any K below 2^39), cast to ``out_dtype``
    (int32). On either device."""
    if x.dtype.is_floating_point:
        return torch.matmul(x.float(), w.float()).to(out_dtype)
    return torch.matmul(x.double(), w.double()).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    import ctypes

    fn = build.load("probe_mm").probe_mm
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # without argtypes ctypes passes Python ints as 32-bit C ints and cuts
    # the pointers
    fn.argtypes = [ptr] * 3 + [i32] * 4 + [i64] * 2 + [ptr] * 3
    fn.restype = i32
    return fn


@functools.lru_cache(maxsize=None)
def _plan(device_index, kind, m, k, n):
    """(workspace bytes, the schedule's fields) of P1 at this shape on
    that device (its SM count sets the grid)."""
    import ctypes

    fn = build.load("probe_mm").probe_mm_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_longlong
    info = (ctypes.c_longlong * len(gemm.FIELDS))()
    with torch.cuda.device(device_index):
        nbytes = fn(kind, m, k, n, info)
    if nbytes < 0:
        raise ValueError(f"probe_mm: no schedule for kind {kind} at ({m}, {k}, {n})")
    return nbytes, tuple(info)


def plan(x, w, *, out_dtype):
    """How P1 cuts the product of these CUDA tensors: ``gemm.describe``'s
    dict (tile columns, tiles, K panels, CTAs, whole and split tiles, chunks
    a split tile, work units, the split's workspace)."""
    _check_layout(x, w, out_dtype)
    (m, k), n = x.shape, w.shape[1]
    return gemm.describe(*_plan(x.device.index, PAIRS[x.dtype][1], m, k, n))


def _check_layout(x, w, out_dtype):
    """What P1 takes, whatever the device: x (M, K) and w (K, N) of one of
    the two input dtypes with ``out_dtype`` its pair's output; unit stride
    along the rows; addresses and row strides multiples of 16 bytes (K and
    N multiples of 8 for bf16, of 16 for int8)."""
    if x.dtype not in PAIRS or w.dtype != x.dtype or PAIRS[x.dtype][0] != out_dtype:
        raise TypeError(f"probe_mm: takes bf16 x bf16 -> bf16 or int8 x int8 -> int32, got "
                        f"{x.dtype} x {w.dtype} -> {out_dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"probe_mm: x must be (M, K) and w (K, N), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    per16 = PAIRS[x.dtype][2]
    for name, a in (("x", x), ("w", w)):
        if a.shape[1] % per16:
            raise ValueError(f"probe_mm: {name}'s rows must be whole 16-byte units "
                             f"({per16} elements), got width {a.shape[1]}")
        if a.stride(1) != 1 or a.stride(0) % per16 or a.data_ptr() % 16:
            raise ValueError(f"probe_mm: {name} rows must be 16-byte aligned with unit stride "
                             f"(strides {a.stride()}, address {a.data_ptr():#x})")


def _launch(x, w, out_dtype):
    global launches
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"probe_mm: x and w must be on one CUDA device or both on the CPU, "
                         f"got {x.device}, {w.device}")
    _check_layout(x, w, out_dtype)
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    kind = PAIRS[x.dtype][1]
    nbytes, _ = _plan(x.device.index, kind, m, k, n)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
        rc = _entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(), kind, m, k, n, x.stride(0),
                      w.stride(0), workspace.data_ptr() if nbytes else None,
                      gemm.counters(x.device, stream).data_ptr(), stream)
    fa._check_rc("probe_mm", rc)
    launches += 1
    return out


def probe_mm(x, w, *, out_dtype):
    """x (M, K) @ w (K, N) -> (M, N) of ``out_dtype``: bf16 x bf16 -> bf16
    (fp32 accumulation) or int8 x int8 -> int32. Any other pair raises, on
    either device. CPU tensors go to ``probe_mm_plain``; CUDA tensors launch
    P1 and must also meet the TMA's 16-byte rule (``_check_layout``)."""
    if fa._on_cpu(x, w):
        _check_layout(x, w, out_dtype)
        return probe_mm_plain(x, w, out_dtype=out_dtype)
    return _launch(x, w, out_dtype)
