"""K1: fused self-attention on the packed (B, S, H*D) layout.

``flash_attention_nhd`` replaces the TPU kernel ``_attn_nhd_kernel``
(imagharmony_tpu/kernels/flash_attention.py:415, entry
``flash_attention_nhd`` :576). On a CUDA tensor it launches the hand-written
sm_90a kernel in ``csrc/flash_attn_nhd.cu``; on a CPU tensor it runs
``flash_attention_nhd_plain``. There is no fallback between the two: a CUDA
tensor the kernel does not take raises.

What bounds K1 on an H100: at head_dim 64 it is compute-bound. S=4096 with
10 heads and B=2 is 4*B*H*S*S*D = 86 GFLOP per call against ~42 MB of q, k,
v and output, about 2000 flop/byte, far above the ~295 flop/byte at which
the tensor cores become the limit. The kernel therefore keeps the (Sq, Sk)
logits in registers (online softmax over 64-key tiles) and never writes
them to device memory, which the plain version does in fp32.

The TPU kernel's dispatch rules (Sk >= 512, heads packed into 128 lanes, the
no-max clamped exp2, sequences padded to 256) are TPU rules and are not
carried over: every self-attention of the UNet goes through K1, and K1
computes the exact softmax with the ragged edges masked in the kernel.
"""

from __future__ import annotations

import functools

import torch

from imagharmony_tpu_torch.kernels import build

# Kernel launches since the last reset; only the CUDA launch adds to it.
launches = 0

HEAD_DIMS = (32, 64, 128)
_LOG2E = 1.4426950408889634


def flash_attention_nhd_plain(q, k, v, *, scale, head_dim):
    """Reference: fp32 logits, fp32 softmax, fp32 PV, cast back to q's dtype.

    q: (B, Sq, H*D); k, v: (B, Sk, H*D) -> (B, Sq, H*D)."""
    b, sq, hd = q.shape
    heads = hd // head_dim

    def split(x):
        return x.reshape(b, x.shape[1], heads, head_dim).transpose(1, 2).float()

    logits = torch.matmul(split(q), split(k).transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs, split(v))
    return out.transpose(1, 2).reshape(b, sq, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    import ctypes

    fn = build.load("flash_attn_nhd").flash_attn_nhd_bf16
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # without argtypes ctypes passes Python ints as 32-bit C ints and cuts
    # the pointers
    fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                   i64, i64, i64, i64, i64, i64, ctypes.c_float, ptr]
    fn.restype = i32
    return fn


def _check_operand(name, x, batch, hd):
    if x.dim() != 3 or x.shape[0] != batch or x.shape[2] != hd:
        raise ValueError(f"{name} must be ({batch}, S, {hd}), got {tuple(x.shape)}")
    if x.stride(2) != 1:
        raise ValueError(f"{name} must have unit stride on its last axis, got {x.stride()}")
    if x.stride(1) % 8 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(
            f"{name} rows must be 16-byte aligned (strides {x.stride()}, "
            f"address {x.data_ptr():#x})"
        )


def flash_attention_nhd(q, k, v, *, scale, head_dim):
    """softmax(q k^T * scale) v per head on packed (B, S, H*D) tensors.

    q: (B, Sq, H*D); k, v: (B, Sk, H*D), each with unit stride on the last
    axis and any row stride (column slices of one packed to_qkv output are
    taken as they are). Returns a contiguous (B, Sq, H*D) tensor.

    CPU tensors go to ``flash_attention_nhd_plain``. CUDA tensors must be
    bf16 with head_dim in HEAD_DIMS; anything else raises.
    """
    global launches
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_nhd_plain(q, k, v, scale=scale, head_dim=head_dim)
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention_nhd: q, k, v must all be on one CUDA device or all "
            f"on the CPU, got {q.device}, {k.device}, {v.device}"
        )
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(
            f"flash_attention_nhd: the CUDA kernel takes bf16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention_nhd: head_dim {head_dim} not in {HEAD_DIMS}")
    b, sq, hd = q.shape
    if hd % head_dim:
        raise ValueError(f"flash_attention_nhd: width {hd} is not a multiple of {head_dim}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, b, hd)
    sk = k.shape[1]
    if v.shape[1] != sk:
        raise ValueError(f"k and v lengths differ: {sk} vs {v.shape[1]}")
    out = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q.device)
    if b == 0 or sq == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention_nhd: k is empty")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, hd // head_dim, head_dim,
            q.stride(1), k.stride(1), v.stride(1),
            q.stride(0), k.stride(0), v.stride(0),
            float(scale) * _LOG2E, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_nhd: kernel launch failed with CUDA error {rc}")
    launches += 1
    return out
