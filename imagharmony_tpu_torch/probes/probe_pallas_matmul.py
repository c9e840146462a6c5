"""The matmul probe on the card: P1, the hand-written matrix product, in
bf16 and in int8 against the library's product of the same pair, and K5,
the fused GEGLU projection, against the unfused chain, at the SDXL
feed-forward shapes. The port's counterpart of tools/probe_pallas_matmul.py
(its main(): the same shapes and pairs).

    python -m imagharmony_tpu_torch.probes.probe_pallas_matmul [--device cpu]

Each line: P1's device time from the profiler's trace beside its
CUDA-event median and its rate (TFLOP/s for bf16, TOP/s for int8), the
same for ``torch.matmul`` (bf16) and ``torch._int_mm`` (int8), and how far
P1 lies from them (bf16: max abs difference; int8: whether every element
is equal). The GEGLU lines time K5 (erf gelu, the probe's), the plain
chain and ``F.linear`` alone (the GEMM K5 replaces).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from imagharmony_tpu_torch.kernels import geglu as kg
from imagharmony_tpu_torch.kernels import probe_matmul as pm
from imagharmony_tpu_torch.probes import _bench

# (M, K, N, label): the SDXL feed-forward's products, as the JAX probe's
SHAPES = [(8192, 640, 5120, "ffn-in dim640"), (2048, 1280, 10240, "ffn-in dim1280"),
          (8192, 2560, 640, "ffn-out dim640"), (2048, 5120, 1280, "ffn-out dim1280")]
# (M, K, inner, label): the fused GEGLU projection
GEGLU_SHAPES = [(8192, 640, 2560, "geglu dim640"), (2048, 1280, 5120, "geglu dim1280")]


def _int_mm(xq, wq):
    """The library's int8 product (cuBLASLt on a card); on the CPU the
    float64 product, exact here."""
    if xq.is_cuda:
        return torch._int_mm(xq, wq)
    return pm.probe_mm_plain(xq, wq, out_dtype=torch.int32)


@torch.inference_mode()
def main(argv=None):
    args = _bench.parse(argv, __doc__.splitlines()[0])
    dev = args.device
    _bench.header(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for m, k, n, tag in SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        ops = 2 * m * k * n
        y = pm.probe_mm(x, w, out_dtype=torch.bfloat16)
        yq = pm.probe_mm(xq, wq, out_dtype=torch.int32)
        lib = torch.matmul(x, w)
        libq = _int_mm(xq, wq)
        diff = float((y.float() - lib.float()).abs().max())
        exact = bool(torch.equal(yq, libq))
        t = {name: _bench.timed(fn, dev) for name, fn in (
            ("bf16", lambda: pm.probe_mm(x, w, out_dtype=torch.bfloat16)),
            ("matmul", lambda: torch.matmul(x, w)),
            ("int8", lambda: pm.probe_mm(xq, wq, out_dtype=torch.int32)),
            ("int_mm", lambda: _int_mm(xq, wq)))}
        print(f"{tag:18s} M{m} K{k} N{n}: P1 bf16 {_bench.fmt(t['bf16'], ops, 'FLOP')} | "
              f"torch.matmul {_bench.fmt(t['matmul'], ops, 'FLOP')} | maxdiff {diff:.1e}",
              flush=True)
        print(f"{'':18s} P1 int8 {_bench.fmt(t['int8'], ops, 'OP')} | torch._int_mm "
              f"{_bench.fmt(t['int_mm'], ops, 'OP')} | equal {exact}", flush=True)
        results.append({"shape": (m, k, n), "bf16_maxdiff": diff, "int8_equal": exact, **t})

    for m, k, inner, tag in GEGLU_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((2 * inner, k), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        ops = 2 * m * k * 2 * inner
        diff = float((kg.geglu(x, w, gelu="erf").float()
                      - kg.geglu_plain(x, w, gelu="erf").float()).abs().max())
        t = {name: _bench.timed(fn, dev) for name, fn in (
            ("k5", lambda: kg.geglu(x, w, gelu="erf")),
            ("plain", lambda: kg.geglu_plain(x, w, gelu="erf")),
            ("linear", lambda: F.linear(x, w)))}
        print(f"{tag:18s} M{m} K{k} ffi{inner}: K5 fused {_bench.fmt(t['k5'], ops, 'FLOP')} | "
              f"plain chain {_bench.fmt(t['plain'], ops, 'FLOP')} | F.linear alone "
              f"{_bench.fmt(t['linear'], ops, 'FLOP')} | maxdiff {diff:.1e}", flush=True)
        results.append({"shape": (m, k, inner), "geglu_maxdiff": diff, **t})
    return results


if __name__ == "__main__":
    main()
