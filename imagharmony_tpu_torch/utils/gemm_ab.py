"""Device times of P1 and K5 at their timed shapes, to compare two
checkouts of the port in turns on one card.

    python imagharmony_tpu_torch/utils/gemm_ab.py                 # this checkout
    python imagharmony_tpu_torch/utils/gemm_ab.py --against DIR   # DIR, this, this, DIR

Alone, it times ``probe_mm`` at the matmul probe's four shapes in both
pairs (bf16, int8) and ``geglu`` (tanh, with the bias) at the six
inference shapes, ``P1_SHAPES`` and ``K5_SHAPES`` (which ``chip_smoke.py``'s
phases 3g and 3h time too), each against its library call
(``torch.matmul``, ``torch._int_mm``, ``F.linear``), from random inputs
of a seed, and prints one JSON line: the device ms of each call,
from the profiler's trace (``utils/profiling.kernel_ms``), with the card's
name and power limit. It runs whichever ``imagharmony_tpu_torch`` comes
first on the path, so with ``--against DIR`` (the root of another
checkout) it runs itself four times in turn, DIR first on PYTHONPATH,
then this checkout, this checkout, DIR, and prints each run's line and
one last line with both runs of each tree side by side. Every checkout
builds its own kernels. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# P1, (M, K, N): the matmul probe's SDXL feed-forward products
P1_SHAPES = [(8192, 640, 5120), (2048, 1280, 10240), (8192, 2560, 640), (2048, 5120, 1280)]
# K5, (M, K, inner): the GEGLU projection of every UNet feed-forward (one
# per transformer block), rows M = B*S: SDXL at 1024² with the CFG pair (10
# at 64², 60 at 32² per UNet call), then SD1.5 at 512² (5, 5, 5 and 1 per
# UNet call)
K5_SHAPES = [(8192, 640, 2560), (2048, 1280, 5120), (8192, 320, 1280), (2048, 640, 2560),
             (512, 1280, 5120), (128, 1280, 5120)]


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def measure(seed=0):
    """{"card", "p1": {"bf16 M K N": {"kernel", "library"}, ...}, "k5": {...}}
    of the package first on the path, device ms per call."""
    import torch

    from imagharmony_tpu_torch.kernels import geglu as kg
    from imagharmony_tpu_torch.kernels import probe_matmul as pm
    from imagharmony_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        raise RuntimeError("gemm_ab needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ms(fn):
        got = profiling.kernel_ms(fn)["total"]
        if got is None:
            raise RuntimeError("the profiler's traces give no kernel time on the card")
        return got

    p1, k5 = {}, {}
    with torch.inference_mode():
        for m, k, n in P1_SHAPES:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            w = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
            xq = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
            wq = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
            p1[f"bf16 {m} {k} {n}"] = {
                "kernel": ms(lambda: pm.probe_mm(x, w, out_dtype=torch.bfloat16)),
                "library": ms(lambda: torch.matmul(x, w))}
            p1[f"int8 {m} {k} {n}"] = {
                "kernel": ms(lambda: pm.probe_mm(xq, wq, out_dtype=torch.int32)),
                "library": ms(lambda: torch._int_mm(xq, wq))}
        for m, k, inner in K5_SHAPES:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            w = (torch.randn((2 * inner, k), generator=gen, device="cuda") * k**-0.5).to(
                torch.bfloat16)
            b = torch.randn((2 * inner,), generator=gen, device="cuda").to(torch.bfloat16)
            k5[f"{m} {k} {inner}"] = {
                "kernel": ms(lambda: kg.geglu(x, w, b, gelu="tanh")),
                "library": ms(lambda: torch.nn.functional.linear(x, w, b))}
    return {"card": _card(), "package": str(Path(kg.__file__).resolve().parents[1]), "p1": p1,
            "k5": k5}


def against(other):
    """Runs this file for ``other``, this checkout, this, ``other``, each
    with its tree first on PYTHONPATH; returns the four results."""
    here = Path(__file__).resolve().parents[2]
    runs = []
    for tree in (Path(other).resolve(), here, here, Path(other).resolve()):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(tree)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve())], env=env,
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError(f"gemm_ab on {tree} failed:\n{proc.stdout}\n{proc.stderr}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": str(tree), **result}), flush=True)
        runs.append(result)
    return runs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="root of another checkout of the port")
    args = parser.parse_args(argv)
    if not args.against:
        print(json.dumps(measure()), flush=True)
        return
    runs = against(args.against)
    table = {kernel: {key: {"other": [runs[i][kernel][key]["kernel"] for i in (0, 3)],
                            "this": [runs[i][kernel][key]["kernel"] for i in (1, 2)],
                            "library": [r[kernel][key]["library"] for r in runs]}
                      for key in runs[0][kernel]}
             for kernel in ("p1", "k5")}
    print(json.dumps({"card": runs[0]["card"], "order": "other, this, this, other", **table}),
          flush=True)


if __name__ == "__main__":
    main()
