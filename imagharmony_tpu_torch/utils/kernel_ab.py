"""Device times of the port's redesigned kernels at their timed shapes, to
compare two checkouts of the port in turns on one card.

    python imagharmony_tpu_torch/utils/kernel_ab.py                 # this checkout
    python imagharmony_tpu_torch/utils/kernel_ab.py --against DIR   # DIR, this, this, DIR
    python imagharmony_tpu_torch/utils/kernel_ab.py --against A B --kernels nomax  # A, B, this, this, B, A

Alone, it times, from random inputs of a seed:

* P1 (``probe_mm``) at the matmul probe's four shapes in both pairs (bf16,
  int8) and K5 (``geglu``, tanh, with the bias) at the six inference
  shapes, ``P1_SHAPES`` and ``K5_SHAPES`` (which ``chip_smoke.py``'s phases
  3g and 3h time too), each against its library call (``torch.matmul``,
  ``torch._int_mm``, ``F.linear``);
* the no-max attention kernel (P2-P6) at SDXL's two self-attention shapes,
  ``NOMAX_SHAPES`` (phases 3i and 3j time them too): P2 at every (bq, kb)
  tile, P3, P4 (g = 128) and each P5-P6 recipe through its entry point, at
  the defaults, beside SDPA on the same inputs;

and prints one JSON line: the device ms of each call, from the profiler's
trace (``utils/profiling.kernel_ms``), with the card's name and power
limit. ``--kernels`` picks some of ``p1``, ``k5`` and ``nomax``. It runs
whichever ``imagharmony_tpu_torch`` comes first on the path, so with
``--against DIR`` (the root of another checkout) it runs itself four times
in turn, DIR first on PYTHONPATH, then this checkout, this checkout, DIR,
and prints each run's line and one last line with both runs of each tree
side by side; with several DIRs, each of them before and after this
checkout's two runs, in mirrored order. Every checkout builds its own
kernels, all of them in parallel before the first run. Needs a CUDA card.
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
# P2-P6, (B, S, H, D): SDXL's two self-attention shapes at 1024², the CFG
# pair on the batch axis
NOMAX_SHAPES = [(2, 4096, 10, 64), (2, 1024, 20, 64)]
KERNELS = ("p1", "k5", "nomax")


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _nomax(gen, ms):
    """{"B S H D": {cell: device ms}} of P2-P6 and SDPA at NOMAX_SHAPES."""
    import torch

    from imagharmony_tpu_torch.kernels import probe_attention as pa
    from imagharmony_tpu_torch.kernels import probe_softmax as ps

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for b, s, h, d in NOMAX_SHAPES:
        q, k, v = torch.randn((b, s, 3 * h * d), generator=gen,
                              device="cuda").to(torch.bfloat16).chunk(3, dim=-1)
        scale = d**-0.5
        cells = {f"P2 bq={bq} kb={kb}": lambda bq=bq, kb=kb: pa.kblock_attn(q, k, v, scale, d,
                                                                             bq, kb)
                 for bq in pa.BQS for kb in pa.kbs(d)}
        cells["P3"] = lambda: pa.batchpack_attn(q, k, v, scale, d)
        cells["P4 g=128"] = lambda: pa.nhd_with_g(q, k, v, scale, d, s, 128)
        for (no_max, mxu_sum), recipe in ps.NOMAX.items():
            cells[f"P5 {recipe}"] = lambda n=no_max, m=mxu_sum: ps.softmax_nomax(
                q, k, v, scale, d, no_max=n, mxu_sum=m)
        for variant, recipe in ps.TRICKS.items():
            if recipe not in ps.NOMAX.values():  # v2 is P5's base recipe
                cells[f"P6 {recipe}"] = lambda n=variant: ps.softmax_tricks(q, k, v, scale, d, n)
        qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v))
        cells["SDPA"] = lambda: sdpa(qh, kh, vh)  # the yardstick; the port never calls it
        out[f"{b} {s} {h} {d}"] = {name: ms(fn) for name, fn in cells.items()}
    return out


def measure(kernels=KERNELS, seed=0):
    """{"card", "package", "p1": {"bf16 M K N": {"kernel", "library"}, ...},
    "k5": {...}, "nomax": {"B S H D": {cell: ms}}} (those of ``kernels``)
    of the package first on the path, device ms per call."""
    import torch

    from imagharmony_tpu_torch.kernels import geglu as kg
    from imagharmony_tpu_torch.kernels import probe_matmul as pm
    from imagharmony_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ms(fn):
        got = profiling.kernel_ms(fn)["total"]
        if got is None:
            raise RuntimeError("the profiler's traces give no kernel time on the card")
        return got

    result = {"card": _card(), "package": str(Path(kg.__file__).resolve().parents[1])}
    with torch.inference_mode():
        if "p1" in kernels:
            p1 = result["p1"] = {}
            for m, k, n in P1_SHAPES:
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                w = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
                xq = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                                   dtype=torch.int8)
                wq = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                                   dtype=torch.int8)
                p1[f"bf16 {m} {k} {n}"] = {
                    "kernel": ms(lambda: pm.probe_mm(x, w, out_dtype=torch.bfloat16)),
                    "library": ms(lambda: torch.matmul(x, w))}
                p1[f"int8 {m} {k} {n}"] = {
                    "kernel": ms(lambda: pm.probe_mm(xq, wq, out_dtype=torch.int32)),
                    "library": ms(lambda: torch._int_mm(xq, wq))}
        if "k5" in kernels:
            k5 = result["k5"] = {}
            for m, k, inner in K5_SHAPES:
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                w = (torch.randn((2 * inner, k), generator=gen, device="cuda") * k**-0.5).to(
                    torch.bfloat16)
                b = torch.randn((2 * inner,), generator=gen, device="cuda").to(torch.bfloat16)
                k5[f"{m} {k} {inner}"] = {
                    "kernel": ms(lambda: kg.geglu(x, w, b, gelu="tanh")),
                    "library": ms(lambda: torch.nn.functional.linear(x, w, b))}
        if "nomax" in kernels:
            result["nomax"] = _nomax(gen, ms)
    return result


# the libraries each kind of cell runs
_LIBRARIES = {"p1": ("probe_matmul",), "k5": ("geglu",), "nomax": ("probe_attention",)}


def _env(tree):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tree)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))


def against(others, kernels):
    """Runs this file for each of ``others``, this checkout twice, then
    ``others`` again in reverse order, each with its tree first on
    PYTHONPATH, after building every tree's kernels in parallel; returns
    [(tree, result)] in run order."""
    here = Path(__file__).resolve().parents[2]
    others = [Path(o).resolve() for o in others]
    modules = sorted({m for k in kernels for m in _LIBRARIES[k]})
    build = "; ".join(f"from imagharmony_tpu_torch.kernels import {m}; {m}._entry()"
                      for m in modules)
    builds = [(tree, subprocess.Popen([sys.executable, "-c", build], env=_env(tree), cwd=tree,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
              for tree in others + [here]]
    for tree, proc in builds:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_ab: building {tree} failed:\n{out}\n{err}")
    runs = []
    for tree in others + [here, here] + others[::-1]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--kernels",
                               ",".join(kernels)], env=_env(tree), capture_output=True, text=True,
                              cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_ab on {tree} failed:\n{proc.stdout}\n{proc.stderr}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": str(tree), **result}), flush=True)
        runs.append((tree, result))
    return runs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", nargs="+", metavar="DIR",
                        help="roots of other checkouts of the port")
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help=f"comma-separated, of {', '.join(KERNELS)} (default: all)")
    args = parser.parse_args(argv)
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        parser.error(f"--kernels takes {', '.join(KERNELS)}, got {args.kernels}")
    if not args.against:
        print(json.dumps(measure(kernels)), flush=True)
        return
    runs = against(args.against, kernels)
    here = Path(__file__).resolve().parents[2]
    # each tree's label: "this", or the other checkout's directory name
    labels = ["this" if tree == here else tree.name for tree, _ in runs]

    def by_tree(value):  # {label: [value of each of its runs]}
        out = {}
        for label, (_, result) in zip(labels, runs):
            out.setdefault(label, []).append(value(result))
        return out

    first = runs[0][1]
    table = {kernel: {key: {**by_tree(lambda r: r[kernel][key]["kernel"]),
                            "library": [r[kernel][key]["library"] for _, r in runs]}
                      for key in first[kernel]}
             for kernel in ("p1", "k5") if kernel in kernels}
    if "nomax" in kernels:
        table["nomax"] = {shape: {cell: by_tree(lambda r: r["nomax"][shape][cell])
                                  for cell in cells}
                          for shape, cells in first["nomax"].items()}
    print(json.dumps({"card": first["card"], "order": labels, **table}), flush=True)


if __name__ == "__main__":
    main()
