"""What the attention and softmax probes share: the shapes, the inputs,
the current kernel's line and one timed line of a probe kernel."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from imagharmony_tpu_torch.kernels import flash_attention as fa
from imagharmony_tpu_torch.kernels import probe_attention as pa
from imagharmony_tpu_torch.probes import _bench

HEAD_DIM = 64
SCALE = HEAD_DIM ** -0.5
# (B, S, H*D, label): SDXL's self-attentions at 1024², the CFG pair on the batch
KBLOCK_SHAPES = [(2, 4096, 640, "64sq dim640 h10"), (2, 1024, 1280, "32sq dim1280 h20")]
LANEGROUP_SHAPES = KBLOCK_SHAPES[::-1]  # the JAX lane-group probe's order
# (bq, kb): every tile the no-max kernel is built for at head dim 64
TILES = [(bq, kb) for bq in pa.BQS for kb in pa.kbs(HEAD_DIM)]


def inputs(b, s, hd, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    return [torch.randn((b, s, hd), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(3)]


def _flops(q):
    b, s, hd = q.shape
    return 4 * b * s * s * hd


def _sdpa(q, k, v):
    b, s, hd = q.shape
    split = [x.view(b, -1, hd // HEAD_DIM, HEAD_DIM).transpose(1, 2) for x in (q, k, v)]
    return F.scaled_dot_product_attention(*split, scale=SCALE)


def current(q, k, v, label, dev):
    """Prints the current kernel's (K1's) and SDPA's line; returns K1's
    output."""
    ops = _flops(q)
    out = fa.flash_attention_nhd(q, k, v, scale=SCALE, head_dim=HEAD_DIM)
    t_k1 = _bench.timed(lambda: fa.flash_attention_nhd(q, k, v, scale=SCALE, head_dim=HEAD_DIM),
                        dev)
    t_sdpa = _bench.timed(lambda: _sdpa(q, k, v), dev)
    print(f"\n{label} {tuple(q.shape)}: current (K1) {_bench.fmt(t_k1, ops, 'FLOP')} | SDPA "
          f"{_bench.fmt(t_sdpa, ops, 'FLOP')}", flush=True)
    return out


def run(tag, fn, base, dev, first=None, diff_name="maxdiff"):
    """Runs ``fn`` once, then times it; prints its line with the largest
    difference from ``base`` (K1's output, or what the probe names
    ``diff_name``) and, given, from ``first``."""
    out = fn()
    diff = float((out.float() - base.float()).abs().max())
    extra = "" if first is None else \
        f" maxdiff vs first={float((out.float() - first.float()).abs().max()):.1e}"
    t = _bench.timed(fn, dev)
    print(f"  {tag}: {_bench.fmt(t, _flops(base), 'FLOP')} {diff_name}={diff:.2e}{extra}",
          flush=True)
    return {"tag": tag, "shape": tuple(base.shape), "time": t, "maxdiff": diff, "out": out}
