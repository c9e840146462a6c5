"""The lane-group probe on the card: P4 (``nhd_with_g``), the no-max
attention with ``g / 64`` heads a CTA, over g = 128, 256, 640, 1280,
against the port's current self-attention K1 (``flash_attention_nhd``) and
SDPA, at the SDXL self-attention shapes. The port's counterpart of
tools/probe_attn_lanegroup.py (its main(): the same shapes and g values,
maxdiff against g = 128; here also against K1).

    python -m imagharmony_tpu_torch.probes.probe_attn_lanegroup [--device cpu]

On the TPU more heads a grid step cut the per-step overhead of a short
sequence; on the card more heads a CTA cut the number of CTAs (g = 1280 at
(2, 1024, 1280): 16 CTAs for 132 SMs), which the sweep shows.
"""

from __future__ import annotations

import torch

from imagharmony_tpu_torch.kernels import probe_attention as pa
from imagharmony_tpu_torch.probes import _attn, _bench

GS = (128, 256, 640, 1280)


@torch.inference_mode()
def main(argv=None):
    args = _bench.parse(argv, __doc__.splitlines()[0])
    dev = args.device
    _bench.header(dev)
    results = []
    for b, s, hd, label in _attn.LANEGROUP_SHAPES:
        q, k, v = _attn.inputs(b, s, hd, dev)
        base = _attn.current(q, k, v, label, dev)
        first = None
        for g in GS:
            if hd % g:
                continue
            r = _attn.run(f"G={g:5d}", lambda: pa.nhd_with_g(
                q, k, v, _attn.SCALE, _attn.HEAD_DIM, s, g), base, dev, first)
            first = r["out"] if first is None else first
            results.append(r)
    return results


if __name__ == "__main__":
    main()
