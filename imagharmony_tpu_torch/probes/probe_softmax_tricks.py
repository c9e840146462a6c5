"""The softmax placement probe on the card: P6 (``softmax_tricks``) in its
three variants, each with its largest difference from the exact attention
in fp32 (``flash_attention_nhd_plain`` on the same inputs), against the
port's current self-attention K1 (``flash_attention_nhd``) and against
SDPA, at the SDXL self-attention shapes. The port's counterpart of
tools/probe_softmax_tricks.py (its main(): the same shapes and variants,
the error against the fp32 XLA attention; its whole-row TPU blocks become
the card's 128 query rows and 128 keys a tile, the keys streamed).

    python -m imagharmony_tpu_torch.probes.probe_softmax_tricks [--device cpu]

The variants: v0 scales the fp32 logits and normalises the probabilities
before PV (on the card a statistics pass over K first, then the PV pass);
v1 folds the scale into q and normalises after PV; v2 is v1 with exp2 and
log2(e) folded into q (a bare exp2, no multiply before it). The question:
what each placement costs on Hopper.
"""

from __future__ import annotations

import torch

from imagharmony_tpu_torch.kernels import flash_attention as fa
from imagharmony_tpu_torch.kernels import probe_softmax as ps
from imagharmony_tpu_torch.probes import _attn, _bench


@torch.inference_mode()
def main(argv=None):
    args = _bench.parse(argv, __doc__.splitlines()[0])
    dev = args.device
    _bench.header(dev)
    results = []
    for b, s, hd, label in _attn.KBLOCK_SHAPES:
        q, k, v = _attn.inputs(b, s, hd, dev)
        _attn.current(q, k, v, label, dev)
        exact = fa.flash_attention_nhd_plain(q.float(), k.float(), v.float(), scale=_attn.SCALE,
                                             head_dim=_attn.HEAD_DIM)
        for variant in (0, 1, 2):
            results.append(_attn.run(f"v{variant}", lambda: ps.softmax_tricks(
                q, k, v, _attn.SCALE, _attn.HEAD_DIM, variant), exact, dev,
                diff_name="maxerr vs fp32 exact"))
    return results


if __name__ == "__main__":
    main()
