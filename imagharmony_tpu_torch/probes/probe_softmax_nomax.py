"""The no-max softmax probe on the card: P5 (``softmax_nomax``) under each
(no_max, mxu_sum), its largest difference from the base recipe (no_max
False, mxu_sum False: the row max subtracted, the register sum), against
the port's current self-attention K1 (``flash_attention_nhd``, exact online
softmax) and against SDPA, at the SDXL self-attention shapes. The port's
counterpart of tools/probe_softmax_nomax.py (its main(): the same shapes and
settings, ``maxerr_vs_base``; its whole-row TPU blocks become the card's
128 query rows and 128 keys a tile, the keys streamed).

    python -m imagharmony_tpu_torch.probes.probe_softmax_nomax [--device cpu]

The question it answers: on Hopper, is the max pass (no_max True or
"fp32", with P5's clamp at 80·log2(e)) or the sum pass (mxu_sum: the row
sum from a ones column on the tensor core) worth removing, and what does
rounding the exp2 argument to bf16 cost?
"""

from __future__ import annotations

import torch

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
        base = ps.softmax_nomax(q, k, v, _attn.SCALE, _attn.HEAD_DIM, no_max=False, mxu_sum=False)
        for no_max in (False, True, "fp32"):
            for mxu_sum in (False, True):
                results.append(_attn.run(
                    f"no_max={no_max} mxu_sum={int(mxu_sum)}", lambda: ps.softmax_nomax(
                        q, k, v, _attn.SCALE, _attn.HEAD_DIM, no_max=no_max, mxu_sum=mxu_sum),
                    base, dev, diff_name="maxerr_vs_base"))
    return results


if __name__ == "__main__":
    main()
