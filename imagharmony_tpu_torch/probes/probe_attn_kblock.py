"""The k-blocked no-max attention probe on the card: P2 (``kblock_attn``)
over the card's (bq, kb) tiles and P3 (``batchpack_attn``), against the
port's current self-attention K1 (``flash_attention_nhd``, exact online
softmax) and against SDPA, at the SDXL self-attention shapes. The port's
counterpart of tools/probe_attn_kblock.py (its main(): the same shapes,
maxdiff against the current kernel; its TPU blocks of 512-4096 rows become
the card's 64 or 128 query rows and 64 or 128 keys a tile, and P3, which
the JAX probe runs at S <= 1024 only, where its whole batch fits one grid
step's VMEM, runs at both shapes).

    python -m imagharmony_tpu_torch.probes.probe_attn_kblock [--device cpu]

The question it answers: does the rescale-free no-max softmax beat K1's
online softmax on Hopper? P2 and K1 share their producer warp, ring and
wgmma products; the no-max one drops the running max, its shuffles and the
rescale of O.
"""

from __future__ import annotations

import torch

from imagharmony_tpu_torch.kernels import probe_attention as pa
from imagharmony_tpu_torch.probes import _attn, _bench


@torch.inference_mode()
def main(argv=None):
    args = _bench.parse(argv, __doc__.splitlines()[0])
    dev = args.device
    _bench.header(dev)
    results = []
    for b, s, hd, label in _attn.KBLOCK_SHAPES:
        q, k, v = _attn.inputs(b, s, hd, dev)
        base = _attn.current(q, k, v, label, dev)
        for bq, kb in _attn.TILES:
            results.append(_attn.run(
                f"bq={bq:3d} kb={kb:3d}", lambda: pa.kblock_attn(
                    q, k, v, _attn.SCALE, _attn.HEAD_DIM, bq, kb), base, dev))
        results.append(_attn.run("batch-packed", lambda: pa.batchpack_attn(
            q, k, v, _attn.SCALE, _attn.HEAD_DIM), base, dev))
    return results


if __name__ == "__main__":
    main()
