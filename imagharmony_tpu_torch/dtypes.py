"""Mixed-precision policy (port of imagharmony_tpu/dtypes.py).

The port keeps weights in the compute dtype: a model built or moved with
``module.to(dtype)`` computes in that dtype, ``COMPUTE_DTYPE`` (bf16) on
the card and fp32 for parity tests on the CPU. Two rules hold whatever the
compute dtype:

* normalization statistics accumulate in fp32 (``NORM_DTYPE``), while the
  centering and scaling run in the input dtype (nn/layers.py);
* attention logits and softmax are fp32 (``SOFTMAX_DTYPE``).
"""

import torch

COMPUTE_DTYPE = torch.bfloat16
NORM_DTYPE = torch.float32
SOFTMAX_DTYPE = torch.float32
