"""Shared helpers of the tests/test_torch_*.py files, which hold the PyTorch
port (imagharmony_tpu_torch) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides; JAX
weights come from the JAX package's tiny inits and reach the port through
io/from_jax. Both sides run in fp32 (the JAX conftest sets "highest"
matmul precision).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imagharmony_tpu_torch.io import from_jax

torch.set_num_threads(2)

# per-module parity tolerance, as the repo's reference-oracle tests use
TOL = dict(rtol=2e-5, atol=2e-5)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(x):
    """numpy -> CPU torch tensor."""
    return torch.as_tensor(np.asarray(x))


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def nchw(x):
    return t(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def nhwc(x):
    return np_(x.permute(0, 2, 3, 1))


def load(module, jax_tree, *, skip_prefixes=()):
    """Load a JAX parameter tree into ``module`` through io/from_jax; every
    parameter of the module must be covered."""
    import jax

    sd = {k: v for k, v in from_jax.state_dict(jax.device_get(jax_tree)).items()
          if not k.startswith(tuple(skip_prefixes))}
    module.load_state_dict(sd, strict=True)
    return module.eval().requires_grad_(False)


def close(port, ref, **tol):
    np.testing.assert_allclose(np_(port), np.asarray(ref, np.float32), **(tol or TOL))


@pytest.fixture()
def cuda():
    """The CUDA device, or a skip: K1 has no CPU mode, its own tests run on
    the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")
