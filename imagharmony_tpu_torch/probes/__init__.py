"""The port's probe tools: hand-run sweeps of the probe kernels (P1-P4, and
K5 beside P1) at the SDXL shapes, each timed against the kernel the port
runs today and the library call, as the JAX package's ``tools/probe_*.py``
sweep the Pallas kernels. Run one as

    python -m imagharmony_tpu_torch.probes.<name> [--device cpu]
"""
