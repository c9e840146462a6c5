"""PyTorch/CUDA port of imagharmony_tpu for one NVIDIA H100.

The module layout mirrors the JAX package (``nn/layers.py`` <->
``imagharmony_tpu/nn/layers.py``, ...). The port imports torch and numpy,
never jax; its CUDA kernels build at first use (``kernels/build.py``).
Entry point: ``imagharmony_tpu_torch.pipelines.harmony_edit.HarmonyPipeline``.
"""
