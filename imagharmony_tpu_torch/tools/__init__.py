"""The port's evaluation tools (port of the JAX package's ``tools/``
eval_benchmark.py and validate_presets.py): the HarmonyBench-style CLIP-T /
CLIP-I evaluation over a manifest, and the quality check of the ``--fast``
/ ``--turbo`` latency presets against the exact edit. Run one as

    python -m imagharmony_tpu_torch.tools.<name> --random tiny --device cpu ...
"""
