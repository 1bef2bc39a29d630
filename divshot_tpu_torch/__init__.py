"""divshot_tpu_torch — the PyTorch + CUDA port of ``divshot_tpu``.

Module names follow the JAX package so each counterpart is easy to find.
Nothing here imports JAX, flax, PIL or ``divshot_tpu``; the hand-written
Hopper kernels live under ``csrc/`` and are built on first use by
``_build.py``.
"""

__version__ = "0.1.0"
