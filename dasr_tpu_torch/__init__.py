"""dasr_tpu_torch — the PyTorch / CUDA port of ``dasr_tpu`` for NVIDIA Hopper.

The package mirrors ``dasr_tpu``'s layout (``core``, ``data``, ``ops``,
``nn``, ``train``, ``models``, ``eval``, ``cli``) so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax`` or
``dasr_tpu``. Hand-written CUDA kernels live in ``csrc/`` and are built by
``kernels/build.py`` at first use.
"""
