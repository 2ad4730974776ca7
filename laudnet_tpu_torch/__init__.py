"""laudnet_tpu_torch: the PyTorch / CUDA (H100) port of ``laudnet_tpu``.

Mirrors the JAX package's layout. It imports ``torch`` and never ``jax``,
``flax`` or ``laudnet_tpu``; the JAX package is the reference the port is
tested against. Hand-written CUDA kernels live in ``csrc/`` and are built
at first use on a machine with ``nvcc`` (`ops/_build.py`).
"""
