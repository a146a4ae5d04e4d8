"""COMET in PyTorch with hand-written CUDA kernels for the H100.

The port of ``comet_tpu`` (JAX, TPU), module for module: ``config``,
``geometry``, ``ops`` (with the CUDA kernels K1 and K2 under ``csrc``),
``models`` and the weight bridge ``weights``. It imports neither JAX nor
``comet_tpu``. Public functions keep the JAX layouts: images
[B, S, H, W, 3], queries [B, N, 2].
"""
