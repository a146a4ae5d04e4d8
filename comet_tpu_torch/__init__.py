"""COMET in PyTorch with hand-written CUDA kernels for the H100.

The port of ``comet_tpu`` (JAX, TPU), module for module: ``config``,
``geometry``, ``ops`` (with the CUDA kernels K1 to K5 under ``csrc``),
``models`` (with the windowed long-sequence mode), the weight bridge
``weights``, and the train, eval and bench entry points: ``data``,
``metrics``, ``training`` (the train and eval loops, the optimizer,
checkpoints), ``bench_lib``, ``entry`` and the command line ``cli``, the
distributed layer ``parallel`` (the (data, model) mesh over
``torch.distributed``, data and tensor parallelism), with
``twoview`` (triangulation) and ``utils`` (weight files, the one-time
inference cast, the demo's exports, the serving export, profiling) behind
it. It
imports neither JAX nor ``comet_tpu``. Public functions keep the JAX
layouts: images [B, S, H, W, 3], queries [B, N, 2]. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.
"""
