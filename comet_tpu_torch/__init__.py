"""COMET in PyTorch with hand-written CUDA kernels for the H100.

The port of ``comet_tpu`` (JAX, TPU), module for module: ``config``,
``geometry``, ``ops`` (with the CUDA kernels K1 to K5 under ``csrc``),
``models`` (with the windowed long-sequence mode), the weight bridge
``weights``, and the train, eval and bench entry points: ``data``,
``metrics``, ``training`` (the train and eval loops, the optimizer,
checkpoints), ``bench_lib``, ``entry`` and the command line ``cli``, the
distributed layer ``parallel`` (the (data, model) mesh over
``torch.distributed``, data and tensor parallelism), with
``twoview`` (two-view and scene geometry: the 7- and 8-point,
homography and essential RANSACs, the 5-point and EPnP solvers, PnP,
alignment, the dense LM bundle adjustment, preliminary cameras, the staged
``reconstruct_scene`` and the robust-estimator registry), ``utils`` (weight
files, among them the JAX package's flax ``.msgpack`` read without JAX,
the one-time inference cast, the demo's exports, the COLMAP model, the
dense-depth alignment, the serving export, profiling) and ``native`` (the
C++ frame loader, host code built with ``g++`` at first use) behind it. It
imports neither JAX nor ``comet_tpu``. Public functions keep the JAX
layouts: images [B, S, H, W, 3], queries [B, N, 2]. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.
"""
