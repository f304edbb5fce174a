"""PyTorch and CUDA port of the `repro` package, for NVIDIA Hopper GPUs.

The JAX package `repro` is the reference; this package imports nothing
of it (nor JAX). Layout and names follow `repro`: `core` (training,
the optimization ladder, quantized nets, dataset), `netgen` (compiler,
session, server, kernel tuner, design-space explorer), `kernels`
(hand-written CUDA kernels with their plain PyTorch versions), `serve`
(slot batching, the LM engine), and the LM stack's `configs`, `layers`,
`models`, `quantized`, `data`, `optim`, `train`, `checkpoint` and
`launch` (every family and modality; serving and training). Entry
points run on `cuda:0` unless the caller passes `device="cpu"`.
"""
