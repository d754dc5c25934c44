"""PyTorch/CUDA port of the split-learning system (``repro`` is the JAX
reference). Sub-packages mirror the reference path for path; this package
imports ``torch`` and ``numpy`` only.

Ported so far: the multi-tenant LoRA serving path of the dense families
(configs, model, KV cache, ``generate``, ``ServingEngine``, admission), the
decision stack and its measured-cost calibration, split LoRA fine-tuning
(splitting, optimizer, train step, trainer, checkpoints, faults, the SL
protocol), and five hand-written CUDA kernels under ``csrc/``.
"""
