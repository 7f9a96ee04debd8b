"""PyTorch/CUDA port of the equi-depth histogram framework (``repro``).

- :mod:`repro_torch.core` — histograms, the segment-tree interval engine
  and ``HistogramStore``, on PyTorch tensors;
- :mod:`repro_torch.kernels` — the hand-written CUDA kernels of that path
  (row sort, stable kv sort, batched merge) and their plain versions;
- :mod:`repro_torch.convert` — state carried across from the JAX package.

Imports ``torch`` and ``numpy``; never ``jax``, and nothing of ``repro``.
"""
