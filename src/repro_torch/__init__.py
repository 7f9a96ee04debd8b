"""PyTorch/CUDA port of the equi-depth histogram framework (``repro``).

- :mod:`repro_torch.core` — histograms, the segment-tree interval engine,
  ``HistogramStore``, the registry, telemetry and the distributed
  summarize-and-merge (``core.distributed``), on PyTorch tensors;
- :mod:`repro_torch.kernels` — the hand-written CUDA kernels of that path
  (row sort, stable kv sort, batched merge, bucket count) and their plain
  versions;
- :mod:`repro_torch.serve` — the serving plane (``HistogramService``,
  standing-query subscriptions);
- :mod:`repro_torch.launch` — the ``torch.distributed`` device mesh;
- :mod:`repro_torch.optim` — AdamW with quantile clipping, and gradient
  compression, over trees of tensors (:mod:`repro_torch.tree`);
- :mod:`repro_torch.data` — the synthetic LM stream and the length
  bucketer;
- :mod:`repro_torch.convert` — state carried across from the JAX package.

Imports ``torch`` and ``numpy``; never ``jax``, and nothing of ``repro``.
"""
