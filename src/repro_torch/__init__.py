"""PyTorch/CUDA port of the equi-depth histogram framework (``repro``).

- :mod:`repro_torch.core` — histograms, the segment-tree interval engine,
  ``HistogramStore``, the registry, telemetry and the distributed
  summarize-and-merge (``core.distributed``), on PyTorch tensors;
- :mod:`repro_torch.kernels` — the hand-written CUDA kernels of that path
  (row sort, stable kv sort, batched merge, bucket count) and their plain
  versions;
- :mod:`repro_torch.serve` — the serving plane (``HistogramService``,
  standing-query subscriptions) and the model-serving ``Engine``;
- :mod:`repro_torch.models` and :mod:`repro_torch.configs` — the dense
  model stack and the model configs;
- :mod:`repro_torch.launch` — the ``torch.distributed`` device mesh and
  the serve and train launchers;
- :mod:`repro_torch.train`, :mod:`repro_torch.checkpoint` and
  :mod:`repro_torch.sharding` — the train step, the ``Trainer``, its
  checkpoints (the reference's format) and the logical-axis rules;
- :mod:`repro_torch.optim` — AdamW with quantile clipping, and gradient
  compression, over trees of tensors (:mod:`repro_torch.tree`);
- :mod:`repro_torch.data` — the synthetic LM stream and the length
  bucketer;
- :mod:`repro_torch.convert` — state and parameters carried across from
  the JAX package.

Imports ``torch`` and ``numpy``; never ``jax``, and nothing of ``repro``.
"""
