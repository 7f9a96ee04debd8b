"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

- :func:`sort_rows` / :func:`summarize_rows` — the Summarizer's row sort
  (``csrc/row_sort.cu``);
- :func:`sort_kv` — the stable key/value sort (``csrc/kv_sort.cu``), whose
  first stage :func:`argsort_pairs` also starts every merge;
- :func:`merge_batched` — the batched merge (``csrc/merge_cut.cu``).

Every wrapper runs its plain version (:mod:`repro_torch.kernels.ref`) for
a CPU tensor and its kernel for a CUDA tensor; :data:`LAUNCHES` counts the
kernel launches.  The kernels are compiled at first use (``_lib.build``).
"""
from repro_torch.kernels import ref
from repro_torch.kernels._lib import LAUNCHES, build, reset_launches
from repro_torch.kernels.merge_cut import merge_batched
from repro_torch.kernels.tile_sort import (
    argsort_pairs,
    sort_kv,
    sort_rows,
    summarize_rows,
)

__all__ = [
    "LAUNCHES",
    "argsort_pairs",
    "build",
    "merge_batched",
    "ref",
    "reset_launches",
    "sort_kv",
    "sort_rows",
    "summarize_rows",
]
