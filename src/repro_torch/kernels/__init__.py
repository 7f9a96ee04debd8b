"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

- :func:`sort_rows` / :func:`summarize_rows` — the Summarizer's row sort
  (``csrc/row_sort.cu``);
- :func:`sort_kv` — the stable key/value sort (``csrc/kv_sort.cu``), whose
  pair form :func:`argsort_pairs` also starts every long merge;
- :func:`merge_batched` — the batched merge (``csrc/merge_cut.cu``): one
  launch for a problem that fits one block, else the kv sort and one
  scan-and-cut launch;
- :func:`cumulative_counts` — the bucket count (``csrc/bucket_count.cu``).

The public entry points of :mod:`.ops` sit on them: :func:`bucket_sizes`,
the tile Summarizer :func:`summarize_tiles` and :func:`merge_histograms`.

Every wrapper above runs its plain version (:mod:`repro_torch.kernels.ref`)
for a CPU tensor and its kernel for a CUDA tensor.  The model's decode
attention core (:func:`.gqa_decode.decode_attention`,
``csrc/decode_attention.cu``, which replaces no TPU kernel) takes CUDA
tensors only: ``models.common.decode_attention`` keeps its plain body for
the others.  :data:`LAUNCHES` counts the kernel launches.  The kernels are
compiled at first use (``_lib.build``).
"""
from repro_torch.kernels import ref
from repro_torch.kernels._lib import LAUNCHES, build, reset_launches
from repro_torch.kernels.bucket_count import cumulative_counts
from repro_torch.kernels.merge_cut import merge_batched
from repro_torch.kernels.tile_sort import (
    argsort_pairs,
    pad_to_tiles,
    sort_kv,
    sort_rows,
    summarize_rows,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ops import bucket_sizes, merge_histograms, summarize_tiles

__all__ = [
    "LAUNCHES",
    "argsort_pairs",
    "bucket_sizes",
    "build",
    "cumulative_counts",
    "merge_batched",
    "merge_histograms",
    "ops",
    "pad_to_tiles",
    "ref",
    "reset_launches",
    "sort_kv",
    "sort_rows",
    "summarize_rows",
    "summarize_tiles",
]
