"""Bucket count against fixed boundaries: wrapper of the CUDA kernel in
``csrc/bucket_count.cu``.

Replaces ``bucket_count_kernel`` of ``repro/kernels/bucket_count.py``
(wrapper ``cumulative_counts_pallas``).  The TPU kernel compares each tile
of the stream with every boundary (n·(T+1) compares); the CUDA kernel
places each value by a branch-free search of fixed depth over the
boundaries laid out in BFS order in shared memory, keeps integer counts,
and each block adds its own cumulative counts into the zeroed output: one
memset and one launch a call.  The source note in ``csrc/bucket_count.cu``
says why the bound is device-memory bytes; :func:`grid` sizes the launch.

Two differences from the reference, both on purpose:

- the stream is never padded, so nothing but the real values is counted.
  ``cumulative_counts_pallas`` pads with ``+inf`` and counts the padding
  whenever ``b_T = +inf``; its own oracle ``cumulative_counts_ref`` does
  not, and the port follows the oracle;
- the boundaries must be histogram boundaries — non-decreasing, with NaN
  only at the end — because the kernel searches them.  Anything else is
  rejected with a ``ValueError`` (the reference accepts any vector).

A tensor on the CPU goes to the plain version in :mod:`.ref`; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.device import as_tensor, home
from repro_torch.kernels import _lib, ref
from repro_torch.kernels.tile_sort import _check_cuda

__all__ = ["counts", "cumulative_counts", "grid"]

# geometry of csrc/bucket_count.cu (tests/test_torch_bucket_layout.py holds
# these to its constants)
THREADS = 512  # kThreads
BLOCKS_PER_SM = 1  # kBlocksPerSM, the kernel's launch bound
ROUND = THREADS * 4  # kRound: float4s of a full round, four a thread
MAX_ROUNDS = ((1 << 31) - 1) // (4 * ROUND)  # full rounds a block counts below 2^31 values
SHARED_MAX_T1 = 25_087  # the largest T+1 whose table and one histogram fit shared memory


def grid(n: int, T1: int, sms: int) -> tuple[int, int]:
    """``(blocks, float4s a block round)`` of one bucket-count launch over
    ``n`` values against ``T1`` boundaries on a card of ``sms`` SMs.

    At most one block an SM, none that counts fewer values than half the
    ``T1 + 1`` cumulative counts it adds to the output (one atomic each),
    and at least one.  Blocks count full rounds (four float4s a thread),
    block g the rounds g, g + blocks, ..., where the stream's full rounds
    fill at least half of those blocks, with more blocks if one would
    count 2^31 values (its shared counts are 32-bit).  A smaller stream is
    cut into one short round a block, in whole warps of float4s, so that
    it still spreads over the SMs."""
    q = n // 4
    rounds = -(-q // ROUND)
    blocks = max(1, min(sms * BLOCKS_PER_SM, 2 * n // (T1 + 1)))
    if 2 * rounds >= blocks:
        return max(min(blocks, rounds), -(-q // (ROUND * MAX_ROUNDS))), ROUND
    per = 32 * max(1, -(-q // (32 * blocks)))
    return max(1, -(-q // per)), per


def counts(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Exact int64 ``(T+2,)`` counts ``[#(x < b_j)]_{j<=T} ++ [#(x == b_T)]``
    of the float32 values of ``x`` (any shape; other dtypes are cast to
    float32 first, as the reference casts them).  The boundaries
    ``(T+1,)`` follow ``x`` to its device.

    On the card the kernel launches before the boundaries are checked: a
    copy of them comes back to the host while it runs, and boundaries that
    are not sorted raise ``ValueError`` then (the launch's answer is
    dropped), so that the card never waits on the host's check."""
    flat = x.reshape(-1)
    if flat.dtype != torch.float32:
        flat = flat.to(torch.float32)
    b = boundaries.reshape(-1).to(device=flat.device, dtype=torch.float32)
    if b.shape[0] < 2:
        raise ValueError("need at least two boundaries (T >= 1)")
    if flat.device.type == "cpu":
        return ref.counts_ref(flat, b)
    flat, b = flat.contiguous(), b.contiguous()
    _check_cuda(flat, b)
    T1, n = b.shape[0], flat.shape[0]
    host = torch.empty(T1, dtype=torch.float32, pin_memory=True)
    host.copy_(b, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(flat.device))
    out = torch.empty(T1 + 1, dtype=torch.int64, device=flat.device)  # the kernel zeroes it
    sms = torch.cuda.get_device_properties(flat.device).multi_processor_count
    blocks, per = grid(n, T1, sms)
    lib = _lib.library("bucket_count")
    err = lib.hk_bucket_count(
        flat.data_ptr(), n, b.data_ptr(), T1, blocks, per, out.data_ptr(), _lib.stream(flat),
    )
    _lib.check(lib, err, "bucket count")
    _lib.count("bucket_count")
    copied.synchronize()
    ref.count_prefix(host.numpy())  # raises on boundaries that are not histogram boundaries
    return out


def cumulative_counts(x, boundaries, *, device=None) -> torch.Tensor:
    """Cumulative ``< b_j`` counts of ``x`` (any shape) + the ``== b_T``
    count, float32 ``(T+2,)`` — ``cumulative_counts_pallas`` without its
    padding count (module docstring).  Input that is not a tensor goes to
    ``device`` (``None`` → the card)."""
    x = as_tensor(x, home(x, boundaries, device=device))
    return counts(x, as_tensor(boundaries, x.device)).to(torch.float32)
