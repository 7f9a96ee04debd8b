"""Grouped-query decode attention on the card: wrapper of the CUDA kernel in
``csrc/decode_attention.cu``.

Replaces no TPU kernel: the reference's decode attention is plain ``jnp``
(``repro.models.common.decode_attention``).  The port's plain body,
:func:`repro_torch.models.common.plain_decode_attention`, casts the whole
cache to float32 and copies it before its products; the kernel reads each
K/V element of the visible range once, where it lies, and computes the
same float32 scores, softcap, softmax and PV product (the source note says
why the bound is device-memory bytes).  The kernel reads the token's
position from device memory, and :func:`plan` fixes the launch's splits
from the shapes alone, so one launch serves every position and a CUDA graph
of the decode step replays it unchanged while the position advances on the
card.

:func:`decode_attention` takes CUDA tensors only and raises on anything the
kernel does not take: ``models.common.decode_attention`` sends a CUDA
tensor here and every other one to the plain body.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

__all__ = ["HEAD_DIMS", "MAX_GROUP", "decode_attention", "plan", "visible"]

HEAD_DIMS = (32, 64, 128, 256)  # the kernel's template instances
MAX_GROUP = 8  # query heads a KV head
BLOCKS_PER_SM = 16  # the grid the planner aims at, in blocks an SM (several waves)
CHUNK_ALIGN = 32  # a split's positions, a multiple of this
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
_SMS: dict[int, int] = {}


def visible(position: int, smax: int, window: int | None) -> tuple[int, int]:
    """``(lo, hi)``, the inclusive range of cache positions the token at
    ``position`` attends to: every one the plain path does not mask, up to
    ``Smax - 1`` when ``position`` is past the cache (its slot clamped).
    Raises where none is visible (the plain path would then average every
    position with equal weights)."""
    hi = min(position, smax - 1)
    lo = 0 if window is None else max(0, position - window + 1)
    if position < 0 or lo > hi:
        raise ValueError(f"no visible cache position at position {position} (Smax {smax}, window {window})")
    return lo, hi


def plan(batch: int, hkv: int, smax: int, window: int | None, sms: int) -> tuple[int, int]:
    """``(chunk, splits)`` of every launch at these shapes: the widest
    visible range, ``min(Smax, window)`` positions, cut into ``splits``
    chunks of ``chunk`` positions (a multiple of :data:`CHUNK_ALIGN`),
    enough for about :data:`BLOCKS_PER_SM` blocks an SM over ``batch ·
    hkv`` (row, KV head) pairs.  At a position whose :func:`visible` range
    is ``(lo, hi)``, split ``s`` covers ``[lo + s·chunk, min(hi, lo + (s +
    1)·chunk - 1)]``, as the kernel's blocks compute it: empty where it
    starts past ``hi``."""
    n = smax if window is None else min(smax, window)
    want = max(1, -(-BLOCKS_PER_SM * sms // (batch * hkv)))
    chunk = CHUNK_ALIGN * max(1, -(-n // (want * CHUNK_ALIGN)))
    return chunk, -(-n // chunk)


def _sms(index: int) -> int:
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hkv, G, hd)
    k_cache: torch.Tensor,  # (B, Smax, Hkv, hd)
    v_cache: torch.Tensor,
    position: int | torch.Tensor,
    *,
    window: int | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """``plain_decode_attention`` on the card: ``(B, 1, Hkv, G, hd)`` in
    q's dtype.  q bfloat16 or float32; the caches contiguous, 16-byte
    aligned, both bfloat16 or both float32; hd in :data:`HEAD_DIMS`, G at
    most :data:`MAX_GROUP`.  ``position``: an int32 tensor of one element
    (0-d or ``(1,)``) on q's device, which the kernel reads there (where no
    position is visible its output is NaN: the caller checks its positions
    on the host), or a host ``int``, checked by :func:`visible` and filled
    into one on the card.  One wrapper call is one count of
    ``LAUNCHES["decode_attention"]`` (one launch, two with splits)."""
    if q.dim() != 5 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, 1, Hkv, G, hd) and the caches (B, Smax, Hkv, hd), "
                         f"got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, _, Hkv, G, hd = q.shape
    Smax = k_cache.shape[1]
    if k_cache.shape != (B, Smax, Hkv, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches must be (B, Smax, Hkv, hd) = ({B}, Smax, {Hkv}, {hd}), "
                         f"got {tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    if hd not in HEAD_DIMS or not 1 <= G <= MAX_GROUP:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS} and 1 to {MAX_GROUP} query heads a KV head, "
                         f"got hd {hd}, G {G}")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"kernel takes bfloat16 or float32, got q {q.dtype}, k {k_cache.dtype}, v {v_cache.dtype}")
    if not (q.is_cuda and k_cache.is_cuda and v_cache.is_cuda) or not (
            q.get_device() == k_cache.get_device() == v_cache.get_device()):
        raise ValueError(f"kernel takes CUDA tensors on one device, got {q.device}, {k_cache.device}, {v_cache.device}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()) or (k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("kernel takes contiguous, 16-byte aligned caches")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if isinstance(position, torch.Tensor):
        if position.dtype != torch.int32 or position.numel() != 1 or position.device != q.device:
            raise ValueError(f"position must be an int32 tensor of one element on {q.device}, "
                             f"got {position.dtype} {tuple(position.shape)} on {position.device}")
    else:
        visible(int(position), Smax, window)  # raises where no position is visible
        position = torch.full((), int(position), dtype=torch.int32, device=q.device)
    q = q.contiguous()
    chunk, splits = plan(B, Hkv, Smax, window, _sms(q.get_device()))
    out = torch.empty_like(q)
    part = torch.empty(B * Hkv * splits * G * (hd + 2), dtype=torch.float32, device=q.device) if splits > 1 else None
    lib = _lib.library("decode_attention")
    err = lib.hk_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), position.data_ptr(), _DTYPES[q.dtype],
        _DTYPES[k_cache.dtype], B, Smax, Hkv, G, hd, window or 0, chunk, splits, hd**-0.5,
        0.0 if logit_cap is None else float(logit_cap), _lib.stream(q),
    )
    _lib.check(lib, err, "decode attention")
    _lib.count("decode_attention")
    return out
