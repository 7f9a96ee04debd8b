"""The decode attention kernel's declaration, launch planning and layout,
on the CPU (the kernel itself runs only on the card:
``tests/test_torch_cuda.py``).

The planner (``kernels/gqa_decode.py``) fixes one split layout a shape,
which must hand the kernel exactly the cache positions the plain path
leaves unmasked, each to one split, at every position; every
template instance's lane layout, evaluated from the source's own
expressions, must read whole rows and keep its registers in bounds.  On the CPU
``models.common.decode_attention`` is the plain body, bit for bit, and
launches nothing.
"""
import os
import re

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _lib, gqa_decode
from repro_torch.models import common

SOURCE = os.path.join(_lib._CSRC, "decode_attention.cu")


def source() -> str:
    with open(SOURCE) as f:
        return f.read()


def test_kernel_is_declared_with_its_source_and_signature():
    assert _lib.KERNELS["decode_attention"] == "decode_attention.cu"
    params = re.search(r"int hk_decode_attention\(([^)]*)\)", source()).group(1).split(",")
    assert len(params) == len(_lib._SIGNATURES["hk_decode_attention"]) == 19
    assert params[5].split() == ["const", "int*", "pos"]  # the position, read on the device
    kinds = ["ptr" if "*" in p else p.split()[0] for p in params]
    want = {_lib._PTR: "ptr", _lib._INT: "int", _lib._FLT: "float"}
    assert kinds == [want[t] for t in _lib._SIGNATURES["hk_decode_attention"]]


def geometry(hd: int, group: int, kv_bytes: int) -> dict[str, int]:
    """The constants of the source's ``Geo`` for one instance, evaluated
    from the source's own expressions: elements a 16-byte load (``kVec``),
    a lane's elements a row (``kE``), lanes a row (``kTpr``), rows a warp
    reads at once (``kRpw``), loads a lane a row (``kNc``), rows a lane
    keeps in flight (``kUnroll``), rows a block iteration (``kRows``).
    G is rounded up to 1, 2, 4 or 8, as ``launch_g`` picks the instance."""
    src = source()
    env = {"HD": hd, "GM": 1 << max(0, group - 1).bit_length(), "max": max, "min": min,
           "kWarps": int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))}
    body = src[src.index("struct Geo {"):src.index("};", src.index("struct Geo {"))]
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body):
        expr = expr.replace("static_cast<int>(sizeof(T))", str(kv_bytes)).replace("cmax", "max")
        env[name] = eval(expr.replace("cmin", "min").replace("/", "//"), env)
    return {k: v for k, v in env.items() if k.startswith("k")}


def visible_by_mask(position, smax, window):
    """The positions the plain path does not mask (``kv_pos <= position``
    and, with a window, ``kv_pos > position - window``)."""
    pos = np.arange(smax)
    keep = pos <= position
    if window is not None:
        keep &= pos > position - window
    return pos[keep]


@pytest.mark.parametrize("batch,hkv,smax,position,window", [
    (104, 8, 1152, 0, None),  # the first token: one position
    (104, 8, 1152, 1088, None),  # the cell's decode
    (8, 8, 1152, 1151, None),
    (8, 8, 1152, 1200, None),  # past the cache: clamped to Smax - 1
    (2, 8, 4200, 4150, 4096),  # gemma-2's local layer, the window bites
    (2, 8, 4200, 4300, 4096),  # clamped and windowed
    (2, 8, 4200, 10, 4096),  # a window longer than the positions so far
    (1, 1, 500_000, 499_999, None),  # one (row, head): many splits
    (2, 2, 48, 40, 32),  # the smoke width
])
def test_plan_covers_the_visible_range_exactly_once(batch, hkv, smax, position, window):
    chunk, splits = gqa_decode.plan(batch, hkv, smax, window, sms=132)
    assert chunk % gqa_decode.CHUNK_ALIGN == 0 and splits >= 1
    assert (splits - 1) * chunk < (smax if window is None else min(smax, window))  # no split past the widest range
    covered = np.concatenate(kernel_splits(position, smax, window, chunk, splits))
    np.testing.assert_array_equal(covered, visible_by_mask(position, smax, window))


def kernel_splits(position, smax, window, chunk, splits) -> list[np.ndarray]:
    """Each split's positions as the kernel's blocks compute them from the
    position they read: ``hi = min(position, Smax - 1)``, ``lo = max(0,
    position - window + 1)`` (0 without a window), split ``s`` from ``lo +
    s·chunk`` to ``min(hi, lo + (s + 1)·chunk - 1)``; the non-empty ones
    come first."""
    hi = min(position, smax - 1)
    lo = 0 if window is None else max(0, position - window + 1)
    parts = [np.arange(lo + s * chunk, min(hi, lo + s * chunk + chunk - 1) + 1) for s in range(splits)]
    sizes = [len(p) for p in parts]
    full = sum(1 for n in sizes if n == chunk)
    assert sizes[0] >= 1 and all(n == 0 for n in sizes[full + 1:]), sizes  # whole splits, one part, then empty ones
    return parts


@pytest.mark.parametrize("batch,hkv,smax,window", [
    (104, 8, 1152, None),  # the cell's shape
    (8, 8, 1152, None),
    (2, 8, 700, 256),  # a window shorter than the cache
    (2, 8, 300, 4096),  # a window longer than the cache
    (1, 1, 3000, None),  # one (row, head): many splits
    (2, 2, 48, 32),  # the smoke width
])
def test_one_split_layout_covers_every_position_exactly_once(batch, hkv, smax, window):
    """The layout ``plan`` fixes for a shape serves every position a decode
    reaches, past the cache included (its slot clamped): each visible
    position in exactly one split, no masked one in any, no split read past
    ``hi``."""
    chunk, splits = gqa_decode.plan(batch, hkv, smax, window, sms=132)
    last = smax + 40 if window is None else smax + window - 2  # beyond: nothing visible
    for position in range(last + 1):
        parts = kernel_splits(position, smax, window, chunk, splits)
        np.testing.assert_array_equal(np.concatenate(parts), visible_by_mask(position, smax, window))
        assert all(p.max() <= min(position, smax - 1) for p in parts if p.size)


@pytest.mark.parametrize("position,smax,window", [(-1, 16, None), (40, 16, 8), (23, 16, 8)])
def test_no_visible_position_raises(position, smax, window):
    assert visible_by_mask(position, smax, window).size == 0
    with pytest.raises(ValueError):
        gqa_decode.visible(position, smax, window)


@pytest.mark.parametrize("kv_bytes", [2, 4])
@pytest.mark.parametrize("hd", gqa_decode.HEAD_DIMS)
@pytest.mark.parametrize("group", range(1, gqa_decode.MAX_GROUP + 1))
def test_geometry_splits_each_row_over_whole_lanes(hd, group, kv_bytes):
    """Every instance: a row's lanes read it whole in 16-byte words, 4 to
    32 lanes a row (at least 64 contiguous bytes a load), a lane keeps at
    least 128 bytes of K and V in flight, and the query and accumulator
    registers (2·GM·kE) stay at most 128."""
    geo = geometry(hd, group, kv_bytes)
    gm = 1 << max(0, group - 1).bit_length()
    assert gm >= group and geo["kTpr"] * geo["kE"] == hd and geo["kNc"] * geo["kVec"] == geo["kE"]
    assert geo["kTpr"] in (4, 8, 16, 32) and geo["kVec"] * kv_bytes == 16 and geo["kRpw"] * geo["kTpr"] == 32
    assert geo["kUnroll"] * 2 * geo["kE"] * kv_bytes >= 128
    assert 2 * gm * geo["kE"] <= 128


def test_the_cells_shape_reads_each_row_with_sixteen_lanes():
    assert geometry(128, 4, 2) == {"kWarps": 4, "kVec": 8, "kE": 8, "kTpr": 16, "kRpw": 2, "kNc": 1,
                                   "kUnroll": 4, "kRows": 32}
    assert gqa_decode.plan(104, 8, 1152, None, 132) == (384, 3)
    # at the cell's decode positions 1,088 and 1,151 a layout cut to the visible range alone
    # (n = position + 1) has the same boundaries, so the fixed layout sums there in its order
    want = -(-gqa_decode.BLOCKS_PER_SM * 132 // (104 * 8))
    for position in (1088, 1151):
        n = position + 1
        chunk = gqa_decode.CHUNK_ALIGN * -(-n // (want * gqa_decode.CHUNK_ALIGN))
        assert (chunk, -(-n // chunk)) == (384, 3)
        assert [p[0] for p in kernel_splits(position, 1152, None, 384, 3)] == [0, 384, 768]


@pytest.mark.parametrize("window,cap", [(None, None), (5, 50.0)])
def test_cpu_decode_attention_is_the_plain_body_and_launches_nothing(window, cap):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 1, 2, 3, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 12, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 12, 2, 16)).astype(np.float32))
    kernels.reset_launches()
    got = common.decode_attention(q, k, v, 7, window=window, logit_cap=cap)
    want = common.plain_decode_attention(q, k, v, 7, window=window, logit_cap=cap)
    assert torch.equal(got, want)
    assert kernels.LAUNCHES["decode_attention"] == 0
    meta = common.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), 7, window=window, logit_cap=cap)
    assert meta.device.type == "meta" and meta.shape == q.shape


def test_the_wrapper_takes_only_what_the_kernel_takes():
    q = torch.zeros((2, 1, 2, 3, 32))
    k = torch.zeros((2, 12, 2, 32))
    with pytest.raises(ValueError):  # CPU tensors
        gqa_decode.decode_attention(q, k, k, 7)
    with pytest.raises(ValueError):  # hd 48
        gqa_decode.decode_attention(torch.zeros((2, 1, 2, 3, 48)), torch.zeros((2, 12, 2, 48)),
                                    torch.zeros((2, 12, 2, 48)), 7)
    with pytest.raises(ValueError):  # nine query heads a KV head
        gqa_decode.decode_attention(torch.zeros((2, 1, 2, 9, 32)), k, k, 7)
    with pytest.raises(TypeError):
        gqa_decode.decode_attention(q.half(), k.half(), k.half(), 7)
    assert kernels.LAUNCHES["decode_attention"] == 0
