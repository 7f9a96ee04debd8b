"""The Summarizer's pinned staging ring (``repro_torch.core.pinned``) on
the CPU: its chunk plan, and that a CPU store never builds a ring.  The
ring's copies themselves run only on a card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest

from repro_torch.core import HistogramStore, build_exact, pinned, spans

T, C = pinned.MIN_BYTES, pinned.CHUNK_BYTES


@pytest.mark.parametrize(
    "nbytes",
    [1, T - 1, T, C - 1, C, C + 1, 3 * C + 7],
    ids=["one", "threshold-1", "threshold", "chunk-1", "chunk", "chunk+1", "3chunks+7"],
)
def test_the_chunk_plan_covers_a_row_once_in_order(nbytes):
    plan = pinned.chunks(nbytes, C)
    assert plan[0][0] == 0 and plan[-1][1] == nbytes
    assert all(b == a2 for (_, b), (a2, _) in zip(plan, plan[1:]))  # no gap, no overlap
    assert all(0 < b - a <= C for a, b in plan)
    assert len(plan) == -(-nbytes // C)


def test_a_cpu_store_builds_no_ring_and_counts_no_pinned_bytes(monkeypatch):
    """Even with every row above the threshold, a CPU store copies each
    row directly: no ring, no copy thread, no ``ingest.pinned_bytes``."""
    monkeypatch.setattr(pinned, "MIN_BYTES", 64)
    monkeypatch.setattr(pinned, "_RINGS", {})
    rng = np.random.default_rng(33)
    parts = {p: rng.gumbel(size=n).astype(np.float32) for p, n in enumerate([3000, 5000, 4096])}
    st = HistogramStore(num_buckets=16, device="cpu")
    s0 = spans.snapshot()
    st.ingest(0, parts[0])
    st.ingest_many({1: parts[1], 2: parts[2]})
    s1 = spans.snapshot()
    assert pinned._RINGS == {}
    assert s1["ingest.pinned_bytes"] == s0["ingest.pinned_bytes"]
    assert s1["ingest.upload_bytes"] - s0["ingest.upload_bytes"] == sum(v.nbytes for v in parts.values())
    for pid, v in parts.items():
        want = build_exact(v, 16, device="cpu")
        assert np.array_equal(st.summaries[pid].boundaries, want.boundaries.numpy())
        assert np.array_equal(st.summaries[pid].sizes, want.sizes.numpy())
