"""A run with the timed path broken underneath comes out not correct:
each fault that a cell can have, planted in the program (the port's
``device="cpu"`` path).  The exchange between chips is not among them:
every cell runs on one card."""
import numpy as np
import pytest

from hbench import harness, tiny
from hbench.data import Pool
from hbench.reference.exact import Reference

from repro_torch.core import interval_tree, stream
from repro_torch.core.stream import HistogramStore
from repro_torch.core.tenant import TenantRegistry

BENCH = harness.with_deferred(harness.load_bench())


def run(name, seconds=0.6):
    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    return harness.run_cell(name, 987654321, seconds, False, device="cpu",
                            overrides=tiny.overrides(cell), bench=BENCH)


def half_answered(real):
    """Answers the first half of a batch (rounded down); the rest get the
    first half's answers, and a batch of one gets none."""
    def query_many(self, queries, beta, **kw):
        keep = len(queries) // 2
        out = real(self, queries[:keep], beta, **kw) if keep else []
        return [out[i % keep] for i in range(len(queries))] if keep else []
    return query_many


def nudged(real):
    """The merge, with one boundary of every answer moved one ulp."""
    def merge_stacks(bounds, sizes, beta, device=None):
        bo, so = real(bounds, sizes, beta, device=device)
        bo = bo.clone()
        mid = bo.shape[-1] // 2
        bo[:, mid] = bo[:, mid].nextafter(bo[:, mid] + 1)
        return bo, so
    return merge_stacks


def nudged_summaries(real):
    def build(values, ns, num_buckets, *a, **k):
        h = real(values, ns, num_buckets, *a, **k)
        b = h.boundaries.clone()
        b[:, 1] = b[:, 1].nextafter(b[:, 1] + 1)
        return type(h)(b, h.sizes)
    return build


FAULTS = {
    "state_unchanged": lambda mp: mp.setattr(HistogramStore, "_apply", lambda self, summs: None),
    "half_the_day_left_out": lambda mp: mp.setattr(
        HistogramStore, "ingest", (lambda real: lambda self, pid, v: real(self, pid, v[: len(v) // 2]))(HistogramStore.ingest)),
    "half_the_batch_left_out": lambda mp: mp.setattr(HistogramStore, "query_many", half_answered(HistogramStore.query_many)),
    "answer_altered": lambda mp: mp.setattr(interval_tree, "merge_stacks", nudged(interval_tree.merge_stacks)),
    "summary_altered": lambda mp: mp.setattr(stream, "build_exact_padded_batched",
                                             nudged_summaries(stream.build_exact_padded_batched)),
}

CASES = [
    ("paper_month.daily", "state_unchanged"),
    ("paper_month.daily", "half_the_day_left_out"),
    ("paper_month.daily", "answer_altered"),
    ("paper_month.daily", "summary_altered"),
    ("paper_month.windows", "half_the_batch_left_out"),
    ("paper_month.windows", "answer_altered"),
]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    real = harness.set_up

    def set_up(*args, **kw):  # the fault is planted once set-up is done
        out = real(*args, **kw)
        FAULTS[fault](monkeypatch)
        return out

    monkeypatch.setattr(harness, "set_up", set_up)
    out = run(name)
    assert not out["correct"], out


@pytest.mark.parametrize("registry", [False, True])
def test_the_reference_agrees_with_the_ports_cpu_path(registry):
    rng = np.random.default_rng(3)
    tenants = 3 if registry else 1
    lengths = rng.integers(2000, 4000, size=(tenants, 9))  # ragged partitions
    pool = Pool(rng.gumbel(size=int(lengths.sum())).astype(np.float32), lengths)
    ref = Reference(pool, 40, "cpu")
    beta = 12
    items, answers = [], []
    if registry:
        reg = TenantRegistry(40, shared_arena=True, device="cpu")
        for t in range(3):
            for d in range(9):
                reg.ingest_async(f"t{t}", d, pool.part(t, d))
        reg.flush()
        for t in range(3):
            items += [(t, p, s.boundaries, s.sizes) for p, s in reg[f"t{t}"].summaries.items()]
        qs = [(t, lo, hi) for t in range(3) for lo in range(9) for hi in range(lo, 9)]
        got = reg.query_many([(f"t{t}", lo, hi) for t, lo, hi in qs], beta)
        reg.close()
    else:
        store = HistogramStore(40, device="cpu")
        for d in range(9):
            s = store.ingest(d, pool.part(0, d))
            items.append((0, d, s.boundaries, s.sizes))
        qs = [(0, lo, hi) for lo in range(9) for hi in range(lo, 9)]
        got = store.query_many([(lo, hi) for _, lo, hi in qs], beta)
    assert ref.summary_mismatches(items) == 0
    off, ratio = ref.judge_answers([(t, lo, hi, beta, h.boundaries, h.sizes, eps) for (t, lo, hi), (h, eps) in zip(qs, got)])
    assert off == 0 and 0 < ratio <= 1
