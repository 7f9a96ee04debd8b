"""A run with the timed path broken underneath comes out not correct:
each fault that a cell can have (``faults.py``, and those a configuration
brings in ``planted/<config>.py``), planted in the program (the port's
``device="cpu"`` path)."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hbench import faults, harness, tiny
from hbench.data import Pool
from hbench.reference.exact import Reference

from repro_torch.configs import get_config, smoke
from repro_torch.core.stream import HistogramStore
from repro_torch.core.tenant import TenantRegistry
from repro_torch.models import attention
from repro_torch.models.common import Init

BENCH = harness.with_deferred(harness.load_bench())
FAULTS, PLANTED = faults.planted()


def planted_run(monkeypatch, name, fault, plants=FAULTS, bench=BENCH, root=harness.ROOT):
    """Cell ``name`` at its tiny sizes in the checkout ``root``, with
    ``plants[fault]`` planted: once set-up is done, or, for a served model
    (its adapter's ``KIND``), whose run has no store set-up, before it."""
    cell, cfg, _ = harness.cell_parts(bench, name, root)
    if harness.is_model(cfg, root):
        plants[fault](monkeypatch)
    else:
        real = harness.set_up

        def set_up(*args, **kw):
            out = real(*args, **kw)
            plants[fault](monkeypatch)
            return out

        monkeypatch.setattr(harness, "set_up", set_up)
    return harness.run_cell(name, 987654321, 0.6, False, device="cpu", overrides=tiny.overrides(cell, root),
                            bench=bench, root=root)


CASES = [
    ("paper_month.daily", "state_unchanged"),
    ("paper_month.daily", "half_the_day_left_out"),
    ("paper_month.daily", "answer_altered"),
    ("paper_month.daily", "summary_altered"),
    ("paper_month.windows", "half_the_batch_left_out"),
    ("paper_month.windows", "answer_altered"),
    ("qwen3_8b.offline", "kv_one_position_off"),
    ("qwen3_8b.offline", "kv_cache_unwritten"),
    ("qwen3_8b.offline", "qk_norm_skipped_in_decode"),
    ("qwen3_8b.offline", "token_altered"),
    ("qwen3_8b.offline", "half_the_rows_left_out"),
]


@pytest.mark.parametrize("name,fault", CASES + PLANTED)
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    out = planted_run(monkeypatch, name, fault)
    assert not out["correct"], out


SMAX = 16


class NoHostRead(TorchDispatchMode):
    """Refuses every read of a tensor's value on the host (``int``,
    ``bool``, ``.item()``), which a CUDA graph's capture refuses too."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a value read on the host")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("offset", [1, None])
@pytest.mark.parametrize("position", [5, SMAX - 2, SMAX - 1, SMAX + 3])
def test_a_kv_fault_writes_its_slot_from_a_position_on_the_device(position, offset):
    """The KV faults take the position as the program's step does, a 0-d
    int32 tensor, and read no value of it on the host: one slot off writes
    the program's key and value at ``position + 1``, clamped to the
    cache's last slot; unwritten writes nothing."""
    cfg = smoke(get_config("qwen3-8b"))
    g = torch.Generator().manual_seed(5)
    p = attention.init_attention(cfg, Init(g, torch.device("cpu")))
    x = torch.randn((3, 1, cfg.d_model), generator=g)
    pos = torch.tensor(position, dtype=torch.int32)
    sound = attention.init_kv_cache(cfg, 3, SMAX, dtype=torch.float32)
    cache = attention.init_kv_cache(cfg, 3, SMAX, dtype=torch.float32)
    with NoHostRead():
        y, _ = attention.decode_attention_step(cfg, p, x, pos, sound)
        out, back = faults._decode_writing_at(offset)(cfg, p, x, pos, cache)
    assert back is cache and out.shape == y.shape and pos.shape == () and int(pos) == position
    written = [s for s in range(SMAX) if cache["k"][:, s].any() or cache["v"][:, s].any()]
    assert written == ([] if offset is None else [min(position + 1, SMAX - 1)])
    for s in written:
        here = min(position, SMAX - 1)  # where the program's step wrote the same key and value
        assert torch.equal(cache["k"][:, s], sound["k"][:, here]) and torch.equal(cache["v"][:, s], sound["v"][:, here])


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
