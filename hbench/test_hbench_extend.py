"""The harness takes new cells, mixes, configurations and metrics as new
files alone: a copy of ``hbench/`` gets only files it did not have (and a
``BENCHMARK.json`` with their entries), and each new cell runs correct on
the port's ``device="cpu"`` path at a tiny size, its control not."""
import json
import os
import shutil

import pytest

from hbench import harness

TENANTS = {"name": "tenants", "system": "registry", "num_buckets": 32, "retention_partitions": 31, "tenants": 5,
           "values_per_partition": 2048, "pool_partitions": 31, "dtype": "float32",
           "distribution": {"kind": "lognormal", "mu": -1.8, "sigma": 0.55}}
RAGGED = {"name": "ragged", "system": "store", "num_buckets": 64, "retention_partitions": 31, "tenants": 1,
          "values_per_partition": {"kind": "lognormal", "median": 3000, "sigma": 0.8, "min": 64, "max": 30000},
          "pool_partitions": 7, "dtype": "float32", "distribution": {"kind": "gumbel", "loc": 0.0, "scale": 1.0}}
OPEN = {"fill": {"days": 31, "mode": "async"}, "loop": "open", "rate_per_s": 300,
        "tenants": {"kind": "zipf", "s": 1.0}, "days": 31, "beta": 8, "check_answers": 100}
EXACT = {"boundaries_off_leaves": 0, "bucket_err_over_eps": 1.0}
NEW = {
    "configs/tenants.json": TENANTS,
    "configs/ragged.json": RAGGED,
    "traffic/windows_recent.json": {**OPEN, "windows": {"kind": "recent", "lengths": [1, 7, 14, 31]}},
    "traffic/windows_mixed.json": {**OPEN, "windows": {"kind": "uniform"}, "ingest": {"every_s": 0.15, "mode": "async"}},
    "traffic/refresh_all.json": {**OPEN, "rate_per_s": 20, "tenants": {"kind": "all"}, "windows": {"kind": "newest"}},
    "limits/tenants.recent.json": {"limits": EXACT},
    "limits/tenants.mixed.json": {"limits": {"summary_mismatches": 0, **EXACT}},
    "limits/tenants.refresh_all.json": {"limits": EXACT},
    "limits/ragged.daily.json": {"limits": {"summary_mismatches": 0, **EXACT}},
}
CELLS = {"tenants.recent": ("tenants", "windows_recent"), "tenants.mixed": ("tenants", "windows_mixed"),
         "tenants.refresh_all": ("tenants", "refresh_all"), "ragged.daily": ("ragged", "daily_publish")}
METRIC = '''def read(run):
    c = run["counters"]
    return c["host_row_copies"] / c["requests"] if c.get("requests") else None
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(harness.HERE, os.path.join(root, "hbench"), ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.with_deferred(harness.load_bench())
    for rel, body in NEW.items():
        assert not os.path.exists(os.path.join(harness.HERE, rel)), rel
        with open(os.path.join(root, "hbench", rel), "w") as f:
            json.dump(body, f)
    metric = os.path.join("metrics", "host_row_copies_per_request.query.py")
    assert not os.path.exists(os.path.join(harness.HERE, metric))
    with open(os.path.join(root, "hbench", metric), "w") as f:
        f.write(METRIC)
    bench["configs"] += [{"name": n, "source": "a test", "file": f"hbench/configs/{n}.json", "reduced": [], "why": "a test"}
                         for n in ("tenants", "ragged")]
    bench["workloads"] += [{"name": w, "config": c, "traffic": t, "chips": 1, "why": "a test"} for w, (c, t) in CELLS.items()]
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    bench["per_layer"] = [
        {"name": "host_row_copies_per_request.query", "unit": "copies", "better": "lower", "source": "program_counter",
         "layer": "interval tree", "moves": "answer_p50_ms", "workloads": ["tenants.recent"]},
        *[m for m in bench["per_layer"] if m["name"] == "cache_hit_share.query"],
    ]
    bench["per_layer"][-1]["workloads"] = ["tenants.recent"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run(root, name, control=False, trace=False):
    over = {"traffic": {"beta": 16}} if name == "ragged.daily" else {}
    return harness.run_cell(name, 2**31 + 77, 0.6, trace, device="cpu", control=control, overrides=over, root=root)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_cell_of_new_files_runs_correct(root, name):
    out = run(root, name)
    assert out["correct"] and out["failed"] == 0, out
    assert set(out["checks"]) == set(harness.cell_limits(name, root))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_cell_of_new_files_fails_its_control(root, name):
    out = run(root, name, control=True)
    assert out["failed"] == 0 and not out["correct"], out


def test_a_new_metric_reads_a_program_counter_the_adapter_passes_through(root):
    out = run(root, "tenants.recent", trace=True)
    assert out["correct"], out
    assert out["metrics"]["host_row_copies_per_request.query"]["value"] == 0.0  # the shared arena gathers on the device
    assert out["metrics"]["cache_hit_share.query"]["value"] > 25.0  # the newest windows repeat: the cache answers


def test_windows_follow_the_newest_partition_while_ingest_runs_beside_them(root, monkeypatch):
    fed, judged = [], []
    ingest, judge = harness._ingest, harness.Reference.judge_answers
    monkeypatch.setattr(harness, "_ingest", lambda sysobj, pool, d, *a: (fed.append(d), ingest(sysobj, pool, d, *a)))
    monkeypatch.setattr(harness.Reference, "judge_answers", lambda self, ans: (judged.extend(ans), judge(self, ans))[1])
    out = run(root, "tenants.mixed")
    assert out["correct"] and "summary_mismatches" in out["checks"], out
    assert fed == list(range(31, 31 + len(fed))) and len(fed) >= 3  # set-up filled ids 0..30
    newest = fed[-1]
    assert max(hi for _, _, hi, *_ in judged) == newest  # the month asked after the window
    assert all(newest - 30 <= lo for _, lo, *_ in judged[-5:])
    assert min(lo for _, lo, *_ in judged) < newest - 30 + 1  # earlier answers were of earlier months
