"""BENCHMARK.json and the files the harness finds by name."""
import json
import os
import re

import pytest

from hbench import harness, tiny

BENCH = harness.load_bench()
ALL = harness.with_deferred(BENCH)  # with the cells kept out of it (``deferred/``)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_every_cell_finds_its_config_traffic_and_system():
    for w in ALL["workloads"]:
        cell, cfg, traffic = harness.cell_parts(ALL, w["name"])
        assert cell is w and cfg["name"] == w["config"]
        assert traffic["loop"] in ("open", "closed")
        assert os.path.exists(os.path.join(harness.HERE, "systems", cfg["system"] + ".py"))
        assert harness.system_class(cfg, False).__name__ == "System"
        limits = harness.cell_limits(w["name"])
        assert limits and all(v >= 0 for v in limits.values())


def test_every_cell_has_its_three_tiny_files():
    for w in ALL["workloads"]:
        over = tiny.overrides(w)
        assert set(over) == {"config", "traffic", "limits"}, w["name"]
        cfg, traffic = harness.cell_parts(ALL, w["name"])[1:]
        assert set(over["config"]) <= set(cfg) and set(over["traffic"]) <= set(traffic), w["name"]
        assert set(over["limits"]) <= set(harness.cell_limits(w["name"])), w["name"]


def test_a_missing_tiny_file_is_a_layout_error_that_names_it():
    cell = {**ALL["workloads"][0], "traffic": "no_such_mix"}
    with pytest.raises(tiny.LayoutError, match=r"tiny/traffic/no_such_mix\.json"):
        tiny.overrides(cell)


def test_every_per_layer_metric_has_a_reader_that_reads_nothing_from_an_empty_run():
    empty = {"config": {"num_buckets": 8}, "traffic": {"beta": 4}, "trace": None,
             "counters": {"tile_sort": 0, "merge_cut": 0, "cache_hits": 0, "cache_misses": 0,
                          "partitions": 0, "values": 0, "requests": 0}}
    for m in ALL["per_layer"]:
        reader = harness.load_module(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
        assert reader.read(empty) is None, m["name"]


def check_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        mine = [m for m in bench["end_to_end"] if harness.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in bench["per_layer"] if harness.applies(m, w["name"])]
        assert layer and all(harness.applies(e2e[m["moves"]], w["name"]) for m in layer)
    cells = {w["name"] for w in bench["workloads"]}
    assert all(set(m.get("workloads", ())) <= cells for m in bench["end_to_end"] + bench["per_layer"])
    for c in bench["configs"]:
        assert c["file"].startswith("hbench/") and os.path.exists(os.path.join(harness.ROOT, c["file"]))


def test_contract_shape():
    check_contract_shape(BENCH)


def test_deferred_cells_fit_the_contract_once_copied_back():
    assert len(ALL["workloads"]) > len(BENCH["workloads"])
    check_contract_shape(ALL)


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(harness.HERE, "traffic"))))
def test_traffic_files_parse(name):
    with open(os.path.join(harness.HERE, "traffic", name)) as f:
        t = json.load(f)
    if "batch" in t:  # a served model's turns (serving.py)
        assert t["loop"] == "closed" and {"batch", "prompt_tokens", "new_tokens"} <= set(t)
        assert min(int(t[k]) for k in ("batch", "prompt_tokens", "new_tokens")) >= 1
        return
    assert {"fill", "loop", "days", "beta"} <= set(t)
    from hbench import traffic as gen
    for key, table in (("windows", gen.WINDOWS), ("publish", gen.WINDOWS), ("tenants", gen.TENANTS)):
        if key in t and t[key]["kind"] != "all":
            assert t[key]["kind"] in table
