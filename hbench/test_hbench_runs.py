"""Whole runs of every cell on the CPU at tiny sizes: the program (the
port's ``device="cpu"`` path) is correct, the control is not, and the
result line keeps its schema."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from hbench import harness, tiny
from hbench.reference.model import part_file

BENCH = harness.with_deferred(harness.load_bench())
CELLS = [w["name"] for w in BENCH["workloads"]]
TOP = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run(name, control=False, seconds=0.6, seed=2**31 + 12345, trace=False, bench=BENCH, root=harness.ROOT):
    """One run of cell ``name`` at its tiny sizes in the checkout ``root``."""
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    return harness.run_cell(name, seed, seconds, trace, device="cpu", control=control,
                            overrides=tiny.overrides(cell, root), bench=bench, root=root)


def check_program(out, name, bench=BENCH):
    """What a sound run's result line holds: correct, and in its schema."""
    assert out["correct"], out
    assert TOP <= set(out) and list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in bench["end_to_end"] if harness.applies(m, name)}
    assert set(out["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)


def check_control(out):
    """The control's run ends, and a number it compared is past its limit."""
    assert out["failed"] == 0 and not out["correct"], out
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct_and_the_line_keeps_its_schema(name):
    check_program(run(name), name)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_one_precision_down_is_not_correct(name):
    check_control(run(name, control=True))


def test_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=harness.ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from hbench import harness, tiny\n"
        "b = harness.with_deferred(harness.load_bench())\n"
        "for w in b['workloads']:\n"
        "    harness.run_cell(w['name'], 7, 0.3, False, device='cpu', overrides=tiny.overrides(w), bench=b)\n"
        "sys.argv = ['run.py']\n"
        "import importlib.util as u\n"
        "s = u.spec_from_file_location('hb_run', {run!r}); m = u.module_from_spec(s); s.loader.exec_module(m)\n"
        "print(repr(m.forbidden_modules()))\n"
    ).format(root=harness.ROOT, src=os.path.join(harness.ROOT, "src"), run=os.path.join(harness.HERE, "run.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    configs = os.path.join(harness.HERE, "configs")
    served = [os.path.join(configs, n) for n in sorted(os.listdir(configs))
              if harness.is_model(harness._json(os.path.join(configs, n)))]
    assert served
    # the layer parts as committed, and a copy in which each served configuration has its own folder
    layers = os.path.join(harness.HERE, "reference", "layers")
    own = str(tmp_path / "layers")
    shutil.copytree(layers, own, ignore=shutil.ignore_patterns("__pycache__"))
    for path in served:
        c = harness._json(path)
        os.makedirs(os.path.join(own, c["name"]), exist_ok=True)
        for part in {p for kind in c["pattern"] for p in kind.split("+")}:
            shutil.copy(part_file(layers, c["name"], part), os.path.join(own, c["name"], part + ".py"))
    code = (
        "import sys, os; sys.path[:0] = [{root!r}]\n"
        "import hbench.reference.exact, hbench.reference.control, hbench.cost, hbench.traffic, hbench.data\n"
        "import json, hbench.model_cost, hbench.reference.model as m\n"
        "for path in {served!r}:\n"
        "    c = json.load(open(path))\n"
        "    m.Decoder(c, {layers!r})\n"
        "    d = m.Decoder(c, {own!r})\n"
        "    assert all(os.path.dirname(p.__file__) == os.path.join({own!r}, c['name']) for p in d.parts.values())\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}}))\n"
    ).format(root=harness.ROOT, served=served, layers=layers, own=own)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"
