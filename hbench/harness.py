"""Runs one cell of ``BENCHMARK.json`` once and returns its result line.

Everything a cell is made of is found by name under ``hbench/`` in the
checkout (``root``): its configuration file (through ``BENCHMARK.json``),
its traffic mix (``traffic/<traffic>.json``, read by ``traffic.py``), its
limits (``limits/<workload>.json``), the adapter of the configuration's
``system`` (``systems/<system>.py``) and one reader a per-layer metric
(``metrics/<metric>.py``).

A run: the pool is drawn from the seed on the card and copied to the
host; the adapter warms every call the cell makes on a throwaway system;
set-up fills the partitions the traffic needs; then the window runs for
``seconds``, closed or open loop, with nothing built or compiled inside
it.  Once it has closed, the peak device memory is read, the system is
closed and freed, and the reference (``reference/exact.py``) judges what
the window produced.

A configuration whose adapter is a served model (``KIND = "model"``,
``systems/engine.py``) runs through ``serving.py`` instead: weights from
the seed, a closed loop of batched turns, the model's reference.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from hbench import data
from hbench import traffic as traffic_gen
from hbench.reference.exact import Reference
from hbench.trace import Tracer

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the traced stretch: from this share of the window, this long at most
TRACE_START = 0.4
TRACE_SECONDS = 3.0


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def with_deferred(bench: dict, root: str = ROOT) -> dict:
    """``bench`` with the entries of every cell kept out of it
    (``deferred/<workload>.json``), for the tests and the knee sweep:
    ``run.py`` runs only what ``BENCHMARK.json`` holds."""
    out = json.loads(json.dumps(bench))
    folder = os.path.join(root, "hbench", "deferred")
    for name in sorted(os.listdir(folder)) if os.path.isdir(folder) else []:
        for key, entries in _json(os.path.join(folder, name)).items():
            if key != "why":
                out[key] += entries
    return out


def part_path(root: str, kind: str, name: str, ext: str) -> str:
    """The file of ``name`` among the ``kind`` files (``traffic``, ``limits``, ...)."""
    return os.path.join(root, "hbench", kind, name + ext)


def load_module(path: str):
    name = "hbench_" + os.path.basename(os.path.dirname(path)) + "_" + os.path.basename(path).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(bench: dict, workload: str, root: str = ROOT) -> tuple[dict, dict, dict]:
    """The cell named ``workload``, its configuration and its traffic."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, _json(os.path.join(root, conf["file"])), _json(part_path(root, "traffic", cell["traffic"], ".json"))


def cell_limits(workload: str, root: str = ROOT) -> dict:
    """Each number the reference compares in ``workload``, with its limit."""
    return _json(part_path(root, "limits", workload, ".json"))["limits"]


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def is_model(cfg: dict, root: str = ROOT) -> bool:
    """The configuration's adapter serves a model (``KIND = "model"``)."""
    return getattr(load_module(part_path(root, "systems", cfg["system"], ".py")), "KIND", None) == "model"


def system_class(cfg: dict, control: bool, root: str = ROOT):
    path = (
        os.path.join(HERE, "reference", "control.py")
        if control
        else part_path(root, "systems", cfg["system"], ".py")
    )
    return load_module(path).System


def percentile_ms(lat_s: np.ndarray, q: float) -> float:
    """The ``q``-th percentile of every request's latency, in ms."""
    return float(np.percentile(lat_s, q)) * 1e3


def _delta(c1: dict, c0: dict) -> dict:
    return {k: c1[k] - c0.get(k, 0) for k in c1}


def _absolute(lo: int, hi: int, newest: int, days: int) -> tuple[int, int]:
    """Offsets inside the newest ``days`` partition ids as ids, none below 0."""
    first = newest - days + 1
    return max(0, first + int(lo)), max(0, first + int(hi))


def _ask(sysobj, wins, beta):
    """One window through ``query`` where the adapter has it, else one ``query_many``."""
    if len(wins) == 1 and hasattr(sysobj, "query"):
        return [sysobj.query(*wins[0], beta)]
    return sysobj.query_many(wins, beta)


def new_record() -> dict:
    """What a loop records of its window."""
    return {"summaries": [], "answers": [], "errors": [], "trace_ns": [], "trace_batches": [],
            "values": 0, "partitions": 0, "requests": 0}


def _ingest(sysobj, pool, d, mode, tracer, rec):
    """Partition id ``d`` of every tenant; counted once it has returned."""
    traced = tracer.active
    with tracer.span("ingest"):
        rec["summaries"] += sysobj.ingest(d, [pool.part(t, d) for t in range(pool.tenants)], mode)
    ns = [pool.n(t, d) for t in range(pool.tenants)]
    rec["values"] += sum(ns)
    rec["partitions"] += len(ns)
    rec["last_pid"] = d
    if traced:
        rec["trace_ns"] += ns


def _closed_loop(sysobj, pool, traffic, seconds, seed, tracer, rec):
    days, beta, publish = int(traffic["days"]), int(traffic["beta"]), traffic.get("publish")
    rng = np.random.default_rng([int(seed), 0xC105ED])
    d = int(traffic["fill"]["days"])
    steps = failed = 0
    start = time.perf_counter()
    rec["step_s"] = []
    while True:
        elapsed = time.perf_counter() - start
        if elapsed >= seconds:
            break
        if steps:
            rec["step_s"].append(elapsed - rec["step_at"])
        rec["step_at"] = elapsed
        tracer.turn(elapsed)
        traced = tracer.active
        try:
            _ingest(sysobj, pool, d, traffic["ingest"], tracer, rec)
            if publish:
                lo, hi = traffic_gen.draw(traffic_gen.WINDOWS, publish, rng, pool.tenants, days)
                wins = [(t, *_absolute(lo[t], hi[t], d, days)) for t in range(pool.tenants)]
                with tracer.span("query"):
                    out = _ask(sysobj, wins, beta)
                rec["answers"] += [(t, lo, hi, beta, b, s, eps) for (t, lo, hi), (b, s, eps) in zip(wins, out)]
                if traced:
                    rec["trace_batches"].append((wins, len(wins)))
        except Exception as exc:  # the program failed this step: counted, the window ends
            failed += 1
            rec["errors"].append(repr(exc))
            break
        steps += 1
        d += 1
    rec["elapsed"] = time.perf_counter() - start
    rec["attempted"], rec["failed"] = steps + failed, failed


def _open_loop(sysobj, pool, traffic, seconds, seed, tracer, rec):
    days, beta, feed = int(traffic["days"]), int(traffic["beta"]), traffic.get("ingest")
    sched = traffic_gen.open_schedule(traffic, pool.tenants, seconds, seed)
    due, first, R = sched.due, sched.first, sched.due.shape[0]
    lat = np.full(R, np.nan)
    check = set(sched.check.tolist())
    newest = int(traffic["fill"]["days"]) - 1
    req = list(zip(sched.tenant.tolist(), sched.lo.tolist(), sched.hi.tolist()))

    def windows(a: int, b: int) -> list:
        return [(t, *_absolute(lo, hi, newest, days)) for t, lo, hi in req[a:b]]

    fixed = None if feed else windows(0, len(req))  # with no ingest, made before the window
    every = float(feed["every_s"]) if feed else float("inf")
    next_feed, feeds = every, 0
    failed, i = 0, 0
    start = time.perf_counter()
    while i < R:
        now = time.perf_counter() - start
        tracer.turn(now)
        if now >= next_feed:  # a new partition id of every tenant, beside the requests
            feeds += 1
            next_feed += every
            try:
                _ingest(sysobj, pool, newest + 1, feed["mode"], tracer, rec)
                newest += 1
            except Exception as exc:  # the program failed the ingest: counted, no more are made
                failed += 1
                rec["errors"].append(repr(exc))
                next_feed = float("inf")
            continue
        j = int(np.searchsorted(due, now, side="right"))
        if j == i:  # nothing due: poll, as a server's receive loop does, so
            continue  # no request waits on the host's wake-up from a sleep
        a, b = int(first[i]), int(first[j])
        wins = fixed[a:b] if fixed is not None else windows(a, b)
        traced = tracer.active
        m0 = sysobj.counters()["cache_misses"] if traced else 0
        try:
            with tracer.span("query"):
                out = sysobj.query_many(wins, beta)
            if len(out) != len(wins):
                raise RuntimeError(f"{len(out)} answers to {len(wins)} windows")
        except Exception as exc:  # the program failed the batch: every request in it failed
            failed += j - i
            rec["errors"].append(repr(exc))
            i = j
            continue
        lat[i:j] = (time.perf_counter() - start) - due[i:j]
        for k in check.intersection(range(i, j)):
            for w in range(int(first[k]) - a, int(first[k + 1]) - a):
                rec["answers"].append((*wins[w], beta, *out[w]))
        if traced:
            rec["trace_batches"].append((sorted(set(wins)), sysobj.counters()["cache_misses"] - m0))
        i = j
    rec["elapsed"] = time.perf_counter() - start
    rec["attempted"], rec["failed"] = R + feeds, failed
    rec["requests"] = R - failed
    rec["latency_s"] = lat[~np.isnan(lat)]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def set_up(cfg: dict, traffic: dict, seed: int, device, control: bool = False, tracer: Tracer | None = None,
           root: str = ROOT):
    """Draw the pool, warm every call on a throwaway system, and fill the
    system under test as the traffic needs; returns ``(pool, system)``.
    An open loop's fill ends with one answer a tenant (all it holds), so
    that no first touch of a tenant lands in the window."""
    cuda = torch.device(device).type == "cuda"
    clock = time.perf_counter()
    System = system_class(cfg, control, root)  # the program is imported before any work
    if cuda:
        torch.cuda.init()
    log(f"set-up: program imported and device ready in {time.perf_counter() - clock:.3f} s")
    clock = time.perf_counter()
    pool = data.make_pool(cfg, seed, device)
    t_pool = time.perf_counter() - clock
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    clock = time.perf_counter()
    sysobj = System(cfg, device)
    sysobj.warm(pool, traffic)
    if tracer is not None:
        tracer.warm()
    t_warm = time.perf_counter() - clock
    fill = int(traffic["fill"]["days"])
    clock = time.perf_counter()
    for d in range(fill):
        sysobj.ingest(d, [pool.part(t, d) for t in range(pool.tenants)], traffic["fill"]["mode"])
    if traffic["loop"] == "open":
        sysobj.query_many([(t, 0, fill - 1) for t in range(pool.tenants)], int(traffic["beta"]))
    if cuda:
        torch.cuda.synchronize()
    # a server that has loaded its state collects once and freezes what
    # it holds, so that the collector's full passes in the window walk only
    # what the window makes, not the whole of set-up's objects
    gc.collect()
    gc.freeze()
    log(f"set-up: pool {t_pool:.3f} s, warm-up {t_warm:.3f} s, fill {time.perf_counter() - clock:.3f} s")
    return pool, sysobj


def run_cell(
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    device="cuda",
    control: bool = False,
    overrides: dict | None = None,
    t0: float | None = None,
    bench: dict | None = None,
    root: str = ROOT,
) -> dict:
    """One run of cell ``workload``: its result line as a dict, with the
    compared numbers under ``checks`` (last)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = load_bench(root) if bench is None else bench
    cell, cfg, traffic = cell_parts(bench, workload, root)
    limits = cell_limits(workload, root)
    for part, over in (overrides or {}).items():
        {"config": cfg, "traffic": traffic, "limits": limits}[part].update(over)
    if is_model(cfg, root):
        from hbench import serving

        return serving.run_cell(workload, seed, seconds, trace, cell=cell, cfg=cfg, traffic=traffic, limits=limits,
                                bench=bench, device=device, control=control, root=root, t0=t0)
    cuda = torch.device(device).type == "cuda"
    open_loop, beta = traffic["loop"] == "open", int(traffic["beta"])
    tracer = Tracer(trace and cuda, TRACE_START * seconds, min(TRACE_SECONDS, 0.3 * seconds))
    pool, sysobj = set_up(cfg, traffic, seed, device, control, tracer, root)
    c0 = sysobj.counters()
    rec = new_record()
    setup_s = time.perf_counter() - t0
    if open_loop:
        _open_loop(sysobj, pool, traffic, seconds, seed, tracer, rec)
    else:
        _closed_loop(sysobj, pool, traffic, seconds, seed, tracer, rec)
    tracer.stop()
    counters = _delta(sysobj.counters(), c0)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    retained = {}
    if rec["partitions"] and rec["failed"] == 0:
        # the window ingested: every tenant's retained partitions after it,
        # and the histogram of them all as the program answers it now
        last, keep = rec["last_pid"], int(cfg["retention_partitions"])
        first = max(0, last - keep + 1)
        retained = {t: sysobj.retained(t) for t in range(pool.tenants)}
        retained_ids = range(first, last + 1)
        month = [(t, first, last) for t in range(pool.tenants)]
        try:
            for (t, lo, hi), (b, s, eps) in zip(month, sysobj.query_many(month, beta), strict=True):
                rec["answers"].append((t, lo, hi, beta, b, s, eps))
        except Exception as exc:  # the program cannot answer for the state it kept
            rec["failed"] += 1
            rec["errors"].append(repr(exc))
    sysobj.close()
    tracer.finish()
    del sysobj
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    log(f"window: {rec['attempted']} attempted, {rec['failed']} failed, {rec['elapsed']:.3f} s")
    if rec.get("step_s"):
        q = np.percentile(rec["step_s"], [0, 50, 100])
        log(f"window: step s min {q[0]:.3f} median {q[1]:.3f} max {q[2]:.3f}")
    clock = time.perf_counter()
    checks = {}
    if rec["failed"] == 0:
        ref = Reference(pool, int(cfg["num_buckets"]), device)
        if retained:
            bad = ref.summary_mismatches(rec["summaries"])
            bad += sum(ref.retained_mismatches(t, retained_ids, got) for t, got in retained.items())
            checks["summary_mismatches"] = bad
        if rec["answers"]:
            off, ratio = ref.judge_answers(rec["answers"])
            checks["boundaries_off_leaves"] = off
            checks["bucket_err_over_eps"] = ratio
        del ref
        if cuda:
            torch.cuda.empty_cache()
    log(f"reference: {len(rec['summaries'])} summaries, {len(rec['answers'])} answers judged in {time.perf_counter() - clock:.3f} s")
    correct = (
        rec["failed"] == 0
        and rec["attempted"] > 0
        and checks.keys() == limits.keys()
        and all(v <= limits[k] for k, v in checks.items())
    )

    e2e = {"setup_s": setup_s}
    if open_loop and rec["latency_s"].size:
        e2e["answer_p50_ms"] = percentile_ms(rec["latency_s"], 50)
        e2e["answer_p95_ms"] = percentile_ms(rec["latency_s"], 95)
    if not open_loop and rec["elapsed"] > 0:
        e2e["ingest_values_per_s"] = rec["values"] / rec["elapsed"]
    run = None
    if trace:
        counters.update({k: rec[k] for k in ("partitions", "values", "requests")})
        run = {"config": cfg, "traffic": traffic, "counters": counters, "trace": None}
        if tracer.parsed:
            run["trace"] = {
                **tracer.parsed,
                "ingest_ns": rec["trace_ns"],
                "query_batches": rec["trace_batches"],
            }
    outcome = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"], "errors": rec["errors"]}
    return result_line(workload, cell, bench, root, tracer, run, e2e, outcome, peak, cuda, checks, limits)


def result_line(workload, cell, bench, root, tracer, run, e2e, outcome, peak, cuda, checks, limits) -> dict:
    """The result of a run: with a traced ``run`` (the readers' input) its
    per-layer metrics, else its end-to-end metrics ``e2e``; ``outcome``
    holds ``correct``, ``attempted``, ``failed`` and ``errors``."""
    metrics = {}
    if run is not None:
        for m in bench["per_layer"]:
            if applies(m, workload):
                value = load_module(part_path(root, "metrics", m["name"], ".py")).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, workload) and m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(outcome["correct"]), "attempted": int(outcome["attempted"]),
           "failed": int(outcome["failed"])}
    out["metrics"] = metrics
    out["device"] = dev
    if run is not None and tracer.parsed:
        lo, hi = tracer.parsed["stretch"]
        dev["busy_s"] = tracer.parsed["busy_us"] * 1e-6
        dev["window_s"] = (hi - lo) * 1e-6
        out["breakdown"] = tracer.parsed["breakdown"]
        out["lost_launches"] = tracer.parsed["lost"]
    if outcome["errors"]:
        out["errors"] = outcome["errors"][:3]
    out["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()}
    return out
