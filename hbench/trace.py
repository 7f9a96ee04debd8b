"""The device trace of a short steady stretch of the window.

``torch.profiler`` (CPU and CUDA activities) records the stretch; its
Chrome trace is read back into device intervals, each tagged with the
harness span (``hbench.<name>``) inside which the host launched it, and
with the innermost program span (a ``record_function`` span of the
program, such as ``core/spans.py``'s ``store.sort``) open on the
launching thread at the launch.  Busy
time is the **union** of the kernel, copy and memset intervals, so a copy
that overlaps a kernel counts once.  A launch with no device record is
counted as lost: a trace opened on an idle card can drop records, which
is why set-up makes one throwaway trace first.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
STRETCH = "hbench.stretch"


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]`` (any unit)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _innermost(intervals):
    """``at(t)``: the name of the latest-starting of ``intervals``
    ``[(start, end, name)]`` around ``t``, or ``None``.  The intervals nest,
    as one thread's host spans and ops do, so that one is the innermost."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))  # of two that start together, the outer first
    starts = [iv[0] for iv in ivs]
    reach, last = [], float("-inf")  # reach[k]: the latest end among ivs[:k + 1]
    for iv in ivs:
        last = max(last, iv[1])
        reach.append(last)

    def at(t: float):
        k = bisect.bisect_right(starts, t) - 1
        while k >= 0 and reach[k] >= t:
            if ivs[k][1] >= t:
                return ivs[k][2]
            k -= 1
        return None

    return at


def parse(trace: dict) -> dict:
    """The parts of a Chrome trace the readers use (times in µs):
    ``stretch`` ``(start, end)``, ``spans`` ``[(start, end, name)]`` of the
    harness's spans, ``device`` ``[(name, cat, start, end,
    span)]``, ``program_spans`` (for each ``device`` interval, in its
    order, the innermost program span open on the launching thread when it
    was launched, or ``None``), ``busy_us``, ``lost`` launches, and the
    ``breakdown``."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    stretch = next((e for e in evs if e.get("name") == STRETCH and e.get("cat") == "user_annotation"), None)
    if stretch is None:
        return {}
    lo, hi = float(stretch["ts"]), float(stretch["ts"]) + float(stretch["dur"])
    main = stretch.get("tid")
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in evs
        if e.get("cat") == "user_annotation" and e["name"].startswith("hbench.") and e["name"] != STRETCH
    )
    starts = [s[0] for s in spans]

    def span_at(t: float):
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= t else None

    by_thread: dict = {}  # (pid, tid) -> that thread's program spans
    for e in evs:
        if e.get("cat") == "user_annotation" and not e["name"].startswith("hbench."):
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    program_at = {k: _innermost(v) for k, v in by_thread.items()}

    def program_span(launch: dict):
        at = program_at.get((launch.get("pid"), launch.get("tid")))
        return at(float(launch["ts"])) if at else None

    launches = {}
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
    device, program, seen = [], [], set()
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if end <= lo or s >= hi:
            continue
        corr = e.get("args", {}).get("correlation")
        seen.add(corr)
        launch = launches.get(corr)
        device.append((e["name"], e["cat"], s, end, span_at(float(launch["ts"])) if launch else None))
        program.append(program_span(launch) if launch else None)
    lost = sum(
        1
        for c, e in launches.items()
        if e["name"].startswith(LAUNCH_APIS) and c not in seen and lo <= float(e["ts"]) <= hi
    )
    intervals = [(s, e) for _, _, s, e, _ in device]
    busy = union_seconds(intervals, lo, hi)
    by_name: dict[str, float] = {}
    for name, _, s, e, _ in device:
        by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo))
    innermost_op = _innermost(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in evs
        if e.get("tid") == main and e.get("cat") in ("cpu_op", "user_annotation") and not e["name"].startswith("hbench.")
    )

    labelled: dict[str, float] = {}
    for s, e in sorted(gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:200]:
        mid = 0.5 * (s + e)
        span = span_at(mid) or "between spans"
        op = innermost_op(mid)
        label = f"{span} > {op}" if op else f"{span} (python)"
        labelled[label] = max(labelled.get(label, 0.0), e - s)
    top = lambda d: [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "stretch": (lo, hi),
        "spans": spans,
        "device": device,
        "program_spans": program,
        "busy_us": busy,
        "lost": lost,
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(labelled)},
    }


class Tracer:
    """Profiles one stretch of the window, between two turns of the loop."""

    def __init__(self, enabled: bool, start_s: float, length_s: float):
        self.enabled, self.start_s, self.length_s = enabled, start_s, length_s
        self.prof = None
        self.stretch = None
        self.done = False
        self.parsed: dict = {}

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def warm(self) -> None:
        """A throwaway trace of a few kernels, so the real one finds the
        profiler's device side awake."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            w = torch.zeros(1024, device="cuda")
            for _ in range(8):
                w.add_(1)
            torch.cuda.synchronize()

    def turn(self, elapsed: float) -> None:
        """Called between two turns with the window's elapsed seconds."""
        if not self.enabled or self.done:
            return
        if self.prof is None and elapsed >= self.start_s:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.began = elapsed
            self.stretch = torch.profiler.record_function(STRETCH)
            self.stretch.__enter__()
        elif self.active and elapsed >= self.began + self.length_s:
            self.stop()

    def stop(self) -> None:
        """Ends the stretch; the trace is read later, by :meth:`finish`."""
        if self.prof is None or self.done:
            return
        import torch

        torch.cuda.synchronize()
        self.stretch.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def finish(self) -> None:
        """Reads the stretch's trace, once the window has closed."""
        if self.prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.parsed = parse(json.load(f))
        finally:
            os.unlink(path)
        self.prof = None

    def span(self, name: str):
        """A named host span around one call, while the stretch is traced."""
        if not self.active:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"hbench.{name}")
