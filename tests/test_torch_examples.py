"""The port's examples (``repro_torch.examples``) against the reference's
``examples/`` on the CPU, each at its smoke size.

Each example's ``main`` runs in this process with ``device="cpu"`` and the
reference's script in a subprocess; the port must print the reference's
lines, in order, with the reference's numbers.  The quickstart's output is
equal to the reference's character for character (the worked example's
numbers, the merged histogram's error and its p95 are bit-equal).  The
other three draw their data the same way from the same seeds, so every
count and every histogram's number is held equal too; only each example's
``CLOCK_FIELDS`` (wall-clock times, the async ingest's mid-flight
snapshot) are masked, and its ``MODEL_FIELDS`` (the calibrated clip, the
training loss and gradient norm: the port draws its parameters from a
``torch.Generator``, not from JAX's keys).  The one wording the port
changes (log analytics' Summarizer runs the port's tile-sort kernels, not
a Pallas path) is listed in ``RENAMED``.
"""
import contextlib
import io
import os
import subprocess
import sys

import pytest

from repro_torch.examples import log_analytics, quickstart, serve_calibrated, split_fields, train_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENAMED = {"Pallas tile-sort path": "tile-sort kernels"}


def _masked(text: str, example) -> list[str]:
    for old, new in RENAMED.items():
        text = text.replace(old, new)
    return split_fields(text, example.CLOCK_FIELDS + example.MODEL_FIELDS)[0].splitlines()


def _reference(script: str, *args: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # one host device, whatever an earlier test file of this worker set
    return subprocess.Popen([sys.executable, os.path.join(REPO, "examples", script), *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 900) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return out


def _port(fn, *args, **kwargs) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


def test_quickstart_prints_the_references_numbers():
    ref = _reference("quickstart.py")
    out = _port(quickstart.main, device="cpu")
    assert out == _finish(ref)
    assert "H* (vectorized): [ 2.  7. 18. 30.] [9. 9. 9.]" in out and out.endswith("quickstart OK\n")


def test_log_analytics_smoke_prints_the_references_lines(tmp_path, monkeypatch):
    ref = _reference("log_analytics.py", "--smoke")
    monkeypatch.chdir(tmp_path)
    out = _port(log_analytics.main, True, device="cpu")
    assert _masked(out, log_analytics) == _masked(_finish(ref), log_analytics)
    assert out.endswith("log_analytics OK\n")


def test_serve_calibrated_prints_the_references_lines():
    ref = _reference("serve_calibrated.py")
    out = _port(serve_calibrated.main, device="cpu")
    assert _masked(out, serve_calibrated) == _masked(_finish(ref), serve_calibrated)
    assert "rank error bound: ±128 of 32,768 calibration values (0.39%)" in out


def test_train_lm_prints_the_references_lines(tmp_path):
    args = ["--steps", "2", "--compress", "--ckpt-dir"]
    ref = _reference("train_lm.py", *args, str(tmp_path / "ref"))
    out = _port(train_lm.main, [*args, str(tmp_path / "port"), "--device", "cpu"])
    want = _masked(_finish(ref), train_lm)
    assert _masked(out, train_lm) == want + ["train_lm OK"]
    assert os.listdir(tmp_path / "port")  # the final checkpoint


@pytest.mark.parametrize("main", [quickstart.main, serve_calibrated.main], ids=["quickstart", "serve_calibrated"])
def test_examples_run_on_the_card_unless_asked_for_the_cpu(main, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _port(main)
