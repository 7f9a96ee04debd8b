"""The port's checkpoints (``repro_torch.checkpoint``) — the port's mirror
of ``tests/test_checkpoint.py`` and of the checkpoint failpoint case of
``tests/test_failpoint_sites.py``, plus the shared on-disk format: a
checkpoint written by either package restores in the other.

Tolerance: bit-equal everywhere (float32 round trips, bfloat16 through its
float32 container, int32 steps).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint import restore_checkpoint as ref_restore, save_checkpoint as ref_save
from repro_torch.checkpoint import gc_checkpoints, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core import failpoints as faults
from repro_torch.tree import flatten_with_path

CPU = torch.device("cpu")


def tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16)},
    }


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    t = tree()
    save_checkpoint(d, 7, t, {"m": t, "step": torch.tensor(7, dtype=torch.int32)})
    assert latest_step(d) == 7
    p, o, step = restore_checkpoint(d, None, t, {"m": t, "step": torch.tensor(0, dtype=torch.int32)})
    assert step == 7
    assert torch.equal(p["a"], t["a"])
    assert p["nested"]["b"].dtype == torch.bfloat16 and torch.equal(p["nested"]["b"], t["nested"]["b"])
    assert int(o["step"]) == 7 and o["step"].dtype == torch.int32
    with open(os.path.join(d, "step_00000007", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 7 and manifest["extra"] == {}
    assert manifest["keys"] == sorted(["p|['a']", "p|['nested']['b']", "o|['m']['a']", "o|['m']['nested']['b']",
                                       "o|['step']"])


def test_latest_pointer_advances(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, tree())
    save_checkpoint(d, 5, tree())
    assert latest_step(d) == 5


def test_gc_keeps_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, tree())
    gc_checkpoints(d, keep=2)
    remaining = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert remaining == ["step_00000004", "step_00000005"]
    assert latest_step(d) == 5


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), None, tree())


def test_overwrite_same_step(tmp_path):
    d = str(tmp_path)
    t = tree()
    save_checkpoint(d, 2, t)
    save_checkpoint(d, 2, {"a": t["a"] * 2, "nested": t["nested"]})
    p, _, _ = restore_checkpoint(d, 2, t)
    assert torch.equal(p["a"], t["a"] * 2)


def test_restore_places_on_the_template_device_or_the_one_asked(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"w": np.arange(6, dtype=np.float32)})
    p, _, _ = restore_checkpoint(d, None, {"w": torch.zeros(6)})
    assert p["w"].device == CPU and torch.equal(p["w"], torch.arange(6, dtype=torch.float32))
    p, _, _ = restore_checkpoint(d, None, {"w": np.zeros(6, np.float32)}, device="cpu")
    assert isinstance(p["w"], torch.Tensor) and p["w"].device == CPU
    if not torch.cuda.is_available():  # a leaf with no device of its own goes to the card by default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore_checkpoint(d, None, {"w": np.zeros(6, np.float32)})


def test_save_fsync_discipline(tmp_path, monkeypatch):
    """The arrays payload and the manifest are fsynced BEFORE the
    step-directory rename, the checkpoint dir AFTER each publish rename
    (step dir and LATEST pointer), and the LATEST payload before its own
    rename — the reference's contract."""
    events = []
    real_fsync, real_replace = os.fsync, os.replace

    def recording_fsync(fd):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            target = "?"
        kind = "dir" if os.path.isdir(target) else os.path.basename(target)
        events.append(("fsync", kind))
        return real_fsync(fd)

    def recording_replace(src, dst):
        events.append(("replace", os.path.basename(dst)))
        return real_replace(src, dst)

    monkeypatch.setattr(os, "fsync", recording_fsync)
    monkeypatch.setattr(os, "replace", recording_replace)

    d = str(tmp_path)
    save_checkpoint(d, 3, tree())

    step_pub = events.index(("replace", "step_00000003"))
    latest_pub = events.index(("replace", "LATEST"))
    before_step = [k for op, k in events[:step_pub] if op == "fsync"]
    assert "arrays.npz" in before_step, events
    assert "manifest.json" in before_step, events
    assert ("fsync", "dir") in events[step_pub:latest_pub], events
    assert ("fsync", "dir") in events[latest_pub:], events
    latest_fsyncs = [k for op, k in events[step_pub:latest_pub] if op == "fsync"]
    assert any(k != "dir" for k in latest_fsyncs), events
    assert latest_step(d) == 3


def test_checkpoint_save_and_restore_faultable(tmp_path):
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    ckpt = str(tmp_path / "ckpt")
    with faults.inject("checkpoint.save"):
        with pytest.raises(faults.FaultError):
            save_checkpoint(ckpt, 1, params)
    assert latest_step(ckpt) is None and not os.path.exists(ckpt)  # the fault fires before any write
    save_checkpoint(ckpt, 1, params)
    with faults.inject("checkpoint.restore"):
        with pytest.raises(faults.FaultError):
            restore_checkpoint(ckpt, None, params)
    got, _opt, step = restore_checkpoint(ckpt, None, params)
    assert step == 1 and torch.equal(got["w"], params["w"])


@pytest.fixture
def gloo_world_1(tmp_path):
    """A gloo process group of one rank (a FileStore rendezvous)."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_elastic_restore_resharded(tmp_path, gloo_world_1):
    """Save unsharded, restore onto a (1, 1) mesh as DTensors — elastic;
    a DTensor saves whole, so the restored checkpoint saves again."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_host_mesh

    d = str(tmp_path / "ckpt")
    t = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4), "b": torch.ones(4, dtype=torch.bfloat16)}
    save_checkpoint(d, 3, t)
    mesh = make_host_mesh("cpu")
    sh = {"w": (mesh, [Shard(0), Replicate()]), "b": (mesh, [Replicate(), Replicate()])}
    p, _, step = restore_checkpoint(d, None, t, shardings=sh)
    assert step == 3 and isinstance(p["w"], DTensor) and p["w"].placements == (Shard(0), Replicate())
    assert torch.equal(p["w"].full_tensor(), t["w"]) and p["b"].dtype == torch.bfloat16
    save_checkpoint(d, 4, p)
    again, _, _ = restore_checkpoint(d, 4, t)
    assert torch.equal(again["w"], t["w"]) and torch.equal(again["b"], t["b"])
    with pytest.raises(ValueError):
        restore_checkpoint(d, 3, t, shardings={"w": sh["w"]})


def ref_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.normal(size=(8, 4)).astype(np.float32),
        "blocks": [{"w": rng.normal(size=(2, 4, 4)).astype(np.float32),
                    "g": rng.normal(size=(2, 4)).astype(jnp.bfloat16)}],
        "final_norm": {"g": rng.normal(size=(4,)).astype(np.float32)},
    }


def test_the_reference_restores_a_port_checkpoint_and_back(tmp_path):
    """One on-disk format: each package restores the other's checkpoint bit
    for bit, parameters and optimizer state (bfloat16 leaves included)."""
    host = ref_tree(0)
    opt = {"m": ref_tree(1), "v": ref_tree(2), "step": np.int32(5)}
    port = lambda t: jax.tree.map(  # noqa: E731
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a)), t)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_save(d_ref, 5, jax.tree.map(jnp.asarray, host), jax.tree.map(jnp.asarray, opt))
    save_checkpoint(d_port, 5, port(host), port(opt))
    with np.load(os.path.join(d_ref, "step_00000005", "arrays.npz")) as a, \
            np.load(os.path.join(d_port, "step_00000005", "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    zeros = lambda t: jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, t))  # noqa: E731
    rp, ro, rstep = ref_restore(d_port, None, zeros(host), zeros(opt))
    pp, po, pstep = restore_checkpoint(d_ref, None, port(zeros(host)), port(zeros(opt)))
    assert rstep == pstep == 5
    for (name, got), want, back in zip(flatten_with_path({"p": pp, "o": po}), jax.tree.leaves(
            {"p": host, "o": opt}), jax.tree.leaves({"p": rp, "o": ro})):
        want = np.asarray(want)
        assert np.array_equal(np.asarray(back), want) and np.asarray(back).dtype == want.dtype, name
        g = got.to(torch.float32).numpy() if got.dtype == torch.bfloat16 else got.numpy()
        assert np.array_equal(g, np.asarray(want, np.float32) if want.dtype == jnp.bfloat16 else want), name
        assert (got.dtype == torch.bfloat16) == (want.dtype == jnp.bfloat16), name
