"""The port's sharding rules (``repro_torch.sharding.Rules``),
``data.shard_batch`` and the data-parallel train step — the port's mirror
of ``tests/test_sharding_rules.py`` and of ``tests/test_distributed.py``'s
``test_sharded_train_step_runs_and_matches_single_device``.

``Rules`` reads only the mesh's axis names and sizes, so the reference
gets a JAX ``AbstractMesh`` and the port a stand-in with a
``DeviceMesh``'s ``mesh_dim_names``, ``shape``, ``size`` and
``get_local_rank``: the tables and every mapped spec must be equal.

The data-parallel step runs on 8 gloo ranks (a (4, 2) ``("data",
"model")`` mesh, each rank its own subprocess with a ``file://``
rendezvous, every process joined with a timeout), from the reference's
parameters (carried in an npz).  Tolerance: every rank's loss and
parameters equal rank 0's bit for bit (the step all-reduces the
gradients, so every rank applies the same update); the loss within 1e-5
of the single-process port's on the whole batch (the mean of four shards'
means against one mean), the parameters within ``lr`` of it (AdamW's
first step moves an entry by ``lr · g / (|g| + eps)``, which the
gradients' last-bit gap can flip where |g| is near eps); the loss within
the reference test's 5e-2 of the reference's single-device step.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as RC
import repro.models as RM
import repro.optim as RO
import repro_torch.configs as PC
from repro.sharding import Rules as RRules
from repro.train import make_opt_state as ref_opt_state, make_train_step as ref_train_step
from repro_torch.convert import params_from_reference
from repro_torch.data import shard_batch
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding import Rules
from repro_torch.train import make_opt_state, make_train_step
from repro_torch.tree import flatten_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
TIMEOUT_S = 240
KINDS = ("train", "prefill", "decode", "decode_long")


def fake_mesh(shape=(16, 16), axes=("data", "model")):
    try:  # jax ≥ 0.5: AbstractMesh(shape, axis_names)
        return jax.sharding.AbstractMesh(shape, axes)
    except TypeError:  # jax 0.4.x: AbstractMesh(((name, size), ...))
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))


class FakeMesh:
    """A DeviceMesh's coordinates without a process group."""

    def __init__(self, shape, axes, coords):
        self.shape, self.mesh_dim_names, self._coords = tuple(shape), tuple(axes), dict(zip(axes, coords))

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_local_rank(self, axis: str) -> int:
        return self._coords[axis]


def port_mesh(shape=(16, 16), axes=("data", "model")):
    return FakeMesh(shape, axes, (0,) * len(axes))


def both(arch, kind, seq_len, shape=(16, 16), axes=("data", "model")):
    return (RRules(RC.get_config(arch), fake_mesh(shape, axes), kind, seq_len=seq_len),
            Rules(PC.get_config(arch), port_mesh(shape, axes), kind, seq_len=seq_len))


# every case of tests/test_sharding_rules.py: (arch, mesh shape, axes, kind, seq_len, logical specs)
CASES = {
    "train_rules_dense": ("qwen3-8b", (16, 16), ("data", "model"), "train", 4096, [
        ("vocab", "embed"), ("embed", "mlp"), ("layers", "embed", "heads", None), ("embed", "kv_heads", None),
        ("act_batch", "act_seq", None)]),
    "multi_pod_batch_axes": ("deepseek-7b", (2, 16, 16), ("pod", "data", "model"), "train", 4096, [
        ("act_batch", None), ("embed", "mlp")]),
    "smollm_attention_replication_fallback": ("smollm-135m", (16, 16), ("data", "model"), "train", 4096, [
        ("embed", "heads", None), ("embed", "mlp")]),
    "decode_kv_seq_sharding": ("qwen3-8b", (16, 16), ("data", "model"), "decode", 32768, [
        ("batch_kv", "kv_seq", "kv_heads_cache", None), ("act_batch", "act_seq", None)]),
    "long_context_rules": ("jamba-v0.1-52b", (16, 16), ("data", "model"), "decode_long", 524288, [
        ("batch_kv", "kv_seq", "kv_heads_cache", None)]),
    "prefill_kv_seq_now_sharded": ("deepseek-7b", (16, 16), ("data", "model"), "prefill", 32768, [
        ("batch_kv", "kv_seq", "kv_heads_cache", None)]),
    "expert_sharding_dbrx": ("dbrx-132b", (16, 16), ("data", "model"), "train", 4096, [
        ("experts", "embed", "expert_mlp")]),
    "expert_sharding_llama4": ("llama4-maverick-400b-a17b", (16, 16), ("data", "model"), "train", 4096, [
        ("experts", "embed", "expert_mlp")]),
    "seq_parallel_divisibility_guard": ("qwen3-8b", (16, 16), ("data", "model"), "train", 100, [
        ("act_batch", "act_seq", None)]),
    "vocab_padding_whisper": ("whisper-medium", (16, 16), ("data", "model"), "train", 4096, [
        ("vocab", "embed")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rules_equal_the_reference_on_its_cases(case):
    arch, shape, axes, kind, seq_len, specs = CASES[case]
    ref, port = both(arch, kind, seq_len, shape, axes)
    assert port.table == ref.table
    for logical in specs:
        got = port(logical)
        assert isinstance(got, tuple) and len(got) == len(logical)
        assert ref(logical) == P(*got), (logical, got, ref(logical))
    assert port.degradations() == ref.degradations()


@pytest.mark.parametrize("mesh", [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
                                  ((4, 2), ("data", "model")), ((8,), ("data",)), ((1, 1), ("data", "model"))])
def test_rules_tables_equal_the_reference_for_every_arch_and_kind(mesh):
    shape, axes = mesh
    for arch in RC.list_archs():
        for kind in KINDS:
            for seq_len in (100, 4096):
                ref, port = both(arch, kind, seq_len, shape, axes)
                assert port.table == ref.table, (arch, kind, seq_len)
                assert port.degradations() == ref.degradations(), (arch, kind)
    _, port = both("smollm-135m", "train", 4096)
    assert any("heads" in d for d in port.degradations())


def test_placements_follow_the_specs():
    from torch.distributed.tensor import Replicate, Shard

    _, port = both("qwen3-8b", "train", 4096)
    assert port.placements(("vocab", "embed")) == [Shard(1), Shard(0)]  # data → dim 1, model → dim 0
    assert port.placements(("embed", "kv_heads", None)) == [Shard(0), Replicate()]
    assert port.placements(("act_batch", "act_seq", None)) == [Shard(0), Shard(1)]
    _, pods = both("qwen3-8b", "train", 4096, (2, 16, 16), ("pod", "data", "model"))
    assert pods.placements(("act_batch", None)) == [Shard(0), Shard(0), Replicate()]
    _, long = both("jamba-v0.1-52b", "decode_long", 524288)
    assert long.placements(("batch_kv", "kv_seq", "kv_heads_cache", None)) == [Shard(1), Shard(1)]


def test_shard_batch_splits_the_leading_dim_over_act_batch():
    batch = {"tokens": np.arange(16 * 3, dtype=np.int32).reshape(16, 3),
             "mask": np.ones((16, 3), np.float32)}
    cfg = PC.get_config("qwen3-8b")
    got = {}
    for d in range(4):
        for m in range(2):
            mesh = FakeMesh((4, 2), ("data", "model"), (d, m))
            got[d, m] = shard_batch(batch, Rules(cfg, mesh, "train", seq_len=3), mesh, device="cpu")
    for (d, m), b in got.items():
        assert b["tokens"].dtype == torch.int32 and b["tokens"].device.type == "cpu"
        assert np.array_equal(b["tokens"].numpy(), batch["tokens"][4 * d:4 * d + 4])  # the model axis replicates
    pods = FakeMesh((2, 2, 2), ("pod", "data", "model"), (1, 0, 1))
    b = shard_batch(batch, Rules(cfg, pods, "train", seq_len=3), pods, device="cpu")
    assert np.array_equal(b["tokens"].numpy(), batch["tokens"][8:12])  # row-major over (pod, data)
    whole = shard_batch(batch, device="cpu")
    assert np.array_equal(whole["tokens"].numpy(), batch["tokens"])
    with pytest.raises(ValueError):
        shard_batch({"tokens": batch["tokens"][:6]}, Rules(cfg, pods, "train", seq_len=3), pods, device="cpu")


# one rank of the data-parallel step: argv = inputs, output prefix, rendezvous file, rank
PORT_RANK = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist

inp_path, out_prefix, init_file, rank = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + init_file, rank=rank, world_size=%(world)d)
from repro_torch.configs import get_config, smoke
from repro_torch.data import shard_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_model
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding import Rules
from repro_torch.train import make_opt_state, make_train_step
from repro_torch.tree import flatten_with_path, unflatten

inp = dict(np.load(inp_path))
cfg = smoke(get_config("qwen3-8b"))
template = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
params = unflatten(template, [torch.from_numpy(inp["p" + name]) for name, _ in flatten_with_path(template)])
mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu")
rules = Rules(cfg, mesh, "train", seq_len=32)
batch = shard_batch({k: inp[k] for k in ("tokens", "targets", "mask")}, rules, mesh, device="cpu")
assert batch["tokens"].shape == (2, 32)
step = make_train_step(cfg, OptimizerConfig(), rules, mesh=mesh)
p2, o2, m = step(params, make_opt_state(params, OptimizerConfig()), batch)
out = {"loss": m["loss"].numpy(), "grad_norm": m["grad_norm"].numpy()}
out.update({"p" + name: t.numpy() for name, t in flatten_with_path(p2)})
np.savez(out_prefix + str(rank) + ".npz", **out)
dist.destroy_process_group()
''' % {"world": WORLD}


def _finish(procs: dict, timeout: float) -> dict:
    """Wait for every process (killing all of them at the timeout)."""
    out = {}
    try:
        for name, p in procs.items():
            text, _ = p.communicate(timeout=timeout)
            out[name] = (p.returncode, text)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_data_parallel_step_on_8_gloo_ranks_matches_one_process_and_the_reference(tmp_path):
    rc, pc = RC.smoke(RC.get_config("qwen3-8b")), PC.smoke(PC.get_config("qwen3-8b"))
    rp, _ = RM.init_model(rc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {
        "tokens": rng.integers(0, rc.vocab_size, (8, 32)).astype(np.int32),
        "targets": rng.integers(0, rc.vocab_size, (8, 32)).astype(np.int32),
        "mask": np.ones((8, 32), np.float32),
    }
    host = jax.tree.map(np.asarray, rp)
    inp = {"p" + jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(host)[0]}
    np.savez(tmp_path / "inputs.npz", **inp, **batch)
    (tmp_path / "rank.py").write_text(PORT_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = {f"rank{r}": subprocess.Popen(
        [sys.executable, str(tmp_path / "rank.py"), str(tmp_path / "inputs.npz"), str(tmp_path / "rank"),
         str(tmp_path / "rendezvous"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)}

    # meanwhile: the single-process port and the reference on the whole batch
    pp = params_from_reference(host, device="cpu")
    one_p, _, one_m = make_train_step(pc, OptimizerConfig())(pp, make_opt_state(pp, OptimizerConfig()), batch)
    _, _, ref_m = jax.jit(ref_train_step(rc, RO.OptimizerConfig()))(
        rp, ref_opt_state(rp, RO.OptimizerConfig()), {k: jnp.asarray(v) for k, v in batch.items()})

    for name, (rc_, text) in _finish(procs, TIMEOUT_S).items():
        assert rc_ == 0, f"{name} exited {rc_}:\n{text[-4000:]}"
    ranks = []
    for r in range(WORLD):
        with np.load(tmp_path / f"rank{r}.npz") as f:
            ranks.append(dict(f))
    for r in range(1, WORLD):
        for k, v in ranks[0].items():
            assert ranks[r][k].tobytes() == v.tobytes(), (r, k)
    loss = float(ranks[0]["loss"])
    assert abs(loss - float(one_m["loss"])) <= 1e-5, (loss, float(one_m["loss"]))
    assert abs(loss - float(ref_m["loss"])) < 5e-2, (loss, float(ref_m["loss"]))
    np.testing.assert_allclose(float(ranks[0]["grad_norm"]), float(one_m["grad_norm"]), rtol=1e-5)
    lr = float(one_m["lr"])
    for name, t in flatten_with_path(one_p):
        assert np.abs(ranks[0]["p" + name] - t.numpy()).max() <= lr, name
