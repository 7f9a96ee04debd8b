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
parameters (carried in an npz), in five cases: qwen3-8b's smoke config
with an all-ones mask; with a ragged mask (row 1 zero past position 4,
so the ranks' mask counts differ), without and with ``grad_accum=2``;
and dbrx-132b's smoke config (MoE: the load balance is a product of two
batch means) with the ragged mask, without and with ``grad_accum=2``.
Tolerance: every rank's loss and parameters equal rank 0's bit for bit
(the step all-reduces the gradients, so every rank applies the same
update); the loss and ``grad_norm`` within rel 1e-5 of the reference's
single-device step on the whole batch, and the ranks' gradient shares
summed (``make_grad_fn`` on the mesh) within the float32 tolerance
``atol=5e-5, rtol=1e-5`` of the reference's gradient of the whole batch;
in the all-ones case also the loss within 1e-5 of the single-process
port's, the parameters within ``lr`` of it (AdamW's first step moves an
entry by ``lr · g / (|g| + eps)``, which the gradients' last-bit gap can
flip where |g| is near eps).
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
from repro_torch.train import make_grad_fn, make_opt_state, make_train_step
from repro_torch.tree import flatten_with_path, leaves, unflatten

inp = dict(np.load(inp_path))
mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu")
out = {}
for case, (arch, accum) in %(cases)r.items():
    cfg = smoke(get_config(arch))
    template = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = unflatten(template, [torch.from_numpy(inp[arch + ":p" + name]) for name, _ in flatten_with_path(template)])
    rules = Rules(cfg, mesh, "train", seq_len=32)
    whole = {k: inp[case + ":" + k] for k in ("tokens", "targets", "mask")}
    if accum > 1:
        micro = [shard_batch({k: v[i] for k, v in whole.items()}, rules, mesh, device="cpu") for i in range(accum)]
        batch = {k: torch.stack([m[k] for m in micro]) for k in whole}
    else:
        micro = [shard_batch(whole, rules, mesh, device="cpu")]
        batch = micro[0]
    assert micro[0]["tokens"].shape == (2, 32)
    opt = OptimizerConfig(grad_accum=accum)
    p2, _, m = make_train_step(cfg, opt, rules, mesh=mesh)(params, make_opt_state(params, opt), batch)
    out[case + ":loss"], out[case + ":grad_norm"] = m["loss"].numpy(), m["grad_norm"].numpy()
    if case == "ones":
        out.update({case + ":p" + name: t.numpy() for name, t in flatten_with_path(p2)})
    # the ranks' gradient shares, summed over the data axis: the whole batch's gradient
    grad_fn = make_grad_fn(cfg, rules, mesh)
    shares = [leaves(grad_fn(params, mb)[1]) for mb in micro]
    for (name, _), *gs in zip(flatten_with_path(params), *shares):
        g = sum(gs) / accum
        dist.all_reduce(g, group=mesh.get_group("data"))
        out[case + ":g" + name] = g.numpy()
np.savez(out_prefix + str(rank) + ".npz", **out)
dist.destroy_process_group()
'''

# case → (arch, grad_accum); the cases but "ones" mask row 1 past position 4
DP_CASES = {"ones": ("qwen3-8b", 1), "ragged": ("qwen3-8b", 1), "ragged_accum": ("qwen3-8b", 2),
            "moe_ragged": ("dbrx-132b", 1), "moe_ragged_accum": ("dbrx-132b", 2)}


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


def dp_batch(rc, case: str, accum: int) -> dict:
    rng = np.random.default_rng(0)
    shape = (accum, 8, 32) if accum > 1 else (8, 32)
    mask = np.ones(shape, np.float32)
    if case != "ones":
        mask[..., 1, 5:] = 0.0  # ROADMAP Queue 3 fault A's probe: row 1 of each microbatch
    return {
        "tokens": rng.integers(0, rc.vocab_size, shape).astype(np.int32),
        "targets": rng.integers(0, rc.vocab_size, shape).astype(np.int32),
        "mask": mask,
    }


def ref_whole_batch(rc, rp, batch: dict, accum: int):
    """The reference's single-device step metrics and its gradient of the
    whole batch (the mean over microbatches), float32."""
    opt = RO.OptimizerConfig(grad_accum=accum)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, _, m = jax.jit(ref_train_step(rc, opt))(rp, ref_opt_state(rp, opt), jb)
    grad = jax.jit(jax.grad(lambda p, b: RM.loss_fn(rc, p, b)[0]))
    micro = [{k: v[i] for k, v in jb.items()} for i in range(accum)] if accum > 1 else [jb]
    gs = [jax.tree.leaves(grad(rp, mb)) for mb in micro]
    return m, [sum(np.asarray(g[i]) for g in gs) / accum for i in range(len(gs[0]))]


def test_data_parallel_step_on_8_gloo_ranks_matches_one_process_and_the_reference(tmp_path):
    inp, ref_params, batches = {}, {}, {}
    for arch in sorted({a for a, _ in DP_CASES.values()}):
        rp, _ = RM.init_model(RC.smoke(RC.get_config(arch)), jax.random.PRNGKey(0))
        ref_params[arch] = rp
        host = jax.tree.map(np.asarray, rp)
        inp.update({arch + ":p" + jax.tree_util.keystr(k): v
                    for k, v in jax.tree_util.tree_flatten_with_path(host)[0]})
    for case, (arch, accum) in DP_CASES.items():
        batches[case] = dp_batch(RC.smoke(RC.get_config(arch)), case, accum)
        inp.update({case + ":" + k: v for k, v in batches[case].items()})
    np.savez(tmp_path / "inputs.npz", **inp)
    (tmp_path / "rank.py").write_text(PORT_RANK % {"world": WORLD, "cases": DP_CASES})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = {f"rank{r}": subprocess.Popen(
        [sys.executable, str(tmp_path / "rank.py"), str(tmp_path / "inputs.npz"), str(tmp_path / "rank"),
         str(tmp_path / "rendezvous"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)}

    # meanwhile: the single-process port and the reference on the whole batch
    rc, pc = RC.smoke(RC.get_config("qwen3-8b")), PC.smoke(PC.get_config("qwen3-8b"))
    pp = params_from_reference(jax.tree.map(np.asarray, ref_params["qwen3-8b"]), device="cpu")
    one_p, _, one_m = make_train_step(pc, OptimizerConfig())(pp, make_opt_state(pp, OptimizerConfig()),
                                                             batches["ones"])
    ref = {case: ref_whole_batch(RC.smoke(RC.get_config(arch)), ref_params[arch], batches[case], accum)
           for case, (arch, accum) in DP_CASES.items()}

    for name, (rc_, text) in _finish(procs, TIMEOUT_S).items():
        assert rc_ == 0, f"{name} exited {rc_}:\n{text[-4000:]}"
    ranks = []
    for r in range(WORLD):
        with np.load(tmp_path / f"rank{r}.npz") as f:
            ranks.append(dict(f))
    for r in range(1, WORLD):
        for k, v in ranks[0].items():
            assert ranks[r][k].tobytes() == v.tobytes(), (r, k)
    got = ranks[0]
    for case in DP_CASES:  # the step's metrics first, then the gradients
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[case + ":" + k]), float(ref[case][0][k]), rtol=1e-5,
                                       err_msg=(case, k))
    for case, (arch, _) in DP_CASES.items():
        names = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(ref_params[arch])[0]]
        for name, want in zip(names, ref[case][1]):
            np.testing.assert_allclose(got[case + ":g" + name], want, atol=5e-5, rtol=1e-5, err_msg=(case, name))
    loss = float(got["ones:loss"])
    assert abs(loss - float(one_m["loss"])) <= 1e-5, (loss, float(one_m["loss"]))
    np.testing.assert_allclose(float(got["ones:grad_norm"]), float(one_m["grad_norm"]), rtol=1e-5)
    lr = float(one_m["lr"])
    for name, t in flatten_with_path(one_p):
        assert np.abs(got["ones:p" + name] - t.numpy()).max() <= lr, name
