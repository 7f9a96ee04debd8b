"""The port's dry-run (``repro_torch.launch.{specs,dryrun,dryrun_core}``)
against the reference's, on the CPU.

- input specs: shapes and dtypes equal to the reference's
  ``ShapeDtypeStruct``s for every arch × ``SHAPES`` entry;
- ``param_specs`` / ``cache_specs``: equal leaf for leaf to the
  reference's ``init_model(..., abstract=True)`` and ``init_cache(...,
  abstract=True)`` specs for all ten archs at full size, and the port's
  trees (made under ``FakeTensorMode``) of the reference's shapes and dtypes;
- per-device argument bytes: equal, as exact integers, to the reference's
  ``Rules.tree_pspecs`` arithmetic (each dimension divided, rounding up, by
  the mesh size of its ``PartitionSpec`` entry) on 16 × 16 and 2 × 16 × 16
  stand-in meshes, for every arch × shape (the reference's ``Rules`` reads
  only ``mesh.shape`` and ``mesh.axis_names``);
- ``_model_flops`` and ``costing_config``: equal to the reference's (its
  ``tests/test_dryrun_tools.py`` costing tests, mirrored, and every arch ×
  shape);
- the collective rules one at a time, by hand counts on a 2 × 2 stand-in
  mesh; the data-parallel gradient all-reduce against the bytes the port's
  step sends on 8 gloo ranks;
- FLOPs of Qwen3-8B at full width within a derived band, and per-device
  work that adds up to the whole where every dimension divides.

The reference's ``parse_collective_bytes`` / ``_shape_bytes`` tests are not
mirrored: they parse XLA's HLO text, which the port has no counterpart of.

The reference's ``dryrun.py`` sets ``XLA_FLAGS`` when imported; it is
imported here after ``jax.devices()`` has fixed this process's device
count, and the variable is restored right after.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as RC
import repro.launch.specs as RS
import repro.models.model as RM
import repro_torch.configs as PC
import repro_torch.launch.specs as PS
from repro.sharding import Rules as RRules
from repro_torch.kernels.cost import CARD
from repro_torch.launch import dryrun, dryrun_core
from repro_torch.models.model import cache_specs, init_cache, init_model, is_spec, param_specs
from repro_torch.sharding import Rules
from repro_torch.tree import flatten_with_path

jax.devices()  # fixes this process's device count before the reference's dryrun sets XLA_FLAGS
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = RC.list_archs()
SHAPE_NAMES = list(RC.SHAPES)
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class RefMesh:
    """What the reference's ``Rules`` reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _ref_leaves(tree, is_leaf=None):
    return [(jax.tree_util.keystr(k), v) for k, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
def test_input_specs_equal_the_reference(arch, shape_name):
    rc, pc, shape = RC.get_config(arch), PC.get_config(arch), RC.SHAPES[shape_name]
    pshape = PC.SHAPES[shape_name]
    for rf, pf in ((RS.train_input_specs, PS.train_input_specs), (RS.prefill_input_specs, PS.prefill_input_specs),
                   (RS.decode_input_specs, PS.decode_input_specs)):
        ref, port = rf(rc, shape), pf(pc, pshape)
        assert list(ref) == list(port)
        for k in ref:
            assert tuple(ref[k].shape) == port[k].shape and str(ref[k].dtype) == _dtype(port[k]), (k, ref[k], port[k])
    assert RS.batch_logical_specs(rc) == PS.batch_logical_specs(pc)
    assert tuple(PS.decode_input_specs(pc, pshape)["token"].empty().shape) == (shape.global_batch, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_the_reference_at_full_size(arch):
    rc, pc = RC.get_config(arch), PC.get_config(arch)
    rp, rs = RM.init_model(rc, jax.random.PRNGKey(0), abstract=True)
    assert _ref_leaves(rs, is_spec) == flatten_with_path(param_specs(pc), is_leaf=is_spec)
    with FakeTensorMode():
        tp = init_model(pc, torch.Generator().manual_seed(0), device="cpu")
        tc = init_cache(pc, 3, 128, device="cpu")
    assert [(k, tuple(v.shape), str(v.dtype)) for k, v in _ref_leaves(rp)] == [
        (k, tuple(v.shape), _dtype(v)) for k, v in flatten_with_path(tp)]
    rcache, rcs = RM.init_cache(rc, 3, 128, abstract=True)
    assert _ref_leaves(rcs, is_spec) == flatten_with_path(cache_specs(pc), is_leaf=is_spec)
    assert [(k, tuple(v.shape), str(v.dtype)) for k, v in _ref_leaves(rcache)] == [
        (k, tuple(v.shape), _dtype(v)) for k, v in flatten_with_path(tc)]


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    return RM.init_model(RC.get_config(arch), jax.random.PRNGKey(0), abstract=True)


def _ref_local_bytes(structs, pspecs, mesh) -> int:
    """The reference's per-device bytes: each leaf's dimensions divided,
    rounding up, by the mesh size of its PartitionSpec entry."""
    total = 0
    for s, p in zip(jax.tree.leaves(structs), jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))):
        n = s.dtype.itemsize
        entries = tuple(p) + (None,) * (len(s.shape) - len(p))
        for dim, e in zip(s.shape, entries):
            axes = (e,) if isinstance(e, str) else tuple(e or ())
            n *= -(-dim // math.prod(mesh.shape[a] for a in axes))
        total += n
    return total


def _ref_arguments(arch, shape_name, mesh) -> dict:
    rc, shape = RC.get_config(arch), RC.SHAPES[shape_name]
    rules = RRules(rc, mesh, shape.kind, seq_len=shape.seq_len)
    params, pspecs = _ref_abstract(arch)
    out = {"params": _ref_local_bytes(params, rules.tree_pspecs(pspecs), mesh)}
    lb = RS.batch_logical_specs(rc)
    if shape.kind == "train":
        batch = RS.train_input_specs(rc, shape)
        mdt = jax.numpy.bfloat16 if rc.optimizer_dtype == "bfloat16" else jax.numpy.float32
        moments = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, mdt), params)
        out["opt"] = 2 * _ref_local_bytes(moments, rules.tree_pspecs(pspecs), mesh) + 4  # m, v, the int32 step
        out["batch"] = _ref_local_bytes(batch, rules.tree_pspecs({k: lb[k] for k in batch}), mesh)
        return out
    cache, cspecs = RM.init_cache(rc, shape.global_batch, shape.seq_len, abstract=True)
    out["cache"] = _ref_local_bytes(cache, rules.tree_pspecs(cspecs), mesh)
    if shape.kind == "prefill":
        batch = RS.prefill_input_specs(rc, shape)
        out["batch"] = _ref_local_bytes(batch, rules.tree_pspecs({k: lb[k] for k in batch}), mesh)
    else:
        dec = RS.decode_input_specs(rc, shape)
        out["token"] = _ref_local_bytes(dec["token"], rules(("act_batch", None)), mesh)
        out["pos"] = 4
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_arithmetic(arch, shape_name, mesh_name):
    shape_, axes = MESHES[mesh_name]
    pc, pshape = PC.get_config(arch), PC.SHAPES[shape_name]
    assert PC.shape_applicable(pc, pshape) == RC.shape_applicable(RC.get_config(arch), RC.SHAPES[shape_name])
    mesh = dryrun.StandInMesh(axes, shape_)
    cell = dryrun.build_cell(pc, pshape)
    got = dryrun.arguments(cell, Rules(pc, mesh, pshape.kind, seq_len=pshape.seq_len), mesh)
    assert got == _ref_arguments(arch, shape_name, RefMesh(shape_, axes))


def test_costing_config_collapses_loops():
    cfg, shape = PC.get_config("gemma2-9b"), PC.SHAPES["train_4k"]
    c1 = dryrun.costing_config(cfg, shape, 1)
    assert c1.repeats == 1 and c1.scan_unroll == 1
    assert c1.attn_q_chunk == shape.seq_len
    assert c1.loss_chunk == shape.seq_len
    c2 = dryrun.costing_config(cfg, shape, 2)
    assert c2.repeats == 2 and c2.scan_unroll == 2
    rc = RC.get_config("gemma2-9b")
    for r in (1, 2):
        assert dataclasses.asdict(dryrun.costing_config(cfg, shape, r)) == dataclasses.asdict(
            ref_dryrun.costing_config(rc, RC.SHAPES["train_4k"], r))


def test_costing_config_encoder_scaling():
    c2 = dryrun.costing_config(PC.get_config("whisper-medium"), PC.SHAPES["train_4k"], 2)
    assert c2.encoder_layers == 2  # enc scales with r so the marginal is exact
    assert c2.encoder_layers == ref_dryrun.costing_config(
        RC.get_config("whisper-medium"), RC.SHAPES["train_4k"], 2).encoder_layers


def test_model_flops_train_vs_decode():
    cfg = PC.get_config("deepseek-7b")
    train = dryrun._model_flops(cfg, PC.SHAPES["train_4k"])
    assert train == pytest.approx(6 * cfg.param_count() * 256 * 4096, rel=1e-6)
    dec = dryrun._model_flops(cfg, PC.SHAPES["decode_32k"])
    assert dec == pytest.approx(2 * cfg.param_count() * 128, rel=1e-6)
    assert train == ref_dryrun._model_flops(RC.get_config("deepseek-7b"), RC.SHAPES["train_4k"])


def test_model_flops_moe_uses_active():
    cfg = PC.get_config("llama4-maverick-400b-a17b")
    f = dryrun._model_flops(cfg, PC.SHAPES["train_4k"])
    assert f == pytest.approx(6 * cfg.active_param_count() * 256 * 4096, rel=1e-6)
    assert cfg.active_param_count() < 0.05 * cfg.param_count()
    assert f == ref_dryrun._model_flops(RC.get_config("llama4-maverick-400b-a17b"), RC.SHAPES["train_4k"])


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_costing_config_equal_the_reference(arch, shape_name):
    pc, rc = PC.get_config(arch), RC.get_config(arch)
    assert dryrun._model_flops(pc, PC.SHAPES[shape_name]) == ref_dryrun._model_flops(rc, RC.SHAPES[shape_name])
    for r in (1, 2):
        assert dataclasses.asdict(dryrun.costing_config(pc, PC.SHAPES[shape_name], r)) == dataclasses.asdict(
            ref_dryrun.costing_config(rc, RC.SHAPES[shape_name], r))


# ---------------------------------------------------------------------------
# Collectives, one rule at a time, on a 2 × 2 ("data", "model") stand-in
# ---------------------------------------------------------------------------

MESH_2X2 = dryrun.StandInMesh(("data", "model"), (2, 2))


def _dense(**kw):
    """A one-layer float32 dense config whose every dimension splits in 2."""
    return dataclasses.replace(PC.smoke(PC.get_config("qwen3-8b")), qk_norm=False, **kw)


def _costs(cfg, shape):
    return dryrun.measure(cfg, shape, [MESH_2X2])[0]["collectives"]


def test_fsdp_all_gathers_each_weight_once_a_use():
    cfg, d, f, V, H, Hkv, hd = _dense(), 128, 256, 512, 4, 2, 32
    # a layer's matrices: wq (d, H·hd) and wo split on heads, wk, wv on kv heads,
    # the MLP on d_ff: each model-split in 2; embed and unembed split on the vocabulary
    layer = d * H * hd / 2 * 2 + d * Hkv * hd / 2 * 2 + 3 * d * f / 2
    tables = 2 * V * d / 2
    prefill = PC.ShapeConfig("p", 32, 4, "prefill")
    assert _costs(cfg, prefill)[("all-gather", "data")] == 4 * (layer + tables)  # float32: the smoke compute dtype
    train = PC.ShapeConfig("t", 32, 4, "train")  # remat "none": the forward and the backward
    got = dryrun._analytic_collectives(cfg, train, Rules(cfg, MESH_2X2, "train", seq_len=32), MESH_2X2)
    assert got[("all-gather", "data")] == 2 * 4 * (layer + tables)
    full = dataclasses.replace(cfg, remat_policy="full")  # and the recompute
    got = dryrun._analytic_collectives(full, train, Rules(full, MESH_2X2, "train", seq_len=32), MESH_2X2)
    assert got[("all-gather", "data")] == 3 * 4 * (layer + tables)


def test_gradients_reduce_scatter_over_fsdp_and_all_reduce_over_the_rest():
    cfg = _dense()
    train = PC.ShapeConfig("t", 32, 4, "train")
    mesh = dryrun.StandInMesh(("pod", "data", "model"), (2, 2, 2))
    got = dryrun._analytic_collectives(cfg, train, Rules(cfg, mesh, "train", seq_len=32), mesh)
    params = dryrun._abstract_params(cfg)
    rules = Rules(cfg, mesh, "train", seq_len=32)
    shards = {k: 4 * math.prod(s.shape) / math.prod(
        mesh.sizes[a] for e in rules(lg) for a in ((e,) if isinstance(e, str) else (e or ())))
        for k, s, lg in dryrun._pairs((params, param_specs(cfg)))}
    fsdp = {k for k, _, lg in dryrun._pairs((params, param_specs(cfg))) if "embed" in lg}
    assert fsdp and len(fsdp) < len(shards)  # the norms are not split over "data"
    assert got[("reduce-scatter", "data")] == sum(shards[k] for k in fsdp)
    assert got[("all-reduce", "data")] == sum(v for k, v in shards.items() if k not in fsdp)
    assert got[("all-reduce", "pod")] == sum(shards.values())


def test_sequence_parallel_gathers_and_scatters_around_each_block():
    cfg, B, S, d, V = _dense(), 4, 32, 128, 512
    got = _costs(cfg, PC.ShapeConfig("p", S, B, "prefill"))
    act = (B // 2) * S * d * 4  # a device's batch share at full sequence, float32
    # attention block: the normed input gathered once for wq, wk, wv; the MLP's
    # once for w_gate and w_up; the final norm's last position once for the
    # unembedding (its S = 1 row)
    assert got[("all-gather", "model")] == 2 * act + (B // 2) * 1 * d * 4
    # reduce-scatters onto the sequence: after the vocabulary-split lookup, wo and w_down
    assert got[("reduce-scatter", "model")] == 3 * act / 2


def test_decode_all_reduces_row_parallel_outputs_and_combines_split_kv():
    cfg, B, S, d, H, hd = _dense(), 4, 32, 128, 4, 32
    got = _costs(cfg, PC.ShapeConfig("d", S, B, "decode"))
    tok = (B // 2) * 1 * d * 4
    assert ("all-gather", "model") not in got  # no sequence to split in decode
    # the lookup, wo and w_down all-reduced; the attention's partial output
    # and its two statistics combined over kv_seq's "model"
    assert got[("all-reduce", "model")] == 3 * tok + 4 * (B // 2) * H * (hd + 2)


def test_moe_all_to_all_when_experts_are_over_model():
    cfg = dataclasses.replace(PC.smoke(PC.get_config("dbrx-132b")), qk_norm=False)
    B, S = 4, 32
    assert Rules(cfg, MESH_2X2, "prefill", seq_len=S).table["experts"] == "model"
    got = dryrun._analytic_collectives(cfg, PC.ShapeConfig("p", S, B, "prefill"),
                                       Rules(cfg, MESH_2X2, "prefill", seq_len=S), MESH_2X2)
    g = cfg.moe_group_size
    cap = max(int(g * cfg.num_experts_per_token * cfg.moe_capacity_factor / cfg.num_experts), 1)
    slots = (B // 2) * (S // g) * cfg.num_experts * cap * cfg.d_model * 4 / 2  # float32, half the experts
    assert got[("all-to-all", "model")] == 2 * slots  # dispatch and combine


DP_RANK = r'''
import json
import sys
import numpy as np
import torch
import torch.distributed as dist

init_file, out, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + init_file, rank=rank, world_size=8)
sent = []
_all_reduce = dist.all_reduce
def recording(t, *a, **k):
    sent.append(t.numel() * t.element_size())
    return _all_reduce(t, *a, **k)
dist.all_reduce = recording
from repro_torch.configs import get_config, smoke
from repro_torch.data import shard_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_model
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding import Rules
from repro_torch.train import make_opt_state, make_train_step

cfg = smoke(get_config("qwen3-8b"))
mesh = make_mesh((8,), ("data",), device_type="cpu")
rules = Rules(cfg, mesh, "train", seq_len=32)
params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
rng = np.random.default_rng(0)
whole = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32), "mask": np.ones((8, 32), np.float32)}
opt = OptimizerConfig()
_, _, metrics = make_train_step(cfg, opt, rules, mesh=mesh)(params, make_opt_state(params, opt),
                                                            shard_batch(whole, rules, mesh, device="cpu"))
with open(out + str(rank) + ".json", "w") as f:
    json.dump(sent, f)
dist.destroy_process_group()
'''


def test_data_parallel_all_reduce_equals_what_the_step_sends_on_8_gloo_ranks(tmp_path):
    (tmp_path / "rank.py").write_text(DP_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "rank.py"), str(tmp_path / "rendezvous"),
                               str(tmp_path / "sent"), str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(8)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (text, _) in zip(procs, outs):
        assert p.returncode == 0, text[-4000:]
    cfg = PC.smoke(PC.get_config("qwen3-8b"))
    mesh = dryrun.StandInMesh(("data",), (8,))
    # the port's step keeps the parameters replicated: the rules without FSDP
    rules = Rules(cfg, mesh, "train", seq_len=32, fsdp=False)
    predicted = dryrun._analytic_collectives(cfg, PC.ShapeConfig("t", 32, 8, "train"), rules, mesh)
    assert set(predicted) == {("all-reduce", "data")}
    for r in range(8):
        sent = json.loads((tmp_path / f"sent{r}.json").read_text())
        # the step's all-reduces: the mask count, then the four metrics
        # (loss, ce, load balance, router z) with every float32 gradient
        assert sent[:-1] == [4] and sent[-1] - 4 * 4 == predicted[("all-reduce", "data")]


# ---------------------------------------------------------------------------
# FLOPs and the records
# ---------------------------------------------------------------------------


def test_qwen3_train_flops_within_the_derived_band():
    """Qwen3-8B at full width, train_4k on one device (1 × 1 mesh).

    With ``remat_policy="full"`` every block matmul runs in the forward,
    its recompute and twice in the backward: 8·N·D for the N matmul
    parameters (the embedding lookup does none; the float32 unembedding of
    the chunked loss is checkpointed alike), plus the attention cores,
    2·2·B·H·S²·hd a layer per pass (QKᵀ and PV, unmasked), in the forward,
    the recompute and the backward's four products: 16·B·H·S²·hd·L.
    PyTorch's non-reentrant checkpoint stops its recompute once every
    saved tensor is back, so each layer's last matmul (``w_down``, whose
    output no backward needs) is not recomputed: 2·D·d·d_ff·L less.  The
    count is that, to the float32 sum's precision; the band below the
    naive 8·N·D + cores is what the early stop takes (5.2 %)."""
    cfg, shape = PC.get_config("qwen3-8b"), PC.SHAPES["train_4k"]
    one = dryrun.StandInMesh(("data", "model"), (1, 1))
    got = dryrun.measure(cfg, shape, [one])[0]
    B, S, d, L = shape.global_batch, shape.seq_len, cfg.d_model, cfg.num_layers
    D = B * S
    N = cfg.param_count() - cfg.vocab_size * d  # the lookup's table does no matmul
    cores = 16 * B * cfg.num_heads * S * S * cfg.head_dim * L
    naive = 8 * N * D + cores
    want = naive - 2 * D * d * cfg.d_ff * L
    assert got["flops"] == pytest.approx(want, rel=1e-6)
    assert 0.94 * naive <= got["flops"] <= naive
    assert got["flops_by_dtype"]["float32"] == pytest.approx(cores + 8 * D * cfg.vocab_size * d, rel=1e-6)


def test_per_device_work_adds_up_where_every_dimension_divides():
    cfg, shape = PC.get_config("deepseek-7b"), PC.SHAPES["train_4k"]
    meshes = [dryrun.StandInMesh(("data", "model"), (1, 1)), dryrun.production_mesh(False),
              dryrun.production_mesh(True)]
    one, single, multi = dryrun.measure(cfg, shape, meshes)
    assert Rules(cfg, meshes[1], "train", seq_len=4096).degradations() == []
    for m, c in ((meshes[1], single), (meshes[2], multi)):
        assert c["flops"] * m.size == pytest.approx(one["flops"], rel=1e-9)
        assert c["bytes"] * m.size == pytest.approx(one["bytes"], rel=0.02)  # norms' gains: replicated
    smollm = PC.get_config("smollm-135m")  # 9 heads: attention replicated over "model"
    one, single = dryrun.measure(smollm, shape, meshes[:2])
    assert single["flops"] * 256 > 1.05 * one["flops"]


def test_run_cell_record_keys_and_main_writes_every_cell(tmp_path, monkeypatch):
    rec = dryrun.run_cell("smollm-135m", "decode_32k", False)
    assert rec["status"] == "ok" and rec["card"] == CARD and rec["mesh"] == "16x16"
    for k in ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "alias_size_in_bytes",
              "peak_bytes_per_device"):
        assert isinstance(rec["memory"][k], int)
    for k in ("hlo_flops_per_device", "hlo_bytes_per_device", "collectives", "terms", "dominant",
              "roofline_step_s", "model_flops_total", "model_flops_per_device", "useful_compute_ratio",
              "mfu_upper_bound", "degradations", "cost_source"):
        assert k in rec, k
    assert rec["degradations"] == ["heads=9 !% model=16 -> replicated", "kv_heads=3 !% model=16 -> replicated"]
    assert rec["roofline_step_s"] == max(rec["terms"].values())
    out = tmp_path / "dr"
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "qwen3-8b", "--shape", "long_500k", "--out", str(out)])
    dryrun.main()
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "whisper-medium", "--shape", "decode_32k", "--out",
                                      str(out)])
    dryrun.main()
    recs = {p.name: json.loads(p.read_text()) for p in out.iterdir()}
    assert sorted(recs) == [f"{a}__{s}__{m}.json" for a, s in (("qwen3-8b", "long_500k"),
                                                                  ("whisper-medium", "decode_32k"))
                            for m in ("16x16", "2x16x16")]
    assert {r["status"] for n, r in recs.items() if n.startswith("qwen3")} == {"skip"}
    assert {r["status"] for n, r in recs.items() if n.startswith("whisper")} == {"ok"}


def test_dryrun_core_writes_three_variants_for_both_meshes(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["dryrun_core", "--out", str(tmp_path)])
    dryrun_core.main()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"core__{v}__{m}.json" for v in dryrun_core.VARIANTS for m in ("16x16", "2x16x16"))
    merge = json.loads((tmp_path / "core__merge__16x16.json").read_text())
    T = 40 * 254
    # the all-gathers carry gather_and_merge's shapes: 2T + 1 float32 a summary, 16 then 256 of them
    assert merge["collectives"]["all-gather"] == 4.0 * (16 + 256) * (2 * T + 1)
    assert merge["collectives"]["all-gather@data"] == 4.0 * 16 * (2 * T + 1)
    assert merge["collectives"]["n_all-gather"] == 2
    assert [item["name"] for item in merge["launches"]] == ["tile_sort", "merge_cut"]
    one = dryrun_core.run("merge", False, 1 << 22, T, 254, mesh=dryrun.StandInMesh(("data",), (1,)))
    assert one["collectives"]["all-gather"] == 0.0 and one["kernel_bound_s"] > 0
