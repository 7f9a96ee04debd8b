"""The port's distributed summarize-and-merge (``repro_torch.core.distributed``,
telemetry's mesh path, quantile clipping and compression on a mesh) against
``repro.core.distributed`` — the port's mirror of ``tests/test_distributed.py``.

Both sides read one npz of seeded NumPy inputs.  The reference runs in a
subprocess with 8 forced XLA host devices (the flag must be set before JAX
starts, as in ``tests/test_distributed.py``); the port runs 8 gloo ranks,
each a subprocess of its own with a ``file://`` rendezvous in a temporary
directory, each rank calling the port with its own shard (the one
``P(axis_names)`` gives its mesh coordinate).  Every process is joined
with a timeout, so a hang fails the test.

Tolerance: bit-equal float32 boundaries and sizes (total mass < 2^24), the
same leaf names in the same order; ``grad_norm`` (a float32 sum whose order
XLA picks) within rtol 1e-6.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import Histogram, gather_and_merge, merge, theoretical_eps_max
from repro_torch.launch.mesh import make_host_mesh, make_mesh, make_production_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
TIMEOUT_S = 240

# name -> (kind, mesh shape, mesh axes, arguments); both sides run each one
CASES = {
    "hist_4x2": ("hist", (4, 2), ("data", "model"), dict(x="gumbel", T=512, beta=64, axes=["data", "model"])),
    "hist_4x2_ties": ("hist", (4, 2), ("data", "model"), dict(x="ties", T=64, beta=16, axes=["data", "model"])),
    "hist_4x2_model_data": ("hist", (4, 2), ("data", "model"), dict(x="gumbel", T=128, beta=32, axes=["model", "data"])),
    "hist_4x2_data_only": ("hist", (4, 2), ("data", "model"), dict(x="ties", T=64, beta=16, axes=["data"])),
    "hier_2x2x2": ("hier", (2, 2, 2), ("pod", "data", "model"), dict(
        x="normal", tile_size=1024, T_tile=256, T_device=512, T_pod=512, beta=64,
        data_axes=["data", "model"], pod_axis="pod")),
    "hier_2x2x2_ties_tail": ("hier", (2, 2, 2), ("pod", "data", "model"), dict(
        x="ties_tail", tile_size=1024, T_tile=32, T_device=64, T_pod=64, beta=16,
        data_axes=["data", "model"], pod_axis="pod")),
    "hier_4x2_no_pod": ("hier", (4, 2), ("data", "model"), dict(
        x="normal", tile_size=1024, T_tile=128, T_device=256, T_pod=256, beta=32,
        data_axes=["data", "model"], pod_axis="pod")),
    "in_step_4x2": ("in_step", (4, 2), ("data", "model"), dict(x="odd", T=64, beta=32, axes=["data", "model"])),
    "gq_8": ("gq", (8,), ("data",), dict(grads="g8", q=0.99, T=256, axes=["data"])),
    "gq_4x2_ties": ("gq", (4, 2), ("data", "model"), dict(grads="gties", q=0.9, T=64, axes=["data", "model"])),
    "tree_8": ("tree", (8,), ("data",), dict(grads="gmixed", T=32, axes=["data"])),
    "clip_8": ("clip", (8,), ("data",), dict(grads="g8", q=0.99, T=256, axes=["data"])),
    "compress_8": ("compress", (8,), ("data",), dict(grads="g8", rho=0.05, T=512, axes=["data"])),
}

# each case's results: every key starting with "<case>/" holds an array
REFERENCE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import distributed_histogram, distributed_histogram_hierarchical, tensor_histogram_in_step
from repro.core.telemetry import grad_quantile, tree_summaries
from repro.launch.mesh import make_mesh
from repro.optim import CompressionConfig, OptimizerConfig, clip_grads, compress_grads

inp = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
out = {}

def grads(name):
    return {k.split("/", 1)[1]: jnp.asarray(v) for k, v in inp.items() if k.startswith(name + "/")}

def nest(g):  # "c" and "d" of gmixed go under a list, as the port nests them
    return {"a": g["a"], "b": g["b"], "z": [g["c"], {"d": g["d"]}]} if "d" in g else g

for name, (kind, shape, axes, a) in cases.items():
    mesh = make_mesh(tuple(shape), tuple(axes))
    if kind in ("hist", "hier", "in_step"):
        x = jnp.asarray(inp[a["x"]])
        if kind == "hist":
            xs = jax.device_put(x, NamedSharding(mesh, P(tuple(a["axes"]))))
            h = distributed_histogram(xs, a["T"], a["beta"], mesh, axis_names=tuple(a["axes"]))
        elif kind == "hier":
            names = tuple(a["data_axes"]) + ((a["pod_axis"],) if a["pod_axis"] in mesh.axis_names else ())
            xs = jax.device_put(x, NamedSharding(mesh, P(names)))
            h = distributed_histogram_hierarchical(
                xs, mesh, tile_size=a["tile_size"], T_tile=a["T_tile"], T_device=a["T_device"],
                T_pod=a["T_pod"], beta=a["beta"], data_axes=tuple(a["data_axes"]), pod_axis=a["pod_axis"])
        else:
            with mesh:
                h = jax.jit(lambda v: tensor_histogram_in_step(v, a["T"], a["beta"], mesh, tuple(a["axes"])))(x)
        out[name + "/b"], out[name + "/s"] = np.asarray(h.boundaries), np.asarray(h.sizes)
        continue
    g = nest(grads(a["grads"]))
    with mesh:
        if kind == "gq":
            out[name + "/thr"] = np.asarray(jax.jit(
                lambda g: grad_quantile(g, a["q"], a["T"], mesh=mesh, axis_names=tuple(a["axes"])))(g))
        elif kind == "tree":
            hs = jax.jit(lambda g: tree_summaries(g, a["T"], mesh=mesh, axis_names=tuple(a["axes"])))(g)
            out[name + "/keys"] = np.array(list(hs))
            for i, h in enumerate(hs.values()):
                out[f"{name}/b{i}"], out[f"{name}/s{i}"] = np.asarray(h.boundaries), np.asarray(h.sizes)
        elif kind == "clip":
            cfg = OptimizerConfig(clip_mode="quantile", clip_q=a["q"], clip_hist_T=a["T"])
            c, m = jax.jit(lambda g: clip_grads(g, cfg, mesh=mesh, axis_names=tuple(a["axes"])))(g)
            out[name + "/thr"], out[name + "/norm"] = np.asarray(m["clip_threshold"]), np.asarray(m["grad_norm"])
            for k in sorted(c):
                out[f"{name}/c_{k}"] = np.asarray(c[k])
        else:
            ccfg = CompressionConfig(enabled=True, rho=a["rho"], hist_T=a["T"])
            r = jax.tree.map(jnp.zeros_like, g)
            sp, res, m = jax.jit(lambda g, r: compress_grads(g, r, ccfg, mesh=mesh, axis_names=tuple(a["axes"])))(g, r)
            out[name + "/thr"] = np.asarray(m["compress_threshold"])
            out[name + "/kept"] = np.asarray(m["compress_kept_fraction"])
            for k in sorted(sp):
                out[f"{name}/sp_{k}"], out[f"{name}/res_{k}"] = np.asarray(sp[k]), np.asarray(res[k])
np.savez(sys.argv[2], **out)
'''

# one rank of the port: argv = inputs, output prefix, cases, rendezvous file, rank
PORT_RANK = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

inp_path, out_prefix, cases, init_file, rank = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), sys.argv[4], int(sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + init_file, rank=rank, world_size=%(world)d)
from repro_torch.core import distributed_histogram, distributed_histogram_hierarchical, tensor_histogram_in_step
from repro_torch.core.telemetry import grad_quantile, tree_summaries
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import CompressionConfig, OptimizerConfig, clip_grads, compress_grads
from repro_torch.tree import tree_map

inp = dict(np.load(inp_path))
out = {}

def shard(x, mesh, axes):
    """This rank's block of x under P(axes): its linear coordinate over axes."""
    k, idx = 1, 0
    for ax in axes:
        size = mesh.size(mesh.mesh_dim_names.index(ax))
        idx, k = idx * size + mesh.get_local_rank(ax), k * size
    n = x.shape[0] // k
    return torch.from_numpy(x[idx * n:(idx + 1) * n])

def grads(name):
    return {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in inp.items() if k.startswith(name + "/")}

def nest(g):
    return {"a": g["a"], "b": g["b"], "z": [g["c"], {"d": g["d"]}]} if "d" in g else g

for name, (kind, shape, axes, a) in cases.items():
    mesh = make_mesh(tuple(shape), tuple(axes), device_type="cpu")
    if kind == "hist":
        h = distributed_histogram(shard(inp[a["x"]], mesh, a["axes"]), a["T"], a["beta"], mesh, tuple(a["axes"]))
    elif kind == "hier":
        names = tuple(a["data_axes"]) + ((a["pod_axis"],) if a["pod_axis"] in mesh.mesh_dim_names else ())
        h = distributed_histogram_hierarchical(
            shard(inp[a["x"]], mesh, names), mesh, tile_size=a["tile_size"], T_tile=a["T_tile"],
            T_device=a["T_device"], T_pod=a["T_pod"], beta=a["beta"], data_axes=tuple(a["data_axes"]),
            pod_axis=a["pod_axis"])
    elif kind == "in_step":
        h = tensor_histogram_in_step(torch.from_numpy(inp[a["x"]]), a["T"], a["beta"], mesh, tuple(a["axes"]))
    if kind in ("hist", "hier", "in_step"):
        out[name + "/b"], out[name + "/s"] = h.boundaries.numpy(), h.sizes.numpy()
        continue
    g = nest(grads(a["grads"]))
    if kind == "gq":
        out[name + "/thr"] = grad_quantile(g, a["q"], a["T"], mesh=mesh, axis_names=tuple(a["axes"])).numpy()
    elif kind == "tree":
        hs = tree_summaries(g, a["T"], mesh=mesh, axis_names=tuple(a["axes"]))
        out[name + "/keys"] = np.array(list(hs))
        for i, h in enumerate(hs.values()):
            out[f"{name}/b{i}"], out[f"{name}/s{i}"] = h.boundaries.numpy(), h.sizes.numpy()
    elif kind == "clip":
        cfg = OptimizerConfig(clip_mode="quantile", clip_q=a["q"], clip_hist_T=a["T"])
        c, m = clip_grads(g, cfg, mesh=mesh, axis_names=tuple(a["axes"]))
        out[name + "/thr"], out[name + "/norm"] = m["clip_threshold"].numpy(), m["grad_norm"].numpy()
        for k in sorted(c):
            out[f"{name}/c_{k}"] = c[k].numpy()
    else:
        ccfg = CompressionConfig(enabled=True, rho=a["rho"], hist_T=a["T"])
        sp, res, m = compress_grads(g, tree_map(torch.zeros_like, g), ccfg, mesh=mesh, axis_names=tuple(a["axes"]))
        out[name + "/thr"] = m["compress_threshold"].numpy()
        out[name + "/kept"] = m["compress_kept_fraction"].numpy()
        for k in sorted(sp):
            out[f"{name}/sp_{k}"], out[f"{name}/res_{k}"] = sp[k].numpy(), res[k].numpy()
np.savez(out_prefix + str(rank) + ".npz", **out)
dist.destroy_process_group()
''' % {"world": WORLD}


def make_inputs(path: str) -> dict:
    rng = np.random.default_rng(0)
    inp = {
        "gumbel": rng.gumbel(size=8 * 4000).astype(np.float32),
        "ties": rng.integers(0, 40, size=8 * 4000).astype(np.float32),
        "normal": rng.normal(size=8 * 4096).astype(np.float32),
        "ties_tail": rng.integers(-20, 20, size=8 * 5000).astype(np.float32),
        "odd": rng.standard_t(3, size=8 * 1003 + 5).astype(np.float32),
        "g8/a": rng.normal(size=(512, 16)).astype(np.float32),
        "g8/b": rng.normal(size=(1024,)).astype(np.float32),
        "gties/a": (rng.integers(-8, 9, size=(64, 40)) / 4).astype(np.float32),
        "gties/b": (rng.integers(-8, 9, size=(999,)) / 4).astype(np.float32),
        "gmixed/a": rng.normal(size=(40, 21)).astype(np.float32),
        "gmixed/b": (rng.normal(size=(1003,)) * 3).astype(np.float32),
        "gmixed/c": rng.normal(size=(5,)).astype(np.float32),
        "gmixed/d": rng.laplace(size=(7, 9)).astype(np.float32),
    }
    np.savez(path, **inp)
    return inp


def _finish(procs: dict, timeout: float) -> dict:
    """Wait for every process (killing all of them at the timeout); returns
    name -> (returncode, stdout + stderr)."""
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs, the reference's results and every rank's results."""
    d = tmp_path_factory.mktemp("dist")
    inp_path = str(d / "inputs.npz")
    inputs = make_inputs(inp_path)
    cases = json.dumps(CASES)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}", OMP_NUM_THREADS="1")
    (d / "reference.py").write_text(REFERENCE)
    (d / "rank.py").write_text(PORT_RANK)
    common = dict(env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = {"reference": subprocess.Popen(
        [sys.executable, str(d / "reference.py"), inp_path, str(d / "reference.npz"), cases], **common)}
    for r in range(WORLD):
        procs[f"rank{r}"] = subprocess.Popen(
            [sys.executable, str(d / "rank.py"), inp_path, str(d / "rank"), cases, str(d / "rendezvous"), str(r)],
            **common)
    done = _finish(procs, TIMEOUT_S)
    for name, (rc, text) in done.items():
        assert rc == 0, f"{name} exited {rc}:\n{text[-4000:]}"
    return inputs, _load(d / "reference.npz"), [_load(d / f"rank{r}.npz") for r in range(WORLD)]


def _load(path) -> dict:
    with np.load(path) as f:
        return dict(f)


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind in "US":
        return bool(np.array_equal(a, b))
    return a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_is_bit_equal_to_reference_on_8_devices(runs, case):
    _, ref, ranks = runs
    keys = sorted(k for k in ref if k.startswith(case + "/"))
    assert keys and keys == sorted(k for k in ranks[0] if k.startswith(case + "/"))
    for k in keys:
        if k.endswith("/norm"):  # a float32 sum in an order each side picks
            np.testing.assert_allclose(ranks[0][k], ref[k], rtol=1e-6)
        else:
            assert _bits_equal(ranks[0][k], ref[k]), (k, ranks[0][k], ref[k])


@pytest.mark.parametrize("rank", range(1, WORLD))
def test_every_rank_holds_rank_0s_answer(runs, rank):
    _, _, ranks = runs
    assert sorted(ranks[rank]) == sorted(ranks[0])
    for k, v in ranks[0].items():
        assert _bits_equal(ranks[rank][k], v), (rank, k)


def test_distributed_histogram_matches_local(runs):
    inputs, _, ranks = runs
    N = inputs["gumbel"].shape[0]
    sizes = ranks[0]["hist_4x2/s"]
    err = np.abs(sizes - N / 64).max()
    bound = theoretical_eps_max(N, 512, k=8, exact_inputs=False)
    assert err <= bound, (err, bound)
    assert float(sizes.sum()) == N


def test_hierarchical_pod_merge(runs):
    inputs, _, ranks = runs
    N = inputs["normal"].shape[0]
    err = np.abs(ranks[0]["hier_2x2x2/s"] - N / 64).max()
    bound = 2 * N * (1 / 256 + 1 / 512 + 1 / 512) + 2 * (8 * 4 + 8 + 2)
    assert err <= bound, (err, bound)


def test_telemetry_quantile_clip_on_mesh(runs):
    inputs, _, ranks = runs
    thr = float(ranks[0]["gq_8/thr"])
    allv = np.sort(np.abs(np.concatenate([inputs["g8/a"].ravel(), inputs["g8/b"].ravel()])))
    rank = np.searchsorted(allv, thr) / len(allv)
    assert abs(rank - 0.99) < 2 / 256 + 0.02, (thr, rank)
    assert np.abs(ranks[0]["clip_8/c_a"]).max() <= thr


def test_tree_summaries_keys_in_jax_order(runs):
    _, ref, ranks = runs
    assert list(ranks[0]["tree_8/keys"]) == ["['a']", "['b']", "['z'][0]", "['z'][1]['d']"]
    assert list(ref["tree_8/keys"]) == list(ranks[0]["tree_8/keys"])
    # the 5-value leaf is shorter than the mesh: summarized whole, 5 buckets
    assert ranks[0]["tree_8/s2"].shape == (5,)


def test_compression_on_mesh_is_lossless(runs):
    inputs, _, ranks = runs
    for k in ("a", "b"):
        np.testing.assert_array_equal(
            ranks[0][f"compress_8/sp_{k}"] + ranks[0][f"compress_8/res_{k}"], inputs[f"g8/{k}"]
        )
    assert abs(float(ranks[0]["compress_8/kept"]) - 0.05) < 2 / 512 + 0.01


def test_ties_case_depends_on_the_gather_order(runs):
    """The tied case is sensitive to the merge's row order: the same local
    summaries merged in plain rank order give other sizes than the
    reference's gather order (data-major within model), which the port
    matches bit for bit."""
    inputs, ref, _ = runs
    from repro_torch.core import build_exact

    x = torch.from_numpy(inputs["ties"])
    local = [build_exact(s, 64, device="cpu") for s in x.reshape(WORLD, -1)]
    rank_order = merge(Histogram(torch.stack([h.boundaries for h in local]),
                                 torch.stack([h.sizes for h in local])), 16)
    gather_order = [0, 2, 4, 6, 1, 3, 5, 7]
    ref_order = merge(Histogram(torch.stack([local[r].boundaries for r in gather_order]),
                                torch.stack([local[r].sizes for r in gather_order])), 16)
    assert ref_order.sizes.numpy().tobytes() == ref["hist_4x2_ties/s"].tobytes()
    assert rank_order.sizes.numpy().tobytes() != ref["hist_4x2_ties/s"].tobytes()


@pytest.fixture
def fake_world():
    """An in-process process group of 512 ranks on torch's fake backend."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_production_mesh_shapes(fake_world):
    m1 = make_production_mesh(multi_pod=False, device_type="cpu")
    assert m1.mesh_dim_names == ("data", "model") and tuple(m1.mesh.shape) == (16, 16)
    m2 = make_production_mesh(multi_pod=True, device_type="cpu")
    assert m2.mesh_dim_names == ("pod", "data", "model") and tuple(m2.mesh.shape) == (2, 16, 16)


@pytest.fixture
def gloo_world_1(tmp_path):
    """A gloo process group of one rank, in this process."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_world_1_mesh_is_the_local_merge(gloo_world_1):
    mesh = make_host_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (1, 1)
    rng = np.random.default_rng(3)
    local = Histogram(torch.from_numpy(np.sort(rng.normal(size=65)).astype(np.float32)),
                      torch.full((64,), 7.0))
    got = gather_and_merge(local, 16, mesh, ("data", "model"))
    want = merge(Histogram(local.boundaries[None], local.sizes[None]), 16)
    assert torch.equal(got.boundaries, want.boundaries) and torch.equal(got.sizes, want.sizes)


def test_mesh_call_without_a_process_group_raises(gloo_world_1):
    mesh = make_mesh((1,), ("data",), device_type="cpu")
    dist.destroy_process_group()
    local = Histogram(torch.arange(5, dtype=torch.float32), torch.ones(4))
    with pytest.raises(RuntimeError, match="process group"):
        gather_and_merge(local, 2, mesh, "data")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1,), ("data",), device_type="cpu")


def test_unknown_mesh_axis_raises(gloo_world_1):
    from repro_torch.core import tensor_histogram_in_step

    mesh = make_mesh((1,), ("data",), device_type="cpu")
    with pytest.raises(KeyError, match="model"):
        tensor_histogram_in_step(torch.ones(16), 4, 4, mesh, ("model",))


# ---- the same functions without a mesh (one process, both packages) ----


def _tree(rng):
    """Dict keys out of sorted order, a list, a tuple, None and int keys."""
    return {
        "zeta": rng.normal(size=(33, 5)).astype(np.float32),
        "alpha": [rng.laplace(size=(200,)).astype(np.float32),
                  (rng.integers(-9, 9, size=(40,)).astype(np.float32), None)],
        "mid": {3: rng.standard_t(2, size=(7, 7)).astype(np.float32),
                1: rng.normal(size=(2,)).astype(np.float32)},
    }


def test_tree_leaf_names_and_order_match_jax():
    import jax
    from repro_torch.tree import flatten_with_path, leaves

    tree = _tree(np.random.default_rng(0))
    got = flatten_with_path(tree)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [k for k, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert all(a is b for a, b in zip(leaves(tree), jax.tree.leaves(tree)))


@pytest.mark.parametrize("magnitude", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_tensor_summary_without_mesh_matches_reference(magnitude, dtype):
    import jax.numpy as jnp
    from repro.core.telemetry import tensor_summary as ref_summary
    from repro_torch.core.telemetry import tensor_summary

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(37, 11)) * 20).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tensor_summary(xt, 64, magnitude=magnitude)
    want = ref_summary(xj, 64, magnitude=magnitude)
    assert got.boundaries.numpy().tobytes() == np.asarray(want.boundaries).tobytes()
    assert got.sizes.numpy().tobytes() == np.asarray(want.sizes).tobytes()


def test_tree_summaries_without_mesh_same_keys_same_order():
    from repro.core.telemetry import tree_summaries as ref_tree
    from repro_torch.core.telemetry import tree_summaries
    from repro_torch.tree import tree_map

    tree = _tree(np.random.default_rng(2))
    got = tree_summaries(tree_map(torch.from_numpy, tree), 16)
    want = ref_tree(tree, 16)
    assert list(got) == list(want)
    for k in want:
        assert got[k].boundaries.numpy().tobytes() == np.asarray(want[k].boundaries).tobytes(), k
        assert got[k].sizes.numpy().tobytes() == np.asarray(want[k].sizes).tobytes(), k


@pytest.mark.parametrize("q, T", [(0.5, 16), (0.99, 64), (0.999, 512), (1.0, 32)])
def test_grad_quantile_without_mesh_matches_reference(q, T):
    from repro.core.telemetry import grad_quantile as ref_gq
    from repro_torch.core.telemetry import grad_quantile
    from repro_torch.tree import tree_map

    tree = _tree(np.random.default_rng(3))
    got = grad_quantile(tree_map(torch.from_numpy, tree), q, T)
    assert got.dim() == 0 and got.dtype == torch.float32
    assert got.numpy().tobytes() == np.asarray(ref_gq(tree, q, T)).tobytes()
