"""The harness takes new cells, mixes, configurations and metrics as new
files alone: a copy of ``hbench/`` gets only files it did not have (and a
``BENCHMARK.json`` with their entries, the new cells' names appended to
the ``workloads`` of the metrics they report), and each new cell passes
the checks the committed cells pass (``test_hbench_runs.py``), at the
tiny sizes its own tiny files give, on the port's ``device="cpu"`` path.
Among them is a served hybrid model (``jamba-v0.1-52b`` at the port's
smoke widths: Mamba, attention and MoE layers in one period), whose
reference brings its two layer parts in its own folder
(``reference/layers/hybrid/``), which the shared names leave free for the
published parts; whose adapter of its own (``systems/hybrid_chunked.py``)
sets a port option that ``systems/engine.py`` does not; and whose
configuration brings a planted fault (``planted/hybrid.py``) that
``test_hbench_faults.py``'s check catches."""
import filecmp
import json
import os
import shutil

import pytest
import torch

from hbench import faults, harness
from hbench.reference.model import Decoder
from hbench.test_hbench_faults import planted_run
from hbench.test_hbench_runs import check_control, check_program
from hbench.test_hbench_runs import run as run_tiny

TENANTS = {"name": "tenants", "system": "registry", "num_buckets": 32, "retention_partitions": 31, "tenants": 5,
           "values_per_partition": 2048, "pool_partitions": 31, "dtype": "float32",
           "distribution": {"kind": "lognormal", "mu": -1.8, "sigma": 0.55}}
RAGGED = {"name": "ragged", "system": "store", "num_buckets": 64, "retention_partitions": 31, "tenants": 1,
          "values_per_partition": {"kind": "lognormal", "median": 3000, "sigma": 0.8, "min": 64, "max": 30000},
          "pool_partitions": 7, "dtype": "float32", "distribution": {"kind": "gumbel", "loc": 0.0, "scale": 1.0}}
OPEN = {"fill": {"days": 31, "mode": "async"}, "loop": "open", "rate_per_s": 300,
        "tenants": {"kind": "zipf", "s": 1.0}, "days": 31, "beta": 8, "check_answers": 100}
EXACT = {"boundaries_off_leaves": 0, "bucket_err_over_eps": 1.0}
# jamba-v0.1-52b's layer period at the port's smoke widths (repro_torch.configs.smoke), in float32
# as smoke configs are (in bfloat16 a router's near-tie flips an expert and moves a logit far past
# rounding), with RoPE at the port's default theta, which the plain attention then applies too;
# served through an adapter of its own that takes the scan's chunk from the configuration
HYBRID = {"name": "hybrid", "system": "hybrid_chunked", "arch": "jamba-v0.1-52b", "mamba_chunk": 5,
          "pattern": ["mamba+mlp", "mamba+moe", "mamba+mlp", "mamba+moe", "attn+mlp", "mamba+moe", "mamba+mlp",
                      "mamba+moe"],
          "hidden_size": 128, "intermediate_size": 256, "num_attention_heads": 4, "num_key_value_heads": 2,
          "num_experts": 4, "num_experts_per_tok": 2, "mamba_d_state": 8, "mamba_d_conv": 4, "mamba_expand": 2,
          "mamba_dt_rank": 8, "num_hidden_layers": 8, "vocab_size": 512, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
          "initializer_range": 0.02, "tie_word_embeddings": False, "torch_dtype": "float32"}
MAMBA = '''"""The port's selective-scan mixer, plain and sequential, in float32."""
import torch
import torch.nn.functional as F

matrices = ("wx", "wz", "w_dbc", "w_dt", "w_out")


def params(c):
    d, s = c["hidden_size"], c["initializer_range"]
    di, n, K, r = c["mamba_expand"] * d, c["mamba_d_state"], c["mamba_d_conv"], c["mamba_dt_rank"]
    return {"wx": ((d, di), s), "wz": ((d, di), s), "conv_w": ((di, K), 0.5), "conv_b": ((di,), 0.1),
            "w_dbc": ((di, r + 2 * n), s), "w_dt": ((r, di), 0.3), "dt_bias": ((di,), 0.1),
            "A_log": ((di, n), 0.5), "D": ((di,), 1.0), "w_out": ((di, d), s)}


def apply(c, p, x, w):
    n, r = c["mamba_d_state"], c["mamba_dt_rank"]
    xi = x @ w("wx", p["wx"])
    K = p["conv_w"].shape[1]
    pad = F.pad(xi, (0, 0, K - 1, 0))
    xi = F.silu(sum(pad[:, k:k + x.shape[1]] * p["conv_w"][:, k] for k in range(K)) + p["conv_b"])
    dbc = xi @ w("w_dbc", p["w_dbc"])
    dt = F.softplus(dbc[..., :r] @ w("w_dt", p["w_dt"]) + p["dt_bias"])
    B, C, A = dbc[..., r:r + n], dbc[..., r + n:], -torch.exp(p["A_log"])
    h = x.new_zeros(x.shape[0], xi.shape[-1], n)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + dt[:, t, :, None] * B[:, t, None, :] * xi[:, t, :, None]
        ys.append((h * C[:, t, None, :]).sum(-1) + p["D"] * xi[:, t])
    return (torch.stack(ys, 1) * F.silu(x @ w("wz", p["wz"]))) @ w("w_out", p["w_out"])
'''
MOE = '''"""Top-k experts with renormalised gates and no token dropped, float32."""
import torch
import torch.nn.functional as F

matrices = ("w_gate", "w_up", "w_down")


def params(c):
    d, f, E, s = c["hidden_size"], c["intermediate_size"], c["num_experts"], c["initializer_range"]
    return {"w_router": ((d, E), s), "w_gate": ((E, d, f), s), "w_up": ((E, d, f), s), "w_down": ((E, f, d), s)}


def apply(c, p, x, w):
    probs = (x @ p["w_router"]).softmax(-1)
    gate, idx = probs.topk(c["num_experts_per_tok"], dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    wg, wu, wd = w("w_gate", p["w_gate"]), w("w_up", p["w_up"]), w("w_down", p["w_down"])
    for e in range(probs.shape[-1]):
        mix = (gate * (idx == e)).sum(-1, keepdim=True)
        y = y + mix * ((F.silu(x @ wg[e]) * (x @ wu[e])) @ wd[e])
    return y
'''
PLANTED = '''"""The hybrid's own fault: a Mamba decode step that hands its state back
unchanged, so every later token reads the prefill's state."""
from repro_torch.models import mamba


def state_unchanged(real):
    def step(cfg, p, x, cache):
        return real(cfg, p, x, cache)[0], cache
    return step


FAULTS = {"mamba_state_unchanged": lambda mp: mp.setattr(mamba, "decode_mamba_step",
                                                         state_unchanged(mamba.decode_mamba_step))}
CASES = [("hybrid.chat", "mamba_state_unchanged")]
'''
NONE = {"overrides": {}, "why": "a test's sizes are tiny already"}
NEW = {
    "configs/tenants.json": TENANTS,
    "configs/ragged.json": RAGGED,
    "traffic/windows_recent.json": {**OPEN, "windows": {"kind": "recent", "lengths": [1, 7, 14, 31]}},
    "traffic/windows_mixed.json": {**OPEN, "windows": {"kind": "uniform"}, "ingest": {"every_s": 0.15, "mode": "async"}},
    "traffic/refresh_all.json": {**OPEN, "rate_per_s": 20, "tenants": {"kind": "all"}, "windows": {"kind": "newest"}},
    "limits/tenants.recent.json": {"limits": EXACT},
    "limits/tenants.mixed.json": {"limits": {"summary_mismatches": 0, **EXACT}},
    "limits/tenants.refresh_all.json": {"limits": EXACT},
    "limits/ragged.daily.json": {"limits": {"summary_mismatches": 0, **EXACT}},
    "configs/hybrid.json": HYBRID,
    "traffic/chat_batch.json": {"loop": "closed", "clients": 1, "batch": 6, "prompt_tokens": 12, "new_tokens": 8},
    # set from this tiny hybrid's readings (CPU, 12 seeds): the program's widest gap 0.0 (float32 both
    # sides), the control's narrowest 0.118 (one turn)
    "limits/hybrid.chat.json": {"limits": {"answers_malformed": 0, "token_gap_sd": 0.04}},
    **{f"tiny/configs/{n}.json": NONE for n in ("tenants", "ragged", "hybrid")},
    **{f"tiny/traffic/{n}.json": NONE for n in ("windows_recent", "windows_mixed", "refresh_all", "chat_batch")},
    **{f"tiny/limits/{n}.json": NONE for n in ("tenants.recent", "tenants.mixed", "tenants.refresh_all", "ragged.daily",
                                                "hybrid.chat")},
}
CELLS = {"tenants.recent": ("tenants", "windows_recent"), "tenants.mixed": ("tenants", "windows_mixed"),
         "tenants.refresh_all": ("tenants", "refresh_all"), "ragged.daily": ("ragged", "daily_publish"),
         "hybrid.chat": ("hybrid", "chat_batch")}
# each end-to-end metric -> the new cells that report it, appended to its workloads
REPORTS = {"answer_p50_ms": ["tenants.recent", "tenants.mixed", "tenants.refresh_all"],
           "ingest_values_per_s": ["ragged.daily"], "output_tokens_per_s": ["hybrid.chat"]}
METRIC = '''def read(run):
    c = run["counters"]
    return c["host_row_copies"] / c["requests"] if c.get("requests") else None
'''
# a reader of a program span's total, which the engine's adapter passes through its counters
SPAN_METRIC = '''def read(run):
    c = run["counters"]
    ns = c.get("span_ns.engine.generate")
    return ns / c["turns"] / 1e6 if ns and c.get("turns") else None
'''
# an adapter of the kind a configuration brings where its architecture needs a port option that
# systems/engine.py does not set (its _FIELDS map onto a ModelConfig held equal to the JAX package's)
ADAPTER = '''"""The hybrid's adapter: ``systems/engine.py``'s, with the selective
scan's prefill chunk (``mamba_chunk``), a port option that adapter does
not set, taken from the configuration."""
import dataclasses

from hbench.systems import engine
from repro_torch.serve import Engine, ServeConfig

KIND = "model"


def port_config(cfg):
    return dataclasses.replace(engine.port_config(cfg), mamba_chunk=int(cfg["mamba_chunk"]))


class System(engine.System):
    def __init__(self, cfg, traffic, params, device):
        prompt, new = int(traffic["prompt_tokens"]), int(traffic["new_tokens"])
        scfg = ServeConfig(max_seq=prompt + new, max_new_tokens=new, temperature=0.0,
                           eos_id=int(cfg["vocab_size"]), cache_dtype=cfg["torch_dtype"])
        self.engine = Engine(port_config(cfg), params, scfg, device=device)
'''
CODE = {"reference/layers/hybrid/mamba.py": MAMBA, "reference/layers/hybrid/moe.py": MOE,
        "systems/hybrid_chunked.py": ADAPTER, "planted/hybrid.py": PLANTED,
        "metrics/host_row_copies_per_request.query.py": METRIC, "metrics/generate_ms_per_turn.serve.py": SPAN_METRIC}
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(harness.HERE, os.path.join(root, "hbench"), ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.with_deferred(harness.load_bench())
    for rel, body in {**NEW, **CODE}.items():
        path = os.path.join(root, "hbench", rel)
        assert not os.path.exists(os.path.join(harness.HERE, rel)), rel
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            if rel.endswith(".py"):
                f.write(body)
            else:
                json.dump(body, f)
    bench["configs"] += [{"name": n, "source": "a test", "file": f"hbench/configs/{n}.json", "reduced": [], "why": "a test"}
                         for n in ("tenants", "ragged", "hybrid")]
    bench["workloads"] += [{"name": w, "config": c, "traffic": t, "chips": 1, "why": "a test"} for w, (c, t) in CELLS.items()]
    for m in bench["end_to_end"]:
        m.get("workloads", []).extend(REPORTS.get(m["name"], []))
    bench["per_layer"] = [
        {"name": "host_row_copies_per_request.query", "unit": "copies", "better": "lower", "source": "program_counter",
         "layer": "interval tree", "moves": "answer_p50_ms", "workloads": ["tenants.recent"]},
        {"name": "generate_ms_per_turn.serve", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "serving engine", "moves": "output_tokens_per_s", "workloads": ["hybrid.chat"]},
        *[m for m in bench["per_layer"] if m["name"] == "cache_hit_share.query"],
    ]
    bench["per_layer"][-1]["workloads"] = ["tenants.recent"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run(root, name, control=False, trace=False):
    return run_tiny(name, control, seed=SEED, trace=trace, bench=harness.load_bench(root), root=root)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_cell_of_new_files_runs_correct(root, name):
    out = run(root, name)
    check_program(out, name, harness.load_bench(root))
    assert set(out["checks"]) == set(harness.cell_limits(name, root))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_cell_of_new_files_fails_its_control(root, name):
    check_control(run(root, name, control=True))


def test_a_fault_a_new_configuration_plants_is_not_correct(root, monkeypatch):
    plants, cases = faults.planted(root)
    assert cases == [("hybrid.chat", "mamba_state_unchanged")]
    for name, fault in cases:
        with monkeypatch.context() as mp:
            out = planted_run(mp, name, fault, plants, harness.load_bench(root), root)
        assert out["failed"] == 0 and not out["correct"], out


def test_a_new_reader_reads_a_program_span_the_engines_adapter_passes_through(root, monkeypatch):
    from repro_torch.core import spans
    from repro_torch.serve import Engine

    monkeypatch.setitem(spans.SPANS, "engine.generate", "one generate call")
    monkeypatch.setitem(spans._SPAN_TOTALS, "engine.generate", [0, 0, 0])
    real = Engine.generate

    def generate(self, *args, **kw):
        with spans.span("engine.generate"):
            return real(self, *args, **kw)

    monkeypatch.setattr(Engine, "generate", generate)
    out = run(root, "hybrid.chat", trace=True)
    assert out["correct"], out
    assert set(out["metrics"]) == {"generate_ms_per_turn.serve"}
    assert out["metrics"]["generate_ms_per_turn.serve"]["value"] > 0


def test_the_copy_edits_no_file_of_the_original(root):
    for folder, dirs, files in os.walk(harness.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            original = os.path.join(folder, name)
            assert filecmp.cmp(original, os.path.join(root, "hbench", os.path.relpath(original, harness.HERE)),
                               shallow=False), original


def test_a_new_metric_reads_a_program_counter_the_adapter_passes_through(root):
    out = run(root, "tenants.recent", trace=True)
    assert out["correct"], out
    assert out["metrics"]["host_row_copies_per_request.query"]["value"] == 0.0  # the shared arena gathers on the device
    assert out["metrics"]["cache_hit_share.query"]["value"] > 25.0  # the newest windows repeat: the cache answers


def test_windows_follow_the_newest_partition_while_ingest_runs_beside_them(root, monkeypatch):
    fed, judged = [], []
    ingest, judge = harness._ingest, harness.Reference.judge_answers
    monkeypatch.setattr(harness, "_ingest", lambda sysobj, pool, d, *a: (fed.append(d), ingest(sysobj, pool, d, *a)))
    monkeypatch.setattr(harness.Reference, "judge_answers", lambda self, ans: (judged.extend(ans), judge(self, ans))[1])
    out = run(root, "tenants.mixed")
    assert out["correct"] and "summary_mismatches" in out["checks"], out
    assert fed == list(range(31, 31 + len(fed))) and len(fed) >= 3  # set-up filled ids 0..30
    newest = fed[-1]
    assert max(hi for _, _, hi, *_ in judged) == newest  # the month asked after the window
    assert all(newest - 30 <= lo for _, lo, *_ in judged[-5:])
    assert min(lo for _, lo, *_ in judged) < newest - 30 + 1  # earlier answers were of earlier months


def test_a_served_configurations_own_adapter_sets_a_port_option_engine_py_does_not(root, monkeypatch):
    from hbench.systems import engine
    from repro_torch.models import mamba

    chunks, real = [], mamba._chunk
    monkeypatch.setattr(mamba, "_chunk", lambda cfg, p, s, d, h, x1_c: (chunks.append(x1_c.shape[1]), real(
        cfg, p, s, d, h, x1_c))[1])
    out = run(root, "hybrid.chat")
    check_program(out, "hybrid.chat", harness.load_bench(root))
    assert engine.port_config(HYBRID).mamba_chunk != HYBRID["mamba_chunk"]  # the shared adapter leaves it
    assert set(chunks) == {5, 2}  # 12-token prompts: two chunks of 5 and a tail of 2 in every Mamba layer


def test_a_configurations_own_layer_parts_come_before_the_shared_ones(tmp_path):
    layers = tmp_path / "layers"
    (layers / "hybrid").mkdir(parents=True)
    for part in ("attn", "mlp"):
        shutil.copy(os.path.join(harness.HERE, "reference", "layers", part + ".py"), layers / (part + ".py"))
    for part, body in (("mamba", MAMBA), ("moe", MOE)):
        (layers / "hybrid" / (part + ".py")).write_text(body)
        (layers / (part + ".py")).write_text(body + "\n\ndef apply(c, p, x, w):\n    raise LookupError('shared')\n")
    tokens = torch.arange(12).reshape(2, 6) * 37 % HYBRID["vocab_size"]
    own = Decoder(HYBRID, str(layers))
    assert {n: os.path.relpath(m.__file__, layers) for n, m in own.parts.items()} == {
        "attn": "attn.py", "mlp": "mlp.py", "mamba": os.path.join("hybrid", "mamba.py"),
        "moe": os.path.join("hybrid", "moe.py")}
    assert torch.isfinite(own.logits(own.make_params(3, "cpu"), tokens, 0)).all()
    other = Decoder({**HYBRID, "name": "other"}, str(layers))
    assert {n: os.path.relpath(m.__file__, layers) for n, m in other.parts.items()} == {
        n: n + ".py" for n in ("attn", "mlp", "mamba", "moe")}
    with pytest.raises(LookupError, match="shared"):
        other.logits(other.make_params(3, "cpu"), tokens, 0)
