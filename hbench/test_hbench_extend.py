"""The harness takes new cells, mixes, configurations and metrics as new
files alone: a copy of ``hbench/`` gets only files it did not have (and a
``BENCHMARK.json`` with their entries), and each new cell runs correct on
the port's ``device="cpu"`` path at a tiny size, its control not.  Among
them is a served hybrid model (``jamba-v0.1-52b`` at the port's smoke
widths: Mamba, attention and MoE layers in one period), whose reference
brings its two new layer parts as files of their own."""
import json
import os
import shutil

import pytest

from hbench import harness

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
# rounding), with RoPE at the port's default theta, which the plain attention then applies too
HYBRID = {"name": "hybrid", "system": "engine", "arch": "jamba-v0.1-52b",
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
}
CODE = {"reference/layers/mamba.py": MAMBA, "reference/layers/moe.py": MOE}
CELLS = {"tenants.recent": ("tenants", "windows_recent"), "tenants.mixed": ("tenants", "windows_mixed"),
         "tenants.refresh_all": ("tenants", "refresh_all"), "ragged.daily": ("ragged", "daily_publish"),
         "hybrid.chat": ("hybrid", "chat_batch")}
METRIC = '''def read(run):
    c = run["counters"]
    return c["host_row_copies"] / c["requests"] if c.get("requests") else None
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(harness.HERE, os.path.join(root, "hbench"), ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.with_deferred(harness.load_bench())
    for rel, body in NEW.items():
        assert not os.path.exists(os.path.join(harness.HERE, rel)), rel
        with open(os.path.join(root, "hbench", rel), "w") as f:
            json.dump(body, f)
    for rel, body in {os.path.join("metrics", "host_row_copies_per_request.query.py"): METRIC, **CODE}.items():
        assert not os.path.exists(os.path.join(harness.HERE, rel)), rel
        with open(os.path.join(root, "hbench", rel), "w") as f:
            f.write(body)
    bench["configs"] += [{"name": n, "source": "a test", "file": f"hbench/configs/{n}.json", "reduced": [], "why": "a test"}
                         for n in ("tenants", "ragged", "hybrid")]
    bench["workloads"] += [{"name": w, "config": c, "traffic": t, "chips": 1, "why": "a test"} for w, (c, t) in CELLS.items()]
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    bench["per_layer"] = [
        {"name": "host_row_copies_per_request.query", "unit": "copies", "better": "lower", "source": "program_counter",
         "layer": "interval tree", "moves": "answer_p50_ms", "workloads": ["tenants.recent"]},
        *[m for m in bench["per_layer"] if m["name"] == "cache_hit_share.query"],
    ]
    bench["per_layer"][-1]["workloads"] = ["tenants.recent"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run(root, name, control=False, trace=False):
    over = {"traffic": {"beta": 16}} if name == "ragged.daily" else {}
    return harness.run_cell(name, 2**31 + 77, 0.6, trace, device="cpu", control=control, overrides=over, root=root)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_cell_of_new_files_runs_correct(root, name):
    out = run(root, name)
    assert out["correct"] and out["failed"] == 0, out
    assert set(out["checks"]) == set(harness.cell_limits(name, root))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_cell_of_new_files_fails_its_control(root, name):
    out = run(root, name, control=True)
    assert out["failed"] == 0 and not out["correct"], out


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
