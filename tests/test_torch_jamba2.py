"""AI21-Jamba2-Mini's port options (``repro_torch.configs.options``) against
the benchmark's plain float32 reference (``hbench/reference/model.py``
with the published parts ``hbench/reference/layers/{attn,mlp,mamba,moe}.py``),
at the configuration's tiny sizes (``hbench/tiny/configs/jamba2_mini.json``:
smoke widths, one period of 8 layers, float32) on seeded random weights,
served through the cell's own adapter (``hbench/systems/jamba2_mini.py``).

Tolerance: both sides are float32, TF32 off, and differ in the order of
their sums only: the port's chunked associative scan against the
reference's token-by-token recurrence, its grouped expert products and
batched gate sum against the reference's expert-by-expert products and
``index_add_``.  So logits and layer outputs agree to ``TOL`` of their
largest magnitude; the differences each option makes are many times that.

Beside them, the faults that put back a departure the options remove
(``hbench/planted/jamba2_mini.py``): each turns the tiny cell
``jamba2_mini.offline``'s run not correct, as do ``hbench/faults.py``'s
two KV-cache faults; and the cell's two readers of what the port adds
(``moe_rows_per_routed_token.serve``, ``mamba_scan.roofline.serve``).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hbench import faults, harness, tiny
from hbench.reference.model import Decoder, part_file
from repro_torch.configs import get_config, smoke
from repro_torch.configs.options import PortConfig, option, with_options
from repro_torch.core import spans
from repro_torch.models import decode_step, init_cache, init_model, mamba, model, moe, prefill

CELL = "jamba2_mini.offline"
LAYERS = os.path.join(harness.HERE, "reference", "layers")
TOL = 2e-5  # of the largest magnitude compared: float32 sums in another order
SEED = 2**31 + 351


def tiny_config() -> dict:
    cell, cfg, _ = harness.cell_parts(harness.load_bench(), CELL)
    return {**cfg, **tiny.overrides(cell)["config"]}


ADAPTER = harness.load_module(os.path.join(harness.HERE, "systems", "jamba2_mini.py"))
CFG = tiny_config()
PORT = ADAPTER.port_config(CFG)
DEC = Decoder(CFG, LAYERS)


def reference_part(name: str):
    return harness.load_module(part_file(LAYERS, CFG["name"], name))


def close(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference as a share of ``want``'s largest magnitude."""
    return float((got - want).abs().max() / want.abs().max())


def served_logits(cfg, params, tokens: torch.Tensor, prompt: int) -> torch.Tensor:
    """The prefill's last logits, then each teacher-forced decode step's,
    through the caches: ``(n, S - prompt + 1, V)`` for positions
    ``prompt - 1`` to ``S - 1``."""
    n, S = tokens.shape
    with torch.no_grad():
        logits, cache = prefill(cfg, params, {"tokens": tokens[:, :prompt]}, init_cache(cfg, n, S, torch.float32, "cpu"))
        out = [logits[:, -1]]
        for pos in range(prompt, S):
            logits, cache = decode_step(cfg, params, cache, tokens[:, pos:pos + 1], pos)
            out.append(logits[:, -1])
    return torch.stack(out, 1)


@pytest.fixture(autouse=True)
def one_host_thread():
    """One host thread for torch, as ``hbench/run.py`` runs: these tests'
    many small operations slow many times over where several test workers'
    thread pools share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    return DEC.make_params(SEED, "cpu")


def tokens(n=3, S=14, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, CFG["vocab_size"], (n, S)))


def test_the_adapter_sets_the_published_options_and_refuses_what_the_port_cannot_express():
    assert isinstance(PORT, PortConfig) and PORT.pattern == get_config("jamba-v0.1-52b").pattern
    assert (PORT.positions, PORT.use_rope, PORT.mamba_dbc_norm, PORT.moe_renormalize, PORT.moe_dispatch) == (
        "none", False, True, False, "dropless")
    assert PORT.mamba_chunk == CFG["mamba_chunk"] and PORT.mamba_scan_dtype == "float32"
    for bad in ({"mamba_dt_rank": 7}, {"mamba_conv_bias": False}, {"mamba_proj_bias": True}, {"rope_theta": 1e4}):
        with pytest.raises(ValueError):
            ADAPTER.port_config({**CFG, **bad})
    with pytest.raises(ValueError, match="use_rope"):
        with_options(PORT, use_rope=True)


def test_prefill_then_decode_gives_the_reference_logits_at_every_position(weights):
    """Prefill 8 tokens, then decode 6 through the caches (the Mamba state
    and convolution tail, the KV cache of the attention layer): each
    position's logits are the reference's full forward's."""
    toks = tokens()
    with torch.no_grad():
        want = DEC.logits(weights, toks[:, :-1], 7)
    got = served_logits(PORT, weights, toks[:, :-1], 8)
    assert got.shape == want.shape
    assert close(got, want) < TOL


@pytest.mark.parametrize("renormalize", [True, False])
def test_the_dropless_dispatch_equals_the_capacity_dispatch_where_neither_drops(renormalize):
    """At capacity E/k every expert has a place for every token of its
    group, so neither dispatch drops: the same routing, and the same
    output up to the order of the sums; with no group padded (16 tokens
    in groups of 8), the same load-balance sums."""
    base = with_options(smoke(get_config("jamba-v0.1-52b")), moe_renormalize=renormalize,
                        moe_capacity_factor=2.0, moe_group_size=8)
    p = init_model(base, torch.Generator().manual_seed(3))["blocks"][1]["ffn"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((2, 16, base.d_model), generator=torch.Generator().manual_seed(4))
    y_cap, a_cap = moe.apply_moe(base, p, x)
    y_drop, a_drop = moe.apply_moe(dataclasses.replace(base, moe_dispatch="dropless"), p, x)
    assert float(a_cap["moe_drop_fraction"]) == 0.0 and float(a_drop["moe_drop_fraction"]) == 0.0
    assert torch.equal(a_cap["routing"], a_drop["routing"])
    assert close(y_drop, y_cap) < TOL
    for key in ("moe_load_balance", "moe_router_z", "prob_sum", "route_sum"):
        torch.testing.assert_close(a_drop[key], a_cap[key])


def test_an_expert_layer_equals_the_published_part(weights):
    p = {k: v[0] for k, v in weights["blocks"][1]["ffn"].items()}
    x = torch.randn((3, 11, CFG["hidden_size"]), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got, aux = moe.apply_moe(PORT, p, x)
        want = reference_part("moe").apply(CFG, p, x, lambda n, t: t)
    assert close(got, want) < TOL
    assert aux["routing"].min() >= 0  # nothing dropped


@pytest.mark.parametrize("chunk", [1, 5, 12])
def test_the_mamba_mixer_with_its_norms_equals_the_published_part(weights, chunk):
    """Chunks of one token, of 5 (two and a tail of 2) and the whole
    12-token sequence; the state it ends with carries a decode step to the
    reference's next output."""
    cfg = dataclasses.replace(PORT, mamba_chunk=chunk)
    p = {k: v[0] for k, v in weights["blocks"][0]["mixer"].items()}
    x = torch.randn((2, 13, CFG["hidden_size"]), generator=torch.Generator().manual_seed(6))
    part = reference_part("mamba")
    with torch.no_grad():
        want = part.apply(CFG, p, x, lambda n, t: t)
        y, state = mamba.prefill_mamba(cfg, p, x[:, :12])
        step, _ = mamba.decode_mamba_step(cfg, p, x[:, 12:], state)
    assert close(y, want[:, :12]) < TOL
    assert close(step, want[:, 12:]) < TOL


OPTIONS = {"positions": "default", "mamba_dbc_norm": False, "moe_renormalize": True, "moe_dispatch": "capacity"}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_each_option_changes_the_served_logits_or_only_the_route_to_them(weights, name):
    """Each option switched back to the registry's default: positions,
    the norms and the gates move the logits far past ``TOL``; the
    capacity dispatch at E/k serves the dropless dispatch's logits."""
    other = dataclasses.replace(PORT, **{name: OPTIONS[name]})  # positions: sinusoidal, with use_rope off
    toks = tokens(seed=1)
    want = served_logits(PORT, weights, toks, 9)
    got = served_logits(other, weights, toks, 9)
    if name == "moe_dispatch":
        assert close(got, want) < TOL
    else:
        assert close(got, want) > 1000 * TOL


FAMILIES = ["qwen3-8b", "dbrx-132b", "jamba-v0.1-52b", "rwkv6-7b", "whisper-medium", "pixtral-12b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_a_registry_config_serves_the_same_bits_with_the_options_at_their_defaults(arch):
    """One config of each family: the ``PortConfig`` with every option at
    its default serves the plain ``ModelConfig``'s logits, bit for bit."""
    cfg = smoke(get_config(arch))
    assert all(option(cfg, n) == getattr(with_options(cfg), n) for n in OPTIONS)
    params = init_model(cfg, torch.Generator().manual_seed(7))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10)))
    batch = {"tokens": toks[:, :8]}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((2, cfg.encoder_seq, cfg.d_model))
    got = []
    for c in (cfg, with_options(cfg)):
        with torch.no_grad():
            logits, cache = prefill(c, params, dict(batch), init_cache(c, 2, 10, torch.float32, "cpu"))
            step, _ = decode_step(c, params, cache, toks[:, 8:9], 8)
        got.append((logits, step))
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])


class NoHostRead(TorchDispatchMode):
    """Refuses every read of a tensor's value on the host (``.item()``,
    ``int``, ``bool``, ``.tolist()``), which a CUDA graph's capture refuses
    too, and which would add a device-to-host copy to a served turn."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a value read on the host")
        return func(*args, **(kwargs or {}))


def test_the_prefill_and_a_decode_step_read_no_value_on_the_host(weights):
    toks = tokens(n=2, S=10, seed=3)
    cache = init_cache(PORT, 2, 10, torch.float32, "cpu")
    pos = torch.full((), 8, dtype=torch.int32)
    with torch.no_grad(), NoHostRead():
        _, cache = prefill(PORT, weights, {"tokens": toks[:, :8]}, cache)
        decode_step(PORT, weights, cache, toks[:, 8:9], pos)


@pytest.mark.parametrize("dispatch,rows", [("dropless", 1.0), ("capacity", 2.0)])
def test_the_expert_layers_count_their_routed_slots_and_computed_rows(weights, dispatch, rows):
    """``moe.expert_rows / moe.routed_slots``: 1 for the dropless dispatch;
    E/k = 2 for the capacity dispatch at E/k, whose every expert holds a
    place for every token (groups of 8: a 16-token prompt pads nothing)."""
    cfg = dataclasses.replace(PORT, moe_dispatch=dispatch, moe_group_size=8)
    s0 = spans.snapshot()
    with torch.no_grad():
        prefill(cfg, weights, {"tokens": tokens(n=2, S=16, seed=4)}, init_cache(cfg, 2, 16, torch.float32, "cpu"))
    d = {k: v - s0[k] for k, v in spans.snapshot().items()}
    moe_layers = sum(1 for kind in cfg.pattern if kind.endswith("moe")) * cfg.repeats
    mamba_layers = sum(1 for kind in cfg.pattern if kind.startswith("mamba")) * cfg.repeats
    assert d["moe.routed_slots"] == moe_layers * 2 * 16 * cfg.num_experts_per_token
    assert d["moe.expert_rows"] == rows * d["moe.routed_slots"]
    assert d["span_calls.model.moe"] == moe_layers
    assert d["span_calls.model.mamba"] == d["span_calls.mamba.scan"] == mamba_layers


# ---- faults: each departure the options remove, put back ------------------------------------------


FAULTS = harness.load_module(os.path.join(harness.HERE, "planted", "jamba2_mini.py")).FAULTS
KV_FAULTS = ("kv_one_position_off", "kv_cache_unwritten")


def tiny_run(trace=False, seed=987654321):
    bench = harness.load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    return harness.run_cell(CELL, seed, 0.6, trace, device="cpu", overrides=tiny.overrides(cell), bench=bench)


def test_the_planted_faults_are_found_beside_the_shared_ones():
    plants, cases = faults.planted()
    assert set(FAULTS) | set(KV_FAULTS) <= set(plants)
    assert all(name != CELL for name, _ in cases)  # run here, at the tiny size


@pytest.mark.parametrize("fault", [*FAULTS, *KV_FAULTS])
def test_a_fault_of_the_jamba_cell_is_not_correct(monkeypatch, fault):
    faults.planted()[0][fault](monkeypatch)
    out = tiny_run()
    assert out["failed"] == 0 and not out["correct"], out


def test_the_full_size_limit_lies_between_its_sound_readings_and_the_control_and_faults():
    """The limits file keeps every reading it was set from: the limit is
    past the widest sound run and short of the control and every planted
    fault.  The KV-cache faults' readings are kept too: at the full size
    they fall among the sound runs' (PERF.md section 2)."""
    with open(harness.part_path(harness.ROOT, "limits", CELL, ".json")) as f:
        limits = json.load(f)
    gap = limits["readings"]["token_gap_sd"]
    assert gap["program_max"] < limits["limits"]["token_gap_sd"] < min(
        gap["control_min"], *(gap[f + "_min"] for f in FAULTS))
    assert all(f + "_min" in gap for f in KV_FAULTS)


# ---- the cell's readers ------------------------------------------------------------------------------


def reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py")).read


def test_a_traced_tiny_run_reads_one_row_a_routed_slot_through_the_adapters_counters():
    """On the CPU the trace is off, so the scan's roofline reads nothing;
    the counters pass through the adapter, the prefill's and every decode
    step's."""
    out = tiny_run(trace=True)
    assert out["correct"], out
    assert out["metrics"]["moe_rows_per_routed_token.serve"]["value"] == 1.0
    assert "mamba_scan.roofline.serve" not in out["metrics"]


@pytest.mark.parametrize("rows,want", [(4 * 2 * 16 * 2, 1.0), (4 * 2 * 16 * 4, 2.0), (None, None)])
def test_the_rows_a_slot_reader(rows, want):
    counters = {"moe.routed_slots": 4 * 2 * 16 * 2}
    if rows is not None:
        counters["moe.expert_rows"] = rows
    run = {"config": CFG, "traffic": {}, "trace": None, "counters": counters}
    assert reader("moe_rows_per_routed_token.serve")(run) == want
    assert reader("moe_rows_per_routed_token.serve")({**run, "counters": {**counters, "moe.routed_slots": 0}}) is None


def _scan_turn(spans_of):
    """A synthetic traced turn of 2 rows of 24 tokens and 3 new ones:
    the prefill from 5 µs to the first copy's end at 105 µs, then two
    steps; ``spans_of`` names each device interval's program span."""
    d2h = "Memcpy DtoH (Device -> Pageable)"
    device = [("scan_a", "kernel", 10.0, 30.0, "hbench.turn"), ("scan_b", "kernel", 30.0, 40.0, "hbench.turn"),
              ("proj", "kernel", 40.0, 80.0, "hbench.turn"), (d2h, "gpu_memcpy", 90.0, 105.0, "hbench.turn"),
              ("scan_c", "kernel", 110.0, 150.0, "hbench.turn"), (d2h, "gpu_memcpy", 195.0, 205.0, "hbench.turn"),
              (d2h, "gpu_memcpy", 295.0, 305.0, "hbench.turn")]
    tr = {"stretch": (0.0, 1000.0), "busy_us": 400.0, "spans": [(5.0, 900.0, "hbench.turn")], "device": device,
          "program_spans": spans_of}
    cfg = {**CFG, "torch_dtype": "bfloat16"}
    return {"config": cfg, "traffic": {"batch": 2, "prompt_tokens": 24, "new_tokens": 3}, "counters": {},
            "trace": tr, "platform": "gpu"}


def test_the_scan_roofline_reads_the_prefills_work_under_the_scan_span():
    from hbench import cost

    read = reader("mamba_scan.roofline.serve")
    # the first two kernels under the span in the prefill (30 µs); the third after the first copy
    run = _scan_turn(["mamba.scan", "mamba.scan", "model.mamba", None, "mamba.scan", None, None])
    di, n, r = 2 * CFG["hidden_size"], CFG["mamba_d_state"], CFG["mamba_dt_rank"]
    layer = 2 * 2 * 24 * di * 2 + (di * (r + 2 * n) + r * di) * 2 + 2 * di * n * 4
    assert read(run) == pytest.approx(100 * cost.least_seconds(7 * layer) / 30e-6)
    assert read(_scan_turn([None] * 7)) is None  # a program without the span
    run["trace"]["device"] = run["trace"]["device"][:-1]  # a copy lost: no whole turn
    assert read(run) is None
