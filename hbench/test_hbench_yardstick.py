"""The frozen yardstick: byte and operation counts, the trace's union,
the percentiles, the served model's readers."""
import json
import os
import time

import numpy as np
import pytest

from hbench import cost, harness, trace
from hbench.data import Pool
from hbench.reference.exact import tree_eps_bound


def test_row_sort_bytes_count_real_values_not_padding():
    n = 161_290_322  # floor(5e9 / 31), padded by the program to 2^28
    assert cost.row_sort_bytes(n, 2032) == 4 * n + 4 * 2033


def test_canonical_nodes_match_a_brute_force_cover():
    for lo in range(40):
        for hi in range(lo, 40):
            need, l = 0, lo
            while l <= hi:  # greedy largest aligned block from the left
                size = 1
                while l % (2 * size) == 0 and l + 2 * size - 1 <= hi:
                    size *= 2
                need += 1
                l += size
            assert cost.canonical_nodes(lo, hi) == need


def test_busy_time_is_the_union_not_the_sum():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert sum(e - s for s, e in iv) == 31
    assert trace.union_seconds(iv, 0, 40) == 25
    assert trace.union_seconds(iv, 8, 22) == 9
    assert trace.gaps(iv, 0, 40) == [(15, 20), (30, 40)]


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_parse_tags_device_work_with_the_span_that_launched_it():
    t = {"traceEvents": [
        _ev("hbench.stretch", "user_annotation", 0, 100),
        _ev("hbench.ingest", "user_annotation", 0, 50),
        _ev("hbench.query", "user_annotation", 60, 30),
        _ev("cudaMemcpyAsync", "cuda_runtime", 1, 1, correlation=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 61, 1, correlation=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 70, 1, correlation=4),  # lost: no device record
        _ev("aten::copy_", "cpu_op", 30, 20),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5, 15, tid=7, correlation=1),
        _ev("void hk::onesweep_kernel<false, false>", "kernel", 15, 20, tid=7, correlation=2),
        _ev("void hk::resident_merge_kernel<8, 4>", "kernel", 65, 5, tid=7, correlation=3),
    ]}
    p = trace.parse(t)
    assert p["stretch"] == (0.0, 100.0) and p["lost"] == 1
    assert p["busy_us"] == 30 + 5  # copy and sort overlap 5 µs: counted once
    spans = {name: span for name, _, _, _, span in p["device"]}
    assert spans["void hk::onesweep_kernel<false, false>"] == "hbench.ingest"
    assert spans["void hk::resident_merge_kernel<8, 4>"] == "hbench.query"
    gaps = dict(p["breakdown"]["idle_gaps"])
    assert gaps["hbench.ingest > aten::copy_"] == pytest.approx(30e-6)
    assert [k for k, _ in p["breakdown"]["device_ops"]][0].startswith("void hk::onesweep")


def test_parse_tags_device_work_with_the_innermost_program_span_of_the_launching_thread():
    t = {"traceEvents": [
        _ev("hbench.stretch", "user_annotation", 0, 100),
        _ev("hbench.ingest", "user_annotation", 0, 60),
        _ev("store.ingest", "user_annotation", 1, 50),
        _ev("store.pad", "user_annotation", 1, 1),  # starts with store.ingest, inside it
        _ev("store.h2d", "user_annotation", 3, 10),
        _ev("store.sort", "user_annotation", 20, 10),
        _ev("pool.worker", "user_annotation", 0, 100, tid=2),  # another thread's span
        _ev("cudaMemsetAsync", "cuda_runtime", 1.5, 0.2, correlation=1),
        _ev("cudaMemcpyAsync", "cuda_runtime", 4, 1, correlation=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 21, 1, correlation=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 40, 1, correlation=4),
        _ev("cudaLaunchKernel", "cuda_runtime", 70, 1, correlation=5),
        _ev("Memset (Device)", "gpu_memset", 2, 1, tid=7, correlation=1),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5, 15, tid=7, correlation=2),
        _ev("void hk::onesweep_kernel<false, false>", "kernel", 22, 5, tid=7, correlation=3),
        _ev("void hk::gather_cuts_kernel", "kernel", 41, 2, tid=7, correlation=4),
        _ev("void hk::resident_merge_kernel<8, 4>", "kernel", 71, 5, tid=7, correlation=5),
    ]}
    p = trace.parse(t)
    assert all(len(d) == 5 for d in p["device"]) and len(p["program_spans"]) == len(p["device"])
    got = [(d[0].split()[0], d[4], ps) for d, ps in zip(p["device"], p["program_spans"])]
    assert got == [("Memset", "hbench.ingest", "store.pad"), ("Memcpy", "hbench.ingest", "store.h2d"),
                   ("void", "hbench.ingest", "store.sort"), ("void", "hbench.ingest", "store.ingest"),
                   ("void", None, None)]  # the last launched outside any span of its thread


def test_roofline_readers_on_a_synthetic_trace():
    tr = {"stretch": (0.0, 1e6), "busy_us": 0.0, "ingest_ns": [1000, 3000],
          "query_batches": [([(0, 0, 30), (0, 3, 4)], 1)],
          "device": [("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0.0, 20.0, "hbench.ingest"),
                     ("void hk::onesweep_kernel<false, false>", "kernel", 0.0, 10.0, "hbench.ingest"),
                     ("void hk::resident_merge_kernel<8, 4>", "kernel", 0.0, 4.0, "hbench.ingest"),
                     ("void hk::resident_merge_kernel<8, 4>", "kernel", 20.0, 30.0, "hbench.query")]}
    run = {"config": {"num_buckets": 16}, "traffic": {"beta": 4}, "counters": {}, "trace": tr}
    load = lambda n: harness.load_module(f"{harness.HERE}/metrics/{n}.py").read(run)
    sort = load("row_sort.roofline.ingest")
    assert sort == pytest.approx(100 * cost.least_seconds(4 * 4000 + 2 * 4 * 17) / 10e-6)
    merge = load("merge_cut.roofline.query")  # one miss: the window with the fewest nodes, [3, 4]
    assert merge == pytest.approx(100 * cost.least_seconds(cost.merge_bytes(2, 16, 4)) / 10e-6)
    assert load("h2d_ms_per_gvalue.ingest") == pytest.approx(20e-3 / 4000e-9)  # 20 µs for 4,000 values
    tr["busy_us"] = 2.5e5
    assert load("device_idle.ingest") == load("device_idle.query") == pytest.approx(75.0)


def test_eps_bound_is_the_worst_alignment():
    # one leaf: exact, the bound is the top-level term alone
    assert tree_eps_bound([100], 10) == pytest.approx(2 * 100 / 10 + 2)
    # two leaves aligned on a pair make one node; unaligned, two leaves
    aligned = (2 * 200 / 10 + 4) + 2 * 200 / 10 + 2
    assert tree_eps_bound([100, 100], 10) == pytest.approx(max(aligned, 2 * 200 / 10 + 4))


class _Stalling:
    """An answering system that stalls once, for ``stall`` seconds."""

    def __init__(self, stall):
        self.stall = stall

    def query_many(self, batch, beta):
        if self.stall:
            time.sleep(self.stall)
            self.stall = 0.0
        return [(np.zeros(beta + 1), np.ones(beta), 1.0)] * len(batch)

    def counters(self):
        return {"cache_misses": 0}


def _p95(stall):
    rec = harness.new_record()
    pool = Pool(np.zeros(1, np.float32), np.ones((1, 1), np.int64))
    traffic = {"fill": {"days": 31}, "rate_per_s": 400, "tenants": {"kind": "one"}, "windows": {"kind": "uniform"},
               "days": 31, "beta": 4, "check_answers": 0}
    harness._open_loop(_Stalling(stall), pool, traffic, 1.0, 5, trace.Tracer(False, 0, 0), rec)
    assert rec["failed"] == 0 and rec["latency_s"].size == rec["attempted"] > 300
    return harness.percentile_ms(rec["latency_s"], 95)


def test_a_stall_moves_p95_because_every_request_counts():
    assert _p95(0.3) - _p95(0.0) > 100.0


QWEN = json.load(open(os.path.join(harness.HERE, "configs", "qwen3_8b.json")))


def test_model_operations_and_bytes_match_a_hand_count():
    from hbench import model_cost as mc

    attn = 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096  # q, k and v (8 heads of 128), out
    mlp = 3 * 4096 * 12288
    P, U = 36 * (attn + mlp), 151936 * 4096
    assert mc.token_params(QWEN) == P == 6_945_767_424 and mc.unembed_params(QWEN) == U
    assert P + 2 * U == 8_190_427_136  # Qwen3-8B's 8.19 B, less its norms
    # two prompts of 3 tokens: the layers at 3 positions, causal attention over 1 + 2 + 3, logits at the last
    assert mc.prefill_flops(QWEN, 2, 3) == 2 * (2 * 3 * P + 4 * 4096 * 36 * 6 + 2 * U)
    # a step at position 9 sees 10 positions; it reads every weight and 10 positions of 36 layers' K and V
    assert mc.decode_flops(QWEN, 4, 9) == 4 * (2 * (P + U) + 4 * 4096 * 36 * 10)
    assert mc.decode_bytes(QWEN, 4, 9, "bfloat16") == 2 * (P + U) + 36 * 2 * 4 * 10 * 8 * 128 * 2
    assert mc.turn_flops(QWEN, 4, 5, 3) == mc.prefill_flops(QWEN, 4, 5) + mc.decode_flops(QWEN, 4, 5) + \
        mc.decode_flops(QWEN, 4, 6)


def test_hybrid_layer_parts_match_a_hand_count():
    from hbench import model_cost as mc

    jamba = {"hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32, "num_key_value_heads": 8,
             "num_experts": 16, "num_experts_per_tok": 2, "mamba_d_state": 16, "mamba_d_conv": 4,
             "mamba_expand": 2, "mamba_dt_rank": 256, "vocab_size": 65536, "num_hidden_layers": 8,
             "pattern": ["mamba+mlp", "mamba+moe", "mamba+mlp", "mamba+moe", "attn+mlp", "mamba+moe", "mamba+mlp",
                         "mamba+moe"]}
    mamba = 2 * 4096 * 8192 + 8192 * 4 + 8192 * (256 + 32) + 256 * 8192 + 8192 * 4096
    assert mc.part_params(jamba, "mamba") == mamba == 105_152_512
    assert mc.part_params(jamba, "moe") == 4096 * 16 + 2 * 3 * 4096 * 14336
    assert mc.part_params(jamba, "moe", routed=16) == 4096 * 16 + 16 * 3 * 4096 * 14336
    # a step of 4 tokens reaches at most 8 of the 16 experts; the state is read and written
    moe8 = 4096 * 16 + 8 * 3 * 4096 * 14336
    layers = 7 * mamba + 4 * mc.part_params(jamba, "mlp") + 4 * moe8 + mc.part_params(jamba, "attn")
    state = 7 * 2 * 4 * (8192 * 16 * 4 + 3 * 8192 * 2) + 2 * 4 * 10 * 8 * 128 * 2
    assert mc.decode_bytes(jamba, 4, 9, "bfloat16") == (layers + 65536 * 4096) * 2 + state


def _turn_run(**counters):
    cfg = {**QWEN, "hidden_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
           "intermediate_size": 256, "vocab_size": 512, "num_hidden_layers": 2}
    traffic = {"batch": 4, "prompt_tokens": 24, "new_tokens": 3}
    d2h = "Memcpy DtoH (Device -> Pageable)"
    tr = {"stretch": (0.0, 1000.0), "busy_us": 400.0, "spans": [(5.0, 900.0, "hbench.turn")],
          "device": [("kernel_a", "kernel", 10.0, 50.0, "hbench.turn"), (d2h, "gpu_memcpy", 90.0, 105.0, "hbench.turn"),
                     ("kernel_b", "kernel", 110.0, 150.0, "hbench.turn"), ("kernel_c", "kernel", 160.0, 190.0, "hbench.turn"),
                     (d2h, "gpu_memcpy", 195.0, 205.0, "hbench.turn"), ("kernel_b", "kernel", 210.0, 260.0, "hbench.turn"),
                     (d2h, "gpu_memcpy", 295.0, 305.0, "hbench.turn"), ("kernel_b", "kernel", 310.0, 350.0, "hbench.turn")]}
    return {"config": cfg, "traffic": traffic, "counters": counters, "trace": tr, "platform": "gpu"}


def test_serve_readers_on_a_synthetic_turn():
    from hbench import model_cost as mc

    run = _turn_run(turns=3, window_s=0.9, plain_turns=2, plain_s=0.5)
    load = lambda n: harness.load_module(f"{harness.HERE}/metrics/{n}.py").read(run)
    c = run["config"]
    # the prefill runs from the turn's start (5 µs) to the first token's copy (105 µs)
    assert load("prefill.mfu.serve") == pytest.approx(100 * mc.prefill_flops(c, 4, 24) / (100e-6 * mc.PEAK_BF16_FLOPS))
    # two steps (positions 24 and 25) between the first copy (105) and the last (305)
    need = mc.decode_bytes(c, 4, 24, "bfloat16") + mc.decode_bytes(c, 4, 25, "bfloat16")
    assert load("decode_step.roofline.serve") == pytest.approx(100 * cost.least_seconds(need) / 200e-6)
    assert load("launches_per_decode_step.serve") == 1.5  # kernels b, c and b; the last b is after the last copy
    assert load("turn.mfu.serve") == pytest.approx(100 * 2 * mc.turn_flops(c, 4, 24, 3) / (0.5 * mc.PEAK_BF16_FLOPS))
    assert load("device_idle.serve") == pytest.approx(60.0)
    run["counters"].update(plain_turns=0, plain_s=0.0)  # every turn traced: no share from the profiled one
    assert load("turn.mfu.serve") is None
    run["counters"].update(plain_turns=2, plain_s=0.5)
    run["trace"]["device"] = run["trace"]["device"][:-2]  # a copy lost: no whole turn, nothing read
    assert load("prefill.mfu.serve") is None and load("launches_per_decode_step.serve") is None
    run["platform"] = "cpu"
    assert load("turn.mfu.serve") is None  # no device share from a CPU run
