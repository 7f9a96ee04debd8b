"""The port's serving engine and launcher (``repro_torch.serve.Engine``,
``repro_torch.launch.serve``) against the reference's — the port's mirror
of the engine tests of ``tests/test_trainer_serve.py``.

Both engines serve the same parameters (the reference's ``init_model``,
carried across by ``convert.params_from_reference``), on the CPU, in
float32 (the smoke configs), from the same seeded NumPy prompts.

Tolerance: greedy tokens are compared teacher-forced, by the margin rule:
at each step the port's argmax must equal the reference's token wherever
the port's top-2 logit margin exceeds ``MARGIN = 1e-4`` (twice the model
tests' float32 tolerance); the generated sequences are equal up to the
first step below it (all of them, in these cases).  Calibration: counts
and bounds equal, the clip within ``rtol=1e-5``; summaries of the same
hidden values bit-equal.  Sampled draws are the port's own (a
``torch.Generator``), so sampling is held to determinism, not to the
reference's draws.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.core.histogram as RH
import repro.launch.serve as R_launch
import repro.models as RM
import repro.serve as RS
import repro_torch.configs as PC
import repro_torch.core.histogram as PH
import repro_torch.launch.serve as P_launch
import repro_torch.models as PM
import repro_torch.serve as PS
from repro_torch.convert import params_from_reference
from repro_torch.tree import leaves

CPU = torch.device("cpu")
MARGIN = 1e-4


def engines(arch: str, **scfg):
    """(reference engine, port engine) on one smoke config's parameters."""
    rc, pc = RC.smoke(RC.get_config(arch)), PC.smoke(PC.get_config(arch))
    rp, _ = RM.init_model(rc, jax.random.PRNGKey(0))
    pp = params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)
    return (RS.Engine(rc, rp, RS.ServeConfig(**scfg)),
            PS.Engine(pc, pp, PS.ServeConfig(**scfg), device=CPU))


def prompts_of(cfg, lengths, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]


def forced_agreement(eng, prompts, outs) -> int | None:
    """Teacher-force the port's engine with the reference's tokens ``outs``;
    assert the margin rule at every step and return the first step whose
    margin is below it (``None``: none)."""
    cfg, scfg = eng.cfg, eng.scfg
    toks, _ = eng._pad_batch(prompts)
    B, L = toks.shape
    cache = PM.init_cache(cfg, B, scfg.max_seq, torch.float32, CPU)
    batch = {"tokens": toks}
    if cfg.is_encoder_decoder:  # the engine's zero frames
        batch["frames"] = np.zeros((B, cfg.encoder_seq, cfg.d_model), np.float32)
    uncertain = None
    with torch.no_grad():
        logits, cache = PM.prefill(cfg, eng._run, batch, cache)
        for step in range(max(len(o) - len(p) for o, p in zip(outs, prompts))):
            last = logits[:, -1]
            top = torch.topk(last, 2).values
            fed = np.zeros((B, 1), np.int32)
            for i, (o, p) in enumerate(zip(outs, prompts)):
                if step >= len(o) - len(p):
                    continue  # the row stopped; its tokens no longer matter
                fed[i, 0] = want = int(o[len(p) + step])
                if float(top[i, 0] - top[i, 1]) > MARGIN:
                    assert int(torch.argmax(last[i])) == want, (i, step)
                elif uncertain is None:
                    uncertain = step
            logits, cache = PM.decode_step(cfg, eng._run, cache, fed, L + step)
    return uncertain


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b", "dbrx-132b", "jamba-v0.1-52b", "rwkv6-7b",
                                  "whisper-medium", "pixtral-12b"])
def test_greedy_generate_matches_the_reference(arch):
    ref, port = engines(arch, max_seq=48, max_new_tokens=8)
    prompts = prompts_of(ref.cfg, (5, 9, 12))
    want = ref.generate(prompts)
    got = port.generate(prompts)
    upto = forced_agreement(port, prompts, want)
    for g, w, p in zip(got, want, prompts):
        n = len(w) if upto is None else len(p) + upto
        assert g.dtype == np.int32 and np.array_equal(g[:n], w[:n])
    assert upto is None  # no near-tie in these cases: the whole sequences agree


def test_engine_generate_ssm_arch():
    """The mirror of ``tests/test_trainer_serve.py``'s case: RWKV-6's O(1)
    state through the engine, and the same tokens as the reference's."""
    ref, port = engines("rwkv6-7b", max_seq=32, max_new_tokens=4)
    prompt = [np.arange(2, 8, dtype=np.int32)]
    outs = port.generate(prompt)
    assert len(outs[0]) >= 7
    np.testing.assert_array_equal(outs[0], ref.generate(prompt)[0])


@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-v0.1-52b", "rwkv6-7b", "whisper-medium"])
def test_back_to_back_turns_on_one_held_cache_match_fresh_engines_and_the_reference(arch):
    """Two turns of one shape (3 rows, ``max_seq`` 48; prompt lengths 11
    then 12) run on the caches the engine holds, zeroed between them, and
    the position set anew: each turn's tokens are a fresh engine's and the
    reference's.  A turn of another shape builds new caches."""
    ref, port = engines(arch, max_seq=48, max_new_tokens=6)
    turns = [prompts_of(ref.cfg, (7, 11, 9), seed=1), prompts_of(ref.cfg, (12, 4, 10), seed=2)]
    got = [port.generate(turns[0])]
    held = port._cache
    got.append(port.generate(turns[1]))
    assert port._cache is held
    for prompts, g in zip(turns, got):
        fresh = PS.Engine(port.cfg, port.params, port.scfg, device=CPU).generate(prompts)
        want = ref.generate(prompts)
        upto = forced_agreement(port, prompts, want)
        for a, b, w, p in zip(g, fresh, want, prompts):
            np.testing.assert_array_equal(a, b)
            n = len(w) if upto is None else len(p) + upto
            assert len(a) == len(w) and np.array_equal(a[:n], w[:n])
    port.generate(turns[0][:2])
    assert port._cache is not held and all(t.shape[1] == 2 for t in leaves(port._cache))


def test_greedy_generate_is_deterministic():
    _, port = engines("smollm-135m", max_seq=48, max_new_tokens=8)
    prompts = prompts_of(port.cfg, (5, 9, 12))
    o1, o2 = port.generate(prompts), port.generate(prompts)
    for a, b, p in zip(o1, o2, prompts):
        np.testing.assert_array_equal(a, b)
        assert len(a) > len(p)


def test_sampled_generate_is_deterministic_under_one_generator_seed():
    _, port = engines("smollm-135m", max_seq=48, max_new_tokens=8, temperature=0.8, eos_id=-1)
    prompts = prompts_of(port.cfg, (5, 9))
    draw = [port.generate(prompts, torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    for a, b in zip(draw[0], draw[1]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, c) for a, c in zip(draw[0], draw[2]))
    assert all(len(a) == len(p) + 8 for a, p in zip(draw[0], prompts))
    assert all(int(t) < port.cfg.vocab_size for a in draw[0] for t in a)


def test_ragged_batch_answer_depends_on_its_batch_in_both_packages():
    """Reference behaviour copied on purpose (ROADMAP Queue 3): a short
    prompt right-padded with 0 continues after its padding."""
    ref, port = engines("smollm-135m", max_seq=48, max_new_tokens=6)
    rng = np.random.default_rng(0)
    short = rng.integers(2, ref.cfg.vocab_size, size=5).astype(np.int32)
    long = rng.integers(2, ref.cfg.vocab_size, size=12).astype(np.int32)
    batched = [ref.generate([short, long])[0], port.generate([short, long])[0]]
    alone = [ref.generate([short])[0], port.generate([short])[0]]
    assert batched[0].tolist() == [435, 326, 262, 139, 158, 267, 267, 267, 488, 4, 82]
    assert alone[0].tolist() == [435, 326, 262, 139, 158, 367, 202, 4, 4, 4, 4]
    for r, p in (batched, alone):
        np.testing.assert_array_equal(p, r)
    assert not np.array_equal(batched[1], alone[1])


def test_calibrate_matches_the_reference():
    ref, port = engines("qwen3-8b")
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, ref.cfg.vocab_size, (2, 16)).astype(np.int32)} for _ in range(3)]
    want = ref.calibrate([{"tokens": jnp.asarray(b["tokens"])} for b in batches], q=0.999, T=256)
    got = port.calibrate(batches, q=0.999, T=256)
    assert got["n_calibration_values"] == want["n_calibration_values"] == 3 * 2 * 16 * 128
    assert got["rank_error_bound"] == want["rank_error_bound"]
    assert got["clip"] == pytest.approx(want["clip"], rel=1e-5) and got["clip"] > 0
    assert got["int8_scale"] == got["clip"] / 127.0

    # given the reference's own |hidden|, the port's summaries, merge and clip are the reference's
    ref_sums, port_sums = [], []
    for b in batches:
        hidden, _ = RM.forward_hidden(ref.cfg, ref.params, {"tokens": jnp.asarray(b["tokens"])})
        flat = np.asarray(jnp.abs(hidden).reshape(-1).astype(jnp.float32))
        np.testing.assert_allclose(port.calibration_values(b).numpy(), flat, atol=5e-5, rtol=1e-5)
        ref_sums.append(RH.build_exact(jnp.asarray(flat), 256))
        port_sums.append(PH.build_exact(flat, 256, device=CPU))
    for r, p in zip(ref_sums, port_sums):
        assert np.array_equal(p.boundaries.numpy(), np.asarray(r.boundaries))
        assert np.array_equal(p.sizes.numpy(), np.asarray(r.sizes))
    rm, pm = RH.merge_list(ref_sums, 254), PH.merge_list(port_sums, 254)
    assert np.array_equal(pm.boundaries.numpy(), np.asarray(rm.boundaries))
    assert np.array_equal(pm.sizes.numpy(), np.asarray(rm.sizes))
    assert float(PH.quantile(pm, np.float32(0.999))) == float(RH.quantile(rm, jnp.float32(0.999)))


@pytest.mark.parametrize("arch", ["pixtral-12b", "whisper-medium"])
def test_calibrate_passes_the_frontend_inputs(arch):
    """``calibrate`` on batches carrying ``patch_embeds`` (the patch
    positions among the calibration values) or ``frames`` equals the
    reference's."""
    ref, port = engines(arch)
    cfg = ref.cfg
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(2):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
        if cfg.frontend == "vision":
            b["patch_embeds"] = rng.normal(size=(2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        if cfg.is_encoder_decoder:
            b["frames"] = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        batches.append(b)
    want = ref.calibrate([{k: jnp.asarray(v) for k, v in b.items()} for b in batches], q=0.999, T=256)
    got = port.calibrate(batches, q=0.999, T=256)
    stream = 16 + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    assert got["n_calibration_values"] == want["n_calibration_values"] == 2 * 2 * stream * cfg.d_model
    assert got["rank_error_bound"] == want["rank_error_bound"]
    assert got["clip"] == pytest.approx(want["clip"], rel=1e-5) and got["clip"] > 0
    # the frontend's inputs reach the forward: without them the values differ
    bare = port.calibration_values({"tokens": batches[0]["tokens"]}) if cfg.frontend == "vision" else None
    if bare is not None:
        assert bare.numel() == 2 * 16 * cfg.d_model
    else:
        other = dict(batches[0], frames=batches[0]["frames"] + 1.0)
        assert not torch.equal(port.calibration_values(other), port.calibration_values(batches[0]))


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    cfg = PC.smoke(PC.get_config("smollm-135m"))
    params = PM.init_model(cfg, device=CPU)
    assert PS.Engine(cfg, PM.Model(cfg, params), PS.ServeConfig(), device=CPU).device == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.Engine(cfg, params, PS.ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P_launch.main(["--arch", "smollm-135m", "--smoke", "--batch", "1"])


def _normalized(text: str) -> list[str]:
    """The launcher's lines with token values and timings blanked."""
    text = re.sub(r"output=\[[^\]]*\]", "output=[...]", text)
    text = re.sub(r"lag=[0-9.]+ms", "lag=...ms", text)
    text = re.sub(r"lag_s=[^ ]+", "lag_s=...", text)
    return text.splitlines()


def test_launcher_prints_what_the_reference_prints(tmp_path, monkeypatch, capsys):
    flags = ["--arch", "qwen3-8b", "--smoke", "--batch", "2", "--max-new-tokens", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *flags, "--metrics-dir", str(tmp_path / "rm"),
                                      "--replicate-to", str(tmp_path / "rr")])
    R_launch.main()
    want = capsys.readouterr().out
    res = P_launch.main([*flags, "--device", "cpu", "--metrics-dir", str(tmp_path / "pm"),
                         "--replicate-to", str(tmp_path / "pr")])
    got = capsys.readouterr().out
    assert _normalized(got) == _normalized(want)
    assert [ln for ln in got.splitlines() if ln.startswith(("pushed update", "replica answer"))]
    assert len(res["outputs"]) == 2 and res["update"] is not None
    (hp, ep), (hr, er) = res["primary"], res["replica"]
    assert ep == er and not res["replica"].degraded
    assert np.array_equal(np.asarray(hp.boundaries), np.asarray(hr.boundaries))
    assert np.array_equal(np.asarray(hp.sizes), np.asarray(hr.sizes))


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b", "rwkv6-7b",
                                  "whisper-medium", "pixtral-12b"])
def test_launcher_serves_the_moe_and_hybrid_smoke_configs(arch, monkeypatch, capsys):
    """``--arch <moe, hybrid, rwkv, encoder-decoder or vision> --smoke`` on
    the CPU prints the reference launcher's lines (token values blanked:
    each package draws its own weights)."""
    flags = ["--arch", arch, "--smoke", "--batch", "2", "--max-new-tokens", "3"]
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    R_launch.main()
    want = capsys.readouterr().out
    res = P_launch.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out
    assert _normalized(got) == _normalized(want)
    assert len(res["outputs"]) == 2 and all(len(o) > 0 for o in res["outputs"])
