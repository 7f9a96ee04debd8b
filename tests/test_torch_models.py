"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
against the reference's — the port's mirror of ``tests/test_models.py``
for every family: dense, MoE, hybrid Mamba, RWKV-6, the whisper
encoder-decoder and the pixtral vision frontend.

Both packages run the same parameters (the reference's ``init_model``,
carried across bit for bit by ``convert.params_from_reference``) on the
same seeded NumPy batches (``make_batch``: tokens, and the frontend's
frames or patch embeddings), on the CPU, in float32 (the smoke configs).

Tolerance: hidden states, logits and caches within ``atol=5e-5,
rtol=1e-5`` (float32; XLA and torch order their reductions and matmul
accumulations differently, and torch's ``cos``/``sin`` may differ from
XLA's by an ulp in RoPE; the measured gap is near 3e-6).  Configs, tree
names, shapes and dtypes equal.  The port's own decode-vs-prefill check
keeps the reference test's ``rtol=atol=2e-3``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models as RM
import repro_torch.configs as PC
import repro_torch.models as PM
import repro_torch.serve as PS
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.models import common as PMC
from repro_torch.tree import flatten_with_path, leaves, tree_map

CPU = torch.device("cpu")
ARCHS = RC.list_archs()
ATOL, RTOL = 5e-5, 1e-5


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(a, b) -> None:
    np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=RTOL)


def both_configs(arch: str, **changes):
    """The smoke config of ``arch`` in each package, with ``changes``."""
    rc = dataclasses.replace(RC.smoke(RC.get_config(arch)), **changes)
    pc = dataclasses.replace(PC.smoke(PC.get_config(arch)), **changes)
    return rc, pc


def shared_params(rc, seed: int = 0):
    rp, _ = RM.init_model(rc, jax.random.PRNGKey(seed))
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)


def make_batch(cfg, B: int, S: int, seed: int = 1) -> dict:
    """``tests/test_models.py``'s ``make_batch`` from a NumPy seed: a
    stream of S positions (the vision frontend's patches among them),
    ``targets`` and ``mask`` over all S, and ``frames`` for an
    encoder-decoder config."""
    rng = np.random.default_rng(seed)
    s_text = S - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "mask": np.ones((B, S), np.float32),
    }
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def tokens(cfg, B: int, S: int, seed: int = 1) -> np.ndarray:
    return make_batch(cfg, B, S, seed)["tokens"]


def prefix(batch: dict) -> dict:
    """The batch without its last token (the frontend's inputs kept)."""
    return dict(batch, tokens=batch["tokens"][:, :-1])


def ref_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Configs and the parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RC.list_archs())
def test_config_and_smoke_equal_the_reference(arch):
    ref, port = RC.get_config(arch), PC.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(PC.smoke(port)) == dataclasses.asdict(RC.smoke(ref))
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    for name in RC.SHAPES:
        assert PC.shape_applicable(port, PC.SHAPES[name]) == RC.shape_applicable(ref, RC.SHAPES[name])


def test_registry_and_shapes_equal_the_reference():
    assert PC.list_archs() == RC.list_archs()
    assert sorted(PC.REGISTRY) == sorted(RC.REGISTRY)
    assert {k: dataclasses.asdict(v) for k, v in PC.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()
    }
    with pytest.raises(KeyError):
        PC.get_config("no-such-arch")
    assert PC.config().name == "paper-logstats" and PC.LogStatsConfig().beta == 254


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_names_shapes_dtypes_equal_the_reference(arch):
    rc, pc = both_configs(arch)
    rp, _ = RM.init_model(rc, jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(path), tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(rp)[0]]
    model = PM.Model(pc, generator=torch.Generator().manual_seed(0))
    got = [(name, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for name, t in flatten_with_path(model.params())]
    assert got == want
    # the module registers exactly those tensors, and the tree of init_model is the same
    assert sum(1 for _ in model.parameters()) == len(want)
    assert sum(p.numel() for p in model.parameters()) == sum(a.size for a in jax.tree.leaves(rp))
    tree = PM.init_model(pc, torch.Generator().manual_seed(0))
    assert [n for n, _ in flatten_with_path(tree)] == [w[0] for w in want]
    for a, b in zip(leaves(tree), leaves(model.params())):
        assert torch.equal(a, b)


def test_init_distributions_and_seeds():
    cfg = dataclasses.replace(PC.smoke(PC.get_config("qwen3-8b")), d_model=256, d_ff=1024)
    p = PM.init_model(cfg, torch.Generator().manual_seed(3))
    blk = p["blocks"][0]
    assert float(p["embed"].std()) == pytest.approx(0.02, rel=0.05)
    assert float(blk["ffn"]["w_up"].std()) == pytest.approx(256**-0.5, rel=0.05)
    assert float(blk["ffn"]["w_down"].std()) == pytest.approx(1024**-0.5, rel=0.05)
    assert float(blk["mixer"]["wo"].std()) == pytest.approx((4 * 32) ** -0.5, rel=0.05)
    for g in (blk["ln1"]["g"], blk["ln2"]["g"], blk["mixer"]["q_norm"], p["final_norm"]["g"]):
        assert not bool(g.any())
    again = PM.init_model(cfg, torch.Generator().manual_seed(3))
    other = PM.init_model(cfg, torch.Generator().manual_seed(4))
    assert all(torch.equal(a, b) for a, b in zip(leaves(p), leaves(again)))
    assert not torch.equal(p["embed"], other["embed"])


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PC.smoke(PC.get_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.init_cache(cfg, 1, 8)
    assert PM.init_model(cfg, device="cpu")["embed"].device == CPU


# ---------------------------------------------------------------------------
# The model functions against the reference
# ---------------------------------------------------------------------------

# (arch, config changes, S): gemma2 at S = 64 runs its local layers past the
# smoke window of 32; qwen3 without RoPE and with layer norms (the
# sinusoidal and GELU paths); deepseek at an S that q_chunk 16 does not
# divide; dbrx at an S that the MoE group of 16 does not divide (a padded
# group), llama4's dense and MoE layers (top-1), jamba's hybrid block at
# S = 17 (two Mamba chunks of 8 and a tail of 1); rwkv6 at S = 17 (two
# chunks of 8 and a tail of 1); whisper over 20 frames, which q_chunk 16
# does not divide (the encoder's and the cross-attention's padded query
# chunks run over them), at S = 21; pixtral's 8 patches ahead of 16 text
# tokens
CASES = [
    ("smollm-135m", {}, 24),
    ("qwen3-8b", {}, 32),
    ("deepseek-7b", {}, 21),
    ("gemma2-9b", {}, 64),
    ("qwen3-8b", {"use_rope": False, "norm_type": "layernorm"}, 20),
    ("dbrx-132b", {}, 20),
    ("llama4-maverick-400b-a17b", {}, 32),
    ("jamba-v0.1-52b", {}, 17),
    ("rwkv6-7b", {}, 17),
    ("whisper-medium", {"encoder_seq": 20}, 21),
    ("pixtral-12b", {}, 24),
]


@pytest.mark.parametrize("arch,changes,S", CASES, ids=[f"{a}{'-' + '-'.join(c) if c else ''}" for a, c, _ in CASES])
def test_forward_prefill_decode_match_the_reference(arch, changes, S):
    rc, pc = both_configs(arch, **changes)
    rp, pp = shared_params(rc)
    full = make_batch(rc, 2, S + 1)
    batch, last = prefix(full), full["tokens"][:, -1:]
    B, Smax = 2, S + 8
    with torch.no_grad():
        rh, raux = RM.forward_hidden(rc, rp, ref_batch(batch))
        ph, aux = PM.forward_hidden(pc, pp, batch)
        assert ph.shape == (B, S, rc.d_model)
        close(ph, rh)
        assert ("moe_layers" in aux) == bool(rc.num_experts)
        for key in ("moe_load_balance", "moe_router_z"):  # summed over the MoE layers, 0 without
            assert aux[key].dtype == torch.float32 and aux[key].dim() == 0
            close(aux[key], raux[key])
            assert (float(aux[key]) > 0) == bool(rc.num_experts)

        rcache, _ = RM.init_cache(rc, B, Smax, dtype=jnp.float32)
        rl, rcache = RM.prefill(rc, rp, ref_batch(batch), rcache)
        pcache = PM.init_cache(pc, B, Smax, torch.float32, CPU)
        pl, pcache_out = PM.prefill(pc, pp, batch, pcache)
        assert pcache_out is pcache and pl.shape == (B, 1, rc.vocab_size)
        close(pl, rl)
        ref_leaves = jax.tree.leaves(rcache)
        assert [tuple(t.shape) for t in leaves(pcache)] == [a.shape for a in ref_leaves]
        for got, want in zip(leaves(pcache), ref_leaves):
            close(got, want)

        # decode from the reference's own cache, so only the step differs; the
        # position is the length of the whole stream, the patches included
        rl2, rcache2 = RM.decode_step(rc, rp, rcache, jnp.asarray(last), jnp.int32(S))
        start = cache_from_reference(jax.tree.map(np.asarray, rcache), device=CPU)
        pl2, pcache2 = PM.decode_step(pc, pp, start, last, S)
        close(pl2, rl2)
        for got, want in zip(leaves(pcache2), jax.tree.leaves(rcache2)):
            close(got, want)


def test_bfloat16_embedding_scale_rounds_sqrt_d_first():
    rc, pc = both_configs("gemma2-9b", compute_dtype="bfloat16")
    rp, pp = shared_params(rc)
    toks = tokens(rc, 1, 8)
    want = RM.model._embed_tokens(rc, rp, jnp.asarray(toks))
    got = PM.model._embed_tokens(pc, pp, toks)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    # √128 = 11.3137 rounds to 11.3125 in bfloat16 first
    assert torch.tensor(128**0.5, dtype=torch.bfloat16).item() == 11.3125


def test_rope_rotates_split_halves_like_the_reference():
    x = np.random.default_rng(2).normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32) + 7
    want = np.asarray(RM.common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = PMC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("window,cap", [(None, None), (3, None), (None, 2.0), (4, 1.5)])
def test_attention_cores_match_the_reference(window, cap):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 11, 2, 3, 8)).astype(np.float32)
    k = rng.normal(size=(2, 11, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 11, 2, 8)).astype(np.float32)
    want = RM.common.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                       window=window, logit_cap=cap, q_chunk=4)
    got = PMC.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
                                window=window, logit_cap=cap, q_chunk=4)
    close(got, want)
    qd = q[:, :1]
    want = RM.common.decode_attention(jnp.asarray(qd), jnp.asarray(k), jnp.asarray(v), jnp.int32(6),
                                      window=window, logit_cap=cap)
    got = PMC.decode_attention(torch.from_numpy(qd), torch.from_numpy(k), torch.from_numpy(v), 6,
                               window=window, logit_cap=cap)
    close(got, want)


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """prefill(x[:S]) + decode(x[S]) == prefill(x[:S+1]): the caches (KV,
    SSM state and conv tail, RWKV state and token shifts, the encoder's
    cross-attention keys and values) and, for pixtral, decode's position
    counting the patches.  MoE runs dropless, as the reference test does:
    capacity routing legitimately drops other tokens when decode folds the
    batch into one group."""
    cfg = PC.smoke(PC.get_config(arch))
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=16.0)
    params = PM.init_model(cfg, torch.Generator().manual_seed(1))
    B, S = 2, 16
    batch = make_batch(cfg, B, S + 1, seed=3)
    with torch.no_grad():
        full, _ = PM.prefill(cfg, params, batch, PM.init_cache(cfg, B, S + 8, torch.float32, CPU))
        _, cache = PM.prefill(cfg, params, prefix(batch), PM.init_cache(cfg, B, S + 8, torch.float32, CPU))
        step, _ = PM.decode_step(cfg, params, cache, batch["tokens"][:, -1:], S)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b", "jamba-v0.1-52b", "whisper-medium", "pixtral-12b"])
def test_decode_step_reads_a_device_position_as_it_reads_an_int(arch):
    """``decode_step`` with its position as a one-element int32 tensor (0-d,
    as the engine holds it, or ``(1,)``) gives
    the logits and caches that the ``int`` gives, bit for bit, inside the
    cache, at its last slot and past it (the slot clamped): RoPE, gemma-2's
    window (32 of 40 slots), the Mamba layers beside attention, whisper's
    sinusoid and pixtral's patches ahead of the text read the tensor."""
    cfg = PC.smoke(PC.get_config(arch))
    params = PM.init_model(cfg, torch.Generator().manual_seed(4))
    B, S, Smax = 2, 12, 40
    batch = make_batch(cfg, B, S + 1, seed=5)
    with torch.no_grad():
        _, cache = PM.prefill(cfg, params, prefix(batch), PM.init_cache(cfg, B, Smax, torch.float32, CPU))
        for pos in (S, 33, Smax - 1, Smax + 3):
            at_int = tree_map(torch.clone, cache)
            want, _ = PM.decode_step(cfg, params, at_int, batch["tokens"][:, -1:], pos)
            for shape in ((), (1,)):
                at_tensor = tree_map(torch.clone, cache)
                got, _ = PM.decode_step(cfg, params, at_tensor, batch["tokens"][:, -1:],
                                        torch.full(shape, pos, dtype=torch.int32))
                assert torch.equal(got, want), (pos, shape)
                assert all(torch.equal(a, b) for a, b in zip(leaves(at_tensor), leaves(at_int))), (pos, shape)


def test_local_window_masks_differ_from_global():
    cfg = PC.smoke(PC.get_config("gemma2-9b"))
    assert cfg.sliding_window == 32
    params = PM.init_model(cfg, torch.Generator().manual_seed(2))
    toks = tokens(cfg, 1, 64, seed=4)
    with torch.no_grad():
        local, _ = PM.forward_hidden(cfg, params, {"tokens": toks})
        wide, _ = PM.forward_hidden(dataclasses.replace(cfg, sliding_window=None), params, {"tokens": toks})
    assert bool(torch.isfinite(local).all())
    # the window masks nothing before position 32 and something after it
    assert torch.equal(local[:, :32], wide[:, :32])
    assert not torch.allclose(local[:, 32:], wide[:, 32:])


def test_whisper_prefill_caches_the_encoder_once_and_decode_reads_it_back():
    """``prefill`` runs the encoder once and writes each cross layer's
    keys and values of its states into the cache; ``decode_step`` takes
    no frames and attends to what the cache holds, and leaves it as it
    was."""
    cfg = dataclasses.replace(PC.smoke(PC.get_config("whisper-medium")), encoder_seq=20)
    params = PM.init_model(cfg, torch.Generator().manual_seed(5))
    batch = make_batch(cfg, 2, 13, seed=6)
    calls = {"n": 0}
    real = PM.model._run_encoder

    def counted(*args):
        calls["n"] += 1
        return real(*args)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(PM.model, "_run_encoder", counted)
        enc = real(cfg, params, batch["frames"])
        cache = PM.init_cache(cfg, 2, 24, torch.float32, CPU)
        _, cache = PM.prefill(cfg, params, prefix(batch), cache)
        assert calls["n"] == 1
        cross = cache[0]["cross"]
        assert tuple(cross["k"].shape) == (cfg.repeats, 2, 20, cfg.num_kv_heads, cfg.head_dim)
        for r, p in enumerate(PM.model._unstacked(params["blocks"][0])):
            k, v = PM.attention.encode_cross_kv(cfg, p["cross"], enc)
            assert torch.equal(cross["k"][r], k) and torch.equal(cross["v"][r], v)
        kept = {k: t.clone() for k, t in cross.items()}
        step, cache = PM.decode_step(cfg, params, cache, batch["tokens"][:, -1:], 12)
        assert calls["n"] == 1 and all(torch.equal(cross[k], kept[k]) for k in kept)
        full, _ = PM.prefill(cfg, params, batch, PM.init_cache(cfg, 2, 24, torch.float32, CPU))
        np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)
        # decode's cross-attention reads the cache: other values there move its logits
        _, other = PM.prefill(cfg, params, prefix(batch), PM.init_cache(cfg, 2, 24, torch.float32, CPU))
        other[0]["cross"]["v"].mul_(-1.0)
        moved, _ = PM.decode_step(cfg, params, other, batch["tokens"][:, -1:], 12)
    assert not torch.allclose(moved, step, atol=1e-3)


def test_model_module_forward_is_forward_hidden():
    cfg = PC.smoke(PC.get_config("smollm-135m"))
    model = PM.Model(cfg, device=CPU)
    names = [n for n, _ in model.named_parameters()]
    assert "embed" in names and "blocks.0.mixer.wq" in names and "unembed" not in names
    toks = tokens(cfg, 2, 8)
    with torch.no_grad():
        assert torch.equal(model({"tokens": toks}), PM.forward_hidden(cfg, model.params(), {"tokens": toks})[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_sit_as_far_from_float32_as_the_references(arch):
    """bfloat16 compute (and jamba's bfloat16 scan), dropless: the port's
    last-position logits sit no farther (rms, by row) from the reference's
    float32 logits than 1.5× the farthest of the reference's own bfloat16
    rows.  The two programs round alike in kind, not in every bit (XLA
    fuses elementwise chains and rounds ``silu`` otherwise); measured:
    jamba 0.028–0.044 against the reference's 0.031–0.048 (its Mamba
    decays amplify bfloat16's rounding of Δ), dbrx 0.011–0.015 against
    0.009–0.016, rwkv6 0.010–0.020 against 0.013–0.021 (its float32
    recurrence reads bfloat16 r, k, v), whisper 0.005–0.006 against
    0.005–0.006 (frames from the batch), pixtral 0.009–0.013 against
    0.009–0.013 (bfloat16 patches ahead of the text)."""
    ch = dict(compute_dtype="bfloat16", mamba_scan_dtype="bfloat16", moe_capacity_factor=16.0)
    rc, pc = both_configs(arch, **ch)
    rc32 = dataclasses.replace(rc, compute_dtype="float32", mamba_scan_dtype="float32")
    rp, pp = shared_params(rc32)
    batch = make_batch(rc, 4, 128, seed=0)

    def ref(c):
        cache, _ = RM.init_cache(c, 4, 128, dtype=jnp.float32)
        logits, _ = jax.jit(lambda p, b, cc: RM.prefill(c, p, b, cc))(rp, ref_batch(batch), cache)
        return np.asarray(logits[:, -1]).astype(np.float64)

    r16, r32 = ref(rc), ref(rc32)
    run = PS.Engine(pc, pp, PS.ServeConfig(), device=CPU)._run  # the bf16 copy of the block weights
    with torch.no_grad():
        p16, _ = PM.prefill(pc, run, batch, PM.init_cache(pc, 4, 128, torch.float32, CPU))
    p16 = p16[:, -1].double().numpy()

    def gaps(x):
        return np.sqrt(np.mean((x - r32) ** 2, axis=-1) / np.mean(r32**2, axis=-1))

    assert np.all(gaps(p16) <= 1.5 * gaps(r16).max()), (gaps(p16), gaps(r16))


def test_bf16_rwkv_at_full_depth_sits_as_far_from_float32_as_the_reference():
    """RWKV-6's 32 layers at smoke width, 4 × 64, bfloat16 compute: the
    port's last-position logits sit no farther (rms and max, by row) from
    the reference's float32 logits than 1.5× the farthest of the
    reference's own bfloat16 rows.  Here the reference's own sit 0.16–0.29
    (rms) and 0.52–1.11 (max) of the float32 rms away, ten times the
    2-layer gap: the float32 recurrence reads bfloat16 r, k, v and mixes
    32 times over (measured: the port's 0.18–0.32 and 0.57–0.95).
    ``chip_smoke.py`` holds the full-width model to the same bounds."""
    rc, pc = both_configs("rwkv6-7b", compute_dtype="bfloat16", repeats=32)
    rc32 = dataclasses.replace(rc, compute_dtype="float32")
    rp, pp = shared_params(rc32)
    batch = make_batch(rc, 4, 64, seed=0)

    def ref(c):
        cache, _ = RM.init_cache(c, 4, 64, dtype=jnp.float32)
        logits, _ = jax.jit(lambda p, b, cc: RM.prefill(c, p, b, cc))(rp, ref_batch(batch), cache)
        return np.asarray(logits[:, -1]).astype(np.float64)

    r16, r32 = ref(rc), ref(rc32)
    run = PS.Engine(pc, pp, PS.ServeConfig(), device=CPU)._run
    with torch.no_grad():
        p16, _ = PM.prefill(pc, run, batch, PM.init_cache(pc, 4, 64, torch.float32, CPU))
    p16 = p16[:, -1].double().numpy()
    scale = np.sqrt(np.mean(r32**2, axis=-1))

    def gaps(x):
        return np.sqrt(np.mean((x - r32) ** 2, axis=-1)) / scale, np.abs(x - r32).max(axis=-1) / scale

    (prms, pmax), (rrms, rmax) = gaps(p16), gaps(r16)
    assert rrms.max() > 0.1  # the reference's own gap at this depth
    assert np.all(prms <= 1.5 * rrms.max()) and np.all(pmax <= 1.5 * rmax.max()), (prms, rrms, pmax, rmax)
