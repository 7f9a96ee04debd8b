"""The port's optimizer, compression and data pipeline (``repro_torch.optim``,
``repro_torch.data``) against the reference's — the port's mirror of
``tests/test_optim_data.py``.  Both packages start from one state
(``convert.opt_state_from_reference``) and one seeded NumPy input.

Tolerance: ``lr_schedule`` within 1 ulp, plus what one ulp of its cosine
carries into ``lr`` where ``1 + cos`` cancels (torch's float32 cosine and
XLA's differ by 1 ulp on a few per cent of arguments); parameters and
float32 moments
after 10 ``adamw_update`` steps within rtol 1e-6, atol 1e-7 (XLA may
contract the update into FMAs that eager torch rounds twice); bfloat16
moments equal; thresholds, clipped and sparsified gradients, bucket
boundaries and batches bit-equal; ``grad_norm`` within rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as RD
import repro.optim as RO
from repro_torch.convert import opt_state_from_reference
from repro_torch.data import LengthBucketer, SyntheticLM
from repro_torch.optim import (
    CompressionConfig,
    OptimizerConfig,
    adamw_update,
    clip_grads,
    compress_grads,
    init_opt_state,
    init_residual,
    lr_schedule,
    opt_state_specs,
)
from repro_torch.tree import leaves, tree_map

CPU = torch.device("cpu")


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def to_jax(tree):
    return tree_map(jnp.asarray, tree)


def test_adamw_converges_on_quadratic():
    cfg = OptimizerConfig(peak_lr=0.1, warmup_steps=1, decay_steps=200,
                          weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params, cfg)
    for _ in range(150):
        g = {"w": 2 * params["w"]}  # ∇ Σ w²
        params, state, _ = adamw_update(g, state, params, cfg)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2
    assert int(state["step"]) == 150 and state["step"].dtype == torch.int32


def test_lr_schedule_shape():
    cfg = OptimizerConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(lr_schedule(cfg, torch.tensor(float(s)))) for s in range(0, 101, 10)]
    assert lrs[1] == pytest.approx(1.0)  # end of warmup
    assert max(lrs) <= 1.0 and lrs[-1] == pytest.approx(0.1, abs=1e-6)


@pytest.mark.parametrize("warmup, decay", [(10, 100), (100, 10_000), (0, 1), (7, 7)])
def test_lr_schedule_within_one_ulp_of_reference(warmup, decay):
    cfg = dict(peak_lr=3e-4, warmup_steps=warmup, decay_steps=decay, min_lr_ratio=0.1)
    steps = np.arange(0, 2 * decay + 3, max(1, decay // 50), dtype=np.float32)
    got = lr_schedule(OptimizerConfig(**cfg), torch.from_numpy(steps)).numpy()
    want = np.asarray(RO.lr_schedule(RO.OptimizerConfig(**cfg), jnp.asarray(steps)))
    assert got.dtype == want.dtype == np.float32
    # one ulp of lr, plus lr's share of one ulp of cos(πt) (≤ 2^-24 below 1)
    tol = np.spacing(want) + cfg["peak_lr"] * (1 - cfg["min_lr_ratio"]) * 0.5 * 2.0**-24
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= tol), (steps[err.argmax()], got[err.argmax()], want[err.argmax()])
    warm = steps < warmup  # no cosine there: 1 ulp
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert np.all(ulps[warm] <= 1)


def test_global_norm_clip():
    cfg = OptimizerConfig(clip_mode="global_norm", clip_value=1.0)
    g = {"a": torch.full((100,), 10.0)}
    clipped, m = clip_grads(g, cfg)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-3)


def test_quantile_clip_threshold_rank():
    cfg = OptimizerConfig(clip_mode="quantile", clip_q=0.99, clip_hist_T=512)
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.normal(size=20000).astype(np.float32))}
    clipped, m = clip_grads(g, cfg)
    thr = m["clip_threshold"]
    assert thr.dim() == 0 and thr.device == CPU
    frac_above = float(np.mean(np.abs(g["a"].numpy()) > float(thr)))
    assert abs(frac_above - 0.01) < 2 / 512 + 0.005
    assert float(torch.max(torch.abs(clipped["a"]))) <= float(thr) * 1.0001


def grad_tree(seed: int) -> dict:
    """Leaves of several shapes and scales, nested dicts and a list."""
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.normal(size=(64, 48)) * 0.02).astype(np.float32),
        "blocks": [
            {"q": rng.standard_t(3, size=(32, 16)).astype(np.float32),
             "norm": rng.normal(size=(16,)).astype(np.float32)},
            {"q": (rng.laplace(size=(32, 16)) * 5).astype(np.float32),
             "norm": rng.normal(size=(16,)).astype(np.float32)},
        ],
        "b": rng.normal(size=(3,)).astype(np.float32),
    }


@pytest.mark.parametrize("mode", ["none", "global_norm", "quantile"])
def test_clip_grads_matches_reference(mode):
    g = grad_tree(1)
    kw = dict(clip_mode=mode, clip_value=0.5, clip_q=0.95, clip_hist_T=128)
    got, gm = clip_grads(to_torch(g), OptimizerConfig(**kw))
    want, wm = RO.clip_grads(to_jax(g), RO.OptimizerConfig(**kw))
    assert sorted(gm) == sorted(wm)
    np.testing.assert_allclose(gm["grad_norm"].numpy(), np.asarray(wm["grad_norm"]), rtol=1e-6)
    if mode == "quantile":
        assert gm["clip_threshold"].numpy().tobytes() == np.asarray(wm["clip_threshold"]).tobytes()
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        if mode == "global_norm":  # the scale comes from the norm
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-9)
        else:
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_mode", ["none", "quantile"])
def test_ten_adamw_steps_match_reference(moments, clip_mode):
    """10 steps of clip + AdamW on both packages from one state.  Both
    clip modes hand both updates bit-equal gradients (the global norm's
    float32 sum is ordered differently by XLA: test_clip_grads_matches_reference)."""
    kw = dict(peak_lr=1e-2, warmup_steps=3, decay_steps=20, moment_dtype=moments,
              clip_mode=clip_mode, clip_q=0.98, clip_hist_T=64)
    cfg, rcfg = OptimizerConfig(**kw), RO.OptimizerConfig(**kw)
    rparams = to_jax(grad_tree(2))
    rstate = RO.init_opt_state(rparams, rcfg)
    params = to_torch(jax.tree.map(np.asarray, rparams))
    state = opt_state_from_reference(jax.tree.map(np.asarray, rstate), device="cpu")
    assert leaves(state["m"])[0].dtype == (torch.bfloat16 if moments == "bfloat16" else torch.float32)
    for step in range(10):
        g = grad_tree(100 + step)
        cg, _ = clip_grads(to_torch(g), cfg)
        rg, _ = RO.clip_grads(to_jax(g), rcfg)
        params, state, m = adamw_update(cg, state, params, cfg)
        rparams, rstate, rm = RO.adamw_update(rg, rstate, rparams, rcfg)
        np.testing.assert_allclose(m["lr"].numpy(), np.asarray(rm["lr"]), rtol=2e-7)
    assert int(state["step"]) == int(rstate["step"]) == 10
    for a, b in zip(leaves(params), jax.tree.leaves(rparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for part in ("m", "v"):
        for a, b in zip(leaves(state[part]), jax.tree.leaves(rstate[part])):
            if moments == "bfloat16":
                assert torch.equal(a, opt_state_from_reference({"m": b, "v": b, "step": 0}, "cpu")["m"])
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_opt_state_from_reference_round_trips_bits():
    rparams = to_jax(grad_tree(3))
    for moments in ("float32", "bfloat16"):
        rcfg = RO.OptimizerConfig(moment_dtype=moments)
        _, rstate, _ = RO.adamw_update(to_jax(grad_tree(4)), RO.init_opt_state(rparams, rcfg), rparams, rcfg)
        host = jax.tree.map(np.asarray, rstate)
        state = opt_state_from_reference(host, device="cpu")
        assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
        for a, b in zip(leaves(state["m"]) + leaves(state["v"]),
                        jax.tree.leaves(host["m"]) + jax.tree.leaves(host["v"])):
            bits = b.view(np.int16) if moments == "bfloat16" else b.view(np.int32)
            mine = a.view(torch.int16) if moments == "bfloat16" else a.view(torch.int32)
            assert np.array_equal(mine.numpy(), bits)


def test_opt_state_specs_mirror_params():
    specs = {"w": ("embed", None), "b": (None,)}
    assert opt_state_specs(specs) == RO.opt_state_specs(specs)


def test_compression_error_feedback():
    """Sparsified + residual == original accumulated gradient (lossless EF)."""
    ccfg = CompressionConfig(enabled=True, rho=0.05, hist_T=512)
    rng = np.random.default_rng(1)
    g = {"a": torch.from_numpy(rng.normal(size=8192).astype(np.float32))}
    resid = init_residual(g)
    sparse, new_resid, m = compress_grads(g, resid, ccfg)
    np.testing.assert_allclose(
        (sparse["a"] + new_resid["a"]).numpy(), g["a"].numpy(), rtol=1e-6,
    )
    kept = float(m["compress_kept_fraction"])
    assert abs(kept - 0.05) < 2 / 512 + 0.01
    # survivors are exactly the largest-magnitude entries (within rank bound)
    thr = float(m["compress_threshold"])
    s = sparse["a"].numpy()
    assert np.all(np.abs(s)[s != 0] >= thr)


def test_compression_matches_reference_over_two_rounds():
    """Two rounds with error feedback: thresholds, survivors, residuals and
    the kept fraction bit-equal to the reference."""
    kw = dict(enabled=True, rho=0.02, hist_T=256)
    resid, rresid = init_residual(to_torch(grad_tree(5))), RO.init_residual(to_jax(grad_tree(5)))
    for r in range(2):
        g = grad_tree(10 + r)
        sp, resid, m = compress_grads(to_torch(g), resid, CompressionConfig(**kw))
        rsp, rresid, rm = RO.compress_grads(to_jax(g), rresid, RO.CompressionConfig(**kw))
        for key in ("compress_threshold", "compress_kept_fraction"):
            assert m[key].numpy().tobytes() == np.asarray(rm[key]).tobytes(), key
        for a, b in zip(leaves(sp) + leaves(resid), jax.tree.leaves(rsp) + jax.tree.leaves(rresid)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_synthetic_data_deterministic_resume():
    d1 = SyntheticLM(vocab_size=1000, seq_len=64, global_batch=4, seed=3)
    d2 = SyntheticLM(vocab_size=1000, seq_len=64, global_batch=4, seed=3)
    for step in (0, 7, 123):
        b1, b2 = d1.batch_at(step), d2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(
        d1.batch_at(0)["tokens"], d1.batch_at(1)["tokens"]
    )


@pytest.mark.parametrize("step", [0, 7, 123])
def test_synthetic_batches_bit_equal_to_reference(step):
    kw = dict(vocab_size=1000, seq_len=64, global_batch=4, seed=3)
    got, want = SyntheticLM(**kw).batch_at(step), RD.SyntheticLM(**kw).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    rng, rrng = SyntheticLM(**kw)._rng(step), RD.SyntheticLM(**kw)._rng(step)
    assert np.array_equal(SyntheticLM(**kw).doc_lengths(rng, 500), RD.SyntheticLM(**kw).doc_lengths(rrng, 500))


def test_length_bucketer_balances_counts():
    rng = np.random.default_rng(4)
    shards = [rng.lognormal(5.5, 1.0, size=4000).astype(np.float32)
              for _ in range(4)]
    b = LengthBucketer(num_buckets=8, summary_T=256, device="cpu").fit(shards)
    allv = np.concatenate(shards)
    counts = np.bincount(b.assign(allv), minlength=8)
    # equi-depth: every bucket within the paper bound of N/8
    n = len(allv)
    assert np.abs(counts - n / 8).max() <= 2 * n / 256 + 2 * 4 + 8
    rep = b.bucket_report(allv)
    assert rep["pad_waste_bucketed"] < rep["pad_waste_unbucketed"]


def test_bucketer_report_monotone_buckets():
    rng = np.random.default_rng(5)
    lens = rng.lognormal(5.0, 0.8, size=10000).astype(np.float32)
    b = LengthBucketer(num_buckets=4, summary_T=128, device="cpu").fit([lens])
    assert np.all(np.diff(b.boundaries_) >= 0)


@pytest.mark.parametrize("num_buckets, summary_T, shard_sizes", [
    (8, 256, [4000, 4000, 4000, 4000]),
    (4, 128, [10000]),
    (8, 256, [3000, 100, 5000, 257, 64]),  # ragged shards, some shorter than T
])
def test_length_bucketer_bit_equal_to_reference(num_buckets, summary_T, shard_sizes):
    data = SyntheticLM(vocab_size=1000, seq_len=2048, global_batch=1, seed=9)
    rng = np.random.default_rng(len(shard_sizes))
    shards = [data.doc_lengths(rng, n) for n in shard_sizes]
    got = LengthBucketer(num_buckets, summary_T, device="cpu").fit(shards)
    want = RD.LengthBucketer(num_buckets, summary_T).fit(shards)
    assert got.boundaries_.tobytes() == want.boundaries_.tobytes()
    assert got.merged_.sizes.numpy().tobytes() == np.asarray(want.merged_.sizes).tobytes()
    allv = np.concatenate(shards)
    assert np.array_equal(got.assign(allv), want.assign(allv))
    assert got.bucket_report(allv) == want.bucket_report(allv)


def test_bucketer_runs_on_the_card_by_default():
    assert LengthBucketer().device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LengthBucketer(num_buckets=2, summary_T=4).fit([np.arange(10)])
