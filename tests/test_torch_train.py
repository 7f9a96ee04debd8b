"""The port's training path (``repro_torch.models.loss_fn``,
``chunked_softmax_xent``, ``repro_torch.train``, ``launch.train``) against
the reference's — the port's mirror of the trainer cases of
``tests/test_trainer_serve.py``, with the loss, its gradients and one
train step held to the reference's on the same inputs.

Both packages start from the reference's parameters and optimizer state
(``convert.params_from_reference`` / ``opt_state_from_reference``) and one
seeded NumPy batch, on the CPU.

Tolerances, set from the dtypes:
- float32 (the smoke configs): loss and gradients within ``atol=5e-5,
  rtol=1e-5``, as PR 19's forward (XLA and torch order their reductions
  and matmul accumulations differently; the measured gap is ≈ 3e-7);
- bfloat16 compute (the cast rule): loss within 1e-3 (≈ 1.6e-4 relative),
  each gradient leaf within 3e-2 of its norm (every bf16 rounding errs by
  up to 2^-9, and XLA fuses elementwise chains that eager torch rounds op
  by op; measured ≤ 1.3e-2), and the same leaves exactly representable in
  bfloat16 on both sides — every cast matrix and stacked norm gain, the
  tied embedding (its two uses' gradients meet in bfloat16), not the 1-D
  final norm; the reference runs eagerly there, as written;
- remat ``none`` / ``full`` / ``dots``: bit-equal (the same ops, recomputed);
- one train step: metrics within rtol 1e-6 (``lr``, ``grad_norm``), 5e-6
  (loss) and 1e-5 (the thresholds and the kept fraction: a threshold is a
  gradient value, and the gradients' own gap is ≈ 1e-6 of them); moments
  and the compression residual within ``rtol=1e-5`` plus 2e-5 of the leaf's largest magnitude; parameters: AdamW's first
  step moves an entry by ``lr · g / (|g| + eps)``, so where |g| is near
  eps the float32 gradients' last-bit gap moves it by up to ``lr`` — at
  most 0.1 % of the entries may differ by more than 1e-6, none by more
  than ``lr``;
- the Trainer, across packages: losses at steps 5–8 within rel 1e-4, the
  reference restart test's own tolerance.
"""
import dataclasses
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models as RM
import repro.models.common as RMC
import repro.optim as RO
import repro_torch.configs as PC
import repro_torch.models as PM
from repro.core.telemetry import StragglerDetector as RStraggler
from repro.train import make_opt_state as ref_opt_state, make_train_step as ref_train_step
from repro.train.trainer import Trainer as RTrainer, TrainerConfig as RTrainerConfig
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.core.telemetry import StragglerDetector
from repro_torch.launch import train as launcher
from repro_torch.models import model as PMM
from repro_torch.optim import CompressionConfig, OptimizerConfig
from repro_torch.train import Trainer, TrainerConfig, make_grad_fn, make_opt_state, make_train_step
from repro_torch.tree import flatten_with_path, leaves

CPU = torch.device("cpu")
DENSE = ["smollm-135m", "qwen3-8b", "deepseek-7b", "gemma2-9b"]
ATOL, RTOL = 5e-5, 1e-5


def both_configs(arch: str, **changes):
    rc = dataclasses.replace(RC.smoke(RC.get_config(arch)), **changes)
    pc = dataclasses.replace(PC.smoke(PC.get_config(arch)), **changes)
    return rc, pc


def ref_params(rc, seed: int = 0):
    rp, _ = RM.init_model(rc, jax.random.PRNGKey(seed))
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)


def lm_batch(cfg, shape, seed: int = 1, ragged_mask: bool = True) -> dict:
    """Tokens, targets and mask of ``shape`` (the stream's), plus the
    frontend's inputs: a vision config's patch embeddings take the first
    ``frontend_tokens`` positions from the tokens, an encoder-decoder
    config gets frames."""
    rng = np.random.default_rng(seed)
    mask = (rng.random(shape) > 0.2) if ragged_mask else np.ones(shape, bool)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
        "mask": mask.astype(np.float32),
    }
    lead = tuple(shape[:-1])
    if cfg.frontend == "vision":
        batch["tokens"] = batch["tokens"][..., cfg.frontend_tokens:]
        batch["patch_embeds"] = rng.normal(size=lead + (cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=lead + (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def port_value_and_grad(pc, params, batch):
    (loss, metrics), grads = make_grad_fn(pc)(params, batch)
    return loss, metrics, [g.numpy() for g in leaves(grads)]


def ref_value_and_grad(rc, params, batch, jit: bool = True):
    dt = jnp.bfloat16 if rc.compute_dtype == "bfloat16" else jnp.float32

    def f(p):
        pc = jax.tree.map(lambda x: x.astype(dt) if (x.dtype == jnp.float32 and x.ndim > 1) else x, p)
        return RM.loss_fn(rc, pc, {k: jnp.asarray(v) for k, v in batch.items()})

    vg = jax.value_and_grad(f, has_aux=True)
    (loss, metrics), grads = (jax.jit(vg) if jit else vg)(params)
    return float(loss), metrics, [np.asarray(g) for g in jax.tree.leaves(grads)]


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("final_cap", [None, 30.0])
def test_chunked_softmax_xent_value_and_grad_match_the_reference(final_cap):
    rng = np.random.default_rng(2)
    B, S, d, V = 3, 48, 32, 97
    hidden = rng.normal(size=(B, S, d)).astype(np.float32)
    unemb = (rng.normal(size=(V, d)) * 0.5).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)

    def ref(h, u):
        return RMC.chunked_softmax_xent(h, u, jnp.asarray(targets), jnp.asarray(mask), s_chunk=16,
                                        final_cap=final_cap)

    want, (gh, gu) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(unemb))
    h, u = torch.from_numpy(hidden).requires_grad_(), torch.from_numpy(unemb).requires_grad_()
    got = PM.chunked_softmax_xent(h, u, torch.from_numpy(targets), torch.from_numpy(mask), s_chunk=16,
                                  final_cap=final_cap)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(gh), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(gu), atol=ATOL, rtol=RTOL)
    # an empty mask divides by 1, as the reference's max(Σmask, 1)
    zero = PM.chunked_softmax_xent(h, u, torch.from_numpy(targets), torch.zeros(B, S), s_chunk=16)
    assert float(zero) == 0.0
    with pytest.raises(AssertionError):
        PM.chunked_softmax_xent(h, u, torch.from_numpy(targets), torch.from_numpy(mask), s_chunk=20)


@pytest.mark.parametrize("arch", RC.list_archs())
def test_loss_and_grads_match_the_reference(arch):
    """The loss, its MoE terms (0 for the dense archs) and every gradient
    leaf: the router, the experts, the Mamba mixer's, the RWKV time and
    channel mix's, the whisper encoder's and cross-attention's (the frames
    from the batch) included; pixtral's loss runs over its patch positions
    too, as the reference's does."""
    rc, pc = both_configs(arch)
    rp, pp = ref_params(rc)
    batch = lm_batch(rc, (2, 32))
    want, wm, wg = ref_value_and_grad(rc, rp, batch)
    got, gm, gg = port_value_and_grad(pc, pp, batch)
    np.testing.assert_allclose(float(got), want, atol=ATOL, rtol=RTOL)
    for key in ("ce", "moe_load_balance", "moe_router_z"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), atol=ATOL, rtol=RTOL, err_msg=key)
    assert (float(gm["moe_load_balance"]) > 0) == bool(rc.num_experts)
    names = [n for n, _ in flatten_with_path(pp)]
    for name, a, b in zip(names, wg, gg):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=name)


def is_bf16(a: np.ndarray) -> bool:
    return np.array_equal(np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)), a)


def test_bf16_loss_and_grads_follow_the_cast_rule():
    rc, pc = both_configs("smollm-135m", compute_dtype="bfloat16", repeats=2)
    rp, pp = ref_params(rc)
    batch = lm_batch(rc, (2, 32))
    # eager: XLA's CPU compile of the jitted program folds away the bf16
    # round trip of the embedding's summed cotangent, which the program as
    # written (and the port) makes
    want, _, wg = ref_value_and_grad(rc, rp, batch, jit=False)
    got, _, gg = port_value_and_grad(pc, pp, batch)
    assert abs(float(got) - want) <= 1e-3, (float(got), want)
    names = [n for n, _ in flatten_with_path(pp)]
    rep = {}
    for name, a, b in zip(names, wg, gg):
        assert b.dtype == np.float32 and b.shape == a.shape, name
        assert np.linalg.norm(b - a) <= 3e-2 * np.linalg.norm(a), name
        rep[name] = is_bf16(b)
        assert rep[name] == is_bf16(a), name
    # the stacked (repeats, d) norm gains and the tied embedding went through bf16; the final norm did not
    assert rep["['blocks'][0]['ln1']['g']"] and rep["['blocks'][0]['ffn']['w_up']"] and rep["['embed']"]
    assert not rep["['final_norm']['g']"]


def test_remat_policies_are_bit_equal_and_recompute():
    calls = {"n": 0}
    real = PMM.apply_layer_train

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    runs = {}
    rc, _ = both_configs("qwen3-8b", repeats=3)
    _, pp = ref_params(rc)
    batch = lm_batch(rc, (2, 32))
    for policy in ("none", "full", "dots"):
        _, pc = both_configs("qwen3-8b", repeats=3, remat_policy=policy)
        calls["n"] = 0
        PMM.apply_layer_train = counted
        try:
            runs[policy] = port_value_and_grad(pc, pp, batch)
        finally:
            PMM.apply_layer_train = real
        runs[policy] += (calls["n"],)
    assert runs["none"][3] == 3 and runs["full"][3] == 6 and runs["dots"][3] == 6  # recomputed in the backward
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], runs["none"][0])
        for a, b in zip(runs[policy][2], runs["none"][2]):
            assert np.array_equal(a, b), policy
    _, bad = both_configs("qwen3-8b", remat_policy="everything")
    with pytest.raises(ValueError):
        port_value_and_grad(bad, pp, batch)


def test_remat_policies_are_bit_equal_for_the_hybrid_moe_stack():
    """jamba's block under ``"full"`` and ``"dots"``: each layer
    recomputed, and inside it each Mamba chunk under its own checkpoint;
    the MoE routing recomputes the same decisions."""
    rc, _ = both_configs("jamba-v0.1-52b")
    _, pp = ref_params(rc)
    batch = lm_batch(rc, (2, 32))
    runs = {policy: port_value_and_grad(both_configs("jamba-v0.1-52b", remat_policy=policy)[1], pp, batch)
            for policy in ("none", "full", "dots")}
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], runs["none"][0])
        assert torch.equal(runs[policy][1]["moe_load_balance"], runs["none"][1]["moe_load_balance"])
        for a, b in zip(runs[policy][2], runs["none"][2]):
            assert np.array_equal(a, b), policy


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------

STEP_CASES = {
    "none": (dict(clip_mode="none"), False),
    "global_norm": (dict(clip_mode="global_norm"), False),
    "quantile": (dict(clip_mode="quantile", clip_hist_T=256), False),
    "quantile+compression": (dict(clip_mode="quantile", clip_hist_T=256), True),
    "grad_accum=2": (dict(clip_mode="global_norm", grad_accum=2), False),
}


def leaf_close(got: torch.Tensor, want, name: str) -> None:
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5 * scale, err_msg=name)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_the_reference(case, arch="qwen3-8b", per_leaf=True):
    kw, compress = STEP_CASES[case]
    kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=16, **kw)
    rc, pc = both_configs(arch)
    rp, pp = ref_params(rc)
    accum = kw.get("grad_accum", 1)
    batch = lm_batch(rc, (accum, 4, 32) if accum > 1 else (4, 32), seed=3, ragged_mask=False)
    rcc = RO.CompressionConfig(enabled=True, rho=0.05, hist_T=256) if compress else None
    pcc = CompressionConfig(enabled=True, rho=0.05, hist_T=256) if compress else None
    rs = ref_opt_state(rp, RO.OptimizerConfig(**kw), rcc)
    rp2, rs2, rm = jax.jit(ref_train_step(rc, RO.OptimizerConfig(**kw), comp_cfg=rcc))(
        rp, rs, {k: jnp.asarray(v) for k, v in batch.items()})
    ps = opt_state_from_reference(jax.tree.map(np.asarray, rs), device=CPU)
    assert sorted(ps) == sorted(make_opt_state(pp, OptimizerConfig(**kw), pcc))
    step = make_train_step(pc, OptimizerConfig(**kw), comp_cfg=pcc)
    pp2, ps2, pm = step(pp, ps, batch)
    assert sorted(pm) == sorted(rm)
    for k in rm:
        assert pm[k].dim() == 0 and pm[k].device == CPU, k
        tol = {"loss": 5e-6, "ce": 5e-6, "lr": 1e-6, "grad_norm": 1e-6}.get(k, 1e-5)
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=tol, atol=1e-9, err_msg=k)
    assert sorted(ps2) == sorted(rs2) and int(ps2["step"]) == int(rs2["step"]) == 1
    for key in ("m", "v") + (("residual",) if compress else ()):
        for (name, got), want in zip(flatten_with_path(ps2[key]), jax.tree.leaves(rs2[key])):
            leaf_close(got, want, f"{key}{name}")
    lr = float(rm["lr"])
    far = total = 0
    for (name, got), want in zip(flatten_with_path(pp2), jax.tree.leaves(rp2)):
        d = np.abs(got.numpy() - np.asarray(want))
        assert d.max() <= lr and (not per_leaf or np.mean(d > 1e-6) <= 1e-3), (name, d.max(), np.mean(d > 1e-6))
        far, total = far + int(np.sum(d > 1e-6)), total + d.size
    assert far <= 1e-3 * total, (far, total)
    # functional: the inputs are left as they are
    for a, b in zip(leaves(pp), jax.tree.leaves(rp)):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b"])
def test_moe_and_hybrid_train_step_matches_the_reference(arch):
    """One quantile-clipped step of the MoE and hybrid smoke configs, at
    ``test_train_step_matches_the_reference``'s tolerances, the 0.1 % of
    parameters off by more than 1e-6 counted over the tree: jamba's
    128-entry ``['blocks'][3]['ln1']['g']`` has one gradient entry of
    -4.7e-8 (port -4.8e-8), near AdamW's eps of 1e-8, which moves that
    entry 1.5e-6 apart — the mechanism the tolerance names, in one entry
    of 128."""
    test_train_step_matches_the_reference("quantile", arch=arch, per_leaf=False)


# ---------------------------------------------------------------------------
# The Trainer (mirrors tests/test_trainer_serve.py)
# ---------------------------------------------------------------------------

OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=16, clip_mode="global_norm")


def make_trainer(path, steps, *, ref=False, seed=0, resume=True, log_every=2):
    """The reference test's trainer, in either package (CPU)."""
    tc = dict(total_steps=steps, log_every=log_every, checkpoint_every=4,
              checkpoint_dir=str(path), seed=seed, resume=resume)
    if ref:
        return RTrainer(RC.smoke(RC.get_config("smollm-135m")), RO.OptimizerConfig(**OPT),
                        RTrainerConfig(**tc), seq_len=32, global_batch=4)
    return Trainer(PC.smoke(PC.get_config("smollm-135m")), OptimizerConfig(**OPT), TrainerConfig(**tc),
                   seq_len=32, global_batch=4, device="cpu")


def losses_of(trainer) -> dict[int, float]:
    out = {}
    trainer.run(on_metrics=lambda s, m: out.__setitem__(s, float(m["loss"])))
    return out


def test_loss_decreases(tmp_path):
    tr = make_trainer(tmp_path / "ckpt", steps=12)
    tr.run()
    first = tr.telemetry.scalars["loss"][0][1]
    last = tr.telemetry.scalars["loss"][-1][1]
    assert last < first
    assert tr.params["embed"].device == CPU and tr.host == 0


def test_restart_is_deterministic(tmp_path):
    trA = make_trainer(tmp_path / "a", steps=8)
    trA.run()
    lossA = trA.telemetry.scalars["loss"][-1][1]
    make_trainer(tmp_path / "b", steps=4).run()
    trB2 = make_trainer(tmp_path / "b", steps=8)
    assert trB2.start_step == 4
    trB2.run()
    lossB = trB2.telemetry.scalars["loss"][-1][1]
    assert lossA == pytest.approx(lossB, rel=1e-4), (lossA, lossB)


def test_straggler_detector_flags_slow_host_as_the_reference():
    dets = [StragglerDetector(window=32, T=32, quantile_q=0.5, tolerance=1.3, device="cpu"),
            RStraggler(window=32, T=32, quantile_q=0.5, tolerance=1.3)]
    rng = np.random.default_rng(0)
    for step in range(32):
        for host in range(8):
            t = (0.10 + 0.005 * rng.standard_normal()) * (3.0 if host == 5 else 1.0)
            for det in dets:
                det.record(host, t)
    (flagged, cut), (ref_flagged, ref_cut) = (det.flag() for det in dets)
    assert flagged == ref_flagged == [5]
    assert cut == ref_cut and 0.1 < cut < 0.35


def test_preemption_checkpoint_on_sigterm(tmp_path):
    """SIGTERM mid-run → checkpoint written at the interrupted step, clean
    exit, and a fresh Trainer resumes exactly there."""
    tr = make_trainer(tmp_path, steps=50)
    previous = signal.getsignal(signal.SIGTERM)
    tr.install_signal_handler()
    try:
        def interrupt(step, metrics):
            if step >= 6:
                os.kill(os.getpid(), signal.SIGTERM)

        stopped_at = tr.run(on_metrics=interrupt)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert stopped_at < 50
    assert make_trainer(tmp_path, steps=50).start_step == stopped_at


@pytest.mark.parametrize("first", ["reference", "port"])
def test_resume_across_packages(tmp_path, first):
    """One package trains 8 steps (checkpointing at 4 and 8); the other
    resumes from its step-4 checkpoint and reaches the same losses at
    steps 5–8."""
    whole = make_trainer(tmp_path / "whole", steps=8, ref=first == "reference", log_every=1)
    want = losses_of(whole)
    assert sorted(want) == list(range(1, 9)) and want[8] < want[1]
    half = tmp_path / "half"
    half.mkdir()
    shutil.copytree(tmp_path / "whole" / "step_00000004", half / "step_00000004")
    (half / "LATEST").write_text("step_00000004")
    other = make_trainer(half, steps=8, ref=first != "reference", log_every=1)
    assert other.start_step == 4
    got = losses_of(other)
    assert sorted(got) == [5, 6, 7, 8]
    for s in got:
        assert got[s] == pytest.approx(want[s], rel=1e-4), (s, got[s], want[s])


# ---------------------------------------------------------------------------
# The launcher and the device rule
# ---------------------------------------------------------------------------


def test_train_launcher_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "4", "--seq-len", "32",
            "--global-batch", "4", "--log-every", "2", "--checkpoint-every", "2",
            "--checkpoint-dir", str(tmp_path), "--clip-mode", "quantile", "--compress-rho", "0.05"]
    tr = launcher.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in out if ln.startswith("[trainer] step=")] == ["step=2", "step=4"]
    assert out[-1].startswith("[trainer] done: 4 steps")
    assert "residual" in tr.opt_state and tr.mesh.mesh_dim_names == ("data", "model")
    assert not torch.distributed.is_initialized()  # the launcher's own world-1 group is gone
    tr2 = launcher.main(argv[:argv.index("--steps") + 1] + ["6"] + argv[argv.index("--steps") + 2:])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[trainer] resumed from step 4" and tr2.start_step == 4
    assert out[-1].startswith("[trainer] done: 2 steps")


def test_entry_points_need_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    cfg = PC.smoke(PC.get_config("smollm-135m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, OptimizerConfig(), TrainerConfig(checkpoint_dir=str(tmp_path)), seq_len=32, global_batch=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "smollm-135m", "--smoke", "--checkpoint-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.init_model(cfg)
